"""The port's copies of the numpy-only modules against the reference: the
configs equal field for field, the datasets and mini-batch draws byte for
byte, and the copied sources line for line (import lines aside).
"""
import dataclasses
import importlib
import inspect
import re

import numpy as np
import pytest

from repro import configs as C
from repro.data import pipeline as jpipe
from repro_torch import configs as TC
from repro_torch.data import pipeline as tpipe
from torch_threads import one_torch_thread  # noqa: F401

TASKS = ("synthetic-1-1", "femnist", "shakespeare")

#: modules the port keeps as copies of the reference's
COPIED = ("utils.registry", "configs.paper_tasks", "configs.scenarios",
          "configs.recurrentgemma_2b", "configs.h2o_danube_1_8b",
          "configs.mamba2_1_3b",
          "data.synthetic", "data.femnist", "data.shakespeare",
          "data.pipeline", "core.events", "core.behavior", "core.screening",
          "core.adaptive_k")


def _code_lines(mod):
    """Source lines with the package name normalized on import lines."""
    out = []
    for line in inspect.getsource(mod).splitlines():
        if re.match(r"\s*(from|import)\s", line):
            line = line.replace("repro_torch", "repro")
        out.append(line)
    return out


@pytest.mark.parametrize("name", COPIED)
def test_copied_module_source_equal(name):
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    assert _code_lines(port) == _code_lines(ref)


class TestFedConfig:
    def test_class_source_byte_equal(self):
        from repro.configs.base import FedConfig as J
        from repro_torch.configs.base import FedConfig as T
        assert inspect.getsource(T) == inspect.getsource(J)

    def test_fields_and_defaults(self):
        jf = {f.name: f.default for f in dataclasses.fields(C.FedConfig)}
        tf = {f.name: f.default for f in dataclasses.fields(TC.FedConfig)}
        assert tf == jf
        assert TC.FedConfig().backend == "pytree"

    @pytest.mark.parametrize("bad", [dict(client_engine="gpu"),
                                     dict(batch_window=-1.0),
                                     dict(model_shards=3),
                                     dict(screen="nope")])
    def test_validation_matches(self, bad):
        with pytest.raises(ValueError):
            C.FedConfig(**bad)
        with pytest.raises(ValueError):
            TC.FedConfig(**bad)

    @pytest.mark.parametrize("name", TASKS)
    def test_paper_task_configs_equal(self, name):
        assert (dataclasses.asdict(TC.PAPER_TASKS[name])
                == dataclasses.asdict(C.PAPER_TASKS[name]))

    @pytest.mark.parametrize("arch", sorted(C.ARCHS.names()))
    def test_arch_configs_equal(self, arch):
        """Every assigned architecture, full and reduced."""
        assert (dataclasses.asdict(TC.get_arch(arch))
                == dataclasses.asdict(C.get_arch(arch)))
        assert (dataclasses.asdict(TC.reduced(TC.get_arch(arch)))
                == dataclasses.asdict(C.reduced(C.get_arch(arch))))
        assert TC.ARCHS.names() == C.ARCHS.names()
        assert TC.ALL_ARCH_IDS == C.ALL_ARCH_IDS

    def test_scenario_configs_equal(self):
        assert TC.SCENARIOS.names() == C.SCENARIOS.names()
        for name in C.SCENARIOS.names():
            assert (dataclasses.asdict(TC.SCENARIOS[name])
                    == dataclasses.asdict(C.SCENARIOS[name])), name


def _assert_dataset_equal(a, b):
    for xa, xb in zip(a, b):
        assert xa.dtype == xb.dtype and xa.shape == xb.shape
        assert xa.tobytes() == xb.tobytes()


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", TASKS)
def test_datasets_byte_equal(name, seed):
    jtrain, jeval = jpipe.load_task_datasets(C.PAPER_TASKS[name], seed=seed)
    ttrain, teval = tpipe.load_task_datasets(TC.PAPER_TASKS[name], seed=seed)
    assert len(jtrain) == len(ttrain)
    for a, b in zip(jtrain, ttrain):
        _assert_dataset_equal(a, b)
    _assert_dataset_equal(jeval, teval)


@pytest.mark.parametrize("name", TASKS)
def test_minibatch_draws_byte_equal(name):
    jtrain, _ = jpipe.load_task_datasets(C.PAPER_TASKS[name], seed=0)
    ttrain, _ = tpipe.load_task_datasets(TC.PAPER_TASKS[name], seed=0)
    seed = 0 * 10_007 + 1            # the client seed derivation
    jb = jpipe.MiniBatcher(jtrain[1], 32, seed=seed)
    tb = tpipe.MiniBatcher(ttrain[1], 32, seed=seed)
    for k in (1, 10, 3):
        _assert_dataset_equal(jb.next(), tb.next())
        _assert_dataset_equal(jb.next_stacked(k), tb.next_stacked(k))
    assert (jb.rng.bit_generator.state == tb.rng.bit_generator.state)


def test_next_stacked_equals_k_next_calls():
    ttrain, _ = tpipe.load_task_datasets(TC.SYNTHETIC_1_1, seed=0)
    a = tpipe.MiniBatcher(ttrain[0], 32, seed=7)
    b = tpipe.MiniBatcher(ttrain[0], 32, seed=7)
    xs, ys = a.next_stacked(4)
    for k in range(4):
        x, y = b.next()
        np.testing.assert_array_equal(xs[k], x)
        np.testing.assert_array_equal(ys[k], y)
