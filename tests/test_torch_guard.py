"""The port stands alone: it imports neither jax nor the JAX package.

Two checks: importing every module of ``repro_torch`` in a fresh process in
which ``import jax`` fails, and a scan of every ``.py`` of the port, of
``chip_smoke.py`` and of the examples' twins (``examples/*_torch.py``) for an
import line of ``jax`` or ``repro``.

Besides, every port test module takes the suite's one thread rule,
``tests/torch_threads.py``, apart from the modules ``THREAD_RULE_EXEMPT``
names with a reason.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("*_torch.py")))
BAD_IMPORT = re.compile(
    r"^\s*(import\s+(jax|repro)(\.|\s|,|$)|from\s+(jax|repro)(\.|\s))")


def test_port_imports_without_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"import importlib\nfor m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "assert not any(m == 'jax' or m.startswith('jax.') for m in "
            "sys.modules if sys.modules[m] is not None)\n"
            "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_lines(path):
    bad = [line for line in path.read_text().splitlines()
           if BAD_IMPORT.match(line)]
    assert not bad, bad


def test_pattern_catches_the_forms():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.core import server", "from repro import configs",
                 "    import repro.utils", "import repro"):
        assert BAD_IMPORT.match(line), line
    for line in ("import repro_torch", "from repro_torch.core import server",
                 "import jaxlib_free_thing", "# from repro.core import x"):
        assert not BAD_IMPORT.match(line), line


@pytest.mark.parametrize("module", ["launch/mesh.py", "sharding/specs.py",
                                    "kernels/fedagg/sharded.py"])
def test_sharded_modules_are_guarded(module):
    """The model-sharding and pod-engine modules are among the files both
    checks above cover."""
    assert PORT / module in FILES


THREAD_RULE = "from torch_threads import one_torch_thread  # noqa: F401"
_CARD_ONLY = ("skips on the CPU; on the card, in one process where no pool "
              "contends, its CPU-side comparisons ran slower at one thread "
              "(the six card-only modules 59.1 -> 67.1 s, 4 runs each)")
#: port test modules that run at torch's default intra-op pool, and why
THREAD_RULE_EXEMPT = {
    "test_torch_arch_cuda.py": _CARD_ONLY,
    "test_torch_arch_families_cuda.py": _CARD_ONLY,
    "test_torch_cohort_cuda.py": _CARD_ONLY,
    "test_torch_fedagg_cuda.py": _CARD_ONLY,
    "test_torch_sharded_cuda.py": _CARD_ONLY,
    "test_torch_steps_cuda.py": _CARD_ONLY,
    "test_torch_models_client.py":
        "at one thread test_client_run_local[femnist-10] crosses a max-pool "
        "near-tie of the FEMNIST CNN (first round, step 3: a second-pool "
        "window whose top two inputs the reference holds 9 ulps apart), which "
        "2, 4 and 8 threads do not; the conv's reduction order decides it "
        "(ROADMAP F3)",
}


def test_port_test_modules_take_the_thread_rule():
    """Each ``tests/test_torch_*.py`` imports the shared fixture and sets no
    thread count of its own; an exempt module does neither."""
    offenders = []
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        text = path.read_text()
        takes = THREAD_RULE in text.splitlines()
        if (takes == (path.name in THREAD_RULE_EXEMPT)
                or re.search(r"set_num_threads\s*\(", text)):
            offenders.append(path.name)
    assert not offenders, offenders
    assert set(THREAD_RULE_EXEMPT) <= {
        p.name for p in (ROOT / "tests").glob("test_torch_*.py")}
