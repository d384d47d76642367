"""The thread rule of the port's test modules, defined once.

A port test module takes it with::

    from torch_threads import one_torch_thread  # noqa: F401

(``tests/`` is on ``sys.path``: it has no ``__init__.py``, so pytest's
default import mode puts it there.) ``tests/test_torch_guard.py`` checks
that every ``tests/test_torch_*.py`` does, apart from the modules it names
with a reason.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the module runs, the previous count
    restored after, for the other modules of the process.

    The suite runs under pytest-xdist's workers, which share the cores. At
    torch's default of one thread per core each worker's pool spins at
    every small op's barrier, and a test can run several times slower than
    it does alone; the port's tests run small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
