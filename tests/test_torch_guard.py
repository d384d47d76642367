"""The port stands alone: it imports neither jax nor the JAX package.

Two checks: importing every module of ``repro_torch`` in a fresh process in
which ``import jax`` fails, and a scan of every ``.py`` of the port, of
``chip_smoke.py`` and of the examples' twins (``examples/*_torch.py``) for an
import line of ``jax`` or ``repro``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

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
