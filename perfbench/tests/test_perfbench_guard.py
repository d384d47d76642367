"""The benchmark runs without JAX: no module of ``perfbench`` imports
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` (compared by the
whole top-level name: ``repro_torch`` is the port), a process that loads
the harness and the port's modules it drives holds none of them, and the
plain reference imports nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

from perfbench import bench, guard

PB = bench.ROOT / "perfbench"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_whole_top_level_names():
    assert guard.forbidden(["repro_torch.core.server", "jaxtyping",
                            "reprolib", "torch"]) == []
    assert guard.forbidden(["repro", "repro.core.server", "jax.numpy",
                            "jaxlib.xla_client", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib.xla_client", "repro",
        "repro.core.server"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sorted(PB.rglob("*.py")):
        bad = guard.forbidden(_imports(path))
        assert not bad, f"{path.relative_to(bench.ROOT)} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    """The reference, and every module of the benchmark it imports."""
    seen, todo = set(), [p for p in (PB / "reference").glob("*.py")]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            assert guard.top_level(name) != "repro_torch", (path, name)
            if guard.top_level(name) == "perfbench":
                mod = bench.ROOT.joinpath(*name.split("."))
                todo += [p for p in (mod.with_suffix(".py"),
                                     mod / "__init__.py") if p.exists()]
    assert PB / "weights.py" in seen and PB / "feed.py" in seen


def test_the_harness_process_holds_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(bench.ROOT)!r}, {str(bench.ROOT / 'src')!r}]\n"
        "from perfbench import bench, control, guard, judge\n"
        "from perfbench.runners import fedtrain, server_uploads\n"
        "from repro_torch.core import simulator, server, tasks\n"
        "from repro_torch.kernels.ssd import ssd\n"
        "for name in ('mamba2-fedtrain', 'mamba2-agg-burst',\n"
        "             'danube-fedtrain'):\n"
        "    cell = bench.load_cell(name)\n"
        "    bench.runner(cell.traffic['runner'])\n"
        "    for m in cell.per_layer:\n"
        "        bench.reader(m['name'])\n"
        "print(guard.loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
