"""What the benchmark may load: nothing of JAX or the JAX package
(``petibm_tpu``, compared as a whole top-level name, so the port
``petibm_tpu_torch`` passes), a reference that imports nothing of the
port, and none of the JAX package's benchmark files."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _sources(skip_tests: bool = True):
    for dirpath, dirs, files in os.walk(BENCH):
        if skip_tests and os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path: str) -> set:
    with open(path) as fh:
        tree = ast.parse(fh.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax():
    for path in _sources():
        bad = _imports(path) & {"jax", "jaxlib", "flax", "petibm_tpu"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for name in os.listdir(os.path.join(BENCH, "reference")):
        if name.endswith(".py"):
            tops = _imports(os.path.join(BENCH, "reference", name))
            assert tops <= {"__future__", "numpy", "torch"}, (name, tops)


def test_reads_none_of_the_jax_benchmark_files():
    for path in _sources():
        with open(path) as fh:
            text = fh.read()
        for word in ("bench.py", "BENCH_", "MULTICHIP_", "VERDICT",
                     "examples/", "chip_smoke"):
            assert word not in text, (path, word)


def test_forbidden_names_are_whole_top_level_names():
    code = textwrap.dedent("""
        import sys, types
        sys.path.insert(0, {root!r})
        from benchmark import harness
        assert harness.forbidden_modules() == [], harness.forbidden_modules()
        sys.modules["petibm_tpu_torch_x"] = types.ModuleType("x")
        sys.modules["jaxish.sub"] = types.ModuleType("y")
        assert harness.forbidden_modules() == []
        sys.modules["petibm_tpu.solvers"] = types.ModuleType("z")
        assert harness.forbidden_modules() == ["petibm_tpu"]
        sys.modules["jax.numpy"] = types.ModuleType("w")
        assert harness.forbidden_modules() == ["jax", "petibm_tpu"]
        """).format(root=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_a_run_loads_no_jax(small_root):
    """A whole run on a CPU cut, in a process of its own: the modules it
    holds at the end."""
    code = textwrap.dedent("""
        import sys, time
        sys.path.insert(0, {root!r})
        from benchmark import harness
        res = harness.run_cell({small!r}, "small2d.fdm_k4", 5, 0.2, False,
                               t_start=time.perf_counter(), device="cpu")
        assert res["correct"], res
        assert "petibm_tpu_torch" in sys.modules
        tops = sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"jax", "jaxlib", "flax", "petibm_tpu"}})
        assert not tops, tops
        """).format(root=ROOT, small=small_root)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
