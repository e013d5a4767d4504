"""BENCHMARK.json against the benchmark's contract, and every file a cell
or metric names found by name."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from conftest import ROOT, load

SPEC = os.path.join(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture
def spec():
    return load(SPEC)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(spec):
    assert set(spec) == KEYS
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.rstrip("/").endswith("_torch")
    assert 1 <= len(spec["command"]) <= 32
    for word in spec["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert os.path.isfile(os.path.join(ROOT, spec["command"][1]))
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51


def test_names_units_and_lines(spec):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names += [e["name"] for e in spec[group]]
    for name in names:
        assert NAME.match(name), name
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in spec[group]]
        assert len(seen) == len(set(seen)), group
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
    for c in spec["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
    for m in spec["per_layer"]:
        assert _line(m["layer"])
    assert len(json.dumps(spec)) <= 64 * 1024


def test_entries_have_only_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES


def test_bounds_cells_and_metrics(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    assert 1 <= len(cells) <= 24
    four = sum(1 for w in spec["workloads"] if w["chips"] == 4)
    assert all(w["chips"] in (1, 4) for w in spec["workloads"])
    assert four <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for cell in cells:  # each cell reports a per-layer metric
        assert any(cell in m.get("workloads", cells)
                   for m in spec["per_layer"])
    for m in spec["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_config_files_hold_their_reductions(spec):
    """Each configuration file: its reductions and source as the spec
    has them, the keys the harness reads, a solver of ``SOLVERS``, a
    reference that resolves (``ibpm.DecoupledIBPM`` where none is
    named), and one ``body``, a ``bodies`` list, or neither."""
    from benchmark import harness

    assert harness.DEFAULT_REFERENCE == "ibpm.DecoupledIBPM"
    base = spec["paths"][0]
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert c["file"].startswith(base + "/")
        case = load(os.path.join(ROOT, c["file"]))
        assert case["reduced"] == c["reduced"]
        assert case["source"] == c["source"]
        for key in ("mesh", "flow", "parameters", "inputs", "assumed",
                    "solver"):
            assert key in case, key
        assert set(case) <= {"source", "case", "assumed", "reduced",
                             "solver", "reference", "body", "bodies",
                             "inputs", "mesh", "flow", "parameters"}
        assert not ("body" in case and "bodies" in case)
        assert case["solver"] in harness.SOLVERS
        ref = harness.resolve_reference(
            case.get("reference", "ibpm.DecoupledIBPM"))
        for attr in ("initial_state", "load", "advance"):
            assert callable(getattr(ref, attr)), attr


def test_every_cell_finds_its_files(spec):
    from benchmark import harness

    for w in spec["workloads"]:
        cell = harness.Cell(ROOT, spec, w["name"])
        path, pts = cell.body()
        bodies = cell.bodies() or []
        for b in bodies:
            if "file" in b:
                assert b["file"].startswith(os.path.join(
                    ROOT, spec["paths"][0]))
        if path is not None:
            assert pts.shape[1] == len(cell.case["mesh"])
        for key in ("spinup_chunks", "min_chunks", "trace_chunks", "why"):
            assert key in cell.traffic
        assert cell.k == cell.traffic["parameters"]["stepsPerDispatch"]
        for m in cell.per_layer:
            assert os.path.isfile(os.path.join(cell.metrics_dir,
                                               m["name"] + ".py"))
        dims = len(cell.case["mesh"])
        want = {"u_gap", "v_gap", "p_gap"} | (
            {"w_gap"} if dims == 3 else set()) | (
            {"f_gap"} if bodies else set())
        assert want <= set(cell.limits)


def test_bodies_match_the_examples():
    """The body files the configurations carry are the examples' own."""
    pairs = (("cylinder2d_re200", "cylinder2dRe200/circle.body"),
             ("sphere3d_re300", "sphere3dRe300/sphere.body"))
    for name, example in pairs:
        with open(os.path.join(ROOT, "benchmark", "configs",
                               name + ".body")) as a, \
                open(os.path.join(ROOT, "examples", "decoupledibpm",
                                  example)) as b:
            assert a.read() == b.read()


def test_configs_match_the_examples():
    yaml = pytest.importorskip("yaml")
    pairs = (("cylinder2d_re200", "cylinder2dRe200"),
             ("sphere3d_re300", "sphere3dRe300"))
    for name, example in pairs:
        case = load(os.path.join(ROOT, "benchmark", "configs",
                                 name + ".json"))
        with open(os.path.join(ROOT, "examples", "decoupledibpm", example,
                               "config.yaml")) as fh:
            ex = yaml.safe_load(fh)
        assert case["mesh"] == ex["mesh"]
        assert case["flow"] == ex["flow"]
        assert case["parameters"]["dt"] == ex["parameters"]["dt"]
        for role, max_it in (("velocity", 10000), ("poisson", 20000),
                             ("forces", 10000)):
            opts = case["parameters"][f"{role}Solver"]
            assert (opts["atol"], opts["rtol"], opts["max_it"]) == (
                1e-6, 0.0, max_it)


def test_help_lists_the_cells(spec):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    for w in spec["workloads"]:
        assert w["name"] in out and w["why"] in out
    for m in spec["per_layer"]:
        assert m["name"] in out


def test_refuses_without_a_card():
    """No CUDA card: a non-zero exit and no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cylinder2d_re200.fdm_k100", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()
