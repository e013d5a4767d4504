"""Probes and vorticity: the port against the JAX package.

Twins of tests/test_io_aux.py's probe and vorticity tests: each case runs
the port (``io/probes.py``, ``io/vorticity.py``) and the JAX package on
the same seeded inputs.  The probe files match: the same lines, with the
numbers to 1e-12 of the file's largest in float64 (bit-equal where both
packages format the same values), for both writers, HDF5 (h5py imports
here) and ASCII.  The vorticity to 1e-12 in 2D and 3D, and the vorticity
CLIs' outputs on a 2D and a 3D case.  Card-only: the probes of a run on
the card against the same run on the CPU.
"""

import os
import shutil
import types

import numpy as np
import pytest
import torch

import petibm_tpu_torch.boundary as tb
import petibm_tpu_torch.io.probes as tprobes
import petibm_tpu_torch.io.vorticity as tvort
import petibm_tpu_torch.mesh as tm
from petibm_tpu_torch.cli import vorticity as tcli
from petibm_tpu_torch.io import hdf5 as thdf5
from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver
from petibm_tpu_torch.types import Field

torch.set_num_threads(2)

VIEWERS = ["hdf5", "ascii"]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side and h5py, imported here and not with the
    module: the card-only test runs where neither is installed."""
    import h5py
    import jax.numpy as jnp

    import petibm_tpu.boundary as jb
    import petibm_tpu.io.probes as jprobes
    import petibm_tpu.io.vorticity as jvort
    import petibm_tpu.mesh as jm
    from petibm_tpu.cli import vorticity as jcli
    from petibm_tpu.solvers.navierstokes import NavierStokesSolver

    return types.SimpleNamespace(h5py=h5py, jnp=jnp, boundary=jb,
                                 probes=jprobes, vort=jvort, mesh=jm,
                                 cli=jcli, NS=NavierStokesSolver)


def cavity_config(nx, ny):
    """tests/test_mesh.py's unit-square cavity (Dirichlet walls at rest)."""
    return {
        "mesh": [{"direction": d, "start": 0.0, "subDomains": [
            {"end": 1.0, "cells": n, "stretchRatio": 1.0}]}
            for d, n in (("x", nx), ("y", ny))],
        "flow": {"nu": 0.01, "initialVelocity": [0.0, 0.0],
                 "boundaryConditions": [
                     {"location": loc, "u": ["DIRICHLET", 0.0],
                      "v": ["DIRICHLET", 0.0]}
                     for loc in ("xMinus", "xPlus", "yMinus", "yPlus")]},
    }


def run_config(tmp_path, nt):
    """tests/test_navierstokes.py's lid-driven cavity run, 16^2."""
    cfg = cavity_config(16, 16)
    cfg["flow"]["boundaryConditions"][3]["u"] = ["DIRICHLET", 1.0]  # lid
    cfg["parameters"] = {
        "dt": 0.01, "startStep": 0, "nt": nt, "nsave": 10, "nrestart": 10,
        "convection": "ADAMS_BASHFORTH_2", "diffusion": "CRANK_NICOLSON",
        "velocitySolver": {"type": "CPU"}, "poissonSolver": {"type": "CPU"}}
    cfg["directory"] = str(tmp_path)
    cfg["output"] = str(tmp_path / "output")
    cfg["logs"] = str(tmp_path / "output" / "logs")
    return cfg


def tgv3d_config():
    """A 3D mesh, periodic in z, stretched in x (tests/test_torch_host.py's
    ``tgv3d_config``)."""
    from test_torch_host import tgv3d_config as make

    return make()


def _numbers(path):
    """The lines of a probe file, each split into words and numbers."""
    out = []
    for line in open(path).read().splitlines():
        words = []
        for w in line.replace("\t", " ").split():
            try:
                words.append(float(w))
            except ValueError:
                words.append(w)
        out.append(words)
    return out


def _h5_items(path):
    import h5py

    items = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            items[name] = (np.asarray(obj), dict(obj.attrs))

    with h5py.File(path) as fh:
        fh.visititems(visit)
    return items


def _is_hdf5(path):
    with open(path, "rb") as fh:
        return fh.read(8) == b"\x89HDF\r\n\x1a\n"


def assert_probe_files_match(got, want, tol=1e-12):
    if _is_hdf5(want):
        g, w = _h5_items(got), _h5_items(want)
        assert sorted(g) == sorted(w)
        for key, (arr, attrs) in w.items():
            assert g[key][0].dtype == arr.dtype, key
            assert g[key][1] == attrs, key
            np.testing.assert_allclose(g[key][0], arr, rtol=0,
                                       atol=tol * max(np.abs(arr).max(), 1e-300))
        return
    g, w = _numbers(got), _numbers(want)
    assert len(g) == len(w) and len(w) > 0
    scale = max([abs(x) for line in w for x in line
                 if isinstance(x, float)] + [1e-300])
    for lg, lw in zip(g, w):
        assert len(lg) == len(lw)
        for a, b in zip(lg, lw):
            if isinstance(b, float):
                assert abs(a - b) <= tol * scale, (a, b)
            else:
                assert a == b


def _meshes(cfg, jx):
    return tm.StaggeredMesh(cfg), jx.mesh.StaggeredMesh(cfg)


def _both(node, tmp_path, make, jx):
    """The port's and JAX's probe for one node, each writing its own file."""
    out = {}
    for tag, mod in (("port", tprobes), ("jax", jx.probes)):
        path = tmp_path / tag / os.path.basename(node["path"])
        out[tag] = make(mod, dict(node, path=str(path)))
    return out


@pytest.mark.parametrize("viewer", VIEWERS)
def test_volume_probe_box_and_gating(tmp_path, viewer, jx):
    """test_io_aux.py:22: the box, the gating by n_monitor, the values."""
    jnp, jb, jvort, h5py = jx.jnp, jx.boundary, jx.vort, jx.h5py
    cfg = cavity_config(8, 8)
    tmesh, jmesh = _meshes(cfg, jx)
    ext = "h5" if viewer == "hdf5" else "txt"
    node = {"type": "VOLUME", "field": "p", "path": f"probe.{ext}",
            "viewer": viewer, "n_monitor": 2,
            "box": {"x": [0.2, 0.6], "y": [0.2, 0.6]}}
    probes = _both(node, tmp_path, lambda mod, n: mod.create_probe(
        n, tmesh if mod is tprobes else jmesh), jx)
    assert probes["port"].start == probes["jax"].start
    assert probes["port"].npts == probes["jax"].npts
    np.testing.assert_array_equal(probes["port"].natural_is,
                                  probes["jax"].natural_is)
    p = np.arange(64, dtype=np.float64).reshape(8, 8)
    for n, t in ((1, 0.1), (2, 0.2), (4, 99.0)):  # the first is gated out
        probes["port"].monitor({"p": torch.as_tensor(p)}, n=n, t=t)
        probes["jax"].monitor({"p": jnp.asarray(p)}, n=n, t=t)
    got, want = (tmp_path / k / f"probe.{ext}" for k in ("port", "jax"))
    assert open(got, "rb").read() == open(want, "rb").read() or viewer == "hdf5"
    assert_probe_files_match(got, want, tol=0.0)
    if viewer == "hdf5":
        with h5py.File(got) as fh:
            keys = sorted(fh["p"].keys())
            assert len(keys) == 2
            np.testing.assert_array_equal(np.asarray(fh["p"][keys[0]]),
                                          p[probes["port"]._slices()])


@pytest.mark.parametrize("viewer", VIEWERS)
def test_volume_probe_time_average(tmp_path, viewer, jx):
    """test_io_aux.py:47: n_sum 3 over six calls, float32 fields."""
    jnp, jb, jvort, h5py = jx.jnp, jx.boundary, jx.vort, jx.h5py
    cfg = cavity_config(6, 6)
    tmesh, jmesh = _meshes(cfg, jx)
    node = {"type": "VOLUME", "field": "p", "path": "avg.out",
            "viewer": viewer, "n_sum": 3,
            "box": {"x": [0.0, 1.0], "y": [0.0, 1.0]}}
    probes = _both(node, tmp_path, lambda mod, n: mod.create_probe(
        n, tmesh if mod is tprobes else jmesh), jx)
    rng = np.random.default_rng(3)
    for n in range(1, 7):
        p = (float(n) + rng.standard_normal((6, 6))).astype(np.float32)
        probes["port"].monitor({"p": torch.as_tensor(p)}, n=n, t=0.01 * n)
        probes["jax"].monitor({"p": jnp.asarray(p)}, n=n, t=0.01 * n)
    got, want = (tmp_path / k / "avg.out" for k in ("port", "jax"))
    assert_probe_files_match(got, want, tol=0.0)
    if viewer == "hdf5":
        with h5py.File(got) as fh:
            keys = sorted(fh["p"].keys())
            assert len(keys) == 2 and fh["p"][keys[0]].attrs["count"] == 3
    else:
        assert open(got).read().count("count = 3") == 2


@pytest.mark.parametrize("field", ["u", "v", "p"])
def test_point_probe_interpolates_linear_field(tmp_path, field, jx):
    """test_io_aux.py:64: a linear field is interpolated exactly; the
    port's line equals JAX's (the velocity ghosts from the BCs, the
    pressure edge-padded), a point near the wall included."""
    jnp, jb, jvort, h5py = jx.jnp, jx.boundary, jx.vort, jx.h5py
    cfg = cavity_config(8, 8)
    cfg["mesh"][0]["subDomains"][0]["stretchRatio"] = 1.1
    tmesh, jmesh = _meshes(cfg, jx)
    tbc, jbc = tb.BoundarySet(tmesh, cfg), jb.BoundarySet(jmesh, cfg)
    a, b, c = 0.2, 1.5, -0.8
    q = {}
    for k, f in (("u", Field.U), ("v", Field.V), ("p", Field.P)):
        x = jmesh.bcast(f, 0, jmesh.coord(f, 0))
        y = jmesh.bcast(f, 1, jmesh.coord(f, 1))
        q[k] = np.array(np.broadcast_to(a + b * x + c * y, jmesh.shape(f)))
    for n, loc in enumerate(([0.43, 0.57], [0.02, 0.97])):
        node = {"type": "POINT", "field": field, "path": f"pt{n}.txt",
                "loc": loc, "n_monitor": 1}
        probes = _both(node, tmp_path, lambda mod, nd: mod.ProbePoint(
            nd, tmesh if mod is tprobes else jmesh,
            tbc if mod is tprobes else jbc), jx)
        tq = {k: torch.as_tensor(v) for k, v in q.items()}
        jq = {k: jnp.asarray(v) for k, v in q.items()}
        tfields = dict(tq, _bcstate=tbc.init_state(
            {k: tq[k] for k in "uv"}))
        jfields = dict(jq, _bcstate=jbc.init_state(
            {k: jq[k] for k in "uv"}))
        for step in (1, 2):
            probes["port"].monitor(tfields, n=step, t=0.5 * step)
            probes["jax"].monitor(jfields, n=step, t=0.5 * step)
        probes["port"].close()
        probes["jax"].close()
        got, want = (tmp_path / k / f"pt{n}.txt" for k in ("port", "jax"))
        assert open(got).read() == open(want).read()
        if n == 0:
            t, val = np.loadtxt(got)[0]
            assert t == 0.5
            np.testing.assert_allclose(val, a + b * 0.43 + c * 0.57,
                                       rtol=1e-8)


VORT_CASES = {"2d": lambda: cavity_config(10, 7), "3d": tgv3d_config}


@pytest.mark.parametrize("name", sorted(VORT_CASES))
def test_vorticity_matches_jax(name, jx):
    """compute_vorticity on seeded fields to 1e-12, and its grids."""
    jnp, jb, jvort, h5py = jx.jnp, jx.boundary, jx.vort, jx.h5py
    cfg = VORT_CASES[name]()
    if name == "2d":
        cfg["mesh"][1]["subDomains"][0]["stretchRatio"] = 1.08
    tmesh, jmesh = _meshes(cfg, jx)
    tbc, jbc = tb.BoundarySet(tmesh, cfg), jb.BoundarySet(jmesh, cfg)
    rng = np.random.default_rng(4)
    q = {("u", "v", "w")[c]: rng.standard_normal(jmesh.shape(Field(c)))
         for c in range(jmesh.dim)}
    tq = {k: torch.as_tensor(v) for k, v in q.items()}
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    got = tvort.compute_vorticity(tmesh, tbc, tq, tbc.init_state(tq))
    want = jvort.compute_vorticity(jmesh, jbc, jq, jbc.init_state(jq))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == torch.float64 and tuple(got[k].shape) == w.shape
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-12 * np.abs(w).max())
    tg, jg = tvort.vorticity_meshes(tmesh), jvort.vorticity_meshes(jmesh)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        for a, b in zip(tg[k], jg[k]):
            # the copied mesh's coordinates equal the JAX mesh's to
            # rounding (tests/test_torch_host.py)
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_vorticity_rigid_rotation():
    """test_io_aux.py:84: u = -y, v = x gives wz = 2 inside."""
    cfg = cavity_config(10, 10)
    mesh = tm.StaggeredMesh(cfg)
    bcs = tb.BoundarySet(mesh, cfg)
    yu = mesh.bcast(Field.U, 1, mesh.coord(Field.U, 1))
    xv = mesh.bcast(Field.V, 0, mesh.coord(Field.V, 0))
    q = {"u": torch.as_tensor(np.array(np.broadcast_to(-yu,
                                                       mesh.shape(Field.U)))),
         "v": torch.as_tensor(np.array(np.broadcast_to(xv,
                                                       mesh.shape(Field.V))))}
    w = tvort.compute_vorticity(mesh, bcs, q, bcs.init_state(q))
    assert tuple(w["wz"].shape) == (11, 11)
    np.testing.assert_allclose(w["wz"][1:-1, 1:-1].numpy(), 2.0, rtol=1e-12)


def _write_case(d, cfg, rng, h5py):
    import yaml

    """A case directory: config.yaml, grid.h5 and snapshots 0 and 2 of
    seeded velocity fields."""
    os.makedirs(d / "output")
    body = {k: cfg[k] for k in ("mesh", "flow")}
    body["parameters"] = {"dt": 0.01, "nt": 2, "nsave": 2}
    (d / "config.yaml").write_text(yaml.safe_dump(body))
    mesh = tm.StaggeredMesh(cfg)
    thdf5.write_grid(mesh, str(d / "output" / "grid.h5"))
    for ite in (0, 2):
        with h5py.File(d / "output" / f"{ite:07d}.h5", "w") as fh:
            for c in range(mesh.dim):
                fh.create_dataset(("u", "v", "w")[c], data=rng.standard_normal(
                    mesh.shape(Field(c))))


@pytest.mark.parametrize("name", sorted(VORT_CASES))
def test_vorticity_cli_matches_jax(tmp_path, name, capsys, jx):
    jnp, jb, jvort, h5py = jx.jnp, jx.boundary, jx.vort, jx.h5py
    cfg = VORT_CASES[name]()
    _write_case(tmp_path / "jax", cfg, np.random.default_rng(6), h5py)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    assert jx.cli.main(["-directory", str(tmp_path / "jax")]) == 0
    assert tcli.main(["-directory", str(tmp_path / "port"),
                      "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("wrote") == 4
    for fname in ("grid.h5", "0000000.h5", "0000002.h5"):
        got = _h5_items(tmp_path / "port" / "output" / fname)
        want = _h5_items(tmp_path / "jax" / "output" / fname)
        assert sorted(got) == sorted(want)
        assert any(k.split("/")[0] in ("wx", "wy", "wz") for k in want)
        for key, (arr, _) in want.items():
            assert got[key][0].dtype == arr.dtype, key
            np.testing.assert_allclose(got[key][0], arr, rtol=0,
                                       atol=1e-12 * np.abs(arr).max())


def _solver_probes():
    return [
        {"type": "POINT", "field": "u", "path": "probe-u.txt",
         "loc": [0.5, 0.75]},
        {"type": "POINT", "field": "p", "path": "probe-pp.txt",
         "loc": [0.31, 0.22], "n_monitor": 2},
        {"type": "VOLUME", "field": "p", "viewer": "hdf5",
         "path": "probe-p.h5", "box": {"x": [0.0, 1.0], "y": [0.4, 0.6]}},
        {"type": "VOLUME", "field": "v", "viewer": "ascii", "n_sum": 2,
         "path": "probe-v.txt", "box": {"x": [0.2, 0.5], "y": [0.1, 0.9]}},
    ]


def test_probes_through_solver(tmp_path, jx):
    """test_io_aux.py:104: the probes of a 4-step cavity run, each file
    against JAX's; the port's fields stay on their device."""
    jnp, jb, jvort, h5py = jx.jnp, jx.boundary, jx.vort, jx.h5py
    paths = {}
    for tag, cls, kw in (("jax", jx.NS, {}), ("port", NavierStokesSolver,
                                              {"device": "cpu"})):
        cfg = run_config(tmp_path / tag, nt=4)
        cfg["parameters"]["dtype"] = "float64"
        cfg["probes"] = _solver_probes()
        solver = cls(cfg, **kw)
        solver.run()
        solver.close()
        paths[tag] = tmp_path / tag / "output"
    pts = np.loadtxt(paths["port"] / "probe-u.txt")
    assert pts.shape == (4, 2)
    with h5py.File(paths["port"] / "probe-p.h5") as fh:
        assert len(fh["p"].keys()) == 4
    for probe in _solver_probes():
        assert_probe_files_match(paths["port"] / probe["path"],
                                 paths["jax"] / probe["path"])


@pytest.mark.cuda
def test_cuda_probes_match_cpu(tmp_path):
    """The probes of a cavity run on the card against the same run on the
    CPU (ASCII writers: the card may have no h5py), float64, to 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    probes = [p for p in _solver_probes() if p.get("viewer") != "hdf5"]
    for dev in ("cuda", "cpu"):
        cfg = run_config(tmp_path / dev, nt=6)
        cfg["parameters"]["dtype"] = "float64"
        cfg["probes"] = probes
        solver = NavierStokesSolver(cfg, device=dev)
        solver.run()
        solver.close()
    for probe in probes:
        assert_probe_files_match(tmp_path / "cuda" / "output" / probe["path"],
                                 tmp_path / "cpu" / "output" / probe["path"])
