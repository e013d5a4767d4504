"""HDF5 output and restarts: the port's against the JAX package's.

Four solvers, each on a small case whose outlet is convective (its BC
ghost state evolves, so an exact restart must carry it):
- ``ns``: the plain projection step in the 16^2 channel of
  ``__graft_entry__._cylinder_config`` without its body;
- ``decoupled``: the 32^2 decoupled cylinder (``force`` and ``dF``
  extras);
- ``rigid``: the same cylinder oscillating in line
  (``test_torch_rigidkinematics.py``'s kinematics; body files too);
- ``coupled``: ``test_ibm.py``'s 30^2 ``ib_config`` under the coupled
  IBPM (``force``, ``dP`` and ``dF`` from dPhi).

Held:
- ``grid.h5`` and every ``<step>.h5`` (snapshots, and the restart groups
  at a restart point) of either package hold the other's dataset names,
  shapes and dtypes, its values (grid exactly, fields to 1e-9 of their
  maximum in float64) and the same ``time`` attribute on /p;
- inside the port on the CPU, 3 + 3 steps through a restart file equal 6
  continuous steps bit for bit, every leaf of the state (the BC ghost
  state, the histories and the warm starts included), for all four in
  float64; the moving body in float32 re-seeds its time from the file's
  float64 ``time`` (as the JAX package does), so it is held to the
  float32 tolerance, 1e-4 of each field's maximum;
- a restart file written by the JAX package loads into the port with
  every tensor equal to the file's arrays, and a port file into the JAX
  package; each continuation then equals the other package's continuous
  run to 1e-9 in float64;
- ``createxdmf`` and ``writemesh`` write what the JAX package's CLIs
  write;
- without h5py the port says so on stderr, writes no HDF5 file and its
  text logs, and refuses a restart start naming h5py.
"""

import os

import h5py
import numpy as np
import pytest
import torch

import petibm_tpu_torch.io as pio
from __graft_entry__ import _cylinder_config
from petibm_tpu.solvers.decoupledibpm import DecoupledIBPMSolver as JaxDIBPM
from petibm_tpu.solvers.ibpm import IBPMSolver as JaxIBPM
from petibm_tpu.solvers.navierstokes import NavierStokesSolver as JaxNS
from petibm_tpu.solvers.rigidkinematics import RigidKinematicsSolver as JaxRK
from petibm_tpu_torch.convert import state_to_numpy
from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_tpu_torch.solvers.ibpm import IBPMSolver
from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver
from petibm_tpu_torch.solvers.rigidkinematics import RigidKinematicsSolver
from test_ibm import ib_config
from test_torch_rigidkinematics import KINEMATICS

torch.set_num_threads(2)


def _cylinder(d, n, dtype, body=True, moving=False):
    (d / "output").mkdir(parents=True)
    (d / "logs").mkdir()
    cfg = _cylinder_config(n, str(d))
    cfg["parameters"]["dtype"] = dtype
    if not body:
        del cfg["bodies"]
    elif moving:
        cfg["bodies"][0]["kinematics"] = dict(KINEMATICS)
    return cfg


def _coupled(d, n, dtype):
    d.mkdir(parents=True)
    cfg = ib_config(d, n=n)
    cfg["parameters"]["dtype"] = dtype
    return cfg


#: name -> (config maker, JAX class, port class)
CASES = {
    "ns": (lambda d, dt: _cylinder(d, 16, dt, body=False), JaxNS,
           NavierStokesSolver),
    "decoupled": (lambda d, dt: _cylinder(d, 32, dt), JaxDIBPM,
                  DecoupledIBPMSolver),
    "rigid": (lambda d, dt: _cylinder(d, 32, dt, moving=True), JaxRK,
              RigidKinematicsSolver),
    "coupled": (lambda d, dt: _coupled(d, 30, dt), JaxIBPM, IBPMSolver),
}


def config(case, d, dtype="float64", **params):
    cfg = CASES[case][0](d, dtype)
    cfg["parameters"].update(params)
    return cfg


def make(case, package, cfg):
    _, jax_cls, port_cls = CASES[case]
    return jax_cls(cfg) if package == "jax" else port_cls(cfg, device="cpu")


def run(case, package, cfg):
    solver = make(case, package, cfg)
    solver.run()
    solver.close()
    return solver


def h5_tree(path) -> dict:
    """Every dataset of an HDF5 file by its path."""
    out = {}
    with h5py.File(path, "r") as fh:
        fh.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj))
                      if isinstance(obj, h5py.Dataset) else None)
        time = fh["p"].attrs.get("time") if "p" in fh else None
    return out, time


@pytest.mark.parametrize("case", sorted(CASES))
def test_h5_files_match_jax(case, tmp_path):
    params = dict(nt=4, nsave=2, nrestart=4)
    for package in ("jax", "port"):
        run(case, package, config(case, tmp_path / package, **params))
    names = ("grid.h5", "0000000.h5", "0000002.h5", "0000004.h5")
    for name in names:
        want, want_t = h5_tree(tmp_path / "jax" / "output" / name)
        got, got_t = h5_tree(tmp_path / "port" / "output" / name)
        assert sorted(got) == sorted(want), name
        assert got_t == want_t, name
        if name != "grid.h5":
            assert isinstance(got_t, np.float64)
        for key, w in want.items():
            g = got[key]
            assert g.shape == w.shape and g.dtype == w.dtype, (name, key)
            tol = 0.0 if name == "grid.h5" else 1e-9
            err = np.abs(g - w).max() if w.size else 0.0
            assert err <= tol * max(np.abs(w).max(), 1e-14), (name, key, err)
    restart, _ = h5_tree(tmp_path / "port" / "output" / "0000004.h5")
    groups = {k.split("/")[0] for k in restart}
    assert {"convection", "diffusion", "dP"} <= groups
    assert any(g.startswith("bc_") for g in groups)
    if case != "ns":
        assert {"force", "dF"} <= groups


def _leaves(state):
    """(path, array) of every leaf of a state tree."""
    if isinstance(state, dict):
        return [(f"{k}/{p}", a) for k in sorted(state)
                for p, a in _leaves(state[k])]
    if isinstance(state, (tuple, list)):
        return [(f"{i}/{p}", a) for i, item in enumerate(state)
                for p, a in _leaves(item)]
    return [("", np.asarray(state))]


def _restart_pair(case, tmp_path, dtype):
    """The port's 6 continuous steps and its 3 + 3 through the restart file
    of step 3 (in the first run's output directory)."""
    params = dict(nsave=3, nrestart=3)
    cont = run(case, "port", config(case, tmp_path / "cont", dtype, nt=6,
                                    **params))
    cfg = config(case, tmp_path / "split", dtype, nt=3, **params)
    run(case, "port", cfg)
    cfg["parameters"].update(startStep=3)
    restarted = run(case, "port", cfg)
    assert restarted.ite == cont.ite == 6 and restarted.t == cont.t
    return state_to_numpy(cont.state), state_to_numpy(restarted.state)


@pytest.mark.parametrize("case", sorted(CASES))
def test_restart_is_exact_inside_the_port(case, tmp_path):
    want, got = _restart_pair(case, tmp_path, "float64")
    wl, gl = _leaves(want), _leaves(got)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_rigid_float32_restart_to_float32_tolerance(tmp_path):
    """The float32 moving body's time after a restart is the file's
    float64 time rounded once, where the continuous run summed dt in
    float32: the JAX package's behaviour, kept; the fields agree to the
    float32 tolerance."""
    want, got = _restart_pair("rigid", tmp_path, "float32")
    assert got["t"].dtype == np.float32
    assert abs(float(got["t"]) - float(want["t"])) <= 2 * np.spacing(
        np.float32(want["t"]))
    for key, w, g in (("u", want["q"]["u"], got["q"]["u"]),
                      ("v", want["q"]["v"], got["q"]["v"]),
                      ("p", want["p"], got["p"]), ("f", want["f"], got["f"])):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-4, (key, err)


def _file_tensors(solver, path) -> dict:
    """The arrays of a restart file as the solver's state keys."""
    mesh = solver.mesh
    names = ["u", "v", "w"][:mesh.dim]
    data = pio.read_solution(path, names + ["p"])
    shapes = {n: mesh.shape(c) for c, n in enumerate(names)}
    conv, diff, extra = pio.read_restart_histories(
        path, mesh.dim, shapes, len(solver.state["conv"]),
        len(solver.state["diff"]), extra_names=tuple(solver._restart_extra()))
    return {"q": {n: data[n] for n in names}, "p": data["p"],
            "conv": conv, "diff": diff, "extra": extra}


def _np(value):
    return (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
            else np.asarray(value))


def _assert_state_is_file(solver, want: dict) -> None:
    state = solver.state
    for n, w in want["q"].items():
        np.testing.assert_array_equal(_np(state["q"][n]), w)
    np.testing.assert_array_equal(_np(state["p"]), want["p"])
    for key in ("conv", "diff"):
        assert len(state[key]) == len(want[key])
        for have, w in zip(state[key], want[key]):
            for n in w:
                np.testing.assert_array_equal(_np(have[n]), w[n])
    extra = solver._restart_extra()
    assert sorted(extra) == sorted(want["extra"])
    for key, w in want["extra"].items():
        np.testing.assert_array_equal(_np(extra[key]).ravel(), w,
                                      err_msg=key)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_restart_across_packages(case, writer, tmp_path):
    """The writer runs 3 steps and writes its restart file; the reader
    starts from it (every tensor equal to the file's arrays, its time the
    file's) and runs 3 more, equal to the writer's 6 continuous steps to
    1e-9."""
    reader = "port" if writer == "jax" else "jax"
    params = dict(nsave=3, nrestart=3)
    cont = run(case, writer, config(case, tmp_path / "cont", nt=6, **params))
    cfg = config(case, tmp_path / "split", nt=3, **params)
    run(case, writer, cfg)
    cfg["parameters"].update(startStep=3)
    path = tmp_path / "split" / "output" / "0000003.h5"
    solver = make(case, reader, cfg)
    solver.io_initial_data()
    _assert_state_is_file(solver, _file_tensors(solver, path))
    assert solver.t == h5_tree(path)[1]
    solver.run()  # reads the restart file again, then 3 steps
    solver.close()
    got, want = solver.state, cont.state
    pairs = [("u", got["q"]["u"], want["q"]["u"]),
             ("v", got["q"]["v"], want["q"]["v"]), ("p", got["p"], want["p"])]
    if case != "ns":
        pairs.append(("f", got["f"], want["f"]))
    for key, g, w in pairs:
        g, w = _np(g), _np(w)
        assert np.abs(g - w).max() <= 1e-9 * np.abs(w).max(), key


def test_createxdmf_and_writemesh_match_jax(tmp_path, capsys):
    from petibm_tpu.cli.createxdmf import main as jax_xdmf
    from petibm_tpu.cli.writemesh import main as jax_mesh
    from petibm_tpu_torch.cli.createxdmf import main as port_xdmf
    from petibm_tpu_torch.cli.writemesh import main as port_mesh
    from test_torch_decoupledibpm import _write_case

    cfg = config("decoupled", tmp_path / "src", nt=12, nsave=4)
    for package, mains in (("jax", (jax_xdmf, jax_mesh)),
                           ("port", (port_xdmf, port_mesh))):
        case = tmp_path / package
        _write_case(str(case), cfg)
        os.makedirs(case / "output")
        for main in mains:
            assert main(["-directory", str(case)]) == 0
    assert "wrote" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax" / "output"))
    assert names == sorted(os.listdir(tmp_path / "port" / "output"))
    xmf = ["p.xmf", "u.xmf", "v.xmf", "wz.xmf"]
    assert set(xmf + ["grid.h5"]) <= set(names)
    for name in xmf:
        assert ((tmp_path / "port" / "output" / name).read_text()
                == (tmp_path / "jax" / "output" / name).read_text())
    want, _ = h5_tree(tmp_path / "jax" / "output" / "grid.h5")
    got, _ = h5_tree(tmp_path / "port" / "output" / "grid.h5")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_without_h5py(tmp_path, monkeypatch, capsys):
    """Where h5py does not import: a note on stderr at init, no HDF5 file,
    the text logs and the body files written; a restart start raises
    naming h5py."""
    monkeypatch.setattr(pio, "hdf5_available", lambda: False)
    cfg = config("rigid", tmp_path / "run", nt=4, nsave=2, nrestart=2)
    solver = run("rigid", "port", cfg)
    err = capsys.readouterr().err
    assert err.count("h5py does not import") == 1
    out = sorted(os.listdir(tmp_path / "run" / "output"))
    assert not [n for n in out if n.endswith(".h5")]
    assert "iterations-0.txt" in out and "forces-0.txt" in out
    assert "body00_0000004.2D" in out
    assert solver.ite == 4
    cfg["parameters"].update(startStep=2)
    with pytest.raises(RuntimeError, match="h5py"):
        RigidKinematicsSolver(cfg, device="cpu")
