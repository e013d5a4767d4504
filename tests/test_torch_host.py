"""The port's copied host modules against their JAX-package originals
(float64, 1e-12), and the port's import isolation from jax.

petibm_tpu_torch copies the numpy-only host modules (types, timeintegration,
config, mesh, ics, ibm/body, utils/timers, io/hdf5 and io/xdmf) because
importing any module of petibm_tpu imports jax (petibm_tpu/__init__.py).
These tests hold each copy equal to its original."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import petibm_tpu.config as jconfig
import petibm_tpu.ibm.body as jbody
import petibm_tpu.ics as jics
import petibm_tpu.mesh as jmesh
import petibm_tpu.timeintegration as jti
import petibm_tpu.types as jtypes
import petibm_tpu_torch.config as tconfig
import petibm_tpu_torch.ibm.body as tbody
import petibm_tpu_torch.ics as tics
import petibm_tpu_torch.mesh as tmesh
import petibm_tpu_torch.timeintegration as tti
import petibm_tpu_torch.types as ttypes
from petibm_tpu_torch.utils.timers import StageTimers

from test_mesh import cavity_config, periodic_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PI = 3.141592653589793


def cylinder_config(tmpdir=None):
    """The flagship's 450^2 stretched cylinder mesh (bench.py:43-83)."""
    axes = [{"direction": d, "start": -15.0, "subDomains": [
        {"end": -0.6, "cells": 120, "stretchRatio": 0.975},
        {"end": 0.6, "cells": 120, "stretchRatio": 1.0},
        {"end": 15.0, "cells": 210, "stretchRatio": 1.02}]}
        for d in ("x", "y")]
    cfg = cavity_config(4, 4)
    cfg["mesh"] = axes
    cfg["flow"]["initialVelocity"] = [1.0, 0.0]
    cfg["flow"]["boundaryConditions"] = [
        {"location": "xMinus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
        {"location": "xPlus", "u": ["CONVECTIVE", 1.0], "v": ["CONVECTIVE", 1.0]},
        {"location": "yMinus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]},
        {"location": "yPlus", "u": ["DIRICHLET", 1.0], "v": ["DIRICHLET", 0.0]}]
    return cfg


def tgv3d_config():
    """A 3D mesh, periodic in z, stretched in x, with symbolic ICs."""
    cfg = {
        "mesh": [
            {"direction": "x", "start": 0.0, "subDomains": [
                {"end": 1.0, "cells": 7, "stretchRatio": 1.1},
                {"end": 2.0, "cells": 5, "stretchRatio": 0.9}]},
            {"direction": "y", "start": -1.0,
             "subDomains": [{"end": 1.0, "cells": 6, "stretchRatio": 1.0}]},
            {"direction": "z", "start": 0.0,
             "subDomains": [{"end": 2 * PI, "cells": 8, "stretchRatio": 1.0}]},
        ],
        "flow": {
            "nu": 0.02,
            "initialVelocity": ["sin(x) * cos(z) * exp(-nu * t)",
                                "x * y + t", "cos(y + z)"],
            "initialPressure": "x**2 - y * z",
            "boundaryConditions": [
                {"location": loc, "u": [bct, 0.0], "v": [bct, 0.0],
                 "w": [bct, 0.0]}
                for loc, bct in (("xMinus", "DIRICHLET"),
                                 ("xPlus", "NEUMANN"),
                                 ("yMinus", "DIRICHLET"),
                                 ("yPlus", "DIRICHLET"),
                                 ("zMinus", "PERIODIC"),
                                 ("zPlus", "PERIODIC"))],
        },
    }
    return cfg


def stretched_cavity():
    cfg = cavity_config(19, 13)
    cfg["mesh"][0]["subDomains"][0]["stretchRatio"] = 1.15
    return cfg


MESH_CONFIGS = {
    "cylinder450": cylinder_config,
    "cavity": stretched_cavity,
    "periodic": lambda: periodic_config(10, 7),
    "3d_zperiodic": tgv3d_config,
}


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-12,
                               atol=1e-12 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("name", sorted(MESH_CONFIGS))
def test_mesh_copy_matches_original(name):
    cfg = MESH_CONFIGS[name]()
    a, b = tmesh.StaggeredMesh(cfg), jmesh.StaggeredMesh(cfg)
    assert a.dim == b.dim and list(a.periodic) == list(b.periodic)
    _close(a.min, b.min)
    _close(a.max, b.max)
    for d in range(a.dim):
        _close(a.dxp[d], b.dxp[d])
    for fa, fb in zip(a.fields, b.fields):
        assert int(fa) == int(fb)
        assert a.shape(fa) == b.shape(fb)
        for la, lb in zip(a.lines[fa], b.lines[fb]):
            assert la.n == lb.n
            _close(la.coord, lb.coord)
            _close(la.dl, lb.dl)
            _close(la.dneg(), lb.dneg())
            _close(la.dpos(), lb.dpos())
    assert a.info() == b.info()


@pytest.mark.parametrize("kind", ["make_r", "make_rinv", "make_mhat",
                                  "make_m"])
@pytest.mark.parametrize("name", sorted(MESH_CONFIGS))
def test_diag_operators_match_original(name, kind):
    """operators/diag.py (a port, not a copy: tensors on a device) against
    the JAX package's, float64."""
    import jax.numpy as jnp

    import petibm_tpu.operators.diag as jdiag
    import petibm_tpu_torch.operators.diag as tdiag

    cfg = MESH_CONFIGS[name]()
    got = getattr(tdiag, kind)(tmesh.StaggeredMesh(cfg),
                               dtype=torch.float64, device="cpu")
    want = getattr(jdiag, kind)(jmesh.StaggeredMesh(cfg), jnp.float64)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == torch.float64
        _close(got[key].numpy(), want[key])


def test_stretch_grid_copy_matches_original():
    for args in ((0.0, 2.0, 10, 1.1), (-15.0, -0.6, 120, 0.975),
                 (0.6, 15.0, 210, 1.02), (0.0, 1.0, 7, 1.0)):
        _close(tmesh.stretch_grid(*args), jmesh.stretch_grid(*args))


@pytest.mark.parametrize("name", sorted(MESH_CONFIGS))
def test_ics_copy_matches_original(name):
    cfg = MESH_CONFIGS[name]()
    if name == "periodic":
        cfg["flow"]["initialVelocity"] = ["cos(2*pi*x) * sin(y)", "- x * y"]
        cfg["flow"]["initialPressure"] = "exp(-x) + t"
    a = tics.initial_fields(cfg, tmesh.StaggeredMesh(cfg), t=0.3)
    b = jics.initial_fields(cfg, jmesh.StaggeredMesh(cfg), t=0.3)
    assert sorted(a) == sorted(b)
    for key in b:
        _close(a[key], b[key])


def _write_body(path, n, dim=2):
    rng = np.random.default_rng(7)
    with open(path, "w") as fh:
        fh.write(f"{n}\n")
        for row in rng.uniform(-0.4, 0.4, size=(n, dim)):
            fh.write("\t".join(f"{v:.10e}" for v in row) + "\n")


def test_body_copy_matches_original(tmp_path):
    cfg = cylinder_config()
    cfg["directory"] = str(tmp_path)
    _write_body(tmp_path / "a.body", 37)
    _write_body(tmp_path / "b.body", 11)
    cfg["bodies"] = [{"type": "points", "file": "a.body"},
                     {"type": "points", "file": str(tmp_path / "b.body"),
                      "name": "second"}]
    a = tbody.BodyPack(cfg, tmesh.StaggeredMesh(cfg))
    b = jbody.BodyPack(cfg, jmesh.StaggeredMesh(cfg))
    assert (a.n_bodies, a.n_pts) == (b.n_bodies, b.n_pts)
    assert a.slices() == b.slices()
    assert [x.name for x in a.bodies] == [x.name for x in b.bodies]
    _close(a.all_coords(), b.all_coords())
    for ba, bb in zip(a.bodies, b.bodies):
        np.testing.assert_array_equal(ba.mesh_idx(a.mesh), bb.mesh_idx(b.mesh))
    f = np.random.default_rng(1).standard_normal((a.n_pts, 2))
    for fa, fb in zip(a.avg_forces(f), b.avg_forces(f)):
        _close(fa, fb)
    tbody.write_lagrangian_points(str(tmp_path / "t.body"), a.all_coords())
    jbody.write_lagrangian_points(str(tmp_path / "j.body"), b.all_coords())
    _close(np.loadtxt(tmp_path / "t.body"), np.loadtxt(tmp_path / "j.body"))


def test_enums_and_time_integration_copies_match():
    for name in ("Dir", "Field", "BCType", "BCLoc", "ProbeType"):
        ta, tb = getattr(ttypes, name), getattr(jtypes, name)
        assert [(m.name, int(m)) for m in ta] == [(m.name, int(m)) for m in tb]
    for name in ("STR2DIR", "STR2FIELD", "STR2BCTYPE", "STR2BCLOC"):
        ma, mb = getattr(ttypes, name), getattr(jtypes, name)
        assert {k: int(v) for k, v in ma.items()} == {
            k: int(v) for k, v in mb.items()}
    assert ttypes.FIELD_NAMES == jtypes.FIELD_NAMES
    assert {k: (v.name, v.implicit_coeff, v.explicit_coeffs)
            for k, v in tti.SCHEMES.items()} == {
        k: (v.name, v.implicit_coeff, v.explicit_coeffs)
        for k, v in jti.SCHEMES.items()}


def test_config_copy_matches_original(tmp_path):
    (tmp_path / "config").mkdir()
    (tmp_path / "config" / "p.info").write_text(
        "-poisson_ksp_type cg\n-poisson_ksp_atol 1.0E-08\n"
        "-poisson_ksp_rtol 0.0\n-poisson_pc_type gamg\n")
    (tmp_path / "config" / "amgx.info").write_text(
        "config_version=2\nsolver(s1)=PCG\ns1:tolerance=1e-6\n"
        "s1:convergence=RELATIVE_INI_CORE\ns1:max_iters=500\n"
        "s1:preconditioner(amg)=AMG\namg:max_iters=1\n")
    (tmp_path / "config.yaml").write_text(
        "parameters:\n  dt: 0.01\n  poissonSolver:\n    type: CPU\n"
        "    config: config/p.info\n  velocitySolver:\n    type: GPU\n"
        "    config: config/amgx.info\n  forcesSolver:\n    atol: 1.0e-7\n"
        "    dense: false\n")
    a = tconfig.load_config(directory=str(tmp_path))
    b = jconfig.load_config(directory=str(tmp_path))
    assert a == b
    for role in ("poisson", "velocity", "forces"):
        assert tconfig.solver_config(a, role) == jconfig.solver_config(b, role)


def test_timers_copy():
    timers = StageTimers()
    with timers.stage("step"):
        pass
    with timers.stage("step"):
        pass
    assert timers.count == {"step": 2}
    assert "step" in timers.report()


def _h5_datasets(path) -> dict:
    import h5py

    out = {}
    with h5py.File(path, "r") as fh:
        fh.visititems(lambda name, obj: out.__setitem__(
            name, (np.asarray(obj), dict(obj.attrs)))
            if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_h5(a, b, exact=True):
    """Same dataset names, dtypes, shapes and attributes; the values equal,
    or with ``exact`` false to the mesh copy's 1e-12."""
    da, db = _h5_datasets(a), _h5_datasets(b)
    assert sorted(da) == sorted(db)
    for key in db:
        (xa, attrs_a), (xb, attrs_b) = da[key], db[key]
        assert xa.dtype == xb.dtype and xa.shape == xb.shape, key
        if exact:
            np.testing.assert_array_equal(xa, xb, err_msg=key)
        else:
            _close(xa, xb)
        assert attrs_a == attrs_b, key


@pytest.mark.parametrize("name", sorted(MESH_CONFIGS))
def test_hdf5_grid_copy_matches_original(tmp_path, name):
    import petibm_tpu.io.hdf5 as jhdf5
    import petibm_tpu_torch.io.hdf5 as thdf5

    cfg = MESH_CONFIGS[name]()
    thdf5.write_grid(tmesh.StaggeredMesh(cfg), str(tmp_path / "t.h5"))
    jhdf5.write_grid(jmesh.StaggeredMesh(cfg), str(tmp_path / "j.h5"))
    # the stretched lines of the mesh copy round as its test allows
    _assert_same_h5(tmp_path / "t.h5", tmp_path / "j.h5", exact=False)


def test_hdf5_solution_and_restart_copy_matches_original(tmp_path):
    """write_solution, write_time and write_restart_histories of the copy
    and of the original write the same file from the same arrays (float32
    ones too: both store float64); each package reads either file back to
    the same arrays."""
    import petibm_tpu.io.hdf5 as jhdf5
    import petibm_tpu_torch.io.hdf5 as thdf5

    rng = np.random.default_rng(11)
    shapes = {"u": (6, 5, 4), "v": (6, 4, 5), "w": (5, 5, 5)}

    def qdict(dtype=np.float64):
        return {k: rng.standard_normal(sh).astype(dtype)
                for k, sh in shapes.items()}

    fields = dict(qdict(np.float32), p=rng.standard_normal((6, 5, 5)))
    conv, diff = [qdict(), qdict()], [qdict()]
    extra = {"dP": rng.standard_normal((6, 5, 5)),
             "force": rng.standard_normal((7, 3)).astype(np.float32),
             "bc_u_xMinus_a1": rng.standard_normal((6, 5))}
    for mod, name in ((thdf5, "t.h5"), (jhdf5, "j.h5")):
        path = str(tmp_path / name)
        mod.write_solution(path, fields)
        mod.write_time(path, 0.1 + 0.2)
        mod.write_restart_histories(path, 3, conv, diff, extra=extra)
    _assert_same_h5(tmp_path / "t.h5", tmp_path / "j.h5")
    for name in ("t.h5", "j.h5"):
        path = str(tmp_path / name)
        assert thdf5.read_time(path) == jhdf5.read_time(path) == 0.1 + 0.2
        a = thdf5.read_solution(path, list(fields))
        b = jhdf5.read_solution(path, list(fields))
        for key in fields:
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a[key], fields[key])
        ra = thdf5.read_restart_histories(path, 3, shapes, 2, 1,
                                          extra_names=(*extra, "dF"))
        rb = jhdf5.read_restart_histories(path, 3, shapes, 2, 1,
                                          extra_names=(*extra, "dF"))
        for hist_a, hist_b, want in ((ra[0], rb[0], conv),
                                     (ra[1], rb[1], diff)):
            for ha, hb, w in zip(hist_a, hist_b, want):
                for key in shapes:
                    np.testing.assert_array_equal(ha[key], hb[key])
                    np.testing.assert_array_equal(ha[key], w[key])
        assert sorted(ra[2]) == sorted(rb[2]) == sorted(extra)
        for key in extra:
            np.testing.assert_array_equal(ra[2][key], rb[2][key])
            np.testing.assert_array_equal(ra[2][key], extra[key].ravel())
    assert thdf5.hdf5_available()


@pytest.mark.parametrize("dim", [2, 3])
def test_xdmf_copy_matches_original(tmp_path, dim):
    import petibm_tpu.io.xdmf as jxdmf
    import petibm_tpu_torch.io.xdmf as txdmf

    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    n = [12, 10, 8][:dim] + [1] * (3 - dim)
    a = txdmf.write_single_xdmf(str(tmp_path / "t"), "u", dim, n, 0, 20, 5)
    b = jxdmf.write_single_xdmf(str(tmp_path / "j"), "u", dim, n, 0, 20, 5)
    assert open(a).read() == open(b).read()


#: the port's copies of host modules -> their originals (paths in the repo)
COPIES = {
    "petibm_tpu_torch/native/__init__.py": "petibm_tpu/native/__init__.py",
    "petibm_tpu_torch/native/hostcore.cpp": "petibm_tpu/native/hostcore.cpp",
    "petibm_tpu_torch/mesh.py": "petibm_tpu/mesh.py",
    "petibm_tpu_torch/ibm/body.py": "petibm_tpu/ibm/body.py",
}


def _without_copy_note(text: str) -> str:
    """A copy's text without the paragraph of its module docstring that
    names its original ("Copy of ``petibm_tpu/...``")."""
    at = text.find("\n\nCopy of ``petibm_tpu/")
    if at < 0:
        return text
    end = text.index('"""', at)
    return text[:at] + "\n" + text[end:]


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_native_and_host_copies_equal_originals(copy):
    """The native hostcore and the modules that call it are copies: each
    equals its original but for the docstring paragraph that names it
    (the C++ source byte for byte)."""
    with open(os.path.join(REPO, copy)) as fh:
        got = fh.read()
    with open(os.path.join(REPO, COPIES[copy])) as fh:
        want = fh.read()
    if copy.endswith(".py"):
        assert f"Copy of ``{COPIES[copy]}``" in got
        got = _without_copy_note(got)
    assert got == want


@pytest.fixture(scope="module")
def sphere_body(tmp_path_factory):
    """A large 3D body: scripts/make_sphere_body.py's sphere at ds 0.01
    (31 416 points), as the refined sphere of chip_smoke.py's phase 12
    takes one."""
    path = tmp_path_factory.mktemp("sphere") / "sphere.body"
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_sphere_body.py"),
                    str(path), "--ds", "0.01"], check=True,
                   capture_output=True, timeout=120)
    return path


def _fallback(monkeypatch, *modules):
    """The numpy fallbacks: ``native.available()`` false in ``modules``."""
    for mod in modules:
        monkeypatch.setattr(mod, "available", lambda: False)


@pytest.mark.parametrize("entry", ["stretch_grid", "read_lagrangian_points",
                                   "write_lagrangian_points",
                                   "search_cells"])
def test_native_entries_match_jax_and_fallback(entry, tmp_path, sphere_body,
                                              monkeypatch):
    """Each hostcore entry of the port, called through the module that
    uses it, gives the JAX package's native output bit for bit, and the
    port's numpy fallback gives the same (a 2D body and the large 3D
    sphere among the inputs); ``stretch_grid``'s fallback to 1e-12, as
    the original's two paths agree."""
    import petibm_tpu.native as jnative
    import petibm_tpu_torch.native as tnative

    assert tnative.available() and jnative.available()
    small = tmp_path / "small.body"
    _write_body(small, 37)
    if entry == "stretch_grid":
        args = [(0.0, 2.0, 10, 1.1), (-15.0, -0.6, 120, 0.975),
                (0.6, 15.0, 210, 1.02), (0.0, 1.0, 7, 1.0)]

        def run(mesh):
            return [mesh.stretch_grid(*a) for a in args]

        want = [tnative.stretch_grid(*a) for a in args]
        for a, w in zip(args, want):
            np.testing.assert_array_equal(jnative.stretch_grid(*a), w)
    elif entry == "read_lagrangian_points":
        def run(body):
            return [body.read_lagrangian_points(str(p))
                    for p in (small, sphere_body)]

        want = [tnative.read_lagrangian_points(str(p))
                for p in (small, sphere_body)]
        assert want[1].shape == (31416, 3)
    elif entry == "write_lagrangian_points":
        coords = [tbody.read_lagrangian_points(str(p))
                  for p in (small, sphere_body)]
        counter = iter(range(100))

        def run(body):
            out = []
            for c in coords:
                path = tmp_path / f"w{next(counter)}.body"
                body.write_lagrangian_points(str(path), c)
                out.append(path.read_text())
            return out

        want = []
        for c in coords:
            path = tmp_path / f"n{next(counter)}.body"
            assert tnative.write_lagrangian_points(str(path), c)
            want.append(path.read_text())
    else:
        cfg = cylinder_config()
        sphere = tbody.read_lagrangian_points(str(sphere_body))
        pts = {2: np.random.default_rng(3).uniform(-14.9, 14.9, (500, 2)),
               3: sphere * 0.9 + 0.5}
        meshes = {2: cfg, 3: sphere_body_mesh()}

        def run(body):
            out = []
            for dim in (2, 3):
                mesh = (tmesh if body is tbody else jmesh).StaggeredMesh(
                    meshes[dim])
                out.append(body.SingleBody("b", pts[dim], dim)
                           .mesh_idx(mesh))
            return out

        want = []
        for dim in (2, 3):
            mesh = tmesh.StaggeredMesh(meshes[dim])
            want.append(np.stack(
                [tnative.search_cells(mesh.coord(tmesh.Field.VERTEX, d),
                                      pts[dim][:, d]) for d in range(dim)],
                axis=1))
    mod = tmesh if entry == "stretch_grid" else tbody
    jmod = jmesh if entry == "stretch_grid" else jbody
    got_native, got_jax = run(mod), run(jmod)
    _fallback(monkeypatch, tnative)
    got_numpy = run(mod)
    for w, a, j, f in zip(want, got_native, got_jax, got_numpy):
        if isinstance(w, str):
            assert a == j == w
            # the fallback formats as the native writer does
            assert f == w
        else:
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(j, w)
            if entry == "stretch_grid":
                # numpy's and the C++ loop's products round apart in the
                # last bit (the original's own two paths)
                _close(f, w)
            else:
                np.testing.assert_array_equal(f, w)


def sphere_body_mesh() -> dict:
    """A 3D stretched box around the unit sphere of ``sphere_body``
    (shifted by 0.5): 40 x 36 x 32 cells."""
    return {"mesh": [
        {"direction": d, "start": -1.0, "subDomains": [
            {"end": 0.0, "cells": n // 2, "stretchRatio": 0.97},
            {"end": 2.0, "cells": n - n // 2, "stretchRatio": 1.03}]}
        for d, n in (("x", 40), ("y", 36), ("z", 32))],
        "flow": {"nu": 0.01, "boundaryConditions": [
            {"location": d + side, "u": ["DIRICHLET", 0.0],
             "v": ["DIRICHLET", 0.0], "w": ["DIRICHLET", 0.0]}
            for d in "xyz" for side in ("Minus", "Plus")]}}


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import petibm_tpu_torch, petibm_tpu_torch.solvers.decoupledibpm, "
            "petibm_tpu_torch.cli.decoupledibpm, petibm_tpu_torch.convert, "
            "petibm_tpu_torch.operators.cuda_stencil, "
            "petibm_tpu_torch.solvers.navierstokes, "
            "petibm_tpu_torch.cli.navierstokes, "
            "petibm_tpu_torch.solvers.ibpm, petibm_tpu_torch.cli.ibpm, "
            "petibm_tpu_torch.operators.diag, "
            "petibm_tpu_torch.linalg.krylov, "
            "petibm_tpu_torch.linalg.probe_diag, "
            "petibm_tpu_torch.solvers.rigidkinematics, "
            "petibm_tpu_torch.cli.rigidkinematics, petibm_tpu_torch.io, "
            "petibm_tpu_torch.io.xdmf, petibm_tpu_torch.cli.createxdmf, "
            "petibm_tpu_torch.cli.writemesh, petibm_tpu_torch.ibm.interp, "
            "petibm_tpu_torch.io.probes, petibm_tpu_torch.io.vorticity, "
            "petibm_tpu_torch.cli.vorticity, petibm_tpu_torch.cli.common, "
            "petibm_tpu_torch.utils.profiling, petibm_tpu_torch.parallel, "
            "petibm_tpu_torch.parallel.dist, "
            "petibm_tpu_torch.parallel.multihost, "
            "petibm_tpu_torch.native, petibm_tpu_torch.mesh, "
            "petibm_tpu_torch.ibm.body\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'petibm_tpu.')) or m == 'petibm_tpu')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
