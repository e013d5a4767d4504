"""HDF5 I/O in the reference's exact file layout.

Reference layouts (so the reference's post-processing scripts keep working):
  - ``grid.h5`` (cartesianmesh.cpp:798-823): one group per field
    (u/v/w/p/vertex), 1D datasets x/y/z of interior gridline coordinates.
  - ``<0-padded step>.h5`` (solutionsimple.cpp:229-260 + io.cpp:137-167):
    root datasets u/v/w/p shaped (nz, ny, nx) per field (x fastest — the
    DMDA natural ordering), float64; ``time`` attribute on /p
    (navierstokes.cpp:797-815).
  - restart extras (navierstokes.cpp:637-688): groups /convection/<i> and
    /diffusion/<i> holding the packed velocity-space history vectors as flat
    1D datasets in u,v,w concatenation order (the single-rank DMComposite
    packed ordering); IBM apps add /force/0.

Copy of ``petibm_tpu/io/hdf5.py`` (held equal to the original by
tests/test_torch_host.py) with h5py imported inside each function, so
the port imports without it; ``hdf5_available`` says whether it is there.
"""

from __future__ import annotations

import numpy as np

from ..mesh import StaggeredMesh
from ..types import Field

VEL_NAMES = ("u", "v", "w")


def hdf5_available() -> bool:
    """Whether h5py imports (snapshots and restart files need it)."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def write_grid(mesh: StaggeredMesh, path: str) -> None:
    import h5py

    names = ("x", "y", "z")
    with h5py.File(path, "w") as fh:
        for f in [Field(c) for c in range(mesh.dim)] + [Field.P, Field.VERTEX]:
            grp = fh.create_group(f.name.lower() if f != Field.P else "p")
            for d in range(mesh.dim):
                grp.create_dataset(names[d], data=np.asarray(
                    mesh.coord(f, d), dtype=np.float64))


def write_solution(path: str, fields: dict, mode: str = "w") -> None:
    """Write u/v/w/p arrays as root datasets (float64, reference parity)."""
    import h5py

    with h5py.File(path, mode) as fh:
        for name, arr in fields.items():
            data = np.asarray(arr, dtype=np.float64)
            if name in fh:
                del fh[name]
            fh.create_dataset(name, data=data)


def read_solution(path: str, names) -> dict:
    import h5py

    with h5py.File(path, "r") as fh:
        return {name: np.asarray(fh[name]) for name in names}


def write_time(path: str, t: float) -> None:
    import h5py

    with h5py.File(path, "a") as fh:
        fh["p"].attrs["time"] = np.float64(t)


def read_time(path: str) -> float:
    import h5py

    with h5py.File(path, "r") as fh:
        return float(fh["p"].attrs["time"])


def _pack(qdict: dict, dim: int) -> np.ndarray:
    return np.concatenate(
        [np.asarray(qdict[VEL_NAMES[c]], dtype=np.float64).ravel()
         for c in range(dim)])


def _unpack(flat: np.ndarray, shapes: dict) -> dict:
    out = {}
    off = 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        out[name] = flat[off:off + n].reshape(shape)
        off += n
    return out


def write_restart_histories(path: str, dim: int, conv: list, diff: list,
                            extra: dict | None = None) -> None:
    """Append /convection/<i>, /diffusion/<i> (and e.g. /force/0) groups."""
    import h5py

    with h5py.File(path, "a") as fh:
        for group, hist in (("convection", conv), ("diffusion", diff)):
            if group in fh:
                del fh[group]
            g = fh.create_group(group)
            for i, item in enumerate(hist):
                g.create_dataset(str(i), data=_pack(item, dim))
        for name, arr in (extra or {}).items():
            if name in fh:
                del fh[name]
            g = fh.create_group(name)
            g.create_dataset("0", data=np.asarray(arr, dtype=np.float64).ravel())


def read_restart_histories(path: str, dim: int, shapes: dict, n_conv: int,
                           n_diff: int, extra_names=()) -> tuple:
    import h5py

    conv, diff, extra = [], [], {}
    with h5py.File(path, "r") as fh:
        for i in range(n_conv):
            conv.append(_unpack(np.asarray(fh[f"convection/{i}"]), shapes))
        for i in range(n_diff):
            diff.append(_unpack(np.asarray(fh[f"diffusion/{i}"]), shapes))
        for name in extra_names:
            # tolerate files from older runs / the reference layout that
            # lack native extras (dP, force, BC ghost state)
            if name in fh:
                extra[name] = np.asarray(fh[f"{name}/0"])
    return conv, diff, extra
