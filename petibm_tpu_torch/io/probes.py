"""Probes: volume sub-field monitors and interpolated point monitors.

Counterpart of ``petibm_tpu/io/probes.py`` (reference: src/misc/probes.cpp,
include/petibm/probes.h:30-382):
  - gating: monitor when ``n % n_monitor == 0`` and
    ``t_start <= t <= t_end`` (probes.cpp:114-148);
  - ProbeVolume: a box selects a sub-mesh of one field's grid
    (lower/upper_bound with atol, :267-310); its values go to ASCII
    ("t = <t>" and one value a line) or HDF5 (group "mesh" with x/y/z and
    the natural index "IS", group "<field>" with one dataset a time),
    optionally averaged over n_sum monitor calls (a "count" attribute,
    :489-573);
  - ProbePoint: bi/trilinear interpolation at a location over the
    ghost-extended field, ASCII lines "t<tab>value" (:607-687;
    lininterp.cpp:94-209).

The fields stay on their device: a volume probe copies its box to the
host, a point probe its 2^dim corner values, and the host arithmetic on
those values is the JAX package's, so the values written are equal.
h5py is imported inside the HDF5 writers (the port runs without it).

On a decomposed run (``part``, a ``parallel.dist.Partition``) every
rank monitors and rank 0 alone writes.  A volume probe gathers only its
box, each rank sending the box's part in its block
(``Partition.gather_box``); a point probe takes each corner from the
rank whose (ghost-extended) block holds it, and one all-reduce of the
2^dim values, zero where a rank holds none, brings them together.  No
probe gathers a whole field.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..mesh import StaggeredMesh
from ..types import STR2FIELD, Field

VEL_NAMES = ("u", "v", "w")
DIR_NAMES = ("x", "y", "z")


def create_probe(node: dict, mesh: StaggeredMesh, bcset=None, part=None):
    """Factory (reference: probes.cpp:23-51); ``part``: the rank's
    ``Partition`` of a decomposed run."""
    ptype = str(node.get("type", "VOLUME")).upper()
    if ptype == "VOLUME":
        return ProbeVolume(node, mesh, part=part)
    if ptype == "POINT":
        return ProbePoint(node, mesh, bcset, part=part)
    raise ValueError(f"unknown probe type {ptype}; accepted: VOLUME, POINT")


class ProbeBase:
    def __init__(self, node: dict, mesh: StaggeredMesh, part=None):
        self.mesh = mesh
        self.part = part
        #: whether this rank writes the file
        self.is_root = part is None or part.rank == 0
        self.name = node.get("name", "unnamed")
        self.field = int(STR2FIELD[node["field"]])
        self.path = node["path"]
        self.n_monitor = int(node.get("n_monitor", 1))
        self.t_start = float(node.get("t_start", 0.0))
        self.t_end = float(node.get("t_end", 1e12))

    def _field_name(self) -> str:
        return VEL_NAMES[self.field] if self.field < self.mesh.dim else "p"

    def _gated(self, n: int, t: float) -> bool:
        return n % self.n_monitor == 0 and self.t_start <= t <= self.t_end

    def monitor(self, fields: dict, n: int, t: float) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Nothing stays open (the point probe overrides)."""


class ProbeVolume(ProbeBase):
    def __init__(self, node: dict, mesh: StaggeredMesh, part=None):
        super().__init__(node, mesh, part)
        self.viewer = node.get("viewer", "ascii")
        self.atol = float(node.get("atol", 1e-6))
        self.n_sum = int(node.get("n_sum", 0))
        self._accum = None
        self._count = 0

        box = node["box"]
        self.start = [0] * mesh.dim
        self.npts = [1] * mesh.dim
        f = Field(self.field)
        for d in range(mesh.dim):
            line = mesh.coord(f, d)
            lo, hi = (float(v) for v in box[DIR_NAMES[d]])
            # lower/upper_bound with tolerance (probes.cpp:267-310 getInfo)
            start = int(np.searchsorted(line, lo - self.atol, side="left"))
            stop = int(np.searchsorted(line, hi + self.atol, side="right"))
            self.start[d] = start
            self.npts[d] = stop - start
        self.sub_coords = [
            mesh.coord(f, d)[self.start[d]:self.start[d] + self.npts[d]]
            for d in range(mesh.dim)]
        # natural (x-fastest) flat indices of the box points, ascending
        grids = np.meshgrid(*[np.arange(self.start[d],
                                        self.start[d] + self.npts[d])
                              for d in range(mesh.dim)], indexing="ij")
        flat = np.zeros_like(grids[0])
        stride = 1
        for d in range(mesh.dim):
            flat = flat + grids[d] * stride
            stride *= mesh.n(f, d)
        self.natural_is = np.sort(flat.ravel())
        self._write_grid()

    def _slices(self):
        return tuple(slice(self.start[d], self.start[d] + self.npts[d])
                     for d in reversed(range(self.mesh.dim)))

    def _write_grid(self) -> None:
        if not self.is_root:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if self.viewer == "hdf5":
            import h5py

            with h5py.File(self.path, "w") as fh:
                g = fh.create_group("mesh")
                for d in range(self.mesh.dim):
                    g.create_dataset(DIR_NAMES[d], data=self.sub_coords[d])
                g.create_dataset("IS", data=self.natural_is.astype(np.int64))
        else:
            with open(self.path, "w") as fh:
                for d in range(self.mesh.dim):
                    fh.write(DIR_NAMES[d] + "\n")
                    for v in self.sub_coords[d]:
                        fh.write(f"{v:18.16e}\n")
                fh.write("IS\n")
                for v in self.natural_is:
                    fh.write(f"{v}\n")

    def monitor(self, fields: dict, n: int, t: float) -> None:
        if not self._gated(n, t):
            return
        # the box alone leaves the device
        arr = fields[self._field_name()]
        if self.part is None:
            sub = arr[self._slices()]
        else:
            sub = self.part.gather_box(arr, Field(self.field), self._slices())
        sub = sub.cpu().numpy()
        if self.n_sum != 0:
            # time accumulation / averaging (probes.cpp:489-526)
            if self._accum is None:
                self._accum = np.zeros_like(sub, dtype=np.float64)
            self._accum += sub
            self._count += 1
            if self._count % self.n_sum == 0:
                self._write(self._accum / self._count, t, self._count)
                self._accum[:] = 0.0
                self._count = 0
        else:
            self._write(sub, t, 0)

    def _write(self, data: np.ndarray, t: float, count: int) -> None:
        if not self.is_root:
            return
        if self.viewer == "hdf5":
            import h5py

            with h5py.File(self.path, "a") as fh:
                grp = fh.require_group(self._field_name())
                name = f"{t:.6f}"
                if name in grp:
                    del grp[name]
                ds = grp.create_dataset(name,
                                        data=np.asarray(data, np.float64))
                if count:
                    ds.attrs["count"] = count
        else:
            with open(self.path, "a") as fh:
                fh.write(f"\nt = {t:e}\n")
                if count:
                    fh.write(f"count = {count}\n")
                for v in np.asarray(data, np.float64).ravel():
                    fh.write(f"{v:18.16e}\n")


class ProbePoint(ProbeBase):
    def __init__(self, node: dict, mesh: StaggeredMesh, bcset=None,
                 part=None):
        super().__init__(node, mesh, part)
        self.bcset = bcset
        self.loc = [float(v) for v in node["loc"]]
        f = Field(self.field)
        # bottom-left ghosted-line cell and linear weights per direction
        # (lininterp.cpp:94-209)
        self.base_idx = []
        self.weights = []
        for d in range(mesh.dim):
            line = mesh.coord_ghosted(f, d)
            i = int(np.searchsorted(line, self.loc[d], side="right")) - 1
            i = min(max(i, 0), len(line) - 2)
            self.base_idx.append(i)  # index into the ghosted array
            self.weights.append((self.loc[d] - line[i])
                                / (line[i + 1] - line[i]))
        # the 2^dim corners in (z, y, x) order: their indices into the
        # ghosted array and their weights
        self.corners = []
        for corner in np.ndindex(*([2] * mesh.dim)):
            w = 1.0
            idx = [0] * mesh.dim
            for d in range(mesh.dim):
                bit = corner[mesh.dim - 1 - d]
                idx[mesh.axis_of(d)] = self.base_idx[d] + bit
                w *= self.weights[d] if bit else (1.0 - self.weights[d])
            self.corners.append((tuple(idx), w))
        self._fh = None
        if self.is_root:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "w")

    def monitor(self, fields: dict, n: int, t: float) -> None:
        if not self._gated(n, t):
            return
        vals = self._corner_values(fields)
        if self._fh is None:
            return
        val = 0.0
        for (_, w), v in zip(self.corners, vals):
            val += w * v
        self._fh.write(f"{t:10.8e}\t{val:10.8e}\n")
        self._fh.flush()

    def _owned(self, ghosts: bool) -> tuple:
        """(each corner's index into the rank's array, whether the rank
        holds it) on a decomposed run.  With ``ghosts`` the array is the
        ghost-extended block (local index = ghosted index - block start):
        the rank holds a corner inside its block, or a ghost past the
        domain's wall on its side; else the field's block, the ghosted
        index clamped into the field (edge padding)."""
        f = Field(self.field)
        dim = self.mesh.dim
        local, own = [], []
        for idx, _ in self.corners:
            loc, mine = [0] * dim, True
            for d in range(dim):
                axis = self.mesh.axis_of(d)
                g, n = idx[axis], self.mesh.n(f, d)
                lo, hi = self.part.range(f, d)
                if ghosts:
                    mine &= (lo <= g - 1 < hi or (g == 0 and lo == 0)
                             or (g == n + 1 and hi == n))
                    loc[axis] = g - lo
                else:
                    i = min(max(g - 1, 0), n - 1)
                    mine &= lo <= i < hi
                    loc[axis] = i - lo
            local.append(loc)
            own.append(mine)
        return local, own

    def _corner_values(self, fields: dict) -> np.ndarray:
        """The ghost-extended field at the corners, gathered on the device
        and copied to the host (numpy scalars of the field's dtype)."""
        arr = fields[self._field_name()]
        bcstate = fields.get("_bcstate")
        ghosts = (self.field < self.mesh.dim and self.bcset is not None
                  and bcstate is not None)
        if ghosts:
            # the velocity's ghosts from its boundary conditions (on a
            # decomposed run the block's, the halo from the neighbours)
            arr = self.bcset.extend(arr, self.field, bcstate)
        if self.part is not None:
            local, own = self._owned(ghosts)
            vals = torch.zeros(len(local), dtype=arr.dtype, device=arr.device)
            hold = [k for k, mine in enumerate(own) if mine]
            if hold:
                idx = torch.tensor([local[k] for k in hold],
                                   device=arr.device)
                vals[hold] = arr[tuple(idx.T)]
            return self.part.allreduce_sum(vals).cpu().numpy()
        idx = torch.tensor([c for c, _ in self.corners], device=arr.device)
        if not ghosts:
            # pressure (or no bc state): edge padding, i.e. the ghosted
            # index clamped into the field
            shape = torch.tensor(arr.shape, device=arr.device)
            idx = torch.minimum(torch.clamp(idx - 1, min=0), shape - 1)
        return arr[tuple(idx.T)].cpu().numpy()

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self._fh.close()
