"""Process mesh, block partition and the collectives of a decomposed run.

Counterpart of ``petibm_tpu/parallel/dist.py`` (dist.py:1-139).  The only
parallelism in this problem class is spatial domain decomposition.  The
JAX package shards its dense arrays over a ("dy", "dx") or ("dz", "dy",
"dx") device mesh and lets GSPMD insert the halo exchanges and
reductions; here one process runs per device, each owns one block of
every grid field, and the exchanges are explicit:

- ``ProcessMesh``: the ("dy", "dx") or ("dz", "dy", "dx") grid of ranks,
  laid over the trailing array axes (x over "dx", y over "dy", z over
  "dz").  A 2D grid on a 3-axis mesh is replicated along "dz", as JAX
  ``_leaf_spec`` leaves it: each "dz" layer holds the same (dy, dx)
  blocks and computes them again, its sums run inside the layer (a
  subgroup per layer) and rank 0 writes.
- ``Partition``: each rank's block of every staggered field.  Each mesh
  axis cuts the pressure cells of its direction into contiguous ranges
  (``k*n // p``); a face belongs to the rank of the cell below it, so on a
  non-periodic axis the last rank holds one face fewer.
- ``Partition.halo``: the width-1 halo exchange (``isend``/``irecv``),
  wrapping across ranks on a periodic axis; ``allreduce_sum`` and
  ``Partition.mean``; ``Partition.scatter`` (a block sliced from the full
  array every rank holds) and ``Partition.gather`` (the full array
  assembled from the blocks by an all-gather: rank 0 writes it);
  ``Partition.gather_box`` (one box of a field, from each block's part of
  it: the volume probes); ``alltoall`` for the FDM's transposes and the
  line pencils; ``reduce_scatter`` for the FDM's transforms contracted
  over a cut axis (``linalg/fdm.py``).

Lagrangian arrays (forces, body coordinates) and scalars stay replicated.
The BC face arrays are each rank's segment of the face, along its block
(the replicated face restricted to the block; ``Partition.gather_face``
assembles it).

The tensors go to the collectives as they are: NCCL for cuda tensors,
gloo for CPU ones (``multihost.maybe_initialize`` picks the backend from
the device).  Every collective adds its calls and the bytes this rank
sends to ``COUNTERS``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..types import STR2BCLOC, Field

#: solver-state keys holding Eulerian grid fields (decomposed); everything
#: else (Lagrangian forces f/df, scalars) stays replicated and the BC face
#: arrays are held as segments (JAX dist.py:79-92)
FIELD_KEYS = ("q", "p", "dP", "conv", "diff")

#: kind -> [calls, bytes sent by this rank]; ``reset_counters`` zeroes it
COUNTERS = {"halo": [0, 0], "allreduce": [0, 0], "alltoall": [0, 0],
            "gather": [0, 0], "reduce_scatter": [0, 0]}


def reset_counters() -> None:
    for v in COUNTERS.values():
        v[0] = v[1] = 0


def counters() -> dict:
    """{kind: {"calls": n, "bytes": b}} since the last reset."""
    return {k: {"calls": v[0], "bytes": v[1]} for k, v in COUNTERS.items()}


def _count(kind: str, nbytes: int) -> None:
    COUNTERS[kind][0] += 1
    COUNTERS[kind][1] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _factor2(n: int) -> tuple[int, int]:
    """Near-square factorization n = a*b with a <= b."""
    a = int(math.isqrt(n))
    while a > 1 and n % a != 0:
        a -= 1
    return a, n // a


class ProcessMesh:
    """The ("dy", "dx") or ("dz", "dy", "dx") grid of the process group's
    ranks, row-major: rank = (iz * dy + iy) * dx + ix.  ``rank`` given,
    the layout alone (no process group: a stand-in for checks)."""

    def __init__(self, shape, rank: int | None = None):
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) not in (2, 3):
            raise ValueError("a process mesh has 2 or 3 axes")
        self.axis_names = ("dy", "dx") if len(self.shape) == 2 \
            else ("dz", "dy", "dx")
        #: (dz, dy, dx), dz 1 on a 2-axis mesh
        self.dims = (1,) * (3 - len(self.shape)) + self.shape
        self.ranks = np.arange(math.prod(self.dims)).reshape(self.dims)
        self.size = int(self.ranks.size)
        self._layers = None
        if rank is not None:
            self.rank, self.backend = int(rank), None
            return
        import torch.distributed as dist

        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        # a collective of the whole group first: NCCL's point-to-point
        # batches want the communicator up on every rank
        dist.barrier()

    def rank_at(self, *coord: int) -> int:
        """The rank at (iz,) iy, ix."""
        coord = (0,) * (3 - len(coord)) + tuple(int(c) for c in coord)
        return int(self.ranks[coord])

    def coord_of(self, rank: int) -> tuple:
        """(iz, iy, ix) of ``rank``."""
        return tuple(int(v) for v in np.unravel_index(int(rank), self.dims))

    def layer_group(self):
        """The process subgroup of this rank's "dz" layer.  Every rank
        makes every layer's group on the first call (``new_group`` is a
        collective of the whole group), so all ranks call it together."""
        import torch.distributed as dist

        if self._layers is None:
            self._layers = [dist.new_group([int(r) for r in layer.ravel()])
                            for layer in self.ranks]
        return self._layers[self.coord_of(self.rank)[0]]


def mesh_from_config(node: dict | None) -> ProcessMesh | None:
    """The process mesh of the ``parameters.sharding`` node (JAX
    ``mesh_from_config``): ``nDevices`` (default: the process group's
    size), ``platform`` (read by nothing: every rank runs where its
    solver runs), ``shape`` ([dy, dx] or [dz, dy, dx]).  None when the
    node is absent or selects one device.  One process runs per device,
    so ``nDevices`` must equal the group's size."""
    from .multihost import process_info

    if not node:
        return None
    _, world = process_info()
    n = int(node.get("nDevices", world))
    if n > world:
        raise ValueError(
            f"sharding.nDevices={n} but only {world} process(es) run: "
            "launch one process per device (torchrun, or "
            "parameters.distributed)")
    if n < 2:
        return None
    if n != world:
        raise ValueError(f"sharding.nDevices={n} but {world} processes run: "
                         "one process per device")
    if node.get("shape"):
        dims = [int(v) for v in node["shape"]]
        if math.prod(dims) != n:
            raise ValueError(f"sharding.shape {dims} != nDevices {n}")
        if len(dims) not in (2, 3):
            raise ValueError("sharding.shape wants 2 or 3 entries")
    else:
        dims = list(_factor2(n))
    return ProcessMesh(dims)


def allreduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the process group, or over ``group`` (a new
    tensor)."""
    import torch.distributed as dist

    buf = t.clone()
    _count("allreduce", _nbytes(buf))
    dist.all_reduce(buf, group=group)
    return buf


def alltoall(flat: torch.Tensor, send_counts: list, recv_counts: list,
             kind: str = "alltoall") -> torch.Tensor:
    """``all_to_all_single`` of a 1D tensor: ``send_counts[r]`` entries to
    rank r, ``recv_counts[r]`` from it, in rank order; counted under
    ``kind``."""
    import torch.distributed as dist

    src = flat.contiguous()
    out = torch.empty(sum(recv_counts), dtype=src.dtype, device=src.device)
    _count(kind, _nbytes(src))
    dist.all_to_all_single(out, src, [int(c) for c in recv_counts],
                           [int(c) for c in send_counts])
    return out


class _Blocks:
    """Blocks of cell-aligned ranges on a ``ProcessMesh``: direction x is
    cut over "dx", y over "dy", z over "dz" (whole on a 2-axis mesh).
    ``bounds[d]`` holds the ``parts[d] + 1`` cut points of direction d.
    A 2D grid on a 3-axis mesh takes the rank's "dz" layer: its
    neighbours and groups are in the layer and its sums run over the
    layer's subgroup (``group``).  The halo exchange and the reductions
    live here; ``Partition`` (the staggered fields) and ``LevelBlocks``
    (the multigrid levels, and a field's cells) give the ranges."""

    def __init__(self, pmesh: ProcessMesh, dim: int, periodic, bounds):
        self.pmesh = pmesh
        self.dim = dim
        self.periodic = [bool(p) for p in periodic]
        dz, dy, dx = pmesh.dims
        #: parts per direction (x: dx, y: dy, z: dz)
        self.parts = [dx, dy, dz][:dim]
        self.bounds = [list(b) for b in bounds]
        self.rank = pmesh.rank
        #: the rank's "dz" layer
        self.layer = pmesh.coord_of(self.rank)[0]
        self.coord = self.coord_of(self.rank)
        #: the process group of the sums: the layer's where "dz" layers
        #: replicate a 2D grid, else the whole group (None)
        self.group = pmesh.layer_group() if dim == 2 and dz > 1 else None

    def coord_of(self, rank: int) -> list:
        """The block index per direction of ``rank``."""
        iz, iy, ix = self.pmesh.coord_of(rank)
        return [ix, iy, iz][:self.dim]

    def rank_of(self, coord) -> int:
        """The rank of block ``coord`` (in this rank's layer in 2D)."""
        iz = coord[2] if self.dim == 3 else self.layer
        return self.pmesh.rank_at(iz, coord[1], coord[0])

    def touches(self, d: int, side: int) -> bool:
        """Whether the block lies on the domain's min (``side`` 0) or max
        (1) face of direction ``d``."""
        return self.coord[d] == (0 if side == 0 else self.parts[d] - 1)

    def _group(self, d: int) -> list:
        """The ranks whose blocks share every block coordinate but d's, in
        the order of their coordinate along d."""
        out = []
        for k in range(self.parts[d]):
            coord = list(self.coord)
            coord[d] = k
            out.append(self.rank_of(coord))
        return out

    # --- reductions -----------------------------------------------------
    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return allreduce_sum(t, self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a decomposed field over the whole grid (one
        all-reduce of its sum and its point count)."""
        # the count by a fill kernel, not a host copy: a CUDA graph
        # captures it
        both = torch.stack([torch.sum(x),
                            torch.full((), float(x.numel()), dtype=x.dtype,
                                       device=x.device)])
        both = self.allreduce_sum(both)
        return both[0] / both[1]

    def reduce_scatter(self, y: torch.Tensor, d: int) -> torch.Tensor:
        """The sum over direction d's group of its members' partials
        ``y`` (each the whole of direction d), of which each member keeps
        its range: one all-to-all (member k's rows to member k) and the
        sum of what arrives, in member order, so every rank sums alike."""
        axis = self.dim - 1 - d
        group = self._group(d)
        bnd = self.bounds[d]
        shape = list(y.shape)
        shape[axis] = bnd[self.coord[d] + 1] - bnd[self.coord[d]]
        send = [0] * self.pmesh.size
        recv = [0] * self.pmesh.size
        pieces = []
        for k, r in enumerate(group):
            piece = y.narrow(axis, bnd[k], bnd[k + 1] - bnd[k])
            pieces.append(piece.contiguous().reshape(-1))
            send[r] = pieces[-1].numel()
            recv[r] = math.prod(shape)
        got = alltoall(torch.cat(pieces), send, recv, kind="reduce_scatter")
        parts = got.split([recv[r] for r in group])
        out = parts[0].reshape(shape)
        for part in parts[1:]:
            out = out + part.reshape(shape)
        return out

    # --- halo -----------------------------------------------------------
    def _neighbour(self, d: int, step: int) -> int | None:
        coord = list(self.coord)
        k = coord[d] + step
        if not 0 <= k < self.parts[d]:
            if not self.periodic[d]:
                return None
            k %= self.parts[d]
        coord[d] = k
        return self.rank_of(coord)

    def halo(self, x: torch.Tensor, d: int, lower: bool = True,
             upper: bool = True) -> tuple:
        """The width-1 halo of a block along direction ``d``: (the slab
        below the block, the slab above it), each from the neighbouring
        rank (wrapping on a periodic axis), None past a domain wall.  On
        an axis with one part a periodic field wraps onto itself.  With
        ``lower`` (``upper``) false the slab below (above) is not
        exchanged and comes back None."""
        import torch.distributed as dist

        axis = self.dim - 1 - d
        n = x.shape[axis]
        if self.parts[d] == 1:
            if self.periodic[d]:
                return (x.narrow(axis, n - 1, 1) if lower else None,
                        x.narrow(axis, 0, 1) if upper else None)
            return None, None
        lo_nbr, hi_nbr = self._neighbour(d, -1), self._neighbour(d, 1)
        shape = list(x.shape)
        shape[axis] = 1
        lo_buf = (torch.empty(shape, dtype=x.dtype, device=x.device)
                  if lower and lo_nbr is not None else None)
        hi_buf = (torch.empty(shape, dtype=x.dtype, device=x.device)
                  if upper and hi_nbr is not None else None)
        # posted in one order on every rank (NCCL matches a pair's messages
        # in order): our first slab to the lower neighbour (tag 1, its
        # upper halo), our last to the upper one (tag 2); the upper halo
        # is the upper neighbour's first slab, the lower halo the lower
        # neighbour's last
        ops = []
        if upper and lo_nbr is not None:
            first = x.narrow(axis, 0, 1).contiguous()
            ops.append(dist.P2POp(dist.isend, first, lo_nbr, tag=1))
        if lower and hi_nbr is not None:
            last = x.narrow(axis, n - 1, 1).contiguous()
            ops.append(dist.P2POp(dist.isend, last, hi_nbr, tag=2))
        if hi_buf is not None:
            ops.append(dist.P2POp(dist.irecv, hi_buf, hi_nbr, tag=1))
        if lo_buf is not None:
            ops.append(dist.P2POp(dist.irecv, lo_buf, lo_nbr, tag=2))
        _count("halo", sum(_nbytes(op.tensor) for op in ops
                           if op.op is dist.isend))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return lo_buf, hi_buf

    def extend_hi(self, x: torch.Tensor, d: int) -> torch.Tensor:
        """``x`` with the next point above the block along ``d`` appended
        (from the neighbour, or the periodic image); unchanged on the last
        block of a non-periodic direction.  Only the upper slab moves."""
        _, hi = self.halo(x, d, lower=False)
        return x if hi is None else torch.cat([x, hi], dim=self.dim - 1 - d)

    def _gather_blocks(self, x: torch.Tensor, blocks: list, full_shape,
                       take=None) -> torch.Tensor:
        """The full array from every rank's block (``blocks[r]``: slices of
        rank r's block), by one all-gather of the blocks padded to the
        largest; ranks where ``take(r)`` is false are left out."""
        import torch.distributed as dist

        sizes = [math.prod(s.stop - s.start for s in b) for b in blocks]
        width = max(sizes)
        flat = torch.zeros(width, dtype=x.dtype, device=x.device)
        flat[:x.numel()] = x.reshape(-1)
        parts = [torch.empty_like(flat) for _ in blocks]
        _count("gather", _nbytes(flat))
        dist.all_gather(parts, flat)
        full = torch.zeros(tuple(full_shape), dtype=x.dtype, device=x.device)
        for r, (blk, part) in enumerate(zip(blocks, parts)):
            if take is None or take(r):
                shape = tuple(s.stop - s.start for s in blk)
                full[blk] = part[:sizes[r]].reshape(shape)
        return full


class Partition(_Blocks):
    """Each rank's block of every field of a ``StaggeredMesh`` on a
    ``ProcessMesh``.  Directions x, y and z are cut over the mesh axes
    "dx", "dy" and "dz" (z whole on a 2-axis mesh; a 2D grid replicated
    along "dz")."""

    def __init__(self, mesh, pmesh: ProcessMesh):
        self.mesh = mesh
        dz, dy, dx = pmesh.dims
        parts = [dx, dy, dz][:mesh.dim]
        bounds = []
        for d in range(mesh.dim):
            n, p = mesh.n(Field.P, d), parts[d]
            if n < 2 * p:
                raise ValueError(
                    f"{n} cells along direction {d} cannot be cut into {p} "
                    "blocks of at least 2 cells")
            bounds.append([k * n // p for k in range(p + 1)])
        super().__init__(pmesh, mesh.dim, mesh.periodic, bounds)

    # --- layout ---------------------------------------------------------
    def range(self, field, d: int, rank: int | None = None) -> tuple:
        """[lo, hi) of ``field``'s points along direction ``d`` on ``rank``
        (default this one)."""
        k = self.coord[d] if rank is None else self.coord_of(rank)[d]
        lo, hi = self.bounds[d][k], self.bounds[d][k + 1]
        if (int(field) == d and not self.periodic[d]
                and k == self.parts[d] - 1):
            hi -= 1  # the wall face: n - 1 velocity points
        return lo, hi

    def block(self, field, rank: int | None = None) -> tuple:
        """The rank's block of ``field`` as slices in array-axis order."""
        return tuple(slice(*self.range(field, d, rank))
                     for d in reversed(range(self.dim)))

    def local_shape(self, field, rank: int | None = None) -> tuple:
        return tuple(s.stop - s.start for s in self.block(field, rank))

    def origin(self) -> tuple:
        """The global index of the block's first point per array axis
        (the same for every field)."""
        return tuple(self.bounds[d][self.coord[d]]
                     for d in reversed(range(self.dim)))

    # --- scatter / gather -----------------------------------------------
    def scatter(self, full, field, dtype=None, device=None) -> torch.Tensor:
        """The rank's block of a full array that every rank holds (cut
        where it lies, then moved)."""
        return self._cut(full, self.block(field), dtype, device)

    @staticmethod
    def _cut(full, block: tuple, dtype, device) -> torch.Tensor:
        full = torch.as_tensor(full)
        return full[block].to(dtype=dtype or full.dtype,
                              device=device or full.device).contiguous()

    def gather(self, x: torch.Tensor, field) -> torch.Tensor:
        """The full array of a decomposed field, on every rank."""
        blocks = [self.block(field, r) for r in range(self.pmesh.size)]
        return self._gather_blocks(x, blocks, self.mesh.shape(Field(field)))

    def face_block(self, field, d: int, rank: int | None = None) -> tuple:
        """The rank's segment of a face of ``field`` normal to ``d``."""
        axis = self.dim - 1 - d
        blk = list(self.block(field, rank))
        del blk[axis]
        return tuple(blk)

    def gather_face(self, a: torch.Tensor, field, d: int,
                    side: int) -> torch.Tensor:
        """The full face array (field ``field``'s face normal to ``d`` at
        ``side``) from the segments of the ranks on that face."""
        blocks = [self.face_block(field, d, r) for r in range(self.pmesh.size)]
        shape = list(self.mesh.shape(Field(field)))
        del shape[self.dim - 1 - d]
        on_face = self.parts[d] - 1 if side else 0
        return self._gather_blocks(
            a, blocks, shape, take=lambda r: self.coord_of(r)[d] == on_face)

    def scatter_face(self, full, field, d: int, dtype=None,
                     device=None) -> torch.Tensor:
        """The rank's segment of a full face array."""
        return self._cut(full, self.face_block(field, d), dtype, device)

    def box_part(self, field, box: tuple, rank: int | None = None) -> tuple:
        """The part of ``box`` (global slices of ``field`` in array-axis
        order) in ``rank``'s block, as slices relative to the box's
        start (empty where they do not meet)."""
        out = []
        for b, s in zip(box, self.block(field, rank)):
            lo, hi = max(b.start, s.start), min(b.stop, s.stop)
            lo = min(lo, b.stop)
            out.append(slice(lo - b.start, max(hi, lo) - b.start))
        return tuple(out)

    def gather_box(self, x: torch.Tensor, field, box: tuple) -> torch.Tensor:
        """The values of ``field`` inside ``box`` (global slices in
        array-axis order), on every rank: each rank sends only its
        block's part of the box (one all-gather of those parts)."""
        mine = self.box_part(field, box)
        origin = [s.start for s in self.block(field)]
        local = tuple(slice(b.start + m.start - o, b.start + m.stop - o)
                      for b, m, o in zip(box, mine, origin))
        blocks = [self.box_part(field, box, r)
                  for r in range(self.pmesh.size)]
        return self._gather_blocks(x[local], blocks,
                                   [b.stop - b.start for b in box])


    def gather_state(self, state: dict) -> dict:
        """A solver state with every decomposed leaf gathered (the grid
        fields of ``FIELD_KEYS`` and the BC face segments); replicated
        leaves as they are."""
        vel = ("u", "v", "w")

        def fields(tree):
            return {k: self.gather(v, Field(vel.index(k)))
                    for k, v in tree.items()}

        out = {}
        for key, val in state.items():
            if key == "q":
                out[key] = fields(val)
            elif key in ("p", "dP"):
                out[key] = self.gather(val, Field.P)
            elif key in ("conv", "diff"):
                out[key] = tuple(fields(h) for h in val)
            elif key == "bc":
                out[key] = {}
                for fkey, st in val.items():
                    name, loc = fkey.split("_", 1)
                    loc = STR2BCLOC[loc]
                    out[key][fkey] = {
                        k: self.gather_face(a, vel.index(name), loc.axis,
                                            int(loc.is_max))
                        for k, a in st.items()}
            else:
                out[key] = val
        return out


class LevelBlocks(_Blocks):
    """The blocks of one cell-centred multigrid level (``linalg/mg.py``).
    Level 0 takes the pressure's blocks; a coarser level gives coarse
    cell j, the sum of fine cells 2j and 2j+1, to the rank of its first
    child (``coarsen``), so restriction and prolongation move at most
    one slab along each cut axis.

    A line sweep along a cut direction d moves its lines whole onto one
    rank: ``to_pencil`` exchanges the blocks of the ranks that share the
    other block coordinates (one all-to-all), so that each holds all of
    direction d and a ``parts[d]``-th of the split direction
    (``split_dir``: y for x lines, x for y lines, y for z lines);
    ``from_pencil`` is its inverse."""

    @classmethod
    def of_pressure(cls, part: Partition) -> "LevelBlocks":
        return cls(part.pmesh, part.dim, part.periodic, part.bounds)

    @classmethod
    def of_field(cls, part: Partition, field) -> "LevelBlocks":
        """The blocks of one staggered field's points (a velocity's last
        block one face short on its own non-periodic axis): its pencils
        and its sums over a cut axis (``linalg/fdm.py``)."""
        bounds = [list(b) for b in part.bounds]
        f = int(field)
        if f < part.dim and not part.periodic[f]:
            bounds[f][-1] -= 1
        return cls(part.pmesh, part.dim, part.periodic, bounds)

    def coarsen(self) -> "LevelBlocks":
        return LevelBlocks(self.pmesh, self.dim, self.periodic,
                           [[(b + 1) // 2 for b in bnd]
                            for bnd in self.bounds])

    def range(self, d: int, rank: int | None = None) -> tuple:
        k = self.coord[d] if rank is None else self.coord_of(rank)[d]
        return self.bounds[d][k], self.bounds[d][k + 1]

    def block(self, rank: int | None = None) -> tuple:
        """The rank's block as slices in array-axis order."""
        return tuple(slice(*self.range(d, rank))
                     for d in reversed(range(self.dim)))

    def local_shape(self, rank: int | None = None) -> tuple:
        return tuple(s.stop - s.start for s in self.block(rank))

    def full_shape(self) -> tuple:
        return tuple(self.bounds[d][-1] for d in reversed(range(self.dim)))

    def cut(self, d: int) -> bool:
        return self.parts[d] > 1

    def split_dir(self, d: int) -> int:
        """The direction a pencil of direction-d lines splits: y for x
        lines, x for y lines, y for z lines (each piece then holds whole
        x rows)."""
        return 0 if d == 1 else 1

    def holds_lines(self) -> bool:
        """Whether every block has at least 2 cells along each cut
        direction and every pencil at least one line: the level can stay
        decomposed."""
        def least(d):
            return min(b - a for a, b in zip(self.bounds[d],
                                             self.bounds[d][1:]))

        return all(least(d) >= 2 and least(self.split_dir(d)) >= self.parts[d]
                   for d in range(self.dim) if self.cut(d))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole level from the blocks, on every rank."""
        blocks = [self.block(r) for r in range(self.pmesh.size)]
        return self._gather_blocks(x, blocks, self.full_shape())

    # --- pencils --------------------------------------------------------
    def pencil_range(self, d: int, k: int | None = None) -> tuple:
        """[lo, hi) of the split direction's cells in member k's pencil
        of direction-d lines (default this rank's)."""
        s = self.split_dir(d)
        lo, hi = self.range(s)
        p = self.parts[d]
        k = self.coord[d] if k is None else k
        m = hi - lo
        return lo + k * m // p, lo + (k + 1) * m // p

    def _exchange(self, d: int, pieces: list, recv_shapes: list,
                  cat_axis: int) -> list:
        """One all-to-all within the group of direction d: ``pieces[k]``
        (a tensor per field) to member k, and from member k one block of
        ``recv_shapes[k]`` per field; each field's blocks joined along
        ``cat_axis`` in member order."""
        group = self._group(d)
        nfields = len(pieces[0])
        send = [0] * self.pmesh.size
        recv = [0] * self.pmesh.size
        flat = []
        for k, r in enumerate(group):
            flat += [t.contiguous().reshape(-1) for t in pieces[k]]
            send[r] = sum(t.numel() for t in pieces[k])
            recv[r] = nfields * math.prod(recv_shapes[k])
        got = alltoall(torch.cat(flat), send, recv)
        blocks = [c.split(math.prod(shape)) for c, shape in zip(
            got.split([recv[r] for r in group]), recv_shapes)]
        return [torch.cat([b[f].reshape(shape) for b, shape
                           in zip(blocks, recv_shapes)], dim=cat_axis)
                for f in range(nfields)]

    def to_pencil(self, d: int, *xs: torch.Tensor) -> list:
        """The rank's blocks of ``xs`` (fields of one shape) -> its pencils
        of whole direction-d lines, in one all-to-all."""
        ax_d, ax_s = self.dim - 1 - d, self.dim - 1 - self.split_dir(d)
        lo_s = self.range(self.split_dir(d))[0]
        mine = self.pencil_range(d)
        pieces, shapes = [], []
        for k in range(self.parts[d]):
            a, b = self.pencil_range(d, k)
            pieces.append([x.narrow(ax_s, a - lo_s, b - a) for x in xs])
            shape = list(xs[0].shape)
            shape[ax_d] = self.bounds[d][k + 1] - self.bounds[d][k]
            shape[ax_s] = mine[1] - mine[0]
            shapes.append(shape)
        return self._exchange(d, pieces, shapes, ax_d)

    def from_pencil(self, d: int, *xs: torch.Tensor) -> list:
        """The inverse of ``to_pencil``."""
        ax_d, ax_s = self.dim - 1 - d, self.dim - 1 - self.split_dir(d)
        lo_d, hi_d = self.range(d)
        pieces, shapes = [], []
        for k in range(self.parts[d]):
            lo, hi = self.bounds[d][k], self.bounds[d][k + 1]
            pieces.append([x.narrow(ax_d, lo, hi - lo) for x in xs])
            a, b = self.pencil_range(d, k)
            shape = list(xs[0].shape)
            shape[ax_d] = hi_d - lo_d
            shape[ax_s] = b - a
            shapes.append(shape)
        return self._exchange(d, pieces, shapes, ax_s)


class GroupSum:
    """The process group's sum of a rank's partial: the ``reduce`` of the
    Krylov solvers on a decomposed run.  ``replicated`` names the leaves
    of a dict unknown that every rank holds whole (the Lagrangian forces
    of the coupled {p, f} system): their inner products are every rank's
    own and are not summed (``linalg/krylov.py``'s ``_dot``).  ``group``:
    the process subgroup of the sums (a ``Partition``'s ``group``), or
    the whole group."""

    replicated = frozenset({"f"})

    def __init__(self, group=None):
        self.group = group

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return allreduce_sum(t, self.group)


class LocalMesh:
    """The rank's view of a ``StaggeredMesh``: ``shape`` and ``n`` are the
    block's, and ``bcast`` slices a per-direction 1D array of the global
    line (as ``dl``, ``coord`` and ``lines`` return it) to the block's
    range before shaping it, so the stencil closures built on this view
    carry the block's coefficients.  Everything else is the global
    mesh's."""

    def __init__(self, part: Partition):
        self._global = part.mesh
        self.part = part

    def __getattr__(self, name):
        return getattr(self._global, name)

    def shape(self, field) -> tuple:
        return self.part.local_shape(field)

    def n(self, field, direction) -> int:
        lo, hi = self.part.range(field, int(direction))
        return hi - lo

    def bcast(self, field, direction, arr1d) -> np.ndarray:
        d = int(direction)
        arr = np.asarray(arr1d)
        if len(arr) != self._global.n(field, d):
            raise ValueError(f"bcast wants a line of {field!r} along {d}")
        lo, hi = self.part.range(field, d)
        return self._global.bcast(field, d, arr[lo:hi])
