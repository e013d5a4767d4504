"""Ghost-point boundary-condition system.

Counterpart of ``petibm_tpu/boundary.py`` (``BoundarySet``,
boundary.py:71-245).  Every (velocity field, domain face) pair carries
ghost points obeying ``u_ghost = a0 * u_target + a1``: ``a0`` is static per
face (``FaceBC``); ``a1`` and the cached ghost ``value`` live in the
``bcstate`` dict (``"<field>_<loc>" -> {"a1": tensor, "value": tensor}``)
and evolve only for convective BCs.  ``extend`` pads a field by one ghost
layer per direction (periodic wrap or ``a0*target + a1``); the plain
interior stencil on the extended array is the reference's folded-BC
operator plus its MatShell correction.

Under a domain decomposition (``part``, a ``parallel.dist.Partition``)
fields are the rank's blocks: ``extend`` takes a block's interior sides
from the neighbouring ranks' halo (periodic wrap across ranks included)
and only its domain-wall sides from the BCs, and the ``bcstate`` face
arrays are the block's segment of each face, so ``init_state``,
``update_eqs`` and ``update_ghost_values`` run on the segment as they
stand (no quantity of theirs is global).  A block off a face keeps a
segment it never reads.
"""

from __future__ import annotations

import dataclasses

import torch

from .mesh import StaggeredMesh
from .types import BCLoc, BCType, Field, STR2BCLOC, STR2BCTYPE, STR2FIELD


@dataclasses.dataclass(frozen=True)
class FaceBC:
    """Static BC data for one (field, face) pair
    (reference: singleboundarybase.cpp:22-105)."""

    field: int
    loc: BCLoc
    type: BCType
    value: float  # BC value from YAML (Dirichlet value / flux / convective Uc)
    a0: float
    normal: float
    dL: float  # ghost-to-target distance (reference: misc.cpp:183-191)

    @property
    def key(self) -> str:
        from .types import BCLOC2STR, FIELD2STR

        return f"{FIELD2STR[Field(self.field)]}_{BCLOC2STR[self.loc]}"

    @property
    def same_dir(self) -> bool:
        """Face normal parallel to the velocity component (the ghost point
        then sits exactly on the boundary)."""
        return self.loc.axis == self.field


def _static_a0(bctype: BCType, same_dir: bool) -> float:
    """a0 per BC type (reference: singleboundarydirichlet.cpp:34-43,
    singleboundaryneumann.cpp:29, singleboundaryconvective.cpp:20-37)."""
    if bctype == BCType.DIRICHLET:
        return 0.0 if same_dir else -1.0
    if bctype == BCType.NEUMANN:
        return 1.0
    if bctype == BCType.CONVECTIVE:
        return 0.0 if same_dir else -1.0
    return 0.0


class BoundarySet:
    """All face BCs of a simulation (reference: boundarysimple.cpp:44-146)."""

    def __init__(self, mesh: StaggeredMesh, config: dict, part=None):
        """``part``: the rank's ``Partition`` of a decomposed run, else
        None."""
        self.mesh = mesh
        self.part = part
        self.dim = mesh.dim
        self.specs: dict[tuple[int, int], FaceBC] = {}

        bcs = config.get("flow", {}).get("boundaryConditions", None)
        if bcs is None:
            raise ValueError("flow.boundaryConditions is required")
        for entry in bcs:
            loc = STR2BCLOC[entry["location"]]
            if loc.axis >= self.dim:
                continue
            for key, val in entry.items():
                if key == "location":
                    continue
                f = int(STR2FIELD[str(key)])
                if f >= self.dim:
                    continue
                btype = STR2BCTYPE[str(val[0])]
                value = float(val[1])
                if btype == BCType.PERIODIC:
                    continue  # handled structurally by wraparound
                line = mesh.lines[Field(f)][loc.axis]
                if loc.is_max:
                    dl = line.coord[-1] - line.coord[-2]
                else:
                    dl = line.coord[1] - line.coord[0]
                same_dir = loc.axis == f
                self.specs[(f, int(loc))] = FaceBC(
                    field=f, loc=loc, type=btype, value=value,
                    a0=_static_a0(btype, same_dir), normal=loc.normal,
                    dL=float(dl))

        # sanity: every non-periodic face of every velocity field needs a BC
        for f in range(self.dim):
            for d in range(self.dim):
                if mesh.periodic[d]:
                    continue
                for side in (0, 1):
                    if (f, 2 * d + side) not in self.specs:
                        raise ValueError(
                            f"missing BC for field {Field(f).name} at "
                            f"{BCLoc(2 * d + side).name}")

    def touches(self, d: int, side: int) -> bool:
        """Whether this rank's block lies on the face (always, undivided)."""
        return self.part is None or self.part.touches(d, side)

    def _halo(self, x: torch.Tensor, d: int) -> tuple:
        """The layers beyond ``x`` along direction ``d``, (below, above):
        the neighbouring ranks' or the periodic images, None at a wall."""
        if self.part is not None:
            return self.part.halo(x, d)
        if not self.mesh.periodic[d]:
            return None, None
        axis = self.mesh.axis_of(d)
        return x.narrow(axis, x.shape[axis] - 1, 1), x.narrow(axis, 0, 1)

    # ------------------------------------------------------------------
    def _target(self, q: dict, spec: FaceBC) -> torch.Tensor:
        """Interior value adjacent to the face (the reference's targetStencil,
        misc.cpp:226-267)."""
        arr = q[_fname(spec.field)]
        axis = self.mesh.axis_of(spec.loc.axis)
        return arr.select(axis, -1 if spec.loc.is_max else 0)

    # ------------------------------------------------------------------
    def init_state(self, q: dict, dtype: torch.dtype | None = None) -> dict:
        """Ghost ICs: the initial (a1, value) tensors per face
        (reference: singleboundarybase.cpp:107-124 setGhostICs)."""
        state: dict[str, dict] = {}
        for spec in self.specs.values():
            target = self._target(q, spec)
            if dtype is not None:
                target = target.to(dtype)
            if spec.type == BCType.DIRICHLET:
                a1 = torch.full_like(target, spec.value if spec.same_dir
                                     else 2.0 * spec.value)
                value = spec.a0 * target + a1
            elif spec.type == BCType.NEUMANN:
                a1 = torch.full_like(target,
                                     spec.normal * spec.dL * spec.value)
                value = spec.a0 * target + a1
            elif spec.type == BCType.CONVECTIVE:
                # at t=0 the ghost value equals the target
                # (singleboundaryconvective.cpp:80-92)
                value = target.clone()
                a1 = value.clone() if spec.same_dir else value + target
            else:
                a1 = torch.zeros_like(target)
                value = torch.zeros_like(target)
            state[spec.key] = {"a1": a1, "value": value}
        return state

    def update_eqs(self, bcstate: dict, q: dict, dt: float) -> dict:
        """Recompute a1 from the previous ghost value and the current target:
        the upwinded convective outflow (reference:
        singleboundarybase.cpp:126-144, singleboundaryconvective.cpp:13-37).
        No-op for Dirichlet and Neumann faces."""
        new = dict(bcstate)
        for spec in self.specs.values():
            if spec.type != BCType.CONVECTIVE:
                continue
            st = bcstate[spec.key]
            target = self._target(q, spec)
            adv = (spec.normal * dt * spec.value * (st["value"] - target)
                   / spec.dL)
            if spec.same_dir:
                a1 = st["value"] - adv
            else:
                a1 = st["value"] + target - 2.0 * adv
            new[spec.key] = {"a1": a1, "value": st["value"]}
        return new

    def update_ghost_values(self, bcstate: dict, q: dict) -> dict:
        """Ghost value refresh after the solve: value = a0*target + a1
        (reference: singleboundarybase.cpp:146-163)."""
        new = dict(bcstate)
        for spec in self.specs.values():
            st = bcstate[spec.key]
            target = self._target(q, spec)
            new[spec.key] = {"a1": st["a1"],
                             "value": spec.a0 * target + st["a1"]}
        return new

    # ------------------------------------------------------------------
    def extend(self, arr: torch.Tensor, field: int, bcstate: dict | None,
               homogeneous: bool = False, dirs=None) -> torch.Tensor:
        """Pad a field by one ghost layer per direction.

        Periodic directions wrap; others use ``a0*target + a1`` (or
        ``a0*target`` when ``homogeneous``: the BC-folded operator without
        the MatShell correction).  ``dirs`` selects the directions (default
        all), processed x first; a1 face arrays are edge/wrap-padded along
        already-extended directions so corner ghosts match the reference's
        DMDA wraparound."""
        mesh = self.mesh
        if dirs is None:
            dirs = range(mesh.dim)
        dirs = sorted(int(d) for d in dirs)
        out = arr
        done: list[int] = []
        for d in dirs:
            axis = mesh.axis_of(d)
            halo = self._halo(out, d)
            ghosts = []
            for side, idx in ((0, 0), (1, out.shape[axis] - 1)):
                if halo[side] is not None:
                    ghosts.append(halo[side])
                    continue
                spec = self.specs[(field, 2 * d + side)]
                g = spec.a0 * out.narrow(axis, idx, 1)
                if not homogeneous:
                    a1 = bcstate[spec.key]["a1"]
                    g = g + self._pad_face(a1, axis, done)
                ghosts.append(g)
            out = torch.cat([ghosts[0], out, ghosts[1]], dim=axis)
            done.append(d)
        return out

    def _pad_face(self, a1: torch.Tensor, face_axis: int,
                  done_dirs: list[int]) -> torch.Tensor:
        """Lift a face array (interior shape of the other directions) onto
        the partially-extended array: insert the face axis and pad
        already-extended directions (wrap if periodic, else edge)."""
        g = a1.unsqueeze(face_axis)
        for dprev in done_dirs:
            axis = self.mesh.axis_of(dprev)
            # the neighbours' segments (or the periodic images); edge
            # copies past a wall
            lo, hi = self._halo(g, dprev)
            n = g.shape[axis]
            g = torch.cat([g.narrow(axis, 0, 1) if lo is None else lo, g,
                           g.narrow(axis, n - 1, 1) if hi is None else hi],
                          dim=axis)
        return g


def _fname(field: int) -> str:
    return ("u", "v", "w")[field]
