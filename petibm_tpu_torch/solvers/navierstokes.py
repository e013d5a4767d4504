"""Projection-method incompressible Navier-Stokes solver.

Counterpart of ``petibm_tpu/solvers/navierstokes.py``: the 2D and 3D
projection step.  One time step (Perot 1993 fractional
step, reference navierstokes.cpp:240-266) is a function over a state dict
with the JAX package's keys (``q``, ``p``, ``bc``, ``conv``, ``diff``,
``dP``):

  1. rhs1 = -G p + u/dt + AB2 convection + CN diffusion history
            + a_imp nu Lbc u  (after the convective-BC update); in 3D the
            convection is the CUDA kernel K3
  2. u* from the direct FDM Helmholtz solve with refinement, or from a
     Krylov solve (BiCGStab/CG with a probed Jacobi diagonal); in 3D the
     momentum operator of either is the CUDA kernel K2a
  3. rhs2 = (D + Dbc) u*, mean removed (or, with the pinned pressure of
     ``poissonSolver.type: GPU``, its entry 0 set to 0)
  4. dP from the direct FDM Poisson solve with refinement, or (``fdm:
     false`` or BN > 1) from CG preconditioned by a multigrid V-cycle
     whose smoother sweeps are the CUDA kernels K4/K5 and K6/K7
     (``linalg/mg.py``), or from another Krylov solve; for BN order 1 its
     operator is the CUDA kernel K1 on non-periodic grids and K2b on 3D
     grids with a periodic axis (``operators/cuda_stencil.py``).  With
     ``mg: {dtype: bfloat16}`` the V-cycle runs on a bfloat16 hierarchy
     (the bfloat16 instances of K4-K7, and of K1 at its level-0
     residual) while CG stays in the solver's dtype.  The FDM solves
     transform periodic uniform axes by FFT under ``fdm.fft: true``.  The
     pinned pressure solves its operator (row and column 0 the identity)
     through ``linalg/fdm.py``'s ``PinnedSolve`` (FFT on periodic uniform
     axes, as in the JAX package), or by MG-CG under ``fdm: false``; its
     operator stays the stencil closure
  5. u = u* - B_N G dP (dP's mean removed unless pinned), p += dP; ghost
     refresh

``parameters.disablePallas`` turns every hand kernel off (the stencil
closures run instead), as it turns off the Pallas kernels of the JAX
package.  Every solve is one loop body on the current driver of
``linalg/loops.py``; a single step (``advance``) takes the host driver,
which reads each loop's predicate once per iteration, as JAX's jitted
single step runs its while_loops to the end.  The stats stay 0-d device
tensors until the flush (``stats_history`` converts them in one read).

``stepsPerDispatch: k`` > 1 runs k steps a host round trip
(``advance_chunk``; ``solvers/chunk.py``): on the card the step is
captured once as a CUDA graph whose loops are capped unrolls of guarded
bodies (CUDA IF nodes; on a decomposed run, whose loop bodies hold NCCL
collectives, every copy runs with its writes masked by the predicate)
and replayed k times, with one host read at the chunk's end; on the CPU
the same guarded step runs k times.  ``run()``
cuts chunks at host events (save, restart, probe, the end) as the JAX
package does (``_steps_to_host_event``, navierstokes.py:746-755,
934-952).  A loop that overflows its cap is rerun through the host
driver and recaptured (``chunk_overflows``).

Output and restarts (JAX ``navierstokes.py:770-858``, through the copied
``io/hdf5.py``): ``grid.h5`` at init, the step-0 snapshot or the restart
read (``io_initial_data``, the first thing ``run()`` does), a snapshot
every ``nsave`` steps and the restart histories every ``nrestart``, with
the dP warm start and the BC ghost state as extras so that a restart is
exact.  Fields go to the host only at those points.  Where h5py does not
import, the solver says so once on stderr at init and writes the text
logs only; a restart start (``startStep > 0``) then raises.  The probes
of ``config["probes"]`` (``io/probes.py``) are monitored after each
step's output (JAX ``navierstokes.py:911-930``); each copies only its own
values to the host.

The step is the reference's log stages chained (``_profile_phases``), so
the stage profiler, ``profile_stages`` (``utils/profiling.py``; JAX
``navierstokes.py:667-718``), times the production step's own code.

Domain decomposition (JAX ``navierstokes.py:95-105, 130-148``): with
``parameters.sharding`` in a run of N processes (``parameters.distributed``
or torchrun; ``parallel/multihost.py``), each rank owns one block of every
grid field on the ("dy", "dx") or ("dz", "dy", "dx") process mesh
(``parallel/dist.py``; a 2D grid replicated along "dz").  The state is
scattered at init; the operators are built on the rank's ``LocalMesh``
and exchange halos; means, norms and inner products are summed over the
group; the FDM solves repartition their blocks on a 2-axis mesh, and
contract their transforms over the cut axes on a 3-axis mesh or with
``fdm.repartition: false`` (``linalg/fdm.py``); the V-cycle keeps its
finer levels on the blocks and runs K4-K7 on line pencils and on the
whole coarse levels (``linalg/mg.py``), while K1-K3 stay off (the JAX
package's gates, navierstokes.py:237, 266, 388, 411).  The delta engines
contract and spread on the rank's block (``ibm/interp.py``) and the
probes read their boxes and corners from the blocks that hold them
(``io/probes.py``).  Output, iteration logs and restarts go through
gather and scatter, and only rank 0 writes.  Chunks of steps run on the
ranks as on one device.

The one configuration this port does not cover, an ``mg.dtype`` that the
V-cycle's kernels have no instances of, raises ``NotImplementedError``
(the JAX package refuses it too); nothing is substituted silently.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch

from .. import io as pio
from ..boundary import BoundarySet
from ..config import solver_config
from ..convert import state_to_numpy
from ..ics import initial_fields
from ..linalg.fdm import (FastDiagHelmholtz, FastDiagPoisson, PinnedSolve,
                          fdm_config, helmholtz_lines, holds_first,
                          make_fdm_solver, pinned_operator, set_first)
from ..linalg.krylov import make_solver, tmap
from ..linalg.mg import PoissonMG, poisson_level0
from ..linalg.probe_diag import extract_diagonal
from ..mesh import StaggeredMesh
from ..operators.bn import make_bn
from ..operators.convection import make_convection
from ..operators.cuda_stencil import (make_cuda_convection,
                                      make_cuda_momentum, make_cuda_poisson,
                                      make_cuda_poisson_zblocked)
from ..operators.stencil import make_divergence, make_gradient, make_laplacian
from ..parallel.dist import (GroupSum, LocalMesh, Partition,
                             mesh_from_config)
from ..parallel.multihost import local_rank, maybe_initialize
from ..timeintegration import create_time_integration
from ..types import Field
from ..utils import stamps
from ..utils.profiling import chain_phases
from ..utils.timers import StageTimers, StampBlock
from .chunk import ChunkRunner, StatsLayout, scalar_stats

VEL_NAMES = ("u", "v", "w")

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
#: the V-cycle's dtypes (``mg.dtype``): the solver's, or bfloat16, the
#: mixed-precision V-cycle
_MG_DTYPES = dict(_DTYPES, bfloat16=torch.bfloat16)


def check_supported(config: dict) -> None:
    """Raise NotImplementedError for the options the port does not cover."""
    params = config.get("parameters", {})
    mg_dtype = (params.get("mg") or {}).get("dtype")
    if mg_dtype and str(mg_dtype) not in _MG_DTYPES:
        raise NotImplementedError(
            f"mg.dtype {mg_dtype}: the V-cycle's kernels have float32, "
            "float64 and bfloat16 instances")


def resolve_device(device=None) -> torch.device:
    """The device a solver runs on: ``None`` means cuda.  Raises when cuda
    is asked for and no card is present; it never picks the CPU itself.
    In a process group, cuda without an index is the card
    ``LOCAL_RANK % device_count`` (made the current one)."""
    import torch.distributed as dist

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(-device cpu on the command line) to run on the "
                           "CPU")
    if (device.type == "cuda" and device.index is None
            and dist.is_available() and dist.is_initialized()):
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


class NavierStokesSolver:
    """The projection-method solver; the IBM solvers extend it through
    ``_extra_init``, ``_profile_phases`` (the step's stages) and
    ``_step_stats``."""

    #: set by a subclass that replaces the pressure system (the coupled
    #: IBPM's {p, f} block system)
    _skip_base_poisson = False

    def __init__(self, config: dict, device=None):
        """``device``: where fields live, "cuda" unless given; the CPU
        only when asked for (``device="cpu"``)."""
        self.config = config
        self.timers = StageTimers()
        # the process group comes up before the device is chosen (JAX
        # navierstokes.py:95-105)
        maybe_initialize(config.get("parameters", {}).get("distributed"),
                         device)
        self.device = resolve_device(device)
        check_supported(config)
        with self.timers.stage("initialize"):
            self._init(config)

    # ------------------------------------------------------------------
    def _init(self, config: dict) -> None:
        params = config.get("parameters", {})
        self.dt = float(params["dt"])
        self.nstart = int(params.get("startStep", 0))
        self.ite = self.nstart
        self.t = float(params.get("t", 0.0))
        self.nt = int(params.get("nt", 1))
        self.nsave = int(params.get("nsave", self.nt))
        self.nrestart = int(params.get("nrestart", self.nt))
        self.nu = float(config["flow"]["nu"])
        #: steps a chunk advances (JAX ``navierstokes.py:188-204``)
        self.steps_per_dispatch = max(1, int(params.get("stepsPerDispatch",
                                                        1)))
        self._chunk = None
        #: chunks whose loops overflowed their caps (rerun and recaptured)
        self.chunk_overflows = 0
        dtype_name = params.get("dtype") or "float32"
        if dtype_name not in _DTYPES:
            raise ValueError(f"parameters.dtype must be float32 or float64, "
                             f"got {dtype_name!r}")
        self.dtype = _DTYPES[dtype_name]

        self.mesh = StaggeredMesh(config)
        # the domain decomposition (JAX navierstokes.py:130-148): the rank's
        # blocks, and the mesh view the operators are built on
        self.sharding_mesh = mesh_from_config(params.get("sharding"))
        self.part = None
        self.grid = self.mesh
        if self.sharding_mesh is not None:
            self.part = Partition(self.mesh, self.sharding_mesh)
            self.grid = LocalMesh(self.part)
        #: only rank 0 writes files
        self.is_root = self.part is None or self.part.rank == 0
        self._reduce = None if self.part is None else GroupSum(
            self.part.group)
        #: the FDM solves' core on a decomposed run: the four all-to-alls
        #: unless ``fdm.repartition: false`` (or a 3-axis mesh)
        self._repartition = bool(fdm_config(params).get("repartition", True))
        self._mean = torch.mean if self.part is None else self.part.mean
        self.output_dir = config.get("output", os.getcwd())
        self.logs_dir = config.get("logs", self.output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        os.makedirs(self.logs_dir, exist_ok=True)
        self.hdf5 = pio.hdf5_available()
        if self.hdf5:
            if self.is_root:
                pio.write_grid(self.mesh,
                               os.path.join(self.output_dir, "grid.h5"))
        elif self.nstart > 0:
            raise RuntimeError("a restart start (startStep > 0) reads its "
                               "restart file with h5py, which does not "
                               "import here")
        elif self.is_root:
            print("petibm_tpu_torch: h5py does not import; grid.h5, the "
                  "snapshots and the restart files are not written, only "
                  "the text logs", file=sys.stderr)

        self.bc = BoundarySet(self.mesh, config, part=self.part)

        # initial conditions (solutionsimple.cpp:122-228), host float64;
        # a decomposed run scatters them
        fields0 = initial_fields(config, self.mesh, t=self.t)
        q = {VEL_NAMES[c]: self._field(fields0[VEL_NAMES[c]], Field(c))
             for c in range(self.mesh.dim)}
        self.state = {"q": q, "p": self._field(fields0["p"], Field.P)}
        self.state["bc"] = self.bc.init_state(q, self.dtype)
        self.state["dP"] = torch.zeros_like(self.state["p"])

        self.conv_ti = create_time_integration("convection", config)
        self.diff_ti = create_time_integration("diffusion", config)
        self.state["conv"] = tuple(tmap(torch.zeros_like, q)
                                   for _ in range(self.conv_ti.n_explicit))
        self.state["diff"] = tuple(tmap(torch.zeros_like, q)
                                   for _ in range(self.diff_ti.n_explicit))

        self._create_operators(config)
        with self.timers.stage("solvers"):
            self._create_solvers(config)
        self._extra_init(config)
        self._create_probes(config)
        self._step_fn = self._build_step()

        self.iter_log_path = os.path.join(
            self.output_dir, f"iterations-{self.ite}.txt")
        self._iter_log = (open(self.iter_log_path, "w") if self.is_root
                          else None)
        self._io_done = False
        #: (first step, stats, count) not yet read: a step's device stats
        #: (count 1) or a chunk's host stats stacked (count k)
        self._stats_buffer: list = []
        self._stats_layout = None
        #: every read step's solver stats (host scalars); the iterations
        #: log holds the first ``_n_logged``
        self._stats_host: list[dict] = []
        self._n_logged = 0
        # reference parity: KSP aborts when a solve diverges
        # (linsolverksp.cpp:96-104); "warn" prints, "ignore" continues
        self.divergence_policy = str(params.get("divergence", "abort"))
        if self.divergence_policy not in ("abort", "warn", "ignore"):
            raise ValueError(
                f"parameters.divergence must be abort|warn|ignore, got "
                f"{self.divergence_policy!r}")

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=self.dtype, device=self.device)

    def _field(self, arr, field) -> torch.Tensor:
        """A full host array of ``field`` as the rank's tensor: the whole
        of it, or the rank's block of a decomposed run."""
        if self.part is None:
            return self._tensor(arr)
        return self.part.scatter(np.asarray(arr), field, dtype=self.dtype,
                                 device=self.device)

    def _gather(self, x: torch.Tensor, field) -> torch.Tensor:
        """The full array of the rank's tensor of ``field`` (every rank
        takes part in a decomposed run)."""
        return x if self.part is None else self.part.gather(x, field)

    def _diag_layout(self, leaves) -> dict:
        """``extract_diagonal``'s keywords on the rank's block: its global
        origin and the global shape of ``leaves`` (a field, or a dict of
        velocity components); {} undecomposed."""
        if self.part is None:
            return {}
        if isinstance(leaves, dict):
            shape = {k: self.mesh.shape(Field(VEL_NAMES.index(k)))
                     for k in leaves}
        else:
            shape = self.mesh.shape(leaves)
        return {"origin": self.part.origin(), "global_shape": shape}

    def _extra_init(self, config: dict) -> None:
        """Subclass hook (bodies, extra operators and solvers)."""

    # ------------------------------------------------------------------
    def _create_operators(self, config: dict) -> None:
        """Stencil closures (reference createOperators,
        navierstokes.cpp:317-365), and in 3D the kernels K3 (convection)
        and K2a (momentum operator), chosen as the JAX package chooses
        them (navierstokes.py:234-280)."""
        mesh, bc = self.grid, self.bc
        kw = dict(dtype=self.dtype, device=self.device)
        # no hand kernel on a decomposed run (JAX navierstokes.py:237, 266)
        kernels = (not bool(config.get("parameters", {}).get("disablePallas",
                                                             False))
                   and self.part is None)
        self.grad = make_gradient(mesh, part=self.part, **kw)
        self.div = make_divergence(mesh, bc, **kw)
        self.lap = make_laplacian(mesh, bc, **kw)
        self.convect = make_convection(mesh, bc, **kw)
        if kernels and mesh.dim == 3:
            self.convect = make_cuda_convection(mesh, bc, **kw)
        self.bn_order = int(config.get("parameters", {}).get("BN", 1))
        self.bn = make_bn(self.lap, self.dt,
                          self.diff_ti.implicit_coeff * self.nu, self.bn_order)

        dt, nu, cimp = self.dt, self.nu, self.diff_ti.implicit_coeff

        def A_momentum(u):
            lu = self.lap(u, None, homogeneous=True)
            return tmap(lambda a, b: a / dt - cimp * nu * b, u, lu)

        # the stencil closure stays for the Jacobi probe (the JAX package
        # probes it too, navierstokes.py:255-258)
        self._A_momentum_stencil = A_momentum
        if kernels and mesh.dim == 3 and cimp * nu > 0.0:
            A_momentum = make_cuda_momentum(mesh, bc, dt, cimp * nu, **kw)

        def A_poisson(phi):
            return self.div(self.bn(self.grad(phi)), None, homogeneous=True)

        self.A_momentum = A_momentum
        self.A_poisson = A_poisson

    def _create_solvers(self, config: dict) -> None:
        """The momentum solve, then the pressure solve (the JAX
        _create_solvers, navierstokes.py:282-457, without the branch
        check_supported refuses: the sharded solves)."""
        params = config.get("parameters", {})
        vopts = solver_config(config, "velocity")
        fdm_cfg = fdm_config(params)
        cnu = self.diff_ti.implicit_coeff * self.nu
        # an explicit velocity pc wins over the FDM default; the role's
        # implicit jacobi default does not
        pc_user = vopts.get("pc") if vopts.get("pc_explicit") else None
        if (bool(fdm_cfg.get("enabled", True))
                and bool(fdm_cfg.get("velocity", True)) and cnu > 0.0
                and pc_user is None):
            # direct solve + true-residual refinement; transforms in full
            # precision of the working dtype
            helm = {VEL_NAMES[c]: FastDiagHelmholtz(
                helmholtz_lines(self.mesh, self.bc, c), self.dt, cnu,
                dtype=self.dtype, device=self.device,
                use_fft=bool(fdm_cfg.get("fft", False)))
                for c in range(self.mesh.dim)}
            if self.part is not None:
                # JAX navierstokes.py:325-328
                for c in range(self.mesh.dim):
                    helm[VEL_NAMES[c]].set_mesh(self.part, Field(c),
                                                self._repartition)

            class _HelmDict:
                @staticmethod
                def solve(r):
                    return {k: helm[k].solve(v) for k, v in r.items()}

            self.v_solver = make_fdm_solver(_HelmDict, self.A_momentum, vopts,
                                            reduce=self._reduce)
        else:
            # Krylov momentum solve with the probed Jacobi diagonal
            M_mom = None
            if vopts.get("pc") != "none":
                diag_mom = extract_diagonal(
                    self._A_momentum_stencil,
                    tmap(torch.zeros_like, self.state["q"]), radius=1,
                    **self._diag_layout(self.state["q"]))

                def M_mom(r):
                    return tmap(lambda a, b: a / b, r, diag_mom)

            self.v_solver = make_solver(self.A_momentum, vopts, M=M_mom,
                                        reduce=self._reduce,
                                        region="krylov.velocity")
        self.warm_start = bool(params.get("warmStart", True))
        self.warm_start_poisson = bool(params.get("warmStartPoisson", True))
        if not self._skip_base_poisson:
            self._create_poisson_solver(config)

    def _create_poisson_solver(self, config: dict) -> None:
        """The pressure solve (navierstokes.py:362-457): the pinned
        pressure (``poissonSolver.type: GPU``) or the mean-projected one,
        each by the direct FDM solve with refinement or by a Krylov solve
        preconditioned by ``_make_poisson_pc``."""
        params = config.get("parameters", {})
        popts = solver_config(config, "poisson")
        # pinned pressure (the reference's AmgX path) vs mean projection
        # (its KSP path)
        self.is_ref_p = popts.get("backend") == "GPU"
        A_p = (pinned_operator(self.A_poisson, part=self.part)
               if self.is_ref_p else self.A_poisson)

        def negA_p(phi):
            return -A_p(phi)

        self._negA_p = negA_p
        if (self.is_ref_p and self.bn_order == 1
                and bool(fdm_config(params).get("enabled", True))):
            # the pinned system's exact inverse from the projected FDM
            # solve (navierstokes.py:410-441): two transform sets a solve,
            # where MG-CG on the pinned system takes ~80 V-cycles a step
            # at 450^2; its operator stays the closure (no K1).  As in the
            # JAX package it takes the FFT default, whatever fdm.fft says
            self._poisson_pc_check(popts)
            fdm_pin = FastDiagPoisson(self.mesh.dxp, self.mesh.periodic,
                                      dtype=self.dtype, device=self.device,
                                      scale=self.dt)
            if self.part is not None:
                fdm_pin.set_mesh(self.part, self._repartition)
            self._poisson_fdm_pinned = fdm_pin
            self.p_solver = make_fdm_solver(
                PinnedSolve(fdm_pin, part=self.part), negA_p, popts,
                reduce=self._reduce)
            return
        M_p = self._M_p = self._make_poisson_pc(popts)
        # for BN order 1, -D B1 G equals the level-0 operator: K1 on
        # non-periodic grids, K2b on 3D grids with a periodic axis; 2D
        # periodic grids keep the closure (navierstokes.py:382-408).  It
        # is the CG or refinement operator and the V-cycle's level-0
        # residual.  The pinned operator keeps the closure.
        if (not self.is_ref_p and self.bn_order == 1
                and getattr(self, "poisson_level", None) is not None
                and not bool(params.get("disablePallas", False))
                and self.part is None):  # JAX :388, 411
            fused = make_cuda_poisson(self.poisson_level)
            if fused is None and self.mesh.dim == 3:
                fused = make_cuda_poisson_zblocked(self.poisson_level)
            if fused is not None:
                self._negA_p = fused
                if getattr(self, "poisson_mg", None) is not None:
                    self.poisson_mg.set_fused_apply(fused)
            # the low-precision V-cycle's level-0 residual: K1 in its
            # dtype on non-periodic grids, and no K2b (JAX :404-408)
            mg_lp = getattr(self, "poisson_mg_lp", None)
            if mg_lp is not None:
                fused_lp = make_cuda_poisson(mg_lp.levels[0])
                if fused_lp is not None:
                    mg_lp.set_fused_apply(fused_lp)
        if (getattr(self, "poisson_fdm", None) is not None
                and self._fdm_mode == "direct"):
            self.p_solver = make_fdm_solver(self.poisson_fdm, self._negA_p,
                                            popts, reduce=self._reduce)
        else:
            self.p_solver = make_solver(self._negA_p, popts, M=M_p,
                                        reduce=self._reduce)

    def _poisson_pc_check(self, popts: dict) -> None:
        if (popts.get("pc", "mg") == "fdm"
                and (self.bn_order != 1 or self.is_ref_p)):
            raise ValueError("poisson pc 'fdm' requires BN order 1 and the "
                             "CPU-backend (mean-projection) nullspace "
                             "treatment")

    def _make_poisson_pc(self, popts: dict):
        """The pressure preconditioner (navierstokes.py:459-576), building
        what it needs: for pc mg or fdm, ``poisson_fdm`` (BN order 1, not
        pinned, unless ``fdm: false``; None is returned for its default
        direct mode, the exact pseudo-inverse with output mean removal for
        ``fdm.mode: pcg``) or else ``poisson_mg`` (its V-cycle, the mean
        removed unless pinned); for pc jacobi the probed diagonal of
        ``_negA_p``; for pc none, None.  ``poisson_level`` is the level-0
        factors of either solve (the K1 operator)."""
        pc = popts.get("pc", "mg")
        if pc == "none":
            return None
        if pc not in ("mg", "fdm"):
            diag_p = extract_diagonal(
                self._negA_p, torch.zeros_like(self.state["p"]),
                radius=self.bn_order, **self._diag_layout(Field.P))
            return lambda r: r / diag_p
        self._poisson_pc_check(popts)
        params = self.config.get("parameters", {})
        fdm_cfg = fdm_config(params)
        kw = dict(dtype=self.dtype, device=self.device, scale=self.dt)
        if (self.bn_order == 1 and not self.is_ref_p
                and (pc == "fdm" or bool(fdm_cfg.get("enabled", True)))):
            self.poisson_fdm = FastDiagPoisson(
                self.mesh.dxp, self.mesh.periodic,
                use_fft=bool(fdm_cfg.get("fft", False)), **kw)
            self.poisson_level = poisson_level0(self.mesh.dxp,
                                                self.mesh.periodic, **kw)
            if self.part is not None:
                # JAX navierstokes.py:495-500
                self.poisson_fdm.set_mesh(self.part, self._repartition)
            self._fdm_mode = str(fdm_cfg.get("mode", "direct"))
            if self._fdm_mode == "direct":
                return None
            # "pcg": CG preconditioned by the FDM pseudo-inverse, its
            # output mean removed (navierstokes.py:536-544)
            fdm, mean = self.poisson_fdm, self._mean

            def M_fdm(r):
                out = fdm.solve(r)
                return out - mean(out)

            return M_fdm
        mg = params.get("mg", {}) or {}
        # V(1,1) by default, as in the JAX package
        knobs = dict(
            kernels=not bool(params.get("disablePallas", False)),
            pre=int(mg.get("pre", 1)), post=int(mg.get("post", 1)),
            omega=float(mg.get("omega", 1.0)),
            coarse_sweeps=int(mg.get("coarseSweeps", 10)),
            consolidate_below=int(mg.get("consolidateBelow", 4096)),
            device=self.device, scale=self.dt)
        self.poisson_mg = PoissonMG(self.mesh.dxp, self.mesh.periodic,
                                    dtype=self.dtype, **knobs)
        if self.part is not None:
            # JAX navierstokes.py:523-531: the levels above
            # consolidateBelow cells decomposed, the rest whole
            self.poisson_mg.set_mesh(self.part)
        self.poisson_level = self.poisson_mg.levels[0]
        lp_dtype = _MG_DTYPES.get(str(mg.get("dtype")), self.dtype)
        if lp_dtype == self.dtype:
            return self.poisson_mg.preconditioner(
                remove_mean=not self.is_ref_p)
        # the mixed-precision V-cycle (navierstokes.py:545-568): the CG
        # operator and solution stay in the solver's dtype, the V-cycle's
        # coefficients and smoother arithmetic in the lower precision
        # (K4-K7 in bfloat16; K1 at its level-0 residual, set in
        # _create_poisson_solver), which halves the bytes it streams
        self.poisson_mg_lp = mg_lp = PoissonMG(
            self.mesh.dxp, self.mesh.periodic, dtype=lp_dtype, **knobs)
        if self.part is not None:
            mg_lp.set_mesh(self.part)  # JAX :557-558
        remove_mean, out_dtype = not self.is_ref_p, self.dtype
        mean = self._mean

        def M_lp(r):
            # the nullspace means in the solver's dtype: a low-precision
            # sum over the whole grid would be noise
            if remove_mean:
                r = r - mean(r)
            out = mg_lp.cycle(r.to(lp_dtype)).to(out_dtype)
            return out - mean(out) if remove_mean else out

        return M_lp

    # ------------------------------------------------------------------
    # step building blocks, shared with the IBM subclasses
    def _rhs_velocity(self, state):
        """assembleRHSVelocity (navierstokes.cpp:432-521); returns
        (rhs1, updated state)."""
        dt, nu = self.dt, self.nu
        cimp = self.diff_ti.implicit_coeff
        q, p, bcstate = state["q"], state["p"], state["bc"]
        conv, diff = state["conv"], state["diff"]

        gp = self.grad(p)
        rhs1 = tmap(lambda u, g: u / dt - g, q, gp)
        if self.conv_ti.explicit_coeffs:
            with stamps.region("convection"):
                nq = self.convect(q, bcstate)
            # history tuple, newest first
            conv = (tmap(lambda x: -x, nq),) + conv[:-1]
            for c, h in zip(self.conv_ti.explicit_coeffs, conv):
                rhs1 = tmap(lambda r, x: r + c * x, rhs1, h)
        if self.diff_ti.explicit_coeffs:
            lq = tmap(lambda a, b: a + b,
                      self.lap(q, None, homogeneous=True),
                      self.lap.correction(bcstate))
            diff = (tmap(lambda x: nu * x, lq),) + diff[:-1]
            for c, h in zip(self.diff_ti.explicit_coeffs, diff):
                rhs1 = tmap(lambda r, x: r + c * x, rhs1, h)
        # implicit BC correction with the POST-update_eqs a1
        # (reference navierstokes.cpp:505)
        bcstate = self.bc.update_eqs(bcstate, q, dt)
        if cimp != 0.0:
            rhs1 = tmap(lambda r, x: r + cimp * nu * x,
                        rhs1, self.lap.correction(bcstate))
        state = dict(state, bc=bcstate, conv=conv, diff=diff)
        return rhs1, state

    def _solve_velocity(self, rhs1, state):
        x0 = (state["q"] if self.warm_start
              else tmap(torch.zeros_like, state["q"]))
        return self.v_solver(rhs1, x0)

    def _rhs_poisson(self, ustar, state):
        """assembleRHSPoisson (navierstokes.cpp:540-563): the pinned row
        0 set to 0, or the mean removed (nullspace-consistent)."""
        rhs2 = self.div(ustar, state["bc"])
        if self.is_ref_p:
            if not holds_first(self.part):
                return rhs2
            return set_first(rhs2.reshape(-1), 0.0).reshape(rhs2.shape)
        return rhs2 - self._mean(rhs2)

    def _solve_poisson(self, rhs2, state):
        """solvePoisson (navierstokes.cpp:566-580)."""
        x0 = (state["dP"] if self.warm_start_poisson
              else torch.zeros_like(state["p"]))
        return self.p_solver(-rhs2, x0)

    def _project_update(self, ustar, dP, state):
        """applyDivergenceFreeVelocity + updatePressure
        (navierstokes.cpp:583-615); returns (q, p, dP)."""
        if not self.is_ref_p:
            dP = dP - self._mean(dP)
        qnew = tmap(lambda u, g: u - g, ustar, self.bn(self.grad(dP)))
        return qnew, state["p"] + dP, dP

    def _build_step(self):
        """One time step as a state -> (state, stats) function (advance,
        navierstokes.cpp:240-266): the phases of ``_profile_phases``
        chained, the solves' stats read from the last context."""
        phases = self._profile_phases()

        def step(state):
            ctx = chain_phases(phases, state)
            return ctx["state"], self._step_stats(ctx)

        return step

    def _step_stats(self, ctx: dict) -> dict:
        vsol, psol = ctx["vsol"], ctx["psol"]
        return {"v_iters": vsol.iters, "v_res": vsol.residual,
                "v_ok": vsol.converged,
                "p_iters": psol.iters, "p_res": psol.residual,
                "p_ok": psol.converged}

    def _profile_phases(self):
        """The step as an ordered list of (name, fn) phases, each fn
        mapping a context dict to the next: the reference's PETSc log
        stages (navierstokes.cpp:99-199; JAX ``navierstokes.py:667-703``),
        which the stage profiler times one by one and ``_build_step``
        chains."""

        def rhsVelocity(ctx):
            rhs1, state = self._rhs_velocity(ctx["state"])
            return dict(ctx, state=state, rhs1=rhs1)

        def solveVelocity(ctx):
            vsol = self._solve_velocity(ctx["rhs1"], ctx["state"])
            return dict(ctx, vsol=vsol, ustar=vsol.x)

        def rhsPoisson(ctx):
            return dict(ctx, rhs2=self._rhs_poisson(ctx["ustar"],
                                                    ctx["state"]))

        def solvePoisson(ctx):
            psol = self._solve_poisson(ctx["rhs2"], ctx["state"])
            return dict(ctx, psol=psol, dP=psol.x)

        def update(ctx):
            state = ctx["state"]
            qnew, pnew, dP = self._project_update(ctx["ustar"], ctx["dP"],
                                                  state)
            bc = self.bc.update_ghost_values(state["bc"], qnew)
            return dict(ctx, state=dict(state, q=qnew, p=pnew, dP=dP, bc=bc))

        return [("rhsVelocity", rhsVelocity),
                ("solveVelocity", solveVelocity),
                ("rhsPoisson", rhsPoisson),
                ("solvePoisson", solvePoisson),
                ("update", update)]

    def profile_stages(self, steps: int = 10, warmup: int = 3,
                       path: str | None = None) -> dict:
        """The per-phase time of the step (``utils/profiling.py``): writes
        the stage table to logs/stages-<ite>.txt (or ``path``; rank 0's
        alone on a decomposed run) and returns {phase: ms, "_total": ...,
        "_fused": ...}."""
        from ..utils.profiling import profile_stages

        if path is None and self.is_root:
            path = os.path.join(self.logs_dir, f"stages-{self.ite}.txt")
        return profile_stages(self, steps=steps, warmup=warmup, path=path)

    # ------------------------------------------------------------------
    @functools.cached_property
    def stamp_layout(self) -> stamps.Layout:
        """The columns of a traced step's device stamps: one after each
        phase of ``_profile_phases``."""
        return stamps.Layout([name for name, _ in self._profile_phases()])

    def trace_spans(self, on: bool = True) -> None:
        """Switch tracing on or off (``utils/timers.py``,
        ``utils/stamps.py``).  On: the card's clock put on the host's,
        the span records and device stamps kept from now on, and a chunked
        run's stamped step captured beside the plain one.  Off: the
        aggregates alone, and chunks replay the plain graph captured
        before, which was kept as it was."""
        if bool(on) == self.timers.tracing:
            return
        if on:
            with self.timers.stage("trace_spans"):
                with self.timers.stage("calibrate"):
                    clock = stamps.Clock.calibrate(self.device)
                self.timers.start_tracing(clock)
                if self._chunk is not None:
                    self._chunk.trace(True)
            return
        self.timers.stop_tracing()
        if self._chunk is not None:
            self._chunk.trace(False)

    def advance(self) -> None:
        self.t += self.dt
        self.ite += 1
        timers = self.timers
        with timers.stage("step"):
            if not timers.tracing:
                self.state, stats = self._step_fn(self.state)
            else:
                st = stamps.Stamps.one_row(self.stamp_layout, timers.clock,
                                           self.device)
                with stamps.use(st):
                    self.state, stats = self._step_fn(self.state)
                    st.end()
                timers.keep_stamps(StampBlock(timers.current_span(),
                                              self.ite, st.layout.names,
                                              st.rows, st.layout.regions))
        self._record_stats(self.ite, stats, 1)

    def _device_allocs(self):
        """The caching allocator's allocations from the driver so far
        (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats_as_nested_dict(self.device)
        return stats["num_device_alloc"]

    def advance_chunk(self) -> None:
        """Advance ``steps_per_dispatch`` steps in one host round trip
        (JAX ``navierstokes.py:729-738``; ``solvers/chunk.py``), in the
        span ``chunk``; while tracing, its counter ``device_allocs``."""
        timers = self.timers
        with timers.stage("chunk"):
            allocs = self._device_allocs() if timers.tracing else None
            self._advance_chunk()
            if allocs is not None:
                timers.add("device_allocs", self._device_allocs() - allocs)

    def _advance_chunk(self) -> None:
        k = self.steps_per_dispatch
        if self._chunk is None:
            with self.timers.stage("chunk.capture"):
                self._chunk = ChunkRunner(self)
                self._chunk.trace(self.timers.tracing)
                self._chunk.prepare()
        stats = self._chunk.run()
        if stats is None:
            # a loop overflowed its cap: the k steps through the host
            # driver, then the step captured again with the caps doubled
            self.chunk_overflows += 1
            with self.timers.stage("chunk.rerun"):
                for _ in range(k):
                    self.advance()
                with self.timers.stage("chunk.capture"):
                    self._chunk.capture()
            return
        self.t += k * self.dt
        self.ite += k
        self._record_stats(self.ite - k + 1, {
            key: np.stack([s[key] for s in stats]) for key in stats[0]}, k)

    def _record_stats(self, ite0: int, stats: dict, count: int) -> None:
        """Queue per-step solver stats (device tensors of one step, or a
        chunk's host values stacked along axis 0) for the flush."""
        self._stats_buffer.append((ite0, stats, count))

    def _steps_to_host_event(self) -> int:
        """Steps until the host next needs state (save / restart / probe
        monitor / end of run): the window advance_chunk may fill (JAX
        ``navierstokes.py:746-755``)."""
        nexts = [self.nstart + self.nt - self.ite]
        intervals = [self.nsave, self.nrestart]
        intervals += [p.n_monitor for p in getattr(self, "probes", [])]
        for interval in intervals:
            if interval > 0:
                nexts.append(interval - self.ite % interval)
        return min(nexts)

    def _read_stats(self) -> None:
        """Read the queued stats to the host: one read for every queued
        single step's device stats."""
        items, self._stats_buffer = self._stats_buffer, []
        single = [scalar_stats(s) for _, s, count in items if count == 1]
        if single:
            if self._stats_layout is None:
                self._stats_layout = StatsLayout(single[0])
            layout = self._stats_layout
            rows = iter(torch.stack([layout.pack(s) for s in single])
                        .cpu().numpy())
        for ite0, s, count in items:
            if count == 1:
                self._stats_host.append(dict(layout.unpack(next(rows)),
                                             ite=ite0))
                continue
            for j in range(count):
                self._stats_host.append(dict(
                    {k: v[j].item() for k, v in s.items() if v.ndim == 1},
                    ite=ite0 + j))

    @property
    def stats_history(self) -> list[dict]:
        """Every step's solver stats as host values (read here where they
        are still on the device); the iterations log's rows."""
        self._read_stats()
        return self._stats_host

    def finished(self) -> bool:
        return self.ite >= self.nstart + self.nt

    # ------------------------------------------------------------------
    def _solution_fields(self) -> dict:
        """u, v(, w) and p as numpy arrays on the host (gathered on a
        decomposed run)."""
        out = {VEL_NAMES[c]: self._gather(self.state["q"][VEL_NAMES[c]],
                                          Field(c))
               for c in range(self.mesh.dim)}
        out["p"] = self._gather(self.state["p"], Field.P)
        return state_to_numpy(out)

    def _snapshot_path(self) -> str:
        return os.path.join(self.output_dir, f"{self.ite:07d}.h5")

    def io_initial_data(self) -> None:
        """Write the step-0 snapshot or read the restart data
        (navierstokes.cpp:207-237); text logs only without h5py."""
        if not self.hdf5:
            return
        if self.ite == 0:
            self.write_solution_hdf5(self._snapshot_path())
        else:
            self.read_restart_data_hdf5(self._snapshot_path())

    def write_solution_hdf5(self, path: str) -> None:
        fields = self._solution_fields()
        if self.is_root:
            pio.write_solution(path, fields)
            pio.write_time(path, self.t)

    def write_restart_data_hdf5(self, path: str) -> None:
        # every rank takes part in the gathers; rank 0 decides and writes
        if self.part is not None or not os.path.isfile(path):
            fields = self._solution_fields()
            if self.is_root and not os.path.isfile(path):
                pio.write_solution(path, fields)
                pio.write_time(path, self.t)
        hist = [tuple({k: self._gather(v, Field(VEL_NAMES.index(k)))
                       for k, v in h.items()} for h in self.state[key])
                for key in ("conv", "diff")]
        extra = state_to_numpy(self._restart_extra())
        if self.is_root:
            pio.write_restart_histories(
                path, self.mesh.dim, state_to_numpy(hist[0]),
                state_to_numpy(hist[1]), extra=extra)

    def _restart_extra(self) -> dict:
        """Extras beyond the reference's layout (its readers ignore them):
        dP, the pressure solve's warm start, and the BC ghost state, which
        the reference re-initialises (navierstokes.cpp:742)."""
        return dict({"dP": self._gather(self.state["dP"], Field.P)},
                    **self._bc_restart_extra())

    def _bc_restart_extra(self) -> dict:
        """Per-face BC ghost state (a1 and value; a decomposed run's
        segments gathered)."""
        extra = {}
        for spec in self.bc.specs.values():
            st = self.state["bc"][spec.key]
            for name in ("a1", "value"):
                a = st[name]
                if self.part is not None:
                    a = self.part.gather_face(a, spec.field, spec.loc.axis,
                                              int(spec.loc.is_max))
                extra[f"bc_{spec.key}_{name}"] = a
        return extra

    def read_restart_data_hdf5(self, path: str) -> None:
        names = [VEL_NAMES[c] for c in range(self.mesh.dim)] + ["p"]
        data = pio.read_solution(path, names)
        q = {n: self._field(data[n], Field(VEL_NAMES.index(n)))
             for n in names if n != "p"}
        self.state["q"] = q
        self.state["p"] = self._field(data["p"], Field.P)
        self.t = pio.read_time(path)
        shapes = {VEL_NAMES[c]: self.mesh.shape(Field(c))
                  for c in range(self.mesh.dim)}
        conv, diff, extra = pio.read_restart_histories(
            path, self.mesh.dim, shapes, len(self.state["conv"]),
            len(self.state["diff"]), extra_names=tuple(self._restart_extra()))
        self.state["conv"] = tuple(
            {k: self._field(v, Field(VEL_NAMES.index(k)))
             for k, v in h.items()} for h in conv)
        self.state["diff"] = tuple(
            {k: self._field(v, Field(VEL_NAMES.index(k)))
             for k, v in h.items()} for h in diff)
        # the reference's default ghost state, then the saved one where the
        # file has it
        self.state["bc"] = self.bc.init_state(q, self.dtype)
        self._read_restart_extra(extra)

    def _read_restart_extra(self, extra: dict) -> None:
        if "dP" in extra:
            self.state["dP"] = self._field(
                extra["dP"].reshape(self.mesh.shape(Field.P)), Field.P)
        self._restore_bc_extra(extra)

    def _restore_bc_extra(self, extra: dict) -> None:
        bcstate = dict(self.state["bc"])
        for spec in self.bc.specs.values():
            key = spec.key
            a1 = extra.get(f"bc_{key}_a1")
            val = extra.get(f"bc_{key}_value")
            if a1 is None or val is None:
                continue
            if self.part is None:
                shape = bcstate[key]["a1"].shape
                bcstate[key] = {"a1": self._tensor(a1.reshape(shape)),
                                "value": self._tensor(val.reshape(shape))}
                continue
            shape = list(self.mesh.shape(Field(spec.field)))
            del shape[self.mesh.axis_of(spec.loc.axis)]
            bcstate[key] = {
                name: self.part.scatter_face(
                    arr.reshape(shape), spec.field, spec.loc.axis,
                    dtype=self.dtype, device=self.device)
                for name, arr in (("a1", a1), ("value", val))}
        self.state["bc"] = bcstate

    # ------------------------------------------------------------------
    def write(self) -> None:
        """Per-step outputs (write, navierstokes.cpp:269-308): the
        iterations log, the snapshot and the restart data."""
        with self.timers.stage("write"):
            self.write_lin_solvers_info()
            if self.ite % self.nsave == 0:
                if self.hdf5:
                    self.write_solution_hdf5(self._snapshot_path())
                if self.is_root:
                    self.timers.dump(os.path.join(self.logs_dir,
                                                  f"{self.ite:07d}.log"))
            if self.hdf5 and self.ite % self.nrestart == 0:
                self.write_restart_data_hdf5(self._snapshot_path())
        self.monitor_probes()

    def _iter_log_stats(self, s: dict) -> list[tuple]:
        return [(s["v_iters"], s["v_res"]), (s["p_iters"], s["p_res"])]

    def write_lin_solvers_info(self) -> None:
        """iterations-<start>.txt lines (navierstokes.cpp:766-794), flushed
        at save points and at the end of the run."""
        if self.ite % self.nsave == 0 or self.finished():
            self._flush_iter_log()

    _SOLVER_NAMES = {"v": "velocity", "p": "poisson", "f": "forces"}

    def _flush_iter_log(self) -> None:
        """Write the stats read since the last flush; a divergence among
        them raises here and names its step (JAX
        ``navierstokes.py:875-906``)."""
        items = self.stats_history[self._n_logged:]
        if not items:
            return
        self._n_logged = len(self.stats_history)
        failures = []
        for s in items:
            ite = s["ite"]
            cols = [str(ite)]
            for iters, res in self._iter_log_stats(s):
                cols.append(f"{int(iters)}\t{float(res):e}")
            if self._iter_log is not None:
                self._iter_log.write("\t".join(cols) + "\n")
            for key, val in s.items():
                if key.endswith("_ok") and not bool(val):
                    pre = key[:-3]
                    failures.append((self._SOLVER_NAMES.get(pre, pre), ite,
                                     int(s[f"{pre}_iters"]),
                                     float(s[f"{pre}_res"])))
        if self._iter_log is not None:
            self._iter_log.flush()
        if failures and self.divergence_policy != "ignore":
            name, step, iters, res = failures[0]
            msg = (f"{name} solver diverged at time step {step}: "
                   f"{iters} iterations, residual {res:e} "
                   f"(+{len(failures) - 1} more failure(s); see "
                   f"{self.iter_log_path})")
            if self.divergence_policy == "abort":
                from ..linalg.krylov import SolverDivergedError

                raise SolverDivergedError(msg)
            print(f"WARNING: {msg}", file=sys.stderr)

    def _create_probes(self, config: dict) -> None:
        """The probes of ``config["probes"]``, relative paths under the
        output directory (navierstokes.cpp:167-177)."""
        from ..io.probes import create_probe

        self.probes = []
        for node in config.get("probes", []) or []:
            node = dict(node)
            if not os.path.isabs(node.get("path", "")):
                node["path"] = os.path.join(self.output_dir, node["path"])
            self.probes.append(create_probe(node, self.mesh, self.bc,
                                            part=self.part))

    def monitor_probes(self) -> None:
        """monitorProbes (navierstokes.cpp:840-856): each probe reads the
        fields on the device (the rank's blocks of a decomposed run: every
        rank takes part, rank 0 writes)."""
        if not self.probes:
            return
        with self.timers.stage("monitor"):
            fields = {VEL_NAMES[c]: self.state["q"][VEL_NAMES[c]]
                      for c in range(self.mesh.dim)}
            fields["p"] = self.state["p"]
            fields["_bcstate"] = self.state["bc"]
            for probe in self.probes:
                probe.monitor(fields, self.ite, self.t)

    # ------------------------------------------------------------------
    def run(self, progress: bool = False) -> None:
        """Main loop (applications/navierstokes/main.cpp:45-78), after
        ``io_initial_data`` on the first call (a later call, with ``nt``
        raised, goes on from where the last one stopped)."""
        if not self._io_done:
            self.io_initial_data()
            self._io_done = True
        try:
            while not self.finished():
                # chunks wherever no host event falls inside one (JAX
                # navierstokes.py:934-952)
                if (self.steps_per_dispatch > 1
                        and self._steps_to_host_event()
                        >= self.steps_per_dispatch):
                    self.advance_chunk()
                else:
                    self.advance()
                self.write()
                if progress and self.is_root and (self.ite % self.nsave == 0
                                                  or self.finished()):
                    print(f"[time step {self.ite}] t = {self.t:.6g}")
        finally:
            # a mid-run exception still lands every buffered record on disk
            self.flush_logs()

    def flush_logs(self) -> None:
        """Flush the buffered per-step logs (iterations, forces)."""
        try:
            self._flush_iter_log()
        finally:
            flush_forces = getattr(self, "_flush_forces", None)
            if flush_forces is not None:
                flush_forces()

    def close(self) -> None:
        self._flush_iter_log()
        if self._iter_log and not self._iter_log.closed:
            self._iter_log.close()
        for probe in self.probes:
            probe.close()
