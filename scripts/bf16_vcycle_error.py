"""Where the bfloat16 V-cycle (``mg: {dtype: bfloat16}``) loses its
accuracy on a stretched grid: the port's plain twins on the CPU, no card.

On the flagship's mesh (``chip_smoke.flagship_config``, 450^2, its cells
scaled by ``--scale``) it prints, against float64:

- one line sweep of the smoother (K4's twin) from phi = 0, direction by
  direction, with (a) every operation rounded to bfloat16 (the JAX
  package's design and the port's kernels), (b) bfloat16 coefficients
  and right side in float64 arithmetic, (c) the same in float32
  arithmetic, (d) float32 throughout;
- one V-cycle of the bfloat16 hierarchy, with its sweeps as in (a) and
  as in (c), against the float32 V-cycle, and the iterations CG takes
  with each (at most ``--maxiter``) to 1e-6 of the right side's norm.

    python3 scripts/bf16_vcycle_error.py --scale 0.5
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from petibm_tpu_torch.linalg import cuda_sweep, mg as mg_mod  # noqa: E402
from petibm_tpu_torch.linalg.krylov import cg  # noqa: E402
from petibm_tpu_torch.linalg.mg import PoissonMG  # noqa: E402

BF16 = torch.bfloat16


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def sweep_in_float32(phi, rhs, aux, axis, omega):
    """K4's twin in float32 arithmetic on bfloat16 operands, rounded to
    bfloat16 once (variant (c))."""
    return cuda_sweep.fused_sweep_ref(
        phi.float(), rhs.float(), [a.float() for a in aux], axis,
        omega).to(BF16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.5,
                    help="the flagship's cell counts times this")
    ap.add_argument("--maxiter", type=int, default=120)
    args = ap.parse_args()
    torch.set_num_threads(4)
    cfg = chip_smoke.flagship_config(os.path.join(tempfile.mkdtemp(), "f"))
    # one list of subdomains serves both axes
    for sub in cfg["mesh"][0]["subDomains"]:
        sub["cells"] = int(round(sub["cells"] * args.scale))
    mesh, _ = chip_smoke._mesh_and_bcs(cfg)
    kw = dict(device="cpu", scale=cfg["parameters"]["dt"], pre=1, post=1)
    mgs = {dt: PoissonMG(mesh.dxp, mesh.periodic, dtype=dt, **kw)
           for dt in (torch.float64, torch.float32, BF16)}
    shape = mgs[torch.float64].levels[0].shape
    print(f"flagship mesh x {args.scale}: {shape}, "
          f"{len(mgs[BF16].levels)} levels")
    rng = np.random.default_rng(0)
    rhs = torch.as_tensor(rng.standard_normal(shape))
    zero = torch.zeros(shape, dtype=torch.float64)
    for d in range(2):
        axis = 1 - d
        exact = cuda_sweep.fused_sweep_ref(
            zero, rhs, mgs[torch.float64]._aux(0, d), axis, 1.0)
        aux16 = mgs[BF16]._aux(0, d)
        variants = {
            "(a) bf16 op by op": cuda_sweep.fused_sweep_ref(
                zero.to(BF16), rhs.to(BF16), aux16, axis, 1.0),
            "(b) bf16 data, f64 math": cuda_sweep.fused_sweep_ref(
                zero, rhs.to(BF16).double(), [a.double() for a in aux16],
                axis, 1.0),
            "(c) bf16 data, f32 math": sweep_in_float32(
                zero.to(BF16), rhs.to(BF16), aux16, axis, 1.0),
            "(d) float32": cuda_sweep.fused_sweep_ref(
                zero.float(), rhs.float(), mgs[torch.float32]._aux(0, d),
                axis, 1.0)}
        print(f"one sweep, direction {d}, against float64: " + "; ".join(
            f"{k} {rel(v, exact):.3e}" for k, v in variants.items()))
    b = rhs.float() - rhs.float().mean()
    m32 = mgs[torch.float32]

    def lowp(r):
        r = r - torch.mean(r)
        out = mgs[BF16].vcycle(0, r.to(BF16)).float()
        return out - torch.mean(out)

    def solve(label, M):
        res = cg(lambda x: m32.apply_op(0, x), b, torch.zeros_like(b), M=M,
                 atol=1e-6 * float(b.norm()), maxiter=args.maxiter)
        print(f"{label}: CG converged {bool(res.converged)} in "
              f"{int(res.iters)} iterations, residual "
              f"{float(res.residual):.3e}")

    ref = m32.preconditioner()(b)
    solve("float32 V-cycle", m32.preconditioner())
    for label, sweep in (("(a)", cuda_sweep.fused_sweep_ref),
                         ("(c)", sweep_in_float32)):
        mg_mod.fused_sweep = sweep
        print(f"bfloat16 V-cycle, sweeps as {label}: {rel(lowp(b), ref):.3e}"
              " from the float32 one")
        solve(f"bfloat16 V-cycle {label}", lowp)
    mg_mod.fused_sweep = cuda_sweep.fused_sweep
    return 0


if __name__ == "__main__":
    sys.exit(main())
