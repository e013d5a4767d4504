"""The velocity solve's iterations a step, the mean over every step of
the window: BiCGStab or CG iterations of a Krylov velocity solve,
refinement passes of the FDM solve (the solver's own counter)."""


def read(run):
    iters = [s["v_iters"] for s in run.stats if "v_iters" in s]
    return sum(iters) / len(iters) if iters else None
