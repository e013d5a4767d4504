"""The pressure solve's iterations a step, the mean over every step of
the window: refinement passes of the FDM solve, CG iterations of
MG-CG (the solver's own counter)."""


def read(run):
    iters = [s["p_iters"] for s in run.stats if "p_iters" in s]
    return sum(iters) / len(iters) if iters else None
