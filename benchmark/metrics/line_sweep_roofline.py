"""One line-Jacobi sweep in every direction of the V-cycle's finest
level, through the multigrid's own entry (``smooth``), on the solver's
own pressure field, as a share of its bound: per direction the iterate
and the right side read and the iterate written once over the card's
HBM bandwidth, in %.  The time is the device time in a torch.profiler
trace of a hundred calls after the window.  Only where the pressure
solve runs the V-cycle."""

from benchmark import timing, work


def read(run):
    solver = run.solver
    mg = getattr(solver, "poisson_mg", None)
    if mg is None or solver.device.type != "cuda":
        return None
    p = solver.state["p"]
    if tuple(p.shape) != tuple(mg.levels[0].shape):
        return None
    phi, rhs = p.to(mg.dtype).clone(), p.to(mg.dtype).clone()
    seconds = timing.device_s(lambda arg: mg.smooth(0, arg, rhs, 1), phi)
    if seconds is None:
        return None
    dtype = str(mg.dtype).removeprefix("torch.")
    return work.roofline_pct(seconds, work.line_sweep_bytes(phi.shape,
                                                            dtype))
