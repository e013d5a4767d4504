"""Device ms of one V-cycle of the pressure solve's multigrid, through
its own entry (``cycle``, as the CG preconditioner calls it) on the
solver's own pressure field: the device time of the cycle's operations
in a torch.profiler trace of a hundred cycles after the window.  Only
where the pressure solve runs the V-cycle."""

from benchmark import timing


def read(run):
    solver = run.solver
    mg = getattr(solver, "poisson_mg", None)
    if mg is None or solver.device.type != "cuda":
        return None
    r = solver.state["p"].to(mg.dtype).clone()
    seconds = timing.device_s(mg.cycle, r)
    return None if seconds is None else 1e3 * seconds
