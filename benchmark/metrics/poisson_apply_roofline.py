"""The pressure operator's apply (-D B1 G) on the solver's own pressure
field, through the solver's own entry, as a share of its bound: the
field read once and the result written once over the card's HBM
bandwidth, in %.  The time is the device time of the entry's operations
in a torch.profiler trace of a hundred applies after the window."""

from benchmark import timing, work


def read(run):
    solver = run.solver
    apply = getattr(solver, "_negA_p", None)
    if apply is None or solver.device.type != "cuda":
        return None
    phi = solver.state["p"].clone()
    seconds = timing.device_s(apply, phi)
    if seconds is None:
        return None
    dtype = str(solver.dtype).removeprefix("torch.")
    return work.roofline_pct(seconds, work.poisson_apply_bytes(phi.shape,
                                                               dtype))
