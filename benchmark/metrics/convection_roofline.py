"""The 3D convection term of (u, v, w) in one call, through the solver's
own entry on the solver's own velocity, as a share of its bound: three
fields read and three written once over the card's HBM bandwidth, in %.
The time is the device time of the entry's operations (the ghost fill
with the kernel) in a torch.profiler trace of a hundred calls after the
window.  2D cells have no such kernel: nothing is read."""

from benchmark import timing, work


def read(run):
    solver = run.solver
    if solver.mesh.dim != 3 or solver.device.type != "cuda":
        return None
    q, bc = solver.state["q"], solver.state["bc"]
    seconds = timing.device_s(lambda arg: solver.convect(arg, bc), q)
    if seconds is None:
        return None
    dtype = str(solver.dtype).removeprefix("torch.")
    return work.roofline_pct(seconds, work.convection_bytes(
        [v.shape for v in q.values()], dtype))
