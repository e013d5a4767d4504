"""The card's idle share, in %: 1 - (device busy time a step) / (wall
time a step).  Busy time is the union of the device operations'
intervals in the traced chunks over their steps; wall time is the
window's median chunk over its steps, hundreds of chunks of the same
traffic timed untraced.  The traced chunks' own wall is not the base:
the profiler stretches a graph replay's gaps (more than 2x on the
cylinder's chunk of 100 steps), not its kernels."""


def read(run):
    if (run.trace is None or not run.trace.device or run.trace_steps == 0
            or run.step_s <= 0):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace_steps / run.step_s)
