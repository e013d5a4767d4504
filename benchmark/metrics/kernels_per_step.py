"""Device kernels a step in the traced chunks (copies and sets left
out)."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace_steps == 0:
        return None
    return run.trace.kernels / run.trace_steps
