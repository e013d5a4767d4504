"""Seconds of the run's first ``chunk.capture`` span, in set-up: the
warm-up step through the host driver, the capture of the step as a CUDA
graph and its instantiation, less the kernel libraries built or loaded
inside it (their ``kernels.<name>`` spans: nvcc runs on a checkout's
first run only).  Read from the solver's span store, ``solver.timers``,
whose aggregates are kept under each span's path."""

PATH = "chunk/chunk.capture"


def read(run):
    solver = run.solver
    first = getattr(solver.timers, "first", None)
    if solver.device.type != "cuda" or not first or PATH not in first:
        return None
    builds = sum(v for key, v in solver.timers.total.items()
                 if key.startswith(PATH + "/")
                 and key.rsplit("/", 1)[-1].startswith("kernels."))
    return first[PATH] - builds
