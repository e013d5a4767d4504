"""The window's chunks in which a capped loop overflowed, so that the
chunk's steps reran through the host driver and the step was captured
again (the solver's own counter, ``chunk_overflows``)."""


def read(run):
    return run.window_overflows
