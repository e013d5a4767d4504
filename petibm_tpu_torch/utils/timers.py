"""Stage timers replacing PETSc log stages.

Copy of ``petibm_tpu/utils/timers.py``.

The reference registers a log stage per solver phase (initialize,
rhsVelocity, solveVelocity, rhsPoisson, solvePoisson, update, write,
monitor; navierstokes.cpp:99-199) and dumps -log_view to logs/<ite>.log at
every save (io.cpp:274).  Under jit the whole step is one XLA computation,
so the native breakdown is per-stage wall time at the Python orchestration
level plus optional jax profiler traces.
"""

from __future__ import annotations

import contextlib
import time


class StageTimers:
    def __init__(self):
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] = self.total.get(name, 0.0) + dt
            self.count[name] = self.count.get(name, 0) + 1

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("stage\tcalls\ttotal_s\tavg_s\n")
            for name, tot in sorted(self.total.items()):
                c = self.count[name]
                fh.write(f"{name}\t{c}\t{tot:.6f}\t{tot / max(c, 1):.6f}\n")

    def report(self) -> str:
        return "; ".join(
            f"{k}: {v:.3f}s/{self.count[k]}" for k, v in sorted(self.total.items()))
