"""Buffered per-step forces log shared by the IBM solvers.

Counterpart of ``petibm_tpu/solvers/_forceslog.py``.  forces-<start>.txt
holds t, then the integrated force components of each body (reference:
decoupledibpm.cpp:420-453).  The forces ride along in the step stats
(key "f", a device tensor) and are copied to the host in one batch at save
points and at the end of the run.
"""

from __future__ import annotations

import os

import torch


class ForcesLogMixin:
    """Requires: step stats contain "f"; self.bodies is a BodyPack."""

    _forces_log = None

    def _record_stats(self, ite0: int, stats: dict, count: int) -> None:
        super()._record_stats(ite0, stats, count)
        if self._forces_log is None:
            self._forces_log = open(os.path.join(
                self.output_dir, f"forces-{self.nstart}.txt"), "w")
            self._forces_buffer = []
        t0 = self.t - (count - 1) * self.dt  # t of the chunk's first step
        self._forces_buffer.append((t0, stats["f"], count))

    def write(self) -> None:
        super().write()
        self.write_forces_ascii()

    def write_forces_ascii(self) -> None:
        if self.ite % self.nsave == 0 or self.finished():
            self._flush_forces()

    def _flush_forces(self) -> None:
        if not getattr(self, "_forces_buffer", None):
            return
        with self.timers.stage("integrateForces"):
            single = [f for _, f, count in self._forces_buffer if count == 1]
            single = iter(torch.stack(single).cpu().numpy() if single
                          else [])
        items, self._forces_buffer = self._forces_buffer, []
        for t0, fs, count in items:
            for j in range(count):
                # JAX _forceslog.py: the chunk's times from its first
                t = t0 + j * self.dt
                f = next(single) if count == 1 else fs[j]
                cols = [f"{t:10.8e}"]
                for body_force in self.bodies.avg_forces(f):
                    cols.extend(f"{v:10.8e}" for v in body_force)
                self._forces_log.write("\t".join(cols) + "\n")
        self._forces_log.flush()

    def close(self) -> None:
        self._flush_forces()
        super().close()
        if self._forces_log and not self._forces_log.closed:
            self._forces_log.close()
