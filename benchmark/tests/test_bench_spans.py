"""``benchmark/spans.py`` on the CPU cuts: the span run reads the
solver's store (the stamps' twins on the host clock), the parts of each
chunk's period add up to it, and the readers of the new metrics find
nothing off the card."""

from __future__ import annotations

import os

import numpy as np
import pytest

from benchmark import harness, spans
from conftest import load


def _solver(root, cell, tmp_path):
    from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver

    c = harness.Cell(root, harness.load_spec(root), cell)
    solver = DecoupledIBPMSolver(c.solver_config(str(tmp_path)),
                                 device="cpu")
    solver.nt += c.k
    solver.run()
    return c, solver


def _budget(run, c):
    """Chunk ``c``'s period split into its parts, and the period, in
    ms."""
    t = run.stamps[c]
    parts = {p: run.phase_ms(p).reshape(run.stamps.shape[:2])[c].sum()
             for p in run.phases}
    parts["tail"] = np.sum(t[:, -1] - t[:, -2]) / 1e6
    parts["replay_gaps"] = np.sum(t[1:, 0] - t[:-1, -1]) / 1e6
    parts["turnaround"] = run.turnarounds_ms()[c]
    return parts, (run.stamps[c + 1, 0, 0] - t[0, 0]) / 1e6


@pytest.mark.parametrize("cell", ["small2d.fdm_k4", "small2d.mgcg_k2"])
def test_span_run_reads_the_store(small_root, cell, tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "MIN_CHUNKS", 3)
    monkeypatch.setattr(spans, "MIN_SECONDS", 0.0)
    c, solver = _solver(small_root, cell, tmp_path)
    n_stats = len(solver.stats_history)
    run = spans.collect(solver, c.k)
    assert not solver.timers.tracing and solver._chunk.traced is None
    assert run.stamps.shape[:2] == (3, c.k)
    assert run.phases[0] == "moveIB" and run.phases[-1] == "update"
    assert len(run.names) == 11
    assert (np.diff(run.stamps, axis=2) >= 0).all()
    assert run.pairs() == [0, 1]
    # a chunk's period on the stamps: its phases, its tails (write-back
    # and stats row), its replay gaps and the turnaround, nothing left
    for c_ in run.pairs():
        parts, period = _budget(run, c_)
        assert sum(parts.values()) == pytest.approx(period, rel=1e-12)
    assert (run.turnarounds_ms() > 0).all()
    assert run.replay_gaps_us().shape == (3 * (c.k - 1),)
    for name in ("solveVelocity", "solveForces", "solvePoisson"):
        assert run.phase_median_ms(name) > 0
    assert run.operators_ms() > 0
    # the CPU's stamps are the host clock: the periods agree with the
    # ``chunk`` spans' but for the jitter between a chunk span's start
    # and its first step's
    assert len(run.chunk_spans) == 3
    periods = np.diff(run.stamps[:, 0, 0])
    host = np.diff([s.t0 for s in run.chunk_spans]).astype(float)
    assert abs(periods.sum() - host.sum()) < 0.05 * host.sum()
    # the V-cycles the stamps count: CG's iterations and its first
    # preconditioning a step
    rows = np.concatenate([b.values() for b in solver.timers.stamp_blocks()])
    stats = solver.stats_history[n_stats:]
    if "mgcg" in cell:
        assert rows[:, 13].sum() == sum(s["p_iters"] + 1 for s in stats)
        assert (rows[:, 12] > 0).all()
    else:
        assert rows[:, 12:].sum() == 0
    assert run.allocs_per_chunk() is None  # counted on the card only
    solver.close()


def test_new_readers_find_nothing_off_the_card(small_root, tmp_path):
    c, solver = _solver(small_root, "small2d.mgcg_k2", tmp_path)
    run = harness.Run(c, solver, solver.stats_history, 1.0, 0, None, [], 0)
    spec = load(os.path.join(small_root, "BENCHMARK.json"))
    names = [m["name"] for m in spec["per_layer"]
             if m["source"] == "program_span"
             or m["name"] == "device_allocs_per_chunk"]
    assert len(names) == 8
    for name in names:
        assert harness._read_metric(c, name, run) is None
    assert not hasattr(run, "_spans") or run._spans is None
    solver.close()
