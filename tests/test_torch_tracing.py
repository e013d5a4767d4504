"""The port's spans, counters and device stamps (``utils/timers.py``,
``utils/stamps.py``, ``solver.trace_spans``).

On the CPU, on the 32^2 cylinder chunked by 4 (the FDM path and MG-CG):
with tracing off a chunk holds no stamp buffer and, without an active
profiler, enters no ``record_function``; with tracing on the states and
stats equal those of tracing off bit for bit; a traced step holds 11
stamps in phase order, non-decreasing; the V-cycles counted equal the
stats' (CG's iterations and its first preconditioning a step, in masked
copies too); on the 32^2 cylinder with BiCGStab velocity and on the 16^3
Taylor-Green vortex the ``krylov.velocity`` region counts the stats'
velocity iterations (masked copies too) and ``convection`` once a step,
inside rhsVelocity's span, and tracing on equals tracing off on the TGV
too; spans nest by parent id; an overflowing chunk records
``chunk.rerun``; ``report()`` and ``dump()`` list the spans and
counters; a kernel library's load is a span with its build counters.

Card tests (``cuda``; skipped without a card, and importing no JAX): the
stamped graph's states equal the plain graph's at tolerance 0, the plain
graph stays the one captured before tracing (its node count a
never-traced solver's); eager steps with tracing on hold 11 stamps in
order and equal untraced steps at tolerance 0; and the clock's
calibration.
"""

import numpy as np
import pytest
import torch

from petibm_tpu_torch import _kernels
from petibm_tpu_torch.solvers import chunk
from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver
from petibm_tpu_torch.utils import stamps, timers
from test_torch_chunked import cylinder, leaves, tgv3d

torch.set_num_threads(2)

PHASES = ["moveIB", "rhsVelocity", "solveVelocity", "rhsForces",
          "solveForces", "applyNoSlip", "rhsPoisson", "solvePoisson",
          "update"]
CASES = {"fdm": {}, "mgcg": {"fdm": False}}
#: the traced step's stamp columns: start, the nine phases, end, then
#: three columns (open, ns, count) for each region
STAMPS = 11 + 3 * len(stamps.REGIONS)
#: the 32^2 cylinder's velocity solve by BiCGStab + Jacobi
BICGSTAB = {"type": "CPU", "max_it": 100, "kspType": "bicgstab"}


def _solver(tmp_path, name, case, device="cpu", **params):
    if case == "tgv3d":
        cfg = tgv3d(tmp_path, name, dtype="float32", nt=4, nsave=1000,
                    nrestart=1000, stepsPerDispatch=4, **params)
        return NavierStokesSolver(cfg, device=device)
    cfg = cylinder(tmp_path, name, dtype="float32", nt=4, nsave=1000,
                   nrestart=1000, stepsPerDispatch=4,
                   **dict(CASES[case], **params))
    return DecoupledIBPMSolver(cfg, device=device)


def _chunks(solver, n):
    """``n`` more chunks of 4 steps."""
    solver.nt = solver.ite - solver.nstart + 4 * n
    solver.run()


def _count_record_function(monkeypatch):
    """Count the record functions the spans enter (``utils/timers.py``
    opens a function-scope one; a user annotation would be counted
    too)."""
    calls = []
    fast = torch._C._profiler._RecordFunctionFast
    user = torch.profiler.record_function

    def counting(real):
        def enter(name, *args):
            calls.append(name)
            return real(name, *args)
        return enter

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(fast))
    monkeypatch.setattr(torch.profiler, "record_function", counting(user))
    return calls


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_no_profiler_no_record_function(on, tmp_path, monkeypatch):
    calls = _count_record_function(monkeypatch)
    solver = _solver(tmp_path, "run", "fdm")
    solver.trace_spans(on)
    _chunks(solver, 2)
    assert calls == []
    runner = solver._chunk
    width = runner.layout.width + len(runner.sites)
    assert runner.rows.shape == (4, width)
    if on:
        assert runner.traced.rows.shape == (4, width + STAMPS)
        assert len(solver.timers.spans()) > 0
    else:
        assert runner.traced is None
        assert solver.timers.spans() == []
        assert solver.timers.stamp_blocks() == []
    solver.close()


def test_profiler_holds_the_spans(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    solver = _solver(tmp_path, "run", "fdm")
    _chunks(solver, 1)
    calls = _count_record_function(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _chunks(solver, 1)
    events = prof.profiler.kineto_results.events()
    spans = {"chunk", "chunk.copy_in", "chunk.replay", "chunk.read",
             "chunk.unpack", "write"}
    assert spans <= {e.name() for e in events}
    # host events, none a user annotation the profiler would lay over the
    # card's timeline
    assert not any(e.is_user_annotation() for e in events
                   if e.name() in spans)
    assert calls.count("chunk") == 1
    solver.close()


@pytest.mark.parametrize("case", sorted(CASES) + ["tgv3d"])
def test_traced_chunks_equal_plain(case, tmp_path):
    """Chunks with tracing on between chunks with it off: states and stats
    bit-equal to a run never traced."""
    plain = _solver(tmp_path, "plain", case)
    _chunks(plain, 3)
    traced = _solver(tmp_path, "traced", case)
    _chunks(traced, 1)
    traced.trace_spans(True)
    _chunks(traced, 1)
    traced.trace_spans(False)
    _chunks(traced, 1)
    a, b = leaves(plain.state), leaves(traced.state)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert plain.stats_history == traced.stats_history
    assert len(traced.timers.stamp_blocks()) == 1
    plain.close()
    traced.close()


@pytest.mark.parametrize("case", sorted(CASES))
def test_stamps_in_phase_order(case, tmp_path):
    solver = _solver(tmp_path, "run", case)
    solver.trace_spans(True)
    _chunks(solver, 2)
    solver.advance()            # an eager step: a one-row block
    blocks = solver.timers.stamp_blocks()
    assert [len(b.values()) for b in blocks] == [4, 4, 1]
    assert [b.ite0 for b in blocks] == [1, 5, 9]
    for b in blocks:
        assert b.names == ["start", *PHASES, "end"]
        t = b.values()[:, :11]
        assert t.shape[1] == 11
        assert (np.diff(t, axis=1) >= 0).all()
        assert (t.ravel()[1:] >= t.ravel()[:-1]).all()
    # the chunks follow each other on the clock
    assert blocks[1].values()[0, 0] > blocks[0].values()[-1, 10]
    solver.close()


@pytest.mark.parametrize("masked", [False, True], ids=["if", "masked"])
def test_vcycle_count_matches_stats(masked, tmp_path, monkeypatch):
    """CG preconditions once before its loop and once an iteration: the
    V-cycles a step are p_iters + 1.  With every copy run masked (the
    decomposed card's design) only the kept copies count."""
    if masked:
        monkeypatch.setattr(chunk, "masks_loops", lambda solver: True)
    solver = _solver(tmp_path, "run", "mgcg")
    solver.trace_spans(True)
    _chunks(solver, 2)
    blocks = solver.timers.stamp_blocks()
    counts = np.concatenate([b.values()[:, 13] for b in blocks])
    hist = solver.stats_history
    assert counts.tolist() == [h["p_iters"] + 1 for h in hist]
    assert (np.concatenate([b.values()[:, 12] for b in blocks]) > 0).all()
    solver.close()
    fdm = _solver(tmp_path, "fdm", "fdm")
    fdm.trace_spans(True)
    _chunks(fdm, 1)
    assert fdm.timers.stamp_blocks()[0].values()[:, 12:14].sum() == 0
    fdm.close()


@pytest.mark.parametrize("masked", [False, True], ids=["if", "masked"])
@pytest.mark.parametrize("case", ["cylinder", "tgv3d"])
def test_krylov_velocity_count_matches_stats(case, masked, tmp_path,
                                             monkeypatch):
    """The velocity solve's BiCGStab iterations a step are its stats'
    v_iters, each with its device time; with every copy run masked only
    the kept copies count.  The convective term is one region a step,
    inside rhsVelocity's span; the V-cycle columns stay those of the
    V-cycle (none: the pressure solve is the FDM's)."""
    _check_krylov_velocity(case, masked, tmp_path, monkeypatch, "cpu")


def _check_krylov_velocity(case, masked, tmp_path, monkeypatch, device):
    if masked:
        monkeypatch.setattr(chunk, "masks_loops", lambda solver: True)
    solver = (_solver(tmp_path, "run", "tgv3d", device=device)
              if case == "tgv3d" else
              _solver(tmp_path, "run", "fdm", device=device,
                      velocitySolver=BICGSTAB, fdm={"velocity": False}))
    solver.trace_spans(True)
    _chunks(solver, 2)
    blocks = solver.timers.stamp_blocks()
    assert len(blocks) == 2
    ns, counts = (np.concatenate(a) for a in zip(
        *[b.region("krylov.velocity") for b in blocks]))
    hist = solver.stats_history
    assert len(hist) == 8
    assert counts.tolist() == [h["v_iters"] for h in hist]
    assert counts.sum() > 0
    assert (ns[counts > 0] > 0).all() and (ns[counts == 0] == 0).all()
    conv_ns, conv_counts = (np.concatenate(a) for a in zip(
        *[b.region("convection") for b in blocks]))
    assert conv_counts.tolist() == [1.0] * 8
    for b in blocks:
        t = b.values()
        phase = b.names.index("rhsVelocity")
        opened = t[:, b.regions["convection"]]
        assert (t[:, phase - 1] <= opened).all()
        assert (opened + b.region("convection")[0] <= t[:, phase]).all()
        assert sum(a.sum() for a in b.region("vcycle")) == 0
        assert b.region("nothing") is None
    solver.close()


def test_spans_nest_by_parent(tmp_path):
    solver = _solver(tmp_path, "run", "fdm")
    solver.trace_spans(True)
    _chunks(solver, 2)
    recs = solver.timers.spans()
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs)
    roots = [r for r in recs if r.parent == 0]
    assert ([r.name for r in roots]
            == ["chunk", "write", "chunk", "write", "integrateForces"])
    first = roots[0]
    kids = [r.name for r in recs if r.parent == first.id]
    assert kids == ["chunk.capture", "chunk.copy_in", "chunk.replay",
                    "chunk.read", "chunk.unpack"]
    cap = next(r for r in recs if r.name == "chunk.capture")
    assert [r.name for r in recs if r.parent == cap.id] == ["warmup"]
    for r in recs:
        assert r.t0 <= r.t1
        if r.parent:
            p = by_id[r.parent]
            assert p.t0 <= r.t0 and r.t1 <= p.t1
    second = roots[2]
    assert ([r.name for r in recs if r.parent == second.id]
            == ["chunk.copy_in", "chunk.replay", "chunk.read",
                "chunk.unpack"])
    # aggregates by path, the first call's time kept
    t = solver.timers
    assert t.count["chunk"] == 2 and t.count["chunk/chunk.capture"] == 1
    assert t.first["chunk/chunk.capture"] == t.total["chunk/chunk.capture"]
    assert {"initialize/solvers", "initialize/forces.invert"} <= set(t.count)
    solver.close()


def test_overflow_records_rerun(tmp_path, monkeypatch):
    real = chunk.ChunkRunner.prepare

    def prepare(self):
        real(self)
        self.caps = [1 if s.kind == "cond" else 1 for s in self.sites]
        self.capture()

    monkeypatch.setattr(chunk.ChunkRunner, "prepare", prepare)
    solver = _solver(tmp_path, "run", "mgcg")
    solver.trace_spans(True)
    _chunks(solver, 1)
    assert solver.chunk_overflows == 1
    recs = solver.timers.spans()
    rerun = next(r for r in recs if r.name == "chunk.rerun")
    assert by_name(recs, rerun.parent) == "chunk"
    assert ([r.name for r in recs if r.parent == rerun.id]
            == ["step"] * 4 + ["chunk.capture"])
    # the rerun's eager steps carry their stamps; the thrown-away chunk
    # none
    assert [len(b.values()) for b in solver.timers.stamp_blocks()] == [1] * 4
    assert solver.timers.count["chunk/chunk.rerun/step"] == 4
    solver.close()


def by_name(recs, span_id):
    return next(r.name for r in recs if r.id == span_id)


def test_report_and_dump_list_spans(tmp_path):
    solver = _solver(tmp_path, "run", "fdm")
    solver.trace_spans(True)
    _chunks(solver, 1)
    solver.timers.add("device_allocs", 3)
    report = solver.timers.report()
    path = tmp_path / "stages.log"
    solver.timers.dump(str(path))
    text = path.read_text()
    for name in ("initialize", "chunk", "chunk/chunk.capture/warmup",
                 "chunk/chunk.replay", "chunk/chunk.read", "write",
                 "trace_spans/calibrate"):
        assert f"{name}: " in report
        assert f"\n{name}\t" in text
    assert "device_allocs: 3" in report
    assert "counter\ttotal\ndevice_allocs\t3\n" in text
    solver.close()


def test_kernel_library_is_a_span(monkeypatch, tmp_path):
    """A library's build and load: a span ``kernels.<name>`` under the
    span open around it, ``kernels.builds`` and ``kernels.build_s``."""
    monkeypatch.setattr(_kernels, "build",
                        lambda name: (tmp_path / f"{name}.so", 1.5))
    monkeypatch.setattr(_kernels.ctypes, "CDLL", lambda path: object())
    monkeypatch.delitem(_kernels._LIBS, "fake", raising=False)
    store = timers.StageTimers()
    store.start_tracing(stamps.Clock.calibrate("cpu"))
    with store.stage("initialize"):
        _kernels.library("fake")
        _kernels.library("fake")   # loaded: no second span
    _kernels._LIBS.pop("fake")
    recs = store.spans()
    assert [r.name for r in recs] == ["initialize", "kernels.fake"]
    assert recs[1].parent == recs[0].id
    assert recs[1].counts == {"kernels.builds": 1, "kernels.build_s": 1.5}
    assert store.counters == {"kernels.builds": 1, "kernels.build_s": 1.5}
    assert store.count["initialize/kernels.fake"] == 1
    # outside any span the module-level helpers record nothing
    with timers.span("x"):
        timers.add("y", 1)
    assert "x" not in store.count and "y" not in store.counters


# ----------------------------------------------------------------------
# on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_stamped_graph_equals_plain(case, tmp_path):
    """The stamped graph's chunks against a never-traced solver's plain
    graph: every state tensor and stat equal; the plain graph and its
    nodes stay those captured before tracing."""
    _card()
    plain = _solver(tmp_path, "plain", case, device="cuda")
    _chunks(plain, 3)
    traced = _solver(tmp_path, "traced", case, device="cuda")
    _chunks(traced, 1)
    runner = traced._chunk
    graph, nodes = runner.graph, runner.info["nodes"]
    assert nodes == plain._chunk.info["nodes"]
    traced.trace_spans(True)
    assert runner.traced.info["top_nodes"] > runner.info["top_nodes"]
    _chunks(traced, 1)
    traced.trace_spans(False)
    assert runner.graph is graph and runner.traced is None
    assert runner.info["nodes"] == nodes
    _chunks(traced, 1)
    a, b = leaves(plain.state), leaves(traced.state)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert plain.stats_history == traced.stats_history
    t = traced.timers.stamp_blocks()[0].values()
    assert (np.diff(t[:, :11], axis=1) >= 0).all()
    if case == "mgcg":
        hist = traced.stats_history[4:8]
        assert t[:, 13].tolist() == [h["p_iters"] + 1 for h in hist]
    plain.close()
    traced.close()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_eager_traced_steps_equal_plain(case, tmp_path):
    """``advance()`` with tracing on: each step a one-row block of 11
    stamps, non-decreasing, and the states and stats equal an untraced
    solver's steps at tolerance 0."""
    _card()
    plain = _solver(tmp_path, "plain", case, device="cuda")
    traced = _solver(tmp_path, "traced", case, device="cuda")
    traced.trace_spans(True)
    for solver in (plain, traced):
        for _ in range(3):
            solver.advance()
    traced.trace_spans(False)
    a, b = leaves(plain.state), leaves(traced.state)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert plain.stats_history == traced.stats_history
    blocks = traced.timers.stamp_blocks()
    assert [b.ite0 for b in blocks] == [1, 2, 3]
    rows = np.concatenate([b.values() for b in blocks])
    assert rows.shape == (3, STAMPS)
    t = rows[:, :11]
    assert (np.diff(t, axis=1) >= 0).all() and (t[:, -1] > t[:, 0]).all()
    assert (t.ravel()[1:] >= t.ravel()[:-1]).all()
    if case == "mgcg":
        hist = traced.stats_history
        assert rows[:, 13].tolist() == [h["p_iters"] + 1 for h in hist]
    plain.close()
    traced.close()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["if", "masked"])
@pytest.mark.parametrize("case", ["cylinder", "tgv3d"])
def test_cuda_krylov_velocity_count_matches_stats(case, masked, tmp_path,
                                                  monkeypatch):
    """``test_krylov_velocity_count_matches_stats`` on the card: the
    region and step stamps are the captured chunk's device kernels, held
    to the stats' v_iters with the loops run as conditional nodes or
    masked."""
    _card()
    _check_krylov_velocity(case, masked, tmp_path, monkeypatch, "cuda")


@pytest.mark.cuda
def test_cuda_clock_calibration():
    """The card's clock put on the host's: a stamp taken between two host
    readings lands between them, within the calibration's window; the
    clock steps by a microsecond or less."""
    _card()
    import time

    clock = stamps.Clock.calibrate("cuda")
    assert 0 < clock.window_ns < 1_000_000
    assert 0 < clock.steps_ns[0] <= clock.steps_ns[1] <= 2_000
    layout = stamps.Layout(["a"])
    for _ in range(5):
        st = stamps.Stamps.one_row(layout, clock, "cuda")
        torch.cuda.synchronize()
        h0 = time.perf_counter_ns()
        st.stamp(0)
        torch.cuda.synchronize()
        h1 = time.perf_counter_ns()
        at = float(clock.host_ns(st.rows[0, 0].item()))
        slack = clock.window_ns + clock.steps_ns[1]
        assert h0 - slack <= at <= h1 + slack
