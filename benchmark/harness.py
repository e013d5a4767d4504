"""One run of one cell: set-up, the measured window, the traced chunks,
the per-layer readers, and the check of the window's output against the
plain reference.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, whose file holds the case, and a traffic mix, found by
name in ``<benchmark>/traffic/<traffic>.json``, which says how the
solves run (solver options, steps a chunk) and how many chunks spin up,
fill a window and are traced.  Its correctness limits are in
``<benchmark>/limits/<cell>.json`` and each per-layer metric's reader in
``<benchmark>/metrics/<metric>.py``.

The configuration file names the rest:

- ``solver``: the port's solver class, one of ``SOLVERS``;
- ``reference``: ``"<module>.<Class>"`` under ``reference/``
  (``ibpm.DecoupledIBPM`` where the key is absent);
- ``body``: one stationary body's points file, or ``bodies``: the
  solver's list as written, each ``file`` beside the configuration
  (a moving body's ``kinematics`` with it), or neither: no body;
- ``flow.initialVelocity`` and ``flow.initialPressure``: numbers or
  expressions in x, y, z, t, nu (``inputs.py``).

A reference class keeps this interface (``reference/__init__.py``):
``Class(config, body, *, device, precision="float64"|"tf32")``, ``body``
the ``body`` file's points or None; ``dim`` and ``lines[c][d].coord``,
the coordinates of component c's points along direction d with a ghost
at each end; ``initial_state(fields)`` (numpy leaves with the layout of
the port's state for that solver, from velocity fields and ``p`` where
given), ``load(host_state)`` and ``advance(state, k)``, whose state holds
``q`` and ``p`` (and ``f`` with bodies) as tensors.

The window drives the port solver's ``run()`` chunk after chunk
(``stepsPerDispatch`` steps a chunk, one host read each), timed by the
host clock with the card synchronised at both ends.  Three chunks'
outputs are then checked against the reference worked out in float64 on
the card: the first chunk of the run and, once the window has closed,
one more replay of the window's captured step from the same seeded
start, both against the reference from that start; and a window chunk
drawn from the seed, from the solver's own state before it (the
reference cannot follow a whole run of thousands of steps: the flow
amplifies any rounding).  The fields compared are those both states
hold; each needs its ``<field>_gap`` limit.
"""

from __future__ import annotations

import copy
import gc
import importlib
import json
import os
import re
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

from . import inputs

#: top-level module names a run may not hold once its window has closed:
#: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "petibm_tpu")
#: the fields the check compares where both states hold them, each as its
#: largest gap to the reference over the checked chunks, relative to the
#: reference's largest magnitude
CHECKED = ("u", "v", "w", "p", "f")
#: a configuration's ``solver``: the port's module and class
SOLVERS = {
    "decoupledibpm": ("decoupledibpm", "DecoupledIBPMSolver"),
    "ibpm": ("ibpm", "IBPMSolver"),
    "rigidkinematics": ("rigidkinematics", "RigidKinematicsSolver"),
    "navierstokes": ("navierstokes", "NavierStokesSolver"),
}
#: the reference where a configuration names none
DEFAULT_REFERENCE = "ibpm.DecoupledIBPM"
_REFERENCE = re.compile(r"^([A-Za-z_]\w*)\.([A-Za-z_]\w*)$", re.ASCII)


class CellError(RuntimeError):
    """The cell cannot run here (no card, a missing file, a JAX import)."""


# ----------------------------------------------------------------------
# the files of a cell, found by name
def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def bench_dir(root: str, spec: dict) -> str:
    return os.path.join(root, spec["paths"][0])


def _json(path: str) -> dict:
    if not os.path.isfile(path):
        raise CellError(f"missing file {path}")
    with open(path) as fh:
        return json.load(fh)


def deep_merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for key, val in over.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = deep_merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


class Cell:
    """A workload entry with its configuration, traffic and limits."""

    def __init__(self, root: str, spec: dict, name: str):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise CellError(f"no workload {name!r}; the cells: "
                            + ", ".join(by_name))
        self.entry = by_name[name]
        self.name = name
        conf = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config_path = os.path.join(root, conf["file"])
        self.case = _json(self.config_path)
        base = bench_dir(root, spec)
        self.traffic = _json(os.path.join(base, "traffic",
                                          self.entry["traffic"] + ".json"))
        self.limits = _json(os.path.join(base, "limits", name + ".json"))
        self.chips = int(self.entry["chips"])
        self.k = int(self.traffic["parameters"]["stepsPerDispatch"])
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]
        self.metrics_dir = os.path.join(base, "metrics")

    def _beside(self, name: str) -> str:
        return os.path.join(os.path.dirname(self.config_path), name)

    def body(self) -> tuple:
        """The ``body`` file's path and its points; (None, None) where the
        configuration has no ``body``."""
        if "body" not in self.case:
            return None, None
        path = self._beside(self.case["body"])
        if not os.path.isfile(path):
            raise CellError(f"missing file {path}")
        with open(path) as fh:
            n = int(fh.readline())
            pts = np.loadtxt(fh, ndmin=2)
        if len(pts) != n:
            raise CellError(f"{path}: {len(pts)} points, its header says {n}")
        return path, pts

    def bodies(self) -> list | None:
        """The solver's ``bodies``: one stationary points body from
        ``body``; ``bodies`` as written, each ``file`` beside the
        configuration; None for neither."""
        if "body" in self.case and "bodies" in self.case:
            raise CellError(f"{self.config_path}: both body and bodies")
        if "body" in self.case:
            return [{"type": "points", "file": self.body()[0]}]
        if "bodies" not in self.case:
            return None
        out = copy.deepcopy(self.case["bodies"])
        for b in out:
            if "file" in b:
                b["file"] = self._beside(b["file"])
                if not os.path.isfile(b["file"]):
                    raise CellError(f"missing file {b['file']}")
        return out

    def solver_class(self):
        """The port's solver class the configuration's ``solver`` names,
        imported here."""
        name = self.case.get("solver")
        if name not in SOLVERS:
            raise CellError(f"{self.config_path}: solver {name!r}; one of "
                            + ", ".join(SOLVERS))
        module, cls = SOLVERS[name]
        mod = importlib.import_module(f"petibm_tpu_torch.solvers.{module}")
        return getattr(mod, cls)

    def reference_class(self):
        """The reference class the configuration's ``reference`` names
        (``<module>.<Class>`` under ``reference/``)."""
        return resolve_reference(self.case.get("reference",
                                               DEFAULT_REFERENCE))

    def solver_config(self, workdir: str) -> dict:
        """The solver's configuration: the case with the traffic's solver
        options over it, the run's output under ``workdir``, no snapshot
        or restart within the run."""
        cfg = {k: copy.deepcopy(self.case[k])
               for k in ("mesh", "flow", "parameters")}
        cfg = deep_merge(cfg, {"parameters": self.traffic["parameters"]})
        cfg["parameters"].update(nt=0, nsave=10 ** 9, nrestart=10 ** 9)
        bodies = self.bodies()
        if bodies is not None:
            cfg["bodies"] = bodies
        cfg.update(directory=workdir, output=os.path.join(workdir, "output"),
                   logs=os.path.join(workdir, "logs"))
        return cfg


def resolve_reference(name: str):
    """``"<module>.<Class>"``: the class in ``reference/<module>.py``."""
    m = _REFERENCE.match(str(name))
    if m is None:
        raise CellError(f"reference {name!r}: write <module>.<Class>")
    try:
        mod = importlib.import_module(f"{__package__}.reference.{m[1]}")
    except ModuleNotFoundError as exc:
        raise CellError(f"reference {name!r}: no module reference/"
                        f"{m[1]}.py ({exc})") from None
    if not isinstance(getattr(mod, m[2], None), type):
        raise CellError(f"reference {name!r}: reference/{m[1]}.py has no "
                        f"class {m[2]}")
    return getattr(mod, m[2])


# ----------------------------------------------------------------------
def _same_layout(a, b, where: str = "state") -> None:
    """Raise unless two state trees have the same keys and shapes."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise CellError(f"{where}: keys {sorted(a)} against "
                            f"{sorted(b) if isinstance(b, dict) else b}")
        for k in a:
            _same_layout(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise CellError(f"{where}: {len(a)} entries against {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_layout(x, y, f"{where}[{i}]")
    elif tuple(np.shape(a)) != tuple(np.shape(b)):
        raise CellError(f"{where}: shape {np.shape(a)} against {np.shape(b)}")


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def gaps(out: dict, ref: dict) -> dict:
    """Each field both states hold: its largest gap between a program
    state and the reference's, over the reference's largest
    magnitude."""
    res = {}
    for key in CHECKED:
        a, b = ((out.get(key), ref.get(key)) if key in ("p", "f")
                else (out["q"].get(key), ref["q"].get(key)))
        if a is None or b is None:
            continue
        b = np.asarray(b, np.float64)
        scale = float(np.abs(b).max())
        res[key] = float(np.abs(np.asarray(a, np.float64) - b).max()
                         / (scale if scale > 0 else 1.0))
    return res


def _to_host(state) -> dict:
    from petibm_tpu_torch.convert import state_to_numpy

    return state_to_numpy(state)


def _reference_numpy(st: dict) -> dict:
    out = {"q": {k: v.double().cpu().numpy() for k, v in st["q"].items()}}
    for key in ("p", "f"):
        if key in st:
            out[key] = st[key].double().cpu().numpy()
    return out


def _read_metric(cell: Cell, name: str, run) -> float | None:
    import importlib.util

    path = os.path.join(cell.metrics_dir, name + ".py")
    if not os.path.isfile(path):
        raise CellError(f"metric {name}: no reader {path}")
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(run)
    return None if value is None else float(value)


class Run:
    """What a per-layer reader reads (``metrics/<name>.py``: ``read(run)``,
    returning a number, or None where it finds nothing to read)."""

    def __init__(self, cell: Cell, solver, stats: list, step_s: float,
                 window_overflows: int, trace, trace_stats,
                 trace_steps: int):
        self.cell = cell
        self.solver = solver
        #: the window's steps' solver stats (host values)
        self.stats = stats
        #: the window's wall seconds a step: its median chunk over its
        #: steps
        self.step_s = step_s
        #: the window's chunks whose capped loops overflowed and reran
        self.window_overflows = window_overflows
        #: the traced chunks (``timing.Trace``), their steps and stats
        self.trace = trace
        self.trace_steps = trace_steps
        self.trace_stats = trace_stats


# ----------------------------------------------------------------------
def start_state(cell: Cell, cfg: dict, body, seed: int) -> dict:
    """The seeded start (numpy leaves), made by the reference on the
    host from the case's initial fields and the seed's bumps."""
    grid = cell.reference_class()(cfg, body, device="cpu")
    try:
        fields = inputs.initial_fields(grid, cell.case, seed)
    except inputs.ExpressionError as exc:
        raise CellError(f"{cell.config_path}: {exc}") from None
    return grid.initial_state(fields)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             *, t_start: float, device: str = "cuda", fault=None,
             control: bool = False) -> dict:
    """One run; returns the result dict (the last line's keys) with the
    checks last.  ``device="cpu"`` and ``fault`` serve the tests: the
    same run on the CPU, with the step broken by ``fault(step_fn)``.
    ``control``: also the control's gaps (``calibrate.py``)."""
    import torch

    spec = load_spec(root)
    cell = Cell(root, spec, name)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise CellError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise CellError(f"{cell.chips} cards wanted, "
                            f"{torch.cuda.device_count()} present")
    from petibm_tpu_torch.convert import state_from_numpy

    Solver = cell.solver_class()
    workdir = tempfile.mkdtemp(prefix="petibm-bench-")
    try:
        return _run(cell, seed, seconds, trace, t_start, device, fault,
                    control, workdir, Solver, state_from_numpy)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cell, seed, seconds, trace, t_start, device, fault, control,
         workdir, Solver, state_from_numpy):
    import torch

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    clock = [("imports", time.perf_counter())]
    cfg = cell.solver_config(workdir)
    _, body = cell.body()
    start = start_state(cell, cfg, body, seed)
    clock.append(("inputs", time.perf_counter()))
    solver = Solver(cfg, device=device)
    sync()
    clock.append(("solver", time.perf_counter()))
    _same_layout(_to_host(solver.state), start)
    missing = [f"{key}_gap" for key in CHECKED
               if (key in start or key in start["q"])
               and f"{key}_gap" not in cell.limits]
    if missing:
        raise CellError(f"{cell.name}: compared with no limit: "
                        + ", ".join(missing))
    solver.state = state_from_numpy(start, solver.device, solver.dtype)
    ite0, t0 = solver.ite, solver.t
    if fault is not None:
        solver._step_fn = fault(solver._step_fn)
    k, traffic = cell.k, cell.traffic

    def chunk():
        solver.nt += k
        solver.run()

    # set-up: the spin-up chunks capture the step and meet its first
    # overflows; the first chunk's output is checked
    chunk()
    sync()
    clock.append(("chunk 0", time.perf_counter()))
    first_out = solver.state
    for _ in range(int(traffic["spinup_chunks"]) - 1):
        chunk()
    sync()
    clock.append(("later spin-up chunks", time.perf_counter()))
    overflows0 = solver.chunk_overflows
    n_stats0 = len(solver.stats_history)
    setup_s = time.perf_counter() - t_start

    # the window
    sample = inputs.sample_chunk(seed, int(traffic["min_chunks"]))
    held = None
    marks = [time.perf_counter()]
    while True:
        before = solver.state
        chunk()
        marks.append(time.perf_counter())
        if len(marks) - 2 == sample:
            held = (before, solver.state)
        if marks[-1] - marks[0] >= seconds:
            break
    sync()
    t_end = time.perf_counter()
    n_chunks = len(marks) - 1
    window_overflows = solver.chunk_overflows - overflows0
    stats = solver.stats_history[n_stats0:]
    extra = 0
    while held is None:  # the drawn chunk lies past a short window
        before = solver.state
        chunk()
        extra += 1
        if n_chunks + extra - 1 == sample:
            held = (before, solver.state)
    bad = forbidden_modules()
    if bad:
        raise CellError("modules of JAX or the JAX package were loaded: "
                        + ", ".join(bad))
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    failed = sum(
        1 for c in range(n_chunks)
        if not all(s.get(f"{x}_ok", True) for s in stats[c * k:(c + 1) * k]
                   for x in ("v", "p", "f")))
    result = {"correct": False, "attempted": n_chunks, "failed": failed}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    notes = ["set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b)
        in zip([("start", t_start)] + clock, clock))
        + f"; {overflows0} overflowed",
        f"window {t_end - marks[0]:.3f} s, {n_chunks} chunks of {k} "
        f"steps, {window_overflows} overflowed; checked chunks: the first "
        f"and window chunk {sample}"
        + (f" ({extra} chunks past the window)" if extra else "")]
    q = np.percentile(np.diff(marks[:-1] + [t_end]) * 1e3,
                      [0, 25, 50, 75, 100])
    notes.append("chunk ms min/q1/median/q3/max: "
                 + " ".join(f"{v:.3f}" for v in q))
    if n_chunks < int(traffic["min_chunks"]):
        notes.append(f"the window held {n_chunks} chunks, fewer than the "
                     f"traffic's min_chunks {traffic['min_chunks']}")

    window = marks[:-1] + [t_end]
    if trace:
        step_s = statistics.median(np.diff(window)) / k
        result["metrics"], breakdown = _traced(
            cell, solver, stats, step_s, window_overflows, chunk, device_info)
        result["device"] = device_info
        result["breakdown"] = breakdown
    else:
        result["metrics"] = dict(window_metrics(window, k),
                                 setup_s={"value": setup_s, "unit": "s"})
        result["device"] = device_info

    # the window's captured step once more, from the seeded start
    solver.state = state_from_numpy(start, solver.device, solver.dtype)
    solver.ite, solver.t, solver.nt = ite0, t0, ite0 - solver.nstart
    overflows1 = solver.chunk_overflows
    chunk()
    replay_out = _to_host(solver.state)
    if solver.chunk_overflows > overflows1:
        notes.append("the replay from the seeded start overflowed")

    # the check, with the program's state freed first
    first_out = _to_host(first_out)
    held = tuple(_to_host(s) for s in held)
    notes.append("replay from the start against the first chunk, largest "
                 "gap: " + ", ".join(f"{key} {v:.3g}" for key, v in
                                     gaps(replay_out, first_out).items()))
    del solver, before
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, control_gaps = _check(cell, cfg, body, device, start,
                                  [first_out, replay_out], held, control)
    notes.append(f"check {time.perf_counter() - t_ref:.3f} s")
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    if control:
        result["control"] = control_gaps
    result["notes"] = notes
    return result


def window_metrics(marks: list, k: int) -> dict:
    """``step_ms`` and ``chunk_ms_p95`` from the host clock's marks: the
    window's start, then each chunk's end (its host read; the last one
    after the closing synchronise), ``k`` steps a chunk."""
    chunk_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    p95 = (chunk_ms[0] if len(chunk_ms) < 2 else statistics.quantiles(
        chunk_ms, n=20, method="inclusive")[18])
    return {"step_ms": {"value": 1e3 * (marks[-1] - marks[0])
                        / (k * len(chunk_ms)), "unit": "ms"},
            "chunk_ms_p95": {"value": p95, "unit": "ms"}}


def _traced(cell, solver, stats, step_s, window_overflows, chunk,
            device_info) -> tuple:
    """``trace_chunks`` more chunks under torch.profiler, then each
    per-layer metric's reader."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .timing import Trace

    n = int(cell.traffic["trace_chunks"])
    cuda = solver.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    n0 = len(solver.stats_history)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            chunk()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tr = Trace(prof, wall)
    device_info["busy_s"] = tr.busy_s
    device_info["window_s"] = wall
    run = Run(cell, solver, stats, step_s, window_overflows, tr,
              solver.stats_history[n0:], n * cell.k)
    metrics = {}
    for m in cell.per_layer:
        value = _read_metric(cell, m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}


def _check(cell, cfg, body, device, start_in, from_start, held,
           control: bool) -> tuple:
    """The checked chunks worked out by the reference in float64: the
    chunks ``from_start`` (host states) from the seeded start, ``held``'s
    from its state before; each field's largest gap over them against
    its limit.  ``control``: the same chunks by the control
    (``precision="tf32"``), its gaps to the reference."""
    k = cell.k
    Reference = cell.reference_class()
    ref = Reference(cfg, body, device=device)
    want = [ref.advance(ref.load(start_in), k),
            ref.advance(ref.load(held[0]), k)]
    want = [_reference_numpy(w) for w in want]
    pairs = [(g, want[0]) for g in from_start] + [(held[1], want[1])]
    worst = {}
    for g, w in pairs:
        for key, val in gaps(g, w).items():
            worst[key] = max(worst.get(key, 0.0), val)
    checks = {f"{key}_gap": {"value": val,
                             "limit": float(cell.limits[f"{key}_gap"])}
              for key, val in worst.items()}
    control_gaps = None
    if control:
        ctl = Reference(cfg, body, device=device, precision="tf32")
        outs = [ctl.advance(ctl.load(start_in), k),
                ctl.advance(ctl.load(held[0]), k)]
        control_gaps = {}
        for o, w in zip(outs, want):
            for key, val in gaps(_reference_numpy(o), w).items():
                control_gaps[f"{key}_gap"] = max(
                    control_gaps.get(f"{key}_gap", 0.0), val)
    return checks, control_gaps


def print_result(result: dict, stream_out=None, stream_err=None) -> None:
    """The notes and each compared number beside its limit, last on
    standard error; the result as one JSON line, last on standard output,
    its checks last."""
    out = stream_out or sys.stdout
    err = stream_err or sys.stderr
    for note in result.pop("notes", []):
        print(f"note: {note}", file=err)
    control = result.pop("control", None)
    if control:
        for key, val in control.items():
            print(f"control {key} {val!r}", file=err)
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), file=out)
    out.flush()
