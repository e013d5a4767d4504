"""Chunks of steps (``stepsPerDispatch``) on a decomposed run of the port,
on CPU processes over gloo, held to the JAX package's sharded chunked
run.

The ranks are processes of this file (``python
test_torch_parallel_chunked.py <rank> <world> <port> <out>``, one torch
thread each), started once by a module fixture
(``test_torch_parallel.RankJob``).  Four ranks run each case three times
in float64, 8 steps: single steps (the host driver), chunks of 4 under
the guarded driver (``if bool(pred):`` on each rank) and chunks of 4
with every loop copy masked (``loops.masked``: the design a decomposed
chunk takes on the card, where an IF node's body takes no NCCL
collective).  Rank 0 publishes each case's results when the case ends,
and each test waits for the file it reads.

The cases: the FDM cylinder and the ``fdm: false`` MG-CG cylinder on
[2, 2], the coupled IBPM on [2, 2] and the 16^3 sphere on the 3-axis
mesh [2, 1, 2] (z cut: the FDM's contraction core).  Each chunked run
equals the same ranks' single steps bit for bit, every rank's stats are
equal (each predicate comes from a replicated reduction, so all ranks
take the same branch), the sweep wrappers were called as the stats
imply, and the fields are within 1e-12 of their maxima of the JAX
package's sharded chunked run (``lax.scan`` over its sharded step on
conftest's virtual CPU devices), every ``_iters``/``_ok`` stat equal per
step.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for path in (REPO, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

from test_torch_parallel import (SHARDING, RankJob,  # noqa: E402
                                 cylinder_config, init_ranks, publish_npz,
                                 sphere_config)
from test_torch_parallel_mg import mgcg_cylinder  # noqa: E402

#: the rank job's time limit (s from its start): a guard against a hang,
#: at least 4x the job's run on an idle machine (CHANGES.md)
TIMEOUT = 300
WORLD = 4
#: steps a run takes, and a chunk
NT, K = 8, 4

DECOUPLED = "decoupledibpm.DecoupledIBPMSolver"
#: name -> (config function, solver module.class, process mesh)
CASES = {
    "cylinder_fdm": (cylinder_config, DECOUPLED, [2, 2]),
    "cylinder_mgcg": (mgcg_cylinder, DECOUPLED, [2, 2]),
    "coupled": (cylinder_config, "ibpm.IBPMSolver", [2, 2]),
    "sphere_2x1x2": (sphere_config, DECOUPLED, [2, 1, 2]),
}
MODES = ("single", "chunked", "masked")


def _solver_class(name: str, package: str):
    import importlib

    module, cls = name.split(".")
    return getattr(importlib.import_module(f"{package}.solvers.{module}"),
                   cls)


def _config(name, tmpdir, sharding, chunked: bool) -> dict:
    build = CASES[name][0]
    cfg = build(tmpdir, sharding=sharding)
    cfg["parameters"].update(nt=NT, nsave=NT, nrestart=NT)
    if chunked:
        cfg["parameters"]["stepsPerDispatch"] = K
    return cfg


# --- the rank processes ----------------------------------------------------
def _count_calls() -> dict:
    """Count the calls of the V-cycle's sweep wrappers (K4/K5's and
    K6/K7's twins)."""
    from petibm_tpu_torch.linalg import mg as mg_mod

    calls = {}
    for name in ("fused_sweep", "pcr"):
        real = getattr(mg_mod, name)
        calls[name] = 0

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        setattr(mg_mod, name, counted)
    return calls


def _run_mode(name, mode, tmpdir, calls) -> dict:
    """One run of the case on this rank: its state's tensors, its stats
    per step, and (chunked) the sweep calls of its chunks and its
    overflows."""
    from petibm_tpu_torch.convert import state_to_numpy
    from petibm_tpu_torch.solvers import chunk

    _, cls, shape = CASES[name]
    real = chunk.masks_loops
    if mode == "masked":
        chunk.masks_loops = lambda solver: solver.part is not None
    try:
        solver = _solver_class(cls, "petibm_tpu_torch")(
            _config(name, tmpdir, dict(SHARDING, shape=shape),
                    mode != "single"), device="cpu")
        assert solver.part is not None
        out = {}
        if mode == "single":
            for _ in range(NT):
                solver.advance()
        else:
            # the warm-up step outside the counted window
            solver._chunk = chunk.ChunkRunner(solver)
            solver._chunk.prepare()
            assert solver._chunk.masked == (mode == "masked")
            for key in calls:
                calls[key] = 0
            for _ in range(NT // K):
                solver.advance_chunk()
            out["calls"] = [calls[k] for k in sorted(calls)]
            out["overflows"] = solver.chunk_overflows
        out["stats"] = [{k: float(v) for k, v in s.items()
                         if k != "ite" and np.ndim(v) == 0}
                        for s in solver.stats_history]
        assert [s["ite"] for s in solver.stats_history] == \
            list(range(1, NT + 1))
        flat, _ = torch.utils._pytree.tree_flatten_with_path(solver.state)
        out["leaves"] = {torch.utils._pytree.keystr(p): t.clone()
                         for p, t in flat}
        out["full"] = state_to_numpy(solver.state, solver.part)
        mg = getattr(solver, "poisson_mg", None)
        out["sweeps"] = [mg.sweeps_per_vcycle() if mg is not None else -1,
                         int(mg is not None and any(mg.levels[0].periodic))]
        solver.close()
    finally:
        chunk.masks_loops = real
    return out


def _same_bits(a: dict, b: dict) -> list:
    """The state tensors that differ (by path) between two runs."""
    if a.keys() != b.keys():
        return ["<structure>"]
    return [k for k in a if not torch.equal(a[k], b[k])]


def _run_case(name, tmpdir, calls) -> dict:
    import torch.distributed as dist

    runs = {mode: _run_mode(name, mode, os.path.join(tmpdir, mode), calls)
            for mode in MODES}
    single = runs["single"]
    mine = {"differ": {m: _same_bits(single["leaves"], runs[m]["leaves"])
                       for m in ("chunked", "masked")},
            "stats_differ": {m: runs[m]["stats"] != single["stats"]
                             for m in ("chunked", "masked")},
            "stats": runs["chunked"]["stats"],
            "calls": runs["chunked"]["calls"],
            "overflows": [runs[m]["overflows"]
                          for m in ("chunked", "masked")]}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    full = runs["chunked"]["full"]
    out = {f"q_{k}": v for k, v in full["q"].items()}
    out["p"] = full["p"]
    if "f" in full:
        out["f"] = full["f"]
    stats = runs["chunked"]["stats"]
    for key in stats[0]:
        out[f"stat_{key}"] = np.array([s[key] for s in stats])
    out["sweeps"] = np.array(runs["chunked"]["sweeps"])
    out["differ"] = np.array([len(e["differ"][m]) for e in every
                              for m in ("chunked", "masked")])
    out["differ_keys"] = np.array(repr([e["differ"] for e in every]))
    out["stats_differ"] = np.array([e["stats_differ"][m] for e in every
                                    for m in ("chunked", "masked")])
    out["ranks_same_stats"] = np.array(
        all(e["stats"] == every[0]["stats"] for e in every))
    out["calls"] = np.array([e["calls"] for e in every])
    out["overflows"] = np.array([e["overflows"] for e in every])
    return out


def _job(rank, out):
    calls = _count_calls()
    for name in CASES:
        arr = _run_case(name, os.path.join(out, f"{name}-{rank}"), calls)
        if rank == 0:
            publish_npz(out, f"{name}.npz", arr)


def _rank_main(argv) -> None:
    import torch.distributed as dist

    rank, world, port, out = argv
    init_ranks(int(rank), int(world), int(port))
    _job(int(rank), out)
    dist.destroy_process_group()


# --- the tests' side ---------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The rank job, started when the module's first test asks for it:
    before the tests take their JAX references, which overlap it."""
    job = RankJob([os.path.abspath(__file__)], WORLD,
                  tmp_path_factory.mktemp("chunked_ranks"), TIMEOUT)
    yield job
    job.stop()


def _implied_calls(got) -> list:
    """The sweep wrappers' calls the stats imply on each rank over the
    chunks (sorted by name): sweeps_per_vcycle() x V-cycles (one a CG
    iteration and one for the first residual) on K4/K5's twin, or on
    K6/K7's on periodic levels; none without a V-cycle."""
    sweeps, periodic = (int(v) for v in got["sweeps"])
    vcycles = int(np.sum(got["stat_p_iters"] + 1)) if sweeps > 0 else 0
    want = {"fused_sweep": 0 if periodic else sweeps * vcycles,
            "pcr": sweeps * vcycles if periodic else 0}
    return [want[k] for k in sorted(want)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_decomposed_chunk_equals_single_steps(ranks, name):
    """On every rank, 8 steps in chunks of 4 (guarded, and masked) equal
    the same ranks' 8 single steps bit for bit, state and stats; every
    rank read the same stats (all took the same branches) and reran the
    same chunks where a loop overflowed its cap; the sweep wrappers were called in the chunks as the stats
    imply."""
    got = ranks.npz(f"{name}.npz")
    assert not got["differ"].any(), str(got["differ_keys"])
    assert not got["stats_differ"].any()
    assert bool(got["ranks_same_stats"])
    # a chunk that overflows reruns on every rank together (the coupled
    # case's outer CG outgrows its first caps once)
    assert (got["overflows"] == got["overflows"][0]).all()
    want = _implied_calls(got)
    for rank, calls in enumerate(got["calls"]):
        assert calls.tolist() == want, (rank, name)
    if name == "cylinder_mgcg":
        assert want[0] > 0


def _run_jax_steps(name, tmpdir, sharded: bool) -> dict:
    """The JAX package's single steps of a case, on the case's mesh of
    virtual devices or on one device: its fields."""
    import jax

    _, cls, shape = CASES[name]
    sharding = (dict(SHARDING, nDevices=math.prod(shape), shape=shape)
                if sharded else None)
    solver = _solver_class(cls, "petibm_tpu")(
        _config(name, tmpdir, sharding, False))
    state = solver.state
    for _ in range(NT):
        state, _ = solver._step_fn(state)
    state = jax.device_get(state)
    solver.close()
    return _fields(state)


def _fields(state) -> dict:
    out = {f"q_{k}": np.asarray(v) for k, v in state["q"].items()}
    out["p"] = np.asarray(state["p"])
    if "f" in state:
        out["f"] = np.asarray(state["f"])
    return out


def _run_jax_chunked(name, tmpdir):
    """The JAX package's sharded run of a case in chunks of K
    (``_chunk_fn``, ``lax.scan`` over its sharded step) on conftest's
    virtual CPU devices: its state and stats per step."""
    import jax

    _, cls, shape = CASES[name]
    sharding = dict(SHARDING, nDevices=math.prod(shape), shape=shape)
    solver = _solver_class(cls, "petibm_tpu")(
        _config(name, tmpdir, sharding, True))
    assert solver._chunk_fn is not None
    state, stats = solver.state, []
    for _ in range(NT // K):
        state, s = solver._chunk_fn(state)
        s = jax.device_get(s)
        stats += [{k: float(v[j]) for k, v in s.items()
                   if k != "f" and np.ndim(v) == 1} for j in range(K)]
    state = jax.device_get(state)
    solver.close()
    return state, stats


@pytest.mark.parametrize("name", sorted(CASES))
def test_decomposed_chunk_matches_jax_sharded_chunk(ranks, tmp_path, name):
    """The ranks' chunked run against the JAX package's sharded chunked
    run: every field (and the forces) within 1e-12 of its maximum, every
    ``_iters``/``_ok`` stat equal per step.  The coupled IBPM's outer CG
    (a few hundred iterations a step to atol 1e-12) spreads rounding
    further in the JAX package itself: its own sharded single steps and
    its one-device steps part from its sharded chunk by up to 2e-11 (p)
    and 7e-11 (f) of their maxima, so that case is held to 4x the larger
    of those two spreads of each field, measured here."""
    ranks.check(f"{name}.npz")
    state, stats = _run_jax_chunked(name, tmp_path / "jax")
    fields = _fields(state)
    rel = {key: 1e-12 for key in fields}
    if name == "coupled":
        for sharded in (True, False):
            other = _run_jax_steps(name, tmp_path / f"steps{sharded}",
                                   sharded)
            for key, want in fields.items():
                spread = np.abs(other[key] - want).max() / np.abs(want).max()
                rel[key] = max(rel[key], 4 * spread)
    got = ranks.npz(f"{name}.npz")
    for key, want in fields.items():
        assert got[key].shape == want.shape, key
        np.testing.assert_allclose(got[key], want, rtol=0,
                                   atol=rel[key] * np.abs(want).max(),
                                   err_msg=key)
    keys = [k for k in stats[0] if k.endswith(("_iters", "_ok"))]
    assert keys and len(stats) == NT
    for key in keys:
        np.testing.assert_array_equal(got[f"stat_{key}"],
                                      [s[key] for s in stats], err_msg=key)


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
