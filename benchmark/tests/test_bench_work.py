"""The yardstick's arithmetic: byte counts against hand counts, and the
window's metrics from the host clock's marks."""

from __future__ import annotations

import pytest

from benchmark import harness, work


def test_poisson_apply_bytes():
    # 450 x 450 float32: 202 500 cells read and written
    assert work.poisson_apply_bytes((450, 450)) == 2 * 202_500 * 4
    # the sphere's pressure, 160 x 130 x 130 = 2 704 000 cells
    assert work.poisson_apply_bytes((130, 130, 160)) == 2 * 2_704_000 * 4
    assert work.poisson_apply_bytes((450, 450), "float64") == 3_240_000


def test_convection_bytes():
    # u on 159 x 130 x 130 points, v and w on 160 x 129 x 130
    shapes = [(130, 130, 159), (130, 129, 160), (129, 130, 160)]
    cells = 2_687_100 + 2 * 2_683_200
    assert work.convection_bytes(shapes) == 2 * cells * 4 == 64_428_000


def test_line_sweep_bytes():
    # per direction the iterate and the right side read, the iterate
    # written: 2 directions x 3 arrays of 202 500 float32
    assert work.line_sweep_bytes((450, 450)) == 4_860_000


def test_roofline():
    nbytes = work.poisson_apply_bytes((450, 450))
    assert work.bound_s(nbytes) == pytest.approx(1_620_000 / 3.35e12)
    # 3.10 us against a 0.4836 us bound: a share of 15.6%
    assert work.roofline_pct(3.10e-6, nbytes) == pytest.approx(
        100 * 0.48358 / 3.10, rel=1e-4)
    # operations bind where they outweigh the bytes
    assert work.bound_s(1.0, 67e12) == pytest.approx(1.0)


def _marks(chunk_s: list) -> list:
    out = [0.0]
    for s in chunk_s:
        out.append(out[-1] + s)
    return out


def test_window_metrics():
    m = harness.window_metrics(_marks([0.1] * 20), 100)
    assert m["step_ms"]["value"] == pytest.approx(1.0)
    assert m["chunk_ms_p95"]["value"] == pytest.approx(100.0)


def test_a_stalled_chunk_moves_both_metrics():
    calm = harness.window_metrics(_marks([0.1] * 20), 100)
    stall = harness.window_metrics(_marks([0.1] * 19 + [2.0]), 100)
    assert stall["step_ms"]["value"] > calm["step_ms"]["value"] * 1.5
    assert stall["chunk_ms_p95"]["value"] > calm["chunk_ms_p95"]["value"]
    # in a window of 200 chunks the tail needs more than one stall
    calm = harness.window_metrics(_marks([0.1] * 200), 100)
    stalls = harness.window_metrics(_marks([0.1] * 189 + [2.0] * 11), 100)
    assert stalls["chunk_ms_p95"]["value"] == pytest.approx(2000.0)
    assert stalls["step_ms"]["value"] > calm["step_ms"]["value"]


def test_union_of_intervals():
    from benchmark.timing import union_ns

    merged, total = union_ns([(0, 10), (5, 20), (30, 40), (35, 36)])
    assert merged == [[0, 20], [30, 40]] and total == 30
