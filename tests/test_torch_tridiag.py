"""The PCR tridiagonal solve and K6/K7 (the batched PCR kernel) against
the JAX package on the same numpy inputs.

(a) ``tridiag_solve_pcr``: the port against the JAX function and against
    ``jax.lax.linalg.tridiagonal_solve`` (float64, 1e-12)
(b) ``pcr_ref``, the plain twin of K6/K7, against the Pallas kernels
    ``pcr_pallas`` (2D, both axes) and ``pcr_pallas_blocked`` (3D, every
    axis) in interpret mode, float32 (1e-5) and float64 (1e-12)
(c) the ``pcr`` wrapper runs the twin on CPU tensors and raises on what
    the kernel does not take; ``launch_plan`` picks the path, rows a lane
    and lines a block for every line length and axis
(d) on a card (the JAX side is imported inside the tests that use it, so
    these also run where jax is not installed: ``--noconftest -m cuda``):
    the kernel equals its twin bit for bit, every axis, 2D and
    3D, lines of 1 to 4096 rows across every threshold of the plan; the
    block path equals the register paths where both apply
"""

import numpy as np
import pytest
import torch

from petibm_tpu_torch.linalg import cuda_pcr
from petibm_tpu_torch.linalg.tridiag import tridiag_solve_pcr

torch.set_num_threads(2)

TOLS = {np.float32: 1e-5, np.float64: 1e-12}


def random_system(rng, shape, axis=-1):
    """A strictly diagonally dominant system along ``axis`` with a[first]
    = c[last] = 0 and its solution x."""
    axis %= len(shape)
    a = -rng.random(shape) * 0.4
    c = -rng.random(shape) * 0.4
    first = [slice(None)] * len(shape)
    first[axis] = 0
    last = [slice(None)] * len(shape)
    last[axis] = -1
    a[tuple(first)] = 0.0
    c[tuple(last)] = 0.0
    b = 1.0 + np.abs(a) + np.abs(c)
    x = rng.standard_normal(shape)
    lo = [slice(None)] * len(shape)
    lo[axis] = slice(1, None)
    hi = [slice(None)] * len(shape)
    hi[axis] = slice(0, -1)
    d = b * x
    d[tuple(lo)] += a[tuple(lo)] * x[tuple(hi)]
    d[tuple(hi)] += c[tuple(hi)] * x[tuple(lo)]
    return a, b, c, d, x


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 100, 450])
def test_pcr_matches_jax_and_lapack(n):
    import jax
    import jax.numpy as jnp

    from petibm_tpu.linalg.tridiag import tridiag_solve_pcr as jax_pcr

    rng = np.random.default_rng(n)
    a, b, c, d, x = random_system(rng, (4, 5, n))
    # a[first] and c[last] are ignored: garbage there changes nothing
    a[..., 0] = 7.0
    c[..., -1] = -3.0
    got = tridiag_solve_pcr(*(torch.as_tensor(v) for v in (a, b, c, d)))
    want = jax_pcr(*(jnp.asarray(v) for v in (a, b, c, d)))
    assert rel(got, want) <= 1e-12
    a[..., 0] = 0.0
    c[..., -1] = 0.0
    lapack = jax.lax.linalg.tridiagonal_solve(
        *(jnp.asarray(v) for v in (a, b, c)), jnp.asarray(d)[..., None])
    assert rel(got, np.asarray(lapack)[..., 0]) <= 1e-12
    np.testing.assert_allclose(got.numpy(), x, rtol=0, atol=1e-10)


def test_pcr_poisson_line_systems():
    """The smoother's systems: FV Poisson lines on a strongly stretched
    grid (test_tridiag.py::test_pcr_poisson_line_systems)."""
    import jax.numpy as jnp

    from petibm_tpu.linalg.tridiag import tridiag_solve_pcr as jax_pcr

    rng = np.random.default_rng(1)
    w = np.geomspace(1.0, 40.0, 128)
    inv = 1.0 / (0.5 * (w[:-1] + w[1:]))
    a = np.zeros(128)
    c = np.zeros(128)
    a[1:] = -inv
    c[:-1] = -inv
    b = -(a + c) + 1e-3
    x = rng.standard_normal((6, 128))
    d = b * x
    d[..., 1:] += a[1:] * x[..., :-1]
    d[..., :-1] += c[:-1] * x[..., 1:]
    args = [np.broadcast_to(v, x.shape).copy() for v in (a, b, c)] + [d]
    got = tridiag_solve_pcr(*(torch.as_tensor(v) for v in args))
    want = jax_pcr(*(jnp.asarray(v) for v in args))
    assert rel(got, want) <= 1e-12
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,axis", [(37, 1), (37, 0), (64, 1), (64, 0)])
def test_pcr_ref_matches_pallas_2d(n, axis, dtype):
    import jax.numpy as jnp

    from petibm_tpu.linalg.pallas_pcr import pcr_pallas

    rng = np.random.default_rng(3)
    shape = (n, 41) if axis == 0 else (41, n)
    args = [v.astype(dtype) for v in random_system(rng, shape, axis)[:4]]
    want = pcr_pallas(*(jnp.asarray(v) for v in args), axis=axis,
                      interpret=True)
    got = cuda_pcr.pcr_ref(*(torch.as_tensor(v) for v in args), axis)
    assert got.dtype == torch.as_tensor(args[0]).dtype
    assert rel(got, want) <= TOLS[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pcr_ref_matches_pallas_blocked_3d(axis, dtype):
    import jax.numpy as jnp

    from petibm_tpu.linalg.pallas_pcr import pcr_pallas_blocked

    rng = np.random.default_rng(5)
    shape = (12, 16, 16)
    args = [v.astype(dtype) for v in random_system(rng, shape, axis)[:4]]
    block_axis = 1 if axis != 1 else 0
    want = pcr_pallas_blocked(*(jnp.asarray(v) for v in args), axis=axis,
                              block_axis=block_axis, bs=4, interpret=True)
    got = cuda_pcr.pcr_ref(*(torch.as_tensor(v) for v in args), axis)
    assert rel(got, want) <= TOLS[dtype]


def test_pcr_wrapper_on_cpu_runs_the_twin():
    rng = np.random.default_rng(7)
    args = [torch.as_tensor(v) for v in random_system(rng, (5, 6, 9), 1)[:4]]
    before = cuda_pcr.pcr.launches
    got = cuda_pcr.pcr(*args, axis=1)
    assert cuda_pcr.pcr.launches == before  # nothing launched on the CPU
    assert torch.equal(got, cuda_pcr.pcr_ref(*args, 1))


def test_pcr_wrapper_raises_on_what_the_kernel_does_not_take():
    ones = torch.ones(3, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="one shape"):
        cuda_pcr.pcr(ones, ones, ones, torch.ones(4, 3, dtype=torch.float64),
                      axis=0)
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_pcr.pcr(*(torch.ones(3, 4, dtype=torch.float16),) * 4, axis=0)
    with pytest.raises(ValueError, match="2D or 3D"):
        cuda_pcr.pcr(*(torch.ones(8, dtype=torch.float64),) * 4, axis=0)
    long = torch.ones(2, cuda_pcr.MAX_LINE + 1, dtype=torch.float32)
    with pytest.raises(ValueError, match="at most 4096"):
        cuda_pcr.pcr(long, long, long, long, axis=1)
    with pytest.raises(ValueError, match="out of range"):
        cuda_pcr.pcr(ones, ones, ones, ones, axis=2)


#: line lengths at and around every threshold of the launch plan
PLAN_LENGTHS = [1, 2, 3, 31, 32, 33, 255, 256, 257, 512, 513, 4096]


@pytest.mark.parametrize("n", PLAN_LENGTHS)
def test_launch_plan(n):
    for axis in (0, 1, 2):
        shape = [5, 7, 19]
        shape[axis] = n
        plan = cuda_pcr.launch_plan(tuple(shape), axis)
        if n <= 256:
            # the least power of two of rows a lane that holds the line
            rows = 1 if n <= 32 else 2 if n <= 64 else 4 if n <= 128 else 8
            if axis == 2:
                assert plan == ("warp_rows", rows, cuda_pcr.ROWS_WARPS)
            else:
                assert plan == ("warp_tiles", rows, cuda_pcr.TILE_LINES)
        else:
            nlines = shape[0] * shape[1] * shape[2] // n
            assert plan == ("block", 0, min(max(2048 // n, 1), 64, nlines))


def test_launch_plan_2d_and_limits():
    # a 2D array is (1, n1, n2): its lines along axis 1 are strided
    assert cuda_pcr.launch_plan((1, 100, 3), 1) == ("warp_tiles", 4, 8)
    assert cuda_pcr.launch_plan((1, 3, 100), 2) == ("warp_rows", 4, 8)
    assert cuda_pcr.launch_plan((1, 300, 5), 1) == ("block", 0, 5)
    # arrays of 2^31 values or more take the block path (64-bit offsets)
    assert cuda_pcr.launch_plan((2 ** 16, 2 ** 8, 2 ** 7), 2).path \
        == "block"
    assert cuda_pcr.launch_plan((2 ** 16, 2 ** 8, 2 ** 7 - 1), 2).path \
        == "warp_rows"
    with pytest.raises(ValueError, match="at most 4096"):
        cuda_pcr.launch_plan((2, 3, cuda_pcr.MAX_LINE + 1), 2)
    with pytest.raises(ValueError, match="at most 4096"):
        cuda_pcr.launch_plan((cuda_pcr.MAX_LINE + 1, 3, 2), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcr_kernel_matches_twin_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(11)
    cases = []
    for n in PLAN_LENGTHS:
        for axis in (0, 1, 2):
            shape = [6, 5, 19]
            shape[axis] = n
            cases.append((tuple(shape), axis))
        cases += [((n, 37), 0), ((37, n), 1)]
    for shape, axis in cases:
        args = [torch.as_tensor(v, dtype=dtype, device="cuda")
                for v in random_system(rng, shape, axis)[:4]]
        before = cuda_pcr.pcr.launches
        got = cuda_pcr.pcr(*args, axis=axis)
        torch.cuda.synchronize()
        assert cuda_pcr.pcr.launches == before + 1
        want = cuda_pcr.pcr_ref(*args, axis)
        assert float((got - want).abs().max()) == 0.0, (shape, axis)
        if shape[axis] <= cuda_pcr.WARP_LINE:
            # the block path takes these lines too, with the same bits
            shape3 = (1,) * (3 - len(shape)) + shape
            axis3 = axis + 3 - len(shape)
            block = cuda_pcr.launch(*args, axis3,
                                    cuda_pcr.block_plan(shape3, axis3))
            assert torch.equal(block, got), (shape, axis)
