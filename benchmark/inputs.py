"""What a seed makes: the initial velocity of a run and the chunk whose
output is checked.

Every seed gets the same work: a Gaussian bump of the same strength in
each cell of a fixed lattice over the configuration's
``inputs.region``, added to the case's initial velocity, the seed
drawing only each centre's jitter within its cell and each sign.  The
bumps break the wake's symmetry, so the flow develops as a user's run
does; the same fields go to the port and to the reference.
"""

from __future__ import annotations

import numpy as np

NAMES = ("u", "v", "w")


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)), stream])


def initial_velocity(grid, case: dict, seed: int) -> dict:
    """Velocity fields (numpy float64, z-y-x order) at step 0 on the
    staggered points of ``grid`` (the reference's ``DecoupledIBPM``): the
    case's uniform initial velocity plus a Gaussian bump in each of the
    ``inputs.sites`` cells that split ``inputs.region``, its centre
    jittered by up to a quarter of its cell and its sign in each
    component drawn from the seed."""
    spec = case["inputs"]
    dim = grid.dim
    rng = _rng(seed, 0)
    region = np.asarray(spec["region"], np.float64)
    sites = [int(n) for n in spec["sites"]]
    size = (region[:, 1] - region[:, 0]) / sites
    lattice = np.stack(np.meshgrid(*[np.arange(n) for n in sites],
                                   indexing="ij"), -1).reshape(-1, dim)
    centres = (region[:, 0] + (lattice + 0.5) * size
               + (rng.random(lattice.shape) - 0.5) * 0.5 * size)
    signs = rng.choice([-1.0, 1.0], size=lattice.shape)
    amp, sigma = float(spec["amplitude"]), float(spec["sigma"])
    base = case["flow"]["initialVelocity"]
    out = {}
    for c in range(dim):
        axes = [grid.lines[c][d].coord[1:-1] for d in range(dim)]
        field = np.full([len(a) for a in reversed(axes)], float(base[c]))
        for b in range(len(centres)):
            # a Gaussian is the product of its 1D factors (z, y, x order)
            bump = amp * signs[b, c]
            for a, x in zip(reversed(axes), reversed(centres[b])):
                bump = np.multiply.outer(bump, np.exp(-0.5 * ((a - x) / sigma)
                                                      ** 2))
            field += bump
        out[NAMES[c]] = field
    return out


def sample_chunk(seed: int, chunks: int) -> int:
    """The window chunk (0-based) whose output is checked: drawn from the
    first ``chunks`` of the window."""
    return int(_rng(seed, 1).integers(0, chunks))
