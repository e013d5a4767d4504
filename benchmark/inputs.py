"""What a seed makes: the initial fields of a run and the chunk whose
output is checked.

The case's initial fields come first: each ``flow.initialVelocity``
entry, and ``flow.initialPressure`` where it is given, is a number or an
expression in ``x``, ``y``, ``z``, ``t`` and ``nu`` (the names PetIBM's
parser takes), with ``t`` = 0, evaluated here with numpy over the
reference's coordinates, apart from the program's own parser.

Every seed then gets the same work: a Gaussian bump of the same
strength in each cell of a fixed lattice over the configuration's
``inputs.region``, added to the initial velocity, the seed drawing only
each centre's jitter within its cell and each sign.  The bumps break the
flow's symmetry, so it develops as a user's run does; the same fields go
to the port and to the reference.
"""

from __future__ import annotations

import ast

import numpy as np

NAMES = ("u", "v", "w")
#: what an expression may name: the coordinates, the time, the viscosity
#: and these numpy functions and constants, nothing else
FUNCTIONS = {"sin": np.sin, "cos": np.cos, "tan": np.tan, "exp": np.exp,
             "sqrt": np.sqrt}
VARIABLES = ("x", "y", "z", "t", "nu")
_NODES = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Call, ast.Name,
          ast.Load, ast.Constant, ast.Add, ast.Sub, ast.Mult, ast.Div,
          ast.Pow, ast.USub, ast.UAdd)


class ExpressionError(ValueError):
    """An initial field's expression names or uses what it may not."""


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)), stream])


def compile_expression(text: str):
    """The code of one expression, checked node by node: numbers, the
    names of ``VARIABLES``, ``pi``, calls of ``FUNCTIONS``, ``+ - * /``
    and ``**``.  ``^`` and every other name or construct raise
    ``ExpressionError``."""
    try:
        tree = ast.parse(str(text), mode="eval")
    except SyntaxError as exc:
        raise ExpressionError(f"{text!r}: {exc.msg}") from None
    for node in ast.walk(tree):
        if isinstance(node, ast.BitXor):
            raise ExpressionError(f"{text!r}: '^' is not a power here; "
                                  "write '**'")
        if not isinstance(node, _NODES):
            raise ExpressionError(f"{text!r}: {type(node).__name__} is not "
                                  "allowed")
        if isinstance(node, ast.Constant) and not isinstance(
                node.value, (int, float)):
            raise ExpressionError(f"{text!r}: constant {node.value!r}")
        if isinstance(node, ast.Name) and node.id not in (
                VARIABLES + ("pi",) + tuple(FUNCTIONS)):
            raise ExpressionError(f"{text!r}: unknown name {node.id!r}")
        if isinstance(node, ast.Call) and (
                not isinstance(node.func, ast.Name)
                or node.func.id not in FUNCTIONS or node.keywords):
            raise ExpressionError(f"{text!r}: only {', '.join(FUNCTIONS)} "
                                  "may be called, with plain arguments")
    return compile(tree, "<initial field>", "eval")


def evaluate(entry, axes: list, nu: float) -> np.ndarray:
    """One initial field (numpy float64, z-y-x order) on the points whose
    coordinates along x, y[, z] are ``axes``: a number as it stands, an
    expression at t = 0."""
    shape = [len(a) for a in reversed(axes)]
    if isinstance(entry, (int, float)):
        return np.full(shape, float(entry))
    code = compile_expression(entry)
    # each coordinate along its own array axis, broadcast by the arithmetic
    grids = np.meshgrid(*reversed(axes), indexing="ij", sparse=True)
    xyz = list(reversed(grids)) + [0.0] * (3 - len(axes))
    names = dict(FUNCTIONS, pi=np.pi, x=xyz[0], y=xyz[1], z=xyz[2], t=0.0,
                 nu=float(nu))
    out = eval(code, {"__builtins__": {}}, names)  # noqa: S307 (checked)
    return np.broadcast_to(np.asarray(out, np.float64), shape).copy()


def initial_velocity(grid, case: dict, seed: int) -> dict:
    """Velocity fields (numpy float64, z-y-x order) at step 0 on the
    staggered points of ``grid`` (a reference's ``dim`` and
    ``lines[c][d].coord``): the case's initial velocity plus a Gaussian
    bump in each of the ``inputs.sites`` cells that split
    ``inputs.region``, its centre jittered by up to a quarter of its cell
    and its sign in each component drawn from the seed."""
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
    nu = case["flow"].get("nu", 0.0)
    out = {}
    for c in range(dim):
        axes = [grid.lines[c][d].coord[1:-1] for d in range(dim)]
        field = evaluate(base[c], axes, nu)
        for b in range(len(centres)):
            # a Gaussian is the product of its 1D factors (z, y, x order)
            bump = amp * signs[b, c]
            for a, x in zip(reversed(axes), reversed(centres[b])):
                bump = np.multiply.outer(bump, np.exp(-0.5 * ((a - x) / sigma)
                                                      ** 2))
            field += bump
        out[NAMES[c]] = field
    return out


def initial_fields(grid, case: dict, seed: int) -> dict:
    """``initial_velocity``'s fields, and ``p`` from
    ``flow.initialPressure`` where the case gives it (no bumps), on the
    cell centres: along direction d, the points of a component c != d."""
    out = initial_velocity(grid, case, seed)
    flow = case["flow"]
    if "initialPressure" in flow:
        centres = [grid.lines[(d + 1) % grid.dim][d].coord[1:-1]
                   for d in range(grid.dim)]
        out["p"] = evaluate(flow["initialPressure"], centres,
                            flow.get("nu", 0.0))
    return out


def sample_chunk(seed: int, chunks: int) -> int:
    """The window chunk (0-based) whose output is checked: drawn from the
    first ``chunks`` of the window."""
    return int(_rng(seed, 1).integers(0, chunks))
