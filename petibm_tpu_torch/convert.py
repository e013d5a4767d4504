"""Carry solver state between the JAX package and the port.

A state is a dict with the keys ``q`` (velocity components), ``p``,
``bc`` (per face ``a1`` and ``value``), ``conv`` and ``diff`` (explicit
histories, newest first), ``dP``, and for the IBM solvers ``f`` and
``df``.  ``state_from_numpy`` takes that tree with numpy leaves (the JAX
solver's state after ``jax.device_get``) and returns the port's state;
``state_to_numpy`` converts back, gathering a decomposed state.  Keys and
nesting are kept as they are.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(tree, device, dtype: torch.dtype):
    """numpy (or array-like) leaves -> tensors of ``dtype`` on ``device``;
    dicts stay dicts, tuples and lists become tuples."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(state_from_numpy(v, device, dtype) for v in tree)
    # np.array copies: arrays from jax.device_get are read-only
    return torch.as_tensor(np.array(tree), dtype=dtype, device=device)


def state_to_numpy(state, part=None):
    """Tensors -> numpy arrays on the host, the nesting unchanged; a
    decomposed run's state (``part``, its ``Partition``) is gathered
    first, on every rank."""
    if part is not None:
        state = part.gather_state(state)
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(state_to_numpy(v) for v in state)
    return state.detach().cpu().numpy()
