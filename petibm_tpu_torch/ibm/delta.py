"""Regularized delta kernels on tensors.

Counterpart of ``petibm_tpu/ibm/delta.py`` (reference: delta.cpp:17-62):
the Roma et al. (1999) 3-point kernel (window half-width 2) and the
Peskin (2002) 4-point kernel (half-width 3); the nD delta is the tensor
product of the 1D kernels.
"""

from __future__ import annotations

import torch


def roma_1999(r: torch.Tensor, dr) -> torch.Tensor:
    """Roma et al. 1999 3-pt kernel (reference: delta.cpp:17-27)."""
    x = torch.abs(r) / dr
    inner = (1.0 + torch.sqrt(torch.clamp(1.0 - 3.0 * x * x, min=0.0))) / (
        3.0 * dr)
    mid = (5.0 - 3.0 * x - torch.sqrt(
        torch.clamp(1.0 - 3.0 * (1.0 - x) ** 2, min=0.0))) / (6.0 * dr)
    zero = torch.zeros_like(x)
    return torch.where(x > 1.5, zero, torch.where(x > 0.5, mid, inner))


def peskin_2002(r: torch.Tensor, dr) -> torch.Tensor:
    """Peskin 2002 4-pt kernel (reference: delta.cpp:30-39)."""
    x = torch.abs(r) / dr
    near = (3.0 - 2.0 * x + torch.sqrt(
        torch.clamp(1.0 + 4.0 * x - 4.0 * x * x, min=0.0))) / (8.0 * dr)
    far = (5.0 - 2.0 * x - torch.sqrt(
        torch.clamp(-7.0 + 12.0 * x - 4.0 * x * x, min=0.0))) / (8.0 * dr)
    zero = torch.zeros_like(x)
    return torch.where(x > 2.0, zero, torch.where(x > 1.0, far, near))


# name -> (kernel fn, window half-width) (reference: delta.cpp:42-62)
KERNELS = {
    "ROMA_ET_AL_1999": (roma_1999, 2),
    "PESKIN_2002": (peskin_2002, 3),
}
