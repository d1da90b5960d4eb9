"""Positional encodings and mirror reflection.

Port of ``fgs_nerf_tpu/ops/encoding.py:19-40`` without the IDE, which no
forward calls.
"""
from __future__ import annotations

import numpy as np
import torch

from fgs_nerf_tpu_torch.device import to_device


def freq_bank(n: int, device=None) -> torch.Tensor:
    """[2^0, ..., 2^(n-1)] (`ops/encoding.py:19-21`), copied to the card
    without a synchronize."""
    return to_device([2.0**i for i in range(n)], device or "cpu",
                     torch.float32)


def sincos_encode(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [..., D + 2*D*F]: identity, then sin and cos with all
    frequencies of a component contiguous (`ops/encoding.py:24-29`)."""
    xf = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(xf), torch.cos(xf)], dim=-1)


def reflect(viewdirs: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection ``d - 2(d.n)n`` (`ops/encoding.py:32-35`)."""
    return viewdirs - 2.0 * torch.sum(
        viewdirs * normal, dim=-1, keepdim=True
    ) * normal


def l2_normalize(x: torch.Tensor,
                 eps: float = float(np.finfo(np.float32).eps)) -> torch.Tensor:
    """Unit-normalize along the last axis (`ops/encoding.py:38-40`)."""
    return x / torch.sqrt(
        torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=eps)
    )
