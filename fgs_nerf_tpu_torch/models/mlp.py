"""MLP parameter dicts with torch-Linear-compatible init.

Port of ``fgs_nerf_tpu/models/mlp.py:17-78``: init, the channel-last
``mlp_apply`` of the lattice heads and the layer sizes (the sorted
engine's channel-major application is ``models/sdf_voxel.py:_mlp_apply_cm``).
Parameters are flat dicts
``{'w0': [in, out], 'b0': [out], ...}`` drawn from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)).  Randomness comes from a
``torch.Generator`` (its numbers differ from ``jax.random``; the parity
tests carry weights across with ``convert.py`` instead).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def init_mlp(
    generator: torch.Generator, dims: Sequence[int], device: torch.device
) -> Dict[str, torch.Tensor]:
    """dims = [in, hidden, ..., out]; len(dims)-1 linear layers.  The
    generator must live on ``device``."""
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 1.0 / float(d_in) ** 0.5
        for name, shape in ((f"w{i}", (d_in, d_out)), (f"b{i}", (d_out,))):
            u = torch.rand(shape, generator=generator, device=device)
            params[name] = u * (2.0 * bound) - bound
    return params


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              bf16: bool = False) -> torch.Tensor:
    """ReLU between layers, none after the last (`models/mlp.py:32-66`).

    ``bf16=True`` rounds where the JAX package does: the input and the
    weights are cast to bf16; each hidden layer is a bf16 product (f32
    sums, bf16 result) plus a bf16 bias; the last layer sums the bf16
    operands in f32 (they are exact in f32) and adds the f32 bias."""
    n = len(params) // 2
    if bf16:
        x = x.to(torch.bfloat16)
    for i in range(n):
        w, b = params[f"w{i}"], params[f"b{i}"]
        if bf16:
            wb = w.to(torch.bfloat16)
            if i == n - 1:
                x = x.float() @ wb.float() + b
            else:
                x = torch.relu(x @ wb + b.to(torch.bfloat16))
        else:
            x = x @ w + b
            if i < n - 1:
                x = torch.relu(x)
    return x


def refnet_dims(d_in: int, width: int, depth: int) -> list:
    """Linear(d,W) + (depth-2) x Linear(W,W) + Linear(W,3)
    (`models/mlp.py:69-72`)."""
    return [d_in] + [width] * (depth - 1) + [3]


def rgbnet_dims(d_in: int, width: int, depth: int) -> list:
    """The same stack with a ``width``-feature head instead of RGB
    (`models/mlp.py:75-78`)."""
    return [d_in] + [width] * (depth - 1) + [width]
