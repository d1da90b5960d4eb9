"""NeuS-style SDF -> alpha conversion and the s-value schedule.

Port of ``fgs_nerf_tpu/ops/sdf2alpha.py:15-58``.
"""
from __future__ import annotations

import torch


def s_val_schedule(global_step, s_ratio: float, s_start: float,
                   step_start: int = 0) -> torch.Tensor:
    """``s = s_ratio / (step + s_ratio / s_start - step_start)``
    (`ops/sdf2alpha.py:15-22`)."""
    step = torch.as_tensor(global_step, dtype=torch.float32)
    return s_ratio / (step + s_ratio / s_start - step_start)


def neus_alpha(viewdirs: torch.Tensor, sdf: torch.Tensor,
               gradients: torch.Tensor, dist, s_val) -> torch.Tensor:
    """Per-sample opacity on the [N, S] lattice (`ops/sdf2alpha.py:25-41`):
    viewdirs [N, 3], sdf [N, S], gradients [N, S, 3]."""
    true_cos = torch.sum(viewdirs[:, None, :] * gradients, dim=-1)
    return neus_alpha_from_cos(true_cos, sdf, dist, s_val)


def neus_alpha_from_cos(true_cos, sdf, dist, s_val) -> torch.Tensor:
    """Elementwise NeuS alpha (`ops/sdf2alpha.py:44-55`): half-step SDF
    extrapolation along ``iter_cos = -relu(-cos)`` and the clipped
    sigmoid-CDF ratio with the reference's 1e-5 stabilizers."""
    inv_s = 1.0 / s_val
    iter_cos = -torch.clamp(-true_cos, min=0.0)
    est_next = sdf + iter_cos * dist * 0.5
    est_prev = sdf - iter_cos * dist * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    p = prev_cdf - next_cdf
    c = prev_cdf
    return torch.clamp((p + 1e-5) / (c + 1e-5), 0.0, 1.0)
