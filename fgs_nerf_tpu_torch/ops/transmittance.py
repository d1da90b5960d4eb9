"""Masked transmittance scan with early exit and a hand-written backward.

Port of ``fgs_nerf_tpu/ops/transmittance.py:24-118``.  Two reference
quirks are kept: the early exit (a ray stops once its running
transmittance drops below 1e-3, and later samples get zero weight and
zero gradient) and the backward guard ``max(1 - a, 1e-10)``.  The scan
is the same Hillis-Steele shifted scan as the JAX package (not
``torch.cumprod``): the early-exit predicate is knife-edge on the
product's reassociation, and the same association keeps CPU parity
tight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EARLY_EXIT_T = 1e-3
_GUARD = 1e-10


def _scan_last(x: torch.Tensor, op, identity: float,
               reverse: bool = False) -> torch.Tensor:
    """Hillis-Steele inclusive scan along the last axis
    (`ops/transmittance.py:28-53`)."""
    s = x.shape[-1]
    y = x
    shift = 1
    while shift < s:
        if reverse:
            shifted = F.pad(y[..., shift:], (0, shift), value=identity)
        else:
            shifted = F.pad(y[..., :-shift], (shift, 0), value=identity)
        y = op(y, shifted)
        shift *= 2
    return y


def _exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    c = _scan_last(x, torch.mul, 1.0)
    return torch.cat([torch.ones_like(c[..., :1]), c[..., :-1]], dim=-1)


def _forward(alpha: torch.Tensor, valid: torch.Tensor):
    zero = torch.zeros((), dtype=alpha.dtype, device=alpha.device)
    a = torch.where(valid, alpha, zero)
    t_excl = _exclusive_cumprod(1.0 - a)
    processed = (t_excl >= EARLY_EXIT_T) & valid
    a_eff = torch.where(processed, a, zero)
    t = _exclusive_cumprod(1.0 - a_eff)
    weights = t * a_eff
    alphainv_last = torch.prod(1.0 - a_eff, dim=-1)
    return weights, alphainv_last, t, processed, a_eff


class _AlphaToWeights(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, valid):
        weights, alphainv_last, t, processed, a_eff = _forward(alpha, valid)
        ctx.save_for_backward(weights, alphainv_last, t, processed, a_eff)
        ctx.mark_non_differentiable(processed)
        return weights, alphainv_last

    @staticmethod
    def backward(ctx, g_w, g_last):
        weights, alphainv_last, t, processed, a_eff = ctx.saved_tensors
        zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
        if g_w is None:
            g_w = torch.zeros_like(weights)
        if g_last is None:
            g_last = torch.zeros_like(alphainv_last)
        g_w = torch.where(processed, g_w, zero)
        gww = g_w * weights
        suffix = _scan_last(gww, torch.add, 0.0, reverse=True) - gww
        back_cum = g_last[..., None] * alphainv_last[..., None] + suffix
        grad_alpha = g_w * t - back_cum / torch.clamp(1.0 - a_eff, min=_GUARD)
        grad_alpha = torch.where(processed, grad_alpha, zero)
        return grad_alpha, None


def alpha_to_weights(alpha: torch.Tensor, valid: torch.Tensor):
    """[N, S] alphas (+ bool validity) -> (weights [N, S],
    alphainv_last [N]) (`ops/transmittance.py:83-118`)."""
    return _AlphaToWeights.apply(alpha, valid)
