"""Masked / per-voxel Adam as a functional update.

Port of ``fgs_nerf_tpu/optim/masked_adam.py:30-123``: bias correction
folded into the step size, ``skip_zero_grad`` groups leave the parameter
and both moments untouched where the gradient is exactly zero, and a
per-voxel learning-rate array scales the step where given.  Parameters
are dicts ``{group: tensor or dict of tensors}``.

A leaf on the CPU takes :func:`adam_leaf`, the plain version; a leaf on
a CUDA device takes its kernel, ``ops/cuda/masked_adam.py``
(``csrc/masked_adam.cu``: one pass a leaf, bit-equal to
:func:`adam_leaf` on the card).  ``adam_update`` counts the elements it
updates (``adam_elems``) and those the kernel updated
(``adam_fused_elems``) with the span recorder.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from fgs_nerf_tpu_torch.ops.cuda.masked_adam import masked_adam_step
from fgs_nerf_tpu_torch.utils.profiling import count


@dataclasses.dataclass(frozen=True)
class ParamOpts:
    """Static per-parameter-group options (`optim/masked_adam.py:30-35`)."""

    skip_zero_grad: bool = False
    has_per_lr: bool = False


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor  # [] int32, shared step count
    exp_avg: Any        # same structure as params
    exp_avg_sq: Any


def tree_map(fn, *trees):
    """Map over matching dict-of-tensors structures."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_state(params: Any) -> AdamState:
    dev = next(iter(tree_leaves(params))).device
    return AdamState(
        torch.zeros((), dtype=torch.int32, device=dev),
        tree_map(torch.zeros_like, params),
        tree_map(torch.zeros_like, params),
    )


def tree_leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves(tree[k])
    else:
        yield tree


def adam_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, lr: torch.Tensor, bias: torch.Tensor,
              plr: Optional[torch.Tensor], skip_zero_grad: bool,
              beta1: float, beta2: float, eps: float):
    """One leaf's (p', m', v'), plain PyTorch: the twin of the kernel
    ``ops/cuda/masked_adam.py:masked_adam_step``, which repeats every
    rounding of it."""
    m_n = beta1 * m + (1.0 - beta1) * g
    v_n = beta2 * v + (1.0 - beta2) * g * g
    step_scale = lr * bias
    if plr is not None:
        step_scale = step_scale * plr
    p_n = p - step_scale * m_n / (torch.sqrt(v_n) + eps)
    if skip_zero_grad:
        live = g != 0.0
        p_n = torch.where(live, p_n, p)
        m_n = torch.where(live, m_n, m)
        v_n = torch.where(live, v_n, v)
    return p_n, m_n, v_n


def adam_update(params: Dict[str, Any], grads: Dict[str, Any],
                state: AdamState, lrs: Dict[str, Any],
                opts: Dict[str, ParamOpts], per_lr: Optional[Dict] = None,
                beta1: float = 0.9, beta2: float = 0.99, eps: float = 1e-8):
    """One Adam step (`optim/masked_adam.py:59-123`); groups missing
    from ``lrs`` are frozen.  Returns (new_params, new_state)."""
    step = state.step + 1
    t = step.to(torch.float32)
    bias = torch.sqrt(1.0 - torch.pow(beta2, t)) / (1.0 - torch.pow(beta1, t))

    new_p, new_m, new_v = {}, {}, {}
    elems = {"adam_elems": 0, "adam_fused_elems": 0}
    for name, p in params.items():
        if name not in lrs:
            new_p[name] = p
            new_m[name] = state.exp_avg[name]
            new_v[name] = state.exp_avg_sq[name]
            continue
        o = opts.get(name, ParamOpts())
        lr = torch.as_tensor(lrs[name], dtype=torch.float32, device=t.device)
        plr = per_lr.get(name) if (per_lr and o.has_per_lr) else None

        def leaf(p_l, g_l, m_l, v_l, plr_l=None):
            elems["adam_elems"] += p_l.numel()
            fn = adam_leaf
            if p_l.is_cuda:
                elems["adam_fused_elems"] += p_l.numel()
                fn = masked_adam_step
            return fn(p_l, g_l, m_l, v_l, lr, bias, plr_l, o.skip_zero_grad,
                      beta1, beta2, eps)

        trees = (p, grads[name], state.exp_avg[name], state.exp_avg_sq[name])
        if plr is not None:
            trees = trees + (plr,)
        out = tree_map(leaf, *trees)  # (p, m, v) tuples at the leaves
        new_p[name] = tree_map(lambda x: x[0], out)
        new_m[name] = tree_map(lambda x: x[1], out)
        new_v[name] = tree_map(lambda x: x[2], out)
    for k, n in elems.items():
        count(k, n)
    return new_p, AdamState(step, new_m, new_v)
