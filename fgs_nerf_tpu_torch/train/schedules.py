"""Host-side training schedules: LR decay, cosine LR, step-indexed
events, the s-value schedule gate, and the TV gate.

These replicate the mutable schedule logic of
`model/nerf_training.py:389-456` exactly; every quantity is computed on
host and fed to the jitted step as a scalar, so schedule changes never
retrace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional


@dataclasses.dataclass
class LrState:
    """Per-group current learning rates, mutated step by step like the
    reference's ``param_group['lr']``."""

    lrs: Dict[str, float]

    def copy(self) -> "LrState":
        return LrState(dict(self.lrs))


def initial_lrs(cfg_train: Mapping, param_names) -> Dict[str, float]:
    """`create_optimizer_or_freeze_model` (`model/nerf_training.py:9-37`)
    with global_step=0: base ``lrate_<name>`` for every matching,
    positive-lr parameter group."""
    out = {}
    for key, val in cfg_train.items():
        if not key.startswith("lrate_") or key == "lrate_decay":
            continue
        name = key[len("lrate_"):]
        if name in param_names and val > 0:
            out[name] = float(val)
    return out


def exp_decay_factor(lrate_decay: float) -> float:
    """Per-step multiplicative decay 0.1^(1/(lrate_decay*1000))
    (`model/nerf_training.py:392-396`)."""
    return 0.1 ** (1.0 / (lrate_decay * 1000.0))


def cosine_lr_func(
    it: int, warm_up_iters: int, warm_up_min_ratio: float, max_steps: int,
    const_warm_up: bool = False, min_ratio: float = 0.0,
) -> float:
    """`model/nerf_training.py:398-407`."""
    if it < warm_up_iters:
        if not const_warm_up:
            return warm_up_min_ratio + (1 - warm_up_min_ratio) * (it / warm_up_iters)
        return warm_up_min_ratio
    return (
        1 + math.cos((it - warm_up_iters) / (max_steps - warm_up_iters) * math.pi)
    ) * 0.5 * (1 - min_ratio) + min_ratio


def update_lrs(
    lr_state: LrState,
    global_step: int,
    cfg_train: Mapping,
) -> None:
    """End-of-step LR update (`model/nerf_training.py:389-436`):
    exponential decay (or cosine ratio-multiplicative), then the
    step-indexed ``decay_step_module`` multipliers keyed on
    global_step - 1."""
    n_iters = int(cfg_train["N_iters"])
    if not cfg_train.get("cosine_lr", False):
        f = exp_decay_factor(cfg_train["lrate_decay"])
        for k in lr_state.lrs:
            lr_state.lrs[k] *= f
    else:
        c = cfg_train.get("cosine_lr_cfg", {})
        wu = c.get("warm_up_iters", 0)
        wu_min = c.get("warm_up_min_ratio", 1.0)
        const_wu = c.get("const_warm_up", False)
        min_ratio = c.get("cos_min_ratio", False) or 0.0
        gs = global_step - 1
        pre = 1.0 if global_step == 0 else cosine_lr_func(
            gs - 1, wu, wu_min, n_iters, const_wu, min_ratio
        )
        pos = cosine_lr_func(gs, wu, wu_min, n_iters, const_wu, min_ratio)
        f = pos / pre
        for k in lr_state.lrs:
            lr_state.lrs[k] *= f

    events = cfg_train.get("decay_step_module", {})
    gs = global_step - 1
    if gs in events:
        for name, factor in events[gs].items():
            if name in lr_state.lrs:
                lr_state.lrs[name] *= factor


def apply_tv_updates(tv_terms: Dict[str, float], global_step: int, cfg_train: Mapping):
    """Step-indexed mutation of tv_terms (`model/nerf_training.py:438-443`)."""
    updates = cfg_train.get("tv_updates", {})
    gs = global_step - 1
    if gs in updates:
        tv_terms.update(updates[gs])
        return True
    return False


def tv_active(global_step: int, cfg_train: Mapping) -> bool:
    """`model/nerf_training.py:330, 353`."""
    return (
        global_step > cfg_train["tv_from"]
        and global_step < cfg_train["tv_end"]
        and global_step % cfg_train["tv_every"] == 0
    )


def inc_bounds(global_step: int, cfg_train: Mapping) -> Optional[tuple]:
    """Incremental-voxel growing box (`model/nerf_training.py:200-214,
    286-293`): expands from the init ratios to the full unit cube over
    ``inc_steps``.  Returns (lower[3], upper[3]) or None when inactive."""
    if not cfg_train.get("voxel_inc", False):
        return None
    if global_step > cfg_train["inc_steps"]:
        return None  # the reference stops updating; the last box is full
    mids = [cfg_train["x_mid"], cfg_train["y_mid"], cfg_train["z_mid"]]
    ratios = [
        cfg_train["x_init_ratio"], cfg_train["y_init_ratio"], cfg_train["z_init_ratio"]
    ]
    lower0 = [m - r * m for m, r in zip(mids, ratios)]
    upper0 = [m + r * (1 - m) for m, r in zip(mids, ratios)]
    weight = min(global_step * 1.0 / cfg_train["inc_steps"], 1.0)
    lower = [l - weight * l for l in lower0]
    upper = [u + weight * (1 - u) for u in upper0]
    return lower, upper
