"""Frozen copy of the stage schedules (``fgs_nerf_tpu_torch/train/
schedules.py`` and ``ops/sdf2alpha.py:s_val_schedule``, themselves copies
of the upstream ``model/nerf_training.py:389-456``): learning rates,
their end-of-step update, the TV gate, TV updates and the s value."""
from __future__ import annotations

import math
from typing import Dict, Mapping


def initial_lrs(cfg_train: Mapping, names) -> Dict[str, float]:
    return {k[len("lrate_"):]: float(v) for k, v in cfg_train.items()
            if k.startswith("lrate_") and k != "lrate_decay"
            and k[len("lrate_"):] in names and v > 0}


def _cosine(it, wu, wu_min, max_steps, const_wu=False, min_ratio=0.0):
    if it < wu:
        return wu_min if const_wu else wu_min + (1 - wu_min) * (it / wu)
    return ((1 + math.cos((it - wu) / (max_steps - wu) * math.pi)) * 0.5
            * (1 - min_ratio) + min_ratio)


def update_lrs(lrs: Dict[str, float], global_step: int, cfg_train: Mapping):
    """End-of-step update: decay (exponential or cosine ratio), then the
    ``decay_step_module`` factors keyed on ``global_step - 1``."""
    n_iters = int(cfg_train["N_iters"])
    if not cfg_train.get("cosine_lr", False):
        f = 0.1 ** (1.0 / (cfg_train["lrate_decay"] * 1000.0))
    else:
        c = cfg_train.get("cosine_lr_cfg", {})
        args = (c.get("warm_up_iters", 0), c.get("warm_up_min_ratio", 1.0),
                n_iters, c.get("const_warm_up", False),
                c.get("cos_min_ratio", False) or 0.0)
        gs = global_step - 1
        pre = 1.0 if global_step == 0 else _cosine(gs - 1, *args)
        f = _cosine(gs, *args) / pre
    for k in lrs:
        lrs[k] *= f
    for name, factor in cfg_train.get("decay_step_module", {}).get(
            global_step - 1, {}).items():
        if name in lrs:
            lrs[name] *= factor


def tv_active(global_step: int, cfg_train: Mapping) -> bool:
    return (cfg_train["tv_from"] < global_step < cfg_train["tv_end"]
            and global_step % cfg_train["tv_every"] == 0)


def apply_tv_updates(tv_terms: Dict, global_step: int, cfg_train: Mapping):
    tv_terms.update(cfg_train.get("tv_updates", {}).get(global_step - 1, {}))


def s_val(global_step: int, model: Mapping) -> float:
    """``s_ratio / (step + s_ratio / s_start - step_start)`` in float32."""
    import numpy as np

    step = np.float32(global_step)
    s_ratio, s_start = model.get("s_ratio", 50.0), model.get("s_start", 0.05)
    return float(np.float32(s_ratio) / (step + np.float32(s_ratio / s_start)
                                        - np.float32(model.get("step_start", 0))))
