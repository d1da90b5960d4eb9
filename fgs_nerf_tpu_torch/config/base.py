"""Configuration system.

The reference drives everything from mmcv python-dict configs with
load-bearing conventions (SURVEY.md §5.6): per-stage ``(<stage>_model,
<stage>_train)`` blocks, ``lrate_<attr>`` keys consumed by
attribute-name reflection in the optimizer factory
(`model/nerf_training.py:9-37`), and step-indexed dict schedules.  We
keep the same schema as plain nested dicts wrapped in a light accessor,
because the schedules are load-bearing for reproducing results.
"""
from __future__ import annotations

import copy
import importlib.util
from typing import Any, Dict


class Cfg(dict):
    """dict with attribute access (mmcv-Config-alike, read side only)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Cfg(v) if isinstance(v, dict) and not isinstance(v, Cfg) else v

    def get(self, k, default=None):
        v = super().get(k, default)
        return Cfg(v) if isinstance(v, dict) and not isinstance(v, Cfg) else v


def deep_update(base: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path_or_name: str) -> Cfg:
    """Load a config: a built-in name ('shiny_blender', 'dtu',
    'smart_car') or a path to a python file defining ``config``."""
    from fgs_nerf_tpu_torch.config import scenes

    builtin = getattr(scenes, path_or_name.upper(), None)
    if builtin is not None:
        return Cfg(copy.deepcopy(builtin))
    import os

    if not os.path.isfile(path_or_name):
        names = [n.lower() for n in dir(scenes) if n.isupper()]
        raise FileNotFoundError(
            f"config {path_or_name!r} is neither a built-in "
            f"({', '.join(sorted(names))}) nor an existing python file"
        )
    spec = importlib.util.spec_from_file_location("user_config", path_or_name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if hasattr(mod, "config"):
        return Cfg(copy.deepcopy(mod.config))
    # mmcv-style module namespace config: collect module-level dicts/scalars
    ns = {
        k: v for k, v in vars(mod).items()
        if not k.startswith("_") and not callable(v) and not isinstance(v, type(mod))
    }
    return Cfg(copy.deepcopy(ns))


STAGES = ("geometry_searching", "coarse", "fine")


def stage_blocks(cfg: Cfg, stage: str):
    """(cfg_model, cfg_train) for a stage, following the reference's
    naming: geometry_searching / geometry_searching_model, coarse_model /
    coarse_train, fine_model / fine_train (`run.py:31-85`)."""
    if stage == "geometry_searching":
        return cfg.geometry_searching_model, cfg.geometry_searching
    return cfg[f"{stage}_model"], cfg[f"{stage}_train"]
