"""Checkpoint schema and stage-handoff artifacts.

Port of ``fgs_nerf_tpu/train/checkpoint.py`` with the same file format,
so each package reads the other's files: a pickle-free
``np.savez_compressed`` archive of flattened float32 arrays
(``params/<group>[/<leaf>]``, ``opt/exp_avg/...``, ``opt/exp_avg_sq/...``,
``opt/step``, ``artifacts/sdf_mask``) plus a JSON ``meta_json`` blob
(``format_version`` 1).  The ``sdf_mask`` lets the next stage build its
mask cache and shrink its bbox from the file alone.  Tensors are copied
to the host here and nowhere else in the stage loop.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(prefix: str, tree: Any, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}", v, out)
    elif tree is not None:
        out[prefix] = _to_host(tree)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _json_default(o):
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, (np.ndarray, torch.Tensor)):
        return _to_host(o).tolist()
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(f"not json-serializable: {type(o)}")


def save_checkpoint(path: str, *, global_step: int, params: Dict[str, Any],
                    opt_state: Optional[Any] = None,
                    sdf_mask: Optional[torch.Tensor] = None,
                    model_kwargs: Optional[Dict[str, Any]] = None,
                    xyz_min=None, xyz_max=None,
                    lrs: Optional[Dict[str, float]] = None,
                    mesh=None) -> None:
    """Write one stage checkpoint (`train/checkpoint.py:62-110`);
    ``opt_state`` is the port's ``AdamState``.  The file appears under
    ``path`` only once complete (write to ``.tmp``, then rename).  Under
    a ``mesh`` every rank calls it with the full trees (grid slabs
    gathered first, ``parallel/spatial_train.py:gather_spatial``): rank 0
    writes and every rank waits until the file is there."""
    from fgs_nerf_tpu_torch.parallel.mesh import barrier, is_writer

    if is_writer(mesh):
        _write(path, global_step, params, opt_state, sdf_mask, model_kwargs,
               xyz_min, xyz_max, lrs)
    barrier(mesh)


def _write(path, global_step, params, opt_state, sdf_mask, model_kwargs,
           xyz_min, xyz_max, lrs) -> None:
    flat: Dict[str, np.ndarray] = {}
    _flatten("params", params, flat)
    if opt_state is not None:
        _flatten("opt/exp_avg", opt_state.exp_avg, flat)
        _flatten("opt/exp_avg_sq", opt_state.exp_avg_sq, flat)
        flat["opt/step"] = _to_host(opt_state.step)
    if sdf_mask is not None:
        flat["artifacts/sdf_mask"] = _to_host(sdf_mask)
    meta = {
        "global_step": int(global_step),
        "model_kwargs": model_kwargs or {},
        "xyz_min": None if xyz_min is None else _to_host(xyz_min).tolist(),
        "xyz_max": None if xyz_max is None else _to_host(xyz_max).tolist(),
        "lrs": lrs or {},
        "format_version": 1,
    }
    flat["meta_json"] = np.frombuffer(
        json.dumps(meta, default=_json_default).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **flat)
    os.replace(tmp, path)


class Checkpoint:
    """A loaded checkpoint: numpy trees ``params``, ``opt``,
    ``artifacts`` and the ``meta`` dict (`train/checkpoint.py:127-152`)."""

    def __init__(self, path: str):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        self.meta = json.loads(bytes(flat.pop("meta_json").tobytes()).decode())
        tree = _unflatten(flat)
        self.params = tree.get("params", {})
        self.opt = tree.get("opt", None)
        self.artifacts = tree.get("artifacts", {})

    @property
    def global_step(self) -> int:
        return self.meta["global_step"]

    @property
    def sdf_mask(self) -> Optional[np.ndarray]:
        return self.artifacts.get("sdf_mask")

    @property
    def box(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.asarray(self.meta["xyz_min"], np.float32),
                np.asarray(self.meta["xyz_max"], np.float32))


def load_checkpoint(path: str) -> Checkpoint:
    return Checkpoint(path)
