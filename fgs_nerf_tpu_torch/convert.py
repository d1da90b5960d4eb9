"""Carry parameters and Adam state across the JAX / PyTorch boundary.

The public layouts are the JAX package's: ``sdf [X, Y, Z, 1]``,
``k0 [X, Y, Z, k0_dim]`` (or, for ``grid_type='tensorf'``, the factor
dict ``{xy_plane, xz_plane, yz_plane, x_vec, y_vec, z_vec[, f_vec]}``),
``refnet {w{i} [in, out], b{i} [out]}``, ``s_val [1]``, the DVGO
stage's ``density [X, Y, Z, 1]`` and ``k0 [X, Y, Z, 3]``, all float32;
nested dicts are carried whole.  Both directions go through numpy, so
this module imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device
from fgs_nerf_tpu_torch.optim.masked_adam import AdamState, tree_map


def params_from_jax(np_params: Dict[str, Any],
                    device: DeviceLike = None) -> Dict[str, Any]:
    """numpy (or array-like) parameter tree -> torch tensors on
    ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=dev),
        dict(np_params))


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """torch parameter tree -> numpy float32 tree."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def adam_state_from_jax(step, exp_avg: Dict[str, Any],
                        exp_avg_sq: Dict[str, Any],
                        device: DeviceLike = None) -> AdamState:
    """The JAX ``AdamState`` fields (as numpy) -> the port's state."""
    dev = resolve_device(device)
    return AdamState(
        torch.as_tensor(np.asarray(step, dtype=np.int32), device=dev),
        params_from_jax(exp_avg, dev),
        params_from_jax(exp_avg_sq, dev),
    )


def adam_state_to_numpy(state: AdamState) -> Tuple[np.ndarray, Dict, Dict]:
    """The port's Adam state -> (step, exp_avg, exp_avg_sq) as numpy."""
    return (state.step.cpu().numpy(), params_to_numpy(state.exp_avg),
            params_to_numpy(state.exp_avg_sq))
