"""LPIPS (v0.1, AlexNet trunk) in plain PyTorch.

The port's own copy of ``fgs_nerf_tpu/eval/lpips_native.py``: the same
names, environment variables, shape checks and math, with ``F.conv2d``
and ``F.max_pool2d`` in place of the ``lax`` calls.  The weights come
from ONE local ``.npz`` named by ``FGS_LPIPS_WEIGHTS`` (written once by
``scripts/export_lpips_weights.py`` where ``lpips`` and ``torchvision``
are installed); without it, a deterministic random-feature fallback
drawn from ``np.random.default_rng(0)`` in the same order as the JAX
module, so both packages get bit-equal weights.  ``FGS_LPIPS_FALLBACK=0``
turns the fallback off.

Math (LPIPS v0.1): images scaled to [-1, 1], ImageNet shift/scale,
AlexNet convs with taps after each ReLU (3x3 / stride-2 max pools after
taps 0 and 1), per-channel unit normalisation, squared difference,
non-negative 1x1 linear head per tap, spatial mean, sum over taps.  The
convolutions run with cuDNN's TF32 off (float32 as on the reference's
CPU path), without changing the global setting.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device

# AlexNet feature trunk (torchvision layout): (out, in, k, stride, pad),
# with 3x3/stride-2 max pools after taps 0 and 1.
_ALEX = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# (weights path or "<fallback>", device) -> weights as tensors on device
_CACHE: Dict[Tuple[str, str], Dict[str, torch.Tensor]] = {}


def weights_path() -> Optional[str]:
    p = os.environ.get("FGS_LPIPS_WEIGHTS")
    return p if p and os.path.exists(p) else None


def fallback_enabled() -> bool:
    """Weights-free fallback gate (on unless FGS_LPIPS_FALLBACK=0)."""
    return os.environ.get("FGS_LPIPS_FALLBACK", "1") not in (
        "0", "False", "false"
    )


def _fallback_weights() -> Dict[str, np.ndarray]:
    """Deterministic random-feature weights (seed 0, He-init convs,
    uniform linear heads), drawn in the JAX module's order.  A stand-in
    for the pretrained AlexNet+LPIPS weights: reproducible, usable for
    regression tracking and relative comparisons, NOT comparable to
    published LPIPS numbers."""
    rng = np.random.default_rng(0)
    w: Dict[str, np.ndarray] = {}
    for i, (co, ci, k, _, _) in enumerate(_ALEX):
        w[f"conv{i}_w"] = (
            rng.normal(size=(co, ci, k, k)).astype(np.float32)
            * np.sqrt(2.0 / (ci * k * k))
        )
        w[f"conv{i}_b"] = np.zeros(co, np.float32)
        w[f"lin{i}"] = np.full((co,), 1.0 / co, np.float32)
    return w


def load_weights(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        w = {k: z[k] for k in z.files}
    for i, (co, ci, k, _, _) in enumerate(_ALEX):
        if w[f"conv{i}_w"].shape != (co, ci, k, k):
            raise ValueError(
                f"conv{i}_w shape {w[f'conv{i}_w'].shape} != {(co, ci, k, k)}"
            )
        if w[f"lin{i}"].shape != (co,):
            raise ValueError(f"lin{i} shape {w[f'lin{i}'].shape} != ({co},)")
    return w


def _features(x: torch.Tensor, w: Dict[str, torch.Tensor]):
    """x: [1, 3, H, W] in [-1, 1] -> list of 5 tap tensors."""
    shift = torch.as_tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)
    h = (x - shift) / scale
    taps = []
    for i, (_, _, _, stride, pad) in enumerate(_ALEX):
        h = F.conv2d(h, w[f"conv{i}_w"], stride=stride, padding=pad)
        h = torch.relu(h + w[f"conv{i}_b"].reshape(1, -1, 1, 1))
        taps.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, kernel_size=3, stride=2)
    return taps


def _distance(im0: torch.Tensor, im1: torch.Tensor,
              w: Dict[str, torch.Tensor]) -> torch.Tensor:
    t0 = _features(im0, w)
    t1 = _features(im1, w)
    total = torch.zeros((), device=im0.device)
    for i, (a, b) in enumerate(zip(t0, t1)):
        na = a / torch.sqrt(torch.sum(a**2, dim=1, keepdim=True) + 1e-10)
        nb = b / torch.sqrt(torch.sum(b**2, dim=1, keepdim=True) + 1e-10)
        d = (na - nb) ** 2  # [1, C, H', W']
        lin = torch.clamp(w[f"lin{i}"], min=0.0).reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum(d * lin, dim=1))
    return total


def _weights_on(path: Optional[str], dev: torch.device):
    key = (path or "<fallback>", str(dev))
    if key not in _CACHE:
        if path is None:
            warnings.warn(
                "FGS_LPIPS_WEIGHTS is not set — LPIPS is running on the "
                "DETERMINISTIC RANDOM-FEATURE fallback (fixed-seed conv "
                "trunk, same metric math).  Values are reproducible and "
                "usable for regression tracking, but NOT comparable to "
                "published LPIPS numbers.  Export the pretrained weights "
                "once with scripts/export_lpips_weights.py to match the "
                "reference metric exactly.",
                stacklevel=3,
            )
            w = _fallback_weights()
        else:
            w = load_weights(path)
        _CACHE[key] = {k: torch.as_tensor(np.asarray(v, np.float32),
                                          device=dev)
                       for k, v in w.items()}
    return _CACHE[key]


@torch.no_grad()
def lpips_native(np_gt: np.ndarray, np_im: np.ndarray,
                 device: DeviceLike = None) -> Optional[float]:
    """LPIPS(alex) of two [H, W, 3] float images in [0, 1], computed on
    ``device`` (the card unless the caller asks for the CPU).

    Uses the exported pretrained weights when ``FGS_LPIPS_WEIGHTS`` is
    set; otherwise the deterministic random-feature fallback (one-time
    warning per device).  Returns None only when the fallback is
    disabled via ``FGS_LPIPS_FALLBACK=0`` and no weights file exists."""
    path = weights_path()
    if path is None and not fallback_enabled():
        return None
    dev = resolve_device(device)
    w = _weights_on(path, dev)

    def chw(x):
        return torch.as_tensor(np.transpose(
            np.asarray(x, np.float32) * 2.0 - 1.0, (2, 0, 1))[None],
            device=dev)

    cudnn = torch.backends.cudnn
    # flags() resets every argument it is not given: keep the others
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return float(_distance(chw(np_gt), chw(np_im), w))
