"""Quality metrics: PSNR with foreground/background splits, SSIM, LPIPS.

Copies of ``mse2psnr``, ``psnr_splits``, ``rgb_ssim`` and ``to8b`` from
``fgs_nerf_tpu/eval/metrics.py:16-89`` and ``:135`` (numpy and scipy;
the JAX module is free of JAX, but the port imports nothing of the JAX
package), and ``rgb_lpips`` (``:90-132``) on the port's own LPIPS(alex)
(``eval/lpips_native.py``).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log10(mse))


def psnr_splits(rgb: np.ndarray, gt: np.ndarray, mask: Optional[np.ndarray]):
    """(full, foreground, background) PSNR (`eval/metrics.py:20-32`)."""
    full = -10.0 * np.log10(np.mean(np.square(rgb - gt)))
    fore = back = 0.0
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[..., None]
        bg_rgb = rgb * (1 - mask)
        bg_gt = gt * (1 - mask)
        back = -10.0 * np.log10(np.sum(np.square(bg_rgb - bg_gt)) / np.sum(1 - mask))
        fore = -10.0 * np.log10(np.sum(np.square(rgb - gt)) / np.sum(mask))
    return float(full), float(fore), float(back)


def rgb_ssim(
    img0, img1, max_val, filter_size=11, filter_sigma=1.5, k1=0.01, k2=0.03,
    return_map=False,
):
    """SSIM, numpy (`eval/metrics.py:35-89`).

    Modified from https://github.com/google/mipnerf/blob/16e73dfdb52044dcceb47cc5101115cbc30c4e4b/internal/math.py#L58
    — a standard metric must be numerically identical, so it is kept
    verbatim with attribution.
    """
    assert len(img0.shape) == 3 and img0.shape[-1] == 3
    assert img0.shape == img1.shape
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    import scipy.signal  # slow to import; only SSIM needs it

    def convolve2d(z, f):
        return scipy.signal.convolve2d(z, f, mode="valid")

    def filt_fn(z):
        return np.stack(
            [
                convolve2d(convolve2d(z[..., i], filt[:, None]), filt[None, :])
                for i in range(z.shape[-1])
            ],
            -1,
        )

    mu0 = filt_fn(img0)
    mu1 = filt_fn(img1)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    sigma00 = filt_fn(img0**2) - mu00
    sigma11 = filt_fn(img1**2) - mu11
    sigma01 = filt_fn(img0 * img1) - mu01
    sigma00 = np.maximum(0.0, sigma00)
    sigma11 = np.maximum(0.0, sigma11)
    sigma01 = np.sign(sigma01) * np.minimum(
        np.sqrt(sigma00 * sigma11), np.abs(sigma01)
    )
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(np.mean(ssim_map))


_LPIPS_WARNED = set()


def rgb_lpips(np_gt, np_im, net_name="alex", device=None) -> Optional[float]:
    """LPIPS (`model/evaluation.py:59-74`) on ``device`` (the card
    unless the caller asks for the CPU); None when unavailable.

    'alex' is the native metric (`eval/lpips_native.py`: the weights of
    ``FGS_LPIPS_WEIGHTS``, else the seed-0 fallback unless
    ``FGS_LPIPS_FALLBACK=0``).  'vgg', and 'alex' with the fallback off
    and no weights file, give None with a once-per-net logged warning,
    as the JAX package does without the ``lpips`` package; the port
    computes LPIPS itself and never imports it."""
    if net_name == "alex":
        from fgs_nerf_tpu_torch.eval.lpips_native import lpips_native

        val = lpips_native(np_gt, np_im, device=device)
        if val is not None:
            return val
        why = "FGS_LPIPS_FALLBACK=0 and FGS_LPIPS_WEIGHTS names no file"
    else:
        why = "the port computes LPIPS(alex) only"
    if net_name not in _LPIPS_WARNED:
        _LPIPS_WARNED.add(net_name)
        logging.getLogger("fgs").warning(
            f"LPIPS({net_name}) unavailable, omitting the metric: {why}")
    return None


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)
