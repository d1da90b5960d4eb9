"""Image scores of the plain reference: PSNR and SSIM (the Gaussian
11 x 11, sigma 1.5 window of mip-NeRF's SSIM, 'valid' borders,
k1 = 0.01, k2 = 0.03), in float64 PyTorch on the host (``dtype`` lowers it for the control)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(img: np.ndarray, gt: np.ndarray, dtype=torch.float64) -> float:
    a = torch.as_tensor(img).to(dtype)
    b = torch.as_tensor(gt).to(dtype)
    return float(-10.0 * torch.log10(torch.mean((a - b) ** 2)))


def ssim(img: np.ndarray, gt: np.ndarray, max_val: float = 1.0,
         dtype=torch.float64) -> float:
    a = torch.as_tensor(img).to(dtype).permute(2, 0, 1)[:, None]
    b = torch.as_tensor(gt).to(dtype).permute(2, 0, 1)[:, None]
    x = torch.arange(11, dtype=dtype) - 5
    g = torch.exp(-0.5 * (x / 1.5) ** 2)
    g = g / g.sum()

    def blur(z):
        z = F.conv2d(z, g.reshape(1, 1, 11, 1))
        return F.conv2d(z, g.reshape(1, 1, 1, 11))

    mu0, mu1 = blur(a), blur(b)
    s00 = torch.clamp(blur(a * a) - mu0 * mu0, min=0.0)
    s11 = torch.clamp(blur(b * b) - mu1 * mu1, min=0.0)
    s01 = blur(a * b) - mu0 * mu1
    s01 = torch.sign(s01) * torch.minimum(torch.sqrt(s00 * s11), s01.abs())
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    m = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)
         / ((mu0 * mu0 + mu1 * mu1 + c1) * (s00 + s11 + c2)))
    return float(m.mean())
