"""Chunked full-image rendering and evaluation.

Port of ``fgs_nerf_tpu/eval/render.py:25-193``: a view's rays are cut
into fixed 8,192-ray chunks (the last one padded by repeating its last
ray) and rendered by the lattice engine, whatever engine the stage
trained with (the sorted engine is a training path); each image gets
PSNR with foreground / background splits and SSIM, and, with a
``savedir``, the image, error, normal, depth and background dumps as
PNG files (``eval/image_io.py``); ``eval_lpips=True`` adds LPIPS(alex)
(and LPIPS(vgg) where available: never in the port) computed on the
parameters' device (``eval/metrics.py:rgb_lpips``).  Spans
(``utils/profiling.py``): ``render_view`` a view, inside it ``rays``,
``to_host`` a chunk, ``score`` and ``save``.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.data.rays import get_rays_of_a_view
from fgs_nerf_tpu_torch.eval import metrics as metrics_lib
from fgs_nerf_tpu_torch.eval.image_io import write_png
from fgs_nerf_tpu_torch.models import sdf_voxel as M
from fgs_nerf_tpu_torch.utils.profiling import span

_OUT_KEYS = ("rgb_marched", "depth", "disp", "alphainv_cum", "normal_marched",
             "overflow")


def make_render_fn(cfg_model, box: SceneBox, near: float, bg: float):
    """``render_chunk(params, buffers, rays_o, rays_d, viewdirs, s_val)``
    -> the image-level outputs of one chunk, on the lattice engine, with
    no autograd graph (`eval/render.py:25-52`)."""
    if cfg_model.engine != "lattice":
        cfg_model = dataclasses.replace(cfg_model, engine="lattice")

    @torch.no_grad()
    def render_chunk(params, buffers, rays_o, rays_d, viewdirs, s_val):
        out = M.forward(params, buffers, cfg_model, box, rays_o, rays_d,
                        viewdirs, s_val, near=near, bg=bg)
        return {k: out[k] for k in _OUT_KEYS}

    return render_chunk


def render_image(render_chunk, params, buffers, h, w, k, c2w, conv: Dict,
                 s_val, chunk: int = 8192) -> Dict[str, np.ndarray]:
    """One view through ``render_chunk`` -> numpy [H, W(, C)] outputs
    and the overflowed-ray fraction (`eval/render.py:55-87`).  Rays go to
    the device of ``params['sdf']``."""
    with span("rays"):
        rays_o, rays_d, viewdirs = get_rays_of_a_view(h, w, k, c2w, **conv)
        o = rays_o.reshape(-1, 3)
        d = rays_d.reshape(-1, 3)
        v = viewdirs.reshape(-1, 3)
        n = len(o)
        pad = (-n) % chunk
        if pad:
            o = np.concatenate([o, np.repeat(o[-1:], pad, 0)])
            d = np.concatenate([d, np.repeat(d[-1:], pad, 0)])
            v = np.concatenate([v, np.repeat(v[-1:], pad, 0)])
    dev = params["sdf"].device
    sv = torch.as_tensor(s_val, dtype=torch.float32, device=dev)
    outs = []
    for s in range(0, n + pad, chunk):
        sl = slice(s, s + chunk)
        res = render_chunk(params, buffers,
                           *(torch.as_tensor(a[sl], device=dev)
                             for a in (o, d, v)), sv)
        with span("to_host"):
            outs.append({key: val.cpu().numpy()
                         for key, val in res.items()})
    cat = {key: np.concatenate([ot[key] for ot in outs])[:n] for key in outs[0]}
    result = {}
    for key, val in cat.items():
        result[key] = val.reshape(h, w, -1) if val.ndim > 1 else val.reshape(h, w)
    if "overflow" in result:
        result["overflow_frac"] = float(np.mean(result.pop("overflow")))
    return result


def matte(vis, bgmap, dark=1.0, light=1.0, width=8):
    """Checkerboard matte for non-accumulated pixels
    (`eval/render.py:90-101`)."""
    acc = 1.0 - bgmap
    bg_mask = np.logical_xor(
        (np.arange(acc.shape[0]) % (2 * width) // width)[:, None],
        (np.arange(acc.shape[1]) % (2 * width) // width)[None, :],
    )
    bg = np.where(~bg_mask, light, dark)[..., None]
    if acc.ndim == 2:
        acc = acc[..., None]
    return vis * acc + bg * (1 - acc)


def _save_view(savedir, pre, i, res, rgb, gt):
    """The image dumps of one view (`eval/render.py:145-182`)."""
    write_png(os.path.join(savedir, f"{pre}render_{i:03d}.png"),
              metrics_lib.to8b(rgb))
    if gt is not None:
        gt8 = metrics_lib.to8b(gt)
        err = 1 - np.exp(-20 * np.square(rgb - gt).sum(-1))
        err8 = metrics_lib.to8b(np.repeat(err[..., None], 3, -1))
        write_png(os.path.join(savedir, f"{pre}gt_{i:03d}.png"), gt8)
        write_png(os.path.join(savedir, f"{pre}{i:03d}.png"),
                  np.concatenate([err8, metrics_lib.to8b(rgb), gt8], axis=0))
    bgmap = res["alphainv_cum"]
    normal_vis = matte(res["normal_marched"] / 2.0 + 0.5, bgmap[..., None])
    write_png(os.path.join(savedir, f"{pre}_normal_{i:03d}.png"),
              metrics_lib.to8b(normal_vis))
    depth = res["depth"]
    dmax = float(depth.max()) or 1.0
    depth_vis = matte((depth / dmax)[..., None], bgmap[..., None])
    write_png(os.path.join(savedir, f"{pre}_depth_{i:03d}.png"),
              metrics_lib.to8b(np.repeat(depth_vis, 3, axis=-1)))
    write_png(os.path.join(savedir, f"{pre}_bgmap_{i:03d}.png"),
              metrics_lib.to8b(np.asarray(bgmap)[..., None].repeat(3, -1)))


def render_viewpoints(render_chunk, params, buffers, poses, hw, ks, conv: Dict,
                      s_val, gt_imgs=None, masks=None,
                      savedir: Optional[str] = None, eval_ssim=True,
                      eval_lpips=False, logger=None, step: int = 0
                      ) -> Dict[str, list]:
    """Render and score every pose (`eval/render.py:104-193`)."""
    log = logger or logging.getLogger("fgs")
    stats = {"psnr": [], "fore_psnr": [], "bg_psnr": [], "ssim": [],
             "lpips_alex": [], "lpips_vgg": [], "rgbs": []}
    if savedir:
        os.makedirs(savedir, exist_ok=True)
    for i, c2w in enumerate(poses):
        with span("render_view"):
            h, w = int(hw[i][0]), int(hw[i][1])
            res = render_image(render_chunk, params, buffers, h, w, ks[i],
                               c2w, conv, s_val)
            rgb = res["rgb_marched"]
            stats["rgbs"].append(rgb)
            ovf = res.get("overflow_frac", 0.0)
            if ovf > 0:
                log.warning(
                    f"view {i}: {ovf:.2%} of rays overflowed the shading/"
                    f"sample capacity (shade_k/sample_k) — rendered images "
                    f"are biased; raise the capacities (or set -1 for exact)")
            gt = None
            if gt_imgs is not None:
                gt = np.asarray(gt_imgs[i])
                mask = None if masks is None else np.asarray(masks[i])
                with span("score"):
                    p, fore, back = metrics_lib.psnr_splits(rgb, gt, mask)
                    stats["psnr"].append(p)
                    stats["fore_psnr"].append(fore)
                    stats["bg_psnr"].append(back)
                    if eval_ssim:
                        stats["ssim"].append(
                            metrics_lib.rgb_ssim(rgb, gt, max_val=1))
                    if eval_lpips:
                        dev = params["sdf"].device
                        la = metrics_lib.rgb_lpips(gt, rgb, "alex", device=dev)
                        lv = metrics_lib.rgb_lpips(gt, rgb, "vgg", device=dev)
                        if la is not None:
                            stats["lpips_alex"].append(la)
                        if lv is not None:
                            stats["lpips_vgg"].append(lv)
                log.info(f"view {i}: psnr {p:.2f} fore {fore:.2f} "
                         f"bg {back:.2f}")
            if savedir:
                with span("save"):
                    _save_view(savedir, f"{step}_" if step else "", i, res,
                               rgb, gt)
    if stats["psnr"]:
        msg = (f"Testing psnr {np.mean(stats['psnr']):.2f} (avg) | "
               f"foreground {np.mean(stats['fore_psnr']):.2f} | "
               f"background {np.mean(stats['bg_psnr']):.2f}")
        if stats["ssim"]:
            msg += f" | ssim {np.mean(stats['ssim']):.4f}"
        log.info(msg)
    return stats
