"""Evaluation traffic: test views rendered and scored one after another
through ``eval/render.py:render_viewpoints`` with ``make_render_fn`` (the
lattice engine, 8,192-ray chunks, SSIM on, LPIPS off), from the fine
stage's state at its final rung.

Set-up makes the state, the mask cache and nonempty mask (through
``models/sdf_voxel.py``) and the ground truth of the views the window may
reach, and renders one chunk and scores a small image to warm up.  The
window renders whole views in the ring's order from a view drawn from the
seed, until its time is up; it ends when the last view has been scored.
A traced window, where asked for, goes on with the next views.  A seeded
sample of each rendered view's pixels is then rendered by the plain
reference, and each view's PSNR and SSIM are scored again by the
reference's own code.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import counts, scene
from benchmark import trace as T
from benchmark.drivers.train import Cell as TrainCell
from benchmark.reference import image as RI
from benchmark.reference import sdf_step as R
from benchmark.reference import schedules as RS


class Cell(TrainCell):
    """The fine stage's state and the test views of the scene."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        self.test = scene.cameras(cfg["scene"], "test")
        self.n_views = len(self.test["poses"])
        self.first_view = seed % self.n_views
        self.s_val = RS.s_val(int(traffic["at_step"]), self.model)

    def view(self, i: int) -> int:
        return (self.first_view + i) % self.n_views

    def ground_truth(self, i: int) -> np.ndarray:
        h, w = self.test["hw"]
        o, d, _ = scene.view_rays(h, w, self.test["K"],
                                  self.test["poses"][self.view(i)],
                                  self.test["inverse_y"], self.dev)
        return scene.shade_sphere(o, d).reshape(h, w, 3).cpu().numpy()

    def count_cell(self) -> Dict:
        return dict(n_rays=int(self.traffic["chunk"]), model=self.model,
                    stage=self.stage, world_size=self.ws, engine="lattice")


class Program:
    def __init__(self, cell: Cell, params: Dict, fault: Optional[str] = None):
        from fgs_nerf_tpu_torch.core.box import SceneBox
        from fgs_nerf_tpu_torch.eval.render import make_render_fn
        from fgs_nerf_tpu_torch.models import sdf_voxel as M
        from fgs_nerf_tpu_torch.train.stage_common import config_passthrough

        self.cell = cell
        self.cfg_m = M.make_model_config(
            stage=cell.stage, xyz_min=cell.box[0], xyz_max=cell.box[1],
            num_voxels=cell.num_voxels,
            **config_passthrough(cell.model, M.SDFModelConfig))
        if tuple(self.cfg_m.world_size) != tuple(cell.ws):
            raise RuntimeError(f"the program's grid {self.cfg_m.world_size} is "
                               f"not the benchmark's {cell.ws}")
        box = SceneBox.create(cell.box[0], cell.box[1], cell.dev)
        buffers = {"mask_cache": M.build_mask_cache(cell.geo_mask, *cell.geo_box)}
        self.params, self.buffers = M.set_nonempty_mask(params, buffers,
                                                        self.cfg_m, box)
        render = make_render_fn(self.cfg_m, box, near=float(cell.test["near"]),
                                bg=cell.bg)
        self.chunks = 0
        per_view = -(-cell.test["hw"][0] * cell.test["hw"][1]
                     // int(cell.traffic["chunk"]))

        def counted(*args):
            with T.span("chunk"):
                out = render(*args)
            if fault == "chunk" and self.chunks % per_view == per_view // 2:
                out = dict(out, rgb_marched=1.0 - out["rgb_marched"])
            self.chunks += 1
            return out

        self.render_chunk = counted

    def score_view(self, i: int, gt: np.ndarray):
        from fgs_nerf_tpu_torch.eval.render import render_viewpoints

        c = self.cell
        j = c.view(i)
        h, w = c.test["hw"]
        conv = dict(ndc=False, inverse_y=c.test["inverse_y"], flip_x=False,
                    flip_y=False)
        stats = render_viewpoints(
            self.render_chunk, self.params, self.buffers,
            c.test["poses"][j:j + 1], np.array([[h, w]]), c.test["K"][None],
            conv, c.s_val, gt_imgs=[gt], masks=None, savedir=None,
            eval_ssim=True, eval_lpips=False)
        return stats["rgbs"][0], stats["psnr"][0], stats["ssim"][0]


def window(prog: Program, cell: Cell, gts: List, first: int, seconds: float,
           traced: bool) -> Dict:
    """Views ``first``, ``first + 1``, ... rendered and scored until
    ``seconds`` have passed; the window ends with its last view."""
    dev = cell.dev
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    views: List = []
    prog.chunks = 0
    with T.traced(dev, traced) as tr, T.span("window"):
        t0 = time.perf_counter()
        while not views or time.perf_counter() - t0 < seconds:
            i = first + len(views)
            while i >= len(gts):
                gts.append(cell.ground_truth(len(gts)))
            with T.span("view"):
                views.append(prog.score_view(i, gts[i]))
        if cuda:
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
    h, w = cell.test["hw"]
    return dict(views=views, units=len(views), work=len(views) * h * w,
                window_s=t1 - t0, trace=tr,
                peak=torch.cuda.max_memory_allocated(dev) if cuda else 0,
                failed=sum(1 for _, p, s in views
                           if not (np.isfinite(p) and np.isfinite(s))))


def run(cell: Cell, seconds: float, trace_seconds: float = 0.0,
        fault: Optional[str] = None, on_setup_done=None,
        control: bool = False) -> Dict:
    dev = cell.dev
    cuda = torch.device(dev).type == "cuda"
    prog = Program(cell, cell.state(), fault)
    gts = [cell.ground_truth(i) for i in range(int(cell.traffic["ground_truth_views"]))]
    h, w = cell.test["hw"]
    chunk = int(cell.traffic["chunk"])
    # warm-up: one chunk of the first view's rays
    from fgs_nerf_tpu_torch.data.rays import get_rays_of_a_view

    o, d, v = (torch.as_tensor(a.reshape(-1, 3)[:chunk], device=dev)
               for a in get_rays_of_a_view(h, w, cell.test["K"],
                                           cell.test["poses"][cell.view(0)],
                                           False, cell.test["inverse_y"],
                                           False, False))
    prog.render_chunk(prog.params, prog.buffers, o, d, v,
                      torch.tensor(cell.s_val, device=dev))
    # and the scorer: its first SSIM imports scipy.signal (seconds), which
    # would otherwise land in the window's first view
    from fgs_nerf_tpu_torch.eval import metrics as metrics_lib

    img = np.zeros((16, 16, 3), np.float32)
    metrics_lib.rgb_ssim(img, img, max_val=1)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if on_setup_done is not None:
        on_setup_done()

    rec = {"e2e": window(prog, cell, gts, 0, seconds, False)}
    if trace_seconds:
        rec["traced"] = window(prog, cell, gts, rec["e2e"]["units"],
                               trace_seconds, True)
    rec["peak"] = max([setup_peak] + [x["peak"] for x in rec.values()])
    del prog
    if cuda:
        torch.cuda.empty_cache()

    views = [v for x in ("e2e", "traced") if x in rec for v in rec[x].pop("views")]
    rec["readings"], rec["control_gap"] = reference_readings(cell, views, gts,
                                                             control)
    rec["bounds"] = counts.kernel_bounds(cell.count_cell())
    rec["head_flops_per_row"] = counts.head_row_flops(
        cell.model, cell.stage == "fine", False)
    return rec


def reference_readings(cell: Cell, views, gts, control: bool = False):
    """The widest gap of a sampled pixel's rgb from the reference's render
    of its ray, and the widest gaps of each view's PSNR (dB) and SSIM
    from the reference's scores of the program's image; with ``control``
    also the control's gaps: its render of the same pixels, and its
    scores computed in bf16."""
    stage = cell.reference_stage()
    ctl_stage = cell.reference_stage(control=True) if control else None
    ctl = {"rgb_gap": 0.0, "psnr_gap": 0.0, "ssim_gap": 0.0}
    p = cell.state()
    h, w = cell.test["hw"]
    n = int(cell.traffic["check_pixels"])
    gen = np.random.default_rng(cell.seed)
    rgb_gap = psnr_gap = ssim_gap = 0.0
    for i, (rgb, p_psnr, p_ssim) in enumerate(views):
        j = cell.view(i)
        pix = gen.choice(h * w, size=n, replace=False)
        o, d, v = (torch.as_tensor(a[pix], device=cell.dev) for a in
                   scene.view_rays_host(h, w, cell.test["K"],
                                        cell.test["poses"][j],
                                        cell.test["inverse_y"]))
        ref = torch.cat([R.render_lattice(stage, p, o[s:s + 8192], d[s:s + 8192],
                                          v[s:s + 8192], cell.s_val)
                         for s in range(0, n, 8192)]).cpu().numpy()
        got = rgb.reshape(-1, 3)[pix]
        rgb_gap = max(rgb_gap, float(np.abs(got - ref).max()))
        if ctl_stage is not None:
            c_rgb = torch.cat([R.render_lattice(ctl_stage, p, o[s:s + 8192],
                                                d[s:s + 8192], v[s:s + 8192],
                                                cell.s_val)
                               for s in range(0, n, 8192)]).cpu().numpy()
            low = torch.bfloat16
            for k, gap in (("rgb_gap", float(np.abs(c_rgb - ref).max())),
                           ("psnr_gap", abs(RI.psnr(rgb, gts[i], low)
                                            - RI.psnr(rgb, gts[i]))),
                           ("ssim_gap", abs(RI.ssim(rgb, gts[i], dtype=low)
                                            - RI.ssim(rgb, gts[i])))):
                ctl[k] = max(ctl[k], gap)
        psnr_gap = max(psnr_gap, abs(p_psnr - RI.psnr(rgb, gts[i])))
        ssim_gap = max(ssim_gap, abs(p_ssim - RI.ssim(rgb, gts[i])))
    return ({"rgb_gap": rgb_gap, "psnr_gap": psnr_gap, "ssim_gap": ssim_gap},
            ctl)
