"""Training traffic: a closed loop of the program's train step at a
stage's final rung, as ``train/trainer.py:train_stage`` drives it.

Set-up builds what ``train_stage`` builds at the rung: the mask cache and
the nonempty mask through ``models/sdf_voxel.py``, the state (made by
the benchmark from the seed), a fresh optimizer and learning-rate state,
every training view's rays on the device behind the mask-cache filter,
and the step of ``make_train_step``.  Each step then does the stage
driver's host work: the batch draw of ``data/rays.py:
batch_index_generator``, the gather on the device, the schedules of
``train/schedules.py`` copied to the device in one non-blocking copy, and
the step call.  The first ``check_steps`` steps run in set-up through
the same feed; their losses, the first gradient as the optimizer holds
it and the parameters' change are kept for the comparison with the
plain reference, which follows the same steps once the window has
closed.  A CUDA event after each step marks its end; nothing waits on
the device inside the window but its closing synchronize.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import counts, scene
from benchmark import trace as T
from benchmark.reference import sdf_step as R


def world_size(model: Dict, box, num_voxels: int):
    """``models/sdf_voxel.py:make_model_config``'s grid: the budget's
    resolution, x raised until (X + 2)(Y + 2) is a multiple of 4 on the
    sorted engine."""
    ws, voxel = scene.grid_resolution(box[0], box[1], num_voxels)
    x, y, z = ws
    if model.get("engine") == "sorted":
        while ((x + 2) * (y + 2)) % 4:
            x += 1
    return (x, y, z), voxel


class Cell:
    """The inputs the benchmark makes for one training cell: handed to
    the program and, after the window, to the reference."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        self.stage = traffic["stage"]
        self.model = cfg[f"{self.stage}_model"]
        self.train = cfg[f"{self.stage}_train"]
        self.n_rand = int(self.train["N_rand"])
        self.cams = scene.cameras(cfg["scene"], "train")
        self.geo_mask, geo_min, geo_max = scene.geometry_sdf_mask(
            cfg, self.cams, device)
        self.geo_box = (geo_min, geo_max)
        shrunk = scene.bbox_from_sdf_mask(self.geo_mask, geo_min, geo_max)
        found = scene.stage_box(cfg, self.stage, shrunk)
        stated = np.asarray(cfg["box_stated"][self.stage], np.float32)
        if not np.allclose(np.stack(found), stated, rtol=0, atol=1e-5):
            raise RuntimeError(f"the {self.stage} box {found} is not the "
                               f"box the configuration states ({stated})")
        self.box = (stated[0], stated[1])
        self.num_voxels = scene.final_rung_voxels(cfg, self.stage)
        self.ws, self.voxel = world_size(self.model, self.box, self.num_voxels)
        self.dims = counts.head_dims(self.model, self.stage == "fine")
        self.bg = 1.0 if cfg["data"].get("white_bkgd", True) else 0.0
        _, geo_voxel = scene.grid_resolution(
            geo_min, geo_max, cfg["geometry_searching_model"]["num_voxels"])
        self.keep_radius = scene.mask_cache_reach(geo_voxel)

    def state(self) -> Dict:
        st = dict(self.cfg["state"], k0_dim=self.model.get("k0_dim", 12),
                  s_start=self.model.get("s_start", 0.05))
        return scene.stage_state(st, self.ws, *self.box, self.dims, self.seed,
                                 self.dev)

    def rays(self):
        return scene.training_rays(self.cams, self.keep_radius, self.dev)

    def count_cell(self) -> Dict:
        return dict(n_rays=self.n_rand, model=self.model, stage=self.stage,
                    world_size=self.ws, engine=self.model.get("engine"))

    def reference_stage(self, control: bool = False) -> R.Stage:
        return R.Stage(self.cfg, self.stage, self.box, self.ws, self.voxel,
                       self.geo_mask, self.geo_box, self.cams["near"], self.bg,
                       control=control)


def _leaves(tree):
    """(``group.leaf`` name, tensor) pairs, named as the reference names
    its leaves."""
    leaves, names = R.flatten(tree)
    return zip(names, leaves)


def _norms(tree) -> Dict[str, torch.Tensor]:
    return {k: torch.linalg.vector_norm(v.float()) for k, v in _leaves(tree)}


class Program:
    """The program at the cell's rung, fed as the stage driver feeds it."""

    def __init__(self, cell: Cell, params: Dict, fault: Optional[str] = None):
        from fgs_nerf_tpu_torch.core.box import SceneBox
        from fgs_nerf_tpu_torch.data.rays import batch_index_generator
        from fgs_nerf_tpu_torch.models import sdf_voxel as M
        from fgs_nerf_tpu_torch.optim.masked_adam import init_state
        from fgs_nerf_tpu_torch.train import schedules
        from fgs_nerf_tpu_torch.train import trainer as TR
        from fgs_nerf_tpu_torch.train.stage_common import config_passthrough

        self.cell, self.fault = cell, fault
        self.S, self.TR = schedules, TR
        dev = cell.dev
        self.cfg_m = M.make_model_config(
            stage=cell.stage, xyz_min=cell.box[0], xyz_max=cell.box[1],
            num_voxels=cell.num_voxels,
            **config_passthrough(cell.model, M.SDFModelConfig))
        if tuple(self.cfg_m.world_size) != tuple(cell.ws):
            raise RuntimeError(f"the program's grid {self.cfg_m.world_size} is "
                               f"not the benchmark's {cell.ws}")
        self.box = SceneBox.create(cell.box[0], cell.box[1], dev)
        buffers = {"mask_cache": M.build_mask_cache(cell.geo_mask, *cell.geo_box)}
        self.params, self.buffers = M.set_nonempty_mask(params, buffers,
                                                        self.cfg_m, self.box)
        self.opt = init_state(self.params)
        self.opts = TR.make_param_opts(self.params, cell.train)
        self.loss_w = TR.loss_weights_from_cfg(cell.train)
        self.lr = schedules.LrState(schedules.initial_lrs(cell.train,
                                                          set(self.params)))
        self.tv_terms = dict(cell.train.get("tv_terms", {}))
        self.steps_cache: Dict = {}
        self.rays, self.n_pixels = cell.rays()
        if len(self.rays[0]) < cell.n_rand:
            raise RuntimeError("the mask-cache filter kept fewer rays than a batch")
        self.index = batch_index_generator(len(self.rays[0]), cell.n_rand,
                                           cell.seed)
        self.global_step = int(cell.traffic["first_step"])

    def _step_fn(self, g: int):
        t = self.cell.train
        key = (self.tv_terms.get("sdf_tv", 0.0),
               self.tv_terms.get("smooth_grad_tv", 0.0),
               g < t.get("tv_dense_before", 0))
        if key not in self.steps_cache:
            self.steps_cache[key] = self.TR.make_train_step(
                self.cfg_m, self.box, self.loss_w, self.opts,
                near=float(self.cell.cams["near"]), bg=self.cell.bg,
                n_rand=self.cell.n_rand, sdf_tv=float(key[0]),
                smooth_grad_tv=float(key[1]),
                inject_tv=not t.get("ori_tv", False), tv_dense=key[2],
                weight_tv_density=self.loss_w.weight_tv_density,
                weight_tv_k0=self.loss_w.weight_tv_k0,
                use_nonempty_mask=True)
        return self.steps_cache[key]

    def draw(self):
        from fgs_nerf_tpu_torch.device import to_device

        sel = to_device(next(self.index), self.cell.dev)
        return [a[sel] for a in self.rays]

    def step(self, batch):
        """One step at the current global step; returns its metrics."""
        from fgs_nerf_tpu_torch.device import to_device
        from fgs_nerf_tpu_torch.ops.sdf2alpha import s_val_schedule

        g, cm = self.global_step, self.cfg_m
        s_val = float(s_val_schedule(g, cm.s_ratio, cm.s_start, cm.step_start))
        tv_on = 1.0 if self.S.tv_active(g, self.cell.train) else 0.0
        names = list(self.lr.lrs)
        scal = to_device([s_val, tv_on] + [self.lr.lrs[k] for k in names],
                         self.cell.dev, torch.float32)
        lrs = dict(zip(names, scal[2:]))
        if self.fault == "half_batch":
            batch = [a[: len(a) // 2] for a in batch]
        new_p, new_opt, metrics = self._step_fn(g)(
            self.params, self.opt, self.buffers, *batch, scal[0], lrs, scal[1])
        if self.fault != "unchanged":
            self.params, self.opt = new_p, new_opt
        self.S.update_lrs(self.lr, g, self.cell.train)
        self.S.apply_tv_updates(self.tv_terms, g, self.cell.train)
        self.global_step += 1
        return metrics


def _cuda(cell: Cell) -> bool:
    return torch.device(cell.dev).type == "cuda"


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def setup(cell: Cell, fault: Optional[str] = None):
    """The program at the rung, driven through ``check_steps`` steps and
    the warm-up; returns (program, what the comparison needs)."""
    params0 = cell.state()
    prog = Program(cell, params0, fault)
    p0 = dict(_leaves(prog.params))
    batches, losses = [], []
    grad_norms = change_norms = None
    n_check = int(cell.traffic["check_steps"])
    for i in range(n_check + int(cell.traffic["warmup_steps"])):
        batch = prog.draw()
        if i < n_check:
            batches.append([a.clone() for a in batch])
        metrics = prog.step(batch)
        if i < n_check:
            losses.append(metrics["loss"])
        if i == 0:
            # the first gradient as Adam holds it: m = (1 - beta1) g
            grad_norms = {k: n / 0.1 for k, n in _norms(prog.opt.exp_avg).items()}
        if i == n_check - 1:
            change_norms = {k: torch.linalg.vector_norm((v - p0[k]).float())
                            for k, v in _leaves(prog.params)}
            del p0
    _sync(cell.dev)
    check = dict(batches=batches, losses=[float(x) for x in losses],
                 grad=({k: float(v) for k, v in grad_norms.items()}),
                 change=({k: float(v) for k, v in change_norms.items()}))
    return prog, check


def window(prog: Program, seconds: float, traced: bool):
    """The closed loop for ``seconds``; returns the window's record."""
    dev = prog.cell.dev
    cuda = torch.device(dev).type == "cuda"
    events: List = []
    host_s: List[float] = []
    metrics: List = []
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
    with T.traced(dev, traced) as tr, T.span("window"):
        t0 = time.perf_counter()
        if cuda:
            start.record()
        while time.perf_counter() - t0 < seconds:
            h0 = time.perf_counter()
            with T.span("draw"):
                batch = prog.draw()
            with T.span("step"):
                metrics.append(prog.step(batch))
            host_s.append(time.perf_counter() - h0)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
        _sync(dev)
        t1 = time.perf_counter()
    steps = len(host_s)
    marks = [start] + events if cuda else []
    intervals = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
    return dict(units=steps, work=steps * prog.cell.n_rand, window_s=t1 - t0,
                step_ms=intervals, host_ms=[1e3 * h for h in host_s],
                failed=int((~torch.isfinite(losses)).sum()),
                peak=torch.cuda.max_memory_allocated(dev) if cuda else 0,
                trace=tr)


def reference_readings(cell: Cell, check: Dict, control: bool = False):
    """The plain reference (or its control) over the check steps, from the
    same seed and batches; returns (losses, first-gradient norms, change
    norms)."""
    stage = cell.reference_stage(control)
    p0 = cell.state()
    losses, g, p3 = R.run_steps(stage, p0, check["batches"],
                                int(cell.traffic["first_step"]), cell.n_rand)
    p0 = dict(zip(*reversed(R.flatten(stage.prepare(p0)))))
    grad = {k: float(torch.linalg.vector_norm(v)) for k, v in g.items()}
    change = {k: float(torch.linalg.vector_norm(p3[k] - p0[k])) for k in p3}
    return losses, grad, change


def compare(check: Dict, ref) -> Dict[str, float]:
    """The compared numbers: the relative loss gap of the first check step
    (both sides from the same state) and the worst over the check steps,
    and by the worst leaf the gap of the first gradient's norm and of the
    parameters' change, each against the reference's norm of the leaf or
    of the median leaf, whichever is larger.  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out."""
    losses, grad, change = ref
    gaps = [abs(a - b) / abs(b) for a, b in zip(check["losses"], losses)]
    med_g = float(np.median(list(grad.values())))
    kept = [k for k, v in grad.items() if v >= 1e-3 * med_g]
    med_c = float(np.median([change[k] for k in kept]))

    def worst(prog, refv, med):
        return max(abs(prog[k] - refv[k]) / max(refv[k], med) for k in kept)

    return {"first_loss_gap": gaps[0], "loss_gap": max(gaps),
            "grad_gap": worst(check["grad"], grad, med_g),
            "change_gap": worst(check["change"], change, med_c)}


def detail(check: Dict, ref) -> Dict:
    """Every step's loss gap and every leaf's gaps, for calibration."""
    losses, grad, change = ref
    med_g = float(np.median(list(grad.values())))
    return {"loss": [abs(a - b) / abs(b) for a, b in zip(check["losses"], losses)],
            "ref_loss": losses,
            "leaves": {k: [grad[k] / med_g,
                           abs(check["grad"][k] - grad[k]) / max(grad[k], med_g),
                           abs(check["change"][k] - change[k]) / max(change[k], 1e-30)]
                       for k in grad}}


def run(cell: Cell, seconds: float, trace_seconds: float = 0.0,
        fault: Optional[str] = None, on_setup_done=None) -> Dict:
    """Set-up, the untraced window, with ``trace_seconds`` a traced window
    after it, and the reference: everything the harness reports."""
    prog, check = setup(cell, fault)
    setup_peak = torch.cuda.max_memory_allocated(cell.dev) if _cuda(cell) else 0
    if on_setup_done is not None:
        on_setup_done()
    rec = {"e2e": window(prog, seconds, False)}
    if trace_seconds:
        rec["traced"] = window(prog, trace_seconds, True)
    rec["peak"] = max([setup_peak] + [w["peak"] for w in rec.values()])
    rec["n_pixels"], rec["n_kept"] = prog.n_pixels, len(prog.rays[0])
    del prog
    if _cuda(cell):
        torch.cuda.empty_cache()
    ref = reference_readings(cell, check)
    rec["readings"] = compare(check, ref)
    rec["bounds"] = counts.kernel_bounds(cell.count_cell())
    rec["head_flops_per_row"] = counts.head_row_flops(
        cell.model, cell.stage == "fine", True)
    return rec
