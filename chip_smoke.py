#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fgs_nerf_tpu_torch``) on one CUDA card
and check it.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero, with no result line):

1. Build: compile every CUDA kernel of the port (B1-B9) from
   ``fgs_nerf_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel)
   and print the card's name and power limit.
2. Kernel checks: run one coarse step at the ``bench.py`` configuration
   (8,192 rays, 114^3 grid, sample_k 288 -> M = 2,359,296 samples,
   refnet 90 -> 192 -> 192 -> 3) and keep the inputs each kernel wrapper
   received.  On those inputs, hold every kernel against its plain
   PyTorch twin (tolerances below), time both with CUDA events, time
   the one PyTorch call that computes the same function where there is
   one, and compute the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate of their type).  Beside
   B3 and B4, as context: the bf16 ``torch.matmul`` chain over the same
   padded products, each kernel's ``ptxas`` registers, stack and spills,
   and its blocks' dynamic shared memory.
3. Main path: zero the launch counts, run warm-up and timed train steps
   (``train/trainer.py:make_train_step``), read the counts; the loss
   must be finite and fall, and every kernel must have launched (the
   masked Adam once a leaf a step).  Then profile two more steps
   (``torch.profiler``) and print device time per step by kernel group
   and the device's idle share.
4. Kernel path against plain path: one step through the kernels and
   one through their plain twins from the same state (the masked Adam's
   twin ``optim/masked_adam.py:adam_leaf`` included); compare loss,
   gradients and post-Adam parameters.

The fine stage, at the ``bench.py:_fine_workload`` configuration
(8,192 rays, 256^3 grid, sample_k 512 -> 4,194,304 pass-1 samples,
shade_k 128 -> 1,048,576 pass-2 samples, rgbnet 106 -> 256 x 4, refnet
307 -> 256 x 3 -> 3, 16 z/y and 8 x taps, TV injected):

5. Fine kernel checks: one fine step with every kernel call recorded (B1
   and B2 in both passes, B5 and B6 in the z/y and the x tap call); each
   call's kernel is held against its twin, timed, and bounded.  Bytes
   of a sparse serve count the pack columns its rows touch and, beside
   that bound, the 32-byte sectors of each pack row those columns lie in
   (device memory moves whole sectors) and, as context, the 64-byte
   segments; B1 calls report the share of their sample tiles that take
   the staged branch and the stage's shared memory per block; B6 also
   times its own sort.
6. Fine main path: zero the counts, 2 warm-up and 4 timed steps; the
   loss must be finite and fall, and B1, B2, B5 and B6 must each have
   launched twice per step.  Profile two steps.
7. Masked traffic: two fine steps behind a mask cache built from the
   initial ball SDF band, with every kernel call of the first step (B1,
   B2, B5, B6) checked as in phase 5 (the sentinel runs are long there).
8. Fine kernel path against plain path, as phase 4.

The lattice engine (``engine="lattice"``, the JAX package's default and
the engine of every evaluation), whose grid-gradient accumulate is B7:

9. Lattice coarse kernel check: one step at the ``bench.py --engine
   lattice`` configuration (the coarse configuration above), its B7 call
   held against its twin, repeated, timed (kernel, twin, ``index_add_``)
   and bounded.
10. Lattice coarse main path: zero the counts, 2 warm-up and 10 timed
    steps; the loss is finite and falls, B7 launches once per step;
    profile two steps; a kernel step against a plain step, as phase 4.
11. Lattice fine, at the ``bench.py:_fine_workload`` configuration with
    ``engine="lattice"``: one step with its three B7 calls (the fused
    ``[sdf | k0]`` field, the center taps, the hierarchical taps) checked
    as in phase 9; 2 warm-up and 4 timed steps, B7 three times per step;
    peak memory, a profile, and a kernel step against a plain step.
12. Eval render: one 800 x 800 view of the procedural glossy sphere
    (``pose_spherical(30, -30, 4)``, the synthetic focal) through
    ``eval/render.py`` with the fine parameters left by phase 11: PSNR,
    SSIM, seconds per view and rays/s; every pixel finite and in [0, 1].

The fused channel-major MLP (kernels B8/B9, which no training path
launches) and the whole training pipeline:

13. B8/B9: record the feature blocks and weights that the rgbnet and the
    refnet receive in one sorted fine step at the ``_fine_workload``
    shapes (M = 1,048,576 shading samples), run ``ops/fused_mlp_cm.py:
    fused_mlp_cm`` forward and backward on them through the kernels (the
    op is B8/B9's path: zero the counts, run, read), hold each kernel
    against its plain twin, repeat, time, bound; beside the kernel, the
    bf16 ``torch.matmul`` chain of ``models/mlp.py:mlp_apply`` on the same
    inputs (a chain, not one library call).  Each B8 record also holds
    the kernel's own device time (``torch.profiler``, without the
    wrapper's weight layout), its bytes and operations bounds side by
    side (both roofs are close), the block's shared memory (the
    launcher's formula, checked against ``fwd_plan``), its launch plan,
    the weight bytes its bulk copies move from L2 a call, and ptxas's
    registers and spills.  Controls: the twins with a
    bf16 rounding left out (hiddens, or each layer's ``dz``) must fail
    the tolerances that the kernels pass.
14. Pipeline: ``python -m fgs_nerf_tpu_torch.run --mode train`` in process
    on a config derived from ``full_synthetic`` (the shiny_blender widths,
    40 views of 256 x 256, 3 test views, 8,192 rays per step) with only
    the depth cut (geometry 16 steps over its 7 rungs, coarse 14 over its
    6, fine 6 with one rung at step 3): per stage the wall time, the last
    rung's step time (each step followed by a synchronize), world size,
    the mask-cache ray filter's kept share, peak memory, launches by
    kernel and checkpoint write time; then the test-view render, PSNR,
    SSIM, LPIPS(alex) (``--eval_lpips 1``: the seed-0 fallback weights
    unless ``FGS_LPIPS_WEIGHTS`` names a file) and the 512^3 mesh.
    Every kernel call of the first step at each stage's last rung is
    recorded (bbox-shrunk grids, mask-cache-filtered
    rays, the geometry stage's 128-wide refnet) and held against its twin
    as in phases 2 and 5, timed and bounded.  Checks: finite losses and
    PSNR, every checkpoint loads with its stage's voxel budget, every
    kernel of each stage's path launched, a non-empty mesh, rendered
    pixels in [0, 1].

The DTU path:

15. DTU: write a DTU-format scan under ``results/`` (``write_dtu_scan``:
    49 views of 1,600 x 1,200 PNG images and masks of the glossy sphere
    of ``data/synthetic.py:shade_sphere`` in the normalised frame, seen
    by OpenCV cameras on an upper-hemisphere arc with a DTU-like K, and
    ``cameras_sphere.npz`` with world matrices in the scan's world frame
    and one scale matrix; ``write_dtu_eval_data``: the ObsMask, plane and
    STL point files beside it), then run the CLI on it as in phase 14
    (``--dataset_path``, ``--scene``, no test renders at the end of each
    stage: ``--i_validate 0``) with the built-in ``dtu`` config at
    its full widths (geometry 1,024,000 voxels from an 80^3 base, coarse
    1.5M with viewbase_pe 3, so the coarse head's B3/B4 take 144 padded
    input rows, fine 256^3, N_rand 8,192, reso_level 2: 800 x 600 views)
    and only the depth cut as there; the 7 test views, the 512^3 mesh in
    the scan's world frame and its DTU Chamfer (d2s, s2d, mean).  Every
    kernel call of each stage's last-rung first step is held against its
    twin as in phase 14.  Checks as there, and a finite Chamfer that the
    evaluator wrote to ``resulteval.txt`` and its stats.

The remaining loaders, the DVGO geometry search and the TensoRF k0:

16. Loaders: write one small scan of each remaining format with the
    port's ``write_png`` (``write_llff_scan`` and its siblings: LLFF at 20
    views of 504 x 378, LLFF's factor-8 size, loaded at ``factor`` 1 and
    2, and a spherified inward LLFF ring; NSVF, Tanks & Temples,
    BlendedMVS, NeRF++, CO3D, ILSH at ``factor`` 3 and DeepVoxels at the
    sizes of ``tests/test_loaders.py``) and load each through
    ``data/dataset.py:load_dataset``: views, splits, image shapes, near /
    far, pixels in [0, 1], load seconds; neither ``imageio`` nor ``cv2``
    may be imported.
17. ``--dvgo_init``: the CLI in process on ``full_synthetic`` at the
    built-in ``dvgo`` / ``dvgo_model`` widths (100^3, N_rand 8,192,
    sample_k 256, per-voxel learning rates; alpha_init 0.01, see
    ``_DVGO_CONFIG``), the depth cut to 16 DVGO steps and 4 coarse steps
    off its checkpoint, without the final evaluation (phase 14's).  Both
    B7 calls of the first DVGO step (density: 8 columns, k0: 24; the
    stage's loss reads no normals, so the gradient field's sample has no
    backward) are held against their twin, repeated, timed beside
    ``index_add_`` and bounded; the DVGO step is timed (ms, rays/s, peak
    memory) and profiled (idle share), and a kernel step is compared with
    a plain-twin step (loss 1e-4, gradients relative L2 1e-3).  Checks:
    finite PSNR, a DVGO checkpoint of density and k0 with a non-empty
    sdf_mask, B7 and the masked Adam alone launched by the DVGO stage,
    B1-B4 by the coarse.
18. TensoRF: the ``bench.py`` sorted coarse step with ``grid_type=
    'tensorf'`` (8 components, densified every step): 2 warm-up and 4
    timed steps with B1-B4 launched each step, then a kernel step against
    a plain-twin step as phase 4 (every factor's gradient).

Parallelism (``fgs_nerf_tpu_torch/parallel``), two ranks sharing the one
card through gloo (NCCL refuses two ranks on one device; their step times
are not a scaling measurement), each rank started by ``parallel/launch.py:
launch_local``:

19. dp = 2: the sorted coarse step (8,192 rays, 4,096 a rank, 114^3) and
    the sorted fine step (256^3): on each rank, the loss and the
    dp-averaged gradients of its shard against the single-process step of
    the whole batch from the same state (loss relative 1e-5, gradients
    ``rtol 1e-3, atol 5e-5``), the post-Adam parameters where |g| > 1e-5
    within 1e-4; then 2 warm-up and 4 timed dp steps with the launch
    counts zeroed before and read after (every kernel of the path on
    each rank), the replicas bit-equal after them, the gradient
    all-reduce's bytes and time, step ms and peak memory a rank.
20. sp = 2: the lattice fine step at 256^3, 128 x-planes a slab, against
    the single-process step (run in turns: loss relative 1e-5, the
    slabs' grid parameters ``rtol 1e-4, atol 1e-5``, MLP leaves ``rtol
    1e-3, atol 2e-3``); the sharded gather's and halo exchanges'
    all-reduces recorded on one step (bytes, ms); timed steps, B7 on
    each slab.
21. The CLI under ``torch.distributed.run --nproc_per_node 2 --mesh dp=2
    --dist_backend gloo --device cuda:0`` on phase 14's config, geometry
    stage only: its whole PSNR history within 5e-3 of a single-process
    stage that sums each step as dp does (two half-batch passes, their
    gradients and metrics averaged: ``_half_batch_steps``), and of the
    plain single-process stage over the first 8 steps (the whole history
    printed), rank 0's checkpoint loads with ``load_checkpoint``, both
    ranks exit 0.  Then NCCL at world size 1 (``torch.distributed.run
    --nproc_per_node 1``, ``--mesh dp=1``): one sorted coarse step
    bit-equal to the step without a mesh.
22. A user's capture to a trained model: write a capture
    (``write_capture``: 30 views at 504 x 378 of the glossy sphere on an
    inward arc of OpenCV cameras, and its COLMAP binary ``sparse/0``),
    convert it with ``python -m fgs_nerf_tpu_torch.run_colmap
    --skip_masks`` (``poses_bounds.npy``, ``cameras_sphere.npz``; no
    ``colmap`` runs) and check the LLFF loader's cameras against the
    written ones up to one similarity (centres within 1e-4 of the
    radius); then phase 14's pipeline on the ``smart_car`` config with
    ``--dataset_type llff`` (the full widths, the same cut depth but 8
    fine steps), every kernel call of each stage's last-rung first step
    held against its twin, two fine steps traced with
    ``utils/profiling.py:trace_steps`` (the trace's path, kernel count
    and device ms by group), then the ``llffhold`` test views' PSNR /
    SSIM and the 512^3 mesh.

The masked Adam (``csrc/masked_adam.cu``, A1: no TPU kernel; every
training path launches it once a leaf a step, which phases 3, 6, 7, 10,
11, 14, 15, 17-20 and 22 count):

23. Record every leaf ``adam_update`` receives in two sorted fine steps
    and two sorted coarse steps from a fresh state (a rung's first step,
    whose k0 gradient reaches Adam channel-major against channel-last
    parameters and moments: the tiled pass; the step after it: the flat
    pass); on those same tensors hold ``masked_adam_step`` bit for bit
    against ``adam_leaf`` (p', m' and v': values, signs of zeros and
    strides), time both and bound each call by its bytes (28 B an
    element, 32 with a per-voxel lr, at 3.35 TB/s).

B1 and B5 calls of phases 2, 5-8, 14, 15 and 22 also carry a library
time: one
``F.grid_sample`` (trilinear, ``align_corners=True``, zero padding) of
the unpacked [1, C, X, Y, Z] grid at the serve's own points, held within
1e-4 of the serve's output (it recomputes the fractions from the
weights).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

Tolerances and why: B1 and B5 sum in their twins' order with IEEE
operations, so they must be bit-equal; the B2 / B6 twins use
``index_add_``, whose atomics add in any order (relative 1e-4 of the
largest value), and B2 / B6 must repeat bit for bit; so must B7, whose
twin is ``index_add_`` as well; B3/B4 share every
bf16 rounding with their twins but sum in another order, so a hidden
value can land one bf16 ulp away (logits: max 1e-2, at most 1% past
1e-5; cotangents, dW and db: relative L2 1e-3), B8 likewise; the order
can also flip the ReLU mask of a hidden pre-activation that lies within
the bound on float32 summation error of zero, which moves that sample's
cotangents by O(1) (phase 15's geometry call: 8 of 2.9M samples), so
where a B4 cotangent is past 1e-3 the samples whose mask the sum order
can flip (``_mask_band``) and whose cotangents moved are set aside, at
most ceil(1e-5 M) of them, every other sample stays held to 1e-3 and
the whole output to 1e-2; B9's cotangents, dW
and db agree to relative L2 2.5e-3 (not 1e-3) on the fine head's 4-layer
nets: the same function summed in float64 instead of float32, bf16
roundings kept, already moves them by about 1e-3 (``tests/
test_torch_fused_mlp.py::test_deep_net_cotangents_move_with_the_sum_order``),
as each one-ulp landing of a rounded cotangent propagates down the
layers.  Leaving the ``dz`` rounding out moves them by only about 3.5e-3,
so B9 is also held to at most 5% of dx entries more than 1e-4 of dx's
RMS away from the twin: a one-ulp landing moves a few samples' dx, a
rounding left out most samples'.  The phase 13 controls must fail that
check; dW / db repeat bit for bit.
Whole-step losses: relative 1e-4;
gradients: relative L2 1e-2; post-Adam parameters where |g| > 1e-5:
1e-4 (Adam's first step is lr * g / (|g| + 1e-8), steep where |g| is
small).
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# where the device breakdowns write their (removed) traces
TRACE_DIR = Path(__file__).resolve().parent / "results" / "chip_smoke_traces"
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # dense tensor-core bf16
PEAK_F32_FLOPS = 67e12       # fp32 outside the tensor cores
N_WARMUP = 2
N_STEPS = 10
N_FINE_STEPS = 4
MLP_FLIP_SHARE = 0.01   # B8 outputs allowed past 1e-5 (see above)
MLP_REL_L2 = 2.5e-3     # B9 outputs against the twin (see above)
MLP_DX_SHARE = 0.05     # B9 dx entries allowed past 1e-4 of its RMS


XYZ_MIN = (-1.0, -1.0, -1.0)
XYZ_MAX = (1.0, 1.0, 1.0)
FINE_DISPLACE = (0.5, 1.0, 1.5, 2.0)


def _coarse_cfg(M, engine):
    """The ``bench.py:105-121`` coarse configuration on ``engine``."""
    return M.make_model_config(
        stage="coarse", xyz_min=XYZ_MIN, xyz_max=XYZ_MAX,
        num_voxels=1_500_000, num_voxels_base=1_500_000, stepsize=0.5,
        k0_dim=12, refnet_width=192, refnet_depth=3, posbase_pe=5,
        viewbase_pe=1, refbase_pe=5, smooth_ksize=5, smooth_sigma=0.8,
        s_ratio=50.0, s_start=0.2, fast_color_thres=1e-4, shade_k=256,
        sample_k=288, shade_remat=False, engine=engine,
    )


def _fine_cfg(M, engine):
    """The ``bench.py:_fine_workload`` configuration on ``engine``."""
    return M.make_model_config(
        stage="fine", xyz_min=XYZ_MIN, xyz_max=XYZ_MAX,
        num_voxels=256**3, num_voxels_base=256**3, stepsize=0.5,
        k0_dim=12, rgbnet_width=256, rgbnet_depth=4, refnet_width=256,
        refnet_depth=4, posbase_pe=5, viewbase_pe=3, refbase_pe=8,
        grad_feat=FINE_DISPLACE, sdf_feat=FINE_DISPLACE, center_sdf=True,
        use_viewdir=True, s_ratio=50.0, s_start=0.05, fast_color_thres=1e-4,
        shade_k=128, sample_k=512, shade_remat=False, engine=engine,
    )


# per workload: loss weights, learning rates, s_val, fine-stage TV injection
_WORKLOADS = {
    "coarse": (_coarse_cfg,
               dict(weight_main=1.0, weight_rgbper=0.2,
                    weight_entropy_last=1e-3, weight_orientation=1e-4,
                    sigmoid_rgb_loss=0.1, weight_tv_density=0.01,
                    weight_tv_k0=0.0, ori_tv=True),
               {"sdf": 0.1, "k0": 0.1, "refnet": 1e-3}, 0.2, False),
    "fine": (_fine_cfg,
             dict(weight_main=1.0, weight_rgbper=0.0,
                  weight_entropy_last=1e-3, weight_orientation=1e-4,
                  sigmoid_rgb_loss=0.02, weight_tv_density=0.01,
                  weight_tv_k0=0.0, ori_tv=False),
             {"sdf": 5e-3, "k0": 0.1, "refnet": 1e-3, "rgbnet": 1e-3}, 0.05,
             True),
}


def _setup(torch, M, stage, engine, dev, n_rand, mesh=None, **cfg_over):
    """(cfg, box, params0, lrs, s_val, loss_and_grads, step) of the
    ``stage`` bench workload on ``engine``, its config fields replaced by
    ``cfg_over``; the step on ``mesh`` when given."""
    import dataclasses

    from fgs_nerf_tpu_torch.core.box import SceneBox
    from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts
    from fgs_nerf_tpu_torch.train.losses import LossWeights
    from fgs_nerf_tpu_torch.train.trainer import (
        make_loss_and_grads, make_train_step,
    )

    make_cfg, loss_kw, lrs, s_val, inject_tv = _WORKLOADS[stage]
    cfg = dataclasses.replace(make_cfg(M, engine), **cfg_over)
    box = SceneBox.create(XYZ_MIN, XYZ_MAX, dev)
    loss_w = LossWeights(**loss_kw)
    params0 = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
    opts = {k: ParamOpts(skip_zero_grad=k in ("k0", "sdf")) for k in params0}
    loss_and_grads = make_loss_and_grads(
        cfg, box, loss_w, near=0.2, bg=1.0, sdf_tv=0.1, smooth_grad_tv=0.05,
        use_nonempty_mask=False, mesh=mesh)
    step = make_train_step(
        cfg, box, loss_w, opts, near=0.2, bg=1.0, n_rand=n_rand, sdf_tv=0.1,
        smooth_grad_tv=0.05, inject_tv=inject_tv, tv_dense=True,
        weight_tv_density=0.01, weight_tv_k0=0.0, use_nonempty_mask=False,
        mesh=mesh)
    return (cfg, box, params0, lrs, torch.tensor(s_val, device=dev),
            loss_and_grads, step)


def _bench_batch(torch, np, dev, n_rand):
    """The bench traffic: ``n_rand`` rays from one camera, seed 0."""
    rng = np.random.default_rng(0)
    cam = np.array([0.0, 0.0, 3.5], np.float32)
    rays_o = np.broadcast_to(cam, (n_rand, 3)).copy()
    look = rng.normal(size=(n_rand, 3)).astype(np.float32) * 0.4
    rays_d = look - rays_o
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    target = rng.uniform(size=(n_rand, 3)).astype(np.float32)
    return [torch.as_tensor(a, device=dev)
            for a in (rays_o, rays_d, viewdirs, target)]


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, n, torch):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _bound(n_bytes, n_flops, peak_flops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _check(ok, msg):
    """A check that stays under ``python -O`` (unlike ``assert``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def _b9_outputs(bwd):
    """B9's (dx, dW list, db list) -> [dx, dW..., db...]."""
    dx, dws, dbs = bwd
    return [dx, *dws, *dbs]


def _b9_readings(outs, ref):
    """(the worst relative L2 over B9's outputs, the share of dx entries
    more than 1e-4 of the reference dx's RMS away).  A bf16 value that
    lands one ulp away moves the dx of a few samples; a rounding left out
    moves nearly every sample's."""
    dx, dx_ref = outs[0].double(), ref[0].double()
    far = (dx - dx_ref).abs() > 1e-4 * dx_ref.pow(2).mean().sqrt()
    return (max(_rel_l2(a, b) for a, b in zip(outs, ref)),
            float(far.double().mean()))


_BUCKETS = (  # (bucket, kernel-name fragments, kernel call site), first
    # match wins; the call site (``_LAUNCHER_OF``) that launches the group
    ("accumulate B7", ("rowmajor_",), None),
    ("serve B5", ("tap_serve_samples",), "tap_window_serve_cm"),
    ("accumulate B6", ("tap_tile_accumulate", "tap_block_sums",
                       "tap_run_totals"), "tap_dense_accumulate_cm"),
    ("serve B1", ("window_gather_tiles",), "window_gather_cm"),
    ("accumulate B2", ("cm_tile_accumulate", "cm_block_sums",
                       "cm_run_totals"), "dense_accumulate_cm"),
    ("shade B3", ("fused_shade_fwd",), "fused_shade_cm_fwd"),
    ("shade B4", ("fused_shade_bwd", "fused_shade_dw",
                  "shade_reduce_partials"), "fused_shade_cm_bwd"),
    ("adam A1", ("masked_adam_step",), None),
    ("matmul", ("gemm", "Gemm", "cutlass"), None),
    ("sort", ("sort", "radix", "Sort"), None),
    ("gather/scatter", ("index", "gather", "scatter", "Index"), None),
    ("reduce", ("reduce", "Reduce"), None),
    ("elementwise", ("elementwise", "Elementwise", "vectorized"), None),
)


def _bucket(kernel):
    """The ``_BUCKETS`` group of a device kernel's name ("other": none)."""
    return next((b for b, frags, _ in _BUCKETS
                 if any(f in kernel for f in frags)), "other")


def _traced_kernels(run_steps, n_steps):
    """Trace ``run_steps()`` (``n_steps`` steps) with
    ``utils/profiling.py:trace_steps``: device ms a step by kernel name,
    and the kernel events a step; the trace file is removed."""
    from fgs_nerf_tpu_torch.utils import profiling as PF

    with PF.trace_steps(str(TRACE_DIR)) as tr:
        run_steps()
    per = _per_kernel(tr, n_steps)
    os.remove(tr.path)
    return per


def _per_kernel(trace, n_steps):
    """{kernel name: (device ms a step, launches a step)} of a written
    ``utils/profiling.py`` trace of ``n_steps`` steps."""
    per = {}
    for name, us in trace.kernels():
        t, c = per.get(name, (0.0, 0))
        per[name] = (t + us / (1e3 * n_steps), c + 1)
    return {name: (t, c // n_steps) for name, (t, c) in per.items()}


def _by_bucket(ms_of):
    """Device ms a step by ``_BUCKETS`` group, from ms a step by kernel."""
    groups = {}
    for name, ms in ms_of.items():
        groups[_bucket(name)] = groups.get(_bucket(name), 0.0) + ms
    return groups


def _device_breakdown(torch, run_step, step_ms, card, path="coarse"):
    """Trace two steps; print device time per step by bucket, the top
    kernels, and the device's idle share against the untraced step."""
    def two():
        for _ in range(2):
            run_step()

    per = _traced_kernels(two, 2)
    busy = sum(t for t, _ in per.values())
    top = sorted(per.items(), key=lambda k: -k[1][0])[:12]
    print(json.dumps({
        "path": path, "device_ms_per_step": busy, "step_ms": step_ms,
        "idle_share": (1.0 - busy / step_ms) if busy else None,
        "buckets_ms": _by_bucket({n: t for n, (t, _) in per.items()}),
        "n_kernel_names": len(per),
        "top": [{"kernel": n[:90], "ms": t, "calls": c}
                for n, (t, c) in top],
        "card": card,
    }))


def _clone(a, torch, device=None):
    """A copy of the tensors in ``a`` (nested lists / tuples), on
    ``device`` if given, else where they are."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    if isinstance(a, (list, tuple)):
        return type(a)(_clone(x, torch, device) for x in a)
    return a


@contextlib.contextmanager
def _patched(pairs):
    """Set ``module.attr = value`` for each (module, attr, value) and
    restore the old values on the way out."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in pairs]
    for mod, attr, value in pairs:
        setattr(mod, attr, value)
    try:
        yield
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


def _plain_twins(ST, FS, SC, B1, B2, B56, B7):
    """Route the eight kernel call sites to their plain twins."""
    from fgs_nerf_tpu_torch.optim import masked_adam as OPT

    return _patched([
        (OPT, "masked_adam_step", OPT.adam_leaf),
        (SC, "dense_accumulate", B7.dense_accumulate_plain),
        (ST, "window_gather_cm", B1.window_gather_cm_plain),
        (ST, "dense_accumulate_cm", B2.dense_accumulate_cm_plain),
        (ST, "tap_window_serve_cm", B56.tap_window_serve_cm_plain),
        (ST, "tap_dense_accumulate_cm", B56.tap_dense_accumulate_cm_plain),
        (FS, "fused_shade_cm_fwd", FS.fused_shade_cm_fwd_plain),
        (FS, "fused_shade_cm_bwd", FS.fused_shade_cm_bwd_plain),
    ])


def _adam_leaves(params, lrs):
    """The leaves ``adam_update`` updates a step: one masked Adam launch
    each."""
    from fgs_nerf_tpu_torch.optim.masked_adam import tree_leaves

    return sum(1 for k, x in params.items() if k in lrs
               for leaf in tree_leaves(x) if leaf.numel())


def _leaves(tree, prefix=""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + key + ".")
        else:
            yield prefix + key, v


def _step_vs_plain(torch, loss_and_grads, step, state, buffers, batch, s_val,
                   lrs, twins):
    """One step through the kernels and one through the plain twins from
    the same state: loss within 1e-4 relative, gradients within relative
    L2 1e-2, post-Adam parameters within 1e-4 where |g| > 1e-5.  The
    kernel path's graph is freed before the plain path runs."""
    params, _ = state
    _, lk, gk = loss_and_grads(params, buffers, *batch, s_val, 1.0)
    loss_k = float(lk["loss"].detach())
    pk, _, _ = step(*state, buffers, *batch, s_val, lrs, 1.0)
    del lk
    torch.cuda.empty_cache()
    with twins:
        _, lp, gp = loss_and_grads(params, buffers, *batch, s_val, 1.0)
        loss_p = float(lp["loss"].detach())
        del lp
        pp, _, _ = step(*state, buffers, *batch, s_val, lrs, 1.0)
    report = {"loss_kernel": loss_k, "loss_plain": loss_p}
    _check(abs(loss_k - loss_p) <= 1e-4 * abs(loss_p), report)
    gp_l, pk_l, pp_l = dict(_leaves(gp)), dict(_leaves(pk)), dict(_leaves(pp))
    for name, a in _leaves(gk):
        b = gp_l[name]
        if name == "s_val":
            continue
        rel = _rel_l2(a, b)
        report[f"grad_rel_l2.{name}"] = rel
        _check(rel < 1e-2, (name, rel))
        clear = b.abs() > 1e-5
        if bool(clear.any()):
            d = float((pk_l[name] - pp_l[name])[clear].abs().max())
            report[f"post_adam_max_abs.{name}"] = d
            _check(d < 1e-4, (name, d))
    return report


def _touched(torch, cols, pack):
    """(f32 bytes of the pack columns ``cols`` (any shape) reach, each
    once; bytes of the distinct 32-byte sectors those columns lie in, in
    each row of the contiguous ``pack``: device memory moves whole
    sectors)."""
    c = cols.reshape(-1)
    c = torch.unique(c[(c >= 0) & (c < pack.shape[1])])
    n_rows, rp = pack.shape
    # float offset of each pack row within its sector, by row
    offsets = [(pack.data_ptr() // 4 + k * rp) % 8 for k in range(n_rows)]
    sectors = sum(offsets.count(o) * torch.unique((c + o) // 8).numel()
                  for o in set(offsets))
    return c.numel() * n_rows * 4, sectors * 32


def _check_serve(torch, name, fn, plain, args, touched, n_flops, path):
    """A serve kernel (B1, B5): bit-equal to its twin and on a repeat;
    timed; bound by the bytes its call must move (the touched pack
    columns, inputs, output) and, beside it, by the same with the touched
    pack columns counted in whole 32-byte sectors."""
    got = fn(*args)
    want = plain(*args)
    err = float((got - want).abs().max())
    _check(err == 0.0, f"{name} ({path}) differs from its plain twin: {err}")
    _check(torch.equal(got, fn(*args)), f"{name} ({path}) is not deterministic")
    cols, sectors = touched
    rest = _nbytes(*args[1:], got)
    bound = _bound(cols + rest, n_flops, PEAK_F32_FLOPS)
    sector_bound = _bound(sectors + rest, n_flops, PEAK_F32_FLOPS)[0]
    ms = _time_ms(lambda: fn(*args), 5, torch)
    return dict(path=path, max_abs_err=err, m=args[1].numel(), ms=ms,
                plain_ms=_time_ms(lambda: plain(*args), 2, torch),
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                touched_mb=cols / 1e6, sector_mb=sectors / 1e6,
                sector_bound_ms=sector_bound,
                sector_bound_share=sector_bound / ms,
                whole_pack_bound_ms=_nbytes(args[0]) / PEAK_BYTES_PER_S * 1e3)


def _check_accumulate(torch, name, fn, plain, args, keys, library, n_flops,
                      path):
    """An accumulate kernel (B2, B6, B7): within 1e-4 of the largest value
    of its twin (``index_add_`` atomics add in any order), bit-equal on a
    repeat; timed; bound by inputs read once and the dense output written
    once; the library time is ``library()``, ``index_add_`` alone on
    updates formed outside the timed region."""
    got = fn(*args)
    want = plain(*args)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    del want
    _check(err <= 1e-4 * scale + 1e-12, f"{name} ({path}): {err} vs {scale}")
    _check(torch.equal(got, fn(*args)), f"{name} ({path}) is not deterministic")
    longest = int(torch.unique_consecutive(torch.sort(keys)[0],
                                           return_counts=True)[1].max())
    bound = _bound(_nbytes(*args[:-1], got), n_flops, PEAK_F32_FLOPS)
    del got
    torch.cuda.empty_cache()
    return dict(path=path, max_abs_err=err, m=args[0].numel(),
                longest_run=longest,
                ms=_time_ms(lambda: fn(*args), 3, torch),
                plain_ms=_time_ms(lambda: plain(*args), 2, torch),
                bound_ms=bound[0], bound_by=bound[1],
                library_ms=_time_ms(library, 2, torch))


def _mlp_bwd_flops(ws, m):
    """Operations of an MLP backward over ``m`` samples: the hidden
    layers' forward products recomputed (the last layer's ``dz`` is the
    given ``g``), then a dW and a dx product for every layer."""
    macs = [w.shape[0] * w.shape[1] for w in ws]
    return 2 * m * (sum(macs[:-1]) + 2 * sum(macs))


def _ptxas(kernel, fragments):
    """Registers, static shared memory, stack and spill bytes of each
    kernel entry of ``kernel`` whose mangled name holds one of
    ``fragments``, from its ``nvcc -Xptxas -v`` log."""
    import re

    out, cur = {}, None
    for line in kernel.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = (m.group(1) if any(f in m.group(1) for f in fragments)
                   else None)
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_bytes=int(m.group(1)),
                            spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem_bytes"] = int(m.group(1)) if m else 0
    return out


def _kernel_ms(torch, fn, fragments, n=2):
    """Device ms per call of the kernels whose names hold each of
    ``fragments`` (the first that matches), from ``torch.profiler`` over
    ``n`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {f: 0.0 for f in fragments}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        f = next((f for f in fragments if f in e.key), None)
        if f is not None:
            out[f] += t / (1e3 * n)
    return out


def _b9_plan(torch, blocks, ws):
    """B9's plan for one call (``ops/cuda/fused_mlp_cm.py:bwd_plan`` over
    the wrapper's padded widths) and its blocks' dynamic shared memory by
    the launcher's own formula (``fused_mlp_bwd_smem_bytes``)."""
    import ctypes

    from fgs_nerf_tpu_torch.ops import fused_mlp_cm as FM
    from fgs_nerf_tpu_torch.ops.cuda import fused_mlp_cm as B89

    rows = [b.shape[0] for b in blocks]
    kp = ([B89._pad16(FM.pad_plan(rows)[1])]
          + [B89._pad16(w.shape[0]) for w in ws[1:]])
    np_ = [B89._pad16(w.shape[1]) for w in ws]
    n_sm = torch.cuda.get_device_properties(blocks[0].device)
    plan = B89.bwd_plan(blocks[0].shape[1], kp, np_,
                        n_sm.multi_processor_count)
    f = B89.KERNEL.lib().fused_mlp_bwd_smem_bytes
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int]
    f.restype = ctypes.c_longlong
    c_kp = (ctypes.c_int * len(kp))(*kp)
    c_np = (ctypes.c_int * len(np_))(*np_)
    smem = {"tile": f(c_kp, c_np, len(kp), 0), "dw": f(c_kp, c_np, len(kp), 1)}
    return plan, smem


def _b8_plan(torch, blocks, ws):
    """B8's launch for one call (``ops/cuda/fused_mlp_cm.py:fwd_plan`` over
    the wrapper's padded widths) and its block's dynamic shared memory by
    the launcher's own formula (``fused_mlp_fwd_smem_bytes``)."""
    import ctypes

    from fgs_nerf_tpu_torch.ops import fused_mlp_cm as FM
    from fgs_nerf_tpu_torch.ops.cuda import fused_mlp_cm as B89

    rows = [b.shape[0] for b in blocks]
    kp = ([B89._pad16(FM.pad_plan(rows)[1])]
          + [B89._pad16(w.shape[0]) for w in ws[1:]])
    np_ = [B89._pad16(w.shape[1]) for w in ws]
    props = torch.cuda.get_device_properties(blocks[0].device)
    plan = B89.fwd_plan(blocks[0].shape[1], kp, np_,
                        props.multi_processor_count)
    f = B89.KERNEL.lib().fused_mlp_fwd_smem_bytes
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    f.restype = ctypes.c_longlong
    smem = f((ctypes.c_int * len(kp))(*kp), (ctypes.c_int * len(np_))(*np_),
             len(kp))
    return plan, smem


# B8's kernel: a fragment of its mangled name
_MLP_FWD_ENTRIES = ("fused_mlp_fwd",)
# B9's kernels: fragments of their mangled names
_MLP_BWD_ENTRIES = ("fused_mlp_tile_bwd", "fused_mlp_dw",
                    "mlp_reduce_partials")
# B6's kernels: fragments of their mangled names
_TAP_ACCUMULATE_ENTRIES = ("tap_tile_accumulate", "tap_block_sums",
                           "tap_run_totals")
# the serves' kernels (B1: one per channel instance, B5: per tap count)
_SERVE_ENTRIES = {"window_gather_cm": ("window_gather_tiles",),
                  "tap_window_serve_cm": ("tap_serve_samples",)}

# B3 / B4 call site -> fragments of its kernels' mangled names
_SHADE_ENTRIES = {"fused_shade_cm_fwd": ("fused_shade_fwd",),
                  "fused_shade_cm_bwd": ("fused_shade_bwd", "fused_shade_dw",
                                         "shade_reduce_partials")}


def _cin8(args):
    """Padded input rows of a recorded B3 / B4 call."""
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS

    return FS.pad_plan(FS.shade_layout(args[0].shape[0], *args[-3:],
                                       args[4] is not None))[1]


def _shade_smem(args):
    """Dynamic shared memory per block of B3, B4's per-tile pass and B4's
    dW kernel for one recorded call (the launchers' own formulas)."""
    import ctypes

    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS

    k0, vd, ws = args[0], args[4], args[5]
    f = FS.KERNEL.lib().fused_shade_smem_bytes
    f.argtypes = [ctypes.c_int] * 4
    f.restype = ctypes.c_longlong
    nraw = k0.shape[0] + 9 + 3 * (vd is not None)
    return {name: f(_cin8(args), ws[0].shape[1], nraw, i)
            for i, name in enumerate(("fwd", "bwd", "dw"))}


def _shade_chain_ms(torch, args, backward):
    """Context for B3 / B4, no port: the bf16 ``torch.matmul`` chain over
    the same padded products (forward: the three layers; backward: layers
    0-1 recomputed, then a dW and a dh product per layer), on operands
    made before the timed region."""
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS

    k0, xyz, refl, normal, vd, ws, bs = args[:7]
    pe = args[-3:]
    rows = FS.shade_layout(k0.shape[0], *pe, vd is not None)
    wps, bps = FS.pad_weights(ws, bs, rows)
    w = [x.to(torch.bfloat16) for x in wps]
    b = [x.to(torch.bfloat16) for x in bps]
    x = FS.build_shade_x(k0, xyz, refl, normal, vd, *pe).T.to(torch.bfloat16)

    def fwd():
        h1 = torch.relu(x @ w[0] + b[0])
        h2 = torch.relu(h1 @ w[1] + b[1])
        return h1, h2, h2 @ w[2]

    if not backward:
        return _time_ms(fwd, 3, torch)
    h1, h2, _ = fwd()
    dz = [torch.empty_like(h1).normal_(), torch.empty_like(h2).normal_(),
          torch.empty((x.shape[0], w[2].shape[1]), dtype=torch.bfloat16,
                      device=x.device).normal_()]

    def bwd():
        a1, a2, _ = fwd()
        return (a2.T @ dz[2], dz[2] @ w[2].T, a1.T @ dz[1], dz[1] @ w[1].T,
                x.T @ dz[0], dz[0] @ w[0].T)

    return _time_ms(bwd, 3, torch)


def _mlp_chain_bwd_ms(torch, blocks, ws, bs):
    """Context for B9, no port: the bf16 ``torch.matmul`` chain of its
    backward as ``_shade_chain_ms`` times B4's (the hidden layers
    recomputed, then a dW and a dh product per layer), on operands made
    before the timed region."""
    x = torch.cat(blocks, dim=0).T.to(torch.bfloat16)
    w = [a.to(torch.bfloat16) for a in ws]
    b = [a.to(torch.bfloat16) for a in bs]

    def hiddens():
        hs = [x]
        for wi, bi in zip(w[:-1], b[:-1]):
            hs.append(torch.relu(hs[-1] @ wi + bi))
        return hs

    dz = [torch.empty((x.shape[0], wi.shape[1]), dtype=torch.bfloat16,
                      device=x.device).normal_() for wi in w]

    def bwd():
        hs = hiddens()
        return [p for h, wi, d in zip(hs, w, dz) for p in (h.T @ d, d @ wi.T)]

    return _time_ms(bwd, 2, torch)


def _check_shade_fwd(torch, args, path):
    """B3: within 1e-2 of its twin with at most 1% of the logits past
    1e-5, bit-equal on a repeat; timed; bound by its products at the
    bf16 peak."""
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS

    k0, xyz, refl, normal, vd, ws, bs, *pe = args
    ins = (k0, xyz, refl, normal, vd)
    m = k0.shape[-1]
    got = FS.fused_shade_cm_fwd(*ins, ws, bs, *pe)
    want = FS.fused_shade_cm_fwd_plain(*ins, ws, bs, *pe)
    diff = (got - want).abs()
    err = float(diff.max())
    frac = float((diff > 1e-5).float().mean())
    _check(err < 1e-2 and frac < 0.01,
           f"B3 ({path}): max {err}, past 1e-5 {frac}")
    _check(torch.equal(got, FS.fused_shade_cm_fwd(*ins, ws, bs, *pe)),
           f"B3 ({path}) is not deterministic")
    macs = sum(w.shape[0] * w.shape[1] for w in ws)
    bound = _bound(_nbytes(*ins, *ws, *bs, got), 2 * macs * m,
                   PEAK_BF16_FLOPS)
    del got, want, diff
    return dict(path=path, hidden=ws[0].shape[1], cin8=_cin8(args), m=m,
                max_abs_err=err, share_past_1e5=frac,
                ms=_time_ms(lambda: FS.fused_shade_cm_fwd(*ins, ws, bs, *pe),
                            5, torch),
                plain_ms=_time_ms(
                    lambda: FS.fused_shade_cm_fwd_plain(*ins, ws, bs, *pe), 3,
                    torch),
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                matmul_chain_ms=_shade_chain_ms(torch, args, False),
                dynamic_smem_bytes=_shade_smem(args))


_SHADE_BWD_OUTPUTS = ("d_k0", "d_xyz", "d_refl", "d_normal", "d_vd", "dW0",
                      "dW1", "dW2", "db0", "db1", "db2")


def _mask_band(torch, FS, ins, ws, bs, pe, chunk=1 << 18):
    """Samples whose ReLU masks may follow the sum order: bool [M].

    The kernel and the float32 twin form the same bf16 products, exact in
    float32, and sum them (and the bias) in different orders, each within
    gamma_K * (sum_k |w_k h_k| + |b|) of the exact sum, gamma_K =
    K u / (1 - K u), K the products and the bias, u = 2^-23 (not 2^-24:
    the tensor cores' float32 sums may truncate).  Carried
    through both hidden layers in interval arithmetic, in float64 with
    every bf16 rounding kept: layer 1 sees the twin's own input X exactly,
    each hidden value then lies in [bf16(relu(lo)), bf16(relu(hi))], and a
    sample is in the band when a pre-activation interval of either layer
    holds 0 (``dz = dh * (z > 0)``)."""
    k0, xyz, refl, normal, vd = ins
    rows = FS.shade_layout(k0.shape[0], *pe, vd is not None)
    wps, bps = FS.pad_weights(ws, bs, rows)
    layers = [(FS.bf16_round(w.double()), b.double())
              for w, b in zip(wps[:-1], bps[:-1])]
    u = 2.0 ** -23
    m = k0.shape[-1]
    band = torch.zeros(m, dtype=torch.bool, device=k0.device)
    for a in range(0, m, chunk):
        part = [None if t is None else t[:, a:a + chunk] for t in ins]
        lo = hi = FS.build_shade_x(*part, *pe).double()
        for w, b in layers:
            k = w.shape[0] + 1
            gam = k * u / (1 - k * u)
            wa = w.abs().T
            z = w.T @ ((lo + hi) / 2) + b[:, None]
            rad = (wa @ ((hi - lo) / 2)
                   + gam * (wa @ torch.maximum(lo.abs(), hi.abs())
                            + b.abs()[:, None]))
            band[a:a + chunk] |= ((z - rad <= 0) & (z + rad > 0)).any(0)
            lo = FS.bf16_round(torch.relu(z - rad))
            hi = FS.bf16_round(torch.relu(z + rad))
            del z, rad, wa
    return band


def _shade_bwd_band(torch, FS, ins, ws, bs, pe, kern, plain):
    """B4's cotangents past relative L2 1e-3 of the twin: set aside the
    samples of ``_mask_band`` whose cotangents moved (more than 1e-3 of
    their own norm plus the output's per-sample RMS), at most
    ceil(1e-5 M); every other sample within 1e-3, the whole output
    within 1e-2."""
    m = ins[0].shape[-1]
    band = _mask_band(torch, FS, ins, ws, bs, pe)
    moved = torch.zeros_like(band)
    pairs = [(n, a.double(), b.double())
             for n, a, b in zip(_SHADE_BWD_OUTPUTS[:5], kern[:5], plain[:5])
             if b is not None]
    for _, a, b in pairs:
        nb = b.norm(dim=0)
        rms = nb.pow(2).mean().sqrt()
        moved |= (a - b).norm(dim=0) > 1e-3 * (nb + rms)
    moved &= band
    keep = ~moved
    out = dict(band_samples=int(band.sum()), set_aside=int(moved.sum()),
               cap=math.ceil(1e-5 * m))
    for name, a, b in pairs:
        out[name] = dict(whole=_rel_l2(a, b),
                         rest=_rel_l2(a[:, keep], b[:, keep]))
    return out


def _check_shade_bwd(torch, args, path):
    """B4: every cotangent, dW and db within relative L2 1e-3 of its
    twin, where a cotangent is past it, as ``_shade_bwd_band`` (see the
    module's tolerances); every output bit-equal on a repeat; timed;
    bound as ``_mlp_bwd_flops``."""
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS

    k0, xyz, refl, normal, vd, ws, bs, g, *pe = args
    ins = (k0, xyz, refl, normal, vd)
    m = k0.shape[-1]
    d_k, dw_k, db_k = FS.fused_shade_cm_bwd(*ins, ws, bs, g, *pe)
    d_p, dw_p, db_p = FS.fused_shade_cm_bwd_plain(*ins, ws, bs, g, *pe)
    kern, plain = list(d_k) + dw_k + db_k, list(d_p) + dw_p + db_p
    rels = {n: _rel_l2(a, b) for n, a, b in zip(_SHADE_BWD_OUTPUTS, kern,
                                                 plain) if b is not None}
    err = max(float((a - b).abs().max())
              for a, b in zip(kern, plain) if b is not None)
    rel_max = max(rels.values())
    _check(all(r < 1e-3 for n, r in rels.items() if not n.startswith("d_")),
           f"B4 ({path}) dW / db off their twin: {rels}")
    band = {}
    if rel_max >= 1e-3:
        band = _shade_bwd_band(torch, FS, ins, ws, bs, pe, kern, plain)
        _check(band["set_aside"] <= band["cap"]
               and all(band[n]["rest"] < 1e-3 and band[n]["whole"] < 1e-2
                       for n in _SHADE_BWD_OUTPUTS[:5] if n in band),
               f"B4 ({path}) cotangents off their twin: {band}")
    del kern, plain
    again = FS.fused_shade_cm_bwd(*ins, ws, bs, g, *pe)
    _check(all((a is None and b is None) or torch.equal(a, b) for a, b in
               zip(list(d_k) + dw_k + db_k,
                   list(again[0]) + again[1] + again[2])),
           f"B4 ({path}) is not deterministic")
    out_bytes = _nbytes(*[d for d in d_k if d is not None], *dw_k, *db_k)
    bound = _bound(_nbytes(*ins, *ws, *bs, g) + out_bytes,
                   _mlp_bwd_flops(ws, m), PEAK_BF16_FLOPS)
    del d_k, dw_k, db_k, d_p, dw_p, db_p, again
    torch.cuda.empty_cache()
    return dict(path=path, hidden=ws[0].shape[1], cin8=_cin8(args), m=m,
                max_abs_err=err, max_rel_l2=rel_max, mask_band=band,
                ms=_time_ms(lambda: FS.fused_shade_cm_bwd(*ins, ws, bs, g, *pe),
                            3, torch),
                plain_ms=_time_ms(
                    lambda: FS.fused_shade_cm_bwd_plain(*ins, ws, bs, g, *pe),
                    2, torch),
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                matmul_chain_ms=_shade_chain_ms(torch, args[:7] + args[8:],
                                                True),
                dynamic_smem_bytes=_shade_smem(args))


def _grid_sample_library(torch, pack, c, grid3, margin, rows, w8, want):
    """The library call beside a serve (B1, B5): one ``F.grid_sample``
    (trilinear: ``mode='bilinear'`` on a 5-D input, ``align_corners=True``,
    zero padding) of the unpacked [1, C, X, Y, Z] grid at the serve's own
    points, base cells from ``rows`` (real rows from ``margin`` on) and
    fractions from the weights ``w8`` [8, P] (corner k = dx*4 + dy*2 +
    dz), which the serve quantized.  Returns (ms, its largest difference
    from the serve's output ``want`` [C, P], that output's largest
    value)."""
    import torch.nn.functional as F

    from fgs_nerf_tpu_torch.ops import sorted_cm as ST

    x, y, z = grid3
    r = ST.padded_rows_cm(grid3)
    zp = ST.z_stride(z)
    grid = pack[:c, margin:margin + r].reshape(c, x + 2, y + 2, zp)[
        None, :, 1:1 + x, 1:1 + y, 1:1 + z].contiguous()
    real = (rows.long() - margin < r) & (w8.sum(0) != 0)
    b0, b1, b2 = ST.rows_to_coords_cm(
        torch.clamp(rows.long() - margin, 0, r - 1), grid3)
    ix = b0 - 1.0 + w8[4:8].sum(0)
    iy = b1 - 1.0 + w8[[2, 3, 6, 7]].sum(0)
    iz = b2 - 1.0 + w8[[1, 3, 5, 7]].sum(0)
    # grid_sample's last axis is (W, H, D) = (z, y, x); outside: zeros
    pts = torch.stack([2.0 * iz / (z - 1) - 1.0, 2.0 * iy / (y - 1) - 1.0,
                       2.0 * ix / (x - 1) - 1.0], -1)
    pts = torch.where(real[:, None], pts, torch.full_like(pts, 3.0))
    pts = pts.reshape(1, 1, 1, -1, 3)
    del b0, b1, b2, ix, iy, iz, real

    def call():
        return F.grid_sample(grid, pts, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    got = call().reshape(c, -1)
    err = float((got - want.reshape(c, -1)).abs().max())
    scale = float(want.abs().max())
    del got
    return _time_ms(call, 3, torch), err, scale


def _library_into(out, lib):
    """Record a serve's ``F.grid_sample`` time; the library call must
    compute the serve's function at its points (within 1e-4 of the
    output's largest value: it recomputes the fractions from the
    weights)."""
    ms, err, scale = lib
    _check(err <= 1e-4 * scale + 1e-12,
           f"F.grid_sample at the serve's points: {err} vs {scale}")
    out.update(library_ms=ms, library="F.grid_sample",
               library_max_abs_err=err)


def _serve_library(torch, name, args, path, grid3):
    """``_grid_sample_library`` for a recorded B1 or B5 call on a grid of
    ``grid3`` (the fine x taps serve the transposed grid from a margin of
    128 columns, the z/y taps from their envelope's margin)."""
    from fgs_nerf_tpu_torch.ops import sorted_cm as ST
    from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56
    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1

    if name == "window_gather_cm":
        pack, rows, w8 = args
        c = pack.shape[0] // 4
        return _grid_sample_library(torch, pack, c, grid3, 0, rows, w8,
                                    B1.window_gather_cm_plain(*args))
    pack, rows, delta, w8t = args
    if "x taps" in path:
        grid3, maxneg = tuple(grid3)[::-1], 4
    else:
        maxneg = ST.tap_bounds(grid3)[0]
    margin = (maxneg + 127) // 128 * 128
    n_taps = delta.shape[0]
    rows_t = (rows[None, :].long() + delta.long()).reshape(-1)
    # (t, d, k2)-packed weights -> corner k = k2 * 2 + d, taps one after
    # another
    w8 = torch.cat([torch.stack([w8t[8 * t + 4 * (k & 1) + (k >> 1)]
                                 for k in range(8)]) for t in range(n_taps)],
                   dim=1)
    return _grid_sample_library(torch, pack, 1, grid3, margin, rows_t, w8,
                                B56.tap_window_serve_cm_plain(*args))


def _check_call(torch, name, args, path, grid3):
    """Hold one recorded call of the kernel call site ``name`` (a
    function of ``ops/sorted_cm.py`` or ``ops/cuda/fused_shade_cm.py``)
    against its twin; time and bound it.  A serve (B1, B5) also gets its
    library time (``F.grid_sample`` at its points on the grid of shape
    ``grid3``, the call's own)."""
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
    from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56
    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1

    if name == "fused_shade_cm_fwd":
        return _check_shade_fwd(torch, args, path)
    if name == "fused_shade_cm_bwd":
        return _check_shade_bwd(torch, args, path)
    if name == "window_gather_cm":
        pack, rows, w8 = args
        c = pack.shape[0] // 4
        cols = torch.stack([rows, rows + 1])
        out = _check_serve(torch, name, B1.window_gather_cm,
                           B1.window_gather_cm_plain, args,
                           _touched(torch, cols, pack),
                           16 * c * rows.numel(), path)
        # the tile design: which tiles take the staged branch, the stage
        out["staged_share"] = float(
            B1.staged_tiles(rows, c).double().mean())
        out["smem_bytes"] = _b1_smem(c)
        out["segment64_bound_ms"] = _segment64_bound(
            torch, cols, pack, _nbytes(rows, w8) + 4 * c * rows.numel())
        _library_into(out, _serve_library(torch, name, args, path, grid3))
        return out
    if name == "tap_window_serve_cm":
        pack, rows, delta, w8t = args
        cols = rows[None, :] + delta
        cols = torch.stack([cols, cols + 1])
        out = _check_serve(torch, name, B56.tap_window_serve_cm,
                           B56.tap_window_serve_cm_plain, args,
                           _touched(torch, cols, pack), 16 * delta.numel(),
                           path)
        out["smem_bytes"] = 0  # no stage: its pack reads hit L1/L2
        out["segment64_bound_ms"] = _segment64_bound(
            torch, cols, pack, _nbytes(rows, delta, w8t) + 4 * delta.numel())
        _library_into(out, _serve_library(torch, name, args, path, grid3))
        return out
    if name == "dense_accumulate_cm":
        rows, w8, g, n_rows = args
        upd0, upd1 = B2.dense_updates(w8, g)
        idx = torch.cat([rows, rows + 1]).long()
        upd = torch.cat([upd0, upd1], dim=1)
        del upd0, upd1
        return _check_accumulate(
            torch, name, B2.dense_accumulate_cm,
            B2.dense_accumulate_cm_plain, args, rows,
            lambda: torch.zeros((4 * g.shape[0], n_rows),
                                device=g.device).index_add_(1, idx, upd),
            16 * g.shape[0] * rows.numel(), path)
    rows, delta, w8t, g, n_rows = args
    idx, upd = B56.tap_updates(rows, delta, w8t, g)
    keys = (rows[None, :] + delta).reshape(-1)
    out = _check_accumulate(
        torch, name, B56.tap_dense_accumulate_cm,
        B56.tap_dense_accumulate_cm_plain, args, keys,
        lambda: torch.zeros((4, n_rows), device=g.device).index_add_(
            1, idx, upd),
        16 * delta.numel(), path)
    del idx, upd
    # the wrapper's own sort (keys formed and sorted), part of ``ms``
    out["sort_ms"] = _time_ms(
        lambda: torch.sort((rows[None, :] + delta).reshape(-1), stable=True),
        3, torch)
    out["smem_bytes"] = _tap_smem(keys.numel(), n_rows)
    return out


def _segment64_bound(torch, cols, pack, rest):
    """Context for a serve's sector bound: the same bytes (``rest``: all
    but the pack) with the touched pack columns counted in whole 64-byte
    segments of each pack row (the pack rows start on 64-byte boundaries:
    a fresh allocation, rows of a multiple of 512 floats)."""
    c = cols.reshape(-1)
    c = torch.unique(c[(c >= 0) & (c < pack.shape[1])] // 16)
    return (c.numel() * 64 * pack.shape[0] + rest) / PEAK_BYTES_PER_S * 1e3


def _b1_smem(c):
    """Dynamic shared memory per B1 block for C channels (the launcher's
    own formula)."""
    import ctypes

    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1

    f = B1.KERNEL.lib().window_gather_cm_smem_bytes
    f.argtypes = [ctypes.c_int]
    f.restype = ctypes.c_longlong
    return f(c)


def _tap_smem(n, n_rows):
    """Dynamic shared memory per block of B6's tile kernel for ``n``
    deposits over ``n_rows`` rows (the launcher's own formula)."""
    import ctypes

    from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56

    f = B56.KERNEL.lib().tap_dense_accumulate_smem_bytes
    f.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    f.restype = ctypes.c_longlong
    return f(n, n_rows)


def _fine_phases(torch, np, card, dev, batch, n_rand):
    """Phases 5-8 at the ``bench.py:_fine_workload`` configuration.
    Returns (per-kernel lists of checked calls, main-path launch counts,
    masked-path launch counts)."""
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.ops import scatter as SC
    from fgs_nerf_tpu_torch.ops import sorted_cm as ST
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS
    from fgs_nerf_tpu_torch.ops.cuda import masked_adam as A1
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
    from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56
    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1
    from fgs_nerf_tpu_torch.optim.masked_adam import init_state

    displace = FINE_DISPLACE
    cfg, _, params0, lrs, s_val, loss_and_grads, step = _setup(
        torch, M, "fine", "sorted", dev, n_rand)
    xyz_min = np.array(XYZ_MIN, np.float32)
    xyz_max = np.array(XYZ_MAX, np.float32)
    m1, m2 = n_rand * cfg.sample_k, n_rand * cfg.shade_k
    print(json.dumps({
        "config": "bench.py fine", "world_size": cfg.world_size,
        "s_max": cfg.s_max, "samples_pass1": m1, "samples_pass2": m2,
        "padded_rows": ST.padded_rows_cm(cfg.world_size),
        "pack_cols": ST.rp_for(cfg.world_size),
        "tap_bounds_zy": ST.tap_bounds(cfg.world_size),
        "rgbnet_in": cfg.rgbnet_in_dim(), "refnet_in": cfg.refnet_in_dim()}))
    sites = {"window_gather_cm": (ST, B1.KERNEL),
             "dense_accumulate_cm": (ST, B2.KERNEL),
             "tap_window_serve_cm": (ST, B56.KERNEL),
             "tap_dense_accumulate_cm": (ST, B56.KERNEL)}

    def record(names, calls):
        def rec(name, fn):
            def wrapped(*args):
                calls.setdefault(name, []).append(_clone(args, torch))
                return fn(*args)
            return wrapped
        return _patched([(ST, n, rec(n, getattr(ST, n))) for n in names])

    def label(name, args):
        """Which call of the step: pass 1 / 2 by the sample count, z/y or
        x taps by the tap count (delta is args[2] of B5, args[1] of B6)."""
        if name == "tap_window_serve_cm":
            n_taps = args[2].shape[0]
        elif name == "tap_dense_accumulate_cm":
            n_taps = args[1].shape[0]
        else:
            return "fine pass 1" if args[1].shape[-1] == m1 else "fine pass 2"
        return "fine z/y taps" if n_taps == 4 * len(displace) else "fine x taps"

    def check_all(calls, suffix=""):
        out = {}
        for name in list(calls):
            for args in calls[name]:
                r = _check_call(torch, name, args, label(name, args) + suffix,
                                grid3=cfg.world_size)
                out.setdefault(name, []).append(r)
                print(json.dumps({"kernel": name, **r, "card": card}))
            del calls[name]
            torch.cuda.empty_cache()
        return out

    # ---- 5. fine kernel checks on the main path's own inputs ------------
    calls = {}
    with record(sites, calls):
        loss_and_grads(params0, {}, *batch, s_val, 1.0)
    torch.cuda.synchronize()
    _check({n: len(v) for n, v in calls.items()} == {n: 2 for n in sites},
           {n: len(v) for n, v in calls.items()})
    fine_calls = check_all(calls)

    def counts():
        return {n: k.launches[n] for n, (_, k) in sites.items()}

    def zero_counts():
        for k in [k for _, k in sites.values()] + [A1.KERNEL]:
            for fn in k.launches:
                k.launches[fn] = 0

    def adam_counts(path, n_steps):
        n = A1.KERNEL.launches["masked_adam_step"]
        want = _adam_leaves(params0, lrs) * n_steps
        print(json.dumps({"path": path, "masked_adam_step_launches": n,
                          "steps": n_steps, "card": card}))
        _check(n == want, f"{path}: {n} masked Adam launches, {want} "
                          "expected (one a leaf a step)")
        return n

    # ---- 6. fine main path ----------------------------------------------
    zero_counts()
    params, opt_state = params0, init_state(params0)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(N_WARMUP + N_FINE_STEPS):
        if i == N_WARMUP:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, {}, *batch,
                                          s_val, lrs, 1.0)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t_start) / N_FINE_STEPS
    launches = counts()
    losses = [float(x) for x in losses]
    print(json.dumps({
        "metric": "train_rays_per_s_fine", "value": n_rand / dt,
        "step_ms": dt * 1e3, "steps": N_FINE_STEPS, "card": card,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "launches": launches,
        "metrics": {k: float(v) for k, v in metrics.items()},
    }))
    _check(all(np.isfinite(losses)), losses)
    _check(losses[-1] < losses[0], f"fine loss did not fall: {losses}")
    for name, n in launches.items():
        _check(n == 2 * (N_WARMUP + N_FINE_STEPS),
               f"{name}: {n} launches on the fine path, 2 per step expected")
    launches["masked_adam_step"] = adam_counts("fine",
                                               N_WARMUP + N_FINE_STEPS)
    _device_breakdown(torch, lambda: step(params, opt_state, {}, *batch,
                                          s_val, lrs, 1.0), dt * 1e3, card,
                      path="fine")

    # ---- 7. masked traffic ----------------------------------------------
    band = torch.where(params0["sdf"].abs() < 0.3, 1e-3, 0.0)
    buffers = {"mask_cache": M.build_mask_cache(band, xyz_min, xyz_max)}
    zero_counts()
    p_m, o_m = params0, init_state(params0)
    calls = {}
    with record(sites, calls):
        p_m, o_m, met1 = step(p_m, o_m, buffers, *batch, s_val, lrs, 1.0)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    p_m, o_m, met2 = step(p_m, o_m, buffers, *batch, s_val, lrs, 1.0)
    torch.cuda.synchronize()
    dt_m = time.perf_counter() - t_start
    masked_launches = counts()
    print(json.dumps({
        "metric": "train_rays_per_s_fine_masked", "value": n_rand / dt_m,
        "step_ms": dt_m * 1e3, "card": card,
        "losses": [float(met1["loss"]), float(met2["loss"])],
        "launches": masked_launches,
        "metrics": {k: float(v) for k, v in met2.items()}}))
    _check(np.isfinite(float(met1["loss"])) and np.isfinite(float(met2["loss"])),
           "masked fine loss is not finite")
    for name, n in masked_launches.items():
        _check(n == 4, f"{name}: {n} launches in two masked fine steps")
    masked_launches["masked_adam_step"] = adam_counts("fine masked", 2)
    for name, rs in check_all(calls, " masked").items():
        fine_calls[name] += rs
    del p_m, o_m, buffers, band
    torch.cuda.empty_cache()

    # ---- 8. fine kernel path against plain path ---------------------------
    report = _step_vs_plain(torch, loss_and_grads, step, (params, opt_state),
                            {}, batch, s_val, lrs,
                            _plain_twins(ST, FS, SC, B1, B2, B56, B7))
    print(json.dumps({"fine_kernel_vs_plain_step": report, "card": card}))
    return fine_calls, launches, masked_launches


@contextlib.contextmanager
def _record_b7(torch, IT, SC, stage, calls):
    """Record every B7 call's inputs with the gather it is the backward
    of: the fused field (idx [N, S, 3]), the center taps (idx [..., 6, 1,
    3]) or the hierarchical taps (idx [..., 6, D, 3])."""
    labels = []
    classes = (IT._TrilinearSampleIndex, IT._TrilinearSampleIndexPacked)
    saved = [(cls, cls.__dict__["backward"]) for cls in classes]
    site = SC.dense_accumulate

    def labelled(fn):
        def backward(ctx, g):
            shape = ctx.saved_tensors[0].shape
            kind = ("field" if len(shape) == 3 else
                    "center taps" if shape[-2] == 1 else "hierarchical taps")
            labels.append(f"{stage} {kind}")
            return fn(ctx, g)
        return staticmethod(backward)

    def rec(*args):
        calls.append((labels[-1], _clone(args, torch)))
        return site(*args)

    for cls, sm in saved:
        cls.backward = labelled(sm.__func__)
    SC.dense_accumulate = rec
    try:
        yield
    finally:
        SC.dense_accumulate = site
        for cls, sm in saved:
            cls.backward = sm


def _lattice_phases(torch, np, card, dev, batch, n_rand):
    """Phases 9-11: the lattice engine's coarse and fine steps.  Returns
    (B7's checked calls, launch counts per path, the fine state for the
    eval render)."""
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.ops import interp as IT
    from fgs_nerf_tpu_torch.ops import scatter as SC
    from fgs_nerf_tpu_torch.ops import sorted_cm as ST
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS
    from fgs_nerf_tpu_torch.ops.cuda import masked_adam as A1
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
    from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56
    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1
    from fgs_nerf_tpu_torch.optim.masked_adam import init_state

    kernels = (B1.KERNEL, B2.KERNEL, FS.KERNEL, B56.KERNEL, B7.KERNEL,
               A1.KERNEL)

    def zero_counts():
        for k in kernels:
            for fn in k.launches:
                k.launches[fn] = 0

    def counts():
        return {fn: n for k in kernels for fn, n in k.launches.items() if n}

    b7_calls, launches = [], {}
    per_step = {"coarse": 1, "fine": 3}
    n_steps = {"coarse": N_STEPS, "fine": N_FINE_STEPS}
    for stage in ("coarse", "fine"):
        path = f"lattice {stage}"
        cfg, box, params0, lrs, s_val, loss_and_grads, step = _setup(
            torch, M, stage, "lattice", dev, n_rand)
        print(json.dumps({"config": f"bench.py {stage}, engine lattice",
                          "world_size": cfg.world_size, "s_max": cfg.s_max,
                          "sample_k": cfg.sample_k, "shade_k": cfg.shade_k,
                          "samples_per_step": n_rand * cfg.sample_k}))

        # ---- 9. / 11. B7 on the main path's own inputs -----------------
        calls = []
        with _record_b7(torch, IT, SC, stage, calls):
            loss_and_grads(params0, {}, *batch, s_val, 1.0)
        torch.cuda.synchronize()
        _check(len(calls) == per_step[stage],
               f"{path}: {[c[0] for c in calls]}")
        torch.cuda.empty_cache()
        while calls:
            label, args = calls.pop(0)
            rows, upd, cap = args
            idx = rows.long()
            # one add per update value
            r = _check_accumulate(
                torch, "B7", B7.dense_accumulate, B7.dense_accumulate_plain,
                args, rows,
                lambda: torch.zeros((cap, upd.shape[1]),
                                    device=upd.device).index_add_(0, idx, upd),
                upd.numel(), label)
            r.update(c=upd.shape[1], cap=cap)
            del args, rows, upd, idx
            torch.cuda.empty_cache()
            b7_calls.append(r)
            print(json.dumps({"kernel": "dense_accumulate", **r, "card": card}))

        # ---- 10. / 11. main path --------------------------------------
        zero_counts()
        params, opt_state = params0, init_state(params0)
        losses = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(N_WARMUP + n_steps[stage]):
            if i == N_WARMUP:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, {}, *batch,
                                              s_val, lrs, 1.0)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t_start) / n_steps[stage]
        launches[path] = counts()
        losses = [float(x) for x in losses]
        print(json.dumps({
            "metric": f"train_rays_per_s_lattice_{stage}",
            "value": n_rand / dt, "step_ms": dt * 1e3,
            "steps": n_steps[stage], "card": card,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": losses, "launches": launches[path],
            "metrics": {k: float(v) for k, v in metrics.items()}}))
        _check(all(np.isfinite(losses)), losses)
        _check(losses[-1] < losses[0], f"{path} loss did not fall: {losses}")
        want = {"dense_accumulate": per_step[stage] * (N_WARMUP + n_steps[stage]),
                "masked_adam_step": _adam_leaves(params0, lrs)
                * (N_WARMUP + n_steps[stage])}
        _check(launches[path] == want,
               f"{path}: launches {launches[path]}, expected {want}")
        _device_breakdown(torch, lambda: step(params, opt_state, {}, *batch,
                                              s_val, lrs, 1.0), dt * 1e3,
                          card, path=path)
        report = _step_vs_plain(torch, loss_and_grads, step,
                                (params, opt_state), {}, batch, s_val, lrs,
                                _plain_twins(ST, FS, SC, B1, B2, B56, B7))
        print(json.dumps({f"{path}_kernel_vs_plain_step": report,
                          "card": card}))
        del params0, opt_state, report
        torch.cuda.empty_cache()
    return b7_calls, launches, (cfg, box, params, s_val)


def _eval_phase(torch, np, card, fine_state):
    """Phase 12: one 800 x 800 view of the procedural sphere through
    ``eval/render.py`` (lattice engine, no autograd)."""
    from fgs_nerf_tpu_torch.data.rays import get_rays_of_a_view
    from fgs_nerf_tpu_torch.data.synthetic import (
        intrinsics, pose_spherical, shade_sphere,
    )
    from fgs_nerf_tpu_torch.eval import render as R
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7

    cfg, box, params, s_val = fine_state
    h = w = 800
    k = intrinsics(h, w)
    c2w = pose_spherical(30.0, -30.0, 4.0)
    conv = dict(ndc=False, inverse_y=False, flip_x=False, flip_y=False)
    rays_o, rays_d, _ = get_rays_of_a_view(h, w, k, c2w, **conv)
    gt, mask = shade_sphere(rays_o, rays_d)
    render_chunk = R.make_render_fn(cfg, box, near=2.0, bg=1.0)
    n0 = B7.KERNEL.launches["dense_accumulate"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    img = R.render_image(render_chunk, params, {}, h, w, k, c2w, conv, s_val)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t_start
    t_start = time.perf_counter()
    stats = R.render_viewpoints(render_chunk, params, {}, [c2w], [(h, w)],
                                [k], conv, s_val, gt_imgs=[gt], masks=[mask])
    t_view = time.perf_counter() - t_start
    rgb = stats["rgbs"][0]
    print(json.dumps({
        "metric": "eval_render_800x800", "s_per_view": t_render,
        "rays_per_s": h * w / t_render,
        "s_per_view_with_metrics": t_view, "psnr": stats["psnr"][0],
        "fore_psnr": stats["fore_psnr"][0], "bg_psnr": stats["bg_psnr"][0],
        "ssim": stats["ssim"][0], "overflow_frac": img["overflow_frac"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card}))
    _check(rgb.shape == (h, w, 3), rgb.shape)
    _check(bool(np.all(np.isfinite(rgb))) and rgb.min() >= 0.0
           and rgb.max() <= 1.0, "eval pixels not finite or outside [0, 1]")
    _check(np.array_equal(rgb, img["rgb_marched"]),
           "two renders of one view differ")
    _check(B7.KERNEL.launches["dense_accumulate"] == n0,
           "the eval render ran a backward")


def _mlp_phase(torch, np, card, dev, batch, n_rand):
    """Phase 13: B8/B9 on the fine shading head's own inputs.  Returns
    (the kernel rows' call records, launches on the op's path)."""
    from fgs_nerf_tpu_torch.models import mlp as MLP
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.ops import fused_mlp_cm as FM
    from fgs_nerf_tpu_torch.ops.cuda import fused_mlp_cm as B89

    _check(not any(B89.KERNEL.launches.values()),
           f"B8/B9 launched before phase 13: {B89.KERNEL.launches}")
    torch.cuda.reset_peak_memory_stats()
    cfg, _, params0, _, s_val, loss_and_grads, _ = _setup(
        torch, M, "fine", "sorted", dev, n_rand)
    seen = []
    real = M._mlp_apply_cm

    def rec(mlp_params, blocks, bf16):
        seen.append(([b.detach().clone().contiguous() for b in blocks],
                     {k: v.detach().clone() for k, v in mlp_params.items()}))
        return real(mlp_params, blocks, bf16)

    # the head's capacity, every row of the pass-2 stream (M = n_rand x
    # shade_k), not the live prefix the step computes
    with _patched([(M, "_mlp_apply_cm", rec),
                   (M, "HEAD_ROW_MULTIPLE", 1 << 62)]):
        loss_and_grads(params0, {}, *batch, s_val, 1.0)
    torch.cuda.synchronize()
    del params0
    nets = {}
    for blocks, mp in seen:
        n = len(mp) // 2
        name = "rgbnet" if mp[f"w{n - 1}"].shape[1] > 8 else "refnet"
        nets[name] = (blocks, [mp[f"w{i}"] for i in range(n)],
                      [mp[f"b{i}"] for i in range(n)])
    _check(sorted(nets) == ["refnet", "rgbnet"], sorted(nets))
    del seen
    torch.cuda.empty_cache()

    # the op's path through the kernels: zero, run forward + backward, read
    for fn in B89.KERNEL.launches:
        B89.KERNEL.launches[fn] = 0
    gen = torch.Generator(device=dev).manual_seed(13)
    gs = {}
    for name, (blocks, ws, bs) in nets.items():
        g = torch.randn((ws[-1].shape[1], blocks[0].shape[1]), generator=gen,
                        device=dev)
        gs[name] = g
        leaves = [b.clone().requires_grad_(True) for b in blocks]
        wl = [w.clone().requires_grad_(True) for w in ws]
        out = FM.fused_mlp_cm(leaves, wl, [b.clone() for b in bs])
        _check(out.shape == (ws[-1].shape[1], blocks[0].shape[1]), out.shape)
        (out * g).sum().backward()
        _check(all(bool(torch.isfinite(x.grad).all()) for x in leaves + wl),
               f"{name}: non-finite gradient through the op")
        del out, leaves, wl
    torch.cuda.synchronize()
    launches = dict(B89.KERNEL.launches)
    _check(launches == {"fused_mlp_fwd": 2, "fused_mlp_bwd": 2}, launches)
    torch.cuda.empty_cache()

    calls = {"fused_mlp_fwd": [], "fused_mlp_bwd": []}
    for name, (blocks, ws, bs) in nets.items():
        g = gs[name]
        m = blocks[0].shape[1]
        macs = sum(w.shape[0] * w.shape[1] for w in ws) * m
        in_bytes = _nbytes(*blocks, *ws, *bs)
        widths = [ws[0].shape[0]] + [w.shape[1] for w in ws]
        got = FM.fused_mlp_cm_fwd(blocks, ws, bs)
        want = FM.fused_mlp_cm_fwd_plain(blocks, ws, bs)
        diff = (got - want).abs()
        err = float(diff.max())
        share = {t: float((diff > t).float().mean()) for t in (1e-5, 1e-4, 1e-3)}
        _check(err < 1e-2 and share[1e-5] < MLP_FLIP_SHARE,
               f"B8 {name}: max {err}, shares past 1e-5/1e-4/1e-3 {share}")
        _check(torch.equal(got, FM.fused_mlp_cm_fwd(blocks, ws, bs)),
               f"B8 {name} is not deterministic")
        bound = _bound(in_bytes + _nbytes(got), 2 * macs, PEAK_BF16_FLOPS)
        # both roofs: bytes (inputs read once, the output written once) and
        # operations (the unpadded net's products)
        roofs = {"bytes": (in_bytes + _nbytes(got)) / PEAK_BYTES_PER_S * 1e3,
                 "operations": 2 * macs / PEAK_BF16_FLOPS * 1e3}
        plan8, smem8 = _b8_plan(torch, blocks, ws)
        _check(smem8 == plan8["smem"] and plan8["stages"] >= 2,
               f"B8 {name}: shared memory {smem8} vs the wrapper's plan {plan8}")
        # control: hiddens left in f32 must fail the share limit
        ctrl = FM.fused_mlp_cm_fwd_plain(blocks, ws, bs, round_hidden=False)
        ctrl_share = float(((ctrl - want).abs() > 1e-5).float().mean())
        _check(ctrl_share > MLP_FLIP_SHARE,
               f"B8 {name}: the unrounded control passes ({ctrl_share})")
        del want, diff, got, ctrl
        x_cl = torch.cat(blocks, dim=0).T.contiguous()
        mp = {**{f"w{i}": w for i, w in enumerate(ws)},
              **{f"b{i}": b for i, b in enumerate(bs)}}
        r = dict(path=f"fine {name}", m=m, widths=widths, max_abs_err=err,
                 share_past={str(k): v for k, v in share.items()},
                 control_share_past_1e5={"no_hidden_rounding": ctrl_share},
                 ms=_time_ms(lambda: FM.fused_mlp_cm_fwd(blocks, ws, bs), 3,
                             torch),
                 plain_ms=_time_ms(
                     lambda: FM.fused_mlp_cm_fwd_plain(blocks, ws, bs), 2,
                     torch),
                 # the kernel alone, without the wrapper's weight layout
                 kernel_ms=_kernel_ms(
                     torch, lambda: FM.fused_mlp_cm_fwd(blocks, ws, bs),
                     _MLP_FWD_ENTRIES)["fused_mlp_fwd"],
                 bound_ms=bound[0], bound_by=bound[1],
                 bound_bytes_ms=roofs["bytes"],
                 bound_operations_ms=roofs["operations"], library_ms=None,
                 dynamic_smem_bytes=smem8,
                 plan={k: plan8[k] for k in ("tile", "grid", "stages",
                                             "chunks")},
                 l2_weight_bytes=plan8["l2_weight_bytes"],
                 ptxas=_ptxas(B89.KERNEL, _MLP_FWD_ENTRIES),
                 matmul_chain_ms=_time_ms(
                     lambda: MLP.mlp_apply(mp, x_cl, bf16=True), 3, torch))
        del x_cl
        calls["fused_mlp_fwd"].append(r)
        print(json.dumps({"kernel": "fused_mlp_fwd", **r, "card": card}))
        torch.cuda.empty_cache()

        plan, smem = _b9_plan(torch, blocks, ws)
        _check(smem == {"tile": plan["smem_tile"], "dw": plan["smem_dw"]},
               f"B9 {name}: shared memory {smem} vs the wrapper's plan {plan}")
        dx, dws, dbs = FM.fused_mlp_cm_bwd(blocks, ws, bs, g)
        plain = _b9_outputs(FM.fused_mlp_cm_bwd_plain(blocks, ws, bs, g))
        kernel = [dx] + dws + dbs
        _check([a.shape for a in kernel] == [b.shape for b in plain],
               f"B9 {name}: output shapes")
        err = max(float((a - b).abs().max()) for a, b in zip(kernel, plain))
        rel_max, dx_share = _b9_readings(kernel, plain)
        # controls: the twin without one of its bf16 roundings, which the
        # same check must reject
        control = {}
        for key, kw in (("no_dz_rounding", dict(round_dz=False)),
                        ("no_hidden_rounding", dict(round_hidden=False))):
            control[key] = _b9_readings(_b9_outputs(
                FM.fused_mlp_cm_bwd_plain(blocks, ws, bs, g, **kw)), plain)
        del plain, kernel
        report = dict(rel_l2=rel_max, dx_share=dx_share, control=control)
        _check(rel_max < MLP_REL_L2 and dx_share < MLP_DX_SHARE,
               f"B9 {name} fails its check: {report}")
        for key, (c_rel, c_share) in control.items():
            _check(c_rel > MLP_REL_L2 or c_share > MLP_DX_SHARE,
                   f"B9 {name}: the control {key} passes: {report}")
        again = FM.fused_mlp_cm_bwd(blocks, ws, bs, g)
        _check(all(torch.equal(a, b) for a, b in
                   zip([dx] + dws + dbs, [again[0]] + again[1] + again[2])),
               f"B9 {name} is not deterministic")
        out_bytes = _nbytes(dx, *dws, *dbs)
        del again, dx, dws, dbs
        torch.cuda.empty_cache()
        bound = _bound(in_bytes + _nbytes(g) + out_bytes,
                       _mlp_bwd_flops(ws, m), PEAK_BF16_FLOPS)
        r = dict(path=f"fine {name}", m=m, widths=widths, max_abs_err=err,
                 max_rel_l2=rel_max, dx_share_past_1e4_rms=dx_share,
                 limits={"rel_l2": MLP_REL_L2, "dx_share": MLP_DX_SHARE},
                 controls={k: {"max_rel_l2": v[0], "dx_share_past_1e4_rms": v[1]}
                           for k, v in control.items()},
                 ms=_time_ms(lambda: FM.fused_mlp_cm_bwd(blocks, ws, bs, g), 2,
                             torch),
                 # the per-tile pass, the dW kernel and the partial sums
                 kernels_ms=_kernel_ms(
                     torch, lambda: FM.fused_mlp_cm_bwd(blocks, ws, bs, g),
                     _MLP_BWD_ENTRIES),
                 scratch_bytes=2 * plan["scratch_elems"],
                 plan={k: plan[k] for k in ("nblk", "slices", "nr", "n_dwl")},
                 dynamic_smem_bytes=smem,
                 plain_ms=_time_ms(
                     lambda: FM.fused_mlp_cm_bwd_plain(blocks, ws, bs, g), 1,
                     torch),
                 bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                 matmul_chain_ms=_mlp_chain_bwd_ms(torch, blocks, ws, bs))
        # device memory: the phase's peak so far (the recorded inputs, the
        # nets, B9's scratch and partials, the twin's and chain's operands)
        r["phase_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        calls["fused_mlp_bwd"].append(r)
        print(json.dumps({"kernel": "fused_mlp_bwd", **r, "card": card}))
        torch.cuda.empty_cache()
    del nets, gs
    torch.cuda.empty_cache()
    return calls, launches


_PIPELINE_CONFIG = """\
from fgs_nerf_tpu_torch.config.base import deep_update
from fgs_nerf_tpu_torch.config.scenes import FULL_SYNTHETIC

# full_synthetic (the shiny_blender widths, 40 views of 256 x 256, 3 test
# views, N_rand 8,192) with the depth of every schedule cut; each stage
# still climbs all its pg_scale rungs to its full grid
config = deep_update(FULL_SYNTHETIC, dict(
    geometry_searching=dict(N_iters=16, pg_scale=[2, 4, 6, 8, 10, 12, 14],
                            reset_iter=[2, 4, 6, 8, 10, 12, 14],
                            decay_step_module={}),
    coarse_train=dict(N_iters=14, pg_scale=[2, 4, 6, 8, 10, 12],
                      tv_updates={}, decay_step_module={}),
    fine_train=dict(N_iters=6, pg_scale=[3], decay_step_module={}),
))
"""

_DTU_CONFIG = """\
from fgs_nerf_tpu_torch.config.base import deep_update
from fgs_nerf_tpu_torch.config.scenes import DTU

# the built-in dtu config whole (geometry 1,024,000 voxels from an 80^3
# base, coarse 1.5M with viewbase_pe 3, fine 256^3, N_rand 8,192,
# reso_level 2) with the depth of every schedule cut; each stage still
# climbs all its pg_scale rungs to its full grid
config = deep_update(DTU, dict(
    geometry_searching=dict(N_iters=16, pg_scale=[2, 4, 6, 8, 10, 12, 14],
                            reset_iter=[2, 4, 6, 8, 10, 12, 14],
                            decay_step_module={}),
    coarse_train=dict(N_iters=14, pg_scale=[2, 4, 6, 8, 10, 12],
                      tv_updates={}, decay_step_module={}),
    fine_train=dict(N_iters=6, pg_scale=[3], decay_step_module={}),
))
"""

# A DTU-like camera at 1,600 x 1,200: fx, fy ~ 2,890, principal point
# near the centre
DTU_K = ((2892.33, 0.0, 823.20), (0.0, 2883.18, 619.07), (0.0, 0.0, 1.0))
DTU_HW = (1200, 1600)
DTU_CENTRE = (-10.0, -30.0, 600.0)  # the scan's world origin of the sphere, mm
DTU_SCENE = 24


def _dtu_camera_centres(n_views, radius=3.2):
    """Camera centres in the normalised frame on an upper-hemisphere arc
    (+z up) around the origin: rings of elevation 20-60 degrees, each
    over a 200-degree arc of azimuth, as DTU's robot arm places them."""
    import numpy as np

    k = int(np.ceil(np.sqrt(n_views)))
    el, az = np.meshgrid(np.radians(np.linspace(20.0, 60.0, k)),
                         np.radians(np.linspace(-100.0, 100.0, k)),
                         indexing="ij")
    el, az = el.reshape(-1)[:n_views], az.reshape(-1)[:n_views]
    return radius * np.stack([np.cos(el) * np.sin(az),
                              -np.cos(el) * np.cos(az), np.sin(el)], -1)


def _look_at(c):
    """OpenCV c2w rotation (x right, y down, z forward) of a camera at
    ``c`` looking at the origin, +z world up."""
    import numpy as np

    z = -c / np.linalg.norm(c)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], -1)


def view_dirs(d_cam, c2w):
    """World ray directions ``d_cam @ c2w[:3, :3].T`` as three
    multiply-adds a ray.  Not a BLAS product: the scan writer renders
    views in threads, and concurrent float32 matrix products from
    several threads gave different bits from run to run (a band of rays
    in one view of a 49-view scan now and then), so the written scan,
    and all that phase 15 trains on it, differed between runs."""
    import numpy as np

    d = d_cam.reshape(-1, 3)
    r = np.asarray(c2w, np.float32)[:3, :3]
    return d[:, :1] * r[:, 0] + d[:, 1:2] * r[:, 1] + d[:, 2:3] * r[:, 2]


def write_dtu_scan(scan_dir, n_views, hw=DTU_HW, scale=100.0,
                   mask_channels=1):
    """Write a DTU-format scan: ``image/%06d.png`` (RGB) and
    ``mask/%06d.png`` (grayscale, or RGB with ``mask_channels`` 3) of
    ``data/synthetic.py:shade_sphere`` (the glossy sphere of radius 0.5 in
    the normalised frame, white background) seen by ``n_views`` OpenCV
    cameras, and ``cameras_sphere.npz`` with ``world_mat_i = K [R | t]``
    in the scan's world frame (mm) and ``scale_mat_i``, the one map from
    the normalised frame to it (``scale`` times, then ``DTU_CENTRE``).
    ``DTU_K`` scales with the width of ``hw``.  Returns the scale
    matrix."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from fgs_nerf_tpu_torch.data.rays import get_rays_of_a_view
    from fgs_nerf_tpu_torch.data.synthetic import shade_sphere
    from fgs_nerf_tpu_torch.eval.image_io import write_png

    h, w = hw
    kk = np.array(DTU_K, np.float64)
    kk[:2] *= w / 1600.0
    sm = np.eye(4)
    sm[:3, :3] *= scale
    sm[:3, 3] = DTU_CENTRE
    os.makedirs(os.path.join(scan_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(scan_dir, "mask"), exist_ok=True)
    # camera-frame ray directions of the loader's convention (inverse_y)
    _, d_cam, _ = get_rays_of_a_view(h, w, kk.astype(np.float32),
                                     np.eye(4, dtype=np.float32)[:3],
                                     ndc=False, inverse_y=True, flip_x=False,
                                     flip_y=False)
    cams, k4 = {}, np.eye(4)
    k4[:3, :3] = kk
    centres = _dtu_camera_centres(n_views)
    for i, c in enumerate(centres):
        r = _look_at(c).T                     # world -> camera rotation
        w2c = np.eye(4)
        w2c[:3, :3] = r
        w2c[:3, 3] = -r @ (scale * c + np.asarray(DTU_CENTRE))
        cams[f"world_mat_{i}"] = (k4 @ w2c).astype(np.float32)
        cams[f"scale_mat_{i}"] = sm.astype(np.float32)
    np.savez(os.path.join(scan_dir, "cameras_sphere.npz"), **cams)

    def view(i):
        rays_d = view_dirs(d_cam, _look_at(centres[i]))
        rays_o = np.broadcast_to(centres[i].astype(np.float32), rays_d.shape)
        img, alpha = shade_sphere(rays_o, rays_d)
        write_png(os.path.join(scan_dir, "image", f"{i:06d}.png"),
                  np.round(img.reshape(h, w, 3) * 255).astype(np.uint8))
        m = (alpha.reshape(h, w, 1) * 255).astype(np.uint8)
        write_png(os.path.join(scan_dir, "mask", f"{i:06d}.png"),
                  np.repeat(m, mask_channels, -1))

    # numpy and zlib release the GIL on whole arrays: views in threads
    with ThreadPoolExecutor(min(8, n_views)) as pool:
        list(pool.map(view, range(n_views)))
    return sm


def write_dtu_eval_data(dtu_root, scene, scale_mat, n_points=50000, res=10.0):
    """The DTU evaluation files beside a scan, laid out as
    ``tests/test_dtu_chamfer.py`` writes them: ``Points/stl/stl%03d_total
    .ply`` (points of the sphere of radius 0.5 in the scan's world frame),
    ``ObsMask/ObsMask<scene>_10.mat`` (every ``res``-mm cell of the world
    box of the normalised [-1.1, 1.1]^3 observed) and
    ``ObsMask/Plane<scene>.mat`` (a ground plane below it all)."""
    import os

    import numpy as np
    from scipy.io import savemat

    from fgs_nerf_tpu_torch.eval.mesh import write_ply

    os.makedirs(os.path.join(dtu_root, "ObsMask"), exist_ok=True)
    os.makedirs(os.path.join(dtu_root, "Points", "stl"), exist_ok=True)
    sm = np.asarray(scale_mat, np.float64)
    d = np.random.default_rng(1).normal(size=(n_points, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    write_ply(os.path.join(dtu_root, "Points", "stl",
                           f"stl{scene:03}_total.ply"),
              (0.5 * d * sm[0, 0] + sm[:3, 3]).astype(np.float32),
              np.zeros((0, 3), np.int64))
    bb = np.stack([sm[:3, 3] - 1.1 * sm[0, 0], sm[:3, 3] + 1.1 * sm[0, 0]])
    n = int(np.ceil((bb[1, 0] - bb[0, 0]) / res)) + 1
    savemat(os.path.join(dtu_root, "ObsMask", f"ObsMask{scene}_10.mat"),
            {"ObsMask": np.ones((n, n, n), np.uint8), "BB": bb,
             "Res": np.array([[res]])})
    savemat(os.path.join(dtu_root, "ObsMask", f"Plane{scene}.mat"),
            {"P": np.array([[0.0], [0.0], [1.0], [1e4]])})


# kernel call site (a function of ops/sorted_cm.py or of
# ops/cuda/fused_shade_cm.py) -> the launcher name its kernel counts under
_LAUNCHER_OF = {"window_gather_cm": "window_gather_cm",
                "dense_accumulate_cm": "dense_accumulate_cm",
                "fused_shade_cm_fwd": "fused_shade_fwd",
                "fused_shade_cm_bwd": "fused_shade_bwd",
                "tap_window_serve_cm": "tap_window_serve_cm",
                "tap_dense_accumulate_cm": "tap_dense_accumulate_cm"}

# each stage's block of training settings in a config
_TRAIN_BLOCK = {"geometry_searching": "geometry_searching",
                "coarse": "coarse_train", "fine": "fine_train"}

# the kernel call sites each stage's path reaches (sorted engine)
_STAGE_SITES = {
    "geometry_searching": ("window_gather_cm", "dense_accumulate_cm",
                           "fused_shade_cm_fwd", "fused_shade_cm_bwd"),
    "coarse": ("window_gather_cm", "dense_accumulate_cm", "fused_shade_cm_fwd",
               "fused_shade_cm_bwd"),
    "fine": ("window_gather_cm", "dense_accumulate_cm", "tap_window_serve_cm",
             "tap_dense_accumulate_cm"),
}


def _write_dtu(run_dir):
    """Phase 15's data: a 49-view DTU scan at 1,600 x 1,200 with its
    evaluation files beside it -> the CLI's data arguments."""
    t0 = time.perf_counter()
    dtu_root = run_dir / "DTU"
    sm = write_dtu_scan(str(dtu_root / f"scan{DTU_SCENE}"), 49)
    write_dtu_eval_data(str(dtu_root), DTU_SCENE, sm)
    print(json.dumps({"dtu_scan": {
        "views": 49, "hw": list(DTU_HW), "scale_mat": sm.tolist(),
        "write_s": time.perf_counter() - t0}}))
    return ["--dataset_path", str(dtu_root / f"scan{DTU_SCENE}"),
            "--scene", str(DTU_SCENE)]


def _pipeline_phase(torch, np, card, repo, kernels, config_text,
                    label="pipeline", prepare=None, eval_lpips=True,
                    validate=True, trace_stage=None):
    """Phase 14 (and 15, ``label`` "dtu", and 22, "capture"): the
    three-stage pipeline through the CLI, in process, on the data of
    ``config_text`` (or of ``prepare(run_dir)``, which writes it and
    returns the CLI's data arguments); ``validate`` False skips the test
    renders at the end of each stage (``--i_validate 0``), not the final
    evaluation.  Each stage's kernel calls are recorded at the first step
    of its last rung and held against their twins after the stage.  With
    ``trace_stage``, the second and third steps of that stage's last rung
    run under ``utils/profiling.py:trace_steps`` (a build that ends after
    one traced step drops its trace; the traced seconds and the trace's
    writing come off the stage's wall time).  Returns (the per-stage
    report, the checked kernel calls by site)."""
    import shutil

    from fgs_nerf_tpu_torch import run as R
    from fgs_nerf_tpu_torch.config.base import load_config
    from fgs_nerf_tpu_torch.eval import dtu_chamfer as DC
    from fgs_nerf_tpu_torch.eval import evaluator as E
    from fgs_nerf_tpu_torch.eval import lpips_native as LP
    from fgs_nerf_tpu_torch.eval import metrics as MT
    from fgs_nerf_tpu_torch.eval import render as RD
    from fgs_nerf_tpu_torch.ops import sorted_cm as ST
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS
    from fgs_nerf_tpu_torch.train import checkpoint as CK
    from fgs_nerf_tpu_torch.train import trainer as TR
    from fgs_nerf_tpu_torch.utils import profiling as PF

    run_dir = repo / "results" / ("chip_smoke" if label == "pipeline"
                                  else f"chip_smoke_{label}")
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    cfg_path = run_dir / "pipeline_config.py"
    cfg_path.write_text(config_text)
    cfg = load_config(str(cfg_path))
    data_argv = prepare(run_dir) if prepare else []

    def counts():
        return {fn: n for k in kernels for fn, n in k.launches.items() if n}

    stages, step_log, ckpt_s, evals = {}, [], [], {}
    real_stage, real_step = TR.train_stage, TR.make_train_step
    real_save = CK.save_checkpoint
    real_rv, real_mesh = E.render_viewpoints, E.extract_mesh_from_params
    # the kernel calls of the first step of each built step function of
    # the stage's last rung; a stage keeps those of its last build, whose
    # first step the last rung's timing leaves out.  The copies go to the
    # host, out of the stage's peak device memory, and their seconds come
    # off the stage's wall time.
    rec = {"on": False, "calls": [], "s": 0.0}
    checked = {}
    # the traced steps: the stage running, the open trace, the result
    tracing = {"stage": None, "cm": None, "trace": None}

    def recorder(name, fn):
        def run(*args):
            if rec["on"]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dev = next(a.device for a in args
                           if isinstance(a, torch.Tensor))
                rec["calls"].append((name, dev, _clone(args, torch, "cpu")))
                rec["s"] += time.perf_counter() - t0
            return fn(*args)
        return run

    sites = [(mod, name, recorder(name, getattr(mod, name)))
             for mod, names in ((ST, ("window_gather_cm", "dense_accumulate_cm",
                                      "tap_window_serve_cm",
                                      "tap_dense_accumulate_cm")),
                                (FS, ("fused_shade_cm_fwd",
                                      "fused_shade_cm_bwd")))
             for name in names]

    def check_stage(stage):
        calls, rec["calls"] = rec["calls"], []
        _check(sorted({c[0] for c in calls}) == sorted(_STAGE_SITES[stage]),
               f"{stage}: recorded calls {[c[0] for c in calls]}")
        seen = {}
        # the serves also get their library time at the last rung's grid
        # (B5's x taps serve the transposed grid)
        cfg_last = stages[stage]["result"].cfg_model
        while calls:
            name, dev, args = calls.pop(0)
            seen[name] = seen.get(name, 0) + 1
            t0 = time.perf_counter()
            args = _clone(args, torch, dev)
            path = f"{label} {stage} #{seen[name]}"
            if name == "tap_window_serve_cm":
                path += (" z/y taps" if args[2].shape[0]
                         == 4 * len(cfg_last.all_displace) else " x taps")
            r = _check_call(torch, name, args, path,
                            grid3=cfg_last.world_size)
            del args
            torch.cuda.empty_cache()
            checked.setdefault(name, []).append(r)
            print(json.dumps({"kernel": name, **r, "card": card,
                              "check_s": time.perf_counter() - t0}))

    def timed_stage(cfg_, stage, *args, **kw):
        for k in kernels:
            for fn in k.launches:
                k.launches[fn] = 0
        step_log.clear()
        ckpt_s.clear()
        rec["s"] = 0.0
        tracing["stage"] = stage
        trn = cfg_[_TRAIN_BLOCK[stage]]
        tracing["grids"] = set()
        tracing["rungs"] = 1 + sum(1 for s in trn["pg_scale"]
                                   if s < trn["N_iters"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = real_stage(cfg_, stage, *args, **kw)
        torch.cuda.synchronize()
        if tracing["cm"] is not None:
            close_trace(False)
        stages[stage] = dict(
            result=res, wall_s=time.perf_counter() - t0 - rec["s"],
            record_s=rec["s"], launches=counts(),
            steps=list(step_log), ckpt_s=list(ckpt_s),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        t0 = time.perf_counter()
        check_stage(stage)
        stages[stage]["check_s"] = time.perf_counter() - t0
        return res

    def close_trace(keep):
        tracing["cm"].__exit__(None, None, None)
        tracing["cm"] = None
        if not keep:
            tracing["trace"] = None
        rec["s"] += time.perf_counter() - tracing["t0"]

    def timed_make_step(cfg_m, *args, **kw):
        if tracing["cm"] is not None:
            close_trace(False)  # the last build ran one step traced: again
        step = real_step(cfg_m, *args, **kw)
        n_run = [0]
        # only the builds of the stage's last rung are recorded and traced
        tracing["grids"].add(tuple(cfg_m.world_size))
        last_rung = len(tracing["grids"]) == tracing["rungs"]
        traced = (last_rung and tracing["stage"] == trace_stage
                  and tracing["trace"] is None)

        def run(*a):
            rec["on"] = last_rung and n_run[0] == 0
            if rec["on"]:
                rec["calls"].clear()
            n_run[0] += 1
            t0 = time.perf_counter()
            if traced and n_run[0] == 2:
                tracing["t0"] = t0
                tracing["cm"] = PF.trace_steps(str(run_dir / "trace"))
                tracing["trace"] = tracing["cm"].__enter__()
            in_trace = tracing["cm"] is not None
            out = step(*a)
            torch.cuda.synchronize()
            # recorded and traced steps stay out of the last rung's ms
            step_log.append((tuple(cfg_m.world_size),
                             time.perf_counter() - t0, rec["on"] or in_trace))
            if traced and n_run[0] == 3:
                close_trace(True)
            rec["on"] = False
            return out
        return run

    def timed_save(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(*a, **kw)
        ckpt_s.append(time.perf_counter() - t0)

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            evals[key] = (time.perf_counter() - t0, out)
            return out
        return run

    # where the final evaluation's seconds go: host rays, the whole view
    # render (rays included), SSIM, PSNR, the image dumps
    parts = {}

    def part(mod, name):
        fn = getattr(mod, name)

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
            return out
        return mod, name, run

    def eval_render(*a, **kw):
        parts.clear()
        return timed("render", real_rv)(*a, **kw)

    argv = ["--mode", "train", "--config", str(cfg_path), "--expname", "run",
            "--output_dir", str(run_dir), "--device", "cuda", "--i_print", "2",
            "--eval_lpips", str(int(eval_lpips)), *data_argv,
            *([] if validate else ["--i_validate", "0"])]
    t0 = time.perf_counter()
    with _patched([(TR, "train_stage", timed_stage),
                   (TR, "make_train_step", timed_make_step),
                   (CK, "save_checkpoint", timed_save),
                   (E, "render_viewpoints", eval_render),
                   part(RD, "get_rays_of_a_view"), part(RD, "render_image"),
                   part(MT, "rgb_ssim"), part(MT, "psnr_splits"),
                   part(RD, "_save_view"),
                   (E, "extract_mesh_from_params", timed("mesh", real_mesh)),
                   (DC, "dtu_chamfer", timed("chamfer", DC.dtu_chamfer)),
                   *sites]):
        R.main(argv)
    wall = time.perf_counter() - t0
    out_dir = run_dir / "run"

    report = {}
    for stage, blk, trn in (
            ("geometry_searching", "geometry_searching_model",
             "geometry_searching"),
            ("coarse", "coarse_model", "coarse_train"),
            ("fine", "fine_model", "fine_train")):
        st = stages[stage]
        res = st["result"]
        last_ws = st["steps"][-1][0]
        # a build's first step also allocates (and was recorded), and the
        # traced steps run under the profiler: left out
        last = ([dt for ws, dt, first in st["steps"]
                 if ws == last_ws and not first]
                or [dt for ws, dt, _ in st["steps"] if ws == last_ws])
        ms = 1e3 * float(np.mean(last))
        ck = CK.load_checkpoint(str(out_dir / f"{stage}_last.npz"))
        ws_ck = tuple(ck.meta["model_kwargs"]["world_size"])
        nv = int(cfg[blk]["num_voxels"])
        line = {
            "stage": stage, "wall_s": st["wall_s"],
            "record_s_left_out": st["record_s"],
            "check_s_left_out": st["check_s"], "steps": len(st["steps"]),
            "ms_per_step_last_rung": ms,
            "rays_per_s_last_rung": int(cfg[trn]["N_rand"]) / (ms / 1e3),
            "steps_timed_at_last_rung": len(last),
            "world_size": list(res.cfg_model.world_size),
            "kept_ratio": res.kept_ratio, "peak_mem_gb": st["peak_mem_gb"],
            "launches": st["launches"], "ckpt_write_s": st["ckpt_s"],
            "loss": res.last_metrics.get("loss"),
            "psnr_last": res.psnr_history[-1], "card": card}
        report[stage] = line
        print(json.dumps({f"{label}_stage": line}))
        _check(bool(np.isfinite(res.psnr_history).all())
               and bool(np.isfinite(res.last_metrics["loss"])),
               f"{stage}: non-finite loss or PSNR")
        _check(ws_ck == tuple(ck.params["sdf"].shape[:3]) == last_ws,
               f"{stage}: checkpoint grid {ck.params['sdf'].shape} vs {ws_ck}")
        _check(abs(ck.meta["model_kwargs"]["num_voxels"] / nv - 1) < 0.01
               and abs(np.prod(ws_ck) / nv - 1) < 0.1,
               f"{stage}: grid {ws_ck} does not hold {nv} voxels")
        for site in _STAGE_SITES[stage]:
            fn = _LAUNCHER_OF[site]
            _check(st["launches"].get(fn, 0) > 0,
                   f"{stage}: {fn} was not launched ({st['launches']})")
        _check(st["launches"].get("masked_adam_step", 0) > 0,
               f"{stage}: the masked Adam was not launched "
               f"({st['launches']})")
        _check(not any(fn.startswith("fused_mlp") for fn in st["launches"]),
               f"{stage}: B8/B9 launched on a training path")

    if trace_stage:
        tr = tracing["trace"]
        _check(tr is not None, f"{trace_stage}: no steps were traced")
        groups = _by_bucket({n: t for n, (t, _) in _per_kernel(tr, 2).items()})
        line = {"stage": trace_stage, "steps": 2,
                "path": str(Path(tr.path).relative_to(repo)),
                "kernel_events": tr.kernel_events(),
                "device_ms_per_step_by_group": groups, "card": card}
        print(json.dumps({f"{label}_trace": line}))
        want = {b for b, _, site in _BUCKETS
                if site in _STAGE_SITES[trace_stage]}
        _check(line["kernel_events"] > 0 and want <= set(groups),
               f"the trace misses {sorted(want - set(groups))}: {line}")

    t_render, stats = evals["render"]
    t_mesh, (verts, tris) = evals["mesh"]
    n_views = len(stats["rgbs"])
    line = {"wall_s_total": wall, "views": n_views,
            "hw": list(stats["rgbs"][0].shape[:2]),
            "s_per_view": t_render / n_views,
            "s_per_view_split": {k: v / n_views for k, v in parts.items()},
            "psnr": stats["psnr"],
            "psnr_mean": float(np.mean(stats["psnr"])), "ssim": stats["ssim"],
            "mesh_resolution": 512, "mesh_s": t_mesh,
            "vertices": len(verts), "triangles": len(tris), "card": card}
    if eval_lpips:
        line.update(lpips_alex=stats["lpips_alex"],
                    lpips_weights=LP.weights_path() or "seed-0 fallback")
    if "chamfer" in evals:
        t_ch, (d2s, s2d, mean) = evals["chamfer"]
        line.update(chamfer_d2s=d2s, chamfer_s2d=s2d, chamfer_mean=mean,
                    chamfer_s=t_ch)
        written = (out_dir / "meshes" / "resulteval.txt").read_text().split()
        _check(all(np.isfinite([d2s, s2d, mean]))
               and [float(x) for x in written] == [d2s, s2d, mean]
               and stats.get("chamfer") == mean,
               f"DTU chamfer {d2s} / {s2d} / {mean}, file {written}, "
               f"stats {stats.get('chamfer')}")
    print(json.dumps({f"{label}_eval": line}))
    _check(bool(np.isfinite(stats["psnr"]).all()), "eval PSNR not finite")
    if eval_lpips and (LP.weights_path() or LP.fallback_enabled()):
        _check(len(stats["lpips_alex"]) == n_views
               and bool(np.isfinite(stats["lpips_alex"]).all()),
               f"eval LPIPS(alex): {stats['lpips_alex']}")
    for rgb in stats["rgbs"]:
        _check(bool(np.all(np.isfinite(rgb))) and rgb.min() >= 0.0
               and rgb.max() <= 1.0, "eval pixels not finite or outside [0, 1]")
    _check(len(verts) > 0 and len(tris) > 0, "empty mesh")
    _check((out_dir / "meshes" / "eval.ply").is_file(), "no mesh file")
    _check(len(list((out_dir / "render_test_eval").glob("*render_*.png")))
           == n_views, "test renders were not written")
    shutil.rmtree(run_dir, ignore_errors=True)
    return report, checked


def _dtu_coarse_row(calls):
    """The DTU coarse stage's B3 / B4 call (cin8 144) for its kernels-line
    row: time, bound, chain time and shared memory."""
    c = next(c for c in calls if c["path"] == "dtu coarse #1")
    _check(c["cin8"] == 144, f"DTU coarse head at cin8 {c['cin8']}")
    keys = ("m", "hidden", "cin8", "ms", "plain_ms", "bound_ms", "bound_by",
            "matmul_chain_ms", "max_abs_err", "dynamic_smem_bytes")
    return {k: c[k] for k in keys if k in c}


# ---- phase 16: one small scan of each remaining capture format ----------


def write_random_png(path, h=8, w=8, channels=3, seed=0):
    """A PNG of random uint8 pixels from ``seed`` (grayscale for 1)."""
    import numpy as np

    from fgs_nerf_tpu_torch.eval.image_io import write_png

    img = np.random.default_rng(seed).integers(0, 256, size=(h, w, channels),
                                               dtype=np.uint8)
    write_png(path, img[..., 0] if channels == 1 else img)


def llff_poses_bounds(n, hw, seed=1, inward=False):
    """LLFF ``poses_bounds.npy`` rows: a 3 x 5 [down right back] camera
    with its (h, w, focal) column, then near / far; forward-facing
    cameras, or an inward ring (for ``spherify``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 17))
    for i in range(n):
        if inward:
            th = 2 * np.pi * i / n
            c = np.array([np.cos(th), np.sin(th), 0.3 + 0.1 * rng.normal()])
            z = c / np.linalg.norm(c)
        else:
            c = np.array([0.2 * np.cos(i), 0.2 * np.sin(i), 0.0])
            c = c + 0.02 * rng.normal(size=3)
            z = np.array([0.0, 0.0, 1.0]) + 0.05 * rng.normal(size=3)
            z = z / np.linalg.norm(z)
        right = np.cross([0.0, 1.0, 0.0], z)
        right /= np.linalg.norm(right)
        down = np.cross(z, right)
        hwf = [hw[0], hw[1], 1.2 * hw[1]]
        rows[i, :15] = np.stack([down, right, z, c, hwf], 1).reshape(-1)
        rows[i, 15:] = [1.0 + 0.1 * rng.uniform(), 6.0 + rng.uniform()]
    return rows


def write_llff_scan(root, n=10, hw=(24, 32), ext="png", inward=False,
                    channels=4):
    """An LLFF scan: ``images/%03d.png`` (RGBA) and ``poses_bounds.npy``
    (``.{ext}`` names hold the same PNG bytes).  Returns its data block."""
    import os

    import numpy as np

    os.makedirs(os.path.join(root, "images"))
    for i in range(n):
        write_random_png(os.path.join(root, "images", f"{i:03d}.{ext}"),
                         *hw, channels, seed=i)
    np.save(os.path.join(root, "poses_bounds.npy"),
            llff_poses_bounds(n, hw, inward=inward))
    return dict(dataset_type="llff", datadir=root)


def write_nsvf_scan(root, dtype="nsvf", with_traj=False, n=4, channels=3):
    """An NSVF-layout scan (``pose/*.txt``, ``rgb/*.png`` whose first
    digit is the split, ``intrinsics.txt``), laid out as
    ``tests/test_loaders.py:54-68``; also Tanks & Temples and BlendedMVS
    (``dtype``).  Returns its data block."""
    import os

    import numpy as np

    os.makedirs(os.path.join(root, "pose"))
    os.makedirs(os.path.join(root, "rgb"))
    for i in range(n):
        split = 0 if i < n - 1 else 1
        pose = np.eye(4)
        pose[:3, 3] = [i * 0.5, 0.0, 3.0]
        np.savetxt(os.path.join(root, "pose", f"{split}_{i:03d}.txt"), pose)
        write_random_png(os.path.join(root, "rgb", f"{split}_{i:03d}.png"),
                         channels=channels, seed=i)
    np.savetxt(os.path.join(root, "intrinsics.txt"),
               np.array([[50.0, 0, 4], [0, 50.0, 4], [0, 0, 1]]))
    if with_traj:
        np.savetxt(os.path.join(root, "test_traj.txt"),
                   np.stack([np.eye(4)] * 2).reshape(-1, 4))
    return dict(dataset_type=dtype, datadir=root)


def write_nerfpp_scan(root):
    """A NeRF++ capture (``tests/test_loaders.py:158-177``) with a
    three-pose camera path at another focal.  Returns its data block."""
    import os

    import numpy as np

    k = np.eye(4)
    k[0, 0] = k[1, 1] = 50.0
    for split, n in (("train", 4), ("test", 2)):
        for sub in ("intrinsics", "pose", "rgb"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(n):
            np.savetxt(os.path.join(root, split, "intrinsics", f"{i:03d}.txt"),
                       k.reshape(-1)[None])
            c2w = np.eye(4)
            c2w[:3, 3] = [np.cos(i + (split == "test")), np.sin(i), 1.0]
            np.savetxt(os.path.join(root, split, "pose", f"{i:03d}.txt"),
                       c2w.reshape(-1)[None])
            write_random_png(os.path.join(root, split, "rgb", f"{i:03d}.png"),
                             seed=i)
    for sub in ("intrinsics", "pose"):
        os.makedirs(os.path.join(root, "camera_path", sub))
    k[0, 0] = k[1, 1] = 40.0
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.5 * i, 0.2, 1.5]
        np.savetxt(os.path.join(root, "camera_path", "pose", f"{i:03d}.txt"),
                   c2w.reshape(-1)[None])
        np.savetxt(os.path.join(root, "camera_path", "intrinsics",
                                f"{i:03d}.txt"), k.reshape(-1)[None])
    return dict(dataset_type="nerfpp", datadir=root)


def write_co3d_scan(root):
    """A CO3D sequence (``tests/test_loaders.py:180-218``): gzip'd
    annotations, a split file, five views of which one has another shape
    (the object-array path) and one an empty mask (dropped); grayscale
    masks.  Returns its data block."""
    import gzip
    import os

    import numpy as np

    from fgs_nerf_tpu_torch.eval.image_io import write_png

    seq = "seq1"
    annot, split = [], {"known_frames": [], "unseen_frames": []}
    for i in range(5):
        im_path, mask_path = f"img_{i}.png", f"mask_{i}.png"
        h = 8 if i < 3 else 10
        write_random_png(os.path.join(root, im_path), h=h, seed=i)
        if i == 4:
            write_png(os.path.join(root, mask_path), np.zeros((h, 8), np.uint8))
        else:
            write_random_png(os.path.join(root, mask_path), h=h, channels=1,
                             seed=10 + i)
        annot.append({
            "sequence_name": seq,
            "image": {"path": im_path, "size": [h, 8]},
            "mask": {"path": mask_path, "mass": 10},
            "viewpoint": {
                "R": np.eye(3).tolist(), "T": [0.1 * i, 0.0, 3.0],
                "principal_point": [0.1, -0.05], "focal_length": [2.0, 2.1],
            },
        })
        split["known_frames" if i < 3 else "unseen_frames"].append(
            [seq, i, im_path])
    annot_path = os.path.join(root, "annot.jgz")
    with gzip.open(annot_path, "wt", encoding="utf8") as f:
        json.dump(annot, f)
    split_path = os.path.join(root, "split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    return dict(dataset_type="co3d", datadir=root, annot_path=annot_path,
                split_path=split_path, sequence_name=seq)


def write_ilsh_scan(root, n=6, hw=(24, 32), inward=False):
    """An ILSH capture (``tests/test_loaders.py:221-240``): RGB
    ``images/``, grayscale ``mask/`` and ``poses_bounds.npy``.  Returns
    its data block."""
    import os

    import numpy as np

    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "mask"))
    for i in range(n):
        write_random_png(os.path.join(root, "images", f"{i:03d}.png"), *hw,
                         seed=i)
        write_random_png(os.path.join(root, "mask", f"{i:03d}.png"), *hw, 1,
                         seed=20 + i)
    np.save(os.path.join(root, "poses_bounds.npy"),
            llff_poses_bounds(n, hw, seed=3, inward=inward))
    return dict(dataset_type="ILSH", datadir=root)


def write_deepvoxels_scan(root, scene="cube"):
    """A DeepVoxels layout: ``{train,validation,test}/<scene>/{pose,rgb}``
    (4 / 2 / 3 views) and the train split's ``intrinsics.txt``.  Returns
    its data block (``datadir`` is ``<root>/<scene>``)."""
    import os

    import numpy as np

    for split, n in (("train", 4), ("validation", 2), ("test", 3)):
        for sub in ("pose", "rgb"):
            os.makedirs(os.path.join(root, split, scene, sub))
        for i in range(n):
            th = 2 * np.pi * i / n + len(split)
            w2c = np.eye(4)
            w2c[:3, 3] = [np.cos(th), np.sin(th), 1.2]
            np.savetxt(os.path.join(root, split, scene, "pose", f"{i:06d}.txt"),
                       w2c.reshape(1, 16))
            write_random_png(
                os.path.join(root, split, scene, "rgb", f"{i:06d}.png"),
                seed=100 * len(split) + i)
    with open(os.path.join(root, "train", scene, "intrinsics.txt"), "w") as f:
        f.write("420.0 256.0 256.0 0.\n0. 0. 0.\n0.\n1.\n512 512\n")
    return dict(dataset_type="deepvoxels", datadir=os.path.join(root, scene))


def data_block(**kw):
    """A config's ``data`` block as the loaders read it."""
    d = dict(datadir="", white_bkgd=True, half_res=False, testskip=1,
             inverse_y=False, flip_x=False, flip_y=False, ndc=False, factor=1,
             llffhold=8, spherify=False)
    d.update(kw)
    return d


# (scan, extra data options, expected: views, train, test, image hw)
LLFF_HW = (378, 504)  # LLFF's factor-8 images
_LOADER_CASES = (
    ("llff", lambda r: write_llff_scan(r, 20, LLFF_HW), {},
     (20, 17, 3, LLFF_HW)),
    ("llff", lambda r: write_llff_scan(r, 20, LLFF_HW), dict(factor=2),
     (20, 17, 3, (189, 252))),
    ("llff", lambda r: write_llff_scan(r, 12, (24, 32), inward=True),
     dict(spherify=True, ndc=False, llffhold=0), (12, 11, 1, (24, 32))),
    ("nsvf", lambda r: write_nsvf_scan(r), {}, (4, 3, 0, (8, 8))),
    # Tanks & Temples trains on the 50 views nearest view 0: all four
    ("tankstemple", lambda r: write_nsvf_scan(r, "tankstemple", True, 4, 4),
     {}, (4, 4, 1, (8, 8))),
    ("blendedmvs", lambda r: write_nsvf_scan(r, "blendedmvs", True), {},
     (4, 3, 1, (8, 8))),
    ("nerfpp", write_nerfpp_scan, {}, (6, 4, 2, (8, 8))),
    ("co3d", write_co3d_scan, {}, (4, 3, 1, None)),
    ("ILSH", lambda r: write_ilsh_scan(r), dict(factor=3),
     (6, 5, 1, (8, 10))),
    ("deepvoxels", write_deepvoxels_scan, dict(testskip=2),
     (7, 4, 2, (8, 8))),
)


def _loaders_phase(np, card, repo):
    """Phase 16: write one small scan of each remaining format and load it
    through ``data/dataset.py:load_dataset`` on this machine (no image
    package, no OpenCV): shapes, near / far, splits, load seconds."""
    import shutil

    from fgs_nerf_tpu_torch.config.base import Cfg
    from fgs_nerf_tpu_torch.data.dataset import load_dataset

    root = repo / "results" / "chip_smoke_loaders"
    shutil.rmtree(root, ignore_errors=True)
    out = []
    for k, (dtype, write, extra, (n, n_tr, n_te, hw)) in enumerate(
            _LOADER_CASES):
        scan = root / f"{k:02d}_{dtype}"
        scan.mkdir(parents=True)
        block = data_block(**write(str(scan)), **extra)
        t0 = time.perf_counter()
        d = load_dataset(Cfg(dict(data=block)))
        load_s = time.perf_counter() - t0
        imgs = d["images"]
        shapes = {tuple(im.shape) for im in imgs}
        line = dict(dataset_type=dtype, options=extra, views=len(imgs),
                    train=len(d["i_train"]), test=len(d["i_test"]),
                    image_shapes=sorted(shapes), near=float(d["near"]),
                    far=float(d["far"]), irregular=d["irregular_shape"],
                    load_s=load_s)
        out.append(line)
        print(json.dumps({"loader": line}))
        _check((len(imgs), len(d["i_train"]), len(d["i_test"])) == (n, n_tr,
                                                                     n_te),
               f"{dtype}: {line}")
        _check(all(s[-1] == 3 for s in shapes)
               and (hw is None or shapes == {(*hw, 3)}), f"{dtype}: {shapes}")
        _check(np.isfinite([d["near"], d["far"]]).all()
               and d["near"] < d["far"], f"{dtype}: near/far {line}")
        _check(d["poses"].shape == (n, 3, 4) or d["poses"].shape == (n, 4, 4),
               f"{dtype}: poses {d['poses'].shape}")
        _check(len(d["Ks"]) == n and len(d["HW"]) == n
               and d["render_poses"].shape[-2:] in ((3, 4), (4, 4)),
               f"{dtype}: Ks / HW / render poses")
        _check(all(float(np.min(im)) >= 0 and float(np.max(im)) <= 1
                   for im in imgs), f"{dtype}: pixels outside [0, 1]")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("imageio",
                                                               "cv2"))
    _check(not bad, f"the loaders imported {bad}")
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 17: the --dvgo_init pipeline ----------------------------------

_DVGO_CONFIG = """\
from fgs_nerf_tpu_torch.config.base import deep_update
from fgs_nerf_tpu_torch.config.scenes import FULL_SYNTHETIC

# full_synthetic (40 views of 256 x 256) with the built-in dvgo / dvgo_model
# widths (100^3, N_rand 8,192, sample_k 256, per-voxel learning rates) and
# the depth cut: 16 DVGO steps, then 4 coarse steps off its checkpoint.
# alpha_init 0.01 (the JAX package's own DVGO pipeline test) so that 16
# steps leave a non-empty sdf_mask: at the built-in 1e-6 no voxel reaches
# the handoff's alpha 1e-3 in so few steps.
config = deep_update(FULL_SYNTHETIC, dict(
    dvgo=dict(N_iters=16),
    dvgo_model=dict(alpha_init=0.01),
    coarse_train=dict(N_iters=4, tv_updates={}, decay_step_module={}),
))
"""


def _record_dvgo_b7(torch, D, SC, calls):
    """Record the B7 calls of a DVGO step with the grid each is the
    backward of: each of ``D.forward``'s trilinear samples labels its
    backward node before it runs (a pre-hook)."""
    labels = []
    sample = D.trilinear_sample
    site = SC.dense_accumulate
    names = iter(())

    def labelled(grid, pts, box):
        out = sample(grid, pts, box)
        name = next(names)
        out.grad_fn.register_prehook(
            lambda grads, name=name: labels.append(name))
        return out

    def rec(*args):
        calls.append((labels[-1] if labels else "voxel counts",
                      _clone(args, torch)))
        return site(*args)

    def begin():
        nonlocal names
        names = iter(("density", "k0", "gradient field"))
        labels.clear()
    return _patched([(D, "trilinear_sample", labelled),
                     (SC, "dense_accumulate", rec)]), begin


def _dvgo_phase(torch, np, card, repo, kernels):
    """Phase 17: ``python -m fgs_nerf_tpu_torch.run --dvgo_init 1`` in
    process on ``_DVGO_CONFIG``: the DVGO stage, then the coarse stage off
    its checkpoint (the final evaluation is phase 14's and is left out).
    Every B7 call of the first DVGO step is held against its twin, timed
    and bounded; the DVGO step is timed (ms, rays/s, peak memory, idle
    share); a kernel step is compared with a plain-twin step.  Returns
    (the report, B7's checked calls, launches by stage)."""
    import shutil

    from fgs_nerf_tpu_torch import run as R
    from fgs_nerf_tpu_torch.models import density_voxel as D
    from fgs_nerf_tpu_torch.ops import scatter as SC
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
    from fgs_nerf_tpu_torch.train import checkpoint as CK
    from fgs_nerf_tpu_torch.train import density_trainer as DT
    from fgs_nerf_tpu_torch.train import trainer as TR

    run_dir = repo / "results" / "chip_smoke_dvgo"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    cfg_path = run_dir / "dvgo_config.py"
    cfg_path.write_text(_DVGO_CONFIG)

    def zero_counts():
        for k in kernels:
            for fn in k.launches:
                k.launches[fn] = 0

    def counts():
        return {fn: n for k in kernels for fn, n in k.launches.items() if n}

    calls, step_ms, first, stages = [], [], {}, {}
    recording, begin = _record_dvgo_b7(torch, D, SC, calls)
    real_make, real_stage = DT.make_density_train_step, TR.train_stage
    real_dvgo = DT.train_density_stage

    def timed_make(cfg_m, box, opts, **kw):
        step = real_make(cfg_m, box, opts, **kw)

        def run(params, opt_state, buffers, *rest):
            if not first:
                # the first step: its B7 calls recorded, its inputs kept
                first.update(cfg=cfg_m, box=box, kw=kw, step=step,
                             state=(params, opt_state, buffers, *rest))
                begin()
                with recording:
                    out = step(params, opt_state, buffers, *rest)
                torch.cuda.synchronize()
                return out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt_state, buffers, *rest)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    def timed(name, fn):
        def run(*a, **kw):
            zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[name] = dict(
                result=res, wall_s=time.perf_counter() - t0,
                launches=counts(),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            return res
        return run

    def coarse_stage(cfg_, stage, *a, **kw):
        return timed(stage, real_stage)(cfg_, stage, *a, **kw)

    argv = ["--mode", "train", "--config", str(cfg_path), "--expname", "run",
            "--output_dir", str(run_dir), "--device", "cuda", "--i_print", "4",
            "--dvgo_init", "1", "--fine_training", "0", "--i_validate", "0"]
    t0 = time.perf_counter()
    with _patched([(DT, "make_density_train_step", timed_make),
                   (DT, "train_density_stage", timed("dvgo", real_dvgo)),
                   (TR, "train_stage", coarse_stage),
                   (R, "_evaluate", lambda *a, **kw: None)]):
        R.main(argv)
    wall = time.perf_counter() - t0

    # ---- B7's calls of the first DVGO step ---------------------------
    # the stage's loss reads no normals, so the gradient field's sample
    # has no backward: two calls a step (as under jax.grad)
    step_calls = [c for c in calls if c[0] != "voxel counts"]
    cols = sorted((c[0], c[1][1].shape[1]) for c in step_calls)
    _check(cols == [("density", 8), ("k0", 24)],
           f"DVGO step B7 calls {cols}")
    checked = []
    for label, args in step_calls:
        rows, upd, cap = args
        idx = rows.long()
        r = _check_accumulate(
            torch, "B7", B7.dense_accumulate, B7.dense_accumulate_plain,
            args, rows,
            lambda: torch.zeros((cap, upd.shape[1]),
                                device=upd.device).index_add_(0, idx, upd),
            upd.numel(), f"dvgo {label}")
        r.update(c=upd.shape[1], cap=cap, rel_l2=_rel_l2(
            B7.dense_accumulate(*args), B7.dense_accumulate_plain(*args)))
        checked.append(r)
        print(json.dumps({"kernel": "dense_accumulate", **r, "card": card}))
    del calls[:], step_calls, args, rows, upd, idx
    torch.cuda.empty_cache()

    # ---- the DVGO step: time, profile, kernel vs plain ---------------
    cfg_m, box, kw = first["cfg"], first["box"], first["kw"]
    params, opt_state, buffers, *batch = first.pop("state")
    n_rand = batch[0].shape[0]
    timed_steps = step_ms[1:]  # the second step still allocates
    ms = float(np.mean(timed_steps))
    _device_breakdown(torch, lambda: first["step"](params, opt_state, buffers,
                                                   *batch), ms, card,
                      path="dvgo")
    lag = DT.make_density_loss_and_grads(cfg_m, box, **{
        k: v for k, v in kw.items() if k != "mesh"})
    _, lk, _, gk = lag(params, buffers, *batch[:4])
    with _patched([(SC, "dense_accumulate", B7.dense_accumulate_plain)]):
        _, lp, _, gp = lag(params, buffers, *batch[:4])
    vs_plain = {"loss_kernel": float(lk), "loss_plain": float(lp),
                **{f"grad_rel_l2.{k}": _rel_l2(gk[k], gp[k]) for k in gk}}
    print(json.dumps({"dvgo_kernel_vs_plain_step": vs_plain, "card": card}))
    _check(abs(float(lk) - float(lp)) <= 1e-4 * abs(float(lp)), vs_plain)
    _check(all(vs_plain[f"grad_rel_l2.{k}"] < 1e-3 for k in gk), vs_plain)
    del params, opt_state, buffers, batch, gk, gp, first
    torch.cuda.empty_cache()

    dvgo, coarse = stages["dvgo"], stages["coarse"]
    res = dvgo["result"]
    ck = CK.load_checkpoint(str(run_dir / "run" /
                                "geometry_searching_last.npz"))
    report = {
        "world_size": list(res.cfg_model.world_size),
        "s_max": res.cfg_model.s_max, "sample_k": res.cfg_model.sample_k,
        "samples_per_step": n_rand * res.cfg_model.sample_k,
        "dvgo_wall_s": dvgo["wall_s"], "dvgo_step_ms": ms,
        "dvgo_step_ms_all": step_ms, "dvgo_rays_per_s": n_rand / (ms / 1e3),
        "dvgo_peak_mem_gb": dvgo["peak_mem_gb"],
        "dvgo_launches": dvgo["launches"], "dvgo_loss": res.last_metrics,
        "psnr_last": res.psnr_history[-1],
        "sdf_mask_voxels": int((ck.sdf_mask > 0).sum()),
        "coarse_wall_s": coarse["wall_s"],
        "coarse_world_size": list(coarse["result"].cfg_model.world_size),
        "coarse_kept_ratio": coarse["result"].kept_ratio,
        "coarse_launches": coarse["launches"],
        "coarse_psnr_last": coarse["result"].psnr_history[-1],
        "coarse_peak_mem_gb": coarse["peak_mem_gb"],
        "wall_s_total": wall, "card": card}
    print(json.dumps({"dvgo_pipeline": report}))
    _check(np.isfinite(res.psnr_history).all()
           and np.isfinite(coarse["result"].psnr_history).all(),
           "non-finite DVGO or coarse PSNR")
    _check(set(ck.params) == {"density", "k0"}
           and report["sdf_mask_voxels"] > 0,
           f"DVGO checkpoint {sorted(ck.params)}, mask "
           f"{report['sdf_mask_voxels']}")
    _check(set(dvgo["launches"]) == {"dense_accumulate", "masked_adam_step"}
           and dvgo["launches"]["dense_accumulate"] >= 2 * 16
           and dvgo["launches"]["masked_adam_step"] >= 16,
           f"DVGO launches {dvgo['launches']}")
    for fn in ("window_gather_cm", "dense_accumulate_cm", "fused_shade_fwd",
               "fused_shade_bwd"):
        _check(coarse["launches"].get(fn, 0) > 0,
               f"coarse after DVGO: {fn} not launched ({coarse['launches']})")
    shutil.rmtree(run_dir, ignore_errors=True)
    return report, checked, {"dvgo": dvgo["launches"],
                             "dvgo_coarse": coarse["launches"]}


# ---- phase 18: the TensoRF k0 on the sorted coarse step ------------------


def _tensorf_phase(torch, np, card, dev, batch, n_rand, kernels):
    """Phase 18: the ``bench.py`` sorted coarse step with a TensoRF k0
    (``grid_type='tensorf'``, 8 components, densified every step): timed
    with its launches, then a kernel step against a plain-twin step."""
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.ops import scatter as SC
    from fgs_nerf_tpu_torch.ops import sorted_cm as ST
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
    from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56
    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1
    from fgs_nerf_tpu_torch.optim.masked_adam import init_state

    cfg, _, params, lrs, s_val, loss_and_grads, step = _setup(
        torch, M, "coarse", "sorted", dev, n_rand, grid_type="tensorf")
    _check(isinstance(params["k0"], dict) and M.k0_dense(params, cfg).shape
           == (*cfg.world_size, cfg.k0_dim), "TensoRF k0 factors")
    for k in kernels:
        for fn in k.launches:
            k.launches[fn] = 0
    state = (params, init_state(params))
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(N_WARMUP + 4):
        if i == N_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        p, o, metrics = step(*state, {}, *batch, s_val, lrs, 1.0)
        state = (p, o)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 4
    launches = {fn: n for k in kernels for fn, n in k.launches.items() if n}
    losses = [float(x) for x in losses]
    line = {"metric": "train_rays_per_s_tensorf_coarse", "value": n_rand / dt,
            "step_ms": dt * 1e3, "steps": 4, "world_size": cfg.world_size,
            "tensorf_n_comp": cfg.tensorf_n_comp, "losses": losses,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "card": card}
    print(json.dumps(line))
    _check(all(np.isfinite(losses)), losses)
    for fn in ("window_gather_cm", "dense_accumulate_cm", "fused_shade_fwd",
               "fused_shade_bwd"):
        _check(launches.get(fn, 0) == N_WARMUP + 4,
               f"TensoRF coarse: {fn} launches {launches}")
    _check(launches.get("masked_adam_step", 0)
           == _adam_leaves(params, lrs) * (N_WARMUP + 4),
           f"TensoRF coarse: masked Adam launches {launches}")
    report = _step_vs_plain(torch, loss_and_grads, step, state, {}, batch,
                            s_val, lrs,
                            _plain_twins(ST, FS, SC, B1, B2, B56, B7))
    _check(sum(k.startswith("grad_rel_l2.k0.") for k in report) == 7,
           sorted(report))
    print(json.dumps({"tensorf_kernel_vs_plain_step": report, "card": card}))
    del state, params
    torch.cuda.empty_cache()
    return line, launches


# ---------------------------------------------------------------------------
# 19.-21. parallelism: two ranks share the one card (gloo); NCCL at world 1
# ---------------------------------------------------------------------------

N_MESH_STEPS = 4
# the launchers each dp path must reach, on each rank
_DP_PATH_LAUNCHERS = {
    "coarse": ("window_gather_cm", "dense_accumulate_cm", "fused_shade_fwd",
               "fused_shade_bwd", "masked_adam_step"),
    "fine": ("window_gather_cm", "dense_accumulate_cm", "tap_window_serve_cm",
             "tap_dense_accumulate_cm", "masked_adam_step"),
}


def _rank_kernels():
    """The kernels, loaded from the libraries the parent built."""
    from fgs_nerf_tpu_torch.ops.cuda import build
    from fgs_nerf_tpu_torch.ops.cuda import fused_mlp_cm as B89
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS
    from fgs_nerf_tpu_torch.ops.cuda import masked_adam as A1
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
    from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56
    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1

    kernels = (B1.KERNEL, B2.KERNEL, FS.KERNEL, B56.KERNEL, B7.KERNEL,
               B89.KERNEL, A1.KERNEL)
    build.build_all(kernels)
    return kernels


def _zero_counts(kernels):
    for k in kernels:
        for fn in k.launches:
            k.launches[fn] = 0


def _counts(kernels):
    return {fn: n for k in kernels for fn, n in k.launches.items() if n}


def _worst(torch, got, want, rtol, atol, where=None):
    """max(|got - want| - (atol + rtol |want|)) over ``where``: <= 0 when
    every element is within tolerance."""
    d = (got - want).abs() - (atol + rtol * want.abs())
    if where is not None:
        d = d[where]
    return float(d.max()) if d.numel() else float("-inf")


def _timed_steps(torch, step, state, batch, s_val, lrs, kernels, dev):
    """2 warm-up and ``N_MESH_STEPS`` timed steps (host clock, ending in a
    synchronize), launch counts zeroed before and read after, peak
    memory: (state, step ms, counts, peak GB)."""
    params, opt = state
    _zero_counts(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(N_WARMUP + N_MESH_STEPS):
        if i == N_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, {}, *batch, s_val, lrs, 1.0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / N_MESH_STEPS * 1e3
    _check(math.isfinite(float(metrics["loss"])), "non-finite mesh loss")
    return ((params, opt), ms, _counts(kernels),
            torch.cuda.max_memory_allocated(dev) / 1e9)


def _all_reduce_ms(torch, n_floats, group, dev, reps=3):
    """One ``all_reduce`` of ``n_floats`` float32 over ``group``, alone."""
    import torch.distributed as dist

    buf = torch.zeros((n_floats,), dtype=torch.float32, device=dev)
    dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _dp_rank(device, n_rand=8192):
    """Phase 19 on one rank of dp = 2."""
    import numpy as np
    import torch

    from fgs_nerf_tpu_torch.device import resolve_device
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.optim.masked_adam import init_state, tree_leaves
    from fgs_nerf_tpu_torch.parallel.mesh import (
        build_mesh, check_replicas, shard_batch,
    )
    from fgs_nerf_tpu_torch.train.trainer import dp_reduce, step_metrics

    dev = resolve_device(device)
    torch.cuda.set_device(dev)
    kernels = _rank_kernels()
    mesh = build_mesh("dp=2", device=dev)
    batch = _bench_batch(torch, np, dev, n_rand)
    local = list(shard_batch(mesh, *batch))
    out = {"rank": mesh.rank}
    for stage in ("coarse", "fine"):
        _, _, p0, lrs, s_val, lg1, step1 = _setup(torch, M, stage, "sorted",
                                                  dev, n_rand)
        *_, lgm, stepm = _setup(torch, M, stage, "sorted", dev, n_rand,
                                mesh=mesh)
        # the whole batch in this process, then the shard and the dp mean
        _, l1, g1 = lg1(p0, {}, *batch, s_val, 1.0)
        loss1 = float(l1["loss"])
        render, lm, gm = lgm(p0, {}, *local, s_val, 1.0)
        gm, mm = dp_reduce(mesh, gm, step_metrics(render, lm))
        del render, lm, l1
        rel = abs(float(mm["loss"]) - loss1) / abs(loss1)
        g_worst = max(_worst(torch, b, a, 1e-3, 5e-5) for a, b in
                      zip(tree_leaves(g1), tree_leaves(gm)))
        _check(rel <= 1e-5, f"dp {stage}: loss {float(mm['loss'])} vs "
                            f"{loss1}")
        _check(g_worst <= 0, f"dp {stage}: gradients past rtol 1e-3, "
                             f"atol 5e-5 by {g_worst}")
        del gm
        torch.cuda.empty_cache()
        p1, _, _ = step1(p0, init_state(p0), {}, *batch, s_val, lrs, 1.0)
        pm, _, _ = stepm(p0, init_state(p0), {}, *local, s_val, lrs, 1.0)
        adam = max(
            _worst(torch, b, a, 0.0, 1e-4, where=g.abs() > 1e-5)
            for a, b, g in zip(tree_leaves(p1), tree_leaves(pm),
                               tree_leaves(g1)))
        _check(adam <= 0, f"dp {stage}: post-Adam past 1e-4 by {adam}")
        del p1, pm, g1
        torch.cuda.empty_cache()
        (params, _), ms, counts, peak = _timed_steps(
            torch, stepm, (p0, init_state(p0)), local, s_val, lrs, kernels,
            dev)
        for fn in _DP_PATH_LAUNCHERS[stage]:
            _check(counts.get(fn, 0) > 0,
                   f"dp {stage}: {fn} not launched on rank {mesh.rank}")
        check_replicas(mesh, params, f"dp {stage} params")
        n_floats = sum(x.numel() for x in tree_leaves(params)) + 9
        out.update({
            f"{stage}/loss_rel_err": rel, f"{stage}/grad_worst": g_worst,
            f"{stage}/adam_worst": adam, f"{stage}/step_ms": ms,
            f"{stage}/peak_gb": peak,
            f"{stage}/all_reduce_bytes": 4 * n_floats,
            f"{stage}/all_reduce_ms": _all_reduce_ms(torch, n_floats,
                                                     mesh.dp_group, dev),
            **{f"{stage}/launches/{fn}": n for fn, n in counts.items()}})
        del params, p0
        torch.cuda.empty_cache()
    return out


def _sp_rank(device, n_rand=8192):
    """Phase 20 on one rank of sp = 2."""
    import numpy as np
    import torch

    from fgs_nerf_tpu_torch.device import resolve_device
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.optim.masked_adam import init_state
    from fgs_nerf_tpu_torch.parallel import spatial as SPM
    from fgs_nerf_tpu_torch.parallel.mesh import (
        barrier, build_mesh, check_replicas,
    )
    from fgs_nerf_tpu_torch.parallel.spatial import slab_bounds
    from fgs_nerf_tpu_torch.parallel.spatial_train import (
        GRID_PARAMS, gather_spatial, place_spatial,
    )

    dev = resolve_device(device)
    torch.cuda.set_device(dev)
    kernels = _rank_kernels()
    mesh = build_mesh("dp=1,sp=2", device=dev)
    batch = _bench_batch(torch, np, dev, n_rand)
    cfg, _, p0, lrs, s_val, _, step1 = _setup(torch, M, "fine", "lattice",
                                              dev, n_rand)
    *_, stepm = _setup(torch, M, "fine", "lattice", dev, n_rand, mesh=mesh)
    x = cfg.world_size[0]
    x0, x1 = slab_bounds(x, mesh)
    # the single-process step, one rank at a time (one on the card)
    for r in range(mesh.sp):
        if r == mesh.sp_index:
            p1, _, m1 = step1(p0, init_state(p0), {}, *batch, s_val, lrs, 1.0)
            ref = {k: (v[x0:x1].clone() if k in GRID_PARAMS else v)
                   for k, v in p1.items()}
            loss1 = float(m1["loss"])
            del p1, m1
            torch.cuda.empty_cache()
        barrier(mesh)
    ps, os_ = place_spatial(mesh, p0, init_state(p0))
    pm, _, mm = stepm(ps, os_, {}, *batch, s_val, lrs, 1.0)
    rel = abs(float(mm["loss"]) - loss1) / abs(loss1)
    _check(rel <= 1e-5, f"sp: loss {float(mm['loss'])} vs {loss1}")
    grid_worst = max(_worst(torch, pm[k], ref[k], 1e-4, 1e-5)
                     for k in GRID_PARAMS)
    _check(grid_worst <= 0, f"sp: grid parameters past rtol 1e-4, atol 1e-5 "
                            f"by {grid_worst}")
    mlp_worst = max(_worst(torch, pm[h][k], ref[h][k], 1e-3, 2e-3)
                    for h in ("refnet", "rgbnet") for k in ref[h])
    _check(mlp_worst <= 0, f"sp: MLP leaves past rtol 1e-3, atol 2e-3 by "
                           f"{mlp_worst}")
    full = gather_spatial(mesh, pm, x)
    _check(all(torch.equal(full[k][x0:x1], pm[k]) for k in GRID_PARAMS),
           "sp: gathered grid differs from the slab")
    del full, ref
    torch.cuda.empty_cache()
    # the collectives of one step: the sharded gathers' sums, and the
    # rest (halo planes forward and backward, the TV sums)
    rec = {"gather": [], "other": []}
    in_gather = [False]
    real_sum, real_reduce = SPM.sum_over_sp, SPM.all_reduce_sum

    def gather_sum(x, mesh_):
        in_gather[0] = True
        try:
            return real_sum(x, mesh_)
        finally:
            in_gather[0] = False

    def recorded(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(t, group)
        torch.cuda.synchronize()
        rec["gather" if in_gather[0] else "other"].append(
            (t.numel() * t.element_size(), (time.perf_counter() - t0) * 1e3))
        return t

    SPM.sum_over_sp, SPM.all_reduce_sum = gather_sum, recorded
    try:
        stepm(ps, os_, {}, *batch, s_val, lrs, 1.0)
    finally:
        SPM.sum_over_sp, SPM.all_reduce_sum = real_sum, real_reduce
    (params, _), ms, counts, peak = _timed_steps(
        torch, stepm, (ps, os_), batch, s_val, lrs, kernels, dev)
    _check(counts.get("dense_accumulate", 0) > 0,
           f"sp: B7 not launched on rank {mesh.rank}")
    _check(counts.get("masked_adam_step", 0) > 0,
           f"sp: the masked Adam not launched on rank {mesh.rank}")
    check_replicas(mesh, {k: v for k, v in params.items()
                          if k not in GRID_PARAMS}, "sp MLP leaves")
    return {"rank": mesh.rank, "loss_rel_err": rel, "grid_worst": grid_worst,
            "mlp_worst": mlp_worst, "step_ms": ms, "peak_gb": peak,
            "slab_planes": x1 - x0,
            **{f"{kind}_all_reduce_{what}": (
                len(r) if what == "calls" else
                sum(b for b, _ in r) if what == "bytes" else
                sum(t for _, t in r))
               for kind, r in rec.items()
               for what in ("calls", "bytes", "ms")},
            **{f"launches/{fn}": n for fn, n in counts.items()}}


def _mesh_phases(torch, np, card, repo):
    """Phases 19 and 20 (two ranks on ``cuda:0``, gloo): the per-rank
    records, printed, and the launch counts of each path (rank 0's)."""
    from fgs_nerf_tpu_torch.parallel.launch import launch_local

    target = f"{Path(__file__).resolve()}:"
    launches = {}
    for phase, fn in ((19, "_dp_rank"), (20, "_sp_rank")):
        t0 = time.perf_counter()
        ranks = launch_local(2, target + fn, device="cuda:0", timeout=400)
        recs = [{k: (v.item() if v.ndim == 0 else v.tolist())
                 for k, v in r.items()} for r in ranks]
        print(json.dumps({f"phase_{phase}": recs, "wall_s":
                          time.perf_counter() - t0, "card": card,
                          "note": "two ranks share one card"}))
        rank0 = next(r for r in recs if r["rank"] == 0)
        for k, v in rank0.items():
            if "launches/" in k:
                stage, _, launcher = k.rpartition("launches/")
                path = (f"dp2_{stage.rstrip('/')}" if phase == 19
                        else "sp2_lattice_fine")
                launches.setdefault(path, {})[launcher] = v
    return launches


@contextlib.contextmanager
def _half_batch_steps(torch, dev):
    """Single-process stages whose every step takes the mean of two
    half-batch passes, as dp = 2 forms it: rank 0's rows and rank 1's
    each through the loss (the orientation term scaled by dp), gradients
    and metrics summed in float32 and halved.  The dp run's arithmetic
    without its processes and collectives: what a dp run should track
    once rounding alone has parted it from the whole-batch stage."""
    from fgs_nerf_tpu_torch.optim.masked_adam import tree_map
    from fgs_nerf_tpu_torch.parallel.mesh import Mesh
    from fgs_nerf_tpu_torch.train import trainer as T

    real_make, real_metrics = T.make_loss_and_grads, T.step_metrics
    halves = Mesh(dp=2, sp=1, dp_index=0, sp_index=0, dp_group=None,
                  sp_group=None, device=torch.device(dev))

    def make(*args, mesh=None, **kw):
        fn = real_make(*args, mesh=halves, **kw)

        def two_halves(params, buffers, rays_o, rays_d, viewdirs, target,
                       s_val, tv_on):
            n = rays_o.shape[0] // 2
            outs = [fn(params, buffers, rays_o[s], rays_d[s], viewdirs[s],
                       target[s], s_val, tv_on)
                    for s in (slice(0, n), slice(n, None))]
            grads = tree_map(lambda a, b: (a + b) / 2, outs[0][2],
                             outs[1][2])
            return ([o[0] for o in outs], [o[1] for o in outs], grads)
        return two_halves

    def metrics(renders, losses):
        m0, m1 = (real_metrics(r, l) for r, l in zip(renders, losses))
        return {k: (m0[k].float() + m1[k].float()) / 2 for k in m0}

    T.make_loss_and_grads, T.step_metrics = make, metrics
    try:
        yield
    finally:
        T.make_loss_and_grads, T.step_metrics = real_make, real_metrics


def _cli_mesh_phase(torch, np, card, repo, dev):
    """Phase 21: the CLI on two ranks of ``cuda:0`` (dp = 2, gloo),
    geometry stage of phase 14's config, against the same stage in this
    process; then NCCL at world size 1."""
    import re
    import shutil

    from fgs_nerf_tpu_torch.config.base import load_config
    from fgs_nerf_tpu_torch.data.dataset import load_dataset
    from fgs_nerf_tpu_torch.train.checkpoint import load_checkpoint
    from fgs_nerf_tpu_torch.train.pipeline import run_training

    run_dir = repo / "results" / "chip_smoke_dp"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    cfg_path = run_dir / "pipeline_config.py"
    cfg_path.write_text(_PIPELINE_CONFIG)
    t0 = time.perf_counter()
    cfg = load_config(str(cfg_path))
    single = run_training(cfg, load_dataset(cfg), str(run_dir / "single"),
                          stages=("geometry_searching",), i_print=1,
                          device=dev)["geometry_searching"]
    t_single = time.perf_counter() - t0
    with _half_batch_steps(torch, dev):
        halves = run_training(cfg, load_dataset(cfg),
                              str(run_dir / "halves"),
                              stages=("geometry_searching",), i_print=1,
                              device=dev)["geometry_searching"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "fgs_nerf_tpu_torch.run",
         "--config", str(cfg_path), "--expname", "dp2",
         "--output_dir", str(run_dir), "--mesh", "dp=2",
         "--dist_backend", "gloo", "--device", "cuda:0",
         "--coarse_training", "0", "--fine_training", "0",
         "--i_print", "1", "--eval_ssim", "0"],
        cwd=str(repo), capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    _check(proc.returncode == 0,
           f"CLI dp=2 exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    psnr = [float(v) for v in re.findall(
        r"\[geometry_searching\] iter +\d+/\d+ loss \S+ PSNR +(\S+)",
        proc.stderr + proc.stdout)]
    want = np.asarray(single.psnr_history)
    _check(len(psnr) == len(want), f"CLI dp=2: {len(psnr)} PSNR lines, "
                                   f"want {len(want)}")
    # The log prints 4 decimals (hence the 5e-5).  The whole history is
    # held within 5e-3 (`tests/test_parallel.py:204`) of the half-batch
    # stage, which sums as dp does; against the whole-batch stage, the
    # first 8 steps (the JAX test's stage), then printed.
    halves_psnr = np.asarray(halves.psnr_history)
    dev_halves = np.abs(np.asarray(psnr) - halves_psnr)
    dev_psnr = np.abs(np.asarray(psnr) - want)
    psnr_err = float(dev_psnr.max())
    _check(len(halves_psnr) == len(want)
           and float(dev_halves.max()) <= 5e-3 + 5e-5,
           f"CLI dp=2 PSNR history off the half-batch stage's by "
           f"{dev_halves.tolist()}: {psnr} against {halves_psnr.tolist()}")
    _check(float(dev_psnr[:8].max()) <= 5e-3 + 5e-5,
           f"CLI dp=2 PSNR history off by {dev_psnr.tolist()}: {psnr} "
           f"against {want.tolist()}")
    ck = load_checkpoint(str(run_dir / "dp2" / "geometry_searching_last.npz"))
    d = np.abs(ck.params["sdf"] - single.params["sdf"].cpu().numpy())
    _check(ck.global_step == len(want), f"checkpoint step {ck.global_step}")
    rec = {"psnr_max_abs_err": psnr_err,
           "psnr_max_abs_err_8": float(dev_psnr[:8].max()),
           "psnr_max_abs_err_halves": float(dev_halves.max()),
           "halves_vs_single_max_abs": float(np.abs(halves_psnr
                                                    - want).max()),
           "steps": len(want),
           "psnr_cli": psnr, "psnr_single": want.tolist(),
           "psnr_halves": halves_psnr.tolist(),
           "sdf_median_abs_diff": float(np.median(d)),
           "sdf_max_abs_diff": float(d.max()), "single_s": t_single,
           "cli_s": t_cli, "card": card, "note": "two ranks share one card"}
    shutil.rmtree(run_dir, ignore_errors=True)

    # NCCL, world size 1
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", str(Path(__file__).resolve()),
         "--nccl-world-1"], cwd=str(repo), capture_output=True, text=True,
        timeout=300)
    _check(proc.returncode == 0,
           f"NCCL world 1 exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith('{"nccl_world_1"')]
    _check(len(line) == 1, proc.stdout[-2000:])
    nccl = json.loads(line[0])["nccl_world_1"]
    _check(nccl["bit_equal"], f"NCCL dp=1 step differs: {nccl}")
    rec["nccl_world_1"] = dict(nccl, wall_s=time.perf_counter() - t0)
    print(json.dumps({"phase_21": rec}))
    return rec


# ---- phase 22: a capture -> run_colmap -> LLFF three-stage training ------

_CAPTURE_CONFIG = """\
from fgs_nerf_tpu_torch.config.base import deep_update
from fgs_nerf_tpu_torch.config.scenes import SMART_CAR

# smart_car (a user's own capture: the _BASE widths, geometry 1.5M voxels,
# coarse 1.5M, fine 256^3, N_rand 8,192), the dataset type from the CLI,
# with the depth of every schedule cut as phase 14 cuts it, the fine
# stage two steps longer (its last rung keeps three untraced, unrecorded
# steps to time); each stage still climbs all its pg_scale rungs to its
# full grid
config = deep_update(SMART_CAR, dict(
    geometry_searching=dict(N_iters=16, pg_scale=[2, 4, 6, 8, 10, 12, 14],
                            reset_iter=[2, 4, 6, 8, 10, 12, 14],
                            decay_step_module={}),
    coarse_train=dict(N_iters=14, pg_scale=[2, 4, 6, 8, 10, 12],
                      tv_updates={}, decay_step_module={}),
    fine_train=dict(N_iters=8, pg_scale=[3], decay_step_module={}),
))
"""

CAPTURE_VIEWS = 30
CAPTURE_RADIUS = 2.6          # camera distance from the sphere's centre
CAPTURE_FOCAL = 420.0         # pixels at LLFF_HW's 504 wide
CAPTURE_POINTS = 2000         # sparse points on the sphere


def rotmat2qvec(r):
    """COLMAP's ``(w, x, y, z)`` of a rotation matrix with ``w >= 0``: the
    inverse of ``data/colmap.py:qvec2rotmat``.  The largest of 4w^2, 4x^2,
    4y^2, 4z^2 (read off the trace and the diagonal) gives one component,
    sums and differences of the off-diagonal pairs the other three."""
    import numpy as np

    r = np.asarray(r, np.float64)
    t = r[0, 0] + r[1, 1] + r[2, 2]
    k = int(np.argmax([t, r[0, 0], r[1, 1], r[2, 2]]))
    if k == 0:
        w = 0.5 * np.sqrt(1.0 + t)
        q = [w, (r[2, 1] - r[1, 2]) / (4 * w), (r[0, 2] - r[2, 0]) / (4 * w),
             (r[1, 0] - r[0, 1]) / (4 * w)]
    elif k == 1:
        x = 0.5 * np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2])
        q = [(r[2, 1] - r[1, 2]) / (4 * x), x, (r[0, 1] + r[1, 0]) / (4 * x),
             (r[0, 2] + r[2, 0]) / (4 * x)]
    elif k == 2:
        y = 0.5 * np.sqrt(1.0 - r[0, 0] + r[1, 1] - r[2, 2])
        q = [(r[0, 2] - r[2, 0]) / (4 * y), (r[0, 1] + r[1, 0]) / (4 * y), y,
             (r[1, 2] + r[2, 1]) / (4 * y)]
    else:
        z = 0.5 * np.sqrt(1.0 - r[0, 0] - r[1, 1] + r[2, 2])
        q = [(r[1, 0] - r[0, 1]) / (4 * z), (r[0, 2] + r[2, 0]) / (4 * z),
             (r[1, 2] + r[2, 1]) / (4 * z), z]
    q = np.array(q)
    return q if q[0] >= 0 else -q


def write_colmap_model(sparse, cameras, images, points):
    """A COLMAP binary sparse model (``cameras.bin``, ``images.bin``,
    ``points3D.bin``) in the documented format, as
    ``tests/test_colmap.py:write_fixture`` writes it.  ``cameras``:
    ``(id, model name, width, height, params)``; ``images``: ``(id, qvec,
    tvec, camera id, name, xys [n, 2], point3D ids [n])`` (id -1: no
    point); ``points``: ``(id, xyz, rgb, error, track [(image id,
    point2D index)])``."""
    import os
    import struct

    import numpy as np

    from fgs_nerf_tpu_torch.data.colmap import CAMERA_MODELS

    ids = {name: (i, n) for i, (name, n) in CAMERA_MODELS.items()}
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam_id, model, w, h, params in cameras:
            model_id, n_params = ids[model]
            _check(len(params) == n_params, f"{model}: {len(params)} params")
            f.write(struct.pack("<iiQQ", cam_id, model_id, w, h))
            f.write(struct.pack(f"<{n_params}d", *params))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for img_id, qvec, tvec, cam_id, name, xys, pids in images:
            f.write(struct.pack("<i", img_id))
            f.write(struct.pack("<4d", *qvec))
            f.write(struct.pack("<3d", *tvec))
            f.write(struct.pack("<i", cam_id))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(pids)))
            for (x, y), pid in zip(np.asarray(xys, np.float64), pids):
                # the point3D id as a float64: the layout the readers
                # (``data/colmap.py:read_images_bin``) and the fixture
                # read; COLMAP itself writes a uint64 there (ROADMAP §C)
                f.write(struct.pack("<3d", x, y, float(pid)))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid, xyz, rgb, err, track in points:
            f.write(struct.pack("<Q", pid))
            f.write(struct.pack("<3d", *xyz))
            f.write(struct.pack("<3B", *rgb))
            f.write(struct.pack("<d", err))
            f.write(struct.pack("<Q", len(track)))
            for img_id, idx in track:
                f.write(struct.pack("<ii", img_id, idx))


def capture_centres(n, radius=CAPTURE_RADIUS):
    """Camera centres of an inward capture around the origin (+z up): an
    arc of 240 degrees of azimuth at elevations 15 and 35 degrees in
    turn, as a hand-held walk around an object gives.  Not a closed
    ring: there the LLFF loader's mean back and up vectors are both
    vertical, and its average pose's x axis (their cross product) is
    float32 rounding noise."""
    import numpy as np

    az = np.radians(np.linspace(-120.0, 120.0, n))
    el = np.radians(np.where(np.arange(n) % 2 == 0, 15.0, 35.0))
    return radius * np.stack([np.cos(el) * np.sin(az),
                              -np.cos(el) * np.cos(az), np.sin(el)], -1)


def write_capture(root, n_views=CAPTURE_VIEWS, hw=LLFF_HW,
                  n_points=CAPTURE_POINTS, seed=0):
    """A user's capture as ``run_colmap`` takes it once COLMAP has run:
    ``images/%03d.png`` of ``data/synthetic.py:shade_sphere`` (the glossy
    sphere of radius 0.5, white background) seen by ``n_views`` OpenCV
    cameras on :func:`capture_centres`, and ``sparse/0``, a binary model
    with one ``PINHOLE`` camera, each view's ``R_w2c`` / ``t_w2c`` and
    ``n_points`` points on the sphere (from ``seed``), each listed by the
    views that see it.  Views are written one after another, their rays
    three multiply-adds each (``view_dirs``), so two writes give the
    same bytes.  Returns the centres and OpenCV ``c2w`` rotations."""
    import os

    import numpy as np

    from fgs_nerf_tpu_torch.data.rays import get_rays_of_a_view
    from fgs_nerf_tpu_torch.data.synthetic import shade_sphere
    from fgs_nerf_tpu_torch.eval.image_io import write_png

    h, w = hw
    f = CAPTURE_FOCAL * w / LLFF_HW[1]
    kk = np.array([[f, 0.0, 0.5 * w], [0.0, f, 0.5 * h], [0.0, 0.0, 1.0]])
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    _, d_cam, _ = get_rays_of_a_view(h, w, kk.astype(np.float32),
                                     np.eye(4, dtype=np.float32)[:3],
                                     ndc=False, inverse_y=True, flip_x=False,
                                     flip_y=False)
    pts = np.random.default_rng(seed).normal(size=(n_points, 3))
    pts = 0.5 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    centres = capture_centres(n_views)
    rots, images, tracks = [], [], [[] for _ in range(n_points)]
    for i, c in enumerate(centres):
        c2w = _look_at(c)
        rots.append(c2w)
        rays_d = view_dirs(d_cam, c2w)
        rays_o = np.broadcast_to(c.astype(np.float32), rays_d.shape)
        img, _ = shade_sphere(rays_o, rays_d)
        name = f"{i:03d}.png"
        write_png(os.path.join(root, "images", name),
                  np.round(img.reshape(h, w, 3) * 255).astype(np.uint8))
        r = c2w.T                                # world -> camera
        t = -r @ c
        cam = (pts[:, :1] * r[:, 0] + pts[:, 1:2] * r[:, 1]
               + pts[:, 2:3] * r[:, 2] + t)
        uv = cam[:, :2] / cam[:, 2:] * f + [0.5 * w, 0.5 * h]
        seen = np.flatnonzero((np.sum(pts * (c - pts), -1) > 0)
                              & (cam[:, 2] > 0) & (uv[:, 0] >= 0)
                              & (uv[:, 0] < w) & (uv[:, 1] >= 0)
                              & (uv[:, 1] < h))
        for j, p in enumerate(seen):
            tracks[p].append((i + 1, j))
        images.append((i + 1, rotmat2qvec(r), t, 1, name, uv[seen], seen))
    points = [(p, pts[p], (200, 200, 200), 0.5, tracks[p])
              for p in range(n_points) if tracks[p]]
    write_colmap_model(os.path.join(root, "sparse", "0"),
                       [(1, "PINHOLE", w, h, (f, f, 0.5 * w, 0.5 * h))],
                       images, points)
    return centres, np.stack(rots)


def fit_similarity(src, dst):
    """The similarity ``x -> s R x + t`` that best maps the points ``src``
    onto ``dst`` in least squares (Umeyama): returns (s, R, t)."""
    import numpy as np

    src, dst = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    ms, md = src.mean(0), dst.mean(0)
    a, b = src - ms, dst - md
    u, sv, vt = np.linalg.svd(b.T @ a / len(src))
    e = np.eye(3)
    e[2, 2] = np.sign(np.linalg.det(u @ vt))
    rot = u @ e @ vt
    s = float(np.sum(sv * np.diag(e)) / np.mean(np.sum(a * a, -1)))
    return s, rot, md - s * rot @ ms


def check_capture_conversion(root, centres, rots):
    """What ``run_colmap`` left in ``root`` against the written capture:
    one 17-column ``poses_bounds`` row and a ``world_mat_i`` /
    ``scale_mat_i`` pair a view, and the LLFF loader's cameras (as
    ``data/dataset.py`` loads them: recentred, ``bd_factor`` 1) one
    similarity away from the written ones: centres within 1e-4 of the
    capture's radius, camera axes ([right up back]) within 1e-4.  Returns
    the readings."""
    import os

    import numpy as np

    from fgs_nerf_tpu_torch.data.llff import load_llff_data

    n = len(centres)
    pb = np.load(os.path.join(root, "poses_bounds.npy"))
    _check(pb.shape == (n, 17) and np.isfinite(pb).all(),
           f"poses_bounds {pb.shape}")
    cs = np.load(os.path.join(root, "cameras_sphere.npz"))
    want = {f"{k}_{i}" for i in range(n) for k in ("world_mat", "scale_mat")}
    _check(set(cs.files) == want, f"cameras_sphere keys {sorted(cs.files)}")
    _, poses, bds, _, _ = load_llff_data(root, 1, recenter=True, bd_factor=1)
    s, rot, t = fit_similarity(poses[:, :3, 3], centres)
    got = s * poses[:, :3, 3] @ rot.T + t
    centre_err = float(np.abs(got - centres).max() / CAPTURE_RADIUS)
    gl = rots * np.array([1.0, -1.0, -1.0])      # OpenCV -> [right up back]
    axis_err = float(np.abs(rot @ poses[:, :3, :3] - gl).max())
    line = dict(views=n, near_far=[float(bds.min()), float(bds.max())],
                similarity_scale=s, centre_err_rel=centre_err,
                axis_err=axis_err,
                scale_mat_0=cs["scale_mat_0"].tolist())
    _check(centre_err <= 1e-4 and axis_err <= 1e-4,
           f"the LLFF cameras are not the capture's: {line}")
    return line


def _write_capture(run_dir):
    """Phase 22's data: a capture written by :func:`write_capture`,
    converted by the port's ``run_colmap --skip_masks`` (its ``sparse/0``
    taken as a reconstruction COLMAP left, no ``colmap`` run) and checked
    (:func:`check_capture_conversion`) -> the CLI's data arguments."""
    from fgs_nerf_tpu_torch import run_colmap as RC

    root = run_dir / "capture"
    t0 = time.perf_counter()
    centres, rots = write_capture(str(root))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = RC.main(["--custom_dataset_path", str(root), "--skip_masks"])
    convert_s = time.perf_counter() - t0
    _check(rc == 0, f"run_colmap exited with {rc}")
    line = check_capture_conversion(str(root), centres, rots)
    print(json.dumps({"capture": {"hw": list(LLFF_HW), "write_s": write_s,
                                  "run_colmap_s": convert_s, **line}}))
    return ["--dataset_type", "llff", "--dataset_path", str(root)]


# ---- phase 23: the masked Adam on the leaves of fine and coarse steps ----


def _adam_phase(torch, np, card, dev, batch, n_rand):
    """Phase 23: every masked Adam call of two sorted fine and two sorted
    coarse steps from a fresh state, held bit for bit against
    ``adam_leaf`` on the same tensors, timed and bounded.  Returns the
    calls' records."""
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.ops.cuda import masked_adam as A1
    from fgs_nerf_tpu_torch.optim import masked_adam as OPT

    kernel = OPT.masked_adam_step
    calls = []

    def checked(path):
        def run(*args):
            p, g, m, v, _, _, plr, skip = args[:8]
            got, want = kernel(*args), OPT.adam_leaf(*args)
            same = all(a.stride() == b.stride() and torch.equal(
                a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(got, want))
            r = dict(
                path=path, shape=list(p.shape), param_strides=list(p.stride()),
                grad_strides=list(g.stride()),
                tiled=not A1.plan(p, g, m, v, plr, skip).flat,
                skip_zero_grad=skip, per_voxel_lr=plr is not None,
                bit_equal=same,
                max_abs_err=max(float((a - b).abs().max()) if a.numel() else
                                0.0 for a, b in zip(got, want)),
                ms=_time_ms(lambda: kernel(*args), 10, torch),
                plain_ms=_time_ms(lambda: OPT.adam_leaf(*args), 3, torch),
                bound_ms=(28 + 4 * (plr is not None)) * p.numel()
                / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
            calls.append(r)
            print(json.dumps({"kernel": "masked_adam_step", **r,
                              "card": card}))
            _check(same, f"masked Adam, {path} {r['shape']}: not bit-equal "
                         "to adam_leaf")
            return got
        return run

    for stage in ("fine", "coarse"):
        _, _, params, lrs, s_val, _, step = _setup(torch, M, stage, "sorted",
                                                   dev, n_rand)
        opt = OPT.init_state(params)
        for which in ("first step", "second step"):
            path = f"{stage} {which}"
            with _patched([(OPT, "masked_adam_step", checked(path))]):
                params, opt, _ = step(params, opt, {}, *batch, s_val, lrs, 1.0)
            torch.cuda.synchronize()
            n = sum(c["path"] == path for c in calls)
            _check(n == _adam_leaves(params, lrs),
                   f"masked Adam, {path}: {n} leaves recorded")
        del params, opt
        torch.cuda.empty_cache()
    k0 = [c["tiled"] for c in calls
          if c["path"].startswith("fine") and c["shape"][-1] == 12
          and len(c["shape"]) == 4]
    _check(k0 == [True, False], f"fine k0 passes (tiled?) {k0}: the first "
                                "step tiled, the second flat expected")
    return calls


def _nccl_world_1():
    """Under ``torch.distributed.run --nproc_per_node 1``: one sorted coarse
    bench step on ``--mesh dp=1`` through NCCL and one without a mesh,
    from the same state: loss and every parameter bit for bit."""
    import numpy as np
    import torch

    from fgs_nerf_tpu_torch.device import resolve_device
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.optim.masked_adam import init_state, tree_leaves
    from fgs_nerf_tpu_torch.parallel.mesh import (
        build_mesh, maybe_distributed_init,
    )

    dev = resolve_device("cuda:0")
    torch.cuda.set_device(dev)
    _rank_kernels()
    _check(maybe_distributed_init("nccl", dev), "no launcher environment")
    mesh = build_mesh("dp=1", device=dev)
    batch = _bench_batch(torch, np, dev, 8192)
    _, _, p0, lrs, s_val, _, step = _setup(torch, M, "coarse", "sorted", dev,
                                           8192)
    *_, step_m = _setup(torch, M, "coarse", "sorted", dev, 8192, mesh=mesh)
    p1, _, m1 = step(p0, init_state(p0), {}, *batch, s_val, lrs, 1.0)
    pm, _, mm = step_m(p0, init_state(p0), {}, *batch, s_val, lrs, 1.0)
    equal = bool(torch.equal(m1["loss"], mm["loss"])) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(pm)))
    import torch.distributed as dist

    print(json.dumps({"nccl_world_1": {
        "backend": dist.get_backend(), "world": dist.get_world_size(),
        "bit_equal": equal, "loss": float(mm["loss"])}}))
    dist.destroy_process_group()


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    repo = Path(__file__).resolve().parent
    if not (repo / "fgs_nerf_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke: the fgs_nerf_tpu_torch package is "
                         "not beside this script")
    sys.path.insert(0, str(repo))
    if "--nccl-world-1" in sys.argv[1:]:
        return _nccl_world_1()

    import numpy as np

    from fgs_nerf_tpu_torch.device import resolve_device
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.ops import scatter as SC
    from fgs_nerf_tpu_torch.ops import sorted_cm as ST
    from fgs_nerf_tpu_torch.ops.cuda import build
    from fgs_nerf_tpu_torch.ops.cuda import fused_mlp_cm as B89
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS
    from fgs_nerf_tpu_torch.ops.cuda import masked_adam as A1
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
    from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56
    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1
    from fgs_nerf_tpu_torch.optim.masked_adam import init_state

    dev = resolve_device(None)
    t0 = time.perf_counter()

    # ---- 1. build ------------------------------------------------------
    kernels = (B1.KERNEL, B2.KERNEL, FS.KERNEL, B56.KERNEL, B7.KERNEL,
               B89.KERNEL, A1.KERNEL)
    build.build_all(kernels)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        for line in k.build_log().splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {k.source.name}: {line.strip()}")
    card = _card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)

    # ---- the bench.py configuration and traffic --------------------------
    n_rand = 8192
    batch = _bench_batch(torch, np, dev, n_rand)
    cfg, _, params0, lrs, s_val, loss_and_grads, step = _setup(
        torch, M, "coarse", "sorted", dev, n_rand)
    m = n_rand * cfg.sample_k
    print(json.dumps({"config": "bench.py coarse", "world_size": cfg.world_size,
                      "s_max": cfg.s_max, "sample_k": cfg.sample_k,
                      "samples_per_step": m,
                      "padded_rows": ST.padded_rows_cm(cfg.world_size),
                      "pack_cols": ST.rp_for(cfg.world_size)}))

    # ---- 2. kernel checks on the main path's own inputs -----------------
    captured = {}

    def recorder(key, fn):
        def rec(*args):
            captured.setdefault(key, _clone(args, torch))
            return fn(*args)
        return rec

    with _patched([(ST, "window_gather_cm", recorder("b1", ST.window_gather_cm)),
                   (ST, "dense_accumulate_cm",
                    recorder("b2", ST.dense_accumulate_cm)),
                   (FS, "fused_shade_cm_fwd",
                    recorder("b3", FS.fused_shade_cm_fwd)),
                   (FS, "fused_shade_cm_bwd",
                    recorder("b4", FS.fused_shade_cm_bwd))]):
        loss_and_grads(params0, {}, *batch, s_val, 1.0)
    torch.cuda.synchronize()
    _check(set(captured) == {"b1", "b2", "b3", "b4"}, sorted(captured))

    results = {}

    # B1: serve
    results["window_gather_cm"] = _check_call(torch, "window_gather_cm",
                                              captured["b1"], "coarse",
                                              grid3=cfg.world_size)

    # B2: dense accumulate
    rows_c, w8_2, g2, n_rows = captured["b2"]
    got = B2.dense_accumulate_cm(rows_c, w8_2, g2, n_rows)
    want = B2.dense_accumulate_cm_plain(rows_c, w8_2, g2, n_rows)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    _check(err <= 1e-4 * scale + 1e-12, f"B2: {err} vs scale {scale}")
    again = B2.dense_accumulate_cm(rows_c, w8_2, g2, n_rows)
    _check(torch.equal(got, again), "B2 is not deterministic")
    upd0, upd1 = B2.dense_updates(w8_2, g2)
    idx2 = torch.cat([rows_c, rows_c + 1]).long()
    upd2 = torch.cat([upd0, upd1], dim=1)
    c2 = g2.shape[0]
    bound = _bound(_nbytes(rows_c, w8_2, g2, got), 16 * c2 * rows_c.numel(),
                   PEAK_F32_FLOPS)
    results["dense_accumulate_cm"] = dict(
        path="coarse", max_abs_err=err,
        ms=_time_ms(lambda: B2.dense_accumulate_cm(rows_c, w8_2, g2, n_rows),
                    10, torch),
        plain_ms=_time_ms(
            lambda: B2.dense_accumulate_cm_plain(rows_c, w8_2, g2, n_rows), 5,
            torch),
        bound_ms=bound[0], bound_by=bound[1],
        # index_add_ alone, on updates formed before the timed region
        library_ms=_time_ms(
            lambda: torch.zeros((4 * c2, n_rows), device=dev).index_add_(
                1, idx2, upd2), 5, torch))
    del got, want, again, upd0, upd1, upd2, idx2

    # B3 / B4: fused shading head
    results["fused_shade_cm_fwd"] = _check_shade_fwd(torch, captured["b3"],
                                                     "coarse")
    results["fused_shade_cm_bwd"] = _check_shade_bwd(torch, captured["b4"],
                                                     "coarse")
    del captured
    torch.cuda.empty_cache()
    for name, r in results.items():
        print(json.dumps({"kernel": name, **r, "card": card}))

    # ---- 3. main path ----------------------------------------------------
    launchers = {
        "window_gather_cm": (B1.KERNEL, "window_gather_cm"),
        "dense_accumulate_cm": (B2.KERNEL, "dense_accumulate_cm"),
        "fused_shade_cm_fwd": (FS.KERNEL, "fused_shade_fwd"),
        "fused_shade_cm_bwd": (FS.KERNEL, "fused_shade_bwd"),
        "masked_adam_step": (A1.KERNEL, "masked_adam_step"),
    }
    for k in kernels:
        for fn in k.launches:
            k.launches[fn] = 0
    params, opt_state = params0, init_state(params0)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(N_WARMUP):
        params, opt_state, metrics = step(params, opt_state, {}, *batch,
                                          s_val, lrs, 1.0)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for _ in range(N_STEPS):
        params, opt_state, metrics = step(params, opt_state, {}, *batch,
                                          s_val, lrs, 1.0)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t_start) / N_STEPS
    launches = {name: k.launches[fn] for name, (k, fn) in launchers.items()}
    losses = [float(x) for x in losses]
    print(json.dumps({
        "metric": "train_rays_per_s", "value": n_rand / dt,
        "step_ms": dt * 1e3, "steps": N_STEPS, "card": card,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches": launches,
        "metrics": {k: float(v) for k, v in metrics.items()},
    }))
    _check(all(np.isfinite(losses)), losses)
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name, n in launches.items():
        _check(n > 0, f"{name} was not launched on the main path")
    _check(launches["masked_adam_step"]
           == _adam_leaves(params0, lrs) * (N_WARMUP + N_STEPS),
           f"coarse: {launches['masked_adam_step']} masked Adam launches, "
           "one a leaf a step expected")
    _device_breakdown(torch, lambda: step(params, opt_state, {}, *batch,
                                          s_val, lrs, 1.0), dt * 1e3, card)

    # ---- 4. kernel path against plain path -------------------------------
    twins = _plain_twins(ST, FS, SC, B1, B2, B56, B7)
    report = _step_vs_plain(torch, loss_and_grads, step, (params, opt_state),
                            {}, batch, s_val, lrs, twins)
    print(json.dumps({"kernel_vs_plain_step": report}))
    del params, opt_state, params0, report
    torch.cuda.empty_cache()
    coarse_launches = launches

    # ---- 5.-8. the fine stage ------------------------------------------
    fine_calls, fine_launches, masked_launches = _fine_phases(
        torch, np, card, dev, batch, n_rand)
    torch.cuda.empty_cache()

    # ---- 9.-11. the lattice engine, 12. the eval render ------------------
    b7_calls, lattice_launches, fine_state = _lattice_phases(
        torch, np, card, dev, batch, n_rand)
    _eval_phase(torch, np, card, fine_state)
    del fine_state
    torch.cuda.empty_cache()

    # ---- 13. B8/B9, 14. the pipeline through the CLI ---------------------
    mlp_calls, mlp_launches = _mlp_phase(torch, np, card, dev, batch, n_rand)
    pipeline, pipeline_calls = _pipeline_phase(torch, np, card, repo,
                                               kernels, _PIPELINE_CONFIG)
    torch.cuda.empty_cache()

    # ---- 15. the DTU path through the CLI ----------------------------
    dtu, dtu_calls = _pipeline_phase(torch, np, card, repo, kernels,
                                     _DTU_CONFIG, label="dtu",
                                     prepare=_write_dtu, eval_lpips=False,
                                     validate=False)

    # ---- 16. the remaining loaders, 17. --dvgo_init, 18. TensoRF ------
    t_new = time.perf_counter()
    loaders = _loaders_phase(np, card, repo)
    dvgo, dvgo_calls, dvgo_launches = _dvgo_phase(torch, np, card, repo,
                                                  kernels)
    torch.cuda.empty_cache()
    tensorf, tensorf_launches = _tensorf_phase(torch, np, card, dev, batch,
                                               n_rand, kernels)
    print(json.dumps({"phases_16_18_s": time.perf_counter() - t_new,
                      "loaders": len(loaders),
                      "dvgo_step_ms": dvgo["dvgo_step_ms"],
                      "tensorf_step_ms": tensorf["step_ms"]}))

    # ---- 19. dp = 2, 20. sp = 2 (two ranks on the card), 21. the CLI ----
    t_new = time.perf_counter()
    torch.cuda.empty_cache()
    mesh_launches = _mesh_phases(torch, np, card, repo)
    _cli_mesh_phase(torch, np, card, repo, dev)
    print(json.dumps({"phases_19_21_s": time.perf_counter() - t_new}))

    # ---- 22. a capture -> run_colmap -> LLFF three stages -----------------
    t_new = time.perf_counter()
    torch.cuda.empty_cache()
    capture, capture_calls = _pipeline_phase(
        torch, np, card, repo, kernels, _CAPTURE_CONFIG, label="capture",
        prepare=_write_capture, eval_lpips=False, validate=False,
        trace_stage="fine")
    print(json.dumps({"phase_22_s": time.perf_counter() - t_new}))

    # ---- 23. the masked Adam on the leaves of fine and coarse steps -------
    t_new = time.perf_counter()
    torch.cuda.empty_cache()
    adam_calls = _adam_phase(torch, np, card, dev, batch, n_rand)
    print(json.dumps({"phase_23_s": time.perf_counter() - t_new}))

    rows_out = []
    for name, kern, replaces, main_call in (
        ("window_gather_cm", B1.KERNEL,
         "fgs_nerf_tpu/ops/pallas/window_gather_cm.py:156", "fine pass 1"),
        ("dense_accumulate_cm", B2.KERNEL,
         "fgs_nerf_tpu/ops/pallas/scatter_combine_cm.py:182", "fine pass 1"),
        ("fused_shade_cm_fwd", FS.KERNEL,
         "fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:587", "coarse"),
        ("fused_shade_cm_bwd", FS.KERNEL,
         "fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:620", "coarse"),
        ("tap_window_serve_cm", B56.KERNEL,
         "fgs_nerf_tpu/ops/pallas/tap_serve_cm.py:158", "fine z/y taps"),
        ("tap_dense_accumulate_cm", B56.KERNEL,
         "fgs_nerf_tpu/ops/pallas/tap_serve_cm.py:358", "fine z/y taps"),
    ):
        calls = ([results[name]] if name in results else []) + (
            fine_calls.get(name, []) + pipeline_calls.get(name, [])
            + dtu_calls.get(name, []) + capture_calls.get(name, []))
        main = next(c for c in calls if c["path"] == main_call)
        by_path = {"coarse": coarse_launches.get(name, 0),
                   "fine": fine_launches.get(name, 0),
                   "fine_masked": masked_launches.get(name, 0),
                   **{p.replace(" ", "_"): c.get(_LAUNCHER_OF[name], 0)
                      for p, c in lattice_launches.items()},
                   "dvgo_coarse": dvgo_launches["dvgo_coarse"].get(
                       _LAUNCHER_OF[name], 0),
                   "tensorf_coarse": tensorf_launches.get(
                       _LAUNCHER_OF[name], 0),
                   **{p: c.get(_LAUNCHER_OF[name], 0)
                      for p, c in mesh_launches.items()},
                   **{f"capture_{st}": r["launches"].get(
                       _LAUNCHER_OF[name], 0) for st, r in capture.items()}}
        rows_out.append({
            "name": name, "route": "cuda", "source": kern.source_rel,
            "replaces": replaces,
            "launches": by_path["fine" if name in fine_launches else "coarse"],
            "max_abs_err": max(c["max_abs_err"] for c in calls),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "timed_call": main_call,
            **({"matmul_chain_ms": main["matmul_chain_ms"],
                "ptxas": _ptxas(kern, _SHADE_ENTRIES[name]),
                "dtu_coarse": _dtu_coarse_row(calls)}
               if kern is FS.KERNEL else {}),
            **({"ptxas": _ptxas(kern, _TAP_ACCUMULATE_ENTRIES)}
               if name == "tap_dense_accumulate_cm" else {}),
            **({"ptxas": _ptxas(kern, _SERVE_ENTRIES[name])}
               if name in _SERVE_ENTRIES else {}),
            "launches_by_path": by_path,
            "launches_per_step": {
                "coarse": by_path["coarse"] / (N_WARMUP + N_STEPS),
                "fine": by_path["fine"] / (N_WARMUP + N_FINE_STEPS)},
            "calls": calls,
        })
    main = next(c for c in b7_calls if c["path"] == "fine field")
    by_path = {p.replace(" ", "_"): c.get("dense_accumulate", 0)
               for p, c in lattice_launches.items()}
    by_path["dvgo"] = dvgo_launches["dvgo"].get("dense_accumulate", 0)
    by_path["sp2_lattice_fine"] = mesh_launches["sp2_lattice_fine"].get(
        "dense_accumulate", 0)
    b7_calls = b7_calls + dvgo_calls
    rows_out.append({
        "name": "dense_accumulate", "route": "cuda",
        "source": B7.KERNEL.source_rel,
        "replaces": "fgs_nerf_tpu/ops/pallas/scatter_combine.py:118",
        "launches": by_path["lattice_fine"],
        "max_abs_err": max(c["max_abs_err"] for c in b7_calls),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "timed_call": "fine field",
        "launches_by_path": by_path,
        "launches_per_step": {
            "lattice_coarse": by_path["lattice_coarse"] / (N_WARMUP + N_STEPS),
            "lattice_fine": by_path["lattice_fine"] / (N_WARMUP + N_FINE_STEPS),
            "dvgo": len(dvgo_calls)},
        "calls": b7_calls,
    })
    for name, replaces in (
            ("fused_mlp_fwd", "fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:231"),
            ("fused_mlp_bwd", "fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:258")):
        calls = mlp_calls[name]
        main = next(c for c in calls if c["path"] == "fine rgbnet")
        rows_out.append({
            "name": name, "route": "cuda", "source": B89.KERNEL.source_rel,
            "replaces": replaces, "launches": mlp_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in calls),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "matmul_chain_ms": main.get("matmul_chain_ms"),
            **({k: main[k] for k in (
                "kernel_ms", "bound_bytes_ms", "bound_operations_ms",
                "dynamic_smem_bytes", "plan", "l2_weight_bytes", "ptxas")}
               if name == "fused_mlp_fwd" else {}),
            **({"kernels_ms": main["kernels_ms"],
                "scratch_bytes": main["scratch_bytes"],
                "dynamic_smem_bytes": main["dynamic_smem_bytes"],
                "phase_peak_gb": max(c["phase_peak_gb"] for c in calls),
                "ptxas": _ptxas(B89.KERNEL, _MLP_BWD_ENTRIES)}
               if name == "fused_mlp_bwd" else {}),
            "timed_call": main["path"],
            "launches_path": "the fused_mlp_cm op, forward and backward of "
                             "the rgbnet and the refnet",
            "launches_per_step": {p: 0 for p in (
                "coarse", "fine", "lattice_coarse", "lattice_fine",
                *(f"pipeline_{st}" for st in pipeline),
                *(f"dtu_{st}" for st in dtu),
                *(f"capture_{st}" for st in capture))},
            "calls": calls,
        })
    main = next(c for c in adam_calls if c["path"] == "fine second step"
                and c["shape"][-1] == 12 and len(c["shape"]) == 4)
    by_path = {
        "coarse": coarse_launches["masked_adam_step"],
        "fine": fine_launches["masked_adam_step"],
        "fine_masked": masked_launches["masked_adam_step"],
        **{p.replace(" ", "_"): c.get("masked_adam_step", 0)
           for p, c in lattice_launches.items()},
        **{p: c.get("masked_adam_step", 0) for p, c in dvgo_launches.items()},
        "tensorf_coarse": tensorf_launches.get("masked_adam_step", 0),
        **{p: c.get("masked_adam_step", 0) for p, c in mesh_launches.items()},
        **{f"{label}_{st}": r["launches"].get("masked_adam_step", 0)
           for label, stages in (("pipeline", pipeline), ("dtu", dtu),
                                 ("capture", capture))
           for st, r in stages.items()}}
    rows_out.append({
        "name": "masked_adam_step", "route": "cuda",
        "source": A1.KERNEL.source_rel,
        "replaces": "none: fgs_nerf_tpu/optim/masked_adam.py is plain jnp",
        "launches": by_path["fine"],
        "max_abs_err": max(c["max_abs_err"] for c in adam_calls),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "timed_call": "fine k0, second step (flat)",
        "launches_by_path": by_path,
        "launches_per_step": {
            "coarse": by_path["coarse"] / (N_WARMUP + N_STEPS),
            "fine": by_path["fine"] / (N_WARMUP + N_FINE_STEPS)},
        "calls": adam_calls,
    })
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
