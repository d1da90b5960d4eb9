#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fgs_nerf_tpu_torch``) on one CUDA card
and check it.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero, with no result line):

1. Build: compile every CUDA kernel of the coarse train step from
   ``fgs_nerf_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel)
   and print the card's name and power limit.
2. Kernel checks: run one coarse step at the ``bench.py`` configuration
   (8,192 rays, 114^3 grid, sample_k 288 -> M = 2,359,296 samples,
   refnet 90 -> 192 -> 192 -> 3) and keep the inputs each kernel wrapper
   received.  On those inputs, hold every kernel against its plain
   PyTorch twin (tolerances below), time both with CUDA events, time
   the one PyTorch call that computes the same function where there is
   one, and compute the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate of their type).
3. Main path: zero the launch counts, run warm-up and timed train steps
   (``train/trainer.py:make_train_step``), read the counts; the loss
   must be finite and fall, and every kernel must have launched.  Then
   profile two more steps (``torch.profiler``) and print device time
   per step by kernel group and the device's idle share.
4. Kernel path against plain path: one step through the kernels and
   one through their plain twins from the same state; compare loss,
   gradients and post-Adam parameters.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

Tolerances and why: B1 sums in its twin's order with IEEE operations,
so it must be bit-equal; B2's twin uses ``index_add_``, whose atomics add
in any order (relative 1e-4 of the largest value); B3/B4 share every
bf16 rounding with their twins but sum in another order, so a hidden
value can land one bf16 ulp away (logits: max 1e-2, at most 1% past
1e-5; cotangents: relative L2 1e-3).  Whole-step gradients: relative L2
1e-2; post-Adam parameters where |g| > 1e-5: 1e-4 (Adam's first step is
lr * g / (|g| + 1e-7), steep where |g| is small).
"""
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # dense tensor-core bf16
PEAK_F32_FLOPS = 67e12       # fp32 outside the tensor cores
N_WARMUP = 2
N_STEPS = 10


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


_BUCKETS = (  # kernel-name fragments -> bucket, first match wins
    ("serve B1", ("window_gather_cm",)),
    ("accumulate B2", ("run_starts", "chunk_sums", "dense_accumulate_cm")),
    ("shade B3", ("fused_shade_fwd",)),
    ("shade B4", ("fused_shade_bwd", "reduce_partials")),
    ("sort", ("sort", "radix", "Sort")),
    ("gather/scatter", ("index", "gather", "scatter", "Index")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized")),
)


def _device_breakdown(torch, run_step, step_ms, card):
    """Profile two steps; print device time per step by bucket, the top
    kernels, and the device's idle share against the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run_step()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t and str(getattr(e, "device_type", "")).endswith("CUDA"):
            kernels.append((e.key, t / 2e3, e.count // 2))
    busy = sum(t for _, t, _ in kernels)
    buckets = {}
    for name, t, _ in kernels:
        for bucket, frags in _BUCKETS:
            if any(f in name for f in frags):
                break
        else:
            bucket = "other"
        buckets[bucket] = buckets.get(bucket, 0.0) + t
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    print(json.dumps({
        "device_ms_per_step": busy, "step_ms": step_ms,
        "idle_share": (1.0 - busy / step_ms) if busy else None,
        "buckets_ms": buckets, "n_kernel_names": len(kernels),
        "top": [{"kernel": n[:90], "ms": t, "calls": c} for n, t, c in top],
        "card": card,
    }))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    repo = Path(__file__).resolve().parent
    if not (repo / "fgs_nerf_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke: the fgs_nerf_tpu_torch package is "
                         "not beside this script")
    sys.path.insert(0, str(repo))

    import numpy as np

    from fgs_nerf_tpu_torch.core.box import SceneBox
    from fgs_nerf_tpu_torch.device import resolve_device
    from fgs_nerf_tpu_torch.models import sdf_voxel as M
    from fgs_nerf_tpu_torch.ops import sorted_cm as ST
    from fgs_nerf_tpu_torch.ops.cuda import build
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS
    from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
    from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1
    from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts, init_state
    from fgs_nerf_tpu_torch.train.losses import LossWeights
    from fgs_nerf_tpu_torch.train.trainer import (
        make_loss_and_grads, make_train_step,
    )

    dev = resolve_device(None)
    t0 = time.perf_counter()

    # ---- 1. build ------------------------------------------------------
    kernels = (B1.KERNEL, B2.KERNEL, FS.KERNEL)
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
    xyz_min = np.array([-1.0, -1.0, -1.0], np.float32)
    xyz_max = np.array([1.0, 1.0, 1.0], np.float32)
    cfg = M.make_model_config(
        stage="coarse", xyz_min=xyz_min, xyz_max=xyz_max,
        num_voxels=1_500_000, num_voxels_base=1_500_000, stepsize=0.5,
        k0_dim=12, refnet_width=192, refnet_depth=3, posbase_pe=5,
        viewbase_pe=1, refbase_pe=5, smooth_ksize=5, smooth_sigma=0.8,
        s_ratio=50.0, s_start=0.2, fast_color_thres=1e-4, shade_k=256,
        sample_k=288, shade_remat=False, engine="sorted",
    )
    box = SceneBox.create(xyz_min, xyz_max, dev)
    n_rand = 8192
    rng = np.random.default_rng(0)
    cam = np.array([0.0, 0.0, 3.5], np.float32)
    rays_o = np.broadcast_to(cam, (n_rand, 3)).copy()
    look = rng.normal(size=(n_rand, 3)).astype(np.float32) * 0.4
    rays_d = look - rays_o
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    target = rng.uniform(size=(n_rand, 3)).astype(np.float32)
    batch = [torch.as_tensor(a, device=dev)
             for a in (rays_o, rays_d, viewdirs, target)]
    loss_w = LossWeights(
        weight_main=1.0, weight_rgbper=0.2, weight_entropy_last=1e-3,
        weight_orientation=1e-4, sigmoid_rgb_loss=0.1,
        weight_tv_density=0.01, weight_tv_k0=0.0, ori_tv=True,
    )
    step_kw = dict(near=0.2, bg=1.0, n_rand=n_rand, sdf_tv=0.1,
                   smooth_grad_tv=0.05, inject_tv=False, tv_dense=True,
                   weight_tv_density=0.01, weight_tv_k0=0.0,
                   use_nonempty_mask=False)
    params0 = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
    opts = {k: ParamOpts(skip_zero_grad=k in ("k0", "sdf")) for k in params0}
    lrs = {"sdf": 0.1, "k0": 0.1, "refnet": 1e-3}
    s_val = torch.tensor(0.2, device=dev)
    loss_and_grads = make_loss_and_grads(
        cfg, box, loss_w, near=0.2, bg=1.0, sdf_tv=0.1, smooth_grad_tv=0.05,
        use_nonempty_mask=False)
    step = make_train_step(cfg, box, loss_w, opts, **step_kw)
    m = n_rand * cfg.sample_k
    print(json.dumps({"config": "bench.py coarse", "world_size": cfg.world_size,
                      "s_max": cfg.s_max, "sample_k": cfg.sample_k,
                      "samples_per_step": m,
                      "padded_rows": ST.padded_rows_cm(cfg.world_size),
                      "pack_cols": ST.rp_for(cfg.world_size)}))

    # ---- 2. kernel checks on the main path's own inputs -----------------
    captured = {}

    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.detach().clone()
        if isinstance(a, (list, tuple)):
            return type(a)(clone(x) for x in a)
        return a

    def recorder(key, fn):
        def rec(*args):
            captured.setdefault(key, clone(args))
            return fn(*args)
        return rec

    saved = (ST.window_gather_cm, ST.dense_accumulate_cm,
             FS.fused_shade_cm_fwd, FS.fused_shade_cm_bwd)
    ST.window_gather_cm = recorder("b1", saved[0])
    ST.dense_accumulate_cm = recorder("b2", saved[1])
    FS.fused_shade_cm_fwd = recorder("b3", saved[2])
    FS.fused_shade_cm_bwd = recorder("b4", saved[3])
    try:
        loss_and_grads(params0, {}, *batch, s_val, 1.0)
    finally:
        (ST.window_gather_cm, ST.dense_accumulate_cm,
         FS.fused_shade_cm_fwd, FS.fused_shade_cm_bwd) = saved
    torch.cuda.synchronize()
    _check(set(captured) == {"b1", "b2", "b3", "b4"}, sorted(captured))

    results = {}

    # B1: serve
    pack, rows, w8 = captured["b1"]
    got = B1.window_gather_cm(pack, rows, w8)
    want = B1.window_gather_cm_plain(pack, rows, w8)
    err = float((got - want).abs().max())
    _check(err == 0.0, f"B1 differs from its plain twin: {err}")
    c = pack.shape[0] // 4
    nb = _nbytes(pack, rows, w8, got)
    results["window_gather_cm"] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: B1.window_gather_cm(pack, rows, w8), 10, torch),
        plain_ms=_time_ms(lambda: B1.window_gather_cm_plain(pack, rows, w8), 5,
                          torch),
        bound=_bound(nb, 16 * c * rows.numel(), PEAK_F32_FLOPS),
        library_ms=None)
    del got, want

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
    nb = _nbytes(rows_c, w8_2, g2, got)
    results["dense_accumulate_cm"] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: B2.dense_accumulate_cm(rows_c, w8_2, g2, n_rows),
                    10, torch),
        plain_ms=_time_ms(
            lambda: B2.dense_accumulate_cm_plain(rows_c, w8_2, g2, n_rows), 5,
            torch),
        bound=_bound(nb, 16 * c2 * rows_c.numel(), PEAK_F32_FLOPS),
        # index_add_ alone, on updates formed before the timed region
        library_ms=_time_ms(
            lambda: torch.zeros((4 * c2, n_rows), device=dev).index_add_(
                1, idx2, upd2), 5, torch))
    del got, want, again, upd0, upd1, upd2, idx2

    # B3 / B4: fused shading head
    k0, xyz, refl, normal, vd, ws, bs, *pe = captured["b3"]
    ins = (k0, xyz, refl, normal, vd)
    cin = ws[0].shape[0]
    hid = ws[0].shape[1]
    d_out = ws[-1].shape[1]
    macs = cin * hid + sum(w.shape[0] * w.shape[1] for w in ws[1:])
    ms = k0.shape[-1]
    got = FS.fused_shade_cm_fwd(*ins, ws, bs, *pe)
    want = FS.fused_shade_cm_fwd_plain(*ins, ws, bs, *pe)
    diff = (got - want).abs()
    err = float(diff.max())
    frac = float((diff > 1e-5).float().mean())
    _check(err < 1e-2 and frac < 0.01, f"B3: max {err}, past 1e-5 {frac}")
    in_bytes = _nbytes(*ins) + _nbytes(*ws) + _nbytes(*bs)
    results["fused_shade_cm_fwd"] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: FS.fused_shade_cm_fwd(*ins, ws, bs, *pe), 5,
                    torch),
        plain_ms=_time_ms(
            lambda: FS.fused_shade_cm_fwd_plain(*ins, ws, bs, *pe), 3, torch),
        bound=_bound(in_bytes + _nbytes(got), 2 * macs * ms, PEAK_BF16_FLOPS),
        library_ms=None)
    del got, want, diff

    k0, xyz, refl, normal, vd, ws, bs, g, *pe = captured["b4"]
    ins = (k0, xyz, refl, normal, vd)
    d_k, dw_k, db_k = FS.fused_shade_cm_bwd(*ins, ws, bs, g, *pe)
    d_p, dw_p, db_p = FS.fused_shade_cm_bwd_plain(*ins, ws, bs, g, *pe)
    err = 0.0
    for a, b in zip(list(d_k) + dw_k + db_k, list(d_p) + dw_p + db_p):
        if b is None:
            continue
        rel = _rel_l2(a, b)
        _check(rel < 1e-3, f"B4 cotangent off by rel L2 {rel}")
        err = max(err, float((a - b).abs().max()))
    again = FS.fused_shade_cm_bwd(*ins, ws, bs, g, *pe)
    _check(all(torch.equal(a, b) for a, b in zip(dw_k, again[1])),
           "B4 dW is not deterministic")
    out_bytes = _nbytes(*[d for d in d_k if d is not None], *dw_k, *db_k)
    results["fused_shade_cm_bwd"] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: FS.fused_shade_cm_bwd(*ins, ws, bs, g, *pe), 3,
                    torch),
        plain_ms=_time_ms(
            lambda: FS.fused_shade_cm_bwd_plain(*ins, ws, bs, g, *pe), 2,
            torch),
        # recompute + dW + dX: three times the forward's products
        bound=_bound(in_bytes + _nbytes(g) + out_bytes, 6 * macs * ms,
                     PEAK_BF16_FLOPS),
        library_ms=None)
    del d_k, dw_k, db_k, d_p, dw_p, db_p, again, captured
    torch.cuda.empty_cache()
    for name, r in results.items():
        print(json.dumps({"kernel": name, "max_abs_err": r["max_abs_err"],
                          "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                          "bound_ms": r["bound"][0],
                          "bound_by": r["bound"][1],
                          "library_ms": r["library_ms"], "card": card}))

    # ---- 3. main path ----------------------------------------------------
    launchers = {
        "window_gather_cm": (B1.KERNEL, "window_gather_cm"),
        "dense_accumulate_cm": (B2.KERNEL, "dense_accumulate_cm"),
        "fused_shade_cm_fwd": (FS.KERNEL, "fused_shade_fwd"),
        "fused_shade_cm_bwd": (FS.KERNEL, "fused_shade_bwd"),
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
    _device_breakdown(torch, lambda: step(params, opt_state, {}, *batch,
                                          s_val, lrs, 1.0), dt * 1e3, card)

    # ---- 4. kernel path against plain path -------------------------------
    @contextlib.contextmanager
    def plain_twins():
        ST.window_gather_cm = B1.window_gather_cm_plain
        ST.dense_accumulate_cm = B2.dense_accumulate_cm_plain
        FS.fused_shade_cm_fwd = FS.fused_shade_cm_fwd_plain
        FS.fused_shade_cm_bwd = FS.fused_shade_cm_bwd_plain
        try:
            yield
        finally:
            (ST.window_gather_cm, ST.dense_accumulate_cm,
             FS.fused_shade_cm_fwd, FS.fused_shade_cm_bwd) = saved

    state = (params, opt_state)
    _, lk, gk = loss_and_grads(params, {}, *batch, s_val, 1.0)
    pk, _, _ = step(*state, {}, *batch, s_val, lrs, 1.0)
    with plain_twins():
        _, lp, gp = loss_and_grads(params, {}, *batch, s_val, 1.0)
        pp, _, _ = step(*state, {}, *batch, s_val, lrs, 1.0)
    report = {"loss_kernel": float(lk["loss"].detach()),
              "loss_plain": float(lp["loss"].detach())}
    _check(abs(report["loss_kernel"] - report["loss_plain"])
           <= 1e-4 * abs(report["loss_plain"]), report)

    def leaves(tree, prefix=""):
        for key, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + key + ".")
            else:
                yield prefix + key, v

    gp_l, pk_l, pp_l = dict(leaves(gp)), dict(leaves(pk)), dict(leaves(pp))
    for name, a in leaves(gk):
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
    print(json.dumps({"kernel_vs_plain_step": report}))

    rows_out = []
    for name, src, replaces in (
        ("window_gather_cm", B1.KERNEL.source_rel,
         "fgs_nerf_tpu/ops/pallas/window_gather_cm.py:156"),
        ("dense_accumulate_cm", B2.KERNEL.source_rel,
         "fgs_nerf_tpu/ops/pallas/scatter_combine_cm.py:182"),
        ("fused_shade_cm_fwd", FS.KERNEL.source_rel,
         "fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:587"),
        ("fused_shade_cm_bwd", FS.KERNEL.source_rel,
         "fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:620"),
    ):
        r = results[name]
        rows_out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
