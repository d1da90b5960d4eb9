"""Time kernels B8 / B9 (the fused channel-major MLP) of a checkout of the
PyTorch port on the card, at the fine shading head's widths (`rgbnet`:
seven feature blocks, 106 -> 256 x 4; `refnet`: 307 -> 256 x 3 -> 3) and
M = 1,048,576 samples.  Inputs are random, made from a seed.  Each B9
call is also held against its plain twin (relative L2 and the share of
dx entries more than 1e-4 of the twin's RMS away, as `chip_smoke.py`
phase 13 reads them) and repeated for bit-equality; its time is split
by kernel name with `torch.profiler`.

    python scripts/time_mlp_torch.py [--tree DIR] [--label NAME]
                                     [--m M] [--build-only]

``--tree`` is the root of the checkout whose ``fgs_nerf_tpu_torch`` is
built and timed (default: the one this script lies in), so one call can
time two versions side by side, each in its own process.  Prints one
JSON line per net, with the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

NETS = (
    ("rgbnet", (12, 33, 21, 1, 24, 12, 3), (106, 256, 256, 256, 256)),
    ("refnet", (256, 51), (307, 256, 256, 256, 3)),
)
REPEAT = 5  # timed calls per kernel and net, after one untimed call


def _time_ms(torch, fn, n):
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


def kernel_split_ms(torch, fn, n=2):
    """Device ms per call of each CUDA kernel that ``fn`` launches, by
    kernel name, from ``torch.profiler`` over ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t:
            out[e.key[:60]] = t / (1e3 * n)
    return out


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--m", type=int, default=1_048_576)
    ap.add_argument("--build-only", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.tree).resolve()))
    from fgs_nerf_tpu_torch.ops import fused_mlp_cm as FM
    from fgs_nerf_tpu_torch.ops.cuda import fused_mlp_cm as B89

    if a.build_only:
        proc = B89.KERNEL.start_build()
        if proc is not None:
            B89.KERNEL.finish_build(proc)
        return
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for name, rows, dims in NETS:
        blocks = [t(r, a.m, scale=0.5) for r in rows]
        ws = [t(i, o, scale=i ** -0.5) for i, o in zip(dims[:-1], dims[1:])]
        bs = [t(o, scale=0.1) for o in dims[1:]]
        g = t(dims[-1], a.m)
        got = FM.fused_mlp_cm_bwd(blocks, ws, bs, g)
        again = FM.fused_mlp_cm_bwd(blocks, ws, bs, g)
        outs = [got[0], *got[1], *got[2]]
        repeat = all(torch.equal(x, y) for x, y in
                     zip(outs, [again[0], *again[1], *again[2]]))
        del again
        ref = FM.fused_mlp_cm_bwd_plain(blocks, ws, bs, g)
        ref = [ref[0], *ref[1], *ref[2]]
        far = ((outs[0] - ref[0]).abs()
               > 1e-4 * ref[0].double().pow(2).mean().sqrt())
        readings = dict(
            max_rel_l2=max(_rel_l2(x, y) for x, y in zip(outs, ref)),
            dx_share_past_1e4_rms=float(far.double().mean()),
            bit_equal_repeat=repeat)
        del got, outs, ref, far
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        b9_ms = _time_ms(torch, lambda: FM.fused_mlp_cm_bwd(blocks, ws, bs, g),
                         REPEAT)
        print(json.dumps({
            "label": a.label, "net": name, "m": a.m, "card": card,
            "b8_ms": _time_ms(torch, lambda: FM.fused_mlp_cm_fwd(blocks, ws, bs),
                              REPEAT),
            "b9_ms": b9_ms,
            "b9_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "b9_kernels_ms": kernel_split_ms(
                torch, lambda: FM.fused_mlp_cm_bwd(blocks, ws, bs, g)),
            **readings,
        }), flush=True)
        del blocks, ws, bs, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
