"""Time kernels B3 / B4 (the fused coarse shading head) of a checkout of
the PyTorch port on the card, at the three shapes its main paths give
them: the sorted coarse stage (cin8 128, hidden 192), the DTU geometry
stage (cin8 120, hidden 128) and the DTU coarse stage (cin8 144, hidden
192).  Inputs are random, made from a seed; a shape the checkout's
kernels cannot take is skipped.

    python scripts/time_shade_torch.py [--tree DIR] [--label NAME]
                                       [--build-only]

``--tree`` is the root of the checkout whose ``fgs_nerf_tpu_torch`` is
built and timed (default: the one this script lies in), so one call can
time two versions of the kernel side by side, each in its own process.
Prints one JSON line per shape, with the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

# (name, k0_dim, (pos_pe, ref_pe, view_pe), hidden, M)
SHAPES = (
    ("coarse", 12, (5, 5, 1), 192, 2_359_296),
    ("dtu_geometry", 6, (5, 3, 1), 128, 2_949_120),
    ("dtu_coarse", 12, (5, 5, 3), 192, 2_359_296),
)
REPEAT = 10  # timed calls per kernel and shape, after one untimed call


def _inputs(torch, k0_dim, m):
    """The five raw input blocks and a maker of more random tensors, all
    from generator seed 0."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def unit(n):
        v = t(3, n)
        return v / v.norm(dim=0, keepdim=True)

    ins = [t(k0_dim, m), t(3, m).clamp(-1, 1), unit(m), unit(m), unit(m)]
    return ins, t


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--build-only", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.tree).resolve()))
    from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS

    if a.build_only:
        proc = FS.KERNEL.start_build()
        if proc is not None:
            FS.KERNEL.finish_build(proc)
        return
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    max_cin8 = getattr(FS, "MAX_CIN8", 128)
    for name, k0_dim, pe, hid, m in SHAPES:
        rows = FS.shade_layout(k0_dim, *pe, True)
        cin8 = FS.pad_plan(rows)[1]
        if cin8 > max_cin8:
            continue
        ins, t = _inputs(torch, k0_dim, m)
        dims = (sum(rows), hid, hid, 3)
        ws = [t(i, o, scale=i ** -0.5) for i, o in zip(dims[:-1], dims[1:])]
        bs = [t(o, scale=0.1) for o in dims[1:]]
        grad = t(3, m)
        fwd = FS.fused_shade_cm_fwd(*ins, ws, bs, *pe)
        bwd = FS.fused_shade_cm_bwd(*ins, ws, bs, grad, *pe)
        torch.cuda.synchronize()
        print(json.dumps({
            "label": a.label, "shape": name, "cin8": cin8, "hidden": hid,
            "m": m, "card": card,
            "b3_ms": _time_ms(torch, lambda: FS.fused_shade_cm_fwd(
                *ins, ws, bs, *pe), REPEAT),
            "b4_ms": _time_ms(torch, lambda: FS.fused_shade_cm_bwd(
                *ins, ws, bs, grad, *pe), REPEAT),
            "b3_finite": bool(torch.isfinite(fwd).all()),
            "b4_finite": bool(all(torch.isfinite(x).all()
                                  for x in bwd[1] + bwd[2])),
        }), flush=True)
        del ins, ws, bs, grad, fwd, bwd
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
