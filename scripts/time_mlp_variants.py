"""Time variants of kernels B8 and B9 (the fused MLP forward and
backward) on the card, each built from a copy of
``fgs_nerf_tpu_torch/csrc/fused_mlp_cm.cu`` with a few constants or lines
replaced, at the fine head's widths (M = 1,048,576, random inputs from
seed 0), their time split by kernel with ``torch.profiler``, in two
rounds of turns.

    python scripts/time_mlp_variants.py [NAME ...]

Variants (default: all):

- ``base``: the source as it is (B8 and B9 both timed).
- B9: ``tile64``: 64-sample tiles, 8 warps, 32-row weight chunks, two
  per-tile blocks an SM (twice the grid); ``warps8`` / ``warps32``: 8
  warps of 64 x 64 / 32 warps of 32 x 32 accumulator tiles a block
  (128-sample tiles).
- B9 ablations, whose outputs are wrong and whose time says what the part
  costs: ``no_mma`` (no tensor-core product in the per-tile pass),
  ``no_loads`` (no global loads of the inputs or the cotangents),
  ``no_stores`` (no scratch stores), ``no_wcopy`` (no weight copies),
  ``no_ballots`` (no ReLU mask ballots).
- B8 ablations (outputs wrong, likewise): ``fwd_no_mma`` (no wgmma
  product), ``fwd_no_loads`` (no global loads of the input rows),
  ``fwd_no_stores`` (no output stores), ``fwd_no_wcopy`` (no bulk copies
  of the weights: each stage's barrier completes at once), and their
  combinations ``fwd_mma_only`` (no loads, no stores), ``fwd_io_only``
  (no products, loads or stores) and ``fwd_sync_only`` (and no weight
  copies: the kernel's skeleton of waits, barriers, epilogues and X
  stores).
- B8 variants: ``fwd_frs3`` (input units stored two chunks after their
  copy, not one: three staging slots a warp), ``fwd_late_prefetch`` (a
  chunk's input step after its wgmmas are committed, not before they are
  issued).

Each line also says whether ptxas serialized B8's wgmmas (C7520).

The copies and their builds go under ``results/mlp_variants/``.  Prints
one JSON line per net, variant and round, with the card's name and
power limit.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "fgs_nerf_tpu_torch" / "csrc"
OUT = ROOT / "results" / "mlp_variants"

_TILE64 = [
    ("#define BT 128 ", "#define BT 64 "), ("#define BNT 512 ", "#define BNT 256 "),
    ("#define KC 64 ", "#define KC 32 "),
    ("__launch_bounds__(BNT, 1)\nfused_mlp_tile_bwd_kernel",
     "__launch_bounds__(BNT, 2)\nfused_mlp_tile_bwd_kernel"),
]
VARIANTS = {
    "base": [],
    "tile64": _TILE64,
    "warps8": [("#define BNT 512 ", "#define BNT 256 ")],
    "warps32": [("#define BNT 512 ", "#define BNT 1024 "),
                ("#define WM 2 ", "#define WM 4 ")],
    "no_mma": [("for (int mt = 0; mt < MTW; ++mt) mma16816(acc[mt][j], af[mt], b0, b1);",
                "for (int mt = 0; mt < MTW; ++mt) acc[mt][j][0] += "
                "__uint_as_float(af[mt][0] ^ b0 ^ b1);")],
    "no_loads": [("? __ldg(r0 + gs) : 0.0f;", "? 1.0f : 0.0f;"),
                 ("? __ldg(r1 + gs) : 0.0f;", "? 1.0f : 0.0f;")],
    "no_stores": [("    *reinterpret_cast<uint4*>(dst + (long long)s * width + c) = v;",
                   "    if (v.x == 0x7fffffffu && v.y == 0x7fffffffu)\n"
                   "      *reinterpret_cast<uint4*>(dst + (long long)s * width + c) = v;")],
    "no_wcopy": [("      cp_async16(dst + r * sw + k, src + (long long)r * p.ldb + k);",
                  "      if (k < 0) cp_async16(dst + r * sw + k, src + (long long)r * p.ldb + k);")],
    "fwd_no_mma": [("wgmma_n<N>(acc, da, db, sd);", "if (sd < 0) wgmma_n<N>(acc, da, db, sd);")],
    "fwd_no_loads": [("cp_async4z(raw + sl * 256 + 2 * m + e, ok ? row + s : a.blk[0], ok ? 4u : 0u);",
                      "cp_async4z(raw + sl * 256 + 2 * m + e, a.blk[0], 0u);")],
    "fwd_no_stores": [("__stcs(reinterpret_cast<float4*>(row + s), v);",
                       "if (v.x == 12345.0f) __stcs(reinterpret_cast<float4*>(row + s), v);"),
                      ("if (tg < rows && base + tg < a.d_out)\n",
                       "if (tg < rows && base + tg < a.d_out && M < 0)\n")],
    "fwd_no_wcopy": [("mbar_expect_tx(full + st, (uint32_t)p.q_bytes[c]);", "mbar_arrive(full + st);"),
                     ("bulk_load(ring + st * FSTAGE, p.q_src[c], (uint32_t)p.q_bytes[c], full + st);", "")],
    "fwd_frs3": [("#define FRS 2 ", "#define FRS 3 ")],
    "fwd_late_prefetch": [],  # filled below: the prefetch step after the commit
    "fwd_io_only": [],      # filled below: no products, loads, stores
    "fwd_sync_only": [],    # and no weight copies
    "fwd_mma_only": [],     # products and the ring: no loads, no stores
    "no_ballots": [("        const uint32_t w0 = __ballot_sync(0xffffffffu, z0 > 0.0f);\n"
                    "        const uint32_t w1 = __ballot_sync(0xffffffffu, z1 > 0.0f);\n"
                    "        if (lane == 0) {",
                    "        const uint32_t w0 = 0, w1 = 0;\n"
                    "        if (lane == 0 && z0 == 12345.0f) {")],
}
VARIANTS["fwd_io_only"] = (VARIANTS["fwd_no_mma"] + VARIANTS["fwd_no_loads"]
                           + VARIANTS["fwd_no_stores"])
VARIANTS["fwd_sync_only"] = VARIANTS["fwd_io_only"] + VARIANTS["fwd_no_wcopy"]
VARIANTS["fwd_mma_only"] = VARIANTS["fwd_no_loads"] + VARIANTS["fwd_no_stores"]
# the prefetch step of a chunk moved from before its wgmmas to after its commit
_PREF = (CSRC / "fused_mlp_cm.cu").read_text()
_PREF = _PREF[_PREF.index("            if (l > 0) {\n              if (has_next) {"):
              _PREF.index("            const bf16* ws = ring + st * FSTAGE;")]
VARIANTS["fwd_late_prefetch"] = [
    (_PREF, ""), ("            wgmma_commit();\n", "            wgmma_commit();\n" + _PREF)]
NETS = (
    ("rgbnet", (12, 33, 21, 1, 24, 12, 3), (106, 256, 256, 256, 256)),
    ("refnet", (256, 51), (307, 256, 256, 256, 3)),
)


def write_variant(name):
    src = (CSRC / "fused_mlp_cm.cu").read_text()
    src = src.replace('#include "mma_bf16.cuh"', f'#include "{CSRC}/mma_bf16.cuh"')
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not in the source once")
        src = src.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(src)
    return path


def main():
    sys.path.insert(0, str(ROOT))
    import torch

    from fgs_nerf_tpu_torch.ops import fused_mlp_cm as FM
    from fgs_nerf_tpu_torch.ops.cuda import build
    from fgs_nerf_tpu_torch.ops.cuda import fused_mlp_cm as B89
    sys.path.insert(0, str(ROOT / "scripts"))
    from time_mlp_torch import kernel_split_ms

    names = sys.argv[1:] or list(VARIANTS)
    OUT.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    procs = {n: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"lib{n}.so"),
         str(write_variant(n))], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in names}
    libs, ptxas = {}, {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {n}: nvcc failed\n{log[-3000:]}")
        lines = log.splitlines()
        ptxas[n] = {}
        for entry in ("tile_bwd", "mlp_fwd"):
            at = next(i for i, l in enumerate(lines)
                      if "Compiling entry" in l and entry in l)
            ptxas[n][entry] = " ".join(
                l.split(":", 1)[-1].strip() for l in lines[at + 1:at + 4]
                if "Used" in l or "spill" in l)
        ptxas[n]["serialized_wgmma"] = any("C7520" in l for l in lines)
        lib = ctypes.CDLL(str(OUT / f"lib{n}.so"))
        for fn, argtypes in B89.KERNEL.launchers.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        libs[n] = lib
    plan = B89.bwd_plan

    def plan_twice_the_grid(*a, **k):
        out = plan(*a, **k)
        out["nblk"] = min(2 * out["nblk"], -(-a[0] // 64))
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for net, rows, dims in NETS:
        m = 1_048_576
        blocks = [t(r, m, scale=0.5) for r in rows]
        ws = [t(i, o, scale=i ** -0.5) for i, o in zip(dims[:-1], dims[1:])]
        bs = [t(o, scale=0.1) for o in dims[1:]]
        g = t(dims[-1], m)
        for rnd in range(2):
            for n, lib in libs.items():
                B89.KERNEL._lib = lib
                B89.bwd_plan = plan_twice_the_grid if n == "tile64" else plan
                split = {}
                if not n.startswith("fwd_"):
                    split.update(kernel_split_ms(
                        torch, lambda: FM.fused_mlp_cm_bwd(blocks, ws, bs, g)))
                if n == "base" or n.startswith("fwd_"):
                    split.update(kernel_split_ms(
                        torch, lambda: FM.fused_mlp_cm_fwd(blocks, ws, bs)))
                print(json.dumps({
                    "net": net, "variant": n, "round": rnd,
                    **{k.split("(")[0]: v for k, v in split.items()
                       if "mlp" in k},
                    "ptxas": ptxas[n], "card": card}), flush=True)
        B89.bwd_plan = plan
        del blocks, ws, bs, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
