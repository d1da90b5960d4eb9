"""Kernels B8/B9: the fused channel-major MLP, forward and backward.

Replaces ``fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:231``
(``fused_mlp_cm_fwd_pallas``) and ``:258`` (``fused_mlp_cm_bwd_pallas``);
the CUDA source is ``csrc/fused_mlp_cm.cu`` (design and bounds in its
header).  B8: one persistent block an SM on 128-sample tiles; a producer
warpgroup copies each layer's weights once per tile, in <= 16 KB chunks
of the slab layout (``slab_layout``), by bulk copies (the TMA engine)
into a ring of shared-memory stages, and two consumer warpgroups, each
owning 64 samples, run the products on ``wgmma`` with both operands in
shared memory, load the next tile's input rows during this tile's
products and write the output by bulk stores (``fwd_plan``).  B9: a
per-tile pass on 128-sample tiles with the weights staged in shared
memory, which writes dx, the tile's bf16 activations and cotangents to a
scratch buffer and per-block bias sums; a split-K dW kernel over sample
ranges; and a fixed-order sum of the partials (``bwd_plan``).  Both
refuse a layer wider than 256 outputs.  The function, its plain twins
and the autograd op live in ``ops/fused_mlp_cm.py``; this module prepares
the kernels' operands (every dim padded to 16 with zeros, the weights in
bf16 in [out][in] and [in][out] order for B9 and in B8's slab layout)
and launches them.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from fgs_nerf_tpu_torch.ops.cuda.build import I32, I64, P, CudaKernel, stream_ptr

KERNEL = CudaKernel(
    "fused_mlp_cm", "fused_mlp_cm.cu",
    "fgs_nerf_tpu/ops/pallas/fused_mlp_cm.py:231 and :258",
    {
        "fused_mlp_fwd": (P, P, P, I32, P, P, P, P, I32, I32, I32, I64, P, P),
        "fused_mlp_bwd": (P, P, P, I32, P, P, P, P, P, I32, I32, I32, I64,
                          P, P, P, I64, P, I32, P, I32, P, P),
    },
)

MAX_BLOCKS = 16
MAX_LAYERS = 8
SMEM_MAX = 232448  # bytes of shared memory a block can use on an H100
# B8 (the launcher's own constants, csrc/fused_mlp_cm.cu)
FWD_TILE = 128        # samples per tile (FT)
FWD_STAGE = 16384     # bytes of a ring stage: 32 inputs of 256 outputs
FWD_STAGES_MAX = 7    # most ring stages (FST_MAX)
FWD_ALIGN = 1024      # alignment of the ring, X and H (FALIGN)
FWD_BAR = 1024        # bytes for the mbarriers (FBAR)
FWD_RAW = 16384       # bytes staging the input units: 8 warps x 2 x 1 KB (FRAW)
FWD_MAXQ = 96         # most weight chunks a tile (FMAXQ)
# B9 (the launcher's own constants, csrc/fused_mlp_cm.cu)
BWD_TILE = 128      # samples per tile of the per-tile pass (BT)
BWD_WM = 2          # warps along the samples of a per-tile block (WM)
KC, NSTAGE = 64, 3  # weight rows per staged chunk, chunks staged
NPASS = 256         # widest output of a layer
SMALL_NP = 16       # a last layer this narrow keeps its dW in registers
DW_ROWS = 64        # weight rows of a dW slice
DW_CHUNK = 64       # samples per dW chunk
DW_BLOCKS_PER_SM = 4  # dW blocks per SM: two resident, two waves

def _pad16(r: int) -> int:
    return (r + 15) // 16 * 16


def _pad64(r: int) -> int:
    return (r + 63) // 64 * 64


def bwd_plan(m: int, kp: Sequence[int], np_: Sequence[int],
             n_sm: int) -> dict:
    """B9's scratch and partials for M = ``m`` samples and padded layer
    widths ``kp`` (inputs) / ``np_`` (outputs), as the launcher plans
    them: the per-tile pass's blocks (``nblk``) and shared memory, which
    layers go through the dW kernel (``n_dwl``; a 16-output last layer
    keeps its dW in the per-tile pass), the bf16 scratch elements, the dW
    slices and sample ranges (``nr``), and the partial rows."""
    n_layers = len(kp)
    small = np_[-1] == SMALL_NP and kp[-1] <= NPASS
    n_dwl = n_layers - small
    ntiles = -(-m // BWD_TILE)
    mp = ntiles * BWD_TILE
    aw = [_pad64(k) for k in kp[:n_dwl]]
    slices = sum(a // DW_ROWS for a in aw)
    sa = max(kp[0], *np_) + 8
    smem_tile = (2 * (BWD_TILE * sa + NSTAGE * KC * (NPASS + 8)
                      + (BWD_TILE * 24 if small else 0))
                 + 4 * (BWD_TILE // 8) * (NPASS // 8) * 2 * (n_layers - 1)
                 + 4 * BWD_WM * n_layers * NPASS + 8 * kp[0])
    return dict(
        mp=mp, n_dwl=n_dwl,
        nblk=max(1, min(n_sm, ntiles)),
        scratch_elems=mp * sum(a + n for a, n in zip(aw, np_)),
        slices=slices,
        nr=max(1, min(DW_BLOCKS_PER_SM * n_sm // max(slices, 1),
                      mp // DW_CHUNK)),
        n_dw=sum(k * n for k, n in zip(kp[:n_dwl], np_)),
        n_t=(kp[-1] * np_[-1] if small else 0) + sum(np_),
        smem_tile=smem_tile,
        smem_dw=2 * 2 * DW_CHUNK * (DW_ROWS + 8 + NPASS + 8))


def dw_ranges(mp: int, nr: int):
    """The dW kernel's sample ranges [begin, end) over the ``mp`` padded
    samples: whole DW_CHUNK chunks, split as evenly as the launcher
    splits them (range r takes chunks r * n // nr .. (r + 1) * n // nr)."""
    n = mp // DW_CHUNK
    return [(r * n // nr * DW_CHUNK, (r + 1) * n // nr * DW_CHUNK)
            for r in range(nr)]


def fwd_kc(kp: int, np_: int) -> int:
    """Inputs of one B8 weight chunk of a layer: whole 16-input slabs of
    ``np_`` outputs in one ring stage, at most the layer's ``kp``."""
    return min(kp, FWD_STAGE // 2 // np_ // 16 * 16)


def fwd_plan(m: int, kp: Sequence[int], np_: Sequence[int],
             n_sm: int) -> dict:
    """B8's launch for M = ``m`` samples and padded layer widths ``kp``
    (inputs) / ``np_`` (outputs), as the launcher plans it: the tile, the
    tiles and the persistent grid (at most one block an SM), the ring's
    stages, the block's dynamic shared memory (``smem``; ``stages`` < 2
    means the net does not fit), the weight chunks a tile (``chunks``)
    and the bytes the bulk copies move from L2 a call
    (``l2_weight_bytes``: every tile stages the whole net once)."""
    hmax = max(np_[:-1], default=0)
    fixed = (FWD_ALIGN + FWD_BAR + FWD_RAW + 2 * FWD_TILE * (kp[0] + hmax)
             + 8 * kp[0])
    stages = min(FWD_STAGES_MAX, (SMEM_MAX - fixed) // FWD_STAGE)
    ntiles = -(-m // FWD_TILE)
    return dict(
        tile=FWD_TILE, ntiles=ntiles, grid=min(n_sm, ntiles), stages=stages,
        smem=fixed + stages * FWD_STAGE,
        chunks=sum(-(-k // fwd_kc(k, n)) for k, n in zip(kp, np_)),
        l2_weight_bytes=ntiles * 2 * sum(k * n for k, n in zip(kp, np_)))


def slab_layout(wt: torch.Tensor) -> torch.Tensor:
    """B8's weight layout of one layer: bf16 [np][kp] (out-major) ->
    16-input slabs [kp/16][np][16], the two 8-input halves of a row
    swapped on rows 4-7 of every 8: the K-major 32-byte swizzle layout in
    which the kernel's wgmma reads them.  (n, k) lies at ``(k // 16) * np * 16 + n * 16 + 8 * ((k // 8) % 2 ^
    (n // 4) % 2) + k % 8``."""
    np_, kp = wt.shape
    x = wt.view(np_ // 8, 2, 4, kp // 16, 2, 8)
    x = torch.stack([x[:, 0], x[:, 1].flip(-2)], dim=1)
    return x.reshape(np_, kp // 16, 2, 8).permute(1, 0, 2, 3).contiguous()


def _arr(ctype, values):
    return (ctype * len(values))(*values)


class _Operands:
    """The kernels' padded operands; keeps every tensor alive while the
    launch reads them."""

    def __init__(self, blocks, weights, biases, backward: bool):
        from fgs_nerf_tpu_torch.ops.fused_mlp_cm import pad_plan

        m = blocks[0].shape[-1]
        rows = [b.shape[0] for b in blocks]
        offs, cin8 = pad_plan(rows)
        if len(blocks) > MAX_BLOCKS or len(weights) > MAX_LAYERS:
            raise ValueError(f"fused_mlp_cm kernel: at most {MAX_BLOCKS} "
                             f"blocks and {MAX_LAYERS} layers")
        for b in blocks:
            if (not b.is_cuda or b.dtype != torch.float32
                    or not b.is_contiguous() or b.shape[-1] != m):
                raise ValueError("fused_mlp_cm kernel: blocks must be "
                                 "contiguous CUDA f32 [r_i, M]")
        self.blocks = blocks
        self.m, self.cin8, self.d_out = m, cin8, weights[-1].shape[1]
        self.kp, self.np_ = [], []
        self.wt, self.w, self.b = [], [], []
        for li, (w, bias) in enumerate(zip(weights, biases)):
            if li == 0:
                w_in = w.new_zeros((cin8, w.shape[1]))
                src = 0
                for r, o in zip(rows, offs):
                    w_in[o:o + r] = w[src:src + r]
                    src += r
            else:
                w_in = w
            kp, np_ = _pad16(w_in.shape[0]), _pad16(w_in.shape[1])
            wp = torch.nn.functional.pad(
                w_in.float(), (0, np_ - w_in.shape[1], 0, kp - w_in.shape[0]))
            self.kp.append(kp)
            self.np_.append(np_)
            self.wt.append(wp.T.contiguous().to(torch.bfloat16))
            if backward:
                self.w.append(wp.contiguous().to(torch.bfloat16))
            self.b.append(torch.nn.functional.pad(
                bias.float(), (0, np_ - bias.shape[0])).contiguous())
        widths = [tuple(w.shape) for w in weights]
        name = "fused_mlp_cm_bwd" if backward else "fused_mlp_cm_fwd"
        if max(self.np_) > NPASS:
            raise ValueError(f"{name} kernel: layer widths {widths} pad "
                             f"past {NPASS} outputs")
        if backward:
            smem = bwd_plan(m, self.kp, self.np_, 1)["smem_tile"]
        else:
            plan = fwd_plan(m, self.kp, self.np_, 1)
            smem = plan["smem"] + max(0, 2 - plan["stages"]) * FWD_STAGE
            if plan["chunks"] > FWD_MAXQ:
                raise ValueError(f"{name} kernel: {plan['chunks']} weight "
                                 f"chunks a tile for widths {widths}; at "
                                 f"most {FWD_MAXQ}")
        if smem > SMEM_MAX:
            raise ValueError(
                f"{name} kernel: needs {smem} bytes of shared memory "
                f"for widths {widths}; the card gives a block {SMEM_MAX}")
        self.ptr_blocks = _arr(ctypes.c_void_p, [b.data_ptr() for b in blocks])
        self.c_rows = _arr(ctypes.c_int, rows)
        self.c_offs = _arr(ctypes.c_int, offs)
        self.ptr_wt = _arr(ctypes.c_void_p, [t.data_ptr() for t in self.wt])
        self.ptr_w = (_arr(ctypes.c_void_p, [t.data_ptr() for t in self.w])
                      if backward else None)
        self.ptr_b = _arr(ctypes.c_void_p, [t.data_ptr() for t in self.b])
        self.c_kp = _arr(ctypes.c_int, self.kp)
        self.c_np = _arr(ctypes.c_int, self.np_)

    def head(self):
        return (ctypes.addressof(self.ptr_blocks), ctypes.addressof(self.c_rows),
                ctypes.addressof(self.c_offs), len(self.blocks))


def launch_fwd(blocks: Sequence[torch.Tensor], weights, biases) -> torch.Tensor:
    """Launch B8 -> [d_out, M] f32."""
    ops = _Operands(blocks, weights, biases, backward=False)
    dev = blocks[0].device
    slabs = [slab_layout(w) for w in ops.wt]
    ptr_slabs = _arr(ctypes.c_void_p, [t.data_ptr() for t in slabs])
    out = torch.empty((ops.d_out, ops.m), dtype=torch.float32, device=dev)
    KERNEL.call("fused_mlp_fwd", *ops.head(), ctypes.addressof(ptr_slabs),
                ctypes.addressof(ops.ptr_b), ctypes.addressof(ops.c_kp),
                ctypes.addressof(ops.c_np), len(weights), ops.cin8, ops.d_out,
                ops.m, out.data_ptr(), stream_ptr(dev))
    return out


def launch_bwd(blocks, weights, biases, g: torch.Tensor):
    """Launch B9 -> (dx_pad [Cin8, M] f32, padded transposed dW list
    [np, kp], padded db list [np]); ``ops/fused_mlp_cm.py`` unpads.  The
    scratch and both partial buffers are ``torch.empty``: the kernels
    write every element once before it is read."""
    ops = _Operands(blocks, weights, biases, backward=True)
    dev = blocks[0].device
    if (g.shape != (ops.d_out, ops.m) or g.dtype != torch.float32
            or not g.is_cuda or not g.is_contiguous()):
        raise ValueError("fused_mlp_cm_bwd: g must be contiguous CUDA f32 "
                         "[d_out, M]")
    plan = bwd_plan(ops.m, ops.kp, ops.np_,
                    torch.cuda.get_device_properties(dev).multi_processor_count)
    dx = torch.empty((ops.cin8, ops.m), dtype=torch.float32, device=dev)
    scratch = torch.empty((plan["scratch_elems"],), dtype=torch.bfloat16,
                          device=dev)
    part_t = torch.empty((plan["nblk"], plan["n_t"]), dtype=torch.float32,
                         device=dev)
    part_dw = torch.empty((plan["nr"], plan["n_dw"]), dtype=torch.float32,
                          device=dev)
    sizes: List[int] = [kp * np_ for kp, np_ in zip(ops.kp, ops.np_)]
    sizes += ops.np_
    dwb = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    KERNEL.call("fused_mlp_bwd", *ops.head(), ctypes.addressof(ops.ptr_wt),
                ctypes.addressof(ops.ptr_w), ctypes.addressof(ops.ptr_b),
                ctypes.addressof(ops.c_kp), ctypes.addressof(ops.c_np),
                len(weights), ops.cin8, ops.d_out, ops.m, g.data_ptr(),
                dx.data_ptr(), scratch.data_ptr(), plan["scratch_elems"],
                part_t.data_ptr(), plan["nblk"], part_dw.data_ptr(),
                plan["nr"], dwb.data_ptr(), stream_ptr(dev))
    del scratch, part_t, part_dw
    pieces = torch.split(dwb, sizes)
    n = len(ops.kp)
    dwts = [pieces[i].view(kp, np_).T
            for i, (kp, np_) in enumerate(zip(ops.kp, ops.np_))]
    return dx, dwts, list(pieces[n:])
