"""Channel-major sorted-stream field engine.

Port of ``fgs_nerf_tpu/ops/sorted_cm.py``: every per-sample quantity is
a 1-D ``[M]`` tensor or a ``[C, M]`` matrix in grid-row order, the field
is served from a channel-major half cell pack ``[4C, Rp]`` (kernel B1,
``ops/cuda/window_gather_cm.py``) and its gradient is a deterministic
dense accumulate (kernel B2, ``ops/cuda/scatter_combine_cm.py``) plus a
4-shift combine.  The fine stage's multi-tap serve (``:294-504``) rides
the same row space: kernel B5 serves every tap at ``row + delta`` from a
1-channel half pack and kernel B6 accumulates its gradient
(``ops/cuda/tap_serve_cm.py``).  Packs and accumulates stay float32
(the JAX CPU path; its bf16 pack and bf16 flushes are TPU-only
branches, ``sorted_cm.py:169-170, 256-265, 475-477``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from fgs_nerf_tpu_torch.ops.cuda.scatter_combine_cm import dense_accumulate_cm
from fgs_nerf_tpu_torch.ops.cuda.tap_serve_cm import (
    tap_dense_accumulate_cm, tap_window_serve_cm,
)
from fgs_nerf_tpu_torch.ops.cuda.window_gather_cm import window_gather_cm

PACK_BW = 512  # the JAX package's serve window; fixes the pack's padded Rp


def z_stride(z: int) -> int:
    """Lane-aligned z stride, one guaranteed zero row past the content
    (`sorted_cm.py:39-43`)."""
    return ((z + 3) + 127) // 128 * 128


def padded_rows_cm(grid_shape3) -> int:
    x, y, z = grid_shape3
    return (x + 2) * (y + 2) * z_stride(z)


def rp_for(grid_shape3) -> int:
    """Padded pack columns (`sorted_cm.py:181-183` at its bw = 512): at
    least one zero block past the sentinel row, which B1 reads."""
    r = padded_rows_cm(grid_shape3)
    return ((r + PACK_BW) // PACK_BW + 1) * PACK_BW


def rows_fracs_cm(ix, iy, iz, grid_shape3):
    """Row ids, fractional offsets and in-range mask from per-axis
    index-space coordinates (`sorted_cm.py:51-74`)."""
    x, y, z = grid_shape3
    zp = z_stride(z)
    i0x, i0y, i0z = torch.floor(ix), torch.floor(iy), torch.floor(iz)
    fx, fy, fz = ix - i0x, iy - i0y, iz - i0z
    ok = ((i0x >= -1.0) & (i0x < x) & (i0y >= -1.0) & (i0y < y)
          & (i0z >= -1.0) & (i0z < z))
    bx = torch.clamp(i0x, -1.0, x - 1.0) + 1.0
    by = torch.clamp(i0y, -1.0, y - 1.0) + 1.0
    bz = torch.clamp(i0z, -1.0, z - 1.0) + 1.0
    rows = ((bx * (y + 2) + by) * zp + bz).to(torch.int32)
    return rows, (fx, fy, fz), ok


def rows_to_coords_cm(rows: torch.Tensor, grid_shape3):
    """Inverse linearization -> padded base coords (3 x [M] f32)
    (`sorted_cm.py:77-87`)."""
    x, y, z = grid_shape3
    zp = z_stride(z)
    b2 = rows % zp
    r = rows // zp
    b1 = r % (y + 2)
    b0 = r // (y + 2)
    return b0.float(), b1.float(), b2.float()


def quantize16(a: torch.Tensor) -> torch.Tensor:
    """The 16-bit fixed point of ``pack16_pair`` / ``unpack16_pair``
    (`sorted_cm.py:90-109`): ``round(a * 65535) * (1 / 65535)`` with
    round-half-even.  Inputs lie in [0, 1] here, so the u32 packing of
    the JAX package is the identity on these values and is not needed:
    torch sorts the payloads through the permutation instead."""
    return torch.round(a * 65535.0) * (1.0 / 65535.0)


def sort_stream(keys, fx, fy, fz, vdx, vdy, vdz, pack16: bool = True):
    """The main stream sort: stable by grid row, carrying the fracs and
    viewdirs (`sorted_cm.py:112-136`).  A stable ``torch.sort`` of the
    int32 keys plus a gather of the payloads by its permutation equals
    ``lax.sort(num_keys=1)``.  Returns (keys_s, iota_s, fx_s, fy_s, fz_s,
    vx_s, vy_s, vz_s); iota_s is each sorted element's ray-major index."""
    keys_s, perm = torch.sort(keys, stable=True)
    if pack16:
        fx, fy, fz = quantize16(fx), quantize16(fy), quantize16(fz)
        vdx, vdy, vdz = (quantize16((v + 1.0) * 0.5) * 2.0 - 1.0
                         for v in (vdx, vdy, vdz))
    pay = torch.stack([fx, fy, fz, vdx, vdy, vdz], dim=0)[:, perm]
    return (keys_s, perm.to(torch.int32), *pay.unbind(0))


def corner_weights_cm(fx, fy, fz) -> torch.Tensor:
    """Trilinear corner weights [8, M], corner k = dx*4 + dy*2 + dz
    (`sorted_cm.py:139-149`)."""
    parts = []
    for dx in (0, 1):
        wx = fx if dx else 1.0 - fx
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dz in (0, 1):
                wz = fz if dz else 1.0 - fz
                parts.append(wx * wy * wz)
    return torch.stack(parts, dim=0)


def build_cell_pack_cm(field_cm: torch.Tensor, rp: int) -> torch.Tensor:
    """Channel-major half cell pack [4C, rp] f32: column b holds the 4
    (dx, dy) corners of padded base b at z-offset 0, group k2 = dx*2 + dy
    at rows [k2*C, (k2+1)*C); out-of-grid corners and the tail are zero
    (`sorted_cm.py:152-178`)."""
    c, x, y, z = field_cm.shape
    zp = z_stride(z)
    gp = F.pad(field_cm, (1, zp - z - 1, 1, 2, 1, 2))
    parts = [gp[:, dx:dx + x + 2, dy:dy + y + 2, :zp]
             for dx in (0, 1) for dy in (0, 1)]
    pack = torch.cat(parts, dim=0).reshape(4 * c, -1)
    return F.pad(pack, (0, rp - pack.shape[1]))


class _PackGatherSortedCM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, field_cm, keys_sorted, w8_sorted):
        grid3 = tuple(field_cm.shape[1:])
        pack = build_cell_pack_cm(field_cm, rp_for(grid3))
        ctx.grid_shape = tuple(field_cm.shape)
        ctx.save_for_backward(keys_sorted, w8_sorted)
        return window_gather_cm(pack, keys_sorted.contiguous(),
                                w8_sorted.contiguous())

    @staticmethod
    def backward(ctx, g):
        keys_sorted, w8_sorted = ctx.saved_tensors
        c, x, y, z = ctx.grid_shape
        zp = z_stride(z)
        r = padded_rows_cm((x, y, z))
        # sentinels clamp to r - 2 so their (zero) dz pair stays inside
        # the r-row space (`sorted_cm.py:244-250`)
        keys_c = torch.clamp(keys_sorted, max=r - 2)
        dense = dense_accumulate_cm(keys_c, w8_sorted, g.contiguous(), r)
        dense = dense.reshape(4, c, x + 2, y + 2, zp)
        # node v receives corner (dx, dy, dz) of base v - (dx, dy, dz):
        # the dz pair already merged in row space, 4 shifted adds remain
        dfield = torch.zeros((c, x, y, z), dtype=torch.float32,
                             device=g.device)
        for k2, (dx, dy) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
            sx, sy = 1 - dx, 1 - dy
            dfield = dfield + dense[k2, :, sx:sx + x, sy:sy + y, 1:1 + z]
        return dfield, None, None


def pack_gather_sorted_cm(field_cm: torch.Tensor, keys_sorted: torch.Tensor,
                          w8_sorted: torch.Tensor) -> torch.Tensor:
    """Trilinear serve of a row-sorted sample stream, channel-major
    (`sorted_cm.py:186-291`).

    field_cm: [C, X, Y, Z]; keys_sorted: [M] non-decreasing int32 rows
    (a sentinel >= padded_rows_cm serves zeros); w8_sorted: [8, M].
    Returns [C, M] f32.  The backward is the dense accumulate plus the
    4-shift combine; sentinel samples must carry zero cotangent, and the
    key / weight cotangents are zero (sample positions are data).
    """
    return _PackGatherSortedCM.apply(field_cm, keys_sorted, w8_sorted)


# ---------------------------------------------------------------------------
# Multi-tap serve (the fine stage's hierarchical taps)
# ---------------------------------------------------------------------------


def tap_bounds(grid_shape3) -> Tuple[int, int]:
    """(maxneg, maxpos) row-offset envelope of displacement-<=2 taps in
    the z-minor row space (`sorted_cm.py:299-304`)."""
    zp = z_stride(grid_shape3[2])
    return 3 * zp + 4, 2 * zp + 4


def tap_deltas_weights(b0, b1, b2, fx, fy, fz, displace, grid_shape3,
                       axes=("z", "y")):
    """Per-tap row offsets, (t, d, k2)-packed corner weights and the
    post-clamp displaced coordinate of each axis tap
    (`sorted_cm.py:307-376`).  Taps run (axis-, axis+) per axis, then
    displacement; x taps come from a call on the transposed grid with
    ``axes=('z',)``.  Every expression keeps the JAX order (the clamp
    before the floor, ``(i0 + 1) - b``), so the results are bit-equal.
    Returns (delta [T, M] int32, w8t [8T, M], coord [T, M])."""
    x, y, z = grid_shape3
    zp = z_stride(z)
    iy = b1 - 1.0 + fy
    iz = b2 - 1.0 + fz
    wx0, wx1 = 1.0 - fx, fx
    wy0, wy1 = 1.0 - fy, fy

    deltas, w8ts, coords = [], [], []

    def emit(delta, wa0, wa1, wb0, wb1, flerp, coord):
        deltas.append(delta.to(torch.int32))
        f0, f1 = 1.0 - flerp, flerp
        w8ts.extend([
            f0 * wa0 * wb0, f0 * wa0 * wb1, f0 * wa1 * wb0, f0 * wa1 * wb1,
            f1 * wa0 * wb0, f1 * wa0 * wb1, f1 * wa1 * wb0, f1 * wa1 * wb1,
        ])
        coords.append(coord)

    for axis in axes:
        for sign in (-1.0, 1.0):
            for d in displace:
                if axis == "z":
                    zt = torch.clamp(iz + sign * d, 0.0, z - 1.0)
                    i0 = torch.floor(zt)
                    emit((i0 + 1.0) - b2, wx0, wx1, wy0, wy1, zt - i0, zt)
                elif axis == "y":
                    yt = torch.clamp(iy + sign * d, 0.0, y - 1.0)
                    i0 = torch.floor(yt)
                    fyt = yt - i0
                    emit(((i0 + 1.0) - b1) * zp, wx0, wx1, 1.0 - fyt, fyt,
                         fz, yt)
                else:
                    raise ValueError(axis)
    return (torch.stack(deltas, dim=0), torch.stack(w8ts, dim=0),
            torch.stack(coords, dim=0))


def _tap_bw(maxneg: int, maxpos: int) -> int:
    """The JAX serve window for the envelope (`sorted_cm.py:411-415`); it
    fixes the padded pack width."""
    return max(512, ((maxneg + maxpos + 130 + 127) // 128) * 128)


def _tap_geometry(grid_shape3, maxneg: int, maxpos: int):
    """(r, margin, rp, forward sentinel) of the margined tap row space
    (`sorted_cm.py:379-386`): real row ``k`` lives at ``k + margin``, so
    ``row + delta >= 0`` for every delta of the envelope, and the pack is
    zero past ``margin + r``."""
    bw = _tap_bw(maxneg, maxpos)
    r = padded_rows_cm(grid_shape3)
    margin = ((maxneg + 127) // 128) * 128
    rp = ((margin + r + maxpos + 2 + bw - 1) // bw) * bw
    return r, margin, rp, rp - maxpos - 2


class _TapGatherSortedCM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, field3, keys_sorted, delta, w8t, maxneg, maxpos):
        grid3 = tuple(field3.shape)
        r, margin, rp, sentinel = _tap_geometry(grid3, maxneg, maxpos)
        pack = F.pad(build_cell_pack_cm(field3[None], r),
                     (margin, rp - margin - r))
        rows = torch.where(keys_sorted < r, keys_sorted + margin,
                           torch.full_like(keys_sorted, sentinel))
        ctx.geom = (grid3, maxneg, maxpos)
        ctx.save_for_backward(keys_sorted, delta, w8t)
        return tap_window_serve_cm(pack, rows.contiguous(),
                                   delta.contiguous(), w8t.contiguous())

    @staticmethod
    def backward(ctx, g):
        keys_sorted, delta, w8t = ctx.saved_tensors
        grid3, maxneg, maxpos = ctx.geom
        x, y, z = grid3
        zp = z_stride(z)
        r, margin, _, _ = _tap_geometry(grid3, maxneg, maxpos)
        cap = margin + r + maxpos + 2
        # backward sentinel: zero-cotangent deposits parked just past the
        # real rows, inside the accumulate's row space
        # (`sorted_cm.py:464-469`)
        rows = torch.where(keys_sorted < r, keys_sorted + margin,
                           torch.full_like(keys_sorted, cap - maxpos - 2))
        dense = tap_dense_accumulate_cm(rows.contiguous(), delta.contiguous(),
                                        w8t.contiguous(), g.contiguous(), cap)
        dense = dense[:, margin:margin + r].reshape(4, x + 2, y + 2, zp)
        dfield = torch.zeros((x, y, z), dtype=torch.float32, device=g.device)
        for k2, (da, db) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
            sa, sb = 1 - da, 1 - db
            dfield = dfield + dense[k2, sa:sa + x, sb:sb + y, 1:1 + z]
        return dfield, None, None, None, None, None


def tap_gather_sorted_cm(field3: torch.Tensor, keys_sorted: torch.Tensor,
                         delta: torch.Tensor, w8t: torch.Tensor,
                         maxneg: int, maxpos: int) -> torch.Tensor:
    """Multi-tap trilinear serve of a row-sorted stream over a 1-channel
    grid (`sorted_cm.py:389-504`).

    field3: [X, Y, Z] (transposed for the x-minor pass); keys_sorted: [M]
    non-decreasing rows (sentinels >= padded_rows_cm serve zeros from the
    pack's zero tail); delta: [T, M] int32 row offsets inside the
    (maxneg, maxpos) envelope; w8t: [8T, M] (t, d, k2)-packed weights.
    Returns [T, M] f32.  The grid cotangent is the multi-tap dense
    accumulate (B6) plus the 4-shift combine; delta and w8t get none
    (tap positions are data)."""
    return _TapGatherSortedCM.apply(field3, keys_sorted, delta, w8t,
                                    maxneg, maxpos)


class _UnsortChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, iota_sorted, vals):
        idx = iota_sorted.long()
        ctx.save_for_backward(idx)
        out = torch.empty_like(vals)
        out[:, idx] = vals
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, g[:, idx]


def unsort_channels(iota_sorted: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Bring sorted-domain channels [K, M] back to ray-major order
    (`sorted_cm.py:507-542`).  ``iota_sorted`` is the main sort's
    permutation; its gather is the backward (the JAX package rebuilds
    the same permutation by re-sorting the ray-major keys)."""
    return _UnsortChannels.apply(iota_sorted, vals)


class _ResortChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, iota_sorted, vals):
        idx = iota_sorted.long()
        ctx.save_for_backward(idx)
        return vals[:, idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = torch.empty_like(g)
        out[:, idx] = g
        return None, out


def resort_channels(iota_sorted: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Bring ray-major channels [K, M] into the order of a stable key
    sort, the inverse of ``unsort_channels`` (`sorted_cm.py:545-579`).
    ``iota_sorted`` is that sort's permutation; the JAX package re-sorts
    the ray-major keys, which gives the same permutation."""
    return _ResortChannels.apply(iota_sorted, vals)
