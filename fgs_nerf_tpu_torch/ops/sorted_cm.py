"""Channel-major sorted-stream field engine (the coarse base serve).

Port of ``fgs_nerf_tpu/ops/sorted_cm.py:1-291`` and ``:507-579``: every
per-sample quantity is a 1-D ``[M]`` tensor or a ``[C, M]`` matrix in
grid-row order, the field is served from a channel-major half cell pack
``[4C, Rp]`` (kernel B1, ``ops/cuda/window_gather_cm.py``) and its
gradient is a deterministic dense accumulate (kernel B2,
``ops/cuda/scatter_combine_cm.py``) plus a 4-shift combine.  The pack
stays float32 (the JAX CPU path; its bf16 pack is a TPU-only branch,
``sorted_cm.py:169-170``).  The fine stage's multi-tap half
(``sorted_cm.py:294-504``) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from fgs_nerf_tpu_torch.ops.cuda.scatter_combine_cm import dense_accumulate_cm
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
