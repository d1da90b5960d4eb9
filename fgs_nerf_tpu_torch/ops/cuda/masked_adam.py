"""Masked / per-voxel Adam of one leaf in one pass (the train step's
optimizer).

Replaces no Pallas kernel: the JAX package's masked Adam is plain
``jnp``.  The CUDA source is ``csrc/masked_adam.cu`` (design and bound in
its header: 28 B an element; a flat pass with 16-byte loads where every
operand shares one layout, shared-memory tiles where a gradient reaches
Adam channel-major against channel-last parameters or the reverse).  The
plain twin is ``optim/masked_adam.py:adam_leaf``, which CPU leaves take;
the kernel repeats its every rounding, so the two are bit-equal.

``plan`` reads the layouts from the tensors alone.  A leaf is N rows of
C channels (C its last dimension); each operand is read at a row and a
channel stride, which takes row-major tensors, channel-major ones (the
last dimension outermost, as the backward of ``permute(3, 0, 1, 2)``
hands a k0 gradient over) and strided slices of either (a padded head
weight's columns, a channel range of a field); an operand whose leading
dimensions do not collapse into one strided dimension raises.  The
outputs are dense, in the order the plain twin gives them: the
gradient's where ``skip_zero_grad`` is set (its ``torch.where`` follows
the mask), else each its own input's.  Every operand dense in one order
takes the flat pass (the tiled one, as rows of one channel, where an
operand is not 16-byte aligned); any other mix the tiled one.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from fgs_nerf_tpu_torch.ops.cuda.build import I32, I64, P, CudaKernel, stream_ptr

F32 = ctypes.c_float

KERNEL = CudaKernel(
    "masked_adam_step", "masked_adam.cu", "none (plain jnp)",
    {"masked_adam_step": (P, P, P, P, P, P, P, P, P, P, I64, I32, P, I32,
                          F32, F32, F32, F32, F32, I32, P)},
)

TILE_ELEMS = 2048  # one operand's tile (csrc/masked_adam.cu); C at most this
OPERANDS = ("p", "g", "m", "v", "plr")


class Plan(NamedTuple):
    rows: int                     # N
    channels: int                 # C
    strides: Tuple[Tuple[int, int], ...]  # (row, channel) of p g m v plr p' m' v'
    out: Tuple[bool, bool, bool]  # p', m', v' channel-major
    flat: bool                    # every operand dense in one order


def rows_channels(x: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(row stride, channel stride) of ``x`` seen as [N, C] (C its last
    dimension, N the others collapsed), or None where the leading
    dimensions do not collapse into one strided dimension."""
    shape, stride = x.shape, x.stride()
    if not shape:
        return 1, 1
    rs, need = 1, None  # need: the stride the next outer dimension must have
    for n, s in zip(reversed(shape[:-1]), reversed(stride[:-1])):
        if n == 1:
            continue
        if need is None:
            rs = s
        elif s != need:
            return None
        need = s * n
    return rs, (stride[-1] if shape[-1] > 1 else 1)


def _channel_major(rs: int, cs: int, n: int, c: int) -> bool:
    return n > 1 and c > 1 and rs < cs


def _dense(rs: int, cs: int, n: int, c: int, cmajor: bool) -> bool:
    if cmajor:
        return rs == 1 and cs == n
    return (cs == 1 or c == 1) and (rs == c or n == 1)


def plan(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
         v: torch.Tensor, plr: Optional[torch.Tensor],
         skip_zero_grad: bool) -> Plan:
    """The leaf as N rows of C channels, each operand's strides and the
    outputs' order; raises on a layout the kernel does not take."""
    c = p.shape[-1] if p.dim() else 1
    n = p.numel() // c if c else 0
    strides, given = [], []  # given: (strides, channel-major) of each operand
    for k, x in zip(OPERANDS, (p, g, m, v, plr)):
        if x is None:
            strides.append((0, 0))
            continue
        rc = rows_channels(x)
        if rc is None:
            raise ValueError(f"masked_adam_step: {k} of shape "
                             f"{tuple(x.shape)} has strides {x.stride()}: "
                             "its leading dimensions are not one strided "
                             "dimension")
        strides.append(rc)
        given.append((rc, _channel_major(*rc, n, c)))
    cm = [o for _, o in given]
    out = (cm[1],) * 3 if skip_zero_grad else (cm[0], cm[2], cm[3])
    for o in out:
        rc = (1, n) if o else (c, 1)
        strides.append(rc)
        given.append((rc, o))
    flat = all(o == cm[0] and _dense(*rc, n, c, o) for rc, o in given)
    return Plan(n, c, tuple(strides), out, flat)


def _empty(like: torch.Tensor, channel_major: bool) -> torch.Tensor:
    if not channel_major:
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)
    shape = (like.shape[-1],) + tuple(like.shape[:-1])
    return torch.empty(shape, dtype=like.dtype,
                       device=like.device).movedim(0, -1)


def masked_adam_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, lr: torch.Tensor, bias: torch.Tensor,
                     plr: Optional[torch.Tensor], skip_zero_grad: bool,
                     beta1: float, beta2: float, eps: float):
    """One leaf's (p', m', v') in one launch, on fresh tensors (the
    arguments of ``optim/masked_adam.py:adam_leaf``).  Every tensor is
    float32 on one CUDA device; ``lr`` and ``bias`` are 0-d, read by the
    kernel on the device; ``plr`` is None or shaped like ``p``."""
    ops = [p, g, m, v, lr, bias] + ([plr] if plr is not None else [])
    if (not p.is_cuda or any(x.dtype != torch.float32 or x.device != p.device
                             for x in ops)
            or any(x.shape != p.shape for x in ops[1:4] + ops[6:])
            or lr.dim() or bias.dim()):
        raise ValueError("masked_adam_step: expects float32 tensors on one "
                         "CUDA device, g, m, v and plr shaped like p, and "
                         "0-d lr and bias")
    pl = plan(p, g, m, v, plr, skip_zero_grad)
    if not pl.flat and pl.channels > TILE_ELEMS:
        raise ValueError(f"masked_adam_step: {pl.channels} channels in a "
                         f"tiled pass; at most {TILE_ELEMS}")
    outs = tuple(_empty(p, o) for o in pl.out)
    if pl.rows == 0 or pl.channels == 0:
        return outs
    strides = (ctypes.c_longlong * 16)(*[rs for rs, _ in pl.strides],
                                       *[cs for _, cs in pl.strides])
    po, mo, vo = outs
    KERNEL.call("masked_adam_step", p.data_ptr(), g.data_ptr(), m.data_ptr(),
                v.data_ptr(), plr.data_ptr() if plr is not None else None,
                po.data_ptr(), mo.data_ptr(), vo.data_ptr(), lr.data_ptr(),
                bias.data_ptr(), pl.rows, pl.channels, ctypes.addressof(strides),
                int(pl.flat), beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
                int(skip_zero_grad), stream_ptr(p.device))
    return outs
