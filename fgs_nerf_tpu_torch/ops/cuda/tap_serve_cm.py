"""Kernels B5 and B6: the fine stage's multi-tap serve and its backward.

B5 replaces ``fgs_nerf_tpu/ops/pallas/tap_serve_cm.py:158``
(``tap_window_serve_cm_pallas``), B6 replaces ``:358``
(``tap_dense_accumulate_cm_pallas``); both live in
``csrc/tap_serve_cm.cu`` (designs and bounds in its header: B5 streams,
one thread per sample serving all taps, its pack values gathered from
L1/L2; B6 sorts the deposit keys with
``torch.sort`` and sums them in row tiles on ``csrc/sorted_runs.cuh``:
a block per 1,024 output rows finds its deposits with two searches,
stages their keys and products in shared memory, each product at its
place in its row's order, and writes its rows with vector stores; long
runs through deterministic block sums; no atomics and no per-row
scratch; both bytes-bound).

The plain twins port the JAX references ``tap_serve_cm.py:211-224`` and
``:430-442``.  B5's twin sums each (tap, d) group of 4 products with
explicit sequential adds, the kernel's order, so the two are bit-equal.
B6's twin scatters tap by tap and d by d in sample order (the JAX
reference's serial order); the kernel adds each row's deposits in that
same (t, d, sample) order for runs of up to 2 x CHUNK deposits.  The
output is always float32: the JAX package's bf16 flush past 256 MiB
exists only on its TPU path.
"""
from __future__ import annotations

import torch

from fgs_nerf_tpu_torch.ops.cuda.build import I32, I64, P, CudaKernel, stream_ptr

KERNEL = CudaKernel(
    "tap_serve_cm", "tap_serve_cm.cu",
    "fgs_nerf_tpu/ops/pallas/tap_serve_cm.py:158 and :358",
    {
        "tap_window_serve_cm": (P, P, P, P, P, I64, I32, I64, P),
        "tap_dense_accumulate_cm": (P, P, P, P, P, P, I32, I64, I64, I64, P),
    },
)

CHUNK = 256  # deposits per block sum (csrc/sorted_runs.cuh)
TILE_ROWS = 1024  # output rows of a B6 tile (csrc/tap_serve_cm.cu)
STAGE_DEPOSITS = 1024  # the most deposits a B6 pass stages (the same)


def tap_window_serve_cm_plain(pack: torch.Tensor, rows: torch.Tensor,
                              delta: torch.Tensor,
                              w8t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [4, Rp] pack, [M] rows, [T, M] delta,
    [8T, M] w8t -> [T, M] f32 (`tap_serve_cm.py:211-224`)."""
    r = rows.long()
    outs = []
    for t in range(delta.shape[0]):
        rt = r + delta[t].long()
        acc = torch.zeros(rows.shape, dtype=torch.float32, device=pack.device)
        for d in (0, 1):
            v = pack[:, rt + d]
            w4 = w8t[8 * t + 4 * d:8 * t + 4 * d + 4]
            s = v[0] * w4[0]
            s = s + v[1] * w4[1]
            s = s + v[2] * w4[2]
            s = s + v[3] * w4[3]
            acc = acc + s
        outs.append(acc)
    return torch.stack(outs, dim=0)


def tap_window_serve_cm(pack: torch.Tensor, rows: torch.Tensor,
                        delta: torch.Tensor, w8t: torch.Tensor) -> torch.Tensor:
    """out[t, m] = sum_{d, k2} w8t[8t + 4d + k2, m] *
    pack[k2, rows[m] + delta[t, m] + d].

    Every ``rows + delta`` (and its ``+ 1``) must lie inside the pack.
    CPU tensors take the plain version; CUDA tensors launch B5."""
    if not pack.is_cuda:
        return tap_window_serve_cm_plain(pack, rows, delta, w8t)
    c4, rp = pack.shape
    t, m = delta.shape
    if (pack.dtype != torch.float32 or w8t.dtype != torch.float32
            or rows.dtype != torch.int32 or delta.dtype != torch.int32
            or c4 != 4 or rows.shape != (m,) or w8t.shape != (8 * t, m)
            or not all(a.is_cuda and a.is_contiguous()
                       for a in (pack, rows, delta, w8t))):
        raise ValueError("tap_window_serve_cm: expects contiguous CUDA f32 "
                         "pack [4, Rp], int32 rows [M], int32 delta [T, M], "
                         "f32 w8t [8T, M]")
    out = torch.empty((t, m), dtype=torch.float32, device=pack.device)
    KERNEL.call("tap_window_serve_cm", pack.data_ptr(), rows.data_ptr(),
                delta.data_ptr(), w8t.data_ptr(), out.data_ptr(), rp, t, m,
                stream_ptr(pack.device))
    return out


def tap_updates(rows: torch.Tensor, delta: torch.Tensor, w8t: torch.Tensor,
                g: torch.Tensor):
    """Every deposit in (t, d, sample) order: (rows [2TM] int64, updates
    ``w8t[8t + 4d + k2] * g[t]`` as [4, 2TM])."""
    t, m = g.shape
    idx = (rows.long()[None, None, :] + delta.long()[:, None, :]
           + torch.arange(2, device=g.device)[None, :, None])  # [T, 2, M]
    upd = w8t.reshape(t, 2, 4, m) * g[:, None, None, :]      # [T, 2, 4, M]
    return idx.reshape(-1), upd.permute(2, 0, 1, 3).reshape(4, 2 * t * m)


def tap_dense_accumulate_cm_plain(rows: torch.Tensor, delta: torch.Tensor,
                                  w8t: torch.Tensor, g: torch.Tensor,
                                  n_rows: int) -> torch.Tensor:
    """Plain PyTorch version -> [4, n_rows] f32: the updates scattered in
    (t, d, sample) order, the JAX reference's serial order
    (`tap_serve_cm.py:430-442`)."""
    idx, upd = tap_updates(rows, delta, w8t, g)
    dense = torch.zeros((4, n_rows), dtype=torch.float32, device=g.device)
    return dense.index_add_(1, idx, upd)


def tap_dense_accumulate_cm(rows: torch.Tensor, delta: torch.Tensor,
                            w8t: torch.Tensor, g: torch.Tensor,
                            n_rows: int) -> torch.Tensor:
    """D[k2, rows + delta_t + d] += w8t[8t + 4d + k2] * g[t] -> [4, n_rows].

    Every deposit row ``rows + delta`` must lie in [0, n_rows - 2].  CPU
    tensors take the plain version; CUDA tensors sort the T * M deposit
    keys (``torch.sort``, stable) and launch B6 on the sorted keys and
    their permutation; the result is then a view of a [4, n_rows]
    prefix of rows padded to a multiple of 4."""
    if not g.is_cuda:
        return tap_dense_accumulate_cm_plain(rows, delta, w8t, g, n_rows)
    t, m = g.shape
    if (g.dtype != torch.float32 or w8t.dtype != torch.float32
            or rows.dtype != torch.int32 or delta.dtype != torch.int32
            or rows.shape != (m,) or delta.shape != (t, m)
            or w8t.shape != (8 * t, m) or t * m >= 2**31 or n_rows < 2
            or not all(a.is_cuda and a.is_contiguous()
                       for a in (rows, delta, w8t, g))):
        raise ValueError("tap_dense_accumulate_cm: expects contiguous CUDA "
                         "int32 rows [M], int32 delta [T, M], f32 w8t "
                         "[8T, M], f32 g [T, M] with T * M < 2**31 and "
                         "n_rows >= 2")
    keys_s, perm = torch.sort((rows[None, :] + delta).reshape(-1), stable=True)
    # rows padded to a multiple of 4 floats: every 4-row group of every
    # channel is one aligned float4 store
    ld = (n_rows + 3) // 4 * 4
    out = torch.empty((4, ld), dtype=torch.float32, device=g.device)
    block_sums = torch.empty((max(1, 8 * ((t * m) // CHUNK)),),
                             dtype=torch.float32, device=g.device)
    KERNEL.call("tap_dense_accumulate_cm", keys_s.data_ptr(), perm.data_ptr(),
                w8t.data_ptr(), g.data_ptr(), block_sums.data_ptr(),
                out.data_ptr(), t, m, n_rows, ld, stream_ptr(g.device))
    return out[:, :n_rows]
