"""The sorted channel-major serve (B1) and its backward (B2) against the
JAX package (CPU), plus the stream sort and the un-sort.

On the CPU the port runs the kernels' plain twins; the JAX package runs
its references (``window_gather_cm.py:204``,
``scatter_combine_cm.py:261``) behind ``pack_gather_sorted_cm``'s
custom VJP.  Streams include duplicate rows, gaps, sentinel keys and a
length that is not a multiple of the JAX block (its padding path).
Tolerance: float32 trilinear sums in the same order, 1e-6; the
accumulate adds the same terms in the same order (serial scatters on
both sides), 1e-6; on the edge streams of ``test_torch_streams.py``
the accumulate twin equals the reference bit for bit (both scatter the
dz = 0 updates, then the dz = 1 updates, serially in sample order), and
the serve twin is within 1e-6 of its reference on B1's edge streams.  The
CUDA kernels themselves are checked against these plain twins on the
card by ``tests/test_torch_kernels.py``, on the same edge streams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.ops import sorted_cm as SJ
from fgs_nerf_tpu.ops.pallas.scatter_combine_cm import dense_accumulate_cm_reference
from fgs_nerf_tpu.ops.pallas.window_gather_cm import sorted_window_gather_cm_reference

from fgs_nerf_tpu_torch.ops import sorted_cm as ST
from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1
from test_torch_streams import (
    B1_CHANNELS, B2_CHANNELS, CASES, SERVE_CASES, b1_stream, b2_stream,
)


def T(a):
    return torch.from_numpy(np.array(a))


def _stream(seed, grid=(6, 7, 9), c=5, m=1500, n_sent=200):
    rng = np.random.default_rng(seed)
    r = SJ.padded_rows_cm(grid)
    x, y, z = grid
    zp = SJ.z_stride(z)
    # valid rows: padded base coords in [0, size] per axis
    b = np.stack([rng.integers(0, s + 1, size=m - n_sent) for s in grid], -1)
    rows = (b[:, 0] * (y + 2) + b[:, 1]) * zp + b[:, 2]
    rows[:40] = rows[0]  # a long run of one row
    keys = np.sort(np.concatenate([rows, np.full(n_sent, r)])).astype(np.int32)
    w8 = rng.uniform(size=(8, m)).astype(np.float32)
    field = rng.normal(size=(c, *grid)).astype(np.float32)
    g = rng.normal(size=(c, m)).astype(np.float32)
    g[:, keys == r] = 0.0  # sentinels carry zero cotangent
    return field, keys, w8, g


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_gather_forward_and_vjp(seed):
    field, keys, w8, g = _stream(seed)
    out_j, vjp = jax.vjp(
        lambda f: SJ.pack_gather_sorted_cm(f, jnp.asarray(keys), jnp.asarray(w8)),
        jnp.asarray(field))
    (df_j,) = vjp(jnp.asarray(g))
    f_t = T(field).requires_grad_(True)
    out_t = ST.pack_gather_sorted_cm(f_t, T(keys), T(w8))
    (df_t,) = torch.autograd.grad(out_t, f_t, T(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-6, atol=1e-6)
    assert not out_t.detach().numpy()[:, keys == SJ.padded_rows_cm(field.shape[1:])].any()
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j),
                               rtol=1e-6, atol=1e-6)


def test_serve_and_accumulate_plain_match_references():
    field, keys, w8, g = _stream(2)
    grid = field.shape[1:]
    rp = ST.rp_for(grid)
    assert rp == SJ._rp_for(grid, 512)
    pack_j = SJ.build_cell_pack_cm(jnp.asarray(field), rp)
    pack_t = ST.build_cell_pack_cm(T(field), rp)
    np.testing.assert_array_equal(pack_t.numpy(), np.asarray(pack_j))
    np.testing.assert_allclose(
        B1.window_gather_cm(pack_t, T(keys), T(w8)).numpy(),
        np.asarray(sorted_window_gather_cm_reference(pack_j, jnp.asarray(keys),
                                                     jnp.asarray(w8))),
        rtol=1e-6, atol=1e-6)
    r = SJ.padded_rows_cm(grid)
    kc = np.minimum(keys, r - 2)
    np.testing.assert_allclose(
        B2.dense_accumulate_cm(T(kc), T(w8), T(g), r).numpy(),
        np.asarray(dense_accumulate_cm_reference(jnp.asarray(kc), jnp.asarray(w8),
                                                 jnp.asarray(g), r)),
        rtol=1e-6, atol=1e-6)


_reference_jit = jax.jit(dense_accumulate_cm_reference, static_argnums=3)


@pytest.mark.parametrize("c", B2_CHANNELS)
@pytest.mark.parametrize("case", CASES)
def test_accumulate_plain_matches_reference_on_edge_streams(case, c):
    rows, w8, g, r = b2_stream(case, c)
    want = np.asarray(_reference_jit(
        jnp.asarray(rows), jnp.asarray(w8), jnp.asarray(g), r))
    got = B2.dense_accumulate_cm(T(rows), T(w8), T(g), r)
    assert got.shape == (4 * c, r) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


_serve_reference_jit = jax.jit(sorted_window_gather_cm_reference)


@pytest.mark.parametrize("c", B1_CHANNELS)
@pytest.mark.parametrize("case", SERVE_CASES)
def test_serve_plain_matches_reference_on_edge_streams(case, c):
    pack, rows, w8 = b1_stream(case, c)
    want = np.asarray(_serve_reference_jit(
        *map(jnp.asarray, (pack, rows, w8))))
    got = B1.window_gather_cm(T(pack), T(rows), T(w8))
    assert got.shape == (c, rows.size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pack16", [True, False])
def test_sort_stream(pack16):
    rng = np.random.default_rng(3)
    m = 3000
    keys = rng.integers(0, 50, size=m).astype(np.int32)  # many ties
    fr = [rng.uniform(size=m).astype(np.float32) for _ in range(3)]
    fr[0][:5] = [0.0, 1.0, 0.5 / 65535, 1.5 / 65535, 2.5 / 65535]  # ties of the rounding
    vd = rng.normal(size=(m, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    out_j = SJ.sort_stream(jnp.asarray(keys), jnp.arange(m, dtype=jnp.int32),
                           *map(jnp.asarray, fr), *map(jnp.asarray, vd.T),
                           pack16=pack16)
    out_t = ST.sort_stream(T(keys), *map(T, fr), *map(T, vd.T), pack16=pack16)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unsort_channels_and_vjp():
    rng = np.random.default_rng(4)
    m = 500
    keys = rng.integers(0, 30, size=m).astype(np.int32)
    iota_s = np.argsort(keys, kind="stable").astype(np.int32)
    vals = rng.normal(size=(5, m)).astype(np.float32)
    g = rng.normal(size=(5, m)).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda v: SJ.unsort_channels(jnp.asarray(iota_s), jnp.asarray(keys),
                                     tuple(v)), jnp.asarray(vals))
    (gv_j,) = vjp(tuple(jnp.asarray(g)))
    v_t = T(vals).requires_grad_(True)
    out_t = ST.unsort_channels(T(iota_s), v_t)
    (gv_t,) = torch.autograd.grad(out_t, v_t, T(g))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.stack(out_j))
    np.testing.assert_array_equal(gv_t.numpy(), np.asarray(gv_j))
