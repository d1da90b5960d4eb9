"""The fine stage's multi-tap serve (B5) and its backward (B6) against the
JAX package (CPU), plus the row-space helpers, ``resort_channels`` and
the top-k selection.

On the CPU the port runs the kernels' plain twins; the JAX package runs
its references (``tap_serve_cm.py:211``, ``:430``) behind
``tap_gather_sorted_cm``'s custom VJP.  Streams come from a numpy seed on
a small grid, with edge-heavy coordinates (the tap clamp) and sentinel
samples; the x call runs on the transposed grid with the (4, 5) envelope
of the fine forward.

Tolerances and why:
* ``tap_bounds``, ``tap_deltas_weights``, the row geometry, the resort and
  the top-k indices: bit-equal (the same float expressions in the same
  order, integer results).
* tap serve forward: 1e-6 (four-product sums; XLA may reassociate its
  ``jnp.sum`` over the 4 rows, the twin adds them in a fixed order).
* grid VJP: 1e-5 relative (the accumulate adds the same terms in the
  same serial order, then the same 4-shift combine).
* B6's twin on the edge streams of ``test_torch_streams.py``: 1e-6, as
  the twin against the reference above (both scatter tap by tap, d by d,
  serially in sample order); B5's twin on its edge streams (envelope
  ends, sentinel piles, the last pack columns): 1e-6, as the forward.
The CUDA kernels themselves are checked against these plain twins on the
card by ``tests/test_torch_kernels.py`` (B5 and B6 on the same edge
streams) and
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.ops import sorted_cm as SJ
from fgs_nerf_tpu.ops.pallas.tap_serve_cm import (
    tap_dense_accumulate_cm_reference, tap_window_serve_cm_reference,
)

from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.ops import sorted_cm as ST
from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B
from test_torch_streams import (
    B6_CASES, B6_TAPS, SERVE_CASES, b5_stream, b6_stream,
)

DISPLACE = (0.5, 1.0, 1.5, 2.0)
SHAPE = (13, 12, 14)


def T(a):
    return torch.from_numpy(np.array(a))


def _coords(seed, shape=SHAPE, m=300, edge_heavy=False, n_out=20):
    """Index-space coordinates [m, 3]; the last ``n_out`` lie outside the
    grid and become sentinel samples."""
    rng = np.random.default_rng(seed)
    size = np.asarray(shape, np.float32)
    if edge_heavy:
        idx = rng.uniform(-0.49, 0.49, size=(m, 3)).astype(np.float32)
        idx += rng.choice([0.0, 1.0], size=(m, 3)) * (size - 1.0)
        idx = np.clip(idx, 0.0, size - 1.0)
    else:
        idx = rng.uniform(0, 1, size=(m, 3)).astype(np.float32) * (size - 1.0)
    idx[m - n_out:, rng.integers(0, 3)] = -3.0
    return idx.astype(np.float32)


def _stream(idx, shape, transpose=False):
    """Sorted keys and (fx, fy, fz) of the z-minor (or, transposed,
    x-minor) linearization, numpy."""
    axes = (2, 1, 0) if transpose else (0, 1, 2)
    shp = tuple(shape[a] for a in axes)
    rows, fr, ok = SJ.rows_fracs_cm(*(jnp.asarray(idx[:, a]) for a in axes), shp)
    keys = np.asarray(jnp.where(ok, rows, SJ.padded_rows_cm(shp)))
    order = np.argsort(keys, kind="stable")
    return shp, keys[order], [np.asarray(f)[order] for f in fr]


def _taps(idx, shape, transpose):
    """delta / w8t / coord from both packages for one tap call."""
    shp, keys, (fa, fb, fc) = _stream(idx, shape, transpose)
    axes = ("z",) if transpose else ("z", "y")
    r = SJ.padded_rows_cm(shp)
    bj = SJ.rows_to_coords_cm(jnp.minimum(jnp.asarray(keys), r - 1), shp)
    bt = ST.rows_to_coords_cm(torch.clamp(T(keys), max=r - 1), shp)
    out_j = SJ.tap_deltas_weights(*bj, *map(jnp.asarray, (fa, fb, fc)),
                                  DISPLACE, shp, axes=axes)
    out_t = ST.tap_deltas_weights(*bt, *map(T, (fa, fb, fc)), DISPLACE, shp,
                                  axes=axes)
    bounds = (4, 5) if transpose else SJ.tap_bounds(shp)
    return shp, keys, out_j, out_t, bounds


@pytest.mark.parametrize("shape", [SHAPE, (9, 7, 11), (256, 256, 256)])
def test_tap_bounds_and_geometry(shape):
    mn, mp = ST.tap_bounds(shape)
    assert (mn, mp) == SJ.tap_bounds(shape)
    for bounds in ((mn, mp), (4, 5)):
        bw = SJ._tap_bw(*bounds, None)
        assert ST._tap_bw(*bounds) == bw
        assert ST._tap_geometry(shape, *bounds) == SJ._tap_geometry(
            shape, *bounds, 1024, bw)


@pytest.mark.parametrize("transpose", [False, True], ids=["zy", "x"])
@pytest.mark.parametrize("edge_heavy", [False, True], ids=["random", "edges"])
def test_tap_deltas_weights_bit_equal(edge_heavy, transpose):
    idx = _coords(1, edge_heavy=edge_heavy)
    shp, keys, out_j, out_t, (mn, mp) = _taps(idx, SHAPE, transpose)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # real samples stay inside the envelope the row space is built for
    delta = out_t[0].numpy()[:, keys < SJ.padded_rows_cm(shp)]
    assert delta.dtype == np.int32
    assert delta.min() >= -mn and delta.max() <= mp - 1


@pytest.mark.parametrize("transpose", [False, True], ids=["zy", "x"])
@pytest.mark.parametrize("edge_heavy", [False, True], ids=["random", "edges"])
def test_tap_gather_forward_and_vjp(edge_heavy, transpose):
    idx = _coords(2, edge_heavy=edge_heavy)
    rng = np.random.default_rng(3)
    grid = rng.normal(size=SHAPE).astype(np.float32)
    shp, keys, (dj, wj, _), (dt, wt, _), (mn, mp) = _taps(idx, SHAPE,
                                                          transpose)
    field = np.transpose(grid, (2, 1, 0)) if transpose else grid
    out_j, vjp = jax.vjp(
        lambda f: SJ.tap_gather_sorted_cm(f, jnp.asarray(keys), dj, wj, mn, mp),
        jnp.asarray(field))
    cot = rng.normal(size=out_j.shape).astype(np.float32)
    (df_j,) = vjp(jnp.asarray(cot))
    f_t = T(field).requires_grad_(True)
    out_t = ST.tap_gather_sorted_cm(f_t, T(keys), dt, wt, mn, mp)
    (df_t,) = torch.autograd.grad(out_t, f_t, T(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-6, atol=1e-6)
    want = np.asarray(df_j)
    assert np.abs(want).max() > 0
    err = np.linalg.norm(df_t.numpy() - want) / np.linalg.norm(want)
    assert err <= 1e-5
    np.testing.assert_allclose(df_t.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("transpose", [False, True], ids=["zy", "x"])
def test_plain_twins_match_references(transpose):
    """B5/B6 twins against the JAX references in the margined row space
    of the tap serve, sentinel samples included."""
    idx = _coords(4, edge_heavy=True, n_out=60)
    rng = np.random.default_rng(5)
    shp, keys, (dj, wj, _), _, (mn, mp) = _taps(idx, SHAPE, transpose)
    r, margin, rp, sentinel = ST._tap_geometry(shp, mn, mp)
    grid = rng.normal(size=shp).astype(np.float32)
    pack = np.asarray(jnp.pad(SJ.build_cell_pack_cm(jnp.asarray(grid)[None], r),
                              ((0, 0), (margin, rp - margin - r))))
    np.testing.assert_array_equal(
        pack, torch.nn.functional.pad(ST.build_cell_pack_cm(T(grid)[None], r),
                                      (margin, rp - margin - r)).numpy())
    rows = np.where(keys < r, keys + margin, sentinel).astype(np.int32)
    assert (keys >= r).sum() >= 40
    delta, w8t = np.asarray(dj), np.asarray(wj)
    want = np.asarray(tap_window_serve_cm_reference(
        jnp.asarray(pack), jnp.asarray(rows), dj, wj))
    got = B.tap_window_serve_cm(T(pack), T(rows), T(delta), T(w8t))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    cap = margin + r + mp + 2
    rows_b = np.where(keys < r, keys + margin, cap - mp - 2).astype(np.int32)
    g = rng.normal(size=delta.shape).astype(np.float32)
    want = np.asarray(tap_dense_accumulate_cm_reference(
        jnp.asarray(rows_b), dj, wj, jnp.asarray(g), cap))
    got = B.tap_dense_accumulate_cm(T(rows_b), T(delta), T(w8t), T(g), cap)
    assert got.shape == (4, cap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


_accumulate_reference_jit = jax.jit(tap_dense_accumulate_cm_reference,
                                    static_argnums=4)


@pytest.mark.parametrize("taps", B6_TAPS)
@pytest.mark.parametrize("case", B6_CASES)
def test_accumulate_plain_matches_reference_on_edge_streams(case, taps):
    rows, delta, w8t, g, r = b6_stream(case, taps)
    want = np.asarray(_accumulate_reference_jit(
        *map(jnp.asarray, (rows, delta, w8t, g)), r))
    got = B.tap_dense_accumulate_cm(T(rows), T(delta), T(w8t), T(g), r)
    assert got.shape == (4, r) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


_serve_reference_jit = jax.jit(tap_window_serve_cm_reference)


@pytest.mark.parametrize("taps", (3, 8, 16))
@pytest.mark.parametrize("case", SERVE_CASES)
def test_serve_plain_matches_reference_on_edge_streams(case, taps):
    pack, rows, delta, w8t, _, _ = b5_stream(case, taps)
    want = np.asarray(_serve_reference_jit(
        *map(jnp.asarray, (pack, rows, delta, w8t))))
    got = B.tap_window_serve_cm(T(pack), T(rows), T(delta), T(w8t))
    assert got.shape == delta.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_resort_channels_and_vjp():
    rng = np.random.default_rng(6)
    m = 400
    keys = rng.integers(0, 25, size=m).astype(np.int32)  # many ties
    iota_s = np.argsort(keys, kind="stable").astype(np.int32)
    vals = rng.normal(size=(3, m)).astype(np.float32)
    g = rng.normal(size=(3, m)).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda v: SJ.resort_channels(jnp.asarray(keys), jnp.asarray(iota_s),
                                     tuple(v)), jnp.asarray(vals))
    (gv_j,) = vjp(tuple(jnp.asarray(g)))
    v_t = T(vals).requires_grad_(True)
    out_t = ST.resort_channels(T(iota_s), v_t)
    (gv_t,) = torch.autograd.grad(out_t, v_t, T(g))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.stack(out_j))
    np.testing.assert_array_equal(gv_t.numpy(), np.asarray(gv_j))
    # resort undoes unsort
    back = ST.resort_channels(T(iota_s), ST.unsort_channels(T(iota_s), T(vals)))
    np.testing.assert_array_equal(back.numpy(), vals)


def test_topk_select_and_gather_slots():
    """Tie order of the top-k selection against ``lax.top_k``: masked
    slots all score -1 and equal weights repeat, so most of the order is
    decided by ties."""
    rng = np.random.default_rng(8)
    n, s, k = 16, 40, 12
    weights = rng.choice([0.0, 0.25, 0.5, 0.125], size=(n, s)).astype(np.float32)
    live = rng.uniform(size=(n, s)) < 0.5
    live[0] = False
    steps = np.tile(np.arange(s, dtype=np.float32), (n, 1))
    idx_j, sel_j = MJ._topk_select(jnp.asarray(weights), jnp.asarray(live), k)
    idx_t, sel_t = MT._topk_select(T(weights), T(live), k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    for x in (steps, weights):
        np.testing.assert_array_equal(
            MT._gather_slots(T(x), idx_t).numpy(),
            np.asarray(MJ._gather_slots(jnp.asarray(x), idx_j)))
