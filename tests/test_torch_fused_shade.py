"""The fused coarse shading head (B3 forward, B4 backward) against the
JAX package (CPU).

The port's plain twins run here.  B3 is compared with
``fused_shade_cm`` (its CPU value is ``fused_shade_cm_reference``), B4
with the TPU backward kernel run in Pallas interpret mode (same
arithmetic: bf16 dz before both products) and with the JAX CPU VJP
(autodiff through the reference, which rounds elsewhere).

Tolerances and why: logits share every bf16 rounding, so they agree to
f32 reassociation (1e-5) except where a reassociated hidden sum falls on
the other side of a bf16 rounding boundary: that hidden value moves one
bf16 ulp and its sample's logits by up to ~5e-3 (held: all within 1e-2,
at most 1% of them past 1e-5); the interpret-mode kernel sums blocks in
another order and a reassociated dz can round to the neighbouring bf16
value, so cotangents are held at rel L2 1e-3; against the JAX autodiff
path rel L2 2e-2 (bf16 rounding at different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.ops.pallas import fused_mlp_cm as FJ

from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FT

PE = (5, 5, 1)  # pos, ref, view: the bench configuration's banks


def T(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _case(seed, use_vd, m=2048, width=32, k0_dim=12):
    rng = np.random.default_rng(seed)
    ins = [rng.normal(size=(k0_dim, m)).astype(np.float32),
           rng.uniform(size=(3, m)).astype(np.float32),
           rng.normal(size=(3, m)).astype(np.float32),
           rng.normal(size=(3, m)).astype(np.float32),
           rng.normal(size=(3, m)).astype(np.float32) if use_vd else None]
    cin = sum(FT.shade_layout(k0_dim, *PE, use_vd))
    dims = (cin, width, width, 3)
    ws = [rng.normal(size=(i, o)).astype(np.float32) / np.sqrt(i)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(size=(o,)).astype(np.float32) * 0.1 for o in dims[1:]]
    g = rng.normal(size=(3, m)).astype(np.float32)
    return ins, ws, bs, g


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else T(a)


@pytest.mark.parametrize("use_vd", [True, False])
def test_forward_matches_jax(use_vd):
    ins, ws, bs, _ = _case(0, use_vd)
    want = FJ.fused_shade_cm(*map(_j, ins), [_j(w) for w in ws],
                             [_j(b) for b in bs], *PE)
    got = FT.fused_shade_cm(*map(_t, ins), [_t(w) for w in ws],
                            [_t(b) for b in bs], *PE)
    err = np.abs(got.detach().numpy() - np.asarray(want))
    assert err.max() < 1e-2
    assert (err > 1e-5).mean() < 0.01


@pytest.mark.parametrize("use_vd", [True, False])
def test_backward_matches_interpret_kernel_and_vjp(use_vd):
    ins, ws, bs, g = _case(1, use_vd)
    d_k, dws_k, dbs_k = FJ.fused_shade_cm_bwd_pallas(
        *map(_j, ins), [_j(w) for w in ws], [_j(b) for b in bs], _j(g), *PE,
        bs=1024, interpret=True)
    _, vjp = jax.vjp(lambda *a: FJ.fused_shade_cm(*a, *PE),
                     *map(_j, ins), [_j(w) for w in ws], [_j(b) for b in bs])
    ref = vjp(_j(g))
    d_v, dws_v, dbs_v = list(ref[:5]), ref[5], ref[6]

    leaves = [_t(a) for a in ins]
    wt = [T(w).requires_grad_(True) for w in ws]
    bt = [T(b).requires_grad_(True) for b in bs]
    for a in leaves:
        if a is not None:
            a.requires_grad_(True)
    out = FT.fused_shade_cm(*leaves, wt, bt, *PE)
    diff = [a for a in leaves if a is not None] + wt + bt
    grads = torch.autograd.grad(out, diff, T(g))
    n_in = len(diff) - 6
    got_in, got_w, got_b = grads[:n_in], grads[n_in:n_in + 3], grads[n_in + 3:]
    want_k = [d for d in d_k if d is not None][:n_in]
    want_v = [d for d in d_v if d is not None]
    for got, k, v in zip(got_in, want_k, want_v):
        assert _rel_l2(got, k) < 1e-3
        assert _rel_l2(got, v) < 2e-2
    for got, k, v in zip(list(got_w) + list(got_b), list(dws_k) + list(dbs_k),
                         list(dws_v) + list(dbs_v)):
        assert _rel_l2(got, k) < 1e-3
        assert _rel_l2(got, v) < 2e-2


def test_layout_helpers_match_jax():
    rows = FT.shade_layout(12, *PE, True)
    assert rows == FJ._shade_layout(12, *PE, True)
    assert FT.pad_plan(rows) == FJ.pad_plan(rows)
    assert sum(rows) == 90 and FT.pad_plan(rows)[1] == 128


@pytest.mark.parametrize("m", [1, 63, 64, 5000, 2_359_296])
@pytest.mark.parametrize("k0_dim,pe,use_vd,hid", [
    (12, (5, 5, 1), True, 192), (6, (5, 3, 1), True, 128),
    (6, (5, 3, 1), False, 128)])
def test_bwd_scratch_layout(m, k0_dim, pe, use_vd, hid):
    """B4's scratch holds X (rows padded to 64 values), H1, dz1 and dz0
    for M rounded up to whole 64-sample tiles."""
    cin8 = FT.pad_plan(FT.shade_layout(k0_dim, *pe, use_vd))[1]
    mp = -(-m // FT.TILE) * FT.TILE
    assert mp % 64 == 0 and m <= mp < m + 64
    xw = -(-cin8 // 64) * 64
    assert xw in (64, 128) and cin8 <= xw
    assert FT.bwd_scratch_elems(m, cin8, hid) == mp * (xw + 3 * hid)


def test_share_limit_needs_many_logits():
    """B3's card limit (at most 1% of logits past 1e-5 of the twin) is a
    share: on 192 samples of ``test_b3_b4_match_plain``'s inputs (576
    logits) the twin summed in float64 instead of float32, every bf16
    rounding kept, already puts more than 1% past 1e-5, so that test
    judges whole tiles on 80 of them."""
    rng = np.random.default_rng(6)
    m, hid = 192, 192

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32))

    ins = [t(12, m), t(3, m), t(3, m), t(3, m), t(3, m)]
    dims = (sum(FT.shade_layout(12, *PE, True)), hid, hid, 3)
    ws = [t(i, o, scale=1 / np.sqrt(i)) for i, o in zip(dims[:-1], dims[1:])]
    bs = [t(o, scale=0.1) for o in dims[1:]]
    f32 = FT.fused_shade_cm_fwd_plain(*ins, ws, bs, *PE)
    # bf16_round keeps its input's dtype: the same roundings, float64 sums
    f64 = FT.fused_shade_cm_fwd_plain(
        *[x.double() for x in ins], [w.double() for w in ws],
        [b.double() for b in bs], *PE).float()
    assert float(((f32 - f64).abs() > 1e-5).float().mean()) > 0.01
