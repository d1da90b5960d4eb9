"""Kernels B8/B9 (the fused channel-major MLP) on the CPU: the port's
plain twins against the Pallas kernels in interpret mode, and the
port's autograd op against the JAX op's CPU gradients.

Tolerances: the forward twin repeats the kernel's bf16 roundings and
sums in float32, so it agrees with the interpreted kernel to 1e-5, but
for the few outputs behind a hidden value that an f32 reassociation
rounds to the neighbouring bf16 value (at most 0.5% of outputs, each
within 1e-3).  The backward twin rounds each layer's cotangent
to bf16 where the TPU kernel does; an f32 reassociation can move one of
those roundings by one bf16 ulp, so the backward agrees to relative L2
1e-3 (the B4 tolerance).  Both tolerances reject the twin with a bf16
rounding left out (``test_tolerances_reject_a_twin_without_its_roundings``:
dropping the ``dz`` rounding moves some cotangent past 2e-3).
The JAX op on the CPU differentiates the reference with f32 cotangents
instead, so the op's gradients agree with it at the 2e-2 bf16 scale of
``tests/test_fused_mlp.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.ops.pallas import fused_mlp_cm as J
from fgs_nerf_tpu_torch.ops import fused_mlp_cm as T
from fgs_nerf_tpu_torch.ops.cuda import fused_mlp_cm as K

BS = 256
SHAPES = {
    # the shapes of tests/test_fused_mlp.py
    "refnet-like": ((12, 33, 33, 3, 9), (90, 64, 64, 3)),
    # a 256-wide last layer and 8-but-not-16 multiple widths
    "rgbnet-like": ((12, 33, 21, 1, 24, 12, 3), (106, 40, 40, 24)),
}


def _setup(rng, rows, dims, m=4 * BS):
    blocks = [rng.normal(size=(r, m)).astype(np.float32) * 0.5 for r in rows]
    weights = [(rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)
               for i, o in zip(dims[:-1], dims[1:])]
    biases = [rng.normal(size=(o,)).astype(np.float32) * 0.1 for o in dims[1:]]
    return blocks, weights, biases


def _t(xs):
    return [torch.as_tensor(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _flip_share(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float((np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)).mean())


def _assert_close_but_bf16_flips(got, want):
    assert _flip_share(got, want) <= 5e-3, _flip_share(got, want)
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= 1e-3


def _outputs(bwd):
    """(dx, dWs, dbs) -> one flat list."""
    dx, dws, dbs = bwd
    return [dx, *dws, *dbs]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _pallas_fwd(name):
    """(inputs, the interpreted B8's output) on seed 0."""
    rows, dims = SHAPES[name]
    blocks, weights, biases = _setup(np.random.default_rng(0), rows, dims)
    want = J.fused_mlp_cm_fwd_pallas(tuple(_j(blocks)), _j(weights),
                                     _j(biases), tuple(rows), bs=BS,
                                     interpret=True)
    return (blocks, weights, biases), np.asarray(want)


@functools.lru_cache(maxsize=None)
def _pallas_bwd(name):
    """(inputs with g, the interpreted B9's dx, dWs and dbs) on seed 1."""
    rows, dims = SHAPES[name]
    rng = np.random.default_rng(1)
    blocks, weights, biases = _setup(rng, rows, dims)
    g = rng.normal(size=(dims[-1], blocks[0].shape[1])).astype(np.float32)
    dx_j, dws_j, dbs_j = J.fused_mlp_cm_bwd_pallas(
        tuple(_j(blocks)), _j(weights), _j(biases), jnp.asarray(g),
        tuple(rows), bs=BS, interpret=True)
    return ((blocks, weights, biases, g),
            [np.asarray(x) for x in [dx_j, *dws_j, *dbs_j]])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_twin_matches_pallas_interpret(name):
    (blocks, weights, biases), want = _pallas_fwd(name)
    got = T.fused_mlp_cm_fwd(_t(blocks), _t(weights), _t(biases))
    assert got.shape == (SHAPES[name][1][-1], blocks[0].shape[1])
    _assert_close_but_bf16_flips(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_backward_twin_matches_pallas_interpret(name):
    (blocks, weights, biases, g), want = _pallas_bwd(name)
    got = T.fused_mlp_cm_bwd(_t(blocks), _t(weights), _t(biases),
                             torch.as_tensor(g))
    for a, b in zip(_outputs(got), want):
        assert a.shape == b.shape
        assert _rel_l2(a.numpy(), b) < 1e-3


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tolerances_reject_a_twin_without_its_roundings(name):
    """The forward and backward tolerances above are tight enough to tell
    a function that leaves out one of the TPU kernel's bf16 roundings:
    hiddens kept in f32 move most outputs past 1e-5, and an unrounded
    ``dz`` moves some cotangent past 2e-3 (relative L2), twice the 1e-3
    limit."""
    (blocks, weights, biases), want = _pallas_fwd(name)
    got = T.fused_mlp_cm_fwd_plain(_t(blocks), _t(weights), _t(biases),
                                   round_hidden=False)
    assert _flip_share(got.numpy(), want) > 0.5
    (blocks, weights, biases, g), want = _pallas_bwd(name)
    for kw in (dict(round_dz=False), dict(round_hidden=False)):
        got = T.fused_mlp_cm_bwd_plain(
            _t(blocks), _t(weights), _t(biases), torch.as_tensor(g), **kw)
        worst = max(_rel_l2(a.numpy(), b) for a, b in zip(_outputs(got), want))
        assert worst > 2e-3, (kw, worst)


def test_op_gradients_match_jax_cpu_op():
    rows, dims = SHAPES["refnet-like"]
    rng = np.random.default_rng(2)
    blocks, weights, biases = _setup(rng, rows, dims, m=BS)
    ct = rng.normal(size=(dims[-1], BS)).astype(np.float32)

    def f(bl, w, b_):
        return jnp.sum(J.fused_mlp_cm(tuple(bl), w, b_, BS) * ct)

    # jitted: op by op, the JAX side compiles some 140 small programs
    want_out = jax.jit(lambda bl, w, b_: J.fused_mlp_cm(tuple(bl), w, b_, BS))(
        _j(blocks), _j(weights), _j(biases))
    g_j = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(_j(blocks), _j(weights),
                                                  _j(biases))

    tb = [t.requires_grad_(True) for t in _t(blocks)]
    tw = [t.requires_grad_(True) for t in _t(weights)]
    tbi = [t.requires_grad_(True) for t in _t(biases)]
    out = T.fused_mlp_cm(tb, tw, tbi, BS)
    _assert_close_but_bf16_flips(out.detach().numpy(), want_out)
    (out * torch.as_tensor(ct)).sum().backward()
    for got_l, want_l in zip((tb, tw, tbi), g_j):
        for got, want in zip(got_l, want_l):
            want = np.asarray(want)
            scale = max(float(np.abs(want).max()), 1e-3)
            np.testing.assert_allclose(got.grad.numpy() / scale, want / scale,
                                       rtol=2e-2, atol=2e-2)


def test_op_checks_its_preconditions():
    rows, dims = SHAPES["refnet-like"]
    blocks, weights, biases = _setup(np.random.default_rng(3), rows, dims,
                                     m=BS)
    with pytest.raises(ValueError, match="multiple of bs"):
        T.fused_mlp_cm(_t(blocks), _t(weights), _t(biases), bs=3 * BS)
    bad = [np.zeros((90, 60), np.float32)] + weights[1:]
    bad[1] = np.zeros((60, 64), np.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        T.fused_mlp_cm(_t(blocks), _t(bad), _t(biases), bs=BS)


def test_deep_net_cotangents_move_with_the_sum_order():
    """Why the card checks hold B9 on the fine head's 4-layer, 256-wide
    nets to relative L2 2.5e-3 (5e-3 on random inputs) and not B4's
    1e-3, and why they add a dx-share check: the twin itself, summed in
    float64 instead of float32 with every bf16 rounding kept, moves its
    cotangents by about 1e-3 (each one-ulp landing of a rounded cotangent
    propagates down the layers), so a kernel with a third sum order can
    sit past 1e-3 from the twin on sum order alone.  Leaving the ``dz``
    rounding out moves the worst of them past 2.5e-3 but not far, while
    it moves most samples' dx past 1e-4 of dx's RMS, where the sum order
    moves under 1% of them."""
    rng = np.random.default_rng(6)
    m = 16384
    rows, dims = (256, 51), (307, 256, 256, 256, 3)
    blocks, weights, biases = _setup(rng, rows, dims, m=m)
    g = rng.normal(size=(dims[-1], m)).astype(np.float32)
    f32 = T.fused_mlp_cm_bwd_plain(_t(blocks), _t(weights), _t(biases),
                                   torch.as_tensor(g))
    f64 = T.fused_mlp_cm_bwd_plain(
        [t.double() for t in _t(blocks)], [t.double() for t in _t(weights)],
        [t.double() for t in _t(biases)], torch.as_tensor(g).double())
    rel = _rel_l2(f32[0].numpy(), f64[0].numpy())
    assert 5e-4 < rel < 5e-3, rel
    no_dz = T.fused_mlp_cm_bwd_plain(_t(blocks), _t(weights), _t(biases),
                                     torch.as_tensor(g), round_dz=False)
    worst = max(_rel_l2(a.numpy(), b.numpy())
                for a, b in zip(_outputs(no_dz), _outputs(f32)))
    assert worst > 2.5e-3, worst

    def dx_share(dx, ref):
        return float(((dx - ref).abs() > 1e-4 * ref.pow(2).mean().sqrt())
                     .double().mean())

    assert dx_share(f64[0].float(), f32[0]) < 0.01
    assert dx_share(no_dz[0], f32[0]) > 0.5


# the fine head's nets as B9's wrapper pads them (`_Operands`): rgbnet's
# seven blocks pad to cin8 136, refnet's two to 312, every width to 16
_FINE_NETS = {
    "rgbnet": ((12, 33, 21, 1, 24, 12, 3), [144, 256, 256, 256], [256] * 4),
    "refnet": ((256, 51), [320, 256, 256, 256], [256, 256, 256, 16]),
}


@pytest.mark.parametrize("name,m,want", [
    # X 192 wide + 3 H + 4 dz (256 each); 3 + 12 slices; 528 // 15 ranges
    ("rgbnet", 1_048_576, dict(n_dwl=4, per_sample=1984, slices=15, nr=35,
                               nblk=132, n_dw=233_472, n_t=1024,
                               smem_tile=190_592)),
    # the 16-output last layer's dW stays in the per-tile pass
    ("refnet", 1_048_576, dict(n_dwl=3, per_sample=1600, slices=13, nr=40,
                               nblk=132, n_dw=212_992, n_t=256 * 16 + 784,
                               smem_tile=214_528)),
    # ragged: 65 tiles of 128, 130 chunks of 64 over 35 ranges
    ("rgbnet", 8192 + 77, dict(n_dwl=4, per_sample=1984, slices=15, nr=35,
                               nblk=65, n_dw=233_472, n_t=1024,
                               smem_tile=190_592)),
])
def test_bwd_plan(name, m, want):
    """B9's scratch and partials plan for the fine head's nets on 132 SMs,
    and the dW kernel's sample ranges: whole chunks, contiguous, covering
    the padded samples once."""
    rows, kp, np_ = _FINE_NETS[name]
    assert K._pad16(T.pad_plan(rows)[1]) == kp[0]
    plan = K.bwd_plan(m, kp, np_, 132)
    mp = -(-m // 128) * 128
    assert plan["mp"] == mp
    assert plan["scratch_elems"] == mp * want.pop("per_sample")
    assert {k: plan[k] for k in want} == want
    assert plan["smem_tile"] <= K.SMEM_MAX
    ranges = K.dw_ranges(mp, plan["nr"])
    assert ranges[0][0] == 0 and ranges[-1][1] == mp
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = {(e - b) // K.DW_CHUNK for b, e in ranges}
    assert all(b % K.DW_CHUNK == 0 for b, _ in ranges)
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


@pytest.mark.parametrize("name,m,want", [
    # 6 stages of 16 KB beside X (144 rows), H (256 rows) of 128 samples
    # and the input staging
    ("rgbnet", 1_048_576, dict(grid=132, ntiles=8192, stages=6,
                               smem=220_288, chunks=29,
                               l2_weight_bytes=8192 * 466_944)),
    # X's 320 rows leave room for 3 stages; the 256 x 16 layer is one chunk
    ("refnet", 1_048_576, dict(grid=132, ntiles=8192, stages=3,
                               smem=217_600, chunks=27,
                               l2_weight_bytes=8192 * 434_176)),
    # ragged: 65 tiles of 128, fewer than the SMs
    ("rgbnet", 8192 + 77, dict(grid=65, ntiles=65, stages=6,
                               smem=220_288, chunks=29,
                               l2_weight_bytes=65 * 466_944)),
])
def test_fwd_plan(name, m, want):
    """B8's launch for the fine head's nets on 132 SMs, as the source
    header figures it: 128-sample tiles, a persistent grid of at most one
    block an SM, the ring stages that fit beside X and H, and the weight
    bytes the bulk copies move (every tile stages the whole net once)."""
    _, kp, np_ = _FINE_NETS[name]
    plan = K.fwd_plan(m, kp, np_, 132)
    assert plan["tile"] == 128
    assert {k: plan[k] for k in want} == want
    assert plan["smem"] <= K.SMEM_MAX


def test_fwd_slab_layout():
    """B8's weight layout: element (n, k) of a layer lies where the
    kernel's ldmatrix reads it, every element once."""
    np_, kp = 48, 80
    w = torch.as_tensor(np.random.default_rng(0).normal(size=(np_, kp)),
                        dtype=torch.bfloat16)
    flat = K.slab_layout(w).reshape(-1)
    n = torch.arange(np_)[:, None]
    k = torch.arange(kp)[None, :]
    at = ((k // 16) * np_ * 16 + n * 16 + 8 * ((k // 8) % 2 ^ (n // 4) % 2)
          + k % 8)
    assert torch.equal(flat[at], w)
    assert sorted(at.reshape(-1).tolist()) == list(range(np_ * kp))


def _kernel_order_bwd(blocks, weights, biases, g, n_sm, drop_range=False):
    """B9's function summed in its kernels' order, in f32: dW of the
    dW-kernel layers over each sample range, then the ranges in order;
    db (and a 16-output last layer's dW) over each per-tile block's
    128-sample tiles, then the blocks in order; every dz rounded to bf16
    before its products.  ``drop_range`` leaves out the second range."""
    rows = [b.shape[0] for b in blocks]
    x = T.build_x(blocks)
    wts, bs = T.pad_weights_t(weights, biases, rows)
    kp = [K._pad16(x.shape[0])] + [K._pad16(w.shape[0]) for w in weights[1:]]
    np_ = [K._pad16(w.shape[1]) for w in weights]
    m = x.shape[1]
    plan = K.bwd_plan(m, kp, np_, n_sm)
    ranges = K.dw_ranges(plan["mp"], plan["nr"])
    if drop_range:
        ranges = ranges[:1] + ranges[2:]
    tiles = [(t0, t0 + K.BWD_TILE) for t0 in range(0, plan["mp"], K.BWD_TILE)]
    per_block = [tiles[b::plan["nblk"]] for b in range(plan["nblk"])]
    by_range = [[r] for r in ranges]

    def ordered(term, groups):
        total = 0.0
        for spans in groups:
            part = 0.0
            for a, b in spans:
                if a < m:
                    part = part + term(a, min(b, m))
            total = total + part
        return total

    w16 = [T.bf16_round(w) for w in wts]
    n = len(wts)
    zs, hs, h = [], [x], x
    for li in range(n):
        z = w16[li] @ h + bs[li][:, None]
        zs.append(z)
        if li < n - 1:
            h = T.bf16_round(torch.relu(z))
            hs.append(h)
    dh = torch.nn.functional.pad(g, (0, 0, 0, wts[-1].shape[0] - g.shape[0]))
    dwts, dbs = [None] * n, [None] * n
    for li in range(n - 1, -1, -1):
        dz = dh if li == n - 1 else dh * (zs[li] > 0)
        dz16 = T.bf16_round(dz)
        groups = by_range if li < plan["n_dwl"] else per_block
        dwts[li] = ordered(lambda a, b: dz16[:, a:b] @ hs[li][:, a:b].T, groups)
        dbs[li] = ordered(lambda a, b: dz[:, a:b].sum(dim=1), per_block)
        dh = w16[li].T @ dz16
    dws, dbs = T.unpad_grads(dwts, dbs, weights, rows)
    return dh, dws, dbs


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_backward_in_the_kernels_summation_order(name):
    """B9's partial sums (`bwd_plan`, `dw_ranges`; 5 SMs here, so several
    ranges and blocks at M 1,024) reassociate the twin's sums only: they
    agree with it within the card's relative L2 2.5e-3, while a dropped
    sample range does not."""
    (blocks, weights, biases, g), _ = _pallas_bwd(name)
    args = (_t(blocks), _t(weights), _t(biases), torch.as_tensor(g))
    want = _outputs(T.fused_mlp_cm_bwd_plain(*args))
    got = _outputs(_kernel_order_bwd(*args, n_sm=5))
    worst = max(_rel_l2(a.numpy(), b.numpy()) for a, b in zip(got, want))
    assert worst < 2.5e-3, worst
    dropped = _outputs(_kernel_order_bwd(*args, n_sm=5, drop_range=True))
    worst = max(_rel_l2(a.numpy(), b.numpy()) for a, b in zip(dropped, want))
    assert worst > 2.5e-3, worst
