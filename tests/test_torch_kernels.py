"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA card (sm_90a) and ``nvcc``; without a card
they skip.  The file imports no JAX, but ``tests/conftest.py`` does, so
on a machine with the card and without JAX run them with
``python -m pytest --noconftest tests/test_torch_kernels.py -q``.  The
plain twins are what the CPU parity tests hold against the JAX package.

Tolerances: B1 and B5 sum in the plain version's order with IEEE
multiplies/adds, so they must match bit for bit; B2, B6 and B7 add runs
of up to 512 deposits in the CPU twin's order and match it bit for bit
there (longer runs go through block sums: reassociation, within 1e-4 of
the largest value), while on the card the twins' ``index_add_`` adds in
any order (a 500-sample run of one row reassociates to ~4e-5), 1e-4;
B1 and B5 also run on the serve edge streams of
``tests/test_torch_streams.py`` (B1's staged and direct tiles at the
stage's width, sentinel piles, ragged counts, the last pack columns; B5's
deltas at both ends of its envelope);
B2, B6 and B7 run on the edge streams of ``tests/test_torch_streams.py``
(tile boundaries, runs of 2 x CHUNK and one more, spans past the
shared-memory stage, empty tiles, the first and last rows; B6 also a
sentinel pile, at 8 and 16 taps); B3/B4 share
every bf16 rounding with their twins but sum in another order, so a
hidden value can land one bf16 ulp away (logits within 1e-2, at most
1% past 1e-5; cotangents rel L2 1e-3); so do B8/B9, with the same
tolerances (for the fine head's 4-layer nets on random inputs, at most
2% of outputs past 1e-5, see ``MLP_FLIP_SHARE``, and cotangents within
relative L2 5e-3, see ``MLP_REL_L2``: the same function summed in
float64 moves them by about 1e-3, and the tensor cores' sums land
further), B9 with at most 5% of dx entries more than 1e-4 of dx's RMS
away (``MLP_DX_SHARE``: one-ulp landings move a few samples' dx, a
rounding left out nearly all), and their dW / db must repeat bit for
bit.  The twins with a bf16 rounding left out must fail those checks.
"""
import contextlib

import numpy as np
import pytest
import torch

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models import sdf_voxel as M
from fgs_nerf_tpu_torch.ops import fused_mlp_cm as FM
from fgs_nerf_tpu_torch.ops import scatter as SC
from fgs_nerf_tpu_torch.ops import sorted_cm as ST
from fgs_nerf_tpu_torch.ops.cuda import fused_mlp_cm as B89
from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FS
from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
from fgs_nerf_tpu_torch.ops.cuda import scatter_combine_cm as B2
from fgs_nerf_tpu_torch.ops.cuda import tap_serve_cm as B56
from fgs_nerf_tpu_torch.ops.cuda import window_gather_cm as B1
from fgs_nerf_tpu_torch.train.losses import LossWeights
from fgs_nerf_tpu_torch.train.trainer import make_loss_and_grads
import test_torch_streams as STREAMS

PE = (5, 5, 1)
PE_DTU = (5, 5, 3)  # the `dtu` config's coarse head: viewbase_pe 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest "
                    "tests/test_torch_kernels.py` on the H100")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_twins():
    """Route the seven kernel call sites to their plain twins."""
    saved = (ST.window_gather_cm, ST.dense_accumulate_cm,
             ST.tap_window_serve_cm, ST.tap_dense_accumulate_cm,
             FS.fused_shade_cm_fwd, FS.fused_shade_cm_bwd,
             SC.dense_accumulate)
    SC.dense_accumulate = B7.dense_accumulate_plain
    ST.window_gather_cm = B1.window_gather_cm_plain
    ST.dense_accumulate_cm = B2.dense_accumulate_cm_plain
    ST.tap_window_serve_cm = B56.tap_window_serve_cm_plain
    ST.tap_dense_accumulate_cm = B56.tap_dense_accumulate_cm_plain
    FS.fused_shade_cm_fwd = FS.fused_shade_cm_fwd_plain
    FS.fused_shade_cm_bwd = FS.fused_shade_cm_bwd_plain
    try:
        yield
    finally:
        (ST.window_gather_cm, ST.dense_accumulate_cm,
         ST.tap_window_serve_cm, ST.tap_dense_accumulate_cm,
         FS.fused_shade_cm_fwd, FS.fused_shade_cm_bwd,
         SC.dense_accumulate) = saved


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _check_b2(cuda, rows, w8, g, r):
    """B2 on a stream against its CPU twin (runs of up to 2 x CHUNK on
    both halves of a row bit for bit, the rest within 1e-4 of the largest
    value) and its card twin (``index_add_``: 1e-4), and on a repeat."""
    keys, w8c, gc = (torch.from_numpy(a).to(cuda) for a in (rows, w8, g))
    n0 = B2.KERNEL.launches["dense_accumulate_cm"]
    got = B2.dense_accumulate_cm(keys, w8c, gc, r)
    torch.cuda.synchronize()
    assert B2.KERNEL.launches["dense_accumulate_cm"] == n0 + 1
    assert got.shape == (4 * g.shape[0], r) and got.dtype == torch.float32
    cpu = B2.dense_accumulate_cm_plain(*(torch.from_numpy(a)
                                         for a in (rows, w8, g)), r)
    short = torch.from_numpy(STREAMS.b2_short_rows(rows, r))
    assert torch.equal(got.cpu()[:, short], cpu[:, short])
    scale = float(cpu.abs().max())
    assert float((got.cpu() - cpu).abs().max()) <= 1e-4 * scale
    want = B2.dense_accumulate_cm_plain(keys, w8c, gc, r)
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(got, B2.dense_accumulate_cm(keys, w8c, gc, r))


def _sentinel_stream(c):
    """Rows of a 20 x 21 x 22 grid with a 500-sample run and 3,000
    sentinel keys, as the sorted engine deposits them."""
    rng = np.random.default_rng(5)
    grid, m, n_sent = (20, 21, 22), 40000, 3000
    r = ST.padded_rows_cm(grid)
    zp = ST.z_stride(grid[2])
    b = np.stack([rng.integers(0, s + 1, size=m - n_sent) for s in grid], -1)
    rows = (b[:, 0] * (grid[1] + 2) + b[:, 1]) * zp + b[:, 2]
    rows[:500] = rows[0]
    keys = np.sort(np.concatenate([rows, np.full(n_sent, r)])).astype(np.int32)
    w8 = rng.uniform(size=(8, m)).astype(np.float32)
    g = rng.normal(size=(c, m)).astype(np.float32)
    field = rng.normal(size=(c, *grid)).astype(np.float32)
    return grid, keys, w8, g, field, r


@pytest.mark.parametrize("c", STREAMS.B2_CHANNELS)
@pytest.mark.parametrize("case", ["sentinels", *STREAMS.CASES])
def test_b1_b2_match_plain(cuda, case, c):
    if case != "sentinels":
        _check_b2(cuda, *STREAMS.b2_stream(case, c))
        return
    grid, keys, w8, g, field, r = _sentinel_stream(c)
    keys_d, w8_d = torch.from_numpy(keys).to(cuda), torch.from_numpy(w8).to(cuda)
    pack = ST.build_cell_pack_cm(torch.from_numpy(field).to(cuda),
                                 ST.rp_for(grid))
    n0 = B1.KERNEL.launches["window_gather_cm"]
    got = B1.window_gather_cm(pack, keys_d, w8_d)
    torch.cuda.synchronize()
    assert B1.KERNEL.launches["window_gather_cm"] == n0 + 1
    assert torch.equal(got, B1.window_gather_cm_plain(pack, keys_d, w8_d))
    # sentinels clamp to r - 2: a 3,000-sample run through block sums
    _check_b2(cuda, np.minimum(keys, r - 2), w8, g, r)


@pytest.mark.parametrize("c", STREAMS.B1_CHANNELS)
@pytest.mark.parametrize("case", STREAMS.SERVE_CASES)
def test_b1_match_plain(cuda, case, c):
    """B1 on its edge streams (staged and direct tiles, stage-width edges,
    a sentinel pile, a ragged count, rows at Rp - 2): bit-equal to its twin
    on the card and on the CPU copy, one launch."""
    cpu = [torch.from_numpy(a) for a in STREAMS.b1_stream(case, c)]
    pack, rows, w8 = (a.to(cuda) for a in cpu)
    n0 = B1.KERNEL.launches["window_gather_cm"]
    got = B1.window_gather_cm(pack, rows, w8)
    torch.cuda.synchronize()
    assert B1.KERNEL.launches["window_gather_cm"] == n0 + 1
    assert torch.equal(got, B1.window_gather_cm_plain(pack, rows, w8))
    assert torch.equal(got.cpu(), B1.window_gather_cm_plain(*cpu))


@pytest.mark.parametrize("taps", (3, 8, 16))
@pytest.mark.parametrize("case", STREAMS.SERVE_CASES)
def test_b5_match_plain(cuda, case, taps):
    """B5 on its edge streams (deltas at both ends of the envelope, y taps
    of whole z strides, a sentinel pile, a ragged count, columns at
    Rp - 2): bit-equal to its twin on the card and on the CPU copy, one
    launch."""
    cpu = [torch.from_numpy(a) for a in STREAMS.b5_stream(case, taps)[:4]]
    pack, rows, delta, w8t = (a.to(cuda) for a in cpu)
    n0 = B56.KERNEL.launches["tap_window_serve_cm"]
    got = B56.tap_window_serve_cm(pack, rows, delta, w8t)
    torch.cuda.synchronize()
    assert B56.KERNEL.launches["tap_window_serve_cm"] == n0 + 1
    assert torch.equal(got, B56.tap_window_serve_cm_plain(pack, rows, delta, w8t))
    assert torch.equal(got.cpu(), B56.tap_window_serve_cm_plain(*cpu))


def _shade_operands(cuda, k0_dim, pe, use_vd, hid, m):
    rng = np.random.default_rng(6)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).to(cuda)

    ins = [t(k0_dim, m), t(3, m), t(3, m), t(3, m), t(3, m) if use_vd else None]
    rows = FS.shade_layout(k0_dim, *pe, use_vd)
    dims = (sum(rows), hid, hid, 3)
    ws = [t(i, o, scale=1 / np.sqrt(i)) for i, o in zip(dims[:-1], dims[1:])]
    bs = [t(o, scale=0.1) for o in dims[1:]]
    return ins, ws, bs, t(3, m), FS.pad_plan(rows)[1]


def _check_b3_b4(ins, ws, bs, g, pe):
    """B3 within 1e-2 of its twin with at most 1% of the logits past
    1e-5, B4 within relative L2 1e-3, dW bit-equal on a repeat; each
    call raises its launch count."""
    n_fwd = FS.KERNEL.launches["fused_shade_fwd"]
    n_bwd = FS.KERNEL.launches["fused_shade_bwd"]
    got = FS.fused_shade_cm_fwd(*ins, ws, bs, *pe)
    assert FS.KERNEL.launches["fused_shade_fwd"] == n_fwd + 1
    err = (got - FS.fused_shade_cm_fwd_plain(*ins, ws, bs, *pe)).abs()
    assert float(err.max()) < 1e-2
    assert float((err > 1e-5).float().mean()) < 0.01
    d_k, dws_k, dbs_k = FS.fused_shade_cm_bwd(*ins, ws, bs, g, *pe)
    assert FS.KERNEL.launches["fused_shade_bwd"] == n_bwd + 1
    d_p, dws_p, dbs_p = FS.fused_shade_cm_bwd_plain(*ins, ws, bs, g, *pe)
    for a, b in zip(list(d_k) + dws_k + dbs_k, list(d_p) + dws_p + dbs_p):
        if b is None:
            assert a is None
            continue
        assert _rel_l2(a, b) < 1e-3
    d_again = FS.fused_shade_cm_bwd(*ins, ws, bs, g, *pe)
    assert all(torch.equal(a, b) for a, b in zip(dws_k, d_again[1]))


@pytest.mark.parametrize("m", [5000, 80 * FS.TILE, 37])
@pytest.mark.parametrize("hid", FS.KERNEL_HIDDENS)
@pytest.mark.parametrize("use_vd", [True, False])
def test_b3_b4_match_plain(cuda, use_vd, hid, m):
    """The coarse bench layout (k0 12, pe 5/5/1, viewdir on: cin8 128) and
    one without viewdir, at M off a multiple of the sample tile, one
    whole number of tiles, and less than one tile."""
    ins, ws, bs, g, cin8 = _shade_operands(cuda, 12, PE, use_vd, hid, m)
    assert cin8 == (128 if use_vd else 104)
    _check_b3_b4(ins, ws, bs, g, PE)


@pytest.mark.parametrize("m", [5000, 80 * FS.TILE, 37])
@pytest.mark.parametrize("hid", FS.KERNEL_HIDDENS)
def test_b3_b4_match_plain_at_cin8_144(cuda, hid, m):
    """The DTU coarse layout (k0 12, pe 5/5/3, viewdir on: cin8 144, the
    kernels' widest), held as the bench layout is."""
    ins, ws, bs, g, cin8 = _shade_operands(cuda, 12, PE_DTU, True, hid, m)
    assert cin8 == FS.MAX_CIN8 == 144
    _check_b3_b4(ins, ws, bs, g, PE_DTU)


def test_b3_b4_raise_past_cin8_144(cuda):
    """cin8 152 (k0 20 at the DTU encodings) has no kernel: both wrappers
    raise on CUDA tensors, launch nothing and take no plain path."""
    ins, ws, bs, g, cin8 = _shade_operands(cuda, 20, PE_DTU, True, 192, 256)
    assert cin8 == 152
    before = dict(FS.KERNEL.launches)
    with pytest.raises(ValueError, match="padded inputs"):
        FS.fused_shade_cm_fwd(*ins, ws, bs, *PE_DTU)
    with pytest.raises(ValueError, match="padded inputs"):
        FS.fused_shade_cm_bwd(*ins, ws, bs, g, *PE_DTU)
    assert FS.KERNEL.launches == before


def test_coarse_step_kernels_match_plain(cuda):
    """A small coarse step (20^3 grid, 256 rays, refnet width 192)
    through the four kernels and through their plain twins."""
    kw = dict(stage="coarse", xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
              num_voxels=20**3, num_voxels_base=20**3, stepsize=0.5,
              k0_dim=12, refnet_width=192, refnet_depth=3, posbase_pe=5,
              viewbase_pe=1, refbase_pe=5, smooth_ksize=5, smooth_sigma=0.8,
              s_start=0.2, sample_k=32, shade_remat=False, engine="sorted")
    cfg = M.make_model_config(**kw)
    params = M.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    params["k0"] = torch.randn(params["k0"].shape, generator=gen,
                               device=cuda) * 0.3
    n = 256
    rays_o = torch.tensor([0.0, 0.1, 2.6], device=cuda).expand(n, 3).contiguous()
    look = torch.randn((n, 3), generator=gen, device=cuda) * 0.4
    rays_d = look - rays_o
    viewdirs = rays_d / rays_d.norm(dim=-1, keepdim=True)
    target = torch.rand((n, 3), generator=gen, device=cuda)
    box = SceneBox.create([-1, -1, -1], [1, 1, 1], cuda)
    fn = make_loss_and_grads(
        cfg, box, LossWeights(weight_main=1.0, weight_rgbper=0.2,
                              weight_entropy_last=1e-3,
                              weight_orientation=1e-4, sigmoid_rgb_loss=0.1,
                              weight_tv_density=0.01, ori_tv=True),
        near=0.2, bg=1.0, sdf_tv=0.1, smooth_grad_tv=0.05,
        use_nonempty_mask=False)
    args = (params, {}, rays_o, rays_d, viewdirs, target,
            torch.tensor(0.2, device=cuda), 1.0)
    before = {k: dict(v.KERNEL.launches) for k, v in
              (("b1", B1), ("b2", B2), ("fs", FS))}
    _, lk, gk = fn(*args)
    torch.cuda.synchronize()
    assert B1.KERNEL.launches["window_gather_cm"] > before["b1"]["window_gather_cm"]
    assert B2.KERNEL.launches["dense_accumulate_cm"] > before["b2"]["dense_accumulate_cm"]
    assert FS.KERNEL.launches["fused_shade_fwd"] > before["fs"]["fused_shade_fwd"]
    assert FS.KERNEL.launches["fused_shade_bwd"] > before["fs"]["fused_shade_bwd"]
    with plain_twins():
        _, lp, gp = fn(*args)
    assert torch.isfinite(lk["loss"])
    torch.testing.assert_close(lk["loss"], lp["loss"], rtol=1e-4, atol=0)
    for name in ("sdf", "k0"):
        assert _rel_l2(gk[name], gp[name]) < 1e-3
    for name in gk["refnet"]:
        assert _rel_l2(gk["refnet"][name], gp["refnet"][name]) < 1e-3


def _tap_stream(rng, m, t, rp, n_long):
    """Sorted rows with a long run of one row (the sentinels of masked
    traffic) and tap offsets that keep every read inside [0, rp)."""
    rows = np.sort(rng.integers(40, rp - 60, size=m)).astype(np.int32)
    rows[m - n_long:] = rp - 40
    delta = rng.integers(-30, 20, size=(t, m)).astype(np.int32)
    delta[:, m - n_long:] = rng.integers(-2, 1, size=(t, n_long))
    w8t = rng.uniform(size=(8 * t, m)).astype(np.float32)
    g = rng.normal(size=(t, m)).astype(np.float32)
    pack = rng.normal(size=(4, rp)).astype(np.float32)
    return [torch.from_numpy(a) for a in (pack, rows, delta, w8t, g)]


def test_b5_b6_match_plain(cuda):
    rng = np.random.default_rng(7)
    t, rp = 16, 60000
    cpu = _tap_stream(rng, 40000, t, rp, 3000)
    pack, rows, delta, w8t, g = (a.to(cuda) for a in cpu)

    n0 = dict(B56.KERNEL.launches)
    got = B56.tap_window_serve_cm(pack, rows, delta, w8t)
    torch.cuda.synchronize()
    assert B56.KERNEL.launches["tap_window_serve_cm"] == n0["tap_window_serve_cm"] + 1
    assert torch.equal(got, B56.tap_window_serve_cm_plain(pack, rows, delta, w8t))
    assert torch.equal(got.cpu(), B56.tap_window_serve_cm_plain(*cpu[:4]))

    # the ~16,000-deposit sentinel runs go through block sums
    keys = (cpu[1][None, :] + cpu[2]).reshape(-1).numpy()
    assert (np.bincount(keys, minlength=rp + 1) > 2 * B56.CHUNK).any()
    _check_b6(cuda, *cpu[1:], rp)


def _check_b6(cuda, rows, delta, w8t, g, r):
    """B6 on CPU tensors against its CPU twin (rows whose d = 0 and d = 1
    halves hold at most 2 x CHUNK deposits each bit for bit, the rest
    within 1e-4 of the largest value: long runs reassociate to ~2e-5) and
    its card twin (``index_add_``: 1e-4), and on a repeat."""
    dev = [a.to(cuda) for a in (rows, delta, w8t, g)]
    n0 = B56.KERNEL.launches["tap_dense_accumulate_cm"]
    got = B56.tap_dense_accumulate_cm(*dev, r)
    torch.cuda.synchronize()
    assert B56.KERNEL.launches["tap_dense_accumulate_cm"] == n0 + 1
    assert got.shape == (4, r) and got.dtype == torch.float32
    want_cpu = B56.tap_dense_accumulate_cm_plain(rows, delta, w8t, g, r)
    keys = STREAMS.b6_keys(rows.numpy(), delta.numpy())
    short = torch.from_numpy(STREAMS.b2_short_rows(keys, r))
    assert torch.equal(got.cpu()[:, short], want_cpu[:, short])
    scale = float(want_cpu.abs().max())
    assert float((got.cpu() - want_cpu).abs().max()) <= 1e-4 * scale
    want = B56.tap_dense_accumulate_cm_plain(*dev, r)
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(got, B56.tap_dense_accumulate_cm(*dev, r))


@pytest.mark.parametrize("taps", STREAMS.B6_TAPS)
@pytest.mark.parametrize("case", STREAMS.B6_CASES)
def test_b6_matches_plain(cuda, case, taps):
    rows, delta, w8t, g, r = STREAMS.b6_stream(case, taps)
    _check_b6(cuda, *(torch.from_numpy(a) for a in (rows, delta, w8t, g)), r)


def test_fine_step_kernels_match_plain(cuda):
    """A small fine step (20^3 grid, 256 rays, widths 64) through B1, B2,
    B5 and B6 and through their plain twins."""
    d = (0.5, 1.0, 1.5, 2.0)
    cfg = M.make_model_config(
        stage="fine", xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
        num_voxels=20**3, num_voxels_base=20**3, stepsize=0.5, k0_dim=12,
        rgbnet_width=64, rgbnet_depth=3, refnet_width=64, refnet_depth=3,
        posbase_pe=5, viewbase_pe=3, refbase_pe=8, grad_feat=d, sdf_feat=d,
        s_start=0.2, sample_k=48, shade_k=24, shade_remat=False,
        engine="sorted")
    params = M.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    params["k0"] = torch.randn(params["k0"].shape, generator=gen,
                               device=cuda) * 0.3
    n = 256
    rays_o = torch.tensor([0.0, 0.1, 2.6], device=cuda).expand(n, 3).contiguous()
    look = torch.randn((n, 3), generator=gen, device=cuda) * 0.4
    rays_d = look - rays_o
    viewdirs = rays_d / rays_d.norm(dim=-1, keepdim=True)
    target = torch.rand((n, 3), generator=gen, device=cuda)
    box = SceneBox.create([-1, -1, -1], [1, 1, 1], cuda)
    fn = make_loss_and_grads(
        cfg, box, LossWeights(weight_main=1.0, weight_entropy_last=1e-3,
                              weight_orientation=1e-4, sigmoid_rgb_loss=0.02,
                              weight_tv_density=0.01),
        near=0.2, bg=1.0, sdf_tv=0.1, smooth_grad_tv=0.05,
        use_nonempty_mask=False)
    args = (params, {}, rays_o, rays_d, viewdirs, target,
            torch.tensor(0.2, device=cuda), 1.0)
    kernels = {"b1": (B1.KERNEL, "window_gather_cm"),
               "b2": (B2.KERNEL, "dense_accumulate_cm"),
               "b5": (B56.KERNEL, "tap_window_serve_cm"),
               "b6": (B56.KERNEL, "tap_dense_accumulate_cm")}
    before = {k: kern.launches[fn_] for k, (kern, fn_) in kernels.items()}
    _, lk, gk = fn(*args)
    torch.cuda.synchronize()
    for k, (kern, fn_) in kernels.items():
        assert kern.launches[fn_] == before[k] + 2, k
    with plain_twins():
        _, lp, gp = fn(*args)
    assert torch.isfinite(lk["loss"])
    torch.testing.assert_close(lk["loss"], lp["loss"], rtol=1e-4, atol=0)
    for name in ("sdf", "k0"):
        assert _rel_l2(gk[name], gp[name]) < 1e-3
    for net in ("rgbnet", "refnet"):
        for name in gk[net]:
            assert _rel_l2(gk[net][name], gp[net][name]) < 1e-3


def _mixed_stream(c):
    """Sorted rows with gaps, duplicates, a ~600-sample run, a
    3,000-sample run and the last row of the space."""
    rng = np.random.default_rng(c)
    cap, m = 50000, 30000
    rows = np.sort(rng.integers(0, cap, size=m))
    rows[:600] = rows[600]                   # a run of ~600: block sums
    rows[10000:13000] = rows[10000]          # a 3,000-sample run
    rows[-5:] = cap - 1
    rows = np.sort(rows).astype(np.int32)
    return rows, rng.normal(size=(m, c)).astype(np.float32), cap


@pytest.mark.parametrize("c", STREAMS.B7_CHANNELS)
@pytest.mark.parametrize("case", ["mixed", *STREAMS.CASES])
def test_b7_matches_plain(cuda, case, c):
    """B7 against its CPU twin (runs of up to 2 x CHUNK bit for bit, the
    rest within 1e-4 of the largest value), its card twin and a repeat."""
    rows, upd, cap = (_mixed_stream(c) if case == "mixed"
                      else STREAMS.b7_stream(case, c))
    cpu = (torch.from_numpy(rows), torch.from_numpy(upd))
    r, u = (a.to(cuda) for a in cpu)
    n0 = B7.KERNEL.launches["dense_accumulate"]
    got = B7.dense_accumulate(r, u, cap)
    torch.cuda.synchronize()
    assert B7.KERNEL.launches["dense_accumulate"] == n0 + 1
    assert got.shape == (cap, c) and got.dtype == torch.float32
    want_cpu = B7.dense_accumulate_plain(*cpu, cap)
    short = torch.from_numpy(STREAMS.b7_short_rows(rows, cap))
    if case == "mixed":
        assert (~short).sum() == 2 and bool((want_cpu == 0).all(1).any())
    assert torch.equal(got.cpu()[short], want_cpu[short])
    scale = float(want_cpu.abs().max())
    assert float((got.cpu() - want_cpu).abs().max()) <= 1e-4 * scale
    want = B7.dense_accumulate_plain(r, u, cap)
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(got, B7.dense_accumulate(r, u, cap))


def test_b7_at_dvgo_shapes(cuda):
    """B7 on the three calls of one DVGO step at the built-in dvgo_model's
    widths (100^3 grid, 8,192 rays, sample_k 256: M = 2,097,152 over a
    102^3 padded row space): the density (8 columns), k0 and gradient
    field (24 columns each) against the card twin and a repeat."""
    from fgs_nerf_tpu_torch.models import density_voxel as D

    cfg = D.make_density_config([-1, -1, -1], [1, 1, 1], 100**3, 100**3,
                                0.5, alpha_init=1e-6, fast_color_thres=1e-7,
                                sample_k=256)
    params = D.init_params(cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    params["density"] = params["density"] + 2.0 * torch.randn(
        params["density"].shape, generator=gen, device=cuda)
    params["k0"] = torch.randn(params["k0"].shape, generator=gen, device=cuda)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    n = 8192
    rays_o = torch.tensor([0.0, 0.0, 3.5], device=cuda).expand(n, 3)
    rays_d = torch.randn((n, 3), generator=gen, device=cuda) * 0.4 - rays_o
    target = torch.rand((n, 3), generator=gen, device=cuda)
    box = SceneBox.create([-1, -1, -1], [1, 1, 1], cuda)
    calls = []
    site = SC.dense_accumulate

    def rec(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return site(*args)

    SC.dense_accumulate = rec
    try:
        out = D.forward(params, {}, cfg, box, rays_o.contiguous(), rays_d,
                        None, near=0.2, bg=1.0)
        loss = (torch.mean((out["rgb_marched"] - target) ** 2)
                + torch.mean(out["normal_marched"] ** 2))
        torch.autograd.grad(loss, [params["density"], params["k0"]])
    finally:
        SC.dense_accumulate = site
    assert sorted(c[1].shape[1] for c in calls) == [8, 24, 24]
    for rows, upd, cap in calls:
        assert rows.numel() == n * 256 and cap == 102**3
        n0 = B7.KERNEL.launches["dense_accumulate"]
        got = B7.dense_accumulate(rows, upd, cap)
        torch.cuda.synchronize()
        assert B7.KERNEL.launches["dense_accumulate"] == n0 + 1
        want = B7.dense_accumulate_plain(rows, upd, cap)
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-4 * scale
        assert torch.equal(got, B7.dense_accumulate(rows, upd, cap))


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_lattice_step_kernels_match_plain(cuda, stage):
    """A small lattice step (20^3 grid, 256 rays) through B7 and through
    its plain twin: one B7 call per coarse step, three per fine step."""
    d = (0.5, 1.0, 1.5, 2.0)
    extra = (dict(k0_dim=12, refnet_width=64, refnet_depth=3,
                  smooth_ksize=5, smooth_sigma=0.8, shade_k=24)
             if stage == "coarse" else
             dict(k0_dim=12, rgbnet_width=64, rgbnet_depth=3, refnet_width=64,
                  refnet_depth=3, grad_feat=d, sdf_feat=d, shade_k=24))
    cfg = M.make_model_config(
        stage=stage, xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
        num_voxels=20**3, num_voxels_base=20**3, stepsize=0.5, posbase_pe=5,
        viewbase_pe=1, refbase_pe=5, s_start=0.2, sample_k=48,
        shade_remat=False, engine="lattice", **extra)
    params = M.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    params["k0"] = torch.randn(params["k0"].shape, generator=gen,
                               device=cuda) * 0.3
    n = 256
    rays_o = torch.tensor([0.0, 0.1, 2.6], device=cuda).expand(n, 3).contiguous()
    look = torch.randn((n, 3), generator=gen, device=cuda) * 0.4
    rays_d = look - rays_o
    viewdirs = rays_d / rays_d.norm(dim=-1, keepdim=True)
    target = torch.rand((n, 3), generator=gen, device=cuda)
    box = SceneBox.create([-1, -1, -1], [1, 1, 1], cuda)
    fn = make_loss_and_grads(
        cfg, box, LossWeights(weight_main=1.0, weight_entropy_last=1e-3,
                              weight_orientation=1e-4, sigmoid_rgb_loss=0.02,
                              weight_tv_density=0.01),
        near=0.2, bg=1.0, sdf_tv=0.1, smooth_grad_tv=0.05,
        use_nonempty_mask=False)
    args = (params, {}, rays_o, rays_d, viewdirs, target,
            torch.tensor(0.2, device=cuda), 1.0)
    n0 = B7.KERNEL.launches["dense_accumulate"]
    _, lk, gk = fn(*args)
    torch.cuda.synchronize()
    assert B7.KERNEL.launches["dense_accumulate"] == n0 + (
        1 if stage == "coarse" else 3)
    with plain_twins():
        _, lp, gp = fn(*args)
    assert torch.isfinite(lk["loss"])
    torch.testing.assert_close(lk["loss"], lp["loss"], rtol=1e-4, atol=0)
    for name in ("sdf", "k0"):
        assert _rel_l2(gk[name], gp[name]) < 1e-3


# (block rows, layer widths): the shapes of tests/test_fused_mlp.py, and
# the fine shading head's rgbnet and refnet (`_shade_fine_cm`)
# share of B8's outputs allowed past 1e-5: B3's 1%, but 2% for the 4-layer
# nets on these random inputs, whose larger hiddens land one bf16 ulp away
# more often (refnet 1.49%, rgbnet 0.81% on the H100; 0.40% / 0.34% on
# the fine step's own inputs, where chip_smoke.py holds them to 1%); the
# twin with f32 hiddens moves most outputs past 1e-5
MLP_FLIP_SHARE = {"small": 0.01, "rgbnet": 0.02, "refnet": 0.02,
                  "rgbnet-ragged": 0.02}
MLP_REL_L2 = {"small": 1e-3, "rgbnet": 5e-3, "refnet": 5e-3,
              "rgbnet-ragged": 5e-3}
MLP_DX_SHARE = 0.05  # B9 dx entries allowed past 1e-4 of the twin's RMS
_MLP_SHAPES = {
    "small": ((12, 33, 33, 3, 9), (90, 64, 64, 3)),
    "rgbnet": ((12, 33, 21, 1, 24, 12, 3), (106, 256, 256, 256, 256)),
    "refnet": ((256, 51), (307, 256, 256, 256, 3)),
    "rgbnet-ragged": ((12, 33, 21, 1, 24, 12, 3), (106, 256, 256, 256, 256)),
}
# samples per case (8,192 unless named): the ragged case ends inside a
# 64-sample chunk, a 128-sample tile and a dW sample range
_MLP_M = {"rgbnet-ragged": 8192 + 77}


@pytest.mark.parametrize("name", sorted(_MLP_SHAPES))
def test_b8_b9_match_plain(cuda, name):
    rows, dims = _MLP_SHAPES[name]
    gen = torch.Generator(device=cuda).manual_seed(8)
    m = _MLP_M.get(name, 8192)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    blocks = [randn(r, m, scale=0.5) for r in rows]
    weights = [randn(i, o, scale=i ** -0.5) for i, o in zip(dims[:-1], dims[1:])]
    biases = [randn(o, scale=0.1) for o in dims[1:]]
    g = randn(dims[-1], m)
    n0 = dict(B89.KERNEL.launches)

    def flat(bwd):
        dx, dws, dbs = bwd
        return [dx, *dws, *dbs]

    def b9_readings(outs, ref):
        """(worst relative L2 over the outputs, share of dx entries more
        than 1e-4 of the reference dx's RMS away)."""
        dx, dx_ref = outs[0].double(), ref[0].double()
        far = (dx - dx_ref).abs() > 1e-4 * dx_ref.pow(2).mean().sqrt()
        return (max(_rel_l2(a, b) for a, b in zip(outs, ref)),
                float(far.double().mean()))

    # every reading first, so that a failure shows them all
    got = FM.fused_mlp_cm_fwd(blocks, weights, biases)
    want = FM.fused_mlp_cm_fwd_plain(blocks, weights, biases)
    diff = (got - want).abs()
    unrounded = FM.fused_mlp_cm_fwd_plain(blocks, weights, biases,
                                          round_hidden=False)
    kernel = flat(FM.fused_mlp_cm_bwd(blocks, weights, biases, g))
    plain = flat(FM.fused_mlp_cm_bwd_plain(blocks, weights, biases, g))
    torch.cuda.synchronize()
    readings = {
        "b8_max": float(diff.max()),
        "b8_share_past_1e5": float((diff > 1e-5).float().mean()),
        "control_b8_share": float(((unrounded - want).abs() > 1e-5)
                                  .float().mean()),
        "b9": b9_readings(kernel, plain),
        **{f"control_b9_{k}": b9_readings(flat(FM.fused_mlp_cm_bwd_plain(
            blocks, weights, biases, g, **{k: False})), plain)
           for k in ("round_dz", "round_hidden")},
    }
    print(name, readings)
    assert readings["b8_max"] < 1e-2
    assert readings["b8_share_past_1e5"] < MLP_FLIP_SHARE[name]
    assert readings["control_b8_share"] > MLP_FLIP_SHARE[name]
    assert torch.equal(got, FM.fused_mlp_cm_fwd(blocks, weights, biases))
    assert [a.shape for a in kernel] == [b.shape for b in plain]
    rel, share = readings["b9"]
    assert rel < MLP_REL_L2[name] and share < MLP_DX_SHARE
    for k in ("round_dz", "round_hidden"):
        rel, share = readings[f"control_b9_{k}"]
        assert rel > MLP_REL_L2[name] or share > MLP_DX_SHARE, k
    again = flat(FM.fused_mlp_cm_bwd(blocks, weights, biases, g))
    assert all(torch.equal(a, b) for a, b in zip(kernel, again))
    dx = kernel[0]
    assert B89.KERNEL.launches["fused_mlp_fwd"] == n0["fused_mlp_fwd"] + 2
    assert B89.KERNEL.launches["fused_mlp_bwd"] == n0["fused_mlp_bwd"] + 2

    # the autograd op routes to the kernels
    tb = [b.clone().requires_grad_(True) for b in blocks]
    out = FM.fused_mlp_cm(tb, weights, biases, bs=m)
    (out * g).sum().backward()
    for blk, o, r in zip(tb, FM.pad_plan(rows)[0], rows):
        assert torch.equal(blk.grad, dx[o:o + r])


# B8's edges (csrc/fused_mlp_cm.cu): (block rows, layer widths, M, share
# of outputs allowed past 1e-5, as MLP_FLIP_SHARE: 1% for one or two
# 64-wide hidden layers, 2% for deeper or wider nets)
_B8_EDGES = {
    "one-layer": ((12, 33), (45, 64), 8192, 0.01),
    "eight-layers": ((12, 33, 33, 3, 9), (90,) + (64,) * 7 + (3,), 8192,
                     0.02),
    # kp0 432 beside 256-wide hidden layers: two ring stages, the least
    "kp0-limit": ((216, 215), (431, 256, 256, 3), 8192, 0.02),
    "sixteen-blocks": (tuple(range(1, 17)), (136, 64, 64, 3), 8192, 0.01),
    # 301 tiles over the persistent grid, the last one 77 samples
    "many-tiles": ((12, 33, 21, 1, 24, 12, 3), (106, 256, 256, 256, 256),
                   128 * 300 + 77, 0.02),
}
# samples of the many-tile case's inputs taken alone: M = 1 and a tile
# less one
_B8_PREFIX = {"m-1": 1, "m-tile-less-one": 127}


def _b8_inputs(cuda, rows, dims, m, seed=12):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    blocks = [randn(r, m, scale=0.5) for r in rows]
    weights = [randn(i, o, scale=i ** -0.5) for i, o in zip(dims[:-1], dims[1:])]
    biases = [randn(o, scale=0.1) for o in dims[1:]]
    return blocks, weights, biases


@pytest.mark.parametrize("name", sorted(_B8_EDGES) + sorted(_B8_PREFIX))
def test_b8_edges(cuda, name):
    """B8 against its twin at the edges of its design: one and eight
    layers, kp0 at its shared-memory limit, 16 input blocks, many tiles a
    block with a ragged last tile, M = 1 and M = 127; every call repeated
    bit for bit.  A share over 1 or 127 samples counts one or two
    samples, so those two cases are held bit for bit to the same samples
    inside the many-tile call, which is held to the share limit; a
    one-layer net has no hidden rounding for the control to leave out."""
    prefix = None
    if name in _B8_PREFIX:
        rows, dims, m_all, limit = _B8_EDGES["many-tiles"]
        blocks, weights, biases = _b8_inputs(cuda, rows, dims, m_all)
        m = _B8_PREFIX[name]
        prefix = FM.fused_mlp_cm_fwd(blocks, weights, biases)[:, :m]
        blocks = [b[:, :m].contiguous() for b in blocks]
    else:
        rows, dims, m, limit = _B8_EDGES[name]
        blocks, weights, biases = _b8_inputs(cuda, rows, dims, m)
    if name == "kp0-limit":
        kp, np_ = [432, 256, 256], [256, 256, 16]
        assert B89.fwd_plan(m, kp, np_, 132)["stages"] == 2
        assert B89.fwd_plan(m, [448] + kp[1:], np_, 132)["stages"] < 2
    n0 = B89.KERNEL.launches["fused_mlp_fwd"]
    got = FM.fused_mlp_cm_fwd(blocks, weights, biases)
    again = FM.fused_mlp_cm_fwd(blocks, weights, biases)
    want = FM.fused_mlp_cm_fwd_plain(blocks, weights, biases)
    unrounded = FM.fused_mlp_cm_fwd_plain(blocks, weights, biases,
                                          round_hidden=False)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    readings = {
        "max": float(diff.max()),
        "share_past_1e5": float((diff > 1e-5).float().mean()),
        "control_share": float(((unrounded - want).abs() > 1e-5)
                               .float().mean()),
    }
    print(name, readings)
    assert got.shape == (dims[-1], m)
    assert B89.KERNEL.launches["fused_mlp_fwd"] == n0 + 2
    assert torch.equal(got, again)
    assert readings["max"] < 1e-2
    if prefix is not None:
        assert torch.equal(got, prefix)
    else:
        assert readings["share_past_1e5"] < limit
        if len(dims) > 2:
            assert readings["control_share"] > limit


@pytest.mark.parametrize("rows,dims,match", [
    ((12, 33), (45, 272, 3), "pad past 256 outputs"),
    # kp0 448 beside 256-wide hidden layers: not two stages beside X and H
    ((224, 224), (448, 256, 256, 3), "shared memory"),
])
def test_b8_refuses_nets_past_its_limits(cuda, rows, dims, match):
    """A layer wider than 256 outputs, or an input too wide for the
    block's shared memory, raises ValueError naming the widths before any
    launch."""
    blocks, weights, biases = _b8_inputs(cuda, rows, dims, 256)
    n0 = B89.KERNEL.launches["fused_mlp_fwd"]
    with pytest.raises(ValueError, match=match):
        FM.fused_mlp_cm_fwd(blocks, weights, biases)
    assert B89.KERNEL.launches["fused_mlp_fwd"] == n0


def test_tensorf_rows_match_densify_at_full_width(cuda):
    """The TensoRF k0 query (``core/grids.py:tensorf_rows``) at the fine
    grid of ``shiny_blender`` (258 x 257 x 252, 48 components a plane, a
    [144, 12] basis) against ``tensorf_densify`` served trilinearly, on
    32,768 rows: inside, on the faces, past them (zero padding) and at
    the sorted engine's sentinel corner.  Trilinear weights factor over
    the axes, so the two differ by float32 summation order alone (the
    basis product sums 144 terms in another order): values and every
    factor's gradient within 1e-5 of their largest magnitude."""
    from benchmark.reference.sdf_step import serve
    from fgs_nerf_tpu_torch.core import grids as G

    ws, r, c, n = (258, 257, 252), 48, 12, 32768
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = G.init_tensorf_params(gen, c, ws, r, device=cuda)
    size = torch.tensor(ws, dtype=torch.float32, device=cuda)[:, None]
    idx = torch.rand((3, n), generator=gen, device=cuda) * (size + 1.0) - 1.0
    idx[:, :64] = torch.floor(idx[:, :64])             # on grid nodes
    idx[0, 64:128] = ws[0] - 1.0                        # the last x face
    idx[2, 128:192] = 0.0                               # the first z face
    base = torch.floor(idx).long()
    fr = idx - torch.floor(idx)
    zp = ST.z_stride(ws[2])
    base[:, -64:] = torch.tensor([ws[0], ws[1], zp - 2], device=cuda)[:, None]
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    got = G.tensorf_rows(leaves, base, fr, c)
    dense = G.tensorf_densify(leaves, c)
    b = base.float()
    want = serve(dense, b[0] + fr[0], b[1] + fr[1], b[2] + fr[2],
                 list(fr.unbind(0))).t()
    with torch.no_grad():
        assert float(want[:, -64:].abs().max()) == 0.0
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    g = torch.randn(got.shape, generator=gen, device=cuda)
    g_got = torch.autograd.grad((got * g).sum(), list(leaves.values()))
    g_want = torch.autograd.grad((want * g).sum(), list(leaves.values()))
    for k, a, w in zip(leaves, g_got, g_want):
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max()), k
