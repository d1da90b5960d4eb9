"""The ported fine sorted-engine train step against the JAX step (CPU).

Same parameters (made by the JAX package, perturbed from a numpy seed,
carried across with ``fgs_nerf_tpu_torch.convert``) and the same rays go
through ``fgs_nerf_tpu`` and ``fgs_nerf_tpu_torch``; the port runs its
plain PyTorch paths (CPU tensors), the JAX package its CPU references.
Shape, after ``tests/test_fine_sorted.py:156-197``: 14^3 grid, 32 rays,
sample_k 40 -> 1,280 pass-1 samples, shade_k 24 -> 768 pass-2 samples,
rgbnet / refnet width 16 depth 3, displacements (0.5, 1, 1.5, 2) (16 z/y
taps, 8 x taps), TV injected into the sdf gradient
(``inject_tv=True, tv_dense=True``), fine-stage loss weights of
``bench.py:371-376``.

Cases: float32 shading without and with a mask cache, bf16 shading
with a mask cache.  The mask cache holds 2e-3 in the SDF band
|sdf| < 0.3: with the stage handoff's 1e-3, interpolating all-1e-3
corners lands exactly on the 1e-3 threshold, where any reassociation
flips the comparison (see ``tests/test_torch_coarse_step.py``).

Tolerances and why:
* float32: render outputs and the loss agree to reassociation (~1e-7),
  held at 1e-5; n.v normalizes the interpolated gradient, whose noise
  grows by 1/|g| where it is small, held at 2e-4; gradients agree to
  ~5e-7 relative L2, held at 1e-4.
* bf16 shading: the forward rounds at the same places (outputs as in
  float32); the hidden-layer sums run in another order on each side, so
  one bf16 ulp can differ and the bias gradients differ by ~1e-2
  relative L2, held at 2e-2 (the reason of
  ``tests/test_torch_coarse_step.py:14-18``).
* post-Adam parameters: Adam's first step lr * g / (|g| + eps) amplifies
  gradient differences where |g| is small; compared where |g| > 1e-6 at
  1e-5 (float32) or |g| > 1e-5 at 1e-4 (bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.optim.masked_adam import ParamOpts as ParamOptsJ
from fgs_nerf_tpu.optim.masked_adam import init_state as init_state_j
from fgs_nerf_tpu.ops.sorted_cm import padded_rows_cm as padded_rows_j
from fgs_nerf_tpu.train.losses import LossWeights as LossWeightsJ
from fgs_nerf_tpu.train.losses import compute_losses as compute_losses_j
from fgs_nerf_tpu.train.trainer import make_train_step as make_train_step_j

from fgs_nerf_tpu_torch import convert
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.models.mlp import rgbnet_dims
from fgs_nerf_tpu_torch.ops.sorted_cm import padded_rows_cm, tap_bounds
from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts, init_state
from fgs_nerf_tpu_torch.train.losses import LossWeights
from fgs_nerf_tpu_torch.train.trainer import make_loss_and_grads, make_train_step

XYZ_MIN = np.array([-1.0, -1.0, -1.0], np.float32)
XYZ_MAX = np.array([1.0, 1.0, 1.0], np.float32)
N_RAYS = 32
S_VAL = 0.2
DISPLACE = (0.5, 1.0, 1.5, 2.0)
LOSS_W = dict(
    weight_main=1.0, weight_rgbper=0.0, weight_entropy_last=1e-3,
    weight_orientation=1e-4, sigmoid_rgb_loss=0.02, weight_tv_density=0.01,
    weight_tv_k0=0.0, ori_tv=False,
)
STEP_KW = dict(near=0.2, bg=1.0, n_rand=N_RAYS, sdf_tv=0.1,
               smooth_grad_tv=0.05, inject_tv=True, tv_dense=True,
               weight_tv_density=0.01, weight_tv_k0=0.0,
               use_nonempty_mask=False)
LRS = {"sdf": 5e-3, "k0": 0.1, "refnet": 1e-3, "rgbnet": 1e-3}
LEAVES = ["sdf", "k0"] + [f"{net}.{p}{i}" for net in ("refnet", "rgbnet")
                          for i in range(3) for p in ("w", "b")]


def _cfg_kwargs(mlp_bf16):
    return dict(
        stage="fine", xyz_min=XYZ_MIN, xyz_max=XYZ_MAX, num_voxels=14**3,
        num_voxels_base=14**3, stepsize=0.5, k0_dim=4, refnet_width=16,
        refnet_depth=3, rgbnet_width=16, rgbnet_depth=3, posbase_pe=2,
        viewbase_pe=1, refbase_pe=2, s_ratio=50.0, s_start=0.2, shade_k=24,
        sample_k=40, grad_feat=DISPLACE, sdf_feat=DISPLACE,
        fast_color_thres=1e-4, shade_remat=False, engine="sorted",
        mlp_bf16=mlp_bf16,
    )


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _params_and_rays(cfg_j):
    rng = np.random.default_rng(7)
    pj = MJ.init_params(jax.random.PRNGKey(0), cfg_j)
    pj["k0"] = jnp.asarray(
        rng.normal(size=pj["k0"].shape).astype(np.float32) * 0.3)
    # a strictly interior sphere with a little noise
    axes = [np.linspace(-1.0, 1.0, n) for n in cfg_j.world_size]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(gx**2 + gy**2 + gz**2)[..., None]
    pj["sdf"] = jnp.asarray(
        (r - 0.55 + rng.normal(size=r.shape) * 0.02).astype(np.float32))
    rays_o = np.full((N_RAYS, 3), [0, 0, 3.0], np.float32)
    rays_o += rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.2
    look = rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.25
    rays_d = (look - rays_o).astype(np.float32)
    viewdirs = (rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
                ).astype(np.float32)
    target = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    return pj, (rays_o, rays_d, viewdirs, target)


@pytest.fixture(scope="module",
                params=[(False, False), (False, True), (True, True)],
                ids=["f32", "f32_masked", "bf16_masked"])
def case(request):
    mlp_bf16, masked = request.param
    kw = _cfg_kwargs(mlp_bf16)
    cfg_j = MJ.make_model_config(**kw)
    cfg_t = MT.make_model_config(**kw)
    pj, batch = _params_and_rays(cfg_j)
    rays_o, rays_d, viewdirs, target = batch
    buf_j, buf_t = {}, {}
    if masked:
        mask = np.where(np.abs(np.asarray(pj["sdf"])) < 0.3, 2e-3, 0.0
                        ).astype(np.float32)
        buf_j = {"mask_cache": MJ.build_mask_cache(jnp.asarray(mask),
                                                   XYZ_MIN, XYZ_MAX)}
        buf_t = {"mask_cache": MT.build_mask_cache(torch.from_numpy(mask),
                                                   XYZ_MIN, XYZ_MAX)}

    # --- JAX side ---------------------------------------------------------
    box_j = SceneBoxJ.create(XYZ_MIN, XYZ_MAX)
    lw_j = LossWeightsJ(**LOSS_W)

    def loss_j(p):
        r = MJ.forward(p, buf_j, cfg_j, box_j, *map(jnp.asarray, batch[:3]),
                       jnp.float32(S_VAL), near=0.2, bg=1.0)
        losses = compute_losses_j(
            r, jnp.asarray(target), jnp.asarray(viewdirs), p, cfg_j, lw_j,
            sdf_tv=0.1, smooth_grad_tv=0.05, tv_on=1.0, nonempty_mask=None)
        return losses["loss"], r

    (lj, rj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(pj)
    np_params = jax.tree.map(np.asarray, pj)
    opts_j = {k: ParamOptsJ(skip_zero_grad=k in ("k0", "sdf")) for k in pj}
    step_j = make_train_step_j(cfg_j, box_j, lw_j, opts_j, **STEP_KW)
    new_pj, _, metrics_j = step_j(
        jax.tree.map(jnp.asarray, np_params), init_state_j(pj), buf_j,
        *map(jnp.asarray, batch), jnp.float32(S_VAL),
        {k: jnp.asarray(v) for k, v in LRS.items()}, jnp.float32(1.0))

    # --- port -------------------------------------------------------------
    box_t = SceneBox.create(XYZ_MIN, XYZ_MAX, device="cpu")
    lw_t = LossWeights(**LOSS_W)
    pt = convert.params_from_jax(np_params, "cpu")
    tb = [torch.from_numpy(a) for a in batch]
    fn = make_loss_and_grads(cfg_t, box_t, lw_t, near=0.2, bg=1.0,
                             sdf_tv=0.1, smooth_grad_tv=0.05,
                             use_nonempty_mask=False)
    rt, lt, gt = fn(pt, buf_t, *tb, torch.tensor(S_VAL), 1.0)
    opts_t = {k: ParamOpts(skip_zero_grad=k in ("k0", "sdf")) for k in pt}
    step_t = make_train_step(cfg_t, box_t, lw_t, opts_t, **STEP_KW)
    new_pt, _, metrics_t = step_t(pt, init_state(pt), buf_t, *tb,
                                  torch.tensor(S_VAL), LRS, 1.0)
    return dict(
        mlp_bf16=mlp_bf16, cfg_j=cfg_j, cfg_t=cfg_t,
        jax=dict(loss=float(lj), render=rj, grads=_flat(gj),
                 new_params=_flat(new_pj), metrics=metrics_j),
        torch=dict(loss=float(lt["loss"].detach()), render=rt,
                   grads=_flat(convert.params_to_numpy(gt)),
                   new_params=_flat(convert.params_to_numpy(new_pt)),
                   metrics=metrics_t),
    )


def test_config_matches(case):
    assert dataclasses.asdict(case["cfg_t"]) == dataclasses.asdict(case["cfg_j"])
    for name in ("all_displace", "voxel_size_ratio"):
        assert getattr(case["cfg_t"], name) == getattr(case["cfg_j"], name)
    assert case["cfg_t"].rgbnet_in_dim() == case["cfg_j"].rgbnet_in_dim()


@pytest.mark.parametrize("key", ["rgb_marched", "sigmoid_rgb", "alphainv_cum",
                                 "weights", "ndv", "sel_weights", "depth"])
def test_forward_outputs(case, key):
    want = np.asarray(case["jax"]["render"][key])
    got = case["torch"]["render"][key].detach().numpy()
    assert got.shape == want.shape
    tol = 2e-4 if key == "ndv" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("key", ["valid", "live", "sel_live", "overflow"])
def test_forward_masks(case, key):
    got = case["torch"]["render"][key].numpy()
    np.testing.assert_array_equal(got, np.asarray(case["jax"]["render"][key]))
    if key in ("live", "sel_live"):
        assert got.any()


def test_loss(case):
    np.testing.assert_allclose(case["torch"]["loss"], case["jax"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(case["torch"]["metrics"]["loss"]),
                               float(case["jax"]["metrics"]["loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradients(case, leaf):
    want = case["jax"]["grads"][leaf]
    got = case["torch"]["grads"][leaf]
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    tol = 2e-2 if case["mlp_bf16"] else 1e-4
    assert _rel_l2(got, want) < tol


@pytest.mark.parametrize("leaf", LEAVES + ["s_val"])
def test_post_adam_params(case, leaf):
    want = case["jax"]["new_params"][leaf]
    got = case["torch"]["new_params"][leaf]
    if leaf == "s_val":
        np.testing.assert_array_equal(got, want)
        return
    g = case["jax"]["grads"][leaf]
    floor, tol = (1e-5, 1e-4) if case["mlp_bf16"] else (1e-6, 1e-5)
    clear = np.abs(g) > floor
    assert clear.sum() > 0 or leaf == "k0"
    np.testing.assert_allclose(got[clear], want[clear], rtol=0, atol=tol)
    # skip_zero_grad: voxels with an exactly zero gradient stay untouched
    # (the sdf gradient has none: the TV terms reach every voxel)
    if leaf == "k0":
        zero = case["torch"]["grads"][leaf] == 0
        assert zero.any()
        np.testing.assert_array_equal(got[zero], want[zero])


def _cube_sdf(cfg_j, rng):
    """A noisy cube whose faces lie 0.15 inside the grid's edges."""
    axes = [np.linspace(-1.0, 1.0, n) for n in cfg_j.world_size]
    g = np.meshgrid(*axes, indexing="ij")
    r = np.maximum(np.maximum(np.abs(g[0]), np.abs(g[1])), np.abs(g[2]))
    return (r[..., None] - 0.85 + rng.normal(size=r[..., None].shape) * 0.02
            ).astype(np.float32)


def _compact_rays(kind, n, rng):
    """``no_live``: rays from above the box pointing away from it;
    ``all_live``: rays through the sphere 0.3 off its centre (where the
    SDF's gradient vanishes and n.v is noise); ``grid_edge``: rays
    grazing a face of the box 0.0-0.1 inside it."""
    o = np.zeros((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    if kind == "grid_edge":
        for i in range(n):
            a, b, c = np.roll(np.arange(3), -int(rng.integers(3)))
            o[i, a] = rng.choice([-1.0, 1.0]) * rng.uniform(0.9, 1.0)
            o[i, b] = rng.uniform(-1.0, 1.0)
            o[i, c] = -3.0
            d[i, c] = 1.0
            d[i, b] = rng.normal() * 0.2
            d[i, a] = rng.normal() * 0.05
    else:
        o[:] = [0.0, 0.0, 3.0]
        o += rng.normal(size=(n, 3)).astype(np.float32) * 0.05
        ring = rng.uniform(0.0, 2.0 * np.pi, size=n)
        d[:] = np.stack([np.cos(ring), np.sin(ring), 0.0 * ring], -1) * 0.3 - o
        if kind == "no_live":
            d = -d
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, v.astype(np.float32), rng.uniform(size=(n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("kind,n_rays,shade_k", [
    ("no_live", 32, 24), ("all_live", 32, 8), ("grid_edge", 128, 24)])
def test_compacted_head(monkeypatch, kind, n_rays, shade_k):
    """The sorted fine head computes the pass-2 stream's live prefix
    (``HEAD_ROW_MULTIPLE`` rows at a time, at most ``m2``) and pads its
    output with 0: render outputs, loss (``rgbper`` on, which reads the
    padded rows times a zero weight) and gradients equal the JAX
    package's full-stream head.  In the pass-2 sorted stream the live
    rows are exactly the first ``sum(sel_live)``.  ``no_live``: the head
    runs on zero rows and its leaves get exact zero gradients;
    ``all_live``: it computes every row; ``grid_edge``: a cube surface
    at the grid's edges, where the head computes a prefix shorter than
    ``m2``."""
    kw = dict(_cfg_kwargs(False), shade_k=shade_k)
    cfg_j = MJ.make_model_config(**kw)
    cfg_t = MT.make_model_config(**kw)
    rng = np.random.default_rng(11)
    pj, _ = _params_and_rays(cfg_j)
    if kind == "grid_edge":
        pj["sdf"] = jnp.asarray(_cube_sdf(cfg_j, rng))
    batch = _compact_rays(kind, n_rays, rng)
    loss_w = dict(LOSS_W, weight_rgbper=0.1)

    box_j = SceneBoxJ.create(XYZ_MIN, XYZ_MAX)

    def loss_j(p):
        r = MJ.forward(p, {}, cfg_j, box_j, *map(jnp.asarray, batch[:3]),
                       jnp.float32(S_VAL), near=0.2, bg=1.0)
        losses = compute_losses_j(
            r, jnp.asarray(batch[3]), jnp.asarray(batch[2]), p, cfg_j,
            LossWeightsJ(**loss_w), sdf_tv=0.1, smooth_grad_tv=0.05,
            tv_on=1.0, nonempty_mask=None)
        return losses["loss"], r

    (lj, rj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(pj)
    gj = _flat(gj)

    sorts, heads = [], []
    real_sort, real_head = MT.sort_stream, MT._head_rows
    monkeypatch.setattr(MT, "sort_stream",
                        lambda *a, **k: sorts.append(real_sort(*a, **k))
                        or sorts[-1])
    monkeypatch.setattr(MT, "_head_rows",
                        lambda *a: heads.append(real_head(*a)) or heads[-1])
    fn = make_loss_and_grads(
        cfg_t, SceneBox.create(XYZ_MIN, XYZ_MAX, device="cpu"),
        LossWeights(**loss_w), near=0.2, bg=1.0, sdf_tv=0.1,
        smooth_grad_tv=0.05, use_nonempty_mask=False)
    rt, lt, gt = fn(convert.params_from_jax(jax.tree.map(np.asarray, pj),
                                            "cpu"), {},
                    *(torch.from_numpy(a) for a in batch),
                    torch.tensor(S_VAL), 1.0)
    gt = _flat(convert.params_to_numpy(gt))

    # the live rows lead the pass-2 sorted stream; the head's row count
    sel = rt["sel_live"].reshape(-1)
    m2, n_live = sel.numel(), int(sel.sum())
    iota2_s = sorts[-1][1].long()
    assert torch.equal(sel[iota2_s], torch.arange(m2) < n_live)
    mult = MT.HEAD_ROW_MULTIPLE
    assert heads == [(n_live, min(-(-n_live // mult) * mult, m2))]
    n_head = heads[0][1]
    want_rows = {"no_live": 0, "all_live": m2}.get(kind)
    if want_rows is None:
        assert 0 < n_live < n_head < m2
    else:
        assert n_live == n_head == want_rows

    np.testing.assert_array_equal(sel.reshape(n_rays, shade_k).numpy(),
                                  np.asarray(rj["sel_live"]))
    for key in ("rgb_marched", "sigmoid_rgb", "alphainv_cum", "weights",
                "ndv", "sel_weights", "depth"):
        tol = 2e-4 if key == "ndv" else 1e-5
        np.testing.assert_allclose(rt[key].detach().numpy(),
                                   np.asarray(rj[key]), rtol=tol, atol=tol,
                                   err_msg=key)
    live = sel.reshape(n_rays, shade_k).numpy()
    for got, want in zip(rt["sel_rgb_ch"], rj["sel_rgb_ch"]):
        got = got.detach().numpy()
        np.testing.assert_allclose(got[live], np.asarray(want)[live],
                                   rtol=1e-5, atol=1e-5)
        assert (got[~live] == 0).all()
    np.testing.assert_allclose(float(lt["loss"].detach()), float(lj),
                               rtol=1e-5)
    for leaf in LEAVES:
        if kind == "no_live" and leaf.startswith(("rgbnet", "refnet")):
            assert (gt[leaf] == 0).all() and (gj[leaf] == 0).all(), leaf
        else:
            assert _rel_l2(gt[leaf], gj[leaf]) < 1e-4, leaf


def test_convert_fine_params_and_init():
    """The fine parameter tree (with ``rgbnet``) crosses the boundary and
    back unchanged, and the port's own init makes the JAX shapes."""
    kw = _cfg_kwargs(True)
    cfg_j = MJ.make_model_config(**kw)
    cfg_t = MT.make_model_config(**kw)
    pj = jax.tree.map(np.asarray, MJ.init_params(jax.random.PRNGKey(3), cfg_j))
    pt = convert.params_from_jax(pj, "cpu")
    back = _flat(convert.params_to_numpy(pt))
    for k, v in _flat(pj).items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == np.float32
    state = convert.adam_state_from_jax(np.int32(2), pj, pj, "cpu")
    np.testing.assert_array_equal(
        convert.adam_state_to_numpy(state)[1]["rgbnet"]["w2"], pj["rgbnet"]["w2"])
    own = MT.init_params(torch.Generator().manual_seed(0), cfg_t, "cpu")
    assert set(own) == set(pj) and set(own["rgbnet"]) == set(pj["rgbnet"])
    for k, v in _flat(pj).items():
        assert _flat(convert.params_to_numpy(own))[k].shape == v.shape, k
    assert rgbnet_dims(106, 256, 4) == [106, 256, 256, 256, 256]


def test_bench_geometry():
    """The fine bench configuration (`bench.py:351-365`): 256^3 grid,
    rgbnet 106 -> 256 x 4, refnet 307 -> ..., 16 z/y and 8 x taps."""
    kw = dict(stage="fine", xyz_min=XYZ_MIN, xyz_max=XYZ_MAX,
              num_voxels=256**3, num_voxels_base=256**3, stepsize=0.5,
              k0_dim=12, rgbnet_width=256, rgbnet_depth=4, refnet_width=256,
              refnet_depth=4, posbase_pe=5, viewbase_pe=3, refbase_pe=8,
              grad_feat=DISPLACE, sdf_feat=DISPLACE, center_sdf=True,
              use_viewdir=True, s_ratio=50.0, s_start=0.05,
              fast_color_thres=1e-4, shade_k=128, sample_k=512,
              shade_remat=False, engine="sorted")
    cfg_t = MT.make_model_config(**kw)
    cfg_j = MJ.make_model_config(**kw)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.world_size == (256, 256, 256)
    assert (cfg_t.sample_k, cfg_t.shade_k) == (512, 128)
    assert padded_rows_cm(cfg_t.world_size) == padded_rows_j(cfg_j.world_size)
    assert padded_rows_cm(cfg_t.world_size) == 25_560_576
    assert cfg_t.rgbnet_in_dim() == 106 and cfg_t.refnet_in_dim() == 307
    assert cfg_t.all_displace == DISPLACE
    assert tap_bounds(cfg_t.world_size) == (1156, 772)
