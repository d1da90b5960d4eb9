"""The sorted fine step with a TensoRF k0 (``grid_type='tensorf'``), CPU.

With a factored k0 the fine engine serves ``[sdf | grad]`` alone and
queries the factors at the head's rows (``core/grids.py:tensorf_rows``)
in place of densifying them.  Held here:

* the query against the factors densified and served by the engine's
  own pass-2 serve (``pack_gather_sorted_cm``) on a sorted stream with
  rows inside the grid, on its faces, past them and at the sentinel;
* one train step against the plain reference of the benchmark
  (``benchmark/reference/tensorf.py``: densify by ``einsum``, then the
  dense stage's serve), both with bf16 heads, from one seeded state;
* the loss, gradients and masked Adam of the JAX package's step, which
  densifies, with float32 heads.

Size: 14^3 grid, 4 components a plane, 12 k0 channels, rgbnet / refnet
16 x 3, displacements (0.5, 1, 1.5, 2), 32 rays (sample_k 40, shade_k
16).  Tolerances and why:

* query: the same products summed in another order (the basis product
  over 12 components, the trilinear corners): 1e-6 of the largest
  value, gradients too;
* against the reference: the program and the reference round the heads'
  operands to bf16 at the same places; they sum in other orders (the
  reference's densify contracts each term with the basis first), so a
  hidden value can land one bf16 ulp apart: loss 1e-5 relative, each
  factor's gradient relative L2 1e-3, the post-Adam factors within 1e-5
  (a hundredth of the step, lr = 0.1) where |g| > 1e-7 (Adam's first
  step is lr * g / (|g| + 1e-7): below that the step turns on eps) and
  unchanged where g is exactly zero (masked Adam, ``skip_zero_grad``);
* against the JAX package (float32 heads): loss 1e-5 relative, each
  factor's gradient relative L2 1e-4, as ``tests/test_torch_fine_step.py``'s
  float32 case; post-Adam factors as against the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmark.reference import sdf_step as RS
from benchmark.reference import tensorf as RT
from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.optim.masked_adam import ParamOpts as ParamOptsJ
from fgs_nerf_tpu.optim.masked_adam import adam_update as adam_update_j
from fgs_nerf_tpu.optim.masked_adam import init_state as init_state_j
from fgs_nerf_tpu.train.losses import LossWeights as LossWeightsJ
from fgs_nerf_tpu.train.losses import compute_losses as compute_losses_j

from fgs_nerf_tpu_torch import convert
from fgs_nerf_tpu_torch.core import grids as G
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.ops import sorted_cm as ST
from fgs_nerf_tpu_torch.optim.masked_adam import init_state
from fgs_nerf_tpu_torch.train import trainer as TR

XYZ_MIN = np.array([-1.0, -1.0, -1.0], np.float32)
XYZ_MAX = np.array([1.0, 1.0, 1.0], np.float32)
N_RAYS = 32
DISPLACE = (0.5, 1.0, 1.5, 2.0)
FACTORS = ("xy_plane", "xz_plane", "yz_plane", "x_vec", "y_vec", "z_vec",
           "f_vec")
MODEL = dict(num_voxels=14**3, num_voxels_base=14**3, stepsize=0.5,
             k0_dim=12, refnet_width=16, refnet_depth=3, rgbnet_width=16,
             rgbnet_depth=3, posbase_pe=2, viewbase_pe=1, refbase_pe=2,
             s_ratio=50.0, s_start=0.2, shade_k=16, sample_k=40,
             grad_feat=DISPLACE, sdf_feat=DISPLACE, fast_color_thres=1e-4,
             mask_cache_thres=1e-3, engine="sorted", grid_type="tensorf",
             tensorf_n_comp=4)
TRAIN = dict(N_iters=20000, N_rand=N_RAYS, lrate_k0=0.1, lrate_sdf=5e-3,
             lrate_rgbnet=1e-3, lrate_refnet=1e-3, lrate_decay=20,
             weight_main=1.0, weight_entropy_last=1e-3, weight_rgbper=0.0,
             weight_tv_density=0.01, weight_tv_k0=0.0, sigmoid_rgb_loss=0.02,
             weight_orientation=1e-4, tv_every=1, tv_from=0, tv_end=30000,
             tv_dense_before=20000,
             tv_terms={"sdf_tv": 0.1, "smooth_grad_tv": 0.05},
             skip_zero_grad_fields=["k0"])
STEP = 100
# bound at import: ``torch_rank_workers.training_rank``, which
# ``tests/test_torch_parallel.py`` calls in the test process, rebinds
# ``MT.init_params`` for the rest of that process
INIT_PARAMS = MT.init_params


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(
                v, torch.Tensor) else v)
    return out


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = np.full((N_RAYS, 3), [0.0, 0.0, 3.0], np.float32)
    o += rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.2
    d = (rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.25 - o)
    v = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d.astype(np.float32), v, rng.uniform(size=(N_RAYS, 3)).astype(
        np.float32)


def _sphere_sdf(ws, seed):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1.0, 1.0, n) for n in ws]
    g = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(g[0] ** 2 + g[1] ** 2 + g[2] ** 2)[..., None]
    return (r - 0.55 + rng.normal(size=r.shape) * 0.02).astype(np.float32)


# ---------------------------------------------------------------------------
# The query
# ---------------------------------------------------------------------------


def test_query_equals_the_densified_field_served():
    """On a sorted pass-2 stream, ``tensorf_rows`` at each row's lower
    corner ``b - 1`` and fractions (what ``forward_fine_sorted`` hands it)
    equals the densified k0 served by ``pack_gather_sorted_cm``: rows
    inside, on grid nodes, on the six faces, past the faces (zero
    padding) and sentinel rows (zeros in both)."""
    ws = (9, 8, 7)
    gen = torch.Generator().manual_seed(5)
    params = {k: v.requires_grad_(True) for k, v in
              G.init_tensorf_params(gen, 12, ws, 4, device="cpu").items()}
    size = torch.tensor(ws, dtype=torch.float32)[:, None]
    idx = torch.rand((3, 600), generator=gen) * (size + 0.8) - 0.9
    idx[:, :40] = torch.floor(idx[:, :40])               # grid nodes
    for a in range(3):                                   # the faces
        idx[a, 40 + 40 * a:60 + 40 * a] = 0.0
        idx[a, 60 + 40 * a:80 + 40 * a] = ws[a] - 1.0
    rows, (fx, fy, fz), ok = ST.rows_fracs_cm(*idx.unbind(0), ws)
    r_sent = ST.padded_rows_cm(ws)
    keep = ok & (torch.arange(600) % 10 != 3)            # some sentinels
    keys = torch.where(keep, rows, torch.full_like(rows, r_sent))
    keys_s, perm = torch.sort(keys, stable=True)
    fr = torch.stack([fx, fy, fz])[:, perm]
    assert int((keys_s == r_sent).sum()) >= 60
    assert bool((idx < 0).any() and (idx > size - 1).any())

    dense_cm = G.tensorf_densify(params, 12).permute(3, 0, 1, 2)
    want = ST.pack_gather_sorted_cm(dense_cm, keys_s,
                                    ST.corner_weights_cm(*fr.unbind(0)))
    b = torch.stack(ST.rows_to_coords_cm(torch.clamp(keys_s, max=r_sent - 1),
                                         ws))
    got = G.tensorf_rows(params, b.long() - 1, fr, 12)
    assert got.shape == want.shape == (12, 600)
    with torch.no_grad():
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-6 * scale
        assert float(got[:, keys_s == r_sent].abs().max()) == 0.0
    g = torch.randn(got.shape, generator=gen)
    g[:, keys_s == r_sent] = 0.0     # sentinel rows carry no cotangent
    leaves = [params[k] for k in FACTORS]
    g_got = torch.autograd.grad((got * g).sum(), leaves)
    g_want = torch.autograd.grad((want * g).sum(), leaves)
    for k, a, w in zip(FACTORS, g_got, g_want):
        assert float(w.abs().max()) > 0, k
        assert float((a - w).abs().max()) <= 1e-6 * float(w.abs().max()), k


def test_one_component_query():
    """Without a basis (one channel) the query sums the three terms, as
    ``tensorf_densify`` does."""
    ws = (6, 7, 5)
    params = G.init_tensorf_params(torch.Generator().manual_seed(1), 1, ws, 3,
                                   device="cpu")
    assert "f_vec" not in params
    base = torch.tensor([[0, 2, 4], [1, 5, 0], [3, 0, 3]])
    fr = torch.tensor([[0.25, 0.5, 0.0], [0.75, 0.1, 0.9], [0.5, 0.0, 0.3]])
    dense = G.tensorf_densify(params, 1)
    want = RS.serve(dense, *(base.float() + fr).unbind(0), list(fr.unbind(0)))
    got = G.tensorf_rows(params, base, fr, 1)
    np.testing.assert_allclose(got[0].numpy(), want[:, 0].numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# One step against the benchmark's plain reference
# ---------------------------------------------------------------------------


def _program(cfg_m, box, params, buffers):
    lw = TR.loss_weights_from_cfg(TRAIN)
    kw = dict(near=0.2, bg=1.0, sdf_tv=0.1, smooth_grad_tv=0.05,
              use_nonempty_mask=True)
    lg = TR.make_loss_and_grads(cfg_m, box, lw, **kw)
    step = TR.make_train_step(
        cfg_m, box, lw, TR.make_param_opts(params, TRAIN), n_rand=N_RAYS,
        inject_tv=True, tv_dense=True, weight_tv_density=0.01,
        weight_tv_k0=0.0, **kw)
    return lg, step


def test_fine_step_matches_the_plain_reference():
    cfg_m = MT.make_model_config(stage="fine", xyz_min=XYZ_MIN,
                                 xyz_max=XYZ_MAX, **MODEL)
    box = SceneBox.create(XYZ_MIN, XYZ_MAX, "cpu")
    gen = torch.Generator().manual_seed(3)
    params = INIT_PARAMS(gen, cfg_m, "cpu")
    params["sdf"] = torch.from_numpy(_sphere_sdf(cfg_m.world_size, 3))
    # factors of a trained field (k0 of order 1), not of the init's 0.1
    params["k0"] = {k: v * (1.0 if k == "f_vec" else 8.0)
                    for k, v in params["k0"].items()}
    geo = torch.ones((12, 12, 12, 1))
    params, buffers = MT.set_nonempty_mask(
        params, {"mask_cache": MT.build_mask_cache(geo, XYZ_MIN, XYZ_MAX)},
        cfg_m, box)
    batch = [torch.from_numpy(a) for a in _rays(3)]
    s_val = RS.S.s_val(STEP, MODEL)
    lrs = RS.S.initial_lrs(TRAIN, {"sdf", "k0", "rgbnet", "refnet"})

    lg, step = _program(cfg_m, box, params, buffers)
    render, losses, grads = lg(params, buffers, *batch, torch.tensor(s_val),
                               1.0)
    assert int(render["sel_live"].sum()) > 0
    new_p, _, _ = step(params, init_state(params), buffers, *batch,
                       torch.tensor(s_val), lrs, torch.tensor(1.0))

    stage = RT.Stage({"fine_model": MODEL, "fine_train": TRAIN}, "fine",
                     (XYZ_MIN, XYZ_MAX), cfg_m.world_size, cfg_m.voxel_size,
                     geo, (XYZ_MIN, XYZ_MAX), 0.2, 1.0)
    ref_losses, ref_g, ref_p = RS.run_steps(stage, params, [batch], STEP,
                                            N_RAYS)
    np.testing.assert_allclose(float(losses["loss"].detach()), ref_losses[0],
                               rtol=1e-5)
    got_g, got_p = _flat(grads), _flat(new_p)
    p0 = _flat(params)
    for k in FACTORS:
        name = "k0." + k
        g_ref = ref_g[name].numpy()
        assert np.abs(g_ref).max() > 0, name
        assert _rel_l2(got_g[name], g_ref) < 1e-3, name
        clear = np.abs(g_ref) > 1e-7
        assert clear.any(), name
        np.testing.assert_allclose(got_p[name][clear],
                                   ref_p[name].numpy()[clear], rtol=0,
                                   atol=1e-5, err_msg=name)
        zero = got_g[name] == 0
        np.testing.assert_array_equal(got_p[name][zero], p0[name][zero])


# ---------------------------------------------------------------------------
# One step against the JAX package (which densifies)
# ---------------------------------------------------------------------------


def test_fine_step_matches_jax():
    """The loss and every factor's gradient of the JAX package's fine
    sorted step, which densifies the factors (one ``jit``), and the
    factors after its masked Adam (``optim/masked_adam.py:adam_update``,
    run eagerly: it is elementwise)."""
    kw = dict(MODEL, stage="fine", xyz_min=XYZ_MIN, xyz_max=XYZ_MAX,
              mlp_bf16=False, shade_remat=False)
    cfg_j, cfg_t = MJ.make_model_config(**kw), MT.make_model_config(**kw)
    pj = MJ.init_params(jax.random.PRNGKey(0), cfg_j)
    pj["sdf"] = jnp.asarray(_sphere_sdf(cfg_j.world_size, 7))
    pj["k0"] = {k: v * (1.0 if k == "f_vec" else 8.0)
                for k, v in pj["k0"].items()}
    np_params = jax.tree.map(np.asarray, pj)
    batch = _rays(7)
    lw = dict(weight_main=1.0, weight_rgbper=0.0, weight_entropy_last=1e-3,
              weight_orientation=1e-4, sigmoid_rgb_loss=0.02,
              weight_tv_density=0.01, weight_tv_k0=0.0, ori_tv=False)
    lrs = {"sdf": 5e-3, "k0": 0.1, "refnet": 1e-3, "rgbnet": 1e-3}
    s = 0.2
    box_j = SceneBoxJ.create(XYZ_MIN, XYZ_MAX)

    def loss_j(p):
        r = MJ.forward(p, {}, cfg_j, box_j, *map(jnp.asarray, batch[:3]),
                       jnp.float32(s), near=0.2, bg=1.0)
        return compute_losses_j(
            r, jnp.asarray(batch[3]), jnp.asarray(batch[2]), p, cfg_j,
            LossWeightsJ(**lw), sdf_tv=0.1, smooth_grad_tv=0.05, tv_on=1.0,
            nonempty_mask=None)["loss"]

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(pj)
    opts_j = {k: ParamOptsJ(skip_zero_grad=k == "k0") for k in pj}
    new_pj, _ = adam_update_j(pj, gj, init_state_j(pj),
                              {k: jnp.asarray(v) for k, v in lrs.items()},
                              opts_j)

    box_t = SceneBox.create(XYZ_MIN, XYZ_MAX, "cpu")
    pt = convert.params_from_jax(np_params, "cpu")
    tb = [torch.from_numpy(a) for a in batch]
    _, lt, gt = TR.make_loss_and_grads(
        cfg_t, box_t, TR.LossWeights(**lw), near=0.2, bg=1.0, sdf_tv=0.1,
        smooth_grad_tv=0.05, use_nonempty_mask=False)(
            pt, {}, *tb, torch.tensor(s), 1.0)
    opts_t = {k: TR.ParamOpts(skip_zero_grad=k == "k0") for k in pt}
    new_pt, _ = TR.adam_update(pt, gt, init_state(pt), lrs, opts_t)

    np.testing.assert_allclose(float(lt["loss"].detach()), float(lj),
                               rtol=1e-5)
    gj_f, gt_f = _flat(gj), _flat(gt)
    new_j, new_t = _flat(new_pj), _flat(new_pt)
    for k in FACTORS:
        name = "k0." + k
        assert np.abs(gj_f[name]).max() > 0, name
        assert _rel_l2(gt_f[name], gj_f[name]) < 1e-4, name
        clear = np.abs(gj_f[name]) > 1e-7
        assert clear.any(), name
        np.testing.assert_allclose(new_t[name][clear], new_j[name][clear],
                                   rtol=0, atol=1e-5, err_msg=name)
