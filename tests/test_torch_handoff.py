"""The port's stage-handoff primitives against the JAX package (CPU):
configs, schedules, grid resizes and pools, the checkpoint sdf_mask and
bbox shrink, the nonempty and near-camera masks, the view counts, the
coarse -> fine warm start and the training-ray samplers.

Inputs come from numpy seeds and go through both packages.

Tolerances and why:
* configs, schedules, max pool, bbox shrink, the per-view and flattened
  rays and the batch indices: the same host arithmetic, exactly equal.
* resizes and the warm start: the same float32 expressions, max abs
  1e-6 on unit-scale grids; the interpolation positions come from
  ``linspace``, whose float32 result XLA rounds differently in the last
  bit for some entries, which moves a value by that ulp times the grid's
  local slope: 1e-5 on the multi-axis resizes of a rung and a warm start
  (slopes up to ~4).
* threshold tests (``sdf < 0.5``, the near-camera distance, the mask
  cache ``>= 1e-3``, the view count ``> 1``): equal except at inputs
  within float32 reassociation of the threshold, which the tests count
  and bound (the mask cache is built from a 4e-3 sdf_mask so that no
  node interpolates to exactly 1e-3, the trap of ROADMAP §C).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.config import base as CBJ
from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.data import rays as RJ
from fgs_nerf_tpu.data.synthetic import make_synthetic_dataset as synth_j
from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.ops import interp as IJ
from fgs_nerf_tpu.train import schedules as SJ

from fgs_nerf_tpu_torch.config import base as CBT
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.data import rays as RT
from fgs_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.ops import interp as IT
from fgs_nerf_tpu_torch.train import schedules as ST

BUILTINS = ("shiny_blender", "dtu", "smart_car", "quick_synthetic",
            "full_synthetic")
XYZ_MIN = np.array([-1.0, -0.8, -0.9], np.float32)
XYZ_MAX = np.array([1.1, 0.9, 1.0], np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _cfgs(stage, num_voxels, **kw):
    base = dict(stage=stage, xyz_min=XYZ_MIN, xyz_max=XYZ_MAX,
                num_voxels=num_voxels, num_voxels_base=num_voxels,
                stepsize=0.5, smooth_ksize=5, smooth_sigma=0.8, **kw)
    return MJ.make_model_config(**base), MT.make_model_config(**base)


def _boxes():
    return (SceneBoxJ.create(XYZ_MIN, XYZ_MAX),
            SceneBox.create(XYZ_MIN, XYZ_MAX, "cpu"))


@pytest.mark.parametrize("name", BUILTINS)
def test_load_config_builtins(name):
    assert dict(CBT.load_config(name)) == dict(CBJ.load_config(name))
    for stage in ("geometry_searching", "coarse", "fine"):
        jm, jt = CBJ.stage_blocks(CBJ.load_config(name), stage)
        tm, tt = CBT.stage_blocks(CBT.load_config(name), stage)
        assert dict(tm) == dict(jm) and dict(tt) == dict(jt)


def test_load_config_file_and_bad_name(tmp_path):
    p = tmp_path / "cfg.py"
    p.write_text("from fgs_nerf_tpu_torch.config.scenes import QUICK_SYNTHETIC"
                 "\nconfig = dict(QUICK_SYNTHETIC, expname='x')\n")
    assert CBT.load_config(str(p))["expname"] == "x"
    with pytest.raises(FileNotFoundError, match="quick_synthetic"):
        CBT.load_config("no_such_config")


@pytest.mark.parametrize("stage", ["geometry_searching", "coarse_train",
                                   "fine_train"])
def test_schedules_over_steps(stage):
    cfg = CBJ.load_config("shiny_blender")
    cfg_train = dict(cfg[stage])
    cfg_train["N_iters"] = 300
    cfg_train["decay_step_module"] = {10: dict(sdf=0.1), 200: dict(k0=0.5)}
    cfg_train["tv_updates"] = {5: dict(sdf_tv=0.3), 250: dict(smooth_grad_tv=0.2)}
    names = {"sdf", "k0", "refnet", "rgbnet", "s_val"}
    lj = SJ.LrState(SJ.initial_lrs(cfg_train, names))
    lt = ST.LrState(ST.initial_lrs(cfg_train, names))
    tvj, tvt = {"sdf_tv": 0.1}, {"sdf_tv": 0.1}
    for step in range(1, 301):
        assert ST.tv_active(step, cfg_train) == SJ.tv_active(step, cfg_train)
        assert ST.inc_bounds(step, cfg_train) == SJ.inc_bounds(step, cfg_train)
        SJ.update_lrs(lj, step, cfg_train)
        ST.update_lrs(lt, step, cfg_train)
        assert lt.lrs == lj.lrs
        assert (ST.apply_tv_updates(tvt, step, cfg_train)
                == SJ.apply_tv_updates(tvj, step, cfg_train))
        assert tvt == tvj


@pytest.mark.parametrize("shapes", [
    ((5, 1, 7, 3), (9, 4, 7)),      # upsample, a size-1 axis, an equal axis
    ((6, 5, 4, 2), (11, 3, 4)),     # up and down
    ((3, 3, 3, 1), (3, 3, 3)),      # identity
])
def test_resize_trilinear(shapes):
    src, new = shapes
    g = np.random.default_rng(0).normal(size=src).astype(np.float32)
    want = np.asarray(IJ.resize_trilinear(jnp.asarray(g), new))
    got = IT.resize_trilinear(_t(g), new).numpy()
    assert got.shape == want.shape == (*new, src[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_max_pool3d_same():
    g = np.random.default_rng(1).normal(size=(7, 6, 5, 2)).astype(np.float32)
    want = np.asarray(IJ.max_pool3d_same(jnp.asarray(g), 3))
    np.testing.assert_array_equal(IT.max_pool3d_same(_t(g), 3).numpy(), want)


def _sdf_grid(cfg_j, seed):
    r = np.random.default_rng(seed)
    ws = cfg_j.world_size
    return (np.asarray(MJ.ball_init_sdf(ws, "coarse"))
            + r.normal(scale=0.2, size=(*ws, 1))).astype(np.float32)


def test_build_sdf_mask_and_bbox_shrink():
    cfg_j, cfg_t = _cfgs("coarse", 18**3)
    sdf = _sdf_grid(cfg_j, 2)
    want = np.asarray(MJ.build_sdf_mask({"sdf": jnp.asarray(sdf)}, cfg_j))
    got = MT.build_sdf_mask({"sdf": _t(sdf)}, cfg_t).numpy()
    assert got.dtype == want.dtype == np.float32
    sm = np.asarray(MJ.smooth_grid(jnp.asarray(sdf), 5, 0.8))
    off = got != want
    assert np.all(np.abs(sm[off] - 0.5) < 1e-5), int(off.sum())
    assert off.mean() < 1e-3
    np.testing.assert_array_equal(
        MT.compute_bbox_from_sdf_mask(want, XYZ_MIN, XYZ_MAX),
        MJ.compute_bbox_from_sdf_mask(want, XYZ_MIN, XYZ_MAX))


def test_scale_volume_grid():
    cfg_j, cfg_t = _cfgs("coarse", 10**3, k0_dim=4)
    new_j, new_t = _cfgs("coarse", 17**3, k0_dim=4)
    r = np.random.default_rng(3)
    p = {"sdf": r.normal(size=(*cfg_j.world_size, 1)).astype(np.float32),
         "k0": r.normal(size=(*cfg_j.world_size, 4)).astype(np.float32)}
    want = MJ.scale_volume_grid({k: jnp.asarray(v) for k, v in p.items()}, new_j)
    got = MT.scale_volume_grid({k: _t(v) for k, v in p.items()}, new_t)
    for k in ("sdf", "k0"):
        assert got[k].shape == (*new_t.world_size, p[k].shape[-1])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("reduce, smooth_scale", [(0.3, True), (1.0, False)])
def test_init_sdf_from_sdf(reduce, smooth_scale):
    cfg_j, cfg_t = _cfgs("fine", 16**3, smooth_scale=smooth_scale)
    src_j, _ = _cfgs("coarse", 11**3)
    sdf0 = _sdf_grid(src_j, 4)
    want = MJ.init_sdf_from_sdf({}, jnp.asarray(sdf0), cfg_j, reduce=reduce)
    got = MT.init_sdf_from_sdf({}, _t(sdf0), cfg_t, reduce=reduce)
    assert got["sdf"].shape == (*cfg_t.world_size, 1)
    np.testing.assert_allclose(got["sdf"].numpy(), np.asarray(want["sdf"]),
                               rtol=0, atol=1e-5)


def _mask_cache_pair(seed, shape=(12, 13, 11)):
    """A prior-stage sdf_mask of 4e-3 (not 1e-3: see the module doc)."""
    r = np.random.default_rng(seed)
    axes = [np.linspace(-1, 1, n) for n in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    inside = (x**2 + y**2 + z**2 < 0.5) | (r.uniform(size=shape) < 0.02)
    sdf_mask = np.where(inside, 4e-3, 0.0).astype(np.float32)[..., None]
    pmin, pmax = XYZ_MIN * 1.05, XYZ_MAX * 1.05
    return (MJ.build_mask_cache(jnp.asarray(sdf_mask), pmin, pmax),
            MT.build_mask_cache(_t(sdf_mask), pmin, pmax))


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_set_nonempty_mask(stage):
    cfg_j, cfg_t = _cfgs(stage, 20**3)
    box_j, box_t = _boxes()
    mc_j, mc_t = _mask_cache_pair(5)
    sdf = _sdf_grid(cfg_j, 6)
    pj, bj = MJ.set_nonempty_mask({"sdf": jnp.asarray(sdf)},
                                  {"mask_cache": mc_j}, cfg_j, box_j)
    pt, bt = MT.set_nonempty_mask({"sdf": _t(sdf)}, {"mask_cache": mc_t},
                                  cfg_t, box_t)
    want = np.asarray(bj["nonempty_mask"])
    got = bt["nonempty_mask"].numpy()
    assert got.shape == want.shape and 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pt["sdf"].numpy(), np.asarray(pj["sdf"]))


def test_maskout_near_cam_vox():
    cfg_j, cfg_t = _cfgs("geometry_searching", 22**3)
    box_j, box_t = _boxes()
    r = np.random.default_rng(7)
    cams = r.uniform(-1.5, 1.5, size=(5, 3)).astype(np.float32)
    sdf = _sdf_grid(cfg_j, 8)
    near = 0.6
    want = np.asarray(MJ.maskout_near_cam_vox({"sdf": jnp.asarray(sdf)},
                                              jnp.asarray(cams), near, cfg_j,
                                              box_j)["sdf"])
    got = MT.maskout_near_cam_vox({"sdf": _t(sdf)}, _t(cams), near, cfg_t,
                                  box_t)["sdf"].numpy()
    assert 0 < (want == 5.0).mean() < 0.5
    nodes = np.asarray(MJ._grid_nodes(cfg_j.world_size, box_j))
    dist = np.sqrt(((nodes[..., None, :] - cams) ** 2).sum(-1)).min(-1)
    off = (got != want)[..., 0]
    assert np.all(np.abs(dist[off] - near) < 1e-5), int(off.sum())
    np.testing.assert_allclose(
        MT._grid_nodes(cfg_t.world_size, box_t).numpy(), nodes, rtol=0,
        atol=3e-7)


def test_voxel_count_views():
    cfg_j, cfg_t = _cfgs("coarse", 14**3)
    data = synth_j(n_views=3, h=12, w=12, n_test=1)
    conv = dict(ndc=False, inverse_y=False, flip_x=False, flip_y=False)
    _, o, d, _ = RJ.get_training_rays(data["images"][:3], data["poses"][:3],
                                      data["HW"][:3], data["Ks"][:3], **conv)
    box = (np.array([-0.7] * 3, np.float32), np.array([0.7] * 3, np.float32))
    box_j, box_t = SceneBoxJ.create(*box), SceneBox.create(*box, "cpu")
    want = np.asarray(MJ.voxel_count_views(cfg_j, box_j, o, d, 2.0, 6.0, 0.5))
    got = MT.voxel_count_views(cfg_t, box_t, o, d, 2.0, 6.0, 0.5).numpy()
    assert got.shape == want.shape and want.max() == 3
    # each count is a `weight > 1` test on a sum of trilinear weights; a
    # reassociated sum can cross 1 only for a handful of voxels
    assert np.mean(got != want) < 5e-3


def test_training_rays_and_batches():
    data = make_synthetic_dataset(n_views=3, h=16, w=20, n_test=1)
    args = (data["images"][:3], data["poses"][:3], data["HW"][:3],
            data["Ks"][:3])
    conv = dict(ndc=False, inverse_y=False, flip_x=False, flip_y=False)
    for fn_t, fn_j in ((RT.get_training_rays, RJ.get_training_rays),
                       (RT.get_training_rays_flatten,
                        RJ.get_training_rays_flatten)):
        for a, b in zip(fn_t(*args, **conv), fn_j(*args, **conv)):
            np.testing.assert_array_equal(a, b)
    gt, gj = (RT.batch_index_generator(50, 16, seed=3),
              RJ.batch_index_generator(50, 16, seed=3))
    for _ in range(10):
        np.testing.assert_array_equal(next(gt), next(gj))


def test_maskcache_ray_filter_keep_set():
    data = make_synthetic_dataset(n_views=4, h=24, w=24, n_test=1)
    args = (data["images"][:4], data["poses"][:4], data["HW"][:4],
            data["Ks"][:4])
    conv = dict(ndc=False, inverse_y=False, flip_x=False, flip_y=False)
    cfg_j, cfg_t = _cfgs("coarse", 20**3)
    box_j, box_t = _boxes()
    mc_j, mc_t = _mask_cache_pair(9)
    keep_j = RJ.make_maskcache_pixel_filter(
        box_j, cfg_j.world_size, cfg_j.stepsize, cfg_j.voxel_size,
        lambda pts: MJ.mask_cache_query(mc_j, pts, 1e-3))
    keep_t = RT.make_maskcache_pixel_filter(
        box_t, cfg_t.world_size, cfg_t.stepsize, cfg_t.voxel_size,
        lambda pts: MT.mask_cache_query(mc_t, pts, 1e-3))
    *rays_j, ratio_j = RJ.get_training_rays_in_maskcache(
        *args, **conv, keep_fn=keep_j, near=2.0, far=6.0, chunk=1024)
    *rays_t, ratio_t = RT.get_training_rays_in_maskcache(
        *args, **conv, keep_fn=keep_t, near=2.0, far=6.0, chunk=1024)
    assert 0.05 < ratio_j < 0.95
    # pixels whose deciding sample sits on the cache's 1e-3 contour may
    # flip under reassociation: at most 0.5% of the pixels
    assert abs(ratio_t - ratio_j) <= 5e-3
    if ratio_t == ratio_j:
        for a, b in zip(rays_t, rays_j):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("half_res", [False, True])
def test_blender_loader_matches_jax(tmp_path, half_res):
    """A Blender-format capture on disk (RGBA PNGs written by the port's
    writer): the port's dispatcher and loader against the JAX package's
    (which reads with imageio, and halves with OpenCV's INTER_AREA, whose
    exact-2x case is the 2 x 2 mean the port takes; float32 means of four
    values: within 1e-6)."""
    import json

    from fgs_nerf_tpu.config.base import Cfg
    from fgs_nerf_tpu.data.dataset import load_dataset as load_dataset_j
    from fgs_nerf_tpu_torch.config.base import Cfg as CfgT
    from fgs_nerf_tpu_torch.data.dataset import load_dataset as load_dataset_t
    from fgs_nerf_tpu_torch.eval.image_io import write_png

    r = np.random.default_rng(10)
    for split in ("train", "val", "test"):
        frames = []
        for i in range(3 if split == "train" else 1):
            name = f"r_{split}_{i}"
            write_png(str(tmp_path / f"{name}.png"),
                      r.integers(0, 256, size=(12, 16, 4), dtype=np.uint8))
            c2w = np.eye(4)
            c2w[:3, 3] = r.normal(size=3) + [0.0, 0.0, 4.0]
            frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
        (tmp_path / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    data = dict(datadir=str(tmp_path), dataset_type="blender", white_bkgd=True,
                half_res=half_res, testskip=1, inverse_y=False, flip_x=False,
                flip_y=False, ndc=False)
    want = load_dataset_j(Cfg(dict(data=data)))
    got = load_dataset_t(CfgT(dict(data=data)))
    assert set(got) <= set(want)
    for key, val in got.items():
        if isinstance(val, np.ndarray) and val.dtype.kind == "f":
            np.testing.assert_allclose(val, want[key], rtol=0, atol=1e-6,
                                       err_msg=key)
        elif isinstance(val, np.ndarray):
            np.testing.assert_array_equal(val, want[key], err_msg=key)
        else:
            assert val == want[key], key
