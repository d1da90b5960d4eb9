"""A user's capture through the port against the JAX package (CPU): the
capture that ``chip_smoke.py`` phase 22 writes (its bytes, its COLMAP
rotations), the capture -> ``run_colmap`` -> LLFF loader -> geometry,
coarse and fine stages, the pose helpers of ``data/rays.py`` and the
profiling module.

Tolerances and why: both packages' ``run_colmap`` and LLFF loaders are
the same numpy code on the same bytes, so images must be equal and
poses, near / far and the frustum bbox agree to 1e-6; the geometry
stage's loss and PSNR histories are held to ``rtol 1e-3``, the bound of
``tests/test_torch_pipeline.py``'s geometry-stage parity (float32 sums
in another order over a few steps).  The pose helpers are the same
numpy / scipy code: 1e-6.

The coarse and fine stages start from the JAX checkpoints, so each is
held on its own:
* the mask-cache ray filter: the jitted JAX filter rounds a sample
  position differently from its own op-by-op arithmetic (which the port
  matches), so a pixel whose samples graze a bbox face or the threshold
  can go either way: at most two on each side;
* the mask cache's threshold: the geometry checkpoint's ``sdf_mask``
  holds 1e-3 wherever ``sdf < 0.5`` and the reference keeps a point at
  an interpolated ``>= 1e-3``, so on that plateau rounding decides (a
  reference behaviour, ROADMAP §C, held by
  ``test_capture_mask_cache_threshold_tie``).  The histories therefore
  run the coarse and fine mask caches at 3e-4, away from the plateau's
  tie, and take the JAX filter's rays;
* the first step's loss: the forward on equal inputs, ``rtol 1e-3``
  (the coarse head's bf16 products as in ``tests/test_torch_coarse_step.py``);
* the later steps: Adam's first steps divide by ``|g| + eps``, so the
  gradients' bf16 and summation-order differences become lr-sized
  parameter differences where ``|g|`` is small
  (``tests/test_torch_fine_step.py``) and the losses and PSNRs of the
  next steps differ by a few 1e-3: ``rtol 1e-2``.
"""
import dataclasses
import hashlib
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from fgs_nerf_tpu.config.base import Cfg as CfgJ
from fgs_nerf_tpu.config.base import deep_update as deep_update_j
from fgs_nerf_tpu.config.base import load_config as load_config_j
from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.data import colmap as CJ
from fgs_nerf_tpu.data import rays as RJ
from fgs_nerf_tpu.data.dataset import load_dataset as load_dataset_j
from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.train import bbox as bbox_j
from fgs_nerf_tpu.train import trainer as TJ
from fgs_nerf_tpu.train.pipeline import run_training as run_training_j

from fgs_nerf_tpu_torch import run_colmap as RCT
from fgs_nerf_tpu_torch.config.base import load_config
from fgs_nerf_tpu_torch.convert import params_from_jax
from fgs_nerf_tpu_torch.data import rays as RT
from fgs_nerf_tpu_torch.data.dataset import load_dataset
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.train import bbox as bbox_t
from fgs_nerf_tpu_torch.train import trainer as TT
from fgs_nerf_tpu_torch.utils import profiling as PFT

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402
import run_colmap as RCJ  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _random_rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return [CJ.qvec2rotmat(v / np.linalg.norm(v)) for v in q]


def test_rotmat2qvec_inverts_qvec2rotmat():
    """The capture writer's rotations round-trip through COLMAP's
    quaternions, on each of the writer's four branches (the largest of
    w, x, y, z) and on random rotations."""
    turns = [np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
             np.diag([-1.0, -1.0, 1.0]), np.eye(3)]
    for r in turns + _random_rotations(64, 1):
        q = CS.rotmat2qvec(r)
        assert q[0] >= 0 and abs(np.linalg.norm(q) - 1) < 1e-12
        np.testing.assert_allclose(CJ.qvec2rotmat(q), r, atol=1e-12)
    for v in np.random.default_rng(2).normal(size=(32, 4)):
        v = v / np.linalg.norm(v)
        np.testing.assert_allclose(CS.rotmat2qvec(CJ.qvec2rotmat(v)),
                                   v * np.sign(v[0]), atol=1e-12)


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_capture_writes_are_byte_equal_and_convert(tmp_path):
    """Two writes of a capture give the same bytes; converted by the
    port's ``run_colmap``, the LLFF cameras are the written ones up to one
    similarity (``check_capture_conversion``, phase 22's check), and a
    capture whose camera axes are flipped fails that check."""
    a, b = tmp_path / "a", tmp_path / "b"
    centres, rots = CS.write_capture(str(a), n_views=8, hw=(24, 32),
                                     n_points=300)
    CS.write_capture(str(b), n_views=8, hw=(24, 32), n_points=300)
    da = _digest(a)
    assert len(da) == 8 + 3 and da == _digest(b)
    assert RCT.main(["--custom_dataset_path", str(a), "--skip_masks"]) == 0
    line = CS.check_capture_conversion(str(a), centres, rots)
    assert line["centre_err_rel"] <= 1e-4 and line["axis_err"] <= 1e-4
    with pytest.raises(RuntimeError, match="not the capture's"):
        CS.check_capture_conversion(str(a), centres, -rots)


# the mask cache's threshold of the coarse and fine histories: off the
# handoff's 1e-3 plateau (module doc)
TIE_FREE = 3e-4
STEPS = dict(geometry_searching=4, coarse=4, fine=4)
TINY = dict(
    geometry_searching=dict(
        N_iters=4, N_rand=256, pg_scale=[3], reset_iter=[3], inc_steps=8,
        save_iter=10**9, decay_step_module={},
    ),
    geometry_searching_model=dict(num_voxels=16**3, num_voxels_base=16**3,
                                  shade_k=32),
    coarse_train=dict(N_iters=4, N_rand=256, pg_scale=[], save_iter=10**9,
                      decay_step_module={}, tv_updates={}),
    coarse_model=dict(num_voxels=20**3, num_voxels_base=20**3, shade_k=64,
                      sample_k=96, mask_cache_thres=TIE_FREE),
    fine_train=dict(N_iters=4, N_rand=256, pg_scale=[], save_iter=10**9,
                    decay_step_module={}),
    fine_model=dict(num_voxels=24**3, num_voxels_base=24**3, shade_k=64,
                    sample_k=128, mask_cache_thres=TIE_FREE),
)


def _host(tree):
    """A host copy of a step's params or buffers (the JAX step donates
    its inputs; the port's are tensors)."""
    return jax.tree.map(lambda v: np.array(
        v.detach().cpu() if hasattr(v, "detach") else v), tree)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A capture of 8 views at 32 x 24 through each package's
    ``run_colmap`` and LLFF loader (``smart_car`` with ``dataset_type``
    llff, as phase 22 trains it); the JAX pipeline's three stages
    (``run_training``: a 4-step geometry stage with a rung and a refnet
    reset at step 3, then 4 coarse and 4 fine steps); the port's geometry
    stage on the same data, and its coarse and fine stages off the JAX
    checkpoints, each step drawing from the rays JAX's mask-cache filter
    kept.  Both sides start every stage from the JAX initial weights.
    Records each step's loss and starting params / buffers, and each
    filter's rays."""
    tmp = tmp_path_factory.mktemp("capture_chain")
    roots = {}
    for side, main in (("port", RCT.main), ("jax", RCJ.main)):
        roots[side] = tmp / side
        CS.write_capture(str(roots[side]), n_views=8, hw=(24, 32),
                         n_points=300)
        assert main(["--custom_dataset_path", str(roots[side]),
                     "--skip_masks"]) == 0
    cfg_j = CfgJ(deep_update_j(dict(load_config_j("smart_car")), deep_update_j(
        TINY, dict(data=dict(dataset_type="llff",
                             datadir=str(roots["jax"]))))))
    cfg_t = load_config("smart_car")
    cfg_t.update(deep_update_j(dict(cfg_t), deep_update_j(
        TINY, dict(data=dict(dataset_type="llff",
                             datadir=str(roots["port"]))))))
    data_j, data_t = load_dataset_j(cfg_j), load_dataset(cfg_t)

    key = jax.random.PRNGKey(777)
    key, k_init = jax.random.split(key)
    key, k_reset = jax.random.split(key)

    def jcfg(cfg):
        return MJ.SDFModelConfig(**dataclasses.asdict(cfg))

    def init_params(gen, cfg, device=None):
        return params_from_jax(jax.tree.map(
            np.asarray, MJ.init_params(k_init, jcfg(cfg))), device)

    def reset_refnet(params, gen, cfg):
        ref = MJ.reset_refnet({}, k_reset, jcfg(cfg))["refnet"]
        return {**params, "refnet": params_from_jax(
            jax.tree.map(np.asarray, ref), params["sdf"].device)}

    out = dict(cfg_j=cfg_j, cfg_t=cfg_t, data_j=data_j, data_t=data_t,
               steps={"jax": [], "port": []}, rays={"jax": [], "port": []})

    def recorder(make, side):
        def make_step(cfg_m, *a, **kw):
            step = make(cfg_m, *a, **kw)

            def run(*args):
                start = (_host(args[0]), _host(args[2]))
                res = step(*args)
                out["steps"][side].append(
                    (cfg_m.stage, float(res[2]["loss"]), start))
                return res
            return run
        return make_step

    def jax_rays(fn):
        def run(*a, **kw):
            res = fn(*a, **kw)
            out["rays"]["jax"].append(
                [np.asarray(x) for x in res[:4]] + [res[4]])
            return res
        return run

    def port_rays(fn):
        def run(*a, **kw):
            out["rays"]["port"].append(list(fn(*a, **kw)))
            return tuple(out["rays"]["jax"][len(out["rays"]["port"]) - 1])
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MT, "init_params", init_params)
        mp.setattr(MT, "reset_refnet", reset_refnet)
        mp.setattr(MJ, "init_params", lambda k, cfg: MJ_INIT(k_init, cfg))
        mp.setattr(MJ, "reset_refnet",
                   lambda p, k, cfg: MJ_RESET(p, k_reset, cfg))
        mp.setattr(TJ, "make_train_step", recorder(TJ.make_train_step, "jax"))
        mp.setattr(TT, "make_train_step",
                   recorder(TT.make_train_step, "port"))
        mp.setattr(RJ, "get_training_rays_in_maskcache",
                   jax_rays(RJ.get_training_rays_in_maskcache))
        mp.setattr(RT, "get_training_rays_in_maskcache",
                   port_rays(RT.get_training_rays_in_maskcache))
        out["res_j"] = run_training_j(cfg_j, data_j, str(tmp / "out_jax"),
                                      n_iters_override=STEPS, i_print=1)
        geo = str(tmp / "out_jax" / "geometry_searching_last.npz")
        coarse = str(tmp / "out_jax" / "coarse_last.npz")
        box_t = bbox_t.compute_bbox_by_cam_frustrm(cfg_t, data_t)
        shrunk = bbox_t.compute_bbox_by_coarse_geo(geo)
        kw = dict(i_print=1, device="cpu")
        out["res_t"] = {
            "geometry_searching": TT.train_stage(
                cfg_t, "geometry_searching", data_t, *box_t,
                str(tmp / "out_port"), n_iters_override=4, seed=777, **kw),
            "coarse": TT.train_stage(
                cfg_t, "coarse", data_t, *shrunk, str(tmp / "out_port"),
                mask_ckpt_path=geo, n_iters_override=4, **kw),
            "fine": TT.train_stage(
                cfg_t, "fine", data_t, *shrunk, str(tmp / "out_port"),
                mask_ckpt_path=geo, coarse_ckpt_path=coarse,
                n_iters_override=4, **kw)}
    out["geo_ckpt"] = geo
    return out


MJ_INIT, MJ_RESET = MJ.init_params, MJ.reset_refnet


def _stage(steps, stage):
    return [(loss, start) for st, loss, start in steps if st == stage]


def test_capture_to_geometry_stage_matches_jax(chain):
    """The capture through each package's ``run_colmap`` and LLFF loader,
    then a 4-step geometry stage with a rung and a refnet reset at step
    3: images equal, cameras, near / far and the frustum bbox to 1e-6,
    the stage's loss and PSNR histories to ``rtol 1e-3``."""
    cfg_j, cfg_t = chain["cfg_j"], chain["cfg_t"]
    data_j, data_t = chain["data_j"], chain["data_t"]
    np.testing.assert_array_equal(np.asarray(data_t["images"]),
                                  np.asarray(data_j["images"]))
    for k in ("poses", "Ks", "render_poses", "near", "far"):
        np.testing.assert_allclose(np.asarray(data_t[k], np.float64),
                                   np.asarray(data_j[k], np.float64), **TOL)
    for k in ("HW", "i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(np.asarray(data_t[k]),
                                      np.asarray(data_j[k]))
    box_j = bbox_j.compute_bbox_by_cam_frustrm(cfg_j, data_j)
    box_t = bbox_t.compute_bbox_by_cam_frustrm(cfg_t, data_t)
    for got, want in zip(box_t, box_j):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)

    res_j = chain["res_j"]["geometry_searching"]
    res_t = chain["res_t"]["geometry_searching"]
    assert res_t.cfg_model == MT.SDFModelConfig(
        **dataclasses.asdict(res_j.cfg_model))
    losses = {side: [loss for loss, _ in _stage(chain["steps"][side],
                                                 "geometry_searching")]
              for side in ("jax", "port")}
    assert len(losses["jax"]) == len(losses["port"]) == 4
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-3)
    np.testing.assert_allclose(res_t.psnr_history, res_j.psnr_history,
                               rtol=1e-3)
    assert np.isfinite(losses["port"]).all()


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_capture_coarse_and_fine_stages_match_jax(chain, stage):
    """The coarse and fine stages of the capture off the JAX checkpoints:
    the shrunk bbox and grid; the port's own mask-cache ray filter keeps
    the JAX filter's pixels but for at most two on each side (rounding at
    a bbox face or a threshold, module doc); the first step's mask
    buffers equal, its params equal (coarse: free space pushed to +1) or
    warm-started from the coarse SDF within 1e-5 (fine); on the JAX
    filter's rays, the first step's loss to ``rtol 1e-3`` and the loss
    and PSNR histories to ``rtol 1e-2`` (module doc)."""
    res_j, res_t = chain["res_j"][stage], chain["res_t"][stage]
    np.testing.assert_allclose(res_t.box.xyz_min.numpy(),
                               np.asarray(res_j.box.xyz_min), **TOL)
    np.testing.assert_allclose(res_t.box.xyz_max.numpy(),
                               np.asarray(res_j.box.xyz_max), **TOL)
    assert res_t.cfg_model == MT.SDFModelConfig(
        **dataclasses.asdict(res_j.cfg_model))
    k = ("coarse", "fine").index(stage)
    own, theirs = chain["rays"]["port"][k], chain["rays"]["jax"][k]
    rows = [{tuple(r) for r in np.concatenate(x[1:3], 1)}
            for x in (own, theirs)]
    assert len(rows[1]) > 1000
    assert len(rows[0] - rows[1]) <= 2 and len(rows[1] - rows[0]) <= 2
    assert abs(own[4] - theirs[4]) * len(rows[1]) / theirs[4] <= 2

    steps = {side: _stage(chain["steps"][side], stage)
             for side in ("jax", "port")}
    assert len(steps["jax"]) == len(steps["port"]) == 4
    (p_j, b_j), (p_t, b_t) = steps["jax"][0][1], steps["port"][0][1]
    np.testing.assert_array_equal(b_t["nonempty_mask"], b_j["nonempty_mask"])
    for name in ("grid", "xyz_min", "xyz_max"):
        np.testing.assert_array_equal(b_t["mask_cache"][name],
                                      b_j["mask_cache"][name])
    np.testing.assert_allclose(p_t["sdf"], p_j["sdf"], rtol=0,
                               atol=1e-6 if stage == "coarse" else 1e-5)
    if stage == "coarse":
        assert (p_t["sdf"] == 1.0).any() and (p_t["sdf"] != 1.0).any()
    losses = {side: [loss for loss, _ in steps[side]] for side in steps}
    np.testing.assert_allclose(losses["port"][0], losses["jax"][0], rtol=1e-3)
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-2)
    np.testing.assert_allclose(res_t.psnr_history, res_j.psnr_history,
                               rtol=1e-2)


def test_capture_mask_cache_threshold_tie(chain):
    """A reference behaviour (ROADMAP §C): the geometry checkpoint's
    ``sdf_mask`` holds 1e-3 wherever ``sdf < 0.5``, and the mask cache
    keeps a point where its trilinear value is ``>= 1e-3``, so inside
    that plateau float32 rounding of the interpolation decides.  On the
    JAX checkpoint of the capture, at the coarse grid's nodes (the
    handoff's nonempty mask, at the reference's 1e-3): both packages drop
    a share of the plateau's nodes, the same share within 2 points, and
    the nodes where they disagree all lie on the plateau; with a 2^-7
    slack on the threshold (the JAX package's TPU comparison) both keep
    every plateau node."""
    import torch

    from fgs_nerf_tpu.train import checkpoint as ckpt_j

    ck = ckpt_j.load_checkpoint(chain["geo_ckpt"])
    cfg_c = chain["res_t"]["coarse"].cfg_model
    box = chain["res_t"]["coarse"].box
    mc_t = MT.build_mask_cache(torch.as_tensor(np.asarray(ck.sdf_mask)),
                               *ck.box)
    mc_j = MJ.build_mask_cache(jax.numpy.asarray(ck.sdf_mask), *ck.box)
    nodes_t = MT._grid_nodes(cfg_c.world_size, box)
    nodes_j = MJ._grid_nodes(cfg_c.world_size,
                             SceneBoxJ.create(box.xyz_min.numpy(),
                                              box.xyz_max.numpy()))

    def keep(thres):
        return (MT.mask_cache_query(mc_t, nodes_t, thres).numpy(),
                np.asarray(MJ.mask_cache_query(mc_j, nodes_j, thres)))

    lo, hi = keep(1e-3 * (1 - 1e-6))[0], keep(1e-3 * (1 + 1e-6))[0]
    plateau = lo & ~hi
    assert plateau.sum() > 100
    got_t, got_j = keep(1e-3)
    assert not (got_t & ~lo).any() and not (got_j & ~lo).any()
    assert (got_t == got_j)[~plateau].all()
    dropped = [1 - (g & plateau).sum() / plateau.sum() for g in (got_t, got_j)]
    assert min(dropped) > 0.01 and abs(dropped[0] - dropped[1]) < 0.02
    for g in keep(1e-3 * (1 - 2.0**-7)):
        assert g[plateau].all()


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    out = np.zeros((n, 4, 4), np.float32)
    for i, r in enumerate(_random_rotations(n, seed)):
        out[i, :3, :3] = r
        out[i, :3, 3] = rng.normal(size=3)
        out[i, 3, 3] = 1.0
    return out


def test_pose_helpers_match_jax():
    """``slerp`` (its ``so < 1e-8`` branch too), ``interp_pose`` and
    ``get_random_poses`` in both modes over seeds 0-2; an unknown mode
    raises ``NotImplementedError`` in both."""
    rng = np.random.default_rng(4)
    for _ in range(8):
        p0, p1 = rng.normal(size=4), rng.normal(size=4)
        t = float(rng.uniform())
        np.testing.assert_allclose(RT.slerp(p0, p1, t), RJ.slerp(p0, p1, t),
                                   **TOL)
    p0 = np.array([0.5, 0.5, 0.5, 0.5])
    np.testing.assert_allclose(RT.slerp(p0, p0, 0.3), RJ.slerp(p0, p0, 0.3),
                               **TOL)
    np.testing.assert_allclose(RT.slerp(p0, p0, 0.3), p0, **TOL)
    poses = _poses(6, 9)
    for s in (0.0, 0.25, 0.8):
        got = RT.interp_pose(poses[0], poses[1], s)
        assert got.dtype == np.float32 and got.shape == (4, 4)
        np.testing.assert_allclose(got, RJ.interp_pose(poses[0], poses[1], s),
                                   **TOL)
    for seed in range(3):
        for mode, n in (("loaded", 4), ("loaded", 10),
                        ("interpolate_train_all", 5)):
            got = RT.get_random_poses(poses, mode, n, seed=seed)
            want = RJ.get_random_poses(poses, mode, n, seed=seed)
            assert got.shape == want.shape == (min(n, 6) if mode == "loaded"
                                               else n, 4, 4)
            np.testing.assert_allclose(got, want, **TOL)
    for fn in (RT.get_random_poses, RJ.get_random_poses):
        with pytest.raises(NotImplementedError):
            fn(poses, "spiral")


def test_trace_steps_writes_a_trace_and_asks_for_the_card(tmp_path):
    """``trace_steps(..., device="cpu")`` writes a Chrome trace of the
    steps inside it; with the default device, on a machine without a
    card, it raises and writes nothing."""
    import torch

    with PFT.trace_steps(str(tmp_path / "cpu"), device="cpu") as trace:
        x = torch.ones(64, 64)
        (x @ x).sum()
    assert trace.path and os.path.isfile(trace.path)
    assert Path(trace.path).parent == tmp_path / "cpu"
    assert trace.kernel_events() == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with PFT.trace_steps(str(tmp_path / "card")):
                pass
        assert not (tmp_path / "card").exists()
