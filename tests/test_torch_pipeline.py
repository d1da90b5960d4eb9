"""The port's training pipeline on the CPU: checkpoint interop with the
JAX package in both directions, one geometry stage against the JAX
stage, the three stages end to end with evaluation, and the CLI.

Sizes are those of ``tests/test_pipeline_smoke.py`` (16^3 / 20^3 / 24^3
grids, 256 rays per step, 6 views of 40 x 40); the end-to-end run cuts
the step counts further, keeping one pg_scale rung per stage.

Tolerances and why (stage parity): both stages start from the same
weights (the JAX initial and reset refnets are injected into the port)
and draw the same rays (numpy ``default_rng(seed)`` on both sides).  The
JAX CPU path differentiates the bf16 shading head with float32
cotangents where the port rounds them to bf16 as the TPU kernel does
(ROADMAP §C), so per-step losses agree to 1e-3 relative; after four
Adam steps, whose first steps are ``lr * g / (|g| + 1e-8)`` and so move
a parameter by about ``lr`` whatever the size of its gradient, the
parameters agree to relative L2 2e-2 of their change over the stage.
"""
import dataclasses
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest

from fgs_nerf_tpu.config.base import Cfg as CfgJ
from fgs_nerf_tpu.config.base import deep_update as deep_update_j
from fgs_nerf_tpu.config.base import load_config as load_config_j
from fgs_nerf_tpu.data.synthetic import make_synthetic_dataset as synth_j
from fgs_nerf_tpu.eval.evaluator import rebuild_model as rebuild_model_j
from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.optim.masked_adam import AdamState as AdamStateJ
from fgs_nerf_tpu.train import bbox as bbox_j
from fgs_nerf_tpu.train import checkpoint as ckpt_j
from fgs_nerf_tpu.train import trainer as TJ

from fgs_nerf_tpu_torch.config.base import load_config
from fgs_nerf_tpu_torch.convert import params_from_jax, params_to_numpy
from fgs_nerf_tpu_torch.data.dataset import load_dataset
from fgs_nerf_tpu_torch.eval.evaluator import evaluate_checkpoint, rebuild_model
from fgs_nerf_tpu_torch.eval.image_io import read_png, write_png
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.train import checkpoint as ckpt_t
from fgs_nerf_tpu_torch.train import trainer as TT
from fgs_nerf_tpu_torch.train.pipeline import run_training

REPO = Path(__file__).resolve().parents[1]

TINY = dict(
    data=dict(dataset_type="synthetic", synthetic_views=6, synthetic_hw=40,
              synthetic_test=1),
    geometry_searching=dict(
        N_iters=25, N_rand=256, pg_scale=[6], reset_iter=[6], inc_steps=8,
        save_iter=10**9, decay_step_module={},
    ),
    geometry_searching_model=dict(num_voxels=16**3, num_voxels_base=16**3,
                                  shade_k=32),
    coarse_train=dict(
        N_iters=12, N_rand=256, pg_scale=[5], save_iter=10**9,
        decay_step_module={}, tv_updates={},
    ),
    coarse_model=dict(num_voxels=20**3, num_voxels_base=20**3, shade_k=32),
    fine_train=dict(
        N_iters=10, N_rand=256, pg_scale=[], save_iter=10**9,
        decay_step_module={},
    ),
    fine_model=dict(num_voxels=24**3, num_voxels_base=24**3, shade_k=32),
)
E2E_ITERS = {"geometry_searching": 8, "coarse": 5, "fine": 4}

_CONFIG_FILE = """\
from fgs_nerf_tpu_torch.config.base import deep_update
from fgs_nerf_tpu_torch.config.scenes import SHINY_BLENDER
config = deep_update(SHINY_BLENDER, {tiny!r})
"""


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's three stages on the TINY scene, then its evaluation."""
    root = tmp_path_factory.mktemp("pipeline")
    cfg_path = root / "tiny_config.py"
    cfg_path.write_text(_CONFIG_FILE.format(tiny=TINY))
    cfg = load_config(str(cfg_path))
    data = load_dataset(cfg)
    out = root / "run"
    results = run_training(cfg, data, str(out), i_print=2,
                           n_iters_override=E2E_ITERS, device="cpu")
    stats, mesh_path = evaluate_checkpoint(
        results["fine"].ckpt_path, cfg, data, str(out), mesh_resolution=32,
        device="cpu")
    return dict(root=root, cfg_path=cfg_path, cfg=cfg, data=data, out=out,
                results=results, stats=stats, mesh_path=mesh_path)


def test_full_pipeline_and_eval(trained):
    results = trained["results"]
    assert set(results) == {"geometry_searching", "coarse", "fine"}
    for stage, res in results.items():
        assert len(res.psnr_history) == E2E_ITERS[stage]
        assert np.isfinite(res.psnr_history).all(), stage
        assert os.path.exists(res.ckpt_path), stage
        assert res.cfg_model.stage == stage
    # each later stage trained on the rays of the geometry stage's mask cache
    for stage in ("coarse", "fine"):
        assert 0.0 < results[stage].kept_ratio < 1.0
    fine = ckpt_t.load_checkpoint(results["fine"].ckpt_path)
    assert fine.global_step == E2E_ITERS["fine"]
    assert tuple(fine.params["sdf"].shape[:3]) == results["fine"].cfg_model.world_size
    stats = trained["stats"]
    assert np.isfinite(stats["psnr"]).all() and len(stats["psnr"]) == 1
    rgb = stats["rgbs"][0]
    assert rgb.shape == (40, 40, 3) and rgb.min() >= 0.0 and rgb.max() <= 1.0
    assert os.path.getsize(trained["mesh_path"]) > 0
    pngs = list((trained["out"] / "render_test_eval").glob("*.png"))
    # render, gt, error strip, normal, depth, background
    assert len(pngs) == 6


def test_port_checkpoint_loads_in_jax(trained):
    path = trained["results"]["fine"].ckpt_path
    geo = os.path.join(os.path.dirname(path), "geometry_searching_last.npz")
    want = params_to_numpy(trained["results"]["fine"].params)
    pj, bj, cfg_j, box_j, ck = rebuild_model_j(path, geo)
    assert cfg_j == MJ.SDFModelConfig(
        **dataclasses.asdict(trained["results"]["fine"].cfg_model))
    for name, a in _leaves(want):
        b = dict(_leaves(jax.tree.map(np.asarray, pj)))[name]
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert ck.opt is not None and ck.sdf_mask is not None
    assert "mask_cache" in bj
    # the port reads its own file the same way
    pt, bt, cfg_t, _, _ = rebuild_model(path, geo, device="cpu")
    assert cfg_t == trained["results"]["fine"].cfg_model and "mask_cache" in bt


def test_jax_checkpoint_loads_in_port(tmp_path):
    cfg_j = MJ.make_model_config(
        stage="fine", xyz_min=np.array([-1, -1, -1], np.float32),
        xyz_max=np.array([1, 1, 1], np.float32), num_voxels=9**3,
        num_voxels_base=9**3, stepsize=0.5, rgbnet_width=16, rgbnet_depth=3,
        refnet_width=16, refnet_depth=3, grad_feat=(1.0,), sdf_feat=(1.0,))
    params = MJ.init_params(jax.random.PRNGKey(3), cfg_j)
    r = np.random.default_rng(4)
    moments = jax.tree.map(
        lambda a: r.normal(size=np.shape(a)).astype(np.float32), params)
    opt = AdamStateJ(np.asarray(7, np.int32), moments,
                     jax.tree.map(np.abs, moments))
    sdf_mask = MJ.build_sdf_mask(params, cfg_j)
    path = str(tmp_path / "fine_last.npz")
    ckpt_j.save_checkpoint(
        path, global_step=7, params=params, opt_state=opt, sdf_mask=sdf_mask,
        model_kwargs=dataclasses.asdict(cfg_j),
        xyz_min=np.array([-1, -1, -1], np.float32),
        xyz_max=np.array([1, 1, 1], np.float32), lrs={"sdf": 0.1})
    ck = ckpt_t.load_checkpoint(path)
    assert ck.global_step == 7 and ck.meta["lrs"] == {"sdf": 0.1}
    for name, a in _leaves(jax.tree.map(np.asarray, params)):
        np.testing.assert_array_equal(dict(_leaves(ck.params))[name], a)
    np.testing.assert_array_equal(ck.opt["exp_avg_sq"]["refnet"]["w0"],
                                  np.abs(moments["refnet"]["w0"]))
    np.testing.assert_array_equal(ck.sdf_mask, np.asarray(sdf_mask))
    pt, _, cfg_t, box_t, _ = rebuild_model(path, device="cpu")
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    np.testing.assert_array_equal(pt["rgbnet"]["w1"].numpy(),
                                  np.asarray(params["rgbnet"]["w1"]))
    np.testing.assert_array_equal(box_t.xyz_max.numpy(), np.ones(3, np.float32))


def test_geometry_stage_matches_jax(tmp_path, monkeypatch):
    """Four geometry steps with a pg_scale rung and a refnet reset at
    step 3, the port against the JAX stage (tolerances: module doc)."""
    tiny = deep_update_j(TINY, dict(geometry_searching=dict(
        pg_scale=[3], reset_iter=[3])))
    cfg_j = CfgJ(deep_update_j(dict(load_config_j("shiny_blender")), tiny))
    cfg_t = load_config("shiny_blender")
    cfg_t.update(deep_update_j(dict(cfg_t), tiny))
    data = synth_j(n_views=6, h=40, w=40, n_test=1)
    xyz_min, xyz_max = bbox_j.compute_bbox_by_cam_frustrm(cfg_j, data)
    seed = 777
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    key, k_reset = jax.random.split(key)

    def jcfg(cfg):
        return MJ.SDFModelConfig(**dataclasses.asdict(cfg))

    def init_params(gen, cfg, device=None):
        return params_from_jax(
            jax.tree.map(np.asarray, MJ.init_params(k_init, jcfg(cfg))), device)

    def reset_refnet(params, gen, cfg):
        ref = MJ.reset_refnet({}, k_reset, jcfg(cfg))["refnet"]
        return {**params, "refnet": params_from_jax(
            jax.tree.map(np.asarray, ref), params["sdf"].device)}

    losses = {"jax": [], "port": []}

    def recorder(make, side):
        def make_step(*a, **kw):
            step = make(*a, **kw)

            def run(*args):
                out = step(*args)
                losses[side].append(float(out[2]["loss"]))
                return out
            return run
        return make_step

    monkeypatch.setattr(MT, "init_params", init_params)
    monkeypatch.setattr(MT, "reset_refnet", reset_refnet)
    monkeypatch.setattr(TJ, "make_train_step",
                        recorder(TJ.make_train_step, "jax"))
    monkeypatch.setattr(TT, "make_train_step",
                        recorder(TT.make_train_step, "port"))
    kw = dict(i_print=1, n_iters_override=4, seed=seed)
    res_j = TJ.train_stage(cfg_j, "geometry_searching", data, xyz_min,
                           xyz_max, str(tmp_path / "jax"), **kw)
    res_t = TT.train_stage(cfg_t, "geometry_searching", data, xyz_min,
                           xyz_max, str(tmp_path / "port"), device="cpu",
                           **kw)
    assert res_t.cfg_model == MT.SDFModelConfig(**dataclasses.asdict(res_j.cfg_model))
    assert len(losses["jax"]) == len(losses["port"]) == 4
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-3)
    # the starting point of the final rung, for the change over the stage
    start = jax.tree.map(np.asarray, MJ.scale_volume_grid(
        jax.tree.map(np.asarray, MJ.init_params(k_init, jcfg(res_t.cfg_model))),
        res_j.cfg_model))
    got = dict(_leaves(params_to_numpy(res_t.params)))
    start = dict(_leaves(start))
    for name, want in _leaves(jax.tree.map(np.asarray, res_j.params)):
        if name == "s_val":
            np.testing.assert_array_equal(got[name], want)
            continue
        change = max(np.linalg.norm(want - start[name]), 1e-6)
        err = np.linalg.norm(got[name] - want) / change
        assert err < 2e-2, (name, err)


def _cli(*args, cwd=REPO, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "fgs_nerf_tpu_torch.run", *args], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=600)


def test_cli_eval_mode(trained, tmp_path):
    out = _cli("--mode", "eval", "--config", str(trained["cfg_path"]),
               "--expname", "run", "--output_dir", str(trained["root"]),
               "--device", "cpu", "--mesh_resolution", "24", "--eval_ssim", "0",
               cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Testing psnr" in out.stderr
    assert (trained["out"] / "meshes" / "eval.ply").is_file()


def test_cli_eval_mode_with_lpips(trained, tmp_path):
    """``--eval_lpips 1`` runs LPIPS(alex) on the test view (40 x 40, on
    the seed-0 fallback weights, which warn once) and exits cleanly."""
    env_extra = {"FGS_LPIPS_WEIGHTS": "", "FGS_LPIPS_FALLBACK": "1"}
    out = _cli("--mode", "eval", "--config", str(trained["cfg_path"]),
               "--expname", "run", "--output_dir", str(trained["root"]),
               "--device", "cpu", "--mesh_resolution", "24", "--eval_ssim", "0",
               "--eval_lpips", "1", cwd=tmp_path, env_extra=env_extra)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RANDOM-FEATURE fallback" in out.stderr
    assert "Testing psnr" in out.stderr


def test_cli_bad_config_lists_builtins(tmp_path):
    out = _cli("--config", "no_such_scene", "--device", "cpu",
               "--output_dir", str(tmp_path), cwd=tmp_path)
    assert out.returncode != 0
    assert "quick_synthetic" in out.stderr and "Traceback" not in out.stderr


def test_cli_untrained_expname_exits_cleanly(trained, tmp_path):
    out = _cli("--mode", "eval", "--config", str(trained["cfg_path"]),
               "--expname", "never_trained", "--output_dir", str(tmp_path),
               "--device", "cpu", cwd=tmp_path)
    assert out.returncode != 0
    assert "no checkpoint found" in out.stderr
    assert "Traceback" not in out.stderr


def test_cli_refuses_what_is_not_ported(tmp_path):
    """A ``--mesh dp=2`` in one process (no launcher: a world of one)
    exits naming the ranks it needs (A9 runs under
    ``torch.distributed.run``); the DVGO geometry search (A8) and the
    LLFF loader (A10) run."""
    from fgs_nerf_tpu_torch import run as R
    from fgs_nerf_tpu_torch.data.synthetic import make_synthetic_dataset

    with pytest.raises(SystemExit, match="needs 2 ranks"):
        R.main(["--mesh", "dp=2", "--device", "cpu"])
    cfg = load_config("quick_synthetic")
    cfg.update(deep_update_j(dict(cfg), dict(
        dvgo=dict(N_iters=2, N_rand=64, pervoxel_lr=False),
        dvgo_model=dict(num_voxels=12**3, num_voxels_base=12**3,
                        sample_k=0))))
    res = run_training(cfg, make_synthetic_dataset(n_views=3, h=16, w=16,
                                                   n_test=1),
                       str(tmp_path / "dvgo"), stages=("geometry_searching",),
                       dvgo_init=True, device="cpu")
    ck = ckpt_t.load_checkpoint(res["geometry_searching"].ckpt_path)
    assert set(ck.params) == {"density", "k0"} and ck.sdf_mask is not None
    root = tmp_path / "llff"
    (root / "images").mkdir(parents=True)
    rows = np.zeros((3, 17))
    for i in range(3):
        write_png(str(root / "images" / f"{i}.png"),
                  np.full((8, 12, 3), 40 * i, np.uint8))
        pose = np.concatenate([np.eye(3), [[0.1 * i], [0.0], [0.0]],
                               [[8.0], [12.0], [10.0]]], 1)
        rows[i] = np.concatenate([pose.reshape(-1), [1.0, 4.0]])
    np.save(root / "poses_bounds.npy", rows)
    cfg = load_config("dtu")
    cfg["data"]["dataset_type"] = "llff"
    cfg["data"]["datadir"] = str(root)
    data = load_dataset(cfg)
    assert data["images"].shape == (3, 8, 12, 3)
    assert list(data["i_test"]) == [0]


def _png_chunks(data):
    pos, out = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        out.setdefault(data[pos + 4:pos + 8], []).append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return out


@pytest.mark.parametrize("channels", [1, 3])
def test_png_write_then_zlib_decode(tmp_path, channels):
    """The render dumps' PNG writer, decoded here with zlib alone."""
    img = np.random.default_rng(channels).integers(
        0, 256, size=(17, 23, channels), dtype=np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), img[..., 0] if channels == 1 else img)
    ch = _png_chunks(path.read_bytes())
    w, h, depth, ctype = struct.unpack(">IIBB", ch[b"IHDR"][0][:10])
    assert (w, h, depth, ctype) == (23, 17, 8, 0 if channels == 1 else 2)
    raw = np.frombuffer(zlib.decompress(b"".join(ch[b"IDAT"])), np.uint8)
    raw = raw.reshape(17, 1 + 23 * channels)
    assert (raw[:, 0] == 0).all()  # filter type 0 on every row
    np.testing.assert_array_equal(raw[:, 1:].reshape(img.shape), img)
    np.testing.assert_array_equal(read_png(str(path)).reshape(img.shape), img)


def test_png_read_every_row_filter(tmp_path):
    """read_png undoes the five PNG row filters (an encoder written here)."""
    img = np.random.default_rng(5).integers(0, 256, size=(10, 7, 4),
                                            dtype=np.uint8)
    c, stride = 4, 7 * 4
    prev = np.zeros(stride, np.int16)
    rows = []
    for y in range(10):
        cur = img[y].reshape(-1).astype(np.int16)
        left = np.concatenate([np.zeros(c, np.int16), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int16), prev[:-c]])
        ft = y % 5
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    path = tmp_path / "f.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 10, 8, 6, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                     + chunk(b"IEND", b""))
    np.testing.assert_array_equal(read_png(str(path)), img)


def test_resume_continues_from_saved_rung(tmp_path):
    """The port's resume, as ``tests/test_resume.py`` checks the JAX one:
    params, Adam state, LR state and the pg_scale rung come back from the
    mid-stage checkpoint, and only the remaining steps run."""
    cfg = load_config("shiny_blender")
    cfg.update(deep_update_j(dict(cfg), dict(
        geometry_searching=dict(N_iters=8, N_rand=128, pg_scale=[3],
                                reset_iter=[], inc_steps=4, save_iter=5,
                                decay_step_module={}),
        geometry_searching_model=dict(num_voxels=14**3, num_voxels_base=14**3,
                                      shade_k=16))))
    data = synth_j(n_views=4, h=24, w=24, n_test=1)
    xyz_min, xyz_max = bbox_j.compute_bbox_by_cam_frustrm(cfg, data)
    kw = dict(seed=3, i_print=1, device="cpu")
    res1 = TT.train_stage(cfg, "geometry_searching", data, xyz_min, xyz_max,
                          str(tmp_path), n_iters_override=5, **kw)
    saved = ckpt_t.load_checkpoint(res1.ckpt_path)
    # Adam restarts at the rung (step 3): steps 3..5 are in its count
    assert saved.global_step == 5 and int(saved.opt["step"]) == 3
    res2 = TT.train_stage(cfg, "geometry_searching", data, xyz_min, xyz_max,
                          str(tmp_path), n_iters_override=8, resume=True, **kw)
    assert res2.cfg_model.world_size == res1.cfg_model.world_size
    assert tuple(res2.params["sdf"].shape[:3]) == res1.cfg_model.world_size
    assert len(res2.psnr_history) == 3  # steps 6..8 only
    assert np.isfinite(res2.psnr_history).all()
    final = ckpt_t.load_checkpoint(res2.ckpt_path)
    assert final.global_step == 8 and int(final.opt["step"]) == 6


def test_cli_render_only_and_only_mesh(trained):
    """``--render_only`` renders the loader's render_poses (frames; the
    mp4 encode is optional) and ``--only_mesh`` skips the test renders."""
    from fgs_nerf_tpu_torch import run as R

    common = ["--config", str(trained["cfg_path"]), "--expname", "run",
              "--output_dir", str(trained["root"]), "--device", "cpu"]
    R.main(common + ["--render_only"])
    frames = list((trained["out"] / "render_path").glob("*render_*.png"))
    assert len(frames) == len(trained["data"]["render_poses"])
    mesh = trained["out"] / "meshes" / "eval.ply"
    mesh.unlink()
    R.main(common + ["--mode", "eval", "--only_mesh", "--mesh_resolution",
                     "16"])
    assert mesh.is_file()
