"""The port's DTU path against the JAX package (CPU): the DTU and
IDR-style loaders, ``read_ply`` and the DTU Chamfer, the coarse shading
head (B3/B4) at the ``dtu`` config's 144 padded input rows, a DTU coarse
head carried over from JAX parameters, the evaluator's Chamfer, and the
branches of ``chip_smoke.py``'s B4 check (no JAX there).

Inputs are made with numpy from fixed seeds; the DTU scans are written
by ``chip_smoke.write_dtu_scan`` (the scan that the card run trains on,
here at 64 x 48 with 12 views), the IDR-style ones by the fixtures of
``tests/test_loaders.py`` (as PNG: the port reads no JPEG).

Tolerances and why: images, masks, splits and scale matrices are the
same arrays (same PNG bytes, same float arithmetic), so equal; the JAX
loaders decompose each projection matrix with OpenCV, the port with
``scipy.linalg.rq`` under OpenCV's sign convention, both in float64 and
stored as float32, so poses, intrinsics, near and far agree to a float32
rounding (held at 1e-5, relative where the value exceeds 1); the Chamfer
sums the same float64 distances (1e-9); B3/B4 as in
``tests/test_torch_fused_shade.py``; the carried-over head's renders as
in ``tests/test_torch_coarse_step.py`` (1e-5).
"""
import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import rq

from fgs_nerf_tpu.config.base import Cfg as CfgJ
from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.data import dtu as DJ
from fgs_nerf_tpu.data.dataset import load_dataset as load_dataset_j
from fgs_nerf_tpu.eval import dtu_chamfer as CJ
from fgs_nerf_tpu.eval import mesh as MeshJ
from fgs_nerf_tpu.models import sdf_voxel as MJ
from fgs_nerf_tpu.ops.pallas import fused_mlp_cm as FJ

from fgs_nerf_tpu_torch import convert
from fgs_nerf_tpu_torch.config.base import Cfg
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.data import dtu as DT
from fgs_nerf_tpu_torch.data.dataset import load_dataset
from fgs_nerf_tpu_torch.eval import dtu_chamfer as CT
from fgs_nerf_tpu_torch.eval import mesh as MeshT
from fgs_nerf_tpu_torch.eval.evaluator import evaluate_checkpoint
from fgs_nerf_tpu_torch.models import sdf_voxel as MT
from fgs_nerf_tpu_torch.ops.cuda import fused_shade_cm as FT
from fgs_nerf_tpu_torch.train import checkpoint as CK

import test_loaders as LOADERS

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

PE = (5, 5, 3)  # pos, ref, view: the `dtu` config's coarse head
SCENE = 24


def _cfg(root, dtype, **extra):
    return dict(reso_level=extra.pop("reso_level", 1), data=dict(
        datadir=str(root), dataset_type=dtype, white_bkgd=True,
        inverse_y=True, flip_x=False, flip_y=False, ndc=False, **extra))


def _assert_same_dataset(got, want):
    assert set(got) == set(want)
    for key, b in want.items():
        a = got[key]
        if key in ("poses", "render_poses", "Ks", "near", "far"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=key)
        elif key == "hwf":
            assert a[:2] == b[:2]
            np.testing.assert_allclose(a[2], b[2], rtol=1e-5)
        elif isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key


def _naive_rq_flips_a_sign(scan):
    cams = np.load(os.path.join(scan, "cameras_sphere.npz"))
    n = len([k for k in cams.files if k.startswith("world_mat_")])
    p = [(cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :3]
         for i in range(n)]
    return any((np.diag(rq(m.astype(np.float64))[0]) < 0).any() for m in p)


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """A 12-view DTU scan at 64 x 48 (grayscale masks) with its ObsMask
    and STL files beside it, world scale 10 mm."""
    root = tmp_path_factory.mktemp("dtu")
    sm = CS.write_dtu_scan(str(root / f"scan{SCENE}"), 12, hw=(48, 64),
                           scale=10.0)
    CS.write_dtu_eval_data(str(root), SCENE, sm, n_points=4000, res=2.0)
    return root / f"scan{SCENE}"


def test_projection_decomposition_matches_opencv():
    """K, R and the camera centre of OpenCV's decomposition, for random
    projection matrices of both determinant signs (the sign fix of a
    naive RQ is what is held)."""
    rng = np.random.default_rng(3)
    flips = 0
    for i in range(200):
        p = (rng.normal(size=(3, 4)) * rng.uniform(0.1, 100)).astype(np.float32)
        flips += (np.diag(rq(p[:, :3].astype(np.float64))[0]) < 0).any()
        for a, b in zip(DT.load_K_Rt_from_P(p), DJ.load_K_Rt_from_P(p)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert flips > 50


@pytest.mark.parametrize("reso_level", [1, 2])
@pytest.mark.parametrize("mask_channels", [1, 3])
def test_dtu_loader_matches_jax(scan, tmp_path, reso_level, mask_channels):
    if mask_channels == 3:  # RGB masks: the loader keeps m[..., :3]
        CS.write_dtu_scan(str(tmp_path / "scan"), 9, hw=(48, 64), scale=10.0,
                          mask_channels=3)
        scan = tmp_path / "scan"
    assert _naive_rq_flips_a_sign(str(scan))
    cfg = _cfg(scan, "dtu", reso_level=reso_level)
    got, want = load_dataset(Cfg(cfg)), load_dataset_j(CfgJ(cfg))
    _assert_same_dataset(got, want)
    n = 12 if mask_channels == 1 else 9
    assert got["images"].shape == (n, 48 // reso_level, 64 // reso_level, 3)
    assert got["masks"].shape == got["images"].shape[:3]
    assert not np.allclose(got["scale_mats_np"], np.eye(4))
    assert list(got["i_test"]) == [8] and len(got["i_train"]) == n


def test_jpeg_scan_raises(tmp_path):
    root = tmp_path / "scan"
    os.makedirs(root / "image")
    os.makedirs(root / "mask")
    (root / "image" / "000000.jpg").write_bytes(b"\xff\xd8\xff")
    (root / "mask" / "000000.png").write_bytes(b"")
    np.savez(root / "cameras_sphere.npz",
             world_mat_0=np.eye(4, dtype=np.float32)[:3] @ np.eye(4),
             scale_mat_0=np.eye(4, dtype=np.float32))
    with pytest.raises(NotImplementedError, match="000000.jpg"):
        DT.load_dtu_data(str(root))


def _scannet_fixture(root, n=12):
    cams = {}
    for i in range(n):
        LOADERS._write_png(os.path.join(root, f"{i:03d}_rgb.png"), channels=3)
        np.save(os.path.join(root, f"{i:03d}_depth.npy"),
                np.full((8, 8), 1.0 + i, np.float32))
        np.save(os.path.join(root, f"{i:03d}_normal.npy"),
                np.random.default_rng(i).uniform(size=(3, 8, 8)).astype(np.float32))
        k = np.array([[50.0, 0, 4, 0], [0, 50.0, 4, 0], [0, 0, 1, 0]])
        c2w = np.eye(4)
        c2w[:3, 3] = [np.cos(i), np.sin(i), 3.0]
        cams[f"world_mat_{i}"] = k @ np.linalg.inv(c2w)
        cams[f"scale_mat_{i}"] = np.diag([2.0, 2.0, 2.0, 1.0])
    np.savez(os.path.join(root, "cameras.npz"), **cams)


@pytest.mark.parametrize("dtype", ["volsdf_bmvs", "mobile_brick", "scannet"])
def test_idr_loaders_match_jax(tmp_path, dtype):
    root = str(tmp_path)
    extra = {}
    if dtype == "scannet":
        _scannet_fixture(root)
        extra = dict(center_crop_type="center_crop_for_dtu")
    else:
        LOADERS.make_idr_fixture(root, ext="png",
                                 scale=dtype == "mobile_brick")
    cfg = _cfg(root, dtype, reso_level=2, **extra)
    got, want = load_dataset(Cfg(cfg)), load_dataset_j(CfgJ(cfg))
    _assert_same_dataset(got, want)
    if dtype == "scannet":
        assert got["depths"].shape == (12, 8, 8)
        assert got["normals"].shape == (12, 8, 8, 3)


@pytest.mark.parametrize("colours", [False, True])
def test_read_ply_matches_jax(tmp_path, colours):
    rng = np.random.default_rng(4)
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    tris = rng.integers(0, 50, size=(80, 3))
    vc = rng.integers(0, 255, size=(50, 3)) if colours else None
    MeshJ.write_ply(str(tmp_path / "j.ply"), verts, tris, vertex_colors=vc)
    MeshT.write_ply(str(tmp_path / "t.ply"), verts, tris)
    for path in ("j.ply", "t.ply"):
        (va, ta), (vb, tb) = (MeshT.read_ply(str(tmp_path / path)),
                              MeshJ.read_ply(str(tmp_path / path)))
        assert va.dtype == vb.dtype and ta.dtype == tb.dtype
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("r,stl_r,runtime", [(50.0, 52.0, True),
                                             (8.0, 8.5, False)])
def test_dtu_chamfer_matches_jax(tmp_path, r, stl_r, runtime):
    """Both packages' Chamfer on the two-sphere fixture of
    ``tests/test_dtu_chamfer.py`` (and a small one at the 0.2 mm
    density of a full evaluation)."""
    import test_dtu_chamfer as T

    from scipy.io import savemat

    verts, tris = T.sphere_mesh(n=28, r=50.0)
    verts = verts * np.float32(r / 50.0)
    mesh_path = str(tmp_path / "pred.ply")
    MeshJ.write_ply(mesh_path, verts, tris)
    d = np.random.default_rng(1).normal(size=(20000, 3))
    stl = (d / np.linalg.norm(d, axis=-1, keepdims=True) * stl_r).astype(np.float32)
    ds = tmp_path / "DTU"
    os.makedirs(ds / "ObsMask")
    os.makedirs(ds / "Points" / "stl")
    MeshJ.write_ply(str(ds / "Points" / "stl" / "stl001_total.ply"), stl,
                    np.zeros((0, 3), np.int64))
    savemat(str(ds / "ObsMask" / "ObsMask1_10.mat"),
            {"ObsMask": np.ones((21, 21, 21), np.uint8),
             "BB": np.array([[-100.0] * 3, [100.0] * 3]),
             "Res": np.array([[10.0]])})
    savemat(str(ds / "ObsMask" / "Plane1.mat"),
            {"P": np.array([[0.0], [0.0], [1.0], [1000.0]])})
    want = CJ.dtu_chamfer(mesh_path, 1, str(ds), str(tmp_path / "j"),
                          runtime=runtime)
    got = CT.dtu_chamfer(mesh_path, 1, str(ds), str(tmp_path / "t"),
                         runtime=runtime)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert all(np.isfinite(got)) and 0 < got[2] < 4.5
    a = np.array((tmp_path / "t" / "result.txt").read_text().split(), float)
    b = np.array((tmp_path / "j" / "result.txt").read_text().split(), float)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


# ---- B3/B4 at the DTU coarse layout -----------------------------------


def _shade_case(seed, m=2048, width=32):
    rng = np.random.default_rng(seed)
    ins = [rng.normal(size=(12, m)).astype(np.float32),
           rng.uniform(size=(3, m)).astype(np.float32),
           rng.normal(size=(3, m)).astype(np.float32),
           rng.normal(size=(3, m)).astype(np.float32),
           rng.normal(size=(3, m)).astype(np.float32)]
    dims = (sum(FT.shade_layout(12, *PE, True)), width, width, 3)
    ws = [rng.normal(size=(i, o)).astype(np.float32) / np.sqrt(i)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(size=(o,)).astype(np.float32) * 0.1 for o in dims[1:]]
    return ins, ws, bs, rng.normal(size=(3, m)).astype(np.float32)


def test_dtu_coarse_layout_is_the_kernels_widest():
    rows = FT.shade_layout(12, *PE, True)
    assert rows == FJ._shade_layout(12, *PE, True)
    assert FT.pad_plan(rows) == FJ.pad_plan(rows)
    assert sum(rows) == 102 and FT.pad_plan(rows)[1] == FT.MAX_CIN8 == 144
    # B4's scratch: X rows padded to 192 values, then H1, dz1, dz0
    assert FT.bwd_scratch_elems(2_359_296, 144, 192) == 2_359_296 * (192 + 576)
    assert FT.bwd_scratch_elems(37, 144, 192) == 64 * (192 + 576)


def test_b3_at_cin8_144_matches_jax():
    ins, ws, bs, _ = _shade_case(0)
    want = FJ.fused_shade_cm(*map(jnp.asarray, ins), [jnp.asarray(w) for w in ws],
                             [jnp.asarray(b) for b in bs], *PE)
    got = FT.fused_shade_cm_fwd_plain(*map(torch.from_numpy, ins),
                                      [torch.from_numpy(w) for w in ws],
                                      [torch.from_numpy(b) for b in bs], *PE)
    err = np.abs(got.numpy() - np.asarray(want))
    # both sums are deterministic here (max 4.4608e-4, 6 of 6,144 logits
    # past 1e-5, whatever the XLA / torch thread counts); the readings go
    # into the message should that ever change
    readings = (float(err.max()), float((err > 1e-5).mean()))
    assert err.max() < 1e-2, readings
    assert (err > 1e-5).mean() < 0.01, readings


def test_b4_at_cin8_144_matches_interpret_kernel_and_vjp():
    ins, ws, bs, g = _shade_case(1)
    j = [jnp.asarray(a) for a in ins]
    wj, bj = [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs]
    d_k, dws_k, dbs_k = FJ.fused_shade_cm_bwd_pallas(
        *j, wj, bj, jnp.asarray(g), *PE, bs=1024, interpret=True)
    _, vjp = jax.vjp(lambda *a: FJ.fused_shade_cm(*a, *PE), *j, wj, bj)
    ref = vjp(jnp.asarray(g))
    d_v, dws_v, dbs_v = list(ref[:5]), ref[5], ref[6]
    d_t, dws_t, dbs_t = FT.fused_shade_cm_bwd_plain(
        *map(torch.from_numpy, ins), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], torch.from_numpy(g), *PE)
    for got, k, v in zip(list(d_t) + dws_t + dbs_t,
                         list(d_k) + list(dws_k) + list(dbs_k),
                         d_v + list(dws_v) + list(dbs_v)):
        got = got.numpy()
        assert got.shape == np.shape(v)
        for want, tol in ((k, 1e-3), (v, 2e-2)):
            want = np.asarray(want, np.float64)
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
            assert rel < tol


# ---- the DTU coarse head from JAX parameters; the evaluator ----------------

XYZ_MIN = np.array([-1.0, -1.0, -1.0], np.float32)
XYZ_MAX = np.array([1.0, 1.0, 1.0], np.float32)


def _dtu_coarse_kwargs():
    """The `dtu` config's coarse head (k0 12, refnet 192 x 3, pe 5/5/3,
    viewdir) on a 16^3 grid, sample_k 32 over 64 rays: M = 2,048, a
    multiple of 1,024, so both sides take the fused shading branch."""
    return dict(
        stage="coarse", xyz_min=XYZ_MIN, xyz_max=XYZ_MAX,
        num_voxels=16**3, num_voxels_base=16**3, stepsize=0.5, k0_dim=12,
        refnet_width=192, refnet_depth=3, posbase_pe=5, viewbase_pe=3,
        refbase_pe=5, smooth_ksize=5, smooth_sigma=0.8, s_ratio=50.0,
        s_start=0.2, fast_color_thres=1e-4, shade_k=0, sample_k=32,
        engine="sorted", mlp_bf16=True)


@pytest.fixture(scope="module")
def dtu_head():
    kw = _dtu_coarse_kwargs()
    cfg_j, cfg_t = MJ.make_model_config(**kw), MT.make_model_config(**kw)
    rng = np.random.default_rng(12)
    pj = MJ.init_params(jax.random.PRNGKey(0), cfg_j)
    pj["k0"] = jnp.asarray(
        rng.normal(size=pj["k0"].shape).astype(np.float32) * 0.3)
    np_params = jax.tree.map(np.asarray, pj)
    return cfg_j, cfg_t, np_params, rng


def test_dtu_coarse_head_from_jax_params(dtu_head):
    cfg_j, cfg_t, np_params, rng = dtu_head
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert np_params["refnet"]["w0"].shape == (102, 192)
    cam = np.array([0.0, 0.1, 2.6], np.float32)
    rays_o = np.broadcast_to(cam, (64, 3)).copy()
    rays_d = (rng.normal(size=(64, 3)).astype(np.float32) * 0.4 - rays_o)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    batch = (rays_o, rays_d, viewdirs.astype(np.float32))
    rj = jax.jit(lambda p, o, d, v: MJ.forward(
        p, {}, cfg_j, SceneBoxJ.create(XYZ_MIN, XYZ_MAX), o, d, v,
        jnp.float32(0.2), near=0.2, bg=1.0))(
            jax.tree.map(jnp.asarray, np_params), *map(jnp.asarray, batch))
    pt = convert.params_from_jax(np_params, "cpu")
    with torch.no_grad():
        rt = MT.forward(pt, {}, cfg_t, SceneBox.create(XYZ_MIN, XYZ_MAX, "cpu"),
                        *map(torch.from_numpy, batch), torch.tensor(0.2),
                        near=0.2, bg=1.0)
    assert int(np.asarray(rj["live"]).sum()) > 0
    for key in ("rgb_marched", "sigmoid_rgb", "weights"):
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_evaluator_writes_the_dtu_chamfer(scan, dtu_head, tmp_path):
    """``evaluate_checkpoint`` on the DTU scan fixture, with the ObsMask
    and STL files beside it, renders the test view, writes the mesh and
    ``result<stage>.txt`` and sets ``stats["chamfer"]`` (CPU)."""
    _, cfg_t, np_params, _ = dtu_head
    cfg = Cfg(_cfg(scan, "dtu", reso_level=2))
    data = load_dataset(cfg)
    ckpt = str(tmp_path / "coarse_last.npz")
    CK.save_checkpoint(ckpt, global_step=1, params=np_params,
                       model_kwargs=dataclasses.asdict(cfg_t),
                       xyz_min=XYZ_MIN, xyz_max=XYZ_MAX)
    stats, mesh_path = evaluate_checkpoint(
        ckpt, cfg, data, str(tmp_path), mesh_resolution=32, scene=SCENE,
        stage_label="dtu", device="cpu")
    result = tmp_path / "meshes" / "resultdtu.txt"
    d2s, s2d, mean = map(float, result.read_text().split())
    assert np.isfinite([d2s, s2d, mean]).all() and mean == (d2s + s2d) / 2
    assert stats["chamfer"] == mean
    assert len(stats["psnr"]) == 1 and np.isfinite(stats["psnr"]).all()
    verts, tris = MeshT.read_ply(mesh_path)
    sm = data["scale_mats_np"]
    # the mesh is in the scan's world frame (mm), around its centre
    assert len(tris) > 0
    assert np.abs(verts.mean(0) - sm[:3, 3]).max() < 2 * sm[0, 0]


# ---- chip_smoke's B4 check past 1e-3 -----------------------------------

# samples put on the mask band of layer 1 (``chip_smoke._mask_band``): a
# bias that cancels their pre-activation of one hidden unit each
BAND = (7, 9, 11)


def _band_case():
    ins, ws, bs, g = _shade_case(2, m=256)
    t = [torch.from_numpy(a) for a in ins]
    rows = FT.shade_layout(12, *PE, True)
    x = FT.build_shade_x(*t, *PE).double()
    w0 = FT.bf16_round(FT.pad_weights([torch.from_numpy(ws[0])],
                                      [torch.from_numpy(bs[0])],
                                      rows)[0][0].double())
    for unit, sample in enumerate(BAND):
        bs[0][unit] = -float(w0[:, unit] @ x[:, sample])
    return (*t, [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs], torch.from_numpy(g), *PE)


@pytest.mark.parametrize(
    "case", ["twin", "twin_flip", "broken", "uniform", "too_many",
             "ceiling"])
def test_card_b4_check_past_1e3(monkeypatch, case):
    """``chip_smoke._check_shade_bwd`` (the card's B4 check) on the CPU,
    with stand-ins for the kernel, on an input with three samples on the
    mask band: the twin passes at 1e-3; a flipped mask on one band sample
    (as on the DTU geometry call) that puts the kernel 2e-3 off passes,
    that sample set aside; rejected: a non-band sample's cotangents
    tripled, that flip with every cotangent also 1.5e-3 off, flips on two
    band samples (past the cap, ceil(1e-5 M) = 1), and a flip that puts
    the whole output 2e-2 off."""
    monkeypatch.setattr(CS, "_time_ms", lambda fn, n, torch_: 1.0)
    monkeypatch.setattr(CS, "_shade_chain_ms", lambda *a: 1.0)
    monkeypatch.setattr(CS, "_shade_smem", lambda args: {})
    args = _band_case()
    plain = FT.fused_shade_cm_bwd_plain
    d_normal = plain(*args)[0][3]

    def scale(sample, rel):
        """The factor on ``sample``'s d_normal that moves the whole
        d_normal by relative L2 ``rel``."""
        return 1 + rel * float(d_normal.norm() / d_normal[:, sample].norm())

    flip = (BAND[0], scale(BAND[0], 2e-3))
    moves = {"twin": [], "twin_flip": [flip], "broken": [(20, 3.0)],
             "uniform": [flip],
             "too_many": [flip, (BAND[1], scale(BAND[1], 2e-3))],
             "ceiling": [(BAND[0], scale(BAND[0], 2e-2))]}[case]

    def kernel(*a):
        d, dw, db = plain(*a)
        d = [None if x is None else x.clone() for x in d]
        if case == "uniform":
            d = [None if x is None else x * (1 + 1.5e-3) for x in d]
        for sample, f in moves:
            d[3][:, sample] *= f
        return d, dw, db

    monkeypatch.setattr(FT, "fused_shade_cm_bwd", kernel)
    if case in ("broken", "uniform", "too_many", "ceiling"):
        with pytest.raises(RuntimeError, match="off their twin"):
            CS._check_shade_bwd(torch, args, "cpu")
        return
    r = CS._check_shade_bwd(torch, args, "cpu")
    if case == "twin":
        assert r["max_rel_l2"] == 0.0 and r["mask_band"] == {}
        return
    band = r["mask_band"]
    assert r["max_rel_l2"] > 1e-3 and band["cap"] == 1
    assert band["set_aside"] == 1 and 3 <= band["band_samples"] <= 8
    assert band["d_normal"]["rest"] == 0.0
    assert abs(band["d_normal"]["whole"] - 2e-3) < 1e-5


def test_mask_band_holds_the_cancelled_samples():
    """``chip_smoke._mask_band`` finds the samples whose layer-1
    pre-activation the bias cancels, and loses them when the bias moves
    their pre-activation 0.05 off 0."""
    args = _band_case()
    ins, ws, bs, pe = args[:5], args[5], args[6], args[8:]
    band = CS._mask_band(torch, FT, ins, ws, bs, pe, chunk=100)
    assert band.shape == (256,) and band[list(BAND)].all()
    assert int(band.sum()) <= 8
    far = [b.clone() for b in bs]
    far[0][:len(BAND)] += 0.05
    band = CS._mask_band(torch, FT, ins, ws, far, pe)
    assert not band[list(BAND)].any()
