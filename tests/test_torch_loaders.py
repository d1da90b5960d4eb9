"""The port's loaders against the JAX package's (CPU): LLFF, NSVF, Tanks &
Temples, BlendedMVS, DeepVoxels, CO3D, NeRF++ and ILSH through each
package's ``load_dataset``, on the same small scans (``chip_smoke.py``'s
writers, which phase 16 loads on the card's machine: random uint8 PNGs
from numpy seeds, poses made with numpy), and ``area_resize`` against
OpenCV's ``INTER_AREA``.

Tolerances and why: the JAX loaders read PNG with imageio and shrink
with OpenCV, the port reads with ``eval/image_io.py:read_png`` and
shrinks with ``data/llff.py:area_resize``; both give the same bytes, so
images and masks must be equal, and ``area_resize`` must equal
``cv2.resize(INTER_AREA)`` byte for byte.  The pose arithmetic is the
same numpy code on the same inputs, so poses, intrinsics, near / far and
render poses are held to 1e-6 (absolute and relative).
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from fgs_nerf_tpu.config.base import Cfg as CfgJ
from fgs_nerf_tpu.data.dataset import load_dataset as load_dataset_j

from fgs_nerf_tpu_torch.config.base import Cfg
from fgs_nerf_tpu_torch.data.dataset import load_dataset
from fgs_nerf_tpu_torch.data.llff import area_resize

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _data(block, **kw):
    return CS.data_block(**block, **kw)


def _both(data):
    return (load_dataset_j(CfgJ(dict(data=dict(data)))),
            load_dataset(Cfg(dict(data=dict(data)))))


def _same(dj, dt):
    assert dt["irregular_shape"] == dj["irregular_shape"]
    for key in ("images", "masks"):
        a, b = dj[key], dt[key]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), key
    for key in ("HW", "i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(dt[key], dj[key], err_msg=key)
    for key in ("poses", "Ks", "render_poses"):
        np.testing.assert_allclose(dt[key], dj[key], err_msg=key, **TOL)
    for key in ("near", "far"):
        np.testing.assert_allclose(dt[key], dj[key], err_msg=key, **TOL)
    assert dt["hwf"][:2] == dj["hwf"][:2]
    np.testing.assert_allclose(dt["hwf"][2], dj["hwf"][2], **TOL)


@pytest.mark.parametrize("factor", [2, 3, 4, 8])
@pytest.mark.parametrize("hw", [(64, 96), (61, 83)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_area_resize_is_cv2_inter_area(factor, hw, channels):
    import cv2

    h, w = hw
    rng = np.random.default_rng(factor * 100 + h + channels)
    shape = (h, w) if channels == 1 else (h, w, channels)
    for hi in (256, 3):  # 3: many rounding ties
        img = rng.integers(0, hi, size=shape, dtype=np.uint8)
        want = cv2.resize(img, (w // factor, h // factor),
                          interpolation=cv2.INTER_AREA)
        got = area_resize(img, w // factor, h // factor)
        assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("factor", [1, 2, 3])
@pytest.mark.parametrize("ndc", [False, True])
def test_llff_matches_jax(tmp_path, factor, ndc):
    block = CS.write_llff_scan(str(tmp_path))
    dj, dt = _both(_data(block, factor=factor, ndc=ndc))
    _same(dj, dt)
    assert dt["images"].shape == (10, 24 // factor, 32 // factor, 3)
    if ndc:
        assert (dt["near"], dt["far"]) == (0.0, 1.0)
    np.testing.assert_array_equal(dt["i_test"], [0, 8])


@pytest.mark.parametrize("llffhold", [8, 0])
def test_llff_spherify_matches_jax(tmp_path, llffhold):
    block = CS.write_llff_scan(str(tmp_path), n=12, inward=True)
    dj, dt = _both(_data(block, spherify=True, llffhold=llffhold))
    _same(dj, dt)
    assert dt["render_poses"].shape == (120, 3, 4)
    if llffhold == 0:
        assert len(dt["i_test"]) == 1


def test_llff_jpeg_raises(tmp_path):
    block = CS.write_llff_scan(str(tmp_path), n=3, ext="jpg")
    with pytest.raises(NotImplementedError, match=r"000\.jpg.*PNG"):
        load_dataset(Cfg(dict(data=_data(block))))


@pytest.mark.parametrize("dtype,traj,channels", [
    ("nsvf", False, 3), ("nsvf", False, 4), ("tankstemple", False, 3),
    ("tankstemple", True, 4), ("blendedmvs", True, 3)])
def test_nsvf_family_matches_jax(tmp_path, dtype, traj, channels):
    dj, dt = _both(_data(CS.write_nsvf_scan(str(tmp_path), dtype, traj,
                                            channels=channels)))
    _same(dj, dt)
    assert dt["images"].shape[-1] == 3


def test_nerfpp_matches_jax(tmp_path):
    """`tests/test_loaders.py:158-177`, with a camera path."""
    dj, dt = _both(_data(CS.write_nerfpp_scan(str(tmp_path))))
    _same(dj, dt)
    assert dt["near"] == 0.0 and len(dt["render_poses"]) == 3


@pytest.mark.parametrize("white", [True, False])
def test_co3d_matches_jax(tmp_path, white):
    """`tests/test_loaders.py:180-218`: one view of another shape (the
    object-array path), grayscale masks, one view with an empty mask."""
    block = CS.write_co3d_scan(str(tmp_path))
    dj, dt = _both(_data(block, white_bkgd=white))
    _same(dj, dt)
    assert dt["irregular_shape"] and len(dt["images"]) == 4
    assert dt["masks"][0].shape == (8, 8)


@pytest.mark.parametrize("factor,spherify", [(1, False), (2, True), (3, False)])
def test_ilsh_matches_jax(tmp_path, factor, spherify):
    """`tests/test_loaders.py:221-240` at 24 x 32."""
    block = CS.write_ilsh_scan(str(tmp_path), inward=spherify)
    dj, dt = _both(_data(block, factor=factor, spherify=spherify))
    _same(dj, dt)
    assert dt["masks"].shape == (6, 24 // factor, 32 // factor)


def test_ilsh_depth_maps_match_jax(tmp_path):
    from fgs_nerf_tpu.data.ilsh import load_ilsh_data as ilsh_j
    from fgs_nerf_tpu_torch.data.ilsh import load_ilsh_data

    root = str(tmp_path)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "stereo", "depth_maps"))
    for i in range(3):
        CS.write_random_png(os.path.join(root, "images", f"{i:03d}.png"),
                            24, 32, seed=i)
        depth = np.random.default_rng(i).uniform(1, 5, (24, 32)).astype(np.float32)
        with open(os.path.join(root, "stereo", "depth_maps",
                               f"{i:03d}.png.geometric.bin"), "wb") as f:
            f.write(b"32&24&1&")
            f.write(np.asfortranarray(depth.T).tobytes(order="F"))
    np.save(os.path.join(root, "poses_bounds.npy"),
            CS.llff_poses_bounds(3, (24, 32), seed=5))
    oj = ilsh_j(root, load_depths=True)
    ot = load_ilsh_data(root, load_depths=True)
    np.testing.assert_allclose(ot["depths"], oj["depths"], **TOL)
    np.testing.assert_array_equal(ot["masks"], oj["masks"])


def test_deepvoxels_matches_jax(tmp_path):
    """A DeepVoxels layout: ``{train,validation,test}/<scene>/{pose,rgb}``
    and the train split's ``intrinsics.txt``."""
    block = CS.write_deepvoxels_scan(str(tmp_path))
    dj, dt = _both(_data(block, testskip=2))
    _same(dj, dt)
    assert len(dt["i_train"]) == 4 and len(dt["i_test"]) == 2
    assert dt["hwf"][:2] == [512, 512]
