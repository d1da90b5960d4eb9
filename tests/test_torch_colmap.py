"""The port's capture preprocessing against the JAX package's (CPU): the
COLMAP binary model reader, ``poses_bounds`` rows, the ``cameras_sphere``
normalisation, the ``run_colmap`` CLI (its outputs, its three exit-2
errors, the ``colmap`` commands it issues), ``rembg`` masks and video
frames.

Tolerances and why: the reader, ``qvec2rotmat`` and
``colmap_to_poses_bounds`` are the same float64 numpy code on the same
bytes in both packages, so they must be exactly equal, and so must the
CLI's ``.npy`` / ``.npz`` outputs; the camera normalisation is held to
1e-6 (absolute and relative), its float32 matrices made by the same
code.  Video frames are decoded and written by OpenCV in both packages:
byte-equal PNGs.
"""
import os
import stat
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from fgs_nerf_tpu.data import colmap as CJ
from fgs_nerf_tpu.data import preprocess as PJ

from fgs_nerf_tpu_torch import run_colmap as RCT
from fgs_nerf_tpu_torch.data import colmap as CT
from fgs_nerf_tpu_torch.data import preprocess as PT

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402
import run_colmap as RCJ  # noqa: E402
from test_colmap import write_fixture  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def write_seeded_model(sparse, seed=0, n_images=24, n_points=400):
    """A model with ``SIMPLE_PINHOLE``, ``PINHOLE`` and ``OPENCV`` cameras,
    ``n_images`` views with random unit quaternions (listing random
    points, some ids -1), ``n_points`` points; the last view sees no
    point (its ids are all -1)."""
    rng = np.random.default_rng(seed)
    cams = [(1, "SIMPLE_PINHOLE", 640, 480, (500.0, 320.0, 240.0)),
            (2, "PINHOLE", 800, 600, (610.0, 590.0, 401.5, 298.0)),
            (3, "OPENCV", 1024, 768,
             (700.0, 710.0, 515.0, 380.0, 0.01, -0.002, 1e-4, -2e-4))]
    pts = rng.normal(size=(n_points, 3)) * 2.0
    images, tracks = [], [[] for _ in range(n_points)]
    for i in range(n_images):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        r = CJ.qvec2rotmat(q)
        # the camera 6 units from the points' centre, looking at it
        t = np.array([0.0, 0.0, 6.0]) + rng.normal(size=3) * 0.3
        k = int(rng.integers(5, 40))
        ids = rng.choice(n_points, size=k, replace=False)
        ids = np.where(rng.uniform(size=k) < 0.2, -1, ids)
        if i == n_images - 1:
            ids = np.full(k, -1)
        cam = pts[np.maximum(ids, 0)] @ r.T + t
        xys = cam[:, :2] / cam[:, 2:] * 500.0 + 300.0
        for j, p in enumerate(ids):
            if p >= 0:
                tracks[p].append((i + 1, j))
        images.append((i + 1, q, t, 1 + i % 3, f"img_{i:03d}.png", xys, ids))
    points = [(p, pts[p], (10, 20, 30), 0.25, tracks[p])
              for p in range(n_points)]
    CS.write_colmap_model(sparse, cams, images, points)


FIXTURES = {"two_view": write_fixture, "seeded": write_seeded_model}


@pytest.fixture(params=sorted(FIXTURES))
def model(request, tmp_path):
    sparse = str(tmp_path / "sparse" / "0")
    FIXTURES[request.param](sparse)
    return sparse


def test_read_model_is_the_jax_readers(model):
    cams_j, imgs_j, pts_j, ids_j = CJ.read_model(model)
    cams_t, imgs_t, pts_t, ids_t = CT.read_model(model)
    assert sorted(cams_t) == sorted(cams_j)
    for k, cj in cams_j.items():
        ct = cams_t[k]
        assert (ct.id, ct.model, ct.width, ct.height) == (
            cj.id, cj.model, cj.width, cj.height)
        np.testing.assert_array_equal(ct.params, cj.params)
    assert sorted(imgs_t) == sorted(imgs_j)
    for k, ij in imgs_j.items():
        it = imgs_t[k]
        assert (it.id, it.camera_id, it.name) == (ij.id, ij.camera_id, ij.name)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(it, f), getattr(ij, f))
    np.testing.assert_array_equal(pts_t, pts_j)
    assert ids_t == ids_j
    assert CT.CAMERA_MODELS == CJ.CAMERA_MODELS


def test_poses_bounds_rows_are_the_jax_rows(model):
    got, want = CT.colmap_to_poses_bounds(model), CJ.colmap_to_poses_bounds(
        model)
    assert got.shape == want.shape and got.shape[1] == 17
    np.testing.assert_array_equal(got, want)
    if got.shape[0] == 24:
        # the view with no visible point takes the default bounds
        np.testing.assert_array_equal(got[-1, 15:], [0.1, 10.0])


def test_qvec2rotmat_is_the_jax_function():
    rng = np.random.default_rng(3)
    for q in rng.normal(size=(32, 4)):
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(CT.qvec2rotmat(q), CJ.qvec2rotmat(q))


def test_camera_normalisation_matches_jax(model, tmp_path):
    """``colmap_to_idr`` (every camera model, ``OPENCV`` included, read as
    the JAX package reads it), ``normalize_cameras`` and
    ``write_cameras_sphere``."""
    got = np.load(PT.colmap_to_idr(model, str(tmp_path / "t")))
    want = np.load(PJ.colmap_to_idr(model, str(tmp_path / "j")))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k], want[k], **TOL)
    rng = np.random.default_rng(5)
    ks = [np.array([[400.0 + i, 0, 200], [0, 410.0, 150], [0, 0, 1]],
                   np.float32) for i in range(6)]
    rts = []
    for _ in range(6):
        q = rng.normal(size=4)
        r = CJ.qvec2rotmat(q / np.linalg.norm(q))
        rts.append(np.concatenate([r, rng.normal(size=(3, 1))], 1))
    for radius in (3.0, 1.5):
        a = PT.normalize_cameras(ks, rts, radius)
        b = PJ.normalize_cameras(ks, rts, radius)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], **TOL)
    got = np.load(PT.write_cameras_sphere(str(tmp_path / "wt"), ks, rts))
    want = np.load(PJ.write_cameras_sphere(str(tmp_path / "wj"), ks, rts))
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], **TOL)
    np.testing.assert_allclose(PT.nearest_point_to_rays(
        np.asarray(rts)[:, :, 3], np.asarray(rts)[:, 2, :3]),
        PJ.nearest_point_to_rays(np.asarray(rts)[:, :, 3],
                                 np.asarray(rts)[:, 2, :3]), **TOL)


def _capture(root, n=8, hw=(24, 32)):
    CS.write_capture(str(root), n_views=n, hw=hw, n_points=300)
    return root


def _outputs(root):
    pb = np.load(root / "poses_bounds.npy")
    cs = np.load(root / "cameras_sphere.npz")
    return pb, {k: cs[k] for k in cs.files}


def _same_outputs(a, b):
    (pa, ca), (pb, cb) = _outputs(a), _outputs(b)
    np.testing.assert_array_equal(pa, pb)
    assert sorted(ca) == sorted(cb)
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k])


def test_cli_outputs_match_jax(tmp_path, capsys):
    """``python -m fgs_nerf_tpu_torch.run_colmap`` and the repo's
    ``run_colmap.py`` on two copies of one capture (its ``sparse/0``
    taken as COLMAP's): equal outputs, the same printed stages."""
    a, b = _capture(tmp_path / "t"), _capture(tmp_path / "j")
    capsys.readouterr()
    assert RCT.main(["--custom_dataset_path", str(a), "--skip_masks"]) == 0
    out_t = capsys.readouterr().out.replace(str(a), "<root>")
    assert RCJ.main(["--custom_dataset_path", str(b), "--skip_masks"]) == 0
    out_j = capsys.readouterr().out.replace(str(b), "<root>")
    assert out_t == out_j
    _same_outputs(a, b)
    pb, cs = _outputs(a)
    assert pb.shape == (8, 17)
    assert sorted(cs) == sorted(f"{k}_{i}" for i in range(8)
                                for k in ("world_mat", "scale_mat"))


def test_cli_errors_match_jax(tmp_path, capsys):
    """The three exit-2 errors: video mode with no video, no ``images/``,
    ``--skip_colmap`` with no ``sparse/0``."""
    (tmp_path / "noimg").mkdir()
    (tmp_path / "nosparse" / "images").mkdir(parents=True)
    for argv in (["--custom_dataset_path", str(tmp_path / "v"),
                  "--run_mode", "video"],
                 ["--custom_dataset_path", str(tmp_path / "noimg"),
                  "--skip_masks"],
                 ["--custom_dataset_path", str(tmp_path / "nosparse"),
                  "--skip_masks", "--skip_colmap"]):
        capsys.readouterr()
        assert RCT.main(argv) == 2
        got = capsys.readouterr()
        assert RCJ.main(argv) == 2
        want = capsys.readouterr()
        assert got.err.startswith("error: ") and got.err == want.err
        assert got.out == want.out


_STUB = """#!{python}
import os, shutil, sys
with open(os.environ["COLMAP_STUB_LOG"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
if sys.argv[1] == "mapper":
    out = sys.argv[sys.argv.index("--output_path") + 1]
    shutil.copytree(os.environ["COLMAP_STUB_MODEL"], os.path.join(out, "0"))
"""


@pytest.mark.parametrize("match_type", ["exhaustive_matcher",
                                        "sequential_matcher"])
def test_run_colmap_issues_the_jax_commands(tmp_path, monkeypatch, capsys,
                                            match_type):
    """A stub ``colmap`` on ``PATH`` logs its arguments and writes the
    seeded model on ``mapper``: both packages' CLIs issue the same three
    commands and write the same outputs."""
    stub = tmp_path / "bin"
    stub.mkdir()
    exe = stub / "colmap"
    exe.write_text(_STUB.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    model = tmp_path / "model"
    write_seeded_model(str(model), n_images=8)
    monkeypatch.setenv("PATH", f"{stub}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("COLMAP_STUB_MODEL", str(model))
    logs = {}
    for side, main in (("t", RCT.main), ("j", RCJ.main)):
        root = tmp_path / side
        (root / "images").mkdir(parents=True)
        log = tmp_path / f"{side}.log"
        monkeypatch.setenv("COLMAP_STUB_LOG", str(log))
        assert main(["--custom_dataset_path", str(root), "--skip_masks",
                     "--match_type", match_type]) == 0
        logs[side] = log.read_text().replace(str(root), "<root>")
    capsys.readouterr()
    assert logs["t"] == logs["j"]
    cmds = logs["t"].splitlines()
    assert [c.split()[0] for c in cmds] == ["feature_extractor", match_type,
                                            "mapper"]
    _same_outputs(tmp_path / "t", tmp_path / "j")


def test_run_colmap_without_a_binary_raises_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError) as got:
        CT.run_colmap(str(tmp_path))
    with pytest.raises(RuntimeError) as want:
        CJ.run_colmap(str(tmp_path))
    assert str(got.value) == str(want.value)
    assert "colmap binary not found" in str(got.value)


def test_masks_without_rembg_match_jax(tmp_path):
    """Where ``rembg`` cannot be imported both return None and write
    nothing."""
    _capture(tmp_path / "c", n=2)
    img = str(tmp_path / "c" / "images")
    got = PT.mask_with_rembg(img, str(tmp_path / "mt"))
    want = PJ.mask_with_rembg(img, str(tmp_path / "mj"))
    assert got == want
    if got is None:
        assert not (tmp_path / "mt").exists()


def test_video_frames_match_jax(tmp_path):
    """A 12-frame MJPG AVI at 6 fps, extracted at 2 fps by both packages:
    the same 4 frames, byte-equal PNGs."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 6.0, (32, 24))
    rng = np.random.default_rng(0)
    for i in range(12):
        frame = np.full((24, 32, 3), 20 * i, np.uint8)
        frame[4:12, 8:20] = rng.integers(0, 256, size=(8, 12, 3))
        vw.write(frame)
    vw.release()
    n_t = CT.extract_video_frames(path, str(tmp_path / "t"), fps=2.0)
    n_j = CJ.extract_video_frames(path, str(tmp_path / "j"), fps=2.0)
    assert n_t == n_j == 4
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())


def test_point_ids_are_read_as_float64_as_in_jax(tmp_path):
    """Reference behaviour (ROADMAP §C): each point2D's point3D id is read
    as a float64, the fixture's layout; COLMAP writes a uint64 there, so
    a model in COLMAP's own layout reads its ids as 0 (denormals) and -1
    as a negative id, in both packages alike."""
    sparse = tmp_path / "sparse"
    write_fixture(str(sparse))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<4d", 1.0, 0.0, 0.0, 0.0))
        f.write(struct.pack("<3d", 0.0, 0.0, 0.0))
        f.write(struct.pack("<i", 1))
        f.write(b"a.png\x00")
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<ddQ", 10.0, 20.0, 101))
        f.write(struct.pack("<ddq", 11.0, 21.0, -1))
    with np.errstate(invalid="ignore"):  # NaN -> int64 for the -1 id
        got = CT.read_model(str(sparse))[1][1].point3d_ids
        want = CJ.read_model(str(sparse))[1][1].point3d_ids
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[1] < 0
