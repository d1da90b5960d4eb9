"""The port imports neither JAX nor the JAX package, and asks for the
card unless told otherwise."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import fgs_nerf_tpu_torch as P
names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k.startswith("jaxlib.") or k == "fgs_nerf_tpu"
             or k.startswith("fgs_nerf_tpu.") or k.split(".")[0]
             in ("imageio", "cv2"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for name in ("fgs_nerf_tpu_torch.train.trainer",
                 "fgs_nerf_tpu_torch.ops.cuda.window_gather_cm",
                 "fgs_nerf_tpu_torch.ops.cuda.scatter_combine_cm",
                 "fgs_nerf_tpu_torch.ops.cuda.fused_shade_cm",
                 "fgs_nerf_tpu_torch.ops.cuda.tap_serve_cm",
                 "fgs_nerf_tpu_torch.ops.cuda.scatter_combine",
                 "fgs_nerf_tpu_torch.ops.interp",
                 "fgs_nerf_tpu_torch.ops.scatter",
                 "fgs_nerf_tpu_torch.data.rays",
                 "fgs_nerf_tpu_torch.data.synthetic",
                 "fgs_nerf_tpu_torch.eval.metrics",
                 "fgs_nerf_tpu_torch.eval.render",
                 "fgs_nerf_tpu_torch.eval.lpips_native",
                 "fgs_nerf_tpu_torch.convert",
                 "fgs_nerf_tpu_torch.config.base",
                 "fgs_nerf_tpu_torch.config.scenes",
                 "fgs_nerf_tpu_torch.train.schedules",
                 "fgs_nerf_tpu_torch.train.checkpoint",
                 "fgs_nerf_tpu_torch.train.stage_common",
                 "fgs_nerf_tpu_torch.train.bbox",
                 "fgs_nerf_tpu_torch.train.pipeline",
                 "fgs_nerf_tpu_torch.data.dataset",
                 "fgs_nerf_tpu_torch.data.blender",
                 "fgs_nerf_tpu_torch.data.dtu",
                 "fgs_nerf_tpu_torch.data.idr_like",
                 "fgs_nerf_tpu_torch.data.llff",
                 "fgs_nerf_tpu_torch.data.nsvf",
                 "fgs_nerf_tpu_torch.data.nsvf_like",
                 "fgs_nerf_tpu_torch.data.nerfpp",
                 "fgs_nerf_tpu_torch.data.co3d",
                 "fgs_nerf_tpu_torch.data.ilsh",
                 "fgs_nerf_tpu_torch.data.deepvoxels",
                 "fgs_nerf_tpu_torch.models.density_voxel",
                 "fgs_nerf_tpu_torch.train.density_trainer",
                 "fgs_nerf_tpu_torch.core.grids",
                 "fgs_nerf_tpu_torch.eval.dtu_chamfer",
                 "fgs_nerf_tpu_torch.eval.image_io",
                 "fgs_nerf_tpu_torch.eval.mesh",
                 "fgs_nerf_tpu_torch.eval.evaluator",
                 "fgs_nerf_tpu_torch.ops.fused_mlp_cm",
                 "fgs_nerf_tpu_torch.ops.cuda.fused_mlp_cm",
                 "fgs_nerf_tpu_torch.parallel.mesh",
                 "fgs_nerf_tpu_torch.parallel.spatial",
                 "fgs_nerf_tpu_torch.parallel.spatial_train",
                 "fgs_nerf_tpu_torch.parallel.launch",
                 "fgs_nerf_tpu_torch.parallel.dryrun",
                 "fgs_nerf_tpu_torch.data.colmap",
                 "fgs_nerf_tpu_torch.data.preprocess",
                 "fgs_nerf_tpu_torch.utils.profiling",
                 "fgs_nerf_tpu_torch.run_colmap",
                 "fgs_nerf_tpu_torch.run"):
        assert name in res["modules"]


def test_rank_workers_import_no_jax():
    """The multi-process tests' rank programs (``tests/torch_rank_workers
    .py``) and the parallel modules leave JAX and the JAX package out of
    ``sys.modules``."""
    probe = (
        "import json, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_rank_workers\n"
        "import fgs_nerf_tpu_torch.parallel.mesh\n"
        "import fgs_nerf_tpu_torch.parallel.spatial\n"
        "import fgs_nerf_tpu_torch.parallel.spatial_train\n"
        "import fgs_nerf_tpu_torch.parallel.launch\n"
        "import fgs_nerf_tpu_torch.parallel.dryrun\n"
        "torch_rank_workers.spatial_inputs()\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0]\n"
        "      in ('jax', 'jaxlib', 'fgs_nerf_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_mesh_spec_must_match_the_world(monkeypatch):
    """``--mesh dp=2`` in a world of one process (no launcher, or a
    ``WORLD_SIZE`` that does not match) raises ``ValueError``; none /
    auto give no mesh."""
    from fgs_nerf_tpu_torch.parallel.mesh import build_mesh

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        build_mesh("dp=2")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        build_mesh("dp=2,sp=2")
    assert build_mesh("none") is None and build_mesh("auto") is None
    m = build_mesh("dp=1", device="cpu")
    assert (m.dp, m.sp, m.rank, m.dp_group) == (1, 1, 0, None)


def test_parallel_entry_points_default_to_the_card(monkeypatch):
    """With no device, ``build_mesh`` and ``maybe_distributed_init`` take
    the rank's card (``rank_device``), which a machine with no card does
    not have; ``launch_local`` starts its ranks on the cards (NCCL)."""
    import inspect

    import torch

    from fgs_nerf_tpu_torch.parallel import mesh as M
    from fgs_nerf_tpu_torch.parallel.launch import launch_local

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert M.build_mesh("none") is None and M.build_mesh("auto") is None
    with pytest.raises(RuntimeError, match="has no card of its own"):
        M.build_mesh("dp=1")
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="has no card of its own"):
        M.maybe_distributed_init()
    params = inspect.signature(launch_local).parameters
    assert params["device"].default == "cuda"


def test_nccl_refuses_two_ranks_on_one_device(monkeypatch):
    """NCCL with two local ranks on ``cuda:0`` raises before any
    rendezvous, and a partial launcher environment raises too."""
    import torch.distributed as dist

    from fgs_nerf_tpu_torch.parallel.mesh import maybe_distributed_init

    env = dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="two ranks on one device"):
        maybe_distributed_init("nccl", "cuda:0")
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(ValueError, match="MASTER_PORT missing"):
        maybe_distributed_init("gloo", "cpu")
    assert not dist.is_initialized()


def test_chip_smoke_imports_no_jax(tmp_path):
    """``chip_smoke.py`` and the port modules its DTU scan writers and its
    capture path (phase 22: the capture writer, ``run_colmap``, the LLFF
    check) use leave JAX, the JAX package, ``imageio`` and ``cv2`` out of
    ``sys.modules``."""
    cap = str(tmp_path / "capture")
    probe = (
        "import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke as CS\n"
        "from fgs_nerf_tpu_torch import run_colmap as RC\n"
        f"sm = CS.write_dtu_scan({str(tmp_path / 'scan')!r}, 2, hw=(12, 16))\n"
        f"CS.write_dtu_eval_data({str(tmp_path)!r}, 1, sm, n_points=10)\n"
        f"c, r = CS.write_capture({cap!r}, 4, hw=(12, 16), n_points=50)\n"
        f"assert RC.main(['--custom_dataset_path', {cap!r}]) == 0\n"
        f"CS.check_capture_conversion({cap!r}, c, r)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0]\n"
        "      in ('jax', 'jaxlib', 'fgs_nerf_tpu', 'imageio', 'cv2'))))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert (tmp_path / "scan" / "image" / "000001.png").is_file()
    assert (tmp_path / "ObsMask" / "Plane1.mat").is_file()
    assert (tmp_path / "capture" / "poses_bounds.npy").is_file()


def test_entry_points_default_to_the_card():
    import torch

    from fgs_nerf_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            is False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)


def test_kernel_sources_and_wrappers():
    from fgs_nerf_tpu_torch.ops.cuda import (
        fused_mlp_cm, fused_shade_cm, scatter_combine, scatter_combine_cm,
        tap_serve_cm, window_gather_cm,
    )

    for mod in (window_gather_cm, scatter_combine_cm, fused_shade_cm,
                tap_serve_cm, scatter_combine, fused_mlp_cm):
        k = mod.KERNEL
        assert k.source.exists(), k.source
        text = k.source.read_text()
        for fn in k.launchers:
            assert f'extern "C" int {fn}(' in text
        assert set(k.launches) == set(k.launchers)
        assert k.replaces.startswith("fgs_nerf_tpu/ops/pallas/")


def test_card_tests_collect_without_jax(tmp_path):
    """The card tests run where there is no JAX: with ``jax`` made
    unimportable and ``--noconftest`` (``tests/conftest.py`` imports JAX),
    ``tests/test_torch_kernels.py`` collects and, without a card, skips."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text(
        "raise ImportError('no JAX on this machine')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(REPO), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "tests/test_torch_kernels.py"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    import torch

    if not torch.cuda.is_available():
        assert " skipped" in out.stdout and "error" not in out.stdout
