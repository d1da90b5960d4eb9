"""Two real processes through the port's process group (gloo on the
CPU): the counterparts of ``tests/test_distributed.py``.

One 2-rank launch (``tests/torch_rank_workers.py:distributed_rank``)
gives each rank its dp rows of one global batch and sums over the group,
then writes an sp = 2 checkpoint from x-slabs (gathered, rank 0 writes),
reads it back on every rank and places it again; this process loads the
file with the JAX package's ``load_checkpoint``.
"""
import numpy as np
import pytest

import torch_rank_workers as W
from fgs_nerf_tpu_torch.parallel.launch import launch_local


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist") / "shard_ckpt.npz")
    return path, launch_local(2, f"{W.__file__}:distributed_rank",
                              device="cpu", kwargs=dict(ckpt_path=path),
                              timeout=120)


def test_two_process_distributed_shard_batch(ranks):
    _, res = ranks
    batch = np.arange(16 * 3, dtype=np.float32).reshape(16, 3) * 0.5
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["rows"], batch[rank * 8:rank * 8 + 8])
        np.testing.assert_allclose(float(r["sum"]), float(np.sum(batch * 2.0)),
                                   rtol=1e-6)


def test_two_process_sharded_checkpoint_roundtrip(ranks):
    """sp-sharded grids survive a save / restore across 2 processes, and
    the file is the JAX package's format."""
    from fgs_nerf_tpu.train.checkpoint import load_checkpoint

    path, res = ranks
    want = W.checkpoint_params()
    for r in res:
        assert int(r["slab_planes"]) == 4  # each rank held half the x-planes
        assert bool(r["equal/sdf"]) and bool(r["equal/k0"])
        assert bool(r["equal/w0"])
        assert int(r["global_step"]) == 3
    # both processes computed the same restored-grid reduction
    np.testing.assert_allclose(float(res[0]["restored_sum"]),
                               float(res[1]["restored_sum"]), rtol=1e-6)
    np.testing.assert_allclose(
        float(res[0]["restored_sum"]),
        float(want["sdf"].sum() + want["k0"].sum()), rtol=1e-5)
    ck = load_checkpoint(path)
    for name in ("sdf", "k0"):
        np.testing.assert_array_equal(ck.params[name], want[name])
    np.testing.assert_array_equal(ck.params["refnet"]["w0"],
                                  want["refnet"]["w0"])
    np.testing.assert_array_equal(
        ck.artifacts["sdf_mask"],
        np.where(want["sdf"] < 0.0, 1e-3, 0.0).astype(np.float32))
    assert ck.global_step == 3
    assert ck.opt is not None
    np.testing.assert_array_equal(ck.opt["exp_avg"]["sdf"],
                                  np.zeros_like(want["sdf"]))
