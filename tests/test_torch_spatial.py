"""The port's spatial grid sharding (``fgs_nerf_tpu_torch/parallel/
spatial.py``) against the JAX package's dense ops: halo exchange,
sharded stencils and the sharded trilinear gather, forward and grid
gradient, the counterparts of ``tests/test_spatial.py`` at 2 and 4
shards with its tolerances.

One 4-rank gloo launch (one CPU thread a rank) runs every case on an sp
group of 4 and on two sp groups of 2 (``tests/torch_rank_workers.py:
spatial_rank``); this process computes the JAX references and compares.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fgs_nerf_tpu.ops.interp import trilinear_sample_index
from fgs_nerf_tpu.ops.stencils import sdf_gradient, smooth_grid

import torch_rank_workers as W
from fgs_nerf_tpu_torch.parallel.launch import launch_local
from fgs_nerf_tpu_torch.parallel.spatial import slab_bounds

SHARDS = (2, 4)


@pytest.fixture(scope="module")
def ranks():
    return launch_local(4, f"{W.__file__}:spatial_rank", device="cpu",
                        timeout=120)


@pytest.fixture(scope="module")
def ins():
    return W.spatial_inputs()


def _slabs(ranks, n, key):
    """The sp group of dp row 0, in sp order: that group's outputs."""
    row = [r for r in ranks if int(r[f"sp{n}/dp_index"]) == 0]
    row.sort(key=lambda r: int(r[f"sp{n}/sp_index"]))
    assert len(row) == n
    return [r[f"sp{n}/{key}"] for r in row]


def _replicated(ranks, n, key):
    vals = [r[f"sp{n}/{key}"] for r in ranks]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])  # every rank agrees
    return vals[0]


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_zero(ranks, ins, n_shards, halo):
    g = ins["halo_zero"]
    xl = g.shape[0] // n_shards
    gp = np.pad(g, ((halo, halo), (0, 0), (0, 0), (0, 0)))
    for i, ext in enumerate(_slabs(ranks, n_shards, f"halo_zero/{halo}")):
        np.testing.assert_array_equal(ext, gp[i * xl:i * xl + xl + 2 * halo])


@pytest.mark.parametrize("n_shards", SHARDS)
def test_halo_exchange_replicate(ranks, ins, n_shards):
    g, halo = ins["halo_replicate"], 2
    xl = g.shape[0] // n_shards
    gp = np.concatenate([np.repeat(g[:1], halo, 0), g,
                         np.repeat(g[-1:], halo, 0)])
    for i, ext in enumerate(_slabs(ranks, n_shards, "halo_replicate")):
        np.testing.assert_array_equal(ext, gp[i * xl:i * xl + xl + 2 * halo])


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_smooth_matches_dense(ranks, ins, n_shards):
    dense = np.asarray(smooth_grid(jnp.asarray(ins["smooth"]), 5, 0.8))
    out = np.concatenate(_slabs(ranks, n_shards, "smooth"))
    np.testing.assert_allclose(out, dense, atol=1e-6)


@pytest.mark.parametrize("mode", W.SDF_GRAD_MODES)
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_sdf_gradient_matches_dense(ranks, ins, mode, n_shards):
    dense = np.asarray(sdf_gradient(jnp.asarray(ins["sdf_gradient"]), 0.37,
                                    mode))
    out = np.concatenate(_slabs(ranks, n_shards, f"sdf_gradient/{mode}"))
    np.testing.assert_allclose(out, dense, atol=1e-5)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_trilinear_matches_dense(ranks, ins, n_shards):
    dense = np.asarray(trilinear_sample_index(
        jnp.asarray(ins["trilinear"]), jnp.asarray(ins["trilinear_idx"])))
    out = _replicated(ranks, n_shards, "trilinear")
    np.testing.assert_allclose(out, dense, atol=1e-5)


def _dense_grad(grid, idx, cot):
    return np.asarray(jax.grad(lambda g: jnp.sum(
        trilinear_sample_index(g, jnp.asarray(idx)) * jnp.asarray(cot)))(
            jnp.asarray(grid)))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_trilinear_grid_grad_matches_dense(ranks, ins, n_shards):
    """VJP parity: the grid gradient through the sharded gather (halo
    cotangents routed back to their owners) equals the dense one."""
    want = _dense_grad(ins["grid_grad"], ins["grid_grad_idx"],
                       ins["grid_grad_cot"])
    got = np.concatenate(_slabs(ranks, n_shards, "grid_grad"))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_spatial_gather_on_unequal_slabs(ranks, ins, n_shards):
    """The training gather over a 15-plane grid (slabs 8 + 7, 4 + 4 + 4 +
    3, padded inside the gather): values and the gathered grid gradient
    against the dense JAX gather."""
    grid, idx, cot = ins["gather15"], ins["gather15_idx"], ins["gather15_cot"]
    dense = np.asarray(trilinear_sample_index(jnp.asarray(grid),
                                              jnp.asarray(idx)))
    np.testing.assert_allclose(_replicated(ranks, n_shards, "gather15"),
                               dense, atol=1e-5)
    np.testing.assert_allclose(
        _replicated(ranks, n_shards, "gather15_grad"),
        _dense_grad(grid, idx, cot), atol=1e-4)


@pytest.mark.parametrize("x,sp", [(16, 4), (15, 4), (15, 2), (9, 4), (10, 4)])
def test_slab_bounds_tile_the_grid(x, sp):
    """Slabs of ceil(x / sp) planes, the last one shorter, cover every
    plane once."""
    class M:
        pass

    planes = []
    for i in range(sp):
        m = M()
        m.sp, m.sp_index = sp, i
        x0, x1 = slab_bounds(x, m)
        assert x1 - x0 <= -(-x // sp)
        planes += list(range(x0, x1))
    assert planes == list(range(x))
