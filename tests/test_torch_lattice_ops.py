"""The port's lattice-engine ops against the JAX package (CPU).

Inputs come from numpy seeds and go through ``fgs_nerf_tpu`` and
``fgs_nerf_tpu_torch``; the port runs its plain paths (CPU tensors,
so kernel B7's wrapper takes its ``index_add_`` twin), the JAX package
its CPU paths (the serial scatter-add of ``ops/scatter.py:57-64`` and the
float32 cell pack of ``ops/interp.py:148-154``).

Tolerances and why:
* B7 twin against the JAX CPU accumulate: both add each row's run
  serially in sample order, so they agree bit for bit.
* ``corner_scatter_grid_grad``: the cases of ``tests/test_scatter.py``,
  at its tolerance (atol 5e-4 / rtol 1e-4): the JAX sort is not stable
  and its updates may meet in another order.
* B7 twin against ``dense_accumulate_pallas(interpret=True)``: the
  Pallas kernel casts the updates to bf16 (`scatter_combine.py:149`), so
  the updates are made bf16-representable; its one-hot MXU product then
  sums exact products in float32 in another order: rtol 1e-5 (atol 1e-5
  for sums that cancel to near zero).  On the edge streams of
  ``test_torch_streams.py`` the twin equals the JAX CPU accumulate bit
  for bit, and the Pallas kernel on integer-valued updates (exact in
  bf16, every partial sum exact in float32, so any order gives the same
  floats) at the streams' small row spaces.
* gathers, taps and lookups: the same float32 expressions on both sides,
  values within 1e-6; gradients by reassociation within 1e-5; boolean
  lookups exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgs_nerf_tpu.core.box import SceneBox as SceneBoxJ
from fgs_nerf_tpu.models.mlp import mlp_apply as mlp_apply_j
from fgs_nerf_tpu.ops import interp as IJ
from fgs_nerf_tpu.ops.encoding import sincos_encode as sincos_encode_j
from fgs_nerf_tpu.ops.pallas.scatter_combine import dense_accumulate_pallas
from fgs_nerf_tpu.ops.ray_sample import sample_along_rays as sample_along_rays_j
from fgs_nerf_tpu.ops.scatter import _dense_accumulate as dense_accumulate_j
from fgs_nerf_tpu.ops.scatter import corner_scatter_grid_grad as csgg_j
from fgs_nerf_tpu.ops.sdf2alpha import neus_alpha as neus_alpha_j

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models.mlp import mlp_apply
from fgs_nerf_tpu_torch.ops import interp as IT
from fgs_nerf_tpu_torch.ops.cuda import scatter_combine as B7
from fgs_nerf_tpu_torch.ops.encoding import freq_bank, sincos_encode
from fgs_nerf_tpu_torch.ops.ray_sample import sample_along_rays
from fgs_nerf_tpu_torch.ops.scatter import corner_scatter_grid_grad
from fgs_nerf_tpu_torch.ops.sdf2alpha import neus_alpha
from test_torch_streams import B7_CHANNELS, CASES, b7_stream

XYZ_MIN = np.array([-1.0, -1.0, -1.0], np.float32)
XYZ_MAX = np.array([1.0, 1.0, 1.0], np.float32)


def _boxes():
    return SceneBoxJ.create(XYZ_MIN, XYZ_MAX), SceneBox.create(XYZ_MIN, XYZ_MAX,
                                                               "cpu")


# the four index makers of tests/test_scatter.py
def _uniform(r, m):
    return r.uniform(0, 6.99, size=(m, 3))


def _heavy_duplicates(r, m):
    cells = r.integers(0, 3, size=(m, 3)).astype(np.float64)
    return cells + r.uniform(0, 1, size=(m, 3))


def _oob_and_borders(r, m):
    base = r.uniform(-3.0, 9.0, size=(m, 3))
    base[: m // 8] = 0.0
    base[m // 8: m // 4] = 4.0
    return base


def _more_than_block(r, m):
    return r.uniform(0, 2.99, size=(m, 3))


SCATTER_CASES = {
    "uniform": ((9, 8, 7, 3), 5000, _uniform),
    "heavy_duplicates": ((6, 6, 6, 2), 4000, _heavy_duplicates),
    "oob_and_borders": ((5, 5, 5, 4), 3000, _oob_and_borders),
    "more_samples_than_block": ((4, 4, 4, 1), 6000, _more_than_block),
}


@pytest.mark.parametrize("name", sorted(SCATTER_CASES))
def test_corner_scatter_grid_grad_matches_jax(name):
    grid_shape, m, maker = SCATTER_CASES[name]
    rng = np.random.default_rng(777)
    idx = maker(rng, m).astype(np.float32)
    g = rng.normal(size=(m, grid_shape[-1])).astype(np.float32)
    i0 = np.floor(idx).astype(np.int32)
    fr = idx - i0
    want = np.asarray(csgg_j(jnp.asarray(i0), jnp.asarray(fr), jnp.asarray(g),
                             grid_shape))
    got = corner_scatter_grid_grad(torch.from_numpy(i0), torch.from_numpy(fr),
                                   torch.from_numpy(g), grid_shape).numpy()
    assert got.dtype == np.float32 and got.shape == grid_shape
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


def _sorted_stream(rng, m, cap, c):
    """Sorted rows with gaps, a heavy run and a tail, as in
    ``tests/test_pallas_interpret.py:205-211``."""
    vals = np.concatenate([
        np.full(m // 3, 5),
        rng.integers(cap // 20, cap // 10, size=m // 3),
        rng.integers(cap - cap // 20, cap, size=m - 2 * (m // 3)),
    ])
    rows = np.sort(vals).astype(np.int32)
    upd = rng.normal(size=(m, c)).astype(np.float32)
    return rows, upd


@pytest.mark.parametrize("c", [1, 8, 13])
def test_b7_twin_matches_jax_cpu_accumulate(c):
    rng = np.random.default_rng(c)
    rows, upd = _sorted_stream(rng, 3000, 4000, c)
    want = np.asarray(dense_accumulate_j(jnp.asarray(rows), jnp.asarray(upd),
                                         4000))
    got = B7.dense_accumulate(torch.from_numpy(rows), torch.from_numpy(upd),
                              4000)
    assert got.dtype == torch.float32 and got.shape == (4000, c)
    np.testing.assert_array_equal(got.numpy(), want)
    # every row written: the gaps are zeros
    hit = np.zeros(4000, bool)
    hit[rows] = True
    assert np.all(got.numpy()[~hit] == 0.0)


def test_b7_twin_matches_pallas_interpret():
    rng = np.random.default_rng(6)
    m, cap, c = 3 * 512, 20 * 512, 128
    vals = np.concatenate([
        np.full(m // 3, 5),
        rng.integers(512, 2 * 512, size=m // 3),
        rng.integers(15 * 512, 16 * 512, size=m - 2 * (m // 3)),
    ])
    rows = np.sort(vals).astype(np.int32)
    upd = np.array(jnp.asarray(rng.normal(size=(m, c)).astype(np.float32))
                   .astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(dense_accumulate_pallas(
        jnp.asarray(rows), jnp.asarray(upd), cap, block=512, interpret=True))
    got = B7.dense_accumulate(torch.from_numpy(rows), torch.from_numpy(upd),
                              cap).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


_accumulate_jit = jax.jit(dense_accumulate_j, static_argnums=2)
_pallas_jit = jax.jit(functools.partial(dense_accumulate_pallas, block=512,
                                        interpret=True), static_argnums=2)


@pytest.mark.parametrize("c", B7_CHANNELS)
@pytest.mark.parametrize("case", CASES)
def test_b7_twin_matches_jax_cpu_accumulate_on_edge_streams(case, c):
    rows, upd, cap = b7_stream(case, c)
    want = np.asarray(_accumulate_jit(jnp.asarray(rows), jnp.asarray(upd),
                                      cap))
    got = B7.dense_accumulate(torch.from_numpy(rows), torch.from_numpy(upd),
                              cap)
    assert got.shape == (cap, c) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [1, 128])  # C = 8: the JAX CPU cases above
@pytest.mark.parametrize("case", ["two_chunks", "edges", "one", "short"])
def test_b7_twin_matches_pallas_interpret_on_edge_streams(case, c):
    rows, upd, cap = b7_stream(case, c)
    upd = np.round(upd * 4.0).astype(np.float32)
    want = np.asarray(_pallas_jit(jnp.asarray(rows), jnp.asarray(upd), cap))
    got = B7.dense_accumulate(torch.from_numpy(rows), torch.from_numpy(upd),
                              cap).numpy()
    np.testing.assert_array_equal(got, want)


def _grid_and_points(seed, shape, m, lo=-1.1, hi=1.1):
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=shape).astype(np.float32)
    xyz = rng.uniform(lo, hi, size=(m, 3)).astype(np.float32)
    cot = rng.normal(size=(m, shape[-1])).astype(np.float32)
    return grid, xyz, cot


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_trilinear_sample_and_grid_grad(packed):
    grid, xyz, cot = _grid_and_points(3, (8, 9, 7, 3), 4000)
    box_j, box_t = _boxes()
    assert IT.pack_worthwhile(grid.shape, 4000) == IJ.pack_worthwhile(
        grid.shape, 4000) == True  # noqa: E712

    def loss_j(g):
        out = IJ.trilinear_sample(g, jnp.asarray(xyz), box_j, packed=packed)
        return jnp.sum(out * cot), out

    (_, out_j), grad_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(grid))
    g_t = torch.from_numpy(grid).requires_grad_(True)
    out_t = IT.trilinear_sample(g_t, torch.from_numpy(xyz), box_t,
                                packed=packed)
    (grad_t,) = torch.autograd.grad(torch.sum(out_t * torch.from_numpy(cot)),
                                    g_t)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=1e-5,
                               atol=1e-5)


def test_pack_worthwhile_rule():
    for shape, n in [((256, 256, 256, 13), 4_194_304),
                     ((114, 114, 114, 16), 2_359_296),
                     ((20, 20, 20, 16), 100), ((20, 20, 20, 16), 2000)]:
        assert IT.pack_worthwhile(shape, n) == IJ.pack_worthwhile(shape, n)
    assert not IT.pack_worthwhile((256, 256, 256, 13), 4_194_304)
    assert IT.pack_worthwhile((114, 114, 114, 16), 2_359_296)


@pytest.mark.parametrize("use_grad_norm", [False, True])
def test_sample_sdf_taps(use_grad_norm):
    grid, xyz, _ = _grid_and_points(4, (9, 8, 10, 1), 300, -1.3, 1.3)
    disp = (0.5, 1.0, 1.5, 2.0)
    box_j, box_t = _boxes()
    rng = np.random.default_rng(9)
    cf = rng.normal(size=(300, 6, 4)).astype(np.float32)
    cg = rng.normal(size=(300, 3, 4)).astype(np.float32)

    def loss_j(g):
        feat, grad = IJ.sample_sdf_taps(g, jnp.asarray(xyz), box_j, disp, 0.25,
                                        use_grad_norm)
        return jnp.sum(feat * cf) + jnp.sum(grad * cg), (feat, grad)

    (_, (feat_j, grad_j)), gg_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(grid))
    g_t = torch.from_numpy(grid).requires_grad_(True)
    feat_t, grad_t = IT.sample_sdf_taps(g_t, torch.from_numpy(xyz), box_t,
                                        disp, 0.25, use_grad_norm)
    (gg_t,) = torch.autograd.grad(
        torch.sum(feat_t * torch.from_numpy(cf))
        + torch.sum(grad_t * torch.from_numpy(cg)), g_t)
    np.testing.assert_allclose(feat_t.detach().numpy(), np.asarray(feat_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad_t.detach().numpy(), np.asarray(grad_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gg_t.numpy(), np.asarray(gg_j), rtol=1e-5,
                               atol=1e-5)


def test_center_gradient_taps():
    grid, xyz, _ = _grid_and_points(5, (10, 9, 8, 1), 200)
    box_j, box_t = _boxes()
    gj, fj = IJ.center_gradient_taps(jnp.asarray(grid), jnp.asarray(xyz),
                                     box_j, 0.2)
    gt, ft = IT.center_gradient_taps(torch.from_numpy(grid),
                                     torch.from_numpy(xyz), box_t, 0.2)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6, atol=1e-6)


def test_nearest_bool_lookup():
    rng = np.random.default_rng(8)
    mask = rng.uniform(size=(7, 9, 8)) > 0.5
    xyz = rng.uniform(-1.2, 1.2, size=(3000, 3)).astype(np.float32)
    box_j, box_t = _boxes()
    want = np.asarray(IJ.nearest_bool_lookup(jnp.asarray(mask),
                                             jnp.asarray(xyz), box_j))
    got = IT.nearest_bool_lookup(torch.from_numpy(mask), torch.from_numpy(xyz),
                                 box_t).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_sample_along_rays_and_neus_alpha():
    rng = np.random.default_rng(2)
    n = 40
    rays_o = (np.array([0.0, 0.1, 2.6], np.float32)
              + rng.normal(size=(n, 3)).astype(np.float32) * 0.2)
    rays_d = (rng.normal(size=(n, 3)).astype(np.float32) * 0.4
              - rays_o).astype(np.float32)
    box_j, box_t = _boxes()
    rj = sample_along_rays_j(jnp.asarray(rays_o), jnp.asarray(rays_d), box_j,
                             0.2, 0.05, 96)
    rt = sample_along_rays(torch.from_numpy(rays_o), torch.from_numpy(rays_d),
                           box_t, 0.2, 0.05, 96)
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    np.testing.assert_array_equal(rt.n_steps.numpy(), np.asarray(rj.n_steps))
    np.testing.assert_allclose(rt.pts.numpy(), np.asarray(rj.pts), rtol=1e-6,
                               atol=1e-6)
    vd = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    sdf = rng.normal(size=(n, 96)).astype(np.float32) * 0.1
    grads = rng.normal(size=(n, 96, 3)).astype(np.float32)
    aj = neus_alpha_j(jnp.asarray(vd), jnp.asarray(sdf), jnp.asarray(grads),
                      jnp.float32(0.05), jnp.float32(0.2))
    at = neus_alpha(torch.from_numpy(vd), torch.from_numpy(sdf),
                    torch.from_numpy(grads), 0.05, torch.tensor(0.2))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_sincos_and_mlp_apply(bf16):
    """The channel-last head: encodings equal; the MLP within float32
    reassociation, and with bf16 within one bf16 ulp of a hidden value
    (the rounding points are the same, the sums' order is not)."""
    rng = np.random.default_rng(12)
    x3 = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    ej = np.asarray(sincos_encode_j(jnp.asarray(x3), jnp.asarray(
        [2.0**i for i in range(4)], jnp.float32)))
    et = sincos_encode(torch.from_numpy(x3), freq_bank(4)).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-6, atol=1e-6)
    dims = (27, 32, 32, 3)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
        params[f"b{i}"] = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
    yj = np.asarray(mlp_apply_j({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(ej), bf16=bf16)).astype(np.float32)
    yt = mlp_apply({k: torch.from_numpy(v) for k, v in params.items()},
                   torch.from_numpy(et), bf16=bf16)
    assert yt.dtype == torch.float32
    tol = 3e-2 if bf16 else 1e-5
    np.testing.assert_allclose(yt.numpy(), yj, rtol=tol, atol=tol)
