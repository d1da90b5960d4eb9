"""Masked Adam: the plain twin on the CPU, the layout plan of the kernel
``ops/cuda/masked_adam.py`` (``csrc/masked_adam.cu``), the engagement
counters, and on the card the kernel against the plain twin bit for bit.

The card tests need an NVIDIA card (sm_90a) and ``nvcc``; without a card
they skip.  The file imports no JAX; on a machine with the card run
``python -m pytest --noconftest tests/test_torch_masked_adam.py -q``.
PyTorch's vectorized CPU square root is not always correctly rounded
(one ulp off on ~0.7% of inputs), so the written-out formula here takes
its square root from ``torch.sqrt`` and every other step from numpy's
float32 arithmetic; the kernel rounds the square root correctly, as
PyTorch's CUDA ``sqrt`` does.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.models import sdf_voxel as M
from fgs_nerf_tpu_torch.ops.cuda import masked_adam as K
from fgs_nerf_tpu_torch.optim import masked_adam as MA
from fgs_nerf_tpu_torch.train import trainer as TR
from fgs_nerf_tpu_torch.train.losses import LossWeights
from fgs_nerf_tpu_torch.utils import profiling as P

B1, B2, EPS = 0.9, 0.99, 1e-8
FINE_WS = (258, 257, 252)  # the fine grid of the `shiny_blender` configuration


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest "
                    "tests/test_torch_masked_adam.py` on the H100")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def recorder_off():
    P.disable()
    yield
    P.disable()


def _leaf_inputs(shape, seed, zero_share=0.3):
    """p, g (a share exactly zero, some -0.0), m, v >= 0, plr in [0, 1)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=shape).astype(np.float32)
    g = (rng.normal(size=shape) * 1e-3).astype(np.float32)
    g[rng.random(shape) < zero_share] = 0.0
    g.reshape(-1)[:3] = -0.0
    m = (rng.normal(size=shape) * 1e-3).astype(np.float32)
    v = (rng.random(shape) * 1e-6).astype(np.float32)
    plr = rng.random(shape).astype(np.float32)
    return p, g, m, v, plr


def _bias(step):
    t = torch.tensor(float(step))
    return torch.sqrt(1.0 - torch.pow(B2, t)) / (1.0 - torch.pow(B1, t))


def _written_out(p, g, m, v, plr, lr, bias, skip):
    """The update op by op in float32 (square root: ``torch.sqrt``)."""
    f = np.float32
    m_n = f(B1) * m + f(1.0 - B1) * g
    v_n = f(B2) * v + (f(1.0 - B2) * g) * g
    s = f(lr) * f(bias)
    if plr is not None:
        s = s * plr
    den = torch.sqrt(torch.from_numpy(v_n)).numpy() + f(EPS)
    p_n = p - (s * m_n) / den
    if skip:
        live = g != 0.0
        p_n, m_n, v_n = (np.where(live, a, b) for a, b in
                         ((p_n, p), (m_n, m), (v_n, v)))
    return p_n, m_n, v_n


# ---- CPU: the plain twin and the counters ------------------------------


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("with_plr", [False, True])
def test_cpu_leaves_take_the_plain_twin_and_match_the_formula(
        monkeypatch, skip, with_plr):
    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU leaf reached the kernel")
    monkeypatch.setattr(MA, "masked_adam_step", no_kernel)
    p, g, m, v, plr = _leaf_inputs((7, 5, 3, 4), seed=1)
    state = MA.AdamState(torch.tensor(2, dtype=torch.int32),
                         {"k0": torch.from_numpy(m)},
                         {"k0": torch.from_numpy(v)})
    opts = {"k0": MA.ParamOpts(skip_zero_grad=skip, has_per_lr=with_plr)}
    new_p, new_s = MA.adam_update(
        {"k0": torch.from_numpy(p)}, {"k0": torch.from_numpy(g)}, state,
        {"k0": torch.tensor(0.1)}, opts,
        per_lr={"k0": torch.from_numpy(plr)} if with_plr else None)
    want = _written_out(p, g, m, v, plr if with_plr else None, 0.1,
                        _bias(3).numpy(), skip)
    got = (new_p["k0"], new_s.exp_avg["k0"], new_s.exp_avg_sq["k0"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert int(new_s.step) == 3
    live = g != 0.0
    if skip:   # untouched where the gradient is zero (both signs)
        np.testing.assert_array_equal(got[0].numpy()[~live], p[~live])
    else:
        assert not np.array_equal(got[1].numpy()[~live], m[~live])


def test_adam_counts_the_elements_it_updates():
    params = {"sdf": torch.zeros(4, 5, 6, 1), "k0": torch.zeros(4, 5, 6, 3),
              "refnet": {"w0": torch.zeros(7, 8), "b0": torch.zeros(8)},
              "s_val": torch.zeros(1)}
    grads = MA.tree_map(torch.ones_like, params)
    lrs = {k: 0.1 for k in ("sdf", "k0", "refnet")}   # s_val frozen
    opts = {k: MA.ParamOpts() for k in params}
    MA.adam_update(params, grads, MA.init_state(params), lrs, opts)
    assert P.export() == {"spans": [], "counters": {}}   # recorder off
    P.enable()
    MA.adam_update(params, grads, MA.init_state(params), lrs, opts)
    MA.adam_update(params, grads, MA.init_state(params), lrs, opts)
    counters = P.export()["counters"]
    n = 2 * (120 + 360 + 56 + 8)
    assert counters == {"adam_elems": n, "adam_fused_elems": 0}
    assert all(isinstance(x, int) for x in counters.values())


# ---- CPU: the kernel's layout plan -------------------------------------


def _logical(x, rows, channels, strides):
    """``x`` read as the kernel reads it: [N, C] at the plan's strides."""
    return torch.as_strided(x, (rows, channels), strides, x.storage_offset())


def _layouts(shape):
    """Operands in the layouts the port hands Adam (named), as views."""
    *lead, c = shape
    n = int(np.prod(lead))
    base = torch.arange(n * c, dtype=torch.float32)
    cm_block = torch.arange(16 * n, dtype=torch.float32).reshape(16, *lead)
    last = torch.arange(n * (c + 4), dtype=torch.float32).reshape(*lead, c + 4)
    return {
        "row-major": base.reshape(shape),
        "channel-major": base.reshape(c, *lead).movedim(0, -1),
        # a k0 gradient: channels 4 .. 4 + c of a channel-major field
        "channel-major slice": cm_block[4:4 + c].movedim(0, -1),
        # a channel range of a channel-last field (the lattice engine)
        "row pitch": last[..., 4:4 + c],
    }


@pytest.mark.parametrize("name", ["row-major", "channel-major",
                                  "channel-major slice", "row pitch"])
def test_plan_reads_every_layout_the_port_hands_over(name):
    shape = (5, 6, 7, 3)
    x = _layouts(shape)[name]
    dense = torch.zeros(shape)
    pl = K.plan(dense, x, dense, dense, None, skip_zero_grad=True)
    assert (pl.rows, pl.channels) == (210, 3)
    np.testing.assert_array_equal(
        _logical(x, 210, 3, pl.strides[1]).numpy(), x.reshape(210, 3).numpy())
    # the outputs take the gradient's order (the plain twin's torch.where)
    cm = name.startswith("channel-major")
    assert pl.out == (cm, cm, cm)
    for out, strides in zip(pl.out, pl.strides[5:]):
        y = K._empty(dense, out)
        y.copy_(x)
        np.testing.assert_array_equal(
            _logical(y, 210, 3, strides).numpy(), x.reshape(210, 3).numpy())
    assert pl.flat == (name == "row-major")


def test_plan_of_the_fine_step_k0_first_and_later_steps():
    """The first step: parameters and moments channel-last, the gradient
    channel-major (tiled, outputs channel-major with skip_zero_grad, as
    the plain twin leaves them); from then on all channel-major (flat)."""
    lay = _layouts((4, 5, 6, 12))
    g = lay["channel-major slice"]
    p = lay["row-major"]
    first = K.plan(p, g, p, p, None, skip_zero_grad=True)
    assert not first.flat and first.out == (True, True, True)
    q = K._empty(p, True)
    assert K.plan(q, g, q, q, None, skip_zero_grad=True).flat
    assert K.plan(q, g, q, q, q, skip_zero_grad=True).flat
    # without skip_zero_grad each output keeps its own input's order
    assert K.plan(p, g, p, p, None, skip_zero_grad=False).out == (False,) * 3


@pytest.mark.parametrize("shape", [(1,), (3,), (256,), (307, 256), (256, 3),
                                   (4, 5, 6, 1)])
def test_plan_of_small_and_single_channel_leaves_is_flat(shape):
    x = torch.zeros(shape)
    pl = K.plan(x, x, x, x, None, skip_zero_grad=False)
    assert pl.flat and pl.rows * pl.channels == x.numel()


def test_plan_of_a_padded_weight_slice_is_tiled():
    """A head's last weight reaches Adam as columns of its padded [in, 8]."""
    padded = torch.arange(256 * 8, dtype=torch.float32).reshape(256, 8)
    g = padded[:, :3]
    p = torch.zeros(256, 3)
    pl = K.plan(p, g, p, p, None, skip_zero_grad=False)
    assert not pl.flat and pl.strides[1] == (8, 1)
    np.testing.assert_array_equal(
        _logical(g, 256, 3, pl.strides[1]).numpy(), g.numpy())


@pytest.mark.parametrize("bad", ["transposed lead", "channel stride"])
def test_plan_raises_on_other_layouts(bad):
    p = torch.zeros(4, 5, 6, 3)
    if bad == "transposed lead":
        g = torch.zeros(5, 4, 6, 3).transpose(0, 1)
    else:   # leading dimensions that do not collapse
        g = torch.zeros(4, 5, 7, 3)[:, :, :6]
    with pytest.raises(ValueError, match="masked_adam_step"):
        K.plan(p, g, p, p, None, skip_zero_grad=True)


def test_kernel_wrapper_takes_cuda_tensors_only():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        K.masked_adam_step(x, x, x, x, torch.tensor(0.1), torch.tensor(1.0),
                           None, True, B1, B2, EPS)


# ---- on the card -------------------------------------------------------


def _on(dev, *arrays):
    return [None if a is None else torch.from_numpy(a).to(dev) for a in arrays]


def _both(p, g, m, v, plr, skip, step=3, lr=0.1):
    """Kernel and plain twin on the same CUDA tensors: their outputs."""
    lr_t = torch.tensor(lr, dtype=torch.float32, device=p.device)
    bias = _bias(step).to(p.device)
    kern = K.masked_adam_step(p, g, m, v, lr_t, bias, plr, skip, B1, B2, EPS)
    plain = MA.adam_leaf(p, g, m, v, lr_t, bias, plr, skip, B1, B2, EPS)
    return kern, plain


def _assert_same(kern, plain):
    for a, b in zip(kern, plain):
        assert a.stride() == b.stride()
        assert torch.equal(a, b)
        # bit for bit: also the signs of zeros
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("steady", [False, True])
def test_card_fine_k0_in_the_step_layouts(cuda, skip, steady):
    """[258, 257, 252, 12] with the gradient as the step hands it over:
    channels 4 .. 16 of a channel-major [16, X, Y, Z]; p, m and v
    channel-last on a rung's first step, channel-major after it."""
    shape = FINE_WS + (12,)
    p, g, m, v, _ = _leaf_inputs(shape, seed=2)
    field = torch.zeros((16,) + FINE_WS, device=cuda)
    field[4:] = torch.from_numpy(g).to(cuda).movedim(-1, 0)
    g_t = field[4:].movedim(0, -1)
    p_t, m_t, v_t = _on(cuda, p, m, v)
    if steady:
        p_t, m_t, v_t = (x.movedim(-1, 0).contiguous().movedim(0, -1)
                         for x in (p_t, m_t, v_t))
    assert K.plan(p_t, g_t, m_t, v_t, None, skip).flat == steady
    _assert_same(*_both(p_t, g_t, m_t, v_t, None, skip))


@pytest.mark.parametrize("skip", [False, True])
def test_card_fine_sdf(cuda, skip):
    p, g, m, v, _ = _leaf_inputs(FINE_WS + (1,), seed=3)
    _assert_same(*_both(*_on(cuda, p, g, m, v), None, skip))


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("zero_share", [0.0, 0.5, 1.0])
def test_card_zero_gradients(cuda, skip, zero_share):
    p, g, m, v, _ = _leaf_inputs((64, 48, 40, 1), seed=4,
                                 zero_share=zero_share)
    _assert_same(*_both(*_on(cuda, p, g, m, v), None, skip))


@pytest.mark.parametrize("layout", ["flat", "tiled"])
def test_card_per_voxel_lr(cuda, layout):
    p, g, m, v, plr = _leaf_inputs((40, 41, 42, 3), seed=5)
    p_t, g_t, m_t, v_t, plr_t = _on(cuda, p, g, m, v, plr)
    if layout == "tiled":
        g_t = g_t.movedim(-1, 0).contiguous().movedim(0, -1)
    assert K.plan(p_t, g_t, m_t, v_t, plr_t, True).flat == (layout == "flat")
    _assert_same(*_both(p_t, g_t, m_t, v_t, plr_t, True))


@pytest.mark.parametrize("shape", [(7, 13), (1,), (3,), (5,), (307, 256),
                                   (256,), (256, 3), (106, 256), (3, 1, 1, 1)])
@pytest.mark.parametrize("skip", [False, True])
def test_card_small_and_ragged_leaves(cuda, shape, skip):
    _assert_same(*_both(*_on(cuda, *_leaf_inputs(shape, seed=6)[:4]), None,
                        skip))


@pytest.mark.parametrize("case", ["padded weight", "lattice channels",
                                  "misaligned flat",
                                  "misaligned flat, per-voxel lr"])
def test_card_strided_and_misaligned_gradients(cuda, case):
    plr_t = None
    if case == "padded weight":   # columns 0..3 of a padded [256, 8]
        p, g, m, v, _ = _leaf_inputs((256, 8), seed=7)
        p, m, v = (x[:, :3].copy() for x in (p, m, v))
        g_t = torch.from_numpy(g).to(cuda)[:, :3]
    elif case == "lattice channels":   # channels 4..16 of [X, Y, Z, 16]
        p, g, m, v, _ = _leaf_inputs((30, 31, 32, 16), seed=8)
        p, m, v = (x[..., 4:].copy() for x in (p, m, v))
        g_t = torch.from_numpy(g).to(cuda)[..., 4:]
    elif case == "misaligned flat":   # a leaf at an odd offset of a flat
        p, g, m, v, _ = _leaf_inputs((1001,), seed=9)   # buffer (dp)
        g_t = torch.from_numpy(np.concatenate([[0.5], g]).astype(
            np.float32)).to(cuda)[1:]
    else:   # several tiles of one channel, with a per-voxel lr
        p, g, m, v, plr = _leaf_inputs((5001,), seed=10)
        g_t = torch.from_numpy(np.concatenate([[0.5], g]).astype(
            np.float32)).to(cuda)[1:]
        plr_t = _on(cuda, plr)[0]
    p_t, m_t, v_t = _on(cuda, p, m, v)
    pl = K.plan(p_t, g_t, m_t, v_t, plr_t, True)
    assert pl.flat == case.startswith("misaligned flat")
    _assert_same(*_both(p_t, g_t, m_t, v_t, plr_t, True))


def test_card_wrapper_raises_on_other_layouts(cuda):
    p = torch.zeros(4, 5, 6, 3, device=cuda)
    g = torch.zeros(5, 4, 6, 3, device=cuda).transpose(0, 1)
    one = torch.ones((), device=cuda)
    with pytest.raises(ValueError, match="masked_adam_step"):
        K.masked_adam_step(p, g, p, p, one, one, None, True, B1, B2, EPS)
    with pytest.raises(ValueError, match="masked_adam_step"):
        K.masked_adam_step(p, p.double(), p, p, one, one, None, True, B1, B2,
                           EPS)


def _fine_step(dev):
    """A sorted fine step at 16^3 voxels, 64 rays, shade_k 32 (the card's
    kernels throughout), and its inputs."""
    box = (np.array([-1.0] * 3, np.float32), np.array([1.0] * 3, np.float32))
    cfg = M.make_model_config(
        stage="fine", xyz_min=box[0], xyz_max=box[1], num_voxels=16**3,
        num_voxels_base=16**3, stepsize=0.5, k0_dim=12, refnet_width=16,
        refnet_depth=3, rgbnet_width=16, rgbnet_depth=3, posbase_pe=2,
        viewbase_pe=1, refbase_pe=2, s_ratio=50.0, s_start=0.2, shade_k=32,
        sample_k=48, grad_feat=(0.5, 1.0), sdf_feat=(0.5, 1.0),
        fast_color_thres=1e-4, engine="sorted")
    params = M.init_params(torch.Generator(dev).manual_seed(3), cfg, dev)
    opts = {k: MA.ParamOpts(skip_zero_grad=k == "k0") for k in params}
    step = TR.make_train_step(
        cfg, SceneBox.create(*box, device=dev),
        LossWeights(weight_main=1.0, weight_entropy_last=1e-3,
                    weight_orientation=1e-4, sigmoid_rgb_loss=0.02),
        opts, near=0.2, bg=1.0, n_rand=64, sdf_tv=0.1, smooth_grad_tv=0.05,
        inject_tv=True, tv_dense=True, weight_tv_density=0.01,
        weight_tv_k0=0.0, use_nonempty_mask=False)
    rng = np.random.default_rng(5)
    o = np.full((64, 3), [0, 0, 3.0], np.float32)
    o += rng.normal(size=(64, 3)).astype(np.float32) * 0.2
    d = rng.normal(size=(64, 3)).astype(np.float32) * 0.3 - o
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(size=(64, 3)).astype(np.float32)
    lrs = {k: torch.tensor(1e-3, device=dev) for k in params if k != "s_val"}
    rays = [torch.as_tensor(a, device=dev) for a in (o, d, vd, t)]
    return step, params, rays, lrs


def test_card_whole_fine_steps_fused_equal_plain(cuda, monkeypatch):
    """Three sorted fine steps: inside each, every leaf's kernel update
    equals the plain twin's on the same gradient, bit for bit and in the
    same layout; the k0 leaf takes the tiled pass on the first step and
    the flat pass after it."""
    kernel = K.masked_adam_step
    seen = []

    def checked(p, g, m, v, lr, bias, plr, skip, b1, b2, eps):
        kern = kernel(p, g, m, v, lr, bias, plr, skip, b1, b2, eps)
        plain = MA.adam_leaf(p, g, m, v, lr, bias, plr, skip, b1, b2, eps)
        _assert_same(kern, plain)
        seen.append((tuple(p.shape), K.plan(p, g, m, v, plr, skip).flat))
        return kern
    monkeypatch.setattr(MA, "masked_adam_step", checked)
    step, params, rays, lrs = _fine_step(cuda)
    opt = MA.init_state(params)
    P.enable()
    for _ in range(3):
        params, opt, metrics = step(params, opt, {}, *rays,
                                    torch.tensor(0.2, device=cuda), lrs,
                                    torch.tensor(1.0, device=cuda))
        assert torch.isfinite(metrics["loss"])
    counters = P.export()["counters"]
    n_leaves = sum(1 for k, x in params.items() if k != "s_val"
                   for _ in MA.tree_leaves(x))
    assert len(seen) == 3 * n_leaves
    assert counters["adam_fused_elems"] == counters["adam_elems"] > 0
    k0 = [flat for shape, flat in seen if shape[-1] == 12 and len(shape) == 4]
    assert k0 == [False, True, True]
    assert dataclasses.is_dataclass(opt)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("name", ["row-major", "channel-major",
                                  "channel-major slice", "row pitch"])
def test_plan_gives_the_outputs_the_plain_twins_layouts(name, skip):
    """The outputs' strides are those the plain twin's own outputs take
    (TensorIterator's, which the CPU and the card share)."""
    shape = (5, 6, 7, 3)
    g = _layouts(shape)[name]
    for p in (torch.zeros(shape), _layouts(shape)["channel-major"] * 0):
        pl = K.plan(p, g, p, p, None, skip)
        plain = MA.adam_leaf(p, g, p, p, torch.tensor(0.1), torch.tensor(1.0),
                             None, skip, B1, B2, EPS)
        assert [K._empty(p, o).stride() for o in pl.out] == \
            [x.stride() for x in plain]


@pytest.mark.parametrize("p_name", ["row-major", "channel-major"])
@pytest.mark.parametrize("g_name", ["row-major", "channel-major",
                                    "channel-major slice", "row pitch"])
def test_plan_is_flat_where_every_operand_shares_one_dense_layout(p_name,
                                                                 g_name):
    """The flat pass (every step but a rung's first) is planned exactly
    where the gradient is dense in the parameters' order, and its outputs
    are then laid out like the parameters."""
    lay = _layouts((5, 6, 7, 3))
    p, g = lay[p_name], lay[g_name]
    same = g_name == p_name or (p_name, g_name) == ("channel-major",
                                                    "channel-major slice")
    for skip in (False, True):
        pl = K.plan(p, g, p, p, None, skip)
        assert pl.flat == same
        if same:
            assert all(K._empty(p, o).stride() == p.stride() for o in pl.out)
