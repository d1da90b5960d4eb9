"""The program's span recorder (``fgs_nerf_tpu_torch/utils/profiling.py``)
on the CPU: off by default and free of effect on the step's numbers; on,
the span tree of the train step, the stage loop and the evaluation, the
shading head's fill counters, parents across threads, and the spans
written into ``trace_steps``' Chrome trace.  Imports no JAX."""
import dataclasses
import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from fgs_nerf_tpu_torch.config.base import deep_update, load_config
from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from fgs_nerf_tpu_torch.eval import render as RD
from fgs_nerf_tpu_torch.models import sdf_voxel as M
from fgs_nerf_tpu_torch.optim.masked_adam import ParamOpts, init_state
from fgs_nerf_tpu_torch.train import bbox as BB
from fgs_nerf_tpu_torch.train import trainer as TR
from fgs_nerf_tpu_torch.train.losses import LossWeights
from fgs_nerf_tpu_torch.utils import profiling as P

BOX = (np.array([-1.0, -1.0, -1.0], np.float32),
       np.array([1.0, 1.0, 1.0], np.float32))
N_RAYS = 64


@pytest.fixture(autouse=True)
def recorder_off():
    P.disable()
    yield
    P.disable()


def _coarse_step(engine, device="cpu"):
    """A coarse step (TV injected, the head recomputed in the backward)
    and its inputs, at 16^3 voxels and ``N_RAYS`` rays."""
    cfg = M.make_model_config(
        stage="coarse", xyz_min=BOX[0], xyz_max=BOX[1], num_voxels=16**3,
        num_voxels_base=16**3, stepsize=0.5, k0_dim=4, refnet_width=16,
        refnet_depth=3, posbase_pe=2, viewbase_pe=1, refbase_pe=2,
        s_ratio=50.0, s_start=0.2, shade_k=16, engine=engine)
    assert cfg.shade_remat
    box = SceneBox.create(*BOX, device=device)
    params = M.init_params(torch.Generator(device).manual_seed(3), cfg,
                           device)
    opts = {k: ParamOpts(skip_zero_grad=k in ("k0", "sdf")) for k in params}
    step = TR.make_train_step(
        cfg, box, LossWeights(weight_main=1.0, weight_entropy_last=1e-3,
                              weight_orientation=1e-4, sigmoid_rgb_loss=0.1,
                              weight_tv_density=0.01, ori_tv=False),
        opts, near=0.2, bg=1.0, n_rand=N_RAYS, sdf_tv=0.1,
        smooth_grad_tv=0.05, inject_tv=True, tv_dense=True,
        weight_tv_density=0.01, weight_tv_k0=0.01, use_nonempty_mask=False)
    rng = np.random.default_rng(5)
    o = np.full((N_RAYS, 3), [0, 0, 3.0], np.float32)
    o += rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.2
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.3 - o
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    lrs = {k: torch.tensor(0.1 if k in ("sdf", "k0") else 1e-3,
                           device=device) for k in params}
    args = (params, init_state(params), {},
            *(torch.as_tensor(a, device=device) for a in (o, d, v, t)),
            torch.tensor(0.2, device=device), lrs,
            torch.tensor(1.0, device=device))
    return cfg, step, args


def _fine_step():
    """A sorted fine step (the head on its stream's live prefix) and its
    inputs, at 16^3 voxels, ``N_RAYS`` rays and shade_k 32."""
    cfg = M.make_model_config(
        stage="fine", xyz_min=BOX[0], xyz_max=BOX[1], num_voxels=16**3,
        num_voxels_base=16**3, stepsize=0.5, k0_dim=4, refnet_width=16,
        refnet_depth=3, rgbnet_width=16, rgbnet_depth=3, posbase_pe=2,
        viewbase_pe=1, refbase_pe=2, s_ratio=50.0, s_start=0.2, shade_k=32,
        sample_k=48, grad_feat=(0.5, 1.0), sdf_feat=(0.5, 1.0),
        fast_color_thres=1e-4, shade_remat=False, engine="sorted")
    assert cfg.all_displace and 1.0 in cfg.all_displace
    params = M.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    opts = {k: ParamOpts(skip_zero_grad=k in ("k0", "sdf")) for k in params}
    step = TR.make_train_step(
        cfg, SceneBox.create(*BOX, device="cpu"),
        LossWeights(weight_main=1.0, weight_entropy_last=1e-3,
                    weight_orientation=1e-4, sigmoid_rgb_loss=0.02),
        opts, near=0.2, bg=1.0, n_rand=N_RAYS, sdf_tv=0.1,
        smooth_grad_tv=0.05, inject_tv=False, tv_dense=False,
        weight_tv_density=0.0, weight_tv_k0=0.0, use_nonempty_mask=False)
    rng = np.random.default_rng(5)
    o = np.full((N_RAYS, 3), [0, 0, 3.0], np.float32)
    o += rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.2
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.3 - o
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    lrs = {k: torch.tensor(1e-3) for k in params}
    args = (params, init_state(params), {},
            *(torch.as_tensor(a) for a in (o, d, v, t)), torch.tensor(0.2),
            lrs, torch.tensor(1.0))
    return cfg, step, args


def _flat(tree, prefix=""):
    """(path, tensor) of a step's output: dicts, tuples, ``AdamState``."""
    if dataclasses.is_dataclass(tree):
        tree = dataclasses.asdict(tree)
    if isinstance(tree, (tuple, list)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items()
                for k2, v in _flat(sub, f"{prefix}{k}.").items()}
    return {prefix: tree}


def _paths(spans):
    """Each span's path of names from its root, by parent ids."""
    by_id = {s.id: s for s in spans}

    def path(s):
        return (path(by_id[s.parent]) + "/" if s.parent is not None
                else "") + s.name
    return [path(s) for s in spans]


def test_off_span_is_one_shared_object_and_export_is_empty():
    assert not P.recording()
    assert P.span("forward") is P.span("backward")
    with P.span("forward"):
        P.count("head_rows", 5)
    assert P.export() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("engine", ["sorted", "lattice"])
def test_step_is_bit_equal_with_the_recorder_on(engine):
    """The same step with the recorder off and on: every new parameter,
    moment and metric bit for bit."""
    _, step, args = _coarse_step(engine)
    off = _flat(step(*args))
    P.enable()
    on = _flat(step(*args))
    rec = P.export()
    assert rec["spans"] and rec["counters"]
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.parametrize("engine", ["sorted", "lattice"])
def test_train_step_span_tree_and_head_fill(engine):
    cfg, step, args = _coarse_step(engine)
    P.enable()
    _, _, metrics = step(*args)
    rec = P.export()
    assert P.export() == {"spans": [], "counters": {}}   # export cleared it
    paths = _paths(rec["spans"])
    assert Counter(paths) == Counter([
        "train_step", "train_step/forward", "train_step/forward/shade",
        "train_step/loss", "train_step/backward",
        "train_step/backward/shade", "train_step/metrics", "train_step/tv",
        "train_step/adam"])
    me = threading.get_native_id()
    assert all(s.tid == me and s.start <= s.end for s in rec["spans"])
    by = {p: s for p, s in zip(paths, rec["spans"])}
    root = by["train_step"]
    for p, s in by.items():
        if p != "train_step":
            assert root.start <= s.start <= s.end <= root.end, p
    order = [p for p, _ in sorted(by.items(), key=lambda kv: kv[1].start)]
    assert order.index("train_step/forward") < order.index("train_step/loss") \
        < order.index("train_step/backward") < order.index("train_step/tv") \
        < order.index("train_step/adam")
    # the head computes rays x shade_k rows (sorted coarse: every slot)
    slots = cfg.sample_k if 0 < cfg.sample_k < cfg.s_max else cfg.s_max
    rows = rec["counters"]["head_rows"]
    assert rows == N_RAYS * (cfg.shade_k if engine == "lattice" else slots)
    assert 0 < rec["counters"]["head_live_rows"] <= rows
    assert isinstance(rec["counters"]["head_live_rows"], int)
    assert np.isfinite(float(metrics["loss"]))


def test_sorted_fine_head_counts_its_live_prefix():
    """The sorted fine head computes its stream's live rows rounded up to
    ``HEAD_ROW_MULTIPLE`` (at most rays x shade_k), read on the host
    once a step inside ``forward/head_count``."""
    cfg, step, args = _fine_step()
    P.enable()
    _, _, metrics = step(*args)
    rec = P.export()
    paths = Counter(_paths(rec["spans"]))
    assert paths["train_step/forward/head_count"] == 1
    assert paths["train_step/forward/shade"] == 1
    live = rec["counters"]["head_live_rows"]
    rows = rec["counters"]["head_rows"]
    cap = N_RAYS * cfg.shade_k
    mult = M.HEAD_ROW_MULTIPLE
    assert rows == min(-(-live // mult) * mult, cap)
    assert 0 < live <= rows <= cap
    assert live < cap - mult        # the batch has dead slots ...
    assert rows < cap               # ... which the head does not compute
    assert np.isfinite(float(metrics["loss"]))


def test_a_thread_without_open_spans_takes_the_enabling_threads_span():
    """As autograd's worker thread does: its spans hang under the span
    open on the thread that turned the recorder on."""
    P.enable()
    got = {}

    def worker():
        with P.span("shade"):
            with P.span("inner"):
                got["tid"] = threading.get_native_id()

    with P.span("backward"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    P.count("rows", 3)
    P.count("rows", torch.tensor(4))
    P.count("rows", torch.tensor([5]).sum())
    rec = P.export()
    by = {s.name: s for s in rec["spans"]}
    assert by["shade"].parent == by["backward"].id
    assert by["inner"].parent == by["shade"].id
    assert by["backward"].parent is None
    assert by["shade"].tid == got["tid"] != by["backward"].tid
    assert rec["counters"] == {"rows": 12}


def test_stage_loop_spans():
    """Three geometry steps with a rung at step 2, a flush every second
    step, the validation render and the checkpoint at the end."""
    cfg = load_config("shiny_blender")
    cfg.update(deep_update(dict(cfg), dict(
        geometry_searching=dict(N_iters=3, N_rand=128, pg_scale=[2],
                                reset_iter=[], inc_steps=2, save_iter=10**9,
                                decay_step_module={}),
        geometry_searching_model=dict(num_voxels=12**3,
                                      num_voxels_base=12**3, shade_k=16))))
    data = make_synthetic_dataset(n_views=3, h=16, w=16, n_test=1)
    xyz_min, xyz_max = BB.compute_bbox_by_cam_frustrm(cfg, data)
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        P.enable()
        TR.train_stage(cfg, "geometry_searching", data, xyz_min, xyz_max,
                       out, i_print=2, i_validate=3, device="cpu")
        rec = P.export()
    paths = Counter(_paths(rec["spans"]))
    assert paths["stage_step"] == 3
    assert paths["stage_step/batch"] == 3
    assert paths["stage_step/train_step"] == 3
    assert paths["stage_step/rung"] == 1
    assert paths["stage_step/flush"] == 2
    assert paths["stage_step/validate"] == 1
    assert paths["stage_step/validate/render_view"] == 1
    assert paths["stage_step/checkpoint"] == 1


def test_render_viewpoints_spans(monkeypatch):
    """One 24 x 20 view in 128-ray chunks: ``render_view`` > ``rays``,
    ``to_host`` for each of its 4 chunks, ``score``."""
    cfg = M.make_model_config(
        stage="coarse", xyz_min=BOX[0], xyz_max=BOX[1], num_voxels=12**3,
        num_voxels_base=12**3, stepsize=0.5, k0_dim=4, refnet_width=16,
        refnet_depth=3, posbase_pe=2, viewbase_pe=1, refbase_pe=2,
        s_ratio=50.0, s_start=0.2, shade_k=16)
    params = M.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    data = make_synthetic_dataset(n_views=1, h=24, w=20, n_test=1)
    i = data["i_test"]
    fn = RD.make_render_fn(cfg, SceneBox.create(*BOX, device="cpu"),
                           near=2.0, bg=1.0)

    real = RD.render_image
    monkeypatch.setattr(RD, "render_image",
                        lambda *a, **kw: real(*a, chunk=128, **kw))
    P.enable()
    stats = RD.render_viewpoints(
        fn, params, {}, data["poses"][i], data["HW"][i], data["Ks"][i],
        dict(ndc=False, inverse_y=False, flip_x=False, flip_y=False), 0.2,
        gt_imgs=data["images"][i], masks=data["masks"][i])
    rec = P.export()
    assert len(stats["psnr"]) == 1 and len(stats["ssim"]) == 1
    paths = Counter(_paths(rec["spans"]))
    assert paths == Counter({"render_view": 1, "render_view/rays": 1,
                             "render_view/to_host": 4, "render_view/shade": 4,
                             "render_view/score": 1})
    assert rec["counters"]["head_rows"] == 4 * 128 * cfg.shade_k


def test_trace_steps_writes_the_program_spans(tmp_path):
    """``trace_steps(..., device="cpu")`` turns the recorder on for its
    block, writes the program's spans into its Chrome trace on the
    trace's clock, and leaves the recorder off."""
    _, step, args = _coarse_step("sorted")
    with P.trace_steps(str(tmp_path), device="cpu") as trace:
        assert P.recording()
        step(*args)
    assert not P.recording()
    with open(trace.path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program"]
    assert Counter(s["name"] for s in spans)["train_step"] == 1
    assert {s["name"] for s in spans} >= {"forward", "shade", "loss",
                                          "backward", "tv", "adam"}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    root = next(s for s in spans if s["name"] == "train_step")
    # the step's host operators run inside its span, on the same clock
    inside = [e for e in ops if root["ts"] <= e["ts"]
              <= root["ts"] + root["dur"]]
    assert len(inside) >= 0.9 * len([e for e in ops if e["ts"] > root["ts"]])
    by_id = {s["args"]["id"]: s for s in spans}
    fwd = next(s for s in spans if s["name"] == "forward")
    assert by_id[fwd["args"]["parent"]]["name"] == "train_step"
