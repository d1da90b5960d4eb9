"""The yardstick's counts: each kernel's logical bytes and operations and
the heads' FLOPs a row, from a cell's shapes alone.

A serve or an accumulate is counted by the logical work it does,
whatever kernel does it: each sample's position (three float32
coordinates) and its values read or written once, and, for an
accumulate, the dense gradient grid written once.  The field values a
serve reads depend on where the samples fall and are not counted, so a
serve's bound is a floor and its share a lower reading.  Heads count
their products: 2 operations a multiply-add, forward 2 M sum(in x out),
backward (input and weight cotangents) twice that.  The bound of a call
is the larger of bytes over the HBM bandwidth and operations over the
peak of the precision it runs in (``PEAKS``; NVIDIA's H100 SXM data
sheet, dense, at 700 W).  The layer sizes are frozen copies of
``models/sdf_voxel.py:SDFModelConfig.rgbnet_in_dim`` / ``refnet_in_dim``
and ``models/mlp.py:refnet_dims`` / ``rgbnet_dims``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

PEAKS = {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12,
         "f32_flops": 67e12}
POS_BYTES = 12  # a sample's position, three float32 coordinates


def n_displace(model: Dict) -> int:
    return len(sorted(set(model.get("grad_feat", ())) |
                      set(model.get("k_grad_feat", (1.0,)))))


def rgbnet_in_dim(model: Dict) -> int:
    d = (3 + 3 * model.get("posbase_pe", 5) * 2) + model.get("k0_dim", 12) + 3
    d += len(model.get("grad_feat", ())) * 3 + len(model.get("sdf_feat", ())) * 6
    if model.get("center_sdf", True):
        d += 1
    if model.get("use_viewdir", True):
        d += 3 + 3 * model.get("viewbase_pe", 3) * 2
    return d


def refnet_in_dim(model: Dict, fine: bool) -> int:
    d = 3 + 3 * model.get("refbase_pe", 8) * 2
    if fine:
        return d + model.get("refnet_width", 256)
    d += model.get("k0_dim", 12) + (3 + 3 * model.get("posbase_pe", 5) * 2) + 3
    if model.get("use_viewdir", True):
        d += 3 + 3 * model.get("viewbase_pe", 3) * 2
    return d


def head_dims(model: Dict, fine: bool) -> Dict[str, List[int]]:
    """{'refnet': [in, w, ..., 3], 'rgbnet': [in, w, ..., w] (fine)}."""
    rw, rd = model.get("refnet_width", 256), model.get("refnet_depth", 4)
    dims = {"refnet": [refnet_in_dim(model, fine)] + [rw] * (rd - 1) + [3]}
    if fine:
        gw, gd = model.get("rgbnet_width", 256), model.get("rgbnet_depth", 4)
        dims["rgbnet"] = [rgbnet_in_dim(model)] + [gw] * (gd - 1) + [gw]
    return dims


def macs(dims: List[int]) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def bound_s(n_bytes: float, n_flops: float, peak_flops: float) -> float:
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], n_flops / peak_flops)


def serve(m: int, c: int) -> Tuple[float, float]:
    """Trilinear serve of ``c`` channels at ``m`` samples."""
    return m * (POS_BYTES + 4 * c), 16.0 * c * m


def accumulate(m: int, c: int, nodes: int) -> Tuple[float, float]:
    """Its backward: cotangents in, the dense [nodes, c] gradient out."""
    return m * (POS_BYTES + 4 * c) + 4.0 * c * nodes, 16.0 * c * m


def head_fwd(m: int, dims: List[int], n_in: int) -> Tuple[float, float]:
    """A head's forward over ``m`` samples from ``n_in`` raw input
    floats a sample (encodings are computed, not read)."""
    return (m * 4.0 * (n_in + dims[-1]) + 4.0 * macs(dims),
            2.0 * m * macs(dims))


def head_bwd(m: int, dims: List[int], n_in: int) -> Tuple[float, float]:
    return (m * 4.0 * (2 * n_in + dims[-1]) + 8.0 * macs(dims),
            4.0 * m * macs(dims))


def kernel_bounds(cell: Dict, groups=None) -> Dict[str, float]:
    """Least seconds a step of each kernel group the cell runs, keyed as
    ``record.bucket`` names them: the frozen groups' below, and each
    group file's (``groups.load()``, or ``groups``) that runs in the
    cell."""
    from benchmark import groups as G

    out = _frozen_bounds(cell)
    for g in G.load() if groups is None else groups:
        bound = g.bound_s(cell)
        if bound is not None:
            out[g.name] = bound
    return out


def _frozen_bounds(cell: Dict) -> Dict[str, float]:
    n, model, stage = cell["n_rays"], cell["model"], cell["stage"]
    ws = cell["world_size"]
    nodes = ws[0] * ws[1] * ws[2]
    c = 4 + model.get("k0_dim", 12)
    f32 = PEAKS["f32_flops"]
    out: Dict[str, float] = {}
    if cell["engine"] != "sorted":
        return out
    m1 = n * model["sample_k"]
    if stage == "fine":
        m2 = n * model["shade_k"]
        nd = n_displace(model)
        out["serve B1"] = sum(bound_s(*serve(m, c), f32) for m in (m1, m2))
        out["accumulate B2"] = sum(bound_s(*accumulate(m, c, nodes), f32)
                                   for m in (m1, m2))
        out["serve B5"] = sum(bound_s(*serve(m2, t), f32)
                              for t in (4 * nd, 2 * nd))
        out["accumulate B6"] = sum(bound_s(*accumulate(m2, t, nodes / t), f32)
                                   for t in (4 * nd, 2 * nd))
    else:
        dims = head_dims(model, fine=False)["refnet"]
        n_in = model.get("k0_dim", 12) + 12
        bf16 = PEAKS["bf16_flops"]
        out["serve B1"] = bound_s(*serve(m1, c), f32)
        out["accumulate B2"] = bound_s(*accumulate(m1, c, nodes), f32)
        out["shade B3"] = bound_s(*head_fwd(m1, dims, n_in), bf16)
        out["shade B4"] = bound_s(*head_bwd(m1, dims, n_in), bf16)
    return out


def head_row_flops(model: Dict, fine: bool, backward: bool) -> float:
    """The heads' product FLOPs of one row (a sample the head shades):
    forward, plus backward when training."""
    total = sum(macs(d) for d in head_dims(model, fine).values())
    return (6.0 if backward else 2.0) * total
