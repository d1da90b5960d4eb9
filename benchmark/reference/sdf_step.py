"""The plain reference of one training step of the coarse and the fine
stage, in float32 PyTorch (TF32 off), ray-major, with autograd for the
backward.  It imports nothing of the program.

It follows the semantics of the stage as the port's configuration states
it (``models/sdf_voxel.py:forward_coarse_sorted`` / ``forward_fine_sorted``,
``train/losses.py``, ``ops/tv.py``, ``optim/masked_adam.py``): the sample
lattice from the box entry, the mask cache (3^3 max-pool of the geometry
stage's ``sdf_mask``, trilinear, ``>= mask_cache_thres``), compaction to
the first ``sample_k`` valid samples, the field ``[sdf | grad | k0]``
(central differences, zero at the faces) served trilinearly with the
fractions and view directions of the first pass held to 16 bits
(``sort_pack16``), NeuS alpha, the transmittance scan with its early exit
below 1e-3, the heads with the bf16 rounding of ``mlp_bf16`` (operands
and hidden outputs rounded, float32 sums, the last layer float32), the
fine stage's top-``shade_k`` selection, hierarchical taps and
finite-difference features, the losses, the fine stage's TV injection
and masked Adam.

The lattice points, the mask-cache lookup and the nonempty mask are
computed with the same float32 expressions in the same order as the
program: the mask cache holds a plateau of exactly ``mask_cache_thres``,
so a lookup there is decided by its last bit, and any other order of
operations would move samples across it (ROADMAP section C).

``control=True`` computes the control: each stated precision one step
lower, the grids and every served field value in bf16 (float32 stated)
and the heads' operands in float8 e4m3 with a scale a tensor (bf16
stated).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import schedules as S

EARLY_EXIT_T = 1e-3


def bf16r(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def fp8r(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale a tensor (its largest value to
    448), the way an fp8 product takes its operands."""
    scale = 448.0 / torch.clamp(x.detach().abs().amax(), min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())  # the cotangent passes as it is


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def ray_box(o, d, bmin, bmax, near, far=1e9):
    vec = torch.where(d == 0.0, torch.full_like(d, 1e-6), d)
    ra = (bmax - o) / vec
    rb = (bmin - o) / vec
    t_min = torch.amax(torch.minimum(ra, rb), dim=-1)
    t_max = torch.amin(torch.maximum(ra, rb), dim=-1)
    t_min = torch.clamp(torch.clamp(t_min, max=far), min=near)
    t_max = torch.clamp(torch.clamp(t_max, max=far), min=near)
    return t_min, t_max


def lattice(o, d, bmin, bmax, near, step_dist, s_max):
    """(points at steps fn, steps0 [N, S], (px, py, pz), valid)."""
    n = o.shape[0]
    t_min, t_max = ray_box(o, d, bmin, bmax, near)
    d_norm = torch.sqrt(torch.sum(d * d, dim=-1))
    n_steps = torch.clamp(torch.ceil((t_max - t_min) * d_norm / step_dist),
                          min=1.0).to(torch.int32)
    start = o + d * t_min[..., None]
    unit = d / d_norm[..., None]
    ids = torch.arange(s_max, dtype=torch.float32, device=o.device)

    def at(steps):
        dd = steps * step_dist
        return tuple(start[:, a:a + 1] + unit[:, a:a + 1] * dd for a in range(3))

    steps0 = ids[None, :].expand(n, s_max)
    pts = at(steps0)
    valid = ids[None, :] < n_steps[:, None].to(torch.float32)
    for a, p in enumerate(pts):
        valid = valid & (p >= bmin[a]) & (p <= bmax[a])
    return at, steps0, pts, valid


def trilinear_ordered(grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup [..., C] at index coordinates [..., 3], zero
    outside, the corner weight the product x * y * z and the corners
    summed dz fastest (the mask cache's order)."""
    sizes = torch.tensor(grid.shape[:3], dtype=torch.int64, device=grid.device)
    flat = grid.reshape(-1, grid.shape[-1])
    i0f = torch.floor(idx)
    f = idx - i0f
    i0 = i0f.long()
    wa = [(1.0 - f[..., a], f[..., a]) for a in range(3)]
    out = None
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                ci = i0 + torch.tensor((ox, oy, oz), device=grid.device)
                inb = torch.all((ci >= 0) & (ci < sizes), dim=-1)
                cc = torch.minimum(torch.clamp(ci, min=0), sizes - 1)
                lin = (cc[..., 0] * sizes[1] + cc[..., 1]) * sizes[2] + cc[..., 2]
                w = wa[0][ox] * wa[1][oy] * wa[2][oz]
                term = w[..., None] * (flat[lin] * inb[..., None].to(flat.dtype))
                out = term if out is None else out + term
    return out


def max_pool3(grid: torch.Tensor) -> torch.Tensor:
    return F.max_pool3d(grid.permute(3, 0, 1, 2), 3, stride=1,
                        padding=1).permute(1, 2, 3, 0).contiguous()


def mask_query(mc: Dict, xyz: torch.Tensor, thres: float) -> torch.Tensor:
    sizes = torch.tensor(mc["grid"].shape[:3], dtype=torch.float32,
                         device=xyz.device)
    idx = (xyz - mc["min"]) / (mc["max"] - mc["min"]) * (sizes - 1.0)
    return trilinear_ordered(mc["grid"], idx)[..., 0] >= thres


def grid_nodes(ws, bmin, bmax):
    axes = [torch.linspace(float(bmin[i]), float(bmax[i]), ws[i],
                           dtype=torch.float32, device=bmin.device)
            for i in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def compact(valid: torch.Tensor, k: int):
    """The first ``k`` valid slots of each ray in step order."""
    order = torch.sort((~valid).to(torch.int32), dim=-1, stable=True)[1][:, :k]
    return (torch.gather(valid, 1, order), order.to(torch.float32),
            torch.sum(valid, dim=-1) > k)


def q16(a: torch.Tensor) -> torch.Tensor:
    return torch.round(a * 65535.0) * (1.0 / 65535.0)


def index_coords(pts, bmin, bmax, ws):
    ext = bmax - bmin
    return tuple((p - bmin[a]) / ext[a] * (ws[a] - 1.0) for a, p in enumerate(pts))


def serve(grid: torch.Tensor, ix, iy, iz, fracs=None) -> torch.Tensor:
    """Trilinear serve of grid [X, Y, Z, C] at index coordinates, zero
    outside; ``fracs`` replaces the fractional parts (held to 16 bits)."""
    x, y, z, c = grid.shape
    flat = grid.reshape(-1, c)
    i0 = [torch.floor(t) for t in (ix, iy, iz)]
    f = fracs if fracs is not None else [t - b for t, b in zip((ix, iy, iz), i0)]
    size = (x, y, z)
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cs = [(i0[a] + o).long() for a, o in enumerate((dx, dy, dz))]
                ok = torch.ones_like(ix, dtype=torch.bool)
                for a in range(3):
                    ok = ok & (cs[a] >= 0) & (cs[a] < size[a])
                lin = ((cs[0].clamp(0, x - 1) * y + cs[1].clamp(0, y - 1)) * z
                       + cs[2].clamp(0, z - 1))
                w = ((f[0] if dx else 1.0 - f[0]) * (f[1] if dy else 1.0 - f[1])
                     * (f[2] if dz else 1.0 - f[2])) * ok
                term = flat[lin] * w[..., None]
                out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# Field, alpha, scan, heads
# ---------------------------------------------------------------------------


def sdf_gradient(s: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Central differences of [X, Y, Z], zero at the faces -> [X, Y, Z, 3]."""
    inv = 1.0 / (2.0 * voxel_size)
    return torch.stack([
        F.pad((s[2:] - s[:-2]) * inv, (0, 0, 0, 0, 1, 1)),
        F.pad((s[:, 2:] - s[:, :-2]) * inv, (0, 0, 1, 1)),
        F.pad((s[:, :, 2:] - s[:, :, :-2]) * inv, (1, 1))], -1)


def _edge_pad(g, axis, r):
    n = g.shape[axis]
    lo = g.narrow(axis, 0, 1).expand(*[r if a == axis else s for a, s in enumerate(g.shape)])
    hi = g.narrow(axis, n - 1, 1).expand(*[r if a == axis else s for a, s in enumerate(g.shape)])
    return torch.cat([lo, g, hi], dim=axis)


def separable(g: torch.Tensor, k1d) -> torch.Tensor:
    """The same 1-D stencil along each of the first three axes, edges
    replicated."""
    r = len(k1d) // 2
    for axis in range(3):
        x = _edge_pad(g, axis, r)
        n = g.shape[axis]
        g = sum(float(w) * x.narrow(axis, i, n) for i, w in enumerate(k1d))
    return g


def gaussian_smooth(g: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    r = np.arange(-(ksize // 2), ksize // 2 + 1, dtype=np.float64)
    k = np.exp(-(r ** 2) / (2.0 * sigma ** 2))
    return separable(g, (k / k.sum()).astype(np.float32))


def neus_alpha(true_cos, sdf, dist, s_val):
    inv_s = 1.0 / s_val
    iter_cos = -torch.clamp(-true_cos, min=0.0)
    prev_cdf = torch.sigmoid((sdf - iter_cos * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * dist * 0.5) * inv_s)
    return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)


def unit_normal(gx, gy, gz):
    gn = torch.sqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-24)) + 1e-7
    hx, hy, hz = gx / gn, gy / gn, gz / gn
    hn = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz,
                                min=float(np.finfo(np.float32).eps)))
    return hx / hn, hy / hn, hz / hn


def excl_cumprod(x: torch.Tensor) -> torch.Tensor:
    c = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(c[..., :1]), c[..., :-1]], dim=-1)


def scan(alpha: torch.Tensor, valid: torch.Tensor):
    """Transmittance weights with the early exit below 1e-3, and the
    transmittance past the last sample."""
    a = torch.where(valid, alpha, torch.zeros_like(alpha))
    processed = (excl_cumprod(1.0 - a.detach()) >= EARLY_EXIT_T) & valid
    a_eff = torch.where(processed, a, torch.zeros_like(a))
    weights = excl_cumprod(1.0 - a_eff) * a_eff
    return weights, torch.prod(1.0 - a_eff, dim=-1)


def encode(x3: torch.Tensor, n_freq: int) -> torch.Tensor:
    """[..., 3] -> [..., 3 + 6 n]: identity, sin, cos, frequencies of one
    axis contiguous."""
    freqs = torch.tensor([2.0 ** i for i in range(n_freq)], device=x3.device)
    xf = (x3[..., None] * freqs).reshape(*x3.shape[:-1], -1)
    return torch.cat([x3, torch.sin(xf), torch.cos(xf)], dim=-1)


def mlp(p: Dict[str, torch.Tensor], blocks: List[torch.Tensor],
        rnd=bf16r) -> torch.Tensor:
    """ReLU MLP over the concatenated blocks, operands and hidden outputs
    rounded by ``rnd`` (bf16 as configured), float32 sums."""
    x = torch.cat([rnd(b) for b in blocks], dim=-1)
    n = len(p) // 2
    for i in range(n):
        z = x @ rnd(p[f"w{i}"])
        if i == n - 1:
            return z + p[f"b{i}"]
        x = torch.relu(rnd(rnd(z) + rnd(p[f"b{i}"])))
    return x


def reflect(v3, n3):
    """``v - 2 (v.n) n``, the dot product summed x + y + z (the program's
    order: the reflection is encoded up to 2^7 times its value, so its
    last bit shows)."""
    vx, vy, vz = v3.unbind(-1)
    nx, ny, nz = n3.unbind(-1)
    dot2 = 2.0 * (vx * nx + vy * ny + vz * nz)
    return torch.stack([vx - dot2 * nx, vy - dot2 * ny, vz - dot2 * nz], -1)


# ---------------------------------------------------------------------------
# The stage
# ---------------------------------------------------------------------------


class Stage:
    """One stage at its final rung: its model block, grid, box and
    buffers, made from the inputs the benchmark hands both sides."""

    def __init__(self, cfg: Dict, stage: str, box, world_size, voxel_size,
                 geo_mask: torch.Tensor, geo_box, near: float, bg: float,
                 control: bool = False):
        self.model = cfg[f"{stage}_model"]
        self.train = cfg[f"{stage}_train"]
        self.stage = stage
        dev = geo_mask.device
        self.bmin = torch.as_tensor(np.asarray(box[0], np.float32), device=dev)
        self.bmax = torch.as_tensor(np.asarray(box[1], np.float32), device=dev)
        self.ws = tuple(world_size)
        self.voxel = float(voxel_size)
        self.step_dist = self.model["stepsize"] * self.voxel
        diag = float(np.linalg.norm(np.asarray(self.ws, np.float64)))
        self.s_max = ((int(np.ceil(diag / self.model["stepsize"])) + 1 + 7) // 8) * 8
        self.near, self.bg = near, bg
        self.thr = self.model.get("mask_cache_thres", 1e-3)
        self.fct = self.model.get("fast_color_thres", 1e-4)
        self.mc = {"grid": max_pool3(geo_mask),
                   "min": torch.as_tensor(np.asarray(geo_box[0], np.float32), device=dev),
                   "max": torch.as_tensor(np.asarray(geo_box[1], np.float32), device=dev)}
        self.nonempty = mask_query(self.mc, grid_nodes(self.ws, self.bmin, self.bmax),
                                   self.thr)[..., None]
        self.fdt = torch.bfloat16 if control else torch.float32
        self.rnd = fp8r if control else bf16r

    def prepare(self, params: Dict) -> Dict:
        """The state as the stage's rung leaves it: in the coarse stage
        the SDF outside the nonempty mask is pushed to +1."""
        if self.stage == "coarse":
            params = dict(params)
            params["sdf"] = torch.where(self.nonempty, params["sdf"], 1.0)
        return params

    def _fq(self, t):
        return t.to(self.fdt).to(torch.float32) if self.fdt != torch.float32 else t

    # -- forward -----------------------------------------------------------

    def _pass1(self, p, o, d, v):
        m, n = self.model, o.shape[0]
        at, steps0, pts, valid = lattice(o, d, self.bmin, self.bmax, self.near,
                                         self.step_dist, self.s_max)
        valid = valid & mask_query(self.mc, torch.stack(pts, -1), self.thr)
        k = m.get("sample_k", 0)
        if 0 < k < self.s_max:
            valid, steps, _ = compact(valid, k)
            pts = at(steps)
        else:
            steps = steps0
        sdf3 = p["sdf"][..., 0]
        sdf_field = sdf3
        if m.get("smooth_ksize", 0) > 0 and self.stage != "fine":
            sdf_field = gaussian_smooth(sdf3, m["smooth_ksize"], m["smooth_sigma"])
        grad = sdf_gradient(p["sdf"][..., 0], self.voxel)
        field = self._fq(torch.cat([sdf_field[..., None], grad, p["k0"]], -1))
        ix, iy, iz = index_coords(pts, self.bmin, self.bmax, self.ws)
        fr = [q16(t - torch.floor(t)) for t in (ix, iy, iz)]
        samp = self._fq(serve(field, ix, iy, iz, fr)) * valid[..., None]
        vq = [q16((v[:, a:a + 1] + 1.0) * 0.5) * 2.0 - 1.0 for a in range(3)]
        gx, gy, gz = samp[..., 1], samp[..., 2], samp[..., 3]
        true_cos = vq[0] * gx + vq[1] * gy + vq[2] * gz
        alpha = neus_alpha(true_cos, samp[..., 0], self.step_dist, self._sv)
        nx, ny, nz = unit_normal(gx, gy, gz)
        ndv = -(nx * vq[0] + ny * vq[1] + nz * vq[2])
        return dict(at=at, steps=steps, valid=valid, samp=samp, alpha=alpha,
                    ndv=ndv, normal=(nx, ny, nz), vq=vq, ijk=(ix, iy, iz), fr=fr)

    def forward(self, p, o, d, v, s_val):
        self._sv = s_val
        if self.stage == "fine":
            return self._forward_fine(p, o, d, v)
        return self._forward_coarse(p, o, d, v)

    def _forward_coarse(self, p, o, d, v):
        m = self.model
        r = self._pass1(p, o, d, v)
        valid, samp, vq = r["valid"], r["samp"], r["vq"]
        ix, iy, iz = r["ijk"]
        fr = r["fr"]
        xyz = torch.stack([(torch.floor(t) + f) / (s - 1.0) for t, f, s
                           in zip((ix, iy, iz), fr, self.ws)], -1)
        n3 = torch.stack(r["normal"], -1)
        v3 = torch.stack([q.expand_as(ix) for q in vq], -1)
        blocks = [samp[..., 4:], encode(xyz, m["posbase_pe"]),
                  encode(reflect(v3, n3), m["refbase_pe"]), n3]
        if m.get("use_viewdir", True):
            blocks.append(encode(v3, m["viewbase_pe"]))
        rgb = torch.sigmoid(mlp(p["refnet"], blocks, self.rnd))
        w1, _ = scan(r["alpha"], valid)
        live = valid & (w1 > self.fct) if self.fct > 0 else valid
        weights, last = scan(r["alpha"], live)
        w_full = weights * live
        return self._composite(w_full, rgb, w_full, last, r["ndv"], live, valid)

    def _forward_fine(self, p, o, d, v):
        m = self.model
        n = o.shape[0]
        r = self._pass1(p, o, d, v)
        valid, alpha = r["valid"], r["alpha"]
        m1 = valid & (alpha > self.fct) if self.fct > 0 else valid
        weights, last = scan(alpha, m1)
        live = m1 & (weights > self.fct) if self.fct > 0 else m1
        w_eff = weights * live
        k = m["shade_k"]
        score = torch.where(live, weights, torch.full_like(weights, -1.0))
        vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
        idx = idx[:, :k]
        sel_live = vals[:, :k] > 0.0
        steps_sel = torch.gather(r["steps"], 1, idx)
        s_weights = torch.gather(weights, 1, idx) * sel_live

        q = r["at"](steps_sel)
        ix, iy, iz = index_coords(q, self.bmin, self.bmax, self.ws)
        sdf3 = p["sdf"][..., 0]
        grad = sdf_gradient(sdf3, self.voxel)
        field = self._fq(torch.cat([sdf3[..., None], grad, p["k0"]], -1))
        live_f = sel_live[..., None].to(torch.float32)
        samp2 = self._fq(serve(field, ix, iy, iz)) * live_f
        sdf2, k02 = samp2[..., 0], samp2[..., 4:]
        sdf_t = self._fq(sdf3)[..., None]
        disp = sorted(set(m.get("grad_feat", ())) | set(m.get("k_grad_feat", (1.0,))))
        ic = {"z": iz, "y": iy, "x": ix}
        size = {"z": self.ws[2], "y": self.ws[1], "x": self.ws[0]}
        taps = {}
        for ax in ("z", "y", "x"):
            for sign in (-1.0, 1.0):
                for dd in disp:
                    c = {"x": ix, "y": iy, "z": iz}
                    c[ax] = torch.clamp(ic[ax] + sign * dd, 0.0, size[ax] - 1.0)
                    taps[(ax, sign, dd)] = (
                        self._fq(serve(sdf_t, c["x"], c["y"], c["z"]))[..., 0]
                        * sel_live)
        feat_rows = [taps[(ax, sg, dd)] for ax in ("z", "y", "x")
                     for sg in (-1.0, 1.0) for dd in disp]

        def tap_diff(ax, dd):
            hi = torch.clamp(ic[ax] + dd, 0.0, size[ax] - 1.0)
            lo = torch.clamp(ic[ax] - dd, 0.0, size[ax] - 1.0)
            dist = hi - lo
            dist = torch.where(dist > 0, dist, torch.ones_like(dist))
            return (taps[(ax, 1.0, dd)] - taps[(ax, -1.0, dd)]) / dist / self.voxel

        grad_rows = {(ax, dd): tap_diff(ax, dd) for ax in ("z", "y", "x") for dd in disp}
        if m.get("use_grad_norm", True):
            for dd in disp:
                g3 = [grad_rows[(ax, dd)] for ax in ("z", "y", "x")]
                nrm = torch.sqrt(torch.clamp(g3[0] * g3[0] + g3[1] * g3[1]
                                             + g3[2] * g3[2], min=1e-24))
                for ax, g in zip(("z", "y", "x"), g3):
                    grad_rows[(ax, dd)] = g / (nrm + 1e-5)
        gcz, gcy, gcx = (tap_diff(ax, 1.0) for ax in ("z", "y", "x"))
        n3 = torch.stack(unit_normal(gcx, gcy, gcz), -1)
        xyz = torch.stack([ix / (self.ws[0] - 1.0), iy / (self.ws[1] - 1.0),
                           iz / (self.ws[2] - 1.0)], -1)
        v3 = v[:, None, :].expand(n, k, 3)
        blocks = [k02, encode(xyz, m["posbase_pe"])]
        if m.get("use_viewdir", True):
            blocks.append(encode(v3, m["viewbase_pe"]))
        if m.get("center_sdf", True):
            blocks.append(sdf2[..., None])
        blocks += [torch.stack(feat_rows, -1),
                   torch.stack([grad_rows[(ax, dd)] for ax in ("z", "y", "x")
                                for dd in disp], -1),
                   torch.stack([gcx, gcy, gcz], -1)]
        rgb_feat = mlp(p["rgbnet"], blocks, self.rnd)
        rgb = torch.sigmoid(mlp(p["refnet"], [rgb_feat, encode(
            reflect(v3, n3), m["refbase_pe"])], self.rnd))
        return self._composite(s_weights, rgb, w_eff, last, r["ndv"], live, valid)

    def _composite(self, s_weights, rgb, w_eff, last, ndv, live, valid):
        cum = torch.sum(w_eff, -1, keepdim=True)
        comp = torch.clamp(torch.sum(s_weights[..., None] * rgb, 1)
                           + (1.0 - cum) * self.bg, 0.0, 1.0)
        comp_sig = torch.clamp(torch.sum(s_weights[..., None] * torch.sigmoid(rgb), 1)
                               + (1.0 - cum) * self.bg, 0.0, 1.0)
        return dict(rgb=comp, rgb_sig=comp_sig, last=last, weights=w_eff, ndv=ndv,
                    sel_w=s_weights, sel_rgb=rgb, live=live, valid=valid)

    # -- losses ------------------------------------------------------------

    def loss(self, p, out, target, tv_on: float, tv_terms: Dict) -> torch.Tensor:
        t = self.train
        n = target.shape[0]
        loss = t.get("weight_main", 1.0) * torch.mean((out["rgb"] - target) ** 2)
        if t.get("weight_rgbper", 0) > 0:
            diff = torch.sum((out["sel_rgb"] - target[:, None, :]) ** 2, -1)
            loss = loss + t["weight_rgbper"] * torch.sum(
                diff * out["sel_w"].detach()) / n
        if t.get("weight_entropy_last", 0) > 0:
            po = torch.clamp(out["last"], 1e-6, 1 - 1e-6)
            loss = loss - t["weight_entropy_last"] * torch.mean(
                po * torch.log(po) + (1 - po) * torch.log(1 - po))
        if t.get("weight_orientation", 0) > 0:
            loss = loss + t["weight_orientation"] * torch.sum(
                out["weights"].detach() * torch.clamp(out["ndv"], max=0.0) ** 2)
        if t.get("sigmoid_rgb_loss", 0) > 0:
            loss = loss + t["sigmoid_rgb_loss"] * torch.mean(
                (out["rgb_sig"] - target) ** 2)
        if t.get("weight_tv_density", 0) > 0:
            grad = sdf_gradient(p["sdf"][..., 0], self.voxel)
            msk = self.nonempty.to(torch.float32)
            tv = torch.zeros((), device=target.device)
            sg = tv_terms.get("smooth_grad_tv", 0.0)
            if sg > 0:
                err = (separable(grad.detach(), np.asarray([0.25, 0.5, 0.25],
                                                           np.float32)) - grad) ** 2
                tv = tv + torch.sum(err * msk) / (torch.sum(msk) * 3.0) * sg
            if t.get("ori_tv", False) and tv_terms.get("sdf_tv", 0.0) > 0:
                s = p["sdf"]
                num = (torch.sum(torch.abs(s[1:] - s[:-1]) * msk[1:] * msk[:-1])
                       + torch.sum(torch.abs(s[:, 1:] - s[:, :-1]) * msk[:, 1:] * msk[:, :-1])
                       + torch.sum(torch.abs(s[:, :, 1:] - s[:, :, :-1])
                                   * msk[:, :, 1:] * msk[:, :, :-1]))
                tv = tv + num / 3.0 / torch.sum(msk) / 2.0 / self.voxel * tv_terms["sdf_tv"]
            loss = loss + tv_on * t["weight_tv_density"] * tv
        return loss

    # -- a whole step ------------------------------------------------------

    def step(self, p, opt, batch, global_step: int, lrs: Dict, tv_terms: Dict,
             n_rand: int):
        """One step: returns (new params, new opt state, loss)."""
        o, d, v, target = batch
        s_val = S.s_val(global_step, self.model)
        tv_on = 1.0 if S.tv_active(global_step, self.train) else 0.0
        leaves, names = flatten(p)
        req = [x.detach().requires_grad_(True) for x in leaves]
        pr = unflatten(req, names)
        out = self.forward(pr, o, d, v, s_val)
        loss = self.loss(pr, out, target, tv_on, tv_terms)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(x)
                 for g, x in zip(grads, leaves)]
        g = dict(zip(names, grads))
        t = self.train
        if not t.get("ori_tv", False) and t.get("weight_tv_density", 0) > 0 \
                and tv_terms.get("sdf_tv", 0.0) > 0:
            w = (t["weight_tv_density"] * tv_terms["sdf_tv"] / n_rand
                 * (max(self.ws) / 128.0) * tv_on)
            g["sdf"] = g["sdf"] + tv_grad(p["sdf"], w,
                                          global_step < t.get("tv_dense_before", 0),
                                          g["sdf"])
        skip = set(t.get("skip_zero_grad_fields", []))
        new_p, new_opt = adam(dict(zip(names, leaves)), g, opt, lrs, skip)
        new_p["s_val"] = torch.full((1,), s_val, device=o.device)
        return unflatten([new_p[k] for k in names], names), new_opt, loss.detach(), g


def tv_grad(grid, w, dense, grad):
    tv = torch.zeros_like(grid)
    for axis in range(3):
        n = grid.shape[axis]
        fwd = torch.clamp(grid.narrow(axis, 0, n - 1) - grid.narrow(axis, 1, n - 1),
                          -1.0, 1.0) * (w / 6.0)
        tv.narrow(axis, 0, n - 1).add_(fwd)
        tv.narrow(axis, 1, n - 1).sub_(fwd)
    if not dense:
        tv = torch.where(grad != 0.0, tv, torch.zeros_like(tv))
    return tv


def flatten(p: Dict, prefix: str = "") -> Tuple[List[torch.Tensor], List[str]]:
    leaves, names = [], []
    for k, v in p.items():
        if isinstance(v, dict):
            lv, nv = flatten(v, prefix + k + ".")
            leaves += lv
            names += nv
        else:
            leaves.append(v)
            names.append(prefix + k)
    return leaves, names


def unflatten(leaves, names) -> Dict:
    out: Dict = {}
    for x, name in zip(leaves, names):
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = x
    return out


def adam(p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor], opt: Dict,
         lrs: Dict[str, float], skip, b1=0.9, b2=0.99, eps=1e-8):
    """Masked Adam on flat leaves named ``group.leaf``; groups without a
    rate stay; ``skip`` groups keep value and moments where g == 0."""
    step = opt["step"] + 1
    bias = np.sqrt(1.0 - b2 ** step) / (1.0 - b1 ** step)
    new_p, m_n, v_n = {}, {}, {}
    for name, x in p.items():
        group = name.split(".")[0]
        m0 = opt["m"].get(name, torch.zeros_like(x))
        v0 = opt["v"].get(name, torch.zeros_like(x))
        if group not in lrs:
            new_p[name], m_n[name], v_n[name] = x, m0, v0
            continue
        gi = g[name]
        m1 = b1 * m0 + (1.0 - b1) * gi
        v1 = b2 * v0 + (1.0 - b2) * gi * gi
        x1 = x - (lrs[group] * bias) * m1 / (torch.sqrt(v1) + eps)
        if group in skip:
            live = gi != 0.0
            x1 = torch.where(live, x1, x)
            m1 = torch.where(live, m1, m0)
            v1 = torch.where(live, v1, v0)
        new_p[name], m_n[name], v_n[name] = x1, m1, v1
    return new_p, {"step": step, "m": m_n, "v": v_n}


def run_steps(stage: Stage, params: Dict, batches, first_step: int, n_rand: int):
    """Follow ``len(batches)`` steps from ``params`` and a fresh optimizer:
    (losses, first gradient as the optimizer gets it, parameters after
    the last step), leaves named ``group.leaf``."""
    p = stage.prepare(params)
    names = flatten(p)[1]
    lrs = S.initial_lrs(stage.train, {n.split(".")[0] for n in names})
    tv_terms = dict(stage.train.get("tv_terms", {}))
    opt = {"step": 0, "m": {}, "v": {}}
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        gs = first_step + i
        p, opt, loss, g = stage.step(p, opt, batch, gs, lrs, tv_terms, n_rand)
        if i == 0:
            first_grad = {k: g[k] if k.split(".")[0] in lrs
                          else torch.zeros_like(g[k]) for k in g}
        del g
        losses.append(float(loss))
        S.update_lrs(lrs, gs, stage.train)
        S.apply_tv_updates(tv_terms, gs, stage.train)
    return losses, first_grad, dict(zip(*reversed(flatten(p))))


# ---------------------------------------------------------------------------
# The fine stage's render on the lattice (evaluation)
# ---------------------------------------------------------------------------


def _norm_last(x, eps):
    return torch.sqrt(torch.clamp(torch.sum(x ** 2, dim=-1, keepdim=True), min=eps))


def taps(sdf4: torch.Tensor, idx: torch.Tensor, disp, voxel: float, grad_norm: bool):
    """Six-neighbour taps at displacements ``disp`` along each axis, every
    coordinate clamped into the grid, and their finite differences:
    (feat [..., 6, D] ordered z-, z+, y-, y+, x-, x+; grad [..., 3, D]
    ordered z, y, x)."""
    sizes = torch.tensor(sdf4.shape[:3], dtype=torch.float32, device=idx.device)
    d = torch.tensor(list(disp), dtype=torch.float32, device=idx.device)
    offs = torch.tensor(((0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0),
                         (-1, 0, 0), (1, 0, 0)), dtype=torch.float32,
                        device=idx.device)
    t = idx[..., None, None, :] + offs[:, None, :] * d[None, :, None]
    t = torch.minimum(torch.clamp(t, min=0.0), sizes - 1.0)
    feat = serve(sdf4, t[..., 0], t[..., 1], t[..., 2])[..., 0]
    coord = torch.stack([t[..., 0, :, 2], t[..., 1, :, 2], t[..., 2, :, 1],
                         t[..., 3, :, 1], t[..., 4, :, 0], t[..., 5, :, 0]], -2)
    dist = coord[..., 1::2, :] - coord[..., 0::2, :]
    dist = torch.where(dist > 0, dist, torch.ones_like(dist))
    grad = (feat[..., 1::2, :] - feat[..., 0::2, :]) / dist / voxel
    if grad_norm:
        nrm = torch.sqrt(torch.clamp(torch.sum(grad ** 2, dim=-2, keepdim=True),
                                     min=1e-24))
        grad = grad / (nrm + 1e-5)
    return feat, grad


@torch.no_grad()
def render_lattice(stage: Stage, p: Dict, o, d, v, s_val: float) -> torch.Tensor:
    """The fine stage's evaluation render of a chunk of rays on the sample
    lattice: the field ``[sdf | k0]`` served trilinearly (no 16-bit
    fractions), the gradient from the displacement-1 taps, NeuS alpha,
    one scan, top-``shade_k`` selection, the hierarchical taps and the
    two heads; returns rgb [N, 3]."""
    m, n = stage.model, o.shape[0]
    at, steps0, pts, valid = lattice(o, d, stage.bmin, stage.bmax, stage.near,
                                     stage.step_dist, stage.s_max)
    valid = valid & mask_query(stage.mc, torch.stack(pts, -1), stage.thr)
    k = m.get("sample_k", 0)
    if 0 < k < stage.s_max:
        valid, steps, _ = compact(valid, k)
        pts = at(steps)
    pts = torch.stack(pts, -1)
    sizes = torch.tensor(stage.ws, dtype=torch.float32, device=o.device)
    idx = (pts - stage.bmin) / (stage.bmax - stage.bmin) * (sizes - 1.0)
    sdf4 = stage._fq(p["sdf"])
    field = stage._fq(torch.cat([p["sdf"], p["k0"]], -1))
    samp = stage._fq(serve(field, idx[..., 0], idx[..., 1], idx[..., 2]))
    sdf, k0 = samp[..., 0], samp[..., 1:]
    _, g = taps(sdf4, idx, (1.0,), stage.voxel, False)
    grad = torch.stack([g[..., 2, 0], g[..., 1, 0], g[..., 0, 0]], -1)
    alpha = neus_alpha(torch.sum(v[:, None, :] * grad, dim=-1), sdf,
                       stage.step_dist, s_val)
    m1 = valid & (alpha > stage.fct)
    weights, _ = scan(alpha, m1)
    live = m1 & (weights > stage.fct)
    w_eff = weights * live
    normal = grad / (_norm_last(grad, 1e-24) + 1e-7)
    normal = normal / _norm_last(normal, float(np.finfo(np.float32).eps))
    kk = m["shade_k"]
    score = torch.where(live, weights, torch.full_like(weights, -1.0))
    vals, sel = torch.sort(score, dim=-1, descending=True, stable=True)
    sel = sel[:, :kk]
    s_w = torch.gather(weights, 1, sel) * (vals[:, :kk] > 0.0)

    def pick(x):
        return torch.gather(x, 1, sel[..., None].expand(-1, -1, x.shape[-1]))

    s_pts, s_sdf, s_n, s_g, s_k0 = (pick(x) for x in (pts, sdf[..., None], normal,
                                                     grad, k0))
    s_idx = (s_pts - stage.bmin) / (stage.bmax - stage.bmin) * (sizes - 1.0)
    disp = sorted(set(m.get("grad_feat", ())) | set(m.get("k_grad_feat", (1.0,))))
    feat, tg = taps(sdf4, s_idx, disp, stage.voxel, m.get("use_grad_norm", True))
    xyz = (s_pts - stage.bmin) / (stage.bmax - stage.bmin)
    vd = v[:, None, :].expand(n, kk, 3)
    blocks = [s_k0, encode(xyz, m["posbase_pe"]), encode(vd, m["viewbase_pe"]),
              s_sdf, feat.reshape(n, kk, -1), tg.reshape(n, kk, -1), s_g]
    rgb_feat = mlp(p["rgbnet"], blocks, stage.rnd)
    refl = vd - 2.0 * torch.sum(vd * s_n, -1, keepdim=True) * s_n
    rgb = torch.sigmoid(mlp(p["refnet"], [rgb_feat, encode(refl, m["refbase_pe"])],
                            stage.rnd))
    cum = torch.sum(w_eff, -1, keepdim=True)
    return torch.clamp(torch.sum(s_w[..., None] * rgb, 1) + (1.0 - cum) * stage.bg,
                       0.0, 1.0)
