"""The TensoRF vector-matrix k0 grid (``grid_type='tensorf'``).

Port of ``fgs_nerf_tpu/core/grids.py`` (`model/grid.py:136-247`): three
planes + three vectors (+ a feature basis for C > 1), queried with
bilinear samples and combined as xy*z + xz*y + yz*x.  Parameters are a
dict with the JAX package's names and layouts:
  xy_plane [X, Y, Rxy]  xz_plane [X, Z, R]  yz_plane [Y, Z, R]
  x_vec [X, R]  y_vec [Y, R]  z_vec [Z, Rxy]  f_vec [2R + Rxy, C] (C > 1)
Gradients reach the factors through autograd.  The sorted coarse
engine and the lattice engine densify the grid every step
(``tensorf_densify``) and serve it like a dense k0; the sorted fine
engine queries the factors at the rows its head shades
(``tensorf_rows``), whose backward scatters into the factors.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from fgs_nerf_tpu_torch.core.box import SceneBox
from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device
from fgs_nerf_tpu_torch.ops.interp import _resize_axis_linear
from fgs_nerf_tpu_torch.utils import profiling


def bilinear_sample(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """plane [A, B, C]; uv [..., 2] fractional index coords
    (align_corners, zero padding) -> [..., C] (`core/grids.py:22-40`)."""
    sizes = torch.tensor(plane.shape[:2], dtype=torch.int64,
                         device=plane.device)
    flat = plane.reshape(-1, plane.shape[-1])
    i0f = torch.floor(uv)
    f = uv - i0f
    i0 = i0f.long()
    out = None
    for off in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ci = i0 + torch.tensor(off, dtype=torch.int64, device=plane.device)
        inb = torch.all((ci >= 0) & (ci < sizes), dim=-1)
        cc = torch.minimum(torch.clamp(ci, min=0), sizes - 1)
        lin = cc[..., 0] * sizes[1] + cc[..., 1]
        v = flat[lin] * inb[..., None].to(flat.dtype)
        w = ((f[..., 0] if off[0] else 1.0 - f[..., 0])
             * (f[..., 1] if off[1] else 1.0 - f[..., 1]))
        term = w[..., None] * v
        out = term if out is None else out + term
    return out


def init_tensorf_params(generator: torch.Generator, channels: int, world_size,
                        n_comp: int, n_comp_xy: int = None,
                        device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Planes / vectors ~ N(0, 0.1); the feature basis kaiming-uniform for
    multi-channel grids (`core/grids.py:43-66`), drawn in that order from
    ``generator`` (which lives on ``device``)."""
    dev = resolve_device(device)
    n_comp_xy = n_comp_xy or n_comp
    x, y, z = (int(v) for v in world_size)

    def normal(*shape):
        return 0.1 * torch.randn(shape, generator=generator,
                                 dtype=torch.float32, device=dev)

    p = {
        "xy_plane": normal(x, y, n_comp_xy),
        "xz_plane": normal(x, z, n_comp),
        "yz_plane": normal(y, z, n_comp),
        "x_vec": normal(x, n_comp),
        "y_vec": normal(y, n_comp),
        "z_vec": normal(z, n_comp_xy),
    }
    if channels > 1:
        r_total = 2 * n_comp + n_comp_xy
        bound = math.sqrt(6.0 / r_total) / math.sqrt(6.0)  # kaiming a=sqrt(5)
        u = torch.rand((r_total, channels), generator=generator,
                       dtype=torch.float32, device=dev)
        p["f_vec"] = (2.0 * u - 1.0) * bound
    return p


def _line_sample(vec: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """vec [N, R]; t fractional index -> [..., R] (linear, zero pad;
    `core/grids.py:95-105`)."""
    n = vec.shape[0]
    i0f = torch.floor(t)
    f = (t - i0f)[..., None]
    i0 = i0f.long()
    lo_in = (i0 >= 0) & (i0 < n)
    hi_in = (i0 + 1 >= 0) & (i0 + 1 < n)
    lo = vec[torch.clamp(i0, 0, n - 1)] * lo_in[..., None].to(vec.dtype)
    hi = vec[torch.clamp(i0 + 1, 0, n - 1)] * hi_in[..., None].to(vec.dtype)
    return lo * (1 - f) + hi * f


def tensorf_sample(params: Dict[str, torch.Tensor], xyz: torch.Tensor,
                   box: SceneBox, channels: int) -> torch.Tensor:
    """VM-decomposed query at world coords (`core/grids.py:69-92`):
    [..., C], or [...] for one channel."""
    u = box.normalize(xyz)
    x, y = params["xy_plane"].shape[:2]
    z = params["z_vec"].shape[0]
    ux = u[..., 0] * (x - 1)
    uy = u[..., 1] * (y - 1)
    uz = u[..., 2] * (z - 1)

    xy = bilinear_sample(params["xy_plane"], torch.stack([ux, uy], -1))
    xz = bilinear_sample(params["xz_plane"], torch.stack([ux, uz], -1))
    yz = bilinear_sample(params["yz_plane"], torch.stack([uy, uz], -1))
    xv = _line_sample(params["x_vec"], ux)
    yv = _line_sample(params["y_vec"], uy)
    zv = _line_sample(params["z_vec"], uz)

    feat = torch.cat([xy * zv, xz * yv, yz * xv], dim=-1)
    if channels > 1:
        return feat @ params["f_vec"]
    return torch.sum(feat, dim=-1)


def tensorf_densify(params: Dict[str, torch.Tensor],
                    channels: int) -> torch.Tensor:
    """Expand to a dense [X, Y, Z, C] grid (`core/grids.py:108-123`)."""
    xy, xz, yz = params["xy_plane"], params["xz_plane"], params["yz_plane"]
    xv, yv, zv = params["x_vec"], params["y_vec"], params["z_vec"]
    feat = torch.cat([
        xy[:, :, None, :] * zv[None, None, :, :],
        xz[:, None, :, :] * yv[None, :, None, :],
        yz[None, :, :, :] * xv[:, None, None, :],
    ], dim=-1)
    if channels > 1:
        return feat @ params["f_vec"]
    return torch.sum(feat, dim=-1, keepdim=True)


# (plane, its two axes, the vector it multiplies, that vector's axis), in
# the order of the feature basis's rows (``tensorf_densify``)
_TERMS = (("xy_plane", 0, 1, "z_vec", 2), ("xz_plane", 0, 2, "y_vec", 1),
          ("yz_plane", 1, 2, "x_vec", 0))
_FACTORS = ("xy_plane", "xz_plane", "yz_plane", "x_vec", "y_vec", "z_vec")


def _axis_corners(base: torch.Tensor, fracs: torch.Tensor, sizes):
    """Per axis the lower and upper corner of each row, clamped into the
    grid, and its linear weight, zero for a corner outside it: (idx
    [2, n] int64, w [2, n]) for each of the three axes."""
    off = torch.arange(2, device=base.device)[:, None]
    out = []
    for a, size in enumerate(sizes):
        c = base[a][None, :] + off
        inb = (c >= 0) & (c < size)
        f = fracs[a][None, :]
        w = torch.where(off == 1, f, 1.0 - f)
        out.append((torch.clamp(c, 0, size - 1),
                    torch.where(inb, w, torch.zeros_like(w))))
    return out


class _TensorfRows(torch.autograd.Function):
    """The VM query at rows given by their lower corner and fractions;
    the backward scatters the cotangent into the planes, the vectors
    and the basis (``index_add_``) in a ``k0`` span."""

    @staticmethod
    def forward(ctx, base, fracs, xy, xz, yz, xv, yv, zv, basis):
        factors = dict(zip(_FACTORS, (xy, xz, yz, xv, yv, zv)))
        sizes = (xy.shape[0], xy.shape[1], zv.shape[0])
        corners = _axis_corners(base, fracs, sizes)
        n = base.shape[1]
        parts, saved = [], []
        for plane, a, b, vec, c in _TERMS:
            pl, ve = factors[plane], factors[vec]
            (ia, wa), (ib, wb) = corners[a], corners[b]
            lin = (ia[:, None, :] * pl.shape[1] + ib[None, :, :]).reshape(-1)
            wpl = (wa[:, None, :] * wb[None, :, :]).reshape(4, n, 1)
            ps = torch.sum(pl.reshape(-1, pl.shape[-1])[lin].reshape(4, n, -1)
                           * wpl, dim=0)
            ic, wc = corners[c]
            vs = torch.sum(ve[ic.reshape(-1)].reshape(2, n, -1)
                           * wc[..., None], dim=0)
            parts.append(ps * vs)
            saved.append((lin, wpl, ps, ic, wc, vs))
        feat = torch.cat(parts, dim=-1)
        ctx.terms = saved
        ctx.shapes = [f.shape for f in (xy, xz, yz, xv, yv, zv)]
        ctx.has_basis = basis is not None
        if basis is None:
            return torch.sum(feat, dim=-1)[None]
        ctx.save_for_backward(feat, basis)
        return (feat @ basis).t()

    @staticmethod
    def backward(ctx, g):
        with profiling.span("k0"):
            g_rows = g.t()                                  # [n, C]
            if ctx.has_basis:
                feat, basis = ctx.saved_tensors
                g_basis = feat.t() @ g_rows
                g_feat = g_rows @ basis.t()
            else:
                g_basis = None
                g_feat = g_rows.expand(g_rows.shape[0],
                                       sum(t[2].shape[-1] for t in ctx.terms))
            grads = dict.fromkeys(_FACTORS)
            shapes = dict(zip(_FACTORS, ctx.shapes))
            col = 0
            for (plane, _, _, vec, _), (lin, wpl, ps, ic, wc, vs) in zip(
                    _TERMS, ctx.terms):
                r = ps.shape[-1]
                gf = g_feat[:, col:col + r]
                col += r
                gp = torch.zeros(shapes[plane], dtype=g.dtype, device=g.device)
                gp.view(-1, r).index_add_(
                    0, lin, (wpl * (gf * vs)[None]).reshape(-1, r))
                gv = torch.zeros(shapes[vec], dtype=g.dtype, device=g.device)
                gv.index_add_(0, ic.reshape(-1),
                              (wc[..., None] * (gf * ps)[None]).reshape(-1, r))
                grads[plane], grads[vec] = gp, gv
        return (None, None, *(grads[k] for k in _FACTORS), g_basis)


def tensorf_rows(params: Dict[str, torch.Tensor], base: torch.Tensor,
                 fracs: torch.Tensor, channels: int) -> torch.Tensor:
    """The VM-decomposed k0 at ``n`` rows, channel-major [C, n]: row i at
    index coordinates ``base[:, i] + fracs[:, i]`` (``base`` [3, n] int64
    lower corners, any integers; ``fracs`` [3, n] in [0, 1]), planes read
    bilinearly and vectors linearly with align-corners and zero padding.
    Trilinear weights factor over the axes, so this equals
    ``tensorf_densify`` served trilinearly at those rows up to float32
    summation order, without the dense grid.  Forward and backward run
    in ``k0`` spans; ``k0_rows`` counts the rows."""
    profiling.count("k0_rows", base.shape[1])
    with profiling.span("k0"):
        out = _TensorfRows.apply(base, fracs,
                                 *(params[k] for k in _FACTORS),
                                 params.get("f_vec") if channels > 1 else None)
    return out


def tensorf_scale(params: Dict[str, torch.Tensor],
                  new_world_size) -> Dict[str, torch.Tensor]:
    """Progressive upscaling of the factored grid: an align-corners linear
    resize of each plane / vector to the new resolution; the feature
    basis passes through (`core/grids.py:126-140`)."""
    x, y, z = (int(v) for v in new_world_size)
    out = dict(params)
    for name, (a, b) in {"xy_plane": (x, y), "xz_plane": (x, z),
                         "yz_plane": (y, z)}.items():
        out[name] = _resize_axis_linear(
            _resize_axis_linear(params[name], 0, a), 1, b)
    for name, a in {"x_vec": x, "y_vec": y, "z_vec": z}.items():
        out[name] = _resize_axis_linear(params[name], 0, a)
    return out
