"""The SDF voxel renderer, coarse stage on the sorted channel-major engine.

Port of the parts of ``fgs_nerf_tpu/models/sdf_voxel.py`` that the
coarse sorted-engine train step runs: the config (``:62-233``),
parameter construction (``:241-297``), the mask machinery
(``:337-431``), ``_compact_valid`` (``:535-554``), the channel-major
shading head (``:980-1067``) and ``forward_coarse_sorted``
(``:1445-1633``).  The lattice engine and the fine stage are not ported
yet: ``forward`` raises ``NotImplementedError`` for them.

Parameters are a flat dict with the JAX package's names and layouts:
  sdf    [X, Y, Z, 1]
  k0     [X, Y, Z, k0_dim]
  refnet {w0 [in, out], b0 [out], ...}
  s_val  [1]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from fgs_nerf_tpu_torch.core.box import SceneBox, grid_resolution, max_samples_per_ray
from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device
from fgs_nerf_tpu_torch.models.mlp import init_mlp, refnet_dims
from fgs_nerf_tpu_torch.ops.cuda.fused_shade_cm import bf16_round, fused_shade_cm
from fgs_nerf_tpu_torch.ops.encoding import freq_bank
from fgs_nerf_tpu_torch.ops.ray_sample import ray_box_intersect
from fgs_nerf_tpu_torch.ops.sdf2alpha import neus_alpha_from_cos
from fgs_nerf_tpu_torch.ops.sorted_cm import (
    corner_weights_cm, pack_gather_sorted_cm, padded_rows_cm, rows_fracs_cm,
    rows_to_coords_cm, sort_stream, unsort_channels,
)
from fgs_nerf_tpu_torch.ops.stencils import sdf_gradient_cm, smooth_grid
from fgs_nerf_tpu_torch.ops.transmittance import alpha_to_weights


@dataclasses.dataclass(frozen=True)
class SDFModelConfig:
    """Static model configuration for one training stage
    (`sdf_voxel.py:62-171`; same fields and defaults)."""

    stage: str  # 'geometry_searching' | 'coarse' | 'fine'
    num_voxels: int
    num_voxels_base: int
    world_size: Tuple[int, int, int]
    voxel_size: float
    voxel_size_base: float
    s_max: int
    stepsize: float
    k0_dim: int = 12
    rgbnet_width: int = 256
    rgbnet_depth: int = 4
    refnet_width: int = 256
    refnet_depth: int = 4
    posbase_pe: int = 5
    viewbase_pe: int = 3
    refbase_pe: int = 8
    grad_feat: Tuple[float, ...] = ()
    sdf_feat: Tuple[float, ...] = ()
    k_grad_feat: Tuple[float, ...] = (1.0,)
    k_sdf_feat: Tuple[float, ...] = ()
    use_grad_norm: bool = True
    center_sdf: bool = True
    use_viewdir: bool = True
    grad_mode: str = "interpolate"
    s_ratio: float = 50.0
    s_start: float = 0.05
    s_learn: bool = False
    step_start: int = 0
    smooth_ksize: int = 0
    smooth_sigma: float = 1.0
    smooth_scale: bool = True
    fast_color_thres: float = 1e-4
    mask_cache_thres: float = 1e-3
    shade_k: int = 0
    sample_k: int = 0
    mlp_bf16: bool = True
    engine: str = "lattice"
    sort_pack16: bool = True
    grid_type: str = "dense"
    tensorf_n_comp: int = 8
    shade_remat: bool = True

    @property
    def is_fine(self) -> bool:
        return self.stage == "fine"

    @property
    def step_dist(self) -> float:
        return self.stepsize * self.voxel_size

    @property
    def smooth_sdf(self) -> bool:
        return self.smooth_ksize > 0

    def refnet_in_dim(self) -> int:
        """`sdf_voxel.py:162-171`."""
        d = 3 + 3 * self.refbase_pe * 2
        if self.is_fine:
            d += self.refnet_width
        else:
            d += self.k0_dim + (3 + 3 * self.posbase_pe * 2) + 3
            if self.use_viewdir:
                d += 3 + 3 * self.viewbase_pe * 2
        return d


def make_model_config(stage: str, xyz_min, xyz_max, num_voxels: int,
                      num_voxels_base: int, stepsize: float, shade_k: int = 0,
                      sp_multiple: int = 1, **kwargs) -> SDFModelConfig:
    """Resolve the voxel budget into static grid geometry
    (`sdf_voxel.py:174-233`), including the sorted engine's x rounding
    that makes (X+2)(Y+2) a multiple of 4."""
    world_size, voxel_size = grid_resolution(xyz_min, xyz_max, num_voxels)
    if sp_multiple > 1:
        x, y, z = world_size
        world_size = (x + (-x) % sp_multiple, y, z)
    if kwargs.get("engine") == "sorted":
        x, y, z = world_size
        while ((x + 2) * (y + 2)) % 4:
            x += 1
        world_size = (x, y, z)
    _, voxel_size_base = grid_resolution(xyz_min, xyz_max, num_voxels_base)
    s_max = max_samples_per_ray(world_size, stepsize)
    if shade_k == -1:
        shade_k = s_max
    if kwargs.get("sample_k") == -1:
        kwargs["sample_k"] = s_max
    shade_k = min(shade_k, s_max)
    if kwargs.get("sample_k", 0) > s_max:
        kwargs["sample_k"] = s_max
    return SDFModelConfig(
        stage=stage, num_voxels=num_voxels, num_voxels_base=num_voxels_base,
        world_size=world_size, voxel_size=voxel_size,
        voxel_size_base=voxel_size_base, s_max=s_max, stepsize=stepsize,
        shade_k=shade_k, **kwargs,
    )


# ---------------------------------------------------------------------------
# Parameter / buffer construction
# ---------------------------------------------------------------------------


def ball_init_sdf(world_size, stage: str, device: DeviceLike = None) -> torch.Tensor:
    """Unit-ball SDF init (`sdf_voxel.py:241-249`)."""
    axes = [np.linspace(-1.0, 1.0, n) for n in world_size]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(x**2 + y**2 + z**2)
    if stage != "geometry_searching":
        r = r - 1.0
    return torch.as_tensor(r[..., None].astype(np.float32),
                           device=resolve_device(device))


def init_params(generator: torch.Generator, cfg: SDFModelConfig,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Coarse-stage parameters (`sdf_voxel.py:252-276`), dense k0 only.
    ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    if cfg.grid_type != "dense":
        raise NotImplementedError(f"grid_type {cfg.grid_type!r} is not ported")
    if cfg.is_fine:
        raise NotImplementedError("the fine stage is not ported")
    return {
        "sdf": ball_init_sdf(cfg.world_size, cfg.stage, dev),
        "k0": torch.zeros((*cfg.world_size, cfg.k0_dim), dtype=torch.float32,
                          device=dev),
        "refnet": init_mlp(
            generator,
            refnet_dims(cfg.refnet_in_dim(), cfg.refnet_width, cfg.refnet_depth),
            dev,
        ),
        "s_val": torch.full((1,), cfg.s_start, dtype=torch.float32, device=dev),
    }


def k0_dense(params: Dict[str, Any], cfg: SDFModelConfig) -> torch.Tensor:
    """The k0 grid as dense [X, Y, Z, k0_dim] (`sdf_voxel.py:289-297`)."""
    if cfg.grid_type != "dense":
        raise NotImplementedError(f"grid_type {cfg.grid_type!r} is not ported")
    return params["k0"]


# ---------------------------------------------------------------------------
# Mask machinery
# ---------------------------------------------------------------------------


def _trilinear_sample_index(grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """8-corner trilinear interpolation at index-space coords, zero
    outside the grid (`ops/interp.py:60-85`); grid [X, Y, Z, C]."""
    sizes = torch.tensor(grid.shape[:3], dtype=torch.int64, device=grid.device)
    flat = grid.reshape(-1, grid.shape[-1])
    i0f = torch.floor(idx)
    f = idx - i0f
    i0 = i0f.long()
    out = None
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                off = torch.tensor((ox, oy, oz), device=grid.device)
                ci = i0 + off
                w = torch.prod(
                    torch.where(off.bool(), f, 1.0 - f), dim=-1)
                inb = torch.all((ci >= 0) & (ci < sizes), dim=-1)
                cc = torch.minimum(torch.clamp(ci, min=0), sizes - 1)
                lin = (cc[..., 0] * sizes[1] + cc[..., 1]) * sizes[2] + cc[..., 2]
                v = flat[lin] * inb[..., None].to(flat.dtype)
                term = w[..., None] * v
                out = term if out is None else out + term
    return out


def build_mask_cache(sdf_mask: torch.Tensor, prior_xyz_min,
                     prior_xyz_max) -> Dict[str, torch.Tensor]:
    """MaskCache state: 3x3x3 max-pooled prior-stage sdf_mask
    (`sdf_voxel.py:337-346`).  sdf_mask: [X, Y, Z, 1]."""
    pooled = F.max_pool3d(sdf_mask.permute(3, 0, 1, 2), 3, stride=1, padding=1)
    dev = sdf_mask.device
    return {
        "grid": pooled.permute(1, 2, 3, 0).contiguous(),
        "xyz_min": torch.as_tensor(np.asarray(prior_xyz_min, np.float32), device=dev),
        "xyz_max": torch.as_tensor(np.asarray(prior_xyz_max, np.float32), device=dev),
    }


def mask_cache_query(mc: Dict[str, torch.Tensor], xyz: torch.Tensor,
                     thres: float) -> torch.Tensor:
    """Trilinear lookup >= thres with the exact f32 threshold
    (`sdf_voxel.py:349-375`, CPU branch)."""
    box = SceneBox(mc["xyz_min"], mc["xyz_max"])
    sizes = torch.tensor(mc["grid"].shape[:3], dtype=torch.float32,
                         device=xyz.device)
    val = _trilinear_sample_index(mc["grid"], box.normalize(xyz) * (sizes - 1.0))
    return val[..., 0] >= thres


def inc_mask_query(lower, upper, xyz, box: SceneBox, world_size) -> torch.Tensor:
    """Incremental-voxel box test (`sdf_voxel.py:415-431`)."""
    sizes = torch.tensor(world_size, dtype=torch.float32, device=xyz.device)
    ijk = torch.floor(box.normalize(xyz) * (sizes - 1.0) + 0.5)
    inb = torch.all((ijk >= 0) & (ijk <= sizes - 1.0), dim=-1)
    u = ijk / (sizes - 1.0)
    inside = torch.all((u >= lower) & (u <= upper), dim=-1)
    return inside & inb


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _compact_valid(valid: torch.Tensor, k: int):
    """First ``k`` valid slots per ray in step order
    (`sdf_voxel.py:535-554`).  ``lax.top_k`` over ``-step`` scores keeps
    the valid slots in ascending step order and then the masked slots in
    ascending index order; a stable sort of the masked flag gives the
    same slots (``torch.topk`` leaves the order of ties open).  Returns
    (valid [N, k], steps [N, k] f32, overflow [N])."""
    order = torch.sort((~valid).to(torch.int32), dim=-1, stable=True)[1][:, :k]
    new_valid = torch.gather(valid, 1, order)
    overflow = torch.sum(valid, dim=-1) > k
    return new_valid, order.to(torch.float32), overflow


def _mlp_apply_cm(mlp_params, blocks, bf16: bool) -> torch.Tensor:
    """Channel-major MLP over concatenated feature row blocks
    (`sdf_voxel.py:1037-1067`): ``w.T @ x + b``, ReLU between layers.
    With ``bf16`` the operands are bf16-rounded, sums are f32, hidden
    layers round their output and bias add to bf16, and the last layer
    stays f32."""
    n = len(mlp_params) // 2
    if bf16:
        blocks = [bf16_round(b) for b in blocks]
    x = torch.cat(blocks, dim=0)
    for i in range(n):
        w, b = mlp_params[f"w{i}"], mlp_params[f"b{i}"]
        last = i == n - 1
        if bf16:
            z = bf16_round(w).T @ x
            if last:
                x = z + b[:, None]
            else:
                x = bf16_round(bf16_round(z) + bf16_round(b)[:, None])
        else:
            x = w.T @ x + b[:, None]
        if not last:
            x = torch.relu(x)
    return x


def _shade_coarse_cm(params, cfg: SDFModelConfig, rays_xyz, vd, normal, k0):
    """The coarse shading head over a channel-major stream
    (`sdf_voxel.py:980-1034`): the fused kernel pair B3/B4 when the JAX
    package takes its fused branch (bf16, 8-multiple hidden widths,
    M % 1024 == 0), else the plain channel-major MLP."""
    nx, ny, nz = normal
    vx, vy, vz = vd
    dot2 = 2.0 * (vx * nx + vy * ny + vz * nz)
    refl = (vx - dot2 * nx, vy - dot2 * ny, vz - dot2 * nz)
    m = k0.shape[-1]
    n_w = len(params["refnet"]) // 2
    widths_ok = all(
        params["refnet"][f"w{i}"].shape[1] % 8 == 0 for i in range(n_w - 1)
    )
    if cfg.mlp_bf16 and widths_ok and m % 1024 == 0:
        out = fused_shade_cm(
            k0.contiguous(), torch.stack(rays_xyz, dim=0),
            torch.stack(refl, dim=0), torch.stack(normal, dim=0),
            torch.stack(vd, dim=0) if cfg.use_viewdir else None,
            [params["refnet"][f"w{i}"] for i in range(n_w)],
            [params["refnet"][f"b{i}"] for i in range(n_w)],
            cfg.posbase_pe, cfg.refbase_pe, cfg.viewbase_pe,
        )
    else:
        def enc(parts, n_freq):
            x3 = torch.stack(parts, dim=0)
            freqs = freq_bank(n_freq, x3.device)
            xf = (x3[:, None, :] * freqs[None, :, None]).reshape(-1, x3.shape[-1])
            return torch.cat([x3, torch.sin(xf), torch.cos(xf)], dim=0)

        feats = [k0, enc(rays_xyz, cfg.posbase_pe), enc(refl, cfg.refbase_pe),
                 torch.stack(normal, dim=0)]
        if cfg.use_viewdir:
            feats.append(enc(vd, cfg.viewbase_pe))
        out = _mlp_apply_cm(params["refnet"], feats, bf16=cfg.mlp_bf16)
    return torch.sigmoid(out)  # [3, M]


def forward(params, buffers, cfg: SDFModelConfig, box: SceneBox, rays_o,
            rays_d, viewdirs, s_val, near: float, bg: float):
    """Render dispatch (`sdf_voxel.py:608-641`); only the coarse sorted
    engine is ported."""
    if cfg.is_fine:
        raise NotImplementedError("the fine stage is not ported yet")
    if cfg.engine != "sorted":
        raise NotImplementedError("the lattice engine is not ported yet")
    return forward_coarse_sorted(params, buffers, cfg, box, rays_o, rays_d,
                                 viewdirs, s_val, near, bg)


def forward_coarse_sorted(params, buffers, cfg: SDFModelConfig, box: SceneBox,
                          rays_o, rays_d, viewdirs, s_val, near: float,
                          bg: float) -> Dict[str, torch.Tensor]:
    """Geometry-searching / coarse render on the row-sorted stream,
    channel-major end to end (`sdf_voxel.py:1445-1633`): lattice
    sampling and compaction, one stable sort by grid row, the fused
    ``[sdf | grad | k0]`` serve (B1, backward B2), NeuS alpha, the
    shading head (B3, backward B4), an un-sort of five scalar channels
    and the ray-major transmittance scan."""
    n = rays_o.shape[0]
    dist = cfg.step_dist
    dev = rays_o.device

    t_min, t_max = ray_box_intersect(rays_o, rays_d, box, near, 1e9)
    d_norm = torch.sqrt(torch.sum(rays_d * rays_d, dim=-1))
    n_steps = torch.clamp(
        torch.ceil((t_max - t_min) * d_norm / cfg.step_dist), min=1.0
    ).to(torch.int32)
    start = rays_o + rays_d * t_min[..., None]
    dir_unit = rays_d / d_norm[..., None]
    step_ids = torch.arange(cfg.s_max, dtype=torch.float32, device=dev)

    def axes_at(steps):
        d_ = steps * cfg.step_dist
        return tuple(start[:, a:a + 1] + dir_unit[:, a:a + 1] * d_
                     for a in range(3))

    steps0 = step_ids[None, :].expand(n, cfg.s_max)
    px, py, pz = axes_at(steps0)
    valid = step_ids[None, :] < n_steps[:, None].to(torch.float32)
    for a, p in enumerate((px, py, pz)):
        valid = valid & (p >= box.xyz_min[a]) & (p <= box.xyz_max[a])

    use_mc = cfg.stage == "coarse" and "mask_cache" in buffers
    if use_mc or "inc_lower" in buffers:
        pts = torch.stack([px, py, pz], dim=-1)
        if use_mc:
            valid = valid & mask_cache_query(buffers["mask_cache"], pts,
                                             cfg.mask_cache_thres)
        if "inc_lower" in buffers:
            valid = valid & inc_mask_query(buffers["inc_lower"],
                                           buffers["inc_upper"], pts, box,
                                           cfg.world_size)

    if 0 < cfg.sample_k < cfg.s_max:
        valid, steps, sample_overflow = _compact_valid(valid, cfg.sample_k)
        px, py, pz = axes_at(steps)
    else:
        steps = steps0
        sample_overflow = torch.zeros((n,), dtype=torch.bool, device=dev)
    s = valid.shape[-1]
    m = n * s

    # ---- field, channel-major ----------------------------------------
    sdf_grid = params["sdf"]
    if cfg.smooth_sdf:
        sdf_grid = smooth_grid(sdf_grid, cfg.smooth_ksize, cfg.smooth_sigma)
    grad_cm = sdf_gradient_cm(params["sdf"][..., 0], cfg.voxel_size,
                              cfg.grad_mode)
    k0_cm = k0_dense(params, cfg).permute(3, 0, 1, 2)
    field_cm = torch.cat([sdf_grid[..., 0][None], grad_cm, k0_cm], dim=0)

    # ---- keys / sort --------------------------------------------------
    sizes = cfg.world_size
    ext = box.extent
    ix = (px - box.xyz_min[0]) / ext[0] * (sizes[0] - 1.0)
    iy = (py - box.xyz_min[1]) / ext[1] * (sizes[1] - 1.0)
    iz = (pz - box.xyz_min[2]) / ext[2] * (sizes[2] - 1.0)
    rows, (fx, fy, fz), ok = rows_fracs_cm(ix, iy, iz, sizes)
    r_sent = padded_rows_cm(sizes)
    keys = torch.where(valid & ok, rows, torch.full_like(rows, r_sent)).reshape(m)
    vds = [viewdirs[:, a:a + 1].expand(n, s).reshape(m) for a in range(3)]
    keys_s, iota_s, fx_s, fy_s, fz_s, vx_s, vy_s, vz_s = sort_stream(
        keys, fx.reshape(m), fy.reshape(m), fz.reshape(m), *vds,
        pack16=cfg.sort_pack16,
    )
    w8_s = corner_weights_cm(fx_s, fy_s, fz_s)

    samp = pack_gather_sorted_cm(field_cm, keys_s, w8_s)  # [4 + k0_dim, M]
    sdf_s = samp[0]
    gx, gy, gz = samp[1], samp[2], samp[3]
    k0_s = samp[4:]

    true_cos = vx_s * gx + vy_s * gy + vz_s * gz
    alpha_s = neus_alpha_from_cos(true_cos, sdf_s, dist, s_val)
    gn = torch.sqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-24)) + 1e-7
    hx, hy, hz = gx / gn, gy / gn, gz / gn
    hn = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz,
                                min=float(np.finfo(np.float32).eps)))
    nx, ny, nz = hx / hn, hy / hn, hz / hn
    ndv_s = -(nx * vx_s + ny * vy_s + nz * vz_s)

    b0, b1, b2 = rows_to_coords_cm(torch.clamp(keys_s, max=r_sent - 1), sizes)
    rays_xyz_s = (
        (b0 - 1.0 + fx_s) / (sizes[0] - 1.0),
        (b1 - 1.0 + fy_s) / (sizes[1] - 1.0),
        (b2 - 1.0 + fz_s) / (sizes[2] - 1.0),
    )
    shade_args = (rays_xyz_s, (vx_s, vy_s, vz_s), (nx, ny, nz), k0_s)
    if cfg.shade_remat:
        rgb_s = torch.utils.checkpoint.checkpoint(
            lambda *a: _shade_coarse_cm(params, cfg, *a), *shade_args,
            use_reentrant=False)
    else:
        rgb_s = _shade_coarse_cm(params, cfg, *shade_args)

    unsorted = unsort_channels(
        iota_s, torch.stack([alpha_s, rgb_s[0], rgb_s[1], rgb_s[2], ndv_s]))
    alpha = unsorted[0].reshape(n, s)
    ndv = unsorted[4].reshape(n, s)
    rgb_ch = tuple(unsorted[1 + a].reshape(n, s) for a in range(3))

    # ray-major tail — the double scan of forward_coarse
    w1, _ = alpha_to_weights(alpha, valid)
    if cfg.fast_color_thres > 0:
        live = valid & (w1 > cfg.fast_color_thres)
    else:
        live = valid
    weights, alphainv_last = alpha_to_weights(alpha, live)

    w_full = weights * live
    cum_w = torch.sum(w_full, dim=-1)
    comp, comp_sig = [], []
    for ch in rgb_ch:
        comp.append(torch.clamp(
            torch.sum(w_full * ch, dim=-1) + (1.0 - cum_w) * bg, 0.0, 1.0))
        comp_sig.append(torch.clamp(
            torch.sum(w_full * torch.sigmoid(ch), dim=-1) + (1.0 - cum_w) * bg,
            0.0, 1.0))
    rgb_marched = torch.stack(comp, dim=-1)
    sigmoid_rgb = torch.stack(comp_sig, dim=-1)
    depth = torch.sum(w_full * steps * dist, dim=-1).detach()

    return {
        "rgb_marched": rgb_marched,
        "sigmoid_rgb": sigmoid_rgb,
        "alphainv_cum": alphainv_last,
        "cum_weights": cum_w[..., None],
        "depth": depth,
        "disp": 1.0 / torch.clamp(depth, min=1e-10),
        "weights": w_full,
        "ndv": ndv,
        "live": live,
        "valid": valid,
        "sel_weights": w_full,
        "sel_rgb_ch": rgb_ch,
        "sel_live": live,
        "overflow": sample_overflow,
        "overflow_sample": sample_overflow,
        "overflow_shade": torch.zeros((n,), dtype=torch.bool, device=dev),
        "s_val": s_val,
    }
