"""The SDF voxel renderer: the lattice engine and the sorted channel-major
engine.

Port of ``fgs_nerf_tpu/models/sdf_voxel.py``: the config (``:62-233``),
parameter construction (``:241-297``), the mask machinery
(``:337-431``), the lattice engine (``_safe_norm``, ``_compact_valid``,
``_pts_at_steps``, ``_topk_select``, ``_gather_slots``, ``forward`` and
``forward_coarse`` / ``forward_fine`` with their shading heads,
``:529-972``), the channel-major shading heads (``:980-1067``,
``:1412-1442``), ``forward_fine_sorted`` (``:1070-1409``),
``forward_coarse_sorted`` (``:1445-1633``) and the stage handoff
(``:279-527``: refnet reset, the checkpoint's sdf_mask, bbox shrink,
nonempty mask, near-camera mask-out, view counts, rung upscaling and the
coarse -> fine warm start).

Parameters are a flat dict with the JAX package's names and layouts:
  sdf    [X, Y, Z, 1]
  k0     [X, Y, Z, k0_dim], or the TensoRF factor dict
         (``grid_type='tensorf'``, ``core/grids.py``)
  refnet {w0 [in, out], b0 [out], ...}
  rgbnet {w0 [in, out], b0 [out], ...}   (fine stage only)
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
from fgs_nerf_tpu_torch.core.grids import (
    init_tensorf_params, tensorf_densify, tensorf_rows, tensorf_scale,
)
from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device, to_device
from fgs_nerf_tpu_torch.models.mlp import (
    init_mlp, mlp_apply, refnet_dims, rgbnet_dims,
)
from fgs_nerf_tpu_torch.ops.cuda.fused_shade_cm import bf16_round, fused_shade_cm
from fgs_nerf_tpu_torch.ops.encoding import (
    freq_bank, l2_normalize, reflect, sincos_encode,
)
from fgs_nerf_tpu_torch.ops.interp import (
    _trilinear_sample_index_impl, center_gradient_taps, max_pool3d_same,
    resize_trilinear, sample_sdf_taps, trilinear_sample,
)
from fgs_nerf_tpu_torch.ops.ray_sample import (
    ray_box_intersect, ray_norm, sample_along_rays,
)
from fgs_nerf_tpu_torch.ops.sdf2alpha import neus_alpha, neus_alpha_from_cos
from fgs_nerf_tpu_torch.ops.sorted_cm import (
    corner_weights_cm, pack_gather_sorted_cm, padded_rows_cm, resort_channels,
    rows_fracs_cm, rows_to_coords_cm, sort_stream, tap_bounds,
    tap_deltas_weights, tap_gather_sorted_cm, unsort_channels,
)
from fgs_nerf_tpu_torch.ops.stencils import sdf_gradient_cm, smooth_grid
from fgs_nerf_tpu_torch.ops.transmittance import alpha_to_weights
from fgs_nerf_tpu_torch.parallel.spatial import (
    sharded_sdf_gradient, sharded_stencil, sp_mesh,
)
from fgs_nerf_tpu_torch.parallel.spatial_train import make_spatial_gather
from fgs_nerf_tpu_torch.utils import profiling


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
    def voxel_size_ratio(self) -> float:
        return self.voxel_size / self.voxel_size_base

    @property
    def step_dist(self) -> float:
        return self.stepsize * self.voxel_size

    @property
    def smooth_sdf(self) -> bool:
        return self.smooth_ksize > 0

    @property
    def all_displace(self) -> Tuple[float, ...]:
        """sorted(set(grad_feat | k_grad_feat)); the grad and sdf
        displacement sets must match (`sdf_voxel.py:142-150`)."""
        inds = tuple(sorted(set(self.grad_feat) | set(self.k_grad_feat)))
        sdf_inds = tuple(sorted(set(self.sdf_feat) | set(self.k_sdf_feat)))
        if inds != sdf_inds:
            raise ValueError("grad_feat/sdf_feat displacement sets must match")
        return inds

    def rgbnet_in_dim(self) -> int:
        """`sdf_voxel.py:152-160`."""
        d = (3 + 3 * self.posbase_pe * 2) + self.k0_dim + 3
        d += len(self.grad_feat) * 3 + len(self.sdf_feat) * 6
        if self.center_sdf:
            d += 1
        if self.use_viewdir:
            d += 3 + 3 * self.viewbase_pe * 2
        return d

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
    """Stage parameters (`sdf_voxel.py:252-276`); the fine stage adds
    ``rgbnet``.  k0 is a zero dense grid, or for ``grid_type='tensorf'``
    the factor dict of ``core/grids.py``, drawn after the MLPs.
    ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    if cfg.grid_type not in ("dense", "tensorf"):
        raise ValueError(f"unknown grid_type {cfg.grid_type!r}")
    params = {
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
    if cfg.is_fine:
        params["rgbnet"] = init_mlp(
            generator,
            rgbnet_dims(cfg.rgbnet_in_dim(), cfg.rgbnet_width, cfg.rgbnet_depth),
            dev,
        )
    if cfg.grid_type == "tensorf":
        params["k0"] = init_tensorf_params(generator, cfg.k0_dim,
                                           cfg.world_size,
                                           cfg.tensorf_n_comp, device=dev)
    return params


def k0_dense(params: Dict[str, Any], cfg: SDFModelConfig) -> torch.Tensor:
    """The k0 grid as dense [X, Y, Z, k0_dim] (`sdf_voxel.py:289-297`):
    the grid itself, or the TensoRF factors densified (every step;
    autograd carries the gradients back to the factors)."""
    if cfg.grid_type == "tensorf":
        return tensorf_densify(params["k0"], cfg.k0_dim)
    return params["k0"]


# ---------------------------------------------------------------------------
# Mask machinery
# ---------------------------------------------------------------------------


def build_mask_cache(sdf_mask: torch.Tensor, prior_xyz_min,
                     prior_xyz_max) -> Dict[str, torch.Tensor]:
    """MaskCache state: 3x3x3 max-pooled prior-stage sdf_mask
    (`sdf_voxel.py:337-346`).  sdf_mask: [X, Y, Z, 1]."""
    dev = sdf_mask.device
    return {
        "grid": max_pool3d_same(sdf_mask, 3),
        "xyz_min": torch.as_tensor(np.asarray(prior_xyz_min, np.float32), device=dev),
        "xyz_max": torch.as_tensor(np.asarray(prior_xyz_max, np.float32), device=dev),
    }


def mask_cache_query(mc: Dict[str, torch.Tensor], xyz: torch.Tensor,
                     thres: float) -> torch.Tensor:
    """Trilinear lookup >= thres with the exact f32 threshold
    (`sdf_voxel.py:349-375`, CPU branch)."""
    box = SceneBox(mc["xyz_min"], mc["xyz_max"])
    sizes = to_device(mc["grid"].shape[:3], xyz.device, torch.float32)
    val = _trilinear_sample_index_impl(mc["grid"],
                                       box.normalize(xyz) * (sizes - 1.0))
    return val[..., 0] >= thres


def inc_mask_query(lower, upper, xyz, box: SceneBox, world_size) -> torch.Tensor:
    """Incremental-voxel box test (`sdf_voxel.py:415-431`)."""
    sizes = torch.tensor(world_size, dtype=torch.float32, device=xyz.device)
    ijk = torch.floor(box.normalize(xyz) * (sizes - 1.0) + 0.5)
    inb = torch.all((ijk >= 0) & (ijk <= sizes - 1.0), dim=-1)
    u = ijk / (sizes - 1.0)
    inside = torch.all((u >= lower) & (u <= upper), dim=-1)
    return inside & inb


def reset_refnet(params: Dict[str, Any], generator: torch.Generator,
                 cfg: SDFModelConfig) -> Dict[str, Any]:
    """Re-init the shading head after a progressive-scaling rung
    (`sdf_voxel.py:279-286`).  ``generator`` lives on the params' device."""
    new = dict(params)
    new["refnet"] = init_mlp(
        generator,
        refnet_dims(cfg.refnet_in_dim(), cfg.refnet_width, cfg.refnet_depth),
        params["sdf"].device,
    )
    return new


def empty_buffers() -> Dict[str, Any]:
    return {}


def build_sdf_mask(params: Dict[str, Any], cfg: SDFModelConfig) -> torch.Tensor:
    """The checkpoint-time occupancy summary handed to the next stage
    (`sdf_voxel.py:309-320`), with the reference's quirk: a boolean
    ``sdf < 0.5`` (not ``|sdf| < 0.5``) scaled to 1e-3, on the smoothed
    SDF when smoothing is on."""
    sdf = params["sdf"]
    if cfg.smooth_sdf:
        sdf = smooth_grid(sdf, cfg.smooth_ksize, cfg.smooth_sigma)
    return torch.where(sdf < 0.5, 1e-3, 0.0).to(torch.float32)


def compute_bbox_from_sdf_mask(sdf_mask: np.ndarray, xyz_min: np.ndarray,
                               xyz_max: np.ndarray):
    """Shrink the stage bbox to the active mask extent, on the host
    (`sdf_voxel.py:323-334`)."""
    m = np.asarray(sdf_mask)[..., 0] > 0
    axes = [np.linspace(0.0, 1.0, n) for n in m.shape]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    interp = np.stack([gx, gy, gz], -1)
    dense_xyz = xyz_min * (1 - interp) + xyz_max * interp
    active = dense_xyz[m]
    return active.min(0).astype(np.float32), active.max(0).astype(np.float32)


def _grid_nodes(world_size, box: SceneBox) -> torch.Tensor:
    """World positions of the grid nodes [X, Y, Z, 3]
    (`sdf_voxel.py:393-396`)."""
    axes = [torch.linspace(float(box.xyz_min[i]), float(box.xyz_max[i]),
                           world_size[i], dtype=torch.float32,
                           device=box.xyz_min.device) for i in range(3)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx, gy, gz], -1)


def set_nonempty_mask(params: Dict[str, Any], buffers: Dict[str, Any],
                      cfg: SDFModelConfig, box: SceneBox):
    """Mark grid nodes inside known-occupied space; in the coarse stage
    also push free-space SDF to +1 (`sdf_voxel.py:378-390`)."""
    nodes = _grid_nodes(cfg.world_size, box)
    mask = mask_cache_query(buffers["mask_cache"], nodes, cfg.mask_cache_thres)
    buffers = dict(buffers)
    buffers["nonempty_mask"] = mask[..., None]
    params = dict(params)
    if cfg.stage == "coarse":
        params["sdf"] = torch.where(mask[..., None], params["sdf"], 1.0)
    return params, buffers


def maskout_near_cam_vox(params: Dict[str, Any], cam_o: torch.Tensor,
                         near: float, cfg: SDFModelConfig,
                         box: SceneBox) -> Dict[str, Any]:
    """SDF := 5 for voxels within ``near`` of any camera
    (`sdf_voxel.py:399-412`); one camera at a time, so no
    [X, Y, Z, V, 3] temporary."""
    nodes = _grid_nodes(cfg.world_size, box)
    d2 = None
    for c in cam_o:
        diff = nodes - c
        dc = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
        d2 = dc if d2 is None else torch.minimum(d2, dc)
    near_mask = torch.sqrt(d2) <= near
    params = dict(params)
    params["sdf"] = torch.where(near_mask[..., None], 5.0, params["sdf"])
    return params


def voxel_count_views(cfg, box: SceneBox,
                      rays_o_views: np.ndarray, rays_d_views: np.ndarray,
                      near: float, far: float, stepsize: float,
                      downrate: int = 1) -> torch.Tensor:
    """Per-voxel count of views whose rays deposit more than 1 of
    accumulated trilinear weight (`sdf_voxel.py:434-480`).  The weight is
    the gradient of ``sum(trilinear(ones, pts))`` w.r.t. the grid, i.e.
    the trilinear backward (kernel B7 on the card).  ``cfg`` is any
    config with ``world_size`` and ``voxel_size``: an ``SDFModelConfig``
    or the DVGO stage's ``DensityModelConfig``."""
    dev = box.xyz_min.device
    n_samples = int(np.linalg.norm(np.asarray(cfg.world_size) + 1)
                    / stepsize) + 1
    step = (stepsize * cfg.voxel_size
            * torch.arange(n_samples, dtype=torch.float32, device=dev))
    count = torch.zeros((*cfg.world_size, 1), dtype=torch.float32, device=dev)
    for v in range(len(rays_o_views)):
        rays_o = torch.as_tensor(
            np.ascontiguousarray(rays_o_views[v][::downrate, ::downrate])
            .reshape(-1, 3), device=dev)
        rays_d = torch.as_tensor(
            np.ascontiguousarray(rays_d_views[v][::downrate, ::downrate])
            .reshape(-1, 3), device=dev)
        vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
        rate_a = (box.xyz_max - rays_o) / vec
        rate_b = (box.xyz_min - rays_o) / vec
        t_min = torch.clamp(torch.amax(torch.minimum(rate_a, rate_b), -1),
                            near, far)
        interpx = t_min[:, None] + step[None, :] / torch.linalg.norm(
            rays_d, dim=-1, keepdim=True)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
        ones = torch.ones((*cfg.world_size, 1), dtype=torch.float32,
                          device=dev, requires_grad=True)
        (w,) = torch.autograd.grad(trilinear_sample(ones, pts, box).sum(),
                                   ones)
        count = count + (w > 1.0).to(torch.float32)
    return count


def scale_volume_grid(params: Dict[str, Any],
                      new_cfg: SDFModelConfig) -> Dict[str, Any]:
    """Trilinear upsample of sdf + k0 to the new rung's resolution
    (`sdf_voxel.py:488-501`); TensoRF factors are resized one by one."""
    params = dict(params)
    params["sdf"] = resize_trilinear(params["sdf"], new_cfg.world_size)
    if new_cfg.grid_type == "tensorf":
        params["k0"] = tensorf_scale(params["k0"], new_cfg.world_size)
    else:
        params["k0"] = resize_trilinear(params["k0"], new_cfg.world_size)
    return params


def init_sdf_from_sdf(params: Dict[str, Any], sdf0: torch.Tensor,
                      cfg: SDFModelConfig, reduce: float = 1.0) -> Dict[str, Any]:
    """Warm-start the SDF from the previous stage's grid
    (`sdf_voxel.py:504-521`): resize, divide by ``reduce``, then (with
    ``smooth_scale``) a 5^3 sigma-1 gaussian."""
    params = dict(params)
    if tuple(sdf0.shape[:3]) != tuple(cfg.world_size):
        sdf0 = resize_trilinear(sdf0, cfg.world_size)
    sdf = sdf0 / reduce
    if cfg.smooth_scale:
        sdf = smooth_grid(sdf, 5, 1.0)
    params["sdf"] = sdf
    return params


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


def _topk_select(weights: torch.Tensor, live: torch.Tensor, k: int):
    """Per-ray top-``k`` slots by weight (`sdf_voxel.py:568-573`).
    ``lax.top_k`` puts the lower index first among equal scores; a
    stable descending sort does the same (``torch.topk`` leaves the order
    of ties open).  Returns (idx [N, k] int64, sel_live [N, k])."""
    score = torch.where(live, weights, torch.full_like(weights, -1.0))
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return idx[:, :k], vals[:, :k] > 0.0


def _gather_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis over the sample axis for [N, S] or [N, S, C]
    (`sdf_voxel.py:576-606`; the JAX package writes it as a one-hot
    matmul only because the TPU lacks a fast gather)."""
    if x.ndim == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


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
        feats = [k0, _enc_cm(rays_xyz, cfg.posbase_pe),
                 _enc_cm(refl, cfg.refbase_pe), torch.stack(normal, dim=0)]
        if cfg.use_viewdir:
            feats.append(_enc_cm(vd, cfg.viewbase_pe))
        out = _mlp_apply_cm(params["refnet"], feats, bf16=cfg.mlp_bf16)
    return torch.sigmoid(out)  # [3, M]


def _enc_cm(parts, n_freq: int) -> torch.Tensor:
    """Channel-major sincos encoding of three [M] rows:
    [x3 | sin(x3 * f) | cos(x3 * f)], rows axis-major then frequency."""
    x3 = torch.stack(parts, dim=0)
    freqs = freq_bank(n_freq, x3.device)
    xf = (x3[:, None, :] * freqs[None, :, None]).reshape(3 * n_freq,
                                                         x3.shape[-1])
    return torch.cat([x3, torch.sin(xf), torch.cos(xf)], dim=0)


def _shade_fine_cm(params, cfg: SDFModelConfig, rays_xyz, vd, normal, sdf, k0,
                   all_feat_rows, grad_rows, grad_xyz) -> torch.Tensor:
    """The fine shading head over a channel-major stream
    (`sdf_voxel.py:1412-1442`): rgbnet over the feature row blocks in the
    lattice head's concat order, then refnet over [rgb_feat | reflection
    encoding]; plain matmuls, as in the JAX package."""
    feats = [k0, _enc_cm(rays_xyz, cfg.posbase_pe)]
    if cfg.use_viewdir:
        feats.append(_enc_cm(vd, cfg.viewbase_pe))
    if cfg.center_sdf:
        feats.append(sdf[None])
    feats.append(torch.stack(all_feat_rows, dim=0))
    feats.append(torch.stack(grad_rows, dim=0))
    feats.append(torch.stack(grad_xyz, dim=0))
    rgb_feat = _mlp_apply_cm(params["rgbnet"], feats, bf16=cfg.mlp_bf16)

    nx, ny, nz = normal
    vx, vy, vz = vd
    dot2 = 2.0 * (vx * nx + vy * ny + vz * nz)
    refl = (vx - dot2 * nx, vy - dot2 * ny, vz - dot2 * nz)
    out = _mlp_apply_cm(params["refnet"],
                        [rgb_feat, _enc_cm(refl, cfg.refbase_pe)],
                        bf16=cfg.mlp_bf16)
    return torch.sigmoid(out)  # [3, M]


def forward(params, buffers, cfg: SDFModelConfig, box: SceneBox, rays_o,
            rays_d, viewdirs, s_val, near: float, bg: float, mesh=None):
    """Render dispatch (`sdf_voxel.py:608-641`): the sorted engine when
    ``cfg.engine == "sorted"`` (the fine stage only when its
    displacements include 1.0), else the lattice engine.  Under spatial
    grid sharding (a ``mesh`` with sp > 1, ``parallel/spatial_train.py``)
    the sorted engine falls back to the lattice pipeline, which serves
    the sp-sharded gathers."""
    sorted_ok = cfg.engine == "sorted" and sp_mesh(mesh) is None
    if cfg.is_fine:
        if sorted_ok and cfg.all_displace and 1.0 in cfg.all_displace:
            fwd = forward_fine_sorted
        else:
            fwd = forward_fine
    elif sorted_ok:
        fwd = forward_coarse_sorted
    else:
        fwd = forward_coarse
    # sorted engines run only where sp does not shard the grids
    sp_kw = {} if sp_mesh(mesh) is None else {"mesh": mesh}
    out = fwd(params, buffers, cfg, box, rays_o, rays_d, viewdirs, s_val,
              near, bg, **sp_kw)
    # the sorted fine head computes its stream's live prefix; the other
    # heads every slot of their fixed capacity
    head_rows = out.pop("head_rows") if fwd is forward_fine_sorted else None
    if profiling.recording():
        # the head's useful work: live rows of rows computed
        profiling.count("head_live_rows", torch.sum(out["sel_live"]))
        profiling.count("head_rows", out["sel_live"].numel()
                        if head_rows is None else head_rows)
    return out


def _field_sample(cfg: SDFModelConfig, box: SceneBox, field, pts, gather_fn):
    """The fused field's trilinear gather: cell-packed on one device, the
    sharded gather (global index space) under sp."""
    if gather_fn is None:
        return trilinear_sample(field, pts, box, packed=True)
    sizes = torch.tensor(cfg.world_size, dtype=torch.float32,
                         device=pts.device)
    return gather_fn(field, box.normalize(pts) * (sizes - 1.0),
                     cfg.world_size[0])


def _gather_fn(mesh):
    """The sharded gather under sp, else None (the dense gathers)."""
    return None if sp_mesh(mesh) is None else make_spatial_gather(mesh)


def _smooth(cfg: SDFModelConfig, sdf_grid, mesh):
    return sharded_stencil(
        lambda g: smooth_grid(g, cfg.smooth_ksize, cfg.smooth_sigma),
        sdf_grid, cfg.smooth_ksize // 2, mesh)


# ---------------------------------------------------------------------------
# Lattice engine (`sdf_voxel.py:529-972`)
# ---------------------------------------------------------------------------


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis with a NaN-free gradient at 0
    (`sdf_voxel.py:529-532`)."""
    return torch.sqrt(torch.clamp(torch.sum(x**2, dim=-1, keepdim=True),
                                  min=1e-24))


def _pts_at_steps(rays_o, rays_d, t_min, steps, step_dist: float):
    """World positions of lattice slots ``steps`` [N, k]
    (`sdf_voxel.py:557-565`): the expression tree of
    ``ops/ray_sample.py:sample_along_rays``, so the points are
    bitwise-identical to the lattice points."""
    d_norm = ray_norm(rays_d)
    start = rays_o + rays_d * t_min[..., None]
    dir_unit = rays_d / d_norm[..., None]
    dist = steps * step_dist
    return start[:, None, :] + dir_unit[:, None, :] * dist[..., None]


def _remat(cfg: SDFModelConfig, fn, *args):
    """The shading head ``fn(*args)`` in a ``shade`` span, recomputed in
    the backward (in a ``shade`` span there too) when ``cfg.shade_remat``
    (``jax.checkpoint`` at `sdf_voxel.py:729-731`, `:888-890`)."""
    def shade(*a):
        with profiling.span("shade"):
            return fn(*a)

    if cfg.shade_remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(shade, *args,
                                                 use_reentrant=False)
    return shade(*args)


def _lattice_samples(cfg: SDFModelConfig, box: SceneBox, rays_o, rays_d,
                     near: float, valid_fn):
    """The lattice, ``valid &= valid_fn(pts)`` for the mask buffers, and
    the compaction to ``sample_k`` slots with recomputed points
    (`sdf_voxel.py:653-670`, `:805-818`).  Returns (pts, valid, steps,
    sample_overflow)."""
    n = rays_o.shape[0]
    rs = sample_along_rays(rays_o, rays_d, box, near, cfg.step_dist,
                           cfg.s_max)
    pts, valid = rs.pts, rs.valid
    valid = valid_fn(pts, valid)
    if 0 < cfg.sample_k < cfg.s_max:
        valid, steps, sample_overflow = _compact_valid(valid, cfg.sample_k)
        pts = _pts_at_steps(rays_o, rays_d, rs.t_min, steps, cfg.step_dist)
    else:
        steps = torch.arange(cfg.s_max, dtype=torch.float32,
                             device=rays_o.device).expand(valid.shape)
        sample_overflow = torch.zeros((n,), dtype=torch.bool,
                                      device=rays_o.device)
    return pts, valid, steps, sample_overflow


def _composite(s_weights, rgb, w_full, bg: float):
    """(rgb_marched, sigmoid_rgb, cum_weights) with the double sigmoid
    (`sdf_voxel.py:733-745`)."""
    cum_weights = torch.sum(w_full, dim=-1, keepdim=True)
    rgb_marched = torch.clamp(
        torch.sum(s_weights[..., None] * rgb, dim=1) + (1.0 - cum_weights) * bg,
        0.0, 1.0)
    sigmoid_rgb = torch.clamp(
        torch.sum(s_weights[..., None] * torch.sigmoid(rgb), dim=1)
        + (1.0 - cum_weights) * bg, 0.0, 1.0)
    return rgb_marched, sigmoid_rgb, cum_weights


def forward_coarse(params, buffers, cfg: SDFModelConfig, box: SceneBox,
                   rays_o, rays_d, viewdirs, s_val, near: float,
                   bg: float, mesh=None) -> Dict[str, torch.Tensor]:
    """Geometry-searching / coarse render on the lattice
    (`sdf_voxel.py:644-768`): the fused ``[sdf | grad | k0]`` trilinear
    gather (cell-packed where worthwhile; backward kernel B7), NeuS alpha,
    the double scan, top-``shade_k`` selection and the refnet head.
    ``mesh`` with sp > 1: the grids are x-slabs, smoothed and
    differentiated with halos and served by the sharded gather."""
    n = rays_o.shape[0]
    dev = rays_o.device

    def valid_fn(pts, valid):
        if cfg.stage == "coarse" and "mask_cache" in buffers:
            valid = valid & mask_cache_query(buffers["mask_cache"], pts,
                                             cfg.mask_cache_thres)
        if "inc_lower" in buffers:
            valid = valid & inc_mask_query(buffers["inc_lower"],
                                           buffers["inc_upper"], pts, box,
                                           cfg.world_size)
        return valid

    pts, valid, steps, sample_overflow = _lattice_samples(
        cfg, box, rays_o, rays_d, near, valid_fn)

    gather_fn = _gather_fn(mesh)
    sdf_grid = params["sdf"]
    if cfg.smooth_sdf:
        sdf_grid = _smooth(cfg, sdf_grid, mesh)
    # the gradient field comes from the raw sdf grid (`sdf_voxel.py:675`)
    grad_field = sharded_sdf_gradient(params["sdf"], cfg.voxel_size, mesh,
                                      cfg.grad_mode)
    field = torch.cat([sdf_grid, grad_field, k0_dense(params, cfg)], dim=-1)
    samp = _field_sample(cfg, box, field, pts, gather_fn)  # [N, S, 4 + k0]
    sdf = samp[..., 0]
    gradient = samp[..., 1:4]
    k0_all = samp[..., 4:]

    dist = cfg.step_dist
    alpha = neus_alpha(viewdirs, sdf, gradient, dist, s_val)
    w1, _ = alpha_to_weights(alpha, valid)
    if cfg.fast_color_thres > 0:
        live = valid & (w1 > cfg.fast_color_thres)
    else:
        live = valid
    weights, alphainv_last = alpha_to_weights(alpha, live)
    normal = l2_normalize(gradient / (_safe_norm(gradient) + 1e-7))

    if cfg.shade_k > 0:
        idx, sel_live = _topk_select(weights, live, cfg.shade_k)
        s_pack = _gather_slots(
            torch.cat([pts, normal, k0_all, weights[..., None]], dim=-1), idx)
        s_pts = s_pack[..., 0:3]
        s_normal = s_pack[..., 3:6]
        s_k0 = s_pack[..., 6:6 + cfg.k0_dim]
        s_weights = s_pack[..., 6 + cfg.k0_dim] * sel_live
        overflow = torch.sum(live, dim=-1) > cfg.shade_k
    else:
        s_pts, s_normal, s_k0 = pts, normal, k0_all
        s_weights = weights * live
        sel_live = live
        overflow = torch.zeros((n,), dtype=torch.bool, device=dev)

    viewdirs_pts = viewdirs[:, None, :].expand(s_pts.shape)
    rgb = _remat(cfg, lambda *a: _shade_coarse(params, cfg, box, *a),
                 s_pts, viewdirs_pts, s_normal, viewdirs, s_k0)

    w_full = weights * live
    rgb_marched, sigmoid_rgb, cum_weights = _composite(s_weights, rgb, w_full,
                                                       bg)
    depth = torch.sum(w_full * steps * dist, dim=-1).detach()
    return {
        "rgb_marched": rgb_marched,
        "sigmoid_rgb": sigmoid_rgb,
        "alphainv_cum": alphainv_last,
        "cum_weights": cum_weights,
        "normal_marched": torch.sum(w_full[..., None] * normal, dim=1),
        "depth": depth,
        "disp": 1.0 / torch.clamp(depth, min=1e-10),
        "weights": w_full,
        "normal": normal,
        "live": live,
        "valid": valid,
        "sel_weights": s_weights,
        "sel_rgb": rgb,
        "sel_live": sel_live,
        "overflow": overflow | sample_overflow,
        "overflow_sample": sample_overflow,
        "overflow_shade": overflow,
        "s_val": s_val,
    }


def _vd_emb(cfg: SDFModelConfig, viewdirs, shape2):
    """The per-ray view-direction encoding broadcast over the samples."""
    emb = sincos_encode(viewdirs, freq_bank(cfg.viewbase_pe, viewdirs.device))
    return emb[:, None, :].expand(*shape2, emb.shape[-1])


def _shade_coarse(params, cfg: SDFModelConfig, box: SceneBox, pts,
                  viewdirs_pts, normal, viewdirs, k0) -> torch.Tensor:
    """Coarse shading head (`sdf_voxel.py:771-792`): refnet on
    [k0, xyz_emb, reflect_emb, normal(, viewdirs_emb)] -> sigmoid."""
    dev = pts.device
    xyz_emb = sincos_encode(box.normalize(pts), freq_bank(cfg.posbase_pe, dev))
    refl = reflect(viewdirs_pts, normal)
    reflect_emb = sincos_encode(refl, freq_bank(cfg.refbase_pe, dev))
    feats = [k0, xyz_emb, reflect_emb, normal]
    if cfg.use_viewdir:
        feats.append(_vd_emb(cfg, viewdirs, pts.shape[:2]))
    if cfg.mlp_bf16:
        # the casts mlp_apply would make, one feature at a time
        feats = [f.to(torch.bfloat16) for f in feats]
    out = mlp_apply(params["refnet"], torch.cat(feats, dim=-1),
                    bf16=cfg.mlp_bf16)
    return torch.sigmoid(out.float())


def forward_fine(params, buffers, cfg: SDFModelConfig, box: SceneBox,
                 rays_o, rays_d, viewdirs, s_val, near: float,
                 bg: float, mesh=None) -> Dict[str, torch.Tensor]:
    """Fine render on the lattice (`sdf_voxel.py:795-928`): the fused
    ``[sdf | k0]`` gather, the displacement-1.0 center taps for alpha,
    one scan, top-``shade_k`` selection, the hierarchical taps on the
    selection (outside the remat boundary) and the rgbnet -> refnet head.
    Each of the three trilinear gathers runs kernel B7 in its backward."""
    n = rays_o.shape[0]
    dev = rays_o.device

    def valid_fn(pts, valid):
        if "mask_cache" in buffers:
            valid = valid & mask_cache_query(buffers["mask_cache"], pts,
                                             cfg.mask_cache_thres)
        return valid

    pts, valid, steps, sample_overflow = _lattice_samples(
        cfg, box, rays_o, rays_d, near, valid_fn)

    gather_fn = _gather_fn(mesh)
    sdf_grid = params["sdf"]
    if cfg.smooth_sdf:
        sdf_grid = _smooth(cfg, sdf_grid, mesh)
    field = torch.cat([sdf_grid, k0_dense(params, cfg)], dim=-1)
    samp = _field_sample(cfg, box, field, pts, gather_fn)
    sdf = samp[..., 0]
    k0_all = samp[..., 1:]
    # the tap samplers on x-slabs: the sharded gather, global sizes
    taps = {} if gather_fn is None else dict(
        sample_fn=lambda grid, idx: gather_fn(grid, idx, cfg.world_size[0]),
        grid_size=cfg.world_size)
    gradient, _ = center_gradient_taps(sdf_grid, pts, box, cfg.voxel_size,
                                       **taps)

    dist = cfg.step_dist
    alpha = neus_alpha(viewdirs, sdf, gradient, dist, s_val)
    # alpha threshold -> one scan -> weight threshold
    if cfg.fast_color_thres > 0:
        m1 = valid & (alpha > cfg.fast_color_thres)
    else:
        m1 = valid
    weights, alphainv_last = alpha_to_weights(alpha, m1)
    if cfg.fast_color_thres > 0:
        live = m1 & (weights > cfg.fast_color_thres)
    else:
        live = m1
    normal = l2_normalize(gradient / (_safe_norm(gradient) + 1e-7))
    w_eff = weights * live

    if cfg.shade_k > 0:
        idx, sel_live = _topk_select(weights, live, cfg.shade_k)
        s_pack = _gather_slots(
            torch.cat([pts, sdf[..., None], normal, gradient, k0_all,
                       weights[..., None]], dim=-1), idx)
        s_pts = s_pack[..., 0:3]
        s_sdf = s_pack[..., 3]
        s_normal = s_pack[..., 4:7]
        s_gradient = s_pack[..., 7:10]
        s_k0 = s_pack[..., 10:10 + cfg.k0_dim]
        s_weights = s_pack[..., 10 + cfg.k0_dim] * sel_live
        overflow = torch.sum(live, dim=-1) > cfg.shade_k
    else:
        s_pts, s_sdf, s_normal, s_gradient = pts, sdf, normal, gradient
        s_k0 = k0_all
        s_weights = w_eff
        sel_live = live
        overflow = torch.zeros((n,), dtype=torch.bool, device=dev)

    # hierarchical taps outside the remat boundary (a re-gather in the
    # backward would double the dominant gather)
    tap_feats = []
    if cfg.all_displace:
        all_feat, all_grad = sample_sdf_taps(
            sdf_grid, s_pts, box, cfg.all_displace, cfg.voxel_size,
            cfg.use_grad_norm, **taps)
        d = len(cfg.all_displace)
        tap_feats = [all_feat.reshape(*s_pts.shape[:2], 6 * d),
                     all_grad.reshape(*s_pts.shape[:2], 3 * d)]
    nt = len(tap_feats)
    rgb = _remat(
        cfg, lambda *a: _shade_fine(params, cfg, box, list(a[:nt]), *a[nt:]),
        *tap_feats, s_pts, s_sdf, s_gradient, s_normal, viewdirs, s_k0)

    rgb_marched, sigmoid_rgb, cum_weights = _composite(s_weights, rgb, w_eff,
                                                       bg)
    depth = torch.sum(w_eff * steps * dist, dim=-1).detach()
    return {
        "rgb_marched": rgb_marched,
        "sigmoid_rgb": sigmoid_rgb,
        "alphainv_cum": alphainv_last,
        "cum_weights": cum_weights,
        "normal_marched": torch.sum(w_eff[..., None] * normal, dim=1),
        "depth": depth,
        "disp": 1.0 / torch.clamp(depth, min=1e-10),
        "weights": w_eff,
        "normal": normal,
        "live": live,
        "valid": valid,
        "sel_weights": s_weights,
        "sel_rgb": rgb,
        "sel_live": sel_live,
        "overflow": overflow | sample_overflow,
        "overflow_sample": sample_overflow,
        "overflow_shade": overflow,
        "s_val": s_val,
    }


def _shade_fine(params, cfg: SDFModelConfig, box: SceneBox, tap_feats, pts,
                sdf, gradient, normal, viewdirs, k0) -> torch.Tensor:
    """Fine shading (`sdf_voxel.py:931-972`): rgbnet on [k0, xyz_emb(,
    viewdirs_emb)(, sdf), taps, tap gradients, center gradient], then
    refnet on [rgb_feat, reflect_emb] -> sigmoid."""
    dev = pts.device
    feats = [k0, sincos_encode(box.normalize(pts),
                               freq_bank(cfg.posbase_pe, dev))]
    if cfg.use_viewdir:
        feats.append(_vd_emb(cfg, viewdirs, pts.shape[:2]))
    if cfg.center_sdf:
        feats.append(sdf[..., None])
    feats.extend(tap_feats)
    feats.append(gradient)
    if cfg.mlp_bf16:
        feats = [f.to(torch.bfloat16) for f in feats]
    rgb_feat = mlp_apply(params["rgbnet"], torch.cat(feats, dim=-1),
                         bf16=cfg.mlp_bf16)
    refl = reflect(viewdirs[:, None, :].expand(pts.shape), normal)
    reflect_emb = sincos_encode(refl, freq_bank(cfg.refbase_pe, dev))
    dt = torch.bfloat16 if cfg.mlp_bf16 else torch.float32
    ref_feat = torch.cat([rgb_feat.to(dt), reflect_emb.to(dt)], dim=-1)
    out = mlp_apply(params["refnet"], ref_feat, bf16=cfg.mlp_bf16)
    return torch.sigmoid(out.float())


# ---------------------------------------------------------------------------
# Sorted channel-major engine (`sdf_voxel.py:980-1633`)
# ---------------------------------------------------------------------------


def _lattice(cfg: SDFModelConfig, box: SceneBox, rays_o, rays_d, near: float):
    """The per-ray sample lattice of the sorted engines
    (`sdf_voxel.py:1117-1137`, `:1465-1489`): (axes_at, steps0, lattice
    points (px, py, pz), valid); ``axes_at(steps)`` recomputes points at
    any step ids with the same expressions."""
    n = rays_o.shape[0]
    t_min, t_max = ray_box_intersect(rays_o, rays_d, box, near, 1e9)
    d_norm = ray_norm(rays_d)
    n_steps = torch.clamp(
        torch.ceil((t_max - t_min) * d_norm / cfg.step_dist), min=1.0
    ).to(torch.int32)
    start = rays_o + rays_d * t_min[..., None]
    dir_unit = rays_d / d_norm[..., None]
    step_ids = torch.arange(cfg.s_max, dtype=torch.float32,
                            device=rays_o.device)

    def axes_at(steps):
        d_ = steps * cfg.step_dist
        return tuple(start[:, a:a + 1] + dir_unit[:, a:a + 1] * d_
                     for a in range(3))

    steps0 = step_ids[None, :].expand(n, cfg.s_max)
    pts = axes_at(steps0)
    valid = step_ids[None, :] < n_steps[:, None].to(torch.float32)
    for a, p in enumerate(pts):
        valid = valid & (p >= box.xyz_min[a]) & (p <= box.xyz_max[a])
    return axes_at, steps0, pts, valid


def _index_coords(cfg: SDFModelConfig, box: SceneBox, px, py, pz):
    """World points -> per-axis grid index coordinates."""
    sizes, ext = cfg.world_size, box.extent
    return tuple((p - box.xyz_min[a]) / ext[a] * (sizes[a] - 1.0)
                 for a, p in enumerate((px, py, pz)))


def _normalize_grad(gx, gy, gz):
    """Unit normal of an SDF gradient with the reference's two guards
    (`sdf_voxel.py:1196-1202`, `:1354-1359`)."""
    gn = torch.sqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-24)) + 1e-7
    hx, hy, hz = gx / gn, gy / gn, gz / gn
    hn = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz,
                                min=float(np.finfo(np.float32).eps)))
    return hx / hn, hy / hn, hz / hn


HEAD_ROW_MULTIPLE = 1024  # the sorted fine head's row count is a multiple


def _live_count(keys: torch.Tensor, r_sent: int):
    """The count of ``keys`` below the sentinel ``r_sent``, sent to the
    host without a wait: (count, event), the count a pinned host tensor
    that a non-blocking copy fills by the time the event completes (on
    the CPU the count itself and no event)."""
    live = torch.count_nonzero(keys < r_sent)
    if not live.is_cuda:
        return live, None
    host = torch.empty((), dtype=live.dtype, pin_memory=True)
    host.copy_(live, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _head_rows(count, m: int) -> Tuple[int, int]:
    """The live rows of ``_live_count`` (one host read, which waits for
    its copy) and the sorted fine head's row count: those rounded up to
    ``HEAD_ROW_MULTIPLE``, so that the caching allocator reuses the
    head's blocks from step to step, and at most the stream's length
    ``m``."""
    host, done = count
    if done is not None:
        done.synchronize()
    live = int(host)
    padded = -(-live // HEAD_ROW_MULTIPLE) * HEAD_ROW_MULTIPLE
    return live, min(padded, m)


def forward_fine_sorted(params, buffers, cfg: SDFModelConfig, box: SceneBox,
                        rays_o, rays_d, viewdirs, s_val, near: float,
                        bg: float) -> Dict[str, torch.Tensor]:
    """Fine render on the row-sorted channel-major stream, in two sorted
    passes (`sdf_voxel.py:1070-1409`).

    Pass 1 (the compacted lattice): one stable sort by grid row, the
    fused ``[sdf | grad | k0]`` serve (B1, backward B2), alpha and n.v in
    sorted order, then the ray-major scan.  Pass 2 (the top-``shade_k``
    selection per ray): a second serve for sdf and k0, the exact
    hierarchical taps (B5, backward B6) — z/y taps on the z-minor sort,
    x taps on an x-minor sort of the transposed grid — the finite
    differences, rgbnet -> refnet shading, and three rgb channels back to
    ray order for compositing.  With a TensoRF k0 (``grid_type='tensorf'``)
    both passes serve ``[sdf | grad]`` alone and the head's k0 is the
    factors' query at its rows (``core/grids.py:tensorf_rows``, from each
    row's lower corner ``b - 1`` and fractions, as ``rays_xyz2``): no
    dense k0 is made.

    The head shades the live prefix of the pass-2 stream alone: a dead
    slot's key is the sentinel ``r_sent``, which the stable sort puts
    last, and a live slot is always in the grid (pass 2 recomputes the
    pass-1 points, whose ``valid`` is stricter than ``ok``).  The count
    of keys below ``r_sent`` leaves for the host before the pass-2 sort
    (``_live_count``) and is read just before the head (``_head_rows``,
    the step's one wait), so the card has the sort, the serve and the
    taps queued when the host resumes; the head's
    inputs are cut to that count rounded up to ``HEAD_ROW_MULTIPLE``
    (at most ``m2``; the extra rows are dead sentinel rows, finite), and
    its output's live rows are padded with 0 back to ``m2``.  Dead
    slots of ``sel_rgb_ch`` so read 0, not the head's value at a
    sentinel row; every consumer multiplies them by a zero weight (the
    composite below, ``rgbper`` in ``train/losses.py``), so outputs and
    gradients are the full stream's up to float32 summation order.  With
    no live slot the head runs on zero rows and its leaves get zero
    gradients.  The returned ``head_rows`` is the rows it computed."""
    n = rays_o.shape[0]
    dist = cfg.step_dist
    sizes = cfg.world_size

    # ---- pass 1: lattice, mask cache (any stage), compaction ----------
    axes_at, steps0, (px, py, pz), valid = _lattice(cfg, box, rays_o, rays_d,
                                                    near)
    if "mask_cache" in buffers:
        valid = valid & mask_cache_query(buffers["mask_cache"],
                                         torch.stack([px, py, pz], dim=-1),
                                         cfg.mask_cache_thres)
    if 0 < cfg.sample_k < cfg.s_max:
        valid, steps, sample_overflow = _compact_valid(valid, cfg.sample_k)
        px, py, pz = axes_at(steps)
    else:
        steps = steps0
        sample_overflow = torch.zeros((n,), dtype=torch.bool,
                                      device=rays_o.device)
    s = valid.shape[-1]
    m = n * s

    # ---- field, channel-major; the gradient comes from the (possibly
    # smoothed) grid the taps sample -----------------------------------
    sdf_grid = params["sdf"]
    if cfg.smooth_sdf:
        sdf_grid = smooth_grid(sdf_grid, cfg.smooth_ksize, cfg.smooth_sigma)
    sdf3 = sdf_grid[..., 0]
    grad_cm = sdf_gradient_cm(sdf3, cfg.voxel_size, cfg.grad_mode)
    # a TensoRF k0 is queried at the head's rows below: no k0 channel is
    # densified or served
    factored = cfg.grid_type == "tensorf"
    field_cm = torch.cat([sdf3[None], grad_cm] + (
        [] if factored else [k0_dense(params, cfg).permute(3, 0, 1, 2)]),
        dim=0)

    rows, (fx, fy, fz), ok = rows_fracs_cm(*_index_coords(cfg, box, px, py, pz),
                                           sizes)
    r_sent = padded_rows_cm(sizes)
    keys = torch.where(valid & ok, rows, torch.full_like(rows, r_sent)).reshape(m)
    vds = [viewdirs[:, a:a + 1].expand(n, s).reshape(m) for a in range(3)]
    keys_s, iota_s, fx_s, fy_s, fz_s, vx_s, vy_s, vz_s = sort_stream(
        keys, fx.reshape(m), fy.reshape(m), fz.reshape(m), *vds,
        pack16=cfg.sort_pack16,
    )
    samp = pack_gather_sorted_cm(field_cm, keys_s,
                                 corner_weights_cm(fx_s, fy_s, fz_s))
    sdf_s = samp[0]
    gx, gy, gz = samp[1], samp[2], samp[3]
    true_cos = vx_s * gx + vy_s * gy + vz_s * gz
    alpha_s = neus_alpha_from_cos(true_cos, sdf_s, dist, s_val)
    nx, ny, nz = _normalize_grad(gx, gy, gz)
    ndv_s = -(nx * vx_s + ny * vy_s + nz * vz_s)
    unsorted = unsort_channels(iota_s, torch.stack([alpha_s, ndv_s]))
    alpha = unsorted[0].reshape(n, s)
    ndv = unsorted[1].reshape(n, s)

    # fine tail: alpha threshold -> one scan -> weight threshold
    if cfg.fast_color_thres > 0:
        m1 = valid & (alpha > cfg.fast_color_thres)
    else:
        m1 = valid
    weights, alphainv_last = alpha_to_weights(alpha, m1)
    if cfg.fast_color_thres > 0:
        live = m1 & (weights > cfg.fast_color_thres)
    else:
        live = m1
    w_eff = weights * live

    # ---- shade selection (ray-major) ----------------------------------
    if cfg.shade_k > 0:
        idx, sel_live = _topk_select(weights, live, cfg.shade_k)
        steps_sel = _gather_slots(steps, idx)
        s_weights = _gather_slots(weights, idx) * sel_live
        overflow = torch.sum(live, dim=-1) > cfg.shade_k
        k = cfg.shade_k
    else:
        steps_sel, sel_live, s_weights = steps, live, w_eff
        overflow = torch.zeros((n,), dtype=torch.bool, device=rays_o.device)
        k = s

    # ---- pass 2: exact taps + shading on the selection (plain f32 sort
    # payloads) ---------------------------------------------------------
    m2 = n * k
    qx, qy, qz = axes_at(steps_sel)
    ix2, iy2, iz2 = _index_coords(cfg, box, qx, qy, qz)
    rows2, (fx2, fy2, fz2), ok2 = rows_fracs_cm(ix2, iy2, iz2, sizes)
    keys2 = torch.where(sel_live & ok2, rows2,
                        torch.full_like(rows2, r_sent)).reshape(m2)
    live_count = _live_count(keys2, r_sent)
    vds2 = [viewdirs[:, a:a + 1].expand(n, k).reshape(m2) for a in range(3)]
    keys2_s, iota2_s, fx2_s, fy2_s, fz2_s, vx2_s, vy2_s, vz2_s = sort_stream(
        keys2, fx2.reshape(m2), fy2.reshape(m2), fz2.reshape(m2), *vds2,
        pack16=False)
    samp2 = pack_gather_sorted_cm(field_cm, keys2_s,
                                  corner_weights_cm(fx2_s, fy2_s, fz2_s))
    sdf2_s = samp2[0]
    k02_s = samp2[4:]

    b0, b1, b2 = rows_to_coords_cm(torch.clamp(keys2_s, max=r_sent - 1), sizes)
    displace = cfg.all_displace
    nd = len(displace)

    # z/y taps on the base sort; the tap weights are data
    mn_zy, mp_zy = tap_bounds(sizes)
    delta_zy, w8t_zy, _ = tap_deltas_weights(
        b0, b1, b2, fx2_s, fy2_s, fz2_s, displace, sizes, axes=("z", "y"))
    taps_zy = tap_gather_sorted_cm(sdf3, keys2_s, delta_zy, w8t_zy.detach(),
                                   mn_zy, mp_zy)  # [4 nd, M2]: z-, z+, y-, y+

    # x taps: x-minor linearization of the transposed grid
    sizes_t = (sizes[2], sizes[1], sizes[0])
    r_sent_x = padded_rows_cm(sizes_t)
    rows2x, (fz2x, fy2x, fx2x), okx = rows_fracs_cm(iz2, iy2, ix2, sizes_t)
    keys2x = torch.where(sel_live & okx, rows2x,
                         torch.full_like(rows2x, r_sent_x)).reshape(m2)
    keys2x_s, iota2x = torch.sort(keys2x, stable=True)
    fxx_s, fyx_s, fzx_s = torch.stack(
        [fx2x.reshape(m2), fy2x.reshape(m2), fz2x.reshape(m2)])[:, iota2x]
    bx0, bx1, bx2 = rows_to_coords_cm(torch.clamp(keys2x_s, max=r_sent_x - 1),
                                      sizes_t)
    delta_x, w8t_x, _ = tap_deltas_weights(
        bx0, bx1, bx2, fzx_s, fyx_s, fxx_s, displace, sizes_t, axes=("z",))
    taps_x_xs = tap_gather_sorted_cm(sdf3.permute(2, 1, 0), keys2x_s, delta_x,
                                     w8t_x.detach(), 4, 5)  # x-, x+ (x order)
    # x-sorted -> ray-major -> base (z-minor) sorted order
    taps_x = resort_channels(iota2_s, unsort_channels(iota2x, taps_x_xs))

    # hierarchical features: post-clamp tap distances, finite
    # differences; grad order (z, y, x), tap order (z-, z+, y-, y+, x-, x+)
    ic = (b2 - 1.0 + fz2_s, b1 - 1.0 + fy2_s, b0 - 1.0 + fx2_s)
    size = (sizes[2], sizes[1], sizes[0])
    all_feat_rows = list(taps_zy.unbind(0)) + list(taps_x.unbind(0))

    def tap_diff(a, di, d):
        hi = torch.clamp(ic[a] + d, 0.0, size[a] - 1.0)
        lo = torch.clamp(ic[a] - d, 0.0, size[a] - 1.0)
        dd = hi - lo
        dd = torch.where(dd > 0, dd, torch.ones_like(dd))
        neg = all_feat_rows[(2 * a) * nd + di]
        pos = all_feat_rows[(2 * a + 1) * nd + di]
        return (pos - neg) / dd / cfg.voxel_size

    grad_rows = [tap_diff(a, di, d) for a in range(3)
                 for di, d in enumerate(displace)]
    if cfg.use_grad_norm:
        normed = []
        for di in range(nd):
            g3 = [grad_rows[a * nd + di] for a in range(3)]
            norm = torch.sqrt(torch.clamp(
                g3[0] * g3[0] + g3[1] * g3[1] + g3[2] * g3[2], min=1e-24))
            normed.extend([g / (norm + 1e-5) for g in g3])
        grad_rows = [normed[di * 3 + a] for a in range(3) for di in range(nd)]

    # center gradient (displacement 1.0, no grad norm), xyz order: the
    # `gradient` feature and the reflection normal
    d1 = displace.index(1.0)
    gcz, gcy, gcx = (tap_diff(a, d1, 1.0) for a in range(3))
    normal2 = _normalize_grad(gcx, gcy, gcz)
    rays_xyz2 = (
        (b0 - 1.0 + fx2_s) / (sizes[0] - 1.0),
        (b1 - 1.0 + fy2_s) / (sizes[1] - 1.0),
        (b2 - 1.0 + fz2_s) / (sizes[2] - 1.0),
    )

    with profiling.span("head_count"):
        n_live, n_head = _head_rows(live_count, m2)

    def prefix(rows):  # the head's rows: the stream's live prefix
        return [r[..., :n_head] for r in rows]

    if factored:  # k0 at the head's rows, from their lower corners
        k02_h = tensorf_rows(
            params["k0"], torch.stack(prefix((b0, b1, b2))).long() - 1,
            torch.stack(prefix((fx2_s, fy2_s, fz2_s))), cfg.k0_dim)
    else:
        k02_h = k02_s[:, :n_head]
    head_in = (prefix(rays_xyz2), prefix((vx2_s, vy2_s, vz2_s)),
               prefix(normal2), sdf2_s[:n_head], k02_h,
               prefix(all_feat_rows), prefix(grad_rows),
               prefix((gcx, gcy, gcz)))
    with profiling.span("shade"):
        rgb_h = _shade_fine_cm(params, cfg, *head_in)
    rgb_s3 = F.pad(rgb_h[:, :n_live], (0, m2 - n_live))
    rgb_u = unsort_channels(iota2_s, rgb_s3)
    rgb_ch = tuple(rgb_u[a].reshape(n, k) for a in range(3))

    cum_w = torch.sum(w_eff, dim=-1)
    comp, comp_sig = [], []
    for ch in rgb_ch:
        comp.append(torch.clamp(
            torch.sum(s_weights * ch, dim=-1) + (1.0 - cum_w) * bg, 0.0, 1.0))
        comp_sig.append(torch.clamp(
            torch.sum(s_weights * torch.sigmoid(ch), dim=-1)
            + (1.0 - cum_w) * bg, 0.0, 1.0))
    depth = torch.sum(w_eff * steps * dist, dim=-1).detach()
    return {
        "rgb_marched": torch.stack(comp, dim=-1),
        "sigmoid_rgb": torch.stack(comp_sig, dim=-1),
        "alphainv_cum": alphainv_last,
        "cum_weights": cum_w[..., None],
        "depth": depth,
        "disp": 1.0 / torch.clamp(depth, min=1e-10),
        "weights": w_eff,
        "ndv": ndv,
        "live": live,
        "valid": valid,
        "sel_weights": s_weights,
        "sel_rgb_ch": rgb_ch,
        "sel_live": sel_live,
        "overflow": overflow | sample_overflow,
        "overflow_sample": sample_overflow,
        "overflow_shade": overflow,
        "s_val": s_val,
        "head_rows": n_head,
    }


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
    axes_at, steps0, (px, py, pz), valid = _lattice(cfg, box, rays_o, rays_d,
                                                    near)

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
    rows, (fx, fy, fz), ok = rows_fracs_cm(*_index_coords(cfg, box, px, py, pz),
                                           sizes)
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
    nx, ny, nz = _normalize_grad(gx, gy, gz)
    ndv_s = -(nx * vx_s + ny * vy_s + nz * vz_s)

    b0, b1, b2 = rows_to_coords_cm(torch.clamp(keys_s, max=r_sent - 1), sizes)
    rays_xyz_s = (
        (b0 - 1.0 + fx_s) / (sizes[0] - 1.0),
        (b1 - 1.0 + fy_s) / (sizes[1] - 1.0),
        (b2 - 1.0 + fz_s) / (sizes[2] - 1.0),
    )
    rgb_s = _remat(cfg, lambda *a: _shade_coarse_cm(params, cfg, *a),
                   rays_xyz_s, (vx_s, vy_s, vz_s), (nx, ny, nz), k0_s)

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
