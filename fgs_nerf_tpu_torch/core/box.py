"""Scene bounding box + voxel-grid geometry helpers.

Port of ``fgs_nerf_tpu/core/box.py:1-89``: the voxel size is
``(volume / num_voxels)**(1/3)`` and the per-axis resolution is
``floor(extent / voxel_size)``, both in float32 as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from fgs_nerf_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SceneBox:
    """Axis-aligned world-space bounding box (float32 ``[3]`` tensors)."""

    xyz_min: torch.Tensor
    xyz_max: torch.Tensor

    @property
    def extent(self) -> torch.Tensor:
        return self.xyz_max - self.xyz_min

    def normalize(self, xyz: torch.Tensor) -> torch.Tensor:
        """World coords -> [0, 1]^3 (`core/box.py:42-44`)."""
        return (xyz - self.xyz_min) / (self.xyz_max - self.xyz_min)

    @staticmethod
    def create(xyz_min, xyz_max, device: DeviceLike = None) -> "SceneBox":
        dev = resolve_device(device)
        return SceneBox(
            torch.as_tensor(np.asarray(xyz_min, np.float32), device=dev),
            torch.as_tensor(np.asarray(xyz_max, np.float32), device=dev),
        )


def grid_resolution(
    xyz_min: np.ndarray, xyz_max: np.ndarray, num_voxels: int
) -> Tuple[Tuple[int, int, int], float]:
    """Voxel size and integer world resolution (`core/box.py:58-74`);
    float32 arithmetic on purpose (the truncation depends on it)."""
    ext = (np.asarray(xyz_max, np.float32) - np.asarray(xyz_min, np.float32))
    voxel_size = np.power(
        ext.prod() / np.float32(num_voxels), np.float32(1.0 / 3.0),
        dtype=np.float32,
    )
    world_size = tuple(int(v) for v in (ext / voxel_size).astype(np.int64))
    return world_size, float(voxel_size)


def max_samples_per_ray(world_size: Tuple[int, int, int], stepsize: float) -> int:
    """Static bound on samples along any ray (`core/box.py:77-89`):
    ``ceil(|world_size| / stepsize) + 1`` rounded up to a multiple of 8."""
    diag = float(np.linalg.norm(np.asarray(world_size, np.float64)))
    s_max = int(np.ceil(diag / stepsize)) + 1
    return ((s_max + 7) // 8) * 8
