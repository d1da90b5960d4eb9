"""The masked Adam kernel (``fgs_nerf_tpu_torch/csrc/masked_adam.cu``):
one pass a leaf that reads p, g, m and v and writes p, m and v, 28 B an
element.  The bound counts the grid leaves whose sizes the cell's
configuration fixes: the SDF grid, and the dense k0 at ``k0_dim``
channels or, with ``grid_type='tensorf'``, the factor planes and
vectors (the served field's count of a factored cell has ``k0_dim`` 0,
so the [3R, k0_dim] basis is left out).  The heads' leaves and a
per-voxel learning rate are left out too, so the share can only read
low.  The evaluation cell runs no Adam: its count names the lattice
engine, on which no cell trains."""
from typing import Dict, Optional

from benchmark.counts import PEAKS

FRAGMENTS = ("masked_adam_step",)
BYTES_PER_ELEM = 28  # p, g, m, v read; p, m, v written; float32


def grid_elems(model: Dict, world_size) -> int:
    x, y, z = (int(v) for v in world_size)
    n = x * y * z  # the SDF grid
    if model.get("grid_type") == "tensorf":
        r = int(model["tensorf_n_comp"])
        return n + r * (x * y + x * z + y * z + x + y + z)
    return n * (1 + int(model.get("k0_dim", 12)))


def bound_s(cell: Dict) -> Optional[float]:
    if cell["engine"] == "lattice":
        return None
    return (BYTES_PER_ELEM * grid_elems(cell["model"], cell["world_size"])
            / PEAKS["hbm_bytes_per_s"])
