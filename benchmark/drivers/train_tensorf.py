"""Training traffic of a stage whose k0 is a TensoRF vector-matrix
factorization (``grid_type='tensorf'``): the closed loop of ``train``,
with the factors drawn by the benchmark from the seed, the reference
that densifies them (``reference/tensorf.py``) and the counts of the
field the program serves, ``[sdf | grad]`` alone (its k0 is queried at
the head's rows, not served).

The comparison adds the factors' own gaps: their gradients are some
1e-5 of the median leaf's, so ``train.compare`` leaves them out as
round-off; ``k0_grad_gap`` and ``k0_change_gap`` hold each factor leaf's
first-gradient norm and change norm against the reference's norm of
that leaf.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import counts, scene
from benchmark.drivers import train
from benchmark.drivers.train import _cuda, reference_readings, setup, window
from benchmark.reference import tensorf as RT

FACTOR_SEED = 0x7E450F  # the factors' generator: the seed plus this


def factors(world_size, n_comp: int, channels: int, std: float, seed: int,
            device) -> Dict[str, torch.Tensor]:
    """Planes and vectors from N(0, std), the basis [3R, C] from
    U(-1/sqrt(3R), 1/sqrt(3R)) (kaiming-uniform with a = sqrt(5)), in the
    program's names and layouts."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + FACTOR_SEED)
    x, y, z = (int(v) for v in world_size)
    shapes = {"xy_plane": (x, y, n_comp), "xz_plane": (x, z, n_comp),
              "yz_plane": (y, z, n_comp), "x_vec": (x, n_comp),
              "y_vec": (y, n_comp), "z_vec": (z, n_comp)}
    out = {k: std * torch.randn(s, generator=gen, device=device)
           for k, s in shapes.items()}
    bound = 1.0 / math.sqrt(3 * n_comp)
    out["f_vec"] = (torch.rand((3 * n_comp, channels), generator=gen,
                               device=device) * 2.0 - 1.0) * bound
    return out


class Cell(train.Cell):
    """A training cell with a factored k0."""

    def state(self) -> Dict:
        st = self.cfg["state"]
        gen = torch.Generator(device=self.dev).manual_seed(int(self.seed))
        nodes = scene.grid_nodes(self.ws, *self.box, self.dev)
        sdf = scene.sphere_sdf(nodes) * st["sdf_scale"]
        del nodes
        sdf = sdf + st["sdf_noise"] * torch.randn(sdf.shape, generator=gen,
                                                  device=self.dev)
        params = {"sdf": sdf,
                  "k0": factors(self.ws, int(self.model["tensorf_n_comp"]),
                                int(self.model.get("k0_dim", 12)),
                                st["tensorf_std"], self.seed, self.dev)}
        for name, d in self.dims.items():
            params[name] = scene.mlp_weights(gen, d, self.dev)
        params["s_val"] = torch.full((1,), self.model.get("s_start", 0.05),
                                     dtype=torch.float32, device=self.dev)
        return params

    def count_cell(self) -> Dict:
        """The served field's channels: ``[sdf | grad]``, no k0."""
        return dict(super().count_cell(), model=dict(self.model, k0_dim=0))

    def reference_stage(self, control: bool = False) -> RT.Stage:
        return RT.Stage(self.cfg, self.stage, self.box, self.ws, self.voxel,
                        self.geo_mask, self.geo_box, self.cams["near"], self.bg,
                        control=control)


def compare(check: Dict, ref) -> Dict[str, float]:
    """``train.compare``'s numbers, and by the worst k0 factor leaf the
    gap of its first gradient's norm and of its change, each over the
    reference's norm of the same leaf."""
    out = train.compare(check, ref)
    _, grad, change = ref
    k0 = [k for k in grad if k.startswith("k0.")]
    out["k0_grad_gap"] = max(abs(check["grad"][k] - grad[k]) / grad[k]
                             for k in k0)
    out["k0_change_gap"] = max(abs(check["change"][k] - change[k]) / change[k]
                               for k in k0)
    return out


def run(cell: Cell, seconds: float, trace_seconds: float = 0.0,
        fault=None, on_setup_done=None) -> Dict:
    """``train.run`` with this module's comparison."""
    prog, check = setup(cell, fault)
    setup_peak = torch.cuda.max_memory_allocated(cell.dev) if _cuda(cell) else 0
    if on_setup_done is not None:
        on_setup_done()
    rec = {"e2e": window(prog, seconds, False)}
    if trace_seconds:
        rec["traced"] = window(prog, trace_seconds, True)
    rec["peak"] = max([setup_peak] + [w["peak"] for w in rec.values()])
    rec["n_pixels"], rec["n_kept"] = prog.n_pixels, len(prog.rays[0])
    del prog
    if _cuda(cell):
        torch.cuda.empty_cache()
    rec["readings"] = compare(check, reference_readings(cell, check))
    rec["bounds"] = counts.kernel_bounds(cell.count_cell())
    rec["head_flops_per_row"] = counts.head_row_flops(
        cell.model, cell.stage == "fine", True)
    return rec
