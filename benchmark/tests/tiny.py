"""Tiny versions of the benchmark's configurations for CPU tests: the
same stages, engines and schedules at a few voxels, views and rays."""
from __future__ import annotations

import copy
from typing import Dict

from benchmark import scene
from benchmark.spec import Spec


def tiny_config(name: str, device="cpu") -> Dict:
    cfg = copy.deepcopy(Spec().config(name))
    sc = cfg["scene"]
    sc["hw"] = [24, 32]
    if sc["cameras"] == "ring":
        sc["n_train"], sc["n_test"] = 6, 2
    else:
        sc["n_views"], sc["test_ids"], sc["K_full"] = 9, [4], [
            [2892.33 / 50, 0.0, 823.20 / 50], [0.0, 2883.18 / 50, 619.07 / 50],
            [0.0, 0.0, 1.0]]
    cfg["geometry_searching_model"]["num_voxels"] = 20 ** 3
    for st, nv in (("coarse", 18 ** 3), ("fine", 22 ** 3)):
        cfg[f"{st}_model"].update(num_voxels=nv, num_voxels_base=nv, shade_k=16,
                                  sample_k=48)
        cfg[f"{st}_train"]["N_rand"] = 128
    for st in ("coarse", "fine"):
        cfg[f"{st}_model"]["refnet_width"] = 16
        cfg[f"{st}_model"]["rgbnet_width"] = 16
    cams = scene.cameras(sc, "train")
    mask, gmin, gmax = scene.geometry_sdf_mask(cfg, cams, device)
    shr = scene.bbox_from_sdf_mask(mask, gmin, gmax)
    cfg["box_stated"] = {st: [list(map(float, b)) for b in scene.stage_box(cfg, st, shr)]
                         for st in ("coarse", "fine")}
    return cfg


def tiny_traffic(name: str) -> Dict:
    t = copy.deepcopy(Spec().traffic(name))
    return t


def tiny_cell(config: str, traffic: str, seed: int = 7):
    """A tiny cell of the driver the traffic names, on the CPU."""
    import importlib

    cfg, tr = tiny_config(config), tiny_traffic(traffic)
    if tr["kind"] == "eval":
        tr.update(check_pixels=256, ground_truth_views=2)
    driver = importlib.import_module(f"benchmark.drivers.{tr['kind']}")
    return driver, driver.Cell(cfg, tr, seed, "cpu")
