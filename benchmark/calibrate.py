"""Readings that set a cell's limits, for a list of seeds in one process:
the program's compared numbers (set-up's check steps against the plain
reference, no window) and, with ``--control``, the control's (the
reference computed with a bf16 field in the program's place).  One JSON
line a seed.

    python -m benchmark.calibrate --workload <cell> --seeds 1 2 3 [--control]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import harness
from benchmark.spec import Spec


def readings(workload: str, seeds, control: bool, fault=None,
             device="cuda:0", spec=None, cfg=None, traffic=None):
    spec = spec or Spec()
    wl = spec.workload(workload)
    cfg = cfg or spec.config(wl["config"])
    traffic = traffic or spec.traffic(wl["traffic"])
    from benchmark.drivers import train as D

    if traffic["kind"] == "eval":
        from benchmark.drivers import eval as E

        for seed in seeds:
            rec = E.run(E.Cell(cfg, traffic, seed, device), 0.0,
                        fault=fault, control=control)
            yield {"seed": seed, "fault": fault, "program": rec["readings"],
                   "control": rec["control_gap"]}
        return
    for seed in seeds:
        cell = D.Cell(cfg, traffic, seed, device)
        prog, check = D.setup(cell, fault)
        del prog
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        ref = D.reference_readings(cell, check)
        row = {"seed": seed, "fault": fault, "program": D.compare(check, ref),
               "detail": D.detail(check, ref)}
        if control:
            ctl = D.reference_readings(cell, check, control=True)
            c = dict(losses=ctl[0], grad=ctl[1], change=ctl[2])
            row["control"] = D.compare(c, ref)
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("half_batch", "unchanged", "chunk"),
                    help="plant a fault in the program's step")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.build_kernels()
    for row in readings(args.workload, args.seeds, args.control, args.fault):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
