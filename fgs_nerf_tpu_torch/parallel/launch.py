"""Start ``n`` local ranks as subprocesses with ``torchrun``'s environment.

``launch_local(n, target, ...)`` runs ``target`` (``"package.module:fn"``
or ``"path/to/file.py:fn"``) in ``n`` fresh processes that share one
process group (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  Each rank calls
``fn(device=device, **kwargs)`` after joining the group and returns a flat dict of
numpy arrays or numbers, which comes back to the caller as one dict per
rank.  The ranks run on the cards (``device="cuda"``: a card a rank, NCCL)
unless the caller names another device (``"cuda:0"``: every rank on the
first card, gloo; ``"cpu"``: gloo, one thread a rank).  A rank that exits
nonzero, or a run past ``timeout`` seconds, kills every rank and raises.

    results = launch_local(2, "fgs_nerf_tpu_torch.parallel.dryrun:_dryrun_rank",
                           timeout=120)
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _load_target(target: str):
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem, where)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, name)


def launch_local(n: int, target: str, *, device: str = "cuda",
                 timeout: float = 120.0,
                 kwargs: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
    """Run ``target`` on ``n`` local ranks; returns each rank's result."""
    backend = "nccl" if device == "cuda" else "gloo"
    out_dir = Path(tempfile.mkdtemp(prefix="fgs_ranks_"))
    base = dict(os.environ)
    base.update(
        WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
        FGS_RANK_TARGET=target, FGS_RANK_BACKEND=backend,
        FGS_RANK_DEVICE=device, FGS_RANK_OUT=str(out_dir),
        FGS_RANK_KWARGS=json.dumps(kwargs or {}),
        FGS_RANK_TIMEOUT=str(timeout),
        PYTHONPATH=os.pathsep.join(
            [str(REPO)] + [p for p in [base.get("PYTHONPATH")] if p]))
    if device == "cpu":
        base.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for r in range(n):
        e = dict(base, RANK=str(r), LOCAL_RANK=str(r))
        log = open(out_dir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "fgs_nerf_tpu_torch.parallel.launch"],
            env=e, stdout=log, stderr=subprocess.STDOUT, cwd=str(REPO)), log))
    t_end = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > t_end:
                failed = f"timed out after {timeout:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    try:
        if failed:
            tails = "\n".join(
                f"--- rank {r} ---\n"
                + (out_dir / f"rank{r}.log").read_text()[-3000:]
                for r in range(n))
            raise RuntimeError(
                f"launch_local({n}, {target}): {failed}\n{tails}")
        results = []
        for r in range(n):
            with np.load(out_dir / f"rank{r}.npz", allow_pickle=False) as z:
                results.append({k: z[k] for k in z.files})
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _rank_main() -> None:
    import torch
    import torch.distributed as dist

    from fgs_nerf_tpu_torch.parallel.mesh import maybe_distributed_init

    device = os.environ["FGS_RANK_DEVICE"]
    if device == "cpu":
        torch.set_num_threads(1)
    maybe_distributed_init(os.environ["FGS_RANK_BACKEND"], device,
                           timeout_s=float(os.environ["FGS_RANK_TIMEOUT"]))
    fn = _load_target(os.environ["FGS_RANK_TARGET"])
    out = fn(device=device, **json.loads(os.environ["FGS_RANK_KWARGS"])) or {}
    rank = dist.get_rank()
    dist.barrier()
    dist.destroy_process_group()
    np.savez(Path(os.environ["FGS_RANK_OUT"]) / f"rank{rank}.npz",
             **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    _rank_main()
