"""Process mesh and the collectives of the port's parallel plan.

Port of ``fgs_nerf_tpu/parallel/mesh.py``.  The JAX package is one
controller over a device ``Mesh``; the port runs one process per rank
(the ``torchrun`` model).  A :class:`Mesh` holds the axis sizes ``dp``
(ray shards) and ``sp`` (x-slabs of the voxel grids, see
``parallel/spatial.py``), this rank's place on both axes, one process
group per axis and the rank's device.  Rank order is dp-major:
``rank = dp_index * sp + sp_index``.

Every rank draws the same global ray batch from the numpy seed and keeps
its contiguous dp rows (:func:`shard_batch`); rays never interact, so
the forward on the shard is the global forward restricted to it, and
the gradient of the global batch is the mean over dp of the ranks'
gradients (:func:`dp_mean`, one flattened ``all_reduce``).

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo runs
them on CPU tensors and on CUDA tensors alike, so the same code runs
under gloo on the CPU (the tests), under gloo with two ranks sharing one
card (NCCL refuses two ranks on one device) and under NCCL with a card
per rank.  The backend is an explicit choice (``--dist_backend``).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) grid of ranks seen from one rank."""

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    dp_group: Any  # process group over the ranks of this sp_index
    sp_group: Any  # process group over the ranks of this dp_index
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def rank(self) -> int:
        return self.dp_index * self.sp + self.sp_index


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device: Optional[str] = None) -> torch.device:
    """The rank's device: ``device`` when given, else ``cuda:LOCAL_RANK``
    under a launcher (``cuda`` alone). Raises when ``LOCAL_RANK`` names no
    card; ``--device cuda:0`` puts every local rank on the first card."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device not in (None, "cuda"):
        return torch.device(device)
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(
            f"LOCAL_RANK {local} has no card of its own ({n} visible); pass "
            "--device cuda:0 (with --dist_backend gloo) to share one card")
    return torch.device(f"cuda:{local}")


def maybe_distributed_init(backend: Optional[str] = None, device=None,
                           timeout_s: float = 600.0) -> bool:
    """Join the process group that ``torchrun``'s environment describes.

    Returns False (and does nothing) when none of ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` is set: one process.
    Raises ``ValueError`` when only some are set, or when NCCL would put
    two ranks on one device (it cannot), before any rendezvous.  With no
    ``device`` the rank's card (:func:`rank_device`) decides the backend.
    The ``timeout_s`` bounds every collective, so a lost rank fails the
    others instead of hanging them."""
    if dist.is_initialized():
        return True
    present = [k for k in ENV_KEYS if k in os.environ]
    if not present:
        return False
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise ValueError(
            f"{', '.join(present)} set but {', '.join(missing)} missing: "
            "a distributed run needs all of " + ", ".join(ENV_KEYS))
    dev = torch.device(device) if device is not None else rank_device()
    backend = backend or default_backend(dev)
    if backend == "nccl":
        local = int(os.environ["LOCAL_RANK"])
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ["WORLD_SIZE"]))
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device per rank")
        idx = local if dev.index is None else dev.index
        if n_local > 1 and idx != local:
            raise ValueError(
                f"nccl cannot run two ranks on one device ({dev} for local "
                f"rank {local} of {n_local}); use --dist_backend gloo")
    dist.init_process_group(
        backend=backend, init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _parse(spec: str):
    sizes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if not size.strip().isdigit() or name not in ("dp", "sp"):
            raise ValueError(f"bad mesh spec part {part!r}; want dp=N or sp=M")
        sizes[name] = int(size)
    return sizes.get("dp", 1), sizes.get("sp", 1)


def build_mesh(spec: str, device=None) -> Optional[Mesh]:
    """Resolve a CLI mesh request (`mesh.py:63-100`).

    ``'none'`` / ``'1'`` / ``''`` -> None, in one process only;
    ``'auto'`` -> None in one process, else dp over every rank;
    ``'dp=N[,sp=M]'`` -> that grid, whose size must equal the world size
    (``ValueError`` otherwise), on ``device`` or else the rank's card
    (:func:`rank_device`).  Every rank must call it, in the same order: it
    makes the groups."""
    n = world_size()
    if spec in ("none", "1", ""):
        if n > 1:
            raise ValueError(f"no mesh in a world of {n} ranks: each would "
                             "train alone; use auto or dp=N[,sp=M]")
        return None
    if spec == "auto":
        if n == 1:
            return None
        dp, sp = n, 1
    else:
        dp, sp = _parse(spec)
        if dp * sp != n:
            raise ValueError(f"mesh spec {spec!r} needs {dp * sp} ranks, "
                             f"the world has {n}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp_group = sp_group = None
    if dist.is_initialized():
        # every rank makes every group, in one order
        for s in range(sp):
            g = dist.new_group([j * sp + s for j in range(dp)])
            if s == rank % sp:
                dp_group = g
        for j in range(dp):
            g = dist.new_group([j * sp + s for s in range(sp)])
            if j == rank // sp:
                sp_group = g
    dev = torch.device(device) if device is not None else rank_device()
    return Mesh(dp=dp, sp=sp, dp_index=rank // sp, sp_index=rank % sp,
                dp_group=dp_group, sp_group=sp_group, device=dev)


def local_rows(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's contiguous dp row range of an ``n``-row batch
    (`mesh.py:_local_rows`)."""
    if mesh is None:
        return slice(0, n)
    if n % mesh.dp:
        raise ValueError(f"batch of {n} rows does not split over dp={mesh.dp}")
    k = n // mesh.dp
    return slice(mesh.dp_index * k, (mesh.dp_index + 1) * k)


def shard_batch(mesh: Optional[Mesh], *arrays):
    """Each array's (numpy or torch) dp rows for this rank
    (`mesh.py:shard_batch`): every rank holds the same global batch."""
    if mesh is None:
        return tuple(arrays)
    return tuple(a[local_rows(mesh, len(a))] for a in arrays)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no-op without one)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _flat(leaves):
    return torch.cat([x.reshape(-1) for x in leaves])


def _unflat(flat, leaves):
    out, k = [], 0
    for x in leaves:
        out.append(flat[k:k + x.numel()].view_as(x))
        k += x.numel()
    return out


def dp_mean(mesh: Optional[Mesh], leaves, extra: Optional[torch.Tensor] = None):
    """Mean over dp of ``leaves`` (same-dtype tensors) and of the vector
    ``extra``: one flattened ``all_reduce`` over the dp group, then a
    division by dp.  Returns (leaves, extra)."""
    leaves = list(leaves)
    if mesh is None:
        return leaves, extra
    parts = leaves + ([extra] if extra is not None else [])
    flat = all_reduce_sum(_flat(parts), mesh.dp_group) / mesh.dp
    out = _unflat(flat, parts)
    return (out[:len(leaves)], out[len(leaves)] if extra is not None
            else None)


def barrier(mesh: Optional[Mesh] = None) -> None:
    if dist.is_initialized():
        dist.barrier()


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Rank 0 writes files and logs; a single process always does."""
    return mesh is None or mesh.rank == 0


def check_replicas(mesh: Optional[Mesh], tree, what: str = "params") -> None:
    """Assert that every rank holds bit-equal copies of the replicated
    ``tree`` (a dict of tensors): rank 0's copy is broadcast and
    compared.  Raises on the ranks whose copy differs."""
    if mesh is None or not dist.is_initialized():
        return
    from fgs_nerf_tpu_torch.optim.masked_adam import tree_leaves

    leaves = [x.detach() for x in tree_leaves(tree)]
    bits = _flat([x.reshape(-1).view(torch.int32) if x.dtype == torch.float32
                  else x.reshape(-1).to(torch.int32) for x in leaves])
    ref = bits.clone()
    dist.broadcast(ref, src=0)
    n_bad = int((ref != bits).sum())
    if n_bad:
        raise RuntimeError(f"rank {mesh.rank}: {what} differ from rank 0's "
                           f"in {n_bad} of {bits.numel()} values")

