"""Default device and float32 numerics for the port.

Entry points take an explicit ``device``; ``None`` means the CUDA card,
and asking for it without one raises (no silent fall back to the CPU).
Callers that want the CPU (the parity tests) pass ``device="cpu"``.

TF32 stays off for matmuls and convolutions: the reference numerics are
float32 (the JAX package's CPU path), and TF32 keeps ~3 decimal digits.
bf16 products (``mlp_bf16``) keep float32 sums: cuBLAS may not reduce
them in bf16.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def set_f32_numerics() -> None:
    """Full-precision float32 matmuls and convolutions on the card, and
    float32 sums in bf16 matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is missing and the caller
    did not ask for the CPU."""
    set_f32_numerics()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch paths on the CPU"
        )
    return dev


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Host data (numpy array or Python number) -> a tensor on ``device``.

    To the card the copy goes through pinned memory without blocking, so
    a step loop that feeds per-step host values (batch indices, learning
    rates, schedule scalars) does not wait for the work already queued;
    a plain ``torch.tensor(x, device='cuda')`` would synchronise."""
    t = torch.as_tensor(np.asarray(a), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
