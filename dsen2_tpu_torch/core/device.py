"""Device choice and the TF32 scope.

Entry points run on "cuda" unless the caller passes another device; with no
GPU and no explicit device they raise rather than drift onto the CPU.

cuDNN runs float32 convolutions in TF32 by default, which keeps about three
decimal digits and belongs to none of the port's accuracy classes. TF32 stays
out of every class except as an exact carrier of bf16 operands: a bf16 value
(8 significant bits, 8-bit exponent) is exactly a TF32 value, and the product
of two is exact in f32, so a TF32 conv of bf16-valued f32 planes computes the
bf16 products with f32 sums. Plane convs run inside
`tf32_for_bf16_operands()`; every other conv and matmul the port owns runs
inside `tf32_disabled()`. Both restore the flags they found; nothing is
flipped at import. The flags are process-wide and mesh shards dispatch
convs from several host threads, so a scope holds a lock while it is open:
no other thread's scope changes the flags under it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "tf32_disabled", "tf32_for_bf16_operands", "upload"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `device` when given, else "cuda",
    which must then be available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return torch.device("cuda")


# Held by the thread whose TF32 scope is open; re-entrant, as scopes nest.
_tf32_lock = threading.RLock()


@contextlib.contextmanager
def _tf32(on: bool) -> Iterator[None]:
    with _tf32_lock:
        conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = on
        torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = conv
            torch.backends.cuda.matmul.allow_tf32 = mm


def tf32_disabled():
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls inside the
    block, then restore both flags as they were."""
    return _tf32(False)


def tf32_for_bf16_operands():
    """Turn TF32 on inside the block, then restore both flags as they were.
    Only for convs and matmuls whose every operand holds bf16 values (planes
    from ops/resblock_chain.py::split_planes): there TF32 rounds nothing."""
    return _tf32(True)


def upload(a: np.ndarray, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Host array `a` as a tensor on `device` (cast to `dtype` on the host
    when given). On CUDA the copy is queued from pinned memory on the current
    stream and the host does not wait for it; torch's pinned-memory cache
    hands the staging block out again only after that copy has completed."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
