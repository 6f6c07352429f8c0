"""Device resolution for the PyTorch port (counterpart of
`cozo_tpu/utils/jax_setup.py`).

Entry points run on `cuda` unless the caller asks for the CPU; with no
card and no explicit device they raise instead of carrying on on the
host.  Resolving a device also pins float32 matrix products to full
float32: the f32 lane and the exact re-rank are "HIGHEST" precision in
the JAX package, and TF32 (about three decimal digits) would silently
break both.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def default_device(device: DeviceLike = None) -> torch.device:
    """`device` as a `torch.device`; `None` means the card.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no card is visible."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cozo_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run the plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"cozo_tpu_torch: unsupported device {dev}")
    return dev


def to_device(arr, device: torch.device) -> torch.Tensor:
    """numpy array -> tensor on `device`.  On the card the copy goes
    through pinned memory without blocking the host, so a host→device
    upload does not wait for kernels already queued on the stream."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, d] @ b [N, d]^T with both rounded to bf16, f32 result
    (JAX: bf16 dot_general with preferred_element_type=f32).  On the card
    cuBLAS multiplies the bf16 operands and writes f32; on the CPU the
    rounded operands are multiplied in f32, which is the same arithmetic
    up to summation order."""
    a16 = a.to(torch.bfloat16)
    b16 = b.to(torch.bfloat16)
    if a.device.type == "cuda":
        return torch.mm(a16, b16.T, out_dtype=torch.float32)
    return a16.float() @ b16.float().T


class PendingPull:
    """A device→host copy of `t` started without waiting for work queued
    after it, so the host can read it while the device runs on;
    `numpy()` waits for this copy alone."""

    def __init__(self, t: torch.Tensor) -> None:
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

