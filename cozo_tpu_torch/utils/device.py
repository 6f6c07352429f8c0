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


def quantize_i8(x: torch.Tensor, reciprocal: bool = False):
    """Per-row max-abs int8 quantisation of x [..., d] f32: returns
    (int8 [..., d], scale f32 [...]) with scale = max|x| / 127 (1 on an
    all-zero row) and values clip(round(x / scale)) (half to even, as
    numpy's rint and jnp.round).

    `reciprocal`: the scale as max|x| * (1/127), which is what the JAX
    package's jitted functions compute (XLA rewrites a division by a
    constant into a multiplication by its reciprocal; the two differ in
    the last bit on some 5% of rows), where its numpy host code divides.
    Each caller takes the form of the function it is the counterpart of,
    so tables and scales are bit-equal to the JAX package's."""
    mx = x.abs().amax(dim=-1)
    scale = mx * (1.0 / 127.0) if reciprocal else mx / 127.0
    scale = torch.where(mx > 0, scale, torch.ones_like(mx))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def prepare_queries(q: torch.Tensor, metric: str, d_pad: int,
                    half: bool = False, quantize: bool = False,
                    reciprocal: bool = False):
    """Query preparation on the device, for every serving lane: takes the
    f32 queries [B, d] as uploaded and gives what the lane scores.

      - Cosine: row normalise (`q / ||q||` in f32; a zero row stays zero);
      - `half`: round to f16 and back, the precision at which the JAX
        package uploads the queries of its bf16, fused and int8 lanes.
        For L2/IP a batch whose largest magnitude is not below 6.0e4 (or
        is not finite) would overflow f16 and stays f32; the choice is
        made on the device, with no host round trip;
      - zero-pad the rows to `d_pad`;
      - `quantize`: the per-query max-abs scale and int8 values of the
        int8 lanes (`reciprocal` as in `quantize_i8`).

    Returns the padded f32 queries, or (f32, int8, scale) with
    `quantize`."""
    q = q.float()
    if metric == "Cosine":
        nrm = torch.linalg.vector_norm(q, dim=1, keepdim=True)
        q = q / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    if half:
        rounded = q.to(torch.float16).float()
        if metric == "Cosine":
            q = rounded
        elif q.numel():
            q = torch.where(q.abs().max() < 6.0e4, rounded, q)
    if q.shape[1] < d_pad:
        q = torch.nn.functional.pad(q, (0, d_pad - q.shape[1]))
    if not quantize:
        return q
    q_i8, scale = quantize_i8(q, reciprocal)
    return q, q_i8, scale


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [N, K]^T int8 -> [M, N] int32, exact.  On the
    card the int8 tensor-core product (`torch._int_mm`, which wants more
    than 16 rows and K, N multiples of 8: a smaller batch is padded with
    zero rows); on the CPU an int32 matmul.  int32 sums are exact either
    way, so both give the same bits."""
    if a.device.type != "cuda":
        return a.to(torch.int32) @ b.to(torch.int32).T
    M = a.shape[0]
    if M <= 16:
        a = torch.nn.functional.pad(a, (0, 0, 0, 32 - M))
    return torch._int_mm(a, b.T)[:M]


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

