"""Fused scoring + segment-top-2 sweep (counterpart of
`cozo_tpu/ops/pallas_sweep.py`), the `compute_dtype="fused"` serving lane.

The kernel is `csrc/fused_sweep.cu`, hand-written CUDA for Hopper
(sm_90a: TMA loads, `wgmma` products, the top-2 on the accumulator
registers); it replaces the Pallas TPU kernel `_kernel` / `_fused_fn`
(`pallas_sweep.py:65-161`).  It scores a bf16 query batch against the
whole flat bf16 table with f32 accumulation, adds the per-row bias, packs
each column's position within its 256-column segment into the low 8
mantissa bits (`bits & ~0xFF | col`) and keeps the two best packed values
per segment, so the [B, n_total] score slab never reaches device memory.
Output: ONE f32 array [B, 2 * n_total / SEG], ordered
[seg0 top1, seg0 top2, seg1 top1, ...].  Packing perturbs a score by less
than 2^-15 relative, so a plain top-k over the packed array selects the
candidates AND carries their ids; the exact f32 re-rank in `serve`
restores true scores and order.  Dead rows carry a finite NEG_FILL bias:
a -inf bias with id bits OR'd into its mantissa is a NaN.

Unlike the TPU kernel, the CUDA kernel has no shape restriction beyond
d_pad % 16 == 0 and n_total % 256 == 0 (every `_chunking` table meets
the second), and it takes any batch size.  The source holds two routes,
chosen by `route` from the shape alone: `resident` (d_pad <= 128: two
table segments stay in shared memory, query tiles stream past them) and
`kloop` (wider rows: a K-loop over a ring of query and table chunks).
`work_split` mirrors how each route's persistent grid divides the work.

`fused_sweep` launches the kernel for CUDA tensors and runs the plain
PyTorch version `fused_sweep_plain` (same arithmetic) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.device import mm_bf16
from . import _build

SEG = 256          # table columns per segment (top-2 kept per segment)
NEG_FILL = -3.0e38  # finite "minus infinity" (see module docstring)


def prep(tbl: torch.Tensor, bias: torch.Tensor):
    """The kernel's flat bf16 table + finite-min bias from the resident
    chunked f32 table (counterpart of `_prep_fn`; re-run per version)."""
    d_pad = tbl.shape[-1]
    flat = tbl.reshape(-1, d_pad).to(torch.bfloat16).contiguous()
    b = torch.where(torch.isfinite(bias), bias, torch.full_like(bias, NEG_FILL))
    return flat, b.reshape(-1).contiguous()


def _check(qs: torch.Tensor, tbl: torch.Tensor, bias: torch.Tensor) -> None:
    if qs.dim() != 2 or tbl.dim() != 2 or qs.shape[1] != tbl.shape[1]:
        raise ValueError(
            f"fused_sweep: qs {tuple(qs.shape)} / tbl {tuple(tbl.shape)} "
            "must be [B, d_pad] / [n_total, d_pad]"
        )
    if qs.dtype != torch.bfloat16 or tbl.dtype != torch.bfloat16:
        raise TypeError("fused_sweep: qs and tbl must be bfloat16")
    if bias.dtype != torch.float32 or bias.numel() != tbl.shape[0]:
        raise TypeError("fused_sweep: bias must be float32 [n_total]")
    B, d_pad = qs.shape
    n_total = tbl.shape[0]
    if B < 1 or d_pad % 16 or n_total < SEG or n_total % SEG:
        raise ValueError(
            f"fused_sweep: needs B >= 1, d_pad % 16 == 0 and n_total % {SEG} "
            f"== 0 (got B={B}, d_pad={d_pad}, n_total={n_total})"
        )
    if not (qs.is_contiguous() and tbl.is_contiguous() and bias.is_contiguous()):
        raise ValueError("fused_sweep: inputs must be contiguous")
    if not (qs.device == tbl.device == bias.device):
        raise ValueError("fused_sweep: inputs must be on one device")


def fused_sweep_plain(qs: torch.Tensor, tbl: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the bf16 product with f32
    results (`mm_bf16`: f32 arithmetic on the bf16-rounded inputs on the
    CPU, the bf16 tensor-core product on the card), the same bit packing,
    top-2 per segment (the second clamped at NEG_FILL, as the TPU
    kernel's masked re-max).  Processes query rows in slabs of at most
    2^29 scores."""
    B, d_pad = qs.shape
    n_total = tbl.shape[0]
    segs = n_total // SEG
    out = torch.empty((B, 2 * segs), dtype=torch.float32, device=qs.device)
    b = bias.reshape(1, -1)
    col = torch.arange(n_total, device=qs.device, dtype=torch.int32) & (SEG - 1)
    step = max(1, (1 << 29) // n_total)
    for b0 in range(0, B, step):
        s = mm_bf16(qs[b0:b0 + step], tbl)
        s += b
        packed = ((s.view(torch.int32) & ~(SEG - 1)) | col).view(torch.float32)
        top = packed.view(-1, segs, SEG).topk(2, dim=2).values
        top[..., 1].clamp_(min=NEG_FILL)
        out[b0:b0 + step] = top.reshape(-1, 2 * segs)
        del s, packed, top
    return out


# The routes' tiling, as in csrc/fused_sweep.cu.
ROUTES = ("resident", "kloop")
RESIDENT_MAX_D = 128   # widest row whose two segments fit in shared memory
Q_TILE = {"resident": 64, "kloop": 128}   # query rows per work unit
SEG_GROUP = {"resident": 2, "kloop": 1}   # table segments per work unit


def route(B: int, n_total: int, d_pad: int) -> str:
    """The kernel route for a shape `_check` accepts: a function of the
    shape alone (in fact of d_pad alone)."""
    return "resident" if d_pad <= RESIDENT_MAX_D else "kloop"


def work_split(B: int, n_total: int, d_pad: int, n_sm: int):
    """How the route's persistent grid divides the sweep, as the launcher
    and the kernel compute it: the (segment group, query tile) units,
    group-major, are cut into `grid = min(n_sm, units)` contiguous ranges
    of equal length (to within one), one per block.  Returns
    (route, n_qt, ranges) with ranges[b] = (u_begin, u_end); unit u covers
    query tile u % n_qt and the segments
    [(u // n_qt) * g, min((u // n_qt + 1) * g, n_seg)), g = SEG_GROUP."""
    r = route(B, n_total, d_pad)
    n_seg = n_total // SEG
    n_qt = -(-B // Q_TILE[r])
    units = -(-n_seg // SEG_GROUP[r]) * n_qt
    grid = min(n_sm, units)
    return r, n_qt, [(units * b // grid, units * (b + 1) // grid)
                     for b in range(grid)]


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_sweep")
    for r in ROUTES:
        fn = getattr(lib, "cozo_fused_sweep_" + r)
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def fused_sweep(qs: torch.Tensor, tbl: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """qs [B, d_pad] bf16, tbl [n_total, d_pad] bf16, bias [n_total] f32
    -> packed [B, 2 * n_total / SEG] f32.  CUDA tensors launch the kernel
    route that `route` names on the current stream (and count the launch
    in `fused_sweep.launches` and `fused_sweep.route_launches`); CPU
    tensors run `fused_sweep_plain`."""
    _check(qs, tbl, bias)
    if qs.device.type == "cpu":
        return fused_sweep_plain(qs, tbl, bias)
    if qs.device.type != "cuda":
        raise ValueError(f"fused_sweep: unsupported device {qs.device}")
    for t in (qs, tbl, bias):
        if t.data_ptr() % 16:
            raise ValueError("fused_sweep: inputs must be 16-byte aligned")
    B, d_pad = qs.shape
    n_total = tbl.shape[0]
    r = route(B, n_total, d_pad)
    lib = _lib()
    out = torch.empty((B, 2 * (n_total // SEG)), dtype=torch.float32,
                      device=qs.device)
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        err = getattr(lib, "cozo_fused_sweep_" + r)(
            qs.data_ptr(), tbl.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, n_total, d_pad, stream,
        )
    _build.check(lib, err, f"fused_sweep launch ({r})")
    fused_sweep.launches += 1
    fused_sweep.route_launches[r] += 1
    return out


fused_sweep.launches = 0
fused_sweep.route_launches = dict.fromkeys(ROUTES, 0)


def serve(tbl_flat: torch.Tensor, bias_flat: torch.Tensor,
          tbl_f32: torch.Tensor, qs_in: torch.Tensor, k: int, kf: int,
          metric: str, d_in: int, d_pad: int) -> torch.Tensor:
    """End-to-end fused serving (counterpart of `_serve_fn`): kernel ->
    top-kf over the packed array -> decode ids -> exact f32 re-rank.
    Returns the packed int32 [B, 2k] (ids | score bits) of
    `exact_knn._sweep`.

    Selection over the packed array is the exact `exact_knn.select_topk`
    (`csrc/slab_topk.cu`) at every width, where the JAX version switches
    to `approx_max_k` past 4,096 packed columns."""
    from .exact_knn import rerank_pack, select_topk

    qs = qs_in.float()
    if d_in and d_in < d_pad:
        qs = torch.nn.functional.pad(qs, (0, d_pad - d_in))
    packed = fused_sweep(qs.to(torch.bfloat16).contiguous(), tbl_flat,
                         bias_flat)
    vals, pos = select_topk(packed, min(kf, packed.shape[1]))
    col = vals.view(torch.int32) & (SEG - 1)
    rows_id = (pos >> 1) * SEG + col
    valid = vals > NEG_FILL * 0.5
    return rerank_pack(tbl_f32.reshape(-1, d_pad), qs, rows_id, valid, k,
                       metric)


def fused_ref_numpy(tbl: np.ndarray, bias: np.ndarray, qs: np.ndarray):
    """Pure-numpy reference of the packed segment-top2 (tests)."""
    scores = (
        qs.astype(np.float32) @ tbl.astype(np.float32).T
        + bias.reshape(1, -1)
    )
    bits = scores.view(np.int32) if scores.flags.c_contiguous else \
        np.ascontiguousarray(scores).view(np.int32)
    col8 = (np.arange(scores.shape[1], dtype=np.int32) % SEG)[None, :]
    packed = ((bits & ~(SEG - 1)) | col8).view(np.float32)
    B, N = packed.shape
    segs = N // SEG
    p3 = packed.reshape(B, segs, SEG)
    order = np.argsort(-p3, axis=2)[:, :, :2]
    top2 = np.take_along_axis(p3, order, axis=2)
    return top2.reshape(B, segs * 2)
