"""Device-resident chunked k-NN sweep (counterpart of
`cozo_tpu/ops/exact_knn.py`) — the serving path for large-batch vector
search.

Layout: the table lives on the device as [n_chunks, CHUNK, d_pad] f32
with a score bias [n_chunks, CHUNK] (0 alive, -inf dead/padding).  Each
chunk's scores (f32, or bf16 / int8 inputs with f32 / int32 results) give
its top candidates; ONE top-k merges them, then an exact f32 re-rank of
the over-fetched candidates.  Where the JAX version computes a chunk's
product and its `lax.approx_max_k` in one scan body, the f32, bf16 and
i8 lanes call `sweep_topk`: the product and an exact selection in one
kernel, the score slab never in device memory (`csrc/sweep_topk.cu` for
bf16 and int8 on the tensor cores; `csrc/sweep_topk_f32.cu` for the f32
lane's true-f32 product, which no tensor-core format gives bit for bit:
FFMA chains).  `select_topk`, the hand kernel `csrc/slab_topk.cu`, is an
exact selection from a slab in device memory that takes the slab's bias
(and the int8 rescale and bf16 rounding) as it reads it: the merges, the
quant lane's and the int8 build's chunks, the fused lane's pick and
`sweep_topk`'s two-step route.  Both follow `lax.top_k`'s tie rule
(equal keys by ascending position, +0.0 above -0.0).
Queries arrive as f16 (or f32) and unpadded, and results come back as one
packed int32 array (ids | score bits), as in the JAX version, so both
packages score the same inputs and return the same contract.

Distance handling reduces every metric to a max-similarity problem:
  L2:     s = 2 q·v - ||v||^2          (d = ||q||^2 - s)
  IP:     s = q·v                      (d = 1 - s)
  Cosine: s = q̂·v̂ (rows pre-normalized; d = 1 - s)

Lanes: `f32` (exact), `bf16` (+ exact re-rank, or raw), `i8` (int8 x
int8 -> int32 products rescaled to a bf16 score slab, always re-ranked)
and `fused` (the CUDA kernel of `ops/fused_sweep.py`, always re-ranked).
Queries are uploaded as f32 through pinned memory and prepared on the
device (`utils/device.prepare_queries`: cosine normalise, the f16 round
of the JAX package's upload, zero-pad, int8 quantisation).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import (default_device, int_mm, mm_bf16,
                            prepare_queries, quantize_i8, to_device)
from . import _build
from . import fused_sweep as _fs

MAX_CHUNK = 1 << 17


def _pad_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _chunking(n: int) -> Tuple[int, int]:
    """(chunk_size, n_chunks): one pow2 chunk for small tables, fixed
    MAX_CHUNK chunks beyond."""
    if n <= MAX_CHUNK:
        c = max(_pad_pow2(n), 512)
        return c, 1
    return MAX_CHUNK, (n + MAX_CHUNK - 1) // MAX_CHUNK


def rerank_pack(flat: torch.Tensor, qs: torch.Tensor, ids: torch.Tensor,
                valid: torch.Tensor, k: int, metric: str) -> torch.Tensor:
    """Exact f32 re-score of candidate rows `ids` [B, kf] of `flat`
    [rows, d_pad] against `qs` [B, d_pad]; returns the packed int32
    [B, 2k] (ids | score bits) of the best k (id -1 / -inf if fewer)."""
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    rows = flat[safe]  # [B, kf, d_pad]
    if metric == "L2":
        v = rows * 0.5  # storage form is 2v; sweep queries are raw q
        diff = qs[:, None, :] - v
        s_exact = -torch.sum(diff * diff, dim=2)
    else:
        s_exact = torch.einsum("bkd,bd->bk", rows, qs)
    s_exact = torch.where(valid, s_exact,
                          torch.full_like(s_exact, -math.inf))
    if s_exact.shape[1] < k:  # fewer candidates than k (tiny tables)
        short = k - s_exact.shape[1]
        s_exact = torch.nn.functional.pad(s_exact, (0, short), value=-math.inf)
        ids = torch.nn.functional.pad(ids, (0, short), value=-1)
    ts, ti = torch.topk(s_exact, k)
    out_i = torch.gather(ids, 1, ti)
    out_i = torch.where(torch.isfinite(ts), out_i, torch.full_like(out_i, -1))
    return torch.cat([out_i.to(torch.int32), ts.view(torch.int32)], dim=1)


# -- the per-chunk selection: csrc/slab_topk.cu -------------------------------

_TOPK_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                  + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_void_p])
# the most bytes of sort scratch one launch takes (kf past the kernel's
# shared sort buffer); more rows go in further launches
TOPK_SCRATCH_BYTES = 1 << 28


def _bind_topk(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.cozo_slab_topk.argtypes is None:
        lib.cozo_slab_topk.argtypes = _TOPK_ARGTYPES
        lib.cozo_slab_topk.restype = ctypes.c_int
        lib.cozo_slab_topk_sort_cap.argtypes = []
        lib.cozo_slab_topk_sort_cap.restype = ctypes.c_int
    return lib


def _topk_lib() -> ctypes.CDLL:
    return _bind_topk(_build.load("slab_topk"))


def order_key(v: torch.Tensor) -> torch.Tensor:
    """The int32 key of f32 (or bf16, widened) values that orders as the
    values do, +0.0 above -0.0 (`lax.top_k`'s total order)."""
    u = v.float().contiguous().view(torch.int32)
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def slab_key(x: torch.Tensor, col_scale=None, row_scale=None, bias=None,
             bf16: bool = False) -> torch.Tensor:
    """The selection's key of slab x [B, W] (f32, int32 or bf16): ((x *
    col_scale[j]) * row_scale[i]) + bias[j], each factor where given, in
    separate f32 passes, then rounded to bf16 where asked."""
    key = x.float()
    if col_scale is not None:
        key = key * col_scale[None, :]
    if row_scale is not None:
        key = key * row_scale[:, None]
    if bias is not None:
        key = key + bias[None, :]
    return key.to(torch.bfloat16) if bf16 else key


def select_topk_plain(x: torch.Tensor, kf: int, col_scale=None,
                      row_scale=None, bias=None, bf16: bool = False,
                      offset: int = 0):
    """Plain version of `select_topk`: the keys' `order_key`, each made
    unique by its position (key << 32 | 2^32 - 1 - position, int64), and
    the kf largest of those: the first kf of a stable descending sort of
    the keys (ties by ascending position), at the cost of a top-k.
    Returns (values [B, kf] f32, or bf16 where asked or x is bf16; ids
    [B, kf] int64 = position + offset)."""
    key = slab_key(x, col_scale, row_scale, bias,
                   bf16 or x.dtype == torch.bfloat16)
    pos = torch.arange(key.shape[1], dtype=torch.int64, device=key.device)
    unique = (order_key(key).to(torch.int64) << 32) | (0xFFFFFFFF - pos)
    _, pos = torch.topk(unique, kf)
    return torch.gather(key, 1, pos), pos + offset


def _check_topk(x, kf, col_scale, row_scale, bias, bf16, out):
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"select_topk: x must be [B, W] with unit column "
                         f"stride, got {tuple(x.shape)} / {x.stride()}")
    B, W = x.shape
    if x.dtype not in (torch.float32, torch.int32, torch.bfloat16):
        raise TypeError(f"select_topk: x must be f32, int32 or bf16, got "
                        f"{x.dtype}")
    if x.dtype == torch.bfloat16 and not (
            col_scale is None and row_scale is None and bias is None):
        raise ValueError("select_topk: a bf16 slab takes no prologue")
    if not 1 <= kf <= W or W >= 1 << 31:
        raise ValueError(f"select_topk: needs 1 <= kf <= W < 2^31 (kf={kf}, "
                         f"W={W})")
    for name, v, n in (("col_scale", col_scale, W), ("row_scale", row_scale, B),
                       ("bias", bias, W)):
        if v is not None and (v.dtype != torch.float32 or v.dim() != 1
                              or v.shape[0] != n or not v.is_contiguous()
                              or v.device != x.device):
            raise ValueError(f"select_topk: {name} must be contiguous f32 "
                             f"[{n}] on {x.device}")
    if out is not None:
        _check_topk_out(out, B, kf, torch.bfloat16 if bf16
                        or x.dtype == torch.bfloat16 else torch.float32,
                        x.device, "select_topk")


def _check_topk_out(out, B, width, want, device, who):
    vals, ids = out
    if (tuple(vals.shape) != (B, width) or tuple(ids.shape) != (B, width)
            or vals.dtype != want or ids.dtype != torch.int64
            or vals.stride(1) != 1 or ids.stride(1) != 1
            or (B > 1 and vals.stride(0) != ids.stride(0))
            or vals.device != device or ids.device != device):
        raise ValueError(f"{who}: out must be ({want}, int64) [{B}, "
                         f"{width}] with unit column stride and one row "
                         f"stride, on {device}")


def select_topk(x: torch.Tensor, kf: int, col_scale=None, row_scale=None,
                bias=None, bf16: bool = False, offset: int = 0, out=None):
    """The kf largest keys of each row of slab x [B, W] (f32, int32, or
    bf16 without a prologue; key as `slab_key`), descending, equal keys
    by ascending position: (values, ids = position + offset int64), into
    `out` (two [B, kf] views with one row stride, e.g. a chunk's columns
    of a merge buffer) where given.  CUDA tensors launch
    `csrc/slab_topk.cu` on the current stream (each launch counted in
    `select_topk.launches`); CPU tensors run `select_topk_plain`."""
    _check_topk(x, kf, col_scale, row_scale, bias, bf16, out)
    if x.device.type == "cpu":
        vals, ids = select_topk_plain(x, kf, col_scale, row_scale, bias,
                                      bf16, offset)
        if out is None:
            return vals, ids
        out[0].copy_(vals)
        out[1].copy_(ids)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"select_topk: unsupported device {x.device}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        out, launches = _topk_run(_topk_lib(), x, kf, col_scale, row_scale,
                                  bias, bf16, offset, out, stream)
    select_topk.launches += launches
    return out


select_topk.launches = 0


def _topk_run(lib, x, kf, col_scale, row_scale, bias, bf16, offset, out,
              stream):
    """Enqueues the kernel of `lib` on `stream` for checked arguments, with
    sort scratch where kf needs it, in launches of at most
    TOPK_SCRATCH_BYTES of scratch; returns (out, the number of
    launches)."""
    if x.dtype == torch.bfloat16:  # exact widening; the kernel rounds back
        x, bf16 = x.float(), True
    B, W = x.shape
    if out is None:
        out = (torch.empty((B, kf), device=x.device,
                           dtype=torch.bfloat16 if bf16 else torch.float32),
               torch.empty((B, kf), dtype=torch.int64, device=x.device))
    n_sort = _pad_pow2(kf)
    scratch, rows = None, max(B, 1)
    if n_sort > lib.cozo_slab_topk_sort_cap():
        rows = max(1, min(B, TOPK_SCRATCH_BYTES // (8 * n_sort)))
        scratch = torch.empty((rows, n_sort), dtype=torch.int64,
                              device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    launches = 0
    for row0 in range(0, B, rows):
        err = lib.cozo_slab_topk(
            x.data_ptr(), int(x.dtype == torch.int32),
            x.stride(0) if B > 1 else W, min(rows, B - row0), W, kf,
            ptr(col_scale), ptr(row_scale), ptr(bias), out[0].data_ptr(),
            int(bf16), out[1].data_ptr(), out[0].stride(0) if B > 1 else kf,
            offset, ptr(scratch), n_sort, row0, stream)
        _build.check(lib, err, "slab_topk launch")
        launches += 1
    return out, launches


# -- the chunk step: csrc/sweep_topk.cu ---------------------------------------

SWEEP_MAX_D = 4096    # the kernels' widest row (d_pad; past 128 the wide form
                      # of csrc/sweep_topk.cu, the f32 kind's streamed rows)
SWEEP_MAX_KC = 256    # its largest kc
SWEEP_PIECE = 256     # a piece is a multiple of this many table rows
SWEEP_FILL = 0.9      # `sweep_piece`: the share of the SMs' waves enough
_SWEEP_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
_SWEEP_F32_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_void_p])
SWEEP_F32 = 2  # `sweep_piece`'s kind of the f32 chunk step (0 bf16, 1 int8)


def _bind_shape(lib: ctypes.CDLL) -> None:
    """Both libraries' launch configuration: `cozo_sweep_topk_rows`,
    `_cluster` and `_slots`, each (kind, d_pad, kc)."""
    for name in ("rows", "cluster", "slots"):
        fn = getattr(lib, "cozo_sweep_topk_" + name)
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int


def _bind_sweep(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.cozo_sweep_topk.argtypes is None:
        lib.cozo_sweep_topk.argtypes = _SWEEP_ARGTYPES
        lib.cozo_sweep_topk.restype = ctypes.c_int
        _bind_shape(lib)
        lib.cozo_sweep_topk_counts.argtypes = [ctypes.c_void_p]
        lib.cozo_sweep_topk_counts.restype = ctypes.c_int
    return lib


def _sweep_lib() -> ctypes.CDLL:
    return _bind_sweep(_build.load("sweep_topk"))


def _bind_sweep_f32(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.cozo_sweep_topk_f32.argtypes is None:
        lib.cozo_sweep_topk_f32.argtypes = _SWEEP_F32_ARGTYPES
        lib.cozo_sweep_topk_f32.restype = ctypes.c_int
        _bind_shape(lib)
    return lib


def _sweep_f32_lib() -> ctypes.CDLL:
    return _bind_sweep_f32(_build.load("sweep_topk_f32"))


@functools.lru_cache(maxsize=None)
def _sweep_block_shape(lib, device_index: int, kind: int, d_pad: int,
                       kc: int) -> Tuple[int, int, int]:
    """`lib`'s query rows a block, blocks a cluster and slots (the blocks
    the card holds at once) for one launch configuration."""
    with torch.cuda.device(device_index):
        slots = lib.cozo_sweep_topk_slots(kind, d_pad, kc)
    if slots <= 0:
        raise RuntimeError(f"sweep_piece: the occupancy query failed ({slots})")
    return (lib.cozo_sweep_topk_rows(kind, d_pad, kc),
            lib.cozo_sweep_topk_cluster(kind, d_pad, kc), slots)


def sweep_piece(n_total: int, chunk: int, B: int, d_pad: int, kc: int,
                kind: int, device, lib=None) -> int:
    """The piece width the lanes hand `sweep_topk` for a table of n_total
    rows in chunks of `chunk`: the top kf of the whole table is the top kf
    of any pieces' top kf, so the piece is free.  On the CPU, and on the
    card's two-step route (whose slab is a piece wide), the chunk.  On the
    kernel's route (d_pad to SWEEP_MAX_D, kc to SWEEP_MAX_KC), where fewer
    and wider pieces mean fewer selections
    and a tighter threshold, the widest piece (n_total / d for d dividing
    n_total / SWEEP_PIECE, at least `chunk` / 8 rows) whose blocks fill
    the card's slots to SWEEP_FILL of their waves, or the one that fills
    them best.  A launch has a block a piece and tile of the kernel's
    query rows, the tiles rounded up to its cluster (the blocks that share
    each table tile); its slots are the blocks the card holds at once:
    whole clusters on the SMs, as the occupancy query counts them (asked
    once a configuration).  `kind`: 0 (or False) bf16, 1 (or True) int8,
    SWEEP_F32 f32.  `lib`: the kernel's library (default: this checkout's
    build of the kind's source)."""
    if device.type != "cuda" or sweep_route(d_pad, kc, chunk) != "kernel":
        return chunk
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    kind = int(kind)
    rows, cluster, slots = _sweep_block_shape(
        lib or (_sweep_f32_lib() if kind == SWEEP_F32 else _sweep_lib()),
        index, kind, d_pad, kc)
    n_qt = -(-B // rows)
    n_qt = -(-n_qt // cluster) * cluster
    units = n_total // SWEEP_PIECE
    best, best_fill = chunk, -1.0
    for d in range(1, units + 1):
        if n_total // d < max(chunk // 8, SWEEP_PIECE):
            break
        if units % d:
            continue
        blocks = n_qt * d
        fill = blocks / (slots * -(-blocks // slots))
        if fill >= SWEEP_FILL:
            return n_total // d
        if fill > best_fill:
            best, best_fill = n_total // d, fill
    return best


def sweep_route(d_pad: int, kc: int, piece: int) -> str:
    """The route of `sweep_topk` on the card, from the shape alone:
    "kernel" for d_pad <= SWEEP_MAX_D, kc <= SWEEP_MAX_KC and a piece that
    is a multiple of SWEEP_PIECE, else "two_step" (the product, then
    `select_topk`)."""
    return ("kernel" if d_pad <= SWEEP_MAX_D and kc <= SWEEP_MAX_KC
            and piece % SWEEP_PIECE == 0 else "two_step")


def _check_sweep(q, tbl, piece, kc, bias, col_scale, row_scale, out):
    if q.dim() != 2 or tbl.dim() != 2 or q.shape[1] != tbl.shape[1]:
        raise ValueError(f"sweep_topk: q {tuple(q.shape)} / tbl "
                         f"{tuple(tbl.shape)} must be [B, d_pad] / "
                         f"[n_total, d_pad]")
    if q.dtype != tbl.dtype or q.dtype not in (torch.bfloat16, torch.int8,
                                               torch.float32):
        raise TypeError(f"sweep_topk: q and tbl must both be bf16, both int8 "
                        f"or both f32, got {q.dtype} / {tbl.dtype}")
    int8 = q.dtype == torch.int8
    B, d_pad = q.shape
    n_total = tbl.shape[0]
    if (B < 1 or d_pad < 16 or d_pad % 16 or piece < 1 or n_total < piece
            or n_total % piece or not 1 <= kc <= piece):
        raise ValueError(
            f"sweep_topk: needs B >= 1, d_pad a multiple of 16, a piece that "
            f"divides n_total, 1 <= kc <= piece (B={B}, d_pad={d_pad}, "
            f"n_total={n_total}, piece={piece}, kc={kc})")
    if int8 != (col_scale is not None) or int8 != (row_scale is not None):
        raise ValueError("sweep_topk: int8 inputs take col_scale and "
                         "row_scale, bf16 and f32 inputs neither")
    for name, v, n in (("bias", bias, n_total), ("col_scale", col_scale,
                                                 n_total),
                       ("row_scale", row_scale, B)):
        if name == "bias" or v is not None:
            if (v is None or v.dtype != torch.float32 or v.dim() != 1
                    or v.shape[0] != n or not v.is_contiguous()
                    or v.device != q.device):
                raise ValueError(f"sweep_topk: {name} must be contiguous "
                                 f"f32 [{n}] on {q.device}")
    if not (q.is_contiguous() and tbl.is_contiguous()) \
            or tbl.device != q.device:
        raise ValueError("sweep_topk: q and tbl must be contiguous, on one "
                         "device")
    if out is not None:
        _check_topk_out(out, B, (n_total // piece) * kc,
                        torch.bfloat16 if int8 else torch.float32, q.device,
                        "sweep_topk")


def sweep_topk_plain(q: torch.Tensor, tbl: torch.Tensor, piece: int,
                     kc: int, bias: torch.Tensor, col_scale=None,
                     row_scale=None, offset: int = 0, out=None):
    """Plain version of `sweep_topk`: per piece the product (`mm_bf16`,
    `int_mm` for int8, `torch.mm` in f32 for f32), then `select_topk_plain`
    of its slab with the piece's bias (and scales, and the bf16 rounding
    for int8), ids offset by the piece's first row.  Returns (values, ids),
    [B, n_pieces * kc]."""
    int8 = q.dtype == torch.int8
    if out is None:
        out = _chunk_buffers(q.shape[0], tbl.shape[0] // piece, kc,
                             torch.bfloat16 if int8 else torch.float32,
                             q.device)
    for p in range(tbl.shape[0] // piece):
        cols = slice(p * piece, (p + 1) * piece)
        if int8:
            vals, ids = select_topk_plain(
                int_mm(q, tbl[cols]), kc, col_scale=col_scale[cols],
                row_scale=row_scale, bias=bias[cols], bf16=True,
                offset=offset + p * piece)
        else:
            vals, ids = select_topk_plain(_piece_product(q, tbl[cols]), kc,
                                          bias=bias[cols],
                                          offset=offset + p * piece)
        dst = _cols(out, p, kc)
        dst[0].copy_(vals)
        dst[1].copy_(ids)
    return out


def _piece_product(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The f32 slab of a bf16 or f32 piece: `mm_bf16`, or `torch.mm` in
    f32 (TF32 off, `utils/device.default_device`)."""
    return torch.mm(q, t.T) if q.dtype == torch.float32 else mm_bf16(q, t)


def sweep_two_step(q, tbl, piece, kc, bias, col_scale, row_scale, offset,
                   out):
    """`sweep_topk`'s two-step route on checked arguments: per piece the
    product (`mm_bf16`, `int_mm` or `torch.mm` in f32) writes its slab,
    then `select_topk` selects from it into the piece's columns of
    `out`."""
    for p in range(tbl.shape[0] // piece):
        cols = slice(p * piece, (p + 1) * piece)
        if q.dtype == torch.int8:
            select_topk(int_mm(q, tbl[cols]), kc, col_scale=col_scale[cols],
                        row_scale=row_scale, bias=bias[cols], bf16=True,
                        offset=offset + p * piece, out=_cols(out, p, kc))
        else:
            select_topk(_piece_product(q, tbl[cols]), kc, bias=bias[cols],
                        offset=offset + p * piece, out=_cols(out, p, kc))
    return out


def sweep_topk(q: torch.Tensor, tbl: torch.Tensor, piece: int, kc: int,
               bias: torch.Tensor, col_scale=None, row_scale=None,
               offset: int = 0, out=None, d_real: int = 0):
    """The chunk step of the sweeps: for each row of q and each piece of
    `piece` table rows, the kc largest keys of the row's scores against the
    piece, as `select_topk` selects them from the slab (descending, equal
    keys by ascending position, +0.0 above -0.0).

      - bf16: q [B, d_pad] and tbl [n_total, d_pad] bf16, scores f32 sums
        of the bf16 products, key = score + bias[j], values f32;
      - int8: q and tbl int8, exact int32 products, key = bf16(((s *
        col_scale[j]) * row_scale[i]) + bias[j]), values bf16;
      - f32: q and tbl f32, scores true-f32 sums (one `fmaf` chain over k
        ascending from +0.0 on the card), key = score + bias[j], values
        f32.  `d_real`: the rows' real width where every column past it
        is +0.0 in q and tbl (0: unknown); the card's chains stop there,
        with the padded chains' bits.

    Returns (values, ids = position in tbl + offset, int64), [B, n_pieces
    * kc], piece p in columns [p kc, (p + 1) kc): the merge buffer of
    `_chunk_buffers`, or `out` (two such views with one row stride).
    CUDA tensors: the route `sweep_route(d_pad, kc, piece)` names, chosen
    before any launch: "kernel" launches one kernel on the current stream
    for every piece (counted in `sweep_topk.launches`, the f32 kind's also
    in `sweep_topk.f32_launches`), with no slab in device memory: bf16 and
    int8 `csrc/sweep_topk.cu` (rows past 128 wide in its wide form: query
    rows in shared memory, the table's 128-byte K-chunks through its
    ring), f32 `csrc/sweep_topk_f32.cu` (FFMA on register micro-tiles, the
    table's K-slices through a TMA ring, a selecting warpgroup beside the
    products), each to d_pad 4,096
    (OpenAI's 1,536 and 3,072, the 7B-LLM embedders' 4,096); "two_step"
    (d_pad > 4,096, kc > 256 or a piece that is not a multiple of 256)
    runs each piece's product and `select_topk` (counted in
    `sweep_topk.two_step`).  A launch the kernel refuses raises; nothing
    falls back to the two-step route.
    CPU tensors run `sweep_topk_plain`."""
    _check_sweep(q, tbl, piece, kc, bias, col_scale, row_scale, out)
    if not 0 <= d_real <= q.shape[1]:
        raise ValueError(f"sweep_topk: d_real {d_real} past d_pad "
                         f"{q.shape[1]}")
    if q.device.type == "cpu":
        return sweep_topk_plain(q, tbl, piece, kc, bias, col_scale,
                                row_scale, offset, out)
    if q.device.type != "cuda":
        raise ValueError(f"sweep_topk: unsupported device {q.device}")
    int8 = q.dtype == torch.int8
    B, d_pad = q.shape
    n_pieces = tbl.shape[0] // piece
    if out is None:
        out = _chunk_buffers(B, n_pieces, kc,
                             torch.bfloat16 if int8 else torch.float32,
                             q.device)
    if sweep_route(d_pad, kc, piece) == "two_step":
        sweep_two_step(q, tbl, piece, kc, bias, col_scale, row_scale, offset,
                       out)
        sweep_topk.two_step += 1
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    ldo = out[0].stride(0) if B > 1 else n_pieces * kc
    f32 = q.dtype == torch.float32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if f32:
            lib = _sweep_f32_lib()
            err = lib.cozo_sweep_topk_f32(
                q.data_ptr(), tbl.data_ptr(), B, tbl.shape[0], d_pad, d_real,
                piece, kc, bias.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), ldo, offset, stream)
        else:
            lib = _sweep_lib()
            err = lib.cozo_sweep_topk(
                q.data_ptr(), tbl.data_ptr(), int(int8), B, tbl.shape[0],
                d_pad, piece, kc, bias.data_ptr(), ptr(col_scale),
                ptr(row_scale), out[0].data_ptr(), out[1].data_ptr(), ldo,
                offset, stream)
    _build.check(lib, err, "sweep_topk launch")
    sweep_topk.launches += 1
    sweep_topk.f32_launches += f32
    return out


sweep_topk.launches = 0
sweep_topk.f32_launches = 0
sweep_topk.two_step = 0


def merge_chunks(alld: torch.Tensor, alli: torch.Tensor, kf: int):
    """The best kf of the per-chunk candidates alld [B, n_chunks * kc]
    (scores, chunk-major) with their global ids alli: the chunks' own
    order breaks ties, lower position first, as the JAX merge's
    `lax.top_k` does."""
    if alld.shape[1] == kf:
        return alld, alli
    bs, sel = select_topk(alld, min(kf, alld.shape[1]))
    return bs, torch.gather(alli, 1, sel)


def _chunk_buffers(B: int, n_chunks: int, kc: int, dtype, device):
    """The merge buffer's scores and ids, [B, n_chunks * kc]: chunk c's
    selection writes columns c * kc ... (c + 1) * kc."""
    return (torch.empty((B, n_chunks * kc), dtype=dtype, device=device),
            torch.empty((B, n_chunks * kc), dtype=torch.int64, device=device))


def _cols(bufs, c: int, kc: int):
    return tuple(t[:, c * kc:(c + 1) * kc] for t in bufs)


def _sweep(tbl: torch.Tensor, bias: torch.Tensor, qs: torch.Tensor,
           k: int, compute_dtype: str, rerank_k: int = 0,
           metric: str = "IP", tbl16: Optional[torch.Tensor] = None,
           d_in: int = 0) -> torch.Tensor:
    """Counterpart of `_sweep_fn`; `qs` [B, d_pad] f32 as
    `prepare_queries` gives them.  Every chunk's product and selection in
    `sweep_topk`, on the piece `sweep_piece` picks: bf16 (`tbl16`, the
    flat bf16 table, is made from `tbl` where not given) or true f32
    (the flat f32 table, a view; `d_in`, the rows' real width with
    zeros past it in `qs` and `tbl`, lets its chains stop there); then one
    merge.  rerank_k > 0:
    over-fetch rerank_k candidates in the scan, then re-score them in true
    f32 (L2 in the cancellation-free diff form) and return the exact top-k.
    Returns the packed int32 [B, 2k'] (ids | score bits)."""
    n_chunks, chunk, d_pad = tbl.shape
    kf = max(k, rerank_k)
    if compute_dtype == "bf16":
        if tbl16 is None:
            tbl16 = tbl.reshape(-1, d_pad).to(torch.bfloat16)
        q, flat, kind = qs.to(torch.bfloat16), tbl16, 0
    else:
        q, flat, kind = qs.contiguous(), tbl.reshape(-1, d_pad), SWEEP_F32
    piece = sweep_piece(flat.shape[0], chunk, qs.shape[0], d_pad,
                        min(kf, chunk), kind, qs.device)
    bufs = sweep_topk(q, flat, piece, min(kf, piece), bias.reshape(-1),
                      d_real=d_in if kind == SWEEP_F32 else 0)
    bs, bi = merge_chunks(*bufs, kf)
    if rerank_k <= 0:
        return torch.cat([bi.to(torch.int32), bs.view(torch.int32)], dim=1)
    valid = (bi >= 0) & torch.isfinite(bs)
    return rerank_pack(tbl.reshape(-1, d_pad), qs, bi, valid, k, metric)


def quantize_tbl(tbl: torch.Tensor, bias: torch.Tensor):
    """The int8 lane's table from the resident f32 table, on the device
    (counterpart of `_quantize_tbl_fn`; re-run per version): int8 rows
    [n_chunks, chunk, d_pad] and per-row max-abs scales, 0 on dead rows."""
    q = torch.empty(tbl.shape, dtype=torch.int8, device=tbl.device)
    sc = torch.empty(bias.shape, dtype=torch.float32, device=tbl.device)
    for c in range(tbl.shape[0]):  # chunk by chunk: bounds the temporaries
        q[c], sc[c] = quantize_i8(tbl[c], reciprocal=True)
    return q, torch.where(torch.isfinite(bias), sc, torch.zeros_like(sc))


def _sweep_i8(tbl_i8: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              tbl: torch.Tensor, qs: torch.Tensor, q_i8: torch.Tensor,
              q_scale: torch.Tensor, k: int, rerank_k: int,
              metric: str) -> torch.Tensor:
    """Counterpart of `_sweep_fn_i8`: int8 x int8 -> int32 products per
    chunk, rescaled by the row and query scales, biased and rounded to
    bf16 keys as the JAX lane does, and each chunk's top candidates, all
    in `sweep_topk`; one merge, then the same exact f32 re-rank of the
    over-fetched candidates as `_sweep`.  `qs` / `q_i8` / `q_scale` come
    from `prepare_queries`."""
    n_chunks, chunk, d_pad = tbl.shape
    kf = max(k, rerank_k)
    kc = min(kf, chunk)
    piece = sweep_piece(n_chunks * chunk, chunk, qs.shape[0], d_pad, kc,
                        True, qs.device)
    kc = min(kf, piece)
    bufs = sweep_topk(q_i8, tbl_i8.reshape(-1, d_pad), piece, kc,
                      bias.reshape(-1), col_scale=scale.reshape(-1),
                      row_scale=q_scale)
    bs, bi = merge_chunks(*bufs, kf)
    valid = (bi >= 0) & torch.isfinite(bs.float())
    return rerank_pack(tbl.reshape(-1, d_pad), qs, bi, valid, k, metric)


class SweepTable:
    """Device-resident chunked score table for one index, incrementally
    maintained from the host index's dirty-slot set.

    The table is scattered in place (the JAX `_update_fn` returns new
    arrays instead), so `lock` is held while `refresh` takes the pending
    set and scatters it and while a search reads the table: concurrent
    searches of one index never see a half-written table."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.lock = threading.Lock()
        self.version = -1
        self.tbl: Optional[torch.Tensor] = None
        self.bias: Optional[torch.Tensor] = None
        self.chunk = 0
        self.n_chunks = 0
        self.d_pad = 0
        # capacity hint: size chunking for this many rows up-front so a
        # growing bulk build keeps one table shape
        self.reserve = 0
        # int8 lane (compute_dtype="i8"): int8 rows + per-row scales,
        # derived on device from the f32 table per version
        self.tbl_i8: Optional[torch.Tensor] = None
        self.scale_i8: Optional[torch.Tensor] = None
        self.i8_version = -1
        # bf16 lane: the flat bf16 table `sweep_topk` reads, derived on
        # device per version
        self.tbl_bf16: Optional[torch.Tensor] = None
        self.bf16_version = -1
        # fused lane (compute_dtype="fused"): flat bf16 table + finite-min
        # bias, derived on device per version
        self.tbl_fused: Optional[torch.Tensor] = None
        self.bias_fused: Optional[torch.Tensor] = None
        self.fused_version = -1

    # -- host-side row prep ---------------------------------------------------

    @staticmethod
    def _prep_rows(index, slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (rows [len, d_pad] f32, bias [len] f32) in sweep form."""
        d = index.dim
        d_pad = max(128, int(math.ceil(d / 128) * 128))
        vecs = index.vectors[slots].astype(np.float32)
        alive = index.alive[slots]
        rows = np.zeros((len(slots), d_pad), dtype=np.float32)
        bias = np.where(alive, 0.0, -np.inf).astype(np.float32)
        if index.distance == "L2":
            rows[:, :d] = 2.0 * vecs
            bias = bias - index.norms[slots].astype(np.float32)
        elif index.distance == "IP":
            rows[:, :d] = vecs
        else:  # Cosine
            nrm = np.sqrt(index.norms[slots]).astype(np.float32)
            nrm = np.where(nrm > 0, nrm, 1.0)
            rows[:, :d] = vecs / nrm[:, None]
        bias = np.where(alive, bias, -np.inf)
        return rows, bias

    def refresh(self, index) -> None:
        """Bring the table to the index's version; call with `lock` held.
        The pending set is swapped for an empty one before its slots are
        read, so a slot a writer adds meanwhile waits for the next
        refresh; the version is read before the swap, so that refresh
        comes (an empty pending set at a new version rebuilds the whole
        table)."""
        version = index.version
        if self.version == version:
            return
        n = max(index.n, 1, self.reserve)
        chunk, n_chunks = _chunking(n)
        d = index.dim
        d_pad = max(128, int(math.ceil(d / 128) * 128))
        pending, index.sweep_pending = index.sweep_pending, set()
        if (
            self.tbl is not None
            and n_chunks == self.n_chunks
            and chunk == self.chunk
            and d_pad == self.d_pad
            and pending is not None
            and 0 < len(pending) <= max(4096, (chunk * n_chunks) // 16)
        ):
            # incremental: scatter the dirty slots IN PLACE (index_put_);
            # the JAX version rebuilds the array functionally
            slots = np.fromiter(sorted(pending), dtype=np.int64)
            u_pad = _pad_pow2(len(slots))
            slots_p = np.full(u_pad, slots[0], dtype=np.int64)
            slots_p[: len(slots)] = slots
            rows, bias = self._prep_rows(index, slots_p)
            idx = to_device(slots_p, self.device)
            self.tbl.view(-1, d_pad).index_put_(
                (idx,), to_device(rows, self.device))
            self.bias.view(-1).index_put_(
                (idx,), to_device(np.ascontiguousarray(bias), self.device))
        else:
            total = n_chunks * chunk
            slots = np.arange(total, dtype=np.int64)
            slots_c = np.minimum(slots, index.vectors.shape[0] - 1)
            rows, bias = self._prep_rows(index, slots_c)
            # padding slots (>= index capacity or >= n) are dead
            dead = slots >= index.n
            bias[dead] = -np.inf
            rows[dead] = 0.0
            self.tbl = to_device(rows, self.device).view(n_chunks, chunk, d_pad)
            self.bias = to_device(np.ascontiguousarray(bias),
                                  self.device).view(n_chunks, chunk)
        self.chunk, self.n_chunks, self.d_pad = chunk, n_chunks, d_pad
        self.version = version

    # -- search ---------------------------------------------------------------

    def search(
        self,
        index,
        qs: np.ndarray,
        k: int,
        rt: float = 0.98,
        compute_dtype: str = "bf16",
        exact_rerank: bool = True,
        rerank_k: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """`rt` is accepted for parity with the JAX signature; the
        per-chunk selection here is an exact top-k at every rt."""
        with self.lock:
            return self._search_locked(index, qs, k, compute_dtype,
                                       exact_rerank, rerank_k)

    def _search_locked(self, index, qs, k, compute_dtype, exact_rerank,
                       rerank_k):
        self.refresh(index)
        q = np.asarray(qs, dtype=np.float32)
        # overfetch width: k+16 covers bf16 rank noise at the 0.999
        # operating point
        rerank_k = (
            min(max(rerank_k or 0, k + 16), self.n_chunks * self.chunk)
            if exact_rerank
            else 0
        )
        # f32 upload through pinned memory; normalise, f16 round (as the
        # JAX package uploads for these lanes; the f32 lane stays exact),
        # pad and int8 quantisation run on the device
        prepared = prepare_queries(
            to_device(np.ascontiguousarray(q), self.device), index.distance,
            self.d_pad, half=compute_dtype in ("bf16", "i8", "fused"),
            quantize=compute_dtype == "i8", reciprocal=True,
        )
        if compute_dtype == "fused":
            # fused scoring + segment-top2 (ops/fused_sweep.py): the score
            # slab never reaches device memory.  Always exact-reranked.
            if self.fused_version != self.version or self.tbl_fused is None:
                self.tbl_fused, self.bias_fused = _fs.prep(self.tbl, self.bias)
                self.fused_version = self.version
            packed_d = _fs.serve(
                self.tbl_fused, self.bias_fused, self.tbl, prepared, k,
                max(rerank_k, k + 16), index.distance, 0, self.d_pad,
            )
            exact_rerank = True
        elif compute_dtype == "i8":
            # int8 lane (always exact-reranked)
            if self.i8_version != self.version or self.tbl_i8 is None:
                self.tbl_i8, self.scale_i8 = quantize_tbl(self.tbl, self.bias)
                self.i8_version = self.version
            packed_d = _sweep_i8(
                self.tbl_i8, self.scale_i8, self.bias, self.tbl, *prepared,
                k, max(rerank_k, k + 16), index.distance,
            )
            exact_rerank = True
        else:
            tbl16 = None
            if compute_dtype == "bf16":
                if self.bf16_version != self.version or self.tbl_bf16 is None:
                    self.tbl_bf16 = self.tbl.reshape(-1, self.d_pad).to(
                        torch.bfloat16)
                    self.bf16_version = self.version
                tbl16 = self.tbl_bf16
            packed_d = _sweep(
                self.tbl, self.bias, prepared, k, compute_dtype,
                rerank_k=rerank_k, metric=index.distance, tbl16=tbl16,
                d_in=index.dim,
            )
        packed = packed_d.cpu().numpy()
        kk = packed.shape[1] // 2
        ids = packed[:, :kk].astype(np.int64)
        scores = np.ascontiguousarray(packed[:, kk:]).view(
            np.float32
        ).astype(np.float64)
        bad = ~np.isfinite(scores) | (ids < 0) | (ids >= index.n)
        ids = np.where(bad, -1, ids)
        if exact_rerank:
            # scores are exact f32: L2 returns -||q-v||^2, others similarity
            dists = -scores if index.distance == "L2" else 1.0 - scores
        elif index.distance == "L2":
            qn = np.einsum("bd,bd->b", q.astype(np.float64), q.astype(np.float64))
            dists = np.maximum(qn[:, None] - scores, 0.0)
        else:
            dists = 1.0 - scores
        dists = np.where(bad, np.inf, dists)
        return ids, dists


def sweep_search(index, qs, k, rt: float = 0.98, compute_dtype: str = "bf16",
                 exact_rerank: bool = True, rerank_k: Optional[int] = None):
    """Module-level entry: per-index cached SweepTable, on the index's
    device (the card unless the index was made with device="cpu")."""
    st = getattr(index, "_sweep_table", None)
    if st is None:
        st = SweepTable(default_device(index.device))
        index._sweep_table = st
    return st.search(
        index, qs, k, rt=rt, compute_dtype=compute_dtype,
        exact_rerank=exact_rerank, rerank_k=rerank_k,
    )
