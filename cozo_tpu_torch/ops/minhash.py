"""Vectorized MinHash (counterpart of `cozo_tpu/ops/minhash.py`;
reference `runtime/minhash_lsh.rs:291-341`).

Each element hashes through a seeded 32-bit integer mixer (murmur3
fmix32 of `hash ^ seed[p]`) and a signature is the per-permutation min.
The host half is the JAX package's numpy code, copied: FNV-1a token
hashes, the seeds, `minhash`, the tiled `minhash_segments`, the band
parameters.  The device half is new: the bulk backfill's segment-min is
the hand-written CUDA kernel `csrc/minhash.cu`, launched by `segment_min`
for CUDA tensors; `segment_min_plain` is its plain PyTorch version (uint32
emulated in int64), which the wrapper takes for CPU tensors only.
`minhash_segments_dispatch` keeps the JAX size rule (`DEVICE_MIN_TOKENS`)
and the `COZO_TPU_LSH_DEVICE=0` knob; the device comes from the caller
(`None` is the card, and raises without one), and a fault raises: there is
no probe and no fallback."""

from __future__ import annotations

import ctypes
import math
import os
from typing import List, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, default_device
from . import _build

_U32 = 0xFFFFFFFF


def _mix32_inplace(x: np.ndarray) -> None:
    # murmur3 fmix32 — a well-mixed 32-bit permutation.  In-place ufuncs:
    # the bulk-backfill path runs this over [tokens, n_perm] blocks where
    # one temporary per op costs more than the arithmetic.
    t = np.empty_like(x)
    np.right_shift(x, 16, out=t)
    np.bitwise_xor(x, t, out=x)
    np.multiply(x, np.uint32(0x85EBCA6B), out=x)
    np.right_shift(x, 13, out=t)
    np.bitwise_xor(x, t, out=x)
    np.multiply(x, np.uint32(0xC2B2AE35), out=x)
    np.right_shift(x, 16, out=t)
    np.bitwise_xor(x, t, out=x)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32, copy=True)
    _mix32_inplace(x)
    return x


def hash_tokens(tokens: List[str]) -> np.ndarray:
    """Stable 32-bit hashes of strings (FNV-1a), vectorized over tokens:
    byte columns of a padded [T, L] matrix are folded in L rounds, with a
    mask freezing each hash once its token ends.  Bit-identical to the
    per-byte reference loop (verified in tests/test_lsh.py)."""
    n = len(tokens)
    if n == 0:
        return np.empty(0, dtype=np.uint32)
    bs = [t.encode("utf-8") for t in tokens]
    lens = np.fromiter((len(b) for b in bs), dtype=np.int64, count=n)
    lmax = int(lens.max()) if n else 0
    total = int(lens.sum())
    if lmax == 0:
        return np.full(n, 2166136261, dtype=np.uint32)
    # one joined buffer + a [n, lmax] gather (the per-token fill loop cost
    # 2s per 100K-doc backfill chunk batch)
    arr = np.frombuffer(b"".join(bs), dtype=np.uint8)
    starts = np.empty(n, dtype=np.int64)
    starts[0] = 0
    np.cumsum(lens[:-1], out=starts[1:])
    cols = np.arange(lmax, dtype=np.int64)
    idx = np.minimum(starts[:, None] + cols[None, :], total - 1)
    valid = cols[None, :] < lens[:, None]
    mat = np.where(valid, arr[idx], np.uint8(0))
    h = np.full(n, 2166136261, dtype=np.uint32)
    prime = np.uint32(16777619)
    for j in range(lmax):
        hj = (h ^ mat[:, j]) * prime
        h = np.where(lens > j, hj, h)
    return h


def hash_tokens_dedup(tokens: List[str]) -> np.ndarray:
    """hash_tokens with duplicate folding: backfill chunks repeat the
    same vocabulary heavily, and FNV folding cost scales with rows."""
    uniq: dict = {}
    inv = np.empty(len(tokens), dtype=np.int64)
    for i, t in enumerate(tokens):
        j = uniq.get(t)
        if j is None:
            j = len(uniq)
            uniq[t] = j
        inv[i] = j
    hu = hash_tokens(list(uniq))
    return hu[inv]


_SEEDS_CACHE = {}


def perm_seeds(n_perm: int) -> np.ndarray:
    s = _SEEDS_CACHE.get(n_perm)
    if s is None:
        rng = np.random.RandomState(0x5EED)
        s = rng.randint(0, 1 << 32, size=n_perm, dtype=np.uint64).astype(np.uint32)
        _SEEDS_CACHE[n_perm] = s
    return s


def minhash(element_hashes: np.ndarray, n_perm: int) -> np.ndarray:
    """[E] element hashes → [n_perm] minhash signature (uint32)."""
    if len(element_hashes) == 0:
        return np.full(n_perm, _U32, dtype=np.uint32)
    seeds = perm_seeds(n_perm)
    h = _mix32_np(element_hashes[:, None] ^ seeds[None, :])
    return h.min(axis=0)


_HOST_BLOCK_TOKENS = 32_768


def minhash_segments(
    flat_hashes: np.ndarray, offsets: np.ndarray, n_perm: int
) -> np.ndarray:
    """Tiled driver for `_minhash_segments_block`: the [T, n_perm] mixed
    matrix at T=425K (a 32K-doc backfill chunk) is 218MB — the six fmix
    passes thrash LLC (measured 30s/100K docs).  Tiling doc ranges to
    ~32K tokens keeps each tile cache-resident (~16MB)."""
    n_docs = len(offsets)
    total = len(flat_hashes)
    if total <= _HOST_BLOCK_TOKENS or n_docs <= 1:
        return _minhash_segments_block(flat_hashes, offsets, n_perm)
    offsets = np.asarray(offsets, dtype=np.int64)
    out = np.empty((n_docs, n_perm), dtype=np.uint32)
    d0 = 0
    while d0 < n_docs:
        # widest doc range whose token span fits in a block (>=1 doc)
        d1 = int(
            np.searchsorted(offsets, offsets[d0] + _HOST_BLOCK_TOKENS, "right")
        )
        d1 = max(d1 - 1, d0 + 1)
        end = offsets[d1] if d1 < n_docs else total
        out[d0:d1] = _minhash_segments_block(
            flat_hashes[offsets[d0]:end], offsets[d0:d1] - offsets[d0], n_perm
        )
        d0 = d1
    return out


def _minhash_segments_block(
    flat_hashes: np.ndarray, offsets: np.ndarray, n_perm: int
) -> np.ndarray:
    """Minhash signatures for a batch of variable-length docs in one shot.

    `flat_hashes` is the concatenation of every doc's element hashes;
    `offsets[d]` is doc d's start (offsets[-1] == len(flat_hashes) is NOT
    included).  Empty docs get the all-0xFFFFFFFF signature, matching
    `minhash([])`.  Host-vectorized: one [T, n_perm] mix + a reduceat —
    this is the bulk LSH backfill path (per-doc `minhash` costs ~50µs of
    numpy dispatch; a 4096-doc chunk through here costs ~6µs/doc)."""
    n_docs = len(offsets)
    if n_docs == 0:
        return np.empty((0, n_perm), dtype=np.uint32)
    seeds = perm_seeds(n_perm)
    total = len(flat_hashes)
    if total == 0:
        return np.full((n_docs, n_perm), _U32, dtype=np.uint32)
    # a trailing all-max row keeps every offset a valid index (offsets[d]
    # may equal `total` for trailing empty docs) and is neutral under min
    # for the final segment, which reduceat extends to the end of the array
    mixed = np.empty((total + 1, n_perm), dtype=np.uint32)
    np.bitwise_xor(
        flat_hashes.astype(np.uint32)[:, None], seeds[None, :],
        out=mixed[:total],
    )
    _mix32_inplace(mixed[:total])
    mixed[total] = _U32
    offsets = np.asarray(offsets, dtype=np.int64)
    sigs = np.minimum.reduceat(mixed, offsets, axis=0)
    # reduceat returns the element AT the offset for an interior empty
    # segment (offsets[d] == offsets[d+1] < total) — overwrite those
    ends = np.append(offsets[1:], total)
    empty = ends <= offsets
    if empty.any():
        sigs[empty] = _U32
    return sigs.astype(np.uint32)


# ------------------------------------------------------------------ device
#
# The JAX package's device path (`_device_segment_min`, a jitted
# [T_pad, n_perm] mix + sorted `segment_min` over power-of-two buckets)
# is one hand-written kernel here, `csrc/minhash.cu`.  It takes the doc
# starts as they are, so there is no padding and no host "tail fix" for a
# last doc that the JAX version's padding would merge with.

_SEEDS_DEV: dict = {}


def _seeds_on(n_perm: int, device: torch.device) -> torch.Tensor:
    """`perm_seeds(n_perm)` as int32 bits on `device`, uploaded once."""
    key = (n_perm, str(device))
    s = _SEEDS_DEV.get(key)
    if s is None:
        s = torch.from_numpy(perm_seeds(n_perm).view(np.int32)).to(device)
        _SEEDS_DEV[key] = s
    return s


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the constant is split
    into 16-bit halves and the high half's product is cut to the 16 bits
    that survive the shift, so no intermediate reaches 2^63 (torch has no
    full uint32 arithmetic, and int64 overflow is not relied on)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _mix32_torch(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 values in [0, 2^32) (`_mix32_inplace`)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _as_u32_i64(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> the uint32 values they hold, as int64."""
    return bits.long() & _U32


def _as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def segment_min_plain(hashes: torch.Tensor, offsets: torch.Tensor,
                      n_perm: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: hashes [T] int32 (uint32
    bits), offsets [D] int64 doc starts (no trailing total; doc d spans
    [offsets[d], offsets[d + 1]) and the last doc runs to T; empty docs
    anywhere) -> signatures [D, n_perm] int32 bits, with
    out[d, p] = min over doc d's tokens of fmix32(hash ^ seed[p]) and
    0xFFFFFFFF for an empty doc.  Mixes tiles of at most
    `_HOST_BLOCK_TOKENS` tokens in int64 and reduces each with
    `scatter_reduce(..., "amin")`."""
    dev = hashes.device
    T, D = hashes.shape[0], offsets.shape[0]
    out = torch.full((D, n_perm), _U32, dtype=torch.int64, device=dev)
    if T and D:
        seeds = _as_u32_i64(_seeds_on(n_perm, dev))
        offs = offsets.long()
        for t0 in range(0, T, _HOST_BLOCK_TOKENS):
            t1 = min(t0 + _HOST_BLOCK_TOKENS, T)
            pos = torch.arange(t0, t1, device=dev)
            # each token's doc: the last doc starting at or before it (an
            # empty doc shares its start with the next one); tokens before
            # the first start belong to no doc
            seg = torch.searchsorted(offs, pos, right=True) - 1
            keep = seg >= 0
            h = _as_u32_i64(hashes[t0:t1][keep])
            mixed = _mix32_torch(h[:, None] ^ seeds[None, :])
            idx = seg[keep][:, None].expand(-1, n_perm)
            out.scatter_reduce_(0, idx, mixed, "amin", include_self=True)
    return _as_i32_bits(out)


_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
             + [ctypes.c_int] + [ctypes.c_void_p] * 2)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.cozo_minhash_segments.argtypes is None:
        lib.cozo_minhash_segments.argtypes = _ARGTYPES
        lib.cozo_minhash_segments.restype = ctypes.c_int
    return lib


def _segment_min_launch(lib, hashes, offsets, seeds, n_perm: int, out,
                        stream) -> None:
    """Enqueues the kernel on `stream` for checked arguments."""
    err = lib.cozo_minhash_segments(
        hashes.data_ptr(), offsets.data_ptr(), hashes.shape[0],
        offsets.shape[0], seeds.data_ptr(), n_perm, out.data_ptr(), stream)
    _build.check(lib, err, "minhash launch")


def segment_min(hashes: torch.Tensor, offsets: torch.Tensor, n_perm: int,
                out: torch.Tensor) -> torch.Tensor:
    """Signatures of `segment_min_plain`'s function written into `out`
    [D, n_perm] int32.  CUDA tensors launch `csrc/minhash.cu` (counted in
    `segment_min.launches`) on the current stream, without a sync; CPU
    tensors run `segment_min_plain`.  Raises on what the kernel does not
    take.  Returns `out`."""
    if n_perm < 1:
        raise ValueError("segment_min: n_perm must be >= 1")
    if hashes.dim() != 1 or offsets.dim() != 1:
        raise ValueError("segment_min: hashes [T] and offsets [D]")
    if tuple(out.shape) != (offsets.shape[0], n_perm):
        raise ValueError(f"segment_min: out must be [{offsets.shape[0]}, "
                         f"{n_perm}], got {tuple(out.shape)}")
    if (hashes.dtype != torch.int32 or offsets.dtype != torch.int64
            or out.dtype != torch.int32):
        raise ValueError("segment_min: int32 hashes and out, int64 offsets")
    if hashes.device.type == "cpu":
        if offsets.device.type != "cpu" or out.device.type != "cpu":
            raise ValueError("segment_min: tensors on different devices")
        out.copy_(segment_min_plain(hashes, offsets, n_perm))
        return out
    for t in (hashes, offsets, out):
        if (t.device.type != "cuda" or t.device != hashes.device
                or not t.is_contiguous()):
            raise ValueError(f"segment_min: every tensor must be contiguous "
                             f"on the card, on one device; got {t.device} / "
                             f"contiguous={t.is_contiguous()}")
    if hashes.shape[0] >= 1 << 31 or offsets.shape[0] >= 1 << 31:
        raise ValueError("segment_min: T and D must be below 2^31")
    lib = _bind(_build.load("minhash"))
    with torch.cuda.device(hashes.device):
        _segment_min_launch(
            lib, hashes, offsets, _seeds_on(n_perm, hashes.device), n_perm,
            out, torch.cuda.current_stream(hashes.device).cuda_stream)
    segment_min.launches += 1
    return out


segment_min.launches = 0


# flip to device only when the mix+min work dwarfs the transfers
DEVICE_MIN_TOKENS = 16_384


def _device_wanted() -> bool:
    """`COZO_TPU_LSH_DEVICE=0` forces the host path, as in the JAX package."""
    return os.environ.get("COZO_TPU_LSH_DEVICE", "1") != "0"


class _SigFuture:
    """Async minhash result: `get()` materializes.  On the card the
    signatures are copied back into a pinned host buffer of this dispatch
    alone, and `get()` waits on the event recorded after that copy, so the
    caller overlaps its host work (KV put loops) with the kernel and the
    copy.  The dispatch's pinned inputs are held until then."""

    def __init__(self, value, event=None, keep=()) -> None:
        self._v = value  # np.ndarray, or the pinned int32 host tensor
        self._event = event
        self._keep = keep

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._v = self._v.numpy().view(np.uint32)
            self._event = None
            self._keep = ()
        return self._v


def _dispatch(flat_hashes: np.ndarray, offsets: np.ndarray, n_perm: int,
              dev: torch.device) -> _SigFuture:
    """Uploads one chunk through pinned buffers of its own, launches the
    kernel on the current stream and starts the copy back."""
    h = torch.from_numpy(
        np.ascontiguousarray(flat_hashes, dtype=np.uint32).view(np.int32))
    offs = torch.from_numpy(np.ascontiguousarray(offsets, dtype=np.int64))
    if dev.type == "cpu":
        out = torch.empty((len(offs), n_perm), dtype=torch.int32)
        segment_min(h, offs, n_perm, out)
        return _SigFuture(out.numpy().view(np.uint32))
    h_pin = h.pin_memory()
    o_pin = offs.pin_memory()
    with torch.cuda.device(dev):
        h_dev = h_pin.to(dev, non_blocking=True)
        o_dev = o_pin.to(dev, non_blocking=True)
        out = torch.empty((len(offs), n_perm), dtype=torch.int32, device=dev)
        segment_min(h_dev, o_dev, n_perm, out)
        host = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return _SigFuture(host, event, (h_pin, o_pin, h_dev, o_dev, out))


def minhash_segments_device(
    flat_hashes: np.ndarray, offsets: np.ndarray, n_perm: int,
    device: DeviceLike = None,
) -> np.ndarray:
    """Device variant of `minhash_segments` (bit-identical output): the
    mix + per-doc min as one launch of `csrc/minhash.cu` on `device`
    (None: the card; "cpu": `segment_min_plain`)."""
    n_docs = len(offsets)
    total = len(flat_hashes)
    if n_docs == 0:
        return np.empty((0, n_perm), dtype=np.uint32)
    if total == 0:
        return np.full((n_docs, n_perm), _U32, dtype=np.uint32)
    return _dispatch(flat_hashes, offsets, n_perm,
                     default_device(device)).get()


def minhash_segments_auto(
    flat_hashes: np.ndarray, offsets: np.ndarray, n_perm: int,
    device: DeviceLike = None,
) -> np.ndarray:
    """Pick the device segment-min or the host (numpy reduceat) by size."""
    if len(flat_hashes) >= DEVICE_MIN_TOKENS and _device_wanted():
        return minhash_segments_device(flat_hashes, offsets, n_perm, device)
    return minhash_segments(flat_hashes, offsets, n_perm)


def minhash_segments_dispatch(
    flat_hashes: np.ndarray, offsets: np.ndarray, n_perm: int,
    device: DeviceLike = None,
) -> _SigFuture:
    """Async variant of `minhash_segments_auto`: returns at once with a
    future; on the device path the kernel and the copy back are queued but
    not waited for, so the backfill overlaps chunk K's kernel with chunk
    K-1's KV writes."""
    n_docs = len(offsets)
    total = len(flat_hashes)
    if (
        total < DEVICE_MIN_TOKENS
        or n_docs == 0
        or total == 0
        or not _device_wanted()
    ):
        return _SigFuture(minhash_segments(flat_hashes, offsets, n_perm))
    return _dispatch(flat_hashes, offsets, n_perm, default_device(device))


def find_optimal_params(
    threshold: float, n_perm: int, fp_weight: float, fn_weight: float
) -> Tuple[int, int]:
    """Choose (n_bands, rows_per_band) minimizing weighted FP+FN probability
    mass (reference `minhash_lsh.rs:259-289`, quadrature over the S-curve)."""
    s = np.linspace(0.0, 1.0, 201)
    ds = s[1] - s[0]
    best = (1, n_perm)
    best_err = math.inf
    for r in range(1, n_perm + 1):
        b = n_perm // r
        if b < 1:
            break
        p = 1.0 - (1.0 - s**r) ** b  # P(candidate | similarity s)
        fp = float(np.trapezoid(p[s <= threshold], dx=ds))
        fn = float(np.trapezoid(1.0 - p[s >= threshold], dx=ds))
        err = fp_weight * fp + fn_weight * fn
        if err < best_err:
            best_err = err
            best = (b, r)
    return best


def band_keys(signature: np.ndarray, n_bands: int, rows_per_band: int) -> List[bytes]:
    out = []
    for i in range(n_bands):
        chunk = signature[i * rows_per_band : (i + 1) * rows_per_band]
        out.append(chunk.tobytes())
    return out


def jaccard_estimate(sig_a: np.ndarray, sig_b: np.ndarray) -> float:
    return float(np.mean(sig_a == sig_b))
