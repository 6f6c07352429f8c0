"""Device-resident chunked k-NN sweep (counterpart of
`cozo_tpu/ops/exact_knn.py`) — the serving path for large-batch vector
search.

Layout: the table lives on the device as [n_chunks, CHUNK, d_pad] f32
with a score bias [n_chunks, CHUNK] (0 alive, -inf dead/padding).  A loop
over chunks computes the scores (f32, or bf16 inputs with f32 results)
and keeps each chunk's top candidates; ONE top-k merges them, then an
exact f32 re-rank of the over-fetched candidates.  Where the JAX version
calls `lax.approx_max_k`, this one calls `torch.topk`, which is exact.
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

import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import (default_device, int_mm, mm_bf16,
                            prepare_queries, quantize_i8, to_device)
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


def merge_chunks(nds, nis, kf: int):
    """The best kf of the per-chunk candidates (scores, global ids)."""
    alld = torch.cat(nds, dim=1)
    alli = torch.cat(nis, dim=1)
    if alld.shape[1] == kf:
        return alld, alli
    bs, sel = torch.topk(alld, min(kf, alld.shape[1]))
    return bs, torch.gather(alli, 1, sel)


def _sweep(tbl: torch.Tensor, bias: torch.Tensor, qs: torch.Tensor,
           k: int, compute_dtype: str, rerank_k: int = 0,
           metric: str = "IP") -> torch.Tensor:
    """Counterpart of `_sweep_fn`; `qs` [B, d_pad] f32 as
    `prepare_queries` gives them.  rerank_k > 0: over-fetch rerank_k
    candidates in the scan, then re-score them in true f32 (L2 in the
    cancellation-free diff form) and return the exact top-k.  Returns
    the packed int32 [B, 2k'] (ids | score bits)."""
    n_chunks, chunk, d_pad = tbl.shape
    kf = max(k, rerank_k)
    kc = min(kf, chunk)
    nds, nis = [], []
    for c in range(n_chunks):
        if compute_dtype == "bf16":
            s = mm_bf16(qs, tbl[c])
        else:
            s = qs @ tbl[c].T
        s += bias[c]
        nd, ni = torch.topk(s, kc)
        del s  # free the [B, chunk] slab before the next chunk's
        nds.append(nd)
        nis.append(ni + c * chunk)
    bs, bi = merge_chunks(nds, nis, kf)
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
    chunk, rescaled by the row and query scales, biased and rounded to a
    bf16 slab as the JAX lane does; per-chunk top candidates, one merge,
    then the same exact f32 re-rank of the over-fetched candidates as
    `_sweep`.  `qs` / `q_i8` / `q_scale` come from `prepare_queries`."""
    n_chunks, chunk, d_pad = tbl.shape
    kf = max(k, rerank_k)
    kc = min(kf, chunk)
    nds, nis = [], []
    for c in range(n_chunks):
        s = int_mm(q_i8, tbl_i8[c]).float()
        s *= scale[c][None, :]
        s *= q_scale[:, None]
        s += bias[c][None, :]
        nd, ni = torch.topk(s.to(torch.bfloat16), kc)
        del s
        nds.append(nd)
        nis.append(ni + c * chunk)
    bs, bi = merge_chunks(nds, nis, kf)
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
            packed_d = _sweep(
                self.tbl, self.bias, prepared, k, compute_dtype,
                rerank_k=rerank_k, metric=index.distance,
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
