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

Lanes: `f32` (exact), `bf16` (+ exact re-rank, or raw), and `fused` (the
CUDA kernel of `ops/fused_sweep.py`, always re-ranked).  The int8 lane is
not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import default_device, mm_bf16, to_device
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


def _sweep(tbl: torch.Tensor, bias: torch.Tensor, qs_in: torch.Tensor,
           k: int, compute_dtype: str, rerank_k: int = 0,
           metric: str = "IP", d_in: int = 0) -> torch.Tensor:
    """Counterpart of `_sweep_fn`.  rerank_k > 0: over-fetch rerank_k
    candidates in the scan, then re-score them in true f32 (L2 in the
    cancellation-free diff form) and return the exact top-k.  Returns
    the packed int32 [B, 2k'] (ids | score bits)."""
    n_chunks, chunk, d_pad = tbl.shape
    kf = max(k, rerank_k)
    qs = qs_in.float()
    if d_in and d_in < d_pad:
        qs = torch.nn.functional.pad(qs, (0, d_pad - d_in))
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
    alld = torch.cat(nds, dim=1)
    alli = torch.cat(nis, dim=1)
    if alld.shape[1] == kf:
        bs, bi = alld, alli
    else:
        bs, sel = torch.topk(alld, min(kf, alld.shape[1]))
        bi = torch.gather(alli, 1, sel)
    if rerank_k <= 0:
        return torch.cat([bi.to(torch.int32), bs.view(torch.int32)], dim=1)
    valid = (bi >= 0) & torch.isfinite(bs)
    return rerank_pack(tbl.reshape(-1, d_pad), qs, bi, valid, k, metric)


class SweepTable:
    """Device-resident chunked score table for one index, incrementally
    maintained from the host index's dirty-slot set."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.version = -1
        self.tbl: Optional[torch.Tensor] = None
        self.bias: Optional[torch.Tensor] = None
        self.chunk = 0
        self.n_chunks = 0
        self.d_pad = 0
        # capacity hint: size chunking for this many rows up-front so a
        # growing bulk build keeps one table shape
        self.reserve = 0
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
        if self.version == index.version:
            return
        n = max(index.n, 1, self.reserve)
        chunk, n_chunks = _chunking(n)
        d = index.dim
        d_pad = max(128, int(math.ceil(d / 128) * 128))
        pending = index.sweep_pending
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
        self.version = index.version
        index.sweep_pending.clear()

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
        if compute_dtype == "i8":
            raise NotImplementedError(
                "compute_dtype='i8' is not ported yet (ROADMAP port item: "
                "i8 sweep lane)"
            )
        self.refresh(index)
        d = index.dim
        q = np.asarray(qs, dtype=np.float32)
        B = q.shape[0]
        # f16 query upload as in the JAX package, so the lanes score the
        # same inputs in both; the f32 lane stays bit-exact
        qdt = np.float16 if compute_dtype in ("bf16", "fused") else np.float32
        if qdt == np.float16 and index.distance != "Cosine":
            # f16 overflows to inf past 65504 and every score in the
            # affected row goes inf/NaN.  Cosine queries are normalized
            # below; L2/IP keep f32 for out-of-range batches.
            amax = float(np.max(np.abs(q))) if q.size else 0.0
            if not (amax < 6.0e4):  # also catches nan/inf inputs
                qdt = np.float32
        qp = np.empty((B, d), dtype=qdt)
        if index.distance == "Cosine":
            nrm = np.linalg.norm(q, axis=1, keepdims=True)
            nrm = np.where(nrm > 0, nrm, 1.0)
            qp[:] = q / nrm
        else:
            qp[:] = q
        # overfetch width: k+16 covers bf16 rank noise at the 0.999
        # operating point
        rerank_k = (
            min(max(rerank_k or 0, k + 16), self.n_chunks * self.chunk)
            if exact_rerank
            else 0
        )
        q_dev = to_device(qp, self.device)
        if compute_dtype == "fused":
            # fused scoring + segment-top2 (ops/fused_sweep.py): the score
            # slab never reaches device memory.  Always exact-reranked.
            if self.fused_version != self.version or self.tbl_fused is None:
                self.tbl_fused, self.bias_fused = _fs.prep(self.tbl, self.bias)
                self.fused_version = self.version
            packed_d = _fs.serve(
                self.tbl_fused, self.bias_fused, self.tbl, q_dev, k,
                max(rerank_k, k + 16), index.distance, d, self.d_pad,
            )
            exact_rerank = True
        else:
            packed_d = _sweep(
                self.tbl, self.bias, q_dev, k, compute_dtype,
                rerank_k=rerank_k, metric=index.distance, d_in=d,
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
