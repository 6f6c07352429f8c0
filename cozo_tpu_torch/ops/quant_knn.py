"""int8-quantized chunked sweep (counterpart of `cozo_tpu/ops/quant_knn.py`)
— vector serving for tables whose f32 rows do not fit on the device beside
their serving copies (`COZO_TPU_F32_TABLE_MAX` in `models/hnsw_index.py`).

Design (ScaNN-family asymmetric scoring):
  - storage: per-row max-abs scale s_r = max|v_i|/127, rows quantized to
    int8; scales stay f32.  Cosine rows are L2-normalized first.
  - scan: int8 x int8 product (int32 accumulate) per chunk, rescaled by
    s_r and the per-query scale, top-kf per chunk, one end merge.
  - re-rank: the over-fetched candidate ids are re-scored on the host
    against the f32 vectors (which stay in host RAM), restoring exact
    top-k order.

Differences from the JAX module: the per-chunk selection is the exact
`exact_knn.select_topk` (the hand kernel `csrc/slab_topk.cu`, which
rescales and biases the int32 products as it reads them) where JAX calls
`lax.approx_max_k`.  An exact top-k has no un-aggregated form, so every chunk gives exactly kf candidates and the JAX
module's `_AGG_CHUNKS` switch (aggregate per chunk past 16 chunks, defer
to the end merge below) has no counterpart here.  Queries are uploaded as
f32 and normalised and quantised on the device
(`utils/device.prepare_queries`).
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..utils.device import (default_device, int_mm, PendingPull,
                            prepare_queries, to_device)
from .exact_knn import (_chunk_buffers, _chunking, _cols, merge_chunks,
                        select_topk)


def _qsweep(tbl_i8: torch.Tensor, scales: torch.Tensor, bias: torch.Tensor,
            qs_i8: torch.Tensor, q_scale: torch.Tensor, kf: int) -> torch.Tensor:
    """score = (q_i8 . row_i8) * scale_row * scale_q + bias_row (counterpart
    of `_qsweep_fn`; an f32 slab, not the bf16 slab of the sweep's i8 lane).

    The per-query scale and the additive per-row bias make L2 servable:
    with rows stored as v (scales doubled at load) and bias = -||v||^2,
    score = 2 q.v - ||v||^2 which ranks -||q-v||^2 per query.  IP/Cosine
    use bias 0 (dead rows -inf).  Returns the packed int32 [B, 2 kf]
    (ids | score bits)."""
    n_chunks, chunk, _ = tbl_i8.shape
    kc = min(kf, chunk)
    bufs = _chunk_buffers(qs_i8.shape[0], n_chunks, kc, torch.float32,
                          qs_i8.device)
    for c in range(n_chunks):
        s = int_mm(qs_i8, tbl_i8[c])
        select_topk(s, kc, col_scale=scales[c], row_scale=q_scale,
                    bias=bias[c], offset=c * chunk, out=_cols(bufs, c, kc))
        del s  # free the [B, chunk] slab before the next chunk's
    ss, ii = merge_chunks(*bufs, kf)
    return torch.cat([ii.to(torch.int32), ss.view(torch.int32)], dim=1)


class QuantSweepTable:
    """Device-resident int8 table + scales for one index/matrix."""

    def __init__(self, device=None) -> None:
        self.device = device  # resolved at load (the card unless given)
        self.tbl = None  # [n_chunks, chunk, d_pad] int8 on device
        self.scales = None  # [n_chunks, chunk] f32 (0 = dead row)
        self.bias = None  # [n_chunks, chunk] f32 (-inf = dead; L2: -||v||^2)
        self.chunk = self.n_chunks = self.d_pad = 0
        self.n = 0
        self.distance = "Cosine"
        self.version = -1

    @staticmethod
    def quantize_rows(vecs: np.ndarray, distance: str,
                      alive: Optional[np.ndarray] = None,
                      out_q: Optional[np.ndarray] = None,
                      out_s: Optional[np.ndarray] = None,
                      out_b: Optional[np.ndarray] = None):
        """Returns (q_rows int8 [n, d], scales f32 [n], bias f32 [n]) in
        scoring form: score(q, r) = (q_i8 . r_i8) * scales[r] * scale_q
        + bias[r] monotonically ranks the true metric for a fixed query
        (cosine/IP: descending dot, bias 0; L2: scales doubled, bias
        -||v||^2 so score = 2 q.v - ||v||^2 = ||q||^2 - ||q - v||^2).

        Processes in row blocks, so a large table never needs several
        whole-array f32 temporaries.  ``out_q``/``out_s``/``out_b`` let
        callers pass preallocated (possibly padded) destinations."""
        n, d = vecs.shape
        q = out_q if out_q is not None else np.empty((n, d), dtype=np.int8)
        scale = out_s if out_s is not None else np.empty(n, dtype=np.float32)
        bias = out_b if out_b is not None else np.zeros(n, dtype=np.float32)
        BLK = 262_144
        for s0 in range(0, n, BLK):
            v = np.asarray(vecs[s0 : s0 + BLK], dtype=np.float32)
            if distance == "Cosine":
                nrm = np.linalg.norm(v, axis=1, keepdims=True)
                v = v / np.where(nrm > 0, nrm, 1.0)
            mx = np.abs(v).max(axis=1)
            sc = np.where(mx > 0, mx / 127.0, 1.0).astype(np.float32)
            q[s0 : s0 + len(v), :d] = np.clip(
                np.rint(v / sc[:, None]), -127, 127
            )
            if distance == "L2":
                sc = sc * 2.0
                bias[s0 : s0 + len(v)] = -np.einsum(
                    "bd,bd->b", v, v, dtype=np.float64
                )
            else:
                bias[s0 : s0 + len(v)] = 0.0
            scale[s0 : s0 + len(v)] = sc
        if alive is not None:
            scale[:n] = np.where(alive[:n], scale[:n], 0.0)
            bias[:n] = np.where(alive[:n], bias[:n], -np.inf)
        return q, scale, bias

    def load(self, vecs: np.ndarray, distance: str,
             alive: Optional[np.ndarray] = None, chunk: Optional[int] = None):
        dev = default_device(self.device)
        self.device = dev
        n, d = vecs.shape
        self.n, self.distance = n, distance
        self.d_pad = max(128, int(math.ceil(d / 128) * 128))
        if chunk is None:
            chunk, n_chunks = _chunking(n)
        else:
            n_chunks = -(-n // chunk)
        self.chunk, self.n_chunks = chunk, n_chunks
        total = chunk * n_chunks
        # quantize straight into the padded staging arrays (no [n, d]
        # intermediate copy; see quantize_rows block processing)
        qp = np.zeros((total, self.d_pad), dtype=np.int8)
        sp = np.zeros(total, dtype=np.float32)
        bp = np.full(total, -np.inf, dtype=np.float32)  # padding rows dead
        self.quantize_rows(
            vecs, distance, alive,
            out_q=qp[:n, :d], out_s=sp[:n], out_b=bp[:n],
        )
        self.tbl = to_device(qp, dev).view(n_chunks, chunk, self.d_pad)
        self.scales = to_device(sp, dev).view(n_chunks, chunk)
        self.bias = to_device(bp, dev).view(n_chunks, chunk)
        return self

    def quantize_queries(self, qs: np.ndarray):
        """(q_i8 [B, d_pad] int8, per-query scale f32 [B]), on the device:
        f32 upload through pinned memory, then cosine normalise, max-abs
        scale and rounding there."""
        q = to_device(np.ascontiguousarray(qs, dtype=np.float32), self.device)
        _, q_i8, scale = prepare_queries(q, self.distance, self.d_pad,
                                         quantize=True)
        return q_i8, scale

    def search_candidates(self, qs: np.ndarray, kf: int, rt: float = 0.95):
        """(ids [B, kf], approx scores) from the quantized scan; `rt` is
        accepted for parity with the JAX signature (the selection here is
        exact).  Ids and scores come back in one pinned pull."""
        q_i8, q_scale = self.quantize_queries(qs)
        packed = PendingPull(_qsweep(self.tbl, self.scales, self.bias,
                                     q_i8, q_scale, kf)).numpy()
        kk = packed.shape[1] // 2
        ids = packed[:, :kk].astype(np.int64)
        sc = np.ascontiguousarray(packed[:, kk:]).view(np.float32)
        bad = (ids < 0) | (ids >= self.n) | ~np.isfinite(sc)
        return np.where(bad, -1, ids), sc


def quant_search(vectors: np.ndarray, table: QuantSweepTable, qs: np.ndarray,
                 k: int, overfetch: Optional[int] = None, rt: float = 0.95,
                 sq_norms: Optional[np.ndarray] = None):
    """End-to-end: int8 device scan over-fetching overfetch*k candidates,
    exact f32 re-rank on the host against `vectors` (the full-precision
    rows, host-resident).  Returns (ids [B, k], dists [B, k]) with the
    index's distance semantics (cosine/L2 distance / negative IP).

    overfetch default 4 (env COZO_TPU_QUANT_OVERFETCH): the host side of
    the re-rank (a [B, kf, d] gather + einsum) scales linearly with kf.

    `sq_norms`: precomputed squared row norms (HnswIndex.norms) — saves
    a full [B, kf, d] pass recomputing candidate norms for Cosine.

    With COZO_TPU_SEARCH_TIMING=1 the scan (with its pull) and the host
    re-rank seconds are printed, and kept in `quant_search.last_timing`."""
    timing = os.environ.get("COZO_TPU_SEARCH_TIMING") == "1"
    if overfetch is None:
        overfetch = int(os.environ.get("COZO_TPU_QUANT_OVERFETCH", 4))
    kf = min(max(k * overfetch, k), table.chunk)
    t0 = time.time()
    ids, _ = table.search_candidates(qs, kf, rt)
    t_scan = time.time()
    B = qs.shape[0]
    q = np.asarray(qs, dtype=np.float32)
    if table.distance == "Cosine":
        qn = np.linalg.norm(q, axis=1, keepdims=True)
        q = q / np.where(qn > 0, qn, 1.0)
    safe = np.where(ids >= 0, ids, 0)
    # [B, kf, d] gather — the rerank's hot cost.  Past a few million rows
    # the table is tens of GB and a random-order gather pays a TLB/page
    # miss per row; fetching in ascending row order then unpermuting is
    # the JAX package's remedy, kept with its threshold
    if vectors.shape[0] >= int(
        os.environ.get("COZO_TPU_SORTED_GATHER_MIN", 4_000_000)
    ):
        flat = safe.ravel()
        order = np.argsort(flat, kind="stable")
        g = vectors[flat[order]]
        out = np.empty_like(g)
        out[order] = g
        cand = out.reshape(safe.shape[0], safe.shape[1], vectors.shape[1])
    else:
        cand = vectors[safe]
    if table.distance == "Cosine":
        dots = np.einsum("bkd,bd->bk", cand, q, dtype=np.float32)
        if sq_norms is not None:
            cn = np.sqrt(sq_norms[safe]).astype(np.float32)
        else:
            cn = np.sqrt(
                np.einsum("bkd,bkd->bk", cand, cand, dtype=np.float32)
            )
        sims = dots / np.where(cn > 0, cn, 1.0)
        d = 1.0 - sims
    elif table.distance == "L2":
        diff = cand - q[:, None, :]  # promotes to f32 (q is f32)
        d = np.einsum("bkd,bkd->bk", diff, diff, dtype=np.float32)
    else:  # IP
        d = -np.einsum("bkd,bd->bk", cand, q, dtype=np.float32)
    d = np.where(ids >= 0, d, np.inf)
    sel = np.argsort(d, axis=1, kind="stable")[:, :k]
    out_ids = np.take_along_axis(ids, sel, axis=1)
    out_d = np.take_along_axis(d, sel, axis=1)
    quant_search.last_timing = (t_scan - t0, time.time() - t_scan)
    if timing:
        print(
            f"# quant_search B={B} kf={kf}: scan+pull "
            f"{t_scan - t0:.3f}s rerank {time.time() - t_scan:.3f}s",
            flush=True,
        )
    return out_ids, out_d


quant_search.last_timing = None
