"""Device-side bulk HNSW construction (counterpart of
`cozo_tpu/ops/bulk_build.py`), driven by the chunked sweep
(`ops/exact_knn.py`):

  per wave of W vectors:
    1. scatter the wave into the device sweep table, in place (capacity
       reserved up-front);
    2. one sweep pass = exact top-P candidates for all W vectors at once
       (the kNN-graph + RNG-prune construction family);
    3. the neighbor-selection heuristic runs on the device batched over
       the wave (pairwise candidate distances from one batched product on
       the sweep-table rows; the dominance scan is sequential over P);
    4. reverse links + overflow shrink are vectorized numpy using link
       distances carried from the sweep (no per-edge Python).

  The host half of a wave runs while the device computes the next one.
  Upper levels (6%/0.4%/... of nodes at m=16) keep the per-node host
  heuristic — they are too few to matter.

Where the JAX version calls `lax.approx_max_k` (rt=0.9), this one calls
`torch.topk`, which is exact.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..utils.device import default_device, mm_bf16, PendingPull, to_device
from .exact_knn import SweepTable, _chunking


def _select(tbl: torch.Tensor, bias: torch.Tensor, pool_ids: torch.Tensor,
            pool_d: torch.Tensor, mmax: int, metric: str) -> torch.Tensor:
    """Batched neighbor-selection heuristic (counterpart of `_select_fn`).

    Inputs: sweep table (transformed rows + bias), pool_ids [W, P] (-1 =
    invalid, sorted by pool_d ascending), pool_d [W, P].
    Output: sel mask [W, P] — reference semantics: scan candidates in
    distance order; candidate r is dominated if it lies closer to an
    already-selected s than to the query (pair(r, s) < pool_d[r])."""
    d_pad = tbl.shape[-1]
    flat = tbl.reshape(-1, d_pad)
    bflat = bias.reshape(-1)
    safe = torch.where(pool_ids >= 0, pool_ids, torch.zeros_like(pool_ids))
    safe = safe.long()
    rows = flat[safe]  # [W, P, d_pad]
    b = bflat[safe]  # [W, P]
    dots = torch.bmm(rows, rows.transpose(1, 2))
    if metric == "L2":
        pair = -b[:, :, None] - b[:, None, :] - dots * 0.5
    else:
        pair = 1.0 - dots
    valid = (pool_ids >= 0) & torch.isfinite(pool_d)
    W, P = pool_ids.shape
    dominated = torch.zeros((W, P), dtype=torch.bool, device=tbl.device)
    count = torch.zeros((W,), dtype=torch.int32, device=tbl.device)
    sel = torch.zeros((W, P), dtype=torch.bool, device=tbl.device)
    for i in range(P):
        can = (~dominated[:, i]) & (count < mmax) & valid[:, i]
        sel[:, i] = can
        count += can.to(torch.int32)
        dominated |= can[:, None] & (pair[:, i, :] < pool_d)
    return sel


def _build_step(tbl: torch.Tensor, bias: torch.Tensor, new_rows: torch.Tensor,
                new_bias: torch.Tensor, slots: torch.Tensor, P: int,
                mmax: int, metric: str) -> torch.Tensor:
    """One device step per wave (counterpart of `_build_step_fn`):
    scatter the wave's rows into the resident table IN PLACE (the JAX
    version donates the buffers), sweep the whole table for each wave
    vector's top-P candidates (self-match masked), and run the batched
    selection heuristic.  Returns the packed int32 [W, 3P]
    (ids | dist bits | sel)."""
    n_chunks, chunk, d_pad = tbl.shape
    tbl.view(-1, d_pad).index_put_((slots,), new_rows)
    bias.view(-1).index_put_((slots,), new_bias)
    # query form from storage form: L2 rows are 2v (q·row = 2 q·v);
    # cosine/IP rows are the (normalized) vectors themselves
    qs = new_rows * 0.5 if metric == "L2" else new_rows

    nds, nis = [], []
    for c in range(n_chunks):
        s = mm_bf16(qs, tbl[c])
        s += bias[c]
        nd, ni = torch.topk(s, P + 1)
        del s  # free the [W, chunk] slab before the next chunk's
        nds.append(nd)
        nis.append(ni + c * chunk)
    alld = torch.cat(nds, dim=1)
    alli = torch.cat(nis, dim=1)
    if alld.shape[1] == P + 1:
        scores, ids = alld, alli
    else:
        scores, sel_t = torch.topk(alld, P + 1)
        ids = torch.gather(alli, 1, sel_t)
    # mask self-matches, keep top P
    scores = torch.where(ids == slots[:, None],
                         torch.full_like(scores, -math.inf), scores)
    scores, ti = torch.topk(scores, P)
    pool_ids = torch.gather(ids, 1, ti)
    if metric == "L2":
        qn = torch.sum(qs * qs, dim=1, keepdim=True)
        pool_d = qn - scores
    else:
        pool_d = 1.0 - scores
    pool_d = torch.where(torch.isfinite(scores), pool_d,
                         torch.full_like(pool_d, math.inf))
    sel = _select(tbl, bias, pool_ids, pool_d, mmax, metric)
    return torch.cat(
        [pool_ids.to(torch.int32), pool_d.float().view(torch.int32),
         sel.to(torch.int32)],
        dim=1,
    )


def bulk_build_device(index, data: np.ndarray, wave: int = 4096,
                      pool_size: Optional[int] = None) -> list:
    """Fresh build of `index` (must be empty) from `data` on the index's
    device. Returns slots."""
    assert index.n == 0 and not index._free
    dev = default_device(index.device)
    n_new = data.shape[0]
    dt = index.dtype
    data = np.asarray(data, dtype=dt)

    m0 = index.m_max0
    efc = index.ef_construction
    P = pool_size or min(max(efc, 2 * m0), 96)
    # reserve capacity so the sweep table keeps one shape for this build;
    # the device table starts as zeros ON DEVICE (dead bias) — vectors
    # cross the host→device link exactly once, wave by wave
    index._grow(n_new)
    chunk, n_chunks = _chunking(n_new)
    d_pad = max(128, int(math.ceil(index.dim / 128) * 128))
    # past the f32 budget the JAX build runs on an int8 table
    budget = int(os.environ.get("COZO_TPU_F32_TABLE_MAX", 8 << 30))
    if n_chunks * chunk * d_pad * 4 > budget:
        raise NotImplementedError(
            "int8 bulk build (f32 table past COZO_TPU_F32_TABLE_MAX) is not "
            "ported yet (ROADMAP port item: quant lane + i8 build)"
        )
    st = SweepTable(dev)
    st.reserve = n_new
    index._sweep_table = st
    st.chunk, st.n_chunks, st.d_pad = chunk, n_chunks, d_pad
    st.tbl = torch.zeros((n_chunks, chunk, d_pad), dtype=torch.float32,
                         device=dev)
    st.bias = torch.full((n_chunks, chunk), -math.inf, dtype=torch.float32,
                         device=dev)

    # level 0 link bookkeeping (vectorized reverse links need distances)
    cap = index.vectors.shape[0]
    nb0_count = np.zeros(cap, dtype=np.int32)
    link_d0 = np.full((cap, m0), np.inf, dtype=np.float32)

    # vectorized level sampling (reference hnsw.rs:46-52 distribution)
    rng = np.random.default_rng(index.rng.randrange(1 << 63))
    u = rng.random(n_new)
    u = np.where(u <= 0.0, 0.5, u)
    levels = (-np.log(u) * index.level_mult).astype(np.int32)

    log = os.environ.get("COZO_TPU_BUILD_LOG") == "1"
    slots_all = np.arange(n_new, dtype=np.int64)
    pos = 0
    tstate = [time.time()]
    pending = None

    def _process_wave(*args):
        _bulk_process_wave(
            index, data, levels, nb0_count, link_d0, P, m0, cap, n_new,
            wave, log, tstate, *args,
        )

    while pos < n_new:
        end = min(pos + wave, n_new)
        W = end - pos
        slots = slots_all[pos:end]
        batch = data[pos:end]

        # -- 1. register the wave in the host index (vectorized)
        index.vectors[pos:end] = batch
        b64 = batch.astype(np.float64)
        index.norms[pos:end] = np.einsum("id,id->i", b64, b64)
        index.levels[pos:end] = levels[pos:end]
        index.alive[pos:end] = True
        index.n = end
        max_l = int(levels[pos:end].max(initial=0))
        index._ensure_level(max_l)
        index.version += 1

        # -- 2+3. ONE device step: scatter wave rows into the resident
        # table, sweep-search candidates (self-masked), run the batched
        # selection heuristic.  Padded slots repeat slots[0] with its
        # identical row, so duplicate scatter writes agree.
        t_ph = time.time()
        rows_w, bias_w = SweepTable._prep_rows(index, slots)
        w_pad = wave
        if W < w_pad:
            rows_w = np.concatenate(
                [rows_w, np.repeat(rows_w[:1], w_pad - W, axis=0)]
            )
            bias_w = np.concatenate([bias_w, np.repeat(bias_w[:1], w_pad - W)])
        slots_p = np.full(w_pad, slots[0], dtype=np.int64)
        slots_p[:W] = slots
        packed_d = _build_step(
            st.tbl, st.bias, to_device(rows_w, dev),
            to_device(np.ascontiguousarray(bias_w), dev),
            to_device(slots_p, dev), P, m0, index.distance,
        )
        st.version = index.version
        index.sweep_pending.clear()
        pull = PendingPull(packed_d)
        ph_dispatch = time.time() - t_ph
        # -- pipeline: process the PREVIOUS wave's results while this
        # wave computes on the device
        if pending is not None:
            _process_wave(*pending)
        pending = (slots, pos, end, W, pull, ph_dispatch)
        pos = end

    if pending is not None:
        _process_wave(*pending)
    return slots_all.tolist()


def _bulk_process_wave(index, data, levels, nb0_count, link_d0, P, m0,
                       cap, n_new, wave, log, tstate,
                       slots, pos, end, W, pull, ph_dispatch):
    """Host half of one build wave: wait for the packed device results
    and apply out-links, vectorized reverse links, overflow shrink, and
    the upper-level heuristic.  Runs while the NEXT wave's device step is
    in flight (see the pipeline note in `bulk_build_device`)."""
    t_ph = time.time()
    batch = data[pos:end]
    packed = pull.numpy()[:W]
    pool_ids = packed[:, :P].astype(np.int64)
    pool_d = np.ascontiguousarray(packed[:, P : 2 * P]).view(np.float32)
    sel = packed[:, 2 * P :] != 0
    ph_pull = time.time() - t_ph
    t_ph = time.time()

    # -- 4. out-links + vectorized reverse links at level 0
    nb0 = index.neighbors[0]
    w_idx, p_idx = np.nonzero(sel)
    sel_frm = pool_ids[w_idx, p_idx].astype(np.int64)  # link target
    sel_d = pool_d[w_idx, p_idx]
    sel_to = slots[w_idx]

    # out-links: group by wave row (w_idx is sorted; positions within
    # each row are in distance order already)
    row_start = np.searchsorted(w_idx, np.arange(W))
    row_end = np.searchsorted(w_idx, np.arange(W) + 1)
    counts_out = (row_end - row_start).astype(np.int32)
    col = np.arange(len(w_idx)) - row_start[w_idx]
    keep = col < m0
    nb0[slots[w_idx[keep]], col[keep]] = sel_frm[keep]
    link_d0[slots[w_idx[keep]], col[keep]] = sel_d[keep]
    nb0_count[slots] = np.minimum(counts_out, m0)

    # reverse links: for each selected neighbor frm, append `to`.
    # Drop duplicate edges first (frm may be a wave peer whose
    # out-links already include `to`) so in-group positions are dense.
    in_wave = sel_frm >= pos
    dup = np.zeros(len(sel_frm), bool)
    if in_wave.any():
        iw = np.nonzero(in_wave)[0]
        dup[iw] = (nb0[sel_frm[iw]] == sel_to[iw, None]).any(axis=1)
    keep_rl = ~dup
    frm_order = np.argsort(sel_frm[keep_rl], kind="stable")
    r_frm = sel_frm[keep_rl][frm_order]
    r_to = sel_to[keep_rl][frm_order]
    r_d = sel_d[keep_rl][frm_order]
    uniq, grp_start, grp_counts = np.unique(
        r_frm, return_index=True, return_counts=True
    )
    cum = np.arange(len(r_frm)) - grp_start[
        np.searchsorted(uniq, r_frm)
    ]  # position within group
    base = nb0_count[r_frm]
    tgt = base + cum
    fits = tgt < m0
    overflow_mask = tgt >= m0
    nb0[r_frm[fits], tgt[fits]] = r_to[fits]
    link_d0[r_frm[fits], tgt[fits]] = r_d[fits]
    # counts reflect only appended-in-place entries:
    filled = np.zeros(cap, dtype=np.int32)
    np.add.at(filled, r_frm[fits], 1)
    nb0_count[uniq] = nb0_count[uniq] + filled[uniq]

    # overflow rows: shrink to the m0 closest using stored distances
    over = np.unique(r_frm[overflow_mask])
    if len(over) > 0:
        max_add = int(grp_counts.max())
        K = m0 + max_add
        cand_ids = np.full((len(over), K), -1, dtype=np.int64)
        cand_d = np.full((len(over), K), np.inf, dtype=np.float32)
        cand_ids[:, :m0] = nb0[over]
        cand_d[:, :m0] = link_d0[over]
        # gather this wave's additions per overflow row
        pos_of = {f: i for i, f in enumerate(over)}
        fill = np.zeros(len(over), dtype=np.int32)
        om = overflow_mask
        for f, t, dd in zip(r_frm[om], r_to[om], r_d[om]):
            i = pos_of[f]
            j = m0 + fill[i]
            if j < K:
                cand_ids[i, j] = t
                cand_d[i, j] = dd
                fill[i] += 1
        part = np.argpartition(cand_d, m0 - 1, axis=1)[:, :m0]
        sort_in = np.take_along_axis(cand_d, part, axis=1)
        srt = np.argsort(sort_in, axis=1, kind="stable")
        part = np.take_along_axis(part, srt, axis=1)
        nb0[over] = np.take_along_axis(cand_ids, part, axis=1)
        link_d0[over] = np.take_along_axis(cand_d, part, axis=1)
        nb0_count[over] = (nb0[over] >= 0).sum(axis=1).astype(np.int32)

    index.dirty.update(slots.tolist())
    index.dirty.update(np.unique(sel_frm).tolist())
    index.dev_pending.update(slots.tolist())
    index.dev_pending.update(np.unique(sel_frm).tolist())

    ph_links = time.time() - t_ph
    t_ph = time.time()

    # -- 5. upper levels: per-node host heuristic (few nodes)
    hi = np.nonzero(levels[pos:end] >= 1)[0]
    for j in hi.tolist():
        slot = int(slots[j])
        lvl = int(levels[pos + j])
        pool_l = [
            (float(d), int(c))
            for d, c in zip(pool_d[j], pool_ids[j])
            if c >= 0 and np.isfinite(d) and index.levels[c] >= 1
        ]
        for l in range(1, lvl + 1):
            cands_l = [(d, c) for d, c in pool_l if index.levels[c] >= l]
            if not cands_l:
                continue
            selected = index._select_neighbors(batch[j], cands_l, l)
            index._set_neighbors(l, slot, selected[: index.m_max])
            for nb_ in selected[: index.m_max]:
                index._add_link(l, nb_, slot)

    # entry point: highest level so far
    if index.entry < 0 or levels[pos:end].max(initial=-1) > int(
        index.levels[index.entry]
    ):
        index.entry = pos + int(np.argmax(levels[pos:end]))

    if log and (end // wave) % 16 == 0:
        el = time.time() - tstate[0]
        tstate[0] = time.time()
        ph_upper = time.time() - t_ph
        print(
            f"# bulk_build: {end}/{n_new} ({el/16:.2f}s/wave; last: "
            f"dispatch {ph_dispatch:.2f} pull {ph_pull:.2f} "
            f"links {ph_links:.2f} upper {ph_upper:.2f})",
            file=sys.stderr,
            flush=True,
        )
