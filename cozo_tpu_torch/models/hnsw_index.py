"""Device-resident HNSW index model (counterpart of
`cozo_tpu/models/hnsw_index.py`).

The hierarchy of proximity graphs is held as *padded neighbor arrays*
per level (`[n_l, m_max]` int32, -1 padded), with vectors in one dense
`[n, dim]` matrix.  Construction follows the reference algorithm (random
geometric levels, greedy descent + ef_construction beam + the
neighbor-selection heuristic with extend_candidates /
keep_pruned_connections, bidirectional links with neighbor shrinking).
The host graph code is the JAX package's, copied: the same seed gives the
same graph in both packages.

Device work runs on `device` (the card unless the index was made with
device="cpu"): the chunked sweep (`ops/exact_knn.py`) serves large
batches, and `bulk_build` runs the device build (`ops/bulk_build.py`).
`to_state` / `from_state` carry an index across as plain numpy arrays
and ints.
"""

from __future__ import annotations

import math
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

DIST_L2 = "L2"
DIST_IP = "IP"
DIST_COSINE = "Cosine"

# Largest f32 sweep table (rows x d_pad x 4 bytes = T) that `search` and
# `bulk_build` keep on the device; past it they take the int8 table
# (ops/quant_knn.py, `_build_step_i8`).  Sized for one 80 GB card (79.6 GiB
# usable) on which everything one index can hold there is resident at once:
#   the f32 table                                              T
#   its bf16 copy (fused lane) and int8 copy (i8 lane)         T/2 + T/4
#   the beam search's mirror: f32 rows padded to a power of    <= 2 T
#     two (up to twice the rows), unpadded width
#   the mirror's neighbour lists, (m0 + levels x m) x 4 bytes  <= 1.75 T
#     a row (448 at m = 16 with 5 upper levels) on up to twice
#     the rows: as large as the rows themselves at d_pad = 128
#   one batch's score slab at B = 16,384: [B, 131,072] f32 is
#     16,384 x 131,072 x 4 B = 8 GiB.  The f32, bf16 and i8
#     lanes write none (their chunk steps select inside
#     `ops/exact_knn.sweep_topk`'s kernels, to d_pad 4,096);
#     its two-step route (d_pad > 4,096, or kc > 256: a k or a
#     re-rank past 256 at any width) writes one a chunk, which
#     `select_topk` biases (and rescales) as it reads it.  The
#     slab's size does not depend on d_pad, and kc > 256 still
#     reaches the route at every width: kept for that route     8 GiB
#   headroom: the products' library workspace, the allocator's
#     cache and fragmentation, the merge and re-rank buffers   20 GiB
# 5.5 T + 28 GiB <= 79.6 GiB gives T <= 9.3 GiB: the JAX package's 8 GiB
# stays, now for this sum and not for a 16 GB device.  The environment
# variable COZO_TPU_F32_TABLE_MAX overrides it.
F32_TABLE_MAX = 8 << 30


def f32_table_budget() -> int:
    return int(os.environ.get("COZO_TPU_F32_TABLE_MAX", F32_TABLE_MAX))


class HnswIndex:
    def __init__(
        self,
        dim: int,
        m: int = 16,
        ef_construction: int = 200,
        distance: str = DIST_L2,
        dtype=np.float32,
        extend_candidates: bool = False,
        keep_pruned_connections: bool = False,
        seed: int = 42,
        device=None,
    ) -> None:
        self.device = device  # resolved at the first device call
        self.dim = dim
        self.m = m
        self.m_max = m
        self.m_max0 = 2 * m
        self.ef_construction = ef_construction
        self.distance = distance
        self.dtype = np.dtype(dtype)
        self.extend_candidates = extend_candidates
        self.keep_pruned_connections = keep_pruned_connections
        self.rng = random.Random(seed)
        self.level_mult = 1.0 / math.log(m)

        cap = 1024
        self.vectors = np.zeros((cap, dim), dtype=self.dtype)
        self.norms = np.zeros(cap, dtype=np.float64)  # squared norms
        self.levels = np.full(cap, -1, dtype=np.int32)  # -1 = unused slot
        self.alive = np.zeros(cap, dtype=bool)
        self.n = 0
        # per level: [cap, m_max(l)] neighbor slots, -1 padded
        self.neighbors: List[np.ndarray] = [
            np.full((cap, self.m_max0), -1, dtype=np.int32)
        ]
        self.entry: int = -1  # slot of entry point (highest level)
        self.version = 0
        self._free: List[int] = []
        # slots whose adjacency changed since last KV sync
        self.dirty: set = set()
        # slots changed since the device mirror was last refreshed
        self.dev_pending: set = set()
        # slots whose vector/alive state changed (sweep table maintenance)
        self.sweep_pending: set = set()
        # device serving table (ops/exact_knn.SweepTable), made on first use
        self._sweep_table = None
        # mesh-sharded serving table (COZO_TPU_MESH), rebuilt on version
        self._mesh_sweep = None
        self._mesh_sweep_version = -1
        # int8 serving table past the f32 budget (ops/quant_knn)
        self._quant_sweep = None
        self._quant_sweep_version = -1
        # device mirror for the beam search (ops/vector_search)
        self._dev_cache = None

    # ------------------------------------------------------------------ state

    _STATE_ARRAYS = ("vectors", "norms", "levels", "alive")
    _STATE_SCALARS = (
        "dim", "n", "entry", "version", "m", "m_max", "m_max0",
        "ef_construction", "distance", "level_mult", "extend_candidates",
        "keep_pruned_connections",
    )

    def to_state(self) -> dict:
        """The index as plain numpy arrays and Python scalars: what an
        index of either package needs to serve and insert exactly as this
        one does."""
        state = {k: np.array(getattr(self, k)) for k in self._STATE_ARRAYS}
        state.update({k: getattr(self, k) for k in self._STATE_SCALARS})
        state["neighbors"] = [np.array(nb) for nb in self.neighbors]
        state["_free"] = list(self._free)
        state["dtype"] = self.dtype.str
        state["rng"] = self.rng.getstate()
        return state

    @classmethod
    def from_state(cls, state: dict, device=None) -> "HnswIndex":
        idx = cls(
            dim=int(state["dim"]), m=int(state["m"]),
            ef_construction=int(state["ef_construction"]),
            distance=state["distance"], dtype=np.dtype(state["dtype"]),
            device=device,
        )
        for k in cls._STATE_ARRAYS:
            setattr(idx, k, np.array(state[k]))
        for k in cls._STATE_SCALARS:
            setattr(idx, k, state[k])
        idx.neighbors = [np.array(nb) for nb in state["neighbors"]]
        idx._free = list(state["_free"])
        idx.rng.setstate(state["rng"])
        return idx

    # ------------------------------------------------------------------ sizing

    def __len__(self) -> int:
        return self.n

    def _grow(self, need: int) -> None:
        cap = self.vectors.shape[0]
        if need <= cap:
            return
        new_cap = max(cap * 2, need)
        self.vectors = np.resize(self.vectors, (new_cap, self.dim))
        self.norms = np.resize(self.norms, new_cap)
        new_levels = np.full(new_cap, -1, dtype=np.int32)
        new_levels[:cap] = self.levels
        self.levels = new_levels
        new_alive = np.zeros(new_cap, dtype=bool)
        new_alive[:cap] = self.alive
        self.alive = new_alive
        for l, nb in enumerate(self.neighbors):
            grown = np.full((new_cap, nb.shape[1]), -1, dtype=np.int32)
            grown[:cap] = nb
            self.neighbors[l] = grown

    def _ensure_level(self, level: int) -> None:
        cap = self.vectors.shape[0]
        while len(self.neighbors) <= level:
            self.neighbors.append(np.full((cap, self.m_max), -1, dtype=np.int32))

    # raw-slot helpers used only by a cache rebuild from a KV image
    # (runtime/hnsw.py, runtime/hnsw_packed.py)

    def _alloc_slot(self, v, level: int) -> int:
        v = self._prep(v)
        slot = self.n
        self._grow(slot + 1)
        self.n = slot + 1
        self.vectors[slot] = v
        self.norms[slot] = float(v.astype(np.float64) @ v.astype(np.float64))
        self.levels[slot] = level
        self.alive[slot] = True
        self._ensure_level(level)
        self.version += 1
        return slot

    def _append_neighbor(self, level: int, frm: int, to: int) -> None:
        self._ensure_level(level)
        row = self.neighbors[level][frm]
        for i in range(row.shape[0]):
            if row[i] == to:
                return
            if row[i] < 0:
                row[i] = to
                return

    def random_level(self) -> int:
        # reference hnsw.rs:46-52 (negated: here 0 is the bottom)
        u = self.rng.random()
        while u <= 0.0:
            u = self.rng.random()
        return int(-math.log(u) * self.level_mult)

    # --------------------------------------------------------------- distances

    def _prep(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, dtype=self.dtype).reshape(-1)
        if v.shape[0] != self.dim:
            raise ValueError(f"vector dim {v.shape[0]} != index dim {self.dim}")
        return v

    def dists_to(self, q: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Distances from one query to many stored slots (vectorized)."""
        vs = self.vectors[slots]
        if self.distance == DIST_L2:
            d = vs - q
            return np.einsum("ij,ij->i", d, d, dtype=np.float64)
        dots = vs @ q.astype(self.dtype)
        if self.distance == DIST_IP:
            return 1.0 - dots.astype(np.float64)
        qd = q.astype(np.float64)
        qn = float(qd @ qd)
        denom = np.sqrt(self.norms[slots] * qn)
        denom = np.where(denom > 0, denom, 1.0)
        return 1.0 - dots.astype(np.float64) / denom

    def dists_batch(
        self, qs: np.ndarray, slots: np.ndarray, dtype=np.float64
    ) -> np.ndarray:
        """qs [B, d]; slots [B, K] → [B, K] distances (invalid slots = +inf).
        dtype=float32 matches the reference's f32 distance math
        (VectorCache::dist, hnsw.rs:66-109) at half the memory traffic."""
        valid = slots >= 0
        safe = np.where(valid, slots, 0)
        vs = self.vectors[safe].astype(dtype)  # [B, K, d]
        qd = qs.astype(dtype)  # [B, d]
        if self.distance == DIST_L2:
            d = vs - qd[:, None, :]
            out = np.einsum("bkd,bkd->bk", d, d)
        else:
            dots = np.einsum("bkd,bd->bk", vs, qd)
            if self.distance == DIST_IP:
                out = 1.0 - dots
            else:
                qn = np.einsum("bd,bd->b", qd, qd)
                denom = np.sqrt(self.norms[safe] * qn[:, None])
                denom = np.where(denom > 0, denom, 1.0)
                out = 1.0 - dots / denom
        return np.where(valid, out, np.inf)

    # ----------------------------------------------------------------- insert

    def insert(self, vec, level: Optional[int] = None) -> int:
        """Insert one vector; returns its slot id."""
        v = self._prep(vec)
        if level is None:
            level = self.random_level()
        if self._free:
            slot = self._free.pop()
        else:
            slot = self.n
            self._grow(slot + 1)
        self.n = max(self.n, slot + 1)
        self.vectors[slot] = v
        self.norms[slot] = float(v.astype(np.float64) @ v.astype(np.float64))
        self.levels[slot] = level
        self.alive[slot] = True
        self.dirty.add(slot)
        self.dev_pending.add(slot)
        self.sweep_pending.add(slot)
        self._ensure_level(level)
        for l in range(level + 1):
            self.neighbors[l][slot, :] = -1
        self.version += 1

        if self.entry < 0:
            self.entry = slot
            return slot

        q = v
        ep = self.entry
        top = int(self.levels[self.entry])
        # greedy descent above the node's level
        for l in range(top, level, -1):
            ep = self._greedy_search(q, ep, l)
        # beam insert at each level
        for l in range(min(level, top), -1, -1):
            cands = self._beam_search(q, [ep], l, self.ef_construction)
            selected = self._select_neighbors(q, cands, l)
            mmax = self.m_max0 if l == 0 else self.m_max
            self._set_neighbors(l, slot, selected[: mmax])
            for nb in selected[: mmax]:
                self._add_link(l, nb, slot)
            if cands:
                ep = cands[0][1]
        if level > top:
            self.entry = slot
        return slot

    def _greedy_search(self, q: np.ndarray, ep: int, level: int) -> int:
        nb = self.neighbors[level]
        cur = ep
        cur_d = float(self.dists_to(q, np.array([cur]))[0])
        while True:
            ns = nb[cur]
            ns = ns[ns >= 0]
            if len(ns) == 0:
                return cur
            ds = self.dists_to(q, ns)
            i = int(np.argmin(ds))
            if ds[i] < cur_d:
                cur = int(ns[i])
                cur_d = float(ds[i])
            else:
                return cur

    def _beam_search(
        self, q: np.ndarray, eps: List[int], level: int, ef: int
    ) -> List[Tuple[float, int]]:
        """Single-query beam search; returns sorted (dist, slot) candidates."""
        import heapq

        nb = self.neighbors[level]
        visited = np.zeros(self.vectors.shape[0], dtype=bool)
        eps_a = np.asarray(eps, dtype=np.int64)
        visited[eps_a] = True
        d0 = self.dists_to(q, eps_a)
        cand = [(float(d), int(e)) for d, e in zip(d0, eps)]
        heapq.heapify(cand)
        result = [
            (-float(d), int(e)) for d, e in zip(d0, eps) if self.alive[e]
        ] or [(-float(d), int(e)) for d, e in zip(d0, eps)]
        heapq.heapify(result)
        heappush, heappop = heapq.heappush, heapq.heappop
        while cand:
            d, c = heappop(cand)
            if d > -result[0][0] and len(result) >= ef:
                break
            ns = nb[c]
            ns = ns[ns >= 0]
            if ns.size == 0:
                continue
            new = ns[~visited[ns]]
            if new.size == 0:
                continue
            visited[new] = True
            ds = self.dists_to(q, new)
            worst = -result[0][0]
            full = len(result) >= ef
            for nd, nn in zip(ds.tolist(), new.tolist()):
                if not full or nd < worst:
                    heappush(cand, (nd, nn))
                    heappush(result, (-nd, nn))
                    if len(result) > ef:
                        heappop(result)
                        full = True
                    worst = -result[0][0]
        return sorted((-d, s) for d, s in result)

    def _select_neighbors(
        self, q: np.ndarray, cands: List[Tuple[float, int]], level: int
    ) -> List[int]:
        """Reference neighbor-selection heuristic (`hnsw.rs:470-537`)."""
        mmax = self.m_max0 if level == 0 else self.m_max
        pool = list(cands)
        if self.extend_candidates:
            seen = {s for _, s in pool}
            nb = self.neighbors[level]
            extra = set()
            for _, s in cands:
                for x in nb[s]:
                    if x >= 0 and int(x) not in seen:
                        extra.add(int(x))
            if extra:
                extra = list(extra)
                ds = self.dists_to(q, np.array(extra))
                pool.extend((float(d), s) for d, s in zip(ds, extra))
            pool.sort()
        # one vectorized sweep per SELECTED node: when c is selected, mark
        # every remaining candidate that lies closer to c than to q as
        # dominated (equivalent to the reference's per-candidate check)
        cand_ids = np.array([c for _, c in pool], dtype=np.int64)
        cand_d = np.array([d for d, _ in pool])
        ok_mask = self.alive[cand_ids]
        dominated = np.zeros(len(pool), dtype=bool)
        selected: List[int] = []
        pruned: List[int] = []
        for i in range(len(pool)):
            if not ok_mask[i]:
                continue
            if dominated[i]:
                pruned.append(int(cand_ids[i]))
                continue
            c = int(cand_ids[i])
            selected.append(c)
            if len(selected) >= mmax:
                break
            rest = slice(i + 1, len(pool))
            if rest.start < len(pool):
                dc = self.dists_to(self.vectors[c], cand_ids[rest])
                dominated[rest] |= dc < cand_d[rest]
        if self.keep_pruned_connections:
            for c in pruned:
                if len(selected) >= mmax:
                    break
                selected.append(c)
        return selected

    def _set_neighbors(self, level: int, slot: int, neighbors: List[int]) -> None:
        mmax = self.m_max0 if level == 0 else self.m_max
        self.dirty.add(slot)
        self.dev_pending.add(slot)
        row = self.neighbors[level][slot]
        row[:] = -1
        row[: min(len(neighbors), mmax)] = neighbors[:mmax]

    def _add_link(self, level: int, frm: int, to: int) -> None:
        mmax = self.m_max0 if level == 0 else self.m_max
        self.dirty.add(frm)
        self.dev_pending.add(frm)
        row = self.neighbors[level][frm]
        for i in range(mmax):
            if row[i] == to:
                return
            if row[i] < 0:
                row[i] = to
                return
        # overfull: keep the mmax closest (cheap prune; the full selection
        # heuristic still shapes each node's own out-links at insert time)
        existing = np.append(row[:mmax], np.int32(to))
        q = self.vectors[frm]
        ds = self.dists_to(q, existing)
        keep = np.argpartition(ds, mmax - 1)[:mmax]
        row[:] = existing[keep]

    # ----------------------------------------------------------------- remove

    def remove(self, slot: int) -> None:
        """Unlink + entry repair (reference `hnsw.rs:754-867`)."""
        if slot < 0 or not self.alive[slot]:
            return
        self.alive[slot] = False
        self.dirty.add(slot)
        self.dev_pending.add(slot)
        self.sweep_pending.add(slot)
        level = int(self.levels[slot])
        for l in range(min(level, len(self.neighbors) - 1) + 1):
            nb = self.neighbors[l]
            # remove in-links from this node's neighbors (cheap local pass)
            for x in nb[slot]:
                if x >= 0:
                    row = nb[int(x)]
                    row[row == slot] = -1
                    self.dirty.add(int(x))
                    self.dev_pending.add(int(x))
            nb[slot, :] = -1
        self.levels[slot] = -1
        self._free.append(slot)
        self.version += 1
        if self.entry == slot:
            # entry repair: highest-level alive node
            alive_idx = np.nonzero(self.alive[: self.n])[0]
            if len(alive_idx) == 0:
                self.entry = -1
            else:
                self.entry = int(alive_idx[np.argmax(self.levels[alive_idx])])

    # ----------------------------------------------------------------- search

    def search(
        self,
        queries: np.ndarray,
        k: int,
        ef: int,
        use_tpu: Optional[bool] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched k-NN; queries [B, d] → (slots [B, k], dists [B, k]);
        missing results padded with -1/inf."""
        qs = np.asarray(queries, dtype=self.dtype)
        if qs.ndim == 1:
            qs = qs[None, :]
        B = qs.shape[0]
        if self.entry < 0:
            return (
                np.full((B, k), -1, dtype=np.int64),
                np.full((B, k), np.inf),
            )
        if use_tpu is None:
            use_tpu = self.n >= 20_000 and B >= 4
        # opt-in mesh serving (COZO_TPU_MESH, or a mesh installed with
        # `parallel.mesh.set_serving_mesh`): the row-sharded exact sweep
        # with a gathered top-k merge.  No fallback: a mesh that fails to
        # build or to search raises.
        from ..parallel.mesh import serving_mesh

        mesh = serving_mesh()
        if mesh is not None:
            ss = self._mesh_sweep
            if ss is None or self._mesh_sweep_version != self.version:
                from ..parallel.mesh import ShardedSweep

                ss = ShardedSweep(mesh, self)
                self._mesh_sweep = ss
                self._mesh_sweep_version = self.version
            return ss.search(qs, k)
        if use_tpu:
            # past the f32 budget: the int8-quantized sweep + host f32
            # re-rank (ops/quant_knn.py)
            d_pad = max(128, -(-self.dim // 128) * 128)
            if int(self.n) * d_pad * 4 > f32_table_budget():
                from ..ops.quant_knn import QuantSweepTable, quant_search

                qt = self._quant_sweep
                if qt is None or self._quant_sweep_version != self.version:
                    qt = QuantSweepTable(self.device).load(
                        self.vectors[: self.n], self.distance,
                        alive=self.alive[: self.n],
                    )
                    self._quant_sweep = qt
                    self._quant_sweep_version = self.version
                return quant_search(
                    self.vectors, qt, qs, k, sq_norms=self.norms
                )
            # Large query batches (or single-chunk tables): the chunked
            # sweep (ops/exact_knn.py).  Small batches on big tables take
            # the beam-search kernel (reads O(B·beam·m) rows, not the
            # table).
            if B >= 64 or self.n <= 131_072:
                from ..ops.exact_knn import sweep_search

                return sweep_search(self, qs, k)
            from ..ops.vector_search import hnsw_search_device

            return hnsw_search_device(self, qs, k, ef)
        out_ids = np.full((B, k), -1, dtype=np.int64)
        out_d = np.full((B, k), np.inf)
        top = int(self.levels[self.entry])
        for b in range(B):
            q = qs[b]
            ep = self.entry
            for l in range(top, 0, -1):
                ep = self._greedy_search(q, ep, l)
            res = self._beam_search(q, [ep], 0, max(ef, k))
            res = [(d, s) for d, s in res if self.alive[s]][:k]
            for i, (d, s) in enumerate(res):
                out_ids[b, i] = s
                out_d[b, i] = d
        return out_ids, out_d

    def _bf_candidates(self, batch: np.ndarray, k: int):
        """Exact top-k against the built prefix via the device brute-force
        search, padded to pow2 buckets (as the JAX version)."""
        from ..ops.vector_search import brute_force_knn, _pad_pow2

        n = self.n
        n_pad = _pad_pow2(max(n, 1))
        vecs = np.zeros((n_pad, self.dim), dtype=np.float32)
        vecs[:n] = self.vectors[:n].astype(np.float32)
        norms = np.full(n_pad, np.inf)
        norms[:n] = self.norms[:n]
        if self.distance == "L2":
            # padding rows are all-zero; give them +inf norms so they sort last
            pass
        ids, dists = brute_force_knn(vecs, norms, batch.astype(np.float32), k,
                                     self.distance, device=self.device)
        ids = np.where(ids < n, ids, -1)
        alive = self.alive[np.where(ids >= 0, ids, 0)]
        ids = np.where((ids >= 0) & alive, ids, -1)
        return ids, np.where(ids >= 0, dists, np.inf)

    def _bf_candidates_np(self, batch: np.ndarray, k: int):
        n = self.n
        vs = self.vectors[:n]
        qs = batch.astype(self.dtype)
        if self.distance == "L2":
            sq = self.norms[:n]
            d = (
                np.einsum("bd,bd->b", qs.astype(np.float64), qs.astype(np.float64))[:, None]
                + sq[None, :]
                - 2.0 * (qs @ vs.T).astype(np.float64)
            )
        else:
            dots = (qs @ vs.T).astype(np.float64)
            if self.distance == "IP":
                d = 1.0 - dots
            else:
                qn = np.sqrt(np.einsum("bd,bd->b", qs, qs).astype(np.float64))
                denom = np.outer(qn, np.sqrt(self.norms[:n]))
                denom = np.where(denom > 0, denom, 1.0)
                d = 1.0 - dots / denom
        d = np.where(self.alive[:n][None, :], d, np.inf)
        k = min(k, n)
        part = np.argpartition(d, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(pd, axis=1)
        ids = np.take_along_axis(part, order, axis=1)
        return ids.astype(np.int64), np.take_along_axis(pd, order, axis=1)

    # ------------------------------------------------------------ bulk build

    def bulk_build(
        self,
        vectors: np.ndarray,
        wave: int = 512,
        use_tpu: Optional[bool] = None,
    ) -> List[int]:
        """Wave-batched bulk construction (SURVEY.md §7.4: insert B vectors
        per wave instead of per-row MVCC writes).

        The first wave seeds the graph with sequential reference inserts;
        every later wave batch-searches the already-built graph for all W
        new vectors at once (one device call), adds intra-wave brute-force
        candidates (one matmul), then runs the selection heuristic and
        bidirectional linking on the host.  Returns slot ids in order."""
        data = np.asarray(vectors, dtype=self.dtype)
        n_new = data.shape[0]
        if n_new == 0:
            return []
        if n_new <= wave or self.n > 0:
            # small builds / incremental tails: reference-faithful inserts
            return [self.insert(v) for v in data]
        if use_tpu is not False and n_new >= 4096 and not self._free:
            # device-centric construction: sweep-exact candidates + batched
            # selection heuristic + vectorized reverse links (ops/bulk_build)
            from ..ops.bulk_build import bulk_build_device

            return bulk_build_device(self, data, wave=max(wave, 2048))
        ef = self.ef_construction
        # seed wave: sequential
        slots = [self.insert(v) for v in data[:wave]]
        pos = wave
        while pos < n_new:
            end = min(pos + wave, n_new)
            batch = data[pos:end]
            W = end - pos
            # candidates from the built part: exact brute force — numpy for
            # small prefixes (compile-free), device matmul+top_k for larger
            # ones, batched beam search beyond the brute-force budget
            if self.n <= 16_384 and use_tpu is not True:
                cand_ids, cand_d = self._bf_candidates_np(batch, min(ef, self.n))
            elif self.n <= 262_144:
                cand_ids, cand_d = self._bf_candidates(batch, min(ef, self.n))
            else:
                cand_ids, cand_d = self.search(batch, k=ef, ef=ef, use_tpu=use_tpu)
            # intra-wave brute-force candidates (earlier peers only)
            bf = batch.astype(np.float64)
            if self.distance == DIST_L2:
                sq = np.einsum("id,id->i", bf, bf)
                intra = sq[:, None] + sq[None, :] - 2.0 * (bf @ bf.T)
            else:
                dots = bf @ bf.T
                if self.distance == DIST_IP:
                    intra = 1.0 - dots
                else:
                    nrm = np.sqrt(np.einsum("id,id->i", bf, bf))
                    denom = np.outer(nrm, nrm)
                    denom = np.where(denom > 0, denom, 1.0)
                    intra = 1.0 - dots / denom

            new_slots = []
            for j in range(W):
                v = batch[j]
                level = self.random_level()
                if self._free:
                    slot = self._free.pop()
                else:
                    slot = self.n
                    self._grow(slot + 1)
                self.n = max(self.n, slot + 1)
                self.vectors[slot] = v
                self.norms[slot] = float(
                    v.astype(np.float64) @ v.astype(np.float64)
                )
                self.levels[slot] = level
                self.alive[slot] = True
                self.dirty.add(slot)
                self.dev_pending.add(slot)
                self.sweep_pending.add(slot)
                self._ensure_level(level)
                for l in range(level + 1):
                    self.neighbors[l][slot, :] = -1
                new_slots.append(slot)

            n_peer = min(ef, W)
            for j in range(W):
                slot = new_slots[j]
                level = int(self.levels[slot])
                pool = [
                    (float(d), int(c))
                    for d, c in zip(cand_d[j], cand_ids[j])
                    if c >= 0
                ]
                if j > 0:
                    peer_d = intra[j, :j]
                    if j > n_peer:
                        nearest = np.argpartition(peer_d, n_peer - 1)[:n_peer]
                    else:
                        nearest = np.arange(j)
                    pool.extend(
                        (float(peer_d[i]), new_slots[i]) for i in nearest
                    )
                pool.sort()
                del pool[ef:]  # heuristic only ever consumes ~ef candidates
                for l in range(level, -1, -1):
                    cands_l = [
                        (d, c) for d, c in pool if self.levels[c] >= l
                    ]
                    if not cands_l:
                        continue
                    mmax = self.m_max0 if l == 0 else self.m_max
                    selected = self._select_neighbors(v, cands_l, l)
                    self._set_neighbors(l, slot, selected[:mmax])
                    for nb_ in selected[:mmax]:
                        self._add_link(l, nb_, slot)
                if level > int(self.levels[self.entry]):
                    self.entry = slot
            slots.extend(new_slots)
            self.version += 1
            pos = end
        return slots
