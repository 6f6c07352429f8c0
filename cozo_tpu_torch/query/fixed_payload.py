"""Payload passed to fixed rules (reference `fixed_rule/mod.rs:47`):
uniform access to rule-store / stored-relation inputs plus options."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..data.program import (
    FixedRuleNamedRelArg,
    FixedRuleRelArg,
    FixedRuleRuleArg,
)
from ..data.value import cmp_key
from ..utils.errors import QueryError


def _undirected_merge(indptr, src_a, dst_a, out_deg):
    """(indptr_und, indices_und) for src ∪ reversed edges, given a
    src-grouped directed CSR — O(E), no 2E-element argsort (at the 10M
    node / 330M edge proximity graph that argsort is a 660M-element
    single-core sort: ~90s + 5.3GB of permutation temporaries).

    Ordering matches the old concat+stable-argsort output bit-for-bit:
    within each source's block, forward edges keep CSR order and precede
    reversed edges, which keep ascending original-edge order (the native
    counting sort in utils/graph_stage is stable)."""
    from ..utils.graph_stage import stage_by_dst

    nv = len(indptr) - 1
    e = len(dst_a)
    src_rev, _, in_deg = stage_by_dst(indptr, dst_a, nv)
    und_ptr = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(out_deg + in_deg, out=und_ptr[1:])
    indices = np.empty(2 * e, dtype=np.int64)
    ar = np.arange(e, dtype=np.int64)
    # forward: position = block start + rank within the src's CSR run
    indices[und_ptr[src_a] + (ar - indptr[src_a])] = dst_a
    # reversed: grouped by (original dst) already; rank via in-deg cumsum
    rev_start = np.zeros(nv, dtype=np.int64)
    if nv > 1:
        np.cumsum(in_deg[:-1], out=rev_start[1:])
    rev_src = np.repeat(np.arange(nv, dtype=np.int64), in_deg)
    indices[und_ptr[rev_src] + out_deg[rev_src] + (ar - rev_start[rev_src])] = src_rev
    return und_ptr, indices


class FixedInput:
    """One input relation of a fixed rule."""

    def __init__(self, arg, ctx) -> None:
        self.arg = arg
        self.ctx = ctx

    def rows(self) -> List[list]:
        arg, ctx = self.arg, self.ctx
        if isinstance(arg, FixedRuleRuleArg):
            store = ctx.stores.get(arg.name)
            if store is None:
                raise QueryError(f"input rule '{arg.name}' not found")
            return list(store.total.values())
        handle = ctx.tx.get_relation(arg.name)
        handle.ensure_can_read()
        tx = ctx.tx.store_tx_for(handle)
        if isinstance(arg, FixedRuleNamedRelArg):
            cols = [c for c, _ in arg.pairs]
            idxs = [handle.col_index(c) for c in cols]
            pins = getattr(arg, "pins", None) or []
            if not pins:
                return [[r[i] for i in idxs] for r in handle.scan_all(tx)]
            # constant pins: use a prefix scan when the pinned columns are
            # a key prefix (in order); remaining pins filter row-by-row
            key_names = [c.name for c in handle.keys]
            pin_map = dict(pins)
            prefix_vals = []
            npfx = 0
            for kn in key_names:
                if kn in pin_map:
                    prefix_vals.append(pin_map[kn])
                    npfx += 1
                else:
                    break
            rest = [
                (handle.col_index(c), v)
                for c, v in pins
                if c not in key_names[:npfx]
            ]
            it = (
                handle.scan_prefix(tx, prefix_vals)
                if prefix_vals
                else handle.scan_all(tx)
            )
            out = []
            for r in it:
                if all(r[i] == v for i, v in rest):
                    out.append([r[i] for i in idxs])
            return out
        if arg.validity is not None:
            vld = ctx.eval_vld(arg.validity)
            return list(handle.scan_at_validity(tx, [], vld))
        return list(handle.scan_all(tx))

    def arity(self) -> int:
        arg, ctx = self.arg, self.ctx
        if isinstance(arg, FixedRuleRuleArg):
            rows = self.rows()
            return len(rows[0]) if rows else len(arg.bindings)
        if isinstance(arg, FixedRuleNamedRelArg):
            return len(arg.pairs)
        return ctx.tx.get_relation(arg.name).arity

    def binding_map(self) -> Dict[str, int]:
        arg = self.arg
        if isinstance(arg, (FixedRuleRuleArg, FixedRuleRelArg)):
            return {b: i for i, b in enumerate(arg.bindings)}
        if isinstance(arg, FixedRuleNamedRelArg):
            return {
                (alias or col): i for i, (col, alias) in enumerate(arg.pairs)
            }
        return {}

    # --- graph adapters (reference `fixed_rule/mod.rs:136-328`) -------------

    def _int_pairs_fast(self):
        """Vectorized edge staging for the common whole-graph shape: a
        stored relation keyed by exactly two Int columns.  Int-Int keys
        memcmp-encode at a fixed 44-byte width (8B relation prefix + 2 x
        18B exact-int encodings), so the whole scan decodes as one numpy
        byte-matrix view instead of per-row Python decode — at 31M edges
        this is ~50x faster than decode_row.  Returns (src, dst) int64
        arrays or None when the shape doesn't apply."""
        arg, ctx = self.arg, self.ctx
        if not isinstance(arg, FixedRuleRelArg) or arg.validity is not None:
            return None
        handle = ctx.tx.get_relation(arg.name)
        handle.ensure_can_read()
        if len(handle.keys) != 2 or handle.values:
            return None
        for c in handle.keys:
            if c.typing is None or c.typing.kind != "Int" or c.typing.nullable:
                return None
        from ..runtime.relation import rel_prefix, rel_upper

        tx = ctx.tx.store_tx_for(handle)
        keys = tx.collect_keys(rel_prefix(handle.id), rel_upper(handle.id))
        if not keys:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        if len(keys[0]) != 44 or any(len(k) != 44 for k in keys[:256]):
            return None  # unexpected encoding: fall back to decode_row
        total = sum(map(len, keys))
        if total != 44 * len(keys):
            return None
        blob = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(-1, 44)

        def dec(cols):
            # stored = v + 2^63 (mod 2^64) == v XOR 2^63: flip the top bit
            u = blob[:, cols].copy().view(">u8").reshape(-1)
            u = u.astype("<u8") ^ np.uint64(1 << 63)
            return u.view(np.int64)

        return dec(slice(18, 26)), dec(slice(36, 44))

    def as_directed_graph(self, undirected: bool = False):
        """Returns (indptr, indices, vertices) as a numpy CSR over interned
        vertex ids — the host-side staging format for the TPU kernels.

        Staged CSRs cache per (relation, mutation-version): repeated
        whole-graph queries over an unmodified relation skip the scan and
        the CSR build entirely (the serving pattern — together with the
        device-array content cache a warm 32M-edge PageRank is pure
        device time)."""
        db = getattr(self.ctx, "db", None)
        ck = self._csr_cache_key(db, undirected)
        if ck is not None:
            got = db._csr_cache.get(ck)
            if got is not None:
                return got
        out = self._as_directed_graph_impl(undirected)
        if ck is not None:
            if len(db._csr_cache) >= 2:
                db._csr_cache.pop(next(iter(db._csr_cache)))
            db._csr_cache[ck] = out
        return out

    def _csr_cache_key(self, db, undirected):
        """Cache key for the staged CSR, or None when uncacheable.

        Covers plain stored relations AND the proximity-graph shape
        (`*rel:idx{layer: 0, fr_k, to_k}` named args): the 10M-node HNSW
        layer-0 staging is ~330M edges of numpy work per call, and warm
        PageRank/LabelPropagation re-paid it every run when only
        FixedRuleRelArg was cacheable."""
        if db is None or getattr(self.arg, "validity", None) is not None:
            return None
        if isinstance(self.arg, FixedRuleRelArg):
            ver = db._rel_versions.get(self.arg.name, 0)
            return (self.arg.name, ver, undirected, "csr")
        if (
            isinstance(self.arg, FixedRuleNamedRelArg)
            and ":" in self.arg.name
            and getattr(self.arg, "pins", None) == [("layer", 0)]
        ):
            base = self.arg.name.rsplit(":", 1)[0]
            ver = (
                db._rel_versions.get(self.arg.name, 0),
                db._rel_versions.get(base, 0),
            )
            cols = tuple(c for c, _ in self.arg.pairs)
            return (self.arg.name, cols, ver, undirected, "csr")
        return None

    def _hnsw_layer0_fast(self):
        """Proximity-graph staging straight from the in-memory HNSW
        adjacency: a named rel-arg over an index relation with pins
        `{layer: 0}` and columns `{fr_<key>, to_<key>}` (single-Int-key
        base) stages (src_ids, dst_ids) vectorized from the level-0
        neighbor arrays — no KV scan, no per-row decode.  Row-for-row
        equal to scanning the KV image (self-edges included: the image
        stores a `(0, k, k)` membership row per node, reference
        runtime/hnsw.rs:679).  Returns (src, dst) or None."""
        arg, ctx = self.arg, self.ctx
        if not isinstance(arg, FixedRuleNamedRelArg) or arg.validity is not None:
            return None
        if getattr(arg, "pins", None) != [("layer", 0)]:
            return None
        if ":" not in arg.name:
            return None
        db = getattr(ctx, "db", None)
        if db is None:
            return None
        base_name, idx_name = arg.name.rsplit(":", 1)
        try:
            base = ctx.tx.get_relation(base_name)
        except Exception:
            return None
        meta = base.indices.get(idx_name)
        if meta is None or meta.get("kind") != "hnsw":
            return None
        if len(base.keys) != 1:
            return None
        kn = base.keys[0].name
        if [c for c, _ in arg.pairs] != [f"fr_{kn}", f"to_{kn}"]:
            return None
        handle = ctx.tx.get_relation(arg.name)
        handle.ensure_can_read()
        from ..runtime.hnsw import get_hnsw_cache

        cache = get_hnsw_cache(db, ctx.tx, base, idx_name, meta)
        index = cache.index
        n = index.n
        if n == 0:
            z = np.empty(0, np.int64)
            return z, z, z, z
        ids = cache.slot_ids_array()
        alive = index.alive[:n]
        nb = index.neighbors[0][:n]
        # self-edge (membership row) as an extra first column so the
        # row-major nonzero yields src-sorted edges with no 660M argsort
        nbx = np.concatenate(
            [np.arange(n, dtype=nb.dtype)[:, None], nb], axis=1
        )
        valid = (nbx >= 0) & alive[:, None]
        valid &= np.where(nbx >= 0, index.alive[np.maximum(nbx, 0)], False)
        src_slots = np.repeat(
            np.arange(n, dtype=np.int64), valid.sum(axis=1)
        )
        dst_slots = nbx[valid].astype(np.int64)
        vert_slots = np.nonzero(alive)[0]  # == unique(src_slots)
        return src_slots, dst_slots, vert_slots, ids

    def _as_directed_graph_impl(self, undirected: bool = False):
        fast = self._hnsw_layer0_fast()
        if fast is not None:
            # slot-space CSR: vertex set = alive slots (every alive node
            # owns a self-edge), compacted by slot order — no np.unique
            # over the 2E-element id stream (at 10M x 33 that unique is
            # a 660M-element sort on one core)
            s_slots, d_slots, vert_slots, ids = fast
            # vertices: alive slots (src always includes every alive
            # slot via its self-edge; dst ⊆ alive slots)
            pos = np.full(
                int(vert_slots[-1]) + 1 if len(vert_slots) else 1,
                -1,
                dtype=np.int64,
            )
            pos[vert_slots] = np.arange(len(vert_slots), dtype=np.int64)
            src_a = pos[s_slots]
            del s_slots
            dst_a = pos[d_slots]
            del d_slots
            nv = len(vert_slots)
            # src_a is grouped ascending by construction (row-major
            # nonzero over the neighbor matrix) — bincount, not
            # np.add.at (which is ~50x slower at 330M edges)
            out_deg = np.bincount(src_a, minlength=nv)
            indptr = np.zeros(nv + 1, dtype=np.int64)
            np.cumsum(out_deg, out=indptr[1:])
            if undirected:
                indptr, dst_a = _undirected_merge(
                    indptr, src_a, dst_a, out_deg
                )
            verts = ids[vert_slots]
            return indptr, dst_a, [int(v) for v in verts]
        fast = self._int_pairs_fast()
        if fast is not None:
            s_raw, d_raw = fast
            vert_arr, inv = np.unique(
                np.concatenate([s_raw, d_raw]), return_inverse=True
            )
            src_a = inv[: len(s_raw)]
            dst_a = inv[len(s_raw) :]
            order = np.argsort(src_a, kind="stable")
            src_a, dst_a = src_a[order], dst_a[order]
            n = len(vert_arr)
            out_deg = np.bincount(src_a, minlength=n)
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(out_deg, out=indptr[1:])
            if undirected:
                # sort E directed edges, then O(E)-merge the reversed
                # half — cheaper than the old concat + 2E stable argsort
                indptr, dst_a = _undirected_merge(
                    indptr, src_a, dst_a, out_deg
                )
            return indptr, dst_a, [int(v) for v in vert_arr]
        rows = self.rows()
        verts: Dict[tuple, int] = {}
        vert_vals: List[Any] = []

        def intern(v):
            k = cmp_key(v)
            i = verts.get(k)
            if i is None:
                i = len(vert_vals)
                verts[k] = i
                vert_vals.append(v)
            return i

        src = []
        dst = []
        for r in rows:
            if len(r) < 2:
                raise QueryError("graph input requires rows of at least 2 columns")
            a, b = intern(r[0]), intern(r[1])
            src.append(a)
            dst.append(b)
            if undirected:
                src.append(b)
                dst.append(a)
        n = len(vert_vals)
        src_a = np.asarray(src, dtype=np.int64)
        dst_a = np.asarray(dst, dtype=np.int64)
        order = np.argsort(src_a, kind="stable")
        src_a, dst_a = src_a[order], dst_a[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src_a + 1, 1)
        indptr = np.cumsum(indptr)
        return indptr, dst_a, vert_vals

    def as_directed_weighted_graph(
        self, undirected: bool = False, allow_negative: bool = False
    ):
        # 2-column inputs carry no weight column: delegate to the
        # unweighted stager, which has the vectorized HNSW-layer0 /
        # int-pair fast paths AND the per-(relation, version) CSR cache —
        # LabelPropagation over a 16M-edge proximity graph otherwise
        # pays ~90s of per-row decode + cmp_key interning PER CALL
        try:
            ar = self.arity()
        except Exception:
            ar = None
        if ar == 2:
            indptr, dst, verts = self.as_directed_graph(undirected)
            return indptr, dst, np.ones(len(dst), dtype=np.float64), verts
        db = getattr(self.ctx, "db", None)
        ck = None
        if (
            db is not None
            and isinstance(self.arg, FixedRuleRelArg)
            and self.arg.validity is None
        ):
            ver = db._rel_versions.get(self.arg.name, 0)
            ck = (self.arg.name, ver, undirected, allow_negative, "csrw")
            got = db._csr_cache.get(ck)
            if got is not None:
                return got
        out = self._as_directed_weighted_graph_impl(undirected, allow_negative)
        if ck is not None:
            if len(db._csr_cache) >= 2:
                db._csr_cache.pop(next(iter(db._csr_cache)))
            db._csr_cache[ck] = out
        return out

    def _as_directed_weighted_graph_impl(
        self, undirected: bool = False, allow_negative: bool = False
    ):
        rows = self.rows()
        verts: Dict[tuple, int] = {}
        vert_vals: List[Any] = []

        def intern(v):
            k = cmp_key(v)
            i = verts.get(k)
            if i is None:
                i = len(vert_vals)
                verts[k] = i
                vert_vals.append(v)
            return i

        src, dst, wts = [], [], []
        for r in rows:
            if len(r) < 2:
                raise QueryError("graph input requires rows of at least 2 columns")
            a, b = intern(r[0]), intern(r[1])
            w = 1.0
            if len(r) > 2:
                v = r[2]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise QueryError(f"edge weight must be numeric, got {v!r}")
                w = float(v)
                if not allow_negative and w < 0:
                    raise QueryError("edge weight must be non-negative")
            src.append(a)
            dst.append(b)
            wts.append(w)
            if undirected:
                src.append(b)
                dst.append(a)
                wts.append(w)
        n = len(vert_vals)
        src_a = np.asarray(src, dtype=np.int64)
        dst_a = np.asarray(dst, dtype=np.int64)
        w_a = np.asarray(wts, dtype=np.float64)
        order = np.argsort(src_a, kind="stable")
        src_a, dst_a, w_a = src_a[order], dst_a[order], w_a[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src_a + 1, 1)
        indptr = np.cumsum(indptr)
        return indptr, dst_a, w_a, vert_vals


class FixedRulePayload:
    def __init__(self, apply, ctx) -> None:
        self.apply = apply
        self.ctx = ctx
        self.options: Dict[str, Any] = apply.options

    def get_input(self, i: int) -> FixedInput:
        if i >= len(self.apply.inputs):
            raise QueryError(
                f"fixed rule '{self.apply.fixed_name}' requires at least "
                f"{i + 1} input(s)"
            )
        return FixedInput(self.apply.inputs[i], self.ctx)

    @property
    def device(self):
        """The device of the Db the rule runs in (None without a Db: the
        card).  The device iterations of PageRank, SSSP and
        LabelPropagation run there: a CPU Db takes their plain versions."""
        db = getattr(self.ctx, "db", None)
        return None if db is None else db.device

    def n_inputs(self) -> int:
        return len(self.apply.inputs)

    def option(self, name: str, default=None):
        from ..data.expr import Const, Expr

        v = self.options.get(name)
        if v is None:
            return default
        if isinstance(v, Expr):
            v = v.fold_const()
            if not isinstance(v, Const):
                raise QueryError(f"option '{name}' must be a constant")
            return v.val
        return v

    def int_option(self, name: str, default=None) -> Optional[int]:
        v = self.option(name, default)
        if v is None:
            return None
        if isinstance(v, bool) or not isinstance(v, int):
            raise QueryError(f"option '{name}' must be an integer, got {v!r}")
        return v

    def float_option(self, name: str, default=None) -> Optional[float]:
        v = self.option(name, default)
        if v is None:
            return None
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise QueryError(f"option '{name}' must be a number, got {v!r}")
        return float(v)

    def bool_option(self, name: str, default=None) -> Optional[bool]:
        v = self.option(name, default)
        if v is None:
            return None
        if not isinstance(v, bool):
            raise QueryError(f"option '{name}' must be a boolean, got {v!r}")
        return v

    def string_option(self, name: str, default=None) -> Optional[str]:
        v = self.option(name, default)
        if v is None:
            return None
        if not isinstance(v, str):
            raise QueryError(f"option '{name}' must be a string, got {v!r}")
        return v

    def expr_option(self, name: str, default=None):
        return self.options.get(name, default)
