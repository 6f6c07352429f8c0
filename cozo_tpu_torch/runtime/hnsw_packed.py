"""Packed KV image for large HNSW indexes.

The reference persists an HNSW index as one KV row per edge
(`runtime/hnsw.rs:679` — key `(layer, fr, fr_field, to, to_field) =>
dist`).  That image is perfect at OLTP scale but quadratic pain at bulk
scale: a fresh 10M-node build would write ~300M discrete rows through
the host (hours of encode time, tens of GB of key bytes).  The TPU
rebuild's canonical structure is already a padded neighbor array on
device — so past `COZO_TPU_PACKED_KV_MIN` rows (default 2M) the DDL
build persists the *arrays themselves* as a handful of chunked blobs in
the internal key range, and the index relation becomes a **virtual
relation**: scans/point-reads decode rows on demand from the arrays,
byte-for-byte equal (same columns, same memcmp ordering, lazily
computed distances) to the row image they replace.

Incremental mutations after a packed build write ordinary rows for the
touched nodes (the same delete+rewrite protocol as the row image) and
record those nodes in an overlay set; the virtual scan merges overlay
rows over the packed base, and a cache rebuild applies them the same
way.  Readers therefore never observe a difference between the two
storage modes.

Counterpart of `cozo_tpu/runtime/hnsw_packed.py`, with the same blob
layout, so either package opens the other's packed image.  The cache it
rebuilds holds the port's `HnswIndex` on the Db's device (made by
`hnsw._new_index`); the raw-slot helpers `_alloc_slot` and
`_append_neighbor` are methods of that class.
"""

from __future__ import annotations

import json
from heapq import merge as heap_merge
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np

from ..data.memcmp import decode_tuple, encode_tuple
from ..data.value import cmp_key
from .relation import INTERNAL_ID, RelationHandle, rel_prefix

BLOB_CHUNK = 32 << 20  # bytes per neighbor-array chunk value

PACKED_MIN_DEFAULT = 2_000_000


def packed_threshold() -> int:
    import os

    try:
        return int(os.environ.get("COZO_TPU_PACKED_KV_MIN", PACKED_MIN_DEFAULT))
    except ValueError:
        return PACKED_MIN_DEFAULT


def _pfx(rel: str, idx: str) -> bytes:
    return (
        rel_prefix(INTERNAL_ID)
        + b"hnsw_packed::"
        + rel.encode()
        + b"::"
        + idx.encode()
        + b"::"
    )


def _put_chunked(store_tx, key_base: bytes, data: bytes) -> int:
    n_chunks = max(1, (len(data) + BLOB_CHUNK - 1) // BLOB_CHUNK)
    for i in range(n_chunks):
        store_tx.put(
            key_base + b":%06d" % i, data[i * BLOB_CHUNK : (i + 1) * BLOB_CHUNK]
        )
    return n_chunks


def _get_chunked(store_tx, key_base: bytes, n_chunks: int) -> bytes:
    parts = store_tx.multi_get(
        [key_base + b":%06d" % i for i in range(n_chunks)]
    )
    if any(p is None for p in parts):
        raise RuntimeError(f"packed hnsw blob missing: {key_base!r}")
    return b"".join(parts)


def write_packed_image(cache, tx, handle, idx_handle) -> None:
    """Persist the fresh in-memory index as packed blobs (no row image).

    Called instead of `_sync_dirty_to_kv(fresh=True)` by the DDL build
    when the item count crosses the packed threshold."""
    index = cache.index
    rel, idx = handle.name, idx_handle.name.rsplit(":", 1)[1]
    store_tx = tx.store_tx_for(idx_handle)
    p = _pfx(rel, idx)
    n = index.n

    meta: dict = {"n": n, "levels": len(index.neighbors), "m": []}
    store_tx.put(p + b"lv", np.ascontiguousarray(
        index.levels[:n].astype(np.int16)).tobytes())
    store_tx.put(p + b"alive", np.packbits(index.alive[:n]).tobytes())
    for lvl, nbr in enumerate(index.neighbors):
        arr = np.ascontiguousarray(nbr[:n].astype(np.int32))
        meta["m"].append(
            [int(arr.shape[1]), _put_chunked(store_tx, p + b"nbr%d" % lvl, arr.tobytes())]
        )
    # slot → item mapping
    if cache.slot_ids is not None:
        meta["key_kind"] = "int"
        store_tx.put(p + b"ids", np.ascontiguousarray(
            cache.slot_ids[:n]).tobytes())
    else:
        meta["key_kind"] = "tuple"
        buf = bytearray()
        for slot in range(n):
            item = cache.slot_to_item.get(slot)
            row = list(item[0]) + [item[1]] if item is not None else None
            enc = encode_tuple(row) if row is not None else b""
            buf.extend(len(enc).to_bytes(4, "big"))
            buf.extend(enc)
        meta["ids_chunks"] = _put_chunked(store_tx, p + b"items", bytes(buf))
    store_tx.put(p + b"meta", json.dumps(meta).encode())
    index.dirty.clear()


def read_packed_meta(store_tx, rel: str, idx: str) -> Optional[dict]:
    raw = store_tx.get(_pfx(rel, idx) + b"meta")
    return json.loads(raw) if raw is not None else None


def drop_packed_image(store_tx, rel: str, idx: str) -> None:
    p = _pfx(rel, idx)
    for k, _ in list(store_tx.range_scan(p, p + b"\xff" * 8)):
        store_tx.delete(k)


def add_overlay_entries(store_tx, rel: str, idx: str, entries) -> None:
    """Record items that moved to the row-image overlay.  One KV row per
    entry (`key_vals + [field]`, memcmp-encoded) — append-only, so a
    mutation never rewrites the whole overlay set."""
    p = _pfx(rel, idx) + b"ovl:"
    for e in entries:
        store_tx.put(p + encode_tuple(e), b"")


def load_overlay_entries(store_tx, rel: str, idx: str) -> List[list]:
    p = _pfx(rel, idx) + b"ovl:"
    return [
        decode_tuple(k[len(p):])
        for k, _ in store_tx.range_scan(p, p + b"\xff" * 9)
    ]


def rebuild_cache_packed(db, tx, handle, idx_name, meta_cfg, cache) -> bool:
    """Populate `cache` from the packed image (+ row overlay).  Returns
    False when no packed image exists (caller falls back to row scan)."""
    idx_handle = tx.get_relation(f"{handle.name}:{idx_name}")
    store_tx = tx.store_tx_for(idx_handle)
    rel, idx = handle.name, idx_name
    meta = read_packed_meta(store_tx, rel, idx)
    if meta is None:
        return False
    index = cache.index
    n = meta["n"]
    p = _pfx(rel, idx)

    index._grow(n)
    index.n = n
    index.levels[:n] = np.frombuffer(
        store_tx.get(p + b"lv"), dtype=np.int16
    ).astype(index.levels.dtype)
    index.alive[:n] = np.unpackbits(
        np.frombuffer(store_tx.get(p + b"alive"), dtype=np.uint8), count=n
    ).astype(bool)
    for lvl, (m, n_chunks) in enumerate(meta["m"]):
        index._ensure_level(lvl)
        raw = _get_chunked(store_tx, p + b"nbr%d" % lvl, n_chunks)
        arr = np.frombuffer(raw, dtype=np.int32).reshape(n, m)
        tgt = index.neighbors[lvl]
        if tgt.shape[1] < m:  # capacity mismatch can't happen (same manifest)
            raise RuntimeError("packed neighbor width exceeds index m_max")
        tgt[:n, :m] = arr
        tgt[:n, m:] = -1

    if meta["key_kind"] == "int":
        cache.slot_ids = np.frombuffer(
            store_tx.get(p + b"ids"), dtype=np.int64
        ).copy()
    else:
        raw = _get_chunked(store_tx, p + b"items", meta["ids_chunks"])
        pos = 0
        for slot in range(n):
            ln = int.from_bytes(raw[pos : pos + 4], "big")
            pos += 4
            if ln:
                row = decode_tuple(raw[pos : pos + ln])
                pos += ln
                cache.put_item(slot, row[:-1], int(row[-1]))
            else:
                index.alive[slot] = False

    # vectors: one sequential pass over the base relation (point gets per
    # node would pay 10M random lookups)
    fields = meta_cfg["fields"]
    fcols = [handle.col_index(f) for f in fields]
    nk = len(handle.keys)
    base_tx = tx.store_tx_for(handle)
    if cache.slot_ids is not None:
        ids = cache.slot_ids[:n]
        order = np.argsort(ids, kind="stable")
        sorted_ids = ids[order]
        got = np.zeros(n, dtype=bool)
        for row in handle.scan_all(base_tx):
            rid = row[0]
            j = np.searchsorted(sorted_ids, rid)
            if j >= n or sorted_ids[j] != rid:
                continue
            slot = int(order[j])
            vec = row[fcols[0]]
            if vec is None:
                continue
            index.vectors[slot] = np.asarray(vec.a, dtype=index.dtype)
            got[slot] = True
        index.alive[:n] &= got
    else:
        for slot, item in cache.slot_to_item.items():
            base_row = handle.get_row(base_tx, item[0])
            if base_row is None:
                index.alive[slot] = False
                continue
            vec = base_row[fcols[item[1]]]
            if vec is None:
                index.alive[slot] = False
                continue
            index.vectors[slot] = np.asarray(vec.a, dtype=index.dtype)
    v64 = index.vectors[:n].astype(np.float64)
    index.norms[:n] = np.einsum("nd,nd->n", v64, v64)

    # overlay: nodes mutated after the pack own their rows in the normal
    # key range; re-derive their membership + adjacency from those rows
    cache.packed = True
    ovl_entries = load_overlay_entries(store_tx, rel, idx)
    cache.ovl_keys = {
        cache.item_key(list(e[:-1]), int(e[-1])) for e in ovl_entries
    }
    if cache.ovl_keys:
        cache.ensure_maps()
        for ik in cache.ovl_keys:
            s = cache.key_to_slot.get(ik)
            if s is None:
                continue
            for nbr in index.neighbors:
                nbr[s] = -1
            index.alive[s] = False  # resurrected below by self-edges
        rows = list(idx_handle.scan_all(store_tx, raw_image=True))
        # pass A: membership self-edges; post-pack inserts get fresh slots
        for row in rows:
            layer = -int(row[0])
            fr_key = row[1 : 1 + nk]
            fr_field = row[1 + nk]
            to_key = row[2 + nk : 2 + 2 * nk]
            to_field = row[2 + 2 * nk]
            fr = cache.item_key(fr_key, fr_field)
            if fr != cache.item_key(to_key, to_field):
                continue
            s1 = cache.key_to_slot.get(fr)
            if s1 is None:
                base_row = handle.get_row(base_tx, list(fr_key))
                if base_row is None:
                    continue
                vec = base_row[fcols[fr_field]]
                if vec is None:
                    continue
                cache.put_item(index._alloc_slot(np.asarray(vec.a), layer),
                               fr_key, fr_field)
            else:
                index.alive[s1] = True
                index.levels[s1] = max(int(index.levels[s1]), layer)
        # pass B: adjacency
        for row in rows:
            layer = -int(row[0])
            fr = cache.item_key(row[1 : 1 + nk], row[1 + nk])
            to = cache.item_key(row[2 + nk : 2 + 2 * nk], row[2 + 2 * nk])
            if fr == to:
                continue
            s1 = cache.key_to_slot.get(fr)
            s2 = cache.key_to_slot.get(to)
            if s1 is not None and s2 is not None:
                index._append_neighbor(layer, s1, s2)
        n = index.n  # may have grown past the packed image

    if n:
        alive_slots = np.nonzero(index.alive[:n])[0]
        if len(alive_slots):
            index.entry = int(
                alive_slots[np.argmax(index.levels[alive_slots])]
            )
    index.dirty.clear()
    index.version += 1
    return True


# --------------------------------------------------------------- virtual scan


class PackedHnswBinder:
    """Attached to a packed index relation's handle; resolves the live
    HnswCache per call and serves scans from it."""

    def __init__(self, db, base_name: str, idx_name: str) -> None:
        self.db = db
        self.base_name = base_name
        self.idx_name = idx_name

    def _view(self, idx_handle: RelationHandle, store_tx):
        from ..storage.mem import MemStorage
        from .hnsw import get_hnsw_cache
        from .transact import SessionTx

        tx = SessionTx(store_tx, MemStorage, 0)
        tx.db = self.db
        base = tx.get_relation(self.base_name)
        meta = base.indices.get(self.idx_name)
        if meta is None or meta.get("kind") != "hnsw":
            raise RuntimeError(
                f"packed index {self.base_name}:{self.idx_name} missing meta"
            )
        cache = get_hnsw_cache(self.db, tx, base, self.idx_name, meta)
        return PackedHnswView(cache, base, idx_handle, store_tx)


class PackedHnswView:
    def __init__(self, cache, base_handle, idx_handle, store_tx) -> None:
        self.cache = cache
        self.index = cache.index
        self.base = base_handle
        self.handle = idx_handle
        self.store_tx = store_tx
        self.nk = len(base_handle.keys)

    # --- helpers -----------------------------------------------------------

    def _sorted_alive(self) -> np.ndarray:
        """Alive slots sorted by encoded key order (ints sort numerically)."""
        c = self.cache
        n = self.index.n
        key = ("sorted_alive", self.index.version)
        if c.scan_cache.get("k") == key:
            return c.scan_cache["v"]
        alive = np.nonzero(self.index.alive[:n])[0]
        if c.slot_ids is not None:
            order = np.argsort(c.slot_ids[alive], kind="stable")
            out = alive[order]
        else:
            c.ensure_maps()
            out = np.asarray(
                sorted(
                    (s for s in alive.tolist() if s in c.slot_to_item),
                    key=lambda s: (
                        tuple(cmp_key(v) for v in c.slot_to_item[s][0]),
                        c.slot_to_item[s][1],
                    ),
                ),
                dtype=np.int64,
            )
        c.scan_cache = {"k": key, "v": out}
        return out

    def _item(self, slot: int) -> Optional[Tuple[list, int]]:
        c = self.cache
        if c.slot_ids is not None:
            return ([int(c.slot_ids[slot])], 0)
        return c.slot_to_item.get(int(slot))

    def _slot_for_key(self, key_vals, field) -> Optional[int]:
        c = self.cache
        if c.slot_ids is not None:
            if field != 0 or len(key_vals) != 1 or not isinstance(
                key_vals[0], int
            ):
                return None
            n = self.index.n
            ids = c.slot_ids[:n]
            key = ("ids_order", self.index.version)
            if c.scan_cache.get("ik") != key:
                order = np.argsort(ids, kind="stable")
                c.scan_cache["ik"] = key
                c.scan_cache["iv"] = (order, ids[order])
            order, sorted_ids = c.scan_cache["iv"]
            j = np.searchsorted(sorted_ids, key_vals[0])
            if j >= n or sorted_ids[j] != key_vals[0]:
                return None
            s = int(order[j])
            return s if self.index.alive[s] else None
        c.ensure_maps()
        s = c.key_to_slot.get(c.item_key(list(key_vals), field))
        return s if s is not None and self.index.alive[s] else None

    def _is_ovl(self, slot: int) -> bool:
        ok = self.cache.ovl_keys
        if not ok:
            return False
        item = self._item(slot)
        return item is not None and self.cache.item_key(item[0], item[1]) in ok

    def _rows_for_slot(self, slot: int, lvl: int) -> Iterator[List[Any]]:
        """All rows with fr = slot at `lvl`, in to-key order (self first
        iff its key sorts first — order by the to endpoint like the KV
        image does)."""
        idx = self.index
        item = self._item(slot)
        if item is None:
            return
        key_vals, field = item
        nbr = idx.neighbors[lvl][slot]
        nbs = [
            int(nb)
            for nb in nbr[nbr >= 0]
            if idx.alive[nb] and self._item(int(nb)) is not None
        ]
        ds = (
            idx.dists_to(idx.vectors[slot], np.asarray(nbs, dtype=np.int64))
            if nbs
            else []
        )
        ents: List[Tuple[tuple, list]] = []
        self_row = (
            [-lvl] + list(key_vals) + [field] + list(key_vals) + [field, 0.0]
        )
        ents.append(
            ((tuple(cmp_key(v) for v in key_vals), field), self_row)
        )
        for nb, d in zip(nbs, ds):
            to_item = self._item(nb)
            ents.append(
                (
                    (tuple(cmp_key(v) for v in to_item[0]), to_item[1]),
                    [-lvl]
                    + list(key_vals)
                    + [field]
                    + list(to_item[0])
                    + [to_item[1], float(d)],
                )
            )
        ents.sort(key=lambda e: e[0])
        for _, row in ents:
            yield row

    def _gen_level(self, lvl: int) -> Iterator[List[Any]]:
        idx = self.index
        for slot in self._sorted_alive():
            if int(idx.levels[slot]) < lvl:
                continue
            if self._is_ovl(int(slot)):
                continue
            yield from self._rows_for_slot(int(slot), lvl)

    def _gen_all(self) -> Iterator[List[Any]]:
        for lvl in range(len(self.index.neighbors) - 1, -1, -1):
            yield from self._gen_level(lvl)

    def _row_sort_key(self, row):
        return tuple(cmp_key(v) for v in row[: 2 * self.nk + 3])

    def _merge_overlay(self, gen, overlay_rows) -> Iterator[List[Any]]:
        return heap_merge(gen, overlay_rows, key=self._row_sort_key)

    # --- scan API (mirrors RelationHandle) ---------------------------------

    def scan_all(self) -> Iterator[List[Any]]:
        overlay = self.handle.scan_all(self.store_tx, raw_image=True)
        return self._merge_overlay(self._gen_all(), overlay)

    def scan_prefix(self, prefix_vals) -> Iterator[List[Any]]:
        if not prefix_vals:
            return self.scan_all()
        overlay = self.handle.scan_prefix(
            self.store_tx, prefix_vals, raw_image=True
        )
        layer = prefix_vals[0]
        if not isinstance(layer, int):
            return overlay
        lvl = -int(layer)
        if lvl < 0 or lvl >= len(self.index.neighbors):
            return overlay

        def packed():
            if len(prefix_vals) >= 1 + self.nk:
                key_vals = list(prefix_vals[1 : 1 + self.nk])
                if len(prefix_vals) > 1 + self.nk:
                    cand_fields = [int(prefix_vals[1 + self.nk])]
                else:
                    nfields = len(self.cache.manifest.get("fields", [0]))
                    cand_fields = list(range(nfields))
                rest = prefix_vals[1 + self.nk :]
                for field in cand_fields:
                    slot = self._slot_for_key(key_vals, field)
                    if slot is None or self._is_ovl(slot):
                        continue
                    if int(self.index.levels[slot]) < lvl:
                        continue
                    for row in self._rows_for_slot(slot, lvl):
                        if all(
                            cmp_key(row[1 + self.nk + i]) == cmp_key(pv)
                            for i, pv in enumerate(rest)
                        ):
                            yield row
            else:
                rest = prefix_vals[1:]
                for row in self._gen_level(lvl):
                    if all(
                        cmp_key(row[1 + i]) == cmp_key(pv)
                        for i, pv in enumerate(rest)
                    ):
                        yield row

        return self._merge_overlay(packed(), overlay)

    def scan_bounded(
        self, prefix_vals, lo_val, lo_incl, hi_val, hi_incl
    ) -> Iterator[List[Any]]:
        pos = len(prefix_vals)
        for row in self.scan_prefix(prefix_vals):
            v = cmp_key(row[pos])
            if lo_val is not None:
                lv = cmp_key(lo_val)
                if v < lv or (v == lv and not lo_incl):
                    continue
            if hi_val is not None:
                hv = cmp_key(hi_val)
                if v > hv or (v == hv and not hi_incl):
                    continue
            yield row

    def get_row(self, key_vals) -> Optional[List[Any]]:
        got = self.handle.get_row(self.store_tx, key_vals, raw_image=True)
        if got is not None:
            return got
        if len(key_vals) != 2 * self.nk + 3:
            return None
        lvl = -int(key_vals[0])
        fr_key = list(key_vals[1 : 1 + self.nk])
        fr_field = int(key_vals[1 + self.nk])
        to_key = list(key_vals[2 + self.nk : 2 + 2 * self.nk])
        to_field = int(key_vals[2 + 2 * self.nk])
        slot = self._slot_for_key(fr_key, fr_field)
        if slot is None or self._is_ovl(slot):
            return None
        if lvl < 0 or lvl >= len(self.index.neighbors):
            return None
        if int(self.index.levels[slot]) < lvl:
            return None
        if [cmp_key(v) for v in to_key] == [cmp_key(v) for v in fr_key] and (
            to_field == fr_field
        ):
            return list(key_vals) + [0.0]
        to_slot = self._slot_for_key(to_key, to_field)
        if to_slot is None:
            return None
        nbr = self.index.neighbors[lvl][slot]
        if to_slot not in nbr[nbr >= 0]:
            return None
        d = float(
            self.index.dists_to(
                self.index.vectors[slot], np.asarray([to_slot])
            )[0]
        )
        return list(key_vals) + [d]

    def exists(self, key_vals) -> bool:
        return self.get_row(key_vals) is not None
