"""SessionTx — the spine threading storage, temp storage and catalog cache
through every layer (reference `runtime/transact.rs:24-30`)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..storage.base import Storage, StoreTx
from ..utils.errors import QueryError
from .relation import Catalog, RelationHandle


class SessionTx:
    def __init__(
        self,
        store_tx: StoreTx,
        temp_store: Storage,
        cur_vld: int,
        handle_cache: Optional[dict] = None,
        rel_id_alloc: Optional[Any] = None,
        db: Optional[Any] = None,
    ) -> None:
        self.store_tx = store_tx
        self._temp_store = temp_store
        self._temp_tx = None  # created on first `_rel` access (OLTP hot path
        # never touches temp storage; a SortedDict per query is measurable)
        self.cur_vld = cur_vld
        self.db = db  # backref for packed-index virtual views
        self._rel_cache: Dict[str, RelationHandle] = {}
        # db-level (raw_bytes, handle) cache shared across queries; validated
        # against the raw catalog bytes so DDL invalidates naturally
        self._shared_cache = handle_cache
        self._rel_id_alloc = rel_id_alloc

    @property
    def temp_store(self):
        ts = self._temp_store
        if isinstance(ts, type):  # a factory class, not an instance
            ts = self._temp_store = ts()
        return ts

    @property
    def temp_tx(self):
        if self._temp_tx is None:
            self._temp_tx = self.temp_store.transact(write=True)
        return self._temp_tx

    # --- relations ------------------------------------------------------------

    def get_relation(self, name: str, for_update: bool = False) -> RelationHandle:
        cached = self._rel_cache.get(name)
        if cached is not None and not for_update:
            return cached
        tx = self.temp_tx if name.startswith("_") else self.store_tx
        raw = tx.get(Catalog.meta_key(name))
        if raw is None:
            raise QueryError(
                f"stored relation '{name}' not found", code="query::relation_not_found"
            )
        shared = self._shared_cache if not name.startswith("_") else None
        if shared is not None and not for_update:
            ent = shared.get(name)
            if ent is not None and ent[0] == raw:
                h = ent[1]
                self._rel_cache[name] = h
                return h
        h = RelationHandle.from_json(raw.decode("utf-8"))
        h.is_temp = name.startswith("_")
        self._bind_virt(h)
        self._rel_cache[name] = h
        if shared is not None and not for_update:
            shared[name] = (raw, h)
        return h

    def _bind_virt(self, h: RelationHandle) -> None:
        if h.packed_src is not None and h.virt_binder is None and self.db is not None:
            from .hnsw_packed import PackedHnswBinder

            ps = h.packed_src
            h.virt_binder = PackedHnswBinder(self.db, ps["base"], ps["idx"])

    def relation_exists(self, name: str) -> bool:
        tx = self.temp_tx if name.startswith("_") else self.store_tx
        return Catalog.get(tx, name) is not None

    def put_relation_meta(self, handle: RelationHandle) -> None:
        tx = self.temp_tx if handle.name.startswith("_") else self.store_tx
        Catalog.put(tx, handle)
        self._rel_cache[handle.name] = handle

    def delete_relation_meta(self, name: str) -> None:
        tx = self.temp_tx if name.startswith("_") else self.store_tx
        Catalog.delete(tx, name)
        self._rel_cache.pop(name, None)

    def alloc_rel_id(self, temp: bool) -> int:
        if temp:
            # temp storage is a per-session MemStorage — no cross-tx race
            Catalog.init_storage(self.temp_tx)
            return Catalog.alloc_rel_id(self.temp_tx)
        if self._rel_id_alloc is not None:
            rid = self._rel_id_alloc()
            # persist high-water mark so a fresh process reopens correctly
            self.store_tx.put(Catalog.NEXT_ID_KEY, str(rid + 1).encode())
            return rid
        Catalog.init_storage(self.store_tx)
        return Catalog.alloc_rel_id(self.store_tx)

    def store_tx_for(self, handle: RelationHandle) -> StoreTx:
        return self.temp_tx if handle.is_temp else self.store_tx

    def invalidate_cache(self, name: Optional[str] = None) -> None:
        if name is None:
            self._rel_cache.clear()
        else:
            self._rel_cache.pop(name, None)

    # --- lifecycle --------------------------------------------------------------

    def commit(self) -> None:
        self.store_tx.commit()
        if self._temp_tx is not None:
            self._temp_tx.commit()

    def abort(self) -> None:
        self.store_tx.abort()
        if self._temp_tx is not None:
            self._temp_tx.abort()
