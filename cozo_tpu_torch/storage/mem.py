"""In-memory storage engine over a sorted container.

Analog of the reference `mem` engine (`cozo-core/src/storage/mem.rs`):
a shared sorted map; write transactions buffer an overlay merged on
commit under the store lock.  Readers materialize chunks of the scanned
range *under the same lock* (never iterating the shared SortedDict
while a commit mutates it), so every row and every chunk is a
consistent committed state; long scans are read-committed at chunk
granularity, matching the single-process semantics the Db layer's
per-relation write locks assume.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional, Tuple

from sortedcontainers import SortedDict

from .base import Storage, StoreTx

_SCAN_CHUNK = 4096


class MemTx(StoreTx):
    def __init__(self, store: "MemStorage", write: bool) -> None:
        self.store = store
        self.writable = write
        # plain dict: writes are O(1); scans sort the (tiny) overlay lazily
        self.overlay = {} if write else None
        self._done = False

    # -- reads --------------------------------------------------------------
    def get(self, key: bytes, for_update: bool = False) -> Optional[bytes]:
        if self.overlay is not None and key in self.overlay:
            return self.overlay[key]
        with self.store.lock:
            return self.store.data.get(key)

    def _base_chunks(self, lower: bytes, upper: bytes, reverse: bool):
        """Yield (key, value) pairs from the shared map, materializing one
        chunk at a time under the store lock (no iteration of the shared
        SortedDict outside the lock).  Chunks start small and grow so
        short scans (point/seek patterns) don't pay for 4096-row chunks."""
        data = self.store.data
        lo, hi = lower, upper
        inclusive = (True, False)
        size = 32
        while True:
            chunk = []
            with self.store.lock:
                it = data.irange(lo, hi, inclusive=inclusive, reverse=reverse)
                for k in it:
                    chunk.append((k, data[k]))
                    if len(chunk) >= size:
                        break
            if not chunk:
                return
            yield from chunk
            last = chunk[-1][0]
            if len(chunk) < size:
                return
            size = min(size * 8, _SCAN_CHUNK)
            if reverse:
                hi = last
                inclusive = (True, False)
            else:
                lo = last
                inclusive = (False, False)

    def range_scan(self, lower: bytes, upper: bytes) -> Iterator[Tuple[bytes, bytes]]:
        base = self._base_chunks(lower, upper, reverse=False)
        if not self.overlay:
            yield from base
            return
        over = [
            (k, self.overlay[k])
            for k in sorted(k for k in self.overlay if lower <= k < upper)
        ]
        yield from self._merge(base, over)

    def range_scan_rev(self, lower: bytes, upper: bytes) -> Iterator[Tuple[bytes, bytes]]:
        base = self._base_chunks(lower, upper, reverse=True)
        if not self.overlay:
            yield from base
            return
        over = [
            (k, self.overlay[k])
            for k in sorted(
                (k for k in self.overlay if lower <= k < upper), reverse=True
            )
        ]
        yield from self._merge(base, over, reverse=True)

    def _merge(self, base_iter, over_pairs, reverse=False):
        j = 0
        n_over = len(over_pairs)
        cmp = (lambda a, b: a > b) if reverse else (lambda a, b: a < b)
        for bk, bv in base_iter:
            while j < n_over and cmp(over_pairs[j][0], bk):
                ok, ov = over_pairs[j]
                j += 1
                if ov is not None:
                    yield ok, ov
            if j < n_over and over_pairs[j][0] == bk:
                ok, ov = over_pairs[j]
                j += 1
                if ov is not None:
                    yield ok, ov
            else:
                yield bk, bv
        while j < n_over:
            ok, ov = over_pairs[j]
            j += 1
            if ov is not None:
                yield ok, ov

    def range_count(self, lower: bytes, upper: bytes) -> int:
        if not self.overlay:
            with self.store.lock:
                d = self.store.data
                return d.bisect_left(upper) - d.bisect_left(lower)
        n = 0
        for _ in self.range_scan(lower, upper):
            n += 1
        return n

    def collect_keys(self, lower: bytes, upper: bytes) -> list:
        if self.overlay:
            return [k for k, _ in self.range_scan(lower, upper)]
        with self.store.lock:
            d = self.store.data
            i = d.bisect_left(lower)
            j = d.bisect_left(upper)
            # SortedDict keys view slicing is O(log n + k) and returns a
            # list built from the internal sublists — ~10x faster than
            # iterating 10^7 keys through a generator
            return list(d.keys()[i:j])

    def seek_first(self, lower: bytes, upper: bytes):
        """First live pair >= lower (< upper), O(log n): no chunking."""
        data = self.store.data
        lo = lower
        while True:
            with self.store.lock:
                bk = next(data.irange(lo, upper, inclusive=(True, False)), None)
                bv = data[bk] if bk is not None else None
            ok = None
            if self.overlay:
                ok = min(
                    (k for k in self.overlay if lo <= k < upper), default=None
                )
            if ok is not None and (bk is None or ok <= bk):
                ov = self.overlay[ok]
                if ov is None:  # overlay delete shadows base
                    if bk == ok:
                        lo = ok + b"\x00"
                        continue
                    # base key (if any) earlier than ok is unshadowed
                    if bk is not None and bk < ok:
                        return (bk, bv)
                    lo = ok + b"\x00"
                    continue
                return (ok, ov)
            if bk is None:
                return None
            return (bk, bv)

    # -- writes -------------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        self.overlay[key] = value

    def delete(self, key: bytes) -> None:
        self.overlay[key] = None

    def commit(self) -> None:
        if self._done:
            return
        self._done = True
        if self.overlay:
            with self.store.lock:
                data = self.store.data
                if len(self.overlay) > max(4096, len(data)):
                    # huge commit (index backfill, bulk load): one sorted
                    # rebuild beats per-key O(log n) inserts by ~4x
                    merged = dict(data)
                    for k, v in self.overlay.items():
                        if v is None:
                            merged.pop(k, None)
                        else:
                            merged[k] = v
                    self.store.data = SortedDict(merged)
                else:
                    for k, v in self.overlay.items():
                        if v is None:
                            data.pop(k, None)
                        else:
                            data[k] = v

    def abort(self) -> None:
        self._done = True
        self.overlay = {} if self.writable else None


class MemStorage(Storage):
    name = "mem"

    def __init__(self) -> None:
        self.data = SortedDict()
        self.lock = threading.RLock()

    def transact(self, write: bool = False) -> MemTx:
        return MemTx(self, write)

    def del_range(self, lower: bytes, upper: bytes) -> None:
        with self.lock:
            for k in list(self.data.irange(lower, upper, inclusive=(True, False))):
                del self.data[k]

    def batch_put(self, items) -> None:
        with self.lock:
            if not self.data:
                # bulk load into an empty store: SortedDict.update builds
                # the sorted structure in one pass (restore_backup path)
                self.data.update(items)
            else:
                for k, v in items:
                    self.data[k] = v
