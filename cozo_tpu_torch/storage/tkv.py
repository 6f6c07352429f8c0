"""tkv storage engine — Python binding over the native C++ ordered-KV
(`native/tkv.cpp`, shared with the JAX package and built into
`build/cozo_tpu_torch_kernels/`), the analog of the reference's rocksdb engine
(`storage/rocks.rs` over the cozorocks bridge).

Optimistic transactions: a Python-side overlay buffers writes; commit
sends the read-set (keys fetched with for_update) + the write batch to
`tkv_commit`, which verifies read-set freshness against per-key
modification sequences under an exclusive lock."""

from __future__ import annotations

import ctypes

from sortedcontainers import SortedDict
import os
from typing import Iterator, Optional, Tuple

from ..ops._build import build_host, host_lib_path
from .base import ConflictError, Storage, StorageError, StoreTx

_LIB = None

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX package's source, read in place; built into the port's own
# (git-ignored) directory, never over the JAX package's `native/libtkv.so`
TKV_SRC = os.path.join(_ROOT, "native", "tkv.cpp")
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def lib_path() -> str:
    return host_lib_path(TKV_SRC, GXX_FLAGS, "libtkv-{hash}.so")


def _find_or_build_lib() -> str:
    return build_host(TKV_SRC, GXX_FLAGS, "libtkv-{hash}.so")


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(_find_or_build_lib())
    lib.tkv_open.restype = ctypes.c_void_p
    lib.tkv_open.argtypes = [ctypes.c_char_p]
    lib.tkv_close.argtypes = [ctypes.c_void_p]
    lib.tkv_seq.restype = ctypes.c_uint64
    lib.tkv_seq.argtypes = [ctypes.c_void_p]
    lib.tkv_get.restype = ctypes.c_int
    lib.tkv_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.tkv_free.restype = None
    lib.tkv_free.argtypes = [ctypes.c_void_p]
    lib.tkv_iter.restype = ctypes.c_void_p
    lib.tkv_iter.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.tkv_iter_next.restype = ctypes.c_int
    lib.tkv_iter_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.tkv_iter_close.argtypes = [ctypes.c_void_p]
    lib.tkv_count.restype = ctypes.c_uint64
    lib.tkv_count.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
    ]
    lib.tkv_commit.restype = ctypes.c_int
    lib.tkv_commit.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_size_t,
    ]
    lib.tkv_del_range.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
    ]
    lib.tkv_compact.restype = ctypes.c_int
    lib.tkv_compact.argtypes = [ctypes.c_void_p]
    lib.tkv_set_sync.restype = None
    lib.tkv_set_sync.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tkv_set_flush_bytes.restype = None
    lib.tkv_set_flush_bytes.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tkv_flush.restype = ctypes.c_int
    lib.tkv_flush.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


_DELETE = object()
_SIZE_MAX = ctypes.c_size_t(-1).value


class TkvTx(StoreTx):
    def __init__(self, store: "TkvStorage", write: bool) -> None:
        self.store = store
        self.writable = write
        self.overlay = SortedDict() if write else None
        self.read_set: set = set() if write else None
        self.snapshot_seq = _lib().tkv_seq(store.handle) if write else 0
        self._done = False

    def get(self, key: bytes, for_update: bool = False) -> Optional[bytes]:
        if self.overlay is not None and key in self.overlay:
            v = self.overlay[key]
            return None if v is _DELETE else v
        if for_update and self.read_set is not None:
            self.read_set.add(key)
        lib = _lib()
        v = ctypes.c_void_p()
        vlen = ctypes.c_size_t()
        seq = ctypes.c_uint64()
        found = lib.tkv_get(
            self.store.handle, key, len(key), ctypes.byref(v),
            ctypes.byref(vlen), ctypes.byref(seq),
        )
        if not found:
            return None
        try:
            return ctypes.string_at(v, vlen.value)
        finally:
            lib.tkv_free(v)

    def _base_scan(self, lower: bytes, upper: bytes, reverse: bool):
        lib = _lib()
        it = lib.tkv_iter(self.store.handle, lower, len(lower), upper, len(upper),
                          1 if reverse else 0)
        try:
            k = ctypes.c_char_p()
            klen = ctypes.c_size_t()
            v = ctypes.c_char_p()
            vlen = ctypes.c_size_t()
            while lib.tkv_iter_next(
                it, ctypes.byref(k), ctypes.byref(klen), ctypes.byref(v),
                ctypes.byref(vlen),
            ):
                yield (
                    ctypes.string_at(k, klen.value),
                    ctypes.string_at(v, vlen.value),
                )
        finally:
            lib.tkv_iter_close(it)

    def _merged_scan(self, lower, upper, reverse):
        over = list(
            self.overlay.irange(lower, upper, inclusive=(True, False), reverse=reverse)
        )
        base = self._base_scan(lower, upper, reverse)
        import heapq

        oi = 0
        bnext = next(base, None)
        cmp = (lambda a, b: a > b) if reverse else (lambda a, b: a < b)
        while oi < len(over) or bnext is not None:
            if oi >= len(over):
                yield bnext
                bnext = next(base, None)
            elif bnext is None:
                k = over[oi]
                oi += 1
                v = self.overlay[k]
                if v is not _DELETE:
                    yield (k, v)
            else:
                bk = bnext[0]
                ok = over[oi]
                if bk == ok:
                    bnext = next(base, None)
                elif cmp(bk, ok):
                    yield bnext
                    bnext = next(base, None)
                else:
                    oi += 1
                    v = self.overlay[ok]
                    if v is not _DELETE:
                        yield (ok, v)

    def range_scan(self, lower: bytes, upper: bytes):
        if not self.overlay:
            yield from self._base_scan(lower, upper, False)
        else:
            yield from self._merged_scan(lower, upper, False)

    def range_scan_rev(self, lower: bytes, upper: bytes):
        if not self.overlay:
            yield from self._base_scan(lower, upper, True)
        else:
            yield from self._merged_scan(lower, upper, True)

    def range_count(self, lower: bytes, upper: bytes) -> int:
        if not self.overlay:
            return int(_lib().tkv_count(self.store.handle, lower, len(lower),
                                        upper, len(upper)))
        return sum(1 for _ in self.range_scan(lower, upper))

    def put(self, key: bytes, value: bytes) -> None:
        self.overlay[key] = value

    def delete(self, key: bytes) -> None:
        self.overlay[key] = _DELETE

    def commit(self) -> None:
        if self._done:
            return
        self._done = True
        if not self.overlay:
            return
        lib = _lib()
        # The full read_set is validated, including keys we also wrote:
        # read-modify-write keys are exactly the ones OCC must check for a
        # concurrent commit between our snapshot and now (lost updates).
        reads = list(self.read_set) if self.read_set else []
        n_r = len(reads)
        rkeys = (ctypes.c_char_p * max(n_r, 1))(*reads) if n_r else (ctypes.c_char_p * 1)()
        rlens = (ctypes.c_size_t * max(n_r, 1))(*[len(k) for k in reads]) if n_r else (ctypes.c_size_t * 1)()
        items = list(self.overlay.items())
        n_o = len(items)
        okeys = (ctypes.c_char_p * n_o)(*[k for k, _ in items])
        oklens = (ctypes.c_size_t * n_o)(*[len(k) for k, _ in items])
        ovals = (ctypes.c_char_p * n_o)(
            *[(b"" if v is _DELETE else v) for _, v in items]
        )
        ovlens = (ctypes.c_size_t * n_o)(
            *[(_SIZE_MAX if v is _DELETE else len(v)) for _, v in items]
        )
        rc = lib.tkv_commit(
            self.store.handle, self.snapshot_seq, rkeys, rlens, n_r,
            okeys, oklens, ovals, ovlens, n_o,
        )
        if rc == 1:
            raise ConflictError("optimistic transaction conflict")
        if rc != 0:
            raise StorageError(f"tkv commit failed with code {rc}")

    def abort(self) -> None:
        self._done = True
        self.overlay = SortedDict() if self.writable else None


class TkvStorage(Storage):
    name = "tkv"

    def __init__(self, path: str = "", sync_mode: int = 1) -> None:
        """sync_mode: 0 = buffered WAL, 1 = fflush per commit (survives
        SIGKILL; default — matches RocksDB's default non-fsync WAL),
        2 = fdatasync per commit (survives power loss)."""
        self.path = path
        self.handle = _lib().tkv_open(path.encode("utf-8"))
        if not self.handle:
            raise StorageError(f"cannot open tkv database at {path!r}")
        _lib().tkv_set_sync(self.handle, int(sync_mode))

    def set_flush_bytes(self, n: int) -> None:
        """Memtable budget before an automatic flush to an SST level."""
        _lib().tkv_set_flush_bytes(self.handle, int(n))

    def flush(self) -> None:
        """Force the memtable out to an SST (truncates the WAL)."""
        rc = _lib().tkv_flush(self.handle)
        if rc != 0:
            raise StorageError("tkv flush failed")

    def transact(self, write: bool = False) -> TkvTx:
        return TkvTx(self, write)

    def del_range(self, lower: bytes, upper: bytes) -> None:
        _lib().tkv_del_range(self.handle, lower, len(lower), upper, len(upper))

    def range_compact(self, lower: bytes, upper: bytes) -> None:
        _lib().tkv_compact(self.handle)

    def batch_put(self, items) -> None:
        # bulk-restore path: chunked commits with the overlay built in one
        # SortedDict() constructor pass (per-item insertion costs ~2.5µs;
        # backup files scan in key order, the constructor's best case)
        from itertools import islice

        it = iter(items)
        while True:
            chunk = list(islice(it, 500_000))
            if not chunk:
                break
            tx = self.transact(write=True)
            tx.overlay = SortedDict(chunk)
            tx.commit()

    def close(self) -> None:
        if self.handle:
            _lib().tkv_close(self.handle)
            self.handle = None
