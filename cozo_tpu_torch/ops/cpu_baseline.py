"""ctypes binding for the measured CPU HNSW baseline
(`native/hnsw_baseline.cpp`, the reference algorithm's single-thread
HNSW; counterpart of `cozo_tpu/ops/cpu_baseline.py`), against which the
port's graph quality and build time are held.  The source is the JAX
package's, read in place, built into the port's own git-ignored
directory (`ops/_build.build_host`), never over `native/libhnswb.so`."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ._build import build_host

_LIB = None

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HNSWB_SRC = os.path.join(_ROOT, "native", "hnsw_baseline.cpp")
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_host(HNSWB_SRC, GXX_FLAGS, "libhnswb-{hash}.so"))
    lib.hnswb_new.restype = ctypes.c_void_p
    lib.hnswb_new.argtypes = [ctypes.c_int] * 4
    lib.hnswb_free.argtypes = [ctypes.c_void_p]
    lib.hnswb_add_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.hnswb_search_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.hnswb_count.restype = ctypes.c_int
    lib.hnswb_count.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class CpuHnswBaseline:
    """Single-thread C++ HNSW (reference-algorithm semantics, in-memory)."""

    def __init__(self, dim: int, m: int = 16, ef_construction: int = 200,
                 metric: str = "L2") -> None:
        self.lib = _lib()
        self.dim = dim
        self.ptr = self.lib.hnswb_new(
            dim, m, ef_construction, 0 if metric == "L2" else 1
        )

    def add(self, data: np.ndarray) -> None:
        d = np.ascontiguousarray(data, dtype=np.float32)
        self.lib.hnswb_add_batch(
            self.ptr, d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            d.shape[0],
        )

    def search(self, qs: np.ndarray, k: int, ef: int):
        q = np.ascontiguousarray(qs, dtype=np.float32)
        B = q.shape[0]
        ids = np.empty((B, k), dtype=np.int64)
        dists = np.empty((B, k), dtype=np.float32)
        self.lib.hnswb_search_batch(
            self.ptr, q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), B, k,
            ef, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return ids, dists

    def __del__(self):
        try:
            self.lib.hnswb_free(self.ptr)
        except Exception:
            pass
