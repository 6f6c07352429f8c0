"""Host-side edge staging for the device graph kernels.

`stage_by_dst` groups CSR edges by destination (stable) and returns the
per-edge sources, the permutation, and the in-degree histogram — the
exact inputs PageRank / sliced-ELL SSSP staging needs before device
upload (ops/graph_algos.py).  Fast path: one C counting-sort pass
(native/graphstage.c, built on demand); fallback: numpy
(repeat + stable argsort), bit-identical output.

Reference anchor: the reference's CPU algorithms need no such staging
(fixed_rule/algos/shortest_path_dijkstra.rs:432, pagerank.rs) — this
cost is TPU-upload-specific, hence the native pass to keep it off the
critical path on a 1-core host.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_LIB_TRIED = False


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        here = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        native = os.path.join(here, "native")
        so = os.path.join(native, "libgraphstage.so")
        src = os.path.join(native, "graphstage.c")

        def compile_so():
            subprocess.run(
                ["gcc", "-O3", "-shared", "-fPIC", "-o", so, src],
                check=True,
                capture_output=True,
            )

        # mtime comparison misfires on fresh git checkouts (both files get
        # the checkout time), so also retry with a forced recompile if
        # loading a stale/wrong-arch committed binary fails
        if not os.path.exists(so) or (
            os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(so)
        ):
            compile_so()
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            compile_so()
            lib = ctypes.CDLL(so)
        lib.stage_by_dst.restype = ctypes.c_int
        lib.stage_by_dst.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.gather_f32.restype = None
        lib.gather_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def stage_by_dst(indptr, dst, n_slots):
    """Group CSR edges by destination (stable within a destination).

    Returns (src_by_dst int32[e], order int64[e], deg int64[n_slots])
    where `order` maps output slot -> original edge index.
    """
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    n = len(indptr) - 1
    e = len(dst)
    lib = None if os.environ.get("COZO_TPU_NO_NATIVE_STAGE") else _load()
    if lib is not None and e > 0:
        src_out = np.empty(e, dtype=np.int32)
        order = np.empty(e, dtype=np.int64)
        deg = np.empty(n_slots, dtype=np.int64)
        rc = lib.stage_by_dst(
            indptr.ctypes.data, dst.ctypes.data, n, e, int(n_slots),
            src_out.ctypes.data, order.ctypes.data, deg.ctypes.data,
        )
        if rc == 0:
            return src_out, order, deg
    deg = np.bincount(dst.astype(np.int64), minlength=n_slots).astype(
        np.int64
    )
    order = np.argsort(dst, kind="stable").astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    return src[order], order, deg


def gather_f32(w, order):
    """w[order] as a tight native pass (numpy fallback otherwise)."""
    w = np.ascontiguousarray(w, dtype=np.float32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    lib = None if os.environ.get("COZO_TPU_NO_NATIVE_STAGE") else _load()
    if lib is not None and len(order):
        out = np.empty(len(order), dtype=np.float32)
        lib.gather_f32(w.ctypes.data, order.ctypes.data, len(order),
                       out.ctypes.data)
        return out
    return w[order]
