"""Graph fixed-rule iterations over numpy CSR (counterpart of
`cozo_tpu/ops/graph_algos.py`).

The host stages graphs as numpy CSR (`fixed_payload.as_directed_graph`);
below the device threshold (`fixed_rule/algos.TPU_EDGE_THRESHOLD`) the
rules run on the host (`pagerank_numpy` here, the rest in
`fixed_rule/algos.py`).  At or above it they run here, on the device the
caller names: `device=None` is the card (and raises without one, as
`utils/device.default_device` does), `device="cpu"` runs the plain
PyTorch versions of the kernels.

Three loops that the JAX package keeps on the device are hand-written
CUDA kernels, each with a plain PyTorch version in this module that its
wrapper takes for CPU tensors only:

  - `pagerank_steps` (`csrc/graph_pagerank.cu`): every PageRank step of a
    call, enqueued back to back with no host sync, over the binned layout
    `_pagerank_bins` builds on the card once per graph (destinations in
    bins of `PR_BIN_NODES`, each bin's edges by source); plain
    `pagerank_plain` (the JAX two-level prefix sum);
  - `sssp_ell` (`csrc/graph_sssp.cu`): the synchronous sliced-ELL
    Bellman-Ford and its parent witnesses; the host reads the device's
    "changed" flags every `SSSP_CHECK_EVERY` steps, not every step; plain
    `sssp_ell_plain`;
  - `lp_pick` (`csrc/graph_labelprop.cu`): the weighted-mode label pick
    over padded rows, for the dense layout and every lane width; plain
    `lp_pick_plain`.

The opt-in alternates are plain PyTorch on either device: the sort label
propagation (`COZO_TPU_LP_IMPL=sort`), the scatter SSSP
(`COZO_TPU_SSSP_IMPL=scatter`) and the scan SSSP (`COZO_TPU_SSSP_SCAN=1`).

Caches, as in the JAX package: staged device images by graph content key
in `_GRAPH_DEV_CACHE` (every key carries the device, so a CPU Db and a
card Db in one process never share tensors), the host destination sort in
`_HOST_STAGE_CACHE`, the PageRank source array published for SSSP under
("srcdev", ...), and packed SSSP images on disk (`COZO_TPU_GRAPH_CACHE`,
default `.graph_cache/` in the checkout).  The port's disk images are
named `sssp1t_*.npz`; the JAX package's are `sssp1_*.npz`, so neither
package ever loads the other's.  The JAX package's ahead-of-time load of
its SSSP executable in a background thread (`_sssp_prefetch_exec`) has no
counterpart: each kernel is built once per checkout at first use
(`ops/_build.py`) and loaded once per process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import time
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import default_device, to_device
from ..utils.graph_stage import gather_f32, stage_by_dst
from . import _build


def _pad_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def pagerank_numpy(indptr, dst, theta=0.85, epsilon=1e-4, iterations=10):
    n = len(indptr) - 1
    out_deg = np.diff(indptr).astype(np.float64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    ranks = np.full(n, 1.0 / n)
    safe_deg = np.where(out_deg > 0, out_deg, 1.0)
    for _ in range(iterations):
        contrib = ranks / safe_deg
        incoming = np.zeros(n)
        np.add.at(incoming, dst, contrib[src])
        dangling = ranks[out_deg == 0].sum()
        new_ranks = (1 - theta) / n + theta * (incoming + dangling / n)
        if np.abs(new_ranks - ranks).sum() < epsilon:
            ranks = new_ranks
            break
        ranks = new_ranks
    return ranks


# edges are processed in chunks of at most this many per device op (the
# scatter SSSP alternate), so the gather working set stays bounded
EDGE_CHUNK = 1 << 24

_PR_CHUNK = 8192

# ------------------------------------------------------------------ caches

# (tag, device, content key, ...) -> staged device tensors; repeated
# fixed-rule queries over the same graph skip the host->device transfer
_GRAPH_DEV_CACHE = {}
_GRAPH_DEV_CACHE_MAX = 4


def graph_content_key(indptr, dst) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(indptr))
    h.update(np.ascontiguousarray(dst))
    return h.hexdigest()


_W_FP_CACHE = {}  # id(w) -> (weakref(w), f32 copy, digest, uniform_scalar)


def _w_fingerprint(w):
    """(f32 view/copy, blake2b digest, uniform-scalar-or-None) of an edge
    weight array, memoized by object identity: the CSR cache in
    query/fixed_payload.py returns the same ndarray across calls, so a
    repeated SSSP/LP on a big graph would otherwise repay a full copy,
    hash and uniformity scan per call.  The weakref guards id() reuse
    after the original array is freed."""
    hit = _W_FP_CACHE.get(id(w))
    if hit is not None and hit[0]() is w:
        return hit[1], hit[2], hit[3]
    # evict dead entries eagerly: each one pins a full f32 weight copy
    for k in [k for k, v in _W_FP_CACHE.items() if v[0]() is None]:
        del _W_FP_CACHE[k]
    w_np = np.ascontiguousarray(np.asarray(w, dtype=np.float32))
    h = hashlib.blake2b(digest_size=8)
    h.update(w_np)
    digest = h.hexdigest()
    uniform = (
        float(w_np.flat[0])
        if w_np.size and bool(np.all(w_np == w_np.flat[0]))
        else None
    )
    try:
        ref = weakref.ref(w)
    except TypeError:  # plain lists etc.
        ref = lambda: w  # noqa: E731
    if isinstance(w, np.ndarray):
        # the digest memoizes by identity: an in-place mutation of the
        # source would silently reuse a stale staged device image, so
        # freeze it (CSR-cache consumers are read-only by contract)
        w.flags.writeable = False
    if len(_W_FP_CACHE) > 16:
        _W_FP_CACHE.clear()
    _W_FP_CACHE[id(w)] = (ref, w_np, digest, uniform)
    return w_np, digest, uniform


def _edge_data_key(cache_key, w):
    """A topology content key extended with a fingerprint of the edge
    weights: staged images bake the weights in, so same-topology,
    different-weight calls must not share them."""
    if cache_key is None:
        return None
    if w is None:
        return (cache_key, "unw")
    _, digest, _ = _w_fingerprint(w)
    return (cache_key, digest)


def _graph_disk_dir():
    """On-disk cache for packed SSSP images: `COZO_TPU_GRAPH_CACHE`
    overrides, the empty string disables; default `.graph_cache/` at the
    root of the checkout."""
    d = os.environ.get("COZO_TPU_GRAPH_CACHE")
    if d == "":
        return None
    if d is None:
        d = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), ".graph_cache")
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:
        return None


def _prune_graph_disk_cache(d):
    """Bound the on-disk image cache: evict the oldest images past
    COZO_TPU_GRAPH_CACHE_MAX_GB (default 16), never the newest, and sweep
    orphaned *.tmp.npz from interrupted saves."""
    try:
        cap = float(os.environ.get("COZO_TPU_GRAPH_CACHE_MAX_GB", 16)) * 1e9
        entries = []
        now = time.time()
        for de in os.scandir(d):
            if de.name.endswith(".tmp.npz"):
                if now - de.stat().st_mtime > 3600:
                    os.unlink(de.path)
                continue
            if de.name.endswith(".npz"):
                st = de.stat()
                entries.append((st.st_mtime, st.st_size, de.path))
        total = sum(s for _, s, _ in entries)
        for _, sz, path in sorted(entries)[:-1]:
            if total <= cap:
                break
            os.unlink(path)
            total -= sz
    except OSError:
        pass


def _dev_cache_put(key, value):
    if len(_GRAPH_DEV_CACHE) >= _GRAPH_DEV_CACHE_MAX:
        _GRAPH_DEV_CACHE.pop(next(iter(_GRAPH_DEV_CACHE)))
    _GRAPH_DEV_CACHE[key] = value


# host-side staging shared between kernels: PageRank, SSSP and the LP
# lanes all group edges by destination; pay it once per graph
_HOST_STAGE_CACHE = {}


def _host_stage_put(key, value):
    if len(_HOST_STAGE_CACHE) >= _GRAPH_DEV_CACHE_MAX:
        _HOST_STAGE_CACHE.pop(next(iter(_HOST_STAGE_CACHE)))
    _HOST_STAGE_CACHE[key] = value


def _dst_stage(indptr, dst, n_slots, cache_key):
    """(src_by_dst, order, deg) for the graph, cached per content key."""
    st = (
        _HOST_STAGE_CACHE.get(("dststage", cache_key, n_slots))
        if cache_key
        else None
    )
    if st is None:
        st = stage_by_dst(indptr, dst, n_slots)
        if cache_key:
            _host_stage_put(("dststage", cache_key, n_slots), st)
    return st


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(what: str, *tensors) -> None:
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous on "
                             f"the card, got {t.device} / contiguous="
                             f"{t.is_contiguous()}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------- PageRank


# destinations a bin of the PageRank kernel's layout holds
# (`COZO_PR_BIN_NODES` in csrc/graph_pagerank.cu, which takes no other
# size): their sums fill 112 KB of shared memory, the rest of the SM's is L1
PR_BIN_NODES = 14_336


def pagerank_plain(src_by_dst, in_ptr, out_deg, bin_src, bin_off, bin_ptr,
                   n_real: int, iterations: int, theta: float) -> torch.Tensor:
    """`iterations` PageRank steps in f32 on the tensors' device, each
    node's incoming sum taken from an f64 prefix sum over the
    destination-sorted contributions, diffed at the in-CSR bounds (the
    JAX function's f32 two-level prefix sum rounds each node's sum to the
    ulp of its 8,192-edge chunk's running total: about 1e-8 a node, an L1
    distance of 1e-5 and more from the direct sum).  Takes the staged
    tuple as the kernel does and reads its first three tensors (the
    binned layout is the kernel's alone).  Returns the ranks [n_pad] f32,
    0 on padding."""
    dev = src_by_dst.device
    n_pad = out_deg.shape[0]
    real = torch.arange(n_pad, device=dev) < n_real
    zero = torch.zeros((), device=dev)
    inv_n = torch.tensor(1.0, device=dev) / float(np.float32(n_real))
    ranks = torch.where(real, inv_n, zero)
    safe_deg = torch.where(out_deg > 0, out_deg, torch.ones_like(out_deg))
    is_dangling = (out_deg == 0) & real
    bounds = in_ptr.long()
    src = src_by_dst.long()
    for _ in range(iterations):
        contrib = ranks / safe_deg
        g = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                       contrib[src].double().cumsum(0)])[bounds]
        incoming = (g[1:] - g[:-1]).float()
        dangling = torch.where(is_dangling, ranks, zero).sum()
        new = (1 - theta) * inv_n + theta * (incoming + dangling * inv_n)
        ranks = torch.where(real, new, zero)
    return ranks


def _pagerank_bins(src_by_dst, in_ptr, n_real: int,
                   bin_nodes: int = PR_BIN_NODES):
    """The kernel's layout of a staged graph, built where its tensors lie
    (one sort of (bin, source, offset) keys): the real destinations cut
    into bins of `bin_nodes` consecutive nodes, each bin's edges in
    ascending source order, no padding edge.  Returns bin_src [e] i32
    (the sources), bin_off [e] i16 (each destination's offset in its
    bin) and bin_ptr [ceil(n_real / bin_nodes) + 1] i32 (each bin's first
    edge)."""
    if not 0 < bin_nodes < 1 << 15:
        raise ValueError("_pagerank_bins: offsets are 15-bit")
    dev = src_by_dst.device
    n_bins = -(-n_real // bin_nodes)
    starts = (torch.arange(n_bins + 1, device=dev) * bin_nodes).clamp_(
        max=n_real)
    bin_ptr = in_ptr[starts].contiguous()
    e = int(in_ptr[n_real])
    dst = torch.repeat_interleave(
        torch.arange(n_real, device=dev),
        (in_ptr[1:n_real + 1] - in_ptr[:n_real]).long(), output_size=e)
    key = ((dst // bin_nodes) << 46) | (src_by_dst[:e].long() << 15) | (
        dst % bin_nodes)
    del dst
    key = torch.sort(key).values
    bin_src = ((key >> 15) & 0x7FFFFFFF).int()
    bin_off = (key & 0x7FFF).short()
    return bin_src, bin_off, bin_ptr


_PR_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
                + [ctypes.c_void_p] * 7)


def _bind_pagerank(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.cozo_pagerank.argtypes is None:
        lib.cozo_pagerank.argtypes = _PR_ARGTYPES
        lib.cozo_pagerank.restype = ctypes.c_int
        lib.cozo_pagerank_max_blocks.restype = ctypes.c_int
        lib.cozo_pagerank_bin_nodes.restype = ctypes.c_int
    return lib


def _pagerank_launch(lib, src_by_dst, in_ptr, out_deg, bin_src, bin_off,
                     bin_ptr, n_real: int, iterations: int, theta: float,
                     stream) -> torch.Tensor:
    """Enqueues the kernel's steps on `stream` for checked arguments;
    returns the ranks tensor it writes."""
    dev = out_deg.device
    n_pad = out_deg.shape[0]
    ranks = torch.empty(n_pad, dtype=torch.float32, device=dev)
    ca = torch.empty_like(ranks)
    cb = torch.empty_like(ranks)
    sums = torch.empty(n_pad, dtype=torch.int64, device=dev)
    parts = torch.empty(lib.cozo_pagerank_max_blocks(), dtype=torch.float32,
                        device=dev)
    dang = torch.empty(1, dtype=torch.float32, device=dev)
    # the f32 constants as the JAX function rounds them
    inv_n = np.float32(1.0) / np.float32(n_real)
    c0 = np.float32(1 - theta) * inv_n
    err = lib.cozo_pagerank(
        _ptr(bin_src), _ptr(bin_off), bin_ptr.data_ptr(),
        bin_ptr.shape[0] - 1, bin_src.shape[0], out_deg.data_ptr(), n_real,
        n_pad, iterations, float(inv_n), float(c0), float(np.float32(theta)),
        ranks.data_ptr(), ca.data_ptr(), cb.data_ptr(), sums.data_ptr(),
        parts.data_ptr(), dang.data_ptr(), stream)
    _build.check(lib, err, "graph_pagerank launch")
    return ranks


def pagerank_steps(src_by_dst, in_ptr, out_deg, bin_src, bin_off, bin_ptr,
                   n_real: int, iterations: int, theta: float) -> torch.Tensor:
    """`iterations` PageRank steps over a staged graph (`_pagerank_stage`):
    src_by_dst [e_pad] i32, in_ptr [n_pad + 1] i32, out_deg [n_pad] f32
    and the binned layout (`_pagerank_bins`).  Returns the ranks [n_pad]
    f32.  CUDA tensors launch `csrc/graph_pagerank.cu` over the layout
    (all steps in one call, counted in `pagerank_steps.launches`); CPU
    tensors run `pagerank_plain`."""
    n_pad = out_deg.shape[0]
    if in_ptr.shape[0] != n_pad + 1 or not 0 < n_real < n_pad:
        raise ValueError("pagerank_steps: in_ptr must be [n_pad + 1] and "
                         "0 < n_real < n_pad")
    if src_by_dst.device.type == "cpu":
        return pagerank_plain(src_by_dst, in_ptr, out_deg, bin_src, bin_off,
                              bin_ptr, n_real, iterations, theta)
    _check_cuda("pagerank_steps", src_by_dst, in_ptr, out_deg, bin_src,
                bin_off, bin_ptr)
    if (bin_src.dtype != torch.int32 or bin_off.dtype != torch.int16
            or bin_ptr.dtype != torch.int32 or out_deg.dtype != torch.float32):
        raise ValueError("pagerank_steps: i32 sources and bin bounds, i16 "
                         "offsets, f32 degrees")
    if (bin_ptr.shape[0] != -(-n_real // PR_BIN_NODES) + 1
            or bin_off.shape != bin_src.shape):
        raise ValueError("pagerank_steps: the binned layout must be built "
                         "for this graph at PR_BIN_NODES")
    lib = _bind_pagerank(_build.load("graph_pagerank"))
    with torch.cuda.device(out_deg.device):
        ranks = _pagerank_launch(lib, src_by_dst, in_ptr, out_deg, bin_src,
                                 bin_off, bin_ptr, n_real, iterations, theta,
                                 _stream(out_deg))
    pagerank_steps.launches += 1
    return ranks


pagerank_steps.launches = 0


def _pagerank_stage(indptr, dst, cache_key, dev, bins=None):
    """The staged (src_by_dst, in_ptr, out_deg, bin_src, bin_off, bin_ptr)
    tensors of a graph on `dev`, cached by content key; publishes the
    source array for SSSP.  The binned layout is built when `bins` is
    true, by default on the card only (the plain version never reads it:
    on the CPU its three tensors are empty)."""
    n = len(indptr) - 1
    e = len(dst)
    n_pad = _pad_pow2(n + 1)
    # edges pad to chunk multiples at 1/16-pow2 granularity: a 69M-edge
    # graph pads to ~70M, not 134M
    gran = max(_PR_CHUNK, _pad_pow2(max(e, 1)) // 16)
    e_pad = ((max(e, 1) + gran - 1) // gran) * gran
    key = ("pr", str(dev), cache_key)
    staged = _GRAPH_DEV_CACHE.get(key) if cache_key else None
    if staged is not None:
        return staged
    # a dummy slot (rank forced to 0) takes the padding edges
    dummy = n_pad - 1
    src_e, _order, deg = _dst_stage(indptr, dst, n_pad, cache_key)
    src_by_dst = np.full(e_pad, dummy, dtype=np.int32)
    src_by_dst[:e] = src_e
    in_ptr = np.zeros(n_pad + 1, dtype=np.int32)
    in_ptr[1:n_pad + 1] = np.cumsum(deg)
    in_ptr[n_pad] = e_pad  # padding edges belong to the dummy slot
    out_deg = np.ones(n_pad, dtype=np.float32)  # 1.0 on padding avoids 0/0
    out_deg[:n] = np.diff(indptr)
    src_t, ptr_t = to_device(src_by_dst, dev), to_device(in_ptr, dev)
    if bins is None:
        bins = src_t.device.type == "cuda"
    layout = (_pagerank_bins(src_t, ptr_t, n) if bins else (
        torch.empty(0, dtype=torch.int32, device=src_t.device),
        torch.empty(0, dtype=torch.int16, device=src_t.device),
        torch.empty(0, dtype=torch.int32, device=src_t.device)))
    staged = (src_t, ptr_t, to_device(out_deg, dev), *layout)
    if cache_key:
        _dev_cache_put(key, staged)
        # the same destination-sorted sources, dummy fill and e_pad that
        # the SSSP pack needs at scale (both granules are pow2(e)/16 past
        # ~131K edges): SSSP after PageRank skips its upload (an alias)
        _dev_cache_put(("srcdev", str(dev), cache_key, n_pad, e_pad),
                       staged[0])
    return staged


def pagerank_jax(indptr, dst, theta=0.85, iterations=10, cache_key=None,
                 device=None):
    """Exactly `iterations` PageRank steps on `device` (no epsilon stop,
    as the JAX package's device path); returns f64 ranks [n]."""
    dev = default_device(device)
    n = len(indptr) - 1
    staged = _pagerank_stage(indptr, dst, cache_key, dev)
    ranks = pagerank_steps(*staged, n, iterations, float(theta))
    return ranks[:n].cpu().numpy().astype(np.float64)


def pagerank(indptr, dst, theta=0.85, epsilon=1e-4, iterations=10,
             use_tpu=False, device=None):
    if use_tpu:
        return pagerank_jax(indptr, dst, theta=theta, iterations=iterations,
                            cache_key=graph_content_key(indptr, dst),
                            device=device)
    return pagerank_numpy(
        indptr, dst, theta=theta, epsilon=epsilon, iterations=iterations
    )


# ---------------------------------------------------------------------------
# batched single-source shortest paths: sliced-ELL Bellman-Ford
#
# Edges grouped by destination are packed into degree-bucketed padded
# gather matrices (sliced ELLPACK), all buckets in one flat [P] array:
# bucket (off, cap, rows_p) holds its rows as [cap, rows_p], rows on the
# minor axis.  Hub nodes past ELL_CAP_MAX in-edges split into rows whose
# minima feed a second-level layout of the same form.  The destination
# grouping is the native counting sort of `utils/graph_stage.py`, shared
# with PageRank; the pack runs on the device.

ELL_CAP_MAX = 1024
_ELL_LANE = 512  # rows pad to this multiple
# the host reads the kernel's "changed" flags after this many steps
SSSP_CHECK_EVERY = 8
# a step of the kernel pushes over the out-edges of the nodes that fell at
# the step before when those out-edges are at most this share of all
# edges, else it pulls over the ELL
SSSP_PUSH_SHARE = 0.25
# sources a kernel thread carries (`MAX_SG` in csrc/graph_sssp.cu; 1 when
# there is one source)
SSSP_GROUP = 8


def _stage_sssp_ell_meta(deg, n_pad, e_pad):
    """Bucket metadata from the in-degree histogram.  Returns (layout,
    p_layout, row_start_flat, row_len_flat, node_flat, R_pad, level2,
    node_pos)."""
    starts = np.zeros(len(deg) + 1, np.int64)
    np.cumsum(deg, out=starts[1:])

    nodes_in = np.nonzero(deg > 0)[0]
    nd = deg[nodes_in]
    rows_per = (nd + ELL_CAP_MAX - 1) // ELL_CAP_MAX
    R = int(rows_per.sum())
    rowptr = np.concatenate([[0], np.cumsum(rows_per)])
    row_node = np.repeat(nodes_in, rows_per)
    row_ofs = (
        np.arange(R, dtype=np.int64) - np.repeat(rowptr[:-1], rows_per)
    ) * ELL_CAP_MAX
    row_start = starts[row_node] + row_ofs
    row_len = np.minimum(deg[row_node] - row_ofs, ELL_CAP_MAX)
    row_cap = (2 ** np.ceil(np.log2(np.maximum(row_len, 1))).astype(np.int64))

    layout = []  # (flat row offset, cap, rows_p)
    p_layout = []  # (offset into packed edge space, cap, rows_p)
    rs_chunks, rl_chunks, node_chunks = [], [], []
    global_pos = np.empty(R, dtype=np.int64)
    base = 0
    p_off = 0
    for cap in sorted(set(row_cap.tolist())):
        rc = np.nonzero(row_cap == cap)[0]
        rows_c = len(rc)
        rows_p = ((rows_c + _ELL_LANE - 1) // _ELL_LANE) * _ELL_LANE
        rs = np.zeros(rows_p, np.int32)
        rs[:rows_c] = row_start[rc]
        rl = np.zeros(rows_p, np.int32)
        rl[:rows_c] = row_len[rc]
        node_c = np.full(rows_p, n_pad - 1, dtype=np.int32)
        node_c[:rows_c] = row_node[rc]
        layout.append((base, int(cap), rows_p))
        p_layout.append((p_off, int(cap), rows_p))
        rs_chunks.append(rs)
        rl_chunks.append(rl)
        node_chunks.append(node_c)
        global_pos[rc] = base + np.arange(rows_c)
        base += rows_p
        p_off += int(cap) * rows_p
    R_pad = base

    # level 2: per-node min over its virtual rows' partial minima
    cnt = rows_per
    cnt_cap = (2 ** np.ceil(np.log2(np.maximum(cnt, 1))).astype(np.int64))
    level2 = []
    out_nodes = []
    for cap in sorted(set(cnt_cap.tolist())):
        nc = np.nonzero(cnt_cap == cap)[0]
        m_c = len(nc)
        m_p = ((m_c + _ELL_LANE - 1) // _ELL_LANE) * _ELL_LANE
        cols = np.arange(cap, dtype=np.int64)
        idx = rowptr[nc][:, None] + cols[None, :]
        valid = cols[None, :] < cnt[nc][:, None]
        rowpos = np.full((cap, m_p), R_pad, dtype=np.int32)
        rowpos[:, :m_c] = np.where(
            valid, global_pos[np.minimum(idx, max(R - 1, 0))], R_pad
        ).T
        level2.append(rowpos)
        out_nodes.append(np.pad(nodes_in[nc], (0, m_p - m_c),
                                constant_values=n_pad - 1))
    if out_nodes:
        out_nodes = np.concatenate(out_nodes)
    else:
        out_nodes = np.empty(0, np.int64)
    M = len(out_nodes)
    node_pos = np.full(n_pad, M, dtype=np.int32)
    node_pos[out_nodes[out_nodes != n_pad - 1]] = np.nonzero(
        out_nodes != n_pad - 1
    )[0].astype(np.int32)
    rs_flat = np.concatenate(rs_chunks) if rs_chunks else np.zeros(0, np.int32)
    rl_flat = np.concatenate(rl_chunks) if rl_chunks else np.zeros(0, np.int32)
    nd_flat = (
        np.concatenate(node_chunks) if node_chunks else np.zeros(0, np.int32)
    )
    return (
        tuple(layout), tuple(p_layout), rs_flat, rl_flat, nd_flat, R_pad,
        level2, node_pos,
    )


def _sssp_pack(s_sorted, w_sorted, rs_flat, rl_flat, layout, e_pad: int,
               n_pad: int):
    """Padded-bucket packing of destination-sorted edges on their device
    (gathers only).  `w_sorted` None (uniform weights): no weight array
    is built; a padding slot names the dummy node, whose distance stays
    +inf.  Returns (flat_src [P] i32, flat_w [P] f32 or None)."""
    dev = s_sorted.device
    outs_s, outs_w = [], []
    for off, cap, rows_p in layout:
        rs = rs_flat[off:off + rows_p].long()
        rl = rl_flat[off:off + rows_p]
        cols = torch.arange(cap, device=dev)[:, None]
        idx = (rs[None, :] + cols).clamp(0, e_pad - 1)
        valid = cols < rl[None, :]
        outs_s.append(torch.where(valid, s_sorted[idx],
                                  torch.full((), n_pad - 1, dtype=s_sorted.dtype,
                                             device=dev)).reshape(-1))
        if w_sorted is not None:
            outs_w.append(torch.where(valid, w_sorted[idx],
                                      torch.full((), float("inf"),
                                                 device=dev)).reshape(-1))
        del idx, valid
    flat_src = torch.cat(outs_s).to(torch.int32)
    return flat_src, (torch.cat(outs_w) if w_sorted is not None else None)


class EllGraph(NamedTuple):
    """A staged sliced-ELL graph on one device.  The JAX layout
    (`p_layout`, `level2`, `node_pos`) for the plain version; the flat
    forms the kernel takes (`row_desc`, `l2_flat`, `l2_desc`,
    `out_nodes`: the node of each level-2 column, -1 on padding) and the
    out-CSR its push steps read (`out_ptr` [n_pad + 1] i64, `out_dst`
    [e] i32, `out_w` [e] f32 or None for w_uni) of the graph's `n`
    nodes."""

    flat_src: torch.Tensor
    flat_w: Optional[torch.Tensor]  # None: every slot weighs w_uni
    w_uni: float
    p_layout: tuple
    R_pad: int
    node_flat: torch.Tensor
    level2: tuple
    node_pos: torch.Tensor
    n_pad: int
    row_desc: np.ndarray
    l2_flat: torch.Tensor
    l2_desc: np.ndarray
    out_nodes: torch.Tensor
    out_ptr: torch.Tensor
    out_dst: torch.Tensor
    out_w: Optional[torch.Tensor]
    n: int


def _out_csr(indptr, dst, w_np, n_pad, dev):
    """The caller's CSR on `dev` as the kernel's push steps read it: the
    row pointers padded to n_pad + 1 (nodes past n have no out-edge), the
    destinations, the weights (None: uniform), and n."""
    n = len(indptr) - 1
    ptr = np.full(n_pad + 1, indptr[-1], dtype=np.int64)
    ptr[:n + 1] = indptr
    return (to_device(ptr, dev),
            to_device(np.require(dst, np.int32, ["C", "W"]), dev),
            None if w_np is None else to_device(
                np.require(w_np, np.float32, ["C", "W"]), dev), n)


def ell_graph(flat_src, flat_w, w_uni, nd_flat, level2_h, node_pos_h,
              p_layout, R_pad, n_pad, dev, out_csr) -> EllGraph:
    """An `EllGraph` on `dev` from the host layout (numpy level-2 arrays
    and node positions, as `_stage_sssp_ell_meta` gives them), the
    packed device arrays and the out-CSR (`_out_csr`)."""
    row_desc, base = [], 0
    for off, cap, rows_p in p_layout:
        row_desc.append((base, off, cap, rows_p))
        base += rows_p
    l2_desc, col, slot = [], 0, 0
    for rp in level2_h:
        cap, m_p = rp.shape
        l2_desc.append((col, slot, cap, m_p))
        col += m_p
        slot += cap * m_p
    M = col
    out_nodes = np.full(M, -1, dtype=np.int32)
    has = node_pos_h < M
    out_nodes[node_pos_h[has]] = np.nonzero(has)[0]
    l2_flat = (np.concatenate([rp.reshape(-1) for rp in level2_h])
               if level2_h else np.zeros(0, np.int32))
    return EllGraph(
        flat_src, flat_w, float(np.float32(w_uni)) if flat_w is None else 0.0,
        tuple(p_layout), int(R_pad), to_device(np.ascontiguousarray(nd_flat), dev),
        tuple(to_device(np.ascontiguousarray(rp), dev) for rp in level2_h),
        to_device(np.ascontiguousarray(node_pos_h), dev), int(n_pad),
        np.asarray(row_desc, dtype=np.int64).reshape(-1, 4),
        to_device(np.ascontiguousarray(l2_flat, dtype=np.int32), dev),
        np.asarray(l2_desc, dtype=np.int64).reshape(-1, 4),
        to_device(out_nodes, dev), *out_csr,
    )


def _initial_dist(sources, n_pad, dev):
    S = len(sources)
    dist0 = torch.full((S, n_pad), float("inf"), device=dev)
    dist0[torch.arange(S, device=dev),
          torch.as_tensor(np.asarray(sources, dtype=np.int64), device=dev)] = 0.0
    return dist0


def _ell_candidates(g: EllGraph, dist):
    """dist[:, flat_src] + w for every slot: [S, P]."""
    cand = dist[:, g.flat_src.long()]
    return cand + (g.flat_w if g.flat_w is not None else g.w_uni)


def sssp_ell_plain(g: EllGraph, sources, max_iters: int):
    """The JAX function's arithmetic in PyTorch (one [S, P] candidate
    array a step, a host sync a step).  Returns (dist [S, n_pad] f32,
    parent [S, n_pad] i32, steps run)."""
    dev = g.flat_src.device
    inf = float("inf")
    dist0 = _initial_dist(sources, g.n_pad, dev)
    S = dist0.shape[0]
    l2 = [rp.long() for rp in g.level2]
    node_pos = g.node_pos.long()

    def relax(dist):
        cand = _ell_candidates(g, dist)
        outs = [cand[:, off:off + cap * rows_p].view(S, cap, rows_p).amin(1)
                for off, cap, rows_p in g.p_layout]
        rowmins = torch.cat(outs + [torch.full((S, 1), inf, device=dev)], 1)
        louts = [rowmins[:, rp].amin(1) for rp in l2]
        nodemins = torch.cat(louts + [torch.full((S, 1), inf, device=dev)], 1)
        return torch.minimum(dist, nodemins[:, node_pos])

    dist, it, changed = dist0, 0, True
    while it < max_iters and changed:
        nd = relax(dist)
        changed = bool((nd < dist).any())
        dist, it = nd, it + 1

    cand = _ell_candidates(g, dist)
    wits, l_off = [], 0
    for off, cap, rows_p in g.p_layout:
        seg = cand[:, off:off + cap * rows_p].view(S, cap, rows_p)
        srcs = g.flat_src[off:off + cap * rows_p].view(cap, rows_p)
        node_b = g.node_flat[l_off:l_off + rows_p].long()
        ok = (seg == dist[:, node_b][:, None, :]) & torch.isfinite(seg)
        wits.append(torch.where(ok, srcs, torch.full((), -1, dtype=srcs.dtype,
                                                     device=dev)).amax(1))
        l_off += rows_p
    neg = torch.full((S, 1), -1, dtype=torch.int32, device=dev)
    roww = torch.cat(wits + [neg], 1)
    nodew = torch.cat([roww[:, rp].amax(1) for rp in l2] + [neg], 1)
    par = nodew[:, node_pos]
    par = torch.where(torch.isfinite(dist), par, -1)
    par = torch.where(dist0 == 0.0, -1, par)
    return dist, par.to(torch.int32), it


_SSSP_RELAX_ARGTYPES = (
    [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
    + [ctypes.c_void_p])
_SSSP_PARENT_ARGTYPES = (
    [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 5)


def _bind_sssp(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.cozo_sssp_relax.argtypes is None:
        lib.cozo_sssp_relax.argtypes = _SSSP_RELAX_ARGTYPES
        lib.cozo_sssp_relax.restype = ctypes.c_int
        lib.cozo_sssp_parent.argtypes = _SSSP_PARENT_ARGTYPES
        lib.cozo_sssp_parent.restype = ctypes.c_int
    return lib


def _desc_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _sssp_launch(lib, g: EllGraph, sources, max_iters: int, stream,
                 push_share: float = SSSP_PUSH_SHARE):
    """Runs the kernel for checked arguments: SSSP_CHECK_EVERY steps a
    call, then the flags of those steps are read; then the parents.  A
    step pushes when its frontier's out-edges are at most `push_share` of
    all edges (>= 1: always; < 0: never).  Returns (dist, parent, steps
    run, calls into the kernel, (frontier sizes [steps + 1, G], their
    out-edges [steps + 1, G]) on the device)."""
    dev = g.flat_src.device
    S, n_pad = len(sources), g.n_pad
    G = 1 if S == 1 else -(-S // SSSP_GROUP)
    T = max(max_iters, 1)
    # the kernel's first step puts each source's 0 into both buffers
    dist_a, dist_b = torch.full((2, S, n_pad), float("inf"), device=dev)
    rowmin = torch.empty((S, g.R_pad), dtype=torch.float32, device=dev)
    frontier = torch.empty((2, G, n_pad), dtype=torch.int32, device=dev)
    # the zeroed scratch in one buffer: the frontiers' out-edge counts
    # (i64), their sizes and the "changed" flags (i32)
    n_i64 = (T + 1) * G
    zeroed = torch.zeros(n_i64 + -(-(n_i64 + T) // 2), dtype=torch.int64,
                         device=dev)
    fedges = zeroed[:n_i64].view(T + 1, G)
    counts = zeroed[n_i64:].view(torch.int32)
    fcount, changed = counts[:n_i64].view(T + 1, G), counts[n_i64:n_i64 + T]
    src_t = to_device(np.asarray(sources, dtype=np.int32), dev)
    # the parent pass's buffers too, so that nothing but its launch waits
    # for the host after the last flags are read
    rowwit = torch.empty((S, g.R_pad), dtype=torch.int32, device=dev)
    parent = torch.full((S, n_pad), -1, dtype=torch.int32, device=dev)
    M = g.out_nodes.shape[0]
    common = (g.flat_src.data_ptr(), _ptr(g.flat_w), g.w_uni,
              _desc_ptr(g.row_desc), len(g.row_desc), g.R_pad)
    l2 = (g.l2_flat.data_ptr(), _desc_ptr(g.l2_desc), len(g.l2_desc), M,
          g.out_nodes.data_ptr())
    out_csr = (g.out_ptr.data_ptr(), g.out_dst.data_ptr(), _ptr(g.out_w),
               g.out_dst.shape[0], float(push_share), src_t.data_ptr())
    it = steps_run = calls = 0
    while it < max_iters:
        steps = min(SSSP_CHECK_EVERY, max_iters - it)
        err = lib.cozo_sssp_relax(
            *common, *l2, *out_csr, S, n_pad, g.n, dist_a.data_ptr(),
            dist_b.data_ptr(), rowmin.data_ptr(), frontier.data_ptr(),
            fcount.data_ptr(), fedges.data_ptr(), changed.data_ptr(), it,
            steps, stream)
        _build.check(lib, err, "graph_sssp relax launch")
        calls += 1
        flags = changed[it:it + steps].cpu().numpy()
        it += steps
        still = np.nonzero(flags == 0)[0]
        if len(still):
            steps_run = it - steps + int(still[0]) + 1
            break
        steps_run = it
    # both buffers hold the same distances after every step
    dist = dist_a
    err = lib.cozo_sssp_parent(
        *common, g.node_flat.data_ptr(), *l2, S, n_pad, src_t.data_ptr(),
        dist.data_ptr(), rowwit.data_ptr(), parent.data_ptr(), stream)
    _build.check(lib, err, "graph_sssp parent launch")
    return (dist, parent, steps_run, calls + 1,
            (fcount[:steps_run + 1], fedges[:steps_run + 1]))


def sssp_ell(g: EllGraph, sources, max_iters: int):
    """Synchronous Bellman-Ford from each of `sources` over the staged
    graph, then the parent witnesses: (dist [S, n_pad] f32, parent
    [S, n_pad] i32, steps run).  On the card `csrc/graph_sssp.cu` runs
    SSSP_CHECK_EVERY steps between reads of its "changed" flags, never
    past `max_iters` (steps at the fixed point change nothing, so the
    result equals a check after every step), each step a push from the
    nodes that fell at the step before or, past SSSP_PUSH_SHARE of the
    edges, a pull over the ELL; each call into the kernel counts in
    `sssp_ell.launches`, each solve in `sssp_ell.solves`.  CPU tensors
    run `sssp_ell_plain`."""
    if g.flat_src.device.type == "cpu":
        return sssp_ell_plain(g, sources, max_iters)
    _check_cuda("sssp_ell", g.flat_src, g.flat_w, g.node_flat, g.l2_flat,
                g.out_nodes, g.out_ptr, g.out_dst, g.out_w)
    lib = _bind_sssp(_build.load("graph_sssp"))
    with torch.cuda.device(g.flat_src.device):
        dist, parent, steps_run, calls, _ = _sssp_launch(
            lib, g, sources, max_iters, _stream(g.flat_src))
    sssp_ell.launches += calls
    sssp_ell.solves += 1
    return dist, parent, steps_run


sssp_ell.launches = 0
sssp_ell.solves = 0


def _sssp_scatter_plain(src, dst, w, dist0, max_iters, n_pad, e_pad):
    """Edge-chunked Bellman-Ford with segment min / max as scatter
    reductions (`_sssp_compiled_scatter`); parents follow each step."""
    S = dist0.shape[0]
    n_chunks = max(1, e_pad // min(e_pad, EDGE_CHUNK))
    src_c = src.long().view(n_chunks, -1)
    dst_c = dst.long().view(n_chunks, -1)
    w_c = w.view(n_chunks, -1)
    dev = dist0.device
    dist = dist0
    parent = torch.full(dist0.shape, -1, dtype=torch.int32, device=dev)
    it, changed = 0, True
    while it < max_iters and changed:
        nd, npar = dist, parent
        for s, d, wt in zip(src_c, dst_c, w_c):
            cand = dist[:, s] + wt[None, :]
            d_e = d[None, :].expand(S, -1)
            cd = torch.full((S, n_pad), float("inf"), device=dev)
            cd = cd.scatter_reduce(1, d_e, cand, "amin")
            achieves = cand <= cd[:, d]
            wit = torch.full((S, n_pad), -1, dtype=torch.int32, device=dev)
            wit = wit.scatter_reduce(
                1, d_e, torch.where(achieves, s.to(torch.int32)[None, :], -1),
                "amax")
            better = cd < nd
            nd, npar = (torch.minimum(nd, cd),
                        torch.where(better & (wit >= 0), wit, npar))
        improved = nd < dist
        parent = torch.where(improved, npar, parent)
        changed = bool(improved.any())
        dist, it = nd, it + 1
    return dist, parent


def _sssp_scan_plain(src, dst, w, has_in, dist0, max_iters, n_pad):
    """Edge-parallel Bellman-Ford over destination-sorted edges, parents
    after convergence (`_sssp_compiled`, whose segmented associative
    scans compute these segment minima and maxima)."""
    S = dist0.shape[0]
    dev = dist0.device
    s_l, d_l = src.long(), dst.long()
    d_e = d_l[None, :].expand(S, -1)
    dist, it, changed = dist0, 0, True
    while it < max_iters and changed:
        cand = dist[:, s_l] + w[None, :]
        seg = torch.full((S, n_pad), float("inf"), device=dev)
        seg = seg.scatter_reduce(1, d_e, cand, "amin")
        nd = torch.where(has_in[None, :], torch.minimum(dist, seg), dist)
        changed = bool((nd < dist).any())
        dist, it = nd, it + 1
    cand = dist[:, s_l] + w[None, :]
    ok = (cand == dist[:, d_l]) & torch.isfinite(cand)
    wit = torch.where(ok, src[None, :], -1).to(torch.int32)
    par = torch.full((S, n_pad), -1, dtype=torch.int32, device=dev)
    par = par.scatter_reduce(1, d_e, wit, "amax")
    par = torch.where(has_in[None, :] & torch.isfinite(dist), par, -1)
    par = torch.where(dist0 == 0.0, -1, par)
    return dist, par


# The scan alternate (COZO_TPU_SSSP_SCAN=1) is taken up to this many
# padded edges, as in the JAX package
SSSP_SCAN_MAX_EDGES = 1 << 24


def _sssp_use_scan(e_pad: int) -> bool:
    if os.environ.get("COZO_TPU_SSSP_SCAN") != "1":
        return False
    return e_pad <= SSSP_SCAN_MAX_EDGES


def _sssp_ell_stage(indptr, dst, w, cache_key, dev, log):
    """The staged `EllGraph` of a graph on `dev`: from the device cache,
    else packed from PageRank's source array on the device, else from the
    disk image, else staged on the host and packed on the device."""
    t0 = time.time()
    n = len(indptr) - 1
    e = len(dst)
    n_pad = _pad_pow2(n + 1)
    w_np, w_digest, w_uni = _w_fingerprint(w)
    uniform = w_uni is not None
    # weights are baked into the staged image: key them in
    dk = (
        (cache_key, f"u{w_uni!r}") if uniform else (cache_key, w_digest)
    ) if cache_key else None
    staged = _GRAPH_DEV_CACHE.get(("sssp4", str(dev), dk)) if dk else None
    if staged is not None:
        return staged
    gran = max(_ELL_LANE, _pad_pow2(max(e, 1)) // 16)
    e_pad = ((max(e, 1) + gran - 1) // gran) * gran
    # PageRank over the same graph already put the destination-sorted
    # sources on this device: packing from that alias beats the upload
    # and the disk image
    src_dev = (
        _GRAPH_DEV_CACHE.get(("srcdev", str(dev), cache_key, n_pad, e_pad))
        if cache_key else None
    )
    disk = _graph_disk_dir() if cache_key else None
    fpath = None
    if disk and dk:
        wtag = "uni" if uniform else dk[1]
        fpath = os.path.join(disk, f"sssp1t_{cache_key}_{n_pad}_{wtag}.npz")
    loaded = None
    if src_dev is None and fpath and os.path.exists(fpath):
        try:
            loaded = np.load(fpath)
        except Exception:  # noqa: BLE001 - a bad image is rebuilt below
            loaded = None
    out_csr = _out_csr(indptr, dst, None if uniform else w_np, n_pad, dev)
    if loaded is not None:
        p_layout = tuple(
            tuple(int(x) for x in row) for row in loaded["p_layout"]
        )
        l2_h = [loaded[f"l2_{i}"] for i in range(int(loaded["n_l2"]))]
        flat_src = to_device(loaded["flat_src"], dev)
        flat_w = None if uniform else to_device(loaded["flat_w"], dev)
        staged = ell_graph(flat_src, flat_w, w_uni, loaded["nd_flat"], l2_h,
                           loaded["node_pos"], p_layout, int(loaded["R_pad"]),
                           n_pad, dev, out_csr)
        if log:
            print(f"# sssp-ell disk-cached image {time.time() - t0:.1f}s",
                  flush=True)
    else:
        src_e, order, deg = _dst_stage(indptr, dst, n_pad, cache_key)
        (layout, p_layout, rs_flat, rl_flat, nd_flat, R_pad, l2_host,
         node_pos_h) = _stage_sssp_ell_meta(deg, n_pad, e_pad)
        t_meta = time.time()
        if src_dev is not None:
            s_dev = src_dev  # device alias: no host build or upload
        else:
            s_sorted = np.full(e_pad, n_pad - 1, dtype=np.int32)
            s_sorted[:e] = src_e
            s_dev = to_device(s_sorted, dev)
        w_dev = None
        if not uniform:
            w_sorted = np.full(e_pad, np.inf, dtype=np.float32)
            w_sorted[:e] = gather_f32(w_np, order)
            w_dev = to_device(w_sorted, dev)
        flat_src, flat_w = _sssp_pack(
            s_dev, w_dev, to_device(rs_flat, dev), to_device(rl_flat, dev),
            layout, e_pad, n_pad)
        staged = ell_graph(flat_src, flat_w, w_uni, nd_flat, l2_host,
                           node_pos_h, p_layout, R_pad, n_pad, dev, out_csr)
        if log:
            print(
                f"# sssp-ell meta {t_meta - t0:.1f}s "
                f"pack {time.time() - t_meta:.1f}s "
                f"src={'dev-alias' if src_dev is not None else 'upload'} "
                f"layout {p_layout}",
                flush=True,
            )
        # persist the packed image only when it was built from a host
        # upload (pulling an aliased one back costs what the alias saves)
        if fpath and src_dev is None and not os.path.exists(fpath):
            try:
                save = {
                    "flat_src": flat_src.cpu().numpy(),
                    "nd_flat": nd_flat,
                    "node_pos": node_pos_h,
                    "p_layout": np.asarray(p_layout, dtype=np.int64),
                    "R_pad": np.int64(R_pad),
                    "n_l2": np.int64(len(l2_host)),
                }
                for i, rp in enumerate(l2_host):
                    save[f"l2_{i}"] = rp
                if not uniform:
                    save["flat_w"] = flat_w.cpu().numpy()
                tmp = fpath + ".tmp"
                np.savez(tmp, **save)
                os.replace(tmp + ".npz", fpath)
                _prune_graph_disk_cache(os.path.dirname(fpath))
                if log:
                    print("# sssp-ell image saved to disk cache", flush=True)
            except OSError:
                pass
    if dk:
        _dev_cache_put(("sssp4", str(dev), dk), staged)
    return staged


def sssp_device(indptr, dst, w, sources, max_iters: int = 512,
                cache_key=None, device=None):
    """Batched SSSP over CSR on `device`; returns (dist [S, n] f64,
    parent [S, n] i64) numpy.

    Default: the sliced-ELL kernel.  COZO_TPU_SSSP_IMPL=scatter selects
    the scatter alternate, COZO_TPU_SSSP_SCAN=1 the scan alternate (up to
    SSSP_SCAN_MAX_EDGES padded edges; past it the scatter one)."""
    dev = default_device(device)
    n = len(indptr) - 1
    e = len(dst)
    n_pad = _pad_pow2(n + 1)
    if os.environ.get("COZO_TPU_SSSP_IMPL", "ell") == "ell" and e > 0 \
            and os.environ.get("COZO_TPU_SSSP_SCAN") != "1":
        log = os.environ.get("COZO_TPU_SSSP_LOG") == "1"
        t0 = time.time()
        g = _sssp_ell_stage(indptr, dst, w, cache_key, dev, log)
        t1 = time.time()
        dist, parent, iters = sssp_ell(g, sources, max_iters)
        out = (
            dist[:, :n].cpu().numpy().astype(np.float64),
            parent[:, :n].cpu().numpy().astype(np.int64),
        )
        if log:
            print(
                f"# sssp-ell run {time.time() - t1:.1f}s "
                f"iters {iters} total {time.time() - t0:.1f}s",
                flush=True,
            )
        return out
    # pad at 1/16-pow2 granularity; above EDGE_CHUNK, to chunk multiples
    if e > EDGE_CHUNK:
        e_pad = ((e + EDGE_CHUNK - 1) // EDGE_CHUNK) * EDGE_CHUNK
    else:
        gran = max(4096, _pad_pow2(max(e, 1)) // 16)
        e_pad = ((max(e, 1) + gran - 1) // gran) * gran
    use_scan = _sssp_use_scan(e_pad)
    tag = "sssp2" if use_scan else "sssp"
    dk = _edge_data_key(cache_key, w)  # the staged image bakes w in
    staged = _GRAPH_DEV_CACHE.get((tag, str(dev), dk)) if dk else None
    if staged is None:
        dummy = n_pad - 1
        src = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
        src_p = np.full(e_pad, dummy, dtype=np.int32)
        dst_p = np.full(e_pad, dummy, dtype=np.int32)
        w_p = np.full(e_pad, np.inf, dtype=np.float32)
        if use_scan:
            order = np.argsort(dst, kind="stable")
            src_p[:e] = src[order]
            dst_p[:e] = np.asarray(dst)[order]
            w_p[:e] = np.asarray(w, dtype=np.float32)[order]
            counts = np.bincount(dst_p, minlength=n_pad)
            has_in = (counts > 0) & (np.arange(n_pad) < n)
            staged = (to_device(src_p, dev), to_device(dst_p, dev),
                      to_device(w_p, dev), to_device(has_in, dev))
        else:
            src_p[:e] = src
            dst_p[:e] = dst
            w_p[:e] = w
            staged = (to_device(src_p, dev), to_device(dst_p, dev),
                      to_device(w_p, dev))
        if dk:
            _dev_cache_put((tag, str(dev), dk), staged)
    dist0 = _initial_dist(sources, n_pad, dev)
    if use_scan:
        src_t, dst_t, w_t, has_in = staged
        dist, parent = _sssp_scan_plain(src_t, dst_t, w_t, has_in, dist0,
                                        max_iters, n_pad)
    else:
        dist, parent = _sssp_scatter_plain(*staged, dist0, max_iters, n_pad,
                                           e_pad)
    return (
        dist[:, :n].cpu().numpy().astype(np.float64),
        parent[:, :n].cpu().numpy().astype(np.int64),
    )


# ------------------------------------------------------------- label prop

LP_DENSE_DMAX = 128
LP_MAX_W = 8192  # the widest row the pick kernel takes
_LP_BIG = 2**31 - 1


def _lane_blk(W: int) -> int:
    """Rows per block of the plain pick, so its [blk, W, W] equality
    workspace stays ~512MB."""
    return max(1, min(65536, (1 << 27) // max(W * W, 1)))


def lp_pick_plain(labels, nb, w, idx, has_in, n_real: int, out) -> None:
    """The JAX pick in PyTorch (the [blk, W, W] equality tensor and a
    batched product per block of rows), writing `out` as `lp_pick`
    does.  Weights below 0 count as 0."""
    H, W = nb.shape
    dev = nb.device
    dummy = labels.shape[0] - 1
    blk = _lane_blk(W)
    picks = []
    for b0 in range(0, H, blk):
        nb_b = nb[b0:b0 + blk].long()
        if w is None:
            valid = nb_b != dummy
            w_b = valid.float()
        else:
            w_b = w[b0:b0 + blk].clamp(min=0)
            valid = w_b > 0
        L = labels[nb_b]  # [blk, W]
        eq = (L[:, :, None] == L[:, None, :]).float()
        wsum = torch.bmm(eq, w_b[:, :, None])[:, :, 0]
        del eq
        wsum = torch.where(valid, wsum, float("-inf"))
        maxw = wsum.amax(1, keepdim=True)
        cand = torch.where(wsum == maxw, L, _LP_BIG)
        picks.append(cand.amin(1))
    picked = torch.cat(picks) if picks else torch.zeros(0, dtype=labels.dtype,
                                                        device=dev)
    picked = picked.to(labels.dtype)
    if idx is None:
        keep = has_in[:H] & (torch.arange(H, device=dev) < n_real)
        out[:H] = torch.where(keep, picked, labels[:H])
    else:
        keep = idx != dummy
        out[idx[keep].long()] = picked[keep]


_LP_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                + [ctypes.c_void_p] * 3)


def _bind_lp(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.cozo_lp_pick.argtypes is None:
        lib.cozo_lp_pick.argtypes = _LP_ARGTYPES
        lib.cozo_lp_pick.restype = ctypes.c_int
    return lib


def _lp_launch(lib, labels, nb, w, idx, has_in, n_real: int, out,
               stream) -> None:
    H, W = nb.shape
    err = lib.cozo_lp_pick(
        nb.data_ptr(), _ptr(w), _ptr(idx), _ptr(has_in), H, W, n_real,
        labels.shape[0] - 1, labels.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, err, "graph_labelprop launch")


def lp_pick(labels, nb, w, idx, has_in, n_real: int, out) -> None:
    """One synchronous pick over padded rows nb [H, W] i32 (w [H, W] f32,
    or None for unit weights), reading labels [n_pad] i32 and writing out
    [n_pad] i32: the weighted mode of each row's labels, ties to the
    smallest.  idx None: the dense layout (row h is node h; rows without
    in-edges or past n_real copy their label; `has_in` [H] bool).  idx
    [H] i32: row h writes node idx[h] (dummy rows are padding), and `out`
    must already hold `labels` elsewhere.  CUDA tensors launch
    `csrc/graph_labelprop.cu` (counted in `lp_pick.launches`); CPU
    tensors run `lp_pick_plain`."""
    H, W = nb.shape
    if idx is None and has_in is None:
        raise ValueError("lp_pick: the dense layout needs has_in")
    if nb.device.type == "cpu":
        lp_pick_plain(labels, nb, w, idx, has_in, n_real, out)
        return
    _check_cuda("lp_pick", labels, nb, w, idx, has_in, out)
    if W > LP_MAX_W:
        raise ValueError(f"lp_pick: rows of {W} slots (limit {LP_MAX_W})")
    if has_in is not None and has_in.dtype != torch.bool:
        raise ValueError("lp_pick: has_in must be bool")
    lib = _bind_lp(_build.load("graph_labelprop"))
    with torch.cuda.device(nb.device):
        _lp_launch(lib, labels, nb, w, idx, has_in, n_real, out, _stream(nb))
    lp_pick.launches += 1


lp_pick.launches = 0


def _labelprop_sort(indptr, dst, w, iterations, cache_key, n, e, dev):
    """The sort label propagation (`_labelprop_compiled`,
    COZO_TPU_LP_IMPL=sort): gather the neighbours' labels along the
    destination-sorted edges, sort by the composite key (dst, label),
    run totals by a cumsum, and per destination the largest total, ties
    to the smallest label.  Plain PyTorch on either device."""
    n_pad = _pad_pow2(n + 1)
    gran = max(_PR_CHUNK, _pad_pow2(max(e, 1)) // 16)
    e_pad = ((max(e, 1) + gran - 1) // gran) * gran
    dk = _edge_data_key(cache_key, w)
    staged = _GRAPH_DEV_CACHE.get(("lp", str(dev), dk)) if dk else None
    if staged is None:
        dummy = n_pad - 1
        src = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
        order = np.argsort(dst, kind="stable")
        src_by_dst = np.full(e_pad, dummy, dtype=np.int32)
        src_by_dst[:e] = src[order]
        dst_e = np.full(e_pad, dummy, dtype=np.int32)
        dst_e[:e] = np.asarray(dst)[order]
        w_by_dst = np.zeros(e_pad, dtype=np.float32)
        if w is None:
            w_by_dst[:e] = 1.0
        else:
            # negative weights would break the monotone run totals
            w_by_dst[:e] = np.maximum(
                np.asarray(w, dtype=np.float32)[order], 0.0)
        counts = np.bincount(dst_e, minlength=n_pad)
        has_in = (counts > 0) & (np.arange(n_pad) < n)
        staged = (to_device(src_by_dst, dev), to_device(dst_e, dev),
                  to_device(w_by_dst, dev), to_device(has_in, dev))
        if dk:
            _dev_cache_put(("lp", str(dev), dk), staged)
    src_by_dst, dst_e, w_e, has_in = staged
    src_l, dst_l = src_by_dst.long(), dst_e.long()
    neg = -3.4e38
    labels = torch.arange(n_pad, dtype=torch.int32, device=dev)
    for _ in range(iterations):
        lab_e = labels[src_l]
        key = (dst_l << 32) | lab_e.long()
        _, perm = torch.sort(key, stable=True)
        d_s, lab_s, w_s = dst_l[perm], lab_e[perm], w_e[perm]
        diff = (d_s[1:] != d_s[:-1]) | (lab_s[1:] != lab_s[:-1])
        one = torch.ones(1, dtype=torch.bool, device=dev)
        run_start = torch.cat([one, diff])
        run_end = torch.cat([diff, one])
        s = torch.cumsum(w_s, 0)
        base = torch.cummax(torch.where(run_start, s - w_s, neg), 0).values
        cand = torch.where(run_end, s - base, neg)
        best = torch.full((n_pad,), float("-inf"), device=dev)
        best = best.scatter_reduce(0, d_s, cand, "amax")
        lab_best = torch.where(cand == best[d_s], lab_s, _LP_BIG)
        picked = torch.full((n_pad,), _LP_BIG, dtype=torch.int32, device=dev)
        picked = picked.scatter_reduce(0, d_s, lab_best, "amin")
        labels = torch.where(has_in, picked, labels)
    return labels[:n].cpu().numpy()


def labelprop_jax(indptr, dst, w=None, iterations=10, cache_key=None,
                  degree_cap=None, device=None):
    """Synchronous label propagation over a CSR graph on `device`;
    returns int labels[n] (label ids are node indices; the rule layer
    canonicalises them).

    Dispatch, as the JAX package's: max in-degree <= LP_DENSE_DMAX takes
    the dense padded-neighbour layout end to end on the device; with
    `degree_cap` hubs keep only their `cap` highest-weight in-edges (the
    first in order when unweighted), still dense; otherwise the hybrid
    lanes, where nodes past COZO_TPU_LP_TIER_MAX (and lanes past the
    COZO_TPU_LP_DENSE_MAX byte budget) take an exact host weighted mode
    between device steps.  COZO_TPU_LP_IMPL=sort selects the sort path."""
    dev = default_device(device)
    n = len(indptr) - 1
    e = len(dst)
    in_deg = np.bincount(np.asarray(dst), minlength=n)
    if in_deg.max(initial=0) <= LP_DENSE_DMAX:
        return _labelprop_dense(
            indptr, dst, w, iterations, cache_key, in_deg, n, e, dev
        )
    if degree_cap:
        cap = min(int(degree_cap), LP_DENSE_DMAX)
        return _labelprop_dense(
            indptr, dst, w, iterations,
            (cache_key + f"#cap{cap}") if cache_key else None,
            np.minimum(in_deg, cap), n, e, dev, cap=cap,
        )
    if os.environ.get("COZO_TPU_LP_IMPL", "hybrid") != "sort":
        return _labelprop_hybrid(
            indptr, dst, w, iterations, cache_key, in_deg, n, e, dev
        )
    return _labelprop_sort(indptr, dst, w, iterations, cache_key, n, e, dev)


def _labelprop_hybrid(indptr, dst, w, iterations, cache_key, in_deg, n, e,
                      dev):
    """Exact synchronous LP for power-law graphs: every node is packed
    into a lane of power-of-two width >= its in-degree (device memory
    about twice the edges, not n x max degree), and only nodes past
    COZO_TPU_LP_TIER_MAX (default 8192) take the exact host weighted mode
    between device steps.  Without such a hub the whole loop runs on the
    device with no host sync.  COZO_TPU_LP_DENSE_MAX bounds the lanes'
    bytes; lanes past it spill to the host pass."""
    lp_log = os.environ.get("COZO_TPU_LP_LOG") == "1"
    t0 = time.time()
    n_pad = _pad_pow2(n + 1)
    weighted = w is not None
    dk = _edge_data_key(cache_key, w)
    staged = _GRAPH_DEV_CACHE.get(("lph2", str(dev), dk)) if dk else None
    if staged is None:
        dummy = n_pad - 1
        src_s, order, deg_pad = _dst_stage(indptr, dst, n_pad, cache_key)
        if lp_log:
            print(f"# lp-hybrid dst_stage {time.time() - t0:.1f}s",
                  flush=True)
        w_s = None if w is None else np.maximum(gather_f32(w, order), 0.0)
        budget = int(os.environ.get("COZO_TPU_LP_DENSE_MAX", 4 << 30))
        # lanes wider than the pick kernel takes go to the host lane, which
        # is exact: the labels are the same at any tier
        tier_max = min(int(os.environ.get("COZO_TPU_LP_TIER_MAX", 8192)),
                       LP_MAX_W)
        bytes_per_slot = 8 if weighted else 4
        deg = deg_pad[:n]
        # lane id per node = ceil-pow2 of in-degree (min 8)
        lane_w_of = np.maximum(
            1 << np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64), 8
        )
        lane_w_of[deg == 0] = 0  # no in-edges: keeps its label
        node_start = np.zeros(n_pad, dtype=np.int64)
        np.cumsum(deg_pad[:-1], out=node_start[1:])
        lanes = []  # (shape, nb, idx, w) host arrays
        spill = np.zeros(n, dtype=bool)
        used = 0
        for W in (1 << np.arange(3, 32)):
            if W > tier_max or not (lane_w_of == W).any():
                if W > max(tier_max, lane_w_of.max(initial=0)):
                    break
                spill |= lane_w_of == W
                continue
            nodes_l = np.nonzero(lane_w_of == W)[0]
            blk = _lane_blk(int(W))
            H_pad = -(-len(nodes_l) // blk) * blk
            need = H_pad * int(W) * bytes_per_slot + H_pad * 4
            if used + need > budget:
                spill |= lane_w_of == W
                continue
            used += need
            lens = deg[nodes_l]
            tot = int(lens.sum())
            rows = np.repeat(np.arange(len(nodes_l), dtype=np.int64), lens)
            cols = np.arange(tot, dtype=np.int64) - np.repeat(
                np.cumsum(lens, dtype=np.int64) - lens, lens
            )
            eidx = np.repeat(node_start[nodes_l], lens) + cols
            nb_l = np.full((H_pad, int(W)), dummy, dtype=np.int32)
            nb_l[rows, cols] = src_s[eidx]
            idx_l = np.full(H_pad, dummy, dtype=np.int32)
            idx_l[: len(nodes_l)] = nodes_l
            w_l = None
            if weighted:
                w_l = np.zeros((H_pad, int(W)), dtype=np.float32)
                w_l[rows, cols] = w_s[eidx]
            lanes.append(((H_pad, int(W), blk), nb_l, idx_l, w_l))
        # host lane: mega-hubs + budget spill (exact segment mode)
        hub_nodes = np.nonzero(spill)[0].astype(np.int64)
        lens = deg[hub_nodes]
        tot = int(lens.sum())
        cols = np.arange(tot, dtype=np.int64) - np.repeat(
            np.cumsum(lens, dtype=np.int64) - lens, lens
        )
        eidx = np.repeat(node_start[hub_nodes], lens) + cols
        h_src = src_s[eidx].astype(np.int64)
        h_seg = np.repeat(np.arange(len(hub_nodes), dtype=np.int64), lens)
        h_w = (
            w_s[eidx].astype(np.float64)
            if weighted
            else np.ones(tot, dtype=np.float64)
        )
        lane_shapes = tuple(s for s, _, _, _ in lanes)
        dev_lanes = tuple(
            (to_device(nb_l, dev), to_device(idx_l, dev),
             None if w_l is None else to_device(w_l, dev))
            for _, nb_l, idx_l, w_l in lanes)
        staged = (lane_shapes, dev_lanes, hub_nodes, h_src, h_seg, h_w)
        if cache_key:
            _dev_cache_put(("lph2", str(dev), dk), staged)
        if lp_log:
            print(
                f"# lp-hybrid staged {time.time() - t0:.1f}s lanes "
                f"{[(int(s[1]), int(s[0])) for s in lane_shapes]} "
                f"host-hubs {len(hub_nodes)} dev_bytes {used}",
                flush=True,
            )
    lane_shapes, dev_lanes, hub_nodes, h_src, h_seg, h_w = staged

    def step(labels, out):
        out.copy_(labels)
        for nb_l, idx_l, w_l in dev_lanes:
            lp_pick(labels, nb_l, w_l, idx_l, None, n, out)

    labels = torch.arange(n_pad, dtype=torch.int32, device=dev)
    out = torch.empty_like(labels)
    if len(hub_nodes) == 0:
        for _ in range(iterations):
            step(labels, out)
            labels, out = out, labels
        labels = labels.cpu().numpy()
        if lp_log:
            print(f"# lp-hybrid device loop {time.time() - t0:.1f}s",
                  flush=True)
        return labels[:n]
    labels_h = np.arange(n_pad, dtype=np.int32)
    for _ in range(iterations):
        labels.copy_(torch.from_numpy(labels_h))
        step(labels, out)
        picked = out.cpu().numpy().copy()
        # exact weighted mode per hub: segment-key bincount over (hub,
        # neighbour label), ties to the smallest label (the device pick's
        # tie rule)
        lab_e = labels_h[h_src].astype(np.int64)
        keys = h_seg * np.int64(n_pad) + lab_e
        uk, inv = np.unique(keys, return_inverse=True)
        wsum = np.bincount(inv, weights=h_w)
        u_seg = uk // n_pad
        u_lab = (uk % n_pad).astype(np.int64)
        sel = np.lexsort((u_lab, -wsum, u_seg))
        first = np.ones(len(sel), dtype=bool)
        seg_sorted = u_seg[sel]
        first[1:] = seg_sorted[1:] != seg_sorted[:-1]
        picked[hub_nodes[seg_sorted[first]]] = u_lab[sel[first]]
        labels_h = picked
        if lp_log:
            print(f"# lp-hybrid iter {time.time() - t0:.1f}s cumulative",
                  flush=True)
    return labels_h[:n]


def _labelprop_dense(indptr, dst, w, iterations, cache_key, in_deg, n, e,
                     dev, cap=None):
    n_pad = _pad_pow2(n + 1)
    dmax = int(1 << max(3, int(np.ceil(np.log2(max(in_deg.max(), 1))))))
    weighted = w is not None
    dk = _edge_data_key(cache_key, w)
    staged = _GRAPH_DEV_CACHE.get(("lpd", str(dev), dk)) if dk else None
    if staged is None:
        dummy = n_pad - 1
        if cap is not None and w is not None:
            # keep each dst's `cap` highest-weight in-edges
            src = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
            order = np.lexsort(
                (-np.asarray(w, dtype=np.float32), np.asarray(dst))
            )
            src_s = src[order]
            dst_s = np.asarray(dst)[order].astype(np.int64)
            cnt = np.bincount(dst_s, minlength=n)
        else:
            src_s, order, deg_pad = _dst_stage(indptr, dst, n_pad, cache_key)
            cnt = deg_pad[:n]
            dst_s = np.repeat(np.arange(n, dtype=np.int64), cnt)
        in_ptr = np.zeros(n + 1, dtype=np.int64)
        in_ptr[1:] = np.cumsum(cnt)
        pos = np.arange(len(dst_s), dtype=np.int64) - in_ptr[dst_s]
        if cap is not None:
            keep = pos < cap
            src_s, dst_s, pos = src_s[keep], dst_s[keep], pos[keep]
            order = order[keep]
            cnt = np.minimum(cnt, cap)
        nb = np.full((n_pad, dmax), dummy, dtype=np.int32)
        nb[dst_s, pos] = src_s
        wq_d = None  # unit weights: the valid mask comes from nb itself
        if weighted:
            wq = np.zeros((n_pad, dmax), dtype=np.float32)
            wq[dst_s, pos] = np.maximum(gather_f32(w, order), 0.0)
            wq_d = to_device(wq, dev)
        has_in = np.zeros(n_pad, dtype=bool)
        has_in[:n] = cnt > 0
        staged = (to_device(nb, dev), wq_d, to_device(has_in, dev))
        if dk:
            _dev_cache_put(("lpd", str(dev), dk), staged)
    nb_d, wq_d, has_in_d = staged
    labels = torch.arange(n_pad, dtype=torch.int32, device=dev)
    out = torch.empty_like(labels)
    for _ in range(iterations):
        lp_pick(labels, nb_d, wq_d, None, has_in_d, n, out)
        labels, out = out, labels
    return labels[:n].cpu().numpy()
