"""Brute-force k-NN and the batched device HNSW search (counterpart of
`cozo_tpu/ops/vector_search.py`).

A whole batch of queries descends the hierarchy on the device: a greedy
descent through the upper levels, then a level-0 beam of fixed width that
expands the `expand` nearest unexpanded entries per round, drops
neighbours already in the beam or seen earlier in the same expansion,
and re-selects the beam with a stable top-`beam` (equal distances keep
the lower position).  Visited-set semantics are approximated by the
in-beam dedup plus an iteration cap; recall is held against the host
search in the tests.

The JAX function (`_compiled_search`, `vector_search.py:81-205`) is two
`lax.while_loop`s that end when NO query has work; eager PyTorch would
pay a host sync per round.  Here the search is ONE launch of the
hand-written CUDA kernel `csrc/beam_search.cu` (one thread block per
query, beam and candidates in shared memory; a round dedups through a
hash table, lists only the candidates nearer than the beam's last and
merges them in by rank, with no sort of the whole).  A finished query's
round is a no-op in the JAX loops, so per-query termination gives the
same result.  `beam_search` launches the kernel for CUDA tensors and runs the
plain PyTorch version `beam_search_plain` (the JAX algorithm on tensors,
Python loops) for CPU tensors.

The device mirror of the index (`_device_arrays`) is cached by
`index.version`; small mutation sets are scattered into it in place.  The
mirror also keeps the staging buffers of `hnsw_search_device` (pinned
host memory that the kernel reads and writes in place, one set per batch
size), so a small-batch call allocates nothing and copies nothing on the
device.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from typing import Tuple

import numpy as np
import torch

from ..utils.device import default_device, to_device
from . import _build


def _pad_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def brute_force_knn(
    vectors: np.ndarray,
    norms_sq: np.ndarray,
    queries: np.ndarray,
    k: int,
    distance: str,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN via one matmul + top-k on `device` (the card unless
    given).  Used for small indexes, re-ranking, and recall validation."""
    dev = default_device(device)
    v = to_device(np.ascontiguousarray(vectors, dtype=np.float32), dev)
    q = to_device(np.ascontiguousarray(queries, dtype=np.float32), dev)
    nsq = to_device(np.ascontiguousarray(norms_sq, dtype=np.float32), dev)
    dots = q @ v.T  # [B, N]
    if distance == "L2":
        qn = torch.sum(q * q, dim=1, keepdim=True)
        d = qn + nsq[None, :] - 2.0 * dots
    elif distance == "IP":
        d = 1.0 - dots
    else:  # Cosine
        qn = torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))
        vn = torch.sqrt(nsq)[None, :]
        denom = torch.where(qn * vn > 0, qn * vn, torch.ones_like(dots))
        d = 1.0 - dots / denom
    neg_d, idx = torch.topk(-d, k)
    return (idx.cpu().numpy().astype(np.int64),
            (-neg_d).cpu().numpy().astype(np.float64))


# ------------------------------------------------------------ device search

DIST_KINDS = {"L2": 0, "IP": 1, "Cosine": 2}
# what the kernel's shared-memory layout takes (csrc/beam_search.cu): the
# keys of one round's candidates go into a power-of-two array of at most
# MAX_SORT entries, and the whole block state must fit the 227 KB a block
# may use
MAX_SORT = 4096
MAX_SMEM = 232_448


def _dist(qv: torch.Tensor, cv: torch.Tensor, dist_kind: int) -> torch.Tensor:
    """qv [B, d]; cv [B, K, d] -> [B, K], as `dist()` of the JAX function:
    L2 as qn + cn - 2 dot (not as a difference), Cosine with the
    qn * cn > 0 guard."""
    dots = torch.einsum("bkd,bd->bk", cv, qv)
    if dist_kind == 0:
        qn = torch.sum(qv * qv, dim=1, keepdim=True)
        cn = torch.sum(cv * cv, dim=2)
        return qn + cn - 2.0 * dots
    if dist_kind == 1:
        return 1.0 - dots
    qn = torch.sqrt(torch.sum(qv * qv, dim=1, keepdim=True))
    cn = torch.sqrt(torch.sum(cv * cv, dim=2))
    denom = torch.where(qn * cn > 0, qn * cn, torch.ones_like(dots))
    return 1.0 - dots / denom


def _stable_smallest(d: torch.Tensor, n: int):
    """The n smallest of each row in ascending order, equal values keeping
    the lower position first (`lax.top_k`'s tie rule; `torch.topk`
    promises none): (values, positions)."""
    sd, si = torch.sort(d, dim=1, stable=True)
    return sd[:, :n], si[:, :n]


def beam_round(ids, dists, expanded, nb0, vectors, qs, expand: int,
               dist_kind: int):
    """One round of the level-0 beam for every query (the body of the JAX
    `while_loop`): returns the new (ids, dists, expanded)."""
    B, beam = ids.shape
    m0 = nb0.shape[1]
    inf = math.inf
    sel_d = torch.where(expanded | (ids < 0), torch.full_like(dists, inf),
                        dists)
    sel_v, sel = _stable_smallest(sel_d, expand)  # [B, E]
    sel_active = sel_v < inf
    sel_ids = torch.gather(ids, 1, sel)
    expanded = expanded.scatter(1, sel, True)
    nbr = nb0[torch.where(sel_active, sel_ids, torch.zeros_like(sel_ids)).long()]
    nbr = torch.where(sel_active[:, :, None], nbr, torch.full_like(nbr, -1))
    nbr = nbr.reshape(B, expand * m0)
    valid = nbr >= 0
    # dedup against the current beam
    dup = (nbr[:, :, None] == ids[:, None, :]).any(dim=2)
    # dedup within the expansion (earlier occurrence wins)
    em = expand * m0
    tri = torch.tril(torch.ones((em, em), dtype=torch.bool,
                                device=ids.device), diagonal=-1)
    dup_new = ((nbr[:, :, None] == nbr[:, None, :]) & tri[None]).any(dim=2)
    valid = valid & ~dup & ~dup_new
    cv = vectors[torch.where(nbr >= 0, nbr, torch.zeros_like(nbr)).long()]
    nd = torch.where(valid, _dist(qs, cv, dist_kind),
                     torch.full((B, em), inf, device=ids.device))
    all_ids = torch.cat([ids, torch.where(valid, nbr,
                                          torch.full_like(nbr, -1))], dim=1)
    all_d = torch.cat([dists, nd], dim=1)
    all_exp = torch.cat([expanded, ~valid], dim=1)
    new_d, top = _stable_smallest(all_d, beam)
    return (torch.gather(all_ids, 1, top), new_d,
            torch.gather(all_exp, 1, top))


def beam_search_plain(vectors, nb0, up_nb, alive, entry: int, qs, k: int,
                      beam: int, n_levels: int, dist_kind: int,
                      max_iters: int, expand: int):
    """Plain PyTorch version of the kernel: `_compiled_search` on tensors,
    its two `while_loop`s as Python loops with host checks.

    vectors [n_pad, d] f32; nb0 [n_pad, m0] i32; up_nb
    [max(n_levels, 1), n_pad, m_up] i32 (row l-1 holds level l); alive
    [n_pad] bool; qs [B, d] f32 -> (ids [B, k] i32, dists [B, k] f32),
    missing results -1 / inf."""
    B = qs.shape[0]
    dev = qs.device
    inf = math.inf
    cur = torch.full((B,), entry, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    for lvl in range(n_levels - 1, -1, -1):
        curd = _dist(qs, vectors[cur.long()][:, None, :], dist_kind)[:, 0]
        moved = torch.ones((B,), dtype=torch.bool, device=dev)
        while bool(moved.any()):
            nbr = up_nb[lvl][cur.long()]  # [B, m_up]
            valid = nbr >= 0
            cv = vectors[torch.where(valid, nbr, torch.zeros_like(nbr)).long()]
            ds = torch.where(valid, _dist(qs, cv, dist_kind),
                             torch.full(nbr.shape, inf, device=dev))
            # first minimum, as jnp.argmin
            bestd, best = _stable_smallest(ds, 1)
            bestd, best = bestd[:, 0], best[:, 0]
            moved = bestd < curd
            cur = torch.where(moved, nbr[rows, best], cur)
            curd = torch.where(moved, bestd, curd)

    ids = torch.full((B, beam), -1, dtype=torch.int32, device=dev)
    ids[:, 0] = cur
    dists = torch.full((B, beam), inf, dtype=torch.float32, device=dev)
    dists[:, 0] = _dist(qs, vectors[cur.long()][:, None, :], dist_kind)[:, 0]
    expanded = torch.ones((B, beam), dtype=torch.bool, device=dev)
    expanded[:, 0] = False
    it = 0
    while it < max_iters and bool((~expanded & (ids >= 0)).any()):
        ids, dists, expanded = beam_round(ids, dists, expanded, nb0, vectors,
                                          qs, expand, dist_kind)
        it += 1
    # drop dead nodes, then top-k
    safe = torch.where(ids >= 0, ids, torch.zeros_like(ids)).long()
    dead = ~alive[safe] | (ids < 0)
    final_d = torch.where(dead, torch.full_like(dists, inf), dists)
    out_d, top = _stable_smallest(final_d, k)
    out_ids = torch.gather(ids, 1, top)
    out_ids = torch.where(torch.isinf(out_d), torch.full_like(out_ids, -1),
                          out_ids)
    return out_ids, out_d


def sort_size(expand: int, m0: int) -> int:
    """Entries of the kernel's key array: one round's candidates, rounded
    up to a power of two (the block sort's width when most of them are
    nearer than the beam's last)."""
    return max(_pad_pow2(expand * m0), 2)


def table_size(beam: int, expand: int, m0: int) -> int:
    """Slots of the kernel's dedup table: a power of two, at least twice
    the ids one round can enter (the beam's and the candidates')."""
    return _pad_pow2(2 * (beam + expand * m0))


def smem_bytes(d: int, m0: int, m_up: int, beam: int, expand: int) -> int:
    """Dynamic shared memory of one block, as csrc/beam_search.cu lays it
    out: the round's keys and the dedup table (8 bytes an entry), the query
    (padded to 4 floats), the beam (id, distance, expanded flag;
    double-buffered), the candidates (id, distance, position list) and the
    round's selection."""
    cand = max(expand * m0, m_up)
    return (8 * sort_size(expand, m0) + 8 * table_size(beam, expand, m0)
            + 4 * (-(-d // 4) * 4) + 24 * beam + 12 * cand + 4 * expand)


def out_size(B: int, k: int) -> int:
    """int32 entries the kernel writes for B queries: [B, 2k] (a query's k
    ids, then the bits of its k f32 distances) and behind it the counters
    [B, 4]."""
    return B * (2 * k + 4)


def _check(vectors, nb0, up_nb, alive, qs, k, beam, n_levels, expand):
    n_pad, d = vectors.shape
    if qs.dim() != 2 or qs.shape[1] != d or qs.shape[0] < 1:
        raise ValueError(f"beam_search: qs {tuple(qs.shape)} must be [B, {d}]")
    if (vectors.dtype != torch.float32 or qs.dtype != torch.float32
            or nb0.dtype != torch.int32 or up_nb.dtype != torch.int32
            or alive.dtype != torch.bool):
        raise TypeError("beam_search: vectors/qs f32, nb0/up_nb i32, alive bool")
    if (nb0.dim() != 2 or nb0.shape[0] != n_pad or up_nb.dim() != 3
            or up_nb.shape[1] != n_pad or alive.shape != (n_pad,)
            or up_nb.shape[0] < max(n_levels, 1)):
        raise ValueError("beam_search: graph arrays do not match the vectors")
    _check_params(k, beam, n_levels, expand)
    for t in (vectors, nb0, up_nb, alive, qs):
        if not t.is_contiguous() or t.device != qs.device:
            raise ValueError("beam_search: inputs must be contiguous and on "
                             "one device")


def _check_params(k: int, beam: int, n_levels: int, expand: int) -> None:
    if beam < 8 or beam % 8 or not 1 <= k <= beam or expand < 1 \
            or n_levels < 0:
        raise ValueError(
            f"beam_search: needs beam a multiple of 8, 1 <= k <= beam, "
            f"expand >= 1 (got beam={beam}, k={k}, expand={expand})")


def _check_layout(d: int, m0: int, m_up: int, beam: int, expand: int) -> None:
    smem = smem_bytes(d, m0, m_up, beam, expand)
    if sort_size(expand, m0) > MAX_SORT or smem > MAX_SMEM:
        raise ValueError(
            f"beam_search: expand * m0 = {expand * m0} candidates a round "
            f"(limit {MAX_SORT}) / {smem} bytes of shared memory (limit "
            f"{MAX_SMEM}) is more than the kernel takes")


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("beam_search")
    if lib.cozo_beam_search.argtypes is None:
        lib.cozo_beam_search.argtypes = _ARGTYPES
        lib.cozo_beam_search.restype = ctypes.c_int
        lib.cozo_chase.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]
        lib.cozo_chase.restype = ctypes.c_int
    return lib


def memory_round_trip_ms(n: int = 1 << 26, steps: int = 20_000,
                         device=None) -> float:
    """Milliseconds of one dependent load from device memory, measured: a
    single thread follows a random cycle through `n` ints (256 MB by
    default, past the L2 cache) for `steps` steps.  A measurement aid for
    the search's bound (each round costs at least one such trip); needs
    the card."""
    dev = default_device(device)
    if dev.type != "cuda":
        raise ValueError("memory_round_trip_ms: needs a CUDA device")
    perm = torch.randperm(n, device=dev, dtype=torch.int32)
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt[perm.long()] = torch.roll(perm, -1)
    del perm
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    _build.check(lib, lib.cozo_chase(nxt.data_ptr(), 1000, out.data_ptr(),
                                     stream), "chase launch")  # warm
    t0.record()
    _build.check(lib, lib.cozo_chase(nxt.data_ptr(), steps, out.data_ptr(),
                                     stream), "chase launch")
    t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / steps


def _launch(vectors, nb0, up_nb, alive, entry: int, qs, out, k: int,
            beam: int, n_levels: int, dist_kind: int, max_iters: int,
            expand: int, stream: int) -> None:
    """Enqueues the kernel on `stream` (a raw CUDA stream of the graph
    arrays' device) for arguments already checked, and counts the launch.
    `qs` and `out` lie on that device or in pinned host memory, which the
    device reads and writes in place."""
    lib = _lib()
    err = lib.cozo_beam_search(
        vectors.data_ptr(), nb0.data_ptr(), up_nb.data_ptr(),
        alive.data_ptr(), qs.data_ptr(), out.data_ptr(),
        qs.shape[0], vectors.shape[0], vectors.shape[1], nb0.shape[1],
        up_nb.shape[2], n_levels, int(entry), k, beam, expand, max_iters,
        dist_kind, vectors.device.index, stream,
    )
    _build.check(lib, err, "beam_search launch")
    beam_search.launches += 1


def beam_search(vectors, nb0, up_nb, alive, entry: int, qs, k: int,
                beam: int, n_levels: int, dist_kind: int, max_iters: int,
                expand: int, out=None):
    """Batched HNSW search, shapes as `beam_search_plain`.  CUDA tensors
    launch the kernel on the current stream (one launch for the whole
    search; counted in `beam_search.launches`); CPU tensors run
    `beam_search_plain`.

    The kernel writes into ONE int32 buffer of `out_size(B, k)` entries
    (`out`, allocated here unless given): [B, 2k] with a query's ids and
    the bits of its distances, then its per-query counters [B, 4]
    (descent steps, beam rounds, vector rows read, neighbour lists read),
    left in `beam_search.last_stats`.  The ids and distances returned are
    views of that buffer.  Raises where the shared-memory layout does not
    take the shape: sort_size(expand, m0) > MAX_SORT or smem_bytes(...) >
    MAX_SMEM."""
    _check(vectors, nb0, up_nb, alive, qs, k, beam, n_levels, expand)
    if qs.device.type == "cpu":
        return beam_search_plain(vectors, nb0, up_nb, alive, entry, qs, k,
                                 beam, n_levels, dist_kind, max_iters, expand)
    if qs.device.type != "cuda":
        raise ValueError(f"beam_search: unsupported device {qs.device}")
    B, d = qs.shape
    _check_layout(d, nb0.shape[1], up_nb.shape[2], beam, expand)
    if out is None:
        out = torch.empty(out_size(B, k), dtype=torch.int32, device=qs.device)
    elif (out.shape != (out_size(B, k),) or out.dtype != torch.int32
          or out.device != qs.device or not out.is_contiguous()):
        raise ValueError(f"beam_search: out must be {out_size(B, k)} int32 "
                         "entries on the queries' device")
    _launch(vectors, nb0, up_nb, alive, entry, qs, out, k, beam, n_levels,
            dist_kind, max_iters, expand,
            torch.cuda.current_stream(qs.device).cuda_stream)
    packed = out[: B * 2 * k].view(B, 2 * k)
    beam_search.last_stats = out[B * 2 * k:].view(B, 4)
    return packed[:, :k], packed[:, k:].view(torch.float32)


beam_search.launches = 0
beam_search.last_stats = None


def _device_arrays(index):
    """The index arrays on the device, cached by index.version; small
    mutation sets apply as dirty-slot scatters instead of a full
    re-push.  The mirror keeps a lock (`cache["lock"]`): an in-place
    update and a small-batch search on the same mirror take it, so a
    search never reads a half-updated mirror nor shares its staging
    buffers with another caller."""
    cache = getattr(index, "_dev_cache", None)
    if cache is not None and cache["version"] == index.version:
        return cache
    if cache is not None:
        updated = _try_incremental_update(index, cache)
        if updated is not None:
            return updated
    dev = default_device(index.device)
    n = max(index.n, 1)
    n_pad = _pad_pow2(n)
    d = index.dim
    vecs = np.zeros((n_pad, d), dtype=np.float32)
    vecs[: index.n] = index.vectors[: index.n].astype(np.float32)
    nb0 = np.full((n_pad, index.m_max0), -1, dtype=np.int32)
    nb0[: index.n] = index.neighbors[0][: index.n]
    n_levels = len(index.neighbors) - 1
    m_up = index.m_max
    up_nb = np.full((max(n_levels, 1), n_pad, m_up), -1, dtype=np.int32)
    for l in range(1, n_levels + 1):
        up_nb[l - 1, : index.n] = index.neighbors[l][: index.n, :m_up]
    alive = np.zeros(n_pad, dtype=bool)
    alive[: index.n] = index.alive[: index.n]
    cache = {
        "version": index.version,
        "n_pad": n_pad,
        "n_levels": n_levels,
        "m_up": m_up,
        "vectors": to_device(vecs, dev),
        "nb0": to_device(nb0, dev),
        "up_nb": to_device(up_nb, dev),
        "alive": to_device(alive, dev),
        "entry": int(index.entry),
        "lock": threading.Lock(),
    }
    index._dev_cache = cache
    index.dev_pending.clear()
    return cache


def _update(cache, idxs, new_vecs, new_nb0, new_up, new_alive) -> None:
    """Dirty-slot scatter into the resident mirror, IN PLACE
    (`index_put_`; the JAX `_update_fn` rebuilds the arrays
    functionally).  new_up is [u, n_levels, m_up]."""
    cache["vectors"].index_put_((idxs,), new_vecs)
    cache["nb0"].index_put_((idxs,), new_nb0)
    cache["up_nb"][:, idxs] = new_up.transpose(0, 1)
    cache["alive"].index_put_((idxs,), new_alive)


def _try_incremental_update(index, cache):
    with cache["lock"]:
        if cache["version"] == index.version:  # another caller did it
            return cache
        return _incremental_update(index, cache)


def _incremental_update(index, cache):
    n_pad = cache["n_pad"]
    n_levels_now = len(index.neighbors) - 1
    pending = index.dev_pending
    if (
        index.n > n_pad
        or n_levels_now != cache["n_levels"]
        or not pending
        or len(pending) > max(1024, n_pad // 16)
    ):
        return None
    dev = cache["vectors"].device
    idxs = np.fromiter(sorted(pending), dtype=np.int64)
    u = len(idxs)
    u_pad = _pad_pow2(u)
    # pad by repeating the first slot (idempotent double-writes)
    idxs_p = np.full(u_pad, idxs[0], dtype=np.int64)
    idxs_p[:u] = idxs
    m_up = cache["m_up"]
    n_levels = cache["n_levels"]
    new_vecs = index.vectors[idxs_p].astype(np.float32)
    new_nb0 = index.neighbors[0][idxs_p]
    new_up = np.full((u_pad, max(n_levels, 1), m_up), -1, dtype=np.int32)
    for l in range(1, n_levels + 1):
        new_up[:, l - 1, :] = index.neighbors[l][idxs_p, :m_up]
    new_alive = index.alive[idxs_p]
    _update(cache, to_device(idxs_p, dev), to_device(new_vecs, dev),
            to_device(np.ascontiguousarray(new_nb0), dev),
            to_device(new_up, dev), to_device(new_alive, dev))
    cache.update(version=index.version, entry=int(index.entry))
    pending.clear()
    return cache


def beam_params(k: int, ef: int, expand: int = None):
    """(beam, max_iters, expand) of a search with `ef`: the beam is
    max(ef, k) rounded up to a multiple of 8, `expand` entries are
    expanded per round (COZO_TPU_HNSW_EXPAND, default 8), and the rounds
    are capped at ceil(beam / expand) + 8."""
    beam = int(math.ceil(max(ef, k) / 8) * 8)
    if expand is None:
        expand = int(os.environ.get("COZO_TPU_HNSW_EXPAND", "8"))
    return beam, (beam + expand - 1) // expand + 8, expand


MAX_STAGING = 64  # (batch size, k) pairs whose buffers a mirror keeps


def _staging(cache, B: int, d: int, k: int):
    """The buffers of one small-batch call on the card, kept with the
    mirror per (B, k) and reused: the queries [B, d] f32 and the kernel's
    output (`out_size(B, k)` int32; `stats` is its counters' part [B, 4])
    in pinned host memory, with numpy views (`out_np`: the [B, 2k] ids and
    distance bits).  Pinned memory is mapped into the card's address
    space, so the kernel reads the queries and writes its results there
    directly: a call needs no upload and no pull."""
    kept = cache.setdefault("staging", {})
    st = kept.get((B, k))
    if st is None:
        if len(kept) >= MAX_STAGING:
            kept.clear()
        q_host = torch.empty((B, d), dtype=torch.float32, pin_memory=True)
        out_host = torch.empty(out_size(B, k), dtype=torch.int32,
                               pin_memory=True)
        st = kept[(B, k)] = {
            "q_host": q_host, "q_np": q_host.numpy(),
            "out_host": out_host,
            "out_np": out_host[: B * 2 * k].view(B, 2 * k).numpy(),
            "stats": out_host[B * 2 * k:].view(B, 4),
        }
    return st


def hnsw_search_device(index, qs: np.ndarray, k: int, ef: int,
                       expand: int = None):
    """`index.search` for a small batch through `beam_search`: ids [B, k]
    int64 and distances [B, k] float64 (missing: -1 / inf).

    On the card the call is one staging copy, one launch of the kernel on
    the pinned staging buffers kept with the index's device mirror
    (`_staging`; the counters it leaves in `beam_search.last_stats` are
    then a pinned host tensor) and one wait for the stream.  Concurrent
    callers are safe: everything from reading the mirror and the staging
    copy to the numpy unpack holds the mirror's lock (`cache["lock"]`,
    also taken by its in-place update), which costs about a microsecond
    uncontended."""
    if qs.ndim != 2 or qs.shape[0] < 1 or qs.shape[1] != index.dim:
        raise ValueError(f"hnsw_search_device: qs {qs.shape} must be "
                         f"[B, {index.dim}]")
    dev = _device_arrays(index)
    beam, max_iters, expand = beam_params(k, ef, expand)
    with dev["lock"]:
        return _search_locked(dev, index, qs, k, beam, max_iters, expand)


def _search_locked(dev, index, qs, k, beam, max_iters, expand):
    device = dev["vectors"].device
    graph = (dev["vectors"], dev["nb0"], dev["up_nb"], dev["alive"],
             dev["entry"])
    tail = (k, beam, dev["n_levels"], DIST_KINDS[index.distance], max_iters,
            expand)
    if device.type != "cuda":
        q = torch.from_numpy(np.ascontiguousarray(qs, dtype=np.float32))
        out_ids, out_d = beam_search(*graph, q, *tail)
        return (out_ids.numpy().astype(np.int64),
                out_d.numpy().astype(np.float64))
    # the arrays are the mirror's and the staging's own: only the caller's
    # parameters can be wrong
    _check_params(k, beam, dev["n_levels"], expand)
    _check_layout(index.dim, dev["nb0"].shape[1], dev["m_up"], beam, expand)
    st = _staging(dev, qs.shape[0], index.dim, k)
    np.copyto(st["q_np"], qs, casting="same_kind")
    stream = torch.cuda.current_stream(device)
    _launch(*graph, st["q_host"], st["out_host"], *tail, stream.cuda_stream)
    beam_search.last_stats = st["stats"]
    stream.synchronize()
    packed = st["out_np"]
    return (packed[:, :k].astype(np.int64),
            packed[:, k:].view(np.float32).astype(np.float64))
