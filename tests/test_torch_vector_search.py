"""Parity of the port's batched device HNSW search (`cozo_tpu_torch/ops/
vector_search.py`: the device mirror, `beam_search_plain`, the dispatch)
with the JAX package's (`cozo_tpu/ops/vector_search.py`).  Both packages
search the SAME host index.  On the CPU the wrapper runs the plain
version; the CUDA kernel's round (select, dedup, stable merge) is
re-enacted here in PyTorch and held against it."""

import math

import numpy as np
import pytest
import torch

from cozo_tpu.models.hnsw_index import HnswIndex as JaxIndex
from cozo_tpu.ops.vector_search import hnsw_search_device as jax_search
from cozo_tpu_torch import HnswIndex
from cozo_tpu_torch.ops import vector_search as vs
from tests._torch_state import (carry, device_mirrors, jax_from_state,
                                line_state, recall)


def _built(distance, n=600, d=24, m=8, seed=2, removed=range(0, 40, 3)):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    jidx = JaxIndex(dim=d, m=m, ef_construction=60, distance=distance)
    for v in data:
        jidx.insert(v)
    for s in removed:
        jidx.remove(s)
    return rng, data, jidx


def _flatten(jidx):
    """The same points as a flat index (no upper level)."""
    jidx.neighbors = jidx.neighbors[:1]
    jidx.levels[: jidx.n] = np.minimum(jidx.levels[: jidx.n], 0)
    jidx.version += 1
    jidx._dev_cache = None


@pytest.mark.parametrize("flat", [False, True], ids=["levels", "flat"])
@pytest.mark.parametrize("distance", ["L2", "IP", "Cosine"])
def test_beam_search_matches_jax(distance, flat):
    """Same ids (distances are distinct on random rows), distances within
    1e-5 relative (f32 sums in another order), after removals, at two beam
    widths; no removed row comes back."""
    rng, data, jidx = _built(distance)
    if flat:
        _flatten(jidx)
    tidx = carry(jidx)
    assert (len(tidx.neighbors) == 1) == flat
    qs = rng.standard_normal((8, 24)).astype(np.float32)
    for ef, k in ((64, 10), (8, 3)):
        ids_j, d_j = jax_search(jidx, qs, k, ef)
        ids_t, d_t = vs.hnsw_search_device(tidx, qs, k, ef)
        assert np.array_equal(ids_t, ids_j)
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)
        assert not np.isin(ids_t, np.arange(0, 40, 3)).any()


def test_beam_search_single_query_and_expand(monkeypatch):
    rng, data, jidx = _built("L2", n=400, d=19, seed=3, removed=())
    tidx = carry(jidx)
    q = rng.standard_normal((1, 19)).astype(np.float32)
    for expand in ("1", "3", "8"):
        monkeypatch.setenv("COZO_TPU_HNSW_EXPAND", expand)
        ids_j, d_j = jax_search(jidx, q, 5, 24)
        ids_t, d_t = vs.hnsw_search_device(tidx, q, 5, 24)
        assert np.array_equal(ids_t, ids_j), expand
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 1), (0, 19), (19,)],
                         ids=["one column", "no query", "one dimension"])
def test_search_device_refuses_queries_of_another_shape(shape):
    """A [B, 1] batch would broadcast into the staging buffer; an empty or
    flat one has no batch: all raise before anything runs."""
    rng, data, jidx = _built("L2", n=200, d=19, seed=5, removed=())
    tidx = carry(jidx)
    with pytest.raises(ValueError, match="must be"):
        vs.hnsw_search_device(tidx, np.zeros(shape, dtype=np.float32), 5, 24)


def test_device_mirrors_equal():
    """Both packages' `_device_arrays` of one host index hold the same
    bits."""
    _, _, jidx = _built("Cosine", n=300, d=12, seed=5)
    jc, tc, _ = device_mirrors(jidx)
    for key in ("n_pad", "n_levels", "m_up", "entry", "version"):
        assert jc[key] == tc[key], key
    for key in ("vectors", "nb0", "up_nb", "alive"):
        assert np.array_equal(np.asarray(jc[key]), tc[key].numpy()), key


def test_incremental_device_update_consistency():
    """Mutations reach the mirror as dirty-slot scatters in place (same
    cache object, same tensors); results equal a full re-push and the JAX
    package's, and both mirrors still hold the same bits."""
    rng = np.random.default_rng(4)
    data = rng.standard_normal((400, 8)).astype(np.float32)
    jidx = JaxIndex(dim=8, m=8, ef_construction=30)
    slots = [jidx.insert(v) for v in data]
    tidx = carry(jidx)
    qs = rng.standard_normal((4, 8)).astype(np.float32)
    vs.hnsw_search_device(tidx, qs, 3, 16)
    jax_search(jidx, qs, 3, 16)
    cache_before = tidx._dev_cache
    vectors_before = cache_before["vectors"]
    for idx in (jidx, tidx):
        idx.insert(data[7] + 0.001)
        idx.remove(slots[2])
    ids_inc, d_inc = vs.hnsw_search_device(tidx, qs, 3, 16)
    assert tidx._dev_cache is cache_before  # incremental, not rebuilt
    assert tidx._dev_cache["vectors"] is vectors_before  # and in place
    assert not tidx.dev_pending
    ids_j, d_j = jax_search(jidx, qs, 3, 16)
    jc, tc, _ = device_mirrors(jidx, tidx)
    for key in ("vectors", "nb0", "up_nb", "alive"):
        assert np.array_equal(np.asarray(jc[key]), tc[key].numpy()), key
    tidx._dev_cache = None
    ids_full, d_full = vs.hnsw_search_device(tidx, qs, 3, 16)
    assert np.array_equal(ids_inc, ids_full) and np.array_equal(d_inc, d_full)
    assert np.array_equal(ids_inc, ids_j)
    assert slots[2] not in ids_inc


def test_mirror_rebuilds_past_the_thresholds():
    """More dirty slots than max(1024, n_pad // 16), or a new level, is a
    full re-push (a new cache object), as in the JAX package."""
    rng = np.random.default_rng(6)
    tidx = HnswIndex(dim=6, m=4, ef_construction=16, device="cpu")
    for v in rng.standard_normal((200, 6)).astype(np.float32):
        tidx.insert(v, level=0)
    first = vs._device_arrays(tidx)
    tidx.dev_pending.update(range(1025))  # past max(1024, 256 // 16)
    tidx.version += 1
    second = vs._device_arrays(tidx)
    assert second is not first and not tidx.dev_pending
    tidx.insert(rng.standard_normal(6).astype(np.float32), level=1)
    assert vs._device_arrays(tidx) is not second


def test_search_dispatches_small_batches_to_the_beam_search(monkeypatch):
    """B < 64 on a table past 131,072 rows reaches `hnsw_search_device` in
    both packages (the f32 budget pinned, so the lane cannot move) and
    answers alike; B >= 64 takes the sweep."""
    monkeypatch.setenv("COZO_TPU_F32_TABLE_MAX", str(8 << 30))
    state = line_state(140_000)
    tidx = HnswIndex.from_state(state, device="cpu")
    jidx = jax_from_state(state)
    rng = np.random.default_rng(1)
    qs = np.stack([rng.random(16).astype(np.float32),
                   np.zeros(16, np.float32)], axis=1)
    calls = []
    real = vs.hnsw_search_device
    monkeypatch.setattr(vs, "hnsw_search_device",
                        lambda *a, **kw: calls.append(a[1].shape) or real(*a, **kw))
    ids_t, d_t = tidx.search(qs, k=5, ef=32)  # use_tpu by the default rule
    assert calls == [(16, 2)] and tidx._dev_cache is not None
    ids_j, d_j = jidx.search(qs, k=5, ef=32)
    assert np.array_equal(ids_t, ids_j)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-6)
    x = state["vectors"][:, 0]
    assert np.abs(x[ids_t] - qs[:, :1]).max() < 1e-3  # found the neighbourhood
    tidx.search(np.repeat(qs, 4, axis=0), k=5, ef=32)
    assert len(calls) == 1 and tidx._sweep_table is not None


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, _, jidx = _built("L2", n=100, d=8, seed=7, removed=())
    _, tc, _ = device_mirrors(jidx)
    q = torch.zeros((2, 8))
    args = (tc["vectors"], tc["nb0"], tc["up_nb"], tc["alive"], tc["entry"])
    with pytest.raises(ValueError, match="multiple of 8"):
        vs.beam_search(*args, q, 3, 12, tc["n_levels"], 0, 10, 4)
    with pytest.raises(ValueError, match="k <= beam"):
        vs.beam_search(*args, q, 9, 8, tc["n_levels"], 0, 10, 4)
    with pytest.raises(ValueError):
        vs.beam_search(*args, torch.zeros((2, 7)), 3, 8, tc["n_levels"], 0, 10, 4)
    with pytest.raises(TypeError):
        vs.beam_search(*args, q.double(), 3, 8, tc["n_levels"], 0, 10, 4)
    # the shared-memory layout, as the wrapper and the launcher compute it
    assert vs.sort_size(8, 32) == 256 and vs.sort_size(1, 1) == 2
    assert vs.table_size(64, 8, 32) == 1024  # >= 2 * (64 + 256) slots
    assert vs.smem_bytes(100, 32, 16, 64, 8) == (
        8 * 256 + 8 * 1024 + 4 * 100 + 24 * 64 + 12 * 256 + 4 * 8)
    assert vs.smem_bytes(37, 16, 8, 64, 8) - vs.smem_bytes(36, 16, 8, 64, 8) == 16
    assert vs.sort_size(64, 128) > vs.MAX_SORT
    assert vs.smem_bytes(32, 16, 8, 2048, 8) <= vs.MAX_SMEM  # beam 2048 runs
    assert vs.smem_bytes(16, 16, 8, 8192, 8) > vs.MAX_SMEM
    assert vs.out_size(16, 10) == 16 * 24


# ---- the kernel's round, re-enacted ---------------------------------------


def _ordered(d):
    """csrc/beam_search.cu `ordered`: float -> order-preserving unsigned."""
    d = torch.where(d == 0, torch.zeros_like(d), d)  # -0 -> +0
    u = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


RANK_MAX = 256  # csrc/beam_search.cu: listed keys placed by counting


def _key(d, pos):
    """csrc/beam_search.cu `make_key`: (ordered distance, position).  The
    kernel compares it as unsigned 64-bit; here the ordered distance is
    shifted down by 2^31 so that the signed int64 compares alike."""
    return ((_ordered(d) - 0x80000000) << 32) | pos


def _table_dedup(beam_ids, c_id, n_slots):
    """The kernel's dedup table, slot by slot: `h_id[slot]` an id,
    `h_pos[slot]` the lowest position entered for it (-1 for a beam
    entry), linear probing from a multiplicative hash.  Returns the
    survivors: not -1, and the table's position for the id is the
    candidate's own."""
    log_h = n_slots.bit_length() - 1
    h_id, h_pos = {}, {}

    def slot_of(i):
        s = ((i * 2654435761) & 0xFFFFFFFF) >> (32 - log_h)
        while s in h_id and h_id[s] != i:
            s = (s + 1) & (n_slots - 1)
        return s

    def enter(i, pos):
        s = slot_of(i)
        h_id[s] = i
        h_pos[s] = min(h_pos.get(s, 2 ** 31 - 1), pos)

    for i in beam_ids.tolist():
        if i >= 0:
            enter(i, -1)
    cands = c_id.tolist()
    for p, i in enumerate(cands):
        if i >= 0:
            enter(i, p)
    assert len(h_id) <= n_slots // 2
    return torch.tensor([i >= 0 and h_pos[slot_of(i)] == p
                         for p, i in enumerate(cands)], dtype=torch.bool)


def kernel_rounds(ids, dists, expanded, nb0, vectors, qs, expand, dist_kind,
                  rank_max=RANK_MAX):
    """One round of csrc/beam_search.cu, query by query and step by step
    as a block does it: prefix selection over the sorted beam, neighbour
    gather in selection order, first-occurrence dedup through the hash
    table, distances of the survivors only, the threshold filter (strictly
    below the beam's last), 64-bit (ordered distance, position) keys of
    the candidates that pass, and the merge by rank: an entry's new place
    is the number of keys below its own (counted, or by binary search in
    the sorted list past `rank_max` keys), written into the other beam
    buffer if inside.  (The distances are taken in one product of the
    plain version's shape, so that equal rows give equal bits in both.)"""
    B, beam = ids.shape
    m0 = nb0.shape[1]
    C = expand * m0
    assert C <= vs.sort_size(expand, m0) <= vs.MAX_SORT
    inf = math.inf
    expanded = expanded.clone()
    c_id = torch.full((B, C), -1, dtype=torch.int32)
    ok = torch.zeros((B, C), dtype=torch.bool)
    idle = []
    for b in range(B):
        open_ = ~expanded[b] & (ids[b] >= 0)
        idle.append(not bool(open_.any()))
        act = open_ & (dists[b] < inf)
        rank = torch.cumsum(act.int(), 0) - act.int()  # ballot + popc prefix
        chosen = act & (rank < expand)
        sel = ids[b][chosen]  # beam order IS ascending (distance, position)
        expanded[b] |= chosen
        c_id[b, : len(sel) * m0] = nb0[sel.long()].reshape(-1)
        ok[b] = _table_dedup(ids[b], c_id[b], vs.table_size(beam, expand, m0))
    c_d = vs._dist(qs, vectors[c_id.clamp(min=0).long()], dist_kind)
    out = []
    for b in range(B):
        thr = dists[b, beam - 1]
        listed = torch.nonzero(ok[b] & (c_d[b] < thr))[:, 0]
        if idle[b] or len(listed) == 0:
            # the block has left its loop, or nothing passed: the beam
            # stays (with the flags of what was expanded)
            out.append((ids[b], dists[b], expanded[b]))
            continue
        keys = _key(c_d[b][listed], beam + listed)
        b_keys = _key(dists[b], torch.arange(beam))
        if len(listed) > rank_max:  # the block's sort, then binary searches
            keys, order = torch.sort(keys)
            listed = listed[order]
            c_rank = torch.arange(len(keys))
            b_below = torch.searchsorted(keys, b_keys)
        else:
            c_rank = (keys[None, :] < keys[:, None]).sum(1)
            b_below = (keys[None, :] < b_keys[:, None]).sum(1)
        cd = c_d[b][listed]
        # beam entries not farther stay ahead of a candidate
        c_at = torch.searchsorted(dists[b], cd, right=True) + c_rank
        b_at = torch.arange(beam) + b_below
        new = [torch.full((beam,), -7, dtype=torch.int32),
               torch.full((beam,), math.nan), torch.zeros(beam, dtype=torch.bool)]
        bk, ck = b_at < beam, c_at < beam
        new[0][b_at[bk]], new[0][c_at[ck]] = ids[b][bk], c_id[b][listed][ck]
        new[1][b_at[bk]], new[1][c_at[ck]] = dists[b][bk], cd[ck]
        new[2][b_at[bk]], new[2][c_at[ck]] = expanded[b][bk], False
        out.append(tuple(new))  # every place below `beam` was written once
    return [torch.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("rank_max", [RANK_MAX, 4], ids=["count", "sort"])
@pytest.mark.parametrize("distance,expand", [("L2", 4), ("IP", 8),
                                             ("Cosine", 2)])
def test_kernel_round_reenacted_equals_plain(distance, expand, rank_max):
    """The kernel's way of doing a round (prefix select, hash-table dedup,
    threshold filter, merge by rank; with `rank_max` lowered, its sorted
    merge) gives the plain version's beam, round after round, duplicates
    and ties included."""
    rng, data, jidx = _built(distance, n=500, d=16, seed=11)
    # duplicate rows: equal distances, so the tie rule is exercised
    for i in range(60, 90):
        jidx.insert(data[i])
    _, tc, _ = device_mirrors(jidx)
    kind = vs.DIST_KINDS[distance]
    beam = 24
    qs = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    ids = torch.full((6, beam), -1, dtype=torch.int32)
    ids[:, 0] = tc["entry"]
    dists = torch.full((6, beam), math.inf)
    dists[:, 0] = vs._dist(qs, tc["vectors"][ids[:, 0].long()][:, None], kind)[:, 0]
    expanded = torch.ones((6, beam), dtype=torch.bool)
    expanded[:, 0] = False
    rounds = 0
    while bool((~expanded & (ids >= 0)).any()) and rounds < 20:
        want = vs.beam_round(ids, dists, expanded, tc["nb0"], tc["vectors"],
                             qs, expand, kind)
        got = kernel_rounds(ids, dists, expanded, tc["nb0"], tc["vectors"],
                            qs, expand, kind, rank_max)
        for g, w in zip(got, want):
            assert torch.equal(g, w), rounds
        ids, dists, expanded = want
        rounds += 1
    assert rounds >= 5


def _crafted_round(case):
    """One beam state and graph on a line (row i at x = radius[i], the
    query at 0, L2: a distance is radius^2, exact in f32), built so that
    one round meets `case`.  Returns (ids, dists, expanded, nb0, vectors,
    qs, expand) and what the round must do."""
    n, m0 = 128, 8
    radius = np.arange(1, n + 1, dtype=np.float32)
    nb0 = np.full((n, m0), -1, dtype=np.int32)
    beam, expand = 8, 2
    if case == "beam not full":
        members, flags = [10, 20, 30], [True, False, False]
        nb0[20] = [5, 40, 10, -1, 41, 42, 5, 43]  # 10 in the beam, 5 twice
        nb0[30] = [40, 44, 2, 45, 20, -1, 46, 47]  # 40 again, 20 in the beam
        passed = 9  # 5, 40, 41, 42, 43, 44, 2, 45, 46, 47 less the cut at 8
    elif case == "no candidate passes":
        beam = 4
        members, flags = [1, 2, 3, 4], [True, True, False, False]
        nb0[3] = [50, 51, 52, 1, 53, 54, 55, 56]
        nb0[4] = [60, 50, 61, 62, 2, 63, 64, 65]
        passed = 0
    elif case == "equal to the last loses":
        beam = 4
        members, flags = [1, 2, 3, 4], [True, True, False, False]
        radius[60] = radius[4]  # the beam's last distance again
        nb0[3] = [60, 50, 0, 51, 52, 53, 54, 55]  # 0 is nearer than all
        nb0[4] = [56, 57, 58, 59, 61, 62, 63, 64]
        passed = 1
    elif case == "two selected lists alike":
        members, flags = [3, 9, 12, 15, 18, 21, 24, 27], [True] + [False] * 7
        nb0[9] = [1, 2, 4, 5, 6, 7, 8, 10]
        nb0[12] = [1, 2, 4, 5, 6, 7, 8, 10]
        passed = 8
    elif case == "more candidates than the beam":
        expand = 4  # C = 32 > beam = 8
        members = [40, 41, 42, 43, 44, 45, 46, 47]
        flags = [False] * 8
        for r, m in enumerate(members[:4]):
            nb0[m] = np.arange(8 * r, 8 * r + 8)  # 32 rows, all nearer
        passed = 32
    elif case == "more than 32 pass":
        beam, expand = 64, 8
        members, flags = list(range(100, 110)), [False] * 10
        for r, m in enumerate(members[:8]):
            nb0[m] = np.arange(8 * r, 8 * r + 8)
        passed = 64
    else:
        raise AssertionError(case)
    vectors = np.zeros((n, 2), dtype=np.float32)
    vectors[:, 0] = radius
    ids = torch.full((1, beam), -1, dtype=torch.int32)
    ids[0, : len(members)] = torch.tensor(members, dtype=torch.int32)
    dists = torch.full((1, beam), math.inf)
    dists[0, : len(members)] = torch.from_numpy(radius[members] ** 2)
    expanded = torch.ones((1, beam), dtype=torch.bool)
    expanded[0, : len(members)] = torch.tensor(flags)
    state = (ids, dists, expanded, torch.from_numpy(nb0),
             torch.from_numpy(vectors), torch.zeros((1, 2)), expand)
    return state, passed


@pytest.mark.parametrize("rank_max", [RANK_MAX, 4], ids=["count", "sort"])
@pytest.mark.parametrize("case", [
    "beam not full", "no candidate passes", "equal to the last loses",
    "two selected lists alike", "more candidates than the beam",
    "more than 32 pass"])
def test_kernel_round_on_crafted_states(case, rank_max):
    """The re-enacted round equals the plain round on states built to meet
    each branch of the kernel's merge, and the branch is really met: the
    number of candidates that pass the threshold is the one intended."""
    (ids, dists, expanded, nb0, vectors, qs, expand), passed = \
        _crafted_round(case)
    beam = ids.shape[1]
    want = vs.beam_round(ids, dists, expanded, nb0, vectors, qs, expand, 0)
    got = kernel_rounds(ids, dists, expanded, nb0, vectors, qs, expand, 0,
                        rank_max)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # how many candidates the filter let through: valid, first occurrence,
    # not in the beam, strictly below the beam's last
    new_ids = want[0][0]
    cand = nb0[ids[0][(~expanded[0]) & (ids[0] >= 0)][:expand].long()].reshape(-1)
    fresh = sorted({int(c) for c in cand if c >= 0} - set(ids[0].tolist()))
    thr = float(dists[0, beam - 1])
    n_pass = sum(float(vectors[c, 0]) ** 2 < thr for c in fresh)
    assert n_pass == (10 if case == "beam not full" else passed)
    if case == "no candidate passes":
        assert torch.equal(new_ids, ids[0]) and bool(want[2][0].all())
    if case == "equal to the last loses":
        assert 60 not in new_ids.tolist() and new_ids.tolist() == [0, 1, 2, 3]
    if case == "more than 32 pass":
        assert new_ids.tolist() == list(range(64))


def test_ordered_key_orders_like_floats():
    d = torch.tensor([-math.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, math.inf])
    k = _ordered(d)
    assert k[3] == k[4]  # -0 and +0 are one key: position decides
    assert (k[:3] < k[3]).all() and (k[1:4].diff() >= 0).all()
    assert (k[4:].diff() > 0).all()


def test_recall_against_host_search():
    """The bar of the JAX package's own test: the device search finds
    what the host search finds."""
    rng, data, jidx = _built("L2", removed=())
    tidx = carry(jidx)
    qs = rng.standard_normal((8, 24)).astype(np.float32)
    ids_d, _ = vs.hnsw_search_device(tidx, qs, 10, 64)
    gt, _ = tidx._bf_candidates_np(qs, 10)
    ids_h, _ = tidx.search(qs, k=10, ef=64, use_tpu=False)
    assert recall(ids_d, gt) > 0.85
    assert recall(ids_d, gt) >= recall(ids_h, gt) - 0.02
