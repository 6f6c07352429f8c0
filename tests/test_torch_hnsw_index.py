"""The port's host HNSW code (`cozo_tpu_torch/models/hnsw_index.py`) is
the JAX package's, copied: the same seed gives the same graph, and an
index carried across by to_state/from_state serves and inserts exactly
as the JAX one does."""

import numpy as np
import pytest

from cozo_tpu.models.hnsw_index import HnswIndex as JaxIndex
from cozo_tpu_torch import HnswIndex
from tests._torch_state import carry


def _assert_same_graph(a, b):
    assert a.n == b.n and a.entry == b.entry and a.version == b.version
    assert np.array_equal(a.levels[: a.n], b.levels[: b.n])
    assert np.array_equal(a.alive[: a.n], b.alive[: b.n])
    assert len(a.neighbors) == len(b.neighbors)
    for l in range(len(a.neighbors)):
        assert np.array_equal(a.neighbors[l][: a.n], b.neighbors[l][: b.n])


@pytest.mark.parametrize("distance", ["L2", "Cosine", "IP"])
def test_sequential_insert_identical(distance):
    rng = np.random.default_rng(21)
    data = rng.standard_normal((500, 16)).astype(np.float32)
    jidx = JaxIndex(dim=16, m=8, ef_construction=32, distance=distance)
    tidx = HnswIndex(dim=16, m=8, ef_construction=32, distance=distance,
                     device="cpu")
    for v in data:
        assert jidx.insert(v) == tidx.insert(v)
    _assert_same_graph(jidx, tidx)


def test_carried_index_serves_and_inserts_identically():
    rng = np.random.default_rng(22)
    data = rng.standard_normal((600, 12)).astype(np.float32)
    jidx = JaxIndex(dim=12, m=6, ef_construction=24, distance="Cosine")
    for v in data[:500]:
        jidx.insert(v)
    for s in (3, 77, 140):
        jidx.remove(s)
    tidx = carry(jidx)
    _assert_same_graph(jidx, tidx)
    qs = rng.standard_normal((40, 12)).astype(np.float32)
    ids_j, d_j = jidx.search(qs, k=10, ef=32, use_tpu=False)
    ids_t, d_t = tidx.search(qs, k=10, ef=32, use_tpu=False)
    assert np.array_equal(ids_t, ids_j)
    assert np.array_equal(d_t, d_j)
    # the rng state and free list came across: later inserts agree
    for v in data[500:]:
        assert jidx.insert(v) == tidx.insert(v)
    _assert_same_graph(jidx, tidx)


def test_state_round_trip():
    rng = np.random.default_rng(23)
    tidx = HnswIndex(dim=8, m=4, ef_construction=16, device="cpu")
    for v in rng.standard_normal((200, 8)).astype(np.float32):
        tidx.insert(v)
    tidx.remove(5)
    back = HnswIndex.from_state(tidx.to_state(), device="cpu")
    _assert_same_graph(tidx, back)
    assert back._free == tidx._free and back.rng.getstate() == tidx.rng.getstate()
    v = rng.standard_normal(8).astype(np.float32)
    assert back.insert(v) == tidx.insert(v)
    _assert_same_graph(tidx, back)


def _big_index(n=131_073, d=4):
    """An index past one sweep chunk, without a graph (dispatch only)."""
    idx = HnswIndex(dim=d, m=4, ef_construction=8, device="cpu")
    state = idx.to_state()
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    state.update(vectors=vectors,
                 norms=(vectors.astype(np.float64) ** 2).sum(1),
                 levels=np.zeros(n, np.int32),
                 alive=np.ones(n, bool), n=n, entry=0,
                 neighbors=[np.full((n, 8), -1, np.int32)])
    return HnswIndex.from_state(state, device="cpu")


def test_unported_paths_raise(monkeypatch):
    """Of the dispatcher's branches only the `COZO_TPU_MESH` mesh sweep is
    still unported: it raises naming its ROADMAP item.  The two that raised
    before (the device beam search for small batches on a big table, the
    quant lane past the f32 budget) now answer."""
    idx = _big_index()
    qs = idx.vectors[:8].copy()
    monkeypatch.setenv("COZO_TPU_F32_TABLE_MAX", str(8 << 30))  # pin the lane
    # small batches on a big table: the device beam search (no links in
    # this graph, so it returns the entry point alone)
    ids, dists = idx.search(qs, k=3, ef=8, use_tpu=True)
    assert idx._dev_cache is not None
    assert (ids[:, 0] == 0).all() and (ids[:, 1:] == -1).all()
    assert np.isfinite(dists[:, 0]).all() and np.isinf(dists[:, 1:]).all()
    # the quant lane past the f32 budget
    monkeypatch.setenv("COZO_TPU_F32_TABLE_MAX", "1024")
    ids, _ = idx.search(np.tile(qs, (8, 1)), k=3, ef=8, use_tpu=True)
    assert idx._quant_sweep is not None
    assert (ids[:8, 0] == np.arange(8)).all()
    # the mesh sweep
    monkeypatch.setenv("COZO_TPU_MESH", "1")
    with pytest.raises(NotImplementedError, match="mesh sharding"):
        idx.search(qs, k=3, ef=8)


@pytest.mark.parametrize("budget,B,lane", [
    ("1024", 64, "quant"), ("1024", 8, "quant"),
    (str(8 << 30), 64, "sweep"), (str(8 << 30), 8, "beam"),
])
def test_dispatcher_branches_with_the_lane_pinned(monkeypatch, budget, B, lane):
    """Each branch of `HnswIndex.search` is reached with the f32 budget
    pinned by COZO_TPU_F32_TABLE_MAX, so a re-derived default cannot move
    the lane under the test."""
    from cozo_tpu_torch.models.hnsw_index import F32_TABLE_MAX, f32_table_budget

    assert f32_table_budget() == F32_TABLE_MAX == 8 << 30
    monkeypatch.setenv("COZO_TPU_F32_TABLE_MAX", budget)
    assert f32_table_budget() == int(budget)
    idx = _big_index()
    idx.search(idx.vectors[:B].copy(), k=3, ef=8, use_tpu=True)
    reached = {"quant": idx._quant_sweep is not None,
               "sweep": idx._sweep_table is not None,
               "beam": idx._dev_cache is not None}
    assert reached == {k: k == lane for k in reached}
