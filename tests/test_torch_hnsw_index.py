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
    state.update(vectors=np.zeros((n, d), np.float32),
                 norms=np.zeros(n), levels=np.zeros(n, np.int32),
                 alive=np.ones(n, bool), n=n, entry=0,
                 neighbors=[np.full((n, 8), -1, np.int32)])
    return HnswIndex.from_state(state, device="cpu")


def test_unported_paths_raise(monkeypatch):
    idx = _big_index()
    qs = np.zeros((8, 4), np.float32)
    # small batches on a big table take the device beam search in JAX
    with pytest.raises(NotImplementedError, match="beam search"):
        idx.search(qs, k=3, ef=8, use_tpu=True)
    # the quant lane past the f32 budget
    monkeypatch.setenv("COZO_TPU_F32_TABLE_MAX", "1024")
    with pytest.raises(NotImplementedError, match="quant lane"):
        idx.search(np.zeros((64, 4), np.float32), k=3, ef=8, use_tpu=True)
    monkeypatch.delenv("COZO_TPU_F32_TABLE_MAX")
    # the mesh sweep
    monkeypatch.setenv("COZO_TPU_MESH", "1")
    with pytest.raises(NotImplementedError, match="mesh"):
        idx.search(qs, k=3, ef=8)
