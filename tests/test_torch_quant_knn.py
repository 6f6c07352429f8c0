"""Parity of the port's int8 quant lane (`cozo_tpu_torch/ops/quant_knn.py`)
with the JAX package's (`cozo_tpu/ops/quant_knn.py`): the six cases of
tests/test_quant_knn.py, each through both packages on the same rows."""

import numpy as np
import pytest

from cozo_tpu.models.hnsw_index import HnswIndex as JaxIndex
from cozo_tpu.ops.quant_knn import quant_search as jax_quant_search
from cozo_tpu_torch import HnswIndex
from cozo_tpu_torch.ops.quant_knn import QuantSweepTable, quant_search
from tests._torch_state import quant_tables, recall


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return rng.standard_normal((8192, 48)).astype(np.float32)


def _gt_cosine(data, qs, k):
    dn = data / np.linalg.norm(data, axis=1, keepdims=True)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    return np.argsort(-(qn @ dn.T), axis=1)[:, :k]


def _same_tables(jt, tt):
    """Both device tables hold the same bits."""
    assert (jt.chunk, jt.n_chunks, jt.d_pad, jt.n) == \
        (tt.chunk, tt.n_chunks, tt.d_pad, tt.n)
    assert np.array_equal(np.asarray(jt.tbl), tt.tbl.numpy())
    assert np.array_equal(np.asarray(jt.scales), tt.scales.numpy())
    assert np.array_equal(np.asarray(jt.bias), tt.bias.numpy())


def test_recall_with_rerank(data):
    rng = np.random.default_rng(4)
    qs = data[:32] + 0.05 * rng.standard_normal((32, 48)).astype(np.float32)
    jt, tt = quant_tables(data, "Cosine")
    _same_tables(jt, tt)
    ids, d = quant_search(data, tt, qs, 10, overfetch=8, rt=0.99)
    ids_j, d_j = jax_quant_search(data, jt, qs, 10, overfetch=8, rt=0.99)
    gt = _gt_cosine(data, qs, 10)
    assert recall(ids, gt) > 0.97
    assert recall(ids, gt) >= recall(ids_j, gt) - 0.005
    assert (np.diff(d, axis=1) >= -1e-6).all()  # ascending per row
    # the host re-rank is the same numpy code: where both found a row, the
    # distance is the same number
    both = ids == ids_j
    assert both.mean() > 0.97
    assert np.array_equal(d[both], d_j[both])


def test_candidates_match_jax(data):
    """The scan itself: the same candidate sets (exact top-k here,
    `approx_max_k` there, which is exact on the CPU) and the same f32
    scores to 1e-5: the int32 sums are exact, the rescale is three f32
    operations in the same order, which XLA may contract into a fused
    multiply-add."""
    rng = np.random.default_rng(5)
    qs = data[100:132] + 0.05 * rng.standard_normal((32, 48)).astype(np.float32)
    for metric in ("Cosine", "L2", "IP"):
        jt, tt = quant_tables(data, metric)
        ids_t, sc_t = tt.search_candidates(qs, 40)
        ids_j, sc_j = jt.search_candidates(qs, 40)
        assert recall(ids_t, ids_j) > 0.995, metric
        np.testing.assert_allclose(np.sort(sc_t, 1), np.sort(sc_j, 1),
                                   rtol=1e-5, atol=1e-5)


def test_dead_rows_never_returned(data):
    alive = np.ones(len(data), bool)
    alive[::3] = False
    jt, tt = quant_tables(data, "Cosine", alive=alive)
    _same_tables(jt, tt)
    qs = data[::3][:16]  # queries exactly at dead rows
    ids, _ = quant_search(data, tt, qs, 5)
    assert not np.isin(ids[ids >= 0], np.nonzero(~alive)[0]).any()
    ids_j, _ = jax_quant_search(data, jt, qs, 5)
    assert recall(ids, ids_j) > 0.97


def test_ip_metric(data):
    jt, tt = quant_tables(data, "IP")
    _same_tables(jt, tt)
    qs = data[:8]
    ids, d = quant_search(data, tt, qs, 5)
    gt = np.argsort(-(qs @ data.T), axis=1)[:, :5]
    assert recall(ids, gt) > 0.95
    ids_j, _ = jax_quant_search(data, jt, qs, 5)
    assert recall(ids, gt) >= recall(ids_j, gt) - 0.03


def test_l2_metric(data):
    """L2 serves through the bias lane: rows stored with doubled scales +
    bias -||v||^2 so the int8 scan ranks 2 q.v - ||v||^2; the host re-rank
    restores exact squared-L2 order."""
    jt, tt = quant_tables(data, "L2")
    _same_tables(jt, tt)
    rng = np.random.default_rng(7)
    qs = data[:16] + 0.05 * rng.standard_normal((16, 48)).astype(np.float32)
    ids, d = quant_search(data, tt, qs, 10, overfetch=8, rt=0.99)
    d2 = ((data[None, :, :] - qs[:, None, :]) ** 2).sum(axis=2)
    gt = np.argsort(d2, axis=1)[:, :10]
    assert recall(ids, gt) > 0.97
    assert (np.diff(d, axis=1) >= -1e-5).all()
    exact = np.take_along_axis(d2, ids, axis=1)
    assert np.allclose(d, exact, rtol=1e-4, atol=1e-4)
    ids_j, _ = jax_quant_search(data, jt, qs, 10, overfetch=8, rt=0.99)
    assert recall(ids, gt) >= recall(ids_j, gt) - 0.01


def test_l2_dead_rows(data):
    alive = np.ones(len(data), bool)
    alive[::2] = False
    jt, tt = quant_tables(data, "L2", alive=alive)
    _same_tables(jt, tt)
    qs = data[::2][:8]
    ids, _ = quant_search(data, tt, qs, 5)
    assert not np.isin(ids[ids >= 0], np.nonzero(~alive)[0]).any()


def test_auto_quant_serving_policy(monkeypatch):
    """HnswIndex.search engages the int8 sweep when the f32 table would
    exceed the budget (COZO_TPU_F32_TABLE_MAX), in both packages."""
    monkeypatch.setenv("COZO_TPU_F32_TABLE_MAX", "100000")
    rng = np.random.default_rng(0)
    n, d = 4096, 32
    data = rng.standard_normal((n, d)).astype(np.float32)
    qs = data[:32] + 0.02 * rng.standard_normal((32, d)).astype(np.float32)
    gt = _gt_cosine(data, qs, 10)
    recs = []
    for cls, kw in ((HnswIndex, {"device": "cpu"}), (JaxIndex, {})):
        idx = cls(dim=d, m=8, ef_construction=32, distance="Cosine", **kw)
        idx.bulk_build(data, wave=1024)
        ids, _ = idx.search(qs, 10, 64, use_tpu=True)
        assert idx._quant_sweep is not None
        assert idx._quant_sweep_version == idx.version
        recs.append(recall(ids, gt))
    assert recs[0] > 0.97, recs
    assert recs[0] >= recs[1] - 0.005, recs


def test_sorted_gather_gives_the_same_answer(data, monkeypatch):
    """Past COZO_TPU_SORTED_GATHER_MIN rows the re-rank fetches the
    candidates in ascending row order and unpermutes: same result."""
    tt = QuantSweepTable("cpu").load(data, "Cosine")
    qs = data[40:56] + 0.01
    want = quant_search(data, tt, qs, 10)
    monkeypatch.setenv("COZO_TPU_SORTED_GATHER_MIN", "1000")
    got = quant_search(data, tt, qs, 10)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert quant_search.last_timing is not None
