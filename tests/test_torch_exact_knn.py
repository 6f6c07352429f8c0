"""Parity of the port's chunked sweep (`cozo_tpu_torch/ops/exact_knn.py`)
with the JAX package's (`cozo_tpu/ops/exact_knn.py`): both packages serve
the SAME index, carried from JAX to the port by to_state/from_state.
The port runs on the CPU (device="cpu"); its per-chunk selection is an
exact top-k where JAX calls approx_max_k."""

import numpy as np
import pytest

from cozo_tpu.models.hnsw_index import HnswIndex as JaxIndex
from cozo_tpu.ops.exact_knn import sweep_search as jax_sweep
from cozo_tpu_torch import sweep_search
from tests._torch_state import carry, recall


def _pair(distance, n, d, seed, insert=True, wave=2048):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    jidx = JaxIndex(dim=d, m=8, ef_construction=50, distance=distance)
    if insert:
        for v in data:
            jidx.insert(v)
    else:
        jidx.bulk_build(data, wave=wave)
    return rng, data, jidx, carry(jidx)


@pytest.mark.parametrize("distance", ["L2", "Cosine", "IP"])
def test_sweep_lanes_match_jax(distance):
    rng, data, jidx, tidx = _pair(distance, 1000, 32, 3)
    B, k = 128, 10
    qs = rng.standard_normal((B, d := 32)).astype(np.float32)
    ids_j, d_j = jax_sweep(jidx, qs, k, rt=1.0, compute_dtype="f32")
    ids_t, d_t = sweep_search(tidx, qs, k, rt=1.0, compute_dtype="f32")
    # f32 lane: the same ids (rows may differ only by f32 ties)
    same = np.mean([set(ids_j[b]) == set(ids_t[b]) for b in range(B)])
    assert same >= 0.999, same
    np.testing.assert_allclose(np.sort(d_t, 1), np.sort(d_j, 1),
                               rtol=1e-5, atol=1e-5)
    # bf16 + exact rerank: recall vs host exact no worse than JAX's
    gt, _ = jidx._bf_candidates_np(qs, k)
    ids_jb, _ = jax_sweep(jidx, qs, k, compute_dtype="bf16")
    ids_tb, d_tb = sweep_search(tidx, qs, k, compute_dtype="bf16")
    assert recall(ids_tb, gt) >= recall(ids_jb, gt) - 0.002
    assert np.isfinite(d_tb).all()


def test_sweep_incremental_mutations_match_jax():
    rng, data, jidx, tidx = _pair("L2", 1000, 16, 4)
    k = 5
    qs = data[:32] + 0.001
    ids, _ = sweep_search(tidx, qs, k, rt=1.0, compute_dtype="f32")
    ids_j, _ = jax_sweep(jidx, qs, k, rt=1.0, compute_dtype="f32")
    assert (ids[:, 0] == np.arange(32)).mean() > 0.95
    assert np.array_equal(ids[:, 0], ids_j[:, 0])

    # remove the true NNs in both; they must vanish from results
    for s in range(16):
        jidx.remove(s)
        tidx.remove(s)
    ids2, _ = sweep_search(tidx, qs[:16], k, rt=1.0, compute_dtype="f32")
    assert not np.isin(ids2, np.arange(16)).any()

    # insert replacements right on the queries (incremental refresh, in
    # place); the port's host graph evolves exactly as the JAX one
    new_j = [jidx.insert(qs[i]) for i in range(16)]
    new_t = [tidx.insert(qs[i]) for i in range(16)]
    assert new_j == new_t
    ids3, d3 = sweep_search(tidx, qs[:16], k, rt=1.0, compute_dtype="f32")
    ids3_j, d3_j = jax_sweep(jidx, qs[:16], k, rt=1.0, compute_dtype="f32")
    assert all(ids3[i, 0] == new_t[i] for i in range(16))
    assert np.allclose(d3[:, 0], 0.0, atol=1e-4)
    assert np.array_equal(ids3[:, 0], ids3_j[:, 0])
    for l in range(len(jidx.neighbors)):
        assert np.array_equal(tidx.neighbors[l], jidx.neighbors[l])


@pytest.mark.parametrize("distance", ["L2", "IP"])
def test_f16_overflow_keeps_f32_queries(distance):
    """Query magnitudes past f16's range (> 6e4) must not turn the bf16
    lane's scores into inf/NaN: the upload stays f32 in both packages."""
    rng = np.random.default_rng(9)
    n, d, k = 600, 8, 3
    data = (rng.standard_normal((n, d)) * 1e5).astype(np.float32)
    jidx = JaxIndex(dim=d, m=8, ef_construction=32, distance=distance)
    for v in data:
        jidx.insert(v)
    tidx = carry(jidx)
    qs = data[:16] * (1.0 + 1e-4)
    assert np.abs(qs).max() > 6e4
    ids_t, d_t = sweep_search(tidx, qs, k, compute_dtype="bf16")
    ids_j, d_j = jax_sweep(jidx, qs, k, compute_dtype="bf16")
    assert (ids_t >= 0).all() and np.isfinite(d_t).all()
    assert np.array_equal(ids_t[:, 0], ids_j[:, 0])
    if distance == "L2":
        assert (ids_t[:, 0] == np.arange(16)).all()


def test_search_dispatches_to_sweep():
    rng, data, jidx, tidx = _pair("L2", 8_192, 24, 5, insert=False)
    B, k = 256, 10
    qs = rng.standard_normal((B, 24)).astype(np.float32)
    ids_t, _ = tidx.search(qs, k=k, ef=64, use_tpu=True)
    ids_j, _ = jidx.search(qs, k=k, ef=64, use_tpu=True)
    gt, _ = tidx._bf_candidates_np(qs, k)
    assert recall(ids_t, gt) > 0.97
    assert recall(ids_t, gt) >= recall(ids_j, gt) - 0.002


def test_rerank_k_override_matches_default():
    """A wider exact-rerank overfetch must not change the returned top-k
    on an easy table (bf16 lane; the i8 lane is not ported yet)."""
    rng, data, jidx, tidx = _pair("Cosine", 5_000, 16, 11, insert=False)
    B, k = 64, 5
    qs = data[:B] + 1e-3 * rng.standard_normal((B, 16)).astype(np.float32)
    for idx, search in ((tidx, sweep_search), (jidx, jax_sweep)):
        base, _ = search(idx, qs, k, rt=1.0, compute_dtype="f32")
        wide, wd = search(idx, qs, k, rt=1.0, compute_dtype="bf16",
                          rerank_k=64)
        agree = np.mean([
            len(set(wide[b].tolist()) & set(base[b].tolist())) / k
            for b in range(B)
        ])
        assert agree > 0.95, agree
        assert np.isfinite(wd[np.asarray(wide) >= 0]).all()


def test_i8_lane_not_ported_raises():
    _, data, _, tidx = _pair("L2", 64, 8, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sweep_search(tidx, data[:4], 3, compute_dtype="i8")
