"""Parity of the port's int8 paths with the JAX package's: the sweep's
`i8` lane (`cozo_tpu_torch/ops/exact_knn.py`: `quantize_tbl`, `_sweep_i8`)
and the int8 bulk build (`ops/bulk_build.py`: `_build_step_i8`).  Same
seeded numpy inputs through both; the port runs on the CPU."""

import numpy as np
import pytest
import torch

from cozo_tpu.models.hnsw_index import HnswIndex as JaxIndex
from cozo_tpu.ops import bulk_build as jax_bb
from cozo_tpu.ops.exact_knn import _quantize_tbl_fn
from cozo_tpu.ops.exact_knn import sweep_search as jax_sweep
from cozo_tpu_torch import HnswIndex, sweep_search
from cozo_tpu_torch.ops import bulk_build as bb
from cozo_tpu_torch.ops.exact_knn import quantize_tbl
from cozo_tpu_torch.utils.device import int_mm, prepare_queries
from tests._torch_state import carry, recall


def _inserted(distance, n, d, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    jidx = JaxIndex(dim=d, m=8, ef_construction=50, distance=distance)
    for v in data:
        jidx.insert(v)
    return rng, data, jidx, carry(jidx)


@pytest.mark.parametrize("distance", ["L2", "Cosine", "IP"])
def test_sweep_i8_lane_matches_exact(distance):
    """int8 scoring + exact f32 re-rank: recall against the host's exact
    answer clears the JAX test's bar (0.97), and the ids are the JAX
    lane's on the same index, rank for rank.  (The comparison is after the
    re-rank: JAX's un-aggregated `approx_max_k` on the CPU hands its
    merge the bins in an order of its own, by which that merge breaks the
    bf16 slab's ties, and XLA fuses the slab's last multiply and add.)
    Re-ranked distances are exact f32."""
    rng, data, jidx, tidx = _inserted(distance, 3000, 48, 6)
    B, k = 128, 10
    qs = rng.standard_normal((B, 48)).astype(np.float32)
    ids, dists = sweep_search(tidx, qs, k, rt=0.99, compute_dtype="i8")
    ids_j, _ = jax_sweep(jidx, qs, k, rt=0.99, compute_dtype="i8")
    gt_ids, gt_d = tidx._bf_candidates_np(qs, k)
    rec = recall(ids, gt_ids)
    assert rec > 0.97, rec
    assert np.array_equal(ids, np.asarray(ids_j))
    mask = ids == gt_ids  # rows where ranks agree exactly
    np.testing.assert_allclose(dists[mask], gt_d[mask], rtol=2e-3, atol=2e-3)

    # a version bump invalidates the quantized lane
    st = tidx._sweep_table
    assert st.i8_version == st.version == tidx.version
    tidx.insert(qs[0])
    ids2, d2 = sweep_search(tidx, qs[:8], k, rt=0.99, compute_dtype="i8")
    assert ids2[0, 0] == tidx.n - 1 and d2[0, 0] < 1e-3
    assert st.i8_version == tidx.version


def test_rerank_k_override_matches_default():
    """A wider exact-rerank overfetch must not change the returned top-k
    on an easy table (the `i8` case of the JAX test; the bf16 case is in
    tests/test_torch_exact_knn.py)."""
    rng = np.random.default_rng(11)
    n, d, B, k = 5_000, 16, 64, 5
    data = rng.standard_normal((n, d)).astype(np.float32)
    jidx = JaxIndex(dim=d, m=8, ef_construction=50, distance="Cosine")
    jidx.bulk_build(data, wave=2048)
    tidx = carry(jidx)
    qs = data[:B] + 1e-3 * rng.standard_normal((B, d)).astype(np.float32)
    for idx, search in ((tidx, sweep_search), (jidx, jax_sweep)):
        base, _ = search(idx, qs, k, rt=1.0, compute_dtype="f32")
        wide, wd = search(idx, qs, k, rt=1.0, compute_dtype="i8", rerank_k=64)
        assert recall(wide, base) > 0.95
        assert np.isfinite(wd[np.asarray(wide) >= 0]).all()


@pytest.mark.parametrize("distance", ["L2", "Cosine"])
def test_i8_table_scales_and_accumulators_bit_equal(distance):
    """The int8 table and its scales (dead rows 0) are bit-equal to the JAX
    package's, the quantised queries too, and the int32 products of the
    two are the same integers."""
    import jax
    import jax.numpy as jnp

    rng, data, jidx, tidx = _inserted(distance, 700, 24, 16)
    for s in (3, 50, 51):
        jidx.remove(s)
        tidx.remove(s)
    qs = rng.standard_normal((32, 24)).astype(np.float32)
    sweep_search(tidx, qs, 5, compute_dtype="i8")
    jax_sweep(jidx, qs, 5, compute_dtype="i8")
    st, jst = tidx._sweep_table, jidx._sweep_table
    assert np.array_equal(st.tbl.numpy(), np.asarray(jst.tbl))
    assert np.array_equal(st.tbl_i8.numpy(), np.asarray(jst.tbl_i8))
    assert np.array_equal(st.scale_i8.numpy(), np.asarray(jst.scale_i8))
    assert (st.scale_i8.view(-1)[[3, 50, 51]] == 0).all()
    # derived afresh from the table as well (no state carried)
    q_t, s_t = quantize_tbl(st.tbl, st.bias)
    q_j, s_j = _quantize_tbl_fn(st.n_chunks, st.chunk, st.d_pad)(
        jnp.asarray(st.tbl.numpy()), jnp.asarray(st.bias.numpy()))
    assert np.array_equal(q_t.numpy(), np.asarray(q_j))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))

    # the queries as `_sweep_fn_i8` quantises them (f16 in, on device)
    q16 = qs.astype(np.float16)
    if distance == "Cosine":
        q16 = (qs / np.linalg.norm(qs, axis=1, keepdims=True)).astype(np.float16)
    @jax.jit  # as inside the jitted `_sweep_fn_i8`
    def quantise(q_in):
        qf = jnp.pad(q_in.astype(jnp.float32), ((0, 0), (0, 128 - 24)))
        mx = jnp.max(jnp.abs(qf), axis=1)
        sc = jnp.where(mx > 0, mx / 127.0, 1.0).astype(jnp.float32)
        return sc, jnp.clip(jnp.round(qf / sc[:, None]), -127, 127).astype(
            jnp.int8)

    sc_j, qi_j = quantise(jnp.asarray(q16))
    _, qi_t, sc_t = prepare_queries(torch.from_numpy(q16.astype(np.float32)),
                                    "IP", 128, half=True, quantize=True,
                                    reciprocal=True)
    assert np.array_equal(qi_t.numpy(), np.asarray(qi_j))
    assert np.array_equal(sc_t.numpy(), np.asarray(sc_j))
    acc_j = jax.lax.dot_general(qi_j, q_j[0], (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.int32)
    acc_t = int_mm(qi_t, q_t[0])
    assert acc_t.dtype == torch.int32
    assert np.array_equal(acc_t.numpy(), np.asarray(acc_j))


@pytest.mark.parametrize("distance", ["L2", "IP"])
def test_f16_overflow_keeps_f32_queries_on_the_i8_lane(distance):
    """Query magnitudes past f16's range must not turn the i8 lane's
    scores into inf/NaN: the batch stays f32 in both packages."""
    rng = np.random.default_rng(9)
    n, d, k = 600, 8, 3
    data = (rng.standard_normal((n, d)) * 1e5).astype(np.float32)
    jidx = JaxIndex(dim=d, m=8, ef_construction=32, distance=distance)
    for v in data:
        jidx.insert(v)
    tidx = carry(jidx)
    qs = data[:16] * (1.0 + 1e-4)
    assert np.abs(qs).max() > 6e4
    ids_t, d_t = sweep_search(tidx, qs, k, compute_dtype="i8")
    ids_j, _ = jax_sweep(jidx, qs, k, compute_dtype="i8")
    assert (ids_t >= 0).all() and np.isfinite(d_t).all()
    assert np.array_equal(ids_t[:, 0], ids_j[:, 0])
    if distance == "L2":
        assert (ids_t[:, 0] == np.arange(16)).all()


# ---- the int8 build --------------------------------------------------------

N, D, NQ, K = 24_000, 48, 64, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((NQ, D)).astype(np.float32))


def _graph_recall(idx, gt, qs):
    hits = 0
    for i in range(NQ):
        got = idx._beam_search(qs[i].astype(idx.dtype), [idx.entry], 0, 64)
        got.sort()
        hits += len({s for _, s in got[:K]} & set(gt[i].tolist()))
    return hits / (NQ * K)


def _exact(vecs, qs, metric):
    if metric == "L2":
        dd = ((vecs[None] - qs[:, None]) ** 2).sum(2)
    else:
        dn = np.linalg.norm(vecs, axis=1)[None] * np.linalg.norm(qs, axis=1)[:, None]
        dd = 1 - (qs @ vecs.T) / np.where(dn > 0, dn, 1.0)
    return np.argsort(dd, axis=1)[:, :K]


@pytest.mark.parametrize("metric", ["Cosine", "L2"])
def test_i8_build_quality_matches_f32(data, metric, monkeypatch):
    """The int8 build's graph against the f32 build's (the JAX test's bar:
    at most 0.05 lower) and against the JAX package's int8 build of the
    same rows (at most 0.02 apart: its pools come from `approx_max_k`)."""
    vecs, qs = data
    gt = _exact(vecs, qs, metric)
    recalls = {}
    for mode, budget in (("f32", str(8 << 30)), ("i8", "1")):
        monkeypatch.setenv("COZO_TPU_F32_TABLE_MAX", budget)
        idx = HnswIndex(dim=D, m=16, ef_construction=100, distance=metric,
                        dtype=np.float32, device="cpu")
        bb.bulk_build_device(idx, vecs, wave=4096)
        assert (idx._quant_sweep is not None) == (mode == "i8")
        recalls[mode] = _graph_recall(idx, gt, qs)
    jidx = JaxIndex(dim=D, m=16, ef_construction=100, distance=metric,
                    dtype=np.float32)
    jax_bb.bulk_build_device(jidx, vecs, wave=4096)
    assert jidx._quant_sweep is not None
    recalls["jax_i8"] = _graph_recall(jidx, gt, qs)
    assert recalls["i8"] >= recalls["f32"] - 0.05, recalls
    assert abs(recalls["i8"] - recalls["jax_i8"]) <= 0.02, recalls


def test_i8_build_installs_quant_serving(data, monkeypatch):
    vecs, qs = data
    monkeypatch.setenv("COZO_TPU_F32_TABLE_MAX", "1")
    idx = HnswIndex(dim=D, m=16, ef_construction=100, distance="Cosine",
                    dtype=np.float32, device="cpu")
    bb.bulk_build_device(idx, vecs, wave=4096)
    qt = idx._quant_sweep
    assert qt is not None and idx._sweep_table is None
    assert idx._quant_sweep_version == idx.version
    assert qt.tbl.dtype == torch.int8 and qt.n == N
    ids, d = idx.search(qs, K, 64)
    assert idx._quant_sweep is qt  # served from the build's table
    assert recall(ids, _exact(vecs, qs, "Cosine")) > 0.95
    # the build's storage form IS `quantize_rows`' scoring form
    from cozo_tpu_torch.ops.quant_knn import QuantSweepTable

    q, s, b = QuantSweepTable.quantize_rows(vecs[:4096], "Cosine")
    got = qt.tbl.view(-1, qt.d_pad)[:4096, :D].numpy()
    assert (got == q).mean() > 0.999  # a last-bit norm may move one step
    np.testing.assert_allclose(qt.scales.view(-1)[:4096].numpy(), s, rtol=1e-6)


@pytest.mark.parametrize("metric", ["Cosine", "L2"])
def test_build_step_i8_matches_jax(metric):
    """One wave step on the same table and wave: the scattered int8 rows
    and scales are bit-equal to the JAX step's, and the pools agree (JAX's
    `approx_max_k` is exact on the CPU; ids may differ only where bf16
    scores tie, so pools are compared as sets, >= 0.99)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    n, d, d_pad, W, P, mmax = 2048, 24, 128, 256, 16, 8
    chunk = 2048
    v = rng.standard_normal((n, d)).astype(np.float32)
    rows = np.zeros((n, d_pad), np.float32)
    if metric == "L2":
        rows[:, :d] = 2.0 * v
        bias = -(v.astype(np.float64) ** 2).sum(1).astype(np.float32)
    else:
        rows[:, :d] = v / np.linalg.norm(v, axis=1, keepdims=True)
        bias = np.zeros(n, np.float32)
    tbl = torch.zeros((1, chunk, d_pad), dtype=torch.int8)
    scale = torch.zeros((1, chunk))
    tb = torch.full((1, chunk), -np.inf)
    jt, js, jb = (jnp.zeros((1, chunk, d_pad), jnp.int8),
                  jnp.zeros((1, chunk), jnp.float32),
                  jnp.full((1, chunk), -jnp.inf, jnp.float32))
    step = jax_bb._build_step_fn_i8(1, chunk, d_pad, W, P, mmax, metric, 0.9)
    for pos in range(0, 3 * W, W):
        slots = np.arange(pos, pos + W, dtype=np.int64)
        packed_t = bb._build_step_i8(
            tbl, scale, tb, torch.from_numpy(rows[slots]),
            torch.from_numpy(bias[slots]), torch.from_numpy(slots), P, mmax,
            metric).numpy()
        jt, js, jb, packed_j = step(
            jt, js, jb, jnp.asarray(rows[slots]), jnp.asarray(bias[slots]),
            jnp.asarray((slots // chunk).astype(np.int32)),
            jnp.asarray((slots % chunk).astype(np.int32)),
            jnp.asarray(slots.astype(np.int32)))
    assert np.array_equal(tbl.numpy(), np.asarray(jt))
    assert np.array_equal(scale.numpy(), np.asarray(js))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    packed_j = np.asarray(packed_j)
    ids_t, ids_j = packed_t[:, :P], packed_j[:, :P]
    assert recall(ids_t, ids_j) >= 0.99
    same = ids_t == ids_j
    d_t = packed_t[:, P:2 * P].view(np.float32)
    d_j = packed_j[:, P:2 * P].view(np.float32)
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=1e-5, atol=1e-5)
    sel_t, sel_j = packed_t[:, 2 * P:], packed_j[:, 2 * P:]
    rows_same = same.all(1)
    assert rows_same.mean() > 0.9
    assert (sel_t[rows_same] == sel_j[rows_same]).mean() > 0.995
