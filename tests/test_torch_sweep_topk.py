"""The sweep lanes' chunk step (`cozo_tpu_torch/ops/exact_knn.py`:
`sweep_topk`, its plain version `sweep_topk_plain` and `sweep_route`; the
kernels are `csrc/sweep_topk.cu`, bf16 and int8, and
`csrc/sweep_topk_f32.cu`, f32) on the CPU, where the wrapper runs the
plain version.

* The plain version over 1, 2, 3 and 7 pieces, merged by `merge_chunks`,
  is bit-equal to one `select_topk_plain` over the whole slab, for both
  key kinds (bf16 products + bias; int8 products rescaled, biased and
  rounded to bf16): ties planted across piece edges, +-0.0, dead columns
  (-inf bias), rows with fewer live entries than kf, kc 1, 10 and the
  piece's width.  The inputs are small integers, so every f32 sum is
  exact in any order: the tolerance is none.
* `_sweep` (bf16 with re-rank, raw bf16), `_sweep_i8` and `_build_step`
  go through the wrapper and match the JAX package's `_sweep_fn`,
  `_sweep_fn_i8` and `_build_step_fn` on the same seeded inputs, by the
  measures of the existing parity tests: the bf16 lanes as
  `tests/test_torch_exact_knn.py::test_sweep_lanes_match_jax` holds the
  f32 lane (the same ids as sets on >= 99.9% of rows, scores within
  1e-5), the i8 lane as `tests/test_torch_i8.py::
  test_sweep_i8_lane_matches_exact` (ids rank for rank after the
  re-rank), the build step on integer rows exactly (ids, distance bits
  and selection mask); each at d_pad 128 and at 768 (the kernel's wide
  form on the card), the i8 lane there with rows whose int8 sums pass
  2^22; and the bf16, f32 and i8 lanes at 1,536-wide rows (OpenAI's; the
  kernels run to 4,096) for L2, IP and Cosine, raw and re-ranked, 2
  chunks of 512 rows and 33 queries, the i8 lane's int8 sums past 2^24.
* The f32 kind: the plain version merged is one selection of the slab
  (above, small integers: no tolerance), is the old two-step lane
  bit for bit, and `_sweep`'s f32 lane through the wrapper matches
  `_sweep_fn(compute_dtype="f32", rt=1.0)` for L2, IP and Cosine, raw and
  re-ranked, with dead rows, a ragged last chunk, ties across chunk edges
  and +-0.0 (small integers: ids and score bits equal; normal rows: ids
  equal but at f32 ties, scores within 1e-5), and at 768-wide rows.
* The wrapper refuses what the kernel cannot take, and the route by
  shape is the one its docstring names.

The kernels themselves run on the card alone (`tests/test_torch_cuda.py`,
`chip_smoke.py` phase 2): no emulation of `wgmma` here; the f32 kernel's
block loop runs on the host in `tests/test_torch_sweep_select_host_f32*.py`.
"""

import numpy as np
import pytest
import torch

from cozo_tpu.ops.bulk_build import _build_step_fn
from cozo_tpu.ops.exact_knn import _sweep_fn, _sweep_fn_i8
from chip_smoke import topk_same
from cozo_tpu_torch.ops import bulk_build as bb
from cozo_tpu_torch.ops import exact_knn as ek
from cozo_tpu_torch.utils.device import int_mm, mm_bf16, prepare_queries

PIECE = 256


def chunk_inputs(B, n_pieces, d, kind, variant, seed):
    """(q, tbl, kwargs of `sweep_topk`) of small integers: q [B, d] and
    tbl [n_pieces * PIECE, d], bf16 or int8, with the variant's planted
    structure."""
    rng = np.random.default_rng(seed)
    n = n_pieces * PIECE
    q = rng.integers(-3, 4, (B, d)).astype(np.float32)
    t = rng.integers(-3, 4, (n, d)).astype(np.float32)
    bias = -rng.integers(0, 3, n).astype(np.float32)
    cs = rng.integers(1, 4, n).astype(np.float32) * 0.25
    rs = rng.integers(1, 4, B).astype(np.float32) * 0.5
    if variant == "ties":
        # each piece's last rows repeat in the next piece's first: equal keys
        # on both sides of every edge; zero rows with a +-0.0 bias
        for p in range(1, n_pieces):
            t[p * PIECE:p * PIECE + 8] = t[p * PIECE - 8:p * PIECE]
            bias[p * PIECE:p * PIECE + 8] = bias[p * PIECE - 8:p * PIECE]
            cs[p * PIECE:p * PIECE + 8] = cs[p * PIECE - 8:p * PIECE]
        zero = rng.choice(n, n // 4, replace=False)
        t[zero] = 0.0
        bias[zero] = rng.choice(np.float32([0.0, -0.0]), len(zero))
        q[0] = 0.0  # a row of zero scores: every key is its bias
    elif variant == "dead":
        # three live columns a piece: fewer live entries than most kc
        bias[:] = -np.inf
        cs[:] = 0.0
        for p in range(n_pieces):
            live = p * PIECE + rng.choice(PIECE, 3, replace=False)
            bias[live] = -rng.integers(0, 3, 3)
            cs[live] = 0.5
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8,
             "f32": torch.float32}[kind]
    kw = {"bias": torch.from_numpy(bias)}
    if kind == "int8":
        kw["col_scale"] = torch.from_numpy(cs)
        kw["row_scale"] = torch.from_numpy(rs)
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(t).to(dtype), kw)


def whole_slab(q, tbl, kc, kw):
    """One `select_topk_plain` over the whole [B, n_total] slab."""
    if q.dtype == torch.int8:
        return ek.select_topk_plain(int_mm(q, tbl), kc, bf16=True, **kw)
    if q.dtype == torch.float32:
        return ek.select_topk_plain(q @ tbl.T, kc, **kw)
    return ek.select_topk_plain(mm_bf16(q, tbl), kc, **kw)


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("variant", ["random", "ties", "dead"])
@pytest.mark.parametrize("n_pieces", [1, 2, 3, 7])
@pytest.mark.parametrize("kc", [1, 10, PIECE])
def test_pieces_merged_equal_one_selection_of_the_slab(kind, variant,
                                                       n_pieces, kc):
    q, tbl, kw = chunk_inputs(5, n_pieces, 32, kind, variant,
                              seed=n_pieces * 100 + kc)
    vals, ids = ek.sweep_topk_plain(q, tbl, PIECE, kc, **kw)
    assert vals.shape == ids.shape == (5, n_pieces * kc)
    assert vals.dtype == (torch.bfloat16 if kind == "int8" else torch.float32)
    assert ids.dtype == torch.int64
    merged = ek.merge_chunks(vals, ids, kc)
    assert topk_same(merged, whole_slab(q, tbl, kc, kw))
    # each piece's columns are its own selection, ids offset by its start
    for p in range(n_pieces):
        cols = slice(p * PIECE, (p + 1) * PIECE)
        pk = {name: (v[cols] if name != "row_scale" else v)
              for name, v in kw.items()}
        want = whole_slab(q, tbl[cols], kc, pk)
        got = tuple(t[:, p * kc:(p + 1) * kc] for t in (vals, ids))
        assert topk_same(got, (want[0], want[1] + p * PIECE))


def test_the_wrapper_on_cpu_tensors_is_the_plain_version():
    """CPU tensors: `sweep_topk` runs the plain version into `out` (a
    chunk's columns of a wider buffer, with an id offset) and counts no
    launch on either route."""
    q, tbl, kw = chunk_inputs(4, 3, 16, "int8", "ties", seed=3)
    bufs = ek._chunk_buffers(4, 5, 10, torch.bfloat16, torch.device("cpu"))
    for t in bufs:
        t.fill_(7)
    view = tuple(t[:, 10:40] for t in bufs)
    before = (ek.sweep_topk.launches, ek.sweep_topk.two_step)
    ek.sweep_topk(q, tbl, PIECE, 10, offset=1000, out=view, **kw)
    assert (ek.sweep_topk.launches, ek.sweep_topk.two_step) == before
    want = ek.sweep_topk_plain(q, tbl, PIECE, 10, offset=1000, **kw)
    assert topk_same(view, want)
    assert (bufs[1][:, :10] == 7).all() and (bufs[1][:, 40:] == 7).all()


def test_route_by_shape_is_the_docstring_s():
    """"kernel" for d_pad <= 4,096, kc <= 256 and a piece that is a
    multiple of 256, else "two_step": a function of (d_pad, kc, piece)
    alone, and the docstrings name the bounds."""
    for d_pad in (16, 64, 112, 128, 144, 256, 768, 1024, 1040, 1536, 2048,
                  3072, 4096, 4112, 8192):
        for kc in (1, 26, 97, 256, 257, 1000):
            for piece in (128, 256, 384, 512, 131_072):
                want = "kernel" if (d_pad <= 4096 and kc <= 256
                                    and piece % 256 == 0) else "two_step"
                assert ek.sweep_route(d_pad, kc, piece) == want
    assert (ek.SWEEP_MAX_D, ek.SWEEP_MAX_KC, ek.SWEEP_PIECE) == (4096, 256,
                                                                256)
    doc = " ".join(ek.sweep_topk.__doc__.split())
    assert ("d_pad > 4,096, kc > 256 or a piece that is not a multiple of "
            "256") in doc
    doc = " ".join(ek.sweep_route.__doc__.split())
    assert ("d_pad <= SWEEP_MAX_D, kc <= SWEEP_MAX_KC and a piece that is a "
            "multiple of SWEEP_PIECE") in doc


def _bad_calls():
    q, tbl, kw = chunk_inputs(4, 2, 32, "bf16", "random", seed=1)
    qi, ti, kwi = chunk_inputs(4, 2, 32, "int8", "random", seed=1)
    b = kw["bias"]
    # f32 inputs take the bias alone, as bf16 inputs do
    yield "f32 inputs", (q.float(), tbl.float(), PIECE, 10), kwi
    yield "f16 inputs", (q.half(), tbl.half(), PIECE, 10), kw
    yield "a real width past d_pad", (q.float(), tbl.float(), PIECE, 10), {
        **kw, "d_real": 33}
    yield "f32 queries, bf16 table", (q.float(), tbl, PIECE, 10), kw
    yield "mixed kinds", (q, ti, PIECE, 10), kw
    yield "piece 0", (q, tbl, 0, 10), kw
    yield "piece not dividing the table", (q, tbl[:384], PIECE, 10), \
        {"bias": b[:384]}
    yield "piece past the table", (q, tbl, 1024, 10), kw
    yield "kc past the piece", (q, tbl, PIECE, PIECE + 1), kw
    yield "kc 0", (q, tbl, PIECE, 0), kw
    yield "d_pad not a multiple of 16", (q[:, :24].contiguous(),
                                         tbl[:, :24].contiguous(), PIECE, 10), kw
    yield "no bias", (q, tbl, PIECE, 10), {"bias": None}
    yield "bias of another length", (q, tbl, PIECE, 10), {"bias": b[:256]}
    yield "bf16 with scales", (q, tbl, PIECE, 10), {**kw, **{
        k: v for k, v in kwi.items() if k != "bias"}}
    yield "int8 without scales", (qi, ti, PIECE, 10), {"bias": kwi["bias"]}
    yield "row scale of another length", (qi, ti, PIECE, 10), {
        **kwi, "row_scale": kwi["row_scale"][:3]}
    yield "non-contiguous queries", (q.t().contiguous().t(), tbl, PIECE, 10), kw
    yield "an out of another width", (q, tbl, PIECE, 10), {
        **kw, "out": ek._chunk_buffers(4, 2, 9, torch.float32,
                                       torch.device("cpu"))}
    yield "an out of another type", (q, tbl, PIECE, 10), {
        **kw, "out": ek._chunk_buffers(4, 2, 10, torch.bfloat16,
                                       torch.device("cpu"))}


@pytest.mark.parametrize("name,args,kw", list(_bad_calls()),
                         ids=[c[0] for c in _bad_calls()])
def test_the_wrapper_refuses_what_the_kernel_cannot_take(name, args, kw):
    with pytest.raises((ValueError, TypeError)):
        ek.sweep_topk(*args, **kw)


# ---- the lanes through the wrapper, against the JAX package -----------------

N_CHUNKS, CHUNK, D_PAD, D = 3, 512, 128, 40


@pytest.fixture
def counted(monkeypatch):
    """Counts the plain version's calls: the lanes go through `sweep_topk`."""
    calls = []
    plain = ek.sweep_topk_plain

    def counting(*a, **kw):
        calls.append(a[3])
        return plain(*a, **kw)

    monkeypatch.setattr(ek, "sweep_topk_plain", counting)
    return calls


def _table(seed, metric="Cosine", n_dead=40, d_pad=D_PAD, d=D,
           flat_rows=0):
    """(table [N_CHUNKS, CHUNK, d_pad], bias, queries [96, d]) of unit rows;
    the first `flat_rows` table rows and queries near a constant vector
    (each component within a few % of the others, every other query
    negated), whose int8 codes are all near +-127: their products pass
    2^22 at d = 768."""
    rng = np.random.default_rng(seed)
    n = N_CHUNKS * CHUNK
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((96, d)).astype(np.float32)
    for m in (v, q):
        m[:flat_rows] = 1.0 + 0.03 * rng.standard_normal((flat_rows, d))
    q[1:flat_rows:2] *= -1.0
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tbl = np.zeros((n, d_pad), np.float32)
    tbl[:, :d] = v
    bias = np.zeros(n, np.float32)
    bias[rng.choice(np.arange(flat_rows, n), n_dead, replace=False)] = -np.inf
    return (tbl.reshape(N_CHUNKS, CHUNK, d_pad), bias.reshape(N_CHUNKS, CHUNK),
            q)


def _unpack(packed):
    kk = packed.shape[1] // 2
    return packed[:, :kk], np.ascontiguousarray(packed[:, kk:]).view(
        np.float32)


@pytest.mark.parametrize("rerank_k", [0, 26])
def test_sweep_bf16_lanes_match_jax(counted, rerank_k):
    """Raw bf16 (rerank_k 0: the scan's own scores) and bf16 + re-rank."""
    _bf16_lanes_match_jax(counted, rerank_k, _table(5), D_PAD, D)


@pytest.mark.parametrize("rerank_k", [0, 26])
def test_sweep_bf16_lanes_match_jax_at_768(counted, rerank_k):
    """The same at 768-wide rows (the kernel's wide form on the card)."""
    _bf16_lanes_match_jax(counted, rerank_k,
                          _table(15, d_pad=768, d=768, flat_rows=8), 768, 768)


def _bf16_lanes_match_jax(counted, rerank_k, table, d_pad, d):
    import jax.numpy as jnp

    tbl, bias, q = table
    k = 10
    qp = np.zeros((q.shape[0], d_pad), np.float32)
    qp[:, :d] = q
    got = ek._sweep(torch.from_numpy(tbl), torch.from_numpy(bias),
                    torch.from_numpy(qp), k, "bf16", rerank_k=rerank_k,
                    metric="Cosine").numpy()
    assert counted == [max(k, rerank_k)]
    want = np.asarray(_sweep_fn(N_CHUNKS, CHUNK, d_pad, k, 1.0, "bf16",
                                rerank_k, "Cosine")(
        jnp.asarray(tbl), jnp.asarray(bias), jnp.asarray(qp)))
    (ids_t, s_t), (ids_j, s_j) = _unpack(got), _unpack(want)
    same = np.mean([set(ids_t[b]) == set(ids_j[b])
                    for b in range(len(ids_t))])
    assert same >= 0.999, same
    np.testing.assert_allclose(np.sort(s_t, 1), np.sort(s_j, 1), rtol=1e-5,
                               atol=1e-5)


def _f32_table(seed, metric, variant, d_pad=D_PAD, d=D, n_live=None,
               n_chunks=N_CHUNKS, nq=96, flat_rows=0):
    """(table [n_chunks, CHUNK, d_pad], bias, queries [nq, d_pad]) in the
    sweep table's form for `metric` (`SweepTable._prep_rows`: L2 rows 2 v
    with bias -||v||^2, IP rows as they are, Cosine unit rows), the rows
    past n_live dead and zero (a ragged last chunk), 40 dead rows among
    the live.  "random": normal rows, the first `flat_rows` rows and
    queries near a constant vector (as `_table`'s: int8 codes near +-127);
    "ints": small integers (every f32 sum exact in any order), each
    chunk's last 8 rows repeated at the next chunk's start, a quarter of
    the rows zero with a +-0.0 bias (IP) and a zero query (equal keys
    across chunk edges, +-0.0)."""
    rng = np.random.default_rng(seed)
    n = n_chunks * CHUNK
    n_live = n if n_live is None else n_live
    if variant == "ints":
        v = rng.integers(-3, 4, (n, d)).astype(np.float32)
        q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
        for c in range(1, n_chunks):
            v[c * CHUNK:c * CHUNK + 8] = v[c * CHUNK - 8:c * CHUNK]
        q[0] = 0.0
    else:
        v = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((nq, d)).astype(np.float32)
        for m in (v, q):
            m[:flat_rows] = 1.0 + 0.03 * rng.standard_normal((flat_rows, d))
        q[1:flat_rows:2] *= -1.0
    bias = np.zeros(n, np.float32)
    if variant == "ints":
        zero = rng.choice(n, n // 4, replace=False)
        v[zero] = 0.0
        bias[zero] = rng.choice(np.float32([0.0, -0.0]), len(zero))
    if metric == "Cosine":
        nrm = np.linalg.norm(v, axis=1, keepdims=True)
        v = v / np.where(nrm > 0, nrm, 1.0)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
    elif metric == "L2":
        bias = bias - np.einsum("nd,nd->n", v, v)
        v = 2.0 * v
    bias[flat_rows + rng.choice(n_live - flat_rows, 40, replace=False)] = \
        -np.inf
    bias[n_live:] = -np.inf
    v[n_live:] = 0.0
    tbl = np.zeros((n, d_pad), np.float32)
    tbl[:, :d] = v
    qp = np.zeros((nq, d_pad), np.float32)
    qp[:, :d] = q
    return (tbl.reshape(n_chunks, CHUNK, d_pad),
            bias.astype(np.float32).reshape(n_chunks, CHUNK), qp)


@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
@pytest.mark.parametrize("variant", ["random", "ints"])
@pytest.mark.parametrize("rerank_k", [0, 26])
def test_sweep_f32_lane_matches_jax(counted, metric, variant, rerank_k):
    """The f32 lane (`_sweep` at compute_dtype "f32": `sweep_topk` once, on
    the plain version here, then one merge) against `_sweep_fn(...,
    compute_dtype="f32", rt=1.0)` on the same inputs, the last chunk
    ragged (its last 300 rows dead).  Tolerance: on small integers (exact
    sums) ids and score bits equal rank for rank; on normal rows the same
    ids as sets on >= 99.9% of rows (they may differ only by f32 ties, as
    `tests/test_torch_exact_knn.py::test_sweep_lanes_match_jax` states
    it) and sorted scores within 1e-5."""
    import jax.numpy as jnp

    k = 10
    seed = {"L2": 21, "IP": 22, "Cosine": 23}[metric] + 10 * rerank_k
    tbl, bias, qp = _f32_table(seed, metric, variant,
                               n_live=N_CHUNKS * CHUNK - 300)
    got = ek._sweep(torch.from_numpy(tbl), torch.from_numpy(bias),
                    torch.from_numpy(qp), k, "f32", rerank_k=rerank_k,
                    metric=metric).numpy()
    assert counted == [max(k, rerank_k)]
    want = np.asarray(_sweep_fn(N_CHUNKS, CHUNK, D_PAD, k, 1.0, "f32",
                                rerank_k, metric)(
        jnp.asarray(tbl), jnp.asarray(bias), jnp.asarray(qp)))
    (ids_t, s_t), (ids_j, s_j) = _unpack(got), _unpack(want)
    if variant == "ints" and rerank_k == 0:
        assert np.array_equal(ids_t, ids_j)
        assert np.array_equal(s_t.view(np.int32), s_j.view(np.int32))
        return
    if variant == "ints":  # the re-rank keeps any of the k-th score's ties
        ids_t = [i[s > s.min()] for i, s in zip(ids_t, s_t)]
        ids_j = [i[s > s.min()] for i, s in zip(ids_j, s_j)]
    same = np.mean([set(ids_t[b]) == set(ids_j[b])
                    for b in range(len(ids_t))])
    assert same >= 0.999, same
    np.testing.assert_allclose(np.sort(s_t, 1), np.sort(s_j, 1), rtol=1e-5,
                               atol=1e-5)


def test_sweep_f32_lane_matches_jax_at_768(counted):
    """The f32 lane at 768-wide rows (the f32 kernel streams the query rows
    there on the card), Cosine, raw: as the test above."""
    import jax.numpy as jnp

    k = 10
    tbl, bias, qp = _f32_table(24, "Cosine", "random", d_pad=768, d=768)
    got = ek._sweep(torch.from_numpy(tbl), torch.from_numpy(bias),
                    torch.from_numpy(qp), k, "f32", metric="Cosine").numpy()
    assert counted == [k]
    want = np.asarray(_sweep_fn(N_CHUNKS, CHUNK, 768, k, 1.0, "f32", 0,
                                "Cosine")(
        jnp.asarray(tbl), jnp.asarray(bias), jnp.asarray(qp)))
    (ids_t, s_t), (ids_j, s_j) = _unpack(got), _unpack(want)
    same = np.mean([set(ids_t[b]) == set(ids_j[b])
                    for b in range(len(ids_t))])
    assert same >= 0.999, same
    np.testing.assert_allclose(np.sort(s_t, 1), np.sort(s_j, 1), rtol=1e-5,
                               atol=1e-5)


# ---- 1,536-wide rows (OpenAI's embeddings; the kernels' widest run to 4,096)

N_WIDE, B_WIDE, D_WIDE = 2, 33, 1536


def _wide_table(metric, seed, variant="random"):
    """`_f32_table` at 1,536-wide rows: 2 chunks of 512 rows, 33 queries,
    the first 8 rows and queries near a constant vector ("random": int8
    sums past 2^24, where the s32 -> f32 conversion rounds)."""
    return _f32_table(seed, metric, variant, d_pad=D_WIDE, d=D_WIDE,
                      n_chunks=N_WIDE, nq=B_WIDE,
                      flat_rows=8 if variant == "random" else 0)


def _same_sets_close_scores(got, want):
    """The parity tests' measure for lanes whose sums may take another
    order: the same ids as sets on >= 99.9% of rows, sorted scores within
    1e-5."""
    (ids_t, s_t), (ids_j, s_j) = _unpack(got), _unpack(want)
    same = np.mean([set(ids_t[b]) == set(ids_j[b])
                    for b in range(len(ids_t))])
    assert same >= 0.999, same
    np.testing.assert_allclose(np.sort(s_t, 1), np.sort(s_j, 1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
@pytest.mark.parametrize("rerank_k", [0, 26])
def test_sweep_bf16_lanes_match_jax_at_1536(counted, metric, rerank_k):
    """Raw bf16 and bf16 + re-rank at 1,536-wide rows (the wide form
    streaming its query rows on the card), each metric in the sweep
    table's form, against `_sweep_fn` on the same inputs."""
    import jax.numpy as jnp

    k = 10
    tbl, bias, qp = _wide_table(metric, 31 + rerank_k)
    got = ek._sweep(torch.from_numpy(tbl), torch.from_numpy(bias),
                    torch.from_numpy(qp), k, "bf16", rerank_k=rerank_k,
                    metric=metric).numpy()
    assert counted == [max(k, rerank_k)]
    want = np.asarray(_sweep_fn(N_WIDE, CHUNK, D_WIDE, k, 1.0, "bf16",
                                rerank_k, metric)(
        jnp.asarray(tbl), jnp.asarray(bias), jnp.asarray(qp)))
    _same_sets_close_scores(got, want)


@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
@pytest.mark.parametrize("variant", ["random", "ints"])
@pytest.mark.parametrize("rerank_k", [0, 26])
def test_sweep_f32_lane_matches_jax_at_1536(counted, metric, variant,
                                            rerank_k):
    """The f32 lane at 1,536-wide rows with its real width (`d_in`, which
    stops the card's chains there) against `_sweep_fn(...,
    compute_dtype="f32", rt=1.0)`: on small integers in L2's and IP's
    form (exact sums; Cosine's unit rows are not) ids and score bits
    equal rank for rank where nothing is re-ranked; else the same ids as
    sets (but the k-th score's ties on integers) and scores within 1e-5,
    as `test_sweep_f32_lane_matches_jax` holds the lane at d_pad 128."""
    import jax.numpy as jnp

    k = 10
    tbl, bias, qp = _wide_table(metric, 41 + rerank_k, variant)
    got = ek._sweep(torch.from_numpy(tbl), torch.from_numpy(bias),
                    torch.from_numpy(qp), k, "f32", rerank_k=rerank_k,
                    metric=metric, d_in=D_WIDE).numpy()
    assert counted == [max(k, rerank_k)]
    want = np.asarray(_sweep_fn(N_WIDE, CHUNK, D_WIDE, k, 1.0, "f32",
                                rerank_k, metric)(
        jnp.asarray(tbl), jnp.asarray(bias), jnp.asarray(qp)))
    if variant == "ints" and rerank_k == 0 and metric != "Cosine":
        (ids_t, s_t), (ids_j, s_j) = _unpack(got), _unpack(want)
        assert np.array_equal(ids_t, ids_j)
        assert np.array_equal(s_t.view(np.int32), s_j.view(np.int32))
        return
    if variant == "ints":  # any of the k-th score's ties may be kept
        (ids_t, s_t), (ids_j, s_j) = _unpack(got), _unpack(want)
        ids_t = [i[s > s.min()] for i, s in zip(ids_t, s_t)]
        ids_j = [i[s > s.min()] for i, s in zip(ids_j, s_j)]
        assert all(set(a) == set(b) for a, b in zip(ids_t, ids_j))
        np.testing.assert_allclose(np.sort(s_t, 1), np.sort(s_j, 1),
                                   rtol=1e-5, atol=1e-5)
        return
    _same_sets_close_scores(got, want)


@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
def test_sweep_i8_matches_jax_at_1536(counted, metric):
    """The i8 lane at 1,536-wide rows in each metric's sweep form, with
    rows and queries near a constant vector: int8 products past 2^24,
    where the s32 -> f32 conversion rounds (to nearest even, as
    `.astype(float32)`: planted; checked), against `_sweep_fn_i8`; ids
    rank for rank after the re-rank, as `test_sweep_i8_matches_jax`."""
    tbl, bias, qp = _wide_table(metric, 51)
    tbl_i8, _ = ek.quantize_tbl(torch.from_numpy(tbl), torch.from_numpy(bias))
    big = int_mm(tbl_i8.reshape(-1, D_WIDE)[:8], tbl_i8.reshape(-1, D_WIDE)[:8])
    assert int(big.abs().max()) > 1 << 24
    assert bool((big.float().to(torch.int64) != big.to(torch.int64)).any())
    _i8_matches_jax(counted, (tbl, bias, qp), D_WIDE, D_WIDE, metric=metric,
                    n_chunks=N_WIDE)


def test_sweep_f32_plain_is_the_old_two_step_lane():
    """`sweep_topk_plain` on f32 inputs is what the f32 lane computed before
    it had a kernel: a chunk's `qs @ tbl[c].T`, then `select_topk_plain`
    with the chunk's bias: values and ids bit-equal, a piece a chunk."""
    tbl, bias, qp = _f32_table(25, "L2", "random")
    q, t = torch.from_numpy(qp), torch.from_numpy(tbl)
    b = torch.from_numpy(bias)
    vals, ids = ek.sweep_topk_plain(q, t.reshape(-1, D_PAD), CHUNK, 26,
                                    b.reshape(-1))
    for c in range(N_CHUNKS):
        want = ek.select_topk_plain(q @ t[c].T, 26, bias=b[c],
                                    offset=c * CHUNK)
        got = (vals[:, c * 26:(c + 1) * 26], ids[:, c * 26:(c + 1) * 26])
        assert topk_same(got, want)


def test_sweep_i8_matches_jax(counted):
    """The i8 lane: the port's table, scales and quantised queries (bit-
    equal to the JAX package's, `tests/test_torch_i8.py`) through both."""
    _i8_matches_jax(counted, _table(6), D_PAD, D)


def test_sweep_i8_matches_jax_at_768(counted):
    """The same at 768-wide rows, with rows whose int8 codes are all near
    +-127: products near 768 x 127^2, past 2^22, where the s32 -> f32
    conversion must round as `.astype(float32)` does (planted; checked)."""
    table = _table(16, d_pad=768, d=768, flat_rows=8)
    tt = torch.from_numpy(table[0])
    tbl_i8, _ = ek.quantize_tbl(tt, torch.from_numpy(table[1]))
    big = int_mm(tbl_i8.reshape(-1, 768)[:8], tbl_i8.reshape(-1, 768)[:8])
    assert int(big.abs().max()) > 1 << 22
    _i8_matches_jax(counted, table, 768, 768)


def _i8_matches_jax(counted, table, d_pad, d, metric="Cosine",
                    n_chunks=N_CHUNKS):
    import jax.numpy as jnp

    tbl, bias, q = table
    k, rerank_k = 10, 64
    tt, bt = torch.from_numpy(tbl), torch.from_numpy(bias)
    tbl_i8, scale = ek.quantize_tbl(tt, bt)
    q16 = q.astype(np.float16)
    prepared = prepare_queries(torch.from_numpy(q16.astype(np.float32)),
                               metric, d_pad, half=True, quantize=True,
                               reciprocal=True)
    got = ek._sweep_i8(tbl_i8, scale, bt, tt, *prepared, k, rerank_k,
                       metric).numpy()
    assert counted == [rerank_k]
    want = np.asarray(_sweep_fn_i8(n_chunks, CHUNK, d_pad, k, 0.99, rerank_k,
                                   metric, d)(
        jnp.asarray(tbl_i8.numpy()), jnp.asarray(scale.numpy()),
        jnp.asarray(bias), jnp.asarray(tbl), jnp.asarray(q16)))
    (ids_t, s_t), (ids_j, s_j) = _unpack(got), _unpack(want)
    assert np.array_equal(ids_t, ids_j)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-5)


def test_build_step_matches_jax(counted):
    """One wave of the f32-table build step on integer rows (IP: exact
    sums in any order, so the pools compare exactly): ids, distance bits
    and selection mask equal to `_build_step_fn`'s, and the bf16 copy of
    the table updated in step."""
    _build_step_matches_jax(counted, 8, 24, D_PAD, D)


def test_build_step_matches_jax_at_768(counted):
    """The same at 768-wide rows."""
    _build_step_matches_jax(counted, 18, 24, 768, 768)


def _build_step_matches_jax(counted, seed, P, D_PAD, D):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    n, W, mmax = N_CHUNKS * CHUNK, 64, 8
    tbl = np.zeros((N_CHUNKS, CHUNK, D_PAD), np.float32)
    tbl.reshape(-1, D_PAD)[:, :D] = rng.integers(-2, 3, (n, D))
    bias = np.zeros((N_CHUNKS, CHUNK), np.float32)
    bias.reshape(-1)[rng.choice(n, 50, replace=False)] = -np.inf
    slots = rng.choice(n, W, replace=False).astype(np.int64)
    new_rows = np.zeros((W, D_PAD), np.float32)
    new_rows[:, :D] = rng.integers(-2, 3, (W, D))
    new_bias = np.zeros(W, np.float32)
    cs, rs = slots // CHUNK, slots % CHUNK
    _, _, want = _build_step_fn(N_CHUNKS, CHUNK, D_PAD, W, P, mmax, "IP",
                                0.9)(
        jnp.asarray(tbl), jnp.asarray(bias), jnp.asarray(new_rows),
        jnp.asarray(new_bias), jnp.asarray(cs.astype(np.int32)),
        jnp.asarray(rs.astype(np.int32)), jnp.asarray(slots.astype(np.int32)))
    want = np.asarray(want)
    tt, bt = torch.from_numpy(tbl.copy()), torch.from_numpy(bias.copy())
    tbl16 = tt.reshape(-1, D_PAD).to(torch.bfloat16)
    got = bb._build_step(tt, bt, torch.from_numpy(new_rows),
                         torch.from_numpy(new_bias), torch.from_numpy(slots),
                         P, mmax, "IP", tbl16=tbl16).numpy()
    assert counted == [P + 1]
    assert np.array_equal(got, want)
    assert torch.equal(tbl16, tt.reshape(-1, D_PAD).to(torch.bfloat16))


def test_ctypes_signature_matches_the_source():
    """`_SWEEP_ARGTYPES` follows the C entry in `csrc/sweep_topk.cu`, and
    `_SWEEP_F32_ARGTYPES` the one in `csrc/sweep_topk_f32.cu`:
    pointers as void*, ints as int, 64-bit ints as long long, in order.
    Both sources define the launch configuration's three queries alike,
    (kind, d_pad, kc), as `_bind_shape` binds them."""
    import ctypes
    import os
    import re

    from cozo_tpu_torch.ops import _build
    from tests.test_torch_fused_routes import _extern_c_functions

    funcs = _extern_c_functions()
    assert funcs["cozo_sweep_topk"] == ek._SWEEP_ARGTYPES
    assert funcs["cozo_sweep_topk_counts"] == [ctypes.c_void_p]
    assert funcs["cozo_sweep_topk_f32"] == ek._SWEEP_F32_ARGTYPES
    for source in ("sweep_topk.cu", "sweep_topk_f32.cu"):
        with open(os.path.join(_build.CSRC, source)) as f:
            src = f.read()
        for name in ("rows", "cluster", "slots"):
            sig = re.findall(rf"^int cozo_sweep_topk_{name}\(([^)]*)\)",
                             src, re.M)
            assert sig == ["int kind, int d_pad, int kc"], (source, name)


def test_the_lanes_piece_is_the_chunk_on_the_cpu():
    """`sweep_piece`: the CPU keeps the chunk (the card picks wider pieces,
    which give the same merged top kf; `tests/test_torch_cuda.py`)."""
    cpu = torch.device("cpu")
    for n_chunks, chunk, B, kc in ((10, 131_072, 16_384, 26), (3, 512, 96, 10),
                                   (73, 16_384, 4_096, 10)):
        assert ek.sweep_piece(n_chunks * chunk, chunk, B, 128, kc, False,
                              cpu) == chunk
