"""Tests of the port that need an NVIDIA card (marker `cuda`): each CUDA
kernel (`fused_sweep`, `beam_search`, the three graph kernels, `minhash`,
`slab_topk`, `sweep_topk`'s two, bf16 / int8 and f32) against its plain
PyTorch version, the graph rules' entry points and a
MinHash-LSH Db on the card against the same calls on the CPU, the
MinHash dispatch's own pinned buffers,
the lanes end to end through the kernels, the staging buffers of a
small-batch search and its lock under concurrent callers, the card's
int8 product
against the CPU's, and the hosts: the HTTP server over a Db on the card,
the C bridge's Db on the card when its options name no device, and a
trace that names a kernel.  They skip where CUDA is absent.  This file imports
neither JAX nor `cozo_tpu`, so it runs on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import (BEAM_CASES, F32_CHAIN_ORDER_D, GRAPH_LP_LABELS,
                        GRAPH_LP_WIDTHS,
                        GRAPH_PR_CASES, GRAPH_SSSP_CASES, MINHASH_CASES,
                        PR_L1_TOL, SSSP_FORCED_SHARES, graph_csr,
                        lp_inputs, minhash_inputs, minhash_tensors,
                        pagerank_agreement, pr_inputs, sssp_inputs,
                        sweep_agreement, sweep_cases, sweep_inputs,
                        sweep_slab_keys, topk_cases, topk_inputs, topk_same,
                        wide_index)
from chip_smoke import PHASE2_SHAPES as SHAPES
from chip_smoke import (agreement_ok, beam_args, beam_case, beam_ok,
                        compare_beam, compare_fused, random_case)
from cozo_tpu_torch import HnswIndex, sweep_search
from cozo_tpu_torch.ops import _build
from cozo_tpu_torch.ops import exact_knn as ek
from cozo_tpu_torch.ops import fused_sweep as fs
from cozo_tpu_torch.ops import graph_algos as ga
from cozo_tpu_torch.ops import minhash as mh
from cozo_tpu_torch.ops import vector_search as vs
from cozo_tpu_torch.utils.device import int_mm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_total,d_pad,dead", SHAPES)
def test_kernel_matches_plain(cuda, B, n_total, d_pad, dead):
    """At every shape `chip_smoke.py` phase 2 holds the kernel to, and by
    its measure: the ids carried in the packed output agree with the plain
    version's on >= 99.9% of entries (a last-bit difference of a sum may
    cross one 2^-15 packing quantum), no dead row is live; besides, the
    values are close on >= 99% and two runs are bit-identical."""
    qs, tbl, bias = random_case(B, n_total, d_pad, dead, cuda, seed=B)
    before = fs.fused_sweep.launches
    out = fs.fused_sweep(qs, tbl, bias)
    again = fs.fused_sweep(qs, tbl, bias)
    assert fs.fused_sweep.launches == before + 2
    ref = fs.fused_sweep_plain(qs, tbl, bias)
    torch.cuda.synchronize()
    assert out.shape == (B, 2 * n_total // fs.SEG)
    assert torch.equal(out, again)
    c = compare_fused(out, ref, n_total, dead)
    assert agreement_ok(c), c
    assert c["isclose"] >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_total,d_pad,dead", [SHAPES[2], SHAPES[4],
                                                  SHAPES[6], SHAPES[8]])
def test_launch_counts_the_route_the_shape_selects(cuda, B, n_total, d_pad,
                                                   dead):
    qs, tbl, bias = random_case(B, n_total, d_pad, dead, cuda)
    before = dict(fs.fused_sweep.route_launches)
    fs.fused_sweep(qs, tbl, bias)
    torch.cuda.synchronize()
    took = fs.route(B, n_total, d_pad)
    for r in fs.ROUTES:
        assert fs.fused_sweep.route_launches[r] == before[r] + (r == took)


@pytest.mark.cuda
def test_kernel_rejects_bad_shapes(cuda):
    qs = torch.zeros(4, 120, dtype=torch.bfloat16, device=cuda)
    tbl = torch.zeros(512, 120, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        fs.fused_sweep(qs, tbl, torch.zeros(512, device=cuda))


@pytest.mark.cuda
def test_fused_lane_goes_through_the_kernel(cuda):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((20_000, 64)).astype(np.float32)
    idx = HnswIndex(dim=64, m=8, ef_construction=50, distance="Cosine")
    idx.bulk_build(data, wave=4096)
    qs = data[:256] + 0.01 * rng.standard_normal((256, 64)).astype(np.float32)
    before = fs.fused_sweep.launches
    ids_f, _ = sweep_search(idx, qs, 10, compute_dtype="fused")
    assert fs.fused_sweep.launches == before + 1
    ids_b, _ = sweep_search(idx, qs, 10, compute_dtype="f32", rt=1.0)
    assert float(np.mean(ids_f[:, 0] == np.arange(256))) > 0.99
    overlap = np.mean([len(set(ids_f[i]) & set(ids_b[i])) / 10
                       for i in range(256)])
    assert overlap > 0.98


# ---- beam_search -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", BEAM_CASES,
    ids=lambda c: f"{c[0]}-d{c[2]}-m{c[3]}-B{c[4]}-ef{c[5]}-x{c[9]}-c{c[10]}")
def test_beam_search_matches_plain(cuda, case):
    """At `chip_smoke.py` phase 2's shapes and by its measure: ids equal on
    >= 99% of (query, rank) entries (the kernel's sums differ from the
    plain version's in the last bits, so two near-tied entries may swap),
    distances within 1e-4 where ids match, no dead row, two runs
    bit-identical, one count per launch."""
    idx, qs = beam_case(*case)
    args = beam_args(idx, qs, case[6], case[5], case[9])
    before = vs.beam_search.launches
    out = vs.beam_search(*args)
    again = vs.beam_search(*args)
    assert vs.beam_search.launches == before + 2
    ref = vs.beam_search_plain(*args)
    torch.cuda.synchronize()
    assert vs.beam_search.launches == before + 2  # the plain version: none
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    c = compare_beam(out, ref, args[3])
    assert beam_ok(c), c
    stats = vs.beam_search.last_stats.cpu().numpy()
    assert (stats[:, 1] >= 1).all() and (stats[:, 2] >= stats[:, 1]).all()
    assert (stats[:, 0] == 0).all() == (args[8] == 0)


@pytest.mark.cuda
def test_beam_search_refuses_a_beam_past_shared_memory(cuda):
    """Past the layout's limits the wrapper raises and launches nothing:
    a beam whose dedup table does not fit the block's shared memory, more
    candidates a round than the key array takes, an output buffer of
    another size."""
    idx, qs = beam_case(*BEAM_CASES[3])
    before = vs.beam_search.launches
    with pytest.raises(ValueError, match="more than the kernel takes"):
        vs.beam_search(*beam_args(idx, qs, 3, 8192))
    with pytest.raises(ValueError, match="more than the kernel takes"):
        vs.beam_search(*beam_args(idx, qs, 3, 64, expand=512))
    args = beam_args(idx, qs, 3, 64)
    with pytest.raises(ValueError, match="out must be"):
        vs.beam_search(*args, out=torch.zeros(7, dtype=torch.int32,
                                              device=cuda))
    assert vs.beam_search.launches == before
    # the largest beam the layout takes still runs
    beam = 8
    m0, m_up = args[1].shape[1], args[2].shape[2]
    while vs.smem_bytes(16, m0, m_up, 2 * beam, 8) <= vs.MAX_SMEM:
        beam *= 2
    ids, _ = vs.beam_search(*beam_args(idx, qs, 3, beam))
    ref, _ = vs.beam_search_plain(*beam_args(idx, qs, 3, beam))
    torch.cuda.synchronize()
    assert float((ids == ref).float().mean()) >= 0.99


@pytest.fixture(scope="module")
def big_index():
    """A table past 131,072 rows: small batches take the beam-search kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    rng = np.random.default_rng(3)
    data = rng.standard_normal((140_000, 16)).astype(np.float32)
    idx = HnswIndex(dim=16, m=8, ef_construction=50, distance="L2")
    idx.bulk_build(data, wave=8192)
    qs = data[:16] + 0.01 * rng.standard_normal((16, 16)).astype(np.float32)
    return idx, qs


@pytest.mark.cuda
def test_small_batch_search_goes_through_the_kernel(cuda, big_index):
    idx, qs = big_index
    before = vs.beam_search.launches
    ids, _ = idx.search(qs, k=10, ef=64)
    assert vs.beam_search.launches == before + 1
    assert float(np.mean(ids[:, 0] == np.arange(16))) > 0.9


@pytest.mark.cuda
def test_small_batch_searches_reuse_their_staging_buffers(cuda, big_index):
    """Two batch sizes on one index: each keeps one set of pinned staging
    buffers with the device mirror (the kernel reads and writes them in
    place), a repeated call reuses its set (same memory) and answers as a
    call with fresh buffers does, and what a call returned is its own:
    later calls do not write over it."""
    idx, qs = big_index
    ids16, d16 = idx.search(qs, k=10, ef=64)
    kept = idx._dev_cache["staging"]
    assert (16, 10) in kept
    ptrs = {name: t.data_ptr() for name, t in kept[(16, 10)].items()
            if isinstance(t, torch.Tensor)}
    assert kept[(16, 10)]["q_host"].is_pinned()
    assert kept[(16, 10)]["out_host"].is_pinned()
    ids16_copy, d16_copy = ids16.copy(), d16.copy()
    ids5, d5 = idx.search(qs[:5], k=10, ef=64)
    assert set(kept) >= {(16, 10), (5, 10)}
    again_ids, again_d = idx.search(qs, k=10, ef=64)
    assert idx._dev_cache["staging"] is kept
    assert ptrs == {name: t.data_ptr() for name, t in kept[(16, 10)].items()
                    if isinstance(t, torch.Tensor)}
    assert np.array_equal(again_ids, ids16) and np.array_equal(again_d, d16)
    assert np.array_equal(ids16, ids16_copy) and np.array_equal(d16, d16_copy)
    assert np.array_equal(ids5, ids16[:5]) and np.array_equal(d5, d16[:5])
    kept.clear()  # fresh buffers
    fresh_ids, fresh_d = idx.search(qs, k=10, ef=64)
    assert np.array_equal(fresh_ids, ids16) and np.array_equal(fresh_d, d16)
    assert ids16.dtype == np.int64 and d16.dtype == np.float64
    last = vs.beam_search.last_stats
    assert last.shape == (16, 4) and bool((last[:, 1] >= 1).all())
    with pytest.raises(ValueError, match="must be"):
        vs.hnsw_search_device(idx, qs[:, :1], 10, 64)  # would broadcast
    # the same kernel on buffers in device memory answers alike
    dev_ids, dev_d = vs.beam_search(*beam_args(idx, qs, 10, 64))
    assert np.array_equal(dev_ids.cpu().numpy(), ids16)
    assert np.array_equal(dev_d.cpu().numpy().astype(np.float64), d16)


@pytest.mark.cuda
def test_concurrent_small_batch_searches_equal_sequential(cuda, big_index):
    """8 threads call `hnsw_search_device` at once with the same (B, k), so
    they share one set of staging buffers, each with its own queries; the
    mirror's lock keeps every answer equal to its sequential one.  Then a
    writer inserts rows and the threads race to the mirror's in-place
    update: each answer equals that of a copy of the index whose mirror was
    pushed whole."""
    import sys
    import threading

    idx, qs = big_index
    rng = np.random.default_rng(9)
    sets = [qs + 0.05 * t * rng.standard_normal(qs.shape).astype(np.float32)
            for t in range(8)]
    errors = []

    def race(want):
        def worker(t):
            try:
                for _ in range(20):
                    ids, d = vs.hnsw_search_device(idx, sets[t], 10, 64)
                    assert np.array_equal(ids, want[t][0])
                    assert np.array_equal(d, want[t][1])
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)  # switch threads often: races show
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        finally:
            sys.setswitchinterval(switch)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors[:2]

    race([vs.hnsw_search_device(idx, q, 10, 64) for q in sets])
    cache = idx._dev_cache
    far = np.full((4, 16), 1e3, dtype=np.float32) + np.arange(4)[:, None]
    new = [idx.insert(v) for v in far]
    twin = HnswIndex.from_state(idx.to_state(), device=idx.device)
    race([vs.hnsw_search_device(twin, q, 10, 64) for q in sets])
    assert idx._dev_cache is cache and not idx.dev_pending
    ids, _ = vs.hnsw_search_device(idx, far, 1, 64)
    assert ids[:, 0].tolist() == new


@pytest.mark.cuda
def test_int_mm_lane_matches_the_cpu_int32_product(cuda):
    """`torch._int_mm` on the card gives the integers of the CPU's int32
    matmul, padded small batches included; and the i8 lane through it
    clears the lane's recall bar."""
    rng = np.random.default_rng(5)
    for B in (1, 16, 17, 300):
        a = torch.from_numpy(rng.integers(-127, 128, (B, 128), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (4096, 128), dtype=np.int8))
        got = int_mm(a.to(cuda), b.to(cuda))
        assert got.shape == (B, 4096) and got.dtype == torch.int32
        assert torch.equal(got.cpu(), int_mm(a, b))
    data = rng.standard_normal((20_000, 64)).astype(np.float32)
    idx = HnswIndex(dim=64, m=8, ef_construction=50, distance="Cosine")
    idx.bulk_build(data, wave=4096)
    qs = data[:256] + 0.01 * rng.standard_normal((256, 64)).astype(np.float32)
    for nq in (256, 5):  # 5: the product pads the batch
        ids_i, _ = sweep_search(idx, qs[:nq], 10, compute_dtype="i8")
        ids_f, _ = sweep_search(idx, qs[:nq], 10, compute_dtype="f32", rt=1.0)
        overlap = np.mean([len(set(ids_i[i]) & set(ids_f[i])) / 10
                           for i in range(nq)])
        assert overlap > 0.98


# ------------------------------------------------------------ graph kernels


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,steps,dangling,hub", GRAPH_PR_CASES)
def test_graph_pagerank_matches_plain(cuda, n, e, steps, dangling, hub):
    """L1 <= 1e-5 against the plain version, the same top 100 up to ties,
    two runs bit-identical (no float atomics), 0 on padding."""
    staged = pr_inputs(n, e, dangling, cuda, hub)
    before = ga.pagerank_steps.launches
    got = ga.pagerank_steps(*staged, n, steps, 0.85)
    again = ga.pagerank_steps(*staged, n, steps, 0.85)
    assert ga.pagerank_steps.launches == before + 2
    want = ga.pagerank_plain(*staged, n, steps, 0.85)
    l1, top = pagerank_agreement(got, want, n)
    assert l1 <= PR_L1_TOL and top
    assert torch.equal(got, again) and not bool(got[n:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", GRAPH_SSSP_CASES)
def test_graph_sssp_matches_plain(cuda, case):
    """Distances, parents and the steps run EQUAL the plain version's,
    with the wrapper's push share and with every step pushed or pulled."""
    g, sources, max_iters = sssp_inputs(case, cuda)
    got = ga.sssp_ell(g, sources, max_iters)
    want = ga.sssp_ell_plain(g, sources, max_iters)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
    again = ga.sssp_ell(g, sources, max_iters)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    lib = ga._bind_sssp(_build.load("graph_sssp"))
    for share in SSSP_FORCED_SHARES.values():
        forced = ga._sssp_launch(lib, g, sources, max_iters,
                                 ga._stream(g.flat_src), share)
        assert torch.equal(forced[0], want[0])
        assert torch.equal(forced[1], want[1]) and forced[2] == want[2]


def check_lp_pick(cuda, W, weighted, kind):
    H = 4096 if W <= 128 else 64
    labels, nb, w, idx, has_in, n_real = lp_inputs(H, W, weighted, W, cuda,
                                                   kind)
    got = labels.clone()
    ga.lp_pick(labels, nb, w, idx, has_in, n_real, got)
    want = labels.clone()
    ga.lp_pick_plain(labels, nb, w, idx, has_in, n_real, want)
    assert torch.equal(got, want)
    node = 2 if idx is None else int(idx[2])
    assert int(got[node]) == 65


@pytest.mark.cuda
@pytest.mark.parametrize("W", GRAPH_LP_WIDTHS)
@pytest.mark.parametrize("weighted", [False, True])
def test_graph_lp_pick_matches_plain(cuda, W, weighted):
    """Picks EQUAL the plain version's (unit or k/8 weights: exact sums),
    the planted tie to the smaller label."""
    check_lp_pick(cuda, W, weighted, "mixed")


@pytest.mark.cuda
@pytest.mark.parametrize("W", GRAPH_LP_WIDTHS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", GRAPH_LP_LABELS[1:])
def test_graph_lp_pick_label_mixes(cuda, W, weighted, kind):
    """All labels distinct, three, one."""
    check_lp_pick(cuda, W, weighted, kind)

@pytest.mark.cuda
def test_graph_rules_on_the_card_equal_the_cpu(cuda):
    """The entry points on 60,000 edges (a hub past 1,024 in-edges, so
    SSSP has level-2 rows and LabelPropagation takes the hybrid lanes):
    the card through the kernels, the CPU through the plain versions."""
    ip, d = graph_csr(5000, 60_000, 3, hub=1500, dangling=100)
    w = np.random.default_rng(1).integers(1, 16, len(d)).astype(np.float32) / 8
    ck = ga.graph_content_key(ip, d)
    counts = (ga.pagerank_steps.launches, ga.sssp_ell.launches,
              ga.lp_pick.launches)
    pr = ga.pagerank_jax(ip, d, cache_key=ck)
    sp = ga.sssp_device(ip, d, w, [0, 1, 2], cache_key=ck)
    lp = ga.labelprop_jax(ip, d, iterations=6, cache_key=ck)
    assert (ga.pagerank_steps.launches > counts[0]
            and ga.sssp_ell.launches > counts[1]
            and ga.lp_pick.launches > counts[2])
    assert np.abs(pr - ga.pagerank_jax(ip, d, device="cpu")).sum() <= PR_L1_TOL
    sp_c = ga.sssp_device(ip, d, w, [0, 1, 2], device="cpu")
    assert np.array_equal(sp[0], sp_c[0]) and np.array_equal(sp[1], sp_c[1])
    assert np.array_equal(lp, ga.labelprop_jax(ip, d, iterations=6,
                                               device="cpu"))



@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(MINHASH_CASES)),
                         ids=[c[0] for c in MINHASH_CASES])
def test_minhash_matches_plain(cuda, i):
    """Every phase-2 case: signatures bit-equal to the plain version and to
    the host `minhash_segments`, two runs identical, one launch each."""
    _, lens, n_perm = MINHASH_CASES[i]
    flat, offs = minhash_inputs(lens, i)
    h, o = minhash_tensors(flat, offs, cuda)
    before = mh.segment_min.launches
    outs = [mh.segment_min(h, o, n_perm, torch.empty(
        (len(offs), n_perm), dtype=torch.int32, device=cuda))
        for _ in range(2)]
    assert mh.segment_min.launches == before + 2
    want = mh.segment_min_plain(h, o, n_perm)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], want) and torch.equal(outs[0], outs[1])
    assert (outs[0].cpu().numpy().view(np.uint32)
            == mh.minhash_segments(flat, offs, n_perm)).all()


@pytest.mark.cuda
def test_minhash_dispatches_read_in_reverse_keep_their_own_buffers(cuda):
    """Two chunks in flight, as the backfill keeps them: of one shape (the
    backfill's chunks are all 32,768 docs) but different hashes.  Each
    dispatch's pinned buffers are its own, so the second's copy never
    overwrites the first's signatures, whichever is read first."""
    flat_a, offs = minhash_inputs({"n": 4000, "lo": 8, "hi": 18}, 1)
    flat_b = np.random.default_rng(2).integers(
        0, 1 << 32, len(flat_a), dtype=np.uint64).astype(np.uint32)
    before = mh.segment_min.launches
    fa = mh.minhash_segments_dispatch(flat_a, offs, 128)
    fb = mh.minhash_segments_dispatch(flat_b, offs.copy(), 128)
    assert mh.segment_min.launches == before + 2
    got_b, got_a = fb.get(), fa.get()
    want_a = mh.minhash_segments(flat_a, offs, 128)
    want_b = mh.minhash_segments(flat_b, offs, 128)
    assert not (want_a == want_b).all()
    assert (got_b == want_b).all() and (got_a == want_a).all()
    assert got_a.shape == got_b.shape
    assert got_a.ctypes.data != got_b.ctypes.data


@pytest.mark.cuda
def test_lsh_db_on_the_card_equals_the_cpu(cuda):
    """`::lsh create` past DEVICE_MIN_TOKENS through the kernel, searches
    and maintenance: the same rows and stored signatures as a CPU Db."""
    from cozo_tpu_torch import Db

    rng = np.random.default_rng(4)
    docs = [" ".join(f"w{w}" for w in rng.integers(0, 400, 12))
            for _ in range(3000)]
    scripts = [
        "?[id, s] := ~doc:sim{id | query: $q, k: 5, bind_similarity: s}",
        "?[id, sig] := *doc:sim:inv{id, signature: sig}",
    ]
    answers = []
    for dev in (cuda, "cpu"):
        db = Db("mem", device=dev)
        db.run_script(":create doc {id: Int => body: String}")
        db.run_script("?[id, body] <- $rows :put doc {id => body}",
                      {"rows": [[i, d] for i, d in enumerate(docs)]})
        before = mh.segment_min.launches
        db.run_script("::lsh create doc:sim {extractor: body, "
                      "tokenizer: Simple, n_perm: 128, target_threshold: 0.7}")
        launched = mh.segment_min.launches - before
        assert launched == (1 if dev is cuda else 0)
        db.run_script("?[id] <- [[3]] :rm doc {id}")
        db.run_script("?[id, body] <- [[5000, $q]] :put doc {id => body}",
                      {"q": docs[7]})
        answers.append([db.run_script(s, {"q": docs[7]}).rows
                        for s in scripts])
    assert answers[0] == answers[1]
    assert [5000, 1.0] in answers[0][0] and [7, 1.0] in answers[0][0]


def _sweep_source(n, d, seed):
    """What `ShardedSweep` reads of an index: n x d cosine rows."""
    import types

    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return types.SimpleNamespace(
        dim=d, n=n, vectors=x, alive=np.ones(n, bool), distance="Cosine",
        norms=np.einsum("nd,nd->n", x.astype(np.float64), x.astype(np.float64)))


@pytest.mark.cuda
def test_mesh_one_shard_against_two_on_the_card(cuda):
    """`ShardedSweep` on [cuda:0] and on [cuda:0, cuda:0]: the same ids
    (equal chunks give equal products), recall@10 of the bf16 scan >= 0.95
    against the exact f32 top-10; the sharded PageRank step on two shards
    of the card deterministic and within 1e-6 of the f64 host sum, and the
    SSSP step's fixed point equal to the CPU mesh's."""
    from cozo_tpu_torch.parallel import mesh as pm

    src = _sweep_source(70_000, 100, 1)
    qs = src.vectors[:256] + 0.05 * np.random.default_rng(2).standard_normal(
        (256, 100)).astype(np.float32)
    one = pm.ShardedSweep(pm.make_mesh(devices=[cuda]), src)
    two = pm.ShardedSweep(pm.make_mesh(devices=[cuda, cuda]), src)
    assert (one.n_chunks, two.n_chunks, two.local_chunks) == (5, 6, 3)
    ids1, d1 = one.search(qs, 10)
    ids2, d2 = two.search(qs, 10)
    assert np.array_equal(ids1, ids2) and np.array_equal(d1, d2)
    xn = src.vectors / np.linalg.norm(src.vectors, axis=1, keepdims=True)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ xn.T), axis=1)[:, :10]
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids2, gt)])
    assert rec >= 0.95, rec

    rng = np.random.default_rng(3)
    n, e = 20_000, 400_000
    s, t = rng.integers(0, n, e), rng.integers(0, n, e)
    deg = np.maximum(np.bincount(s, minlength=n), 1).astype(np.float32)
    m2 = pm.make_mesh(devices=[cuda, cuda])
    step = pm.sharded_pagerank_step(m2, s, t, deg, n)
    sh = [pm.shard_array(m2, a) for a in (s, t)]
    ranks = torch.full((n,), 1.0 / n, device=cuda)
    got = step(*sh, ranks)
    assert torch.equal(got, step(*sh, ranks)) and got.device.type == cuda.type
    want = np.zeros(n)
    np.add.at(want, t, (1.0 / n) / deg[s].astype(np.float64))
    assert np.abs(got.cpu().numpy() - want).sum() <= 1e-6

    w = rng.uniform(0.5, 2.0, e).astype(np.float32)
    cpu2 = pm.make_mesh(devices=["cpu", "cpu"])
    fixed = []
    for m in (m2, cpu2):
        sstep = pm.sharded_sssp_step(m, n)
        shards = [pm.shard_array(m, a) for a in (s, t, w)]
        dist = torch.full((n,), float("inf"), device=m.lead)
        dist[0] = 0
        for _ in range(200):
            new = sstep(*shards, dist)
            if torch.equal(new, dist):
                break
            dist = new
        fixed.append(dist.cpu())
    assert torch.equal(fixed[0], fixed[1])


@pytest.mark.cuda
def test_tkv_db_on_the_card_answers_hnsw(cuda, tmp_path):
    """A `Db("tkv")` on the card: a 16-query join (the sweep lane on the
    card: the table is under one chunk) gives the ids of
    `HnswIndex.search` called directly, and after the store is closed and
    reopened the rows and the answers are the same."""
    from cozo_tpu_torch import Db

    rng = np.random.default_rng(5)
    x = rng.standard_normal((24_000, 32)).astype(np.float32)
    path = str(tmp_path / "kv")
    db = Db("tkv", path, device=cuda)
    db.run_script(":create item {id: Int => v: <F32; 32>}")
    db.run_script("?[id, v] <- $rows :put item {id => v}",
                  {"rows": [[i, x[i]] for i in range(len(x))]})
    db.run_script("::hnsw create item:ix {dim: 32, m: 16, "
                  "ef_construction: 64, fields: [v], distance: Cosine}")
    db.run_script(":create q {qid: Int => v: <F32; 32>}")
    db.run_script("?[qid, v] <- $rows :put q {qid => v}",
                  {"rows": [[i, x[i * 7] + 0.01] for i in range(16)]})
    join = ("?[qid, id] := *q{qid, v: qv}, ~item:ix{id | query: qv, k: 10, "
            "ef: 64}")
    rows = sorted(db.run_script(join).rows)
    cache = db.algo_cache["hnsw::item::ix"]
    assert cache.index._sweep_table.tbl.device.type == cuda.type
    ids, _ = cache.index.search(
        np.stack([x[i * 7] + 0.01 for i in range(16)]), 10, 64)
    sid = cache.slot_ids_array()
    want = sorted([q, int(sid[i])] for q in range(16)
                  for i in ids[q] if i >= 0)
    assert rows == want
    assert all([q, q * 7] in rows for q in range(16))
    db.close()
    again = Db("tkv", path, device=cuda)
    assert again.run_script("?[count(id)] := *item{id}").rows == [[24_000]]
    assert sorted(again.run_script(join).rows) == rows
    again.close()


def _card_db_with_index(n=24_000, d=32):
    """A mem Db on the card with an HNSW index and 16 stored queries."""
    from cozo_tpu_torch import Db

    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, d)).astype(np.float32)
    db = Db("mem")
    db.run_script(f":create item {{id: Int => v: <F32; {d}>}}")
    db.run_script("?[id, v] <- $rows :put item {id => v}",
                  {"rows": [[i, x[i]] for i in range(n)]})
    db.run_script(f"::hnsw create item:ix {{dim: {d}, m: 16, "
                  "ef_construction: 64, fields: [v], distance: Cosine}")
    db.run_script(f":create q {{qid: Int => v: <F32; {d}>}}")
    db.run_script("?[qid, v] <- $rows :put q {qid => v}",
                  {"rows": [[i, x[i * 7] + 0.01] for i in range(16)]})
    return db


SMALL_JOIN = ("?[qid, id, dist] := *q{qid, v: qv}, ~item:ix{id | query: qv, "
              "k: 10, ef: 64, bind_distance: dist}")


@pytest.mark.cuda
def test_server_on_a_card_db_answers_a_small_join(cuda):
    """`hosts/server.serve` over a Db on the card: 4 clients' small joins
    over HTTP give the Db's own rows."""
    import json
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from cozo_tpu_torch.hosts.server import serve

    db = _card_db_with_index()
    assert db.device.type == "cuda"
    want = sorted(json.loads(db.run_script_json(SMALL_JOIN))["rows"])
    srv = serve(db, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def ask(_):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/text-query",
            data=json.dumps({"script": SMALL_JOIN}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            return sorted(json.loads(resp.read())["rows"])

    try:
        with ThreadPoolExecutor(4) as ex:
            got = list(ex.map(ask, range(8)))
    finally:
        srv.shutdown()
        srv.server_close()
    assert len(want) == 160 and all(g == want for g in got)


@pytest.mark.cuda
def test_c_bridge_opens_on_the_card_without_options(cuda):
    import json

    from cozo_tpu_torch.hosts import c_bridge

    for options in ("", "{}"):
        out = json.loads(c_bridge.open_db("mem", "", options))
        assert out["ok"] is True
        assert c_bridge._DBS[out["id"]].device.type == "cuda"
        res = json.loads(c_bridge.run_query(out["id"], "?[a] <- [[1]]", "{}",
                                            True))
        assert res["rows"] == [[1]]
        assert c_bridge.close_db(out["id"])


@pytest.mark.cuda
def test_device_trace_names_a_kernel(cuda, tmp_path):
    """A trace around fused-sweep launches on the card names the kernel."""
    import json
    import os

    from cozo_tpu_torch.utils.profiling import device_trace

    B, n_total, d_pad, dead = SHAPES[0]
    qs, tbl, bias = random_case(B, n_total, d_pad, dead, cuda, seed=3)
    fs.fused_sweep(qs, tbl, bias)
    torch.cuda.synchronize()
    with device_trace(str(tmp_path)):
        for _ in range(3):
            fs.fused_sweep(qs, tbl, bias)
        torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("sweep_" in k for k in kernels), sorted(kernels)


TOPK_CASES = topk_cases(widths=(512, 4097, 10_240), ragged=None)


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(TOPK_CASES)),
                         ids=[f"B{B}-W{W}-kf{kf}-{v}-{k}"
                              for B, W, kf, v, k in TOPK_CASES])
def test_slab_topk_matches_plain(cuda, i):
    """Every variant and kind of `chip_smoke.py` phase 2 up to W = 10,240:
    values and ids bit-equal to the plain version, two runs identical, one
    launch each."""
    B, W, kf, variant, kind = TOPK_CASES[i]
    x, kw = topk_inputs(B, W, variant, kind, i, cuda)
    before = ek.select_topk.launches
    got = ek.select_topk(x, kf, **kw)
    again = ek.select_topk(x, kf, **kw)
    assert ek.select_topk.launches == before + 2
    assert topk_same(got, ek.select_topk_plain(x, kf, **kw))
    assert topk_same(got, again)


@pytest.mark.cuda
def test_slab_topk_refuses_tensors_off_the_card(cuda):
    x = torch.zeros((4, 512), device=cuda)
    with pytest.raises(ValueError):
        ek.select_topk(x, 10, bias=torch.zeros(512))


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["f32", "bf16", "i8", "fused"])
def test_bf16_and_i8_lanes_launch_sweep_topk_the_others_slab_topk(cuda, cd):
    """A lane's search launches its selection kernel (the fused lane
    `slab_topk` once over its packed array; the f32, bf16 and i8 lanes
    `sweep_topk` once for all the pieces `sweep_piece` cuts, the f32 lane
    on its own kernel, counted in `sweep_topk.f32_launches` too, and
    `slab_topk` at most once, to merge them) and returns the CPU's ids."""
    rng = np.random.default_rng(4)
    data = rng.standard_normal((3000, 24)).astype(np.float32)
    qs = rng.standard_normal((64, 24)).astype(np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        idx = HnswIndex(dim=24, m=8, ef_construction=32, distance="Cosine",
                        device=dev)
        idx.bulk_build(data, wave=1024)
        before = (ek.select_topk.launches, ek.sweep_topk.launches,
                  ek.sweep_topk.f32_launches)
        got[dev] = sweep_search(idx, qs, 5, compute_dtype=cd)[0]
        if dev == "cuda":
            after = (ek.select_topk.launches, ek.sweep_topk.launches,
                     ek.sweep_topk.f32_launches)
            if cd in ("f32", "bf16", "i8"):
                assert after[1] == before[1] + 1
                assert after[2] == before[2] + (cd == "f32")
                assert after[0] - before[0] in (0, 1)
            else:
                assert after[0] > before[0] and after[1:] == before[1:]
    assert np.mean(got["cpu"] == got["cuda"]) > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16", "i8"])
def test_wide_sweep_lanes_take_the_kernel_route(cuda, cd):
    """At d = 768 (the kernel's wide form) `sweep_search`'s bf16 and i8
    lanes, as `HnswIndex.search` serves a batch of B >= 64 there, launch
    `sweep_topk` once (no call on its two-step route) and give the CPU's
    answers."""
    rng = np.random.default_rng(8)
    data = rng.standard_normal((5000, 768)).astype(np.float32)
    qs = rng.standard_normal((64, 768)).astype(np.float32)
    norms = np.einsum("nd,nd->n", data, data)
    got = {}
    for dev in ("cpu", "cuda"):
        before = (ek.sweep_topk.launches, ek.sweep_topk.two_step)
        got[dev] = sweep_search(wide_index(data, norms, dev), qs, 10,
                                compute_dtype=cd,
                                rerank_k=64 if cd == "i8" else None)
        if dev == "cuda":
            assert (ek.sweep_topk.launches, ek.sweep_topk.two_step) == (
                before[0] + 1, before[1])
    assert np.mean(got["cpu"][0] == got["cuda"][0]) > 0.99
    np.testing.assert_allclose(np.sort(got["cuda"][1], 1),
                               np.sort(got["cpu"][1], 1), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16", "i8", "f32"])
def test_1536_wide_lanes_take_the_kernel_route(cuda, cd):
    """At d = 1,536 (OpenAI's embeddings: the wide form streams its query
    rows, the f32 kind its K-slices) `sweep_search`'s bf16, i8 and f32
    lanes launch `sweep_topk` once (the f32 kind's counted apart; no call
    on its two-step route) and give the CPU's answers."""
    rng = np.random.default_rng(9)
    data = rng.standard_normal((5000, 1536)).astype(np.float32)
    qs = rng.standard_normal((64, 1536)).astype(np.float32)
    norms = np.einsum("nd,nd->n", data, data)
    lane = {"bf16": {}, "i8": {"rerank_k": 64},
            "f32": {"rt": 1.0, "exact_rerank": False}}[cd]
    got = {}
    for dev in ("cpu", "cuda"):
        before = (ek.sweep_topk.launches, ek.sweep_topk.f32_launches,
                  ek.sweep_topk.two_step)
        got[dev] = sweep_search(wide_index(data, norms, dev), qs, 10,
                                compute_dtype=cd, **lane)
        if dev == "cuda":
            assert (ek.sweep_topk.launches, ek.sweep_topk.f32_launches,
                    ek.sweep_topk.two_step) == (
                before[0] + 1, before[1] + (cd == "f32"), before[2])
    assert np.mean(got["cpu"][0] == got["cuda"][0]) > 0.99
    np.testing.assert_allclose(np.sort(got["cuda"][1], 1),
                               np.sort(got["cpu"][1], 1), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_sweep_topk_raises_where_it_cannot_launch_wide(cuda, kind):
    """No fallback at the new widths: at d_pad 1,536 queries one element
    off a 16-byte boundary (contiguous, so the wrapper's checks pass) make
    the kernel's entry refuse, and the wrapper raises; nothing is counted
    on either route."""
    q, tbl, kw = sweep_inputs(kind, 4, 256, 1, 1536, "random", 3, cuda)
    off = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    off = off.view(q.shape)
    off.copy_(q)
    before = (ek.sweep_topk.launches, ek.sweep_topk.two_step)
    with pytest.raises(RuntimeError):
        ek.sweep_topk(off, tbl, 256, 10, **kw)
    assert (ek.sweep_topk.launches, ek.sweep_topk.two_step) == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,kc,kind", [(4_096, 26, 0), (4_096, 10, 0),
                                       (4_096, 64, 1), (4_096, 128, 1),
                                       (8_192, 97, 0), (4_096, 116, 0),
                                       (4_096, 116, 1), (4_096, 10, 2),
                                       (4_096, 116, 2)])
def test_the_1536_lanes_piece_fills_the_slots(cuda, B, kc, kind):
    """Phase 3d's chunk steps (500,000 rows in 4 chunks of 131,072, d_pad
    1,536; bf16, int8 and f32 kinds, at the lanes' kc and at 116):
    `sweep_piece` cuts pieces of the kernel's route that divide the table,
    at least a chunk / 8 wide, whose blocks fill SWEEP_FILL of the slots'
    waves."""
    lib = ek._sweep_f32_lib() if kind == ek.SWEEP_F32 else ek._sweep_lib()
    slots = lib.cozo_sweep_topk_slots(kind, 1536, kc)
    rows = lib.cozo_sweep_topk_rows(kind, 1536, kc)
    cluster = lib.cozo_sweep_topk_cluster(kind, 1536, kc)
    assert slots >= cluster >= 1
    n_total, chunk = 4 * 131_072, 131_072
    piece = ek.sweep_piece(n_total, chunk, B, 1536, kc, kind, cuda)
    assert ek.sweep_route(1536, kc, piece) == "kernel"
    assert piece % ek.SWEEP_PIECE == 0 and n_total % piece == 0
    assert piece >= chunk // 8
    n_qt = -(-(-(-B // rows)) // cluster) * cluster
    blocks = n_qt * (n_total // piece)
    assert blocks / (slots * -(-blocks // slots)) >= ek.SWEEP_FILL


SWEEP_CASES = [c for c in sweep_cases() if c[2] <= 8192]


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(SWEEP_CASES)),
                         ids=["-".join(map(str, c)) for c in SWEEP_CASES])
def test_sweep_topk_matches_plain(cuda, i):
    """Every case of `chip_smoke.py` phase 2 with pieces up to 8,192 rows,
    by its measure (`sweep_agreement`: int8 bit-equal; bf16 values within
    1e-5 x max(1, |v|), ids equal on >= 99.9%, every other a near-tie; f32
    the same, past d_pad 1,024 by the near-tie test alone), two runs
    identical, one launch each."""
    kind, B, W, n_p, d_pad, kc, variant = SWEEP_CASES[i]
    q, tbl, kw = sweep_inputs(kind, B, W, n_p, d_pad, variant, i, cuda)
    before = ek.sweep_topk.launches
    got = ek.sweep_topk(q, tbl, W, kc, **kw)
    again = ek.sweep_topk(q, tbl, W, kc, **kw)
    assert ek.sweep_topk.launches == before + 2
    ok, share, err = sweep_agreement(got, ek.sweep_topk_plain(q, tbl, W, kc,
                                                              **kw),
                                     sweep_slab_keys(q, tbl, kw),
                                     kind == "f32"
                                     and d_pad > F32_CHAIN_ORDER_D)
    assert ok, (share, err)
    assert topk_same(got, again)


@pytest.mark.cuda
def test_sweep_topk_takes_the_two_step_route_past_its_shapes(cuda):
    """d_pad 4,112 (past the kernels' 4,096), kc 300 and pieces of 128
    rows take the product and `slab_topk`, counted apart, with the plain
    version's answer; the kernel is not launched."""
    for d_pad, kc, piece in ((4112, 26, 512), (128, 300, 512),
                             (128, 26, 128)):
        q, tbl, kw = sweep_inputs("bf16", 5, 512, 2, d_pad, "random", 1, cuda)
        before = (ek.sweep_topk.launches, ek.sweep_topk.two_step)
        got = ek.sweep_topk(q, tbl, piece, kc, **kw)
        assert (ek.sweep_topk.launches, ek.sweep_topk.two_step) == (
            before[0], before[1] + 1)
        ok, _, _ = sweep_agreement(got, ek.sweep_topk_plain(q, tbl, piece, kc,
                                                            **kw),
                                   sweep_slab_keys(q, tbl, kw))
        assert ok


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks,chunk,B,kc,int8", [
    (10, 131_072, 16_384, 26, False), (10, 131_072, 8_192, 97, False),
    (10, 131_072, 16_384, 64, True), (73, 16_384, 16_384, 10, False),
    (10, 131_072, 4_096, 26, False), (1, 512, 64, 10, False)])
def test_the_lanes_piece_divides_the_table(cuda, n_chunks, chunk, B, kc, int8):
    """`sweep_piece` on the card: a multiple of 256 rows that divides the
    table, at least a chunk / 8 wide, and the widest of those that fill
    the SMs as well; at d_pad 384, 768, 1,536 and 4,096 (the wide form: 64
    query rows a block, blocks in pairs) from the library's rows, cluster
    and slots of that configuration."""
    n_total = n_chunks * chunk
    piece = ek.sweep_piece(n_total, chunk, B, 128, kc, int8, cuda)
    assert piece % ek.SWEEP_PIECE == 0 and n_total % piece == 0
    assert piece >= min(n_total, max(chunk // 8, ek.SWEEP_PIECE))
    # the two-step route keeps the chunk: its slab is a piece wide
    assert ek.sweep_piece(n_total, chunk, B, 4112, kc, int8, cuda) == chunk
    lib = ek._sweep_lib()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for d_pad in (384, 768, 1536, 4096):
        assert lib.cozo_sweep_topk_rows(int(int8), d_pad, kc) == 64
        assert lib.cozo_sweep_topk_cluster(int(int8), d_pad, kc) == 2
        slots = lib.cozo_sweep_topk_slots(int(int8), d_pad, kc)
        assert slots % 2 == 0 and 2 <= slots <= sms
        wide = ek.sweep_piece(n_total, chunk, B, d_pad, kc, int8, cuda)
        assert wide % ek.SWEEP_PIECE == 0 and n_total % wide == 0
        assert wide >= min(n_total, max(chunk // 8, ek.SWEEP_PIECE))


@pytest.mark.cuda
@pytest.mark.parametrize("d_pad", [384, 768])
@pytest.mark.parametrize("B,kc,int8", [(4_096, 26, False), (4_096, 10, False),
                                       (4_096, 64, True), (4_096, 128, True),
                                       (8_192, 97, False)])
def test_the_wide_lanes_piece_fills_the_slots(cuda, d_pad, B, kc, int8):
    """Phase 3b's chunk steps (a table of 2,097,152 rows in chunks of
    131,072) at d_pad 384 and 768: the wide form's slots are whole pairs
    on at least 120 of the card's SMs, and `sweep_piece` cuts pieces that
    divide the table and whose blocks (64 query rows, in pairs, a block a
    piece) fill SWEEP_FILL of the slots' waves."""
    lib = ek._sweep_lib()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    slots = lib.cozo_sweep_topk_slots(int(int8), d_pad, kc)
    assert slots % 2 == 0 and min(120, sms) <= slots <= sms
    n_total = 2_097_152
    piece = ek.sweep_piece(n_total, 131_072, B, d_pad, kc, int8, cuda)
    assert piece % ek.SWEEP_PIECE == 0 and n_total % piece == 0
    blocks = -(-B // 64) * (n_total // piece)  # B / 64 is even: whole pairs
    assert blocks / (slots * -(-blocks // slots)) >= ek.SWEEP_FILL


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [1, 32, 33, 64, 65, 128, 129, 256])
@pytest.mark.parametrize("int8", [False, True])
def test_sweep_topk_block_shape_and_slots(cuda, kc, int8):
    """The kernel's query rows a block (to d_pad 128: 128 with the lists,
    kc <= 64, 64 past; wider: 64, in pairs), its cluster (1 or 2 blocks)
    and the blocks the card holds at once: whole clusters, at least one a
    cluster's worth, at most the SMs."""
    lib = ek._sweep_lib()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for d_pad in (16, 128, 256, 768, 1024, 1536, 2048, 3072, 4096):
        rows = lib.cozo_sweep_topk_rows(int(int8), d_pad, kc)
        assert rows == (64 if d_pad > 128 or kc > 64 else 128)
        cluster = lib.cozo_sweep_topk_cluster(int(int8), d_pad, kc)
        assert cluster == 2 if d_pad > 128 else cluster in (1, 2)
        slots = lib.cozo_sweep_topk_slots(int(int8), d_pad, kc)
        assert cluster <= slots <= sms and slots % cluster == 0


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
def test_f32_lane_is_the_two_step_route_on_the_card(cuda, metric):
    """The f32 lane (`_sweep` at compute_dtype "f32": one launch of the f32
    kernel, then the merge) against the lane as it ran before it had a
    kernel, a chunk's `torch.mm` in f32 and `select_topk`, on the same
    inputs (4 chunks of 131,072 rows, 300 queries, d 100 padded to 128,
    dead rows): ids and score bits equal, the kernel's chain and cuBLAS's
    being the same sums in the same order (phase 3 of `chip_smoke.py` says
    how many rows differ at the main shape if they are not)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    n_chunks, chunk, d_pad = 4, 131_072, 128
    tbl = torch.zeros((n_chunks * chunk, d_pad), device=cuda)
    tbl[:, :100] = torch.randn((n_chunks * chunk, 100), generator=g,
                               device=cuda)
    bias = torch.zeros(n_chunks * chunk, device=cuda)
    if metric == "Cosine":
        tbl = torch.nn.functional.normalize(tbl, dim=1)
    elif metric == "L2":
        bias -= (tbl * tbl).sum(1)
        tbl *= 2.0
    bias[torch.randperm(n_chunks * chunk, generator=g, device=cuda)[:500]] = \
        float("-inf")
    q = torch.zeros((300, d_pad), device=cuda)
    q[:, :100] = torch.randn((300, 100), generator=g, device=cuda)
    before = (ek.sweep_topk.launches, ek.sweep_topk.f32_launches,
              ek.sweep_topk.two_step)
    got = ek._sweep(tbl.view(n_chunks, chunk, d_pad),
                    bias.view(n_chunks, chunk), q, 10, "f32", metric=metric)
    assert (ek.sweep_topk.launches, ek.sweep_topk.f32_launches,
            ek.sweep_topk.two_step) == (before[0] + 1, before[1] + 1,
                                        before[2])
    bufs = ek._chunk_buffers(300, n_chunks, 10, torch.float32, cuda)
    ek.sweep_two_step(q, tbl, chunk, 10, bias, None, None, 0, bufs)
    bs, bi = ek.merge_chunks(*bufs, 10)
    want = torch.cat([bi.to(torch.int32), bs.view(torch.int32)], dim=1)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_sweep_topk_f32_raises_where_it_cannot_launch(cuda):
    """No fallback: queries 4 bytes off a 16-byte boundary (contiguous, so
    the wrapper's checks pass) make the kernel's entry refuse, and the
    wrapper raises; nothing is counted."""
    q, tbl, kw = sweep_inputs("f32", 4, 256, 1, 64, "random", 2, cuda)
    off = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    off.copy_(q)
    before = (ek.sweep_topk.launches, ek.sweep_topk.f32_launches)
    with pytest.raises(RuntimeError):
        ek.sweep_topk(off, tbl, 256, 10, **kw)
    assert (ek.sweep_topk.launches, ek.sweep_topk.f32_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [1, 32, 33, 64, 65, 128, 129, 256])
def test_sweep_topk_f32_block_shape_and_slots(cuda, kc):
    """The f32 kernel's query rows a block (64 for every row state), no
    clusters, and the blocks the card holds at once: one an SM for every
    row state and width (its shared memory holds the ring, the staged
    tiles and the heads past half of the SM's); `sweep_piece` cuts pieces
    that divide the lane's table and fill the slots."""
    lib = ek._sweep_f32_lib()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for d_pad in (16, 128, 256, 768, 1024, 1536, 4096):
        assert lib.cozo_sweep_topk_rows(ek.SWEEP_F32, d_pad, kc) == 64
        assert lib.cozo_sweep_topk_cluster(ek.SWEEP_F32, d_pad, kc) == 1
        slots = lib.cozo_sweep_topk_slots(ek.SWEEP_F32, d_pad, kc)
        assert slots == sms, (d_pad, kc, slots)
    n_total = 10 * 131_072
    piece = ek.sweep_piece(n_total, 131_072, 16_384, 128, kc, ek.SWEEP_F32,
                           cuda)
    assert piece % ek.SWEEP_PIECE == 0 and n_total % piece == 0


@pytest.mark.cuda
def test_sweep_topk_refuses_tensors_off_the_card(cuda):
    q, tbl, kw = sweep_inputs("bf16", 4, 256, 1, 64, "random", 2, cuda)
    with pytest.raises(ValueError):
        ek.sweep_topk(q, tbl, 256, 10, bias=kw["bias"].cpu())
