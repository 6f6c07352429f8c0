"""Tests of the port that need an NVIDIA card (marker `cuda`): each CUDA
kernel (`fused_sweep`, `beam_search`, the three graph kernels, `minhash`)
against its plain PyTorch version, the graph rules' entry points and a
MinHash-LSH Db on the card against the same calls on the CPU, the
MinHash dispatch's own pinned buffers,
the lanes end to end through the kernels, the staging buffers of a
small-batch search and its lock under concurrent callers, and the card's
int8 product
against the CPU's.  They skip where CUDA is absent.  This file imports
neither JAX nor `cozo_tpu`, so it runs on a machine that has only the
port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import (BEAM_CASES, GRAPH_LP_LABELS, GRAPH_LP_WIDTHS,
                        GRAPH_PR_CASES, GRAPH_SSSP_CASES, MINHASH_CASES,
                        PR_L1_TOL, SSSP_FORCED_SHARES, graph_csr,
                        lp_inputs, minhash_inputs, minhash_tensors,
                        pagerank_agreement, pr_inputs, sssp_inputs)
from chip_smoke import PHASE2_SHAPES as SHAPES
from chip_smoke import (agreement_ok, beam_args, beam_case, beam_ok,
                        compare_beam, compare_fused, random_case)
from cozo_tpu_torch import HnswIndex, sweep_search
from cozo_tpu_torch.ops import _build
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
