"""The graph fixed rules' device half (`cozo_tpu_torch/ops/graph_algos.py`)
against the JAX package's (`cozo_tpu/ops/graph_algos.py`, on the CPU), on
the same numpy inputs made from a seed.  The port runs with
`device="cpu"`, so each kernel's plain PyTorch version.

Tolerances:
  - SSSP (every route): distances and parents EQUAL.  Both take f32
    candidates `dist[src] + w` and exact minima and maxima, in
    synchronous steps;
  - LabelPropagation (every route): labels EQUAL.  Weights are unit or
    k/8 (dyadic), so every weighted sum is exact in any order;
  - PageRank: the JAX device path sums each node's in-edges as the
    difference of an f32 two-level prefix sum, whose last addition rounds
    to the ulp of the running total (up to 1): about 1e-8 a node, an L1
    distance from the exact ranks that grows with n.  The port sums
    directly (the plain version through an f64 prefix sum).  So the port
    is held to the exact f64 ranks (`pagerank_numpy` without its epsilon
    stop) within L1 1e-5, and to JAX within JAX's own distance from them
    plus 1e-5.
"""

import pathlib

import numpy as np
import pytest
import torch

import cozo_tpu.ops.graph_algos as J
import cozo_tpu_torch.ops.graph_algos as T

CPU = "cpu"


def csr(n, e, seed, hub=0, hub_node=3, dangling=0):
    """n nodes, e random edges (sources from `dangling` up: the nodes below
    have no out-edge), `hub` more into `hub_node`."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(dangling, n, e),
                          rng.integers(dangling, n, hub)])
    dst = np.concatenate([rng.integers(0, n, e),
                          np.full(hub, hub_node)])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    return np.cumsum(indptr), dst


def dyadic(e, seed, low=1):
    return (np.random.default_rng(seed).integers(low, 24, e)
            .astype(np.float32) / 8)


@pytest.fixture(autouse=True)
def no_disk_cache(monkeypatch):
    monkeypatch.setenv("COZO_TPU_GRAPH_CACHE", "")


# ---------------------------------------------------------------- PageRank


@pytest.mark.parametrize("n,e,dangling,iterations", [
    (3000, 40_000, 300, 10),   # e_pad pads 40,000 to 40,960
    (700, 9000, 0, 20),
    (5000, 131_000, 1000, 10),  # pow2(e)/16 granularity
])
def test_pagerank_against_jax(n, e, dangling, iterations):
    ip, d = csr(n, e, n, dangling=dangling)
    got = T.pagerank_jax(ip, d, iterations=iterations, device=CPU)
    jax = J.pagerank_jax(ip, d, iterations=iterations)
    exact = T.pagerank_numpy(ip, d, epsilon=-1.0, iterations=iterations)
    assert got.dtype == np.float64 and got.shape == (n,)
    assert np.abs(got - exact).sum() <= 1e-5
    jax_err = np.abs(jax - exact).sum()
    assert np.abs(got - jax).sum() <= jax_err + 1e-5
    top = np.argsort(-exact)[:100]
    assert set(np.argsort(-got)[:100]) == set(top)
    assert abs(got.sum() - 1.0) < 1e-5


def test_pagerank_runs_exactly_its_steps():
    """No epsilon stop on the device path: 1 step differs from 30."""
    ip, d = csr(500, 6000, 1)
    one = T.pagerank(ip, d, iterations=1, use_tpu=True, device=CPU)
    many = T.pagerank(ip, d, epsilon=1.0, iterations=30, use_tpu=True,
                      device=CPU)
    assert np.abs(one - many).sum() > 1e-4
    host = T.pagerank(ip, d, epsilon=1.0, iterations=30, use_tpu=False)
    # the host stops after step 1: the same ranks, in f64 against f32
    assert np.abs(host - one).sum() < 1e-6


# -------------------------------------------------------------------- SSSP

SSSP_CASES = [
    # (n, e, hub in-degree, weights, sources, max_iters)
    (2000, 20_000, 0, "dyadic", [0, 5, 17], 512),
    (2000, 20_000, 2500, "random", [0, 3], 512),   # a hub past ELL_CAP_MAX
    (2000, 20_000, 2500, "uniform", [0], 512),     # the uniform scalar
    (2000, 20_000, 0, "random", [1, 2, 3, 4], 3),  # cut before convergence
    (3000, 2500, 0, "dyadic", [7], 512),           # most nodes unreached
]


def weights(kind, e, seed):
    if kind == "uniform":
        return np.full(e, 2.0, np.float32)
    if kind == "dyadic":
        return dyadic(e, seed)
    return np.random.default_rng(seed).uniform(0.1, 4.0, e).astype(np.float32)


def assert_sssp_equal(got, want):
    assert got[0].dtype == np.float64 and got[1].dtype == np.int64
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("case", SSSP_CASES,
                         ids=["dyadic", "hub", "uniform-hub", "cut", "sparse"])
def test_sssp_ell_against_jax(case):
    n, e, hub, kind, sources, max_iters = case
    ip, d = csr(n, e, n + hub, hub=hub)
    w = weights(kind, len(d), hub + 1)
    got = T.sssp_device(ip, d, w, sources, max_iters=max_iters, device=CPU)
    assert_sssp_equal(got, J.sssp_device(ip, d, w, sources,
                                         max_iters=max_iters))
    if hub:
        g = T._sssp_ell_stage(ip, d, w, None, torch.device(CPU), False)
        assert len(g.l2_desc) > 1 and (g.flat_w is None) == (kind == "uniform")
    assert (got[1][np.arange(len(sources)), sources] == -1).all()


@pytest.mark.parametrize("env", [{"COZO_TPU_SSSP_IMPL": "scatter"},
                                 {"COZO_TPU_SSSP_SCAN": "1"}],
                         ids=["scatter", "scan"])
@pytest.mark.parametrize("case", [SSSP_CASES[1], SSSP_CASES[3]],
                         ids=["hub", "cut"])
def test_sssp_alternates_against_jax(monkeypatch, env, case):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    n, e, hub, kind, sources, max_iters = case
    ip, d = csr(n, e, n + hub, hub=hub)
    w = weights(kind, len(d), hub + 1)
    got = T.sssp_device(ip, d, w, sources, max_iters=max_iters, device=CPU)
    assert_sssp_equal(got, J.sssp_device(ip, d, w, sources,
                                         max_iters=max_iters))


# -------------------------------------------------------- label propagation

def hub_graph(weighted, hub=300, seed=4):
    ip, d = csr(2000, 16_000, seed, hub=hub)
    w = dyadic(len(d), seed, low=-4) if weighted else None  # <= 0 clamped
    return ip, d, w


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("route", ["dense", "capped", "hybrid",
                                   "hybrid-host-hubs", "sort"])
def test_labelprop_against_jax(monkeypatch, weighted, route):
    """Each route of the dispatch: dense (max in-degree <= 128), capped
    dense (`degree_cap`), the hybrid lanes with and without host hubs
    (COZO_TPU_LP_TIER_MAX lowered), the sort path."""
    ip, d, w = hub_graph(weighted, hub=0 if route == "dense" else 300)
    cap = None
    if route == "capped":
        cap = 64
    elif route == "hybrid-host-hubs":
        monkeypatch.setenv("COZO_TPU_LP_TIER_MAX", "64")
    elif route == "sort":
        monkeypatch.setenv("COZO_TPU_LP_IMPL", "sort")
    got = T.labelprop_jax(ip, d, w=w, iterations=6, degree_cap=cap,
                          device=CPU)
    want = J.labelprop_jax(ip, d, w=w, iterations=6, degree_cap=cap)
    assert got.shape == (len(ip) - 1,)
    assert np.array_equal(got, want)


def test_labelprop_lanes_and_host_hubs_are_staged(monkeypatch):
    monkeypatch.setenv("COZO_TPU_LP_TIER_MAX", "64")
    ip, d, _ = hub_graph(False)
    ck = T.graph_content_key(ip, d)
    T.labelprop_jax(ip, d, iterations=2, cache_key=ck, device=CPU)
    shapes, lanes, hubs = T._GRAPH_DEV_CACHE[("lph2", "cpu", (ck, "unw"))][:3]
    widths = [W for _, W, _ in shapes]
    assert widths == sorted(widths) and widths[0] == 8 and widths[-1] <= 64
    assert list(hubs) == [3]  # the hub takes the host lane


# ------------------------------------------------ caches (port twins of
# tests/test_graph_cache_keys.py)


def tiny_graph():
    # 0 -> 1 -> 2, 0 -> 2 (direct edge): shortest path 0->2 depends on w
    return np.array([0, 2, 3, 3], np.int64), np.array([1, 2, 2], np.int64)


def test_sssp_restage_on_weight_change():
    indptr, dst = tiny_graph()
    ck = T.graph_content_key(indptr, dst)
    d1, _ = T.sssp_device(indptr, dst, np.ones(3, np.float32), [0],
                          cache_key=ck, device=CPU)
    assert d1[0, 2] == 1.0
    d2, _ = T.sssp_device(indptr, dst, np.array([0.5, 10.0, 0.5], np.float32),
                          [0], cache_key=ck, device=CPU)
    assert d2[0, 2] == 1.0 and d2[0, 1] == 0.5
    # uniform but different scalars must not share an image either
    d3, _ = T.sssp_device(indptr, dst, np.full(3, 2.0, np.float32), [0],
                          cache_key=ck, device=CPU)
    assert d3[0, 2] == 2.0


def test_labelprop_restage_on_weight_change():
    indptr = np.array([0, 2, 4, 6, 9, 11, 13], dtype=np.int64)
    dst = np.array([1, 2, 0, 2, 0, 1, 2, 4, 5, 3, 5, 3, 4], dtype=np.int64)
    ck = T.graph_content_key(indptr, dst)
    w_hi = np.ones(len(dst), dtype=np.float32)
    w_hi[6] = 100.0
    w_lo = np.ones(len(dst), dtype=np.float32)
    w_lo[6] = 0.01
    l1 = T.labelprop_jax(indptr, dst, w=w_hi, iterations=4, cache_key=ck,
                         device=CPU)
    l2 = T.labelprop_jax(indptr, dst, w=w_lo, iterations=4, cache_key=ck,
                         device=CPU)
    assert not np.array_equal(l1, l2)
    assert np.array_equal(l2, J.labelprop_jax(indptr, dst, w=w_lo,
                                              iterations=4, cache_key=ck))


def test_sssp_disk_image_roundtrip(tmp_path, monkeypatch):
    """The port writes its packed image as `sssp1t_*` (never the JAX
    package's `sssp1_*`), loads it back with the in-memory caches empty,
    and answers alike; weighted images are keyed apart."""
    monkeypatch.setenv("COZO_TPU_GRAPH_CACHE", str(tmp_path))
    ip, d = csr(200, 1200, 3)
    ck = T.graph_content_key(ip, d)
    w = np.ones(len(d), dtype=np.float32)
    d1, p1 = T.sssp_device(ip, d, w, [0, 7], cache_key=ck, device=CPU)
    names = [f.name for f in tmp_path.iterdir()]
    assert names and all(f.startswith("sssp1t_") for f in names), names
    T._GRAPH_DEV_CACHE.clear()
    T._HOST_STAGE_CACHE.clear()
    loads = []
    real = np.load
    monkeypatch.setattr(np, "load", lambda *a, **k: loads.append(a[0])
                        or real(*a, **k))
    d2, p2 = T.sssp_device(ip, d, w, [0, 7], cache_key=ck, device=CPU)
    assert len(loads) == 1
    assert np.array_equal(d1, d2) and np.array_equal(p1, p2)
    w2 = np.random.default_rng(3).uniform(0.5, 2.0, len(d)).astype(np.float32)
    d3, _ = T.sssp_device(ip, d, w2, [0], cache_key=ck, device=CPU)
    T._GRAPH_DEV_CACHE.clear()
    d4, _ = T.sssp_device(ip, d, w2, [0], cache_key=ck, device=CPU)
    assert np.array_equal(d3, d4) and not np.allclose(d1[0], d3[0])
    assert len(list(tmp_path.iterdir())) == 2
    assert np.array_equal(d3, J.sssp_device(ip, d, w2, [0])[0])


def test_disk_images_of_the_two_packages_never_mix(tmp_path, monkeypatch):
    """A JAX image and a port image of one graph live side by side under
    their own prefixes; each package reads only its own."""
    monkeypatch.setenv("COZO_TPU_GRAPH_CACHE", str(tmp_path))
    ip, d = csr(300, 2000, 5)
    ck = T.graph_content_key(ip, d)
    assert ck == J.graph_content_key(ip, d)
    w = np.ones(len(d), dtype=np.float32)
    J.sssp_device(ip, d, w, [0], cache_key=ck)
    T.sssp_device(ip, d, w, [0], cache_key=ck, device=CPU)
    names = sorted(f.name for f in tmp_path.iterdir())
    assert len(names) == 2
    assert names[0].startswith("sssp1_") and names[1].startswith("sssp1t_")


def test_sssp_reuses_the_pagerank_source_array(capsys, monkeypatch):
    """PageRank publishes its destination-sorted sources under a "srcdev"
    key; a following SSSP over the same graph (~140K edges, where both
    paddings are pow2(e)/16) packs from that alias and stays exact."""
    rng = np.random.default_rng(7)
    n, deg = 2000, 70
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = rng.integers(0, n, len(src))
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.uniform(0.5, 4.0, len(src)).astype(np.float32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    ck = T.graph_content_key(indptr, dst)
    T.pagerank_jax(indptr, dst, iterations=3, cache_key=ck, device=CPU)
    monkeypatch.setenv("COZO_TPU_SSSP_LOG", "1")
    got = T.sssp_device(indptr, dst, w, [0], cache_key=ck, device=CPU)
    out = capsys.readouterr().out
    assert "src=dev-alias" in out, out
    assert_sssp_equal(got, J.sssp_device(indptr, dst, w, [0]))


@pytest.mark.parametrize("bin_nodes,hub", [(64, 0), (256, 300),
                                            (T.PR_BIN_NODES, 0)])
def test_pagerank_bins_are_the_destination_segments_by_source(bin_nodes,
                                                              hub):
    """Each bin holds the destination-major segments of its nodes: the
    same (source, destination) multiset, in ascending source order, every
    offset below the bin size, no padding edge; the bounds are the in-CSR
    bounds at the bins' first nodes."""
    n, e = 1500, 20_000
    ip, d = csr(n, e, bin_nodes, hub=hub, dangling=100)
    src_by_dst, in_ptr, _, *empty = T._pagerank_stage(ip, d, None,
                                                       torch.device(CPU))
    assert all(t.numel() == 0 for t in empty)  # never built on the CPU
    bin_src, bin_off, bin_ptr = T._pagerank_bins(src_by_dst, in_ptr, n,
                                                 bin_nodes)
    n_bins = -(-n // bin_nodes)
    assert bin_src.dtype == torch.int32 and bin_off.dtype == torch.int16
    assert bin_ptr.dtype == torch.int32 and len(bin_ptr) == n_bins + 1
    e_real = e + hub
    assert len(bin_src) == len(bin_off) == e_real == int(bin_ptr[-1])
    assert not bool((bin_src == len(in_ptr) - 2).any())  # the dummy slot
    assert int(bin_off.min()) >= 0 and int(bin_off.max()) < bin_nodes
    src_by_dst, in_ptr = src_by_dst.numpy(), in_ptr.numpy()
    for b in range(n_bins):
        lo, hi = b * bin_nodes, min(n, (b + 1) * bin_nodes)
        assert bin_ptr[b] == in_ptr[lo] and bin_ptr[b + 1] == in_ptr[hi]
        seg = slice(int(bin_ptr[b]), int(bin_ptr[b + 1]))
        got_src = bin_src[seg].numpy()
        assert np.all(np.diff(got_src) >= 0)
        got = sorted(zip(got_src, lo + bin_off[seg].numpy().astype(int)))
        want = sorted(
            (int(src_by_dst[j]), v) for v in range(lo, hi)
            for j in range(in_ptr[v], in_ptr[v + 1]))
        assert got == want


def test_pagerank_bin_size_matches_the_kernel_source():
    """The layout's bin size is the kernel's (`COZO_PR_BIN_NODES`), which
    refuses bins of any other."""
    src = (pathlib.Path(T.__file__).parent.parent / "csrc"
           / "graph_pagerank.cu").read_text()
    assert f"#define COZO_PR_BIN_NODES {T.PR_BIN_NODES}" in src
    assert T.PR_BIN_NODES * 8 <= 227 * 1024  # a block's shared memory


def test_pagerank_bins_are_cached_with_the_graph(monkeypatch):
    """The layout is built once per graph, kept in the staged tuple under
    the graph's key, and never rebuilt by a second call."""
    ip, d = csr(900, 9000, 3)
    ck = T.graph_content_key(ip, d)
    T._GRAPH_DEV_CACHE.clear()
    built = []
    real = T._pagerank_bins

    def counted(*a, **kw):
        built.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(T, "_pagerank_bins", counted)
    cpu = torch.device(CPU)
    first = T._pagerank_stage(ip, d, ck, cpu, bins=True)
    again = T._pagerank_stage(ip, d, ck, cpu, bins=True)
    assert len(built) == 1 and again is first
    assert T._GRAPH_DEV_CACHE[("pr", CPU, ck)] is first
    assert len(first) == 6 and len(first[3]) == 9000
    T.pagerank_jax(ip, d, iterations=3, cache_key=ck, device=CPU)
    assert len(built) == 1


def test_sssp_after_pagerank_with_bins_equals_sssp_alone(capsys,
                                                         monkeypatch):
    """The staged tuple grew by the layout beside the source array: SSSP
    after PageRank still packs from that array (the alias) and answers as
    SSSP alone does."""
    rng = np.random.default_rng(11)
    n, deg = 2000, 70
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = rng.integers(0, n, len(src))
    w = rng.uniform(0.5, 4.0, len(src)).astype(np.float32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    ck = T.graph_content_key(indptr, dst)
    T._GRAPH_DEV_CACHE.clear()
    alone = T.sssp_device(indptr, dst, w, [0, 5], cache_key=ck, device=CPU)
    T._GRAPH_DEV_CACHE.clear()
    staged = T._pagerank_stage(indptr, dst, ck, torch.device(CPU), bins=True)
    assert len(staged[3]) == len(dst)
    monkeypatch.setenv("COZO_TPU_SSSP_LOG", "1")
    after = T.sssp_device(indptr, dst, w, [0, 5], cache_key=ck, device=CPU)
    assert "src=dev-alias" in capsys.readouterr().out
    assert_sssp_equal(after, alone)


def test_device_cache_keys_never_collide_across_devices():
    """Every staged entry is keyed by its device: a CPU Db's tensors are
    never handed to a card Db in the same process, nor the other way."""
    ip, d = csr(800, 60_000, 2, hub=200)
    ck = T.graph_content_key(ip, d)
    w = np.ones(len(d), np.float32)
    T._GRAPH_DEV_CACHE.clear()
    T.pagerank_jax(ip, d, cache_key=ck, device=CPU)
    T.sssp_device(ip, d, w, [0], cache_key=ck, device=CPU)
    T.labelprop_jax(ip, d, iterations=2, cache_key=ck, device=CPU)
    keys = list(T._GRAPH_DEV_CACHE)
    assert keys and all(k[1] == "cpu" for k in keys)
    # a card-keyed entry of the same graph is another key: a CPU lookup
    # never returns it
    fake = ("pr", "cuda", ck)
    T._GRAPH_DEV_CACHE[fake] = "card tensors"
    assert fake not in keys
    staged = T._pagerank_stage(ip, d, ck, torch.device(CPU))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in staged)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ip, d = csr(100, 600, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.pagerank_jax(ip, d)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.sssp_device(ip, d, np.ones(len(d), np.float32), [0])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.labelprop_jax(ip, d)


def test_wrappers_take_plain_versions_only_for_cpu_tensors():
    """A tensor that is not on the CPU never reaches a plain version: the
    wrappers launch their kernel or raise (here: tensors on the `meta`
    device, refused before any launch)."""
    ip, d = csr(100, 600, 1)
    cpu = torch.device(CPU)
    meta = [t.to("meta") for t in T._pagerank_stage(ip, d, None, cpu)]
    with pytest.raises(ValueError, match="on the card"):
        T.pagerank_steps(*meta, 100, 3, 0.85)
    g = T._sssp_ell_stage(ip, d, np.ones(len(d), np.float32), None, cpu,
                          False)
    g = g._replace(flat_src=g.flat_src.to("meta"))
    with pytest.raises(ValueError, match="on the card"):
        T.sssp_ell(g, [0], 8)
    labels = torch.arange(8, dtype=torch.int32, device="meta")
    nb = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="on the card"):
        T.lp_pick(labels, nb, None, None, torch.ones(2, dtype=torch.bool),
                  5, labels.clone())
