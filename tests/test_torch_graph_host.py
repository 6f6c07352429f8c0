"""The CUDA sources of the graph kernels (`cozo_tpu_torch/csrc/
graph_pagerank.cu`, `graph_sssp.cu`, `graph_labelprop.cu`), run on the
CPU and held against their plain PyTorch versions.

As `tests/test_torch_beam_host.py` does for the beam search: each source
is compiled with g++ against that file's stand-in `cuda_runtime.h` (one
`std::thread` per CUDA thread, blocks one after another, barriers for
`__syncthreads` and `__syncwarp`, shuffles through a per-warp scratch
array), at 64 threads a block (every kernel strides by its block-size
constant), and its C entry point is called with CPU tensors through the
module's own launch helpers, at the shapes of `chip_smoke.py` phase 2.
The PageRank grid is cut to 8 blocks and its bins to 64 nodes (and 256,
a second build), so warps stride over many nodes and every slice of the
edge pass crosses bins, as they do on the card at full size.

Tolerances: SSSP distances and parents and the label picks must be EQUAL
(minima, maxima and integer or dyadic sums are exact in any order);
PageRank ranks within an L1 distance of 1e-5 of the plain version (the
kernel rounds each node's exact fixed-point sum to f32, the plain version
takes it from an f64 prefix sum), two runs and two bin sizes
bit-identical (integer adds, no float atomics).  What this cannot
show: that nvcc takes the sources, races only real warps hit, any time.
Skips where there is no g++.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import (GRAPH_LP_LABELS, GRAPH_LP_WIDTHS, GRAPH_PR_CASES,
                        GRAPH_SSSP_CASES, PR_L1_TOL, SSSP_FORCED_SHARES,
                        lp_inputs, pagerank_agreement, pr_inputs, sssp_inputs)
from cozo_tpu_torch.ops import _build
from cozo_tpu_torch.ops import graph_algos as ga
from tests.test_torch_beam_host import SHIM
from tests.test_torch_fused_routes import _extern_c_functions

THREADS = 64
_PR_FLAGS = [f"-DCOZO_PR_THREADS={THREADS}", f"-DCOZO_PR_BIN_THREADS={THREADS}",
             "-DCOZO_PR_MAX_BLOCKS=8"]
# library name: (source, binder, flags)
KERNELS = {
    "graph_pagerank": ("graph_pagerank", ga._bind_pagerank,
                       [*_PR_FLAGS, "-DCOZO_PR_BIN_NODES=64"]),
    "graph_pagerank_256": ("graph_pagerank", ga._bind_pagerank,
                           [*_PR_FLAGS, "-DCOZO_PR_BIN_NODES=256"]),
    "graph_sssp": ("graph_sssp", ga._bind_sssp,
                   [f"-DCOZO_SSSP_THREADS={THREADS}",
                    "-DCOZO_SSSP_MAX_BLOCKS=2"]),
    "graph_labelprop": ("graph_labelprop", ga._bind_lp,
                        [f"-DCOZO_LP_THREADS={THREADS}"]),
}


def to_host_cpp(src: str) -> str:
    """The .cu with its CUDA syntax rewritten: dynamic shared memory and
    the `<<<...>>>` launches."""
    src = re.sub(
        r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
        r"unsigned char* \1 = SHIM_SMEM;", src)
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\(", r"SHIM_LAUNCH(\1, \2)(", src,
                     flags=re.S)
    assert n >= 1
    return src


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel sources for the host")
    work = tmp_path_factory.mktemp("graph_host")
    (work / "cuda_runtime.h").write_text(SHIM)
    procs = {}
    for name, (source, _, flags) in KERNELS.items():
        with open(f"{_build.CSRC}/{source}.cu") as f:
            (work / f"{name}.cpp").write_text(to_host_cpp(f.read()))
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", *flags,
             f"-I{work}", "-o", str(work / f"{name}.so"),
             str(work / f"{name}.cpp")],
            stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0 and "barrier" in err and "No such file" in err:
            pytest.skip("needs a g++ with C++20 <barrier>")
        assert proc.returncode == 0, err[-3000:]
        out[name] = KERNELS[name][1](ctypes.CDLL(str(work / f"{name}.so")))
    return out


def pr_case_id(case):
    n, e, steps, dangling, hub = case
    return f"{n}-{e}-{steps}-{dangling}" + (f"-hub{hub}" if hub else "")


def host_pagerank(lib, staged, n, steps):
    """The kernel's launcher over the layout built at the library's bin
    size (the CPU stage leaves it empty)."""
    bins = ga._pagerank_bins(staged[0], staged[1], n,
                             lib.cozo_pagerank_bin_nodes())
    return ga._pagerank_launch(lib, *staged[:3], *bins, n, steps, 0.85, None)


# the last case of each kernel (20,000 nodes) is the card's alone: a
# thread a CUDA thread makes it minutes here
@pytest.mark.parametrize("case", GRAPH_PR_CASES[:-1], ids=pr_case_id)
def test_pagerank_source_on_the_host(libs, case):
    """Dangling nodes, isolated nodes, padding edges, 0 steps, nodes
    without in-edges, one node not dangling, a hub: bins of 64 nodes over
    8 blocks, so most cases span many bins and slices cross them."""
    n, e, steps, dangling, hub = case
    staged = pr_inputs(n, e, dangling, torch.device("cpu"), hub)
    want = ga.pagerank_plain(*staged, n, steps, 0.85)
    got = host_pagerank(libs["graph_pagerank"], staged, n, steps)
    again = host_pagerank(libs["graph_pagerank"], staged, n, steps)
    assert torch.equal(got, again)
    l1, top = pagerank_agreement(got, want, n)
    assert l1 <= PR_L1_TOL and top
    assert not bool(got[n:].any())
    if steps == 0:
        assert torch.equal(got[:n], torch.full((n,), np.float32(1) / n))


@pytest.mark.parametrize("case", GRAPH_PR_CASES[:-1], ids=pr_case_id)
def test_pagerank_bin_sizes_give_the_same_bits_on_the_host(libs, case):
    """Bins of 64 and of 256 nodes: other bins, other slices, other
    orders of the adds; the fixed-point sums are exact, so the same
    ranks."""
    n, e, steps, dangling, hub = case
    staged = pr_inputs(n, e, dangling, torch.device("cpu"), hub)
    small = host_pagerank(libs["graph_pagerank"], staged, n, steps)
    large = host_pagerank(libs["graph_pagerank_256"], staged, n, steps)
    assert torch.equal(small, large)


SSSP_IDS = ["dyadic", "uniform-hub-8src", "hub", "cut", "sparse", "9src",
            "negative-8src", "cut1", "negative-cut3"]


def check_sssp_source(lib, case, share):
    """One GRAPH_SSSP_CASES entry through the kernel's launcher at a route
    share: equal to the plain version, step 0's frontier the distinct
    sources, a converged solve's last frontier empty, two runs equal."""
    g, sources, max_iters = sssp_inputs(case, torch.device("cpu"))
    assert (g.flat_w is None) == (case[3] == "uniform")
    if case[2] > ga.ELL_CAP_MAX:
        assert len(g.l2_desc) > 1  # the hub's rows meet at level 2
    want = ga.sssp_ell_plain(g, sources, max_iters)
    got = ga._sssp_launch(lib, g, sources, max_iters, None, share)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[3] == -(-min(want[2], max_iters) // ga.SSSP_CHECK_EVERY) + 1
    if max_iters < 10:
        assert got[2] == max_iters and not torch.equal(
            got[0], ga.sssp_ell_plain(g, sources, 512)[0])
    else:  # the last step changed nothing: its frontier is empty
        assert got[2] < max_iters and not bool(got[4][0][got[2]].any())
    groups = [sources] if len(sources) == 1 else [
        sources[i:i + ga.SSSP_GROUP]
        for i in range(0, len(sources), ga.SSSP_GROUP)]
    assert got[4][0][0].tolist() == [len(set(x)) for x in groups]
    n = case[0]
    isolated = got[0][:, n - 3:n]  # unreached unless a source
    assert torch.isinf(isolated[isolated != 0]).all()
    again = ga._sssp_launch(lib, g, sources, max_iters, None, share)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("case", GRAPH_SSSP_CASES[:-1], ids=SSSP_IDS)
def test_sssp_source_on_the_host(libs, case):
    """The wrapper's route share (`SSSP_PUSH_SHARE`)."""
    check_sssp_source(libs["graph_sssp"], case, ga.SSSP_PUSH_SHARE)


@pytest.mark.parametrize("route", SSSP_FORCED_SHARES)
@pytest.mark.parametrize("case", GRAPH_SSSP_CASES[:-1], ids=SSSP_IDS)
def test_sssp_forced_routes_on_the_host(libs, case, route):
    """Every step pushed, every step pulled: the same bits."""
    check_sssp_source(libs["graph_sssp"], case, SSSP_FORCED_SHARES[route])


def test_sssp_negative_weights_are_exercised():
    """The negative-weight cases reach nodes at negative distances."""
    for case in GRAPH_SSSP_CASES:
        if case[3] == "negative":
            g, sources, max_iters = sssp_inputs(case, torch.device("cpu"))
            dist = ga.sssp_ell_plain(g, sources, max_iters)[0]
            assert bool((dist < 0).any())


def check_lp_source(lib, W, weighted, kind):
    H = 256 if W <= 32 else (64 if W <= 256 else 4)
    labels, nb, w, idx, has_in, n_real = lp_inputs(H, W, weighted, W,
                                                   torch.device("cpu"), kind)
    want = labels.clone()
    ga.lp_pick_plain(labels, nb, w, idx, has_in, n_real, want)
    got = labels.clone()
    ga._lp_launch(lib, labels, nb, w, idx, has_in, n_real, got, None)
    assert torch.equal(got, want)
    assert not torch.equal(got, labels)
    node = 2 if idx is None else int(idx[2])
    assert int(got[node]) == 65  # the planted tie: the smaller label
    again = labels.clone()
    ga._lp_launch(lib, labels, nb, w, idx, has_in, n_real, again, None)
    assert torch.equal(again, got)


@pytest.mark.parametrize("W", GRAPH_LP_WIDTHS)
@pytest.mark.parametrize("weighted", [False, True])
def test_lp_pick_source_on_the_host(libs, W, weighted):
    check_lp_source(libs["graph_labelprop"], W, weighted, "mixed")


@pytest.mark.parametrize("W", GRAPH_LP_WIDTHS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", GRAPH_LP_LABELS[1:])
def test_lp_pick_label_mixes_on_the_host(libs, W, weighted, kind):
    """All labels distinct, three, one."""
    check_lp_source(libs["graph_labelprop"], W, weighted, kind)


def test_lp_cases_reach_every_rule():
    """The pick's inputs hold rows without a valid slot (all padding, all
    weights 0), dense rows without in-edges, and rows that tie."""
    for W in (16, 64, 256):
        labels, nb, w, idx, has_in, n_real = lp_inputs(
            256, W, True, W, torch.device("cpu"))
        assert bool((nb[0] == labels.shape[0] - 1).all())
        assert not bool((w[1] > 0).any())
        if idx is None:
            assert not bool(has_in.all())


def test_lp_launcher_refuses_bad_widths(libs):
    lib = libs["graph_labelprop"]
    labels = torch.arange(64, dtype=torch.int32)
    nb = torch.zeros((2, ga.LP_MAX_W * 2), dtype=torch.int32)
    err = lib.cozo_lp_pick(nb.data_ptr(), None, None, None, 2,
                           ga.LP_MAX_W * 2, 60, 63, labels.data_ptr(),
                           labels.clone().data_ptr(), None)
    assert err != 0


@pytest.mark.parametrize("fn,types", [
    ("cozo_pagerank", ga._PR_ARGTYPES),
    ("cozo_sssp_relax", ga._SSSP_RELAX_ARGTYPES),
    ("cozo_sssp_parent", ga._SSSP_PARENT_ARGTYPES),
    ("cozo_lp_pick", ga._LP_ARGTYPES),
])
def test_c_interfaces_match_the_wrappers(fn, types):
    """Each argtypes list follows the C signature in its source."""
    assert _extern_c_functions()[fn] == types
