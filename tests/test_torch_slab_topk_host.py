"""The CUDA source of the per-chunk selection (`cozo_tpu_torch/csrc/
slab_topk.cu`), run on the CPU and held against `select_topk_plain`.

As `tests/test_torch_minhash_host.py` does for its kernel: the source is
compiled with g++ against `tests/test_torch_beam_host.py`'s stand-in
`cuda_runtime.h` (one `std::thread` per CUDA thread, blocks one after
another, barriers, shuffles, ballots and atomics), with the few CUDA
names this kernel adds beside it (`__ffs`, `__any_sync`, the
round-to-nearest conversions and arithmetic, a stand-in `cuda_bf16.h`),
and its C entry point is called with CPU tensors through the module's
own launch helper (`exact_knn._topk_run`).  Three builds:

* one warp a block with 256-entry buffers: one warp a row, kf up to 128
  on the warp route (a compaction every 128 - kf appends past the
  seed), kf 256 on the radix route in shared memory, 512 or the full
  width in the scratch the helper allocates;
* two warps with the card's buffers (2,048 entries for the radix route,
  512 a warp): kf up to 256 on the warp route, two warps sharing a row of
  4,097 when the launch has few rows, two rows a block on narrow rows;
* two warps with 256-entry warp buffers: the same with the compaction
  many times a row.

The cases are `chip_smoke.py` phase 2's at its two smallest widths (512
and 4,097, every kf from 1 to W, B = 1 and 17, every variant with every
kind: planted ties, +-0.0, a row all -inf, a row with fewer live entries
than kf, a bf16 key slab from int8 products), every variant with the
order kinds (ascending and descending keys, the best in the last
columns) at both widths (ascending keys past the seed's columns re-seed
the threshold), the merges' widths 260 and 970, and a ragged block of
launches.

Tolerance: none.  Values and ids must be bit-equal to the plain version,
and two runs bit-identical.  What this cannot show: that nvcc takes the
source, races that only real warps hit, any time.  Skips where there is no
g++.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from chip_smoke import topk_cases, topk_inputs, topk_same
from cozo_tpu_torch.ops import _build
from cozo_tpu_torch.ops import exact_knn as ek
from tests.test_torch_beam_host import SHIM
from tests.test_torch_graph_host import to_host_cpp

# the CUDA names slab_topk.cu uses beyond the beam test's stand-in
EXTRA = r'''
inline int __ffs(int x) { return __builtin_ffs(x); }
inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
inline float __int2float_rn(int x) { return (float)x; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
'''

BF16 = r'''
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { unsigned short x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // to nearest, ties even
  uint32_t u; memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = (uint32_t)h.x << 16; float f; memcpy(&f, &u, 4); return f;
}
'''

BUILDS = {"32 threads, 256-entry buffers": ["-DCOZO_TOPK_THREADS=32",
                                             "-DCOZO_TOPK_CAP=256",
                                             "-DCOZO_TOPK_WARP_BUF=256"],
          "64 threads, 2,048-entry buffers": ["-DCOZO_TOPK_THREADS=64",
                                              "-DCOZO_TOPK_CAP=2048"],
          "64 threads, 256-entry warp buffers": [
              "-DCOZO_TOPK_THREADS=64", "-DCOZO_TOPK_CAP=2048",
              "-DCOZO_TOPK_WARP_BUF=256"]}
CASES = topk_cases(widths=(512, 4097), ragged=None)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    work = tmp_path_factory.mktemp("slab_topk_host")
    (work / "cuda_runtime.h").write_text(SHIM + EXTRA)
    (work / "cuda_bf16.h").write_text(BF16)
    with open(f"{_build.CSRC}/slab_topk.cu") as f:
        (work / "slab_topk.cpp").write_text(to_host_cpp(f.read()))
    procs = {}
    for i, (name, flags) in enumerate(BUILDS.items()):
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", *flags,
             f"-I{work}", "-o", str(work / f"slab_topk_{i}.so"),
             str(work / "slab_topk.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for i, (name, proc) in enumerate(procs.items()):
        _, err = proc.communicate()
        if proc.returncode != 0 and "barrier" in err and "No such file" in err:
            pytest.skip("needs a g++ with C++20 <barrier>")
        assert proc.returncode == 0, err[-3000:]
        out[name] = ek._bind_topk(ctypes.CDLL(str(work / f"slab_topk_{i}.so")))
    return out


def run_source(lib, x, kf, kw):
    out, _ = ek._topk_run(lib, x, kf, kw.get("col_scale"),
                          kw.get("row_scale"), kw.get("bias"),
                          kw.get("bf16", False), 0, None, None)
    return out


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"B{B}-W{W}-kf{kf}-{v}-{k}"
                              for B, W, kf, v, k in CASES])
def test_slab_topk_source_on_the_host(libs, build, i):
    """Every phase-2 case at widths 512 and 4,097, the order kinds at both
    and the narrow widths: values and ids bit-equal to the plain version,
    two runs identical."""
    B, W, kf, variant, kind = CASES[i]
    x, kw = topk_inputs(B, W, variant, kind, i, CPU)
    got = run_source(libs[build], x, kf, kw)
    assert topk_same(got, ek.select_topk_plain(x, kf, **kw))
    assert topk_same(got, run_source(libs[build], x, kf, kw))


def test_ragged_block_of_launches_and_offsets(libs, monkeypatch):
    """kf past the shared sort buffer with scratch for 5 rows a launch: 17
    rows go in launches of 5, 5, 5 and 2, written into a chunk's columns
    of a wider buffer with the chunk's id offset."""
    lib = libs["32 threads, 256-entry buffers"]
    monkeypatch.setattr(ek, "TOPK_SCRATCH_BYTES", 8 * 512 * 5)
    x, kw = topk_inputs(17, 500, "bias", "random", 7, CPU)
    bufs = ek._chunk_buffers(17, 3, 500, torch.float32, CPU)
    for t in bufs:
        t.fill_(3)
    out, launches = ek._topk_run(lib, x, 500, None, None, kw["bias"], False,
                                 131_072, ek._cols(bufs, 1, 500), None)
    assert launches == 4
    want = ek.select_topk_plain(x, 500, bias=kw["bias"], offset=131_072)
    assert topk_same((bufs[0][:, 500:1000], bufs[1][:, 500:1000]), want)
    assert (bufs[1][:, :500] == 3).all() and (bufs[1][:, 1000:] == 3).all()


def test_the_c_entry_refuses_what_it_cannot_take(libs):
    """kf past W, a row stride below W, and a kf past the shared sort
    buffer without scratch are refused before any launch."""
    lib = libs["32 threads, 256-entry buffers"]
    x = torch.zeros((4, 300))
    v = torch.empty((4, 300))
    i = torch.empty((4, 300), dtype=torch.int64)
    args = lambda ldx, kf, scratch: (  # noqa: E731
        x.data_ptr(), 0, ldx, 4, 300, kf, None, None, None, v.data_ptr(), 0,
        i.data_ptr(), 300, 0, scratch, 512, 0, None)
    assert lib.cozo_slab_topk(*args(300, 301, None)) != 0
    assert lib.cozo_slab_topk(*args(299, 10, None)) != 0
    assert lib.cozo_slab_topk(*args(300, 300, None)) != 0
    assert lib.cozo_slab_topk_sort_cap() == 256
