"""What the three host tests of the per-chunk selection's CUDA source
(`tests/test_torch_slab_topk_host*.py`, one file a build, so that `--dist
loadfile` spreads the builds over workers) share: the stand-in headers,
the builds, the cases, the compile and the check of one case.

The source (`cozo_tpu_torch/csrc/slab_topk.cu`) is compiled with g++
against `tests/test_torch_beam_host.py`'s stand-in `cuda_runtime.h` (the
threads of a block as fibers on the calling thread, blocks one after
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
CASE_IDS = [f"B{B}-W{W}-kf{kf}-{v}-{k}" for B, W, kf, v, k in CASES]
CPU = torch.device("cpu")
COMPILE_TIMEOUT_S = 600


def build_lib(tmp_path_factory, build):
    """The library of `build` (a key of BUILDS), compiled with g++ into a
    fresh directory; skips where there is no g++ with C++20."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    work = tmp_path_factory.mktemp("slab_topk_host")
    (work / "cuda_runtime.h").write_text(SHIM + EXTRA)
    (work / "cuda_bf16.h").write_text(BF16)
    with open(f"{_build.CSRC}/slab_topk.cu") as f:
        (work / "slab_topk.cpp").write_text(to_host_cpp(f.read()))
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         *BUILDS[build], f"-I{work}", "-o", str(work / "slab_topk.so"),
         str(work / "slab_topk.cpp")],
        capture_output=True, text=True, timeout=COMPILE_TIMEOUT_S)
    if proc.returncode != 0 and "barrier" in proc.stderr \
            and "No such file" in proc.stderr:
        pytest.skip("needs a g++ with C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ek._bind_topk(ctypes.CDLL(str(work / "slab_topk.so")))


def run_source(lib, x, kf, kw):
    out, _ = ek._topk_run(lib, x, kf, kw.get("col_scale"),
                          kw.get("row_scale"), kw.get("bias"),
                          kw.get("bf16", False), 0, None, None)
    return out


def check_case(lib, i):
    """Case i of CASES through `lib`: values and ids bit-equal to the
    plain version, two runs identical."""
    B, W, kf, variant, kind = CASES[i]
    x, kw = topk_inputs(B, W, variant, kind, i, CPU)
    got = run_source(lib, x, kf, kw)
    assert topk_same(got, ek.select_topk_plain(x, kf, **kw))
    assert topk_same(got, run_source(lib, x, kf, kw))
