"""The CUDA source of the beam-search kernel (`cozo_tpu_torch/csrc/
beam_search.cu`), run on the CPU and held against `beam_search_plain`.

A CUDA kernel has no interpret mode, but this one's block logic is plain
C++ between a handful of CUDA names.  The test compiles the very source
with g++ against a small stand-in for `cuda_runtime.h` (below: one
`std::thread` per CUDA thread, blocks one after another, `std::barrier`
for `__syncthreads` and `__syncwarp`, shuffles and ballots through a
per-warp scratch array, atomics through the compiler's builtins), at 64
threads a block instead of 512 (`COZO_BEAM_THREADS`; every loop of the
kernel strides by that constant), and calls the C entry point with CPU
tensors.  ids must EQUAL the plain version's (both sum in f32, in another
order, and the distances of distinct random rows are far apart; where 200
of 900 rows are returned, two near-equal ones may swap).  What this
cannot show: that nvcc takes the source, races that only real warps hit,
and any time; those are the card's (`tests/test_torch_cuda.py`,
`chip_smoke.py`).  Skips where there is no g++.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cozo_tpu_torch import HnswIndex
from cozo_tpu_torch.ops import _build
from cozo_tpu_torch.ops import vector_search as vs

SHIM = r'''
// Host stand-in for the CUDA runtime: one std::thread per CUDA thread,
// blocks one after another.  For trying a kernel's block logic without a card.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x) alignas(x)
#define __shared__ static

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "shim error"; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1; return 0;
}

struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct ulonglong2 { unsigned long long x, y; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct uint3s { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

namespace shim {
struct Warp { uint64_t scratch[32]; std::barrier<> bar{32}; };
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  unsigned char* smem;
};
inline Block* g_block;
inline thread_local uint3s t_tid, t_bid, t_gdim;
inline Warp& warp() { return *g_block->warps[t_tid.x >> 5]; }
inline int lane() { return t_tid.x & 31; }

template <class K>
struct Launch {
  dim3 grid; unsigned block; size_t smem; K kern;
  template <class... A> void operator()(A... args) {
    for (unsigned b = 0; b < grid.x * grid.y; ++b) {
      Block blk;
      blk.bar = std::make_unique<std::barrier<>>(block);
      for (unsigned w = 0; w < (block + 31) / 32; ++w) blk.warps.push_back(std::make_unique<Warp>());
      blk.smem = (unsigned char*)aligned_alloc(128, ((smem + 127) / 128 + 1) * 128);
      memset(blk.smem, 0xAB, smem);
      g_block = &blk;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block; ++t)
        ts.emplace_back([=, this] {
          t_tid = {t, 0, 0}; t_bid = {b % grid.x, b / grid.x, 0}; t_gdim = {grid.x, grid.y, 1};
          kern(args...);
        });
      for (auto& t : ts) t.join();
      free(blk.smem);
    }
  }
};
template <class K> Launch<K> launch(dim3 g, unsigned b, size_t s, K k) { return {g, b, s, k}; }
}  // namespace shim

#define threadIdx shim::t_tid
#define blockIdx shim::t_bid
#define gridDim shim::t_gdim
#define SHIM_LAUNCH(kern, grid, block, smem, stream) shim::launch(grid, block, smem, kern)
#define SHIM_SMEM (shim::g_block->smem)

inline void __syncthreads() { shim::g_block->bar->arrive_and_wait(); }
inline void __syncwarp() { shim::warp().bar.arrive_and_wait(); }
template <class T> T __shfl_sync(unsigned, T v, int src) {
  auto& w = shim::warp(); uint64_t bits = 0; memcpy(&bits, &v, sizeof(T));
  w.scratch[shim::lane()] = bits; w.bar.arrive_and_wait();
  uint64_t r = w.scratch[src & 31]; w.bar.arrive_and_wait();
  T out; memcpy(&out, &r, sizeof(T)); return out;
}
template <class T> T __shfl_xor_sync(unsigned m, T v, int o) { return __shfl_sync(m, v, shim::lane() ^ o); }
template <class T> T __shfl_up_sync(unsigned m, T v, unsigned d) {
  const int src = shim::lane() - (int)d;
  return __shfl_sync(m, v, src < 0 ? shim::lane() : src);
}
inline unsigned __ballot_sync(unsigned, bool p) {
  auto& w = shim::warp(); w.scratch[shim::lane()] = p; w.bar.arrive_and_wait();
  unsigned m = 0; for (int i = 0; i < 32; ++i) m |= (unsigned)(w.scratch[i] != 0) << i;
  w.bar.arrive_and_wait(); return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline int __float_as_int(float f) { int u; memcpy(&u, &f, 4); return u; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcs(const T* p) { return *p; }
inline long long __float2ll_rn(float x) { return llrintf(x); }
inline float __ll2float_rn(long long x) { return (float)x; }
using std::max;
using std::min;
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old > v && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
  return old;
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  unsigned old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
  return old;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicCAS(int* p, int cmp, int v) {
  __atomic_compare_exchange_n(p, &cmp, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST); return cmp;
}
'''

THREADS = 64


def to_host_cpp(src: str) -> str:
    """The .cu with its two pieces of CUDA syntax rewritten: the dynamic
    shared-memory declaration and the `<<<...>>>` launches."""
    src, n = re.subn(
        r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
        r"unsigned char* \1 = SHIM_SMEM;", src)
    assert n == 1
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\(", r"SHIM_LAUNCH(\1, \2)(", src,
                     flags=re.S)
    assert n == 2  # the search and the pointer-chase probe
    return src


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    work = tmp_path_factory.mktemp("beam_host")
    (work / "cuda_runtime.h").write_text(SHIM)
    with open(f"{_build.CSRC}/beam_search.cu") as f:
        (work / "beam_search.cpp").write_text(to_host_cpp(f.read()))
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-DCOZO_BEAM_THREADS={THREADS}", f"-I{work}", "-o",
         str(work / "beam_host.so"), str(work / "beam_search.cpp")],
        capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr and \
            "No such file" in proc.stderr:
        pytest.skip("needs a g++ with C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(work / "beam_host.so"))
    lib.cozo_beam_search.argtypes = vs._ARGTYPES
    lib.cozo_beam_search.restype = ctypes.c_int
    return lib


def host_kernel(lib, vectors, nb0, up_nb, alive, entry, qs, k, beam, n_levels,
                kind, max_iters, expand):
    """The wrapper's launch, on CPU tensors: (ids, dists, counters)."""
    B, d = qs.shape
    out = torch.full((vs.out_size(B, k),), 12345, dtype=torch.int32)
    err = lib.cozo_beam_search(
        vectors.data_ptr(), nb0.data_ptr(), up_nb.data_ptr(),
        alive.data_ptr(), qs.data_ptr(), out.data_ptr(), B, vectors.shape[0],
        d, nb0.shape[1], up_nb.shape[2], n_levels, int(entry), k, beam, expand,
        max_iters, kind, 0, None)
    packed = out[: B * 2 * k].view(B, 2 * k)
    return (err, packed[:, :k], packed[:, k:].view(torch.float32),
            out[B * 2 * k:].view(B, 4))


# (distance, n, d, m, B, ef, k, flat, removed, expand, copies)
CASES = [
    ("L2", 900, 100, 16, 3, 64, 10, False, 0, 8, 0),
    ("IP", 800, 24, 8, 1, 64, 10, False, 0, 8, 0),         # B = 1
    ("Cosine", 800, 37, 8, 3, 64, 10, False, 60, 8, 0),    # 4-byte loads
    ("L2", 800, 16, 8, 3, 8, 3, True, 0, 8, 0),            # flat, beam 8
    ("Cosine", 600, 260, 8, 2, 24, 5, False, 0, 8, 0),     # rows past a slice
    ("IP", 900, 32, 8, 2, 512, 10, False, 30, 8, 0),       # a wide beam
    ("L2", 1000, 20, 64, 2, 64, 10, False, 0, 16, 0),      # 2048 candidates: sorted merge
    ("L2", 900, 20, 32, 2, 200, 200, False, 0, 8, 0),      # the build's k = ef
    ("Cosine", 800, 12, 16, 3, 64, 10, False, 0, 1, 0),    # expand 1
    ("L2", 1000, 16, 8, 3, 32, 10, False, 20, 8, 400),     # many copies of rows
]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-d{c[2]}-m{c[3]}-beam{c[5]}-x{c[9]}"
                              for c in CASES])
def test_kernel_source_on_the_host_equals_plain(host_lib, case):
    distance, n, d, m, B, ef, k, flat, removed, expand, copies = case
    rng = np.random.default_rng(n + d + B)
    data = rng.standard_normal((n, d)).astype(np.float32)
    if copies:
        data[n - copies:] = data[rng.integers(0, n - copies, copies)]
    index = HnswIndex(dim=d, m=m, ef_construction=40, distance=distance,
                      device="cpu")
    index.bulk_build(data, wave=512)
    for s in range(0, 3 * removed, 3):
        index.remove(s)
    if flat:
        index.neighbors = index.neighbors[:1]
        index.levels[:n] = np.minimum(index.levels[:n], 0)
        index.version += 1
    qs = data[rng.integers(0, n, B)] + \
        0.1 * rng.standard_normal((B, d)).astype(np.float32)
    dev = vs._device_arrays(index)
    beam, max_iters, expand = vs.beam_params(k, ef, expand)
    args = (dev["vectors"], dev["nb0"], dev["up_nb"], dev["alive"],
            dev["entry"], torch.from_numpy(qs), k, beam, dev["n_levels"],
            vs.DIST_KINDS[distance], max_iters, expand)
    assert (dev["n_levels"] == 0) == flat
    err, ids, dists, stats = host_kernel(host_lib, *args)
    assert err == 0
    want_ids, want_d = vs.beam_search_plain(*args)
    # f32 sums in another order: the distance at every rank agrees to 1e-4,
    # and ids may differ only where two rows are that close (at most 1% of
    # the entries; none but in the case that returns 200 of 900 rows)
    assert torch.equal(torch.isinf(dists), torch.isinf(want_d))
    fin = torch.isfinite(want_d)
    assert float((dists - want_d)[fin].abs().max()) <= 1e-4
    same = float((ids == want_ids).float().mean())
    assert same == 1.0 if k < 200 else same >= 0.99
    assert not bool((~dev["alive"][ids.clamp(min=0).long()] & (ids >= 0)).any())
    # the counters: rounds within the cap, a list per descent step and per
    # expanded entry, at least the entry's row, no descent on a flat index
    assert ((stats[:, 1] >= 1) & (stats[:, 1] <= max_iters)).all()
    assert (stats[:, 3] >= stats[:, 0] + stats[:, 1]).all() or expand == 1
    assert (stats[:, 2] >= 1).all() and ((stats[:, 0] == 0).all() == flat)
    again = host_kernel(host_lib, *args)
    assert torch.equal(again[1], ids) and torch.equal(again[2], dists)


def test_launcher_refuses_what_the_wrapper_refuses(host_lib):
    """The C launcher computes the shared-memory size as `smem_bytes` does
    and returns an error for a shape past the limits, and for bad
    arguments, instead of launching."""
    index = HnswIndex(dim=8, m=8, ef_construction=20, device="cpu")
    rng = np.random.default_rng(0)
    for v in rng.standard_normal((200, 8)).astype(np.float32):
        index.insert(v)
    dev = vs._device_arrays(index)
    q = torch.zeros((1, 8))
    graph = (dev["vectors"], dev["nb0"], dev["up_nb"], dev["alive"],
             dev["entry"], q)
    m0, m_up = dev["nb0"].shape[1], dev["up_nb"].shape[2]

    def err(k, beam, expand):
        return host_kernel(host_lib, *graph, k, beam, dev["n_levels"], 0, 10,
                           expand)[0]

    assert err(3, 8, 4) == 0
    assert err(9, 8, 4) != 0  # k > beam
    beam = 8
    while vs.smem_bytes(8, m0, m_up, 2 * beam, 8) <= vs.MAX_SMEM:
        beam *= 2
    assert err(3, beam, 8) == 0  # the largest beam the layout takes
    assert err(3, 2 * beam, 8) != 0
    assert vs.sort_size(512, m0) > vs.MAX_SORT and err(3, 64, 512) != 0


def test_c_interface_matches_the_wrapper():
    """`_ARGTYPES` follows the C signature in the source: pointers as
    void*, ints as int, in order."""
    with open(f"{_build.CSRC}/beam_search.cu") as f:
        src = f.read()
    sig = re.search(r"int cozo_beam_search\((.*?)\)\s*{", src, re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in a else ctypes.c_int
             for a in sig.split(",")]
    assert kinds == vs._ARGTYPES
