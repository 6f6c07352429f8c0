"""What the host tests of the chunk step's selection half
(`tests/test_torch_sweep_select_host*.py`, one file a row state, so that
`--dist loadfile` spreads the builds over workers) share: the stand-in
headers, the harness, the build, the cases and the check of one case.

The selection (`cozo_tpu_torch/csrc/sweep_select.cuh`, every step that
`sweep_topk.cu` takes on an accumulator fragment: pass 1, pass 2, the lists
in registers, the heads and tails in shared memory and their merges, the
end write) has no PTX.  It is compiled with g++ against
`tests/test_torch_beam_host.py`'s stand-in `cuda_runtime.h` (the threads
of a block as fibers on the calling thread) and the few names it adds, and
run by `HARNESS` below: a block of the configuration's consumer
warpgroups (no producer, no `wgmma`, no TMA) walks the piece's tiles in the
kernel's order (`tile_of`), each thread building its accumulator fragment
in `wgmma` m64n64's register layout from a product matrix computed on the
host (f32 for the bf16 route, s32 for int8, of small integer inputs: every
f32 sum exact), the tile's bias and column scales in shared memory as the
kernel's ring holds them.

Each row state is built three times: in the narrow kernel's configuration,
in the wide one's (`-DSEL_WIDE=1`: one consumer of 64 rows for every
state, the int8 sums converted by round-to-nearest), and in the wide one's
with two consumers on the block's 64 rows (`-DSEL_WIDE=2`): the piece's
tiles in groups of 1, 2 or 8 (`set_group`: eight groups, four, or one, so
that the second consumer selects nothing), each group selected by the
consumers in turn (`sync_t` first), the heads and tails one state in
shared memory, the lists each consumer's own, merged at the end
(`dump_lists`, `merge_lists`).

The cases: kc 1, 10, 26, 32 (lists of 8), 33, 64 (lists of 16), 65, 97,
128 (head 128 and tail 128), 256 (head 256 and tail 64); both key kinds;
"random" (2% dead columns), "ties" (integer keys: equal keys in every tile,
and rows repeated across tiles), "zeros" (+-0.0: zero rows with a +-0.0
bias, the first query zero), "dead" (3 live columns a piece: fewer than
kc), "rising" (keys that rise along the piece: every tile of the order
beats the threshold), and in the wide configuration "big" (sums past
2^22), "big1536" and "big4096" (the sums of 1,536- and 4,096-wide rows,
past 2^24, where the int8 route's conversion rounds: the harness has no
products and no ring, so a row's width reaches the selection only as the
size of its sums); two pieces of 512 columns, 70 or 130 query rows (a
ragged last tile of rows), an id offset.

Tolerance: none.  Values and ids must be bit-equal to
`select_topk_plain` a piece.  What this cannot show: the products, the
ring, the clusters (the card's: `tests/test_torch_cuda.py`,
`chip_smoke.py`), races that only real warps hit, any time.  Skips where
there is no g++.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import topk_same
from cozo_tpu_torch.ops import _build
from cozo_tpu_torch.ops import exact_knn as ek
from tests._torch_slab_topk_host import BF16, EXTRA
from tests.test_torch_beam_host import SHIM

# the CUDA names the selection uses beyond the slab_topk tests' stand-ins
SELECT_EXTRA = r'''
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; memcpy(&f, &u, 4); return f; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
'''

# A block of the configuration's consumer warpgroups over each piece and
# query tile: the kernel's consumer loop without the products.
HARNESS = r'''
#include <cuda_runtime.h>
#include <type_traits>
#include "sweep_select.cuh"
using namespace cozo_sweep;

#ifndef SEL_WIDE
#define SEL_WIDE 0
#endif
// the narrow kernel's configuration of the row state, the wide one's, or
// the wide one's with two consumers
typedef typename std::conditional<
    SEL_WIDE == 2, WideCfg<SEL_MODE, 2>,
    typename std::conditional<SEL_WIDE == 1, WideCfg<SEL_MODE>, CfgOf<SEL_MODE, 1>>::type>::type
    Conf;
constexpr int TURNS = SEL_WIDE == 2 ? 2 : 1;  // consumers that take the groups in turns
constexpr int THREADS = 128 * (SEL_WIDE == 2 ? 2 : Conf::NCONS);
constexpr unsigned SCRATCH = SEL_WIDE == 2 ? 64u * 4 * Conf::L * 8 : 0u;  // lists' merge
static int sel_group = 1;  // tiles a group (SEL_WIDE == 2)

template <int KIND, class C>
__global__ void walk(const void* prod, long long n_total, Args a) {
  typedef typename std::conditional<KIND == 0, float, int>::type Acc;
  unsigned char* smem = SHIM_SMEM;
  float* vec = reinterpret_cast<float*>(smem + C::SEL_BYTES);  // the stage's vectors
  u64* scratch = reinterpret_cast<u64*>(smem + C::SEL_BYTES + 512);
  const int tid = threadIdx.x, lane = tid & 31;
  const int piece_idx = blockIdx.x / a.n_qt, qt = blockIdx.x % a.n_qt;
  const int n_tiles = a.piece / TN;
  // two consumers: both on the block's rows, the groups of tiles in turns
  const int cons = SEL_WIDE == 2 ? tid >> 7 : 0, ctid = SEL_WIDE == 2 ? tid & 127 : tid;
  const int group = SEL_WIDE == 2 ? sel_group : 1;
  const int wrow = (ctid >> 7) * BM + ((ctid & 127) >> 5) * 16;
  Select<C, KIND, SEL_WIDE != 0> sel;
  sel.init(ctid, qt, a, smem);
  for (int e = 0, tile = 0; e < n_tiles; ++e, tile = next_tile(tile, a.stride, n_tiles)) {
    if (tile != tile_of(e, n_tiles, a.stride)) abort();  // the two forms of the order
    const long long col = (long long)piece_idx * a.piece + (long long)tile * TN;
    __syncthreads();
    if (tid < TN) {
      vec[tid] = a.bias[col + tid];
      if (KIND == 1) vec[TN + tid] = a.col_scale[col + tid];
    }
    __syncthreads();
    if (cons != (e / group) % TURNS) continue;  // the other consumer's group
    if (SEL_WIDE == 2 && e % group == 0) sel.sync_t();
    Acc d[32];  // m64n64's fragment: row lane/4 (+ 8), columns 8 j + 2 (lane & 3) (+ 1)
    for (int i = 0; i < 32; ++i) {
      const int r = wrow + (lane >> 2) + 8 * ((i >> 1) & 1);
      const long long c = col + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      d[i] = static_cast<const Acc*>(prod)[((long long)qt * C::RB + r) * n_total + c];
    }
    float x[32], mx[2];
    sel.pass1(d, vec, x, mx);
    if (sel.need(mx, tile)) sel.select(d, x, tile, vec);
  }
  if (SEL_WIDE == 2) {  // the second consumer's lists into the first's
    __syncthreads();
    if (cons == 1) sel.dump_lists(scratch);
    __syncthreads();
    if (cons == 1) return;
    sel.merge_lists(scratch);
  }
  sel.finish(a, piece_idx);
}

template <int KIND>
int run(const void* prod, long long n_total, Args a) {
  typedef Conf C;
  a.n_qt = a.n_qt_c = (a.B + C::RB - 1) / C::RB;
  a.stride = stride_of(a.piece / TN);
  const unsigned blocks = (unsigned)((n_total / a.piece) * a.n_qt);
  shim::launch(dim3(blocks), THREADS, C::SEL_BYTES + 512 + SCRATCH,
               &walk<KIND, C>)(prod, n_total, a);
  return 0;
}

extern "C" {
// The selection of every piece and query tile of prod [n_qt RB, n_total]
// (f32 for kind 0, s32 for kind 1), into out_v / out_i as the kernel
// writes them.  Returns 1 if kc is not this build's row state.
int run_select(int kind, const void* prod, long long n_total, int B, int piece, int kc,
                 const float* bias, const float* col_scale, const float* row_scale,
                 void* out_v, void* out_i, long long ldo, long long id_off) {
  if (mode_of(kc) != SEL_MODE) return 1;
  Args a;
  a.bias = bias;
  a.col_scale = col_scale;
  a.row_scale = row_scale;
  a.out_v = out_v;
  a.out_i = static_cast<long long*>(out_i);
  a.ldo = ldo;
  a.id_off = id_off;
  a.B = B;
  a.piece = piece;
  a.kc = kc;
  return kind == 0 ? run<0>(prod, n_total, a) : run<1>(prod, n_total, a);
}
int block_rows(int kc) {
  (void)kc;
  return Conf::RB;
}
void set_group(int g) { sel_group = g; }
}
'''

MODES = {"lists of 8": 0, "lists of 16": 1, "head 128": 2, "head 256": 3}
KCS = {0: (1, 10, 26, 32), 1: (33, 64), 2: (65, 97, 128), 3: (256,)}
KINDS = ("bf16", "int8")
VARIANTS = ("random", "ties", "zeros", "dead", "rising")
PIECE, N_PIECES, D, ID_OFF = 512, 2, 16, 1000
# the wide variants of rows near +-127 and their widths: sums up to 768
# 127^2 (past 2^22), 1,536 and 4,096 127^2 (past 2^24)
BIG_WIDTHS = {"big1536": 1536, "big4096": 4096}
COMPILE_TIMEOUT_S = 600


def cases(mode, wide=False):
    """(kind, kc, variant, B) of a row state: every kc, kind and variant,
    B 70 and 130 in turn; for the wide kernel's configuration also "big"
    (768-wide rows of integers near +-127: sums past 2^22, where the int8
    route's conversion to f32 must round as `.float()` does), then every
    kc and kind at "big1536" and "big4096" (sums past 2^24)."""
    out = []
    for kc in KCS[mode]:
        for kind in KINDS:
            for variant in VARIANTS + (("big",) if wide else ()):
                out.append((kind, kc, variant, (70, 130)[len(out) % 2]))
    for variant in BIG_WIDTHS if wide else ():
        for kc in KCS[mode]:
            for kind in KINDS:
                out.append((kind, kc, variant, (70, 130)[len(out) % 2]))
    return out


def case_ids(mode, wide=False):
    return [f"{k}-kc{kc}-{v}-B{B}" for k, kc, v, B in cases(mode, wide)]


def build_wide(tmp_path_factory, mode, consumers=1):
    """The harness of row state `mode` in the wide kernel's configuration
    (64 rows a block, the exact conversion; one consumer, or two that
    select the groups of tiles in turns)."""
    return build_lib(tmp_path_factory, mode, (f"-DSEL_WIDE={consumers}",))


# the tiles a group in the two-consumer build, by case: a piece's 8 tiles
# in eight groups, four, or one (the second consumer selects nothing)
GROUPS = (1, 2, 8)


def compile_harness(tmp_path_factory, mode, defines=(), harness=HARNESS):
    """`harness` (the selection's, or another over `csrc/` headers) for
    row state `mode` compiled with g++ (with the extra -D flags `defines`)
    into a fresh directory and loaded; skips where there is no g++ with
    C++20."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the selection for the host")
    work = tmp_path_factory.mktemp("sweep_select_host")
    (work / "cuda_runtime.h").write_text(SHIM + EXTRA + SELECT_EXTRA)
    (work / "cuda_bf16.h").write_text(BF16)
    (work / "harness.cpp").write_text(harness)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-DSEL_MODE={mode}", *defines, f"-I{work}", f"-I{_build.CSRC}", "-o",
         str(work / "harness.so"), str(work / "harness.cpp")],
        capture_output=True, text=True, timeout=COMPILE_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ctypes.CDLL(str(work / "harness.so"))


def build_lib(tmp_path_factory, mode, defines=()):
    """The selection's harness of row state `mode` (with the extra -D flags
    `defines`), its entries bound."""
    lib = compile_harness(tmp_path_factory, mode, defines)
    lib.run_select.argtypes = ([ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_longlong] + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p] * 5
                                 + [ctypes.c_longlong] * 2)
    lib.run_select.restype = ctypes.c_int
    lib.block_rows.argtypes = [ctypes.c_int]
    lib.block_rows.restype = ctypes.c_int
    lib.set_group.argtypes = [ctypes.c_int]
    lib.set_group.restype = None
    return lib


def inputs(kind, B, variant, seed):
    """(product matrix [B, n] f32 or int32 of small integers, bias,
    col_scale, row_scale) of a case."""
    rng = np.random.default_rng(seed)
    n = PIECE * N_PIECES
    q = rng.integers(-3, 4, (B, D))
    t = rng.integers(-3, 4, (n, D))
    if variant == "big" or variant in BIG_WIDTHS:
        # |sums| up to w 127^2: 12,387,072 > 2^22 at 768, 66,064,384 > 2^24
        # at 4,096
        w = BIG_WIDTHS.get(variant, 768)
        q = rng.integers(100, 128, (B, w)) * rng.choice([-1, 1], (B, 1))
        t = rng.integers(100, 128, (n, w)) * rng.choice([-1, 1], (n, 1))
    bias = -rng.integers(0, 9, n).astype(np.float32) * 0.25
    bias[rng.random(n) < 0.02] = -np.inf
    cs = rng.integers(1, 4, n).astype(np.float32) * 0.25
    rs = rng.integers(1, 4, B).astype(np.float32) * 0.5
    if variant == "ties":
        bias[np.isfinite(bias)] = 0.0
        t[64:128] = t[:64]  # a tile repeated: equal keys at other positions
    elif variant == "zeros":
        zero = rng.choice(n, n // 4, replace=False)
        t[zero] = 0
        bias[zero] = rng.choice(np.float32([0.0, -0.0]), len(zero))
        q[0] = 0
    elif variant == "dead":
        bias[:] = -np.inf
        for p in range(N_PIECES):
            bias[p * PIECE + rng.choice(PIECE, 3, replace=False)] = 0.0
    elif variant == "rising":
        t[:] = rng.integers(-1, 2, (n, D))
        bias = (np.arange(n) % PIECE).astype(np.float32) * 0.25
    if kind == "int8":
        cs[~np.isfinite(bias)] = 0.0
    # in f64 through BLAS: every sum (< 2^27) exact
    prod = np.rint(q.astype(np.float64) @ t.T.astype(np.float64)).astype(
        np.int64)
    return (torch.from_numpy(prod.astype(np.float32 if kind == "bf16"
                                         else np.int32)),
            torch.from_numpy(bias), torch.from_numpy(cs),
            torch.from_numpy(rs))


def run_source(lib, kind, prod, kc, bias, cs, rs):
    """The harness's (values, ids) [B, N_PIECES kc]."""
    B, n = prod.shape
    rows = lib.block_rows(kc)
    padded = torch.zeros((-(-B // rows) * rows, n), dtype=prod.dtype)
    padded[:B] = prod
    vals = torch.full((B, N_PIECES * kc), 7.0,
                      dtype=torch.float32 if kind == "bf16" else torch.bfloat16)
    ids = torch.full((B, N_PIECES * kc), -5, dtype=torch.int64)
    int8 = kind == "int8"
    err = lib.run_select(int(int8), padded.data_ptr(), n, B, PIECE, kc,
                           bias.data_ptr(), cs.data_ptr() if int8 else None,
                           rs.data_ptr() if int8 else None, vals.data_ptr(),
                           ids.data_ptr(), N_PIECES * kc, ID_OFF)
    assert err == 0
    return vals, ids


def plain(kind, prod, kc, bias, cs, rs):
    """`select_topk_plain` a piece, ids offset as the kernel's."""
    vals, ids = [], []
    for p in range(N_PIECES):
        cols = slice(p * PIECE, (p + 1) * PIECE)
        if kind == "int8":
            v, i = ek.select_topk_plain(prod[:, cols], kc, col_scale=cs[cols],
                                        row_scale=rs, bias=bias[cols],
                                        bf16=True, offset=ID_OFF + p * PIECE)
        else:
            v, i = ek.select_topk_plain(prod[:, cols], kc, bias=bias[cols],
                                        offset=ID_OFF + p * PIECE)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals, 1), torch.cat(ids, 1)


def check_case(lib, mode, i, wide=False, group=1):
    """Case i of the row state: values and ids bit-equal to the plain
    version (`group`: the two-consumer build's tiles a group)."""
    kind, kc, variant, B = cases(mode, wide)[i]
    prod, bias, cs, rs = inputs(kind, B, variant, i)
    lib.set_group(group)
    got = run_source(lib, kind, prod, kc, bias, cs, rs)
    want = plain(kind, prod, kc, bias, cs, rs)
    assert topk_same(got, want), (
        f"{int((got[1] != want[1]).sum())} ids differ of {want[1].numel()}")


# ---- the f32 chunk step (`csrc/sweep_f32.cuh`): the FFMA product too -------

# The f32 kernel's block loop (`f32_block`) as the card runs it, the
# producer warp and the consumer warpgroups as fibers, but for its policy:
# `mbarrier`s as counters of arrivals and bytes whose waiters yield, a TMA
# box as a plain copy of the box (zeros out of bounds) that completes its
# bytes at once, the counters' waits as yields, no registers to move.
F32_HARNESS = r"""
#include <cuda_runtime.h>
#include <cmath>
#include <unordered_map>
#include "sweep_f32.cuh"
using namespace cozo_f32;

// An mbarrier: arrivals a phase, arrivals and bytes still to come, phases
// completed.
struct HostBar {
  unsigned count, pending;
  long long tx;
  unsigned phase;
};
static std::unordered_map<const void*, HostBar> host_bars;

// A tensor map: a row-major [rows, cols] f32 matrix and its box.
struct HostMap {
  const float* ptr;
  long long rows, cols;
  int box_cols, box_rows;
};

struct HostTma {
  typedef HostMap Map;
  static void progress(HostBar& b) {
    ++shim::g_progress;
    if (b.pending == 0 && b.tx == 0) {
      ++b.phase;
      b.pending = b.count;
    }
  }
  static void init(void* bar, unsigned count) { host_bars[bar] = HostBar{count, count, 0, 0}; }
  static void fence_init() {}
  static void expect(void* bar, unsigned bytes) {
    HostBar& b = host_bars.at(bar);
    b.tx += bytes;
    --b.pending;
    progress(b);
  }
  static void load(void* dst, const Map& m, void* bar, int k0, int row0) {
    float* out = static_cast<float*>(dst);
    for (int r = 0; r < m.box_rows; ++r)
      for (int k = 0; k < m.box_cols; ++k) {
        const long long row = (long long)row0 + r, col = (long long)k0 + k;
        out[r * m.box_cols + k] = row < m.rows && col < m.cols ? m.ptr[row * m.cols + col] : 0.f;
      }
    HostBar& b = host_bars.at(bar);
    b.tx -= (long long)m.box_rows * m.box_cols * 4;
    progress(b);
  }
  static void wait(void* bar, unsigned parity) {
    while ((host_bars.at(bar).phase & 1u) == parity) shim::yield();
  }
  static void arrive(void* bar) {
    HostBar& b = host_bars.at(bar);
    --b.pending;
    progress(b);
  }
  static bool test(void* bar, unsigned parity) {
    return (host_bars.at(bar).phase & 1u) != parity;
  }
  static void idle() { shim::yield(); }
  static void count(int* c, int lane) {
    __syncwarp();
    if (lane == 0) {
      ++*c;
      ++shim::g_progress;
    }
  }
  static void until(const int* c, int n) {
    while (*c < n) shim::yield();
  }
  template <int N, bool UP>
  static void regs() {}
};

template <int MODE>
__global__ void walk(HostMap mq, HostMap mt, Args a, Layout L) {
  f32_block<MODE, HostTma>(SHIM_SMEM, mq, mt, a, L, (int)blockIdx.x);
}

extern "C" {
// The kernel's launch of `cozo_sweep_topk_f32` on host arrays.  Returns 1
// if kc is not this build's row state, 2 if the layout does not fit.
int run_f32(const float* q, const float* tbl, long long n_total, int d_pad, int d_real, int B,
            int piece, int kc, const float* bias, float* out_v, long long* out_i, long long ldo,
            long long id_off) {
  if (mode_of(kc) != SEL_MODE) return 1;
  typedef F32Cfg<SEL_MODE> F;
  const Layout L = layout_of<SEL_MODE>(d_pad, d_real);
  if (L.stages < 2) return 2;
  Args a;
  a.bias = bias;
  a.col_scale = a.row_scale = nullptr;
  a.out_v = out_v;
  a.out_i = out_i;
  a.ldo = ldo;
  a.id_off = id_off;
  a.B = B;
  a.piece = piece;
  a.kc = kc;
  a.n_qt = a.n_qt_c = (B + RB - 1) / RB;
  a.stride = tile_stride<SEL_MODE>(piece);
  const HostMap mq{q, B, d_pad, F::BOX, RB}, mt{tbl, n_total, d_pad, F::BOX, F::TC};
  const unsigned blocks = (unsigned)((n_total / piece) * a.n_qt);
  shim::launch(dim3(blocks), F::NT, L.bytes, &walk<SEL_MODE>)(mq, mt, a, L);
  return 0;
}
// threads a block, query rows a block, columns a tile, columns a thread's
// micro-tile, floats a K-slice, the ring's stages, whether the query rows
// stay resident at d_pad, the staging's selection tiles
void shape_of(int d_pad, int* out) {
  typedef F32Cfg<SEL_MODE> F;
  const Layout L = layout_of<SEL_MODE>(d_pad);
  out[0] = F::NT;
  out[1] = RB;
  out[2] = F::TC;
  out[3] = F::MC;
  out[4] = F::KS;
  out[5] = L.stages;
  out[6] = L.resident;
  out[7] = L.slots;
}
}
"""

# d_pad: a slice of 16 alone, 32 + 16, the lane's 128 (rows resident), 144
# (rows streamed, a last slice of 16), 256 (streamed, whole slices); then
# the widest: 1,536 (OpenAI's) and 4,096 (the kernel's widest), each with
# the chain over d_pad and stopped at the real width
F32_DS = (16, 48, 128, 144, 256)
F32_WIDE_DS = (1536, 4096)
F32_VARIANTS = ("random", "ties", "zeros", "dead", "rising")
# the tile's edges, (d_pad, B, d_real, piece): pieces of 256 (one or two
# tiles of 256 or 128 columns), B a whole block, one past it, a single
# row, a block and one; real widths that end inside a slice (the lane's
# 100 of 128, 37 of 48, 130 of 144, 1,500 of 1,536)
F32_EDGES = ((128, 64, 100, 256), (48, 65, 37, 256), (144, 1, 130, 512),
             (1536, 129, 1500, 256))


def build_f32(tmp_path_factory, mode):
    """The f32 kernel's harness of row state `mode`, its entries bound."""
    lib = compile_harness(tmp_path_factory, mode, harness=F32_HARNESS)
    lib.run_f32.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                            + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
                            + [ctypes.c_longlong] * 2)
    lib.run_f32.restype = ctypes.c_int
    lib.shape_of.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.shape_of.restype = None
    return lib


def f32_shape(lib, d_pad):
    """(threads, rows, columns a tile, columns a micro-tile, floats a
    K-slice, stages, resident, staged selection tiles) of a build."""
    out = (ctypes.c_int * 8)()
    lib.shape_of(d_pad, out)
    return tuple(out)


def f32_cases(mode):
    """(kc, variant, d_pad, B, d_real, piece) of a row state: every kc and
    variant, d_pad and B (70, 130: a ragged last query tile) in turn, the
    real width (the inputs' d_pad - 4 nonzero columns) given to every
    other case (0: the chain over d_pad); then at each of F32_WIDE_DS the
    chain over d_pad and stopped at the real width, the row state's kc
    and the variants in turn; then F32_EDGES.  Pieces of PIECE but the
    edges'."""
    out = []
    for kc in KCS[mode]:
        for variant in F32_VARIANTS:
            i = len(out)
            d_pad = F32_DS[i % len(F32_DS)]
            out.append((kc, variant, d_pad, (70, 130)[i % 2],
                        (0, d_pad - 4)[(i // len(F32_DS)) % 2], PIECE))
    for j, (d_pad, d_real) in enumerate((d, r) for d in F32_WIDE_DS
                                        for r in (0, d - 4)):
        out.append((KCS[mode][j % len(KCS[mode])],
                    F32_VARIANTS[j % len(F32_VARIANTS)], d_pad,
                    (70, 130)[j % 2], d_real, PIECE))
    for j, (d_pad, B, d_real, piece) in enumerate(F32_EDGES):
        out.append((KCS[mode][j % len(KCS[mode])],
                    F32_VARIANTS[j % len(F32_VARIANTS)], d_pad, B, d_real,
                    piece))
    return out


def f32_case_ids(mode):
    return [f"kc{kc}-{v}-d{d}-B{B}" + (f"-real{r}" if r else "")
            + (f"-piece{p}" if p != PIECE else "")
            for kc, v, d, B, r, p in f32_cases(mode)]


def f32_inputs(B, d_pad, variant, seed, d_real=0):
    """(q [B, d_pad], tbl [n, d_pad], bias) f32 of small integers (every
    sum exact in any order), the variant's structure planted as
    `inputs` plants it; the columns past d_real, or the last 4 (the
    lanes' padding), zero."""
    rng = np.random.default_rng(seed)
    n = PIECE * N_PIECES
    d = d_real or max(1, d_pad - 4)
    q = np.zeros((B, d_pad), np.float32)
    t = np.zeros((n, d_pad), np.float32)
    q[:, :d] = rng.integers(-3, 4, (B, d))
    t[:, :d] = rng.integers(-3, 4, (n, d))
    bias = -rng.integers(0, 9, n).astype(np.float32) * 0.25
    bias[rng.random(n) < 0.02] = -np.inf
    if variant == "ties":
        bias[np.isfinite(bias)] = 0.0
        t[64:128] = t[:64]
    elif variant == "zeros":
        zero = rng.choice(n, n // 4, replace=False)
        t[zero] = 0.0
        bias[zero] = rng.choice(np.float32([0.0, -0.0]), len(zero))
        q[0] = 0.0
    elif variant == "dead":
        bias[:] = -np.inf
        for p in range(N_PIECES):
            bias[p * PIECE + rng.choice(PIECE, 3, replace=False)] = 0.0
    elif variant == "rising":
        t[:, :d] = rng.integers(-1, 2, (n, d))
        bias = (np.arange(n) % PIECE).astype(np.float32) * 0.25
    return torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(bias)


def check_f32_case(lib, mode, i):
    """Case i of the row state: the f32 kernel's values and ids bit-equal
    to `sweep_topk_plain`'s (`torch.mm` in f32 over d_pad, then
    `select_topk_plain` a piece), whether its chains run over d_pad or
    stop at the real width."""
    kc, variant, d_pad, B, d_real, piece = f32_cases(mode)[i]
    q, t, bias = f32_inputs(B, d_pad, variant, 100 + i, d_real)
    cols = t.shape[0] // piece * kc
    vals = torch.full((B, cols), 7.0, dtype=torch.float32)
    ids = torch.full((B, cols), -5, dtype=torch.int64)
    err = lib.run_f32(q.data_ptr(), t.data_ptr(), t.shape[0], d_pad, d_real,
                      B, piece, kc, bias.data_ptr(), vals.data_ptr(),
                      ids.data_ptr(), cols, ID_OFF)
    assert err == 0
    want = ek.sweep_topk_plain(q, t, piece, kc, bias, offset=ID_OFF)
    assert topk_same((vals, ids), want), (
        f"{int((ids != want[1]).sum())} ids differ of {want[1].numel()}")
