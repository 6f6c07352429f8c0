// The exact top-kf of each row of a score slab for Hopper (sm_90a), with
// the slab's prologue folded in.  For row i and column j of X [B, W]
// (f32, or the int32 products of an int8 x int8 product):
//
//   key[i, j] = ((x[i, j] * c[j]) * r[i]) + b[j]      (each factor optional)
//
// rounded to bf16 where the caller asks (the i8 lane's slab).  Each row's
// kf largest keys come out in descending order, equal keys by ascending
// position, as values in the key's type and ids = position + a given
// offset (int64), written straight into the caller's columns of a wider
// buffer (a chunk's columns of the merge buffer).
//
// Replaces the TPU primitive `lax.approx_max_k` (the hardware
// PartialReduce) where the JAX package calls it on a slab:
// `_sweep_fn` (cozo_tpu/ops/exact_knn.py:118), `_sweep_fn_i8` (:209),
// `_qsweep_fn` (cozo_tpu/ops/quant_knn.py:88), `_build_step_fn`
// (cozo_tpu/ops/bulk_build.py:144), `_build_step_fn_i8` (:266) and
// `_serve_fn` past 4,096 packed columns (cozo_tpu/ops/pallas_sweep.py:201),
// and the exact `lax.top_k` merges behind them.  The selection is exact
// and follows `lax.top_k`'s tie rule, as the JAX package's merges do (and
// as its `approx_max_k` does on a CPU for 1 < kf < W).
//
// The order: each key maps to the unsigned integer
//   u = bits(key) ^ (sign ? 0xFFFFFFFF : 0x80000000)
// (bf16 keys widened to f32 first), which orders as the floats do with
// +0.0 above -0.0, and each element to the 64-bit composite
//   (u << 32) | ~position,
// unique in a row: the kf largest composites are the kf wanted elements,
// in the wanted order.  No NaN arises on these paths; -inf is a dead row
// or padding and ranks below every finite key.
//
// What bounds it: bytes.  The least the function needs is one read of the
// slab, 4 B W a row (the scales and bias are shared by all rows and stay
// in L2), and the outputs, 12 B kf a row: at [16,384 x 131,072] 8.59 GB,
// 2.56 ms at 3.35 TB/s.
//
// The design: one read of the slab, a warp a row.
//   * The warp route (kf up to WARP_MAX_KF).  Each warp streams its row
//     once in steps of 128 columns (a 16-byte load a lane, or four 4-byte
//     loads where the row does not allow vectors), UNROLL steps' loads in
//     flight before the first is used, and keeps a running threshold t:
//     every composite above t goes to the warp's candidate buffer in
//     shared memory (a ballot and a popcount give each lane its slot; the
//     count lives in registers, no atomics).  When the buffer passes HIGH
//     (room for one more step), the warp sorts it (bitonic, __syncwarp
//     between stages), keeps its kf best and raises t to the kf-th of them.
//     At the row's end it sorts what is left and writes the first kf.  No
//     block barrier is on the path: a block holds NWARPS rows.
//     The stream's time is the latency of its loads: bytes in flight are
//     the warps an SM holds times UNROLL x 512 B.  ptxas held to 64
//     registers (MIN_BLOCKS = 4 blocks of 8 warps an SM) with UNROLL = 2
//     keeps 32 warps resident without a spill; that beat UNROLL 3 or 4 at
//     fewer warps, and 5 or 6 blocks, which spill (timed in turns on the
//     H100, `chip_graph_vs.py --kernel slab_topk`).  The kernel is
//     instantiated per prologue shape (PRO_*) so that a lane that loads
//     no scale keeps no registers for it; those that load the column
//     scale, and those with scalar loads, need 72 registers (3 blocks an
//     SM) to keep clear of spills.
//     Why it stays exact: t is always a composite with at least kf
//     elements of the row at or above it (the kf kept in the buffer, or
//     the seed's kf below), so an element below t is never among the kf
//     wanted, and t itself is already in the buffer; every element above t
//     is appended, and a compaction keeps the kf best of the buffer, which
//     hold every wanted element seen so far.  Composites are unique, so
//     this holds on any data: ties, dead rows, rows with fewer live entries
//     than kf, rows whose keys only rise.
//   * The seed (kf up to SEED_MAX_KF, rows at least 4 kf wide): before the
//     stream the warp reads the first SEED_COLS columns of its share and
//     keeps each lane's m best composites (m = 1, 2 or 4, 32 m >= 2 kf
//     where 4 allows) in registers; the kf-th largest of those 32 m
//     distinct elements is a valid t from the start.  The stream then
//     re-reads those columns (from L1 / L2) and appends only what is at or
//     above it: on narrow rows (the merges, the fused lane's packed array)
//     the row takes one small final sort instead of compactions.
//   * The re-seed: keys that keep rising (a sorted row) beat every
//     threshold, and the buffer would compact every HIGH - kf appends.
//     After RESEED_AFTER compactions (random rows take at most 4) the warp
//     seeds again from the rest of its share, which it then streams: two
//     reads of that rest, as a two-pass selection would.
//   * Rows too few for the card (B times the warps a row below
//     TARGET_WARPS): G = 2, 4 ... NWARPS warps share a row, each its own
//     steps (step s of the row goes to warp s mod G) with its own buffer
//     and threshold; after one block barrier the row's first warp gathers
//     the G sorted lists' entries at or above the largest of their kf-th
//     entries (a valid t again) and sorts them.
//   * The radix route (kf past WARP_MAX_KF): a block a row, a radix
//     select of the composite, 8 bits a round, histograms in shared
//     memory; each round reads the row (or, once at most CAP elements
//     share the prefix, the candidate buffer) until the threshold
//     composite is exact.  The elements above it go to a sort buffer, in
//     shared memory up to SORT_CAP entries, past that in the scratch the
//     caller gives (`sort_n` entries a row), which is then sorted.  It
//     re-reads the row; no main-path shape reaches it (kf 10-97 there).
//
// Where trouble is likely, and what the code does about it:
//   1. 64-bit offsets: B x W reaches 2^31 (16,384 x 131,072); a row's
//      start is row * ldx in 64 bits, ids are 64-bit, columns unsigned.
//   2. No FMA contraction in the prologue: `__fmul_rn` / `__fadd_rn`, never
//      contracted, so the key is bit-equal to the plain version's
//      separate passes; int32 -> f32 by `__int2float_rn`, bf16 by
//      `__float2bfloat16_rn`, as torch rounds.
//   3. Order-preserving keys, as above; each value's own bits are written
//      out (decoded from the composite).
//   4. A compaction must not lose what another lane appended in the same
//      step: the appends of a step are all written before the sort's first
//      __syncwarp, and a slot is never written below the kept kf.
//   5. Every kf from 1 to W: the warp route up to WARP_MAX_KF, the radix
//      route beyond, with a sort buffer in device memory past SORT_CAP.
//   6. Any row stride (ldx >= W) and width: float4 / int4 loads when the
//      row starts, the stride, the width and the scale and bias vectors
//      allow them, scalar loads otherwise.
//   7. The slab is read once: its loads are `__ldcs` (evict first), so
//      that the scales and the bias, read by every row, stay in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef COZO_TOPK_THREADS
#define COZO_TOPK_THREADS 256
#endif
#ifndef COZO_TOPK_CAP
#define COZO_TOPK_CAP 2048
#endif
#ifndef COZO_TOPK_WARP_BUF
#define COZO_TOPK_WARP_BUF 512
#endif

constexpr int NTHREADS = COZO_TOPK_THREADS;
constexpr int NWARPS = NTHREADS / 32;
constexpr int CAP = COZO_TOPK_CAP;       // the radix route's candidate buffer
constexpr int SORT_CAP = COZO_TOPK_CAP;  // its shared sort buffer, entries
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int STEP = 128;                // columns a warp reads in one step
constexpr int WBUF = COZO_TOPK_WARP_BUF;  // a warp's candidate buffer, entries
constexpr int HIGH = WBUF - STEP;        // compact past this: room for a step
constexpr int WARP_MAX_KF = WBUF / 2 < HIGH ? WBUF / 2 : HIGH;
constexpr int SEED_MAX_KF = 128;         // 32 lanes x 4 registers
constexpr int SEED_COLS = 2048;          // of the warp's share
constexpr int RESEED_AFTER = 6;          // compactions (random rows: <= 4)
constexpr int UNROLL = 2;                // steps whose loads are in flight
constexpr int MIN_BLOCKS = 4;            // an SM's: ptxas keeps 64 registers
constexpr long long TARGET_WARPS = 4096;  // warps a launch should give the card
constexpr int MIN_SHARE = 1024;          // least columns of a warp's share
static_assert(NTHREADS % 32 == 0 && NTHREADS <= SORT_CAP, "block size");
static_assert((WBUF & (WBUF - 1)) == 0 && WBUF >= 2 * STEP, "warp buffer");
static_assert(WARP_MAX_KF >= SEED_MAX_KF, "the seed's kf takes the warp route");
static_assert(HIGH + 4 * 32 <= WBUF, "a re-seed sorts past the candidates");

typedef unsigned long long u64;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned key_bits(unsigned k) {
  return (k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k;
}

__device__ __forceinline__ u64 composite(float key, unsigned pos) {
  return ((u64)order_key(key) << 32) | (u64)(~pos);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int x) { return __int2float_rn(x); }

// The prologue of one row: optional column scale, row scale, column bias,
// bf16 rounding.
struct Prologue {
  const float* c;
  const float* b;
  float r;
  bool has_r;
  bool bf16;

  __device__ __forceinline__ float key(float x, float cj, float bj) const {
    if (c) x = __fmul_rn(x, cj);
    if (has_r) x = __fmul_rn(x, r);
    if (b) x = __fadd_rn(x, bj);
    if (bf16) x = __bfloat162float(__float2bfloat16_rn(x));
    return x;
  }
};

template <typename T> struct Vec4;
template <> struct Vec4<float> { typedef float4 type; };
template <> struct Vec4<int> { typedef int4 type; };

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ---------------------------------------------------------- the warp route

// What a step loads beside the slab: nothing (the fused lane's packed
// array, the merges), the bias (the f32 / bf16 lanes, the build), or
// any of the column scale and the bias (the int8 lanes, the int8 build).
// A row scale may come with each.  The first two keep fewer registers.
enum { PRO_NONE = 0, PRO_BIAS = 1, PRO_ANY = 2 };

// A lane's four elements of one step of a row, as loaded.
template <typename T>
struct Raw {
  T x[4];
  float c[4], b[4];
};

// The column of a lane's i-th element of step g: with vectors, four
// neighbours (one 16-byte load); else four columns 32 apart.
template <bool VEC>
__device__ __forceinline__ unsigned col_of(unsigned g, unsigned lane, int i) {
  return VEC ? (g * 32u + lane) * 4u + (unsigned)i : g * 128u + lane + 32u * (unsigned)i;
}

template <typename T, bool VEC, int PRO>
__device__ __forceinline__ void load_step(const T* __restrict__ xr, unsigned W, unsigned g,
                                          unsigned lane, const Prologue& p, Raw<T>& r) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.x[i] = 0;
    r.c[i] = 1.f;
    r.b[i] = 0.f;
  }
  if (VEC) {
    typedef typename Vec4<T>::type V;
    const unsigned q = g * 32u + lane;
    if (4u * q < W) {  // W % 4 == 0: the four columns live together
      const V v = __ldcs(reinterpret_cast<const V*>(xr) + q);
      r.x[0] = v.x;
      r.x[1] = v.y;
      r.x[2] = v.z;
      r.x[3] = v.w;
      if (PRO == PRO_ANY && p.c) {
        const float4 c4 = __ldg(reinterpret_cast<const float4*>(p.c) + q);
        r.c[0] = c4.x;
        r.c[1] = c4.y;
        r.c[2] = c4.z;
        r.c[3] = c4.w;
      }
      if (PRO != PRO_NONE && p.b) {
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(p.b) + q);
        r.b[0] = b4.x;
        r.b[1] = b4.y;
        r.b[2] = b4.z;
        r.b[3] = b4.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned j = col_of<false>(g, lane, i);
      if (j < W) {
        r.x[i] = __ldcs(xr + j);
        if (PRO == PRO_ANY && p.c) r.c[i] = __ldg(p.c + j);
        if (PRO != PRO_NONE && p.b) r.b[i] = __ldg(p.b + j);
      }
    }
  }
}

// Sorts buf[0, n) descending, n a power of two, by one warp (bitonic, in
// shared memory).  Starts and ends with __syncwarp.
__device__ __forceinline__ void warp_sort_desc(u64* buf, int n, unsigned lane) {
  __syncwarp();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = (int)lane; p < (n >> 1); p += 32) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i | j;
        const u64 a = buf[i], b = buf[l];
        const bool desc = (i & k) == 0;
        if (desc ? (a < b) : (a > b)) {
          buf[i] = b;
          buf[l] = a;
        }
      }
      __syncwarp();
    }
  }
}

// Sorts the warp's cnt candidates (zeros below them up to a power of two
// of at least `least`); returns that power of two.
__device__ __forceinline__ int warp_sort_candidates(u64* buf, int cnt, int least,
                                                    unsigned lane) {
  const int n = pow2_at_least(cnt > least ? cnt : least);
  for (int i = cnt + (int)lane; i < n; i += 32) buf[i] = 0;
  warp_sort_desc(buf, n, lane);
  return n;
}

// The first kf of the sorted buf: values (f32 or bf16 bits) and ids, by
// `stride` threads from thread `first`.
template <bool OUT_BF16>
__device__ __forceinline__ void write_out(const u64* buf, int kf, void* out_v, long long* out_i,
                          long long row_off, long long id_off, int first, int stride) {
  for (int i = first; i < kf; i += stride) {
    const u64 cv = buf[i];
    const unsigned bits = key_bits((unsigned)(cv >> 32));
    const long long pos = (long long)(~(unsigned)(cv & 0xFFFFFFFFull));
    if (OUT_BF16)
      static_cast<unsigned short*>(out_v)[row_off + i] = (unsigned short)(bits >> 16);
    else
      static_cast<unsigned*>(out_v)[row_off + i] = bits;
    out_i[row_off + i] = pos + id_off;
  }
}

// The kf-th largest of the lanes' m best composites (m = 1, 2 or 4: 32 m
// >= 2 kf up to kf 64, >= kf up to SEED_MAX_KF) over the warp's steps s0,
// s0 + 1, ... below s1 (its step s is the row's step sub + s G): at least
// kf elements of the row are at or above it; 0 where those steps hold
// fewer than kf.  Sorts in scratch[0, 32 m).  U steps' loads in flight.
template <typename T, bool VEC, int PRO, int U>
__device__ __forceinline__ u64 seed(const T* __restrict__ xr, unsigned W, int kf,
                                    const Prologue& p, u64* scratch, unsigned lane,
                                    unsigned sub, unsigned G, unsigned s0, unsigned s1) {
  const unsigned n_steps = (W + STEP - 1) / STEP;
  const int m = kf <= 16 ? 1 : kf <= 32 ? 2 : 4;
  u64 best[4] = {0, 0, 0, 0};
  for (unsigned s = s0; s < s1 && sub + s * G < n_steps; s += U) {
    Raw<T> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) load_step<T, VEC, PRO>(xr, W, sub + (s + u) * G, lane, p, raw[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned j = col_of<VEC>(sub + (s + u) * G, lane, i);
        if (j >= W) continue;
        const u64 cv = composite(p.key(to_float(raw[u].x[i]), raw[u].c[i], raw[u].b[i]), j);
#pragma unroll
        for (int e = 3; e > 0; --e)  // sorted insertion, best[0] largest
          if (e < m && cv > best[e]) best[e] = cv > best[e - 1] ? best[e - 1] : cv;
        if (cv > best[0]) best[0] = cv;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < m) scratch[e * 32 + lane] = best[e];
  warp_sort_desc(scratch, 32 * m, lane);
  const u64 v = scratch[kf - 1];
  __syncwarp();  // every lane has read v before the buffer is written again
  return v;
}

// One warp's share of a row (steps sub, sub + G, ...): its kf best,
// sorted, at buf[0, kf) (zeros where the share has fewer elements).
template <typename T, bool VEC, int PRO>
__device__ __forceinline__ void warp_select(const T* __restrict__ xr, unsigned W, int kf,
                                            const Prologue& p, u64* buf, unsigned lane,
                                            unsigned sub, unsigned G) {
  const unsigned n_steps = (W + STEP - 1) / STEP;
  const unsigned lt = (1u << lane) - 1u;
  u64 t = 0;  // append composites above t; 0 ranks below every composite
  const bool seeded = kf <= SEED_MAX_KF && W / G >= 4u * (unsigned)kf;
  if (seeded) {
    const u64 s = seed<T, VEC, PRO, UNROLL>(xr, W, kf, p, buf, lane, sub, G, 0, SEED_COLS / STEP);
    t = s ? s - 1 : 0;  // s's element is not yet in the buffer
  }
  int cnt = 0, compactions = 0;
  for (unsigned s0 = 0; sub + s0 * G < n_steps; s0 += UNROLL) {
    if (seeded && compactions == RESEED_AFTER) {
      // keys that keep rising defeat a running threshold: a threshold from
      // the lanes' best over the rest of the row (one more read of it, a
      // step at a time: no registers beyond the stream's), sorted past the
      // candidates (cnt <= HIGH here)
      const u64 s = seed<T, VEC, PRO, 1>(xr, W, kf, p, buf + cnt, lane, sub, G, s0, ~0u);
      if (s > t) t = s - 1;
      ++compactions;
    }
    Raw<T> raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load_step<T, VEC, PRO>(xr, W, sub + (s0 + u) * G, lane, p, raw[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned g = sub + (s0 + u) * G;
      if (g >= n_steps) break;
      unsigned key[4];
      bool may = false;
      const unsigned thi = (unsigned)(t >> 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        key[i] = order_key(p.key(to_float(raw[u].x[i]), raw[u].c[i], raw[u].b[i]));
        may |= col_of<VEC>(g, lane, i) < W && key[i] >= thi;
      }
      if (!__any_sync(FULL, may)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned j = col_of<VEC>(g, lane, i);
        const u64 cv = ((u64)key[i] << 32) | (u64)(~j);
        const bool take = j < W && cv > t;
        const unsigned mask = __ballot_sync(FULL, take);
        if (take) buf[cnt + __popc(mask & lt)] = cv;
        cnt += __popc(mask);
      }
      if (cnt > HIGH) {  // keep the kf best, raise t to the kf-th
        warp_sort_candidates(buf, cnt, 1, lane);
        t = buf[kf - 1];
        cnt = kf;
        ++compactions;
      }
    }
  }
  warp_sort_candidates(buf, cnt, kf, lane);
}

template <typename T, bool OUT_BF16, bool VEC, int PRO>
__global__ void __launch_bounds__(NTHREADS, PRO == PRO_ANY || !VEC ? MIN_BLOCKS - 1 : MIN_BLOCKS)
slab_topk_warps(const T* __restrict__ x, long long ldx, int B, int W, int kf,
                const float* __restrict__ col_scale, const float* __restrict__ row_scale,
                const float* __restrict__ bias, void* out_v, long long* out_i,
                long long ldo, long long id_off, long long row0, int G) {
  __shared__ u64 wbuf[NWARPS * WBUF];
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned sub = warp % (unsigned)G;  // this warp's place in its row
  const long long local = (long long)blockIdx.x * (NWARPS / G) + warp / (unsigned)G;
  const bool live = local < B;
  const long long row = row0 + local;
  u64* buf = wbuf + warp * WBUF;
  if (live) {
    Prologue p;
    p.c = col_scale;
    p.b = bias;
    p.has_r = row_scale != nullptr;
    p.r = p.has_r ? row_scale[row] : 1.f;
    p.bf16 = OUT_BF16;
    warp_select<T, VEC, PRO>(x + row * ldx, (unsigned)W, kf, p, buf, lane, sub, (unsigned)G);
  }
  if (G > 1) {
    // the row's first warp merges the G lists: every wanted element is in
    // one of them, at or above the largest of their kf-th entries
    __syncthreads();
    if (!live || sub != 0) return;
    u64 t = 0;
    for (int v = 0; v < G; ++v) {
      const u64 e = buf[v * WBUF + kf - 1];
      t = e > t ? e : t;
    }
    const unsigned lt = (1u << lane) - 1u;
    int cnt = 0;
    for (int v = 0; v < G; ++v) {
      for (int i0 = 0; i0 < kf; i0 += 32) {
        const int i = i0 + (int)lane;
        const u64 cv = i < kf ? buf[v * WBUF + i] : 0;
        const bool take = cv != 0 && cv >= t;
        const unsigned mask = __ballot_sync(FULL, take);
        __syncwarp();  // every lane has read before any writes (in place)
        if (take) buf[cnt + __popc(mask & lt)] = cv;
        cnt += __popc(mask);
      }
    }
    warp_sort_candidates(buf, cnt, kf, lane);
  } else if (!live) {
    return;
  }
  write_out<OUT_BF16>(buf, kf, out_v, out_i, row * ldo, id_off, (int)lane, 32);
}

// --------------------------------------------------------- the radix route

// f(position, key) for every element of the row, each thread its own
// elements (float4 / int4 groups strided by the block when `vec`).  Every
// thread of the block makes the same number of calls, `live` false past
// the row's end, so that warp-wide votes inside f see all 32 lanes.
template <typename T, typename F>
__device__ __forceinline__ void for_row(const T* __restrict__ xr, int W,
                                        bool vec, const Prologue p, F&& f) {
  if (vec) {
    typedef typename Vec4<T>::type V;
    const int nq = W >> 2;
    for (int base = 0; base < nq; base += NTHREADS) {
      const int q = base + (int)threadIdx.x;
      const bool live = q < nq;
      float k0 = 0.f, k1 = 0.f, k2 = 0.f, k3 = 0.f;
      if (live) {
        const V v = reinterpret_cast<const V*>(xr)[q];
        float4 c4 = make_float4(1.f, 1.f, 1.f, 1.f), b4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p.c) c4 = reinterpret_cast<const float4*>(p.c)[q];
        if (p.b) b4 = reinterpret_cast<const float4*>(p.b)[q];
        k0 = p.key(to_float(v.x), c4.x, b4.x);
        k1 = p.key(to_float(v.y), c4.y, b4.y);
        k2 = p.key(to_float(v.z), c4.z, b4.z);
        k3 = p.key(to_float(v.w), c4.w, b4.w);
      }
      f(4 * q, k0, live);
      f(4 * q + 1, k1, live);
      f(4 * q + 2, k2, live);
      f(4 * q + 3, k3, live);
    }
  } else {
    for (int base = 0; base < W; base += NTHREADS) {
      const int j = base + (int)threadIdx.x;
      const bool live = j < W;
      float k = 0.f;
      if (live) k = p.key(to_float(xr[j]), p.c ? p.c[j] : 1.f, p.b ? p.b[j] : 0.f);
      f(j, k, live);
    }
  }
}

// Appends `v` to buf at the slot counter *cnt hands out, one atomic a warp;
// slots past `cap` are counted and dropped.  All 32 lanes must call it.
__device__ __forceinline__ void warp_append(bool take, u64 v, u64* buf, int* cnt, int cap) {
  const unsigned m = __ballot_sync(FULL, take);
  if (m == 0) return;
  const int lane = (int)(threadIdx.x & 31);
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cnt, __popc(m));
  base = __shfl_sync(FULL, base, leader);
  if (take) {
    const int slot = base + __popc(m & ((1u << lane) - 1u));
    if (slot < cap) buf[slot] = v;
  }
}

// Sorts buf[0, n) descending, n a power of two, by the whole block
// (bitonic; buf in shared or device memory).
__device__ void block_sort_desc(u64* buf, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = (int)threadIdx.x; i < n; i += NTHREADS) {
        const int l = i ^ j;
        if (l > i) {
          const u64 a = buf[i], b = buf[l];
          const bool desc = (i & k) == 0;
          if (desc ? (a < b) : (a > b)) {
            buf[i] = b;
            buf[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, bool OUT_BF16>
__global__ void __launch_bounds__(NTHREADS)
slab_topk_radix(const T* __restrict__ x, long long ldx, int W, int kf,
                const float* __restrict__ col_scale,
                const float* __restrict__ row_scale,
                const float* __restrict__ bias, void* out_v,
                long long* out_i, long long ldo, long long id_off,
                u64* scratch, int sort_n, int vec, long long row0) {
  __shared__ u64 cand[CAP];
  __shared__ u64 sbuf[SORT_CAP];
  __shared__ unsigned hist[RADIX];
  __shared__ int s_cnt, s_sel, s_need, s_cnt_in, s_digit;

  const long long row = row0 + (long long)blockIdx.x;
  const T* xr = x + row * ldx;
  Prologue p;
  p.c = col_scale;
  p.b = bias;
  p.has_r = row_scale != nullptr;
  p.r = p.has_r ? row_scale[row] : 1.f;
  p.bf16 = OUT_BF16;
  const int tid = (int)threadIdx.x;

  // the exact threshold composite, 8 bits a round
  const int n_sort = pow2_at_least(kf);
  u64* sb = n_sort <= SORT_CAP ? sbuf : scratch + (long long)blockIdx.x * sort_n;
  u64 prefix = 0;
  int shift = 64;  // bits [shift, 64) of the threshold are fixed
  bool in_smem = false;
  if (tid == 0) {
    s_need = kf;
    s_cnt_in = W;
    s_sel = 0;
    s_cnt = 0;
  }
  __syncthreads();
  // above: the prefix's bits exceed the threshold's; match: they equal them
#define COZO_ABOVE(cv) (shift < 64 && ((cv) >> shift) > (prefix >> shift))
#define COZO_MATCH(cv) (shift == 64 || ((cv) >> shift) == (prefix >> shift))
  while (shift > 0 && s_need < s_cnt_in) {
    if (!in_smem && s_cnt_in <= CAP) {
      // the elements that share the prefix move to shared memory, those
      // above it go to the sort buffer (kf - need of them)
      for_row(xr, W, vec != 0, p, [&](int j, float k, bool live) {
        const u64 cv = live ? composite(k, (unsigned)j) : 0;
        warp_append(live && COZO_ABOVE(cv), cv, sb, &s_sel, n_sort);
        warp_append(live && COZO_MATCH(cv), cv, cand, &s_cnt, CAP);
      });
      in_smem = true;
    }
    for (int i = tid; i < RADIX; i += NTHREADS) hist[i] = 0;
    __syncthreads();
    const int dshift = shift - RADIX_BITS;
    if (in_smem) {
      const int cnt = s_cnt;
      for (int i = tid; i < cnt; i += NTHREADS) {
        const u64 cv = cand[i];
        if (COZO_MATCH(cv)) atomicAdd(&hist[(unsigned)(cv >> dshift) & (RADIX - 1)], 1u);
      }
    } else {
      for_row(xr, W, vec != 0, p, [&](int j, float k, bool live) {
        if (live) {
          const u64 cv = composite(k, (unsigned)j);
          if (COZO_MATCH(cv)) atomicAdd(&hist[(unsigned)(cv >> dshift) & (RADIX - 1)], 1u);
        }
      });
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0, d = RADIX - 1;
      for (; d > 0; --d) {
        if (acc + (int)hist[d] >= s_need) break;
        acc += (int)hist[d];
      }
      s_need -= acc;
      s_cnt_in = (int)hist[d];
      s_digit = d;
    }
    __syncthreads();
    prefix |= (u64)s_digit << dshift;
    shift = dshift;
  }
  // the kf wanted elements are exactly the composites >= prefix
  if (in_smem) {
    const int cnt = s_cnt;
    for (int base = 0; base < cnt; base += NTHREADS) {
      const int i = base + tid;
      const u64 cv = i < cnt ? cand[i] : 0;
      warp_append(i < cnt && cv >= prefix, cv, sb, &s_sel, n_sort);
    }
  } else {
    for_row(xr, W, vec != 0, p, [&](int j, float k, bool live) {
      const u64 cv = live ? composite(k, (unsigned)j) : 0;
      warp_append(live && cv >= prefix, cv, sb, &s_sel, n_sort);
    });
  }
#undef COZO_ABOVE
#undef COZO_MATCH
  __syncthreads();
  for (int i = kf + tid; i < n_sort; i += NTHREADS) sb[i] = 0;
  __syncthreads();
  block_sort_desc(sb, n_sort);
  write_out<OUT_BF16>(sb, kf, out_v, out_i, row * ldo, id_off, tid, NTHREADS);
}

bool aligned16(const void* q) { return q == nullptr || ((uintptr_t)q & 15u) == 0; }

// The warps a row takes: more while the launch has fewer than
// TARGET_WARPS and each keeps at least MIN_SHARE columns.
int warps_a_row(int B, int W) {
  int G = 1;
  while (G < NWARPS && (long long)B * G < TARGET_WARPS && W / (2 * G) >= MIN_SHARE) G <<= 1;
  return G;
}

template <typename T, bool OUT_BF16>
int launch(const void* x, long long ldx, int B, int W, int kf, const void* c,
           const void* r, const void* b, void* out_v, void* out_i, long long ldo,
           long long id_off, void* scratch, int sort_n, long long row0,
           void* stream) {
  const bool vec = W % 4 == 0 && ldx % 4 == 0 && aligned16(x) && aligned16(c) &&
                   aligned16(b);
  const T* xt = static_cast<const T*>(x);
  const float *cf = static_cast<const float*>(c), *rf = static_cast<const float*>(r),
              *bf = static_cast<const float*>(b);
  long long* ids = static_cast<long long*>(out_i);
  if (kf <= WARP_MAX_KF) {
    const int G = warps_a_row(B, W);
    const int rows = NWARPS / G;
    // one of the kernels, by the vectors the prologue reads and the loads
    // the row allows
    typedef void (*Kernel)(const T*, long long, int, int, int, const float*, const float*,
                           const float*, void*, long long*, long long, long long, long long,
                           int);
    const Kernel kerns[3][2] = {
        {slab_topk_warps<T, OUT_BF16, false, PRO_NONE>, slab_topk_warps<T, OUT_BF16, true, PRO_NONE>},
        {slab_topk_warps<T, OUT_BF16, false, PRO_BIAS>, slab_topk_warps<T, OUT_BF16, true, PRO_BIAS>},
        {slab_topk_warps<T, OUT_BF16, false, PRO_ANY>, slab_topk_warps<T, OUT_BF16, true, PRO_ANY>}};
    auto kern = kerns[c ? PRO_ANY : b ? PRO_BIAS : PRO_NONE][vec ? 1 : 0];
    kern<<<dim3((unsigned)((B + rows - 1) / rows)), NTHREADS, 0, (cudaStream_t)stream>>>(
        xt, ldx, B, W, kf, cf, rf, bf, out_v, ids, ldo, id_off, row0, G);
  } else {
    auto kern = slab_topk_radix<T, OUT_BF16>;
    kern<<<dim3((unsigned)B), NTHREADS, 0, (cudaStream_t)stream>>>(
        xt, ldx, W, kf, cf, rf, bf, out_v, ids, ldo, id_off, static_cast<u64*>(scratch),
        sort_n, vec ? 1 : 0, row0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues the top-kf of rows [row0, row0 + B) of x on `stream`.  x: rows
// of W elements, `ldx` apart, f32 (in_kind 0) or int32 (in_kind 1); c [W],
// r [rows], b [W] f32 or null; out_v (f32, or bf16 when out_kind is 1) and
// out_i (int64) rows of kf, `ldo` apart, row i's at row i of the arrays
// (not of the launch); ids = position + id_off.  `scratch` holds B x
// sort_n u64 (sort_n the power of two at or above kf) when sort_n exceeds
// the shared sort buffer, else may be null.  Returns 0 when the kernel was
// launched (or B is 0), else a cudaError_t.  Allocates nothing, does not
// synchronise.
int cozo_slab_topk(const void* x, int in_kind, long long ldx, int B, int W, int kf,
                   const void* c, const void* r, const void* b, void* out_v,
                   int out_kind, void* out_i, long long ldo, long long id_off,
                   void* scratch, int sort_n, long long row0, void* stream) {
  if (B < 0 || W < 1 || kf < 1 || kf > W || ldx < W || ldo < kf || row0 < 0 ||
      in_kind < 0 || in_kind > 1 || out_kind < 0 || out_kind > 1)
    return (int)cudaErrorInvalidValue;
  int n_sort = 1;
  while (n_sort < kf) n_sort <<= 1;
  if (n_sort > SORT_CAP && (scratch == nullptr || sort_n < n_sort))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (in_kind == 0)
    return out_kind ? launch<float, true>(x, ldx, B, W, kf, c, r, b, out_v, out_i, ldo,
                                          id_off, scratch, sort_n, row0, stream)
                    : launch<float, false>(x, ldx, B, W, kf, c, r, b, out_v, out_i, ldo,
                                           id_off, scratch, sort_n, row0, stream);
  return out_kind ? launch<int, true>(x, ldx, B, W, kf, c, r, b, out_v, out_i, ldo,
                                      id_off, scratch, sort_n, row0, stream)
                  : launch<int, false>(x, ldx, B, W, kf, c, r, b, out_v, out_i, ldo,
                                       id_off, scratch, sort_n, row0, stream);
}

// The size of the shared sort buffer (entries): past it a launch needs
// scratch.
int cozo_slab_topk_sort_cap() { return SORT_CAP; }

const char* cozo_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
