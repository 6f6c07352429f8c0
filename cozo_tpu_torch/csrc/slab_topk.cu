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
// The design (simple and right first):
//   * One block a row.  Pass 1 reads the row once and keeps each thread's
//     largest composite: the kf-th largest of those NTHREADS maxima is a
//     composite t with at least kf elements at or above it (the kf
//     maxima above it are kf distinct elements), and the row's kf-th
//     largest is at or above t.  Pass 2 reads the row again and appends
//     every composite >= t to a candidate buffer in shared memory, one
//     atomic a warp (ballot).  On data without heavy ties that is about
//     kf + a few elements; the buffer is sorted (bitonic, descending) and
//     its first kf written.  Two reads of the slab.
//   * Otherwise (kf past NTHREADS / 2, fewer than kf threads with an
//     element, or more than CAP candidates: ties, padding, dead rows) a
//     radix select of the composite, 8 bits a round, histograms in shared
//     memory: each round reads the row (or, once at most CAP elements
//     share the prefix, the candidate buffer) until the threshold
//     composite is exact.  The elements above it go to a sort buffer, in
//     shared memory up to SORT_CAP entries, past that in the scratch the
//     caller gives (`sort_n` entries a row), which is then sorted the
//     same way.  Slower, and only where the fast route cannot answer.
//
// What bounds it: bytes.  The least the function needs is one read of the
// slab, 4 B W a row (the scales and bias are shared by all rows), and the
// outputs, 12 B kf a row: at [16,384 x 131,072] 8.59 GB, 2.56 ms at
// 3.35 TB/s.  The fast route reads the slab twice (the second read finds
// little of a 512 KB row in the 50 MB L2 while ~400 rows are in flight).
//
// Where trouble is likely, and what the code does about it:
//   1. 64-bit offsets: B x W reaches 2^31 (16,384 x 131,072); a row's
//      start is row * ldx in 64 bits, ids are 64-bit.
//   2. No FMA contraction in the prologue: `__fmul_rn` / `__fadd_rn`, never
//      contracted, so the key is bit-equal to the plain version's
//      separate passes; int32 -> f32 by `__int2float_rn`, bf16 by
//      `__float2bfloat16_rn`, as torch rounds.
//   3. Order-preserving keys, as above; each value's own bits are written
//      out (decoded from the composite).
//   4. Rows with fewer live entries than kf: the -inf entries rank by
//      position like any tie; many of them overflow the candidate buffer
//      and take the radix route.
//   5. Every kf from 1 to W: the fast route up to NTHREADS / 2, the radix
//      route beyond, with a sort buffer in device memory past SORT_CAP.
//   6. Any row stride (ldx >= W) and width: float4 / int4 loads when the
//      row starts, the stride, the width and the scale and bias vectors
//      allow them, scalar loads otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef COZO_TOPK_THREADS
#define COZO_TOPK_THREADS 512
#endif
#ifndef COZO_TOPK_CAP
#define COZO_TOPK_CAP 2048
#endif

constexpr int NTHREADS = COZO_TOPK_THREADS;
constexpr int CAP = COZO_TOPK_CAP;       // candidate buffer, entries
constexpr int SORT_CAP = COZO_TOPK_CAP;  // shared sort buffer, entries
constexpr int FAST_MAX = NTHREADS / 2;   // largest kf of the fast route
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
static_assert(NTHREADS % 32 == 0 && NTHREADS <= SORT_CAP, "block size");

typedef unsigned long long u64;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned key_bits(unsigned k) {
  return (k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k;
}

__device__ __forceinline__ u64 composite(float key, int pos) {
  return ((u64)order_key(key) << 32) | (u64)(~(unsigned)pos);
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
  const unsigned m = __ballot_sync(0xFFFFFFFFu, take);
  if (m == 0) return;
  const int lane = (int)(threadIdx.x & 31);
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cnt, __popc(m));
  base = __shfl_sync(0xFFFFFFFFu, base, leader);
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

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The first kf of the sorted buf: values (f32 or bf16 bits) and ids.
template <bool OUT_BF16>
__device__ void write_out(const u64* buf, int kf, void* out_v, long long* out_i,
                          long long row_off, long long id_off) {
  for (int i = (int)threadIdx.x; i < kf; i += NTHREADS) {
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

template <typename T, bool OUT_BF16>
__global__ void __launch_bounds__(NTHREADS)
slab_topk_kernel(const T* __restrict__ x, long long ldx, int W, int kf,
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
  const long long row_off = row * ldo;
  const int tid = (int)threadIdx.x;

  // ---- fast route: a threshold from the threads' maxima, one filter pass
  if (kf <= FAST_MAX) {
    u64 best = 0;  // no element: 0 ranks below every composite
    for_row(xr, W, vec != 0, p, [&](int j, float k, bool live) {
      if (live) {
        const u64 cv = composite(k, j);
        best = cv > best ? cv : best;
      }
    });
    sbuf[tid] = best;
    if (tid == 0) s_cnt = 0;
    __syncthreads();
    block_sort_desc(sbuf, NTHREADS);
    const u64 t = sbuf[kf - 1];
    if (t != 0) {
      for_row(xr, W, vec != 0, p, [&](int j, float k, bool live) {
        const u64 cv = live ? composite(k, j) : 0;
        warp_append(live && cv >= t, cv, cand, &s_cnt, CAP);
      });
      __syncthreads();
      const int cnt = s_cnt;
      if (cnt <= CAP) {
        const int n = pow2_at_least(cnt);
        for (int i = cnt + tid; i < n; i += NTHREADS) cand[i] = 0;
        __syncthreads();
        block_sort_desc(cand, n);
        write_out<OUT_BF16>(cand, kf, out_v, out_i, row_off, id_off);
        return;
      }
    }
    __syncthreads();  // every thread read s_cnt before it is reset
  }

  // ---- radix route: the exact threshold composite, 8 bits a round
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
        const u64 cv = live ? composite(k, j) : 0;
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
          const u64 cv = composite(k, j);
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
      const u64 cv = live ? composite(k, j) : 0;
      warp_append(live && cv >= prefix, cv, sb, &s_sel, n_sort);
    });
  }
#undef COZO_ABOVE
#undef COZO_MATCH
  __syncthreads();
  for (int i = kf + tid; i < n_sort; i += NTHREADS) sb[i] = 0;
  __syncthreads();
  block_sort_desc(sb, n_sort);
  write_out<OUT_BF16>(sb, kf, out_v, out_i, row_off, id_off);
}

bool aligned16(const void* q) { return q == nullptr || ((uintptr_t)q & 15u) == 0; }

template <typename T, bool OUT_BF16>
int launch(const void* x, long long ldx, int B, int W, int kf, const void* c,
           const void* r, const void* b, void* out_v, void* out_i, long long ldo,
           long long id_off, void* scratch, int sort_n, long long row0,
           void* stream) {
  const int vec = (W % 4 == 0 && ldx % 4 == 0 && aligned16(x) && aligned16(c) &&
                   aligned16(b)) ? 1 : 0;
  auto kern = slab_topk_kernel<T, OUT_BF16>;
  kern<<<dim3((unsigned)B), NTHREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), ldx, W, kf, static_cast<const float*>(c),
      static_cast<const float*>(r), static_cast<const float*>(b), out_v,
      static_cast<long long*>(out_i), ldo, id_off, static_cast<u64*>(scratch),
      sort_n, vec, row0);
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
