// Fused scoring + segment-top-2 sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` launched by `_fused_fn`
// (cozo_tpu/ops/pallas_sweep.py:65-161, pl.pallas_call at :126).  It
// computes exactly what that kernel computes:
//
//   S = Q . V^T   (bf16 in, f32 accumulate)   + bias[col]
//   packed = bits(S) & ~0xFF | (col % 256)     (column id in the low mantissa bits)
//   out[b, 2*seg], out[b, 2*seg+1] = the two largest packed values of each
//   256-column segment of row b (the second clamped below at NEG_FILL, as
//   the TPU kernel's "mask the argmax with NEG_FILL, take the max again").
//
// Inputs: qs [B, d_pad] bf16, tbl [n_total, d_pad] bf16, bias [n_total] f32
// (0 alive / NEG_FILL = -3e38 dead: finite, since a -inf with id bits OR'd
// into its mantissa is a NaN).  Output: [B, 2*n_total/256] f32.  Any B,
// any d_pad that is a multiple of 16, any n_total that is a multiple of 256.
//
// Bound at the main-path shape (B = 16,384 queries, n_total = 1,310,720
// rows, d_pad = 128): 2*B*n_total*d_pad = 5.50 TFLOP, 5.6 ms at the H100's
// 989 TFLOP/s dense bf16; it moves ~1.0 GB (335 MB table, 671 MB output),
// 0.30 ms at 3.35 TB/s.  Compute-bound: 5.6 ms per 16,384-query launch.
//
// Design (simple first; wgmma, TMA and a persistent schedule are later
// work): one block per (64-query x 256-column) tile, i.e. one segment per
// block column, so no reduction crosses blocks.  The grid is 1-D with the
// query tile fastest, so blocks in flight together share one 64 KB table
// segment (read from device memory once) and stream the small query
// matrix from L2.  A K-loop over d_pad in chunks of 64 stages bf16 Q and
// V tiles in shared memory and multiplies them on the tensor cores with
// nvcuda::wmma (bf16 -> f32).  The [64, 256] f32 tile then goes to shared
// memory (aliasing the staging buffers), and one warp per row adds the
// bias, packs the column bits and reduces 256 values to the top 2 with a
// per-lane top-2 and a shuffle merge.  Packed values are unique within a
// segment (the id bits differ), so the result does not depend on the
// order of the merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <climits>

using namespace nvcuda;

namespace {

constexpr int SEG = 256;        // table columns per segment (= per block)
constexpr int BQ = 64;          // query rows per block
constexpr int KC = 64;          // contraction chunk staged per step
constexpr int LDS = KC + 8;     // bf16 staging row stride (bank skew)
constexpr int LDC = SEG + 4;    // f32 score tile row stride (bank skew)
constexpr int NTHREADS = 256;   // 8 warps: 2 (rows) x 4 (columns)
constexpr float NEG_FILL = -3.0e38f;

constexpr size_t STAGE_BYTES = (size_t)(BQ + SEG) * LDS * sizeof(__nv_bfloat16);
constexpr size_t SCORE_BYTES = (size_t)BQ * LDC * sizeof(float);
constexpr size_t TILE_BYTES = STAGE_BYTES > SCORE_BYTES ? STAGE_BYTES : SCORE_BYTES;
constexpr size_t SMEM_BYTES = TILE_BYTES + SEG * sizeof(float);

static_assert(NTHREADS == SEG, "one thread stages one bias entry");
static_assert(TILE_BYTES % 128 == 0, "bias region alignment");

__global__ void __launch_bounds__(NTHREADS)
fused_sweep_kernel(const __nv_bfloat16* __restrict__ qs,
                   const __nv_bfloat16* __restrict__ tbl,
                   const float* __restrict__ bias,
                   float* __restrict__ out,
                   int B, int d_pad, int n_qt, long long out_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sv = sq + BQ * LDS;
  float* sc = reinterpret_cast<float*>(smem);  // aliases sq/sv after the K-loop
  float* sb = reinterpret_cast<float*>(smem + TILE_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long bid = blockIdx.x;
  const int q0 = (int)(bid % n_qt) * BQ;
  const long long seg = bid / n_qt;
  const long long c0 = seg * SEG;

  sb[tid] = bias[c0 + tid];

  const int wr = warp >> 2;  // rows wr*32 .. wr*32+31
  const int wc = warp & 3;   // columns wc*64 .. wc*64+63
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  constexpr int VPR = KC / 8;  // 16-byte vectors per staged row
  for (int k0 = 0; k0 < d_pad; k0 += KC) {
    const int kw = min(KC, d_pad - k0);  // a multiple of 16
    const int vw = kw / 8;
    for (int i = tid; i < BQ * VPR; i += NTHREADS) {
      const int r = i / VPR, c = i % VPR;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < vw && q0 + r < B)
        v = *reinterpret_cast<const uint4*>(qs + (size_t)(q0 + r) * d_pad + k0 + c * 8);
      *reinterpret_cast<uint4*>(sq + r * LDS + c * 8) = v;
    }
    for (int i = tid; i < SEG * VPR; i += NTHREADS) {
      const int r = i / VPR, c = i % VPR;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < vw)
        v = *reinterpret_cast<const uint4*>(tbl + (size_t)(c0 + r) * d_pad + k0 + c * 8);
      *reinterpret_cast<uint4*>(sv + r * LDS + c * 8) = v;
    }
    __syncthreads();
    for (int kk = 0; kk < kw; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sq + (wr * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // V rows stored row-major are V^T in column-major order
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, sv + (wc * 64 + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();  // staging is rewritten (or aliased by sc) next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sc + (wr * 32 + i * 16) * LDC + wc * 64 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int r = warp; r < BQ && q0 + r < B; r += NTHREADS / 32) {
    const float* row = sc + r * LDC;
    float m1 = 0.0f, m2 = NEG_FILL;
#pragma unroll
    for (int j = 0; j < SEG / 32; ++j) {
      const int col = lane + 32 * j;
      const float s = row[col] + sb[col];
      const float p = __int_as_float((__float_as_int(s) & ~(SEG - 1)) | col);
      if (j == 0) {
        m1 = p;
      } else if (p > m1) {
        m2 = fmaxf(m2, m1);
        m1 = p;
      } else {
        m2 = fmaxf(m2, p);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, m1, off);
      const float o2 = __shfl_xor_sync(0xffffffffu, m2, off);
      if (o1 > m1) {
        m2 = fmaxf(o2, m1);
        m1 = o1;
      } else {
        m2 = fmaxf(m2, o1);
      }
    }
    if (lane == 0)
      *reinterpret_cast<float2*>(out + (size_t)(q0 + r) * out_w + 2 * seg) =
          make_float2(m1, m2);
  }
}

}  // namespace

extern "C" {

// Launches the sweep on `stream`; returns a cudaError_t (0 = launched).
int cozo_fused_sweep(const void* qs, const void* tbl, const void* bias, void* out,
                     int B, int n_total, int d_pad, void* stream) {
  if (B <= 0 || n_total <= 0 || n_total % SEG != 0 || d_pad <= 0 || d_pad % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_qt = (B + BQ - 1) / BQ;
  const long long n_seg = n_total / SEG;
  if (n_qt * n_seg > (long long)INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      fused_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  fused_sweep_kernel<<<(unsigned)(n_qt * n_seg), NTHREADS, SMEM_BYTES,
                       (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qs), static_cast<const __nv_bfloat16*>(tbl),
      static_cast<const float*>(bias), static_cast<float*>(out), B, d_pad, (int)n_qt,
      2 * n_seg);
  return (int)cudaGetLastError();
}

const char* cozo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
