// The f32 lane's chunk step for Hopper (sm_90a): each query row's true-f32
// scores against a column piece of the resident table, and that piece's
// exact top-kc, in one kernel.  The [B x piece] score slab (8 GiB a chunk
// at the f32 lane's B = 16,384) never reaches device memory.
//
// Replaces the chunk body that the JAX package writes as one program for
// its exact lane: `dot_general` at Precision.HIGHEST + bias, then `top_k`
// (`approx_max_k` at rt = 1), in `_sweep_fn`'s scan at compute_dtype "f32"
// (cozo_tpu/ops/exact_knn.py:100-123); `sweep_topk.cu` is the same body
// for bf16 and int8.
//
// For row i and piece p (columns [p P, (p + 1) P) of the table) the kc
// largest of the unique composites (order_key(key) << 32) | ~position,
// key = __fadd_rn(score, bias[j]) with score = fmaf(q[i][d_pad - 1],
// t[j][d_pad - 1], ... fmaf(q[i][0], t[j][0], +0.0f)): one chain over k
// ascending, the bias added after it, as `select_topk` adds it to the
// product's slab.  Values f32, ids = p P + position + id_off (int64), into
// columns [p kc, (p + 1) kc) of the caller's merge buffers.
//
// What bounds it: operations outside the tensor cores.  At the f32 lane's
// shape (B = 16,384, n_total = 1,310,720, d_pad = 128, 100 real columns)
// the products are 4.29 TFLOP with the chains stopped at the real width,
// 64.1 ms at the H100's 67 TFLOP/s f32 (5.50 TFLOP, 82.0 ms over d_pad);
// the bytes (the table once, the outputs) are under 1 GB.  On the card
// (PERF.md section 6): about half of that bound, and faster than the
// two-step route (cuBLAS's product and `slab_topk` a chunk) in turns.
// The design (`sweep_f32.cuh`): FFMA on register fragments fed by 128-bit
// shared loads; the table in K-slices through a `cp.async`
// ring, its traffic from L2 the table once a query tile (671 MB x 128 =
// 85.9 GB at the lane's shape, some 13 ms at the rate this family's ring
// streamed out of L2: no clusters); the selection of `sweep_select.cuh`
// (KIND 0: the f32 keys) on each finished tile, a few percent of the slots.
// Configurations by kc: kc <= 32 128 rows, two fragments a thread (128
// threads); kc <= 64 128 rows, a fragment a thread (256); kc <= 256 64
// rows (128), the heads and tails filling the shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_f32.cuh"

namespace {

using namespace cozo_f32;

// 16 bytes from device memory to shared memory, asynchronously (zeros
// where `in` is false), in the thread's current commit group.
struct DeviceCopy {
  static __device__ __forceinline__ void copy16(void* dst, const void* src, bool in) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
  }
  static __device__ __forceinline__ void commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  // until at most n of the thread's groups are in flight (n < MAX_STAGES)
  static __device__ __forceinline__ void wait(int n) {
    switch (n) {
      case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
      case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
      default: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    }
  }
};
static_assert(MAX_STAGES - 2 <= 2, "DeviceCopy::wait names every count");

template <int MODE>
__global__ void __launch_bounds__(F32Cfg<MODE>::NT, F32Cfg<MODE>::MINB)
sweep_topk_f32_kernel(const float* q, const float* tbl, const Args a, const Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  f32_block<MODE, DeviceCopy>(smem, q, tbl, a, L, (int)blockIdx.x);
}

template <int MODE>
int launch(const float* q, const float* tbl, long long n_total, int d_pad, int d_real, Args a,
           cudaStream_t stream) {
  typedef F32Cfg<MODE> F;
  const Layout L = layout_of<MODE>(d_pad, d_real);
  // a piece's steps are counted in int
  if (L.stages < 2 || (long long)(a.piece / TN) * L.n_ks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  a.n_qt = a.n_qt_c = (a.B + F::RB - 1) / F::RB;
  const long long blocks = (n_total / a.piece) * (long long)a.n_qt;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto kernel = sweep_topk_f32_kernel<MODE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, F::NT, L.bytes, stream>>>(q, tbl, a, L);
  return (int)cudaGetLastError();
}

// The blocks of row state MODE at d_pad the card holds at once, or minus a
// cudaError_t.
template <int MODE>
int slots(int d_pad) {
  const Layout L = layout_of<MODE>(d_pad);
  if (L.stages < 2) return -(int)cudaErrorInvalidValue;
  auto kernel = sweep_topk_f32_kernel<MODE>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, F32Cfg<MODE>::NT, L.bytes);
  return e == cudaSuccess ? per_sm * sms : -(int)e;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

constexpr int KIND_F32 = 2;  // `sweep_topk.cu`'s kinds are 0 (bf16) and 1 (int8)

}  // namespace

extern "C" {

// Enqueues the f32 chunk step on `stream`.  q [B, d_pad] and tbl [n_total,
// d_pad] f32, row-major, 16-byte aligned; bias [n_total] f32.  out_v (f32)
// and out_i (int64) hold B rows `ldo` apart; piece p writes its kc columns
// from p kc on, ids = p piece + position + id_off.  d_real (0: d_pad): the
// rows' real width, every column past it +0.0 in q and in tbl; the chains
// stop there (`sweep_f32.cuh`: the same bits).  Needs B >= 1, d_pad % 16 ==
// 0, d_pad <= MAX_D (4,096), 0 <= d_real <= d_pad, piece % 256 == 0, n_total %
// piece == 0, 1 <= kc <= min(256, piece), ldo >= kc n_total / piece.
// Returns 0 when the kernel was launched, else a cudaError_t.  Allocates
// nothing, does not synchronise.
int cozo_sweep_topk_f32(const void* q, const void* tbl, int B, long long n_total, int d_pad,
                        int d_real, int piece, int kc, const void* bias, void* out_v,
                        void* out_i, long long ldo, long long id_off, void* stream) {
  if (B < 1 || d_pad < 16 || d_pad % 16 || d_pad > MAX_D || d_real < 0 || d_real > d_pad ||
      piece < PIECE_ALIGN ||
      piece % PIECE_ALIGN || n_total < piece || n_total % piece || kc < 1 || kc > MAX_KC ||
      kc > piece || ldo < (long long)kc * (n_total / piece) || !bias || !aligned16(q) ||
      !aligned16(tbl) || !aligned16(bias))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.bias = static_cast<const float*>(bias);
  a.col_scale = a.row_scale = nullptr;
  a.out_v = out_v;
  a.out_i = static_cast<long long*>(out_i);
  a.ldo = ldo;
  a.id_off = id_off;
  a.B = B;
  a.piece = piece;
  a.kc = kc;
  a.n_qt = a.n_qt_c = 0;
  a.stride = stride_of(piece / TN);
  const float* qf = static_cast<const float*>(q);
  const float* tf = static_cast<const float*>(tbl);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode_of(kc)) {
    case LIST8: return launch<LIST8>(qf, tf, n_total, d_pad, d_real, a, s);
    case LIST16: return launch<LIST16>(qf, tf, n_total, d_pad, d_real, a, s);
    case HEAD128: return launch<HEAD128>(qf, tf, n_total, d_pad, d_real, a, s);
    default: return launch<HEAD256>(qf, tf, n_total, d_pad, d_real, a, s);
  }
}

// The launch configuration, under the names and signatures of
// `sweep_topk.cu`'s, so that the wrapper asks either library alike; kind
// is the f32 kind, KIND_F32 (`exact_knn.SWEEP_F32`).

// The query rows a block owns for this kind, d_pad and kc (the launch's
// tile).
int cozo_sweep_topk_rows(int kind, int d_pad, int kc) {
  (void)kind;
  (void)d_pad;
  return mode_of(kc) <= LIST16 ? F32Cfg<LIST8>::RB : F32Cfg<HEAD128>::RB;
}

// The blocks in a cluster: one, the f32 kind has no clusters.
int cozo_sweep_topk_cluster(int kind, int d_pad, int kc) {
  (void)kind;
  (void)d_pad;
  (void)kc;
  return 1;
}

// The blocks of the launch for (kind, d_pad, kc) that the card holds at
// once, or minus a cudaError_t (cudaErrorInvalidValue for another kind).
int cozo_sweep_topk_slots(int kind, int d_pad, int kc) {
  if (kind != KIND_F32) return -(int)cudaErrorInvalidValue;
  switch (mode_of(kc)) {
    case LIST8: return slots<LIST8>(d_pad);
    case LIST16: return slots<LIST16>(d_pad);
    case HEAD128: return slots<HEAD128>(d_pad);
    default: return slots<HEAD256>(d_pad);
  }
}

const char* cozo_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
