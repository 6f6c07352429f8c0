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
// the bytes (the table once, the outputs) are under 1 GB.  67 TFLOP/s is
// every scheduler issuing an FFMA every clock, so the design counts issue
// slots and keeps everything else off the consumers (`sweep_f32.cuh`):
// the consumer warpgroups run register micro-tiles of 8 query rows x 8
// table rows (4 for the heads) on 128-bit shared loads, their own layout,
// and hand each finished tile through shared memory to a selecting
// warpgroup, whose `Select` (`sweep_select.cuh`, KIND 0) reads it as the
// m64n64 fragments it takes while the consumers multiply the next tile;
// the selecting warpgroup's first thread feeds the ring of K-slices by
// TMA on `mbarrier`s (`hopper.cuh`, shared with `sweep_topk.cu`).  Blocks
// of 64 query rows: the table leaves L2 once a block (171.8 GB a launch at
// the lane's shape), the query rows once a tile of 256 columns where they
// stream past d_pad 128.  Times against the bound: PERF.md section 6.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "sweep_f32.cuh"

namespace {

using namespace cozo_f32;
using namespace cozo_hopper;

constexpr unsigned IDLE_NS = 200;  // a poll's pause (a stage takes ~2 us)

// The block loop's policy on the card: `mbarrier`s, TMA boxes of the
// tensor maps, counters in shared memory.
struct DeviceTma {
  typedef CUtensorMap Map;
  static __device__ __forceinline__ uint32_t at(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
  }
  static __device__ __forceinline__ void init(void* bar, unsigned count) {
    mbar_init(at(bar), count);
  }
  static __device__ __forceinline__ void fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  static __device__ __forceinline__ void expect(void* bar, unsigned bytes) {
    mbar_expect_tx(at(bar), bytes);
  }
  // the box of `map` at (k0, row0) into dst, its bytes completed on bar
  static __device__ __forceinline__ void load(void* dst, const Map& map, void* bar, int k0,
                                              int row0) {
    tma_load_2d(at(dst), &map, at(bar), k0, row0);
  }
  static __device__ __forceinline__ void wait(void* bar, unsigned parity) {
    mbar_wait(at(bar), parity);
  }
  static __device__ __forceinline__ void arrive(void* bar) { mbar_arrive(at(bar)); }
  static __device__ __forceinline__ bool test(void* bar, unsigned parity) {
    return mbar_test(at(bar), parity);
  }
  // a poll's pause, so that a waiting warp leaves the FFMAs their slots
  static __device__ __forceinline__ void idle() { __nanosleep(IDLE_NS); }
  // after the warp's shared loads: lane 0 adds one to *c
  static __device__ __forceinline__ void count(int* c, int lane) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      atomicAdd(c, 1);
    }
  }
  // before the warp's shared stores: until *c reaches n
  static __device__ __forceinline__ void until(const int* c, int n) {
    while (*reinterpret_cast<const volatile int*>(c) < n) idle();
    __threadfence_block();
  }
  template <int N, bool UP>
  static __device__ __forceinline__ void regs() {
    if (UP)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
  }
};

template <int MODE>
__global__ void __launch_bounds__(F32Cfg<MODE>::NT, 1)
sweep_topk_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_t, const Args a, const Layout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + (((raw + ALIGN - 1) & ~(ALIGN - 1)) - raw);
  f32_block<MODE, DeviceTma>(smem, map_q, map_t, a, L, (int)blockIdx.x);
}

// Whether ptxas gave the kernel the registers `setmaxnreg` moves between
// the consumers and the selecting warpgroup (else the side that rises
// would wait forever).
template <int MODE>
cudaError_t regs_ok() {
  typedef F32Cfg<MODE> F;
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, sweep_topk_f32_kernel<MODE>);
  if (e == cudaSuccess &&
      at.numRegs * F::NT < F::CONSUMER_REGS * F::NCONS + F::SELECTOR_REGS * 128)
    e = cudaErrorInvalidDeviceFunction;
  return e;
}

// The tensor maps of the queries [B, d_pad] (boxes of RB rows) and the
// table [n_total, d_pad] (boxes of a tile's TC rows), BOX floats wide.
template <int MODE>
int make_maps(CUtensorMap* mq, CUtensorMap* mt, const float* q, int B, const float* tbl,
              long long n_total, int d_pad) {
  typedef F32Cfg<MODE> F;
  int err = encode_2d(mq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, B, d_pad, F::BOX, RB,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err)
    err = encode_2d(mt, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, tbl, n_total, d_pad, F::BOX, F::TC,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  return err;
}

template <int MODE>
int launch(const float* q, const float* tbl, long long n_total, int d_pad, int d_real, Args a,
           cudaStream_t stream) {
  typedef F32Cfg<MODE> F;
  const Layout L = layout_of<MODE>(d_pad, d_real);
  // a piece's steps are counted in int, TMA's row coordinates too
  if (L.stages < 2 || (long long)(a.piece / F::TC) * L.n_ks > 0x7FFFFFFFLL ||
      n_total > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  a.n_qt = a.n_qt_c = (a.B + RB - 1) / RB;
  a.stride = tile_stride<MODE>(a.piece);
  const long long blocks = (n_total / a.piece) * (long long)a.n_qt;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mt;
  const int err = make_maps<MODE>(&mq, &mt, q, a.B, tbl, n_total, d_pad);
  if (err) return err;
  auto kernel = sweep_topk_f32_kernel<MODE>;
  cudaError_t e = regs_ok<MODE>();
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, F::NT, L.bytes, stream>>>(mq, mt, a, L);
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
  cudaError_t e = regs_ok<MODE>();
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
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
// Returns 0 when the kernel was launched, else a cudaError_t (or a negated
// CUresult where a tensor map could not be made).  Allocates nothing, does
// not synchronise.
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
  a.stride = 0;  // the launch's: its tiles' order
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
  (void)kc;
  return RB;
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

const char* cozo_cuda_error_string(int err) {
  if (err < 0) return "cuTensorMapEncodeTiled failed (the code is the negated CUresult)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
