// Fused scoring + segment-top-2 sweep for Hopper (sm_90a): TMA + wgmma.
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
// 0.30 ms at 3.35 TB/s.  Compute-bound.  At d_pad = 128 a score is only 256
// tensor-core FLOP, and its epilogue (bias add, pack, top-2 update) is five
// CUDA-core instructions, four of them (logic, min, max, max) on the pipe
// that issues a warp instruction every other clock: about as long as the
// product.  So the epilogue has to run beside the products, never after
// them.
//
// Design.  Both routes are persistent, warp-specialised blocks of three
// warpgroups, one block per SM: warpgroup 2 is the producer (one thread
// issues TMA loads into 128-byte-swizzled shared tiles and signals
// mbarriers), warpgroups 0 and 1 are consumers that issue `wgmma` with both
// operands K-major in shared memory and the f32 score tile in registers.
// The epilogue works on that fragment: thread `lane` of a warp holds rows
// lane/4 and lane/4 + 8 and the columns 8j + 2*(lane%4) + e (e < 2).  Per
// row it keeps one running top-2 per e with only the 8j bits packed (within
// one e-stream the other id bits are equal, so the order is that of the
// full packing), ORs the low id bits in afterwards, merges the two streams,
// and merges the quad with two shuffles.  No score touches shared memory.
// TMA zero-fills out of bounds, which covers a ragged last query tile and a
// d_pad that is not a multiple of the 64-wide box.
//
//  * `resident` (d_pad <= 128): a block keeps a group of two adjacent table
//    segments (2 x 64 KB at d_pad = 128) and their bias in shared memory
//    and streams 64-query tiles through a 4-stage ring; the two consumers
//    take alternate query tiles and run free of each other (m64n256k16, the
//    64 x 256 score tile in 128 registers), so one's epilogue falls beside
//    the other's products.  (Timed on an H100 against a ping-pong of the
//    two over named barriers and against one consumer overlapping itself
//    with two n = 128 accumulators: neither was faster, so the simplest
//    stays.  Asynchronous products left in flight across a branch or a
//    loop edge get serialised by ptxas, remarks C7514/C7518: issue and wait
//    stay in straight-line code, `score_unit`.)  Each consumer scores its
//    tile against both segments and writes a row's four results with one
//    16-byte store.
//    The (group, query tile) units are cut into equal contiguous ranges,
//    one per block, so no wave is left half empty; a block reloads the
//    table only when its range crosses into the next group.
//  * `kloop` (d_pad > 128, where a segment no longer fits): the unit is a
//    (segment, 128-query tile); a ring of (query, table) K-chunks of 64
//    feeds both consumers, which share each table chunk and take 64 query
//    rows each.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 256;         // table columns per segment
constexpr int BQ = 64;           // query rows per consumer tile (wgmma M)
constexpr int KC = 64;           // bf16 per TMA box row: 128 bytes, the swizzle span
constexpr int NCONS = 2;         // consumer warpgroups
constexpr int NTHREADS = 128 * (NCONS + 1);
constexpr float NEG_FILL = -3.0e38f;

constexpr uint32_t Q_CHUNK = BQ * KC * 2;    // 8 KB: 64 query rows x 64 k
constexpr uint32_t T_CHUNK = SEG * KC * 2;   // 32 KB: 256 table rows x 64 k
constexpr uint32_t BIAS_BYTES = SEG * 4;

// resident route: shared memory map (offsets from a 1,024-byte boundary)
constexpr int R_GROUP = 2;       // table segments resident per block
constexpr int R_KC = 2;          // K-chunks at most (d_pad <= 128)
constexpr int R_STAGES = 4;      // query ring
constexpr uint32_t R_TBL = 0;
constexpr uint32_t R_Q = R_TBL + R_GROUP * R_KC * T_CHUNK;
constexpr uint32_t R_BIAS = R_Q + R_STAGES * R_KC * Q_CHUNK;
constexpr uint32_t R_BAR = R_BIAS + R_GROUP * BIAS_BYTES;
constexpr uint32_t R_SMEM = R_BAR + 8 * (2 * R_STAGES + 2) + 1024;

// kloop route
constexpr int K_STAGES = 4;
constexpr uint32_t K_STAGE_BYTES = NCONS * Q_CHUNK + T_CHUNK;  // 48 KB
constexpr uint32_t K_BAR = K_STAGES * K_STAGE_BYTES;
constexpr uint32_t K_SMEM = K_BAR + 8 * 2 * K_STAGES + 1024;

static_assert(R_SMEM <= 232448 && K_SMEM <= 232448, "shared memory of one block");

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are 128
// bytes with the 128-byte swizzle, as TMA wrote it: 8-row groups 1,024
// bytes apart (SBO); LBO is not used by this layout.
__device__ __forceinline__ uint64_t mma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#define COZO_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define COZO_D16(i) COZO_D4(i), COZO_D4(i + 4), COZO_D4(i + 8), COZO_D4(i + 12)

// d (+)= A[64 x 16] . B[256 x 16]^T, bf16 operands from shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}"
      : COZO_D16(0), COZO_D16(16), COZO_D16(32), COZO_D16(48), COZO_D16(64), COZO_D16(80),
        COZO_D16(96), COZO_D16(112)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Returns once at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving uses of the accumulators across the
// asynchronous products (it emits no instruction).
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The four k = 16 steps of one 64-wide K-chunk; a step is 32 bytes along
// the swizzled 128-byte row, i.e. 2 in the descriptor's 16-byte units.
__device__ __forceinline__ void mma_chunk(float (&acc)[128], uint32_t q_addr, uint32_t t_addr,
                                          bool first) {
  const uint64_t da = mma_desc(q_addr), db = mma_desc(t_addr);
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks)
    wgmma_m64n256k16(acc, da + 2 * ks, db + 2 * ks, !(first && ks == 0));
}

// ---- epilogue on the accumulator fragment -------------------------------

__device__ __forceinline__ float or_bits(float x, int bits) {
  return __int_as_float(__float_as_int(x) | bits);
}

// ~(SEG - 1) in a register the compiler cannot fold: (bits & keep) | id is
// then one three-input logic instruction (with two constants it is two).
__device__ __forceinline__ int keep_mask() {
  int keep;
  asm volatile("mov.u32 %0, 0xFFFFFF00;" : "=r"(keep));
  return keep;
}

// Running top-2 of the packed (score + bias) of the two rows this thread
// holds (h: row lane/4 + 8h), one stream per column parity e.
struct Top2 {
  float m1[2][2], m2[2][2];  // [h][e]

  __device__ __forceinline__ void init() {
    const float ninf = __int_as_float(0xff800000);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) m1[h][e] = m2[h][e] = ninf;
  }

  // Takes in the N/4 column octets of an accumulator fragment whose first
  // column is `col0` of the segment.  `bias` points at this thread's first
  // column of the fragment, col0 + 2*(lane%4).
  template <int N>
  __device__ __forceinline__ void add(const float (&acc)[N], const float* bias, int col0,
                                      int keep) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = acc[4 * j + 2 * h + e] + (e ? b.y : b.x);
          int pi;
          asm("lop3.b32 %0, %1, %2, %3, 0xEA;"  // (s & keep) | id
              : "=r"(pi)
              : "r"(__float_as_int(s)), "r"(keep), "r"(col0 + 8 * j));
          const float p = __int_as_float(pi);
          m2[h][e] = fmaxf(m2[h][e], fminf(m1[h][e], p));
          m1[h][e] = fmaxf(m1[h][e], p);
        }
    }
  }

  // After the segment's 256 columns: res = {row lane/4: top1, top2, row
  // lane/4 + 8: top1, top2}, the same on all four lanes of a quad.  `low`
  // is 2*(lane%4), the id bits the streams left out.
  __device__ __forceinline__ void finish(int low, float (&res)[4]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // every stream saw 32 finite values, so none of the four is -inf
      const float x1 = or_bits(m1[h][0], low), x2 = or_bits(m2[h][0], low);
      const float y1 = or_bits(m1[h][1], low | 1), y2 = or_bits(m2[h][1], low | 1);
      float t1 = fmaxf(x1, y1);
      float t2 = fmaxf(fminf(x1, y1), fmaxf(x2, y2));
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float o1 = __shfl_xor_sync(0xffffffffu, t1, off);
        const float o2 = __shfl_xor_sync(0xffffffffu, t2, off);
        t2 = fmaxf(fminf(t1, o1), fmaxf(t2, o2));
        t1 = fmaxf(t1, o1);
      }
      res[2 * h] = t1;
      res[2 * h + 1] = fmaxf(t2, NEG_FILL);
    }
  }
};

__device__ __forceinline__ uint32_t aligned_smem_base(const unsigned char* smem) {
  return ((uint32_t)__cvta_generic_to_shared(smem) + 1023u) & ~1023u;
}

// ---- route `resident`: d_pad <= 128 --------------------------------------

// One consumer's work on one unit of the resident route: its 64 query rows
// (at q_addr) against the NSEG resident segments (from t_addr), over KCN
// K-chunks.  `bias` points at this thread's first column, 2*(lane%4) =
// `low`, of the first segment.  res[s] = segment s: {row lane/4: top1,
// top2, row lane/4 + 8: top1, top2}.  All products are complete on return.
template <int KCN, int NSEG>
__device__ __forceinline__ void score_unit(uint32_t q_addr, uint32_t t_addr, const float* bias,
                                           int low, int keep, float (&res)[R_GROUP][4]) {
  float acc[128];
#pragma unroll
  for (int s = 0; s < NSEG; ++s) {
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KCN; ++c)
      mma_chunk(acc, q_addr + c * Q_CHUNK, t_addr + (s * R_KC + c) * T_CHUNK, c == 0);
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(acc);
    Top2 top;
    top.init();
    top.add(acc, bias + s * SEG, 0, keep);
    top.finish(low, res[s]);
  }
}

// KCN: 64-wide K-chunks of a row (1 for d_pad <= 64, else 2).
template <int KCN>
__global__ void __launch_bounds__(NTHREADS, 1)
sweep_resident_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_t,
                      const float* __restrict__ bias, float* __restrict__ out, int B, int n_seg,
                      int n_qt, long long units) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = aligned_smem_base(smem_raw);
  const float* bias_s = reinterpret_cast<const float*>(smem_raw + (base - raw) + R_BIAS);
  const uint32_t q_full = base + R_BAR, q_empty = q_full + 8 * R_STAGES;
  const uint32_t t_full = q_empty + 8 * R_STAGES, t_empty = t_full + 8;

  const int tid = threadIdx.x;
  // through a shuffle, so that the compiler knows it uniform over the warp
  // (it serialises asynchronous products in a path it takes for divergent)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  // this block's contiguous range of (group, query tile) units, group-major
  const long long u_begin = units * blockIdx.x / gridDim.x;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  const long long grp_begin = u_begin / n_qt;
  const int qt_begin = (int)(u_begin % n_qt);

  if (tid == 0) {
    for (int s = 0; s < R_STAGES; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 4);  // the four warps of the one consumer that read it
    }
    mbar_init(t_full, 1);
    mbar_init(t_empty, 4 * NCONS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NCONS) {
    // ===== producer =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 128 * NCONS) {
      long long grp = grp_begin;
      int qt = qt_begin;
      uint32_t loads = 0;  // table groups loaded so far
      bool need_table = true;
      for (long long i = 0; i < u_end - u_begin; ++i) {
        if (need_table) {
          if (loads > 0) mbar_wait(t_empty, (loads - 1) & 1);
          const int nseg = (int)min((long long)R_GROUP, n_seg - R_GROUP * grp);
          mbar_expect_tx(t_full, nseg * (KCN * T_CHUNK + BIAS_BYTES));
          for (int s = 0; s < nseg; ++s) {
            const int row0 = (int)(R_GROUP * grp + s) * SEG;
            for (int c = 0; c < KCN; ++c)
              tma_load_2d(base + R_TBL + (s * R_KC + c) * T_CHUNK, &map_t, t_full, c * KC, row0);
            bulk_load(base + R_BIAS + s * BIAS_BYTES, bias + row0, BIAS_BYTES, t_full);
          }
          ++loads;
          need_table = false;
        }
        const int stage = (int)(i % R_STAGES);
        const uint32_t round = (uint32_t)(i / R_STAGES);
        if (round > 0) mbar_wait(q_empty + 8 * stage, (round - 1) & 1);
        mbar_expect_tx(q_full + 8 * stage, KCN * Q_CHUNK);
        for (int c = 0; c < KCN; ++c)
          tma_load_2d(base + R_Q + (stage * R_KC + c) * Q_CHUNK, &map_q, q_full + 8 * stage,
                      c * KC, qt * BQ);
        if (++qt == n_qt) {
          qt = 0;
          ++grp;
          need_table = true;
        }
      }
    }
  } else {
    // ===== consumers =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = tid & 31;
    const int low = 2 * (lane & 3);
    const int row_in_tile = ((tid & 127) >> 5) * 16 + (lane >> 2);
    const long long out_w = 2LL * n_seg;
    const bool vec4 = (n_seg % 2) == 0;  // a row's 16-byte stores are then aligned
    const int keep = keep_mask();
    // The block's range is walked group by group; within a group the two
    // consumers take alternate units.
    const long long n_units = u_end - u_begin;
    long long i0 = 0;   // index in the range of the group's first unit
    int qt0 = qt_begin;
    for (long long grp = grp_begin; i0 < n_units; ++grp) {
      const long long m = min((long long)(n_qt - qt0), n_units - i0);  // units of this group
      mbar_wait(t_full, (uint32_t)(grp - grp_begin) & 1);
      const int nseg = (int)min((long long)R_GROUP, n_seg - R_GROUP * grp);

      for (long long l = wg; l < m; l += NCONS) {
        const long long i = i0 + l;
        const int qt = qt0 + (int)l;
        const int stage = (int)(i % R_STAGES);
        mbar_wait(q_full + 8 * stage, (uint32_t)(i / R_STAGES) & 1);
        const uint32_t q_addr = base + R_Q + stage * R_KC * Q_CHUNK;

        float r[R_GROUP][4];
        if (nseg == 2)
          score_unit<KCN, 2>(q_addr, base + R_TBL, bias_s + low, low, keep, r);
        else
          score_unit<KCN, 1>(q_addr, base + R_TBL, bias_s + low, low, keep, r);
        // every product that reads the query tile is done: the slot refills
        // during the last epilogue's tail and the stores
        if (lane == 0) mbar_arrive(q_empty + 8 * stage);

        if ((lane & 3) == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row = (long long)qt * BQ + row_in_tile + 8 * h;
            if (row < B) {
              float* o = out + row * out_w + 2 * R_GROUP * grp;
              if (nseg == 2 && vec4) {
                *reinterpret_cast<float4*>(o) =
                    make_float4(r[0][2 * h], r[0][2 * h + 1], r[1][2 * h], r[1][2 * h + 1]);
              } else {
                *reinterpret_cast<float2*>(o) = make_float2(r[0][2 * h], r[0][2 * h + 1]);
                if (nseg == 2)
                  *reinterpret_cast<float2*>(o + 2) = make_float2(r[1][2 * h], r[1][2 * h + 1]);
              }
            }
          }
        }
      }
      // done with this group's table and bias: the producer may overwrite them
      __syncwarp();
      if (lane == 0) mbar_arrive(t_empty);
      i0 += m;
      qt0 = 0;
    }
  }
}

// ---- route `kloop`: d_pad > 128 ------------------------------------------

__global__ void __launch_bounds__(NTHREADS, 1)
sweep_kloop_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_t, const float* __restrict__ bias,
                   float* __restrict__ out, int B, int n_seg, int n_qt, int kc, long long units) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t full = base + K_BAR, empty = full + 8 * K_STAGES;

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // uniform over the warp
  // this block's contiguous range of (segment, 128-query tile) units
  const long long u_begin = units * blockIdx.x / gridDim.x;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  long long seg = u_begin / n_qt;
  int qt = (int)(u_begin % n_qt);

  if (tid == 0) {
    for (int s = 0; s < K_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NCONS) {
    // ===== producer =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 128 * NCONS) {
      long long n = 0;  // K-chunks issued
      for (long long u = u_begin; u < u_end; ++u) {
        for (int c = 0; c < kc; ++c, ++n) {
          const int stage = (int)(n % K_STAGES);
          const uint32_t round = (uint32_t)(n / K_STAGES);
          if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
          const uint32_t dst = base + stage * K_STAGE_BYTES;
          mbar_expect_tx(full + 8 * stage, K_STAGE_BYTES);
          tma_load_2d(dst, &map_q, full + 8 * stage, c * KC, qt * NCONS * BQ);
          tma_load_2d(dst + NCONS * Q_CHUNK, &map_t, full + 8 * stage, c * KC, (int)seg * SEG);
        }
        if (++qt == n_qt) {
          qt = 0;
          ++seg;
        }
      }
    }
  } else {
    // ===== consumers: both take every unit, 64 of its 128 query rows each =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = tid & 31;
    const int low = 2 * (lane & 3);
    const int row_in_tile = wg * BQ + ((tid & 127) >> 5) * 16 + (lane >> 2);
    const long long out_w = 2LL * n_seg;
    const int keep = keep_mask();
    float acc[128];
    long long n = 0;  // K-chunks consumed
    for (long long u = u_begin; u < u_end; ++u) {
      for (int c = 0; c < kc; ++c, ++n) {
        const int stage = (int)(n % K_STAGES);
        mbar_wait(full + 8 * stage, (uint32_t)(n / K_STAGES) & 1);
        const uint32_t src = base + stage * K_STAGE_BYTES;
        wgmma_fence();
        mma_chunk(acc, src + wg * Q_CHUNK, src + NCONS * Q_CHUNK, c == 0);
        wgmma_commit();
        if (c > 0) {  // the chunk before this one has been read: free its slot
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + 8 * (int)((n - 1) % K_STAGES));
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * (int)((n - 1) % K_STAGES));
      acc_fence(acc);

      float r[4];
      Top2 top;
      top.init();
      top.add(acc, bias + seg * SEG + low, 0, keep);
      top.finish(low, r);
      if ((lane & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = (long long)qt * NCONS * BQ + row_in_tile + 8 * h;
          if (row < B)
            *reinterpret_cast<float2*>(out + row * out_w + 2 * seg) =
                make_float2(r[2 * h], r[2 * h + 1]);
        }
      }
      if (++qt == n_qt) {
        qt = 0;
        ++seg;
      }
    }
  }
}

// ---- host side -----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime so that the
// library itself links no libcuda.
cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !p) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// Tensor map of a row-major bf16 [rows, d_pad] matrix cut into boxes of
// `box_rows` x 64 with the 128-byte swizzle; out-of-bounds reads as zero.
// Returns 0, a cudaError_t, or a negated CUresult.
int make_map(CUtensorMap* map, const void* ptr, int rows, int d_pad, int box_rows) {
  EncodeTiledFn fn;
  cudaError_t e = encode_fn(&fn);
  if (e != cudaSuccess) return (int)e;
  const cuuint64_t gdim[2] = {(cuuint64_t)d_pad, (cuuint64_t)rows};
  const cuuint64_t gstride[1] = {(cuuint64_t)d_pad * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), gdim, gstride,
                  box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

int sm_count(int* n) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

bool bad_shape(int B, int n_total, int d_pad) {
  return B <= 0 || n_total <= 0 || n_total % SEG != 0 || d_pad <= 0 || d_pad % 16 != 0;
}

template <int KCN>
int launch_resident(const CUtensorMap& map_q, const CUtensorMap& map_t, const float* bias,
                    float* out, int B, int n_seg, int n_qt, long long units, unsigned grid,
                    cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(sweep_resident_kernel<KCN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R_SMEM);
  if (e != cudaSuccess) return (int)e;
  sweep_resident_kernel<KCN><<<grid, NTHREADS, R_SMEM, stream>>>(map_q, map_t, bias, out, B, n_seg,
                                                                 n_qt, units);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launchers enqueue on `stream` and return 0 when the kernel was
// launched, else a cudaError_t (> 0) or a negated CUresult (< 0).

int cozo_fused_sweep_resident(const void* qs, const void* tbl, const void* bias, void* out, int B,
                              int n_total, int d_pad, void* stream) {
  if (bad_shape(B, n_total, d_pad) || d_pad > R_KC * KC) return (int)cudaErrorInvalidValue;
  const int n_seg = n_total / SEG, n_qt = (B + BQ - 1) / BQ;
  const long long units = (long long)((n_seg + R_GROUP - 1) / R_GROUP) * n_qt;
  CUtensorMap map_q, map_t;
  int err = make_map(&map_q, qs, B, d_pad, BQ);
  if (!err) err = make_map(&map_t, tbl, n_total, d_pad, SEG);
  int n_sm = 0;
  if (!err) err = sm_count(&n_sm);
  if (err) return err;
  const unsigned grid = (unsigned)(units < n_sm ? units : n_sm);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  return d_pad <= KC ? launch_resident<1>(map_q, map_t, b, o, B, n_seg, n_qt, units, grid, s)
                     : launch_resident<2>(map_q, map_t, b, o, B, n_seg, n_qt, units, grid, s);
}

int cozo_fused_sweep_kloop(const void* qs, const void* tbl, const void* bias, void* out, int B,
                           int n_total, int d_pad, void* stream) {
  if (bad_shape(B, n_total, d_pad)) return (int)cudaErrorInvalidValue;
  const int n_seg = n_total / SEG, n_qt = (B + NCONS * BQ - 1) / (NCONS * BQ);
  const int kc = (d_pad + KC - 1) / KC;
  const long long units = (long long)n_seg * n_qt;
  CUtensorMap map_q, map_t;
  int err = make_map(&map_q, qs, B, d_pad, NCONS * BQ);
  if (!err) err = make_map(&map_t, tbl, n_total, d_pad, SEG);
  int n_sm = 0;
  if (!err) err = sm_count(&n_sm);
  if (!err)
    err = (int)cudaFuncSetAttribute(sweep_kloop_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K_SMEM);
  if (err) return err;
  const unsigned grid = (unsigned)(units < n_sm ? units : n_sm);
  sweep_kloop_kernel<<<grid, NTHREADS, K_SMEM, (cudaStream_t)stream>>>(
      map_q, map_t, static_cast<const float*>(bias), static_cast<float*>(out), B, n_seg, n_qt, kc,
      units);
  return (int)cudaGetLastError();
}

const char* cozo_cuda_error_string(int err) {
  if (err < 0) return "cuTensorMapEncodeTiled failed (the code is the negated CUresult)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
