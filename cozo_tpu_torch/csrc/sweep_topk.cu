// The sweep lanes' chunk step for Hopper (sm_90a): each query row's scores
// against a column piece of the resident table, and that piece's exact
// top-kc, in one kernel.  The [B x piece] score slab never reaches device
// memory.
//
// Replaces the chunk body that the JAX package writes as one program:
// `dot_general` + bias, then `lax.approx_max_k`, in `_sweep_fn`'s scan
// (cozo_tpu/ops/exact_knn.py:100-123), `_sweep_fn_i8`'s
// (cozo_tpu/ops/exact_knn.py:199-213) and `_build_step_fn`'s
// (cozo_tpu/ops/bulk_build.py:137-147).  On the TPU `approx_max_k` fuses
// into the dot that feeds it (PartialReduce).  The same body for the f32
// lane (`_sweep_fn` at compute_dtype "f32": a true-f32 product, which no
// tensor-core format gives bit for bit) is `sweep_topk_f32.cu`: FFMA
// chains, with this file's selection half (`sweep_select.cuh`, KIND 0).
//
// Two products:
//   * bf16:  Q [B, d_pad] bf16 . T [n_total, d_pad]^T bf16 -> f32
//            (`wgmma ... f32.bf16.bf16`), key = score + bias[j];
//   * int8:  Q [B, d_pad] s8 . T^T s8 -> s32, exact (`wgmma ... s32.s8.s8`),
//            key = bf16(((float(s32) * c[j]) * r[i]) + bias[j]), with
//            round-to-nearest multiplies and adds, never contracted into an
//            FMA: the JAX i8 body's order and `slab_topk`'s prologue.
// For row i and piece p (columns [p P, (p + 1) P) of the table) the kc
// largest of the unique composites (order_key(key) << 32) | ~position
// (position within the piece), as `exact_knn.select_topk_plain` orders
// them; values in the key's type (f32, or bf16 for int8) and ids = p P +
// position + id_off (int64) go to columns [p kc, (p + 1) kc) of the
// caller's merge buffers.  The selection is `sweep_select.cuh`.
//
// What bounds it: operations.  At the bf16 shape (B = 16,384 queries,
// n_total = 1,310,720 rows, d_pad = 128) the products are 2 B n_total
// d_pad = 5.50 TFLOP, 5.56 ms at 989 TFLOP/s; the bytes, the table once and
// the outputs, a few hundred MB.  The int8 product runs at twice the rate
// (2.78 ms).  Beside that bound, three floors of this design: the ring and
// the products alone (6.8 ms at the bf16 shape on an H100 at 700 W, from a
// diagnostic build that selected nothing; PERF.md §6); the table tiles'
// traffic from L2 to the SMs (B / rows a block / cluster copies of the
// table: `chip_ubench.py` streams 7.77 TB/s to 128 blocks, 9.25 TB/s with
// pairs sharing each tile); and the selection's
// issue slots (pass 1 a bound a row on the bf16 route, about 1.5
// instructions a score; six on the int8 route).  The selection, not the
// products, sets the time: what a warp does beside its products holds its
// three siblings at the next `wgmma` (`.sync.aligned`).
//
// Design.  A block owns RB = 64 NCONS query rows (one 64-row tile per
// consumer warpgroup) and streams its piece of the table through a ring of
// 64-row tiles (TMA, 128-byte swizzle), warp-specialised: a producer
// warpgroup (one thread issues the loads; `setmaxnreg` gives its registers
// to the consumers) and NCONS consumer warpgroups that issue `wgmma` m64n64
// for their 64 rows against each tile and select on the accumulator
// fragment.  Each element below was weighed on the card in turns against
// the others and against the first design (`chip_graph_vs.py --kernel
// sweep_topk`, on switches since folded in or removed; PERF.md §6):
//   * A from registers: each consumer reads its 64 query rows' `wgmma` A
//     fragments once from the swizzled tile (from shared memory at every
//     tile it was 1-15% slower).
//   * Two accumulator sets: tile e + 1's products are issued before tile
//     e's pass 1 and waited for before its pass 2, so only straight-line
//     code lies between an issue and its wait (ptxas serialises the
//     products if branchy code, or any instruction reading the set in
//     flight, does; waiting before pass 1 was up to 4% slower at the
//     build step, even elsewhere).  The loop is unrolled by two and its
//     last two tiles peeled: a piece holds an even number of tiles.
//   * Clusters of 2 for the bf16 lists (the bf16 lanes' 128-row blocks):
//     each block's producer loads 32 rows of every tile with
//     `.multicast::cluster` into both blocks, so a tile leaves L2 once a
//     pair (21.5 GB a launch at the bf16 shape, not 42.9).  A slot's
//     "empty" barrier counts the consumer warps of both blocks (arrived
//     remotely through `mapa`); each producer waits for its slots' last
//     releases before it exits, so no block leaves while the other still
//     arrives on its barriers.  A block past the last query tile (a ragged
//     last pair) loads its share, releases its slots and selects nothing.
//     The int8 route and the heads' 64-row blocks run alone: there the
//     pair, which waits for its slower block, lost 1-5%.
//   * The row state (`sweep_select.cuh`): kc <= 32 a sorted list in the
//     quads' registers, each candidate in as it comes; kc <= 64 lists of
//     16 fed through a short tail of appends in shared memory, inserted in
//     bulk (a warp's stall on the lists, spread over many tiles); kc > 64
//     a sorted head and a tail of appends, merged by a sort of the tail
//     and a bitonic merge.  No shared buffer of kc + 64 entries a row.
// Configurations, by kc (both kinds), and the ring's stages (as many as
// the shared memory holds, at most MAX_STAGES: bf16 at d_pad 128, then
// int8 and bf16 at d_pad <= 64):
//   * kc <= 32: two consumers, 128 rows, lists of 8 a thread a row; 11 / 12;
//   * kc <= 64 (the i8 lane's 64): two consumers, 128 rows, lists of 16, a
//     tail of 72 a row (72.5 KB); 7 / 12;
//   * kc <= 128 (the build's 97): one consumer, 64 rows, head 128 + tail 128
//     (128 KB); 5 / 10;
//   * kc <= 256: one consumer, 64 rows, head 256 + tail 64 (160 KB); 3 / 6.
// A ring stage holds the tile; its bias (and column scales) sit beside the
// ring, one vector a stage, so the selection reads them from shared memory.
// The tiles go in the order e s mod n (s coprime to n near 0.618 n): keys
// that rise along the table meet their top early, and both blocks of a
// pair walk the same order.
//
// Where trouble is likely, and what the code does about it:
//   1. Positions and ids: 64-bit ids, 32-bit positions within a piece.
//   2. The int8 route is bit-equal to `int_mm` + `select_topk_plain`: exact
//      s32 sums, s32 -> f32 as `.float()` rounds (|s| <= 128 127^2 < 2^22
//      at d_pad <= 128: the magic-number conversion, exact; the wide
//      kernel's sums reach 4,096 127^2 = 66,064,384 > 2^24:
//      `__int2float_rn`, exact below 2^24 (d_pad <= 1,040), past it
//      rounded to nearest even, as `.float()` and the JAX package's
//      `s32.astype(jnp.float32)` round), `__fmul_rn` / `__fadd_rn`,
//      `__float2bfloat16_rn`.
//      The bf16 route's f32 sums follow the tensor core's order, not
//      cuBLAS's: its callers compare with a tolerance.
//   3. Rows past B in the last query tile read zeros (TMA fills out of
//      bounds) and are never written.
//   4. A tail never overflows: at most 64 appends a row a tile, and a row
//      is merged as soon as it passes TAIL - 64.
//   5. A multicast load may land in a block before that block's producer
//      announced the stage's bytes: the barrier's transaction count goes
//      below zero for a while, and its phase cannot end before the local
//      arrival.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "sweep_select.cuh"

namespace {

using namespace cozo_hopper;
using namespace cozo_sweep;

constexpr int ROW = 128;              // bytes of a row per TMA box: the swizzle span
constexpr uint32_t T_BOX = TN * ROW;  // 8 KB: a tile's K-chunk
constexpr int MAX_STAGES = 12;        // the ring's most (8 were up to 3% slower)

// The cluster of a kind's row state: the bf16 lists' 128-row blocks share
// their 16 KB tiles in pairs; the int8 route's 8 KB tiles and the 64-row
// blocks of the heads are faster alone (in turns on the card: the pair
// waits for its slower block's releases).
constexpr int cluster_of(int kind, int mode) { return kind == 0 && mode <= LIST16 ? 2 : 1; }
template <int KIND, int MODE>
using CfgK = CfgOf<MODE, cluster_of(KIND, MODE)>;

constexpr uint32_t SMEM_MAX = 232448;

// Shared-memory map of a configuration for KIND (0 bf16, 1 int8) with KCN
// K-chunks a row (offsets from a 1,024-byte boundary): the query tile, the
// ring's tiles, the ring's vectors, the selection's rows, the barriers.
template <class C, int KIND, int KCN>
struct Smem {
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t Q_BOX = C::RB * ROW;
  static constexpr uint32_t TILE = KCN * T_BOX;
  static constexpr uint32_t VEC = TN * 4 * (KIND == 1 ? 2 : 1);
  static constexpr uint32_t FIXED = KCN * Q_BOX + C::SEL_BYTES + 8 + 1024 + 16;
  static constexpr int FIT = (int)((SMEM_MAX - FIXED) / (TILE + VEC + 16));
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr uint32_t RING = Q + KCN * Q_BOX;
  static constexpr uint32_t VECS = RING + STAGES * TILE;
  static constexpr uint32_t SEL = VECS + STAGES * VEC;
  static constexpr uint32_t BAR = (SEL + C::SEL_BYTES + 15u) & ~15u;
  static constexpr uint32_t BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "shared memory of one block");
};

// ---- PTX wrappers ----------------------------------------------------------

// Arrives on the barrier at the same offset in block `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// The box into the same offset of every block in `mask`, each block's
// barrier at `bar`'s offset completing its bytes.
__device__ __forceinline__ void tma_load_2d_mc(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// K-major tile, 128-byte rows, 128-byte swizzle: 8-row groups 1,024 B apart.
__device__ __forceinline__ uint64_t mma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#define COZO_R4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define COZO_R32(c)                                                                          \
  COZO_R4(c, 0), COZO_R4(c, 4), COZO_R4(c, 8), COZO_R4(c, 12), COZO_R4(c, 16), COZO_R4(c, 20), \
      COZO_R4(c, 24), COZO_R4(c, 28)
#define COZO_REGS32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A[64 x 16] . B[64 x 16]^T (bf16, f32 sums) or A[64 x 32] .
// B[64 x 32]^T (s8, exact s32 sums), A from registers (each thread's
// fragment, as `mma.sync`'s m16n8k16 / m16n8k32 A holds a warp's 16 rows),
// B from shared memory.
__device__ __forceinline__ void wgmma_step(float (&d)[32], const uint32_t (&qa)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " COZO_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      : COZO_R32("+f")
      : "r"(qa[0]), "r"(qa[1]), "r"(qa[2]), "r"(qa[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_step(int (&d)[32], const uint32_t (&qa)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " COZO_REGS32
      ", {%32, %33, %34, %35}, %36, p;\n}"
      : COZO_R32("+r")
      : "r"(qa[0]), "r"(qa[1]), "r"(qa[2]), "r"(qa[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving uses of the accumulators across the
// asynchronous products (it emits no instruction).
__device__ __forceinline__ void acc_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void acc_fence(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t aligned_smem_base(const unsigned char* smem) {
  return ((uint32_t)__cvta_generic_to_shared(smem) + 1023u) & ~1023u;
}

// KIND 0: bf16, 1: int8.  KCN: 128-byte K-chunks a row (1 or 2).  The grid
// is pieces x n_qt_c blocks (n_qt query tiles rounded up to the cluster),
// piece-major, so a cluster's blocks share a piece.
template <int KIND, int KCN, class C>
__global__ void __launch_bounds__(C::NTHREADS, 1)
sweep_topk_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_t, const Args a) {
  typedef Smem<C, KIND, KCN> S;
  typedef typename std::conditional<KIND == 0, float, int>::type Acc;
  constexpr int ELEMS = ROW / (KIND == 0 ? 2 : 1);  // elements a 128-byte box row
  constexpr int SHARE = TN / C::CLUSTER;            // tile rows each block loads

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = aligned_smem_base(smem_raw);
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t q_full = base + S::BAR, full = q_full + 8, empty = full + 8 * S::STAGES;

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(FULL, tid >> 7, 0);  // uniform over the warp
  const int piece_idx = (int)(blockIdx.x / (unsigned)a.n_qt_c);
  const int qt = (int)(blockIdx.x % (unsigned)a.n_qt_c);
  const bool idle = qt >= a.n_qt;  // past the last query tile: loads and releases only
  const int n_tiles = a.piece / TN;
  const uint32_t rank = C::CLUSTER > 1 ? cluster_rank() : 0u;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C::NCONS * C::CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (C::CLUSTER > 1)
    cluster_sync();  // no block's loads or arrivals reach a barrier not yet made
  else
    __syncthreads();

  if (wg == C::NCONS) {
    // ===== producer: the query tile once, then its share of every table tile
    if constexpr (C::NCONS > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 128 * C::NCONS) {
      if (!idle) {
        mbar_expect_tx(q_full, KCN * S::Q_BOX);
        for (int c = 0; c < KCN; ++c)
          tma_load_2d(base + S::Q + c * S::Q_BOX, &map_q, q_full, c * ELEMS, qt * C::RB);
      }
      const long long col_base = (long long)piece_idx * a.piece;
      for (int e = 0, tile = 0; e < n_tiles; ++e, tile = next_tile(tile, a.stride, n_tiles)) {
        const int stage = e % S::STAGES;
        const uint32_t round = (uint32_t)(e / S::STAGES);
        if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        const long long col = col_base + (long long)tile * TN;
        const uint32_t dst = base + S::RING + stage * S::TILE, bar = full + 8 * stage;
        mbar_expect_tx(bar, S::TILE + S::VEC);
        for (int c = 0; c < KCN; ++c) {
          if constexpr (C::CLUSTER > 1)
            tma_load_2d_mc(dst + c * T_BOX + rank * (SHARE * ROW), &map_t, bar, c * ELEMS,
                           (int)(col + rank * SHARE), (uint16_t)((1u << C::CLUSTER) - 1));
          else
            tma_load_2d(dst + c * T_BOX, &map_t, bar, c * ELEMS, (int)col);
        }
        const uint32_t vec = base + S::VECS + stage * S::VEC;
        bulk_load(vec, a.bias + col, TN * 4, bar);
        if (KIND == 1) bulk_load(vec + TN * 4, a.col_scale + col, TN * 4, bar);
      }
      // every slot's last release, the other blocks' included: no arrival
      // reaches this block's barriers after it has left
      for (int e = n_tiles; e < n_tiles + S::STAGES; ++e) {
        const uint32_t round = (uint32_t)(e / S::STAGES);
        if (round > 0) mbar_wait(empty + 8 * (e % S::STAGES), (round - 1) & 1);
      }
    }
    return;
  }

  // ===== consumers =====
  if constexpr (C::NCONS > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int lane = tid & 31;
  // frees stage s in every block of the cluster (lane 0, after the warp's reads)
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < C::CLUSTER; ++r) mbar_arrive_cluster(empty + 8 * stage, (uint32_t)r);
    }
  };
  if (idle) {
    for (int e = 0; e < n_tiles; ++e) {
      mbar_wait(full + 8 * (e % S::STAGES), (uint32_t)(e / S::STAGES) & 1);
      release(e % S::STAGES);
    }
    return;
  }

  Select<C, KIND> sel;
  sel.init(tid, qt, a, gbase + S::SEL);
  // the warpgroup's query rows as wgmma A fragments, read once from the
  // swizzled tile: k-step ks of chunk c, register j holds row lane / 4
  // (+ 8 for odd j) of the warp's 16, the 4 bytes at 16-byte unit 2 ks +
  // j / 2 (XOR the row's place in its 8-row group) + 4 (lane % 4)
  uint32_t qa[4 * KCN][4];

  // tile e's products into d, once its stage has landed
  auto issue = [&](Acc(&d)[32], int e) {
    const int stage = e % S::STAGES;
    mbar_wait(full + 8 * stage, (uint32_t)(e / S::STAGES) & 1);
    const uint32_t t_addr = base + S::RING + stage * S::TILE;
    acc_fence(d);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KCN; ++c) {
      const uint64_t db = mma_desc(t_addr + c * T_BOX);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_step(d, qa[4 * c + ks], db + 2 * ks, c + ks > 0);
    }
    wgmma_commit();
  };
  auto vec_of = [&](int e) {
    return reinterpret_cast<const float*>(gbase + S::VECS + (e % S::STAGES) * S::VEC);
  };
  // Tile e, whose products d are finished; `next` issues tile e + 1's into
  // the other set.  Only pass 1 and the vote, straight-line code that never
  // reads the set in flight, lie between that issue and its wait (ptxas
  // serialises the products otherwise); pass 2 runs after the wait.
  int tile = 0;  // tile e's place in the piece
  auto step = [&](Acc(&d)[32], int e, auto&& next) {
    next();
    float x[32], mx[2];
    sel.pass1(d, vec_of(e), x, mx);
    const bool need = sel.need(mx, tile);
    wgmma_wait<0>();
    // the bf16 route's pass 2 reads the bias again: the slot is freed after it
    if (KIND == 1) release(e % S::STAGES);
    if (need) sel.select(d, x, tile, vec_of(e));
    if (KIND == 0) release(e % S::STAGES);
    tile = next_tile(tile, a.stride, n_tiles);
  };

  mbar_wait(q_full, 0);
  {
    const int r = wg * BM + ((tid & 127) >> 5) * 16 + (lane >> 2);  // the thread's first row
#pragma unroll
    for (int c = 0; c < KCN; ++c)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rr = r + 8 * (j & 1);
          const uint32_t off = S::Q + c * S::Q_BOX + rr * ROW +
                               ((((2 * ks + (j >> 1)) ^ (rr & 7)) << 4) | (4 * (lane & 3)));
          qa[4 * c + ks][j] = *reinterpret_cast<const uint32_t*>(gbase + off);
        }
  }
  Acc d0[32], d1[32];
  issue(d0, 0);
  wgmma_wait<0>();
  acc_fence(d0);
  int e = 0;
  for (; e < n_tiles - 2; e += 2) {
    step(d0, e, [&] { issue(d1, e + 1); });
    acc_fence(d1);
    step(d1, e + 1, [&] { issue(d0, e + 2); });
    acc_fence(d0);
  }
  step(d0, e, [&] { issue(d1, e + 1); });
  acc_fence(d1);
  step(d1, e + 1, [] {});
  sel.finish(a, piece_idx);
}

// ---- the wide rows: 128 < d_pad <= WIDE_MAX_D ------------------------------
//
// The same chunk step at rows of up to 8,192 bytes (bf16 d_pad 4,096: the
// 7B-LLM embedders; 1,536 and 3,072 are OpenAI's), where the narrow
// kernel's design does not fit: its consumers hold the query rows' A
// fragments in registers (192 a thread at bf16 d_pad 768) and its ring
// holds whole tiles (96 KB at bf16 d_pad 768).  Here:
//   * 64 query rows a block, every row state, and blocks in pairs sharing
//     each table tile by multicast (each loads 32 rows);
//   * `wgmma` with A from shared memory (SS form; A from registers, read
//     once a chunk for two tiles, was slower: PERF.md §6) and the ring's
//     stages one 128-byte K-chunk of a 64-row tile (8 KB): a tile's
//     products are kcn = ceil(d_pad bytes / 128) chunks of four k-steps
//     (kcn 2-64), for `wide_tiles` tiles at once (a group: 4 with the lists
//     of 8, 2 past), chunk by chunk, into as many accumulator sets.  bf16:
//     the group's stages of a chunk lie side by side (the stages a multiple
//     of the group), so each chunk is one product of N = 128 / 256
//     (`wide_merge`), one in flight past the one issued; int8: one product
//     a tile, the tiles in turns (their chains: one kept the tensor cores
//     at 26-27% of their peak at bf16 d_pad 768, two 39%, four 43%;
//     splitting a tile's chunks over two sets moved its sums off cuBLAS's
//     order).  A chunk's stages are freed once a later product is issued
//     and it is done (the CUTLASS main loop's shape).  Nothing here depends
//     on kcn but the length of a group's sequence (G kcn chunks, 256 at
//     bf16 4,096 with the lists of 8, 16 times the ring);
//   * two consumer warpgroups on the block's 64 rows for the lists, and
//     for the heads where the query rows stay resident beside their state
//     (`wide_two`), one where the heads' state streams them.  Consumer c
//     takes the groups c, c + 2, ...: while one selects its group, the
//     other multiplies the next.  A consumer starts a group's products only
//     once the other has waited for every chunk of the group before
//     (`pturn`): the ring is shorter than a group, and a wait on a stage
//     whose earlier chunk has not landed would pass on the parity of the
//     round before.  So each consumer waits for the ring's stages in the
//     sequence's order, however long a group is.  The lists are each
//     consumer's (registers), merged through the ring at the end; the heads
//     and tails in shared memory are one state, selected in turns (named
//     barriers 1 and 2), each consumer reading the other's raised t first
//     (`sync_t`);
//   * the query rows resident in shared memory (kcn boxes of 64 x 128 B,
//     loaded once) where that leaves MIN_WIDE_STAGES stages (and two
//     products' worth) beside the row state, else streamed: a box with the
//     first stage of each product, in a ring of their own beside the
//     table's (a product's A chunk is freed with its stages) -- the heads'
//     configurations, whose state is 128-160 KB a block, and past 128 KB
//     of rows (bf16 past d_pad 1,024, int8 past 2,048) every row state;
//   * the tiles' bias (and column scales) go through a ring of their own,
//     `wide_vecs` slots with their own barriers, each freed after its tile's
//     selection (held in a chunk's stage, they would pin it while the next
//     tile's chunks wrap the ring onto it).
// Where its time went before the second consumer (diagnostic copies of the
// source, in turns at phase 3b's [4,096 x 2,097,152] x 768 on an H100 at
// 700 W: `chip_graph_vs.py --make-wide-copies`, PERF.md §6): the ring
// alone 15.1 ms (bf16) / 8.0-12.0 (int8), the products alone 15.7 / 10.6-
// 10.9, both 24.1 / 11.5-16.2, of a chunk step of 28.5 / 26.0-26.5 ms: the
// selection after the products was 15% of it in bf16 and 38-57% in int8,
// which the second consumer hides (int8 kc 128 1.25x, bf16 kc 26 1.07x,
// in turns); L2 misses cost 4-5 ms where the pairs of a piece drift apart.
// Traffic: the table leaves L2 once a pair of blocks, table x B / 128
// bytes a launch (103.1 GB at bf16 kc 26 there, 51.5 GB int8, 206.2 GB
// for the build's 8,192 rows), and where A is streamed, A once a product
// (a quarter more with the lists of 8, a half more past them, in bf16;
// as much again as the table in int8); the ring alone here streamed 6.8
// TB/s out of L2 (15.1 ms of bf16 kc 26's 103.1 GB), `chip_ubench.py`'s
// pairs 4.6-4.8 TB/s.  Clusters of 4 (a chunk out of L2 once for 256 rows)
// lost 1.3-2.1x: fewer fit on the card.
// Shared memory of a block (232,448 bytes; `wide_layout`'s map; a stage 8
// KB, and 8 KB of A a product where A is streamed; the vectors' ring 1-8
// KB; A resident at d_pad 768 / 1,024: bf16 96 / 128 KB, int8 48 / 64 KB),
// the configurations at d_pad 768:
//   * lists of 8 (no state): two consumers, A resident; bf16 12 stages;
//   * lists of 16 (a tail of 72 a row, 36.3 KB): two consumers, A resident;
//   * head 128 (128.3 KB): int8 two consumers, A resident (5 stages); bf16
//     one consumer, A streamed (two with A resident to d_pad 256; at 384 and
//     768 two consumers' larger vector ring leaves too few stages for A,
//     and two streaming consumers lost 1.17x at 768);
//   * head 256 (160.3 KB): one consumer, A streamed (int8: two, resident, to
//     d_pad 256).
// At d_pad 1,536 (and to 4,096) the lists stream A in bf16 (two consumers,
// 16 / 14 stages); int8 keeps them resident to 2,048 (1,536: 15 / 11
// stages) and streams past; the heads as at 768 (int8 head 128 one
// consumer, streamed, past 768).  `wide_fits` holds every configuration to
// a block's shared memory at every d_pad to WIDE_MAX_D at compile time.
// What bounds it: operations (bf16 2 B n d_pad at 989 TFLOP/s, int8 at
// 1,979 TOP/s); beside it the L2 stream above.
constexpr int WIDE_MAX_D = 4096;
constexpr int MIN_WIDE_STAGES = 5;   // with A resident; else A streamed
constexpr int MAX_WIDE_STAGES = 16;  // 128 KB of chunks: past the L2 latency
static_assert(WIDE_MAX_D % 16 == 0, "`wide_fits` steps d_pad to WIDE_MAX_D by 16");
// Tiles whose products a wide block keeps in flight at once, by row state:
// four with the lists of 8 (their state is in registers already), two past.
__host__ __device__ constexpr int wide_tiles(int mode) { return mode == LIST8 ? 4 : 2; }
// The vectors' slots: two groups of tiles a consumer.
__host__ __device__ constexpr int wide_vecs(int mode, int nc) { return 2 * nc * wide_tiles(mode); }
// The ring's stages one product reads: bf16 the group's tiles side by side
// as one `wgmma` of N = 64 wide_tiles (7-17% faster at d_pad 768 than one
// a tile), int8 one a tile (2-4% slower merged; PERF.md §6).
__host__ __device__ constexpr int wide_merge(int kind, int mode) {
  return kind == 0 ? wide_tiles(mode) : 1;
}
constexpr uint32_t Q_WBOX = BM * ROW;  // 8 KB: the query rows' K-chunk

// The runtime map of a wide configuration (offsets from a 1,024-byte
// boundary): A (resident) at 0, the ring's table chunks, the ring's A
// chunks (A streamed: one a product's stages), the vectors' slots, the
// selection's rows, the barriers (q_full, the stages' full and empty, the
// slots' full and empty).
struct Wide {
  int kcn, stages, stream;
  uint32_t ring, aring, vecs, sel, bar, bytes;
};

template <int KIND, class C>
constexpr Wide wide_layout(int d_pad) {
  constexpr uint32_t sel_bytes = C::SEL_BYTES;
  constexpr int WIDE_VECS = wide_vecs(C::MODE, C::NC);
  constexpr int MG = wide_merge(KIND, C::MODE);
  constexpr uint32_t VEC = TN * 4 * (KIND == 1 ? 2 : 1);
  Wide w{};
  w.kcn = (d_pad * (KIND == 0 ? 2 : 1) + ROW - 1) / ROW;
  // the selection, the vectors' slots and barriers, q_full, the alignment
  const uint32_t fixed = sel_bytes + 16 + WIDE_VECS * (VEC + 16) + 8 + 1024;
  const int least = MIN_WIDE_STAGES > 2 * MG ? MIN_WIDE_STAGES : 2 * MG;
  for (w.stream = 0; w.stream < 2; ++w.stream) {
    const uint32_t a_res = w.stream ? 0u : w.kcn * Q_WBOX;
    // MG stages and, A streamed, their product's A chunk
    const uint32_t per = MG * (T_BOX + 16) + (w.stream ? Q_WBOX : 0u);
    const int fit =
        a_res + fixed >= SMEM_MAX ? 0 : (int)((SMEM_MAX - a_res - fixed) / per) * MG;
    const int most = MAX_WIDE_STAGES / MG * MG;
    w.stages = fit < most ? fit : most;
    w.ring = a_res;
    if (w.stream || w.stages >= least) break;
  }
  w.aring = w.ring + w.stages * T_BOX;
  w.vecs = w.aring + (w.stream ? (uint32_t)(w.stages / MG) * Q_WBOX : 0u);
  w.sel = w.vecs + WIDE_VECS * VEC;
  w.bar = (w.sel + sel_bytes + 15u) & ~15u;
  w.bytes = w.bar + 8 * (1 + 2 * w.stages + 2 * WIDE_VECS + C::NC) + 1024;
  return w;
}

// Whether the launch takes the layout: two products' stages at least (and
// three), the two consumers' lists' merge (64 rows of 4 L entries) within
// the ring, the whole within a block's shared memory.
template <int KIND, class C>
constexpr bool wide_ok(const Wide& w) {
  constexpr int MG = wide_merge(KIND, C::MODE);
  constexpr int least = 2 * MG > 3 ? 2 * MG : 3;
  constexpr uint32_t merge_bytes = C::NC > 1 && C::LISTS ? 64u * 4 * C::L * 8 : 0u;
  return w.stages >= least && (uint32_t)w.stages * T_BOX >= merge_bytes && w.bytes <= SMEM_MAX;
}

// The wide configuration of (KIND, MODE) at d_pad: two consumers for the
// lists, and for the heads where the query rows stay resident beside their
// state; one where the heads' state streams them (two lost there: PERF.md
// section 6).
template <int KIND, int MODE>
constexpr bool wide_two(int d_pad) {
  return MODE <= LIST16 || !wide_layout<KIND, WideCfg<MODE, 2>>(d_pad).stream;
}

// Every d_pad of the wide form, 144 to WIDE_MAX_D, takes (KIND, MODE)'s
// configuration: asserted below for the eight, so that no width the entry
// accepts is refused at launch for want of shared memory.
template <int KIND, int MODE>
constexpr bool wide_fits() {
  for (int d = 144; d <= WIDE_MAX_D; d += 16) {
    const bool ok = wide_two<KIND, MODE>(d)
                        ? wide_ok<KIND, WideCfg<MODE, 2>>(wide_layout<KIND, WideCfg<MODE, 2>>(d))
                        : wide_ok<KIND, WideCfg<MODE, 1>>(wide_layout<KIND, WideCfg<MODE, 1>>(d));
    if (!ok) return false;
  }
  return true;
}
static_assert(wide_fits<0, LIST8>() && wide_fits<0, LIST16>() && wide_fits<0, HEAD128>() &&
                  wide_fits<0, HEAD256>(),
              "bf16: every wide configuration to WIDE_MAX_D fits a block");
static_assert(wide_fits<1, LIST8>() && wide_fits<1, LIST16>() && wide_fits<1, HEAD128>() &&
                  wide_fits<1, HEAD256>(),
              "int8: every wide configuration to WIDE_MAX_D fits a block");

#define COZO_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define COZO_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (+)= A[64 x 16] . B[64 x 16]^T (bf16, f32 sums) or A[64 x 32] .
// B[64 x 32]^T (s8, exact s32 sums), both from shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " COZO_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : COZO_R32("+f")
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " COZO_REGS32 ", %32, %33, p;\n}"
      : COZO_R32("+r")
      : "l"(da), "l"(db), "r"(acc));
}

// The same for 2 or 4 tiles side by side in shared memory as one product
// of N = 128 / 256: the accumulators of tile t are dt (the fragment of
// columns 64 t ... is laid out as an m64n64 one).
#define COZO_Q4(c, a, i) c(a[i]), c(a[i + 1]), c(a[i + 2]), c(a[i + 3])
#define COZO_Q32(c, a)                                                                  \
  COZO_Q4(c, a, 0), COZO_Q4(c, a, 4), COZO_Q4(c, a, 8), COZO_Q4(c, a, 12), COZO_Q4(c, a, 16), \
      COZO_Q4(c, a, 20), COZO_Q4(c, a, 24), COZO_Q4(c, a, 28)
__device__ __forceinline__ void wgmma_ss2(float (&d0)[32], float (&d1)[32], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " COZO_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}"
      : COZO_Q32("+f", d0), COZO_Q32("+f", d1)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss2(int (&d0)[32], int (&d1)[32], uint64_t da, uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " COZO_REGS64 ", %64, %65, p;\n}"
      : COZO_Q32("+r", d0), COZO_Q32("+r", d1)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss4(float (&d0)[32], float (&d1)[32], float (&d2)[32],
                                          float (&d3)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " COZO_REGS128
      ", %128, %129, p, 1, 1, 0, 0;\n}"
      : COZO_Q32("+f", d0), COZO_Q32("+f", d1), COZO_Q32("+f", d2), COZO_Q32("+f", d3)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss4(int (&d0)[32], int (&d1)[32], int (&d2)[32],
                                          int (&d3)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " COZO_REGS128 ", %128, %129, p;\n}"
      : COZO_Q32("+r", d0), COZO_Q32("+r", d1), COZO_Q32("+r", d2), COZO_Q32("+r", d3)
      : "l"(da), "l"(db), "r"(acc));
}

template <class A>
__device__ __forceinline__ void wgmma_group(A (&d)[2][32], uint64_t da, uint64_t db, int acc) {
  wgmma_ss2(d[0], d[1], da, db, acc);
}

template <class A>
__device__ __forceinline__ void wgmma_group(A (&d)[4][32], uint64_t da, uint64_t db, int acc) {
  wgmma_ss4(d[0], d[1], d[2], d[3], da, db, acc);
}

// Arrives on the barrier at `bar`'s offset in block `cta` where p, with no
// branch (it runs while products are in flight).
__device__ __forceinline__ void mbar_arrive_cluster_if(uint32_t bar, uint32_t cta, bool p) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 ra;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [ra];\n}" ::"r"(bar),
      "r"(cta), "r"((int)p)
      : "memory");
}

// Arrives on this block's barrier at `bar` where p, with no branch.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool p) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}" ::"r"(bar),
      "r"((int)p)
      : "memory");
}

// The named barrier `id` of `n` threads: wait for them, or only arrive.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// KIND 0: bf16, 1: int8.  The grid as the narrow kernel's; the tiles go in
// groups (e, ..., e + G - 1) of the stride order, and the ring's sequence
// holds chunk c of the group's tile t at g = e kcn + G c + t, stage g mod
// stages (a multiple of the stages a product reads, so that a merged
// product's stages lie side by side).
template <int KIND, class C>
__global__ void __launch_bounds__(C::NTHREADS, 1)
sweep_topk_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_t, const Args a, const Wide w) {
  static_assert(C::RB == BM && C::CLUSTER == 2, "the wide configuration");
  typedef typename std::conditional<KIND == 0, float, int>::type Acc;
  constexpr int NC = C::NC;
  constexpr int ELEMS = ROW / (KIND == 0 ? 2 : 1);
  constexpr int SHARE = TN / C::CLUSTER;
  constexpr uint32_t VEC = TN * 4 * (KIND == 1 ? 2 : 1);
  constexpr int G = wide_tiles(C::MODE);
  constexpr int MG = wide_merge(KIND, C::MODE);
  constexpr int WIDE_VECS = wide_vecs(C::MODE, NC);
  // two consumers share the row state in shared memory: they select their
  // groups in turns (named barriers 1 and 2, a consumer's turn each)
  constexpr bool TURNS = NC > 1 && C::TAIL > 0;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = aligned_smem_base(smem_raw);
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t q_full = base + w.bar, full = q_full + 8, empty = full + 8 * w.stages;
  const uint32_t vfull = empty + 8 * w.stages, vempty = vfull + 8 * WIDE_VECS;
  const uint32_t pturn = vempty + 8 * WIDE_VECS;  // consumer c's turn to multiply

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(FULL, tid >> 7, 0);
  const int piece_idx = (int)(blockIdx.x / (unsigned)a.n_qt_c);
  const int qt = (int)(blockIdx.x % (unsigned)a.n_qt_c);
  const bool idle = qt >= a.n_qt;
  const int n_tiles = a.piece / TN;
  const int kcn = w.kcn;
  const uint32_t rank = cluster_rank();

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < w.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C::CLUSTER);  // one consumer's warps a block
    }
    for (int s = 0; s < WIDE_VECS; ++s) {
      mbar_init(vfull + 8 * s, 1);
      mbar_init(vempty + 8 * s, 4);  // the consumer warps of this block's tile
    }
    for (int c = 0; c < NC; ++c) mbar_init(pturn + 8 * c, 4);  // the other consumer's warps
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (wg == NC) {
    // ===== producer: the query rows once (or a chunk with a product's
    // first stage), each tile's vectors (not for an idle block), its share
    // of every table chunk
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 128 * NC) {
      const bool own_a = w.stream && !idle;
      if (!idle && !w.stream) {
        mbar_expect_tx(q_full, kcn * Q_WBOX);
        for (int c = 0; c < kcn; ++c)
          tma_load_2d(base + c * Q_WBOX, &map_q, q_full, c * ELEMS, qt * C::RB);
      }
      const long long col_base = (long long)piece_idx * a.piece;
      int stage = 0;
      uint32_t round = 0;
      for (int e = 0, tile = 0; e < n_tiles; e += G) {
        long long col[G];
        for (int t = 0; t < G; ++t, tile = next_tile(tile, a.stride, n_tiles)) {
          col[t] = col_base + (long long)tile * TN;
          if (idle) continue;
          const int v = (e + t) % WIDE_VECS;
          if (e + t >= WIDE_VECS)
            mbar_wait(vempty + 8 * v, (uint32_t)((e + t) / WIDE_VECS - 1) & 1);
          const uint32_t vec = base + w.vecs + v * VEC;
          mbar_expect_tx(vfull + 8 * v, VEC);
          bulk_load(vec, a.bias + col[t], TN * 4, vfull + 8 * v);
          if (KIND == 1) bulk_load(vec + TN * 4, a.col_scale + col[t], TN * 4, vfull + 8 * v);
        }
        for (int c = 0; c < kcn; ++c)
          for (int t = 0; t < G; ++t) {
            if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
            const uint32_t bar = full + 8 * stage;
            const bool with_a = own_a && stage % MG == 0;
            mbar_expect_tx(bar, T_BOX + (with_a ? Q_WBOX : 0u));
            tma_load_2d_mc(base + w.ring + stage * T_BOX + rank * (SHARE * ROW), &map_t, bar,
                           c * ELEMS, (int)(col[t] + rank * SHARE),
                           (uint16_t)((1u << C::CLUSTER) - 1));
            if (with_a)
              tma_load_2d(base + w.aring + (stage / MG) * Q_WBOX, &map_q, bar, c * ELEMS,
                          qt * C::RB);
            if (++stage == w.stages) {
              stage = 0;
              ++round;
            }
          }
      }
      // every slot's last release, the other block's included
      for (int i = 0; i < w.stages; ++i) {
        if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        if (++stage == w.stages) {
          stage = 0;
          ++round;
        }
      }
    }
    return;
  }

  // ===== the consumer warpgroups: consumer c the groups c, c + NC, ... =====
  if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cons = wg;
  const int lane = tid & 31;
  // frees stage g's slot in both blocks of the pair (after the warp's reads)
  auto release = [&](int g) {
    const uint32_t bar = empty + 8 * (uint32_t)(g % w.stages);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < C::CLUSTER; ++r) mbar_arrive_cluster_if(bar, (uint32_t)r, lane == 0);
  };
  const int n_chunks = n_tiles * kcn;
  if (idle) {
    if (cons > 0) return;
    for (int g = 0; g < n_chunks; ++g) {
      mbar_wait(full + 8 * (g % w.stages), (uint32_t)(g / w.stages) & 1);
      release(g);
    }
    return;
  }

  Select<C, KIND, true> sel;
  sel.init(tid & 127, qt, a, gbase + w.sel);  // every consumer: the block's rows
  if (!w.stream) mbar_wait(q_full, 0);
  const int n_groups = n_tiles / G;
  // the first group's turn, once this consumer's share of the state is clear
  if (TURNS && cons == 1) {
    __threadfence_block();
    named_arrive(1, 256);
  }

  auto vec_of = [&](int e) {
    const int v = e % WIDE_VECS;
    mbar_wait(vfull + 8 * v, (uint32_t)(e / WIDE_VECS) & 1);
    return reinterpret_cast<const float*>(gbase + w.vecs + v * VEC);
  };
  auto free_vec = [&](int e) {
    __syncwarp();
    if (lane == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(vempty + 8 * (e % WIDE_VECS))
                   : "memory");
  };
  // a product's n stages from g's on landed; its A and B descriptors
  auto wait_stages = [&](int g, int n) {
    const int stage = g % w.stages;
    for (int t = 0; t < n; ++t) mbar_wait(full + 8 * (stage + t), (uint32_t)(g / w.stages) & 1);
  };
  auto desc_a = [&](int g, int c) {
    const int stage = g % w.stages;
    return mma_desc(w.stream ? base + w.aring + (stage / MG) * Q_WBOX : base + c * Q_WBOX);
  };
  auto desc_b = [&](int g) { return mma_desc(base + w.ring + (g % w.stages) * T_BOX); };
  // chunk c of one tile, at g in the ring's sequence, into d (added to it
  // where acc), once its stage has landed
  auto issue = [&](Acc(&d)[32], int g, int c, bool acc) {
    wait_stages(g, 1);
    const uint64_t da = desc_a(g, c), db = desc_b(g);
    acc_fence(d);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_ss(d, da + 2 * ks, db + 2 * ks, acc || ks > 0);
    wgmma_commit();
  };
  // the e-th tile's selection on its products d (its place `tile`), then
  // its vectors' slot freed
  auto select_tile = [&](const Acc(&d)[32], int e, int tile) {
    const float* vec = vec_of(e);
    float x[32], mx[2];
    sel.pass1(d, vec, x, mx);
    if (sel.need(mx, tile)) sel.select(d, x, tile, vec);
    free_vec(e);
  };
  Acc d[G][32];
  // bf16: chunk c of every tile of the group, its G stages from g on, as
  // one product of N = 64 G
  auto issue_group = [&](int g, int c, bool acc) {
    wait_stages(g, G);
    const uint64_t da = desc_a(g, c), db = desc_b(g);
#pragma unroll
    for (int t = 0; t < G; ++t) acc_fence(d[t]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_group(d, da + 2 * ks, db + 2 * ks, acc || ks > 0);
    wgmma_commit();
  };
  auto free_group = [&](int g) {
#pragma unroll
    for (int t = 0; t < G; ++t) release(g + t);
  };
  // two consumers: every chunk of the group has landed (this consumer
  // waited for each), so the other may wait for its next group's chunks,
  // whose stages held this group's (a wait on a stage two rounds ahead of
  // its barrier would pass: the parity repeats)
  auto pass_on = [&] {
    if constexpr (NC > 1) {
      __syncwarp();
      mbar_arrive_if(pturn + 8 * (1 - cons), lane == 0);
    }
  };
  // the group's chunks one product each, one in flight past the one issued
  auto products_merged = [&](int g0) {
    for (int c = 0; c < kcn; ++c) {
      issue_group(g0 + G * c, c, c > 0);
      wgmma_wait<1>();
      if (c > 0) free_group(g0 + G * (c - 1));
    }
    pass_on();
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < G; ++t) acc_fence(d[t]);
    free_group(g0 + G * (kcn - 1));
  };
  // int8: the products of the group of G tiles whose chunks start at g0:
  // chunk c of tile t into d[t] (G chains of dependent products in flight
  // at once), each chunk's stage freed once G - 1 later ones are issued and
  // it is done.
  auto products_tiles = [&](int g0) {
#pragma unroll
    for (int t = 0; t < G; ++t) {
      issue(d[t], g0 + t, 0, false);
      wgmma_wait<G - 1>();
      if (t == G - 1) release(g0);
    }
    for (int c = 1; c < kcn; ++c) {
#pragma unroll
      for (int t = 0; t < G; ++t) {
        issue(d[t], g0 + G * c + t, c, true);
        wgmma_wait<G - 1>();
        release(g0 + G * c + t - G + 1);
      }
    }
    pass_on();
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < G; ++t) acc_fence(d[t]);
    for (int k = G * kcn - G + 1; k < G * kcn; ++k) release(g0 + k);
  };
  int tile = 0;  // the place of this consumer's next tile: tile_of(e)
  for (int t = 0; t < cons * G; ++t) tile = next_tile(tile, a.stride, n_tiles);
  for (int j = cons, k = 0; j < n_groups; j += NC, ++k) {
    const int e = j * G;
    // the other consumer's products of group j - 1 issued (its k-th turn
    // for the second consumer, its (k - 1)-th for the first)
    if (NC > 1 && (cons > 0 || k > 0))
      mbar_wait(pturn + 8 * cons, (uint32_t)(cons > 0 ? k : k - 1) & 1);
    if (MG > 1)
      products_merged(e * kcn);
    else
      products_tiles(e * kcn);
    if constexpr (TURNS) {  // the other consumer has selected group j - 1
      named_sync(1 + cons, 256);
      sel.sync_t();
    }
#pragma unroll
    for (int t = 0; t < G; ++t) {
      select_tile(d[t], e + t, tile);
      tile = next_tile(tile, a.stride, n_tiles);
    }
    for (int t = 0; t < (NC - 1) * G; ++t) tile = next_tile(tile, a.stride, n_tiles);
    if (TURNS && j + 1 < n_groups) {  // group j + 1's turn
      __threadfence_block();
      named_arrive(2 - cons, 256);
    }
  }
  if constexpr (NC > 1) {
    // every group selected and every chunk landed: the ring is free, and
    // the second consumer's lists go through it into the first's
    named_sync(3, 256);
    if constexpr (C::LISTS) {
      u64* lists = reinterpret_cast<u64*>(gbase + w.ring);
      if (cons == 1) sel.dump_lists(lists);
      named_sync(3, 256);
      if (cons == 0) sel.merge_lists(lists);
    }
    if (cons > 0) return;
  }
  sel.finish(a, piece_idx);
}

// ---- host side -----------------------------------------------------------

// Tensor map of a row-major [rows, d_pad] matrix of bf16 (kind 0) or int8
// (kind 1), boxes of `box_rows` rows x 128 bytes, 128-byte swizzle, zeros
// out of bounds.  Returns 0, a cudaError_t, or a negated CUresult.
int make_map(CUtensorMap* map, const void* ptr, long long rows, int d_pad, int kind, int box_rows) {
  const int esize = kind == 0 ? 2 : 1;
  return encode_2d(map, kind == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                   esize, ptr, rows, d_pad, ROW / esize, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The launch configuration of `kernel` with `blocks` blocks (a multiple of
// the cluster), its shared memory allowed first.
template <class C, class K>
cudaError_t launch_config(K kernel, uint32_t bytes, unsigned blocks, cudaStream_t stream,
                          cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(C::NTHREADS);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C::CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int KIND, int KCN, class C>
int launch(const void* q, const void* tbl, long long n_total, int d_pad, Args a,
           cudaStream_t stream) {
  typedef Smem<C, KIND, KCN> S;
  a.n_qt = (a.B + C::RB - 1) / C::RB;
  a.n_qt_c = (a.n_qt + C::CLUSTER - 1) / C::CLUSTER * C::CLUSTER;
  const long long blocks = (n_total / a.piece) * (long long)a.n_qt_c;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_t;
  int err = make_map(&map_q, q, a.B, d_pad, KIND, C::RB);
  if (!err) err = make_map(&map_t, tbl, n_total, d_pad, KIND, TN / C::CLUSTER);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  auto kernel = sweep_topk_kernel<KIND, KCN, C>;
  err = (int)launch_config<C>(kernel, S::BYTES, (unsigned)blocks, stream, &cfg, &attr);
  if (err) return err;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, map_q, map_t, a);
  return err ? err : (int)cudaGetLastError();
}

// The blocks of the configuration that the card holds at once (clusters x
// their size), or minus a cudaError_t.
template <int KIND, int KCN, class C>
int slots() {
  typedef Smem<C, KIND, KCN> S;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  auto kernel = sweep_topk_kernel<KIND, KCN, C>;
  cudaError_t e = launch_config<C>(kernel, S::BYTES, 1024u * C::CLUSTER, nullptr, &cfg, &attr);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n * C::CLUSTER : -(int)e;
}

// One function of a (kind, K-chunks) pair, dispatched on kc's row state.
template <int KIND, int KCN>
int launch_kc(const void* q, const void* tbl, long long n_total, int d_pad, const Args& a,
              cudaStream_t s) {
  switch (mode_of(a.kc)) {
    case LIST8: return launch<KIND, KCN, CfgK<KIND, LIST8>>(q, tbl, n_total, d_pad, a, s);
    case LIST16: return launch<KIND, KCN, CfgK<KIND, LIST16>>(q, tbl, n_total, d_pad, a, s);
    case HEAD128: return launch<KIND, KCN, CfgK<KIND, HEAD128>>(q, tbl, n_total, d_pad, a, s);
    default: return launch<KIND, KCN, CfgK<KIND, HEAD256>>(q, tbl, n_total, d_pad, a, s);
  }
}

template <int KIND, int KCN>
int slots_kc(int kc) {
  switch (mode_of(kc)) {
    case LIST8: return slots<KIND, KCN, CfgK<KIND, LIST8>>();
    case LIST16: return slots<KIND, KCN, CfgK<KIND, LIST16>>();
    case HEAD128: return slots<KIND, KCN, CfgK<KIND, HEAD128>>();
    default: return slots<KIND, KCN, CfgK<KIND, HEAD256>>();
  }
}

template <int KIND, class C>
int launch_wide(const void* q, const void* tbl, long long n_total, int d_pad, Args a,
                cudaStream_t stream) {
  const Wide w = wide_layout<KIND, C>(d_pad);
  // a piece's chunks are counted in int (the ring's sequence)
  if (!wide_ok<KIND, C>(w) || (long long)(a.piece / TN) * w.kcn > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  a.n_qt = (a.B + C::RB - 1) / C::RB;
  a.n_qt_c = (a.n_qt + C::CLUSTER - 1) / C::CLUSTER * C::CLUSTER;
  const long long blocks = (n_total / a.piece) * (long long)a.n_qt_c;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_t;
  int err = make_map(&map_q, q, a.B, d_pad, KIND, C::RB);
  if (!err) err = make_map(&map_t, tbl, n_total, d_pad, KIND, TN / C::CLUSTER);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  auto kernel = sweep_topk_wide_kernel<KIND, C>;
  err = (int)launch_config<C>(kernel, w.bytes, (unsigned)blocks, stream, &cfg, &attr);
  if (err) return err;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, map_q, map_t, a, w);
  return err ? err : (int)cudaGetLastError();
}

template <int KIND, class C>
int slots_wide(int d_pad) {
  const Wide w = wide_layout<KIND, C>(d_pad);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  auto kernel = sweep_topk_wide_kernel<KIND, C>;
  cudaError_t e = launch_config<C>(kernel, w.bytes, 1024u * C::CLUSTER, nullptr, &cfg, &attr);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n * C::CLUSTER : -(int)e;
}

template <int KIND, int MODE>
int launch_wide_mode(const void* q, const void* tbl, long long n_total, int d_pad, const Args& a,
                     cudaStream_t s) {
  if constexpr (MODE > LIST16)
    if (!wide_two<KIND, MODE>(d_pad))
      return launch_wide<KIND, WideCfg<MODE, 1>>(q, tbl, n_total, d_pad, a, s);
  return launch_wide<KIND, WideCfg<MODE, 2>>(q, tbl, n_total, d_pad, a, s);
}

template <int KIND, int MODE>
int slots_wide_mode(int d_pad) {
  if constexpr (MODE > LIST16)
    if (!wide_two<KIND, MODE>(d_pad)) return slots_wide<KIND, WideCfg<MODE, 1>>(d_pad);
  return slots_wide<KIND, WideCfg<MODE, 2>>(d_pad);
}

template <int KIND>
int launch_wide_kc(const void* q, const void* tbl, long long n_total, int d_pad, const Args& a,
                   cudaStream_t s) {
  switch (mode_of(a.kc)) {
    case LIST8: return launch_wide_mode<KIND, LIST8>(q, tbl, n_total, d_pad, a, s);
    case LIST16: return launch_wide_mode<KIND, LIST16>(q, tbl, n_total, d_pad, a, s);
    case HEAD128: return launch_wide_mode<KIND, HEAD128>(q, tbl, n_total, d_pad, a, s);
    default: return launch_wide_mode<KIND, HEAD256>(q, tbl, n_total, d_pad, a, s);
  }
}

template <int KIND>
int slots_wide_kc(int d_pad, int kc) {
  switch (mode_of(kc)) {
    case LIST8: return slots_wide_mode<KIND, LIST8>(d_pad);
    case LIST16: return slots_wide_mode<KIND, LIST16>(d_pad);
    case HEAD128: return slots_wide_mode<KIND, HEAD128>(d_pad);
    default: return slots_wide_mode<KIND, HEAD256>(d_pad);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// Enqueues the chunk step on `stream`.  q [B, d_pad] and tbl [n_total,
// d_pad], row-major, bf16 (kind 0) or int8 (kind 1), 16-byte aligned;
// bias [n_total] f32; col_scale [n_total] and row_scale [B] f32 for int8
// (null for bf16).  out_v (f32, or bf16 for int8) and out_i (int64) hold
// B rows `ldo` apart; piece p writes its kc columns from p kc on, ids =
// p piece + position + id_off.  Needs B >= 1, d_pad % 16 == 0, d_pad <=
// WIDE_MAX_D (4,096), piece % 256 == 0, n_total % piece == 0, 1 <= kc <= min(256, piece),
// ldo >= kc n_total / piece.  d_pad <= 128 runs the narrow kernel, wider
// rows the wide one.  Returns 0 when the kernel was launched, else
// a cudaError_t (> 0) or a negated CUresult (< 0).
// Allocates nothing, does not synchronise.
int cozo_sweep_topk(const void* q, const void* tbl, int kind, int B, long long n_total, int d_pad,
                    int piece, int kc, const void* bias, const void* col_scale,
                    const void* row_scale, void* out_v, void* out_i, long long ldo,
                    long long id_off, void* stream) {
  if (kind < 0 || kind > 1 || B < 1 || d_pad < 16 || d_pad % 16 || d_pad > WIDE_MAX_D ||
      piece < PIECE_ALIGN ||
      piece % PIECE_ALIGN || n_total < piece || n_total % piece || kc < 1 || kc > MAX_KC ||
      kc > piece || ldo < (long long)kc * (n_total / piece) || !bias ||
      (kind == 1) != (col_scale != nullptr) || (kind == 1) != (row_scale != nullptr) ||
      !aligned16(q) || !aligned16(tbl) || !aligned16(bias) ||
      (col_scale && !aligned16(col_scale)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.bias = static_cast<const float*>(bias);
  a.col_scale = static_cast<const float*>(col_scale);
  a.row_scale = static_cast<const float*>(row_scale);
  a.out_v = out_v;
  a.out_i = static_cast<long long*>(out_i);
  a.ldo = ldo;
  a.id_off = id_off;
  a.B = B;
  a.piece = piece;
  a.kc = kc;
  a.n_qt = a.n_qt_c = 0;
  a.stride = stride_of(piece / TN);
  cudaStream_t s = (cudaStream_t)stream;
  if (d_pad > 128)
    return kind == 1 ? launch_wide_kc<1>(q, tbl, n_total, d_pad, a, s)
                     : launch_wide_kc<0>(q, tbl, n_total, d_pad, a, s);
  if (kind == 1) return launch_kc<1, 1>(q, tbl, n_total, d_pad, a, s);
  return d_pad <= 64 ? launch_kc<0, 1>(q, tbl, n_total, d_pad, a, s)
                     : launch_kc<0, 2>(q, tbl, n_total, d_pad, a, s);
}

// The query rows a block owns for this kind, d_pad and kc (the launch's
// tile).
int cozo_sweep_topk_rows(int kind, int d_pad, int kc) {
  (void)kind;
  if (d_pad > 128) return BM;
  return mode_of(kc) <= LIST16 ? CfgOf<LIST8, 1>::RB : CfgOf<HEAD128, 1>::RB;
}

// The blocks in a cluster for this kind, d_pad and kc (the launch rounds the
// query tiles up to it).
int cozo_sweep_topk_cluster(int kind, int d_pad, int kc) {
  return d_pad > 128 ? WideCfg<LIST8, 2>::CLUSTER : cluster_of(kind, mode_of(kc));
}

// The blocks of the launch for (kind, d_pad, kc) that the card holds at
// once, or minus a cudaError_t.
int cozo_sweep_topk_slots(int kind, int d_pad, int kc) {
  if (d_pad > 128) return kind == 1 ? slots_wide_kc<1>(d_pad, kc) : slots_wide_kc<0>(d_pad, kc);
  if (kind == 1) return slots_kc<1, 1>(kc);
  return d_pad <= 64 ? slots_kc<0, 1>(kc) : slots_kc<0, 2>(kc);
}

// The three counters of a build with COZO_SWEEP_COUNTERS (`sweep_select.
// cuh`) into out (three int64), then zeroed; -1 in a build without them.
int cozo_sweep_topk_counts(void* out) {
#ifdef COZO_SWEEP_COUNTERS
  cudaError_t e = cudaMemcpyFromSymbol(out, sweep_counts, sizeof(unsigned long long) * 3);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[3] = {0, 0, 0};
  return (int)cudaMemcpyToSymbol(sweep_counts, zero, sizeof(zero));
#else
  (void)out;
  return -1;
#endif
}

const char* cozo_cuda_error_string(int err) {
  if (err < 0) return "cuTensorMapEncodeTiled failed (the code is the negated CUresult)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
