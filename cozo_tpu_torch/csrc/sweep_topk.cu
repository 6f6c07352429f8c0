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
// into the dot that feeds it (PartialReduce); the port had split the body
// into a library product that writes the slab and `slab_topk.cu`, which
// reads it back.
//
// Two products:
//   * bf16:  Q [B, d_pad] bf16 . T [n_total, d_pad]^T bf16 -> f32
//            (`wgmma ... f32.bf16.bf16`), key = score + bias[j];
//   * int8:  Q [B, d_pad] s8 . T^T s8 -> s32, exact (`wgmma ... s32.s8.s8`),
//            key = bf16(((float(s32) * c[j]) * r[i]) + bias[j]), with
//            round-to-nearest multiplies and adds, never contracted into an
//            FMA: the JAX i8 body's order and `slab_topk`'s prologue.
// For row i and piece p (columns [p P, (p + 1) P) of the table), the kc
// largest keys come out descending, equal keys by ascending position,
// +0.0 above -0.0, -inf (dead rows) last: the kc largest of the unique
// composites (order_key(key) << 32) | ~position (position within the
// piece), as `exact_knn.select_topk_plain` orders them.  Values in the
// key's type (f32, or bf16 for int8) and ids = p P + position + id_off
// (int64) go to columns [p kc, (p + 1) kc) of the caller's merge buffers.
//
// What bounds it: operations.  At the bf16 shape (B = 16,384 queries,
// n_total = 1,310,720 rows, d_pad = 128) the products are 2 B n_total
// d_pad = 5.50 TFLOP, 5.56 ms at 989 TFLOP/s (0.556 ms a 131,072-row
// piece); the bytes, the table once and the outputs, are a few hundred MB.
// The int8 product runs at twice the rate (2.78 ms).
//
// Design.  A block owns RB = 64 NCONS query rows (one 64-row tile per
// consumer warpgroup, held in shared memory for the whole piece) and
// streams its piece of the table through a ring of 64-row tiles (TMA, the
// 128-byte swizzle), warp-specialised as `fused_sweep.cu`: one producer
// thread issues the loads, each consumer warpgroup issues `wgmma` m64n64
// for its 64 rows against every tile, waits, frees the slot, and selects
// on the accumulator fragment.  With two consumers one's selection falls
// beside the other's products; the products of a tile are complete
// before its selection starts (issue .. wait in straight-line code: an
// asynchronous product left in flight across a branch is serialised by
// ptxas).  Blocks are ordered piece-major, so the blocks on the card at
// one time read the same piece, which L2 holds.
//
// The selection: in the fragment a thread holds rows lane/4 and lane/4 + 8
// of its warp's 16 rows, 16 columns of each per tile, so each row belongs
// to one quad of one warp, and its state to that warp: a threshold t (a
// composite) in the quad's registers.  Pass 1 keys every value (before
// the int8 route's bf16 rounding) and takes each row's maximum; the slot
// is then free.  Only in a warp where some row's maximum reaches its
// row's lower bound (t's key as a float: conservative for +-0.0; on the
// int8 route the bf16 value below t's key) does pass 2 run: a mask of the
// values at or above the bound, and each of them keyed exactly.
//   * kc <= 32 (the bf16 lanes' 26 and 10): each row's top kc is a sorted
//     list in its quad's registers, thread k holding entries 8k ... 8k + 7;
//     a candidate goes in by a count of the entries above it (summed over
//     the quad by two shuffles) and a shift of the rest, and the row's new
//     kc-th entry is t at once.  The eight quads of a warp insert side by
//     side.  Exact by construction: t never falls, and every value above
//     it goes in.
//   * kc > 32: every composite above t is appended to its row's buffer in
//     shared memory (an atomic gives the slot); when a buffer passes HIGH
//     (room for one more tile), the warp sorts it (bitonic, any length),
//     keeps the kc best and raises t to the kc-th.  Exact as
//     `slab_topk.cu`: t always has kc elements of the piece at or above it.
// At the piece's end each warp writes its rows' first kc.
//
// The seed: keys that rise (or fall) along the piece would beat every
// running threshold, a tile after a tile.  So the ring takes the tiles in
// the order e s mod n (n tiles, s coprime to n near 0.618 n: the first
// few fall all over the piece, and t soon sits near the top of the
// piece), and the first ceil(kc / 64) of them (1 for the lists) are the
// seed: their composites fill the buffers and are sorted, the kc best of
// each row are kept (as its list, or in its buffer) and t is the kc-th.
// Each tile is read once.
//
// Shared memory is the budget: RB rows of BUF candidates of 8 bytes, the
// query tile and the ring.  A row may take a whole tile's 64 values before
// it is compacted, so BUF >= kc + 64, and a compaction is cheap only while
// it frees many slots.  Three configurations, chosen by kind and kc:
//   * kc <= 32: two consumers, 128 rows, lists; 64-entry buffers for the
//     seed (64 KB), 32 KB of queries (bf16, d_pad 128), 4 stages of 16 KB;
//   * int8, kc <= 64 (the i8 lane): two consumers, BUF 192 (HIGH 128): 192
//     KB, 16 KB of queries, 2 stages of 8 KB;
//   * the rest (the build's kc 97): one consumer, 64 rows, BUF 320 (HIGH
//     256), 160 KB, 16 KB, 3 stages.  Its selection does not overlap its
//     products.
// A stage holds the tile and its bias (and column scales), so the
// selection reads them from shared memory.
//
// Where trouble is likely, and what the code does about it:
//   1. Positions and ids: 64-bit ids, 32-bit positions within a piece.
//   2. The int8 route is bit-equal to `int_mm` + `select_topk_plain`: exact
//      s32 sums, s32 -> f32 exact (|s| < 2^22 at d_pad <= 128: the magic-
//      number conversion), `__fmul_rn` / `__fadd_rn`, `__float2bfloat16_rn`.
//      The bf16 route's f32 sums follow the tensor core's order, not
//      cuBLAS's: its callers compare with a tolerance.
//   3. Rows past B in the last query tile read zeros (TMA fills out of
//      bounds) and are never written.
//   4. A buffer never overflows: at most 64 appends a row a tile, and a
//      row is compacted as soon as it passes BUF - 64.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef unsigned long long u64;
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr int BM = 64;           // query rows a consumer warpgroup (wgmma M)
constexpr int TN = 64;           // table rows a tile (wgmma N)
constexpr int ROW = 128;         // bytes of a row per TMA box: the swizzle span
constexpr uint32_t T_BOX = TN * ROW;  // 8 KB: a tile's K-chunk
constexpr int MAX_KC = 256;
constexpr int PIECE_ALIGN = 256;  // a piece holds whole tiles and the seed's

// One configuration of the block (see the design note): NCONS consumer
// warpgroups of 64 rows, BUF candidates a row, for kc up to MAXKC (a
// compaction keeps kc of BUF, so MAXKC leaves room for at least 32 more).
template <int NCONS_, int BUF_, int MAXKC_>
struct Cfg {
  static constexpr int NCONS = NCONS_;
  // kc <= 32: the rows' top-kc in registers, the buffers only for the seed
  static constexpr bool LISTS = MAXKC_ <= 32;
  static constexpr int BUF = BUF_;
  static constexpr int HIGH = BUF_ - TN;  // room for one more tile's appends
  static constexpr int MAXKC = MAXKC_;  // the largest kc it takes
  static constexpr int RB = BM * NCONS_;
  static constexpr int NTHREADS = 128 * (NCONS_ + 1);
  static_assert(LISTS ? BUF_ >= TN : HIGH >= MAXKC_, "a list or a compaction keeps kc");
};
typedef Cfg<2, TN, 32> CfgNarrow;    // kc <= 32 (the bf16 lanes): lists
typedef Cfg<2, 192, 64> CfgMid;      // int8, kc <= 64 (the i8 lane)
typedef Cfg<1, 320, MAX_KC> CfgWide;  // the rest (the build's kc 97)
static_assert(CfgWide::BUF >= 4 * TN, "the seed's tiles fit a buffer");

constexpr uint32_t SMEM_MAX = 232448;

// Shared-memory map of a configuration for KIND (0 bf16, 1 int8) with KCN
// K-chunks a row (offsets from a 1,024-byte boundary).  A ring stage holds
// a tile's K-chunks and its bias (and, for int8, its column scales); the
// ring has as many stages as fit, at most 4.
template <class C, int KIND, int KCN>
struct Smem {
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t Q_BOX = C::RB * ROW;
  static constexpr uint32_t VEC = TN * 4 * (KIND == 1 ? 2 : 1);
  static constexpr uint32_t STAGE = KCN * T_BOX + VEC;
  static constexpr uint32_t FIXED = KCN * Q_BOX + C::RB * C::BUF * 8 + C::RB * 4 + 8 + 1024;
  static constexpr int STAGES = (SMEM_MAX - FIXED) / (STAGE + 16) < 4
                                    ? (int)((SMEM_MAX - FIXED) / (STAGE + 16))
                                    : 4;
  static constexpr uint32_t RING = Q + KCN * Q_BOX;
  static constexpr uint32_t BUF = RING + STAGES * STAGE;
  static constexpr uint32_t CNT = BUF + C::RB * C::BUF * 8;
  static constexpr uint32_t BAR = CNT + C::RB * 4;
  static constexpr uint32_t BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(STAGES >= 2 && BYTES <= SMEM_MAX, "shared memory of one block");
};

// ---- PTX wrappers (as in fused_sweep.cu) ----------------------------------

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

// d (+)= A[64 x 16] . B[64 x 16]^T, bf16 from shared memory, f32 sums.
__device__ __forceinline__ void wgmma_step(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " COZO_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : COZO_R32("+f")
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A[64 x 32] . B[64 x 32]^T, s8 from shared memory, exact s32 sums.
__device__ __forceinline__ void wgmma_step(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " COZO_REGS32 ", %32, %33, p;\n}"
      : COZO_R32("+r")
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
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

// ---- keys, composites, sorting --------------------------------------------

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned key_bits(unsigned k) {
  return (k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The float a value's key is compared with before it is keyed exactly: no
// value below it can beat t.  t = 0 (nothing kept): -inf.  bf16 route: t's
// key.  int8 route (keys are bf16 roundings, compared before rounding): the
// bf16 value below t's key, in the order where -0.0 is below +0.0.
template <bool ROUND>
__device__ __forceinline__ float lower_of(u64 t) {
  if (t == 0) return __int_as_float(0xff800000);
  const unsigned b = key_bits((unsigned)(t >> 32));
  if (!ROUND || b == 0xff800000u) return __uint_as_float(b);
  if (b == 0u) return __uint_as_float(0x80000000u);               // +0 -> -0
  return __uint_as_float((b & 0x80000000u) ? b + 0x10000u : b - 0x10000u);
}

// Sorts buf[0, n) descending by one warp: a bitonic network in its flip
// form (every comparator puts the larger first), over n rounded up to a
// power of two; the entries past n are virtual minima that no comparator
// moves, so any n works in place.  Starts and ends with __syncwarp.
__device__ __noinline__ void warp_sort(u64* buf, int n, unsigned lane) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  __syncwarp();
  for (int k = 2; k <= n2; k <<= 1) {
    const int h = k >> 1;
    for (int p = (int)lane; p < (n2 >> 1); p += 32) {
      const int i = ((p & ~(h - 1)) << 1) | (p & (h - 1));  // first half of its block
      const int l = i ^ (k - 1);                            // its mirror
      if (l < n) {
        const u64 a = buf[i], b = buf[l];
        if (a < b) {
          buf[i] = b;
          buf[l] = a;
        }
      }
    }
    __syncwarp();
    for (int j = k >> 2; j > 0; j >>= 1) {
      for (int p = (int)lane; p < (n2 >> 1); p += 32) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i | j;
        if (l < n) {
          const u64 a = buf[i], b = buf[l];
          if (a < b) {
            buf[i] = b;
            buf[l] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

// x[i] for a run-time i, by a tree of selects (an indexed register array
// would go to local memory).
__device__ __forceinline__ float pick32(const float (&x)[32], int i) {
  float a[16], b[8], c[4], d[2];
#pragma unroll
  for (int k = 0; k < 16; ++k) a[k] = (i & 1) ? x[2 * k + 1] : x[2 * k];
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = (i & 2) ? a[2 * k + 1] : a[2 * k];
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = (i & 4) ? b[2 * k + 1] : b[2 * k];
#pragma unroll
  for (int k = 0; k < 2; ++k) d[k] = (i & 8) ? c[2 * k + 1] : c[2 * k];
  return (i & 16) ? d[1] : d[0];
}

// The ring's e-th tile: e stride mod n, stride coprime to n near 0.618 n,
// so that the first tiles fall all over the piece.
__device__ __forceinline__ int tile_of(int e, int n, int stride) {
  return (int)(((long long)e * stride) % n);
}

// e[j] for a run-time j < 8 (selects: no local memory).
__device__ __forceinline__ u64 sel8(const u64 (&e)[8], int j) {
  u64 v = e[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) v = j == k ? e[k] : v;
  return v;
}

__device__ __forceinline__ uint32_t aligned_smem_base(const unsigned char* smem) {
  return ((uint32_t)__cvta_generic_to_shared(smem) + 1023u) & ~1023u;
}

// What the kernel reads and writes beside the two matrices.
struct Args {
  const float* bias;       // [n_total]
  const float* col_scale;  // [n_total] (int8)
  const float* row_scale;  // [B] (int8)
  void* out_v;             // f32 (bf16 route) or bf16 (int8 route)
  long long* out_i;
  long long ldo, id_off;
  int B, piece, kc, n_qt, stride;
};

// Entry o of the outputs from composite cv: the key's value (f32, or
// bf16 for int8) and the id.
template <int KIND>
__device__ __forceinline__ void write_entry(const Args& a, long long o, u64 cv,
                                            long long col_base) {
  const unsigned bits = key_bits((unsigned)(cv >> 32));
  if (KIND == 0)
    static_cast<unsigned*>(a.out_v)[o] = bits;
  else
    static_cast<unsigned short*>(a.out_v)[o] = (unsigned short)(bits >> 16);
  a.out_i[o] = (long long)(~(unsigned)(cv & 0xFFFFFFFFull)) + col_base + a.id_off;
}

// KIND 0: bf16, 1: int8.  KCN: 128-byte K-chunks a row (1 or 2).
template <int KIND, int KCN, class C>
__global__ void __launch_bounds__(C::NTHREADS, 1)
sweep_topk_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_t, const Args a) {
  typedef Smem<C, KIND, KCN> S;
  typedef typename std::conditional<KIND == 0, float, int>::type Acc;
  constexpr bool ROUND = KIND == 1;
  constexpr int ELEMS = ROW / (KIND == 0 ? 2 : 1);  // elements a 128-byte box row

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = aligned_smem_base(smem_raw);
  unsigned char* gbase = smem_raw + (base - raw);
  u64* bufs = reinterpret_cast<u64*>(gbase + S::BUF);
  int* cnt_s = reinterpret_cast<int*>(gbase + S::CNT);
  const uint32_t q_full = base + S::BAR, full = q_full + 8, empty = full + 8 * S::STAGES;

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(FULL, tid >> 7, 0);  // uniform over the warp
  const int piece_idx = (int)(blockIdx.x / (unsigned)a.n_qt);
  const int qt = (int)(blockIdx.x % (unsigned)a.n_qt);
  const long long col_base = (long long)piece_idx * a.piece;
  const int n_tiles = a.piece / TN;
  // the ring's order: each tile once, spread over the piece from the
  // start (`tile_of`); the first n_seed tiles are the seed
  const int n_seed = C::LISTS ? 1 : (a.kc + TN - 1) / TN;
  const int entries = n_tiles;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C::NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int r = tid; r < C::RB; r += C::NTHREADS) cnt_s[r] = 0;
  __syncthreads();

  if (wg == C::NCONS) {
    // ===== producer: the query tile once, then the ring of table tiles =====
    if (tid == 128 * C::NCONS) {
      mbar_expect_tx(q_full, KCN * S::Q_BOX);
      for (int c = 0; c < KCN; ++c)
        tma_load_2d(base + S::Q + c * S::Q_BOX, &map_q, q_full, c * ELEMS, qt * C::RB);
      for (int e = 0; e < entries; ++e) {
        const int stage = e % S::STAGES;
        const uint32_t round = (uint32_t)(e / S::STAGES);
        if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        const int tile = tile_of(e, n_tiles, a.stride);
        const long long col = col_base + (long long)tile * TN;
        const uint32_t dst = base + S::RING + stage * S::STAGE;
        mbar_expect_tx(full + 8 * stage, S::STAGE);
        for (int c = 0; c < KCN; ++c)
          tma_load_2d(dst + c * T_BOX, &map_t, full + 8 * stage, c * ELEMS, (int)col);
        bulk_load(dst + KCN * T_BOX, a.bias + col, TN * 4, full + 8 * stage);
        if (KIND == 1)
          bulk_load(dst + KCN * T_BOX + TN * 4, a.col_scale + col, TN * 4, full + 8 * stage);
      }
    }
    return;
  }

  // ===== consumers =====
  const int lane = tid & 31;
  const int low = 2 * (lane & 3);
  const int wrow0 = wg * BM + ((tid & 127) >> 5) * 16;  // the warp's first row in the block
  int row[2];
  float rs[2];
  u64 t[2];
  float lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = wrow0 + (lane >> 2) + 8 * h;
    const long long g = (long long)qt * C::RB + row[h];
    rs[h] = (KIND == 1 && g < a.B) ? a.row_scale[g] : 1.f;
    t[h] = 0;
    lo[h] = lower_of<ROUND>(0);
  }
  // LISTS: each of the thread's two rows' top kc (sorted, 0 where empty),
  // spread over its quad: thread k of the quad holds entries 8k ... 8k + 7
  u64 E[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) E[h][j] = 0;
  const int qbase = lane & ~3, qk = lane & 3;
  const int tk = (a.kc - 1) >> 3, tj = (a.kc - 1) & 7;  // where the kc-th sits

  mbar_wait(q_full, 0);
  for (int e = 0; e < entries; ++e) {
    const int stage = e % S::STAGES;
    const int tile = tile_of(e, n_tiles, a.stride);
    mbar_wait(full + 8 * stage, (uint32_t)(e / S::STAGES) & 1);
    Acc d[32];
    const uint32_t t_addr = base + S::RING + stage * S::STAGE;
    const uint32_t q_addr = base + S::Q + wg * BM * ROW;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KCN; ++c) {
      const uint64_t da = mma_desc(q_addr + c * S::Q_BOX), db = mma_desc(t_addr + c * T_BOX);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_step(d, da + 2 * ks, db + 2 * ks, c + ks > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    acc_fence(d);

    // ---- pass 1: every value's key before rounding; each row's max
    const float* vec = reinterpret_cast<const float*>(gbase + S::RING + stage * S::STAGE +
                                                      KCN * T_BOX) + low;
    float x[32];
    float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(vec + 8 * j);
      float2 c2 = make_float2(1.f, 1.f);
      if constexpr (KIND == 1) c2 = *reinterpret_cast<const float2*>(vec + TN + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int i = 4 * j + 2 * h + e2;
          if constexpr (KIND == 0) {
            x[i] = __fadd_rn(d[i], e2 ? b.y : b.x);
          } else {
            // |s| < 2^22: s + 1.5 2^23 is exact in f32, and so is the difference
            const float f = __fsub_rn(__int_as_float(d[i] + 0x4B400000), 12582912.f);
            x[i] = __fadd_rn(__fmul_rn(__fmul_rn(f, e2 ? c2.y : c2.x), rs[h]), e2 ? b.y : b.x);
          }
          mx[h] = fmaxf(mx[h], x[i]);
        }
    }
    // the tile's products and vectors are read: the producer may refill the slot
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);

    // ---- pass 2, where a row of the warp may hold a composite above its t:
    // the values at or above their row's lower bound, as a mask, then the
    // exact composite of each (few: a loop over the mask's bits)
    const bool seed = e < n_seed;
    if (!(seed && !C::LISTS) && !__any_sync(FULL, mx[0] >= lo[0] || mx[1] >= lo[1])) continue;
    const int col0 = tile * TN;  // the tile's first column in the piece
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) m |= (x[i] >= lo[(i >> 1) & 1] ? 1u : 0u) << i;
    if (C::LISTS && !seed) {
      // each quad's candidates of row h, one a quad at a time, into the
      // row's list: the quad counts the entries above it and shifts the
      // rest down by one
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned hm = h ? 0xCCCCCCCCu : 0x33333333u;  // bits of row h
        while (true) {
          const unsigned any = __ballot_sync(FULL, (m & hm) != 0);
          if (!any) break;
          const unsigned q4 = (any >> qbase) & 0xFu;
          const bool active = q4 != 0;
          const int src = qbase + (active ? __ffs((int)q4) - 1 : 0);
          const int mine = __ffs((int)(m & hm)) - 1;
          const float xmine = pick32(x, mine & 31);
          const int i = __shfl_sync(FULL, mine, src);
          const float xv = __shfl_sync(FULL, xmine, src);
          if (active && lane == src) m &= ~(1u << i);  // its own lowest of row h
          const float key = ROUND ? bf16_round(xv) : xv;
          const unsigned pos = (unsigned)(col0 + 8 * (i >> 2) + 2 * (src & 3) + (i & 1));
          const u64 cv = ((u64)order_key(key) << 32) | (u64)(~pos);
          int c = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) c += E[h][j] > cv;
          c += __shfl_xor_sync(FULL, c, 1);
          c += __shfl_xor_sync(FULL, c, 2);
          const u64 prev = __shfl_up_sync(FULL, E[h][7], 1);
          if (active && c < a.kc) {
            u64 nv[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int g = 8 * qk + j;
              nv[j] = g > c ? (j ? E[h][j - 1] : prev) : (g == c ? cv : E[h][j]);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) E[h][j] = nv[j];
          }
          const u64 nt = __shfl_sync(FULL, sel8(E[h], tj), qbase + tk);
          if (active) {
            t[h] = nt;
            lo[h] = lower_of<ROUND>(nt);
          }
        }
      }
      continue;
    }
    {
      // into the row buffers: every composite above the row's t
      while (m) {
        const int i = __ffs((int)m) - 1;
        m &= m - 1;
        const int h = (i >> 1) & 1;
        const float xv = pick32(x, i);
        const float key = ROUND ? bf16_round(xv) : xv;
        const unsigned pos = (unsigned)(col0 + 8 * (i >> 2) + low + (i & 1));
        const u64 cv = ((u64)order_key(key) << 32) | (u64)(~pos);
        if (cv > (h ? t[1] : t[0])) {
          const int r = h ? row[1] : row[0];
          const int slot = atomicAdd(cnt_s + r, 1);
          bufs[(size_t)r * C::BUF + slot] = cv;
        }
      }
      if (e < n_seed - 1) continue;  // the seed's tiles: no compaction yet
      __syncwarp();
      if constexpr (C::LISTS) {
        // the seed tile's composites: each row's kc best become its list
        for (int r = wrow0; r < wrow0 + 16; ++r)
          warp_sort(bufs + (size_t)r * C::BUF, cnt_s[r], (unsigned)lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const u64* buf = bufs + (size_t)row[h] * C::BUF;
#pragma unroll
          for (int j = 0; j < 8; ++j) E[h][j] = 8 * qk + j < a.kc ? buf[8 * qk + j] : 0;
          t[h] = buf[a.kc - 1];
          lo[h] = lower_of<ROUND>(t[h]);
        }
        continue;
      }
      // rows past HIGH (after the seed: every row): keep the kc best, raise t
      // to the kc-th
      const bool lead = (lane & 3) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // bit 4q: quad q's row h, wrow0 + q + 8 h
        unsigned need = __ballot_sync(FULL, lead && (e == n_seed - 1 || cnt_s[row[h]] > C::HIGH));
        while (need) {
          const int r = wrow0 + ((__ffs((int)need) - 1) >> 2) + 8 * h;
          need &= need - 1;
          u64* buf = bufs + (size_t)r * C::BUF;
          warp_sort(buf, cnt_s[r], (unsigned)lane);
          const u64 nt = buf[a.kc - 1];
          if (r == row[h]) {
            t[h] = nt;
            lo[h] = lower_of<ROUND>(nt);
          }
          __syncwarp();
          if (lane == 0) cnt_s[r] = a.kc;
          __syncwarp();
        }
      }
    }
  }

  // ---- the piece's end: the first kc of each row, written out
  if constexpr (C::LISTS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long g = (long long)qt * C::RB + row[h];
      if (g >= a.B) continue;
      const long long o = g * a.ldo + (long long)piece_idx * a.kc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 8 * qk + j;
        if (i < a.kc) write_entry<KIND>(a, o + i, E[h][j], col_base);
      }
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      const long long g = (long long)qt * C::RB + wrow0 + r;
      if (g >= a.B) break;  // rows past B: the rest of the warp's are too
      const long long o = g * a.ldo + (long long)piece_idx * a.kc;
      u64* buf = bufs + (size_t)(wrow0 + r) * C::BUF;
      warp_sort(buf, cnt_s[wrow0 + r], (unsigned)lane);
      for (int i = lane; i < a.kc; i += 32) write_entry<KIND>(a, o + i, buf[i], col_base);
      __syncwarp();
    }
  }
}

// ---- host side -----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

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

// Tensor map of a row-major [rows, d_pad] matrix of bf16 (kind 0) or int8
// (kind 1), boxes of `box_rows` rows x 128 bytes, 128-byte swizzle, zeros
// out of bounds.  Returns 0, a cudaError_t, or a negated CUresult.
int make_map(CUtensorMap* map, const void* ptr, long long rows, int d_pad, int kind, int box_rows) {
  EncodeTiledFn fn;
  cudaError_t e = encode_fn(&fn);
  if (e != cudaSuccess) return (int)e;
  const int esize = kind == 0 ? 2 : 1;
  const cuuint64_t gdim[2] = {(cuuint64_t)d_pad, (cuuint64_t)rows};
  const cuuint64_t gstride[1] = {(cuuint64_t)d_pad * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(ROW / esize), (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  CUresult r = fn(map, kind == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                  2, const_cast<void*>(ptr), gdim, gstride, box, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

template <int KIND, int KCN, class C>
int launch(const void* q, const void* tbl, long long n_total, int d_pad, Args a,
           cudaStream_t stream) {
  typedef Smem<C, KIND, KCN> S;
  a.n_qt = (a.B + C::RB - 1) / C::RB;
  const long long blocks = (n_total / a.piece) * (long long)a.n_qt;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_t;
  int err = make_map(&map_q, q, a.B, d_pad, KIND, C::RB);
  if (!err) err = make_map(&map_t, tbl, n_total, d_pad, KIND, TN);
  if (!err)
    err = (int)cudaFuncSetAttribute(sweep_topk_kernel<KIND, KCN, C>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::BYTES);
  if (err) return err;
  sweep_topk_kernel<KIND, KCN, C><<<(unsigned)blocks, C::NTHREADS, S::BYTES, stream>>>(map_q, map_t,
                                                                                      a);
  return (int)cudaGetLastError();
}

// The block configuration of a kind at kc: 0 narrow, 1 mid (int8), 2 wide.
int config_of(int kind, int kc) {
  if (kc <= CfgNarrow::MAXKC) return 0;
  return kind == 1 && kc <= CfgMid::MAXKC ? 1 : 2;
}

template <int KIND, int KCN>
int launch_kc(const void* q, const void* tbl, long long n_total, int d_pad, const Args& a,
              cudaStream_t s) {
  const int c = config_of(KIND, a.kc);
  if (c == 0) return launch<KIND, KCN, CfgNarrow>(q, tbl, n_total, d_pad, a, s);
  if constexpr (KIND == 1) {  // the mid configuration is int8's alone
    if (c == 1) return launch<KIND, KCN, CfgMid>(q, tbl, n_total, d_pad, a, s);
  }
  return launch<KIND, KCN, CfgWide>(q, tbl, n_total, d_pad, a, s);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

}  // namespace

extern "C" {

// Enqueues the chunk step on `stream`.  q [B, d_pad] and tbl [n_total,
// d_pad], row-major, bf16 (kind 0) or int8 (kind 1), 16-byte aligned;
// bias [n_total] f32; col_scale [n_total] and row_scale [B] f32 for int8
// (null for bf16).  out_v (f32, or bf16 for int8) and out_i (int64) hold
// B rows `ldo` apart; piece p writes its kc columns from p kc on, ids =
// p piece + position + id_off.  Needs B >= 1, d_pad % 16 == 0, d_pad <=
// 128, piece % 256 == 0, n_total % piece == 0, 1 <= kc <= min(256, piece),
// ldo >= kc n_total / piece.  Returns 0 when the kernel was launched, else
// a cudaError_t (> 0) or a negated CUresult (< 0).
// Allocates nothing, does not synchronise.
int cozo_sweep_topk(const void* q, const void* tbl, int kind, int B, long long n_total, int d_pad,
                    int piece, int kc, const void* bias, const void* col_scale,
                    const void* row_scale, void* out_v, void* out_i, long long ldo,
                    long long id_off, void* stream) {
  if (kind < 0 || kind > 1 || B < 1 || d_pad < 16 || d_pad % 16 || d_pad > 128 || piece < PIECE_ALIGN ||
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
  a.n_qt = 0;
  const int n_tiles = piece / TN;
  a.stride = (int)(0.6180339887 * n_tiles);
  while (gcd(a.stride, n_tiles) != 1) ++a.stride;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 1) return launch_kc<1, 1>(q, tbl, n_total, d_pad, a, s);
  return d_pad <= 64 ? launch_kc<0, 1>(q, tbl, n_total, d_pad, a, s)
                     : launch_kc<0, 2>(q, tbl, n_total, d_pad, a, s);
}

// The query rows a block owns for this kind at this kc (the launch's tile).
int cozo_sweep_topk_rows(int kind, int kc) {
  const int c = config_of(kind, kc);
  return c == 0 ? CfgNarrow::RB : c == 1 ? CfgMid::RB : CfgWide::RB;
}

const char* cozo_cuda_error_string(int err) {
  if (err < 0) return "cuTensorMapEncodeTiled failed (the code is the negated CUresult)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
