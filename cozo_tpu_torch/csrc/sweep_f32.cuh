// The f32 kind of the sweep lanes' chunk step (`sweep_topk_f32.cu`): a
// block's query rows against a piece of the table in true f32, each score
// one `fmaf` chain over k ascending from +0.0f (no tensor-core format gives
// those bits), and the piece's exact top-kc per row, taken on the sums as
// each 64-row tile of the piece is finished.  No score reaches device
// memory.  The block's loop is here and not in the `.cu` so that
// `tests/test_torch_sweep_select_host_f32.py` can compile it with g++
// against a stand-in CUDA runtime (the threads of a block as fibers) and
// hold the product and the selection to `exact_knn.select_topk_plain` bit
// for bit; the includer gives the copy into shared memory (`Copy`:
// `cp.async` on the card, a plain copy on the host).
//
// The product.  67 TFLOP/s in f32 is every scheduler issuing an FFMA every
// clock, so the loop is counted in issue slots: a thread holds RV
// accumulator fragments in `wgmma` m64n64's register layout (2 rows x 16
// columns each: register i is column 8 (i >> 2) + 2 (lane & 3) + (i & 1)
// of row lane / 4 + 8 ((i >> 1) & 1) of its warp's 16 rows of the
// fragment's 64), the layout the selection (`sweep_select.cuh`) reads, and
// every 4 k it reads each of its 2 RV rows and each of its 16 columns once,
// as one 128-bit shared load: 16 + 2 RV loads for 128 RV FFMAs (RV = 2:
// 20 for 256, 93% of the slots; RV = 1: 18 for 128, 88%).  Measured on an
// H100 at 1,980 MHz (PERF.md section 6): the loop fed from shared
// memory alone reaches 58.5% of the f32 peak, not 93% (fewer loads, other
// orders of the FFMAs and the unrolling move it by under 10%); the ring
// costs 11% and the selection 2% beside it.  Rows and columns
// sit in shared memory as they are in device memory, [row][k], each row
// padded by 4 floats so that the 8 rows (or the 4 columns 2 apart) a load
// instruction meets fall in distinct banks.  The table streams in K-slices
// of 32 floats of each of a tile's 64 rows (a ring of `stages` slices,
// `cp.async`); the query rows stay resident where d_pad <= 128 and stream
// beside the table's slices past it, to MAX_D (RB rows of d_pad floats
// fill a block's shared memory past a few hundred: 64 KB at 128, 2 MB at
// 4,096).  A stage is one K-slice whatever d_pad is, so nothing else
// depends on the width but the slices a tile (n_ks, 128 at MAX_D).
// A slice of 16 ends a row whose d_pad is an odd multiple of 16: the chain
// is exactly d_pad long, with no padding term.  Where the caller gives the
// rows' real width d_real (the columns past it +0.0 in the queries and in
// the table, as the sweep table and `prepare_queries` pad them), the chain
// stops at k_end, d_real rounded up to 4, and adds +0.0f once: a padded
// product (+0) x (+0) changes a sum only from -0.0 to +0.0, and so does
// that one add, so the sums are the bits of the padded chain's with
// (d_pad - k_end) / d_pad fewer FFMAs (22% at the lanes' 100 of 128).
//
// The block: the row state's query rows (`F32Cfg`: 128 for the lists, 64
// for the heads, whose state fills the shared memory), RV = 2 for the
// lists of 8 (the lanes' kc 10 and 26: two m64n64 fragments, two `Select`s
// a thread, 128 threads, 254 registers), RV = 1 past them (a thread a
// fragment: the lists of 16 hold 64 registers a fragment).  The lists of 8
// at RV = 1 (256 threads) were 1.26-1.39x slower (PERF.md section 6).

#pragma once

#include "sweep_select.cuh"

namespace cozo_f32 {

using namespace cozo_sweep;

constexpr int KS = 32;                // floats of a row in a K-slice
constexpr int LD = KS + 4;            // a slice row's floats in shared memory
constexpr int MAX_STAGES = 4;         // slices in flight, at most (3-6 time alike)
// 4-k steps of a whole slice unrolled together: 4 (an 18 KB loop body),
// 6-9% faster than 1, 2 or the whole slice's 8 (PERF.md section 6)
constexpr int UNROLL = 4;
constexpr unsigned SMEM_MAX = 232448; // a block's shared memory on sm_90
constexpr unsigned SMEM_SM = 233472;  // an SM's, 1 KB of it reserved a block
constexpr int RESIDENT_D = 128;       // query rows resident up to this d_pad
constexpr int MAX_D = 4096;           // the widest row (d_pad) the entry takes
static_assert((KS / 4) % UNROLL == 0, "whole slices");
static_assert(MAX_D % 16 == 0 && RESIDENT_D <= MAX_D, "rows streamed past RESIDENT_D");

// The block of row state MODE: C the selection's configuration (its RB
// rows), RV fragments a thread, NT threads, MINB blocks an SM (asked of
// ptxas, and the shared memory a block takes is held to fit them).
template <int MODE>
struct F32Cfg {
  typedef Cfg<MODE <= LIST16 ? 2 : 1, MODE, 1> C;
  static constexpr int RV = MODE == LIST8 ? 2 : 1;
  static constexpr int RB = C::RB;
  static constexpr int NT = 128 * C::NCONS / RV;
  static constexpr int MINB = MODE == LIST8 ? 2 : 1;
};

// Where things sit in the block's shared memory (offsets in bytes).
struct Layout {
  int d_pad, k_end, n_ks, stages, resident;  // the chains run over k < k_end
  int ldq;                 // floats from one query row to the next
  unsigned q, ring;        // the resident query rows, the ring
  unsigned stage_bytes;    // a stage: the table's slice, then (streamed) the queries'
  unsigned bytes;          // the whole
};

// d_real: the rows' real width (0: d_pad).
template <int MODE>
inline Layout layout_of(int d_pad, int d_real = 0) {
  typedef F32Cfg<MODE> F;
  Layout L;
  L.d_pad = d_pad;
  L.k_end = d_real > 0 && d_real < d_pad ? (d_real + 3) / 4 * 4 : d_pad;
  L.n_ks = (L.k_end + KS - 1) / KS;
  L.resident = d_pad <= RESIDENT_D;
  // resident rows hold the chains' k_end columns, an odd multiple of 4
  // floats apart (8 rows a load in distinct banks)
  L.ldq = L.resident ? L.k_end + (L.k_end % 8 == 0 ? 4 : 0) : LD;
  L.q = (F::C::SEL_BYTES + 15u) & ~15u;
  L.ring = L.q + (L.resident ? (unsigned)(F::RB * L.ldq * 4) : 0u);
  L.stage_bytes = (unsigned)(TN * LD * 4) + (L.resident ? 0u : (unsigned)(F::RB * LD * 4));
  const unsigned budget = F::MINB > 1 ? SMEM_SM / F::MINB - 1024u : SMEM_MAX;
  const long long room = ((long long)budget - L.ring) / L.stage_bytes;
  L.stages = room < MAX_STAGES ? (int)room : MAX_STAGES;
  L.bytes = L.ring + (unsigned)(L.stages > 0 ? L.stages : 0) * L.stage_bytes;
  return L;
}

// The products of 4 k (kk ... kk + 3 of a K-slice) into the thread's
// fragments d: qr[v][h] points at the slice of fragment v's row h, tc at
// the slice of the thread's first column (2 (lane & 3)).
template <int RV>
__device__ __forceinline__ void step4(float (&d)[RV][32], const float* const (&qr)[RV][2],
                                      const float* tc, int kk) {
  float4 a[RV][2];
#pragma unroll
  for (int v = 0; v < RV; ++v)
#pragma unroll
    for (int h = 0; h < 2; ++h) a[v][h] = *reinterpret_cast<const float4*>(qr[v][h] + kk);
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 b = *reinterpret_cast<const float4*>(tc + (8 * j + e) * LD + kk);
#pragma unroll
      for (int v = 0; v < RV; ++v)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& s = d[v][4 * j + 2 * h + e];
          s = fmaf(a[v][h].x, b.x, s);
          s = fmaf(a[v][h].y, b.y, s);
          s = fmaf(a[v][h].z, b.z, s);
          s = fmaf(a[v][h].w, b.w, s);
        }
    }
}

// The products of a K-slice of kl floats (a multiple of 4): a whole
// slice UNROLL steps at a time, a shorter one a step at a time.
template <int RV>
__device__ __forceinline__ void slice_products(float (&d)[RV][32], const float* const (&qr)[RV][2],
                                               const float* tc, int kl) {
  if (kl == KS) {
#pragma unroll 1
    for (int kk = 0; kk < KS; kk += 4 * UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) step4<RV>(d, qr, tc, kk + 4 * u);
    }
  } else {
#pragma unroll 1
    for (int kk = 0; kk < kl; kk += 4) step4<RV>(d, qr, tc, kk);
  }
}

// Block `block` of the launch: piece block / n_qt, query tile block % n_qt.
// q [B, d_pad] and tbl [n_total, d_pad] f32, row-major, 16-byte aligned.
template <int MODE, class Copy>
__device__ __forceinline__ void f32_block(unsigned char* smem, const float* q, const float* tbl,
                                          const Args& a, const Layout& L, int block) {
  typedef F32Cfg<MODE> F;
  typedef typename F::C C;
  constexpr int RV = F::RV, NT = F::NT, RB = F::RB;
  const int tid = threadIdx.x, lane = tid & 31;
  const int piece_idx = block / a.n_qt, qt = block % a.n_qt;
  const int n_tiles = a.piece / TN, d_pad = L.d_pad, stages = L.stages;
  const long long col_base = (long long)piece_idx * a.piece, row0 = (long long)qt * RB;
  float* const qs = reinterpret_cast<float*>(smem + L.q);
  float* const ring = reinterpret_cast<float*>(smem + L.ring);
  const int stage_floats = (int)(L.stage_bytes / 4);

  // the query rows' k_end columns, once (resident), zeros past B
  if (L.resident) {
    const int cpr = L.k_end / 4;  // 16-byte chunks a row
    for (int c = tid; c < RB * cpr; c += NT) {
      const int r = c / cpr, k4 = c - r * cpr;
      const bool in = row0 + r < a.B;
      Copy::copy16(qs + r * L.ldq + 4 * k4, in ? q + (row0 + r) * d_pad + 4 * k4 : q, in);
    }
  }
  // the slice s of tile `tile` (and the queries' slice, streamed) into
  // stage st: its kl = min(32, k_end - 32 s) columns, in 2^sh chunk slots a
  // row
  auto load = [&](int stage, int tile, int s) {
    const int k0 = s * KS, kl = L.k_end - k0 < KS ? L.k_end - k0 : KS;
    const int sh = kl > 16 ? 3 : kl > 8 ? 2 : kl > 4 ? 1 : 0;
    float* dst = ring + stage * stage_floats;
    const float* src = tbl + (col_base + (long long)tile * TN) * d_pad + k0;
    for (int c = tid; c < (TN << sh); c += NT) {
      const int r = c >> sh, k4 = c & ((1 << sh) - 1);
      if (4 * k4 < kl)
        Copy::copy16(dst + r * LD + 4 * k4, src + (long long)r * d_pad + 4 * k4, true);
    }
    if (!L.resident) {
      float* qd = dst + TN * LD;
      for (int c = tid; c < (RB << sh); c += NT) {
        const int r = c >> sh, k4 = c & ((1 << sh) - 1);
        const bool in = row0 + r < a.B;
        if (4 * k4 < kl)
          Copy::copy16(qd + r * LD + 4 * k4, in ? q + (row0 + r) * d_pad + k0 + 4 * k4 : q, in);
      }
    }
  };
  // the steps (a tile's slices, the tiles in `tile_of`'s order), issued
  // stages - 1 ahead; one commit group a step, empty past the last
  const int n_steps = n_tiles * L.n_ks;
  int ld_tile = 0, ld_s = 0;
  auto issue = [&](int step) {
    if (step < n_steps) {
      load(step % stages, ld_tile, ld_s);
      if (++ld_s == L.n_ks) {
        ld_s = 0;
        ld_tile = next_tile(ld_tile, a.stride, n_tiles);
      }
    }
    Copy::commit();
  };
  for (int p = 0; p < stages - 1; ++p) issue(p);

  Select<C, 0> sel[RV];
  int row[RV][2];
#pragma unroll
  for (int v = 0; v < RV; ++v) {
    const int tv = tid + v * NT;  // the consumer thread this fragment is in `Select`'s terms
    sel[v].init(tv, qt, a, smem);
#pragma unroll
    for (int h = 0; h < 2; ++h) row[v][h] = (tv >> 7) * BM + ((tv & 127) >> 5) * 16 + (lane >> 2) + 8 * h;
  }
  float d[RV][32];
#pragma unroll
  for (int v = 0; v < RV; ++v)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[v][i] = 0.f;

  int tile = 0, s = 0;  // the step being multiplied
  for (int step = 0; step < n_steps; ++step) {
    Copy::wait(stages - 2);  // this step's copies (the thread's own) have landed
    __syncthreads();         // everyone's, and the stage of step - 1 is free
    issue(step + stages - 1);
    const float* slice = ring + (step % stages) * stage_floats;
    const float* qbase = L.resident ? qs + s * KS : slice + TN * LD;
    const float* qr[RV][2];
#pragma unroll
    for (int v = 0; v < RV; ++v)
#pragma unroll
      for (int h = 0; h < 2; ++h) qr[v][h] = qbase + row[v][h] * L.ldq;
    const float* tc = slice + 2 * (lane & 3) * LD;
    const int kl = L.k_end - s * KS;
    slice_products<RV>(d, qr, tc, kl < KS ? kl : KS);
    if (++s < L.n_ks) continue;
    // the tile's sums are whole (the padded chain's bits: + 0.0f where it
    // stopped short): its selection, then fresh sums
    s = 0;
    const float* vec = a.bias + col_base + (long long)tile * TN;
#pragma unroll
    for (int v = 0; v < RV; ++v) {
      if (L.k_end < d_pad) {
#pragma unroll
        for (int i = 0; i < 32; ++i) d[v][i] = __fadd_rn(d[v][i], 0.f);
      }
      float x[32], mx[2];
      sel[v].pass1(d[v], vec, x, mx);
      if (sel[v].need(mx, tile)) sel[v].select(d[v], x, tile, vec);
#pragma unroll
      for (int i = 0; i < 32; ++i) d[v][i] = 0.f;
    }
    tile = next_tile(tile, a.stride, n_tiles);
  }
  Copy::wait(0);
#pragma unroll
  for (int v = 0; v < RV; ++v) sel[v].finish(a, piece_idx);
}

}  // namespace cozo_f32
