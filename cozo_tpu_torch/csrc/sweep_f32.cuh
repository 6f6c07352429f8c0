// The f32 kind of the sweep lanes' chunk step (`sweep_topk_f32.cu`): a
// block's 64 query rows against a piece of the table in true f32, each
// score one `fmaf` chain over k ascending from +0.0f (no tensor-core format
// gives those bits), and the piece's exact top-kc per row, taken on the
// sums as each tile of the piece is finished.  No score reaches device
// memory.  The block's loop is here and not in the `.cu` so that
// `tests/test_torch_sweep_select_host_f32*.py` can compile it with g++
// against a stand-in CUDA runtime (the threads of a block as fibers) and
// hold the product and the selection to `exact_knn.sweep_topk_plain` bit
// for bit.  No PTX here: the includer's policy class `Dev` gives the
// barriers, the box copies, the counters' waits and the register moves (on
// the card `mbarrier`s, TMA and `setmaxnreg`; on the host plain copies and
// fibers that yield).
//
// The block (`F32Cfg`): NWG consumer warpgroups that multiply, and one
// selecting warpgroup.  Nothing but FFMAs and their shared loads is left
// in the consumers' K loop: no copy, no `__syncthreads`, no selection.
//   * The ring: `stages` K-slices, each one TMA box of the table (TC rows,
//     the tile's columns, x KS + PAD floats) and, where the query rows
//     stream (d_pad past RESIDENT_D, and always for the heads), one of the
//     block's 64 query rows; resident query rows are loaded once, a box a
//     slice.  A box row's PAD floats past its slice (the next slice's
//     first 4, or TMA's zeros past d_pad) keep shared rows 4 banks apart,
//     so the 4 or 8 rows a warp's 128-bit load meets fall in distinct
//     banks with no swizzle to undo in the loop; a last slice takes up to
//     KS + PAD k, so a real width of 100 is 32 + 32 + 36.  Each stage has
//     a full barrier (the boxes' bytes) and an empty one (an arrival from
//     every consumer warp).  The selecting warpgroup's first thread
//     issues every box: between the selection tiles and while it waits for
//     the next, it refills each stage its empty barrier frees (it never
//     blocks there, so it never waits for the consumers while they wait
//     for it), polling with a short pause.
//   * The product is its own layout: each consumer thread owns a register
//     micro-tile of 8 query rows x MC table rows, rows 4 apart and columns
//     8 apart (lane & 3 and lane >> 2), a warp 32 rows x 8 MC columns, a
//     warpgroup 2 x 2 warps (64 rows x 16 MC columns).  Every 4 k a thread
//     loads each of its MC columns once (128-bit: 4 k) and keeps them,
//     then each of its 8 rows once and multiplies: MC + 8 loads for 32 MC
//     FFMAs, the next step's loads hoisted over this step's FFMAs.
//   * Once a tile's chains end (+0.0f where they stopped short), each warp
//     writes its part of a 64-column selection tile to a staging slot and
//     arrives on the slot's barrier; selecting warp w reads rows 16 w ...
//     of it as the m64n64 fragment `Select` (`sweep_select.cuh`, KIND 0)
//     reads, counts it read, and selects while the consumers multiply the
//     next tile.  A consumer warp reuses a slot once the two selecting
//     warps of its rows have counted its last tile read (counts, not a
//     barrier's phase: the warpgroups take turns at the slots and may wait
//     far apart).  `setmaxnreg` moves registers to whichever side needs
//     them (the lists of 8's consumers 184 a thread, for 8 x 8 micro-tiles
//     and hoisted loads; head 128's selectors 160).
// Where the caller gives the rows' real width d_real (the columns past it
// +0.0 in the queries and in the table, as the sweep table and
// `prepare_queries` pad them), the chains stop at k_end, d_real rounded up
// to 4, and add +0.0f once: a padded product (+0) x (+0) changes a sum only
// from -0.0 to +0.0, and so does that one add, so the sums are the bits of
// the padded chain's with (d_pad - k_end) / d_pad fewer FFMAs.
//
// Configurations by row state, one block an SM: the lists (kc <= 64) two
// consumer warpgroups of 8 x 8 micro-tiles on tiles of 64 x 256, slices of
// 32 floats; head 128 four of 8 x 4 (16 product warps, four a scheduler)
// and head 256 two, on slices of 16, their heads and tails filling the
// shared memory.  Times: PERF.md section 6.

#pragma once

#include "sweep_select.cuh"

namespace cozo_f32 {

using namespace cozo_sweep;

constexpr unsigned SMEM_MAX = 232448;  // a block's shared memory on sm_90
constexpr int RESIDENT_D = 128;        // query rows resident up to this d_pad
constexpr int MAX_D = 4096;            // the widest row (d_pad) the entry takes
constexpr int MAX_STAGES = 4;          // slices in flight, at most
constexpr int MAX_SLOTS = 4;           // selection tiles staged, at most
constexpr int RB = BM;                 // query rows a block, every row state
constexpr int PAD = 4;                 // floats a box row holds past its slice
constexpr int SLD = TN + 8;            // floats a staging row (rows 8 banks apart)
constexpr unsigned ALIGN = 128;        // a box's alignment in shared memory
constexpr unsigned SLOT_BYTES = RB * SLD * 4;
constexpr int UNROLL = 2;              // 4-k steps a turn of the K loop
constexpr unsigned BAR_BYTES = 8u * (2 * MAX_STAGES + 1 + MAX_SLOTS) + 16u;
static_assert(MAX_D % 16 == 0 && RESIDENT_D <= MAX_D, "rows streamed past RESIDENT_D");
static_assert(RB == 64 && SLD % 32 == 8, "64 query rows; staging rows 8 banks apart");

// Whether 8 consecutive rows of `box` floats start in distinct groups of 4
// banks (the 4 or 8 rows a warp's 128-bit load meets, at one k).
constexpr bool rows_apart(int box) {
  unsigned seen = 0;
  for (int i = 0; i < 8; ++i) {
    const int g = i * box % 32 / 4;
    if ((seen >> g) & 1u) return false;
    seen |= 1u << g;
  }
  return box % 4 == 0;
}

// The block of row state MODE: C the selection's configuration (64 rows,
// one warpgroup), NWG consumer warpgroups (the products), MC columns a
// thread, KS floats a K-slice, TC columns a tile, NT threads (and the
// selecting warpgroup, whose first thread also feeds the ring).  The
// registers: ptxas gives every thread REGS (the register file over the
// block's threads); `setmaxnreg` moves them between the consumers
// (CONSUMER_REGS each) and the selecting warpgroup (SELECTOR_REGS).
template <int MODE>
struct F32Cfg {
  typedef Cfg<1, MODE, 1> C;
  static constexpr int NWG = MODE == HEAD128 ? 4 : 2;
  static constexpr int MC = MODE <= LIST16 ? 8 : 4;
  static constexpr int KS = MODE <= LIST16 ? 32 : 16;
  static constexpr int BOX = KS + PAD;         // floats a box row
  static constexpr int WGC = 16 * MC;          // a warpgroup's columns: 2 x 2 warps of 8 MC
  static constexpr int WCT = WGC / TN;         // selection tiles a warpgroup
  static constexpr int TC = NWG * WGC;         // a tile's columns
  static constexpr int NCT = TC / TN;          // selection tiles a tile
  static constexpr int NCONS = 128 * NWG;      // consumer threads
  static constexpr int NT = NCONS + 128;
  static constexpr bool RESIDENT = MODE <= LIST16;  // query rows kept to RESIDENT_D
  static constexpr int REGS = 65536 / NT / 8 * 8;
  static constexpr int CONSUMER_REGS =
      MODE == LIST8 ? 184 : MODE == LIST16 ? 152 : MODE == HEAD128 ? 80 : 128;
  static constexpr int SR = (REGS * NT - CONSUMER_REGS * NCONS) / 128 / 8 * 8;
  static constexpr int SELECTOR_REGS = SR < 240 ? SR : 240;
  static_assert(WGC % TN == 0 && TC <= 256, "whole selection tiles; a box of <= 256 rows");
  static_assert(PIECE_ALIGN % TC == 0, "a piece holds whole tiles");
  static_assert(KS % 16 == 0 && (BOX * 4) % 16 == 0, "a box row a multiple of 16 bytes");
  static_assert(rows_apart(BOX), "a load's rows in distinct banks");
  static_assert(REGS <= 255 && (CONSUMER_REGS - REGS) * (SELECTOR_REGS - REGS) <= 0 &&
                    CONSUMER_REGS * NCONS + SELECTOR_REGS * 128 <= REGS * NT,
                "one side's registers cover the other's rise");
};

// Where things sit in the block's shared memory (bytes from a 128-byte
// boundary).
struct Layout {
  int d_pad, k_end, n_ks, stages, slots, resident;  // the chains run over k < k_end
  unsigned q_box, t_box;   // a box of the query rows, of the table
  unsigned q;              // the resident query rows: n_ks boxes
  unsigned staging;        // `slots` selection tiles' sums, [RB][SLD] each
  unsigned ring;           // stages: the table's box, then (streamed) the queries'
  unsigned stage_bytes;
  unsigned bars;           // full, empty [MAX_STAGES], the resident rows', staged [MAX_SLOTS],
                           // and the selecting warps' counts of tiles read
  unsigned bytes;          // the whole, and room to align its start
};

constexpr unsigned align_up(unsigned x) { return (x + ALIGN - 1) / ALIGN * ALIGN; }

// d_real: the rows' real width (0: d_pad).  A slice covers KS k, the last
// up to KS + PAD (a box's width), so that a real width just past a
// multiple of KS (the lanes' 100) takes no slice of 4.  The ring takes as
// many stages as fit beside one staging slot (at most MAX_STAGES), the
// staging as many slots as fit beside the ring (at most a tile's).
template <int MODE>
constexpr Layout layout_of(int d_pad, int d_real = 0) {
  typedef F32Cfg<MODE> F;
  Layout L{};
  L.d_pad = d_pad;
  L.k_end = d_real > 0 && d_real < d_pad ? (d_real + 3) / 4 * 4 : d_pad;
  L.n_ks = L.k_end > F::BOX ? (L.k_end - PAD + F::KS - 1) / F::KS : 1;
  L.resident = F::RESIDENT && d_pad <= RESIDENT_D;
  L.q_box = (unsigned)(RB * F::BOX * 4);
  L.t_box = (unsigned)(F::TC * F::BOX * 4);
  L.q = align_up(F::C::SEL_BYTES);
  L.staging = L.q + (L.resident ? (unsigned)L.n_ks * L.q_box : 0u);
  L.stage_bytes = L.t_box + (L.resident ? 0u : L.q_box);
  const long long budget = (long long)SMEM_MAX - ALIGN - BAR_BYTES;
  const long long room = (budget - align_up(L.staging + SLOT_BYTES)) / L.stage_bytes;
  L.stages = room < MAX_STAGES ? (int)room : MAX_STAGES;
  for (L.slots = F::NCT < MAX_SLOTS ? F::NCT : MAX_SLOTS; L.slots > 1; --L.slots)
    if (align_up(L.staging + (unsigned)L.slots * SLOT_BYTES) +
            (long long)L.stages * L.stage_bytes <= budget)
      break;
  L.ring = align_up(L.staging + (unsigned)L.slots * SLOT_BYTES);
  L.bars = L.ring + (unsigned)(L.stages > 0 ? L.stages : 0) * L.stage_bytes;
  L.bytes = L.bars + BAR_BYTES + ALIGN;
  return L;
}

// Every row state fits (a ring of at least two stages, a staged tile) at
// every d_pad the entry takes.
template <int MODE>
constexpr bool fits_every_width() {
  for (int d = 16; d <= MAX_D; d += 16)
    if (layout_of<MODE>(d).stages < 2 || layout_of<MODE>(d).slots < 1) return false;
  return true;
}
static_assert(fits_every_width<LIST8>() && fits_every_width<LIST16>() &&
                  fits_every_width<HEAD128>() && fits_every_width<HEAD256>(),
              "every row state's block fits at every d_pad from 16 to MAX_D");

// The order of a piece's tiles (TC columns each): the selection's stride.
template <int MODE>
inline int tile_stride(int piece) {
  return stride_of(piece / F32Cfg<MODE>::TC);
}

// The products of 4 k (kk ... kk + 3 of a slice) into the thread's
// micro-tile: q at its first row (the others 4 box rows apart), t at its
// first column (the others 8 apart).  Each column's 4 k are loaded once and
// kept; each row's then meet all of them, k ascending in every chain.
template <int MC, int BOX>
__device__ __forceinline__ void step4(float (&acc)[8][MC], const float* q, const float* t,
                                      int kk) {
  float4 b[MC];
#pragma unroll
  for (int c = 0; c < MC; ++c) b[c] = *reinterpret_cast<const float4*>(t + 8 * c * BOX + kk);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(q + 4 * r * BOX + kk);
#pragma unroll
    for (int c = 0; c < MC; ++c) acc[r][c] = fmaf(a.x, b[c].x, acc[r][c]);
#pragma unroll
    for (int c = 0; c < MC; ++c) acc[r][c] = fmaf(a.y, b[c].y, acc[r][c]);
#pragma unroll
    for (int c = 0; c < MC; ++c) acc[r][c] = fmaf(a.z, b[c].z, acc[r][c]);
#pragma unroll
    for (int c = 0; c < MC; ++c) acc[r][c] = fmaf(a.w, b[c].w, acc[r][c]);
  }
}

// Block `block` of the launch: piece block / n_qt, query tile block % n_qt.
// mq: the queries [B, d_pad] (boxes of RB rows x BOX floats), mt: the table
// [n_total, d_pad] (boxes of TC rows), as the policy `Dev` names them.
// smem: the block's shared memory, 128-byte aligned, L.bytes - ALIGN long.
// Dev gives: Map, init / fence_init (barriers), expect, load (a box), wait,
// test (a barrier's phase, without waiting), arrive, idle (a poll's pause),
// count (a counter's increment, after the warp's reads) / until (a
// counter's value, before the warp's writes), regs<N, up>() (the calling
// warpgroup's registers a thread to N).
template <int MODE, class Dev>
__device__ __forceinline__ void f32_block(unsigned char* smem, const typename Dev::Map& mq,
                                          const typename Dev::Map& mt, const Args& a,
                                          const Layout& L, int block) {
  typedef F32Cfg<MODE> F;
  typedef typename F::C C;
  constexpr int MC = F::MC, KS = F::KS, BOX = F::BOX;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int piece_idx = block / a.n_qt, qt = block % a.n_qt;
  const int n_tiles = a.piece / F::TC, stages = L.stages, slots = L.slots;
  const int n_steps = n_tiles * L.n_ks;
  const long long col_base = (long long)piece_idx * a.piece;
  float* const staging = reinterpret_cast<float*>(smem + L.staging);
  unsigned char* const bars = smem + L.bars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (MAX_STAGES + st); };
  unsigned char* const q_full = bars + 16 * MAX_STAGES;
  auto staged = [&](int sl) { return q_full + 8 + 8 * sl; };
  // read[w]: the selection tiles whose rows 16 w ... selecting warp w has
  // read, in their order (a count, not a barrier's phase: the consumer
  // warpgroups take turns at the slots and may wait far apart)
  int* const read = reinterpret_cast<int*>(q_full + 8 + 8 * MAX_SLOTS);

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      Dev::init(full(st), 1);
      Dev::init(empty(st), F::NCONS / 32);
    }
    Dev::init(q_full, 1);
    for (int sl = 0; sl < slots; ++sl) Dev::init(staged(sl), 4 / F::WCT);  // its writers
    for (int w = 0; w < 4; ++w) read[w] = 0;
    Dev::fence_init();
  }
  __syncthreads();

  if (warp >= F::NCONS / 32) {
    // the selecting warpgroup: warp w selects the block's rows 16 w ...
    // of each selection tile in turn; its first thread also keeps the
    // ring full, between and while it waits for the tiles (it never waits
    // for the consumers where they could wait for it)
    Dev::template regs<F::SELECTOR_REGS, (F::SELECTOR_REGS > F::REGS)>();
    const int stid = tid - F::NCONS, sw = stid >> 5;
    const bool producer = stid == 0;
    int p_step = 0, p_tile = 0, p_s = 0, p_st = 0, p_phase = 0;
    auto feed = [&]() {  // every box the ring has room for
      for (; p_step < n_steps; ++p_step) {
        if (p_step >= stages && !Dev::test(empty(p_st), p_phase ^ 1)) return;
        unsigned char* dst = smem + L.ring + p_st * L.stage_bytes;
        Dev::expect(full(p_st), L.stage_bytes);
        Dev::load(dst, mt, full(p_st), p_s * KS, (int)(col_base + (long long)p_tile * F::TC));
        if (!L.resident) Dev::load(dst + L.t_box, mq, full(p_st), p_s * KS, qt * RB);
        if (++p_s == L.n_ks) {
          p_s = 0;
          p_tile = next_tile(p_tile, a.stride, n_tiles);
        }
        if (++p_st == stages) {
          p_st = 0;
          p_phase ^= 1;
        }
      }
    };
    if (producer) {
      if (L.resident) {
        Dev::expect(q_full, (unsigned)L.n_ks * L.q_box);
        for (int s = 0; s < L.n_ks; ++s)
          Dev::load(smem + L.q + s * L.q_box, mq, q_full, s * KS, qt * RB);
      }
      feed();
    }
    Select<C, 0> sel;
    sel.init(stid, qt, a, smem);
    int tile = 0, sl = 0, phase = 0;
    for (int e = 0; e < n_tiles; ++e) {
      for (int ct = 0; ct < F::NCT; ++ct) {
        if (producer)
          while (!Dev::test(staged(sl), phase)) {
            feed();
            Dev::idle();
          }
        Dev::wait(staged(sl), phase);
        const float* rows = staging + sl * (SLOT_BYTES / 4) + (16 * sw + (lane >> 2)) * SLD;
        float d[32], x[32], mx[2];  // m64n64's fragment of the selection tile
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v =
                *reinterpret_cast<const float2*>(rows + 8 * h * SLD + 8 * j + 2 * (lane & 3));
            d[4 * j + 2 * h] = v.x;
            d[4 * j + 2 * h + 1] = v.y;
          }
        Dev::count(read + sw, lane);  // the warp has its fragment
        const int t64 = tile * F::NCT + ct;
        const float* vec = a.bias + col_base + (long long)t64 * TN;
        sel.pass1(d, vec, x, mx);
        if (sel.need(mx, t64)) sel.select(d, x, t64, vec);
        if (++sl == slots) {
          sl = 0;
          phase ^= 1;
        }
      }
      tile = next_tile(tile, a.stride, n_tiles);
    }
    sel.finish(a, piece_idx);
    return;
  }

  // the consumers: warpgroup wg, its warp (wr, wc): the block's rows 32 wr
  // ... and half the warpgroup's columns; the thread's micro-tile: rows
  // (lane & 3) + 4 r of the warp's, columns (lane >> 2) + 8 c
  Dev::template regs<F::CONSUMER_REGS, (F::CONSUMER_REGS > F::REGS)>();
  const int wg = warp >> 2, wr = warp & 1, wc = (warp >> 1) & 1;
  const int row0 = 32 * wr + (lane & 3);
  const int col0 = wg * F::WGC + wc * (F::WGC / 2) + (lane >> 2);
  const bool stop0 = L.k_end < L.d_pad;  // the chains stopped short
  if (L.resident) Dev::wait(q_full, 0);

  float acc[8][MC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < MC; ++c) acc[r][c] = 0.f;

  int s = 0, st = 0, phase = 0, e = 0;  // the step being multiplied, its tile
  for (int step = 0; step < n_steps; ++step) {
    Dev::wait(full(st), phase);
    const float* tb = reinterpret_cast<const float*>(smem + L.ring + st * L.stage_bytes);
    const float* qb = L.resident ? reinterpret_cast<const float*>(smem + L.q + s * L.q_box)
                                 : tb + L.t_box / 4;
    const int kl = s + 1 < L.n_ks ? KS : L.k_end - s * KS;
    int kk = 0;
#pragma unroll 1
    for (; kk + 4 * UNROLL <= kl; kk += 4 * UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) step4<MC, BOX>(acc, qb + row0 * BOX, tb + col0 * BOX, kk + 4 * u);
    }
#pragma unroll 1
    for (; kk < kl; kk += 4) step4<MC, BOX>(acc, qb + row0 * BOX, tb + col0 * BOX, kk);
    __syncwarp();
    if (lane == 0) Dev::arrive(empty(st));  // the warp is done with the stage
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
    if (++s < L.n_ks) continue;
    // the tile's sums are whole (the padded chain's bits: + 0.0f where it
    // stopped short): the warp's part of its selection tile (MC = 8: all
    // of one; 4: half) into the staging slot the selecting warps 2 wr and
    // 2 wr + 1 read, then fresh sums
    s = 0;
    {
      const int ct = (wg * F::WGC + wc * (F::WGC / 2)) / TN;
      const int g = e * F::NCT + ct;  // the tile's place in the selection's order
      const int sl = g % slots;
      Dev::until(read + 2 * wr, g - slots + 1);  // the slot's last tile is read
      Dev::until(read + 2 * wr + 1, g - slots + 1);
      float* rows = staging + sl * (SLOT_BYTES / 4) + row0 * SLD + (col0 & (TN - 1));
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          const float v = acc[r][c];
          rows[4 * r * SLD + 8 * c] = stop0 ? __fadd_rn(v, 0.f) : v;
        }
      __syncwarp();
      if (lane == 0) Dev::arrive(staged(sl));
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < MC; ++c) acc[r][c] = 0.f;
    ++e;
  }
}

}  // namespace cozo_f32
