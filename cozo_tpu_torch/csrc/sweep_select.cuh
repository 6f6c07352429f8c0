// The selection half of the sweep lanes' chunk step (`sweep_topk.cu`): each
// query row's exact top-kc of a piece, taken on the accumulator fragments
// of `wgmma` m64n64 as the tiles of the piece arrive, in any order.  No PTX
// here: the kernel includes this file, and `tests/test_torch_sweep_select_
// host*.py` compiles it with g++ against a stand-in CUDA runtime and feeds
// it fragments of host products, so that every configuration is held to
// `exact_knn.select_topk_plain` bit for bit on the CPU.
//
// What is selected: for row i and a piece (positions 0 .. piece - 1), the kc
// largest of the unique composites (order_key(key) << 32) | ~position,
// descending (equal keys by ascending position, +0.0 above -0.0, -inf
// last); key = score + bias[j] (bf16 route, f32), or bf16(((s32 c[j]) r[i])
// + bias[j]) with round-to-nearest multiplies and adds, never an FMA (int8
// route).  Values in the key's type, ids = p piece + position + id_off.
//
// Where the state lives.  In the m64n64 fragment a thread holds rows
// lane/4 and lane/4 + 8 of its warp's 16 rows, 16 columns of each per tile
// (register i: column 8 (i >> 2) + 2 (lane & 3) + (i & 1), row half
// (i >> 1) & 1), so each row belongs to one quad of one warp.  A row's
// threshold t (a composite; 0: nothing kept) sits in its quad's registers,
// with two float bounds drawn from it: `lo`, below which no value's key can
// reach t's key, and `hi`, below which none can pass it (the int8 route
// compares before the bf16 rounding: the midpoints to the neighbouring bf16
// values).  A tile wholly past t's position can only add values whose key
// is above t's (an equal key loses on position): it is filtered at `hi`,
// other tiles at `lo`.  Pass 1 keys every value and takes each row's
// maximum, or on the bf16 route a bound of it, the row's largest score
// plus the tile's largest bias (the slot is then free); only a warp where
// a row's maximum reaches its bound runs pass 2: a mask of the values at or
// above it, each keyed exactly and held to t.  Three kinds of per-row state:
//   * kc <= 32 (lists of 8): the row's top kc is a sorted list in its
//     quad's registers, L = 8 entries a thread (thread k of the quad holds
//     entries L k ... L k + L - 1).  A candidate goes in by a count of the
//     entries above it (summed over the quad by two shuffles) and a shift
//     of the rest; the row's new kc-th is t at once.  The eight quads of a
//     warp insert side by side.  No shared memory; the first tile seeds the
//     list like any other (t = 0 takes everything).
//   * kc <= 64 (lists of 16, L = 16): the same lists, fed through a tail of
//     appends in shared memory: a warp inserts its rows' tails (one entry a
//     quad a round, no vote) when one passes HIGH, and at the end.  t lags
//     until then; the warp's stall on its lists comes once for many tiles,
//     not at each tile with a candidate.
//   * kc <= 128 / kc <= 256 (head and tail): each row keeps in shared memory
//     a sorted head of HEAD composites and a tail of appends (an atomic
//     gives the slot).  When the tail passes HIGH (room for one more
//     tile's appends), the warp sorts the tail alone (bitonic, fixed size)
//     and merges it into the head by one bitonic merge step (the top HEAD
//     of head and tail form a bitonic sequence, cleaned in log2 HEAD
//     rounds); t becomes the head's kc-th.
// Exact in every state: t is always the kc-th of distinct elements of the
// piece (0 until kc are kept), and every composite above t is kept.
// At the piece's end each warp writes its rows' first kc.
//
// Counters (a build with COZO_SWEEP_COUNTERS): warp-tiles that ran pass 2,
// composites keyed in pass 2, and those keyed and then rejected (not above
// t, or below a list's kc-th).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Head 128: appends a row before a merge.  A define only so that the host
// test can build a short tail (16: many merges a row); a tail longer than
// the head is refused below.
#ifndef COZO_SWEEP_HEAD_HIGH
#define COZO_SWEEP_HEAD_HIGH 64
#endif

namespace cozo_sweep {

typedef unsigned long long u64;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int BM = 64;  // query rows a consumer warpgroup (wgmma M)
constexpr int TN = 64;  // table rows a tile (wgmma N)
constexpr int MAX_KC = 256;
constexpr int PIECE_ALIGN = 256;  // a piece holds whole tiles, an even number

// Row state of a configuration.
enum { LIST8 = 0, LIST16 = 1, HEAD128 = 2, HEAD256 = 3 };

// One configuration of the block: NCONS consumer warpgroups of 64 query
// rows, the row state MODE, blocks in clusters of CLUSTER.
template <int NCONS_, int MODE_, int CLUSTER_>
struct Cfg {
  static constexpr int NCONS = NCONS_;
  static constexpr int MODE = MODE_;
  static constexpr int CLUSTER = CLUSTER_;
  static constexpr bool LISTS = MODE_ <= LIST16;
  static constexpr int L = MODE_ == LIST8 ? 8 : 16;  // list entries a thread a row
  static constexpr int MAXKC = MODE_ == LIST8 ? 32 : MODE_ == LIST16 ? 64 : MODE_ == HEAD128 ? 128 : 256;
  // the lists of 16 take their candidates through a tail (DEFER); those
  // of 8 one by one as they come
  static constexpr bool DEFER = MODE_ == LIST16;
  // the head in shared memory (none with the lists, which are in
  // registers) and the tail of appends; a merge (or the lists' flush) when
  // a row passes HIGH appends, so that one more tile's 64 fit
  static constexpr int HEAD = LISTS ? 0 : MAXKC;
  // (the lists of 16: appends a row before the warp inserts them)
  static constexpr int HIGH = LISTS ? 8 : MODE_ == HEAD128 ? COZO_SWEEP_HEAD_HIGH : 0;
  static constexpr int TAIL = LISTS && !DEFER ? 0 : HIGH + TN;
  static_assert(HIGH >= 0, "a tail holds a tile's appends past HIGH");
  static_assert(LISTS || TAIL <= HEAD, "a merge's first step pairs each tail entry with a head's");
  static constexpr int BUF = HEAD + TAIL;  // entries a row in shared memory
  static constexpr int RB = BM * NCONS_;
  static constexpr int NTHREADS = 128 * (NCONS_ + 1);  // and one producer warpgroup
  // shared memory of the selection: the rows' heads and tails, their counts
  static constexpr unsigned SEL_BYTES = TAIL ? (unsigned)(RB * BUF * 8 + RB * 4) : 0u;
};

// The configuration of a row state: two consumers (128 rows) for the
// lists, one (64 rows, whose heads and tails fill the shared memory) past.
template <int MODE, int CLUSTER>
using CfgOf = Cfg<MODE <= LIST16 ? 2 : 1, MODE, CLUSTER>;

// The wide rows' configuration (`sweep_topk.cu`, 128 < d_pad): a block
// of 64 query rows for every row state, NC consumer warpgroups on those
// rows (each the tiles of every NC-th group; one row state, whose
// registers are the consumer's own), blocks in clusters of CLUSTER.
template <int MODE_, int NC_ = 1, int CLUSTER_ = 2>
struct WideCfg : Cfg<1, MODE_, CLUSTER_> {
  static constexpr int NC = NC_;
  static constexpr int NTHREADS = 128 * (NC_ + 1);  // and one producer warpgroup
  static_assert(NC_ == 1 || NC_ == 2, "one or two consumers a block");
};

// What the kernel reads and writes beside the two matrices.
struct Args {
  const float* bias;       // [n_total]
  const float* col_scale;  // [n_total] (int8)
  const float* row_scale;  // [B] (int8)
  void* out_v;             // f32 (bf16 route) or bf16 (int8 route)
  long long* out_i;
  long long ldo, id_off;
  int B, piece, kc, n_qt, n_qt_c, stride;
};

// ---- host: the configuration, the order of the tiles ----------------------

// The row state for kc: lists up to 64, a head and tail past it.
inline int mode_of(int kc) {
  return kc <= 32 ? LIST8 : kc <= 64 ? LIST16 : kc <= 128 ? HEAD128 : HEAD256;
}

inline int gcd_of(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// The stride of the tiles' order over a piece of n_tiles: coprime to it,
// near 0.618 n_tiles.
inline int stride_of(int n_tiles) {
  int s = (int)(0.6180339887 * n_tiles);
  if (s < 1) s = 1;
  while (gcd_of(s, n_tiles) != 1) ++s;
  return s;
}

// ---- device: keys, composites, sorting --------------------------------------

// The ring's e-th tile: e stride mod n, so that the first tiles fall all
// over the piece (keys that rise along it meet their top early).
__device__ __forceinline__ int tile_of(int e, int n, int stride) {
  return (int)(((long long)e * stride) % n);
}

// The tile after `tile` in that order (no division on the way).
__device__ __forceinline__ int next_tile(int tile, int stride, int n) {
  tile += stride;
  return tile >= n ? tile - n : tile;
}

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

__device__ __forceinline__ float bits_float(unsigned b) { return __uint_as_float(b); }

// The bounds of composite t: a value x (compared before the bf16 rounding
// where ROUND) whose composite can reach t needs x >= lo; one whose key
// passes t's key needs x >= hi.  Both are loose where float comparison
// cannot tell -0.0 from +0.0: the exact composite decides after them.
template <bool ROUND>
__device__ __forceinline__ void bounds_of(u64 t, float& lo, float& hi, unsigned& tpos) {
  const float ninf = bits_float(0xff800000u);
  if (t == 0) {  // nothing kept: everything goes in
    lo = hi = ninf;
    tpos = 0xFFFFFFFFu;
    return;
  }
  tpos = ~(unsigned)(t & 0xFFFFFFFFull);
  const unsigned b = key_bits((unsigned)(t >> 32));
  const bool neg = (b & 0x80000000u) != 0;
  if (!ROUND) {  // the key itself: t's key, and the next float above it
    lo = bits_float(b);
    hi = b == 0x80000000u ? 0.f : bits_float(neg ? b - 1 : b + 1);
    return;
  }
  // the bf16 roundings: the midpoints to the neighbouring bf16 values
  if (b == 0u) {
    lo = 0.f;
    hi = bits_float(0x00008000u);
  } else if (b == 0x80000000u) {
    lo = bits_float(0x80008000u);
    hi = 0.f;
  } else if (b == 0xff800000u) {
    lo = ninf;
    hi = bits_float(0xff7f8000u);
  } else if (b == 0x7f800000u) {
    lo = bits_float(0x7f7f8000u);
    hi = bits_float(0x7fc00000u);  // NaN: nothing passes +inf
  } else {
    lo = bits_float(neg ? b + 0x8000u : b - 0x8000u);
    hi = bits_float(neg ? b - 0x8000u : b + 0x8000u);
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

// e[j] for a run-time j < N (selects: no local memory).
template <int N>
__device__ __forceinline__ u64 sel_n(const u64 (&e)[N], int j) {
  u64 v = e[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = j == k ? e[k] : v;
  return v;
}

__device__ __forceinline__ void cmp_swap_desc(u64* buf, int i, int l) {
  const u64 a = buf[i], b = buf[l];
  if (a < b) {
    buf[i] = b;
    buf[l] = a;
  }
}

// Sorts buf[0, N) descending by one warp: a bitonic network in its flip
// form over N rounded up to a power of two (at least 64); the entries past
// N are virtual minima that no comparator moves.  Starts and ends with
// __syncwarp.
template <int N>
__device__ __forceinline__ void warp_sort_n(u64* buf, int lane) {
  constexpr int N2 = N <= 64 ? 64 : 2 * (1 << (31 - __builtin_clz(N - 1)));
  __syncwarp();
#pragma unroll
  for (int k = 2; k <= N2; k <<= 1) {
    const int h = k >> 1;
#pragma unroll
    for (int p0 = 0; p0 < N2 / 2; p0 += 32) {
      const int p = p0 + lane;
      const int i = ((p & ~(h - 1)) << 1) | (p & (h - 1));  // first half of its block
      const int l = i ^ (k - 1);                            // its mirror
      if (l < N) cmp_swap_desc(buf, i, l);
    }
    __syncwarp();
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1) {
#pragma unroll
      for (int p0 = 0; p0 < N2 / 2; p0 += 32) {
        const int p = p0 + lane;
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        if ((i | j) < N) cmp_swap_desc(buf, i, i | j);
      }
      __syncwarp();
    }
  }
}

// Sorts the bitonic buf[0, N) descending by one warp: half-cleaners of N,
// N / 2, ..., 2.  Ends with __syncwarp.
template <int N>
__device__ __forceinline__ void warp_bitonic_merge_n(u64* buf, int lane) {
#pragma unroll
  for (int j = N / 2; j > 0; j >>= 1) {
#pragma unroll
    for (int p0 = 0; p0 < N / 2; p0 += 32) {
      const int p = p0 + lane;
      const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
      cmp_swap_desc(buf, i, i | j);
    }
    __syncwarp();
  }
}

#ifdef COZO_SWEEP_COUNTERS
// warp-tiles with pass 2, composites keyed there, keyed and rejected
__device__ unsigned long long sweep_counts[3];
#endif

// Entry o of the outputs from composite cv: the key's value (f32, or bf16
// for int8) and the id.
template <int KIND>
__device__ __forceinline__ void write_entry(const Args& a, long long o, u64 cv, long long col_base) {
  const unsigned bits = key_bits((unsigned)(cv >> 32));
  if (KIND == 0)
    static_cast<unsigned*>(a.out_v)[o] = bits;
  else
    static_cast<unsigned short*>(a.out_v)[o] = (unsigned short)(bits >> 16);
  a.out_i[o] = (long long)(~(unsigned)(cv & 0xFFFFFFFFull)) + col_base + a.id_off;
}

// The selection state of one consumer thread (KIND 0: bf16, 1: int8) and
// its steps: `init` once, then for every tile `pass1` (after which the
// tile's slot may be freed), `need` and, where it says so, `select`; then
// `finish`.  WIDE: the int8 sums may pass 2^22 (d_pad > 128) and 2^24 (d_pad
// > 1,040; 4,096 127^2 at the widest), converted to f32 by round-to-nearest
// even; below (d_pad <= 128: |s| <= 128 127^2 < 2^22) by the cheaper magic
// number, exact there.
template <class C, int KIND, bool WIDE = false>
struct Select {
  static constexpr bool ROUND = KIND == 1;
  static constexpr int NL = C::LISTS ? C::L : 1;

  int lane, low, qbase, qk, wrow0, kc, tk, tj;
  long long g0;  // the block's first query row
  int row[2];
  float rs[2];
  u64 t[2];
  float lo[2], hi[2];
  unsigned tpos[2];
  u64 E[2][NL];  // lists: each of the thread's two rows' entries, 0 where empty
  u64* bufs;     // head and tail modes: RB rows of BUF composites
  int* cnt;      //   and each row's tail count
#ifdef COZO_SWEEP_COUNTERS
  unsigned n_pass2, n_keyed, n_rejected;
#endif

  // tid: the thread in the block (consumers first); qt: the block's query
  // tile; sel_smem: C::SEL_BYTES of shared memory (head and tail modes).
  __device__ __forceinline__ void init(int tid, int qt, const Args& a, unsigned char* sel_smem) {
    lane = tid & 31;
    low = 2 * (lane & 3);
    qbase = lane & ~3;
    qk = lane & 3;
    wrow0 = (tid >> 7) * BM + ((tid & 127) >> 5) * 16;
    kc = a.kc;
    tk = (kc - 1) / C::L;
    tj = (kc - 1) % C::L;
    g0 = (long long)qt * C::RB;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = wrow0 + (lane >> 2) + 8 * h;
      const long long g = g0 + row[h];
      rs[h] = (KIND == 1 && g < a.B) ? a.row_scale[g] : 1.f;
      t[h] = 0;
      bounds_of<ROUND>(0, lo[h], hi[h], tpos[h]);
#pragma unroll
      for (int j = 0; j < NL; ++j) E[h][j] = 0;
    }
    bufs = reinterpret_cast<u64*>(sel_smem);
    cnt = reinterpret_cast<int*>(sel_smem + (size_t)C::RB * C::BUF * 8);
    if constexpr (C::TAIL > 0) {
      // the warp's own rows: empty heads, empty tails
      for (int r = wrow0; r < wrow0 + 16; ++r) {
        for (int i = lane; i < C::HEAD; i += 32) bufs[(size_t)r * C::BUF + i] = 0;
        if (lane == 0) cnt[r] = 0;
      }
      __syncwarp();
    }
#ifdef COZO_SWEEP_COUNTERS
    n_pass2 = n_keyed = n_rejected = 0;
#endif
  }

  // Pass 1: an upper bound of each row's keys into mx (each thread over its
  // 16 columns of the row).  bf16 route: (max score) + (max bias), rounded
  // as the keys are (round-to-nearest is monotone, so no key of the row is
  // above it); x is left for `select`.  int8 route: every key (before its
  // bf16 rounding) into x, mx their maximum.  vec: the tile's bias, then
  // (int8) its column scales, in shared memory.
  template <class Acc>
  __device__ __forceinline__ void pass1(const Acc (&d)[32], const float* vec, float (&x)[32],
                                        float (&mx)[2]) const {
    vec += low;
    const float ninf = bits_float(0xff800000u);
    if constexpr (KIND == 0) {
      float m[2][4], bm[2] = {ninf, ninf};  // independent chains
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 4; ++k) m[h][k] = ninf;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(vec + 8 * j);
        bm[j & 1] = fmaxf(bm[j & 1], fmaxf(b.x, b.y));
#pragma unroll
        for (int h = 0; h < 2; ++h)
          m[h][j & 3] = fmaxf(m[h][j & 3], fmaxf((float)d[4 * j + 2 * h], (float)d[4 * j + 2 * h + 1]));
      }
      const float bmax = fmaxf(bm[0], bm[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h] = __fadd_rn(fmaxf(fmaxf(m[h][0], m[h][1]), fmaxf(m[h][2], m[h][3])), bmax);
    } else {
      mx[0] = mx[1] = ninf;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(vec + 8 * j);
        const float2 c2 = *reinterpret_cast<const float2*>(vec + TN + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int i = 4 * j + 2 * h + e2;
            // WIDE: `s32.astype(f32)`, exact below 2^24 (d_pad <= 1,040),
            // past it rounded to nearest even as `.float()` rounds; else
            // |s| < 2^22: s + 1.5 2^23 is exact in f32, and so is the
            // difference
            const float f =
                WIDE ? __int2float_rn((int)d[i])
                     : __fsub_rn(__int_as_float((int)d[i] + 0x4B400000), 12582912.f);
            x[i] = __fadd_rn(__fmul_rn(__fmul_rn(f, e2 ? c2.y : c2.x), rs[h]), e2 ? b.y : b.x);
            mx[h] = fmaxf(mx[h], x[i]);
          }
      }
    }
  }

  // The bf16 route's keys, where pass 2 runs: score + bias.
  template <class Acc>
  __device__ __forceinline__ void complete(const Acc (&d)[32], float (&x)[32],
                                           const float* vec) const {
    if constexpr (KIND == 0) {
      vec += low;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(vec + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int i = 4 * j + 2 * h + e2;
            x[i] = __fadd_rn((float)d[i], e2 ? b.y : b.x);
          }
      }
    }
  }

  __device__ __forceinline__ void set_t(int h, u64 nt) {
    t[h] = nt;
    bounds_of<ROUND>(nt, lo[h], hi[h], tpos[h]);
  }

  // Each row's bound at tile `tile` (columns tile TN ... of the piece): a
  // tile wholly past t's position adds only keys above t's (hi), others
  // may add keys equal to t's (lo).
  __device__ __forceinline__ void bounds_at(int tile, float (&eff)[2]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) eff[h] = (unsigned)(tile * TN) > tpos[h] ? hi[h] : lo[h];
  }

  // Whether a row of the warp may gain a composite from the tile whose
  // pass 1 gave mx: the warp's vote (straight-line code, no branch).
  __device__ __forceinline__ bool need(const float (&mx)[2], int tile) const {
    float eff[2];
    bounds_at(tile, eff);
    return __any_sync(FULL, mx[0] >= eff[0] || mx[1] >= eff[1]);
  }

  // Pass 2 of tile `tile`, where `need` said so: d and x as pass 1 had
  // them, vec as pass 1's.
  template <class Acc>
  __device__ __forceinline__ void select(const Acc (&d)[32], float (&x)[32], int tile,
                                         const float* vec) {
    const int col0 = tile * TN;
    float eff[2];
    bounds_at(tile, eff);
#ifdef COZO_SWEEP_COUNTERS
    n_pass2 += lane == 0;
#endif
    complete(d, x, vec);
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) m |= (x[i] >= eff[(i >> 1) & 1] ? 1u : 0u) << i;
    if constexpr (C::LISTS && !C::DEFER)
      insert_lists(x, m, col0);
    else
      append_tails(x, m, col0);
  }

  // Lists of 8: each quad's candidates of row h, one a quad at a time, into
  // the row's list: the quad counts the entries above it and shifts the
  // rest down.
  __device__ __forceinline__ void insert_lists(const float (&x)[32], unsigned m, int col0) {
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
        const int c = rank_in_list(h, cv);
        insert_at(h, c, cv, active);
#ifdef COZO_SWEEP_COUNTERS
        n_keyed += active && lane == src;
        n_rejected += active && lane == src && c >= kc;
#endif
        const u64 nt = __shfl_sync(FULL, sel_n<C::L>(E[h], tj), qbase + tk);
        if (active) set_t(h, nt);
      }
    }
  }

  // The entries of row h's list above cv (the quad's sum).
  __device__ __forceinline__ int rank_in_list(int h, u64 cv) const {
    int c = 0;
#pragma unroll
    for (int j = 0; j < C::L; ++j) c += E[h][j] > cv;
    c += __shfl_xor_sync(FULL, c, 1);
    return c + __shfl_xor_sync(FULL, c, 2);
  }

  // cv into row h's list at rank c (if active and c < kc): the entries at
  // or past rank c move one down.
  __device__ __forceinline__ void insert_at(int h, int c, u64 cv, bool active) {
    const u64 prev = __shfl_up_sync(FULL, E[h][C::L - 1], 1);
    if (active && c < kc) {
#pragma unroll
      for (int j = C::L - 1; j >= 0; --j) {
        const int g = C::L * qk + j;
        E[h][j] = g > c ? (j ? E[h][j - 1] : prev) : (g == c ? cv : E[h][j]);
      }
    }
  }

  // Lists of 16: every row's tail into its list, the warp's rows at once.  Each
  // quad takes its row's appends one a round: it counts the list's entries
  // above one and shifts the rest down; the row's kc-th is then its t.
  __device__ __forceinline__ void flush_lists() {
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const u64* tail = bufs + (size_t)row[h] * C::BUF;
      const int n = cnt[row[h]];
      int rounds = n;  // the warp's longest tail
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        const int other = __shfl_xor_sync(FULL, rounds, o);
        rounds = other > rounds ? other : rounds;
      }
      for (int k = 0; k < rounds; ++k) {
        const bool active = k < n;
        const u64 cv = active ? tail[k] : 0ull;
        const int c = rank_in_list(h, cv);
        insert_at(h, c, cv, active);
#ifdef COZO_SWEEP_COUNTERS
        n_rejected += active && qk == 0 && c >= kc;
#endif
      }
      set_t(h, __shfl_sync(FULL, sel_n<C::L>(E[h], tj), qbase + tk));
    }
    __syncwarp();
    if (qk == 0) cnt[row[0]] = cnt[row[1]] = 0;
    __syncwarp();
  }

  // Merges row r's tail (c entries) into its head; returns the new t.
  // (Heads and tails alone.)
  __device__ __forceinline__ u64 merge_row(int r) {
    u64* head = bufs + (size_t)r * C::BUF;
    u64* tail = head + C::HEAD;
    const int c = cnt[r];
    for (int i = lane; i < C::TAIL; i += 32)
      if (i >= c) tail[i] = 0;
    warp_sort_n<C::TAIL>(tail, lane);
    // the top HEAD of head and tail: the larger of head[HEAD - 1 - j] and
    // tail[j], a bitonic sequence
    for (int j = lane; j < C::TAIL; j += 32) {
      const u64 hv = head[C::HEAD - 1 - j], tv = tail[j];
      if (tv > hv) head[C::HEAD - 1 - j] = tv;
    }
    __syncwarp();
    warp_bitonic_merge_n<C::HEAD>(head, lane);
    const u64 nt = head[kc - 1];
    __syncwarp();
    if (lane == 0) cnt[r] = 0;
    __syncwarp();
    return nt;
  }

  // Every composite above its row's t into the row's tail; rows past HIGH
  // are merged, and their t raised.
  __device__ __forceinline__ void append_tails(const float (&x)[32], unsigned m, int col0) {
    while (m) {
      const int i = __ffs((int)m) - 1;
      m &= m - 1;
      const int h = (i >> 1) & 1;
      const float xv = pick32(x, i);
      const float key = ROUND ? bf16_round(xv) : xv;
      const unsigned pos = (unsigned)(col0 + 8 * (i >> 2) + low + (i & 1));
      const u64 cv = ((u64)order_key(key) << 32) | (u64)(~pos);
      const bool in = cv > (h ? t[1] : t[0]);
      if (in) {
        const int r = h ? row[1] : row[0];
        const int slot = atomicAdd(cnt + r, 1);
        bufs[(size_t)r * C::BUF + C::HEAD + slot] = cv;
      }
#ifdef COZO_SWEEP_COUNTERS
      ++n_keyed;
      n_rejected += !in;
#endif
    }
    __syncwarp();
    if constexpr (C::LISTS) {
      if (__any_sync(FULL, cnt[row[0]] > C::HIGH || cnt[row[1]] > C::HIGH)) flush_lists();
    } else {
      const bool lead = (lane & 3) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // bit 4q: quad q's row h, wrow0 + q + 8 h
        unsigned need = __ballot_sync(FULL, lead && cnt[row[h]] > C::HIGH);
        while (need) {
          const int r = wrow0 + ((__ffs((int)need) - 1) >> 2) + 8 * h;
          need &= need - 1;
          const u64 nt = merge_row(r);
          if (r == row[h]) set_t(h, nt);
        }
      }
    }
  }

  // Two consumers on one block's rows (the wide form), each selecting the
  // tiles of its own groups in turn with the other: the heads and tails in
  // shared memory are one state, whose t the other consumer may have raised
  // since this thread last read it (t is always its head's kc-th).  The
  // lists are each consumer's own (registers); their shared tail is
  // flushed into the lists of the consumer that flushes it.
  __device__ __forceinline__ void sync_t() {
    if constexpr (!C::LISTS) {
#pragma unroll
      for (int h = 0; h < 2; ++h) set_t(h, bufs[(size_t)row[h] * C::BUF + kc - 1]);
    }
  }

  // Lists: this consumer's entries to `s` (a row's 4 L a row, in rank
  // order, 0 where empty) for the other consumer's `merge_lists`.
  __device__ __forceinline__ void dump_lists(u64* s) const {
    if constexpr (C::LISTS) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < C::L; ++j) s[(size_t)row[h] * 4 * C::L + C::L * qk + j] = E[h][j];
    }
  }

  // Lists: the other consumer's first kc entries of each row, from `s`,
  // into this one's (each quad one entry a round, as `flush_lists`).
  __device__ __forceinline__ void merge_lists(const u64* s) {
    if constexpr (C::LISTS) {
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const u64* other = s + (size_t)row[h] * 4 * C::L;
        for (int k = 0; k < kc; ++k) {
          const u64 cv = other[k];
          const int c = rank_in_list(h, cv);
          insert_at(h, c, cv, cv != 0);
        }
        set_t(h, __shfl_sync(FULL, sel_n<C::L>(E[h], tj), qbase + tk));
      }
      __syncwarp();
    }
  }

  // The piece's end: each row's first kc, written out (rows past B are not).
  __device__ __forceinline__ void finish(const Args& a, int piece_idx) {
    const long long col_base = (long long)piece_idx * a.piece;
    if constexpr (C::LISTS) {
      if constexpr (C::DEFER) flush_lists();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long g = g0 + row[h];
        if (g >= a.B) continue;
        const long long o = g * a.ldo + (long long)piece_idx * kc;
#pragma unroll
        for (int j = 0; j < C::L; ++j) {
          const int i = C::L * qk + j;
          if (i < kc) write_entry<KIND>(a, o + i, E[h][j], col_base);
        }
      }
    } else {
      for (int r = wrow0; r < wrow0 + 16; ++r) {
        const long long g = g0 + r;
        if (g >= a.B) break;  // rows past B: the rest of the warp's are too
        if (cnt[r] > 0) merge_row(r);
        const u64* head = bufs + (size_t)r * C::BUF;
        const long long o = g * a.ldo + (long long)piece_idx * kc;
        for (int i = lane; i < kc; i += 32) write_entry<KIND>(a, o + i, head[i], col_base);
      }
    }
#ifdef COZO_SWEEP_COUNTERS
    atomicAdd(&sweep_counts[0], (unsigned long long)n_pass2);
    atomicAdd(&sweep_counts[1], (unsigned long long)n_keyed);
    atomicAdd(&sweep_counts[2], (unsigned long long)n_rejected);
#endif
  }
};

}  // namespace cozo_sweep
