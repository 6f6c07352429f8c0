// The label pick of synchronous label propagation for Hopper (sm_90a): the
// weighted mode of the in-neighbours' labels, per padded row, ties to the
// smallest label.
//
// Replaces the TPU functions `_lp_dense_pick` and `_lane_pick_scan`
// (cozo_tpu/ops/graph_algos.py:1174-1208, 1264-1294), which run inside
// `_labelprop_dense_compiled`, `_labelprop_dense_step_compiled` and
// `_labelprop_lanes_compiled`.  They compare every slot's label with every
// other slot's through a [blk, W, W] f32 equality tensor and a batched
// product (about 512 MB a block, `_lane_blk`), scanned over row blocks.
// Nothing of that size is built here, and no row costs W * W:
//
//   - W <= 32 (the dense layout's narrow rows, the lanes of 8-32): a warp
//     takes 32 / G rows (G = W rounded up to a power of two), one slot a
//     lane, in registers.  The warp puts its 32 labels (EMPTY where the
//     slot is invalid) in shared memory, and each lane reads its row's G
//     labels back four to a 16-byte load: with unit weights it counts those
//     equal to its own, with weights it adds their weights in slot order.
//     (`__match_any_sync` names the equal lanes in one instruction, but its
//     time grows with the distinct labels in the whole warp: on an H100
//     the W = 16 lane took 0.364 ms at random labels and 0.284 at
//     converged ones with it, 0.284 at both with the loads; G shuffles a
//     row cost more than the loads.)
//     The best (largest sum, then smallest label) comes from a shuffle
//     reduction inside the row's lanes, the smallest label only where a
//     row has no valid slot.  A warp loads BATCH such groups of rows (the
//     row ids and neighbour ids, then every label gather) before it uses
//     the first, and skips the work of a group of padding rows.
//   - 32 < W <= 128 (dense rows up to LP_DENSE_DMAX, lanes of 64 and 128):
//     a warp a row, W / 32 slots a lane, the row's labels and weights in
//     the warp's shared memory read back four to a load as above (each
//     lane compares its W / 32 labels with all W: W * W / 4 loads and
//     compares a row, no atomics), except unit weights at W = 128, which
//     count in a table as below (half the time there).
//   - W > 128 (lanes up to COZO_TPU_LP_TIER_MAX = 8192): a block a row, in
//     dynamic shared memory (past 48 KB for the widest rows, so the
//     launcher raises the block's limit).  With unit weights every valid
//     slot counts its label in an open-addressing table of 2 P entries (P
//     = W rounded up to a power of two; integer atomics, exact in any
//     order), and the table's entries are reduced to the best: W
//     operations a row.  With weights the row's (label, valid, slot) keys
//     are sorted by a bitonic network in shared memory, so the slots of
//     one label form a run, invalid ones first and valid ones in slot
//     order; the position that ends a run finds its first valid key by a
//     binary search and adds those weights in slot order: W log^2 W
//     operations a row.
// Either way a weighted sum is added in slot order, the order of the W * W
// scan this kernel replaced, and nothing is a float atomic: two runs are
// bit-identical.
//
// What bounds it: bytes, and of those the label gather.  A row reads its
// W neighbour ids (4 B each, coalesced), its weights where there are any,
// gathers one label a slot (a random 4-byte read: a 32-byte sector of L2
// traffic; a 5M-node label array stays in the 50 MB L2) and writes one
// label.  The narrow variant issues ~30 warp instructions a row at W =
// 16 where a scalar W * W scan issues ~120, so at the widths the rules
// meet what is left is the gather: its L2 sectors (32 B for each 4-byte
// label) and its latency, overlapped across BATCH groups and many
// resident warps.
//
// Semantics, as the JAX pick:
//   - a slot is valid when its weight is > 0 (weighted rows; the staging
//     clamps weights to >= 0), or when its neighbour is not the dummy node
//     (unit weights, never materialised);
//   - wsum(c) is the summed weight of the slots whose label equals slot c's
//     (invalid slots weigh 0), taken over valid slots c only; the pick is the
//     smallest label among the slots of the largest wsum;
//   - a row without a valid slot picks the smallest label among all its
//     slots, as the JAX pick does (every wsum is -inf there);
//   - the dense layout (no `idx`): row h is node h; rows with no in-edge, or
//     past n_real, copy their label;
//   - lanes (`idx`): row h writes node idx[h]; padding rows (idx = dummy)
//     are skipped, and `labels_out` must already hold `labels_in` for the
//     nodes no lane writes.
// Unit weights make every sum an exact integer.  Other weights are summed
// in slot order: a near-tie may resolve differently from the XLA product's
// order, where the two orders round differently.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifndef COZO_LP_THREADS
#define COZO_LP_THREADS 256
#endif

constexpr int NTHREADS = COZO_LP_THREADS;
constexpr int WARPS = NTHREADS / 32;
constexpr int NARROW_W = 32;  // widest row the narrow variant takes
constexpr int WARP_W = 128;   // widest row the warp-sort variant takes
constexpr int MAX_W = 8192;   // widest row the block variant takes
constexpr int BATCH = 4;      // row groups a warp of the narrow variant loads at once
constexpr unsigned FULL = 0xffffffffu;
typedef unsigned long long u64;
constexpr u64 VALID_BIT = 1ull << 16;  // keys: label ^ sign (32) | valid (1) | slot (16)
constexpr u64 SLOT_MASK = 0xffffull;
constexpr u64 PAD_KEY = ~0ull;         // a position past W: sorts last
constexpr int EMPTY = INT_MIN;  // no label: labels are node ids, never this

// (weight, label) order of the pick: a larger weight wins, then a smaller
// label.
__device__ __forceinline__ void take_better(float& bw, int& bl, float w, int l) {
  if (w > bw || (w == bw && l < bl)) {
    bw = w;
    bl = l;
  }
}

__device__ __forceinline__ u64 make_key(int label, bool valid, int slot) {
  return ((u64)((unsigned)label ^ 0x80000000u) << 32) | (valid ? VALID_BIT : 0) | (u64)slot;
}

__device__ __forceinline__ int key_label(u64 k) {
  return (int)((unsigned)(k >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ bool slot_valid(const float* w, float wv, int x, int dummy) {
  return w != nullptr ? wv > 0.0f : x != dummy;
}

// Weights past 32 slots: the row's best (weight, label) over the runs of
// equal labels that end at positions first, first + step, ... of its
// sorted keys ks[0, W); sw holds each slot's weight (0 where invalid).  A
// run holds its invalid slots first and its valid ones in slot order; the
// run's end finds the first valid one by a binary search and adds their
// weights in slot order.
__device__ __forceinline__ void scan_runs(const u64* ks, const float* sw, int W, int first,
                                          int step, float& bw, int& bl) {
  for (int p = first; p < W; p += step) {
    const u64 label_hi = ks[p] >> 32;
    if (p + 1 < W && (ks[p + 1] >> 32) == label_hi) continue;  // not the run's end
    const u64 target = (label_hi << 32) | VALID_BIT;
    int lo = 0, up = p + 1;  // the first key >= target: the run's first valid slot
    while (lo < up) {
      const int mid = (lo + up) >> 1;
      if (ks[mid] < target)
        lo = mid + 1;
      else
        up = mid;
    }
    if (lo > p) continue;  // no valid slot holds this label
    float s = 0.0f;
    for (int q = lo; q <= p; ++q) s += sw[ks[q] & SLOT_MASK];
    take_better(bw, bl, s, key_label(ks[p]));
  }
}

__device__ __forceinline__ void warp_best(float& bw, int& bl) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w2 = __shfl_xor_sync(FULL, bw, o);
    const int l2 = __shfl_xor_sync(FULL, bl, o);
    take_better(bw, bl, w2, l2);
  }
}

// W <= 32: a warp takes 32 / G rows at a time, BATCH times over.
template <int G>
__global__ void __launch_bounds__(NTHREADS)
    pick_narrow(const int* __restrict__ nb, const float* __restrict__ w, const int* __restrict__ idx,
               const uint8_t* __restrict__ has_in, int H, int W, int n_real, int dummy,
               const int* __restrict__ labels_in, int* __restrict__ labels_out) {
  constexpr int RPW = 32 / G;  // rows a warp takes at once
  __shared__ int4 s_lab[WARPS][8];  // a warp's 32 labels (EMPTY where invalid)
  __shared__ float4 s_w[WARPS][8];
  const int lane = threadIdx.x & 31;
  const int c = lane & (G - 1);  // the lane's slot
  const int base = lane & ~(G - 1);
  const long long row0 =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * (RPW * BATCH) + lane / G;
  long long h[BATCH];
  int x[BATCH], node[BATCH], lab[BATCH];
  float wt[BATCH];
  bool act[BATCH];
  // the row ids and neighbour ids (and weights) of every group, then every
  // label gather, before the first use
#pragma unroll
  for (int b = 0; b < BATCH; ++b) {
    h[b] = row0 + b * RPW;
    const bool in_row = h[b] < H && (idx != nullptr || h[b] < n_real);
    node[b] = !in_row ? dummy : idx != nullptr ? idx[h[b]] : (int)h[b];
    act[b] = in_row && (idx != nullptr || has_in[h[b]]);
    const bool in = in_row && c < W;
    x[b] = in ? nb[h[b] * W + c] : dummy;
    wt[b] = in && w != nullptr ? w[h[b] * W + c] : 0.0f;
  }
#pragma unroll
  for (int b = 0; b < BATCH; ++b) {
    // a padding row's slots all name the dummy: one cached address
    lab[b] = c < W ? labels_in[x[b]] : INT_MAX;
    if (idx != nullptr) act[b] = act[b] && node[b] != dummy;
  }
  int4* sl4 = s_lab[threadIdx.x >> 5];
  float4* sw4 = s_w[threadIdx.x >> 5];
  int* sl = (int*)sl4;
  float* sw = (float*)sw4;
#pragma unroll
  for (int b = 0; b < BATCH; ++b) {
    const bool present = act[b] && c < W;
    const bool valid = present && slot_valid(w, wt[b], x[b], dummy);
    float bw = -INFINITY;
    int bl = INT_MAX;
    if (__ballot_sync(FULL, act[b]) != 0) {  // warp-uniform: a group of padding rows skips
      // the row's labels through the warp's shared memory, 4 a load: a
      // count of the valid ones equal to the lane's own (unit weights), or
      // their weights added in slot order
      sl[lane] = valid ? lab[b] : EMPTY;
      if (w != nullptr) sw[lane] = wt[b];
      __syncwarp();
      int cnt = 0;
      float s = 0.0f;
      if constexpr (G >= 4) {
#pragma unroll
        for (int q = 0; q < G / 4; ++q) {
          const int4 l4 = sl4[base / 4 + q];
          if (w == nullptr) {
            cnt += (l4.x == lab[b]) + (l4.y == lab[b]) + (l4.z == lab[b]) + (l4.w == lab[b]);
          } else {
            const float4 w4 = sw4[base / 4 + q];
            if (l4.x == lab[b]) s += w4.x;
            if (l4.y == lab[b]) s += w4.y;
            if (l4.z == lab[b]) s += w4.z;
            if (l4.w == lab[b]) s += w4.w;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (sl[base + j] == lab[b]) {
            cnt += 1;
            s += sw[base + j];
          }
        }
      }
      __syncwarp();
      if (valid) {
        bw = w == nullptr ? (float)cnt : s;
        bl = lab[b];
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        const float w2 = __shfl_xor_sync(FULL, bw, o);
        const int l2 = __shfl_xor_sync(FULL, bl, o);
        take_better(bw, bl, w2, l2);
      }
      // a row without a valid slot takes its smallest label
      if (__ballot_sync(FULL, present && bw == -INFINITY) != 0) {
        int mn = present ? lab[b] : INT_MAX;
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) {
          const int m2 = __shfl_xor_sync(FULL, mn, o);
          mn = m2 < mn ? m2 : mn;
        }
        if (bw == -INFINITY) bl = mn;
      }
    }
    if (c == 0 && h[b] < H) {
      if (act[b])
        labels_out[node[b]] = bl;
      else if (idx == nullptr)
        labels_out[h[b]] = labels_in[h[b]];
    }
  }
}

// Unit weights past 32 slots: each valid slot counts its label in an
// open-addressing table of T = 2P entries (keys, then counts); integer
// counts are exact in any order.

__device__ __forceinline__ void count_label(int* keys, int* counts, int label, int bits) {
  const unsigned mask = (1u << bits) - 1;
  unsigned h = ((unsigned)label * 2654435761u) >> (32 - bits);
  while (true) {
    const int prev = atomicCAS(keys + h, EMPTY, label);
    if (prev == EMPTY || prev == label) {
      atomicAdd(counts + h, 1);
      return;
    }
    h = (h + 1) & mask;
  }
}

// The best (count, label) over the table's entries first, first + step, ...
__device__ __forceinline__ void scan_table(const int* keys, const int* counts, int T, int first,
                                           int step, float& bw, int& bl) {
  for (int i = first; i < T; i += step)
    if (keys[i] != EMPTY) take_better(bw, bl, (float)counts[i], keys[i]);
}

__device__ __forceinline__ void warp_best_min(float& bw, int& bl, int& mn) {
  warp_best(bw, bl);
  for (int o = 16; o > 0; o >>= 1) {
    const int m2 = __shfl_xor_sync(FULL, mn, o);
    mn = m2 < mn ? m2 : mn;
  }
}

// The loads' pick for a warp's row: the row's labels (EMPTY where invalid)
// and weights into `buf` (8 P bytes), then each lane's best (count or
// slot-ordered weight sum, then smallest label) over its own slots.
template <int P>
__device__ __forceinline__ void pick_by_loads(int4* buf, const float* w, const int (&x)[P / 32],
                                              const float (&wt)[P / 32],
                                              const int (&lab)[P / 32], int W, int dummy,
                                              int lane, float& bw, int& bl) {
  constexpr int E = P / 32;
  int* sl = (int*)buf;
  float* sw = (float*)(buf + P / 4);
  const float4* sw4 = (const float4*)(buf + P / 4);
  bool valid[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = e * 32 + lane;
    valid[e] = c < W && slot_valid(w, wt[e], x[e], dummy);
    sl[c] = valid[e] ? lab[e] : EMPTY;
    if (w != nullptr) sw[c] = wt[e];
  }
  __syncwarp();
  int cnt[E];
  float s[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cnt[e] = 0;
    s[e] = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {  // slot order
    const int4 l4 = buf[q];
    if (w == nullptr) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        cnt[e] += (l4.x == lab[e]) + (l4.y == lab[e]) + (l4.z == lab[e]) + (l4.w == lab[e]);
    } else {
      const float4 w4 = sw4[q];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (l4.x == lab[e]) s[e] += w4.x;
        if (l4.y == lab[e]) s[e] += w4.y;
        if (l4.z == lab[e]) s[e] += w4.z;
        if (l4.w == lab[e]) s[e] += w4.w;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (valid[e]) take_better(bw, bl, w == nullptr ? (float)cnt[e] : s[e], lab[e]);
}

// 32 < W <= 128: a warp a row (P = W rounded up to a power of two), W / 32
// slots a lane.  The row's labels (EMPTY where invalid) and weights go to
// the warp's shared memory, and each lane reads them back four to a
// 16-byte load, counting those equal to each of its own labels, or adding
// their weights in slot order: P * P / 4 loads and compares a row.  Unit
// weights at P = 128 count in a table of 2 P entries instead, as the block
// variant does, where the loads' compares grow fourfold; at P = 64 the
// table was faster on a lane of 557,056 rows (0.25-0.29 ms against 0.32
// on an H100) but slower than a W * W scan on a lane of 32,768 rows of
// which ~35 hold edges (0.0054 against 0.0039; the loads 0.0036), where
// one row's chain of shared-memory atomics is the time.
template <int P>
__global__ void __launch_bounds__(NTHREADS)
    pick_warp(const int* __restrict__ nb, const float* __restrict__ w, const int* __restrict__ idx,
              const uint8_t* __restrict__ has_in, int H, int W, int n_real, int dummy,
              const int* __restrict__ labels_in, int* __restrict__ labels_out) {
  static_assert(P == 64 || P == 128, "the warp variant takes 32 < W <= 128");
  constexpr int E = P / 32;
  constexpr bool TABLE = P == 128;  // for unit weights
  __shared__ int4 s_row[WARPS][P];  // 16 P bytes: the table, or the labels and weights
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x * WARPS + warp;
  if (h >= H) return;  // warp-uniform
  int node = h;
  if (idx != nullptr) {
    node = idx[h];
    if (node == dummy) return;
  } else if (!(h < n_real && has_in[h])) {
    if (lane == 0) labels_out[h] = labels_in[h];
    return;
  }
  const long long row = (long long)h * W;
  int x[E], lab[E];
  float wt[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = e * 32 + lane;
    x[e] = c < W ? nb[row + c] : dummy;
    wt[e] = c < W && w != nullptr ? w[row + c] : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) lab[e] = e * 32 + lane < W ? labels_in[x[e]] : INT_MAX;
  float bw = -INFINITY;
  int bl = INT_MAX;
  if (TABLE && w == nullptr) {
    int* keys = (int*)s_row[warp];
    int* counts = keys + 2 * P;
    for (int i = lane; i < 2 * P; i += 32) {
      keys[i] = EMPTY;
      counts[i] = 0;
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e)  // 2 P = 2^8 entries
      if (e * 32 + lane < W && x[e] != dummy) count_label(keys, counts, lab[e], 8);
    __syncwarp();
    scan_table(keys, counts, 2 * P, lane, 32, bw, bl);
  } else {
    pick_by_loads<P>(s_row[warp], w, x, wt, lab, W, dummy, lane, bw, bl);
  }
  warp_best(bw, bl);
  if (bw == -INFINITY) {  // warp-uniform: no valid slot, the smallest label
    int mn = INT_MAX;
#pragma unroll
    for (int e = 0; e < E; ++e) mn = lab[e] < mn ? lab[e] : mn;
    for (int o = 16; o > 0; o >>= 1) {
      const int m2 = __shfl_xor_sync(FULL, mn, o);
      mn = m2 < mn ? m2 : mn;
    }
    bl = mn;
  }
  if (lane == 0) labels_out[node] = bl;
  __syncwarp();
}

// W > 128: a block a row (P = W rounded up to a power of two).  Dynamic
// shared memory holds the table (unit weights: 16 P bytes) or the keys and
// weights (8 P + 4 W), sorted by a bitonic network.
__global__ void __launch_bounds__(NTHREADS)
    pick_block(const int* __restrict__ nb, const float* __restrict__ w, const int* __restrict__ idx,
               const uint8_t* __restrict__ has_in, int H, int W, int P, int n_real, int dummy,
               const int* __restrict__ labels_in, int* __restrict__ labels_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float r_w[WARPS];
  __shared__ int r_l[WARPS], r_m[WARPS];
  const int h = blockIdx.x;
  int node = h;
  if (idx != nullptr) {
    node = idx[h];
    if (node == dummy) return;  // block-uniform
  } else if (!(h < n_real && has_in[h])) {
    if (threadIdx.x == 0) labels_out[h] = labels_in[h];
    return;
  }
  const long long row = (long long)h * W;
  float bw = -INFINITY;
  int bl = INT_MAX, mn = INT_MAX;
  if (w == nullptr) {
    int* keys = (int*)smem;
    int* counts = keys + 2 * P;
    for (int i = threadIdx.x; i < 2 * P; i += NTHREADS) {
      keys[i] = EMPTY;
      counts[i] = 0;
    }
    __syncthreads();
    int bits = 0;
    while ((1 << bits) < 2 * P) ++bits;
#pragma unroll 4
    for (int c = threadIdx.x; c < W; c += NTHREADS) {
      const int x = nb[row + c];
      const int l = labels_in[x];
      mn = l < mn ? l : mn;
      if (x != dummy) count_label(keys, counts, l, bits);
    }
    __syncthreads();
    scan_table(keys, counts, 2 * P, threadIdx.x, NTHREADS, bw, bl);
  } else {
    u64* ks = (u64*)smem;
    float* sw = (float*)(smem + 8 * (size_t)P);
#pragma unroll 4
    for (int c = threadIdx.x; c < P; c += NTHREADS) {
      if (c < W) {
        const float wv = w[row + c];
        const int x = nb[row + c];
        const bool valid = wv > 0.0f;
        ks[c] = make_key(labels_in[x], valid, c);
        sw[c] = valid ? wv : 0.0f;
      } else {
        ks[c] = PAD_KEY;
      }
    }
    __syncthreads();
    for (int size = 2; size <= P; size <<= 1) {
      for (int j = size >> 1; j > 0; j >>= 1) {
        for (int t = threadIdx.x; t < P / 2; t += NTHREADS) {
          const int i = 2 * j * (t / j) + (t % j);  // the pair (i, i + j)
          const u64 a = ks[i], b = ks[i + j];
          if ((a > b) == ((i & size) == 0)) {
            ks[i] = b;
            ks[i + j] = a;
          }
        }
        __syncthreads();
      }
    }
    scan_runs(ks, sw, W, threadIdx.x, NTHREADS, bw, bl);
    mn = key_label(ks[0]);
  }
  warp_best_min(bw, bl, mn);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    r_w[warp] = bw;
    r_l[warp] = bl;
    r_m[warp] = mn;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < WARPS; ++i) {
      take_better(bw, bl, r_w[i], r_l[i]);
      mn = r_m[i] < mn ? r_m[i] : mn;
    }
    labels_out[node] = bw == -INFINITY ? mn : bl;
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Enqueues one pick over the rows nb [H, W] i32 (w [H, W] f32, or null for
// unit weights) on `stream`; returns 0 when the kernel was launched, else a
// cudaError_t.  idx [H] i32 (lanes) or null (the dense layout, which then
// reads has_in [H] u8 and n_real).  Reads labels_in [n_pad] i32, writes
// labels_out [n_pad] i32 as described above.
int cozo_lp_pick(const void* nb, const void* w, const void* idx, const void* has_in, int H, int W,
                 int n_real, int dummy, const void* labels_in, void* labels_out, void* stream) {
  if (H < 0 || W < 1 || W > MAX_W || (idx == nullptr && has_in == nullptr))
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int* nb_ = (const int*)nb;
  const float* w_ = (const float*)w;
  const int* idx_ = (const int*)idx;
  const uint8_t* has_in_ = (const uint8_t*)has_in;
  const int* lin = (const int*)labels_in;
  int* lout = (int*)labels_out;
  const int P = pow2_at_least(W);
  if (W <= NARROW_W) {
    const int rows = WARPS * (32 / P) * BATCH;  // rows a block takes
    const int grid = (int)(((long long)H + rows - 1) / rows);
    auto kern = P == 1    ? pick_narrow<1>
                : P == 2  ? pick_narrow<2>
                : P == 4  ? pick_narrow<4>
                : P == 8  ? pick_narrow<8>
                : P == 16 ? pick_narrow<16>
                          : pick_narrow<32>;
    kern<<<grid, NTHREADS, 0, st>>>(nb_, w_, idx_, has_in_, H, W, n_real, dummy, lin, lout);
  } else if (W <= WARP_W) {
    auto kern = P == 64 ? pick_warp<64> : pick_warp<128>;
    kern<<<(H + WARPS - 1) / WARPS, NTHREADS, 0, st>>>(nb_, w_, idx_, has_in_, H, W, n_real,
                                                        dummy, lin, lout);
  } else {
    const int smem = w == nullptr ? 16 * P : 8 * P + 4 * W;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(pick_block, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    pick_block<<<H, NTHREADS, smem, st>>>(nb_, w_, idx_, has_in_, H, W, P, n_real, dummy, lin,
                                          lout);
  }
  return (int)cudaGetLastError();
}

const char* cozo_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
