// The label pick of synchronous label propagation for Hopper (sm_90a): the
// weighted mode of the in-neighbours' labels, per padded row, ties to the
// smallest label.
//
// Replaces the TPU functions `_lp_dense_pick` and `_lane_pick_scan`
// (cozo_tpu/ops/graph_algos.py:1174-1208, 1264-1294), which run inside
// `_labelprop_dense_compiled`, `_labelprop_dense_step_compiled` and
// `_labelprop_lanes_compiled`.  They compare every slot's label with every
// other slot's through a [blk, W, W] f32 equality tensor and a batched
// product (about 512 MB a block, `_lane_blk`), scanned over row blocks.  Here
// a row's labels and weights sit in shared memory and nothing else is
// built: each slot's summed weight is a loop over the row, kept in a
// register.
//
// One source, two variants:
//   - W <= 128 (the dense layout, max in-degree <= LP_DENSE_DMAX, and the
//     narrow lanes): one warp per row, the row in the warp's own 1 KB of
//     shared memory;
//   - wider lanes (up to COZO_TPU_LP_TIER_MAX = 8192): one block per row,
//     the row in dynamic shared memory (8 B a slot: 64 KB at 8,192, past the
//     48 KB default, so the launcher raises the block's limit).
//
// What bounds it: operations.  A row costs W * W compare-and-adds (the JAX
// function's cost too, without its memory traffic); the bytes are one read
// of the row's neighbour ids and weights and one gather of W labels.  At the
// widths the rules meet (dense rows of 8-128, a few wide lanes) the pick
// is a fraction of the gather.  Sorting each row would cut the operations to
// W log W; that is work for a later version.
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
constexpr int WARP_W = 128;     // widest row the warp variant takes
constexpr int MAX_W = 8192;     // widest row the block variant takes
constexpr unsigned FULL = 0xffffffffu;

// (weight, label) order of the pick: a larger weight wins, then a smaller
// label.
__device__ __forceinline__ void take_better(float& bw, int& bl, float w, int l) {
  if (w > bw || (w == bw && l < bl)) {
    bw = w;
    bl = l;
  }
}

__device__ __forceinline__ void warp_best(float& bw, int& bl, int& mn) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w2 = __shfl_xor_sync(FULL, bw, o);
    const int l2 = __shfl_xor_sync(FULL, bl, o);
    const int m2 = __shfl_xor_sync(FULL, mn, o);
    take_better(bw, bl, w2, l2);
    mn = m2 < mn ? m2 : mn;
  }
}

// The row's best (weight, label) over the slots c = first, first + step, ...
// of the row held in sl (labels) and sw (weights, 0 where invalid), and the
// smallest label of those slots.
__device__ __forceinline__ void scan_slots(const int* sl, const float* sw, int W, int first,
                                           int step, float& bw, int& bl, int& mn) {
  for (int c = first; c < W; c += step) {
    const int l = sl[c];
    mn = l < mn ? l : mn;
    if (!(sw[c] > 0.0f)) continue;
    float s = 0.0f;
    for (int q = 0; q < W; ++q)
      if (sl[q] == l) s += sw[q];
    take_better(bw, bl, s, l);
  }
}

__device__ __forceinline__ void load_slot(const int* __restrict__ nb, const float* __restrict__ w,
                                          const int* __restrict__ labels_in, long long at,
                                          int dummy, int* sl, float* sw, int c) {
  const int x = nb[at];
  sl[c] = labels_in[x];
  if (w != nullptr) {
    const float wv = w[at];
    sw[c] = wv > 0.0f ? wv : 0.0f;
  } else {
    sw[c] = x != dummy ? 1.0f : 0.0f;
  }
}

// One warp per row (W <= 128).
__global__ void __launch_bounds__(NTHREADS)
    pick_warp(const int* __restrict__ nb, const float* __restrict__ w, const int* __restrict__ idx,
              const uint8_t* __restrict__ has_in, int H, int W, int n_real, int dummy,
              const int* __restrict__ labels_in, int* __restrict__ labels_out) {
  __shared__ int s_lab[WARPS][WARP_W];
  __shared__ float s_w[WARPS][WARP_W];
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
  int* sl = s_lab[warp];
  float* sw = s_w[warp];
  const long long row = (long long)h * W;
  for (int c = lane; c < W; c += 32) load_slot(nb, w, labels_in, row + c, dummy, sl, sw, c);
  __syncwarp();
  float bw = -INFINITY;
  int bl = INT_MAX, mn = INT_MAX;
  scan_slots(sl, sw, W, lane, 32, bw, bl, mn);
  warp_best(bw, bl, mn);
  if (lane == 0) labels_out[node] = bw == -INFINITY ? mn : bl;
  __syncwarp();
}

// One block per row (128 < W <= 8192); the row in dynamic shared memory.
__global__ void __launch_bounds__(NTHREADS)
    pick_block(const int* __restrict__ nb, const float* __restrict__ w, const int* __restrict__ idx,
               const uint8_t* __restrict__ has_in, int H, int W, int n_real, int dummy,
               const int* __restrict__ labels_in, int* __restrict__ labels_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float r_w[WARPS];
  __shared__ int r_l[WARPS], r_m[WARPS];
  int* sl = (int*)smem;
  float* sw = (float*)(smem + 4 * (size_t)W);
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
  for (int c = threadIdx.x; c < W; c += NTHREADS)
    load_slot(nb, w, labels_in, row + c, dummy, sl, sw, c);
  __syncthreads();
  float bw = -INFINITY;
  int bl = INT_MAX, mn = INT_MAX;
  scan_slots(sl, sw, W, threadIdx.x, NTHREADS, bw, bl, mn);
  warp_best(bw, bl, mn);
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
  if (W <= WARP_W) {
    pick_warp<<<(H + WARPS - 1) / WARPS, NTHREADS, 0, st>>>(
        (const int*)nb, (const float*)w, (const int*)idx, (const uint8_t*)has_in, H, W, n_real,
        dummy, (const int*)labels_in, (int*)labels_out);
  } else {
    const int smem = 8 * W;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(pick_block, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    pick_block<<<H, NTHREADS, smem, st>>>(
        (const int*)nb, (const float*)w, (const int*)idx, (const uint8_t*)has_in, H, W, n_real,
        dummy, (const int*)labels_in, (int*)labels_out);
  }
  return (int)cudaGetLastError();
}

const char* cozo_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
