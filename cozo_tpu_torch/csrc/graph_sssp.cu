// Batched single-source shortest paths for Hopper (sm_90a): synchronous
// (Jacobi) Bellman-Ford over a sliced-ELL layout of the in-edges, then the
// parent witnesses, for up to thousands of sources at once.
//
// Replaces the TPU function `_sssp_compiled_ell` (cozo_tpu/ops/
// graph_algos.py:633-686): a `while_loop` of relaxations, vmapped over the
// sources, that stops at `max_iters` or when a step changes nothing.  There
// one step gathers every padded slot's candidate into a [S, P] array, takes
// per-row minima over the bucket reshapes, then per-node minima over each
// node's rows.  Here no candidate array exists: a thread owns one ELL row
// and keeps its minimum in a register, and the host reads the "changed"
// flags only every few steps (the wrapper's choice), never each step.
//
// The layout (`_stage_sssp_ell_meta`): the in-edges of a node are cut into
// rows of at most ELL_CAP_MAX = 1024 slots; rows of one power-of-two width
// `cap` form a bucket stored [cap, rows_p], rows on the minor axis, so the
// threads of a warp (neighbouring rows) read neighbouring addresses at
// every slot.  Padding slots name the dummy node n_pad - 1, whose distance
// stays +inf, so their candidate is +inf whatever their weight.  A node with
// more than 1024 in-edges has several rows; the level-2 layout [cap2, m_p]
// lists, per node, the positions of its rows (R_pad where there is none).
//
// What bounds it: bytes, and of those the gather.  A step reads every
// slot's source id (4 B, coalesced), its weight (4 B, or none: uniform
// weights come as one scalar) and the source's distance (a random 4 B
// gather for each of the up to eight sources a thread carries: a 32-byte
// sector of L2 traffic each, 3 GB a step at 96M slots, which is about the
// 0.75 ms a step takes on an NVIDIA H100), writes one row minimum per row
// and source, and reads them back once in the node pass.  Operations are
// one add and one min per slot and source.  The design therefore reads a slot's
// id and weight once for up to 8 sources (one thread, eight registers),
// instead of once per source, and unrolls a row's slot loop by 4 so that
// four slots' dependent loads (the id, then the distance it names) are in
// flight at once.
//
// Semantics kept from the JAX function:
//   - synchronous steps: step t reads buffer t % 2 and writes the other, so
//     a run cut at `max_iters` has the same distances as JAX's even before
//     convergence (an in-place Gauss-Seidel update would not);
//   - f32 candidates `dist[src] + w` and exact minima: any order gives the
//     same bits, so the kernel and the plain version agree exactly;
//   - the parent of v is the largest source index among the in-edges whose
//     candidate equals the final distance and is finite; -1 for the sources
//     themselves and for nodes that are unreached or have no in-edge.
// A node without in-edges is never written: both distance buffers start as
// the initial distances, so it keeps its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifndef COZO_SSSP_THREADS
#define COZO_SSSP_THREADS 256
#endif

constexpr int NTHREADS = COZO_SSSP_THREADS;
// A thread carries SG sources: 8, or 1 for a single-source call (eight
// registers fewer a carried array, so twice the threads fit on an SM).
constexpr int MAX_SG = 8;
constexpr int MAXB = 32;    // bucket descriptors (caps 1..1024: 11 at most)

struct Buckets {
  int n;
  int base[MAXB];        // first row (or level-2 column) of the bucket
  long long off[MAXB];   // first slot of the bucket in its flat array
  int cap[MAXB];         // slots per row
  int rows[MAXB];        // rows of the bucket (padded)
};

__device__ __forceinline__ int bucket_of(const Buckets& b, int r) {
  int i = 0;
  while (i + 1 < b.n && b.base[i + 1] <= r) ++i;
  return i;
}

// Row minima: rowmin[s, r] = min over r's slots of dist[s, src] + w.
template <int SG>
__global__ void __launch_bounds__(NTHREADS)
    relax_rows(const int* __restrict__ flat_src, const float* __restrict__ flat_w, float w_uni,
               Buckets bk, int R_pad, int row_blocks, int S, long long n_pad,
               const float* __restrict__ dist, float* __restrict__ rowmin) {
  const int g = blockIdx.x / row_blocks;
  const int r = (blockIdx.x % row_blocks) * NTHREADS + threadIdx.x;
  if (r >= R_pad) return;
  const int b = bucket_of(bk, r);
  const int cap = bk.cap[b], rows = bk.rows[b];
  const long long p = bk.off[b] + (r - bk.base[b]);
  const int s0 = g * SG;
  const int ns = S - s0 < SG ? S - s0 : SG;
  float m[SG];
#pragma unroll
  for (int k = 0; k < SG; ++k) m[k] = INFINITY;
#pragma unroll 4
  for (int c = 0; c < cap; ++c) {
    const long long q = p + (long long)c * rows;
    const int src = flat_src[q];
    const float w = flat_w != nullptr ? flat_w[q] : w_uni;
#pragma unroll
    for (int k = 0; k < SG; ++k)
      if (k < ns) m[k] = fminf(m[k], dist[(s0 + k) * n_pad + src] + w);
  }
#pragma unroll
  for (int k = 0; k < SG; ++k)
    if (k < ns) rowmin[(long long)(s0 + k) * R_pad + r] = m[k];
}

// Node minima over each node's rows (level 2), then the synchronous update
// dist_out[s, v] = min(dist_in[s, v], that minimum); flags a change.
template <int SG>
__global__ void __launch_bounds__(NTHREADS)
    relax_nodes(const float* __restrict__ rowmin, const int* __restrict__ l2, Buckets lb, int M,
                int col_blocks, int S, int R_pad, const int* __restrict__ out_nodes,
                long long n_pad, const float* __restrict__ dist_in, float* __restrict__ dist_out,
                int* __restrict__ changed) {
  const int g = blockIdx.x / col_blocks;
  const int j = (blockIdx.x % col_blocks) * NTHREADS + threadIdx.x;
  if (j >= M) return;
  const int v = out_nodes[j];
  if (v < 0) return;
  const int b = bucket_of(lb, j);
  const int cap = lb.cap[b], cols = lb.rows[b];
  const long long p = lb.off[b] + (j - lb.base[b]);
  const int s0 = g * SG;
  const int ns = S - s0 < SG ? S - s0 : SG;
  float m[SG];
#pragma unroll
  for (int k = 0; k < SG; ++k) m[k] = INFINITY;
  for (int c = 0; c < cap; ++c) {
    const int rp = l2[p + (long long)c * cols];
    if (rp >= R_pad) continue;
#pragma unroll
    for (int k = 0; k < SG; ++k)
      if (k < ns) m[k] = fminf(m[k], rowmin[(long long)(s0 + k) * R_pad + rp]);
  }
  bool any = false;
#pragma unroll
  for (int k = 0; k < SG; ++k) {
    if (k < ns) {
      const long long at = (s0 + k) * n_pad + v;
      const float old = dist_in[at];
      const float nw = fminf(old, m[k]);
      dist_out[at] = nw;
      any |= nw < old;
    }
  }
  if (any) *changed = 1;
}

// Row witnesses: the largest source among r's slots whose candidate equals
// the final distance of r's node and is finite, else -1.
template <int SG>
__global__ void __launch_bounds__(NTHREADS)
    parent_rows(const int* __restrict__ flat_src, const float* __restrict__ flat_w, float w_uni,
                Buckets bk, int R_pad, int row_blocks, int S, long long n_pad,
                const int* __restrict__ node_flat, const float* __restrict__ dist,
                int* __restrict__ rowwit) {
  const int g = blockIdx.x / row_blocks;
  const int r = (blockIdx.x % row_blocks) * NTHREADS + threadIdx.x;
  if (r >= R_pad) return;
  const int b = bucket_of(bk, r);
  const int cap = bk.cap[b], rows = bk.rows[b];
  const long long p = bk.off[b] + (r - bk.base[b]);
  const int node = node_flat[r];
  const int s0 = g * SG;
  const int ns = S - s0 < SG ? S - s0 : SG;
  float target[SG];
  int wit[SG];
#pragma unroll
  for (int k = 0; k < SG; ++k) {
    wit[k] = -1;
    target[k] = k < ns ? dist[(s0 + k) * n_pad + node] : INFINITY;
  }
#pragma unroll 4
  for (int c = 0; c < cap; ++c) {
    const long long q = p + (long long)c * rows;
    const int src = flat_src[q];
    const float w = flat_w != nullptr ? flat_w[q] : w_uni;
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      if (k < ns) {
        const float cand = dist[(s0 + k) * n_pad + src] + w;
        if (cand == target[k] && isfinite(cand) && src > wit[k]) wit[k] = src;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < SG; ++k)
    if (k < ns) rowwit[(long long)(s0 + k) * R_pad + r] = wit[k];
}

// Node witnesses: the largest row witness of each node; -1 for an unreached
// node and for each source's own node.  `parent` holds -1 beforehand.
template <int SG>
__global__ void __launch_bounds__(NTHREADS)
    parent_nodes(const int* __restrict__ rowwit, const int* __restrict__ l2, Buckets lb, int M,
                 int col_blocks, int S, int R_pad, const int* __restrict__ out_nodes,
                 long long n_pad, const int* __restrict__ sources, const float* __restrict__ dist,
                 int* __restrict__ parent) {
  const int g = blockIdx.x / col_blocks;
  const int j = (blockIdx.x % col_blocks) * NTHREADS + threadIdx.x;
  if (j >= M) return;
  const int v = out_nodes[j];
  if (v < 0) return;
  const int b = bucket_of(lb, j);
  const int cap = lb.cap[b], cols = lb.rows[b];
  const long long p = lb.off[b] + (j - lb.base[b]);
  const int s0 = g * SG;
  const int ns = S - s0 < SG ? S - s0 : SG;
  int wit[SG];
#pragma unroll
  for (int k = 0; k < SG; ++k) wit[k] = -1;
  for (int c = 0; c < cap; ++c) {
    const int rp = l2[p + (long long)c * cols];
    if (rp >= R_pad) continue;
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      if (k < ns) {
        const int x = rowwit[(long long)(s0 + k) * R_pad + rp];
        if (x > wit[k]) wit[k] = x;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < SG; ++k) {
    if (k < ns) {
      const long long at = (s0 + k) * n_pad + v;
      const bool keep = isfinite(dist[at]) && sources[s0 + k] != v;
      parent[at] = keep ? wit[k] : -1;
    }
  }
}

int fill(Buckets* b, const long long* desc, int n) {
  if (n < 1 || n > MAXB) return 1;
  b->n = n;
  for (int i = 0; i < n; ++i) {
    b->base[i] = (int)desc[4 * i];
    b->off[i] = desc[4 * i + 1];
    b->cap[i] = (int)desc[4 * i + 2];
    b->rows[i] = (int)desc[4 * i + 3];
  }
  return 0;
}

}  // namespace

extern "C" {

// Enqueues `steps` synchronous relaxation steps, numbered it0 .. it0 +
// steps - 1, on `stream`; returns 0 when every kernel was launched, else a
// cudaError_t.  Step t reads dist_a when t is even (dist_b when odd) and
// writes the other; it sets changed[t] to 1 if any distance fell (the
// caller zeroes `changed`).  row_desc [n_rb, 4] and l2_desc [n_lb, 4] are
// host int64 arrays: (first row or column, first slot, cap, rows) per
// bucket.  flat_w null means every slot weighs w_uni.  rowmin: [S, R_pad]
// f32 scratch.
int cozo_sssp_relax(const void* flat_src, const void* flat_w, float w_uni, const long long* row_desc,
                    int n_rb, int R_pad, const void* l2, const long long* l2_desc, int n_lb, int M,
                    const void* out_nodes, int S, int n_pad, void* dist_a, void* dist_b,
                    void* rowmin, void* changed, int it0, int steps, void* stream) {
  Buckets rb, lb;
  if (fill(&rb, row_desc, n_rb) || fill(&lb, l2_desc, n_lb) || S < 1 || R_pad < 1 || M < 1 ||
      it0 < 0 || steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int sg = S == 1 ? 1 : MAX_SG;
  const int groups = (S + sg - 1) / sg;
  const int row_blocks = (R_pad + NTHREADS - 1) / NTHREADS;
  const int col_blocks = (M + NTHREADS - 1) / NTHREADS;
  auto rows_kernel = sg == 1 ? relax_rows<1> : relax_rows<MAX_SG>;
  auto nodes_kernel = sg == 1 ? relax_nodes<1> : relax_nodes<MAX_SG>;
  for (int t = it0; t < it0 + steps; ++t) {
    const float* din = (const float*)(t % 2 == 0 ? dist_a : dist_b);
    float* dout = (float*)(t % 2 == 0 ? dist_b : dist_a);
    rows_kernel<<<groups * row_blocks, NTHREADS, 0, st>>>(
        (const int*)flat_src, (const float*)flat_w, w_uni, rb, R_pad, row_blocks, S, n_pad, din,
        (float*)rowmin);
    nodes_kernel<<<groups * col_blocks, NTHREADS, 0, st>>>(
        (const float*)rowmin, (const int*)l2, lb, M, col_blocks, S, R_pad,
        (const int*)out_nodes, n_pad, din, dout, (int*)changed + t);
  }
  return (int)cudaGetLastError();
}

// Enqueues the parent witnesses for the final distances `dist` [S, n_pad];
// `parent` [S, n_pad] i32 must hold -1; rowwit: [S, R_pad] i32 scratch;
// sources [S] i32.
int cozo_sssp_parent(const void* flat_src, const void* flat_w, float w_uni,
                     const long long* row_desc, int n_rb, int R_pad, const void* node_flat,
                     const void* l2, const long long* l2_desc, int n_lb, int M,
                     const void* out_nodes, int S, int n_pad, const void* sources,
                     const void* dist, void* rowwit, void* parent, void* stream) {
  Buckets rb, lb;
  if (fill(&rb, row_desc, n_rb) || fill(&lb, l2_desc, n_lb) || S < 1 || R_pad < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int sg = S == 1 ? 1 : MAX_SG;
  const int groups = (S + sg - 1) / sg;
  const int row_blocks = (R_pad + NTHREADS - 1) / NTHREADS;
  const int col_blocks = (M + NTHREADS - 1) / NTHREADS;
  auto rows_kernel = sg == 1 ? parent_rows<1> : parent_rows<MAX_SG>;
  auto nodes_kernel = sg == 1 ? parent_nodes<1> : parent_nodes<MAX_SG>;
  rows_kernel<<<groups * row_blocks, NTHREADS, 0, st>>>(
      (const int*)flat_src, (const float*)flat_w, w_uni, rb, R_pad, row_blocks, S, n_pad,
      (const int*)node_flat, (const float*)dist, (int*)rowwit);
  nodes_kernel<<<groups * col_blocks, NTHREADS, 0, st>>>(
      (const int*)rowwit, (const int*)l2, lb, M, col_blocks, S, R_pad, (const int*)out_nodes,
      n_pad, (const int*)sources, (const float*)dist, (int*)parent);
  return (int)cudaGetLastError();
}

const char* cozo_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
