// PageRank for Hopper (sm_90a): `iterations` synchronous steps over
// destination-sorted edges, all enqueued back to back with no host sync.
//
// Replaces the TPU function `_pagerank_jax_compiled` (cozo_tpu/ops/
// graph_algos.py:70-118), a jitted `fori_loop` whose per-node incoming sum
// is a two-level prefix sum over the edges' contributions, diffed at the
// in-CSR bounds: scatter-adds serialise on the TPU, a prefix sum streams.
// A GPU sums each destination's segment directly, so here the prefix sum
// is gone and every step reads each edge once.
//
// What bounds it: bytes, and of those the gather.  A step reads every
// edge's source id (4 B, in order), gathers the contribution of that source
// (4 B at a random address), reads the in-CSR bounds and writes one rank
// and one contribution per node.  Operations are one add per edge.  The
// contributions of a graph of a few million nodes fit the 50 MB L2, but a
// random 4-byte read still moves a 32-byte sector: 2.2 GB of L2 traffic a
// step at 69M edges, about as long as the 0.65 ms a step takes on an
// NVIDIA H100 (16% of the device-memory bound).  The design keeps the
// gather the only random access:
//
//   - `contrib = rank / out_degree` is written by the step that makes the
//     rank (double-buffered), so the gather reads one array, not two;
//   - a group of GROUP = 4 lanes per destination walks its in-segment on
//     neighbouring edge slots (coalesced id reads, the loop unrolled by 4)
//     and adds by a shuffle butterfly, so a warp has eight nodes' chains
//     of dependent loads (the bounds, the ids, the contributions) in
//     flight at once.  The mean in-degree of the graphs the rules see is
//     14-64.  (The first version gave a node a whole warp: 0.92 ms a step
//     at 4.93M nodes / 69M edges, one node's latency chain at a time; 8
//     lanes a node and 4 both take 0.65 ms: the gather's sectors, above);
//   - the dangling mass (the rank of nodes without out-edges, spread over
//     all nodes) is summed without float atomics: each warp keeps its own
//     partial over the nodes it owns (a fixed set: the grid has a fixed
//     size and the warps stride over the nodes), each block adds its warps'
//     partials in warp order, and a one-block kernel adds the blocks'
//     partials in a fixed tree.  Two runs give the same bits;
//   - padding nodes (n_real <= v < n_pad) keep rank 0 and are never
//     visited, so the padding edges behind the dummy node are never read.
//
// A step computes, in f32 as the JAX function does,
//   new[v] = (1 - theta) / n + theta * (sum_{u -> v} rank[u] / deg[u]
//                                       + dangling / n)
// with the constant terms passed in already rounded to f32.  nvcc contracts
// the multiply-adds into FMAs, and the sums run in another order than the
// JAX prefix sum: the port holds the ranks to an L1 distance of 1e-5.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifndef COZO_PR_THREADS
#define COZO_PR_THREADS 256
#endif
#ifndef COZO_PR_MAX_BLOCKS
#define COZO_PR_MAX_BLOCKS 2048
#endif

constexpr int NTHREADS = COZO_PR_THREADS;
constexpr int WARPS = NTHREADS / 32;
constexpr int GROUP = 4;              // lanes per destination node
constexpr int PER_WARP = 32 / GROUP;  // nodes a warp sums at once
constexpr int MAX_BLOCKS = COZO_PR_MAX_BLOCKS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Adds each warp's `v` (held by its lane 0) in warp order; thread 0 writes
// the block's total to `out`.  Every thread of the block must call it.
__device__ __forceinline__ void block_total(float v, float* out) {
  __shared__ float part[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += part[w];
    *out = s;
  }
}

__device__ __forceinline__ float safe_deg(const float* out_deg, int v) {
  const float d = out_deg[v];
  return d > 0.0f ? d : 1.0f;
}

// rank = 1/n on real nodes, 0 on padding; contrib = rank / deg; the block's
// share of the dangling mass.  Threads stride over all n_pad nodes.
__global__ void __launch_bounds__(NTHREADS)
    pr_init(const float* __restrict__ out_deg, int n_real, int n_pad, float inv_n, int stride,
            float* __restrict__ ranks, float* __restrict__ contrib, float* __restrict__ partials) {
  float dang = 0.0f;
  for (int v = blockIdx.x * NTHREADS + threadIdx.x; v < n_pad; v += stride) {
    const float r = v < n_real ? inv_n : 0.0f;
    ranks[v] = r;
    contrib[v] = r / safe_deg(out_deg, v);
    if (v < n_real && out_deg[v] == 0.0f) dang += r;
  }
  // a fixed order: lane order inside the warp, then warp order
  dang = warp_sum(dang);
  block_total(dang, partials + blockIdx.x);
}

// One block adds the blocks' partials in a fixed tree: *dangling.
__global__ void __launch_bounds__(NTHREADS)
    pr_reduce(const float* __restrict__ partials, int n_parts, float* __restrict__ dangling) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < n_parts; i += NTHREADS) s += partials[i];
  s = warp_sum(s);
  block_total(s, dangling);
}

// One step: a group of GROUP lanes per real node, warps striding over the
// nodes PER_WARP at a time (a warp-uniform loop: every lane reaches every
// shuffle).
__global__ void __launch_bounds__(NTHREADS)
    pr_step(const int* __restrict__ src_by_dst, const int* __restrict__ in_ptr,
            const float* __restrict__ out_deg, int n_real, float inv_n, float c0, float theta,
            int warp_stride, const float* __restrict__ contrib_in, const float* __restrict__ dangling,
            float* __restrict__ ranks, float* __restrict__ contrib_out,
            float* __restrict__ partials) {
  const int lane = threadIdx.x & 31, sub = lane % GROUP;
  const float dn = *dangling * inv_n;
  float dang = 0.0f;  // a group leader's share of the next dangling mass
  for (long long base = (long long)(blockIdx.x * WARPS + (threadIdx.x >> 5)) * PER_WARP;
       base < n_real; base += (long long)warp_stride * PER_WARP) {
    const long long v = base + lane / GROUP;
    float s = 0.0f;
    if (v < n_real) {
      const int beg = in_ptr[v], end = in_ptr[v + 1];
#pragma unroll 4
      for (int j = beg + sub; j < end; j += GROUP) s += contrib_in[src_by_dst[j]];
    }
    for (int o = GROUP / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (v < n_real && sub == 0) {
      const float r = c0 + theta * (s + dn);
      ranks[v] = r;
      const float d = out_deg[v];
      contrib_out[v] = r / (d > 0.0f ? d : 1.0f);
      if (d == 0.0f) dang += r;
    }
  }
  // the group leaders' shares, added in a fixed tree, then warp order
  dang = warp_sum(dang);
  block_total(dang, partials + blockIdx.x);
}

int blocks_for(long long work, int per_block) {
  long long b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// Enqueues `iterations` PageRank steps on `stream`; returns 0 when every
// kernel was launched, else a cudaError_t.  Inputs: src_by_dst [e_pad] i32
// (sources grouped by destination), in_ptr [n_pad + 1] i32, out_deg
// [n_pad] f32.  Writes ranks [n_pad] f32.  Scratch from the caller:
// contrib_a, contrib_b [n_pad] f32, partials [COZO_PR_MAX_BLOCKS] f32,
// dangling [1] f32.  inv_n = 1/n, c0 = (1 - theta)/n and theta, each
// rounded to f32 by the caller.
int cozo_pagerank(const void* src_by_dst, const void* in_ptr, const void* out_deg, int n_real,
                  int n_pad, int iterations, float inv_n, float c0, float theta, void* ranks,
                  void* contrib_a, void* contrib_b, void* partials, void* dangling, void* stream) {
  if (n_real < 1 || n_pad <= n_real || iterations < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* r = (float*)ranks;
  float* ca = (float*)contrib_a;
  float* cb = (float*)contrib_b;
  float* parts = (float*)partials;
  float* dang = (float*)dangling;
  const float* deg = (const float*)out_deg;
  const int init_blocks = blocks_for(n_pad, NTHREADS);
  pr_init<<<init_blocks, NTHREADS, 0, st>>>(deg, n_real, n_pad, inv_n, init_blocks * NTHREADS, r,
                                            ca, parts);
  pr_reduce<<<1, NTHREADS, 0, st>>>(parts, init_blocks, dang);
  const int step_blocks = blocks_for(n_real, WARPS * PER_WARP);
  for (int it = 0; it < iterations; ++it) {
    const float* cin = it % 2 == 0 ? ca : cb;
    float* cout = it % 2 == 0 ? cb : ca;
    pr_step<<<step_blocks, NTHREADS, 0, st>>>(
        (const int*)src_by_dst, (const int*)in_ptr, deg, n_real, inv_n, c0, theta,
        step_blocks * WARPS, cin, dang, r, cout, parts);
    pr_reduce<<<1, NTHREADS, 0, st>>>(parts, step_blocks, dang);
  }
  return (int)cudaGetLastError();
}

// The size of the `partials` scratch the caller allocates.
int cozo_pagerank_max_blocks() { return MAX_BLOCKS; }

const char* cozo_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
