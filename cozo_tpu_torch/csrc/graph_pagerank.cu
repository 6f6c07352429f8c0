// PageRank for Hopper (sm_90a): `iterations` synchronous steps over edges
// binned by destination and sorted by source, all enqueued back to back
// with no host sync.
//
// Replaces the TPU function `_pagerank_jax_compiled` (cozo_tpu/ops/
// graph_algos.py:70-118), a jitted `fori_loop` whose per-node incoming sum
// is a two-level prefix sum over the edges' contributions, diffed at the
// in-CSR bounds: scatter-adds serialise on the TPU, a prefix sum streams.
//
// What bounds it: the gather's L2 sectors and the edge stream.  A step
// reads every edge once and gathers the contribution of its source (4 B at
// a data-dependent address).  The contributions of a graph of a few
// million nodes fit the 50 MB L2, but each gathered 4-byte value moves a
// 32-byte sector.  The first version walked each destination's in-segment
// (sources in random order): a sector an edge, 2.2 GB of L2 traffic a step
// at 69M edges, 0.65 ms a step on an NVIDIA H100 at 700 W, 0.20 ms of it
// with the gather made sequential.  This version moves fewer sectors:
//
//   - real destinations are cut into bins of BIN_NODES consecutive nodes,
//     whose sums sit in shared memory while the bin's edges stream by: 8
//     bytes a node, 112 KB of the SM's 228 KB, the rest left to L1, where
//     the gathers of neighbouring warps meet (bins of 28,672 nodes, which
//     fill shared memory, ran 40% slower at 69M edges: 28 KB of L1);
//   - inside a bin the edges are sorted by source id, each carrying its
//     source (i32) and its destination's offset in the bin (u16): 6 bytes
//     an edge, padding edges not stored (built once per graph on the
//     device, `ops/graph_algos._pagerank_bins`).  So the 32 lanes of a
//     warp gather 32 neighbouring sources and share sectors, and the warps
//     of a block walk neighbouring stretches of ids (most of all for
//     Pareto sources, as in the LiveJournal-shaped graph);
//   - the edge pass is persistent, one block of BIN_THREADS on each SM
//     (as many as fit, for a build with smaller bins); each block takes an
//     equal slice of the binned edges, in order, UNROLL edges a thread in
//     flight, the ids read with a streaming hint (`__ldcs`: read once,
//     they should not evict the contributions);
//   - each contribution is added into its destination's slot as a 64-bit
//     fixed-point integer, round(c * 2^62), held as two 32-bit words:
//     shared-memory atomics are native at 32 bits, a 64-bit add compiles
//     to a compare-and-swap loop (0.8 ms more over 10 steps at 69M edges),
//     and the carry out of the low word shows in the value it held.  Ranks and
//     incoming sums lie in [0, 1] for theta in [0, 1]; the words add as
//     two's complement, so a negative rank from a theta above 1 adds
//     exactly too while a sum stays below 2 in magnitude.  At each bin
//     boundary and at the end of its slice the block adds its slots into
//     a global [n_pad] array with 64-bit integer atomics.  Integer adds are
//     exact in any order: two runs, two bin sizes and two slicings give
//     the same bits, with no float atomic anywhere;
//   - a node pass, four nodes a thread with 16-byte loads and stores,
//     turns each exact sum into its correctly rounded f32 (then times
//     2^-62, exact), makes the rank and `contrib = rank / out_degree`
//     (double-buffered, so the gather reads one array; the ranks are
//     written out by the last step only), zeroes the sum for the next
//     step and keeps its block's share of the dangling mass (the rank of
//     nodes without out-edges, spread over all nodes): each warp sums the
//     nodes it owns (a fixed set: the grid has a fixed size), each block
//     adds its warps in warp order and a one-block kernel adds the blocks'
//     partials in a fixed tree;
//   - padding nodes (n_real <= v < n_pad) keep rank 0 and no edge reads
//     them.
//
// A step computes, in f32 as the JAX function does,
//   new[v] = (1 - theta) / n + theta * (sum_{u -> v} rank[u] / deg[u]
//                                       + dangling / n)
// with the constant terms passed in already rounded to f32.  The incoming
// sum is the f32 rounding of the exact sum of the f32 contributions (each
// below 2^-39 rounds to a multiple of 2^-62 first), where the JAX prefix
// sum rounds to its running total's ulp: the port holds the ranks to an L1
// distance of 1e-5.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifndef COZO_PR_THREADS
#define COZO_PR_THREADS 256
#endif
#ifndef COZO_PR_BIN_THREADS
#define COZO_PR_BIN_THREADS 1024
#endif
#ifndef COZO_PR_MAX_BLOCKS
#define COZO_PR_MAX_BLOCKS 2048
#endif
// destinations a bin holds: 14,336 x 8 bytes = 112 KB of shared memory
// (below 32,768: the offsets are 15-bit in the layout's sort key)
#ifndef COZO_PR_BIN_NODES
#define COZO_PR_BIN_NODES 14336
#endif

constexpr int NTHREADS = COZO_PR_THREADS;
constexpr int WARPS = NTHREADS / 32;
constexpr int BIN_THREADS = COZO_PR_BIN_THREADS;
constexpr int BIN_NODES = COZO_PR_BIN_NODES;
constexpr int UNROLL = 8;  // edges a thread has in flight
constexpr int MAX_BLOCKS = COZO_PR_MAX_BLOCKS;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float FIX_ONE = 0x1p62f;   // the fixed-point scale
constexpr float FIX_UNIT = 0x1p-62f;

static_assert(BIN_NODES > 0 && BIN_NODES < 32768, "offsets are 15-bit");

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

// rank = 1/n on real nodes, 0 on padding; on real nodes contrib = rank /
// deg and the sums zeroed (no edge reads a padding node's contribution);
// the block's share of the dangling mass.  Threads stride over all n_pad
// nodes.
__global__ void __launch_bounds__(NTHREADS)
    pr_init(const float* __restrict__ out_deg, int n_real, int n_pad, float inv_n, int stride,
            float* __restrict__ ranks, float* __restrict__ contrib,
            unsigned long long* __restrict__ sums, float* __restrict__ partials) {
  float dang = 0.0f;
  for (int v = blockIdx.x * NTHREADS + threadIdx.x; v < n_pad; v += stride) {
    ranks[v] = v < n_real ? inv_n : 0.0f;
    if (v >= n_real) continue;
    contrib[v] = inv_n / safe_deg(out_deg, v);
    sums[v] = 0;
    if (out_deg[v] == 0.0f) dang += inv_n;
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

// Adds a 64-bit two's-complement fixed-point value to a bin slot kept as
// two 32-bit words: shared-memory atomics are native at 32 bits (a 64-bit
// add compiles to a compare-and-swap loop), and the carry out of the low
// word shows in the value it held.  The pair ends as the exact 64-bit sum
// whatever the order of the adds.
__device__ __forceinline__ void slot_add(unsigned* lo, unsigned* hi, unsigned long long v) {
  const unsigned vl = (unsigned)v;
  const unsigned old = atomicAdd(lo, vl);
  const unsigned vh = (unsigned)(v >> 32) + (old + vl < old ? 1u : 0u);
  if (vh != 0) atomicAdd(hi, vh);
}

// The sources and offsets of edges j0 + u * BIN_THREADS (u < UNROLL) below
// `end`, read once with a streaming hint; -1 past it.
__device__ __forceinline__ void load_edges(const int* __restrict__ bin_src,
                                           const unsigned short* __restrict__ bin_off, int j0,
                                           int end, int (&src)[UNROLL], unsigned (&off)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = j0 + u * BIN_THREADS;
    src[u] = j < end ? __ldcs(bin_src + j) : -1;
    off[u] = j < end ? __ldcs(bin_off + j) : 0u;
  }
}

// The edge pass of a step: block b takes binned edges [e*b/G, e*(b+1)/G)
// and adds each edge's contribution, in fixed point, into its bin's slots
// in shared memory, flushed into `sums` at every bin boundary.
__global__ void __launch_bounds__(BIN_THREADS, 1)
    pr_bins(const int* __restrict__ bin_src, const unsigned short* __restrict__ bin_off,
            const int* __restrict__ bin_ptr, int n_bins, int n_edges, int n_real,
            const float* __restrict__ contrib_in, unsigned long long* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* lo = reinterpret_cast<unsigned*>(smem_raw);  // a slot's low words
  unsigned* hi = lo + BIN_NODES;                         // and its high words
  __shared__ int first_bin;
  constexpr int TILE = BIN_THREADS * UNROLL;
  const int slice_beg = (int)((long long)n_edges * blockIdx.x / gridDim.x);
  const int slice_end = (int)((long long)n_edges * (blockIdx.x + 1) / gridDim.x);
  if (slice_beg >= slice_end) return;  // the whole block alike
  if (threadIdx.x == 0) {
    // the last bin whose first edge is at or before the slice's
    int a = 0, b = n_bins - 1;
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (bin_ptr[mid] <= slice_beg) a = mid;
      else b = mid - 1;
    }
    first_bin = a;
  }
  __syncthreads();
  int bin = first_bin;
  for (int beg = slice_beg; beg < slice_end;) {
    while (bin_ptr[bin + 1] <= beg) ++bin;  // bins without edges
    const int end = min(slice_end, bin_ptr[bin + 1]);
    const int base = bin * BIN_NODES;
    const int width = min(BIN_NODES, n_real - base);
    for (int i = threadIdx.x; i < width; i += BIN_THREADS) lo[i] = hi[i] = 0;
    __syncthreads();
    for (int j0 = beg + threadIdx.x; j0 < end; j0 += TILE) {
      int src[UNROLL];
      unsigned off[UNROLL];
      load_edges(bin_src, bin_off, j0, end, src, off);
      float c[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) c[u] = src[u] >= 0 ? contrib_in[src[u]] : 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (src[u] >= 0)
          slot_add(lo + off[u], hi + off[u], (unsigned long long)__float2ll_rn(c[u] * FIX_ONE));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < width; i += BIN_THREADS) {
      const unsigned long long a = ((unsigned long long)hi[i] << 32) | lo[i];
      if (a != 0) atomicAdd(sums + base + i, a);
    }
    __syncthreads();  // the flush reads the slots before the next bin zeroes them
    beg = end;
  }
}

// The node pass of a step, four consecutive nodes a thread (16-byte loads
// and stores): each real node's exact sum as its correctly rounded f32,
// the new rank (written out only by the last step: `ranks` is null before)
// and contribution, the sum zeroed, and the block's share of the next
// dangling mass.
__global__ void __launch_bounds__(NTHREADS)
    pr_finish(unsigned long long* __restrict__ sums, const float* __restrict__ out_deg, int n_real,
              float inv_n, float c0, float theta, int stride, const float* __restrict__ dangling,
              float* __restrict__ ranks, float* __restrict__ contrib_out,
              float* __restrict__ partials) {
  const float dn = *dangling * inv_n;
  float dang = 0.0f;
  const int groups = (n_real + 3) / 4;
  for (int g = blockIdx.x * NTHREADS + threadIdx.x; g < groups; g += stride) {
    const int v0 = 4 * g;
    const bool whole = v0 + 4 <= n_real;
    unsigned long long s[4];
    float d[4];
    if (whole) {
      const ulonglong2 a = reinterpret_cast<const ulonglong2*>(sums)[2 * g];
      const ulonglong2 b = reinterpret_cast<const ulonglong2*>(sums)[2 * g + 1];
      const float4 dd = reinterpret_cast<const float4*>(out_deg)[g];
      s[0] = a.x, s[1] = a.y, s[2] = b.x, s[3] = b.y;
      d[0] = dd.x, d[1] = dd.y, d[2] = dd.z, d[3] = dd.w;
    } else {
      for (int k = 0; k < 4; ++k) {
        s[k] = v0 + k < n_real ? sums[v0 + k] : 0ull;
        d[k] = v0 + k < n_real ? out_deg[v0 + k] : 1.0f;
      }
    }
    float r[4], c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[k] = c0 + theta * (__ll2float_rn((long long)s[k]) * FIX_UNIT + dn);
      c[k] = r[k] / (d[k] > 0.0f ? d[k] : 1.0f);
      if (d[k] == 0.0f && v0 + k < n_real) dang += r[k];
    }
    if (whole) {
      reinterpret_cast<ulonglong2*>(sums)[2 * g] = ulonglong2{0ull, 0ull};
      reinterpret_cast<ulonglong2*>(sums)[2 * g + 1] = ulonglong2{0ull, 0ull};
      if (ranks != nullptr) reinterpret_cast<float4*>(ranks)[g] = make_float4(r[0], r[1], r[2], r[3]);
      reinterpret_cast<float4*>(contrib_out)[g] = make_float4(c[0], c[1], c[2], c[3]);
    } else {
      for (int k = 0; k < 4 && v0 + k < n_real; ++k) {
        sums[v0 + k] = 0;
        if (ranks != nullptr) ranks[v0 + k] = r[k];
        contrib_out[v0 + k] = c[k];
      }
    }
  }
  dang = warp_sum(dang);
  block_total(dang, partials + blockIdx.x);
}

int blocks_for(long long work, int per_block) {
  long long b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

constexpr int BIN_SMEM = BIN_NODES * (int)sizeof(unsigned long long);

// The edge pass's grid: as many blocks as the SMs hold at once (one an SM
// at these bins and registers; at most MAX_BLOCKS, and no more than the
// edges fill); sets the kernel's shared-memory limit once per device.
// Returns 0 or a cudaError_t.
int bin_grid(int n_edges, int* grid) {
  static int per_device[MAX_DEVICES];  // blocks the card holds, once known
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidValue;
  if (!per_device[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pr_bins, cudaFuncAttributeMaxDynamicSharedMemorySize, BIN_SMEM);
    // no more of the SM's 228 KB as shared memory than the slots take: the
    // rest is L1, where neighbouring warps' gathers meet
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pr_bins, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (100 * (BIN_SMEM + 2048) + 233471) / 233472);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pr_bins, BIN_THREADS, BIN_SMEM);
    if (err != cudaSuccess) return (int)err;
    per_device[dev] = sms * (per_sm > 1 ? per_sm : 1);
  }
  int g = per_device[dev] < MAX_BLOCKS ? per_device[dev] : MAX_BLOCKS;
  const int fill = (n_edges + BIN_THREADS - 1) / BIN_THREADS;
  if (g > fill) g = fill;
  *grid = g < 1 ? 1 : g;
  return 0;
}

}  // namespace

extern "C" {

// Enqueues `iterations` PageRank steps on `stream`; returns 0 when every
// kernel was launched, else a cudaError_t.  Inputs: the binned layout
// (bin_src [n_edges] i32 sources and bin_off [n_edges] u16 offsets, each
// bin's edges by ascending source; bin_ptr [n_bins + 1] i32, bin b's edges
// from bin_ptr[b]; n_bins = ceil(n_real / BIN_NODES), the bins of this
// build's size) and out_deg [n_pad] f32.  Writes ranks [n_pad] f32.
// Scratch from the caller: contrib_a, contrib_b [n_pad] f32, sums [n_pad]
// u64, partials [COZO_PR_MAX_BLOCKS] f32, dangling [1] f32.  inv_n = 1/n,
// c0 = (1 - theta)/n and theta, each rounded to f32 by the caller.
int cozo_pagerank(const void* bin_src, const void* bin_off, const void* bin_ptr, int n_bins,
                  int n_edges, const void* out_deg, int n_real, int n_pad, int iterations,
                  float inv_n, float c0, float theta, void* ranks, void* contrib_a,
                  void* contrib_b, void* sums, void* partials, void* dangling, void* stream) {
  if (n_real < 1 || n_pad <= n_real || iterations < 0 || n_edges < 0 ||
      n_bins != (n_real + BIN_NODES - 1) / BIN_NODES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* r = (float*)ranks;
  float* ca = (float*)contrib_a;
  float* cb = (float*)contrib_b;
  unsigned long long* acc = (unsigned long long*)sums;
  float* parts = (float*)partials;
  float* dang = (float*)dangling;
  const float* deg = (const float*)out_deg;
  int bin_blocks = 1;
  if (n_edges > 0) {
    const int err = bin_grid(n_edges, &bin_blocks);
    if (err != 0) return err;
  }
  const int init_blocks = blocks_for(n_pad, NTHREADS);
  pr_init<<<init_blocks, NTHREADS, 0, st>>>(deg, n_real, n_pad, inv_n, init_blocks * NTHREADS, r,
                                            ca, acc, parts);
  pr_reduce<<<1, NTHREADS, 0, st>>>(parts, init_blocks, dang);
  const int node_blocks = blocks_for((n_real + 3) / 4, NTHREADS);
  for (int it = 0; it < iterations; ++it) {
    const float* cin = it % 2 == 0 ? ca : cb;
    float* cout = it % 2 == 0 ? cb : ca;
    if (n_edges > 0)
      pr_bins<<<bin_blocks, BIN_THREADS, BIN_SMEM, st>>>(
          (const int*)bin_src, (const unsigned short*)bin_off, (const int*)bin_ptr, n_bins,
          n_edges, n_real, cin, acc);
    pr_finish<<<node_blocks, NTHREADS, 0, st>>>(acc, deg, n_real, inv_n, c0, theta,
                                                 node_blocks * NTHREADS, dang,
                                                 it + 1 == iterations ? r : nullptr, cout, parts);
    pr_reduce<<<1, NTHREADS, 0, st>>>(parts, node_blocks, dang);
  }
  return (int)cudaGetLastError();
}

// The size of the `partials` scratch the caller allocates.
int cozo_pagerank_max_blocks() { return MAX_BLOCKS; }

// The destinations a bin holds in this build: the layout's bin size.
int cozo_pagerank_bin_nodes() { return BIN_NODES; }

const char* cozo_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
