// Batched single-source shortest paths for Hopper (sm_90a): synchronous
// (Jacobi) Bellman-Ford that relaxes only from the nodes whose distance
// fell at the step before, pushing over the out-edges while that frontier
// is small and pulling over a sliced-ELL layout of the in-edges when it is
// not, then the parent witnesses, for up to thousands of sources at once.
//
// Replaces the TPU function `_sssp_compiled_ell` (cozo_tpu/ops/
// graph_algos.py:633-686): a `while_loop` of relaxations, vmapped over the
// sources, that stops at `max_iters` or when a step changes nothing.  There
// one step gathers every padded slot's candidate into a [S, P] array, takes
// per-row minima over the bucket reshapes, then per-node minima over each
// node's rows.  Here no candidate array exists, and the host reads the
// "changed" flags only every few steps (the wrapper's choice), never each
// step.
//
// Why a frontier: under the Jacobi rule d_t[v] = min(d_{t-1}[v], min_u
// d_{t-1}[u] + w), the candidate of an in-neighbour u whose distance did
// not fall at step t - 1 was already offered at step t - 1, and d_{t-1}[v]
// is at most it.  So step t needs only the out-edges of the nodes that
// fell at step t - 1 (the frontier; at step 0 the sources): with unit
// weights each node falls once, and each edge does useful work once in a
// solve instead of once a step.  For S > 1 the frontier of a group of SG
// sources is the union of its sources' frontiers; each candidate is still
// taken per source.
//
// A step, per group of sources, on two distance buffers that agree when it
// begins (step t reads buffer t % 2 and lowers the other):
//   - the route: push when the frontier's out-edges are at most the
//     caller's share of all edges (`push_share`; the count and the
//     out-edge sum stay on the device, and every kernel of the other route
//     exits at once), else pull; a step is three launches: the push or
//     the pull's row minima (`relax_first`), the pull's node minima, the
//     compaction;
//   - push: a warp takes 32 frontier nodes and spreads all their
//     out-edges over its lanes by a prefix sum of their out-degrees (a
//     thread a light node and a warp a heavy one measured the same within
//     the spread between machines; this is one code path); the
//     candidate d_in[u] + w lowers d_out[v] through an atomic min on the
//     float's order-preserving integer image (signed min for non-negative
//     floats, unsigned max for negative ones: negative weights are exact
//     too), after a plain read that skips the candidates that cannot win;
//   - pull: a thread an ELL row keeps its minimum in registers (`relax_rows`,
//     coalesced, no atomics), then the node's rows meet at level 2
//     (`relax_nodes`), d_out = min(d_in, that);
//   - compaction: one pass over the nodes finds those whose d_out fell
//     below d_in, copies their new values into d_in (so the buffers agree
//     again: the synchronous rule, and a run cut at `max_iters` matches
//     JAX's), appends them to the next frontier (one atomic a flush of a
//     block's buffer), adds their out-degrees to its edge count and sets
//     changed[t].  (Marking the lowered nodes in a byte each so that
//     compaction reads only those cost the large push steps more than it
//     saved the small ones.)  changed[t] is 1 exactly when the next
//     frontier is not empty, as when a full step lowered some distance.
// A minimum is exact in any order, so push, pull and any mix of them give
// the plain version's bits; the frontier's order (atomics) never shows.
//
// The layout (`_stage_sssp_ell_meta`): the in-edges of a node are cut into
// rows of at most ELL_CAP_MAX = 1024 slots; rows of one power-of-two width
// `cap` form a bucket stored [cap, rows_p], rows on the minor axis, so the
// threads of a warp (neighbouring rows) read neighbouring addresses at
// every slot.  Padding slots name the dummy node n_pad - 1, whose distance
// stays +inf, so their candidate is +inf whatever their weight.  A node with
// more than 1024 in-edges has several rows; the level-2 layout [cap2, m_p]
// lists, per node, the positions of its rows (R_pad where there is none).
// The out-CSR is the caller's own graph: out_ptr [n_pad + 1] i64 (nodes
// past n have none), out_dst [e] i32, out_w [e] f32 or none.
//
// What bounds it: bytes.  A pull step reads every slot's source id (4 B,
// coalesced) and gathers the source's distance (a random 4-byte read that
// moves a 32-byte sector: ~3 GB of L2 traffic at 96M slots, ~0.7 ms on an
// NVIDIA H100); a push step reads only the frontier's out-edges (4 B a
// destination id, coalesced within a node) and touches one distance a
// candidate; compaction reads both buffers once (8 B a node and source).
// The least a solve can move is each real edge once while relaxing (4 e,
// plus 4 e of weights where they are not uniform) and 8 n of distances,
// then the parent pass's 4 e + 8 n; the gap to that is the pull steps'
// full passes, the push's atomics (a random read-modify-write in L2 for
// each candidate that passes: about 40 ps an edge against a pull's 7 ps a
// slot on an H100), the compaction passes, and each step's three launches.
//
// Semantics kept from the JAX function:
//   - synchronous steps, as above;
//   - f32 candidates `dist[src] + w` and exact minima: any order gives the
//     same bits, so the kernel and the plain version agree exactly;
//   - the parent of v is the largest source index among the in-edges whose
//     candidate equals the final distance and is finite; -1 for the sources
//     themselves and for nodes that are unreached or have no in-edge
//     (the parent pass is one pull over the ELL, as before).
// Both distance buffers start at +inf and step 0 puts each source's 0 in
// them; a node without in-edges is never lowered, so it keeps its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifndef COZO_SSSP_THREADS
#define COZO_SSSP_THREADS 256
#endif

constexpr int NTHREADS = COZO_SSSP_THREADS;
constexpr int WARPS = NTHREADS / 32;
// A thread carries SG sources: 8, or 1 for a single-source call (eight
// registers fewer a carried array, so twice the threads fit on an SM).
constexpr int MAX_SG = 8;
constexpr int MAXB = 32;    // bucket descriptors (caps 1..1024: 11 at most)
constexpr int COMPACT_BUF = 2048;  // fallen nodes a compaction block gathers before a flush
constexpr int CPT = 4;      // nodes a compaction thread reads at a time
constexpr unsigned FULL = 0xffffffffu;
#ifndef COZO_SSSP_MAX_BLOCKS
#define COZO_SSSP_MAX_BLOCKS 1056  // grid-stride kernels: 8 blocks an SM
#endif

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

// The route of step t for group g: push when the frontier's out-edges
// are at most push_max (-1: never).
__device__ __forceinline__ bool push_route(const unsigned long long* fedges, int t, int G, int g,
                                           long long push_max) {
  return (long long)fedges[(long long)t * G + g] <= push_max;
}

// dist = min(dist, v) through the float's order-preserving integer image.
__device__ __forceinline__ void atomic_min_f32(float* at, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin((int*)at, __float_as_int(v));
  else
    atomicMax((unsigned*)at, __float_as_uint(v));
}

// Step 0's distances and frontier: each source's own distance 0 in both
// buffers; each group's distinct sources and their out-degrees.
__global__ void __launch_bounds__(NTHREADS)
    seed_frontier(const int* __restrict__ sources, int S, int SG, long long n_pad,
                  const long long* __restrict__ out_ptr, float* __restrict__ dist_a,
                  float* __restrict__ dist_b, int* __restrict__ frontier,
                  int* __restrict__ fcount, unsigned long long* __restrict__ fedges) {
  const int s = blockIdx.x * NTHREADS + threadIdx.x;
  if (s >= S) return;
  const int g = s / SG, u = sources[s];
  dist_a[s * n_pad + u] = 0.0f;
  dist_b[s * n_pad + u] = 0.0f;
  for (int q = g * SG; q < s; ++q)
    if (sources[q] == u) return;  // an earlier source of the group
  const int pos = atomicAdd(fcount + g, 1);
  frontier[g * n_pad + pos] = u;
  atomicAdd(fedges + g, (unsigned long long)(out_ptr[u + 1] - out_ptr[u]));
}

// Push: the out-edges of step t's frontier lower dist_out.  A warp takes
// 32 frontier nodes at a time and shares out the edges of all of them, a
// lane an edge, by a prefix sum of their out-degrees across the warp (a
// binary search over it names each edge's node): a hub's edges and a leaf's
// keep every lane busy alike.
template <int SG>
__device__ __forceinline__ void relax_push(const long long* __restrict__ out_ptr,
                                           const int* __restrict__ out_dst,
                                           const float* __restrict__ out_w, float w_uni, int S,
                                           long long n_pad, const int* __restrict__ frontier,
                                           const int* __restrict__ fcount, int t, int G,
                                           const float* __restrict__ dist_in,
                                           float* __restrict__ dist_out) {
  __shared__ long long s_start[WARPS][32];  // each lane's node: its first out-edge,
  __shared__ int s_pre[WARPS][32];          // the edges of the lanes before it,
  __shared__ float s_du[WARPS][SG][32];     // its distances
  const int g = blockIdx.y;
  const int cnt = fcount[(long long)t * G + g];
  const int* F = frontier + ((long long)(t & 1) * G + g) * n_pad;
  const int s0 = g * SG;
  const int ns = S - s0 < SG ? S - s0 : SG;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int warp = blockIdx.x * WARPS + wi;
  for (int base = warp * 32; base < cnt; base += gridDim.x * NTHREADS) {  // warp-uniform
    const int i = base + lane;
    const int u = i < cnt ? F[i] : -1;
    const long long q0 = u >= 0 ? out_ptr[u] : 0;
    const int d = u >= 0 ? (int)(out_ptr[u + 1] - q0) : 0;
    int incl = d;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    s_start[wi][lane] = q0;
    s_pre[wi][lane] = incl - d;
#pragma unroll
    for (int k = 0; k < SG; ++k)
      s_du[wi][k][lane] = u >= 0 && k < ns ? dist_in[(s0 + k) * n_pad + u] : INFINITY;
    __syncwarp();
#pragma unroll 4
    for (int e = lane; e < total; e += 32) {
      int at = 0;  // the last lane whose edges start at or before e
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (s_pre[wi][at + step] <= e) at += step;
      const long long q = s_start[wi][at] + (e - s_pre[wi][at]);
      const int v = out_dst[q];
      const float w = out_w != nullptr ? out_w[q] : w_uni;
#pragma unroll
      for (int k = 0; k < SG; ++k) {
        if (k < ns) {
          const float cand = s_du[wi][k][at] + w;
          float* p = dist_out + (s0 + k) * n_pad + v;
          if (cand < *p) atomic_min_f32(p, cand);
        }
      }
    }
    __syncwarp();
  }
}

// Pull, row minima: rowmin[s, r] = min over r's slots of dist[s, src] + w.
template <int SG>
__device__ __forceinline__ void relax_rows(const int* __restrict__ flat_src,
                                           const float* __restrict__ flat_w, float w_uni,
                                           const Buckets& bk, int R_pad, int S, long long n_pad,
                                           const float* __restrict__ dist,
                                           float* __restrict__ rowmin) {
  const int g = blockIdx.y;
  const int s0 = g * SG;
  const int ns = S - s0 < SG ? S - s0 : SG;
  for (int r = blockIdx.x * NTHREADS + threadIdx.x; r < R_pad; r += gridDim.x * NTHREADS) {
    const int b = bucket_of(bk, r);
    const int cap = bk.cap[b], rows = bk.rows[b];
    const long long p = bk.off[b] + (r - bk.base[b]);
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
}

// A step's first kernel: the push, or the pull's row minima.
template <int SG>
__global__ void __launch_bounds__(NTHREADS)
    relax_first(const long long* __restrict__ out_ptr, const int* __restrict__ out_dst,
                const float* __restrict__ out_w, const int* __restrict__ frontier,
                const int* __restrict__ fcount, const int* __restrict__ flat_src,
                const float* __restrict__ flat_w, float w_uni, Buckets bk, int R_pad, int S,
                long long n_pad, const unsigned long long* __restrict__ fedges,
                long long push_max, int t, int G, const float* __restrict__ dist_in,
                float* __restrict__ dist_out, float* __restrict__ rowmin) {
  if (push_route(fedges, t, G, blockIdx.y, push_max))  // block-uniform
    relax_push<SG>(out_ptr, out_dst, out_w, w_uni, S, n_pad, frontier, fcount, t, G, dist_in,
                   dist_out);
  else
    relax_rows<SG>(flat_src, flat_w, w_uni, bk, R_pad, S, n_pad, dist_in, rowmin);
}

// Pull, node minima over each node's rows (level 2), then the synchronous
// update dist_out[s, v] = min(dist_in[s, v], that minimum).
template <int SG>
__global__ void __launch_bounds__(NTHREADS)
    relax_nodes(const float* __restrict__ rowmin, const int* __restrict__ l2, Buckets lb, int M,
                int S, int R_pad, const int* __restrict__ out_nodes, long long n_pad,
                const unsigned long long* __restrict__ fedges, long long push_max, int t, int G,
                const float* __restrict__ dist_in, float* __restrict__ dist_out) {
  const int g = blockIdx.y;
  if (push_route(fedges, t, G, g, push_max)) return;  // block-uniform
  const int s0 = g * SG;
  const int ns = S - s0 < SG ? S - s0 : SG;
  for (int j = blockIdx.x * NTHREADS + threadIdx.x; j < M; j += gridDim.x * NTHREADS) {
    const int v = out_nodes[j];
    if (v < 0) continue;
    const int b = bucket_of(lb, j);
    const int cap = lb.cap[b], cols = lb.rows[b];
    const long long p = lb.off[b] + (j - lb.base[b]);
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
#pragma unroll
    for (int k = 0; k < SG; ++k) {
      if (k < ns) {
        const long long at = (s0 + k) * n_pad + v;
        dist_out[at] = fminf(dist_in[at], m[k]);
      }
    }
  }
}

// After step t: the nodes whose distance fell (for any source of the
// group) get their new values copied into dist_in and form step t + 1's
// frontier (nodes past n_nodes have no in-edge and never fall).  A thread
// reads C nodes at a time (one source: 4) so that their loads overlap;
// the warps count theirs by ballots, and a block gathers them in shared
// memory and appends them with one atomic a flush (one counter serialises
// its atomics: one for every 256 nodes, or a shared-memory atomic a node,
// cost more than a small step's relaxation).
template <int SG>
__global__ void __launch_bounds__(NTHREADS)
    compact(int S, long long n_pad, long long n_nodes, const long long* __restrict__ out_ptr,
            int t, int G,
            int* __restrict__ frontier, int* __restrict__ fcount,
            unsigned long long* __restrict__ fedges, float* __restrict__ dist_in,
            const float* __restrict__ dist_out, int* __restrict__ changed) {
  constexpr int C = SG == 1 ? CPT : 1;
  constexpr int TILE = NTHREADS * C;
  __shared__ int buf[COMPACT_BUF];
  __shared__ int w_cnt[WARPS], w_off[WARPS];
  __shared__ unsigned long long w_deg[WARPS];
  __shared__ int t_cnt, b_n, b_pos;
  __shared__ unsigned long long t_deg, b_deg;
  const int g = blockIdx.y;
  const int s0 = g * SG;
  const int ns = S - s0 < SG ? S - s0 : SG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  int* next = frontier + ((long long)((t + 1) & 1) * G + g) * n_pad;
  const long long slot = (long long)(t + 1) * G + g;
  if (threadIdx.x == 0) {
    b_n = 0;
    b_deg = 0;
  }
  for (long long base = (long long)blockIdx.x * TILE;; base += (long long)gridDim.x * TILE) {
    const bool more = base < n_nodes;  // block-uniform
    float nw[C][SG], old[C][SG];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const long long v = base + i * NTHREADS + threadIdx.x;
#pragma unroll
      for (int k = 0; k < SG; ++k) {
        const bool in = more && v < n_nodes && k < ns;
        nw[i][k] = in ? dist_out[(s0 + k) * n_pad + v] : 0.0f;
        old[i][k] = in ? dist_in[(s0 + k) * n_pad + v] : 0.0f;
      }
    }
    unsigned fm[C];
    int rank[C], mine = 0;
    unsigned long long deg = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const long long v = base + i * NTHREADS + threadIdx.x;
      bool fell = false;
#pragma unroll
      for (int k = 0; k < SG; ++k) {
        if (nw[i][k] < old[i][k]) {
          dist_in[(s0 + k) * n_pad + v] = nw[i][k];
          fell = true;
        }
      }
      if (fell) deg += (unsigned long long)(out_ptr[v + 1] - out_ptr[v]);
      fm[i] = __ballot_sync(FULL, fell);
      rank[i] = fell ? mine + __popc(fm[i] & below) : -1;
      mine += __popc(fm[i]);  // the warp's count so far
    }
    for (int o = 16; o > 0; o >>= 1) deg += __shfl_xor_sync(FULL, deg, o);
    if (lane == 0) {
      w_cnt[warp] = mine;
      w_deg[warp] = deg;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      unsigned long long edges = 0;
      for (int i = 0; i < WARPS; ++i) {
        w_off[i] = total;
        total += w_cnt[i];
        edges += w_deg[i];
      }
      t_cnt = total;
      t_deg = edges;
    }
    __syncthreads();
    if (b_n > 0 && (b_n + t_cnt > COMPACT_BUF || !more)) {  // flush (block-uniform)
      if (threadIdx.x == 0) {
        b_pos = atomicAdd(fcount + slot, b_n);
        atomicAdd(fedges + slot, b_deg);
        changed[t] = 1;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < b_n; i += NTHREADS) next[b_pos + i] = buf[i];
      __syncthreads();
      if (threadIdx.x == 0) {
        b_n = 0;
        b_deg = 0;
      }
      __syncthreads();
    }
    if (!more) break;
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (rank[i] >= 0) buf[b_n + w_off[warp] + rank[i]] = (int)(base + i * NTHREADS + threadIdx.x);
    __syncthreads();
    if (threadIdx.x == 0) {
      b_n += t_cnt;
      b_deg += t_deg;
    }
  }
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
// lowers the other; after it both hold the same distances, and changed[t]
// is 1 if any distance fell (the caller fills both buffers with +inf, which
// step 0 seeds with each source's 0, and zeroes `changed`, `fcount` and
// `fedges`).  row_desc [n_rb, 4] and l2_desc [n_lb, 4] are host int64
// arrays: (first row or column, first slot, cap, rows) per bucket.  flat_w
// and out_w null mean every edge weighs w_uni.  The out-CSR out_ptr
// [n_pad + 1] i64, out_dst [n_edges] i32, out_w [n_edges] f32.  A group's
// step pushes when its frontier's out-edges are at most push_share *
// n_edges (a share below 0: always pull).  sources [S] i32 seed step 0's
// frontier when it0 is 0.  Scratch: rowmin [S, R_pad] f32, frontier [2, G,
// n_pad] i32, fcount [max steps + 1, G] i32, fedges [max steps + 1, G]
// u64, G = the groups of 8 sources (1 group when S is 1).  n_nodes: the
// graph's nodes (those past it have no edge).
int cozo_sssp_relax(const void* flat_src, const void* flat_w, float w_uni, const long long* row_desc,
                    int n_rb, int R_pad, const void* l2, const long long* l2_desc, int n_lb, int M,
                    const void* out_nodes, const void* out_ptr, const void* out_dst,
                    const void* out_w, long long n_edges, float push_share, const void* sources,
                    int S, int n_pad, int n_nodes, void* dist_a, void* dist_b, void* rowmin,
                    void* frontier,
                    void* fcount, void* fedges, void* changed, int it0, int steps,
                    void* stream) {
  Buckets rb, lb;
  if (fill(&rb, row_desc, n_rb) || fill(&lb, l2_desc, n_lb) || S < 1 || R_pad < 1 || M < 1 ||
      it0 < 0 || steps < 0 || n_edges < 0 || n_nodes < 0 || n_nodes > n_pad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int sg = S == 1 ? 1 : MAX_SG;
  const int G = (S + sg - 1) / sg;
  const long long push_max = push_share < 0.0f ? -1 : (long long)(push_share * (double)n_edges);
  auto grid = [G](long long items) {
    long long b = (items + NTHREADS - 1) / NTHREADS;
    return dim3((unsigned)(b < COZO_SSSP_MAX_BLOCKS ? (b < 1 ? 1 : b) : COZO_SSSP_MAX_BLOCKS),
                (unsigned)G);
  };
  const long long* optr = (const long long*)out_ptr;
  const unsigned long long* fe = (const unsigned long long*)fedges;
  if (it0 == 0)
    seed_frontier<<<(S + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(
        (const int*)sources, S, sg, n_pad, optr, (float*)dist_a, (float*)dist_b,
        (int*)frontier, (int*)fcount,
        (unsigned long long*)fedges);
  auto first_kernel = sg == 1 ? relax_first<1> : relax_first<MAX_SG>;
  auto nodes_kernel = sg == 1 ? relax_nodes<1> : relax_nodes<MAX_SG>;
  auto compact_kernel = sg == 1 ? compact<1> : compact<MAX_SG>;
  for (int t = it0; t < it0 + steps; ++t) {
    float* din = (float*)(t % 2 == 0 ? dist_a : dist_b);
    float* dout = (float*)(t % 2 == 0 ? dist_b : dist_a);
    first_kernel<<<grid(n_nodes > R_pad ? n_nodes : R_pad), NTHREADS, 0, st>>>(
        optr, (const int*)out_dst, (const float*)out_w, (const int*)frontier,
        (const int*)fcount, (const int*)flat_src, (const float*)flat_w, w_uni, rb, R_pad, S,
        n_pad, fe, push_max, t, G, din, dout, (float*)rowmin);
    nodes_kernel<<<grid(M), NTHREADS, 0, st>>>(
        (const float*)rowmin, (const int*)l2, lb, M, S, R_pad, (const int*)out_nodes, n_pad, fe,
        push_max, t, G, din, dout);
    compact_kernel<<<grid(sg == 1 ? (n_nodes + CPT - 1) / CPT : n_nodes), NTHREADS, 0, st>>>(
        S, n_pad, n_nodes, optr, t, G, (int*)frontier, (int*)fcount,
        (unsigned long long*)fedges, din, dout, (int*)changed);
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
