// Batched HNSW search for Hopper (sm_90a): greedy descent through the upper
// levels, then a fixed-width level-0 beam, the whole search in ONE launch.
//
// Replaces the TPU function `_compiled_search` (cozo_tpu/ops/vector_search.py:
// 81-205), a jitted pair of `lax.while_loop`s over the whole batch.  Those
// loops run until NO query has work, but a finished query's round changes
// nothing (descent: `better` is false; beam: nothing is selected, every
// candidate is invalid and the stable top-`beam` returns the beam as it
// was), so here each query stops by itself.
//
// One thread block per query.  The query, the beam (id, distance, expanded
// flag; double-buffered) and one round's expand * m0 candidates live in
// shared memory.  Per round: warp 0 picks the `expand` first unexpanded
// entries (the beam is always sorted, so these are the nearest), all threads
// gather their neighbour lists, drop ids that are -1, already in the beam or
// seen earlier in the same expansion, one warp per surviving row reads its d
// floats coalesced and reduces with shuffles (8 rows in flight per warp),
// and a bitonic sort of (distance, position) keys over beam + candidates
// gives the new beam with `lax.top_k`'s tie rule: equal distances keep the
// lower position.
//
// What bounds it: at the batch sizes it serves (B < 64, fewer blocks than
// SMs) the chain of dependent rounds, each at least one device-memory round
// trip for the neighbour lists and one for the rows, not the bytes.  What
// holds this simple version back beyond that: a round is a series of short
// phases with a block barrier between them, and the two longest are the
// distances (the survivors go through in batches of 64 rows, each batch a
// memory round trip) and the full bitonic sort of T keys where only the
// first `beam` are needed; then the O(C * (beam + C)) dedup compares.  The
// per-query counters it writes (descent steps, beam rounds, rows read,
// neighbour lists read) give the bound of a run from its own data.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS_IN_FLIGHT = 8;  // rows whose loads one warp keeps in flight
constexpr int LOADS_AHEAD = 4;     // loads per row and lane issued before their use
constexpr unsigned FULL = 0xffffffffu;

// Order-preserving map of a float onto unsigned (-0 counts as +0, as a
// comparison of the floats would).
__device__ __forceinline__ uint32_t ordered(float d) {
  if (d == 0.0f) d = 0.0f;
  const uint32_t u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t make_key(float d, int pos) {
  return ((uint64_t)ordered(d) << 32) | (uint32_t)pos;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The three distances as `dist()` of the JAX function: L2 as
// qn + cn - 2 dot with qn = |q|^2; IP as 1 - dot; Cosine with qn = |q| and
// the qn * cn > 0 guard.
__device__ __forceinline__ float finish_dist(float dot, float cn, float qn, int kind) {
  if (kind == 0) return qn + cn - 2.0f * dot;
  if (kind == 1) return 1.0f - dot;
  const float den = qn * sqrtf(cn);
  return 1.0f - dot / (den > 0.0f ? den : 1.0f);
}

// Distances of the rows c_id[c_list[0..nv)] to the query, written to
// c_d[c_list[j]]: one warp per row, ROWS_IN_FLIGHT rows at a time.
__device__ __forceinline__ void list_dists(const float* __restrict__ vectors, const float* q, int d,
                                           float qn, int kind, const int* c_id, const int* c_list,
                                           float* c_d, int nv, int warp, int lane) {
  for (int j0 = warp * ROWS_IN_FLIGHT; j0 < nv; j0 += NWARPS * ROWS_IN_FLIGHT) {
    const float* row[ROWS_IN_FLIGHT];
    int pos[ROWS_IN_FLIGHT];
    float dot[ROWS_IN_FLIGHT], cn[ROWS_IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      const int j = (j0 + u < nv) ? j0 + u : nv - 1;  // the tail repeats a row
      pos[u] = c_list[j];
      row[u] = vectors + (size_t)c_id[pos[u]] * (size_t)d;
      dot[u] = 0.0f;
      cn[u] = 0.0f;
    }
    // all loads of a 32 * LOADS_AHEAD-wide slice are issued before the first
    // fma needs one, so a slice costs one memory round trip, not LOADS_AHEAD
    for (int i0 = lane; i0 < d; i0 += 32 * LOADS_AHEAD) {
      float c[ROWS_IN_FLIGHT][LOADS_AHEAD];
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
#pragma unroll
        for (int j = 0; j < LOADS_AHEAD; ++j) {
          const int i = i0 + 32 * j;
          c[u][j] = i < d ? row[u][i] : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < LOADS_AHEAD; ++j) {
        const int i = i0 + 32 * j;
        const float qi = i < d ? q[i] : 0.0f;
#pragma unroll
        for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
          dot[u] = fmaf(c[u][j], qi, dot[u]);
          cn[u] = fmaf(c[u][j], c[u][j], cn[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      const float dist = finish_dist(warp_sum(dot[u]), warp_sum(cn[u]), qn, kind);
      if (lane == 0 && j0 + u < nv) c_d[pos[u]] = dist;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
beam_search_kernel(const float* __restrict__ vectors, const int* __restrict__ nb0,
                   const int* __restrict__ up_nb, const uint8_t* __restrict__ alive,
                   const float* __restrict__ qs, int* __restrict__ out_ids,
                   float* __restrict__ out_d, int* __restrict__ stats, int n_pad, int d, int m0,
                   int m_up, int n_levels, int entry, int k, int beam, int expand, int max_iters,
                   int kind, int T, int C, int ccap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem_raw);  // [T]
  float* q = reinterpret_cast<float*>(keys + T);           // [d]
  int* beam_id = reinterpret_cast<int*>(q + d);            // [2][beam]
  float* beam_d = reinterpret_cast<float*>(beam_id + 2 * beam);
  int* beam_ex = reinterpret_cast<int*>(beam_d + 2 * beam);
  int* c_id = beam_ex + 2 * beam;                          // [ccap] candidate ids
  float* c_d = reinterpret_cast<float*>(c_id + ccap);      // [ccap] their distances
  int* c_list = reinterpret_cast<int*>(c_d + ccap);        // [ccap] positions to score
  int* sel = c_list + ccap;                                // [expand]

  __shared__ int s_nv, s_nsel, s_work, s_cur, s_moved;
  __shared__ float s_qn, s_curd;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int query = blockIdx.x;
  int n_steps = 0, n_rounds = 0, n_rows = 0, n_lists = 0;  // thread 0's are written

  for (int i = tid; i < d; i += NTHREADS) q[i] = qs[(size_t)query * d + i];
  if (tid == 0) {
    s_nv = 0;
    s_cur = entry;
  }
  __syncthreads();
  if (warp == 0) {
    float s = 0.0f;
    for (int i = lane; i < d; i += 32) s = fmaf(q[i], q[i], s);
    s = warp_sum(s);
    if (lane == 0) s_qn = (kind == 2) ? sqrtf(s) : s;
  }
  __syncthreads();
  const float qn = s_qn;

  // ---- greedy descent through the upper levels; then the entry's distance
  for (int lvl = n_levels - 1; lvl >= -1; --lvl) {
    if (warp == 0) {  // distance of the current node
      if (lane == 0) {
        c_id[0] = s_cur;
        c_list[0] = 0;
      }
      __syncwarp();
      list_dists(vectors, q, d, qn, kind, c_id, c_list, c_d, 1, 0, lane);
      __syncwarp();
      if (lane == 0) s_curd = c_d[0];
    }
    ++n_rows;
    __syncthreads();
    if (lvl < 0) break;
    while (true) {
      const int cur = s_cur;
      const int* nbr = up_nb + ((size_t)lvl * n_pad + cur) * (size_t)m_up;
      for (int p = tid; p < m_up; p += NTHREADS) {
        const int id = nbr[p];
        c_id[p] = id;
        c_d[p] = INFINITY;
        if (id >= 0) c_list[atomicAdd(&s_nv, 1)] = p;
      }
      __syncthreads();
      const int nv = s_nv;
      list_dists(vectors, q, d, qn, kind, c_id, c_list, c_d, nv, warp, lane);
      n_rows += nv;
      ++n_lists;
      ++n_steps;
      __syncthreads();
      if (warp == 0) {  // first minimum, as jnp.argmin
        uint64_t best = ~0ull;
        for (int p = lane; p < m_up; p += 32) {
          const uint64_t key = make_key(c_d[p], p);
          best = key < best ? key : best;
        }
        for (int o = 16; o > 0; o >>= 1) {
          const uint64_t other = __shfl_xor_sync(FULL, best, o);
          best = other < best ? other : best;
        }
        if (lane == 0) {
          const int p = (int)(uint32_t)best;
          const float bestd = c_d[p];
          const int better = bestd < s_curd;
          if (better) {
            s_cur = c_id[p];
            s_curd = bestd;
          }
          s_moved = better;
          s_nv = 0;
        }
      }
      __syncthreads();
      if (!s_moved) break;
    }
  }

  // ---- level-0 beam
  int* b_id = beam_id;
  float* b_d = beam_d;
  int* b_ex = beam_ex;
  int* nb_id = beam_id + beam;
  float* nb_d = beam_d + beam;
  int* nb_ex = beam_ex + beam;
  for (int i = tid; i < beam; i += NTHREADS) {
    b_id[i] = i == 0 ? s_cur : -1;
    b_d[i] = i == 0 ? s_curd : INFINITY;
    b_ex[i] = i != 0;
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // 1. the `expand` nearest unexpanded entries: the beam is sorted by
    // (distance, position), so they are the first ones in order
    if (warp == 0) {
      int cnt = 0, work = 0;
      for (int base = 0; base < beam; base += 32) {
        const int i = base + lane;
        const bool open = i < beam && !b_ex[i] && b_id[i] >= 0;
        const bool act = open && b_d[i] < INFINITY;
        const unsigned m_open = __ballot_sync(FULL, open);
        const unsigned m_act = __ballot_sync(FULL, act);
        work |= m_open != 0u;
        const int r = cnt + __popc(m_act & ((1u << lane) - 1u));
        if (act && r < expand) {
          sel[r] = b_id[i];
          b_ex[i] = 1;
        }
        cnt += __popc(m_act);
      }
      if (lane == 0) {
        s_nsel = cnt < expand ? cnt : expand;
        s_work = work;
        s_nv = 0;
      }
    }
    __syncthreads();
    if (!s_work) break;
    const int nsel = s_nsel;
    ++n_rounds;
    n_lists += nsel;

    // 2. their neighbour lists, in selection order
    for (int p = tid; p < C; p += NTHREADS) {
      const int e = p / m0;
      c_id[p] = e < nsel ? nb0[(size_t)sel[e] * m0 + (p - e * m0)] : -1;
    }
    __syncthreads();

    // 3. drop -1, ids in the beam, and later occurrences within the round
    for (int p = tid; p < C; p += NTHREADS) {
      const int id = c_id[p];
      // no early exit: the compares do not depend on each other, so the
      // shared-memory loads pipeline
      bool ok = id >= 0;
      for (int i = 0; i < beam; ++i) ok &= b_id[i] != id;
      for (int p2 = 0; p2 < p; ++p2) ok &= c_id[p2] != id;
      c_d[p] = ok ? 0.0f : INFINITY;
    }
    __syncthreads();
    for (int p = tid; p < C; p += NTHREADS) {
      if (c_d[p] == 0.0f)
        c_list[atomicAdd(&s_nv, 1)] = p;
      else
        c_id[p] = -1;
    }
    __syncthreads();

    // 4. distances of the survivors
    const int nv = s_nv;
    list_dists(vectors, q, d, qn, kind, c_id, c_list, c_d, nv, warp, lane);
    n_rows += nv;
    __syncthreads();

    // 5. stable top-`beam` of beam + candidates: sort (distance, position)
    for (int i = tid; i < T; i += NTHREADS) {
      uint64_t key = ~0ull;
      if (i < beam)
        key = make_key(b_d[i], i);
      else if (i < beam + C)
        key = make_key(c_d[i - beam], i);
      keys[i] = key;
    }
    __syncthreads();
    for (int size = 2; size <= T; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < (T >> 1); t += NTHREADS) {
          const int lo = 2 * t - (t & (stride - 1));
          const int hi = lo + stride;
          const bool asc = (lo & size) == 0;
          const uint64_t a = keys[lo], b = keys[hi];
          if ((a > b) == asc) {
            keys[lo] = b;
            keys[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < beam; i += NTHREADS) {
      const int pos = (int)(uint32_t)keys[i];
      if (pos < beam) {
        nb_id[i] = b_id[pos];
        nb_d[i] = b_d[pos];
        nb_ex[i] = b_ex[pos];
      } else {  // a dropped candidate counts as expanded
        nb_id[i] = c_id[pos - beam];
        nb_d[i] = c_d[pos - beam];
        nb_ex[i] = c_id[pos - beam] < 0;
      }
    }
    __syncthreads();
    int* ti = b_id;
    b_id = nb_id;
    nb_id = ti;
    float* tf = b_d;
    b_d = nb_d;
    nb_d = tf;
    ti = b_ex;
    b_ex = nb_ex;
    nb_ex = ti;
  }

  // ---- drop dead rows, then the first k in beam order
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < beam; base += 32) {
      const int i = base + lane;
      const int id = i < beam ? b_id[i] : -1;
      const bool live = id >= 0 && alive[id] && b_d[i] < INFINITY;
      const unsigned m = __ballot_sync(FULL, live);
      const int r = cnt + __popc(m & ((1u << lane) - 1u));
      if (live && r < k) {
        out_ids[(size_t)query * k + r] = id;
        out_d[(size_t)query * k + r] = b_d[i];
      }
      cnt += __popc(m);
    }
    for (int r = (cnt < k ? cnt : k) + lane; r < k; r += 32) {
      out_ids[(size_t)query * k + r] = -1;
      out_d[(size_t)query * k + r] = INFINITY;
    }
  }
  if (tid == 0) {
    stats[query * 4 + 0] = n_steps;
    stats[query * 4 + 1] = n_rounds;
    stats[query * 4 + 2] = n_rows;
    stats[query * 4 + 3] = n_lists;
  }
}

// One thread follows `next` for `steps` dependent loads: the device-memory
// round trip that each round of the search pays at least once.
__global__ void chase_kernel(const int* __restrict__ next, int steps, int* __restrict__ out) {
  int p = 0;
  for (int i = 0; i < steps; ++i) p = next[p];
  *out = p;
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Enqueues the search of B queries on `stream`; returns 0 when the kernel was
// launched, else a cudaError_t.  The Python wrapper computes the same
// shared-memory size (`smem_bytes`) and refuses shapes past the limits.
int cozo_beam_search(const void* vectors, const void* nb0, const void* up_nb, const void* alive,
                     const void* qs, void* out_ids, void* out_d, void* stats, int B, int n_pad,
                     int d, int m0, int m_up, int n_levels, int entry, int k, int beam, int expand,
                     int max_iters, int kind, void* stream) {
  if (B < 1 || d < 1 || m0 < 1 || m_up < 1 || n_levels < 0 || entry < 0 || entry >= n_pad ||
      k < 1 || k > beam || expand < 1 || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const int C = expand * m0;
  const int T = pow2_at_least(beam + C);
  const int ccap = C > m_up ? C : m_up;
  const size_t smem = 8u * (size_t)T + 4u * (size_t)d + 24u * (size_t)beam + 12u * (size_t)ccap +
                      4u * (size_t)expand;
  if (T > 4096 || smem > 232448u) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(beam_search_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  beam_search_kernel<<<(unsigned)B, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)vectors, (const int*)nb0, (const int*)up_nb, (const uint8_t*)alive,
      (const float*)qs, (int*)out_ids, (float*)out_d, (int*)stats, n_pad, d, m0, m_up, n_levels,
      entry, k, beam, expand, max_iters, kind, T, C, ccap);
  return (int)cudaGetLastError();
}

// Measurement aid (not on any search path): enqueues a chain of `steps`
// dependent loads through the permutation `next`, for timing one
// device-memory round trip.
int cozo_chase(const void* next, int steps, void* out, void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps, (int*)out);
  return (int)cudaGetLastError();
}

const char* cozo_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
