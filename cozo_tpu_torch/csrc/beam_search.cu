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
// What bounds it: at the batch sizes it serves (B < 64, fewer blocks than
// SMs) one block walks a chain of dependent steps, and every step needs at
// least two trips to device memory, one for neighbour lists and one for the
// rows they name.  Bytes and operations are far below the card's rates.  The
// trips are the floor, but not what a step costs most: with every row and
// list served from the L2 cache this kernel is only about a seventh faster
// (on an NVIDIA H100 80GB HBM3, 700 W).  The rest is the block's own
// instruction stream: a phase costs about five clocks for every instruction
// on its longest thread, whether that thread waits on its own dependent
// shared-memory accesses, ballots and atomics (one warp working) or on the
// other fifteen warps' scheduler slots (all working).  So the design spends
// its effort on the number of instructions a round puts on its critical
// path, not on throughput:
//
//   - One thread block per query; the query, the sorted beam (id, distance,
//     expanded flag; double-buffered) and one round's expand * m0 candidates
//     live in shared memory.
//   - The descent runs inside warp 0 with warp barriers only: an upper
//     level's list is m_up rows, which the warp's four 8-lane groups read in
//     one trip.
//   - A beam round is five phases, each ended by one block barrier (four in
//     a round that changes nothing; the first version of this kernel had 53,
//     45 of them inside a full sort of beam + candidates):
//       1. warp 0 picks the `expand` first unexpanded entries (the beam is
//          sorted, so they are the nearest);
//       2. every thread loads one neighbour id (all lists in one trip) and
//          enters it into an open-addressing table keyed by id: beam ids
//          (from the block's last threads) with position -1, candidates with
//          the `atomicMin` of their position.  O(beam + C) instead of
//          O(C * (beam + C)) compares;
//       3. a candidate survives iff the table's position for its id is its
//          own ("not in the beam, first occurrence wins"); survivors are
//          compacted with ballots, one atomic a warp;
//       4. distances: 8 lanes share a row and read it with 16-byte loads, so
//          one warp instruction reads four rows, and every group keeps up to
//          ROWS rows in flight: the block covers NGROUPS * ROWS = 256
//          survivors before the first sum is needed, one trip for the whole
//          round, and executes nothing for the quarters of that range a
//          round does not fill.  Lane u of a group finishes its u-th row.  A
//          distance below the beam's last (strictly: on a tie the beam entry
//          has the lower position and wins) appends its 64-bit (ordered
//          distance, position) key to the round's short list, one atomic a
//          warp; the table is cleared for the next round in the same phase;
//       5. merge without a sort: all keys are distinct, so an entry's new
//          place is the number of keys below its own.  A beam entry counts
//          the listed keys below it, a listed candidate counts them too and
//          finds its place among the beam's distances by binary search
//          (MERGE_LANES lanes share a count); each writes itself into the
//          other beam buffer if its place is inside.  Past RANK_MAX listed
//          keys (only while a wide beam fills) the list is sorted by a block
//          bitonic network first and both counts become binary searches.  A
//          round in which nothing passes skips the phase.
//     The result is `lax.top_k`'s: equal distances keep the lower position.
//   - The kernel is a template on the width of a row load: 16 bytes, or 4
//     for rows whose width is not a multiple of 4 floats (or that are not
//     16-byte aligned).
//
// The per-query counters it writes (descent steps, beam rounds, rows read,
// neighbour lists read) give the bound of a run from its own data.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifndef COZO_BEAM_THREADS
#define COZO_BEAM_THREADS 512
#endif
constexpr int NTHREADS = COZO_BEAM_THREADS;  // a multiple of 32
constexpr int SUB = 8;                  // lanes that share one row
constexpr int NGROUPS = NTHREADS / SUB; // rows one load instruction of the block reads
constexpr int ROWS = 4;                 // rows whose loads one group keeps in flight
constexpr int LOADS = 4;                // loads per row and lane started before their use
constexpr int RANK_MAX = 256;           // listed keys placed by counting; sorted beyond
constexpr int MERGE_LANES = 2;          // lanes that share one item's count in the merge
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

__device__ __forceinline__ float group_sum(float v) {
  for (int o = SUB / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
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

// VEC floats at `p` (zeros unless `ok`) in one load; LDG: from device memory
// through the read-only path.
template <int VEC, bool LDG>
__device__ __forceinline__ void load_vec(const float* p, bool ok, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    if (ok) t = LDG ? __ldg(p4) : *p4;
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = !ok ? 0.0f : LDG ? __ldg(p) : *p;
  }
}

// Distances of the rows c_id[c_list[0..nv)] to the query, written to
// c_d[c_list[j]].  Group `group` of `ngroups` (SUB lanes each, `sub` the lane
// within) takes rows j = group, group + ngroups, ...; all loads of up to ROWS
// rows and of a SUB * VEC * LOADS-wide slice are started before the first fma
// needs one.  Lane u of a group finishes the group's u-th row; a distance
// below `thr` appends (distance, key_base + position) to keys[0..*n_keys),
// one atomic a warp.  Every lane of a warp must call it with the same nv and
// ngroups.
template <int VEC>
__device__ __forceinline__ void row_dists(const float* __restrict__ vectors, const float* q, int d,
                                          float qn, int kind, const int* c_id, const int* c_list,
                                          float* c_d, int nv, int group, int ngroups, int sub,
                                          float thr, uint64_t* keys, int* n_keys, int key_base) {
  constexpr int SLICE = SUB * VEC * LOADS;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < nv; base += ngroups * ROWS) {
    const float* row[ROWS];
    int pos[ROWS];
    float dot[ROWS], cn[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int j = base + u * ngroups + group;
      pos[u] = j < nv ? c_list[j] : -1;
      // this lane's first floats of the row
      row[u] = vectors + (long long)(pos[u] >= 0 ? c_id[pos[u]] : 0) * d + sub * VEC;
      dot[u] = 0.0f;
      cn[u] = 0.0f;
    }
    for (int s0 = 0; s0 < d; s0 += SLICE) {
      float c[ROWS][LOADS][VEC];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (base + u * ngroups < nv) {  // the same for every caller
#pragma unroll
          for (int l = 0; l < LOADS; ++l) {
            const int i = s0 + (l * SUB + sub) * VEC;
            load_vec<VEC, true>(row[u] + s0 + l * SUB * VEC, pos[u] >= 0 && i < d, c[u][l]);
          }
        }
      }
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        const int i = s0 + (l * SUB + sub) * VEC;
        float qi[VEC];
        load_vec<VEC, false>(q + i, i < d, qi);
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          if (base + u * ngroups < nv) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              dot[u] = fmaf(c[u][l][e], qi[e], dot[u]);
              cn[u] = fmaf(c[u][l][e], c[u][l][e], cn[u]);
            }
          }
        }
      }
    }
    float my_dot = 0.0f, my_cn = 0.0f;
    int my_pos = -1;
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (base + u * ngroups < nv) {
        dot[u] = group_sum(dot[u]);
        cn[u] = group_sum(cn[u]);
        if (sub == u) {
          my_dot = dot[u];
          my_cn = cn[u];
          my_pos = pos[u];
        }
      }
    }
    float dist = INFINITY;
    if (my_pos >= 0) {
      dist = finish_dist(my_dot, my_cn, qn, kind);
      c_d[my_pos] = dist;
    }
    const bool pass = my_pos >= 0 && dist < thr;
    const unsigned listed = __ballot_sync(FULL, pass);
    if (listed != 0u) {
      int at = 0;
      if (lane == 0) at = atomicAdd(n_keys, __popc(listed));
      at = __shfl_sync(FULL, at, 0);
      if (pass) keys[at + __popc(listed & ((1u << lane) - 1u))] = make_key(dist, key_base + my_pos);
    }
  }
}

// The dedup table: h_id[slot] an id or -1, h_pos[slot] the lowest position
// entered for it (INT_MAX when empty); linear probing from a multiplicative
// hash.  It has at least twice as many slots as a round can enter ids.  (One
// 64-bit word a slot was tried and was slower: shared memory has no native
// 64-bit minimum.)
__device__ __forceinline__ unsigned table_slot(int id, int log_h) {
  return ((unsigned)id * 2654435761u) >> (32 - log_h);
}

__device__ __forceinline__ void table_enter(int* h_id, int* h_pos, int log_h, int id, int pos) {
  const unsigned mask = (1u << log_h) - 1u;
  unsigned s = table_slot(id, log_h);
  while (true) {
    const int prev = atomicCAS(&h_id[s], -1, id);
    if (prev == -1 || prev == id) break;
    s = (s + 1) & mask;
  }
  atomicMin(&h_pos[s], pos);
}

// The position entered for `id`, which is in the table.
__device__ __forceinline__ int table_pos(const int* h_id, const int* h_pos, int log_h, int id) {
  const unsigned mask = (1u << log_h) - 1u;
  unsigned s = table_slot(id, log_h);
  while (h_id[s] != id) s = (s + 1) & mask;
  return h_pos[s];
}

__device__ __forceinline__ void table_clear(int* h_id, int* h_pos, int H, int tid) {
#pragma unroll 1
  for (int s = tid; s < H; s += NTHREADS) {
    h_id[s] = -1;
    h_pos[s] = INT_MAX;
  }
}

// The first j with keys[j] >= key in the sorted keys[0..n).
__device__ __forceinline__ int lower_bound(const uint64_t* keys, int n, uint64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int VEC>  // 4: rows read with 16-byte loads; 1: with 4-byte loads
__global__ void __launch_bounds__(NTHREADS, 1)
beam_search_kernel(const float* __restrict__ vectors, const int* __restrict__ nb0,
                   const int* __restrict__ up_nb, const uint8_t* __restrict__ alive,
                   const float* __restrict__ qs, int* __restrict__ out, int* __restrict__ stats,
                   int n_pad, int d, int m0, int m_up, int n_levels, int entry, int k, int beam,
                   int expand, int max_iters, int kind, int C, int KP, int ccap, int log_h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d4 = (d + 3) & ~3, H = 1 << log_h;
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem_raw);  // [KP] the round's listed keys
  float* q = reinterpret_cast<float*>(keys + KP);          // [d4], 16-byte aligned
  int* beam_id = reinterpret_cast<int*>(q + d4);           // [2][beam]
  float* beam_d = reinterpret_cast<float*>(beam_id + 2 * beam);
  int* beam_ex = reinterpret_cast<int*>(beam_d + 2 * beam);
  int* c_id = beam_ex + 2 * beam;                          // [ccap] candidate ids
  float* c_d = reinterpret_cast<float*>(c_id + ccap);      // [ccap] their distances
  int* c_list = reinterpret_cast<int*>(c_d + ccap);        // [ccap] positions to score
  int* h_id = c_list + ccap;                               // [H] the dedup table
  int* h_pos = h_id + H;                                   // [H]
  int* sel = h_pos + H;                                    // [expand]

  __shared__ int s_nv, s_nkeys, s_nsel, s_cur;
  __shared__ float s_qn, s_curd;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = tid / SUB, sub = tid % SUB;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int e0 = tid / m0, j0 = tid - e0 * m0;  // this thread's first candidate: list, place
  const int query = blockIdx.x;
  int n_steps = 0, n_rounds = 0, n_rows = 0, n_lists = 0;  // thread 0's are written

  for (int i = tid; i < d4; i += NTHREADS) q[i] = i < d ? qs[(size_t)query * d + i] : 0.0f;
  table_clear(h_id, h_pos, H, tid);
  __syncthreads();

  // ---- warp 0: |q|, the entry's distance, the greedy descent
  if (warp == 0) {
    float s = 0.0f;
    for (int i = lane; i < d; i += 32) s = fmaf(q[i], q[i], s);
    s = warp_sum(s);
    const float qn = (kind == 2) ? sqrtf(s) : s;
    int cur = entry;
    if (lane == 0) {
      c_id[0] = cur;
      c_list[0] = 0;
    }
    __syncwarp();
    row_dists<VEC>(vectors, q, d, qn, kind, c_id, c_list, c_d, 1, lane / SUB, 32 / SUB, sub,
                   -INFINITY, keys, &s_nkeys, 0);
    __syncwarp();
    float curd = c_d[0];
    n_rows = 1;
    for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
      while (true) {
        __syncwarp();
        const int* nbr = up_nb + ((size_t)lvl * n_pad + cur) * (size_t)m_up;
        int nv = 0;
        for (int p0 = 0; p0 < m_up; p0 += 32) {
          const int p = p0 + lane;
          const int id = p < m_up ? __ldg(nbr + p) : -1;
          if (p < m_up) {
            c_id[p] = id;
            c_d[p] = INFINITY;
          }
          const unsigned m = __ballot_sync(FULL, id >= 0);
          if (id >= 0) c_list[nv + __popc(m & lanes_below)] = p;
          nv += __popc(m);
        }
        __syncwarp();
        row_dists<VEC>(vectors, q, d, qn, kind, c_id, c_list, c_d, nv, lane / SUB, 32 / SUB, sub,
                       -INFINITY, keys, &s_nkeys, 0);
        __syncwarp();
        uint64_t best = ~0ull;  // first minimum, as jnp.argmin
        for (int p = lane; p < m_up; p += 32) {
          const uint64_t key = make_key(c_d[p], p);
          best = key < best ? key : best;
        }
        for (int o = 16; o > 0; o >>= 1) {
          const uint64_t other = __shfl_xor_sync(FULL, best, o);
          best = other < best ? other : best;
        }
        const int p = (int)(uint32_t)best;
        const float bestd = c_d[p];
        n_rows += nv;
        ++n_lists;
        ++n_steps;
        if (!(bestd < curd)) break;
        cur = c_id[p];
        curd = bestd;
      }
    }
    if (lane == 0) {
      s_qn = qn;
      s_cur = cur;
      s_curd = curd;
    }
  }
  __syncthreads();
  const float qn = s_qn;

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
      for (int base = 0; base < beam && cnt < expand; base += 64) {  // two entries a lane
        const int i0 = base + lane, i1 = i0 + 32;
        const bool open0 = i0 < beam && !b_ex[i0] && b_id[i0] >= 0;
        const bool open1 = i1 < beam && !b_ex[i1] && b_id[i1] >= 0;
        const bool act0 = open0 && b_d[i0] < INFINITY;
        const bool act1 = open1 && b_d[i1] < INFINITY;
        const unsigned m_open = __ballot_sync(FULL, open0 || open1);
        const unsigned m_act0 = __ballot_sync(FULL, act0);
        const unsigned m_act1 = __ballot_sync(FULL, act1);
        work |= m_open != 0u;
        const int r0 = cnt + __popc(m_act0 & lanes_below);
        const int r1 = cnt + __popc(m_act0) + __popc(m_act1 & lanes_below);
        if (act0 && r0 < expand) {
          sel[r0] = b_id[i0];
          b_ex[i0] = 1;
        }
        if (act1 && r1 < expand) {
          sel[r1] = b_id[i1];
          b_ex[i1] = 1;
        }
        cnt += __popc(m_act0) + __popc(m_act1);
      }
      if (lane == 0) {
        s_nsel = work ? (cnt < expand ? cnt : expand) : -1;  // -1: no entry is left to expand
        s_nv = 0;
        s_nkeys = 0;
      }
    }
    __syncthreads();
    const int nsel = s_nsel;
    if (nsel < 0) break;
    ++n_rounds;
    n_lists += nsel;

    // 2. their neighbour lists, in selection order, one id a thread; beam
    // ids (from the block's last threads, which seldom hold a candidate)
    // and candidates enter the table
    for (int i = NTHREADS - 1 - tid; i < beam; i += NTHREADS)
      if (b_id[i] >= 0) table_enter(h_id, h_pos, log_h, b_id[i], -1);
    for (int p = tid, e = e0, j = j0; p < C; p += NTHREADS) {
      int id = -1;
      if (e < nsel) id = __ldg(nb0 + (long long)sel[e] * m0 + j);
      c_id[p] = id;
      if (id >= 0) table_enter(h_id, h_pos, log_h, id, p);
      e = (p + NTHREADS) / m0;
      j = p + NTHREADS - e * m0;
    }
    __syncthreads();

    // 3. survivors: not -1, not in the beam, the first occurrence of the id
    for (int p0 = warp * 32; p0 < C; p0 += NTHREADS) {
      const int p = p0 + lane;
      bool ok = false;
      if (p < C) {
        const int id = c_id[p];
        ok = id >= 0 && table_pos(h_id, h_pos, log_h, id) == p;
        if (!ok) c_id[p] = -1;
      }
      const unsigned m = __ballot_sync(FULL, ok);
      int at = 0;
      if (lane == 0 && m != 0u) at = atomicAdd(&s_nv, __popc(m));
      at = __shfl_sync(FULL, at, 0);
      if (ok) c_list[at + __popc(m & lanes_below)] = p;
    }
    __syncthreads();

    // 4. distances of the survivors; those below the beam's last are listed
    const int nv = s_nv;
    const float thr = b_d[beam - 1];
    table_clear(h_id, h_pos, H, tid);
    row_dists<VEC>(vectors, q, d, qn, kind, c_id, c_list, c_d, nv, group, NGROUPS, sub, thr, keys,
                   &s_nkeys, beam);
    n_rows += nv;
    __syncthreads();

    // 5. merge the listed candidates into the beam
    const int nk = s_nkeys;
    if (nk == 0) continue;  // the beam stays; phase 1 marked what was expanded
    const bool sorted = nk > RANK_MAX;
    if (sorted) {
      int P = 1;
      while (P < nk) P <<= 1;
      for (int i = nk + tid; i < P; i += NTHREADS) keys[i] = ~0ull;
      __syncthreads();
      for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int t = tid; t < (P >> 1); t += NTHREADS) {
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
    }
    // one item (a beam entry, then a listed candidate) per MERGE_LANES
    // lanes, which share the count of the listed keys below it
    const int n_items = beam + nk;
    for (int item0 = warp * (32 / MERGE_LANES); item0 < n_items;
         item0 += NTHREADS / MERGE_LANES) {
      const int item = item0 + lane / MERGE_LANES;
      const bool valid = item < n_items;
      uint64_t key = 0;
      if (valid) key = item < beam ? make_key(b_d[item], item) : keys[item - beam];
      int below;
      if (sorted) {
        below = item < beam ? lower_bound(keys, nk, key) : item - beam;
      } else {
        below = 0;
#pragma unroll 4
        for (int j = lane % MERGE_LANES; j < nk; j += MERGE_LANES) below += keys[j] < key;
        for (int o = MERGE_LANES / 2; o > 0; o >>= 1) below += __shfl_xor_sync(FULL, below, o);
      }
      if (!valid || lane % MERGE_LANES != 0) continue;
      if (item < beam) {
        const int at = item + below;
        if (at < beam) {
          nb_id[at] = b_id[item];
          nb_d[at] = b_d[item];
          nb_ex[at] = b_ex[item];
        }
      } else {
        const int p = (int)(uint32_t)key - beam;
        const float cd = c_d[p];
        int lo = 0, hi = beam;  // beam entries not farther stay ahead
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (b_d[mid] <= cd)
            lo = mid + 1;
          else
            hi = mid;
        }
        const int at = lo + below;
        if (at < beam) {
          nb_id[at] = c_id[p];
          nb_d[at] = cd;
          nb_ex[at] = 0;
        }
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

  // ---- drop dead rows, then the first k in beam order: ids, then the
  // distances' bits
  int* o_id = out + (size_t)query * 2 * k;
  int* o_d = o_id + k;
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < beam && cnt < k; base += 32) {
      const int i = base + lane;
      const int id = i < beam ? b_id[i] : -1;
      const bool live = id >= 0 && alive[id] && b_d[i] < INFINITY;
      const unsigned m = __ballot_sync(FULL, live);
      const int r = cnt + __popc(m & lanes_below);
      if (live && r < k) {
        o_id[r] = id;
        o_d[r] = __float_as_int(b_d[i]);
      }
      cnt += __popc(m);
    }
    for (int r = (cnt < k ? cnt : k) + lane; r < k; r += 32) {
      o_id[r] = -1;
      o_d[r] = __float_as_int(INFINITY);
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

int log2_at_least(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// the largest dynamic shared-memory size each kernel has been allowed so far
// on each device (the attribute is set once per size, not per launch)
int smem_allowed[2][64];

}  // namespace

extern "C" {

// Enqueues the search of B queries on `stream`, a stream of `device` (where
// the arrays live); returns 0 when the kernel was launched, else a
// cudaError_t.  `out` takes B * (2 k + 4) ints: [B, 2k] with
// a query's k ids, then the bits of its k float distances; behind them the
// counters [B, 4].  The Python wrapper computes the same shared-memory size
// (`smem_bytes`) and refuses shapes past the limits.
int cozo_beam_search(const void* vectors, const void* nb0, const void* up_nb, const void* alive,
                     const void* qs, void* out, int B, int n_pad, int d, int m0, int m_up,
                     int n_levels, int entry, int k, int beam, int expand, int max_iters, int kind,
                     int device, void* stream) {
  if (B < 1 || d < 1 || m0 < 1 || m_up < 1 || n_levels < 0 || entry < 0 || entry >= n_pad ||
      k < 1 || k > beam || expand < 1 || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const int C = expand * m0;
  const int KP = 1 << log2_at_least(C > 2 ? C : 2);
  const int ccap = C > m_up ? C : m_up;
  const int log_h = log2_at_least(2 * (beam + C));
  const size_t smem = 8u * (size_t)KP + 4u * (size_t)((d + 3) & ~3) + 24u * (size_t)beam +
                      12u * (size_t)ccap + (8u << log_h) + 4u * (size_t)expand;
  if (KP > 4096 || smem > 232448u) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int vec4 = d % 4 == 0 && (uintptr_t)vectors % 16 == 0;
  auto kernel = vec4 ? beam_search_kernel<4> : beam_search_kernel<1>;
  if ((int)smem > smem_allowed[vec4][device] && smem > 48u * 1024u)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) {
    if ((int)smem > smem_allowed[vec4][device]) smem_allowed[vec4][device] = (int)smem;
    int* o = (int*)out;
    kernel<<<(unsigned)B, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const float*)vectors, (const int*)nb0, (const int*)up_nb, (const uint8_t*)alive,
        (const float*)qs, o, o + (size_t)B * 2 * k, n_pad, d, m0, m_up, n_levels, entry, k, beam,
        expand, max_iters, kind, C, KP, ccap, log_h);
    e = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return (int)e;
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
