// MinHash signatures of a batch of docs for Hopper (sm_90a): for doc d and
// permutation p,
//
//   out[d, p] = min over t in [off[d], end(d)) of fmix32(h[t] ^ seed[p])
//
// with end(d) = off[d + 1] (the last doc runs to T) and 0xFFFFFFFF for an
// empty doc, in native 32-bit unsigned arithmetic (murmur3's fmix32).
//
// Replaces the TPU function `_device_segment_min` (cozo_tpu/ops/
// minhash.py:209-238), a jitted [T_pad, n_perm] broadcast of the mix
// followed by a sorted `segment_min` into [D_pad, n_perm], over shapes
// padded to powers of two.  At a backfill chunk of 32,768 docs that
// materialises a 268 MB u32 array (T_pad 524,288 x 128 permutations)
// before the reduction.  Here no [T, n_perm] array exists anywhere: a
// block owns a contiguous range of docs, a thread owns permutations
// p = tid, tid + NTHREADS, ... (n_perm need not divide the block) with its
// seed and running minimum in registers, the docs' hashes pass through
// shared memory in tiles that every thread reads as a broadcast (a doc of
// any length loops over its tiles), and each signature row is written
// coalesced.  The doc starts are taken as they are: no padding, and no
// host fix of a last doc that padding would merge with.
//
// What bounds it: integer operations.  A (token, permutation) pair costs
// 10: the seed xor, three shifts, three xors and the min, which issue on
// the ALU pipe, and two multiplies, which issue on the FMA pipe (Nsight
// Compute's pipe definitions) at the same time.  The bytes are 4 T of
// hashes and 8 D of starts in and 4 D n_perm of signatures out: at a chunk
// of ~410K tokens, 32,768 docs and 128 permutations, 52M pairs against
// 18.7 MB.  The bound `chip_smoke.py` states takes the busiest of three
// rates, in lanes an SM a clock: the ALU's 64 for its 8 operations, the
// FMA pipe's 64 for the 2 multiplies (NVIDIA's Hopper architecture white
// paper: 16 INT32 lanes per SM sub-partition), and the schedulers' issue
// of 128 for all 10.  The ALU is the busiest: 0.125 SM clocks a pair,
// spread over 132 SMs at the maximum SM clock `nvidia-smi` reports, some
// 0.025 ms a chunk at 1,980 MHz, while the bytes take 0.006 ms at 3.35 TB/s.  The
// staging of a tile costs two block barriers and one coalesced read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef COZO_MINHASH_THREADS
#define COZO_MINHASH_THREADS 128
#endif
#ifndef COZO_MINHASH_TILE
#define COZO_MINHASH_TILE 2048
#endif

constexpr int NTHREADS = COZO_MINHASH_THREADS;
constexpr int TILE = COZO_MINHASH_TILE;  // hashes staged at a time (8 KB)
constexpr int DOCS_PER_BLOCK = 16;

__device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A doc's token range, clamped into [0, T] (so no input makes a read out
// of bounds); an empty range is an empty doc.
__device__ __forceinline__ void doc_range(const long long* off, int T, int D, int d, long long& s,
                                          long long& e) {
  s = clamp_ll(off[d], 0, T);
  e = d + 1 < D ? clamp_ll(off[d + 1], s, T) : (long long)T;
}

__global__ void __launch_bounds__(NTHREADS)
    segment_min_kernel(const unsigned* __restrict__ h, const long long* __restrict__ off, int T,
                       int D, const unsigned* __restrict__ seeds, int n_perm,
                       unsigned* __restrict__ out) {
  __shared__ unsigned tile[TILE];
  const int d0 = blockIdx.x * DOCS_PER_BLOCK;
  const int d1 = d0 + DOCS_PER_BLOCK < D ? d0 + DOCS_PER_BLOCK : D;
  // where the block's docs end: a tile never reaches past it
  const long long span_end = d1 < D ? clamp_ll(off[d1], 0, T) : (long long)T;
  for (int pg = 0; pg < n_perm; pg += NTHREADS) {
    const int p = pg + threadIdx.x;
    const bool mine = p < n_perm;
    const unsigned seed = mine ? seeds[p] : 0u;
    // the staged tile is [lo, hi); every thread walks the same tokens, so
    // each test below comes out the same in the whole block
    long long lo = 0, hi = 0;
    for (int d = d0; d < d1; ++d) {
      long long t, e;
      doc_range(off, T, D, d, t, e);
      unsigned m = 0xFFFFFFFFu;
      while (t < e) {
        if (t < lo || t >= hi) {
          __syncthreads();  // the previous tile's readers are done
          lo = t;
          hi = t + TILE < (long long)T ? t + TILE : (long long)T;
          if (span_end > t && span_end < hi) hi = span_end;
          for (long long i = threadIdx.x; i < hi - lo; i += NTHREADS) tile[i] = h[lo + i];
          __syncthreads();
        }
        const long long stop = e < hi ? e : hi;
        for (; t < stop; ++t) {
          const unsigned x = fmix32(tile[t - lo] ^ seed);
          m = x < m ? x : m;
        }
      }
      if (mine) out[(long long)d * n_perm + p] = m;
    }
  }
}

}  // namespace

extern "C" {

// Enqueues the signatures of D docs on `stream`: hashes [T] u32, offsets
// [D] i64 doc starts (no trailing total), seeds [n_perm] u32, out
// [D, n_perm] u32.  Returns 0 when the kernel was launched (or there was
// nothing to do), else a cudaError_t.  Allocates nothing, does not
// synchronise.
int cozo_minhash_segments(const void* hashes, const void* offsets, int T, int D,
                          const void* seeds, int n_perm, void* out, void* stream) {
  if (T < 0 || D < 0 || n_perm < 1) return (int)cudaErrorInvalidValue;
  if (D == 0) return 0;
  segment_min_kernel<<<(D + DOCS_PER_BLOCK - 1) / DOCS_PER_BLOCK, NTHREADS, 0,
                       (cudaStream_t)stream>>>(
      (const unsigned*)hashes, (const long long*)offsets, T, D, (const unsigned*)seeds, n_perm,
      (unsigned*)out);
  return (int)cudaGetLastError();
}

const char* cozo_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
