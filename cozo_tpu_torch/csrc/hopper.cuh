// Hopper's copy engine and barriers as both chunk-step kernels use them
// (`sweep_topk.cu`, `sweep_topk_f32.cu`): `mbarrier`s in shared memory,
// the Tensor Memory Accelerator's 2-D tile copy (`cp.async.bulk.tensor`)
// that completes its bytes on one, and on the host the tensor map of a
// row-major matrix, encoded through the driver's entry point (no link to
// libcuda).  sm_90a.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cozo_hopper {

// ---- device ------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Arrives on the barrier and adds `bytes` to the transactions its phase
// waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Whether the phase of parity `parity` has completed (no wait).
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// The box of `map` at (c0, c1) (innermost coordinate first) into shared
// memory at dst, its bytes completed on the barrier at `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- host --------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !p) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// Tensor map of a row-major [rows, cols] matrix of `type` (elements of
// `esize` bytes), boxes of box_rows rows x box_cols elements, zeros out of
// bounds.  Returns 0, a cudaError_t, or a negated CUresult.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* ptr,
                     long long rows, long long cols, int box_cols, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn;
  cudaError_t e = encode_fn(&fn);
  if (e != cudaSuccess) return (int)e;
  const cuuint64_t gdim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t gstride[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  CUresult r = fn(map, type, 2, const_cast<void*>(ptr), gdim, gstride, box, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

}  // namespace cozo_hopper
