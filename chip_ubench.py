#!/usr/bin/env python3
"""Issue rates of the CUDA-core instructions in the fused sweep's epilogue,
and the rate at which table tiles stream from L2 to the SMs, measured on
the card.

    python3 chip_ubench.py [--epilogue-only | --l2-only]

The epilogue of `cozo_tpu_torch/csrc/fused_sweep.cu` spends five
instructions on every score: `add.f32` (bias), `lop3` (pack the column id),
`min.f32`, `max.f32`, `max.f32` (running top-2).  This compiles a small
CUDA program with `nvcc` for sm_90a into `build/cozo_tpu_torch_kernels/`
and prints, for each instruction alone and for the five together, the
clocks one SM sub-partition needs per warp instruction, with 1, 2 and 4
warps resident on each sub-partition (the kernel's two consumer warpgroups
put 2 there).  Every thread runs 8 independent dependency chains, so the
figure is the issue rate, not the latency.

The stream (`L2_SOURCE`): `sweep_topk.cu`'s ring without its products or
selection.  128 blocks (one a 128-query tile of the bf16 lane's 16,384)
each stream the whole bf16 table of the main path, 1,310,720 x 128 (335.5
MB, past the 50 MB L2), through a ring of 16 KB tiles (TMA, 128-byte
swizzle), every block in the kernel's golden-ratio tile order, so that
the blocks read each tile at about the same time and device memory
serves it about once; three consumer warps wait for each tile and free
its slot.  Clusters of 1 (each block loads its own tiles), of 2 (each
block loads half of every tile with `.multicast::cluster` into both) and
of 4 (a quarter into all four), at 4 and 8 stages: the bytes the SMs receive a second (blocks x table /
time) and those leaving L2 (the same over the cluster).  It needs CUDA
and checks nothing.
"""

import os
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdio.h>
#define ITER 2048
#define CH 8
template <int OP>
__global__ void k(float* out, long long* clk, int seed) {
  float x[CH], y[CH];
  for (int i = 0; i < CH; ++i) {
    x[i] = seed * 0.5f + threadIdx.x + i;
    y[i] = seed * 0.25f + i * 3 - threadIdx.x;
  }
  int keep = ~255 + seed - 1;
  long long t0 = clock64();
  for (int it = 0; it < ITER; ++it) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (OP == 0) asm volatile("max.f32 %0, %0, %1;" : "+f"(x[i]) : "f"(y[i]));
      if (OP == 1)
        asm volatile("lop3.b32 %0, %0, %1, %2, 0xEA;"
                     : "+r"(*(int*)&x[i]) : "r"(keep), "r"(*(int*)&y[i]));
      if (OP == 2) asm volatile("add.f32 %0, %0, %1;" : "+f"(x[i]) : "f"(y[i]));
      if (OP == 3)
        asm volatile("max.s32 %0, %0, %1;" : "+r"(*(int*)&x[i]) : "r"(*(int*)&y[i]));
      if (OP == 4) {  // the epilogue's five: x = top1, y = top2 of a stream
        float s, p, t;
        asm volatile("add.f32 %0, %1, %2;" : "=f"(s) : "f"(x[i]), "f"(y[i]));
        asm volatile("lop3.b32 %0, %1, %2, %3, 0xEA;"
                     : "=r"(*(int*)&p) : "r"(*(int*)&s), "r"(keep), "r"(it));
        asm volatile("min.f32 %0, %1, %2;" : "=f"(t) : "f"(x[i]), "f"(p));
        asm volatile("max.f32 %0, %0, %1;" : "+f"(y[i]) : "f"(t));
        asm volatile("max.f32 %0, %0, %1;" : "+f"(x[i]) : "f"(p));
      }
    }
  }
  long long t1 = clock64();
  float s = 0;
  for (int i = 0; i < CH; ++i) s += x[i] + y[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if ((threadIdx.x & 31) == 0) clk[(blockIdx.x * blockDim.x + threadIdx.x) >> 5] = t1 - t0;
}
template <int OP>
void run(const char* name, int per, int threads, int blocks) {
  float* out;
  long long* clk;
  int nw = blocks * threads / 32;
  cudaMalloc(&out, blocks * threads * 4);
  cudaMalloc(&clk, nw * 8);
  for (int r = 0; r < 2; ++r) k<OP><<<blocks, threads>>>(out, clk, 1);
  cudaDeviceSynchronize();
  long long* h = new long long[nw];
  cudaMemcpy(h, clk, nw * 8, cudaMemcpyDeviceToHost);
  long long mx = 0;
  for (int i = 0; i < nw; ++i) mx = h[i] > mx ? h[i] : mx;
  double instr = (double)ITER * CH * per * (threads / 32) / 4.0;  // per sub-partition
  printf("%-34s %d warp(s) per sub-partition: %.2f clocks per warp instruction (%s)\n",
         name, threads / 128, mx / instr, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out); cudaFree(clk); delete[] h;
}
int main() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int threads : {128, 256, 512}) {  // one block per SM
    run<0>("max.f32", 1, threads, sms);
    run<1>("lop3.b32", 1, threads, sms);
    run<2>("add.f32", 1, threads, sms);
    run<3>("max.s32", 1, threads, sms);
    run<4>("add, lop3, min, max, max (a score)", 5, threads, sms);
  }
  return 0;
}
"""


L2_SOURCE = r"""
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdio.h>
#include <stdint.h>
#define CHECK(x) do { cudaError_t e_ = (x); if (e_ != cudaSuccess) { \
  printf("CUDA error %s at %d\n", cudaGetErrorString(e_), __LINE__); exit(1); } } while (0)
constexpr int TN = 64, ROW = 128;
constexpr uint32_t T_BOX = TN * ROW, TILE = 2 * T_BOX;  // bf16, d_pad 128
__device__ __forceinline__ void mbar_init(uint32_t b, uint32_t n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(b), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t b, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(b), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void arrive_cluster(uint32_t b, uint32_t cta) {
  asm volatile("{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
               "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}" :: "r"(b), "r"(cta) : "memory");
}
__device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* m, uint32_t bar, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4}], [%2];" :: "r"(dst), "l"((uint64_t)m), "r"(bar), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void load_mc(uint32_t dst, const CUtensorMap* m, uint32_t bar, int c0, int c1,
                                        uint16_t mask) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;"
               :: "r"(dst), "l"((uint64_t)m), "r"(bar), "h"(mask), "r"(c0), "r"(c1) : "memory");
}
template <int CL, int STAGES>
__global__ void __launch_bounds__(128, 1) stream(const __grid_constant__ CUtensorMap map, int n_tiles,
                                                 int stride, int* sink) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * TILE, empty = full + 8 * STAGES;
  uint32_t rank = 0;
  if (CL > 1) asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) { mbar_init(full + 8 * s, 1); mbar_init(empty + 8 * s, 3 * CL); }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (warp == 0) {
    if (lane == 0) {
      for (int e = 0; e < n_tiles; ++e) {
        const int s = e % STAGES, round = e / STAGES;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const int row = (int)(((long long)e * stride) % n_tiles) * TN;
        mbar_expect_tx(full + 8 * s, TILE);
        for (int c = 0; c < 2; ++c) {
          const uint32_t dst = base + s * TILE + c * T_BOX;
          if (CL > 1)
            load_mc(dst + rank * (T_BOX / CL), &map, full + 8 * s, c * 64, row + rank * (TN / CL),
                    (uint16_t)((1u << CL) - 1));
          else
            load(dst, &map, full + 8 * s, c * 64, row);
        }
      }
      for (int e = n_tiles; e < n_tiles + STAGES; ++e)
        if (e / STAGES > 0) mbar_wait(empty + 8 * (e % STAGES), (e / STAGES - 1) & 1);
    }
    return;
  }
  int acc = 0;
  for (int e = 0; e < n_tiles; ++e) {
    const int s = e % STAGES;
    mbar_wait(full + 8 * s, (e / STAGES) & 1);
    acc += smem_raw[(base - (uint32_t)__cvta_generic_to_shared(smem_raw)) + s * TILE + lane * 4];
    __syncwarp();
    if (lane == 0)
      for (int r = 0; r < CL; ++r) arrive_cluster(empty + 8 * s, r);
  }
  if (acc == 12345) sink[0] = acc;
}
typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                           const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                           CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
template <int CL, int STAGES>
void run(void* tbl, long long rows, int blocks, Encode enc, int* sink) {
  CUtensorMap map;
  const cuuint64_t gdim[2] = {128, (cuuint64_t)rows}, gstride[1] = {256};
  const cuuint32_t box[2] = {64, (cuuint32_t)(TN / CL)}, es[2] = {1, 1};
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, tbl, gdim, gstride, box, es,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) { printf("encode failed\n"); exit(1); }
  const int n_tiles = (int)(rows / TN);
  int stride = (int)(0.6180339887 * n_tiles);
  auto gcd = [](int a, int b) { while (b) { int r = a % b; a = b; b = r; } return a; };
  while (gcd(stride, n_tiles) != 1) ++stride;
  const int bytes = STAGES * TILE + 16 * STAGES + 1024;
  auto k = stream<CL, STAGES>;
  CHECK(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks); cfg.blockDim = dim3(128); cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL; attr.val.clusterDim.y = 1; attr.val.clusterDim.z = 1;
  cfg.attrs = &attr; cfg.numAttrs = 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a); cudaEventCreate(&b);
  CHECK(cudaLaunchKernelEx(&cfg, k, map, n_tiles, stride, sink));  // warm
  CHECK(cudaDeviceSynchronize());
  float best = 1e30f, sum = 0.f;
  for (int r = 0; r < 5; ++r) {
    cudaEventRecord(a);
    CHECK(cudaLaunchKernelEx(&cfg, k, map, n_tiles, stride, sink));
    cudaEventRecord(b);
    CHECK(cudaEventSynchronize(b));
    float ms; cudaEventElapsedTime(&ms, a, b);
    best = ms < best ? ms : best; sum += ms;
  }
  const double table = (double)rows * 256, to_sms = table * blocks;
  printf("L2 stream: %d blocks, clusters of %d, %d stages of 16 KB: %.3f ms a launch (best %.3f, mean of 5); "
         "to the SMs %.1f GB = %.2f TB/s; from L2 %.1f GB = %.2f TB/s\n", blocks, CL, STAGES, best, sum / 5,
         to_sms / 1e9, to_sms / best / 1e9, to_sms / CL / 1e9, to_sms / CL / best / 1e9);
}
int main() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  CHECK(cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q));
  Encode enc = (Encode)p;
  const long long rows = 1310720;
  void* tbl;
  int* sink;
  CHECK(cudaMalloc(&tbl, rows * 256));
  CHECK(cudaMemset(tbl, 1, rows * 256));
  CHECK(cudaMalloc(&sink, 4));
  for (int blocks : {128, 132}) {
    run<1, 4>(tbl, rows, blocks, enc, sink);
    run<1, 8>(tbl, rows, blocks, enc, sink);
    run<2, 4>(tbl, rows, blocks, enc, sink);
    run<2, 8>(tbl, rows, blocks, enc, sink);
    run<4, 4>(tbl, rows, blocks, enc, sink);
    run<4, 8>(tbl, rows, blocks, enc, sink);
  }
  return 0;
}
"""


def build_run(name, source, nvcc, build_dir):
    src = os.path.join(build_dir, f"{name}.cu")
    exe = os.path.join(build_dir, name)
    with open(src, "w") as f:
        f.write(source)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-o", exe, src], check=True)
    subprocess.run([exe], check=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_ubench: CUDA is not available", file=sys.stderr)
        return 1
    from cozo_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    nvcc = _build.nvcc_path()
    if "--l2-only" not in sys.argv:
        build_run("epilogue_ubench", SOURCE, nvcc, _build.BUILD_DIR)
    if "--epilogue-only" not in sys.argv:
        build_run("l2_stream_ubench", L2_SOURCE, nvcc, _build.BUILD_DIR)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                    "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
