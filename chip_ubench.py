#!/usr/bin/env python3
"""Issue rates of the CUDA-core instructions in the fused sweep's epilogue,
measured on the card.

    python3 chip_ubench.py

The epilogue of `cozo_tpu_torch/csrc/fused_sweep.cu` spends five
instructions on every score: `add.f32` (bias), `lop3` (pack the column id),
`min.f32`, `max.f32`, `max.f32` (running top-2).  This compiles a small
CUDA program with `nvcc` for sm_90a into `build/cozo_tpu_torch_kernels/`
and prints, for each instruction alone and for the five together, the
clocks one SM sub-partition needs per warp instruction, with 1, 2 and 4
warps resident on each sub-partition (the kernel's two consumer warpgroups
put 2 there).  Every thread runs 8 independent dependency chains, so the
figure is the issue rate, not the latency.  It needs CUDA and checks
nothing.
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_ubench: CUDA is not available", file=sys.stderr)
        return 1
    from cozo_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "epilogue_ubench.cu")
    exe = os.path.join(_build.BUILD_DIR, "epilogue_ubench")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-o", exe, src],
                   check=True)
    subprocess.run([exe], check=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                    "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
