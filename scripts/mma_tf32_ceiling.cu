// The ceiling of mma.sync m16n8k8 TF32 (f32 accumulation) on the card:
// TFLOP/s of a kernel doing nothing but independent mma on registers, by
// accumulators a warp keeps in flight and blocks of four warps an SM. Kernel
// #14 (position_induced_transformer_torch/kernels/csrc/dotatt.cuh) runs its
// 3xTF32 products on this instruction; its source notes cite the ceiling.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o /tmp/mma_tf32_ceiling \
//       scripts/mma_tf32_ceiling.cu && /tmp/mma_tf32_ceiling
//
// Prints one line per configuration and, last, one JSON object with the
// card's name and the best rate.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int NACC>
__global__ void bench(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (seed * (threadIdx.x + i)) & 0x3f800000u;
  for (int i = 0; i < 2; ++i) b[i] = (seed * (threadIdx.x + 7 * i)) & 0x3f800000u;
  float d[NACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma(d[j], a, b);
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j)
    for (int e = 0; e < 4; ++e) s += d[j][e];
  if (s == 1.2345f) out[threadIdx.x] = s;  // keeps the work
}

template <int NACC>
double run(int sms, int blocks_per_sm, float* out) {
  const int iters = 20000 / NACC * 8;
  dim3 grid(sms * blocks_per_sm), block(128);
  bench<NACC><<<grid, block>>>(out, 100, 3);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<NACC><<<grid, block>>>(out, iters, 3);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double tflops = 2.0 * 16 * 8 * 8 * (double)iters * NACC * grid.x * 4 / ms / 1e9;
  printf("accumulators a warp %d, blocks of 4 warps an SM %d: %.1f TFLOP/s\n", NACC, blocks_per_sm,
         tflops);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return tflops;
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) return 1;
  float* out = nullptr;
  if (cudaMalloc(&out, 4096) != cudaSuccess) return 1;
  double best = 0.0;
  for (int bps : {1, 2, 4}) {
    const double r[4] = {run<1>(prop.multiProcessorCount, bps, out),
                         run<2>(prop.multiProcessorCount, bps, out),
                         run<4>(prop.multiProcessorCount, bps, out),
                         run<8>(prop.multiProcessorCount, bps, out)};
    for (double x : r) best = x > best ? x : best;
  }
  cudaFree(out);
  if (cudaGetLastError() != cudaSuccess) return 1;
  printf("{\"device\": \"%s\", \"mma_sync_tf32_best_tflops\": %.1f}\n", prop.name, best);
  return 0;
}
