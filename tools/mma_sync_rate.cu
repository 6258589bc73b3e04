// Latency and throughput of one mma.sync on the card: m16n8k8 TF32 (the
// split-TF32 flash backward's product) and m16n8k16 bf16 (the bf16 flash
// kernels'), each warp running ILP independent accumulators, one block of
// W warps on each of 132 SMs.  Cycles come from clock64() in each warp;
// "cycles a sub-partition" divides by the warps that share one of the SM's
// four schedulers.
//
// Build and run from the root of a checkout, on a machine with one H100:
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/mma_sync_rate tools/mma_sync_rate.cu && build/mma_sync_rate

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kBlocks = 132;

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int ILP, bool kBf16>
__global__ void rate(float* out, long long* cycles, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x * 5u, b1 = 11u;
  float c[ILP][4];
  for (int i = 0; i < ILP; ++i)
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      if (kBf16)
        mma_bf16(c[i], a, b0, b1);
      else
        mma_tf32(c[i], a, b0, b1);
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < ILP; ++i)
    for (int e = 0; e < 4; ++e) s += c[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;   // keeps the products
  if (threadIdx.x % 32 == 0)
    cycles[blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32] = t1 - t0;
}

template <int ILP, bool kBf16>
void run(int warps) {
  const int threads = 32 * warps, iters = 4096;
  float* out;
  long long* cycles;
  cudaMalloc(&out, kBlocks * threads * sizeof(float));
  cudaMalloc(&cycles, kBlocks * warps * sizeof(long long));
  rate<ILP, kBf16><<<kBlocks, threads>>>(out, cycles, 16);   // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<ILP, kBf16><<<kBlocks, threads>>>(out, cycles, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  long long host[kBlocks * 32];
  cudaMemcpy(host, cycles, kBlocks * warps * sizeof(long long),
             cudaMemcpyDeviceToHost);
  double mean = 0.0;
  for (int i = 0; i < kBlocks * warps; ++i) mean += host[i];
  mean /= kBlocks * warps;
  const double per_warp = mean / ((double)iters * ILP);
  const double sharing = warps > 4 ? warps / 4.0 : 1.0;
  const double flops = (double)iters * ILP * (kBf16 ? 4096 : 2048) *
                       kBlocks * warps;
  printf("%s ILP %2d, %2d warps an SM: %5.1f cycles a mma a warp, %5.2f a "
         "sub-partition, %6.1f TFLOP/s\n",
         kBf16 ? "bf16 m16n8k16" : "tf32 m16n8k8 ", ILP, warps, per_warp,
         per_warp / sharing, flops / ms / 1e9);
  cudaFree(out);
  cudaFree(cycles);
}

}  // namespace

int main() {
  run<1, false>(4);
  run<4, false>(4);
  run<8, false>(4);
  run<8, false>(8);
  run<8, false>(16);
  run<16, false>(16);
  run<1, true>(4);
  run<8, true>(4);
  run<8, true>(8);
  run<8, true>(16);
  return cudaDeviceSynchronize() != cudaSuccess;
}
