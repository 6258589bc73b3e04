// Fused round-boundary stage update for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of the JAX package's
// split_learning_tpu/ops/kernels/update.py:
//
//   finalize_kernel  <- _finalize_kernel  (:53, via finalize_leaf :60)
//   momentum_kernel  <- _momentum_kernel  (:81, via momentum_leaf :89)
//
// finalize: out = cast(acc / tw), with round-half-even first for integer
//   wire dtypes — the FedAvg divide of one leaf's float32 running sum.
// momentum (FedAvgM, the oracle's op order):
//   a  = acc / tw
//   v' = m * v + (base - a)
//   p  = cast(base - v')
//   emitting p and the float32 v' in one pass.
//
// Numerics are the oracle's bit for bit: a true IEEE division
// (__fdiv_rn), separate multiply, add and subtract (__fmul_rn,
// __fadd_rn, __fsub_rn — never contracted into an FMA, which would round
// once where the oracle rounds twice), round half to even (rintf), and
// round-to-nearest-even casts to bfloat16 and float16.  Integer casts
// truncate toward zero after the rounding, like XLA's convert.
//
// Design (simple first): a grid-stride loop over the flat leaf, one
// element a thread a step; tw and m arrive as float arguments (a new
// total weight needs no rebuild).  The (d0, rest) view of the TPU kernel
// is a blocking choice for its grid; the flat loop needs none.
//
// Bound on an H100 SXM (3.35 TB/s): both kernels are bound by memory.
// momentum over all 1.1 B TinyLlama parameters reads acc, base and v and
// writes p and v' (20 bytes a parameter, ~22 GB a round, ~6.6 ms);
// finalize moves 4 bytes in and 4 (float32) or 2 (bfloat16) out a value.
// Each byte is read or written once; the arithmetic is a few operations
// a value.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ T cast_out(float x);
template <> __device__ __forceinline__ float cast_out<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
cast_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half cast_out<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ int32_t cast_out<int32_t>(float x) {
  return __float2int_rz(x);
}
template <> __device__ __forceinline__ int64_t cast_out<int64_t>(float x) {
  return (int64_t)__float2ll_rz(x);
}
template <> __device__ __forceinline__ int16_t cast_out<int16_t>(float x) {
  return (int16_t)__float2int_rz(x);
}
template <> __device__ __forceinline__ int8_t cast_out<int8_t>(float x) {
  return (int8_t)__float2int_rz(x);
}
template <> __device__ __forceinline__ uint8_t cast_out<uint8_t>(float x) {
  return (uint8_t)__float2int_rz(x);
}
template <> __device__ __forceinline__ bool cast_out<bool>(float x) {
  return x != 0.0f;
}

template <typename T, bool RND>
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ acc, long long n, float tw,
                T* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    float a = __fdiv_rn(acc[i], tw);
    if (RND) a = rintf(a);
    out[i] = cast_out<T>(a);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
momentum_kernel(const float* __restrict__ acc,
                const float* __restrict__ base,
                const float* __restrict__ vel, long long n, float tw,
                float m, T* __restrict__ p, float* __restrict__ nv) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const float a = __fdiv_rn(acc[i], tw);
    const float b = base[i];
    const float v = __fadd_rn(__fmul_rn(m, vel[i]), __fsub_rn(b, a));
    nv[i] = v;
    p[i] = cast_out<T>(__fsub_rn(b, v));
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;   // a few waves of the 132 SMs
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

template <typename T>
int launch_finalize(const float* acc, long long n, float tw, int rnd,
                    void* out, cudaStream_t s) {
  if (rnd) {
    finalize_kernel<T, true><<<grid_for(n), kThreads, 0, s>>>(
        acc, n, tw, (T*)out);
  } else {
    finalize_kernel<T, false><<<grid_for(n), kThreads, 0, s>>>(
        acc, n, tw, (T*)out);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_momentum(const float* acc, const float* base, const float* vel,
                    long long n, float tw, float m, void* p, float* nv,
                    cudaStream_t s) {
  momentum_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
      acc, base, vel, n, tw, m, (T*)p, nv);
  return (int)cudaGetLastError();
}

}  // namespace

// Output dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 int32,
// 4 int64, 5 int8, 6 uint8, 7 int16, 8 bool.
#define SLT_OUT_DISPATCH(CODE, CALL)                 \
  do {                                               \
    switch (CODE) {                                  \
      case 0: { using T = float; return CALL; }      \
      case 1: { using T = __nv_bfloat16; return CALL; } \
      case 2: { using T = __half; return CALL; }     \
      case 3: { using T = int32_t; return CALL; }    \
      case 4: { using T = int64_t; return CALL; }    \
      case 5: { using T = int8_t; return CALL; }     \
      case 6: { using T = uint8_t; return CALL; }    \
      case 7: { using T = int16_t; return CALL; }    \
      case 8: { using T = bool; return CALL; }       \
    }                                                \
    return (int)cudaErrorInvalidValue;               \
  } while (0)

extern "C" {

int slt_finalize(const void* acc, long long n, float tw, int rnd,
                 int out_dtype, void* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  SLT_OUT_DISPATCH(out_dtype,
                   (launch_finalize<T>((const float*)acc, n, tw, rnd, out,
                                       (cudaStream_t)stream)));
}

int slt_momentum(const void* acc, const void* base, const void* vel,
                 long long n, float tw, float m, int out_dtype, void* p,
                 void* nv, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  SLT_OUT_DISPATCH(out_dtype,
                   (launch_momentum<T>((const float*)acc,
                                       (const float*)base,
                                       (const float*)vel, n, tw, m, p,
                                       (float*)nv, (cudaStream_t)stream)));
}

}  // extern "C"
