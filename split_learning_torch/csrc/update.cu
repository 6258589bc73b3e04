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
// Design: a grid-stride loop over the flat leaf; tw and m arrive as
// float arguments (a new total weight needs no rebuild).  The (d0, rest)
// view of the TPU kernel is a blocking choice for its grid; the flat loop
// needs none.
//   finalize: 16-byte float4 loads with the read-once hint (__ldcs), four
//   vectors in flight a thread a step, so each SM keeps enough bytes in
//   flight to cover device memory's latency; stores of four values at
//   once (16 bytes for float32 and int32, 8 for bf16, fp16 and int16, 4
//   for the byte types) with the streaming hint (__stcs).  The grid is
//   four times the SMs' resident blocks (the SM count is read once).  A scalar
//   prologue covers the elements before acc reaches 16-byte alignment (a
//   view such as acc[1:]) and a scalar epilogue the n % 4 tail; when the
//   output is not aligned like the input after the prologue, the four
//   values are stored one by one.
//   momentum: one element a thread a step.
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
__device__ __forceinline__ T finalize_one(float x, float tw) {
  float a = __fdiv_rn(x, tw);
  if (RND) a = rintf(a);
  return cast_out<T>(a);
}

// Four output values as one store: VST stores them at once (p aligned
// to 4 * sizeof(T)), else one by one.
template <typename T, bool VST>
__device__ __forceinline__ void store4(T* p, const T (&y)[4]) {
  if constexpr (VST) {
    struct alignas(4 * sizeof(T)) Four {
      T v[4];
    } f = {{y[0], y[1], y[2], y[3]}};
    if constexpr (sizeof(T) == 4) {
      __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<uint4*>(&f));
    } else if constexpr (sizeof(T) == 2) {
      __stcs(reinterpret_cast<uint2*>(p), *reinterpret_cast<uint2*>(&f));
    } else if constexpr (sizeof(T) == 1) {
      __stcs(reinterpret_cast<unsigned int*>(p),
             *reinterpret_cast<unsigned int*>(&f));
    } else {   // 8-byte values: two 16-byte stores
      __stcs(reinterpret_cast<ulonglong2*>(p),
             reinterpret_cast<ulonglong2*>(&f)[0]);
      __stcs(reinterpret_cast<ulonglong2*>(p) + 1,
             reinterpret_cast<ulonglong2*>(&f)[1]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = y[e];
  }
}

constexpr int kVecPerThread = 4;   // float4 loads in flight a thread

// out[i] = cast(acc[i] / tw) for i < n.  The first `head` elements (acc
// + head is 16-byte aligned) and the n % 4 tail after them are scalar.
template <typename T, bool RND, bool VST>
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ acc, long long n, int head,
                float tw, T* __restrict__ out) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  if (tid < head) out[tid] = finalize_one<T, RND>(acc[tid], tw);
  const float4* a4 = reinterpret_cast<const float4*>(acc + head);
  T* o4 = out + head;
  const long long nv = (n - head) / 4;
  for (long long i0 = tid; i0 < nv; i0 += nthreads * kVecPerThread) {
    float4 x[kVecPerThread];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const long long i = i0 + u * nthreads;
      if (i < nv) x[u] = __ldcs(a4 + i);
    }
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      const long long i = i0 + u * nthreads;
      if (i < nv) {
        const T y[4] = {finalize_one<T, RND>(x[u].x, tw),
                        finalize_one<T, RND>(x[u].y, tw),
                        finalize_one<T, RND>(x[u].z, tw),
                        finalize_one<T, RND>(x[u].w, tw)};
        store4<T, VST>(o4 + 4 * i, y);
      }
    }
  }
  const long long t0 = head + 4 * nv;
  if (tid < n - t0) out[t0 + tid] = finalize_one<T, RND>(acc[t0 + tid], tw);
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

// Four times the blocks all SMs hold at once (kThreads-thread blocks,
// 2048 threads an SM), no more than the vectors need; the SM count is
// read once.
cudaError_t resident_grid(long long vectors, int* grid) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  const long long cap = 4LL * sms * (2048 / kThreads);
  long long blocks = (vectors + (long long)kThreads * kVecPerThread - 1) /
                     ((long long)kThreads * kVecPerThread);
  if (blocks > cap) blocks = cap;
  *grid = (int)(blocks < 1 ? 1 : blocks);
  return cudaSuccess;
}

template <typename T, bool RND>
int launch_finalize_rnd(const float* acc, long long n, void* out,
                        float tw, cudaStream_t s) {
  // elements until acc is 16-byte aligned (acc is 4-byte aligned)
  long long head = ((16 - (long long)((uintptr_t)acc & 15)) & 15) / 4;
  if (head > n) head = n;
  const bool vst =
      (((uintptr_t)((T*)out + head)) % (4 * sizeof(T))) == 0;
  int grid = 0;
  const cudaError_t err = resident_grid((n - head) / 4, &grid);
  if (err != cudaSuccess) return (int)err;
  if (vst) {
    finalize_kernel<T, RND, true><<<grid, kThreads, 0, s>>>(
        acc, n, (int)head, tw, (T*)out);
  } else {
    finalize_kernel<T, RND, false><<<grid, kThreads, 0, s>>>(
        acc, n, (int)head, tw, (T*)out);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finalize(const float* acc, long long n, float tw, int rnd,
                    void* out, cudaStream_t s) {
  if ((uintptr_t)acc & 3) return (int)cudaErrorMisalignedAddress;
  return rnd ? launch_finalize_rnd<T, true>(acc, n, out, tw, s)
             : launch_finalize_rnd<T, false>(acc, n, out, tw, s);
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
