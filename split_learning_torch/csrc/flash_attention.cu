// Flash attention forward and backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the three Pallas TPU kernels of the JAX package's
// split_learning_tpu/ops/flash_attention.py:
//
//   flash_fwd_kernel      <- _fwd_kernel      (:62-102, via _flash_fwd_bhsd)
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel  (:134-170, via _flash_bwd_rule)
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel   (:173-205, via _flash_bwd_rule)
//
// Layout: q, k, v, o, dO, dq, dk, dv are (BH, S, D) row-major, contiguous,
// in float32 or bfloat16; lse and delta are (BH, S) float32.  Q is scaled
// by 1/sqrt(D); lse is the logsumexp of the SCALED scores, so the backward
// rebuilds the softmax rows exactly as p = exp(s*scale - lse).
//
// Design (first, simple version; correctness first):
//   * One thread block of 256 threads (a 16 x 16 grid) per (bh, 64-row
//     tile): a Q tile for the forward and dQ, a K tile for dK/dV.  Blocks
//     run in parallel; the loop over the other axis inside the block takes
//     the place of the Pallas kernels' sequential fori_loop.
//   * Tiles are staged in shared memory as float32 (rows padded by one
//     float so the column walks hit distinct banks).  Products are
//     CUDA-core FMAs in full float32 for both input types: for bf16 inputs
//     each product of two bf16 values is exact in float32, the same as the
//     TPU kernel's bf16 MXU pass with float32 accumulation; for float32
//     inputs it is the counterpart of Precision.HIGHEST.
//   * The softmax state (m, l) and every accumulator stay in float32 in
//     registers.  Thread (ty, tx) owns rows ty + 16*i (i < 4) and columns
//     tx + 16*j of each 64 x 64 score tile; row maxima and sums reduce over
//     the 16 lanes of a row with warp shuffles.
//   * Causal runs skip fully masked tiles: the forward and dQ stop at the
//     diagonal tile, dK/dV starts at it.
//   * Any S works: the ragged last tile is zero-filled on load and masked.
//
// Bound at the slice's shapes ((BH, S, D) = (8*32, 256, 64), bf16, causal)
// on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): all three kernels are
// bound by memory when counted as the least work (forward ~34 MB, ~10 us;
// dK/dV ~51 MB, ~15 us; dQ ~43 MB, ~13 us; the tensor-core time of each is
// 2-4 us).  This version does not reach that bound: its products run on
// the CUDA cores (67 TFLOP/s float32), not the tensor cores, so it is
// bound by its own operations (~2-4 GFLOP a call).  What the design does
// about the memory bound is what flash attention is for: each K/V (or
// Q/dO) tile is read from device memory once per block and the S x S
// score matrix never leaves the chip.  Moving the products to wgmma
// tensor-core tiles fed by TMA is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of a Q tile and of a K tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPStride = kTile + 1;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reduce over the 16 lanes that share a row (tx = lane & 15).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

// Stage rows [r0, r0 + 64) of a (S, D) matrix into shared memory as
// float32 with row stride D + 1, times `mul`; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, float mul) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int g = r0 + r;
    dst[r * DP + c] = g < S ? to_f32(src[(size_t)g * D + c]) * mul : 0.f;
  }
}

// Stage 64 entries of a (S,) float32 row vector; entries past S are zero.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int r0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = r0 + r < S ? src[r0 + r] : 0.f;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int causal) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos);
}

// ---------------------------------------------------------------------------
// forward: one block per (bh, Q tile); loop over K/V tiles.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = (D + 15) / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * DP;
  float* sV = sK + kTile * DP;
  float* sP = sV + kTile * DP;

  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, D>(sQ, q + base, q0, S, scale);   // Q pre-scaled, as on TPU

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (S + kTile - 1) / kTile;
  const int nk_eff = causal ? min(nk, (q0 + kTile + kTile - 1) / kTile) : nk;
  for (int kb = 0; kb < nk_eff; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D>(sK, k + base, k0, S, 1.f);
    load_tile<T, D>(sV, v + base, k0, S, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked scores give p = 0 exactly; m starts at the finite
        // NEG_INF, so a row with nothing visible yet never makes a NaN
        if (!visible(qpos, k0 + tx + 16 * j, S, causal)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float vv = sV[kk * DP + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) o[base + (size_t)r * D + c] = from_f32<T>(acc[i][j] / l_safe);
    }
    if (tx == 0) lse[(size_t)blockIdx.y * S + r] = m[i] + logf(l_safe);
  }
}

// Scores and dP of one (Q tile, K tile) pair, for the thread's 4 x 4
// entries: s = (q . k) * scale masked, p = exp(s - lse), dp = dO . v,
// ds = p * (dp - delta) * scale.  Writes p and ds to registers.
template <int D>
__device__ __forceinline__ void bwd_scores(
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    const float* sL, const float* sDelta, int q0, int k0, int S, int causal,
    float scale, float p[4][4], float ds[4][4]) {
  constexpr int DP = D + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = sQ[(ty + 16 * i) * DP + d];
      dov[i] = sdO[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = sK[(tx + 16 * j) * DP + d];
      vv[j] = sV[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = visible(q0 + qr, k0 + tx + 16 * j, S, causal);
      p[i][j] = ok ? expf(s[i][j] * scale - sL[qr]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - sDelta[qr]) * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (bh, K tile); loop over Q tiles from the causal
// start.  No atomics: each block owns its dK/dV tile.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = (D + 15) / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * DP;
  float* sQ = sV + kTile * DP;
  float* sdO = sQ + kTile * DP;
  float* sP = sdO + kTile * DP;
  float* sL = sP + kTile * kPStride;
  float* sDelta = sL + kTile;

  const int k0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const float* lse_row = lse + (size_t)blockIdx.y * S;
  const float* delta_row = delta + (size_t)blockIdx.y * S;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, D>(sK, k + base, k0, S, 1.f);
  load_tile<T, D>(sV, v + base, k0, S, 1.f);

  float adk[4][DJ], adv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int nq = (S + kTile - 1) / kTile;
  const int qb_start = causal ? k0 / kTile : 0;
  for (int qb = qb_start; qb < nq; ++qb) {
    const int q0 = qb * kTile;
    __syncthreads();
    load_tile<T, D>(sQ, q + base, q0, S, 1.f);
    load_tile<T, D>(sdO, dout + base, q0, S, 1.f);
    load_vec(sL, lse_row, q0, S);
    load_vec(sDelta, delta_row, q0, S);
    __syncthreads();

    float p[4][4], ds[4][4];
    bwd_scores<D>(sQ, sdO, sK, sV, sL, sDelta, q0, k0, S, causal, scale, p,
                  ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = p[i][j];
    __syncthreads();
    // dV[kr, c] += sum_q P[q, kr] * dO[q, c]
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[qq * kPStride + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float x = sdO[qq * DP + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) adv[i][j] = fmaf(pv[i], x, adv[i][j]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dK[kr, c] += sum_q dS[q, kr] * Q[q, c]
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sP[qq * kPStride + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float x = sQ[qq * DP + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) adk[i][j] = fmaf(dsv[i], x, adk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        dk[base + (size_t)r * D + c] = from_f32<T>(adk[i][j]);
        dv[base + (size_t)r * D + c] = from_f32<T>(adv[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (bh, Q tile); loop over K tiles up to the diagonal.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = (D + 15) / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * DP;
  float* sK = sdO + kTile * DP;
  float* sV = sK + kTile * DP;
  float* sP = sV + kTile * DP;
  float* sL = sP + kTile * kPStride;
  float* sDelta = sL + kTile;

  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, D>(sQ, q + base, q0, S, 1.f);
  load_tile<T, D>(sdO, dout + base, q0, S, 1.f);
  load_vec(sL, lse + (size_t)blockIdx.y * S, q0, S);
  load_vec(sDelta, delta + (size_t)blockIdx.y * S, q0, S);

  float adq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adq[i][j] = 0.f;

  const int nk = (S + kTile - 1) / kTile;
  const int nk_eff = causal ? min(nk, (q0 + kTile + kTile - 1) / kTile) : nk;
  for (int kb = 0; kb < nk_eff; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    load_tile<T, D>(sK, k + base, k0, S, 1.f);
    load_tile<T, D>(sV, v + base, k0, S, 1.f);
    __syncthreads();

    float p[4][4], ds[4][4];
    bwd_scores<D>(sQ, sdO, sK, sV, sL, sDelta, q0, k0, S, causal, scale, p,
                  ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ[qr, c] += sum_k dS[qr, k] * K[k, c]
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sP[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float x = sK[kk * DP + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) adq[i][j] = fmaf(dsv[i], x, adq[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dq[base + (size_t)r * D + c] = from_f32<T>(adq[i][j]);
    }
  }
}

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kPStride);
}
constexpr size_t bwd_smem(int D) {
  return sizeof(float) *
         (4 * kTile * (D + 1) + kTile * kPStride + 2 * kTile);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int S, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int S, float scale, int causal, cudaStream_t stream) {
  const size_t smem = bwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, S, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int S,
              float scale, int causal, cudaStream_t stream) {
  const size_t smem = bwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Dispatch on (dtype, D): dtype 0 = float32, 1 = bfloat16; D in
// {8, 16, 32, 64, 128}.  Anything else returns cudaErrorInvalidValue.
#define SLT_DISPATCH(DTYPE, DIM, CALL)                                     \
  do {                                                                     \
    if ((DTYPE) == 0) {                                                    \
      using T = float;                                                     \
      switch (DIM) {                                                       \
        case 8: { constexpr int D = 8; return CALL; }                      \
        case 16: { constexpr int D = 16; return CALL; }                    \
        case 32: { constexpr int D = 32; return CALL; }                    \
        case 64: { constexpr int D = 64; return CALL; }                    \
        case 128: { constexpr int D = 128; return CALL; }                  \
      }                                                                    \
    } else if ((DTYPE) == 1) {                                             \
      using T = __nv_bfloat16;                                             \
      switch (DIM) {                                                       \
        case 8: { constexpr int D = 8; return CALL; }                      \
        case 16: { constexpr int D = 16; return CALL; }                    \
        case 32: { constexpr int D = 32; return CALL; }                    \
        case 64: { constexpr int D = 64; return CALL; }                    \
        case 128: { constexpr int D = 128; return CALL; }                  \
      }                                                                    \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

extern "C" {

int slt_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                  void* o, void* lse, int bh, int s, int d, float scale,
                  int causal, void* stream) {
  SLT_DISPATCH(dtype, d,
               (launch_fwd<T, D>(q, k, v, o, (float*)lse, bh, s, scale,
                                 causal, (cudaStream_t)stream)));
}

int slt_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int s, int d, float scale,
                      int causal, void* stream) {
  SLT_DISPATCH(dtype, d,
               (launch_dkv<T, D>(q, k, v, dout, (const float*)lse,
                                 (const float*)delta, dk, dv, bh, s, scale,
                                 causal, (cudaStream_t)stream)));
}

int slt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int s, int d, float scale, int causal,
                     void* stream) {
  SLT_DISPATCH(dtype, d,
               (launch_dq<T, D>(q, k, v, dout, (const float*)lse,
                                (const float*)delta, dq, bh, s, scale, causal,
                                (cudaStream_t)stream)));
}

}  // extern "C"
