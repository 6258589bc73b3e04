// Flash attention forward and backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the three Pallas TPU kernels of the JAX package's
// split_learning_tpu/ops/flash_attention.py:
//
//   flash_fwd_tc_kernel      <- _fwd_kernel      (:62-102, via _flash_fwd_bhsd)
//                               bfloat16, D in {16, 32, 64, 128}
//   flash_fwd_kernel         <- _fwd_kernel      float32, and bfloat16 D = 8
//   flash_bwd_dkv_tc_kernel  <- _bwd_dkv_kernel  (:134-170, via _flash_bwd_rule)
//                               bfloat16, D in {16, 32, 64, 128}
//   flash_bwd_dkv_kernel     <- _bwd_dkv_kernel  float32, and bfloat16 D = 8
//   flash_bwd_dq_tc_kernel   <- _bwd_dq_kernel   (:173-205, via _flash_bwd_rule)
//                               bfloat16, D in {16, 32, 64, 128}
//   flash_bwd_dq_kernel      <- _bwd_dq_kernel   float32, and bfloat16 D = 8
//
// Layout: q, k, v, o, dO, dq, dk, dv are (BH, S, D) row-major, contiguous,
// in float32 or bfloat16; lse and delta are (BH, S) float32.  lse is the
// natural-log logsumexp of the SCALED scores (scale = 1/sqrt(D)), so the
// backward rebuilds the softmax rows exactly as p = exp(s*scale - lse).
// Any S works: ragged tiles are zero-filled on load and masked.
//
// Bound at the slice's shapes ((BH, S, D) = (8*32, 256, 64), bf16, causal)
// on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): all three kernels are
// bound by memory when counted as the least work (forward ~34 MB, ~10 us;
// dK/dV ~51 MB, ~15 us; dQ ~43 MB, ~13 us; the tensor-core time of each is
// 2-4 us).  What every design here does about it is what flash attention
// is for: each K/V (or Q/dO) tile is read from device memory once per
// block and the S x S score matrix never leaves the chip.
//
// flash_fwd_tc_kernel (the bf16 forward of the main path), FlashAttention-2
// shaped, on mma.sync tensor cores:
//   * One block of 4 warps per (bh, 64-row Q tile); each warp owns 16 Q
//     rows.  Causal blocks are issued heaviest (last Q tile) first.
//   * Q is staged once with 16-byte cp.async and held in registers as
//     mma.sync.m16n8k16 A fragments (ldmatrix) for the whole loop.
//   * K/V tiles are bf16 in shared memory, in a ring of 4 stages (2 at
//     D = 128): the copies (cp.async, zero-filled past S) of the next 3
//     tiles are in flight while tile kb computes, so a causal block of
//     the slice asks for all its tiles at once; one barrier per tile.
//     Rows are 16-byte chunks XOR-swizzled by the row, so the ldmatrix
//     phases of 8 rows hit 8 distinct bank groups.  9 tiles = 72 KB of
//     shared memory a block at D = 64; 158 registers, 3 blocks an SM.
//   * S = Q K^T in bf16 x bf16 -> float32 accumulators; only the diagonal
//     and ragged tiles are masked.  The float32 scores are scaled in log2
//     units, p = 2^(s*scale*log2(e) - m), one FFMA and one ex2.approx a
//     score.  m and l of each row live in registers, reduced over the 4
//     lanes of a quad; l is summed from the float32 p.
//   * P never leaves registers: it is rounded to bf16 (what the TPU
//     kernel's Precision.DEFAULT bf16 pass does with p) and two adjacent n8
//     accumulator fragments become one k16 A fragment of P V, with V read
//     by ldmatrix.trans.
//   * o = acc * (1 / l_safe), one division a row, goes out through shared
//     memory as 16-byte stores; lse converts m back to natural log:
//     m*ln(2) + log(l_safe).
//   The k16 step of mma.sync does not fit D = 8, and float32 inputs must
//   not lose precision to bf16 or TF32 (Precision.HIGHEST), so both keep
//   flash_fwd_kernel.
//
// flash_bwd_dkv_tc_kernel (dK and dV of the bf16 main path), the
// transposed form of FlashAttention-2's backward, on the forward's tiles:
//   * One block of 4 warps per (bh, 64-row K tile); each warp owns 16 K
//     rows.  Under causality K tile 0 loops over every Q tile, so blocks
//     go in index order: the heaviest of each head first.
//   * K and V are staged once (16-byte cp.async) and held in registers as
//     A fragments (at D = 128 they stay in shared memory and are read by
//     ldmatrix at each product: in registers they would spill beside the
//     doubled dK/dV accumulators).
//   * Q, dO, lse and delta tiles stream through a 3-stage cp.async ring
//     (2 at D = 128); bf16 rows swizzled as in the forward, the two float
//     rows by 4-byte copies (zero-filled past S, any row alignment).
//   * S^T = K Q^T and dP^T = V dO^T, with Q and dO as B operands by plain
//     ldmatrix: the accumulators of S^T and dP^T are then laid out as the
//     A operand of the next product, so P^T and dS^T never touch shared
//     memory.  lse and delta are indexed by the column (the query) and
//     read as float2 from the ring's row buffers.
//   * P^T = 2^(s*scale*log2(e) - lse*log2(e)) is rounded to bf16 for
//     dV += P^T dO; dS^T = P^T (dP^T - delta) * scale, from the float32
//     P^T, is rounded to bf16 for dK += dS^T Q (Precision.DEFAULT's one
//     bf16 pass); dO and Q are read by ldmatrix.trans there.  Only the
//     diagonal and ragged tiles are masked (p = 0).
//   * dK and dV accumulate in float32 registers and go out through this
//     warp's rows of the K and V tiles as 16-byte bf16 stores.  No atomics:
//     each block owns its dK/dV tile, as in the TPU decomposition, so the
//     result is deterministic.
//   At D = 64: 243 registers, no spills, 65.5 KB of shared memory, so 2
//   blocks an SM.  Bounding it to 3 blocks spills; K and V read from
//   shared memory at every product, and rings of 2 or 4 stages, were all
//   no faster on an H100.
//
// flash_bwd_dq_tc_kernel (dQ of the bf16 main path), the forward's shape
// with one more product:
//   * One block of 4 warps per (bh, 64-row Q tile), heaviest (last Q
//     tile) first.  Q and dO are held in registers as A fragments; lse (in
//     log2 units) and delta of the thread's two rows in registers.
//   * K/V tiles stream through a 3-stage cp.async ring (2 at D = 128) up
//     to the diagonal.  S = Q K^T and dP = dO V^T with K and V as B
//     operands by plain ldmatrix; p = 2^(...) and dS = p (dP - delta) *
//     scale in float32 registers; dS rounded to bf16 is the A operand of
//     dQ += dS K, K read by ldmatrix.trans.  Only the diagonal and ragged
//     tiles are masked.
//   * dQ goes out through this warp's rows of the Q tile as 16-byte stores.
//   At D = 64 it is bounded to 3 blocks an SM (168 registers, no spills,
//   64 KB of shared memory); unbounded it takes 232 and 2 blocks, ~8 %
//   slower on an H100.
//
// flash_fwd_kernel and the two CUDA-core backward kernels (the float32 and
// D = 8 routes):
//   * One thread block of 256 threads (a 16 x 16 grid) per (bh, 64-row
//     tile): a Q tile for the forward and dQ, a K tile for dK/dV.  Blocks
//     run in parallel; the loop over the other axis inside the block takes
//     the place of the Pallas kernels' sequential fori_loop.
//   * Tiles are staged in shared memory as float32 (rows padded by one
//     float so the column walks hit distinct banks).  Products are
//     CUDA-core FMAs in full float32 for both input types: for bf16 inputs
//     each product of two bf16 values is exact in float32; for float32
//     inputs it is the counterpart of Precision.HIGHEST.  The forward
//     pre-scales Q in float32, as the TPU kernel does.
//   * The softmax state (m, l) and every accumulator stay in float32 in
//     registers.  Thread (ty, tx) owns rows ty + 16*i (i < 4) and columns
//     tx + 16*j of each 64 x 64 score tile; row maxima and sums reduce over
//     the 16 lanes of a row with warp shuffles.
//   * Causal runs skip fully masked tiles: the forward and dQ stop at the
//     diagonal tile, dK/dV starts at it.
//   These run their products on the CUDA cores (67 TFLOP/s float32), so
//   they are bound by their own operations (~2-4 GFLOP a call), well above
//   the memory bound.

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

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores: one block of 4 warps per (bh, Q tile).
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 128;   // 4 warps x 16 Q rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a tile of CH chunks a row:
// the chunk index is XORed with the row's low bits, so the 8 rows an
// ldmatrix phase reads at one logical chunk land in distinct bank groups.
template <int CH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kMask = (CH < 8 ? CH : 8) - 1;
  return (uint32_t)((r * CH + (c ^ (r & kMask))) * 16);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's newest copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Issue the copies of rows [r0, r0 + 64) of a (S, D) bf16 matrix into a
// swizzled tile; rows past S are zero-filled.
template <int D>
__device__ __forceinline__ void stage_tile_bf16(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int r0, int S) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < kTile * CH / kTcThreads; ++i) {
    const int idx = threadIdx.x + i * kTcThreads;
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < S;
    cp_async16(dst + swz<CH>(r, c), src + (size_t)(ok ? r0 + r : 0) * D + c * 8,
               ok);
  }
}

// K/V stages of the copy ring: three tiles in flight ahead of the one
// computing (a causal block of the slice issues all its tiles at once);
// at D = 128 two stages, one tile ahead: four (144 KB) would leave one
// block an SM.
template <int D>
__host__ __device__ constexpr int tc_stages() {
  return D <= 64 ? 4 : 2;
}

template <int D>
constexpr size_t fwd_tc_smem() {   // Q, then K and V per stage
  return (size_t)(1 + 2 * tc_stages<D>()) * kTile * D * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int S, float scale_log2, int causal) {
  constexpr int CH = D / 8;    // 16-byte chunks of a row; n8 tiles of O
  constexpr int KD = D / 16;   // k16 steps of Q K^T; n8 pairs of O
  constexpr int NS = tc_stages<D>();
  constexpr uint32_t kTileBytes = kTile * D * sizeof(__nv_bfloat16);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_u32(tc_smem);
  const uint32_t sK0 = sQ + kTileBytes;           // NS K tiles
  const uint32_t sV0 = sK0 + NS * kTileBytes;     // NS V tiles

  // blockIdx.x walks the Q tiles of one (bh), last (under causal the
  // heaviest) first; the blocks of one (bh) run together, so its K and V
  // come from L2 after the first read
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qrow = q0 + warp * 16 + g;   // this thread's rows: qrow, qrow + 8

  const int nk = (S + kTile - 1) / kTile;
  const int nk_eff = causal ? min(nk, qb + 1) : nk;

  // the ring: copy group i holds K/V tile i (group 0 also Q); a group is
  // committed every step, empty past the last tile, so that "tile kb has
  // landed" is always "at most NS - 2 newer groups pending"
  stage_tile_bf16<D>(sQ, q + base, q0, S);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nk_eff) {
      stage_tile_bf16<D>(sK0 + i * kTileBytes, k + base, i * kTile, S);
      stage_tile_bf16<D>(sV0 + i * kTileBytes, v + base, i * kTile, S);
    }
    cp_async_commit();
  }

  uint32_t qf[KD][4];
  float oacc[CH][4];
#pragma unroll
  for (int n = 0; n < CH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // running max (log2 units) and this thread's partial row sums; m starts
  // at the finite NEG_INF so a row with nothing visible yet gives no NaN
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < nk_eff; ++kb) {
    cp_async_wait<NS - 2>();
    __syncthreads();   // tile kb has landed; tile kb-1's stage is free
    if (kb == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(sQ + swz<CH>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                             2 * kk + (lane >> 4)),
                qf[kk]);
    }
    {   // refill the stage tile kb-1 used with tile kb + NS - 1
      const int nt = kb + NS - 1;
      if (nt < nk_eff) {
        const uint32_t off = (nt % NS) * kTileBytes;
        stage_tile_bf16<D>(sK0 + off, k + base, nt * kTile, S);
        stage_tile_bf16<D>(sV0 + off, v + base, nt * kTile, S);
      }
      cp_async_commit();
    }
    const uint32_t sK = sK0 + (kb % NS) * kTileBytes;
    const uint32_t sV = sV0 + (kb % NS) * kTileBytes;
    const int k0 = kb * kTile;

    // S = Q K^T: this warp's 16 rows x 64 keys, eight n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldsm_x4(sK + swz<CH>(jp * 16 + (lane & 7) + (lane >> 4) * 8,
                             2 * kk + ((lane >> 3) & 1)),
                b);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }
    // mask the diagonal and ragged tiles only (masked scores give p = 0
    // exactly); the scale comes in below, in log2 units
    const bool edge = (causal && kb == qb) || k0 + kTile > S;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge && !visible(qrow + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1),
                             S, causal))
          s[j][e] = -INFINITY;
      }

    // online softmax over the tile; rows g (e = 0, 1) and g + 8 (e = 2, 3);
    // the max is taken on the raw scores (the scale is positive)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
      corr[r] = ex2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      oacc[n][0] *= corr[0];
      oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1];
      oacc[n][3] *= corr[1];
    }
    // P in bf16 A fragments: n8 tiles 2kk and 2kk+1 form k16 step kk
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2f(fmaf(s[j][0], scale_log2, -m[0]));
      const float p1 = ex2f(fmaf(s[j][1], scale_log2, -m[0]));
      const float p2 = ex2f(fmaf(s[j][2], scale_log2, -m[1]));
      const float p3 = ex2f(fmaf(s[j][3], scale_log2, -m[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: V (keys x D) read transposed as the col-major B operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < KD; ++np) {
        uint32_t b[4];
        ldsm_x4_t(sV + swz<CH>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                               2 * np + (lane >> 4)),
                  b);
        mma_bf16(oacc[2 * np], pf[kk], b[0], b[1]);
        mma_bf16(oacc[2 * np + 1], pf[kk], b[2], b[3]);
      }
    }
  }

  // epilogue: o = acc * (1 / l_safe) in bf16, staged in this warp's rows
  // of the Q tile (only this warp read them), then 16-byte coalesced stores
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    l_safe[r] = l[r] > 0.f ? l[r] : 1.f;
  }
  // one IEEE division a row: one a value cost ~10 % of the kernel
  const float inv[2] = {1.f / l_safe[0], 1.f / l_safe[1]};
#pragma unroll
  for (int n = 0; n < CH; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off = swz<CH>(warp * 16 + g + 8 * r, n) + 4 * t;
      *reinterpret_cast<uint32_t*>(tc_smem + off) =
          pack_bf16(oacc[n][2 * r] * inv[r], oacc[n][2 * r + 1] * inv[r]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int r = (lane + 32 * i) / CH, c = (lane + 32 * i) % CH;
    const int row = q0 + warp * 16 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(o + base + (size_t)row * D + c * 8) =
          *reinterpret_cast<const uint4*>(tc_smem +
                                          swz<CH>(warp * 16 + r, c));
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      if (row < S)
        lse[(size_t)blockIdx.y * S + row] =
            l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on the tensor cores
// ---------------------------------------------------------------------------

// 4-byte copy; src-size 0 zero-fills without reading
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

// Issue the copies of lse[r0, r0 + 64) and delta[r0, r0 + 64) of one row
// of (BH, S) into two float rows of shared memory; entries past S are
// zero.  One float a thread (4-byte copies: a row of (BH, S) is 16-byte
// aligned only when S is a multiple of 4).
__device__ __forceinline__ void stage_rows(uint32_t dst_lse,
                                           uint32_t dst_delta,
                                           const float* lse_row,
                                           const float* delta_row, int r0,
                                           int S) {
  static_assert(kTcThreads == 2 * kTile, "one thread per copied float");
  const int r = threadIdx.x & (kTile - 1);
  const bool first = threadIdx.x < kTile;
  const bool ok = r0 + r < S;
  cp_async4((first ? dst_lse : dst_delta) + 4 * r,
            (first ? lse_row : delta_row) + (ok ? r0 + r : 0), ok);
}

// A fragments of rows [16 * warp, 16 * warp + 16) of a swizzled tile, k16
// step kk
template <int CH>
__device__ __forceinline__ void ldsm_a(uint32_t tile, int warp, int lane,
                                       int kk, uint32_t (&a)[4]) {
  ldsm_x4(tile + swz<CH>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                         2 * kk + (lane >> 4)),
          a);
}

// acc[8][4] += A (16 x D) * T^T over a 64-row tile T (its rows are the n
// index), T read as the col-major B operand by plain ldmatrix.  A is the
// fragments af (kRegA) or this warp's rows of the tile at sA.
template <int D, bool kRegA>
__device__ __forceinline__ void mma_rows_by_tile(
    float (&acc)[8][4], const uint32_t (&af)[D / 16][4], uint32_t sA,
    uint32_t sT, int warp, int lane) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (kRegA) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = af[kk][e];
    } else {
      ldsm_a<CH>(sA, warp, lane, kk, a);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4(sT + swz<CH>(jp * 16 + (lane & 7) + (lane >> 4) * 8,
                           2 * kk + ((lane >> 3) & 1)),
              b);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc[D/8][4] += A (16 x 64, bf16 fragments) * T over a 64-row tile T
// (its rows are the k index), T read as the col-major B operand by
// ldmatrix.trans
template <int D>
__device__ __forceinline__ void mma_frags_by_tile(float (&acc)[D / 8][4],
                                                  const uint32_t (&f)[4][4],
                                                  uint32_t sT, int lane) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(sT + swz<CH>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                             2 * np + (lane >> 4)),
                b);
      mma_bf16(acc[2 * np], f[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], f[kk], b[2], b[3]);
    }
  }
}

// Two adjacent n8 accumulator tiles 2kk, 2kk + 1 of a 16 x 64 float32
// block, rounded to bf16, are the k16 A fragment kk of the next product.
__device__ __forceinline__ void pack_frags(const float (&x)[8][4],
                                           uint32_t (&f)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j >> 1][(j & 1) * 2] = pack_bf16(x[j][0], x[j][1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[j][2], x[j][3]);
  }
}

// Write a warp's 16 x D float32 accumulators as bf16 into its rows of a
// swizzled tile, then copy those rows to out[r0 + 16 * warp + r] (rows
// below S) with 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[D / 8][4],
                                                unsigned char* tile,
                                                __nv_bfloat16* out, int r0,
                                                int S, int warp, int lane) {
  constexpr int CH = D / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < CH; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off = swz<CH>(warp * 16 + g + 8 * r, n) + 4 * t;
      *reinterpret_cast<uint32_t*>(tile + off) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int r = (lane + 32 * i) / CH, c = (lane + 32 * i) % CH;
    const int row = r0 + warp * 16 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(out + (size_t)row * D + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<CH>(warp * 16 + r, c));
  }
}

// Stages of the backward rings (Q, dO and their two float rows for dK/dV;
// K and V for dQ): 3 at D <= 64, so that a ring and the tiles a block
// keeps fit 3 blocks an SM; 2 at D = 128.
template <int D>
__host__ __device__ constexpr int bwd_tc_stages() {
  return D <= 64 ? 3 : 2;
}

template <int D>
constexpr size_t dkv_tc_smem() {   // K, V, then Q and dO per stage, rows
  return (size_t)(2 + 2 * bwd_tc_stages<D>()) * kTile * D *
             sizeof(__nv_bfloat16) +
         (size_t)2 * bwd_tc_stages<D>() * kTile * sizeof(float);
}

template <int D>
constexpr size_t dq_tc_smem() {   // Q, dO, then K and V per stage
  return (size_t)(2 + 2 * bwd_tc_stages<D>()) * kTile * D *
         sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int S, float scale,
                        float scale_log2, int causal) {
  constexpr int CH = D / 8;    // 16-byte chunks of a row; n8 tiles of dK
  constexpr int KD = D / 16;   // k16 steps of K Q^T
  constexpr int NS = bwd_tc_stages<D>();
  constexpr bool kRegKV = D <= 64;
  constexpr uint32_t kTileBytes = kTile * D * sizeof(__nv_bfloat16);
  constexpr uint32_t kRowBytes = kTile * sizeof(float);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sK = smem_u32(tc_smem);
  const uint32_t sV = sK + kTileBytes;
  const uint32_t sQ0 = sV + kTileBytes;          // NS Q tiles
  const uint32_t sO0 = sQ0 + NS * kTileBytes;    // NS dO tiles
  const uint32_t sL0 = sO0 + NS * kTileBytes;    // NS lse rows
  const uint32_t sD0 = sL0 + NS * kRowBytes;     // NS delta rows
  const float* rows = reinterpret_cast<const float*>(
      tc_smem + (2 + 2 * NS) * kTileBytes);      // sL0, then sD0

  const int kb = blockIdx.x;   // K tile 0 (the most Q tiles) first
  const int k0 = kb * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const float* lse_row = lse + (size_t)blockIdx.y * S;
  const float* delta_row = delta + (size_t)blockIdx.y * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int krow = k0 + warp * 16 + (lane >> 2);   // keys krow, krow + 8

  const int nq = (S + kTile - 1) / kTile;
  const int qb0 = causal ? kb : 0;   // Q tiles before the diagonal see none
  const int n_it = nq - qb0;

  // copy group i holds the Q-side tiles of step i (group 0 also K and V);
  // a group is committed every step, empty past the last tile
  stage_tile_bf16<D>(sK, k + base, k0, S);
  stage_tile_bf16<D>(sV, v + base, k0, S);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_it) {
      const int r0 = (qb0 + i) * kTile;
      stage_tile_bf16<D>(sQ0 + i * kTileBytes, q + base, r0, S);
      stage_tile_bf16<D>(sO0 + i * kTileBytes, dout + base, r0, S);
      stage_rows(sL0 + i * kRowBytes, sD0 + i * kRowBytes, lse_row,
                 delta_row, r0, S);
    }
    cp_async_commit();
  }

  uint32_t kf[KD][4], vf[KD][4];
  float dka[CH][4], dva[CH][4];
#pragma unroll
  for (int n = 0; n < CH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<NS - 2>();
    __syncthreads();   // step it's tiles have landed; step it-1's are free
    if constexpr (kRegKV) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_a<CH>(sK, warp, lane, kk, kf[kk]);
          ldsm_a<CH>(sV, warp, lane, kk, vf[kk]);
        }
      }
    }
    {   // refill the stage step it-1 used with step it + NS - 1
      const int nt = it + NS - 1;
      if (nt < n_it) {
        const int st = nt % NS, r0 = (qb0 + nt) * kTile;
        stage_tile_bf16<D>(sQ0 + st * kTileBytes, q + base, r0, S);
        stage_tile_bf16<D>(sO0 + st * kTileBytes, dout + base, r0, S);
        stage_rows(sL0 + st * kRowBytes, sD0 + st * kRowBytes, lse_row,
                   delta_row, r0, S);
      }
      cp_async_commit();
    }
    const int st = it % NS;
    const uint32_t sQ = sQ0 + st * kTileBytes;
    const uint32_t sO = sO0 + st * kTileBytes;
    const float* sL = rows + st * kTile;
    const float* sDl = rows + (NS + st) * kTile;
    const int qb = qb0 + it;
    const int q0 = qb * kTile;

    // S^T = K Q^T: this warp's 16 keys x 64 queries, eight n8 tiles
    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
    mma_rows_by_tile<D, kRegKV>(p, kf, sK, sQ, warp, lane);

    // P^T = 2^(s*scale*log2(e) - lse*log2(e)), lse by column (query);
    // masked entries (diagonal and ragged tiles only) are 0
    const bool edge = (causal && qb == kb) || q0 + kTile > S ||
                      k0 + kTile > S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lc = (e & 1) ? l2.y : l2.x;
        float x = ex2f(fmaf(p[j][e], scale_log2, -lc * kLog2e));
        if (edge && !visible(q0 + j * 8 + 2 * t + (e & 1),
                             krow + (e >> 1) * 8, S, causal))
          x = 0.f;
        p[j][e] = x;
      }
    }
    uint32_t pf[4][4];
    pack_frags(p, pf);
    // dV += P^T dO: dO (queries x D) read transposed
    mma_frags_by_tile<D>(dva, pf, sO, lane);

    // dP^T = V dO^T
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
    mma_rows_by_tile<D, kRegKV>(dp, vf, sV, sO, warp, lane);

    // dS^T = P^T (dP^T - delta) * scale, delta by column; dK += dS^T Q
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(sDl + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = p[j][e] * (dp[j][e] - ((e & 1) ? d2.y : d2.x)) * scale;
    }
    pack_frags(dp, pf);
    mma_frags_by_tile<D>(dka, pf, sQ, lane);
  }

  // epilogue: each warp read only its own 16 rows of K and V, so it
  // stages its dK and dV rows there
  cp_async_wait<0>();
  store_rows_bf16<D>(dka, tc_smem, dk + base, k0, S, warp, lane);
  store_rows_bf16<D>(dva, tc_smem + kTileBytes, dv + base, k0, S, warp,
                     lane);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 3 : 1)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int S, float scale,
                       float scale_log2, int causal) {
  constexpr int CH = D / 8;
  constexpr int KD = D / 16;
  constexpr int NS = bwd_tc_stages<D>();
  constexpr uint32_t kTileBytes = kTile * D * sizeof(__nv_bfloat16);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_u32(tc_smem);
  const uint32_t sO = sQ + kTileBytes;
  const uint32_t sK0 = sO + kTileBytes;          // NS K tiles
  const uint32_t sV0 = sK0 + NS * kTileBytes;    // NS V tiles

  // the last (under causal the heaviest) Q tile of each head first, as in
  // the forward
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int qrow = q0 + warp * 16 + (lane >> 2);   // rows qrow, qrow + 8

  const int nk = (S + kTile - 1) / kTile;
  const int nk_eff = causal ? min(nk, qb + 1) : nk;

  stage_tile_bf16<D>(sQ, q + base, q0, S);
  stage_tile_bf16<D>(sO, dout + base, q0, S);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nk_eff) {
      stage_tile_bf16<D>(sK0 + i * kTileBytes, k + base, i * kTile, S);
      stage_tile_bf16<D>(sV0 + i * kTileBytes, v + base, i * kTile, S);
    }
    cp_async_commit();
  }
  // lse in log2 units and delta of the thread's two rows (0 past S)
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    const size_t at = (size_t)blockIdx.y * S + row;
    lr[r] = row < S ? lse[at] * kLog2e : 0.f;
    dr[r] = row < S ? delta[at] : 0.f;
  }

  uint32_t qf[KD][4], of[KD][4];
  float dqa[CH][4];
#pragma unroll
  for (int n = 0; n < CH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int kb = 0; kb < nk_eff; ++kb) {
    cp_async_wait<NS - 2>();
    __syncthreads();   // tile kb has landed; tile kb-1's stage is free
    if (kb == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldsm_a<CH>(sQ, warp, lane, kk, qf[kk]);
        ldsm_a<CH>(sO, warp, lane, kk, of[kk]);
      }
    }
    {   // refill the stage tile kb-1 used with tile kb + NS - 1
      const int nt = kb + NS - 1;
      if (nt < nk_eff) {
        const uint32_t off = (nt % NS) * kTileBytes;
        stage_tile_bf16<D>(sK0 + off, k + base, nt * kTile, S);
        stage_tile_bf16<D>(sV0 + off, v + base, nt * kTile, S);
      }
      cp_async_commit();
    }
    const uint32_t sK = sK0 + (kb % NS) * kTileBytes;
    const uint32_t sV = sV0 + (kb % NS) * kTileBytes;
    const int k0 = kb * kTile;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows_by_tile<D, true>(s, qf, sQ, sK, warp, lane);
    mma_rows_by_tile<D, true>(dp, of, sO, sV, warp, lane);

    // dS = p (dP - delta) * scale, p = 2^(s*scale*log2(e) - lse*log2(e));
    // masked entries (diagonal and ragged tiles only) are 0
    const bool edge = (causal && kb == qb) || k0 + kTile > S ||
                      q0 + kTile > S;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = ex2f(fmaf(s[j][e], scale_log2, -lr[r]));
        if (edge && !visible(qrow + 8 * r, k0 + j * 8 + 2 * t + (e & 1), S,
                             causal))
          x = 0.f;
        dp[j][e] = x * (dp[j][e] - dr[r]) * scale;
      }
    uint32_t df[4][4];
    pack_frags(dp, df);
    // dQ += dS K: K (keys x D) read transposed
    mma_frags_by_tile<D>(dqa, df, sK, lane);
  }

  // epilogue: each warp read only its own rows of the Q tile
  cp_async_wait<0>();
  store_rows_bf16<D>(dqa, tc_smem, dq + base, q0, S, warp, lane);
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

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int S, float scale, int causal,
                  cudaStream_t stream) {
  constexpr size_t smem = fwd_tc_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  flash_fwd_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, S, scale * kLog2e,
      causal);
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

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int bh, int S, float scale, int causal,
                  cudaStream_t stream) {
  constexpr size_t smem = dkv_tc_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  flash_bwd_dkv_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, scale, scale * kLog2e,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int bh, int S, float scale, int causal,
                 cudaStream_t stream) {
  constexpr size_t smem = dq_tc_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  flash_bwd_dq_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, delta,
      (__nv_bfloat16*)dq, S, scale, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Dispatch on D in {16, 32, 64, 128} for the bf16 tensor-core kernels.
#define SLT_DISPATCH_TC(DIM, CALL)                                         \
  do {                                                                     \
    switch (DIM) {                                                         \
      case 16: { constexpr int D = 16; return CALL; }                      \
      case 32: { constexpr int D = 32; return CALL; }                      \
      case 64: { constexpr int D = 64; return CALL; }                      \
      case 128: { constexpr int D = 128; return CALL; }                    \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

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

// The bf16 tensor-core forward: D in {16, 32, 64, 128}; q, k, v and o
// 16-byte aligned.  Anything else returns an error without launching.
int slt_flash_fwd_tc(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int s, int d, float scale,
                     int causal, void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
    return (int)cudaErrorMisalignedAddress;
  SLT_DISPATCH_TC(d, (launch_fwd_tc<D>(q, k, v, o, (float*)lse, bh, s, scale,
                                       causal, (cudaStream_t)stream)));
}

// The CUDA-core backward: float32 at any D, bfloat16 at D = 8 on the
// main paths (every D is built).
int slt_flash_bwd_dkv_simt(int dtype, const void* q, const void* k,
                           const void* v, const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int s, int d, float scale, int causal,
                           void* stream) {
  SLT_DISPATCH(dtype, d,
               (launch_dkv<T, D>(q, k, v, dout, (const float*)lse,
                                 (const float*)delta, dk, dv, bh, s, scale,
                                 causal, (cudaStream_t)stream)));
}

int slt_flash_bwd_dq_simt(int dtype, const void* q, const void* k,
                          const void* v, const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int s, int d,
                          float scale, int causal, void* stream) {
  SLT_DISPATCH(dtype, d,
               (launch_dq<T, D>(q, k, v, dout, (const float*)lse,
                                (const float*)delta, dq, bh, s, scale, causal,
                                (cudaStream_t)stream)));
}

// The bf16 tensor-core backward: D in {16, 32, 64, 128}; q, k, v, dout
// and the outputs 16-byte aligned, lse and delta 4-byte aligned.  Anything
// else returns an error without launching.
int slt_flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int bh, int s, int d,
                         float scale, int causal, void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)dk | (uintptr_t)dv) & 15 ||
      ((uintptr_t)lse | (uintptr_t)delta) & 3)
    return (int)cudaErrorMisalignedAddress;
  SLT_DISPATCH_TC(d, (launch_dkv_tc<D>(q, k, v, dout, (const float*)lse,
                                       (const float*)delta, dk, dv, bh, s,
                                       scale, causal, (cudaStream_t)stream)));
}

int slt_flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int bh, int s, int d, float scale,
                        int causal, void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)dq) & 15 ||
      ((uintptr_t)lse | (uintptr_t)delta) & 3)
    return (int)cudaErrorMisalignedAddress;
  SLT_DISPATCH_TC(d, (launch_dq_tc<D>(q, k, v, dout, (const float*)lse,
                                      (const float*)delta, dq, bh, s, scale,
                                      causal, (cudaStream_t)stream)));
}

}  // extern "C"
