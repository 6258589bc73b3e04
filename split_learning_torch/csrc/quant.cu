// Tiled absmax quantize / dequantize for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of the JAX package's
// split_learning_tpu/ops/kernels/quant.py:
//
//   quantize_kernel    <- _quantize_kernel    (:37, via quantize_tiles :57)
//   dequantize_kernel  <- _dequantize_kernel  (:92, via dequantize_tiles :105)
//
// The wire codec (runtime/codec/quant.py) cuts a leaf into tiles of
// `tile` values, zero-padded to a whole number of tiles (and, for int4, to
// an even code count: one more tile of zeros when tile is odd).  Per tile:
//   scale = amax / qmax         (qmax 127 for int8, 7 for int4)
//   scale = 1                   when the tile is all zeros
//   scale = NaN, codes = 0      when the tile holds a NaN or an inf
//   code  = clip(round_half_even(x / scale), -qmax, qmax)
// int8 codes are stored one a byte; int4 codes are two's-complement
// nibbles, two a byte, low nibble first, over the FLAT padded code array
// (with an odd tile a byte straddles two tiles).  Dequantize is
// code * scale[tile] in float32.
//
// Numerics are the oracle's bit for bit: true IEEE divisions
// (__fdiv_rn, never a reciprocal; the library is built without
// --use_fast_math), round half to even (rintf), and a separate
// non-finite flag beside the absmax, because fmaxf drops a NaN where the
// oracle's max propagates it.
//
// Design (simple first):
//   * quantize: one block of 8 warps owns 8 consecutive tiles (an even
//     count, so code pairs never cross a block).  Phase 1: one warp per
//     tile reads the leaf in its own dtype (float32, bfloat16 or float16),
//     masking the ragged tail in place of the padding copy, and reduces
//     the absmax and the non-finite flag with warp shuffles; lane 0
//     writes the scale.  Phase 2: the block's threads write the codes
//     (int8) or the packed bytes (int4), reading the values again from
//     L1/L2, where phase 1 just left them.
//   * dequantize: a grid-stride loop, four consecutive codes a thread
//     (one index division for the four, one 16-byte store).
//
// Bound at the slice's shapes (one activation or gradient frame of
// 8 x 256 x 2048 = 4.19 M values, tile 256) on an H100 SXM (3.35 TB/s):
// both kernels are bound by memory.  quantize reads 8.4 MB (bf16) and
// writes 4.2 MB of codes and 64 KB of scales: ~12.6 MB, ~3.8 us;
// dequantize reads 4.2 MB of codes and writes 16.8 MB of float32:
// ~21 MB, ~6.3 us.  The design reads every input byte from device memory
// once (the second read of phase 2 hits L1/L2) and writes every output
// byte once; the arithmetic (one division a value) is far below the
// card's rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTilesPerBlock = 8;   // one warp each; even (int4 pairs)
constexpr int kThreads = 32 * kTilesPerBlock;

__device__ __forceinline__ float load_f32(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* x,
                                          long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ float load_f32(const __half* x, long long i) {
  return __half2float(x[i]);
}

// The value at flat padded position c (zero past the leaf's end).
template <typename T>
__device__ __forceinline__ float value_at(const T* x, long long n,
                                          long long c) {
  return c < n ? load_f32(x, c) : 0.0f;
}

// clip(rint(v / scale), -qmax, qmax); a NaN quotient (non-finite tile:
// NaN scale) gives code 0.  +-inf quotients clip to +-qmax, as jnp.clip.
__device__ __forceinline__ int code_of(float v, float scale, float qmax) {
  float r = rintf(__fdiv_rn(v, scale));
  if (r != r) return 0;
  return (int)fminf(fmaxf(r, -qmax), qmax);
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, long long n, int tile,
                long long t_count, int8_t* __restrict__ codes8,
                uint8_t* __restrict__ codes4, float* __restrict__ scales) {
  __shared__ float s_scale[kTilesPerBlock];
  const float qmax = BITS == 8 ? 127.0f : 7.0f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t0 = (long long)blockIdx.x * kTilesPerBlock;

  // phase 1: per-tile absmax + non-finite flag, one warp per tile
  const long long t = t0 + warp;
  if (t < t_count) {   // uniform across the warp
    const long long base = t * (long long)tile;
    float amax = 0.0f;
    int bad = 0;
#pragma unroll 4
    for (int i = lane; i < tile; i += 32) {
      float v = value_at(x, n, base + i);
      if (isfinite(v)) {
        amax = fmaxf(amax, fabsf(v));
      } else {
        bad = 1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      bad |= __shfl_xor_sync(0xffffffffu, bad, off);
    }
    float scale;
    if (bad) {
      scale = __int_as_float(0x7fc00000);   // NaN sentinel
    } else if (amax > 0.0f) {
      scale = __fdiv_rn(amax, qmax);
    } else {
      scale = 1.0f;
    }
    if (lane == 0) {
      s_scale[warp] = scale;
      scales[t] = scale;
    }
  }
  __syncthreads();

  // phase 2: codes for the block's tiles
  const long long t_end = min(t0 + kTilesPerBlock, t_count);
  const long long c0 = t0 * tile;
  const int count = (int)((t_end - t0) * tile);   // codes in this block
  if (BITS == 8) {
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const long long c = c0 + j;
      codes8[c] = (int8_t)code_of(value_at(x, n, c), s_scale[j / tile],
                                  qmax);
    }
  } else {
    // c0 and count are even: tiles per block is even, and the padded
    // total t_count * tile is even
    for (int j = 2 * threadIdx.x; j < count; j += 2 * kThreads) {
      const long long c = c0 + j;
      const int lo = code_of(value_at(x, n, c), s_scale[j / tile], qmax);
      const int hi = code_of(value_at(x, n, c + 1),
                             s_scale[(j + 1) / tile], qmax);
      codes4[c >> 1] = (uint8_t)((lo & 0xF) | ((hi & 0xF) << 4));
    }
  }
}

// Code c of the flat padded code array, sign-extended.
template <int BITS>
__device__ __forceinline__ int code_at(const uint8_t* codes, long long c) {
  if (BITS == 8) return (int)(int8_t)codes[c];
  const int u = codes[c >> 1];
  const int nib = (c & 1) ? (u >> 4) : (u & 0xF);   // low nibble first
  return nib < 8 ? nib : nib - 16;
}

// Four consecutive codes a thread: one integer division for the four
// (IDX is int whenever the array allows it — a 64-bit division a value
// cost more than the memory traffic), one float4 store.
template <int BITS, typename IDX>
__global__ void __launch_bounds__(256)
dequantize_kernel(const uint8_t* __restrict__ codes,
                  const float* __restrict__ scales, IDX total, int tile,
                  float* __restrict__ out) {
  const IDX groups = total / 4;
  for (IDX g = (IDX)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += (IDX)gridDim.x * blockDim.x) {
    const IDX c = 4 * g;
    IDX t = c / tile;
    int r = (int)(c - t * tile);
    float s = scales[t];
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (r == tile) {
        ++t;
        r = 0;
        s = scales[t];
      }
      o[k] = __fmul_rn((float)code_at<BITS>(codes, c + k), s);
      ++r;
    }
    reinterpret_cast<float4*>(out)[g] = make_float4(o[0], o[1], o[2], o[3]);
  }
  // the last total % 4 codes
  if (blockIdx.x == 0 && threadIdx.x < (unsigned)(total - 4 * groups)) {
    const IDX c = 4 * groups + threadIdx.x;
    out[c] = __fmul_rn((float)code_at<BITS>(codes, c), scales[c / tile]);
  }
}

int grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  const long long cap = 132LL * 16;   // a few waves of the 132 SMs
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

template <typename T>
int launch_quantize(const void* x, long long n, int tile, long long t_count,
                    int bits, void* codes, float* scales,
                    cudaStream_t stream) {
  const long long blocks = (t_count + kTilesPerBlock - 1) / kTilesPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (bits == 8) {
    quantize_kernel<T, 8><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)x, n, tile, t_count, (int8_t*)codes, nullptr, scales);
  } else {
    quantize_kernel<T, 4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)x, n, tile, t_count, nullptr, (uint8_t*)codes, scales);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  bits: 8 or 4.
// x holds n values; the padded code array has t_count * tile codes
// (t_count * tile / 2 bytes for int4).  Returns a cudaError_t.
int slt_quantize(int dtype, const void* x, long long n, int tile,
                 long long t_count, int bits, void* codes, void* scales,
                 void* stream) {
  if (tile < 1 || t_count < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && (t_count * tile) % 2) ||
      n > t_count * (long long)tile ||
      (long long)kTilesPerBlock * tile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_quantize<float>(x, n, tile, t_count, bits, codes,
                                    (float*)scales, s);
    case 1:
      return launch_quantize<__nv_bfloat16>(x, n, tile, t_count, bits,
                                            codes, (float*)scales, s);
    case 2:
      return launch_quantize<__half>(x, n, tile, t_count, bits, codes,
                                     (float*)scales, s);
  }
  return (int)cudaErrorInvalidValue;
}

// codes: t_count * tile int8 codes (bits 8) or t_count * tile / 2 packed
// bytes (bits 4); out: t_count * tile float32.
int slt_dequantize(const void* codes, const void* scales, long long t_count,
                   int tile, int bits, void* out, void* stream) {
  if (tile < 1 || t_count < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && (t_count * tile) % 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = t_count * (long long)tile;
  const int grid = grid_for(total / 4 + 1, 256);
  const uint8_t* q = (const uint8_t*)codes;
  const float* sc = (const float*)scales;
  float* o = (float*)out;
  if (total <= 0x7fffffffLL) {
    if (bits == 8) {
      dequantize_kernel<8, int><<<grid, 256, 0, s>>>(q, sc, (int)total,
                                                     tile, o);
    } else {
      dequantize_kernel<4, int><<<grid, 256, 0, s>>>(q, sc, (int)total,
                                                     tile, o);
    }
  } else if (bits == 8) {
    dequantize_kernel<8, long long><<<grid, 256, 0, s>>>(q, sc, total,
                                                         tile, o);
  } else {
    dequantize_kernel<4, long long><<<grid, 256, 0, s>>>(q, sc, total,
                                                         tile, o);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
