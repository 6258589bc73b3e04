// Tiled absmax quantize / dequantize for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of the JAX package's
// split_learning_tpu/ops/kernels/quant.py:
//
//   quantize_kernel          <- _quantize_kernel (:37, via quantize_tiles :57)
//   quantize_generic_kernel  <- the same, for the shapes the first refuses
//   dequantize_kernel        <- _dequantize_kernel
//                               (:92, via dequantize_tiles :105)
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
// --use_fast_math), round half to even, and a non-finite test apart
// from the float absmax, because fmaxf drops a NaN where the oracle's
// max propagates it.
//
// Bound at the slice's shapes (one activation or gradient frame of
// 8 x 256 x 2048 = 4.19 M values, tile 256) on an H100 SXM (3.35 TB/s):
// both kernels are bound by memory.  quantize reads 8.4 MB (bf16) and
// writes 4.2 MB of codes and 64 KB of scales: ~12.6 MB, ~3.8 us;
// dequantize reads 4.2 MB of codes and writes 16.8 MB of float32:
// ~21 MB, ~6.3 us.  The arithmetic is not negligible beside that: the
// IEEE division is ~10 instructions a value, ~3 us of instruction slots on the
// card's 132 SMs for one frame, so it has to hide under the memory time.
//
// Designs:
//   * quantize_kernel (the "vec" route: a tile of 512, 1024, 2048 or
//     4096 bytes, at most 1024 values, from a 16-byte aligned leaf) —
//     one warp per tile, held in registers.  Lane l loads the 16-byte
//     chunks l, l + 32, ... of the tile (read-only loads; each warp load
//     instruction reads 512 contiguous bytes), so the tile is read from
//     device memory once and never again.  The absmax reduces over the
//     magnitudes' bit patterns as unsigned integers — they order as the
//     magnitudes do, and NaN and inf sort above every finite value, so
//     the non-finite flag is "max >= inf's bits" and no NaN is dropped —
//     by a __shfl_xor_sync butterfly, after which every lane holds the
//     scale: no shared memory, no barrier.  Codes come from the
//     registers, a chunk's codes in one store (8 bytes a lane for bf16
//     int8, 4 for bf16 int4).  Blocks are persistent (the SM count times
//     the blocks an SM holds); each warp walks tiles grid-stride and
//     sends the next tile's loads out before it reduces the current one.
//     The ragged last tile is masked in the same kernel (zeros past n).
//     Indices are 32-bit when the padded code array allows it.
//   * quantize_generic_kernel (every other tile width, or a leaf off
//     16-byte alignment): one block of 8 warps owns 8 consecutive tiles
//     (an even count, so code pairs never cross a block).  Phase 1: one
//     warp per tile reads the leaf in its own dtype with scalar loads,
//     masking the ragged tail, and reduces the absmax and the non-finite
//     flag with warp shuffles; lane 0 writes the scale.  Phase 2: the
//     block's threads write the codes (int8) or the packed bytes (int4),
//     reading the values again from L1/L2, where phase 1 left them.
//   * dequantize_kernel: a grid-stride loop, four consecutive codes a
//     thread (one index division for the four, one 16-byte store).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

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
quantize_generic_kernel(const T* __restrict__ x, long long n, int tile,
                        long long t_count, int8_t* __restrict__ codes8,
                        uint8_t* __restrict__ codes4,
                        float* __restrict__ scales) {
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
int launch_quantize_generic(const void* x, long long n, int tile,
                            long long t_count, int bits, void* codes,
                            float* scales, cudaStream_t stream) {
  const long long blocks = (t_count + kTilesPerBlock - 1) / kTilesPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (bits == 8) {
    quantize_generic_kernel<T, 8><<<(unsigned)blocks, kThreads, 0,
                                    stream>>>(
        (const T*)x, n, tile, t_count, (int8_t*)codes, nullptr, scales);
  } else {
    quantize_generic_kernel<T, 4><<<(unsigned)blocks, kThreads, 0,
                                    stream>>>(
        (const T*)x, n, tile, t_count, nullptr, (uint8_t*)codes, scales);
  }
  return (int)cudaGetLastError();
}

// ---- the vec route: one warp per tile, the tile held in registers ----

constexpr int kVecThreads = 256;
constexpr int kChunk = 16;   // bytes a lane loads at once

// By dtype: the running max of a 32-bit word's magnitude bits (sign
// cleared; two values a word for 16-bit types), the least magnitude bits
// of a non-finite value (inf's), and a value's bits as a float.
template <typename T> struct Magnitude;
template <> struct Magnitude<float> {
  static constexpr uint32_t kInf = 0x7f800000u;
  static __device__ __forceinline__ uint32_t max_of(uint32_t w,
                                                    uint32_t m) {
    return max(m, w & 0x7fffffffu);
  }
  static __device__ __forceinline__ float to_float(uint32_t bits) {
    return __uint_as_float(bits);
  }
};
template <> struct Magnitude<__nv_bfloat16> {
  static constexpr uint32_t kInf = 0x7f80u;
  static __device__ __forceinline__ uint32_t max_of(uint32_t w,
                                                    uint32_t m) {
    return max(m, max(w & 0x7fffu, (w >> 16) & 0x7fffu));
  }
  static __device__ __forceinline__ float to_float(uint32_t bits) {
    return __uint_as_float(bits << 16);
  }
};
template <> struct Magnitude<__half> {
  static constexpr uint32_t kInf = 0x7c00u;
  static __device__ __forceinline__ uint32_t max_of(uint32_t w,
                                                    uint32_t m) {
    return max(m, max(w & 0x7fffu, (w >> 16) & 0x7fffu));
  }
  static __device__ __forceinline__ float to_float(uint32_t bits) {
    return __half2float(__ushort_as_half((unsigned short)bits));
  }
};

// Value j of a 16-byte chunk held as four 32-bit words.
template <typename T>
__device__ __forceinline__ float chunk_value(const uint32_t (&w)[4],
                                             int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[j]);
  } else {
    const uint32_t word = w[j >> 1];
    return Magnitude<T>::to_float((j & 1) ? word >> 16 : word & 0xffffu);
  }
}

// The 16-byte chunk of the leaf at element e: one read-only vector load,
// or, for the chunk that holds the leaf's end, element loads with zeros
// past n.
template <typename T, typename IDX>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x, IDX e,
                                           IDX n, uint32_t (&w)[4]) {
  constexpr int kPer = kChunk / sizeof(T);
  if (e + kPer <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + e));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = 0u;
  if constexpr (sizeof(T) == 4) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(x);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < n) w[j] = p[e + j];
  } else {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(x);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (e + j < n) w[j >> 1] |= (uint32_t)p[e + j] << (16 * (j & 1));
  }
}

// The tile starting at element `base`, lane's share: chunk k is the
// 16 bytes at base + (k * 32 + lane) * kPer, so each warp load
// instruction reads 512 contiguous bytes.
template <typename T, int C, typename IDX>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, IDX base,
                                          IDX n, int lane,
                                          uint32_t (&w)[C][4]) {
  constexpr int kPer = kChunk / sizeof(T);
#pragma unroll
  for (int k = 0; k < C; ++k)
    load_chunk<T, IDX>(x, base + (IDX)((k * 32 + lane) * kPer), n, w[k]);
}

// The codes of one 16-byte chunk, packed as the code array holds them
// (int8: a byte each; int4: nibbles, low first), in out[0..1].  SAFE is
// the oracle's formula as the generic kernel has it (code_of: a NaN
// quotient gives 0, +-inf clips); it is needed only for a zero scale (a
// float32 tile whose absmax / qmax underflows to 0).  Otherwise the
// quotient of a finite value by a finite positive scale is finite and
// at most ~128 in magnitude, and the conversion's round-to-nearest-even
// is rint's.
template <typename T, int BITS, bool SAFE>
__device__ __forceinline__ void chunk_codes(const uint32_t (&w)[4],
                                            float scale, uint32_t (&out)[2]) {
  constexpr int kPer = kChunk / sizeof(T);
  constexpr int qmax = BITS == 8 ? 127 : 7;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float v = chunk_value<T>(w, j);
    const uint32_t c = (uint32_t)(
        SAFE ? code_of(v, scale, (float)qmax)
             : min(max(__float2int_rn(__fdiv_rn(v, scale)), -qmax), qmax));
    if constexpr (BITS == 8) {
      out[j >> 2] |= (c & 0xffu) << (8 * (j & 3));
    } else {   // low nibble first
      out[j >> 3] |= (c & 0xfu) << (4 * (j & 7));
    }
  }
}

template <typename T, int C, int BITS, typename IDX>
__global__ void __launch_bounds__(kVecThreads)
quantize_kernel(const T* __restrict__ x, IDX n, IDX t_count,
                uint8_t* __restrict__ codes, float* __restrict__ scales) {
  constexpr int kPer = kChunk / sizeof(T);   // values a chunk
  constexpr int kTile = 32 * C * kPer;
  constexpr int kBytes = BITS == 8 ? kPer : kPer / 2;   // codes a chunk
  const int lane = threadIdx.x & 31;
  const IDX warps = (IDX)gridDim.x * (kVecThreads / 32);
  IDX t = (IDX)blockIdx.x * (kVecThreads / 32) + (IDX)(threadIdx.x >> 5);
  if (t >= t_count) return;   // uniform across the warp

  uint32_t cur[C][4], nxt[C][4];
  load_tile<T, C, IDX>(x, t * kTile, n, lane, cur);
  while (true) {
    const IDX t_next = t + warps;
    if (t_next < t_count)   // the next tile's loads go out first
      load_tile<T, C, IDX>(x, t_next * kTile, n, lane, nxt);

    uint32_t m = 0u;
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) m = Magnitude<T>::max_of(cur[k][j], m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    const bool bad = m >= Magnitude<T>::kInf;   // a NaN or an inf
    float scale;
    if (bad) {
      scale = __int_as_float(0x7fc00000);   // NaN sentinel, codes 0
    } else if (m != 0u) {
      scale = __fdiv_rn(Magnitude<T>::to_float(m), BITS == 8 ? 127.0f : 7.0f);
    } else {
      scale = 1.0f;
    }
    if (lane == 0) scales[t] = scale;

#pragma unroll
    for (int k = 0; k < C; ++k) {
      uint32_t out[2] = {0u, 0u};   // kBytes <= 8 bytes of codes
      if (bad) {
        // codes 0
      } else if (scale != 0.0f) {
        chunk_codes<T, BITS, false>(cur[k], scale, out);
      } else {
        chunk_codes<T, BITS, true>(cur[k], scale, out);
      }
      const IDX e = t * kTile + (IDX)((k * 32 + lane) * kPer);
      uint8_t* dst = codes + (BITS == 8 ? e : e / 2);
      if constexpr (kBytes == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
      } else if constexpr (kBytes == 4) {
        *reinterpret_cast<uint32_t*>(dst) = out[0];
      } else {
        *reinterpret_cast<uint16_t*>(dst) = (uint16_t)out[0];
      }
    }

    if (t_next >= t_count) break;
    t = t_next;
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[k][j] = nxt[k][j];
  }
}

// Persistent grid: as many blocks as the SMs hold at once, no more than
// the tiles need.  The occupancy is asked once per instantiation.
template <typename T, int C, int BITS, typename IDX>
int launch_vec(const void* x, IDX n, IDX t_count, void* codes,
               float* scales, cudaStream_t stream) {
  auto kernel = quantize_kernel<T, C, BITS, IDX>;
  static std::atomic<int> per_sm{0};
  int blocks_per_sm = per_sm.load(std::memory_order_relaxed);
  if (blocks_per_sm == 0) {
    int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, kernel, kVecThreads, 0);
    if (err != 0) return err;
    per_sm.store(blocks_per_sm, std::memory_order_relaxed);
  }
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err != 0) return err;
  const long long need = ((long long)t_count + kVecThreads / 32 - 1) /
                         (kVecThreads / 32);
  const long long fit = (long long)sms * (blocks_per_sm > 0 ? blocks_per_sm
                                                            : 1);
  const long long grid = need < fit ? need : fit;
  kernel<<<(unsigned)grid, kVecThreads, 0, stream>>>(
      (const T*)x, n, t_count, (uint8_t*)codes, scales);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int launch_vec_bits(const void* x, long long n, long long t_count,
                    int bits, void* codes, float* scales,
                    cudaStream_t stream) {
  constexpr long long kTile = 32LL * C * (kChunk / sizeof(T));
  if (t_count * kTile <= 0x7fffffffLL) {
    return bits == 8
        ? launch_vec<T, C, 8, int>(x, (int)n, (int)t_count, codes, scales,
                                   stream)
        : launch_vec<T, C, 4, int>(x, (int)n, (int)t_count, codes, scales,
                                   stream);
  }
  return bits == 8
      ? launch_vec<T, C, 8, long long>(x, n, t_count, codes, scales, stream)
      : launch_vec<T, C, 4, long long>(x, n, t_count, codes, scales,
                                       stream);
}

// chunks: the tile's 16-byte chunks per lane (tile * itemsize / 512).
template <typename T>
int launch_vec_chunks(int chunks, const void* x, long long n,
                      long long t_count, int bits, void* codes,
                      float* scales, cudaStream_t stream) {
  switch (chunks) {
    case 1:
      return launch_vec_bits<T, 1>(x, n, t_count, bits, codes, scales,
                                   stream);
    case 2:
      return launch_vec_bits<T, 2>(x, n, t_count, bits, codes, scales,
                                   stream);
    case 4:
      return launch_vec_bits<T, 4>(x, n, t_count, bits, codes, scales,
                                   stream);
    case 8:
      if constexpr (sizeof(T) == 4)   // tile 1024 of float32
        return launch_vec_bits<T, 8>(x, n, t_count, bits, codes, scales,
                                     stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The widest tile the vec route holds in registers (values).
#define SLT_VEC_MAX_TILE 1024

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  bits: 8 or 4.
// x holds n values; the padded code array has t_count * tile codes
// (t_count * tile / 2 bytes for int4).  Returns a cudaError_t.
//
// The vec route: tile * itemsize must be 512, 1024, 2048 or 4096 bytes
// (one to eight 16-byte chunks a lane), tile at most SLT_VEC_MAX_TILE,
// and x 16-byte aligned; the codes (from torch.empty) are aligned too.
int slt_quantize(int dtype, const void* x, long long n, int tile,
                 long long t_count, int bits, void* codes, void* scales,
                 void* stream) {
  const int item = dtype == 0 ? 4 : 2;
  const int chunks = tile * item / 512;
  if (dtype < 0 || dtype > 2 || tile < 1 || tile > SLT_VEC_MAX_TILE ||
      (tile * item) % 512 || (chunks & (chunks - 1)) || t_count < 1 ||
      (bits != 8 && bits != 4) || n > t_count * (long long)tile ||
      (uintptr_t)x % 16 || (uintptr_t)codes % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* sc = (float*)scales;
  switch (dtype) {
    case 0:
      return launch_vec_chunks<float>(chunks, x, n, t_count, bits, codes,
                                      sc, s);
    case 1:
      return launch_vec_chunks<__nv_bfloat16>(chunks, x, n, t_count, bits,
                                              codes, sc, s);
    default:
      return launch_vec_chunks<__half>(chunks, x, n, t_count, bits, codes,
                                       sc, s);
  }
}

// The generic route: any tile, any alignment; same arguments.
int slt_quantize_generic(int dtype, const void* x, long long n, int tile,
                         long long t_count, int bits, void* codes,
                         void* scales, void* stream) {
  if (tile < 1 || t_count < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && (t_count * tile) % 2) ||
      n > t_count * (long long)tile ||
      (long long)kTilesPerBlock * tile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_quantize_generic<float>(x, n, tile, t_count, bits,
                                            codes, (float*)scales, s);
    case 1:
      return launch_quantize_generic<__nv_bfloat16>(
          x, n, tile, t_count, bits, codes, (float*)scales, s);
    case 2:
      return launch_quantize_generic<__half>(x, n, tile, t_count, bits,
                                             codes, (float*)scales, s);
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
