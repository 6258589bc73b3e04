// Tiled absmax quantize / dequantize for Hopper (sm_90a), CUDA C++.
//
// Replaces the two Pallas TPU kernels of the JAX package's
// split_learning_tpu/ops/kernels/quant.py:
//
//   quantize_kernel            <- _quantize_kernel
//                                 (:37, via quantize_tiles :57)
//   quantize_generic_kernel    <- the same, for the shapes the first refuses
//   dequantize_kernel          <- _dequantize_kernel
//                                 (:92, via dequantize_tiles :105)
//   dequantize_generic_kernel  <- the same, for the shapes the first refuses
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
//     16-byte alignment; the wire-slow codec's tile 64 on bf16 and
//     float32 frames): a block owns a span of whole tiles (pairs at an
//     odd int4 tile, so that no code byte straddles two blocks) of 2-4
//     KB, sized so that a frame spreads over the card (a tile up to
//     kSpanBytes wide, one tile or pair), and
//     stages it in shared memory with 16-byte cp.async copies from the
//     16-byte aligned address at or below its first value (bytes past
//     the leaf's end arrive as zeros): every tile and every alignment
//     take the same loads, and the leaf is read once.  A thread takes 8
//     values of the span (16 bytes, 32 of float32), realigned by funnel
//     shifts from conflict-free 16-byte shared loads; the absmax reduces
//     over the magnitudes' bits (as in the vec kernel: no per-value
//     branch, no NaN dropped) by a shuffle scan over the lanes whose
//     values end in the same tile and a shared atomicMax a tile; a
//     value's tile comes from one division a thread and a compare a
//     value.  The codes (the saturating conversion of the IEEE quotient)
//     are packed 8 to a thread in registers, restaged in shared memory
//     in the layout of the code array and leave by 16-byte stores at the
//     aligned addresses the span covers whole (512 contiguous bytes a
//     warp store), bytes at its unaligned ends.  A tile wider than
//     kSpanBytes (16384 bf16 or fp16 values, 8192 float32) takes one
//     block (a pair at an odd int4 tile) and windows of kSpanBytes, read
//     once to reduce and again from L2 to code: the only case that reads
//     the leaf twice.
//   * dequantize_kernel (the "vec" route: a tile of whole 16-byte code
//     chunks -- tile % 16 == 0 for int8, tile % 32 == 0 for int4 -- from
//     16-byte aligned codes).  A warp takes 32 chunks at a time, lane l
//     chunk l by one read-only 16-byte load (16 int8 or 32 int4 codes),
//     two such groups a thread in flight before any is used; the grid
//     covers the card once (its occupancy asked once) and strides beyond
//     it, so at the main paths' frames (0.5-4.2 M codes) every load of a
//     frame goes out at once.  The chunks pass through the warp's slice
//     of shared memory (one 16-byte store a lane, then 4-byte or 2-byte
//     reads, no bank conflicts), so that each of a lane's 4 (int8) or 8
//     (int4) 16-byte stores is part of 512 contiguous bytes a warp: the
//     same kernel storing each chunk's 64 or 128 bytes from its own lane
//     (16-byte stores 64 or 128 bytes apart) was 1.2-4x slower than the
//     generic kernel on an H100.  A float4's scale is found by one shift
//     (a power-of-two tile) or one division; codes are widened by
//     sign-extending shifts and multiplied with __fmul_rn; stores keep
//     default caching (the consumer reads the output next).  Bound by
//     bytes (codes and scales in, float32 out: 2.6 MB for VGG's 0.5 M-code
//     frame, 0.78 us at 3.35 TB/s), which at such a frame is below a
//     launch and a load round trip: it is read beside the time of a fill
//     that writes the same float32 bytes and reads nothing.
//   * dequantize_generic_kernel (any tile, codes at any alignment):
//     the vec kernel's design, with each 16-byte chunk of the codes
//     realigned by funnel shifts from the aligned chunk at or below it
//     and the next one (taken from the neighbouring lane), one division a
//     float4 for its tile, and the scales of a float4 that straddles
//     tiles loaded beside the chunks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// clip(rint(v / scale), -qmax, qmax); a NaN quotient (non-finite tile:
// NaN scale) gives code 0.  +-inf quotients clip to +-qmax, as jnp.clip.
__device__ __forceinline__ int code_of(float v, float scale, float qmax) {
  float r = rintf(__fdiv_rn(v, scale));
  if (r != r) return 0;
  return (int)fminf(fmaxf(r, -qmax), qmax);
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

// A tile's scale from its absmax bits: the NaN sentinel for a
// non-finite tile, 1 for an all-zero one.
template <typename T, int BITS>
__device__ __forceinline__ float scale_of(uint32_t m) {
  if (m >= Magnitude<T>::kInf) return __int_as_float(0x7fc00000);
  if (m == 0u) return 1.0f;
  return __fdiv_rn(Magnitude<T>::to_float(m), BITS == 8 ? 127.0f : 7.0f);
}

// Value j of 16-byte chunks held as 32-bit words.
template <typename T, int N>
__device__ __forceinline__ float chunk_value(const uint32_t (&w)[N],
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
    const float scale = scale_of<T, BITS>(m);
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

// The SMs of the current device.
int sm_count(int* sms) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  return err;
}

// Blocks of `threads` that cover the card once, no more than `need`:
// the kernel's occupancy is asked once per instantiation (per_sm).
template <typename Kernel>
int covering_grid(Kernel kernel, int threads, long long need,
                  std::atomic<int>& per_sm, long long* grid) {
  int blocks_per_sm = per_sm.load(std::memory_order_relaxed);
  if (blocks_per_sm == 0) {
    int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, kernel, threads, 0);
    if (err != 0) return err;
    per_sm.store(blocks_per_sm, std::memory_order_relaxed);
  }
  int sms = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  const long long fit = (long long)sms * (blocks_per_sm > 0 ? blocks_per_sm
                                                            : 1);
  *grid = need < fit ? need : fit;
  return 0;
}

// Persistent grid: as many blocks as the SMs hold at once, no more than
// the tiles need.
template <typename T, int C, int BITS, typename IDX>
int launch_vec(const void* x, IDX n, IDX t_count, void* codes,
               float* scales, cudaStream_t stream) {
  auto kernel = quantize_kernel<T, C, BITS, IDX>;
  static std::atomic<int> per_sm{0};
  long long grid = 0;
  const int err = covering_grid(
      kernel, kVecThreads,
      ((long long)t_count + kVecThreads / 32 - 1) / (kVecThreads / 32),
      per_sm, &grid);
  if (err != 0) return err;
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

// ---- the dequantizer's vec route: whole 16-byte code chunks a lane ----

constexpr int kDeqThreads = 256;
constexpr int kDeqInFlight = 2;   // chunks a lane loads before it stores

// The four int8 codes of word w (low byte first), sign-extended by
// shifts, times s
__device__ __forceinline__ float4 widen_int8(uint32_t w, float s) {
  return make_float4(__fmul_rn((float)((int32_t)(w << 24) >> 24), s),
                     __fmul_rn((float)((int32_t)(w << 16) >> 24), s),
                     __fmul_rn((float)((int32_t)(w << 8) >> 24), s),
                     __fmul_rn((float)((int32_t)w >> 24), s));
}
// The four int4 codes of halfword h (low nibble first, two's
// complement), sign-extended by shifts, times s
__device__ __forceinline__ float4 widen_int4(uint32_t h, float s) {
  const uint32_t x = h << 16;   // the four nibbles on top
  return make_float4(__fmul_rn((float)((int32_t)(x << 12) >> 28), s),
                     __fmul_rn((float)((int32_t)(x << 8) >> 28), s),
                     __fmul_rn((float)((int32_t)(x << 4) >> 28), s),
                     __fmul_rn((float)((int32_t)x >> 28), s));
}

// A warp takes 32 chunks at a time (512 codes int8, 1024 int4): lane l
// loads chunk l with one read-only 16-byte load, and kDeqInFlight such
// groups a thread (one grid's worth apart) go out before any is used.
// The chunks go through this warp's slice of shared memory so that each
// store instruction writes 512 contiguous bytes: store k of lane l is
// float4 k * 32 + l of the group, the four codes of word k * 32 + l
// (int8) or halfword k * 32 + l (int4).  Code 4j of a group's float4 j
// lies in tile 4j >> shift (shift >= 0) or 4j / tile.
template <int BITS, typename IDX>
__global__ void __launch_bounds__(kDeqThreads)
dequantize_kernel(const uint4* __restrict__ codes,
                  const float* __restrict__ scales, IDX chunks, int tile,
                  int shift, float4* __restrict__ out) {
  constexpr int kOut = BITS == 8 ? 4 : 8;   // float4 stores a chunk
  constexpr int kWarps = kDeqThreads / 32;
  __shared__ uint4 stage[kWarps][kDeqInFlight][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const IDX groups = (chunks + 31) / 32;
  const IDX gstride = (IDX)gridDim.x * kWarps;
  for (IDX g0 = (IDX)blockIdx.x * kWarps + warp; g0 < groups;
       g0 += kDeqInFlight * gstride) {
    uint4 w[kDeqInFlight];
#pragma unroll
    for (int u = 0; u < kDeqInFlight; ++u) {   // every load out first
      const IDX c = (g0 + u * gstride) * 32 + lane;
      if (c < chunks) w[u] = __ldg(codes + c);
    }
    float s[kDeqInFlight][kOut];
#pragma unroll
    for (int u = 0; u < kDeqInFlight; ++u)
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const IDX f = (g0 + u * gstride) * 32 * kOut + k * 32 + lane;
        const IDX code = 4 * f;
        if (f / kOut < chunks)
          s[u][k] = __ldg(scales + (shift >= 0 ? code >> shift
                                               : code / tile));
      }
#pragma unroll
    for (int u = 0; u < kDeqInFlight; ++u) stage[warp][u][lane] = w[u];
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kDeqInFlight; ++u) {
      const IDX f0 = (g0 + u * gstride) * 32 * kOut;
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int j = k * 32 + lane;
        if ((f0 + j) / kOut >= chunks) continue;
        if constexpr (BITS == 8) {
          out[f0 + j] = widen_int8(
              reinterpret_cast<const uint32_t*>(stage[warp][u])[j], s[u][k]);
        } else {
          const uint32_t h =
              reinterpret_cast<const uint16_t*>(stage[warp][u])[j];
          out[f0 + j] = widen_int4(h, s[u][k]);
        }
      }
    }
    __syncwarp();   // the slice is free for the next groups
  }
}

// The grid covers the card once, no more than the chunks need.
template <int BITS, typename IDX>
int launch_dequantize(const void* codes, const float* scales, IDX chunks,
                      int tile, float* out, cudaStream_t stream) {
  auto kernel = dequantize_kernel<BITS, IDX>;
  static std::atomic<int> per_sm{0};
  long long grid = 0;
  const int err = covering_grid(
      kernel, kDeqThreads, ((long long)chunks + kDeqThreads - 1) /
      kDeqThreads, per_sm, &grid);
  if (err != 0) return err;
  int shift = 0;
  while ((1 << shift) < tile) ++shift;
  if ((1 << shift) != tile) shift = -1;
  kernel<<<(unsigned)grid, kDeqThreads, 0, stream>>>(
      (const uint4*)codes, scales, chunks, tile, shift, (float4*)out);
  return (int)cudaGetLastError();
}

// ---- the generic routes: any tile, any alignment ----

// Bytes [s, s + 16) of the 32 bytes a then b (s in [0, 16) and the same
// across the warp), each 32-bit word by one funnel shift.
template <int Q>
__device__ __forceinline__ uint4 shift_words(const uint32_t (&w)[8],
                                             uint32_t r) {
  return make_uint4(__funnelshift_r(w[Q], w[Q + 1], r),
                    __funnelshift_r(w[Q + 1], w[Q + 2], r),
                    __funnelshift_r(w[Q + 2], w[Q + 3], r),
                    __funnelshift_r(w[Q + 3], w[Q + 4], r));
}
__device__ __forceinline__ uint4 realign(const uint4& a, const uint4& b,
                                         int s) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const uint32_t r = 8u * (uint32_t)(s & 3);
  switch (s >> 2) {
    case 0: return shift_words<0>(w, r);
    case 1: return shift_words<1>(w, r);
    case 2: return shift_words<2>(w, r);
    default: return shift_words<3>(w, r);
  }
}

// A unit: 8 consecutive values of a staged window (16 bytes of a 16-bit
// dtype, 32 of float32) as 32-bit words, realigned by funnel shifts from
// the 16-byte chunks that hold them.
constexpr int kUnit = 8;
template <typename T>
using UnitWords = uint32_t[2 * sizeof(T)];

template <typename T>
__device__ __forceinline__ void load_unit(const uint4* sx, int k, int head,
                                          UnitWords<T>& w) {
  constexpr int kChunks = sizeof(T) / 2;   // 16-byte chunks a unit
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint4 v = realign(sx[kChunks * k + c], sx[kChunks * k + c + 1],
                            head);
    w[4 * c] = v.x; w[4 * c + 1] = v.y; w[4 * c + 2] = v.z;
    w[4 * c + 3] = v.w;
  }
}

// The bits (the dtype's own) of value p of a unit.
template <typename T>
__device__ __forceinline__ uint32_t unit_bits(const UnitWords<T>& w, int p) {
  if constexpr (sizeof(T) == 4) {
    return w[p];
  } else {
    return (w[p >> 1] >> (16 * (p & 1))) & 0xffffu;
  }
}

constexpr int kGenThreads = 128;
// The widest span of values (bytes) a block stages in shared memory.  A
// tile wider than it (two tiles of it for int4 at an odd tile, whose
// boundary byte holds a nibble of each) takes windows of this width
// and is read twice.
constexpr int kSpanBytes = 32768;
// A span's bytes: the leaf's bytes over kSpanBlocksPerSM blocks an SM,
// within [kSpanMinBytes, kSpanTargetBytes] (a tile wider than that, one
// tile or pair), so that a small frame still spreads over the card and
// a large one takes waves of short blocks whose loads overlap other
// blocks' work.
constexpr int kSpanMinBytes = 2048;
constexpr int kSpanTargetBytes = 4096;
constexpr int kSpanBlocksPerSM = 4;
constexpr int kMaxSpanTiles = 1024;   // even; the scales a block holds

// Shared memory for a window of `values` values: the values from the
// aligned-down address (up to 15 bytes of head) and one more chunk for
// the realigning reads; its codes behind a 16-byte pad, and one more
// chunk for the realigning reads.
__host__ __device__ constexpr int staged_bytes(int values, int item) {
  return ((values * item + 15) / 16 + 2) * 16;
}
__host__ __device__ constexpr int code_window_bytes(int values, int bits) {
  return ((values * bits / 8 + 15) / 16 + 2) * 16;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// Stage values [e, e + nv) of the leaf x (n values) in sx with 16-byte
// cp.async copies from the 16-byte aligned address at or below x + e;
// bytes past the leaf's end arrive as zeros (the copy's source size).
// Returns the first value's byte offset in sx (x + e's address mod 16).
template <typename T>
__device__ __forceinline__ int stage_window(const T* x, long long n,
                                            long long e, int nv,
                                            uint4* sx) {
  const char* base = reinterpret_cast<const char*>(x);
  const char* g = base + e * (long long)sizeof(T);
  const int head = (int)((uintptr_t)g & 15);
  const char* a = g - head;
  const char* end = base + n * (long long)sizeof(T);
  const int chunks = (head + nv * (int)sizeof(T) + 15) / 16;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const char* src = a + 16LL * i;
    const long long valid = end - src;
    if (valid > 0) {
      cp_async16(sx + i, src, valid >= 16 ? 16 : (int)valid);
    } else {
      sx[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  return head;
}

// The absmax of a staged window (the block's values [v0, v0 + nv)) into
// st[tile], as magnitude bits.  Thread k takes the window's unit k, one
// division for its first value's tile and a compare a value after; a
// run that ends inside the unit goes to st by a shared atomicMax, the
// unit's last run through a shuffle scan over the warp's lanes that end
// in the same tile (their tiles rise with the lane), then one atomicMax
// a tile a warp.
template <typename T>
__device__ __forceinline__ void reduce_window(const uint4* sx, int head,
                                              int v0, int nv, int tile,
                                              uint32_t* st) {
  const int units = (nv + kUnit - 1) / kUnit;
  const int lane = threadIdx.x & 31;
  const uint32_t mag = sizeof(T) == 4 ? 0x7fffffffu : 0x7fffu;
  for (int base = 0; base < units; base += blockDim.x) {
    const int k = base + threadIdx.x;
    uint32_t key = 0xffffffffu, m = 0u;
    if (k < units) {
      UnitWords<T> w;
      load_unit<T>(sx, k, head, w);
      const int j0 = k * kUnit, v = v0 + j0;
      key = (uint32_t)(v / tile);
      int r = v - (int)key * tile;
#pragma unroll
      for (int p = 0; p < kUnit; ++p) {
        if (j0 + p < nv) {
          if (r == tile) {   // the next tile starts inside the unit
            atomicMax(st + key, m);
            ++key;
            m = 0u;
            r = 0;
          }
          m = max(m, unit_bits<T>(w, p) & mag);
          ++r;
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t om = __shfl_down_sync(0xffffffffu, m, off);
      const uint32_t ok = __shfl_down_sync(0xffffffffu, key, off);
      if (lane + off < 32 && ok == key) m = max(m, om);
    }
    const uint32_t prev = __shfl_up_sync(0xffffffffu, key, 1);
    if (key != 0xffffffffu && (lane == 0 || prev != key))
      atomicMax(st + key, m);
  }
}

// The codes of a staged window into the code window sc (window code
// byte r at sc[r]): thread k codes unit k with the scales of its tiles
// (from st's absmax bits: one division a tile a thread), a value's tile
// by one division a unit and a compare a value, packs the unit's 8
// codes as the code array holds them (8 bytes int8, 4 int4) and stores
// them with one shared store.  The conversion rounds half to even and
// saturates, and turns a NaN quotient (a non-finite tile's NaN scale)
// into 0, so clipping it is the oracle's code.
template <typename T, int BITS>
__device__ __forceinline__ void code_window(const uint4* sx, int head,
                                            int v0, int nv, int tile,
                                            const uint32_t* st,
                                            uint8_t* sc) {
  constexpr int qmax = BITS == 8 ? 127 : 7;
  const int units = (nv + kUnit - 1) / kUnit;
  for (int k = threadIdx.x; k < units; k += blockDim.x) {
    UnitWords<T> w;
    load_unit<T>(sx, k, head, w);
    const int j0 = k * kUnit, v = v0 + j0;
    int t = v / tile, r = v - t * tile;
    float s = scale_of<T, BITS>(st[t]);
    uint32_t out[2] = {0u, 0u};
#pragma unroll
    for (int p = 0; p < kUnit; ++p) {
      if (j0 + p < nv) {
        if (r == tile) {
          ++t;
          r = 0;
          s = scale_of<T, BITS>(st[t]);
        }
        const uint32_t q = (uint32_t)min(
            max(__float2int_rn(__fdiv_rn(chunk_value<T>(w, p), s)), -qmax),
            qmax);
        if constexpr (BITS == 8) {
          out[p >> 2] |= (q & 0xffu) << (8 * (p & 3));
        } else {   // low nibble first
          out[0] |= (q & 0xfu) << (4 * p);
        }
        ++r;
      }
    }
    if constexpr (BITS == 8) {
      *reinterpret_cast<uint2*>(sc + j0) = make_uint2(out[0], out[1]);
    } else {
      *reinterpret_cast<uint32_t*>(sc + j0 / 2) = out[0];
    }
  }
}

// A window's nb code bytes, staged behind the 16-byte pad of sc, to
// dst: 16-byte stores at the 16-byte aligned addresses the window
// covers whole (each warp store instruction 512 contiguous bytes), byte
// stores at its unaligned head and tail.
__device__ __forceinline__ void store_window(const uint4* sc, int nb,
                                             uint8_t* dst) {
  const int hb = (int)((uintptr_t)dst & 15);
  uint8_t* a = dst - hb;
  const int chunks = (hb + nb + 15) / 16;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const uint4 v = hb ? realign(sc[i], sc[i + 1], 16 - hb) : sc[i + 1];
    const int r0 = 16 * i - hb;   // the window code byte at a + 16 i
    if (r0 >= 0 && r0 + 16 <= nb) {
      *reinterpret_cast<uint4*>(a + 16 * i) = v;
    } else {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (r0 + b >= 0 && r0 + b < nb)
          a[16 * i + b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
    }
  }
}

// A block takes span_tiles consecutive tiles (the last block fewer) and
// walks their values in windows of `win` values: one window when the
// span fits (the leaf read once), else a wide tile's windows twice, the
// second time from L2.  Per window: stage, reduce; then per window:
// code (the scales written once a tile beside it), restage, store.
template <typename T, int BITS>
__global__ void __launch_bounds__(kGenThreads)
quantize_generic_kernel(const T* __restrict__ x, long long n, int tile,
                        long long t_count, int span_tiles, int win,
                        uint8_t* __restrict__ codes,
                        float* __restrict__ scales) {
  extern __shared__ uint4 smem[];
  uint4* sx = smem;
  uint4* sc = smem + staged_bytes(win, sizeof(T)) / 16;
  uint32_t* st = reinterpret_cast<uint32_t*>(
      sc + code_window_bytes(win, BITS) / 16);
  const long long t0 = (long long)blockIdx.x * span_tiles;
  const int tiles = (int)min((long long)span_tiles, t_count - t0);
  const int span = tiles * tile;   // values: < 2^31 by the entry's limit
  const long long e0 = t0 * tile;
  const int wins = (span + win - 1) / win;
  for (int i = threadIdx.x; i < tiles; i += blockDim.x) st[i] = 0u;
  int head = 0;
  for (int w = 0; w < wins; ++w) {
    if (w) __syncthreads();   // the last window's readers are done
    const int v0 = w * win, nv = min(win, span - v0);
    head = stage_window<T>(x, n, e0 + v0, nv, sx);
    reduce_window<T>(sx, head, v0, nv, tile, st);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tiles; i += blockDim.x)
    scales[t0 + i] = scale_of<T, BITS>(st[i]);
  for (int w = 0; w < wins; ++w) {
    const int v0 = w * win, nv = min(win, span - v0);
    if (wins > 1) head = stage_window<T>(x, n, e0 + v0, nv, sx);
    code_window<T, BITS>(sx, head, v0, nv, tile, st,
                         reinterpret_cast<uint8_t*>(sc + 1));
    __syncthreads();
    const long long e = e0 + v0;
    store_window(sc, BITS == 8 ? nv : nv / 2,
                 codes + (BITS == 8 ? e : e / 2));
    if (w + 1 < wins) __syncthreads();   // sx and sc free for the next
  }
}

// Spans of whole tiles (pairs at an odd int4 tile) within kSpanBytes,
// or windows of kSpanBytes over a wide tile; the dynamic shared memory
// ceiling is raised once per instantiation.
template <typename T, int BITS>
int launch_quantize_generic(const void* x, long long n, int tile,
                            long long t_count, void* codes, float* scales,
                            cudaStream_t stream) {
  auto kernel = quantize_generic_kernel<T, BITS>;
  constexpr int kItem = sizeof(T);
  static std::atomic<int> opted{0};
  if (!opted.load(std::memory_order_relaxed)) {
    const int most = staged_bytes(kSpanBytes / kItem, kItem) +
                     code_window_bytes(kSpanBytes / kItem, BITS) +
                     4 * kMaxSpanTiles;
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != 0) return err;
    opted.store(1, std::memory_order_relaxed);
  }
  const int pair = (BITS == 4 && (tile & 1)) ? 2 : 1;
  const long long tile_bytes = (long long)tile * kItem;
  int span_tiles, win;
  if (pair * tile_bytes > kSpanBytes) {
    span_tiles = pair;
    win = kSpanBytes / kItem;
  } else {
    int sms = 0;
    const int err = sm_count(&sms);
    if (err != 0) return err;
    long long target = t_count * tile_bytes /
                       ((long long)kSpanBlocksPerSM * (sms > 0 ? sms : 1));
    if (target < kSpanMinBytes) target = kSpanMinBytes;
    if (target > kSpanTargetBytes) target = kSpanTargetBytes;
    long long k = target / tile_bytes / pair * pair;
    if (k < pair) k = pair;
    if (k > kMaxSpanTiles) k = kMaxSpanTiles;
    span_tiles = (int)k;
    win = span_tiles * tile;
  }
  const long long blocks = (t_count + span_tiles - 1) / span_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = staged_bytes(win, kItem) + code_window_bytes(win, BITS) +
                   4 * span_tiles;
  kernel<<<(unsigned)blocks, kGenThreads, smem, stream>>>(
      (const T*)x, n, tile, t_count, span_tiles, win, (uint8_t*)codes,
      scales);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quantize_generic_bits(const void* x, long long n, int tile,
                                 long long t_count, int bits, void* codes,
                                 float* scales, cudaStream_t stream) {
  return bits == 8
      ? launch_quantize_generic<T, 8>(x, n, tile, t_count, codes, scales,
                                      stream)
      : launch_quantize_generic<T, 4>(x, n, tile, t_count, codes, scales,
                                      stream);
}

constexpr int kDeqGenThreads = 256;
constexpr int kDeqGenInFlight = 1;   // groups a warp loads before it stores

// The four codes of float4 j of a staged group, sign-extended by
// shifts: word j (int8, low byte first) or halfword j (int4, low nibble
// first).
template <int BITS>
__device__ __forceinline__ void codes_of_quad(const uint4* group, int j,
                                              int (&c)[4]) {
  if constexpr (BITS == 8) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(group)[j];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = (int32_t)(w << (24 - 8 * i)) >> 24;
  } else {
    const uint32_t x =
        (uint32_t)reinterpret_cast<const uint16_t*>(group)[j] << 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = (int32_t)(x << (12 - 4 * i)) >> 28;
  }
}

// Row 5's design at any tile and any alignment.  Chunk c of the codes
// is bytes [16 c, 16 c + 16) from `codes`: a warp takes 32 chunks at a
// time, lane l the 16-byte aligned chunk at or below its chunk's start
// by one read-only load (kDeqGenInFlight groups a thread out before any
// is used) and the next aligned chunk from lane l + 1 (lane 31 loads
// it), realigned by funnel shifts.  Each float4's tile comes from one
// division for its first code; its four codes take the NS scales from
// that tile on (1 when tile % 4 == 0, 2 for any other tile >= 4, 4
// below), loaded beside the chunks.  The chunks go through the warp's
// shared-memory slice so that each store instruction writes 512
// contiguous bytes; the last float4 of an array whose length is not a
// multiple of 4 is stored a float at a time.
template <int BITS, int NS, typename IDX>
__global__ void __launch_bounds__(kDeqGenThreads)
dequantize_generic_kernel(const uint8_t* __restrict__ codes,
                          const float* __restrict__ scales, IDX t_count,
                          IDX total, int tile, float* __restrict__ out) {
  constexpr int kOut = BITS == 8 ? 4 : 8;   // float4s a chunk
  constexpr int kWarps = kDeqGenThreads / 32;
  constexpr int U = kDeqGenInFlight;
  __shared__ uint4 stage[kWarps][U][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hq = (int)((uintptr_t)codes & 15);
  const uint4* qa = reinterpret_cast<const uint4*>(codes - hq);
  const IDX nbytes = BITS == 8 ? total : total / 2;
  const IDX chunks = (nbytes + 15) / 16;
  const IDX held = (hq + nbytes + 15) / 16;   // aligned chunks of codes
  const IDX quads = (total + 3) / 4;           // float4s of out
  const IDX groups = (chunks + 31) / 32;
  const IDX gstride = (IDX)gridDim.x * kWarps;
  for (IDX g0 = (IDX)blockIdx.x * kWarps + warp; g0 < groups;
       g0 += U * gstride) {
    uint4 a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {   // every load out first
      const IDX c = (g0 + u * gstride) * 32 + lane;
      a[u] = c < held ? __ldg(qa + c) : make_uint4(0u, 0u, 0u, 0u);
      b[u] = (hq && lane == 31 && c + 1 < held)
                 ? __ldg(qa + c + 1) : make_uint4(0u, 0u, 0u, 0u);
    }
    float s[U][kOut][NS];
    int r[U][kOut];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const IDX f = (g0 + u * gstride) * 32 * kOut + k * 32 + lane;
        r[u][k] = 0;
#pragma unroll
        for (int i = 0; i < NS; ++i) s[u][k][i] = 0.0f;
        if (f < quads) {
          const IDX code = 4 * f, t = code / tile;
          r[u][k] = (int)(code - t * tile);
          s[u][k][0] = __ldg(scales + t);
#pragma unroll
          for (int i = 1; i < NS; ++i)
            s[u][k][i] = __ldg(scales + (t + i < t_count ? t + i
                                                         : t_count - 1));
        }
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint4 w = a[u];
      if (hq) {   // the same in every lane
        uint4 nxt = make_uint4(__shfl_down_sync(0xffffffffu, a[u].x, 1),
                               __shfl_down_sync(0xffffffffu, a[u].y, 1),
                               __shfl_down_sync(0xffffffffu, a[u].z, 1),
                               __shfl_down_sync(0xffffffffu, a[u].w, 1));
        if (lane == 31) nxt = b[u];
        w = realign(a[u], nxt, hq);
      }
      stage[warp][u][lane] = w;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const IDX f0 = (g0 + u * gstride) * 32 * kOut;
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int j = k * 32 + lane;
        const IDX f = f0 + j;
        if (f >= quads) continue;
        int c[4];
        codes_of_quad<BITS>(stage[warp][u], j, c);
        float o[4];
        int rr = r[u][k], idx = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sc = s[u][k][0];
          if constexpr (NS > 1) {
            if (rr == tile) {   // the next tile starts inside the float4
              ++idx;
              rr = 0;
            }
            if (idx == 1) sc = s[u][k][1];
            if constexpr (NS > 2) {
              if (idx == 2) sc = s[u][k][2];
              if (idx == 3) sc = s[u][k][3];
            }
            ++rr;
          }
          o[i] = __fmul_rn((float)c[i], sc);
        }
        if (4 * f + 4 <= total) {
          reinterpret_cast<float4*>(out)[f] =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * f + i < total) out[4 * f + i] = o[i];
        }
      }
    }
    __syncwarp();   // the slice is free for the next groups
  }
}

// The grid covers the card once, no more than the chunks need.
template <int BITS, int NS, typename IDX>
int launch_dequantize_generic(const void* codes, const float* scales,
                              IDX t_count, IDX total, int tile, float* out,
                              cudaStream_t stream) {
  auto kernel = dequantize_generic_kernel<BITS, NS, IDX>;
  static std::atomic<int> per_sm{0};
  const long long chunks =
      ((long long)(BITS == 8 ? total : total / 2) + 15) / 16;
  long long grid = 0;
  const int err = covering_grid(
      kernel, kDeqGenThreads, (chunks + kDeqGenThreads - 1) / kDeqGenThreads,
      per_sm, &grid);
  if (err != 0) return err;
  kernel<<<(unsigned)grid, kDeqGenThreads, 0, stream>>>(
      (const uint8_t*)codes, scales, t_count, total, tile, out);
  return (int)cudaGetLastError();
}

template <int BITS, typename IDX>
int launch_dequantize_generic_ns(const void* codes, const float* scales,
                                 IDX t_count, IDX total, int tile,
                                 float* out, cudaStream_t stream) {
  if (tile % 4 == 0)
    return launch_dequantize_generic<BITS, 1, IDX>(codes, scales, t_count,
                                                   total, tile, out, stream);
  if (tile >= 4)
    return launch_dequantize_generic<BITS, 2, IDX>(codes, scales, t_count,
                                                   total, tile, out, stream);
  return launch_dequantize_generic<BITS, 4, IDX>(codes, scales, t_count,
                                                 total, tile, out, stream);
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

// The generic route: any tile, any alignment; same arguments.  A tile
// holds at most 2^28 - 1 values, the route's limit since its first
// design.
int slt_quantize_generic(int dtype, const void* x, long long n, int tile,
                         long long t_count, int bits, void* codes,
                         void* scales, void* stream) {
  if (tile < 1 || t_count < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && (t_count * tile) % 2) ||
      n > t_count * (long long)tile || 8LL * tile > 0x7fffffffLL ||
      (uintptr_t)scales % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* sc = (float*)scales;
  switch (dtype) {
    case 0:
      return launch_quantize_generic_bits<float>(x, n, tile, t_count, bits,
                                                 codes, sc, s);
    case 1:
      return launch_quantize_generic_bits<__nv_bfloat16>(
          x, n, tile, t_count, bits, codes, sc, s);
    case 2:
      return launch_quantize_generic_bits<__half>(x, n, tile, t_count, bits,
                                                  codes, sc, s);
  }
  return (int)cudaErrorInvalidValue;
}

// codes: t_count * tile int8 codes (bits 8) or t_count * tile / 2 packed
// bytes (bits 4); out: t_count * tile float32.
//
// The vec route: a tile of whole 16-byte code chunks (tile % 16 == 0 for
// int8, tile % 32 == 0 for int4), codes and out 16-byte aligned, scales
// 4-byte aligned; anything else returns an error without launching.
int slt_dequantize(const void* codes, const void* scales, long long t_count,
                   int tile, int bits, void* out, void* stream) {
  const int per = bits == 8 ? 16 : 32;   // codes a chunk
  if (tile < 1 || t_count < 1 || (bits != 8 && bits != 4) || tile % per ||
      ((uintptr_t)codes | (uintptr_t)out) % 16 || (uintptr_t)scales % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long chunks = t_count * (long long)tile / per;
  const float* sc = (const float*)scales;
  float* o = (float*)out;
  // 32-bit indices while 4 * (the float4 index of a group's end) fits
  if (t_count * (long long)tile <= 0x3fffffffLL) {
    return bits == 8
        ? launch_dequantize<8, int>(codes, sc, (int)chunks, tile, o, s)
        : launch_dequantize<4, int>(codes, sc, (int)chunks, tile, o, s);
  }
  return bits == 8
      ? launch_dequantize<8, long long>(codes, sc, chunks, tile, o, s)
      : launch_dequantize<4, long long>(codes, sc, chunks, tile, o, s);
}

// The generic route: any tile, codes at any alignment; same arguments
// (out 16-byte aligned, scales 4-byte aligned).
int slt_dequantize_generic(const void* codes, const void* scales,
                           long long t_count, int tile, int bits, void* out,
                           void* stream) {
  if (tile < 1 || t_count < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && (t_count * tile) % 2) || (uintptr_t)out % 16 ||
      (uintptr_t)scales % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = t_count * (long long)tile;
  const float* sc = (const float*)scales;
  float* o = (float*)out;
  // 32-bit indices while 4 * (the float4 index of a group's end) fits
  if (total <= 0x3fffffffLL) {
    return bits == 8
        ? launch_dequantize_generic_ns<8, int>(codes, sc, (int)t_count,
                                               (int)total, tile, o, s)
        : launch_dequantize_generic_ns<4, int>(codes, sc, (int)t_count,
                                               (int)total, tile, o, s);
  }
  return bits == 8
      ? launch_dequantize_generic_ns<8, long long>(codes, sc, t_count, total,
                                                   tile, o, s)
      : launch_dequantize_generic_ns<4, long long>(codes, sc, t_count, total,
                                                   tile, o, s);
}

}  // extern "C"
