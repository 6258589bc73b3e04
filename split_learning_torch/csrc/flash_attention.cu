// Flash attention forward and backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the three Pallas TPU kernels of the JAX package's
// split_learning_tpu/ops/flash_attention.py:
//
//   flash_fwd_tc_kernel      <- _fwd_kernel      (:62-102, via _flash_fwd_bhsd)
//                               bfloat16, D in {16, 32, 64, 128}
//   flash_fwd_x3_kernel      <- _fwd_kernel      float32, and bfloat16 D = 8
//   flash_bwd_dkv_tc_kernel  <- _bwd_dkv_kernel  (:134-170, via _flash_bwd_rule)
//                               bfloat16, D in {16, 32, 64, 128}
//   flash_bwd_dkv_x3_kernel  <- _bwd_dkv_kernel  float32, and bfloat16 D = 8
//   flash_bwd_dq_tc_kernel   <- _bwd_dq_kernel   (:173-205, via _flash_bwd_rule)
//                               bfloat16, D in {16, 32, 64, 128}
//   flash_bwd_dq_x3_kernel   <- _bwd_dq_kernel   float32, and bfloat16 D = 8
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
//   not lose precision to bf16 or TF32 (Precision.HIGHEST), so both take
//   flash_fwd_x3_kernel.
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
// flash_bwd_dkv_x3_kernel and flash_bwd_dq_x3_kernel (the float32 and
// D = 8 backward, _bwd_dkv_kernel and _bwd_dq_kernel at float32 and bf16
// D = 8), on the tensor cores in split TF32 ("3xTF32"):
//   * The JAX package runs float32 flash at Precision.HIGHEST (several
//     bf16 passes on the MXU).  Here each float32 operand x is split into
//     hi = cvt.rna.tf32(x) and lo = the TF32 rounding of x - hi, and each
//     product is lo*hi + hi*lo + hi*hi, small terms first, on
//     mma.sync.m16n8k8.tf32 into float32 accumulators: within ~2^-21 of a
//     float32 product, at the 495 TFLOP/s of TF32 and not the 67 of the
//     CUDA cores.  bf16 values are exact in TF32 (lo = 0), so with bf16
//     inputs S = Q K^T and dP = dO V^T take one product and the float32 P
//     and dS two (their B operand's lo term is 0).
//   * Bound at (256, 256, 64) float32 causal by bytes: dK/dV 101 MB, 0.030
//     ms; dQ 84 MB, 0.025 ms (the three TF32 products of each float32 one
//     take 0.026 and 0.020 ms at the TF32 peak).  What bounds this design
//     on an H100 is the shared memory each product reads: a B fragment
//     serves one m16 tile, and with hi and lo it is 4 words a lane for 3
//     mma.sync (each ~5.5 cycles of an SM sub-partition at best,
//     tools/mma_sync_rate.cu), about as many wavefronts as the SM's shared
//     memory serves in that time.  The
//     CUDA-core kernels these replace were bound by one 4-byte shared load
//     per two FMAs and by synchronous element copies, at 21 % of the CUDA
//     cores.
//   * Decomposition as the TPU kernels and the bf16 pair: dK/dV one block
//     of 4 warps per (bh, 64-row K tile), each warp 16 K rows, walking the
//     Q tiles from the causal start; dQ one block per (bh, 64-row Q tile),
//     last first, walking up to the diagonal.  Each block owns its output
//     tile: no atomics, deterministic.  Only the diagonal and ragged tiles
//     are masked; a warp skips a step none of whose pairs it can see.
//   * The kept tiles (K and V, or Q and dO) are split once a block into
//     the A fragments the products read, in fragment order (one 16-byte
//     read a fragment for hi, one for lo).  The streamed ones (Q, dO, lse
//     and delta, or K and V) come in 32-row steps by 16-byte cp.async
//     copies, zero-filled past S, and each step is split once into a hi
//     and a lo plane that every warp then reads (split where each warp
//     reads it, every value is split 8 times a step: slower on an H100,
//     though a ring of raw steps then needs one barrier a step).  The
//     planes take a second barrier a step (written, then read by every
//     warp); the next step's copies are in flight while a step computes.
//     At D = 64: the kept tiles 64 KB, the planes 32 KB, the raw step
//     16.25 KB, 115,200 / 114,688 bytes a block, 2 blocks an SM.
//   * ldmatrix.trans moves 16-bit elements and cannot transpose float32,
//     so the B operands read down columns (dO and Q in dV += P^T dO and
//     dK += dS^T Q, K in dQ += dS K) are 4-byte shared loads of the
//     planes, whose 16-byte chunks are XOR-swizzled by the row so that
//     reads along rows (8 bytes, rows g) and down columns (rows 2t, 2t + 1)
//     both hit 32 distinct banks; no transposed copy (a second plane a
//     tile, past the 2 blocks an SM).
//   * P and dS never leave registers: an m16n8 accumulator gives lane
//     (g, t) columns 2t and 2t + 1, and the m16n8k8 A fragment wants
//     columns t and t + 4, so the k index of each k8 step is permuted
//     (A column t <- 2t, t + 4 <- 2t + 1) and B's rows are read in the
//     same order; a sum over k does not depend on its order, and no
//     shuffle is needed.  The same permutation makes a kept fragment's
//     and a B fragment's two columns adjacent in memory.
//   * p = 2^(s*scale*log2(e) - lse*log2(e)) on ex2.approx; dK, dV and dQ
//     go from the accumulators straight to device memory (8-byte stores
//     of two float32, 4-byte of two bf16).
//   Left for later: wgmma (it takes TF32 only K-major) and TMA.
//
// flash_fwd_x3_kernel (the float32 and D = 8 forward, _fwd_kernel at
// float32 and bf16 D = 8), the backward pair's split-TF32 parts in the
// shape of flash_bwd_dq_x3_kernel with one product fewer:
//   * Bound at (256, 256, 64) float32 causal by bytes: q, k, v, o and lse
//     move 67.4 MB, 0.020 ms; the three TF32 products of each float32 one
//     (2.15 GFLOP) take 0.013 ms at the TF32 peak (0.032 ms on the CUDA
//     cores, where the kernel this one replaced took 0.160 ms on an
//     H100 at 700 W).  What bounds
//     this design on an H100 is, as in the backward, the shared memory
//     its B fragments read (hi and lo, 4 words a lane for 3 mma.sync),
//     and the two barriers a 32-key step.
//   * One block of 4 warps per (bh, 64-row Q tile), each warp 16 Q rows,
//     the last (under causality the heaviest) Q tile first; the block
//     walks K and V up to the diagonal (the TPU kernel's nk_eff).
//   * Q is scaled in float32 (q * scale, as the TPU kernel does), so even
//     bf16 Q needs both TF32 terms.  It lands raw (16-byte cp.async) and
//     is split once into hi/lo A fragments in fragment order: into
//     registers at D <= 64, into shared memory at D = 128 (in registers
//     the fragments and the 64-column accumulator would spill).
//   * K and V stream in 32-row steps by 16-byte cp.async, zero-filled
//     past S, and each step is split once into the swizzled hi/lo planes
//     of the backward (K read along rows as the B operand of S = Q K^T,
//     V down columns as the B operand of O += P V, by 4-byte loads); the
//     next step's copies are in flight while a step computes.  bf16 K
//     and V are exact in TF32: their lo term is skipped, so bf16 D = 8
//     takes two products for S and two for P V.
//   * Online softmax in registers, in log2 units: p = 2^(s*log2(e) - m),
//     m and l of a row reduced over its quad (l at the end only); m
//     starts at the finite NEG_INF and masked scores are -inf, so a
//     masked p is 0 and no row makes a NaN.  Only the diagonal and
//     ragged steps are masked, and a warp skips a step it sees nothing
//     of.  The accumulator is rescaled by corr once a step.  P never
//     leaves registers: split into hi/lo, it is the A operand of P V
//     through the permuted k order, no shuffles.
//   * o = acc * (1 / l_safe) goes from the accumulators straight to
//     device memory; lse = m*ln(2) + log(l_safe), the natural log that
//     _Flash.backward and the x3 pair read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of a Q tile and of a K tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int causal) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos);
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

// ---------------------------------------------------------------------------
// float32 (and bf16 D = 8) backward on the tensor cores, in split TF32
// ---------------------------------------------------------------------------

// x rounded to TF32 by cvt.rna (nearest, ties away from zero): a float32
// whose low 13 mantissa bits are 0
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), both TF32 (kExact: x is a bf16 value, exact
// in TF32, so hi = x and lo = 0).  hi = cvt.rna(x), so that x - hi is the
// exact remainder: the mma reads only the top 19 bits of a register and
// drops the low 13 silently.  lo = cvt.rna(x - hi) in what the mma reads:
// the bits of x - hi plus half a TF32 ulp (0x1000), whose low 13 bits the
// mma drops (round to nearest, ties away from zero, on the magnitude) --
// the same TF32 value as cvt for every finite x, in one integer add in
// place of cvt's four instructions.  A non-finite x keeps hi non-finite.
template <bool kExact>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32_rna(x);
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
  }
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B in split TF32, the small terms first: lo(A) hi(B) + hi(A) lo(B)
// + hi(A) hi(B) (lo lo, ~2^-22 of the product, is left out).  A term whose
// lo is 0 (a bf16 operand) is skipped.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_x3(float (&c)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4],
                                       const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  if constexpr (!kExactA) mma_tf32(c, al, bh[0], bh[1]);
  if constexpr (!kExactB) mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// Rows of a streamed tile of the split-TF32 backward (Q and dO in dK/dV,
// K and V in dQ): 32, so that the kept tiles, the streamed ones split and
// raw fit 2 blocks an SM at D = 64.
constexpr int kSub = 32;

// A kept tile (K and V in dK/dV, Q and dO in dQ) is split once, into the
// A fragments the products read: [warp][k8 step][lane] x 4 hi words, then
// the same for lo, so that a lane's fragment is one 16-byte read into the
// registers the mma takes.  Fragment columns t and t + 4 hold the tile's
// columns 2t and 2t + 1: the k index of each k8 step is permuted (a sum
// over k does not depend on its order), and B operands take their rows in
// the same order.
template <int D>
__host__ __device__ constexpr uint32_t kept_half_bytes() {
  return (uint32_t)kTile * D * 4;
}
template <int D>
__device__ __forceinline__ uint32_t kept_off(int warp, int kk, int lane) {
  return (uint32_t)((warp * (D / 8) + kk) * 32 + lane) * 16;
}

// A streamed tile is split into a hi plane and a lo plane of float32 rows
// of max(D, 32) values, in 16-byte chunks of 4 columns: chunk c/4 of row r
// sits at c/4 ^ pl_swz(r).  B fragments read along rows (columns 2t, 2t + 1
// of rows g: 8-byte reads) and down columns (column g of rows 2t and
// 2t + 1: 4-byte reads) then hit 32 distinct banks: pl_swz takes four
// values on any 4 consecutive rows and on the even and the odd rows of
// each 8.
template <int D>
__host__ __device__ constexpr uint32_t pl_row_bytes() {
  return (D < 32 ? 32 : D) * 4;
}
__device__ __forceinline__ int pl_swz(int r) {
  return ((((r >> 1) & 1) << 1) | ((r ^ (r >> 2)) & 1)) << 1;
}
template <int D>
__device__ __forceinline__ uint32_t pl_off(int r, int c) {
  return r * pl_row_bytes<D>() +
         ((((c >> 2) ^ pl_swz(r)) << 4) | ((c & 3) << 2));
}

// Issue the 16-byte copies of rows [r0, r0 + kSub) of a (S, D) matrix of
// T into a raw streamed tile (rows of D * sizeof(T) bytes); rows past S
// are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage_streamed(uint32_t dst, const T* src,
                                               int r0, int S) {
  constexpr int CH = D * (int)sizeof(T) / 16;   // 16-byte chunks of a row
  for (int idx = threadIdx.x; idx < kSub * CH; idx += kTcThreads) {
    const int r = idx / CH, c = idx - (idx / CH) * CH;
    const bool ok = r0 + r < S;
    cp_async16(dst + idx * 16,
               src + (size_t)(ok ? r0 + r : 0) * D + c * (16 / sizeof(T)),
               ok);
  }
}

// A kept tile lands raw with 16-byte chunk q of row r at q ^ kept_swz(r),
// so that the split below reads it without bank conflicts: float32 rows
// as pairs (8-byte reads of rows g, 4 rows a phase), bf16 rows as 4-byte
// reads (rows g, 8 rows a phase).
template <typename T, int D>
__device__ __forceinline__ int kept_swz(int r) {
  constexpr int CH = D * (int)sizeof(T) / 16;
  return (sizeof(T) == 4 ? 2 * (r & 3) : (r & 7)) & (CH - 1);
}
template <typename T, int D>
__device__ __forceinline__ void stage_kept(uint32_t dst, const T* src,
                                           int r0, int S) {
  constexpr int CH = D * (int)sizeof(T) / 16;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += kTcThreads) {
    const int r = idx / CH, c = idx - (idx / CH) * CH;
    const bool ok = r0 + r < S;
    cp_async16(dst + (r * CH + (c ^ kept_swz<T, D>(r))) * 16,
               src + (size_t)(ok ? r0 + r : 0) * D + c * (16 / sizeof(T)),
               ok);
  }
}

// Split the two raw kept 64-row tiles of T (contiguous at raw) into A
// fragments (at dst, the first tile's, then the second's), each value
// once: a thread builds a lane's whole fragment (rows g and g + 8,
// columns 2t and 2t + 1) and writes it as one 16-byte hi and one 16-byte
// lo store.  Unrolled by 8, so that a thread's reads go out together.
// The hi and lo A fragment of chunk f ([warp][k8 step][lane]) of a raw
// kept 64-row tile of T at src: lane (g, t)'s rows g and g + 8, columns
// 2t and 2t + 1 of the step, each value times mul when kScale.
template <typename T, int D, bool kExact, bool kScale>
__device__ __forceinline__ void kept_frag(const unsigned char* src, int f,
                                          float mul, uint4& hi, uint4& lo) {
  constexpr int CH = D * (int)sizeof(T) / 16;
  const int lane = f & 31, wk = f >> 5;   // wk = warp * D/8 + k8 step
  const int r = (wk / (D / 8)) * 16 + (lane >> 2);
  const int c = (wk % (D / 8)) * 8 + 2 * (lane & 3);
  float x[2][2];   // rows r, r + 8; columns c, c + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h, byte = c * (int)sizeof(T);
    const unsigned char* at =
        src + (row * CH + ((byte >> 4) ^ kept_swz<T, D>(row))) * 16 +
        (byte & 15);
    if constexpr (sizeof(T) == 4) {
      const float2 v = *reinterpret_cast<const float2*>(at);
      x[h][0] = v.x;
      x[h][1] = v.y;
    } else {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(at);
      x[h][0] = __low2float(v);
      x[h][1] = __high2float(v);
    }
    if constexpr (kScale) {
      x[h][0] *= mul;
      x[h][1] *= mul;
    }
  }
  split_tf32<kExact>(x[0][0], hi.x, lo.x);
  split_tf32<kExact>(x[1][0], hi.y, lo.y);
  split_tf32<kExact>(x[0][1], hi.z, lo.z);
  split_tf32<kExact>(x[1][1], hi.w, lo.w);
}

template <typename T, int D>
__device__ __forceinline__ void split_kept(unsigned char* dst,
                                           const unsigned char* raw) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int kFrags = 4 * (D / 8) * 32;   // fragment chunks of a tile
#pragma unroll 8
  for (int i = threadIdx.x; i < 2 * kFrags; i += kTcThreads) {
    const int tile = i / kFrags, f = i - tile * kFrags;
    unsigned char* const out = dst + tile * 2 * kept_half_bytes<D>();
    uint4 hi, lo;
    kept_frag<T, D, kExact, false>(raw + tile * kTile * D * (int)sizeof(T),
                                   f, 1.f, hi, lo);
    *reinterpret_cast<uint4*>(out + f * 16) = hi;
    *reinterpret_cast<uint4*>(out + kept_half_bytes<D>() + f * 16) = lo;
  }
}

// Split the two raw kSub-row tiles of a step (contiguous at raw) into
// their hi and lo planes (at dst: the first tile's hi, its lo, then the
// second's), each value once; the loop is unrolled, so that a thread's
// chunks are read and split together.
template <typename T, int D>
__device__ __forceinline__ void split_streamed(unsigned char* dst,
                                               const unsigned char* raw) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr uint32_t kPlane = kSub * pl_row_bytes<D>();
  constexpr int VC = 16 / (int)sizeof(T);   // values of a 16-byte chunk
  constexpr int CH = D / VC;                // chunks of a raw row
  constexpr int kChunks = 2 * kSub * CH;
#pragma unroll
  for (int i0 = 0; i0 < kChunks; i0 += kTcThreads) {
    const int idx = i0 + threadIdx.x;
    if (kChunks % kTcThreads != 0 && idx >= kChunks) break;
    const int r = idx / CH, q = idx - (idx / CH) * CH;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + idx * 16);
    const T* x = reinterpret_cast<const T*>(&w);
    unsigned char* const plane = dst + (r / kSub) * 2 * kPlane;
#pragma unroll
    for (int i = 0; i < VC; i += 4) {
      uint4 h, l;
      split_tf32<kExact>(to_f32(x[i]), h.x, l.x);
      split_tf32<kExact>(to_f32(x[i + 1]), h.y, l.y);
      split_tf32<kExact>(to_f32(x[i + 2]), h.z, l.z);
      split_tf32<kExact>(to_f32(x[i + 3]), h.w, l.w);
      const uint32_t at = pl_off<D>(r % kSub, q * VC + i);
      *reinterpret_cast<uint4*>(plane + at) = h;
      *reinterpret_cast<uint4*>(plane + kPlane + at) = l;
    }
  }
}

// acc[kSub/8][4] += A B^T over k8 step kk: A one fragment (ah, al) of
// this warp's 16 rows, B the streamed tile's kSub rows (its rows are the
// n index), read along rows.
template <int D, bool kExactA, bool kExactB>
__device__ __forceinline__ void x3_rows_step(float (&acc)[kSub / 8][4],
                                             const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4],
                                             const unsigned char* tB, int kk,
                                             int lane) {
  constexpr uint32_t kPlane = kSub * pl_row_bytes<D>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kSub / 8; ++j) {
    const uint32_t at = pl_off<D>(j * 8 + g, kk * 8 + 2 * t);
    const uint2 h2 = *reinterpret_cast<const uint2*>(tB + at);
    const uint2 l2 = *reinterpret_cast<const uint2*>(tB + kPlane + at);
    const uint32_t bh[2] = {h2.x, h2.y}, bl[2] = {l2.x, l2.y};
    mma_x3<kExactA, kExactB>(acc[j], ah, al, bh, bl);
  }
}

// acc[kSub/8][4] += A B^T: A this warp's kept fragments (16 rows, all D
// columns), B the streamed tile's kSub rows, read along rows.
template <int D, bool kExactA, bool kExactB>
__device__ __forceinline__ void x3_rows_by_tile(float (&acc)[kSub / 8][4],
                                                const unsigned char* kept,
                                                const unsigned char* tB,
                                                int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t ka = kept_off<D>(warp, kk, lane);
    const uint4 h4 = *reinterpret_cast<const uint4*>(kept + ka);
    const uint4 l4 =
        *reinterpret_cast<const uint4*>(kept + kept_half_bytes<D>() + ka);
    const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w};
    const uint32_t al[4] = {l4.x, l4.y, l4.z, l4.w};
    x3_rows_step<D, kExactA, kExactB>(acc, ah, al, tB, kk, lane);
  }
}

// acc[D/8][4] += F B: F (16 x kSub) float32 accumulators, split here, B
// the streamed tile (its rows are the k index), read down columns.  F
// stays in registers: lane (g, t)'s accumulator columns 2t and 2t + 1 are
// its A fragment's columns t and t + 4 (the permuted k order), and B's
// rows 2t and 2t + 1 its fragment rows t and t + 4.
template <int D, bool kExact>
__device__ __forceinline__ void x3_frags_by_tile(float (&acc)[D / 8][4],
                                                 const float (&f)[kSub / 8][4],
                                                 const unsigned char* tB,
                                                 int lane) {
  constexpr uint32_t kPlane = kSub * pl_row_bytes<D>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kSub / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32<false>(f[kk][0], ah[0], al[0]);   // row g,     column 2t
    split_tf32<false>(f[kk][2], ah[1], al[1]);   // row g + 8, column 2t
    split_tf32<false>(f[kk][1], ah[2], al[2]);   // row g,     column 2t + 1
    split_tf32<false>(f[kk][3], ah[3], al[3]);   // row g + 8, column 2t + 1
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint32_t a0 = pl_off<D>(kk * 8 + 2 * t, n * 8 + g);
      const uint32_t a1 = pl_off<D>(kk * 8 + 2 * t + 1, n * 8 + g);
      const uint32_t bh[2] = {*reinterpret_cast<const uint32_t*>(tB + a0),
                              *reinterpret_cast<const uint32_t*>(tB + a1)};
      const uint32_t bl[2] = {
          *reinterpret_cast<const uint32_t*>(tB + kPlane + a0),
          *reinterpret_cast<const uint32_t*>(tB + kPlane + a1)};
      mma_x3<false, kExact>(acc[n], ah, al, bh, bl);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Write a warp's 16 x D accumulators (rows row and row + 8 of this lane)
// to out, rows below S only.
template <typename T, int D>
__device__ __forceinline__ void x3_store_rows(const float (&acc)[D / 8][4],
                                              T* out, int row, int S,
                                              int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(out + (size_t)(row + 8 * r) * D + n * 8 + 2 * t,
             acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// Shared memory of the split-TF32 pair: two kept tiles split, two
// streamed tiles split and raw and, for dK/dV, lse and delta of a
// streamed tile, raw and scaled.  The kept tiles land raw where the
// streamed ones are split (512 max(D, 32) >= 128 D sizeof(T) bytes).
template <typename T, int D>
constexpr size_t x3_smem(bool rows) {
  return (size_t)4 * kept_half_bytes<D>() +
         (size_t)4 * kSub * pl_row_bytes<D>() +
         (size_t)2 * kSub * D * sizeof(T) +
         (rows ? (size_t)4 * kSub * sizeof(float) : 0);
}

// dK, dV (float32, and bf16 at D = 8): one block of 4 warps per (bh,
// 64-row K tile), each warp 16 K rows; Q, dO, lse and delta stream in
// kSub-row tiles from the causal start.  No atomics: each block owns its
// dK/dV tile.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int S, float scale,
                        float scale_log2, int causal) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr uint32_t kKeep = 2 * kept_half_bytes<D>();
  constexpr uint32_t kSplit = 2 * kSub * pl_row_bytes<D>();
  constexpr uint32_t kRaw = kSub * D * sizeof(T);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* const tK = tc_smem;            // K, V: kept fragments
  unsigned char* const tV = tK + kKeep;
  unsigned char* const tQ = tV + kKeep;         // Q, dO: streamed planes
  unsigned char* const tO = tQ + kSplit;
  float* const rows = reinterpret_cast<float*>(tO + kSplit);  // lse*log2(e),
  unsigned char* const raw = tO + kSplit + 2 * kSub * sizeof(float);  // delta
  const uint32_t sRaw = smem_u32(raw);          // raw Q, dO, lse, delta

  const int kb = blockIdx.x;   // K tile 0 (the most Q tiles) first
  const int k0 = kb * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const float* lse_row = lse + (size_t)blockIdx.y * S;
  const float* delta_row = delta + (size_t)blockIdx.y * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int krow = k0 + warp * 16 + (lane >> 2);   // keys krow, krow + 8

  // Q-side steps: kSub-row tiles from the causal start (queries before
  // the K tile see none of its keys)
  const int s0 = causal ? k0 / kSub : 0;
  const int n_it = (S + kSub - 1) / kSub - s0;
  auto stage_step = [&](int it) {
    const int r0 = (s0 + it) * kSub;
    stage_streamed<T, D>(sRaw, q + base, r0, S);
    stage_streamed<T, D>(sRaw + kRaw, dout + base, r0, S);
    if (threadIdx.x < 2 * kSub) {   // lse, then delta: 4-byte copies
      const int r = threadIdx.x & (kSub - 1);
      const bool ok = r0 + r < S;
      cp_async4(sRaw + 2 * kRaw + 4 * threadIdx.x,
                (threadIdx.x < kSub ? lse_row : delta_row) +
                    (ok ? r0 + r : 0),
                ok);
    }
  };

  // K and V land raw where split Q and dO go, and are split once
  stage_kept<T, D>(smem_u32(tQ), k + base, k0, S);
  stage_kept<T, D>(smem_u32(tQ) + kTile * D * sizeof(T), v + base, k0, S);
  cp_async_commit();
  stage_step(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  split_kept<T, D>(tK, tQ);   // K, then V

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // step it has landed; step it-1's split tiles are free
    split_streamed<T, D>(tQ, raw);   // Q, then dO
    if (threadIdx.x < 2 * kSub) {
      const float x =
          reinterpret_cast<const float*>(raw + 2 * kRaw)[threadIdx.x];
      rows[threadIdx.x] = threadIdx.x < kSub ? x * kLog2e : x;
    }
    __syncthreads();   // step it is split; the raw stage is free
    if (it + 1 < n_it) stage_step(it + 1);
    cp_async_commit();

    const int q0 = (s0 + it) * kSub;
    if (causal && krow - (lane >> 2) > q0 + kSub - 1)
      continue;   // this warp's keys follow every query of the step

    // S^T = K Q^T: this warp's 16 keys x kSub queries
    float p[kSub / 8][4];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
    x3_rows_by_tile<D, kExact, kExact>(p, tK, tQ, warp, lane);

    // P^T = 2^(s*scale*log2(e) - lse*log2(e)), lse by column (query);
    // masked entries (diagonal and ragged tiles only) are 0
    const bool edge = (causal && k0 + kTile > q0) || q0 + kSub > S ||
                      k0 + kTile > S;
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(rows + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = ex2f(fmaf(p[j][e], scale_log2, -((e & 1) ? l2.y : l2.x)));
        if (edge && !visible(q0 + j * 8 + 2 * t + (e & 1),
                             krow + (e >> 1) * 8, S, causal))
          x = 0.f;
        p[j][e] = x;
      }
    }
    // dV += P^T dO
    x3_frags_by_tile<D, kExact>(dva, p, tO, lane);

    // dP^T = V dO^T
    float dp[kSub / 8][4];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
    x3_rows_by_tile<D, kExact, kExact>(dp, tV, tO, warp, lane);

    // dS^T = P^T (dP^T - delta) * scale, delta by column; dK += dS^T Q
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(rows + kSub + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = p[j][e] * (dp[j][e] - ((e & 1) ? d2.y : d2.x)) * scale;
    }
    x3_frags_by_tile<D, kExact>(dka, dp, tQ, lane);
  }

  x3_store_rows<T, D>(dka, dk + base, krow, S, t);
  x3_store_rows<T, D>(dva, dv + base, krow, S, t);
}

// dQ (float32, and bf16 at D = 8): one block of 4 warps per (bh, 64-row
// Q tile), each warp 16 Q rows; K and V stream in kSub-row tiles up to
// the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int S, float scale, float scale_log2, int causal) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr uint32_t kKeep = 2 * kept_half_bytes<D>();
  constexpr uint32_t kSplit = 2 * kSub * pl_row_bytes<D>();
  constexpr uint32_t kRaw = kSub * D * sizeof(T);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* const tQ = tc_smem;            // Q, dO: kept fragments
  unsigned char* const tO = tQ + kKeep;
  unsigned char* const tK = tO + kKeep;         // K, V: streamed planes
  unsigned char* const tV = tK + kSplit;
  unsigned char* const raw = tV + kSplit;       // raw K, V
  const uint32_t sRaw = smem_u32(raw);

  // the last (under causal the heaviest) Q tile of each head first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int qrow = q0 + warp * 16 + (lane >> 2);   // rows qrow, qrow + 8

  // K-side steps: kSub-row tiles up to the diagonal
  const int n_all = (S + kSub - 1) / kSub;
  const int n_it = causal ? min(n_all, (q0 + kTile) / kSub) : n_all;
  auto stage_step = [&](int it) {
    stage_streamed<T, D>(sRaw, k + base, it * kSub, S);
    stage_streamed<T, D>(sRaw + kRaw, v + base, it * kSub, S);
  };

  // Q and dO land raw where split K and V go, and are split once
  stage_kept<T, D>(smem_u32(tK), q + base, q0, S);
  stage_kept<T, D>(smem_u32(tK) + kTile * D * sizeof(T), dout + base, q0, S);
  cp_async_commit();
  stage_step(0);
  cp_async_commit();
  // lse in log2 units and delta of the thread's two rows (0 past S)
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    const size_t at = (size_t)blockIdx.y * S + row;
    lr[r] = row < S ? lse[at] * kLog2e : 0.f;
    dr[r] = row < S ? delta[at] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();
  split_kept<T, D>(tQ, tK);   // Q, then dO

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // step it has landed; step it-1's split tiles are free
    split_streamed<T, D>(tK, raw);   // K, then V
    __syncthreads();   // step it is split; the raw stage is free
    if (it + 1 < n_it) stage_step(it + 1);
    cp_async_commit();

    const int k0 = it * kSub;
    if (causal && k0 > qrow - (lane >> 2) + 15)
      continue;   // every key of the step follows this warp's rows

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x kSub keys each
    float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    x3_rows_by_tile<D, kExact, kExact>(s, tQ, tK, warp, lane);
    x3_rows_by_tile<D, kExact, kExact>(dp, tO, tV, warp, lane);

    // dS = p (dP - delta) * scale, p = 2^(s*scale*log2(e) - lse*log2(e));
    // masked entries (diagonal and ragged tiles only) are 0
    const bool edge = (causal && k0 + kSub > q0) || k0 + kSub > S ||
                      q0 + kTile > S;
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = ex2f(fmaf(s[j][e], scale_log2, -lr[r]));
        if (edge && !visible(qrow + 8 * r, k0 + j * 8 + 2 * t + (e & 1), S,
                             causal))
          x = 0.f;
        dp[j][e] = x * (dp[j][e] - dr[r]) * scale;
      }
    // dQ += dS K
    x3_frags_by_tile<D, kExact>(dqa, dp, tK, lane);
  }

  x3_store_rows<T, D>(dqa, dq + base, qrow, S, t);
}

// The float32 and D = 8 forward keeps Q's fragments in registers up to
// this head dim, in shared memory above it.
constexpr int kFwdRegQ = 64;

// Shared memory of the split-TF32 forward: Q's fragments (D > kFwdRegQ),
// the K and V planes of a step, and the raw step.  Q lands raw where the
// planes go (512 max(D, 32) >= 64 D sizeof(T) bytes).
template <typename T, int D>
__host__ __device__ constexpr size_t fwd_x3_smem() {
  return (D > kFwdRegQ ? (size_t)2 * kept_half_bytes<D>() : 0) +
         (size_t)4 * kSub * pl_row_bytes<D>() +
         (size_t)2 * kSub * D * sizeof(T);
}

// o and lse (float32, and bf16 at D = 8): one block of 4 warps per (bh,
// 64-row Q tile), each warp 16 Q rows; K and V stream in kSub-row steps
// up to the diagonal.  Scores are in natural units (Q is pre-scaled),
// m and p in log2 units.
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int S, float scale,
                    int causal) {
  constexpr bool kExact = sizeof(T) == 2;   // K and V exact in TF32
  constexpr bool kRegQ = D <= kFwdRegQ;
  constexpr uint32_t kKeep = kRegQ ? 0 : 2 * kept_half_bytes<D>();
  constexpr uint32_t kSplit = 2 * kSub * pl_row_bytes<D>();
  constexpr uint32_t kRaw = kSub * D * sizeof(T);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* const tQ = tc_smem;            // Q fragments (D = 128)
  unsigned char* const tK = tQ + kKeep;         // K, V: streamed planes
  unsigned char* const tV = tK + kSplit;
  unsigned char* const raw = tV + kSplit;       // raw K, V
  const uint32_t sRaw = smem_u32(raw);

  // the last (under causal the heaviest) Q tile of each head first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qrow = q0 + warp * 16 + g;   // rows qrow, qrow + 8
  const int wrow = q0 + warp * 16;       // this warp's first row

  // K-side steps: kSub-row tiles up to the diagonal
  const int n_all = (S + kSub - 1) / kSub;
  const int n_it = causal ? min(n_all, (q0 + kTile) / kSub) : n_all;
  auto stage_step = [&](int it) {
    stage_streamed<T, D>(sRaw, k + base, it * kSub, S);
    stage_streamed<T, D>(sRaw + kRaw, v + base, it * kSub, S);
  };

  // Q lands raw where the split K and V go, and is split once, scaled
  stage_kept<T, D>(smem_u32(tK), q + base, q0, S);
  cp_async_commit();
  stage_step(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qh[kRegQ ? D / 8 : 1][4], ql[kRegQ ? D / 8 : 1][4];
  if constexpr (kRegQ) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint4 h, l;
      kept_frag<T, D, false, true>(tK, (warp * (D / 8) + kk) * 32 + lane,
                                   scale, h, l);
      qh[kk][0] = h.x; qh[kk][1] = h.y; qh[kk][2] = h.z; qh[kk][3] = h.w;
      ql[kk][0] = l.x; ql[kk][1] = l.y; ql[kk][2] = l.z; ql[kk][3] = l.w;
    }
  } else {
    constexpr int kFrags = 4 * (D / 8) * 32;
#pragma unroll 8
    for (int f = threadIdx.x; f < kFrags; f += kTcThreads) {
      uint4 h, l;
      kept_frag<T, D, false, true>(tK, f, scale, h, l);
      *reinterpret_cast<uint4*>(tQ + f * 16) = h;
      *reinterpret_cast<uint4*>(tQ + kept_half_bytes<D>() + f * 16) = l;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max (log2 units) and this thread's partial row sums; m starts
  // at the finite NEG_INF so a row with nothing visible yet gives no NaN
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();   // step it has landed; step it-1's split tiles are free
    split_streamed<T, D>(tK, raw);   // K, then V
    __syncthreads();   // step it is split; the raw stage is free
    if (it + 1 < n_it) stage_step(it + 1);
    cp_async_commit();

    const int k0 = it * kSub;
    if (causal && k0 > wrow + 15)
      continue;   // every key of the step follows this warp's rows

    // S = Q K^T: this warp's 16 rows x kSub keys
    float s[kSub / 8][4];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kRegQ) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        x3_rows_step<D, false, kExact>(s, qh[kk], ql[kk], tK, kk, lane);
    } else {
      x3_rows_by_tile<D, false, kExact>(s, tQ, tK, warp, lane);
    }

    // mask the diagonal and ragged steps only (masked scores give p = 0
    // exactly); rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const bool edge = (causal && k0 + kSub - 1 > wrow) || k0 + kSub > S;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge && !visible(qrow + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1),
                             S, causal))
          s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * kLog2e);
      corr[r] = ex2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2f(fmaf(s[j][e], kLog2e, -m[e >> 1]));
        l[e >> 1] += s[j][e];
      }
    // O += P V
    x3_frags_by_tile<D, kExact>(acc, s, tV, lane);
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    l_safe[r] = l[r] > 0.f ? l[r] : 1.f;
  }
  // one IEEE division a row
  const float inv[2] = {1.f / l_safe[0], 1.f / l_safe[1]};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= inv[e >> 1];
  x3_store_rows<T, D>(acc, o + base, qrow, S, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      if (row < S)
        lse[(size_t)blockIdx.y * S + row] = m[r] * kLn2 + logf(l_safe[r]);
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int S, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = fwd_x3_smem<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_x3_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  flash_fwd_x3_kernel<T, D><<<grid, kTcThreads, smem, stream>>>(
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
  constexpr size_t smem = x3_smem<T, D>(true);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_x3_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  flash_bwd_dkv_x3_kernel<T, D><<<grid, kTcThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, S, scale, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int S,
              float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = x3_smem<T, D>(false);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_x3_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  flash_bwd_dq_x3_kernel<T, D><<<grid, kTcThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, scale, scale * kLog2e, causal);
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

// The float32 and D = 8 forward ("simt" by its historical name), on the
// tensor cores in split TF32: float32 at any D, bfloat16 at D = 8 on the
// main paths (every D is built for both).  q, k, v and o 16-byte
// aligned, lse 4-byte aligned; anything else returns an error without
// launching.
int slt_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                  void* o, void* lse, int bh, int s, int d, float scale,
                  int causal, void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15 ||
      (uintptr_t)lse & 3)
    return (int)cudaErrorMisalignedAddress;
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

// The float32 and D = 8 backward ("simt" by its historical name), on the
// tensor cores in split TF32: float32 at any D, bfloat16 at D = 8 on the
// main paths (every D is built for both).  q, k, v, dout and the outputs
// 16-byte aligned, lse and delta 4-byte aligned; anything else returns an
// error without launching.
int slt_flash_bwd_dkv_simt(int dtype, const void* q, const void* k,
                           const void* v, const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int s, int d, float scale, int causal,
                           void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)dk | (uintptr_t)dv) & 15 ||
      ((uintptr_t)lse | (uintptr_t)delta) & 3)
    return (int)cudaErrorMisalignedAddress;
  SLT_DISPATCH(dtype, d,
               (launch_dkv<T, D>(q, k, v, dout, (const float*)lse,
                                 (const float*)delta, dk, dv, bh, s, scale,
                                 causal, (cudaStream_t)stream)));
}

int slt_flash_bwd_dq_simt(int dtype, const void* q, const void* k,
                          const void* v, const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int s, int d,
                          float scale, int causal, void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)dq) & 15 ||
      ((uintptr_t)lse | (uintptr_t)delta) & 3)
    return (int)cudaErrorMisalignedAddress;
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
