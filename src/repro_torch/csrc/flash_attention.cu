// Causal, sliding-window or unmasked GQA attention, forward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `flash_attention_fwd` of
// src/repro/kernels/flash_attention/kernel.py:28-129. For every batch row b,
// query head h (kv head h / (H / KH)) and query position i < S:
//   s_j = scale * <q[b,i,h,:], k[b,j,kvh,:]>  for the keys j < T that are
//         live: j <= i when causal, i - j < window when window > 0; every
//         j < T when neither (causal = 0: whisper's encoder, S = T = 1500,
//         and its cross-attention, S queries over T = 1500 keys, S > T
//         included), where the loops visit every key tile and only the
//         ragged last one (1500 = 23 * 64 + 28) is masked, by j < T;
//   out[b,i,h,:] = sum_j softmax_j(s) v[b,j,kvh,:]
// with the softmax state (m, l) and the accumulator in float32 and the
// output in q's type (float32 or bfloat16). A row with no live key gives 0
// (l is clamped to 1e-30, as on the TPU). Any S and T: ragged tails are
// masked here, nothing is padded (the TPU kernel asks S % 512 == 0 past 512).
// The tensors are in the model's layout, q (B, S, H, D), k (B, T, KH, D),
// v (B, T, KH, DV) and out (B, S, H, DV), so a head's rows are D (or DV)
// contiguous elements H*D (or KH*D, KH*DV, H*DV) apart and the caller
// transposes and copies nothing (the TPU kernel takes (B, H, S, D)). DV is
// D but for DeepSeek-V2's latent attention, whose q/k rows are 192 wide
// (128 + 64 rotary) and whose v rows are 128 (the TPU kernel sizes v and
// the output by D, and cannot run it). Offsets inside one batch row are
// 32-bit (S*H*D and T*KH*D below 2^31): with 64-bit row strides ptxas
// holds the D = 256 instances to 128 registers and the kernel runs about
// 14 % slower.
//
// The log-sum-exp. When the caller passes a non-null `lse` (the autograd
// forward does; serving passes null and does no extra work), both kernels
// also write, for every row, L_i = m_i + log(max(l_i, 1e-30)) as float32
// (B, H, S): the natural log of the softmax's denominator over the live
// keys, in the units of the scaled scores scale * <q_i, k_j>, so that
// P_ij = exp(scale * <q_i, k_j> - L_i) (the backward's P). The float32
// kernel's m and l are in those units; the bf16 kernel's m is in log2
// units (scale * log2(e) folded into its exp2f), so it writes
// (m + log2(max(l, 1e-30))) * ln 2. A row with no live key keeps
// m = -1e30 and l = 0: its L is about -1e30 (-6.9e29 from the bf16
// kernel), and the backward masks its pairs explicitly.
//
// The float32 output. With a non-null `out32` (the autograd forward of the
// bf16 route passes one) the bf16 kernel also writes O in float32, before
// its rounding to bf16, into out32 (B, S, H, DV): the backward's delta =
// rowsum(dO * O) taken from the bf16 O can sit a few 1e-2 of 1 + |g| from
// the reference's where a row's delta is large against its largest P.
//
// Two kernels, chosen by the input type:
//   - float32: the CUDA-core kernel below (`flash_fwd_kernel`), whose checks
//     against the plain version are held at 2e-5; tensor cores reach that
//     only from bf16/fp16 inputs (TF32 rounds the inputs to 10 mantissa
//     bits, about 1e-3 off), so float32 stays on CUDA cores;
//   - bfloat16, what serving runs: the tensor-core kernel
//     (`tc::flash_fwd_bf16_kernel`).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile fills kBK rows of Q too");

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  o[0] = __low2float(lo);
  o[1] = __high2float(lo);
  o[2] = __low2float(hi);
  o[3] = __high2float(hi);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// rows [row0, row0 + kBK) of a (len, D) matrix whose rows lie `stride`
// elements apart into shared memory with pitch D + 1; rows at or past `len`
// are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int stride, int row0, int len,
                                          float* dst) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < kBK * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int d = (i % kVecs) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < len) load4(src + (row0 + r) * stride + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * (D + 1) + d + e] = x[e];
  }
}

// The float32 route: the CUDA-core kernel.
//
// What bounds it: operations. Per (q, k) pair the kernel does 2*DQK flops
// for the score and 2*DV for the weighted sum, against DQK + DV elements of
// K and V that are re-read from shared memory by every query row. At the
// full-width prefill (S = 4096, window 2048, H = 16, D = 256) that is about
// 103 GFLOP per call against about 71 MB of device memory: compute-bound on
// the tensor cores' 989 TFLOP/s. This first design is deliberately plain:
// CUDA-core FMAs, no mma/wgmma, no TMA. What it does:
//   - one block of 256 threads per (64 query rows, head, batch row); K and V
//     come in tiles of 64 keys, and only the tiles that hold a live key for
//     some row of the block are visited (the TPU kernel's pl.when skip);
//   - Q, K, V and the probability tile P sit in shared memory as float32
//     with a row pitch of DQK + 1 (Q, K) and DV + 1 (V), so the 16 lanes
//     that read 16 different key rows hit 16 different banks; at D = 256
//     that is 214 KB, one block per SM;
//   - thread (ty, tx) of a 16 x 16 grid owns query rows 4*ty..4*ty+3 and
//     key columns tx + 16*j of the score tile, and the output columns
//     tx + 16*c of the same rows, so the online-softmax row statistics are
//     reduced with xor shuffles inside a half-warp and every thread
//     rescales only its own accumulator;
//   - blocks are issued last query block first: under a causal mask without
//     a window those have the most tiles, and the short ones fill the tail.
// The value head dim DV may differ from the query/key head dim DQK
// (DeepSeek-V2's latent attention: 192 and 128); the output has DV columns.
// mma.sync / wgmma, TMA loads into a ring of tiles and serving all the query
// heads of one kv head from one K/V tile (MQA) are later changes.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int heads, int kv_heads,
                     int q_len, int k_len, int causal, int window,
                     float scale) {
  constexpr int LDQ = DQK + 1;
  constexpr int LDV = DV + 1;
  constexpr int kOut = DV / 16;  // output columns per thread
  static_assert(DQK % 4 == 0 && DV % 16 == 0, "head dims");
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LDQ;
  float* sV = sK + kBK * LDQ;
  float* sP = sV + kBK * LDV;  // kBQ x (kBK + 1)

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qb * kBQ;
  const int q_stride = heads * DQK;  // between positions
  const int k_stride = kv_heads * DQK;
  const int v_stride = kv_heads * DV;
  const int o_stride = heads * DV;
  const T* qh = q + (long long)b * q_len * q_stride + (long long)h * DQK;
  const T* kh = k + (long long)b * k_len * k_stride + (long long)kvh * DQK;
  const T* vh = v + (long long)b * k_len * v_stride + (long long)kvh * DV;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, DQK>(qh, q_stride, q0, q_len, sQ);

  float acc[kRows][kOut];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  // key tiles that hold a live key for some row of this block
  const int q_hi = min(q0 + kBQ, q_len);  // rows [q0, q_hi) are real
  const int k_end = causal ? min(k_len, q_hi) : k_len;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, DQK>(kh, k_stride, k0, k_len, sK);
    load_tile<T, DV>(vh, v_stride, k0, k_len, sV);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty * kRows + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      bool live[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = kpos < k_len && (!causal || kpos <= qpos) &&
                  (window <= 0 || qpos - kpos < window);
        s[i][j] = live[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        sP[(ty * kRows + i) * (kBK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p[i] = sP[(ty * kRows + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float x = sV[kk * LDV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], x, acc[i][c]);
      }
    }
  }

  T* oh = out + (long long)b * q_len * o_stride + (long long)h * DV;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= q_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      oh[row * o_stride + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * heads + h) * q_len + row] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int heads, int kv_heads,
                   int q_len, int k_len, int causal, int window, float scale,
                   cudaStream_t stream) {
  const int smem = (int)sizeof(float) * ((kBQ + kBK) * (DQK + 1) +
                                         kBK * (DV + 1) + kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<T, DQK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, heads, kv_heads,
      q_len, k_len, causal, window, scale);
  return cudaGetLastError();
}

// The (q/k, v) head-dim pairs of the float32 route: the square ones, MLA's
// (192, 128) at full width and (24, 16) in the small test models.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* lse, int batch, int heads, int kv_heads,
                     int q_len, int k_len, int head_dim, int v_head_dim,
                     int causal, int window, float scale, cudaStream_t s) {
#define FLASH_F32_CASE(DQK, DV)                                            \
  if (head_dim == DQK && v_head_dim == DV)                                 \
    return launch<T, DQK, DV>(q, k, v, out, lse, batch, heads, kv_heads,  \
                              q_len, k_len, causal, window, scale, s);
  FLASH_F32_CASE(16, 16)
  FLASH_F32_CASE(64, 64)
  FLASH_F32_CASE(128, 128)
  FLASH_F32_CASE(256, 256)
  FLASH_F32_CASE(192, 128)
  FLASH_F32_CASE(24, 16)
#undef FLASH_F32_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// The bfloat16 route: the tensor-core kernel.
//
// What bounds it: operations, 4*D flops per live (q, k) pair against 2*D
// bf16 elements of K and V that every query row of a block shares. At the
// full-width prefill (B = 1, H = 16, KH = 1, S = 4096, window 2048, D = 256)
// that is 103 GFLOP against 71 MB of device memory, about 0.10 ms at the
// card's 989 TFLOP/s dense bf16 rate. The design is FlashAttention-2's
// tiling on Hopper's warpgroup tensor-core instructions:
//   - a block of two warpgroups (256 threads) takes 128 query rows of one
//     (batch row, head), 64 rows a warpgroup; its O accumulator (64 x D
//     float32, 128 registers a thread at D = 256) and row statistics live
//     in registers;
//   - S = Q K^T is wgmma m64n64k16 with Q and K both read from shared
//     memory; O += P V is wgmma m64nDk16 with P taken from the S
//     accumulators as the register A operand (the accumulator and the A
//     fragment share their row/column ownership, so P never touches shared
//     memory) and V read from shared memory as an MN-major B operand;
//     bf16 in, float32 accumulate;
//   - Q (once) and K, V in tiles of 64 keys come by TMA into a ring of two
//     stages, each load completing on an mbarrier with its byte count; K
//     and V of a tile have barriers of their own, so Q K^T of tile j starts
//     before its V has landed, and tile j + 1 is in flight while tile j is
//     computed. Keys past T arrive as zeros (TMA fills out-of-range rows);
//   - operands stay bf16 in shared memory in the layout wgmma reads: column
//     blocks of 64 elements (128-byte rows, the 128-byte swizzle) at D of
//     64, 128, 192 and 256, 32-byte rows with the 32-byte swizzle at D = 16,
//     written so by TMA itself, one box a column block, every box of a
//     tile completing on the tile's mbarrier with their summed byte count.
//     Q 64 KB and two stages of K and V 128 KB: 192 KB at D = 256, one
//     block an SM; half of that at D = 128 (Q 32 KB, the stages 64 KB);
//   - the value head dim DV may differ from the q/k head dim DQK: at
//     DeepSeek-V2's latent attention (192, 128) Q K^T runs 12 k-steps over
//     three column blocks and P V is m64n128k16 over two; Q 48 KB, two K
//     stages 48 KB, two V stages 32 KB (128 KB); the output has DV columns;
//   - dead tiles are skipped by the loop bounds (keys from
//     max(0, q0 - window + 1) to min(T, q0 + 128)); the element-wise mask
//     runs only on tiles that hold a masked pair for some row of the block
//     (the diagonal, the window's edge and the ragged end), and a
//     warpgroup skips a tile in which every pair of its 64 rows is masked;
//   - the online softmax runs in float32 on the accumulator fragments:
//     scale * log2(e) is folded into one exp2f, row statistics are reduced
//     over the four lanes that share a row with two xor shuffles, masked
//     pairs give p = 0, so a row with no live key ends with l = 0 and an
//     output of 0 (l clamped to 1e-30) as in the float32 kernel; l sums the
//     p that the PV product sees;
//   - P enters the PV product as bf16: rounded once in a tile whose every
//     pair is live, and as three bf16 terms (hi + mid + lo, float32
//     precision, three products) in a tile with a masked pair. A row with
//     fewer than 64 live keys meets only such tiles, and its output, the
//     mean of a few v, can reach |out| >= 4, where one bf16 step is 3.1e-2:
//     rounding its weights to bf16 moved such outputs one step away from
//     the plain version's;
//   - the output is divided by max(l, 1e-30), rounded to bf16 (to nearest
//     even) and staged through the free K/V stages with rows padded by 16
//     bytes, so that each row leaves in 16-byte stores;
//   - blocks are issued last query block first, as in the float32 kernel.
// One thread issues the TMA loads between the tiles; warp-specialised
// producers, a deeper ring and overlapping one warpgroup's softmax with the
// other's products are later changes.
namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBQ = 128;       // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kStages = 2;     // K/V tiles in the ring
constexpr float kNegInf = -1e30f;

// Shared memory of one block at head dims (DQK, DV), in column blocks of
// CK (Q, K) and CV (V) elements (one swizzled row of RBK / RBV bytes): Q
// (kBQ rows x DQK / CK blocks), kStages K tiles (kBK rows x DQK / CK
// blocks), kStages V tiles (kBK rows x DV / CV blocks), five mbarriers.
template <int DQK, int DV>
struct Layout {
  static constexpr int CK = DQK < 64 ? DQK : 64;
  static constexpr int CV = DV < 64 ? DV : 64;
  static constexpr int RBK = 2 * CK;
  static constexpr int RBV = 2 * CV;
  static constexpr int kSwizzleK = RBK == 128 ? 1 : 3;  // wgmma: 128B, 32B
  static constexpr int kSwizzleV = RBV == 128 ? 1 : 3;
  static constexpr int kQBytes = kBQ * DQK * 2;
  static constexpr int kKBytes = kBK * DQK * 2;
  static constexpr int kVBytes = kBK * DV * 2;
  static constexpr int kBarOffset = kQBytes + kStages * (kKBytes + kVBytes);
  static constexpr int kBytes = kBarOffset + 64 + 1024;  // + 1024-alignment
  static_assert(DQK % CK == 0 && DV % CV == 0, "whole column blocks");
  static_assert((RBK == 128 || RBK == 32) && (RBV == 128 || RBV == 32),
                "swizzle rows of 128 or 32 bytes");
  static_assert(kBQ * (DV + 8) * 2 <= kStages * (kKBytes + kVBytes),
                "the output staging fits in the K/V stages");
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          float* __restrict__ out32, int heads, int kv_heads,
                          int q_len, int k_len, int causal, int window,
                          float scale_log2) {
  using L = Layout<DQK, DV>;
  constexpr int CK = L::CK, CV = L::CV, RBK = L::RBK, RBV = L::RBV;
  constexpr int kNT = kBK / 8;  // score n-tiles of 8 keys
  constexpr int kDT = DV / 8;   // output n-tiles of 8 columns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = base;
  unsigned char* sK = sQ + L::kQBytes;
  unsigned char* sV = sK + kStages * L::kKBytes;
  // barrier 0: Q; 1 + s: K of stage s; 1 + kStages + s: V of stage s
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  const uint32_t bar_q = smem_addr(bars);

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qb * kBQ;
  const int warpgroup = threadIdx.x / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g0 = q0 + 64 * warpgroup;  // the warpgroup's first query row
  const int w0 = q0 + 16 * warp;       // the warp's first query row
  const int r_lo = w0 + lane / 4;      // this thread's rows r_lo, r_lo + 8

  // key tiles that hold a live key for some row of this block
  const int q_hi = min(q0 + kBQ, q_len);
  const int k_end = causal ? min(k_len, q_hi) : k_len;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  // K and V of tile j into stage j % kStages (one thread)
  auto load_tile = [&](int j) {
    const int s = j % kStages;
    const int k0 = k_begin + j * kBK;
    const uint32_t bk = smem_addr(bars + 1 + s);
    const uint32_t bv = smem_addr(bars + 1 + kStages + s);
    mbar_expect_tx(bk, L::kKBytes);
    for (int c = 0; c < DQK / CK; ++c)
      tma_load(smem_addr(sK + s * L::kKBytes + c * kBK * RBK), &tm_k, bk,
               c * CK, kvh, k0, b);
    mbar_expect_tx(bv, L::kVBytes);
    for (int c = 0; c < DV / CV; ++c)
      tma_load(smem_addr(sV + s * L::kVBytes + c * kBK * RBV), &tm_v, bv,
               c * CV, kvh, k0, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * kStages; ++i) mbar_init(smem_addr(bars + i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
    for (int c = 0; c < DQK / CK; ++c)
      tma_load(smem_addr(sQ + c * kBQ * RBK), &tm_q, bar_q, c * CK, h, q0, b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_tile(j);
  }

  float o[4 * kDT];  // n-tile t: o[4 t + e], as the m64nDk16 accumulator
  float sc[4 * kNT];
#pragma unroll
  for (int i = 0; i < 4 * kDT; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) sc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int parity = (j / kStages) & 1;
    const int k0 = k_begin + j * kBK;
    const unsigned char* tK = sK + s * L::kKBytes;
    const unsigned char* tV = sV + s * L::kVBytes;
    // every pair of the warpgroup's 64 rows with this tile's keys is masked
    const bool dead = g0 >= q_len || (causal && k0 > g0 + 63) ||
                      (window > 0 && g0 - (k0 + kBK - 1) >= window);
    // every pair of the block's rows with this tile's keys is live
    const bool full = k0 + kBK <= k_len &&
                      (!causal || k0 + kBK - 1 <= q0) &&
                      (window <= 0 || q0 + kBQ - 1 - k0 < window);

    mbar_wait(smem_addr(bars + 1 + s), parity);  // K_j has landed
    if (!dead) {
      // S = Q K^T: 64 rows x 64 keys per warpgroup, DQK / 16 k-steps of 32
      // bytes inside a swizzled row, CK / 16 of them per column block
#pragma unroll
      for (int i = 0; i < 4 * kNT; ++i) pin(sc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const int c = kk / (CK / 16);
        const int off = (kk % (CK / 16)) * 32;
        wgmma_ss_n64(
            sc,
            smem_desc(
                smem_addr(sQ + c * kBQ * RBK + 64 * warpgroup * RBK + off), 16,
                8 * RBK, L::kSwizzleK),
            smem_desc(smem_addr(tK + c * kBK * RBK + off), 16, 8 * RBK,
                      L::kSwizzleK),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 4 * kNT; ++i) pin(sc[i]);

      // online softmax in log2 units; sc[4 t + e] is row r_lo + 8 (e / 2),
      // key k0 + 8 t + 2 (lane % 4) + e % 2
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * t + e] * scale_log2;
          if (!full) {
            const int row = r_lo + 8 * (e / 2);
            const int key = k0 + 8 * t + 2 * (lane % 4) + e % 2;
            const bool live = key < k_len && (!causal || key <= row) &&
                              (window <= 0 || row - key < window);
            x = live ? x : kNegInf;
          }
          sc[4 * t + e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
      }
      // sc becomes p as the PV product will see it: rounded to bf16 in a
      // full tile, float32 otherwise (see the PV product)
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[4 * t + e];
          const float pe = x == kNegInf ? 0.f : exp2f(x - m[e / 2]);
          sc[4 * t + e] = full ? __bfloat162float(__float2bfloat16_rn(pe)) : pe;
          sum[e / 2] += sc[4 * t + e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
#pragma unroll
      for (int t = 0; t < kDT; ++t) {
        o[4 * t + 0] *= alpha[0];
        o[4 * t + 1] *= alpha[0];
        o[4 * t + 2] *= alpha[1];
        o[4 * t + 3] *= alpha[1];
      }
    }
    mbar_wait(smem_addr(bars + 1 + kStages + s), parity);  // V_j has landed
    if (!dead) {
      // O += P V: 64 rows x DV per warpgroup; a k-step is 16 keys, two
      // 8-row swizzle atoms (stride 8 RBV), the DV columns are DV / CV
      // column blocks kBK * RBV bytes apart. P enters as bf16 terms: one in a full
      // tile; three (hi + mid + lo, float32 precision) in a tile with a
      // masked pair, which holds every key of a row with fewer than 64
      // live keys, so that such rows, whose outputs are the largest, get
      // the plain version's float32 weights
      const int terms = full ? 1 : 3;
      for (int term = 0; term < terms; ++term) {
        // P as the A operand: k-step kk (keys 16 kk .. 16 kk + 15) is
        // n-tiles 2 kk and 2 kk + 1 of S; sc keeps what is left of p
        uint32_t p[kBK / 16][4];
#pragma unroll
        for (int t = 0; t < kNT; ++t)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t packed =
                pack_bf16(sc[4 * t + 2 * i], sc[4 * t + 2 * i + 1]);
            const float2 part = unpack_bf16(packed);
            sc[4 * t + 2 * i] -= part.x;
            sc[4 * t + 2 * i + 1] -= part.y;
            p[t / 2][2 * (t % 2) + i] = packed;
          }
#pragma unroll
        for (int i = 0; i < 4 * kDT; ++i) pin(o[i]);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) pin(p[kk][i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs<DV>(o, p[kk],
                       smem_desc(smem_addr(tV + 16 * kk * RBV), kBK * RBV,
                                 8 * RBV, L::kSwizzleV));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < 4 * kDT; ++i) pin(o[i]);
      }
    }
    __syncthreads();  // stage s is no longer read
    if (threadIdx.x == 0 && j + kStages < n_tiles) load_tile(j + kStages);
  }

  // L in natural-log units (see the note at the top), by one lane a row
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r_lo + 8 * i < q_len)
        lse[((long long)b * heads + h) * q_len + r_lo + 8 * i] =
            (m[i] + log2f(fmaxf(l[i], 1e-30f))) * 0.6931471805599453f;
  }
  // out = O / max(l, 1e-30) in bf16, staged through the K/V stages (no
  // longer read, and nothing is in flight) with rows padded by 16 bytes
  constexpr int P = DV + 8;
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  bf16* stage = reinterpret_cast<bf16*>(sK) + 16 * warp * P;
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(stage + (lane / 4 + 8 * i) * P + 8 * t +
                                   2 * (lane % 4)) =
          pack_bf16(o[4 * t + 2 * i] * inv[i], o[4 * t + 2 * i + 1] * inv[i]);
  __syncwarp();
  const int o_stride = heads * DV;  // between positions
  bf16* oh = out + (long long)b * q_len * o_stride + (long long)h * DV;
  if (out32 != nullptr) {  // O before its rounding, from the registers
    float* o32 = out32 + (long long)b * q_len * o_stride + (long long)h * DV;
#pragma unroll
    for (int t = 0; t < kDT; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r_lo + 8 * i < q_len)
          *reinterpret_cast<float2*>(o32 + (r_lo + 8 * i) * o_stride +
                                     8 * t + 2 * (lane % 4)) =
              make_float2(o[4 * t + 2 * i] * inv[i],
                          o[4 * t + 2 * i + 1] * inv[i]);
  }
  constexpr int kChunks = DV / 8;  // 16-byte chunks of a row
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    if (w0 + r < q_len)
      *reinterpret_cast<uint4*>(oh + (w0 + r) * o_stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * P + c * 8);
  }
}

template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, float* out32, int batch, int heads,
                   int kv_heads, int q_len, int k_len, int causal, int window,
                   float scale, cudaStream_t stream) {
  using L = Layout<DQK, DV>;
  // a runtime call first: it makes the device's primary context current
  // on this thread (autograd's worker, recomputing a checkpointed forward,
  // may have none yet), which cuTensorMapEncodeTiled needs
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, batch, q_len, heads, DQK, L::CK, kBQ) ||
      !tensor_map(&tk, k, batch, k_len, kv_heads, DQK, L::CK, kBK) ||
      !tensor_map(&tv, v, batch, k_len, kv_heads, DV, L::CV, kBK))
    return cudaErrorInvalidValue;
  const dim3 grid((q_len + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_bf16_kernel<DQK, DV><<<grid, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, out32, heads, kv_heads,
      q_len, k_len, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t attributes(int* regs, int* local_bytes, int* static_smem,
                       int* dynamic_smem) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, flash_fwd_bf16_kernel<DQK, DV>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem = Layout<DQK, DV>::kBytes;
  return cudaSuccess;
}

// The (q/k, v) head-dim pairs of the tensor-core route: the square ones and
// MLA's (192, 128); rows must be whole 16-byte multiples in swizzle rows of
// 32 or 128 bytes, so the small models' (24, 16) is refused.
#define FLASH_BF16_PAIRS(X) \
  X(16, 16) X(64, 64) X(128, 128) X(256, 256) X(192, 128)

}  // namespace tc

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// q (B, S, H, head_dim), k (B, T, KH, head_dim), v (B, T, KH, v_head_dim)
// and out (B, S, H, v_head_dim): contiguous, 16-byte aligned, of type
// float32 (is_bf16 = 0: the CUDA-core kernel) or bfloat16 (is_bf16 = 1:
// the tensor-core kernel); H % KH == 0 (any group, as smollm's 9 / 3 or
// Qwen2-VL's 28 / 4); (head_dim, v_head_dim) one of (16, 16) (the small
// test models), (64, 64) (smollm's and granite's), (128, 128) (qwen2.5's,
// olmo's, Qwen2-VL's), (256, 256) (RecurrentGemma's and gemma3's),
// (192, 128) (DeepSeek-V2-Lite's latent attention) and, on the float32
// route only, (24, 16) (the small DeepSeek's); S*H and T*KH times either
// head dim below 2^31; window <= 0 means no window. A case that the chosen
// kernel does not take returns cudaErrorInvalidValue: neither kernel
// stands in for the other. `lse` is null, or float32 (B, H, S) for the
// log-sum-exp of every row; `out32` is null, or on the bf16 route float32
// like out for O before its rounding (see the notes at the top).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   void* out32, int batch, int heads,
                                   int kv_heads,
                                   int q_len, int k_len, int head_dim,
                                   int v_head_dim, int causal, int window,
                                   float scale, int is_bf16, void* stream) {
  const long long widest = head_dim > v_head_dim ? head_dim : v_head_dim;
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 ||
      kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 || k_len <= 0 ||
      head_dim <= 0 || v_head_dim <= 0 ||
      (long long)q_len * heads * widest >= (1LL << 31) ||
      (long long)k_len * kv_heads * widest >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* o32 = static_cast<float*>(out32);
  if (!is_bf16 && o32 != nullptr) return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return (int)dispatch<float>(q, k, v, out, l, batch, heads, kv_heads,
                                q_len, k_len, head_dim, v_head_dim, causal,
                                window, scale, s);
#define FLASH_BF16_LAUNCH(DQK, DV)                                         \
  if (head_dim == DQK && v_head_dim == DV)                                 \
    return (int)tc::launch<DQK, DV>(q, k, v, out, l, o32, batch, heads,   \
                                    kv_heads, q_len, k_len, causal, window, \
                                    scale, s);
  FLASH_BF16_PAIRS(FLASH_BF16_LAUNCH)
#undef FLASH_BF16_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel's resources at one head-dim pair: registers a
// thread, local (spilled) bytes a thread, static and dynamic shared memory a
// block.
extern "C" int flash_attention_bf16_attributes(int head_dim, int v_head_dim,
                                               int* regs, int* local_bytes,
                                               int* static_smem,
                                               int* dynamic_smem) {
#define FLASH_BF16_ATTRIBUTES(DQK, DV)                                  \
  if (head_dim == DQK && v_head_dim == DV)                              \
    return (int)tc::attributes<DQK, DV>(regs, local_bytes, static_smem, \
                                        dynamic_smem);
  FLASH_BF16_PAIRS(FLASH_BF16_ATTRIBUTES)
#undef FLASH_BF16_ATTRIBUTES
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
