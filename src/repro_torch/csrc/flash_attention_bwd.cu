// Causal, sliding-window or unmasked GQA attention, backward, for Hopper
// (sm_90a).
//
// The TPU package has no backward kernel: its gradient is the custom VJP
// `_flash_bwd` of src/repro/kernels/flash_attention/ops.py:42-48, which
// recomputes the attention through the materialized reference and
// differentiates that. This is the gradient of the forward kernels of
// flash_attention.cu, with the same mask: for every batch row b, query head
// h (kv head h / (H / KH)), query position i < S and key position j < T,
// the pair (i, j) is live when j <= i (causal), i - j < window (window > 0)
// and always when neither. With s_ij = scale * <q_i, k_j>, the forward's
// log-sum-exp L_i over the live keys, P_ij = exp(s_ij - L_i) (0 for a dead
// pair), the output O and its cotangent dO:
//   delta_i = <dO_i, O_i>
//   dP_ij   = <dO_i, v_j>
//   dS_ij   = P_ij (dP_ij - delta_i)
//   dQ_i    = scale * sum_j dS_ij k_j
//   dK_j    = scale * sum_{i, heads of the group} dS_ij q_i
//   dV_j    = sum_{i, heads of the group} P_ij dO_i
// in float32 whatever the input type, the gradients stored in the input
// type (float32 or bfloat16, rounded to nearest even). A row with no live
// key (only when T < S with a window) has P = 0 everywhere: the forward
// kernels give 0 there, so its gradient is 0.
//
// What bounds it: operations. Per live (i, j) the three kernels below do
// 16 D flops (the pre-pass recomputes s: 2 D; the dK/dV kernel s, dP, dV
// and dK: 8 D; the dQ kernel s, dP and dQ: 6 D), four times the forward's
// 4 D, against q, k, v, o, dO and the three gradients read or written once.
// At smollm-135m's training shape (B 8, H 9, KH 3, S 2048, D 64, causal)
// that is 1.55e11 flops against 0.2 GB. This first design is FlashAttention-
// 2's deterministic backward on the CUDA cores, with no atomics:
//   (a) `flash_bwd_prep_kernel`, one block per (64 query rows, head, batch
//       row): recompute L_i over the live keys with the forward's online
//       softmax (and its clamp of the denominator to 1e-30) and
//       delta_i = <dO_i, O_i>, into a float32 scratch (B, H, S) each. The
//       forward kernels stay as they are (they keep no L);
//   (b) `flash_bwd_dkdv_kernel`, one block per (key tile, kv head, batch
//       row): K and V of the tile stay in shared memory while the block
//       walks every query head of the group and every query tile that holds
//       a live pair for the tile; dK and dV accumulate in registers, so
//       GQA's sum over the group needs no atomics;
//   (c) `flash_bwd_dq_kernel`, one block per (query tile, head, batch row):
//       walks the live key tiles and accumulates dQ in registers.
// Each block is a 16 x 16 grid of threads, as the float32 forward kernel's:
// thread (ty, tx) owns rows ty * R .. ty * R + R - 1 and columns tx + 16 c
// of every tile, operands sit in shared memory as float32 with an odd row
// pitch (D + 1), so the 16 lanes that read 16 rows hit 16 banks, and row
// statistics reduce with xor shuffles inside a half-warp. Key tiles are 64
// keys up to D = 128 and 32 at D = 256, so that the tiles of (b) and (c) fit
// in the 227 KB of one block; query tiles are 64 rows. Dead tiles are
// skipped by the loop bounds, as in the forward kernels. Offsets inside one
// batch row are 32-bit, as in the forward (S*H*D and T*KH*D below 2^31).
// Tensor cores (mma.sync or wgmma for bf16), TMA and the log-sum-exp kept
// by the forward are later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kBQ = 64;        // query rows a tile
constexpr float kNegInf = -1e30f;

// keys a tile: the tiles of D = 256 are halved to fit in shared memory
template <int D>
struct KeyTile {
  static constexpr int value = D <= 128 ? 64 : 32;
};

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

// rows [row0, row0 + ROWS) of a (len, D) matrix whose rows lie `stride`
// elements apart into shared memory with pitch D + 1, as float32; rows at
// or past `len` are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int stride, int row0, int len,
                                          float* dst) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int d = (i % kVecs) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < len) load4(src + (row0 + r) * stride + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * (D + 1) + d + e] = x[e];
  }
}

__device__ __forceinline__ bool live_pair(int qpos, int kpos, int q_len,
                                          int k_len, int causal,
                                          int window) {
  return qpos < q_len && kpos < k_len && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// (a) L and delta of 64 query rows of one (batch row, head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ lse, float* __restrict__ delta,
                          int heads, int kv_heads, int q_len, int k_len,
                          int causal, int window, float scale) {
  constexpr int kBK = 64;
  constexpr int LD = D + 1;
  constexpr int kRows = kBQ / 16;
  constexpr int kCols = kBK / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qb * kBQ;
  const int q_stride = heads * D;
  const int k_stride = kv_heads * D;
  const long long q_base = (long long)b * q_len * q_stride + (long long)h * D;
  const T* kh = k + (long long)b * k_len * k_stride + (long long)kvh * D;
  const long long row_base = ((long long)b * heads + h) * q_len;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  // delta: four lanes a row, each over every fourth vector of 4 elements
  {
    const int r = threadIdx.x / 4;
    const int part = threadIdx.x % 4;
    const int row = q0 + r;
    float sum = 0.f;
    if (row < q_len) {
      for (int d = part * 4; d < D; d += 16) {
        float x[4], y[4];
        load4(o + q_base + row * q_stride + d, x);
        load4(dout + q_base + row * q_stride + d, y);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum = fmaf(x[e], y[e], sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0 && row < q_len) delta[row_base + row] = sum;
  }

  load_tile<T, D, kBQ>(q + q_base, q_stride, q0, q_len, sQ);
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int q_hi = min(q0 + kBQ, q_len);
  const int k_end = causal ? min(k_len, q_hi) : k_len;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, D, kBK>(kh, k_stride, k0, k_len, sK);
    __syncthreads();
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
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
        live[j] = live_pair(qpos, k0 + tx + 16 * j, q_len, k_len, causal,
                            window);
        s[i][j] = live[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sum += live[j] ? expf(s[i][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      if (row < q_len) lse[row_base + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

// (b) dK and dV of one key tile of one (batch row, kv head): the sum over
// the group's query heads and their live query tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int heads, int kv_heads,
                          int q_len, int k_len, int causal, int window,
                          float scale) {
  constexpr int kBK = KeyTile<D>::value;
  constexpr int LD = D + 1;
  constexpr int LP = kBQ + 1;
  constexpr int kRows = kBK / 16;  // key rows a thread
  constexpr int kCols = kBQ / 16;  // query columns a thread
  constexpr int kOut = D / 16;     // gradient columns a thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;   // kBK x LP: P transposed
  float* sdS = sP + kBK * LP;   // kBK x LP: dS transposed
  float* sL = sdS + kBK * LP;   // kBQ
  float* sD = sL + kBQ;         // kBQ

  const int k0 = blockIdx.x * kBK;  // the causal mask's longest first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  const int q_stride = heads * D;
  const int k_stride = kv_heads * D;
  const long long k_base =
      (long long)b * k_len * k_stride + (long long)kvh * D;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, D, kBK>(k + k_base, k_stride, k0, k_len, sK);
  load_tile<T, D, kBK>(v + k_base, k_stride, k0, k_len, sV);

  float acc_k[kRows][kOut], acc_v[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      acc_k[i][c] = 0.f;
      acc_v[i][c] = 0.f;
    }

  // query rows with a live pair for some key of the tile
  const int k_hi = min(k0 + kBK, k_len);
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(q_len, k_hi - 1 + window) : q_len;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long q_base =
        (long long)b * q_len * q_stride + (long long)h * D;
    const long long row_base = ((long long)b * heads + h) * q_len;
    for (int q0 = (q_begin / kBQ) * kBQ; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // the previous query tile is no longer read
      load_tile<T, D, kBQ>(q + q_base, q_stride, q0, q_len, sQ);
      load_tile<T, D, kBQ>(dout + q_base, q_stride, q0, q_len, sdO);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        sL[threadIdx.x] = row < q_len ? lse[row_base + row] : 0.f;
        sD[threadIdx.x] = row < q_len ? delta[row_base + row] : 0.f;
      }
      __syncthreads();

      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = 0.f;
          dp[i][j] = 0.f;
        }
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[kRows], vv[kRows], qv[kCols], ov[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = sK[(ty * kRows + i) * LD + d];
          vv[i] = sV[(ty * kRows + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qv[j] = sQ[(tx + 16 * j) * LD + d];
          ov[j] = sdO[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kpos = k0 + ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = tx + 16 * j;
          const float p =
              live_pair(q0 + col, kpos, q_len, k_len, causal, window)
                  ? expf(s[i][j] * scale - sL[col])
                  : 0.f;
          sP[(ty * kRows + i) * LP + col] = p;
          sdS[(ty * kRows + i) * LP + col] = p * (dp[i][j] - sD[col]);
        }
      }
      __syncthreads();  // P and dS are complete

#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        float p[kRows], ds[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          p[i] = sP[(ty * kRows + i) * LP + qq];
          ds[i] = sdS[(ty * kRows + i) * LP + qq];
        }
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
          const float go = sdO[qq * LD + tx + 16 * c];
          const float x = sQ[qq * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc_v[i][c] = fmaf(p[i], go, acc_v[i][c]);
            acc_k[i][c] = fmaf(ds[i], x, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + ty * kRows + i;
    if (row >= k_len) continue;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const long long at = k_base + row * k_stride + tx + 16 * c;
      dk[at] = from_f32<T>(acc_k[i][c] * scale);
      dv[at] = from_f32<T>(acc_v[i][c]);
    }
  }
}

// (c) dQ of 64 query rows of one (batch row, head).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int heads, int kv_heads, int q_len, int k_len,
                        int causal, int window, float scale) {
  constexpr int kBK = KeyTile<D>::value;
  constexpr int LD = D + 1;
  constexpr int LS = kBK + 1;
  constexpr int kRows = kBQ / 16;  // query rows a thread
  constexpr int kCols = kBK / 16;  // key columns a thread
  constexpr int kOut = D / 16;     // gradient columns a thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sdS = sV + kBK * LD;  // kBQ x LS

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qb * kBQ;
  const int q_stride = heads * D;
  const int k_stride = kv_heads * D;
  const long long q_base = (long long)b * q_len * q_stride + (long long)h * D;
  const long long k_base =
      (long long)b * k_len * k_stride + (long long)kvh * D;
  const long long row_base = ((long long)b * heads + h) * q_len;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, D, kBQ>(q + q_base, q_stride, q0, q_len, sQ);
  load_tile<T, D, kBQ>(dout + q_base, q_stride, q0, q_len, sdO);
  float row_l[kRows], row_d[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    row_l[i] = row < q_len ? lse[row_base + row] : 0.f;
    row_d[i] = row < q_len ? delta[row_base + row] : 0.f;
  }
  float acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;

  const int q_hi = min(q0 + kBQ, q_len);
  const int k_end = causal ? min(k_len, q_hi) : k_len;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous key tile is no longer read
    load_tile<T, D, kBK>(k + k_base, k_stride, k0, k_len, sK);
    load_tile<T, D, kBK>(v + k_base, k_stride, k0, k_len, sV);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], ov[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = sQ[(ty * kRows + i) * LD + d];
        ov[i] = sdO[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        const float p =
            live_pair(qpos, k0 + col, q_len, k_len, causal, window)
                ? expf(s[i][j] * scale - row_l[i])
                : 0.f;
        sdS[(ty * kRows + i) * LS + col] = p * (dp[i][j] - row_d[i]);
      }
    }
    __syncthreads();  // dS is complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) ds[i] = sdS[(ty * kRows + i) * LS + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float x = sK[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(ds[i], x, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= q_len) continue;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      dq[q_base + row * q_stride + tx + 16 * c] = from_f32<T>(acc[i][c] * scale);
  }
}

template <int D>
struct Smem {
  static constexpr int kBK = KeyTile<D>::value;
  static constexpr int prep = (int)sizeof(float) * (kBQ + 64) * (D + 1);
  static constexpr int dkdv =
      (int)sizeof(float) * (2 * (kBK + kBQ) * (D + 1) +
                            2 * kBK * (kBQ + 1) + 2 * kBQ);
  static constexpr int dq = (int)sizeof(float) *
                            (2 * (kBQ + kBK) * (D + 1) + kBQ * (kBK + 1));
  static_assert(prep <= 232448 && dkdv <= 232448 && dq <= 232448,
                "a block's shared memory");
};

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, void* dq, void* dk,
                   void* dv, float* scratch, int batch, int heads,
                   int kv_heads, int q_len, int k_len, int causal, int window,
                   float scale, cudaStream_t stream) {
  using S = Smem<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_prep_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::prep);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::dkdv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::dq);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  float* lse = scratch;
  float* delta = scratch + (long long)batch * heads * q_len;
  const int q_tiles = (q_len + kBQ - 1) / kBQ;
  const int k_tiles = (k_len + S::kBK - 1) / S::kBK;
  flash_bwd_prep_kernel<T, D>
      <<<dim3(q_tiles, heads, batch), kThreads, S::prep, stream>>>(
          qt, kt, static_cast<const T*>(out), dot, lse, delta, heads,
          kv_heads, q_len, k_len, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D>
      <<<dim3(k_tiles, kv_heads, batch), kThreads, S::dkdv, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), heads, kv_heads, q_len, k_len, causal, window,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D>
      <<<dim3(q_tiles, heads, batch), kThreads, S::dq, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), heads, kv_heads,
          q_len, k_len, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, void* dq, void* dk,
                     void* dv, float* scratch, int batch, int heads,
                     int kv_heads, int q_len, int k_len, int head_dim,
                     int causal, int window, float scale, cudaStream_t s) {
#define FLASH_BWD_CASE(D)                                                    \
  if (head_dim == D)                                                         \
    return launch<T, D>(q, k, v, out, dout, dq, dk, dv, scratch, batch,      \
                        heads, kv_heads, q_len, k_len, causal, window, scale, \
                        s);
  FLASH_BWD_CASE(16)
  FLASH_BWD_CASE(64)
  FLASH_BWD_CASE(128)
  FLASH_BWD_CASE(256)
#undef FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches the three kernels on `stream` and returns the first launch
// error (0 = all queued). q, out, dout and dq are (B, S, H, D); k, v, dk
// and dv (B, T, KH, D): contiguous, 16-byte aligned, all float32
// (is_bf16 = 0) or all bfloat16 (is_bf16 = 1); `out` is the forward's
// output for these q, k, v. `scratch` holds 2 * B * H * S float32 (the
// log-sum-exp, then delta). H % KH == 0, D in {16, 64, 128, 256}, S*H*D
// and T*KH*D below 2^31; window <= 0 means no window. Anything else
// returns cudaErrorInvalidValue.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* scratch, int batch,
                                   int heads, int kv_heads, int q_len,
                                   int k_len, int head_dim, int causal,
                                   int window, float scale, int is_bf16,
                                   void* stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 ||
      kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 || k_len <= 0 ||
      head_dim <= 0 || (long long)q_len * heads * head_dim >= (1LL << 31) ||
      (long long)k_len * kv_heads * head_dim >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(scratch);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, f,
                                        batch, heads, kv_heads, q_len, k_len,
                                        head_dim, causal, window, scale, s);
  return (int)dispatch<float>(q, k, v, out, dout, dq, dk, dv, f, batch,
                              heads, kv_heads, q_len, k_len, head_dim, causal,
                              window, scale, s);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
