// Causal, sliding-window or unmasked GQA attention, backward, for Hopper
// (sm_90a), at the head-dim pairs (D, DV) of the forward: q and k rows D
// wide, v and out rows DV wide (DV = D but for DeepSeek-V2's latent
// attention, (192, 128), and the small DeepSeek's (24, 16)).
//
// Replaces the custom VJP `_flash_bwd` of
// src/repro/kernels/flash_attention/ops.py:42-48: the TPU package has no
// backward kernel, and differentiates its materialized reference instead.
// This is the gradient of the forward kernels of flash_attention.cu, with
// the same mask: for every batch row b, query head h (kv head h / (H / KH)),
// query position i < S and key position j < T, the pair (i, j) is live when
// j <= i (causal), i - j < window (window > 0) and always when neither.
// With s_ij = scale * <q_i, k_j>, the log-sum-exp L_i over the live keys
// that the forward kept (natural-log units; see flash_attention.cu),
// P_ij = exp(s_ij - L_i) for a live pair and 0 for a dead one (masked
// explicitly, never through exp(s - L): a row with no live key has L about
// -1e30), the output O and its cotangent dO:
//   delta_i = <dO_i, O_i>
//   dP_ij   = <dO_i, v_j>
//   dS_ij   = P_ij (dP_ij - delta_i)
//   dQ_i    = scale * sum_j dS_ij k_j
//   dK_j    = scale * sum_{i, heads of the group} dS_ij q_i
//   dV_j    = sum_{i, heads of the group} P_ij dO_i
// dP and dV run over DV, S, dQ and dK over D (delta over the DV columns
// of O and dO), in float32 whatever the input type, the gradients stored
// in the input type (float32 or bfloat16, rounded to nearest even). A row
// with no live key (only when T < S with a window) has P = 0 everywhere:
// the forward kernels give 0 there, so its gradient is 0.
//
// Three launches a call on the bf16 route and two on the float32 route,
// with no atomics (every gradient element is written by one block, in a
// fixed order: bit for bit from call to call):
//   (a) bf16: `flash_bwd_delta_kernel`, delta into a float32 scratch
//       (2, B, H, S), a pass over O and dO bounded by bandwidth (float32:
//       (c) writes delta and the row sums of dS there);
//   (b) dK/dV, one block per (key tile, kv head, batch row): K and V of the
//       tile stay in shared memory while the block walks every query head
//       of the group and every query tile that holds a live pair for the
//       tile; each query tile's terms are summed apart and added to dK
//       and dV, which accumulate in registers across the group;
//   (c) dQ, one block per (query tile, head, batch row): walks the live key
//       tiles and accumulates dQ in registers (on the float32 route it runs
//       before (b) and walks them twice, below).
//
// What bounds it: operations. The function needs five products a live
// pair, 2 D flops each for S, dK and dQ and 2 DV for dP and dV; (b) and
// (c) both compute S and dP, 14 D a square pair, the price of having no
// atomics. At smollm-135m's training problem (B 8, H 9, KH 3, S 2048,
// D 64, causal) that is 1.35e11 flops against 0.1 GB of q, k, v, O, dO
// read and dq, dk, dv written once: 0.14 ms at the card's 989 TFLOP/s
// dense bf16 rate against 0.03 ms at HBM's; at DeepSeek-V2-Lite's (B 2,
// H = KH = 16, S 4096, (192, 128), causal) 4.47e11 flops, 0.45 ms.
//
// bfloat16 (what training runs): the tensor-core kernels of namespace tc,
// FlashAttention-2's deterministic split on wgmma and TMA:
//   - one warpgroup (128 threads) a block and tiles of 64 rows. Operands
//     stay bf16 in shared memory as TMA writes them (column blocks of 64
//     elements, the 128-byte swizzle; at D = 16 one block of 16, the
//     32-byte swizzle) and are read by wgmma descriptors K-major or
//     MN-major, so one Q or dO tile is the B operand of S^T = K Q^T
//     (K-major) and of dK += dS^T Q (MN-major) alike;
//   - (b): K and V of the tile come by TMA once; Q and dO tiles by TMA into
//     a ring of two stages, each completing on its own mbarrier, and L and
//     delta by plain loads into a ring beside them. Per query tile: S^T =
//     K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands in shared
//     memory); P^T and dS^T in float32 on the accumulator fragments, the
//     mask applied element by element only in a tile with a masked pair;
//     dV += P^T dO and dK += dS^T Q (wgmma m64nDk16, P^T and dS^T taken
//     from the accumulators as bf16 register A operands, dO and Q as
//     MN-major B operands), each product twice: with P^T and dS^T rounded
//     to bf16 and with what the rounding left, so that their float32
//     values reach the sums with 16 bits of mantissa (one rounding left
//     dV 2.06e-2 of 1 + |g| from the oracle at a group of 16 heads on
//     one kv head, S 4096, window 2048). Where D + DV > 256 ((256, 256),
//     (192, 128)), dK and dV would take (D + DV) / 2 float32 registers a
//     thread: the grid's z holds two blocks a (key tile, batch row), one
//     for dV (S^T over D, dV over DV) and one for dK (S^T, dP^T over DV,
//     dK over D), 16 D flops a square pair in (b) and (c) instead of 14 D;
//   - the Q and K tiles are D columns wide, the dO and V tiles DV: each
//     is its own number of column blocks, the ring's Q and dO stages
//     differ in size and each mbarrier expects the bytes of its own
//     tiles. A product whose n is D = 192 (dK += dS^T Q, dQ += dS K) is
//     issued as m64n128k16 over columns 0-127 and m64n64k16 over 128-191
//     with the same A registers: the accumulators fall in the order of
//     one m64n192k16, so the output staging reads them as one 64 x 192
//     tile;
//   - (c): Q and dO come by TMA once, L and delta of the thread's two rows
//     by plain loads; K and V tiles by TMA into the ring. Per key tile:
//     S = Q K^T and dP = dO V^T (both in shared memory), dS, then dQ +=
//     dS K (dS as the register A operand, K as an MN-major B operand);
//   - dK, dV and dQ are scaled, rounded to bf16 and staged through the
//     ring (no longer read, nothing in flight) with rows padded by 16
//     bytes, so that each row leaves in 16-byte stores;
//   - dead tiles are skipped by the loop bounds, and blocks with the
//     longest walks go first. Shared memory: three 64 x D and three 64 x
//     DV bf16 tiles and the L / delta ring, 50 KB at D = 64, 99 KB at
//     D = 128, 198 KB at D = 256, 124 KB at (192, 128).
// Warp-specialised producers, a deeper ring and two consumer warpgroups
// sharing one K/V tile are later changes.
//
// float32: the CUDA-core kernels of the anonymous namespace, whose checks
// against the plain version are held at 2e-5, which TF32 does not reach.
// Its delta and dS follow autograd's softmax backward: the dQ kernel walks
// each row's live keys twice, first for delta_i = sum_j P_ij dP_ij / sum_j
// P_ij (from the P and dP of these kernels, not from O), then for dS, and
// every row of dS, whose exact sum is 0, has the rounding of its float32
// sum eta_i put on one live key of the row, as autograd puts it on the
// row's largest score: j_i = i mod T (min(i, T - 1) with a window, the
// latest key at or before i, live whenever the row has a live key), which
// spreads the rows over the keys. (c) writes delta and eta into the
// scratch and takes dQ_i = scale * (sum_j dS_ij k_j - eta_i k_{j_i}); (b)
// forms the same dS bit for bit and takes dS_{i j_i} - eta_i. Both are
// the same functions. Where a row's keys and values nearly agree, dP -
// delta keeps only the last few digits of each, and the row sums of dS
// are not small against the true gradients: delta from the forward's O
// and dS summed as it stands put dQ times the keys' common part and dK's
// sum over keys, which the common part of the keys' input projects (wk's
// gradient), far from their values. At whisper-small's trained weights
// (phase [26c]: its first decoder layer's cross-attention, keys 3.3 % and
// values 2.2 % from their mean, P within 1.1x of uniform over 1500 keys)
// dQ sat 1.17e-2 (relative L2) from a float64 evaluation, against 5.0e-5
// for the plain version's autograd, and wk's and wq's gradients 1.44e-3
// and 1.38e-3 from the plain route's; now 5.9e-5 and 1.6e-5 from float64
// (tools/xattn_float32_precision.py, NVIDIA H100 80GB HBM3, 700 W). The
// walk for delta costs 4 D flops a live pair more.
// Each block is a 16 x 16 grid of threads, as the float32 forward
// kernel's: thread (ty, tx) owns rows ty * R .. ty * R + R - 1 and columns
// tx + 16 c of every tile (where D or DV is not a multiple of 16, as the
// small DeepSeek's 24, the last of a thread's columns is guarded), operands
// sit in shared memory as float32 with an odd row pitch (D + 1 or DV + 1),
// so the 16 lanes that read 16 rows hit 16 banks, and row statistics
// reduce with xor shuffles inside a half-warp. Key tiles are 64 keys up to
// D = 128 and 32 past it, so that the tiles of (b) and (c) fit in the
// 227 KB of one block (141 KB for (b) at (192, 128)); query tiles are 64
// rows.
//
// Offsets inside one batch row are 32-bit, as in the forward (S*H*D and
// T*KH*D below 2^31).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kBQ = 64;        // query rows a tile

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

// 16 bytes at p as float32: 4 float32 or 8 bf16 elements
__device__ __forceinline__ void load16(const float* p, float* o) {
  load4(p, o);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = hopper::unpack_bf16(w[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// rows [row0, row0 + ROWS) of a float32 (len, W) matrix whose rows lie
// `stride` elements apart into shared memory with pitch W + 1; rows at or
// past `len` are zeros
template <int W, int ROWS>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int stride, int row0, int len,
                                          float* dst) {
  constexpr int kVecs = W / 4;
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int d = (i % kVecs) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < len) load4(src + (row0 + r) * stride + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * (W + 1) + d + e] = x[e];
  }
}

// is column tx + 16 c of a W-column tile one of its W columns? (always,
// when W is a multiple of 16)
template <int W>
__device__ __forceinline__ bool own_col(int tx, int c) {
  return W % 16 == 0 || tx + 16 * c < W;
}

__device__ __forceinline__ bool live_pair(int qpos, int kpos, int q_len,
                                          int k_len, int causal,
                                          int window) {
  return qpos < q_len && kpos < k_len && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// lanes that share one row of the delta pass: 16 bytes a lane, at most a
// warp
template <typename T, int DV>
struct DeltaLanes {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int value = DV / kVec < 32 ? DV / kVec : 32;
};

// (a) delta of every (batch row, position, head) row of O and dO, which
// lie DV elements apart in the model's layout (B, S, H, DV), into
// (B, H, S); O of type TO: T, or float32 before the forward's rounding to
// T.
template <typename TO, typename T, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const TO* __restrict__ o,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, int heads, int q_len,
                           long long rows) {
  constexpr int kVec = DeltaLanes<T, DV>::kVec;
  constexpr int kLanes = DeltaLanes<T, DV>::value;
  const long long row =
      (long long)blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  float sum = 0.f;
  if (row < rows) {
    for (int d = lane * kVec; d < DV; d += kLanes * kVec) {
      float x[kVec], y[kVec];
#pragma unroll
      for (int e = 0; e < kVec; e += 16 / (int)sizeof(TO))
        load16(o + row * DV + d + e, x + e);
      load16(dout + row * DV + d, y);
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum = fmaf(x[e], y[e], sum);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && lane == 0) {
    const long long pos = row / heads;  // b * S + i
    const long long b = pos / q_len;
    delta[(b * heads + row % heads) * q_len + pos % q_len] = sum;
  }
}

template <typename TO, typename T, int DV>
cudaError_t launch_delta(const void* out, const void* dout, float* delta,
                         int batch, int heads, int q_len,
                         cudaStream_t stream) {
  constexpr int kRows = kThreads / DeltaLanes<T, DV>::value;  // a block
  const long long rows = (long long)batch * q_len * heads;
  flash_bwd_delta_kernel<TO, T, DV>
      <<<(unsigned)((rows + kRows - 1) / kRows), kThreads, 0, stream>>>(
          static_cast<const TO*>(out), static_cast<const T*>(dout), delta,
          heads, q_len, rows);
  return cudaGetLastError();
}

// (b) dK and dV of one key tile of one (batch row, kv head): the sum over
// the group's query heads and their live query tiles.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ eta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int heads, int kv_heads, int q_len, int k_len,
                          int causal, int window, float scale) {
  static_assert(DV <= D, "v rows no wider than q and k rows");
  constexpr int kBK = KeyTile<D>::value;
  constexpr int LD = D + 1;
  constexpr int LDV = DV + 1;
  constexpr int LP = kBQ + 1;
  constexpr int kRows = kBK / 16;           // key rows a thread
  constexpr int kCols = kBQ / 16;           // query columns a thread
  constexpr int kOutK = (D + 15) / 16;      // dK columns a thread
  constexpr int kOutV = (DV + 15) / 16;     // dV columns a thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LDV;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LDV;  // kBK x LP: P transposed
  float* sdS = sP + kBK * LP;   // kBK x LP: dS transposed
  float* sL = sdS + kBK * LP;   // kBQ
  float* sD = sL + kBQ;         // kBQ
  float* sE = sD + kBQ;         // kBQ: each row's sum of dS

  const int k0 = blockIdx.x * kBK;  // the causal mask's longest first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  const int q_stride = heads * D;
  const int o_stride = heads * DV;
  const int k_stride = kv_heads * D;
  const int v_stride = kv_heads * DV;
  const long long k_base =
      (long long)b * k_len * k_stride + (long long)kvh * D;
  const long long v_base =
      (long long)b * k_len * v_stride + (long long)kvh * DV;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<D, kBK>(k + k_base, k_stride, k0, k_len, sK);
  load_tile<DV, kBK>(v + v_base, v_stride, k0, k_len, sV);

  float acc_k[kRows][kOutK], acc_v[kRows][kOutV];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < kOutK; ++c) acc_k[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < kOutV; ++c) acc_v[i][c] = 0.f;
  }

  // query rows with a live pair for some key of the tile
  const int k_hi = min(k0 + kBK, k_len);
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(q_len, k_hi - 1 + window) : q_len;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long q_base =
        (long long)b * q_len * q_stride + (long long)h * D;
    const long long o_base =
        (long long)b * q_len * o_stride + (long long)h * DV;
    const long long row_base = ((long long)b * heads + h) * q_len;
    for (int q0 = (q_begin / kBQ) * kBQ; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // the previous query tile is no longer read
      load_tile<D, kBQ>(q + q_base, q_stride, q0, q_len, sQ);
      load_tile<DV, kBQ>(dout + o_base, o_stride, q0, q_len, sdO);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        sL[threadIdx.x] = row < q_len ? lse[row_base + row] : 0.f;
        sD[threadIdx.x] = row < q_len ? delta[row_base + row] : 0.f;
        sE[threadIdx.x] = row < q_len ? eta[row_base + row] : 0.f;
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
      // S over D and dP over DV: both over the first DV columns, then S
      // alone over the rest (none when DV = D)
#pragma unroll 4
      for (int d = 0; d < DV; ++d) {
        float kv[kRows], vv[kRows], qv[kCols], ov[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = sK[(ty * kRows + i) * LD + d];
          vv[i] = sV[(ty * kRows + i) * LDV + d];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qv[j] = sQ[(tx + 16 * j) * LD + d];
          ov[j] = sdO[(tx + 16 * j) * LDV + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll 4
      for (int d = DV; d < D; ++d) {
        float kv[kRows], qv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) kv[i] = sK[(ty * kRows + i) * LD + d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) qv[j] = sQ[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
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
          // the row's rounded sum of dS goes to its key j_i
          const int qpos = q0 + col;
          const int dump = window > 0 ? min(qpos, k_len - 1) : qpos % k_len;
          sdS[(ty * kRows + i) * LP + col] =
              p * (dp[i][j] - sD[col]) - (kpos == dump ? sE[col] : 0.f);
        }
      }
      __syncthreads();  // P and dS are complete

      // the tile's kBQ terms are summed apart and then added: one float32
      // chain through every live row of the group (16 heads x 4096 rows
      // at RecurrentGemma's) rounded dK and dV past 2e-5 of 1 + |b|
      float part_k[kRows][kOutK], part_v[kRows][kOutV];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < kOutK; ++c) part_k[i][c] = 0.f;
#pragma unroll
        for (int c = 0; c < kOutV; ++c) part_v[i][c] = 0.f;
      }
#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        float p[kRows], ds[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          p[i] = sP[(ty * kRows + i) * LP + qq];
          ds[i] = sdS[(ty * kRows + i) * LP + qq];
        }
#pragma unroll
        for (int c = 0; c < kOutV; ++c) {
          if (!own_col<DV>(tx, c)) continue;
          const float go = sdO[qq * LDV + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            part_v[i][c] = fmaf(p[i], go, part_v[i][c]);
        }
#pragma unroll
        for (int c = 0; c < kOutK; ++c) {
          if (!own_col<D>(tx, c)) continue;
          const float x = sQ[qq * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            part_k[i][c] = fmaf(ds[i], x, part_k[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < kOutK; ++c) acc_k[i][c] += part_k[i][c];
#pragma unroll
        for (int c = 0; c < kOutV; ++c) acc_v[i][c] += part_v[i][c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + ty * kRows + i;
    if (row >= k_len) continue;
#pragma unroll
    for (int c = 0; c < kOutK; ++c)
      if (own_col<D>(tx, c))
        dk[k_base + row * k_stride + tx + 16 * c] = acc_k[i][c] * scale;
#pragma unroll
    for (int c = 0; c < kOutV; ++c)
      if (own_col<DV>(tx, c))
        dv[v_base + row * v_stride + tx + 16 * c] = acc_v[i][c];
  }
}

// s (S) and dp (dP) of a thread's kRows query rows and kCols keys of one
// key tile: the dot products over D and DV in shared memory, in the same
// order as (b)'s (fmaf over the columns, from the first), so that both
// kernels get the same values bit for bit
template <int D, int DV, int kRows, int kCols>
__device__ __forceinline__ void scores_and_dp(
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    int tx, int ty, float (&s)[kRows][kCols], float (&dp)[kRows][kCols]) {
  constexpr int LD = D + 1;
  constexpr int LDV = DV + 1;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
  // S over D and dP over DV, as in (b)
#pragma unroll 4
  for (int d = 0; d < DV; ++d) {
    float qv[kRows], ov[kRows], kv[kCols], vv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      qv[i] = sQ[(ty * kRows + i) * LD + d];
      ov[i] = sdO[(ty * kRows + i) * LDV + d];
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      kv[j] = sK[(tx + 16 * j) * LD + d];
      vv[j] = sV[(tx + 16 * j) * LDV + d];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll 4
  for (int d = DV; d < D; ++d) {
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
}

// (c) dQ of 64 query rows of one (batch row, head), in two walks over the
// live key tiles: the first sums P and P dP of each row, whose ratio is
// delta (written over the scratch's first plane for (b)); the second forms
// dS, sums each row of it (eta, into the second plane) and accumulates dQ.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta,
                        float* __restrict__ eta, float* __restrict__ dq,
                        int heads, int kv_heads, int q_len, int k_len,
                        int causal, int window, float scale) {
  static_assert(DV <= D, "v rows no wider than q and k rows");
  constexpr int kBK = KeyTile<D>::value;
  constexpr int LD = D + 1;
  constexpr int LDV = DV + 1;
  constexpr int LS = kBK + 1;
  constexpr int kRows = kBQ / 16;       // query rows a thread
  constexpr int kCols = kBK / 16;       // key columns a thread
  constexpr int kOut = (D + 15) / 16;   // dQ columns a thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LDV;
  float* sV = sK + kBK * LD;
  float* sdS = sV + kBK * LDV;  // kBQ x LS

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qb * kBQ;
  const int q_stride = heads * D;
  const int o_stride = heads * DV;
  const int k_stride = kv_heads * D;
  const int v_stride = kv_heads * DV;
  const long long q_base = (long long)b * q_len * q_stride + (long long)h * D;
  const long long o_base =
      (long long)b * q_len * o_stride + (long long)h * DV;
  const long long k_base =
      (long long)b * k_len * k_stride + (long long)kvh * D;
  const long long v_base =
      (long long)b * k_len * v_stride + (long long)kvh * DV;
  const long long row_base = ((long long)b * heads + h) * q_len;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<D, kBQ>(q + q_base, q_stride, q0, q_len, sQ);
  load_tile<DV, kBQ>(dout + o_base, o_stride, q0, q_len, sdO);
  float row_l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    row_l[i] = row < q_len ? lse[row_base + row] : 0.f;
  }

  const int q_hi = min(q0 + kBQ, q_len);
  const int k_end = causal ? min(k_len, q_hi) : k_len;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = (k_begin / kBK) * kBK;

  // the first walk: delta_i = sum_j P_ij dP_ij / sum_j P_ij
  float sum_p[kRows], sum_pdp[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) sum_p[i] = sum_pdp[i] = 0.f;
  for (int k0 = k_first; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous key tile is no longer read
    load_tile<D, kBK>(k + k_base, k_stride, k0, k_len, sK);
    load_tile<DV, kBK>(v + v_base, v_stride, k0, k_len, sV);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    scores_and_dp<D, DV>(sQ, sdO, sK, sV, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p =
            live_pair(qpos, k0 + tx + 16 * j, q_len, k_len, causal, window)
                ? expf(s[i][j] * scale - row_l[i])
                : 0.f;
        sum_p[i] += p;
        sum_pdp[i] = fmaf(p, dp[i][j], sum_pdp[i]);
      }
    }
  }
  float row_d[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      sum_p[i] += __shfl_xor_sync(0xffffffffu, sum_p[i], off);
      sum_pdp[i] += __shfl_xor_sync(0xffffffffu, sum_pdp[i], off);
    }
    row_d[i] = sum_p[i] > 0.f ? sum_pdp[i] / sum_p[i] : 0.f;
  }

  // the second walk: dS, its row sums and dQ
  float acc[kRows][kOut], row_e[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    row_e[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = k_first; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous key tile is no longer read
    load_tile<D, kBK>(k + k_base, k_stride, k0, k_len, sK);
    load_tile<DV, kBK>(v + v_base, v_stride, k0, k_len, sV);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    scores_and_dp<D, DV>(sQ, sdO, sK, sV, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        const float p =
            live_pair(qpos, k0 + col, q_len, k_len, causal, window)
                ? expf(s[i][j] * scale - row_l[i])
                : 0.f;
        const float ds = p * (dp[i][j] - row_d[i]);
        sdS[(ty * kRows + i) * LS + col] = ds;
        sum += ds;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row_e[i] += sum;
    }
    __syncthreads();  // dS is complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) ds[i] = sdS[(ty * kRows + i) * LS + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        if (!own_col<D>(tx, c)) continue;
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
    // less the row's rounded sum of dS times the k row of its key j_i
    const int dump = window > 0 ? min(row, k_len - 1) : row % k_len;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      if (own_col<D>(tx, c))
        dq[q_base + row * q_stride + tx + 16 * c] =
            (acc[i][c] - row_e[i] * k[k_base + dump * k_stride + tx + 16 * c])
            * scale;
    if (tx == 0) {
      delta[row_base + row] = row_d[i];
      eta[row_base + row] = row_e[i];
    }
  }
}

template <int D, int DV>
struct Smem {
  static constexpr int kBK = KeyTile<D>::value;
  static constexpr int dkdv =
      (int)sizeof(float) * ((kBK + kBQ) * (D + 1) + (kBK + kBQ) * (DV + 1) +
                            2 * kBK * (kBQ + 1) + 3 * kBQ);
  static constexpr int dq =
      (int)sizeof(float) * ((kBQ + kBK) * (D + 1) + (kBQ + kBK) * (DV + 1) +
                            kBQ * (kBK + 1));
  static_assert(dkdv <= 232448 && dq <= 232448, "a block's shared memory");
};

// the float32 route: the CUDA-core dQ kernel, which writes delta and the
// rows' sums of dS into the scratch, then dK/dV (O is not read)
template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int batch,
                   int heads, int kv_heads, int q_len, int k_len, int causal,
                   int window, float scale, cudaStream_t stream) {
  using S = Smem<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::dkdv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::dq);
  if (err != cudaSuccess) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const int q_tiles = (q_len + kBQ - 1) / kBQ;
  const int k_tiles = (k_len + S::kBK - 1) / S::kBK;
  float* eta = delta + (long long)batch * heads * q_len;
  flash_bwd_dq_kernel<D, DV>
      <<<dim3(q_tiles, heads, batch), kThreads, S::dq, stream>>>(
          qt, kt, vt, dot, lse, delta, eta, static_cast<float*>(dq), heads,
          kv_heads, q_len, k_len, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D, DV>
      <<<dim3(k_tiles, kv_heads, batch), kThreads, S::dkdv, stream>>>(
          qt, kt, vt, dot, lse, delta, eta, static_cast<float*>(dk),
          static_cast<float*>(dv), heads, kv_heads, q_len, k_len, causal,
          window, scale);
  return cudaGetLastError();
}

}  // namespace

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTile = 64;      // rows of a tile: queries or keys
constexpr int kStages = 2;     // tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

// A 64-row bf16 tile of W columns in shared memory: W / C column blocks of
// C elements, one swizzled row of RB bytes each.
template <int W>
struct Cols {
  static constexpr int C = W < 64 ? W : 64;
  static constexpr int RB = 2 * C;
  static constexpr int kSwizzle = RB == 128 ? 1 : 3;  // wgmma: 128B, 32B
  static constexpr int kBytes = kTile * W * 2;
  static constexpr int kAcc = W / 2;  // floats a thread of a 64 x W product
  static_assert(W % C == 0 && (RB == 128 || RB == 32),
                "whole column blocks, swizzle rows of 128 or 32 bytes");
};

// One block's shared memory at head dims (D, DV): two tiles held (K and V,
// or Q and dO: one D and one DV wide) and a ring of kStages stages of two
// (Q and dO, or K and V), L and delta of kStages query tiles, seven
// mbarriers.
template <int D, int DV>
struct Tiles {
  using QK = Cols<D>;   // q and k tiles (and dK, dQ)
  using VO = Cols<DV>;  // v and dO tiles (and dV)
  static constexpr int kPair = QK::kBytes + VO::kBytes;
  static constexpr int kRowsOffset = (1 + kStages) * kPair;
  static constexpr int kBarOffset = kRowsOffset + 2 * kStages * kTile * 4;
  static constexpr int kSmem = kBarOffset + 64 + 1024;  // + 1024-alignment
  // dK and dV in two blocks where both would not fit in registers
  static constexpr bool kSplit = D + DV > 256;
  static_assert(DV <= D, "v rows no wider than q and k rows");
  static_assert(kSplit || D == DV,
                "one block stores dK and dV through one staging area only "
                "at a square pair");
  static_assert(kTile * (D + 8) * 2 <= kStages * QK::kBytes,
                "the output staging fits in the ring's Q (or K) stages");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// k-step kk (16 elements of the reduction) of a 64-row, W-column tile read
// K-major
template <int W>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile,
                                           int kk) {
  using T = Cols<W>;
  return smem_desc(smem_addr(tile + kk / (T::C / 16) * kTile * T::RB +
                             kk % (T::C / 16) * 32),
                   16, 8 * T::RB, T::kSwizzle);
}
// k-step kk (rows 16 kk .. 16 kk + 15) of a 64-row tile read as an MN-major
// B operand whose N is the tile's W columns
template <int W>
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile,
                                            int kk) {
  using T = Cols<W>;
  return smem_desc(smem_addr(tile + 16 * kk * T::RB), kTile * T::RB,
                   8 * T::RB, T::kSwizzle);
}

// s (64 x 64) = a b^T over W: a and b 64-row, W-column tiles, both K-major
template <int W>
__device__ __forceinline__ void product_abt(float* s, const unsigned char* a,
                                            const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_ss_n64(s, kmajor<W>(a, kk), kmajor<W>(b, kk), kk > 0);
}
// acc (64 x W) += a (64 x 64, bf16 registers) b (64 x W, MN-major). At
// W = 192 each k-step is m64n128k16 over the first two column blocks and
// m64n64k16 over the third, with the same A: their accumulators are those
// of one m64n192k16, in its order.
template <int W>
__device__ __forceinline__ void product_rs(float* acc, uint32_t (*a)[4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    if constexpr (W == 192) {
      wgmma_rs<128>(acc, a[kk], mnmajor<W>(b, kk));
      wgmma_rs<64>(acc + 64, a[kk],
                   mnmajor<W>(b + 2 * kTile * Cols<W>::RB, kk));
    } else {
      wgmma_rs<W>(acc, a[kk], mnmajor<W>(b, kk));
    }
  }
}
// a 64 x 64 float32 accumulator as the bf16 A operand of a product over
// its 64 columns: k-step kk is its n-tiles 2 kk and 2 kk + 1
__device__ __forceinline__ void to_a(const float* acc, uint32_t (*a)[4]) {
#pragma unroll
  for (int t = 0; t < kTile / 8; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a[t / 2][2 * (t % 2) + i] =
          pack_bf16(acc[4 * t + 2 * i], acc[4 * t + 2 * i + 1]);
}
// what to_a's rounding left of the same accumulator, acc - bf16(acc), as
// a bf16 A operand: the two products carry 16 bits of its mantissa
__device__ __forceinline__ void to_a_lo(const float* acc, uint32_t (*a)[4]) {
#pragma unroll
  for (int t = 0; t < kTile / 8; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float x = acc[4 * t + 2 * i], y = acc[4 * t + 2 * i + 1];
      const float2 hi = unpack_bf16(pack_bf16(x, y));
      a[t / 2][2 * (t % 2) + i] = pack_bf16(x - hi.x, y - hi.y);
    }
}
template <int N>
__device__ __forceinline__ void pin_all(float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(x[i]);
}
__device__ __forceinline__ void pin_all(uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pin(a[kk][i]);
}

// this warp's 16 rows of a 64 x W accumulator, times mul, as bf16 rows
// w0 .. w0 + 15 (those below len) of `out`, whose rows lie `stride`
// elements apart, through the warp's part of `stage`
template <int W>
__device__ __forceinline__ void store_rows(const float* acc, float mul,
                                           unsigned char* stage_base,
                                           bf16* out, int stride, int w0,
                                           int len) {
  constexpr int P = W + 8;
  constexpr int kChunks = W / 8;  // 16-byte chunks of a row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bf16* stage = reinterpret_cast<bf16*>(stage_base) + 16 * warp * P;
#pragma unroll
  for (int t = 0; t < W / 8; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(stage + (lane / 4 + 8 * i) * P + 8 * t +
                                   2 * (lane % 4)) =
          pack_bf16(acc[4 * t + 2 * i] * mul, acc[4 * t + 2 * i + 1] * mul);
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    if (w0 + r < len)
      *reinterpret_cast<uint4*>(out + (w0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * P + c * 8);
  }
  __syncwarp();
}

// W columns of a (batch, len, heads, W) tensor map, rows r0 .. r0 + 63 of
// head h and batch row b, into the tile at dst (one thread), completing on
// bar
template <int W>
__device__ __forceinline__ void load_rows64(unsigned char* dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int h, int r0,
                                            int b) {
  using T = Cols<W>;
#pragma unroll
  for (int c = 0; c < W / T::C; ++c)
    tma_load(smem_addr(dst + c * kTile * T::RB), map, bar, c * T::C, h, r0,
             b);
}

// what a dK/dV block computes
enum Part { kBoth, kDV, kDK };

// (b) dK and/or dV of one key tile of one (batch row, kv head).
template <int D, int DV, int PART>
__device__ __forceinline__ void dkdv_block(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int b, int heads, int kv_heads, int q_len,
    int k_len, int causal, int window, float scale) {
  using T = Tiles<D, DV>;
  using QK = typename T::QK;
  using VO = typename T::VO;
  constexpr bool kV = PART != kDK;  // the block computes dV
  constexpr bool kK = PART != kDV;  // the block computes dK
  unsigned char* base = aligned_smem();
  unsigned char* sK = base;
  unsigned char* sV = sK + QK::kBytes;
  unsigned char* sQ = base + T::kPair;           // kStages Q tiles
  unsigned char* sO = sQ + kStages * QK::kBytes;  // kStages dO tiles
  float* sL = reinterpret_cast<float*>(base + T::kRowsOffset);  // log2 units
  float* sDelta = sL + kStages * kTile;
  // barrier 0: K (and V); 1 + s: Q of stage s; 1 + kStages + s: dO of s
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + T::kBarOffset);
  const uint32_t bar_kv = smem_addr(bars);

  const int k0 = blockIdx.x * kTile;  // the causal mask's longest first
  const int kvh = blockIdx.y;
  const int group = heads / kv_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int key_lo = k0 + 16 * warp + lane / 4;  // keys key_lo, key_lo + 8

  // query tiles with a live pair for some key of the tile, walked head by
  // head: tile j is query rows tile_q0(j) .. + 63 of head tile_h(j)
  const int k_hi = min(k0 + kTile, k_len);
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(q_len, k_hi - 1 + window) : q_len;
  const int q_tiles =
      q_end > q_begin ? (q_end - q_begin + kTile - 1) / kTile : 0;
  const int n = group * q_tiles;
  auto tile_h = [&](int j) { return kvh * group + j / q_tiles; };
  auto tile_q0 = [&](int j) { return q_begin + j % q_tiles * kTile; };

  // Q and dO of tile j into stage j % kStages (one thread)
  auto load_tile = [&](int j) {
    const int s = j % kStages;
    const uint32_t bq = smem_addr(bars + 1 + s);
    const uint32_t bo = smem_addr(bars + 1 + kStages + s);
    mbar_expect_tx(bq, QK::kBytes);
    load_rows64<D>(sQ + s * QK::kBytes, tm_q, bq, tile_h(j), tile_q0(j), b);
    mbar_expect_tx(bo, VO::kBytes);
    load_rows64<DV>(sO + s * VO::kBytes, tm_do, bo, tile_h(j), tile_q0(j),
                    b);
  };
  // L (in log2 units) and delta of tile j into stage j % kStages (the first
  // 64 threads, one row each)
  auto load_rows = [&](int j) {
    if (threadIdx.x < kTile) {
      const int s = j % kStages;
      const int row = tile_q0(j) + threadIdx.x;
      const long long at = ((long long)b * heads + tile_h(j)) * q_len + row;
      sL[s * kTile + threadIdx.x] = row < q_len ? lse[at] * kLog2e : 0.f;
      sDelta[s * kTile + threadIdx.x] = row < q_len ? delta[at] : 0.f;
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * kStages; ++i) mbar_init(smem_addr(bars + i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_kv, QK::kBytes + (kK ? VO::kBytes : 0));
    load_rows64<D>(sK, tm_k, bar_kv, kvh, k0, b);
    if constexpr (kK) load_rows64<DV>(sV, tm_v, bar_kv, kvh, k0, b);
    for (int j = 0; j < kStages && j < n; ++j) load_tile(j);
  }
  for (int j = 0; j < kStages && j < n; ++j) load_rows(j);
  __syncthreads();  // L and delta of the first stages are in place

  float dk_acc[kK ? QK::kAcc : 1], dv_acc[kV ? VO::kAcc : 1];
  float st[32], dpt[32];  // S^T (then P^T) and dP^T (then dS^T)
  uint32_t pa[kTile / 16][4], da[kTile / 16][4];
  if constexpr (kK) {
#pragma unroll
    for (int i = 0; i < QK::kAcc; ++i) dk_acc[i] = 0.f;
  }
  if constexpr (kV) {
#pragma unroll
    for (int i = 0; i < VO::kAcc; ++i) dv_acc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  mbar_wait(bar_kv, 0);

  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const int parity = (j / kStages) & 1;
    const int q0 = tile_q0(j);
    const unsigned char* tQ = sQ + s * QK::kBytes;
    const unsigned char* tO = sO + s * VO::kBytes;
    const float* tL = sL + s * kTile;
    const float* tD = sDelta + s * kTile;
    // every pair of the tile is live
    const bool full = k0 + kTile <= k_len && q0 + kTile <= q_len &&
                      (!causal || k0 + kTile - 1 <= q0) &&
                      (window <= 0 || q0 + kTile - 1 - k0 < window);

    // S^T = K Q^T over D and dP^T = V dO^T over DV, 64 keys x 64 queries
    pin_all<32>(st);
    if constexpr (kK) pin_all<32>(dpt);
    wgmma_fence();
    mbar_wait(smem_addr(bars + 1 + s), parity);  // Q has landed
    product_abt<D>(st, sK, tQ);
    wgmma_commit();
    mbar_wait(smem_addr(bars + 1 + kStages + s), parity);  // dO has landed
    if constexpr (kK) {
      product_abt<DV>(dpt, sV, tO);
      wgmma_commit();
    }
    wgmma_wait_all();
    pin_all<32>(st);
    if constexpr (kK) pin_all<32>(dpt);

    // P^T = exp(scale S^T - L) and dS^T = P^T (dP^T - delta) in float32;
    // st[4 t + e] is key key_lo + 8 (e / 2) and query q0 + 8 t +
    // 2 (lane % 4) + e % 2
#pragma unroll
    for (int t = 0; t < kTile / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * t + 2 * (lane % 4) + e % 2;
        bool live = true;
        if (!full) {
          const int key = key_lo + 8 * (e / 2);
          const int query = q0 + col;
          live = key < k_len && query < q_len && (!causal || key <= query) &&
                 (window <= 0 || query - key < window);
        }
        const float p =
            live ? exp2f(fmaf(st[4 * t + e], scale_log2, -tL[col])) : 0.f;
        st[4 * t + e] = p;
        if constexpr (kK) dpt[4 * t + e] = p * (dpt[4 * t + e] - tD[col]);
      }

    // dV += P^T dO (n = DV) and dK += dS^T Q (n = D), over the tile's 64
    // queries, each product twice: with P^T and dS^T rounded to bf16, then
    // with what the rounding left (one bf16 operand put dV 2.06e-2 of
    // 1 + |g| from the oracle at RecurrentGemma's group of 16, past the
    // bf16 limit)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if constexpr (kV) {
        half ? to_a_lo(st, pa) : to_a(st, pa);
        pin_all(pa);
        pin_all<VO::kAcc>(dv_acc);
      }
      if constexpr (kK) {
        half ? to_a_lo(dpt, da) : to_a(dpt, da);
        pin_all(da);
        pin_all<QK::kAcc>(dk_acc);
      }
      wgmma_fence();
      if constexpr (kV) product_rs<DV>(dv_acc, pa, tO);
      if constexpr (kK) product_rs<D>(dk_acc, da, tQ);
      wgmma_commit();
      wgmma_wait_all();
      // the A operands stay live until the products are done
      if constexpr (kV) {
        pin_all<VO::kAcc>(dv_acc);
        pin_all(pa);
      }
      if constexpr (kK) {
        pin_all<QK::kAcc>(dk_acc);
        pin_all(da);
      }
    }
    __syncthreads();  // stage s is no longer read
    if (j + kStages < n) {
      if (threadIdx.x == 0) load_tile(j + kStages);
      load_rows(j + kStages);
    }
  }

  // between positions: kv_heads * D in dk, kv_heads * DV in dv
  if constexpr (kK)
    store_rows<D>(dk_acc, scale, sQ,
                  dk + (long long)b * k_len * kv_heads * D +
                      (long long)kvh * D,
                  kv_heads * D, k0 + 16 * warp, k_len);
  if constexpr (kV)
    store_rows<DV>(dv_acc, 1.f, sQ,
                   dv + (long long)b * k_len * kv_heads * DV +
                       (long long)kvh * DV,
                   kv_heads * DV, k0 + 16 * warp, k_len);
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int heads, int kv_heads, int q_len, int k_len,
                               int causal, int window, float scale) {
  if constexpr (Tiles<D, DV>::kSplit) {
    // z = 2 b + part: dV blocks at even z, dK blocks at odd z
    if (blockIdx.z % 2 == 0)
      dkdv_block<D, DV, kDV>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv,
                             blockIdx.z / 2, heads, kv_heads, q_len, k_len,
                             causal, window, scale);
    else
      dkdv_block<D, DV, kDK>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv,
                             blockIdx.z / 2, heads, kv_heads, q_len, k_len,
                             causal, window, scale);
  } else {
    dkdv_block<D, DV, kBoth>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv,
                             blockIdx.z, heads, kv_heads, q_len, k_len,
                             causal, window, scale);
  }
}

// (c) dQ of 64 query rows of one (batch row, head).
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int heads, int kv_heads,
                             int q_len, int k_len, int causal, int window,
                             float scale) {
  using T = Tiles<D, DV>;
  using QK = typename T::QK;
  using VO = typename T::VO;
  unsigned char* base = aligned_smem();
  unsigned char* sQ = base;
  unsigned char* sO = sQ + QK::kBytes;
  unsigned char* sK = base + T::kPair;            // kStages K tiles
  unsigned char* sV = sK + kStages * QK::kBytes;  // kStages V tiles
  // barrier 0: Q and dO; 1 + s: K of stage s; 1 + kStages + s: V of s
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + T::kBarOffset);
  const uint32_t bar_q = smem_addr(bars);

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qb * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_lo = q0 + 16 * warp + lane / 4;  // rows row_lo, row_lo + 8
  const float scale_log2 = scale * kLog2e;
  float l2[2], dl[2];  // L in log2 units and delta of the two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    const long long at = ((long long)b * heads + h) * q_len + row;
    l2[i] = row < q_len ? lse[at] * kLog2e : 0.f;
    dl[i] = row < q_len ? delta[at] : 0.f;
  }

  // key tiles that hold a live key for some row of this block
  const int q_hi = min(q0 + kTile, q_len);
  const int k_end = causal ? min(k_len, q_hi) : k_len;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kTile * kTile : 0;
  const int n = k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile : 0;

  // K and V of tile j into stage j % kStages (one thread)
  auto load_tile = [&](int j) {
    const int s = j % kStages;
    const int k0 = k_begin + j * kTile;
    const uint32_t bk = smem_addr(bars + 1 + s);
    const uint32_t bv = smem_addr(bars + 1 + kStages + s);
    mbar_expect_tx(bk, QK::kBytes);
    load_rows64<D>(sK + s * QK::kBytes, &tm_k, bk, kvh, k0, b);
    mbar_expect_tx(bv, VO::kBytes);
    load_rows64<DV>(sV + s * VO::kBytes, &tm_v, bv, kvh, k0, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * kStages; ++i) mbar_init(smem_addr(bars + i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, T::kPair);
    load_rows64<D>(sQ, &tm_q, bar_q, h, q0, b);
    load_rows64<DV>(sO, &tm_do, bar_q, h, q0, b);
    for (int j = 0; j < kStages && j < n; ++j) load_tile(j);
  }

  float acc[QK::kAcc];
  float sc[32], dp[32];  // S (then P) and dP (then dS)
  uint32_t a[kTile / 16][4];
#pragma unroll
  for (int i = 0; i < QK::kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const int parity = (j / kStages) & 1;
    const int k0 = k_begin + j * kTile;
    const unsigned char* tK = sK + s * QK::kBytes;
    const unsigned char* tV = sV + s * VO::kBytes;
    const bool full = k0 + kTile <= k_len && q0 + kTile <= q_len &&
                      (!causal || k0 + kTile - 1 <= q0) &&
                      (window <= 0 || q0 + kTile - 1 - k0 < window);

    // S = Q K^T over D and dP = dO V^T over DV, 64 queries x 64 keys
    pin_all<32>(sc);
    pin_all<32>(dp);
    wgmma_fence();
    mbar_wait(smem_addr(bars + 1 + s), parity);  // K has landed
    product_abt<D>(sc, sQ, tK);
    wgmma_commit();
    mbar_wait(smem_addr(bars + 1 + kStages + s), parity);  // V has landed
    product_abt<DV>(dp, sO, tV);
    wgmma_commit();
    wgmma_wait_all();
    pin_all<32>(sc);
    pin_all<32>(dp);

    // dS = P (dP - delta); sc[4 t + e] is row row_lo + 8 (e / 2) and key
    // k0 + 8 t + 2 (lane % 4) + e % 2
#pragma unroll
    for (int t = 0; t < kTile / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool live = true;
        if (!full) {
          const int row = row_lo + 8 * (e / 2);
          const int key = k0 + 8 * t + 2 * (lane % 4) + e % 2;
          live = key < k_len && row < q_len && (!causal || key <= row) &&
                 (window <= 0 || row - key < window);
        }
        const float p =
            live ? exp2f(fmaf(sc[4 * t + e], scale_log2, -l2[e / 2])) : 0.f;
        dp[4 * t + e] = p * (dp[4 * t + e] - dl[e / 2]);
      }

    // dQ += dS K over the tile's 64 keys (n = D)
    to_a(dp, a);
    pin_all(a);
    pin_all<QK::kAcc>(acc);
    wgmma_fence();
    product_rs<D>(acc, a, tK);
    wgmma_commit();
    wgmma_wait_all();
    pin_all<QK::kAcc>(acc);
    pin_all(a);  // the A operand stays live until the product is done
    __syncthreads();  // stage s is no longer read
    if (threadIdx.x == 0 && j + kStages < n) load_tile(j + kStages);
  }

  const int stride = heads * D;  // between positions
  store_rows<D>(acc, scale, sK,
                dq + (long long)b * q_len * stride + (long long)h * D, stride,
                q0 + 16 * warp, q_len);
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, int out_f32, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int batch, int heads, int kv_heads, int q_len,
                   int k_len, int causal, int window, float scale,
                   cudaStream_t stream) {
  using T = Tiles<D, DV>;
  // runtime calls first: they make the device's primary context current
  // on this thread (autograd's worker may have none yet), which
  // cuTensorMapEncodeTiled needs
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, batch, q_len, heads, D, T::QK::C, kTile) ||
      !tensor_map(&tk, k, batch, k_len, kv_heads, D, T::QK::C, kTile) ||
      !tensor_map(&tv, v, batch, k_len, kv_heads, DV, T::VO::C, kTile) ||
      !tensor_map(&tdo, dout, batch, q_len, heads, DV, T::VO::C, kTile))
    return cudaErrorInvalidValue;
  err = out_f32 ? launch_delta<float, bf16, DV>(out, dout, delta, batch,
                                                heads, q_len, stream)
                : launch_delta<bf16, bf16, DV>(out, dout, delta, batch,
                                               heads, q_len, stream);
  if (err != cudaSuccess) return err;
  const int k_tiles = (k_len + kTile - 1) / kTile;
  const int q_tiles = (q_len + kTile - 1) / kTile;
  flash_bwd_dkdv_bf16_kernel<D, DV>
      <<<dim3(k_tiles, kv_heads, batch * (T::kSplit ? 2 : 1)), kThreads,
         T::kSmem, stream>>>(tq, tk, tv, tdo, lse, delta,
                             static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                             heads, kv_heads, q_len, k_len, causal, window,
                             scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16_kernel<D, DV>
      <<<dim3(q_tiles, heads, batch), kThreads, T::kSmem, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), heads,
          kv_heads, q_len, k_len, causal, window, scale);
  return cudaGetLastError();
}

// registers, local bytes, static and dynamic shared memory of one kernel
// of the route: 0 the delta pass, 1 dK/dV, 2 dQ
template <int D, int DV>
cudaError_t attributes(int kernel, int* regs, int* local_bytes,
                       int* static_smem, int* dynamic_smem) {
  const void* fn =
      kernel == 0 ? reinterpret_cast<const void*>(
                        ::flash_bwd_delta_kernel<bf16, bf16, DV>)
      : kernel == 1
          ? reinterpret_cast<const void*>(flash_bwd_dkdv_bf16_kernel<D, DV>)
          : reinterpret_cast<const void*>(flash_bwd_dq_bf16_kernel<D, DV>);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem = kernel == 0 ? 0 : Tiles<D, DV>::kSmem;
  return cudaSuccess;
}

}  // namespace tc

// The head-dim pairs (D, DV) of each route, as the forward's
// (flash_attention.cu): the tensor cores take rows of 32 or 128 swizzled
// bytes a column block, so (24, 16) is the CUDA cores' alone.
#define FLASH_BWD_TC_PAIRS(X) \
  X(16, 16) X(64, 64) X(128, 128) X(256, 256) X(192, 128)
#define FLASH_BWD_F32_PAIRS(X) FLASH_BWD_TC_PAIRS(X) X(24, 16)

// Launches the three kernels of a route on `stream` and returns the first
// launch error (0 = all queued). q and dq are (B, S, H, D), out and dout
// (B, S, H, DV); k and dk (B, T, KH, D), v and dv (B, T, KH, DV):
// contiguous, 16-byte aligned, all float32 (tensor_core = 0: the CUDA-core
// kernels) or all bfloat16 (tensor_core = 1: the tensor-core kernels),
// except `out`, float32 on the tensor cores too when out_f32 (the
// forward's O before its rounding); `out` is the forward's output for
// these q, k, v and `lse` the float32 (B, H, S) log-sum-exp that the
// forward kept with it; `delta` is float32 (B, H, S) scratch, which the
// first kernel fills with rowsum(dout * out) and the other two read.
// H % KH == 0, (D, DV) a pair of the route (FLASH_BWD_TC_PAIRS,
// FLASH_BWD_F32_PAIRS), S*H*max(D, DV) and T*KH*max(D, DV) below 2^31,
// B <= 32767 on the tensor cores where D + DV > 256 (two dK/dV blocks a
// batch row); window <= 0 means no window. Anything else returns
// cudaErrorInvalidValue: neither route stands in for the other.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int batch, int heads, int kv_heads,
                                   int q_len, int k_len, int head_dim,
                                   int v_head_dim, int causal, int window,
                                   float scale, int tensor_core, int out_f32,
                                   void* stream) {
  const long long width = head_dim > v_head_dim ? head_dim : v_head_dim;
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 ||
      kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 || k_len <= 0 ||
      head_dim <= 0 || v_head_dim <= 0 ||
      (long long)q_len * heads * width >= (1LL << 31) ||
      (long long)k_len * kv_heads * width >= (1LL << 31) ||
      (tensor_core && head_dim + v_head_dim > 256 && batch > 32767) ||
      (out_f32 && !tensor_core))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (tensor_core) {
#define FLASH_BWD_TC_CASE(D, DV)                                             \
  if (head_dim == D && v_head_dim == DV)                                     \
    return (int)tc::launch<D, DV>(q, k, v, out, out_f32, dout, l, d, dq, dk, \
                                  dv, batch, heads, kv_heads, q_len, k_len,  \
                                  causal, window, scale, s);
    FLASH_BWD_TC_PAIRS(FLASH_BWD_TC_CASE)
#undef FLASH_BWD_TC_CASE
  } else {
#define FLASH_BWD_F32_CASE(D, DV)                                             \
  if (head_dim == D && v_head_dim == DV)                                      \
    return (int)launch<D, DV>(q, k, v, out, dout, l, d, dq, dk, dv, batch,    \
                              heads, kv_heads, q_len, k_len, causal, window, \
                              scale, s);
    FLASH_BWD_F32_PAIRS(FLASH_BWD_F32_CASE)
#undef FLASH_BWD_F32_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route's resources at head dims (D, DV): registers a
// thread, local (spilled) bytes a thread, static and dynamic shared memory
// a block of kernel 0 (delta), 1 (dK/dV) or 2 (dQ).
extern "C" int flash_attention_bwd_attributes(int head_dim, int v_head_dim,
                                              int kernel, int* regs,
                                              int* local_bytes,
                                              int* static_smem,
                                              int* dynamic_smem) {
  if (kernel < 0 || kernel > 2) return (int)cudaErrorInvalidValue;
#define FLASH_BWD_ATTRIBUTES(D, DV)                               \
  if (head_dim == D && v_head_dim == DV)                          \
    return (int)tc::attributes<D, DV>(kernel, regs, local_bytes,  \
                                      static_smem, dynamic_smem);
  FLASH_BWD_TC_PAIRS(FLASH_BWD_ATTRIBUTES)
#undef FLASH_BWD_ATTRIBUTES
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
