// Stabilized chunkwise mLSTM, forward from a fresh state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mlstm_kernel` / `mlstm_chunkwise` of
// src/repro/kernels/mlstm/kernel.py:24-121. For every batch row and head
// (one "bh") the sequence is cut into chunks of L rows, the last one short
// when S % L != 0 (the TPU kernel asks S % L == 0; nothing is padded here).
// In chunk c, with the carried state (C, n, m) of the chunks before it
// (C = 0, n = 0, m = -1e30 before the first) and i, j the chunk's rows:
//   b_i     = sum_{t <= i} log_f_t                  (cumulative log-forget)
//   D_ij    = (b_i - b_j) + log_i_j, j <= i
//   m_new_i = max(b_i + m, max_{j <= i} D_ij)       (row stabilizer)
//   W_ij    = <q_i, k_j> * exp(D_ij - m_new_i),  j <= i
//   h_i     = (sum_j W_ij v_j + exp(b_i + m - m_new_i) * q_i C)
//             / max(|sum_j W_ij + exp(b_i + m - m_new_i) * <q_i, n>|,
//                   exp(-m_new_i))
// and the state after the chunk, with total_f = b at its last real row:
//   m' = max(total_f + m, max_j (b_j + log_i_j))
//   kd_j = exp(total_f - b_j + log_i_j - m'),  decay = exp(total_f + m - m')
//   C' = decay C + sum_j kd_j k_j v_j^T,  n' = decay n + sum_j kd_j k_j
// b is summed in float64 and rounded to float32, as the plain version does,
// so the two agree on it to the bit whatever order each sums in (a float32
// cumsum's rounding, amplified by exp, is the largest difference between two
// orders). Only real rows enter b, total_f, the maxima and the sums. The
// fresh m is finite and the causal mask is a bound on j, not -inf, so no
// exp sees -inf - -inf. q/k/v and h are float32 or bfloat16 in the model's
// layout (B, S, H, hd), read and written in place; the gates are (B, S, H)
// float32; C (B, H, hd, hd), n (B, H, hd) and m (B, H) come out in float32.
// All other arithmetic is float32.
//
// What bounds it: operations. Per (bh, chunk) the work is about L^2*hd for
// the causal scores, L^2*hd for W v, and 2*L*hd^2 each for q C and the
// update of C; at the full-width xLSTM-1.3B prefill (H = 4, hd = 1024,
// S = 4096, L = 256) that is about 77 GFLOP against about 151 MB of device
// memory, compute-bound on the tensor cores' 989 TFLOP/s. The TPU kernel
// runs the chunks of one bh in order on one core with the whole 4 MB C in
// VMEM. On Hopper a block has 227 KB of shared memory and a grid of BH
// sequential programs would be 4 blocks on 132 SMs. Two routes, chosen by
// the input type:
//   - bfloat16, what serving runs: the tensor-core kernels of namespace tc
//     below (wgmma + TMA), whose design is described there;
//   - float32: the CUDA-core kernels right below, whose checks against the
//     plain version are held at 2e-5 / 1e-4; tensor cores reach that only
//     from bf16 inputs, so float32 stays on CUDA cores.
// The float32 route (CUDA-core float32 FMAs, no mma/wgmma, no TMA) splits
// the work so that what does not depend on the value column is done once:
//   1. gates: one block per bh walks the chunks in order and computes the
//      scalars of every row and chunk (b, m_new, the carry's decay
//      exp(b + m - m_new), the key decay, the chunk decay) and the final m;
//   2. n carry: one block per (32 key channels, bh) sums each chunk's
//      decayed keys over 8 warps and walks the chunks in order, keeping n
//      before every chunk (n needs no v);
//   3. weights: one block per (64 rows, chunk, bh) computes the causal
//      scores over all hd channels once, W and the normaliser of every row;
//   4. values: C is tiled over its value (column) dimension, which the
//      update and q C keep independent: one block per (32 value columns,
//      bh), 128 blocks at the full-width shape, keeps its hd x 32 tile of C
//      in shared memory (128 KB at hd = 1024), walks the chunks in order and
//      writes h for its columns and, at the end, its tile of C.
// Pass 3 stages 32-wide slices of q and k as float32 in pitch-33 shared
// tiles, and thread (ty, tx) owns 4 x 4 scores. Pass 4 stages 32-wide
// slices of q, W or the decayed keys transposed (a thread's 8 rows are
// contiguous: two 16-byte shared loads), loads the next slice into
// registers while it multiplies the current one, and thread (ty, tx) owns
// 8 rows x 4 columns of each product. The four launches go on the caller's
// stream in order; the scratch (rows, chunk decays, n per chunk, W) is the
// caller's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;  // rows of a chunk: one thread per row in pass 1
constexpr int kSlice = 32;      // width of a staged slice of q, k or W
constexpr int kPitch = kSlice + 1;  // row pitch of pass 3's staged tiles
constexpr int kTileE = 32;      // value columns per block of pass 4
constexpr int kRowTile = 64;    // rows (and columns) of a score tile, pass 3
constexpr float kMInit = -1e30f;
constexpr float kNegInf = -3.402823466e38f;  // below every finite float


// Offsets of one head's rows in the model's layout: row s of head bh % H of
// batch row bh / H is at base + s * stride.
struct Rows {
  long long base;
  int stride;
  __device__ __forceinline__ long long at(int s) const {
    return base + (long long)s * stride;
  }
};

struct Layout {
  int S, H, hd, L, nc;
  // q/k/v/h (B, S, H, hd)
  __device__ __forceinline__ Rows rows(int bh) const {
    return {(long long)(bh / H) * S * H * hd + (long long)(bh % H) * hd,
            H * hd};
  }
  // log_i/log_f (B, S, H)
  __device__ __forceinline__ Rows gates(int bh) const {
    return {(long long)(bh / H) * S * H + bh % H, H};
  }
};

// Rows of vs and the row pitch of W: the chunk's rows rounded up to whole
// slices.
__host__ __device__ constexpr int padded(int L) {
  return (L + kSlice - 1) / kSlice * kSlice;
}

// Per-row scratch: [kind][bh][s], kinds below.
enum { kB = 0, kMNew, kInterS, kKDecay, kDenom, kRowKinds };

__device__ __forceinline__ float warp_sum16(float x) {
  // sum over the 16 lanes of a half-warp
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------- pass 1
// One block of kThreads per bh; thread i owns row i of the current chunk.
__global__ void __launch_bounds__(kThreads)
    mlstm_gates_kernel(const float* __restrict__ log_i,
                       const float* __restrict__ log_f, Layout lay, int BH,
                       float* __restrict__ rows, float* __restrict__ decay,
                       float* __restrict__ m_out) {
  __shared__ float b_s[kMaxChunk];
  __shared__ float li_s[kMaxChunk];
  __shared__ double warp_tot[kThreads / 32];
  __shared__ float warp_max[kThreads / 32];
  const int bh = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const Rows gr = lay.gates(bh);
  const long long plane = (long long)BH * lay.S;
  float* r_b = rows + kB * plane + (long long)bh * lay.S;
  float* r_m = rows + kMNew * plane + (long long)bh * lay.S;
  float* r_inter = rows + kInterS * plane + (long long)bh * lay.S;
  float* r_kd = rows + kKDecay * plane + (long long)bh * lay.S;
  float m_prev = kMInit;
  for (int c = 0; c < lay.nc; ++c) {
    const int r0 = c * lay.L;
    const int Lc = min(lay.L, lay.S - r0);
    const bool real = i < Lc;
    const float lf = real ? log_f[gr.at(r0 + i)] : 0.f;
    const float li = real ? log_i[gr.at(r0 + i)] : 0.f;
    // inclusive scan of lf over the block in float64: in the warp, then
    // the warp totals
    double acc = lf;
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, acc, off);
      if (lane >= off) acc += y;
    }
    if (lane == 31) warp_tot[warp] = acc;
    __syncthreads();
    for (int w = 0; w < warp; ++w) acc += warp_tot[w];
    const float b = (float)acc;
    b_s[i] = b;
    li_s[i] = li;
    // max over real rows of b_j + li_j
    float mx = real ? b + li : kNegInf;
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) warp_max[warp] = mx;
    __syncthreads();
    float a_max = kNegInf;
    for (int w = 0; w < kThreads / 32; ++w) a_max = fmaxf(a_max, warp_max[w]);
    const float total_f = b_s[Lc - 1];
    const float m_next = fmaxf(total_f + m_prev, a_max);
    if (real) {
      float m_intra = kNegInf;
      for (int j = 0; j <= i; ++j)
        m_intra = fmaxf(m_intra, (b - b_s[j]) + li_s[j]);
      const float m_new = fmaxf(b + m_prev, m_intra);
      r_b[r0 + i] = b;
      r_m[r0 + i] = m_new;
      r_inter[r0 + i] = expf((b + m_prev) - m_new);
      r_kd[r0 + i] = expf(((total_f - b) + li) - m_next);
    }
    if (i == 0)
      decay[(long long)bh * lay.nc + c] = expf((total_f + m_prev) - m_next);
    m_prev = m_next;
    __syncthreads();  // b_s, li_s and the warp partials are reused
  }
  if (i == 0) m_out[bh] = m_prev;
}

// ---------------------------------------------------------------- pass 2
// One block per (32 key channels, bh): each of 8 warps sums every 8th row
// of a chunk for the block's channels, and the first walks the chunks in
// order: n before every chunk, and the final n.
constexpr int kNGroups = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    mlstm_n_kernel(const float* __restrict__ k, Layout lay, int BH,
                   const float* __restrict__ rows,
                   const float* __restrict__ decay,
                   float* __restrict__ n_prev, float* __restrict__ n_out) {
  __shared__ float part[kNGroups][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;  // hd is a multiple of 32
  const int bh = blockIdx.y;
  const Rows hr = lay.rows(bh);
  const float* r_kd =
      rows + kKDecay * (long long)BH * lay.S + (long long)bh * lay.S;
  float n = 0.f;  // carried by the first warp
  for (int c = 0; c < lay.nc; ++c) {
    const int r0 = c * lay.L;
    const int Lc = min(lay.L, lay.S - r0);
    float acc = 0.f;
#pragma unroll 4
    for (int j = grp; j < Lc; j += kNGroups)
      acc += k[hr.at(r0 + j) + d] * r_kd[r0 + j];
    part[grp][lane] = acc;
    __syncthreads();
    if (grp == 0) {
      float sum = part[0][lane];
      for (int g = 1; g < kNGroups; ++g) sum += part[g][lane];
      n_prev[((long long)bh * lay.nc + c) * lay.hd + d] = n;
      n = decay[(long long)bh * lay.nc + c] * n + sum;
    }
    __syncthreads();  // part is reused
  }
  if (grp == 0) n_out[(long long)bh * lay.hd + d] = n;
}

// ---------------------------------------------------------------- pass 3
// acc[r][c] += sum_dd xs[4 ty + r][dd] * ys[4 tx + c][dd], dd < kSlice.
// kSplit (the backward's): the slice's sum apart, then added, so a sum over
// n terms rounds as n / 32 serial sums of 32 and one of n / 32 (long serial
// sums put the backward further from float64 than the plain version's
// products). The forward keeps the serial sum, whose bits its full-depth
// float32 check was measured on.
template <bool kSplit = false>
__device__ __forceinline__ void dot_slice(const float (*xs)[kPitch],
                                          const float (*ys)[kPitch], int ty,
                                          int tx, float acc[4][4]) {
  if (kSplit) {
    float part[4][4] = {};
    dot_slice<false>(xs, ys, ty, tx, part);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += part[r][c];
    return;
  }
#pragma unroll 8
  for (int dd = 0; dd < kSlice; ++dd) {
    float a[4], bb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = xs[ty * 4 + r][dd];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) bb[cc] = ys[tx * 4 + cc][dd];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r][cc] += a[r] * bb[cc];
  }
}

// One block per (64 rows, chunk, bh): W for those rows over every column
// tile up to the diagonal, and the normaliser of each row (and, for the
// backward, the signed denominator when den_raw is not null; kSplit: the
// split sums of dot_slice).
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_weights_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ log_i, Layout lay, int BH,
                         float* __restrict__ rows,
                         const float* __restrict__ n_prev,
                         float* __restrict__ W,
                         float* __restrict__ den_raw) {
  __shared__ float qs[kRowTile][kPitch];
  __shared__ float ks[kRowTile][kPitch];
  __shared__ float bj_s[kRowTile];
  __shared__ float lij_s[kRowTile];
  const int c = blockIdx.y, bh = blockIdx.z;
  const int r0 = c * lay.L;
  const int Lc = min(lay.L, lay.S - r0);
  const int i0 = blockIdx.x * kRowTile;
  if (i0 >= Lc) return;  // the whole block: no barrier is skipped
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const Rows hr = lay.rows(bh), gr = lay.gates(bh);
  const long long plane = (long long)BH * lay.S;
  const float* r_b = rows + kB * plane + (long long)bh * lay.S + r0;
  const float* r_m = rows + kMNew * plane + (long long)bh * lay.S + r0;
  const float* r_inter = rows + kInterS * plane + (long long)bh * lay.S + r0;
  float* r_den = rows + kDenom * plane + (long long)bh * lay.S + r0;
  const int Wp = padded(lay.L);
  float* Wc = W + ((long long)bh * lay.nc + c) * lay.L * Wp;

  float b_i[4], m_i[4], rowsum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    b_i[r] = i < Lc ? r_b[i] : 0.f;
    m_i[r] = i < Lc ? r_m[i] : 0.f;
    rowsum[r] = 0.f;
  }
  const int n_col_tiles = blockIdx.x + 1;  // up to the diagonal tile
  for (int jt = 0; jt < n_col_tiles; ++jt) {
    const int j0 = jt * kRowTile;
    if (t < kRowTile) {
      const int j = j0 + t;
      bj_s[t] = j < Lc ? r_b[j] : 0.f;
      lij_s[t] = j < Lc ? log_i[gr.at(r0 + j)] : 0.f;
    }
    float acc[4][4] = {};
    for (int d0 = 0; d0 < lay.hd; d0 += kSlice) {
      for (int idx = t; idx < kRowTile * kSlice; idx += kThreads) {
        const int r = idx / kSlice, dd = idx % kSlice;
        const int i = i0 + r, j = j0 + r;
        qs[r][dd] = i < Lc ? q[hr.at(r0 + i) + d0 + dd] : 0.f;
        ks[r][dd] = j < Lc ? k[hr.at(r0 + j) + d0 + dd] : 0.f;
      }
      __syncthreads();
      dot_slice<kSplit>(qs, ks, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int jl = tx * 4 + cc, j = j0 + jl;
        float w = 0.f;
        if (i < Lc && j <= i)
          w = acc[r][cc] * expf(((b_i[r] - bj_s[jl]) + lij_s[jl]) - m_i[r]);
        if (i < Lc && j < Lc) Wc[(long long)i * Wp + j] = w;
        rowsum[r] += w;
      }
    }
    __syncthreads();  // bj_s, lij_s are reloaded for the next column tile
  }
  // <q_i, n> with n before this chunk; 16 lanes per row
  const float* n_c = n_prev + ((long long)bh * lay.nc + c) * lay.hd;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    float qn = 0.f;
    if (i < Lc) {
      const long long base = hr.at(r0 + i);
      for (int d = tx; d < lay.hd; d += 16) qn += q[base + d] * n_c[d];
    }
    qn = warp_sum16(qn);
    const float den = warp_sum16(rowsum[r]) + qn * r_inter[i < Lc ? i : 0];
    if (tx == 0 && i < Lc) {
      r_den[i] = fmaxf(fabsf(den), expf(-m_i[r]));
      // the backward's: the sign of den and which term of the max won
      if (den_raw) den_raw[(long long)bh * lay.S + r0 + i] = den;
    }
  }
}

// ---------------------------------------------------------------- pass 4
// One block per (kTileE value columns, bh); C's tile stays in shared memory.
// Dynamic shared memory: Cs[hd][kTileE], vs[padded(L)][kTileE], the staged
// slice at[kSlice][kThreads] (transposed: thread rows are contiguous), then
// the chunk's carry decay, normaliser and key decay per row. The backward
// passes C_chunks (C entering every chunk) and no C_out; h is float32
// there, and its sums are split (kSplit, see dot_slice).
static_assert(kTileE == 32, "thread (ty, tx) owns columns 4 tx .. 4 tx + 3");

__host__ __device__ constexpr size_t values_smem(int hd, int L) {
  return sizeof(float) * ((size_t)hd * kTileE + (size_t)padded(L) * kTileE +
                          (size_t)kSlice * kThreads + 3 * (size_t)kMaxChunk);
}

// 32 consecutive elements (16-byte aligned) into float registers
__device__ __forceinline__ void load32(const float* p, float* o) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float4 x = *reinterpret_cast<const float4*>(p + 4 * u);
    o[4 * u] = x.x;
    o[4 * u + 1] = x.y;
    o[4 * u + 2] = x.z;
    o[4 * u + 3] = x.w;
  }
}

// acc[r][c] += sum_kk at[kk][8 ty + r] * B[kk][4 tx + c], kk < kSlice;
// kSplit as dot_slice's.
template <bool kSplit = false>
__device__ __forceinline__ void fma_slice(const float* at, const float* B,
                                          int ty, int tx, float acc[8][4]) {
  if (kSplit) {
    float part[8][4] = {};
    fma_slice<false>(at, B, ty, tx, part);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += part[r][c];
    return;
  }
#pragma unroll 4
  for (int kk = 0; kk < kSlice; ++kk) {
    const float* a_row = at + kk * kThreads + ty * 8;
    const float4 a0 = *reinterpret_cast<const float4*>(a_row);
    const float4 a1 = *reinterpret_cast<const float4*>(a_row + 4);
    const float4 bv =
        *reinterpret_cast<const float4*>(B + kk * kTileE + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      acc[r][0] += a[r] * bv.x;
      acc[r][1] += a[r] * bv.y;
      acc[r][2] += a[r] * bv.z;
      acc[r][3] += a[r] * bv.w;
    }
  }
}

// Thread t stages element u of the slice into at[u][t]. Every product
// below loads its next slice into registers (`pre`) before it multiplies
// the current one, so the loads are in flight during the FMAs.
__device__ __forceinline__ void stage(float* at, const float* pre, int t) {
#pragma unroll
  for (int u = 0; u < kSlice; ++u) at[u * kThreads + t] = pre[u];
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_values_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, Layout lay, int BH,
                        const float* __restrict__ rows,
                        const float* __restrict__ decay,
                        const float* __restrict__ W, float* __restrict__ h,
                        float* __restrict__ C_out,
                        float* __restrict__ C_chunks) {
  extern __shared__ float smem[];
  float* Cs = smem;                                   // [hd][kTileE]
  float* vs = Cs + (size_t)lay.hd * kTileE;           // [padded(L)][kTileE]
  float* at = vs + (size_t)padded(lay.L) * kTileE;    // [kSlice][kThreads]
  float* inter_s = at + (size_t)kSlice * kThreads;    // [kMaxChunk]
  float* denom_s = inter_s + kMaxChunk;
  float* kd_s = denom_s + kMaxChunk;
  const int e0 = blockIdx.x * kTileE, bh = blockIdx.y;
  const int t = threadIdx.x, tx = t & 7, ty = t >> 3;
  const Rows hr = lay.rows(bh);
  const int Wp = padded(lay.L);
  const long long plane = (long long)BH * lay.S;
  const float* r_inter = rows + kInterS * plane + (long long)bh * lay.S;
  const float* r_den = rows + kDenom * plane + (long long)bh * lay.S;
  const float* r_kd = rows + kKDecay * plane + (long long)bh * lay.S;
  float pre[kSlice];

  for (int idx = t; idx < lay.hd * kTileE; idx += kThreads) Cs[idx] = 0.f;
  for (int c = 0; c < lay.nc; ++c) {
    const int r0 = c * lay.L;
    const int Lc = min(lay.L, lay.S - r0);
    const float* Wc = W + ((long long)bh * lay.nc + c) * lay.L * Wp;
    if (C_chunks) {  // the backward's: C entering the chunk
      float* Cc = C_chunks + ((long long)bh * lay.nc + c) * lay.hd * lay.hd;
      for (int idx = t; idx < lay.hd * kTileE; idx += kThreads)
        Cc[(long long)(idx / kTileE) * lay.hd + e0 + idx % kTileE] = Cs[idx];
    }
    // rows past Lc are zeros: the last slice reads them against zero weights
    for (int idx = t; idx < Wp * kTileE; idx += kThreads) {
      const int j = idx / kTileE, e = idx % kTileE;
      vs[idx] = j < Lc ? v[hr.at(r0 + j) + e0 + e] : 0.f;
    }
    for (int i = t; i < kMaxChunk; i += kThreads) {
      inter_s[i] = i < Lc ? r_inter[r0 + i] : 0.f;
      denom_s[i] = i < Lc ? r_den[r0 + i] : 1.f;
      kd_s[i] = i < Lc ? r_kd[r0 + i] : 0.f;
    }

    // q C for rows 8 ty .. 8 ty + 7, with C before this chunk; thread t
    // loads row t of q
    auto load_q = [&](int d0) {
      if (t < Lc) {
        load32(q + hr.at(r0 + t) + d0, pre);
      } else {
#pragma unroll
        for (int u = 0; u < kSlice; ++u) pre[u] = 0.f;
      }
    };
    float qc[8][4] = {};
    load_q(0);
    for (int d0 = 0; d0 < lay.hd; d0 += kSlice) {
      __syncthreads();  // readers of the last slice (and of vs) are done
      stage(at, pre, t);
      __syncthreads();
      if (d0 + kSlice < lay.hd) load_q(d0 + kSlice);
      fma_slice<kSplit>(at, Cs + (size_t)d0 * kTileE, ty, tx, qc);
    }
    // sum_{j <= i} W_ij v_j; thread t loads row t of W
    auto load_w = [&](int j0) {
      if (t < Lc) load32(Wc + (long long)t * Wp + j0, pre);
#pragma unroll
      for (int u = 0; u < kSlice; ++u)
        if (t >= Lc || j0 + u > t) pre[u] = 0.f;
    };
    float intra[8][4] = {};
    load_w(0);
    for (int j0 = 0; j0 < Lc; j0 += kSlice) {
      __syncthreads();
      stage(at, pre, t);
      __syncthreads();
      if (j0 + kSlice < Lc) load_w(j0 + kSlice);
      if (ty * 8 + 7 >= j0)  // rows above the slice see only zeros
        fma_slice<kSplit>(at, vs + (size_t)j0 * kTileE, ty, tx, intra);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty * 8 + r;
      if (i >= Lc) continue;
      const long long base = hr.at(r0 + i) + e0 + tx * 4;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        h[base + cc] = (intra[r][cc] + qc[r][cc] * inter_s[i]) / denom_s[i];
    }

    // C <- decay C + sum_j (kdecay_j k_j) v_j^T, 256 key channels at a
    // time; thread t loads key channel dblk + t of 32 rows
    const float dc = decay[(long long)bh * lay.nc + c];
    for (int dblk = 0; dblk < lay.hd; dblk += kThreads) {
      const int d = dblk + t;
      auto load_k = [&](int j0) {
#pragma unroll
        for (int u = 0; u < kSlice; ++u)
          pre[u] = (j0 + u < Lc && d < lay.hd)
                       ? k[hr.at(r0 + j0 + u) + d]
                       : 0.f;
      };
      float upd[8][4] = {};
      load_k(0);
      for (int j0 = 0; j0 < Lc; j0 += kSlice) {
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kSlice; ++u)
          at[u * kThreads + t] = pre[u] * kd_s[j0 + u];
        __syncthreads();
        if (j0 + kSlice < Lc) load_k(j0 + kSlice);
        fma_slice<kSplit>(at, vs + (size_t)j0 * kTileE, ty, tx, upd);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {  // rows of Cs no other thread touches
        const int dr = dblk + ty * 8 + r;
        if (dr >= lay.hd) continue;
        float* row = Cs + (size_t)dr * kTileE + tx * 4;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) row[cc] = dc * row[cc] + upd[r][cc];
      }
    }
    __syncthreads();  // vs, the row scalars and Cs before the next chunk
  }
  if (!C_out) return;
  for (int idx = t; idx < lay.hd * kTileE; idx += kThreads) {
    const int d = idx / kTileE, e = idx % kTileE;
    C_out[((long long)bh * lay.hd + d) * lay.hd + e0 + e] = Cs[idx];
  }
}

// The float32 route: the four CUDA-core passes above.
cudaError_t dispatch_f32(const float* q, const float* k, const float* v,
                         const float* log_i, const float* log_f, float* h,
                         float* C, float* n, float* m, float* scratch, int BH,
                         Layout lay, cudaStream_t s) {
  float* rows = scratch;
  float* decay = rows + kRowKinds * (long long)BH * lay.S;
  float* n_prev = decay + (long long)BH * lay.nc;
  float* W = n_prev + (long long)BH * lay.nc * lay.hd;
  mlstm_gates_kernel<<<BH, kThreads, 0, s>>>(log_i, log_f, lay, BH, rows,
                                             decay, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_n_kernel<<<dim3(lay.hd / 32, BH), kThreads, 0, s>>>(
      k, lay, BH, rows, decay, n_prev, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_weights_kernel<false>
      <<<dim3((lay.L + kRowTile - 1) / kRowTile, lay.nc, BH), kThreads, 0, s>>>(
          q, k, log_i, lay, BH, rows, n_prev, W, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = values_smem(lay.hd, lay.L);
  err = cudaFuncSetAttribute(mlstm_values_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  mlstm_values_kernel<false>
      <<<dim3(lay.hd / kTileE, BH), kThreads, smem, s>>>(
          q, k, v, lay, BH, rows, decay, W, h, C, nullptr);
  return cudaGetLastError();
}

// Bytes of the float32 route's scratch: rows (5 * B*H * S), decay
// (B*H * nc), n per chunk (B*H * nc * hd) and W (B*H * nc * L * padded(L))
// in float32.
long long f32_scratch_bytes(long long BH, int S, int hd, int L, int nc) {
  return 4 * BH *
         (kRowKinds * (long long)S + nc + (long long)nc * hd +
          (long long)nc * L * padded(L));
}

// ======================================================================
// The backward: two routes, chosen by the input type as the forward's.
//
// Replaces the reference's custom VJP (src/repro/kernels/mlstm/ops.py:38,
// `_bwd`: jax.vjp of the plain chunkwise form), which has no pallas_call:
// dq, dk, dv, dlog_i and dlog_f from the cotangent g of h (the returned
// state gets none). h_i = num_i / N_i does not depend on the stabilizers:
// with den_i = exp(-m_new_i) Dn_i it is the unstabilised numerator over
// max(|Dn_i|, 1), so every m is a constant of the gradient (the reference's
// autodiff goes through its maxima, and those terms sum to zero). Per chunk,
// with u_i = g_i / N_i and s_i = -sign(den_i) <g_i, h_i> / N_i where |den_i|
// is the larger term of N_i (else 0):
//   dW_ij = <u_i, v_j> + s_i (j <= i), dS = dW * exp(D - m_new),
//   dq = dS k + inter_s (C u + s n),  dk = dS^T q + kd (dC' v + dn'),
//   dv = W^T u + kd dC'^T k,
// with (C, n) the state entering the chunk and (dC', dn') the cotangent of
// the state after it, carried from the last chunk:
//   dC = decay dC' + sum_i inter_s_i q_i u_i^T,
//   dn = decay dn' + sum_i inter_s_i s_i q_i.
// dC is carried in the scale of C (C is stabilised by its m), where decay
// and inter_s are at most 1, so it needs no stabilizer of its own. The log
// cotangents: dW * W on D_ij = b_i - b_j + log_i_j, inter_s_i <q_i, C u_i +
// s_i n> on b_i, kd_j <k_j, dC' v_j + dn'> on the log of kd_j (total_f - b_j
// + log_i_j) and decay <dC', C> + decay <dn', n> on total_f; dlog_f is the
// reverse cumulative sum of b's cotangents inside the chunk. These scalars
// are summed in float64 and rounded to float32, as the forward sums b. No
// route uses atomics: every sum has one order, and a launch gives the same
// bits every time.
//
// What bounds it: operations, about 2.5x the forward's (the state terms
// C u, dC' v and dC'^T k are three more L x hd x hd products a chunk,
// the recomputed C and the dC carry two). Both routes recompute rather
// than save, so autograd keeps only the inputs; every pass either walks the
// chunks (the carries) or is parallel over (rows, columns, chunk, bh).
//
// float32 inputs, the CUDA-core route (its checks are held at 1e-4 and
// within 2x the plain version's distance from float64, which tensor cores
// reach only from bf16 inputs); <g_i, h_i> from a float32 h recomputed here:
//   1-4. the float32 forward's passes: the row scalars, n before every
//      chunk, W and N (and den, signed), and h in float32 with C entering
//      every chunk written to scratch; their long sums split into slices
//      of 32 (dot_slice), as every sum below over more than 32 terms;
//   5. s: a warp a row, <g_i, h_i> in a fixed order;
//   6. dC walk: one block per (32 value columns, bh), dC's hd x 32 tile in
//      shared memory, from the last chunk: writes dC' of every chunk and
//      the tile's part of <dC', C>;
//   7. dn walk: one block per (32 key channels, bh), the same for dn;
//   8. dW: one block per (64 rows, chunk, bh) as the forward's pass 3:
//      dS to scratch, the row sums of dW * W and per-tile column sums;
//   9. dq, dk, dv: one block per (64 rows, 64 columns, chunk, bh), the
//      intra-chunk product and the state product into one accumulator,
//      with per-column-tile parts of the row dots <q_i, C u_i + s_i n> and
//      <k_j, dC' v_j + dn'>;
//  10. gates: one block per (chunk, bh), the parts summed in float64 in a
//      fixed order, dlog_i, and dlog_f by a reverse scan in float64.
//
// bfloat16 inputs, the tensor-core route (namespace tc, after the
// forward's kernels, which it reuses): wgmma with float32 accumulators,
// operands by TMA from q, k, v and g in place (no float32 copies), two
// stages a ring. A float32 operand enters a product as three bf16 planes
// hi + mid + lo (float32's precision, as in the forward): w q (below), C,
// dC', dS and W / N, three planes each; q, k, v and g enter as they are. It
// recomputes no h: with the products it forms anyway,
//   <g_i, h_i> = sum_{j <= i} W_ij <u_i, v_j> + inter_s_i <q_i, C u_i>.
// On the caller's stream:
//   1-3. the forward's gates, states (C entering every chunk as planes, n
//      before every chunk) and scores (W as planes, N, and for the backward
//      the signed den and <q_i, n>);
//   4. cu: y = C u for every row of chunks >= 1 (m64n256 tiles of 128 rows
//      x 256 columns over hd), written in float32, with the rows' parts of
//      <q_i, y_i>;
//   5. dW: one block per (128 rows, chunk, bh): G = g v^T up to the
//      diagonal, <g_i, h_i> by the identity, s, dS and W / N as planes, the
//      row and column sums of dW * W;
//   6. dC walk: the states kernel mirrored, one block per (128 d, 128 e,
//      bh) from the last chunk: dC <- decay dC + (w q)^T g with w = inter_s
//      / N (m64n128, both operands MN-major), writing dC' of every chunk as
//      planes and the tile's part of <dC', C>;
//   7. the dn walk of the CUDA-core route (pass 7), q read as bf16;
//   8. dq = dS k + inter_s (y + s n), dk = kd (dC' v + dn') + dS^T q and
//      dv = kd dC'^T k + (W / N)^T g: one block per (128 rows, 256
//      columns, chunk, bh), the state product over hd, then the chunk
//      product, into one accumulator (dk also writes the parts of
//      <k_j, dC' v_j + dn'>);
//   9. gates: pass 10 above, on this route's parts.

constexpr int kPT = 64;         // rows and columns of a product tile (pass 9)
constexpr int kBP = kPT + 4;    // row pitch of its staged B slice

__device__ __forceinline__ float warp_sum32(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ double warp_sum32(double x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The backward's own row scalars: [kind][bh][s] after the forward's.
enum { kDenRaw = 0, kSRow, kRowD, kBwdRowKinds };

// Pieces of the backward's scratch, in float32 words.
struct BwdScratch {
  long long rows, decay, m, n_prev, n_last, W, h, C, brows, dC, dn, dS,
      part_C, part_n, colpart, dots_q, dots_k, total;
};

__host__ __device__ inline int col_tiles(int hd) {
  return (hd + kPT - 1) / kPT;
}
__host__ __device__ inline int row_tiles(int L) {
  return (L + kPT - 1) / kPT;
}

inline BwdScratch bwd_scratch_of(long long BH, int S, int hd, int L,
                                 int nc) {
  BwdScratch o;
  long long at = 0;
  auto take = [&](long long n) {
    const long long here = at;
    at += (n + 3) / 4 * 4;  // every piece 16-byte aligned
    return here;
  };
  const long long cells = BH * S * hd, states = BH * nc * hd * hd;
  o.rows = take(kRowKinds * BH * S);
  o.decay = take(BH * nc);
  o.m = take(BH);
  o.n_prev = take(BH * nc * hd);
  o.n_last = take(BH * hd);
  o.W = take(BH * nc * (long long)L * padded(L));
  o.h = take(cells);
  o.C = take(states);
  o.brows = take(kBwdRowKinds * BH * S);
  o.dC = take(states);
  o.dn = take(BH * nc * hd);
  o.dS = take(BH * nc * (long long)L * padded(L));
  o.part_C = take(BH * nc * (hd / kTileE));
  o.part_n = take(BH * nc * (hd / 32));
  o.colpart = take(BH * nc * (long long)row_tiles(L) * L);
  o.dots_q = take(BH * S * col_tiles(hd));
  o.dots_k = take(BH * S * col_tiles(hd));
  o.total = at;
  return o;
}

// ---------------------------------------------------------------- pass 5
// s_i from <g_i, h_i>, a warp a row.
__global__ void __launch_bounds__(kThreads)
    mlstm_s_kernel(const float* __restrict__ g, const float* __restrict__ h,
                   Layout lay, int BH, const float* __restrict__ rows,
                   float* __restrict__ brows) {
  const int lane = threadIdx.x & 31;
  const long long w = blockIdx.x * (long long)(kThreads / 32) +
                      (threadIdx.x >> 5);
  if (w >= (long long)BH * lay.S) return;  // the whole warp
  const int bh = (int)(w / lay.S), s = (int)(w % lay.S);
  const long long base = lay.rows(bh).at(s);
  float acc = 0.f;
  for (int e = lane; e < lay.hd; e += 32) acc += g[base + e] * h[base + e];
  acc = warp_sum32(acc);
  if (lane == 0) {
    const long long plane = (long long)BH * lay.S;
    const float den = brows[kDenRaw * plane + w];
    const float norm = rows[kDenom * plane + w];
    const float m = rows[kMNew * plane + w];
    brows[kSRow * plane + w] =
        fabsf(den) > expf(-m) ? (-copysignf(1.f, den) * acc) / norm : 0.f;
  }
}

// ---------------------------------------------------------------- pass 6
// One block per (kTileE value columns, bh), the layout of pass 4: dC's tile
// in shared memory, walked from the last chunk. At chunk c it holds dC'
// (the cotangent of the state after c): writes it, and the tile's part of
// <dC', C_c>; then dC <- decay dC + sum_i (inter_s_i q_i) u_i^T.
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_dstate_kernel(const float* __restrict__ q,
                        const float* __restrict__ g, Layout lay, int BH,
                        const float* __restrict__ rows,
                        const float* __restrict__ decay,
                        const float* __restrict__ C_chunks,
                        float* __restrict__ dC_chunks,
                        float* __restrict__ part) {
  extern __shared__ float smem[];
  float* dCs = smem;                                  // [hd][kTileE]
  float* us = dCs + (size_t)lay.hd * kTileE;          // [padded(L)][kTileE]
  float* at = us + (size_t)padded(lay.L) * kTileE;    // [kSlice][kThreads]
  float* inter_s = at + (size_t)kSlice * kThreads;    // [kMaxChunk]
  float* red = inter_s + kMaxChunk;                   // [kThreads / 32]
  const int e0 = blockIdx.x * kTileE, bh = blockIdx.y;
  const int t = threadIdx.x, tx = t & 7, ty = t >> 3;
  const int lane = t & 31, warp = t >> 5;
  const Rows hr = lay.rows(bh);
  const int Wp = padded(lay.L);
  const long long plane = (long long)BH * lay.S;
  const float* r_inter = rows + kInterS * plane + (long long)bh * lay.S;
  const float* r_den = rows + kDenom * plane + (long long)bh * lay.S;
  float pre[kSlice];

  for (int idx = t; idx < lay.hd * kTileE; idx += kThreads) dCs[idx] = 0.f;
  for (int c = lay.nc - 1; c >= 0; --c) {
    const int r0 = c * lay.L;
    const int Lc = min(lay.L, lay.S - r0);
    const long long cell = ((long long)bh * lay.nc + c) * lay.hd * lay.hd;
    float dot = 0.f;  // this thread's elements of <dC', C_c>, in one order
    for (int idx = t; idx < lay.hd * kTileE; idx += kThreads) {
      const long long at_g =
          cell + (long long)(idx / kTileE) * lay.hd + e0 + idx % kTileE;
      dC_chunks[at_g] = dCs[idx];
      dot += dCs[idx] * C_chunks[at_g];
    }
    dot = warp_sum32(dot);
    if (lane == 0) red[warp] = dot;
    for (int idx = t; idx < Wp * kTileE; idx += kThreads) {
      const int i = idx / kTileE, e = idx % kTileE;
      us[idx] = i < Lc ? g[hr.at(r0 + i) + e0 + e] / r_den[r0 + i] : 0.f;
    }
    for (int i = t; i < kMaxChunk; i += kThreads)
      inter_s[i] = i < Lc ? r_inter[r0 + i] : 0.f;
    __syncthreads();
    if (t == 0) {
      float sum = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) sum += red[w];
      part[((long long)bh * lay.nc + c) * (lay.hd / kTileE) + blockIdx.x] =
          sum;
    }
    // dC <- decay dC + sum_i (inter_s_i q_i) u_i^T, 256 key channels at a
    // time, as pass 4 updates C
    const float dc = decay[(long long)bh * lay.nc + c];
    for (int dblk = 0; dblk < lay.hd; dblk += kThreads) {
      const int d = dblk + t;
      auto load_q = [&](int i0) {
#pragma unroll
        for (int u = 0; u < kSlice; ++u)
          pre[u] = (i0 + u < Lc && d < lay.hd) ? q[hr.at(r0 + i0 + u) + d]
                                               : 0.f;
      };
      float upd[8][4] = {};
      load_q(0);
      for (int i0 = 0; i0 < Lc; i0 += kSlice) {
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kSlice; ++u)
          at[u * kThreads + t] = pre[u] * inter_s[i0 + u];
        __syncthreads();
        if (i0 + kSlice < Lc) load_q(i0 + kSlice);
        fma_slice<true>(at, us + (size_t)i0 * kTileE, ty, tx, upd);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {  // rows of dCs no other thread touches
        const int dr = dblk + ty * 8 + r;
        if (dr >= lay.hd) continue;
        float* row = dCs + (size_t)dr * kTileE + tx * 4;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) row[cc] = dc * row[cc] + upd[r][cc];
      }
    }
    __syncthreads();  // us, inter_s, red and dCs before the next chunk
  }
}

// ---------------------------------------------------------------- pass 7
// One block per (32 key channels, bh), the layout of pass 2: dn walked from
// the last chunk; dn' of every chunk, and the block's part of <dn', n_c>.
// q is float32 here and bf16 on the tensor-core route, which runs this
// walk too (dn is a vector: no product to put on the tensor cores).
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_dn_kernel(const T* __restrict__ q, Layout lay, int BH,
                    const float* __restrict__ rows,
                    const float* __restrict__ brows,
                    const float* __restrict__ decay,
                    const float* __restrict__ n_prev,
                    float* __restrict__ dn_chunks,
                    float* __restrict__ part) {
  __shared__ float sums[kNGroups][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const int bh = blockIdx.y;
  const Rows hr = lay.rows(bh);
  const long long plane = (long long)BH * lay.S;
  const float* r_inter = rows + kInterS * plane + (long long)bh * lay.S;
  const float* r_s = brows + kSRow * plane + (long long)bh * lay.S;
  float dn = 0.f;  // carried by the first warp
  for (int c = lay.nc - 1; c >= 0; --c) {
    const int r0 = c * lay.L;
    const int Lc = min(lay.L, lay.S - r0);
    float acc = 0.f;
#pragma unroll 4
    for (int i = grp; i < Lc; i += kNGroups)
      acc += ld(q + hr.at(r0 + i) + d) * (r_inter[r0 + i] * r_s[r0 + i]);
    sums[grp][lane] = acc;
    __syncthreads();
    if (grp == 0) {
      float sum = sums[0][lane];
      for (int w = 1; w < kNGroups; ++w) sum += sums[w][lane];
      const long long cd = ((long long)bh * lay.nc + c) * lay.hd + d;
      dn_chunks[cd] = dn;
      const float dot = warp_sum32(dn * n_prev[cd]);
      if (lane == 0)
        part[((long long)bh * lay.nc + c) * (lay.hd / 32) + blockIdx.x] = dot;
      dn = decay[(long long)bh * lay.nc + c] * dn + sum;
    }
    __syncthreads();  // sums is reused
  }
}

// ---------------------------------------------------------------- pass 8
// One block per (64 rows, chunk, bh), the layout of pass 3: <g_i, v_j> over
// hd for every column tile up to the diagonal, then dW = <g_i, v_j> / N_i +
// s_i, dS = dW * exp(D_ij - m_new_i) (written), dW * W_ij summed over j (the
// row sums) and over this block's rows (a column part per row tile).
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_dweights_kernel(const float* __restrict__ g,
                          const float* __restrict__ v,
                          const float* __restrict__ log_i, Layout lay,
                          int BH, const float* __restrict__ rows,
                          float* __restrict__ brows,
                          const float* __restrict__ W,
                          float* __restrict__ dS,
                          float* __restrict__ colpart) {
  __shared__ float gs[kRowTile][kPitch];
  __shared__ float vs[kRowTile][kPitch];
  __shared__ float cs[16][kRowTile];
  __shared__ float bj_s[kRowTile];
  __shared__ float lij_s[kRowTile];
  const int c = blockIdx.y, bh = blockIdx.z;
  const int r0 = c * lay.L;
  const int Lc = min(lay.L, lay.S - r0);
  const int i0 = blockIdx.x * kRowTile;
  if (i0 >= Lc) return;  // the whole block: no barrier is skipped
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const Rows hr = lay.rows(bh), gr = lay.gates(bh);
  const long long plane = (long long)BH * lay.S;
  const long long off = (long long)bh * lay.S + r0;
  const float* r_b = rows + kB * plane + off;
  const float* r_m = rows + kMNew * plane + off;
  const float* r_den = rows + kDenom * plane + off;
  const float* r_s = brows + kSRow * plane + off;
  float* r_rowd = brows + kRowD * plane + off;
  const int Wp = padded(lay.L);
  const long long cw = ((long long)bh * lay.nc + c) * lay.L * Wp;
  float* col_out = colpart + (((long long)bh * lay.nc + c) * row_tiles(lay.L) +
                              blockIdx.x) * lay.L;

  float b_i[4], m_i[4], n_i[4], s_i[4], rowsum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    b_i[r] = i < Lc ? r_b[i] : 0.f;
    m_i[r] = i < Lc ? r_m[i] : 0.f;
    n_i[r] = i < Lc ? r_den[i] : 1.f;
    s_i[r] = i < Lc ? r_s[i] : 0.f;
    rowsum[r] = 0.f;
  }
  for (int jt = 0; jt <= (int)blockIdx.x; ++jt) {  // up to the diagonal
    const int j0 = jt * kRowTile;
    if (t < kRowTile) {
      const int j = j0 + t;
      bj_s[t] = j < Lc ? r_b[j] : 0.f;
      lij_s[t] = j < Lc ? log_i[gr.at(r0 + j)] : 0.f;
    }
    float acc[4][4] = {};
    for (int d0 = 0; d0 < lay.hd; d0 += kSlice) {
      for (int idx = t; idx < kRowTile * kSlice; idx += kThreads) {
        const int r = idx / kSlice, dd = idx % kSlice;
        const int i = i0 + r, j = j0 + r;
        gs[r][dd] = i < Lc ? g[hr.at(r0 + i) + d0 + dd] : 0.f;
        vs[r][dd] = j < Lc ? v[hr.at(r0 + j) + d0 + dd] : 0.f;
      }
      __syncthreads();
      dot_slice<true>(gs, vs, ty, tx, acc);
      __syncthreads();
    }
    float colsum[4] = {};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int jl = tx * 4 + cc, j = j0 + jl;
        float ds = 0.f, dd = 0.f;
        if (i < Lc && j <= i) {
          const float dw = acc[r][cc] / n_i[r] + s_i[r];
          ds = dw * expf(((b_i[r] - bj_s[jl]) + lij_s[jl]) - m_i[r]);
          dd = dw * W[cw + (long long)i * Wp + j];
        }
        if (i < Lc && j < Lc) dS[cw + (long long)i * Wp + j] = ds;
        rowsum[r] += dd;
        colsum[cc] += dd;
      }
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) cs[ty][tx * 4 + cc] = colsum[cc];
    __syncthreads();
    if (t < kRowTile && j0 + t < Lc) {
      float sum = 0.f;
      for (int y = 0; y < 16; ++y) sum += cs[y][t];
      col_out[j0 + t] = sum;
    }
    __syncthreads();  // bj_s, lij_s and cs are reused by the next tile
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    const float sum = warp_sum16(rowsum[r]);
    if (tx == 0 && i < Lc) r_rowd[i] = sum;
  }
}

// ---------------------------------------------------------------- pass 9
// acc[r][c] += sum_{x_lo <= x < x_hi} A(4 ty + r, x) B(x, 4 tx + c) over a
// kPT x kPT tile, 32 values of x at a time through shared memory. `row_fast`
// / `col_fast` say which index neighbouring threads load (the one that is
// contiguous in device memory).
template <bool kRowFast, bool kColFast, class LA, class LB>
__device__ __forceinline__ void tile_product(float (*As)[kPitch],
                                             float (*Bs)[kBP], int x_lo,
                                             int x_hi, LA load_a, LB load_b,
                                             float acc[4][4]) {
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  for (int x0 = x_lo; x0 < x_hi; x0 += kSlice) {
    for (int idx = t; idx < kPT * kSlice; idx += kThreads) {
      const int r = kRowFast ? idx % kPT : idx / kSlice;
      const int kk = kRowFast ? idx / kPT : idx % kSlice;
      As[r][kk] = x0 + kk < x_hi ? load_a(r, x0 + kk) : 0.f;
    }
    for (int idx = t; idx < kPT * kSlice; idx += kThreads) {
      const int cc = kColFast ? idx % kPT : idx / kSlice;
      const int kk = kColFast ? idx / kPT : idx % kSlice;
      Bs[kk][cc] = x0 + kk < x_hi ? load_b(x0 + kk, cc) : 0.f;
    }
    __syncthreads();
    float part[4][4] = {};  // the slice's sum apart (see fma_slice)
#pragma unroll 8
    for (int kk = 0; kk < kSlice; ++kk) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[ty * 4 + r][kk];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        part[r][0] += a[r] * b.x;
        part[r][1] += a[r] * b.y;
        part[r][2] += a[r] * b.z;
        part[r][3] += a[r] * b.w;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += part[r][c];
    __syncthreads();
  }
}

enum { kOutQ = 0, kOutK, kOutV };

// One block per (64 rows, 64 columns, chunk, bh) of dq (kOutQ), dk or dv:
//   dq_i = sum_j dS_ij k_j + inter_s_i y_i,  y_i = C u_i + s_i n,
//   dk_j = sum_i dS_ij q_i + kd_j z_j,       z_j = dC' v_j + dn',
//   dv_j = sum_i W_ij u_i + kd_j dC'^T k_j,
// with C, n entering the chunk and dC', dn' after it; the tile's part of
// <q_i, y_i> or <k_j, z_j> goes to `dots` (one column per column tile).
template <int kOut>
__global__ void __launch_bounds__(kThreads)
    mlstm_dproducts_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ g, Layout lay, int BH,
                           const float* __restrict__ rows,
                           const float* __restrict__ brows,
                           const float* __restrict__ Wm,
                           const float* __restrict__ M,
                           const float* __restrict__ vec,
                           float* __restrict__ out,
                           float* __restrict__ dots) {
  __shared__ float As[kPT][kPitch];
  __shared__ __align__(16) float Bs[kSlice][kBP];
  const int ncol = col_tiles(lay.hd);
  const int ct = blockIdx.x % ncol, rt = blockIdx.x / ncol;
  const int c = blockIdx.y, bh = blockIdx.z;
  const int r0 = c * lay.L;
  const int Lc = min(lay.L, lay.S - r0);
  const int i0 = rt * kPT, c0 = ct * kPT;
  if (i0 >= Lc) return;  // the whole block
  const int hd = lay.hd;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const Rows hr = lay.rows(bh);
  const long long plane = (long long)BH * lay.S;
  const long long off = (long long)bh * lay.S + r0;
  const float* r_inter = rows + kInterS * plane + off;
  const float* r_kd = rows + kKDecay * plane + off;
  const float* r_den = rows + kDenom * plane + off;
  const float* r_s = brows + kSRow * plane + off;
  const int Wp = padded(lay.L);
  const float* Sc = Wm + ((long long)bh * lay.nc + c) * lay.L * Wp;
  const float* Mc = M + ((long long)bh * lay.nc + c) * hd * hd;
  const float* vc = vec ? vec + ((long long)bh * lay.nc + c) * hd : nullptr;
  auto in_rows = [&](const float* x, int i, int col) {
    return x[hr.at(r0 + i) + col];
  };

  float intra[4][4] = {}, state[4][4] = {};
  if (kOut == kOutQ) {
    // sum_{j <= i} dS_ij k_j: dS rows up to the end of this row tile (zero
    // above the diagonal)
    tile_product<false, true>(
        As, Bs, 0, min(Lc, i0 + kPT),
        [&](int r, int x) {
          return i0 + r < Lc ? Sc[(long long)(i0 + r) * Wp + x] : 0.f;
        },
        [&](int x, int cc) {
          return c0 + cc < hd ? in_rows(k, x, c0 + cc) : 0.f;
        },
        intra);
    // C u_i: u = g / N; C[d][e] read along e
    tile_product<false, false>(
        As, Bs, 0, hd,
        [&](int r, int x) { return i0 + r < Lc ? in_rows(g, i0 + r, x) : 0.f; },
        [&](int x, int cc) {
          return c0 + cc < hd ? Mc[(long long)(c0 + cc) * hd + x] : 0.f;
        },
        state);
  } else {
    // sum_{i >= j} P_ij X_i with P = dS (dk, X = q) or W (dv, X = u)
    tile_product<true, true>(
        As, Bs, i0, Lc,
        [&](int r, int x) {
          return i0 + r < Lc ? Sc[(long long)x * Wp + i0 + r] : 0.f;
        },
        [&](int x, int cc) {
          if (c0 + cc >= hd) return 0.f;
          return kOut == kOutK ? in_rows(q, x, c0 + cc)
                               : in_rows(g, x, c0 + cc) / r_den[x];
        },
        intra);
    if (kOut == kOutK)  // dC' v_j: dC'[d][e] read along e
      tile_product<false, false>(
          As, Bs, 0, hd,
          [&](int r, int x) {
            return i0 + r < Lc ? in_rows(v, i0 + r, x) : 0.f;
          },
          [&](int x, int cc) {
            return c0 + cc < hd ? Mc[(long long)(c0 + cc) * hd + x] : 0.f;
          },
          state);
    else  // dC'^T k_j: dC'[d][e] read along e
      tile_product<false, true>(
          As, Bs, 0, hd,
          [&](int r, int x) {
            return i0 + r < Lc ? in_rows(k, i0 + r, x) : 0.f;
          },
          [&](int x, int cc) {
            return c0 + cc < hd ? Mc[(long long)x * hd + c0 + cc] : 0.f;
          },
          state);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    const bool live = i < Lc;
    const int il = live ? i : 0;
    const float scale = kOut == kOutQ ? r_inter[il] : r_kd[il];
    float dot = 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = c0 + tx * 4 + cc;
      if (col >= hd) continue;
      float y = state[r][cc];
      if (kOut == kOutQ) y = y / r_den[il] + r_s[il] * vc[col];
      if (kOut == kOutK) y = y + vc[col];
      if (live) {
        out[hr.at(r0 + i) + col] = intra[r][cc] + scale * y;
        if (kOut != kOutV)
          dot += (kOut == kOutQ ? in_rows(q, i, col) : in_rows(k, i, col)) *
                 y;
      }
    }
    if (kOut != kOutV) {
      dot = warp_sum16(dot);
      if (tx == 0 && live) dots[(off + i) * col_tiles(hd) + ct] = dot;
    }
  }
}

// ---------------------------------------------------------------- pass 10
// How the parts of the gates' sums are laid out, by route: each row's parts
// of <q_i, C u_i + s_i n> and <k_j, dC' v_j + dn'>, a (bh, chunk)'s parts
// of <dC', C> and <dn', n>, and the column sums of dW * W a row tile of
// `tile` rows (`tiles` a chunk).
struct GateParts {
  int q, k, C, n, tile, tiles;
};

// One block per (chunk, bh), thread i for row i: the gates' cotangents.
__global__ void __launch_bounds__(kThreads)
    mlstm_dgates_kernel(Layout lay, int BH, GateParts np,
                        const float* __restrict__ rows,
                        const float* __restrict__ brows,
                        const float* __restrict__ decay,
                        const float* __restrict__ colpart,
                        const float* __restrict__ dots_q,
                        const float* __restrict__ dots_k,
                        const float* __restrict__ part_C,
                        const float* __restrict__ part_n,
                        float* __restrict__ dlog_i,
                        float* __restrict__ dlog_f) {
  __shared__ double warp_tot[kThreads / 32];
  __shared__ double db_s[kMaxChunk];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int r0 = c * lay.L;
  const int Lc = min(lay.L, lay.S - r0);
  const bool real = i < Lc;
  const Rows gr = lay.gates(bh);
  const long long plane = (long long)BH * lay.S;
  const long long o = (long long)bh * lay.S + r0 + i;
  const long long bc = (long long)bh * lay.nc + c;
  double db = 0.0, P = 0.0, col_d = 0.0;
  if (real) {
    double dq = 0.0, dk = 0.0;
    for (int ct = 0; ct < np.q; ++ct) dq += dots_q[o * np.q + ct];
    for (int ct = 0; ct < np.k; ++ct) dk += dots_k[o * np.k + ct];
    const int nrt = (Lc + np.tile - 1) / np.tile;
    for (int rt = i / np.tile; rt < nrt; ++rt)
      col_d += colpart[(bc * np.tiles + rt) * lay.L + i];
    P = dk * (double)rows[kKDecay * plane + o];
    db = (double)brows[kRowD * plane + o] - col_d +
         dq * (double)rows[kInterS * plane + o] - P;
    dlog_i[gr.at(r0 + i)] = (float)(col_d + P);
  }
  // total_f's cotangent: sum_j P_j + decay (<dC', C> + <dn', n>)
  double tot = warp_sum32(P);
  if (lane == 0) warp_tot[warp] = tot;
  __syncthreads();
  if (i == Lc - 1) {
    tot = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) tot += warp_tot[w];
    double dd = 0.0;
    for (int x = 0; x < np.C; ++x) dd += part_C[bc * np.C + x];
    for (int x = 0; x < np.n; ++x) dd += part_n[bc * np.n + x];
    db += tot + dd * (double)decay[bc];
  }
  db_s[i] = db;  // 0 past Lc
  __syncthreads();
  // dlog_f_t = sum_{i >= t} db_i: an inclusive scan over the reversed rows
  double acc = db_s[kThreads - 1 - i];
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, acc, off);
    if (lane >= off) acc += y;
  }
  if (lane == 31) warp_tot[warp] = acc;
  __syncthreads();
  for (int w = 0; w < warp; ++w) acc += warp_tot[w];
  const int row = kThreads - 1 - i;
  if (row < Lc) dlog_f[gr.at(r0 + row)] = (float)acc;
}

static_assert(kThreads == kMaxChunk, "pass 10: a thread a row");

// The float32 route's launches on `s`.
cudaError_t dispatch_bwd(const float* q, const float* k, const float* v,
                         const float* g, const float* log_i,
                         const float* log_f, float* dq, float* dk, float* dv,
                         float* dlog_i, float* dlog_f, float* sc,
                         const BwdScratch& o, int BH, Layout lay,
                         cudaStream_t s) {
  float* rows = sc + o.rows;
  float* decay = sc + o.decay;
  float* brows = sc + o.brows;
  const long long plane = (long long)BH * lay.S;
  cudaError_t err;
  mlstm_gates_kernel<<<BH, kThreads, 0, s>>>(log_i, log_f, lay, BH, rows,
                                             decay, sc + o.m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_n_kernel<<<dim3(lay.hd / 32, BH), kThreads, 0, s>>>(
      k, lay, BH, rows, decay, sc + o.n_prev, sc + o.n_last);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_weights_kernel<true>
      <<<dim3((lay.L + kRowTile - 1) / kRowTile, lay.nc, BH), kThreads, 0, s>>>(
          q, k, log_i, lay, BH, rows, sc + o.n_prev, sc + o.W,
          brows + kDenRaw * plane);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = values_smem(lay.hd, lay.L);
  if ((err = cudaFuncSetAttribute(mlstm_values_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  mlstm_values_kernel<true><<<dim3(lay.hd / kTileE, BH), kThreads, smem, s>>>(
      q, k, v, lay, BH, rows, decay, sc + o.W, sc + o.h, nullptr, sc + o.C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long warps = plane;
  mlstm_s_kernel<<<(unsigned)((warps + kThreads / 32 - 1) / (kThreads / 32)),
                   kThreads, 0, s>>>(g, sc + o.h, lay, BH, rows, brows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(mlstm_dstate_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  mlstm_dstate_kernel<<<dim3(lay.hd / kTileE, BH), kThreads, smem, s>>>(
      q, g, lay, BH, rows, decay, sc + o.C, sc + o.dC, sc + o.part_C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_dn_kernel<float><<<dim3(lay.hd / 32, BH), kThreads, 0, s>>>(
      q, lay, BH, rows, brows, decay, sc + o.n_prev, sc + o.dn,
      sc + o.part_n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_dweights_kernel
      <<<dim3(row_tiles(lay.L), lay.nc, BH), kThreads, 0, s>>>(
          g, v, log_i, lay, BH, rows, brows, sc + o.W, sc + o.dS,
          sc + o.colpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid(col_tiles(lay.hd) * row_tiles(lay.L), lay.nc, BH);
  mlstm_dproducts_kernel<kOutQ><<<grid, kThreads, 0, s>>>(
      q, k, v, g, lay, BH, rows, brows, sc + o.dS, sc + o.C, sc + o.n_prev,
      dq, sc + o.dots_q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_dproducts_kernel<kOutK><<<grid, kThreads, 0, s>>>(
      q, k, v, g, lay, BH, rows, brows, sc + o.dS, sc + o.dC, sc + o.dn, dk,
      sc + o.dots_k);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_dproducts_kernel<kOutV><<<grid, kThreads, 0, s>>>(
      q, k, v, g, lay, BH, rows, brows, sc + o.W, sc + o.dC, nullptr, dv,
      nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const GateParts np = {col_tiles(lay.hd), col_tiles(lay.hd),
                        lay.hd / kTileE, lay.hd / 32, kPT,
                        row_tiles(lay.L)};
  mlstm_dgates_kernel<<<dim3(lay.nc, BH), kThreads, 0, s>>>(
      lay, BH, np, rows, brows, decay, sc + o.colpart, sc + o.dots_q,
      sc + o.dots_k, sc + o.part_C, sc + o.part_n, dlog_i, dlog_f);
  return cudaGetLastError();
}

}  // namespace

// ======================================================================
// The bfloat16 route: the tensor-core kernels.
//
// What bounds it: operations (above). The float32 route spends its time in
// pass 4, which re-reads q and the decayed keys for every 32 value columns
// and walks the chunks in order; here the products run on the tensor cores
// (wgmma from shared memory, bf16 in, float32 accumulate, operands brought
// by TMA into 128-byte-swizzled column blocks of 64 elements, the layout
// rule of flash_attention.cu, see hopper.cuh) and the chunk-parallel work is
// parallel. A float32 operand (kd * k, W, the carried C) enters a product
// as three bf16 planes hi + mid + lo, float32's precision. Four launches on
// the caller's stream:
//   1. gates, as the float32 route (pass 1): b in float64, m, the decays;
//   2. states, one block per (128 key channels d, 128 value columns e, bh):
//      walks the chunks in order, 128 rows a step, with C's tile in
//      float32 accumulators; k and v of a step come by TMA into a ring of
//      two stages, k is turned in shared memory into kd * k as three
//      planes, and C <- decay C + (kd k)^T v is wgmma m64n128 with both
//      operands MN-major (their rows are the contraction). Before each
//      chunk c >= 1 it writes C entering c as three bf16 planes for pass 4,
//      and at the end C in float32 (decode reads it). The blocks of a d
//      tile share out its channels to carry n = decay n + sum_j kd_j k_j
//      from k as it came, and write n before every chunk;
//   3. scores, one block per (128 rows, chunk, bh): S = q k^T over hd in
//      steps of 64 columns (two TMA stages), an m64n128 tile of 128 keys
//      at a time up to the diagonal, each step's product summed into the
//      tile in float32 registers (one accumulator over all of hd loses
//      precision, see the kernel), then W = S * exp(D - m) in float32,
//      masked to j <= i < Lc, written to scratch as three bf16 planes, and
//      the
//      normaliser max(|sum_j W_ij + inter_s_i <q_i, n>|, exp(-m_i)) from
//      the float32 W, as the plain version sums it;
//   4. outputs, one block per (128 rows, 256 value columns, chunk, bh):
//      h = (inter_s * q C + W v) / normaliser as m64n256 accumulators over
//      hd (q C, skipped in chunk 0 where C = 0) and over the key tiles up to
//      the diagonal (W v), two TMA stages; rows past Lc are computed from
//      zero weights and not written.
// Rows past S are never read (TMA fills them with zeros) or written; rows
// of the next chunk that a box reaches meet zero weights. Scratch, after the
// rows, decays and n per chunk in float32: W planes (B*H * nc * 3 * Lp^2
// bf16, Lp = L rounded up to 128) and the entering states (B*H * (nc - 1) *
// 3 * hd^2 bf16), 403.2 MB at B=1 H=4 S=4096 hd=1024 L=256. One thread
// issues the TMA loads between the steps; warp specialisation and deeper
// rings are later changes.
namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTile = 128;     // rows of a score or output tile, d and e
                               // of a state tile
constexpr int kCB = 64;        // bf16 elements of a column block
constexpr int kRB = 2 * kCB;   // bytes of its (swizzled) row
constexpr int kSwizzle = 1;    // descriptor code of the 128-byte swizzle
constexpr int kOutCols = 256;  // value columns of an output tile
constexpr int kSbo = 8 * kRB;  // descriptor stride of an 8-row swizzle atom

__host__ __device__ constexpr int wpitch(int L) {
  return (L + kTile - 1) / kTile * kTile;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}
__device__ __forceinline__ uint64_t kmajor(const unsigned char* p) {
  return smem_desc(smem_addr(p), 16, kSbo, kSwizzle);
}
// an MN-major operand whose column blocks are `block` bytes apart
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* p,
                                            int block) {
  return smem_desc(smem_addr(p), block, kSbo, kSwizzle);
}
// A float32 operand enters the products as three bf16 planes hi + mid +
// lo (24 significant bits: float32's precision); two planes keep 16 bits,
// about 2^-18 relative, which moved the full-width xLSTM prefill's bf16 h
// to 1.06e-4 relative L2 from the plain version's on an H100, past the
// 1e-4 check.
constexpr int kPlanes = 3;
__device__ __forceinline__ void split3(float x0, float x1, uint32_t* terms) {
#pragma unroll
  for (int pl = 0; pl < kPlanes; ++pl) {
    terms[pl] = pack_bf16(x0, x1);
    const float2 part = unpack_bf16(terms[pl]);
    x0 -= part.x;
    x1 -= part.y;
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int n) {
  for (int i = 0; i < n; ++i) mbar_init(smem_addr(bars + i));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  fence_proxy_async();
}

// Scratch of this route, in bytes from its start.
struct Scratch {
  long long rows, decay, n_prev, w, c, bytes;
};
__host__ __device__ inline long long align_up(long long x) {
  return (x + 1023) / 1024 * 1024;
}
__host__ __device__ inline Scratch scratch_of(long long BH, int S, int hd,
                                              int L, int nc) {
  Scratch sc;
  sc.rows = 0;
  sc.decay = sc.rows + 4 * kRowKinds * BH * S;
  sc.n_prev = sc.decay + 4 * BH * nc;
  sc.w = align_up(sc.n_prev + 4 * BH * nc * hd);
  const long long lp = wpitch(L);
  sc.c = align_up(sc.w + 2 * BH * nc * kPlanes * lp * lp);
  sc.bytes = sc.c + 2 * BH * (nc - 1) * kPlanes * (long long)hd * hd;
  return sc;
}

// ------------------------------------------------------------- 3. scores
constexpr int kQTile = kTile * kRB;        // 128 rows of one column block
constexpr int kScoreStage = 2 * kQTile;    // q, then a half of k
constexpr int kScoreSmem = 2 * kScoreStage + 64 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
    mlstm_scores_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const bf16* __restrict__ q,
                        const float* __restrict__ log_i, Layout lay, int BH,
                        float* __restrict__ rows,
                        const float* __restrict__ n_prev,
                        bf16* __restrict__ W, float* __restrict__ den_out,
                        float* __restrict__ qn_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + 2 * kScoreStage);
  __shared__ float bj_s[2 * kTile];
  __shared__ float lij_s[2 * kTile];
  __shared__ float qn_s[kTile];
  const int rt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int r0 = c * lay.L;
  const int Lc = min(lay.L, lay.S - r0);
  const int i0 = rt * kTile;
  if (i0 >= Lc) return;  // the whole block: no barrier is skipped
  const int b = bh / lay.H, head = bh % lay.H;
  const int t = threadIdx.x, wg = t / 128, warp = t / 32, lane = t % 32;
  const int halves = (min(i0 + kTile, Lc) + kTile - 1) / kTile;  // 1 or 2
  const int nd = (lay.hd + kCB - 1) / kCB;
  const long long plane = (long long)BH * lay.S;
  const float* r_b = rows + kB * plane + (long long)bh * lay.S + r0;
  const float* r_m = rows + kMNew * plane + (long long)bh * lay.S + r0;
  const float* r_inter = rows + kInterS * plane + (long long)bh * lay.S + r0;
  float* r_den = rows + kDenom * plane + (long long)bh * lay.S + r0;

  // S = q k^T over hd for one half of the keys at a time: step st is
  // half hf = st / nd, columns 64 s .. 64 s + 63 (s = st % nd) of q's 128
  // rows and of the half's 128 keys. Each step's product goes into a fresh
  // accumulator and is added to the half's float32 sum in registers. One
  // wgmma accumulator carried over all of hd (64 k16 steps at hd = 1024)
  // rounded h to other bf16 values than the float64 evaluation about twice
  // as often as the plain version does, enough to carry the full-width
  // xLSTM's bf16 gradients, trained through it, past phase [24c]'s margin
  // (tools/xlstm_bf16_gradients.py measures both).
  const int steps = halves * nd;
  auto load = [&](int st) {
    const int hf = st / nd, s = st % nd;
    unsigned char* stage = base + (st & 1) * kScoreStage;
    const uint32_t bar = smem_addr(bars + (st & 1));
    mbar_expect_tx(bar, 2 * kQTile);
    tma_load(smem_addr(stage), &tm_q, bar, s * kCB, head, r0 + i0, b);
    tma_load(smem_addr(stage + kQTile), &tm_k, bar, s * kCB, head,
             r0 + hf * kTile, b);
  };
  if (t == 0) init_barriers(bars, 2);
  __syncthreads();
  if (t == 0) {
    load(0);
    if (steps > 1) load(1);
  }
  // while the first tiles land: the gates of the chunk's columns and
  // <q_i, n> with n before this chunk, a warp per 16 rows
  const Rows gr = lay.gates(bh), hr = lay.rows(bh);
  for (int j = t; j < 2 * kTile; j += kThreads) {
    bj_s[j] = j < Lc ? r_b[j] : 0.f;
    lij_s[j] = j < Lc ? log_i[gr.at(r0 + j)] : 0.f;
  }
  const float* n_c = n_prev + ((long long)bh * lay.nc + c) * lay.hd;
  for (int r = 0; r < 16; ++r) {
    const int il = warp * 16 + r, i = i0 + il;
    float qn = 0.f;
    if (i < Lc) {
      const long long at = hr.at(r0 + i);
      for (int d = lane; d < lay.hd; d += 32)
        qn += __bfloat162float(q[at + d]) * n_c[d];
    }
    for (int off = 16; off > 0; off >>= 1)
      qn += __shfl_xor_sync(0xffffffffu, qn, off);
    if (lane == 0) qn_s[il] = qn;
  }
  __syncthreads();

  // acc[4 t8 + e] (and sum) is row rA + 8 (e / 2), column 128 hf + 8 t8 +
  // 2 (lane % 4) + e % 2
  const int rA = i0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  float b_i[2], m_i[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    const int i = rA + 8 * pr;
    b_i[pr] = i < Lc ? r_b[i] : 0.f;
    m_i[pr] = i < Lc ? r_m[i] : 0.f;
  }
  const long long lp = wpitch(lay.L);
  bf16* w_c = W + ((long long)bh * lay.nc + c) * kPlanes * lp * lp;
  float acc[64], sum[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = sum[x] = 0.f;
  for (int st = 0; st < steps; ++st) {
    const int hf = st / nd, s = st % nd;
    const unsigned char* stage = base + (st & 1) * kScoreStage;
    mbar_wait(smem_addr(bars + (st & 1)), (st >> 1) & 1);
#pragma unroll
    for (int x = 0; x < 64; ++x) pin(acc[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCB / 16; ++kk)
      wgmma_ss_n128<0, 0>(acc, kmajor(stage + 64 * wg * kRB + 32 * kk),
                          kmajor(stage + kQTile + 32 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      pin(acc[x]);
      sum[x] += acc[x];
    }
    __syncthreads();  // stage st & 1 is no longer read
    if (t == 0 && st + 2 < steps) load(st + 2);
    if (s + 1 < nd) continue;
    // the half is done: W_ij = S_ij exp(D_ij - m_i) for j <= i < Lc, else
    // 0, as three bf16 planes, and the rows' sums of W
#pragma unroll
    for (int t8 = 0; t8 < 16; ++t8)
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int i = rA + 8 * pr;
        const int j = hf * kTile + 8 * t8 + 2 * (lane % 4);
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = j + e;
          w[e] = (i < Lc && jj <= i)
                     ? sum[4 * t8 + 2 * pr + e] *
                           expf(((b_i[pr] - bj_s[jj]) + lij_s[jj]) - m_i[pr])
                     : 0.f;
          rowsum[pr] += w[e];
        }
        uint32_t terms[kPlanes];
        split3(w[0], w[1], terms);
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl)
          *reinterpret_cast<uint32_t*>(w_c + pl * lp * lp + i * lp + j) =
              terms[pl];
      }
#pragma unroll
    for (int x = 0; x < 64; ++x) sum[x] = 0.f;
  }
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    float sum = rowsum[pr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int i = rA + 8 * pr;
    if (lane % 4 == 0 && i < Lc) {
      r_den[i] = fmaxf(fabsf(sum + qn_s[i - i0] * r_inter[i]),
                       expf(-m_i[pr]));
      // the backward's: the signed denominator and <q_i, n>
      const long long at = (long long)bh * lay.S + r0 + i;
      if (den_out) den_out[at] = sum + qn_s[i - i0] * r_inter[i];
      if (qn_out) qn_out[at] = qn_s[i - i0];
    }
  }
}

// ------------------------------------------------------------- 4. states
// A step is up to 128 rows of a chunk: k and v of those rows come by TMA
// into a ring of two stages (the next step's load is in flight while this
// one is computed), and k is turned into kd * k as three bf16 planes in
// shared memory beside the ring.
constexpr int kHalf = 128;                     // rows of a chunk a step
constexpr int kHalfBlock = kHalf * kRB;        // one column block of them
constexpr int kStateStage = 4 * kHalfBlock;    // k, then v: two blocks each
constexpr int kStateSmem =
    2 * kStateStage + 2 * kPlanes * kHalfBlock + 64 + 1024;
static_assert(kThreads == kMaxChunk, "a thread stages one row's key decay");

__global__ void __launch_bounds__(kThreads, 1)
    mlstm_states_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_c, Layout lay,
                        int BH, const float* __restrict__ rows,
                        const float* __restrict__ decay,
                        float* __restrict__ C_out,
                        float* __restrict__ n_prev,
                        float* __restrict__ n_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* planes = base + 2 * kStateStage;  // hi, mid, lo of kd * k
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(planes + 2 * kPlanes * kHalfBlock);
  // n's partial sums, written before the step's planes
  float* part = reinterpret_cast<float*>(planes);
  __shared__ float kd_s[kMaxChunk];
  const int et = blockIdx.x, e0 = et * kTile, d0 = blockIdx.y * kTile;
  const int bh = blockIdx.z;
  const int b = bh / lay.H, head = bh % lay.H;
  const int t = threadIdx.x, wg = t / 128, warp = t / 32, lane = t % 32;
  const float* r_kd =
      rows + kKDecay * (long long)BH * lay.S + (long long)bh * lay.S;
  // n = decay n + sum_j kd_j k_j, carried here too: the blocks of one d
  // tile share its 128 channels out, `share` each; thread (grp, dd) sums
  // channel dd of the share over every groups-th row of a step
  const int share = (kTile + gridDim.x - 1) / gridDim.x;
  const int groups = kThreads / share;
  const int dd = t % share, grp = t / share;
  const int n_col = et * share + dd;  // of the tile's 128
  const int dn = d0 + n_col;
  const bool n_mine = n_col < kTile && dn < lay.hd;
  float n_run = 0.f, n_sum = 0.f;  // kept by the threads with grp == 0
  // acc[4 t8 + e] is C[d, e'] with d = dA + 8 (e / 2) and
  // e' = e0 + 8 t8 + 2 (lane % 4) + e % 2
  const int dA = d0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int per_chunk = (lay.L + kHalf - 1) / kHalf;  // steps a chunk
  const int last_rows = lay.S - (lay.nc - 1) * lay.L;
  const int steps = (lay.nc - 1) * per_chunk + (last_rows + kHalf - 1) / kHalf;

  auto load = [&](int s) {
    const int r = (s / per_chunk) * lay.L + (s % per_chunk) * kHalf;
    unsigned char* stage = base + (s & 1) * kStateStage;
    const uint32_t bar = smem_addr(bars + (s & 1));
    mbar_expect_tx(bar, kStateStage);
    for (int cb = 0; cb < 2; ++cb) {
      tma_load(smem_addr(stage + cb * kHalfBlock), &tm_k, bar, d0 + cb * kCB,
               head, r, b);
      tma_load(smem_addr(stage + (2 + cb) * kHalfBlock), &tm_v, bar,
               e0 + cb * kCB, head, r, b);
    }
  };
  if (t == 0) init_barriers(bars, 2);
  __syncthreads();
  if (t == 0) {
    load(0);
    if (steps > 1) load(1);
  }

  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int c = s / per_chunk, j0 = (s % per_chunk) * kHalf;
    const int r0 = c * lay.L;
    const int Lc = min(lay.L, lay.S - r0);
    const int rows_s = min(kHalf, Lc - j0);
    const float dc = decay[(long long)bh * lay.nc + c];
    if (j0 == 0) kd_s[t] = t < Lc ? r_kd[r0 + t] : 0.f;
    if (t == 0) bulk_wait_read();  // the last state's planes have left
    __syncthreads();  // kd_s, and the planes buffer is free
    const unsigned char* stage = base + (s & 1) * kStateStage;
    mbar_wait(smem_addr(bars + (s & 1)), (s >> 1) & 1);
    // n's partial sums from k as it came (the swizzle moves 16-byte pieces
    // inside a 128-byte row: piece p of row j sits at p ^ (j % 8))
    float sum = 0.f;
    if (grp < groups && n_mine) {
      const int cb = n_col / kCB, c64 = n_col % kCB;
      const unsigned char* col = stage + cb * kHalfBlock + 2 * (c64 % 8);
      for (int j = grp; j < rows_s; j += groups)
        sum += kd_s[j0 + j] *
               __bfloat162float(*reinterpret_cast<const bf16*>(
                   col + j * kRB + (((c64 / 8) ^ (j % 8)) << 4)));
    }
    part[t] = sum;
    __syncthreads();
    if (grp == 0 && n_mine)
      for (int g = 0; g < groups; ++g) n_sum += part[g * share + dd];
    __syncthreads();  // part is overwritten by the planes
    // kd * k in float32 as three bf16 planes; a piece's row is its offset
    // / 128 in its column block
    for (int p = t; p < 2 * kHalfBlock / 16; p += kThreads) {
      const int off = 16 * p;
      const float kd = kd_s[j0 + (off % kHalfBlock) / kRB];
      const uint4 x = *reinterpret_cast<const uint4*>(stage + off);
      const uint32_t in[4] = {x.x, x.y, x.z, x.w};
      uint32_t out[kPlanes][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = unpack_bf16(in[u]);
        uint32_t terms[kPlanes];
        split3(f.x * kd, f.y * kd, terms);
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) out[pl][u] = terms[pl];
      }
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl)
        *reinterpret_cast<uint4*>(planes + pl * 2 * kHalfBlock + off) =
            make_uint4(out[pl][0], out[pl][1], out[pl][2], out[pl][3]);
    }
    fence_proxy_async();
    __syncthreads();
    if (j0 == 0 && c > 0) {
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] *= dc;
    }
    // C += (kd k)^T v: d is A's row (MN-major), the rows of the step are
    // the contraction, 16 a k-step; the warpgroup's 64 d are one column
    // block. Rows past the chunk have zero planes (kd = 0), so every step
    // runs all 8 k-steps: a trip count known to the compiler keeps the
    // wgmmas in one pipeline stage.
#pragma unroll
    for (int x = 0; x < 64; ++x) pin(acc[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHalf / 16; ++kk) {
      const int row = 16 * kk * kRB;
      const uint64_t dv = mnmajor(stage + 2 * kHalfBlock + row, kHalfBlock);
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl)
        wgmma_ss_n128<1, 1>(
            acc,
            mnmajor(planes + pl * 2 * kHalfBlock + wg * kHalfBlock + row,
                    kHalfBlock),
            dv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int x = 0; x < 64; ++x) pin(acc[x]);
    const bool chunk_done = j0 + kHalf >= Lc;
    if (chunk_done && grp == 0 && n_mine) {
      n_prev[((long long)bh * lay.nc + c) * lay.hd + dn] = n_run;
      n_run = dc * n_run + n_sum;
      n_sum = 0.f;
    }
    if (chunk_done && c + 1 < lay.nc) {
      // C entering chunk c + 1, as three bf16 planes, for the outputs:
      // staged in the planes buffer (no longer read) with the 128-byte
      // swizzle, so that the fragments' writes fall in distinct banks,
      // and written by TMA, rows of 128 bytes
      __syncthreads();  // every warpgroup's wgmmas have read the planes
#pragma unroll
      for (int t8 = 0; t8 < 16; ++t8)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          const int r = dA - d0 + 8 * pr;  // row of the tile
          const int col = 8 * t8 + 2 * (lane % 4);
          uint32_t terms[kPlanes];
          split3(acc[4 * t8 + 2 * pr], acc[4 * t8 + 2 * pr + 1], terms);
          const int off = (col / kCB) * kHalfBlock + r * kRB +
                          ((((col % kCB) / 8) ^ (r % 8)) << 4) +
                          2 * (col % 8);
#pragma unroll
          for (int pl = 0; pl < kPlanes; ++pl)
            *reinterpret_cast<uint32_t*>(planes + pl * 2 * kHalfBlock +
                                         off) = terms[pl];
        }
      fence_proxy_async();
      __syncthreads();
      if (t == 0) {
        const int first = (bh * (lay.nc - 1) + c) * kPlanes;
        for (int pl = 0; pl < kPlanes; ++pl)
          for (int cb = 0; cb < 2; ++cb)
            tma_store3(&tm_c,
                       smem_addr(planes + (2 * pl + cb) * kHalfBlock),
                       e0 + cb * kCB, d0, first + pl);
        bulk_commit();
      }
    }
    __syncthreads();  // stage s & 1 and the planes are no longer read
    if (t == 0 && s + 2 < steps) load(s + 2);
  }
#pragma unroll
  for (int t8 = 0; t8 < 16; ++t8)
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int d = dA + 8 * pr;
      const int e = e0 + 8 * t8 + 2 * (lane % 4);
      // C_out is null in the backward, which reads the entering states only
      if (C_out == nullptr || d >= lay.hd || e >= lay.hd) continue;
      *reinterpret_cast<float2*>(C_out + ((long long)bh * lay.hd + d) *
                                             lay.hd + e) =
          make_float2(acc[4 * t8 + 2 * pr], acc[4 * t8 + 2 * pr + 1]);
    }
  if (grp == 0 && n_mine) n_out[(long long)bh * lay.hd + dn] = n_run;
  if (t == 0) bulk_wait_read();  // shared memory outlives its reads
}

// ------------------------------------------------------------ 5. outputs
// A stage: the A tile (q or W_hi: 128 rows, one column block), then B1,
// B2, B3 (C's three planes: 64 rows, four column blocks each); a W v step
// puts v in B1 and W_mid, W_lo at the starts of B2, B3.
constexpr int kOutB = kCB * kRB;  // one column block of 64 rows
constexpr int kOutStage = kQTile + 4 * kPlanes * kOutB;
constexpr int kOutSmem = 2 * kOutStage + 64 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
    mlstm_outputs_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_c,
                         const __grid_constant__ CUtensorMap tm_w,
                         Layout lay, int BH, int row_tiles,
                         const float* __restrict__ rows,
                         bf16* __restrict__ h) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + 2 * kOutStage);
  const int rt = blockIdx.x % row_tiles, et = blockIdx.x / row_tiles;
  const int c = blockIdx.y, bh = blockIdx.z;
  const int r0 = c * lay.L;
  const int Lc = min(lay.L, lay.S - r0);
  const int i0 = rt * kTile, e0 = et * kOutCols;
  if (i0 >= Lc) return;  // the whole block: no barrier is skipped
  const int b = bh / lay.H, head = bh % lay.H;
  const int t = threadIdx.x, wg = t / 128, warp = t / 32, lane = t % 32;
  const int nq = c > 0 ? (lay.hd + kCB - 1) / kCB : 0;  // q C steps
  const int nj = (min(i0 + kTile, Lc) + kCB - 1) / kCB;  // W v steps
  const int steps = nq + nj;
  const int c_plane = (bh * (lay.nc - 1) + c - 1) * kPlanes;
  const int w_plane = (bh * lay.nc + c) * kPlanes;

  auto load = [&](int s) {
    unsigned char* stage = base + (s & 1) * kOutStage;
    unsigned char* b1 = stage + kQTile;
    const uint32_t bar = smem_addr(bars + (s & 1));
    if (s < nq) {
      mbar_expect_tx(bar, kOutStage);
      tma_load(smem_addr(stage), &tm_q, bar, s * kCB, head, r0 + i0, b);
      for (int pl = 0; pl < kPlanes; ++pl)
        for (int cb = 0; cb < 4; ++cb)
          tma_load3(smem_addr(b1 + (4 * pl + cb) * kOutB), &tm_c, bar,
                    e0 + cb * kCB, s * kCB, c_plane + pl);
    } else {
      const int j0 = (s - nq) * kCB;
      mbar_expect_tx(bar, kPlanes * kQTile + 4 * kOutB);
      tma_load3(smem_addr(stage), &tm_w, bar, j0, i0, w_plane);
      for (int pl = 1; pl < kPlanes; ++pl)
        tma_load3(smem_addr(b1 + 4 * pl * kOutB), &tm_w, bar, j0, i0,
                  w_plane + pl);
      for (int cb = 0; cb < 4; ++cb)
        tma_load(smem_addr(b1 + cb * kOutB), &tm_v, bar, e0 + cb * kCB, head,
                 r0 + j0, b);
    }
  };
  if (t == 0) init_barriers(bars, 2);
  __syncthreads();
  if (t == 0) {
    load(0);
    if (steps > 1) load(1);
  }
  const long long plane = (long long)BH * lay.S;
  const float* r_inter = rows + kInterS * plane + (long long)bh * lay.S + r0;
  const float* r_den = rows + kDenom * plane + (long long)bh * lay.S + r0;
  // acc[4 t8 + e] is row rA + 8 (e / 2), column e0 + 8 t8 + 2 (lane % 4) +
  // e % 2
  const int rA = i0 + 64 * wg + 16 * (warp % 4) + lane / 4;

  float acc[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) acc[x] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const unsigned char* stage = base + (s & 1) * kOutStage;
    const unsigned char* b1 = stage + kQTile;
    mbar_wait(smem_addr(bars + (s & 1)), (s >> 1) & 1);
    // W v: skipped by a warpgroup whose rows all lie above the key tile
    const bool live = s < nq || (s - nq) * kCB <= i0 + 64 * wg + 63;
    if (live) {
#pragma unroll
      for (int x = 0; x < 128; ++x) pin(acc[x]);
      wgmma_fence();
#pragma unroll
      // q C_pl (A = q, B = plane pl) or W_pl v (A = plane pl, B = v)
      const bool qc = s < nq;
#pragma unroll
      for (int kk = 0; kk < kCB / 16; ++kk)
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
          const unsigned char* plane = b1 + 4 * pl * kOutB;
          const unsigned char* a = qc || pl == 0 ? stage : plane;
          const unsigned char* bt = qc ? plane : b1;
          wgmma_ss_n256<0, 1>(acc, kmajor(a + 64 * wg * kRB + 32 * kk),
                              mnmajor(bt + 16 * kk * kRB, kOutB), 1);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int x = 0; x < 128; ++x) pin(acc[x]);
    }
    if (s == nq - 1) {  // q C is complete: scale by the carry's decay
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int i = rA + 8 * pr;
        const float is = i < Lc ? r_inter[i] : 0.f;
#pragma unroll
        for (int t8 = 0; t8 < 32; ++t8) {
          acc[4 * t8 + 2 * pr] *= is;
          acc[4 * t8 + 2 * pr + 1] *= is;
        }
      }
    }
    __syncthreads();  // stage s & 1 is no longer read
    if (t == 0 && s + 2 < steps) load(s + 2);
  }
  const int q_stride = lay.H * lay.hd;
  bf16* hb = h + ((long long)b * lay.S + r0) * q_stride +
             (long long)head * lay.hd;
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    const int i = rA + 8 * pr;
    if (i >= Lc) continue;
    const float den = r_den[i];
#pragma unroll
    for (int t8 = 0; t8 < 32; ++t8) {
      const int e = e0 + 8 * t8 + 2 * (lane % 4);
      if (e < lay.hd)
        *reinterpret_cast<uint32_t*>(hb + (long long)i * q_stride + e) =
            pack_bf16(acc[4 * t8 + 2 * pr] / den,
                      acc[4 * t8 + 2 * pr + 1] / den);
    }
  }
}

// A (batch, seq, heads, hd) bf16 tensor as a 4-d tensor map whose boxes are
// 64 columns x `rows` positions of one head, 128-byte swizzled; positions
// past seq (and columns past hd) arrive as zeros
bool head_map(CUtensorMap* map, const void* ptr, int batch, int seq,
              int heads, int hd, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kCB, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `planes` row-major (rows x cols) bf16 matrices as a 3-d tensor map whose
// boxes are 64 columns x `rows_box` rows of one matrix, 128-byte swizzled
bool plane_map(CUtensorMap* map, const void* ptr, int cols, int rows,
               int planes, int rows_box) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kCB, (cuuint32_t)rows_box, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* log_i, const float* log_f, bf16* h, float* C,
                   float* n, float* m, unsigned char* scratch, int batch,
                   int BH, Layout lay, cudaStream_t s) {
  const Scratch sc = scratch_of(BH, lay.S, lay.hd, lay.L, lay.nc);
  float* rows = reinterpret_cast<float*>(scratch + sc.rows);
  float* decay = reinterpret_cast<float*>(scratch + sc.decay);
  float* n_prev = reinterpret_cast<float*>(scratch + sc.n_prev);
  bf16* W = reinterpret_cast<bf16*>(scratch + sc.w);
  bf16* C_planes = reinterpret_cast<bf16*>(scratch + sc.c);
  const int lp = wpitch(lay.L);
  CUtensorMap tq, tk, tv, tv64, tc_, tc_store, tw;
  if (!head_map(&tq, q, batch, lay.S, lay.H, lay.hd, kTile) ||
      !head_map(&tk, k, batch, lay.S, lay.H, lay.hd, kTile) ||
      !head_map(&tv, v, batch, lay.S, lay.H, lay.hd, kHalf) ||
      !head_map(&tv64, v, batch, lay.S, lay.H, lay.hd, kCB) ||
      !plane_map(&tw, W, lp, lp, kPlanes * BH * lay.nc, kTile))
    return cudaErrorInvalidValue;
  // the entering states exist from chunk 1 on; with one chunk the map is
  // never read and keeps W's
  tc_ = tc_store = tw;
  if (lay.nc > 1 && (!plane_map(&tc_, C_planes, lay.hd, lay.hd,
                                kPlanes * BH * (lay.nc - 1), kCB) ||
                     !plane_map(&tc_store, C_planes, lay.hd, lay.hd,
                                kPlanes * BH * (lay.nc - 1), kTile)))
    return cudaErrorInvalidValue;

  cudaError_t err;
  if ((err = cudaFuncSetAttribute(mlstm_scores_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kScoreSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(mlstm_states_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kStateSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(mlstm_outputs_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kOutSmem)) != cudaSuccess)
    return err;
  mlstm_gates_kernel<<<BH, kThreads, 0, s>>>(log_i, log_f, lay, BH, rows,
                                             decay, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int dt = (lay.hd + kTile - 1) / kTile;
  mlstm_states_kernel<<<dim3(dt, dt, BH), kThreads, kStateSmem, s>>>(
      tk, tv, tc_store, lay, BH, rows, decay, C, n_prev, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_scores_kernel<<<dim3(lp / kTile, lay.nc, BH), kThreads, kScoreSmem,
                        s>>>(tq, tk, q, log_i, lay, BH, rows, n_prev, W,
                             nullptr, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int et = (lay.hd + kOutCols - 1) / kOutCols;
  mlstm_outputs_kernel<<<dim3(lp / kTile * et, lay.nc, BH), kThreads,
                         kOutSmem, s>>>(tq, tv64, tc_, tw, lay, BH,
                                        lp / kTile, rows, h);
  return cudaGetLastError();
}

cudaError_t attributes(int which, int* regs, int* local_bytes,
                       int* static_smem, int* dynamic_smem) {
  const void* fns[3] = {(const void*)mlstm_scores_kernel,
                        (const void*)mlstm_states_kernel,
                        (const void*)mlstm_outputs_kernel};
  const int dyn[3] = {kScoreSmem, kStateSmem, kOutSmem};
  if (which < 0 || which > 2) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem = dyn[which];
  return cudaSuccess;
}


// ======================================================================
// The backward's tensor-core route (bfloat16 inputs); the formulas, the
// plane counts and the order of the launches are in the backward's header
// above.

// <q_i, n> with n entering the row's chunk, from the scores kernel: a row
// kind after the backward's own.
enum { kQnRow = kBwdRowKinds, kTcRowKinds };

__host__ __device__ inline int out_tiles(int hd) {  // 256 columns a tile
  return (hd + kOutCols - 1) / kOutCols;
}
__host__ __device__ inline int state_tiles(int hd) {  // 128 d or e a tile
  return (hd + kTile - 1) / kTile;
}

// Scratch of the backward's tensor-core route, in bytes from its start:
// the forward's pieces, then the backward's.
struct BwdScratch {
  Scratch f;
  long long m, n_last, brows, y, qparts, kparts, colpart, ds, wn, dc, dn,
      part_c, part_n, bytes;
};

inline BwdScratch bwd_scratch_of(long long BH, int S, int hd, int L,
                                 int nc) {
  BwdScratch o;
  o.f = scratch_of(BH, S, hd, L, nc);
  long long at = align_up(o.f.bytes);
  auto take = [&](long long bytes) {
    const long long here = at;
    at = align_up(at + bytes);
    return here;
  };
  const long long lp = wpitch(L), nd = out_tiles(hd), nt = state_tiles(hd);
  o.m = take(4 * BH);
  o.n_last = take(4 * BH * hd);
  o.brows = take(4LL * kTcRowKinds * BH * S);
  o.y = take(4 * BH * S * hd);
  o.qparts = take(4 * BH * S * (nd + 1));
  o.kparts = take(4 * BH * S * nd);
  o.colpart = take(4 * BH * nc * (lp / kTile) * L);
  o.ds = take(2 * BH * nc * kPlanes * lp * lp);
  o.wn = take(2 * BH * nc * kPlanes * lp * lp);
  o.dc = take(2 * BH * (nc - 1) * kPlanes * (long long)hd * hd);
  o.dn = take(4 * BH * nc * hd);
  o.part_c = take(4 * BH * nc * nt * nt);
  o.part_n = take(4 * BH * nc * (hd / 32));
  o.bytes = at;
  return o;
}

// the pair (W_ij, W_i(j+1)) in float32 from its three bf16 planes (j even)
__device__ __forceinline__ float2 from_planes(const bf16* p, long long plane) {
  float2 x = make_float2(0.f, 0.f);
#pragma unroll
  for (int pl = 0; pl < kPlanes; ++pl) {
    const float2 part =
        unpack_bf16(*reinterpret_cast<const uint32_t*>(p + pl * plane));
    x.x += part.x;
    x.y += part.y;
  }
  return x;
}

// sum over the four lanes of a quad (the lanes that hold one row of a
// wgmma accumulator)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// ------------------------------------------------------------ b1. dW
// One block per (128 rows, chunk, bh), the layout of the scores kernel:
// G = g v^T over hd (A = g, B = v in halves of 128 keys, two TMA stages),
// up to the diagonal. Then per row, with u = g / N:
//   <g_i, h_i> = sum_j W_ij G_ij / N_i + inter_s_i <q_i, C u_i>
// (the second term's parts come from the cu products), s_i, and
// dW = G / N + s, dS = dW * exp(D - m) and W / N written as three bf16
// planes each (the dq, dk and dv products read them), the row sums of
// dW * W and the block's column sums of it.
constexpr int kDwStage = 3 * kQTile;  // g, then v in two halves
constexpr int kDwSmem = 2 * kDwStage + 64 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
    mlstm_dweights_tc_kernel(const __grid_constant__ CUtensorMap tm_g,
                             const __grid_constant__ CUtensorMap tm_v,
                             const float* __restrict__ log_i, Layout lay,
                             int BH, const float* __restrict__ rows,
                             float* __restrict__ brows,
                             const bf16* __restrict__ W,
                             float* __restrict__ qparts,
                             bf16* __restrict__ dS, bf16* __restrict__ Wn,
                             float* __restrict__ colpart) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + 2 * kDwStage);
  __shared__ float bj_s[2 * kTile];
  __shared__ float lij_s[2 * kTile];
  __shared__ float cs[kThreads / 32][2 * kTile];  // column sums a warp
  const int rt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int r0 = c * lay.L;
  const int Lc = min(lay.L, lay.S - r0);
  const int i0 = rt * kTile;
  if (i0 >= Lc) return;  // the whole block: no barrier is skipped
  const int b = bh / lay.H, head = bh % lay.H;
  const int t = threadIdx.x, wg = t / 128, warp = t / 32, lane = t % 32;
  const int halves = (min(i0 + kTile, Lc) + kTile - 1) / kTile;  // 1 or 2
  const int nk = (lay.hd + kCB - 1) / kCB;
  const int nd = out_tiles(lay.hd);
  const long long plane = (long long)BH * lay.S;
  const long long off = (long long)bh * lay.S + r0;
  const float* r_b = rows + kB * plane + off;
  const float* r_m = rows + kMNew * plane + off;
  const float* r_inter = rows + kInterS * plane + off;
  const float* r_norm = rows + kDenom * plane + off;

  // step s: columns 64 s .. 64 s + 63 of g's 128 rows and v's rows
  auto load = [&](int s) {
    unsigned char* stage = base + (s & 1) * kDwStage;
    const uint32_t bar = smem_addr(bars + (s & 1));
    mbar_expect_tx(bar, (1 + halves) * kQTile);
    tma_load(smem_addr(stage), &tm_g, bar, s * kCB, head, r0 + i0, b);
    for (int hf = 0; hf < halves; ++hf)
      tma_load(smem_addr(stage + (1 + hf) * kQTile), &tm_v, bar, s * kCB,
               head, r0 + hf * kTile, b);
  };
  if (t == 0) init_barriers(bars, 2);
  __syncthreads();
  if (t == 0) {
    load(0);
    if (nk > 1) load(1);
  }
  const Rows gr = lay.gates(bh);
  for (int j = t; j < 2 * kTile; j += kThreads) {
    bj_s[j] = j < Lc ? r_b[j] : 0.f;
    lij_s[j] = j < Lc ? log_i[gr.at(r0 + j)] : 0.f;
  }
  __syncthreads();

  float acc[2][64];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[hf][x] = 0.f;
  for (int s = 0; s < nk; ++s) {
    const unsigned char* stage = base + (s & 1) * kDwStage;
    mbar_wait(smem_addr(bars + (s & 1)), (s >> 1) & 1);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int x = 0; x < 64; ++x) pin(acc[hf][x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCB / 16; ++kk) {
      const uint64_t da = kmajor(stage + 64 * wg * kRB + 32 * kk);
      wgmma_ss_n128<0, 0>(acc[0], da, kmajor(stage + kQTile + 32 * kk), 1);
      if (halves > 1)
        wgmma_ss_n128<0, 0>(acc[1], da,
                            kmajor(stage + 2 * kQTile + 32 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int x = 0; x < 64; ++x) pin(acc[hf][x]);
    __syncthreads();  // stage s & 1 is no longer read
    if (t == 0 && s + 2 < nk) load(s + 2);
  }

  // acc[hf][4 t8 + e] is G at row rA + 8 (e / 2), column 128 hf + 8 t8 +
  // 2 (lane % 4) + e % 2
  const int rA = i0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const long long lp = wpitch(lay.L), pstride = lp * lp;
  const long long cw = ((long long)bh * lay.nc + c) * kPlanes * pstride;
  const bf16* w_c = W + cw;
  float b_i[2], m_i[2], n_i[2], rowdot[2] = {0.f, 0.f};
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    const int i = rA + 8 * pr;
    b_i[pr] = i < Lc ? r_b[i] : 0.f;
    m_i[pr] = i < Lc ? r_m[i] : 0.f;
    n_i[pr] = i < Lc ? r_norm[i] : 1.f;
  }
  // sum_j W_ij G_ij / N_i
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (hf >= halves) break;
#pragma unroll
    for (int t8 = 0; t8 < 16; ++t8)
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int i = rA + 8 * pr;
        const int j = hf * kTile + 8 * t8 + 2 * (lane % 4);
        if (i >= Lc || j > i) continue;
        const float2 w = from_planes(w_c + i * lp + j, pstride);
        rowdot[pr] += w.x * (acc[hf][4 * t8 + 2 * pr] / n_i[pr]);
        if (j + 1 <= i)
          rowdot[pr] += w.y * (acc[hf][4 * t8 + 2 * pr + 1] / n_i[pr]);
      }
  }
  float s_i[2];
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    const int i = rA + 8 * pr;
    const float dot = quad_sum(rowdot[pr]);
    float sv = 0.f;
    if (i < Lc) {
      float* qp = qparts + (off + i) * (nd + 1);
      float qy = 0.f;  // <q_i, C u_i>, 0 in the first chunk (C = 0)
      if (c > 0)
        for (int ct = 0; ct < nd; ++ct) qy += qp[ct];
      const float den = brows[kDenRaw * plane + off + i];
      if (fabsf(den) > expf(-m_i[pr]))
        sv = (-copysignf(1.f, den) * (dot + r_inter[i] * qy)) / n_i[pr];
      if (lane % 4 == 0) {
        brows[kSRow * plane + off + i] = sv;
        // the gates' part s_i <q_i, n> of <q_i, C u_i + s_i n>
        qp[nd] = sv * brows[kQnRow * plane + off + i];
        if (c == 0)
          for (int ct = 0; ct < nd; ++ct) qp[ct] = 0.f;
      }
    }
    s_i[pr] = sv;
  }
  // dS, W / N, and the sums of dW * W
  bf16* ds_c = dS + cw;
  bf16* wn_c = Wn + cw;
  float rowd[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (hf >= halves) break;
#pragma unroll
    for (int t8 = 0; t8 < 16; ++t8) {
      const int j = hf * kTile + 8 * t8 + 2 * (lane % 4);
      float col[2] = {0.f, 0.f};
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int i = rA + 8 * pr;
        float ds[2] = {0.f, 0.f}, wn[2] = {0.f, 0.f};
        if (i < Lc && j <= i) {
          const float2 w2 = from_planes(w_c + i * lp + j, pstride);
          const float w[2] = {w2.x, w2.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jj = j + e;
            if (jj > i) continue;
            const float dw = acc[hf][4 * t8 + 2 * pr + e] / n_i[pr] + s_i[pr];
            ds[e] = dw * expf(((b_i[pr] - bj_s[jj]) + lij_s[jj]) - m_i[pr]);
            wn[e] = w[e] / n_i[pr];
            const float dd = dw * w[e];
            rowd[pr] += dd;
            col[e] += dd;
          }
        }
        uint32_t terms[kPlanes];
        split3(ds[0], ds[1], terms);
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl)
          *reinterpret_cast<uint32_t*>(ds_c + pl * pstride + i * lp + j) =
              terms[pl];
        split3(wn[0], wn[1], terms);
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl)
          *reinterpret_cast<uint32_t*>(wn_c + pl * pstride + i * lp + j) =
              terms[pl];
      }
      // over the warp's 16 rows: the lanes that share lane % 4
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        for (int o = 4; o < 32; o <<= 1)
          col[e] += __shfl_xor_sync(0xffffffffu, col[e], o);
        if (lane < 4) cs[warp][j + e] = col[e];
      }
    }
  }
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    const int i = rA + 8 * pr;
    const float sum = quad_sum(rowd[pr]);
    if (lane % 4 == 0 && i < Lc) brows[kRowD * plane + off + i] = sum;
  }
  __syncthreads();
  // the block's column sums, its warps in order
  const int j = t;
  if (j < halves * kTile && j < Lc) {
    float sum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sum += cs[w][j];
    colpart[(((long long)bh * lay.nc + c) * (lp / kTile) + rt) * lay.L + j] =
        sum;
  }
}
static_assert(kThreads == 2 * kTile, "a thread a column of the block");

// ------------------------------------------------------------ b2. dC
// The states kernel mirrored: one block per (128 key channels d, 128 value
// columns e, bh) walks the chunks from the last, 128 rows a step (k
// there, q here; v there, g here), with dC's tile in float32 accumulators:
//   dC <- decay dC + sum_i (w_i q_i)^T g_i,  w_i = inter_s_i / N_i,
// as wgmma m64n128, both operands MN-major: q comes by TMA and is turned
// in shared memory into w * q as three bf16 planes, g is read as it came.
// When chunk c's rows are done, the accumulator is dC' of chunk c - 1: it
// is written as three bf16 planes by TMA (the dk and dv products read
// them) with the tile's part of <dC', C> (C entering chunk c - 1, from its
// planes). Chunk 0's rows reach no earlier state and are not walked.
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_dstate_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_g,
                           const __grid_constant__ CUtensorMap tm_dc,
                           Layout lay, int BH, const float* __restrict__ rows,
                           const float* __restrict__ decay,
                           const bf16* __restrict__ C_planes,
                           float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* planes = base + 2 * kStateStage;  // hi, mid, lo of w * q
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(planes + 2 * kPlanes * kHalfBlock);
  __shared__ float w_s[kMaxChunk];
  __shared__ float red[kThreads / 32];
  const int e0 = blockIdx.x * kTile, d0 = blockIdx.y * kTile;
  const int bh = blockIdx.z;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int b = bh / lay.H, head = bh % lay.H;
  const int t = threadIdx.x, wg = t / 128, warp = t / 32, lane = t % 32;
  const long long plane = (long long)BH * lay.S;
  const float* r_inter = rows + kInterS * plane + (long long)bh * lay.S;
  const float* r_norm = rows + kDenom * plane + (long long)bh * lay.S;
  const long long hd2 = (long long)lay.hd * lay.hd;
  // acc[4 t8 + e] is dC[d, e'] with d = dA + 8 (e / 2) and
  // e' = e0 + 8 t8 + 2 (lane % 4) + e % 2
  const int dA = d0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  // the steps: the last chunk's, then chunk nc - 2's, ..., chunk 1's
  const int per_chunk = (lay.L + kHalf - 1) / kHalf;
  const int last_rows = lay.S - (lay.nc - 1) * lay.L;
  const int n_last = (last_rows + kHalf - 1) / kHalf;
  const int steps = lay.nc > 1 ? n_last + (lay.nc - 2) * per_chunk : 0;
  auto chunk_of = [&](int s) {
    return s < n_last ? lay.nc - 1 : lay.nc - 2 - (s - n_last) / per_chunk;
  };
  auto row_of = [&](int s) {
    return (s < n_last ? s : (s - n_last) % per_chunk) * kHalf;
  };
  // the last chunk's dC' is 0
  if (t == 0) part[((long long)bh * lay.nc + lay.nc - 1) * tiles + tile] = 0.f;

  auto load = [&](int s) {
    const int r = chunk_of(s) * lay.L + row_of(s);
    unsigned char* stage = base + (s & 1) * kStateStage;
    const uint32_t bar = smem_addr(bars + (s & 1));
    mbar_expect_tx(bar, kStateStage);
    for (int cb = 0; cb < 2; ++cb) {
      tma_load(smem_addr(stage + cb * kHalfBlock), &tm_q, bar, d0 + cb * kCB,
               head, r, b);
      tma_load(smem_addr(stage + (2 + cb) * kHalfBlock), &tm_g, bar,
               e0 + cb * kCB, head, r, b);
    }
  };
  if (t == 0) init_barriers(bars, 2);
  __syncthreads();
  if (t == 0 && steps > 0) {
    load(0);
    if (steps > 1) load(1);
  }

  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int c = chunk_of(s), j0 = row_of(s);
    const int r0 = c * lay.L;
    const int Lc = min(lay.L, lay.S - r0);
    if (j0 == 0) w_s[t] = t < Lc ? r_inter[r0 + t] / r_norm[r0 + t] : 0.f;
    if (t == 0) bulk_wait_read();  // the last dC' planes have left
    __syncthreads();  // w_s, and the planes buffer is free
    const unsigned char* stage = base + (s & 1) * kStateStage;
    mbar_wait(smem_addr(bars + (s & 1)), (s >> 1) & 1);
    // w * q in float32 as three bf16 planes; a piece's row is its offset /
    // 128 in its column block
    for (int p = t; p < 2 * kHalfBlock / 16; p += kThreads) {
      const int o = 16 * p;
      const float w = w_s[j0 + (o % kHalfBlock) / kRB];
      const uint4 x = *reinterpret_cast<const uint4*>(stage + o);
      const uint32_t in[4] = {x.x, x.y, x.z, x.w};
      uint32_t out[kPlanes][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = unpack_bf16(in[u]);
        uint32_t terms[kPlanes];
        split3(f.x * w, f.y * w, terms);
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) out[pl][u] = terms[pl];
      }
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl)
        *reinterpret_cast<uint4*>(planes + pl * 2 * kHalfBlock + o) =
            make_uint4(out[pl][0], out[pl][1], out[pl][2], out[pl][3]);
    }
    fence_proxy_async();
    __syncthreads();
    if (j0 == 0 && c + 1 < lay.nc) {  // dC' of chunk c, decayed
      const float dc = decay[(long long)bh * lay.nc + c];
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] *= dc;
    }
    // dC += (w q)^T g: d is A's row (MN-major), the step's rows the
    // contraction; rows past the chunk have zero planes (w = 0)
#pragma unroll
    for (int x = 0; x < 64; ++x) pin(acc[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHalf / 16; ++kk) {
      const int row = 16 * kk * kRB;
      const uint64_t dg = mnmajor(stage + 2 * kHalfBlock + row, kHalfBlock);
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl)
        wgmma_ss_n128<1, 1>(
            acc,
            mnmajor(planes + pl * 2 * kHalfBlock + wg * kHalfBlock + row,
                    kHalfBlock),
            dg, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int x = 0; x < 64; ++x) pin(acc[x]);
    if (j0 + kHalf >= Lc) {
      // chunk c is done: acc is dC' of chunk cp = c - 1. The tile's part
      // of <dC', C_cp>, C_cp entering chunk cp (0 for cp = 0)
      const int cp = c - 1;
      float dot = 0.f;
      if (cp > 0) {
        const bf16* Cc =
            C_planes + ((long long)bh * (lay.nc - 1) + cp - 1) * kPlanes * hd2;
#pragma unroll
        for (int t8 = 0; t8 < 16; ++t8)
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            const int d = dA + 8 * pr;
            const int e = e0 + 8 * t8 + 2 * (lane % 4);
            if (d >= lay.hd || e >= lay.hd) continue;
            const float2 cv = from_planes(Cc + (long long)d * lay.hd + e, hd2);
            dot += acc[4 * t8 + 2 * pr] * cv.x +
                   acc[4 * t8 + 2 * pr + 1] * cv.y;
          }
      }
      dot = warp_sum32(dot);
      // dC' as three bf16 planes, staged in the planes buffer (no longer
      // read) with the 128-byte swizzle and written by TMA, as the states
      // kernel writes C
      __syncthreads();  // every warpgroup's wgmmas have read the planes
      if (lane == 0) red[warp] = dot;
#pragma unroll
      for (int t8 = 0; t8 < 16; ++t8)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          const int r = dA - d0 + 8 * pr;  // row of the tile
          const int col = 8 * t8 + 2 * (lane % 4);
          uint32_t terms[kPlanes];
          split3(acc[4 * t8 + 2 * pr], acc[4 * t8 + 2 * pr + 1], terms);
          const int o = (col / kCB) * kHalfBlock + r * kRB +
                        ((((col % kCB) / 8) ^ (r % 8)) << 4) + 2 * (col % 8);
#pragma unroll
          for (int pl = 0; pl < kPlanes; ++pl)
            *reinterpret_cast<uint32_t*>(planes + pl * 2 * kHalfBlock + o) =
                terms[pl];
        }
      fence_proxy_async();
      __syncthreads();
      if (t == 0) {
        float sum = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) sum += red[w];
        part[((long long)bh * lay.nc + cp) * tiles + tile] = sum;
        const int first = (bh * (lay.nc - 1) + cp) * kPlanes;
        for (int pl = 0; pl < kPlanes; ++pl)
          for (int cb = 0; cb < 2; ++cb)
            tma_store3(&tm_dc,
                       smem_addr(planes + (2 * pl + cb) * kHalfBlock),
                       e0 + cb * kCB, d0, first + pl);
        bulk_commit();
      }
    }
    __syncthreads();  // stage s & 1 and the planes are no longer read
    if (t == 0 && s + 2 < steps) load(s + 2);
  }
  if (t == 0) bulk_wait_read();  // shared memory outlives its reads
}

// ------------------------------------------------------ b3. the products
// One block per (128 rows, 256 columns, chunk, bh), the layout of the
// outputs kernel: up to two products into one float32 accumulator,
// m64n256 a warpgroup, from two TMA stages of 112 KB:
//   a state product over hd: A = 128 rows of an input, B = the three bf16
//   planes of C or dC' (K-major: 256 rows of a plane a box; MN-major: 64);
//   a row scale;
//   a chunk product over the chunk's rows, 64 a step: A = the three bf16
//   planes of dS or W / N (K-major for dq; transposed, MN-major, for dk
//   and dv), B = 64 rows of an input.
// kCu: y_i = C u_i = C g_i / N_i in float32 and its rows' parts of
//      <q_i, y_i>; chunks >= 1 (C = 0 before the first);
// kDq: dq_i = sum_{j <= i} dS_ij k_j + inter_s_i (y_i + s_i n);
// kDk: dk_j = kd_j (dC' v_j + dn') + sum_{i >= j} dS_ij q_i, with the
//      rows' parts of <k_j, dC' v_j + dn'>;
// kDv: dv_j = kd_j dC'^T k_j + sum_{i >= j} (W_ij / N_i) g_i.
// The last chunk has no state product (dC' = 0 after it). A warpgroup
// skips a chunk step whose block of dS or W is zero for all its rows.
enum { kCu = 0, kDq, kDk, kDv };
constexpr int kBPlane = kOutCols * kRB;  // a K-major plane of 256 rows

template <int kKind>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_dproduct_tc_kernel(const __grid_constant__ CUtensorMap tm_a1,
                             const __grid_constant__ CUtensorMap tm_b1,
                             const __grid_constant__ CUtensorMap tm_a2,
                             const __grid_constant__ CUtensorMap tm_b2,
                             Layout lay, int BH, int row_tiles,
                             const float* __restrict__ rows,
                             const float* __restrict__ brows,
                             const float* __restrict__ vec,
                             const bf16* __restrict__ xdot,
                             float* __restrict__ y,
                             float* __restrict__ parts,
                             bf16* __restrict__ out) {
  constexpr bool kState = kKind != kDq;
  constexpr bool kChunk = kKind != kCu;
  constexpr int kTB1 = kKind == kCu || kKind == kDk ? 0 : 1;  // MN-major?
  constexpr int kTA2 = kKind == kDq ? 0 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + 2 * kOutStage);
  const int rt = blockIdx.x % row_tiles, ct = blockIdx.x / row_tiles;
  const int c = kKind == kCu ? blockIdx.y + 1 : blockIdx.y;
  const int bh = blockIdx.z;
  const int r0 = c * lay.L;
  const int Lc = min(lay.L, lay.S - r0);
  const int i0 = rt * kTile, e0 = ct * kOutCols;
  if (i0 >= Lc) return;  // the whole block: no barrier is skipped
  const int b = bh / lay.H, head = bh % lay.H;
  const int t = threadIdx.x, wg = t / 128, warp = t / 32, lane = t % 32;
  const int n1 = kState && (kKind == kCu || c + 1 < lay.nc)
                     ? (lay.hd + kCB - 1) / kCB
                     : 0;
  const int k0 = kKind == kDq ? 0 : i0;  // the chunk product's rows
  const int k1 = kKind == kDq ? min(i0 + kTile, Lc) : Lc;
  const int n2 = kChunk ? (k1 - k0 + kCB - 1) / kCB : 0;
  const int steps = n1 + n2;
  const int p1 = (bh * (lay.nc - 1) + (kKind == kCu ? c - 1 : c)) * kPlanes;
  const int p2 = (bh * lay.nc + c) * kPlanes;
  const int nd = out_tiles(lay.hd);

  auto load = [&](int s) {
    unsigned char* stage = base + (s & 1) * kOutStage;
    const uint32_t bar = smem_addr(bars + (s & 1));
    if (s < n1) {
      unsigned char* b1 = stage + kQTile;
      mbar_expect_tx(bar, kOutStage);
      tma_load(smem_addr(stage), &tm_a1, bar, s * kCB, head, r0 + i0, b);
      for (int pl = 0; pl < kPlanes; ++pl) {
        if (kTB1 == 0)
          tma_load3(smem_addr(b1 + pl * kBPlane), &tm_b1, bar, s * kCB, e0,
                    p1 + pl);
        else
          for (int cb = 0; cb < 4; ++cb)
            tma_load3(smem_addr(b1 + (4 * pl + cb) * kOutB), &tm_b1, bar,
                      e0 + cb * kCB, s * kCB, p1 + pl);
      }
    } else {
      const int kb = k0 + (s - n1) * kCB;
      unsigned char* b2 = stage + kPlanes * kQTile;
      mbar_expect_tx(bar, kPlanes * kQTile + 4 * kOutB);
      for (int pl = 0; pl < kPlanes; ++pl) {
        if (kTA2 == 0)
          tma_load3(smem_addr(stage + pl * kQTile), &tm_a2, bar, kb, i0,
                    p2 + pl);
        else
          for (int w = 0; w < 2; ++w)
            tma_load3(smem_addr(stage + pl * kQTile + w * kOutB), &tm_a2, bar,
                      i0 + w * kCB, kb, p2 + pl);
      }
      for (int cb = 0; cb < 4; ++cb)
        tma_load(smem_addr(b2 + cb * kOutB), &tm_b2, bar, e0 + cb * kCB,
                 head, r0 + kb, b);
    }
  };
  if (t == 0) init_barriers(bars, 2);
  __syncthreads();
  if (t == 0) {
    load(0);
    if (steps > 1) load(1);
  }
  const Rows hr = lay.rows(bh);
  const long long plane = (long long)BH * lay.S;
  const long long off = (long long)bh * lay.S + r0;
  const float* r_inter = rows + kInterS * plane + off;
  const float* r_kd = rows + kKDecay * plane + off;
  const float* r_norm = rows + kDenom * plane + off;
  // acc[4 t8 + e] is row rA + 8 (e / 2), column e0 + 8 t8 + 2 (lane % 4) +
  // e % 2
  const int rA = i0 + 64 * wg + 16 * (warp % 4) + lane / 4;

  float acc[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) acc[x] = 0.f;
  // between the products: dk's z = acc + dn' (and its dots), scaled by
  // the key decay; dv's likewise
  auto middle = [&]() {
    if (kKind != kDk && kKind != kDv) return;
    const float* dn =
        kKind == kDk ? vec + ((long long)bh * lay.nc + c) * lay.hd : nullptr;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int i = rA + 8 * pr;
      const bool live = i < Lc;
      const float kd = live ? r_kd[i] : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int t8 = 0; t8 < 32; ++t8) {
        const int col = e0 + 8 * t8 + 2 * (lane % 4);
        if (col >= lay.hd) continue;
        float z0 = acc[4 * t8 + 2 * pr], z1 = acc[4 * t8 + 2 * pr + 1];
        if (kKind == kDk) {
          z0 += dn[col];
          z1 += dn[col + 1];
          if (live) {
            const float2 x = unpack_bf16(*reinterpret_cast<const uint32_t*>(
                xdot + hr.at(r0 + i) + col));
            dot += x.x * z0 + x.y * z1;
          }
        }
        acc[4 * t8 + 2 * pr] = kd * z0;
        acc[4 * t8 + 2 * pr + 1] = kd * z1;
      }
      if (kKind == kDk) {
        dot = quad_sum(dot);
        if (lane % 4 == 0 && live) parts[(off + i) * nd + ct] = dot;
      }
    }
  };
  if (n1 == 0) middle();
  for (int s = 0; s < steps; ++s) {
    const unsigned char* stage = base + (s & 1) * kOutStage;
    mbar_wait(smem_addr(bars + (s & 1)), (s >> 1) & 1);
    bool live = true;
    if (s >= n1) {
      const int kb = k0 + (s - n1) * kCB;
      live = kKind == kDq ? kb <= i0 + 64 * wg + 63
                          : kb + kCB - 1 >= i0 + 64 * wg;
    }
    if (live) {
#pragma unroll
      for (int x = 0; x < 128; ++x) pin(acc[x]);
      wgmma_fence();
      if (s < n1) {
        const unsigned char* b1 = stage + kQTile;
#pragma unroll
        for (int kk = 0; kk < kCB / 16; ++kk)
#pragma unroll
          for (int pl = 0; pl < kPlanes; ++pl)
            wgmma_ss_n256<0, kTB1>(
                acc, kmajor(stage + 64 * wg * kRB + 32 * kk),
                kTB1 == 0 ? kmajor(b1 + pl * kBPlane + 32 * kk)
                          : mnmajor(b1 + 4 * pl * kOutB + 16 * kk * kRB,
                                    kOutB),
                1);
      } else {
        const unsigned char* b2 = stage + kPlanes * kQTile;
#pragma unroll
        for (int kk = 0; kk < kCB / 16; ++kk)
#pragma unroll
          for (int pl = 0; pl < kPlanes; ++pl)
            wgmma_ss_n256<kTA2, 1>(
                acc,
                kTA2 == 0
                    ? kmajor(stage + pl * kQTile + 64 * wg * kRB + 32 * kk)
                    : mnmajor(stage + pl * kQTile + wg * kOutB +
                                  16 * kk * kRB,
                              kOutB),
                mnmajor(b2 + 16 * kk * kRB, kOutB), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int x = 0; x < 128; ++x) pin(acc[x]);
    }
    if (s == n1 - 1) middle();
    __syncthreads();  // stage s & 1 is no longer read
    if (t == 0 && s + 2 < steps) load(s + 2);
  }

  const int q_stride = lay.H * lay.hd;
  bf16* hb = kKind == kCu ? nullptr
                          : out + ((long long)b * lay.S + r0) * q_stride +
                                (long long)head * lay.hd;
  const float* s_row = brows + kSRow * plane + off;
  const float* n_c =
      kKind == kDq ? vec + ((long long)bh * lay.nc + c) * lay.hd : nullptr;
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    const int i = rA + 8 * pr;
    const bool live = i < Lc;
    const int il = live ? i : 0;
    if (kKind == kCu) {
      const float norm = r_norm[il];
      float* yrow = y + (off + il) * lay.hd;
      float dot = 0.f;
#pragma unroll
      for (int t8 = 0; t8 < 32; ++t8) {
        const int col = e0 + 8 * t8 + 2 * (lane % 4);
        if (!live || col >= lay.hd) continue;
        const float y0 = acc[4 * t8 + 2 * pr] / norm;
        const float y1 = acc[4 * t8 + 2 * pr + 1] / norm;
        *reinterpret_cast<float2*>(yrow + col) = make_float2(y0, y1);
        const float2 x = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(xdot + hr.at(r0 + i) + col));
        dot += x.x * y0 + x.y * y1;
      }
      dot = quad_sum(dot);
      if (lane % 4 == 0 && live) parts[(off + i) * (nd + 1) + ct] = dot;
      continue;
    }
    if (!live) continue;
    float is = 0.f, sv = 0.f;
    const float* yrow = nullptr;
    if (kKind == kDq) {
      is = r_inter[i];
      sv = s_row[i];
      if (c > 0) yrow = y + (off + i) * lay.hd;
    }
#pragma unroll
    for (int t8 = 0; t8 < 32; ++t8) {
      const int col = e0 + 8 * t8 + 2 * (lane % 4);
      if (col >= lay.hd) continue;
      float o0 = acc[4 * t8 + 2 * pr], o1 = acc[4 * t8 + 2 * pr + 1];
      if (kKind == kDq) {
        const float2 yv = yrow ? *reinterpret_cast<const float2*>(yrow + col)
                               : make_float2(0.f, 0.f);
        o0 += is * (yv.x + sv * n_c[col]);
        o1 += is * (yv.y + sv * n_c[col + 1]);
      }
      *reinterpret_cast<uint32_t*>(hb + (long long)i * q_stride + col) =
          pack_bf16(o0, o1);
    }
  }
}

// The backward's tensor-core route on `s`: the forward's gates, states and
// scores (with the signed denominator and <q_i, n>), then cu, dW, the dC
// walk, the dn walk (CUDA cores), dq, dk, dv and the gates' sums.
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* g, const float* log_i, const float* log_f,
                       bf16* dq, bf16* dk, bf16* dv, float* dlog_i,
                       float* dlog_f, unsigned char* scratch, int batch,
                       int BH, Layout lay, cudaStream_t s) {
  const BwdScratch o = bwd_scratch_of(BH, lay.S, lay.hd, lay.L, lay.nc);
  auto f32 = [&](long long at) {
    return reinterpret_cast<float*>(scratch + at);
  };
  auto b16 = [&](long long at) {
    return reinterpret_cast<bf16*>(scratch + at);
  };
  float* rows = f32(o.f.rows);
  float* decay = f32(o.f.decay);
  float* n_prev = f32(o.f.n_prev);
  float* brows = f32(o.brows);
  bf16* C_planes = b16(o.f.c);
  bf16* dC = b16(o.dc);
  const long long plane = (long long)BH * lay.S;
  const int lp = wpitch(lay.L), nrt = lp / kTile;
  const int nd = out_tiles(lay.hd), nt = state_tiles(lay.hd);
  const int w_planes = kPlanes * BH * lay.nc;        // of W, dS and W / N
  const int s_planes = kPlanes * BH * (lay.nc - 1);  // of C and dC'
  CUtensorMap tq, tk, tv, tg, tq64, tk64, tg64, ts, ts64, twn64, tc_store,
      tc_k, tdc_store, tdc_k, tdc64;
  if (!head_map(&tq, q, batch, lay.S, lay.H, lay.hd, kTile) ||
      !head_map(&tk, k, batch, lay.S, lay.H, lay.hd, kTile) ||
      !head_map(&tv, v, batch, lay.S, lay.H, lay.hd, kTile) ||
      !head_map(&tg, g, batch, lay.S, lay.H, lay.hd, kTile) ||
      !head_map(&tq64, q, batch, lay.S, lay.H, lay.hd, kCB) ||
      !head_map(&tk64, k, batch, lay.S, lay.H, lay.hd, kCB) ||
      !head_map(&tg64, g, batch, lay.S, lay.H, lay.hd, kCB) ||
      !plane_map(&ts, b16(o.ds), lp, lp, w_planes, kTile) ||
      !plane_map(&ts64, b16(o.ds), lp, lp, w_planes, kCB) ||
      !plane_map(&twn64, b16(o.wn), lp, lp, w_planes, kCB))
    return cudaErrorInvalidValue;
  // the states exist from chunk 1 on (C) and up to chunk nc - 2 (dC'); with
  // one chunk their maps are never read and keep dS's
  tc_store = tc_k = tdc_store = tdc_k = tdc64 = ts;
  if (lay.nc > 1 &&
      (!plane_map(&tc_store, C_planes, lay.hd, lay.hd, s_planes, kTile) ||
       !plane_map(&tc_k, C_planes, lay.hd, lay.hd, s_planes, kOutCols) ||
       !plane_map(&tdc_store, dC, lay.hd, lay.hd, s_planes, kTile) ||
       !plane_map(&tdc_k, dC, lay.hd, lay.hd, s_planes, kOutCols) ||
       !plane_map(&tdc64, dC, lay.hd, lay.hd, s_planes, kCB)))
    return cudaErrorInvalidValue;

  cudaError_t err;
  const void* fns[] = {(const void*)mlstm_scores_kernel,
                       (const void*)mlstm_states_kernel,
                       (const void*)mlstm_dweights_tc_kernel,
                       (const void*)mlstm_dstate_tc_kernel,
                       (const void*)mlstm_dproduct_tc_kernel<kCu>,
                       (const void*)mlstm_dproduct_tc_kernel<kDq>,
                       (const void*)mlstm_dproduct_tc_kernel<kDk>,
                       (const void*)mlstm_dproduct_tc_kernel<kDv>};
  const int smem[] = {kScoreSmem, kStateSmem, kDwSmem,   kStateSmem,
                      kOutSmem,   kOutSmem,   kOutSmem,   kOutSmem};
  for (int x = 0; x < 8; ++x)
    if ((err = cudaFuncSetAttribute(
             fns[x], cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem[x])) != cudaSuccess)
      return err;
  mlstm_gates_kernel<<<BH, kThreads, 0, s>>>(log_i, log_f, lay, BH, rows,
                                             decay, f32(o.m));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_states_kernel<<<dim3(nt, nt, BH), kThreads, kStateSmem, s>>>(
      tk, tv, tc_store, lay, BH, rows, decay, nullptr, n_prev,
      f32(o.n_last));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_scores_kernel<<<dim3(nrt, lay.nc, BH), kThreads, kScoreSmem, s>>>(
      tq, tk, q, log_i, lay, BH, rows, n_prev, b16(o.f.w),
      brows + kDenRaw * plane, brows + kQnRow * plane);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (lay.nc > 1) {
    mlstm_dproduct_tc_kernel<kCu>
        <<<dim3(nrt * nd, lay.nc - 1, BH), kThreads, kOutSmem, s>>>(
            tg, tc_k, ts, tg64, lay, BH, nrt, rows, brows, nullptr, q,
            f32(o.y), f32(o.qparts), nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  mlstm_dweights_tc_kernel<<<dim3(nrt, lay.nc, BH), kThreads, kDwSmem,
                             s>>>(tg, tv, log_i, lay, BH, rows, brows,
                                  b16(o.f.w), f32(o.qparts), b16(o.ds),
                                  b16(o.wn), f32(o.colpart));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_dstate_tc_kernel<<<dim3(nt, nt, BH), kThreads, kStateSmem, s>>>(
      tq, tg, tdc_store, lay, BH, rows, decay, C_planes, f32(o.part_c));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_dn_kernel<bf16><<<dim3(lay.hd / 32, BH), kThreads, 0, s>>>(
      q, lay, BH, rows, brows, decay, n_prev, f32(o.dn), f32(o.part_n));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid(nrt * nd, lay.nc, BH);
  mlstm_dproduct_tc_kernel<kDq><<<grid, kThreads, kOutSmem, s>>>(
      tg, tc_k, ts, tk64, lay, BH, nrt, rows, brows, n_prev, nullptr,
      f32(o.y), nullptr, dq);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_dproduct_tc_kernel<kDk><<<grid, kThreads, kOutSmem, s>>>(
      tv, tdc_k, ts64, tq64, lay, BH, nrt, rows, brows, f32(o.dn), k,
      nullptr, f32(o.kparts), dk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_dproduct_tc_kernel<kDv><<<grid, kThreads, kOutSmem, s>>>(
      tk, tdc64, twn64, tg64, lay, BH, nrt, rows, brows, nullptr, nullptr,
      nullptr, nullptr, dv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const GateParts np = {nd + 1, nd, nt * nt, lay.hd / 32, kTile, nrt};
  mlstm_dgates_kernel<<<dim3(lay.nc, BH), kThreads, 0, s>>>(
      lay, BH, np, rows, brows, decay, f32(o.colpart), f32(o.qparts),
      f32(o.kparts), f32(o.part_c), f32(o.part_n), dlog_i, dlog_f);
  return cudaGetLastError();
}

}  // namespace tc

// Size of the scratch the caller passes, in bytes (L = min(chunk, S),
// nc = ceil(S / L)): the float32 route's rows, decays, n per chunk and W;
// the bf16 route's rows, decays, n per chunk, W planes and entering states.
extern "C" long long mlstm_scratch_bytes(int batch, int heads, int seq,
                                         int head_dim, int chunk,
                                         int is_bf16) {
  const long long BH = (long long)batch * heads;
  const int L = chunk < seq ? chunk : seq;
  const int nc = (seq + L - 1) / L;
  return is_bf16 ? tc::scratch_of(BH, seq, head_dim, L, nc).bytes
                 : f32_scratch_bytes(BH, seq, head_dim, L, nc);
}

// Launches the passes on `stream` and returns the first launch's
// cudaError_t that is not 0 (0 = all queued): float32 (is_bf16 = 0) takes
// the four CUDA-core passes, bfloat16 the tensor-core route. q/k/v/h
// (B, S, H, hd), log_i/log_f (B, S, H) float32, C (B, H, hd, hd), n
// (B, H, hd), m (B, H) float32, all contiguous, q/k/v/h 16-byte aligned,
// scratch of mlstm_scratch_bytes; 1 <= chunk <= 256, hd a multiple of 32
// up to 1024.
extern "C" int mlstm_chunkwise_fwd(const void* q, const void* k,
                                   const void* v, const void* log_i,
                                   const void* log_f, void* h, void* C,
                                   void* n, void* m, void* scratch, int batch,
                                   int heads, int seq, int head_dim,
                                   int chunk, int is_bf16, void* stream) {
  const long long BH = (long long)batch * heads;
  if (batch <= 0 || heads <= 0 || seq <= 0 || chunk <= 0 ||
      chunk > kMaxChunk || head_dim <= 0 || head_dim % kTileE != 0 ||
      head_dim > 1024 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  Layout lay;
  lay.S = seq;
  lay.H = heads;
  lay.hd = head_dim;
  lay.L = chunk < seq ? chunk : seq;
  lay.nc = (seq + lay.L - 1) / lay.L;
  if (lay.nc > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* li = static_cast<const float*>(log_i);
  const float* lf = static_cast<const float*>(log_f);
  float* Cf = static_cast<float*>(C);
  float* nf = static_cast<float*>(n);
  float* mf = static_cast<float*>(m);
  if (is_bf16)
    return (int)tc::launch(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), li, lf,
        static_cast<__nv_bfloat16*>(h), Cf, nf, mf,
        static_cast<unsigned char*>(scratch), batch, (int)BH, lay, s);
  return (int)dispatch_f32(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), li, lf, static_cast<float*>(h), Cf, nf,
      mf, static_cast<float*>(scratch), (int)BH, lay, s);
}

// The tensor-core kernels' resources (which: 0 scores, 1 states, 2
// outputs): registers a thread, local (spilled) bytes a thread, static and
// dynamic shared memory a block.
extern "C" int mlstm_bf16_attributes(int which, int* regs, int* local_bytes,
                                     int* static_smem, int* dynamic_smem) {
  return (int)tc::attributes(which, regs, local_bytes, static_smem,
                             dynamic_smem);
}

extern "C" const char* mlstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Size of the backward's scratch in bytes (L = min(chunk, S), nc = ceil(S /
// L)). The float32 route: the forward's rows, decays, n per chunk and W, h
// in float32, C entering and dC' after every chunk (2 * B*H * nc * hd^2
// floats, 512 MB at B=4 H=4 S=2048 hd=1024 L=256), dS and the parts of
// every sum. The bf16 route: the forward's rows, decays, n per chunk, W
// planes and entering states' planes, then y = C u in float32, dS, W / N
// and dC' as three bf16 planes each and the parts of every sum; q, k, v and
// g are read in place.
extern "C" long long mlstm_bwd_scratch_bytes(int batch, int heads, int seq,
                                             int head_dim, int chunk,
                                             int is_bf16) {
  const long long BH = (long long)batch * heads;
  const int L = chunk < seq ? chunk : seq;
  const int nc = (seq + L - 1) / L;
  return is_bf16 ? tc::bwd_scratch_of(BH, seq, head_dim, L, nc).bytes
                 : 4 * bwd_scratch_of(BH, seq, head_dim, L, nc).total;
}

// The backward from a fresh state: dq, dk, dv (B, S, H, hd) in the input
// type and dlog_i, dlog_f (B, S, H) float32 from q/k/v (B, S, H, hd),
// log_i/log_f (B, S, H) float32 and g (B, S, H, hd), the cotangent of h, in
// q's type; the shapes the forward takes. Launches the passes on `stream`
// and returns the first cudaError_t that is not 0 (0 = all queued).
extern "C" int mlstm_chunkwise_bwd(const void* q, const void* k,
                                   const void* v, const void* log_i,
                                   const void* log_f, const void* g,
                                   void* dq, void* dk, void* dv,
                                   void* dlog_i, void* dlog_f, void* scratch,
                                   int batch, int heads, int seq,
                                   int head_dim, int chunk, int is_bf16,
                                   void* stream) {
  const long long BH = (long long)batch * heads;
  if (batch <= 0 || heads <= 0 || seq <= 0 || chunk <= 0 ||
      chunk > kMaxChunk || head_dim <= 0 || head_dim % kTileE != 0 ||
      head_dim > 1024 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  Layout lay;
  lay.S = seq;
  lay.H = heads;
  lay.hd = head_dim;
  lay.L = chunk < seq ? chunk : seq;
  lay.nc = (seq + lay.L - 1) / lay.L;
  if (lay.nc > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* li = static_cast<const float*>(log_i);
  const float* lf = static_cast<const float*>(log_f);
  float* dli = static_cast<float*>(dlog_i);
  float* dlf = static_cast<float*>(dlog_f);
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    return (int)tc::launch_bwd(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), li, lf,
        static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), dli, dlf, static_cast<unsigned char*>(scratch),
        batch, (int)BH, lay, s);
  }
  return (int)dispatch_bwd(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), li, lf,
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), dli, dlf, static_cast<float*>(scratch),
      bwd_scratch_of(BH, seq, head_dim, lay.L, lay.nc), (int)BH, lay, s);
}

// The backward's kernels' resources (which: the float32 route's 0 values,
// 1 dstate, 2 dweights, 3 dq, 4 dk, 5 dv, 6 dgates; the bf16 route's 7 cu,
// 8 dweights, 9 dstate, 10 dq, 11 dk, 12 dv, 13 dn, 14 dgates) at head dim
// `head_dim` and chunk `chunk`: registers a thread, local (spilled) bytes a
// thread, static and dynamic shared memory a block.
extern "C" int mlstm_bwd_attributes(int which, int head_dim, int chunk,
                                    int* regs, int* local_bytes,
                                    int* static_smem, int* dynamic_smem) {
  const void* fns[] = {
      (const void*)mlstm_values_kernel<true>,
      (const void*)mlstm_dstate_kernel,
      (const void*)mlstm_dweights_kernel,
      (const void*)mlstm_dproducts_kernel<kOutQ>,
      (const void*)mlstm_dproducts_kernel<kOutK>,
      (const void*)mlstm_dproducts_kernel<kOutV>,
      (const void*)mlstm_dgates_kernel,
      (const void*)tc::mlstm_dproduct_tc_kernel<tc::kCu>,
      (const void*)tc::mlstm_dweights_tc_kernel,
      (const void*)tc::mlstm_dstate_tc_kernel,
      (const void*)tc::mlstm_dproduct_tc_kernel<tc::kDq>,
      (const void*)tc::mlstm_dproduct_tc_kernel<tc::kDk>,
      (const void*)tc::mlstm_dproduct_tc_kernel<tc::kDv>,
      (const void*)mlstm_dn_kernel<__nv_bfloat16>,
      (const void*)mlstm_dgates_kernel};
  const int values = (int)values_smem(head_dim, chunk);
  const int dyn[] = {values,         values,         0,
                     0,              0,              0,
                     0,              tc::kOutSmem,   tc::kDwSmem,
                     tc::kStateSmem, tc::kOutSmem,   tc::kOutSmem,
                     tc::kOutSmem,   0,              0};
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0])))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem = dyn[which];
  return 0;
}
