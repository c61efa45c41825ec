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
// sequential programs would be 4 blocks on 132 SMs. This first design
// (CUDA-core float32 FMAs, no mma/wgmma, no TMA) splits the work so that
// what does not depend on the value column is done once:
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
// caller's. Tensor-core tiles for the products, and fewer passes over q and
// k per value tile, are later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;  // rows of a chunk: one thread per row in pass 1
constexpr int kSlice = 32;      // width of a staged slice of q, k or W
constexpr int kPitch = kSlice + 1;  // row pitch of pass 3's staged tiles
constexpr int kTileE = 32;      // value columns per block of pass 4
constexpr int kRowTile = 64;    // rows (and columns) of a score tile, pass 3
constexpr float kMInit = -1e30f;
constexpr float kNegInf = -3.402823466e38f;  // below every finite float

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_n_kernel(const T* __restrict__ k, Layout lay, int BH,
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
      acc += to_f32(k[hr.at(r0 + j) + d]) * r_kd[r0 + j];
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
// One block per (64 rows, chunk, bh): W for those rows over every column
// tile up to the diagonal, and the normaliser of each row.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_weights_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const float* __restrict__ log_i, Layout lay, int BH,
                         float* __restrict__ rows,
                         const float* __restrict__ n_prev,
                         float* __restrict__ W) {
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
        qs[r][dd] = i < Lc ? to_f32(q[hr.at(r0 + i) + d0 + dd]) : 0.f;
        ks[r][dd] = j < Lc ? to_f32(k[hr.at(r0 + j) + d0 + dd]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kSlice; ++dd) {
        float a[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[ty * 4 + r][dd];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) bb[cc] = ks[tx * 4 + cc][dd];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] += a[r] * bb[cc];
      }
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
      for (int d = tx; d < lay.hd; d += 16) qn += to_f32(q[base + d]) * n_c[d];
    }
    qn = warp_sum16(qn);
    const float den = warp_sum16(rowsum[r]) + qn * r_inter[i < Lc ? i : 0];
    if (tx == 0 && i < Lc) r_den[i] = fmaxf(fabsf(den), expf(-m_i[r]));
  }
}

// ---------------------------------------------------------------- pass 4
// One block per (kTileE value columns, bh); C's tile stays in shared memory.
// Dynamic shared memory: Cs[hd][kTileE], vs[padded(L)][kTileE], the staged
// slice at[kSlice][kThreads] (transposed: thread rows are contiguous), then
// the chunk's carry decay, normaliser and key decay per row.
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
__device__ __forceinline__ void load32(const __nv_bfloat16* p, float* o) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint4 x = *reinterpret_cast<const uint4*>(p + 8 * u);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
      o[8 * u + 2 * e] = __low2float(b2);
      o[8 * u + 2 * e + 1] = __high2float(b2);
    }
  }
}

// acc[r][c] += sum_kk at[kk][8 ty + r] * B[kk][4 tx + c], kk < kSlice
__device__ __forceinline__ void fma_slice(const float* at, const float* B,
                                          int ty, int tx, float acc[8][4]) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_values_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, Layout lay, int BH,
                        const float* __restrict__ rows,
                        const float* __restrict__ decay,
                        const float* __restrict__ W, T* __restrict__ h,
                        float* __restrict__ C_out) {
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
    // rows past Lc are zeros: the last slice reads them against zero weights
    for (int idx = t; idx < Wp * kTileE; idx += kThreads) {
      const int j = idx / kTileE, e = idx % kTileE;
      vs[idx] = j < Lc ? to_f32(v[hr.at(r0 + j) + e0 + e]) : 0.f;
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
      fma_slice(at, Cs + (size_t)d0 * kTileE, ty, tx, qc);
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
        fma_slice(at, vs + (size_t)j0 * kTileE, ty, tx, intra);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty * 8 + r;
      if (i >= Lc) continue;
      const long long base = hr.at(r0 + i) + e0 + tx * 4;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        h[base + cc] = from_f32<T>((intra[r][cc] + qc[r][cc] * inter_s[i]) /
                                   denom_s[i]);
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
                       ? to_f32(k[hr.at(r0 + j0 + u) + d])
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
        fma_slice(at, vs + (size_t)j0 * kTileE, ty, tx, upd);
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
  for (int idx = t; idx < lay.hd * kTileE; idx += kThreads) {
    const int d = idx / kTileE, e = idx % kTileE;
    C_out[((long long)bh * lay.hd + d) * lay.hd + e0 + e] = Cs[idx];
  }
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* log_i, const float* log_f, void* h,
                     float* C, float* n, float* m, float* rows, float* decay,
                     float* n_prev, float* W, int BH, Layout lay,
                     cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  mlstm_gates_kernel<<<BH, kThreads, 0, s>>>(log_i, log_f, lay, BH, rows,
                                             decay, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_n_kernel<T><<<dim3(lay.hd / 32, BH), kThreads, 0, s>>>(
      kt, lay, BH, rows, decay, n_prev, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_weights_kernel<T>
      <<<dim3((lay.L + kRowTile - 1) / kRowTile, lay.nc, BH), kThreads, 0, s>>>(
          qt, kt, log_i, lay, BH, rows, n_prev, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = values_smem(lay.hd, lay.L);
  err = cudaFuncSetAttribute(mlstm_values_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  mlstm_values_kernel<T><<<dim3(lay.hd / kTileE, BH), kThreads, smem, s>>>(
      qt, kt, vt, lay, BH, rows, decay, W, static_cast<T*>(h), C);
  return cudaGetLastError();
}

}  // namespace

// Size of the float32 scratch the caller passes, in floats: rows
// (5 * B*H * S), decay (B*H * nc), n per chunk (B*H * nc * hd) and W
// (B*H * nc * L * padded(L)), with L = min(chunk, S), nc = ceil(S / L).
extern "C" long long mlstm_scratch_floats(int batch, int heads, int seq,
                                          int head_dim, int chunk) {
  const long long BH = (long long)batch * heads;
  const int L = chunk < seq ? chunk : seq;
  const long long nc = (seq + L - 1) / L;
  return BH * (kRowKinds * (long long)seq + nc + nc * head_dim +
               nc * (long long)L * padded(L));
}

// Launches the four passes on `stream` and returns the first launch's
// cudaError_t that is not 0 (0 = all queued). q/k/v/h (B, S, H, hd) in
// float32 (is_bf16 = 0) or bfloat16, log_i/log_f (B, S, H) float32,
// C (B, H, hd, hd), n (B, H, hd), m (B, H) and scratch float32, all
// contiguous, q/k/v/h 16-byte aligned; 1 <= chunk <= 256, hd a multiple of
// 32 up to 1024.
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
  float* rows = static_cast<float*>(scratch);
  float* decay = rows + kRowKinds * BH * seq;
  float* n_prev = decay + BH * lay.nc;
  float* W = n_prev + BH * lay.nc * head_dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* li = static_cast<const float*>(log_i);
  const float* lf = static_cast<const float*>(log_f);
  float* Cf = static_cast<float*>(C);
  float* nf = static_cast<float*>(n);
  float* mf = static_cast<float*>(m);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, li, lf, h, Cf, nf, mf, rows,
                                        decay, n_prev, W, (int)BH, lay, s);
  return (int)dispatch<float>(q, k, v, li, lf, h, Cf, nf, mf, rows, decay,
                              n_prev, W, (int)BH, lay, s);
}

extern "C" const char* mlstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
