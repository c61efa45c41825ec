// Causal / sliding-window GQA attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `flash_attention_fwd` of
// src/repro/kernels/flash_attention/kernel.py:28-129. For every batch row b,
// query head h (kv head h / (H / KH)) and query position i < S:
//   s_j = scale * <q[b,i,h,:], k[b,j,kvh,:]>  for the keys j < T that are
//         live: j <= i when causal, i - j < window when window > 0;
//   out[b,i,h,:] = sum_j softmax_j(s) v[b,j,kvh,:]
// with the softmax state (m, l) and the accumulator in float32 and the
// output in q's type (float32 or bfloat16). A row with no live key gives 0
// (l is clamped to 1e-30, as on the TPU). Any S and T: ragged tails are
// masked here, nothing is padded (the TPU kernel asks S % 512 == 0 past 512).
// The tensors are in the model's layout, q/out (B, S, H, D) and k/v
// (B, T, KH, D), so a head's rows are D contiguous elements H*D (or KH*D)
// apart and the caller transposes and copies nothing (the TPU kernel takes
// (B, H, S, D)). Offsets inside one batch row are 32-bit (S*H*D and T*KH*D
// below 2^31): with 64-bit row strides ptxas holds the D = 256 instances to
// 128 registers and the kernel runs about 14 % slower.
//
// What bounds it: operations. Per (q, k) pair the kernel does 2*D flops for
// the score and 2*D for the weighted sum, against 2*D elements of K and V
// that are re-read from shared memory by every query row. At the full-width
// prefill (S = 4096, window 2048, H = 16, D = 256) that is about 103 GFLOP
// per call against about 71 MB of device memory: compute-bound on the
// tensor cores' 989 TFLOP/s. This first design is deliberately plain:
// CUDA-core FMAs, no mma/wgmma, no TMA. What it does:
//   - one block of 256 threads per (64 query rows, head, batch row); K and V
//     come in tiles of 64 keys, and only the tiles that hold a live key for
//     some row of the block are visited (the TPU kernel's pl.when skip);
//   - Q, K, V and the probability tile P sit in shared memory as float32
//     with a row pitch of D + 1, so the 16 lanes that read 16 different
//     key rows hit 16 different banks; at D = 256 that is 214 KB, one block
//     per SM;
//   - thread (ty, tx) of a 16 x 16 grid owns query rows 4*ty..4*ty+3 and
//     key columns tx + 16*j of the score tile, and the output columns
//     tx + 16*c of the same rows, so the online-softmax row statistics are
//     reduced with xor shuffles inside a half-warp and every thread
//     rescales only its own accumulator;
//   - blocks are issued last query block first: under a causal mask without
//     a window those have the most tiles, and the short ones fill the tail.
// mma.sync / wgmma, TMA loads into a ring of tiles and serving all the query
// heads of one kv head from one K/V tile (MQA) are later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int heads,
                     int kv_heads, int q_len, int k_len, int causal,
                     int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int kOut = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;  // kBQ x (kBK + 1)

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qb * kBQ;
  const int q_stride = heads * D;  // between positions
  const int k_stride = kv_heads * D;
  const T* qh = q + (long long)b * q_len * q_stride + (long long)h * D;
  const T* kh = k + (long long)b * k_len * k_stride + (long long)kvh * D;
  const T* vh = v + (long long)b * k_len * k_stride + (long long)kvh * D;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, D>(qh, q_stride, q0, q_len, sQ);

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
    load_tile<T, D>(kh, k_stride, k0, k_len, sK);
    load_tile<T, D>(vh, k_stride, k0, k_len, sV);
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
        const float x = sV[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], x, acc[i][c]);
      }
    }
  }

  T* oh = out + (long long)b * q_len * q_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= q_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      oh[row * q_stride + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int heads, int kv_heads, int q_len, int k_len,
                   int causal, int window, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * ((kBQ + 2 * kBK) * (D + 1) +
                                         kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), heads, kv_heads, q_len,
      k_len, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int batch, int heads, int kv_heads, int q_len, int k_len,
                     int head_dim, int causal, int window, float scale,
                     cudaStream_t s) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, out, batch, heads, kv_heads, q_len, k_len,
                           causal, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, heads, kv_heads, q_len, k_len,
                           causal, window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, batch, heads, kv_heads, q_len,
                            k_len, causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// q, out (B, S, H, D) and k, v (B, T, KH, D): contiguous, 16-byte aligned,
// of type float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); H % KH == 0;
// D in {16, 64, 256} (the small test model, the kernel sweep, and
// RecurrentGemma's 256); S*H*D and T*KH*D below 2^31; window <= 0 means no
// window.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int batch,
                                   int heads, int kv_heads, int q_len,
                                   int k_len, int head_dim, int causal,
                                   int window, float scale, int is_bf16,
                                   void* stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 ||
      kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 || k_len <= 0 ||
      (long long)q_len * heads * head_dim >= (1LL << 31) ||
      (long long)k_len * kv_heads * head_dim >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, batch, heads, kv_heads,
                                        q_len, k_len, head_dim, causal,
                                        window, scale, s);
  return (int)dispatch<float>(q, k, v, out, batch, heads, kv_heads, q_len,
                              k_len, head_dim, causal, window, scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
