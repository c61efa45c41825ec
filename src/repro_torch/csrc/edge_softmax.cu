// Edge-softmax aggregation, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `edge_softmax_aggregate` of
// src/repro/kernels/edge_softmax/kernel.py:23-69. Per node n and head h:
//   s_p   = scale * <q[n,h,:], k[n,p,h,:]>, set to -1e30 where mask[n,p] == 0
//   att_p = exp(s_p - max_p s_p) * mask_p / max(sum_p exp(...) * mask_p, 1e-30)
//   out   = sum_p att_p * v[n,p,h,:]
// with float32 accumulation, `out` in q's type (float32 or bfloat16) and
// `att` in float32. A fully masked node gives out = 0 and att = 0.
//
// What bounds it: bytes. Per node the kernel reads q (C values), k and v
// (P*C each) and the mask (P bytes), and writes out (C values) and att
// (H*P floats), with about 4*P*C flops: at the paper's width (C = H*hd =
// 32, P = 3, float32) that is about 1 KB and 400 flops per node, far
// below the card's ratio of flops to bytes. So the design only has to
// move each byte once, in full coalesced transactions:
//   - a group of G = min(32, next_pow2(C)) lanes owns one node, and lane
//     t holds the channels c = t + G*j (j < VEC) of q, of every k_p and of
//     every v_p: each row the group loads is one contiguous segment of the
//     feature axis (the TPU kernel's (node block x head) grid is not
//     copied; all heads of a node are served by the same group);
//   - the score of a head is reduced over its hd lanes with segmented
//     xor shuffles, so every lane of the head ends up holding all P
//     scores, does the softmax in registers and writes its own `out`
//     channel; the head's first lane writes `att`;
//   - nothing is staged in shared memory and nothing is padded: the
//     kernel masks the ragged edge of N itself.
// Limits (checked by the wrapper and again here): hd a power of two,
// H*hd <= 128, 1 <= P <= 8.
//
// Why CUDA C++ and not Triton: CUDA C++ is the port's rule for kernels.
// Triton would also do for a reduction this small, but P = 3 is not a
// power of two (Triton blocks are), and the machines that run the CPU
// tests have no Triton to import.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 8;
constexpr int kMaxChannels = 128;
constexpr float kNegInf = -1e30f;

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
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    edge_softmax_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const uint8_t* __restrict__ mask,
                            T* __restrict__ out, float* __restrict__ att,
                            long long n_nodes, int heads, int head_dim,
                            int n_pred, int group, float scale) {
  const int channels = heads * head_dim;
  const int t = threadIdx.x % group;
  const long long node =
      (long long)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  // Lanes past N still take part in the shuffles, with zeros.
  const bool live = node < n_nodes;
  // Lanes reduced together, and the number of consecutive j that share
  // one head when a head is wider than the group (hd = 64 or 128).
  const int seg = min(head_dim, group);
  const int span = head_dim / seg;

  bool on[VEC];
  float qv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = t + group * j;
    on[j] = live && c < channels;
    qv[j] = on[j] ? to_f32(q[node * channels + c]) : 0.f;
  }

  bool m[kMaxP];
  float s[kMaxP][VEC];
#pragma unroll
  for (int p = 0; p < kMaxP; ++p) {
    if (p >= n_pred) break;
    m[p] = live && mask[node * n_pred + p] != 0;
    const long long row = (node * n_pred + p) * channels;
    float part[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = t + group * j;
      part[j] = on[j] ? qv[j] * to_f32(k[row + c]) : 0.f;
    }
    for (int off = seg >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float tot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (i / span == j / span) tot += part[i];
      s[p][j] = m[p] ? tot * scale : kNegInf;
    }
  }

#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float mx = kNegInf;
#pragma unroll
    for (int p = 0; p < kMaxP; ++p)
      if (p < n_pred) mx = fmaxf(mx, s[p][j]);
    float e[kMaxP];
    float den = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxP; ++p) {
      e[p] = (p < n_pred && m[p]) ? expf(s[p][j] - mx) : 0.f;
      den += e[p];
    }
    den = fmaxf(den, 1e-30f);
    if (!on[j]) continue;
    const int c = t + group * j;
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxP; ++p) {
      if (p >= n_pred) break;
      e[p] = e[p] / den;
      acc += e[p] * to_f32(v[(node * n_pred + p) * channels + c]);
    }
    out[node * channels + c] = from_f32<T>(acc);
    if (c % head_dim == 0) {
      float* a = att + (node * heads + c / head_dim) * n_pred;
#pragma unroll
      for (int p = 0; p < kMaxP; ++p)
        if (p < n_pred) a[p] = e[p];
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* out, float* att,
                   long long n_nodes, int heads, int head_dim, int n_pred,
                   float scale, cudaStream_t stream) {
  const int channels = heads * head_dim;
  int group = 1;
  while (group < channels && group < 32) group <<= 1;
  const int vec = (channels + group - 1) / group;
  const long long per_block = kThreads / group;
  const unsigned blocks = (unsigned)((n_nodes + per_block - 1) / per_block);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (vec == 1)
    edge_softmax_fwd_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        qt, kt, vt, mask, ot, att, n_nodes, heads, head_dim, n_pred, group,
        scale);
  else if (vec == 2)
    edge_softmax_fwd_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(
        qt, kt, vt, mask, ot, att, n_nodes, heads, head_dim, n_pred, group,
        scale);
  else
    edge_softmax_fwd_kernel<T, 4><<<blocks, kThreads, 0, stream>>>(
        qt, kt, vt, mask, ot, att, n_nodes, heads, head_dim, n_pred, group,
        scale);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// q (N, H, hd), k/v (N, P, H, hd), out (N, H, hd): contiguous, of type
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); mask (N, P) bytes;
// att (N, H, P) float32.
extern "C" int edge_softmax_fwd(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* att,
                                long long n_nodes, int heads, int head_dim,
                                int n_pred, float scale, int is_bf16,
                                void* stream) {
  if (n_nodes <= 0 || heads <= 0 || head_dim <= 0 ||
      (head_dim & (head_dim - 1)) != 0 || heads * head_dim > kMaxChannels ||
      n_pred <= 0 || n_pred > kMaxP)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* a = static_cast<float*>(att);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, m, out, a, n_nodes, heads,
                                      head_dim, n_pred, scale, s);
  return (int)launch<float>(q, k, v, m, out, a, n_nodes, heads, head_dim,
                            n_pred, scale, s);
}

extern "C" const char* edge_softmax_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
