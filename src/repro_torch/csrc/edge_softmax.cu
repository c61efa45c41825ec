// Edge-softmax aggregation, forward and backward, for Hopper (sm_90a).
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
// The backward (`edge_softmax_bwd_kernel`) replaces the custom VJP of
// src/repro/kernels/edge_softmax/ops.py:58-71 (`_bwd`, three einsums; the
// TPU has no kernel for it). From the forward's saved att, per node n,
// head h and predecessor p:
//   da_p = <g_out[n,h,:], v[n,p,h,:]> + g_att[n,h,p]   (g_att may be null)
//   ds_p = att_p * (da_p - sum_p att_p * da_p)
//   dq   = scale * sum_p ds_p * k[n,p,h,:]
//   dk_p = scale * ds_p * q[n,h,:],   dv_p = att_p * g_out[n,h,:]
// It has the forward's layout (a group of G lanes a node, lane t holding
// channels c = t + G*j of q, g_out and every k_p / v_p); da_p is reduced
// over the head's lanes with the same segmented xor shuffles as the
// forward's scores, so every lane holds all P values of da and att and
// forms ds in registers, then writes its own channels of dq, dk_p and
// dv_p. The softmax is not recomputed and the mask is not read: att is 0
// on masked slots, so ds, dk and dv are too. Nothing is accumulated
// across groups (a node's gradients belong to its group), so no atomics
// and the same bits on every launch. Bytes bound it: per node it reads
// q and g_out (C each), k and v (P*C each), att (H*P floats) and g_att
// when given, and writes dq (C), dk and dv (P*C each), with about 8*P*C
// flops: at C = 32, P = 3, float32 and no g_att, 1,968 bytes a node.
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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    edge_softmax_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ att,
                            const T* __restrict__ g_out,
                            const float* __restrict__ g_att,
                            T* __restrict__ dq, T* __restrict__ dk,
                            T* __restrict__ dv, long long n_nodes,
                            int heads, int head_dim, int n_pred, int group,
                            float scale) {
  const int channels = heads * head_dim;
  const int t = threadIdx.x % group;
  const long long node =
      (long long)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  // Lanes past N still take part in the shuffles, with zeros.
  const bool live = node < n_nodes;
  const int seg = min(head_dim, group);
  const int span = head_dim / seg;

  bool on[VEC];
  float qv[VEC], gv[VEC];
  long long arow[VEC];  // (node, head of channel j) row of att / g_att
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = t + group * j;
    on[j] = live && c < channels;
    qv[j] = on[j] ? to_f32(q[node * channels + c]) : 0.f;
    gv[j] = on[j] ? to_f32(g_out[node * channels + c]) : 0.f;
    arow[j] = on[j] ? (node * heads + c / head_dim) * n_pred : 0;
  }

  float kv[kMaxP][VEC];  // k_p, kept for dq
  float a[kMaxP][VEC];   // att_p of channel j's head
  float da[kMaxP][VEC];
#pragma unroll
  for (int p = 0; p < kMaxP; ++p) {
    if (p >= n_pred) break;
    const long long row = (node * n_pred + p) * channels;
    float part[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = t + group * j;
      kv[p][j] = on[j] ? to_f32(k[row + c]) : 0.f;
      part[j] = on[j] ? gv[j] * to_f32(v[row + c]) : 0.f;
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
      if (on[j] && g_att != nullptr) tot += g_att[arow[j] + p];
      a[p][j] = on[j] ? att[arow[j] + p] : 0.f;
      da[p][j] = tot;
    }
  }

#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (!on[j]) continue;
    const int c = t + group * j;
    float mean = 0.f;  // sum_p att_p * da_p
#pragma unroll
    for (int p = 0; p < kMaxP; ++p)
      if (p < n_pred) mean += a[p][j] * da[p][j];
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxP; ++p) {
      if (p >= n_pred) break;
      const long long row = (node * n_pred + p) * channels;
      const float ds = a[p][j] * (da[p][j] - mean);
      acc += ds * kv[p][j];
      dk[row + c] = from_f32<T>(scale * (ds * qv[j]));
      dv[row + c] = from_f32<T>(a[p][j] * gv[j]);
    }
    dq[node * channels + c] = from_f32<T>(scale * acc);
  }
}

// Lanes a node (the smallest power of two >= C, at most 32), channels a
// lane, and blocks for n_nodes.
struct Layout {
  int group, vec;
  unsigned blocks;
};

Layout layout(long long n_nodes, int channels) {
  int group = 1;
  while (group < channels && group < 32) group <<= 1;
  const long long per_block = kThreads / group;
  return {group, (channels + group - 1) / group,
          (unsigned)((n_nodes + per_block - 1) / per_block)};
}

bool valid(long long n_nodes, int heads, int head_dim, int n_pred) {
  return n_nodes > 0 && heads > 0 && head_dim > 0 &&
         (head_dim & (head_dim - 1)) == 0 &&
         heads * head_dim <= kMaxChannels && n_pred > 0 && n_pred <= kMaxP;
}

template <typename T, int VEC>
void launch_bwd_vec(const Layout& l, const void* q, const void* k,
                    const void* v, const float* att, const void* g_out,
                    const float* g_att, void* dq, void* dk, void* dv,
                    long long n_nodes, int heads, int head_dim, int n_pred,
                    float scale, cudaStream_t stream) {
  edge_softmax_bwd_kernel<T, VEC><<<l.blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), att, static_cast<const T*>(g_out), g_att,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      n_nodes, heads, head_dim, n_pred, l.group, scale);
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const float* att, const void* g_out,
                       const float* g_att, void* dq, void* dk, void* dv,
                       long long n_nodes, int heads, int head_dim,
                       int n_pred, float scale, cudaStream_t stream) {
  const Layout l = layout(n_nodes, heads * head_dim);
  if (l.vec == 1)
    launch_bwd_vec<T, 1>(l, q, k, v, att, g_out, g_att, dq, dk, dv, n_nodes,
                         heads, head_dim, n_pred, scale, stream);
  else if (l.vec == 2)
    launch_bwd_vec<T, 2>(l, q, k, v, att, g_out, g_att, dq, dk, dv, n_nodes,
                         heads, head_dim, n_pred, scale, stream);
  else
    launch_bwd_vec<T, 4>(l, q, k, v, att, g_out, g_att, dq, dk, dv, n_nodes,
                         heads, head_dim, n_pred, scale, stream);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* out, float* att,
                   long long n_nodes, int heads, int head_dim, int n_pred,
                   float scale, cudaStream_t stream) {
  const Layout l = layout(n_nodes, heads * head_dim);
  const int group = l.group, vec = l.vec;
  const unsigned blocks = l.blocks;
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
  if (!valid(n_nodes, heads, head_dim, n_pred))
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

// The backward: launches on `stream` and returns the launch's cudaError_t.
// q (N, H, hd), k/v (N, P, H, hd), g_out (N, H, hd) and the outputs dq,
// dk, dv (shaped as q, k, v): contiguous, float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); att and g_att (N, H, P) float32, g_att may be
// null (a zero cotangent).
extern "C" int edge_softmax_bwd(const void* q, const void* k, const void* v,
                                const void* att, const void* g_out,
                                const void* g_att, void* dq, void* dk,
                                void* dv, long long n_nodes, int heads,
                                int head_dim, int n_pred, float scale,
                                int is_bf16, void* stream) {
  if (!valid(n_nodes, heads, head_dim, n_pred))
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(att);
  const float* ga = static_cast<const float*>(g_att);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_bwd<__nv_bfloat16>(q, k, v, a, g_out, ga, dq, dk, dv,
                                          n_nodes, heads, head_dim, n_pred,
                                          scale, s);
  return (int)launch_bwd<float>(q, k, v, a, g_out, ga, dq, dk, dv, n_nodes,
                                heads, head_dim, n_pred, scale, s);
}

extern "C" const char* edge_softmax_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
