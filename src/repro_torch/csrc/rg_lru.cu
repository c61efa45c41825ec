// RG-LRU linear scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_lru_kernel` / `rg_lru_scan` of
// src/repro/kernels/rg_lru/kernel.py:23-75. Per batch row b and channel c:
//   h_{-1} = h0[b, c] (0 when h0 is null),  h_t = a[b,t,c] * h_{t-1} + b[b,t,c]
//   y[b, t, c] = h_t,  h_last[b, c] = h_{S-1}
// all in float32, for any S >= 1 and any C (the TPU kernel asks S % 256 == 0
// past 256 steps; nothing is padded or masked here).
//
// What bounds it: bytes, in principle. The scan reads a and b and writes y,
// 12 bytes and one FMA per (b, t, c): at B = 1, S = 4096, C = 4096 that is
// 201 MB, 0.060 ms at 3.35 TB/s. In this first design it is bound by latency
// instead: the recurrence is sequential in t, and one thread owns one
// (b, c), so B*C threads are all the parallelism there is (4096 at B = 1,
// one warp per SM when blocks are one warp). What the design does about it:
//   - one warp-sized block per 32 consecutive channels, so every load of a
//     and b and every store of y is one 128-byte coalesced segment, and the
//     blocks spread over as many SMs as there are;
//   - the loop over t is unrolled by kChunk and software-pipelined: the
//     loads of the next chunk of a and b are issued before the current
//     chunk's FMAs, so 2*kChunk loads are in flight per thread and a step
//     costs the dependent FMA, not a trip to memory.
// The chunked two-pass scan over S (parallel over chunks, then a carry
// fix-up) is the design that reaches the byte bound; it is a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kChunk = 16;

__device__ __forceinline__ void load_chunk(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           long long base, int t0, int steps,
                                           int channels, float* av,
                                           float* bv) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const bool in = t0 + i < steps;
    const long long off = base + (long long)(t0 + i) * channels;
    av[i] = in ? __ldg(a + off) : 0.f;
    bv[i] = in ? __ldg(b + off) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    rg_lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ h_last, int steps, int channels) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (c >= channels) return;
  const long long base = (long long)row * steps * channels + c;
  float h = h0 ? h0[(long long)row * channels + c] : 0.f;

  float an[kChunk], bn[kChunk];
  load_chunk(a, b, base, 0, steps, channels, an, bn);
  for (int t0 = 0; t0 < steps; t0 += kChunk) {
    float ac[kChunk], bc[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      ac[i] = an[i];
      bc[i] = bn[i];
    }
    if (t0 + kChunk < steps)
      load_chunk(a, b, base, t0 + kChunk, steps, channels, an, bn);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (t0 + i < steps) {
        h = fmaf(ac[i], h, bc[i]);
        y[base + (long long)(t0 + i) * channels] = h;
      }
    }
  }
  h_last[(long long)row * channels + c] = h;
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// a, b, y (B, S, C) and h0 (optional, may be null), h_last (B, C):
// contiguous float32.
extern "C" int rg_lru_scan_fwd(const void* a, const void* b, const void* h0,
                               void* y, void* h_last, int batch, int steps,
                               int channels, void* stream) {
  if (batch <= 0 || steps <= 0 || channels <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((channels + kThreads - 1) / kThreads, batch);
  rg_lru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), steps, channels);
  return (int)cudaGetLastError();
}

extern "C" const char* rg_lru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
