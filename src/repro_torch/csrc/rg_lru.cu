// RG-LRU linear scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_lru_kernel` / `rg_lru_scan` of
// src/repro/kernels/rg_lru/kernel.py:23-75. Per batch row b and channel c:
//   h_{-1} = h0[b, c] (0 when h0 is null),  h_t = a[b,t,c] * h_{t-1} + b[b,t,c]
//   y[b, t, c] = h_t,  h_last[b, c] = h_{S-1}
// all in float32, for any S >= 1 and any C (the TPU kernel asks S % 256 == 0
// past 256 steps; nothing is padded here).
//
// What bounds it: bytes. The scan reads a and b and writes y, 12 bytes and
// one FMA per (b, t, c): at B = 1, S = 4096, C = 4096 that is 201 MB, 0.060
// ms at 3.35 TB/s. Parallel work over channels alone (one thread per (b, c))
// is 4096 threads at B = 1, too few to keep the ~2 MB in flight that HBM
// needs; so the scan is parallel over time as well, in one pass: a
// chunk-parallel scan with a decoupled look-back (Merrill & Garland,
// "Single-pass parallel prefix scan with decoupled look-back", 2016) on the
// operator (a, h) -> a * h + b.
//
//   - Tiles. A block owns one tile: one batch row, kSteps = 32 consecutive
//     steps (a chunk) and kThreads = 128 consecutive channels, one channel a
//     thread. Each thread issues all 2 * 32 loads of its a and b before any
//     FMA and keeps them in registers (64 floats): at the main shape that is
//     4096 blocks of 48 KB of traffic, and with several blocks an SM far more
//     than 2 MB in flight across the card; a 128-token prompt still gives 128
//     blocks. A warp's load or store of one step is one 128-byte segment.
//     Plain 4-byte loads into registers (not TMA, not 16-byte vectors) keep
//     any C legal and already put enough bytes in flight: these tiles
//     without the look-back stream as fast as a copy of the same bytes, and
//     wider vectors, other tile shapes or staging in shared memory by
//     cp.async moved the whole kernel by a few percent at most. No tensor
//     core applies to a stream of FMAs.
//   - Order without deadlock. Each block takes a ticket from a global counter
//     (atomicAdd) and derives its tile from it, chunk-major, not from
//     blockIdx: every tile a block waits on (earlier chunks of its row and
//     channels) holds an earlier ticket and so is already running.
//   - Aggregate. A block first folds its chunk into A_k = prod a_t (in step
//     order) and H_k, the chunk's scan from 0 (fmaf in step order), and
//     publishes them per channel with a status flag per tile.
//   - Look-back in an order that fixes the bits. Warp 0 reads the flags of
//     up to 32 earlier chunks at once, back to the nearest chunk j whose
//     inclusive prefix P_j is published (chunk 0 publishes P_0 directly),
//     waiting where a flag is still empty. Every thread then runs the
//     recursion forwards, P_i = fmaf(A_i, P_{i-1}, H_i) for i = j+1..k-1,
//     and publishes P_k = fmaf(A_k, P_{k-1}, H_k). So every P_i is the same
//     expression in the same order (the chain from P_{-1} = h0 or 0),
//     whichever j a block found, and y is bit-identical from run to run.
//     Aggregates are never combined pairwise, whose bits would depend on
//     timing.
//   - Rescan. From P_{k-1} the block rescans its registers, y_t = fmaf(a_t,
//     h, b_t), stores y, and the last chunk of a row writes h_last (= y at
//     S - 1). A ragged last chunk pads a = 1, b = 0, which changes no bit.
//   - Memory order. Values are stored plainly; after a block barrier one
//     thread publishes the tile's flag with st.release.gpu; warp 0 polls with
//     ld.acquire.gpu, and after a block barrier the threads read the values
//     with ld.global.cg, from L2, the point of coherence.
//   - What is left between it and the bound is the look-back's serial
//     round trips (ticket, publish, poll, read, publish), during which a
//     block holds its registers with no bytes in flight.
//   - Scratch, one buffer from the wrapper: A, H and P as float32 per (b,
//     chunk, channel) (12 bytes each, 6.3 MB at the main shape, 3 % of the
//     201 MB the bound counts), then the flags per (b, tile, chunk) and the
//     ticket counter (16 KB at the main shape), which the launcher zeroes
//     with cudaMemsetAsync before the kernel.
//
// RG-LRU linear scan, backward (rg_lru_scan_bwd_kernel). Replaces no Pallas
// kernel: the reference differentiates its plain scan
// (src/repro/kernels/rg_lru/ops.py::_scan_bwd, :31-35, jax.vjp of
// ref.linear_scan). From the forward's a and y, h0 and the cotangents g of
// y and g_last of h_last:
//   dh_{S-1} = g_{S-1} + g_last,  dh_t = a_{t+1} * dh_{t+1} + g_t
//   db_t = dh_t,  da_t = dh_t * h_{t-1} (h_{-1} = h0, or 0),  dh0 = a_0 dh_0
// It reads a, g and y and writes da and db: 20 bytes a (b, t, c), 335.5 MB
// at B = 1, S = 4096, C = 4096, 0.1002 ms at 3.35 TB/s.
//
//   - The forward's design run backwards: the recursion is the forward's
//     operator on the reversed sequence, with coefficient a'_t = a_{t+1}
//     (1 at t = S - 1) and P_{-1} = g_last. The same tiles of 32 steps by
//     128 channels, with tickets handed out chunk-major from the LAST
//     chunk: visit v is chunk chunks - 1 - v, and every tile a block waits
//     on (later chunks of its row) holds an earlier ticket. The same chain
//     (chain() below) publishes each visit's aggregate, looks back to the
//     nearest published prefix and runs P_i = fmaf(A_i, P_{i-1}, H_i) from
//     there in visit order, so da and db are bit-identical from run to run.
//   - Loads. Step i of chunk k (t = 32 k + i) needs a_{t+1}, g_t and
//     h_{t-1} = y_{t-1}: the tile reads a and y one step off its own
//     chunk, so the last step's a and the first step's y come from the
//     neighbouring chunks (one extra 128-byte segment a warp each); h0 (or
//     0) stands for y_{-1}, and chunk 0 reads a_0 for dh0. All 3 * 32 loads
//     are issued before any FMA (96 floats in registers).
//   - A ragged last chunk is visited first: its padded steps carry a' = 1,
//     g = 0, so they hand g_last (or 0) on unchanged to step S - 1 and
//     store nothing.
//   - Scratch as the forward's (rg_lru_scratch_bytes), a buffer of its own
//     per call; the launcher zeroes the flags and ticket before the kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 32;     // steps of a chunk (a tile's length)
constexpr int kThreads = 128;  // channels of a tile, one a thread
constexpr int kBatchRecursion = 8;  // aggregates loaded at once

enum : unsigned { kEmpty = 0, kAggregate = 1, kPrefix = 2 };

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

struct Scratch {
  float* agg_a;     // A_k  (B, chunks, C)
  float* agg_h;     // H_k  (B, chunks, C)
  float* prefix;    // P_k  (B, chunks, C)
  unsigned* flags;  // (B, tiles, chunks): kEmpty / kAggregate / kPrefix
  unsigned* ticket;
};

// The look-back of one tile, visit k of its (row, tile) chain: publishes the
// visit's aggregate (A, H), finds the nearest published prefix j < k, runs
// P_i = fmaf(A_i, P_{i-1}, H_i) forwards from there and publishes P_k (the
// last visit publishes nothing). Returns P_{k-1}, the carry into the tile;
// P_{-1} is *start, or 0 when start is null. Called by every thread.
__device__ __forceinline__ float chain(const Scratch& scr, int row, int tile,
                                       int k, int chunks, int tiles,
                                       int channels, int c, bool live,
                                       const float* start, float A, float H) {
  __shared__ int s_from;
  const long long slot = ((long long)row * chunks + k) * channels + c;
  unsigned* flags = scr.flags + (long long)(row * tiles + tile) * chunks;
  const bool last = k == chunks - 1;
  float carry = k == 0 && start ? *start : 0.f;  // P_{k-1}
  if (k > 0) {
    if (!last) {
      if (live) {
        scr.agg_a[slot] = A;
        scr.agg_h[slot] = H;
      }
      __syncthreads();
      if (threadIdx.x == 0) st_release(flags + k, kAggregate);
    }
    // warp 0 finds the nearest published prefix j < k, past aggregates only
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int end = k;  // this window reads chunks end-1-lane
      int from;
      for (;;) {
        const int j = end - 1 - lane;
        const unsigned s = j >= 0 ? ld_acquire(flags + j) : kPrefix;
        const unsigned prefix = __ballot_sync(~0u, s == kPrefix);
        const unsigned empty = __ballot_sync(~0u, s == kEmpty);
        const int p = prefix ? __ffs(prefix) - 1 : 32;
        const unsigned before = p == 32 ? ~0u : (1u << p) - 1u;
        if (empty & before) {  // an aggregate on the way is not out yet
          __nanosleep(32);
          continue;
        }
        if (p < 32) {
          from = end - 1 - p;
          break;
        }
        end -= 32;
      }
      if (lane == 0) s_from = from;
    }
    __syncthreads();
    const int from = s_from;
    const long long first = ((long long)row * chunks) * channels + c;
    float p = 0.f;
    if (live) {
      if (from < 0 && start) p = *start;
      if (from >= 0)
        p = __ldcg(scr.prefix + first + (long long)from * channels);
      // P_i = fmaf(A_i, P_{i-1}, H_i), forwards, kBatchRecursion loads at once
      for (int i0 = from + 1; i0 < k; i0 += kBatchRecursion) {
        float ai[kBatchRecursion], hi[kBatchRecursion];
#pragma unroll
        for (int u = 0; u < kBatchRecursion; ++u) {
          const long long at = first + (long long)(i0 + u) * channels;
          ai[u] = i0 + u < k ? __ldcg(scr.agg_a + at) : 1.f;
          hi[u] = i0 + u < k ? __ldcg(scr.agg_h + at) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatchRecursion; ++u)
          if (i0 + u < k) p = fmaf(ai[u], p, hi[u]);
      }
    }
    carry = p;
  }
  if (!last) {  // P_k, for the visits after this one
    if (live) scr.prefix[slot] = fmaf(A, carry, H);
    __syncthreads();
    if (threadIdx.x == 0) st_release(flags + k, kPrefix);
  }
  return carry;
}

// The tile of a ticket, chunk-major: (visit, row, tile).
__device__ __forceinline__ void ticket_tile(const Scratch& scr, int batch,
                                            int tiles, int* visit, int* row,
                                            int* tile) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = (int)atomicAdd(scr.ticket, 1u);
  __syncthreads();
  const int per_visit = batch * tiles;
  *visit = s_ticket / per_visit;
  const int rest = s_ticket - *visit * per_visit;
  *row = rest / tiles;
  *tile = rest - *row * tiles;
}

__global__ void __launch_bounds__(kThreads)
    rg_lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ h_last, Scratch scr, int batch,
                       int steps, int channels, int chunks, int tiles) {
  int k, row, tile;
  ticket_tile(scr, batch, tiles, &k, &row, &tile);
  const int c = tile * kThreads + threadIdx.x;
  const bool live = c < channels;
  const int n = min(kSteps, steps - k * kSteps);  // live steps of the chunk

  // all 2 * kSteps loads before any FMA
  const long long base = ((long long)row * steps + (long long)k * kSteps) *
                             channels + c;
  float av[kSteps], bv[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const bool in = live && i < n;
    av[i] = in ? __ldg(a + base + (long long)i * channels) : 1.f;
    bv[i] = in ? __ldg(b + base + (long long)i * channels) : 0.f;
  }

  // the chunk's aggregate: A = prod a_t, H = scan of the chunk from 0
  float A = av[0], H = bv[0];
#pragma unroll
  for (int i = 1; i < kSteps; ++i) {
    A *= av[i];
    H = fmaf(av[i], H, bv[i]);
  }
  const float* start =  // P_{-1}, when h0 is given
      h0 && live ? h0 + (long long)row * channels + c : nullptr;
  const float carry = chain(scr, row, tile, k, chunks, tiles, channels, c,
                            live, start, A, H);

  // rescan from P_{k-1} and store
  if (!live) return;
  float h = carry;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    h = fmaf(av[i], h, bv[i]);
    if (i < n) y[base + (long long)i * channels] = h;
  }
  if (k == chunks - 1) h_last[(long long)row * channels + c] = h;
}

__global__ void __launch_bounds__(kThreads)
    rg_lru_scan_bwd_kernel(const float* __restrict__ a,
                           const float* __restrict__ y,
                           const float* __restrict__ h0,
                           const float* __restrict__ g,
                           const float* __restrict__ g_last,
                           float* __restrict__ da, float* __restrict__ db,
                           float* __restrict__ dh0, Scratch scr, int batch,
                           int steps, int channels, int chunks, int tiles) {
  int v, row, tile;
  ticket_tile(scr, batch, tiles, &v, &row, &tile);
  const int k = chunks - 1 - v;  // the chunk in time: the last visited first
  const int c = tile * kThreads + threadIdx.x;
  const bool live = c < channels;
  const int t0 = k * kSteps;
  const int n = min(kSteps, steps - t0);  // live steps of the chunk

  // step i is t = t0 + i: av[i] = a_{t+1} (1 from S - 1 on), gv[i] = g_t,
  // hv[i] = h_{t-1} = y_{t-1} (h0 or 0 at t = 0); padded steps a' = 1, g = 0
  const long long col = (long long)row * steps * channels + c;  // t = 0
  const long long base = col + (long long)t0 * channels;
  float av[kSteps], gv[kSteps], hv[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const bool in = live && i < n;
    const long long at = base + (long long)i * channels;
    av[i] = in && t0 + i + 1 < steps ? __ldg(a + at + channels) : 1.f;
    gv[i] = in ? __ldg(g + at) : 0.f;
    hv[i] = in && t0 + i > 0 ? __ldg(y + at - channels) : 0.f;
  }
  const bool first = k == 0 && live;
  if (first && h0) hv[0] = h0[(long long)row * channels + c];
  const float a0 = first && dh0 ? __ldg(a + col) : 0.f;

  // the chunk's aggregate, walked from its last step: A = prod a', H = the
  // walk from 0
  float A = av[kSteps - 1], H = gv[kSteps - 1];
#pragma unroll
  for (int i = kSteps - 2; i >= 0; --i) {
    A *= av[i];
    H = fmaf(av[i], H, gv[i]);
  }
  const float* start =  // P_{-1}: dh_S, when g_last is given
      g_last && live ? g_last + (long long)row * channels + c : nullptr;
  const float carry = chain(scr, row, tile, v, chunks, tiles, channels, c,
                            live, start, A, H);

  // rescan from dh_{t0 + 32} and store
  if (!live) return;
  float d = carry;
#pragma unroll
  for (int i = kSteps - 1; i >= 0; --i) {
    d = fmaf(av[i], d, gv[i]);
    if (i < n) {
      const long long at = base + (long long)i * channels;
      db[at] = d;
      da[at] = d * hv[i];
    }
  }
  if (first && dh0) dh0[(long long)row * channels + c] = a0 * d;
}

struct Sizes {
  int chunks, tiles;
  long long values, flags;  // bytes
};

Sizes sizes_of(int batch, int steps, int channels) {
  Sizes z;
  z.chunks = (steps + kSteps - 1) / kSteps;
  z.tiles = (channels + kThreads - 1) / kThreads;
  z.values = 3LL * batch * z.chunks * channels * (long long)sizeof(float);
  z.flags = ((long long)batch * z.tiles * z.chunks + 1) *
            (long long)sizeof(unsigned);
  return z;
}

// The scratch carved into its parts, the flags zeroed on `stream`, the
// grid's blocks; returns the first cudaError_t that is not 0.
int prepare(void* scratch, int batch, int steps, int channels,
            cudaStream_t s, Scratch* scr, Sizes* z, long long* blocks) {
  if (batch <= 0 || steps <= 0 || channels <= 0)
    return (int)cudaErrorInvalidValue;
  *z = sizes_of(batch, steps, channels);
  *blocks = (long long)batch * z->tiles * z->chunks;
  if (*blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)batch * z->chunks * channels;
  scr->agg_a = static_cast<float*>(scratch);
  scr->agg_h = scr->agg_a + plane;
  scr->prefix = scr->agg_h + plane;
  scr->flags = reinterpret_cast<unsigned*>(scr->prefix + plane);
  scr->ticket = scr->flags + *blocks;
  return (int)cudaMemsetAsync(scr->flags, 0, z->flags, s);
}

int attributes_of(const void* kernel, int* regs, int* local_bytes,
                  int* static_smem, int* dynamic_smem) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return (int)rc;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem = 0;
  return 0;
}

}  // namespace

// The kernel's tile: steps of a chunk and channels of a block.
extern "C" void rg_lru_tile(int* steps, int* channels) {
  *steps = kSteps;
  *channels = kThreads;
}

// Bytes of the scratch one call takes: A, H and P, then the flags and the
// ticket counter (which the launch zeroes).
extern "C" long long rg_lru_scratch_bytes(int batch, int steps,
                                          int channels) {
  const Sizes z = sizes_of(batch, steps, channels);
  return z.values + z.flags;
}

// Zeroes the scratch's flags and launches, on `stream`; returns the first
// cudaError_t that is not 0 (0 = queued). a, b, y (B, S, C) and h0
// (optional, may be null), h_last (B, C): contiguous float32; scratch of
// rg_lru_scratch_bytes, 4-byte aligned, any contents.
extern "C" int rg_lru_scan_fwd(const void* a, const void* b, const void* h0,
                               void* y, void* h_last, void* scratch,
                               int batch, int steps, int channels,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Scratch scr;
  Sizes z;
  long long blocks;
  const int rc = prepare(scratch, batch, steps, channels, s, &scr, &z,
                         &blocks);
  if (rc != 0) return rc;
  rg_lru_scan_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), scr, batch, steps, channels, z.chunks,
      z.tiles);
  return (int)cudaGetLastError();
}

// The backward, on `stream`, as rg_lru_scan_fwd: a, y (the forward's
// output), g (y's cotangent), da, db (B, S, C); h0, g_last (h_last's
// cotangent) and dh0 (B, C), each optional (null), dh0 only with h0:
// contiguous float32; scratch of rg_lru_scratch_bytes, any contents.
extern "C" int rg_lru_scan_bwd(const void* a, const void* y, const void* h0,
                               const void* g, const void* g_last, void* da,
                               void* db, void* dh0, void* scratch, int batch,
                               int steps, int channels, void* stream) {
  if (dh0 && !h0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Scratch scr;
  Sizes z;
  long long blocks;
  const int rc = prepare(scratch, batch, steps, channels, s, &scr, &z,
                         &blocks);
  if (rc != 0) return rc;
  rg_lru_scan_bwd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(y),
      static_cast<const float*>(h0), static_cast<const float*>(g),
      static_cast<const float*>(g_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), scr, batch, steps,
      channels, z.chunks, z.tiles);
  return (int)cudaGetLastError();
}

// Registers and local (spilled) bytes a thread, static and dynamic shared
// memory a block, of the forward kernel and of the backward
// (cudaFuncGetAttributes).
extern "C" int rg_lru_attributes(int* regs, int* local_bytes,
                                 int* static_smem, int* dynamic_smem) {
  return attributes_of(reinterpret_cast<const void*>(rg_lru_scan_kernel),
                       regs, local_bytes, static_smem, dynamic_smem);
}

extern "C" int rg_lru_bwd_attributes(int* regs, int* local_bytes,
                                     int* static_smem, int* dynamic_smem) {
  return attributes_of(reinterpret_cast<const void*>(rg_lru_scan_bwd_kernel),
                       regs, local_bytes, static_smem, dynamic_smem);
}

extern "C" const char* rg_lru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
