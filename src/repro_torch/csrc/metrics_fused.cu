// Fused batched stream metrics for Hopper: per-row histogram of scale
// stamps plus its moments [sum q, sum q^2].
//
// Replaces the TPU kernel repro/kernels/metrics_fused.py::_kernel
// (stream_metrics_pallas). For row s of an (S, N) int32 stamp matrix,
// record i counts iff i < lengths[s] and 0 <= ss < buckets (the TPU
// kernel's padding id >= buckets is ignored the same way; the guard also
// keeps the atomics in bounds). Two launches:
//   1. metrics_hist: one block per 2048-record tile. The block finds the
//      stamp range it touches; if that fits in shared memory (always, for
//      the sorted stamps of the main path) it counts into a privatised
//      shared histogram over just that range and then adds the non-zero
//      bins to the global int32 histogram, else it adds straight to global
//      memory (unsorted input stays correct, only slower). Within a warp,
//      lanes holding the same stamp are merged first (__match_any_sync), so
//      sorted runs cost one atomic per distinct stamp per warp.
//   2. metrics_moments: one block per row. Each 512-bucket block of the
//      histogram is reduced to f32 partials of q and q^2 by one warp; the
//      partials are folded in block order with Kahan compensation, as
//      repro/kernels/metrics_fused.py:118-132 does on the TPU.
//
// What bounds it: bytes. Each stamp is read once (4 B/record); the
// histogram is written by atomics and read once more for the moments
// (4 B/bucket each way), small beside the stamps for the original stream
// and below launch latency for the compressed one. Shared-memory
// privatisation keeps the atomics off device memory: a 2048-record tile of
// a sorted day touches ~17 buckets at 86 528 buckets. A full privatised
// histogram would not fit (86 528 x 4 B = 346 KB > 227 KB of shared memory).
//
// Exactness: counts are exact int32 (the host wrapper refuses more than
// 2^31 - 1 records). Moments are f32 with a summation order other than the
// TPU's, within 1e-5 relative of f64.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                       // stamps per thread
constexpr int kTile = kThreads * kItems;        // 2048 records per block
constexpr int kSmemBins = 4096;                 // privatised range, 16 KB
constexpr int kBucketBlock = 512;               // moment partial width
constexpr int kMomentThreads = 1024;

__device__ __forceinline__ void add_aggregated(int* base, int key,
                                               bool valid) {
  // lanes with the same key add once, with the group's size; every lane
  // of the (full, converged) warp calls this, valid or not
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? key : -1);
  const int leader = __ffs(peers) - 1;
  if (valid && (threadIdx.x & 31) == leader) atomicAdd(base + key,
                                                       __popc(peers));
}

__global__ void __launch_bounds__(kThreads)
metrics_hist(const int* __restrict__ ss, const int* __restrict__ lengths,
             int n, int buckets, int* __restrict__ hist) {
  __shared__ int bins[kSmemBins];
  __shared__ int red_lo[kThreads / 32];
  __shared__ int red_hi[kThreads / 32];
  const int s = blockIdx.y;
  const int len = min(__ldg(lengths + s), n);
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  if (base >= len) return;
  const int* row = ss + static_cast<size_t>(s) * n;
  int* h = hist + static_cast<size_t>(s) * buckets;

  // strided: a warp's lanes hold 32 consecutive records per item
  int v[kItems];
  bool ok[kItems];
  int lo = buckets, hi = -1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    v[j] = i < len ? row[i] : -1;
    ok[j] = i < len && v[j] >= 0 && v[j] < buckets;
    if (ok[j]) {
      lo = min(lo, v[j]);
      hi = max(hi, v[j]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    red_lo[wid] = lo;
    red_hi[wid] = hi;
  }
  __syncthreads();
  lo = buckets;
  hi = -1;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    lo = min(lo, red_lo[w]);
    hi = max(hi, red_hi[w]);
  }
  if (hi < lo) return;                   // no countable stamp in the tile
  const int range = hi - lo + 1;

  if (range <= kSmemBins) {
    for (int b = threadIdx.x; b < range; b += kThreads) bins[b] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) add_aggregated(bins, v[j] - lo, ok[j]);
    __syncthreads();
    for (int b = threadIdx.x; b < range; b += kThreads) {
      const int c = bins[b];
      if (c) atomicAdd(h + lo + b, c);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) add_aggregated(h, v[j], ok[j]);
  }
}

__global__ void __launch_bounds__(kMomentThreads)
metrics_moments(const int* __restrict__ hist, int buckets,
                float* __restrict__ mom) {
  constexpr int kWarps = kMomentThreads / 32;
  __shared__ float p1[kWarps];
  __shared__ float p2[kWarps];
  const int s = blockIdx.x;
  const int* h = hist + static_cast<size_t>(s) * buckets;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_blocks = buckets / kBucketBlock;
  float s1 = 0.f, c1 = 0.f, s2 = 0.f, c2 = 0.f;  // used by thread 0 only
  for (int round = 0; round < n_blocks; round += kWarps) {
    const int blk = round + wid;
    float a = 0.f, b = 0.f;
    if (blk < n_blocks) {
      const int* hb = h + static_cast<size_t>(blk) * kBucketBlock;
#pragma unroll
      for (int j = 0; j < kBucketBlock / 32; ++j) {
        const float q = static_cast<float>(hb[j * 32 + lane]);
        a = __fadd_rn(a, q);
        b = __fadd_rn(b, __fmul_rn(q, q));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
        b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
      }
    }
    if (lane == 0) {
      p1[wid] = a;
      p2[wid] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int m = min(kWarps, n_blocks - round);
      for (int w = 0; w < m; ++w) {   // Kahan fold, in bucket-block order
        const float y1 = __fsub_rn(p1[w], c1);
        const float t1 = __fadd_rn(s1, y1);
        c1 = __fsub_rn(__fsub_rn(t1, s1), y1);
        s1 = t1;
        const float y2 = __fsub_rn(p2[w], c2);
        const float t2 = __fadd_rn(s2, y2);
        c2 = __fsub_rn(__fsub_rn(t2, s2), y2);
        s2 = t2;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    mom[2 * s] = s1;
    mom[2 * s + 1] = s2;
  }
}

}  // namespace

// ss (S, N) int32 contiguous; lengths (S,) int32; hist (S, buckets) int32
// zero-filled by the caller, buckets % 512 == 0; mom (S, 2) f32.
extern "C" int metrics_launch(const void* ss, const void* lengths, int rows,
                              int n, int buckets, void* hist, void* mom,
                              void* stream) {
  if (rows == 0) return 0;
  if (buckets % kBucketBlock != 0) return static_cast<int>(
      cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const dim3 grid((n + kTile - 1) / kTile, rows);
    metrics_hist<<<grid, kThreads, 0, st>>>(
        static_cast<const int*>(ss), static_cast<const int*>(lengths), n,
        buckets, static_cast<int*>(hist));
  }
  metrics_moments<<<rows, kMomentThreads, 0, st>>>(
      static_cast<const int*>(hist), buckets, static_cast<float*>(mom));
  return static_cast<int>(cudaGetLastError());
}
