// All-pairs Pearson sufficient statistics of stacked trend series for
// Hopper: per-row sums and the Gram matrix of an (S, K) float32 matrix.
//
// Replaces the TPU kernel repro/kernels/trend_scan.py::_pair_kernel
// (pair_stats_pallas). It writes sums[a] = x[a, 0] + ... + x[a, K-1] and
// gram[a, b] = gram[b, a] = sum over t of x[a, t] * x[b, t].
//
// The TPU kernel walked the time axis in 512-wide tiles, kept (sums, gram)
// resident in VMEM across the grid and did one x_tile @ x_tile^T on the
// MXU per step. Here one block computes one (a, b) pair with a <= b:
// S (S + 1) / 2 blocks, each thread accumulating a strided slice of the
// dot product in f32 with fused multiply-adds, then a warp-shuffle tree and
// a fixed-order sum of the warp partials. The block writes both G[a, b] and
// G[b, a]; a diagonal block also writes the row sum. No tensor cores and no
// TF32: the product stays in full f32, because the correlations built on it
// must stay within 1e-3 of the float64 host path and TF32's 10-bit
// mantissa puts that at risk.
//
// What bounds it: at the fidelity shapes (S = 6, K <= 4096) nothing but
// launch latency; the matrix is 100 KB. Each input byte is read once per
// pair it belongs to, from L2 after the first touch (an (S, K) matrix of
// 37 x 86 528 floats is 12.8 MB, well inside the 50 MB L2); the bound
// counts it once. The operations are 2 K per pair.
//
// Exactness: f32 sums in another order than the TPU's (or the f64 plain
// version's), within 1e-4 of sqrt(G[a, a] G[b, b]) of the f64 Gram.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
pair_stats_kernel(const float* __restrict__ x, int S, int K, bool vec_ok,
                  float* __restrict__ sums, float* __restrict__ gram) {
  __shared__ float part_g[kWarps];
  __shared__ float part_s[kWarps];
  int p = blockIdx.x, a = 0;               // triangular index -> (a, b)
  while (p >= S - a) {
    p -= S - a;
    ++a;
  }
  const int b = a + p;
  const bool diag = a == b;
  const float* xa = x + static_cast<size_t>(a) * K;
  const float* xb = x + static_cast<size_t>(b) * K;
  float g = 0.f, s = 0.f;
  int k0 = 0;
  if (vec_ok) {
    const int k4 = K / 4;
    const float4* va4 = reinterpret_cast<const float4*>(xa);
    const float4* vb4 = reinterpret_cast<const float4*>(xb);
    for (int i = threadIdx.x; i < k4; i += kThreads) {
      const float4 u = va4[i];
      const float4 v = vb4[i];
      g = fmaf(u.x, v.x, g);
      g = fmaf(u.y, v.y, g);
      g = fmaf(u.z, v.z, g);
      g = fmaf(u.w, v.w, g);
      if (diag) s += (u.x + u.y) + (u.z + u.w);
    }
    k0 = k4 * 4;
  }
  for (int k = k0 + threadIdx.x; k < K; k += kThreads) {
    const float u = xa[k];
    g = fmaf(u, xb[k], g);
    if (diag) s += u;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    g += __shfl_xor_sync(0xffffffffu, g, o);
    s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    part_g[wid] = g;
    part_s[wid] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tg = 0.f, ts = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tg += part_g[w];
      ts += part_s[w];
    }
    gram[static_cast<size_t>(a) * S + b] = tg;
    gram[static_cast<size_t>(b) * S + a] = tg;
    if (diag) sums[a] = ts;
  }
}

}  // namespace

// x (S, K) float32 contiguous; sums (S,) and gram (S, S) float32.
extern "C" int pair_stats_launch(const void* x, int rows, int k, void* sums,
                                 void* gram, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_ok = (k % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const long long pairs = static_cast<long long>(rows) * (rows + 1) / 2;
  pair_stats_kernel<<<static_cast<unsigned>(pairs), kThreads, 0, st>>>(
      static_cast<const float*>(x), rows, k, vec_ok,
      static_cast<float*>(sums), static_cast<float*>(gram));
  return static_cast<int>(cudaGetLastError());
}
