// GQA decode attention for Hopper: one new query token per sequence
// against its KV cache, softmax over the first min(lengths[b], S) cache
// positions, accumulated in f32 (split-KV flash-decoding).
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::_kernel
// (flash_decode_pallas). Inputs: q (B, H, D), k and v (B, S, Kh, D), both
// float32 or both bfloat16, lengths (B,) int32, H = Kh * G. Output
// (B, H, D) in q's dtype:
//
//   out[b, h] = sum_s softmax_s(q[b, h] . k[b, s, h / G] / sqrt(D)) v[b, s, h / G]
//
// over s < min(lengths[b], S); a length above S is clamped to S and a row
// of length 0 gives zeros.
//
// The TPU kernel walked the cache axis as the sequential grid axis of one
// program per sequence, carrying the online softmax (m, l, acc) in VMEM
// scratch across 512-position blocks, and read every block of the cache
// whatever the length. On Hopper a sequential axis cannot carry state
// between blocks, and 8 sequences times 8 KV heads would fill half the
// 132 SMs, so the cache axis is split instead:
//
// 1. flash_decode_split: one block per (split, KV head, sequence). It
//    holds the G query rows of its KV head in registers and streams its
//    `chunk` positions through 64-position tiles: each warp computes
//    whole q . k dot products (one cache row per warp, G rows of q, a
//    shuffle tree), then one warp per query row updates the online
//    (m, l) in shared memory and turns the tile's scores into p, then
//    every thread folds p into its (G, one d) slice of acc with the V
//    rows of the tile. It writes the unnormalised partial (m, l, acc) of
//    its split to an f32 workspace. A block whose split starts at or past
//    its row's length returns at once: cache blocks past a row's length
//    are never read.
// 2. flash_decode_combine: one block per (head, sequence) merges the
//    ceil(len / chunk) partials of the row by their maxima and writes the
//    output in q's dtype.
//
// What bounds it: the bytes of K and V below each row's length, read
// once (2 * len * Kh * D * sizeof(T) per row); the arithmetic is 4 flops
// per (head, position, d), far below the f32 rate at these intensities.
// This first version uses no tensor cores, TMA or cp.async pipelining;
// its loads are 4 (bf16) or 2 (f32) per lane per cache row.
//
// Exactness: f32 products and sums (in another order than the plain
// version's), expf without fast math; within 2e-5 of the plain version in
// f32 and within bf16 rounding (5e-2) of it in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // cache positions per shared-memory tile
constexpr int kMaxGroup = 8;    // query heads per KV head

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   int S, int Kh, int G, int chunk, int n_splits, float scale,
                   float* __restrict__ ws_ml, float* __restrict__ ws_acc) {
  constexpr int kPerLane = D / 32;         // q . k elements per lane
  constexpr int kParts = kThreads / D;     // threads sharing one d
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), S);
  const int s0 = split * chunk;
  if (s0 >= len) return;
  const int s1 = min(s0 + chunk, len);
  const int H = Kh * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = threadIdx.x % D, part = threadIdx.x / D;

  __shared__ float sc[kMaxGroup][kTile];   // scores, then p, of one tile
  __shared__ float m_run[kMaxGroup], l_run[kMaxGroup], corr[kMaxGroup];
  __shared__ float red[kParts][kMaxGroup][D];

  float qr[kMaxGroup][kPerLane];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    const T* qg = q + (static_cast<size_t>(b) * H + kh * G + g) * D;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      qr[g][i] = g < G ? to_f32(qg[lane + 32 * i]) : 0.f;
  }
  if (threadIdx.x < kMaxGroup) {
    m_run[threadIdx.x] = -INFINITY;
    l_run[threadIdx.x] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  const size_t row = static_cast<size_t>(Kh) * D;   // between positions
  const T* kb = k + (static_cast<size_t>(b) * S * Kh + kh) * D;
  const T* vb = v + (static_cast<size_t>(b) * S * Kh + kh) * D;
  __syncthreads();

  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int n = min(kTile, s1 - t0);
    // scores: one cache row per warp at a time
    for (int j = warp; j < n; j += kWarps) {
      const T* kr = kb + static_cast<size_t>(t0 + j) * row;
      float kv[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) kv[i] = to_f32(kr[lane + 32 * i]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) s = fmaf(qr[g][i], kv[i], s);
          s = warp_sum(s);
          if (lane == 0) sc[g][j] = s * scale;
        }
      }
    }
    __syncthreads();
    // online softmax bookkeeping: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      const float a = lane < n ? sc[g][lane] : -INFINITY;
      const float c = lane + 32 < n ? sc[g][lane + 32] : -INFINITY;
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
      const float pa = lane < n ? expf(a - m_new) : 0.f;
      const float pc = lane + 32 < n ? expf(c - m_new) : 0.f;
      sc[g][lane] = pa;
      sc[g][lane + 32] = pc;
      const float tile_l = warp_sum(pa + pc);
      __syncwarp();
      if (lane == 0) {
        const float cr = expf(m_old - m_new);
        corr[g] = cr;
        l_run[g] = l_run[g] * cr + tile_l;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g, d] = acc * corr + sum_j p[g, j] v[j, d]
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) acc[g] *= corr[g];
#pragma unroll 4
    for (int j = part; j < n; j += kParts) {
      const float vv = to_f32(vb[static_cast<size_t>(t0 + j) * row + d]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] = fmaf(sc[g][j], vv, acc[g]);
    }
    __syncthreads();
  }

  if (kParts > 1) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) red[part][g][d] = acc[g];
    __syncthreads();
    if (part == 0) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        for (int p = 1; p < kParts; ++p) acc[g] += red[p][g][d];
    }
  }
  if (part == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const size_t slot =
            (static_cast<size_t>(b) * H + kh * G + g) * n_splits + split;
        ws_acc[slot * D + d] = acc[g];
        if (d == 0) {
          ws_ml[2 * slot] = m_run[g];
          ws_ml[2 * slot + 1] = l_run[g];
        }
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_combine(const float* __restrict__ ws_ml,
                     const float* __restrict__ ws_acc,
                     const int* __restrict__ lengths, int S, int H, int chunk,
                     int n_splits, T* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(max(lengths[b], 0), S);
  const int nv = (len + chunk - 1) / chunk;       // splits that ran
  const size_t base = (static_cast<size_t>(b) * H + h) * n_splits;
  float m = -INFINITY;
  for (int j = 0; j < nv; ++j) m = fmaxf(m, ws_ml[2 * (base + j)]);
  float l = 0.f, o = 0.f;
  for (int j = 0; j < nv; ++j) {
    const float w = expf(ws_ml[2 * (base + j)] - m);
    l = fmaf(ws_ml[2 * (base + j) + 1], w, l);
    o = fmaf(ws_acc[(base + j) * D + d], w, o);
  }
  store(out + (static_cast<size_t>(b) * H + h) * D + d, l > 0.f ? o / l : 0.f);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, int B, int S, int Kh, int G,
                   int chunk, int n_splits, float* ws_ml, float* ws_acc,
                   void* out, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_decode_split<T, D><<<dim3(n_splits, Kh, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, S, Kh, G, chunk, n_splits, scale,
      ws_ml, ws_acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine<T, D><<<dim3(Kh * G, B), D, 0, stream>>>(
      ws_ml, ws_acc, lengths, S, Kh * G, chunk, n_splits,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Positions per shared-memory tile: the split size must be a multiple.
int flash_decode_tile() { return kTile; }

// Largest number of query heads per KV head one block holds.
int flash_decode_max_group() { return kMaxGroup; }

// dtype: 0 float32, 1 bfloat16. ws_ml is (B, H, n_splits, 2) f32 and
// ws_acc (B, H, n_splits, D) f32, n_splits = ceil(S / chunk). Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue, without
// launching, for a shape the kernel does not take).
int flash_decode_launch(int dtype, const void* q, const void* k,
                        const void* v, const int* lengths, int B, int S,
                        int Kh, int G, int D, int chunk, int n_splits,
                        void* ws_ml, void* ws_acc, void* out, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Kh < 1 || Kh > 65535 || G < 1 ||
      G > kMaxGroup || chunk < kTile || chunk % kTile != 0 ||
      n_splits != (S + chunk - 1) / chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(ws_ml);
  float* acc = static_cast<float*>(ws_acc);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    err = launch<float, 64>(q, k, v, lengths, B, S, Kh, G, chunk, n_splits,
                            ml, acc, out, st);
  else if (dtype == 0 && D == 128)
    err = launch<float, 128>(q, k, v, lengths, B, S, Kh, G, chunk, n_splits,
                             ml, acc, out, st);
  else if (dtype == 1 && D == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, lengths, B, S, Kh, G, chunk,
                                    n_splits, ml, acc, out, st);
  else if (dtype == 1 && D == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, lengths, B, S, Kh, G, chunk,
                                     n_splits, ml, acc, out, st);
  return static_cast<int>(err);
}

}  // extern "C"
