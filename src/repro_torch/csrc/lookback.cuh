// Pieces of the single-pass scan with decoupled look-back (Merrill &
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016) that the look-back kernels share: the block-wide scan, the
// epoch-stamped 64-bit status words and the block's walk back over them.
// Included by trend_scan.cu (B4, B7), compact.cu (B2) and metrics_fused.cu
// (B3, B6, whose span words are status words); kernels/_build.py hashes
// every header of csrc/ into each library's name, so an edit here rebuilds
// all three.
//
// A status word is 64 bits: the call's epoch (30 bits), the flag (2) and
// the 32-bit unsigned value, written and read whole, so a word from an
// earlier call (another epoch) reads as not yet published and the status
// array needs no clearing between calls.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lookback {

constexpr unsigned kAggregate = 1u;          // status flags
constexpr unsigned kInclusive = 2u;
constexpr unsigned kEpochMask = (1u << 30) - 1u;

// Exclusive block-wide scan of one value per thread; *total gets the block
// sum. Safe to call repeatedly in a loop (it syncs before returning).
template <int kBlock>
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* total) {
  static_assert(kBlock % 32 == 0 && kBlock <= 1024, "block size");
  constexpr int kWarps = kBlock / 32;
  __shared__ unsigned warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    unsigned w = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;   // inclusive warp prefixes
  }
  __syncthreads();
  const unsigned before = wid > 0 ? warp_sums[wid - 1] : 0u;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned epoch, unsigned flag,
                                        unsigned value) {
  const unsigned long long w = (static_cast<unsigned long long>(epoch) << 34) |
                               (static_cast<unsigned long long>(flag) << 32) |
                               value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w) : "l"(word) : "memory");
  return w;
}

// The flag of a status word, 0 when it was written by another call.
__device__ __forceinline__ unsigned flag_of(unsigned long long w,
                                            unsigned epoch) {
  return static_cast<unsigned>(w >> 34) == epoch
             ? static_cast<unsigned>(w >> 32) & 3u : 0u;
}

// The exclusive prefix of tile j > 0 of a row, called by the whole block:
// it sums the published aggregates of tiles j-1, j-2, ... down to the
// nearest inclusive prefix, one thread per preceding tile, kBlock tiles a
// round (a warp's walk, 32 a round, idles the rest of a waiting block and
// needs kBlock / 32 times the rounds).
template <int kBlock>
__device__ __forceinline__ unsigned block_look_back(
    const unsigned long long* row_status, int j, unsigned epoch) {
  constexpr int kWarps = kBlock / 32;
  __shared__ int s_stop;
  __shared__ unsigned s_part[kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  unsigned prefix = 0u;
  for (int k = j - 1;; k -= kBlock) {
    const int idx = k - static_cast<int>(threadIdx.x);  // 0: the nearest
    unsigned long long w = 0ull;
    unsigned flag = kInclusive;        // threads before tile 0 never count
    if (threadIdx.x == 0) s_stop = kBlock;
    int pending;
    do {
      if (idx >= 0) {
        w = peek(row_status + idx);
        flag = flag_of(w, epoch);
      }
      pending = __syncthreads_or(flag == 0u);
    } while (pending);
    if (flag == kInclusive && idx >= 0)
      atomicMin(&s_stop, static_cast<int>(threadIdx.x));
    __syncthreads();
    const int stop = s_stop;
    unsigned v = (static_cast<int>(threadIdx.x) <= stop && idx >= 0)
                     ? static_cast<unsigned>(w) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) s_part[wid] = v;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kWarps; ++i) prefix += s_part[i];
    __syncthreads();                   // s_stop and s_part are reused
    if (stop < kBlock) return prefix;
  }
}

// Wait until the status word holds an inclusive prefix of this call and
// return it (one thread).
__device__ __forceinline__ unsigned wait_inclusive(
    const unsigned long long* word, unsigned epoch) {
  unsigned long long w;
  do {
    w = peek(word);
  } while (flag_of(w, epoch) != kInclusive);
  return static_cast<unsigned>(w);
}

}  // namespace lookback
