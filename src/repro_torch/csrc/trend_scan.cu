// Batched inclusive prefix sum of per-second count series for Hopper,
// whole (B4) or one time chunk at a time with a carried total (B7).
//
// Replaces two TPU kernels of repro/kernels/trend_scan.py:
//   - _scan_kernel (trend_scan_pallas), entry trend_scan_launch (B4): for
//     every row s of an (S, N) int32 count matrix it writes
//     psum[s, i] = q[s, 0] + ... + q[s, i], the carry starting at 0 in each
//     row;
//   - _scan_kernel_carry (trend_scan_carry_pallas), entry
//     trend_scan_carry_launch (B7): the same, the carry starting at init[s]
//     instead, and the row's final total written to tail[s], the init of
//     the next chunk. Only the seed and the tail differ from B4 (one
//     template), so B7 with init = 0 is B4 bit for bit.
// The ops layer turns the prefix sums into the sliding-mean trend with two
// gathers and a divide.
//
// The TPU kernels walked each row's time tiles in order and carried the
// running total in SMEM from one grid step to the next. Hopper runs blocks
// in parallel and in no order, so the carry crosses blocks through device
// memory instead, in one launch: a single-pass scan with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016).
//   - Each block draws the next tile of kTile entries (2048 unless the
//     library was built with another -DREPRO_RECORD_TILE, the tile
//     tuner's record_tile, kernels/tuning.py), row-major over the rows'
//     tiles, from an atomic counter, so every tile it waits on belongs to
//     a block that is already running.
//   - It scans its tile in registers and shared memory and publishes the
//     tile's total as an AGGREGATE status word; tile 0 of a row publishes
//     its INCLUSIVE prefix (the seed plus its total) at once.
//   - The whole block then walks back over the row's preceding tiles 256
//     at a time (block_look_back, as B2 does), summing aggregates until it
//     meets an inclusive prefix, and publishes its own inclusive prefix.
//     A warp's walk, 32 tiles a round, needs eight times the rounds over
//     a long chain (296 tiles on the week row) while seven warps idle.
//   - The row's last tile writes tail[r] (B7).
// The status words carry the call's epoch, so the status array needs no
// clearing between calls (csrc/lookback.cuh, shared with B2). The block
// that draws the last ticket resets the counter for the next call on the
// stream. An empty chunk (N = 0) still writes tail = init, in the same
// single launch.
//
// What bounds it: at the main-path shapes (one 659-entry row; 6 rows of
// 87 040) launch latency, which one launch instead of three divides by
// three; at large N bytes: each count read once and each prefix sum
// written once, 8 B per entry, with 16-byte loads and stores where the
// row allows it. The look-back reads one 8-byte word per preceding tile,
// most of them already inclusive.
//
// Exactness: integer adds only. The prefix sums are exact while a row's
// total (seed included) stays below 2^31, which the ops layer checks before
// the launch (the same guard as the reference, ops.py:523-539 and
// :664-669); the adds are done in unsigned arithmetic so nothing here is
// undefined even outside that domain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

using namespace lookback;

#ifndef REPRO_RECORD_TILE
#define REPRO_RECORD_TILE 2048
#endif
constexpr int kThreads = 256;
constexpr int kTile = REPRO_RECORD_TILE;     // entries per block
constexpr int kItems = kTile / kThreads;     // counts per thread
static_assert(kItems * kThreads == kTile && kItems % 4 == 0,
              "whole 16-byte loads a thread");

// This thread's kItems counts (0 past the row end).
__device__ __forceinline__ void load_items(const int* row, long long n,
                                           long long i0, bool vec_ok,
                                           unsigned v[kItems]) {
  if (vec_ok && i0 + kItems <= n) {
    int4 u[kItems / 4];
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k)
      u[k] = *reinterpret_cast<const int4*>(row + i0 + 4 * k);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      v[4 * k] = u[k].x;
      v[4 * k + 1] = u[k].y;
      v[4 * k + 2] = u[k].z;
      v[4 * k + 3] = u[k].w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      v[j] = (i0 + j < n) ? static_cast<unsigned>(row[i0 + j]) : 0u;
  }
}

// kCarry = false: each row's running total starts at 0 (B4); kCarry = true:
// it starts at init[r] and row r's final total goes to tail[r] (B7).
template <bool kCarry>
__global__ void __launch_bounds__(kThreads)
scan_lookback(const int* __restrict__ q, const int* __restrict__ init,
              int rows, int n, int n_tiles, bool vec_ok, unsigned epoch,
              unsigned long long* __restrict__ status,
              unsigned* __restrict__ counter, int* __restrict__ psum,
              int* __restrict__ tail) {
  if (n == 0) {                        // B7 on an empty chunk: tail = init
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (kCarry && r < rows) tail[r] = init[r];
    return;
  }
  __shared__ unsigned s_tile;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(counter, 1u);
    if (t == static_cast<unsigned>(rows) * n_tiles - 1u)
      atomicExch(counter, 0u);         // the last ticket of this call
    s_tile = t;
  }
  __syncthreads();
  const unsigned t = s_tile;
  const int r = static_cast<int>(t / n_tiles);
  const int j = static_cast<int>(t % n_tiles);
  const size_t row_off = static_cast<size_t>(r) * n;
  const long long i0 = static_cast<long long>(j) * kTile + threadIdx.x * kItems;
  unsigned v[kItems];
  load_items(q + row_off, n, i0, vec_ok, v);
  unsigned c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) c += v[i];
  unsigned total;
  const unsigned excl = block_exclusive_scan<kThreads>(c, &total);

  unsigned long long* row_status = status + static_cast<size_t>(r) * n_tiles;
  unsigned prefix = 0u;                // the same in every thread
  if (j == 0) {
    if constexpr (kCarry) prefix = static_cast<unsigned>(init[r]);
    if (threadIdx.x == 0 && n_tiles > 1)
      publish(row_status, epoch, kInclusive, prefix + total);
  } else {
    if (threadIdx.x == 0) publish(row_status + j, epoch, kAggregate, total);
    prefix = block_look_back<kThreads>(row_status, j, epoch);
    if (threadIdx.x == 0 && j + 1 < n_tiles)
      publish(row_status + j, epoch, kInclusive, prefix + total);
  }
  if (kCarry && threadIdx.x == 0 && j == n_tiles - 1)
    tail[r] = static_cast<int>(prefix + total);

  unsigned acc = prefix + excl;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    acc += v[i];
    v[i] = acc;                        // inclusive prefix
  }
  int* out = psum + row_off;
  if (vec_ok && i0 + kItems <= n) {
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k)
      *reinterpret_cast<int4*>(out + i0 + 4 * k) = make_int4(
          static_cast<int>(v[4 * k]), static_cast<int>(v[4 * k + 1]),
          static_cast<int>(v[4 * k + 2]), static_cast<int>(v[4 * k + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (i0 + i < n) out[i0 + i] = static_cast<int>(v[i]);
  }
}

template <bool kCarry>
int launch(const void* q, const void* init, int rows, int n, void* status,
           void* counter, unsigned epoch, void* psum, void* tail,
           void* stream) {
  if (rows == 0 || (n == 0 && !kCarry)) return 0;
  if (epoch == 0u || epoch > kEpochMask)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + kTile - 1) / kTile;
  const bool vec_ok = (n % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(psum) % 16 == 0);
  const unsigned blocks = n > 0
      ? static_cast<unsigned>(rows) * n_tiles
      : static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  scan_lookback<kCarry><<<blocks, kThreads, 0, st>>>(
      static_cast<const int*>(q), static_cast<const int*>(init), rows, n,
      n_tiles, vec_ok, epoch, static_cast<unsigned long long*>(status),
      static_cast<unsigned*>(counter), static_cast<int*>(psum),
      static_cast<int*>(tail));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Entries per tile: the status array holds one 8-byte word per tile.
int trend_scan_tile_entries() { return kTile; }

// Largest epoch a call may pass (epochs run 1 .. this, then the caller
// clears the status array once and starts again at 1).
unsigned trend_scan_max_epoch() { return kEpochMask; }

// B4. q, psum (R, N) int32 contiguous; status (R, ceil(N / tile_entries))
// 8-byte words and counter (one unsigned) from a per-stream workspace, zeroed
// when it was allocated; epoch this call's number, 1 .. max_epoch, other
// than the previous call's on this workspace.
int trend_scan_launch(const void* q, int rows, int n, void* status,
                      void* counter, unsigned epoch, void* psum,
                      void* stream) {
  return launch<false>(q, nullptr, rows, n, status, counter, epoch, psum,
                       nullptr, stream);
}

// B7. As B4, with row r's running total seeded from init[r] (R,) int32 and
// its final total written to tail[r] (R,) int32.
int trend_scan_carry_launch(const void* q, const void* init, int rows, int n,
                            void* status, void* counter, unsigned epoch,
                            void* psum, void* tail, void* stream) {
  return launch<true>(q, init, rows, n, status, counter, epoch, psum, tail,
                      stream);
}

}  // extern "C"
