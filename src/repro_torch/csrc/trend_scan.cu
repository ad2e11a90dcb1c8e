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
// in parallel and in no order, and one block per row would leave most of
// the 132 SMs idle at the fidelity shapes (S = 6 rows of 87 040), so the
// scan is split into three launches, the pattern of csrc/compact.cu:
//   1. scan_tile_sums: one block per 2048-entry tile sums its counts;
//   2. scan_tile_offsets: one block per row turns the tile sums into
//      exclusive tile offsets (its own warp-shuffle scan), starting from the
//      row's seed;
//   3. scan_tiles: one block per tile re-reads its counts, scans them
//      inside the block and adds the tile's offset.
//
// What bounds it: bytes. Each count is read twice (counted once in the
// bound) and each prefix sum written once, 8 B per entry; the tile arrays
// are N/2048 ints per row. Each thread reads its 8 consecutive counts as
// two 16-byte loads where the row allows it, and writes them the same way.
//
// Exactness: integer adds only. The prefix sums are exact while a row's
// total (seed included) stays below 2^31, which the ops layer checks before
// the launch (the same guard as the reference, ops.py:523-539 and
// :664-669); the adds are done in unsigned arithmetic so nothing here is
// undefined even outside that domain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                    // counts per thread
constexpr int kTile = kThreads * kItems;     // 2048 entries per block
constexpr int kScanThreads = 1024;

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

// This thread's 8 counts (0 past the row end).
__device__ __forceinline__ void load_items(const int* row, long long n,
                                           long long i0, bool vec_ok,
                                           unsigned v[kItems]) {
  if (vec_ok && i0 + kItems <= n) {
    const int4 a = *reinterpret_cast<const int4*>(row + i0);
    const int4 b = *reinterpret_cast<const int4*>(row + i0 + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      v[j] = (i0 + j < n) ? static_cast<unsigned>(row[i0 + j]) : 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_tile_sums(const int* __restrict__ q, int n, int n_tiles, bool vec_ok,
               unsigned* __restrict__ tile_sums) {
  const int r = blockIdx.y;
  const int tile = blockIdx.x;
  const int* row = q + static_cast<size_t>(r) * n;
  const long long i0 =
      static_cast<long long>(tile) * kTile + threadIdx.x * kItems;
  unsigned v[kItems];
  load_items(row, n, i0, vec_ok, v);
  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) c += v[j];
  unsigned total;
  block_exclusive_scan<kThreads>(c, &total);
  if (threadIdx.x == 0)
    tile_sums[static_cast<size_t>(r) * n_tiles + tile] = total;
}

// kCarry = false: each row's running total starts at 0 (B4); kCarry = true:
// it starts at init[r] and row r's final total goes to tail[r] (B7).
template <bool kCarry>
__global__ void __launch_bounds__(kScanThreads)
scan_tile_offsets(const unsigned* __restrict__ tile_sums, int n_tiles,
                  const int* __restrict__ init,
                  unsigned* __restrict__ tile_offsets,
                  int* __restrict__ tail) {
  const int r = blockIdx.x;
  const unsigned* sums = tile_sums + static_cast<size_t>(r) * n_tiles;
  unsigned* off = tile_offsets + static_cast<size_t>(r) * n_tiles;
  unsigned carry = 0u;
  if constexpr (kCarry) carry = static_cast<unsigned>(init[r]);
  for (int base = 0; base < n_tiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const unsigned v = i < n_tiles ? sums[i] : 0u;
    unsigned chunk;
    const unsigned excl = block_exclusive_scan<kScanThreads>(v, &chunk);
    if (i < n_tiles) off[i] = carry + excl;
    carry += chunk;
  }
  if constexpr (kCarry) {
    if (threadIdx.x == 0) tail[r] = static_cast<int>(carry);
  }
}

__global__ void __launch_bounds__(kThreads)
scan_tiles(const int* __restrict__ q, int n, int n_tiles, bool vec_ok,
           const unsigned* __restrict__ tile_offsets,
           int* __restrict__ psum) {
  const int r = blockIdx.y;
  const int tile = blockIdx.x;
  const size_t row_off = static_cast<size_t>(r) * n;
  const long long i0 =
      static_cast<long long>(tile) * kTile + threadIdx.x * kItems;
  unsigned v[kItems];
  load_items(q + row_off, n, i0, vec_ok, v);
  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) c += v[j];
  unsigned total;
  unsigned acc = block_exclusive_scan<kThreads>(c, &total) +
                 tile_offsets[static_cast<size_t>(r) * n_tiles + tile];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    acc += v[j];
    v[j] = acc;                               // inclusive prefix
  }
  int* out = psum + row_off;
  if (vec_ok && i0 + kItems <= n) {
    *reinterpret_cast<int4*>(out + i0) = make_int4(
        static_cast<int>(v[0]), static_cast<int>(v[1]),
        static_cast<int>(v[2]), static_cast<int>(v[3]));
    *reinterpret_cast<int4*>(out + i0 + 4) = make_int4(
        static_cast<int>(v[4]), static_cast<int>(v[5]),
        static_cast<int>(v[6]), static_cast<int>(v[7]));
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (i0 + j < n) out[i0 + j] = static_cast<int>(v[j]);
  }
}

}  // namespace

extern "C" int trend_scan_tile_entries() { return kTile; }

namespace {

template <bool kCarry>
int launch(const void* q, const void* init, int rows, int n,
           void* tile_sums, void* tile_offsets, void* psum, void* tail,
           void* stream) {
  if (rows == 0 || (n == 0 && !kCarry)) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + kTile - 1) / kTile;
  const bool vec_ok = (n % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(psum) % 16 == 0);
  const auto* qi = static_cast<const int*>(q);
  const dim3 grid(n_tiles, rows);
  if (n > 0)
    scan_tile_sums<<<grid, kThreads, 0, st>>>(
        qi, n, n_tiles, vec_ok, static_cast<unsigned*>(tile_sums));
  // B7 runs this phase even for empty rows, so that tail = init is written
  scan_tile_offsets<kCarry><<<rows, kScanThreads, 0, st>>>(
      static_cast<const unsigned*>(tile_sums), n_tiles,
      static_cast<const int*>(init), static_cast<unsigned*>(tile_offsets),
      static_cast<int*>(tail));
  if (n > 0)
    scan_tiles<<<grid, kThreads, 0, st>>>(
        qi, n, n_tiles, vec_ok, static_cast<const unsigned*>(tile_offsets),
        static_cast<int*>(psum));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B4. q, psum (R, N) int32 contiguous; tile_sums, tile_offsets (R, n_tiles)
// int32 scratch with n_tiles = ceil(N / 2048).
extern "C" int trend_scan_launch(const void* q, int rows, int n,
                                 void* tile_sums, void* tile_offsets,
                                 void* psum, void* stream) {
  return launch<false>(q, nullptr, rows, n, tile_sums, tile_offsets, psum,
                       nullptr, stream);
}

// B7. As B4, with row r's running total seeded from init[r] (R,) int32 and
// its final total written to tail[r] (R,) int32.
extern "C" int trend_scan_carry_launch(const void* q, const void* init,
                                       int rows, int n, void* tile_sums,
                                       void* tile_offsets, void* psum,
                                       void* tail, void* stream) {
  return launch<true>(q, init, rows, n, tile_sums, tile_offsets, psum, tail,
                      stream);
}
