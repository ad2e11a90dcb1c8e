// Batched mask compaction for Hopper: keep mask -> kept-record indices.
//
// Replaces the TPU kernel repro/kernels/compact.py::_kernel_batched
// (compact_positions_batched_pallas, and its 1-D case compact_positions_
// pallas) together with the XLA scatter that followed it
// (repro/kernels/ops.py compact_mask_batched_device). For every row r of an
// (R, N) 0/1 byte mask it writes idx[r, p] = i for the p-th set entry i
// (ascending) and totals[r] = the number of set entries. The caller fills
// idx with the sentinel N beforehand, so idx[r, totals[r]:] stays N.
//
// The TPU kernel walked the record tiles in order and carried the running
// count in SMEM from one grid step to the next. Hopper runs blocks in
// parallel and in no order, and one block per row would leave 131 of 132
// SMs idle at R = 1, so the scan is split into three launches:
//   1. compact_count: one block per 4096-record tile counts its set entries;
//   2. compact_scan_tiles: one block per row turns the tile counts into
//      exclusive tile offsets and the row total (the scan is this kernel's
//      own warp-shuffle code);
//   3. compact_scatter: one block per tile re-reads its mask bytes, scans
//      them inside the block and scatters the kept indices to their slots.
//
// What bounds it: bytes. The mask (1 B/record) is read twice (counted once
// in the bound), the index array (4 B/record) is written once by the
// sentinel fill and once more where a record is kept; the tile-count
// arrays are N/4096 ints. Each thread reads 16 consecutive mask bytes with
// one 16-byte load where the row allows it.
//
// Exactness: integer only; indices and totals are exact while N < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                   // mask bytes per thread
constexpr int kTile = kThreads * kItems;     // 4096 records per block
constexpr int kScanThreads = 1024;

// Exclusive block-wide scan of one int per thread; *total gets the block
// sum. Safe to call repeatedly in a loop (it syncs before returning).
template <int kBlock>
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  static_assert(kBlock % 32 == 0 && kBlock <= 1024, "block size");
  constexpr int kWarps = kBlock / 32;
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;   // inclusive warp prefixes
  }
  __syncthreads();
  const int before = wid > 0 ? warp_sums[wid - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return before + x - v;
}

// This thread's 16 mask bytes (0 past the row end), as 0/1 flags.
__device__ __forceinline__ void load_flags(const unsigned char* row,
                                           long long n, long long i0,
                                           bool vec_ok,
                                           unsigned char flags[kItems]) {
  if (vec_ok && i0 + kItems <= n) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + i0);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      flags[j] = ((w[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      flags[j] = (i0 + j < n) ? (row[i0 + j] != 0) : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_count(const unsigned char* __restrict__ mask, int n, int n_tiles,
              bool vec_ok, int* __restrict__ tile_counts) {
  const int r = blockIdx.y;
  const int tile = blockIdx.x;
  const unsigned char* row = mask + static_cast<size_t>(r) * n;
  const long long i0 =
      static_cast<long long>(tile) * kTile + threadIdx.x * kItems;
  unsigned char f[kItems];
  load_flags(row, n, i0, vec_ok, f);
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) c += f[j];
  int total;
  block_exclusive_scan<kThreads>(c, &total);
  if (threadIdx.x == 0)
    tile_counts[static_cast<size_t>(r) * n_tiles + tile] = total;
}

__global__ void __launch_bounds__(kScanThreads)
compact_scan_tiles(const int* __restrict__ tile_counts, int n_tiles,
                   int* __restrict__ tile_offsets, int* __restrict__ totals) {
  const int r = blockIdx.x;
  const int* cnt = tile_counts + static_cast<size_t>(r) * n_tiles;
  int* off = tile_offsets + static_cast<size_t>(r) * n_tiles;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n_tiles ? cnt[i] : 0;
    int chunk;
    const int excl = block_exclusive_scan<kScanThreads>(v, &chunk);
    if (i < n_tiles) off[i] = carry + excl;
    carry += chunk;
  }
  if (threadIdx.x == 0) totals[r] = carry;
}

__global__ void __launch_bounds__(kThreads)
compact_scatter(const unsigned char* __restrict__ mask, int n, int n_tiles,
                bool vec_ok, const int* __restrict__ tile_offsets,
                int* __restrict__ idx) {
  const int r = blockIdx.y;
  const int tile = blockIdx.x;
  const unsigned char* row = mask + static_cast<size_t>(r) * n;
  const long long i0 =
      static_cast<long long>(tile) * kTile + threadIdx.x * kItems;
  unsigned char f[kItems];
  load_flags(row, n, i0, vec_ok, f);
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) c += f[j];
  int total;
  int pos = block_exclusive_scan<kThreads>(c, &total) +
            tile_offsets[static_cast<size_t>(r) * n_tiles + tile];
  int* out = idx + static_cast<size_t>(r) * n;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (f[j]) out[pos++] = static_cast<int>(i0 + j);
  }
}

}  // namespace

extern "C" int compact_tile_records() { return kTile; }

// mask (R, N) uint8, contiguous; tile_counts, tile_offsets (R, n_tiles)
// int32 scratch with n_tiles = ceil(N / 4096); idx (R, N) int32 already
// filled with N; totals (R,) int32.
extern "C" int compact_launch(const void* mask, int rows, int n,
                              void* tile_counts, void* tile_offsets,
                              void* idx, void* totals, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + kTile - 1) / kTile;
  const bool vec_ok =
      (n % 16 == 0) && (reinterpret_cast<uintptr_t>(mask) % 16 == 0);
  const auto* m = static_cast<const unsigned char*>(mask);
  if (n_tiles > 0) {
    const dim3 grid(n_tiles, rows);
    compact_count<<<grid, kThreads, 0, st>>>(m, n, n_tiles, vec_ok,
                                             static_cast<int*>(tile_counts));
  }
  compact_scan_tiles<<<rows, kScanThreads, 0, st>>>(
      static_cast<const int*>(tile_counts), n_tiles,
      static_cast<int*>(tile_offsets), static_cast<int*>(totals));
  if (n_tiles > 0) {
    const dim3 grid(n_tiles, rows);
    compact_scatter<<<grid, kThreads, 0, st>>>(
        m, n, n_tiles, vec_ok, static_cast<const int*>(tile_offsets),
        static_cast<int*>(idx));
  }
  return static_cast<int>(cudaGetLastError());
}
