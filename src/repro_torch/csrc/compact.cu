// Batched mask compaction for Hopper: keep mask -> kept-record indices, in
// one launch with the sentinel fill folded in.
//
// Replaces the TPU kernel repro/kernels/compact.py::_kernel_batched
// (compact_positions_batched_pallas, and its 1-D case compact_positions_
// pallas) together with the XLA scatter that followed it
// (repro/kernels/ops.py compact_mask_batched_device). For every row r of an
// (R, N) 0/1 byte mask it writes idx[r, p] = i for the p-th set entry i
// (ascending), idx[r, p] = N for p >= totals[r], and totals[r] = the
// number of set entries.
//
// The TPU kernel walked the record tiles in order and carried the running
// count in SMEM from one grid step to the next. Hopper runs blocks in
// parallel and in no order, so the count crosses blocks through device
// memory, in a single pass with decoupled look-back (csrc/lookback.cuh,
// shared with B4/B7). A persistent grid, as many blocks as fit on the card
// at once, works in two phases:
//   1. Scan. Each block draws tickets from an atomic counter, row-major
//      over the rows' tiles, until none is left. For a tile it loads its
//      mask bytes once (16-byte loads, all issued before the first byte is
//      tested), scans the per-thread counts in registers and shared
//      memory, stages the tile's kept offsets in shared memory in order
//      (16 bits each), publishes the tile's aggregate, looks back with the
//      whole block (256 preceding tiles a round) for its exclusive offset,
//      publishes its inclusive prefix and copies the staged indices to idx
//      as one contiguous run. The row's last tile writes totals[r].
//   2. Fill. A block that finds no ticket left takes every G-th tile-sized
//      span of idx (G the grid size), waits for its row's total (the last
//      tile's inclusive prefix) and writes N over the span's part of
//      [totals[r], N) with 16-byte stores.
// No block ever waits on one that is not running: a look-back waits on
// tiles of its row with lower tickets, and a fill starts only once every
// ticket has been drawn, so every tile it waits on is held by a running
// block. This holds whatever the grid size; the grid is sized to what is
// resident so that no block waits for a slot. Each block draws until it
// gets a ticket past the last tile, so a call makes exactly tiles + G
// draws, and the block that draws the last one resets the counter for the
// next call on the stream. The status words carry the call's epoch, so
// they need no clearing between calls.
//
// Tile size, chosen at launch from the shape: 16384 records (64 mask bytes
// a thread, four 16-byte loads in flight) when the call has at least one
// such tile per SM, else 4096 (16 bytes a thread), so that a small call
// (one row of a nine-day chunk, ~2 M records) still spreads over the card.
// A library built with -DREPRO_RECORD_TILE (the tile tuner's record_tile,
// kernels/tuning.py: 4096, 8192 or 16384) holds that one tile size and
// launches it at every shape.
//
// What bounds it: bytes. Each mask byte is read once and each idx slot
// written once (by its kept record or by the fill), 5 B per record, the
// traffic the bound counts; the status words add 8 B per tile. The first
// port took four device operations (the caller's sentinel fill, a count
// pass, a per-row tile scan, a scatter that read the mask again); this is
// one. The fill, 4 of the 5 B at the main paths' keep rates, can start
// only once every ticket is drawn and its row's total is known, so at one
// row (the run and chunk shapes) the scan's latency (ticket, load, the
// look-back chain) adds to the fill's streaming time instead of hiding
// under it.
//
// Exactness: integer only; indices and totals are exact while N < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "lookback.cuh"

namespace {

using namespace lookback;

constexpr int kThreads = 256;
#ifdef REPRO_RECORD_TILE                     // one instance
constexpr int kSmallVecs = REPRO_RECORD_TILE / (kThreads * 16);
constexpr int kLargeVecs = kSmallVecs;
static_assert(kThreads * 16 * kSmallVecs == REPRO_RECORD_TILE &&
                  kSmallVecs >= 1 && kSmallVecs <= 4,
              "a tile of 4096, 8192, 12288 or 16384 records");
#else                                        // both, chosen from the shape
constexpr int kSmallVecs = 1;                // 16-byte mask loads a thread
constexpr int kLargeVecs = 4;
#endif
constexpr int kSmallTile = kThreads * 16 * kSmallVecs;   // 4096 records
constexpr int kLargeTile = kThreads * 16 * kLargeVecs;   // 16384 records

// This thread's 16 * kVecs mask bytes from i0 (0 past the row end) as a
// bit mask, bit k for record i0 + k; every load is issued before the first
// byte is tested.
template <int kVecs>
__device__ __forceinline__ unsigned long long load_bits(
    const unsigned char* row, long long n, long long i0, bool vec_ok) {
  constexpr int kItems = 16 * kVecs;
  static_assert(kItems <= 64, "one 64-bit mask a thread");
  unsigned long long bits = 0ull;
  if (vec_ok && i0 + kItems <= n) {
    uint4 u[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      u[v] = *reinterpret_cast<const uint4*>(row + i0 + 16 * v);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const uint32_t w[4] = {u[v].x, u[v].y, u[v].z, u[v].w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if ((w[j >> 2] >> (8 * (j & 3))) & 0xffu)
          bits |= 1ull << (16 * v + j);
    }
  } else {
    unsigned char b[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) b[k] = i0 + k < n ? row[i0 + k] : 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (b[k]) bits |= 1ull << k;
  }
  return bits;
}

// out[lo, hi) = value, by the whole block; 16-byte stores where out is
// 16-byte aligned at a multiple of 4 (vec_ok).
__device__ __forceinline__ void fill(int* out, long long lo, long long hi,
                                     int value, bool vec_ok) {
  if (lo >= hi) return;
  long long a = lo, b = lo;
  if (vec_ok) {
    a = min((lo + 3) & ~3LL, hi);
    b = a + ((hi - a) & ~3LL);
    const int4 v4 = make_int4(value, value, value, value);
    for (long long p = a + 4LL * threadIdx.x; p < b; p += 4LL * kThreads)
      *reinterpret_cast<int4*>(out + p) = v4;
  }
  for (long long p = lo + threadIdx.x; p < a; p += kThreads) out[p] = value;
  for (long long p = b + threadIdx.x; p < hi; p += kThreads) out[p] = value;
}

template <int kVecs>
__global__ void __launch_bounds__(kThreads)
compact_lookback(const unsigned char* __restrict__ mask, int rows, int n,
                 int n_tiles, bool vec_in, bool vec_out, unsigned epoch,
                 unsigned long long* __restrict__ status,
                 unsigned* __restrict__ counter, int* __restrict__ idx,
                 int* __restrict__ totals) {
  constexpr int kItems = 16 * kVecs;
  constexpr int kTile = kThreads * kItems;
  static_assert(kTile <= 65536, "16-bit staged offsets");
  const unsigned n_work = static_cast<unsigned>(rows) * n_tiles;
  __shared__ unsigned short s_off[kTile];   // the tile's kept offsets
  __shared__ unsigned s_ticket, s_value;

  // phase 1: scan tiles until no ticket is left
  for (;;) {
    if (threadIdx.x == 0) {
      const unsigned t = atomicAdd(counter, 1u);
      if (t == n_work + gridDim.x - 1u)
        atomicExch(counter, 0u);       // the last draw of this call
      s_ticket = t;
    }
    __syncthreads();
    const unsigned t = s_ticket;
    if (t >= n_work) break;            // the same for the whole block
    const int r = static_cast<int>(t / n_tiles);
    const int j = static_cast<int>(t % n_tiles);
    const long long base = static_cast<long long>(j) * kTile;
    const int local = threadIdx.x * kItems;   // this thread's first record
    unsigned long long bits = load_bits<kVecs>(
        mask + static_cast<size_t>(r) * n, n, base + local, vec_in);
    unsigned total;
    unsigned pos = block_exclusive_scan<kThreads>(__popcll(bits), &total);
    while (bits) {                     // stage the kept offsets in order
      s_off[pos++] = static_cast<unsigned short>(local + __ffsll(bits) - 1);
      bits &= bits - 1;
    }

    unsigned long long* row_status =
        status + static_cast<size_t>(r) * n_tiles;
    unsigned prefix = 0u;
    if (j > 0) {
      if (threadIdx.x == 0) publish(row_status + j, epoch, kAggregate,
                                    total);
      prefix = block_look_back<kThreads>(row_status, j, epoch);
    }
    if (threadIdx.x == 0) {
      publish(row_status + j, epoch, kInclusive, prefix + total);
      if (j == n_tiles - 1) totals[r] = static_cast<int>(prefix + total);
    }
    __syncthreads();                   // s_off is complete
    int* out = idx + static_cast<size_t>(r) * n + prefix;
    for (unsigned q = threadIdx.x; q < total; q += kThreads)
      out[q] = static_cast<int>(base + s_off[q]);
    __syncthreads();                   // s_off and s_ticket are reused
  }

  // phase 2: every ticket is drawn; fill [total_r, N) span by span
  for (unsigned w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int r = static_cast<int>(w / n_tiles);
    const int j = static_cast<int>(w % n_tiles);
    if (threadIdx.x == 0)
      s_value = wait_inclusive(
          status + static_cast<size_t>(r) * n_tiles + n_tiles - 1, epoch);
    __syncthreads();
    const long long lo = static_cast<long long>(j) * kTile;
    fill(idx + static_cast<size_t>(r) * n,
         max(lo, static_cast<long long>(s_value)),
         min(lo + kTile, static_cast<long long>(n)), n, vec_out);
    __syncthreads();                   // s_value is reused
  }
}

// N = 0: every row's total is 0 and idx is empty.
__global__ void zero_totals(int rows, int* __restrict__ totals) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < rows) totals[r] = 0;
}

struct Card {
  int sms = 0, resident_small = 0, resident_large = 0;
};

constexpr int kMaxDevices = 64;

// The current device's SM count and how many blocks of each instance fit
// on it at once, asked once per device and kept only when every query
// succeeded; filled under a lock, so two host threads never race on it.
// Returns the first failed query's code (the caller returns it to the
// wrapper, which raises), never a card with no resident blocks.
cudaError_t card(Card* out) {
  static Card cards[kMaxDevices];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  Card& c = cards[dev];
  if (c.sms == 0) {
    int small = 0, large = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &small, compact_lookback<kSmallVecs>, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &large, compact_lookback<kLargeVecs>, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (small < 1 || large < 1 || sms < 1)
      return cudaErrorInvalidConfiguration;
    c.resident_small = small * sms;
    c.resident_large = large * sms;
    c.sms = sms;
  }
  *out = c;
  return cudaSuccess;
}

template <int kVecs>
int launch(const unsigned char* mask, int rows, int n, int resident,
           unsigned epoch, void* status, void* counter, void* idx,
           void* totals, cudaStream_t st) {
  constexpr int kTile = kThreads * 16 * kVecs;
  const int n_tiles = (n + kTile - 1) / kTile;
  const long long work = static_cast<long long>(rows) * n_tiles;
  const int grid = static_cast<int>(work < resident ? work : resident);
  const bool vec_in =
      (n % 16 == 0) && (reinterpret_cast<uintptr_t>(mask) % 16 == 0);
  const bool vec_out =
      (n % 4 == 0) && (reinterpret_cast<uintptr_t>(idx) % 16 == 0);
  compact_lookback<kVecs><<<grid > 0 ? grid : 1, kThreads, 0, st>>>(
      mask, rows, n, n_tiles, vec_in, vec_out, epoch,
      static_cast<unsigned long long*>(status),
      static_cast<unsigned*>(counter), static_cast<int*>(idx),
      static_cast<int*>(totals));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Records per small tile: the status array holds one 8-byte word per
// small tile, which is enough for either tile size.
int compact_tile_records() { return kSmallTile; }

// Records per large tile (the one tile of a single-instance library).
int compact_large_tile_records() { return kLargeTile; }

// Largest epoch a call may pass (epochs run 1 .. this, then the caller
// clears the status array once and starts again at 1).
unsigned compact_max_epoch() { return kEpochMask; }

// mask (R, N) uint8 contiguous; status (R, ceil(N / tile_records)) words
// and counter (one unsigned) from a per-stream workspace, zeroed when it
// was allocated; epoch this call's number, 1 .. max_epoch, other than the
// previous call's on this workspace; idx (R, N) int32 and totals (R,)
// int32, written whole.
int compact_launch(const void* mask, int rows, int n, void* status,
                   void* counter, unsigned epoch, void* idx, void* totals,
                   void* stream) {
  if (rows == 0) return 0;
  if (epoch == 0u || epoch > kEpochMask)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    zero_totals<<<(rows + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        rows, static_cast<int*>(totals));
    return static_cast<int>(cudaGetLastError());
  }
  Card c;
  const cudaError_t err = card(&c);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* m = static_cast<const unsigned char*>(mask);
  const long long large_tiles =
      static_cast<long long>(rows) * ((n + kLargeTile - 1) / kLargeTile);
  if (kSmallVecs == kLargeVecs || large_tiles >= c.sms)
    return launch<kLargeVecs>(m, rows, n, c.resident_large, epoch, status,
                              counter, idx, totals, st);
  return launch<kSmallVecs>(m, rows, n, c.resident_small, epoch, status,
                            counter, idx, totals, st);
}

}  // extern "C"
