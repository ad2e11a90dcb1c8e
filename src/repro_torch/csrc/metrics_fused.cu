// Fused batched stream metrics for Hopper: per-row histogram of scale
// stamps plus its moments [sum q, sum q^2], whole (B3) or one time chunk at
// a time with a carried moment state (B6), in one launch per call.
//
// Replaces two TPU kernels of repro/kernels/metrics_fused.py:
//   - _kernel (stream_metrics_pallas), entry metrics_launch (B3);
//   - _kernel_carry (stream_metrics_carry_pallas), entry
//     metrics_carry_launch (B6): the same histogram over one chunk's
//     stamps, rebased by the chunk's first bucket, and a moment fold seeded
//     from a per-row Kahan state [s1, c1, s2, c2] that it writes back
//     updated.
// For row s of an (S, N) int32 stamp matrix, record i counts iff
// i < lengths[s] and 0 <= ss - base < buckets, in bucket ss - base (base is
// 0 for B3; the TPU kernels' padding id >= buckets is ignored the same way,
// and the guard also keeps the atomics in bounds).
//
// B3's time form, entry metrics_time_launch, counts original streams where
// their float64 timestamps already lie on the device (B1's buffer of
// sources, kernels/stream_sample.py): row s reads lengths[s] records from
// t + first[s] and counts record i in bucket
// min(max(floor(t[i] - t0[s]), 0), tr[s] - 1), as the host's
// streamsim/metrics.py _bucket_series does with t0 = t[0]. The bucket is
// computed in registers in f64 (a subtraction and a floor, which round as
// the host's do; NaN counts in bucket 0, as its int cast and clip put it),
// clamped in f64 before the int conversion, which so cannot overflow. A
// sorted row gives sorted buckets, so the runs and tiles below work as on
// sorted stamps; everything after the loads is B3's. Records are read 16
// bytes (two) a load.
//
// The TPU kernel zeroed its VMEM-resident histogram at the first grid step
// and reduced it to moments at the last, in order. Here the histogram lives
// in device memory (the caller allocates it uninitialised) and blocks run
// in no order, so one launch does all of it; each block first draws a
// ticket from a counter, and the ticket says what it does:
//   1. Spans (the first rows * spans tickets). Zero one span, kSpan buckets
//      of one row's histogram, and publish its word, stamped with the
//      call's epoch.
//   2. Tile groups (the next rows * groups tickets). Group g of a row
//      counts its tiles g, g + groups, g + 2 groups, ... of kTile records
//      (at most `group` of them, kItems records a thread in 16-byte loads
//      where the row allows, the next tile's loads issued before the
//      current one is counted) below lengths[s], so that a row's counted
//      prefix spreads over as many blocks as it has tiles. It first notes
//      which of the row's first 32 spans are zeroed already, while its
//      first stamps are in flight. A tile finds the range [lo, hi] of
//      buckets it touches;
//      if that fits in kSmemBins it counts into shared memory (each thread
//      merges its runs of equal stamps, one shared atomic a run; sorted
//      stamps make one or two runs a thread) and adds the non-zero bins to
//      the global histogram, else it adds straight to device memory
//      (unsorted input stays exact, only slower). Before its first add it
//      waits for the words of the spans [lo, hi] covers, unless the block
//      already saw them zeroed. `group` is chosen at launch from the
//      shape and the card's resident blocks.
//   3. The fold. Every span and every tile group within the row's length
//      takes the row's count ticket after a __threadfence(). Where a row
//      has at most kPieceBlocks blocks of kBucketBlock buckets (512 by
//      default), the block that takes the last one computes the partials
//      and folds them. Else the last tickets of the launch are pieces,
//      kPieceBlocks blocks of a row each: a piece waits until the row's
//      count ticket is full, computes
//      its partials, writes them to the workspace and takes the row's
//      piece ticket; the last piece folds them all. (One block reading
//      the original stream's 346 KB histogram is held to one SM's share
//      of the L2 bandwidth; 11 pieces read it in one round trip each.)
//   A partial is the f32 sums of q and q^2 over one block, read
//   through L2 (__ldcg), a per-lane running sum over j * 32 + lane, then
//   the xor butterfly, one warp a block; thread 0 folds the partials in
//   block order with Kahan compensation, as
//   repro/kernels/metrics_fused.py:118-132 does on the TPU, writes the
//   moments and resets the row's counters for the next call. B6's fold
//   starts from the carry, B3's from zeros; the order of every addition is
//   the first port's two-launch kernel's, so the moments are bit-equal to
//   it and B6 with a zero carry is B3 bit for bit.
// No block ever waits on one that is not running: a tile waits only for
// spans and a piece only for spans and tile groups, all of which hold
// lower tickets, so each was drawn by a block that is running (or done);
// spans wait on nothing and tile groups only on spans. This holds whatever
// the grid's residency. The span words carry the call's epoch (unreadable
// to any later call), the last draw resets the ticket counter and the fold
// the row's counters, so the per-stream workspace needs no memset between
// calls.
//
// What bounds it: bytes. Each counted stamp is read once (4 B/record, 8 B
// in the time form), the histogram written by its zeroing and the atomics
// and read once more for the partials (4 B/bucket each), small beside the
// stamps for the original stream. At the chunked paths' shapes (a few
// hundred ns of bytes) the launch and the chain of dependent round trips
// (ticket, lengths, stamps, span word, atomics, count ticket, partials)
// bound it; the first port spent three device operations there (fill,
// histogram, moments).
//
// Exactness: counts are exact int32 (the host wrapper refuses more than
// 2^31 - 1 records). Moments are f32 with a summation order other than the
// TPU's, within 1e-5 relative of f64.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#include "lookback.cuh"

namespace {

using lookback::kEpochMask;
using lookback::peek;

// The tile tuner's record_tile and bucket_block (kernels/tuning.py), built
// into their own library with -DREPRO_RECORD_TILE and -DREPRO_BUCKET_BLOCK;
// 4096 and 512 by default.
#ifndef REPRO_RECORD_TILE
#define REPRO_RECORD_TILE 4096
#endif
#ifndef REPRO_BUCKET_BLOCK
#define REPRO_BUCKET_BLOCK 512
#endif
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = REPRO_RECORD_TILE;        // records per tile
constexpr int kItems = kTile / kThreads;        // stamps per thread
constexpr int kSmemBins = 4096;                 // privatised range, 16 KB
constexpr int kSpan = kThreads * 16;            // buckets zeroed per span
constexpr int kBucketBlock = REPRO_BUCKET_BLOCK;  // moment partial width
static_assert(kItems * kThreads == kTile && kItems % 4 == 0,
              "whole 16-byte loads a thread");
static_assert(kBucketBlock % 32 == 0 && kSpan % 4 == 0,
              "a warp's lanes over a partial; 16-byte span zeroing");
constexpr int kPieceBlocks = 2 * kWarps;        // partials a block computes
constexpr int kFoldMax = 256;                   // partials folded at once
constexpr int kMinBlocks = 4;                   // resident blocks an SM
constexpr int kMaxGroup = 16;                   // most tiles a block takes

// The kernel's three forms: B3 on int32 stamps, B6 (stamps, carried
// moments) and B3's time form (float64 timestamps, bucketed in registers).
enum Form { kStamps, kCarry, kTime };

// The time form's rows: row s reads its records from t + first[s], with
// base t0[s] and series length tr[s] (buckets 0 .. tr[s] - 1; a length
// below 1 reads as 1).
struct TimeRows {
  const double* t;
  const long long* first;
  const double* t0;
  const int* tr;
};

// ---------------------------------------------------------- helpers
// A span's word is a look-back status word (lookback.cuh): published as
// "inclusive" with this call's epoch once the span is zeroed.
__device__ __forceinline__ bool zeroed(const unsigned long long* word,
                                       unsigned epoch) {
  return lookback::flag_of(peek(word), epoch) == lookback::kInclusive;
}

__device__ __forceinline__ unsigned peek32(const unsigned* word) {
  unsigned w;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(w) : "l"(word) : "memory");
  return w;
}

// Wait, by one warp, until spans [z0, z1] of the row are zeroed (each
// held by a block with a lower ticket, which zeroes it without waiting on
// anything). Ends with a __syncwarp().
__device__ __forceinline__ void wait_zeroed(
    const unsigned long long* row_words, int z0, int z1, unsigned epoch) {
  for (int z = z0 + (threadIdx.x & 31); z <= z1; z += 32)
    while (!zeroed(row_words + z, epoch)) {
    }
  __threadfence();                     // acquire what they zeroed
  __syncwarp();
}

// Add a thread's stamps (bucket or -1) to bins, one atomic per run of
// equal stamps.
__device__ __forceinline__ void add_runs(int* bins, const int (&v)[kItems]) {
  int key = -1, count = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (v[j] != key) {
      if (key >= 0) atomicAdd(bins + key, count);
      key = v[j];
      count = 0;
    }
    ++count;
  }
  if (key >= 0) atomicAdd(bins + key, count);
}

// ---------------------------------------------------------- counting
// This thread's kItems stamps of the given tile, rebased unsigned (a stamp
// below base wraps past buckets and is ignored like one at or above
// base + buckets); past the length every bit is set.
__device__ __forceinline__ void load_tile(const int* __restrict__ row,
                                          long long tile, int len, int n,
                                          int base, bool vec_ok,
                                          unsigned (&r)[kItems]) {
  const long long i0 = tile * kTile + threadIdx.x * kItems;
  const unsigned ub = static_cast<unsigned>(base);
  if (vec_ok && i0 + kItems <= n) {
    int4 u[kItems / 4];
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k)
      u[k] = __ldg(reinterpret_cast<const int4*>(row + i0) + k);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      r[4 * k] = static_cast<unsigned>(u[k].x) - ub;
      r[4 * k + 1] = static_cast<unsigned>(u[k].y) - ub;
      r[4 * k + 2] = static_cast<unsigned>(u[k].z) - ub;
      r[4 * k + 3] = static_cast<unsigned>(u[k].w) - ub;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (i0 + j >= len) r[j] = 0xffffffffu;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      r[j] = i0 + j < len ? static_cast<unsigned>(__ldg(row + i0 + j)) - ub
                          : 0xffffffffu;
  }
}

// The bucket of timestamp t in a row with base t0 and last bucket top:
// min(max(floor(t - t0), 0), top), in f64, so the conversion is in range.
__device__ __forceinline__ unsigned time_bucket(double t, double t0,
                                                double top) {
  const double d = floor(__dsub_rn(t, t0));
  return static_cast<unsigned>(d >= 0.0 ? fmin(d, top) : 0.0);
}

// A row of int32 stamps (B3, B6): load_tile over it.
struct StampRow {
  const int* row;
  int n, base;
  bool vec_ok;

  __device__ __forceinline__ void load(long long tile, int len,
                                       unsigned (&r)[kItems]) const {
    load_tile(row, tile, len, n, base, vec_ok, r);
  }
};

// A row of float64 timestamps (the time form): this thread's kItems
// records of the tile as buckets, two records a 16-byte load where the
// row's start allows; past the length every bit is set.
struct TimeRow {
  const double* row;
  double t0, top;
  bool vec_ok;

  __device__ __forceinline__ void load(long long tile, int len,
                                       unsigned (&r)[kItems]) const {
    const long long i0 = tile * kTile + threadIdx.x * kItems;
    if (vec_ok && i0 + kItems <= len) {
      double2 u[kItems / 2];
#pragma unroll
      for (int k = 0; k < kItems / 2; ++k)
        u[k] = __ldg(reinterpret_cast<const double2*>(row + i0) + k);
#pragma unroll
      for (int k = 0; k < kItems / 2; ++k) {
        r[2 * k] = time_bucket(u[k].x, t0, top);
        r[2 * k + 1] = time_bucket(u[k].y, t0, top);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        r[j] = i0 + j < len ? time_bucket(__ldg(row + i0 + j), t0, top)
                            : 0xffffffffu;
    }
  }
};

// Row s's reader in form F.
template <Form F>
__device__ __forceinline__ auto row_reader(const int* ss, const TimeRows& tr,
                                           int s, int n, int base,
                                           bool vec_ok) {
  if constexpr (F == kTime) {
    const double* row = tr.t + __ldg(tr.first + s);
    return TimeRow{row, __ldg(tr.t0 + s),
                   static_cast<double>(max(__ldg(tr.tr + s), 1) - 1),
                   reinterpret_cast<uintptr_t>(row) % 16 == 0};
  } else {
    return StampRow{ss + static_cast<size_t>(s) * n, n, base, vec_ok};
  }
}

// Spans [a, b] (0 <= a <= b <= 31) as bits of a mask.
__device__ __forceinline__ unsigned span_bits(int a, int b) {
  return ((2u << b) - 1u) & ~((1u << a) - 1u);
}

// One tile's loaded stamps counted into the row's histogram h. bins
// (kSmemBins) and red (2 * kWarps) are this tile's shared buffers, which
// the block used last two tiles ago; known has a bit for each of the row's
// first 32 spans the block already saw zeroed (a span past them is waited
// for every time), set here.
__device__ __forceinline__ void count_tile(
    const unsigned (&r)[kItems], int buckets, unsigned epoch,
    const unsigned long long* row_words, int* h, int* bins, int* red,
    unsigned& known) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int v[kItems];                       // bucket, or -1 when not counted
  int lo = buckets, hi = -1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    v[j] = r[j] < static_cast<unsigned>(buckets) ? static_cast<int>(r[j])
                                                 : -1;
    if (v[j] >= 0) {
      lo = min(lo, v[j]);
      hi = max(hi, v[j]);
    }
  }
#pragma unroll
  for (int k = 0; k < kSmemBins / (4 * kThreads); ++k)
    reinterpret_cast<int4*>(bins)[k * kThreads + threadIdx.x] =
        make_int4(0, 0, 0, 0);
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    red[wid] = lo;
    red[kWarps + wid] = hi;
  }
  __syncthreads();
  lo = buckets;
  hi = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, red[kWarps + w]);
  }
  if (hi < lo) return;                 // no countable stamp in the tile
  const int range = hi - lo + 1;
  const int z0 = lo / kSpan, z1 = hi / kSpan;
  const bool seen = z1 < 32 && (known & span_bits(z0, z1)) ==
                                   span_bits(z0, z1);
  if (!seen && z0 < 32) known |= span_bits(z0, min(z1, 31));
  if (range <= kSmemBins) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = v[j] >= 0 ? v[j] - lo : -1;
    add_runs(bins, v);
    if (!seen && wid == 0) wait_zeroed(row_words, z0, z1, epoch);
    __syncthreads();
    for (int b = threadIdx.x; b < range; b += kThreads) {
      const int c = bins[b];
      if (c) atomicAdd(h + lo + b, c);
    }
  } else {
    if (!seen) {
      if (wid == 0) wait_zeroed(row_words, z0, z1, epoch);
      __syncthreads();
    }
    add_runs(h, v);
  }
}

// ---------------------------------------------------------- moments
// Partials of kBucketBlock-bucket blocks [b0, b1) (at most kPieceBlocks)
// of the row's histogram h, read through L2, into p1[b - b0] and
// p2[b - b0]: a per-lane running sum over j * 32 + lane, then the xor
// butterfly, one warp a block. Ends with a __syncthreads().
__device__ void block_partials(const int* h, int b0, int b1, float* p1,
                               float* p2) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int q[2][kBucketBlock / 32];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int blk = b0 + u * kWarps + wid;
    if (blk < b1) {
      const int* hb = h + static_cast<size_t>(blk) * kBucketBlock;
#pragma unroll
      for (int j = 0; j < kBucketBlock / 32; ++j)
        q[u][j] = __ldcg(hb + j * 32 + lane);
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int blk = b0 + u * kWarps + wid;
    if (blk < b1) {                    // the same for the whole warp
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int j = 0; j < kBucketBlock / 32; ++j) {
        const float x = static_cast<float>(q[u][j]);
        a = __fadd_rn(a, x);
        b = __fadd_rn(b, __fmul_rn(x, x));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
        b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
      }
      if (lane == 0) {
        p1[blk - b0] = a;
        p2[blk - b0] = b;
      }
    }
  }
  __syncthreads();
}

// The Kahan fold of m partials, in block order (thread 0).
struct Kahan {
  float s1 = 0.f, c1 = 0.f, s2 = 0.f, c2 = 0.f;

  __device__ void add(const float* p1, const float* p2, int m) {
    for (int w = 0; w < m; ++w) {
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
};

template <Form F>
__device__ __forceinline__ Kahan start_state(const float* mcar, int s) {
  Kahan k;
  if constexpr (F == kCarry) {
    k.s1 = mcar[4 * s];
    k.c1 = mcar[4 * s + 1];
    k.s2 = mcar[4 * s + 2];
    k.c2 = mcar[4 * s + 3];
  }
  return k;
}

template <Form F>
__device__ __forceinline__ void write_moments(const Kahan& k, int s,
                                              float* mom) {
  if constexpr (F == kCarry) {
    mom[4 * s] = k.s1;
    mom[4 * s + 1] = k.c1;
    mom[4 * s + 2] = k.s2;
    mom[4 * s + 3] = k.c2;
  } else {
    mom[2 * s] = k.s1;
    mom[2 * s + 1] = k.s2;
  }
}

// ---------------------------------------------------------- the kernel
struct Shape {
  int n, buckets, base;
  int n_spans;                         // spans of kSpan buckets a row
  int group;                           // most tiles a block takes
  int n_groups;                        // tile groups a row
  int n_pieces;                        // partial pieces a row (0: none)
  bool vec_ok;
};

// Tile groups of a row that hold tiles within its length: group g takes
// tiles g, g + n_groups, g + 2 n_groups, ... below ceil(length / kTile),
// so a row's counted prefix spreads over as many groups as it has tiles.
__device__ __forceinline__ long long active_groups(int length,
                                                   const Shape& sh) {
  const int len = max(0, min(length, sh.n));
  return min(static_cast<long long>(sh.n_groups),
             (static_cast<long long>(len) + kTile - 1) / kTile);
}

// kStamps and kTime: the fold starts from zeros and writes [s1, s2] (B3);
// kCarry: it starts from mcar[s] = [s1, c1, s2, c2] and writes the updated
// 4-state (B6). kTime reads the rows' records through tr, the others
// through ss. Everything else is one code path.
template <Form F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
metrics_fused(const int* __restrict__ ss, TimeRows tr,
              const int* __restrict__ lengths, Shape sh, int rows,
              unsigned epoch,
              unsigned long long* __restrict__ words,
              unsigned* __restrict__ counters, int* __restrict__ hist,
              const float* __restrict__ mcar, float* __restrict__ mom) {
  __shared__ __align__(16) int bins[2][kSmemBins];
  __shared__ int red[2][2 * kWarps];
  __shared__ float p1[kFoldMax], p2[kFoldMax];
  __shared__ unsigned s_ticket, s_known;
  __shared__ bool s_last;
  const unsigned spans_end = static_cast<unsigned>(rows) * sh.n_spans;
  const unsigned groups_end =
      spans_end + static_cast<unsigned>(rows) * sh.n_groups;
  const unsigned n_work =
      groups_end + static_cast<unsigned>(rows) * sh.n_pieces;
  unsigned* ticket_counter = counters;
  unsigned* count_done = counters + 1;            // a row each
  unsigned* piece_done = counters + 1 + rows;     // a row each
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket_counter, 1u);
    if (t == n_work - 1u) atomicExch(ticket_counter, 0u);   // the last draw
    s_ticket = t;
  }
  __syncthreads();
  const unsigned t = s_ticket;

  int s;                               // the ticket's row
  unsigned long long* row_words;
  int* h;
  float2* partials = reinterpret_cast<float2*>(
      words + static_cast<size_t>(rows) * sh.n_spans);

  if (t >= groups_end) {
    // ---- a piece: partials of kPieceBlocks blocks, once the row is counted
    const unsigned u = t - groups_end;
    s = static_cast<int>(u / sh.n_pieces);
    const int piece = static_cast<int>(u % sh.n_pieces);
    h = hist + static_cast<size_t>(s) * sh.buckets;
    const unsigned parts = static_cast<unsigned>(
        sh.n_spans + active_groups(__ldg(lengths + s), sh));
    if (threadIdx.x == 0) {            // every part holds a lower ticket
      while (peek32(count_done + s) != parts) {
      }
      __threadfence();
    }
    __syncthreads();
    const int n_blocks = sh.buckets / kBucketBlock;
    const int b0 = piece * kPieceBlocks;
    const int b1 = min(n_blocks, b0 + kPieceBlocks);
    block_partials(h, b0, b1, p1, p2);
    float2* row_partials = partials + static_cast<size_t>(s) * n_blocks;
    if (threadIdx.x < b1 - b0)
      row_partials[b0 + threadIdx.x] = make_float2(p1[threadIdx.x],
                                                   p2[threadIdx.x]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned prev = atomicAdd(piece_done + s, 1u);
      s_last = prev == static_cast<unsigned>(sh.n_pieces) - 1u;
      if (s_last) {                    // ready for the next call
        atomicExch(piece_done + s, 0u);
        atomicExch(count_done + s, 0u);
      }
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // the row's last piece folds every partial, in block order
    Kahan k = start_state<F>(mcar, s);
    for (int c0 = 0; c0 < n_blocks; c0 += kFoldMax) {
      const int m = min(kFoldMax, n_blocks - c0);
      if (threadIdx.x < m) {
        const float2 p = __ldcg(row_partials + c0 + threadIdx.x);
        p1[threadIdx.x] = p.x;
        p2[threadIdx.x] = p.y;
      }
      __syncthreads();
      if (threadIdx.x == 0) k.add(p1, p2, m);
      __syncthreads();
    }
    if (threadIdx.x == 0) write_moments<F>(k, s, mom);
    return;
  }

  long long groups;                    // tile groups within the row's length
  if (t < spans_end) {
    // ---- a span: zero it and publish it
    s = static_cast<int>(t / sh.n_spans);
    const int z = static_cast<int>(t % sh.n_spans);
    h = hist + static_cast<size_t>(s) * sh.buckets;
    row_words = words + static_cast<size_t>(s) * sh.n_spans;
    const int lo = z * kSpan, hi = min(lo + kSpan, sh.buckets);
    for (int b = lo + 4 * threadIdx.x; b < hi; b += 4 * kThreads)
      *reinterpret_cast<int4*>(h + b) = make_int4(0, 0, 0, 0);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      lookback::publish(row_words + z, epoch, lookback::kInclusive, 0u);
    groups = active_groups(__ldg(lengths + s), sh);
  } else {
    // ---- a tile group: count its tiles
    const unsigned u = t - spans_end;
    s = static_cast<int>(u / sh.n_groups);
    const long long g = u % sh.n_groups;
    h = hist + static_cast<size_t>(s) * sh.buckets;
    row_words = words + static_cast<size_t>(s) * sh.n_spans;
    const int len = max(0, min(__ldg(lengths + s), sh.n));
    groups = active_groups(len, sh);
    if (g >= groups) return;           // past the row's length: no part
    const auto row = row_reader<F>(ss, tr, s, sh.n, sh.base, sh.vec_ok);
    const long long tiles = (static_cast<long long>(len) + kTile - 1) / kTile;
    long long tile = g;                // then every n_groups-th tile
    unsigned cur[kItems];
    row.load(tile, len, cur);
    // the spans already zeroed, seen while the first stamps are in flight
    if (threadIdx.x < 32) {
      const unsigned mask = __ballot_sync(
          0xffffffffu, static_cast<int>(threadIdx.x) < sh.n_spans &&
                           zeroed(row_words + threadIdx.x, epoch));
      __threadfence();                 // acquire what they zeroed
      if (threadIdx.x == 0) s_known = mask;
    }
    __syncthreads();
    unsigned known = s_known;
    for (int k = 0; tile < tiles; tile += sh.n_groups, ++k) {
      unsigned next[kItems];           // the next tile's loads in flight
      if (tile + sh.n_groups < tiles) row.load(tile + sh.n_groups, len, next);
      count_tile(cur, sh.buckets, epoch, row_words, h, bins[k & 1],
                 red[k & 1], known);
#pragma unroll
      for (int j = 0; j < kItems; ++j) cur[j] = next[j];
    }
  }

  // the row's count-done ticket: the parts are its spans and tile groups
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned parts = static_cast<unsigned>(sh.n_spans + groups);
    const unsigned prev = atomicAdd(count_done + s, 1u);
    s_last = prev == parts - 1u;
    if (s_last && sh.n_pieces == 0)
      atomicExch(count_done + s, 0u);  // ready for the next call
  }
  __syncthreads();
  if (!s_last || sh.n_pieces > 0) return;   // pieces take it from here
  __threadfence();
  // few blocks: the last part computes the partials and folds them
  block_partials(h, 0, sh.buckets / kBucketBlock, p1, p2);
  if (threadIdx.x == 0) {
    Kahan k = start_state<F>(mcar, s);
    k.add(p1, p2, sh.buckets / kBucketBlock);
    write_moments<F>(k, s, mom);
  }
}

struct Card {
  int sms = 0, resident = 0;
};

constexpr int kMaxDevices = 64;

// The current device's SM count and how many blocks of the kernel fit on
// it at once (the fewest of the three forms), asked once per device and
// kept only when every query succeeded; filled under a lock, so two host
// threads never race on it. Returns the first failed query's code (the
// caller returns it to the wrapper, which raises), never a card with no
// resident blocks.
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
    int plain = 0, carry = 0, timed = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &plain, metrics_fused<kStamps>, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &carry, metrics_fused<kCarry>, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &timed, metrics_fused<kTime>, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (plain < 1 || carry < 1 || timed < 1 || sms < 1)
      return cudaErrorInvalidConfiguration;
    c.resident = std::min({plain, carry, timed}) * sms;
    c.sms = sms;
  }
  *out = c;
  return cudaSuccess;
}

template <Form F>
int launch(const void* ss, const TimeRows& tr, const void* lengths, int base,
           int rows, int n, int buckets, void* words, void* counters,
           unsigned epoch, void* hist, const void* mcar, void* mom,
           void* stream) {
  if (rows == 0) return 0;
  if (rows > 65535 || n < 0 || buckets <= 0 || buckets % kBucketBlock != 0 ||
      epoch == 0u || epoch > kEpochMask ||
      reinterpret_cast<uintptr_t>(hist) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Card c;
  const cudaError_t err = card(&c);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape sh;
  sh.n = n;
  sh.buckets = buckets;
  sh.base = base;
  sh.n_spans = (buckets + kSpan - 1) / kSpan;
  const long long n_tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  // most tiles a block takes: enough that the call's tiles fill four
  // waves of resident blocks, at most kMaxGroup (the rows' lengths, which
  // decide how many tiles count, are on the device)
  sh.group = static_cast<int>(std::max(
      1LL, std::min(static_cast<long long>(kMaxGroup),
                    (n_tiles * rows + 4LL * c.resident - 1) /
                        (4LL * c.resident))));
  sh.n_groups = static_cast<int>((n_tiles + sh.group - 1) / sh.group);
  const int n_blocks = buckets / kBucketBlock;
  sh.n_pieces = n_blocks <= kPieceBlocks
                    ? 0 : (n_blocks + kPieceBlocks - 1) / kPieceBlocks;
  // the stamp forms' rows start 16-byte aligned when n and ss allow; a
  // time row checks its own start
  sh.vec_ok = n % 4 == 0 && reinterpret_cast<uintptr_t>(ss) % 16 == 0;
  const long long n_work = static_cast<long long>(rows) *
                           (sh.n_spans + sh.n_groups + sh.n_pieces);
  if (n_work >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  metrics_fused<F><<<static_cast<unsigned>(n_work), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ss), tr, static_cast<const int*>(lengths), sh,
      rows, epoch, static_cast<unsigned long long*>(words),
      static_cast<unsigned*>(counters), static_cast<int*>(hist),
      static_cast<const float*>(mcar), static_cast<float*>(mom));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Buckets per zeroed span and per moment partial: the workspace holds one
// 8-byte word per span and one per partial of each row.
int metrics_span_buckets() { return kSpan; }
int metrics_bucket_block() { return kBucketBlock; }

// Records a tile holds in this library (its REPRO_RECORD_TILE).
int metrics_record_tile() { return kTile; }

// Largest epoch a call may pass (epochs run 1 .. this, then the caller
// clears the span words once and starts again at 1).
unsigned metrics_max_epoch() { return kEpochMask; }

// B3. ss (S, N) int32 contiguous; lengths (S,) int32; words: S *
// (ceil(buckets / span_buckets) + buckets / bucket_block) 8-byte words, and
// counters: 1 + 2 S unsigned, from a per-stream workspace, zeroed when
// allocated;
// epoch this call's number, 1 .. max_epoch, other than the previous
// call's on this workspace; hist (S, buckets) int32, 16-byte aligned,
// no initial value needed, buckets % bucket_block == 0; mom (S, 2) f32.
int metrics_launch(const void* ss, const void* lengths, int rows, int n,
                   int buckets, void* words, void* counters, unsigned epoch,
                   void* hist, void* mom, void* stream) {
  return launch<kStamps>(ss, TimeRows{}, lengths, 0, rows, n, buckets, words,
                         counters, epoch, hist, nullptr, mom, stream);
}

// B6. As B3, with stamps counted in bucket ss - base, the moment fold seeded
// from mcar (S, 4) f32 and the updated state written to mom (S, 4) f32.
int metrics_carry_launch(const void* ss, const void* lengths, int base,
                         int rows, int n, int buckets, void* words,
                         void* counters, unsigned epoch, void* hist,
                         const void* mcar, void* mom, void* stream) {
  return launch<kCarry>(ss, TimeRows{}, lengths, base, rows, n, buckets, words,
                        counters, epoch, hist, mcar, mom, stream);
}

// B3's time form. t float64, the rows' records end to end (16-byte aligned
// where a row's 16-byte loads are to be used); first (S,) int64 each row's
// first record in t; t0 (S,) float64 each row's base; tr (S,) int32 each
// row's series length, 1 .. buckets; lengths (S,) int32 its records; n the
// largest length; the rest as B3's.
int metrics_time_launch(const void* t, const void* first, const void* t0,
                        const void* tr, const void* lengths, int rows, int n,
                        int buckets, void* words, void* counters,
                        unsigned epoch, void* hist, void* mom, void* stream) {
  const TimeRows rows_in{static_cast<const double*>(t),
                         static_cast<const long long*>(first),
                         static_cast<const double*>(t0),
                         static_cast<const int*>(tr)};
  return launch<kTime>(nullptr, rows_in, lengths, 0, rows, n, buckets, words,
                       counters, epoch, hist, nullptr, mom, stream);
}

}  // extern "C"
