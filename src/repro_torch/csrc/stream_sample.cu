// Fused, batched NSA inner loop for Hopper: rebase -> normalize -> scale
// stamp -> systematic keep bit, eight records per thread.
//
// Replaces the TPU kernel repro/kernels/stream_sample.py::_kernel
// (stream_sample_pallas). Same contract, record for record:
//   t32  = f32(t - t_min)              f64 subtraction, rounded to f32
//   g    = floor(t32 * inv_span * n_buckets)   f32, rounded per op
//   g    = clip(g, 0, n_buckets - 1)
//   g   += (i >= starts[g] + counts[g]) - (i < starts[g])   (+-1 snap to the
//          exact f64 host tables, so stamps are bit-identical to numpy NSA)
//   ss   = clip(g, 0, n_buckets - 1)
//   keep = (rank * k) % max(c, 1) < k,  rank = i - starts[ss]   (int32)
// and keep = 0 for i >= lengths[s] (padded lanes; the TPU path masked them
// after the kernel). ss is written for every lane.
//
// Inputs: the rows' float64 sources lie end to end in one buffer t; row s
// reads its records from t + base[s] and rebases them by its own t_min.
// Rows of one stream share one copy (a sweep's rows of one dataset), and a
// chunk of a stream is a record offset into it. Lanes at or past a row's
// length read the row's last record, as the reference's rows padded with
// their last timestamp do, so ss on those lanes is the reference's too.
// f32(t - t_min) in float64 then rounded to nearest is numpy's
// (t64 - t_min).astype(np.float32), which the host did before.
//
// What bounds it: bytes. Per record it reads one 8-byte timestamp and
// writes one int32 stamp and one byte of keep bit; the three per-row tables
// (3 x max_range x 4 B, 43 KB at max_range 3600) stay in L1 and L2 and are
// read through the read-only cache (__ldg). To run at the card's 3.35 TB/s
// with ~0.7 us of memory latency, Little's law wants ~2.3 MB in flight,
// ~18 KB per SM. The design:
//   - each thread takes 8 consecutive records (consecutive threads take
//     consecutive groups, so a warp's accesses stay contiguous) and issues
//     its four 16-byte loads of t (a group that starts on an odd record:
//     one 8-byte load, three 16-byte loads, one 8-byte load) before the
//     first table lookup: 64 B in flight per thread;
//   - the grid is one dimension, the rows of one record tile back to back
//     (block b takes row b % rows of tile b / rows): the rows that share a
//     source read their tile while it is in L2, so a sweep of 18 rows over
//     3 streams reads each stream's records from DRAM about once;
//   - the stamps leave as two 16-byte stores, the keep bits as one 8-byte
//     word;
//   - sorted t puts neighbouring records in the same bucket almost always,
//     so the thread keeps the last bucket's (start, count, k) in registers
//     and reads a table only when the guess or the snapped bucket moves:
//     a few lookups per 8 records instead of 40.
// What is left between it and the bound: the two dependent table lookups
// after each group's loads, which miss a cold L2, and at a one-wave shape
// (a ~2 M-record chunk) the launch itself.
// An output width that is not a multiple of 8 takes the kernel's scalar
// store path instead, chosen at launch: the same arithmetic, one 4-byte
// store and one byte a record. A row's last group, cut by its length,
// loads record by record.
//
// Exactness: the float ops use the _rn intrinsics so the compiler cannot
// contract them into an FMA (the reference rounds after every op), the
// float is clamped before the int conversion (inv_span = 0 for a zero-span
// stream gives 0), and the keep product stays in 32-bit int, which the host
// wrapper guarantees cannot overflow on valid lanes (KeepRuleOverflow).
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Records a block takes: the tile tuner's record_tile (kernels/tuning.py),
// built into its own library with -DREPRO_RECORD_TILE; 2048 by default.
// Every instance keeps the 8-record vector layout and varies the block.
#ifndef REPRO_RECORD_TILE
#define REPRO_RECORD_TILE 2048
#endif
constexpr int kItems = 8;                    // records per thread
constexpr int kTile = REPRO_RECORD_TILE;     // records per block
constexpr int kThreads = kTile / kItems;
static_assert(kItems == 8, "four 16-byte loads of t, one 8-byte keep word");
static_assert(kTile % (32 * kItems) == 0 && kThreads <= 1024,
              "whole warps, at most 1024 threads a block");

// The group's 8 timestamps from p (inside the row): 16-byte loads, the
// first and last record alone where p is off a 16-byte boundary (t is
// 8-byte aligned, so it is off by 8 bytes or not at all).
__device__ __forceinline__ void load_group(const double* __restrict__ p,
                                           double (&tv)[kItems]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const double2* q = reinterpret_cast<const double2*>(p);
    const double2 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2),
                  d = __ldg(q + 3);
    tv[0] = a.x; tv[1] = a.y; tv[2] = b.x; tv[3] = b.y;
    tv[4] = c.x; tv[5] = c.y; tv[6] = d.x; tv[7] = d.y;
  } else {
    const double2* q = reinterpret_cast<const double2*>(p + 1);
    const double first = __ldg(p);
    const double2 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
    const double last = __ldg(p + 7);
    tv[0] = first; tv[1] = a.x; tv[2] = a.y; tv[3] = b.x;
    tv[4] = b.y; tv[5] = c.x; tv[6] = c.y; tv[7] = last;
  }
}

// kVec: n % kItems == 0, so every thread's group of lanes is whole and
// stores as vectors.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
stream_sample_kernel(const double* __restrict__ t,
                     const long long* __restrict__ base,
                     const double* __restrict__ t_min,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ ktab,
                     const float* __restrict__ scalars,
                     const int* __restrict__ lengths,
                     int* __restrict__ ss_out,
                     unsigned char* __restrict__ keep_out,
                     int rows, int n, int width) {
  const int s = static_cast<int>(blockIdx.x % rows);
  const long long tile = blockIdx.x / rows;
  const long long i0 = (tile * kThreads + threadIdx.x) * kItems;
  if (i0 >= n) return;
  const size_t off = static_cast<size_t>(s) * n + i0;

  const int len = __ldg(lengths + s);
  const double* row = t + __ldg(base + s);
  double tv[kItems];
  if (i0 + kItems <= len) {
    load_group(row + i0, tv);
  } else {
    // the row's last group, or lanes past its length: the last record
    const long long last = len > 0 ? len - 1 : 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      tv[j] = __ldg(row + min(i0 + j, last));
  }

  const int* st = starts + static_cast<size_t>(s) * width;
  const int* ct = counts + static_cast<size_t>(s) * width;
  const int* kt = ktab + static_cast<size_t>(s) * width;
  const double t0 = __ldg(t_min + s);
  const float inv_span = __ldg(scalars + 2 * s);
  const float nb_f = __ldg(scalars + 2 * s + 1);
  const int nb = static_cast<int>(nb_f);  // exact: n_buckets < 2^24

  int ss[kItems];
  unsigned char keep[kItems];
  // the last snapped bucket and its table entries (-1: none yet)
  int cb = -1, c_start = 0, c_count = 0, c_k = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = static_cast<int>(i0 + j);   // < n on every stored lane
    // the rebase, then paper formula (1), floored to the simulated second
    const float t32 = __double2float_rn(__dsub_rn(tv[j], t0));
    float x = __fmul_rn(__fmul_rn(t32, inv_span), nb_f);
    x = fminf(fmaxf(floorf(x), 0.0f), static_cast<float>(nb - 1));
    const int g = static_cast<int>(x);

    // snap the f32 guess to the bucket that holds record i
    int s_g = c_start, c_g = c_count;
    if (g != cb) {
      s_g = __ldg(st + g);
      c_g = __ldg(ct + g);
    }
    int b = g + static_cast<int>(i >= s_g + c_g) - static_cast<int>(i < s_g);
    b = min(max(b, 0), nb - 1);
    if (b != cb) {
      if (b == g) {
        c_start = s_g;
        c_count = c_g;
      } else {
        c_start = __ldg(st + b);
        c_count = __ldg(ct + b);
      }
      c_k = __ldg(kt + b);
      cb = b;
    }
    ss[j] = b;
    keep[j] = i < len &&
              ((i - c_start) * c_k) % max(c_count, 1) < c_k;
  }

  if (kVec) {
    int4* o = reinterpret_cast<int4*>(ss_out + off);
    o[0] = make_int4(ss[0], ss[1], ss[2], ss[3]);
    o[1] = make_int4(ss[4], ss[5], ss[6], ss[7]);
    uint2 w;
    w.x = keep[0] | (keep[1] << 8) | (keep[2] << 16) |
          (static_cast<unsigned>(keep[3]) << 24);
    w.y = keep[4] | (keep[5] << 8) | (keep[6] << 16) |
          (static_cast<unsigned>(keep[7]) << 24);
    *reinterpret_cast<uint2*>(keep_out + off) = w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j < n) {
        ss_out[off + j] = ss[j];
        keep_out[off + j] = keep[j];
      }
    }
  }
}

}  // namespace

// Records a block takes in this library (its REPRO_RECORD_TILE).
extern "C" int stream_sample_record_tile() { return kTile; }

extern "C" int stream_sample_launch(const void* t, const void* base,
                                    const void* t_min, const void* starts,
                                    const void* counts, const void* ktab,
                                    const void* scalars, const void* lengths,
                                    void* ss_out, void* keep_out, int rows,
                                    int n, int width, void* stream) {
  if (rows == 0 || n == 0) return 0;
  // ss and keep come from torch.empty (aligned); a row starts on a 16-byte
  // boundary of both when n is a multiple of 8
  const bool vec_ok = (n % kItems == 0) &&
                      (reinterpret_cast<uintptr_t>(ss_out) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(keep_out) % 8 == 0);
  const long long tiles = (n + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles * rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = vec_ok ? stream_sample_kernel<true>
                       : stream_sample_kernel<false>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const double*>(t), static_cast<const long long*>(base),
      static_cast<const double*>(t_min), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(ktab),
      static_cast<const float*>(scalars), static_cast<const int*>(lengths),
      static_cast<int*>(ss_out), static_cast<unsigned char*>(keep_out), rows,
      n, width);
  return static_cast<int>(cudaGetLastError());
}
