// Fused, batched NSA inner loop for Hopper: normalize -> scale stamp ->
// systematic keep bit, one thread per record.
//
// Replaces the TPU kernel repro/kernels/stream_sample.py::_kernel
// (stream_sample_pallas). Same contract, record for record:
//   g    = floor((t - t_min) * inv_span * n_buckets)   f32, rounded per op
//   g    = clip(g, 0, n_buckets - 1)
//   g   += (i >= starts[g] + counts[g]) - (i < starts[g])   (+-1 snap to the
//          exact f64 host tables, so stamps are bit-identical to numpy NSA)
//   ss   = clip(g, 0, n_buckets - 1)
//   keep = (rank * k) % max(c, 1) < k,  rank = i - starts[ss]   (int32)
// and keep = 0 for i >= lengths[s] (padded lanes; the TPU path masked them
// after the kernel).
//
// What bounds it: bytes. Per record it reads one f32 timestamp and writes
// one int32 stamp and one byte of keep bit, 9 B; the three per-row tables
// (3 x max_range x 4 B, 43 KB at max_range 3600) stay in L2 and are read
// through the read-only cache (__ldg). The arithmetic is a handful of
// integer and float ops per record. The design therefore does one
// coalesced pass with no shared memory: consecutive threads take
// consecutive records, the keep bit is written as one byte instead of the
// TPU kernel's int32 lane.
//
// Exactness: the float ops use the _rn intrinsics so the compiler cannot
// contract them into an FMA (the reference rounds after every op), the
// float is clamped before the int conversion (inv_span = 0 for a zero-span
// stream gives 0), and the keep product stays in 32-bit int, which the host
// wrapper guarantees cannot overflow on valid lanes (KeepRuleOverflow).
// Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stream_sample_kernel(const float* __restrict__ t,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ ktab,
                     const float* __restrict__ scalars,
                     const int* __restrict__ lengths,
                     int* __restrict__ ss_out,
                     unsigned char* __restrict__ keep_out,
                     int n, int width) {
  const int s = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t off = static_cast<size_t>(s) * n + i;
  const int* st = starts + static_cast<size_t>(s) * width;
  const int* ct = counts + static_cast<size_t>(s) * width;
  const int* kt = ktab + static_cast<size_t>(s) * width;
  const float t_min = __ldg(scalars + 3 * s);
  const float inv_span = __ldg(scalars + 3 * s + 1);
  const float nb_f = __ldg(scalars + 3 * s + 2);
  const int nb = static_cast<int>(nb_f);  // exact: n_buckets < 2^24

  // paper formula (1), floored to the simulated second
  float x = __fmul_rn(__fmul_rn(__fsub_rn(t[off], t_min), inv_span), nb_f);
  x = fminf(fmaxf(floorf(x), 0.0f), static_cast<float>(nb - 1));
  int g = static_cast<int>(x);

  // snap the f32 guess to the bucket that holds record i
  const int s_g = __ldg(st + g);
  const int c_g = __ldg(ct + g);
  g += static_cast<int>(i >= s_g + c_g) - static_cast<int>(i < s_g);
  g = min(max(g, 0), nb - 1);
  ss_out[off] = g;

  unsigned char keep = 0;
  if (i < __ldg(lengths + s)) {
    const int start = __ldg(st + g);
    const int c = __ldg(ct + g);
    const int k = __ldg(kt + g);
    const int rank = i - start;
    keep = ((rank * k) % max(c, 1)) < k;
  }
  keep_out[off] = keep;
}

}  // namespace

extern "C" int stream_sample_launch(const void* t, const void* starts,
                                    const void* counts, const void* ktab,
                                    const void* scalars, const void* lengths,
                                    void* ss_out, void* keep_out, int rows,
                                    int n, int width, void* stream) {
  if (rows == 0 || n == 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads, rows);
  stream_sample_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(ktab),
      static_cast<const float*>(scalars), static_cast<const int*>(lengths),
      static_cast<int*>(ss_out), static_cast<unsigned char*>(keep_out), n,
      width);
  return static_cast<int>(cudaGetLastError());
}
