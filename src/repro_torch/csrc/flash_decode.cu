// GQA decode attention for Hopper: one new query token per sequence
// against its KV cache, softmax over the first min(lengths[b], S) cache
// positions, accumulated in f32 (split-KV flash-decoding, one launch).
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
// scratch. On Hopper one block per (KV head, sequence) would leave most of
// the 132 SMs idle, so the cache axis is split: one block per (split, KV
// head, group slice, sequence), `chunk` positions each, holding up to
// kMaxGroup = 8 query rows of its KV head. A group of G > 8 query heads
// per KV head (command-r+'s 12, recurrentgemma's 10) is cut into
// ceil(G / 8) slices of equal size (the last one smaller where G does not
// divide), side by side in the grid, so the blocks that read one KV head's
// rows run together and the second read of those rows comes from L2.
//
// What bounds it: the bytes of K and V below each row's length, read once
// (2 * len * Kh * D * sizeof(T) per row); the arithmetic is 4 flops per
// (head, position, d), far below the card's rates. So the design is about
// keeping enough bytes in flight and nothing else in their way:
//   - Staging: each block streams its split through a ring of kStages = 3
//     shared-memory stages of 64 positions x D for K and for V (34 KB per
//     stage at bf16 and D = 128, or at f32 and D = 64), filled with 16-byte
//     cp.async.cg copies. Two tiles are in flight while the third is
//     consumed, and two blocks fit on an SM (104 KB of ring each), so
//     about 136 KB per SM are in flight, well above the ~25 KB that
//     3.35 TB/s needs at HBM latency on 132 SMs. At bf16 and D = 256 one
//     block's ring is 198 KB (3 x 2 x 64 x 264 x 2 B), one block an SM,
//     with 128 KB in flight. One __syncthreads per tile: after it the
//     tile has landed and the stage consumed last is free for the next
//     copy.
//   - Locality: one position's row of one KV head is 256 bytes (bf16,
//     D = 128) between the other heads' rows, so the copies carry a
//     256-byte L2 prefetch hint and the grid runs the KV heads fastest,
//     putting the blocks that read one position's heads side by side.
//   - Rows at or past the split's end (a row's length) are zero-filled by
//     the copy's src-size operand, never read, and their scores are set to
//     -inf before the max: NaN or inf past the length cannot reach acc.
//   - Scores without per-score shuffles: each of the 4 warps owns 16
//     positions of a tile and its own online softmax (m, l, acc).
//     bf16: mma.sync m16n8k16 with the query rows as M (G of 16 used) and
//     the positions as N, K fragments read straight from the padded ring
//     (conflict-free 32-bit loads); the scores' accumulator layout is the
//     A operand of P.V, where p goes in as three bf16 terms (p's bf16
//     rounding and two of the rest, three mma each) and V's fragments
//     come from ldmatrix.trans. The row max takes two quad shuffles per
//     tile.
//     f32: FMA without TF32; each lane dots whole K rows from the ring with
//     up to four query rows, the softmax runs per (warp, query row) over a
//     quad of lanes, and each lane accumulates p.v for its columns of d
//     (at D = 16, lanes 16-31 hold no column).
//   - One launch: the warps' states merge in a fixed order; a row whose
//     length needs one split normalises and writes its output at once. A
//     row with several splits has each split write its partial (m, l, acc)
//     to a per-stream workspace and take a ticket; the block that takes the
//     last ticket resets it and merges the partials in split order, so the
//     output does not depend on which block finishes last. Splits that
//     start past the length read nothing.
//
// Exactness: bf16 x bf16 products are exact in the f32 accumulators, so in
// bf16 only the summation order and p's three-term split for P.V (about
// 2^-26 relative, below f32's own rounding) differ from the plain version,
// which keeps p in f32; f32 runs f32 products and sums in another order.
// expf without fast math. Within 2e-5 of the plain version in f32 and
// within one bf16 rounding of the output (under 1%) in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // cache positions per stage
constexpr int kWarpRows = kTile / kWarps;  // 16 positions per warp
constexpr int kStages = 3;
constexpr int kMaxGroup = 8;               // query heads per KV head
constexpr int kMaxDevices = 64;

using bf16 = __nv_bfloat16;

template <typename T, int D>
struct Shape {
  static constexpr int kPad = 16 / sizeof(T);        // one 16-byte chunk
  static constexpr int kLd = D + kPad;               // ring row, elements
  static constexpr int kChunks = D * sizeof(T) / 16;  // 16-byte chunks a row
  static constexpr int kTileElems = kTile * kLd;
  static constexpr size_t kRingBytes =
      static_cast<size_t>(kStages) * 2 * kTileElems * sizeof(T);
  // f32 only: query rows, per-warp scores / p, per-warp corrections
  static constexpr size_t kExtraBytes =
      std::is_same<T, float>::value
          ? (kMaxGroup * D + kWarps * kMaxGroup * kWarpRows +
             kWarps * kMaxGroup) * sizeof(float)
          : 0;
  static constexpr size_t kSmemBytes = kRingBytes + kExtraBytes;
  static_assert(kWarps * kMaxGroup * D * sizeof(float) <= kRingBytes,
                "the warps' partial outputs reuse the ring");
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// (x0, x1) as three bf16 pairs, t[0] = bf16(x), t[1] = bf16(x - t[0]),
// t[2] = bf16(x - t[0] - t[1]): their sum carries x to about 2^-26
// relative, so P.V on the tensor cores keeps p's f32 precision. The low
// half of each pair is x0.
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           unsigned t[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    t[i] = *reinterpret_cast<const unsigned*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

// d[0..1] += A(16x16, rows 8-15 zero) . B(16x8), f32 accumulators; the
// accumulator rows 8-15 are zero in and discarded out.
__device__ __forceinline__ void mma_rows8(float d[2], unsigned a0,
                                          unsigned a2, unsigned b0,
                                          unsigned b1) {
  float z0, z1;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(z0), "=f"(z1)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(d[0]),
        "f"(d[1]), "f"(0.f), "f"(0.f));
  (void)z0;
  (void)z1;
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// m_safe: the running max, 0 while it is still -inf, so that exp(s - m)
// of a masked score is 0 and never exp(-inf + inf).
__device__ __forceinline__ float safe_max(float m) {
  return m == -INFINITY ? 0.f : m;
}

// Per-warp online-softmax state, as each layout keeps it.
template <typename T, int D>
struct WarpState;

// bf16: lane (g = lane / 4, c = lane % 4) holds query row g's running max,
// its share of l, and o[nt] = acc(g, d = 8 nt + 2 c + {0, 1}).
template <int D>
struct WarpState<bf16, D> {
  static constexpr int kKSteps = D / 16;
  unsigned q_lo[kKSteps], q_hi[kKSteps];   // A fragments of the query rows
  float o[D / 8][2];
  float m, l;

  __device__ void init(const bf16* qg, int G) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      q_lo[ks] = g < G ? *reinterpret_cast<const unsigned*>(
                             qg + g * D + 16 * ks + 2 * c) : 0u;
      q_hi[ks] = g < G ? *reinterpret_cast<const unsigned*>(
                             qg + g * D + 16 * ks + 8 + 2 * c) : 0u;
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = 0.f;
    m = -INFINITY;
    l = 0.f;
  }

  // One tile: this warp's 16 positions start at ring row `row0`, cache
  // position `pos0`; positions >= end are masked.
  __device__ void step(const bf16* ks_tile, const bf16* vs_tile, int row0,
                       int pos0, int end, float scale, float*) {
    using S = Shape<bf16, D>;
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    float s[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float acc[2] = {0.f, 0.f};
      const bf16* krow = ks_tile + (row0 + 8 * nt + g) * S::kLd + 2 * c;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const unsigned b0 = *reinterpret_cast<const unsigned*>(krow + 16 * ks);
        const unsigned b1 =
            *reinterpret_cast<const unsigned*>(krow + 16 * ks + 8);
        mma_rows8(acc, q_lo[ks], q_hi[ks], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s[nt][e] = pos0 + 8 * nt + 2 * c + e < end ? acc[e] * scale
                                                   : -INFINITY;
    }
    float mx = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float ms = safe_max(m_new);
    const float corr = expf(m - ms);
    float p[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[nt][e] = expf(s[nt][e] - ms);
    l = l * corr + ((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
    m = m_new;
    unsigned a0[3], a2[3];
    split_bf16(p[0][0], p[0][1], a0);   // positions 2c, 2c+1
    split_bf16(p[1][0], p[1][1], a2);   // positions 8+2c, +1
    // V fragments: matrix i of the x4 load is (positions 8 (i & 1) .. +8,
    // d 8 (i >> 1) .. +8) of the current pair of 8-column tiles
    const int mi = lane >> 3, r = lane & 7;
    const bf16* vrow =
        vs_tile + (row0 + 8 * (mi & 1) + r) * S::kLd + 8 * (mi >> 1);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned b[4];
      ldmatrix_x4_trans(b, vrow + 16 * np);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* od = o[2 * np + h];
        od[0] *= corr;
        od[1] *= corr;
#pragma unroll
        for (int t = 0; t < 3; ++t)
          mma_rows8(od, a0[t], a2[t], b[2 * h], b[2 * h + 1]);
      }
    }
  }

  // Writes this warp's (m, l) per query row and acc to shared memory.
  __device__ void dump(float* wm, float* wl, float* wacc, int G) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    float lt = l;
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (g < G) {
      if (c == 0) {
        wm[g] = m;
        wl[g] = lt;
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        wacc[g * D + 8 * nt + 2 * c] = o[nt][0];
        wacc[g * D + 8 * nt + 2 * c + 1] = o[nt][1];
      }
    }
  }
};

// f32: query rows in shared memory (qs, kMaxGroup x D); per warp a
// (kMaxGroup x 16) block of scores / p and kMaxGroup corrections. Lane
// (g = lane / 4, quad lane c) holds query row g's running max and its
// share of l; lane holds acc(g, d = lane + 32 i) for every g.
template <int D>
struct WarpState<float, D> {
  static_assert(D % 32 == 0 || D < 32, "a lane's columns: d = lane + 32 i");
  static constexpr int kCols = (D + 31) / 32;
  // whether this lane holds a column (every lane does once D >= 32)
  __device__ static bool has_col(int lane) { return D >= 32 || lane < D; }
  float acc[kMaxGroup][kCols];
  float m, l;
  const float* qs;
  int G;

  __device__ void init(const float* qs_, int G_) {
    qs = qs_;
    G = G_;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[g][i] = 0.f;
    m = -INFINITY;
    l = 0.f;
  }

  __device__ void step(const float* ks_tile, const float* vs_tile, int row0,
                       int pos0, int end, float scale, float* scratch) {
    using S = Shape<float, D>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* ps = scratch + warp * kMaxGroup * kWarpRows;   // [g][j]
    float* cs = scratch + kWarps * kMaxGroup * kWarpRows + warp * kMaxGroup;
    // scores: lane (j = lane % 16, gh = lane / 16) dots K row j with query
    // rows gh, gh + 2, gh + 4, gh + 6
    {
      const int j = lane & 15, gh = lane >> 4;
      const float4* kr =
          reinterpret_cast<const float4*>(ks_tile + (row0 + j) * S::kLd);
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = kr[d4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv =
              reinterpret_cast<const float4*>(qs + (gh + 2 * i) * D)[d4];
          dot[i] = fmaf(qv.x, kv.x, dot[i]);
          dot[i] = fmaf(qv.y, kv.y, dot[i]);
          dot[i] = fmaf(qv.z, kv.z, dot[i]);
          dot[i] = fmaf(qv.w, kv.w, dot[i]);
        }
      }
      const bool valid = pos0 + j < end;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ps[(gh + 2 * i) * kWarpRows + j] = valid ? dot[i] * scale : -INFINITY;
    }
    __syncwarp();
    // softmax bookkeeping: quad (g = lane / 4) over 4 positions a lane
    {
      const int g = lane >> 2, c = lane & 3;
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = ps[g * kWarpRows + 4 * c + e];
      float mx = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float ms = safe_max(m_new);
      const float corr = expf(m - ms);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[e] - ms);
        ps[g * kWarpRows + 4 * c + e] = p;
        sum += p;
      }
      l = l * corr + sum;
      m = m_new;
      if (c == 0) cs[g] = corr;
    }
    __syncwarp();
    // acc(g, d) = acc * corr + sum_j p(g, j) v(j, d)
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float cr = cs[g];
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[g][i] *= cr;
      }
    }
    const int rows = has_col(lane) ? kWarpRows : 0;
#pragma unroll 4
    for (int j = 0; j < rows; ++j) {
      const float* vr = vs_tile + (row0 + j) * S::kLd + lane;
      float vv[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) vv[i] = vr[32 * i];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const float p = ps[g * kWarpRows + j];
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[g][i] = fmaf(p, vv[i], acc[g][i]);
        }
      }
    }
    __syncwarp();
  }

  __device__ void dump(float* wm, float* wl, float* wacc, int G_) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
    float lt = l;
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (g < G_ && c == 0) {
      wm[g] = m;
      wl[g] = lt;
    }
    if (!has_col(lane)) return;
#pragma unroll
    for (int g2 = 0; g2 < kMaxGroup; ++g2)
      if (g2 < G_)
#pragma unroll
        for (int i = 0; i < kCols; ++i) wacc[g2 * D + lane + 32 * i] = acc[g2][i];
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    int S, int Kh, int G, int slice, int n_slices, int chunk,
                    int n_splits, float scale, float* __restrict__ ws_ml,
                    float* __restrict__ ws_acc,
                    unsigned* __restrict__ tickets, T* __restrict__ out) {
  using Sh = Shape<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float wm[kWarps][kMaxGroup], wl[kWarps][kMaxGroup];
  __shared__ int s_last;

  // blockIdx.x runs over (KV head, group slice), the slices fastest
  const int kh = blockIdx.x / n_slices, g0 = (blockIdx.x % n_slices) * slice;
  const int split = blockIdx.y, b = blockIdx.z;
  const int H = Kh * G;
  const int Gb = min(slice, G - g0);     // query rows of this block
  const int h0 = kh * G + g0;            // its first query head
  const int len = min(max(lengths[b], 0), S);
  const int s0 = split * chunk;
  T* out_bh = out + (static_cast<size_t>(b) * H + h0) * D;
  if (s0 >= len) {
    if (len == 0 && split == 0)          // a row of length 0 gives zeros
      for (int i = threadIdx.x; i < Gb * D; i += kThreads)
        store(out_bh + i, 0.f);
    return;
  }
  const int s1 = min(s0 + chunk, len);
  const int nv = (len + chunk - 1) / chunk;   // splits of this row that run
  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5;

  T* ring = reinterpret_cast<T*>(smem);
  float* extra = reinterpret_cast<float*>(smem + Sh::kRingBytes);
  const size_t row = static_cast<size_t>(Kh) * D;   // between positions
  const T* kb = k + (static_cast<size_t>(b) * S * Kh + kh) * D;
  const T* vb = v + (static_cast<size_t>(b) * S * Kh + kh) * D;
  const T* qg = q + (static_cast<size_t>(b) * H + h0) * D;

  // stage `st` <- positions [s0 + 64 t, +64) of K and V, zero past s1
  auto stage_tile = [&](int t, int st) {
    T* kst = ring + (2 * st) * Sh::kTileElems;
    T* vst = kst + Sh::kTileElems;
    const int p0 = s0 + t * kTile;
#pragma unroll
    for (int it = 0; it < kTile * Sh::kChunks / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / Sh::kChunks, ch = i % Sh::kChunks;
      const int pos = p0 + r;
      const bool ok = pos < s1;
      const size_t src = static_cast<size_t>(ok ? pos : s0) * row +
                         ch * (16 / sizeof(T));
      const int dst = r * Sh::kLd + ch * (16 / sizeof(T));
      cp_async16(kst + dst, kb + src, ok ? 16 : 0);
      cp_async16(vst + dst, vb + src, ok ? 16 : 0);
    }
  };

  WarpState<T, D> ws;
  if constexpr (std::is_same<T, float>::value) {
    float* qs = extra;
    for (int i = threadIdx.x; i < kMaxGroup * D; i += kThreads)
      qs[i] = i < Gb * D ? qg[i] : 0.f;
    ws.init(qs, Gb);                     // qs is read after the first sync
  } else {
    ws.init(qg, Gb);
  }
  float* scratch = extra + kMaxGroup * D;   // f32 only

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) stage_tile(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile t landed; stage (t - 1) % kStages is free
    if (t + kStages - 1 < n_tiles)
      stage_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const T* kst = ring + (2 * (t % kStages)) * Sh::kTileElems;
    ws.step(kst, kst + Sh::kTileElems, warp * kWarpRows,
            s0 + t * kTile + warp * kWarpRows, s1, scale, scratch);
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is free: it takes the warps' partials

  float* wacc = reinterpret_cast<float*>(smem);   // [warp][g][d]
  ws.dump(wm[warp], wl[warp], wacc + warp * kMaxGroup * D, Gb);
  __syncthreads();

  // merge the warps in order; one split: normalise and write
  const size_t slot0 = (static_cast<size_t>(b) * H + h0) * n_splits;
  for (int i = threadIdx.x; i < Gb * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w][g]);
    const float ms = safe_max(m);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(wm[w][g] - ms);
      l = fmaf(wl[w][g], e, l);
      o = fmaf(wacc[(w * kMaxGroup + g) * D + d], e, o);
    }
    if (nv == 1) {
      store(out_bh + i, l > 0.f ? o / l : 0.f);
    } else {
      const size_t slot = slot0 + static_cast<size_t>(g) * n_splits + split;
      ws_acc[slot * D + d] = o;
      if (d == 0) {
        ws_ml[2 * slot] = m;
        ws_ml[2 * slot + 1] = l;
      }
    }
  }
  if (nv == 1) return;

  // several splits: the last to finish merges them in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = tickets + static_cast<size_t>(b) * gridDim.x +
                       blockIdx.x;
    const unsigned prev = atomicAdd(ticket, 1u);
    s_last = prev == static_cast<unsigned>(nv - 1);
    if (s_last) atomicExch(ticket, 0u);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < Gb * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const size_t base = slot0 + static_cast<size_t>(g) * n_splits;
    float m = -INFINITY;
    for (int j = 0; j < nv; ++j) m = fmaxf(m, __ldcg(ws_ml + 2 * (base + j)));
    const float ms = safe_max(m);
    float l = 0.f, o = 0.f;
    for (int j = 0; j < nv; ++j) {
      const float e = expf(__ldcg(ws_ml + 2 * (base + j)) - ms);
      l = fmaf(__ldcg(ws_ml + 2 * (base + j) + 1), e, l);
      o = fmaf(__ldcg(ws_acc + (base + j) * D + d), e, o);
    }
    store(out_bh + i, l > 0.f ? o / l : 0.f);
  }
}

// Once per device: the instance's dynamic shared memory above 48 KB.
template <typename T, int D>
cudaError_t prepare() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(flash_decode_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Shape<T, D>::kSmemBytes));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

// Blocks of the instance an SM holds at once on the current device, or a
// negative CUDA error code.
template <typename T, int D>
int blocks_per_sm() {
  cudaError_t err = prepare<T, D>();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, flash_decode_kernel<T, D>, kThreads, Shape<T, D>::kSmemBytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, int B, int S, int Kh, int G,
                   int slice, int chunk, int n_splits, float* ws_ml,
                   float* ws_acc, unsigned* tickets, void* out,
                   cudaStream_t stream) {
  cudaError_t err = prepare<T, D>();
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int n_slices = (G + slice - 1) / slice;
  flash_decode_kernel<T, D>
      <<<dim3(Kh * n_slices, n_splits, B), kThreads,
         Shape<T, D>::kSmemBytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lengths, S, Kh, G, slice, n_slices,
          chunk, n_splits, scale, ws_ml, ws_acc, tickets,
          static_cast<T*>(out));
  return cudaGetLastError();
}

// The (dtype code, element type, D) instances built: 0 float32, 1 bfloat16.
#define FLASH_DECODE_INSTANCES(X) \
  X(0, float, 16)                 \
  X(0, float, 64)                 \
  X(0, float, 128)                \
  X(1, bf16, 16)                  \
  X(1, bf16, 64)                  \
  X(1, bf16, 128)                 \
  X(1, bf16, 256)

}  // namespace

extern "C" {

// Positions per shared-memory stage: the split size must be a multiple.
int flash_decode_tile() { return kTile; }

// Largest number of query heads one block holds (a group slice).
int flash_decode_max_group() { return kMaxGroup; }

// dtype: 0 float32, 1 bfloat16; D: 16, 64 or 128 in float32, 16, 64, 128
// or 256 in bfloat16. slice: query heads per block, 1..kMaxGroup and at
// most G; the grid holds n_slices = ceil(G / slice) blocks per KV head.
// chunk: positions per split, a multiple of 64; n_splits = ceil(S /
// chunk). Workspace from the caller, kept per stream: ws_ml (B, H,
// n_splits, 2) f32 and ws_acc (B, H, n_splits, D) f32 (no initial value
// needed), tickets (B, Kh * n_slices) unsigned, zero when first allocated
// (each call leaves them zero). q, k and v 16-byte aligned. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for a shape the kernel does not take).
int flash_decode_launch(int dtype, const void* q, const void* k,
                        const void* v, const int* lengths, int B, int S,
                        int Kh, int G, int D, int slice, int chunk,
                        int n_splits, void* ws_ml, void* ws_acc,
                        void* tickets, void* out, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Kh < 1 || G < 1 || slice < 1 ||
      slice > kMaxGroup || slice > G ||
      static_cast<long long>(Kh) * ((G + slice - 1) / slice) > 0x7fffffff ||
      chunk < kTile || chunk % kTile != 0 || n_splits > 65535 ||
      n_splits != (S + chunk - 1) / chunk ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(ws_ml);
  float* acc = static_cast<float*>(ws_acc);
  unsigned* tk = static_cast<unsigned*>(tickets);
#define FLASH_DECODE_CASE(code, T, DIM)                                     \
  if (dtype == code && D == DIM)                                            \
    return static_cast<int>(launch<T, DIM>(q, k, v, lengths, B, S, Kh, G,   \
                                           slice, chunk, n_splits, ml, acc, \
                                           tk, out, st));
  FLASH_DECODE_INSTANCES(FLASH_DECODE_CASE)
#undef FLASH_DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the (dtype, D) instance an SM holds at once on the current
// device (shared memory, registers and threads as built); a negative CUDA
// error code, or -cudaErrorInvalidValue for an instance not built.
int flash_decode_blocks_per_sm(int dtype, int D) {
#define FLASH_DECODE_CASE(code, T, DIM) \
  if (dtype == code && D == DIM) return blocks_per_sm<T, DIM>();
  FLASH_DECODE_INSTANCES(FLASH_DECODE_CASE)
#undef FLASH_DECODE_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
