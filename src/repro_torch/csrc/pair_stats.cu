// All-pairs Pearson sufficient statistics of stacked trend series for
// Hopper: per-row sums and the Gram matrix of an (S, K) float32 matrix.
//
// Replaces the TPU kernel repro/kernels/trend_scan.py::_pair_kernel
// (pair_stats_pallas). It writes sums[a] = x[a, 0] + ... + x[a, K-1] and
// gram[a, b] = gram[b, a] = sum over t of x[a, t] * x[b, t].
//
// The TPU kernel walked the time axis in 512-wide tiles and accumulated
// x_tile @ x_tile^T into a Gram kept resident in VMEM across the grid.
// Here the same product is split over blocks so that every input byte is
// read from device memory once, in one launch:
//   - Output tiles. The rows fall into row tiles of kTile = 64; a block
//     owns one output tile (ti <= tj, the upper triangle of tiles) and one
//     split of the time axis: grid (tiles, splits). S <= 64 is one tile.
//     The splits of a tile come in thread block clusters of kCluster = 8
//     blocks, on neighbouring SMs.
//   - Staging. A block copies its slab (the rows of tile ti, and of tile
//     tj when tj != ti, over its split's columns) into a ring of kStages
//     shared-memory stages with 16-byte cp.async (4-byte copies when a
//     row does not start on a 16-byte boundary), zero-filling rows past S
//     and columns past the split. Two stages are in flight while the
//     third is consumed.
//   - Register micro-tiles. The tile's pairs are cut into 4 x 4 micro-tiles
//     of row groups (on a diagonal tile only the groups ga <= gb). Each
//     thread owns one micro-tile and one of n_kl "k-lanes", a power of two
//     that spreads the micro-tiles over the 256 threads; a k-lane takes
//     every n_kl-th 4-column chunk of a stage. Per chunk it reads 4 + 4
//     float4 from shared memory and does 64 fused multiply-adds in f32; the
//     threads of a diagonal micro-tile also add up their rows' sums.
//   - Reduction. The k-lanes of a micro-tile are adjacent threads: a
//     butterfly of shuffles sums them within a warp, and the warps of a
//     micro-tile (n_kl > 32) are summed in warp order through shared
//     memory, into the block's partial (16 values a micro-tile, then the
//     row sums of a diagonal tile) in shared memory.
//   - Deterministic fold. Block 0 of each cluster adds up the cluster's
//     partials in rank order, reading the other blocks' shared memory
//     (distributed shared memory; a second cluster barrier keeps it alive
//     until then). A tile of one cluster is then done: block 0 writes the
//     tile's cells of gram, row by row, and the mirrored cells (each cell
//     of gram belongs to one tile, so each is written once) and, on a
//     diagonal tile, its rows' sums (each once too). With
//     several clusters, block 0 writes the cluster's sum to a workspace
//     slot and takes a ticket; the block that takes the tile's last ticket
//     adds up the clusters' sums in cluster order and writes the tile. The
//     order of every addition depends on the shape alone, so two calls are
//     bit-identical. No float atomics; the ticket is reset by the block
//     that takes the last one, so the workspace (no initial value) and the
//     tickets (zero when first allocated) need no memset per call.
//   No tensor cores and no TF32: the product stays in full f32, because
//   the correlations built on it must stay within 1e-3 of the float64 host
//   path and TF32's 10-bit mantissa puts that at risk.
//
// What bounds it: the bytes of x, read once (S K 4 bytes), against the
// S (S + 1) K multiply-adds of the upper triangle; at S = 37 the bytes
// (3.8 us at 3.35 TB/s) outweigh the operations (1.9 us at 67 TFLOP/s).
// Padding rows to groups of 4 and the diagonal micro-tiles' lower halves
// add up to a quarter more FMAs. Small calls are launch-bound.
//
// Exactness: f32 sums in another order than the TPU's (or the f64 plain
// version's), within 1e-4 of sqrt(G[a, a] G[b, b]) of the f64 Gram.
//
// Built with -DPAIR_STATS_PHASES (tools/time_pair_stats.py --phases),
// thread 0 of each block also stamps the global timer at eight points,
// PHASE(0) (start) to PHASE(7) (the tile written), into
// pair_stats_phase_stamps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                  // output tile rows
constexpr int kGroups = kTile / 4;         // 4-row groups a tile
constexpr int kMaxRows = 2 * kTile;        // staged rows of one block
constexpr int kStageFloats = 8192;         // slab floats a stage (32 KB)
constexpr int kStageCap = kStageFloats + 4 * kMaxRows;   // + row padding
constexpr int kStages = 3;
constexpr int kSmemBytes = kStages * kStageCap * 4;
constexpr int kVals = 20;                  // 16 products + 4 row sums
constexpr int kCluster = 8;                // splits a thread block cluster
constexpr int kMaxDevices = 64;

#ifdef PAIR_STATS_PHASES
constexpr int kPhaseBlocks = 8192;
__device__ unsigned long long pair_stats_phase_stamps[kPhaseBlocks * 8];
#define PHASE(i)                                                        \
  do {                                                                  \
    const unsigned blk = blockIdx.y * gridDim.x + blockIdx.x;           \
    if (threadIdx.x == 0 && blk < kPhaseBlocks) {                       \
      unsigned long long t;                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));             \
      pair_stats_phase_stamps[blk * 8 + (i)] = t;                       \
    }                                                                   \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The upper-triangle enumeration of an n x n grid (i <= j), row by row:
// index m -> (i, j), and back.
__device__ __forceinline__ void tri_decode(int m, int n, int& i, int& j) {
  i = 0;
  while (m >= n - i) {
    m -= n - i;
    ++i;
  }
  j = i + m;
}
__device__ __forceinline__ int tri_index(int i, int j, int n) {
  return i * n - i * (i - 1) / 2 + (j - i);
}

// What one block does, from its tile and the shape alone.
struct Plan {
  int ti, tj;        // row tiles of the output tile, ti <= tj
  bool diag;
  int ga, gb;        // 4-row groups of tile ti and tile tj
  int rows_a;        // staged rows of tile ti (4 ga); tj's follow them
  int ra, rb;        // real rows of tile ti and tile tj
  int n_micro;       // micro-tiles of the output tile
  int n_kl;          // k-lanes a micro-tile (a power of two)
  int psize;         // floats of the block's partial

  __device__ Plan(int tile, int nt, int S) {
    tri_decode(tile, nt, ti, tj);
    diag = ti == tj;
    ra = min(kTile, S - ti * kTile);
    rb = diag ? ra : min(kTile, S - tj * kTile);
    ga = (ra + 3) / 4;
    gb = (rb + 3) / 4;
    rows_a = 4 * ga;
    n_micro = diag ? ga * (ga + 1) / 2 : ga * gb;
    n_kl = 1;
    while (2 * n_kl * n_micro <= kThreads) n_kl *= 2;
    psize = 16 * n_micro + (diag ? 4 * ga : 0);
  }
  __device__ int staged_rows() const {
    return diag ? rows_a : rows_a + 4 * gb;
  }
  __device__ void micro(int m, int& ma, int& mb) const {
    if (diag) {
      tri_decode(m, ga, ma, mb);
    } else {
      ma = m / gb;
      mb = m % gb;
    }
  }
  // The tile's answer, its partial in shared memory, to gram and sums:
  // every cell of the tile's square (a diagonal tile) or of its rectangle
  // and the mirrored one, each once, row by row; a lower-half cell takes
  // the upper micro-tile entry of its pair; a diagonal tile's row sums.
  __device__ void write_tile(const float* part, int S,
                             float* __restrict__ sums,
                             float* __restrict__ gram) const {
    const int cols = diag ? ra : rb;
    for (int i = threadIdx.x; i < ra * cols; i += kThreads) {
      const int a = i / cols, b = i % cols;
      int g0 = a / 4, g1 = b / 4, r = a % 4, s = b % 4;
      if (diag && (g0 > g1 || (g0 == g1 && r > s))) {
        const int tg = g0, tr = r;
        g0 = g1;
        g1 = tg;
        r = s;
        s = tr;
      }
      const int m = diag ? tri_index(g0, g1, ga) : g0 * gb + g1;
      const float v = part[16 * m + 4 * r + s];
      gram[static_cast<size_t>(ti * kTile + a) * S + tj * kTile + b] = v;
      if (!diag)
        gram[static_cast<size_t>(tj * kTile + b) * S + ti * kTile + a] = v;
    }
    if (diag)
      for (int a = threadIdx.x; a < ra; a += kThreads)
        sums[ti * kTile + a] = part[16 * n_micro + a];
  }
};

__device__ __forceinline__ void add4(float4& t, const float4& u) {
  t.x += u.x;
  t.y += u.y;
  t.z += u.z;
  t.w += u.w;
}

// Float4 j of the sum of n partial slots first, first + stride, ..., added
// in slot order; eight slots' loads are in flight at a time (the slots
// were written by other blocks of this launch: read through L2).
__device__ __forceinline__ float4 fold4(const float* first, int stride,
                                        int n, int j) {
  const float4* f = reinterpret_cast<const float4*>(first) + j;
  const size_t s4 = stride / 4;
  float4 t = __ldcg(f);
  for (int s0 = 1; s0 < n; s0 += 8) {
    float4 r[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      r[u] = s0 + u < n ? __ldcg(f + (s0 + u) * s4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (s0 + u < n) add4(t, r[u]);
  }
  return t;
}

__global__ void __cluster_dims__(1, kCluster, 1)
__launch_bounds__(kThreads, 2)
pair_stats_kernel(const float* __restrict__ x, int S, int K, bool vec,
                  int nt, int kc, int pstride, float* __restrict__ ws,
                  unsigned* __restrict__ tickets, float* __restrict__ sums,
                  float* __restrict__ gram) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  PHASE(0);                  // start
  const Plan pl(blockIdx.x, nt, S);
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int R = pl.staged_rows();

  // this split's columns, in n_st stages of W columns (W a multiple of
  // 4 n_kl, balanced so the last stage is not mostly padding)
  const int lo = split * kc;
  const int hi = min(K, lo + kc);
  const int len = max(hi - lo, 0);
  const int quantum = 4 * pl.n_kl;
  const int w_max = max(1, kStageFloats / (R * quantum)) * quantum;
  const int n_st = (len + w_max - 1) / w_max;
  const int W = n_st ? ((len + n_st - 1) / n_st + quantum - 1) / quantum *
                           quantum
                     : quantum;
  const int ld = W + 4;                     // row stride, 16-byte aligned
  const int q = W / quantum;                // 4-column chunks a k-lane

  // staged row r -> row of x, or -1 for a padding row
  auto src_row = [&](int r) {
    if (r < pl.rows_a) return r < pl.ra ? pl.ti * kTile + r : -1;
    r -= pl.rows_a;
    return r < pl.rb ? pl.tj * kTile + r : -1;
  };
  auto stage = [&](int t, int st) {
    float* dst = smem + st * kStageCap;
    const int c0 = lo + t * W;
    if (vec) {
      const int w4 = W / 4;
      for (int i = tid; i < R * w4; i += kThreads) {
        const int r = i / w4, c = 4 * (i % w4);
        const int row = src_row(r);
        const bool ok = row >= 0 && c0 + c < hi;
        const float* src = ok ? x + static_cast<size_t>(row) * K + c0 + c : x;
        cp_async16(dst + r * ld + c, src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < R * W; i += kThreads) {
        const int r = i / W, c = i % W;
        const int row = src_row(r);
        const bool ok = row >= 0 && c0 + c < hi;
        const float* src = ok ? x + static_cast<size_t>(row) * K + c0 + c : x;
        cp_async4(dst + r * ld + c, src, ok ? 4 : 0);
      }
    }
  };

  const int m = tid / pl.n_kl, kl = tid % pl.n_kl;
  const bool active = m < pl.n_micro;
  int ma = 0, mb = 0;
  if (active) pl.micro(m, ma, mb);
  const bool row_sums = active && pl.diag && ma == mb;
  const int row_b = pl.diag ? 4 * mb : pl.rows_a + 4 * mb;
  float acc[4][4], rs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rs[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_st) stage(t, t);
    cp_async_commit();
  }
  PHASE(1);                  // the first stages are in flight
  for (int t = 0; t < n_st; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage t landed; stage (t - 1) % kStages is free
    const int next = t + kStages - 1;
    if (next < n_st) stage(next, next % kStages);
    cp_async_commit();
    if (active) {
      const float* base = smem + (t % kStages) * kStageCap;
      const float* A = base + 4 * ma * ld;
      const float* B = base + row_b * ld;
#pragma unroll 2
      for (int i = 0; i < q; ++i) {
        const int c = 4 * (kl + pl.n_kl * i);
        float4 a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = *reinterpret_cast<const float4*>(A + r * ld + c);
          b[r] = *reinterpret_cast<const float4*>(B + r * ld + c);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            acc[r][s] = fmaf(a[r].x, b[s].x, acc[r][s]);
            acc[r][s] = fmaf(a[r].y, b[s].y, acc[r][s]);
            acc[r][s] = fmaf(a[r].z, b[s].z, acc[r][s]);
            acc[r][s] = fmaf(a[r].w, b[s].w, acc[r][s]);
          }
        }
        if (row_sums) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            rs[r] += (a[r].x + a[r].y) + (a[r].z + a[r].w);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is free: it takes the reduction
  PHASE(2);

  // k-lanes -> one value set a micro-tile: shuffles within the warp ...
  float v[kVals];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int s = 0; s < 4; ++s) v[4 * r + s] = acc[r][s];
    v[16 + r] = rs[r];
  }
  const int span = min(pl.n_kl, 32);
  for (int o = 1; o < span; o <<= 1) {
#pragma unroll
    for (int i = 0; i < kVals; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  // ... then the warps of a micro-tile, in warp order
  const int nw = max(1, pl.n_kl / 32);
  float* red = smem;                               // [micro][warp][kVals]
  float* part = smem + kThreads / 32 * 32 * kVals;  // the block's partial
  if (active && kl % 32 == 0) {
#pragma unroll
    for (int i = 0; i < kVals; ++i)
      red[(m * nw + kl / 32) * kVals + i] = v[i];
  }
  __syncthreads();
  for (int p = tid; p < pl.psize; p += kThreads) {
    int mi, vi;
    if (p < 16 * pl.n_micro) {
      mi = p / 16;
      vi = p % 16;
    } else {
      const int r = p - 16 * pl.n_micro;
      mi = tri_index(r / 4, r / 4, pl.ga);
      vi = 16 + r % 4;
    }
    float t = red[(mi * nw) * kVals + vi];
    for (int w = 1; w < nw; ++w) t += red[(mi * nw + w) * kVals + vi];
    part[p] = t;
  }
  __syncthreads();

  PHASE(3);                  // the block's partial
  // block 0 of the cluster adds up the cluster's partials in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  PHASE(4);
  const int n_clusters = gridDim.y / kCluster;
  const size_t tile = blockIdx.x;
  const size_t slot0 = tile * n_clusters;
  if (cluster.block_rank() == 0) {
    const float4* part4 = reinterpret_cast<const float4*>(part);
    const float4* peer[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      peer[r] = cluster.map_shared_rank(part4, r);
    float* slot = n_clusters == 1
                      ? part
                      : ws + (slot0 + blockIdx.y / kCluster) * pstride;
    float4* out = reinterpret_cast<float4*>(slot);
    for (int j = tid; 4 * j < pl.psize; j += kThreads) {
      float4 u[kCluster];
#pragma unroll
      for (int r = 0; r < kCluster; ++r) u[r] = peer[r][j];
      float4 t = u[0];
#pragma unroll
      for (int r = 1; r < kCluster; ++r) add4(t, u[r]);
      out[j] = t;
    }
  }
  cluster.sync();      // the peers' shared memory lives until it is read
  PHASE(5);
  if (cluster.block_rank() != 0) return;
  if (n_clusters == 1) {
    pl.write_tile(part, S, sums, gram);
    PHASE(7);
    return;
  }

  // several clusters: the tile's last one folds their sums in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned prev = atomicAdd(tickets + tile, 1u);
    s_last = prev == static_cast<unsigned>(n_clusters - 1);
    if (s_last) atomicExch(tickets + tile, 0u);
  }
  __syncthreads();
  PHASE(6);                  // the ticket
  if (!s_last) return;
  __threadfence();
  const float* first = ws + slot0 * pstride;
  for (int j = tid; 4 * j < pl.psize; j += kThreads)
    reinterpret_cast<float4*>(part)[j] = fold4(first, pstride, n_clusters, j);
  __syncthreads();
  pl.write_tile(part, S, sums, gram);
  PHASE(7);
}

}  // namespace

extern "C" {

// Rows of one output tile (the wrapper's plan counts tiles with it).
int pair_stats_tile() { return kTile; }

// Splits of a tile in one thread block cluster: the wrapper's plan
// makes the splits a multiple of it.
int pair_stats_cluster() { return kCluster; }

// x (S, K) float32 contiguous; sums (S,) and gram (S, S) float32. The
// plan, from the wrapper: kc columns a split (a multiple of 4), n_splits
// splits a tile (a multiple of kCluster, kc n_splits >= K; splits past K
// are empty), pstride floats a workspace slot (a multiple of 4, at least
// the largest tile's partial). With more than one cluster a tile, ws holds
// tiles x n_splits / kCluster slots (float32, no initial value needed) and
// tickets one unsigned a tile, zero when first allocated (each call leaves
// them zero). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, without launching, for a plan the kernel does
// not take).
static cudaError_t prepare() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(pair_stats_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

// Clusters of this kernel the current device runs at once (one wave), or
// minus a CUDA error code.
int pair_stats_max_clusters() {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, kCluster, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = kCluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, pair_stats_kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

int pair_stats_launch(const void* x, int S, int K, int kc, int n_splits,
                      int pstride, void* ws, void* tickets, void* sums,
                      void* gram, void* stream) {
  const int nt = (S + kTile - 1) / kTile;
  const long long tiles = static_cast<long long>(nt) * (nt + 1) / 2;
  const int g = (S + 3) / 4;
  const int max_psize =
      nt == 1 ? 16 * g * (g + 1) / 2 + 4 * g : 16 * kGroups * kGroups;
  if (S < 1 || K < 0 || tiles > 0x7fffffffLL || n_splits < kCluster ||
      n_splits % kCluster != 0 || n_splits > 65535 || kc < 0 ||
      kc % 4 != 0 || static_cast<long long>(kc) * n_splits < K ||
      (n_splits > kCluster && (pstride % 4 != 0 || pstride < max_psize)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  pair_stats_kernel<<<dim3(static_cast<unsigned>(tiles), n_splits), kThreads,
                      kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), S, K, vec, nt, kc, pstride,
      static_cast<float*>(ws), static_cast<unsigned*>(tickets),
      static_cast<float*>(sums), static_cast<float*>(gram));
  return static_cast<int>(cudaGetLastError());
}

#ifdef PAIR_STATS_PHASES
// The phase stamps of the last launch's first kPhaseBlocks blocks (block
// y * tiles + x, 8 a block, 0 where a block did not reach a phase), into
// host memory of kPhaseBlocks * 8 unsigned 64-bit words; and their reset.
int pair_stats_phase_read(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, pair_stats_phase_stamps, sizeof(pair_stats_phase_stamps)));
}
int pair_stats_phase_clear() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, pair_stats_phase_stamps);
  if (err == cudaSuccess)
    err = cudaMemset(p, 0, sizeof(pair_stats_phase_stamps));
  return static_cast<int>(err);
}
int pair_stats_phase_blocks() { return kPhaseBlocks; }
#endif

}  // extern "C"
