// LayerNorm backward past ln_bwd_any's widths (layer_norm_bwd.cu has the
// rungs and ln_bwd_any, layer_norm_bwd.cuh what they share): rows of more
// than 1024 16-byte vectors (bf16 D > 8192, f32 D > 4096) or of more than
// 4096 elements off the vector. Replaces, at these widths, `_ln_bwd_kernel`
// (chestxray_vit_tpu/ops/layer_norm.py, launched by `_bwd_pallas`), which
// holds a block of whole rows in VMEM and sums the parameter gradients
// across its sequential grid in scratch.
//
// What bounds it on an H100: bandwidth (x and dy in, dx out: 249 MB at
// [4616, 9000] bf16, 0.074 ms at 3.35 TB/s), so each row should be read
// once and the dscale / dbias sums kept on chip, as ln_bwd_any does; but a
// block's registers hold at most 1024 vectors of a row beside the next row
// in flight. A Hopper thread block cluster of k = ceil(D / that width)
// blocks, 2 to 8, holds a row of whole vectors instead (ln_bwd_cluster):
// each block a fixed slice of the columns in registers (3 or 4 vectors a
// thread), the next rows of that slice staged in shared memory by cp.async
// (so that the bytes in flight cost no registers), and its slice of the
// scale in shared memory; the two row reductions across the cluster
// through distributed shared memory with one cluster barrier each, the
// sums in registers across all of a cluster's rows and written once into
// its row of an [n_clusters, 2, D] workspace that the column pass adds. No
// atomics: every sum is taken in a fixed order.
//
// Rows off the vector (a register holds one element there, so a cluster
// keeps too few bytes in flight: 0.189 device ms at [4616, 4100] bf16
// against 0.150 for the two passes) and rows past a cluster of eight (bf16
// D > 65536 in whole vectors, f32 D > 32768; no model reaches them) take
// two passes, at any width: ln_bwd_stats (a block a row: mean, rstd,
// mean(g) and mean(g x_hat), four f32 a row after the workspace's
// partials) and ln_bwd_tiles (column slices times ranges of rows: dx, and
// each range's sums in registers, written once). They read x and dy three
// times.

#include "layer_norm_bwd.cuh"

namespace {

using namespace cxr::ln;

constexpr int kMaxCluster = 8;  // the portable cluster size

// Thread block clusters (sm_90, 1-D grids): this block's rank in its
// cluster, the cluster's size, its index and the clusters of the grid.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ long long cluster_index() {
  uint32_t r;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ long long cluster_count() {
  uint32_t r;
  asm("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}
// The cluster barrier in two halves: arrive releases this thread's writes
// to shared memory; wait returns once every thread of every block of the
// cluster has arrived, and acquires their writes.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
// The float2 at `mine`'s place in the shared memory of block `rank` of
// this cluster (distributed shared memory).
__device__ __forceinline__ float2 load_from_rank(const float2* mine,
                                                 int rank) {
  const uint32_t local =
      static_cast<uint32_t>(__cvta_generic_to_shared(mine));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// A thread's dscale and dbias sums of piece p (E columns) into the [2, D]
// workspace row pr.
template <int E>
__device__ __forceinline__ void store_sums(float* pr, int D, int p,
                                           const float (&ds)[E],
                                           const float (&db)[E]) {
  if constexpr (E == 1) {
    pr[p] = ds[0];
    pr[D + p] = db[0];
  } else {
#pragma unroll
    for (int h = 0; h < E / 4; ++h) {
      reinterpret_cast<float4*>(pr + p * E)[h] = make_float4(
          ds[4 * h], ds[4 * h + 1], ds[4 * h + 2], ds[4 * h + 3]);
      reinterpret_cast<float4*>(pr + D + p * E)[h] = make_float4(
          db[4 * h], db[4 * h + 1], db[4 * h + 2], db[4 * h + 3]);
    }
  }
}

// Rows a cluster's blocks stage ahead of the row in hand, and the blocks
// each SM should hold (a block of 4 vectors a thread holds more than half
// an SM's registers).
constexpr int kStages = 3;
template <int V>
constexpr int kClusterMinBlocks = V < 4 ? 2 : 1;

// The cluster form's dynamic shared memory: the block's slice of the scale
// (span pieces), then kStages rows of x and dy, V 16-byte pieces of each a
// thread of nt.
template <typename W, int E, int V>
__host__ __device__ constexpr int cluster_smem(int span, int nt) {
  return (span * E * static_cast<int>(sizeof(W)) + 15) / 16 * 16 +
         kStages * 2 * V * nt * 16;
}

// A cluster of k blocks a row of whole vectors: block r of the cluster
// owns pieces [r span, (r + 1) span) of every row, V vectors a thread in
// AnyRows' block layout. Each thread stages its own pieces of x and dy of
// the next kStages rows in shared memory by cp.async (16 bytes a copy, one
// commit group a row, no registers held), reads the row in hand into
// registers once it has landed and, once its first sums have used them,
// starts the copies of the row kStages on into the same slots; its
// columns of the scale sit in shared memory. Each reduction adds the
// warps' partials of all k blocks through distributed shared memory after
// one cluster barrier: two buffers in turn, so that the barrier of one
// reduction orders the reads of the buffer before it against the writes
// of the one after it, and dbias's sums are taken between its arrive and
// its wait. Every warp adds the k * warps partials in one fixed order
// (partial w of rank r is slot 8 r + w; lane l adds slots l and l + 32,
// then the butterfly), so every block gets the same bits, run after run.
// Each thread's dscale / dbias sums of its own columns stay in registers
// across all its rows and are written once into its cluster's row of the
// [n_clusters, 2, D] workspace; a last arrive / wait keeps every block's
// shared memory alive until the other blocks' reads of it are done.
template <typename T, typename W, int V>
__global__ void __launch_bounds__(kAnyThreads, (kClusterMinBlocks<V>))
ln_bwd_cluster(const T* __restrict__ x, const W* __restrict__ scale,
               const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ part, long long rows, int D, int span,
               float eps) {
  using R = Piece<T, true>;
  constexpr int E = R::kE, kWd = R::kWords;
  using Q = Params<W, E>;  // the scale's pieces, from shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  W* s_scale = reinterpret_cast<W*>(smem);  // the block's columns
  __shared__ float2 s_part[2][kAnyWarps];   // the warps' partial sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = blockDim.x, nw = nt >> 5;
  // this thread's slots after the scale: [stage][x, dy][piece][thread]
  const uint32_t slots = cxr::smem_addr(smem) +
                         cluster_smem<W, E, 0>(span, nt) + 16 * threadIdx.x;
  auto slot = [&](int stage, int t, int i) {
    return slots + static_cast<uint32_t>(((stage * 2 + t) * V + i) * nt * 16);
  };
  const int k = cluster_size();
  const int first = cluster_rank() * span;  // the block's first piece
  const int np = min(D / E - first, span);  // and its count
  const long long col = static_cast<long long>(first) * E;
  x += col;  // the block's columns from here on
  dy += col;
  dx += col;
  scale += col;
  const long long step = cluster_count();
  long long row = cluster_index();

  auto stage_row = [&](long long r, int stage) {  // one commit group
    if (r < rows) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int p = threadIdx.x + i * nt;
        if (p < np) {
          cxr::cp_async_16(slot(stage, 0, i), x + r * D + p * E, true);
          cxr::cp_async_16(slot(stage, 1, i), dy + r * D + p * E, true);
        }
      }
    }
    cxr::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) stage_row(row + st * step, st);
  for (int c = threadIdx.x; c < np * E; c += nt) s_scale[c] = scale[c];
  __syncthreads();

  int buf = 0;
  auto row_sum2 = [&](float& a, float& b, auto&& meanwhile) {
    warp_sum2(a, b);
    if (lane == 0) s_part[buf][warp] = make_float2(a, b);
    __syncwarp();
    cluster_arrive();
    meanwhile();
    cluster_wait();
    a = b = 0.f;
    for (int s = lane; s < k * kAnyWarps; s += 32) {  // rank * 8 + warp
      if ((s & (kAnyWarps - 1)) < nw) {
        const float2 v =
            load_from_rank(&s_part[buf][s & (kAnyWarps - 1)], s / kAnyWarps);
        a += v.x;
        b += v.y;
      }
    }
    warp_sum2(a, b);
    buf ^= 1;
  };

  float ds[V][E], db[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int j = 0; j < E; ++j) ds[i][j] = db[i][j] = 0.f;

  int stage = 0;
  for (; row < rows; row += step) {  // uniform over the cluster
    cxr::cp_async_wait<kStages - 1>();  // this row's copies have landed
    uint32_t cx[V][kWd], cg[V][kWd];
    float sx = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = threadIdx.x + i * nt;
      if (p < np) {
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(cx[i][0]), "=r"(cx[i][1]), "=r"(cx[i][2]),
                       "=r"(cx[i][3])
                     : "r"(slot(stage, 0, i)));
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(cg[i][0]), "=r"(cg[i][1]), "=r"(cg[i][2]),
                       "=r"(cg[i][3])
                     : "r"(slot(stage, 1, i)));
        uint32_t sv[Q::kWords];
        Q::load(s_scale, p, sv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          sx += R::at(cx[i], j);
          sg += R::at(cg[i], j) * Q::at(sv, j);
        }
      }
    }
    // every piece of the row in hand is in registers and used (the sums
    // are formed before the copies start): its slots take the row kStages
    // on
    asm volatile("" ::"f"(sx), "f"(sg));
    stage_row(row + kStages * step, stage);
    stage = stage + 1 < kStages ? stage + 1 : 0;
    row_sum2(sx, sg, [&] {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (threadIdx.x + i * nt < np) {
#pragma unroll
          for (int j = 0; j < E; ++j) db[i][j] += R::at(cg[i], j);
        }
      }
    });
    const float mean = sx / D;
    float sq = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = threadIdx.x + i * nt;
      if (p < np) {
        uint32_t sv[Q::kWords];
        Q::load(s_scale, p, sv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float d = R::at(cx[i], j) - mean;
          sq += d * d;
          sgx += R::at(cg[i], j) * Q::at(sv, j) * d;
        }
      }
    }
    row_sum2(sq, sgx, [] {});
    const float rstd = rsqrtf(sq / D + eps);
    const float mg = sg / D, mgx = sgx * rstd / D;  // mean(g), mean(g x_hat)
    T* dxr = dx + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = threadIdx.x + i * nt;
      if (p < np) {
        float o[E];
        uint32_t sv[Q::kWords];
        Q::load(s_scale, p, sv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float xh = (R::at(cx[i], j) - mean) * rstd;
          const float gy = R::at(cg[i], j);
          ds[i][j] += gy * xh;
          o[j] = (gy * Q::at(sv, j) - mg - xh * mgx) * rstd;
        }
        R::store(dxr, p, o);
      }
    }
  }
  cxr::cp_async_wait<0>();  // the groups past the last row are empty

  cluster_arrive();  // this block reads no other block's shared memory now
  float* pr = part + cluster_index() * 2 * D + col;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int p = threadIdx.x + i * nt;
    if (p < np) store_sums<E>(pr, D, p, ds[i], db[i]);
  }
  cluster_wait();  // nor does any other block read this one's
}

// Pieces a thread of the column-tiled pass: 2 vectors, or 8 elements off
// the vector.
template <bool kVec>
constexpr int kTilePieces = kVec ? 2 : 8;

// The two-pass form's row statistics: a block a row (rows walked by the
// grid), its x and dy read twice (the second time mostly from L2), mean
// and var two-pass centred; writes mean, rstd, mean(g) and mean(g x_hat)
// as four f32 a row.
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kAnyThreads)
ln_bwd_stats(const T* __restrict__ x, const W* __restrict__ scale,
             const T* __restrict__ dy, float* __restrict__ stats,
             long long rows, int D, float eps) {
  using R = Piece<T, kVec>;
  constexpr int E = R::kE;
  __shared__ float red[2 * kAnyWarps];
  const int np = D / E;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float sx = 0.f, sg = 0.f;
    for (int p = threadIdx.x; p < np; p += kAnyThreads) {
      float xv[E], gv[E];
      R::load(xr, p, xv);
      R::load(gr, p, gv);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        sx += xv[j];
        sg += gv[j] * cxr::to_f32(scale[p * E + j]);
      }
    }
    block_sum2(sx, sg, red);
    const float mean = sx / D;
    float sq = 0.f, sgx = 0.f;
    for (int p = threadIdx.x; p < np; p += kAnyThreads) {
      float xv[E], gv[E];
      R::load(xr, p, xv);
      R::load(gr, p, gv);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float d = xv[j] - mean;
        sq += d * d;
        sgx += gv[j] * cxr::to_f32(scale[p * E + j]) * d;
      }
    }
    block_sum2(sq, sgx, red);
    if (threadIdx.x == 0) {
      const float rstd = rsqrtf(sq / D + eps);
      float* st = stats + 4 * row;
      st[0] = mean;
      st[1] = rstd;
      st[2] = sg / D;
      st[3] = sgx * rstd / D;
    }
  }
}

// The two-pass form's column-tiled pass: the grid is n_slices column
// slices (kTilePieces * 256 pieces each) times the workspace's rows, each a
// contiguous range of rows. A block walks its range, writes dx from the
// rows' statistics, keeps its columns' dscale / dbias sums (and its scale
// values) in registers, and writes the sums once into its range's row.
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kAnyThreads)
ln_bwd_tiles(const T* __restrict__ x, const W* __restrict__ scale,
             const T* __restrict__ dy, T* __restrict__ dx,
             const float* __restrict__ stats, float* __restrict__ part,
             long long rows, int D, int n_slices) {
  using R = Piece<T, kVec>;
  constexpr int E = R::kE, kP = kTilePieces<kVec>;
  const int np = D / E;
  const long long range = blockIdx.x / n_slices;
  const long long per = (rows + gridDim.x / n_slices - 1) /
                        (gridDim.x / n_slices);  // rows a range
  const long long r0 = range * per;
  const long long r1 = r0 + per < rows ? r0 + per : rows;
  const int first =
      static_cast<int>(blockIdx.x % n_slices) * kP * kAnyThreads +
      threadIdx.x;  // pieces first + i * 256
  float sv[kP][E], ds[kP][E], db[kP][E];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int p = first + i * kAnyThreads;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      sv[i][j] = p < np ? cxr::to_f32(scale[p * E + j]) : 0.f;
      ds[i][j] = db[i][j] = 0.f;
    }
  }
  for (long long r = r0; r < r1; ++r) {
    const float* st = stats + 4 * r;
    const float mean = st[0], rstd = st[1], mg = st[2], mgx = st[3];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int p = first + i * kAnyThreads;
      if (p < np) {
        float xv[E], gv[E];
        R::load(x + r * D, p, xv);
        R::load(dy + r * D, p, gv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float xh = (xv[j] - mean) * rstd;
          ds[i][j] += gv[j] * xh;
          db[i][j] += gv[j];
          xv[j] = (gv[j] * sv[i][j] - mg - xh * mgx) * rstd;
        }
        R::store(dx + r * D, p, xv);
      }
    }
  }
  float* pr = part + range * 2 * D;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int p = first + i * kAnyThreads;
    if (p < np) store_sums<E>(pr, D, p, ds[i], db[i]);
  }
}

// ln_bwd_cluster at k blocks a cluster and span pieces a block, then the
// column pass; or its wave, in clusters. A refused launch (say
// cudaErrorClusterOutOfResources) is returned as it is.
template <typename T, typename W, int V>
cudaError_t run_bwd_cluster(const BwdCall& c, int k, int span) {
  constexpr int E = Piece<T, true>::kE;
  auto* kernel = ln_bwd_cluster<T, W, V>;
  static bool opted_in[64] = {};  // the most shared memory it may take
  if (c.device < 0 || c.device >= 64) return cudaErrorInvalidValue;
  if (!opted_in[c.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        cluster_smem<W, E, V>(V * kAnyThreads, kAnyThreads));
    if (err != cudaSuccess) return err;
    opted_in[c.device] = true;
  }
  const int threads = ((span + V - 1) / V + 31) / 32 * 32;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = k;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.wave ? k : c.n_blocks * k);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = cluster_smem<W, E, V>(span, threads);
  cfg.stream = c.st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (c.wave) return cudaOccupancyMaxActiveClusters(c.wave, kernel, &cfg);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(c.x),
      static_cast<const W*>(c.scale), static_cast<const T*>(c.dy),
      static_cast<T*>(c.dx), c.part, c.rows, c.d, span, c.eps);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_cols<W>(c);
}

// The two-pass form: ln_bwd_stats into the [rows, 4] statistics after the
// [n_blocks, 2, d] partials, ln_bwd_tiles over n_blocks ranges of rows,
// then the column pass; or its wave, in ranges (the resident blocks of
// ln_bwd_tiles over its column slices).
template <typename T, typename W, bool kVec>
cudaError_t run_bwd_two_pass(const BwdCall& c) {
  constexpr int kSlice = kTilePieces<kVec> * kAnyThreads;
  const int slices = (c.d / Piece<T, kVec>::kE + kSlice - 1) / kSlice;
  if (c.wave) {
    static int cache[64] = {};
    int blocks = 0;
    const cudaError_t err = wave_of(ln_bwd_tiles<T, W, kVec>, kAnyThreads,
                                    0, c.device, cache, &blocks);
    *c.wave = blocks / slices > 1 ? blocks / slices : 1;
    return err;
  }
  const long long grid = static_cast<long long>(slices) * c.n_blocks;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  float* stats = c.part + static_cast<long long>(c.n_blocks) * 2 * c.d;
  ln_bwd_stats<T, W, kVec>
      <<<static_cast<int>(c.rows < 65535 ? c.rows : 65535), kAnyThreads, 0,
         c.st>>>(static_cast<const T*>(c.x), static_cast<const W*>(c.scale),
                 static_cast<const T*>(c.dy), stats, c.rows, c.d, c.eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_tiles<T, W, kVec><<<static_cast<int>(grid), kAnyThreads, 0, c.st>>>(
      static_cast<const T*>(c.x), static_cast<const W*>(c.scale),
      static_cast<const T*>(c.dy), static_cast<T*>(c.dx), stats, c.part,
      c.rows, c.d, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_cols<W>(c);
}

}  // namespace

namespace cxr {
namespace ln {

// Past ln_bwd_any's widths: whole vectors k = ceil(vectors / 1024) blocks
// a cluster, 2 to 8, each 3 or 4 vectors a thread; past 8, and any row off
// the vector, the two-pass form.
template <typename T, typename W, bool kVec>
cudaError_t run_bwd_wide(const BwdCall& c) {
  if constexpr (kVec) {
    constexpr int kHeld = 4 * kAnyThreads;
    const int np = c.d / Piece<T, true>::kE;
    const int k = (np + kHeld - 1) / kHeld;
    if (k <= kMaxCluster) {
      const int span = (np + k - 1) / k;
      if (span <= 3 * kAnyThreads)
        return run_bwd_cluster<T, W, 3>(c, k, span);
      return run_bwd_cluster<T, W, 4>(c, k, span);
    }
  }
  return run_bwd_two_pass<T, W, kVec>(c);
}

#define CXR_LN_BWD_WIDE(T, W)                                      \
  template cudaError_t run_bwd_wide<T, W, true>(const BwdCall&); \
  template cudaError_t run_bwd_wide<T, W, false>(const BwdCall&);
CXR_LN_BWD_WIDE(__nv_bfloat16, __nv_bfloat16)
CXR_LN_BWD_WIDE(__nv_bfloat16, float)
CXR_LN_BWD_WIDE(float, float)
CXR_LN_BWD_WIDE(float, __nv_bfloat16)
#undef CXR_LN_BWD_WIDE

}  // namespace ln
}  // namespace cxr
