// LayerNorm over the last dim, forward and backward, f32 statistics.
//
// Forward: y = (x - mean) * rsqrt(var + eps) * scale + bias, f32 mean and
// centered variance, output in x's dtype. Replaces the TPU kernel
// chestxray_vit_tpu/ops/layer_norm.py `_ln_fwd_kernel` (launched by
// `_forward_pallas`), which normalises 256-row blocks resident in VMEM after
// padding the rows to a block multiple. Here a warp owns a row at a time:
// it reads the row once with 16-byte vector loads into registers, reduces
// the sum and then the centered sum of squares with warp shuffles (the
// two-pass form of `_ln_fwd_kernel`, not E[x^2] - mean^2), and writes the
// row once. Rows are B * S with no padding. The registers are sized to D
// (template V, dispatched from D as the backward is), the warp's scale and
// bias columns are read once into registers as 16-byte vectors, and each
// warp walks rows with the next row's loads issued before the current
// row's reductions.
//
// Backward: dx = (g - mean(g) - x_hat * mean(g * x_hat)) * rstd with
// g = dy * scale, and dscale = sum over rows of dy * x_hat, dbias = sum of
// dy. Replaces `_ln_bwd_kernel` (launched by `_bwd_pallas`), which sums the
// parameter gradients across a *sequential* row-block grid in VMEM scratch.
// Hopper blocks run in no order, so the sum over rows is taken in an order
// fixed by block and warp index: each warp of a block walks rows (one wave
// of resident blocks), keeping x and dy as packed words and its lanes'
// dscale / dbias columns as f32 sums in registers, with the next row's
// loads issued before the current row's reductions (mean and var recomputed
// as the custom VJP of the JAX package does: sum x with sum g in one
// butterfly, then the centered sum of squares with sum g * (x - mean)); the
// scale sits in shared memory. The block's warps combine in a fixed tree
// through shared memory and write one f32 [2, D] partial into a
// [n_blocks, 2, D] workspace; a column pass (`ln_bwd_cols`: 32 columns a
// block, its warps each summing a fixed share of the partials as 128-byte
// rows, then in warp order) adds them and casts to the scale's dtype. No
// atomics, so the result is the same from run to run.
//
// What bounds both on an H100: pure bandwidth. A [36 * 577, 768] bf16 call
// moves 32 MB in and 32 MB out (forward) or 64 MB in and 32 MB out
// (backward) at ~10-20 flops per element, far below the card's ~295
// flop/byte ridge, so the design goal is one read of each input and one
// write of each output with no shared-memory round trip, and enough bytes
// in flight to cover the memory's latency: two rows a warp and as many
// warps an SM as registers sized to D allow (in the backward at D = 768,
// two blocks of eight warps). The backward's workspace is ~1.6 MB.
//
// D up to 2048 in both dtypes. In bf16 that is eight 16-byte vectors a
// lane; an f32 row of more than 1024 columns (ViT-H/14's 1280) takes up to
// sixteen, and then a lane's row, next row, scale and bias (forward) or
// x, dy, their next row and its dscale / dbias sums (backward) no longer
// fit in registers. Those rungs (kBig) keep one row a warp in flight, read
// the forward's scale and bias where they are used (L1 hits: every warp
// reads the same), and keep the backward's per-warp sums in shared memory
// (lane-minor, so no bank conflicts), which the fixed tree then adds in
// place. The f32 path serves parity runs; the rungs up to eight vectors
// are unchanged.
//
// Any other D (wider than 2048, or not a whole number of 16-byte vectors,
// which the JAX kernels take as one block too): the forward runs ln_fwd_any,
// a block a row at a time (a wave of blocks walks the rows), reading it from
// L1 / L2 once a pass (the sum, the centered sum of squares, the output:
// the two-pass statistics of the rungs), in 16-byte vectors when D is a
// whole number of them, else element by element. The backward runs
// ln_bwd_any, which keeps what the rungs keep on chip at any width its
// rows fit in registers: a row of whole vectors (D past 2048) is owned by a
// block, 2 to 4 vectors a thread (bf16 D <= 8192, f32 D <= 4096), a row off
// the vector by a warp (up to 256 elements) or a block (up to 4096); the
// row's x and dy are read from device memory once into registers, the
// next row's loads are issued before the current row's two reductions
// (the block form's through shared memory, one barrier each), the scale is
// read once a block into shared memory, and each thread's dscale / dbias
// sums of its own columns stay in registers across all its rows and are
// written once a block into the [n_blocks, 2, D] workspace that the same
// column pass adds. So the kernel moves x, dy and dx once, and the
// workspace, one wave of rows, is written once. Wider rows take
// ln_bwd_rowloop (a block a row read once a pass, its sums in its own row
// of the workspace).

#include "common.cuh"

namespace {

using cxr::from_f32;
using cxr::warp_sum;

constexpr int kMaxVecs = 8;          // vectors per lane held with the next row
constexpr int kMaxD = 2048;          // the widest row the rungs take
constexpr int kFwdWarps = 4;         // forward: warps of a block
constexpr int kBwdWarps = 8;         // backward: warps of a block
constexpr int kColWarps = 32;        // column pass: warps of a block

// Element j of a vector of X held as 32-bit words (f32: one a word; bf16:
// two, the lower address in the low half), as a float (exact).
template <typename X>
__device__ __forceinline__ float elem(const uint32_t* w, int j) {
  if constexpr (sizeof(X) == 4)
    return __uint_as_float(w[j]);
  else
    return (j & 1) ? cxr::bf16_hi(w[j >> 1]) : cxr::bf16_lo(w[j >> 1]);
}

// The kWords 32-bit words at p (8, 16 or 32 bytes, as aligned), in 16-byte
// loads or one 8-byte load.
template <int kWords>
__device__ __forceinline__ void load_words(const void* p,
                                           uint32_t (&w)[kWords]) {
  if constexpr (kWords == 2) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x;
    w[1] = r.y;
  } else {
    static_assert(kWords % 4 == 0, "8, 16 or 32 bytes");
#pragma unroll
    for (int h = 0; h < kWords / 4; ++h) {
      const uint4 r = reinterpret_cast<const uint4*>(p)[h];
      w[4 * h] = r.x;
      w[4 * h + 1] = r.y;
      w[4 * h + 2] = r.z;
      w[4 * h + 3] = r.w;
    }
  }
}

// o[0 .. 16 / sizeof(T)) rounded to T, stored as one 16-byte vector at p.
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* o) {
  uint4 out;
  if constexpr (sizeof(T) == 4)
    out = make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                     __float_as_uint(o[2]), __float_as_uint(o[3]));
  else
    out = make_uint4(cxr::pack_bf16x2(o[0], o[1]), cxr::pack_bf16x2(o[2], o[3]),
                     cxr::pack_bf16x2(o[4], o[5]), cxr::pack_bf16x2(o[6], o[7]));
  *reinterpret_cast<uint4*>(p) = out;
}

// Two warp sums in one butterfly.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// V = 16-byte vectors per lane (ceil(D / E / 32)), so that a row, the next
// row, the scale and the bias all stay in registers sized to D, as packed
// words (a bf16 value is widened where it is used). Each warp walks rows (a
// grid of one wave of resident blocks): scale and bias are read once, and
// the next row's loads are issued before the current row's two reductions,
// so two rows a warp are in flight.
template <typename T, typename W, int V>
__global__ void __launch_bounds__(32 * kFwdWarps)
ln_fwd(const T* __restrict__ x, const W* __restrict__ scale,
       const W* __restrict__ bias, T* __restrict__ y, long long rows, int D,
       float eps) {
  constexpr int E = 16 / sizeof(T);               // elements per vector
  constexpr int kW = E * sizeof(W) / 4;           // words of E parameters
  constexpr bool kBig = V > kMaxVecs;  // scale, bias read where used
  constexpr int kHeld = kBig ? 1 : V;  // their vectors held in registers
  const int lane = threadIdx.x & 31;
  const int nvec = D / E;

  uint32_t sw[kHeld][kW], bw[kHeld][kW];
  if constexpr (!kBig) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        load_words(scale + vi * E, sw[i]);
        load_words(bias + vi * E, bw[i]);
      }
    }
  }

  const long long step = static_cast<long long>(gridDim.x) * kFwdWarps;
  long long row =
      static_cast<long long>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5);
  uint32_t cur[V][4];
  auto fetch = [&](long long r, uint32_t (&raw)[V][4]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) load_words(x + r * D + vi * E, raw[i]);
    }
  };
  if (row < rows) fetch(row, cur);
  for (; row < rows; row += step) {
    uint32_t nxt[kBig ? 1 : V][4];
    if constexpr (!kBig)
      if (row + step < rows) fetch(row + step, nxt);

    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + i * 32 < nvec)
#pragma unroll
        for (int j = 0; j < E; ++j) sum += elem<T>(cur[i], j);
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + i * 32 < nvec)
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float d = elem<T>(cur[i], j) - mean;
          sq += d * d;
        }
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
    T* yr = y + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        float o[E];
        if constexpr (kBig) {
          uint32_t swb[kW], bwb[kW];
          load_words(scale + vi * E, swb);
          load_words(bias + vi * E, bwb);
#pragma unroll
          for (int j = 0; j < E; ++j)
            o[j] = (elem<T>(cur[i], j) - mean) * rstd * elem<W>(swb, j) +
                   elem<W>(bwb, j);
        } else {
#pragma unroll
          for (int j = 0; j < E; ++j)
            o[j] = (elem<T>(cur[i], j) - mean) * rstd * elem<W>(sw[i], j) +
                   elem<W>(bw[i], j);
        }
        store_vec(yr + vi * E, o);
      }
    }
    if constexpr (kBig) {
      if (row + step < rows) fetch(row + step, cur);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int w = 0; w < 4; ++w) cur[i][w] = nxt[i][w];
    }
  }
}

// The backward's layout at V 16-byte vectors a lane.
template <typename T, typename W, int V>
struct Bwd {
  static constexpr int E = 16 / sizeof(T);      // elements per vector
  static constexpr int kW = E * sizeof(W) / 4;  // words of E scale values
  static constexpr int kAcc = 2 * V * E;        // a lane's dscale, dbias sums
  // kBig: no next row in flight, and the sums in shared memory
  static constexpr bool kBig = V > kMaxVecs;
  // Two blocks an SM (at most 128 registers a thread) where the row in
  // hand, the next row (x and dy, packed) and the sums take at most 96.
  static constexpr int kMinBlocks = !kBig && 16 * V + kAcc <= 96 ? 2 : 1;
  // Dynamic shared memory: the scale, then the slots of the warps' sums,
  // lane-minor ([slot][kAcc][32] floats): kBwdWarps / 2 for the tree, or
  // one a warp where the sums live there (kBig).
  static constexpr int kSlots = kBig ? kBwdWarps : kBwdWarps / 2;
  __host__ __device__ static constexpr int scale_bytes(int d) {
    return (d * static_cast<int>(sizeof(W)) + 15) / 16 * 16;
  }
  __host__ __device__ static constexpr int smem(int d) {
    return scale_bytes(d) + kSlots * kAcc * 32 * 4;
  }
  static constexpr int kMaxD = 32 * V * E;
};

template <typename T, typename W, int V>
__global__ void __launch_bounds__(32 * kBwdWarps, (Bwd<T, W, V>::kMinBlocks))
ln_bwd(const T* __restrict__ x, const W* __restrict__ scale,
       const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
       long long rows, int D, float eps) {
  using L = Bwd<T, W, V>;
  constexpr int E = L::E, kAcc = L::kAcc;
  constexpr bool kBig = L::kBig;
  constexpr int kReg = kBig ? 1 : V;  // vectors of sums and of the next row
  extern __shared__ __align__(16) unsigned char smem[];
  W* s_scale = reinterpret_cast<W*>(smem);
  float* s_tree = reinterpret_cast<float*>(smem + L::scale_bytes(D));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D / E;
  // kBig: this warp's sums, [kAcc][32] lane-minor (dscale, then dbias)
  float* s_mine = s_tree + warp * kAcc * 32 + lane;

  const long long step = static_cast<long long>(gridDim.x) * kBwdWarps;
  long long row = static_cast<long long>(blockIdx.x) * kBwdWarps + warp;
  uint32_t cx[V][4], cg[V][4];
  auto fetch = [&](long long r, uint32_t (&xw)[V][4], uint32_t (&gw)[V][4]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        load_words(x + r * D + vi * E, xw[i]);
        load_words(dy + r * D + vi * E, gw[i]);
      }
    }
  };
  if (row < rows) fetch(row, cx, cg);  // in flight while the scale is read

  for (int c = threadIdx.x; c < D; c += blockDim.x) s_scale[c] = scale[c];
  if constexpr (kBig) {
#pragma unroll
    for (int a = 0; a < kAcc; ++a) s_mine[a * 32] = 0.f;
  }
  __syncthreads();

  float ds[kReg][E], db[kReg][E];
#pragma unroll
  for (int i = 0; i < kReg; ++i)
#pragma unroll
    for (int j = 0; j < E; ++j) ds[i][j] = db[i][j] = 0.f;

  for (; row < rows; row += step) {
    uint32_t nx[kReg][4], ng[kReg][4];
    if constexpr (!kBig)
      if (row + step < rows) fetch(row + step, nx, ng);

    float sx = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        uint32_t sw[L::kW];
        load_words(s_scale + vi * E, sw);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          sx += elem<T>(cx[i], j);
          sg += elem<T>(cg[i], j) * elem<W>(sw, j);
        }
      }
    }
    warp_sum2(sx, sg);
    const float mean = sx / D;
    float sq = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        uint32_t sw[L::kW];
        load_words(s_scale + vi * E, sw);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float d = elem<T>(cx[i], j) - mean;
          sq += d * d;
          sgx += elem<T>(cg[i], j) * elem<W>(sw, j) * d;
        }
      }
    }
    warp_sum2(sq, sgx);
    const float rstd = rsqrtf(sq / D + eps);
    const float mg = sg / D, mgx = sgx * rstd / D;  // mean(g), mean(g x_hat)
    T* dxr = dx + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        uint32_t sw[L::kW];
        load_words(s_scale + vi * E, sw);
        float o[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float xh = (elem<T>(cx[i], j) - mean) * rstd;
          const float gy = elem<T>(cg[i], j);
          if constexpr (kBig) {
            s_mine[(i * E + j) * 32] += gy * xh;
            s_mine[((V + i) * E + j) * 32] += gy;
          } else {
            ds[i][j] += gy * xh;
            db[i][j] += gy;
          }
          o[j] = (gy * elem<W>(sw, j) - mg - xh * mgx) * rstd;
        }
        store_vec(dxr + vi * E, o);
      }
    }
    if constexpr (kBig) {
      if (row + step < rows) fetch(row + step, cx, cg);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          cx[i][w] = nx[i][w];
          cg[i][w] = ng[i][w];
        }
    }
  }

  // The block's sums, warps combined in a fixed tree: at each level the
  // upper half of the warps still holding sums writes to shared memory and
  // the lower half adds them (warp w + half into warp w). kBig: the sums
  // are in shared memory already, and warp w adds warp w + half's in place.
  if constexpr (kBig) {
    __syncthreads();
#pragma unroll
    for (int half = kBwdWarps / 2; half > 0; half /= 2) {
      if (warp < half) {
        const float* other = s_mine + half * kAcc * 32;
#pragma unroll 8
        for (int a = 0; a < kAcc; ++a) s_mine[a * 32] += other[a * 32];
      }
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int half = kBwdWarps / 2; half > 0; half /= 2) {
      float* slot = s_tree + (warp & (half - 1)) * kAcc * 32 + lane;
      if (warp >= half && warp < 2 * half) {
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int j = 0; j < E; ++j) {
            slot[(i * E + j) * 32] = ds[i][j];
            slot[((V + i) * E + j) * 32] = db[i][j];
          }
      }
      __syncthreads();
      if (warp < half) {
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int j = 0; j < E; ++j) {
            ds[i][j] += slot[(i * E + j) * 32];
            db[i][j] += slot[((V + i) * E + j) * 32];
          }
      }
      __syncthreads();
    }
  }
  if (warp == 0) {
    float* pr = part + static_cast<long long>(blockIdx.x) * 2 * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        float sd[E], sb[E];
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if constexpr (kBig) {
            sd[j] = s_mine[(i * E + j) * 32];
            sb[j] = s_mine[((V + i) * E + j) * 32];
          } else {
            sd[j] = ds[i][j];
            sb[j] = db[i][j];
          }
        }
#pragma unroll
        for (int h = 0; h < E / 4; ++h) {
          reinterpret_cast<float4*>(pr + vi * E)[h] =
              make_float4(sd[4 * h], sd[4 * h + 1], sd[4 * h + 2],
                          sd[4 * h + 3]);
          reinterpret_cast<float4*>(pr + D + vi * E)[h] =
              make_float4(sb[4 * h], sb[4 * h + 1], sb[4 * h + 2],
                          sb[4 * h + 3]);
        }
      }
    }
  }
}

// dscale and dbias from the [n_blocks, 2 * D] partials: a block owns 32
// columns; warp w sums partials w, w + kColWarps, ... in order (each a
// 128-byte row piece), then warp 0 adds the warps' sums in warp order.
template <typename W>
__global__ void __launch_bounds__(32 * kColWarps)
ln_bwd_cols(const float* __restrict__ part, int n_blocks, int D,
            W* __restrict__ dscale, W* __restrict__ dbias) {
  __shared__ float s_sum[kColWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < 2 * D) {
#pragma unroll 4
    for (int b = warp; b < n_blocks; b += kColWarps)
      acc += part[static_cast<long long>(b) * 2 * D + c];
  }
  s_sum[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < 2 * D) {
    float t = s_sum[0][lane];
#pragma unroll
    for (int w = 1; w < kColWarps; ++w) t += s_sum[w][lane];
    if (c < D)
      dscale[c] = from_f32<W>(t);
    else
      dbias[c - D] = from_f32<W>(t);
  }
}

// ---------------------------------------------------------------------------
// Any D: a block a row at a time
// ---------------------------------------------------------------------------

constexpr int kAnyThreads = 256;
constexpr int kAnyWarps = kAnyThreads / 32;

// Piece p of a row: with kVec a 16-byte vector (E elements), else one
// element; as raw 32-bit words (the element in the low bits of a word) or
// as floats.
template <typename T, bool kVec>
struct Piece {
  static constexpr int kE = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  static constexpr int kWords = kVec ? 4 : 1;
  __device__ __forceinline__ static void load(const T* row, int p,
                                              uint32_t (&w)[kWords]) {
    if constexpr (kVec)
      load_words(row + p * kE, w);
    else if constexpr (sizeof(T) == 4)
      w[0] = __float_as_uint(row[p]);
    else
      w[0] = static_cast<uint32_t>(__bfloat16_as_ushort(row[p]));
  }
  __device__ __forceinline__ static float at(const uint32_t (&w)[kWords],
                                             int j) {
    if constexpr (kVec)
      return elem<T>(w, j);
    else if constexpr (sizeof(T) == 4)
      return __uint_as_float(w[0]);
    else
      return cxr::bf16_lo(w[0]);
  }
  __device__ __forceinline__ static void load(const T* row, int p,
                                              float (&v)[kE]) {
    uint32_t w[kWords];
    load(row, p, w);
#pragma unroll
    for (int j = 0; j < kE; ++j) v[j] = at(w, j);
  }
  __device__ __forceinline__ static void store(T* row, int p,
                                               const float (&v)[kE]) {
    if constexpr (kVec)
      store_vec(row + p * kE, v);
    else
      row[p] = from_f32<T>(v[0]);
  }
};

// The block's sums of a and b (every thread gets them), in a fixed order:
// warp sums, then warp 0 ... kAnyWarps - 1. ``red`` holds 2 * kAnyWarps
// floats; every thread must call it.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  warp_sum2(a, b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's reads of red are done
  if (lane == 0) {
    red[warp] = a;
    red[kAnyWarps + warp] = b;
  }
  __syncthreads();
  a = b = 0.f;
#pragma unroll
  for (int w = 0; w < kAnyWarps; ++w) {
    a += red[w];
    b += red[kAnyWarps + w];
  }
}

template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kAnyThreads)
ln_fwd_any(const T* __restrict__ x, const W* __restrict__ scale,
           const W* __restrict__ bias, T* __restrict__ y, long long rows,
           int D, float eps) {
  using P = Piece<T, kVec>;
  constexpr int E = P::kE;
  __shared__ float red[2 * kAnyWarps];
  const int np = D / E;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    float sum = 0.f, unused = 0.f;
    for (int p = threadIdx.x; p < np; p += kAnyThreads) {
      float v[E];
      P::load(xr, p, v);
#pragma unroll
      for (int j = 0; j < E; ++j) sum += v[j];
    }
    block_sum2(sum, unused, red);
    const float mean = sum / D;
    float sq = 0.f;
    unused = 0.f;
    for (int p = threadIdx.x; p < np; p += kAnyThreads) {
      float v[E];
      P::load(xr, p, v);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float d = v[j] - mean;
        sq += d * d;
      }
    }
    block_sum2(sq, unused, red);
    const float rstd = rsqrtf(sq / D + eps);
    T* yr = y + row * D;
    for (int p = threadIdx.x; p < np; p += kAnyThreads) {
      float v[E];
      P::load(xr, p, v);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int c = p * E + j;
        v[j] = (v[j] - mean) * rstd * cxr::to_f32(scale[c]) +
               cxr::to_f32(bias[c]);
      }
      P::store(yr, p, v);
    }
  }
}

// The kE scale values of piece p, from the block's copy in shared memory.
template <typename W, int kE>
__device__ __forceinline__ void scale_piece(const W* s, int p,
                                            float (&v)[kE]) {
  if constexpr (kE == 1) {
    v[0] = cxr::to_f32(s[p]);
  } else {
    uint32_t w[kE * static_cast<int>(sizeof(W)) / 4];
    load_words(s + p * kE, w);
#pragma unroll
    for (int j = 0; j < kE; ++j) v[j] = elem<W>(w, j);
  }
}

// The any-D backward's layout: kWarpRow, a warp a row (rows of at most
// 32 V elements off the vector), 256 threads a block; else a block a row,
// V pieces a thread, as many whole warps as that takes (at most 256
// threads: 160 for a bf16 row of 2560, so three blocks fit an SM).
template <typename T, typename W, bool kVec, bool kWarpRow, int V>
struct AnyBwd {
  using R = Piece<T, kVec>;
  static constexpr int kE = R::kE;
  static constexpr int kMaxD = (kWarpRow ? 32 : kAnyThreads) * V * kE;
  __host__ __device__ static constexpr int threads(int d) {
    return kWarpRow ? kAnyThreads
                    : ((d / kE + V - 1) / V + 31) / 32 * 32;
  }
  // the row in hand and the next (x and dy, raw) and the sums, in registers
  static constexpr int kRegs = 4 * V * R::kWords + 2 * V * kE;
  static constexpr int kMinBlocks =
      kWarpRow ? (kRegs <= 32 ? 4 : 3) : kRegs <= 96 ? 2 : 1;
  __host__ __device__ static constexpr int scale_bytes(int d) {
    return (d * static_cast<int>(sizeof(W)) + 15) / 16 * 16;
  }
  // the scale, then kWarpRow: the warps' sums, [warp][2 V kE][32]
  // lane-minor; else two buffers of the warps' two partial sums
  static constexpr int kAux =
      kWarpRow ? kAnyWarps * 2 * V * kE * 32 * 4 : 2 * 2 * kAnyWarps * 4;
  __host__ __device__ static constexpr int smem(int d) {
    return scale_bytes(d) + kAux;
  }
};

// Rows walked by warps (kWarpRow) or by whole blocks, each held in
// registers as raw words from one read of x and dy, with the next row's
// loads issued before the current row's two reductions; the scale read
// once a block into shared memory; each thread's dscale / dbias sums of
// its own columns kept in registers across all its rows and written once
// (kWarpRow: the warps added in warp order first) into the block's row of
// the [n_blocks, 2, D] workspace.
template <typename T, typename W, bool kVec, bool kWarpRow, int V>
__global__ void __launch_bounds__(
    kAnyThreads, (AnyBwd<T, W, kVec, kWarpRow, V>::kMinBlocks))
ln_bwd_any(const T* __restrict__ x, const W* __restrict__ scale,
           const T* __restrict__ dy, T* __restrict__ dx,
           float* __restrict__ part, long long rows, int D, float eps) {
  using L = AnyBwd<T, W, kVec, kWarpRow, V>;
  using R = typename L::R;
  static_assert(!(kWarpRow && kVec), "a warp a row off the vector only");
  constexpr int E = L::kE, kWd = R::kWords;
  extern __shared__ __align__(16) unsigned char smem[];
  W* s_scale = reinterpret_cast<W*>(smem);
  float* s_aux = reinterpret_cast<float*>(smem + L::scale_bytes(D));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int me = kWarpRow ? lane : threadIdx.x;  // within the row's threads
  const int row_threads = kWarpRow ? 32 : static_cast<int>(blockDim.x);
  const int nw = blockDim.x >> 5;  // warps of the block
  const int np = D / E;

  const long long step =
      kWarpRow ? static_cast<long long>(gridDim.x) * kAnyWarps : gridDim.x;
  long long row = kWarpRow
                      ? static_cast<long long>(blockIdx.x) * kAnyWarps + warp
                      : static_cast<long long>(blockIdx.x);
  uint32_t cx[V][kWd], cg[V][kWd];
  auto fetch = [&](long long r, uint32_t (&xw)[V][kWd],
                   uint32_t (&gw)[V][kWd]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        R::load(x + r * D, p, xw[i]);
        R::load(dy + r * D, p, gw[i]);
      }
    }
  };
  if (row < rows) fetch(row, cx, cg);  // in flight while the scale is read
  for (int c = threadIdx.x; c < D; c += blockDim.x) s_scale[c] = scale[c];
  __syncthreads();

  // Two sums over the row's threads: a warp's butterfly, and in the block
  // form the warps' partials through one of two buffers in turn (the
  // barrier of one reduction orders the reads of the buffer before it
  // against the writes of the one after it), added in warp order.
  int buf = 0;
  auto row_sum2 = [&](float& a, float& b) {
    warp_sum2(a, b);
    if constexpr (!kWarpRow) {
      float* red = s_aux + buf * 2 * kAnyWarps;
      if (lane == 0) {
        red[warp] = a;
        red[kAnyWarps + warp] = b;
      }
      __syncthreads();
      a = b = 0.f;
#pragma unroll
      for (int w = 0; w < kAnyWarps; ++w)
        if (w < nw) {
          a += red[w];
          b += red[kAnyWarps + w];
        }
      buf ^= 1;
    }
  };

  float ds[V][E], db[V][E];
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int j = 0; j < E; ++j) ds[i][j] = db[i][j] = 0.f;

  for (; row < rows; row += step) {  // uniform over the row's threads
    uint32_t nx[V][kWd], ng[V][kWd];
    if (row + step < rows) fetch(row + step, nx, ng);

    float sx = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        float sv[E];
        scale_piece(s_scale, p, sv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          sx += R::at(cx[i], j);
          sg += R::at(cg[i], j) * sv[j];
        }
      }
    }
    row_sum2(sx, sg);
    const float mean = sx / D;
    float sq = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        float sv[E];
        scale_piece(s_scale, p, sv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float d = R::at(cx[i], j) - mean;
          sq += d * d;
          sgx += R::at(cg[i], j) * sv[j] * d;
        }
      }
    }
    row_sum2(sq, sgx);
    const float rstd = rsqrtf(sq / D + eps);
    const float mg = sg / D, mgx = sgx * rstd / D;  // mean(g), mean(g x_hat)
    T* dxr = dx + row * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        float sv[E], o[E];
        scale_piece(s_scale, p, sv);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float xh = (R::at(cx[i], j) - mean) * rstd;
          const float gy = R::at(cg[i], j);
          ds[i][j] += gy * xh;
          db[i][j] += gy;
          o[j] = (gy * sv[j] - mg - xh * mgx) * rstd;
        }
        R::store(dxr, p, o);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int w = 0; w < kWd; ++w) {
        cx[i][w] = nx[i][w];
        cg[i][w] = ng[i][w];
      }
  }

  float* pr = part + static_cast<long long>(blockIdx.x) * 2 * D;
  if constexpr (kWarpRow) {
    // the warps' sums added in warp order by warp 0
    float* mine = s_aux + warp * 2 * V * 32 + lane;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mine[i * 32] = ds[i][0];
      mine[(V + i) * 32] = db[i][0];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int p = lane + i * 32;
        float sd = 0.f, sb = 0.f;
#pragma unroll
        for (int w = 0; w < kAnyWarps; ++w) {
          sd += s_aux[(w * 2 * V + i) * 32 + lane];
          sb += s_aux[(w * 2 * V + V + i) * 32 + lane];
        }
        if (p < np) {
          pr[p] = sd;
          pr[D + p] = sb;
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int p = me + i * row_threads;
      if (p < np) {
        if constexpr (kVec) {
#pragma unroll
          for (int h = 0; h < E / 4; ++h) {
            reinterpret_cast<float4*>(pr + p * E)[h] =
                make_float4(ds[i][4 * h], ds[i][4 * h + 1], ds[i][4 * h + 2],
                            ds[i][4 * h + 3]);
            reinterpret_cast<float4*>(pr + D + p * E)[h] =
                make_float4(db[i][4 * h], db[i][4 * h + 1], db[i][4 * h + 2],
                            db[i][4 * h + 3]);
          }
        } else {
          pr[p] = ds[i][0];
          pr[D + p] = db[i][0];
        }
      }
    }
  }
}

// Past the widths whose rows fit in registers (ln_bwd_any's), a block a
// row read from L1 / L2 once a pass, its dscale / dbias sums in its own row
// of the workspace (each thread owns fixed columns, so no atomics).
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kAnyThreads)
ln_bwd_rowloop(const T* __restrict__ x, const W* __restrict__ scale,
           const T* __restrict__ dy, T* __restrict__ dx,
           float* __restrict__ part, long long rows, int D, float eps) {
  using P = Piece<T, kVec>;
  constexpr int E = P::kE;
  __shared__ float red[2 * kAnyWarps];
  const int np = D / E;
  // this block's [2, D] partial: dscale's sums, then dbias's; a thread
  // owns the columns of its pieces
  float* pr = part + static_cast<long long>(blockIdx.x) * 2 * D;
  for (int p = threadIdx.x; p < np; p += kAnyThreads)
#pragma unroll
    for (int j = 0; j < E; ++j) pr[p * E + j] = pr[D + p * E + j] = 0.f;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float sx = 0.f, sg = 0.f;
    for (int p = threadIdx.x; p < np; p += kAnyThreads) {
      float xv[E], gv[E];
      P::load(xr, p, xv);
      P::load(gr, p, gv);
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
      P::load(xr, p, xv);
      P::load(gr, p, gv);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float d = xv[j] - mean;
        sq += d * d;
        sgx += gv[j] * cxr::to_f32(scale[p * E + j]) * d;
      }
    }
    block_sum2(sq, sgx, red);
    const float rstd = rsqrtf(sq / D + eps);
    const float mg = sg / D, mgx = sgx * rstd / D;  // mean(g), mean(g x_hat)
    T* dxr = dx + row * D;
    for (int p = threadIdx.x; p < np; p += kAnyThreads) {
      float xv[E], gv[E];
      P::load(xr, p, xv);
      P::load(gr, p, gv);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int c = p * E + j;
        const float xh = (xv[j] - mean) * rstd;
        pr[c] += gv[j] * xh;
        pr[D + c] += gv[j];
        xv[j] = (gv[j] * cxr::to_f32(scale[c]) - mg - xh * mgx) * rstd;
      }
      P::store(dxr, p, xv);
    }
  }
}

// Blocks of `kernel` resident on the card at once, with `smem` bytes of
// dynamic shared memory (allowed first), found once per kernel and device
// into `cache`.
template <typename K>
cudaError_t wave_of(K* kernel, int threads, int smem, int device,
                    int (&cache)[64], int* blocks) {
  if (device < 0 || device >= 64) return cudaErrorInvalidValue;
  if (cache[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    cache[device] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  *blocks = cache[device];
  return cudaSuccess;
}

// One wave: as many blocks as fit on the card at once, fewer when there
// are fewer rows.
template <typename T, typename W, int V>
cudaError_t launch_fwd_v(const void* x, const void* s, const void* b, void* y,
                         long long rows, int d, float eps, int device,
                         cudaStream_t st) {
  static int cache[64] = {};
  int wave = 0;
  cudaError_t err =
      wave_of(ln_fwd<T, W, V>, 32 * kFwdWarps, 0, device, cache, &wave);
  if (err != cudaSuccess) return err;
  const long long need = (rows + kFwdWarps - 1) / kFwdWarps;
  const unsigned blocks = static_cast<unsigned>(need < wave ? need : wave);
  ln_fwd<T, W, V><<<blocks, 32 * kFwdWarps, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(s),
      static_cast<const W*>(b), static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

// The any-D forward (ln_fwd_any) on one wave, fewer blocks for fewer rows.
template <typename T, typename W, bool kVec>
cudaError_t launch_fwd_any(const void* x, const void* s, const void* b,
                           void* y, long long rows, int d, float eps,
                           int device, cudaStream_t st) {
  static int cache[64] = {};
  int wave = 0;
  cudaError_t err = wave_of(ln_fwd_any<T, W, kVec>, kAnyThreads, 0, device,
                            cache, &wave);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(rows < wave ? rows : wave);
  ln_fwd_any<T, W, kVec><<<blocks, kAnyThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(s),
      static_cast<const W*>(b), static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

// Whether d takes the rungs (a whole number of 16-byte vectors, at most
// kMaxD) or the any-D kernels.
template <typename T>
bool on_rungs(int d) {
  return d <= kMaxD && d % (16 / static_cast<int>(sizeof(T))) == 0;
}

template <typename T, typename W>
cudaError_t launch_fwd(const void* x, const void* s, const void* b, void* y,
                       long long rows, int d, float eps, int device,
                       cudaStream_t st) {
  if (!on_rungs<T>(d))
    return d % (16 / static_cast<int>(sizeof(T))) == 0
               ? launch_fwd_any<T, W, true>(x, s, b, y, rows, d, eps, device,
                                            st)
               : launch_fwd_any<T, W, false>(x, s, b, y, rows, d, eps, device,
                                             st);
  const int v = (d / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
#define CXR_LN_FWD(V) \
  if (v <= V) return launch_fwd_v<T, W, V>(x, s, b, y, rows, d, eps, device, st);
  CXR_LN_FWD(1)
  CXR_LN_FWD(2)
  CXR_LN_FWD(3)
  CXR_LN_FWD(4)
  CXR_LN_FWD(6)
  CXR_LN_FWD(8)
  if constexpr (sizeof(T) == 4) {  // f32 rows of more than 1024 columns
    CXR_LN_FWD(12)
    CXR_LN_FWD(16)
  }
#undef CXR_LN_FWD
  return cudaErrorInvalidValue;
}

// A backward call, or with `wave` set only the number of its blocks that
// are resident at once.
struct BwdCall {
  const void *x, *scale, *dy;
  void *dx, *dscale, *dbias;
  float* part;
  long long rows;
  int d;
  float eps;
  int n_blocks, device;
  cudaStream_t st;
  int* wave;
};

// The column pass over a backward's n_blocks partials.
template <typename W>
cudaError_t launch_cols(const BwdCall& c) {
  ln_bwd_cols<W><<<(2 * c.d + 31) / 32, 32 * kColWarps, 0, c.st>>>(
      c.part, c.n_blocks, c.d, static_cast<W*>(c.dscale),
      static_cast<W*>(c.dbias));
  return cudaGetLastError();
}

template <typename T, typename W, int V>
cudaError_t run_bwd_v(const BwdCall& c) {
  using L = Bwd<T, W, V>;
  static int cache[64] = {};
  int wave = 0;  // also allows the rung's shared memory
  cudaError_t err = wave_of(ln_bwd<T, W, V>, 32 * kBwdWarps,
                            L::smem(L::kMaxD), c.device, cache, &wave);
  if (err != cudaSuccess) return err;
  if (c.wave) {
    *c.wave = wave;
    return cudaSuccess;
  }
  ln_bwd<T, W, V><<<c.n_blocks, 32 * kBwdWarps, L::smem(c.d), c.st>>>(
      static_cast<const T*>(c.x), static_cast<const W*>(c.scale),
      static_cast<const T*>(c.dy), static_cast<T*>(c.dx), c.part, c.rows,
      c.d, c.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_cols<W>(c);
}

// The any-D backward at a width its rows fit in registers (ln_bwd_any) and
// the column pass, or its wave.
template <typename T, typename W, bool kVec, bool kWarpRow, int V>
cudaError_t run_bwd_any(const BwdCall& c) {
  using L = AnyBwd<T, W, kVec, kWarpRow, V>;
  static int cache[kAnyWarps][64] = {};  // by the block's warps
  const int threads = L::threads(c.d);
  int wave = 0;  // also allows the widest row's shared memory
  cudaError_t err =
      wave_of(ln_bwd_any<T, W, kVec, kWarpRow, V>, threads,
              L::smem(L::kMaxD), c.device, cache[threads / 32 - 1], &wave);
  if (err != cudaSuccess) return err;
  if (c.wave) {
    *c.wave = wave;
    return cudaSuccess;
  }
  ln_bwd_any<T, W, kVec, kWarpRow, V>
      <<<c.n_blocks, threads, L::smem(c.d), c.st>>>(
          static_cast<const T*>(c.x), static_cast<const W*>(c.scale),
          static_cast<const T*>(c.dy), static_cast<T*>(c.dx), c.part, c.rows,
          c.d, c.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_cols<W>(c);
}

// Past ln_bwd_any's widths: ln_bwd_rowloop and the column pass, or its
// wave.
template <typename T, typename W, bool kVec>
cudaError_t run_bwd_rowloop(const BwdCall& c) {
  static int cache[64] = {};
  int wave = 0;
  cudaError_t err = wave_of(ln_bwd_rowloop<T, W, kVec>, kAnyThreads, 0,
                            c.device, cache, &wave);
  if (err != cudaSuccess) return err;
  if (c.wave) {
    *c.wave = wave;
    return cudaSuccess;
  }
  ln_bwd_rowloop<T, W, kVec><<<c.n_blocks, kAnyThreads, 0, c.st>>>(
      static_cast<const T*>(c.x), static_cast<const W*>(c.scale),
      static_cast<const T*>(c.dy), static_cast<T*>(c.dx), c.part, c.rows,
      c.d, c.eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_cols<W>(c);
}

// Any D off the rungs: whole 16-byte vectors (D past 2048) take a block a
// row, 2 to 4 vectors a thread (bf16 D <= 8192, f32 D <= 4096); a D off
// the vector takes a warp a row up to 256 elements (1, 2, 4 or 8 a lane),
// a block a row up to 4096 (2, 4, 8 or 16 a thread); wider rows
// ln_bwd_rowloop.
template <typename T, typename W>
cudaError_t run_bwd_off_rungs(const BwdCall& c) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  if (c.d % E == 0) {
    const int v = (c.d / E + kAnyThreads - 1) / kAnyThreads;
    if (v <= 2) return run_bwd_any<T, W, true, false, 2>(c);
    if (v <= 3) return run_bwd_any<T, W, true, false, 3>(c);
    if (v <= 4) return run_bwd_any<T, W, true, false, 4>(c);
    return run_bwd_rowloop<T, W, true>(c);
  }
  if (c.d <= 32 * 8) {
    const int v = (c.d + 31) / 32;
    if (v <= 1) return run_bwd_any<T, W, false, true, 1>(c);
    if (v <= 2) return run_bwd_any<T, W, false, true, 2>(c);
    if (v <= 4) return run_bwd_any<T, W, false, true, 4>(c);
    return run_bwd_any<T, W, false, true, 8>(c);
  }
  const int v = (c.d + kAnyThreads - 1) / kAnyThreads;
  if (v <= 2) return run_bwd_any<T, W, false, false, 2>(c);
  if (v <= 4) return run_bwd_any<T, W, false, false, 4>(c);
  if (v <= 8) return run_bwd_any<T, W, false, false, 8>(c);
  if (v <= 16) return run_bwd_any<T, W, false, false, 16>(c);
  return run_bwd_rowloop<T, W, false>(c);
}

template <typename T, typename W>
cudaError_t run_bwd(const BwdCall& c) {
  if (!on_rungs<T>(c.d)) return run_bwd_off_rungs<T, W>(c);
  const int v = (c.d / (16 / static_cast<int>(sizeof(T))) + 31) / 32;
#define CXR_LN_BWD(V) \
  if (v <= V) return run_bwd_v<T, W, V>(c);
  CXR_LN_BWD(1)
  CXR_LN_BWD(2)
  CXR_LN_BWD(3)
  CXR_LN_BWD(4)
  CXR_LN_BWD(6)
  CXR_LN_BWD(8)
  if constexpr (sizeof(T) == 4) {  // f32 rows of more than 1024 columns
    CXR_LN_BWD(12)
    CXR_LN_BWD(16)
  }
#undef CXR_LN_BWD
  return cudaErrorInvalidValue;
}

cudaError_t run_bwd_types(int x_dtype, int w_dtype, const BwdCall& c) {
  using bf16 = __nv_bfloat16;
  if (x_dtype == 1 && w_dtype == 1) return run_bwd<bf16, bf16>(c);
  if (x_dtype == 1 && w_dtype == 0) return run_bwd<bf16, float>(c);
  if (x_dtype == 0 && w_dtype == 0) return run_bwd<float, float>(c);
  if (x_dtype == 0 && w_dtype == 1) return run_bwd<float, bf16>(c);
  return cudaErrorInvalidValue;
}

bool bad_shape(long long rows, int d) { return rows <= 0 || d <= 0; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x and y are contiguous [rows, d]
// from a 16-byte aligned address, scale and bias [d] 16-byte aligned; any
// d >= 1.
extern "C" int cxr_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, long long rows,
                                  int d, float eps, int x_dtype, int w_dtype,
                                  int device, void* stream) {
  if (bad_shape(rows, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    err = launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, y, rows, d,
                                                   eps, device, st);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch_fwd<__nv_bfloat16, float>(x, scale, bias, y, rows, d, eps,
                                           device, st);
  else if (x_dtype == 0 && w_dtype == 0)
    err = launch_fwd<float, float>(x, scale, bias, y, rows, d, eps, device, st);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch_fwd<float, __nv_bfloat16>(x, scale, bias, y, rows, d, eps,
                                           device, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// x, dy, dx contiguous [rows, d] in x_dtype from 16-byte aligned addresses;
// scale, dscale, dbias [d] in w_dtype; workspace f32 [n_blocks, 2, d],
// 16-byte aligned (n_blocks >= 1, chosen by the caller, best
// cxr_layer_norm_bwd_wave's or fewer; the result depends on it only
// through the f32 summation order).
extern "C" int cxr_layer_norm_bwd(const void* x, const void* scale,
                                  const void* dy, void* dx, void* dscale,
                                  void* dbias, void* workspace,
                                  long long rows, int d, float eps,
                                  int n_blocks, int x_dtype, int w_dtype,
                                  int device, void* stream) {
  if (bad_shape(rows, d) || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdCall c{x, scale, dy, dx, dscale, dbias,
                  static_cast<float*>(workspace), rows, d, eps, n_blocks,
                  device, static_cast<cudaStream_t>(stream), nullptr};
  return static_cast<int>(run_bwd_types(x_dtype, w_dtype, c));
}

// *blocks = the backward's blocks resident on `device` at once for this d
// and these dtypes: one wave, the workspace's size for any row count.
extern "C" int cxr_layer_norm_bwd_wave(int d, int x_dtype, int w_dtype,
                                       int device, int* blocks) {
  if (bad_shape(1, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdCall c{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, 1, d, 0.f, 1, device, nullptr, blocks};
  return static_cast<int>(run_bwd_types(x_dtype, w_dtype, c));
}
