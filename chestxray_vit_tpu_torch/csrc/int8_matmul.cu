// int8 x int8 -> int32 matrix product with the static-int8 serving epilogue
// fused: out = act(f32(xq @ wq^T) * scale + bias) [+ resid], written in the
// compute dtype or requantized to int8; or the raw int32 sums (out code 3,
// no epilogue: the partial of a row product split over a tensor axis,
// summed over the ranks as int32 before the one epilogue, as one card's
// int32 sum is, models/int8_train.py).
//
// Replaces the TPU kernel chestxray_vit_tpu/ops/int8_pallas.py `_kernel`
// (launched by `int8_matmul_fused`), which takes one image's whole
// [577, K] panel per grid step against a VMEM-resident [K, N] weight. Here
// the batch is folded into the rows (M = B * S) and each block computes a
// 128 x 128 output tile with two consumer warpgroups of 64 rows each, on
// the int8 tensor cores through `wgmma.m64n128k32.s32.s8.s8` with both
// operands read from shared memory through descriptors.
//
// Layouts: xq [M, K] and the weight [N, K] are both K-contiguous, the one
// layout wgmma takes for 8-bit operands (it transposes only 16-bit ones;
// the port's quantized tree keeps weights as [out, in] for this reason, the
// JAX tree's [in, out] is transposed by the bridge). K runs in tiles of 128
// bytes: a stage holds the block's [128 x 128] A and B tiles under the
// 128-byte swizzle (common.cuh `copy_s8_tile_async`, `tile_mma_s8`), filled
// by `cp.async` into a kStages ring so that the next tiles load while the
// current one multiplies. Rows past M, columns past N and the upper half of
// a last tile when K % 128 = 64 are zero-filled on load (and that half's
// k-steps are not issued); rows and columns past the end are skipped on
// store, since B * 577 is never a multiple of 128. An N that is no
// multiple of 8 (a model of any width, as the JAX kernel takes it) leaves
// rows that are not whole 16-byte pieces: that instantiation (kTail) reads
// the residual and writes the output element by element, and the scale
// and bias of the columns below N only.
//
// The epilogue is that of the JAX kernel and of the plain twin
// `int8_matmul_fused_reference`, in its order, each operation rounded on
// its own (`__fmul_rn` / `__fadd_rn`: nvcc would otherwise contract
// a * b + c into one FMA) so that the outputs equal the plain twin's bit
// for bit: dequantize and bias, the exact-erf GELU written term for term as
// ops/gelu.py `erf_fast`, the residual, then either round to the compute
// dtype or multiply by 1 / qs, round half to even (`rintf`), clip to
// [-127, 127] and store int8. The int32 sums are exact in any order. The
// accumulators leave the warpgroups through shared memory (the ring, free
// by then, rows padded by 16 bytes so that neither side conflicts on a
// bank), and each thread then owns 8 consecutive columns of 8 rows: it
// reads the residual as 16-byte pieces of a row, keeps its columns' scale
// and bias in registers, and writes 16 bytes (8 for int8 out) a row, so
// every row of the tile leaves as whole sectors.
//
// What bounds it on an H100: at the ViT-B/16 shapes the products are
// 2 * M * K * N int8 operations against 1,979 TOP/s, and the operands and
// outputs move 20-60 MB at 3.35 TB/s: the projections with K = N = 768 sit
// on the bytes side, the MLP ones (at batch 32) on the operations side.
// With the GELU (about 45 instructions an output, with an IEEE division
// and exp2f) the epilogue costs the CUDA cores about as long as the
// products take (0.08 of 0.21 ms at the batch-32 mlp_in shape, PERF.md),
// and two blocks an SM hide little of it under the other block's
// products. Warp-specialised forms (a TMA producer and two consumer
// warpgroups in turns, one block an SM), 256- and 64-row tiles and a
// branch-free reciprocal were measured slower or no faster (PERF.md).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 128;  // kBK in bytes (int8)
constexpr int kThreads = 256;                   // two warpgroups of 64 rows
constexpr int kStages = 3;
constexpr int kTileA = kBM * kBK, kTileB = kBN * kBK;
constexpr int kStageBytes = kTileA + kTileB;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + 1024 alignment
constexpr int kEpiLd = kBN + 4;  // int32 words per staged row
constexpr float kInvSqrt2 = 0.7071067811865476f;
static_assert(kBM * kEpiLd * 4 <= kStages * kStageBytes,
              "the staged accumulators fit in the ring");
static_assert(kStages >= 2, "the ring overlaps a copy with a tile's products");

// ops/gelu.py `erf_fast` (Abramowitz-Stegun 7.1.26), one rounding per
// operation in the order PyTorch's eager ops take them.
__device__ __forceinline__ float erf_fast(float x) {
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, ax)));
  float p = __fmul_rn(t, 1.061405429f);
  p = __fmul_rn(t, __fadd_rn(-1.453152027f, p));
  p = __fmul_rn(t, __fadd_rn(1.421413741f, p));
  p = __fmul_rn(t, __fadd_rn(-0.284496736f, p));
  p = __fmul_rn(t, __fadd_rn(0.254829592f, p));
  const float e = exp2f(__fmul_rn(-__fmul_rn(ax, ax), cxr::kLog2e));
  const float y = __fsub_rn(1.0f, __fmul_rn(p, e));
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return __fmul_rn(sign, y);
}

__device__ __forceinline__ float gelu(float y) {
  return __fmul_rn(__fmul_rn(y, 0.5f),
                   __fadd_rn(1.0f, erf_fast(__fmul_rn(y, kInvSqrt2))));
}

__device__ __forceinline__ int8_t requant(float y, float inv) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// Eight consecutive values of a row: the residual in, the result out.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = cxr::bf16_lo(w[i]);
    v[2 * i + 1] = cxr::bf16_hi(w[i]);
  }
}

__device__ __forceinline__ void store8(float* o, const float (&y)[8], float) {
  *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
  *reinterpret_cast<float4*>(o + 4) = make_float4(y[4], y[5], y[6], y[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* o, const float (&y)[8],
                                       float) {
  *reinterpret_cast<uint4*>(o) =
      make_uint4(cxr::pack_bf16x2(y[0], y[1]), cxr::pack_bf16x2(y[2], y[3]),
                 cxr::pack_bf16x2(y[4], y[5]), cxr::pack_bf16x2(y[6], y[7]));
}
__device__ __forceinline__ void store8(int* o, const int (&v)[8]) {
  *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<int4*>(o + 4) = make_int4(v[4], v[5], v[6], v[7]);
}
// One value of a row (kTail), as load8 / store8 write eight.
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* o, float y, float) { *o = y; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float y, float) {
  *o = __float2bfloat16_rn(y);
}
__device__ __forceinline__ void store1(int8_t* o, float y, float inv) {
  *o = requant(y, inv);
}

__device__ __forceinline__ void store8(int8_t* o, const float (&y)[8],
                                       float inv) {
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    w[h] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[h] |= (static_cast<uint32_t>(requant(y[4 * h + j], inv)) & 0xFFu)
              << (8 * j);
  }
  *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
}

template <typename OutT, typename ResT, bool kTail>
__global__ void __launch_bounds__(kThreads, 2)
int8_gemm_fused(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const ResT* __restrict__ resid, const float* __restrict__ qs,
                OutT* __restrict__ out, int M, int N, int K, int do_gelu) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = cxr::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows_a = min(kBM, M - m0), rows_b = min(kBN, N - n0);
  const int8_t* a_blk = a + static_cast<long long>(m0) * K;
  const int8_t* b_blk = b + static_cast<long long>(n0) * K;
  const int k_tiles = (K + kBK - 1) / kBK;

  // tile kt into stage kt % kStages; a commit per call, empty past the end,
  // so that the count of groups in flight stays the same
  auto fetch = [&](int kt) {
    if (kt < k_tiles) {
      const uint32_t st = ring + (kt % kStages) * kStageBytes;
      cxr::copy_s8_tile_async<kBM, kThreads>(st, a_blk + kt * kBK, K, rows_a,
                                             K - kt * kBK);
      cxr::copy_s8_tile_async<kBN, kThreads>(st + kTileA, b_blk + kt * kBK, K,
                                             rows_b, K - kt * kBK);
    }
    cxr::cp_async_commit();
  };

  int acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  cxr::acc_fence(acc);
  for (int kt = 0; kt < k_tiles; ++kt) {
    cxr::cp_async_wait<kStages - 2>();  // tile kt has arrived (this thread)
    __syncthreads();  // ... for every thread; and tile kt - 1 is consumed
    fetch(kt + kStages - 1);            // into tile kt - 1's stage
    const uint32_t st = ring + (kt % kStages) * kStageBytes;
    cxr::wgmma_fence();
    cxr::tile_mma_s8(acc, st + wg * (kTileA / 2), st + kTileA,
                     min(4, (K - kt * kBK) / 32));
    cxr::wgmma_commit();
    cxr::wgmma_wait<0>(acc);
  }
  cxr::cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring

  // the accumulators into the ring: row r, column c at word r * kEpiLd + c
  int* stage = reinterpret_cast<int*>(smem_raw + (ring - raw));
  {
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int r = wg * 64 + warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<int2*>(stage + r * kEpiLd + 8 * n + c) =
          make_int2(acc[n][0], acc[n][1]);
      *reinterpret_cast<int2*>(stage + (r + 8) * kEpiLd + 8 * n + c) =
          make_int2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();

  // thread: columns 8 cc ... 8 cc + 7 of rows r0, r0 + 16, ..., r0 + 112
  const int cc = tid & 15, r0 = tid >> 4, col = n0 + 8 * cc;
  if (col >= N) return;  // !kTail: N is a multiple of 8, all 8 are in
  const int ncols = kTail ? min(8, N - col) : 8;
  constexpr bool kRaw = std::is_same<OutT, int>::value;  // int32 out
  float sc[8], bi[8];
  if constexpr (!kRaw) {
    if constexpr (kTail) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j] = j < ncols ? scale[col + j] : 0.f;
        bi[j] = j < ncols ? bias[col + j] : 0.f;
      }
    } else {
      load8(scale + col, sc);
      load8(bias + col, bi);
    }
  }
  // 1 / qs once, as the JAX kernel computes `inv` before its multiply
  const float inv = qs != nullptr ? __fdiv_rn(1.0f, *qs) : 0.f;
  // the two 16-byte halves of the 8 words, in an order that puts the 8
  // threads of a quarter warp on 8 distinct bank groups
  const int h0 = (cc >> 2) & 1;
#pragma unroll
  for (int i = 0; i < kBM / 16; ++i) {
    const int r = r0 + 16 * i, row = m0 + r;
    if (row >= M) continue;
    const long long off = static_cast<long long>(row) * N + col;
    float res[8];
    if (resid != nullptr) {
      if constexpr (kTail) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          res[j] = j < ncols ? load1(resid + off + j) : 0.f;
      } else {
        load8(resid + off, res);
      }
    }
    const int* s = stage + r * kEpiLd + 8 * cc;
    const int4 lo = *reinterpret_cast<const int4*>(s + 4 * h0);
    const int4 hi = *reinterpret_cast<const int4*>(s + 4 * (h0 ^ 1));
    const int4 q0 = h0 ? hi : lo, q1 = h0 ? lo : hi;
    const int v[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    if constexpr (kRaw) {
      if constexpr (kTail) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < ncols) out[off + j] = v[j];
      } else {
        store8(out + off, v);
      }
    } else {
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j] = __fadd_rn(__fmul_rn(__int2float_rn(v[j]), sc[j]), bi[j]);
        if (do_gelu) y[j] = gelu(y[j]);
        if (resid != nullptr) y[j] = __fadd_rn(y[j], res[j]);
      }
      if constexpr (kTail) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < ncols) store1(out + off + j, y[j], inv);
      } else {
        store8(out + off, y, inv);
      }
    }
  }
}

template <typename OutT, typename ResT, bool kTail>
int launch_at(const void* xq, const void* wq, const void* scale,
              const void* bias, const void* resid, const void* qs, void* out,
              int m, int n, int k, int do_gelu, int device,
              cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a kernel must be allowed it, once
  // per device (a repeated call is harmless)
  static bool allowed[64] = {};
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidValue);
  if (!allowed[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_gemm_fused<OutT, ResT, kTail>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = true;
  }
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_gemm_fused<OutT, ResT, kTail><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const ResT*>(resid), static_cast<const float*>(qs),
      static_cast<OutT*>(out), m, n, k, do_gelu);
  return static_cast<int>(cudaGetLastError());
}

// launch_at for the N at hand: whole 16-byte row pieces or a tail.
template <typename OutT, typename ResT>
int launch(const void* xq, const void* wq, const void* scale, const void* bias,
           const void* resid, const void* qs, void* out, int m, int n, int k,
           int do_gelu, int device, cudaStream_t stream) {
  if (n % 8)
    return launch_at<OutT, ResT, true>(xq, wq, scale, bias, resid, qs, out,
                                       m, n, k, do_gelu, device, stream);
  return launch_at<OutT, ResT, false>(xq, wq, scale, bias, resid, qs, out, m,
                                      n, k, do_gelu, device, stream);
}

}  // namespace

// xq int8 [m, k] and wq int8 [n, k], both contiguous with 16-byte aligned
// rows; scale and bias f32 [n], resid [m, n] in res_dtype or null, out
// [m, n], all four 16-byte aligned (rows of them too when n % 8 == 0); qs a
// device f32 scalar (requantize to int8) or null. Dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (out
// only, with qs), 3 = int32 (out only: the raw sums, with no scale, bias,
// GELU, residual or qs). k a multiple of 64 (callers zero-pad K:
// ops/int8_matmul.py pad_k), any n >= 1. At k <= 2^31 / 127^2 (133,143) no
// int32 sum of int8 in [-127, 127] can overflow.
extern "C" int cxr_int8_matmul_fused(const void* xq, const void* wq,
                                     const void* scale, const void* bias,
                                     const void* resid, const void* qs,
                                     void* out, int m, int n, int k,
                                     int do_gelu, int out_dtype, int res_dtype,
                                     int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 64 ||
      (out_dtype == 2) != (qs != nullptr) ||
      (out_dtype == 3) != (scale == nullptr) ||
      (out_dtype == 3) != (bias == nullptr) ||
      (out_dtype == 3 && (resid != nullptr || do_gelu)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res_f32 = resid == nullptr || res_dtype == 0;
  if (resid != nullptr && res_dtype != 0 && res_dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == 0 && res_f32)
    return launch<float, float>(xq, wq, scale, bias, resid, qs, out, m, n, k,
                                do_gelu, device, st);
  if (out_dtype == 1 && (resid == nullptr || res_dtype == 1))
    return launch<__nv_bfloat16, __nv_bfloat16>(xq, wq, scale, bias, resid, qs,
                                                out, m, n, k, do_gelu, device,
                                                st);
  if (out_dtype == 2 && res_f32)
    return launch<int8_t, float>(xq, wq, scale, bias, resid, qs, out, m, n, k,
                                 do_gelu, device, st);
  if (out_dtype == 2)
    return launch<int8_t, __nv_bfloat16>(xq, wq, scale, bias, resid, qs, out, m,
                                         n, k, do_gelu, device, st);
  if (out_dtype == 3)
    return launch<int, float>(xq, wq, nullptr, nullptr, nullptr, nullptr, out,
                              m, n, k, 0, device, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
