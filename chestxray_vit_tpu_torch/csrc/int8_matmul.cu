// int8 x int8 -> int32 matrix product with the static-int8 serving epilogue
// fused: out = act(f32(xq @ wq^T) * scale + bias) [+ resid], written in the
// compute dtype or requantized to int8.
//
// Replaces the TPU kernel chestxray_vit_tpu/ops/int8_pallas.py `_kernel`
// (launched by `int8_matmul_fused`), which takes one image's whole
// [577, K] panel per grid step against a VMEM-resident [K, N] weight. Here
// the batch is folded into the rows (M = B * S) and each block computes a
// 128 x 128 output tile: 8 warps, each 64 x 32, with
// `mma.sync.m16n8k32.s8.s8.s32` on the int8 tensor cores, K in steps of 64
// staged through shared memory by `cp.async` into two buffers, so the next
// step's tiles load while the current one multiplies. Rows (and columns)
// past the end are zero-filled on load and skipped on store, since B * 577
// is never a multiple of 128.
//
// Layouts: xq [M, K] and the weight [N, K] are both K-contiguous, the
// layout the `.row.col` operands read with plain 32-bit shared loads (the
// port's quantized tree keeps weights as [out, in] for this reason; the
// JAX tree's [in, out] is transposed by the bridge). A shared-memory row is
// 64 + 16 bytes, so the eight rows a fragment load touches fall in distinct
// banks.
//
// The epilogue runs in registers, in the order of the JAX kernel and of the
// plain twin `int8_matmul_fused_reference`, each operation rounded on its
// own (`__fmul_rn` / `__fadd_rn`: nvcc would otherwise contract a * b + c
// into one FMA) so that the outputs equal the plain twin's bit for bit:
// dequantize and bias, the exact-erf GELU written term for term as
// ops/gelu.py `erf_fast`, the residual, then either round to the compute
// dtype or multiply by 1 / qs, round half to even (`rintf`), clip to
// [-127, 127] and store int8.
//
// What bounds it on an H100: at the ViT-B/16 shapes the products are
// 2 * M * K * N int8 operations against 1,979 TOP/s, and the operands and
// outputs move 20-60 MB at 3.35 TB/s; the larger projections (MLP, at
// batch 32) sit on the operations side. A simple `mma.sync` kernel reaches
// a fraction of the dense int8 rate; `wgmma` with TMA loads and a
// persistent schedule is later work.

#include "common.cuh"

namespace {

using cxr::to_f32;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;             // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64, kWarpN = 32;   // a warp's tile: 4 x 4 m16n8 tiles
constexpr int kLd = kBK + 16;             // shared row stride in bytes
constexpr float kInvSqrt2 = 0.7071067811865476f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A * B, int8 in, int32 accumulate. Fragments (g = lane / 4,
// t = lane % 4): A rows g and g + 8, bytes 4t..4t+3 (a0, a1) and
// 16 + 4t.. (a2, a3); B column g, k = 4t.. (b0) and 16 + 4t.. (b1); D rows
// g (d0, d1) and g + 8 (d2, d3) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_16832(int (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ void store2(float* o, float y0, float y1, float) {
  *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* o, float y0, float y1,
                                       float) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
}

__device__ __forceinline__ int8_t requant(float y, float inv) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ void store2(int8_t* o, float y0, float y1,
                                       float inv) {
  char2 v;
  v.x = requant(y0, inv);
  v.y = requant(y1, inv);
  *reinterpret_cast<char2*>(o) = v;
}

__device__ __forceinline__ void load_tiles(int8_t (*sa)[kLd], int8_t (*sb)[kLd],
                                           const int8_t* __restrict__ a,
                                           const int8_t* __restrict__ b, int m0,
                                           int n0, int k0, int M, int N, int K) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 16 bytes, each
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2, col = (c & 3) * 16;
    const int am = m0 + r, bn = n0 + r;
    cp_async16(&sa[r][col],
               a + (am < M ? static_cast<long long>(am) * K + k0 + col : 0),
               am < M);
    cp_async16(&sb[r][col],
               b + (bn < N ? static_cast<long long>(bn) * K + k0 + col : 0),
               bn < N);
  }
  cp_async_commit();
}

template <typename OutT, typename ResT>
__global__ void __launch_bounds__(kThreads)
int8_gemm_fused(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const ResT* __restrict__ resid, const float* __restrict__ qs,
                OutT* __restrict__ out, int M, int N, int K, int do_gelu) {
  __shared__ __align__(16) int8_t sa[2][kBM][kLd];
  __shared__ __align__(16) int8_t sb[2][kBN][kLd];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp >> 2) * kWarpM, wn = (warp & 3) * kWarpN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = K / kBK;
  load_tiles(sa[0], sb[0], a, b, m0, n0, 0, M, N, K);
  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < steps) {
      load_tiles(sa[s ^ 1], sb[s ^ 1], a, b, m0, n0, (kt + 1) * kBK, M, N, K);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&sa[s][r][kk + 4 * t]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&sa[s][r + 8][kk + 4 * t]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&sa[s][r][kk + 16 + 4 * t]);
        af[mi][3] =
            *reinterpret_cast<const uint32_t*>(&sa[s][r + 8][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(&sb[s][n][kk + 4 * t]);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(&sb[s][n][kk + 16 + 4 * t]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_16832(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    __syncthreads();
  }

  // 1 / qs once, as the JAX kernel computes `inv` before its multiply
  const float inv = qs != nullptr ? __fdiv_rn(1.0f, *qs) : 0.f;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t;
    if (col >= N) continue;  // N is even: col + 1 < N as well
    const float sc[2] = {scale[col], scale[col + 1]};
    const float bi[2] = {bias[col], bias[col + 1]};
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        const long long off = static_cast<long long>(row) * N + col;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]),
                                     sc[e]),
                           bi[e]);
          if (do_gelu) y[e] = gelu(y[e]);
          if (resid != nullptr) y[e] = __fadd_rn(y[e], to_f32(resid[off + e]));
        }
        store2(out + off, y[0], y[1], inv);
      }
    }
  }
}

template <typename OutT, typename ResT>
int launch(const void* xq, const void* wq, const void* scale, const void* bias,
           const void* resid, const void* qs, void* out, int m, int n, int k,
           int do_gelu, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_gemm_fused<OutT, ResT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const ResT*>(resid), static_cast<const float*>(qs),
      static_cast<OutT*>(out), m, n, k, do_gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq int8 [m, k] and wq int8 [n, k], both contiguous with 16-byte aligned
// rows; scale and bias f32 [n]; resid [m, n] in res_dtype or null; qs a
// device f32 scalar (requantize to int8) or null. Dtype codes: 0 = float32,
// 1 = bfloat16, 2 = int8 (out only, with qs). k a multiple of 64, n of 8.
extern "C" int cxr_int8_matmul_fused(const void* xq, const void* wq,
                                     const void* scale, const void* bias,
                                     const void* resid, const void* qs,
                                     void* out, int m, int n, int k,
                                     int do_gelu, int out_dtype, int res_dtype,
                                     int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % kBK || n % 8 ||
      (out_dtype == 2) != (qs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res_f32 = resid == nullptr || res_dtype == 0;
  if (resid != nullptr && res_dtype != 0 && res_dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == 0 && res_f32)
    return launch<float, float>(xq, wq, scale, bias, resid, qs, out, m, n, k,
                                do_gelu, st);
  if (out_dtype == 1 && (resid == nullptr || res_dtype == 1))
    return launch<__nv_bfloat16, __nv_bfloat16>(xq, wq, scale, bias, resid, qs,
                                                out, m, n, k, do_gelu, st);
  if (out_dtype == 2 && res_f32)
    return launch<int8_t, float>(xq, wq, scale, bias, resid, qs, out, m, n, k,
                                 do_gelu, st);
  if (out_dtype == 2)
    return launch<int8_t, __nv_bfloat16>(xq, wq, scale, bias, resid, qs, out, m,
                                         n, k, do_gelu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
