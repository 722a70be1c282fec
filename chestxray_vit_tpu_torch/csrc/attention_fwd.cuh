// The attention forward, O = softmax(Q K^T * scale) V, shared by the
// inference entry point (flash_attention_inf.cu, no lse) and the training
// one (flash_attention.cu, which also writes the natural-log logsumexp that
// the backward recomputes P from). See those files for which TPU kernel
// each replaces.
//
// A block owns 64 query rows of one (batch, head) and streams K/V through
// shared memory in 64-row tiles with an online (running max / running sum)
// softmax, so no score tile and no padded copy ever reaches device memory:
// q, k, v are read in place through their strides and the ragged key tail
// (S = 577 = 9 * 64 + 1 at ViT-B/16 @384) is masked to -inf in registers.
//
// What bounds it on an H100: at head_dim 64 and S = 577 the block does
// 4 * 64 * 577 * 64 flops over ~150 KB of K/V reads, so it is compute-bound
// on paper (arithmetic intensity ~60 flop/byte from L2, K/V of a head is
// re-read by the 10 query blocks). The bf16 path keeps both products on the
// tensor cores (mma.sync m16n8k16, f32 accumulation) and the softmax in f32
// registers; P is rounded to bf16 for the PV product and the normalizer
// sums the rounded P, so the output is a convex combination of V rows (the
// TPU kernel rounds the exp2 argument instead). The f32 path (used for
// parity runs) is plain FMA. wgmma, TMA and a cp.async pipeline are later
// work.
//
// The running max is kept in log2 units (score * scale * log2 e); the lse
// written for the backward is natural: m * ln 2 + ln l. Rows whose valid
// scores are all strongly negative stay finite: every key tile holds at
// least one valid key, so the running max is finite after the first tile
// and exp2(-inf - m) is exactly 0 for masked columns.
#pragma once

#include <math.h>

#include "common.cuh"

namespace cxr {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kHeadDim = 64;  // the only head dim built
constexpr int kPad = 8;       // bf16 row padding in shared memory (16 bytes)

// 128 threads = 4 warps; warp w owns query rows [16w, 16w + 16) of the
// block. lse (kLse only) is [B * H, S] contiguous, f32.
template <bool kLse>
__global__ void __launch_bounds__(128)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int H, int S, Strides qs, Strides ks,
              Strides vs, Strides os, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM][kHeadDim + kPad];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN][kHeadDim + kPad];
  __shared__ __align__(16) __nv_bfloat16 sVt[kHeadDim][kBlockN + kPad];

  const int m0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;
  __nv_bfloat16* op = o + b * os.b + h * os.h;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q tile: 64 rows x 8 vectors of 16 bytes; rows past S are zero
  for (int i = tid; i < kBlockM * 8; i += 128) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = zero;
    if (m0 + r < S)
      val = *reinterpret_cast<const uint4*>(qp + (m0 + r) * qs.s + c);
    *reinterpret_cast<uint4*>(&sQ[r][c]) = val;
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[4][4];
  load_a(sQ, wr, g, t, qf);

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8 (log2 units)
  float l_run[2] = {0.f, 0.f};              // this thread's share of the sum

  for (int n0 = 0; n0 < S; n0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockN * 8; i += 128) {
      const int r = i >> 3, c = (i & 7) * 8;
      uint4 kv = zero, vv = zero;
      if (n0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kp + (n0 + r) * ks.s + c);
        vv = *reinterpret_cast<const uint4*>(vp + (n0 + r) * vs.s + c);
      }
      *reinterpret_cast<uint4*>(&sK[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[c + j][r] = ve[j];
    }
    __syncthreads();

    // scores for 16 rows x 64 keys: 8 accumulator tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_b(sK, n * 8, kk * 16, g, t, b0, b1);
        mma_16816(s[n], qf[kk], b0, b1);
      }
    }

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + n * 8 + 2 * t + (e & 1);
        const float val = key < S ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = val;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_run[r], tile_max[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // P in bf16, laid out directly as the A operand of the PV product
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = round_bf16(exp2f(s[n][e] - m_run[e >> 1]));
        l_run[e >> 1] += s[n][e];
      }
    }
    uint32_t pf[4][4];
    acc_to_a(s, pf);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_b(sVt, n * 8, kk * 16, g, t, b0, b1);
        mma_16816(acc[n], pf[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int row0 = m0 + wr + g, row1 = row0 + 8;
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(op + row0 * os.s + c) =
          pack_bf16x2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(op + row1 * os.s + c) =
          pack_bf16x2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (kLse && t == 0) {
    float* lp = lse + static_cast<long long>(blockIdx.y) * S;
    if (row0 < S) lp[row0] = m_run[0] * kLn2 + logf(l_run[0]);
    if (row1 < S) lp[row1] = m_run[1] * kLn2 + logf(l_run[1]);
  }
}

// f32 path: one thread per query row, K/V tiles in shared memory read as
// broadcasts, online softmax over chunks of 16 keys.
template <bool kLse>
__global__ void __launch_bounds__(kBlockM)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int H, int S, Strides qs, Strides ks,
             Strides vs, Strides os, float scale_log2) {
  __shared__ __align__(16) float sK[kBlockN][kHeadDim];
  __shared__ __align__(16) float sV[kBlockN][kHeadDim];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBlockM + tid;
  const bool valid = row < S;

  float qr[kHeadDim], acc[kHeadDim];
  const float* qrow = q + b * qs.b + h * qs.h + (valid ? row : 0) * qs.s;
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(qrow + d);
    qr[d] = x.x;
    qr[d + 1] = x.y;
    qr[d + 2] = x.z;
    qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int n0 = 0; n0 < S; n0 += kBlockN) {
    __syncthreads();
    for (int i = tid; i < kBlockN * (kHeadDim / 4); i += kBlockM) {
      const int r = i / (kHeadDim / 4), c = (i % (kHeadDim / 4)) * 4;
      float4 kv = zero, vv = zero;
      if (n0 + r < S) {
        kv = *reinterpret_cast<const float4*>(kp + (n0 + r) * ks.s + c);
        vv = *reinterpret_cast<const float4*>(vp + (n0 + r) * vs.s + c);
      }
      *reinterpret_cast<float4*>(&sK[r][c]) = kv;
      *reinterpret_cast<float4*>(&sV[r][c]) = vv;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kBlockN; j0 += 16) {
      float s[16];
      float m_new = m_run;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) dot = fmaf(qr[d], sK[j0 + j][d], dot);
        s[j] = n0 + j0 + j < S ? dot * scale_log2 : -INFINITY;
        m_new = fmaxf(m_new, s[j]);
      }
      if (m_new == -INFINITY) continue;  // a chunk of masked keys only
      const float alpha = exp2f(m_run - m_new);
      m_run = m_new;
      l_run *= alpha;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = exp2f(s[j] - m_new);
        l_run += p;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(p, sV[j0 + j][d], acc[d]);
      }
    }
  }

  if (!valid) return;
  float* orow = o + b * os.b + h * os.h + row * os.s;
  const float inv = 1.f / l_run;
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 4)
    *reinterpret_cast<float4*>(orow + d) =
        make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv,
                    acc[d + 3] * inv);
  if (kLse)
    lse[static_cast<long long>(blockIdx.y) * S + row] =
        m_run * kLn2 + logf(l_run);
}

// Checks the shape, picks the kernel for the dtype (0 = float32,
// 1 = bfloat16) and launches it on ``stream``.
template <bool kLse>
int launch_attn_fwd(const void* q, const void* k, const void* v, void* o,
                    float* lse, int batch, int heads, int seq, int head_dim,
                    Strides qs, Strides ks, Strides vs, Strides os, float scale,
                    int dtype, int device, void* stream) {
  if (head_dim != kHeadDim || seq <= 0 || batch <= 0 || heads <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBlockM - 1) / kBlockM, batch * heads);
  const float scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    attn_fwd_bf16<kLse><<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        lse, heads, seq, qs, ks, vs, os, scale_log2);
  } else if (dtype == 0) {
    attn_fwd_f32<kLse><<<grid, kBlockM, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, heads, seq,
        qs, ks, vs, os, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cxr
