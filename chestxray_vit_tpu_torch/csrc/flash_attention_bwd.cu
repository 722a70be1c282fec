// Attention backward: dQ, dK, dV of O = softmax(Q K^T * scale) V from the
// forward's O and natural-log lse, with P recomputed (no [S, S] tensor is
// ever stored).
//
// Replaces the TPU kernel chestxray_vit_tpu/ops/flash_attention.py
// `_bwd_kernel` (launched by `_bwd`). That kernel holds a whole padded
// Q block and K/V row in VMEM and produces dQ, dK and dV in one grid step;
// with several Q blocks it accumulates dK/dV across the sequential grid.
// Hopper blocks run in no order, so this is the FlashAttention-2 split,
// without atomics and therefore deterministic:
//
// 1. attn_bwd_delta: Delta = rowsum(dO * O) in f32, one [B * H, S] row each.
// 2. attn_bwd_dkdv: one block per (batch * head, 64-key tile). It walks the
//    query tiles, recomputes P^T = exp2(S^T * scale * log2 e - lse * log2 e),
//    and accumulates dV += P^T dO and dK += dS^T Q with
//    dS = P * (dP - Delta) in f32 registers; dK * scale and dV are written
//    once, in the input dtype.
// 3. attn_bwd_dq: one block per (batch * head, 64-query tile), walking the
//    key tiles the same way and writing dQ * scale once.
//
// Query rows and key columns at or past S contribute nothing: pad query
// rows load lse = +inf (P = 0), pad keys are masked, and nothing past S is
// written. All eight tensors are read and written through their strides,
// so dq, dk and dv can be [B, H, S, d] views of [B, S, H, d] buffers that
// the projections' backward reads without a transpose copy.
//
// What bounds it on an H100: tensor-core throughput. Per (query tile, key
// tile) pair the dK/dV pass runs four 64 x 64 x 64 products (S, dV, dP,
// dK) and the dQ pass three (S, dP, dQ), 3.5x the forward's two, because
// S and dP are recomputed by both passes; bf16 runs them all as mma.sync
// m16n8k16 with f32 accumulation, from 64-row tiles in shared memory. P and dS
// are rounded to bf16 before their products, as the TPU kernel does
// (`p_lo`, `ds_lo`); P is rounded after the exp2, as in the forward. The
// f32 path (parity runs) is plain FMA with two threads per row.

#include <math.h>

#include "common.cuh"

namespace {

using cxr::Strides;
using cxr::kLog2e;

constexpr int kTile = 64;     // query rows or keys per tile
constexpr int kHeadDim = 64;  // the only head dim built
constexpr int kLd = kHeadDim + 8;  // bf16 row stride in shared memory

// ---------------------------------------------------------------------------
// Delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ delta, int H, int S, long long rows,
               Strides os, Strides dos) {
  constexpr int E = 16 / sizeof(T);       // elements per 16-byte vector
  constexpr int kLanes = kHeadDim / E;    // threads per row
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = gid / kLanes;
  const int part = static_cast<int>(gid % kLanes);
  float acc = 0.f;
  if (row < rows) {
    const int bh = static_cast<int>(row / S), s = static_cast<int>(row % S);
    const int b = bh / H, h = bh % H;
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * os.b + h * os.h + s * os.s + part * E);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * dos.b + h * dos.h + s * dos.s + part * E);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int j = 0; j < E; ++j) acc = fmaf(cxr::to_f32(oe[j]), cxr::to_f32(de[j]), acc);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles. 128 threads = 4 warps; warp w owns rows
// [16w, 16w + 16) of the block's tile (keys for dK/dV, queries for dQ).
// ---------------------------------------------------------------------------

// Copies a 64 x 64 tile starting at row r0 (rows past S as zeros) into
// ``dst`` and, if ``dst_t`` is given, its transpose into ``dst_t``.
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src,
                                          long long stride, int r0, int S,
                                          __nv_bfloat16 (*dst)[kLd],
                                          __nv_bfloat16 (*dst_t)[kLd]) {
  for (int i = threadIdx.x; i < kTile * 8; i += 128) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
    if (dst_t != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[c + j][r] = e[j];
    }
  }
}

__global__ void __launch_bounds__(128)
attn_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int S,
                   Strides qs, Strides ks, Strides vs, Strides dos,
                   Strides dks, Strides dvs, float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 sQt[kHeadDim][kLd];
  __shared__ __align__(16) __nv_bfloat16 sdO[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 sdOt[kHeadDim][kLd];
  __shared__ float sL[kTile], sD[kTile];

  const int n0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dop = dout + b * dos.b + h * dos.h;
  const float* lp = lse + static_cast<long long>(bh) * S;
  const float* dlp = delta + static_cast<long long>(bh) * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;

  // this warp's 16 keys and values as A fragments (staged through sQ/sdO)
  load_tile(k + b * ks.b + h * ks.h, ks.s, n0, S, sQ, nullptr);
  load_tile(v + b * vs.b + h * vs.h, vs.s, n0, S, sdO, nullptr);
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  cxr::load_a(sQ, wr, g, t, kf);
  cxr::load_a(sdO, wr, g, t, vf);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int key0 = n0 + wr + g;  // key of accumulator rows g; +8 for c2, c3

  for (int m0 = 0; m0 < S; m0 += kTile) {
    __syncthreads();  // the previous tiles (or the K/V staging) are consumed
    load_tile(qp, qs.s, m0, S, sQ, sQt);
    load_tile(dop, dos.s, m0, S, sdO, sdOt);
    if (tid < kTile) {
      const bool ok = m0 + tid < S;
      sL[tid] = ok ? lp[m0 + tid] * kLog2e : INFINITY;
      sD[tid] = ok ? dlp[m0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T: 16 keys x 64 queries
    float sp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sp[n][0] = sp[n][1] = sp[n][2] = sp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        cxr::load_b(sQ, n * 8, kk * 16, g, t, b0, b1);
        cxr::mma_16816(sp[n], kf[kk], b0, b1);
      }
    }
    // P^T in bf16; pad queries have lse = +inf, so exp2 gives exactly 0
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t + (e & 1);
        const bool key_ok = key0 + (e >> 1) * 8 < S;
        sp[n][e] = key_ok
            ? cxr::round_bf16(exp2f(sp[n][e] * scale_log2 - sL[qc])) : 0.f;
      }
    uint32_t pf[4][4];
    cxr::acc_to_a(sp, pf);
    // dV += P^T dO
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        cxr::load_b(sdOt, n * 8, kk * 16, g, t, b0, b1);
        cxr::mma_16816(dva[n], pf[kk], b0, b1);
      }
    // dP^T = V dO^T, then dS^T = P^T * (dP^T - Delta) in place
    float dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        cxr::load_b(sdO, n * 8, kk * 16, g, t, b0, b1);
        cxr::mma_16816(dp[n], vf[kk], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = sp[n][e] * (dp[n][e] - sD[n * 8 + 2 * t + (e & 1)]);
    }
    uint32_t dsf[4][4];
    cxr::acc_to_a(dp, dsf);
    // dK += dS^T Q
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        cxr::load_b(sQt, n * 8, kk * 16, g, t, b0, b1);
        cxr::mma_16816(dka[n], dsf[kk], b0, b1);
      }
  }

  __nv_bfloat16* dkp = dk + b * dks.b + h * dks.h;
  __nv_bfloat16* dvp = dv + b * dvs.b + h * dvs.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key < S) {
        *reinterpret_cast<uint32_t*>(dkp + key * dks.s + c) =
            cxr::pack_bf16x2(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvp + key * dvs.s + c) =
            cxr::pack_bf16x2(dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(128)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int H, int S, Strides qs,
                 Strides ks, Strides vs, Strides dos, Strides dqs, float scale,
                 float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sK[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 sKt[kHeadDim][kLd];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile][kLd];

  const int m0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;

  // this warp's 16 query rows of Q and dO as A fragments (staged)
  load_tile(q + b * qs.b + h * qs.h, qs.s, m0, S, sK, nullptr);
  load_tile(dout + b * dos.b + h * dos.h, dos.s, m0, S, sV, nullptr);
  __syncthreads();
  uint32_t qf[4][4], df[4][4];
  cxr::load_a(sK, wr, g, t, qf);
  cxr::load_a(sV, wr, g, t, df);

  const int row0 = m0 + wr + g;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long idx = static_cast<long long>(bh) * S + row;
    l2[r] = row < S ? lse[idx] * kLog2e : INFINITY;
    dl[r] = row < S ? delta[idx] : 0.f;
  }
  float dqa[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int n0 = 0; n0 < S; n0 += kTile) {
    __syncthreads();
    load_tile(kp, ks.s, n0, S, sK, sKt);
    load_tile(vp, vs.s, n0, S, sV, nullptr);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys
    float sp[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        cxr::load_b(sK, n * 8, kk * 16, g, t, b0, b1);
        cxr::mma_16816(sp[n], qf[kk], b0, b1);
        cxr::load_b(sV, n * 8, kk * 16, g, t, b0, b1);
        cxr::mma_16816(dp[n], df[kk], b0, b1);
      }
      // P (bf16, pad keys 0), then dS = P * (dP - Delta)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + n * 8 + 2 * t + (e & 1);
        const float p = key < S
            ? cxr::round_bf16(exp2f(sp[n][e] * scale_log2 - l2[e >> 1])) : 0.f;
        dp[n][e] = p * (dp[n][e] - dl[e >> 1]);
      }
    }
    uint32_t dsf[4][4];
    cxr::acc_to_a(dp, dsf);
    // dQ += dS K
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        cxr::load_b(sKt, n * 8, kk * 16, g, t, b0, b1);
        cxr::mma_16816(dqa[n], dsf[kk], b0, b1);
      }
  }

  __nv_bfloat16* dqp = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < S)
        *reinterpret_cast<uint32_t*>(dqp + row * dqs.s + c) =
            cxr::pack_bf16x2(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMA, two threads per row (thread ``half`` holds the elements
// 2i + half of the head dim), tiles of the other operand in shared memory.
// ---------------------------------------------------------------------------

constexpr int kHalf = kHeadDim / 2;

__device__ __forceinline__ void load_tile_f32(const float* src, long long stride,
                                              int r0, int S,
                                              float (*dst)[kHeadDim]) {
  for (int i = threadIdx.x; i < kTile * (kHeadDim / 4); i += 128) {
    const int r = i / (kHeadDim / 4), c = (i % (kHeadDim / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) val = *reinterpret_cast<const float4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<float4*>(&dst[r][c]) = val;
  }
}

__device__ __forceinline__ float pair_dot(const float (&a)[kHalf],
                                          const float* row, int half) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) s = fmaf(a[i], row[2 * i + half], s);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

__global__ void __launch_bounds__(128)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int H, int S,
                  Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                  Strides dvs, float scale, float scale_log2) {
  __shared__ __align__(16) float sQ[kTile][kHeadDim];
  __shared__ __align__(16) float sdO[kTile][kHeadDim];
  __shared__ float sL[kTile], sD[kTile];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int key = blockIdx.x * kTile + (threadIdx.x >> 1);
  const int half = threadIdx.x & 1;
  const bool key_ok = key < S;
  const float* kr = k + b * ks.b + h * ks.h + (key_ok ? key : 0) * ks.s;
  const float* vr = v + b * vs.b + h * vs.h + (key_ok ? key : 0) * vs.s;
  float kv[kHalf], vv[kHalf], dka[kHalf], dva[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    kv[i] = kr[2 * i + half];
    vv[i] = vr[2 * i + half];
    dka[i] = dva[i] = 0.f;
  }
  const float* qp = q + b * qs.b + h * qs.h;
  const float* dop = dout + b * dos.b + h * dos.h;
  const float* lp = lse + static_cast<long long>(bh) * S;
  const float* dlp = delta + static_cast<long long>(bh) * S;

  for (int m0 = 0; m0 < S; m0 += kTile) {
    __syncthreads();
    load_tile_f32(qp, qs.s, m0, S, sQ);
    load_tile_f32(dop, dos.s, m0, S, sdO);
    if (threadIdx.x < kTile && m0 + threadIdx.x < S) {
      sL[threadIdx.x] = lp[m0 + threadIdx.x] * kLog2e;
      sD[threadIdx.x] = dlp[m0 + threadIdx.x];
    }
    __syncthreads();
    const int jn = min(kTile, S - m0);
    for (int j = 0; j < jn; ++j) {
      const float s = pair_dot(kv, sQ[j], half);
      const float p = key_ok ? exp2f(s * scale_log2 - sL[j]) : 0.f;
      const float dp = pair_dot(vv, sdO[j], half);
      const float ds = p * (dp - sD[j]);
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        dva[i] = fmaf(p, sdO[j][2 * i + half], dva[i]);
        dka[i] = fmaf(ds, sQ[j][2 * i + half], dka[i]);
      }
    }
  }
  if (!key_ok) return;
  float* dkr = dk + b * dks.b + h * dks.h + key * dks.s;
  float* dvr = dv + b * dvs.b + h * dvs.h + key * dvs.s;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    dkr[2 * i + half] = dka[i] * scale;
    dvr[2 * i + half] = dva[i];
  }
}

__global__ void __launch_bounds__(128)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int H, int S, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dqs, float scale,
                float scale_log2) {
  __shared__ __align__(16) float sK[kTile][kHeadDim];
  __shared__ __align__(16) float sV[kTile][kHeadDim];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row = blockIdx.x * kTile + (threadIdx.x >> 1);
  const int half = threadIdx.x & 1;
  const bool row_ok = row < S;
  const float* qr = q + b * qs.b + h * qs.h + (row_ok ? row : 0) * qs.s;
  const float* dr = dout + b * dos.b + h * dos.h + (row_ok ? row : 0) * dos.s;
  float qv[kHalf], dov[kHalf], dqa[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    qv[i] = qr[2 * i + half];
    dov[i] = dr[2 * i + half];
    dqa[i] = 0.f;
  }
  const long long idx = static_cast<long long>(bh) * S + (row_ok ? row : 0);
  const float l2 = lse[idx] * kLog2e, dl = delta[idx];
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;

  for (int n0 = 0; n0 < S; n0 += kTile) {
    __syncthreads();
    load_tile_f32(kp, ks.s, n0, S, sK);
    load_tile_f32(vp, vs.s, n0, S, sV);
    __syncthreads();
    const int jn = min(kTile, S - n0);
    for (int j = 0; j < jn; ++j) {
      const float s = pair_dot(qv, sK[j], half);
      const float p = exp2f(s * scale_log2 - l2);
      const float ds = p * (pair_dot(dov, sV[j], half) - dl);
#pragma unroll
      for (int i = 0; i < kHalf; ++i) dqa[i] = fmaf(ds, sK[j][2 * i + half], dqa[i]);
    }
  }
  if (!row_ok) return;
  float* dqr = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) dqr[2 * i + half] = dqa[i] * scale;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ``strides`` holds (batch, head, seq)
// element strides of q, k, v, o, dout, dq, dk, dv in that order (24
// values); every head dim is contiguous with 16-byte aligned rows (the
// wrapper checks). lse and the ``delta`` workspace are contiguous f32
// [batch * heads, seq].
extern "C" int cxr_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int batch, int heads,
                                 int seq, int head_dim,
                                 const long long* strides, float scale,
                                 int dtype, int device, void* stream) {
  if (head_dim != kHeadDim || seq <= 0 || batch <= 0 || heads <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(batch) * heads * seq;
  const int lanes = dtype == 1 ? 8 : 16;
  const unsigned delta_blocks =
      static_cast<unsigned>((rows * lanes + 255) / 256);
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  const float scale_log2 = scale * kLog2e;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    attn_bwd_delta<bf><<<delta_blocks, 256, 0, cs>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(dout), dl, heads,
        seq, rows, st[3], st[4]);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkdv_bf16<<<grid, 128, 0, cs>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), l, dl,
        static_cast<bf*>(dk), static_cast<bf*>(dv), heads, seq, st[0],
        st[1], st[2], st[4], st[6], st[7], scale, scale_log2);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dq_bf16<<<grid, 128, 0, cs>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), l, dl,
        static_cast<bf*>(dq), heads, seq, st[0], st[1], st[2], st[4], st[5],
        scale, scale_log2);
  } else {
    attn_bwd_delta<float><<<delta_blocks, 256, 0, cs>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dl,
        heads, seq, rows, st[3], st[4]);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkdv_f32<<<grid, 128, 0, cs>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dk), static_cast<float*>(dv), heads, seq, st[0],
        st[1], st[2], st[4], st[6], st[7], scale, scale_log2);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dq_f32<<<grid, 128, 0, cs>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dq), heads, seq, st[0], st[1], st[2], st[4],
        st[5], scale, scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}
