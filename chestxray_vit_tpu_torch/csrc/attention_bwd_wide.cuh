// The attention backward at head dims above 128 (attention_bwd.cuh takes
// d <= 128): dQ, dK, dV from the forward's O and lse with P recomputed,
// with and without dropout and segment ids (launch_bwd sends d > 128 here).
//
// The column split of attention_fwd_wide.cuh: dQ = dS K, dK = dS^T Q and
// dV = P^T dO split by output column once P and dS are known, and those
// need all of d only through S = Q K^T, dP = dO V^T and Delta =
// rowsum(dO * O). So:
// 1. attn_bwd_delta_wide: Delta over the whole d, a warp a row (before the
//    passes, which read it; at d <= 128 the dQ pass sums it itself).
// 2. attn_bwd_dq_wide_bf16: a block owns 64 query rows and one output chunk
//    of 128 dQ columns (the grid's third axis); for every key tile it forms
//    S by streaming Q and K in 64-column chunks through two swizzled tiles,
//    rounds P, then forms dP streaming dO and V the same way (so S's and
//    dP's accumulators are never live together), and adds dS K_chunk, K's
//    chunk columns read as they lie.
// 3. attn_bwd_dkdv_wide_bf16: a block owns 64 keys and one output chunk of
//    128 dK and dV columns; for every query tile S^T from K and Q chunks,
//    P^T, dP^T from V and dO chunks, then dV_chunk += P^T dO_chunk and
//    dK_chunk += dS^T Q_chunk.
// S and dP are recomputed once per output chunk (ceil(d / 128) times), the
// copies are not overlapped with a block's products (the SM's other blocks
// hide them), and no atomics are used: every output element is written
// once by one block. The arithmetic of P, dS and the dropout mask is that
// of attention_bwd.cuh.
//
// f32 (parity runs): plain FMA with a 32-column output chunk a block, a
// thread a row (query for dQ, key for dK/dV), S and dP summed over
// 16-column chunks of the own row (registers) and the walked tile (shared
// memory), 16 rows a walked tile.
//
// d is a multiple of 8 (the wrapper zero-pads any other d).
#pragma once

#include <math.h>

#include "common.cuh"

namespace cxr {
namespace wide {

constexpr int kBwdRows = 64;      // rows (queries or keys) a block owns
constexpr int kBwdCols = 128;     // output columns a bf16 block owns
constexpr int kBwdF32Cols = 32;   // output columns an f32 block owns

// Delta = rowsum(dO * O) over the whole head dim, a warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta_wide(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, int H, int S, int hd,
                    long long rows, Strides os, Strides dos) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const int bh = static_cast<int>(row / S), s = static_cast<int>(row % S);
  const int b = bh / H, h = bh % H;
  const T* orow = o + b * os.b + h * os.h + s * os.s;
  const T* drow = dout + b * dos.b + h * dos.h + s * dos.s;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32)
    acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// Shared memory of the bf16 passes: two chunk tiles, the two output tiles
// of each of the walked pair's operands they multiply (dQ: K's; dK/dV: Q's
// and dO's), 64 lse, 64 Delta and 64 ids, and 1024 bytes of alignment.
// The dQ pass fits the 48 KB default; the dK/dV pass is allowed more.
constexpr int kDqSmem = 4 * kTileBytes + 768 + 1024;
constexpr int kDkdvSmem = 6 * kTileBytes + 768 + 1024;
static_assert(kDqSmem <= 48 * 1024, "the wide dQ pass fits 48 KB");

template <bool kDropout, bool kSegment>
__global__ void __launch_bounds__(128, 2)
attn_bwd_dq_wide_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int H, int S, int hd,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dqs, float scale, float scale_log2,
                      Dropout drop, const int* __restrict__ seg) {
  constexpr int T = kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t ua = base, ub = base + T, ko = base + 2 * T;
  const int* sI = reinterpret_cast<const int*>(base_ptr + 4 * T);

  const int m0 = blockIdx.x * kBwdRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int col0 = blockIdx.z * kBwdCols;
  const int ocols = min(kBwdCols, hd - col0);
  const int nq = (hd + 63) / 64;
  const uint32_t dbh = kDropout ? drop_base(drop, b, h) : 0u;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* dop = dout + b * dos.b + h * dos.h;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int row0 = m0 + wr + g;
  float l2[2], dl[2];
  uint32_t dbase[2];
  int seg_row[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long idx = static_cast<long long>(bh) * S + row;
    l2[r] = row < S ? lse[idx] * kLog2e : INFINITY;  // pad rows: P = 0
    dl[r] = row < S ? delta[idx] : 0.f;
    dbase[r] = kDropout ? drop_row(drop, dbh, row) : 0u;
    if (kSegment) seg_row[r] = row < S ? segp[row] : kNoSegment;
  }
  float dqa[2][8][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      dqa[c][n][0] = dqa[c][n][1] = dqa[c][n][2] = dqa[c][n][3] = 0.f;
  acc_fence(dqa);

  TileWalk<kSegment> walk(segp, S, m0);
  for (int tile = walk.next(); tile >= 0; tile = walk.next()) {
    const int n0 = tile * kBwdRows, krows = min(kBwdRows, S - n0);
    __syncthreads();  // every thread is done with the previous tile
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
      copy_tile_async(ko + ch * T, kp + col0, ks.s, n0, S, ch, ocols);
    if (kSegment && tid < kBwdRows) {
      const bool ok = n0 + tid < S;
      cp_async_4(base + 4 * T + 512 + 4 * tid, segp + (ok ? n0 + tid : 0),
                 ok);
    }

    // S = Q K^T, chunk by chunk
    float sp[8][4];
    for (int c = 0; c < nq; ++c) {
      if (c > 0) __syncthreads();
      copy_tile_async(ua, qp, qs.s, m0, S, c, hd);
      copy_tile_async(ub, kp, ks.s, n0, S, c, hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      wgmma_fence();
      tile_mma_ss(sp, ua, ub, c > 0, chunk_steps(c, hd));
      wgmma_commit();
      wgmma_wait<0>(sp);
    }
    const int* sIt = sI + 128;  // the ids behind lse and Delta's slots
    uint32_t pp[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int kc = n * 8 + 2 * t, kk = n >> 1, hi = (n & 1) * 2;
      if (n * 8 >= krows) {
        pp[kk][hi] = pp[kk][hi + 1] = 0u;
        continue;
      }
      int id[2] = {0, 0};
      if (kSegment) {
        const int2 i2 = *reinterpret_cast<const int2*>(sIt + kc);
        id[0] = i2.x;
        id[1] = i2.y;
      }
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e & 1, r = e >> 1;
        bool ok = kc + j < krows;
        if (kSegment) ok = ok && id[j] == seg_row[r];
        pe[e] = ok ? exp2f(sp[n][e] * scale_log2 - l2[r]) : 0.f;
      }
      pp[kk][hi] = pack_bf16x2(pe[0], pe[1]);
      pp[kk][hi + 1] = pack_bf16x2(pe[2], pe[3]);
    }

    // dP = dO V^T, chunk by chunk
    float dp[8][4];
    for (int c = 0; c < nq; ++c) {
      __syncthreads();  // the previous chunk's product is done
      copy_tile_async(ua, dop, dos.s, m0, S, c, hd);
      copy_tile_async(ub, vp, vs.s, n0, S, c, hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      wgmma_fence();
      tile_mma_ss(dp, ua, ub, c > 0, chunk_steps(c, hd));
      wgmma_commit();
      wgmma_wait<0>(dp);
    }

    // dS = P * (M * dP / (1 - rate) - Delta), rounded to bf16
    uint32_t dsf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int kc = n * 8 + 2 * t, kk = n >> 1, hi = (n & 1) * 2;
      if (n * 8 >= krows) {
        dsf[kk][hi] = dsf[kk][hi + 1] = 0u;
        continue;
      }
      float de[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e & 1, r = e >> 1;
        const uint32_t w = pp[kk][hi + r];
        const float p = j ? bf16_hi(w) : bf16_lo(w);
        float dpe = dp[n][e];
        if (kDropout)
          dpe = kept(drop, dbase[r], n0 + kc + j) ? dpe * drop.inv_keep : 0.f;
        de[e] = p * (dpe - dl[r]);
      }
      dsf[kk][hi] = pack_bf16x2(de[0], de[1]);
      dsf[kk][hi + 1] = pack_bf16x2(de[2], de[3]);
    }
    // dQ_chunk += dS K_chunk
    wgmma_fence(dsf);
    tile_mma_rs<true>(dqa[0], dsf, ko, krows);
    if (ocols > 64) tile_mma_rs<true>(dqa[1], dsf, ko + T, krows);
    wgmma_commit();
    wgmma_wait<0>(dqa);
  }

  __nv_bfloat16* dqp = dq + b * dqs.b + h * dqs.h + col0;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = ch * 64 + n * 8 + 2 * t;
      if (c >= ocols) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < S)
          *reinterpret_cast<uint32_t*>(dqp + row * dqs.s + c) =
              pack_bf16x2(dqa[ch][n][2 * r] * scale,
                          dqa[ch][n][2 * r + 1] * scale);
      }
    }
}

template <bool kDropout, bool kSegment>
__global__ void __launch_bounds__(128, 2)
attn_bwd_dkdv_wide_bf16(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int H, int S, int hd,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dks, Strides dvs, float scale,
                        float scale_log2, Dropout drop,
                        const int* __restrict__ seg) {
  constexpr int T = kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t ua = base, ub = base + T, qo = base + 2 * T,
                 doo = base + 4 * T, aux = base + 6 * T;
  const float* sL = reinterpret_cast<const float*>(base_ptr + 6 * T);
  const float* sD = sL + kBwdRows;
  const int* sI = reinterpret_cast<const int*>(sD + kBwdRows);

  const int n0 = blockIdx.x * kBwdRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int col0 = blockIdx.z * kBwdCols;
  const int ocols = min(kBwdCols, hd - col0);
  const int nq = (hd + 63) / 64;
  const uint32_t dbh = kDropout ? drop_base(drop, b, h) : 0u;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* dop = dout + b * dos.b + h * dos.h;
  const float* lp = lse + static_cast<long long>(bh) * S;
  const float* dlp = delta + static_cast<long long>(bh) * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int key0 = n0 + wr + g;
  const bool key_ok[2] = {key0 < S, key0 + 8 < S};
  int seg_key[2] = {0, 0};
  if (kSegment) {
    seg_key[0] = key_ok[0] ? segp[key0] : kNoSegment;
    seg_key[1] = key_ok[1] ? segp[key0 + 8] : kNoSegment;
  }
  float dka[2][8][4], dva[2][8][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[c][n][e] = dva[c][n][e] = 0.f;
  acc_fence(dka);
  acc_fence(dva);

  TileWalk<kSegment> walk(segp, S, n0);
  for (int tile = walk.next(); tile >= 0; tile = walk.next()) {
    const int m0 = tile * kBwdRows, qrows = min(kBwdRows, S - m0);
    __syncthreads();  // every thread is done with the previous tile
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      copy_tile_async(qo + ch * T, qp + col0, qs.s, m0, S, ch, ocols);
      copy_tile_async(doo + ch * T, dop + col0, dos.s, m0, S, ch, ocols);
    }
    if (tid < kBwdRows) {
      const bool ok = m0 + tid < S;
      const int r = ok ? m0 + tid : 0;
      cp_async_4(aux + 4 * tid, lp + r, ok);
      cp_async_4(aux + 256 + 4 * tid, dlp + r, ok);
      if (kSegment) cp_async_4(aux + 512 + 4 * tid, segp + r, ok);
    }

    // S^T = K Q^T, chunk by chunk
    float sp[8][4];
    for (int c = 0; c < nq; ++c) {
      if (c > 0) __syncthreads();
      copy_tile_async(ua, kp, ks.s, n0, S, c, hd);
      copy_tile_async(ub, qp, qs.s, m0, S, c, hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      wgmma_fence();
      tile_mma_ss(sp, ua, ub, c > 0, chunk_steps(c, hd));
      wgmma_commit();
      wgmma_wait<0>(sp);
    }

    // P^T rounded to bf16; keep bit of element (query m0 + 8n + 2t +
    // (e & 1), key): bit 4n + e
    uint32_t pp[4][4], pf[4][4];
    uint32_t kmask = 0u;
    const uint32_t dbase =
        kDropout ? drop_row(drop, dbh, m0) + static_cast<uint32_t>(key0) : 0u;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int qc = n * 8 + 2 * t, kk = n >> 1, hi = (n & 1) * 2;
      if (n * 8 >= qrows) {
        pp[kk][hi] = pp[kk][hi + 1] = 0u;
        continue;
      }
      const float2 l = *reinterpret_cast<const float2*>(sL + qc);
      const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
      int id[2] = {0, 0};
      if (kSegment) {
        const int2 i2 = *reinterpret_cast<const int2*>(sI + qc);
        id[0] = i2.x;
        id[1] = i2.y;
      }
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e & 1, r = e >> 1;
        bool ok = key_ok[r] && qc + j < qrows;
        if (kSegment) ok = ok && id[j] == seg_key[r];
        pe[e] = ok ? exp2f(sp[n][e] * scale_log2 - l2[j]) : 0.f;
        const uint32_t counter =
            dbase + static_cast<uint32_t>(qc + j) * drop.s_pad;
        if (kDropout && kept(drop, counter, r * 8)) kmask |= 1u << (4 * n + e);
      }
      pp[kk][hi] = pack_bf16x2(pe[0], pe[1]);
      pp[kk][hi + 1] = pack_bf16x2(pe[2], pe[3]);
    }
    if (kDropout) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int bit = 4 * (2 * kk + (j >> 1)) + 2 * (j & 1);
          pf[kk][j] = pp[kk][j] & (((kmask >> bit) & 1u ? 0xFFFFu : 0u) |
                                   ((kmask >> (bit + 1)) & 1u ? 0xFFFF0000u
                                                              : 0u));
        }
    }

    // dP^T = V dO^T, chunk by chunk
    float dp[8][4];
    for (int c = 0; c < nq; ++c) {
      __syncthreads();
      copy_tile_async(ua, vp, vs.s, n0, S, c, hd);
      copy_tile_async(ub, dop, dos.s, m0, S, c, hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      wgmma_fence();
      tile_mma_ss(dp, ua, ub, c > 0, chunk_steps(c, hd));
      wgmma_commit();
      wgmma_wait<0>(dp);
    }

    // dS^T = P^T * (M * dP^T / (1 - rate) - Delta), rounded to bf16
    uint32_t dsf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int qc = n * 8 + 2 * t, kk = n >> 1, hi = (n & 1) * 2;
      if (n * 8 >= qrows) {
        dsf[kk][hi] = dsf[kk][hi + 1] = 0u;
        continue;
      }
      const float2 dl = *reinterpret_cast<const float2*>(sD + qc);
      float de[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t w = pp[kk][hi + (e >> 1)];
        const float p = e & 1 ? bf16_hi(w) : bf16_lo(w);
        float dpe = dp[n][e];
        if (kDropout)
          dpe = (kmask >> (4 * n + e)) & 1u ? dpe * drop.inv_keep : 0.f;
        de[e] = p * (dpe - (e & 1 ? dl.y : dl.x));
      }
      dsf[kk][hi] = pack_bf16x2(de[0], de[1]);
      dsf[kk][hi + 1] = pack_bf16x2(de[2], de[3]);
    }
    // dV_chunk += (M * P)^T dO_chunk, dK_chunk += dS^T Q_chunk
    wgmma_fence(dsf);
    wgmma_fence(kDropout ? pf : pp);
    tile_mma_rs<true>(dva[0], kDropout ? pf : pp, doo, qrows);
    if (ocols > 64) tile_mma_rs<true>(dva[1], kDropout ? pf : pp, doo + T, qrows);
    tile_mma_rs<true>(dka[0], dsf, qo, qrows);
    if (ocols > 64) tile_mma_rs<true>(dka[1], dsf, qo + T, qrows);
    wgmma_commit();
    wgmma_wait<0>(dva);
    acc_fence(dka);
  }

  __nv_bfloat16* dkp = dk + b * dks.b + h * dks.h + col0;
  __nv_bfloat16* dvp = dv + b * dvs.b + h * dvs.h + col0;
  const float vscale = kDropout ? drop.inv_keep : 1.f;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = ch * 64 + n * 8 + 2 * t;
      if (c >= ocols) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key_ok[r]) {
          *reinterpret_cast<uint32_t*>(dkp + key * dks.s + c) =
              pack_bf16x2(dka[ch][n][2 * r] * scale,
                          dka[ch][n][2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvp + key * dvs.s + c) =
              pack_bf16x2(dva[ch][n][2 * r] * vscale,
                          dva[ch][n][2 * r + 1] * vscale);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// f32: a thread a row, a 64-column output chunk a block
// ---------------------------------------------------------------------------

constexpr int kF32Walk = 16;    // walked rows a tile
constexpr int kF32Dot = 16;     // columns a chunk of the S and dP sums

// this thread's row chunk [c0, c0 + 16) (zeros at or past d)
__device__ __forceinline__ void load_row_chunk(const float* row, int c0,
                                               int hd, float (&x)[kF32Dot]) {
#pragma unroll
  for (int c = 0; c < kF32Dot; c += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 + c < hd) v = *reinterpret_cast<const float4*>(row + c0 + c);
    x[c] = v.x;
    x[c + 1] = v.y;
    x[c + 2] = v.z;
    x[c + 3] = v.w;
  }
}

// rows [r0, r0 + kF32Walk) x columns [c0, c0 + W) of a strided operand into
// dst (zeros at or past S or ``cols``), by the block's 64 threads
template <int W>
__device__ __forceinline__ void load_walk_tile(const float* src,
                                               long long stride, int r0,
                                               int S, int c0, int cols,
                                               float (*dst)[W]) {
  for (int i = threadIdx.x; i < kF32Walk * W / 4; i += kBwdRows) {
    const int r = i / (W / 4), c = (i % (W / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && c0 + c < cols)
      v = *reinterpret_cast<const float4*>(src + (r0 + r) * stride + c0 + c);
    *reinterpret_cast<float4*>(&dst[r][c]) = v;
  }
}

template <bool kDropout, bool kSegment>
__global__ void __launch_bounds__(kBwdRows)
attn_bwd_dq_wide_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int H, int S, int hd, Strides qs, Strides ks, Strides vs,
                     Strides dos, Strides dqs, float scale, float scale_log2,
                     Dropout drop, const int* __restrict__ seg) {
  __shared__ __align__(16) float sK[kF32Walk][kF32Dot];
  __shared__ __align__(16) float sV[kF32Walk][kF32Dot];
  __shared__ __align__(16) float sKo[kF32Walk][kBwdF32Cols];
  __shared__ int sSeg[kF32Walk];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBwdRows + tid;
  const bool row_ok = row < S;
  const int col0 = blockIdx.z * kBwdF32Cols;
  const int ocols = min(kBwdF32Cols, hd - col0);
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const float* qr = q + b * qs.b + h * qs.h + (row_ok ? row : 0) * qs.s;
  const float* dr = dout + b * dos.b + h * dos.h + (row_ok ? row : 0) * dos.s;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  const long long idx = static_cast<long long>(bh) * S + (row_ok ? row : 0);
  const float l2 = lse[idx] * kLog2e, dl = delta[idx];
  const uint32_t dbase =
      kDropout ? drop_row(drop, drop_base(drop, b, h), row) : 0u;
  const int seg_row = kSegment && row_ok ? segp[row] : kNoSegment;
  float dqa[kBwdF32Cols];
#pragma unroll
  for (int i = 0; i < kBwdF32Cols; ++i) dqa[i] = 0.f;

  for (int n0 = 0; n0 < S; n0 += kF32Walk) {
    float s[kF32Walk], dp[kF32Walk];
#pragma unroll
    for (int j = 0; j < kF32Walk; ++j) s[j] = dp[j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kF32Dot) {
      __syncthreads();
      load_walk_tile<kF32Dot>(kp, ks.s, n0, S, c0, hd, sK);
      load_walk_tile<kF32Dot>(vp, vs.s, n0, S, c0, hd, sV);
      if (kSegment && c0 == 0 && tid < kF32Walk)
        sSeg[tid] = n0 + tid < S ? segp[n0 + tid] : kNoSegment;
      float qc[kF32Dot], dc[kF32Dot];
      load_row_chunk(qr, c0, hd, qc);
      load_row_chunk(dr, c0, hd, dc);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kF32Walk; ++j)
#pragma unroll
        for (int i = 0; i < kF32Dot; ++i) {
          s[j] = fmaf(qc[i], sK[j][i], s[j]);
          dp[j] = fmaf(dc[i], sV[j][i], dp[j]);
        }
    }
    load_walk_tile<kBwdF32Cols>(kp, ks.s, n0, S, col0, hd, sKo);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kF32Walk; ++j) {
      bool ok = row_ok && n0 + j < S;
      if (kSegment) ok = ok && sSeg[j] == seg_row;
      const float p = ok ? exp2f(s[j] * scale_log2 - l2) : 0.f;
      float dpj = dp[j];
      if (kDropout)
        dpj = kept(drop, dbase, n0 + j) ? dpj * drop.inv_keep : 0.f;
      const float ds = p * (dpj - dl);
#pragma unroll
      for (int i = 0; i < kBwdF32Cols; ++i)
        dqa[i] = fmaf(ds, sKo[j][i], dqa[i]);
    }
  }
  if (!row_ok) return;
  float* dqr = dq + b * dqs.b + h * dqs.h + row * dqs.s + col0;
#pragma unroll
  for (int i = 0; i < kBwdF32Cols; ++i)
    if (i < ocols) dqr[i] = dqa[i] * scale;
}

template <bool kDropout, bool kSegment>
__global__ void __launch_bounds__(kBwdRows)
attn_bwd_dkdv_wide_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int H,
                       int S, int hd, Strides qs, Strides ks, Strides vs,
                       Strides dos, Strides dks, Strides dvs, float scale,
                       float scale_log2, Dropout drop,
                       const int* __restrict__ seg) {
  __shared__ __align__(16) float sQ[kF32Walk][kF32Dot];
  __shared__ __align__(16) float sdO[kF32Walk][kF32Dot];
  __shared__ __align__(16) float sQo[kF32Walk][kBwdF32Cols];
  __shared__ __align__(16) float sdOo[kF32Walk][kBwdF32Cols];
  __shared__ float sL[kF32Walk], sD[kF32Walk];
  __shared__ int sSeg[kF32Walk];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int key = blockIdx.x * kBwdRows + tid;
  const bool key_ok = key < S;
  const int col0 = blockIdx.z * kBwdF32Cols;
  const int ocols = min(kBwdF32Cols, hd - col0);
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const float* kr = k + b * ks.b + h * ks.h + (key_ok ? key : 0) * ks.s;
  const float* vr = v + b * vs.b + h * vs.h + (key_ok ? key : 0) * vs.s;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* dop = dout + b * dos.b + h * dos.h;
  const float* lp = lse + static_cast<long long>(bh) * S;
  const float* dlp = delta + static_cast<long long>(bh) * S;
  const uint32_t dbh = kDropout ? drop_base(drop, b, h) : 0u;
  const int seg_key = kSegment && key_ok ? segp[key] : kNoSegment;
  float dka[kBwdF32Cols], dva[kBwdF32Cols];
#pragma unroll
  for (int i = 0; i < kBwdF32Cols; ++i) dka[i] = dva[i] = 0.f;

  for (int m0 = 0; m0 < S; m0 += kF32Walk) {
    float s[kF32Walk], dp[kF32Walk];
#pragma unroll
    for (int j = 0; j < kF32Walk; ++j) s[j] = dp[j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kF32Dot) {
      __syncthreads();
      load_walk_tile<kF32Dot>(qp, qs.s, m0, S, c0, hd, sQ);
      load_walk_tile<kF32Dot>(dop, dos.s, m0, S, c0, hd, sdO);
      if (c0 == 0 && tid < kF32Walk) {
        const bool ok = m0 + tid < S;
        sL[tid] = ok ? lp[m0 + tid] * kLog2e : 0.f;
        sD[tid] = ok ? dlp[m0 + tid] : 0.f;
        if (kSegment) sSeg[tid] = ok ? segp[m0 + tid] : kNoSegment;
      }
      float kc[kF32Dot], vc[kF32Dot];
      load_row_chunk(kr, c0, hd, kc);
      load_row_chunk(vr, c0, hd, vc);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kF32Walk; ++j)
#pragma unroll
        for (int i = 0; i < kF32Dot; ++i) {
          s[j] = fmaf(kc[i], sQ[j][i], s[j]);
          dp[j] = fmaf(vc[i], sdO[j][i], dp[j]);
        }
    }
    load_walk_tile<kBwdF32Cols>(qp, qs.s, m0, S, col0, hd, sQo);
    load_walk_tile<kBwdF32Cols>(dop, dos.s, m0, S, col0, hd, sdOo);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kF32Walk; ++j) {
      bool ok = key_ok && m0 + j < S;
      if (kSegment) ok = ok && sSeg[j] == seg_key;
      const float p = ok ? exp2f(s[j] * scale_log2 - sL[j]) : 0.f;
      float dpj = dp[j], pv = p;
      if (kDropout) {
        const bool keep = kept(drop, drop_row(drop, dbh, m0 + j), key);
        dpj = keep ? dpj * drop.inv_keep : 0.f;
        pv = keep ? p : 0.f;
      }
      const float ds = p * (dpj - sD[j]);
#pragma unroll
      for (int i = 0; i < kBwdF32Cols; ++i) {
        dva[i] = fmaf(pv, sdOo[j][i], dva[i]);
        dka[i] = fmaf(ds, sQo[j][i], dka[i]);
      }
    }
  }
  if (!key_ok) return;
  float* dkr = dk + b * dks.b + h * dks.h + key * dks.s + col0;
  float* dvr = dv + b * dvs.b + h * dvs.h + key * dvs.s + col0;
  const float vscale = kDropout ? drop.inv_keep : 1.f;
#pragma unroll
  for (int i = 0; i < kBwdF32Cols; ++i) {
    if (i >= ocols) continue;
    dkr[i] = dka[i] * scale;
    dvr[i] = dva[i] * vscale;
  }
}

// Delta, then the dQ pass and the dK/dV pass, for the dtype (0 = float32,
// 1 = bfloat16) on ``device``, the current one; st holds the strides of q,
// k, v, o, dout, dq, dk, dv.
template <bool kDropout, bool kSegment>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* l, float* dl, void* dq,
               void* dk, void* dv, int batch, int heads, int seq,
               int head_dim, const Strides (&st)[8], float scale, int dtype,
               int device, cudaStream_t cs, const Dropout& drop,
               const int* seg) {
  const float scale_log2 = scale * kLog2e;
  const long long rows = static_cast<long long>(batch) * heads * seq;
  const unsigned delta_blocks = static_cast<unsigned>((rows + 7) / 8);
  const unsigned tiles = (seq + kBwdRows - 1) / kBwdRows, bh = batch * heads;
  cudaError_t err;
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    auto dqk = attn_bwd_dq_wide_bf16<kDropout, kSegment>;
    auto dkdv = attn_bwd_dkdv_wide_bf16<kDropout, kSegment>;
    if ((err = allow_smem<attn_bwd_dkdv_wide_bf16<kDropout, kSegment>,
                          kDkdvSmem>(device)) != cudaSuccess)
      return static_cast<int>(err);
    attn_bwd_delta_wide<bf><<<delta_blocks, 256, 0, cs>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(dout), dl, heads,
        seq, head_dim, rows, st[3], st[4]);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(tiles, bh, out_blocks(head_dim, kBwdCols));
    dqk<<<grid, 128, kDqSmem, cs>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), l, dl,
        static_cast<bf*>(dq), heads, seq, head_dim, st[0], st[1], st[2],
        st[4], st[5], scale, scale_log2, drop, seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dkdv<<<grid, 128, kDkdvSmem, cs>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), l, dl,
        static_cast<bf*>(dk), static_cast<bf*>(dv), heads, seq, head_dim,
        st[0], st[1], st[2], st[4], st[6], st[7], scale, scale_log2, drop,
        seg);
  } else if (dtype == 0) {
    attn_bwd_delta_wide<float><<<delta_blocks, 256, 0, cs>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dl,
        heads, seq, head_dim, rows, st[3], st[4]);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(tiles, bh, out_blocks(head_dim, kBwdF32Cols));
    attn_bwd_dq_wide_f32<kDropout, kSegment><<<grid, kBwdRows, 0, cs>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dq), heads, seq, head_dim, st[0], st[1], st[2],
        st[4], st[5], scale, scale_log2, drop, seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkdv_wide_f32<kDropout, kSegment><<<grid, kBwdRows, 0, cs>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dk), static_cast<float*>(dv), heads, seq,
        head_dim, st[0], st[1], st[2], st[4], st[6], st[7], scale, scale_log2,
        drop, seg);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide
}  // namespace cxr
