// The attention backward at head dims above 128 (attention_bwd.cuh takes
// d <= 128): dQ, dK, dV from the forward's O and lse with P recomputed,
// with and without dropout and segment ids (launch_bwd sends d > 128 here).
// It replaces the same TPU kernels as attention_bwd.cuh at these widths:
// chestxray_vit_tpu/ops/flash_attention.py `_bwd_kernel`, `_bwd_kernel_drop`,
// `_bwd_kernel_seg` and `_bwd_kernel_seg_drop`, which take the head dim
// whole.
//
// dQ = dS K, dK = dS^T Q and dV = P^T dO split by output column once P and
// dS are known, and those need all of d only through S = Q K^T, dP = dO V^T
// and Delta = rowsum(dO * O). So:
// 1. attn_bwd_delta_wide: Delta over the whole d, a warp a row (before the
//    passes, which read it; at d <= 128 the dQ pass sums it itself).
// 2. attn_bwd_dq_wide_bf16: a block of two warpgroups owns 64 query rows
//    and 256 dQ columns (the grid's third axis), 128 a warpgroup. For
//    every key tile warpgroup 0 forms S while warpgroup 1 forms dP, each
//    over the whole d from 64-column chunk tiles; warpgroup 0 rounds P and
//    hands it to warpgroup 1 through a swizzled tile in shared memory,
//    which forms dS (the dropout mask hashed there) and hands it back the
//    same way; each then adds dS K_chunk to its own two 64-column chunks,
//    and while those products run the next tile's S and dP are issued.
// 3. attn_bwd_dkdv_wide_bf16: a block owns 64 keys and 256 dK and dV
//    columns. Warpgroup 0 forms S^T, rounds P^T, hashes the keep mask,
//    hands both to warpgroup 1 and adds (M P)^T dO_chunk to dV over all
//    256 columns; warpgroup 1 forms dP^T, then dS^T, and adds dS^T
//    Q_chunk to dK. One hand-over a tile, and each warpgroup's 128
//    accumulator registers hold one output.
// What bounds it on an H100: operations, 10 S^2 d flops a head (S, dP, dV,
// dQ, dK); a two-pass design without atomics forms S and dP in both
// passes, 14. S and dP are formed once per (query tile, key tile) for 256
// output columns, so at d = 256 once in all. Up to 256 columns
// the block's own operands (Q and dO in the dQ pass, K and V in the dK/dV
// pass) stay in shared memory, and the walked ones stream through two
// stages, the next tile's copies issued before the current tile's products.
// Past 256 columns the walk goes through d in blocks of four chunks, one
// stage, the own output block's walked chunks read again after the others
// where it is not the last, so nothing grows with d. No atomics: every
// output element is written once by one block. The arithmetic of P, dS
// and the dropout mask is that of attention_bwd.cuh.
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
constexpr int kBwdCols = 256;     // output columns a bf16 block owns
constexpr int kBwdF32Cols = 32;   // output columns an f32 block owns
constexpr int kBwdThreads = 256;  // two warpgroups
constexpr int kBwdChunks = kBwdCols / 64;  // an operand block's chunk tiles
static_assert(kBwdChunks == kBlockChunks, "wg_copy_block's blocks");

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

// Shared memory of the bf16 passes, from a 1024-byte aligned base: the
// block's own operands (two of four chunk tiles each), two stages of the
// walked pair, the P and dS tiles, each stage's 64 lse, Delta and ids, the
// 128 keep-mask words, and 1024 bytes of alignment.
constexpr int kOpBytes = kBwdChunks * kTileBytes;   // an operand's block
constexpr int kStageBytes = 2 * kOpBytes;
constexpr int kOwnOff = 0;
constexpr int kStageOff = kOwnOff + 2 * kOpBytes;
constexpr int kPOff = kStageOff + 2 * kStageBytes;
constexpr int kDsOff = kPOff + kTileBytes;
constexpr int kAuxOff = kDsOff + kTileBytes;
constexpr int kAuxBytes = 3 * kBwdRows * 4;
constexpr int kMaskOff = kAuxOff + 2 * kAuxBytes;
constexpr int kWideBwdSmem = kMaskOff + 128 * 4 + 1024;
static_assert(kWideBwdSmem <= 227 * 1024, "the wide backward fits an SM");
constexpr int kBarP = 1, kBarDs = 2;  // named barriers: P, then dS handed over

template <bool kDropout, bool kSegment>
__global__ void __launch_bounds__(kBwdThreads, 1)
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
  unsigned char* base_ptr = smem_raw + (base - raw);

  const int m0 = blockIdx.x * kBwdRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int oc = blockIdx.z;  // output columns [256 oc, 256 oc + 256)
  const int nq = (hd + 63) / 64, nb = (nq + kBwdChunks - 1) / kBwdChunks;
  const uint32_t dbh = kDropout ? drop_base(drop, b, h) : 0u;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* dop = dout + b * dos.b + h * dos.h;

  // the warpgroup, read from lane 0 so that the compiler knows it uniform
  // over each warp (wgmma under a branch on it is then not serialized)
  const int tid = threadIdx.x, t128 = tid & 127;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = t128 >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int row0 = m0 + wr + g;
  // warpgroup 0: S from Q and K; 1: dP from dO and V
  const __nv_bfloat16* own = wg ? dop : qp;
  const __nv_bfloat16* walked = wg ? vp : kp;
  const long long own_s = wg ? dos.s : qs.s, walked_s = wg ? vs.s : ks.s;
  const int cown = kBwdChunks * oc + 2 * wg;  // this warpgroup's first chunk
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

  const uint32_t own_tiles = base + kOwnOff + wg * kOpBytes;
  auto stage = [&](int st) { return base + kStageOff + st * kStageBytes; };
  // the walked tile's chunk block c0 (this warpgroup's operand) and, from
  // warpgroup 0, the key ids into stage st
  auto load_walked = [&](int n0, int st, int c0) {
    wg_copy_block(stage(st) + wg * kOpBytes, walked, walked_s, n0, S, c0, nq,
                  hd, t128);
    if (kSegment && tid < kBwdRows) {
      const bool ok = n0 + tid < S;
      cp_async_4(base + kAuxOff + st * kAuxBytes + 4 * tid,
                 segp + (ok ? n0 + tid : 0), ok);
    }
  };

  // The tile at n0 in stage st, S (warpgroup 0) or dP (1) in sp: P and dS
  // handed over, then dQ_chunk += dS K_chunk on this warpgroup's two
  // chunks, issued and committed.
  auto finish_tile = [&](int n0, int st, float (&sp)[8][4]) {
    const int krows = min(kBwdRows, S - n0);
    const uint32_t ktiles = stage(st);  // K's chunks of the output block
    const int* sIt = reinterpret_cast<const int*>(base_ptr + kAuxOff +
                                                  st * kAuxBytes);
    uint32_t pp[4][4], dsf[4][4];
    if (wg == 0) {
      // P rounded to bf16, handed over
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
      store_a_swizzled(base_ptr + kPOff, wr, lane, pp);
      bar_arrive(kBarP, kBwdThreads);
      bar_sync(kBarDs, kBwdThreads);
      load_a_swizzled(base + kDsOff, wr, lane, dsf);
    } else {
      bar_sync(kBarP, kBwdThreads);
      load_a_swizzled(base + kPOff, wr, lane, pp);
      // dS = P * (M * dP / (1 - rate) - Delta), rounded to bf16
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
          float dpe = sp[n][e];
          if (kDropout)
            dpe = kept(drop, dbase[r], n0 + kc + j) ? dpe * drop.inv_keep
                                                    : 0.f;
          de[e] = p * (dpe - dl[r]);
        }
        dsf[kk][hi] = pack_bf16x2(de[0], de[1]);
        dsf[kk][hi + 1] = pack_bf16x2(de[2], de[3]);
      }
      store_a_swizzled(base_ptr + kDsOff, wr, lane, dsf);
      bar_arrive(kBarDs, kBwdThreads);
    }
    wgmma_fence(dsf);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (cown + i < nq)
        tile_mma_rs<true>(dqa[i], dsf, ktiles + (2 * wg + i) * T, krows);
    wgmma_commit();
  };

  TileWalk<kSegment> walk(segp, S, m0);
  int tile = walk.next();
  float sp[8][4];  // warpgroup 0: S; 1: dP
  if (nb == 1 && tile >= 0) {
    // The walk, pipelined: the own block stays; while a tile's dQ products
    // run, the next tile's S and dP are issued, and the tile after it is
    // copied into the stage the products are done with (here, unlike in
    // the dK/dV pass, that fits the registers without a spill).
    wg_copy_block(own_tiles, own, own_s, m0, S, 0, nq, hd, t128);
    load_walked(tile * kBwdRows, 0, 0);
    cp_async_commit();
    int next = walk.next();
    cp_async_wait<0>();
    __syncthreads();
    if (next >= 0) load_walked(next * kBwdRows, 1, 0);
    cp_async_commit();
    block_mma(sp, own_tiles, stage(0) + wg * kOpBytes, 0, nq, hd);
    wgmma_wait<0>(sp);
    int st = 0;
    while (tile >= 0) {
      finish_tile(tile * kBwdRows, st, sp);
      cp_async_wait<0>();
      __syncthreads();  // the next tile arrived; the hand-over tiles are free
      if (next >= 0)
        block_mma(sp, own_tiles, stage(st ^ 1) + wg * kOpBytes, 0, nq, hd);
      wgmma_wait<0>(dqa);
      acc_fence(sp);
      __syncthreads();  // both warpgroups' products are done with stage st
      int after = -1;
      if (next >= 0) {
        after = walk.next();
        if (after >= 0) load_walked(after * kBwdRows, st, 0);
      }
      cp_async_commit();
      tile = next;
      next = after;
      st ^= 1;
    }
  }
  // Past 256 columns: d in blocks of four chunks through stage 0, a tile at
  // a time.
  for (; nb > 1 && tile >= 0; tile = walk.next()) {
    const int n0 = tile * kBwdRows;
    for (int cb = 0; cb < nb; ++cb) {
      __syncthreads();  // every thread is done with the previous block
      wg_copy_block(own_tiles, own, own_s, m0, S, cb * kBwdChunks, nq, hd,
                    t128);
      if (cb == 0)
        load_walked(n0, 0, 0);
      else
        wg_copy_block(stage(0) + wg * kOpBytes, walked, walked_s, n0, S,
                      cb * kBwdChunks, nq, hd, t128);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      block_mma(sp, own_tiles, stage(0) + wg * kOpBytes, cb * kBwdChunks, nq,
                hd);
      wgmma_wait<0>(sp);
    }
    if (oc != nb - 1) {  // K's chunks of this block's output columns
      __syncthreads();
      if (wg == 0)
        wg_copy_block(stage(0), kp, ks.s, n0, S, oc * kBwdChunks, nq, hd,
                      t128);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    finish_tile(n0, 0, sp);
    wgmma_wait<0>(dqa);
  }

  __nv_bfloat16* dqp = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = (cown + i) * 64 + n * 8 + 2 * t;
      if (c >= hd) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < S)
          *reinterpret_cast<uint32_t*>(dqp + row * dqs.s + c) =
              pack_bf16x2(dqa[i][n][2 * r] * scale,
                          dqa[i][n][2 * r + 1] * scale);
      }
    }
}

template <bool kDropout, bool kSegment>
__global__ void __launch_bounds__(kBwdThreads, 1)
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
  unsigned char* base_ptr = smem_raw + (base - raw);
  uint32_t* sMask = reinterpret_cast<uint32_t*>(base_ptr + kMaskOff);

  const int n0 = blockIdx.x * kBwdRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int oc = blockIdx.z;  // output columns [256 oc, 256 oc + 256)
  const int nq = (hd + 63) / 64, nb = (nq + kBwdChunks - 1) / kBwdChunks;
  const uint32_t dbh = kDropout ? drop_base(drop, b, h) : 0u;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* dop = dout + b * dos.b + h * dos.h;
  const float* lp = lse + static_cast<long long>(bh) * S;
  const float* dlp = delta + static_cast<long long>(bh) * S;

  // the warpgroup, read from lane 0 so that the compiler knows it uniform
  // over each warp (wgmma under a branch on it is then not serialized)
  const int tid = threadIdx.x, t128 = tid & 127;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = t128 >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int key0 = n0 + wr + g;
  const bool key_ok[2] = {key0 < S, key0 + 8 < S};
  int seg_key[2] = {0, 0};
  if (kSegment) {
    seg_key[0] = key_ok[0] ? segp[key0] : kNoSegment;
    seg_key[1] = key_ok[1] ? segp[key0 + 8] : kNoSegment;
  }
  // warpgroup 0: S^T from K and Q, then dV from (M * P)^T and dO;
  // warpgroup 1: dP^T from V and dO, then dK from dS^T and Q
  const __nv_bfloat16* own = wg ? vp : kp;
  const __nv_bfloat16* walked = wg ? dop : qp;
  const long long own_s = wg ? vs.s : ks.s, walked_s = wg ? dos.s : qs.s;
  const int c0 = kBwdChunks * oc;  // the output block's first chunk
  float acc[kBwdChunks][8][4];     // warpgroup 0: dV; 1: dK
#pragma unroll
  for (int c = 0; c < kBwdChunks; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][n][e] = 0.f;
  acc_fence(acc);

  const uint32_t own_tiles = base + kOwnOff + wg * kOpBytes;
  auto stage = [&](int st) { return base + kStageOff + st * kStageBytes; };
  // the walked tile's chunk block c0 (this warpgroup's operand) and, from
  // warpgroup 0, its lse, Delta and ids into stage st
  auto load_walked = [&](int m0, int st, int cb0) {
    wg_copy_block(stage(st) + wg * kOpBytes, walked, walked_s, m0, S, cb0,
                  nq, hd, t128);
    if (tid < kBwdRows) {
      const bool ok = m0 + tid < S;
      const int r = ok ? m0 + tid : 0;
      const uint32_t aux = base + kAuxOff + st * kAuxBytes;
      cp_async_4(aux + 4 * tid, lp + r, ok);
      cp_async_4(aux + 256 + 4 * tid, dlp + r, ok);
      if (kSegment) cp_async_4(aux + 512 + 4 * tid, segp + r, ok);
    }
  };

  // The tile at m0 in stage st, S^T (warpgroup 0) or dP^T (1) in sp:
  // warpgroup 0 rounds P^T and hashes the keep mask, hands both over and
  // adds (M * P)^T dO_chunk to dV; warpgroup 1 forms dS^T from them and
  // adds dS^T Q_chunk to dK, over the output block's chunks, issued and
  // committed.
  auto finish_tile = [&](int m0, int st, float (&sp)[8][4]) {
    const int qrows = min(kBwdRows, S - m0);
    const float* sL = reinterpret_cast<const float*>(base_ptr + kAuxOff +
                                                     st * kAuxBytes);
    const float* sD = sL + kBwdRows;
    const int* sI = reinterpret_cast<const int*>(sD + kBwdRows);
    uint32_t a[4][4];  // warpgroup 0: M * P^T; 1: dS^T
    if (wg == 0) {
      uint32_t kmask = 0u;  // keep bit of element (query 8n + 2t + (e & 1),
                            // key): bit 4n + e
      const uint32_t dbase =
          kDropout ? drop_row(drop, dbh, m0) + static_cast<uint32_t>(key0)
                   : 0u;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int qc = n * 8 + 2 * t, kk = n >> 1, hi = (n & 1) * 2;
        if (n * 8 >= qrows) {
          a[kk][hi] = a[kk][hi + 1] = 0u;
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
          if (kDropout && kept(drop, counter, r * 8))
            kmask |= 1u << (4 * n + e);
        }
        a[kk][hi] = pack_bf16x2(pe[0], pe[1]);
        a[kk][hi + 1] = pack_bf16x2(pe[2], pe[3]);
      }
      store_a_swizzled(base_ptr + kPOff, wr, lane, a);
      if (kDropout) {
        sMask[t128] = kmask;
        // M * P^T, in place
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int bit = 4 * (2 * kk + (j >> 1)) + 2 * (j & 1);
            a[kk][j] &= ((kmask >> bit) & 1u ? 0xFFFFu : 0u) |
                        ((kmask >> (bit + 1)) & 1u ? 0xFFFF0000u : 0u);
          }
      }
      bar_arrive(kBarP, kBwdThreads);
    } else {
      bar_sync(kBarP, kBwdThreads);
      const uint32_t kmask = kDropout ? sMask[t128] : 0u;
      // dS^T = P^T * (M * dP^T / (1 - rate) - Delta), rounded to bf16; P^T
      // read back 16 columns at a time
      uint32_t pk[4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int qc = n * 8 + 2 * t, kk = n >> 1, hi = (n & 1) * 2;
        if (hi == 0) load_a_swizzled(base + kPOff, wr, lane, kk, pk);
        if (n * 8 >= qrows) {
          a[kk][hi] = a[kk][hi + 1] = 0u;
          continue;
        }
        const float2 dl = *reinterpret_cast<const float2*>(sD + qc);
        float de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t w = pk[hi + (e >> 1)];
          const float p = e & 1 ? bf16_hi(w) : bf16_lo(w);
          float dpe = sp[n][e];
          if (kDropout)
            dpe = (kmask >> (4 * n + e)) & 1u ? dpe * drop.inv_keep : 0.f;
          de[e] = p * (dpe - (e & 1 ? dl.y : dl.x));
        }
        a[kk][hi] = pack_bf16x2(de[0], de[1]);
        a[kk][hi + 1] = pack_bf16x2(de[2], de[3]);
      }
    }
    // dV_chunk += (M * P)^T dO_chunk (0) or dK_chunk += dS^T Q_chunk (1):
    // the other operand of the walked pair's chunks in this stage
    const uint32_t btiles = stage(st) + (1 - wg) * kOpBytes;
    wgmma_fence(a);
#pragma unroll
    for (int c = 0; c < kBwdChunks; ++c)
      if (c0 + c < nq)
        tile_mma_rs<true>(acc[c], a, btiles + c * T, qrows);
    wgmma_commit();
  };

  TileWalk<kSegment> walk(segp, S, n0);
  int tile = walk.next();
  float sp[8][4];  // warpgroup 0: S^T; 1: dP^T
  if (nb == 1 && tile >= 0) {
    // The own block stays; the next tile is copied into the other stage
    // while this one's products run.
    wg_copy_block(own_tiles, own, own_s, n0, S, 0, nq, hd, t128);
    load_walked(tile * kBwdRows, 0, 0);
    cp_async_commit();
    int st = 0;
    while (tile >= 0) {
      const int next = walk.next();
      cp_async_wait<0>();
      __syncthreads();  // the tile arrived; the other stage is free
      if (next >= 0) load_walked(next * kBwdRows, st ^ 1, 0);
      cp_async_commit();
      block_mma(sp, own_tiles, stage(st) + wg * kOpBytes, 0, nq, hd);
      wgmma_wait<0>(sp);
      finish_tile(tile * kBwdRows, st, sp);
      wgmma_wait<0>(acc);
      st ^= 1;
      tile = next;
    }
  }
  // Past 256 columns: d in blocks of four chunks through stage 0, a tile at
  // a time.
  for (; nb > 1 && tile >= 0; tile = walk.next()) {
    const int m0 = tile * kBwdRows;
    for (int cb = 0; cb < nb; ++cb) {
      __syncthreads();  // every thread is done with the previous block
      wg_copy_block(own_tiles, own, own_s, n0, S, cb * kBwdChunks, nq, hd,
                    t128);
      if (cb == 0)
        load_walked(m0, 0, 0);
      else
        wg_copy_block(stage(0) + wg * kOpBytes, walked, walked_s, m0, S,
                      cb * kBwdChunks, nq, hd, t128);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      block_mma(sp, own_tiles, stage(0) + wg * kOpBytes, cb * kBwdChunks, nq,
                hd);
      wgmma_wait<0>(sp);
    }
    if (oc != nb - 1) {  // Q's and dO's chunks of the output columns
      __syncthreads();
      wg_copy_block(stage(0) + wg * kOpBytes, walked, walked_s, m0, S, c0, nq,
                    hd, t128);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    finish_tile(m0, 0, sp);
    wgmma_wait<0>(acc);
  }

  // warpgroup 0 writes dV (times 1 / (1 - rate)), 1 writes dK (times the
  // softmax scale)
  __nv_bfloat16* out = wg ? dk + b * dks.b + h * dks.h
                          : dv + b * dvs.b + h * dvs.h;
  const long long out_s = wg ? dks.s : dvs.s;
  const float oscale = wg ? scale : kDropout ? drop.inv_keep : 1.f;
#pragma unroll
  for (int c = 0; c < kBwdChunks; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = (c0 + c) * 64 + n * 8 + 2 * t;
      if (col >= hd) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key_ok[r])
          *reinterpret_cast<uint32_t*>(out + key * out_s + col) =
              pack_bf16x2(acc[c][n][2 * r] * oscale,
                          acc[c][n][2 * r + 1] * oscale);
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
    if ((err = allow_smem<attn_bwd_dq_wide_bf16<kDropout, kSegment>,
                          kWideBwdSmem>(device)) != cudaSuccess ||
        (err = allow_smem<attn_bwd_dkdv_wide_bf16<kDropout, kSegment>,
                          kWideBwdSmem>(device)) != cudaSuccess)
      return static_cast<int>(err);
    attn_bwd_delta_wide<bf><<<delta_blocks, 256, 0, cs>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(dout), dl, heads,
        seq, head_dim, rows, st[3], st[4]);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(tiles, bh, out_blocks(head_dim, kBwdCols));
    dqk<<<grid, kBwdThreads, kWideBwdSmem, cs>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), l, dl,
        static_cast<bf*>(dq), heads, seq, head_dim, st[0], st[1], st[2],
        st[4], st[5], scale, scale_log2, drop, seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dkdv<<<grid, kBwdThreads, kWideBwdSmem, cs>>>(
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
