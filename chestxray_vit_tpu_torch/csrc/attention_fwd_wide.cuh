// The attention forward at head dims above 128 (attention_fwd.cuh takes
// d <= 128): the same function, O = softmax(Q K^T * scale) V with the
// natural-log lse, dropout, the debug mask and segment ids, for every form
// of attention_fwd.cuh (launch_attn_fwd sends d > 128 here).
//
// What is hard at a wide head dim: a block's O accumulator grows with d
// (64 registers a thread at 128 columns already), and the resident Q tile
// and the K and V stages grow with it in shared memory (83 KB at d = 128),
// so a whole row of d = 256 or 768 fits in neither. The design splits the
// output columns: O = P V splits by column once P is known, and P needs
// all of d only through S = Q K^T. A block owns 64 query rows of one
// (batch, head) and one output chunk of kWideCols columns (a third grid
// axis), and for every key tile forms the whole S by streaming Q and K in
// 64-column chunks through two swizzled tiles (one wgmma m64n64k16 chain
// per chunk, summed in the S accumulator), then runs the online softmax of
// attention_fwd.cuh and O_chunk += P V_chunk with V's chunk columns as they
// lie. S is thus recomputed once per output chunk (ceil(d / 128) times),
// which the simple design accepts; every block's S is the same bits, so
// lse (and the debug mask) are written by the blocks of chunk 0 only. The
// copies are not overlapped with the products inside a block (each chunk
// waits for its tiles): the other blocks of the SM hide that, as the
// shared memory (34 KB) and about 170 registers leave two resident.
//
// The f32 path (parity runs) is plain FMA: a thread owns a query row and a
// 64-column output chunk, S is summed over 32-column chunks of Q (in
// registers) and K (in shared memory), 32 keys a tile.
//
// d is a multiple of 8 (the wrapper zero-pads any other d; columns at or
// past d arrive as zeros and add nothing), and the scale is the caller's.
#pragma once

#include <math.h>

#include "common.cuh"

namespace cxr {
namespace wide {

constexpr int kRows = 64;        // query rows (or keys) a block owns
constexpr int kWideCols = 128;   // output columns a bf16 block owns
constexpr int kF32Cols = 64;     // output columns an f32 block owns

// Shared memory of the bf16 forward: the Q and K chunk tiles, V's two
// output tiles, 64 key ids, and 1024 bytes to put the tiles on a 1024-byte
// boundary: under the 48 KB default, so a launch asks for no more.
constexpr int kFwdSmem = 4 * kTileBytes + 256 + 1024;
static_assert(kFwdSmem <= 48 * 1024, "the wide forward fits 48 KB");

template <bool kLse, bool kDropout, bool kEmitKeep, bool kSegment>
__global__ void __launch_bounds__(128, 2)
attn_fwd_wide_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int H, int S, int hd, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale_log2, Dropout drop,
                   const int* __restrict__ seg) {
  constexpr int T = kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t sq = base, sk = base + T, sv = base + 2 * T;
  const int* sI = reinterpret_cast<const int*>(base_ptr + 4 * T);

  const int m0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int col0 = blockIdx.z * kWideCols;
  const int ocols = min(kWideCols, hd - col0);
  const int nq = (hd + 63) / 64;
  const bool first = blockIdx.z == 0;  // writes lse and the mask
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h + col0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int row0 = m0 + wr + g;

  int seg_row[2] = {0, 0};
  uint32_t dbase[2] = {0u, 0u};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (kSegment) seg_row[r] = row < S ? segp[row] : kNoSegment;
    if (kDropout) dbase[r] = drop_row(drop, drop_base(drop, b, h), row);
  }
  const bool prescale = !(scale_log2 > 0.f);
  const float c = prescale ? 1.f : scale_log2;

  float acc[2][8][4];
#pragma unroll
  for (int ch = 0; ch < 2; ++ch)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[ch][n][0] = acc[ch][n][1] = acc[ch][n][2] = acc[ch][n][3] = 0.f;
  acc_fence(acc);
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  TileWalk<kSegment> walk(segp, S, m0);
  for (int tile = walk.next(); tile >= 0; tile = walk.next()) {
    const int n0 = tile * kRows, krows = min(kRows, S - n0);
    // every thread is done with the previous tile's V, ids and last chunk
    __syncthreads();
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
      copy_tile_async(sv + ch * T, vp, vs.s, n0, S, ch, ocols);
    if (kSegment && tid < kRows) {
      const bool ok = n0 + tid < S;
      cp_async_4(base + 4 * T + 4 * tid, segp + (ok ? n0 + tid : 0), ok);
    }

    // S = Q K^T over the head dim's 64-column chunks
    float s[8][4];
    for (int cq = 0; cq < nq; ++cq) {
      if (cq > 0) __syncthreads();  // chunk cq - 1's product is done
      copy_tile_async(sq, qp, qs.s, m0, S, cq, hd);
      copy_tile_async(sk, kp, ks.s, n0, S, cq, hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      wgmma_fence();
      tile_mma_ss(s, sq, sk, cq > 0, chunk_steps(cq, hd));
      wgmma_commit();
      wgmma_wait<0>(s);
    }

    if (prescale) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    }
    if (kSegment || krows < kRows) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n * 8 >= krows) continue;
        const int kc = n * 8 + 2 * t;
        int id[2] = {0, 0};
        if (kSegment) {
          const int2 i2 = *reinterpret_cast<const int2*>(sI + kc);
          id[0] = i2.x;
          id[1] = i2.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = kc + (e & 1) < krows;
          if (kSegment) ok = ok && id[e & 1] == seg_row[e >> 1];
          if (!ok) s[n][e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n * 8 >= krows) continue;
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float msub[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * c);
      msub[r] = safe_max<kSegment>(m_new);
      alpha[r] = exp2_approx(m_run[r] - msub[r]);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n * 8 >= krows) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = exp2_approx(fmaf(s[n][e], c, -msub[e >> 1]));
    }
    uint32_t pf[4][4];
    acc_to_a(s, pf);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk * 16 >= krows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sum[j & 1] += bf16_lo(pf[kk][j]) + bf16_hi(pf[kk][j]);
    }
    if (kDropout) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n * 8 >= krows) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + n * 8 + 2 * t + (e & 1);
          const bool keep = kept(drop, dbase[e >> 1], col);
          const int row = row0 + 8 * (e >> 1);
          if (kEmitKeep && first && row < S && col < S)
            drop.keep[(static_cast<long long>(bh) * S + row) * S + col] = keep;
          if (!keep) s[n][e] = 0.f;
        }
      }
      acc_to_a(s, pf);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[ch][n][0] *= alpha[0];
        acc[ch][n][1] *= alpha[0];
        acc[ch][n][2] *= alpha[1];
        acc[ch][n][3] *= alpha[1];
      }

    // O_chunk += P V_chunk (the second 64 columns only where the chunk
    // reaches them)
    acc_fence(acc);
    wgmma_fence(pf);
    tile_mma_rs<true>(acc[0], pf, sv, krows);
    if (ocols > 64) tile_mma_rs<true>(acc[1], pf, sv + T, krows);
    wgmma_commit();
    wgmma_wait<0>(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float keep_prob = kDropout ? drop.keep_prob : 1.f;
  const float inv0 = 1.f / (l_run[0] * keep_prob);
  const float inv1 = 1.f / (l_run[1] * keep_prob);
  // O through the Q/K tiles, as attention_fwd.cuh stages it
  __syncthreads();
  __nv_bfloat16* op = o + b * os.b + h * os.h + col0;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    unsigned char* ot = base_ptr + ch * T;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(ot + swizzled(wr + g, n) + 4 * t) =
          pack_bf16x2(acc[ch][n][0] * inv0, acc[ch][n][1] * inv0);
      *reinterpret_cast<uint32_t*>(ot + swizzled(wr + g + 8, n) + 4 * t) =
          pack_bf16x2(acc[ch][n][2] * inv1, acc[ch][n][3] * inv1);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = lane + 32 * j, r = wr + (i >> 3), x = i & 7;
      const int col = ch * 64 + x * 8;
      if (m0 + r < S && col < ocols)
        *reinterpret_cast<uint4*>(op + (m0 + r) * os.s + col) =
            *reinterpret_cast<const uint4*>(ot + swizzled(r, x));
    }
  }
  if (kLse && first && t == 0) {
    float* lp = lse + static_cast<long long>(bh) * S;
    if (row0 < S) lp[row0] = m_run[0] * kLn2 + logf(l_run[0]);
    if (row0 + 8 < S) lp[row0 + 8] = m_run[1] * kLn2 + logf(l_run[1]);
  }
}

// f32: 64 threads, a query row each, a 64-column output chunk a block;
// 32 keys a tile, S summed over 32-column chunks.
constexpr int kF32Keys = 32, kF32Chunk = 32;

template <bool kLse, bool kDropout, bool kEmitKeep, bool kSegment>
__global__ void __launch_bounds__(kRows)
attn_fwd_wide_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int H, int S, int hd, Strides qs,
                  Strides ks, Strides vs, Strides os, float scale_log2,
                  Dropout drop, const int* __restrict__ seg) {
  __shared__ __align__(16) float sK[kF32Keys][kF32Chunk];
  __shared__ __align__(16) float sV[kF32Keys][kF32Cols];
  __shared__ int sSeg[kF32Keys];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kRows + tid;
  const bool valid = row < S;
  const int col0 = blockIdx.z * kF32Cols, ocols = min(kF32Cols, hd - col0);
  const bool first = blockIdx.z == 0;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const float* qrow = q + b * qs.b + h * qs.h + (valid ? row : 0) * qs.s;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h + col0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int seg_row = kSegment && valid ? segp[row] : kNoSegment;
  const uint32_t dbase =
      kDropout ? drop_row(drop, drop_base(drop, b, h), row) : 0u;

  float acc[kF32Cols];
#pragma unroll
  for (int i = 0; i < kF32Cols; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int n0 = 0; n0 < S; n0 += kF32Keys) {
    float s[kF32Keys];
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += kF32Chunk) {
      __syncthreads();  // the previous chunk's (or tile's) reads are done
      for (int i = tid; i < kF32Keys * kF32Chunk / 4; i += kRows) {
        const int r = i / (kF32Chunk / 4), cc = (i % (kF32Chunk / 4)) * 4;
        float4 val = zero;
        if (n0 + r < S && c0 + cc < hd)
          val = *reinterpret_cast<const float4*>(kp + (n0 + r) * ks.s + c0 +
                                                 cc);
        *reinterpret_cast<float4*>(&sK[r][cc]) = val;
      }
      if (kSegment && c0 == 0 && tid < kF32Keys)
        sSeg[tid] = n0 + tid < S ? segp[n0 + tid] : kNoSegment;
      float qc[kF32Chunk];
#pragma unroll
      for (int cc = 0; cc < kF32Chunk; cc += 4) {
        const float4 x = c0 + cc < hd
            ? *reinterpret_cast<const float4*>(qrow + c0 + cc) : zero;
        qc[cc] = x.x;
        qc[cc + 1] = x.y;
        qc[cc + 2] = x.z;
        qc[cc + 3] = x.w;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kF32Keys; ++j)
#pragma unroll
        for (int i = 0; i < kF32Chunk; ++i) s[j] = fmaf(qc[i], sK[j][i], s[j]);
    }
    float m_new = m_run;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      bool ok = n0 + j < S;
      if (kSegment) ok = ok && sSeg[j] == seg_row;
      s[j] = ok ? s[j] * scale_log2 : -INFINITY;
      m_new = fmaxf(m_new, s[j]);
    }
    // 0 in place of a max that is still -inf, so exp2(-inf - 0) = 0
    const float msub = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_run - msub);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < kF32Cols; ++i) acc[i] *= alpha;
    // V's chunk columns of the tile (the last chunk's reads of sK are
    // done, and every read of sV was before the chunk loop's barriers)
    for (int i = tid; i < kF32Keys * kF32Cols / 4; i += kRows) {
      const int r = i / (kF32Cols / 4), cc = (i % (kF32Cols / 4)) * 4;
      float4 val = zero;
      if (n0 + r < S && cc < ocols)
        val = *reinterpret_cast<const float4*>(vp + (n0 + r) * vs.s + cc);
      *reinterpret_cast<float4*>(&sV[r][cc]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      float p = exp2f(s[j] - msub);
      l_run += p;
      if (kDropout) {
        const int col = n0 + j;
        const bool keep = kept(drop, dbase, col);
        if (kEmitKeep && first && valid && col < S)
          drop.keep[(static_cast<long long>(bh) * S + row) * S + col] = keep;
        if (!keep) p = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kF32Cols; ++i) acc[i] = fmaf(p, sV[j][i], acc[i]);
    }
  }

  if (!valid) return;
  float* orow = o + b * os.b + h * os.h + row * os.s + col0;
  const float inv = 1.f / (l_run * (kDropout ? drop.keep_prob : 1.f));
#pragma unroll
  for (int i = 0; i < kF32Cols; i += 4)
    if (i < ocols)
      *reinterpret_cast<float4*>(orow + i) =
          make_float4(acc[i] * inv, acc[i + 1] * inv, acc[i + 2] * inv,
                      acc[i + 3] * inv);
  if (kLse && first) lse[static_cast<long long>(bh) * S + row] =
      m_run * kLn2 + logf(l_run);
}

// Launches the wide forward for the dtype (0 = float32, 1 = bfloat16).
template <bool kLse, bool kDropout, bool kEmitKeep, bool kSegment>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, int heads, int seq, int head_dim,
               Strides qs, Strides ks, Strides vs, Strides os, float scale,
               int dtype, cudaStream_t st, const Dropout& drop,
               const int* seg) {
  const float scale_log2 = scale * kLog2e;
  const unsigned rows = (seq + kRows - 1) / kRows, bh = batch * heads;
  if (dtype == 1) {
    attn_fwd_wide_bf16<kLse, kDropout, kEmitKeep, kSegment>
        <<<dim3(rows, bh, out_blocks(head_dim, kWideCols)), 128, kFwdSmem,
             st>>>(static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v),
                   static_cast<__nv_bfloat16*>(o), lse, heads, seq, head_dim,
                   qs, ks, vs, os, scale_log2, drop, seg);
  } else if (dtype == 0) {
    attn_fwd_wide_f32<kLse, kDropout, kEmitKeep, kSegment>
        <<<dim3(rows, bh, out_blocks(head_dim, kF32Cols)), kRows, 0, st>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(o), lse, heads,
            seq, head_dim, qs, ks, vs, os, scale_log2, drop, seg);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide
}  // namespace cxr
