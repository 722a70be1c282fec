// The attention forward at head dims above 128 (attention_fwd.cuh takes
// d <= 128): the same function, O = softmax(Q K^T * scale) V with the
// natural-log lse, dropout, the debug mask and segment ids, for every form
// of attention_fwd.cuh (launch_attn_fwd sends d > 128 here). It replaces
// the same TPU kernels as attention_fwd.cuh at these widths:
// chestxray_vit_tpu/ops/flash_attention.py `_fwd_kernel_inf`,
// `_fwd_kernel`, `_fwd_kernel_drop`, `_fwd_kernel_drop_debug`,
// `_fwd_kernel_seg` and `_fwd_kernel_seg_drop`, which take the head dim
// whole.
//
// What bounds it on an H100: at S = 577 and d = 256 the bytes (q, k, v
// read once, o written once) and the operations (4 S^2 d flops a head, S =
// Q K^T and O = P V, at the bf16 tensor-core peak) take about the same
// time. The kernel runs at about four times that: within a block the
// tensor cores wait on the softmax (an exp2 per score, O rescaled between
// the products), and the grid's blocks leave a tail (PERF.md). What is
// hard at a wide head dim: O's accumulator grows with d (128 f32 registers
// a thread for 64 rows at d = 256), and Q and a K/V stage grow with it in
// shared memory (Q 32 KB and a stage 64 KB for 64 rows at d = 256).
//
// The bf16 design, for 128 < d <= 256: a block of two warpgroups (256
// threads, one block an SM) owns 128 query rows of one (batch, head), 64 a
// warpgroup, and all of d's output columns, each warpgroup's 64 x 256 O
// accumulator in its registers. Both share every K and V tile, so a query
// row reads K and V from L2 half as often as with 64-row blocks. Each
// warpgroup's Q rows arrive once and stay in shared memory (four 64-column
// chunk tiles each, 64 KB); K and V stream through a ring of two stages
// (the K and V chunk tiles of 64 keys, 64 KB a stage), the next tile's
// copies issued before the current tile's products. For every key tile a
// warpgroup forms S = Q K^T once over the whole d (one wgmma m64n64k16
// chain over the chunks' 16-deep steps, in chunk order, so S has the bits
// of a chunk-by-chunk sum), runs the online softmax of attention_fwd.cuh
// (exp2, P rounded to bf16 and summed so, safe_max, the dropout hash of
// each score's counter), then O += P V over the four 64-column chunks: four
// m64n64k16 chains with P from registers and V's chunk tiles read as they
// lie (the transposed-B form), the same wgmma forms as attention_fwd.cuh,
// only the 16-deep steps that hold a key below S. One barrier a tile
// orders the ring; between barriers the two warpgroups share the tensor
// cores as the warp schedulers issue them (ordering warpgroup 1's S after
// warpgroup 0's on a named barrier, and one m64n256k16 a step for P V in
// place of the four chains, were both slower). 198 KB of shared memory,
// 254-255 registers a thread.
//
// Past 256 columns (d = 264 ... 768) a block keeps 256 output columns (the
// grid's third axis, out_blocks(d, 256)) and forms S from Q and K streamed
// in blocks of four chunks through the Q tiles and stage 0, one block at a
// time, with V's output columns copied beside the first: S once per
// 256-column block, ceil(d / 256) times in all, and nothing grows with d.
// Every block's S has the same bits, so lse and the debug mask are
// written by the blocks of output block 0 only.
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

constexpr int kRows = 64;         // query rows of a warpgroup (bf16) or of
                                  // an f32 block; keys a K/V tile
constexpr int kFwdRows = 2 * kRows;  // query rows a bf16 block owns
constexpr int kFwdCols = 64 * kBlockChunks;  // output columns a bf16 block owns
constexpr int kFwdThreads = 256;  // two warpgroups
constexpr int kF32Cols = 64;      // output columns an f32 block owns

// Shared memory of the bf16 forward, from a 1024-byte aligned base: each
// warpgroup's Q block (four chunk tiles of its 64 rows), two stages of a
// key tile's K and V blocks, each stage's 64 key ids, and 1024 bytes to
// put the tiles on a 1024-byte boundary.
constexpr int kFwdOpBytes = kBlockChunks * kTileBytes;  // a 64-row block
constexpr int kFwdStageBytes = 2 * kFwdOpBytes;         // K, then V
constexpr int kFwdStageOff = 2 * kFwdOpBytes;
constexpr int kFwdIdsOff = kFwdStageOff + 2 * kFwdStageBytes;
constexpr int kFwdSmem = kFwdIdsOff + 2 * kRows * 4 + 1024;
static_assert(kFwdSmem <= 227 * 1024, "the wide forward fits an SM");

template <bool kLse, bool kDropout, bool kEmitKeep, bool kSegment>
__global__ void __launch_bounds__(kFwdThreads, 1)
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

  const int m0 = blockIdx.x * kFwdRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int oc = blockIdx.z;            // output columns [256 oc, + 256)
  const int c0 = kBlockChunks * oc;     // their first chunk
  const int nq = (hd + 63) / 64, nb = (nq + kBlockChunks - 1) / kBlockChunks;
  const bool first = oc == 0;  // writes lse and the mask
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  // the warpgroup, read from lane 0 so that the compiler knows it uniform
  // over each warp (wgmma under a branch on it is then not serialized)
  const int tid = threadIdx.x, t128 = tid & 127;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = t128 >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int q0 = m0 + kRows * wg;  // the warpgroup's first query row
  const int row0 = q0 + wr + g;
  const uint32_t qtiles = base + wg * kFwdOpBytes;
  auto stage = [&](int st) {
    return base + kFwdStageOff + st * kFwdStageBytes;
  };

  int seg_row[2] = {0, 0};
  uint32_t dbase[2] = {0u, 0u};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (kSegment) seg_row[r] = row < S ? segp[row] : kNoSegment;
    if (kDropout) dbase[r] = drop_row(drop, drop_base(drop, b, h), row);
  }
  // A non-positive scale reverses the order of the scores: it is applied
  // to them before the max; a positive one is folded into the exp2's FMA.
  const bool prescale = !(scale_log2 > 0.f);
  const float c = prescale ? 1.f : scale_log2;

  float acc[kBlockChunks][8][4];  // O, one accumulator a 64-column chunk
#pragma unroll
  for (int ch = 0; ch < kBlockChunks; ++ch)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[ch][n][0] = acc[ch][n][1] = acc[ch][n][2] = acc[ch][n][3] = 0.f;
  acc_fence(acc);
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8 (log2 units)
  float l_run[2] = {0.f, 0.f};              // this thread's share of the sum

  // The copies of the key tile at n0 into stage st: warpgroup 0 K's chunk
  // block cb, warpgroup 1 V's output block (with cb 0 only), and the ids.
  auto fetch = [&](int n0, int st, int cb) {
    if (wg == 0)
      wg_copy_block(stage(st), kp, ks.s, n0, S, cb * kBlockChunks, nq, hd,
                    t128);
    else if (cb == 0)
      wg_copy_block(stage(st) + kFwdOpBytes, vp, vs.s, n0, S, c0, nq, hd,
                    t128);
    if (kSegment && cb == 0 && tid < kRows) {
      const bool ok = n0 + tid < S;
      cp_async_4(base + kFwdIdsOff + st * kRows * 4 + 4 * tid,
                 segp + (ok ? n0 + tid : 0), ok);
    }
  };

  // The key tile at n0 in stage st, its raw scores in s: the online
  // softmax, then O += P V over the output block's chunks, waited for.
  auto finish_tile = [&](int n0, int st, float (&s)[8][4]) {
    const int krows = min(kRows, S - n0);
    const int* sI =
        reinterpret_cast<const int*>(base_ptr + kFwdIdsOff + st * kRows * 4);
    if (prescale) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    }
    // pad keys (the tail tile) and other segments' keys to -inf; the
    // 8-wide slices of keys at or past S are skipped (block-uniform)
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
    // P rounded to bf16, packed as the A fragments of the PV product; l
    // sums the rounded values
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
      for (int j = 0; j < 4; ++j)  // j even: row g; odd: row g + 8
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
    for (int ch = 0; ch < kBlockChunks; ++ch)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[ch][n][0] *= alpha[0];
        acc[ch][n][1] *= alpha[0];
        acc[ch][n][2] *= alpha[1];
        acc[ch][n][3] *= alpha[1];
      }
    // O += P V, V's chunks as they lie (the transposed-B form), the k-steps
    // of keys below S only
    const uint32_t vtiles = stage(st) + kFwdOpBytes;
    acc_fence(acc);
    wgmma_fence(pf);
#pragma unroll
    for (int ch = 0; ch < kBlockChunks; ++ch)
      if (c0 + ch < nq) tile_mma_rs<true>(acc[ch], pf, vtiles + ch * T, krows);
    wgmma_commit();
    wgmma_wait<0>(acc);
  };

  TileWalk<kSegment, kFwdRows> walk(segp, S, m0);
  int tile = walk.next();
  if (nb == 1) {
    // The Q blocks stay; the next key tile is copied into the other stage
    // while this one's products run.
    wg_copy_block(qtiles, qp, qs.s, q0, S, 0, nq, hd, t128);
    if (tile >= 0) fetch(tile * kRows, 0, 0);
    cp_async_commit();
    int st = 0;
    while (tile >= 0) {
      cp_async_wait<0>();
      // the tile (and Q) arrived for every thread, and every thread is
      // done with the other stage, which the next copies overwrite
      __syncthreads();
      const int next = walk.next();
      if (next >= 0) fetch(next * kRows, st ^ 1, 0);
      cp_async_commit();
      float s[8][4];
      block_mma(s, qtiles, stage(st), 0, nq, hd);
      wgmma_wait<0>(s);
      finish_tile(tile * kRows, st, s);
      tile = next;
      st ^= 1;
    }
  }
  // Past 256 columns: Q and K in blocks of four chunks through the Q tiles
  // and stage 0, a block at a time; V's output block beside the first.
  for (; nb > 1 && tile >= 0; tile = walk.next()) {
    const int n0 = tile * kRows;
    float s[8][4];
    for (int cb = 0; cb < nb; ++cb) {
      __syncthreads();  // every thread is done with the previous block
      wg_copy_block(qtiles, qp, qs.s, q0, S, cb * kBlockChunks, nq, hd, t128);
      fetch(n0, 0, cb);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      block_mma(s, qtiles, stage(0), cb * kBlockChunks, nq, hd);
      wgmma_wait<0>(s);
    }
    finish_tile(n0, 0, s);
  }
  cp_async_wait<0>();  // copies never outlive the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float keep_prob = kDropout ? drop.keep_prob : 1.f;
  const float inv0 = 1.f / (l_run[0] * keep_prob);
  const float inv1 = 1.f / (l_run[1] * keep_prob);
  // O through the warpgroup's Q tiles (every warp is past its last
  // product): each warp stages its own 16 rows of a swizzled tile a chunk
  // and writes them as 16-byte rows, the columns below hd only
  __syncthreads();
  __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int ch = 0; ch < kBlockChunks; ++ch) {
    if (c0 + ch >= nq) break;
    unsigned char* ot = base_ptr + wg * kFwdOpBytes + ch * T;
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
      const int col = (c0 + ch) * 64 + x * 8;
      if (q0 + r < S && col < hd)
        *reinterpret_cast<uint4*>(op + (q0 + r) * os.s + col) =
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

// Launches the wide forward for the dtype (0 = float32, 1 = bfloat16) on
// ``device``, the current one.
template <bool kLse, bool kDropout, bool kEmitKeep, bool kSegment>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, int heads, int seq, int head_dim,
               Strides qs, Strides ks, Strides vs, Strides os, float scale,
               int dtype, int device, cudaStream_t st, const Dropout& drop,
               const int* seg) {
  const float scale_log2 = scale * kLog2e;
  const unsigned bh = batch * heads;
  if (dtype == 1) {
    const cudaError_t err =
        allow_smem<attn_fwd_wide_bf16<kLse, kDropout, kEmitKeep, kSegment>,
                   kFwdSmem>(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((seq + kFwdRows - 1) / kFwdRows, bh,
                    out_blocks(head_dim, kFwdCols));
    attn_fwd_wide_bf16<kLse, kDropout, kEmitKeep, kSegment>
        <<<grid, kFwdThreads, kFwdSmem, st>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<__nv_bfloat16*>(o), lse, heads, seq, head_dim, qs, ks,
            vs, os, scale_log2, drop, seg);
  } else if (dtype == 0) {
    const unsigned rows = (seq + kRows - 1) / kRows;
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
