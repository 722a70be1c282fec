// Attention backward: dQ, dK, dV of O = softmax(Q K^T * scale) V from the
// forward's O and natural-log lse, with P recomputed (no [S, S] tensor is
// ever stored). Shared by the dense entry points (flash_attention_bwd.cu,
// with and without dropout) and the segment ones
// (flash_attention_seg_bwd.cu); see those files for which TPU kernel each
// replaces.
//
// The TPU kernel `_bwd_kernel` (chestxray_vit_tpu/ops/flash_attention.py,
// launched by `_bwd`) holds a whole padded Q block and K/V row in VMEM and
// produces dQ, dK and dV in one grid step; with several Q blocks it
// accumulates dK/dV across the sequential grid. Hopper blocks run in no
// order, so this is the FlashAttention-2 split, without atomics and
// therefore bit-for-bit repeatable:
//
// 1. attn_bwd_dq: one block per (batch * head, 64-query tile). It first
//    sums Delta = rowsum(dO * O) of its rows (f32, written for pass 2), then
//    walks the key tiles: S = Q K^T and dP = dO V^T, P = exp2(S * scale *
//    log2 e - lse * log2 e), dS = P * (dP - Delta), dQ += dS K in f32
//    registers; dQ * scale is written once, in the input dtype.
// 2. attn_bwd_dkdv: one block per (batch * head, 64-key tile), walking the
//    query tiles the same way: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
//    dK += dS^T Q; dK * scale and dV are written once.
// (f32, the parity path: attn_bwd_delta, then the two passes as plain FMA
// with two threads per row.)
//
// Query rows and key columns at or past S contribute nothing: their tile
// rows are zero-filled, pad keys and pad queries are masked to P = 0, and
// nothing past S is written. All eight tensors are read and written through
// their strides, so dq, dk and dv can be [B, H, S, d] views of [B, S, H, d]
// buffers that the projections' backward reads without a transpose copy.
//
// How the bf16 passes feed the tensor cores (a block is one warpgroup):
// - The walked tiles (Q and dO with lse and Delta for dK/dV; K and V for dQ;
//   the segment ids with either) arrive by cp.async, zero-filled past S, in
//   a ring of two stages in dynamic shared memory: the next tile's copies
//   are issued before the current tile's products, and one cp.async wait and
//   one barrier per tile order them.
// - Every tile is stored once, 64 rows of 128 bytes under the 128-byte
//   swizzle, and read by wgmma through a descriptor in either orientation:
//   K-major where the tile's rows are the product's columns (S, dP, S^T,
//   dP^T), the transposed-B form where they are the k index (dQ, dV, dK).
//   No tile is copied transposed and no B fragment passes through
//   registers.
// - Each pass is a chain: the accumulators of S and dP become, rounded to
//   bf16 in registers, the A fragments of the next product (P^T for dV,
//   dS^T for dK, dS for dQ). The dQ pass holds its own Q and dO as A
//   fragments (ldmatrix, once); the dK/dV pass, which carries two
//   accumulators, reads its own K and V from shared memory through
//   descriptors instead, which keeps it at 168 registers and three blocks an
//   SM. wgmma groups are committed so that exp2 runs under the dP product
//   and the dS arithmetic under the dV product; other blocks of the SM fill
//   the rest.
// - The last walked tile of a ragged sequence runs only the 16-deep steps
//   of dQ, dV, dK and the 8-wide slices of the exp2 / dS arithmetic that
//   hold a row below S; its S and dP products stay whole (wgmma's M is 64
//   and a narrower N saves little), and so does the block that owns the
//   ragged tile.
// What bounds them on an H100: tensor-core throughput (seven 64 x 64 x 64
// products per tile pair, S and dP being computed by both passes), reached
// to about a quarter: a block's chain is serial, and twelve warps an SM hide
// only part of the wgmma, exp2 and barrier latencies. P and dS are rounded
// to bf16 before their products, as the TPU kernel does (`p_lo`, `ds_lo`);
// P is rounded after the exp2, as in the forward.
//
// With kDropout each pass regenerates the forward's keep mask M for its own
// tiles from the element's global (bh, query, key) (cxr::Dropout,
// common.cuh), so no mask is stored or read. dV = (M * P)^T dO / (1 - rate)
// and dS = P * (M * dP / (1 - rate) - Delta), with the unchanged Delta. The
// hash adds about twelve integer operations per score element to each pass.
//
// With kSegment (packed sequences) seg is int32 [B, S] contiguous and P is
// 0 wherever the query's and the key's segment ids differ, so those pairs
// add nothing to any gradient; a tile of the walked operand none of whose
// ids lies within the range of the block's own 64 ids is skipped before its
// copies are issued (TileWalk). Ids are never assumed sorted or contiguous.
//
// Head dims: those of the forward up to 128 (cxr::head_dim_ok; above it
// attention_bwd_wide.cuh splits the output columns), at the padded width
// of the forward (cxr::bf16_head_dim: kD = 64, 80 or 128; the f32 passes
// at 64 or 128) with the real d a runtime argument. Every 64-column chunk
// of a Q, K, V, dO, dQ, dK or dV tile is one swizzled 64 x 64 tile, and at
// kD = 80 the columns 64-79 are a 64 x 16 tile under the 32-byte swizzle
// (common.cuh), as in the forward: S, dP, S^T and dP^T sum the chunks'
// products and the 16-column tiles' one 16-deep step; dQ, dK and dV keep
// one accumulator a chunk (dQ += dS K_c, dV_c += P^T dO_c, dK_c += dS^T
// Q_c) and at kD = 80 one of 16 columns (m64n16k16 on the tile as it
// lies), so no column past 80 is computed. Columns at or past d arrive as
// zeros and are never stored, and Delta sums the columns below d, so the
// result is d's exactly. At kD = 80 the 16-deep steps, their order and
// their operands are those of kD = 128 on the same d, and Delta is summed
// in kD = 128's sixteen lanes a row, so the two widths give the same bits.
// At kD = 80 and 128 the dQ pass reads its own Q and dO through
// descriptors from tiles behind the ring, as the dK/dV pass reads its K
// and V (as fragments they would cost 32 or 64 more registers a thread,
// and at kD = 80 an ldmatrix of the 32-byte swizzle). kD = 128 runs two
// blocks an SM: the dK/dV pass carries 2 x 2 x 32 accumulator registers a
// thread and both passes use 99 KB of shared memory. kD = 80 carries
// 2 x 40 and uses 63 KB, and runs three, as kD = 64 does: its dK/dV pass
// issues dP^T once P is in registers (BwdShape::kLateDp), so S^T's and
// dP^T's accumulators are never live together.
#pragma once

#include <math.h>

#include "attention_bwd_wide.cuh"
#include "common.cuh"

namespace cxr {
namespace bwd {

constexpr int kTile = 64;     // query rows or keys per tile

// ---------------------------------------------------------------------------
// Delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

// kD / E lanes a row (E elements of a 16-byte vector each), the columns
// below hd.
template <typename T, int kD>
__global__ void __launch_bounds__(256)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ delta, int H, int S, int hd,
               long long rows, Strides os, Strides dos) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kLanes = kD / E;     // threads per row
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = gid / kLanes;
  const int part = static_cast<int>(gid % kLanes);
  float acc = 0.f;
  if (row < rows && part * E < hd) {
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
// bf16: one warpgroup (128 threads) per block; warp w owns rows
// [16w, 16w + 16) of the block's own tile (keys for dK/dV, queries for dQ).
// ---------------------------------------------------------------------------

// A ring stage: the two walked tiles (kD / 64 chunks each), then 64 f32
// lse, 64 f32 Delta and 64 int32 segment ids of the walked rows (the dQ
// pass uses only the ids). Two stages: the next tile's copies fly under
// the current tile's products (three and four stages read the same times).
// At kD = 64, with at most 168 registers a thread, three blocks share an
// SM, so one block's exp2, hash and rounding run under another's products.
constexpr int kStages = 2;
static_assert(kStages >= 2, "the ring overlaps a copy with a tile's products");
template <int kD>
struct BwdShape {
  static constexpr int kChunks = kD / 64;
  static constexpr bool kTail = kD % 64 != 0;   // kD = 80: columns 64-79
  static_assert(kD % 64 == 0 || kD % 64 == 16, "64-column chunks and a 16");
  static constexpr int kBlocksPerSm = kD == 128 ? 2 : 3;
  // The dK/dV pass issues dP^T = V dO^T once P is in registers, not beside
  // S^T: S^T's accumulator is then dead before dP^T's is live, which keeps
  // kD = 80 (16 more accumulator registers than kD = 64) within 168
  // registers at three blocks an SM. Beside S^T it spilled 160-188 bytes
  // at 168, and at two blocks an SM (183-198 registers) it ran 10 % slower.
  static constexpr bool kLateDp = kD == 80;
  // the dQ pass holds its own Q and dO as A fragments (at kD = 64, loaded
  // through the last stage) or reads them from tiles behind the ring
  static constexpr bool kOwnFrags = kD == 64;
  // Two operands' tiles (a stage's walked pair, or the block's own pair):
  // the first operand's chunks, the second's, then (kTail) the first's
  // 16-column tile at kTail16 and the second's after it.
  static constexpr int kTail16 = 2 * kChunks * cxr::kTileBytes;
  static constexpr int kPairBytes =
      kTail16 + (kTail ? 2 * cxr::kTile16Bytes : 0);
  static constexpr int kStageAux = kPairBytes;
  static constexpr int kStageBytes = kStageAux + 1024;
  static_assert(kStageBytes % 1024 == 0, "every stage on a 1024-byte line");
  // 1024 bytes of slack: the ring starts at the next 1024-byte boundary
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
  static constexpr int kOwnBytes = kPairBytes;
  // the dK/dV pass keeps its own K and V tiles behind the ring
  static constexpr int kDkdvSmemBytes = kSmemBytes + kOwnBytes;
  // the dQ pass without fragments: its Q and dO tiles and 64 Delta values
  static constexpr int kDqSmemBytes =
      kOwnFrags ? kSmemBytes : kSmemBytes + kOwnBytes + 256;
  // the dQ pass's Delta: 16-byte pieces a row in a power-of-two shuffle
  // tree, kD = 128's sixteen at kD = 80 (lanes past d add 0)
  static constexpr int kDeltaLanes = (kD == 64 ? 64 : 128) / 8;
};

// The 16-deep steps of 64-column chunk ``c`` that reach a column below hd:
// fewer than four only in the last chunk of kD = 128 (at kD = 80 the
// columns past 64 are the 16-column tile's one step).
template <int kD>
__device__ __forceinline__ int chunk_steps(int c, int hd) {
  return kD != 128 || c < kD / 64 - 1 ? 4 : (hd - 64 * c + 15) / 16;
}

template <int kD, bool kPad, bool kDropout, bool kSegment>
__global__ void __launch_bounds__(128, BwdShape<kD>::kBlocksPerSm)
attn_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int S, int hd,
                   Strides qs, Strides ks, Strides vs, Strides dos,
                   Strides dks, Strides dvs, float scale, float scale_log2,
                   cxr::Dropout drop, const int* __restrict__ seg) {
  using L = BwdShape<kD>;
  constexpr int kC = L::kChunks;
  constexpr int T = cxr::kTileBytes, T16 = cxr::kTile16Bytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = cxr::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const unsigned char* ring_ptr = smem_raw + (ring - raw);

  const int n0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const uint32_t dbh = kDropout ? cxr::drop_base(drop, b, h) : 0u;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dop = dout + b * dos.b + h * dos.h;
  const float* lp = lse + static_cast<long long>(bh) * S;
  const float* dlp = delta + static_cast<long long>(bh) * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;

  // the copies of query tile ``tile`` (Q and dO chunks, lse, Delta, ids)
  // into a stage
  auto fetch = [&](int stage, int tile) {
    const int m0 = tile * kTile;
    const uint32_t st = ring + stage * L::kStageBytes;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      cxr::copy_chunk_async<kPad>(st + c * T, qp, qs.s, m0, S, c, hd);
      cxr::copy_chunk_async<kPad>(st + (kC + c) * T, dop, dos.s, m0, S, c,
                                  hd);
    }
    if constexpr (L::kTail) {
      cxr::copy_tile16_async(st + L::kTail16, qp, qs.s, m0, S, 64 * kC, hd);
      cxr::copy_tile16_async(st + L::kTail16 + T16, dop, dos.s, m0, S,
                             64 * kC, hd);
    }
    if (tid < kTile) {
      const bool ok = m0 + tid < S;
      const int r = ok ? m0 + tid : 0;
      cxr::cp_async_4(st + L::kStageAux + 4 * tid, lp + r, ok);
      cxr::cp_async_4(st + L::kStageAux + 256 + 4 * tid, dlp + r, ok);
      if (kSegment)
        cxr::cp_async_4(st + L::kStageAux + 512 + 4 * tid, segp + r, ok);
    }
  };

  // the block's own K and V stay in shared memory behind the ring, the A
  // operands of S^T and dP^T (as fragments they would cost 32 registers a
  // thread a chunk and the third block of the SM)
  const uint32_t own = ring + kStages * L::kStageBytes;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    cxr::copy_chunk_async<kPad>(own + c * T, k + b * ks.b + h * ks.h, ks.s,
                                n0, S, c, hd);
    cxr::copy_chunk_async<kPad>(own + (kC + c) * T, v + b * vs.b + h * vs.h,
                                vs.s, n0, S, c, hd);
  }
  if constexpr (L::kTail) {
    cxr::copy_tile16_async(own + L::kTail16, k + b * ks.b + h * ks.h, ks.s,
                           n0, S, 64 * kC, hd);
    cxr::copy_tile16_async(own + L::kTail16 + T16, v + b * vs.b + h * vs.h,
                           vs.s, n0, S, 64 * kC, hd);
  }
  cxr::cp_async_commit();
  cxr::TileWalk<kSegment> walk(segp, S, n0);
  int fifo[kStages];  // fifo[0]: the tile to compute next; then those in flight
#pragma unroll
  for (int d = 0; d < kStages - 1; ++d) {
    fifo[d] = walk.next();
    if (fifo[d] >= 0) fetch(d, fifo[d]);
    cxr::cp_async_commit();
  }
  fifo[kStages - 1] = -1;
  cxr::cp_async_wait<kStages - 1>();
  __syncthreads();

  float dka[kC][8][4], dva[kC][8][4];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[c][n][e] = dva[c][n][e] = 0.f;
  cxr::acc_fence(dka);
  cxr::acc_fence(dva);
  float dka16[2][4], dva16[2][4];  // kTail: dK's and dV's columns 64-79
  if constexpr (L::kTail) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka16[n][e] = dva16[n][e] = 0.f;
    cxr::acc_fence(dka16);
    cxr::acc_fence(dva16);
  }
  const int key0 = n0 + wr + g;  // key of accumulator rows g; +8 for c2, c3
  const bool key_ok[2] = {key0 < S, key0 + 8 < S};
  int seg_key[2] = {0, 0};  // ids of the two keys
  if (kSegment) {
    seg_key[0] = key_ok[0] ? segp[key0] : cxr::kNoSegment;
    seg_key[1] = key_ok[1] ? segp[key0 + 8] : cxr::kNoSegment;
  }

  int cs = 0;  // the stage of fifo[0]
  while (fifo[0] >= 0) {
    cxr::cp_async_wait<kStages - 2>();
    // tile fifo[0] has arrived for every thread, and every thread is done
    // with the stage before it, which the next copies overwrite
    __syncthreads();
    fifo[kStages - 1] = walk.next();
    if (fifo[kStages - 1] >= 0)
      fetch(cs == 0 ? kStages - 1 : cs - 1, fifo[kStages - 1]);
    cxr::cp_async_commit();

    const int m0 = fifo[0] * kTile, qrows = min(kTile, S - m0);
    const uint32_t sq = ring + cs * L::kStageBytes, sdo = sq + kC * T;
    const float* sL = reinterpret_cast<const float*>(
        ring_ptr + cs * L::kStageBytes + L::kStageAux);
    const float* sD = sL + kTile;
    const int* sI = reinterpret_cast<const int*>(sD + kTile);

    {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp,
      // summed over the head dim's chunks (and the 16-column tiles' step);
      // dP^T beside S^T, or (kLateDp) beside dV
      float sp[8][4], dp[8][4];
      cxr::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kC; ++c)
        cxr::tile_mma_ss(sp, own + c * T, sq + c * T, c > 0,
                         chunk_steps<kD>(c, hd));
      if constexpr (L::kTail)
        cxr::tile16_mma_ss(sp, own + L::kTail16, sq + L::kTail16);
      cxr::wgmma_commit();
      auto issue_dp = [&]() {
#pragma unroll
        for (int c = 0; c < kC; ++c)
          cxr::tile_mma_ss(dp, own + (kC + c) * T, sdo + c * T, c > 0,
                           chunk_steps<kD>(c, hd));
        if constexpr (L::kTail)
          cxr::tile16_mma_ss(dp, own + L::kTail16 + T16,
                             sq + L::kTail16 + T16);
        cxr::wgmma_commit();
      };
      if constexpr (L::kLateDp) {
        cxr::wgmma_wait<0>(sp);
      } else {
        issue_dp();
        cxr::wgmma_wait<1>(sp);
      }

      // P^T rounded to bf16, packed as the A fragments of the next product;
      // keep bit of element (query m0 + 8n + 2t + (e & 1), key): bit 4n + e
      uint32_t pp[4][4], pf[4][4];
      uint32_t kmask = 0u;
      const uint32_t dbase =
          kDropout ? cxr::drop_row(drop, dbh, m0) + static_cast<uint32_t>(key0)
                   : 0u;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int qc = n * 8 + 2 * t, kk = n >> 1, hi = (n & 1) * 2;
        if (n * 8 >= qrows) {  // block-uniform: sub-tiles of pad queries
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
          const uint32_t counter =  // of (query m0 + qc + j, key key0)
              dbase + static_cast<uint32_t>(qc + j) * drop.s_pad;
          if (kDropout && cxr::kept(drop, counter, r * 8))
            kmask |= 1u << (4 * n + e);
        }
        pp[kk][hi] = cxr::pack_bf16x2(pe[0], pe[1]);
        pp[kk][hi + 1] = cxr::pack_bf16x2(pe[2], pe[3]);
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
      // dV += (M * P)^T dO (the 1 / (1 - rate) is applied at the end)
      cxr::wgmma_fence(kDropout ? pf : pp);
      if constexpr (L::kLateDp) issue_dp();
#pragma unroll
      for (int c = 0; c < kC; ++c)
        cxr::tile_mma_rs<true>(dva[c], kDropout ? pf : pp, sdo + c * T,
                               qrows);
      if constexpr (L::kTail)
        cxr::tile16_mma_rs(dva16, kDropout ? pf : pp, sq + L::kTail16 + T16,
                           qrows);
      cxr::wgmma_commit();
      cxr::wgmma_wait<1>(dp);

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
          const float p = e & 1 ? cxr::bf16_hi(w) : cxr::bf16_lo(w);
          float dpe = dp[n][e];
          if (kDropout)
            dpe = (kmask >> (4 * n + e)) & 1u ? dpe * drop.inv_keep : 0.f;
          de[e] = p * (dpe - (e & 1 ? dl.y : dl.x));
        }
        dsf[kk][hi] = cxr::pack_bf16x2(de[0], de[1]);
        dsf[kk][hi + 1] = cxr::pack_bf16x2(de[2], de[3]);
      }
      // dK += dS^T Q
      cxr::wgmma_fence(dsf);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        cxr::tile_mma_rs<true>(dka[c], dsf, sq + c * T, qrows);
      if constexpr (L::kTail)
        cxr::tile16_mma_rs(dka16, dsf, sq + L::kTail16, qrows);
      cxr::wgmma_commit();
      // the stage is free, and pp, pf, dsf may change, once these are done
      cxr::wgmma_wait<0>(dva);
      cxr::acc_fence(dka);
      if constexpr (L::kTail) {
        cxr::acc_fence(dva16);
        cxr::acc_fence(dka16);
      }
    }
#pragma unroll
    for (int d = 0; d < kStages - 1; ++d) fifo[d] = fifo[d + 1];
    cs = cs + 1 == kStages ? 0 : cs + 1;
  }
  cxr::cp_async_wait<0>();  // copies never outlive the block

  __nv_bfloat16* dkp = dk + b * dks.b + h * dks.h;
  __nv_bfloat16* dvp = dv + b * dvs.b + h * dvs.h;
  const float vscale = kDropout ? drop.inv_keep : 1.f;
#pragma unroll
  for (int ch = 0; ch < kC; ++ch)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = ch * 64 + n * 8 + 2 * t;
      if (kPad && c >= hd) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key_ok[r]) {
          *reinterpret_cast<uint32_t*>(dkp + key * dks.s + c) =
              cxr::pack_bf16x2(dka[ch][n][2 * r] * scale,
                               dka[ch][n][2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvp + key * dvs.s + c) =
              cxr::pack_bf16x2(dva[ch][n][2 * r] * vscale,
                               dva[ch][n][2 * r + 1] * vscale);
        }
      }
    }
  if constexpr (L::kTail) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c = 64 * kC + n * 8 + 2 * t;
      if (c >= hd) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key_ok[r]) {
          *reinterpret_cast<uint32_t*>(dkp + key * dks.s + c) =
              cxr::pack_bf16x2(dka16[n][2 * r] * scale,
                               dka16[n][2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvp + key * dvs.s + c) =
              cxr::pack_bf16x2(dva16[n][2 * r] * vscale,
                               dva16[n][2 * r + 1] * vscale);
        }
      }
    }
  }
}

template <int kD, bool kPad, bool kDropout, bool kSegment>
__global__ void __launch_bounds__(128, BwdShape<kD>::kBlocksPerSm)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int H, int S, int hd,
                 Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
                 Strides dqs, float scale, float scale_log2,
                 cxr::Dropout drop, const int* __restrict__ seg) {
  using L = BwdShape<kD>;
  constexpr int kC = L::kChunks;
  constexpr int T = cxr::kTileBytes, T16 = cxr::kTile16Bytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = cxr::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - raw);

  const int m0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const uint32_t dbh = kDropout ? cxr::drop_base(drop, b, h) : 0u;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;

  // the copies of key tile ``tile`` (K and V chunks, ids) into a stage
  auto fetch = [&](int stage, int tile) {
    const int n0 = tile * kTile;
    const uint32_t st = ring + stage * L::kStageBytes;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      cxr::copy_chunk_async<kPad>(st + c * T, kp, ks.s, n0, S, c, hd);
      cxr::copy_chunk_async<kPad>(st + (kC + c) * T, vp, vs.s, n0, S, c, hd);
    }
    if constexpr (L::kTail) {
      cxr::copy_tile16_async(st + L::kTail16, kp, ks.s, n0, S, 64 * kC, hd);
      cxr::copy_tile16_async(st + L::kTail16 + T16, vp, vs.s, n0, S, 64 * kC,
                             hd);
    }
    if (kSegment && tid < kTile) {
      const bool ok = n0 + tid < S;
      cxr::cp_async_4(st + L::kStageAux + 512 + 4 * tid,
                      segp + (ok ? n0 + tid : 0), ok);
    }
  };

  // the block's own Q and dO: through the last stage into A fragments
  // (kOwnFrags), else in tiles behind the ring for the whole walk
  const uint32_t own = L::kOwnFrags ? ring + (kStages - 1) * L::kStageBytes
                                    : ring + kStages * L::kStageBytes;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    cxr::copy_chunk_async<kPad>(own + c * T, q + b * qs.b + h * qs.h, qs.s,
                                m0, S, c, hd);
    cxr::copy_chunk_async<kPad>(own + (kC + c) * T,
                                dout + b * dos.b + h * dos.h, dos.s, m0, S,
                                c, hd);
  }
  if constexpr (L::kTail) {
    cxr::copy_tile16_async(own + L::kTail16, q + b * qs.b + h * qs.h, qs.s,
                           m0, S, 64 * kC, hd);
    cxr::copy_tile16_async(own + L::kTail16 + T16,
                           dout + b * dos.b + h * dos.h, dos.s, m0, S,
                           64 * kC, hd);
  }
  cxr::cp_async_commit();
  cxr::TileWalk<kSegment> walk(segp, S, m0);
  int fifo[kStages];  // fifo[0]: the tile to compute next; then those in flight
#pragma unroll
  for (int d = 0; d < kStages - 1; ++d) {
    fifo[d] = walk.next();
    if (fifo[d] >= 0) fetch(d, fifo[d]);
    cxr::cp_async_commit();
  }
  fifo[kStages - 1] = -1;

  // Delta = rowsum(dO * O) of the block's 64 rows, under the copies:
  // kDeltaLanes lanes a row, summed in attn_bwd_delta's order. It goes to device memory
  // for the dK/dV pass, which runs after this one, and through shared
  // memory (the own stage's spare words, or 256 bytes behind the own
  // tiles) to this block's warps.
  float* sDelta = reinterpret_cast<float*>(
      L::kOwnFrags
          ? ring_ptr + (kStages - 1) * L::kStageBytes + L::kStageAux
          : ring_ptr + kStages * L::kStageBytes + L::kOwnBytes);
  {
    constexpr int kLanes = L::kDeltaLanes;  // 16-byte pieces of a row
    const __nv_bfloat16* op = o + b * os.b + h * os.h;
    const __nv_bfloat16* dop = dout + b * dos.b + h * dos.h;
#pragma unroll
    for (int j = 0; j < kLanes / 2; ++j) {
      const int i = tid + 128 * j, r = i / kLanes, part = i % kLanes;
      const int row = m0 + r;
      float acc = 0.f;
      if (row < S && (!kPad || part * 8 < hd)) {
        const uint4 ov =
            *reinterpret_cast<const uint4*>(op + row * os.s + part * 8);
        const uint4 dv =
            *reinterpret_cast<const uint4*>(dop + row * dos.s + part * 8);
        const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
        const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(cxr::to_f32(oe[e]), cxr::to_f32(de[e]), acc);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (part == 0) {
        sDelta[r] = acc;
        if (row < S) delta[static_cast<long long>(bh) * S + row] = acc;
      }
    }
  }
  cxr::cp_async_wait<kStages - 1>();
  __syncthreads();
  uint32_t qf[4][4], df[4][4];
  if constexpr (L::kOwnFrags) {
    cxr::load_a_swizzled(own, wr, lane, qf);
    cxr::load_a_swizzled(own + T, wr, lane, df);
  }

  const int row0 = m0 + wr + g;
  float l2[2], dl[2];
  uint32_t dbase[2];  // dropout counters of the two rows
  int seg_row[2] = {0, 0};  // ids of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long idx = static_cast<long long>(bh) * S + row;
    l2[r] = row < S ? lse[idx] * kLog2e : INFINITY;  // pad rows: P = 0
    dl[r] = sDelta[wr + g + 8 * r];                  // pad rows: 0
    dbase[r] = kDropout ? cxr::drop_row(drop, dbh, row) : 0u;
    if (kSegment) seg_row[r] = row < S ? segp[row] : cxr::kNoSegment;
  }
  float dqa[kC][8][4];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      dqa[c][n][0] = dqa[c][n][1] = dqa[c][n][2] = dqa[c][n][3] = 0.f;
  cxr::acc_fence(dqa);
  float dqa16[2][4];  // kTail: dQ's columns 64-79
  if constexpr (L::kTail) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
      dqa16[n][0] = dqa16[n][1] = dqa16[n][2] = dqa16[n][3] = 0.f;
    cxr::acc_fence(dqa16);
  }

  int cs = 0;  // the stage of fifo[0]
  while (fifo[0] >= 0) {
    cxr::cp_async_wait<kStages - 2>();
    __syncthreads();  // as in the dK/dV pass
    fifo[kStages - 1] = walk.next();
    if (fifo[kStages - 1] >= 0)
      fetch(cs == 0 ? kStages - 1 : cs - 1, fifo[kStages - 1]);
    cxr::cp_async_commit();

    const int n0 = fifo[0] * kTile, krows = min(kTile, S - n0);
    const uint32_t sk = ring + cs * L::kStageBytes, sv = sk + kC * T;
    const int* sI = reinterpret_cast<const int*>(
        ring_ptr + cs * L::kStageBytes + L::kStageAux + 512);

    {
      // S = Q K^T and dP = dO V^T: 16 queries x 64 keys per warp
      float sp[8][4], dp[8][4];
      cxr::wgmma_fence();
      if constexpr (L::kOwnFrags) {
        cxr::tile_mma_rs<false>(sp, qf, sk);
        cxr::wgmma_commit();
        cxr::tile_mma_rs<false>(dp, df, sv);
        cxr::wgmma_commit();
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c)
          cxr::tile_mma_ss(sp, own + c * T, sk + c * T, c > 0,
                           chunk_steps<kD>(c, hd));
        if constexpr (L::kTail)
          cxr::tile16_mma_ss(sp, own + L::kTail16, sk + L::kTail16);
        cxr::wgmma_commit();
#pragma unroll
        for (int c = 0; c < kC; ++c)
          cxr::tile_mma_ss(dp, own + (kC + c) * T, sv + c * T, c > 0,
                           chunk_steps<kD>(c, hd));
        if constexpr (L::kTail)
          cxr::tile16_mma_ss(dp, own + L::kTail16 + T16,
                             sk + L::kTail16 + T16);
        cxr::wgmma_commit();
      }
      cxr::wgmma_wait<1>(sp);

      // P rounded to bf16 (pad keys 0), two to a register
      uint32_t pp[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int kc = n * 8 + 2 * t, kk = n >> 1, hi = (n & 1) * 2;
        if (n * 8 >= krows) {  // block-uniform: sub-tiles of pad keys
          pp[kk][hi] = pp[kk][hi + 1] = 0u;
          continue;
        }
        int id[2] = {0, 0};
        if (kSegment) {
          const int2 i2 = *reinterpret_cast<const int2*>(sI + kc);
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
        pp[kk][hi] = cxr::pack_bf16x2(pe[0], pe[1]);
        pp[kk][hi + 1] = cxr::pack_bf16x2(pe[2], pe[3]);
      }
      cxr::wgmma_wait<0>(dp);

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
          const float p = j ? cxr::bf16_hi(w) : cxr::bf16_lo(w);
          float dpe = dp[n][e];
          if (kDropout)
            dpe = cxr::kept(drop, dbase[r], n0 + kc + j) ? dpe * drop.inv_keep
                                                         : 0.f;
          de[e] = p * (dpe - dl[r]);
        }
        dsf[kk][hi] = cxr::pack_bf16x2(de[0], de[1]);
        dsf[kk][hi + 1] = cxr::pack_bf16x2(de[2], de[3]);
      }
      // dQ += dS K, chunk by chunk
      cxr::wgmma_fence(dsf);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        cxr::tile_mma_rs<true>(dqa[c], dsf, sk + c * T, krows);
      if constexpr (L::kTail)
        cxr::tile16_mma_rs(dqa16, dsf, sk + L::kTail16, krows);
      cxr::wgmma_commit();
      cxr::wgmma_wait<0>(dqa);  // the stage is free once this is done
      if constexpr (L::kTail) cxr::acc_fence(dqa16);
    }
#pragma unroll
    for (int d = 0; d < kStages - 1; ++d) fifo[d] = fifo[d + 1];
    cs = cs + 1 == kStages ? 0 : cs + 1;
  }
  cxr::cp_async_wait<0>();  // copies never outlive the block

  __nv_bfloat16* dqp = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int ch = 0; ch < kC; ++ch)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = ch * 64 + n * 8 + 2 * t;
      if (kPad && c >= hd) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < S)
          *reinterpret_cast<uint32_t*>(dqp + row * dqs.s + c) =
              cxr::pack_bf16x2(dqa[ch][n][2 * r] * scale,
                               dqa[ch][n][2 * r + 1] * scale);
      }
    }
  if constexpr (L::kTail) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c = 64 * kC + n * 8 + 2 * t;
      if (c >= hd) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < S)
          *reinterpret_cast<uint32_t*>(dqp + row * dqs.s + c) =
              cxr::pack_bf16x2(dqa16[n][2 * r] * scale,
                               dqa16[n][2 * r + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMA, kP = kD / 32 threads per row (thread ``part`` holds the
// elements kP * i + part of the head dim, 32 of them, so the registers stay
// those of d = 64), tiles of the other operand in shared memory (kWalk =
// 64 * 64 / kD rows of kD columns: 16 KB each).
// ---------------------------------------------------------------------------

template <int kD>
struct F32Shape {
  static constexpr int kP = kD / 32;          // threads a row
  static constexpr int kCols = kD / kP;       // elements a thread: 32
  static constexpr int kThreads = kTile * kP;
  static constexpr int kWalk = kTile * 64 / kD;
};

template <int kD>
__device__ __forceinline__ void load_tile_f32(const float* src, long long stride,
                                              int r0, int S, int hd,
                                              float (*dst)[kD]) {
  using L = F32Shape<kD>;
  for (int i = threadIdx.x; i < L::kWalk * (kD / 4); i += L::kThreads) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && c < hd)
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<float4*>(&dst[r][c]) = val;
  }
}

// The row's dot product over its kP threads (each holds a share).
template <int kD>
__device__ __forceinline__ float part_dot(const float (&a)[F32Shape<kD>::kCols],
                                          const float* row, int part) {
  constexpr int kP = kD / 32;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kD / kP; ++i) s = fmaf(a[i], row[kP * i + part], s);
#pragma unroll
  for (int off = 1; off < kP; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int kD, bool kDropout, bool kSegment>
__global__ void __launch_bounds__(F32Shape<kD>::kThreads)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int H, int S,
                  int hd, Strides qs, Strides ks, Strides vs, Strides dos,
                  Strides dks, Strides dvs, float scale, float scale_log2,
                  cxr::Dropout drop, const int* __restrict__ seg) {
  using L = F32Shape<kD>;
  constexpr int kP = L::kP, kCols = L::kCols, kWalk = L::kWalk;
  __shared__ __align__(16) float sQ[kWalk][kD];
  __shared__ __align__(16) float sdO[kWalk][kD];
  __shared__ float sL[kWalk], sD[kWalk];
  __shared__ int sSeg[kSegment ? kTile : 2];   // ids of the query tile
  __shared__ int sRange[2];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const int key = blockIdx.x * kTile + static_cast<int>(threadIdx.x) / kP;
  const int part = threadIdx.x % kP;
  // the dropout counter of (bh, query 0): a query row adds row * s_pad
  const uint32_t dbh = kDropout ? cxr::drop_base(drop, b, h) : 0u;
  const bool key_ok = key < S;
  const float* kr = k + b * ks.b + h * ks.h + (key_ok ? key : 0) * ks.s;
  const float* vr = v + b * vs.b + h * vs.h + (key_ok ? key : 0) * vs.s;
  float kv[kCols], vv[kCols], dka[kCols], dva[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const bool in = kP * i + part < hd;
    kv[i] = in ? kr[kP * i + part] : 0.f;
    vv[i] = in ? vr[kP * i + part] : 0.f;
    dka[i] = dva[i] = 0.f;
  }
  const float* qp = q + b * qs.b + h * qs.h;
  const float* dop = dout + b * dos.b + h * dos.h;
  const float* lp = lse + static_cast<long long>(bh) * S;
  const float* dlp = delta + static_cast<long long>(bh) * S;
  int seg_key = 0, seg_lo = 0, seg_hi = 0;
  if (kSegment) {
    cxr::load_block_ids(segp, blockIdx.x * kTile, S, sSeg, sRange);
    seg_key = sSeg[threadIdx.x / kP];
    seg_lo = sRange[0];
    seg_hi = sRange[1];
  }

  for (int m0 = 0; m0 < S; m0 += kWalk) {
    __syncthreads();
    // (the vote reads 64 ids from m0: a conservative test of kWalk rows)
    if (kSegment && !cxr::load_tile_ids(segp, m0, S, seg_lo, seg_hi, sSeg))
      continue;
    load_tile_f32<kD>(qp, qs.s, m0, S, hd, sQ);
    load_tile_f32<kD>(dop, dos.s, m0, S, hd, sdO);
    if (threadIdx.x < kWalk && m0 + threadIdx.x < S) {
      sL[threadIdx.x] = lp[m0 + threadIdx.x] * kLog2e;
      sD[threadIdx.x] = dlp[m0 + threadIdx.x];
    }
    __syncthreads();
    const int jn = min(kWalk, S - m0);
    for (int j = 0; j < jn; ++j) {
      const float s = part_dot<kD>(kv, sQ[j], part);
      // every thread reaches part_dot's shuffles: mask by value, not by
      // a branch around them
      const bool pair_ok = key_ok && (!kSegment || sSeg[j] == seg_key);
      const float p = pair_ok ? exp2f(s * scale_log2 - sL[j]) : 0.f;
      float dp = part_dot<kD>(vv, sdO[j], part);
      float pv = p;  // M * P, the factor of dV
      if (kDropout) {
        const bool keep =
            cxr::kept(drop, cxr::drop_row(drop, dbh, m0 + j), key);
        dp = keep ? dp * drop.inv_keep : 0.f;
        pv = keep ? p : 0.f;
      }
      const float ds = p * (dp - sD[j]);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        dva[i] = fmaf(pv, sdO[j][kP * i + part], dva[i]);
        dka[i] = fmaf(ds, sQ[j][kP * i + part], dka[i]);
      }
    }
  }
  if (!key_ok) return;
  float* dkr = dk + b * dks.b + h * dks.h + key * dks.s;
  float* dvr = dv + b * dvs.b + h * dvs.h + key * dvs.s;
  const float vscale = kDropout ? drop.inv_keep : 1.f;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (kP * i + part >= hd) continue;
    dkr[kP * i + part] = dka[i] * scale;
    dvr[kP * i + part] = dva[i] * vscale;
  }
}

template <int kD, bool kDropout, bool kSegment>
__global__ void __launch_bounds__(F32Shape<kD>::kThreads)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int H, int S, int hd, Strides qs,
                Strides ks, Strides vs, Strides dos, Strides dqs, float scale,
                float scale_log2, cxr::Dropout drop,
                const int* __restrict__ seg) {
  using L = F32Shape<kD>;
  constexpr int kP = L::kP, kCols = L::kCols, kWalk = L::kWalk;
  __shared__ __align__(16) float sK[kWalk][kD];
  __shared__ __align__(16) float sV[kWalk][kD];
  __shared__ int sSeg[kSegment ? kTile : 2];   // ids of the key tile
  __shared__ int sRange[2];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const int row = blockIdx.x * kTile + static_cast<int>(threadIdx.x) / kP;
  const int part = threadIdx.x % kP;
  const bool row_ok = row < S;
  const float* qr = q + b * qs.b + h * qs.h + (row_ok ? row : 0) * qs.s;
  const float* dr = dout + b * dos.b + h * dos.h + (row_ok ? row : 0) * dos.s;
  float qv[kCols], dov[kCols], dqa[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const bool in = kP * i + part < hd;
    qv[i] = in ? qr[kP * i + part] : 0.f;
    dov[i] = in ? dr[kP * i + part] : 0.f;
    dqa[i] = 0.f;
  }
  const long long idx = static_cast<long long>(bh) * S + (row_ok ? row : 0);
  const float l2 = lse[idx] * kLog2e, dl = delta[idx];
  const uint32_t dbase =
      kDropout ? cxr::drop_row(drop, cxr::drop_base(drop, b, h), row) : 0u;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  int seg_row = 0, seg_lo = 0, seg_hi = 0;
  if (kSegment) {
    cxr::load_block_ids(segp, blockIdx.x * kTile, S, sSeg, sRange);
    seg_row = sSeg[threadIdx.x / kP];
    seg_lo = sRange[0];
    seg_hi = sRange[1];
  }

  for (int n0 = 0; n0 < S; n0 += kWalk) {
    __syncthreads();
    if (kSegment && !cxr::load_tile_ids(segp, n0, S, seg_lo, seg_hi, sSeg))
      continue;
    load_tile_f32<kD>(kp, ks.s, n0, S, hd, sK);
    load_tile_f32<kD>(vp, vs.s, n0, S, hd, sV);
    __syncthreads();
    const int jn = min(kWalk, S - n0);
    for (int j = 0; j < jn; ++j) {
      const float s = part_dot<kD>(qv, sK[j], part);
      const float p = !kSegment || sSeg[j] == seg_row
          ? exp2f(s * scale_log2 - l2) : 0.f;
      float dp = part_dot<kD>(dov, sV[j], part);
      if (kDropout)
        dp = cxr::kept(drop, dbase, n0 + j) ? dp * drop.inv_keep : 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        dqa[i] = fmaf(ds, sK[j][kP * i + part], dqa[i]);
    }
  }
  if (!row_ok) return;
  float* dqr = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    if (kP * i + part < hd) dqr[kP * i + part] = dqa[i] * scale;
}

// The two passes (bf16) or the three kernels (f32, which always mask by
// column and are not built at kD = 80: F32Shape splits a row over kD / 32
// threads) at padded head dim kD.
template <int kD, bool kPad, bool kDropout, bool kSegment>
int launch_bwd_at(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* l, float* dl, void* dq,
                  void* dk, void* dv, int batch, int heads, int seq,
                  int head_dim, const Strides (&st)[8], float scale,
                  int dtype, cudaStream_t cs, const cxr::Dropout& drop,
                  const int* seg) {
  using L = BwdShape<kD>;
  const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    // more dynamic shared memory than the default limit: opt in (per device,
    // so on every call); a launch that asks for more than that is refused
    auto dkdv = attn_bwd_dkdv_bf16<kD, kPad, kDropout, kSegment>;
    auto dqk = attn_bwd_dq_bf16<kD, kPad, kDropout, kSegment>;
    if ((err = cudaFuncSetAttribute(
             dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
             L::kDkdvSmemBytes)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
             L::kDqSmemBytes)) != cudaSuccess)
      return static_cast<int>(err);
    // the dQ pass first: it also writes Delta, which the dK/dV pass reads
    dqk<<<grid, 128, L::kDqSmemBytes, cs>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(o),
        static_cast<const bf*>(dout), l, dl, static_cast<bf*>(dq), heads, seq,
        head_dim, st[0], st[1], st[2], st[3], st[4], st[5], scale, scale_log2,
        drop, seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dkdv<<<grid, 128, L::kDkdvSmemBytes, cs>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), l, dl,
        static_cast<bf*>(dk), static_cast<bf*>(dv), heads, seq, head_dim,
        st[0], st[1], st[2], st[4], st[6], st[7], scale, scale_log2, drop,
        seg);
  } else if constexpr (L::kTail) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    using F = F32Shape<kD>;
    constexpr int kLanes = kD / 4;  // attn_bwd_delta's lanes a row
    const long long rows = static_cast<long long>(batch) * heads * seq;
    const unsigned delta_blocks =
        static_cast<unsigned>((rows * kLanes + 255) / 256);
    attn_bwd_delta<float, kD><<<delta_blocks, 256, 0, cs>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dl,
        heads, seq, head_dim, rows, st[3], st[4]);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkdv_f32<kD, kDropout, kSegment><<<grid, F::kThreads, 0, cs>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dk), static_cast<float*>(dv), heads, seq,
        head_dim, st[0], st[1], st[2], st[4], st[6], st[7], scale, scale_log2,
        drop, seg);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dq_f32<kD, kDropout, kSegment><<<grid, F::kThreads, 0, cs>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dq), heads, seq, head_dim, st[0], st[1], st[2],
        st[4], st[5], scale, scale_log2, drop, seg);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (the width: cxr::bf16_head_dim in bf16,
// cxr::padded_head_dim in f32). ``strides`` holds (batch, head, seq)
// element strides of q, k, v, o, dout, dq, dk, dv in that order (24
// values); every head dim is contiguous with 16-byte aligned rows (the
// wrapper checks), head_dim as cxr::head_dim_ok takes it. lse and the
// ``delta`` workspace are contiguous f32 [batch * heads, seq].
template <bool kDropout, bool kSegment = false>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int batch, int heads, int seq, int head_dim,
               const long long* strides, float scale, int dtype, int device,
               void* stream, cxr::Dropout drop, const int* seg = nullptr) {
  if (!cxr::head_dim_ok(head_dim) || seq <= 0 || batch <= 0 || heads <= 0 ||
      (dtype != 0 && dtype != 1) || kSegment != (seg != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (head_dim > cxr::kWideHeadDim)
    return cxr::wide::launch_bwd<kDropout, kSegment>(
        q, k, v, o, dout, l, dl, dq, dk, dv, batch, heads, seq, head_dim, st,
        scale, dtype, device, cs, drop, seg);
  if (head_dim == 64)
    return launch_bwd_at<64, false, kDropout, kSegment>(
        q, k, v, o, dout, l, dl, dq, dk, dv, batch, heads, seq, head_dim, st,
        scale, dtype, cs, drop, seg);
  if (cxr::padded_head_dim(head_dim) == 64)
    return launch_bwd_at<64, true, kDropout, kSegment>(
        q, k, v, o, dout, l, dl, dq, dk, dv, batch, heads, seq, head_dim, st,
        scale, dtype, cs, drop, seg);
  if (dtype == 1 && cxr::bf16_head_dim(head_dim) == 80)
    return launch_bwd_at<80, true, kDropout, kSegment>(
        q, k, v, o, dout, l, dl, dq, dk, dv, batch, heads, seq, head_dim, st,
        scale, dtype, cs, drop, seg);
  return launch_bwd_at<128, true, kDropout, kSegment>(
      q, k, v, o, dout, l, dl, dq, dk, dv, batch, heads, seq, head_dim, st,
      scale, dtype, cs, drop, seg);
}

}  // namespace bwd
}  // namespace cxr
