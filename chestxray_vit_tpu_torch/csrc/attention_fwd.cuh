// The attention forward, O = softmax(Q K^T * scale) V, shared by the
// inference entry point (flash_attention_inf.cu, no lse), the training one
// (flash_attention.cu, which also writes the natural-log logsumexp that the
// backward recomputes P from) and the dropout one
// (flash_attention_dropout.cu: kDropout drops probabilities after the
// softmax, kEmitKeep also writes the mask) and the segment ones
// (flash_attention_seg.cu: kSegment masks every score whose query and key
// carry different segment ids, for packed sequences). See those files for
// which TPU kernel each replaces.
//
// A warpgroup (128 threads) owns 64 query rows of one (batch, head) and
// walks the key tiles with an online (running max / running sum) softmax,
// so no score tile and no padded copy ever reaches device memory: q, k, v
// are read in place through their strides and the ragged key tail (S = 577
// = 9 * 64 + 1 at ViT-B/16 @384) is masked by index in registers.
//
// How the bf16 path feeds the tensor cores:
// - The block's Q tile arrives once by cp.async into a 128-byte swizzled
//   tile and stays there. K and V tiles (with kSegment their 64 ids) arrive
//   by cp.async, zero-filled past S, into a two-stage ring in dynamic
//   shared memory, each tile stored once under the 128-byte swizzle: the
//   next tile's copies are issued before the current tile's products, and
//   one cp.async wait and one barrier per tile order them.
// - S = Q K^T is a wgmma with both operands read through descriptors (K-major
//   tiles); O += P V a wgmma with P in registers and V read as it lies, in
//   the transposed-B form, so no tile is copied transposed and no B
//   fragment passes through registers. The PV product runs only the 16-deep
//   steps that hold a key below S (one of four in the tail tile at S =
//   577), and the softmax only the 8-wide column slices that do.
// - The softmax stays in f32 registers in the accumulator layout; P is
//   rounded to bf16 after the exp2 and packed as the A fragments of the PV
//   product (acc_to_a), and the normalizer l sums the rounded P, so the
//   output is a convex combination of V rows (the TPU kernel rounds the
//   exp2 argument instead). The exp2 is the special-function unit's own
//   (exp2_approx).
// - O is staged through shared memory and written as 16-byte rows.
// What bounds it on an H100: the serial chain of each block's tile (a
// barrier, the S product, the softmax with one exp2 on the special-function
// unit per score, the PV product), hidden only by the other three blocks of
// the SM. At [36, 12, 577, 64] the tensor cores run at about 24 % of their
// peak and the exp2 unit at about 22 %; 128-row blocks, which read K/V
// from L2 half as often, were not faster (PERF.md). S reads Q and K (16 KB) from shared memory a tile, PV 8 KB of
// V: Q held as register fragments across the walk was read no faster, and
// ptxas reused those registers in one build.
// The f32 path (used for parity runs) is plain FMA.
//
// Head dims: any d with d % 8 == 0 and 8 <= d <= 128 here (d above 128
// goes to attention_fwd_wide.cuh, which splits O's columns), built
// at a padded width kD (bf16_head_dim): 64, 80 (bf16, 64 < d <= 80) or 128;
// d itself is a runtime argument. Each 64-column chunk of a Q, K, V or O
// tile is one of the swizzled 64 x 64 tiles above, so the copies,
// descriptors and the m64n64k16 steps are those of d = 64: S sums the
// chunks' QK products, O keeps one accumulator a V chunk. At kD = 80 the
// columns 64-79 are a 64 x 16 tile of their own under the 32-byte swizzle
// (common.cuh): S adds its one 16-deep step, O += P V_16 runs m64n16k16
// on V's 16 columns as they lie, so the O accumulator is 40 registers a
// thread and no column past 80 is computed. Columns at or past d arrive as
// zeros and are never stored, which is exact: zero Q/K columns add nothing
// to QK^T, zero V columns give zero O columns. The S product skips the
// 16-deep steps of the last chunk that lie wholly past d. The 16-deep
// steps, their order and their operands are those of kD = 128 on the same
// d, so the two widths give the same bits (a d = 80 call equals a d = 128
// call on operands zero-padded to 128). kD = 128 doubles the O
// accumulator (64 registers a thread) and the stage, so it runs two blocks
// an SM (83 KB of shared memory each); kD = 64 (43 KB) and kD = 80 (53 KB)
// run four. The f32 forward is built at 64 or 128 (padded_head_dim). The
// softmax scale is the caller's (d^-1/2 of the real d).
//
// The running max is kept in log2 units (score * scale * log2 e); the lse
// written for the backward is natural: m * ln 2 + ln l. Rows whose valid
// scores are all strongly negative stay finite: every key tile holds at
// least one valid key, so the running max is finite after the first tile
// and exp2(-inf - m) is exactly 0 for masked columns. With kSegment a tile
// may hold no key of a row's segment, so the running max can stay -inf past
// the first tile: the rescale then takes 0 in its place (see safe_max), and
// a key tile none of whose ids lies within the block's range of ids is
// never visited (TileWalk). Ids are never assumed sorted or contiguous.
#pragma once

#include <math.h>

#include "attention_fwd_wide.cuh"
#include "common.cuh"

namespace cxr {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per K/V tile


// The bf16 forward's shared memory at padded head dim kD: a ring of two
// stages (the next tile's copies fly under the current tile's products),
// each the K and V tiles (kD / 64 chunks each, and at kD = 80 a 64 x 16
// tile after them) and 64 int32 ids, padded to keep every tile 1024-byte
// aligned, then the block's Q tile; 1024 bytes of slack put the ring on a
// 1024-byte boundary. The O tile passes through the first stage at the
// end.
constexpr int kFwdStages = 2;
template <int kD>
struct FwdShape {
  static constexpr int kChunks = kD / 64;
  static constexpr bool kTail = kD % 64 != 0;   // kD = 80: columns 64-79
  static_assert(kD % 64 == 0 || kD % 64 == 16, "64-column chunks and a 16");
  // one operand's tile: its chunks, then the 16-column tile
  static constexpr int kOperandBytes =
      kChunks * kTileBytes + (kTail ? kTile16Bytes : 0);
  static constexpr int kIdsOffset = 2 * kOperandBytes;   // in a stage
  static constexpr int kStageBytes = (kIdsOffset + 256 + 1023) / 1024 * 1024;
  static constexpr int kSmemBytes =
      kFwdStages * kStageBytes + kOperandBytes + 1024;
  // kD = 64 and 80: four blocks an SM (sixteen warps), so at most 128
  // registers a thread: the four hide one another's barrier, wgmma and
  // exp2 latencies. Three (the backward's) read 16-18 % slower with
  // dropout or segment ids, whose threads then take 134-148 registers.
  // kD = 128: two, for the 64 more accumulator registers and the 83 KB of
  // shared memory.
  static constexpr int kBlocksPerSm = kD == 128 ? 2 : 4;
};

// The blocks an SM a forward is built for: FwdShape's, but three for the
// segment dropout form at kD = 80, which at 128 registers spilled 12 bytes
// (its 8 more O registers beside the ids and the hash).
template <int kD, bool kDropout, bool kSegment>
constexpr int fwd_blocks_per_sm() {
  return kD == 80 && kDropout && kSegment ? 3 : FwdShape<kD>::kBlocksPerSm;
}

// 128 threads = one warpgroup; warp w owns query rows [16w, 16w + 16) of
// the block. lse (kLse only) is [B * H, S] contiguous, f32. With kDropout
// the normalizer l sums the clean P, the PV product takes the masked P, and
// the output is divided by l * (1 - rate); kEmitKeep writes each element's
// keep bit to drop.keep. With kSegment, seg is int32 [B, S] contiguous and
// a score counts only where its query's and key's ids are equal. hd is the
// real head dim (at most kD); kPad masks the columns at or past it.
template <int kD, bool kPad, bool kLse, bool kDropout, bool kEmitKeep,
          bool kSegment>
__global__ void __launch_bounds__(
    128, (fwd_blocks_per_sm<kD, kDropout, kSegment>()))
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int H, int S, int hd, Strides qs,
              Strides ks, Strides vs, Strides os, float scale_log2,
              Dropout drop, const int* __restrict__ seg) {
  using F = FwdShape<kD>;
  constexpr int kC = F::kChunks;
  constexpr int kTailCol = 64 * kC;  // the 16-column tile's first column
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - raw);

  const int m0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const __nv_bfloat16* kp = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + h * vs.h;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int row0 = m0 + wr + g;  // rows of accumulator rows g and g + 8
  // the 16-deep steps of the last chunk that reach a column below hd
  const int last_steps = kC > 1 ? (hd - 64 * (kC - 1) + 15) / 16 : 4;

  // the copies of key tile ``tile`` (K and V chunks, ids) into a stage
  auto fetch = [&](int stage, int tile) {
    const int n0 = tile * kBlockN;
    const uint32_t st = ring + stage * F::kStageBytes;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      copy_chunk_async<kPad>(st + c * kTileBytes, kp, ks.s, n0, S, c, hd);
      copy_chunk_async<kPad>(st + F::kOperandBytes + c * kTileBytes, vp, vs.s,
                             n0, S, c, hd);
    }
    if constexpr (F::kTail) {
      copy_tile16_async(st + kC * kTileBytes, kp, ks.s, n0, S, kTailCol, hd);
      copy_tile16_async(st + F::kOperandBytes + kC * kTileBytes, vp, vs.s, n0,
                        S, kTailCol, hd);
    }
    if (kSegment && tid < kBlockN) {
      const bool ok = n0 + tid < S;
      cp_async_4(st + F::kIdsOffset + 4 * tid, segp + (ok ? n0 + tid : 0),
                 ok);
    }
  };

  // Q stays in shared memory behind the ring, the A operand of every S
  // product (held as register fragments across the walk, those registers
  // were reused by ptxas in one build)
  const uint32_t qtile = ring + kFwdStages * F::kStageBytes;
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
#pragma unroll
  for (int c = 0; c < kC; ++c)
    copy_chunk_async<kPad>(qtile + c * kTileBytes, qp, qs.s, m0, S, c, hd);
  if constexpr (F::kTail)
    copy_tile16_async(qtile + kC * kTileBytes, qp, qs.s, m0, S, kTailCol, hd);
  cp_async_commit();
  TileWalk<kSegment> walk(segp, S, m0);
  int fifo[kFwdStages];  // fifo[0]: the tile to compute next; then those in flight
#pragma unroll
  for (int d = 0; d < kFwdStages - 1; ++d) {
    fifo[d] = walk.next();
    if (fifo[d] >= 0) fetch(d, fifo[d]);
    cp_async_commit();
  }
  fifo[kFwdStages - 1] = -1;

  int seg_row[2] = {0, 0};       // ids of the two rows
  uint32_t dbase[2] = {0u, 0u};  // dropout counters of the two rows
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

  float acc[kC][8][4];  // O, one accumulator a 64-column chunk of V
  float acc16[2][4];    // kTail: O's columns 64-79
#pragma unroll
  for (int ch = 0; ch < kC; ++ch)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[ch][n][0] = acc[ch][n][1] = acc[ch][n][2] = acc[ch][n][3] = 0.f;
  acc_fence(acc);
  if constexpr (F::kTail) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
      acc16[n][0] = acc16[n][1] = acc16[n][2] = acc16[n][3] = 0.f;
    acc_fence(acc16);
  }
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8 (log2 units)
  float l_run[2] = {0.f, 0.f};              // this thread's share of the sum

  int cs = 0;  // the stage of fifo[0]
  while (fifo[0] >= 0) {
    cp_async_wait<kFwdStages - 2>();
    // tile fifo[0] (and Q) has arrived for every thread, and every thread
    // is done with the stage before it, which the next copies overwrite
    __syncthreads();
    fifo[kFwdStages - 1] = walk.next();
    if (fifo[kFwdStages - 1] >= 0)
      fetch(cs == 0 ? kFwdStages - 1 : cs - 1, fifo[kFwdStages - 1]);
    cp_async_commit();

    const int n0 = fifo[0] * kBlockN, krows = min(kBlockN, S - n0);
    const uint32_t sk = ring + cs * F::kStageBytes,
                   sv = sk + F::kOperandBytes;
    const int* sI = reinterpret_cast<const int*>(
        ring_ptr + cs * F::kStageBytes + F::kIdsOffset);

    // S = Q K^T: 16 rows x 64 keys per warp, raw scores, summed over the
    // head dim's chunks (and the 16-column tile's one step)
    float s[8][4];
    wgmma_fence();
#pragma unroll
    for (int ch = 0; ch < kC; ++ch)
      tile_mma_ss(s, qtile + ch * kTileBytes, sk + ch * kTileBytes, ch > 0,
                  ch == kC - 1 ? last_steps : 4);
    if constexpr (F::kTail)
      tile16_mma_ss(s, qtile + kC * kTileBytes, sk + kC * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>(s);

    if (prescale) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    }
    // pad keys (the tail tile) and other segments' keys to -inf; the
    // 8-wide slices of keys at or past S are skipped (block-uniform)
    if (kSegment || krows < kBlockN) {
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
          if (kEmitKeep && row < S && col < S)
            drop.keep[(static_cast<long long>(bh) * S + row) * S + col] = keep;
          if (!keep) s[n][e] = 0.f;
        }
      }
      acc_to_a(s, pf);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
    for (int ch = 0; ch < kC; ++ch)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[ch][n][0] *= alpha[0];
        acc[ch][n][1] *= alpha[0];
        acc[ch][n][2] *= alpha[1];
        acc[ch][n][3] *= alpha[1];
      }
    if constexpr (F::kTail) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        acc16[n][0] *= alpha[0];
        acc16[n][1] *= alpha[0];
        acc16[n][2] *= alpha[1];
        acc16[n][3] *= alpha[1];
      }
      acc_fence(acc16);
    }

    // O += P V, V as it lies (the transposed-B form), chunk by chunk, the
    // k-steps of keys below S only
    acc_fence(acc);
    wgmma_fence(pf);
#pragma unroll
    for (int ch = 0; ch < kC; ++ch)
      tile_mma_rs<true>(acc[ch], pf, sv + ch * kTileBytes, krows);
    if constexpr (F::kTail)
      tile16_mma_rs(acc16, pf, sv + kC * kTileBytes, krows);
    wgmma_commit();
    wgmma_wait<0>(acc);  // the stage is free once this is done
    if constexpr (F::kTail) acc_fence(acc16);
#pragma unroll
    for (int d = 0; d < kFwdStages - 1; ++d) fifo[d] = fifo[d + 1];
    cs = cs + 1 == kFwdStages ? 0 : cs + 1;
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
  // O through the ring (every warp is past its last product): each warp
  // stages its own 16 rows of a swizzled tile a chunk and writes them as
  // 16-byte rows, the columns below hd only
  __syncthreads();
  __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    unsigned char* ot = ring_ptr + ch * kTileBytes;
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
      if (m0 + r < S && (!kPad || col < hd))
        *reinterpret_cast<uint4*>(op + (m0 + r) * os.s + col) =
            *reinterpret_cast<const uint4*>(ot + swizzled(r, x));
    }
  }
  if constexpr (F::kTail) {
    // columns 64-79 straight from the registers: a quarter warp writes a
    // row's 32 bytes (the columns below hd only)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = kTailCol + n * 8 + 2 * t;
      if (col >= hd) continue;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(op + row0 * os.s + col) =
            pack_bf16x2(acc16[n][0] * inv0, acc16[n][1] * inv0);
      if (row0 + 8 < S)
        *reinterpret_cast<uint32_t*>(op + (row0 + 8) * os.s + col) =
            pack_bf16x2(acc16[n][2] * inv1, acc16[n][3] * inv1);
    }
  }
  if (kLse && t == 0) {
    float* lp = lse + static_cast<long long>(bh) * S;
    if (row0 < S) lp[row0] = m_run[0] * kLn2 + logf(l_run[0]);
    if (row0 + 8 < S) lp[row0 + 8] = m_run[1] * kLn2 + logf(l_run[1]);
  }
}

// f32 path: kP = kD / 64 threads per query row (thread ``part`` holds the
// columns kP * i + part, 64 of them, so the registers stay those of d =
// 64), K/V tiles in shared memory read as broadcasts (kBlockN / kP keys a
// tile: 16 KB each), online softmax over chunks of 16 keys. Dropout and
// the segment mask as in the bf16 path.
template <int kD, bool kLse, bool kDropout, bool kEmitKeep, bool kSegment>
__global__ void __launch_bounds__(kBlockM * (kD / 64))
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int H, int S, int hd, Strides qs,
             Strides ks, Strides vs, Strides os, float scale_log2,
             Dropout drop, const int* __restrict__ seg) {
  constexpr int kP = kD / 64, kKeys = kBlockN / kP, kCols = kD / kP;
  __shared__ __align__(16) float sK[kKeys][kD];
  __shared__ __align__(16) float sV[kKeys][kD];
  __shared__ int sSeg[kSegment ? kBlockN : 2];
  __shared__ int sRange[2];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int* segp = kSegment ? seg + static_cast<long long>(b) * S : nullptr;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  const int tid = threadIdx.x, part = tid % kP;
  const int row = blockIdx.x * kBlockM + tid / kP;
  const bool valid = row < S;

  float qr[kCols], acc[kCols];
  const float* qrow = q + b * qs.b + h * qs.h + (valid ? row : 0) * qs.s;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kP == 1) {
#pragma unroll
    for (int d = 0; d < kCols; d += 4) {
      const float4 x =
          d < hd ? *reinterpret_cast<const float4*>(qrow + d) : zero;
      qr[d] = x.x;
      qr[d + 1] = x.y;
      qr[d + 2] = x.z;
      qr[d + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      qr[i] = kP * i + part < hd ? qrow[kP * i + part] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const uint32_t dbase =
      kDropout ? drop_row(drop, drop_base(drop, b, h), row) : 0u;
  int seg_row = 0, seg_lo = 0, seg_hi = 0;
  if (kSegment) {
    load_block_ids(segp, blockIdx.x * kBlockM, S, sSeg, sRange);
    seg_row = sSeg[tid / kP];
    seg_lo = sRange[0];
    seg_hi = sRange[1];
  }

  for (int n0 = 0; n0 < S; n0 += kKeys) {
    __syncthreads();
    // (the vote reads 64 ids from n0: a conservative test of kKeys keys)
    if (kSegment && !load_tile_ids(segp, n0, S, seg_lo, seg_hi, sSeg)) continue;
    for (int i = tid; i < kKeys * (kD / 4); i += kBlockM * kP) {
      const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
      float4 kv = zero, vv = zero;
      if (n0 + r < S && c < hd) {
        kv = *reinterpret_cast<const float4*>(kp + (n0 + r) * ks.s + c);
        vv = *reinterpret_cast<const float4*>(vp + (n0 + r) * vs.s + c);
      }
      *reinterpret_cast<float4*>(&sK[r][c]) = kv;
      *reinterpret_cast<float4*>(&sV[r][c]) = vv;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kKeys; j0 += 16) {
      float s[16];
      float m_new = m_run;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          dot = fmaf(qr[i], sK[j0 + j][kP * i + part], dot);
        if constexpr (kP == 2) dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        bool ok = n0 + j0 + j < S;
        if (kSegment) ok = ok && sSeg[j0 + j] == seg_row;
        s[j] = ok ? dot * scale_log2 : -INFINITY;
        m_new = fmaxf(m_new, s[j]);
      }
      if (m_new == -INFINITY) continue;  // a chunk of masked keys only
      const float alpha = exp2f(m_run - m_new);
      m_run = m_new;
      l_run *= alpha;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float p = exp2f(s[j] - m_new);
        l_run += p;
        if (kDropout) {
          const int col = n0 + j0 + j;
          const bool keep = kept(drop, dbase, col);
          if (kEmitKeep && valid && col < S && part == 0)
            drop.keep[(static_cast<long long>(blockIdx.y) * S + row) * S +
                      col] = keep;
          if (!keep) p = 0.f;
        }
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          acc[i] = fmaf(p, sV[j0 + j][kP * i + part], acc[i]);
      }
    }
  }

  if (!valid) return;
  float* orow = o + b * os.b + h * os.h + row * os.s;
  const float inv = 1.f / (l_run * (kDropout ? drop.keep_prob : 1.f));
  if constexpr (kP == 1) {
#pragma unroll
    for (int d = 0; d < kCols; d += 4)
      if (d < hd)
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv,
                        acc[d + 3] * inv);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (kP * i + part < hd) orow[kP * i + part] = acc[i] * inv;
  }
  if (kLse && part == 0)
    lse[static_cast<long long>(blockIdx.y) * S + row] =
        m_run * kLn2 + logf(l_run);
}

// Launches the kernel for the dtype (0 = float32, 1 = bfloat16) at padded
// head dim kD on ``stream`` (the f32 kernel always masks by column and is
// not built at kD = 80).
template <int kD, bool kPad, bool kLse, bool kDropout, bool kEmitKeep,
          bool kSegment>
int launch_attn_fwd_at(const void* q, const void* k, const void* v, void* o,
                       float* lse, int batch, int heads, int seq,
                       int head_dim, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, int dtype, cudaStream_t st,
                       const Dropout& drop, const int* seg) {
  const dim3 grid((seq + kBlockM - 1) / kBlockM, batch * heads);
  const float scale_log2 = scale * kLog2e;
  if (dtype == 1) {
    constexpr int smem = FwdShape<kD>::kSmemBytes;
    auto kernel =
        attn_fwd_bf16<kD, kPad, kLse, kDropout, kEmitKeep, kSegment>;
    if constexpr (smem > 48 * 1024) {
      // more dynamic shared memory than the default limit: opt in (per
      // device, so on every call)
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, 128, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        lse, heads, seq, head_dim, qs, ks, vs, os, scale_log2, drop, seg);
  } else if (dtype == 0) {
    if constexpr (FwdShape<kD>::kTail)
      return static_cast<int>(cudaErrorInvalidValue);
    else
      attn_fwd_f32<kD, kLse, kDropout, kEmitKeep, kSegment>
          <<<grid, kBlockM * (kD / 64), 0, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), lse, heads,
          seq, head_dim, qs, ks, vs, os, scale_log2, drop, seg);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Checks the shape, picks the kernel for the dtype (0 = float32,
// 1 = bfloat16) and the padded head dim (bf16: bf16_head_dim; f32:
// padded_head_dim), and launches it on ``stream``.
template <bool kLse, bool kDropout = false, bool kEmitKeep = false,
          bool kSegment = false>
int launch_attn_fwd(const void* q, const void* k, const void* v, void* o,
                    float* lse, int batch, int heads, int seq, int head_dim,
                    Strides qs, Strides ks, Strides vs, Strides os, float scale,
                    int dtype, int device, void* stream,
                    Dropout drop = Dropout{}, const int* seg = nullptr) {
  if (!head_dim_ok(head_dim) || seq <= 0 || batch <= 0 || heads <= 0 ||
      kSegment != (seg != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static_assert(FwdShape<64>::kSmemBytes <= 48 * 1024,
                "d <= 64 fits the default dynamic shared memory limit");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim > kWideHeadDim)
    return wide::launch_fwd<kLse, kDropout, kEmitKeep, kSegment>(
        q, k, v, o, lse, batch, heads, seq, head_dim, qs, ks, vs, os, scale,
        dtype, device, st, drop, seg);
  if (head_dim == 64)
    return launch_attn_fwd_at<64, false, kLse, kDropout, kEmitKeep, kSegment>(
        q, k, v, o, lse, batch, heads, seq, head_dim, qs, ks, vs, os, scale,
        dtype, st, drop, seg);
  if (padded_head_dim(head_dim) == 64)
    return launch_attn_fwd_at<64, true, kLse, kDropout, kEmitKeep, kSegment>(
        q, k, v, o, lse, batch, heads, seq, head_dim, qs, ks, vs, os, scale,
        dtype, st, drop, seg);
  if (dtype == 1 && bf16_head_dim(head_dim) == 80)
    return launch_attn_fwd_at<80, true, kLse, kDropout, kEmitKeep, kSegment>(
        q, k, v, o, lse, batch, heads, seq, head_dim, qs, ks, vs, os, scale,
        dtype, st, drop, seg);
  return launch_attn_fwd_at<128, true, kLse, kDropout, kEmitKeep, kSegment>(
      q, k, v, o, lse, batch, heads, seq, head_dim, qs, ks, vs, os, scale,
      dtype, st, drop, seg);
}

}  // namespace cxr
