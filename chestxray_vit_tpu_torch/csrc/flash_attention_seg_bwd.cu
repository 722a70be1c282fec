// Segment-masked (block-diagonal) attention backward for packed sequences,
// with and without attention-probability dropout: dQ, dK, dV with P
// recomputed from the forward's lse under the segment mask.
//
// Replaces the TPU kernels chestxray_vit_tpu/ops/flash_attention.py
// `_bwd_kernel_seg` and `_bwd_kernel_seg_drop` (both `_bwd_seg_impl`,
// launched by `_bwd_seg`). Those hold a Q block and the whole padded K/V
// row in VMEM, add the -1e6 segment bias to the scores so that
// cross-segment P underflows to 0, and accumulate dK/dV across the
// sequential Q-block grid. Here the passes of attention_bwd.cuh run with
// kSegment: each recomputes P only where the query's and the key's ids are
// equal (0 elsewhere, so masked pairs add nothing to any gradient) and
// skips a 64-row tile of the operand it walks when none of the tile's ids
// lies within the range of the block's own ids, by a test of the ids and
// not of positions: after a token merge the ids interleave. The bf16 passes
// find the tiles to visit 32 at a time from the ids in device memory, every
// warp alike, before any copy of a tile is issued. The ids are int32
// [B, S], read in place once for all heads. With kDropout the mask is
// regenerated with the segment kernels' strides (q_pad = s_pad = the
// sequence padded to the TPU wrapper's Q block).
//
// What bounds them on an H100: tensor-core throughput over the
// same-segment tiles only (see attention_bwd.cuh).

#include "attention_bwd.cuh"

// The arguments of cxr_attention_bwd after seg, a contiguous int32
// [batch, seq] buffer.
extern "C" int cxr_attention_bwd_seg(
    const void* seg, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, void* delta, void* dq,
    void* dk, void* dv, int batch, int heads, int seq, int head_dim,
    const long long* strides, float scale, int dtype, int device,
    void* stream) {
  return cxr::bwd::launch_bwd<false, true>(
      q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads, seq, head_dim,
      strides, scale, dtype, device, stream, cxr::Dropout{},
      static_cast<const int*>(seg));
}

// The dropout backward: also the mask's scalars (see cxr::Dropout) and
// 1 / (1 - rate).
extern "C" int cxr_attention_bwd_seg_dropout(
    const void* seg, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const void* lse, void* delta, void* dq,
    void* dk, void* dv, int batch, int heads, int seq, int head_dim,
    const long long* strides, float scale, unsigned seed_mix,
    unsigned threshold, int q_pad, int s_pad, float inv_keep, int dtype,
    int device, void* stream) {
  if (q_pad < seq || s_pad < seq || !(inv_keep >= 1.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cxr::Dropout drop{seed_mix, threshold, static_cast<uint32_t>(q_pad),
                          static_cast<uint32_t>(s_pad), 1.f / inv_keep,
                          inv_keep, nullptr};
  return cxr::bwd::launch_bwd<true, true>(
      q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads, seq, head_dim,
      strides, scale, dtype, device, stream, drop,
      static_cast<const int*>(seg));
}
