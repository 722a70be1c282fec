// Segment-masked (block-diagonal) training attention forward for packed
// sequences, with and without attention-probability dropout: token i
// attends token j iff their segment ids are equal, so several images share
// one sequence without seeing each other; pad slots carry id -1 and attend
// each other.
//
// Replaces the TPU kernels chestxray_vit_tpu/ops/flash_attention.py
// `_fwd_kernel_seg` and `_fwd_kernel_seg_drop` (both `_fwd_seg_impl`,
// launched by `_fwd_seg`). Those hold a whole padded K/V row in VMEM, add a
// -1e6 bias to every cross-segment score and take an exact softmax over the
// row, whose max always includes the row's own score. Here the training
// forward of attention_fwd.cuh runs with kSegment: the 64-key online
// softmax with cross-segment scores masked to -inf in registers. A key tile
// may hold no key of a row's segment (rows of a later image meet the
// earlier image's tiles first), so the running max may still be -inf after
// a tile and the rescale guards that case. The ids are int32 [B, S], read
// in place once for all heads (the TPU wrapper repeats them per head and
// pads them to its block); nothing assumes them sorted or contiguous: after
// a token merge they interleave. A key tile none of whose ids lies within
// the range of the block's 64 row ids is never visited: every warp scans
// the ids of 32 tiles at a time into the same bit mask (TileWalk) before
// the tile's copies are issued, and a visited tile's ids ride in its ring
// stage.
//
// What bounds it on an H100: the dense forward's chain of barrier, S
// product, softmax and PV product, over only the tiles that hold a
// same-segment pair, with the id compare in the softmax; with kDropout the
// counter hash on the CUDA cores in it. The dropout counter is
// (bh * s_pad + i) * s_pad + j with s_pad the sequence padded to the TPU
// wrapper's Q block (q_pad = s_pad, unlike the dense kernels' strides). The normalizer sums the clean
// P, the output is divided by l * (1 - rate), lse is the clean softmax's.

#include "attention_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; seg is a
// contiguous int32 [batch, seq] buffer; lse a contiguous f32
// [batch * heads, seq] buffer.
extern "C" int cxr_attention_fwd_seg(
    const void* q, const void* k, const void* v, const void* seg, void* o,
    void* lse, int batch, int heads, int seq, int head_dim, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale, int dtype,
    int device, void* stream) {
  const cxr::Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  return cxr::launch_attn_fwd<true, false, false, true>(
      q, k, v, o, static_cast<float*>(lse), batch, heads, seq, head_dim, qs,
      ks, vs, os, scale, dtype, device, stream, cxr::Dropout{},
      static_cast<const int*>(seg));
}

// The dropout forward: seed_mix, threshold, q_pad and s_pad define the mask
// (see cxr::Dropout); keep_prob is 1 - rate.
extern "C" int cxr_attention_fwd_seg_dropout(
    const void* q, const void* k, const void* v, const void* seg, void* o,
    void* lse, int batch, int heads, int seq, int head_dim, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    unsigned seed_mix, unsigned threshold, int q_pad, int s_pad,
    float keep_prob, int dtype, int device, void* stream) {
  if (q_pad < seq || s_pad < seq || !(keep_prob > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cxr::Dropout drop{seed_mix, threshold, static_cast<uint32_t>(q_pad),
                          static_cast<uint32_t>(s_pad), keep_prob,
                          1.f / keep_prob, nullptr};
  const cxr::Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  return cxr::launch_attn_fwd<true, true, false, true>(
      q, k, v, o, static_cast<float*>(lse), batch, heads, seq, head_dim, qs,
      ks, vs, os, scale, dtype, device, stream, drop,
      static_cast<const int*>(seg));
}
