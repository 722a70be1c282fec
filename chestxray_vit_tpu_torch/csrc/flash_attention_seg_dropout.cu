// The segment-masked training attention forward with attention-probability
// dropout (see flash_attention_seg.cu, which holds the form without
// dropout): replaces the TPU kernel chestxray_vit_tpu/ops/flash_attention.py
// `_fwd_kernel_seg_drop`. attention_fwd.cuh with kSegment and kDropout;
// compiled in a unit of its own, beside the segment forward's, so that
// nvcc builds the two at once.

#include "attention_fwd.cuh"

// The dropout forward: seed_mix, threshold, q_pad, s_pad, bh_base,
// heads_total and head_base define the mask (see cxr::Dropout); keep_prob is
// 1 - rate.
extern "C" int cxr_attention_fwd_seg_dropout(
    const void* q, const void* k, const void* v, const void* seg, void* o,
    void* lse, int batch, int heads, int seq, int head_dim, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    unsigned seed_mix, unsigned threshold, int q_pad, int s_pad,
    unsigned bh_base, int heads_total, int head_base, float keep_prob,
    int dtype, int device, void* stream) {
  if (q_pad < seq || s_pad < seq || !(keep_prob > 0.f) ||
      !cxr::dropout_heads_ok(heads, heads_total, head_base))
    return static_cast<int>(cudaErrorInvalidValue);
  const cxr::Dropout drop{seed_mix, threshold, static_cast<uint32_t>(q_pad),
                          static_cast<uint32_t>(s_pad), bh_base,
                          static_cast<uint32_t>(heads_total),
                          static_cast<uint32_t>(head_base), keep_prob,
                          1.f / keep_prob, nullptr};
  const cxr::Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  return cxr::launch_attn_fwd<true, true, false, true>(
      q, k, v, o, static_cast<float*>(lse), batch, heads, seq, head_dim, qs,
      ks, vs, os, scale, dtype, device, stream, drop,
      static_cast<const int*>(seg));
}
