// Training attention forward with attention-probability dropout (HF
// ViTSelfAttention semantics: dropout after the softmax), and its debug
// variant that also writes the mask it applied.
//
// Replaces the TPU kernels chestxray_vit_tpu/ops/flash_attention.py
// `_fwd_kernel_drop` and `_fwd_kernel_drop_debug` (both `_fwd_drop_impl`,
// launched by `_fwd_drop`). Those hold a padded K/V row in VMEM, hash a
// [bb, bq, S_pad] iota tile into the keep mask and select P with it. Here
// the training forward of attention_fwd.cuh runs with kDropout: each thread
// hashes the global (bh, row, col) of every score element it holds in its
// wgmma accumulator (about ten integer operations per element, in
// registers), so the mask never reaches device memory and the backward
// regenerates it from the same scalars. The normalizer l sums the clean P,
// the PV product takes the kept P, and the output is divided by
// l * (1 - rate); lse is the clean softmax's, as the TPU kernel writes it.
// kEmitKeep (the debug variant) also writes each valid element's keep bit
// as one byte of a [B * H, S, S] buffer, the oracle the tests hold the
// mask against. What bounds it is the training forward's chain with the hash
// on the CUDA cores in it; the debug variant's byte-wise mask writes
// ([B * H, S, S], scattered one byte a thread) take most of its time. The
// debug variant is compiled in flash_attention_dropout_debug.cu, so that
// the two build at once.

#include "attention_fwd.cuh"

namespace cxr {
// flash_attention_dropout_debug.cu: launch_attn_fwd with kEmitKeep
int launch_attn_fwd_keep(const void* q, const void* k, const void* v,
                         void* o, float* lse, int batch, int heads, int seq,
                         int head_dim, Strides qs, Strides ks, Strides vs,
                         Strides os, float scale, int dtype, int device,
                         void* stream, Dropout drop);
}  // namespace cxr

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; lse is a
// contiguous f32 [batch * heads, seq] buffer; keep is a u8
// [batch * heads, seq, seq] buffer or null (no mask written). seed_mix,
// threshold, q_pad, s_pad, bh_base, heads_total and head_base define the
// mask (see cxr::Dropout); keep_prob is 1 - rate.
extern "C" int cxr_attention_fwd_dropout(
    const void* q, const void* k, const void* v, void* o, void* lse,
    void* keep, int batch, int heads, int seq, int head_dim, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale,
    unsigned seed_mix, unsigned threshold, int q_pad, int s_pad,
    unsigned bh_base, int heads_total, int head_base, float keep_prob,
    int dtype, int device, void* stream) {
  if (q_pad < seq || s_pad < seq || !(keep_prob > 0.f) ||
      !cxr::dropout_heads_ok(heads, heads_total, head_base))
    return static_cast<int>(cudaErrorInvalidValue);
  cxr::Dropout drop{seed_mix, threshold, static_cast<uint32_t>(q_pad),
                    static_cast<uint32_t>(s_pad), bh_base,
                    static_cast<uint32_t>(heads_total),
                    static_cast<uint32_t>(head_base), keep_prob,
                    1.f / keep_prob, static_cast<unsigned char*>(keep)};
  const cxr::Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  float* l = static_cast<float*>(lse);
  if (keep != nullptr)
    return cxr::launch_attn_fwd_keep(q, k, v, o, l, batch, heads, seq,
                                     head_dim, qs, ks, vs, os, scale, dtype,
                                     device, stream, drop);
  return cxr::launch_attn_fwd<true, true, false>(
      q, k, v, o, l, batch, heads, seq, head_dim, qs, ks, vs, os, scale, dtype,
      device, stream, drop);
}
