// The dense attention backward with attention-probability dropout (see
// flash_attention_bwd.cu, which holds the form without dropout): replaces
// the TPU kernel chestxray_vit_tpu/ops/flash_attention.py
// `_bwd_kernel_drop` (launched by `_bwd_drop`). attention_bwd.cuh with
// kDropout; compiled in a unit of its own, beside the dense backward's, so
// that nvcc builds the two at once.

#include "attention_bwd.cuh"

// The dropout backward: the arguments of cxr_attention_bwd plus the mask's
// scalars (see cxr::Dropout) and 1 / (1 - rate).
extern "C" int cxr_attention_bwd_dropout(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int heads, int seq, int head_dim,
    const long long* strides, float scale, unsigned seed_mix,
    unsigned threshold, int q_pad, int s_pad, unsigned bh_base,
    int heads_total, int head_base, float inv_keep, int dtype, int device,
    void* stream) {
  if (q_pad < seq || s_pad < seq || !(inv_keep >= 1.f) ||
      !cxr::dropout_heads_ok(heads, heads_total, head_base))
    return static_cast<int>(cudaErrorInvalidValue);
  const cxr::Dropout drop{seed_mix, threshold, static_cast<uint32_t>(q_pad),
                          static_cast<uint32_t>(s_pad), bh_base,
                          static_cast<uint32_t>(heads_total),
                          static_cast<uint32_t>(head_base), 1.f / inv_keep,
                          inv_keep, nullptr};
  return cxr::bwd::launch_bwd<true>(
      q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads, seq, head_dim,
      strides, scale, dtype, device, stream, drop);
}
