// Attention backward entry points of the dense training path, with and
// without attention-probability dropout; the kernels are in
// attention_bwd.cuh.
//
// Replaces the TPU kernels chestxray_vit_tpu/ops/flash_attention.py
// `_bwd_kernel` (launched by `_bwd`; entry point cxr_attention_bwd) and
// `_bwd_kernel_drop` (launched by `_bwd_drop`; entry point
// cxr_attention_bwd_dropout, the same kernels with kDropout). What bounds
// them on an H100 is tensor-core throughput; attention_bwd.cuh says how the
// bf16 passes feed the tensor cores (cp.async ring, swizzled tiles, wgmma).

#include "attention_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. See launch_bwd for the operands.
extern "C" int cxr_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int batch, int heads,
                                 int seq, int head_dim,
                                 const long long* strides, float scale,
                                 int dtype, int device, void* stream) {
  return cxr::bwd::launch_bwd<false>(
      q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads, seq, head_dim,
      strides, scale, dtype, device, stream, cxr::Dropout{});
}

// The dropout backward: the arguments of cxr_attention_bwd plus the mask's
// scalars (see cxr::Dropout) and 1 / (1 - rate).
extern "C" int cxr_attention_bwd_dropout(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int heads, int seq, int head_dim,
    const long long* strides, float scale, unsigned seed_mix,
    unsigned threshold, int q_pad, int s_pad, float inv_keep, int dtype,
    int device, void* stream) {
  if (q_pad < seq || s_pad < seq || !(inv_keep >= 1.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cxr::Dropout drop{seed_mix, threshold, static_cast<uint32_t>(q_pad),
                          static_cast<uint32_t>(s_pad), 1.f / inv_keep,
                          inv_keep, nullptr};
  return cxr::bwd::launch_bwd<true>(
      q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads, seq, head_dim,
      strides, scale, dtype, device, stream, drop);
}
