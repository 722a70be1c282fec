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
// The dropout entry point is compiled in flash_attention_bwd_dropout.cu, so
// that the two build at once.

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
