// The debug variant of the dropout training forward
// (flash_attention_dropout.cu, cxr_attention_fwd_dropout with a keep
// buffer): attention_fwd.cuh with kEmitKeep, which also writes each valid
// element's keep bit as one byte of a [B * H, S, S] buffer. It replaces the
// TPU kernel chestxray_vit_tpu/ops/flash_attention.py
// `_fwd_kernel_drop_debug` and is the oracle the tests hold the mask
// against. Compiled in a unit of its own, beside the dropout forward's, so
// that nvcc builds the two at once.

#include "attention_fwd.cuh"

namespace cxr {

int launch_attn_fwd_keep(const void* q, const void* k, const void* v,
                         void* o, float* lse, int batch, int heads, int seq,
                         int head_dim, Strides qs, Strides ks, Strides vs,
                         Strides os, float scale, int dtype, int device,
                         void* stream, Dropout drop) {
  return launch_attn_fwd<true, true, true>(q, k, v, o, lse, batch, heads,
                                           seq, head_dim, qs, ks, vs, os,
                                           scale, dtype, device, stream, drop);
}

}  // namespace cxr
