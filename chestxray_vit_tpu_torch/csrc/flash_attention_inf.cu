// Forward-only attention for eval/serving: O = softmax(Q K^T * scale) V.
//
// Replaces the TPU kernel chestxray_vit_tpu/ops/flash_attention.py
// `_fwd_kernel_inf` (launched by `flash_attention_inference`). That kernel
// holds a whole zero-padded K/V row of one batch-of-heads in VMEM and runs a
// three-pass exact softmax over the full [Q_pad, S_pad] score tile. Here the
// shared forward of attention_fwd.cuh runs without the logsumexp write,
// which eval and serving never read: 64 query rows a block, an online
// softmax over 64-key tiles that arrive by cp.async in a two-stage ring of
// swizzled tiles, S = Q K^T and O += P V as wgmma (bf16) with V read as it
// lies. What bounds it is the training forward's bound (flash_attention.cu);
// at the serving batch of 8 (960 blocks, under two waves of four blocks an
// SM) the tail of the last wave weighs more.

#include "attention_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the wrapper
// checks the head dim (a multiple of 8 from 8 to 128), a contiguous head
// dim and 16-byte alignment.
extern "C" int cxr_attention_fwd_inf(
    const void* q, const void* k, const void* v, void* o, int batch, int heads,
    int seq, int head_dim, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, float scale, int dtype, int device, void* stream) {
  return cxr::launch_attn_fwd<false>(
      q, k, v, o, nullptr, batch, heads, seq, head_dim, {q_sb, q_sh, q_ss},
      {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}, scale, dtype,
      device, stream);
}
