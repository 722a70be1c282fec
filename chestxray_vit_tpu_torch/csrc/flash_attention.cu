// Training attention forward: O = softmax(Q K^T * scale) V plus the
// natural-log logsumexp per query row, lse = m * scale + ln l, which the
// backward (flash_attention_bwd.cu) recomputes P from.
//
// Replaces the TPU kernel chestxray_vit_tpu/ops/flash_attention.py
// `_fwd_kernel` (launched by `_fwd`). That kernel holds the whole padded
// K/V row of a batch-of-heads in VMEM, runs an exact three-pass softmax and
// writes lse into a [BH, Q_pad, 1] buffer. Here the forward of
// attention_fwd.cuh streams 64-key tiles with an online softmax in log2
// units and converts at the end (m_log2 * ln 2 + ln l); lse is written as
// [B * H, S] f32, rows past S never touched, and q, k, v and o are read and
// written in place through their strides, so the training path needs no
// padded copies either. On an H100 (see attention_fwd.cuh) it is bound by
// each block's serial chain of barrier, S product, softmax and PV product,
// which four blocks an SM overlap: the tensor cores run at about 24 % of
// their peak, the exp2 unit at about 22 %; the lse costs 4 bytes a row.

#include "attention_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; lse is a
// contiguous f32 [batch * heads, seq] buffer.
extern "C" int cxr_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int batch,
    int heads, int seq, int head_dim, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int dtype, int device,
    void* stream) {
  return cxr::launch_attn_fwd<true>(
      q, k, v, o, static_cast<float*>(lse), batch, heads, seq, head_dim,
      {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
      {o_sb, o_sh, o_ss}, scale, dtype, device, stream);
}
