"""Multi-head attention: softmax(QKᵀ·d^-½)·V, for serving and training.

- ``attention_reference``: plain PyTorch, the math of the JAX package's
  ``attention_xla`` (f32 scores and softmax, probabilities cast to v's
  dtype, f32-accumulated PV). The CPU path and the forward kernels' oracle.
- ``attention_fwd_reference`` / ``attention_bwd_reference``: the plain
  forward-with-logsumexp and backward, the math of the TPU kernels
  ``_fwd_kernel`` and ``_bwd_kernel``; the training kernels' oracles.
- ``flash_attention_inference``: the forward-only CUDA kernel
  (``csrc/flash_attention_inf.cu``, the port of ``_fwd_kernel_inf``).
- ``flash_attention_fwd`` / ``flash_attention_bwd``: the training kernels
  (``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``, the
  ports of ``_fwd_kernel`` and ``_bwd_kernel``), joined by the autograd
  function ``FlashAttention``, which saves q, k, v, o and lse as the JAX
  custom VJP does (``flash_residual`` and ``flash_out``). Its forward
  runs as the registered op ``cxr::attention_fwd`` (the dropout one as
  ``cxr::attention_dropout_fwd``; ``ATTENTION_FWD_OPS``), so a selective
  checkpoint sees the launch and can keep o and lse instead of launching
  again in the recompute (the ``flash_out`` remat policy).
- ``keep_mask``, ``attention_dropout_{fwd,bwd}_reference``: the dropout
  mask (the counter hash of ``_keep_mask`` / ``_fmix32``) and the plain
  math of ``_fwd_drop_impl`` and ``_bwd_kernel_drop``. Every dropout
  function takes ``row_base``, the global batch row of its first row (0
  in one process), and ``head_base`` / ``heads_total``, the first of its
  heads in the model and the model's head count (a whole-head call by
  default): the mask of a data-parallel rank's rows and of a
  tensor-parallel rank's heads is then the slice of the global batch's
  mask, as the JAX step's one jitted function over the global batch draws
  it.
- ``flash_attention_dropout_{fwd,bwd,debug}``: the dropout kernels
  (``csrc/flash_attention_dropout.cu``, ``flash_attention_dropout_debug.cu``
  and ``flash_attention_bwd_dropout.cu``, the ports of ``_fwd_kernel_drop``, ``_fwd_kernel_drop_debug`` and
  ``_bwd_kernel_drop``), joined by ``FlashAttentionDropout``;
  ``flash_attention_dropout`` has the JAX function's signature.
- ``attention_packed_reference``, ``attention_packed_{fwd,bwd}_reference``,
  ``attention_packed_dropout_{fwd,bwd}_reference``: block-diagonal
  attention over segment ids (packed sequences), the math of
  ``attention_xla_packed``, ``_fwd_seg_impl`` and ``_bwd_seg_impl``.
- ``flash_attention_packed_{fwd,bwd}``, ``flash_attention_packed_dropout_
  {fwd,bwd}``: the segment kernels (``csrc/flash_attention_seg.cu``,
  ``flash_attention_seg_bwd.cu`` and their ``_dropout`` forms, the ports
  of ``_fwd_kernel_seg``,
  ``_bwd_kernel_seg``, ``_fwd_kernel_seg_drop`` and
  ``_bwd_kernel_seg_drop``), joined by ``FlashAttentionPacked`` and
  ``FlashAttentionPackedDropout``; ``flash_attention_packed`` and
  ``flash_attention_packed_dropout`` have the JAX functions' signatures,
  ``attention_packed`` is the dispatch of the reference's ``_packed_mha``.
- ``attention``: the dispatch of ``chestxray_vit_tpu.ops.flash_attention
  .attention``; ``attention_dropout``: the dropout branch of the reference
  ViT's ``_mha``.

Each kernel wrapper runs its plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors. The dense training paths run the
autograd functions on both devices, so the CPU keeps what the card keeps
(q, k, v, o and lse) and the remat policies act alike on both.

Head dims: any d ≥ 1, as the JAX kernels take any. A multiple of 8 up to
128 runs the one-block kernels at a padded width of 64, 80 or 128; above
128 the wide kernels (``csrc/attention_fwd_wide.cuh``,
``attention_bwd_wide.cuh``) split the output columns; any other d is
zero-padded to a multiple of 8 (:func:`kernel_head_dim`, :func:`_padded`)
and the outputs sliced back, the scale the real d's.

The TPU wrapper's tiling (``_pick_block_bh``, ``_vmem_block_bh``,
``_q_blocking``, ``_prep`` and the 16/128-row padding) has no counterpart:
the kernels read q, k, v, o and dO in place through their strides and mask
the ragged tail themselves.

The bf16 kernels round P to bf16 after the exp2, where the TPU kernels
round the exp2 argument (``flash_attention.py:332-334``); the plain
versions here round P at the same point as the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from chestxray_vit_tpu_torch import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM_STEP = 8   # the kernels take d a multiple of 8 (16-byte rows)


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim ``d`` at: ``d`` rounded up
    to a multiple of :data:`HEAD_DIM_STEP` (``csrc/common.cuh``
    ``head_dim_ok``). Up to 128 a kernel is built at a padded width of 64,
    80 or 128 with the columns past d zeros in shared memory only; above
    128 the wide kernels (``csrc/attention_fwd_wide.cuh``,
    ``attention_bwd_wide.cuh``) split the output columns. Any other d is
    zero-padded by the wrappers (:func:`_padded`)."""
    if d < 1:
        raise ValueError(f"head dim must be >= 1, got {d}")
    return -(-d // HEAD_DIM_STEP) * HEAD_DIM_STEP


def _padded(d: int, *ts: torch.Tensor) -> tuple:
    """``ts`` with the head dim zero-padded from ``d`` to
    :func:`kernel_head_dim` (a tensor of that width already is returned as
    it is). Exact: zero columns add nothing to QKᵀ, to rowsum(dO∘O) or to
    any product, give zero output columns, and the callers pass the scale
    of the real d. The cost is one copy of each operand at the padded
    width (q, k, v; with o and dO in the backward) and the outputs sliced
    back, only for d off the multiple of 8."""
    dk = kernel_head_dim(d)
    return tuple(t if t.shape[-1] == dk
                 else torch.nn.functional.pad(t, (0, dk - t.shape[-1]))
                 for t in ts)


def _sliced(t: torch.Tensor, d: int) -> torch.Tensor:
    """A kernel's output at head dim ``d``: itself, or the first d columns
    of its zero-padded width."""
    return t if t.shape[-1] == d else t[..., :d]


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention on [B, H, S, d] with f32 scores and softmax; output
    in q's dtype. Upcasting bf16 operands before the products gives the
    f32-accumulated product that ``preferred_element_type=f32`` asks for
    in the JAX reference."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward with the natural-log logsumexp: (o in q's dtype,
    lse f32 [B, H, S] = log Σ_k exp(s·scale), i.e. m·scale + ln l)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(
        q, sm_scale)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain backward from the forward's o and lse (the math of
    ``_bwd_kernel``): P recomputed from lse and rounded to q's dtype,
    dV = Pᵀ·dO, dP = dO·Vᵀ, Δ = rowsum(dO∘O) in f32, dS = P∘(dP − Δ)
    rounded to q's dtype, dQ = dS·K·scale, dK = dSᵀ·Q·scale. Returns
    (dq, dk, dv) in q's dtype."""
    scale = _scale(q, sm_scale)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.to(q.dtype).float()
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp(s * scale - lse.float()[..., None]).to(q.dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _heads_merged(q: torch.Tensor) -> torch.Tensor:
    """An empty [B, H, S, d] view of a [B, S, H, d] buffer: merging the
    heads (or reading the projections' gradient) is then a view."""
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_inference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Forward-only fused attention for eval/serving (no lse output).

    q, k, v: [B, H, S, d] in f32 or bf16 (any d ≥ 1; d off a multiple of
    8 is zero-padded, :func:`_padded`), any strides with a contiguous head
    dim (the projections' [B, S, H, d] views are read in place). CPU
    tensors take :func:`attention_reference`. The output is [B, H, S, d]
    in q's dtype, laid out as [B, S, H, d] in memory so that merging the
    heads for the output projection is a view (at a padded d, a slice of
    the padded output).
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, sm_scale)
    d, scale = q.shape[-1], _scale(q, sm_scale)
    q, k, v = _padded(d, q, k, v)
    _check(q, k, v)
    b, h, s, dk = q.shape
    out = _heads_merged(q)
    err = kernels.library().cxr_attention_fwd_inf(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s,
        dk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], scale, _DTYPE_CODES[q.dtype], q.device.index,
        _stream(q))
    kernels.check(err, "flash_attention_inference")
    flash_attention_inference.launches += 1
    return _sliced(out, d)


flash_attention_inference.launches = 0   # kernel launches (chip_smoke.py)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (o, lse f32 [B, H, S]). CPU tensors take
    :func:`attention_fwd_reference`; CUDA tensors launch the kernel, which
    takes what :func:`flash_attention_inference` takes. o is laid out as
    [B, S, H, d] in memory."""
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v, sm_scale)
    d, scale = q.shape[-1], _scale(q, sm_scale)
    q, k, v = _padded(d, q, k, v)
    _check(q, k, v)
    b, h, s, dk = q.shape
    out = _heads_merged(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = kernels.library().cxr_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, s, dk, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], scale,
        _DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    kernels.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return _sliced(out, d), lse


flash_attention_fwd.launches = 0         # kernel launches (chip_smoke.py)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training backward: (dq, dk, dv) in q's dtype. CPU tensors take
    :func:`attention_bwd_reference`; CUDA tensors launch the kernel, and
    the gradients come back as [B, H, S, d] views of [B, S, H, d] buffers,
    the layout the projections' backward reads without a copy."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do, sm_scale)
    grads = _bwd_launch(q, k, v, o, lse, do, sm_scale)
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0         # kernel launches (chip_smoke.py)


def _bwd_launch(q, k, v, o, lse, do, sm_scale, dropout=None,
                segment_ids=None):
    """Launch the backward kernels; ``dropout`` = (seed_mix, threshold,
    q_pad, s_pad, bh_base, heads_total, head_base, 1/(1 − rate)) takes the
    dropout entry point,
    ``segment_ids`` (int32 [B, S], checked by the caller) the segment
    ones. A head dim off the multiple of 8 is zero-padded (q, k, v, o, dO)
    and the gradients sliced back."""
    do = do.to(q.dtype)
    if not _fits(do):
        do = do.contiguous()
    d, scale = q.shape[-1], _scale(q, sm_scale)
    q, k, v, o, do = _padded(d, q, k, v, o, do)
    _check(q, k, v, o=o, do=do)
    b, h, s, width = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 [{b}, {h}, {s}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = _heads_merged(q), _heads_merged(q), _heads_merged(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = [st for t in (q, k, v, o, do, dq, dk, dv)
               for st in t.stride()[:3]]
    strides_c = (ctypes.c_longlong * len(strides))(*strides)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, s, width,
            ctypes.addressof(strides_c), scale)
    tail = (_DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    lib = kernels.library()
    if segment_ids is not None:
        args = (segment_ids.data_ptr(), *args)
        fn, fn_drop = (lib.cxr_attention_bwd_seg,
                       lib.cxr_attention_bwd_seg_dropout)
    else:
        fn, fn_drop = lib.cxr_attention_bwd, lib.cxr_attention_bwd_dropout
    if dropout is None:
        err = fn(*args, *tail)
    else:
        err = fn_drop(*args, *dropout, *tail)
    kernels.check(err, "flash_attention_bwd")
    return _sliced(dq, d), _sliced(dk, d), _sliced(dv, d)


@torch.library.custom_op("cxr::attention_fwd", mutates_args=())
def _attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: Optional[float]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd` as a registered op."""
    return flash_attention_fwd(q, k, v, sm_scale)


class FlashAttention(torch.autograd.Function):
    """Attention with the training kernels in both directions (their plain
    versions for CPU tensors). Saves q, k, v, o and lse, the residuals of
    the JAX custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale=None):
        o, lse = _attention_fwd_op(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.sm_scale)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# Attention-probability dropout (HF ViTSelfAttention semantics)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
DEFAULT_BLOCK_Q = 128       # the TPU wrapper's default Q block


def _pad_len(s: int, block: int) -> int:
    return ((s + block - 1) // block) * block


def auto_block_q(seq_len: int) -> int:
    """The JAX package's Q-block pick (``auto_block_q``): the whole padded
    sequence up to 1024 rows, else 384-row blocks when they tile, else
    128. Here it fixes only the mask's logical row stride."""
    s_pad = _pad_len(seq_len, DEFAULT_BLOCK_Q)
    if s_pad <= 1024:
        return s_pad
    if s_pad % 384 == 0:
        return 384
    return DEFAULT_BLOCK_Q


def mask_strides(s: int, block_q: int) -> Tuple[int, int]:
    """(q_pad, s_pad), the padded strides of the TPU wrapper that the
    dropout counter is built from: Q rows padded to 16 when one block
    covers the sequence (``_q_blocking``), else to a multiple of
    ``block_q``; keys to a multiple of 128."""
    q_pad = _pad_len(s, 16) if block_q >= s else _pad_len(s, block_q)
    return q_pad, _pad_len(s, DEFAULT_BLOCK_Q)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x · c mod 2³² for int64 x in [0, 2³²): the constant split into
    16-bit halves, so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_constants(seed: int, rate: float) -> Tuple[int, int]:
    """(seed · 0x9E3779B9 mod 2³², threshold): the int32 seed read as
    uint32 and mixed as ``_keep_mask`` does; an element is kept when its
    hash is at least ``min(int(rate · 2³²), 2³² − 1)``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return (((int(seed) & _M32) * 0x9E3779B9) & _M32,
            min(int(rate * 2.0 ** 32), _M32))


def keep_mask(bh: int, q_pad: int, s_pad: int, seed: int, rate: float,
              device=None, bh_base: int = 0) -> torch.Tensor:
    """The dropout keep mask, bool [bh, q_pad, s_pad], of the JAX package's
    ``_keep_mask`` / ``_fmix32``: element (b, i, j) hashes the counter
    ((bh_base + b)·q_pad + i)·s_pad + j (uint32, wrapping) XOR the mixed
    seed and is kept when the hash reaches the threshold. ``bh_base`` is
    the global (batch · head) index of row 0, so the mask of rows
    [bh_base, bh_base + bh) of a global batch is that batch's mask sliced.
    Plain integer tensor code (uint32 arithmetic in int64), so it runs on
    the CPU and the card."""
    kw = {"dtype": torch.int64, "device": device}
    return _keep_rows((torch.arange(bh, **kw) + (bh_base & _M32)) & _M32,
                      q_pad, s_pad, seed, rate)


def _keep_rows(bh_ids: torch.Tensor, q_pad: int, s_pad: int, seed: int,
               rate: float) -> torch.Tensor:
    """:func:`keep_mask` of the global (batch · head) indices ``bh_ids``
    (int64 [n], each in [0, 2³²)): bool [n, q_pad, s_pad]."""
    seed_mix, threshold = dropout_constants(seed, rate)
    kw = {"dtype": torch.int64, "device": bh_ids.device}
    row = (bh_ids[:, None] * q_pad
           + torch.arange(q_pad, **kw)[None, :]) & _M32
    counter = (_mul32(row, s_pad)[:, :, None]
               + torch.arange(s_pad, **kw)) & _M32
    return _fmix32(counter ^ seed_mix) >= threshold


def _heads_total(q: torch.Tensor, head_base: int,
                 heads_total: Optional[int]) -> int:
    """The model's head count of a call on q's heads, the first of them
    head ``head_base`` (None: q holds every head); raises when q's heads do
    not lie within the model's."""
    h = q.shape[1]
    total = h if heads_total is None else int(heads_total)
    if head_base < 0 or head_base + h > total:
        raise ValueError(f"heads [{head_base}, {head_base + h}) of a "
                         f"{total}-head model")
    return total


def _bh_base(q: torch.Tensor, row_base: int,
             heads_total: Optional[int] = None) -> int:
    """The counter's uint32 (batch · head) base of batch row ``row_base``,
    head 0."""
    total = q.shape[1] if heads_total is None else int(heads_total)
    return (int(row_base) * total) & _M32


def _bh_ids(q: torch.Tensor, row_base: int, head_base: int,
            heads_total: Optional[int]) -> torch.Tensor:
    """The global (batch · head) index of each of q's B·H (batch, head)
    pairs, int64 [B·H] in uint32: (row_base + b)·heads_total + head_base +
    h, what the kernels' ``drop_row`` computes."""
    b, h = q.shape[:2]
    total = _heads_total(q, head_base, heads_total)
    kw = {"dtype": torch.int64, "device": q.device}
    rows = (torch.arange(b, **kw) + int(row_base)) * total + int(head_base)
    return ((rows[:, None] + torch.arange(h, **kw)[None, :])
            .reshape(-1)) & _M32


def _drop_heads(q: torch.Tensor, row_base: int, head_base: int,
                heads_total: Optional[int]) -> Tuple[int, int, int]:
    """(bh_base, heads_total, head_base): the kernels' head arguments."""
    total = _heads_total(q, head_base, heads_total)
    return _bh_base(q, row_base, total), total, int(head_base)


def _keep(q: torch.Tensor, seed: int, rate: float, block_q: int,
          row_base: int = 0, head_base: int = 0,
          heads_total: Optional[int] = None) -> torch.Tensor:
    """The [B, H, S, S] keep mask of attention over q's shape, its first
    batch row global row ``row_base`` and its first head the model's head
    ``head_base`` of ``heads_total`` (None: q holds every head)."""
    b, h, s, _ = q.shape
    q_pad, s_pad = mask_strides(s, block_q)
    return _keep_rows(_bh_ids(q, row_base, head_base, heads_total), q_pad,
                      s_pad, seed, rate)[:, :s, :s].reshape(b, h, s, s)


def attention_dropout_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, seed: int, rate: float,
                                    sm_scale: Optional[float] = None,
                                    block_q: int = DEFAULT_BLOCK_Q,
                                    row_base: int = 0, head_base: int = 0,
                                    heads_total: Optional[int] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward of ``_fwd_drop_impl``: the clean softmax P (its lse is
    returned as the dense forward's), kept probabilities scaled by
    1/(1 − rate), dropped ones zero: (o in q's dtype, lse f32 [B, H, S])."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(
        q, sm_scale)
    p = torch.softmax(s, dim=-1)
    p = torch.where(_keep(q, seed, rate, block_q, row_base, head_base,
                          heads_total), p, 0.0)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / (1.0 - rate)
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def attention_dropout_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, o: torch.Tensor,
                                    lse: torch.Tensor, do: torch.Tensor,
                                    seed: int, rate: float,
                                    sm_scale: Optional[float] = None,
                                    block_q: int = DEFAULT_BLOCK_Q,
                                    row_base: int = 0, head_base: int = 0,
                                    heads_total: Optional[int] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Plain backward of ``_bwd_kernel_drop``: P recomputed from lse and
    rounded to q's dtype, the same mask M regenerated, dV = (M∘P)ᵀ·dO/(1−r),
    dS = P∘(M∘dP/(1−r) − Δ) with the unchanged Δ = rowsum(dO∘O), rounded to
    q's dtype; dQ = dS·K·scale, dK = dSᵀ·Q·scale."""
    scale = _scale(q, sm_scale)
    inv = 1.0 / (1.0 - rate)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.to(q.dtype).float()
    keep = _keep(q, seed, rate, block_q, row_base, head_base, heads_total)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp(s * scale - lse.float()[..., None]).to(q.dtype).float()
    dv = torch.matmul(torch.where(keep, p, 0.0).transpose(-1, -2), dof) * inv
    dp = torch.where(keep, torch.matmul(dof, vf.transpose(-1, -2)) * inv, 0.0)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _dropout_fwd_launch(q, k, v, seed, rate, sm_scale, block_q, keep,
                        row_base, head_base=0, heads_total=None):
    """Launch the dropout forward kernel; ``keep`` (u8 [B·H, S, S]) makes it
    the debug variant that also writes the mask."""
    d, scale = q.shape[-1], _scale(q, sm_scale)
    q, k, v = _padded(d, q, k, v)
    _check(q, k, v)
    b, h, s, width = q.shape
    q_pad, s_pad = mask_strides(s, block_q)
    seed_mix, threshold = dropout_constants(seed, rate)
    out = _heads_merged(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = kernels.library().cxr_attention_fwd_dropout(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), keep.data_ptr() if keep is not None else None,
        b, h, s, width, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], scale, seed_mix, threshold, q_pad,
        s_pad, *_drop_heads(q, row_base, head_base, heads_total),
        1.0 - rate, _DTYPE_CODES[q.dtype],
        q.device.index, _stream(q))
    kernels.check(err, "flash_attention_dropout_fwd")
    return _sliced(out, d), lse


def flash_attention_dropout_fwd(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, seed: int, rate: float,
                                sm_scale: Optional[float] = None,
                                block_q: int = DEFAULT_BLOCK_Q,
                                row_base: int = 0, head_base: int = 0,
                                heads_total: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward with dropout: (o, lse f32 [B, H, S]). CPU tensors
    take :func:`attention_dropout_fwd_reference`; CUDA tensors launch the
    kernel (``csrc/flash_attention_dropout.cu``), which takes what
    :func:`flash_attention_fwd` takes and hashes the mask in registers."""
    if q.device.type == "cpu":
        return attention_dropout_fwd_reference(q, k, v, seed, rate,
                                               sm_scale, block_q, row_base,
                                               head_base, heads_total)
    out = _dropout_fwd_launch(q, k, v, seed, rate, sm_scale, block_q, None,
                              row_base, head_base, heads_total)
    flash_attention_dropout_fwd.launches += 1
    return out


flash_attention_dropout_fwd.launches = 0  # kernel launches (chip_smoke.py)


def flash_attention_dropout_debug(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, seed: int, rate: float,
                                  sm_scale: Optional[float] = None,
                                  block_q: int = DEFAULT_BLOCK_Q,
                                  row_base: int = 0, head_base: int = 0,
                                  heads_total: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, keep bool [B, H, S, S]): the dropout forward that also writes
    the mask it applied, the oracle of the mask as the JAX package's
    ``flash_attention_dropout_debug`` is. CPU tensors take the plain
    forward and :func:`keep_mask`."""
    if q.device.type == "cpu":
        o, _ = attention_dropout_fwd_reference(q, k, v, seed, rate,
                                               sm_scale, block_q, row_base,
                                               head_base, heads_total)
        return o, _keep(q, seed, rate, block_q, row_base, head_base,
                        heads_total)
    b, h, s, _ = q.shape
    keep = torch.empty((b, h, s, s), dtype=torch.bool, device=q.device)
    o, _ = _dropout_fwd_launch(q, k, v, seed, rate, sm_scale, block_q, keep,
                               row_base, head_base, heads_total)
    flash_attention_dropout_debug.launches += 1
    return o, keep


flash_attention_dropout_debug.launches = 0  # kernel launches


def flash_attention_dropout_bwd(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, o: torch.Tensor,
                                lse: torch.Tensor, do: torch.Tensor,
                                seed: int, rate: float,
                                sm_scale: Optional[float] = None,
                                block_q: int = DEFAULT_BLOCK_Q,
                                row_base: int = 0, head_base: int = 0,
                                heads_total: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Training backward with dropout: (dq, dk, dv) in q's dtype, laid
    out as :func:`flash_attention_bwd` lays them out. CPU tensors take
    :func:`attention_dropout_bwd_reference`; CUDA tensors launch the
    kernels of ``csrc/flash_attention_bwd_dropout.cu`` with the mask
    regenerated."""
    if q.device.type == "cpu":
        return attention_dropout_bwd_reference(q, k, v, o, lse, do, seed,
                                               rate, sm_scale, block_q,
                                               row_base, head_base,
                                               heads_total)
    s = q.shape[2]
    q_pad, s_pad = mask_strides(s, block_q)
    seed_mix, threshold = dropout_constants(seed, rate)
    grads = _bwd_launch(q, k, v, o, lse, do, sm_scale,
                        (seed_mix, threshold, q_pad, s_pad,
                         *_drop_heads(q, row_base, head_base, heads_total),
                         1.0 / (1.0 - rate)))
    flash_attention_dropout_bwd.launches += 1
    return grads


flash_attention_dropout_bwd.launches = 0  # kernel launches (chip_smoke.py)


@torch.library.custom_op("cxr::attention_dropout_fwd", mutates_args=())
def _attention_dropout_fwd_op(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, seed: int, rate: float,
                              sm_scale: Optional[float], block_q: int,
                              row_base: int, head_base: int,
                              heads_total: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_dropout_fwd` as a registered op."""
    return flash_attention_dropout_fwd(q, k, v, seed, rate, sm_scale,
                                       block_q, row_base, head_base,
                                       heads_total)


# The registered forwards whose outputs (o and lse) the JAX package names
# ``flash_out``.
ATTENTION_FWD_OPS = (torch.ops.cxr.attention_fwd.default,
                     torch.ops.cxr.attention_dropout_fwd.default)


class FlashAttentionDropout(torch.autograd.Function):
    """Attention with dropout through the dropout kernels in both
    directions (their plain versions for CPU tensors). Saves q, k, v, o
    and lse, as :class:`FlashAttention`, and the seed, the row base and
    the head fields as Python ints: the backward regenerates the mask, so
    no mask is stored and a recompute under remat replays it."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate, sm_scale=None,
                block_q=DEFAULT_BLOCK_Q, row_base=0, head_base=0,
                heads_total=None):
        total = _heads_total(q, head_base, heads_total)
        o, lse = _attention_dropout_fwd_op(q, k, v, int(seed), rate,
                                           sm_scale, block_q, int(row_base),
                                           int(head_base), total)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.seed, ctx.rate, ctx.row_base = int(seed), rate, int(row_base)
        ctx.heads = (int(head_base), total)
        ctx.sm_scale, ctx.block_q = sm_scale, block_q
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_dropout_bwd(
            q, k, v, o, lse, do, ctx.seed, ctx.rate, ctx.sm_scale,
            ctx.block_q, ctx.row_base, *ctx.heads)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_dropout(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, seed: int, rate: float,
                            sm_scale: Optional[float] = None,
                            block_q: int = DEFAULT_BLOCK_Q,
                            row_base: int = 0, head_base: int = 0,
                            heads_total: Optional[int] = None
                            ) -> torch.Tensor:
    """Attention with in-kernel probability dropout, the signature of the
    JAX package's ``flash_attention_dropout`` (``seed`` an int32 value,
    ``block_q`` fixing only the mask's logical row stride), ``row_base``,
    the global batch row of q's first row, and ``head_base`` /
    ``heads_total``, where q's heads lie in the model's: the autograd
    function over the kernels for CUDA tensors, over their plain versions
    for CPU tensors. The same seed gives the same mask as the JAX
    function over the global batch, bit for bit."""
    return FlashAttentionDropout.apply(q, k, v, seed, rate, sm_scale,
                                       block_q, row_base, head_base,
                                       heads_total)


# ---------------------------------------------------------------------------
# Segment-masked (block-diagonal) attention for packed sequences
# ---------------------------------------------------------------------------

def packed_block_q(seq_len: int) -> int:
    """The Q block of the reference's ``_packed_mha``: 384 rows when they
    tile the sequence padded to 128, else 128. Here it fixes only the
    dropout mask's strides."""
    return 384 if _pad_len(seq_len, 128) % 384 == 0 else DEFAULT_BLOCK_Q


def packed_mask_strides(s: int, block_q: int) -> Tuple[int, int]:
    """(q_pad, s_pad) of the segment kernels' dropout counter: the TPU
    wrapper pads queries and keys alike to a multiple of ``block_q``
    (``_flash_packed_drop_fwd_rule``), so the counter of element
    (bh, i, j) is (bh·s_pad + i)·s_pad + j. Not the dense rule of
    :func:`mask_strides`."""
    s_pad = _pad_len(s, block_q)
    return s_pad, s_pad


def _same_segment(segment_ids: torch.Tensor) -> torch.Tensor:
    """bool [B, 1, S, S]: token i attends token j iff their ids are equal
    (pad slots, id −1, attend each other)."""
    return segment_ids[:, None, :, None] == segment_ids[:, None, None, :]


def _packed_keep(q: torch.Tensor, seed: int, rate: float, block_q: int,
                 row_base: int = 0, head_base: int = 0,
                 heads_total: Optional[int] = None) -> torch.Tensor:
    """The [B, H, S, S] keep mask of the segment dropout kernels, the first
    sequence global sequence ``row_base``, the first head the model's head
    ``head_base`` of ``heads_total``."""
    b, h, s, _ = q.shape
    q_pad, s_pad = packed_mask_strides(s, block_q)
    return _keep_rows(_bh_ids(q, row_base, head_base, heads_total), q_pad,
                      s_pad, seed, rate)[:, :s, :s].reshape(b, h, s, s)


def attention_packed_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, segment_ids: torch.Tensor,
                               sm_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Plain block-diagonal attention, the math of the JAX package's
    ``attention_xla_packed``: q, k, v [B, H, S, d], ``segment_ids`` int
    [B, S]; cross-segment scores are masked before an f32 softmax,
    probabilities are cast to v's dtype. The CPU path and the segment
    kernels' oracle."""
    return attention_packed_fwd_reference(q, k, v, segment_ids, sm_scale)[0]


def _packed_fwd_plain(q, k, v, segment_ids, sm_scale, keep, rate):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(
        q, sm_scale)
    s = s.masked_fill(~_same_segment(segment_ids), float("-inf"))
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / (1.0 - rate)
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def _packed_bwd_plain(q, k, v, segment_ids, o, lse, do, sm_scale, keep,
                      rate):
    scale = _scale(q, sm_scale)
    inv = 1.0 / (1.0 - rate)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.to(q.dtype).float()
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp(s * scale - lse.float()[..., None])
    p = torch.where(_same_segment(segment_ids), p, 0.0).to(q.dtype).float()
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    p_drop = p
    if keep is not None:
        p_drop = torch.where(keep, p, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = torch.matmul(p_drop.transpose(-1, -2), dof) * inv
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def attention_packed_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor,
                                   segment_ids: torch.Tensor,
                                   sm_scale: Optional[float] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward of ``_fwd_kernel_seg``: (o in q's dtype, lse f32
    [B, H, S], the logsumexp over the row's own segment)."""
    return _packed_fwd_plain(q, k, v, segment_ids, sm_scale, None, 0.0)


def attention_packed_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor,
                                   segment_ids: torch.Tensor,
                                   o: torch.Tensor, lse: torch.Tensor,
                                   do: torch.Tensor,
                                   sm_scale: Optional[float] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain backward of ``_bwd_kernel_seg``: :func:`attention_bwd_reference`
    with P recomputed from lse under the segment mask (cross-segment P is
    exactly 0), rounded to q's dtype where the kernels round it."""
    return _packed_bwd_plain(q, k, v, segment_ids, o, lse, do, sm_scale,
                             None, 0.0)


def attention_packed_dropout_fwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        segment_ids: torch.Tensor, seed: int, rate: float,
        sm_scale: Optional[float] = None, block_q: int = DEFAULT_BLOCK_Q,
        row_base: int = 0, head_base: int = 0,
        heads_total: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward of ``_fwd_kernel_seg_drop``: the clean segment softmax
    (its lse is returned), kept probabilities scaled by 1/(1 − rate), the
    mask of :func:`keep_mask` on :func:`packed_mask_strides`."""
    return _packed_fwd_plain(q, k, v, segment_ids, sm_scale,
                             _packed_keep(q, seed, rate, block_q, row_base,
                                          head_base, heads_total),
                             rate)


def attention_packed_dropout_bwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        segment_ids: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
        do: torch.Tensor, seed: int, rate: float,
        sm_scale: Optional[float] = None, block_q: int = DEFAULT_BLOCK_Q,
        row_base: int = 0, head_base: int = 0,
        heads_total: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of ``_bwd_kernel_seg_drop``: the same mask M
    regenerated, dV = (M∘P)ᵀ·dO/(1−r), dS = P∘(M∘dP/(1−r) − Δ)."""
    return _packed_bwd_plain(q, k, v, segment_ids, o, lse, do, sm_scale,
                             _packed_keep(q, seed, rate, block_q, row_base,
                                          head_base, heads_total),
                             rate)


def _check_segments(q: torch.Tensor, segment_ids: torch.Tensor) -> None:
    b, _, s, _ = q.shape
    if (segment_ids.dtype != torch.int32 or segment_ids.device != q.device
            or segment_ids.shape != (b, s)
            or not segment_ids.is_contiguous()):
        raise ValueError(
            f"segment_ids must be contiguous int32 [{b}, {s}] on {q.device},"
            f" got {segment_ids.dtype} {tuple(segment_ids.shape)} on "
            f"{segment_ids.device}")


def _packed_dropout_args(q: torch.Tensor, seed: int, rate: float,
                         block_q: int, row_base: int, head_base: int = 0,
                         heads_total: Optional[int] = None):
    """(seed_mix, threshold, q_pad, s_pad, bh_base, heads_total,
    head_base) of the segment dropout kernels."""
    return (*dropout_constants(seed, rate),
            *packed_mask_strides(q.shape[2], block_q),
            *_drop_heads(q, row_base, head_base, heads_total))


def _packed_fwd_launch(q, k, v, segment_ids, sm_scale, dropout=None):
    """Launch a segment forward kernel; ``dropout`` = (seed_mix, threshold,
    q_pad, s_pad, bh_base, heads_total, head_base, 1 − rate) takes the
    dropout entry point. The ids are read
    in place as [B, S], once for all heads."""
    d, scale = q.shape[-1], _scale(q, sm_scale)
    q, k, v = _padded(d, q, k, v)
    _check(q, k, v)
    _check_segments(q, segment_ids)
    b, h, s, width = q.shape
    out = _heads_merged(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, s, width, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], scale)
    tail = (_DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    lib = kernels.library()
    if dropout is None:
        err = lib.cxr_attention_fwd_seg(*args, *tail)
    else:
        err = lib.cxr_attention_fwd_seg_dropout(*args, *dropout, *tail)
    kernels.check(err, "flash_attention_packed_fwd")
    return _sliced(out, d), lse


def flash_attention_packed_fwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, segment_ids: torch.Tensor,
                               sm_scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-masked training forward: (o, lse f32 [B, H, S]). CPU tensors
    take :func:`attention_packed_fwd_reference`; CUDA tensors launch the
    kernel (``csrc/flash_attention_seg.cu``), which takes what
    :func:`flash_attention_fwd` takes plus int32 ids [B, S]."""
    if q.device.type == "cpu":
        return attention_packed_fwd_reference(q, k, v, segment_ids, sm_scale)
    out = _packed_fwd_launch(q, k, v, segment_ids, sm_scale)
    flash_attention_packed_fwd.launches += 1
    return out


flash_attention_packed_fwd.launches = 0   # kernel launches (chip_smoke.py)


def flash_attention_packed_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, segment_ids: torch.Tensor,
                               o: torch.Tensor, lse: torch.Tensor,
                               do: torch.Tensor,
                               sm_scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Segment-masked training backward: (dq, dk, dv), laid out as
    :func:`flash_attention_bwd` lays them out. CPU tensors take
    :func:`attention_packed_bwd_reference`; CUDA tensors launch the kernels
    of ``csrc/flash_attention_seg_bwd.cu``."""
    if q.device.type == "cpu":
        return attention_packed_bwd_reference(q, k, v, segment_ids, o, lse,
                                              do, sm_scale)
    _check_segments(q, segment_ids)
    grads = _bwd_launch(q, k, v, o, lse, do, sm_scale, segment_ids=segment_ids)
    flash_attention_packed_bwd.launches += 1
    return grads


flash_attention_packed_bwd.launches = 0   # kernel launches (chip_smoke.py)


def flash_attention_packed_dropout_fwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        segment_ids: torch.Tensor, seed: int, rate: float,
        sm_scale: Optional[float] = None, block_q: int = DEFAULT_BLOCK_Q,
        row_base: int = 0, head_base: int = 0,
        heads_total: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-masked training forward with dropout: (o, lse). CPU tensors
    take :func:`attention_packed_dropout_fwd_reference`; CUDA tensors
    launch the kernel, which hashes the mask in registers."""
    if q.device.type == "cpu":
        return attention_packed_dropout_fwd_reference(
            q, k, v, segment_ids, seed, rate, sm_scale, block_q, row_base,
            head_base, heads_total)
    out = _packed_fwd_launch(
        q, k, v, segment_ids, sm_scale,
        (*_packed_dropout_args(q, seed, rate, block_q, row_base, head_base,
                               heads_total), 1.0 - rate))
    flash_attention_packed_dropout_fwd.launches += 1
    return out


flash_attention_packed_dropout_fwd.launches = 0   # kernel launches


def flash_attention_packed_dropout_bwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        segment_ids: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
        do: torch.Tensor, seed: int, rate: float,
        sm_scale: Optional[float] = None, block_q: int = DEFAULT_BLOCK_Q,
        row_base: int = 0, head_base: int = 0,
        heads_total: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segment-masked training backward with dropout. CPU tensors take
    :func:`attention_packed_dropout_bwd_reference`; CUDA tensors launch the
    kernels of ``csrc/flash_attention_seg_bwd_dropout.cu`` with the mask
    regenerated."""
    if q.device.type == "cpu":
        return attention_packed_dropout_bwd_reference(
            q, k, v, segment_ids, o, lse, do, seed, rate, sm_scale, block_q,
            row_base, head_base, heads_total)
    _check_segments(q, segment_ids)
    grads = _bwd_launch(
        q, k, v, o, lse, do, sm_scale,
        (*_packed_dropout_args(q, seed, rate, block_q, row_base, head_base,
                               heads_total), 1.0 / (1.0 - rate)),
        segment_ids)
    flash_attention_packed_dropout_bwd.launches += 1
    return grads


flash_attention_packed_dropout_bwd.launches = 0   # kernel launches


class FlashAttentionPacked(torch.autograd.Function):
    """Segment-masked attention with the segment kernels in both
    directions. Saves q, k, v, the ids, o and lse, the residuals of the
    JAX custom VJP (``_flash_packed_fwd_rule``)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, sm_scale=None):
        o, lse = flash_attention_packed_fwd(q, k, v, segment_ids, sm_scale)
        ctx.save_for_backward(q, k, v, segment_ids, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, segment_ids, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_packed_bwd(q, k, v, segment_ids, o, lse,
                                                do, ctx.sm_scale)
        return dq, dk, dv, None, None


class FlashAttentionPackedDropout(torch.autograd.Function):
    """Segment-masked attention with dropout through the segment dropout
    kernels. Saves what :class:`FlashAttentionPacked` saves and the seed,
    the row base and the head fields as Python ints, so the backward and a
    recompute under remat replay the mask."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, seed, rate, sm_scale=None,
                block_q=DEFAULT_BLOCK_Q, row_base=0, head_base=0,
                heads_total=None):
        o, lse = flash_attention_packed_dropout_fwd(
            q, k, v, segment_ids, seed, rate, sm_scale, block_q, row_base,
            head_base, heads_total)
        ctx.save_for_backward(q, k, v, segment_ids, o, lse)
        ctx.seed, ctx.rate, ctx.row_base = int(seed), rate, int(row_base)
        ctx.head_base, ctx.heads_total = int(head_base), heads_total
        ctx.sm_scale, ctx.block_q = sm_scale, block_q
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, segment_ids, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_packed_dropout_bwd(
            q, k, v, segment_ids, o, lse, do, ctx.seed, ctx.rate,
            ctx.sm_scale, ctx.block_q, ctx.row_base, ctx.head_base,
            ctx.heads_total)
        return (dq, dk, dv) + (None,) * 8


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           segment_ids: torch.Tensor,
                           sm_scale: Optional[float] = None,
                           block_q: int = DEFAULT_BLOCK_Q) -> torch.Tensor:
    """Segment-masked (block-diagonal) attention for packed batches, the
    signature of the JAX package's ``flash_attention_packed``: q, k, v
    [B, H, S, d], ``segment_ids`` int32 [B, S]; token i attends token j
    iff their ids are equal, and pad slots (id −1) attend each other.
    ``block_q`` tiled the TPU kernel and changes nothing here. The autograd
    function over the kernels for CUDA tensors, the plain forward under
    plain autograd for CPU tensors."""
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, segment_ids, sm_scale)
    return FlashAttentionPacked.apply(q, k, v, segment_ids, sm_scale)


def flash_attention_packed_dropout(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor,
                                   segment_ids: torch.Tensor, seed: int,
                                   rate: float,
                                   sm_scale: Optional[float] = None,
                                   block_q: int = DEFAULT_BLOCK_Q,
                                   row_base: int = 0, head_base: int = 0,
                                   heads_total: Optional[int] = None
                                   ) -> torch.Tensor:
    """:func:`flash_attention_packed` with in-kernel probability dropout,
    the signature of the JAX package's ``flash_attention_packed_dropout``
    (``seed`` an int32 value; ``block_q`` fixes the mask's strides, see
    :func:`packed_mask_strides`), ``row_base``, the global sequence of the
    first one, and ``head_base`` / ``heads_total``, the model's head of
    q's first (None: q holds every head). The same seed gives the JAX
    function's mask, bit for bit."""
    if q.device.type == "cpu":
        return attention_packed_dropout_fwd_reference(
            q, k, v, segment_ids, seed, rate, sm_scale, block_q,
            row_base, head_base, heads_total)[0]
    return FlashAttentionPackedDropout.apply(q, k, v, segment_ids, seed,
                                             rate, sm_scale, block_q,
                                             row_base, head_base,
                                             heads_total)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     segment_ids: torch.Tensor, impl: str = "auto",
                     seed: Optional[int] = None,
                     rate: float = 0.0, row_base: int = 0,
                     head_base: int = 0,
                     heads_total: Optional[int] = None) -> torch.Tensor:
    """The attention dispatch of the reference's ``_packed_mha``:
    ``'xla'`` runs the plain version on any device, ``'auto'`` and
    ``'pallas'`` the segment kernels for CUDA tensors. With a ``seed`` and
    ``rate > 0`` probabilities are dropped with the counter-hash mask on
    the automatic Q block (:func:`packed_block_q`) on every path, the
    first sequence global sequence ``row_base``, the first head the
    model's head ``head_base`` of ``heads_total`` (a tensor rank's heads);
    the reference's XLA path draws another mask stream (``jax.random``)."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if seed is None or rate == 0.0:
        if impl == "xla":
            return attention_packed_reference(q, k, v, segment_ids)
        return flash_attention_packed(q, k, v, segment_ids)
    block_q = packed_block_q(q.shape[2])
    if impl == "xla":
        return attention_packed_dropout_fwd_reference(
            q, k, v, segment_ids, seed, rate, None, block_q, row_base,
            head_base, heads_total)[0]
    return flash_attention_packed_dropout(q, k, v, segment_ids, seed, rate,
                                          None, block_q, row_base, head_base,
                                          heads_total)


def _fits(t: torch.Tensor) -> bool:
    """A contiguous head dim, 16-byte aligned rows and (b, h, s) strides
    in whole 16-byte vectors: what the kernels read in place."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % vec == 0 for st in t.stride()[:3]))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **more: torch.Tensor) -> None:
    """Raise on any operand the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "the attention kernel wrappers build no autograd graph; use "
            "attention(..., inference=False) or FlashAttention.apply for "
            "gradients")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernel takes f32 or bf16, got {q.dtype}")
    operands = {"k": k, "v": v, **more}
    for name, t in operands.items():
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")
    if q.dim() != 4:
        raise ValueError(f"expected [B, H, S, d], got {tuple(q.shape)}")
    for name, t in {"q": q, **operands}.items():
        if not _fits(t):
            raise ValueError(
                f"{name} needs a contiguous head dim, 16-byte aligned rows "
                f"and strides that are multiples of "
                f"{16 // t.element_size()}; got strides {t.stride()}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "auto", inference: bool = False) -> torch.Tensor:
    """Dispatch as in the JAX package: ``impl='xla'`` runs the plain version
    under plain autograd on any device; ``'auto'`` and ``'pallas'`` run
    the forward-only kernel when ``inference`` (its plain version for CPU
    tensors), else :class:`FlashAttention` (the training kernels, or their
    plain versions for CPU tensors)."""
    if impl == "xla":
        return attention_reference(q, k, v)
    if impl not in ("auto", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if inference:
        return flash_attention_inference(q, k, v)
    return FlashAttention.apply(q, k, v)


def attention_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      seed: int, rate: float, impl: str = "auto",
                      row_base: int = 0, head_base: int = 0,
                      heads_total: Optional[int] = None) -> torch.Tensor:
    """Training attention with probability dropout, as the reference ViT's
    ``_mha`` runs it: :func:`flash_attention_dropout` with the automatic
    Q block (the mask's row stride) for ``'auto'`` and ``'pallas'``; its
    plain version under plain autograd for ``'xla'``. ``row_base`` is the
    global batch row of q's first row, ``head_base`` the model's head of
    q's first (of ``heads_total``; None: q holds every head). The reference's XLA path draws
    another mask stream (``jax.random``); the port keeps the counter hash
    on every path."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    block_q = auto_block_q(q.shape[2])
    if impl == "xla":
        return attention_dropout_fwd_reference(q, k, v, seed, rate, None,
                                               block_q, row_base, head_base,
                                               heads_total)[0]
    return flash_attention_dropout(q, k, v, seed, rate, None, block_q,
                                   row_base, head_base, heads_total)
