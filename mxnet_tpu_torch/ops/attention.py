"""Attention doors (counterpart of ``mxnet_tpu/ops/attention.py``): the
``DotProductAttention`` op and its functional form
:func:`sdp_attention` on the flash kernels (causal or full, or
offset-causal for the contiguous serving plane's decode steps), and the
paged door of the serving path.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..kernels.flash_attention import FlashAttention, flash_attention_offset
from ..kernels.paged_attention import flash_attention_paged
from .registry import Bool, Float, register

__all__ = ["sdp_attention", "sdp_attention_paged"]


def sdp_attention(query, key, value, causal=False, scale=0.0,
                  q_offsets=None):
    """Scaled-dot-product attention over [B, H, L, D] through the flash
    kernel's autograd Function; ``scale <= 0`` selects ``1/sqrt(D)``.
    The inputs are made contiguous first (the kernel's layout); fp32 and
    bf16 take their own kernels, and no dtype is cast here (the model
    casts q to the cache dtype, as the reference's does).

    ``q_offsets`` (a per-sequence int vector) selects the offset-causal
    variant, forward only: query row r of sequence b sits at position
    ``q_offsets[b] + r`` and attends to key positions up to its own, on
    ``flash_attention_offset``."""
    if scale <= 0.0:
        scale = 1.0 / (query.shape[-1] ** 0.5)
    if q_offsets is not None:
        ofs = torch.as_tensor(q_offsets, device=query.device)
        return flash_attention_offset(
            query.contiguous(), key.contiguous(), value.contiguous(),
            ofs.to(torch.int32).contiguous(), float(scale))
    return FlashAttention.apply(query.contiguous(), key.contiguous(),
                                value.contiguous(), bool(causal),
                                float(scale))


def sdp_attention_paged(query, k_pool, v_pool, tables, positions,
                        block_size, scale=0.0, kv_scales=None):
    """Paged scaled-dot-product attention: (B, H, Lq, D) queries whose
    row r of sequence b sits at global position ``positions[b] + r``,
    attending over a global (H, num_blocks * block_size, D) pool through
    (B, T) block tables.  ``scale <= 0`` selects ``1/sqrt(D)``.
    ``kv_scales`` — ``(scale_k, scale_v)``, each (H, num_blocks) fp32 —
    marks the pools as int8 codes with per-(head, block) scales."""
    d = query.shape[-1]
    if scale <= 0.0:
        scale = 1.0 / (d ** 0.5)
    return flash_attention_paged(query, k_pool, v_pool, tables, positions,
                                 int(block_size), scale=scale,
                                 kv_scales=kv_scales)


def _attn_fc(attrs, query, key, value):
    if query.dim() != 4:
        raise MXNetError("DotProductAttention expects [batch, heads, "
                         "length, head_dim] inputs, got ndim=%d"
                         % query.dim())
    return sdp_attention(query, key, value, causal=attrs["causal"],
                         scale=attrs["scale"])


def _attn_infer(attrs, in_shapes):
    known = in_shapes[0] or in_shapes[1] or in_shapes[2]
    if known is not None:
        for i in range(3):
            if in_shapes[i] is None:
                in_shapes[i] = known
    return in_shapes, [in_shapes[0]], []


register("DotProductAttention", fcompute=_attn_fc,
         arguments=("query", "key", "value"),
         attrs={"causal": Bool(False), "scale": Float(0.0)},
         infer_shape=_attn_infer,
         doc="Scaled dot-product attention over [batch, heads, length, "
             "head_dim]; scale<=0 means 1/sqrt(head_dim).  Runs the flash "
             "attention kernel.")
