"""Attention doors (counterpart of ``mxnet_tpu/ops/attention.py``): the
``DotProductAttention`` op and its functional form
:func:`sdp_attention` on the flash kernel, and the paged door of the
serving path.
"""
from __future__ import annotations

from ..base import MXNetError
from ..kernels.flash_attention import FlashAttention
from ..kernels.paged_attention import flash_attention_paged
from .registry import Bool, Float, register

__all__ = ["sdp_attention", "sdp_attention_paged"]


def sdp_attention(query, key, value, causal=False, scale=0.0):
    """Scaled-dot-product attention over [B, H, L, D] through the flash
    kernel's autograd Function; ``scale <= 0`` selects ``1/sqrt(D)``.
    The inputs are made contiguous first (the kernel's layout)."""
    if scale <= 0.0:
        scale = 1.0 / (query.shape[-1] ** 0.5)
    return FlashAttention.apply(query.contiguous(), key.contiguous(),
                                value.contiguous(), bool(causal),
                                float(scale))


def sdp_attention_paged(query, k_pool, v_pool, tables, positions,
                        block_size, scale=0.0):
    """Paged scaled-dot-product attention: (B, H, Lq, D) queries whose
    row r of sequence b sits at global position ``positions[b] + r``,
    attending over a global (H, num_blocks * block_size, D) pool through
    (B, T) block tables.  ``scale <= 0`` selects ``1/sqrt(D)``."""
    d = query.shape[-1]
    if scale <= 0.0:
        scale = 1.0 / (d ** 0.5)
    return flash_attention_paged(query, k_pool, v_pool, tables, positions,
                                 int(block_size), scale=scale)


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
