"""Attention doors (counterpart of ``mxnet_tpu/ops/attention.py``).

Only the paged door of the serving path is ported so far.
"""
from __future__ import annotations

from ..kernels.paged_attention import flash_attention_paged

__all__ = ["sdp_attention_paged"]


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
