"""Paged flash attention: block-table indirection over a global KV pool.

Counterpart of ``mxnet_tpu/pallas_ops/paged_attention.py`` for fp32
pools, forward only.  Logical token position ``p`` of sequence ``b``
lives at pool row ``tables[b, p // bs] * bs + p % bs``, so sequences
share physical blocks (prefix reuse) and grow one block at a time.

``flash_attention_paged`` routes by device: a CPU tensor runs
``paged_attention_reference`` (gather the pool rows through the same
table arithmetic, then dense offset-causal attention with the same
``-1e30`` mask constant and fp32 accumulation); a CUDA tensor launches
``csrc/paged_attention.cu`` or raises.
"""
from __future__ import annotations

import torch

from ._build import launch, route

__all__ = ["flash_attention_paged", "paged_attention_reference"]

_NEG = -1e30  # the TPU kernel's mask constant, shared for parity
MAX_HEAD_DIM = 256


def paged_attention_reference(q, k_pool, v_pool, tables, positions,
                              block_size, scale=None):
    """Plain PyTorch twin of :func:`flash_attention_paged`.

    q: (B, H, Lq, D); k_pool/v_pool: (H, num_blocks * block_size, D);
    tables: (B, T) int; positions: (B,) int.  Returns (B, H, Lq, D) in
    q's dtype."""
    B, H, Lq, D = q.shape
    T = tables.shape[1]
    bs = int(block_size)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    tbl = tables.to(device=q.device, dtype=torch.long)
    pos = positions.to(device=q.device, dtype=torch.long).reshape(B)
    idx = (tbl[:, :, None] * bs +
           torch.arange(bs, device=q.device)[None, None, :]).reshape(B,
                                                                     T * bs)
    k = k_pool[:, idx].permute(1, 0, 2, 3).float()        # (B, H, T*bs, D)
    v = v_pool[:, idx].permute(1, 0, 2, 3).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    qpos = torch.arange(Lq, device=q.device)[:, None]
    kpos = torch.arange(T * bs, device=q.device)[None, :]
    visible = (pos[:, None, None] + qpos[None]) >= kpos[None]  # (B, Lq, K)
    s = torch.where(visible[:, None], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def _check(q, k_pool, v_pool, tables, positions, bs):
    B, H, Lq, D = q.shape
    if D > MAX_HEAD_DIM or D % 4:
        raise ValueError("flash_attention_paged: the CUDA kernel takes a "
                         "head_dim that is a multiple of 4 up to %d, got %d"
                         % (MAX_HEAD_DIM, D))
    for name, t, dtype in (("q", q, torch.float32),
                           ("k_pool", k_pool, torch.float32),
                           ("v_pool", v_pool, torch.float32),
                           ("tables", tables, torch.int32),
                           ("positions", positions, torch.int32)):
        if t.device != q.device:
            raise ValueError("flash_attention_paged: %s on %s, q on %s"
                             % (name, t.device, q.device))
        if t.dtype != dtype:
            raise ValueError("flash_attention_paged: %s must be %s, got %s"
                             % (name, dtype, t.dtype))
        if not t.is_contiguous():
            raise ValueError("flash_attention_paged: %s must be contiguous"
                             % name)
    if k_pool.shape != v_pool.shape or k_pool.dim() != 3 or \
            k_pool.shape[0] != H or k_pool.shape[2] != D:
        raise ValueError("flash_attention_paged: pools must be (H=%d, rows, "
                         "D=%d), got %s / %s" % (H, D, tuple(k_pool.shape),
                                                 tuple(v_pool.shape)))
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("flash_attention_paged: pools must be 16-byte "
                         "aligned")
    if k_pool.shape[1] % bs:
        raise ValueError("flash_attention_paged: pool length %d is not a "
                         "multiple of block_size %d" % (k_pool.shape[1], bs))
    if tables.dim() != 2 or tables.shape[0] != B or positions.shape != (B,):
        raise ValueError("flash_attention_paged: tables (B, T) and "
                         "positions (B,) must match batch %d" % B)


def flash_attention_paged(q, k_pool, v_pool, tables, positions, block_size,
                          scale=None):
    """Offset-causal attention of ``q`` (B, H, Lq, D) against a paged KV
    pool.  Query row r of sequence b sits at global position
    ``positions[b] + r``; table entries past a sequence's frontier must
    point at a valid block (conventionally the trash block 0) — their
    keys are masked either way.  The CUDA kernel takes fp32 q and pools,
    int32 tables and positions, all contiguous, 16-byte aligned pools and
    a head dim D that is a multiple of 4 up to 256."""
    bs = int(block_size)
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if not route("flash_attention_paged", q):
        return paged_attention_reference(q, k_pool, v_pool, tables,
                                         positions, bs, scale)
    _check(q, k_pool, v_pool, tables, positions, bs)
    B, H, Lq, _ = q.shape
    out = torch.empty_like(q)
    launch(q, "flash_attention_paged", "mxt_paged_attention_f32",
           q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
           tables.data_ptr(), positions.data_ptr(), out.data_ptr(), B, H, Lq,
           D, tables.shape[1], bs, k_pool.shape[1], float(scale))
    return out
