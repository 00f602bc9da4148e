"""Paged flash attention: block-table indirection over a global KV pool.

Counterpart of ``mxnet_tpu/pallas_ops/paged_attention.py``, forward
only, for fp32 pools, bf16 pools (with a bf16 q) and int8 code pools
with per-(head, physical block) fp32 scales (``kv_scales``).  Logical
token position ``p`` of sequence ``b`` lives at pool row ``tables[b, p
// bs] * bs + p % bs``, so sequences share physical blocks (prefix
reuse) and grow one block at a time.

``flash_attention_paged`` routes by device: a CPU tensor runs
``paged_attention_reference`` (gather the pool rows through the same
table arithmetic, dequantize int8 rows as ``codes * scale[h, tbl[b,
j]]``, then dense offset-causal attention with the same ``-1e30`` mask
constant and fp32 accumulation); a CUDA tensor launches
``csrc/paged_attention.cu`` (its fp32, bf16 or int8 entry point,
counted as ``flash_attention_paged``, ``flash_attention_paged_bf16`` and
``flash_attention_paged_int8``) or raises.  Over an int8 pool a bf16 q
is widened to fp32 for the int8 kernel (exactly) and its output cast
back to bf16, as the reference's int8 kernel takes a bf16 q and writes
a bf16 output.  Each entry point has three bodies; :func:`_plan` picks
one from the shape: the decode body on CUDA cores for a few query rows,
the tensor-core tile for a prefill chunk, and v1 for D above 128.
"""
from __future__ import annotations

import collections

import torch

from ._build import launch, route, sm_count

__all__ = ["flash_attention_paged", "paged_attention_reference"]

_NEG = -1e30  # the TPU kernel's mask constant, shared for parity
MAX_HEAD_DIM = 256
TILE_MAX_HEAD_DIM = 128  # decode and tile: D zero-padded to 64 or 128
V1_ROWS = 16             # v1: query rows a CTA at most
TILE_ROWS = 32           # the tile: query rows a CTA, or half of them
# the largest Lq that takes the decode body (one query row a CTA, so Lq
# CTAs a sequence and head), by pool dtype: above it the tile is faster
# (PERF.md §6, chip_smoke.py phase 5).  int8 takes the speculative
# verify (Lq 5 at B16, 128 tile CTAs with 5 of 16 rows live) on the
# decode body, which phase 5 timed 1.27x faster there
DECODE_MAX_LQ = {torch.float32: 1, torch.bfloat16: 1, torch.int8: 5}
_PATH = {"v1": 0, "decode": 1, "tile": 2}   # the entry points' path
Plan = collections.namedtuple("Plan", "path block_q grid")
# pool dtype -> (launch name, C entry point, head-dim multiple: one
# 16-byte copy of a row)
_VARIANTS = {
    torch.float32: ("flash_attention_paged", "mxt_paged_attention_f32", 4),
    torch.bfloat16: ("flash_attention_paged_bf16",
                     "mxt_paged_attention_bf16", 8),
    torch.int8: ("flash_attention_paged_int8", "mxt_paged_attention_i8",
                 16),
}


def paged_attention_reference(q, k_pool, v_pool, tables, positions,
                              block_size, scale=None, kv_scales=None):
    """Plain PyTorch twin of :func:`flash_attention_paged`.

    q: (B, H, Lq, D); k_pool/v_pool: (H, num_blocks * block_size, D);
    tables: (B, T) int; positions: (B,) int; ``kv_scales``: ``(scale_k,
    scale_v)``, each (H, num_blocks) fp32, for int8 code pools.  Returns
    (B, H, Lq, D) in q's dtype."""
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
    if kv_scales is not None:
        # scale[h, tbl[b, j]] covers the bs gathered rows of logical
        # block j: the kernel's per-key lookup
        sk, sv = (torch.repeat_interleave(
            s.to(q.device).float()[:, tbl], bs, dim=2).permute(1, 0, 2)
            for s in kv_scales)                            # (B, H, T*bs)
        k = k * sk[..., None]
        v = v * sv[..., None]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    qpos = torch.arange(Lq, device=q.device)[:, None]
    kpos = torch.arange(T * bs, device=q.device)[None, :]
    visible = (pos[:, None, None] + qpos[None]) >= kpos[None]  # (B, Lq, K)
    s = torch.where(visible[:, None], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def _plan(B, H, Lq, D, dtype, sms):
    """The body and grid of one launch over a ``dtype`` pool (float32,
    bfloat16 or int8) on a card of ``sms`` SMs: ``"v1"`` for D above
    128; else ``"decode"`` for Lq up to ``DECODE_MAX_LQ[dtype]`` and
    ``"tile"`` above."""
    if D > TILE_MAX_HEAD_DIM:
        path = "v1"
    elif Lq <= DECODE_MAX_LQ[dtype]:
        path = "decode"
    else:
        path = "tile"
    return _path_plan(path, B, H, Lq, sms)


def _path_plan(path, B, H, Lq, sms):
    """``path``'s query rows a CTA and grid (q-tiles, H, B): decode one
    row; the tile 32, or 16 where 32-row CTAs would not fill ``sms``
    SMs; v1 up to 16."""
    if path == "decode":
        block_q = 1
    elif path == "tile":
        block_q = TILE_ROWS if B * H * -(-Lq // TILE_ROWS) >= sms \
            else TILE_ROWS // 2
    else:
        block_q = min(Lq, V1_ROWS)
    return Plan(path, block_q, (-(-Lq // block_q), H, B))


def _check(q, k_pool, v_pool, tables, positions, bs, kv_scales=None):
    """Refuse what the kernel for ``k_pool``'s dtype does not take: the
    pools fp32 or bf16 with q in the same dtype, or int8 codes (with
    ``kv_scales``) and an fp32 q."""
    B, H, Lq, D = q.shape
    pool_dtype = torch.int8 if kv_scales is not None else (
        k_pool.dtype if k_pool.dtype == torch.bfloat16 else torch.float32)
    mult = _VARIANTS[pool_dtype][2]
    if D > MAX_HEAD_DIM or D % mult:
        raise ValueError("flash_attention_paged: the CUDA kernel takes a "
                         "head_dim that is a multiple of %d up to %d, got "
                         "%d" % (mult, MAX_HEAD_DIM, D))
    q_dtype = torch.float32 if kv_scales is not None else pool_dtype
    args = [("q", q, q_dtype), ("k_pool", k_pool, pool_dtype),
            ("v_pool", v_pool, pool_dtype), ("tables", tables, torch.int32),
            ("positions", positions, torch.int32)]
    if kv_scales is not None:
        args += [("scale_k", kv_scales[0], torch.float32),
                 ("scale_v", kv_scales[1], torch.float32)]
    for name, t, dtype in args:
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
    if kv_scales is not None:
        want = (H, k_pool.shape[1] // bs)
        for t in kv_scales:
            if tuple(t.shape) != want:
                raise ValueError("flash_attention_paged: kv_scales must be "
                                 "(H, num_blocks) = %s, got %s"
                                 % (want, tuple(t.shape)))


def flash_attention_paged(q, k_pool, v_pool, tables, positions, block_size,
                          scale=None, kv_scales=None):
    """Offset-causal attention of ``q`` (B, H, Lq, D) against a paged KV
    pool.  Query row r of sequence b sits at global position
    ``positions[b] + r``; table entries past a sequence's frontier must
    point at a valid block (conventionally the trash block 0) — their
    keys are masked either way.  ``kv_scales`` — ``(scale_k, scale_v)``,
    each (H, num_blocks) fp32 — marks the pools as int8 codes, each
    physical block dequantized with its head's scale.  The output is in
    q's dtype.  The CUDA kernels take fp32 q and pools, bf16 q and
    pools, or int8 pools with fp32 scales and an fp32 or bf16 q (a bf16
    q is widened for that kernel), int32 tables and positions, all
    contiguous, 16-byte aligned pools and a head dim D up to 256 that
    is a multiple of 4 (fp32 pools), 8 (bf16) or 16 (int8)."""
    bs = int(block_size)
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if not route("flash_attention_paged", q):
        return paged_attention_reference(q, k_pool, v_pool, tables,
                                         positions, bs, scale, kv_scales)
    if kv_scales is not None and q.dtype == torch.bfloat16:
        return flash_attention_paged(q.float(), k_pool, v_pool, tables,
                                     positions, bs, scale,
                                     kv_scales).to(q.dtype)
    _check(q, k_pool, v_pool, tables, positions, bs, kv_scales)
    B, H, Lq, _ = q.shape
    name, entry, _mult = _VARIANTS[k_pool.dtype]
    plan = _plan(B, H, Lq, D, k_pool.dtype, sm_count(q.device.index))
    scale_ptrs = () if kv_scales is None else (kv_scales[0].data_ptr(),
                                               kv_scales[1].data_ptr())
    out = torch.empty_like(q)
    launch(q, name, entry, q.data_ptr(), k_pool.data_ptr(),
           v_pool.data_ptr(), *scale_ptrs, tables.data_ptr(),
           positions.data_ptr(), out.data_ptr(), B, H, Lq, D,
           tables.shape[1], bs, k_pool.shape[1], float(scale),
           _PATH[plan.path], plan.block_q)
    return out
