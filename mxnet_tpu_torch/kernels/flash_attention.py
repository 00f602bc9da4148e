"""Flash attention over contiguous ``[B, H, L, D]`` tensors: the CUDA
forward kernels and their plain versions, in fp32 or bf16.

Counterpart of ``flash_attention`` and ``flash_attention_offset`` in
``mxnet_tpu/pallas_ops/flash_attention.py``.  ``flash_attention`` runs
the forward: on a CPU tensor the plain version
:func:`blockwise_attention` (the online-softmax recurrence over key
blocks, with the reference's ``-1e30`` mask, masked ``p`` forced to 0
and ``acc / (l > 0 ? l : 1)``), on a CUDA tensor
``csrc/flash_attention.cu`` or an error.  ``flash_attention_offset`` is
the decode attention of the contiguous serving plane, forward only: on
a CPU tensor the plain :func:`offset_attention_reference` (dense
offset-causal attention, the reference's
``ops/attention._dense_attention(q_offsets=)``), on a CUDA tensor the
same CUDA file.  Both plain versions compute in fp32 and cast back to
the input dtype, as the TPU kernels upcast their tiles.

Each entry point has three bodies, and :func:`_plan` picks one from the
shape: the decode body on CUDA cores for a few query rows (one row a
CTA), the tensor-core tile for more (64 rows a CTA: 3xTF32 in fp32, bf16
``mma.sync`` in bf16), and the CUDA-core v1 for a head dim above 128.
bf16 ``flash_attention`` has a fourth, ``"wgmma"``, which takes the
tile's place: Hopper's warpgroup MMA fed by TMA from a producer warp,
64 query rows a CTA (the bf16 offset kernel keeps the ``mma.sync``
tile).  One call is one launch, counted as
``flash_attention``, ``flash_attention_bf16``, ``flash_attention_offset``
or ``flash_attention_offset_bf16``.

:class:`FlashAttention` is the ``torch.autograd.Function``.  Its
backward is not a kernel, because the reference's is not one either:
``_flash_bwd`` re-runs XLA's ``blockwise_attention`` under ``jax.vjp``.
Here the backward recomputes :func:`blockwise_attention` from the saved
``(q, k, v)`` over key blocks of the reference's size (its default
``block_seq`` of 128, which its backward re-runs with) and
differentiates it, so no ``L x L`` residual is kept between forward and
backward.
"""
from __future__ import annotations

import collections

import torch

from ._build import KernelError, check_args, launch, route, sm_count

__all__ = ["flash_attention", "blockwise_attention", "FlashAttention",
           "flash_attention_offset", "offset_attention_reference",
           "KEY_TILE", "BACKWARD_BLOCK"]

_NEG = -1e30      # the TPU kernel's mask constant, shared for parity
KEY_TILE = 32     # the plain version's key block (v1's key tile)
BACKWARD_BLOCK = 128   # the reference's key block for the recompute
MAX_HEAD_DIM = 256
TILE_MAX_HEAD_DIM = 128  # decode and tile: D zero-padded up to 128
V1_ROWS = 32             # v1: query rows a CTA
TILE_ROWS = 64           # the tile: query rows a CTA, 16 a warp
WGMMA_ROWS = 64          # wgmma: query rows a CTA, its consumer warpgroup
# the largest Lq that takes the decode body (one query row a CTA, so Lq
# CTAs a sequence and head), by dtype: above it the tile is faster at
# B32 Lk1024 (PERF.md §6, chip_smoke.py phase 5)
DECODE_MAX_LQ = {torch.float32: 6, torch.bfloat16: 6}
# the entry points' path argument
_PATH = {"v1": 0, "decode": 1, "tile": 2, "wgmma": 3}
Plan = collections.namedtuple("Plan", "path block_q grid")
# dtype -> ((launch name, C entry point) of flash_attention, the same of
# flash_attention_offset, head-dim multiple: one 16-byte copy of a row)
_VARIANTS = {
    torch.float32: (("flash_attention", "mxt_flash_attention_f32"),
                    ("flash_attention_offset",
                     "mxt_flash_attention_offset_f32"), 4),
    torch.bfloat16: (("flash_attention_bf16", "mxt_flash_attention_bf16"),
                     ("flash_attention_offset_bf16",
                      "mxt_flash_attention_offset_bf16"), 8),
}


def blockwise_attention(q, k, v, causal=False, scale=None,
                        block_size=KEY_TILE):
    """Plain PyTorch attention over ``[B, H, L, D]`` by the online-softmax
    recurrence over key blocks of ``block_size`` (the last may be
    shorter), in fp32.  Causal masking is top-left aligned: query row i
    sees keys j <= i."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = q.float()
    m = torch.full((B, H, Lq, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    qpos = torch.arange(Lq, device=q.device)[:, None]
    for start in range(0, Lk, block_size):
        kb = k[:, :, start:start + block_size].float()
        vb = v[:, :, start:start + block_size].float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            kpos = start + torch.arange(kb.shape[2], device=q.device)
            mask = qpos >= kpos[None, :]
            s = torch.where(mask, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if causal:
            p = torch.where(mask, p, torch.zeros_like(p))
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(p, vb)
        m = m_new
    return (o / torch.where(l > 0, l, torch.ones_like(l))).to(q.dtype)


def _plan(B, H, Lq, Lk, D, dtype, sms, offset=False):
    """The body and grid of one launch in ``dtype`` (float32 or
    bfloat16): ``"v1"`` for D above 128; else ``"decode"`` for Lq up to
    ``DECODE_MAX_LQ[dtype]``; above it ``"wgmma"`` for bf16
    ``flash_attention`` and ``"tile"`` otherwise (fp32, and the
    ``offset`` entry point).  ``Lk`` and the card's ``sms`` SMs do not
    move the choice: no body splits a sequence's keys over CTAs."""
    del Lk, sms
    if D > TILE_MAX_HEAD_DIM:
        path = "v1"
    elif Lq <= DECODE_MAX_LQ[dtype]:
        path = "decode"
    elif dtype == torch.bfloat16 and not offset:
        path = "wgmma"
    else:
        path = "tile"
    return _path_plan(path, B, H, Lq)


def _path_plan(path, B, H, Lq):
    """``path``'s query rows a CTA and grid: decode one row, grid (Lq,
    B*H); the tile and wgmma 64 (wgmma: one consumer warpgroup), grid
    (B*H, q-tiles); v1 32, grid (q-tiles, B*H)."""
    block_q = {"decode": 1, "tile": TILE_ROWS, "wgmma": WGMMA_ROWS,
               "v1": V1_ROWS}[path]
    tiles = -(-Lq // block_q)
    grid = (B * H, tiles) if path in ("tile", "wgmma") else (tiles, B * H)
    return Plan(path, block_q, grid)


def _check(q, k, v, offsets=None):
    """Refuse what the CUDA kernel does not take: q [B,H,Lq,D], k and v
    [B,H,Lk,D], all fp32 or all bf16, contiguous and 16-byte aligned,
    with a head dim up to 256 that is a multiple of 4 (fp32) or 8
    (bf16); ``offsets`` a contiguous (B,) int32 tensor on q's device."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise KernelError("flash_attention: q [B,H,Lq,D] and k, v "
                          "[B,H,Lk,D] expected, got %s / %s / %s"
                          % (tuple(q.shape), tuple(k.shape),
                             tuple(v.shape)))
    check_args("flash_attention", q, k, v,
               dtypes=(torch.float32, torch.bfloat16))
    D = q.shape[3]
    mult = _VARIANTS[q.dtype][2]
    if D > MAX_HEAD_DIM or D % mult:
        raise KernelError("flash_attention: the CUDA kernel takes a %s "
                          "head dim that is a multiple of %d up to %d, "
                          "got %d" % (str(q.dtype).replace("torch.", ""),
                                      mult, MAX_HEAD_DIM, D))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise KernelError("flash_attention: %s must be 16-byte aligned"
                              % name)
    B = q.shape[0]
    if offsets is not None and (
            offsets.device != q.device or offsets.dtype != torch.int32 or
            tuple(offsets.shape) != (B,) or not offsets.is_contiguous()):
        raise KernelError("flash_attention_offset: offsets must be a "
                          "contiguous (B,) = (%d,) int32 tensor on %s"
                          % (B, q.device))


def _launch(q, k, v, offsets, causal, scale):
    """One launch of the body ``_plan`` names; returns the output."""
    _check(q, k, v, offsets)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    plan = _plan(B, H, Lq, Lk, D, q.dtype, sm_count(q.device.index),
                 offset=offsets is not None)
    fa, ofs, _mult = _VARIANTS[q.dtype]
    out = torch.empty_like(q)
    body = (_PATH[plan.path], plan.block_q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if offsets is None:
        launch(q, fa[0], fa[1], *ptrs, out.data_ptr(), B * H, Lq, Lk, D,
               int(bool(causal)), float(scale), *body)
    else:
        launch(q, ofs[0], ofs[1], *ptrs, offsets.data_ptr(), out.data_ptr(),
               B, H, Lq, Lk, D, float(scale), *body)
    return out


def flash_attention(q, k, v, causal=False, scale=None):
    """Scaled-dot-product attention of ``q`` [B, H, Lq, D] over ``k``,
    ``v`` [B, H, Lk, D]; ``scale=None`` is ``1/sqrt(D)``.  The output is
    in the input dtype.  The CUDA kernel takes contiguous fp32 or bf16
    tensors, 16-byte aligned, with a head dim up to 256 that is a
    multiple of 4 (fp32) or 8 (bf16)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if not route("flash_attention", q):
        return blockwise_attention(q, k, v, causal, scale)
    return _launch(q, k, v, None, causal, scale)


def offset_attention_reference(q, k, v, offsets, scale=None):
    """Plain PyTorch offset-causal attention: query row r of sequence b
    (``q`` [B, H, Lq, D]) sits at position ``offsets[b] + r`` and sees
    key positions up to its own in ``k``, ``v`` [B, H, Lk, D]; masked
    scores are ``-1e30``, the softmax and both products fp32."""
    Lq, Lk = q.shape[2], k.shape[2]
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    ofs = offsets.to(device=q.device, dtype=torch.long).reshape(-1)
    qpos = ofs[:, None, None] + torch.arange(Lq, device=q.device)[:, None]
    visible = qpos >= torch.arange(Lk, device=q.device)       # (B, Lq, Lk)
    s = torch.where(visible[:, None], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_offset(q, k, v, offsets, scale=None):
    """Offset-causal attention of ``q`` [B, H, Lq, D] over a [B, H, Lk,
    D] cache: row r of sequence b sits at position ``offsets[b] + r``
    and attends to key positions ``<= offsets[b] + r``.  ``offsets``:
    (B,) int.  Forward only; the output is in the input dtype.  The CUDA
    kernel takes what :func:`flash_attention`'s does, and int32
    offsets."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if not route("flash_attention_offset", q):
        return offset_attention_reference(q, k, v, offsets, scale)
    return _launch(q, k, v, offsets, True, scale)


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, scale)``: the forward
    kernel; the backward differentiates a recomputation of
    :func:`blockwise_attention` over ``BACKWARD_BLOCK``-key blocks from
    the saved ``(q, k, v)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return flash_attention(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = blockwise_attention(q, k, v, ctx.causal, ctx.scale,
                                      BACKWARD_BLOCK)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None
