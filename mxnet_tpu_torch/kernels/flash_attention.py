"""Flash attention over contiguous ``[B, H, L, D]`` tensors: the CUDA
forward kernel and its plain version.

Counterpart of ``flash_attention`` in
``mxnet_tpu/pallas_ops/flash_attention.py``.  ``flash_attention`` runs
the forward: on a CPU tensor the plain version
:func:`blockwise_attention` (the online-softmax recurrence over key
blocks, with the reference's ``-1e30`` mask, masked ``p`` forced to 0
and ``acc / (l > 0 ? l : 1)``), on a CUDA tensor
``csrc/flash_attention.cu`` or an error.

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

import torch

from ._build import KernelError, check_args, launch, route

__all__ = ["flash_attention", "blockwise_attention", "FlashAttention",
           "KEY_TILE", "BACKWARD_BLOCK"]

_NEG = -1e30      # the TPU kernel's mask constant, shared for parity
KEY_TILE = 32     # kKeyTile of csrc/flash_attention.cu
BACKWARD_BLOCK = 128   # the reference's key block for the recompute
MAX_HEAD_DIM = 256


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


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise KernelError("flash_attention: q [B,H,Lq,D] and k, v "
                          "[B,H,Lk,D] expected, got %s / %s / %s"
                          % (tuple(q.shape), tuple(k.shape),
                             tuple(v.shape)))
    D = q.shape[3]
    if D > MAX_HEAD_DIM or D % 4:
        raise KernelError("flash_attention: the CUDA kernel takes a head "
                          "dim that is a multiple of 4 up to %d, got %d"
                          % (MAX_HEAD_DIM, D))
    check_args("flash_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise KernelError("flash_attention: %s must be 16-byte aligned"
                              % name)


def flash_attention(q, k, v, causal=False, scale=None):
    """Scaled-dot-product attention of ``q`` [B, H, Lq, D] over ``k``,
    ``v`` [B, H, Lk, D]; ``scale=None`` is ``1/sqrt(D)``.  The CUDA
    kernel takes contiguous fp32 tensors, 16-byte aligned, with a head
    dim that is a multiple of 4 up to 256."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if not route("flash_attention", q):
        return blockwise_attention(q, k, v, causal, scale)
    _check(q, k, v)
    B, H, Lq, D = q.shape
    out = torch.empty_like(q)
    launch(q, "flash_attention", "mxt_flash_attention_f32", q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, Lq,
           k.shape[2], D, int(bool(causal)), float(scale))
    return out


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
