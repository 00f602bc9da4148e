"""Softmax and cross-entropy row kernels and their plain versions
(counterpart of ``mxnet_tpu/pallas_ops/softmax_xent.py``).

Every entry point takes a 2D ``(rows, classes)`` fp32 tensor and
float32 labels truncated to int32; a label outside ``[0, classes)``
matches no column.  SoftmaxOutput's head (``softmax_rows``,
``xent_grad_from_probs``) and the cross-entropy loss
(``xent_loss_rows``, ``softmax_xent_loss_grad``) take bf16 as well:
fp32 arithmetic, a bf16 output rounded once, the label (and the loss's
per-row ``g`` and the loss itself) still float32; their bf16 launches
count under the name with ``_bf16`` appended.  A CPU tensor runs the
plain version beside each; a CUDA tensor launches
``csrc/softmax_xent.cu`` or raises.

* ``softmax_rows`` / ``xent_grad_from_probs``: SoftmaxOutput's head,
  paired by :class:`SoftmaxOutputHead` with the reference's contract
  (the backward ignores the incoming cotangent and emits ``(p -
  onehot(label)) * scale``; no gradient for the label);
* ``softmax_rows`` / ``softmax_rows_bwd``: :func:`fused_softmax`, the
  row softmax with the classic vjp ``p * (dy - sum(dy * p))`` (fp32
  only on the card);
* ``xent_loss_rows`` / ``softmax_xent_loss_grad``:
  :func:`softmax_xent_loss`, per-row ``logsumexp(x) - x[label]``
  (``(rows,)`` float32; the probabilities are never written) whose
  backward recomputes the softmax from the logits and writes
  ``(softmax(x) - onehot(label)) * g``.
"""
from __future__ import annotations

import collections

import torch

from . import count_body
from ._build import SUFFIX, KernelError, align_bytes, check_args, launch, route

__all__ = ["softmax_rows", "xent_grad_from_probs", "softmax_rows_reference",
           "xent_grad_from_probs_reference", "SoftmaxOutputHead",
           "softmax_output_head", "softmax_rows_bwd",
           "softmax_rows_bwd_reference", "FusedSoftmax", "fused_softmax",
           "xent_loss_rows", "xent_loss_rows_reference",
           "softmax_xent_loss_grad", "softmax_xent_loss_grad_reference",
           "SoftmaxXentLoss", "softmax_xent_loss"]


def softmax_rows_reference(x):
    """Plain PyTorch ``e / sum(e)`` with ``e = exp(x - max(x))`` per
    row."""
    xf = x.float()
    e = torch.exp(xf - torch.amax(xf, dim=-1, keepdim=True))
    return (e / torch.sum(e, dim=-1, keepdim=True)).to(x.dtype)


def xent_grad_from_probs_reference(p, label, scale=1.0):
    """Plain PyTorch ``(p - onehot(int32(label))) * scale``."""
    lbl = label.reshape(-1, 1).to(torch.int32)
    cols = torch.arange(p.shape[1], dtype=torch.int32, device=p.device)
    onehot = (cols[None, :] == lbl).to(torch.float32)
    return ((p.float() - onehot) * scale).to(p.dtype)


def softmax_rows_bwd_reference(p, dy):
    """Plain PyTorch ``p * (dy - sum(dy * p))`` per row."""
    pf, dyf = p.float(), dy.float()
    dot = torch.sum(dyf * pf, dim=-1, keepdim=True)
    return (pf * (dyf - dot)).to(p.dtype)


def _onehot_rows(x, label):
    lbl = label.reshape(-1, 1).to(torch.int32)
    cols = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return cols[None, :] == lbl


def xent_loss_rows_reference(x, label):
    """Plain PyTorch per-row ``logsumexp(x) - x[int32(label)]``, float32
    for fp32 or bf16 ``x`` (widened first); a label outside ``[0,
    classes)`` picks no column (``lse - 0``)."""
    xf = x.float()
    m = torch.amax(xf, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(xf - m), dim=-1, keepdim=True)) + m
    tgt = torch.sum(torch.where(_onehot_rows(x, label), xf,
                                torch.zeros((), device=x.device)),
                    dim=-1, keepdim=True)
    return (lse - tgt)[:, 0]


def softmax_xent_loss_grad_reference(x, label, g):
    """Plain PyTorch ``(softmax(x) - onehot(int32(label))) * g[row]`` in
    ``x``'s dtype: computed in fp32 from the widened ``x`` and rounded
    once, as the TPU kernel casts its fp32 tile."""
    p = softmax_rows_reference(x.float())
    onehot = _onehot_rows(x, label).to(torch.float32)
    return ((p - onehot) * g.reshape(-1, 1).float()).to(x.dtype)


def _check_2d(name, x):
    if x.dim() != 2:
        raise KernelError("%s takes a 2D (rows, classes) tensor, got shape "
                          "%s" % (name, tuple(x.shape)))


def _check_head_label(name, p, label):
    """The head's label on its own: float32 whatever ``p``'s dtype (class
    ids past 256 do not fit bf16), on ``p``'s device, contiguous, one a
    row."""
    check_args(name, label)
    if label.device != p.device:
        raise KernelError("%s: all tensors must be on %s, got %s"
                          % (name, p.device, label.device))
    if label.shape != (p.shape[0],):
        raise KernelError("%s: label shape %s, want (%d,)"
                          % (name, tuple(label.shape), p.shape[0]))


def _check_loss_args(name, x, label, *per_row):
    """The loss kernels' arguments: 2D ``x`` in fp32 or bf16; the label
    and each per-row vector (``g``) float32 whatever ``x``'s dtype, as
    the head's label, on ``x``'s device, one a row."""
    _check_2d(name, x)
    check_args(name, x, dtypes=tuple(SUFFIX))
    for t in (label,) + per_row:
        check_args(name, t)
        if t.device != x.device:
            raise KernelError("%s: all tensors must be on %s, got %s"
                              % (name, x.device, t.device))
    _check_labels(name, x, label, *per_row)


# softmax_rows' bodies (csrc/softmax_xent.cu), the C entry points' path
_ROWS_PATH = {"two_pass": 0, "regs": 1}
ROWS_THREADS = 256
# the registers bodies' instances: 16-byte loads a thread (4 fp32 values
# or 8 bf16 a load), smallest first; fp32 rows to 16384 classes (the LSTM
# LM's 10000 take 10), bf16 to 8192
ROWS_REGS_LOADS = {torch.float32: (1, 2, 4, 8, 10, 16),
                   torch.bfloat16: (1, 2, 4)}
RowsPlan = collections.namedtuple("RowsPlan", "body loads")


def _plan(cols, align, dtype):
    """The body of ``softmax_rows`` on rows of ``cols`` classes of
    ``dtype`` (fp32 or bf16) whose tensors start on multiples of
    ``align`` bytes (:func:`align_bytes`); every body runs one CTA of
    ``ROWS_THREADS`` a row, so the rows do not enter the choice.

    ``"regs"``, the row held in registers and read once, where ``cols``
    is a multiple of the 16-byte chunk (4 fp32, 8 bf16), the rows are
    16-byte aligned and one of ``ROWS_REGS_LOADS[dtype]`` holds the row:
    ``loads`` is the smallest.  Else ``"two_pass"``: one running (max,
    sum of exp) pass, then a read that writes; ``loads`` 1 where fp32
    rows allow float4 accesses, 0 for one element at a time."""
    chunk = 16 // torch.empty((), dtype=dtype).element_size()
    if cols % chunk or align % 16:
        return RowsPlan("two_pass", 0)
    need = -(-cols // (chunk * ROWS_THREADS))
    for loads in ROWS_REGS_LOADS[dtype]:
        if loads >= need:
            return RowsPlan("regs", loads)
    return RowsPlan("two_pass", 1 if dtype == torch.float32 else 0)


def softmax_rows(x):
    """Row softmax of 2D ``x`` (fp32 or bf16), in ``x``'s dtype, on the
    body :func:`_plan` names; each launch also counts under
    ``softmax_rows[body]`` (``softmax_rows_bf16[body]``) in
    :func:`~mxnet_tpu_torch.kernels.body_counts`."""
    if not route("softmax_rows", x):
        return softmax_rows_reference(x)
    _check_2d("softmax_rows", x)
    check_args("softmax_rows", x, dtypes=tuple(SUFFIX))
    tag, sfx = SUFFIX[x.dtype]
    p = torch.empty_like(x)
    plan = _plan(x.shape[1], align_bytes(x, p), x.dtype)
    launch(x, "softmax_rows" + tag, "mxt_softmax_rows" + sfx, x.data_ptr(),
           p.data_ptr(), x.shape[0], x.shape[1], _ROWS_PATH[plan.body],
           plan.loads)
    count_body("softmax_rows" + tag, plan.body)
    return p


def xent_grad_from_probs(p, label, scale=1.0):
    """``(p - onehot(label)) * scale`` for 2D probabilities ``p`` (fp32
    or bf16; the gradient in ``p``'s dtype) and a ``(rows,)`` float32
    label vector."""
    if not route("xent_grad_from_probs", p):
        return xent_grad_from_probs_reference(p, label, scale)
    _check_2d("xent_grad_from_probs", p)
    check_args("xent_grad_from_probs", p, dtypes=tuple(SUFFIX))
    _check_head_label("xent_grad_from_probs", p, label)
    tag, sfx = SUFFIX[p.dtype]
    grad = torch.empty_like(p)
    launch(p, "xent_grad_from_probs" + tag,
           "mxt_xent_grad_from_probs" + sfx, p.data_ptr(), label.data_ptr(),
           grad.data_ptr(), p.shape[0], p.shape[1], float(scale))
    return grad


def _check_labels(name, x, label, *per_row):
    for t in (label,) + per_row:
        if t.shape != (x.shape[0],):
            raise KernelError("%s: per-row vector of shape %s, want (%d,)"
                              % (name, tuple(t.shape), x.shape[0]))


def softmax_rows_bwd(p, dy):
    """``p * (dy - sum(dy * p))`` per row of 2D ``p`` and ``dy``."""
    if not route("softmax_rows_bwd", p):
        return softmax_rows_bwd_reference(p, dy)
    _check_2d("softmax_rows_bwd", p)
    check_args("softmax_rows_bwd", p, dy)
    if dy.shape != p.shape:
        raise KernelError("softmax_rows_bwd: dy shape %s, want %s"
                          % (tuple(dy.shape), tuple(p.shape)))
    dx = torch.empty_like(p)
    launch(p, "softmax_rows_bwd", "mxt_softmax_rows_bwd_f32", p.data_ptr(),
           dy.data_ptr(), dx.data_ptr(), p.shape[0], p.shape[1])
    return dx


def xent_loss_rows(x, label):
    """Per-row ``logsumexp(x) - x[label]`` of 2D ``x`` (fp32 or bf16)
    and a ``(rows,)`` float32 label: ``(rows,)`` float32."""
    if not route("softmax_xent_loss", x):
        return xent_loss_rows_reference(x, label)
    _check_loss_args("softmax_xent_loss", x, label)
    tag, sfx = SUFFIX[x.dtype]
    loss = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    launch(x, "softmax_xent_loss" + tag, "mxt_softmax_xent_loss" + sfx,
           x.data_ptr(), label.data_ptr(), loss.data_ptr(), x.shape[0],
           x.shape[1])
    return loss


def softmax_xent_loss_grad(x, label, g):
    """``(softmax(x) - onehot(label)) * g[row]`` for 2D logits ``x``
    (fp32 or bf16; the gradient in ``x``'s dtype), recomputed from
    ``x``; ``label`` and ``g`` are ``(rows,)`` float32."""
    if not route("softmax_xent_loss_grad", x):
        return softmax_xent_loss_grad_reference(x, label, g)
    _check_loss_args("softmax_xent_loss_grad", x, label, g)
    tag, sfx = SUFFIX[x.dtype]
    grad = torch.empty_like(x)
    launch(x, "softmax_xent_loss_grad" + tag,
           "mxt_softmax_xent_loss_grad" + sfx, x.data_ptr(),
           label.data_ptr(), g.data_ptr(), grad.data_ptr(), x.shape[0],
           x.shape[1])
    return grad


class SoftmaxOutputHead(torch.autograd.Function):
    """``SoftmaxOutputHead.apply(data, label, scale)``: forward the row
    softmax, backward ``(p - onehot(label)) * scale`` from the saved
    ``(p, label)`` whatever cotangent arrives; no gradient for the
    label.  ``p`` is saved in ``data``'s dtype, so a bf16 head's
    gradient reads the rounded probabilities, as the reference's
    ``_head_fwd`` keeps them."""

    @staticmethod
    def forward(ctx, data, label, scale):
        p = softmax_rows(data)
        ctx.save_for_backward(p, label)
        ctx.scale = scale
        return p

    @staticmethod
    def backward(ctx, _ignored):
        p, label = ctx.saved_tensors
        return xent_grad_from_probs(p, label, ctx.scale), None, None


def softmax_output_head(data, label, scale=1.0):
    """SoftmaxOutput's plain 2D head: probabilities forward, the implicit
    cross-entropy gradient backward."""
    return SoftmaxOutputHead.apply(data, label, float(scale))


class FusedSoftmax(torch.autograd.Function):
    """``FusedSoftmax.apply(x)``: row softmax forward, the classic vjp
    ``p * (dy - sum(dy * p))`` backward from the saved ``p``."""

    @staticmethod
    def forward(ctx, x):
        if route("fused_softmax", x):   # its backward kernel is fp32 only
            check_args("fused_softmax", x)
        p = softmax_rows(x)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, dy):
        (p,) = ctx.saved_tensors
        return softmax_rows_bwd(p, dy.contiguous())


def fused_softmax(x):
    """Row softmax of 2D ``x`` with a kernel backward."""
    return FusedSoftmax.apply(x)


class SoftmaxXentLoss(torch.autograd.Function):
    """``SoftmaxXentLoss.apply(logits, label)``: per-row cross entropy
    forward; backward ``(softmax(x) - onehot(label)) * g`` recomputed
    from the saved logits; no gradient for the label."""

    @staticmethod
    def forward(ctx, logits, label):
        ctx.save_for_backward(logits, label)
        return xent_loss_rows(logits, label)

    @staticmethod
    def backward(ctx, g):
        logits, label = ctx.saved_tensors
        return softmax_xent_loss_grad(logits, label,
                                      g.float().contiguous()), None


def softmax_xent_loss(logits, label):
    """Per-row softmax cross entropy ``logsumexp(x) - x[label]`` of 2D
    logits, ``(rows,)`` float32; neither pass writes the ``(rows,
    classes)`` probabilities."""
    return SoftmaxXentLoss.apply(logits, label)
