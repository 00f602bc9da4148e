"""Int8 weight-only quantization: the codec, the weight carrier and the
fused dequant-matmul kernel.

Counterpart of ``mxnet_tpu/pallas_ops/dequant_matmul.py``.  Serving
weights are read-only, so their precision is a storage decision:
symmetric int8 codes with one fp32 scale per output row (``'row'``) or
per weight (``'tensor'``, ``MXNET_SERVE_INT8_GRANULARITY``).

* codec: :func:`quantize_int8` / :func:`dequantize_int8`, numpy, copied
  from the reference so that the codes are the same bits;
* carrier: :class:`QuantizedWeight`, a ``(codes int8, scales fp32)``
  pair of tensors;
* kernel: :func:`dequant_matmul`, ``y = x @ dequant(codes)^T`` with the
  codes widened to fp32 on the tile, fp32 accumulation over K and the
  per-row scale applied once after the K reduction.  A CPU tensor runs
  the plain version :func:`dequant_matmul_dense` (the same association:
  the scale multiplies the finished product); a CUDA tensor launches
  ``csrc/dequant_matmul.cu`` or raises.  Forward only.  The kernel has
  two regimes, which :func:`_plan` picks from the shape: a split-K GEMV
  for M <= 32 (the decode buckets) and a 2xTF32 tensor-core tile above.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..base import MXNetError, get_env
from ._build import KernelError, launch, route, sm_count as _sm_count

__all__ = ["scale_granularity", "quantize_int8", "dequantize_int8",
           "QuantizedWeight", "dequant_matmul", "dequant_matmul_dense"]

K_MULTIPLE = 16   # the kernel stages 16-byte rows of codes
GEMV_MAX_M = 32   # the largest decode bucket
GEMV_COLS = 16    # output columns of a GEMV CTA
GEMV_MAX_SPLITS = 8   # a slab's slices form one cluster: at most 8 CTAs

Plan = collections.namedtuple("Plan", "k_slice splits")


def _plan(M, N, K, sm_count):
    """The split of one ``dequant_matmul`` launch with M, N, K > 0.  For
    M <= 32, the GEMV's K slice (a multiple of 16; the last slice may be
    shorter) and slice count, at most 8: enough slices of each 16-column
    slab to fill one wave of ``sm_count`` SMs where 8 slices can.  Above,
    ``Plan(0, 1)``: the tensor-core tile, which does not split K."""
    if M > GEMV_MAX_M:
        return Plan(0, 1)
    slabs = -(-N // GEMV_COLS)
    want = min(GEMV_MAX_SPLITS, -(-sm_count // slabs))
    k_slice = -(-K // want)                        # rounded up to 16
    k_slice = -(-k_slice // K_MULTIPLE) * K_MULTIPLE
    return Plan(k_slice, -(-K // k_slice))


def scale_granularity():
    """``'row'`` (default) or ``'tensor'`` —
    ``MXNET_SERVE_INT8_GRANULARITY``."""
    g = str(get_env("MXNET_SERVE_INT8_GRANULARITY") or "row").lower()
    if g not in ("row", "tensor"):
        raise MXNetError(
            "MXNET_SERVE_INT8_GRANULARITY must be 'row' or 'tensor', "
            "got %r" % g)
    return g


def quantize_int8(w, granularity=None):
    """Symmetric absmax int8 quantization of a 2D weight.

    ``'row'`` -> ``codes (N, K) int8`` and ``scales (N,) fp32``, one per
    output row; ``'tensor'`` -> one scalar scale.  All-zero rows get
    scale 1.  ``|w - codes * scale| <= scale / 2``."""
    w = np.asarray(w, np.float32)
    if w.ndim != 2:
        raise MXNetError("quantize_int8 wants a 2D weight, got shape %s"
                         % (w.shape,))
    g = granularity or scale_granularity()
    absmax = np.abs(w).max(axis=1) if g == "row" else \
        np.asarray(np.abs(w).max())
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(w / scales.reshape(-1, 1)
                            if g == "row" else w / scales),
                    -127, 127).astype(np.int8)
    return codes, scales


def dequantize_int8(codes, scales):
    """fp32 ``codes * scales``, row scales broadcast over columns."""
    c = np.asarray(codes).astype(np.float32)
    s = np.asarray(scales, np.float32)
    return c * (s.reshape(-1, 1) if s.ndim else s)


class QuantizedWeight:
    """``(codes int8 (N, K), scales fp32 (N,) or ())`` tensors of one
    quantized 2D weight, on one device."""

    __slots__ = ("codes", "scales")

    def __init__(self, codes, scales):
        self.codes = codes
        self.scales = scales

    @property
    def shape(self):
        return tuple(self.codes.shape)

    @property
    def dtype(self):  # storage dtype
        return torch.int8

    def dequantize(self):
        s = self.scales.float()
        return self.codes.float() * (s.reshape(-1, 1) if s.dim() else s)

    def __repr__(self):
        return "QuantizedWeight(%s, scales=%s)" % (
            tuple(self.codes.shape), tuple(self.scales.shape))


def dequant_matmul_dense(x, codes, scales):
    """Plain PyTorch twin: ``(x @ codes.float().T) * scales``, the scale
    applied after the K reduction as in the kernel."""
    prod = torch.matmul(x.float(), codes.float().t())
    return prod * scales.float().reshape(-1)


def _check(x, codes, scales):
    if x.dim() != 2 or codes.dim() != 2 or x.shape[1] != codes.shape[1]:
        raise KernelError("dequant_matmul: x (M, K) and codes (N, K) "
                          "expected, got %s / %s"
                          % (tuple(x.shape), tuple(codes.shape)))
    K = x.shape[1]
    if K == 0 or K % K_MULTIPLE:
        raise KernelError("dequant_matmul: the CUDA kernel takes K a "
                          "positive multiple of %d, got %d"
                          % (K_MULTIPLE, K))
    for name, t, dtype in (("x", x, torch.float32),
                           ("codes", codes, torch.int8),
                           ("scales", scales, torch.float32)):
        if t.device != x.device:
            raise KernelError("dequant_matmul: %s on %s, x on %s"
                              % (name, t.device, x.device))
        if t.dtype != dtype:
            raise KernelError("dequant_matmul: %s must be %s, got %s"
                              % (name, dtype, t.dtype))
        if not t.is_contiguous():
            raise KernelError("dequant_matmul: %s must be contiguous"
                              % name)
    if x.data_ptr() % 16 or codes.data_ptr() % 16:
        raise KernelError("dequant_matmul: x and codes must be 16-byte "
                          "aligned")
    if scales.shape != (codes.shape[0],):
        raise KernelError("dequant_matmul: scales must be (N,) = (%d,), "
                          "got %s" % (codes.shape[0], tuple(scales.shape)))


def dequant_matmul(x, codes, scales):
    """``x (M, K) fp32 @ dequant(codes (N, K) int8, scales)^T -> (M, N)
    fp32``.  ``scales`` is ``(N,)`` or a scalar (``'tensor'``
    granularity, broadcast to ``(N,)`` before the launch).  The CUDA
    kernel takes contiguous, 16-byte aligned fp32 ``x`` and int8
    ``codes`` with K a multiple of 16."""
    if not route("dequant_matmul", x):
        return dequant_matmul_dense(x, codes, scales)
    N = codes.shape[0]
    if scales.dim() == 0 or scales.numel() == 1:
        scales = scales.reshape(1).expand(N).contiguous()
    _check(x, codes, scales)
    M, K = x.shape
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M * N == 0:
        return out
    plan = _plan(M, N, K, _sm_count(x.device.index))
    launch(x, "dequant_matmul", "mxt_dequant_matmul_f32", x.data_ptr(),
           codes.data_ptr(), scales.data_ptr(), out.data_ptr(), M, N, K,
           plan.k_slice, plan.splits)
    return out
