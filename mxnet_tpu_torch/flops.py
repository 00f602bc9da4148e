"""Step cost introspection: model FLOPs and memory (counterpart of
``mxnet_tpu/flops.py``).

The reference reads FLOPs and temporary bytes from the compiled XLA
program.  The port runs eagerly and has no compiled program to ask, so
:func:`compiled_cost` runs one real call of the step under
``torch.utils.flop_counter.FlopCounterMode``, which counts the FLOPs of
every matrix product and convolution (forward and backward) the call
dispatches, and reads the device's peak allocation over that call.  It
runs the step, so callers hand it copies of any state the step updates
(``DataParallelTrainer.step_cost_analysis`` does), and it is a one-shot
diagnostic, never a per-step call.  Element-wise work is not counted:
FLOPs here are those of the products, the numerator of an MFU claim.

``PEAK_BF16_FLOPS`` is the table of dense bf16 peaks by device name:
NVIDIA's data sheet value for the H100 SXM, and the reference's TPU
table values, kept as table values.
"""
from __future__ import annotations

import torch

__all__ = ["compiled_cost", "peak_bf16_flops", "mfu_proxy",
           "PEAK_BF16_FLOPS"]

# Peak dense bf16 FLOP/s per device, keyed by a substring of the
# lowercased device name (torch.cuda.get_device_name), first match wins
PEAK_BF16_FLOPS = [("h100", 989e12),
                   ("v6e", 918e12), ("v6", 918e12), ("v5p", 459e12),
                   ("v5litepod", 197e12), ("v5 lite", 197e12),
                   ("v5e", 197e12), ("v4", 275e12), ("v3", 61.4e12),
                   ("v2", 22.5e12)]


def peak_bf16_flops(device_kind):
    """Table peak bf16 FLOP/s for a device name (None if unknown: CPU
    rows report the FLOP count without an MFU claim)."""
    k = str(device_kind).lower().replace("_", " ")
    for key, val in PEAK_BF16_FLOPS:
        if key in k:
            return val
    return None


def _cuda_device(args):
    """The CUDA device of the first CUDA tensor among ``args`` (nested
    dicts, lists and tuples), or None."""
    stack = list(args)
    while stack:
        a = stack.pop()
        if isinstance(a, torch.Tensor):
            if a.is_cuda:
                return a.device
        elif isinstance(a, dict):
            stack.extend(a.values())
        elif isinstance(a, (list, tuple)):
            stack.extend(a)
    return None


def compiled_cost(fn, *args, **kwargs):
    """FLOPs and memory of one call ``fn(*args, **kwargs)``.

    Returns ``{"flops", "temp_bytes"}``: the FLOPs the call's products
    and convolutions dispatched (None when it dispatched none), and, on
    a CUDA device, the peak of ``torch.cuda.max_memory_allocated`` over
    the call less the bytes allocated before it (None on the CPU).  The
    device's peak-memory statistic is reset for the call.  Returns None
    when the call cannot be counted; callers treat the result as
    diagnostic, never load-bearing."""
    try:
        from torch.utils.flop_counter import FlopCounterMode
    except ImportError:
        return None
    dev = _cuda_device(list(args) + list(kwargs.values()))
    before = None
    if dev is not None:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            fn(*args, **kwargs)
    except (RuntimeError, TypeError, ValueError, NotImplementedError):
        return None
    flops = counter.get_total_flops()
    out = {"flops": float(flops) if flops > 0 else None, "temp_bytes": None}
    if dev is not None:
        torch.cuda.synchronize(dev)
        out["temp_bytes"] = int(torch.cuda.max_memory_allocated(dev) -
                                before)
    return out


def mfu_proxy(flops_per_step, steps_per_sec, peak_flops, n_devices=1):
    """Counted-FLOPs MFU: FLOPs per step over the measured step rate,
    against the table peak.  None when either side is unknown."""
    if not flops_per_step or not steps_per_sec or not peak_flops:
        return None
    return round(flops_per_step * steps_per_sec /
                 (peak_flops * max(1, n_devices)), 4)
