"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

Every wrapper routes by the device of the tensors it is given: a CPU
tensor takes the plain version, a CUDA tensor launches the CUDA kernel
(built on first use by :mod:`._build`) or raises.  Each launch adds one
to the wrapper's count in :func:`launch_counts`, so a run can show that
its path went through the kernels; a wrapper that plans one of several
bodies also adds one to ``name[body]`` in :func:`body_counts`.
"""
from __future__ import annotations

import threading

__all__ = ["launch_counts", "body_counts", "reset_launch_counts",
           "KERNELS"]

# wrapper name -> launches of its CUDA kernel since the last reset
KERNELS = ("rms_norm", "layer_norm", "flash_attention_paged",
           "rms_norm_bwd", "layer_norm_bwd", "softmax_rows",
           "xent_grad_from_probs", "flash_attention", "dequant_matmul",
           "flash_attention_paged_int8", "flash_attention_offset",
           "softmax_xent_loss", "softmax_xent_loss_grad", "softmax_rows_bwd",
           "rtc", "rms_norm_bf16", "layer_norm_bf16",
           "flash_attention_paged_bf16", "flash_attention_bf16",
           "flash_attention_offset_bf16", "rms_norm_bwd_bf16",
           "layer_norm_bwd_bf16", "softmax_rows_bf16",
           "xent_grad_from_probs_bf16", "softmax_xent_loss_bf16",
           "softmax_xent_loss_grad_bf16")
_counts = dict.fromkeys(KERNELS, 0)
# "name[body]" -> launches of that body since the last reset
_bodies = {}
_counts_lock = threading.Lock()


def count_launch(name):
    with _counts_lock:
        _counts[name] += 1


def count_body(name, body):
    """One launch of ``name``'s planned ``body``, counted by the wrapper
    right after the launch itself."""
    key = "%s[%s]" % (name, body)
    with _counts_lock:
        _bodies[key] = _bodies.get(key, 0) + 1


def launch_counts():
    """{wrapper name: CUDA launches since the last reset}."""
    with _counts_lock:
        return dict(_counts)


def body_counts():
    """{"name[body]": CUDA launches of that body since the last reset},
    for the wrappers that plan a body (``softmax_rows``)."""
    with _counts_lock:
        return dict(_bodies)


def reset_launch_counts():
    with _counts_lock:
        for name in _counts:
            _counts[name] = 0
        _bodies.clear()
