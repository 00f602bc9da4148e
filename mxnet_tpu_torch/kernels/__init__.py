"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

Every wrapper routes by the device of the tensors it is given: a CPU
tensor takes the plain version, a CUDA tensor launches the CUDA kernel
(built on first use by :mod:`._build`) or raises.  Each launch adds one
to the wrapper's count in :func:`launch_counts`, so a run can show that
its path went through the kernels.
"""
from __future__ import annotations

import threading

__all__ = ["launch_counts", "reset_launch_counts", "KERNELS"]

# wrapper name -> launches of its CUDA kernel since the last reset
KERNELS = ("rms_norm", "layer_norm", "flash_attention_paged")
_counts = dict.fromkeys(KERNELS, 0)
_counts_lock = threading.Lock()


def count_launch(name):
    with _counts_lock:
        _counts[name] += 1


def launch_counts():
    """{wrapper name: CUDA launches since the last reset}."""
    with _counts_lock:
        return dict(_counts)


def reset_launch_counts():
    with _counts_lock:
        for name in _counts:
            _counts[name] = 0
