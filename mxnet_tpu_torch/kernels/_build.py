"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, loaded with ``ctypes``.
The build happens on first CUDA use, never at import: the library lands
in ``kernels/_build/`` (ignored by git) under a name that hashes the
sources and flags, so an edited source rebuilds and an unchanged one
loads the existing library.  Each source compiles in its own ``nvcc``
process, all started together, and one more ``nvcc`` call links them.

Every C entry point takes raw device pointers, plain ints and floats and
the CUDA stream, launches on that stream without synchronising, and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into
:class:`KernelError`.  The wrappers route by device with :func:`route`,
refuse what a kernel does not take with :func:`check_args`, and call an
entry point with :func:`launch`, which counts the launch.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

from ..base import MXNetError
from . import count_launch

__all__ = ["KernelError", "library", "check", "build_info", "route",
           "check_args", "align_bytes", "launch", "sm_count", "SUFFIX"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# dtype -> (launch-count suffix, C entry point suffix) of the row kernels
# that take fp32 and bf16 (the norms, SoftmaxOutput's head,
# softmax_xent_loss)
SUFFIX = {torch.float32: ("", "_f32"), torch.bfloat16: ("_bf16", "_bf16")}
# C entry point -> argtypes; every entry point returns a cudaError_t
_SIGNATURES = {
    # x, gamma, y, rows, width, eps, stream
    "mxt_rms_norm_f32": (_P, _P, _P, _I, _I, _F, _P),
    # x, gamma, beta, y, rows, width, eps, stream
    "mxt_layer_norm_f32": (_P, _P, _P, _P, _I, _I, _F, _P),
    # the same in bf16 (x, gamma, beta and y all bf16)
    "mxt_rms_norm_bf16": (_P, _P, _P, _I, _I, _F, _P),
    "mxt_layer_norm_bf16": (_P, _P, _P, _P, _I, _I, _F, _P),
    # x, gamma, dy, dx, dgamma, dgamma_partials, rows, width, eps, path,
    # rows_per_warp, stream (norm.py::_bwd_plan)
    "mxt_rms_norm_bwd_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I,
                             _P),
    # x, gamma, dy, dx, dgamma, dbeta, dgamma_partials, dbeta_partials,
    # rows, width, eps, path, rows_per_warp, stream
    "mxt_layer_norm_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                               _I, _I, _P),
    # the same two in bf16 (x, gamma, dy, dx and the weight gradients
    # bf16, the partials fp32)
    "mxt_rms_norm_bwd_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I,
                              _P),
    "mxt_layer_norm_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                                _I, _I, _P),
    # x, p, rows, cols, path, loads, stream (softmax_xent.py::_plan)
    "mxt_softmax_rows_f32": (_P, _P, _I, _I, _I, _I, _P),
    # p, label, grad, rows, cols, scale, stream
    "mxt_xent_grad_from_probs_f32": (_P, _P, _P, _I, _I, _F, _P),
    # the same two with bf16 x, p and grad (the label float32)
    "mxt_softmax_rows_bf16": (_P, _P, _I, _I, _I, _I, _P),
    "mxt_xent_grad_from_probs_bf16": (_P, _P, _P, _I, _I, _F, _P),
    # x, label, loss, rows, cols, stream
    "mxt_softmax_xent_loss_f32": (_P, _P, _P, _I, _I, _P),
    # x, label, g, grad, rows, cols, stream
    "mxt_softmax_xent_loss_grad_f32": (_P, _P, _P, _P, _I, _I, _P),
    # the same two with bf16 x and grad (label, loss and g float32)
    "mxt_softmax_xent_loss_bf16": (_P, _P, _P, _I, _I, _P),
    "mxt_softmax_xent_loss_grad_bf16": (_P, _P, _P, _P, _I, _I, _P),
    # p, dy, dx, rows, cols, stream
    "mxt_softmax_rows_bwd_f32": (_P, _P, _P, _I, _I, _P),
    # q, k, v, out, B*H, Lq, Lk, D, causal, scale, path, block_q, stream
    # (flash_attention.py::_plan)
    "mxt_flash_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                _I, _I, _P),
    # the same with bf16 q, k, v and out
    "mxt_flash_attention_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                 _I, _I, _P),
    # q, k, v, offsets, out, B, H, Lq, Lk, D, scale, path, block_q, stream
    "mxt_flash_attention_offset_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _F, _I, _I, _P),
    # the same with bf16 q, k, v and out
    "mxt_flash_attention_offset_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _F, _I, _I, _P),
    # q, k_pool, v_pool, tables, positions, out, B, H, Lq, D, T,
    # block_size, pool_rows, scale, path, block_q, stream
    # (paged_attention.py::_plan)
    "mxt_paged_attention_f32": (_P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    # the same with bf16 q, pools and out
    "mxt_paged_attention_bf16": (_P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                                 _P),
    # q, k_codes, v_codes, k_scale, v_scale, tables, positions, out,
    # B, H, Lq, D, T, block_size, pool_rows, scale, path, block_q, stream
    "mxt_paged_attention_i8": (_P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    # x, codes, scales, out, M, N, K, k_slice, splits, stream (the decode
    # GEMV's split of K; k_slice 0: the prefill tile)
    "mxt_dequant_matmul_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
_info = {}


class KernelError(MXNetError, ValueError):
    """A kernel failed to build, load or launch, or was handed tensors it
    does not take (a ``ValueError`` as well, for the argument checks)."""


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelError("nvcc not found on PATH or under %s/bin; the "
                          "CUDA kernels cannot be built" % home)
    return path


def _compile(out_path):
    """nvcc every source to an object in parallel, then link the shared
    library; raises KernelError with nvcc's stderr on failure.  Returns
    the compilers' stderr (the ``-Xptxas=-v`` register report)."""
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build-", dir=_BUILD)
    try:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log, failed = [], []
        for src, _obj, proc in procs:
            out, err = proc.communicate()
            log.append("== %s\n%s%s" % (os.path.basename(src), out, err))
            if proc.returncode != 0:
                failed.append(os.path.basename(src))
        if failed:
            raise KernelError("nvcc failed on %s:\n%s"
                              % (", ".join(failed), "\n".join(log)))
        lib_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", lib_tmp,
             *[obj for _s, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        if link.returncode != 0:
            raise KernelError("nvcc link failed:\n%s%s"
                              % (link.stdout, link.stderr))
        os.replace(lib_tmp, out_path)
        return "\n".join(log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library():
    """The loaded kernel library, built on first call (thread-safe: the
    engine thread and the caller's thread may both get here first)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        tic = time.perf_counter()
        path = os.path.join(_BUILD, "libmxtt_kernels_%s.so" % _digest())
        built = not os.path.exists(path)
        log = _compile(path) if built else ""
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _info.update(path=path, built=built, log=log,
                     seconds=time.perf_counter() - tic)
        _lib = lib
        return lib


def build_info():
    """Path, whether this process compiled it, the nvcc log and the
    seconds :func:`library` took (empty before the first build)."""
    with _lock:
        return dict(_info)


def check(code, name):
    """Raise KernelError when a C entry point returned a CUDA error."""
    if code != 0:
        raise KernelError("%s: CUDA error %d at launch" % (name, code))


def route(name, x):
    """True for the CUDA kernel (``x`` on a CUDA device), False for the
    plain version (``x`` on the CPU); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise KernelError("%s: no kernel for device %s" % (name, x.device))
    return True


def check_args(name, *tensors, dtypes=(torch.float32,)):
    """Refuse what a CUDA kernel does not take: tensors on different
    devices, a dtype outside ``dtypes`` or other than the first
    tensor's (a kernel has one element type), a non-contiguous
    layout."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise KernelError("%s: all tensors must be on %s, got %s"
                              % (name, dev, t.device))
        if t.dtype not in dtypes or t.dtype != dtype:
            raise KernelError(
                "%s: the CUDA kernel takes %s, all of one dtype, got %s"
                % (name, " or ".join(str(d).replace("torch.", "")
                                     for d in dtypes), t.dtype))
        if not t.is_contiguous():
            raise KernelError("%s: tensors must be contiguous" % name)


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def align_bytes(*tensors):
    """The bytes every tensor's start is a multiple of, up to 16 (the
    widest access a kernel makes)."""
    align = 16
    while any(t.data_ptr() % align for t in tensors):
        align //= 2
    return align


def launch(x, name, entry, *args):
    """Call C entry point ``entry`` on ``x``'s device and current stream,
    raise on a CUDA error, and count one launch of ``name``."""
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        check(getattr(lib, entry)(*args, stream), name)
    count_launch(name)
