"""Runtime-compiled user kernels on NDArrays (counterpart of
``mxnet_tpu/rtc.py``, whose door is ``PallasKernel``).

The reference MXNet compiled raw CUDA source with NVRTC and launched it
on NDArrays (``MXRtc::push``).  Here the user hands CUDA C++ text that
defines ``extern "C" __global__ void <name>(...)`` with one pointer per
input, then one per output, then ``int n``, the element count of the
first output (the Pallas convention of one ref per input, then per
output):

    src = r'''
    extern "C" __global__ void fma1(const float* x, const float* y,
                                    float* o, int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) o[i] = x[i] * y[i] + 1.0f;
    }'''
    k = mx.rtc.CudaKernel("fma1", src)
    out = k.push([x, y], [mx.nd.empty(x.shape)])

At the first ``push`` of an arity the source is compiled with ``nvcc``
and ``kernels._build.NVCC_FLAGS`` together with a launcher stub
generated for that arity (:func:`launcher_source`), which casts each
pointer to the kernel's own parameter type.  The shared library lands in
``kernels/_build/rtc/`` (ignored by git) under a name that hashes the
source and flags, is loaded with ``ctypes``, and launches on the current
CUDA stream.  Tensors must be float32 or int32, contiguous and on one
CUDA device: a CUDA source has no plain version to run on the CPU, so a
CPU tensor raises :class:`~.kernels._build.KernelError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

import torch

from .base import MXNetError
from .kernels import count_launch
from .kernels import _build
from .kernels._build import KernelError
from .ndarray import NDArray, empty

__all__ = ["CudaKernel", "MXRtc", "launcher_source"]

_RTC_DIR = os.path.join(_build._BUILD, "rtc")
_DTYPES = (torch.float32, torch.int32)
_THREADS = 256


def launcher_source(name, num_inputs, num_outputs):
    """C++ text of the launcher for kernel ``name`` taking
    ``num_inputs + num_outputs`` pointers and then ``int n``: an
    ``extern "C"`` entry ``mxt_rtc_launch(ptrs, n, gx, gy, gz, bx, by,
    bz, stream)`` that launches ``name`` on ``stream`` and returns
    ``cudaGetLastError()``.  The pointer types come from the kernel's own
    signature; a kernel of another arity fails to compile."""
    k = num_inputs + num_outputs
    casts = ",\n".join(
        "      static_cast<std::tuple_element_t<%d, P>>(ptrs[%d])" % (i, i)
        for i in range(k))
    return """
// launcher of %(name)s: %(ni)d inputs, %(no)d outputs, then int n
#include <cuda_runtime.h>
#include <tuple>
#include <type_traits>
namespace mxt_rtc {
template <typename F> struct params;
template <typename... A> struct params<void(A...)> {
  using type = std::tuple<A...>;
};
}  // namespace mxt_rtc
extern "C" int mxt_rtc_launch(void* const* ptrs, int n, int gx, int gy,
                              int gz, int bx, int by, int bz,
                              cudaStream_t stream) {
  using P = mxt_rtc::params<decltype(%(name)s)>::type;
  static_assert(std::tuple_size<P>::value == %(k1)d,
                "%(name)s must take %(k)d pointers, then int n");
  static_assert(std::is_same<std::tuple_element_t<%(k)d, P>, int>::value,
                "the last parameter of %(name)s must be int n");
  %(name)s<<<dim3(gx, gy, gz), dim3(bx, by, bz), 0, stream>>>(
%(casts)s,
      n);
  return static_cast<int>(cudaGetLastError());
}
""" % dict(name=name, ni=num_inputs, no=num_outputs, k=k, k1=k + 1,
           casts=casts)


def _dims3(dims, what):
    if dims is None:
        return None
    dims = tuple(dims) if isinstance(dims, (tuple, list)) else (dims,)
    if not 1 <= len(dims) <= 3 or not all(
            isinstance(d, int) and d > 0 for d in dims):
        raise KernelError("rtc: %s must be 1 to 3 positive ints, got %r"
                          % (what, dims))
    return dims + (1,) * (3 - len(dims))


def _tensor(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    raise KernelError("rtc: push takes NDArrays, got %s" % type(x).__name__)


class CudaKernel:
    """A user CUDA kernel launched on NDArrays (see the module
    docstring for the source's convention)."""

    def __init__(self, name, source):
        if not re.fullmatch(r"[A-Za-z_]\w*", str(name)):
            raise KernelError("rtc: kernel name %r is not a C identifier"
                              % (name,))
        self.name = name
        self.source = source
        self._libs = {}   # (num_inputs, num_outputs) -> ctypes library
        self._lock = threading.Lock()

    def _library(self, num_inputs, num_outputs):
        """The compiled library for this arity, built on first use."""
        key = (num_inputs, num_outputs)
        with self._lock:
            lib = self._libs.get(key)
            if lib is not None:
                return lib
            text = self.source + "\n" + launcher_source(self.name, *key)
            digest = hashlib.sha256(
                (" ".join(_build.NVCC_FLAGS) + "\0" + text).encode()
            ).hexdigest()[:16]
            path = os.path.join(_RTC_DIR, "librtc_%s_%s.so"
                                % (self.name, digest))
            if not os.path.exists(path):
                _compile(text, path)
            lib = ctypes.CDLL(path)
            fn = lib.mxt_rtc_launch
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] + \
                [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._libs[key] = lib
            return lib

    def push(self, ins, outs, grid_dims=None, block_dims=None):
        """Launch on NDArrays; the kernel writes ``outs`` in place.
        ``grid_dims`` / ``block_dims`` (up to three ints each) default to
        ``ceil(n / 256)`` blocks of 256 threads, ``n`` the element count
        of the first output.  Returns ``outs[0]`` for one output, else
        the list."""
        if not isinstance(ins, (list, tuple)):
            ins = [ins]
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        if not outs:
            raise KernelError("rtc: push needs at least one output")
        tensors = [_tensor(x) for x in list(ins) + list(outs)]
        grid = _dims3(grid_dims, "grid_dims")
        block = _dims3(block_dims, "block_dims") or (_THREADS, 1, 1)
        dev = tensors[0].device
        for t in tensors:
            if t.dtype not in _DTYPES:
                raise KernelError("rtc: tensors must be float32 or int32, "
                                  "got %s" % t.dtype)
            if not t.is_contiguous():
                raise KernelError("rtc: tensors must be contiguous")
            if t.device != dev:
                raise KernelError("rtc: all tensors must be on one device, "
                                  "got %s and %s" % (dev, t.device))
        if dev.type != "cuda":
            raise KernelError(
                "rtc: %s is CUDA source and runs only on a CUDA device (the "
                "card); it has no CPU version, got tensors on %s"
                % (self.name, dev))
        n = tensors[len(ins)].numel()
        if n >= 2 ** 31:
            raise KernelError("rtc: n = %d does not fit an int" % n)
        if grid is None:
            if n == 0:
                return outs[0] if len(outs) == 1 else list(outs)
            grid = (-(-n // block[0]), 1, 1)
        lib = self._library(len(ins), len(outs))
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[t.data_ptr() for t in tensors])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _build.check(lib.mxt_rtc_launch(ptrs, n, *grid, *block, stream),
                         "rtc " + self.name)
        count_launch("rtc")
        return outs[0] if len(outs) == 1 else list(outs)

    def __call__(self, *ins):
        """Functional form: one output shaped like the first input."""
        x = ins[0]
        out = empty(x.shape, ctx=x.context, dtype=x.dtype)
        return self.push(list(ins), [out])


def _compile(text, out_path):
    """nvcc ``text`` into shared library ``out_path``; KernelError with
    nvcc's output on failure."""
    nvcc = _build._nvcc()
    os.makedirs(_RTC_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="rtc-", dir=_RTC_DIR)
    try:
        src = os.path.join(tmp, "kernel.cu")
        with open(src, "w") as f:
            f.write(text)
        lib_tmp = os.path.join(tmp, "lib.so")
        proc = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib_tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        if proc.returncode != 0:
            raise KernelError("rtc: nvcc failed:\n%s%s"
                              % (proc.stdout, proc.stderr))
        os.replace(lib_tmp, out_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class MXRtc:
    """The reference's raw-CUDA ``MXRtc(name, inputs, outputs, kernel)``.
    Not provided, as in the JAX package: write the kernel as CUDA source
    for :class:`CudaKernel`."""

    def __init__(self, name, inputs, outputs, kernel):
        raise MXNetError(
            "mx.rtc.MXRtc is not provided; pass the CUDA source of an "
            "extern \"C\" __global__ kernel to mx.rtc.CudaKernel(name, "
            "source) and launch it with push(ins, outs)")
