"""The port's ``rtc`` door (``mx.rtc.CudaKernel``) without a card: the
generated launcher, the argument checks, and that a CPU push raises
(CUDA source has no plain version to fall back on).  The launches
themselves run on the card (``tests/test_torch_cuda.py``)."""
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels import launch_counts
from mxnet_tpu_torch.kernels._build import KernelError
from mxnet_tpu_torch.rtc import CudaKernel, launcher_source

FMA1 = r'''
extern "C" __global__ void fma1(const float* x, const float* y, float* o,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * y[i] + 1.0f;
}
'''


@pytest.mark.parametrize("n_in,n_out", [(2, 1), (1, 1), (3, 2), (0, 1)])
def test_launcher_stub_text_and_arity(n_in, n_out):
    text = launcher_source("fma1", n_in, n_out)
    k = n_in + n_out
    assert 'extern "C" int mxt_rtc_launch(void* const* ptrs, int n' in text
    assert "params<decltype(fma1)>::type" in text
    assert "std::tuple_size<P>::value == %d" % (k + 1) in text
    assert "std::tuple_element_t<%d, P>, int>::value" % k in text
    casts = re.findall(r"static_cast<std::tuple_element_t<(\d+), P>>"
                       r"\(ptrs\[(\d+)\]\)", text)
    assert casts == [(str(i), str(i)) for i in range(k)]
    assert "fma1<<<dim3(gx, gy, gz), dim3(bx, by, bz), 0, stream>>>(" \
        in text
    assert text.rstrip().endswith("return static_cast<int>("
                                  "cudaGetLastError());\n}")
    assert "%d inputs, %d outputs" % (n_in, n_out) in text


def _cpu(*shape, dtype=torch.float32):
    return tmx.nd.NDArray(torch.zeros(shape, dtype=dtype))


def test_push_refuses_bad_arguments():
    k = CudaKernel("fma1", FMA1)
    x = _cpu(4, 3)
    refusals = [
        ([x, np.ones(3)], [x], {}, "push takes NDArrays"),
        ([x, _cpu(3, dtype=torch.float64)], [x], {}, "float32 or int32"),
        ([x, tmx.nd.NDArray(torch.zeros(3, 4).t())], [x], {},
         "contiguous"),
        ([x, tmx.nd.NDArray(torch.zeros(3, device="meta"))], [x], {},
         "one device"),
        ([x], [], {}, "at least one output"),
        ([x], [x], {"grid_dims": (0,)}, "grid_dims"),
        ([x], [x], {"block_dims": (1, 2, 3, 4)}, "block_dims"),
        ([x], [x], {"block_dims": 2.5}, "block_dims"),
    ]
    before = launch_counts()["rtc"]
    for ins, outs, kw, match in refusals:
        with pytest.raises(KernelError, match=match):
            k.push(ins, outs, **kw)
    assert launch_counts()["rtc"] == before
    with pytest.raises(KernelError, match="C identifier"):
        CudaKernel("fma-1", FMA1)


def test_cpu_push_raises_naming_the_card():
    k = CudaKernel("fma1", FMA1)
    with tmx.cpu():
        x, y = tmx.nd.ones((8,)), tmx.nd.ones((8,))
        out = tmx.nd.empty((8,))
        for call in (lambda: k.push([x, y], [out]),
                     lambda: k.push([x, y], out, grid_dims=(1,),
                                    block_dims=(8,)),
                     lambda: k(x, y)):
            with pytest.raises(KernelError, match="CUDA device"):
                call()
        i = tmx.nd.array(np.arange(8, dtype=np.int32))
        with pytest.raises(KernelError, match="no CPU version"):
            k.push([i, i], [i])
    assert not np.any(out.asnumpy())


def test_mxrtc_raises_in_both_packages():
    with pytest.raises(tmx.MXNetError, match="CudaKernel"):
        tmx.rtc.MXRtc("fma1", [("x", None)], [("o", None)], FMA1)
    with pytest.raises(jmx.MXNetError):
        jmx.rtc.MXRtc("fma1", [("x", None)], [("o", None)], FMA1)
