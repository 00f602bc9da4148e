"""PyTorch/CUDA port of ``mxnet_tpu`` for one NVIDIA H100.

The port imports ``torch`` and never ``jax`` or ``mxnet_tpu``; the JAX
package stays the reference it is tested against.  Four paths are
ported.  Training the transformer LM through ``Module.fit``:

    import mxnet_tpu_torch as mx
    net = mx.models.transformer_lm(seq_len=256, num_layers=4,
                                   num_hidden=512, num_heads=8,
                                   vocab_size=8192)
    it = mx.io.NDArrayIter(X, y, batch_size=16)   # float32 token grids
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.005, "momentum": 0.9},
            initializer=mx.init.Xavier(),
            eval_metric=mx.metric.Perplexity(ignore_label=None))

training it imperatively, with ``mx.nd`` ops under ``mx.autograd``:

    w = mx.nd.array(weight)            # on the current context, cuda:0
    w.attach_grad()
    mom = mx.nd.zeros(w.shape)
    with mx.autograd.record():
        logits = mx.nd.FullyConnected(x, w, num_hidden=V, no_bias=True)
        loss = mx.nd.softmax_cross_entropy(logits, label)
    loss.backward()
    mx.nd.sgd_mom_update(w, w.grad, mom, lr=0.005, momentum=0.9, out=w)

training an image classifier, ResNet-50 with BatchNorm's moving
statistics as auxiliary states, as
``examples/image-classification/common/fit.py`` does:

    net = mx.models.resnet(num_classes=1000, num_layers=50)
    it = mx.io.SyntheticDataIter(1000, (32, 3, 224, 224), max_iter=100)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params={
                "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
                "lr_scheduler": mx.lr_scheduler.MultiFactorScheduler(
                    step=[30000, 60000], factor=0.1)},
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=mx.callback.Speedometer(32, 20))

serving ResNet-50 (or any symbol graph with batch-major outputs) on the
forward plane, requests batched continuously into bucketed programs:

    from mxnet_tpu_torch.serving import ModelRegistry, ServingEngine

    reg = ModelRegistry()
    reg.add_model("resnet", net, arg_params, aux_params,
                  input_shapes={"data": (1, 3, 224, 224)},
                  compute_dtype=None)     # or "bfloat16", "int8"
    with ServingEngine(reg) as eng:
        probs = eng.submit("resnet", data=images).result()[0].cpu()

(``mx.Predictor(json, params, shapes, serving=True)`` is the one-request
API over the same store), and serving the LM, on the paged KV plane by
default:

    from mxnet_tpu_torch.models import transformer_lm
    from mxnet_tpu_torch.serving import ModelRegistry, GenerationEngine

    spec = transformer_lm.lm_spec(num_layers=4, num_hidden=512,
                                  num_heads=8, vocab_size=8192)
    reg = ModelRegistry()
    reg.add_generative_model("lm", transformer_lm.random_params(spec), spec)
    with GenerationEngine(reg) as eng:
        print(eng.submit("lm", [1, 2, 3], max_tokens=8).result().tokens)

``add_generative_model(..., compute_dtype="int8", kv_dtype="int8")``
serves int8 weights over an int8 paged pool, ``paged=False`` the
contiguous KV plane.  Entry points run on the current context, ``cuda:0``
unless the caller passes ``mx.cpu()`` / ``device="cpu"`` or runs under
``with mx.cpu():``; without a GPU they raise.  RMSNorm and LayerNorm
(forward and backward), flash attention (causal and offset-causal),
paged attention (fp32 and int8 pools), the int8 dequant-matmul, the
SoftmaxOutput head, the softmax cross-entropy loss (forward and
gradient) and the fused softmax's backward run as hand-written CUDA
kernels on a CUDA tensor (``mxnet_tpu_torch/kernels``) and as their
plain PyTorch versions on a CPU tensor; ``mx.rtc.CudaKernel`` compiles
and launches a user's CUDA source on NDArrays.
"""
from . import (attribute, autograd, callback, contrib, deploy, engine,
               executor, initializer, io, kernels, lr_scheduler, metric,
               model, models, monitor, name, ndarray, optimizer, parallel,
               predictor, random, rnn, rtc, symbol, test_utils)
from . import module
from .attribute import AttrScope
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_devices)
from .initializer import init_registry
from .models import transformer_lm
from .module import Module
from .monitor import Monitor
from .name import NameManager, Prefix
from .optimizer import Optimizer
from .predictor import Predictor
from .serving import GenerationEngine, ModelRegistry, TokenStream
from .symbol import Variable

sym = symbol
nd = ndarray
init = initializer
mod = module

__all__ = ["MXNetError", "ModelRegistry", "GenerationEngine", "TokenStream",
           "transformer_lm", "kernels", "models", "symbol", "sym", "ndarray",
           "nd", "io", "initializer", "init", "metric", "optimizer", "model",
           "lr_scheduler", "callback", "rnn", "monitor", "parallel",
           "random", "module", "mod", "Module", "cpu", "gpu", "autograd",
           "contrib", "rtc", "engine", "Context", "current_context",
           "attribute", "AttrScope", "name", "NameManager", "Prefix",
           "executor", "Variable", "Monitor", "Optimizer", "init_registry",
           "cpu_pinned", "num_devices", "Predictor", "predictor", "deploy",
           "test_utils"]
