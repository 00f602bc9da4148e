"""PyTorch/CUDA port of ``mxnet_tpu`` for one NVIDIA H100.

The port imports ``torch`` and never ``jax`` or ``mxnet_tpu``; the JAX
package stays the reference it is tested against.  Two paths are
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

and serving it on the paged KV plane:

    from mxnet_tpu_torch.models import transformer_lm
    from mxnet_tpu_torch.serving import ModelRegistry, GenerationEngine

    spec = transformer_lm.lm_spec(num_layers=4, num_hidden=512,
                                  num_heads=8, vocab_size=8192)
    reg = ModelRegistry()
    reg.add_generative_model("lm", transformer_lm.random_params(spec), spec)
    with GenerationEngine(reg) as eng:
        print(eng.submit("lm", [1, 2, 3], max_tokens=8).result().tokens)

Entry points run on ``cuda:0`` unless the caller passes ``mx.cpu()`` /
``device="cpu"``.  RMSNorm and LayerNorm (forward and backward), flash
and paged attention and the SoftmaxOutput head run as hand-written CUDA
kernels on a CUDA tensor (``mxnet_tpu_torch/kernels``) and as their
plain PyTorch versions on a CPU tensor.
"""
from . import (initializer, io, kernels, metric, models, ndarray, optimizer,
               random, symbol)
from . import module
from .base import MXNetError
from .context import cpu, gpu
from .models import transformer_lm
from .module import Module
from .serving import GenerationEngine, ModelRegistry, TokenStream

sym = symbol
nd = ndarray
init = initializer
mod = module

__all__ = ["MXNetError", "ModelRegistry", "GenerationEngine", "TokenStream",
           "transformer_lm", "kernels", "models", "symbol", "sym", "ndarray",
           "nd", "io", "initializer", "init", "metric", "optimizer",
           "random", "module", "mod", "Module", "cpu", "gpu"]
