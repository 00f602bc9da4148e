"""PyTorch/CUDA port of ``mxnet_tpu`` for one NVIDIA H100.

The port imports ``torch`` and never ``jax`` or ``mxnet_tpu``; the JAX
package stays the reference it is tested against.  This slice serves
the transformer LM on the paged KV plane:

    from mxnet_tpu_torch.models import transformer_lm
    from mxnet_tpu_torch.serving import ModelRegistry, GenerationEngine

    spec = transformer_lm.lm_spec(num_layers=4, num_hidden=512,
                                  num_heads=8, vocab_size=8192)
    reg = ModelRegistry()
    reg.add_generative_model("lm", transformer_lm.random_params(spec), spec)
    with GenerationEngine(reg) as eng:
        print(eng.submit("lm", [1, 2, 3], max_tokens=8).result().tokens)

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``;
RMSNorm, LayerNorm and paged attention run as hand-written CUDA kernels
on a CUDA tensor (``mxnet_tpu_torch/kernels``) and as their plain
PyTorch versions on a CPU tensor.
"""
from . import kernels, models
from .base import MXNetError
from .models import transformer_lm
from .serving import GenerationEngine, ModelRegistry, TokenStream

__all__ = ["MXNetError", "ModelRegistry", "GenerationEngine", "TokenStream",
           "transformer_lm", "kernels", "models"]
