"""contrib.autograd: the reference's imperative autograd surface
(counterpart of ``mxnet_tpu/contrib/autograd.py``), re-exported from
:mod:`mxnet_tpu_torch.autograd`."""
from ..autograd import (grad, grad_and_loss, mark_variables, backward,
                        set_training as set_is_training,
                        train_section, test_section,
                        is_training, record, pause)

__all__ = ["grad", "grad_and_loss", "mark_variables", "backward",
           "set_is_training", "train_section", "test_section",
           "is_training", "record", "pause"]
