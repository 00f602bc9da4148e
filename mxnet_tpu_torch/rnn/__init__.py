"""RNN cells and the bucketed sentence iterator (counterpart of
``mxnet_tpu/rnn/``)."""
from .io import BucketSentenceIter, encode_sentences
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell, RNNCell,
                       RNNParams, ResidualCell, SequentialRNNCell, ZoneoutCell)

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "ModifierCell",
           "BucketSentenceIter", "encode_sentences"]
