"""The stacked-LSTM language model (counterpart of
``mxnet_tpu/models/lstm_lm.py``, the model of
``examples/rnn/lstm_bucketing.py`` and of bench.py's
``train.lstm-bucketing`` row): an ``Embedding``, ``num_layers``
``LSTMCell``s unrolled over one bucket's length, a ``FullyConnected``
projection onto the vocabulary and ``SoftmaxOutput``."""
from .. import rnn, symbol as sym


def get_symbol(seq_len, num_layers=3, num_hidden=200, num_embed=200,
               vocab_size=10000, dropout=0.0, **kwargs):
    """The unrolled LM for sentences of ``seq_len`` tokens (batch-major
    ``(N, T)`` data and labels)."""
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data=data, input_dim=vocab_size,
                          output_dim=num_embed, name="embed")

    stack = rnn.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(rnn.LSTMCell(num_hidden=num_hidden,
                               prefix="lstm_l%d_" % i))
        if dropout > 0 and i < num_layers - 1:
            stack.add(rnn.DropoutCell(dropout))
    outputs, states = stack.unroll(seq_len, inputs=embed,
                                   merge_outputs=True)

    pred = sym.Reshape(outputs, shape=(-1, num_hidden))
    pred = sym.FullyConnected(data=pred, num_hidden=vocab_size,
                              name="pred")
    lbl = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(data=pred, label=lbl, name="softmax")


def sym_gen_factory(num_layers=3, num_hidden=200, num_embed=200,
                    vocab_size=10000, dropout=0.0):
    """``BucketingModule``'s ``sym_gen``: bucket key (the sentence
    length) -> ``(symbol, data_names, label_names)``."""
    def sym_gen(seq_len):
        s = get_symbol(seq_len, num_layers=num_layers,
                       num_hidden=num_hidden, num_embed=num_embed,
                       vocab_size=vocab_size, dropout=dropout)
        return s, ("data",), ("softmax_label",)
    return sym_gen
