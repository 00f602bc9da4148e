"""RNN cells and their unrolling into a symbol graph (counterpart of
``mxnet_tpu/rnn/rnn_cell.py``): ``RNNParams``, ``BaseRNNCell`` with its
per-step ``unroll`` (``NTC`` or ``TNC`` inputs, ``merge_outputs``), the
``RNNCell`` / ``LSTMCell`` / ``GRUCell`` steps, ``FusedRNNCell`` and the
``Sequential`` / ``Bidirectional`` / ``Dropout`` / ``Zoneout`` /
``Residual`` cells.

The gate orders (LSTM ``i, f, c, o``, GRU ``r, z, o``), the parameter
names (``<prefix>i2h_weight`` ...) and the node names
(``<prefix>t<step>_i2h`` ...) are the reference's, so a checkpoint of
either package loads into the other's graph.  ``begin_state`` makes
zeros of shape ``(0, H)``: the executor resolves the 0 at bind from the
graph around it (``executor.shape_overrides``).  ``FusedRNNCell`` is,
as in the reference, the stack of explicit cells under the names of the
fused op's layers (``<prefix>l<layer>_`` / ``r<layer>_``); ``unfuse``
returns that stack.  The fused ``RNN`` op itself is ``ops/rnn_op.py``.
"""
from __future__ import annotations

from .. import symbol
from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "ModifierCell"]


class RNNParams:
    """Container for cell weights (reference RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract RNN cell (reference BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_shape(self):
        raise NotImplementedError()

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called "\
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_shape:
            self._init_counter += 1
            if info is None:
                state = func(name="%sbegin_state_%d" % (
                    self._prefix, self._init_counter), **kwargs)
            else:
                kwargs.update({"shape": info})
                state = func(name="%sbegin_state_%d" % (
                    self._prefix, self._init_counter), **kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        """Explicit per-timestep graph unrolling (reference
        BaseRNNCell.unroll)."""
        self.reset()
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1, \
                "unroll doesn't allow grouped symbol as input."
            axis = layout.find("T")
            inputs = symbol.SliceChannel(inputs, axis=axis,
                                         num_outputs=length,
                                         squeeze_axis=1)
            inputs = list(inputs)
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()

        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=1) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Vanilla tanh RNN cell."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (i, f, c, o gate order, reference LSTMCell)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        from ..initializer import LSTMBias
        self._iB = self.params.get(
            "i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden), (0, self._num_hidden)]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4,
                                          name="%sslice" % name)
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid",
                                    name="%si" % name)
        forget_gate = symbol.Activation(slice_gates[1], act_type="sigmoid",
                                        name="%sf" % name)
        in_transform = symbol.Activation(slice_gates[2], act_type="tanh",
                                         name="%sc" % name)
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid",
                                     name="%so" % name)
        next_c = symbol._invoke("elemwise_add",
                                [forget_gate * states[1],
                                 in_gate * in_transform], {},
                                name="%sstate" % name)
        next_h = symbol._invoke("elemwise_mul",
                                [out_gate, symbol.Activation(
                                    next_c, act_type="tanh")], {},
                                name="%sout" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference GRUCell)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        seq_idx = self._counter
        name = "%st%d_" % (self._prefix, seq_idx)
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=prev_state_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_r, i2h_z, i2h = symbol.SliceChannel(
            i2h, num_outputs=3, name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(
            h2h, num_outputs=3, name="%sh2h_slice" % name)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                       name="%sr_act" % name)
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                        name="%sz_act" % name)
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h,
                                       act_type="tanh",
                                       name="%sh_act" % name)
        next_h = symbol._invoke(
            "elemwise_add",
            [(1.0 - update_gate) * next_h_tmp, update_gate * prev_state_h],
            {}, name="%sout" % name)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """A whole stacked (optionally bidirectional) RNN as one cell.  As
    in the reference it unrolls the explicit cells of each layer, named
    as the fused op's layers, so fused and unfused share math and
    parameters; ``unfuse()`` returns that stack."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._stack = self._build_stack()

    def _build_stack(self):
        stack = SequentialRNNCell()
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    self._make_cell("%sl%d_" % (self._prefix, i)),
                    self._make_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(self._make_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout))
        return stack

    def _make_cell(self, prefix):
        if self._mode == "rnn_relu":
            return RNNCell(self._num_hidden, activation="relu",
                           prefix=prefix)
        if self._mode == "rnn_tanh":
            return RNNCell(self._num_hidden, activation="tanh",
                           prefix=prefix)
        if self._mode == "lstm":
            return LSTMCell(self._num_hidden, prefix=prefix,
                            forget_bias=self._forget_bias)
        if self._mode == "gru":
            return GRUCell(self._num_hidden, prefix=prefix)
        raise MXNetError("unknown RNN mode %s" % self._mode)

    @property
    def state_shape(self):
        return self._stack.state_shape

    def begin_state(self, **kwargs):
        return self._stack.begin_state(**kwargs)

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        return self._stack.unroll(length, inputs=inputs,
                                  begin_state=begin_state,
                                  input_prefix=input_prefix, layout=layout,
                                  merge_outputs=merge_outputs)

    def unfuse(self):
        """Explicit-cell version sharing parameters (reference unfuse)."""
        return self._stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in sequence (reference SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_shape(self):
        return sum([c.state_shape for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_shape)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cells over the sequence (reference
    BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_shape(self):
        return sum([c.state_shape for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            axis = layout.find("T")
            inputs = list(symbol.SliceChannel(inputs, axis=axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
        if begin_state is None:
            begin_state = self.begin_state()

        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_shape)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False)
        outputs = [symbol.Concat(l_o, r_o, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=1) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        states = l_states + r_states
        return outputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_shape(self):
        return self.base_cell.state_shape

    def begin_state(self, init_sym=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=init_sym, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(BaseRNNCell):
    """Dropout on cell inputs (reference DropoutCell)."""

    def __init__(self, dropout):
        super().__init__()
        self.dropout = dropout

    @property
    def state_shape(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol._invoke(
                "ones_like", [like], {}), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros((0, 0))
        output = (symbol.where(mask(p_outputs, next_output), next_output,
                               prev_output)
                  if p_outputs != 0. else next_output)
        states = ([symbol.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0. else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """y = cell(x) + x (residual connection modifier)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol._invoke("elemwise_add", [output, inputs], {})
        return output, states

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            axis = layout.find("T")
            inputs = list(symbol.SliceChannel(inputs, axis=axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state,
            layout=layout, merge_outputs=False)
        self.base_cell._modified = True
        outputs = [symbol._invoke("elemwise_add", [out, inp], {})
                   for out, inp in zip(outputs, inputs)]
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=1) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        return outputs, states
