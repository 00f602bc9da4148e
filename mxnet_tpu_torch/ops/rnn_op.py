"""The fused ``RNN`` op (counterpart of ``mxnet_tpu/ops/rnn_op.py``): a
stacked, optionally bidirectional LSTM, GRU or vanilla RNN over a whole
time-major sequence ``(T, N, I)``.

Parameter packing, as the reference's: for each layer, then each
direction, ``[i2h_weight (G*H, in), h2h_weight (G*H, H), i2h_bias (G*H),
h2h_bias (G*H)]`` flattened and concatenated (:func:`rnn_param_size`);
the gates in the explicit cells' order, LSTM ``i, f, c, o`` and GRU
``r, z, o``.  A cell step is the reference's ``_cell_step``: the LSTM's
``c' = f*c + i*g``, ``h' = o*tanh(c')``, and the GRU's candidate
``tanh(x_o + r * (W_ho h + b_ho))``, its reset gate applied after the
hidden product and its bias.

Two routes, chosen by :func:`rnn_apply` from the data's device.  The
plain version (:func:`rnn_plain`) is the per-step loop, the reference's
``lax.scan`` written out; a CPU tensor takes it.  A CUDA tensor runs
cuDNN through ``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` /
``rnn_relu``, whose formulas are these (cuDNN's GRU applies its reset
gate to ``W_hn h + b_hn``, as the reference does); the reference
computes this op with XLA, not a Pallas kernel, so cuDNN takes it here
as it takes the convolutions.  Dropout between layers in training
(``p``) draws its keep mask from the generator the executor hands the
op, one layer at a time, on either route.
"""
from __future__ import annotations

import warnings

import torch

from ..base import MXNetError
from .registry import Bool, Float, Int, Str, register

__all__ = ["rnn_param_size", "unpack_params", "rnn_plain", "rnn_apply"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _layer_input_size(layer, input_size, state_size, num_dir):
    return input_size if layer == 0 else state_size * num_dir


def rnn_param_size(num_layers, input_size, state_size, mode,
                   bidirectional=False):
    """The packed parameter vector's length."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        in_sz = _layer_input_size(layer, input_size, state_size, d)
        total += d * (g * state_size * (in_sz + state_size + 2))
    return total


def unpack_params(params, num_layers, input_size, state_size, mode,
                  bidirectional):
    """``[[(i2h_weight, h2h_weight, i2h_bias, h2h_bias) for each
    direction] for each layer]``, views of the packed vector ``params``."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    out, off = [], 0
    for layer in range(num_layers):
        in_sz = _layer_input_size(layer, input_size, h, d)
        dirs = []
        for _ in range(d):
            wi = params[off:off + g * h * in_sz].reshape(g * h, in_sz)
            off += g * h * in_sz
            wh = params[off:off + g * h * h].reshape(g * h, h)
            off += g * h * h
            bi = params[off:off + g * h]
            off += g * h
            bh = params[off:off + g * h]
            off += g * h
            dirs.append((wi, wh, bi, bh))
        out.append(dirs)
    return out


def _cell_step(mode, h, c, x, wi, wh, bi, bh):
    if mode == "gru":
        xr, xz, xo = torch.chunk(x @ wi.t() + bi, 3, dim=-1)
        hr, hz, ho = torch.chunk(h @ wh.t() + bh, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        cand = torch.tanh(xo + r * ho)
        return (1 - z) * cand + z * h, c
    pre = x @ wi.t() + h @ wh.t() + bi + bh
    if mode == "rnn_relu":
        return torch.relu(pre), c
    if mode == "rnn_tanh":
        return torch.tanh(pre), c
    i, f, g, o = torch.chunk(pre, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _plain_layer(mode, x, h0, c0, dirs):
    """One layer of the per-step loop: ``(output, [h_T], [c_T])`` by
    direction, the reverse direction scanning from the last step and its
    outputs put back in time order."""
    outs, hs, cs = [], [], []
    for di, (wi, wh, bi, bh) in enumerate(dirs):
        h, c = h0[di], c0[di]
        steps = range(x.shape[0] - 1, -1, -1) if di else range(x.shape[0])
        ys = [None] * x.shape[0]
        for t in steps:
            h, c = _cell_step(mode, h, c, x[t], wi, wh, bi, bh)
            ys[t] = h
        outs.append(torch.stack(ys))
        hs.append(h)
        cs.append(c)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, -1)), hs, cs


def _cudnn_layers(mode, x, h0, c0, weights, num_layers, bidirectional,
                  is_train):
    """``num_layers`` layers in one cuDNN call: ``(output, h_n, c_n)``."""
    flat = [w for dirs in weights for wts in dirs for w in wts]
    fn = getattr(torch._VF, mode)
    with warnings.catch_warnings():
        # the weights are views of the packed vector, not cuDNN's own
        # flat buffer: cuDNN copies them into one each call
        warnings.filterwarnings("ignore", message=".*contiguous chunk")
        if mode == "lstm":
            return fn(x, (h0, c0), flat, True, num_layers, 0.0, is_train,
                      bidirectional, False)
        out, hn = fn(x, h0, flat, True, num_layers, 0.0, is_train,
                     bidirectional, False)
    return out, hn, c0


def _dropout(x, p, generator):
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return (x * mask) / keep


def _run(layer_fn, attrs, data, params, state, state_cell, is_train,
         generator):
    mode = attrs["mode"]
    if mode not in _GATES:
        raise MXNetError("unknown RNN mode %r" % mode)
    h = attrs["state_size"]
    L = attrs["num_layers"]
    bidir = attrs["bidirectional"]
    p = attrs["p"]
    d = 2 if bidir else 1
    if state_cell is None:
        state_cell = torch.zeros_like(state)
    weights = unpack_params(params, L, data.shape[2], h, mode, bidir)
    drop = is_train and p > 0 and generator is not None
    x, hs, cs = data, [], []
    # without dropout between them every layer goes in one call
    groups = [range(li, li + 1) for li in range(L)] if drop else [range(L)]
    for grp in groups:
        lo, hi = grp.start * d, grp.stop * d
        x, hn, cn = layer_fn(mode, x, state[lo:hi], state_cell[lo:hi],
                             weights[grp.start:grp.stop], len(grp), bidir,
                             is_train)
        hs.append(hn)
        cs.append(cn)
        if drop and grp.stop < L:
            x = _dropout(x, p, generator)
    outs = [x]
    if attrs["state_outputs"]:
        outs.append(torch.cat(hs))
        if mode == "lstm":
            outs.append(torch.cat(cs))
    return tuple(outs)


def _plain_layers(mode, x, h0, c0, weights, num_layers, bidirectional,
                  is_train):
    d = 2 if bidirectional else 1
    hs, cs = [], []
    for li, dirs in enumerate(weights):
        x, h, c = _plain_layer(mode, x, h0[li * d:(li + 1) * d],
                               c0[li * d:(li + 1) * d], dirs)
        hs += h
        cs += c
    return x, torch.stack(hs), torch.stack(cs)


def rnn_plain(attrs, data, params, state, state_cell=None, is_train=False,
              generator=None):
    """The plain version: the per-step loop, on any device."""
    return _run(_plain_layers, attrs, data, params, state, state_cell,
                is_train, generator)


def rnn_apply(attrs, data, params, state, state_cell=None, is_train=False,
              generator=None):
    """The op: cuDNN on a CUDA tensor, the per-step loop on a CPU one.
    Returns the output sequence, then with ``state_outputs`` the last
    hidden (and, for an LSTM, cell) states of every layer and
    direction."""
    layers = _cudnn_layers if data.is_cuda else _plain_layers
    return _run(layers, attrs, data, params, state, state_cell, is_train,
                generator)


def _rnn_fstateful(attrs, inputs, aux, is_train, generator):
    return rnn_apply(attrs, *inputs, is_train=is_train,
                     generator=generator), ()


def _rnn_args(attrs):
    if attrs["mode"] == "lstm":
        return ["data", "parameters", "state", "state_cell"]
    return ["data", "parameters", "state"]


def _rnn_outputs(attrs):
    outs = ["output"]
    if attrs["state_outputs"]:
        outs.append("state")
        if attrs["mode"] == "lstm":
            outs.append("state_cell")
    return outs


def _rnn_num_outputs(attrs):
    return len(_rnn_outputs(attrs))


def _rnn_infer(attrs, in_shapes):
    ds = in_shapes[0]
    mode = attrs["mode"]
    h = attrs["state_size"]
    L = attrs["num_layers"]
    d = 2 if attrs["bidirectional"] else 1
    if ds is None:
        return in_shapes, [None] * _rnn_num_outputs(attrs), []
    T, N, I = ds
    in_shapes[1] = (rnn_param_size(L, I, h, mode, attrs["bidirectional"]),)
    in_shapes[2] = (L * d, N, h)
    if mode == "lstm":
        in_shapes[3] = (L * d, N, h)
    outs = [(T, N, h * d)] + [(L * d, N, h)] * (_rnn_num_outputs(attrs) - 1)
    return in_shapes, outs, []


register("RNN", fstateful=_rnn_fstateful, arguments=_rnn_args,
         outputs=_rnn_outputs, num_outputs=_rnn_num_outputs,
         needs_rng=True, rng_at_eval=False,
         attrs={"state_size": Int(required=True),
                "num_layers": Int(required=True),
                "mode": Str(required=True),
                "bidirectional": Bool(False), "p": Float(0.0),
                "state_outputs": Bool(False),
                "pkeep_": Float(1.0), "lstm_q_": Bool(False)},
         infer_shape=_rnn_infer,
         doc="Stacked LSTM / GRU / vanilla RNN over a time-major sequence: "
             "cuDNN on the card, the per-step loop on the CPU.")
