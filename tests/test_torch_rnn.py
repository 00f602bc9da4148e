"""The port's RNN cells, the fused ``RNN`` op, ``LSTMBias`` /
``FusedRNN`` and ``BucketSentenceIter`` against the JAX package's.

Every graph is built the same way in both packages from seeded numpy
values (vocabulary and widths tiny, at most two layers), bound with
``simple_bind`` on the CPU, run forward in training and sent back with
seeded head gradients; outputs and every gradient agree within 1e-5 x
max|ref|.  The cells' ``begin_state`` is left to ``unroll``: zeros of
shape ``(0, H)`` that each executor resolves from the graph at bind.
The iterator's epoch is drawn by the port (from its own generator) and
handed to the reference through ``state_dict`` / ``load_state``; the
batches then agree bit for bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import rnn_op

PKGS = (jmx, tmx)
TOL = 1e-5
T, N, I, H = 3, 2, 4, 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module (its tests make many tiny
    torch ops); restored when the module ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def _close(got, want, what, tol=TOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= bound, (what, err, bound)


def _bind_run(pkg, net, shapes, values, seed=0):
    """``net`` bound on the CPU to ``shapes``; every argument set from
    ``values`` (by name, else seeded normals), one train forward and a
    backward with seeded head gradients.  Returns (outputs, grads) as
    numpy dicts."""
    exe = net.simple_bind(pkg.cpu(), grad_req="write", **shapes)
    for name, arr in exe.arg_dict.items():
        arr[:] = values[name]
    outs = exe.forward(is_train=True)
    rs = np.random.RandomState(seed)
    with pkg.cpu():
        exe.backward([pkg.nd.array(rs.randn(*o.shape).astype(np.float32))
                      for o in outs])
    return ([_np(o) for o in outs],
            {n: _np(g) for n, g in exe.grad_dict.items()})


def _values(net, shapes, seed=1):
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: (0.5 * rs.randn(*s)).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)}


def _cell(pkg, kind):
    rnn = pkg.rnn
    if kind == "rnn_relu":
        return rnn.RNNCell(H, activation="relu", prefix="rnn_")
    return {"rnn": lambda: rnn.RNNCell(H, prefix="rnn_"),
            "lstm": lambda: rnn.LSTMCell(H, prefix="lstm_"),
            "gru": lambda: rnn.GRUCell(H, prefix="gru_")}[kind]()


def _unrolled(pkg, kind, layout="NTC"):
    with _names(pkg):
        data = pkg.sym.Variable("data")
        outs, states = _cell(pkg, kind).unroll(
            T, inputs=data, layout=layout, merge_outputs=True)
        return pkg.sym.Group([outs] + list(states))


def _names(pkg):
    return (jmx.name.NameManager() if pkg is jmx
            else tmx.symbol.NameManager())


@pytest.mark.parametrize("kind", ["rnn", "rnn_relu", "lstm", "gru"])
def test_cell_outputs_and_gradients_match(kind):
    """An unrolled cell (``begin_state`` left to the 0-wildcard) through
    ``simple_bind``: the merged outputs, the last states and the
    gradients of the data and every parameter."""
    shapes = {"data": (N, T, I)}
    nets = {pkg: _unrolled(pkg, kind) for pkg in PKGS}
    assert nets[tmx].list_arguments() == nets[jmx].list_arguments()
    assert nets[tmx].list_outputs() == nets[jmx].list_outputs()
    values = _values(nets[jmx], shapes)
    (jo, jg), (to, tg) = (_bind_run(p, nets[p], shapes, values)
                          for p in PKGS)
    assert to[0].shape == (N, T, H)
    for i, (g, w) in enumerate(zip(to, jo)):
        _close(g, w, "%s output %d" % (kind, i))
    assert sorted(tg) == sorted(jg)
    for name in jg:
        _close(tg[name], jg[name], "%s grad %s" % (kind, name))


def _stack(pkg, kind):
    rnn = pkg.rnn
    if kind == "sequential":
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.LSTMCell(H, prefix="l0_"))
        cell.add(rnn.DropoutCell(0.5))
        cell.add(rnn.ResidualCell(rnn.GRUCell(H, prefix="l1_")))
        return cell
    if kind == "bidirectional":
        return rnn.BidirectionalCell(rnn.LSTMCell(H, prefix="l_"),
                                     rnn.GRUCell(H, prefix="r_"))
    if kind == "zoneout":
        return rnn.ZoneoutCell(rnn.RNNCell(H, prefix="z_"), 0.3, 0.2)
    if kind == "fused":
        # bidirectional layers in a stack cannot be stepped, in either
        # package: BidirectionalCell unrolls only on its own
        return rnn.FusedRNNCell(H, num_layers=2, mode="lstm", dropout=0.2)
    return rnn.FusedRNNCell(H, num_layers=2, mode="gru").unfuse()


@pytest.mark.parametrize("kind", ["sequential", "bidirectional", "zoneout",
                                  "fused", "unfused"])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_unroll_shapes_and_names_match(kind, layout):
    """Each composite cell's unrolled graph: the same arguments,
    outputs and inferred argument, output and state shapes as the
    reference's, in both layouts."""
    data = (N, T, I) if layout == "NTC" else (T, N, I)
    res = {}
    for pkg in PKGS:
        with _names(pkg):
            outs, states = _stack(pkg, kind).unroll(
                T, inputs=pkg.sym.Variable("data"), layout=layout,
                merge_outputs=False)
            net = pkg.sym.Group(list(outs) + list(states))
        res[pkg] = (net.list_arguments(), net.list_outputs(),
                    net.infer_shape(data=data))
    assert res[tmx] == res[jmx]
    assert len(res[tmx][1]) > T


def test_lstm_bias_and_init_attribute():
    """``LSTMCell``'s ``i2h_bias`` carries the reference's ``__init__``
    attribute, and ``init_params`` sets its forget quarter to
    ``forget_bias`` and the other biases to zero, in both packages."""
    ref = None
    for pkg in PKGS:
        cell = pkg.rnn.LSTMCell(H, prefix="lstm_", forget_bias=2.5)
        with _names(pkg):
            outs, _ = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                                  merge_outputs=True)
        mod = pkg.mod.Module(outs, label_names=None, context=pkg.cpu())
        mod.bind([("data", (N, T, I))], for_training=False)
        mod.init_params(pkg.init.Xavier())
        args = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        got = (outs.attr_dict()["lstm_i2h_bias"], args["lstm_i2h_bias"],
               args["lstm_h2h_bias"])
        if ref is None:
            ref = got
    assert got[0] == ref[0]
    want = np.zeros(4 * H, np.float32)
    want[H:2 * H] = 2.5
    for bias in (got[1], ref[1]):
        np.testing.assert_array_equal(bias, want)
    np.testing.assert_array_equal(got[2], np.zeros(4 * H, np.float32))
    np.testing.assert_array_equal(ref[2], got[2])


MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]
L = 2


def _rnn_net(pkg, mode, bidirectional):
    sym = pkg.sym
    args = [sym.Variable("data"), sym.Variable("parameters"),
            sym.Variable("state")]
    if mode == "lstm":
        args.append(sym.Variable("state_cell"))
    return sym.RNN(*args, state_size=H, num_layers=L, mode=mode,
                   bidirectional=bidirectional, state_outputs=True,
                   name="rnn")


@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches(mode):
    """The fused ``RNN`` op (two bidirectional layers): the output
    sequence, the last states and the gradients of the data, the packed
    parameters and the initial states."""
    shapes = {"data": (T, N, I)}
    nets = {pkg: _rnn_net(pkg, mode, True) for pkg in PKGS}
    values = _values(nets[jmx], shapes, seed=3)
    assert values["parameters"].shape == (rnn_op.rnn_param_size(
        L, I, H, mode, True),)
    (jo, jg), (to, tg) = (_bind_run(p, nets[p], shapes, values, seed=4)
                          for p in PKGS)
    assert len(to) == len(jo) == (3 if mode == "lstm" else 2)
    for i, (g, w) in enumerate(zip(to, jo)):
        _close(g, w, "%s output %d" % (mode, i))
    for name in jg:
        _close(tg[name], jg[name], "%s grad %s" % (mode, name))


def test_rnn_op_dropout_between_layers():
    """Training-time dropout between layers: the executor's output is
    the plain version's with the same generator state (one keep mask a
    layer boundary, scaled by 1/(1-p)), and differs from inference,
    which matches the reference's."""
    attrs = dict(state_size=H, num_layers=3, mode="lstm",
                 bidirectional=False, p=0.5, state_outputs=False,
                 pkeep_=1.0, lstm_q_=False)
    nets = {pkg: pkg.sym.RNN(
        pkg.sym.Variable("data"), pkg.sym.Variable("parameters"),
        pkg.sym.Variable("state"), pkg.sym.Variable("state_cell"),
        **{k: v for k, v in attrs.items() if k not in ("pkeep_", "lstm_q_")})
        for pkg in PKGS}
    shapes = {"data": (T, N, I)}
    values = _values(nets[jmx], shapes, seed=5)
    exes = {}
    for pkg in PKGS:
        exe = nets[pkg].simple_bind(pkg.cpu(), grad_req="null", **shapes)
        for name, arr in exe.arg_dict.items():
            arr[:] = values[name]
        exes[pkg] = exe
    infer = exes[tmx].forward(is_train=False)[0].asnumpy()
    _close(infer, exes[jmx].forward(is_train=False)[0].asnumpy(),
           "inference")
    tmx.random.seed(7)
    train = exes[tmx].forward(is_train=True)[0].asnumpy()
    tmx.random.seed(7)
    t = {k: torch.from_numpy(v) for k, v in values.items()}
    want = rnn_op.rnn_plain(attrs, t["data"], t["parameters"], t["state"],
                            t["state_cell"], is_train=True,
                            generator=tmx.random.generator("cpu"))[0]
    np.testing.assert_array_equal(train, want.numpy())
    assert not np.allclose(train, infer)


def test_fused_rnn_initializer_packs_the_cells_init():
    """``FusedRNN`` fills the packed vector piece by piece: weights by
    its initializer, biases zero, the LSTM's forget quarter of each
    ``i2h_bias`` at ``forget_bias``."""
    n = rnn_op.rnn_param_size(L, I, H, "lstm", True)
    arr = tmx.nd.zeros((n,), tmx.cpu())
    init = tmx.init.FusedRNN(tmx.init.One(), H, L, "lstm",
                             bidirectional=True, forget_bias=3.0)
    init(tmx.init.InitDesc("rnn_parameters"), arr)
    layers = rnn_op.unpack_params(arr._data, L, I, H, "lstm", True)
    assert len(layers) == L and all(len(d) == 2 for d in layers)
    for dirs in layers:
        for wi, wh, bi, bh in dirs:
            assert bool((wi == 1).all()) and bool((wh == 1).all())
            assert bool((bh == 0).all())
            want = torch.zeros(4 * H)
            want[H:2 * H] = 3.0
            assert torch.equal(bi, want)
    # through a variable's __init__ attribute, under a global Xavier
    var = tmx.sym.Variable("p", init=tmx.init.FusedRNN(None, H, 1, "gru"))
    arr2 = tmx.nd.zeros((rnn_op.rnn_param_size(1, I, H, "gru"),),
                        tmx.cpu())
    tmx.init.Xavier()(tmx.init.InitDesc("p", var.attr_dict()["p"]), arr2)
    (wi, wh, bi, bh), = rnn_op.unpack_params(arr2._data, 1, I, H, "gru",
                                             False)[0]
    assert float(wi.abs().min()) > 0 and float(bi.abs().max()) == 0


def _sentences(rs, n, vocab, lo, hi):
    return [list(rs.randint(1, vocab, rs.randint(lo, hi)))
            for _ in range(n)]


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_plan_bit_equal(layout):
    """The port draws an epoch; the reference loads it through
    ``state_dict`` / ``load_state`` and both give the same batches bit
    for bit: data, labels, bucket keys and ``provide_*`` with the
    layout, mid-epoch resume included."""
    rs = np.random.RandomState(11)
    sent = _sentences(rs, 60, 30, 2, 12)
    its = {pkg: pkg.rnn.BucketSentenceIter(
        sent, 4, buckets=[4, 8, 10], invalid_label=0, layout=layout)
        for pkg in PKGS}
    assert its[tmx].default_bucket_key == its[jmx].default_bucket_key == 10
    assert its[tmx].provide_data == its[jmx].provide_data
    assert its[tmx].provide_data[0].layout == layout
    its[jmx].load_state(its[tmx].state_dict())
    n = 0
    for tb, jb in zip(its[tmx], its[jmx]):
        assert tb.bucket_key == jb.bucket_key
        for a, b in zip(tb.data + tb.label, jb.data + jb.label):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
        assert [(d.name, d.shape, d.layout) for d in tb.provide_data] == \
            [(d.name, d.shape, d.layout) for d in jb.provide_data]
        n += 1
        if n == 2:
            its[jmx].load_state(its[tmx].state_dict())
    assert n == len(its[tmx]._plan) > 3
    assert tmx.io.DataDesc.get_batch_axis(layout) == layout.find("N")
    enc = [pkg.rnn.encode_sentences([["a", "b"], ["b", "c", "a"]],
                                    invalid_label=0, start_label=1)
           for pkg in PKGS]
    assert enc[0] == enc[1]
