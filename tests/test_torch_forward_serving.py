"""The port's forward serving plane against ``mxnet_tpu``'s, on the CPU.

``ProgramStore`` (bucketed runs in fp32, bf16 and int8, stats, weight
bytes, the batch-major probe, request checks, LRU eviction),
``ModelRegistry.add_model``, ``ServingEngine`` (batch formation against
the reference engine under the same submit pattern and the same
``_dispatch_hook`` recorder: FIFO partitions, no overtaking past a
parked request, deadlines, cancel, tiers, tenant quotas, admission,
drain), ``Predictor`` on both routes, the ``.mxsrv`` artifact both ways,
``OpenLoopSchedule`` and ``latency_protocol``.  Two models from the
reference's serving tests: the smoke MLP (feat 48, hidden 64) and a
conv net (conv 3x3 x4, ReLU, FC 3 over 3 x 8 x 8), buckets (1, 2, 4),
weights from numpy.  Bounds: fp32 1e-6 x max|ref|, bf16 2e-2 x
max|ref|, int8 1e-5 absolute with the codes bit-equal to the
reference's ``quantize_int8``.  Padded rows are held within rounding of
unpadded ones, never bit for bit (ROADMAP Queue 3, known traps).
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.pallas_ops.dequant_matmul import quantize_int8 as j_quantize
from mxnet_tpu.serving import ModelRegistry as JRegistry
from mxnet_tpu.serving import OpenLoopSchedule as JSchedule
from mxnet_tpu.serving import ProgramStore as JStore
from mxnet_tpu.serving import ServingEngine as JEngine

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import evaluate
from mxnet_tpu_torch.kernels.dequant_matmul import QuantizedWeight
from mxnet_tpu_torch.serving import (ModelRegistry, OpenLoopSchedule,
                                     ProgramStore, ServeClosed,
                                     ServeTimeout,
                                     ServingEngine, latency_protocol,
                                     run_loadgen)

CPU = "cpu"
BUCKETS = (1, 2, 4)
SHAPES = {"mlp": {"data": (1, 48)}, "conv": {"data": (1, 3, 8, 8)}}
DTYPES = {"fp32": None, "bf16": "bfloat16", "int8": "int8"}
PKGS = {"port": tmx, "ref": jmx}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tests make many tiny
    torch ops, and under a parallel run handing each op to a team of
    threads costs many times the op.  Restored when the module ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(pkg, seed=0):
    """The latency protocol's smoke MLP at feat 48, hidden 64."""
    net = pkg.test_utils.smoke_mlp(num_hidden=64)
    shapes, _, _ = net.infer_shape(data=(1, 48), softmax_label=(1,))
    rs = np.random.RandomState(seed)
    args = {n: rs.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    return net, args


def _conv(pkg, seed=0, num_hidden=3):
    """The reference serving tests' conv net."""
    rs = np.random.RandomState(seed)
    data = pkg.sym.Variable("data")
    conv = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                               pad=(1, 1), name="conv1")
    act = pkg.sym.Activation(conv, act_type="relu")
    fc = pkg.sym.FullyConnected(pkg.sym.Flatten(act),
                                num_hidden=num_hidden, name="fc1")
    net = pkg.sym.SoftmaxOutput(fc, name="softmax")
    shapes, _, _ = net.infer_shape(data=(2, 3, 8, 8), softmax_label=(2,))
    args = {n: rs.uniform(-0.2, 0.2, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    return net, args


MODELS = {"mlp": _mlp, "conv": _conv}


def _x(model, n, seed):
    tail = SHAPES[model]["data"][1:]
    return np.random.RandomState(seed).uniform(
        -1, 1, (n,) + tail).astype(np.float32)


def _store(pkg, model, dtype, **kw):
    net, args = MODELS[model](pkg)
    kw.setdefault("buckets", BUCKETS)
    if pkg is tmx:
        kw.setdefault("device", CPU)
        return ProgramStore(net, args, {}, SHAPES[model],
                            compute_dtype=DTYPES[dtype], **kw)
    return JStore(net, args, {}, SHAPES[model],
                  compute_dtype=DTYPES[dtype], **kw)


@pytest.fixture(scope="module")
def ref_stores():
    """The reference's warmed stores, one a (model, dtype)."""
    out = {}
    for model in MODELS:
        for dtype in DTYPES:
            st = _store(jmx, model, dtype)
            st.warmup()
            out[model, dtype] = st
    return out


def _out(o):
    return o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)


# ---------------------------------------------------------------------------
# ProgramStore
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_store_runs_match_reference(ref_stores, model, dtype):
    ref = ref_stores[model, dtype]
    st = _store(tmx, model, dtype)
    st.warmup()
    for n in (1, 2, 3, 4):
        x = _x(model, n, 10 + n)
        got, bucket, bm = st.run(st.canon_inputs({"data": x})[0], n=n)
        want, jbucket, jbm = ref.run({"data": x})
        assert (bucket, bm) == (jbucket, tuple(jbm)) == (
            {1: 1, 2: 2, 3: 4, 4: 4}[n], (True,))
        g, w = _out(got[0]), _out(want[0])
        assert g.shape == w.shape == (n, 10 if model == "mlp" else 3)
        assert g.dtype == np.float32
        err = np.abs(g - w).max()
        if dtype == "fp32":
            assert err <= 1e-6 * np.abs(w).max(), (n, err)
        elif dtype == "bf16":
            assert err <= 2e-2 * np.abs(w).max(), (n, err)
        else:
            assert err <= 1e-5, (n, err)
    if dtype == "int8":
        _net, args = MODELS[model](tmx)
        for name, w in args.items():
            if name.endswith("_weight") and name.startswith("fc"):
                codes, scales = j_quantize(w)
                q = st._params[name]
                assert isinstance(q, QuantizedWeight), name
                np.testing.assert_array_equal(q.codes.numpy(), codes)
                np.testing.assert_array_equal(q.scales.numpy(), scales)
            else:
                assert not isinstance(st._params.get(name),
                                      QuantizedWeight), name


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_store_stats_and_weight_bytes_match_reference(dtype):
    stats = {}
    for key, pkg in PKGS.items():
        st = _store(pkg, "conv", dtype, max_programs=2)
        st.warmup(execute=False)
        for n in (1, 3, 2, 2):
            st.run(st.canon_inputs({"data": _x("conv", n, n)})[0], n=n)
        stats[key] = st.stats()
    got, want = stats["port"], stats["ref"]
    assert set(got) == set(want)
    for k in ("hits", "compiles", "evictions", "size", "max_programs",
              "buckets_resident", "edges", "compute_dtype", "version",
              "weight_bytes"):
        assert got[k] == want[k], k
    assert got["weight_bytes"]["by_dtype"] == {
        "fp32": {"float32": 3532}, "bf16": {"bfloat16": 1766},
        "int8": {"float32": 472, "int8": 768}}[dtype]


def test_store_rejects_non_batch_major_output():
    for pkg, cls in ((tmx, ProgramStore), (jmx, JStore)):
        rs = np.random.RandomState(12)
        fc = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=3,
                                    name="fc1")
        net = pkg.sym.sum(fc)
        shapes, _, _ = net.infer_shape(data=(2, 8))
        args = {n: rs.rand(*s).astype(np.float32)
                for n, s in zip(net.list_arguments(), shapes) if n != "data"}
        kw = {"device": CPU} if pkg is tmx else {}
        with pytest.raises(Exception, match="not batch-major"):
            cls(net, args, {}, {"data": (1, 8)}, buckets=(1, 2), **kw)


@pytest.mark.parametrize("bad", ["oversize", "name", "shape", "empty",
                                 "rows"])
def test_store_refuses_bad_inputs_as_reference(bad):
    rs = np.random.RandomState(2)
    x = rs.rand(1, 3, 8, 8).astype(np.float32)
    inputs = {"oversize": {"data": rs.rand(5, 3, 8, 8)},
              "name": {"wrong": x},
              "shape": {"data": rs.rand(1, 3, 4, 4)},
              "empty": {"data": np.zeros((0, 3, 8, 8), np.float32)},
              "rows": {"data": rs.rand(2, 3, 8)}}[bad]
    msgs = []
    for pkg in PKGS.values():
        st = _store(pkg, "conv", "fp32")
        with pytest.raises(Exception) as info:
            st.canon_inputs(inputs)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_store_lru_eviction_counts_match_reference():
    stats = {}
    for key, pkg in PKGS.items():
        st = _store(pkg, "conv", "fp32", max_programs=2)
        seen = []
        for n in (1, 2, 4, 2, 1):
            st.run({"data": _x("conv", n, n)})
            s = st.stats()
            seen.append((s["hits"], s["compiles"], s["evictions"],
                         s["buckets_resident"]))
        stats[key] = seen
    assert stats["port"] == stats["ref"]
    assert stats["port"][-1] == (1, 4, 2, [1, 2])


def test_store_swap_publishes_one_version():
    st = _store(tmx, "mlp", "fp32")
    _net, args = _mlp(tmx)
    _net2, args2 = _mlp(tmx, seed=1)
    x = _x("mlp", 2, 5)
    before = st.run({"data": x})[0][0].clone()
    snap = st.param_snapshot()
    assert st.swap_params(args2) == 2 and st.version == 2
    after = st.run({"data": x})[0][0]
    want = _store(tmx, "mlp", "fp32")
    want.swap_params(args2)
    np.testing.assert_array_equal(after.numpy(),
                                  want.run({"data": x})[0][0].numpy())
    assert not torch.equal(before, after)
    assert st.restore_params(snap) == 3
    np.testing.assert_array_equal(st.run({"data": x})[0][0].numpy(),
                                  before.numpy())
    bad = dict(args)
    bad["fc1_weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(MXNetError, match="signature"):
        st.swap_params(bad)
    with pytest.raises(MXNetError, match="missing"):
        st.swap_params({})


def test_evaluate_hands_a_quantized_weight_through():
    """Under a compute dtype the walk casts floating tensors and leaves
    a QuantizedWeight to the op that takes it."""
    net, _args = _mlp(tmx)
    st = _store(tmx, "mlp", "int8")
    values = dict(st._params)
    values.update(data=torch.from_numpy(_x("mlp", 2, 0)),
                  softmax_label=torch.zeros(2))
    outs, _ = evaluate(net._nodes(), [(id(n), oi) for n, oi in net._outputs],
                       {}, values, False, torch.device(CPU),
                       compute_dtype=torch.bfloat16)
    assert outs[0].shape == (2, 10) and bool(torch.isfinite(outs[0]).all())
    for name in ("fc1_weight", "fc2_weight"):
        q = values[name]
        assert isinstance(q, QuantizedWeight) and q is st._params[name]
        assert q.codes.dtype == torch.int8


def test_registry_unregisters_on_warmup_failure(monkeypatch):
    net, args = _conv(tmx)
    reg = ModelRegistry()

    def boom(self, execute=True):
        raise MXNetError("compile boom")

    monkeypatch.setattr(ProgramStore, "warmup", boom)
    with pytest.raises(MXNetError, match="compile boom"):
        reg.add_model("m", net, args, {}, input_shapes=SHAPES["conv"],
                      buckets=BUCKETS, device=CPU)
    assert "m" not in reg and len(reg) == 0
    monkeypatch.undo()
    reg.add_model("m", net, args, {}, input_shapes=SHAPES["conv"],
                  buckets=(1,), device=CPU)
    assert "m" in reg and reg.models() == ["m"]
    with pytest.raises(MXNetError, match="already registered"):
        reg.add_model("m", net, args, {}, input_shapes=SHAPES["conv"],
                      buckets=(1,), device=CPU)
    assert set(reg.stats()) == {"m"}
    reg.remove_model("m")
    with pytest.raises(MXNetError, match="unknown serving model"):
        reg.store("m")


def test_registry_default_dtype_from_env(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_DTYPE", "int8")
    net, args = _mlp(tmx)
    reg = ModelRegistry()
    st = reg.add_model("m", net, args, input_shapes=SHAPES["mlp"],
                       buckets=(1,), device=CPU)
    assert st.stats()["compute_dtype"] == "int8"


# ---------------------------------------------------------------------------
# ServingEngine: batch formation against the reference's engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def regs():
    """One registry a package with models "x" and "y" (conv nets from
    seeds 0 and 1) and "a" (the MLP), fp32, warmed."""
    out = {}
    for key, pkg in PKGS.items():
        reg = ModelRegistry() if pkg is tmx else JRegistry()
        kw = {"device": CPU} if pkg is tmx else {}
        for name, (net, args) in (("x", _conv(pkg, 0)), ("y", _conv(pkg, 1)),
                                  ("a", _mlp(pkg))):
            reg.add_model(name, net, args, {},
                          input_shapes=SHAPES["mlp" if name == "a"
                                              else "conv"],
                          buckets=BUCKETS, **kw)
        out[key] = reg
    return out


def _engine(key, regs, **kw):
    kw.setdefault("max_delay_ms", 20.0)
    kw.setdefault("max_batch", 4)
    return (ServingEngine if key == "port" else JEngine)(regs[key], **kw)


def _xc(n, seed=0):
    return _x("conv", n, seed)


def _no_overtake(key, regs):
    eng = _engine(key, regs, max_delay_ms=20.0, max_batch=4)
    release, stalled = threading.Event(), threading.Event()
    batches = []

    def hook(model, live):
        batches.append((model, [r.n for r in live]))
        stalled.set()
        release.wait(10)

    eng._dispatch_hook = hook
    try:
        f1 = eng.submit("x", data=_xc(1))
        assert stalled.wait(10)
        f2 = eng.submit("x", data=_xc(1))
        ys = [eng.submit("y", data=_xc(n, n)) for n in (2, 3, 1)]
        release.set()
        for f in [f1, f2] + ys:
            f.result(30)
    finally:
        release.set()
        eng.close()
    return batches


def test_engine_no_overtake_past_parked_matches_reference(regs):
    """Y a(2) / big(3) / c(1) queue behind a stalled X: with cap 4, big
    parks behind a, and c must not slip past it."""
    got = {key: _no_overtake(key, regs) for key in PKGS}
    assert got["port"] == got["ref"]
    assert [n for m, ns in got["port"] if m == "y" for n in ns] == [2, 3, 1]


def _tiers(key, regs):
    eng = _engine(key, regs, max_delay_ms=0, max_batch=1)
    gate = threading.Event()
    orders = []

    def hook(_model, reqs):
        orders.append([r.priority for r in reqs])
        gate.wait(10)

    eng._dispatch_hook = hook
    try:
        futs = [eng.submit("x", data=_xc(1))]
        time.sleep(0.1)
        futs += [eng.submit("x", data=_xc(1), priority="batch")
                 for _ in range(2)]
        futs += [eng.submit("x", data=_xc(1), priority="latency")
                 for _ in range(2)]
        with pytest.raises(Exception, match="priority tier"):
            eng.submit("x", data=_xc(1), priority="urgent")
        gate.set()
        for f in futs:
            f.result(30)
    finally:
        gate.set()
        eng.close()
    return orders


def test_engine_latency_tier_preempts_batch_as_reference(regs):
    got = {key: _tiers(key, regs) for key in PKGS}
    assert got["port"] == got["ref"]
    assert [p for b in got["port"] for p in b] == [
        "batch", "latency", "latency", "batch", "batch"]


def _quotas(key, regs):
    eng = _engine(key, regs, max_delay_ms=0, max_batch=1,
                  tenant_quotas={"noisy": 2}, max_inflight=4)
    gate = threading.Event()
    eng._dispatch_hook = lambda _model, _reqs: gate.wait(10)
    seen = []
    try:
        futs = [eng.submit("x", data=_xc(1), tenant="noisy")
                for _ in range(2)]
        with pytest.raises(Exception, match="inflight row quota"):
            eng.submit("x", data=_xc(1), tenant="noisy")
        futs += [eng.submit("x", data=_xc(1), tenant="quiet")
                 for _ in range(2)]
        seen.append(eng.stats()["tenant_rows"])
        with pytest.raises(Exception, match="inflight budget"):
            eng.submit("x", data=_xc(1))
        gate.set()
        for f in futs:
            f.result(30)
        st = eng.stats()
        seen.append((st["tenant_rows"], st["tenant_quotas"], st["shed"],
                     st["requests"], st["inflight"], st["max_inflight"]))
    finally:
        gate.set()
        eng.close()
    return seen


def test_engine_tenant_quota_and_admission_shed_as_reference(regs):
    got = {key: _quotas(key, regs) for key in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"] == [{"noisy": 2, "quiet": 2},
                           ({}, {"noisy": 2}, 2, 4, 0, 4)]


def test_engine_flush_ordering_under_seeded_loadgen(regs):
    """Per-model FIFO under a seeded open-loop schedule: the batches
    partition the submit order and respect the cap."""
    eng = _engine("port", regs, max_delay_ms=5.0, max_batch=4)
    batches = []
    eng._dispatch_hook = lambda model, live: batches.append(
        [id(r.future) for r in live])
    try:
        order = []

        def submit(i, n):
            f = eng.submit("x", data=_xc(1))
            order.append(id(f))
            return f

        res = run_loadgen(submit, OpenLoopSchedule(seed=3, n_requests=20,
                                                   qps=2000.0))
        assert res["ok"] == 20
        assert [fid for b in batches for fid in b] == order
        assert max(len(b) for b in batches) <= 4 and len(batches) < 20
    finally:
        eng.close()


def test_engine_results_match_store_and_classic_forward(regs):
    """Mixed sizes in one batch: each request gets exactly its rows, the
    rows of the bucketed batch run, and the classic Predictor's forward
    within rounding; a second model in the queue never joins."""
    reg = regs["port"]
    eng = _engine("port", regs, max_delay_ms=50.0, max_batch=4)
    batches = []
    eng._dispatch_hook = lambda model, live: batches.append(
        (model, [r.n for r in live]))
    try:
        xs = [_xc(n, 20 + n) for n in (2, 1, 1)]
        futs = [eng.submit("x", data=x) for x in xs]
        fa = eng.submit("a", data=_x("mlp", 1, 3))
        got = [f.result(30)[0] for f in futs]
        assert fa.result(30)[0].shape == (1, 10)
        st = eng.stats()
    finally:
        eng.close()
    assert batches[0] == ("x", [2, 1, 1]) and ("a", [1]) in batches
    whole = reg.store("x").run({"data": np.concatenate(xs)})[0][0].numpy()
    net, args = _conv(jmx, 0)
    ofs = 0
    for x, g in zip(xs, got):
        assert g.shape == (x.shape[0], 3)
        np.testing.assert_array_equal(g.numpy(), whole[ofs:ofs + len(x)])
        ofs += len(x)
        pred = jmx.Predictor(net.tojson(),
                             {"arg:%s" % k: v for k, v in args.items()},
                             {"data": x.shape})
        ref = pred.forward(data=x)[0].asnumpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-6, atol=1e-7)
    assert st["requests"] == 4 and st["rows"] == 5 and st["batches"] == 2
    assert st["padded_rows"] == 0 and st["max_rows_in_batch"] == 4
    assert st["weight_bytes_by_dtype"]["float32"] > 0
    with pytest.raises(MXNetError):
        eng.submit("x", data=_xc(1))


def test_engine_timeout_zero_and_cancel(regs):
    eng = _engine("port", regs, max_delay_ms=0.0, max_batch=1)
    eng._dispatch_hook = lambda model, live: time.sleep(0.15)
    try:
        blocker = eng.submit("x", data=_xc(1))
        time.sleep(0.02)
        doomed = eng.submit("x", timeout=0, data=_xc(1))
        timed = eng.submit("x", timeout=0.01, data=_xc(1))
        cancelled = eng.submit("x", data=_xc(1))
        assert cancelled.cancel()
        for f in (doomed, timed):
            with pytest.raises(ServeTimeout):
                f.result(30)
        assert blocker.result(30)[0].shape == (1, 3)
        deadline = time.time() + 5
        while eng.stats()["cancelled"] < 1 and time.time() < deadline:
            time.sleep(0.01)
        st = eng.stats()
        assert st["timeouts"] == 2 and st["cancelled"] == 1
    finally:
        eng.close()


@pytest.mark.parametrize("drain", [True, False])
def test_engine_close_drains_or_fails_queued(regs, drain):
    eng = _engine("port", regs, max_delay_ms=0.0, max_batch=1)
    eng._dispatch_hook = lambda model, live: time.sleep(0.05)
    futs = [eng.submit("x", data=_xc(1)) for _ in range(5)]
    eng.close(drain=drain)
    outcomes = {"ok": 0, "closed": 0}
    for f in futs:
        try:
            assert f.result(0)[0].shape == (1, 3)
            outcomes["ok"] += 1
        except ServeClosed:
            outcomes["closed"] += 1
    if drain:
        assert outcomes == {"ok": 5, "closed": 0}
    else:
        assert outcomes["closed"] >= 1 and sum(outcomes.values()) == 5
    with pytest.raises(ServeClosed):
        eng.submit("x", data=_xc(1))
    assert not eng.alive()
    eng.close()


def test_engine_warms_forward_models_on_its_thread(regs, monkeypatch):
    """The engine runs every forward model's buckets on its own thread
    before serving (PyTorch keeps cuDNN's plans per thread)."""
    seen = []
    warm = ProgramStore.warmup

    def recorded(self, execute=True):
        seen.append((self.name, threading.current_thread().name, execute))
        return warm(self, execute)

    monkeypatch.setattr(ProgramStore, "warmup", recorded)
    eng = _engine("port", regs)
    try:
        assert eng.submit("a", data=_x("mlp", 1, 1)).result(30)[0].shape \
            == (1, 10)
    finally:
        eng.close()
    assert sorted(seen) == [(m, "mxtt-serve-fwd", True)
                            for m in ("a", "x", "y")]


def test_engine_dispatch_builds_nothing_from_host_values(regs, monkeypatch):
    """The dispatch path copies each input once and builds no tensor from
    host values (``torch.tensor`` / ``as_tensor`` would be a blocking
    copy on the card)."""
    eng = _engine("port", regs, max_delay_ms=5.0)

    def refuse(*a, **k):
        raise AssertionError("a tensor built from host values on the "
                             "dispatch path")

    try:
        eng.submit("x", data=_xc(1)).result(30)
        monkeypatch.setattr(torch, "tensor", refuse)
        monkeypatch.setattr(torch, "as_tensor", refuse)
        futs = [eng.submit("x", data=_xc(n, n)) for n in (1, 2, 1)]
        for f in futs:
            f.result(30)
        assert eng.stats()["errors"] == 0
    finally:
        monkeypatch.undo()
        eng.close()


def test_engine_hot_swap_is_atomic_under_traffic():
    net, args = _mlp(tmx)
    _net, args2 = _mlp(tmx, seed=1)
    reg = ModelRegistry()
    st = reg.add_model("m", net, args, input_shapes=SHAPES["mlp"],
                       buckets=BUCKETS, device=CPU)
    xs = [_x("mlp", 1 + i % 3, 100 + i) for i in range(24)]
    v1 = [st.run({"data": x})[0][0].numpy() for x in xs]
    eng = ServingEngine(reg, max_delay_ms=2.0, max_batch=4)
    try:
        futs = []
        for i, x in enumerate(xs):
            futs.append(eng.submit("m", data=x))
            if i == 11:
                futs[0].result(30)
                assert reg.swap_params("m", args2) == 2
        got = [f.result(30)[0].numpy() for f in futs]
    finally:
        eng.close()
    v2 = [st.run({"data": x})[0][0].numpy() for x in xs]
    which = []
    for g, a, b in zip(got, v1, v2):
        ok_a = np.abs(g - a).max() <= 1e-6 * np.abs(a).max()
        ok_b = np.abs(g - b).max() <= 1e-6 * np.abs(b).max()
        assert ok_a != ok_b, "a result matches neither version, or both"
        which.append(ok_b)
    assert which == sorted(which) and not which[0] and which[-1]
    assert reg.stats()["m"]["version"] == 2


# ---------------------------------------------------------------------------
# Predictor, the artifact, the schedule, the protocol
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("serving", [False, True])
def test_predictor_matches_reference(serving):
    net, args = _conv(tmx)
    jnet, _ = _conv(jmx)
    params = {"arg:%s" % k: v for k, v in args.items()}
    x = _xc(3, 7)
    kw = {"serving": True, "buckets": BUCKETS} if serving else {}
    pred = tmx.Predictor(net.tojson(), params, {"data": (3, 3, 8, 8)},
                         dev_type="cpu", **kw)
    ref = jmx.Predictor(jnet.tojson(), params, {"data": (3, 3, 8, 8)}, **kw)
    got = pred.forward(data=x)[0].asnumpy()
    want = ref.forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pred.get_output(0), got)
    assert pred.get_output_shape(0) == (3, 3)
    if serving:
        assert pred.serving_stats()["compiles"] == 3
        one = pred.forward(data=x[:1])[0].asnumpy()
        np.testing.assert_allclose(one, want[:1], rtol=1e-6, atol=1e-7)
        assert pred.get_output_shape(0) == (1, 3)
    else:
        assert pred.serving_stats() is None


def test_predictor_defaults_to_the_card():
    """A difference by design: the reference's Predictor defaults to the
    CPU, the port's to cuda:0 (no card here: it refuses)."""
    net, args = _conv(tmx)
    params = {"arg:%s" % k: v for k, v in args.items()}
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.Predictor(net.tojson(), params, {"data": (1, 3, 8, 8)})
    with pytest.raises(MXNetError, match="dev_type"):
        tmx.Predictor(net.tojson(), params, {"data": (1, 3, 8, 8)},
                      dev_type="tpu")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_serving_artifact_reads_across_packages(tmp_path, writer):
    path = str(tmp_path / "m.mxsrv")
    pkg = PKGS[writer]
    net, args = _conv(pkg)
    pkg.deploy.to_serving(net, args, {}, {"data": (1, 3, 8, 8)}, path,
                          bucket_edges=(1, 2), compute_dtype="int8")
    x = _xc(2, 9)
    outs = {}
    for key, p in PKGS.items():
        reg = ModelRegistry() if p is tmx else JRegistry()
        kw = {"device": CPU} if p is tmx else {}
        st = reg.load_artifact("m", path, **kw)
        assert st.edges == (1, 2) and st.stats()["compute_dtype"] == "int8"
        outs[key] = _out(st.run({"data": x})[0][0])
        sym, arg, aux, meta = p.deploy.read_serving_artifact(path)
        assert meta["format_version"] == 1 and not aux
        assert meta["input_shapes"] == {"data": [1, 3, 8, 8]}
        assert sorted(arg) == sorted(args)
    np.testing.assert_allclose(outs["port"], outs["ref"], atol=1e-5)


def test_load_checkpoint_and_from_checkpoint(tmp_path):
    net, args = _conv(jmx)
    prefix = str(tmp_path / "ck")
    jmx.model.save_checkpoint(prefix, 3, net, {
        k: jmx.nd.array(v) for k, v in args.items()}, {})
    jmx.nd.waitall()
    reg = ModelRegistry()
    st = reg.load_checkpoint("m", prefix, 3, {"data": (1, 3, 8, 8)},
                             buckets=(1, 2), device=CPU)
    x = _xc(2, 4)
    pred = tmx.Predictor.from_checkpoint(prefix, 3, {"data": (2, 3, 8, 8)},
                                         dev_type="cpu")
    np.testing.assert_allclose(st.run({"data": x})[0][0].numpy(),
                               pred.forward(data=x)[0].asnumpy(),
                               rtol=1e-6, atol=1e-7)


def test_open_loop_schedule_matches_reference():
    kw = dict(seed=25, n_requests=64, qps=300.0, sizes=(1, 3, 5),
              size_weights=(6, 1, 1))
    got, want = OpenLoopSchedule(**kw), JSchedule(**kw)
    np.testing.assert_array_equal(got.arrivals, want.arrivals)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    assert (got.n, got.qps, got.seed) == (want.n, want.qps, want.seed)
    with pytest.raises(MXNetError):
        OpenLoopSchedule(qps=0)


def test_latency_protocol_returns_the_reference_dict():
    res = latency_protocol("int8", smoke=True, device=CPU)
    assert set(res) == {"mode", "seed", "model", "serial_closed",
                        "serial_open", "batch", "offered_mult",
                        "max_delay_ms", "max_batch", "qps_vs_per_request",
                        "p99_vs_per_request"}
    batch = res["batch"]
    assert batch["ok"] == batch["n"] == 120
    assert batch["timeouts"] + batch["errors"] + batch["cancelled"] == 0
    wb = batch["engine"]["models"]["m"]["weight_bytes"]
    assert wb["by_dtype"] == {"int8": 2048 * 512 + 10 * 2048,
                              "float32": 4 * (2048 + 2048 + 10 + 10)}
    assert res["serial_closed"]["n"] == 40
    with pytest.raises(MXNetError):
        latency_protocol("fp16", device=CPU)
