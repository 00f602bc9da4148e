"""Seeded open-loop load generator for the forward serving plane
(counterpart of the forward half of ``mxnet_tpu/serving/loadgen.py``).

Requests arrive on their own schedule whether or not the server keeps
up: the whole arrival process (exponential gaps, request sizes) is drawn
once from a seed into an :class:`OpenLoopSchedule`, so one seed replays
the same offered load (the same arrival times as the reference's for
that seed).  :func:`run_loadgen` drives any ``submit(i, n) -> Future``
on the schedule and reports latency percentiles and achieved QPS; a
request completes when its first output has been copied to the host, on
a waiter thread, never on the engine's.

:func:`latency_protocol` is the protocol behind bench.py's
``serving.latency.{fp32,bf16,int8}`` rows: ``Predictor.forward`` one
request at a time, closed loop (service latency and capacity), then a
per-request server and the continuous batcher under the same seeded
open-loop schedule at a multiple of that capacity.  It returns the
reference's dict.  The generation, front-door, fail-over, swap and
control-plane protocols are not ported yet.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..base import MXNetError
from ..context import default_device

__all__ = ["OpenLoopSchedule", "run_loadgen", "latency_protocol"]


class OpenLoopSchedule:
    """Deterministic seeded arrival schedule.

    ``arrivals[i]``: seconds after t0 at which request ``i`` is offered
    (cumulative exponential gaps at ``qps``); ``sizes[i]``: its rows,
    drawn from ``sizes`` / ``size_weights``; ``max_tokens[i]`` drawn the
    same way from ``gen_tokens`` (None without).  Same seed, same
    schedule."""

    def __init__(self, seed=0, n_requests=100, qps=100.0, sizes=(1,),
                 size_weights=None, gen_tokens=None,
                 gen_token_weights=None):
        if qps <= 0 or n_requests < 1:
            raise MXNetError("schedule needs qps > 0 and n_requests >= 1")
        rs = np.random.RandomState(int(seed))
        self.arrivals = np.cumsum(
            rs.exponential(1.0 / float(qps), int(n_requests)))
        p = None
        if size_weights is not None:
            p = np.asarray(size_weights, np.float64)
            p = p / p.sum()
        self.sizes = rs.choice(np.asarray(sizes, np.int64),
                               int(n_requests), p=p)
        self.max_tokens = None
        if gen_tokens is not None:
            pg = None
            if gen_token_weights is not None:
                pg = np.asarray(gen_token_weights, np.float64)
                pg = pg / pg.sum()
            self.max_tokens = rs.choice(
                np.asarray(gen_tokens, np.int64), int(n_requests), p=pg)
        self.seed = int(seed)
        self.qps = float(qps)
        self.n = int(n_requests)
        self.shape = "poisson"


def _fetch(x):
    """Copy an output (tensor or NDArray) to the host: the client-visible
    completion."""
    return getattr(x, "_data", x).cpu()


def _failed_future(exc=None):
    f = Future()
    f.set_exception(exc if exc is not None
                    else MXNetError("submit refused"))
    return f


def _drive_schedule(submit, schedule, on_success, settle_s, thread_name):
    """Offer ``submit(i)`` at the schedule's arrival times (open loop:
    on time even while earlier requests are in flight), classify the
    completions on a waiter thread (``on_success(result, t_submit)``
    makes a success's record, after any host fetch) and return
    ``(records, counts, span_s, slip_s)`` with ``records[i] = (status,
    payload or None, t_submit)``."""
    from .scheduler import ServeOverloaded, ServeTimeout
    n = schedule.n
    done_q = queue.Queue()
    records = [None] * n
    t_last_done = [0.0]

    def waiter():
        for _ in range(n):
            i, t_sub, fut = done_q.get()
            try:
                records[i] = ("ok", on_success(fut.result(), t_sub), t_sub)
            except Exception as e:  # noqa: BLE001 — tallied by class
                if fut.cancelled():
                    status = "cancelled"
                elif isinstance(e, ServeTimeout):
                    status = "timeout"
                elif isinstance(e, ServeOverloaded):
                    status = "shed"
                else:
                    status = "error"
                records[i] = (status, None, t_sub)
            t_last_done[0] = time.perf_counter()

    w = threading.Thread(target=waiter, name=thread_name, daemon=True)
    w.start()
    slip = 0.0
    t0 = time.perf_counter()
    for i in range(n):
        due = schedule.arrivals[i]
        now = time.perf_counter() - t0
        if due > now:
            time.sleep(due - now)
        else:
            slip = max(slip, now - due)
        t_sub = time.perf_counter()
        try:
            fut = submit(i)
        except Exception as e:  # noqa: BLE001 — classified by the waiter
            fut = _failed_future(e)
        fut.add_done_callback(
            lambda f, i=i, t=t_sub: done_q.put((i, t, f)))
    w.join(settle_s)
    if w.is_alive():
        raise MXNetError("loadgen waiter did not drain within %.0fs "
                         "(requests lost?)" % settle_s)
    counts = {}
    for r in records:
        key = r[0] if r else "lost"
        counts[key] = counts.get(key, 0) + 1
    span = max(t_last_done[0] - t0, 1e-9)
    return records, counts, span, slip


def run_loadgen(submit, schedule, fetch=True, settle_s=60.0,
                return_records=False):
    """Drive ``submit(i, n_rows) -> Future`` on an open-loop schedule.

    Returns the reference's summary dict: latency percentiles over the
    successful requests (submit to the first output on the host),
    achieved and offered QPS, failure counters and
    ``max_submit_slip_ms`` (how far the submitting thread fell behind
    the schedule).  ``return_records=True`` also returns the
    ``(status, latency_s, t_submit)`` records."""
    def on_success(res, t_sub):
        if fetch and res:
            _fetch(res[0])
        return time.perf_counter() - t_sub

    records, counts, span, slip = _drive_schedule(
        lambda i: submit(i, int(schedule.sizes[i])), schedule,
        on_success, settle_s, "mxtt-loadgen-wait")
    lats = np.asarray([r[1] for r in records if r and r[0] == "ok"])
    ok = counts.get("ok", 0)
    out = {
        "n": schedule.n,
        "ok": ok,
        "timeouts": counts.get("timeout", 0),
        "cancelled": counts.get("cancelled", 0),
        "shed": counts.get("shed", 0),
        "errors": counts.get("error", 0) + counts.get("lost", 0),
        "lost": counts.get("lost", 0),
        "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 3)
        if ok else None,
        "p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 3)
        if ok else None,
        "mean_ms": round(float(lats.mean()) * 1e3, 3) if ok else None,
        "max_ms": round(float(lats.max()) * 1e3, 3) if ok else None,
        "qps_offered": round(schedule.qps, 2),
        "qps_achieved": round(ok / span, 2),
        "rows": int(schedule.sizes.sum()),
        "duration_s": round(span, 3),
        "max_submit_slip_ms": round(slip * 1e3, 3),
        "seed": schedule.seed,
    }
    if return_records:
        return out, records
    return out


class _PerRequestServer:
    """The per-request baseline under open-loop load: one worker thread
    serves a FIFO queue by calling ``Predictor.forward`` for each request
    alone (no batching, no buckets), with the ServingEngine's Future
    interface."""

    def __init__(self, predictor, input_name="data"):
        self._pred = predictor
        self._input = input_name
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._work,
                                        name="mxtt-serial-serve",
                                        daemon=True)
        self._thread.start()

    def submit(self, x):
        fut = Future()
        self._q.put((x, fut))
        return fut

    def _work(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            x, fut = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                outs = self._pred.forward(**{self._input: x})
                # the device tensor: the loadgen's waiter fetches it,
                # the completion clock the batcher's futures get too
                fut.set_result([outs[0]._data])
            except Exception as e:  # noqa: BLE001 — to the future
                fut.set_exception(e)

    def close(self):
        self._q.put(None)
        self._thread.join(30)


def _smoke_model(feat, hidden, seed):
    """The protocol's MLP (``test_utils.smoke_mlp``) and its weights,
    uniform in [-0.3, 0.3] from ``seed``: the reference's bits."""
    from ..test_utils import smoke_mlp
    sym = smoke_mlp(num_hidden=hidden)
    shapes, _, _ = sym.infer_shape(data=(1, feat), softmax_label=(1,))
    rs = np.random.RandomState(seed)
    args = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name not in ("data", "softmax_label"):
            args[name] = np.asarray(
                rs.uniform(-0.3, 0.3, shape), np.float32)
    return sym, args


def latency_protocol(mode="fp32", smoke=False, seed=11, offered_mult=6.0,
                     max_delay_ms=2.0, max_batch=32, device=None):
    """The serving bench protocol, as the reference runs it.

    1. Per-request baseline, closed loop: ``Predictor.forward`` and the
       output's host fetch back to back: service latency and the
       per-request capacity C.
    2. Per-request baseline, open loop: the same Predictor behind a FIFO
       worker, driven by the seeded schedule at ``offered_mult`` x C.
    3. The continuous batcher (``ModelRegistry`` + ``ServingEngine``,
       the same weights, serving dtype ``mode``: 'fp32', 'bf16' or
       'int8', int8 through the ``dequant_matmul`` kernel) under the
       same schedule.

    ``device`` (the port's addition: its entry points run on ``cuda:0``
    unless asked otherwise) places both servers.  Returns the
    reference's dict, with ``qps_vs_per_request`` = the batcher's
    achieved QPS over the open-loop baseline's."""
    from ..predictor import Predictor
    from .registry import ModelRegistry
    from .scheduler import ServingEngine

    if mode not in ("fp32", "bf16", "int8"):
        raise MXNetError("mode must be fp32, bf16 or int8, got %r"
                         % mode)
    dev = default_device(device)
    feat, hidden = 512, 2048
    n_serial = 40 if smoke else 120
    n_load = 120 if smoke else 400
    sym, args = _smoke_model(feat, hidden, seed)
    rs = np.random.RandomState(seed + 1)
    pool = [np.asarray(rs.uniform(-1, 1, (1, feat)), np.float32)
            for _ in range(16)]

    pred = Predictor(sym.tojson(),
                     {"arg:%s" % k: v for k, v in args.items()},
                     {"data": (1, feat)},
                     dev_type="cpu" if dev.type == "cpu" else "gpu",
                     dev_id=dev.index or 0)
    # closed-loop service measurement, after a warm-up
    for i in range(5):
        pred.forward(data=pool[i % len(pool)])
        pred.get_output(0)
    lats = np.empty(n_serial)
    tic = time.perf_counter()
    for i in range(n_serial):
        t = time.perf_counter()
        pred.forward(data=pool[i % len(pool)])
        pred.get_output(0)          # host fetch: the client-visible value
        lats[i] = time.perf_counter() - t
    serial_qps = n_serial / (time.perf_counter() - tic)
    serial_closed = {
        "qps": round(serial_qps, 2),
        "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 3),
        "n": n_serial,
    }

    offered = serial_qps * float(offered_mult)
    schedule = OpenLoopSchedule(seed, n_load, offered, sizes=(1,))

    serial_srv = _PerRequestServer(pred)
    try:
        serial_open = run_loadgen(
            lambda i, n: serial_srv.submit(pool[i % len(pool)]),
            schedule, fetch=True)
    finally:
        serial_srv.close()

    registry = ModelRegistry()
    registry.add_model(
        "m", sym, args, {}, input_shapes={"data": (1, feat)},
        compute_dtype={"bf16": "bfloat16", "int8": "int8",
                       "fp32": None}[mode],
        device=dev, warmup=True)
    engine = ServingEngine(registry, max_delay_ms=max_delay_ms,
                           max_batch=max_batch)
    try:
        # warm the batched dispatch path, as the baseline was warmed
        for _ in range(3):
            for f in [engine.submit("m", data=pool[i % len(pool)])
                      for i in range(max_batch)]:
                f.result(60)
        batch = run_loadgen(
            lambda i, n: engine.submit("m", data=pool[i % len(pool)]),
            schedule, fetch=True)
        batch["engine"] = engine.stats()
    finally:
        engine.close()
    ratio = (batch["qps_achieved"] / serial_open["qps_achieved"]
             if serial_open["qps_achieved"] else None)
    return {
        "mode": mode,
        "seed": seed,
        "model": {"feat": feat, "hidden": hidden},
        "serial_closed": serial_closed,
        "serial_open": serial_open,
        "batch": batch,
        "offered_mult": float(offered_mult),
        "max_delay_ms": float(max_delay_ms),
        "max_batch": int(max_batch),
        "qps_vs_per_request": round(ratio, 3) if ratio else None,
        "p99_vs_per_request": (
            round(batch["p99_ms"] / serial_open["p99_ms"], 4)
            if batch["p99_ms"] and serial_open["p99_ms"] else None),
    }
