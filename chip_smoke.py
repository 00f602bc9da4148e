#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; builds the port's kernels from the
sources in this checkout on first use.  Phases, each fatal on failure:

1. build the CUDA kernels (``mxnet_tpu_torch/kernels/csrc/*.cu``);
2. run each kernel at the serving path's shapes and hold it against its
   plain PyTorch version on the card (norms: rows 32 and 1024, width
   512, tolerance 1e-5 x max|ref|; paged attention: B=32, H=8, D=64,
   block 64, 16-block tables, Lq 1 and 32, ragged positions, shared
   blocks and trash-block entries, tolerance 1e-4 absolute);
3. serve the transformer LM at full width (4 layers, hidden 512, 8
   heads, vocab 8192, random weights from seed 0) through
   ``ModelRegistry`` + ``GenerationEngine`` with the default knobs: 16
   requests, four sharing a 128-token prefix, two sampled; every kernel
   must have launched during the run;
4. the card against the CPU: one prefill chunk and one decode step of
   ``paged_step_apply`` (logits within 1e-3), then the greedy streams of
   phase 3 against a CPU engine (a stream may differ only where the CPU's
   top-2 logit margin is below 1e-3);
5. time each kernel, its plain version and one PyTorch library call with
   CUDA events (median of 60 launches queued behind a GPU spin, so each
   event pair brackets device time), beside the kernel's bound.

The last lines are a JSON object of per-kernel numbers, the card's name
and power limit as nvidia-smi reports them, and the result object.
Exits non-zero, printing no result, without a CUDA device.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import _build, norm, paged_attention
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import GenerationEngine, ModelRegistry, TokenStream

SPEC = tlm.lm_spec(num_layers=4, num_hidden=512, num_heads=8,
                   vocab_size=8192)
NORM_ROWS, NORM_W = (32, 1024), 512
PA = dict(B=32, H=8, D=64, bs=64, T=16, num_blocks=513)
PA_LQ = (1, 32)
MAX_TOKENS = 64
SOURCES = {
    "rms_norm": ("mxnet_tpu_torch/kernels/csrc/norm.cu",
                 "mxnet_tpu/pallas_ops/norm.py:47"),
    "layer_norm": ("mxnet_tpu_torch/kernels/csrc/norm.cu",
                   "mxnet_tpu/pallas_ops/norm.py:110"),
    "flash_attention_paged": ("mxnet_tpu_torch/kernels/csrc/paged_attention.cu",
                              "mxnet_tpu/pallas_ops/paged_attention.py:41"),
}


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_rates(name):
    """(memory bytes/s, fp32 CUDA-core flop/s) of the card, from NVIDIA's
    data sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s, PCIe 2.0 TB/s and
    51 TFLOP/s."""
    if "H100" not in name:
        raise SystemExit("chip_smoke: no rate table for card %r" % name)
    if "PCIe" in name:
        return 2.0e12, 51e12, "H100 PCIe"
    return 3.35e12, 67e12, "H100 SXM"


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def norm_inputs(rows, dev):
    rs = np.random.RandomState(rows)
    x = rs.randn(rows, NORM_W).astype(np.float32)
    g = rs.uniform(0.5, 1.5, NORM_W).astype(np.float32)
    b = rs.randn(NORM_W).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, g, b)]


def paged_inputs(lq, dev):
    """A paged case at the serving shapes: ragged positions, every
    sequence after the first sharing sequence 0's first physical block,
    unused table entries at the trash block 0, junk in every pool row."""
    B, H, D, bs, T, nb = (PA[k] for k in ("B", "H", "D", "bs", "T",
                                          "num_blocks"))
    rs = np.random.RandomState(100 + lq)
    q = rs.randn(B, H, lq, D).astype(np.float32)
    kp = rs.randn(H, nb * bs, D).astype(np.float32)
    vp = rs.randn(H, nb * bs, D).astype(np.float32)
    pos = rs.randint(0, T * bs - lq + 1, B).astype(np.int32)
    tables = np.zeros((B, T), np.int32)
    nxt = 1
    for b in range(B):
        for j in range(-(-int(pos[b] + lq) // bs)):
            if b > 0 and j == 0:
                tables[b, j] = tables[0, 0]
            else:
                tables[b, j] = nxt
                nxt += 1
    assert nxt <= nb
    return [torch.from_numpy(a).to(dev) for a in (q, kp, vp, tables, pos)]


def paged_work(tables, pos, lq):
    """(bytes, flops) this case needs: q and out once, each K/V pool row
    some query can see once (shared blocks counted once), tables and
    positions; 4*D flops per visible (query row, key, head)."""
    B, H, D, bs = PA["B"], PA["H"], PA["D"], PA["bs"]
    tables, pos = tables.cpu().numpy(), pos.cpu().numpy()
    rows = set()
    keys = 0
    for b in range(B):
        last = int(pos[b]) + lq - 1
        for p in range(last + 1):
            rows.add(int(tables[b, p // bs]) * bs + p % bs)
        keys += sum(int(pos[b]) + r + 1 for r in range(lq))
    nbytes = 4 * (2 * B * H * lq * D + 2 * len(rows) * H * D +
                  tables.size + pos.size)
    return nbytes, 4 * D * H * keys


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build():
    tic = time.perf_counter()
    _build.library()
    info = _build.build_info()
    log("phase 1 build: %.2f s (compiled=%s) -> %s"
        % (time.perf_counter() - tic, info["built"], info["path"]))
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  ptxas:", line.strip())


def phase_compare(dev):
    """Each kernel against its plain version at the path's shapes."""
    errs = {}
    for rows in NORM_ROWS:
        x, g, b = norm_inputs(rows, dev)
        for name, got, want in (
                ("rms_norm", norm.rms_norm(x, g, 1e-6),
                 norm.rms_norm_reference(x, g, 1e-6)),
                ("layer_norm", norm.layer_norm(x, g, b, 1e-5),
                 norm.layer_norm_reference(x, g, b, 1e-5))):
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 1e-5 * want.abs().max().item()
            log("phase 2 %s rows=%d width=%d: max_abs_err %.3e (tol %.3e)"
                % (name, rows, NORM_W, err, tol))
            if not err <= tol:
                raise SystemExit("chip_smoke: %s disagrees with its plain "
                                 "version" % name)
            errs[(name, rows)] = err
    for lq in PA_LQ:
        q, kp, vp, tbl, pos = paged_inputs(lq, dev)
        got = paged_attention.flash_attention_paged(q, kp, vp, tbl, pos,
                                                    PA["bs"])
        want = paged_attention.paged_attention_reference(q, kp, vp, tbl,
                                                         pos, PA["bs"])
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise SystemExit("chip_smoke: paged attention gave non-finite "
                             "values")
        err = (got - want).abs().max().item()
        log("phase 2 flash_attention_paged B=%d H=%d Lq=%d D=%d bs=%d "
            "T=%d: max_abs_err %.3e (tol 1e-4)"
            % (PA["B"], PA["H"], lq, PA["D"], PA["bs"], PA["T"], err))
        if not err <= 1e-4:
            raise SystemExit("chip_smoke: flash_attention_paged disagrees "
                             "with its plain version")
        errs[("flash_attention_paged", lq)] = err
    return errs


def make_requests():
    """16 prompts of 16..384 tokens from a seed; requests 3, 6, 9 and 12
    share a 128-token prefix; requests 5 and 10 sample."""
    rs = np.random.RandomState(1)
    shared = list(rs.randint(0, SPEC["vocab_size"], 128))
    reqs = []
    for i in range(16):
        n = int(rs.randint(16, 385))
        if i in (3, 6, 9, 12):
            n = max(n, 160)
            prompt = shared + list(rs.randint(0, SPEC["vocab_size"],
                                              n - 128))
        else:
            prompt = list(rs.randint(0, SPEC["vocab_size"], n))
        kw = dict(tokens=[int(t) for t in prompt], max_tokens=MAX_TOKENS)
        if i in (5, 10):
            kw.update(temperature=0.8, top_k=40, seed=1000 + i)
        reqs.append(kw)
    return reqs


def serve(reg, reqs):
    """Submit ``reqs``; the three later sharers of the 128-token prefix go
    in once the first sharer's prompt is prefilled (its first token is
    out), so they can adopt its blocks.  Returns (results, seconds,
    engine stats)."""
    late = (6, 9, 12)
    eng = GenerationEngine(reg)
    try:
        tic = time.perf_counter()
        stream = TokenStream()
        futs = {}
        for i, kw in enumerate(reqs):
            if i not in late:
                futs[i] = eng.submit("lm", stream=stream if i == 3 else None,
                                     **kw)
        next(stream)
        for i in late:
            futs[i] = eng.submit("lm", **reqs[i])
        results = [futs[i].result(600) for i in range(len(reqs))]
        seconds = time.perf_counter() - tic
        stats = eng.stats()
    finally:
        eng.close()
    return results, seconds, stats


def check_results(results, reqs):
    for r, kw in zip(results, reqs):
        if len(r.tokens) != kw["max_tokens"] or \
                not all(0 <= t < SPEC["vocab_size"] for t in r.tokens):
            raise SystemExit("chip_smoke: bad generation %r" % (r,))


def phase_serve(params):
    tic = time.perf_counter()
    reg = ModelRegistry()
    store = reg.add_generative_model("lm", params, SPEC)
    log("phase 3 registry + warmup on %s: %.2f s; pool %d blocks of %d "
        "tokens, %.1f MB"
        % (store.device, time.perf_counter() - tic, store.pool_blocks,
           store.kv_block,
           2 * 4 * SPEC["num_layers"] * SPEC["num_hidden"] *
           store.pool_blocks * store.kv_block / 1e6))
    reqs = make_requests()
    kernels.reset_launch_counts()
    results, seconds, stats = serve(reg, reqs)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_results(results, reqs)
    ntok = sum(len(r.tokens) for r in results)
    steps = stats["decode_steps"] + stats["prefills"]
    log("phase 3 served %d requests, %d tokens in %.3f s: %.1f generated "
        "tokens/s, %.3f ms per step; prefix_hits %d cow_forks %d "
        "prefill_chunks %d decode_steps %d chunk_steps %d; launches %s"
        % (len(results), ntok, seconds, ntok / seconds,
           seconds * 1e3 / steps, stats["prefix_hits"], stats["cow_forks"],
           stats["prefill_chunks"], stats["decode_steps"],
           stats["prefills"], counts))
    for name in kernels.KERNELS:
        if counts[name] <= 0:
            raise SystemExit("chip_smoke: %s never launched on the main "
                             "path" % name)
    if stats["prefix_hits"] < 3 or stats["cow_forks"] < 1:
        raise SystemExit("chip_smoke: the shared-prefix requests did not "
                         "share blocks")
    return reg, reqs, results, counts, ntok / seconds


def top2_margin(model_cpu, tokens):
    """CPU logit margin between the best and second-best next token
    after ``tokens`` (one sequence, one chunk)."""
    bs = 64
    T = -(-len(tokens) // bs)
    pk, pv = tlm.init_pool(SPEC, T + 1, bs)
    tables = np.arange(1, T + 1, dtype=np.int32)[None]
    logits, _, _ = model_cpu(pk, pv, tables, np.asarray([tokens], np.int32),
                             np.zeros(1, np.int32),
                             np.asarray([len(tokens)], np.int32), bs)
    top = torch.topk(logits[0], 2).values
    return (top[0] - top[1]).item()


def phase_card_vs_cpu(params, reg, reqs, gpu_results):
    model_gpu = reg.gen_store("lm").model
    model_cpu = tlm.TransformerLM.from_numpy(params, SPEC, device="cpu")
    bs, B, T = 64, 4, 4
    rs = np.random.RandomState(7)
    tables = np.arange(1, B * T + 1, dtype=np.int32).reshape(B, T)
    chunk = rs.randint(0, SPEC["vocab_size"], (B, 32)).astype(np.int32)
    valid = np.array([32, 20, 7, 32], np.int32)
    pools = {}
    for m in (model_gpu, model_cpu):
        pools[m] = tlm.init_pool(SPEC, B * T + 1, bs, device=m.device)
    for tag, toks, pos, val in (
            ("prefill chunk", chunk, np.zeros(B, np.int32), valid),
            ("decode step", chunk[:, :1], valid, np.ones(B, np.int32))):
        out = {}
        for m in (model_gpu, model_cpu):
            with torch.no_grad():
                logits, _, _ = m(*pools[m], tables, toks, pos, val, bs)
            out[m] = logits.cpu()
        err = (out[model_gpu] - out[model_cpu]).abs().max().item()
        log("phase 4 %s logits card vs CPU: max_abs_err %.3e (tol 1e-3)"
            % (tag, err))
        if not (err <= 1e-3 and bool(torch.isfinite(out[model_gpu]).all())):
            raise SystemExit("chip_smoke: card and CPU logits disagree")
    cpu_reg = ModelRegistry()
    cpu_reg.add_generative_model("lm", params, SPEC, device="cpu")
    tic = time.perf_counter()
    cpu_results, _, _ = serve(cpu_reg, reqs)
    check_results(cpu_results, reqs)
    same = 0
    greedy = [i for i, kw in enumerate(reqs) if "temperature" not in kw]
    for i in greedy:
        a, b = gpu_results[i].tokens, cpu_results[i].tokens
        if a == b:
            same += 1
            continue
        k = next(j for j in range(len(a)) if a[j] != b[j])
        margin = top2_margin(model_cpu, reqs[i]["tokens"] + b[:k])
        log("phase 4 stream %d differs at step %d: CPU top-2 margin %.3e"
            % (i, k, margin))
        if not margin < 1e-3:
            raise SystemExit("chip_smoke: greedy stream %d differs from the "
                             "CPU engine's where the CPU is not near a tie"
                             % i)
    log("phase 4 greedy streams card == CPU: %d of %d (CPU engine %.1f s)"
        % (same, len(greedy), time.perf_counter() - tic))


def time_ms(fn, n=60):
    """Median device milliseconds of ``fn`` over ``n`` launches, queued
    behind a GPU spin so the launches run back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def library_paged(q, kp, vp, tbl, pos, bs):
    """Gather K/V through the tables, then one
    ``scaled_dot_product_attention`` with the offset-causal mask (the
    gather is inside the timing)."""
    B, H, Lq, D = q.shape
    T = tbl.shape[1]
    idx = (tbl.long()[:, :, None] * bs +
           torch.arange(bs, device=q.device)).reshape(B, T * bs)
    k = kp[:, idx].permute(1, 0, 2, 3)
    v = vp[:, idx].permute(1, 0, 2, 3)
    mask = (pos.long()[:, None, None] +
            torch.arange(Lq, device=q.device)[:, None]) >= \
        torch.arange(T * bs, device=q.device)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None])


def phase_times(dev, card, errs, counts):
    mem_rate, flop_rate, rate_name = card_rates(torch.cuda.get_device_name(0))
    F = torch.nn.functional
    entries = {}

    def record(name, shape, fn, plain, library, nbytes, flops, err):
        ms, plain_ms, lib_ms = time_ms(fn), time_ms(plain), time_ms(library)
        t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / flop_rate * 1e3
        row = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops, "max_abs_err": err}
        log("phase 5 %s %s: kernel %.4f ms, plain %.4f ms, library %.4f ms, "
            "bound %.4f ms (%s, %s rates) [%s]"
            % (name, shape, ms, plain_ms, lib_ms, row["bound_ms"],
               row["bound_by"], rate_name, card))
        entries.setdefault(name, []).append(row)

    for rows in NORM_ROWS:
        x, g, b = norm_inputs(rows, dev)
        n = rows * NORM_W
        record("rms_norm", "rows=%d width=%d" % (rows, NORM_W),
               lambda: norm.rms_norm(x, g, 1e-6),
               lambda: norm.rms_norm_reference(x, g, 1e-6),
               lambda: F.rms_norm(x, (NORM_W,), g, 1e-6),
               4 * (2 * n + NORM_W), 4 * n, errs[("rms_norm", rows)])
        record("layer_norm", "rows=%d width=%d" % (rows, NORM_W),
               lambda: norm.layer_norm(x, g, b, 1e-5),
               lambda: norm.layer_norm_reference(x, g, b, 1e-5),
               lambda: F.layer_norm(x, (NORM_W,), g, b, 1e-5),
               4 * (2 * n + 2 * NORM_W), 8 * n, errs[("layer_norm", rows)])
    for lq in PA_LQ:
        q, kp, vp, tbl, pos = paged_inputs(lq, dev)
        bs = PA["bs"]
        lib_err = (library_paged(q, kp, vp, tbl, pos, bs) -
                   paged_attention.paged_attention_reference(
                       q, kp, vp, tbl, pos, bs)).abs().max().item()
        log("phase 5 library yardstick for paged attention: table gather + "
            "scaled_dot_product_attention, the gather inside the timing; "
            "Lq=%d vs plain: max_abs_err %.3e" % (lq, lib_err))
        nbytes, flops = paged_work(tbl, pos, lq)
        record("flash_attention_paged",
               "B=%d H=%d Lq=%d D=%d bs=%d T=%d" % (
                   PA["B"], PA["H"], lq, PA["D"], bs, PA["T"]),
               lambda: paged_attention.flash_attention_paged(
                   q, kp, vp, tbl, pos, bs),
               lambda: paged_attention.paged_attention_reference(
                   q, kp, vp, tbl, pos, bs),
               lambda: library_paged(q, kp, vp, tbl, pos, bs),
               nbytes, flops, errs[("flash_attention_paged", lq)])
    out = []
    for name, rows in entries.items():
        head = rows[0]   # the decode-tick shape (rows=32 / Lq=1)
        src, replaces = SOURCES[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[name],
                    "max_abs_err": max(r["max_abs_err"] for r in rows),
                    "ms": head["ms"], "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"],
                    "bound_by": head["bound_by"],
                    "library_ms": head["library_ms"],
                    "shape": head["shape"], "shapes": rows})
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log("card: %s; torch %s, CUDA %s" % (card, torch.__version__,
                                         torch.version.cuda))
    phase_build()
    errs = phase_compare(dev)
    params = tlm.random_params(SPEC, seed=0)
    reg, reqs, results, counts, tok_s = phase_serve(params)
    phase_card_vs_cpu(params, reg, reqs, results)
    kern = phase_times(dev, card, errs, counts)
    log("phase 5 engine: %.1f generated tokens/s at full width [%s]"
        % (tok_s, card))
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
