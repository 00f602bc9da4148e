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
   event pair brackets device time), beside the kernel's bound;
2+. the training path's kernels against their plain versions at training
   width: the norm backwards at 4096 x 512, the loss head's softmax and
   gradient at 4096 x 8192 (1e-5 x max|ref|), flash attention at B16 H8
   L256 D64, causal and not (1e-4 absolute);
6. train the transformer LM at full width (4 layers, hidden 512, 8 heads,
   vocab 8192, seq_len 256, batch 16) through ``Module.fit`` for 20 SGD
   steps (momentum 0.9, learning rate 0.005) on a successor language:
   exact kernel launches per step, finite loss, falling perplexity, ms
   per step and samples/s;
7. one training step from identical parameters on the card and on the
   CPU (TF32 off): probabilities and every gradient within 1e-3 x
   max|ref|;
5+. the training kernels' times at their training shapes.

``python3 chip_smoke.py --profile`` adds, after phase 6, a
``torch.profiler`` window over five training steps: device time and
launches per step, the device's busy share, and the ops with the most
device time.

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

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import (_build, flash_attention, norm,
                                     paged_attention, softmax_xent)
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import GenerationEngine, ModelRegistry, TokenStream

SPEC = tlm.lm_spec(num_layers=4, num_hidden=512, num_heads=8,
                   vocab_size=8192)
TRAIN_BATCH, TRAIN_SEQ = 16, 256
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
TRAIN_ATT = (TRAIN_BATCH, SPEC["num_heads"], TRAIN_SEQ,
             SPEC["num_hidden"] // SPEC["num_heads"])
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
    "rms_norm_bwd": ("mxnet_tpu_torch/kernels/csrc/norm.cu",
                     "mxnet_tpu/pallas_ops/norm.py:54"),
    "layer_norm_bwd": ("mxnet_tpu_torch/kernels/csrc/norm.cu",
                       "mxnet_tpu/pallas_ops/norm.py:120"),
    "softmax_rows": ("mxnet_tpu_torch/kernels/csrc/softmax_xent.cu",
                     "mxnet_tpu/pallas_ops/softmax_xent.py:67"),
    "xent_grad_from_probs": ("mxnet_tpu_torch/kernels/csrc/softmax_xent.cu",
                             "mxnet_tpu/pallas_ops/softmax_xent.py:82"),
    "flash_attention": ("mxnet_tpu_torch/kernels/csrc/flash_attention.cu",
                        "mxnet_tpu/pallas_ops/flash_attention.py:62"),
}
SERVE_KERNELS = ("rms_norm", "layer_norm", "flash_attention_paged")
# kernel launches of one training step of the 4-layer LM: two RMSNorms
# and one attention per block, the final LayerNorm, the loss head
TRAIN_LAUNCHES_PER_STEP = {
    "rms_norm": 8, "rms_norm_bwd": 8, "layer_norm": 1, "layer_norm_bwd": 1,
    "softmax_rows": 1, "xent_grad_from_probs": 1, "flash_attention": 4}
TRAIN_STEPS, TRAIN_WARMUP = 20, 5
# bench.py's SGD with momentum 0.9, at a tenth of its learning rate: its
# 0.05 was set for random tokens, whose loss nobody reads; on the
# successor language at this width it diverges by the fourth step.
# SoftmaxOutput's gradient sums the 256 tokens of each sample, so a rate
# of 0.005 is 1.28 on the mean over tokens.
TRAIN_OPT = {"learning_rate": 0.005, "momentum": 0.9}


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


def train_kernel_inputs(dev):
    """Seeded inputs of the training path's kernels at full width."""
    rs = np.random.RandomState(11)
    B, H, L, D = TRAIN_ATT
    out = dict(
        x=rs.randn(TRAIN_ROWS, SPEC["num_hidden"]).astype(np.float32),
        dy=rs.randn(TRAIN_ROWS, SPEC["num_hidden"]).astype(np.float32),
        g=rs.uniform(0.5, 1.5, SPEC["num_hidden"]).astype(np.float32),
        b=rs.randn(SPEC["num_hidden"]).astype(np.float32),
        logits=(3 * rs.randn(TRAIN_ROWS, SPEC["vocab_size"])).astype(
            np.float32),
        label=rs.randint(0, SPEC["vocab_size"], TRAIN_ROWS).astype(
            np.float32),
        q=rs.randn(B, H, L, D).astype(np.float32),
        k=rs.randn(B, H, L, D).astype(np.float32),
        v=rs.randn(B, H, L, D).astype(np.float32))
    return {n: torch.from_numpy(a).to(dev) for n, a in out.items()}


def train_kernel_cases(t):
    """name -> (kernel call, plain call, tolerance kind) for each new
    entry point at the training shapes; outputs are tuples."""
    sm = softmax_xent.softmax_rows_reference(t["logits"])
    scale = 1.0 / TRAIN_ROWS
    return {
        "rms_norm_bwd": (
            lambda: norm.rms_norm_bwd(t["x"], t["g"], t["dy"], 1e-6),
            lambda: norm.rms_norm_bwd_reference(t["x"], t["g"], t["dy"],
                                                1e-6), "rel"),
        "layer_norm_bwd": (
            lambda: norm.layer_norm_bwd(t["x"], t["g"], t["dy"], 1e-5),
            lambda: norm.layer_norm_bwd_reference(t["x"], t["g"], t["dy"],
                                                  1e-5), "rel"),
        "softmax_rows": (
            lambda: (softmax_xent.softmax_rows(t["logits"]),),
            lambda: (softmax_xent.softmax_rows_reference(t["logits"]),),
            "rel"),
        "xent_grad_from_probs": (
            lambda: (softmax_xent.xent_grad_from_probs(sm, t["label"],
                                                       scale),),
            lambda: (softmax_xent.xent_grad_from_probs_reference(
                sm, t["label"], scale),), "rel"),
        "flash_attention": (
            lambda: (flash_attention.flash_attention(t["q"], t["k"], t["v"],
                                                     True),),
            lambda: (flash_attention.blockwise_attention(
                t["q"], t["k"], t["v"], True),), "abs"),
        "flash_attention non-causal": (
            lambda: (flash_attention.flash_attention(t["q"], t["k"], t["v"],
                                                     False),),
            lambda: (flash_attention.blockwise_attention(
                t["q"], t["k"], t["v"], False),), "abs"),
    }


def phase_compare_train(dev):
    """Each training kernel against its plain version at full width:
    norms 4096 x 512 (every output within 1e-5 x max|ref|), the loss
    head 4096 x 8192 (same), flash attention B16 H8 L256 D64, causal and
    not (1e-4 absolute, as paged attention in phase 2)."""
    t = train_kernel_inputs(dev)
    errs = {}
    for name, (kern, plain, kind) in train_kernel_cases(t).items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, tol = 0.0, 0.0
        for a, b in zip(got, want):
            if not bool(torch.isfinite(a).all()):
                raise SystemExit("chip_smoke: %s gave non-finite values"
                                 % name)
            e = (a - b).abs().max().item()
            bound = 1e-5 * b.abs().max().item() if kind == "rel" else 1e-4
            if not e <= bound:
                raise SystemExit("chip_smoke: %s disagrees with its plain "
                                 "version: %.3e > %.3e" % (name, e, bound))
            err, tol = max(err, e), max(tol, bound)
        log("phase 2 %s: max_abs_err %.3e (tol %.3e)" % (name, err, tol))
        errs[name.split()[0]] = max(errs.get(name.split()[0], 0.0), err)
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
    for name in SERVE_KERNELS:
        if counts[name] <= 0:
            raise SystemExit("chip_smoke: %s never launched on the serving "
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


def train_data(n):
    """``n`` token grids of the successor language of the JAX package's
    convergence test at the full vocabulary: x[t+1] = x[t] + 1 mod V,
    the label the next token."""
    rs = np.random.RandomState(2)
    V = SPEC["vocab_size"]
    X = (rs.randint(0, V, (n, 1)) + np.arange(TRAIN_SEQ)) % V
    return X.astype(np.float32), ((X + 1) % V).astype(np.float32)


def train_symbol():
    return mx.models.transformer_lm(seq_len=TRAIN_SEQ, **SPEC)


def phase_train(dev, card):
    """``Module.fit`` at full width for TRAIN_STEPS SGD steps, set up as
    the repo's on-chip training row (bench.py) but for the learning rate
    (see TRAIN_OPT); returns the launch counts of the whole run and the
    ms per step after the warmup."""
    X, y = train_data(TRAIN_STEPS * TRAIN_BATCH)
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    mx.random.seed(0)
    mod = mx.Module(train_symbol(), context=dev)
    ppl, steps, clock = [], [], {}
    last = {}

    def on_batch(param):
        # per-step perplexity and launches; the metric's host fetch
        # already synchronises every step
        ppl.append(float(param.eval_metric.get()[1]))
        param.eval_metric.reset()
        now = kernels.launch_counts()
        steps.append({k: now[k] - last[k] for k in now})
        last.update(now)
        if param.nbatch in (TRAIN_WARMUP - 1, TRAIN_STEPS - 1):
            torch.cuda.synchronize()
            clock[param.nbatch] = time.perf_counter()

    kernels.reset_launch_counts()
    last.update(kernels.launch_counts())
    tic = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=TRAIN_OPT, initializer=mx.init.Xavier(),
            eval_metric=mx.metric.Perplexity(ignore_label=None),
            batch_end_callback=on_batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - tic
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(TRAIN_LAUNCHES_PER_STEP)
    if len(steps) != TRAIN_STEPS:
        raise SystemExit("chip_smoke: fit ran %d steps, not %d"
                         % (len(steps), TRAIN_STEPS))
    for i, got in enumerate(steps):
        if got != want:
            raise SystemExit("chip_smoke: training step %d launched %s, "
                             "want %s" % (i, got, want))
    if counts != {k: v * TRAIN_STEPS for k, v in want.items()}:
        raise SystemExit("chip_smoke: training launches %s" % counts)
    probs = mod.get_outputs()[0]._data
    if not (all(np.isfinite(ppl)) and bool(torch.isfinite(probs).all())):
        raise SystemExit("chip_smoke: training gave a non-finite loss")
    first, final = (float(np.mean(ppl[:5])), float(np.mean(ppl[-5:])))
    log("phase 6 perplexity per step: %s" % " ".join("%.1f" % p for p in ppl))
    if not final < first:
        raise SystemExit("chip_smoke: perplexity did not fall: first 5 "
                         "steps %.2f, last 5 %.2f" % (first, final))
    timed = TRAIN_STEPS - TRAIN_WARMUP
    sec = clock[TRAIN_STEPS - 1] - clock[TRAIN_WARMUP - 1]
    step_ms = sec * 1e3 / timed
    log("phase 6 trained %d steps (fit %.2f s with bind and init): "
        "perplexity first 5 steps %.2f, last 5 %.2f; launches per step %s; "
        "steps %d..%d: %.3f ms per step, %.1f samples/s, %.0f tokens/s [%s]"
        % (TRAIN_STEPS, wall, first, final, TRAIN_LAUNCHES_PER_STEP,
           TRAIN_WARMUP + 1, TRAIN_STEPS, step_ms,
           timed * TRAIN_BATCH / sec, timed * TRAIN_BATCH * TRAIN_SEQ / sec,
           card))
    return counts, step_ms


def profile_train(dev, card, step_ms, warmup=3, steps=5):
    """``--profile``: ``torch.profiler`` over ``steps`` steps of
    ``Module.fit`` after ``warmup`` (the setup of phase 6).  Prints the
    device time and launches per step, the device's busy share of
    phase 6's unprofiled ``step_ms``, and the ops with the most device
    time.  Host times under the profiler are inflated by its own
    overhead, so none is printed but the window's."""
    X, y = train_data((warmup + steps) * TRAIN_BATCH)
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    mx.random.seed(0)
    mod = mx.Module(train_symbol(), context=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    clock = {}

    def on_batch(param):
        if param.nbatch in (warmup - 1, warmup + steps - 1):
            torch.cuda.synchronize()
            clock[param.nbatch] = time.perf_counter()
            (prof.start if param.nbatch == warmup - 1 else prof.stop)()

    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=TRAIN_OPT,
            initializer=mx.init.Xavier(),
            eval_metric=mx.metric.Perplexity(ignore_label=None),
            batch_end_callback=on_batch)
    window_ms = (clock[warmup + steps - 1] - clock[warmup - 1]) * 1e3 / steps
    avgs = prof.key_averages()
    on_card = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in on_card) / 1e3 / steps
    launches = sum(e.count for e in on_card) / steps
    log("profile %d steps: device %.3f ms per step in %.0f kernels and "
        "copies, %.1f%% of phase 6's %.3f ms per step (%.3f ms per step "
        "under the profiler) [%s]"
        % (steps, dev_ms, launches, 100 * dev_ms / step_ms, step_ms,
           window_ms, card))
    ops = [e for e in avgs if e not in on_card]
    for e in sorted(ops, key=lambda e: e.self_device_time_total,
                    reverse=True)[:15]:
        log("profile op: %8.3f ms device per step, %6.1f calls per step: %s"
            % (e.self_device_time_total / 1e3 / steps, e.count / steps,
               e.key[:80]))


def one_step(dev, params):
    """Probabilities and every gradient of one training step on ``dev``,
    as numpy arrays by name."""
    X, y = train_data(TRAIN_BATCH)
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    mod = mx.Module(train_symbol(), context=dev)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=params)
    tic = time.perf_counter()
    mod.forward_backward(next(iter(it)))
    ex = mod._exec_group.executor
    out = {"probabilities": ex.outputs[0].asnumpy()}
    out.update((n, g.asnumpy()) for n, g in ex.grad_dict.items())
    log("phase 7 one step on %s: %.2f s" % (dev, time.perf_counter() - tic))
    return out


def phase_train_vs_cpu(dev):
    """One training step from the same parameters and batch on the card
    and on the CPU (the plain versions): probabilities and every
    gradient within 1e-3 x max|ref|.  The FFN biases are shifted up by 1
    so that every ReLU input lies far from zero: at a kink, an input
    that rounding puts on the other side of zero passes or stops a whole
    gradient term, and single elements then differ by far more than the
    kernels' rounding."""
    params = tlm.random_params(SPEC, seed=3)
    for name in params:
        if name.endswith("_ffn1_bias"):
            params[name] = params[name] + np.float32(1.0)
    card = one_step(dev, params)
    cpu = one_step(torch.device("cpu"), params)
    worst, worst_name = 0.0, None
    for name, ref in cpu.items():
        got = card[name]
        if not np.isfinite(got).all():
            raise SystemExit("chip_smoke: %s is not finite on the card"
                             % name)
        rel = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
        if rel > worst:
            worst, worst_name = rel, name
        if not rel <= 1e-3:
            raise SystemExit("chip_smoke: %s differs between card and CPU: "
                             "%.3e x max|ref|" % (name, rel))
    log("phase 7 training step card vs CPU: probabilities and %d gradients "
        "agree; worst %s at %.3e x max|ref| (tol 1e-3)"
        % (len(cpu) - 1, worst_name, worst))


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


def timed_row(name, shape, fn, plain, library, nbytes, flops, err, card):
    """Time ``fn``, its plain version and the library call (None where
    there is no single-call yardstick) beside the bound: the larger of
    ``nbytes`` over the memory rate and ``flops`` over the fp32 rate."""
    mem_rate, flop_rate, rate_name = card_rates(torch.cuda.get_device_name(0))
    ms, plain_ms = time_ms(fn), time_ms(plain)
    lib_ms = None if library is None else time_ms(library)
    t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / flop_rate * 1e3
    row = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops, "max_abs_err": err}
    log("phase 5 %s %s: kernel %.4f ms, plain %.4f ms, library %s, "
        "bound %.4f ms (%s, %s rates) [%s]"
        % (name, shape, ms, plain_ms,
           "none" if lib_ms is None else "%.4f ms" % lib_ms,
           row["bound_ms"], row["bound_by"], rate_name, card))
    return row


def phase_times(dev, card, errs):
    """The serving kernels at the serving path's shapes."""
    F = torch.nn.functional
    entries = {}

    def record(name, *args):
        entries.setdefault(name, []).append(timed_row(name, *args, card))

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
    return entries


def autograd_backward(forward, inputs, cot):
    """A call that runs only the backward of ``forward(*inputs)`` for
    cotangent ``cot`` (the graph is kept between calls)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = forward(*leaves)
    return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)


def phase_times_train(dev, card, errs):
    """The training kernels at the training path's shapes.  Yardsticks:
    the autograd backward of ``F.rms_norm`` / ``F.layer_norm``,
    ``torch.softmax`` and ``F.scaled_dot_product_attention`` in fp32;
    ``xent_grad_from_probs`` has no single-call yardstick."""
    F = torch.nn.functional
    t = train_kernel_inputs(dev)
    W, V = SPEC["num_hidden"], SPEC["vocab_size"]
    n, nv = TRAIN_ROWS * W, TRAIN_ROWS * V
    B, H, L, D = TRAIN_ATT
    cases = train_kernel_cases(t)
    shape_n = "rows=%d width=%d" % (TRAIN_ROWS, W)
    shape_v = "rows=%d classes=%d" % (TRAIN_ROWS, V)
    entries = {}

    def record(name, case, shape, library, nbytes, flops):
        kern, plain, _ = cases[case]
        entries.setdefault(name, []).append(timed_row(
            name, shape, kern, plain, library, nbytes, flops, errs[name],
            card))

    # bytes: each input read once, each output written once
    record("rms_norm_bwd", "rms_norm_bwd", shape_n, autograd_backward(
        lambda x, g: F.rms_norm(x, (W,), g, 1e-6), (t["x"], t["g"]),
        t["dy"]), 4 * (3 * n + 2 * W), 12 * n)
    record("layer_norm_bwd", "layer_norm_bwd", shape_n, autograd_backward(
        lambda x, g, b: F.layer_norm(x, (W,), g, b, 1e-5),
        (t["x"], t["g"], t["b"]), t["dy"]), 4 * (3 * n + 3 * W), 16 * n)
    record("softmax_rows", "softmax_rows", shape_v,
           lambda: torch.softmax(t["logits"], -1), 4 * 2 * nv, 5 * nv)
    record("xent_grad_from_probs", "xent_grad_from_probs", shape_v, None,
           4 * (2 * nv + TRAIN_ROWS), 2 * nv)
    for causal in (True, False):
        pairs = B * H * (L * (L + 1) // 2 if causal else L * L)
        record("flash_attention",
               "flash_attention" if causal else "flash_attention non-causal",
               "B=%d H=%d L=%d D=%d causal=%s" % (B, H, L, D, causal),
               lambda c=causal: F.scaled_dot_product_attention(
                   t["q"], t["k"], t["v"], is_causal=c),
               4 * 4 * B * H * L * D, 4 * D * pairs)
    return entries


def kernel_rows(entries, counts, per_step=None):
    """The ``kernels`` JSON rows: the first shape of each kernel (the
    path's own) at the top level, every timed shape under ``shapes``."""
    out = []
    for name, rows in entries.items():
        head = rows[0]
        src, replaces = SOURCES[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": counts[name],
               "max_abs_err": max(r["max_abs_err"] for r in rows),
               "ms": head["ms"], "plain_ms": head["plain_ms"],
               "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
               "library_ms": head["library_ms"], "shape": head["shape"],
               "shapes": rows}
        if per_step is not None:
            row["launches_per_step"] = per_step[name]
        out.append(row)
    return out


def main(argv):
    if argv not in ([], ["--profile"]):
        print("usage: chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log("card: %s; torch %s, CUDA %s" % (card, torch.__version__,
                                         torch.version.cuda))
    # fp32 products on the card, as on the CPU and in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    errs = phase_compare(dev)
    errs.update(phase_compare_train(dev))
    params = tlm.random_params(SPEC, seed=0)
    reg, reqs, results, counts, tok_s = phase_serve(params)
    phase_card_vs_cpu(params, reg, reqs, results)
    train_counts, step_ms = phase_train(dev, card)
    if argv:
        profile_train(dev, card, step_ms)
    phase_train_vs_cpu(dev)
    kern = kernel_rows(phase_times(dev, card, errs), counts)
    for row in kern:
        row["train_launches"] = train_counts[row["name"]]
        row["train_launches_per_step"] = TRAIN_LAUNCHES_PER_STEP.get(
            row["name"], 0)
    kern += kernel_rows(phase_times_train(dev, card, errs), train_counts,
                        TRAIN_LAUNCHES_PER_STEP)
    log("phase 5 engine: %.1f generated tokens/s at full width [%s]"
        % (tok_s, card))
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
