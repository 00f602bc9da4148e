#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; builds the port's kernels from the
sources in this checkout on first use.  Phases, each fatal on failure:

1. build the CUDA kernels (``mxnet_tpu_torch/kernels/csrc/*.cu``);
2. run each kernel at the serving paths' shapes and hold it against its
   plain PyTorch version on the card (norms: rows 32, 1024 and 4096,
   width 512, tolerance 1e-5 x max|ref|; paged attention, fp32 and int8
   pools with a scale per (head, block): B=32, H=8, D=64, block 64,
   16-block tables, Lq 1 and 32, ragged positions, shared blocks and
   trash-block entries, tolerance 1e-4 absolute; the bf16 norms and
   bf16 paged attention at the same shapes, within one bf16 ulp of
   max|ref| (plus 1e-4 for attention); dequant_matmul: M 1, 16, 32,
   256, 512 and 1024 (both regimes: the decode GEMV and the prefill
   tensor-core tile) against every (N, K) of the LM's products, 1e-5 x
   max|ref|;
   flash_attention_offset: B=32, H=8, Lq 1 over a 1024-key cache with
   ragged offsets, 1e-4 absolute); paged attention's bodies at their
   edges, in each pool dtype: Lq on each side of the decode body's
   threshold, 32 and 33, blocks of 8 and 64 tokens, positions 0 and
   T * bs - Lq, with the same bounds; every body (decode, tile, v1 and,
   bf16 ``flash_attention``, wgmma) of both flash entry points in fp32
   and bf16 at phase 3c's shapes: the offset kernel at B32 Lk1024 and
   B16 Lk512, H8 Lq1 D64, ragged offsets, the causal kernel at B4 and
   B16 H8 L512 D64 (fp32 1e-4 absolute, bf16 one bf16 ulp of max|ref|
   plus 1e-4); the wgmma body at phase 3e's and 6b's shapes (B16 L256
   causal and not) and at its ragged edges
   (Lq 70, 33, 20, 130 and 7; Lk 100 and 300; D 16, 104 and 128), two
   launches bit-equal; the speculative verify's paged attention (B16
   H8 Lq5 D64) in each pool dtype on both bodies, with windows that
   cross a block boundary (positions bs - 2 and 3 * bs - 2);
3. serve the transformer LM at full width (4 layers, hidden 512, 8
   heads, vocab 8192, random weights from seed 0) through
   ``ModelRegistry`` + ``GenerationEngine`` with the default knobs: 16
   requests, four sharing a 128-token prefix, two sampled; every kernel
   of the path must have launched during the run; paged attention's
   launches counted by (kernel, B, Lq, body), each on the body
   ``_plan`` names;
3b. the same mix on int8 weights and an int8 paged KV pool
   (``compute_dtype="int8", kv_dtype="int8"``): ``dequant_matmul`` and
   the int8 paged kernel launch, the fp32 paged kernel does not; its
   launches by M and by (N, K); weight bytes and pool bytes per token
   against phase 3's store (the reference's gate: at most 0.3x);
3c. the same mix on the contiguous plane (``paged=False``, prompt
   buckets up to 512): ``flash_attention`` (prefill) and
   ``flash_attention_offset`` (decode) launch, the former counted by
   (B*H, Lq, Lk, D, causal); the greedy streams equal phase 3's but
   where the CPU's top-2 logit margin is below 1e-3;
4. the card against the CPU: one prefill chunk and one decode step of
   ``paged_step_apply`` (logits within 1e-3), then the greedy streams of
   phase 3 against a CPU engine (a stream may differ only where the CPU's
   top-2 logit margin is below 1e-3);
3d. the same mix on bf16 weights and a bf16 paged KV pool
   (``compute_dtype="bfloat16", kv_dtype="bfloat16"``): the bf16 norms
   and the bf16 paged kernel launch, their fp32 forms do not; weight
   bytes and pool bytes per token exactly half of phase 3's store;
3e. phase 3c's mix in bf16 (``compute_dtype="bfloat16",
   kv_dtype="bfloat16"`` on the contiguous plane): the bf16 norms,
   ``flash_attention_bf16`` and ``flash_attention_offset_bf16`` launch,
   their fp32 forms do not; weight bytes and cache bytes per slot
   exactly half of phase 3c's store; both flash entry points' launches
   in phases 3c and 3e counted by (name, B, H, Lq, Lk, D, causal, body),
   each on the body ``_plan`` names, every bf16 ``flash_attention``
   launch above the decode threshold on wgmma (the same census runs
   over phases 6, 6b, 8 and 8b);
3f. phase 3's mix, speculative (``add_draft_model``, ``spec_k`` 4) with
   the target's own weights as the draft: target decode steps per
   generated token at most 0.6x phase 3's, the acceptance printed, the
   greedy streams equal phase 3's but where the CPU's top-2 margin is
   below 1e-3 (the CPU's top-2 logits printed at the first differing
   position), every verify launch (Lq 5) on the body ``_plan`` names and
   every Lq 1 launch on the decode body; then the same on phase 3b's
   int8 store with an int8 self-draft (the verify on the int8 kernel,
   ``draft_pool_bytes`` printed, its streams against phase 3b's reported
   only: its blocks are requantized once a window);
3g. phase 3's mix with a friendly draft (the target's weights plus 3%
   relative noise) and an adversarial one (an independent random LM of
   2 layers, hidden 256, 4 heads): the acceptance, the greedy streams as
   3f, tokens/s and inter-token latency beside phase 3's, and the
   adversarial draft's fallback engaged (``spec_fallback_steps`` > 0);
4b. the same for phase 3b's int8 store;
4c. the same for phase 3d's bf16 store, with the bounds of bf16: logits
   within 2e-2 x max|ref|, and a stream may differ only where the CPU's
   top-2 margin is below 2e-2 x |top logit|;
4d. the same for phase 3e's contiguous bf16 store, under 4c's bounds,
   with ``prefill_apply`` and one ``decode_apply`` step in place of the
   paged steps;
5. time each kernel, its plain version and one PyTorch library call with
   CUDA events (median of 60 launches queued behind a GPU spin, so each
   event pair brackets device time), beside the kernel's bound (bf16
   kernels: bf16 bytes, and the bf16 tensor-core rate for operations;
   dequant_matmul, flash_attention and fp32 or int8 paged attention:
   the TF32 tensor-core rate, the card's peak for fp32 inputs, and
   beside it the fp32 CUDA-core bound of earlier runs), and phase 3b's
   ms per step beside phase 3's; paged attention at each (B, Lq) of the
   serving phases' launches and at B=32 with Lq 1, 32 and each side of
   the decode threshold, and at the speculative verify's B16 Lq5, with
   v1 (the CUDA-core body of earlier slices) and the other new body
   (decode or tile) timed beside each row (the faster body at Lq5
   printed beside ``DECODE_MAX_LQ``);
   ``flash_attention_offset`` in fp32 and bf16 at B32 Lk1024 and at each
   (B, Lk) of phases 3c's and 3e's launches, and at Lq 2 and each
   side of its decode threshold, with v1 and the other body beside each
   row (library: SDPA with the offset mask, in the input dtype);
2+. the training path's kernels against their plain versions at training
   width: the norm backwards at 4096 x 512 and at each edge of their two
   paths (the register cap, width 1024, and 1028; width 1000; width 1002,
   not a multiple of 4; 4097 rows; rows 4 bytes off 16-byte alignment;
   dx and the weight gradients within 1e-5 x max|ref|), the loss head's
   softmax and gradient, the cross-entropy loss and gradient (labels
   random, at column 0, at the last column and out of range) and the
   fused softmax's forward and backward at 4096 x 8192 (1e-5 x max|ref|),
   flash attention at B16 H8 L256 D64, causal and not (1e-4 absolute);
   the bf16 training kernels within one bf16 ulp of max|ref|: both norm
   backwards at widths 8, 512 and 1024 and at 1, 33, 4096 and 4097 rows
   (v3), at widths 4 and 516 and rows 8 bytes off 16-byte alignment
   (v2), and at widths 513 and 1028 and rows 2 bytes off (v1), dx,
   dgamma and dbeta; the head's bf16 softmax and gradient at 2, 8192 and 8193
   classes, float32 labels random, at the last column and outside; the
   bf16 cross-entropy loss and gradient at 4096 x 8192 (the registers
   body), 64 x 8193 and 4096 x 2 (scalar and narrow) and rows 2 bytes
   off 16-byte alignment, float32 labels random, at 0, at the last
   column and outside (-1 and the class count): the loss within 1e-5 x
   max|ref|, the gradient within one bf16 ulp of max|ref|; float-to-
   integer ``Cast``, ``cast`` and ``astype`` on the card, fp32 and bf16
   to uint8, int8 and int32, saturating (equal to the CPU's casts and
   to the reference's values on NaN, infinities and out-of-range
   inputs);
6. train the transformer LM at full width (4 layers, hidden 512, 8 heads,
   vocab 8192, seq_len 256, batch 16) through ``Module.fit`` for 20 SGD
   steps (momentum 0.9, learning rate 0.005) on a successor language:
   exact kernel launches per step, finite loss, falling perplexity, ms
   per step and samples/s;
6b. phase 6 under ``Module(compute_dtype='bfloat16')``: fp32 master
   weights, bf16 forward and backward; exact bf16 kernel launches per
   step, none of the fp32 ones, and no wrapper's plain version reached;
   every bf16 norm backward launch on v3 (``nb_census``: each launch
   counted by (name, rows, width, path) and held to ``_bwd_plan``; the
   same census runs over phases 6, 8 and 8b); perplexity falling;
   outputs bf16, and the parameters, gradients, momenta and
   ``get_params`` float32 after the fit; ms per step,
   samples/s and tokens/s beside phase 6's;
7. one training step from identical parameters on the card and on the
   CPU (TF32 off): probabilities and every gradient within 1e-3 x
   max|ref|;
7b. phase 7 in bf16: probabilities within 2e-2 x max|ref| and every
   gradient within 5e-2 x its max|ref| (``BF16_STEP_TOL``), or within
   the CPU's own bf16-vs-fp32 distance where that is larger, each
   array's ratio to its bound printed;
8. train the same LM imperatively (``mx.nd`` ops under
   ``mx.autograd.record()``, ``mx.nd.softmax_cross_entropy``,
   ``loss.backward()``, ``mx.nd.sgd_mom_update(..., out=w)``) from phase
   6's Xavier start on phase 6's data for 20 steps: exact kernel
   launches per step (the cross-entropy kernels, not SoftmaxOutput's),
   a finite falling loss, ms per step and samples/s beside phase 6's;
8b. phase 8 in bf16 (``imperative_loss(..., compute_dtype='bfloat16')``:
   every weight through ``mx.nd.Cast`` inside ``record()``, the loss
   ``softmax_cross_entropy`` on bf16 logits): exact bf16 kernel launches
   per step (the bf16 cross-entropy pair), none of the fp32 ones, no
   wrapper's plain version reached, a finite falling loss, the weights,
   gradients and momenta float32 after the run; ms per step and
   samples/s beside phases 8 and 6b;
9. one imperative step from identical parameters on the card against
   the CPU (TF32 off), and against phase 7's ``Module`` step on the
   card: every gradient within 1e-3 x max|ref|;
9b. phase 9 in bf16: the card's imperative bf16 step against the CPU's,
   and against phase 7b's ``Module`` bf16 step on the card, under
   phase 7b's bounds (the loss 2e-2, each gradient 5e-2 x its max|ref|,
   or bf16's own distance from phase 9's fp32 step where that is
   larger), each array's ratio to its bound printed;
5+. the training kernels' times at their training shapes (the norm
   backwards also with L2 cold, ``ms_cold``: a 256 MB buffer written
   before each launch, outside the events, and their v1 path beside them,
   ``v1_ms``, on the same inputs 4 bytes off alignment;
   flash_attention also at each shape of phase 3c's prefill launches,
   and in bf16 at each of phase 3e's, with the v1 body beside each row;
   bf16 rows also with the bf16 mma.sync tile (``tile_ms``) and the
   wrapper's host microseconds a call on wgmma and on the tile),
   phase 6b's bf16 kernels at its shapes (the norm backwards at 4096 x
   512 on v3, L2 warm and cold, with the v2 body (``v2_ms``), the v1
   path, the fp32 row of the same call (``fp32_ms``) and the call on 8
   rows (``floor_ms``) beside, the head's two bodies at 4096 x 8192,
   ``flash_attention_bf16`` at B16 H8 L256 D64 causal; library calls in
   bf16), then the imperative plane's: the cross-entropy loss and
   gradient, the fused softmax's backward, phase 8b's bf16 loss and
   gradient at 4096 x 8192 (yardstick bf16 ``F.cross_entropy`` and its
   backward; the fp32 rows of this call beside them) and an ``rtc``
   kernel (``fma1``, checked in phase 2+ against ``torch.addcmul``
   within 2 ulp).

10. the op library (the op-library slice's 136 op names) on the card
   against the CPU, on the same inputs from seed 10 at realistic sizes
   (the elementwise ops on 4096 x 512, ``dot`` of 1024 x 1024 by 1024 x
   1024, ``batch_dot`` of 16 x 256 x 64 by 16 x 64 x 256, ``topk`` and
   the sorts over 8192 columns), with the edge inputs: indices past
   either end, negative and fractional for ``take``, ``pick``,
   ``batch_take`` and ``one_hot``, rows full of ties for ``sort``,
   ``argsort`` and ``topk``, integer ``_power`` with negative exponents,
   ``gamma`` of negative non-integers; synchronised after each op, so a
   device-side assert names its op; integer, bool, index and ordering
   results and IEEE-exact arithmetic bit-equal, the rest within the CPU
   tests' bounds (1e-5 x max|ref|, bf16 2^-8 x max|ref|); the worst
   ratio to its bound for each family;
   then the image-classification slice's 32 names: every layer op
   (``Convolution``/``_v1`` 1-, 2- and 3-D with groups and dilation,
   ``Deconvolution`` with ``adj`` below and past the stride,
   ``Pooling``/``_v1`` max, avg and sum, ``full``, global, explicit
   padding, 1-D and 3-D, ``BatchNorm`` in training, inference,
   ``use_global_stats`` and ``output_mean_var`` with its moving
   statistics, ``LeakyReLU``'s four types, ``LRN``, ``InstanceNorm``,
   ``L2Normalization``, ``UpSampling``, ``Dropout`` outside training)
   card against CPU at ResNet-50's sizes, max-pools, slopes and
   upsampling bit-equal, the rest within 1e-5 x max|ref|; Dropout's
   rate and ``1/(1-p)`` scale and rrelu's slopes in training on the
   card; every one of the 20 sampler names' mean and variance over
   10**6 draws on the card within six standard errors of the
   distribution's, the draws reproduced by a seed;
11. the matrix-factorization recommender of
   ``examples/recommenders/matrix_fact.py`` (two ``Embedding``s, ``*``,
   ``sum(axis=1)``, ``LinearRegressionOutput``; factor 16, batch 256,
   Adam at learning rate 0.01 and wd 1e-5, ``Normal(0.1)``, ``rmse``) at
   MovieLens-1M's id space (6,040 users, 3,952 items, 1,000,209
   synthetic rank-8 ratings from seed 11, split 90/10) through
   ``Module.fit`` for ``MF_EPOCHS`` epochs, its parameters, executor
   arrays, optimizer state and iterator batches on the card: held-out
   RMSE after each epoch, falling each epoch and ending below the rating
   std (three epochs reach about 0.6 x it; the example's bar of 0.5 x
   needs more); steps/s, samples/s and ms per step; no hand kernel
   launched (none lies on this path) and no plain version reached;
12. one recommender step on the card against the CPU's from the same
   parameters and batch: each gradient within 1e-5 x max|ref|, each
   parameter after Adam within 1e-4 x max|ref|;
13. ResNet-50 (``mx.models.resnet(num_classes=1000, num_layers=50)``,
   pre-activation, 3 x 224 x 224, batch 32, fp32, TF32 off) through
   ``Module.fit`` for 30 steps on ``SyntheticDataIter``'s one fixed
   batch on the card, with
   ``examples/image-classification/common/fit.py``'s settings (SGD lr
   0.1, momentum 0.9, wd 1e-4, ``MultiFactorScheduler`` at ImageNet's
   epochs 30 and 60, gaussian Xavier, accuracy, ``Speedometer``): every
   argument, gradient, moving statistic and momentum on the card; the
   loss head's kernel pair (``softmax_rows``, ``xent_grad_from_probs``)
   launched once a step and no other kernel, no plain version reached;
   the cross-entropy on the batch finite and its mean over the last
   five steps below the first step's; all 102 moving statistics finite
   and moved; ms per step and images/s;
14. one ResNet-50 step at batch 4 on the card from the initializer's
   parameters, against the CPU's step in float64, both CPU steps
   replaying the card's decisions at every ReLU and max pool (an input
   within rounding of the kink goes one way on the card and may go the
   other on the CPU, passing or stopping one of as few as 196 summed
   terms): probabilities, updated parameters and moving statistics
   within 1e-4 x max|ref|, every gradient within 1e-3 x its max|ref|,
   or, where larger, within 4 x the CPU's own float32 distance from
   float64 (a sum that cancels, such as ``bn0_gamma``'s gradient); each
   kind's worst ratio, and the count of decisions the CPU steps would
   have taken otherwise;
13b. phase 13 under ``Module(compute_dtype='bfloat16')``, as bench.py's
   ``train.resnet-50.module_fit`` row runs it: the head's bf16 pair
   (``softmax_rows_bf16``, ``xent_grad_from_probs_bf16``) once a step
   and no other kernel, no plain version reached; outputs bf16, every
   parameter, gradient, momentum and moving statistic float32 on the
   card; the moving statistics finite and moved, the cross-entropy
   falling; ms per step, images/s and the ratio to phase 13;
14b. phase 14 in bf16: the card's bf16 step against the CPU's float64
   step, both CPU steps (bf16 and float64) replaying the card's
   decisions; outputs within 2e-2, gradients 5e-2, parameters and
   moving statistics 1e-2 x max|ref|, or within 4 x the CPU's own
   bf16-vs-float64 distance where that is larger (16 x for an array of
   fewer than 64 elements, whose maximum is a poor estimate of bf16's
   noise); how far the card's distance is from the CPU's, by
   percentile;
15. scoring, ``examples/image-classification/benchmark_score.py``'s
   protocol for alexnet, vgg-16, inception-bn, inception-v3 (3 x 299 x
   299), resnet-50 and resnet-152: ``Module(label_names=None)`` (its
   Xavier-initialised ``softmax_label`` parameter ignored by the head),
   ``bind(for_training=False)``, ``Xavier(magnitude=2.0)``, fp32 with
   TF32 off, batch 32, two warm-up and ten timed batches; the head's
   forward kernel once a batch and nothing else; images/s; each network
   reshaped to batch 2 against the CPU's forward from the same
   parameters within 1e-4 x max|ref|;
16. the zoo trains: each of those six and googlenet, resnext-50 and
   inception-resnet-v2 takes two bf16 ``Module.fit`` steps at batch 8:
   the loss finite, every parameter and moving statistic moved, the bf16
   head pair once a step, float32 master arrays;
17. resume and predict: bf16 ResNet-50 at batch 32, two steps,
   ``module_checkpoint(..., save_optimizer_states=True)``,
   ``Module.load(..., load_optimizer_states=True)`` and a third step (at
   a learning rate the restored update count decays), against the same
   three steps uninterrupted, taken twice for the card's own
   run-to-run distance: outputs, parameters, moving statistics and
   momenta within 2 x that distance of their kind; the ``.states`` file
   unpickled with pickle and numpy alone; ``predict`` equal to
   ``iter_predict``'s batches with the padding stripped, and its
   accuracy equal to ``score``'s.

18. the LSTM language model as bench.py's ``train.lstm-bucketing`` row
   runs it (``models/lstm_lm.py``: 3 LSTM layers, hidden and embed 200,
   vocab 10000) through ``BucketingModule.fit`` at batch 32 on one
   bucket of 32 for 20 steps: ``BucketSentenceIter(invalid_label=0)``,
   SGD at learning rate 0.01, momentum 0, wd 1e-5,
   ``Xavier(factor_type='in', magnitude=2.34)``,
   ``Perplexity(ignore_label=0)``, ``kvstore='device'``, on Zipfian
   sentences from seed 18 (bench.py's uniform tokens leave nothing to
   learn): every array on the card; the head's kernel pair once a step
   and no other kernel, no plain version reached; the perplexity finite
   and falling; ms per step and samples/s (``synchronize()`` at both
   ends of the window), and under ``torch.profiler`` for the last three
   steps the device time, kernels and copies a step and the busy share;
18b. ``examples/rnn/lstm_bucketing.py`` at the same width: a copy of
   its ``synthetic_corpus`` (2000 sentences from seed 7, 200 held out
   from seed 8), buckets 10, 20, 30 and 40, one epoch with the held-out
   set scored at its end: the four bucket modules hold the same
   parameter and gradient tensors (equal ``data_ptr()``) and one
   updater, every parameter moved, the head's kernels once a step and
   its forward once a scored batch, the objective's perplexity (every
   label, the padding too) falling; the example's metric and the
   held-out score printed;
19. the LSTM LM's step at batch 4 on the card against the port's CPU
   (fp32, TF32 off): one ``forward_backward`` and ``update`` (momentum
   0.9) of buckets 10 and 20 from one Xavier start, every output,
   gradient and parameter within 1e-4 x max|ref|; the ``RNN`` op at full
   width (LSTM, 3 layers of 200, seq 32, batch 32), cuDNN against its
   plain version (the per-step loop) on the card, the outputs, last
   states and every gradient within 1e-4 x max|ref|, each forward
   timed; ``Module(state_names=...)`` with ``set_states`` /
   ``get_states`` and a ``Monitor`` on the card: the rows' names equal
   the CPU run's, each statistic and the outputs within 1e-4.

Phase 5 also times row 10's kernel pair at phase 13's head, 32 x
1000, and at phase 18's, 1024 x 10000, and row 10b's bf16 pair at
phase 13b's (the registers body, one 16-byte load a lane, confirmed
from the pointers).  Phase 5 also
gives the norm forwards' rows (fp32 and bf16 ``rms_norm``
and ``layer_norm``) ``floor_ms``: the same call on one row, the floor
of one launch.

``python3 chip_smoke.py --profile`` adds, after phases 6 and 6b, a
``torch.profiler`` window over five training steps of each, and after
phase 11 one over 100 recommender steps, and after phases 13 and 13b
one over five ResNet-50 steps each: device time and launches per
step, the device's busy share, and the ops with the most device time.

The last lines are a JSON object of per-kernel numbers, the card's name
and power limit as nvidia-smi reports them, and the result object.
Exits non-zero, printing no result, without a CUDA device.
"""
import collections
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import (_build, dequant_matmul, flash_attention,
                                     norm, paged_attention, softmax_xent)
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.models.lstm_lm import sym_gen_factory
from mxnet_tpu_torch.ops import nn as layer_ops
from mxnet_tpu_torch.ops import rnn_op
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.serving import GenerationEngine, ModelRegistry, TokenStream

SPEC = tlm.lm_spec(num_layers=4, num_hidden=512, num_heads=8,
                   vocab_size=8192)
TRAIN_BATCH, TRAIN_SEQ = 16, 256
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
TRAIN_ATT = (TRAIN_BATCH, SPEC["num_heads"], TRAIN_SEQ,
             SPEC["num_hidden"] // SPEC["num_heads"])
# serving rows (decode bucket, prefill chunk) and the training width
NORM_ROWS, NORM_W = (32, 1024, 4096), 512
# the norm backwards' path edges (rows, width, 4-byte offset): the v2
# register cap and one float4 past it, a ragged last float4 chunk, a
# width not a multiple of 4, one row past 4096, unaligned rows
NORM_BWD_EDGES = ((64, 1024, 0), (64, 1028, 0), (33, 1000, 0),
                  (9, 1002, 0), (4097, 512, 0), (300, 512, 1))
# bytes written before each cold-L2 launch: five times the H100's 50 MB L2
COLD_L2_BYTES = 256 << 20
PA = dict(B=32, H=8, D=64, bs=64, T=16)
PA_LQ = (1, 32)
# the paged kernel's pool dtypes by launch name; phase 5 times Lq 1, 32
# and each side of the decode body's threshold (kernels/paged_attention.py
# DECODE_MAX_LQ), beside v1 and the other body
PA_DTYPES = {"flash_attention_paged": torch.float32,
             "flash_attention_paged_bf16": torch.bfloat16,
             "flash_attention_paged_int8": torch.int8}
PA_TIMED_LQ = {name: sorted({1, 32, paged_attention.DECODE_MAX_LQ[dt],
                             paged_attention.DECODE_MAX_LQ[dt] + 1})
               for name, dt in PA_DTYPES.items()}
# dequant_matmul: M is a decode bucket (1, 16 and 32: the GEMV regime)
# or a prefill chunk of 8, 16 or 32 sequences x 32 tokens (256, 512 and
# 1024: the tensor-core tile; phase 3b runs 16 and 512); (N, K) of
# q/k/v/proj, ffn1, ffn2 and pred at full width
DQ_M = (1, 16, 32, 256, 512, 1024)
DQ_NK = ((512, 512), (2048, 512), (512, 2048), (8192, 512))
# flash_attention_offset at decode: one query row over a full cache
OFS = dict(B=32, H=8, Lk=1024, D=64)
# flash attention's launch names -> (dtype, offset entry point); phase 5
# times the offset kernel at Lq 2 and each side of its decode
# threshold (kernels/flash_attention.py DECODE_MAX_LQ) beside Lq 1
FA_NAMES = {"flash_attention": (torch.float32, False),
            "flash_attention_bf16": (torch.bfloat16, False),
            "flash_attention_offset": (torch.float32, True),
            "flash_attention_offset_bf16": (torch.bfloat16, True)}
# phase 2's wgmma cases (B, H, Lq, Lk, D, causal): phase 3e's prefills,
# phase 6b's step causal and not, and the ragged edges (rows past Lq in a
# CTA, keys past a 64-key tile, D padded 16 -> 64 and 104 -> 128, one
# row past the decode threshold)
WGMMA_EDGES = ((4, 8, 512, 512, 64, True), (16, 8, 512, 512, 64, True),
               (16, 8, 256, 256, 64, True), (16, 8, 256, 256, 64, False),
               (2, 2, 70, 70, 16, True), (2, 2, 33, 100, 64, False),
               (2, 2, 20, 20, 128, True), (3, 2, 130, 300, 104, False),
               (2, 2, 7, 7, 64, True))
OFS_TIMED_LQ = {dt: sorted({1, 2, flash_attention.DECODE_MAX_LQ[dt],
                            flash_attention.DECODE_MAX_LQ[dt] + 1})
                for dt in (torch.float32, torch.bfloat16)}
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
    "dequant_matmul": ("mxnet_tpu_torch/kernels/csrc/dequant_matmul.cu",
                       "mxnet_tpu/pallas_ops/dequant_matmul.py:141"),
    "flash_attention_paged_int8": (
        "mxnet_tpu_torch/kernels/csrc/paged_attention.cu",
        "mxnet_tpu/pallas_ops/paged_attention.py:41"),
    "flash_attention_offset": (
        "mxnet_tpu_torch/kernels/csrc/flash_attention.cu",
        "mxnet_tpu/pallas_ops/flash_attention.py:222"),
    "softmax_xent_loss": ("mxnet_tpu_torch/kernels/csrc/softmax_xent.cu",
                          "mxnet_tpu/pallas_ops/softmax_xent.py:91"),
    "softmax_xent_loss_grad": (
        "mxnet_tpu_torch/kernels/csrc/softmax_xent.cu",
        "mxnet_tpu/pallas_ops/softmax_xent.py:102"),
    "softmax_rows_bwd": ("mxnet_tpu_torch/kernels/csrc/softmax_xent.cu",
                         "mxnet_tpu/pallas_ops/softmax_xent.py:74"),
    "rtc": ("mxnet_tpu_torch/rtc.py", "mxnet_tpu/rtc.py:74"),
    "rms_norm_bf16": ("mxnet_tpu_torch/kernels/csrc/norm.cu",
                      "mxnet_tpu/pallas_ops/norm.py:47"),
    "layer_norm_bf16": ("mxnet_tpu_torch/kernels/csrc/norm.cu",
                        "mxnet_tpu/pallas_ops/norm.py:110"),
    "flash_attention_paged_bf16": (
        "mxnet_tpu_torch/kernels/csrc/paged_attention.cu",
        "mxnet_tpu/pallas_ops/paged_attention.py:41"),
    "flash_attention_bf16": ("mxnet_tpu_torch/kernels/csrc/flash_attention.cu",
                             "mxnet_tpu/pallas_ops/flash_attention.py:62"),
    "flash_attention_offset_bf16": (
        "mxnet_tpu_torch/kernels/csrc/flash_attention.cu",
        "mxnet_tpu/pallas_ops/flash_attention.py:222"),
    "rms_norm_bwd_bf16": ("mxnet_tpu_torch/kernels/csrc/norm.cu",
                          "mxnet_tpu/pallas_ops/norm.py:54"),
    "layer_norm_bwd_bf16": ("mxnet_tpu_torch/kernels/csrc/norm.cu",
                            "mxnet_tpu/pallas_ops/norm.py:120"),
    "softmax_rows_bf16": ("mxnet_tpu_torch/kernels/csrc/softmax_xent.cu",
                          "mxnet_tpu/pallas_ops/softmax_xent.py:67"),
    "xent_grad_from_probs_bf16": (
        "mxnet_tpu_torch/kernels/csrc/softmax_xent.cu",
        "mxnet_tpu/pallas_ops/softmax_xent.py:82"),
    "softmax_xent_loss_bf16": ("mxnet_tpu_torch/kernels/csrc/softmax_xent.cu",
                               "mxnet_tpu/pallas_ops/softmax_xent.py:91"),
    "softmax_xent_loss_grad_bf16": (
        "mxnet_tpu_torch/kernels/csrc/softmax_xent.cu",
        "mxnet_tpu/pallas_ops/softmax_xent.py:102"),
}
# serving phase -> (store arguments, kernels that must launch, kernels
# that must not)
SERVE_PHASES = {
    "3": ({}, ("rms_norm", "layer_norm", "flash_attention_paged"), ()),
    "3b": (dict(compute_dtype="int8", kv_dtype="int8"),
           ("rms_norm", "layer_norm", "dequant_matmul",
            "flash_attention_paged_int8"), ("flash_attention_paged",)),
    "3c": (dict(paged=False, prompt_buckets=(16, 32, 64, 128, 256, 512)),
           ("rms_norm", "layer_norm", "flash_attention",
            "flash_attention_offset"),
           ("flash_attention_paged", "flash_attention_paged_int8",
            "flash_attention_bf16", "flash_attention_offset_bf16")),
    "3d": (dict(compute_dtype="bfloat16", kv_dtype="bfloat16"),
           ("rms_norm_bf16", "layer_norm_bf16", "flash_attention_paged_bf16"),
           ("rms_norm", "layer_norm", "flash_attention_paged")),
    "3e": (dict(paged=False, prompt_buckets=(16, 32, 64, 128, 256, 512),
                compute_dtype="bfloat16", kv_dtype="bfloat16"),
           ("rms_norm_bf16", "layer_norm_bf16", "flash_attention_bf16",
            "flash_attention_offset_bf16"),
           ("rms_norm", "layer_norm", "flash_attention",
            "flash_attention_offset", "flash_attention_paged",
            "flash_attention_paged_bf16")),
}
# speculative decoding (phases 3f, 3g): the window, and the phases' store
# arguments (phase 3's, phase 3b's) with the self-draft; phase 3g's two
# other drafts ride phase 3's store.  Kernels as in SERVE_PHASES.
SPEC_K = 4
SERVE_PHASES.update({
    "3f": SERVE_PHASES["3"],
    "3f8": SERVE_PHASES["3b"],
    "3g": SERVE_PHASES["3"],
    "3ga": SERVE_PHASES["3"],
})
# the adversarial draft of phase 3g: an independent random LM
ADV_SPEC = tlm.lm_spec(num_layers=2, num_hidden=256, num_heads=4,
                       vocab_size=8192)
# the verify step's paged attention shape (phase 5; phase 2 with windows
# that cross a block boundary)
VERIFY_B, VERIFY_LQ = 16, SPEC_K + 1
MARGIN = 1e-3   # a card stream may leave the CPU's only at a near tie
# card vs CPU (phase 4*): serving phase, and the logits' bound and the
# near-tie margin, absolute (fp32 and int8 stores) or relative to the
# largest |logit| (bf16: a few bf16 ulps of the logits)
CARD_VS_CPU = {"4": ("3", "abs", 1e-3), "4b": ("3b", "abs", 1e-3),
               "4c": ("3d", "rel", 2e-2), "4d": ("3e", "rel", 2e-2)}
# kernel launches of one training step of the 4-layer LM: two RMSNorms
# and one attention per block, the final LayerNorm, the loss head
TRAIN_LAUNCHES_PER_STEP = {
    "rms_norm": 8, "rms_norm_bwd": 8, "layer_norm": 1, "layer_norm_bwd": 1,
    "softmax_rows": 1, "xent_grad_from_probs": 1, "flash_attention": 4}
# the same step under Module(compute_dtype='bfloat16'): every kernel
# under its bf16 name, none of the fp32 ones
TRAIN_BF16_LAUNCHES_PER_STEP = {
    "rms_norm_bf16": 8, "rms_norm_bwd_bf16": 8, "layer_norm_bf16": 1,
    "layer_norm_bwd_bf16": 1, "softmax_rows_bf16": 1,
    "xent_grad_from_probs_bf16": 1, "flash_attention_bf16": 4}
# phase 7b's and 9b's tolerances, of each array's max|ref| (one bf16
# step): the repo's bf16 logits bound for the probabilities and the
# loss, 5e-2 for each gradient; an array that bf16 itself moves further
# from fp32 is held to that distance instead (hold_bf16)
BF16_STEP_TOL = {"probabilities": 2e-2, "loss": 2e-2, "gradient": 5e-2}
# phase 2's bf16 norm backward edges (rows, width, element offset): v3
# at widths 8, 512 and 1024 and at 1, 33, 4096 and 4097 rows; v2 at
# widths 4 and 516 and 8 bytes off 16-byte alignment; v1 at widths 513
# and 1028 and rows 2 bytes off
NORM_BWD_BF16_EDGES = ((64, 4, 0), (4096, 512, 0), (64, 1024, 0),
                       (33, 513, 0), (64, 1028, 0), (300, 512, 4),
                       (300, 512, 1), (64, 8, 0), (64, 516, 0),
                       (1, 512, 0), (33, 512, 0), (4097, 512, 0))
# phase 2's bf16 head: (rows, classes) at 2, 8192 and 8193 classes
HEAD_BF16_CASES = ((4096, 2), (TRAIN_ROWS, 8192), (64, 8193))
# phase 2's bf16 cross-entropy loss and gradient (rows, classes, element
# offset): the registers body at 8192, the scalar loops at 8193, narrow
# rows, and rows 2 bytes off 16-byte alignment
XENT_BF16_CASES = ((TRAIN_ROWS, 8192, 0), (64, 8193, 0), (4096, 2, 0),
                   (300, 8192, 1))
TRAIN_STEPS, TRAIN_WARMUP = 20, 5
# phase 10: every op the op-library slice added, each run by the sweep
SWEEP_OPS = (
    "Concat", "ElementWiseSum", "Flatten", "IdentityAttachKLSparseReg",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "Pad", "SVMOutput", "SequenceLast",
    "SequenceMask", "SequenceReverse", "SliceChannel", "SwapAxis",
    "_arange", "_copy", "_div", "_div_scalar", "_equal", "_equal_scalar",
    "_grad_add", "_greater", "_greater_equal", "_greater_equal_scalar",
    "_greater_scalar", "_hypot", "_hypot_scalar", "_lesser",
    "_lesser_equal", "_lesser_equal_scalar", "_lesser_scalar", "_maximum",
    "_maximum_scalar", "_minimum", "_minimum_scalar", "_minus",
    "_minus_scalar", "_mod", "_mod_scalar", "_mul", "_mul_scalar",
    "_not_equal", "_not_equal_scalar", "_ones", "_power", "_power_scalar",
    "_rdiv_scalar", "_rminus_scalar", "_rmod_scalar", "_rpower_scalar",
    "_sub", "_sum", "_zeros", "add_n", "arccos", "arccosh", "arcsin",
    "arcsinh", "arctan", "arctanh", "argmax_channel", "argsort",
    "batch_dot", "batch_take", "broadcast_add", "broadcast_axes",
    "broadcast_axis", "broadcast_div", "broadcast_equal",
    "broadcast_greater", "broadcast_greater_equal", "broadcast_hypot",
    "broadcast_lesser", "broadcast_lesser_equal", "broadcast_maximum",
    "broadcast_minimum", "broadcast_minus", "broadcast_mod",
    "broadcast_mul", "broadcast_not_equal", "broadcast_plus",
    "broadcast_power", "broadcast_sub", "broadcast_to", "cbrt", "ceil",
    "clip", "concat", "cosh", "crop", "degrees", "dot", "elemwise_div",
    "elemwise_mul", "elemwise_sub", "erf", "expand_dims", "expm1", "fix",
    "flatten", "flip", "floor", "gamma", "gammaln", "identity", "log10",
    "log1p", "log2", "norm", "one_hot", "ones_like", "pad", "pick",
    "radians", "rcbrt", "repeat", "reverse", "rint", "round", "rsqrt",
    "sign", "sinh", "slice", "slice_axis", "smooth_l1", "softsign",
    "sort", "split", "swapaxes", "take", "tan", "tile", "topk", "trunc",
    "where", "zeros_like")
# phases 11-12: examples/recommenders/matrix_fact.py's model and defaults
# at MovieLens-1M's id space (6,040 users, movie ids up to 3,952,
# 1,000,209 ratings; synthetic, rank 8, from a seed)
MF = dict(users=6040, items=3952, ratings=1000209, rank=8, factor=16,
          batch=256, lr=0.01, wd=1e-5, sigma=0.1)
MF_EPOCHS = 3
# bench.py's SGD with momentum 0.9, at a tenth of its learning rate: its
# 0.05 was set for random tokens, whose loss nobody reads; on the
# successor language at this width it diverges by the fourth step.
# SoftmaxOutput's gradient sums the 256 tokens of each sample, so a rate
# of 0.005 is 1.28 on the mean over tokens.
TRAIN_OPT = {"learning_rate": 0.005, "momentum": 0.9}
# one imperative step: the Module step's kernels with the cross-entropy
# pair in place of SoftmaxOutput's
IMPERATIVE_LAUNCHES_PER_STEP = {
    "rms_norm": 8, "rms_norm_bwd": 8, "layer_norm": 1, "layer_norm_bwd": 1,
    "softmax_xent_loss": 1, "softmax_xent_loss_grad": 1,
    "flash_attention": 4}
# the same step in bf16 (imperative_loss(..., compute_dtype='bfloat16'):
# every weight through mx.nd.Cast): the bf16 names, none of the fp32 ones
IMPERATIVE_BF16_LAUNCHES_PER_STEP = {
    "rms_norm_bf16": 8, "rms_norm_bwd_bf16": 8, "layer_norm_bf16": 1,
    "layer_norm_bwd_bf16": 1, "flash_attention_bf16": 4,
    "softmax_xent_loss_bf16": 1, "softmax_xent_loss_grad_bf16": 1}
# the rtc kernel of phases 2+ and 5+: o = x * y + 1, which nvcc contracts
# to one fma (torch.addcmul's rounding)
RTC_FMA1 = r'''
extern "C" __global__ void fma1(const float* x, const float* y, float* o,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * y[i] + 1.0f;
}
'''


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bf16_ulp(x):
    """One bf16 ulp at magnitude ``x``: ``2**(floor(log2 x) - 7)`` (8
    significant bits), between 2**-8 and 2**-7 of ``x``."""
    return float(2.0 ** (np.floor(np.log2(max(float(x), 1e-30))) - 7))


def bf16_rate(name):
    """The card's dense bf16 tensor-core rate (NVIDIA's data sheets):
    H100 SXM 989 TFLOP/s, PCIe 756 TFLOP/s."""
    return 756e12 if "PCIe" in name else 989e12


def tf32_rate(name):
    """The card's dense TF32 tensor-core rate (NVIDIA's data sheets):
    H100 SXM 494.7 TFLOP/s, PCIe 378 TFLOP/s."""
    return 378e12 if "PCIe" in name else 494.7e12


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


def pa_geometry(bs, B):
    """(T, num_blocks) of a paged case with ``bs``-token blocks: the
    serving shapes' 1024 keys a sequence, a block for each key of the B
    sequences and the trash block."""
    T = PA["T"] * PA["bs"] // bs
    return T, B * T + 1


def paged_inputs(lq, dev, bs=PA["bs"], edges=False, B=PA["B"]):
    """A paged case at the serving shapes: ragged positions (``edges``:
    the first at 0, the second at T * bs - lq, the third and fourth at
    bs - 2 and 3 * bs - 2, windows that cross a block boundary), every
    sequence after the first sharing sequence 0's first physical block,
    unused table entries at the trash block 0, junk in every pool row
    (so a key read past a row's frontier shows)."""
    H, D = PA["H"], PA["D"]
    T, nb = pa_geometry(bs, B)
    rs = np.random.RandomState(100 + lq)
    q = rs.randn(B, H, lq, D).astype(np.float32)
    kp = rs.randn(H, nb * bs, D).astype(np.float32)
    vp = rs.randn(H, nb * bs, D).astype(np.float32)
    pos = rs.randint(0, T * bs - lq + 1, B).astype(np.int32)
    if edges:
        pos[0], pos[1] = 0, T * bs - lq
        pos[2], pos[3] = bs - 2, 3 * bs - 2
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


def int8_paged_inputs(lq, dev, bs=PA["bs"], edges=False, B=PA["B"]):
    """paged_inputs' tables and queries over int8 code pools, with a
    scale per (head, physical block) that puts the dequantized values
    near unit size."""
    q, _, _, tbl, pos = paged_inputs(lq, dev, bs, edges, B)
    H, D = PA["H"], PA["D"]
    _T, nb = pa_geometry(bs, B)
    rs = np.random.RandomState(200 + lq)
    kc, vc = (rs.randint(-127, 128, (H, nb * bs, D)).astype(np.int8)
              for _ in range(2))
    sk, sv = (rs.uniform(0.005, 0.02, (H, nb)).astype(np.float32)
              for _ in range(2))
    return [q] + [torch.from_numpy(a).to(dev) for a in (kc, vc)] + \
        [tbl, pos] + [torch.from_numpy(a).to(dev) for a in (sk, sv)]


def paged_case(name, lq, dev, bs=PA["bs"], edges=False, B=PA["B"]):
    """(args, kwargs) of one ``flash_attention_paged`` call of kernel
    ``name`` (its pool dtype, ``PA_DTYPES``) on ``paged_inputs``."""
    if PA_DTYPES[name] == torch.int8:
        q, kc, vc, tbl, pos, sk, sv = int8_paged_inputs(lq, dev, bs, edges,
                                                        B)
        return (q, kc, vc, tbl, pos, bs), {"kv_scales": (sk, sv)}
    q, kp, vp, tbl, pos = paged_inputs(lq, dev, bs, edges, B)
    if PA_DTYPES[name] == torch.bfloat16:
        q, kp, vp = bf16_inputs(q, kp, vp)
    return (q, kp, vp, tbl, pos, bs), {}


def paged_work(tables, pos, lq, elem=4):
    """(bytes, flops) this case needs: q and out once (bf16, ``elem``
    2: two bytes an element, else four), each K/V pool row some query
    can see once (shared blocks counted once, ``elem`` bytes an
    element), tables and positions, and for int8 pools (``elem`` 1) the
    fp32 scale of each visible (head, block) and a dequantizing multiply
    per visible element; 4*D flops per visible (query row, key,
    head)."""
    H, D, bs = PA["H"], PA["D"], PA["bs"]
    tables, pos = tables.cpu().numpy(), pos.cpu().numpy()
    B = tables.shape[0]
    assert tables.shape[1] == PA["T"]
    rows, blocks = set(), set()
    keys = 0
    for b in range(B):
        last = int(pos[b]) + lq - 1
        for p in range(last + 1):
            rows.add(int(tables[b, p // bs]) * bs + p % bs)
            blocks.add(int(tables[b, p // bs]))
        keys += sum(int(pos[b]) + r + 1 for r in range(lq))
    nbytes = ((2 if elem == 2 else 4) * 2 * B * H * lq * D +
              4 * (tables.size + pos.size) + elem * 2 * len(rows) * H * D)
    flops = 4 * D * H * keys
    if elem == 1:
        nbytes += 4 * 2 * len(blocks) * H
        flops += 2 * len(rows) * H * D
    return nbytes, flops


def dq_inputs(M, N, K, dev):
    """x (M, K), the int8 codes and row scales of a weight (N, K) drawn
    at the LM's init scale, and that weight dequantized (for the
    library yardstick)."""
    rs = np.random.RandomState(M + N + K)
    x = rs.randn(M, K).astype(np.float32)
    codes, scales = dequant_matmul.quantize_int8(
        rs.uniform(-0.1, 0.1, (N, K)).astype(np.float32), "row")
    w = dequant_matmul.dequantize_int8(codes, scales)
    return [torch.from_numpy(a).to(dev) for a in (x, codes, scales, w)]


def offset_inputs(dev, B=OFS["B"], Lk=OFS["Lk"], lq=1, dtype=torch.float32,
                  edges=False):
    """``lq`` decode query rows per sequence over a full cache of ``Lk``
    keys (H8 D64), ragged offsets in [0, Lk - lq] (``edges``: the first
    at 0, the second at Lk - lq), in ``dtype``; the seed of the earlier
    slices' B32 Lk1024 Lq1 case for that case."""
    H, D = OFS["H"], OFS["D"]
    rs = np.random.RandomState(
        300 if (B, Lk, lq) == (OFS["B"], OFS["Lk"], 1) else [300, B, Lk, lq])
    q = rs.randn(B, H, lq, D).astype(np.float32)
    k, v = (rs.randn(B, H, Lk, D).astype(np.float32) for _ in range(2))
    ofs = rs.randint(0, Lk - lq + 1, B).astype(np.int32)
    if edges:
        ofs[0], ofs[1] = 0, Lk - lq
    q, k, v, ofs = (torch.from_numpy(a).to(dev) for a in (q, k, v, ofs))
    return [t.to(dtype) for t in (q, k, v)] + [ofs]


def offset_work(ofs, lq=1, elem=4):
    """(bytes, flops): q and out once (``elem`` bytes an element), the
    offsets, each cache row of K and V some query row sees once; 4*D
    flops per visible (query row, key, head)."""
    H, D = OFS["H"], OFS["D"]
    o = ofs.cpu().long()
    B = o.numel()
    rows = int((o + lq).sum())
    pairs = sum(int((o + r + 1).sum()) for r in range(lq))
    return (elem * (2 * B * H * lq * D + 2 * rows * H * D) + 4 * B,
            4 * D * H * pairs)


def prefill_inputs(B, dev, dtype=torch.float32, L=512):
    """q, k, v of a causal prefill at B H8 L D64 from a seed."""
    rs = np.random.RandomState(500 + B)
    return [torch.from_numpy(rs.randn(B, OFS["H"], L, OFS["D"])
                             .astype(np.float32)).to(dev).to(dtype)
            for _ in range(3)]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build():
    tic = time.perf_counter()
    _build.library()
    info = _build.build_info()
    log("phase 1 build: %.2f s (compiled=%s) -> %s"
        % (time.perf_counter() - tic, info["built"], info["path"]))
    entry = ""
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif line.startswith("=="):
            log("  ptxas:", line.strip())
        elif "registers" in line or "spill" in line:
            log("  ptxas: %s: %s" % (entry, line.split(":", 1)[-1].strip()))


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
    for lq in PA_LQ:
        q, kc, vc, tbl, pos, sk, sv = int8_paged_inputs(lq, dev)
        got = paged_attention.flash_attention_paged(
            q, kc, vc, tbl, pos, PA["bs"], kv_scales=(sk, sv))
        want = paged_attention.paged_attention_reference(
            q, kc, vc, tbl, pos, PA["bs"], kv_scales=(sk, sv))
        errs[("flash_attention_paged_int8", lq)] = agree(
            "flash_attention_paged_int8", "B=%d H=%d Lq=%d D=%d bs=%d T=%d"
            % (PA["B"], PA["H"], lq, PA["D"], PA["bs"], PA["T"]), got, want,
            1e-4)
    errs.update(phase_compare_bf16(dev))
    errs.update(phase_compare_paged_edges(dev))
    errs.update(phase_compare_verify(dev))
    errs.update(phase_compare_flash(dev))
    for M in DQ_M:
        for N, K in DQ_NK:
            x, c, s, _w = dq_inputs(M, N, K, dev)
            want = dequant_matmul.dequant_matmul_dense(x, c, s)
            errs[("dequant_matmul", M, N, K)] = agree(
                "dequant_matmul", "M=%d N=%d K=%d" % (M, N, K),
                dequant_matmul.dequant_matmul(x, c, s), want,
                1e-5 * want.abs().max().item())
    return errs


def bf16_inputs(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


def phase_compare_bf16(dev):
    """The bf16 kernels against their plain versions at the serving
    shapes, within one bf16 ulp of max|ref| (attention: plus 1e-4):
    both sides widen to fp32, sum in another order and round once.
    The log gives each error in units of 2**-8 x max|ref| as well."""
    errs = {}
    for rows in NORM_ROWS:
        x, g, b = bf16_inputs(*norm_inputs(rows, dev))
        shape = "rows=%d width=%d bf16" % (rows, NORM_W)
        errs[("rms_norm_bf16", rows)] = agree_bf16(
            "rms_norm_bf16", shape, norm.rms_norm(x, g, 1e-6),
            norm.rms_norm_reference(x, g, 1e-6))
        errs[("layer_norm_bf16", rows)] = agree_bf16(
            "layer_norm_bf16", shape, norm.layer_norm(x, g, b, 1e-5),
            norm.layer_norm_reference(x, g, b, 1e-5))
    for lq in PA_LQ:
        q, kp, vp, tbl, pos = paged_inputs(lq, dev)
        q, kp, vp = bf16_inputs(q, kp, vp)
        got = paged_attention.flash_attention_paged(q, kp, vp, tbl, pos,
                                                    PA["bs"])
        if got.dtype != torch.bfloat16:
            raise SystemExit("chip_smoke: bf16 paged attention wrote %s"
                             % got.dtype)
        errs[("flash_attention_paged_bf16", lq)] = agree_bf16(
            "flash_attention_paged_bf16", "B=%d H=%d Lq=%d D=%d bs=%d T=%d "
            "bf16" % (PA["B"], PA["H"], lq, PA["D"], PA["bs"], PA["T"]),
            got, paged_attention.paged_attention_reference(
                q, kp, vp, tbl, pos, PA["bs"]), 1e-4)
    return errs


def agree_bf16(name, shape, got, want, extra=0.0):
    """``agree`` within one bf16 ulp of max|ref| plus ``extra``; the log
    gives the error in units of 2**-8 x max|ref| as well."""
    ref = want.float().abs().max().item()
    err = agree(name, shape, got.float(), want.float(), bf16_ulp(ref) + extra)
    log("phase 2 %s %s: %.3f x 2**-8 max|ref| (max|ref| %.4g)"
        % (name, shape, err / (2.0 ** -8 * ref), ref))
    return err


def agree_paged(name, shape, got, want):
    """Phase 2's bound for a paged kernel: 1e-4 absolute (fp32 and int8
    pools), one bf16 ulp of max|ref| plus 1e-4 (bf16)."""
    if PA_DTYPES[name] == torch.bfloat16:
        return agree_bf16(name, shape, got, want, 1e-4)
    return agree(name, shape, got, want, 1e-4)


def phase_compare_paged_edges(dev):
    """The paged kernel's bodies at their edges against the plain
    version: Lq on each side of the decode body's threshold, 32 and 33
    (the tile's ragged q-tile), blocks of 8 and 64 tokens, positions 0
    and T * bs - Lq, sequence 0's first block shared by every other."""
    errs = {}
    for name, dtype in PA_DTYPES.items():
        m = paged_attention.DECODE_MAX_LQ[dtype]
        for lq in sorted({m, m + 1, 32, 33}):
            for bs in (8, 64):
                args, kw = paged_case(name, lq, dev, bs, edges=True)
                path = paged_attention._plan(
                    PA["B"], PA["H"], lq, PA["D"], dtype,
                    _build.sm_count(dev.index)).path
                errs[(name, "edge", lq, bs)] = agree_paged(
                    name, "B=%d H=%d Lq=%d D=%d bs=%d T=%d positions 0 and "
                    "T*bs-Lq (%s)" % (PA["B"], PA["H"], lq, PA["D"], bs,
                                      args[3].shape[1], path),
                    paged_attention.flash_attention_paged(*args, **kw),
                    paged_attention.paged_attention_reference(*args, **kw))
    return errs


def phase_compare_verify(dev):
    """The speculative verify's paged attention (B16 H8 Lq5 D64, blocks
    of 64) in each pool dtype against the plain version, on the planned
    body and on the other one: positions 0 and T * bs - Lq, and windows
    from bs - 2 and 3 * bs - 2, whose rows r = 0..4 see keys up to
    position + r across a block boundary."""
    errs = {}
    for name, dtype in PA_DTYPES.items():
        args, kw = paged_case(name, VERIFY_LQ, dev, B=VERIFY_B, edges=True)
        plan = paged_attention._plan(VERIFY_B, PA["H"], VERIFY_LQ, PA["D"],
                                     dtype, _build.sm_count(dev.index))
        want = paged_attention.paged_attention_reference(*args, **kw)
        for path in (plan.path, "tile" if plan.path == "decode"
                     else "decode"):
            with paged_path(path):
                got = paged_attention.flash_attention_paged(*args, **kw)
            errs[(name, "verify", path)] = agree_paged(
                name, "B=%d H=%d Lq=%d D=%d bs=%d, windows across a block "
                "boundary (%s%s)" % (VERIFY_B, PA["H"], VERIFY_LQ, PA["D"],
                                     PA["bs"], path,
                                     ", planned" if path == plan.path
                                     else ""), got, want)
    return errs


def phase_compare_cast(dev):
    """Phase 2+: float-to-integer ``Cast``, ``cast`` and ``astype`` on CUDA
    tensors, from fp32 and bf16 to uint8, int8 and int32, saturating as
    the reference's convert: equal to the same casts on the CPU and, from
    fp32, to the reference's values on the out-of-range inputs."""
    edges = np.float32([-2.7, 300.7, np.nan, np.inf, -np.inf, 3e9])
    src = np.concatenate([edges, np.float32([0.49, -0.51, 1.5, -1.5, 126.9,
                                             -127.9, 254.6])])
    want_edges = {"uint8": [0, 255, 0, 255, 0, 255],
                  "int8": [-2, 127, 0, 127, -128, 127],
                  "int32": [-2, 300, 0, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1]}
    n = 0
    for src_dtype in ("float32", "bfloat16"):
        for dtype in ("uint8", "int8", "int32"):
            for how in ("Cast", "cast", "astype"):
                out = []
                for card in (True, False):
                    x = mx.nd.array(src, ctx=mx.gpu(0) if card else mx.cpu())
                    if src_dtype != "float32":
                        x = x.astype(src_dtype)
                    y = x.astype(dtype) if how == "astype" else \
                        getattr(mx.nd, how)(x, dtype=dtype)
                    if y._data.device.type != ("cuda" if card else "cpu"):
                        raise SystemExit("chip_smoke: %s ran off the card"
                                         % how)
                    out.append(y.asnumpy())
                if str(out[0].dtype) != dtype or \
                        not np.array_equal(out[0], out[1]) or \
                        (src_dtype == "float32" and
                         out[0][:len(edges)].tolist() != want_edges[dtype]):
                    raise SystemExit(
                        "chip_smoke: %s %s -> %s on the card gave %s, the "
                        "CPU %s" % (how, src_dtype, dtype, out[0].tolist(),
                                    out[1].tolist()))
                n += 1
    log("phase 2+ Cast/cast/astype float32 and bfloat16 -> uint8, int8, "
        "int32 on the card: %d cases saturate, equal to the CPU's and, from "
        "float32, to the reference's values on %s" % (n, edges.tolist()))


def agree_fa(name, shape, got, want):
    """Phase 2's bound for flash attention in ``want``'s dtype: 1e-4
    absolute (fp32), one bf16 ulp of max|ref| plus 1e-4 (bf16)."""
    if want.dtype == torch.bfloat16:
        if got.dtype != torch.bfloat16:
            raise SystemExit("chip_smoke: %s wrote %s" % (name, got.dtype))
        return agree_bf16(name, shape, got, want, 1e-4)
    return agree(name, shape, got, want, 1e-4)


@contextlib.contextmanager
def flash_path(path):
    """Every flash attention launch inside takes ``path`` ("v1",
    "decode", "tile" or, bf16 ``flash_attention`` only, "wgmma"), with
    that path's rows and grid."""
    plan = flash_attention._plan
    flash_attention._plan = lambda B, H, Lq, Lk, D, dtype, sms, offset=False: \
        flash_attention._path_plan(path, B, H, Lq)
    try:
        yield
    finally:
        flash_attention._plan = plan


def phase_compare_flash(dev):
    """Every body of both flash entry points, in fp32 and bf16, against
    the plain versions at phase 3c's shapes: the offset kernel (decode,
    tile and v1) at B32 Lk1024 and B16 Lk512, H8 Lq1 D64, ragged
    offsets; the causal kernel (wgmma in bf16, tile and v1) at B4 and
    B16 H8 L512 D64; then the wgmma body at its edges
    (``phase_compare_wgmma``)."""
    errs = phase_compare_wgmma(dev)
    for name, (dtype, offset) in FA_NAMES.items():
        tag = " bf16" if dtype == torch.bfloat16 else ""
        for B, Lk in (((OFS["B"], OFS["Lk"]), (16, 512)) if offset
                      else ((4, 512), (16, 512))):
            if offset:
                args = offset_inputs(dev, B, Lk, dtype=dtype)
                fn = flash_attention.flash_attention_offset
                want = flash_attention.offset_attention_reference(*args)
                shape = "B=%d H=%d Lq=1 Lk=%d D=%d%s" % (B, OFS["H"], Lk,
                                                         OFS["D"], tag)
                paths = ("decode", "tile", "v1")
            else:
                args = (*prefill_inputs(B, dev, dtype, L=Lk), True)
                fn = flash_attention.flash_attention
                want = flash_attention.blockwise_attention(*args)
                shape = "B=%d H=%d L=%d D=%d causal%s" % (B, OFS["H"], Lk,
                                                          OFS["D"], tag)
                paths = ("wgmma", "tile", "v1") if tag else ("tile", "v1")
            for path in paths:
                with flash_path(path):
                    errs[(name, B, Lk, path)] = agree_fa(
                        name, "%s (%s)" % (shape, path), fn(*args), want)
    return errs


def phase_compare_wgmma(dev):
    """bf16 ``flash_attention``'s wgmma body against the plain version,
    within one bf16 ulp of max|ref| plus 1e-4, at the paths' shapes and
    the ragged edges (``WGMMA_EDGES``); two launches give the same
    bits."""
    errs = {}
    rs = np.random.RandomState(14)
    for B, H, Lq, Lk, D, causal in WGMMA_EDGES:
        q = rs.randn(B, H, Lq, D).astype(np.float32)
        k, v = (rs.randn(B, H, Lk, D).astype(np.float32) for _ in range(2))
        q, k, v = (torch.from_numpy(a).to(dev).to(torch.bfloat16)
                   for a in (q, k, v))
        plan = flash_attention._plan(B, H, Lq, Lk, D, torch.bfloat16,
                                     _build.sm_count(dev.index))
        if plan.path != "wgmma":
            raise SystemExit("chip_smoke: _plan gave %s for bf16 "
                             "flash_attention at Lq %d D %d" % (plan, Lq, D))
        got = flash_attention.flash_attention(q, k, v, causal)
        again = flash_attention.flash_attention(q, k, v, causal)
        shape = "B=%d H=%d Lq=%d Lk=%d D=%d causal=%s bf16 (wgmma)" % (
            B, H, Lq, Lk, D, causal)
        errs[("flash_attention_bf16", "wgmma", B, Lq, Lk, D, causal)] = \
            agree_fa("flash_attention_bf16", shape, got,
                     flash_attention.blockwise_attention(q, k, v, causal))
        if not torch.equal(got, again):
            raise SystemExit("chip_smoke: the wgmma body gave other bits on "
                             "a second launch (%s)" % shape)
    return errs


def agree(name, shape, got, want, tol):
    """Log and return max|got - want|; fatal past ``tol`` or when the
    kernel gave a non-finite value."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise SystemExit("chip_smoke: %s gave non-finite values" % name)
    err = (got - want).abs().max().item()
    log("phase 2 %s %s: max_abs_err %.3e (tol %.3e)" % (name, shape, err,
                                                         tol))
    if not err <= tol:
        raise SystemExit("chip_smoke: %s disagrees with its plain version"
                         % name)
    return err


def train_kernel_inputs(dev):
    """Seeded inputs of the training path's kernels at full width."""
    rs = np.random.RandomState(11)
    B, H, L, D = TRAIN_ATT
    V = SPEC["vocab_size"]
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
        v=rs.randn(B, H, L, D).astype(np.float32),
        dyv=rs.randn(TRAIN_ROWS, V).astype(np.float32),
        gr=rs.uniform(0.5, 2.0, TRAIN_ROWS).astype(np.float32),
        label_out=rs.choice(np.float32([-3, -1, V, V + 5]), TRAIN_ROWS))
    out.update(label_0=np.zeros(TRAIN_ROWS, np.float32),
               label_last=np.full(TRAIN_ROWS, V - 1, np.float32))
    return {n: torch.from_numpy(a).to(dev) for n, a in out.items()}


def train_kernel_cases(t):
    """name -> (kernel call, plain call, tolerance kind) for each new
    entry point at the training shapes; outputs are tuples."""
    sm = softmax_xent.softmax_rows_reference(t["logits"])
    scale = 1.0 / TRAIN_ROWS
    out = {
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
        "softmax_rows_bwd": (
            lambda: (softmax_xent.softmax_rows_bwd(sm, t["dyv"]),),
            lambda: (softmax_xent.softmax_rows_bwd_reference(sm, t["dyv"]),),
            "rel"),
        "fused_softmax forward and backward": (
            lambda: fused_softmax_pair(softmax_xent.fused_softmax,
                                       t["logits"], t["dyv"]),
            lambda: fused_softmax_pair(softmax_xent.softmax_rows_reference,
                                       t["logits"], t["dyv"]), "rel"),
    }
    for tag in ("", "_0", "_last", "_out"):
        lbl = t["label" + tag]
        sfx = " labels" + (tag.replace("_", "=") or "=random")
        out["softmax_xent_loss" + sfx] = (
            lambda lbl=lbl: (softmax_xent.xent_loss_rows(t["logits"], lbl),),
            lambda lbl=lbl: (softmax_xent.xent_loss_rows_reference(
                t["logits"], lbl),), "rel")
        out["softmax_xent_loss_grad" + sfx] = (
            lambda lbl=lbl: (softmax_xent.softmax_xent_loss_grad(
                t["logits"], lbl, t["gr"]),),
            lambda lbl=lbl: (softmax_xent.softmax_xent_loss_grad_reference(
                t["logits"], lbl, t["gr"]),), "rel")
    return out


def fused_softmax_pair(softmax, x, dy):
    """``(p, dx)``: ``softmax(x)`` and its autograd backward for ``dy``
    (the plain side's backward is autograd over the plain softmax)."""
    xl = x.detach().clone().requires_grad_(True)
    p = softmax(xl)
    (dx,) = torch.autograd.grad(p, xl, dy)
    return p.detach(), dx


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
    for name, err in phase_compare_norm_bwd_edges(dev).items():
        errs[name] = max(errs[name], err)
    errs.update(phase_compare_train_bf16(dev))
    errs["rtc"] = phase_compare_rtc(t)
    phase_compare_cast(dev)
    return errs


def bf16_offset_copy(t, offset):
    """A contiguous bf16 copy of ``t`` starting ``offset`` elements into
    a larger buffer (8 bytes off 16-byte alignment for offset 4, 2 for
    offset 1)."""
    return offset_copy(t.to(torch.bfloat16), offset)


def phase_compare_train_bf16(dev):
    """The bf16 training kernels against their plain versions, within one
    bf16 ulp of max|ref|: both norm backwards at each edge of their two
    paths (``NORM_BWD_BF16_EDGES``: dx, dgamma and dbeta), the head's
    softmax and its gradient (``HEAD_BF16_CASES``; labels random, at the
    last column and outside the classes, float32; the gradient from the
    kernel's own p), then ``phase_compare_xent_bf16``."""
    errs = {}
    for rows, width, offset in NORM_BWD_BF16_EDGES:
        x, g, dy = norm_bwd_edge_inputs(rows, width, 0, dev)
        x, dy = bf16_offset_copy(x, offset), bf16_offset_copy(dy, offset)
        g = g.to(torch.bfloat16)
        align = norm._bwd_align(x, g, dy)
        for name, got, want in (
                ("rms_norm_bwd_bf16", norm.rms_norm_bwd(x, g, dy, 1e-6),
                 norm.rms_norm_bwd_reference(x, g, dy, 1e-6)),
                ("layer_norm_bwd_bf16", norm.layer_norm_bwd(x, g, dy, 1e-5),
                 norm.layer_norm_bwd_reference(x, g, dy, 1e-5))):
            if any(a.dtype != torch.bfloat16 for a in got):
                raise SystemExit("chip_smoke: %s wrote %s" % (
                    name, [a.dtype for a in got]))
            plan = norm._bwd_plan(rows, width, align,
                                  _build.sm_count(dev.index), torch.bfloat16,
                                  name.startswith("layer"))
            err = max(agree_bf16("%s %s" % (name, out), "rows=%d width=%d "
                                 "offset=%d bf16 (%s, %d CTAs)" % (
                                     rows, width, 2 * offset, plan.path,
                                     plan.ctas), a, b)
                      for out, a, b in zip(("dx", "dgamma", "dbeta"), got,
                                           want))
            errs[name] = max(errs.get(name, 0.0), err)
    rs = np.random.RandomState(17)
    for rows, classes in HEAD_BF16_CASES:
        x = torch.from_numpy((3 * rs.randn(rows, classes)).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        lbl = rs.randint(0, classes, rows).astype(np.float32)
        lbl[::7], lbl[1::7] = classes - 1, classes + 5
        lbl = torch.from_numpy(lbl).to(dev)
        shape = "rows=%d classes=%d bf16" % (rows, classes)
        p = softmax_xent.softmax_rows(x)
        if p.dtype != torch.bfloat16:
            raise SystemExit("chip_smoke: softmax_rows_bf16 wrote %s"
                             % p.dtype)
        err = agree_bf16("softmax_rows_bf16", shape, p,
                         softmax_xent.softmax_rows_reference(x))
        errs["softmax_rows_bf16"] = max(errs.get("softmax_rows_bf16", 0.0),
                                        err)
        err = agree_bf16(
            "xent_grad_from_probs_bf16", shape + " labels random, last, "
            "outside", softmax_xent.xent_grad_from_probs(p, lbl, 1.0 / rows),
            softmax_xent.xent_grad_from_probs_reference(p, lbl, 1.0 / rows))
        errs["xent_grad_from_probs_bf16"] = max(
            errs.get("xent_grad_from_probs_bf16", 0.0), err)
    errs.update(phase_compare_xent_bf16(dev))
    return errs


def phase_compare_xent_bf16(dev):
    """The bf16 cross-entropy loss and gradient against their plain
    versions at ``XENT_BF16_CASES``, float32 labels random, at 0, at the
    last column and outside (-1 and the class count), float32 g: the
    loss float32 within 1e-5 x max|ref|, the gradient bf16 within one
    bf16 ulp of max|ref|."""
    errs = {}
    rs = np.random.RandomState(19)
    for rows, classes, offset in XENT_BF16_CASES:
        x = torch.from_numpy((3 * rs.randn(rows, classes)).astype(
            np.float32)).to(dev)
        x = bf16_offset_copy(x, offset)
        lbl = rs.randint(0, classes, rows).astype(np.float32)
        lbl[0::5], lbl[1::5], lbl[2::5], lbl[3::5] = 0, classes - 1, -1, \
            classes
        lbl = torch.from_numpy(lbl).to(dev)
        g = torch.from_numpy(rs.uniform(0.5, 2.0, rows).astype(
            np.float32)).to(dev)
        shape = ("rows=%d classes=%d offset=%d bf16 labels random, 0, last, "
                 "-1, classes" % (rows, classes, 2 * offset))
        loss = softmax_xent.xent_loss_rows(x, lbl)
        grad = softmax_xent.softmax_xent_loss_grad(x, lbl, g)
        if loss.dtype != torch.float32 or grad.dtype != torch.bfloat16:
            raise SystemExit("chip_smoke: the bf16 loss kernels wrote %s "
                             "and %s" % (loss.dtype, grad.dtype))
        want = softmax_xent.xent_loss_rows_reference(x, lbl)
        err = agree("softmax_xent_loss_bf16", shape, loss, want,
                    1e-5 * want.abs().max().item())
        errs["softmax_xent_loss_bf16"] = max(
            errs.get("softmax_xent_loss_bf16", 0.0), err)
        err = agree_bf16("softmax_xent_loss_grad_bf16", shape, grad,
                         softmax_xent.softmax_xent_loss_grad_reference(
                             x, lbl, g))
        errs["softmax_xent_loss_grad_bf16"] = max(
            errs.get("softmax_xent_loss_grad_bf16", 0.0), err)
    return errs


def offset_copy(t, offset):
    """A contiguous copy of ``t`` whose storage starts ``offset`` floats
    into a larger buffer (4 bytes off 16-byte alignment for offset 1)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def norm_bwd_edge_inputs(rows, width, offset, dev):
    rs = np.random.RandomState(rows * 7 + width)
    x, dy = (torch.from_numpy(rs.randn(rows, width).astype(np.float32))
             .to(dev) for _ in range(2))
    g = torch.from_numpy(rs.uniform(0.5, 1.5, width).astype(np.float32))
    return offset_copy(x + 3.0, offset), g.to(dev), offset_copy(dy, offset)


def phase_compare_norm_bwd_edges(dev):
    """Both norm backwards against their plain versions at each edge of
    their paths (``NORM_BWD_EDGES``): dx and every weight gradient within
    1e-5 x max|ref|."""
    errs = {}
    for rows, width, offset in NORM_BWD_EDGES:
        x, g, dy = norm_bwd_edge_inputs(rows, width, offset, dev)
        align = norm._bwd_align(x, g, dy)
        for name, got, want in (
                ("rms_norm_bwd", norm.rms_norm_bwd(x, g, dy, 1e-6),
                 norm.rms_norm_bwd_reference(x, g, dy, 1e-6)),
                ("layer_norm_bwd", norm.layer_norm_bwd(x, g, dy, 1e-5),
                 norm.layer_norm_bwd_reference(x, g, dy, 1e-5))):
            plan = norm._bwd_plan(rows, width, align,
                                  _build.sm_count(dev.index),
                                  layer=name.startswith("layer"))
            err = max(agree("%s %s" % (name, out), "rows=%d width=%d "
                            "offset=%d (%s, %d CTAs)" % (
                                rows, width, offset, plan.path, plan.ctas),
                            a, b, 1e-5 * b.abs().max().item())
                      for out, a, b in zip(("dx", "dgamma", "dbeta"), got,
                                           want))
            errs[name] = max(errs.get(name, 0.0), err)
    return errs


def rtc_fma1(x, y):
    """The ``fma1`` CudaKernel and the NDArrays of ``o = x * y + 1``
    over ``x``'s elements."""
    k = mx.rtc.CudaKernel("fma1", RTC_FMA1)
    xs, ys = mx.nd.NDArray(x), mx.nd.NDArray(y)
    return k, xs, ys, mx.nd.NDArray(torch.empty_like(x))


def phase_compare_rtc(t):
    """``fma1`` through ``mx.rtc.CudaKernel`` on 4096 x 8192 elements
    against ``torch.addcmul``, within 2 ulp of the larger of |result|
    and |x * y| (each side rounds once, or twice without contraction)."""
    x, y = t["logits"], t["dyv"]
    tic = time.perf_counter()
    k, xs, ys, out = rtc_fma1(x, y)
    k.push([xs, ys], [out])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tic
    want = torch.addcmul(torch.ones((), device=x.device), x, y)
    inf = torch.tensor(float("inf"), device=x.device)
    mag = torch.maximum(want.abs(), (x * y).abs())
    bound = 2 * (torch.nextafter(mag, inf) - mag)
    diff = (out._data - want).abs()
    err = diff.max().item()
    ulps = (diff / (bound / 2)).max().item()
    log("phase 2 rtc fma1 %d elements (build and first launch %.2f s): "
        "max_abs_err %.3e, %.2f ulp (tol 2 ulp)"
        % (x.numel(), build_s, err, ulps))
    if not bool((diff <= bound).all()):
        raise SystemExit("chip_smoke: rtc fma1 disagrees with torch.addcmul")
    return err


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


def serve(reg, name, reqs):
    """Submit ``reqs`` to model ``name``; the three later sharers of the
    128-token prefix go in once the first sharer's prompt is prefilled
    (its first token is out), so they can adopt its blocks.  Returns
    (results, seconds, engine stats)."""
    late = (6, 9, 12)
    eng = GenerationEngine(reg)
    try:
        tic = time.perf_counter()
        stream = TokenStream()
        futs = {}
        for i, kw in enumerate(reqs):
            if i not in late:
                futs[i] = eng.submit(name, stream=stream if i == 3 else None,
                                     **kw)
        next(stream)
        for i in late:
            futs[i] = eng.submit(name, **reqs[i])
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


@contextlib.contextmanager
def dq_census():
    """Count the (M, N, K) of each ``dequant_matmul`` launch: the wrapper
    plans every launch it makes, once, so a counting shim around its
    planner sees them all (a dict update each, on the host)."""
    shapes, plan = collections.Counter(), dequant_matmul._plan

    def counted(M, N, K, sm_count):
        shapes[M, N, K] += 1
        return plan(M, N, K, sm_count)

    dequant_matmul._plan = counted
    try:
        yield shapes
    finally:
        dequant_matmul._plan = plan


@contextlib.contextmanager
def fa_census():
    """Count each launch of both flash entry points by (name, B, H, Lq,
    Lk, D, causal, body): a counting shim around the wrapper's
    ``launch`` sees every launch it makes (a dict update each, on the
    host); fatal when a launch's body and rows are not the ones
    ``_plan`` names."""
    shapes, launch = collections.Counter(), flash_attention.launch

    def counted(x, name, entry, *args):
        # flash: ..., out, B*H, Lq, Lk, D, causal, scale, path, block_q;
        # offset: ..., offsets, out, B, H, Lq, Lk, D, scale, path, block_q
        B, H, Lq, D = x.shape
        Lk = args[-5] if FA_NAMES[name][1] else args[-6]
        causal = 1 if FA_NAMES[name][1] else args[-4]
        plan = flash_attention._plan(B, H, Lq, Lk, D, x.dtype,
                                     _build.sm_count(x.device.index),
                                     offset=FA_NAMES[name][1])
        if tuple(args[-2:]) != (flash_attention._PATH[plan.path],
                                plan.block_q):
            raise SystemExit("chip_smoke: %s launched path %s, rows %s; "
                             "_plan names %s" % (name, args[-2], args[-1],
                                                 plan))
        shapes[name, B, H, Lq, Lk, D, causal, plan.path] += 1
        return launch(x, name, entry, *args)

    flash_attention.launch = counted
    try:
        yield shapes
    finally:
        flash_attention.launch = launch


def check_fa_census(tag, fa_shapes, counts):
    """Log phase ``tag``'s flash attention launches by (name, B, H, Lq,
    Lk, D, causal, body); fatal when the census missed a launch or a
    bf16 ``flash_attention`` launch above the decode threshold ran on
    another body than wgmma (``fa_census`` already held each launch to
    ``_plan``)."""
    if not fa_shapes:
        return
    log("phase %s flash attention launches by (name, B, H, Lq, Lk, D, "
        "causal, body) %s" % (tag, dict(sorted(fa_shapes.items()))))
    if sum(fa_shapes.values()) != sum(counts[k] for k in FA_NAMES):
        raise SystemExit("chip_smoke: %d flash attention shapes, %d "
                         "launches in phase %s"
                         % (sum(fa_shapes.values()),
                            sum(counts[k] for k in FA_NAMES), tag))
    off = {k: n for k, n in fa_shapes.items()
           if k[0] == "flash_attention_bf16" and k[-1] != "wgmma"
           and k[3] > flash_attention.DECODE_MAX_LQ[torch.bfloat16]}
    if off:
        raise SystemExit("chip_smoke: phase %s bf16 flash_attention "
                         "launches off the wgmma body: %s" % (tag, off))


# the norm backwards' launch names, and their paths by the C entry
# points' path argument
NB_NAMES = ("rms_norm_bwd", "layer_norm_bwd", "rms_norm_bwd_bf16",
            "layer_norm_bwd_bf16")
NB_PATHS = {v: k for k, v in norm._BWD_PATH.items()}


@contextlib.contextmanager
def nb_census():
    """Count each norm backward launch by (name, rows, width, path): a
    counting shim around the wrapper's ``launch`` sees every launch it
    makes (a dict update each, on the host); fatal when a launch's path
    and rows a warp are not the ones ``_bwd_plan`` names."""
    shapes, launch = collections.Counter(), norm.launch

    def counted(x, name, entry, *args):
        if name in NB_NAMES:
            # x, gamma, dy, dx, grads..., partials..., rows, width, eps,
            # path, rows_per_warp
            rows, width = args[-5:-3]
            align = min([16] + [p & -p for p in args[:4] if p])
            plan = norm._bwd_plan(rows, width, align,
                                  _build.sm_count(x.device.index), x.dtype,
                                  name.startswith("layer"))
            if tuple(args[-2:]) != (norm._BWD_PATH[plan.path],
                                    plan.rows_per_warp):
                raise SystemExit("chip_smoke: %s launched path %s, %s rows "
                                 "a warp; _bwd_plan names %s"
                                 % (name, args[-2], args[-1], plan))
            shapes[name, rows, width, NB_PATHS[args[-2]]] += 1
        return launch(x, name, entry, *args)

    norm.launch = counted
    try:
        yield shapes
    finally:
        norm.launch = launch


def check_nb_census(tag, nb_shapes, counts):
    """Log phase ``tag``'s norm backward launches by (name, rows, width,
    path); fatal when the census missed a launch or a bf16 launch ran
    on another path than v3 (``nb_census`` already held each launch to
    ``_bwd_plan``)."""
    log("phase %s norm backward launches by (name, rows, width, path) %s"
        % (tag, dict(sorted(nb_shapes.items()))))
    if sum(nb_shapes.values()) != sum(counts[k] for k in NB_NAMES):
        raise SystemExit("chip_smoke: %d norm backward shapes, %d launches "
                         "in phase %s" % (sum(nb_shapes.values()),
                                          sum(counts[k] for k in NB_NAMES),
                                          tag))
    off = {k: n for k, n in nb_shapes.items()
           if k[0].endswith("_bf16") and k[-1] != "v3"}
    if off:
        raise SystemExit("chip_smoke: phase %s bf16 norm backward launches "
                         "off v3: %s" % (tag, off))


@contextlib.contextmanager
def norm_path(path):
    """Every norm backward launch inside takes ``path`` ("v1", "v2" or
    "v3"), with that path's grid."""
    plan = norm._bwd_plan
    norm._bwd_plan = lambda rows, width, align, sms, dtype, layer: \
        norm._bwd_grid(path, rows, width, sms, layer)
    try:
        yield
    finally:
        norm._bwd_plan = plan


@contextlib.contextmanager
def pa_census():
    """Count each paged attention launch by (name, B, Lq): a shim around
    the wrapper's ``launch`` (a dict update each, on the host); fatal
    when a launch's path and rows are not the ones ``_plan`` names."""
    shapes, launch = collections.Counter(), paged_attention.launch

    def counted(x, name, entry, *args):
        # ..., B, H, Lq, D, T, block_size, pool_rows, scale, path, block_q
        B, H, Lq, D = args[-10:-6]
        plan = paged_attention._plan(B, H, Lq, D, PA_DTYPES[name],
                                     _build.sm_count(x.device.index))
        if tuple(args[-2:]) != (paged_attention._PATH[plan.path],
                                plan.block_q):
            raise SystemExit("chip_smoke: %s launched path %s, rows %s; "
                             "_plan names %s" % (name, args[-2], args[-1],
                                                 plan))
        shapes[name, B, Lq, plan.path] += 1
        return launch(x, name, entry, *args)

    paged_attention.launch = counted
    try:
        yield shapes
    finally:
        paged_attention.launch = launch


@contextlib.contextmanager
def paged_path(path):
    """Every paged attention launch inside takes ``path`` ("v1",
    "decode" or "tile"), with that path's rows and grid."""
    plan = paged_attention._plan
    paged_attention._plan = lambda B, H, Lq, D, dtype, sms: \
        paged_attention._path_plan(path, B, H, Lq, sms)
    try:
        yield
    finally:
        paged_attention._plan = plan


def phase_serve(tag, name, params, reqs, draft=None):
    """Serve ``reqs`` on a new registry with phase ``tag``'s store
    arguments (``SERVE_PHASES``), the launch counts set to 0 just before
    and read just after; fatal when a kernel of the path did not launch
    or one that must not did.  ``draft``: ``add_draft_model``'s
    arguments (params, spec, compute_dtype) for speculative decoding
    with ``SPEC_K`` proposals a tick.  Returns a dict of the run."""
    kw, must, must_not = SERVE_PHASES[tag]
    tic = time.perf_counter()
    reg = ModelRegistry()
    store = reg.add_generative_model(name, params, SPEC, **kw)
    st = store.stats()
    log("phase %s registry + warmup on %s: %.2f s; compute %s, kv %s, "
        "paged %s, %d weight bytes %s"
        % (tag, store.device, time.perf_counter() - tic,
           st["compute_dtype"] or "float32", st["kv_dtype"], st["paged"],
           st["weight_bytes"]["total"], st["weight_bytes"]["by_dtype"]))
    if draft is not None:
        tic = time.perf_counter()
        d = reg.add_draft_model(name, draft["params"], draft["spec"],
                                spec_k=SPEC_K,
                                compute_dtype=draft.get("compute_dtype"))
        log("phase %s draft (%d layers, hidden %d, compute %s) attached with "
            "spec_k %d, both sides warmed: %.2f s"
            % (tag, d.spec["num_layers"], d.spec["num_hidden"],
               d.stats()["compute_dtype"] or "float32", SPEC_K,
               time.perf_counter() - tic))
    kernels.reset_launch_counts()
    with dq_census() as shapes, fa_census() as fa_shapes, \
            pa_census() as pa_shapes:
        results, seconds, stats = serve(reg, name, reqs)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_results(results, reqs)
    ntok = sum(len(r.tokens) for r in results)
    steps = stats["decode_steps"] + stats["prefills"]
    log("phase %s served %d requests, %d tokens in %.3f s: %.1f generated "
        "tokens/s, %.3f ms per step; prefix_hits %d cow_forks %d "
        "prefills %d prefill_chunks %d decode_steps %d cache_grows %d; "
        "launches %s"
        % (tag, len(results), ntok, seconds, ntok / seconds,
           seconds * 1e3 / steps, stats["prefix_hits"], stats["cow_forks"],
           stats["prefills"], stats["prefill_chunks"], stats["decode_steps"],
           stats["cache_grows"], counts))
    if shapes:
        by_m, by_nk = collections.Counter(), collections.Counter()
        for (m, n, k), c in shapes.items():
            by_m[m] += c
            by_nk["N=%d K=%d" % (n, k)] += c
        log("phase %s dequant_matmul launches by M %s, by (N, K) %s"
            % (tag, dict(sorted(by_m.items())), dict(by_nk)))
        if sum(shapes.values()) != counts["dequant_matmul"]:
            raise SystemExit("chip_smoke: %d dequant_matmul plans, %d "
                             "launches in phase %s"
                             % (sum(shapes.values()),
                                counts["dequant_matmul"], tag))
    check_fa_census(tag, fa_shapes, counts)
    if pa_shapes:
        by_path = collections.Counter()
        for (kname, b, lq, path), c in pa_shapes.items():
            by_path[kname, path, lq] += c
        log("phase %s paged attention launches by (name, B, Lq, path) %s; "
            "by (name, path, Lq) %s"
            % (tag, dict(sorted(pa_shapes.items())),
               dict(sorted(by_path.items()))))
        if sum(pa_shapes.values()) != sum(counts[k] for k in PA_DTYPES):
            raise SystemExit("chip_smoke: %d paged shapes, %d launches in "
                             "phase %s" % (sum(pa_shapes.values()),
                                           sum(counts[k] for k in PA_DTYPES),
                                           tag))
    for k in must:
        if counts[k] <= 0:
            raise SystemExit("chip_smoke: %s never launched in phase %s"
                             % (k, tag))
    for k in must_not:
        if counts[k] != 0:
            raise SystemExit("chip_smoke: %s launched in phase %s" % (k, tag))
    if store.paged and (stats["prefix_hits"] < 3 or stats["cow_forks"] < 1):
        raise SystemExit("chip_smoke: the shared-prefix requests did not "
                         "share blocks in phase %s" % tag)
    return dict(reg=reg, store=store, results=results, counts=counts,
                fa_shapes=fa_shapes, pa_shapes=pa_shapes, stats=stats,
                tok_s=ntok / seconds, step_ms=seconds * 1e3 / steps,
                cache=stats["cache_hwm"].get(name, {}))


def itl_ms(results):
    """(p50, p99, mean) inter-token gaps in ms over every stream."""
    gaps = np.array([g for r in results for g in r.itl_s()]) * 1e3
    return (float(np.percentile(gaps, 50)), float(np.percentile(gaps, 99)),
            float(gaps.mean()))


def phase_spec(tag, served, base, reqs, margin, self_draft):
    """A speculative run (``served``) against its non-speculative base:
    target decode steps per generated token against the base's (at most
    0.6x with a self-draft), the acceptance, tokens/s and ITL beside the
    base's, the greedy streams equal the base's but at a near tie
    (``margin``, as ``compare_streams``), the paged launches by (name,
    Lq, body): every verify (Lq = SPEC_K + 1) on its planned body
    (``pa_census`` held each launch to ``_plan``) and every Lq 1 launch on
    the decode body."""
    st, bst = served["stats"], base["stats"]
    ratio = (st["decode_steps"] / st["generated_tokens"]) / \
        (bst["decode_steps"] / bst["generated_tokens"])
    acc = st["spec_accepted"] / max(st["spec_proposed"], 1)
    desc = served["cache"]
    log("phase %s target decode steps %d for %d tokens vs base %d for %d: "
        "%.4fx steps per token%s; spec_steps %d spec_proposed %d "
        "spec_accepted %d (acceptance %.4f) spec_draft_steps %d "
        "spec_fallback_steps %d; spec_k %s draft_pool_bytes %s (target "
        "pool_bytes %s)"
        % (tag, st["decode_steps"], st["generated_tokens"],
           bst["decode_steps"], bst["generated_tokens"], ratio,
           " (gate 0.6x)" if self_draft else "", st["spec_steps"],
           st["spec_proposed"], st["spec_accepted"], acc,
           st["spec_draft_steps"], st["spec_fallback_steps"],
           desc.get("spec_k"), desc.get("draft_pool_bytes"),
           desc.get("pool_bytes")))
    log("phase %s generated tokens/s %.1f vs base %.1f (%.4fx); ITL p50 "
        "%.3f p99 %.3f mean %.3f ms vs base p50 %.3f p99 %.3f mean %.3f ms "
        "(host clock)" % ((tag, served["tok_s"], base["tok_s"],
                           served["tok_s"] / base["tok_s"]) +
                          itl_ms(served["results"]) + itl_ms(base["results"])))
    if st["spec_steps"] <= 0 or desc.get("spec_k") != SPEC_K:
        raise SystemExit("chip_smoke: phase %s never speculated" % tag)
    if self_draft and not ratio <= 0.6:
        raise SystemExit("chip_smoke: phase %s took %.4fx the target steps "
                         "per token (gate 0.6x)" % (tag, ratio))
    by_lq = collections.Counter()
    for (kname, _b, lq, path), c in served["pa_shapes"].items():
        by_lq[kname, lq, path] += c
        if lq == 1 and path != "decode":
            raise SystemExit("chip_smoke: phase %s ran an Lq 1 launch on %s"
                             % (tag, path))
    log("phase %s paged launches by (name, Lq, body) %s"
        % (tag, dict(sorted(by_lq.items()))))
    if not any(lq == SPEC_K + 1 for _k, lq, _p in by_lq):
        raise SystemExit("chip_smoke: phase %s made no verify launch" % tag)
    same, n = compare_streams(tag, served["results"], base["results"], reqs,
                              margin)
    log("phase %s greedy streams speculative == non-speculative: %d of %d"
        % (tag, same, n))
    return acc


def phase_int8_bytes(fp, i8):
    """Phase 3b's memory against phase 3's: weight bytes, and pool bytes
    per token with the scale pools counted (the reference's gate for
    the latter: at most 0.3x)."""
    wb = [r["store"].stats()["weight_bytes"]["total"] for r in (fp, i8)]
    pt = [r["cache"]["pool_bytes_per_token"] for r in (fp, i8)]
    log("phase 3b weight_bytes int8 %d vs fp32 %d (%.4fx); "
        "pool_bytes_per_token int8 %.1f vs fp32 %.1f (%.4fx, gate 0.3x)"
        % (wb[1], wb[0], wb[1] / wb[0], pt[1], pt[0], pt[1] / pt[0]))
    if not pt[1] <= 0.3 * pt[0]:
        raise SystemExit("chip_smoke: the int8 pool holds a token in more "
                         "than 0.3x the fp32 pool's bytes")


def phase_bf16_bytes(fp, b16):
    """Phase 3d's memory against phase 3's: weight bytes and pool bytes
    per token must be exactly half (the reference's gate for the pool,
    ``tests/test_quant_serving.py``); tokens/s beside them."""
    wb = [r["store"].stats()["weight_bytes"]["total"] for r in (fp, b16)]
    pt = [r["cache"]["pool_bytes_per_token"] for r in (fp, b16)]
    log("phase 3d weight_bytes bf16 %d vs fp32 %d (%.4fx); "
        "pool_bytes_per_token bf16 %.1f vs fp32 %.1f (%.4fx); generated "
        "tokens/s bf16 %.1f vs fp32 %.1f"
        % (wb[1], wb[0], wb[1] / wb[0], pt[1], pt[0], pt[1] / pt[0],
           b16["tok_s"], fp["tok_s"]))
    if wb[1] * 2 != wb[0] or pt[1] * 2 != pt[0]:
        raise SystemExit("chip_smoke: bf16 weights or pool are not exactly "
                         "half of fp32's bytes")


def phase_contiguous_bf16_bytes(fp, b16):
    """Phase 3e's memory against phase 3c's: weight bytes and the bytes
    a slot's cache holds at ``kv_max`` must be exactly half; the served
    high-water mark's bytes per slot and tokens/s beside them."""
    wb = [r["store"].stats()["weight_bytes"]["total"] for r in (fp, b16)]
    slot = [sum(t.numel() * t.element_size()
                for t in r["store"].new_cache(1, r["store"].kv_max))
            for r in (fp, b16)]
    hwm = [(r["cache"]["cache_bytes_per_slot"], r["cache"]["cache_len"])
           for r in (fp, b16)]
    log("phase 3e weight_bytes bf16 %d vs fp32 %d (%.4fx); cache bytes a "
        "slot at kv_max bf16 %d vs fp32 %d (%.4fx); served high-water "
        "bytes per slot bf16 %d at %d tokens vs fp32 %d at %d; generated "
        "tokens/s bf16 %.1f vs fp32 %.1f"
        % (wb[1], wb[0], wb[1] / wb[0], slot[1], slot[0], slot[1] / slot[0],
           *hwm[1], *hwm[0], b16["tok_s"], fp["tok_s"]))
    if wb[1] * 2 != wb[0] or slot[1] * 2 != slot[0] or \
            hwm[1][0] * hwm[0][1] * 2 != hwm[0][0] * hwm[1][1]:
        raise SystemExit("chip_smoke: bf16 weights or cache are not exactly "
                         "half of fp32's bytes")


def top2_margin_contiguous(model_cpu, prompt, gen, kv_dtype):
    """``top2_margin`` on the contiguous plane: the prompt in one
    prefill, then one decode step a generated token (the engine's
    schedule)."""
    C = -(-(len(prompt) + len(gen) + 1) // 64) * 64
    params = model_cpu.params()
    with torch.no_grad():
        logits, ck, cv = tlm.prefill_apply(
            params, np.asarray([prompt], np.int32),
            np.asarray([len(prompt)], np.int32), C, SPEC,
            cache_dtype=kv_dtype)
        logits = logits[:, len(prompt) - 1]
        for i, t in enumerate(gen):
            logits, ck, cv = tlm.decode_apply(
                params, ck, cv, np.asarray([t], np.int32),
                np.asarray([len(prompt) + i], np.int32), SPEC)
    top = torch.topk(logits[0], 2).values
    return (top[0] - top[1]).item(), logits.abs().max().item()


def top2_margin(model_cpu, prompt, gen, kv_dtype=torch.float32):
    """CPU logit margin between the best and second-best next token
    after ``prompt + gen`` (one sequence), and the largest |logit|.
    fp32 pools: one chunk.  int8 and bf16 pools, whose contents depend
    on the order of the writes (int8 codes) or on the rows each product
    saw (bf16): the engine's schedule, the prompt in 32-token prefill
    chunks and then one generated token a step."""
    tokens = prompt + gen
    bs = 64
    T = -(-len(tokens) // bs)
    tables = np.arange(1, T + 1, dtype=np.int32)[None]
    pk, pv = tlm.init_pool(SPEC, T + 1, bs, dtype=kv_dtype)
    scales = tlm.init_scale_pool(SPEC, T + 1) \
        if kv_dtype == torch.int8 else None
    if kv_dtype == torch.float32:
        feeds = [(0, tokens)]
    else:
        feeds = [(p0, prompt[p0:p0 + 32]) for p0 in range(0, len(prompt), 32)]
        feeds += [(len(prompt) + i, [t]) for i, t in enumerate(gen)]
    for p0, toks in feeds:
        logits = model_cpu(pk, pv, tables, np.asarray([toks], np.int32),
                           np.asarray([p0], np.int32),
                           np.asarray([len(toks)], np.int32), bs,
                           scales=scales)[0]
    top = torch.topk(logits[0], 2)
    log("  CPU top-2 logits after %d generated tokens: token %d %.6f, token "
        "%d %.6f" % (len(gen), top.indices[0].item(), top.values[0].item(),
                     top.indices[1].item(), top.values[1].item()))
    top = top.values
    return (top[0] - top[1]).item(), logits.abs().max().item()


def compare_streams(tag, got, want, reqs, margin):
    """Greedy streams ``got`` against ``want``; a stream may differ only
    where ``margin(i, prefix)`` gives ``(m, bound)`` with the CPU's
    top-2 margin ``m`` after the common prefix below ``bound``."""
    same = 0
    greedy = [i for i, kw in enumerate(reqs) if "temperature" not in kw]
    for i in greedy:
        a, b = got[i].tokens, want[i].tokens
        if a == b:
            same += 1
            continue
        k = next(j for j in range(len(a)) if a[j] != b[j])
        m, bound = margin(i, b[:k])
        log("phase %s stream %d differs at step %d: CPU top-2 margin %.3e "
            "(near-tie bound %.3e)" % (tag, i, k, m, bound))
        if not m < bound:
            raise SystemExit("chip_smoke: phase %s greedy stream %d differs "
                             "where the CPU is not near a tie" % (tag, i))
    return same, len(greedy)


def phase_contiguous_vs_paged(served, paged, reqs, model_cpu):
    """Phase 3c's streams against phase 3's: both planes compute the
    same function."""
    same, n = compare_streams(
        "3c", served["results"], paged["results"], reqs,
        lambda i, gen: (top2_margin(model_cpu, reqs[i]["tokens"], gen)[0],
                        MARGIN))
    log("phase 3c greedy streams contiguous == paged: %d of %d" % (same, n))


def phase_card_vs_cpu(tag, name, params, served, reqs):
    """One prefill chunk and one decode step of ``paged_step_apply`` on
    the card and on the CPU, then the greedy streams of the serving
    phase (run as ``served``) against a CPU engine's with the same store
    arguments; bounds from ``CARD_VS_CPU``."""
    serve_tag, kind, bound = CARD_VS_CPU[tag]
    kw = SERVE_PHASES[serve_tag][0]
    kv_dtype = served["store"].kv_dtype
    cpu_reg = ModelRegistry()
    cpu_reg.add_generative_model(name, params, SPEC, device="cpu",
                                 warmup=False, **kw)
    model_cpu = cpu_reg.gen_store(name).model
    model_gpu = served["store"].model
    bs, B, T = 64, 4, 4
    rs = np.random.RandomState(7)
    tables = np.arange(1, B * T + 1, dtype=np.int32).reshape(B, T)
    chunk = rs.randint(0, SPEC["vocab_size"], (B, 32)).astype(np.int32)
    valid = np.array([32, 20, 7, 32], np.int32)
    pools, scales = {}, {}
    for m in (model_gpu, model_cpu):
        pools[m] = tlm.init_pool(SPEC, B * T + 1, bs, device=m.device,
                                 dtype=kv_dtype)
        scales[m] = tlm.init_scale_pool(SPEC, B * T + 1, device=m.device) \
            if kv_dtype == torch.int8 else None
    paged = served["store"].paged
    caches = {}
    for what, toks, pos, val in (
            ("prefill chunk" if paged else "prefill", chunk,
             np.zeros(B, np.int32), valid),
            ("decode step", chunk[:, :1], valid, np.ones(B, np.int32))):
        out = {}
        for m in (model_gpu, model_cpu):
            with torch.no_grad():
                if paged:
                    logits = m(*pools[m], tables, toks, pos, val, bs,
                               scales=scales[m])[0]
                elif what == "prefill":
                    logits, *caches[m] = tlm.prefill_apply(
                        m.params(), toks, val, 64, SPEC, cache_dtype=kv_dtype)
                    logits = logits[torch.arange(B), torch.as_tensor(
                        val, device=logits.device).long() - 1]
                else:
                    logits = tlm.decode_apply(m.params(), *caches[m],
                                              toks[:, 0], pos, SPEC)[0]
            out[m] = logits.cpu()
        err = (out[model_gpu] - out[model_cpu]).abs().max().item()
        ref = out[model_cpu].abs().max().item()
        tol = bound * ref if kind == "rel" else bound
        log("phase %s %s logits card vs CPU: max_abs_err %.3e (tol %.3e; "
            "%.3e x max|ref| %.4g)" % (tag, what, err, tol, err / ref, ref))
        if not (err <= tol and bool(torch.isfinite(out[model_gpu]).all())):
            raise SystemExit("chip_smoke: card and CPU logits disagree")
    tic = time.perf_counter()
    cpu_results, _, _ = serve(cpu_reg, name, reqs)
    check_results(cpu_results, reqs)

    def margin(i, gen):
        m, top = (top2_margin if paged else top2_margin_contiguous)(
            model_cpu, reqs[i]["tokens"], gen, kv_dtype)
        return m, bound * top if kind == "rel" else bound
    same, n = compare_streams(tag, served["results"], cpu_results, reqs,
                              margin)
    log("phase %s greedy streams card == CPU: %d of %d (CPU engine %.1f s)"
        % (tag, same, n, time.perf_counter() - tic))


def friendly_params(params):
    """Phase 3g's friendly draft: the target's weights plus 3% relative
    noise from a fixed seed, as the reference's load generator makes a
    draft that agrees with a random target (``serving/loadgen.py``)."""
    rs = np.random.RandomState(7)
    return {k: v + np.asarray(0.03 * (float(np.std(v)) or 1.0) *
                              rs.standard_normal(v.shape), v.dtype)
            for k, v in params.items()}


def phase_spec_runs(params, reqs, served):
    """Phases 3f and 3g: phase 3's mix, speculative, on phase 3's store
    with a self-draft (3f), on phase 3b's int8 store with an int8
    self-draft (3f, int8), and on phase 3's store with a friendly and an
    adversarial draft (3g).  The fp32 runs' greedy streams must equal
    phase 3's but at a near tie; the int8 run's are compared and
    reported only, since its pool blocks are requantized once a window
    rather than once a token, so its KV codes differ from phase 3b's by
    design.  Adds the runs to ``served``."""
    model_cpu = tlm.TransformerLM.from_numpy(params, SPEC, device="cpu")
    cpu8 = ModelRegistry()
    cpu8.add_generative_model("lm8", params, SPEC, device="cpu",
                              warmup=False, **SERVE_PHASES["3b"][0])
    model_cpu8 = cpu8.gen_store("lm8").model

    def fp_margin(i, gen):
        return top2_margin(model_cpu, reqs[i]["tokens"], gen)[0], MARGIN

    def i8_margin(i, gen):
        return top2_margin(model_cpu8, reqs[i]["tokens"], gen,
                           torch.int8)[0], float("inf")

    runs = (("3f", "lm", "3", dict(params=params, spec=SPEC), fp_margin,
             True),
            ("3f8", "lm8", "3b", dict(params=params, spec=SPEC,
                                      compute_dtype="int8"), i8_margin, True),
            ("3g", "lm", "3", dict(params=friendly_params(params),
                                   spec=SPEC), fp_margin, False),
            ("3ga", "lm", "3", dict(params=tlm.random_params(ADV_SPEC, 9),
                                    spec=ADV_SPEC), fp_margin, False))
    for tag, name, base, draft, margin, self_draft in runs:
        served[tag] = phase_serve(tag, name, params, reqs, draft=draft)
        phase_spec(tag, served[tag], served[base], reqs, margin, self_draft)
    if not served["3ga"]["stats"]["spec_fallback_steps"] > 0:
        raise SystemExit("chip_smoke: the adversarial draft never fell back")


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


@contextlib.contextmanager
def plain_guard():
    """Count every wrapper call that takes its plain version (``route``
    answering False) inside, by wrapper name: a CUDA tensor never
    should."""
    mods = (norm, softmax_xent, flash_attention, paged_attention,
            dequant_matmul)
    saved = [m.route for m in mods]
    plain = collections.Counter()

    def guarded(name, x):
        on_card = _build.route(name, x)
        if not on_card:
            plain[name] += 1
        return on_card

    for m in mods:
        m.route = guarded
    try:
        yield plain
    finally:
        for m, r in zip(mods, saved):
            m.route = r


def phase_train(dev, card, compute_dtype=None, step_ms_fp32=None):
    """``Module.fit`` at full width for TRAIN_STEPS SGD steps, set up as
    the repo's on-chip training row (bench.py) but for the learning rate
    (see TRAIN_OPT); returns the launch counts of the whole run and the
    ms per step after the warmup.  ``compute_dtype='bfloat16'`` is phase
    6b: the bf16 launch table, no plain version reached, and float32
    parameters, gradients and momentum after the fit; its times beside
    phase 6's (``step_ms_fp32``)."""
    tag = "6b" if compute_dtype else "6"
    table = (TRAIN_BF16_LAUNCHES_PER_STEP if compute_dtype
             else TRAIN_LAUNCHES_PER_STEP)
    X, y = train_data(TRAIN_STEPS * TRAIN_BATCH)
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    mx.random.seed(0)
    mod = mx.Module(train_symbol(), context=dev, compute_dtype=compute_dtype)
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
    with plain_guard() as plain, fa_census() as fa_shapes, \
            nb_census() as nb_shapes:
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=TRAIN_OPT, initializer=mx.init.Xavier(),
                eval_metric=mx.metric.Perplexity(ignore_label=None),
                batch_end_callback=on_batch)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_fa_census(tag, fa_shapes, counts)
    check_nb_census(tag, nb_shapes, counts)
    wall = time.perf_counter() - tic
    if plain:
        raise SystemExit("chip_smoke: phase %s reached plain versions: %s"
                         % (tag, dict(plain)))
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(table)
    if len(steps) != TRAIN_STEPS:
        raise SystemExit("chip_smoke: fit ran %d steps, not %d"
                         % (len(steps), TRAIN_STEPS))
    for i, got in enumerate(steps):
        if got != want:
            raise SystemExit("chip_smoke: phase %s training step %d "
                             "launched %s, want %s" % (tag, i, got, want))
    if counts != {k: v * TRAIN_STEPS for k, v in want.items()}:
        raise SystemExit("chip_smoke: training launches %s" % counts)
    probs = mod.get_outputs()[0]._data
    if not (all(np.isfinite(ppl)) and bool(torch.isfinite(probs).all())):
        raise SystemExit("chip_smoke: training gave a non-finite loss")
    if compute_dtype:
        check_master_fp32(mod, probs)
    first, final = (float(np.mean(ppl[:5])), float(np.mean(ppl[-5:])))
    log("phase %s perplexity per step: %s"
        % (tag, " ".join("%.1f" % p for p in ppl)))
    if not final < first:
        raise SystemExit("chip_smoke: perplexity did not fall: first 5 "
                         "steps %.2f, last 5 %.2f" % (first, final))
    timed = TRAIN_STEPS - TRAIN_WARMUP
    sec = clock[TRAIN_STEPS - 1] - clock[TRAIN_WARMUP - 1]
    step_ms = sec * 1e3 / timed
    beside = "" if step_ms_fp32 is None else (
        "; phase 6 (fp32) %.3f ms per step, %.1f samples/s, %.0f tokens/s; "
        "ratio %.3f" % (step_ms_fp32, TRAIN_BATCH * 1e3 / step_ms_fp32,
                        TRAIN_ROWS * 1e3 / step_ms_fp32,
                        step_ms / step_ms_fp32))
    log("phase %s trained %d steps%s (fit %.2f s with bind and init): "
        "perplexity first 5 steps %.2f, last 5 %.2f; launches per step %s; "
        "steps %d..%d: %.3f ms per step, %.1f samples/s, %.0f tokens/s%s "
        "[%s]"
        % (tag, TRAIN_STEPS, " in %s" % compute_dtype if compute_dtype
           else "", wall, first, final, table, TRAIN_WARMUP + 1, TRAIN_STEPS,
           step_ms, timed * TRAIN_BATCH / sec,
           timed * TRAIN_BATCH * TRAIN_SEQ / sec, beside, card))
    return counts, step_ms


def check_master_fp32(mod, probs):
    """Phase 6b: the outputs bf16; the bound parameters, their gradients,
    the optimizer's momentum and ``get_params`` float32."""
    if probs.dtype != torch.bfloat16:
        raise SystemExit("chip_smoke: phase 6b output is %s" % probs.dtype)
    group = mod._exec_group
    arrays = {"parameter " + n: a._data for n, a in
              zip(group.param_names, group.param_arrays)}
    arrays.update(("gradient " + n, g._data) for n, g in
                  zip(group.param_names, group.grad_arrays))
    arrays.update(("momentum %d" % i, st._data) for i, st in
                  mod._updater.states.items() if st is not None)
    arrays.update(("get_params " + n, a._data) for n, a in
                  mod.get_params()[0].items())
    wrong = {k: t.dtype for k, t in arrays.items()
             if t.dtype != torch.float32}
    if wrong:
        raise SystemExit("chip_smoke: phase 6b master arrays not float32: "
                         "%s" % wrong)
    log("phase 6b: outputs bf16; %d parameters, gradients, momenta and "
        "get_params arrays float32" % len(arrays))


def profile_train(dev, card, step_ms, compute_dtype=None, warmup=3,
                  steps=5):
    """``--profile``: ``torch.profiler`` over ``steps`` steps of
    ``Module.fit`` after ``warmup`` (the setup of phase 6, or 6b with
    ``compute_dtype``).  Prints the device time and launches per step,
    the device's busy share of the phase's unprofiled ``step_ms``, and
    the ops with the most device time.  Host times under the profiler
    are inflated by its own overhead, so none is printed but the
    window's."""
    tag = "6b" if compute_dtype else "6"
    X, y = train_data((warmup + steps) * TRAIN_BATCH)
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    mx.random.seed(0)
    mod = mx.Module(train_symbol(), context=dev, compute_dtype=compute_dtype)
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
    report_profile(tag, prof, steps, step_ms, window_ms, card)


def report_profile(tag, prof, steps, step_ms, window_ms, card):
    """Print a profiler window of ``steps`` steps: the device time and
    launches per step, the device's busy share of the phase's unprofiled
    ``step_ms``, and the ops with the most device and host time."""
    avgs = prof.key_averages()
    on_card = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in on_card) / 1e3 / steps
    launches = sum(e.count for e in on_card) / steps
    log("profile %s, %d steps: device %.3f ms per step in %.0f kernels "
        "and copies, %.1f%% of phase %s's %.3f ms per step (%.3f ms per "
        "step under the profiler) [%s]"
        % (tag, steps, dev_ms, launches, 100 * dev_ms / step_ms, tag,
           step_ms, window_ms, card))
    ops = [e for e in avgs if e not in on_card]
    for e in sorted(ops, key=lambda e: e.self_device_time_total,
                    reverse=True)[:15]:
        log("profile %s op: %8.3f ms device per step, %6.1f calls per "
            "step: %s" % (tag, e.self_device_time_total / 1e3 / steps,
                          e.count / steps, e.key[:80]))
    # the host side (inflated by the profiler's own overhead): where the
    # step's host time goes, by self and by inclusive time
    for key, what in (("self_cpu_time_total", "self"),
                      ("cpu_time_total", "total")):
        for e in sorted(ops, key=lambda e: getattr(e, key),
                        reverse=True)[:8]:
            log("profile %s host %s: %8.3f ms per step, %6.1f calls per "
                "step: %s" % (tag, what, getattr(e, key) / 1e3 / steps,
                              e.count / steps, e.key[:80]))


def one_step(dev, params, compute_dtype=None, phase="7"):
    """Probabilities and every gradient of one training step on ``dev``,
    as numpy arrays by name (bf16 probabilities widened to float32, the
    gradients float32 in either dtype)."""
    X, y = train_data(TRAIN_BATCH)
    it = mx.io.NDArrayIter(X, y, batch_size=TRAIN_BATCH)
    mod = mx.Module(train_symbol(), context=dev, compute_dtype=compute_dtype)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=params)
    tic = time.perf_counter()
    mod.forward_backward(next(iter(it)))
    ex = mod._exec_group.executor
    out_dtype = ex.outputs[0]._data.dtype
    grad_dtypes = {g._data.dtype for g in ex.grad_dict.values()}
    if out_dtype != (torch.bfloat16 if compute_dtype else torch.float32) \
            or grad_dtypes != {torch.float32}:
        raise SystemExit("chip_smoke: a %s step gave %s outputs and %s "
                         "gradients" % (compute_dtype or "float32",
                                        out_dtype, grad_dtypes))
    out = {"probabilities": ex.outputs[0].asnumpy()}
    out.update((n, g.asnumpy()) for n, g in ex.grad_dict.items())
    log("phase %s one %s step on %s: %.2f s" % (
        phase, compute_dtype or "float32", dev, time.perf_counter() - tic))
    return out


def step_params():
    """Phase 7's parameters.  The FFN biases are shifted up by 1 so that
    every ReLU input lies far from zero: at a kink, an input that
    rounding puts on the other side of zero passes or stops a whole
    gradient term, and single elements then differ by far more than the
    kernels' rounding."""
    params = tlm.random_params(SPEC, seed=3)
    for name in params:
        if name.endswith("_ffn1_bias"):
            params[name] = params[name] + np.float32(1.0)
    return params


def hold_bf16(phase, what, got, ref, ref32):
    """Each array of a bf16 step (``got``) against ``ref``: within its
    ``BF16_STEP_TOL`` x max|ref| or, where bf16 itself moves ``ref``
    further than that from the fp32 step ``ref32`` (in this run), within
    that distance.  Logs each array's ratio to its bound; fatal past
    it."""
    worst, worst_name, failed, floored = 0.0, None, [], []
    for name, r in ref.items():
        g = got[name]
        if not np.isfinite(g).all():
            raise SystemExit("chip_smoke: %s is not finite (phase %s, %s)"
                             % (name, phase, what))
        tol = BF16_STEP_TOL.get(name, BF16_STEP_TOL["gradient"])
        scale = max(np.abs(r).max(), 1e-30)
        rel = float(np.abs(g - r).max() / scale)
        own = float(np.abs(r - ref32[name]).max() / scale)
        bound = max(tol, own)
        if own > tol:
            floored.append(name)
        log("phase %s %s %s: %.3e x max|ref|, %.3f of its bound %.3e (%s); "
            "bf16 vs fp32 %.3e; max|ref| %.3e"
            % (phase, what, name, rel, rel / bound, bound,
               "bf16's own distance" if own > tol else "tolerance", own,
               scale))
        if rel / bound > worst:
            worst, worst_name = rel / bound, name
        if not rel <= bound:
            failed.append(name)
    if failed:
        raise SystemExit("chip_smoke: %s differ past their bounds (phase "
                         "%s, %s)" % (failed, phase, what))
    log("phase %s %s: %d arrays agree (tol %s x max|ref|); held to bf16's "
        "own distance from fp32 instead: %s; %s"
        % (phase, what, len(ref), BF16_STEP_TOL, floored or "none",
           "worst %s at %.3f of its bound" % (worst_name, worst)
           if worst_name else "every array equal"))


def phase_train_bf16_vs_cpu(dev, params):
    """Phase 7b: one ``compute_dtype='bfloat16'`` step from phase 7's
    parameters and batch on the card and on the CPU.  Each array is held
    to its ``BF16_STEP_TOL`` x max|ref| (probabilities 2e-2, every
    gradient 5e-2), or, where bf16 itself moves it further than that
    (the CPU's bf16 step against its fp32 step, in this run), to that
    distance: the card's bf16 step may be no further from the CPU's than
    bf16 is from fp32.  bf16 rounds at other places on the two devices
    (the card's tensor cores truncate their fp32 sums, the CPU rounds
    its products correctly more often; the kernels against the plain
    versions), and at this width the q/k gradients of blocks 1-3, near
    1e-7 with attention near uniform, carry about 10% of bf16 noise on
    either device (PERF.md, section 6).  Returns the card's arrays."""
    card = one_step(dev, params, "bfloat16", "7b")
    cpu = one_step(torch.device("cpu"), params, "bfloat16", "7b")
    cpu32 = one_step(torch.device("cpu"), params, phase="7b")
    hold_bf16("7b", "bf16 training step card vs CPU", card, cpu, cpu32)
    return card


def phase_train_vs_cpu(dev):
    """One training step from the same parameters and batch on the card
    and on the CPU (the plain versions): probabilities and every
    gradient within 1e-3 x max|ref|; returns the parameters and the
    card's arrays."""
    params = step_params()
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
    return params, card


def xavier_params():
    """Phase 6's start as numpy: ``mx.random.seed(0)``, then Xavier over
    the symbol's parameters in the order ``Module.init_params`` draws
    them."""
    net = train_symbol()
    shapes, _, _ = net.infer_shape(data=(TRAIN_BATCH, TRAIN_SEQ),
                                   softmax_label=(TRAIN_BATCH, TRAIN_SEQ))
    attrs = net.attr_dict()
    init = mx.init.Xavier()
    mx.random.seed(0)
    out = {}
    for name, shape in zip(net.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        arr = mx.nd.zeros(shape, ctx=mx.cpu())
        init(mx.init.InitDesc(name, attrs.get(name)), arr)
        out[name] = arr.asnumpy()
    return out


def imperative_step(w, mom, X, y, compute_dtype=None):
    """One imperative training step as a user writes it: the forward of
    ``transformer_lm.imperative_loss`` under ``autograd.record()`` (with
    ``compute_dtype``: every weight through ``mx.nd.Cast`` first), the
    backward, then ``sgd_mom_update`` into every weight (``mom`` None:
    no update).  Returns the summed loss NDArray."""
    data, label = mx.nd.array(X), mx.nd.array(y)
    with mx.autograd.record():
        loss = tlm.imperative_loss(mx.nd, w, data, label, TRAIN_SEQ, SPEC,
                                   compute_dtype=compute_dtype)
    loss.backward()
    if mom is not None:
        for k in w:
            mx.nd.sgd_mom_update(
                w[k], w[k].grad, mom[k], lr=TRAIN_OPT["learning_rate"],
                momentum=TRAIN_OPT["momentum"],
                rescale_grad=1.0 / TRAIN_BATCH, out=w[k])
    return loss


def phase_imperative(card, step_ms_module, compute_dtype=None,
                     step_ms_fp32=None):
    """Phase 6's training written imperatively on ``cuda:0`` (the
    default context): the same data and Xavier start, SGD momentum 0.9
    at lr 0.005 with rescale_grad 1/batch, for TRAIN_STEPS steps.  The
    summed cross-entropy has SoftmaxOutput's gradient, so the two runs
    take the same steps.  ``compute_dtype='bfloat16'`` is phase 8b: the
    weights through ``mx.nd.Cast`` inside ``record()``, the bf16 launch
    table, no wrapper's plain version reached, and float32 weights,
    gradients and momenta after the run; its times beside phase 8's
    (``step_ms_fp32``) and phase 6b's (``step_ms_module``).  Returns the
    run's launch counts and its ms per step."""
    tag = "8b" if compute_dtype else "8"
    table = (IMPERATIVE_BF16_LAUNCHES_PER_STEP if compute_dtype
             else IMPERATIVE_LAUNCHES_PER_STEP)
    X, y = train_data(TRAIN_STEPS * TRAIN_BATCH)
    params = xavier_params()
    w = {k: mx.nd.array(v) for k, v in params.items()}
    mom = {k: mx.nd.zeros(v.shape) for k, v in params.items()}
    for v in w.values():
        v.attach_grad()
    losses, steps, clock = [], [], {}
    kernels.reset_launch_counts()
    last = kernels.launch_counts()
    tic = time.perf_counter()
    with plain_guard() as plain, fa_census() as fa_shapes, \
            nb_census() as nb_shapes:
        for i in range(TRAIN_STEPS):
            lo = i * TRAIN_BATCH
            loss = imperative_step(w, mom, X[lo:lo + TRAIN_BATCH],
                                   y[lo:lo + TRAIN_BATCH], compute_dtype)
            losses.append(float(loss.asscalar()) / TRAIN_ROWS)   # syncs
            now = kernels.launch_counts()
            steps.append({k: now[k] - last[k] for k in now})
            last = now
            if i in (TRAIN_WARMUP - 1, TRAIN_STEPS - 1):
                torch.cuda.synchronize()
                clock[i] = time.perf_counter()
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - tic
    check_fa_census(tag, fa_shapes, counts)
    check_nb_census(tag, nb_shapes, counts)
    if plain:
        raise SystemExit("chip_smoke: phase %s reached plain versions: %s"
                         % (tag, dict(plain)))
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(table)
    for i, got in enumerate(steps):
        if got != want:
            raise SystemExit("chip_smoke: phase %s imperative step %d "
                             "launched %s, want %s" % (tag, i, got, want))
    if not all(np.isfinite(losses)):
        raise SystemExit("chip_smoke: imperative training gave a "
                         "non-finite loss (phase %s)" % tag)
    if compute_dtype:
        if loss._data.dtype != torch.bfloat16:
            raise SystemExit("chip_smoke: phase 8b loss is %s"
                             % loss._data.dtype)
        arrays = {"weight " + k: v._data for k, v in w.items()}
        arrays.update(("gradient " + k, v.grad._data) for k, v in w.items())
        arrays.update(("momentum " + k, v._data) for k, v in mom.items())
        wrong = {k: t.dtype for k, t in arrays.items()
                 if t.dtype != torch.float32}
        if wrong:
            raise SystemExit("chip_smoke: phase 8b master arrays not "
                             "float32: %s" % wrong)
        log("phase 8b: loss bf16; %d weights, gradients and momenta float32"
            % len(arrays))
    log("phase %s mean loss per token per step: %s"
        % (tag, " ".join("%.3f" % v for v in losses)))
    first, final = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not final < first:
        raise SystemExit("chip_smoke: imperative loss did not fall (phase "
                         "%s): first 5 steps %.4f, last 5 %.4f"
                         % (tag, first, final))
    timed = TRAIN_STEPS - TRAIN_WARMUP
    sec = clock[TRAIN_STEPS - 1] - clock[TRAIN_WARMUP - 1]
    step_ms = sec * 1e3 / timed
    beside = "; phase %s (Module.fit%s) %.3f ms per step, %.1f samples/s" % (
        "6b" if compute_dtype else "6", " bf16" if compute_dtype else "",
        step_ms_module, TRAIN_BATCH * 1e3 / step_ms_module)
    if step_ms_fp32 is not None:
        beside += ("; phase 8 (fp32) %.3f ms per step, %.1f samples/s; "
                   "ratio %.3f" % (step_ms_fp32, TRAIN_BATCH * 1e3
                                   / step_ms_fp32, step_ms / step_ms_fp32))
    log("phase %s trained %d imperative steps%s (%.2f s): mean loss per "
        "token first 5 steps %.4f (perplexity %.1f), last 5 %.4f (%.1f); "
        "launches per step %s; steps %d..%d: %.3f ms per step, %.1f "
        "samples/s%s [%s]"
        % (tag, TRAIN_STEPS, " in %s" % compute_dtype if compute_dtype
           else "", wall, first, np.exp(first), final, np.exp(final), table,
           TRAIN_WARMUP + 1, TRAIN_STEPS, step_ms, timed * TRAIN_BATCH / sec,
           beside, card))
    return counts, step_ms


def imperative_grads(ctx, params, compute_dtype=None):
    """Loss and every gradient of one imperative step from ``params`` on
    ``ctx``, as numpy arrays by name (a bf16 loss widened to float32,
    the gradients float32 in either dtype)."""
    X, y = train_data(TRAIN_BATCH)
    tic = time.perf_counter()
    with ctx:
        w = {k: mx.nd.array(v) for k, v in params.items()}
        for v in w.values():
            v.attach_grad()
        loss = imperative_step(w, None, X, y, compute_dtype)
        dtypes = {v.grad._data.dtype for v in w.values()}
        if dtypes != {torch.float32}:
            raise SystemExit("chip_smoke: a %s imperative step gave %s "
                             "gradients" % (compute_dtype or "float32",
                                            dtypes))
        out = {"loss": loss.asnumpy()}
        out.update((k, v.grad.asnumpy()) for k, v in w.items())
    log("phase %s one imperative %s step on %s: %.2f s"
        % ("9b" if compute_dtype else "9", compute_dtype or "float32", ctx,
           time.perf_counter() - tic))
    return out


def worst_rel(tag, got, want):
    """Fatal past 1e-3 x max|ref| for any entry; logs the worst."""
    worst, worst_name = 0.0, None
    for name, ref in want.items():
        g = got[name]
        if not np.isfinite(g).all():
            raise SystemExit("chip_smoke: %s is not finite (%s)" % (name, tag))
        rel = float(np.abs(g - ref).max() / max(np.abs(ref).max(), 1e-30))
        if rel > worst:
            worst, worst_name = rel, name
        if not rel <= 1e-3:
            raise SystemExit("chip_smoke: %s differs (%s): %.3e x max|ref|"
                             % (name, tag, rel))
    log("phase 9 %s: %d arrays agree; worst %s at %.3e x max|ref| (tol "
        "1e-3)" % (tag, len(want), worst_name, worst))


def phase_imperative_vs(params, module_card):
    """Phase 9: one imperative step from phase 7's parameters on the
    card against the CPU, and its gradients against phase 7's Module
    step on the card (``module_card``): the imperative plane against
    the symbolic one.  Returns the CPU's arrays."""
    card = imperative_grads(mx.gpu(0), params)
    cpu = imperative_grads(mx.cpu(), params)
    worst_rel("imperative step card vs CPU", card, cpu)
    worst_rel("imperative vs Module gradients on the card",
              {k: v for k, v in card.items() if k != "loss"},
              {k: v for k, v in module_card.items()
               if k != "probabilities"})
    return cpu


def phase_imperative_bf16_vs(params, module_card_bf16, cpu32):
    """Phase 9b: one imperative bf16 step (every weight through
    ``mx.nd.Cast``) from phase 7's parameters on the card against the
    CPU, and its gradients against phase 7b's ``Module`` bf16 step on
    the card (``module_card_bf16``), each array under ``hold_bf16``'s
    bounds with phase 9's CPU fp32 step (``cpu32``) as the fp32 side.
    The Module's head rounds p to bf16 before ``p - onehot``; the
    imperative gradient rounds once after, so the two planes agree to
    bf16's bounds, not to phase 9's 1e-3."""
    card = imperative_grads(mx.gpu(0), params, "bfloat16")
    cpu = imperative_grads(mx.cpu(), params, "bfloat16")
    hold_bf16("9b", "imperative bf16 step card vs CPU", card, cpu, cpu32)
    hold_bf16("9b", "imperative vs Module bf16 gradients on the card",
              {k: v for k, v in card.items() if k != "loss"},
              {k: v for k, v in module_card_bf16.items()
               if k != "probabilities"}, cpu32)


# ---------------------------------------------------------------------------
# phase 10: the op library on the card against the CPU
# ---------------------------------------------------------------------------
SWEEP_EXACT, SWEEP_REL, SWEEP_BF16 = 0.0, 1e-5, 2.0 ** -8
SWEEP_ARITH = ("elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
               "_plus", "_add", "_minus", "_sub", "_mul", "_div", "_grad_add",
               "_maximum", "_minimum")
SWEEP_COMPARE = ("equal", "not_equal", "greater", "greater_equal", "lesser",
                 "lesser_equal")
SWEEP_SCALAR = ("plus", "minus", "rminus", "mul", "div", "rdiv", "maximum",
                "minimum", "power", "rpower", "mod", "rmod", "hypot")


def sweep_inputs():
    """The sweep's inputs, torch CPU tensors from seed 10: the
    elementwise shape 4096 x 512 in each domain the ops need, and the
    other ops' operands at the sizes a model gives them."""
    rs = np.random.RandomState(10)
    E = (4096, 512)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    def signed(shape, lo, hi):
        return rs.choice([-1.0, 1.0], shape) * rs.uniform(lo, hi, shape)

    # indices in range, past the end, negative (in [-n, 0) and below),
    # fractional
    edge = [4096, 9000, -1, -4096, -4097, 5.5, 4095.9, -0.5]
    return {
        "f": f32(rs.randn(*E)), "f2": f32(rs.randn(*E)),
        "pos": f32(rs.uniform(0.5, 3.0, E)),
        "unit": f32(rs.uniform(-0.9, 0.9, E)),
        "gt1": f32(rs.uniform(1.1, 3.0, E)), "nz": f32(signed(E, 0.25, 2.0)),
        "quarter": f32(rs.randint(-20, 21, E) / 4.0),
        "negfrac": f32(-(rs.randint(0, 4, E) + rs.uniform(0.1, 0.9, E))),
        "ties": f32(rs.randint(-2, 3, E) / 2.0),
        "ties_row": f32(rs.randint(-2, 3, (1, E[1])) / 2.0),
        "row": f32(signed((1, E[1]), 0.25, 2.0)),
        "col": f32(rs.randn(E[0], 1)),
        "i": i32(rs.randint(-9, 10, E)),
        "inz": i32(rs.choice([-1, 1], E) * rs.randint(1, 6, E)),
        # integer powers with negative exponents: trunc of the real power
        "ibase": i32(rs.choice([-3, -1, 1, 2, 3], E)),
        "iexp": i32(rs.randint(-4, 4, E)),
        "m1": f32(rs.randn(1024, 1024)), "m2": f32(rs.randn(1024, 1024)),
        "b1": f32(rs.randn(16, 256, 64)), "b2": f32(rs.randn(16, 64, 256)),
        "img": f32(rs.randn(16, 32, 64, 64)),
        "ids": f32(np.concatenate([rs.randint(0, 4096, 8192 - len(edge)),
                                   edge])),
        "row_ids": f32(np.concatenate([rs.randint(0, 512, 4088),
                                       [512, 600, -1, -512, -513, 7.5, 0,
                                        511]])),
        "class_ids": f32(rs.randint(0, 1000, 4096)),
        "sort_ties": f32(rs.randint(-3, 4, (64, 8192)) / 2.0),
        "seq": f32(rs.randn(64, 256, 128)),
        "seq_len": f32(np.concatenate([[1, 64, 63.5, 0.5],
                                       rs.randint(1, 65, 252)])),
        "logits": f32(rs.randn(4096, 1000)),
    }


def sweep_cases():
    """(family, op, input names, attrs, tolerance, bf16 inputs?) for every
    op the op-library slice added, at realistic sizes, with the edge
    inputs: indices out of range and negative, rows full of ties, integer
    powers with negative exponents, gamma of negative non-integers."""
    R, X, B = SWEEP_REL, SWEEP_EXACT, SWEEP_BF16
    cases = []
    unary = {"softsign": "f", "sign": "nz", "round": "quarter",
             "rint": "quarter", "ceil": "quarter", "floor": "quarter",
             "trunc": "quarter", "fix": "quarter", "rsqrt": "pos",
             "cbrt": "nz", "rcbrt": "nz", "log10": "pos", "log2": "pos",
             "log1p": "pos", "expm1": "f", "tan": "unit", "arcsin": "unit",
             "arccos": "unit", "arctan": "f", "sinh": "f", "cosh": "f",
             "arcsinh": "f", "arccosh": "gt1", "arctanh": "unit",
             "degrees": "f", "radians": "f", "gamma": "negfrac",
             "gammaln": "pos", "erf": "f", "_copy": "f", "identity": "f"}
    exact = {"sign", "round", "rint", "ceil", "floor", "trunc", "fix",
             "_copy", "identity"}
    for op, d in unary.items():
        cases.append(("unary", op, [d], {}, X if op in exact else R, False))
    cases.append(("unary", "gamma", ["pos"], {}, R, False))
    cases.append(("unary", "smooth_l1", ["f"], {"scalar": 2.0}, R, False))
    for op in SWEEP_ARITH:
        cases.append(("binary", op, ["f", "nz"], {}, X, False))
        if op.startswith("elemwise"):
            cases.append(("binary bf16", op, ["f", "nz"], {}, B, True))
            cases.append(("binary int32", op, ["i", "inz"], {}, X, False))
    cases += [("binary", "_power", ["pos", "f"], {}, R, False),
              ("binary", "_hypot", ["f", "f2"], {}, R, False),
              ("binary", "_mod", ["f", "nz"], {}, R, False),
              ("binary int32", "_power", ["ibase", "iexp"], {}, X, False),
              ("binary int32", "_mod", ["i", "inz"], {}, X, False),
              ("binary bf16", "_power", ["pos", "f"], {}, B, True)]
    for op in ("add", "plus", "sub", "minus", "mul", "div", "maximum",
               "minimum", "power", "hypot", "mod"):
        lhs = "pos" if op == "power" else "f"
        tol = R if op in ("power", "hypot", "mod") else X
        cases.append(("broadcast", "broadcast_" + op, [lhs, "row"], {}, tol,
                      False))
        cases.append(("broadcast", "broadcast_" + op, ["col", "row"], {},
                      tol, False))
        cases.append(("broadcast bf16", "broadcast_" + op, [lhs, "row"], {},
                      B, True))
    for op in SWEEP_COMPARE:
        cases.append(("compare", "broadcast_" + op, ["ties", "ties_row"], {},
                      X, False))
        cases.append(("compare", "_" + op, ["ties", "f2"], {}, X, False))
        cases.append(("compare bf16", "broadcast_" + op, ["ties", "ties_row"],
                      {}, B, True))
        cases.append(("compare", "_%s_scalar" % op, ["ties"],
                      {"scalar": 0.5}, X, False))
        cases.append(("compare int32", "_%s_scalar" % op, ["i"],
                      {"scalar": 2.7}, X, False))
    for op in SWEEP_SCALAR:
        name = "_%s_scalar" % op
        d = {"power": "pos", "rdiv": "nz", "rmod": "nz"}.get(op, "f")
        tol = R if op in ("power", "rpower", "mod", "rmod", "hypot") else X
        cases.append(("scalar", name, [d], {"scalar": 1.5}, tol, False))
        cases.append(("scalar int32", name,
                      ["inz" if op in ("rdiv", "rmod", "power") else "i"],
                      {"scalar": 2.7}, R if op == "hypot" else X, False))
    cases.append(("scalar bf16", "_mul_scalar", ["nz"], {"scalar": 1.5}, B,
                  True))
    for op in ("add_n", "ElementWiseSum", "_sum"):
        cases.append(("binary", op, ["f", "nz", "pos"], {}, X, False))
    cases += [
        ("dot", "dot", ["m1", "m2"], {}, R, False),
        ("dot", "dot", ["m1", "m2"], {"transpose_a": True,
                                      "transpose_b": True}, R, False),
        ("dot", "batch_dot", ["b1", "b2"], {}, R, False),
        ("dot", "batch_dot", ["b2", "b1"], {"transpose_a": True,
                                            "transpose_b": True}, R, False),
        ("shape", "Concat", ["f", "nz", "pos"], {"dim": 1}, X, False),
        ("shape", "concat", ["f", "nz"], {"dim": 0}, X, False),
        ("shape", "Flatten", ["b1"], {}, X, False),
        ("shape", "flatten", ["img"], {}, X, False),
        ("shape", "expand_dims", ["f"], {"axis": 1}, X, False),
        ("shape", "SwapAxis", ["b1"], {"dim1": 0, "dim2": 2}, X, False),
        ("shape", "swapaxes", ["img"], {"dim1": 1, "dim2": 3}, X, False),
        ("shape", "slice", ["f"], {"begin": (7, -300), "end": (4000, -1)}, X,
         False),
        ("shape", "crop", ["img"], {"begin": (0, 3, 5), "end": (8, 30, 60)},
         X, False),
        ("shape", "slice_axis", ["f"], {"axis": 1, "begin": -200,
                                        "end": None}, X, False),
        ("shape", "clip", ["f"], {"a_min": -0.5, "a_max": 0.7}, X, False),
        ("shape", "repeat", ["b1"], {"repeats": 2, "axis": 1}, X, False),
        ("shape", "tile", ["b1"], {"reps": (1, 2, 3)}, X, False),
        ("shape", "reverse", ["img"], {"axis": (1, 3)}, X, False),
        ("shape", "flip", ["f"], {"axis": 0}, X, False),
        ("shape", "where", ["ties", "f", "nz"], {}, X, False),
        ("shape", "SliceChannel", ["f"], {"num_outputs": 4}, X, False),
        ("shape", "split", ["img"], {"num_outputs": 2, "axis": 1}, X, False),
        ("shape", "Pad", ["img"], {"pad_width": (0, 0, 0, 0, 2, 3, 1, 4),
                                   "constant_value": 0.5}, X, False),
        ("shape", "pad", ["img"], {"mode": "edge",
                                   "pad_width": (0, 0, 0, 0, 2, 3, 1, 4)}, X,
         False),
        ("shape", "Pad", ["img"], {"mode": "reflect",
                                   "pad_width": (0, 0, 0, 0, 3, 2, 4, 1)}, X,
         False),
        ("reduce", "norm", ["f"], {}, R, False),
        ("reduce", "broadcast_to", ["row"], {"shape": (4096, 0)}, X, False),
        ("reduce", "broadcast_axis", ["col"], {"axis": (1,), "size": (512,)},
         X, False),
        ("reduce", "broadcast_axes", ["row"], {"axis": 0, "size": 4096}, X,
         False),
        ("reduce", "argmax_channel", ["ties"], {}, X, False),
        ("index", "take", ["f", "ids"], {}, X, False),
        ("index", "take", ["f", "ids"], {"mode": "wrap"}, X, False),
        ("index", "take", ["f", "ids"], {"mode": "raise"}, X, False),
        ("index", "take", ["f", "row_ids"], {"axis": 1}, X, False),
        ("index", "batch_take", ["f", "row_ids"], {}, X, False),
        ("index", "one_hot", ["ids"], {"depth": 4096}, X, False),
        ("index", "pick", ["f", "row_ids"], {}, X, False),
        ("index", "pick", ["f", "row_ids"], {"mode": "wrap",
                                             "keepdims": True}, X, False),
        ("order", "sort", ["sort_ties"], {}, X, False),
        ("order", "sort", ["sort_ties"], {"is_ascend": False}, X, False),
        ("order", "argsort", ["sort_ties"], {}, X, False),
        ("order", "argsort", ["sort_ties"], {"is_ascend": False}, X, False),
        ("order", "argsort", ["sort_ties"], {"axis": 0}, X, False),
        ("order", "topk", ["sort_ties"], {"k": 64}, X, False),
        ("order", "topk", ["sort_ties"], {"k": 64, "is_ascend": True}, X,
         False),
        ("order", "topk", ["sort_ties"], {"k": 10, "ret_typ": "value"}, X,
         False),
        ("order", "topk", ["sort_ties"], {"k": 10, "ret_typ": "both"}, X,
         False),
        ("order", "topk", ["sort_ties"], {"k": 10, "ret_typ": "mask"}, X,
         False),
        ("order", "topk", ["sort_ties"], {"k": 100, "axis": None}, X, False),
        ("init", "_zeros", [], {"shape": (4096, 512)}, X, False),
        ("init", "_ones", [], {"shape": (4096, 512), "dtype": "int32"}, X,
         False),
        ("init", "_arange", [], {"start": -3.0, "stop": 4093.0, "step": 0.5,
                                 "repeat": 2}, X, False),
        ("init", "zeros_like", ["f"], {}, X, False),
        ("init", "ones_like", ["i"], {}, X, False),
        ("sequence", "SequenceLast", ["seq"], {}, X, False),
        ("sequence", "SequenceLast", ["seq", "seq_len"],
         {"use_sequence_length": True}, X, False),
        ("sequence", "SequenceMask", ["seq", "seq_len"],
         {"use_sequence_length": True, "value": -1.5}, X, False),
        ("sequence", "SequenceReverse", ["seq"], {}, X, False),
        ("sequence", "SequenceReverse", ["seq", "seq_len"],
         {"use_sequence_length": True}, X, False),
        ("heads", "LinearRegressionOutput", ["f", "f2"], {}, X, False),
        ("heads", "LogisticRegressionOutput", ["f", "f2"], {}, R, False),
        ("heads", "MAERegressionOutput", ["f", "f2"], {}, X, False),
        ("heads", "SVMOutput", ["logits", "class_ids"], {"margin": 0.5}, X,
         False),
        ("heads", "IdentityAttachKLSparseReg", ["f"], {}, X, False),
    ]
    return cases


def sweep_run(op, tensors, attrs, dev):
    """``mx.nd.<op>`` on ``tensors`` moved to ``dev``, under ``dev``'s
    context (the init ops take it); synchronised after a card's call, so
    a device-side assert is reported at the op that raised it."""
    with mx.cpu() if dev.type == "cpu" else mx.gpu(dev.index or 0):
        out = getattr(mx.nd, op)(*[mx.nd.NDArray(t.to(dev)) for t in tensors],
                                 **attrs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    outs = out if isinstance(out, list) else [out]
    on_device(dev, "phase 10 %s's result" % op,
              [(i, o._data) for i, o in enumerate(outs)])
    return [o._data for o in outs]


def sweep_agree(op, got, want, tol):
    """The card's outputs against the CPU's: dtype and shape equal, bit
    for bit (``tol`` 0), else within ``tol`` x max|ref| with NaN where the
    CPU has NaN; returns the error's ratio to its bound (0 where
    bit-equal)."""
    worst = 0.0
    for g, w in zip(got, want):
        g = g.detach().cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            raise SystemExit("chip_smoke: phase 10 %s: card %s %s, CPU %s %s"
                             % (op, g.dtype, tuple(g.shape), w.dtype,
                                tuple(w.shape)))
        g, w = g.double(), w.double()
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise SystemExit("chip_smoke: phase 10 %s: NaN at other places"
                             % op)
        ok = ~torch.isnan(w)
        g, w = g[ok], w[ok]
        if tol == SWEEP_EXACT or not w.numel():
            if not torch.equal(g, w):
                raise SystemExit("chip_smoke: phase 10 %s is not bit-equal: "
                                 "%d elements differ"
                                 % (op, int((g != w).sum())))
            continue
        bound = tol * max(float(w.abs().max()), 1e-30)
        err = float((g - w).abs().max())
        if not err <= bound:
            raise SystemExit("chip_smoke: phase 10 %s: %.3e past its bound "
                             "%.3e" % (op, err, bound))
        worst = max(worst, err / bound)
    return worst


def phase_op_sweep(dev, card):
    """Phase 10: every op of the op-library slice on the card and on the
    CPU on the same inputs: bit-equal integer, bool, index and ordering
    results and IEEE-exact arithmetic, the rest within the CPU tests'
    bounds; the worst ratio to its bound for each family."""
    tic = time.perf_counter()
    x = sweep_inputs()
    cases = sweep_cases()
    worst, ops = collections.defaultdict(float), set()
    for family, op, names, attrs, tol, bf16 in cases:
        ins = [x[n].to(torch.bfloat16) if bf16 else x[n] for n in names]
        want = sweep_run(op, ins, attrs, torch.device("cpu"))
        got = sweep_run(op, ins, attrs, dev)
        worst[family] = max(worst[family], sweep_agree(op, got, want, tol))
        ops.add(op)
    missing = set(SWEEP_OPS) - ops
    if missing:
        raise SystemExit("chip_smoke: phase 10 did not run %s"
                         % sorted(missing))
    log("phase 10 op sweep: %d cases over %d ops, card vs CPU, in %.1f s; "
        "worst ratio to its bound by family (0: bit-equal): %s [%s]"
        % (len(cases), len(ops), time.perf_counter() - tic,
           ", ".join("%s %.3f" % kv for kv in sorted(worst.items())), card))


# ---------------------------------------------------------------------------
# phases 11 and 12: the matrix-factorization recommender through
# Module.fit (examples/recommenders/matrix_fact.py at MovieLens-1M's
# id space)
# ---------------------------------------------------------------------------
def make_ratings(rs, num_users, num_items, n, rank):
    """``examples/recommenders/matrix_fact.py``'s synthetic ratings: a
    rank-``rank`` ground truth plus noise."""
    U = rs.randn(num_users, rank).astype(np.float32) / np.sqrt(rank)
    V = rs.randn(num_items, rank).astype(np.float32) / np.sqrt(rank)
    users = rs.randint(0, num_users, n)
    items = rs.randint(0, num_items, n)
    r = (U[users] * V[items]).sum(axis=1) + 0.05 * rs.randn(n)
    return (users.astype(np.float32), items.astype(np.float32),
            r.astype(np.float32))


def mf_symbol(num_users, num_items, factor):
    """The example's graph: two ``Embedding``s, ``*``, ``sum(axis=1)``,
    ``LinearRegressionOutput``."""
    user = mx.sym.Variable("user")
    item = mx.sym.Variable("item")
    u = mx.sym.Embedding(user, input_dim=num_users, output_dim=factor,
                         name="user_embed")
    v = mx.sym.Embedding(item, input_dim=num_items, output_dim=factor,
                         name="item_embed")
    pred = mx.sym.sum(u * v, axis=1)
    return mx.sym.LinearRegressionOutput(pred, name="score")


def mf_data():
    """The ratings at MovieLens-1M's size, split 90/10 as the example
    splits them, and the rating std."""
    rs = np.random.RandomState(11)
    users, items, r = make_ratings(rs, MF["users"], MF["items"],
                                   MF["ratings"], MF["rank"])
    n = int(0.9 * MF["ratings"])
    return ((users[:n], items[:n], r[:n]), (users[n:], items[n:], r[n:]),
            float(r.std()))


def mf_iter(part, dev, shuffle=False):
    """An ``NDArrayIter`` over ``part`` held on ``dev``: its batches are
    gathered there."""
    users, items, r = (mx.nd.array(a, ctx=dev) for a in part)
    return mx.io.NDArrayIter({"user": users, "item": items}, r,
                             batch_size=MF["batch"], shuffle=shuffle,
                             label_name="score_label")


def mf_module(dev):
    return mx.Module(mf_symbol(MF["users"], MF["items"], MF["factor"]),
                     data_names=("user", "item"),
                     label_names=("score_label",), context=dev)


def on_device(dev, what, tensors):
    """Fatal unless every (name, tensor) lies on ``dev``'s device type."""
    off = [n for n, t in tensors if t.device.type != dev.type]
    if off:
        raise SystemExit("chip_smoke: %s not on %s: %s" % (what, dev, off))


def phase_recommender(dev, card):
    """Phase 11: the recommender through ``Module.fit`` (Adam, learning
    rate 0.01, wd 1e-5, Normal(0.1), ``eval_metric='rmse'``) for
    ``MF_EPOCHS`` epochs with the parameters, the executor's arrays, the
    optimizer's state and the iterator's batches on the card; the
    held-out RMSE after each epoch, steps/s, samples/s and ms per step;
    the RMSE falling each epoch and ending below the rating std (three
    epochs, the most this phase's time allows, reach about 0.6 x the std
    in the CPU rehearsal, not the 0.5 x that the example's twelve
    reach at its size).
    No hand kernel lies on this path: every launch count stays 0, and no
    wrapper's plain version is reached.  Returns the launch counts and
    the ms per step."""
    train_part, val_part, std = mf_data()
    train = mf_iter(train_part, dev, shuffle=True)
    val = mf_iter(val_part, dev)
    mx.random.seed(0)
    mod = mf_module(dev)
    rmse, marks = [], {}

    def on_batch(param):
        if param.nbatch == 0:
            if param.epoch == 0:
                batch = param.locals["data_batch"]
                on_device(dev, "phase 11 batch", [
                    (d.name, a._data) for d, a in zip(
                        train.provide_data + train.provide_label,
                        batch.data + batch.label)])
            torch.cuda.synchronize()
            marks[param.epoch] = [time.perf_counter(), 0]
        marks[param.epoch][1] = param.nbatch

    def on_epoch(epoch, *_):
        torch.cuda.synchronize()
        start, last = marks[epoch]
        marks[epoch].append(time.perf_counter())
        sec = marks[epoch][2] - start
        rmse.append(dict(mod.score(val, mx.metric.RMSE()))["rmse"])
        log("phase 11 epoch %d: held-out RMSE %.6f (rating std %.6f); "
            "steps 2..%d: %.3f ms per step, %.1f steps/s, %.0f samples/s "
            "[%s]" % (epoch, rmse[-1], std, last + 1, sec * 1e3 / last,
                      last / sec, last * MF["batch"] / sec, card))

    kernels.reset_launch_counts()
    tic = time.perf_counter()
    with plain_guard() as plain:
        mod.fit(train, num_epoch=MF_EPOCHS, optimizer="adam",
                optimizer_params={"learning_rate": MF["lr"], "wd": MF["wd"]},
                initializer=mx.init.Normal(sigma=MF["sigma"]),
                eval_metric="rmse", kvstore="local",
                batch_end_callback=on_batch, epoch_end_callback=on_epoch)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - tic
    ex = mod._exec_group.executor
    on_device(dev, "phase 11 executor arrays and optimizer state",
              list(zip(ex._arg_names, (a._data for a in ex.arg_arrays))) +
              [(n, g._data) for n, g in ex.grad_dict.items()] +
              [("adam state of %d" % i, s._data)
               for i, st in mod._updater.states.items() for s in st])
    if plain:
        raise SystemExit("chip_smoke: phase 11 reached plain versions: %s"
                         % dict(plain))
    if any(counts.values()):
        raise SystemExit("chip_smoke: phase 11 launched hand kernels off its "
                         "path: %s" % {k: v for k, v in counts.items() if v})
    if len(rmse) != MF_EPOCHS or not np.isfinite(rmse).all():
        raise SystemExit("chip_smoke: phase 11 RMSE per epoch %s" % rmse)
    if any(b >= a for a, b in zip(rmse, rmse[1:])):
        raise SystemExit("chip_smoke: phase 11 held-out RMSE did not fall "
                         "each epoch: %s" % rmse)
    if not rmse[-1] < std:
        raise SystemExit("chip_smoke: phase 11 held-out RMSE %.6f is not "
                         "below the rating std, %.6f" % (rmse[-1], std))
    steps = sum(m[1] for m in marks.values())
    sec = sum(m[2] - m[0] for m in marks.values())
    log("phase 11 recommender (%d users, %d items, factor %d, %d ratings, "
        "batch %d): %d epochs in %.1f s with bind, init and scoring; "
        "held-out RMSE %s, final %.6f < %.6f, the rating std (%.3f x it; "
        "the example's 12 epochs are held to 0.5 x); %.3f ms "
        "per step, %.1f steps/s, %.0f samples/s (host clock behind "
        "synchronize, each epoch's first step left out) [%s]"
        % (MF["users"], MF["items"], MF["factor"], MF["ratings"],
           MF["batch"], MF_EPOCHS, wall, " ".join("%.6f" % v for v in rmse),
           rmse[-1], std, rmse[-1] / std, sec * 1e3 / steps, steps / sec,
           steps * MF["batch"] / sec, card))
    return counts, sec * 1e3 / steps


def profile_recommender(dev, card, step_ms, warmup=20, steps=100):
    """``--profile``: ``torch.profiler`` over ``steps`` recommender steps
    of ``Module.fit`` after ``warmup`` (phase 11's setup on the first
    rows of its training split): the device's busy share of phase 11's
    unprofiled ``step_ms``."""
    (users, items, r), _, _ = mf_data()
    n = (warmup + steps) * MF["batch"]
    it = mf_iter((users[:n], items[:n], r[:n]), dev)
    mx.random.seed(0)
    mod = mf_module(dev)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    clock = {}

    def on_batch(param):
        if param.nbatch in (warmup - 1, warmup + steps - 1):
            torch.cuda.synchronize()
            clock[param.nbatch] = time.perf_counter()
            (prof.start if param.nbatch == warmup - 1 else prof.stop)()

    mod.fit(it, num_epoch=1, optimizer="adam",
            optimizer_params={"learning_rate": MF["lr"], "wd": MF["wd"]},
            initializer=mx.init.Normal(sigma=MF["sigma"]),
            eval_metric="rmse", batch_end_callback=on_batch)
    window_ms = (clock[warmup + steps - 1] - clock[warmup - 1]) * 1e3 / steps
    report_profile("11", prof, steps, step_ms, window_ms, card)


def mf_step(dev, params, part):
    """One recommender step (``forward_backward`` + Adam ``update``) on
    ``dev`` from ``params`` on the batch ``part``: the gradients and the
    updated parameters, as numpy by name."""
    it = mf_iter(part, dev)
    mod = mf_module(dev)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=params)
    mod.init_optimizer(optimizer="adam", optimizer_params={
        "learning_rate": MF["lr"], "wd": MF["wd"]})
    mod.forward_backward(next(iter(it)))
    out = {"grad " + n: g.asnumpy() for n, g in
           mod._exec_group.executor.grad_dict.items() if n in params}
    mod.update()
    arg, _ = mod.get_params()
    out.update(("param " + n, v.asnumpy()) for n, v in arg.items())
    return out


def phase_recommender_vs_cpu(dev):
    """Phase 12: one recommender step on the card against the CPU's from
    the same Normal(0.1) parameters and batch: every gradient within
    1e-5 x max|ref|, every parameter after Adam within 1e-4 x max|ref|
    (Adam's standing bound: its step has the size of the learning rate
    whatever the gradient's)."""
    (users, items, r), _, _ = mf_data()
    b = MF["batch"]
    part = (users[:b], items[:b], r[:b])
    rs = np.random.RandomState(12)
    params = {name: (MF["sigma"] * rs.randn(rows, MF["factor"]))
              .astype(np.float32) for name, rows in (
                  ("user_embed_weight", MF["users"]),
                  ("item_embed_weight", MF["items"]))}
    card = mf_step(dev, params, part)
    cpu = mf_step(torch.device("cpu"), params, part)
    ratios = []
    for name, ref in sorted(cpu.items()):
        tol = 1e-4 if name.startswith("param") else 1e-5
        got = card[name]
        err = float(np.abs(got - ref).max())
        bound = tol * max(float(np.abs(ref).max()), 1e-30)
        if not (np.isfinite(got).all() and err <= bound):
            raise SystemExit("chip_smoke: phase 12 %s: card vs CPU %.3e past "
                             "%.3e" % (name, err, bound))
        ratios.append("%s %.3f of %g x max|ref|" % (name, err / bound, tol))
    log("phase 12 recommender step card vs CPU: %s" % "; ".join(ratios))


# ---------------------------------------------------------------------------
# phase 10, the layers and the samplers: every op name of the image
# classification slice, card against CPU at ResNet's sizes, and the
# samplers' moments over 10**6 draws on the card
# ---------------------------------------------------------------------------
LAYER_OPS = ("BatchNorm", "Convolution", "Convolution_v1", "Deconvolution",
             "Dropout", "InstanceNorm", "L2Normalization", "LRN", "LeakyReLU",
             "Pooling", "Pooling_v1", "UpSampling")
# sampler -> (its aliases, attributes, the distribution's mean, variance)
SAMPLERS = {
    "_sample_uniform": (("uniform", "_random_uniform", "random_uniform"),
                        {"low": -1.0, "high": 3.0}, 1.0, 16.0 / 12),
    "_sample_normal": (("normal", "_random_normal", "random_normal"),
                       {"loc": 1.0, "scale": 2.0}, 1.0, 4.0),
    "_sample_gamma": (("_random_gamma", "random_gamma"),
                      {"alpha": 2.5, "beta": 1.5}, 3.75, 2.5 * 1.5 ** 2),
    "_sample_exponential": (("_random_exponential", "random_exponential"),
                            {"lam": 2.0}, 0.5, 0.25),
    "_sample_poisson": (("_random_poisson", "random_poisson"),
                        {"lam": 3.5}, 3.5, 3.5),
    "_sample_negbinomial": (("_random_negbinomial",
                             "random_negative_binomial"),
                            {"k": 3.0, "p": 0.4}, 4.5, 3.0 * 0.6 / 0.16),
}
SAMPLE_N = 10 ** 6
DROP_P = 0.3


def layer_inputs():
    """The layer cases' inputs, torch CPU tensors from seed 10 at the
    sizes ResNet-50 gives these ops (batch 8): its stem, a stage-1 3 x 3
    convolution, a strided 1 x 1 shortcut, the last stage's global
    pool."""
    rs = np.random.RandomState(10)

    def f32(*shape, lo=None):
        a = rs.randn(*shape) if lo is None else rs.uniform(lo, 1.5, shape)
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return {
        "img": f32(8, 3, 224, 224), "stem_w": f32(64, 3, 7, 7) * 0.1,
        "a56": f32(8, 64, 56, 56), "w3": f32(64, 64, 3, 3) * 0.05,
        "a256": f32(8, 256, 56, 56), "w1": f32(512, 256, 1, 1) * 0.06,
        "b512": f32(512), "a28": f32(8, 128, 28, 28),
        "wg": f32(128, 4, 3, 3) * 0.2, "s1d": f32(8, 64, 1024),
        "w1d": f32(128, 64, 5) * 0.05, "v3d": f32(2, 16, 16, 32, 32),
        "w3d": f32(32, 16, 3, 3, 3) * 0.05, "d28": f32(8, 64, 28, 28),
        "wd": f32(64, 32, 3, 3) * 0.05, "wd4": f32(64, 32, 4, 4) * 0.05,
        "b32": f32(32), "d1d": f32(8, 32, 256), "wd1d": f32(32, 8, 4) * 0.1,
        "a112": f32(8, 64, 112, 112), "a55": f32(8, 64, 55, 55),
        "a28p": f32(8, 64, 28, 28), "a7": f32(8, 2048, 7, 7),
        "p1d": f32(8, 64, 1001), "g256": f32(256, lo=0.5),
        "c256": f32(256), "m256": f32(256) * 0.1, "v256": f32(256, lo=0.5),
        "g64": f32(64, lo=0.5), "c64": f32(64), "lrn": f32(8, 96, 55, 55),
        "u32": f32(8, 32, 28, 28),
    }


def layer_cases():
    """(op, input names, auxiliary-state names, attrs, train, tolerance)
    for every layer op name at ResNet's sizes, over the modes the CPU
    tests cover: max-pool results and nearest upsampling bit-equal, the
    rest within 1e-5 x max|ref| (BatchNorm's new moving statistics
    too)."""
    R, X = SWEEP_REL, SWEEP_EXACT
    k3 = {"kernel": (3, 3)}
    cases = [
        ("Convolution", ["img", "stem_w"], [],
         {"kernel": (7, 7), "num_filter": 64, "stride": (2, 2),
          "pad": (3, 3), "no_bias": True}, False, R),
        ("Convolution", ["a56", "w3"], [],
         dict(k3, num_filter=64, pad=(1, 1), no_bias=True), False, R),
        ("Convolution_v1", ["a256", "w1", "b512"], [],
         {"kernel": (1, 1), "num_filter": 512, "stride": (2, 2)}, False, R),
        ("Convolution", ["a28", "wg"], [],
         dict(k3, num_filter=128, num_group=32, dilate=(2, 2), pad=(2, 2),
              no_bias=True), False, R),
        ("Convolution", ["s1d", "w1d"], [],
         {"kernel": (5,), "num_filter": 128, "stride": (2,), "pad": (2,),
          "no_bias": True}, False, R),
        ("Convolution", ["v3d", "w3d"], [],
         {"kernel": (3, 3, 3), "num_filter": 32, "pad": (1, 1, 1),
          "no_bias": True}, False, R),
        ("Deconvolution", ["d28", "wd", "b32"], [],
         dict(k3, num_filter=32, stride=(2, 2), pad=(1, 1), adj=(1, 1)),
         False, R),
        # target 60 = 56 + adj 4, past the stride: the cropped route
        ("Deconvolution", ["d28", "wd4"], [],
         {"kernel": (4, 4), "num_filter": 32, "stride": (2, 2),
          "pad": (1, 1), "target_shape": (60, 60), "no_bias": True}, False,
         R),
        ("Deconvolution", ["d1d", "wd1d"], [],
         {"kernel": (4,), "num_filter": 16, "num_group": 2, "stride": (2,),
          "no_bias": True}, False, R),
        ("Pooling", ["a112"], [], dict(k3, stride=(2, 2), pad=(1, 1)),
         False, X),
        ("Pooling", ["a55"], [], dict(k3, stride=(2, 2), pad=(1, 1),
                                      pool_type="avg",
                                      pooling_convention="full"), False, R),
        ("Pooling", ["a55"], [], dict(k3, stride=(2, 2), pad=(1, 1),
                                      pooling_convention="full"), False, X),
        ("Pooling_v1", ["a28p"], [], dict(k3, stride=(2, 2), pad=(2, 2),
                                          pool_type="sum"), False, R),
        ("Pooling", ["a7"], [], {"kernel": (7, 7), "global_pool": True,
                                 "pool_type": "avg"}, False, R),
        ("Pooling", ["p1d"], [], {"kernel": (3,), "stride": (2,),
                                  "pooling_convention": "full"}, False, X),
        ("Pooling", ["v3d"], [], {"kernel": (2, 2, 2), "stride": (2, 2, 2),
                                  "pool_type": "avg"}, False, R),
        ("LeakyReLU", ["a56"], [], {"act_type": "leaky", "slope": 0.1},
         False, X),
        ("LeakyReLU", ["a56"], [], {"act_type": "elu", "slope": 0.3}, False,
         R),
        ("LeakyReLU", ["a56", "g64"], [], {"act_type": "prelu"}, False, X),
        ("LeakyReLU", ["a56"], [], {"act_type": "rrelu"}, False, X),
        ("LRN", ["lrn"], [], {"nsize": 5}, False, R),
        ("InstanceNorm", ["a56", "g64", "c64"], [], {}, False, R),
        ("UpSampling", ["d28", "u32"], [], {"scale": 2, "num_args": 2},
         False, X),
        ("Dropout", ["a56"], [], {"p": DROP_P}, False, X),
    ]
    for mode in ("instance", "channel", "spatial"):
        cases.append(("L2Normalization", ["a28"], [], {"mode": mode}, False,
                      R))
    for attrs, train in (({"fix_gamma": False}, True),
                         ({"fix_gamma": True, "eps": 2e-5}, True),
                         ({"fix_gamma": False, "output_mean_var": True},
                          True),
                         ({"fix_gamma": False, "use_global_stats": True},
                          True),
                         ({"fix_gamma": False}, False)):
        cases.append(("BatchNorm", ["a256", "g256", "c256"],
                      ["m256", "v256"], attrs, train, R))
    return cases


def layer_run(op, tensors, aux, attrs, train, dev):
    """``mx.nd.<op>`` on ``tensors`` and the auxiliary states ``aux``
    (copies) on ``dev``, in train mode or not: the outputs and then the
    auxiliary states after the call, synchronised on the card."""
    scope = mx.autograd.train_mode() if train else contextlib.nullcontext()
    with (mx.cpu() if dev.type == "cpu" else mx.gpu(dev.index or 0)), scope:
        auxs = [mx.nd.NDArray(t.to(dev).clone()) for t in aux]
        out = getattr(mx.nd, op)(*[mx.nd.NDArray(t.to(dev)) for t in tensors],
                                 *auxs, **attrs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    outs = (out if isinstance(out, list) else [out]) + auxs
    on_device(dev, "phase 10 %s's result" % op,
              [(i, o._data) for i, o in enumerate(outs)])
    return [o._data for o in outs]


def moments_ok(draws, mean, var):
    """The sample mean and variance of ``draws`` (float64) within six
    standard errors of ``mean`` and ``var``; returns the larger of the
    two distances in standard errors."""
    n = draws.numel()
    m = float(draws.mean())
    v = float(draws.var(unbiased=False))
    se_v = float((((draws - m) ** 4).mean() - v ** 2).clamp(min=0)) ** 0.5
    se_v /= n ** 0.5
    return max(abs(m - mean) / (var / n) ** 0.5, abs(v - var) / se_v)


def phase_layer_sweep(dev, card):
    """Phase 10's layer and sampler cases: every layer op card against
    CPU (bounds as ``layer_cases``), Dropout's rate, scale and identity
    outside training on the card, rrelu's slopes in training, and each of
    the 20 sampler names' moments over 10**6 draws on the card within six
    standard errors of the distribution's, reproducible from a seed."""
    tic = time.perf_counter()
    x = layer_inputs()
    worst, ops = collections.defaultdict(float), set()
    for op, names, aux, attrs, train, tol in layer_cases():
        ins, auxs = [x[n] for n in names], [x[n] for n in aux]
        want = layer_run(op, ins, auxs, attrs, train, torch.device("cpu"))
        got = layer_run(op, ins, auxs, attrs, train, dev)
        worst[op] = max(worst[op], sweep_agree(op, got, want, tol))
        ops.add(op)
    # training-mode draws on the card: Dropout's mask and scale, rrelu
    twos = torch.full((SAMPLE_N,), 2.0, device=dev)
    with mx.gpu(dev.index or 0), mx.autograd.train_mode():
        mx.random.seed(10)
        y = mx.nd.Dropout(mx.nd.NDArray(twos), p=DROP_P)._data
        mx.random.seed(10)
        y2 = mx.nd.Dropout(mx.nd.NDArray(twos), p=DROP_P)._data
        slope = -mx.nd.LeakyReLU(mx.nd.NDArray(-twos), act_type="rrelu",
                                 lower_bound=0.1, upper_bound=0.3)._data / 2
    torch.cuda.synchronize()
    rate = float((y == 0).double().mean())
    kept = y[y != 0]
    se = (DROP_P * (1 - DROP_P) / SAMPLE_N) ** 0.5
    scale_err = float((kept / 2.0 - 1 / (1 - DROP_P)).abs().max())
    if not (abs(rate - DROP_P) < 6 * se and scale_err < 1e-6 and
            torch.equal(y, y2)):
        raise SystemExit("chip_smoke: phase 10 Dropout on the card: rate %.6f"
                         " (p %.2f), scale error %.3e, seeded draws equal %s"
                         % (rate, DROP_P, scale_err, torch.equal(y, y2)))
    if not (float(slope.min()) >= 0.1 and float(slope.max()) <= 0.3 and
            abs(float(slope.mean()) - 0.2) <
            6 * 0.2 / (12 * SAMPLE_N) ** 0.5):
        raise SystemExit("chip_smoke: phase 10 rrelu slopes in training: "
                         "%.4f..%.4f, mean %.6f" % (
                             float(slope.min()), float(slope.max()),
                             float(slope.mean())))
    draws_sd = {}
    for name, (aliases, attrs, mean, var) in SAMPLERS.items():
        for op in (name,) + aliases:
            with mx.gpu(dev.index or 0):
                mx.random.seed(10)
                d = getattr(mx.nd, op)(shape=(SAMPLE_N,), **attrs)._data
                mx.random.seed(10)
                again = getattr(mx.nd, op)(shape=(SAMPLE_N,), **attrs)._data
            torch.cuda.synchronize()
            if d.device != dev or d.dtype != torch.float32 or \
                    tuple(d.shape) != (SAMPLE_N,) or not torch.equal(d, again):
                raise SystemExit("chip_smoke: phase 10 %s drew %s %s on %s "
                                 "(seeded draws equal: %s)" % (
                                     op, d.dtype, tuple(d.shape), d.device,
                                     torch.equal(d, again)))
            sd = moments_ok(d.double(), mean, var)
            if not sd < 6:
                raise SystemExit("chip_smoke: phase 10 %s's moments are %.2f"
                                 " standard errors off" % (op, sd))
            draws_sd[op] = sd
            ops.add(op)
    names = set(LAYER_OPS) | {a for n, (al, *_) in SAMPLERS.items()
                              for a in (n,) + al}
    if len(names) != 32 or names - ops:
        raise SystemExit("chip_smoke: phase 10 did not run %s"
                         % sorted(names - ops))
    log("phase 10 layers and samplers: %d layer cases over %d ops card vs "
        "CPU, worst ratio to its bound by op (0: bit-equal): %s; Dropout "
        "p %.1f on %d elements: rate %.6f, kept x 1/(1-p) within %.1e; "
        "rrelu slopes %.4f..%.4f; %d sampler names, %d draws each on the "
        "card, worst moment %.2f standard errors off (%s); in %.1f s [%s]"
        % (len(layer_cases()), len(LAYER_OPS),
           ", ".join("%s %.3f" % kv for kv in sorted(worst.items())), DROP_P,
           SAMPLE_N, rate, scale_err, float(slope.min()),
           float(slope.max()), len(draws_sd), SAMPLE_N,
           max(draws_sd.values()), max(draws_sd, key=draws_sd.get),
           time.perf_counter() - tic, card))


# ---------------------------------------------------------------------------
# phases 13 and 14: ResNet-50 through Module.fit (bench.py's
# train.resnet-50.module_fit protocol, in fp32)
# ---------------------------------------------------------------------------
RESNET = dict(num_classes=1000, num_layers=50, batch=32,
              image=(3, 224, 224))
RESNET_STEPS, RESNET_WARMUP = 30, 5
# examples/image-classification/common/fit.py: lr 0.1, momentum 0.9, wd
# 1e-4, the lr decaying by 0.1 at epochs 30 and 60 of ImageNet
# (1,281,167 images) at batch 32
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
RESNET_EPOCH = 1281167 // 32
# the loss head's kernel pair, once each a step
RESNET_LAUNCHES_PER_STEP = {"softmax_rows": 1, "xent_grad_from_probs": 1}
# phase 14: one step at batch 4, the card against the CPU's float64 step,
# each array within its bound x its max|ref|, or within
# RESNET_STEP_ROUNDING x the CPU's own float32 distance from its float64
# step where that is larger, both CPU steps on the card's ReLU and
# max-pool decisions (see phase_resnet_vs_cpu)
RESNET_STEP_BATCH = 4
RESNET_STEP_TOL = {"output": 1e-4, "gradient": 1e-3, "parameter": 1e-4,
                   "aux": 1e-4}
RESNET_STEP_ROUNDING = 4.0
# phases 13b and 14b: the same under Module(compute_dtype='bfloat16'), as
# bench.py's train.resnet-50.module_fit row runs it: the head's bf16 pair
# once a step; phase 14b's bounds are phase 7b's (outputs 2e-2,
# gradients 5e-2 x max|ref|), 1e-2 for the parameters and moving
# statistics after the step, or RESNET_STEP_ROUNDING x the CPU's own
# bf16-vs-float64 distance where that is larger
RESNET_BF16_LAUNCHES_PER_STEP = {"softmax_rows_bf16": 1,
                                 "xent_grad_from_probs_bf16": 1}
RESNET_BF16_STEP_TOL = {"output": 2e-2, "gradient": 5e-2,
                        "parameter": 1e-2, "aux": 1e-2}
# phase 14b: the maximum over fewer than RESNET_FEW elements is a poor
# estimate of bf16's noise (bn_data_beta, 3 elements: the border terms of
# conv0's data gradient, the rest cancels); such an array is held to
# RESNET_FEW_ROUNDING x the CPU's own distance.  Over six seeds the card's
# distance was 1.10-1.89 x the CPU's (10th-90th percentile of 929
# gradient arrays), at most 3.13 x for 64 elements or more and 4.90 x for
# bn_data_beta; a noise 1.5 x the CPU's passes 4 x in 7.7% of 3-element
# arrays, and 16 x in 0.16%
RESNET_FEW, RESNET_FEW_ROUNDING = 64, 16.0


def resnet_module(dev, compute_dtype=None):
    return mx.Module(mx.models.resnet(num_classes=RESNET["num_classes"],
                                      num_layers=RESNET["num_layers"]),
                     context=dev, compute_dtype=compute_dtype)


def resnet_opt():
    return dict(RESNET_OPT, lr_scheduler=mx.lr_scheduler.MultiFactorScheduler(
        step=[RESNET_EPOCH * 30, RESNET_EPOCH * 60], factor=0.1))


def resnet_init():
    return mx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2)


def synthetic_iter(dev, steps):
    """``SyntheticDataIter``'s one fixed batch on the card, drawn from
    numpy's generator seeded at 13."""
    np.random.seed(13)
    with mx.gpu(dev.index):
        return mx.io.SyntheticDataIter(RESNET["num_classes"],
                                       (RESNET["batch"],) + RESNET["image"],
                                       max_iter=steps)


def phase_resnet(dev, card, compute_dtype=None, step_ms_fp32=None):
    """Phase 13: ResNet-50 (3 x 224 x 224, 1000 classes, batch 32, fp32)
    through ``Module.fit`` on the card for RESNET_STEPS steps, with
    ``fit.py``'s settings (SGD, momentum 0.9, wd 1e-4, lr 0.1,
    ``MultiFactorScheduler``, gaussian Xavier, accuracy, a
    ``Speedometer``) on ``SyntheticDataIter``'s one fixed batch on the
    card.  Fatal unless every bound array, auxiliary state and momentum
    lies on the card, the head's kernel pair launches once a step and
    nothing else does, no wrapper reaches its plain version, the
    cross-entropy on the batch is finite and its mean over the last five
    steps is below the first step's, and every moving statistic is
    finite and has moved.  ``compute_dtype='bfloat16'`` is phase 13b:
    the head's bf16 pair in place of the fp32 one, the outputs bf16, and
    every parameter, gradient, momentum and moving statistic float32;
    its times beside phase 13's (``step_ms_fp32``).  Returns the launch
    counts and ms per step."""
    tag = "13b" if compute_dtype else "13"
    table = (RESNET_BF16_LAUNCHES_PER_STEP if compute_dtype
             else RESNET_LAUNCHES_PER_STEP)
    mx.random.seed(0)
    it = synthetic_iter(dev, RESNET_STEPS)
    mod = resnet_module(dev, compute_dtype)
    label = it.label._data.long()
    ce, clock, start = [], {}, {}

    def on_batch(param):
        # the loss of this step's forward on the fixed batch; its host
        # fetch synchronises every step
        p = mod.get_outputs()[0]._data.float()
        ce.append(float(-torch.log(p[torch.arange(p.shape[0],
                                                  device=p.device),
                                      label]).mean()))
        if param.nbatch in (RESNET_WARMUP - 1, RESNET_STEPS - 1):
            torch.cuda.synchronize()
            clock[param.nbatch] = time.perf_counter()

    kernels.reset_launch_counts()
    tic = time.perf_counter()
    with plain_guard() as plain:
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(resnet_init())
        start.update((k, v.asnumpy()) for k, v in mod.get_params()[1].items())
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=resnet_opt(), eval_metric="accuracy",
                batch_end_callback=[on_batch, mx.callback.Speedometer(
                    RESNET["batch"], 10)])
        torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    counts = kernels.launch_counts()
    ex = mod._exec_group.executor
    on_device(dev, "phase %s arrays, auxiliary states and momenta" % tag,
              list(zip(ex._arg_names, (a._data for a in ex.arg_arrays))) +
              [(n, g._data) for n, g in ex.grad_dict.items()] +
              [(n, a._data) for n, a in ex.aux_dict.items()] +
              [("momentum of %d" % i, s._data)
               for i, s in mod._updater.states.items()])
    if plain:
        raise SystemExit("chip_smoke: phase %s reached plain versions: %s"
                         % (tag, dict(plain)))
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update({k: v * RESNET_STEPS for k, v in table.items()})
    if counts != want:
        raise SystemExit("chip_smoke: phase %s launches %s, want %s"
                         % (tag, {k: v for k, v in counts.items() if v},
                            {k: v for k, v in want.items() if v}))
    first, last5 = ce[0], float(np.mean(ce[-5:]))
    if len(ce) != RESNET_STEPS or not np.isfinite(ce).all() or \
            not last5 < first:
        raise SystemExit("chip_smoke: phase %s cross-entropy per step %s"
                         % (tag, ce))
    arg, aux = mod.get_params()
    still = [k for k, v in aux.items()
             if not np.isfinite(v.asnumpy()).all() or
             np.array_equal(v.asnumpy(), start[k])]
    if len(aux) != 2 * 51 or still:
        raise SystemExit("chip_smoke: phase %s moving statistics not finite "
                         "or unmoved: %s (of %d)" % (tag, still[:8],
                                                     len(aux)))
    if compute_dtype:
        check_resnet_master_fp32(tag, mod)
    sec = clock[RESNET_STEPS - 1] - clock[RESNET_WARMUP - 1]
    timed = RESNET_STEPS - RESNET_WARMUP
    step_ms = sec * 1e3 / timed
    beside = "" if step_ms_fp32 is None else (
        "; phase 13 (fp32) %.3f ms per step, %.1f images/s; ratio %.3f"
        % (step_ms_fp32, RESNET["batch"] * 1e3 / step_ms_fp32,
           step_ms / step_ms_fp32))
    log("phase %s cross-entropy per step: %s"
        % (tag, " ".join("%.4f" % v for v in ce)))
    log("phase %s ResNet-50 (%d parameters in %d arrays, %d moving "
        "statistics) trained %d steps at batch %d, %s, %s (fit %.2f s with "
        "bind and init): cross-entropy step 1 %.4f, last 5 %.4f; head "
        "launches per step %s; steps %d..%d: %.3f ms per step, %.1f "
        "images/s%s [%s]"
        % (tag, sum(v.size for v in arg.values()), len(arg), len(aux),
           RESNET_STEPS, RESNET["batch"], "x".join(map(str, RESNET["image"])),
           compute_dtype or "fp32", wall, first, last5, table,
           RESNET_WARMUP + 1, RESNET_STEPS, step_ms,
           timed * RESNET["batch"] / sec, beside, card))
    return counts, step_ms


def check_resnet_master_fp32(tag, mod):
    """A bf16 image module's outputs bf16; its bound parameters,
    gradients, momenta, moving statistics and ``get_params`` arrays
    float32."""
    group = mod._exec_group
    out = mod.get_outputs()[0]._data
    if out.dtype != torch.bfloat16:
        raise SystemExit("chip_smoke: phase %s output is %s" % (tag,
                                                                out.dtype))
    arrays = {"parameter " + n: a._data for n, a in
              zip(group.param_names, group.param_arrays)}
    arrays.update(("gradient " + n, g._data) for n, g in
                  zip(group.param_names, group.grad_arrays) if g is not None)
    arrays.update(("momentum %d" % i, st._data) for i, st in
                  mod._updater.states.items() if st is not None)
    arrays.update(("moving statistic " + n, a._data) for n, a in
                  zip(group.aux_names, group.aux_arrays))
    arg, aux = mod.get_params()
    arrays.update(("get_params " + n, a._data) for n, a in
                  list(arg.items()) + list(aux.items()))
    wrong = {k: t.dtype for k, t in arrays.items()
             if t.dtype != torch.float32}
    if wrong:
        raise SystemExit("chip_smoke: phase %s master arrays not float32: "
                         "%s" % (tag, dict(list(wrong.items())[:8])))
    log("phase %s: outputs bf16; %d parameters, gradients, momenta, moving "
        "statistics and get_params arrays float32" % (tag, len(arrays)))


def profile_resnet(dev, card, step_ms, compute_dtype=None, warmup=3,
                   steps=5):
    """``--profile``: ``torch.profiler`` over ``steps`` steps of phase 13's
    fit (13b's with ``compute_dtype``) after ``warmup``: device time, the
    busy share of the phase's unprofiled ``step_ms``, the top device
    ops."""
    mx.random.seed(0)
    it = synthetic_iter(dev, warmup + steps)
    mod = resnet_module(dev, compute_dtype)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    clock = {}

    def on_batch(param):
        if param.nbatch in (warmup - 1, warmup + steps - 1):
            torch.cuda.synchronize()
            clock[param.nbatch] = time.perf_counter()
            (prof.start if param.nbatch == warmup - 1 else prof.stop)()

    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=resnet_opt(),
            initializer=resnet_init(), eval_metric="accuracy",
            batch_end_callback=on_batch)
    window_ms = (clock[warmup + steps - 1] - clock[warmup - 1]) * 1e3 / steps
    report_profile("13b" if compute_dtype else "13", prof, steps, step_ms,
                   window_ms, card)


class KinkDecisions:
    """The decisions a step's ReLUs (which inputs pass) and max pools
    (which element of each window is the max) take, in the order the
    executor runs them, recorded; or those of another step's record
    replayed, with the step's own decisions still recorded.  A replayed
    ReLU is ``x * mask`` and a replayed max pool gathers the recorded
    elements, so the backward follows the same decisions."""

    def __init__(self, replay=None):
        self.relu, self.pool = [], []
        self.replay = replay

    @contextlib.contextmanager
    def patched(self):
        act, pool = get_op("Activation"), get_op("Pooling")
        act_fc, pool_fc = act.fcompute, pool.fcompute
        rec = self.replay

        def relu(attrs, x):
            if attrs["act_type"] != "relu":
                return act_fc(attrs, x)
            self.relu.append((x > 0).cpu())
            if rec is None:
                return act_fc(attrs, x)
            mask = rec.relu[len(self.relu) - 1]
            assert mask.shape == x.shape
            return x * mask.to(x.device, x.dtype)

        def max_pool(attrs, x):
            if attrs["pool_type"] != "max" or attrs["global_pool"]:
                return pool_fc(attrs, x)
            kernel = tuple(attrs["kernel"])
            assert len(kernel) == 2
            stride = attrs["stride"] or (1, 1)
            padded = layer_ops.pool_pad(attrs, x, kernel, stride,
                                        attrs["pad"] or (0, 0))
            with torch.no_grad():
                _, own = torch.nn.functional.max_pool2d(
                    padded, kernel, stride, return_indices=True)
            self.pool.append(own.cpu())
            if rec is None:
                return pool_fc(attrs, x)
            idx = rec.pool[len(self.pool) - 1].to(x.device)
            assert idx.shape == own.shape
            return padded.flatten(2).gather(2, idx.flatten(2)).view(
                idx.shape)

        act.fcompute, pool.fcompute = relu, max_pool
        try:
            yield self
        finally:
            act.fcompute, pool.fcompute = act_fc, pool_fc
        if rec is not None:
            assert (len(self.relu), len(self.pool)) == \
                (len(rec.relu), len(rec.pool))

    def differ(self, other):
        """ReLU inputs and max-pool windows where two records' own
        decisions disagree, and the totals of each."""
        return (sum(int((a != b).sum()) for a, b in zip(self.relu,
                                                        other.relu)),
                sum(a.numel() for a in self.relu),
                sum(int((a != b).sum()) for a, b in zip(self.pool,
                                                        other.pool)),
                sum(a.numel() for a in self.pool))


def resnet_step(dev, params, aux, X, y, kinks, compute_dtype=None,
                tag="14"):
    """One ``forward_backward`` + SGD ``update`` of ResNet-50 on ``dev``
    from ``params`` / ``aux`` on the batch (X, y), its ReLU and max-pool
    decisions recorded into or replayed from ``kinks``: the
    probabilities, every gradient, every updated parameter and moving
    statistic, as numpy by kind and name.  ``compute_dtype='float64'``
    runs the step in float64 over float32 master arrays."""
    mod = mx.Module(mx.models.resnet(num_classes=RESNET["num_classes"],
                                     num_layers=RESNET["num_layers"]),
                    context=dev, compute_dtype=compute_dtype)
    it = mx.io.NDArrayIter(X, y, batch_size=RESNET_STEP_BATCH)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=params, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=resnet_opt())
    tic = time.perf_counter()
    with kinks.patched():
        mod.forward_backward(next(iter(it)))
    mod.update()
    out = {("output", "probabilities"): mod.get_outputs()[0].asnumpy()}
    out.update((("gradient", n), g.asnumpy()) for n, g in
               mod._exec_group.executor.grad_dict.items() if n in params)
    arg, auxs = mod.get_params()
    out.update((("parameter", n), v.asnumpy()) for n, v in arg.items())
    out.update((("aux", n), v.asnumpy()) for n, v in auxs.items())
    log("phase %s one %s step on %s (%s decisions): %.2f s" % (
        tag, compute_dtype or "float32", dev,
        "recorded" if kinks.replay is None else "replayed",
        time.perf_counter() - tic))
    return out


def phase_resnet_vs_cpu(dev, card, compute_dtype=None):
    """Phase 14: one ResNet-50 step at full width, batch 4, on the card
    from the initializer's parameters (gaussian Xavier, BatchNorm's
    gamma 1 and beta 0) and moving statistics, against the CPU's step in
    float64: the probabilities, every updated parameter and moving
    statistic within 1e-4 x max|ref|, every gradient within 1e-3 x its
    max|ref|; or, where that is larger, within RESNET_STEP_ROUNDING x
    the distance of the CPU's float32 step from its float64 step (a sum
    such as ``bn0_gamma``'s gradient cancels to a small fraction of its
    terms, and its rounding with it).  Both CPU steps replay the card's
    decisions at every ReLU and max pool: an input within rounding of
    the kink, or two near-equal elements of a pooling window, goes one
    way on the card and may go the other on the CPU, passing or
    stopping a whole term; replayed, the three steps differ by rounding
    alone.  Prints each kind's worst ratio to its bound, the arrays
    held to the CPU's own distance, and the count of decisions the CPU
    steps would have taken otherwise.  ``compute_dtype='bfloat16'`` is
    phase 14b: the card's and the CPU's bf16 steps, held to
    ``RESNET_BF16_STEP_TOL`` or to RESNET_STEP_ROUNDING x the CPU's own
    bf16 distance from its float64 step, as phase 7b holds the LM's
    (RESNET_FEW_ROUNDING x for an array of fewer than RESNET_FEW
    elements); it prints how the card's distance compares with the
    CPU's over the arrays held so."""
    tag = "14b" if compute_dtype else "14"
    tols = RESNET_BF16_STEP_TOL if compute_dtype else RESNET_STEP_TOL
    mx.random.seed(14)
    with mx.cpu():
        init = resnet_module(mx.cpu())
        rs = np.random.RandomState(14)
        shape = (RESNET_STEP_BATCH,) + RESNET["image"]
        X = rs.uniform(-1, 1, shape).astype(np.float32)
        y = rs.randint(0, RESNET["num_classes"],
                       RESNET_STEP_BATCH).astype(np.float32)
        init.bind([("data", shape)], [("softmax_label",
                                       (RESNET_STEP_BATCH,))])
        init.init_params(resnet_init())
        arg, aux = init.get_params()
    params = {k: v.asnumpy() for k, v in arg.items()}
    auxs = {k: v.asnumpy() for k, v in aux.items()}
    cpu = torch.device("cpu")
    card_kinks = KinkDecisions()
    card_out = resnet_step(dev, params, auxs, X, y, card_kinks,
                           compute_dtype, tag)
    cpu32_kinks = KinkDecisions(replay=card_kinks)
    cpu_out = resnet_step(cpu, params, auxs, X, y, cpu32_kinks,
                          compute_dtype, tag)
    cpu64_kinks = KinkDecisions(replay=card_kinks)
    cpu64 = resnet_step(cpu, params, auxs, X, y, cpu64_kinks, "float64",
                        tag)
    worst, rounding, failed, ratios = {}, [], [], []
    for (kind, name), ref in cpu64.items():
        got = card_out[(kind, name)]
        bound = tols[kind] * max(float(np.abs(ref).max()), 1e-30)
        times = (RESNET_FEW_ROUNDING if compute_dtype and
                 ref.size < RESNET_FEW else RESNET_STEP_ROUNDING)
        cpu_err = float(np.abs(cpu_out[(kind, name)].astype(np.float64) -
                               ref).max())
        own = times * cpu_err
        if own > bound:
            bound = own
            rounding.append("%s:%s" % (kind, name))
        err = float(np.abs(got.astype(np.float64) - ref).max())
        if not (np.isfinite(got).all() and err <= bound):
            failed.append("%s %s (%d elements): %.3e past %.3e" % (
                kind, name, ref.size, err, bound))
        if own == bound:
            ratios.append((err / cpu_err, kind, name, ref.size))
        if err / bound >= worst.get(kind, (0.0, ""))[0]:
            worst[kind] = (err / bound, name)
    if ratios:
        r = sorted(ratios)
        log("phase %s the card's distance from the CPU's float64 step over "
            "the CPU's own %s distance, %d arrays held to the latter: 10th "
            "percentile %.3f, median %.3f, 90th %.3f, largest %s [%s]"
            % (tag, compute_dtype or "float32", len(r),
               r[len(r) // 10][0], r[len(r) // 2][0], r[len(r) * 9 // 10][0],
               ", ".join("%.3f (%s %s, %d elements)" % x for x in r[-3:]),
               card))
    if failed:
        raise SystemExit("chip_smoke: phase %s, card vs the CPU's float64 "
                         "step: %s" % (tag, "; ".join(failed)))
    flips32 = card_kinks.differ(cpu32_kinks)
    flips64 = card_kinks.differ(cpu64_kinks)
    own = compute_dtype or "float32"
    log("phase %s ResNet-50 %s step at batch %d, card vs the CPU's float64 "
        "step, both CPU steps on the card's decisions: %d arrays agree; "
        "worst ratio to its bound by kind: %s; %d arrays held to %g x the "
        "CPU's own %s-vs-float64 distance%s, larger than their bound: "
        "%s; decisions the CPU would have taken otherwise: %s %d of "
        "%d ReLU inputs and %d of %d max-pool windows, float64 %d and %d "
        "[%s]"
        % (tag, own, RESNET_STEP_BATCH, len(cpu64), "; ".join(
            "%s %.3f (%s, bound %g x max|ref|)" % (
                k, worst[k][0], worst[k][1], tols[k])
            for k in sorted(worst)), len(rounding), RESNET_STEP_ROUNDING,
            own, " (%g x under %d elements)" % (
                RESNET_FEW_ROUNDING, RESNET_FEW) if compute_dtype else "",
            " ".join(rounding[:12]), own, flips32[0], flips32[1],
            flips32[2], flips32[3], flips64[0], flips64[2], card))


# ---------------------------------------------------------------------------
# phases 15-17: the image-classification user's path: scoring the zoo
# (examples/image-classification/benchmark_score.py's protocol), the zoo
# training in bf16, and a bf16 ResNet-50 run checkpointed with its
# optimizer state, resumed, and used to predict
# ---------------------------------------------------------------------------
# (label, builder, its arguments, image shape): benchmark_score.py's
# networks, then the rest of the zoo
SCORE_NETS = (("alexnet", "alexnet", {}, (3, 224, 224)),
              ("vgg-16", "vgg", {"num_layers": 16}, (3, 224, 224)),
              ("inception-bn", "inception_bn", {}, (3, 224, 224)),
              ("inception-v3", "inception_v3", {}, (3, 299, 299)),
              ("resnet-50", "resnet", {"num_layers": 50}, (3, 224, 224)),
              ("resnet-152", "resnet", {"num_layers": 152}, (3, 224, 224)))
ZOO_NETS = SCORE_NETS + (
    ("googlenet", "googlenet", {}, (3, 224, 224)),
    ("resnext-50", "resnext", {"num_layers": 50}, (3, 224, 224)),
    ("inception-resnet-v2", "inception_resnet_v2", {}, (3, 299, 299)))
SCORE_BATCH, SCORE_WARMUP, SCORE_BATCHES = 32, 2, 10
# phase 15's card forward at batch 2 against the CPU's, of max|ref|
SCORE_CHECK_BATCH, SCORE_TOL = 2, 1e-4
# phase 16: two bf16 fit steps of each network at batch 8, fit.py's
# settings at a hundredth of its learning rate: from the He-scaled start
# the nets without BatchNorm have logits of 10-15 nats, and one step at
# 0.01 took AlexNet's cross-entropy from 10.4 to 69 (batch 2, CPU)
ZOO_BATCH, ZOO_STEPS = 8, 2
ZOO_OPT = {"learning_rate": 0.001, "momentum": 0.9, "wd": 1e-4}
# phase 17: bf16 ResNet-50 at batch 32, RESUME_K steps, a checkpoint with
# the optimizer state, then one more step; the learning rate drops
# tenfold after update RESUME_K, so a resumed run that lost the update
# count takes its step at the wrong rate
RESUME_K = 2
RESUME_PREDICT_ROWS, RESUME_SCORE_ROWS = 40, 64


def zoo_symbol(builder, kwargs):
    return getattr(mx.models, builder)(num_classes=1000, **kwargs)


def head_probs(mod):
    return mod.get_outputs()[0]._data.float()


def phase_score(dev, card):
    """Phase 15: ``benchmark_score.py`` on the card for SCORE_NETS:
    ``Module(label_names=None)`` (``softmax_label`` becomes a parameter,
    which Xavier initialises and the eval forward ignores),
    ``bind(for_training=False)``, ``Xavier(magnitude=2.0)``, fp32 with
    TF32 off, batch 32, two warm-up batches, then ten timed between
    host fetches of the output.  Fatal unless the head's forward kernel
    launches once a batch and nothing else does, no plain version runs,
    the probabilities are finite rows that sum to 1, and the module
    reshaped to batch 2 gives, on the first two images, the CPU
    module's probabilities from the same parameters within SCORE_TOL x
    max|ref|.  Returns the launch counts and images/s by network."""
    cpu = torch.device("cpu")
    kernels.reset_launch_counts()
    rates, total = {}, dict.fromkeys(kernels.KERNELS, 0)
    for label, builder, kwargs, shape in SCORE_NETS:
        mx.random.seed(15)
        mod = mx.Module(zoo_symbol(builder, kwargs), context=dev,
                        label_names=None)
        mod.bind(data_shapes=[("data", (SCORE_BATCH,) + shape)],
                 for_training=False)
        mod.init_params(initializer=mx.init.Xavier(magnitude=2.0))
        arg, aux = mod.get_params()
        if not np.abs(arg["softmax_label"].asnumpy()).max() > 0:
            raise SystemExit("chip_smoke: phase 15 %s: softmax_label was "
                             "not initialised as a parameter" % label)
        rs = np.random.RandomState(0)
        X = rs.uniform(-1, 1, (SCORE_BATCH,) + shape).astype(np.float32)
        batch = mx.io.DataBatch(data=[mx.nd.array(X, ctx=dev)], label=[])
        kernels.reset_launch_counts()
        with plain_guard() as plain:
            for _ in range(SCORE_WARMUP):
                mod.forward(batch, is_train=False)
            mod.get_outputs()[0].asnumpy()
            tic = time.perf_counter()
            for _ in range(SCORE_BATCHES):
                mod.forward(batch, is_train=False)
            probs = mod.get_outputs()[0].asnumpy()
            sec = time.perf_counter() - tic
            mod.reshape([("data", (SCORE_CHECK_BATCH,) + shape)])
            mod.forward(mx.io.DataBatch(data=[mx.nd.array(
                X[:SCORE_CHECK_BATCH], ctx=dev)], label=[]), is_train=False)
            got = mod.get_outputs()[0].asnumpy()
        counts = kernels.launch_counts()
        want = dict.fromkeys(kernels.KERNELS, 0)
        want["softmax_rows"] = SCORE_WARMUP + SCORE_BATCHES + 1
        if plain or counts != want:
            raise SystemExit("chip_smoke: phase 15 %s launches %s, plain %s"
                             % (label, {k: v for k, v in counts.items()
                                        if v}, dict(plain)))
        if probs.shape != (SCORE_BATCH, 1000) or \
                not np.isfinite(probs).all() or \
                np.abs(probs.sum(axis=1) - 1).max() > 1e-4:
            raise SystemExit("chip_smoke: phase 15 %s probabilities %s"
                             % (label, probs.shape))
        ref_mod = mx.Module(zoo_symbol(builder, kwargs), context=cpu,
                            label_names=None)
        ref_mod.bind(data_shapes=[("data", (SCORE_CHECK_BATCH,) + shape)],
                     for_training=False)
        ref_mod.set_params({k: v for k, v in arg.items()
                            if k != "softmax_label"}, aux,
                           allow_missing=True)
        ref_mod.forward(mx.io.DataBatch(data=[mx.nd.array(
            X[:SCORE_CHECK_BATCH], ctx=cpu)], label=[]), is_train=False)
        ref = ref_mod.get_outputs()[0].asnumpy()
        rel = float(np.abs(got - ref).max() / np.abs(ref).max())
        if not rel <= SCORE_TOL:
            raise SystemExit("chip_smoke: phase 15 %s: the card's forward at "
                             "batch %d %.3e x max|ref| from the CPU's"
                             % (label, SCORE_CHECK_BATCH, rel))
        for k, v in counts.items():
            total[k] += v
        rates[label] = SCORE_BATCHES * SCORE_BATCH / sec
        log("phase 15 scoring %s (%d parameters, %s): %.1f images/s at "
            "batch %d, fp32 (%d timed batches); the card's forward at batch "
            "%d %.3e x max|ref| from the CPU's (tol %g); head forward "
            "launches %d [%s]"
            % (label, sum(v.size for k, v in arg.items()
                          if k != "softmax_label"),
               "x".join(map(str, shape)), rates[label], SCORE_BATCH,
               SCORE_BATCHES, SCORE_CHECK_BATCH, rel, SCORE_TOL,
               counts["softmax_rows"], card))
        del mod, ref_mod
    return total, rates


def phase_zoo_train(dev, card):
    """Phase 16: every network of ZOO_NETS takes ZOO_STEPS bf16
    ``Module.fit`` steps at batch ZOO_BATCH on random images from seed
    16 (gaussian Xavier, SGD with ZOO_OPT).  Fatal unless the
    cross-entropy of each step is finite, every parameter and every
    moving statistic has moved, the head's bf16 pair launches once a
    step and nothing else does, and no plain version runs.  Returns the
    launch counts."""
    total = dict.fromkeys(kernels.KERNELS, 0)
    for label, builder, kwargs, shape in ZOO_NETS:
        rs = np.random.RandomState(16)
        X = rs.uniform(-1, 1, (ZOO_STEPS * ZOO_BATCH,) + shape).astype(
            np.float32)
        y = rs.randint(0, 1000, ZOO_STEPS * ZOO_BATCH).astype(np.float32)
        it = mx.io.NDArrayIter(X, y, batch_size=ZOO_BATCH)
        mx.random.seed(16)
        mod = mx.Module(zoo_symbol(builder, kwargs), context=dev,
                        compute_dtype="bfloat16")
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(resnet_init())
        arg0, aux0 = ({k: v.asnumpy() for k, v in d.items()}
                      for d in mod.get_params())
        ce = []

        def on_batch(param):
            p = head_probs(mod)
            lbl = torch.as_tensor(y[param.nbatch * ZOO_BATCH:
                                    (param.nbatch + 1) * ZOO_BATCH],
                                  device=p.device).long()
            ce.append(float(-torch.log(p[torch.arange(ZOO_BATCH,
                                                      device=p.device),
                                         lbl]).mean()))

        kernels.reset_launch_counts()
        tic = time.perf_counter()
        with plain_guard() as plain:
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    optimizer_params=ZOO_OPT, eval_metric="accuracy",
                    batch_end_callback=on_batch)
            torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        counts = kernels.launch_counts()
        want = dict.fromkeys(kernels.KERNELS, 0)
        want.update({k: v * ZOO_STEPS
                     for k, v in RESNET_BF16_LAUNCHES_PER_STEP.items()})
        if plain or counts != want:
            raise SystemExit("chip_smoke: phase 16 %s launches %s, plain %s"
                             % (label, {k: v for k, v in counts.items()
                                        if v}, dict(plain)))
        check_resnet_master_fp32("16 " + label, mod)
        arg, aux = mod.get_params()
        still = [k for k, v in list(arg.items()) + list(aux.items())
                 if np.array_equal(v.asnumpy(), arg0.get(k, aux0.get(k)))]
        bad = [k for k, v in list(arg.items()) + list(aux.items())
               if not np.isfinite(v.asnumpy()).all()]
        if len(ce) != ZOO_STEPS or not np.isfinite(ce).all() or still or \
                bad:
            raise SystemExit("chip_smoke: phase 16 %s: cross-entropy %s; "
                             "unmoved %s; not finite %s"
                             % (label, ce, still[:8], bad[:8]))
        for k, v in counts.items():
            total[k] += v
        log("phase 16 %s (%s) took %d bf16 fit steps at batch %d: "
            "cross-entropy %s; %d parameters and %d moving statistics all "
            "moved; head launches %s; %.2f s with bind and init [%s]"
            % (label, "x".join(map(str, shape)), ZOO_STEPS, ZOO_BATCH,
               " ".join("%.4f" % c for c in ce), len(arg), len(aux),
               {k: v for k, v in counts.items() if v}, wall, card))
        del mod
    return total


def resume_data():
    """RESUME_K + 1 training batches and RESUME_SCORE_ROWS labelled
    images to predict and score, from seed 17."""
    rs = np.random.RandomState(17)
    n = (RESUME_K + 1) * RESNET["batch"]
    X = rs.uniform(-1, 1, (n,) + RESNET["image"]).astype(np.float32)
    y = rs.randint(0, RESNET["num_classes"], n).astype(np.float32)
    P = rs.uniform(-1, 1, (RESUME_SCORE_ROWS,) + RESNET["image"]).astype(
        np.float32)
    q = rs.randint(0, RESNET["num_classes"],
                   RESUME_SCORE_ROWS).astype(np.float32)
    return X, y, P, q


def resume_opt():
    return dict(RESNET_OPT, lr_scheduler=mx.lr_scheduler.MultiFactorScheduler(
        step=[RESUME_K], factor=0.1))


def resume_state(mod):
    """The module's outputs, parameters, moving statistics and momenta,
    as numpy by kind and name."""
    out = {("output", "probabilities"): mod.get_outputs()[0].asnumpy()}
    arg, aux = mod.get_params()
    out.update((("parameter", n), v.asnumpy()) for n, v in arg.items())
    out.update((("aux", n), v.asnumpy()) for n, v in aux.items())
    out.update((("momentum", str(i)), s.asnumpy())
               for i, s in mod._updater.states.items())
    return out


def resume_fit(mod, X, y, begin, end, epoch=0, callbacks=()):
    """``fit`` over batches ``begin`` to ``end`` of (X, y) as epoch
    ``epoch``, with phase 17's optimizer."""
    b = RESNET["batch"]
    it = mx.io.NDArrayIter(X[begin * b:end * b], y[begin * b:end * b],
                           batch_size=b)
    mod.fit(it, begin_epoch=epoch, num_epoch=epoch + 1, optimizer="sgd",
            optimizer_params=resume_opt(), eval_metric="accuracy",
            epoch_end_callback=list(callbacks))


def states_are_numpy(fname):
    """Unpickle a ``.states`` file in a fresh interpreter that cannot
    import torch, and walk it: True when it holds only the v2 envelope's
    dicts, tuples, numbers, None and numpy arrays."""
    code = (
        "import pickle, sys\n"
        "sys.modules['torch'] = None\n"
        "import numpy as np\n"
        "obj = pickle.load(open(sys.argv[1], 'rb'))\n"
        "def ok(v):\n"
        "    if isinstance(v, dict):\n"
        "        return all(ok(k) and ok(x) for k, x in v.items())\n"
        "    if isinstance(v, (tuple, list)):\n"
        "        return all(ok(x) for x in v)\n"
        "    return v is None or isinstance(v, (int, float, str, np.ndarray,"
        " np.generic))\n"
        "assert obj['__updater_format__'] == 2 and ok(obj)\n"
        "print(len(obj['states']), obj['num_update'])\n")
    res = subprocess.run([sys.executable, "-c", code, fname],
                         capture_output=True, text=True, timeout=120)
    return res.returncode == 0, (res.stdout + res.stderr).strip()


def phase_resume(dev, card, workdir):
    """Phase 17: bf16 ResNet-50 at batch 32 from one Xavier start,
    uninterrupted for RESUME_K + 1 fit steps (twice: cuDNN's backward
    convolutions need not be deterministic, and the two runs measure
    the card's own run-to-run distance), and interrupted: RESUME_K steps,
    ``module_checkpoint(..., save_optimizer_states=True)``,
    ``Module.load(..., load_optimizer_states=True)``, ``fit(begin_epoch=
    RESUME_K)`` over the last batch.  Fatal unless the interrupted run's
    outputs, parameters, moving statistics and momenta equal the first
    uninterrupted run's within 2 x the worst run-to-run distance of
    their kind (of each array's max|ref|; bit for bit where the two
    uninterrupted runs are), the ``.states`` file unpickles with pickle
    and numpy alone, holding no torch object, and on the resumed module
    ``predict`` equals ``iter_predict``'s batches (the padding rows
    stripped, RESUME_PREDICT_ROWS rows in batches of 32) and, over
    RESUME_SCORE_ROWS rows, the accuracy of ``predict``'s outputs equals
    ``score``'s.  Returns the launch counts."""
    X, y, P, q = resume_data()
    mx.random.seed(17)
    with mx.cpu():
        init = resnet_module(mx.cpu())
        init.bind([("data", (RESNET["batch"],) + RESNET["image"])],
                  [("softmax_label", (RESNET["batch"],))])
        init.init_params(resnet_init())
        arg0, aux0 = init.get_params()
    start = dict(arg_params={k: v.asnumpy() for k, v in arg0.items()},
                 aux_params={k: v.asnumpy() for k, v in aux0.items()})
    kernels.reset_launch_counts()
    runs = []
    with plain_guard() as plain:
        for _ in range(2):
            mod = resnet_module(dev, "bfloat16")
            mod.bind([("data", (RESNET["batch"],) + RESNET["image"])],
                     [("softmax_label", (RESNET["batch"],))])
            mod.init_params(**start)
            resume_fit(mod, X, y, 0, RESUME_K + 1)
            runs.append(resume_state(mod))
        prefix = "%s/resnet50" % workdir
        mod = resnet_module(dev, "bfloat16")
        mod.bind([("data", (RESNET["batch"],) + RESNET["image"])],
                 [("softmax_label", (RESNET["batch"],))])
        mod.init_params(**start)
        resume_fit(mod, X, y, 0, RESUME_K, callbacks=[
            mx.callback.module_checkpoint(mod, prefix,
                                          save_optimizer_states=True)])
        saved = {str(i): s.asnumpy() for i, s in mod._updater.states.items()}
        mod = mx.Module.load(prefix, 1, load_optimizer_states=True,
                             context=dev, compute_dtype="bfloat16")
        resume_fit(mod, X, y, RESUME_K, RESUME_K + 1, epoch=1)
        resumed = resume_state(mod)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update({k: v * 3 * (RESUME_K + 1)
                 for k, v in RESNET_BF16_LAUNCHES_PER_STEP.items()})
    if plain or counts != want:
        raise SystemExit("chip_smoke: phase 17 launches %s, plain %s"
                         % ({k: v for k, v in counts.items() if v},
                            dict(plain)))
    ok, said = states_are_numpy("%s-0001.states" % prefix)
    if not ok:
        raise SystemExit("chip_smoke: phase 17 .states file: %s" % said)
    with open("%s-0001.states" % prefix, "rb") as f:
        states, counts_saved, num_update = \
            mx.optimizer.unpack_updater_states(f.read())
    if num_update != RESUME_K or any(
            not np.array_equal(states[int(i)], v) for i, v in saved.items()):
        raise SystemExit("chip_smoke: phase 17 .states file holds num_update "
                         "%s and other momenta than the run's" % num_update)
    a, b = runs
    noise = collections.defaultdict(float)
    for key, ref in a.items():
        scale = max(float(np.abs(ref).max()), 1e-30)
        noise[key[0]] = max(noise[key[0]],
                            float(np.abs(b[key] - ref).max()) / scale)
    worst = collections.defaultdict(lambda: (0.0, ""))
    for key, ref in a.items():
        got = resumed[key]
        scale = max(float(np.abs(ref).max()), 1e-30)
        rel = float(np.abs(got - ref).max()) / scale
        if not (np.isfinite(got).all() and rel <= 2 * noise[key[0]]):
            raise SystemExit("chip_smoke: phase 17 resumed %s %s %.3e x "
                             "max|ref| from the uninterrupted run's; the "
                             "card's run-to-run distance %.3e"
                             % (key[0], key[1], rel, noise[key[0]]))
        worst[key[0]] = max(worst[key[0]], (rel, key[1]))
    it = mx.io.NDArrayIter(P[:RESUME_PREDICT_ROWS], q[:RESUME_PREDICT_ROWS],
                           batch_size=RESNET["batch"])
    pred = mod.predict(it).asnumpy()
    parts = [outs[0].asnumpy() for outs, _, _ in mod.iter_predict(it)]
    whole = mx.io.NDArrayIter(P, q, batch_size=RESNET["batch"])
    pred64 = mod.predict(whole).asnumpy()
    acc = dict(mod.score(whole, "acc"))["accuracy"]
    mine = float((pred64.argmax(axis=1) == q).mean())
    if pred.shape != (RESUME_PREDICT_ROWS, RESNET["num_classes"]) or \
            not np.array_equal(pred, np.concatenate(parts)) or \
            abs(acc - mine) > 1e-12:
        raise SystemExit("chip_smoke: phase 17 predict %s vs iter_predict "
                         "%s; score %s vs predict's accuracy %s" % (
                             pred.shape, [p.shape for p in parts], acc,
                             mine))
    log("phase 17 bf16 ResNet-50 resumed after %d steps (module_checkpoint "
        "with optimizer states, Module.load(load_optimizer_states=True), "
        "num_update %d restored): step %d against the uninterrupted run's, "
        "worst of each kind %s (bound 2 x the card's run-to-run distance: "
        "%s); .states file unpickled without torch (%s); predict of %d rows "
        "equals iter_predict's %d batches (the padding stripped); over %d "
        "rows predict's accuracy %.4f equals score's [%s]"
        % (RESUME_K, num_update, RESUME_K + 1, "; ".join(
            "%s %.3e (%s)" % (k, v[0], v[1]) for k, v in sorted(
                worst.items())), "; ".join(
            "%s %.3e" % kv for kv in sorted(noise.items())), said,
            RESUME_PREDICT_ROWS, len(parts), len(q), acc, card))
    return counts


# ---------------------------------------------------------------------------
# phases 18-19: the LSTM language model through BucketingModule
# ---------------------------------------------------------------------------
# bench.py:409-462, train.lstm-bucketing.module_fit: 3 layers, hidden and
# embed 200, vocab 10000, batch 32, one bucket of 32; SGD at learning rate
# 0.01, momentum 0, wd 1e-5; Xavier(factor_type='in', magnitude=2.34);
# Perplexity(ignore_label=0); kvstore 'device'
LSTM = dict(num_layers=3, num_hidden=200, num_embed=200, vocab_size=10000)
LSTM_BATCH, LSTM_SEQ = 32, 32
LSTM_OPT = {"learning_rate": 0.01, "momentum": 0.0, "wd": 1e-5}
# phase 18: steps 1..LSTM_WARMUP warm up, the next ones up to
# LSTM_STEPS - LSTM_PROFILED are timed, the last LSTM_PROFILED run under
# torch.profiler (device time, launches, busy share)
LSTM_STEPS, LSTM_WARMUP, LSTM_PROFILED = 20, 4, 3
# the loss head's kernel pair (row 10), once each a step; its forward
# kernel once a scored batch
LSTM_LAUNCHES_PER_STEP = {"softmax_rows": 1, "xent_grad_from_probs": 1}
LSTM_SCORE_LAUNCHES_PER_BATCH = {"softmax_rows": 1}
# phase 18b: examples/rnn/lstm_bucketing.py's buckets and corpus (its
# default 2000 training sentences from seed 7, max(4 x batch, 200)
# held-out ones from seed 8), one epoch at phase 18's width
LSTM_BUCKETS = [10, 20, 30, 40]
LSTM_SENTENCES = 2000
# phase 19: one step of each of two buckets at batch 4 on the card and on
# the CPU from the same parameters, every array within LSTM_STEP_TOL x
# max|ref|; the RNN op at full width, cuDNN against the per-step loop on
# the card within RNN_OP_TOL x max|ref|
LSTM_STEP_BATCH = 4
LSTM_STEP_BUCKETS = (10, 20)
LSTM_STEP_TOL = 1e-4
RNN_OP = dict(mode="lstm", num_layers=3, state_size=200, seq=32, batch=32,
              input=200)
RNN_OP_TOL = 1e-4


def lstm_sym_gen():
    return sym_gen_factory(**LSTM)


def zipf_sentences(n, length, seed):
    """``n`` sentences of ``length`` tokens in [1, vocab) drawn with
    Zipf's word frequencies (rank r with probability proportional to
    1/r), as a text corpus's words are.  bench.py draws its tokens
    uniformly; on those nothing can be learnt, and the perplexity stays
    at the vocabulary's size."""
    V = LSTM["vocab_size"]
    rs = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, V)
    return rs.choice(np.arange(1, V), (n, length), p=w / w.sum()).tolist()


def synthetic_corpus(num_sentences, vocab_size, seed):
    """A copy of ``examples/rnn/lstm_bucketing.py``'s corpus: sentences
    of 5 to 34 tokens from a random start, each next token
    ``(7 x + 3) mod vocab`` with probability 0.8, else random."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(num_sentences):
        ln = rs.randint(5, 35)
        start = rs.randint(1, vocab_size)
        s = [start]
        for _ in range(ln - 1):
            s.append((s[-1] * 7 + 3) % vocab_size if rs.rand() < 0.8
                     else rs.randint(1, vocab_size))
        out.append(s)
    return out


def lstm_module(ctx, key):
    return mx.mod.BucketingModule(lstm_sym_gen(), default_bucket_key=key,
                                  context=ctx)


def lstm_fit(mod, it, **kwargs):
    mod.fit(it, num_epoch=1, eval_metric=mx.metric.Perplexity(ignore_label=0),
            optimizer="sgd", optimizer_params=LSTM_OPT,
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            kvstore="device", **kwargs)


def lstm_arrays(mod):
    """(name, tensor) of every executor array of every bucket, and of
    the optimizer's state."""
    out = []
    for key, m in mod._buckets.items():
        ex = m._exec_group.executor
        out += [("%s@%s" % (n, key), a._data) for n, a in
                zip(ex._arg_names, ex.arg_arrays)]
        out += [("d%s@%s" % (n, key), g._data)
                for n, g in ex.grad_dict.items()]
    states = mod._buckets[mod._default_bucket_key]._updater.states
    return out + [("state %s" % i, s._data) for i, s in states.items()
                  if s is not None]


def phase_lstm(dev, card):
    """Phase 18: bench.py's ``train.lstm-bucketing`` row at full width
    (3 x 200, vocab 10000, batch 32, one bucket of 32) through
    ``BucketingModule.fit`` on the card for LSTM_STEPS steps, on Zipfian
    sentences from seed 18.  Fatal unless every array lies on the card,
    the head's kernel pair launches once a step and no other kernel
    does, no wrapper reaches its plain version, and the perplexity is
    finite and falls (mean of the last five steps below the first
    step's).  Prints ms a step and samples/s over the timed window
    (``synchronize()`` at both ends), and the device time, launches and
    busy share of the profiled steps.  Returns the launch counts of the
    run and the ms a step."""
    sent = zipf_sentences(LSTM_BATCH * LSTM_STEPS, LSTM_SEQ, 18)
    it = mx.rnn.BucketSentenceIter(sent, LSTM_BATCH, buckets=[LSTM_SEQ],
                                   invalid_label=0)
    mx.random.seed(18)
    mod = lstm_module(dev, it.default_bucket_key)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    t0, t1 = LSTM_WARMUP, LSTM_STEPS - LSTM_PROFILED
    ppl, steps, clock, last = [], [], {}, {}

    def on_batch(param):
        # the metric's host fetch synchronises every step
        ppl.append(float(param.eval_metric.get()[1]))
        param.eval_metric.reset()
        now = kernels.launch_counts()
        steps.append({k: now[k] - last[k] for k in now})
        last.update(now)
        n = param.nbatch + 1
        if n in (t0, t1, LSTM_STEPS):
            torch.cuda.synchronize()
            clock[n] = time.perf_counter()
        if n == t1:
            prof.start()
        elif n == LSTM_STEPS:
            prof.stop()

    kernels.reset_launch_counts()
    last.update(kernels.launch_counts())
    tic = time.perf_counter()
    with plain_guard() as plain:
        lstm_fit(mod, it, batch_end_callback=on_batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    counts = kernels.launch_counts()
    on_device(dev, "phase 18 arrays and optimizer state", lstm_arrays(mod))
    if plain:
        raise SystemExit("chip_smoke: phase 18 reached plain versions: %s"
                         % dict(plain))
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(LSTM_LAUNCHES_PER_STEP)
    bad = [(i, got) for i, got in enumerate(steps) if got != want]
    if len(steps) != LSTM_STEPS or bad:
        raise SystemExit("chip_smoke: phase 18 ran %d steps; launches %s, "
                         "want %s a step" % (len(steps), bad[:2], want))
    first, last5 = ppl[0], float(np.mean(ppl[-5:]))
    if not (np.isfinite(ppl).all() and last5 < first):
        raise SystemExit("chip_smoke: phase 18 perplexity per step %s"
                         % ppl)
    step_ms = (clock[t1] - clock[t0]) * 1e3 / (t1 - t0)
    window_ms = (clock[LSTM_STEPS] - clock[t1]) * 1e3 / LSTM_PROFILED
    arg, _ = mod.get_params()
    log("phase 18 perplexity per step: %s"
        % " ".join("%.1f" % p for p in ppl))
    log("phase 18 LSTM LM (%s, %d parameters in %d arrays) trained %d "
        "steps through BucketingModule.fit at batch %d, bucket %d, fp32 "
        "(fit %.2f s with bind and init): perplexity step 1 %.2f, step %d "
        "%.2f, last 5 %.2f; head launches per step %s; steps %d..%d: %.3f "
        "ms per step, %.1f samples/s, %.0f tokens/s [%s]"
        % (LSTM, sum(v.size for v in arg.values()), len(arg), LSTM_STEPS,
           LSTM_BATCH, LSTM_SEQ, wall, first, LSTM_STEPS, ppl[-1], last5,
           LSTM_LAUNCHES_PER_STEP, t0 + 1, t1, step_ms,
           LSTM_BATCH * 1e3 / step_ms, LSTM_BATCH * LSTM_SEQ * 1e3 / step_ms,
           card))
    report_profile("18", prof, LSTM_PROFILED, step_ms, window_ms, card)
    return counts, step_ms


def phase_lstm_buckets(dev, card, step_ms_18):
    """Phase 18b: ``examples/rnn/lstm_bucketing.py`` at phase 18's width:
    its corpus (a copy of its ``synthetic_corpus``), buckets 10, 20, 30
    and 40, one epoch of ``fit`` with ``eval_data`` scored at its end,
    then ``score`` again.  Fatal unless the four bucket modules hold the
    same parameter and gradient tensors (equal ``data_ptr()``) and share
    one updater, every parameter moved, no plain version was reached,
    the head's forward kernel launched once a training step and a scored
    batch and its gradient kernel once a training step, and the
    objective's perplexity (every label, the padding too: what
    SoftmaxOutput trains) is finite and falls (mean of the last five
    steps below the first step's).  The example's own metric
    (``Perplexity(ignore_label=0)``) and the held-out score are printed
    beside it.  Returns the launch counts."""
    V = LSTM["vocab_size"]
    train = synthetic_corpus(LSTM_SENTENCES, V, 7)
    val = synthetic_corpus(max(LSTM_BATCH * 4, LSTM_SENTENCES // 10), V, 8)
    it = mx.rnn.BucketSentenceIter(train, LSTM_BATCH, buckets=LSTM_BUCKETS,
                                   invalid_label=0)
    ev = mx.rnn.BucketSentenceIter(val, LSTM_BATCH, buckets=LSTM_BUCKETS,
                                   invalid_label=0)
    n_eval = len(ev._plan)
    mx.random.seed(18)
    mod = lstm_module(dev, it.default_bucket_key)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    objective, metric, keys = [], [], []

    def on_batch(param):
        batch = param.locals["data_batch"]
        p = mod.get_outputs()[0]._data
        lab = batch.label[0]._data.to(p.device).reshape(-1).long()
        ce = -torch.log(p[torch.arange(p.shape[0], device=p.device),
                          lab].clamp_min(1e-10)).mean()
        objective.append(float(torch.exp(ce)))
        metric.append(float(param.eval_metric.get()[1]))
        keys.append(batch.bucket_key)
        param.eval_metric.reset()

    kernels.reset_launch_counts()
    tic = time.perf_counter()
    with plain_guard() as plain:
        lstm_fit(mod, it, eval_data=ev, batch_end_callback=on_batch)
        score = mod.score(ev, mx.metric.Perplexity(ignore_label=0))[0][1]
        torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    counts = kernels.launch_counts()
    on_device(dev, "phase 18b arrays and optimizer state", lstm_arrays(mod))
    steps = len(objective)
    want = dict.fromkeys(kernels.KERNELS, 0)
    for table, n in ((LSTM_LAUNCHES_PER_STEP, steps),
                     (LSTM_SCORE_LAUNCHES_PER_BATCH, 2 * n_eval)):
        for k, v in table.items():
            want[k] += v * n
    if plain or counts != want:
        raise SystemExit("chip_smoke: phase 18b launches %s, want %s; "
                         "plain %s" % ({k: v for k, v in counts.items() if v},
                                       {k: v for k, v in want.items() if v},
                                       dict(plain)))
    if sorted(mod._buckets) != LSTM_BUCKETS:
        raise SystemExit("chip_smoke: phase 18b bound buckets %s"
                         % sorted(mod._buckets))
    default = mod._buckets[it.default_bucket_key]
    split = []
    for name in default._param_names:
        ptrs = set()
        for m in mod._buckets.values():
            ex = m._exec_group.executor
            ptrs.add((ex.arg_dict[name]._data.data_ptr(),
                      ex.grad_dict[name]._data.data_ptr()))
        if len(ptrs) != 1:
            split.append(name)
    if split or any(m._updater is not default._updater
                    for m in mod._buckets.values()):
        raise SystemExit("chip_smoke: phase 18b buckets hold their own "
                         "tensors or updaters: %s" % split)
    arg, _ = mod.get_params()
    still = [k for k, v in arg.items() if np.array_equal(v.asnumpy(),
                                                         start[k])]
    first, last5 = objective[0], float(np.mean(objective[-5:]))
    if still or not (np.isfinite(objective).all() and last5 < first and
                     np.isfinite(metric).all() and np.isfinite(score)):
        raise SystemExit("chip_smoke: phase 18b unmoved %s; objective "
                         "perplexity %s; metric %s; score %s"
                         % (still, objective, metric, score))
    rows = sorted({k * LSTM_BATCH for k in keys})
    log("phase 18b objective perplexity (pads included) per step: %s"
        % " ".join("%d:%.1f" % kv for kv in zip(keys, objective)))
    log("phase 18b Perplexity(ignore_label=0) per step: %s"
        % " ".join("%.1f" % m for m in metric))
    log("phase 18b lstm_bucketing.py at %s, buckets %s, batch %d: one epoch "
        "of %d steps (%s a bucket) in %.2f s with bind, init and two "
        "held-out scores (%.3f ms a step on average; phase 18 %.3f at "
        "bucket 32); four bucket modules on one set of %d parameter and "
        "gradient tensors (equal data_ptr) and one updater; every "
        "parameter moved; objective perplexity step 1 %.1f, last 5 %.1f; "
        "Perplexity(ignore_label=0) step 1 %.1f, last 5 %.1f, held-out "
        "%.1f; head rows %s x %d [%s]"
        % (LSTM, LSTM_BUCKETS, LSTM_BATCH, steps,
           {k: keys.count(k) for k in LSTM_BUCKETS}, wall,
           wall * 1e3 / steps, step_ms_18, len(default._param_names), first,
           last5, metric[0], float(np.mean(metric[-5:])), score, rows, V,
           card))
    return counts


def lstm_step_batches(state=None):
    """Phase 19's batches: the first batch of each of LSTM_STEP_BUCKETS
    at batch LSTM_STEP_BATCH from the example's corpus (seed 19), and the
    iterator's epoch (``state_dict``)."""
    sent = [s for s in synthetic_corpus(200, LSTM["vocab_size"], 19)
            if len(s) <= max(LSTM_STEP_BUCKETS)]
    it = mx.rnn.BucketSentenceIter(sent, LSTM_STEP_BATCH,
                                   buckets=list(LSTM_STEP_BUCKETS),
                                   invalid_label=0)
    if state is not None:
        it.load_state(state)
    state = it.state_dict()
    batches = {}
    for b in it:
        batches.setdefault(b.bucket_key, b)
    return [batches[k] for k in LSTM_STEP_BUCKETS], it, state


def lstm_steps(ctx, start, state):
    """One ``forward_backward`` + ``update`` of each of phase 19's
    buckets from ``start``: {array: numpy} of each step's outputs,
    gradients and parameters after the update."""
    batches, it, _ = lstm_step_batches(state)
    mod = lstm_module(ctx, max(LSTM_STEP_BUCKETS))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=start)
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=dict(LSTM_OPT, momentum=0.9))
    out = {}
    for batch in batches:
        key = batch.bucket_key
        mod.forward_backward(batch)
        out["output@%d" % key] = mod.get_outputs()[0].asnumpy()
        ex = mod._curr_module._exec_group.executor
        out.update(("d%s@%d" % (n, key), g.asnumpy())
                   for n, g in ex.grad_dict.items())
        mod.update()
        out.update(("%s@%d" % (n, key), v.asnumpy())
                   for n, v in mod.get_params()[0].items())
    return out


def rnn_op_inputs(dev):
    """The RNN op's inputs at full width from seed 19, on ``dev``, each
    a leaf that takes a gradient; and a head gradient for each output."""
    c = RNN_OP
    g = torch.Generator().manual_seed(19)
    n = rnn_op.rnn_param_size(c["num_layers"], c["input"], c["state_size"],
                              c["mode"])
    st = (c["num_layers"], c["batch"], c["state_size"])
    ins = [torch.randn(c["seq"], c["batch"], c["input"], generator=g),
           torch.empty(n).uniform_(-0.1, 0.1, generator=g),
           0.5 * torch.randn(st, generator=g),
           0.5 * torch.randn(st, generator=g)]
    cots = [torch.randn(c["seq"], c["batch"], c["state_size"], generator=g),
            torch.randn(st, generator=g), torch.randn(st, generator=g)]
    return ([t.to(dev).requires_grad_(True) for t in ins],
            [t.to(dev) for t in cots])


def phase_rnn_op(dev, card):
    """Phase 19, the ``RNN`` op at full width (LSTM, 3 layers of 200,
    seq 32, batch 32, input 200, the last states as outputs): the op on
    the card (cuDNN through ``torch._VF``) against its plain version (the
    per-step loop) on the card, forward and the gradients of the data,
    the packed parameters and both initial states, each within
    RNN_OP_TOL x max|ref|; each fp32 route's distance from the loop in
    float64 printed (cuDNN's sigmoid and tanh are approximations); each
    route's forward timed."""
    c = RNN_OP
    attrs = dict(state_size=c["state_size"], num_layers=c["num_layers"],
                 mode=c["mode"], bidirectional=False, p=0.0,
                 state_outputs=True, pkeep_=1.0, lstm_q_=False)
    ins, cots = rnn_op_inputs(dev)
    ins64 = [t.detach().double().requires_grad_(True) for t in ins]
    res = {}
    for route, fn, xs, cs in (
            ("cudnn", rnn_op.rnn_apply, ins, cots),
            ("plain", rnn_op.rnn_plain, ins, cots),
            ("float64", rnn_op.rnn_plain, ins64, [c.double() for c in cots])):
        outs = fn(attrs, *xs, is_train=True)
        grads = torch.autograd.grad(outs, xs, cs)
        res[route] = [o.detach() for o in outs] + list(grads)
    exact = {route: max(float((a.double() - b).abs().max()) /
                        float(b.abs().max())
                        for a, b in zip(res[route], res["float64"]))
             for route in ("cudnn", "plain")}
    names = ("output", "state", "state_cell", "d_data", "d_parameters",
             "d_state", "d_state_cell")
    worst = {}
    for name, got, want in zip(names, res["cudnn"], res["plain"]):
        err = float((got - want).abs().max())
        worst[name] = err / (RNN_OP_TOL * float(want.abs().max()))
        if not (bool(torch.isfinite(got).all()) and worst[name] <= 1.0):
            raise SystemExit("chip_smoke: phase 19 RNN op %s: cuDNN off the "
                             "per-step loop by %.3e (%.2f x its bound)"
                             % (name, err, worst[name]))
    with torch.no_grad():
        ms = {route: time_ms(lambda f=fn: f(attrs, *ins), n=20)
              for route, fn in (("cudnn", rnn_op.rnn_apply),
                                ("plain", rnn_op.rnn_plain))}
    log("phase 19 RNN op (%s) on the card: cuDNN against the per-step "
        "loop, each error over its bound (%.0e x max|ref|): %s; worst "
        "distance from the loop in float64, of max|ref|: cuDNN %.3e, loop "
        "%.3e; forward %.3f ms (cuDNN) vs %.3f ms (loop) [%s]"
        % (RNN_OP, RNN_OP_TOL, "; ".join("%s %.3f" % kv
                                          for kv in worst.items()),
           exact["cudnn"], exact["plain"], ms["cudnn"], ms["plain"], card))


def state_net(batch):
    """An LSTM cell of 200 unrolled over 5 steps from explicit state
    inputs ``h0``/``c0`` (``state_names``); its outputs the merged
    sequence and the last states."""
    H = LSTM["num_hidden"]
    with mx.symbol.NameManager():
        cell = mx.rnn.LSTMCell(H, prefix="lstm_")
        outs, states = cell.unroll(
            5, inputs=mx.sym.Variable("data"), merge_outputs=True,
            begin_state=[mx.sym.Variable("h0", shape=(batch, H)),
                         mx.sym.Variable("c0", shape=(batch, H))])
        return mx.sym.Group([outs] + list(states))


def states_and_monitor(ctx, start, data, h0, c0):
    """Phase 19's ``state_names`` module on ``ctx``: ``set_states``
    (value, then arrays), ``get_states``, and one forward under a
    ``Monitor`` of every tensor.  Returns the outputs and the monitor's
    rows."""
    mod = mx.Module(state_net(data.shape[0]), label_names=None,
                    state_names=["h0", "c0"], context=ctx)
    mod.bind([("data", data.shape)], for_training=False)
    mod.init_params(arg_params=start)
    mod.set_states(value=0.5)
    got = [s.asnumpy() for s in mod.get_states()]
    if not all((g == 0.5).all() for g in got):
        raise SystemExit("chip_smoke: phase 19 set_states(value=0.5) read "
                         "back %s" % [np.unique(g)[:4] for g in got])
    mod.set_states(states=[mx.nd.array(h0, ctx=mx.cpu()),
                           mx.nd.array(c0, ctx=mx.cpu())])
    for g, w in zip(mod.get_states(), (h0, c0)):
        if not np.array_equal(g.asnumpy(), w):
            raise SystemExit("chip_smoke: phase 19 get_states differs "
                             "from set_states")
    mon = mx.monitor.Monitor(1, pattern=".*", sort=True)
    mod.install_monitor(mon)
    mon.tic()
    mod.forward(mx.io.DataBatch([mx.nd.array(data, ctx=mx.cpu())], []),
                is_train=False)
    return [o.asnumpy() for o in mod.get_outputs()], mon.toc()


def phase_lstm_vs_cpu(dev, card):
    """Phase 19: the LSTM LM's step on the card against the port's CPU
    (fp32, TF32 off): phase 18's width at batch 4, one ``forward_backward``
    and ``update`` (SGD, momentum 0.9, so the second bucket's update reads
    the first's momentum) of each of two buckets from the same Xavier
    start; every output, gradient and parameter within LSTM_STEP_TOL x
    max|ref|.  Then the RNN op (``phase_rnn_op``), and ``state_names``
    with ``set_states`` / ``get_states`` and a ``Monitor`` on the card
    against the CPU: the same rows, the outputs and every statistic
    within LSTM_STEP_TOL."""
    _, it, state = lstm_step_batches()
    mx.random.seed(19)
    init = lstm_module(mx.cpu(), max(LSTM_STEP_BUCKETS))
    init.bind(it.provide_data, it.provide_label)
    init.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    start = {k: v.asnumpy() for k, v in init.get_params()[0].items()}
    got, want = lstm_steps(dev, start, state), lstm_steps(mx.cpu(), start,
                                                          state)
    if sorted(got) != sorted(want):
        raise SystemExit("chip_smoke: phase 19 arrays differ: %s"
                         % sorted(set(got) ^ set(want)))
    worst = (0.0, "")
    for name, w in want.items():
        err = float(np.abs(got[name].astype(np.float64) - w).max())
        ratio = err / (LSTM_STEP_TOL * max(float(np.abs(w).max()), 1e-30))
        worst = max(worst, (ratio, name))
        if not ratio <= 1.0:
            raise SystemExit("chip_smoke: phase 19 %s off the CPU's by %.3e"
                             " (%.2f x its bound)" % (name, err, ratio))
    log("phase 19 LSTM LM step at batch %d, buckets %s, card vs CPU (fp32, "
        "TF32 off): %d outputs, gradients and parameters agree; worst %s at "
        "%.3f of %.0e x max|ref| [%s]"
        % (LSTM_STEP_BATCH, LSTM_STEP_BUCKETS, len(want), worst[1], worst[0],
           LSTM_STEP_TOL, card))
    phase_rnn_op(dev, card)
    H = LSTM["num_hidden"]
    rs = np.random.RandomState(19)
    data = rs.randn(LSTM_STEP_BATCH, 5, H).astype(np.float32)
    h0, c0 = (rs.randn(LSTM_STEP_BATCH, H).astype(np.float32)
              for _ in range(2))
    sstart = {k: v for k, v in start.items() if k.startswith("lstm_l0_")}
    sstart = {k.replace("lstm_l0_", "lstm_"): v for k, v in sstart.items()}
    (o_card, rows_card), (o_cpu, rows_cpu) = (
        states_and_monitor(ctx, sstart, data, h0, c0)
        for ctx in (dev, mx.cpu()))
    if [r[:2] for r in rows_card] != [r[:2] for r in rows_cpu]:
        raise SystemExit("chip_smoke: phase 19 monitor rows differ: %s vs "
                         "%s" % ([r[1] for r in rows_card][:8],
                                 [r[1] for r in rows_cpu][:8]))
    for (_, name, g), (_, _, w) in zip(rows_card, rows_cpu):
        g, w = float(g.split()[0]), float(w.split()[0])
        if not abs(g - w) <= LSTM_STEP_TOL * max(abs(w), 1e-30):
            raise SystemExit("chip_smoke: phase 19 monitor %s: %r vs %r"
                             % (name, g, w))
    for g, w in zip(o_card, o_cpu):
        if not np.abs(g - w).max() <= LSTM_STEP_TOL * np.abs(w).max():
            raise SystemExit("chip_smoke: phase 19 forward from set states "
                             "differs from the CPU's")
    log("phase 19 state_names h0/c0: set_states(value=) and "
        "set_states(states=) read back by get_states on the card; the "
        "forward from them equals the CPU's; Monitor: %d rows (%d op "
        "outputs and the arguments) with the CPU's names, each mean |x| "
        "within %.0e [%s]"
        % (len(rows_card), sum(r[1].endswith("_output") for r in rows_card),
           LSTM_STEP_TOL, card))


def lstm_head_rows(dev, card, entries):
    """Row 10's kernel pair at phase 18's head, 1024 x 10000 (batch 32 x
    bucket 32 rows of the vocabulary's logits): the kernels held against
    their plain versions (1e-5 x max|ref|), then timed with
    ``torch.softmax`` as the forward's yardstick."""
    rows, classes = LSTM_BATCH * LSTM_SEQ, LSTM["vocab_size"]
    g = torch.Generator(device="cpu").manual_seed(18)
    logits = torch.randn(rows, classes, generator=g).to(dev)
    label = torch.randint(0, classes, (rows,), generator=g).float().to(dev)
    p = softmax_xent.softmax_rows(logits)
    scale = 1.0 / LSTM_BATCH
    shape = "rows=%d classes=%d (phase 18's head)" % (rows, classes)
    n = rows * classes
    errs = {}
    for name, got, want in (
            ("softmax_rows", p, softmax_xent.softmax_rows_reference(logits)),
            ("xent_grad_from_probs",
             softmax_xent.xent_grad_from_probs(p, label, scale),
             softmax_xent.xent_grad_from_probs_reference(p, label, scale))):
        errs[name] = agree(name, shape, got, want,
                           1e-5 * float(want.abs().max()))
    entries["softmax_rows"].append(timed_row(
        "softmax_rows", shape, lambda: softmax_xent.softmax_rows(logits),
        lambda: softmax_xent.softmax_rows_reference(logits),
        lambda: torch.softmax(logits, -1), 4 * 2 * n, 5 * n,
        errs["softmax_rows"], card))
    entries["xent_grad_from_probs"].append(timed_row(
        "xent_grad_from_probs", shape,
        lambda: softmax_xent.xent_grad_from_probs(p, label, scale),
        lambda: softmax_xent.xent_grad_from_probs_reference(p, label, scale),
        None, 4 * (2 * n + rows), 2 * n, errs["xent_grad_from_probs"],
        card))


def time_ms(fn, n=60, flush=None):
    """Median device milliseconds of ``fn`` over ``n`` launches, queued
    behind a GPU spin so the launches run back to back; ``flush``: a call
    made before each launch, outside its events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        if flush is not None:
            flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def norm_bwd_cold_and_v1(row, kern, library, t, eps, card):
    """Add ``ms_cold`` and ``library_ms_cold`` to a norm backward's row,
    timed with L2 cold: ``COLD_L2_BYTES`` written before each launch,
    outside its events (which leaves L2 full of dirty lines); and
    ``v1_ms``: the v1 path, which the planner gives the same inputs one
    element (4 bytes fp32, 2 bf16) off 16-byte alignment, agreeing with
    the planned path within 1e-5 x max|ref| (fp32) or one bf16 ulp."""
    x1, dy1 = offset_copy(t["x"], 1), offset_copy(t["dy"], 1)
    fn = getattr(norm, kern)
    bf16 = t["x"].dtype == torch.bfloat16
    for a, b in zip(fn(x1, t["g"], dy1, eps), fn(t["x"], t["g"], t["dy"],
                                                 eps)):
        if bf16:
            agree_bf16(kern + "_bf16 v1 vs v3", row["shape"], a, b)
        else:
            agree(kern + " v1 vs v2", row["shape"], a, b,
                  1e-5 * b.abs().max().item())
    scratch = torch.empty(COLD_L2_BYTES // 4, device=t["x"].device)
    row["ms_cold"] = time_ms(lambda: fn(t["x"], t["g"], t["dy"], eps),
                             flush=scratch.zero_)
    row["library_ms_cold"] = time_ms(library, flush=scratch.zero_)
    row["v1_ms"] = time_ms(lambda: fn(x1, t["g"], dy1, eps))
    log("phase 5 %s%s %s: L2 cold: kernel %.6f ms, library %.6f ms; v1 "
        "path %.6f ms (warm) beside the kernel's %.6f [%s]"
        % (kern, "_bf16" if bf16 else "", row["shape"], row["ms_cold"],
           row["library_ms_cold"], row["v1_ms"], row["ms"], card))


def library_paged(q, kp, vp, tbl, pos, bs, kv_scales=None):
    """Gather K/V through the tables (int8 pools: and dequantize them),
    then one ``scaled_dot_product_attention`` with the offset-causal
    mask (the gather is inside the timing)."""
    B, H, Lq, D = q.shape
    T = tbl.shape[1]
    idx = (tbl.long()[:, :, None] * bs +
           torch.arange(bs, device=q.device)).reshape(B, T * bs)
    k = kp[:, idx].permute(1, 0, 2, 3)
    v = vp[:, idx].permute(1, 0, 2, 3)
    if kv_scales is not None:
        sk, sv = (torch.repeat_interleave(s[:, tbl.long()], bs, dim=2)
                  .permute(1, 0, 2)[..., None] for s in kv_scales)
        k = k.float() * sk
        v = v.float() * sv
    mask = (pos.long()[:, None, None] +
            torch.arange(Lq, device=q.device)[:, None]) >= \
        torch.arange(T * bs, device=q.device)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None])


def timed_row(name, shape, fn, plain, library, nbytes, flops, err, card,
              bf16=False, tf32=False):
    """Time ``fn``, its plain version and the library call (None where
    there is no single-call yardstick) beside the bound: the larger of
    ``nbytes`` over the memory rate and ``flops`` over the fp32 rate
    (``bf16``: over the bf16 tensor-core rate, the peak for bf16
    inputs; ``tf32``: over the TF32 tensor-core rate, the peak for fp32
    inputs, with the fp32 CUDA-core bound kept as
    ``bound_cuda_core_ms``)."""
    dev_name = torch.cuda.get_device_name(0)
    mem_rate, flop_rate, rate_name = card_rates(dev_name)
    t_bytes = nbytes / mem_rate * 1e3
    cuda_core_ms = max(t_bytes, flops / flop_rate * 1e3)
    if bf16:
        flop_rate, rate_name = bf16_rate(dev_name), rate_name + " bf16"
    if tf32:
        flop_rate, rate_name = tf32_rate(dev_name), rate_name + " TF32"
    ms, plain_ms = time_ms(fn), time_ms(plain)
    lib_ms = None if library is None else time_ms(library)
    t_ops = flops / flop_rate * 1e3
    row = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops, "max_abs_err": err}
    cc = ""
    if tf32:
        row["bound_cuda_core_ms"] = cuda_core_ms
        cc = "; fp32 CUDA-core bound %.6f ms" % cuda_core_ms
    log("phase 5 %s %s: kernel %.6f ms, plain %.6f ms, library %s, "
        "bound %.6f ms (%s, %s rates)%s [%s]"
        % (name, shape, ms, plain_ms,
           "none" if lib_ms is None else "%.6f ms" % lib_ms,
           row["bound_ms"], row["bound_by"], rate_name, cc, card))
    return row


def paged_row(dev, card, name, lq, B=PA["B"], note=""):
    """Time paged attention kernel ``name`` at the serving shapes with B
    sequences and Lq ``lq`` on the body ``_plan`` picks, against its
    plain version and
    the gather + SDPA yardstick (fp32 and int8: under the TF32
    tensor-core bound, the peak for fp32 q; bf16: the bf16 one), then
    ``v1_ms`` and ``other_ms``: v1 and the other new body (decode <->
    tile) on the same inputs, each held to phase 2's bound first."""
    dtype = PA_DTYPES[name]
    args, kw = paged_case(name, lq, dev, B=B)
    q, kp, vp, tbl, pos, bs = args
    kv = kw.get("kv_scales")
    plan = paged_attention._plan(B, PA["H"], lq, PA["D"], dtype,
                                 _build.sm_count(dev.index))
    shape = "B=%d H=%d Lq=%d D=%d bs=%d T=%d%s (%s, %d rows a CTA)%s" % (
        B, PA["H"], lq, PA["D"], bs, PA["T"],
        {torch.float32: "", torch.bfloat16: " bf16",
         torch.int8: " int8"}[dtype], plan.path, plan.block_q, note)

    def kern():
        return paged_attention.flash_attention_paged(*args, **kw)

    def plain():
        return paged_attention.paged_attention_reference(*args, **kw)

    want = plain()
    err = agree_paged(name, shape, kern(), want)
    if dtype == torch.float32:
        log("phase 5 library yardstick for paged attention: table gather + "
            "scaled_dot_product_attention, the gather inside the timing; "
            "Lq=%d vs plain: max_abs_err %.3e"
            % (lq, (library_paged(q, kp, vp, tbl, pos, bs) - want).abs()
               .max().item()))
    elem = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    nbytes, flops = paged_work(tbl, pos, lq, elem=elem)
    row = timed_row(name, shape, kern, plain,
                    lambda: library_paged(q, kp, vp, tbl, pos, bs, kv),
                    nbytes, flops, err, card, bf16=dtype == torch.bfloat16,
                    tf32=dtype != torch.bfloat16)
    other = "tile" if plan.path == "decode" else "decode"
    for key, path in (("v1_ms", "v1"), ("other_ms", other)):
        with paged_path(path):
            agree_paged(name, "%s on %s" % (shape, path), kern(), want)
            row[key] = time_ms(kern)
    row["path"], row["other_path"] = plan.path, other
    log("phase 5 %s %s: %s %.6f ms, v1 %.6f ms, %s %.6f ms [%s]"
        % (name, shape, plan.path, row["ms"], row["v1_ms"], other,
           row["other_ms"], card))
    return row


def offset_row(dev, card, dtype, B, Lk, lq, note=""):
    """Time ``flash_attention_offset`` in ``dtype`` at B H8 ``lq`` rows
    over ``Lk`` keys (D64, ragged offsets) on the body ``_plan`` picks,
    against its plain version and SDPA with the offset mask in the same
    dtype (bound: bytes at the dtype's width, operations at the fp32
    CUDA-core rate or, bf16, the bf16 tensor-core rate); then ``v1_ms``
    and ``other_ms``: v1 and the other new body (decode <-> tile) on the
    same inputs, each held to phase 2's bound first."""
    bf16 = dtype == torch.bfloat16
    name = "flash_attention_offset_bf16" if bf16 else "flash_attention_offset"
    q, k, v, ofs = offset_inputs(dev, B, Lk, lq, dtype)
    plan = flash_attention._plan(B, OFS["H"], lq, Lk, OFS["D"], dtype,
                                 _build.sm_count(dev.index))
    shape = "B=%d H=%d Lq=%d Lk=%d D=%d%s, ragged offsets (%s)%s" % (
        B, OFS["H"], lq, Lk, OFS["D"], " bf16" if bf16 else "", plan.path,
        note)

    def kern():
        return flash_attention.flash_attention_offset(q, k, v, ofs)

    def plain():
        return flash_attention.offset_attention_reference(q, k, v, ofs)

    want = plain()
    err = agree_fa(name, shape, kern(), want)
    mask = (ofs.long()[:, None, None, None] +
            torch.arange(lq, device=dev)[:, None] >=
            torch.arange(Lk, device=dev))              # (B, 1, lq, Lk)
    nbytes, flops = offset_work(ofs, lq, 2 if bf16 else 4)
    row = timed_row(name, shape, kern, plain,
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask),
                    nbytes, flops, err, card, bf16=bf16)
    other = "tile" if plan.path == "decode" else "decode"
    for key, path in (("v1_ms", "v1"), ("other_ms", other)):
        with flash_path(path):
            agree_fa(name, "%s on %s" % (shape, path), kern(), want)
            row[key] = time_ms(kern)
    row["path"], row["other_path"] = plan.path, other
    log("phase 5 %s %s: %s %.6f ms, v1 %.6f ms, %s %.6f ms [%s]"
        % (name, shape, plan.path, row["ms"], row["v1_ms"], other,
           row["other_ms"], card))
    return row


def norm_floors(dev, card, entries):
    """``floor_ms`` on every row of the norm forwards (rows 1, 1b, 3, 3b):
    the same call on one row, the floor of one launch: a body can take
    a row's time no lower, so a floor above twice a row's bound means
    no body brings that row to half its bound."""
    x, g, b = norm_inputs(1, dev)
    calls = {"rms_norm": lambda x, g, b: norm.rms_norm(x, g, 1e-6),
             "layer_norm": lambda x, g, b: norm.layer_norm(x, g, b, 1e-5)}
    for name, call in calls.items():
        for suffix, ins in (("", (x, g, b)), ("_bf16", bf16_inputs(x, g, b))):
            floor = time_ms(lambda call=call, ins=ins: call(*ins))
            for row in entries[name + suffix]:
                row["floor_ms"] = floor
            top = entries[name + suffix][-1]
            log("phase 5 %s%s on 1 row: %.6f ms (the launch floor); %s: "
                "%.6f ms, at half its bound (twice the bound's time) "
                "%.6f ms [%s]" % (name, suffix, floor, top["shape"],
                                  top["ms"], 2 * top["bound_ms"], card))


def phase_times(dev, card, errs, pa_shapes, fa_shapes):
    """The serving kernels at the serving path's shapes; paged attention
    also at each (B, Lq) of the serving phases' launches (``pa_shapes``,
    their census), the most frequent first; the offset kernel at B32
    Lk1024, then at each (B, Lk) of phases 3c's and 3e's launches
    (``fa_shapes``), then at the other Lq of ``OFS_TIMED_LQ``."""
    F = torch.nn.functional
    entries = {}

    def record(name, *args, bf16=False, tf32=False):
        entries.setdefault(name, []).append(timed_row(
            name, *args, card, bf16=bf16, tf32=tf32))

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
    # bf16: the same shapes, bytes at two an element (the tables and
    # positions stay int32)
    for rows in NORM_ROWS:
        x, g, b = bf16_inputs(*norm_inputs(rows, dev))
        n = rows * NORM_W
        shape = "rows=%d width=%d bf16" % (rows, NORM_W)
        record("rms_norm_bf16", shape, lambda: norm.rms_norm(x, g, 1e-6),
               lambda: norm.rms_norm_reference(x, g, 1e-6),
               lambda: F.rms_norm(x, (NORM_W,), g, 1e-6),
               2 * (2 * n + NORM_W), 4 * n, errs[("rms_norm_bf16", rows)],
               bf16=True)
        record("layer_norm_bf16", shape,
               lambda: norm.layer_norm(x, g, b, 1e-5),
               lambda: norm.layer_norm_reference(x, g, b, 1e-5),
               lambda: F.layer_norm(x, (NORM_W,), g, b, 1e-5),
               2 * (2 * n + 2 * NORM_W), 8 * n,
               errs[("layer_norm_bf16", rows)], bf16=True)
    norm_floors(dev, card, entries)
    for name in PA_DTYPES:
        census = sorted(((n, B, lq) for (kname, B, lq, _p), n
                         in pa_shapes.items() if kname == name),
                        key=lambda c: (-c[0], c[1:]))
        entries[name] = [
            paged_row(dev, card, name, lq, B, " (serving census, %d "
                      "launches)" % n) for n, B, lq in census] + [
            paged_row(dev, card, name, VERIFY_LQ, VERIFY_B,
                      " (the speculative verify, spec_k %d)" % SPEC_K)] + [
            paged_row(dev, card, name, lq) for lq in PA_TIMED_LQ[name]]
        row = entries[name][len(census)]
        log("phase 5 %s verify B%d Lq%d: planned %s %.6f ms, %s %.6f ms: "
            "%s faster (DECODE_MAX_LQ %d) [%s]"
            % (name, VERIFY_B, VERIFY_LQ, row["path"], row["ms"],
               row["other_path"], row["other_ms"],
               row["path"] if row["ms"] <= row["other_ms"]
               else row["other_path"],
               paged_attention.DECODE_MAX_LQ[PA_DTYPES[name]], card))
    for M in DQ_M:
        for N, K in DQ_NK:
            x, c, sc, w = dq_inputs(M, N, K, dev)
            record("dequant_matmul", "M=%d N=%d K=%d" % (M, N, K),
                   lambda: dequant_matmul.dequant_matmul(x, c, sc),
                   lambda: dequant_matmul.dequant_matmul_dense(x, c, sc),
                   lambda: torch.matmul(x, w.t()),
                   4 * M * K + N * K + 4 * N + 4 * M * N, 2 * M * N * K,
                   errs[("dequant_matmul", M, N, K)], tf32=True)
    for name, (dtype, offset) in FA_NAMES.items():
        if not offset:
            continue
        census = sorted(((n, B, Lk) for (kname, B, _h, lq, Lk, _d, _c, _p), n
                         in fa_shapes.items() if kname == name and lq == 1),
                        key=lambda c: (-c[0], c[1:]))
        entries[name] = [offset_row(dev, card, dtype, OFS["B"], OFS["Lk"], 1)]
        entries[name] += [
            offset_row(dev, card, dtype, B, Lk, 1, " (serving census, %d "
                       "launches)" % n) for n, B, Lk in census]
        entries[name] += [offset_row(dev, card, dtype, OFS["B"], OFS["Lk"], lq)
                          for lq in OFS_TIMED_LQ[dtype] if lq > 1]
    return entries


def autograd_backward(forward, inputs, cot):
    """A call that runs only the backward of ``forward(*inputs)`` for
    cotangent ``cot`` (the graph is kept between calls)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = forward(*leaves)
    return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)


def host_us(fn, n=200):
    """Host microseconds a call of ``fn`` takes to return (the wrapper's
    checks, the tensor maps' encoding, the launch; the device runs
    behind)."""
    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - tic) * 1e6 / n
    torch.cuda.synchronize()
    return us


def flash_row(dev, card, shape, q, k, v, causal, err):
    """Time ``flash_attention`` on ``q`` [B, H, Lq, D] over ``k``, ``v``
    against its plain version and SDPA in the input dtype, under the
    tensor-core bound for the inputs (fp32: TF32, the body's 3xTF32
    products take fp32 inputs; bf16: bf16, bytes at two an element);
    beside them the v1 body on the same inputs, held to phase 2's bound
    first.  bf16 (the wgmma body): also the mma.sync tile of earlier
    PRs (``tile_ms``) and the wrapper's host microseconds a call on
    wgmma and on the tile (``host_us``, ``tile_host_us``)."""
    bf16 = q.dtype == torch.bfloat16
    name = "flash_attention_bf16" if bf16 else "flash_attention"
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    pairs = B * H * (sum(min(i + 1, Lk) for i in range(Lq)) if causal
                     else Lq * Lk)

    def kern():
        return flash_attention.flash_attention(q, k, v, causal)

    row = timed_row(
        name, shape, kern,
        lambda: flash_attention.blockwise_attention(q, k, v, causal),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal),
        (2 if bf16 else 4) * B * H * D * (2 * Lq + 2 * Lk), 4 * D * pairs,
        err, card, bf16=bf16, tf32=not bf16)
    with flash_path("v1"):
        v1_err = agree_fa(name, "%s on v1" % shape, kern(),
                          flash_attention.blockwise_attention(q, k, v,
                                                              causal))
        row["v1_ms"] = time_ms(kern)
    log("phase 5 %s %s: v1 body %.6f ms (max_abs_err %.3e), kernel %.6f "
        "ms, library %.6f ms [%s]" % (name, shape, row["v1_ms"], v1_err,
                                      row["ms"], row["library_ms"], card))
    row["path"] = flash_attention._plan(B, H, Lq, Lk, D, q.dtype,
                                        _build.sm_count(dev.index)).path
    if row["path"] != "wgmma":
        return row
    with flash_path("tile"):
        agree_fa(name, "%s on tile" % shape, kern(),
                 flash_attention.blockwise_attention(q, k, v, causal))
        row["tile_ms"] = time_ms(kern)
        row["tile_host_us"] = host_us(kern)
    row["host_us"] = host_us(kern)
    log("phase 5 %s %s: wgmma %.6f ms, mma.sync tile %.6f ms, v1 %.6f ms, "
        "bf16 SDPA %.6f ms; wrapper host %.2f us a call (tile: %.2f) [%s]"
        % (name, shape, row["ms"], row["tile_ms"], row["v1_ms"],
           row["library_ms"], row["host_us"], row["tile_host_us"], card))
    return row


def prefill_flash_inputs(fa_shapes, dev):
    """Seeded ``(name, (q, k, v), causal, launches)`` at each shape of
    the serving phases' causal ``flash_attention`` launches (their
    prefills', fp32 and bf16), the most frequent first."""
    rs = np.random.RandomState(13)
    for (name, B, H, lq, lk, d, causal, _p), n in sorted(
            fa_shapes.items(), key=lambda kv: (-kv[1], kv[0])):
        dtype, offset = FA_NAMES[name]
        if offset:
            continue
        q = rs.randn(B, H, lq, d).astype(np.float32)
        k, v = (rs.randn(B, H, lk, d).astype(np.float32) for _ in range(2))
        yield (name, [torch.from_numpy(a).to(dev).to(dtype)
                      for a in (q, k, v)], bool(causal), n)


def phase_times_train(dev, card, errs, fa_shapes):
    """The training kernels at the training path's shapes, and
    ``flash_attention`` at the shapes of phases 3c's and 3e's prefill
    launches (``fa_shapes``, their census; 3e's in bf16), then the bf16
    rows (``bf16_train_rows``, ``xent_bf16_rows``).  Yardsticks: the
    autograd backward of ``F.rms_norm`` / ``F.layer_norm``,
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
    lib_rms = autograd_backward(
        lambda x, g: F.rms_norm(x, (W,), g, 1e-6), (t["x"], t["g"]),
        t["dy"])
    lib_ln = autograd_backward(
        lambda x, g, b: F.layer_norm(x, (W,), g, b, 1e-5),
        (t["x"], t["g"], t["b"]), t["dy"])
    record("rms_norm_bwd", "rms_norm_bwd", shape_n, lib_rms,
           4 * (3 * n + 2 * W), 12 * n)
    record("layer_norm_bwd", "layer_norm_bwd", shape_n, lib_ln,
           4 * (3 * n + 3 * W), 16 * n)
    for kern, library, eps in (("rms_norm_bwd", lib_rms, 1e-6),
                               ("layer_norm_bwd", lib_ln, 1e-5)):
        norm_bwd_cold_and_v1(entries[kern][0], kern, library, t, eps, card)
    record("softmax_rows", "softmax_rows", shape_v,
           lambda: torch.softmax(t["logits"], -1), 4 * 2 * nv, 5 * nv)
    record("xent_grad_from_probs", "xent_grad_from_probs", shape_v, None,
           4 * (2 * nv + TRAIN_ROWS), 2 * nv)
    rows = entries.setdefault("flash_attention", [])
    for causal in (True, False):
        rows.append(flash_row(
            dev, card, "B=%d H=%d L=%d D=%d causal=%s" % (B, H, L, D, causal),
            t["q"], t["k"], t["v"], causal, errs["flash_attention"]))
    for name, (q, k, v), causal, n in prefill_flash_inputs(fa_shapes, dev):
        shape = "B=%d H=%d Lq=%d Lk=%d D=%d causal=%s%s (phase %s prefill, " \
            "%d of its launches)" % (
                *q.shape[:3], k.shape[2], q.shape[3], causal,
                " bf16" if name.endswith("bf16") else "",
                "3e" if name.endswith("bf16") else "3c", n)
        err = agree_fa(name, shape, flash_attention.flash_attention(
            q, k, v, causal), flash_attention.blockwise_attention(
                q, k, v, causal))
        entries.setdefault(name, []).append(flash_row(
            dev, card, shape, q, k, v, causal, err))
    bf16_train_rows(dev, card, errs, t, entries)
    # the imperative plane's kernels; yardsticks F.cross_entropy (its
    # autograd backward for the gradient), the autograd backward of
    # torch.softmax, torch.addcmul
    lbl = t["label"].long()
    record("softmax_xent_loss", "softmax_xent_loss labels=random", shape_v,
           lambda: F.cross_entropy(t["logits"], lbl, reduction="none"),
           4 * (nv + 2 * TRAIN_ROWS), 4 * nv)
    record("softmax_xent_loss_grad", "softmax_xent_loss_grad labels=random",
           shape_v, autograd_backward(
               lambda x: F.cross_entropy(x, lbl, reduction="none"),
               (t["logits"],), t["gr"]),
           4 * (2 * nv + 2 * TRAIN_ROWS), 6 * nv)
    record("softmax_rows_bwd", "softmax_rows_bwd", shape_v,
           autograd_backward(lambda x: torch.softmax(x, -1), (t["logits"],),
                             t["dyv"]), 4 * 3 * nv, 4 * nv)
    xent_bf16_rows(card, errs, t, entries)
    resnet_head_rows(dev, card, entries)
    lstm_head_rows(dev, card, entries)
    k, xs, ys, out = rtc_fma1(t["logits"], t["dyv"])
    one = torch.ones((), device=dev)
    entries["rtc"] = [timed_row(
        "rtc", "fma1 %d elements" % nv, lambda: k.push([xs, ys], [out]),
        lambda: t["logits"] * t["dyv"] + 1,
        lambda: torch.addcmul(one, t["logits"], t["dyv"]), 4 * 3 * nv,
        2 * nv, errs["rtc"], card)]
    return entries


def resnet_head_rows(dev, card, entries):
    """Row 10's kernel pair at phase 13's head, 32 x 1000 (ResNet-50's
    logits at batch 32), beside the 4096 x 8192 rows: the kernels held
    against their plain versions (1e-5 x max|ref|), then timed with
    ``torch.softmax`` as the forward's yardstick."""
    rows, classes = RESNET["batch"], RESNET["num_classes"]
    g = torch.Generator(device="cpu").manual_seed(5)
    logits = torch.randn(rows, classes, generator=g).to(dev)
    label = torch.randint(0, classes, (rows,), generator=g).float().to(dev)
    p = softmax_xent.softmax_rows(logits)
    scale = 1.0 / rows
    shape = "rows=%d classes=%d (phase 13's head)" % (rows, classes)
    n = rows * classes
    errs = {}
    for name, got, want in (
            ("softmax_rows", p, softmax_xent.softmax_rows_reference(logits)),
            ("xent_grad_from_probs",
             softmax_xent.xent_grad_from_probs(p, label, scale),
             softmax_xent.xent_grad_from_probs_reference(p, label, scale))):
        errs[name] = agree(name, shape, got, want,
                           1e-5 * float(want.abs().max()))
    entries["softmax_rows"].append(timed_row(
        "softmax_rows", shape, lambda: softmax_xent.softmax_rows(logits),
        lambda: softmax_xent.softmax_rows_reference(logits),
        lambda: torch.softmax(logits, -1), 4 * 2 * n, 5 * n,
        errs["softmax_rows"], card))
    entries["xent_grad_from_probs"].append(timed_row(
        "xent_grad_from_probs", shape,
        lambda: softmax_xent.xent_grad_from_probs(p, label, scale),
        lambda: softmax_xent.xent_grad_from_probs_reference(p, label, scale),
        None, 4 * (2 * n + rows), 2 * n, errs["xent_grad_from_probs"],
        card))
    # row 10b: the bf16 pair at phase 13b's head (bf16 logits, p and
    # gradient, float32 labels), held to one bf16 ulp of max|ref|; 1000
    # classes on 16-byte aligned rows take the registers body with one
    # 16-byte load a lane (the .cu's bf16_row_loads, mirrored)
    xb = logits.to(torch.bfloat16)
    pb = softmax_xent.softmax_rows(xb)
    loads = bf16_row_loads(classes, xb, pb)
    if loads != 1:
        raise SystemExit("chip_smoke: softmax_rows_bf16 at %d x %d takes %d "
                         "loads a lane, not the registers body's one"
                         % (rows, classes, loads))
    shape_b = "rows=%d classes=%d bf16 (phase 13b's head; registers body, " \
        "%d 16-byte load a lane)" % (rows, classes, loads)
    for name, got, want in (
            ("softmax_rows_bf16", pb,
             softmax_xent.softmax_rows_reference(xb)),
            ("xent_grad_from_probs_bf16",
             softmax_xent.xent_grad_from_probs(pb, label, scale),
             softmax_xent.xent_grad_from_probs_reference(pb, label, scale))):
        errs[name] = agree_bf16(name, shape_b, got, want)
    entries["softmax_rows_bf16"].append(timed_row(
        "softmax_rows_bf16", shape_b, lambda: softmax_xent.softmax_rows(xb),
        lambda: softmax_xent.softmax_rows_reference(xb),
        lambda: torch.softmax(xb, -1), 2 * 2 * n, 5 * n,
        errs["softmax_rows_bf16"], card, bf16=True))
    entries["xent_grad_from_probs_bf16"].append(timed_row(
        "xent_grad_from_probs_bf16", shape_b,
        lambda: softmax_xent.xent_grad_from_probs(pb, label, scale),
        lambda: softmax_xent.xent_grad_from_probs_reference(pb, label,
                                                            scale),
        None, 2 * 2 * n + 4 * rows, 2 * n, errs["xent_grad_from_probs_bf16"],
        card, bf16=True))


def bf16_row_loads(cols, *tensors):
    """The 16-byte loads a lane of the bf16 registers kernels makes on
    rows of ``cols`` at ``tensors`` (``bf16_row_loads`` of
    ``csrc/softmax_xent.cu``: 8 elements a load, 256 threads, at most 4
    loads, every base 16-byte aligned), or 0 where the scalar body runs."""
    loads = (cols // 8 + 255) // 256
    aligned = cols % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return loads if cols % 8 == 0 and loads <= 4 and aligned else 0


def bf16_train_rows(dev, card, errs, t, entries):
    """Phase 6b's kernels at its shapes, in bf16 (two bytes an element;
    the bf16 tensor-core rate for operations): the norm backwards at
    4096 x 512 on v3, with L2 cold and beside their v1 path (rows 2 bytes
    off alignment) as ``norm_bwd_cold_and_v1`` adds them, the v2 body on
    the same inputs (``v2_ms``), the fp32 row of this call (``fp32_ms``)
    and the same call on 8 rows (``floor_ms``: two dependent launches
    that move almost no bytes); the head's softmax and gradient at 4096
    x 8192, ``flash_attention_bf16`` at B16 H8 L256 D64 causal.
    Yardsticks in bf16: the autograd backward of ``F.rms_norm`` /
    ``F.layer_norm``, ``torch.softmax``, SDPA; the gradient has no
    single-call yardstick."""
    F = torch.nn.functional
    W, V = SPEC["num_hidden"], SPEC["vocab_size"]
    n, nv = TRAIN_ROWS * W, TRAIN_ROWS * V
    b = {k: t[k].to(torch.bfloat16) for k in ("x", "dy", "g", "b", "logits",
                                              "q", "k", "v")}
    p = softmax_xent.softmax_rows(b["logits"])
    scale = 1.0 / TRAIN_ROWS
    shape_n = "rows=%d width=%d bf16" % (TRAIN_ROWS, W)
    shape_v = "rows=%d classes=%d bf16" % (TRAIN_ROWS, V)
    for name, eps, lib, nbytes, flops in (
            ("rms_norm_bwd", 1e-6, autograd_backward(
                lambda x, g: F.rms_norm(x, (W,), g, 1e-6),
                (b["x"], b["g"]), b["dy"]), 2 * (3 * n + 2 * W), 12 * n),
            ("layer_norm_bwd", 1e-5, autograd_backward(
                lambda x, g, bb: F.layer_norm(x, (W,), g, bb, 1e-5),
                (b["x"], b["g"], b["b"]), b["dy"]), 2 * (3 * n + 3 * W),
             16 * n)):
        fn = getattr(norm, name)
        plain = getattr(norm, name + "_reference")
        row = timed_row(name + "_bf16", shape_n,
                        lambda fn=fn, eps=eps: fn(b["x"], b["g"], b["dy"],
                                                  eps),
                        lambda plain=plain, eps=eps: plain(
                            b["x"], b["g"], b["dy"], eps),
                        lib, nbytes, flops, errs[name + "_bf16"], card,
                        bf16=True)
        row["path"] = norm._bwd_path(
            W, norm._bwd_align(b["x"], b["g"], b["dy"]), torch.bfloat16)
        if row["path"] != "v3":
            raise SystemExit("chip_smoke: %s_bf16 %s planned on %s"
                             % (name, shape_n, row["path"]))
        norm_bwd_cold_and_v1(row, name, lib, b, eps, card)
        with norm_path("v2"):
            for a, ref in zip(fn(b["x"], b["g"], b["dy"], eps),
                              plain(b["x"], b["g"], b["dy"], eps)):
                agree_bf16(name + "_bf16 v2", shape_n, a, ref)
            row["v2_ms"] = time_ms(lambda fn=fn, eps=eps: fn(
                b["x"], b["g"], b["dy"], eps))
        row["fp32_ms"] = entries[name][0]["ms"]
        # the floor of the call's two dependent launches: the same call on
        # 8 of the rows, which move almost no bytes
        x8, dy8 = b["x"][:8], b["dy"][:8]
        row["floor_ms"] = time_ms(lambda fn=fn, eps=eps: fn(x8, b["g"], dy8,
                                                            eps))
        log("phase 5 %s_bf16 %s: v3 %.6f ms beside, in this call, the v2 "
            "body's %.6f (%.3f of it) and the fp32 row's %.6f (%.3f of it); "
            "%.2f x its bound; the same call on 8 rows %.6f [%s]"
            % (name, shape_n, row["ms"], row["v2_ms"],
               row["ms"] / row["v2_ms"], row["fp32_ms"],
               row["ms"] / row["fp32_ms"], row["ms"] / row["bound_ms"],
               row["floor_ms"], card))
        entries[name + "_bf16"] = [row]
    entries["softmax_rows_bf16"] = [timed_row(
        "softmax_rows_bf16", shape_v,
        lambda: softmax_xent.softmax_rows(b["logits"]),
        lambda: softmax_xent.softmax_rows_reference(b["logits"]),
        lambda: torch.softmax(b["logits"], -1), 2 * 2 * nv, 5 * nv,
        errs["softmax_rows_bf16"], card, bf16=True)]
    entries["xent_grad_from_probs_bf16"] = [timed_row(
        "xent_grad_from_probs_bf16", shape_v,
        lambda: softmax_xent.xent_grad_from_probs(p, t["label"], scale),
        lambda: softmax_xent.xent_grad_from_probs_reference(p, t["label"],
                                                            scale),
        None, 2 * 2 * nv + 4 * TRAIN_ROWS, 2 * nv,
        errs["xent_grad_from_probs_bf16"], card, bf16=True)]
    B, H, L, D = TRAIN_ATT
    shape = "B=%d H=%d L=%d D=%d causal=True bf16 (phase 6b)" % (B, H, L, D)
    err = agree_fa("flash_attention_bf16", shape,
                   flash_attention.flash_attention(b["q"], b["k"], b["v"],
                                                   True),
                   flash_attention.blockwise_attention(b["q"], b["k"],
                                                       b["v"], True))
    entries.setdefault("flash_attention_bf16", []).append(flash_row(
        dev, card, shape, b["q"], b["k"], b["v"], True, err))


def xent_bf16_rows(card, errs, t, entries):
    """Phase 8b's loss kernels at 4096 x 8192 bf16 (float32 labels, g and
    loss: 4 bytes a row each), each beside the fp32 row 11 timed in the
    same call (``fp32_ms``).  Yardsticks: bf16 ``F.cross_entropy(...,
    reduction='none')`` and its autograd backward."""
    F = torch.nn.functional
    V = SPEC["vocab_size"]
    nv = TRAIN_ROWS * V
    x = t["logits"].to(torch.bfloat16)
    lbl, gr = t["label"], t["gr"]
    lbl_long = lbl.long()
    shape = "rows=%d classes=%d bf16" % (TRAIN_ROWS, V)
    for name, fn, plain, library, nbytes, flops in (
            ("softmax_xent_loss_bf16",
             lambda: softmax_xent.xent_loss_rows(x, lbl),
             lambda: softmax_xent.xent_loss_rows_reference(x, lbl),
             lambda: F.cross_entropy(x, lbl_long, reduction="none"),
             2 * nv + 4 * 2 * TRAIN_ROWS, 4 * nv),
            ("softmax_xent_loss_grad_bf16",
             lambda: softmax_xent.softmax_xent_loss_grad(x, lbl, gr),
             lambda: softmax_xent.softmax_xent_loss_grad_reference(x, lbl,
                                                                   gr),
             autograd_backward(
                 lambda a: F.cross_entropy(a, lbl_long, reduction="none"),
                 (x,), gr.to(torch.bfloat16)),
             2 * 2 * nv + 4 * 2 * TRAIN_ROWS, 6 * nv)):
        row = timed_row(name, shape, fn, plain, library, nbytes, flops,
                        errs[name], card, bf16=True)
        row["fp32_ms"] = entries[name[:-len("_bf16")]][0]["ms"]
        log("phase 5 %s %s: kernel %.6f ms beside the fp32 row's %.6f ms in "
            "this call (%.3f of it) [%s]" % (name, shape, row["ms"],
                                             row["fp32_ms"],
                                             row["ms"] / row["fp32_ms"],
                                             card))
        entries[name] = [row]


def kernel_rows(entries, counts):
    """The ``kernels`` JSON rows: the first shape of each kernel (the
    path's own) at the top level, every timed shape under ``shapes``;
    ``launches`` sums the main paths' runs (``counts``: phase -> launch
    counts of that run alone), ``launches_by_phase`` splits them."""
    out = []
    for name, rows in entries.items():
        head = rows[0]
        src, replaces = SOURCES[name]
        by_phase = {ph: c[name] for ph, c in counts.items()}
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "train_launches_per_step": TRAIN_LAUNCHES_PER_STEP.get(name, 0),
            "train_bf16_launches_per_step":
                TRAIN_BF16_LAUNCHES_PER_STEP.get(name, 0),
            "imperative_launches_per_step":
                IMPERATIVE_LAUNCHES_PER_STEP.get(name, 0),
            "imperative_bf16_launches_per_step":
                IMPERATIVE_BF16_LAUNCHES_PER_STEP.get(name, 0),
            "resnet_launches_per_step":
                RESNET_LAUNCHES_PER_STEP.get(name, 0),
            "resnet_bf16_launches_per_step":
                RESNET_BF16_LAUNCHES_PER_STEP.get(name, 0),
            "lstm_launches_per_step": LSTM_LAUNCHES_PER_STEP.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "shapes": rows})
        for key in ("bound_cuda_core_ms", "v1_ms", "v2_ms", "floor_ms",
                    "ms_cold",
                    "library_ms_cold", "path", "other_path", "other_ms",
                    "fp32_ms", "tile_ms", "host_us", "tile_host_us"):
            if key in head:
                out[-1][key] = head[key]
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
    reqs = make_requests()
    served = {tag: phase_serve(tag, name, params, reqs)
              for tag, name in (("3", "lm"), ("3b", "lm8"), ("3c", "lmc"),
                                ("3d", "lm16"), ("3e", "lmc16"))}
    log("phase 3b %.3f ms per step (int8 weights through dequant_matmul) "
        "vs phase 3 %.3f ms per step (fp32) [%s]"
        % (served["3b"]["step_ms"], served["3"]["step_ms"], card))
    phase_int8_bytes(served["3"], served["3b"])
    phase_bf16_bytes(served["3"], served["3d"])
    phase_contiguous_bf16_bytes(served["3c"], served["3e"])
    phase_contiguous_vs_paged(
        served["3c"], served["3"], reqs,
        tlm.TransformerLM.from_numpy(params, SPEC, device="cpu"))
    phase_spec_runs(params, reqs, served)
    for tag, name in (("4", "lm"), ("4b", "lm8"), ("4c", "lm16"),
                      ("4d", "lmc16")):
        phase_card_vs_cpu(tag, name, params,
                          served[CARD_VS_CPU[tag][0]], reqs)
    counts = {"serve_" + tag: served[tag]["counts"] for tag in served}
    counts["train"], step_ms = phase_train(dev, card)
    if argv:
        profile_train(dev, card, step_ms)
    counts["train_bf16"], step_ms_bf16 = phase_train(dev, card, "bfloat16",
                                                     step_ms)
    if argv:
        profile_train(dev, card, step_ms_bf16, "bfloat16")
    params7, module_card = phase_train_vs_cpu(dev)
    module_card_bf16 = phase_train_bf16_vs_cpu(dev, params7)
    counts["imperative"], step_ms_imp = phase_imperative(card, step_ms)
    counts["imperative_bf16"], _ = phase_imperative(
        card, step_ms_bf16, "bfloat16", step_ms_imp)
    cpu32 = phase_imperative_vs(params7, module_card)
    phase_imperative_bf16_vs(params7, module_card_bf16, cpu32)
    phase_op_sweep(dev, card)
    phase_layer_sweep(dev, card)
    counts["recommender"], step_ms_mf = phase_recommender(dev, card)
    if argv:
        profile_recommender(dev, card, step_ms_mf)
    phase_recommender_vs_cpu(dev)
    counts["resnet"], step_ms_rn = phase_resnet(dev, card)
    if argv:
        profile_resnet(dev, card, step_ms_rn)
    phase_resnet_vs_cpu(dev, card)
    counts["resnet_bf16"], step_ms_rn16 = phase_resnet(dev, card, "bfloat16",
                                                       step_ms_rn)
    if argv:
        profile_resnet(dev, card, step_ms_rn16, "bfloat16")
    phase_resnet_vs_cpu(dev, card, "bfloat16")
    counts["score"], score_rates = phase_score(dev, card)
    counts["zoo"] = phase_zoo_train(dev, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        counts["resume"] = phase_resume(dev, card, workdir)
    counts["lstm"], step_ms_lstm = phase_lstm(dev, card)
    counts["lstm_buckets"] = phase_lstm_buckets(dev, card, step_ms_lstm)
    phase_lstm_vs_cpu(dev, card)
    pa_shapes, fa_shapes = collections.Counter(), collections.Counter()
    for tag in ("3", "3b", "3d"):
        pa_shapes.update(served[tag]["pa_shapes"])
    for tag in ("3c", "3e"):
        fa_shapes.update(served[tag]["fa_shapes"])
    kern = kernel_rows(phase_times(dev, card, errs, pa_shapes, fa_shapes),
                       counts)
    kern += kernel_rows(phase_times_train(dev, card, errs, fa_shapes), counts)
    for tag, what in (("3", "paged fp32"), ("3b", "paged int8"),
                      ("3c", "contiguous fp32"), ("3d", "paged bf16"),
                      ("3e", "contiguous bf16"),
                      ("3f", "paged fp32, self-draft"),
                      ("3f8", "paged int8, self-draft"),
                      ("3g", "paged fp32, friendly draft"),
                      ("3ga", "paged fp32, adversarial draft")):
        log("phase 5 engine %s: %.1f generated tokens/s at full width [%s]"
            % (what, served[tag]["tok_s"], card))
    log("phase 15 scoring images/s at batch %d, fp32: %s [%s]"
        % (SCORE_BATCH, "; ".join("%s %.1f" % kv
                                  for kv in score_rates.items()), card))
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
