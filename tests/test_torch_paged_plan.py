"""The CUDA ``flash_attention_paged``'s launch planner and the arithmetic of
its tensor-core tile, on the CPU.

The kernel runs only on a card (``tests/test_torch_cuda.py``).  What
decides its launch and its numbers is checked here:

* ``_plan``: the decode body (one query row a CTA) up to
  ``DECODE_MAX_LQ`` of the pool dtype, the tile above, v1 for D above
  128, and the tile's 32 or 16 query rows a CTA; the card route makes
  one launch that carries the plan's path and rows;
* the tile's arithmetic, emulated in plain torch step for step as
  ``csrc/paged_attention.cu`` takes it: 64-key stages whose keys are
  split among the warps that share 16 query rows, each warp's online
  softmax, its partials merged in key order; each mma k-step's exact
  products summed once into an fp32 accumulator; fp32 pools in 3xTF32
  (hi = TF32 rounded to nearest, ties away, lo = x - hi truncated by the
  tensor core; lo.hi + hi.lo + hi.hi), int8 pools in 2xTF32 on the exact
  codes (q_hi.c + q_lo.c) with each key's K scale on S and its V scale
  folded into p, bf16 pools with Q K^T exact in 16-wide k-steps and P
  split into two bf16 terms for P.V.

The emulation is held against ``mxnet_tpu``'s Pallas
``flash_attention_paged`` in interpret mode and the port's plain
``paged_attention_reference``: fp32 and int8 within 1e-4 absolute, bf16
within one bf16 ulp of max|ref| plus 1e-4 (the card check's bounds).
The error of the cheaper arithmetic (one TF32 pass; P rounded once to
bf16) is recorded as a test property, not held to a bound.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_ops.paged_attention import \
    flash_attention_paged as jax_flash_attention_paged
from mxnet_tpu_torch.kernels import paged_attention as pa
from test_torch_cuda import bf16_ulp, int8_paged_case, paged_case

H100_SMS = 132
NEG = -1e30
STAGE = 64          # keys a stage of the tile
TOL = 1e-4
F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,Lq,D,dtype,want", [
    # the serving path: decode steps and 32-token prefill chunks, D 64
    (32, 8, 1, 64, F32, ("decode", 1, (1, 8, 32))),
    (32, 8, 1, 64, BF16, ("decode", 1, (1, 8, 32))),
    (32, 8, 1, 64, I8, ("decode", 1, (1, 8, 32))),
    (32, 8, 32, 64, F32, ("tile", 32, (1, 8, 32))),
    (32, 8, 32, 64, BF16, ("tile", 32, (1, 8, 32))),
    (32, 8, 32, 64, I8, ("tile", 32, (1, 8, 32))),
    (16, 8, 32, 64, F32, ("tile", 16, (2, 8, 16))),
    # the threshold's edges: the largest decode Lq and one past it
    (32, 8, 2, 64, F32, ("tile", 32, (1, 8, 32))),
    (32, 8, 2, 64, BF16, ("tile", 32, (1, 8, 32))),
    (32, 8, 4, 64, I8, ("decode", 1, (4, 8, 32))),
    (32, 8, 5, 64, I8, ("decode", 1, (5, 8, 32))),
    (32, 8, 33, 64, F32, ("tile", 32, (2, 8, 32))),
    # too few 32-row CTAs for the card: 16 rows a CTA
    (1, 8, 32, 64, F32, ("tile", 16, (2, 8, 1))),
    (3, 2, 33, 64, BF16, ("tile", 16, (3, 2, 3))),
    (3, 2, 1, 8, F32, ("decode", 1, (1, 2, 3))),
    # head dims: 128 and below on the new bodies, above on v1
    (32, 8, 32, 128, F32, ("tile", 32, (1, 8, 32))),
    (32, 8, 32, 100, F32, ("tile", 32, (1, 8, 32))),
    (32, 8, 1, 136, F32, ("v1", 1, (1, 8, 32))),
    (32, 8, 32, 256, BF16, ("v1", 16, (2, 8, 32))),
    (3, 2, 33, 256, I8, ("v1", 16, (3, 2, 3))),
    # the speculative verify (spec_k 4): Lq 5 at B16, and int8's edge
    (16, 8, 5, 64, F32, ("tile", 16, (1, 8, 16))),
    (16, 8, 5, 64, BF16, ("tile", 16, (1, 8, 16))),
    (16, 8, 5, 64, I8, ("decode", 1, (5, 8, 16))),
    (32, 8, 6, 64, I8, ("tile", 32, (1, 8, 32))),
])
def test_plan_path_rows_and_grid(B, H, Lq, D, dtype, want):
    assert tuple(pa._plan(B, H, Lq, D, dtype, H100_SMS)) == want


@pytest.mark.parametrize("dtype", [F32, BF16, I8])
def test_plan_threshold_splits_lq(dtype):
    """Every Lq up to the threshold takes the decode body, every Lq above
    it the tile; each plan's grid covers Lq rows exactly once."""
    for Lq in range(1, 70):
        plan = pa._plan(32, 8, Lq, 64, dtype, H100_SMS)
        assert plan.path == ("decode" if Lq <= pa.DECODE_MAX_LQ[dtype]
                             else "tile")
        assert plan.grid[0] * plan.block_q >= Lq
        assert (plan.grid[0] - 1) * plan.block_q < Lq


@pytest.fixture
def card_route(monkeypatch):
    """The wrapper's card route on CPU tensors, with the launches
    recorded instead of made."""
    launches = []
    monkeypatch.setattr(pa, "route", lambda name, x: True)
    monkeypatch.setattr(pa, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(pa, "launch", lambda *a: launches.append(a))
    return launches


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype,lq", [(F32, 1), (F32, 32), (BF16, 1),
                                      (BF16, 33), (I8, 4), (I8, 5)])
def test_card_route_makes_one_launch_with_the_plan(card_route, dtype, lq):
    B, H, D = 3, 2, 64
    if dtype == I8:
        q, kp, vp, tbl, pos, sk, sv = _t(*int8_paged_case(
            0, B, H, T=10, D=D, bs=8, num_blocks=40, positions=[0, 7, 40],
            lq=lq))
        kw = {"kv_scales": (sk, sv)}
    else:
        q, kp, vp, tbl, pos = _t(*paged_case(
            0, B, H, T=10, D=D, bs=8, num_blocks=40, positions=[0, 7, 40],
            lq=lq))
        q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
        kw = {}
    out = pa.flash_attention_paged(q, kp, vp, tbl, pos, 8, **kw)
    assert out.shape == q.shape and out.dtype == q.dtype
    (args,) = card_route
    name, entry, _mult = pa._VARIANTS[dtype]
    assert args[1:3] == (name, entry)
    plan = pa._plan(B, H, lq, D, dtype, H100_SMS)
    # ..., B, H, Lq, D, T, block_size, pool_rows, scale, path, block_q
    assert args[-10:-6] == (B, H, lq, D)
    assert args[-2:] == (pa._PATH[plan.path], plan.block_q)


def test_card_route_widens_a_bf16_query_over_int8(card_route):
    q, kc, vc, tbl, pos, sk, sv = _t(*int8_paged_case(
        1, B=3, H=2, T=10, D=64, bs=8, num_blocks=40, positions=[0, 3, 12],
        lq=1))
    out = pa.flash_attention_paged(q.to(BF16), kc, vc, tbl, pos, 8,
                                   kv_scales=(sk, sv))
    assert out.dtype == BF16
    (args,) = card_route
    assert args[1] == "flash_attention_paged_int8"
    assert args[-2:] == (pa._PATH["decode"], 1)


# ---------------------------------------------------------------------------
# the tile's arithmetic
# ---------------------------------------------------------------------------
def tf32_rna(x):
    """fp32 to TF32 as ``cvt.rna.tf32.f32``: nearest, halves away from
    zero (add half a TF32 ulp to the pattern, clear the low 13 bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """The TF32 value the tensor core reads: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def bf16(x):
    return x.to(BF16).float()


def mma_sum(acc, a, b, k, passes):
    """``acc + a @ b`` as a chain of mma.sync adds it: per k-step of
    ``k``, for each ``(a part, b part)`` of ``passes`` in order, the
    step's exact products summed once and added to the fp32
    accumulator."""
    for k0 in range(0, a.shape[-1], k):
        for pa_, pb in passes(a[..., k0:k0 + k], b[k0:k0 + k]):
            acc = acc + (pa_.double() @ pb.double()).float()
    return acc


def three_tf32(a, b):              # fp32 pools: lo.hi, hi.lo, hi.hi
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return ((al, bh), (ah, bl), (ah, bh))


def two_tf32(a, b):                # int8 pools: b holds exact codes
    ah, al = split_tf32(a)
    return ((al, b), (ah, b))


def one_tf32(a, b):                # the cheaper variant, recorded
    return ((tf32_rna(a), tf32_rna(b)),)


def exact(a, b):                   # bf16 Q K^T: exact products
    return ((a, b),)


def p_split_bf16(p, v):            # bf16 P.V: p = hi + lo, two terms
    hi = bf16(p)
    return ((bf16(p - hi), v), (hi, v))


def p_once_bf16(p, v):             # the cheaper variant, recorded
    return ((bf16(p), v),)


ARITH = {   # pool kind -> (Q K^T passes, P.V passes, mma k)
    "fp32": (three_tf32, three_tf32, 8), "int8": (two_tf32, two_tf32, 8),
    "bf16": (exact, p_split_bf16, 16)}


def emulate(q, kp, vp, tables, positions, bs, kind, kv_scales=None,
            qk=None, pv=None, block_q=32):
    """The tile body's forward on CPU tensors: q (B, H, Lq, D) fp32 (the
    bf16 values for ``kind`` bf16), pools (H, rows, D) (int8: codes,
    ``kv_scales`` (H, num_blocks)); the output in fp32 (bf16: rounded to
    bf16).  ``qk``/``pv`` replace the kind's passes."""
    qk_passes, pv_passes, k = ARITH[kind]
    qk, pv = qk or qk_passes, pv or pv_passes
    B, H, Lq, D = q.shape
    T = tables.shape[1]
    DP = 64 if D <= 64 else 128
    scale = 1.0 / D ** 0.5
    out = torch.zeros(B, H, Lq, D)
    for b in range(B):
        pos = int(positions[b])
        for q0 in range(0, Lq, block_q):
            nq = min(block_q, Lq - q0)
            n_keys = min(pos + q0 + nq, T * bs)
            keys = torch.arange(-(-n_keys // STAGE) * STAGE)
            live = keys < n_keys
            blk = tables[b, torch.clamp(keys // bs, max=T - 1)].long()
            rows = blk * bs + keys % bs
            rbs = 2 if nq > 16 else 1
            kw = STAGE // (4 // rbs)
            for h in range(H):
                K = torch.zeros(len(keys), DP)
                V = torch.zeros(len(keys), DP)
                K[:, :D] = torch.where(live[:, None], kp[h, rows].float(), 0)
                V[:, :D] = torch.where(live[:, None], vp[h, rows].float(), 0)
                if kind == "int8":
                    sk = torch.where(live, kv_scales[0][h, blk], 0)
                    sv = torch.where(live, kv_scales[1][h, blk], 0)
                for rb in range(rbs):
                    r0 = 16 * rb
                    n_rows = min(16, nq - r0)
                    Q = torch.zeros(16, DP)
                    Q[:n_rows, :D] = q[b, h, q0 + r0:q0 + r0 + n_rows].float()
                    row_pos = pos + q0 + r0 + torch.arange(16)
                    warp_keys = min(pos + q0 + min(r0 + 16, nq), n_keys)
                    parts = []
                    for part in range(4 // rbs):
                        m = torch.full((16,), NEG)
                        l = torch.zeros(16)
                        o = torch.zeros(16, DP)
                        for k0 in range(part * kw, len(keys), STAGE):
                            if warp_keys - k0 <= 0:
                                continue
                            ks = slice(k0, k0 + kw)
                            s = mma_sum(torch.zeros(16, kw), Q, K[ks].t(), k,
                                        qk)
                            if kind == "int8":
                                s = s * sk[ks]
                            s = s * scale
                            kpos = keys[ks]
                            vis = (kpos[None] <= row_pos[:, None]) & \
                                (kpos[None] < n_keys)
                            s = torch.where(vis, s, NEG)
                            m_new = torch.maximum(m, s.amax(1))
                            alpha = torch.exp(m - m_new)
                            p = torch.where(vis, torch.exp(s - m_new[:, None]),
                                            0)
                            l = l * alpha + p.sum(1)
                            m = m_new
                            if kind == "int8":
                                p = p * sv[ks]
                            o = o * alpha[:, None] + mma_sum(
                                torch.zeros(16, DP), p, V[ks], k, pv)
                        parts.append((m, l, o))
                    mx = torch.stack([pm for pm, _, _ in parts]).amax(0)
                    f = torch.exp(parts[0][0] - mx)
                    lsum, acc = parts[0][1] * f, parts[0][2] * f[:, None]
                    for pm, pl, po in parts[1:]:
                        f = torch.exp(pm - mx)
                        lsum = lsum + pl * f
                        acc = acc + po * f[:, None]
                    res = acc / torch.where(lsum > 0, lsum, 1)[:, None]
                    out[b, h, q0 + r0:q0 + r0 + n_rows] = res[:n_rows, :D]
    return bf16(out) if kind == "bf16" else out


def tile_case(kind, D, lq, positions, seed):
    """(numpy case, torch case, kv_scales) for ``kind``: B3 H2, 8-token
    blocks; every sequence after the first shares sequence 0's first
    block."""
    if kind == "int8":
        q, kc, vc, tbl, pos, sk, sv = int8_paged_case(
            seed, B=3, H=2, T=10, D=D, bs=8, num_blocks=40,
            positions=positions, lq=lq)
        arrays = (q, kc, vc, tbl, pos)
        return arrays, _t(*arrays), (sk, sv)
    arrays = paged_case(seed, B=3, H=2, T=10, D=D, bs=8, num_blocks=40,
                        positions=positions, lq=lq)
    if kind == "bf16":   # bf16 values, carried in fp32
        arrays = tuple(bf16(torch.from_numpy(a)).numpy() if i < 3 else a
                       for i, a in enumerate(arrays))
    return arrays, _t(*arrays), None


def bound(kind, want):
    if kind == "bf16":
        return bf16_ulp(want.abs().max().item()) + TOL
    return TOL


# (kind, D, Lq, positions): the smallest tile Lq, the prefill chunk and
# one past it; positions 0 and T * bs - Lq
TILE_CASES = [
    ("fp32", 8, 2, [0, 3, 78]), ("fp32", 64, 32, [0, 17, 48]),
    ("fp32", 64, 33, [47, 0, 5]), ("fp32", 100, 32, [0, 9, 48]),
    ("int8", 16, 5, [0, 31, 75]), ("int8", 64, 32, [48, 0, 20]),
    ("int8", 64, 33, [0, 47, 8]),
    ("bf16", 8, 2, [0, 50, 78]), ("bf16", 64, 32, [0, 48, 13]),
    ("bf16", 64, 33, [47, 0, 30])]


@pytest.mark.parametrize("kind,D,lq,positions", TILE_CASES)
def test_emulated_tile_matches_pallas_interpret_and_plain(kind, D, lq,
                                                          positions):
    arrays, (q, kp, vp, tbl, pos), sc = tile_case(kind, D, lq, positions,
                                                  seed=lq + D)
    tsc = None if sc is None else _t(*sc)
    got = emulate(q, kp, vp, tbl, pos, 8, kind, tsc)
    if kind == "bf16":
        tq, tk, tv = (x.to(BF16) for x in (q, kp, vp))
        plain = pa.paged_attention_reference(tq, tk, tv, tbl, pos, 8).float()
    else:
        plain = pa.paged_attention_reference(q, kp, vp, tbl, pos, 8,
                                             kv_scales=tsc)
    pallas = torch.from_numpy(np.array(jax_flash_attention_paged(
        *arrays, 8, interpret=True, kv_scales=sc), np.float32))
    assert bool(torch.isfinite(got).all())
    assert (got - plain).abs().max().item() <= bound(kind, plain)
    assert (got - pallas).abs().max().item() <= bound(kind, pallas)


@pytest.mark.parametrize("kind,cheap", [("fp32", "qk"), ("fp32", "pv"),
                                        ("int8", "qk"), ("bf16", "pv")])
def test_cheaper_arithmetic_error_is_recorded(record_property, kind, cheap):
    """One TF32 pass in place of 3xTF32 (fp32) or 2xTF32 (int8), and P
    rounded once to bf16 in place of its two terms: the error against the
    plain version at D 64, Lq 32, beside the kernel's own, recorded (the
    kernel keeps the split whatever it is)."""
    arrays, (q, kp, vp, tbl, pos), sc = tile_case(kind, 64, 32,
                                                  [0, 48, 20], seed=11)
    tsc = None if sc is None else _t(*sc)
    if kind == "bf16":
        plain = pa.paged_attention_reference(
            *(x.to(BF16) for x in (q, kp, vp)), tbl, pos, 8).float()
        variant = {"pv": p_once_bf16}
    else:
        plain = pa.paged_attention_reference(q, kp, vp, tbl, pos, 8,
                                             kv_scales=tsc)
        variant = {cheap: one_tf32}
    own = (emulate(q, kp, vp, tbl, pos, 8, kind, tsc) - plain).abs().max()
    err = (emulate(q, kp, vp, tbl, pos, 8, kind, tsc, **variant) -
           plain).abs().max()
    record_property("kernel_err", own.item())
    record_property("cheaper_err", err.item())
    record_property("bound", bound(kind, plain))
    assert torch.isfinite(err) and own.item() <= bound(kind, plain)
