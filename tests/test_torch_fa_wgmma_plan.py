"""bf16 ``flash_attention``'s Hopper body (``"wgmma"``): its planner, its
launch and its arithmetic, on the CPU.

The kernel runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2).  What decides its launch and its numbers is
checked here:

* ``_plan``: ``"wgmma"`` for bf16 ``flash_attention`` above
  ``DECODE_MAX_LQ`` with D up to 128, 64 query rows a CTA (its one
  consumer warpgroup) at any grid size; the fp32 tile, the bf16 offset
  tile, the decode body and v1 where they were; the card route makes one
  launch that carries the plan's path and rows;
* the body's arithmetic, emulated in plain torch step for step as
  ``csrc/flash_attention.cu`` takes it: 64-row warpgroups walking 64-key
  tiles, Q K^T exact in 16-wide k-steps into an fp32 accumulator, the
  online softmax in fp32 with the scale folded into one FMA before
  ``exp2`` (``p = 2^(s c - m c)``, ``c = scale log2 e``), O rescaled by
  alpha, then P V added 16 keys a k-step with P in two bf16 terms (lo
  first, then hi), the output ``O / l`` rounded once to bf16.

The emulation is held against ``mxnet_tpu``'s Pallas ``flash_attention``
in interpret mode and the port's plain ``blockwise_attention`` within
one bf16 ulp of max|ref| plus 1e-4 (the card check's bound).  The error
of P rounded once to bf16 is recorded as a test property.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_ops.flash_attention import \
    flash_attention as jax_flash_attention
from mxnet_tpu_torch.kernels import flash_attention as fa
from test_torch_cuda import bf16_ulp
from test_torch_paged_plan import mma_sum, p_once_bf16, p_split_bf16

H100_SMS = 132
NEG = -1e30
TOL = 1e-4
ROWS, KEYS = 64, 64        # query rows a warpgroup, keys a stage
LOG2E = 1.4426950408889634
F32, BF16 = torch.float32, torch.bfloat16


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,Lq,D,dtype,offset,want", [
    # the paths' shapes: phase 3e's prefills and phases 6b/8b's steps
    (4, 8, 512, 64, BF16, False, ("wgmma", 64, (32, 8))),
    (16, 8, 512, 64, BF16, False, ("wgmma", 64, (128, 8))),
    (16, 8, 256, 64, BF16, False, ("wgmma", 64, (128, 4))),
    # one past the decode threshold: 6 CTAs of 64 rows
    (3, 2, 7, 64, BF16, False, ("wgmma", 64, (6, 1))),
    # every padded head dim, and v1 above 128
    (3, 2, 70, 16, BF16, False, ("wgmma", 64, (6, 2))),
    (3, 2, 70, 32, BF16, False, ("wgmma", 64, (6, 2))),
    (3, 2, 70, 128, BF16, False, ("wgmma", 64, (6, 2))),
    (3, 2, 70, 136, BF16, False, ("v1", 32, (3, 6))),
    (3, 2, 70, 256, BF16, False, ("v1", 32, (3, 6))),
    # what stays: the decode body, the fp32 tile, the bf16 offset tile
    (3, 2, 6, 64, BF16, False, ("decode", 1, (6, 6))),
    (4, 8, 512, 64, F32, False, ("tile", 64, (32, 8))),
    (4, 8, 512, 64, BF16, True, ("tile", 64, (32, 8))),
    (3, 2, 7, 64, BF16, True, ("tile", 64, (6, 1))),
])
def test_plan_picks_wgmma_for_bf16_causal_prefill(B, H, Lq, D, dtype, offset,
                                                  want):
    plan = fa._plan(B, H, Lq, 512, D, dtype, H100_SMS, offset=offset)
    assert (plan.path, plan.block_q, plan.grid) == want


@pytest.mark.parametrize("BH,sms", [(1, 132), (263, 132), (528, 132),
                                    (528, 114)])
def test_wgmma_rows_do_not_move_with_the_grid(BH, sms):
    """64 rows a CTA (one consumer warpgroup, three CTAs an SM) at any
    grid size and SM count: two warpgroups of 64 rows sharing each K/V
    stage were as fast or slower at every path shape (PERF.md §6)."""
    plan = fa._plan(BH, 1, 128, 128, 64, BF16, sms)
    assert (plan.path, plan.block_q, plan.grid) == ("wgmma", 64, (BH, 2))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wgmma_takes_the_tiles_place_from_the_threshold(dtype):
    m = fa.DECODE_MAX_LQ[dtype]
    above = "wgmma" if dtype == BF16 else "tile"
    for offset in (False, True):
        assert fa._plan(2, 8, m, 1024, 64, dtype, H100_SMS,
                        offset=offset).path == "decode"
        assert fa._plan(2, 8, m + 1, 1024, 64, dtype, H100_SMS,
                        offset=offset).path == ("tile" if offset else above)


@pytest.fixture
def card_route(monkeypatch):
    """The wrapper's card route on CPU tensors, with the launches
    recorded instead of made."""
    launches = []
    monkeypatch.setattr(fa, "route", lambda name, x: True)
    monkeypatch.setattr(fa, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(fa, "launch", lambda *a: launches.append(a))
    return launches


@pytest.mark.parametrize("B,H,Lq,D", [(4, 8, 512, 64), (16, 8, 256, 64),
                                      (3, 2, 7, 16), (3, 2, 70, 128)])
def test_card_route_launches_wgmma_once_with_the_plans_rows(card_route, B, H,
                                                            Lq, D):
    q, k, v = (torch.zeros(B, H, Lq, D, dtype=BF16) for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape and out.dtype == BF16
    out = fa.flash_attention_offset(q, k, v, torch.zeros(B, dtype=torch.int32))
    assert out.shape == q.shape and out.dtype == BF16
    flash, offset = card_route
    plan = fa._plan(B, H, Lq, Lq, D, BF16, H100_SMS)
    assert plan.path == "wgmma"
    # flash: ..., out, B*H, Lq, Lk, D, causal, scale, path, block_q
    assert flash[1:3] == ("flash_attention_bf16", "mxt_flash_attention_bf16")
    assert flash[-8:-3] == (B * H, Lq, Lq, D, 1)
    assert flash[-2:] == (fa._PATH["wgmma"], plan.block_q)
    # the offset entry point keeps its mma.sync tile
    assert offset[1] == "flash_attention_offset_bf16"
    assert offset[-2:] == (fa._PATH["tile"], fa.TILE_ROWS)


# ---------------------------------------------------------------------------
# the body's arithmetic
# ---------------------------------------------------------------------------
def emulate_wgmma(q, k, v, causal, pv=p_split_bf16):
    """The wgmma body's forward on bf16 values carried in fp32, every
    64-row warpgroup of every (sequence, head) at once: 64-key tiles up
    to the last key a warpgroup's rows can see (tiles past it are no-ops
    for its rows: alpha 1, p 0), D zero-padded to 64 or 128; Q K^T exact
    in 16-wide k-steps; the mask (-1e30, p exactly 0) on every score;
    ``p = 2^(s c - m c)``; O *= alpha, then P V by ``pv`` a 16-key
    k-step; ``O / l`` rounded to bf16."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    DP = 64 if D <= 64 else 128
    Lp = -(-Lq // ROWS) * ROWS
    c = torch.tensor(1.0 / D ** 0.5 * LOG2E, dtype=F32)
    Q = torch.zeros(B, H, Lp, DP)
    Q[:, :, :Lq, :D] = q
    rows = torch.arange(Lp)[:, None]
    m = torch.full((B, H, Lp), NEG)
    l = torch.zeros(B, H, Lp)
    o = torch.zeros(B, H, Lp, DP)
    n_keys = min(Lq, Lk) if causal else Lk
    for k0 in range(0, n_keys, KEYS):
        kpos = torch.arange(k0, k0 + KEYS)
        live = kpos < Lk
        K = torch.zeros(B, H, KEYS, DP)
        V = torch.zeros(B, H, KEYS, DP)
        K[:, :, live, :D] = k[:, :, kpos[live]]
        V[:, :, live, :D] = v[:, :, kpos[live]]
        s = torch.zeros(B, H, Lp, KEYS)
        for d0 in range(0, DP, 16):
            s = s + (Q[..., d0:d0 + 16].double() @
                     K[..., d0:d0 + 16].double().transpose(-1, -2)).float()
        vis = live[None] & ((kpos[None] <= rows) | (not causal))
        s = torch.where(vis, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        o = o * alpha[..., None]
        for b in range(B):
            for h in range(H):
                o[b, h] = mma_sum(o[b, h], p[b, h], V[b, h], 16, pv)
    res = o / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return res[:, :, :Lq, :D].to(BF16).float()


def _case(B, H, Lq, Lk, D, seed):
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(B, H, L, D).astype(np.float32) for L in (Lq, Lk, Lk)]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(BF16) for a in arrays])


def _f32(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


@pytest.mark.parametrize("Lq,Lk,D,causal", [(32, 32, 64, True),
                                            (70, 70, 16, True),
                                            (33, 100, 64, False),
                                            (20, 20, 128, True)])
def test_emulated_wgmma_matches_plain_and_pallas(Lq, Lk, D, causal):
    (jq, jk, jv), (tq, tk, tv) = _case(2, 2, Lq, Lk, D, Lq + D)
    got = emulate_wgmma(tq.float(), tk.float(), tv.float(), causal)
    plain = fa.blockwise_attention(tq, tk, tv, causal).float()
    pallas = _f32(jax_flash_attention(jq, jk, jv, causal=causal, block_q=Lq,
                                      block_k=Lk, interpret=True))
    for want in (plain, pallas):
        assert (got - want).abs().max().item() <= \
            bf16_ulp(want.abs().max().item()) + TOL


def test_emulated_wgmma_crosses_warpgroups_and_key_tiles():
    """Lq 130: three warpgroups, the last holding two rows; 300 keys:
    five tiles, the last ragged; causal and not."""
    (_, _, _), (tq, tk, tv) = _case(1, 2, 130, 300, 64, 3)
    for causal in (True, False):
        got = emulate_wgmma(tq.float(), tk.float(), tv.float(), causal)
        want = fa.blockwise_attention(tq, tk, tv, causal).float()
        assert (got - want).abs().max().item() <= \
            bf16_ulp(want.abs().max().item()) + TOL


def test_p_in_two_terms_and_p_once_recorded(record_property):
    """The body keeps P in two bf16 terms (two wgmmas a k-step into one
    accumulator); P rounded once is cheaper and errs more, recorded
    beside it (the card run's numbers are in PERF.md)."""
    (_, _, _), (tq, tk, tv) = _case(2, 2, 64, 192, 64, 11)
    args = (tq.float(), tk.float(), tv.float(), True)
    plain = fa.blockwise_attention(tq, tk, tv, True).float()
    own = (emulate_wgmma(*args) - plain).abs().max().item()
    once = (emulate_wgmma(*args, pv=p_once_bf16) - plain).abs().max().item()
    bound = bf16_ulp(plain.abs().max().item()) + TOL
    record_property("two_terms_err", own)
    record_property("p_once_err", once)
    record_property("bound", bound)
    assert own <= bound and np.isfinite(once)
