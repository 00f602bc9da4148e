"""The CUDA norm backwards' launch planner and their order of summation,
on the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
What decides their launch and their numbers is checked here:

* ``_bwd_plan``: v2 (the row in registers) up to the register cap, for
  widths that are a multiple of 4 and 16-byte aligned pointers, v1 for
  every other row; the grid the C entry point expects (one partial
  weight-gradient row a CTA);
* the wrapper's card route: one launch with the plan's path and rows a
  warp, no ``torch.sum`` around it;
* the kernels' arithmetic in their order, emulated in torch fp32: each
  lane's sums over its columns, the warp's butterfly, then the weight
  gradients as each lane's column sums over its warp's rows, the warps
  in CTA order and the CTAs' partial rows in the fixed order of the sum
  kernel; held within 1e-5 x max|ref| of ``jax.vjp`` of the Pallas
  kernels in interpret mode and of the plain versions.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_ops import norm as jax_norm
from mxnet_tpu_torch.kernels import norm

CAP = norm.BWD_V2_MAX_WIDTH
SUM_WARPS = 16   # kSumWarps of csrc/norm.cu
H100_SMS = 132


@pytest.mark.parametrize("width,aligned,path", [
    (CAP, True, "v2"), (CAP + 4, True, "v1"), (1000, True, "v2"),
    (1002, True, "v1"), (7, True, "v1"), (40, True, "v2"),
    (512, True, "v2"), (512, False, "v1"), (4, True, "v2")])
def test_plan_picks_the_path(width, aligned, path):
    assert norm._bwd_plan(64, width, aligned, H100_SMS).path == path


@pytest.mark.parametrize("rows", [0, 1, 7, 17, 33, 64, 300, 4096, 4097,
                                  100_000, 1_000_000])
@pytest.mark.parametrize("width,aligned", [(512, True), (1000, False)])
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_plan_grid_covers_the_rows_once(rows, width, aligned, sms):
    plan = norm._bwd_plan(rows, width, aligned, sms)
    per_cta = norm.BWD_WARPS[plan.path] * plan.rows_per_warp
    assert plan.ctas == -(-rows // per_cta)
    if plan.path == "v2":                      # at most one wave
        assert plan.ctas <= sms
    else:
        assert plan.rows_per_warp >= norm.BWD_V1_ROWS_PER_WARP
        assert plan.ctas <= norm.BWD_V1_MAX_CTAS
    if rows:                                   # no CTA without a row
        assert (plan.ctas - 1) * per_cta < rows <= plan.ctas * per_cta
        # as few rows a warp as fill the wave
        if plan.path == "v2" and plan.rows_per_warp > 1:
            assert -(-rows // (per_cta - 8)) > sms


def test_plan_at_the_training_shape():
    # 4096 x 512: 128 CTAs of 8 warps, 4 rows a warp, one wave of one CTA
    # on each of 128 of an H100's 132 SMs
    assert norm._bwd_plan(4096, 512, True, H100_SMS) == \
        norm.BwdPlan("v2", 128, 4)
    assert norm._bwd_plan(4097, 512, True, H100_SMS).ctas == 129
    assert norm._bwd_plan(1024, 512, True, H100_SMS).rows_per_warp == 1


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers' card route on CPU tensors, the launches recorded
    instead of made, and ``torch.sum`` refused."""
    launches = []

    def no_sum(*a, **k):
        raise AssertionError("torch.sum on the card route")

    monkeypatch.setattr(norm, "route", lambda name, x: True)
    monkeypatch.setattr(norm, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(norm, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(torch, "sum", no_sum)
    return launches


@pytest.mark.parametrize("offset,path", [(0, 1), (1, 0)])
def test_card_route_is_one_launch_of_the_plan(card_route, offset, path):
    """A contiguous view 4 bytes off 16-byte alignment takes v1."""
    rows, width = 33, 512
    buf = torch.zeros(2, rows * width + offset)
    x, dy = (b[offset:].view(rows, width) for b in buf)
    g = torch.ones(width)
    dx, dg = norm.rms_norm_bwd(x, g, dy)
    dx2, dg2, db2 = norm.layer_norm_bwd(x, g, dy)
    assert [a[1] for a in card_route] == ["rms_norm_bwd", "layer_norm_bwd"]
    plan = norm._bwd_plan(rows, width, offset == 0, H100_SMS)
    for args, eps in zip(card_route, (1e-6, 1e-5)):
        assert args[-5:] == (rows, width, eps, path, plan.rows_per_warp)
    assert dx.shape == dx2.shape == (rows, width)
    assert dg.shape == dg2.shape == db2.shape == (width,)


@pytest.mark.parametrize("offset,path", [(0, 1), (4, 1), (2, 0), (1, 0)])
def test_bf16_card_route_takes_v2_on_8_byte_chunks(card_route, offset,
                                                   path):
    """bf16 rows take v2 when every row tensor starts on a 4-element
    chunk, 8 bytes (offsets 0 and 4 elements), else v1 (2 and 1); each
    launch is one call of the bf16 entry point under the bf16 name, and
    the outputs are bf16."""
    rows, width = 33, 512
    buf = torch.zeros(2, rows * width + offset, dtype=torch.bfloat16)
    x, dy = (b[offset:].view(rows, width) for b in buf)
    g = torch.ones(width, dtype=torch.bfloat16)
    assert norm._bwd_aligned(x, g, dy) == (path == 1)
    # 8 bytes in: a bf16 chunk, not an fp32 one (16 bytes)
    assert norm._bwd_aligned(torch.zeros(9, dtype=torch.bfloat16)[4:])
    assert not norm._bwd_aligned(torch.zeros(9)[2:])
    outs = norm.rms_norm_bwd(x, g, dy) + norm.layer_norm_bwd(x, g, dy)
    assert [a[1:3] for a in card_route] == [
        ("rms_norm_bwd_bf16", "mxt_rms_norm_bwd_bf16"),
        ("layer_norm_bwd_bf16", "mxt_layer_norm_bwd_bf16")]
    plan = norm._bwd_plan(rows, width, path == 1, H100_SMS)
    for args in card_route:
        assert args[-2:] == (path, plan.rows_per_warp)
    assert all(t.dtype == torch.bfloat16 for t in outs)


def _layout(path, width):
    """``idx[lane, k]``: the column a lane holds k-th, in the order it
    sums them (-1 past the row).  v1: columns lane, lane + 32, ...; v2:
    float4 chunks lane, lane + 32, ... of a power-of-two count, the four
    columns of a chunk in turn."""
    if path == "v1":
        idx = np.arange(32)[:, None] + 32 * np.arange(-(-width // 32))
        return np.where(idx < width, idx, -1)
    n4 = width // 4
    nv = 1
    while 32 * nv < n4:
        nv *= 2
    chunk = np.arange(32)[:, None] + 32 * np.arange(nv)        # (32, nv)
    idx = (4 * chunk[:, :, None] + np.arange(4)).reshape(32, 4 * nv)
    return np.where(np.repeat(chunk < n4, 4, axis=1), idx, -1)


def _row_sum(v, idx):
    """The warp's sum of each row of ``v`` (rows, width): each lane adds
    its columns in turn, then the butterfly of ``warp_sum``."""
    mask = torch.from_numpy(idx >= 0)
    lanes = torch.where(mask, v[:, torch.from_numpy(np.maximum(idx, 0))],
                        torch.zeros(()))                  # (rows, 32, k)
    s = torch.zeros(v.shape[0], 32)
    for k in range(idx.shape[1]):
        s = s + lanes[:, :, k]
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, torch.arange(32) ^ o]
    return s[:, :1]


def _weight_grad(contrib, plan):
    """Sum ``contrib`` (rows, width) over the rows in the kernels' order:
    each lane over its warp's rows, the warps in CTA order, the CTAs'
    partial rows as ``sum_partials_kernel`` adds them."""
    rows, width = contrib.shape
    warps, rpw = norm.BWD_WARPS[plan.path], plan.rows_per_warp
    pad = torch.zeros(plan.ctas * warps * rpw, width)
    pad[:rows] = contrib
    if plan.path == "v2":     # warp w of CTA b: rows b*8*rpw + w + 8i
        t = pad.view(plan.ctas, rpw, warps, width)
    else:                     # rows (b*4 + w)*rpw + i
        t = pad.view(plan.ctas, warps, rpw, width).transpose(1, 2)
    acc = torch.zeros(plan.ctas, warps, width)
    for i in range(rpw):
        acc = acc + t[:, i]
    part = torch.zeros(plan.ctas, width)
    for w in range(warps):
        part = part + acc[:, w]
    groups = -(-plan.ctas // SUM_WARPS)
    padp = torch.zeros(groups * SUM_WARPS, width)
    padp[:plan.ctas] = part
    s = torch.zeros(SUM_WARPS, width)
    for q in range(groups):            # warp w: partial rows w, w + 16, ...
        s = s + padp[q * SUM_WARPS:(q + 1) * SUM_WARPS]
    out = torch.zeros(width)
    for w in range(SUM_WARPS):
        out = out + s[w]
    return out


def emulate_bwd(x, g, dy, eps, layer, aligned=True):
    """The CUDA backward of ``rms_norm`` (``layer`` False: ``(dx, dg)``)
    or ``layer_norm`` (``(dx, dg, db)``) as the planned path computes
    it, in torch fp32."""
    rows, width = x.shape
    plan = norm._bwd_plan(rows, width, aligned, H100_SMS)
    idx = _layout(plan.path, width)
    w = dy * g
    if layer:
        mu = _row_sum(x, idx) / width
        r = torch.rsqrt(_row_sum((x - mu) * (x - mu), idx) / width + eps)
        xhat = (x - mu) * r
        mw, mwx = (_row_sum(v, idx) / width for v in (w, w * xhat))
        dx = r * (w - mw - xhat * mwx)
        return dx, _weight_grad(dy * xhat, plan), _weight_grad(dy, plan)
    r = torch.rsqrt(_row_sum(x * x, idx) / width + eps)
    mwx = _row_sum(w * x, idx) / width
    dx = r * w - (r * r * r) * x * mwx
    return dx, _weight_grad(dy * x * r, plan)


def _case(rows, width):
    rs = np.random.RandomState(rows * 7 + width)
    return (rs.randn(rows, width).astype(np.float32) + 3.0,
            rs.uniform(0.5, 1.5, width).astype(np.float32),
            rs.randn(width).astype(np.float32),
            rs.randn(rows, width).astype(np.float32))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# each row count and width of the plain-version sweep below, both paths
@pytest.mark.parametrize("rows,width", [(1, 7), (17, 40), (33, 512),
                                        (64, 1000), (300, 512), (17, 1000)])
def test_emulation_matches_pallas_interpret(rows, width):
    x, g, b, dy = _case(rows, width)
    _, vjp = jax.vjp(lambda a, c: jax_norm.rms_norm(a, c, 1e-6, 8, True),
                     x, g)
    want = vjp(dy)
    t = [torch.from_numpy(a) for a in (x, g, dy)]
    for got, ref in zip(emulate_bwd(*t, 1e-6, False), want):
        _close(got, ref)
    _, vjp = jax.vjp(lambda a, c, d: jax_norm.layer_norm(a, c, d, 1e-5, 8,
                                                         True), x, g, b)
    want = vjp(dy)
    for got, ref in zip(emulate_bwd(*t, 1e-5, True), want):
        _close(got, ref)


@pytest.mark.parametrize("rows,width", [
    (r, w) for r in (1, 17, 33, 64, 300)
    for w in (7, 40, 512, 1000, 1002, CAP, CAP + 4)] + [(4097, 512)])
@pytest.mark.parametrize("aligned", [True, False])
def test_emulation_matches_plain(rows, width, aligned):
    x, g, _, dy = (torch.from_numpy(a) for a in _case(rows, width))
    for layer, ref in ((False, norm.rms_norm_bwd_reference(x, g, dy, 1e-6)),
                       (True, norm.layer_norm_bwd_reference(x, g, dy,
                                                            1e-5))):
        got = emulate_bwd(x, g, dy, 1e-5 if layer else 1e-6, layer, aligned)
        for a, b in zip(got, ref):
            _close(a, b)
