"""The CUDA norm backwards' launch planner and their order of summation,
on the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
What decides their launch and their numbers is checked here:

* ``_bwd_plan``: v3 (bf16 rows held packed, 16-byte chunks) for bf16
  widths that are a multiple of 8 up to 1024 on 16-byte aligned
  pointers; v2 (the row in registers) up to the register cap, for
  widths that are a multiple of 4 and pointers on a 4-element chunk; v1
  for every other row; fp32 never v3; the grid the C entry point
  expects (one partial weight-gradient row a CTA, at most one wave);
* the wrapper's card route: one launch with the plan's path and rows a
  warp, no ``torch.sum`` around it;
* the kernels' arithmetic in their order, emulated in torch fp32: each
  lane's sums over its columns, the warp's butterfly, then the weight
  gradients as each lane's column sums over its warp's rows, the warps
  in CTA order and the CTAs' partial rows in the fixed order of the sum
  kernel; held within 1e-5 x max|ref| of ``jax.vjp`` of the Pallas
  kernels in interpret mode and of the plain versions; v3's order on
  bf16 inputs, rounded once to bf16, also within one bf16 ulp of the
  plain versions on bf16 tensors.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_ops import norm as jax_norm
from mxnet_tpu_torch.kernels import norm
from test_torch_cuda import bf16_ulp

CAP = norm.BWD_V2_MAX_WIDTH
SUM_WARPS = 16   # kSumWarps of csrc/norm.cu
H100_SMS = 132
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tests make thousands of
    tiny torch ops, and under a parallel run (several workers on the
    same cores) handing each op to a team of threads costs many times
    the op.  Restored when the module ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# align: the bytes every row tensor's start is a multiple of
@pytest.mark.parametrize("width,align,dtype,path", [
    (CAP, 16, F32, "v2"), (CAP + 4, 16, F32, "v1"), (1000, 16, F32, "v2"),
    (1002, 16, F32, "v1"), (7, 16, F32, "v1"), (40, 16, F32, "v2"),
    (512, 16, F32, "v2"), (512, 4, F32, "v1"), (512, 8, F32, "v1"),
    (4, 16, F32, "v2"),
    (512, 16, BF16, "v3"), (8, 16, BF16, "v3"), (CAP, 16, BF16, "v3"),
    (1000, 16, BF16, "v3"), (CAP + 8, 16, BF16, "v1"),
    (516, 16, BF16, "v2"), (4, 16, BF16, "v2"), (512, 8, BF16, "v2"),
    (512, 4, BF16, "v1"), (512, 2, BF16, "v1"), (513, 16, BF16, "v1"),
    (1002, 16, BF16, "v1")])
def test_plan_picks_the_path(width, align, dtype, path):
    assert norm._bwd_plan(64, width, align, H100_SMS, dtype).path == path


def test_plan_never_gives_fp32_v3():
    assert {norm._bwd_path(w, a, F32) for w in range(1, CAP + 64)
            for a in (1, 2, 4, 8, 16)} == {"v1", "v2"}


@pytest.mark.parametrize("rows", [0, 1, 7, 17, 33, 64, 300, 4096, 4097,
                                  100_000, 1_000_000])
@pytest.mark.parametrize("width,align,dtype", [
    (512, 16, F32), (1000, 4, F32), (512, 16, BF16), (CAP, 16, BF16)])
@pytest.mark.parametrize("sms", [H100_SMS, 7])
@pytest.mark.parametrize("layer", [False, True])
def test_plan_grid_covers_the_rows_once(rows, width, align, dtype, sms,
                                        layer):
    plan = norm._bwd_plan(rows, width, align, sms, dtype, layer)
    per_cta = norm.BWD_WARPS[plan.path] * plan.rows_per_warp
    assert plan.ctas == -(-rows // per_cta)
    wave = {"v2": sms, "v3": norm._v3_ctas_per_sm(width, layer) * sms}
    if plan.path in wave:                      # at most one wave
        assert plan.ctas <= wave[plan.path]
    else:
        assert plan.rows_per_warp >= norm.BWD_V1_ROWS_PER_WARP
        assert plan.ctas <= norm.BWD_V1_MAX_CTAS
    if rows:                                   # no CTA without a row
        assert (plan.ctas - 1) * per_cta < rows <= plan.ctas * per_cta
        # as few rows a warp as fill the wave
        if plan.path in wave and plan.rows_per_warp > 1:
            warps = norm.BWD_WARPS[plan.path]
            assert -(-rows // (per_cta - warps)) > wave[plan.path]


def test_plan_at_the_training_shape():
    # 4096 x 512 fp32: 128 CTAs of 8 warps, 4 rows a warp, one wave of one
    # CTA on each of 128 of an H100's 132 SMs; bf16: v3, for RMSNorm 256
    # CTAs of 8 warps, 2 rows a warp, one wave of two CTAs an SM, for
    # LayerNorm (one CTA an SM) as fp32's grid
    assert norm._bwd_plan(4096, 512, 16, H100_SMS) == \
        norm.BwdPlan("v2", 128, 4)
    assert norm._bwd_plan(4097, 512, 16, H100_SMS).ctas == 129
    assert norm._bwd_plan(1024, 512, 16, H100_SMS).rows_per_warp == 1
    assert norm._bwd_plan(4096, 512, 16, H100_SMS, BF16) == \
        norm.BwdPlan("v3", 256, 2)
    assert norm._bwd_plan(4096, 512, 16, H100_SMS, BF16, True) == \
        norm.BwdPlan("v3", 128, 4)
    assert norm._bwd_plan(4096, 512, 8, H100_SMS, BF16) == \
        norm.BwdPlan("v2", 128, 4)
    assert norm._bwd_plan(4096, 1024, 16, H100_SMS, BF16) == \
        norm.BwdPlan("v3", 128, 4)


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
    for args, eps, layer in zip(card_route, (1e-6, 1e-5), (False, True)):
        plan = norm._bwd_plan(rows, width, 16 if offset == 0 else 4,
                              H100_SMS, layer=layer)
        assert args[-5:] == (rows, width, eps, path, plan.rows_per_warp)
    assert dx.shape == dx2.shape == (rows, width)
    assert dg.shape == dg2.shape == db2.shape == (width,)


@pytest.mark.parametrize("offset,path", [(0, 2), (4, 1), (2, 0), (1, 0)])
def test_bf16_card_route_takes_v2_on_8_byte_chunks(card_route, offset,
                                                   path):
    """bf16 rows take v3 when every row tensor starts on 16 bytes (offset
    0), v2 on a 4-element chunk, 8 bytes (offset 4 elements), else v1
    (2 and 1); each launch is one call of the bf16 entry point under the
    bf16 name with the plan's path and rows a warp, and the outputs are
    bf16."""
    rows, width = 33, 512
    buf = torch.zeros(2, rows * width + offset, dtype=torch.bfloat16)
    x, dy = (b[offset:].view(rows, width) for b in buf)
    g = torch.ones(width, dtype=torch.bfloat16)
    align = norm._bwd_align(x, g, dy)
    assert align == {0: 16, 4: 8, 2: 4, 1: 2}[offset]
    # 8 bytes in: a bf16 chunk, not an fp32 one (16 bytes)
    assert norm._bwd_path(width, norm._bwd_align(
        torch.zeros(9, dtype=torch.bfloat16)[4:]), torch.bfloat16) == "v2"
    assert norm._bwd_path(width, norm._bwd_align(torch.zeros(9)[2:]),
                          torch.float32) == "v1"
    outs = norm.rms_norm_bwd(x, g, dy) + norm.layer_norm_bwd(x, g, dy)
    assert [a[1:3] for a in card_route] == [
        ("rms_norm_bwd_bf16", "mxt_rms_norm_bwd_bf16"),
        ("layer_norm_bwd_bf16", "mxt_layer_norm_bwd_bf16")]
    for args, layer in zip(card_route, (False, True)):
        plan = norm._bwd_plan(rows, width, align, H100_SMS, torch.bfloat16,
                              layer)
        assert norm._BWD_PATH[plan.path] == path
        assert args[-2:] == (path, plan.rows_per_warp)
    assert all(t.dtype == torch.bfloat16 for t in outs)


def _layout(path, width):
    """``idx[lane, k]``: the column a lane holds k-th, in the order it
    sums them (-1 past the row).  v1: columns lane, lane + 32, ...; v2
    and v3: chunks lane, lane + 32, ... of a power-of-two count, of 4
    columns (v2, a float4 or 8 bytes of bf16) or 8 (v3, 16 bytes of
    bf16), the columns of a chunk in turn."""
    if path == "v1":
        idx = np.arange(32)[:, None] + 32 * np.arange(-(-width // 32))
        return np.where(idx < width, idx, -1)
    size = {"v2": 4, "v3": 8}[path]
    n = width // size
    nv = 1
    while 32 * nv < n:
        nv *= 2
    chunk = np.arange(32)[:, None] + 32 * np.arange(nv)        # (32, nv)
    idx = (size * chunk[:, :, None] + np.arange(size)).reshape(32, -1)
    return np.where(np.repeat(chunk < n, size, axis=1), idx, -1)


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
    if plan.path != "v1":     # warp w of CTA b: rows b*8*rpw + w + 8i
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


def emulate_bwd(x, g, dy, eps, layer, align=16, dtype=F32):
    """The CUDA backward of ``rms_norm`` (``layer`` False: ``(dx, dg)``)
    or ``layer_norm`` (``(dx, dg, db)``) as the path planned for
    ``dtype`` rows computes it, in torch fp32 (bf16 inputs widened; the
    outputs before their one rounding)."""
    rows, width = x.shape
    plan = norm._bwd_plan(rows, width, align, H100_SMS, dtype, layer)
    idx = _layout(plan.path, width)
    w = dy * g
    if layer:
        mu = _row_sum(x, idx) / width
        r = torch.rsqrt(_row_sum((x - mu) * (x - mu), idx) / width + eps)
        xhat = (x - mu) * r
        mw = _row_sum(w, idx) / width
        if plan.path == "v3":      # r * mean(w * (x - mu)), one pass
            mwx = r * _row_sum(w * (x - mu), idx) / width
        else:
            mwx = _row_sum(w * xhat, idx) / width
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
        got = emulate_bwd(x, g, dy, 1e-5 if layer else 1e-6, layer,
                          16 if aligned else 4)
        for a, b in zip(got, ref):
            _close(a, b)


def _bf16_case(rows, width):
    """``_case`` rounded to bf16: the bf16 tensors, and the same values
    widened to fp32 numpy for the Pallas kernels."""
    t = [torch.from_numpy(a).to(BF16) for a in _case(rows, width)]
    return t, [a.float().numpy() for a in t]


@pytest.mark.parametrize("rows", [1, 33, 4096, 4097])
def test_v3_emulation_matches_pallas_interpret_and_plain(rows):
    """v3's order on bf16 inputs widened (each lane's 16-byte chunks, the
    warps in CTA order, the CTAs' partial rows in the fixed order) within
    1e-5 x max|ref| of ``jax.vjp`` of the Pallas kernels on the same
    widened values; rounded once to bf16, within one bf16 ulp of the
    plain versions on the bf16 tensors.  One Pallas block of all the
    rows: its grid does not change the function."""
    width = 512
    assert norm._bwd_plan(rows, width, 16, H100_SMS, BF16).path == "v3"
    (tx, tg, tb, tdy), (x, g, b, dy) = _bf16_case(rows, width)
    wide = [torch.from_numpy(a) for a in (x, g, dy)]
    for layer, eps in ((False, 1e-6), (True, 1e-5)):
        got = emulate_bwd(*wide, eps, layer, 16, BF16)
        if layer:
            _, vjp = jax.vjp(lambda a, c, d: jax_norm.layer_norm(
                a, c, d, eps, rows, True), x, g, b)
            plain = norm.layer_norm_bwd_reference(tx, tg, tdy, eps)
        else:
            _, vjp = jax.vjp(lambda a, c: jax_norm.rms_norm(
                a, c, eps, rows, True), x, g)
            plain = norm.rms_norm_bwd_reference(tx, tg, tdy, eps)
        for a, ref, p in zip(got, vjp(dy), plain):
            _close(a, ref)
            err = (a.to(BF16).float() - p.float()).abs().max().item()
            assert err <= bf16_ulp(p.float().abs().max().item()), err
