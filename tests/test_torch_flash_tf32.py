"""The arithmetic of the CUDA ``flash_attention``'s tensor-core body,
emulated on the CPU.

The kernel runs only on a card (``tests/test_torch_cuda.py``).  What
decides its numbers is checked here in plain torch, step for step as
``csrc/flash_attention.cu`` takes them:

* every operand split in two TF32 parts: ``hi`` = TF32(x) rounded to
  nearest, ties away from zero (the bits ``cvt.rna.tf32.f32`` gives, by
  a bit mask), ``lo = x - hi`` (exact in fp32) truncated to TF32, as the
  tensor core reads a ``.tf32`` operand;
* both products in 3xTF32: ``lo·hi``, ``hi·lo``, ``hi·hi`` a k-step of
  8, each step's 8 exact products summed and rounded once into an fp32
  accumulator;
* 64-key tiles, the online softmax in fp32, the ``-1e30`` mask with
  masked p forced to 0, and P·V with the keys of each 8-key block
  relabeled as the kernel relabels them (key 2t as the mma's k = t, key
  2t+1 as k = t + 4, in P and in V alike), each tile's P·V summed apart
  and joined as ``acc * alpha + pv``.

The emulation is held against ``mxnet_tpu``'s Pallas ``flash_attention``
in interpret mode and the port's plain ``blockwise_attention`` within
1e-4 absolute, the card check's bound.  One TF32 pass misses that bound
on inputs drawn as the card check draws them, which is why the kernel
runs three.  A fragment-level emulation of ``mma.sync.m16n8k8`` shows
the relabeling taking S's C fragment straight into P·V's A fragment.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_ops.flash_attention import \
    flash_attention as jax_flash_attention
from mxnet_tpu_torch.kernels import flash_attention

NEG = -1e30
KEY_TILE = 64          # keys a shared-memory tile of the body at D <= 64
# key 2t of an 8-key block is the mma's k = t, key 2t+1 its k = t + 4:
# the physical key at each k
RELABEL = [0, 2, 4, 6, 1, 3, 5, 7]
TOL = 1e-4


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


def tf32_rna(x):
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32``: to the nearest value
    with 10 mantissa bits, halves away from zero (add half a TF32 ulp to
    the pattern, clear the low 13 bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """The TF32 value the tensor core reads from an fp32 pattern: its low
    13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x, lo_round=False):
    """``(hi, lo)`` with ``x ~ hi + lo``, as the kernel splits (``lo``
    truncated by the tensor core; ``lo_round``: rounded as ``hi``)."""
    hi = tf32_rna(x)
    lo = x - hi                      # exact in fp32
    return hi, (tf32_rna(lo) if lo_round else tf32_trunc(lo))


def mma_sum(acc, a, b, passes):
    """``acc + a @ b`` the way the kernel's mma chain adds it: per k-step
    of 8, for each ``(a part, b part)`` of ``passes`` in order, the 8
    exact products summed once (in float64) and added to the fp32
    accumulator."""
    for k0 in range(0, a.shape[-1], 8):
        for pa, pb in passes(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]):
            acc = acc + (pa.double() @ pb.double()).float()
    return acc


def three_passes(lo_round=False):
    def passes(a, b):
        (ah, al), (bh, bl) = split(a, lo_round), split(b, lo_round)
        return ((al, bh), (ah, bl), (ah, bh))
    return passes


def one_pass(a, b):
    return ((tf32_rna(a), tf32_rna(b)),)


def pad_to(x, dim, mult):
    n = x.shape[dim]
    extra = -n % mult
    if not extra:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim)


def emulate(q, k, v, causal, passes=None, key_tile=KEY_TILE):
    """The tensor-core body's forward on CPU tensors [B, H, L, D]: D
    zero-padded to a multiple of 8, keys past the end zero-filled and
    masked, online softmax over ``key_tile``-key tiles."""
    passes = passes or three_passes()
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = 1.0 / D ** 0.5
    qp, kp, vp = (pad_to(t.float(), 3, 8) for t in (q, k, v))
    m = torch.full((B, H, Lq, 1), NEG)
    l = torch.zeros(B, H, Lq, 1)
    o = torch.zeros(B, H, Lq, qp.shape[3])
    qpos = torch.arange(Lq)[:, None]
    for k0 in range(0, Lk, key_tile):
        kb = pad_to(kp[:, :, k0:k0 + key_tile], 2, 8)
        vb = pad_to(vp[:, :, k0:k0 + key_tile], 2, 8)
        s = mma_sum(torch.zeros(B, H, Lq, kb.shape[2]), qp,
                    kb.transpose(-1, -2), passes) * scale
        kpos = k0 + torch.arange(kb.shape[2])[None, :]
        vis = (kpos < Lk) & ((kpos <= qpos) if causal else True)
        s = torch.where(vis, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(vis, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        order = torch.tensor([b + r for b in range(0, kb.shape[2], 8)
                              for r in RELABEL])
        pv = mma_sum(torch.zeros_like(o), p[..., order], vb[:, :, order],
                     passes)
        o = o * alpha + pv
        m = m_new
    return (o / torch.where(l > 0, l, torch.ones_like(l)))[..., :D]


def case(B, H, Lq, Lk, D, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, Lq, D).astype(np.float32)
    k, v = (rs.randn(B, H, Lk, D).astype(np.float32) for _ in range(2))
    return q, k, v


def test_tf32_rounding_is_round_half_away_and_truncation_drops_bits():
    one = 1.0
    half_ulp = 2.0 ** -11            # half a TF32 ulp at 1
    below = float(np.nextafter(np.float32(one + half_ulp), np.float32(0)))
    x = torch.tensor([one + half_ulp, below, -(one + half_ulp), -below, 3.0])
    assert tf32_rna(x).tolist() == [1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10),
                                    -1.0, 3.0]
    assert tf32_trunc(x).tolist() == [1.0, 1.0, -1.0, -1.0, 3.0]
    hi, lo = split(x)
    assert torch.equal(hi + (x - hi), x)   # the residual is exact in fp32


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Lq,Lk,D", [
    (1, 2, 256, 256, 64), (1, 2, 33, 33, 64),
    (1, 2, 256, 256, 12), (2, 2, 33, 33, 12),
    (1, 2, 256, 256, 100), (2, 1, 33, 33, 100),
    (2, 2, 16, 48, 64)])
def test_emulated_3xtf32_matches_pallas_interpret_and_plain(causal, B, H,
                                                            Lq, Lk, D):
    q, k, v = case(B, H, Lq, Lk, D, seed=Lq + Lk + D)
    got = emulate(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    pallas = np.asarray(jax_flash_attention(
        q, k, v, causal=causal, interpret=True))
    plain = flash_attention.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal).numpy()
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - pallas).max() <= TOL
    assert np.abs(got.numpy() - plain).max() <= TOL


@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_pass_misses_the_bound_three_hold_it(causal):
    """At the card check's draw (randn q, k, v; D 64, L 256), one TF32
    pass of each product misses 1e-4 several times over; three keep
    under a tenth of it."""
    q, k, v = (torch.from_numpy(a) for a in case(2, 8, 256, 256, 64, 7))
    plain = flash_attention.blockwise_attention(q, k, v, causal)
    one = (emulate(q, k, v, causal, passes=one_pass) - plain).abs().max()
    three = (emulate(q, k, v, causal) - plain).abs().max()
    assert one.item() > 3 * TOL
    assert three.item() <= 0.1 * TOL


def test_truncated_lo_agrees_with_rounded_lo():
    """The kernel hands ``lo`` to the tensor core untruncated (the core
    drops its low bits) instead of rounding it first: the two
    arithmetics agree far inside the bound."""
    q, k, v = (torch.from_numpy(a) for a in case(1, 4, 128, 128, 64, 3))
    for causal in (True, False):
        a = emulate(q, k, v, causal)
        b = emulate(q, k, v, causal, passes=three_passes(lo_round=True))
        assert (a - b).abs().max().item() <= 1e-6


# ---------------------------------------------------------------------------
# mma.sync.m16n8k8 (TF32) at the level of its fragments: lane l holds
# a[4], b[2], c[4]; g = l // 4, t = l % 4
# ---------------------------------------------------------------------------
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4
A_ROW = np.stack([G, G + 8, G, G + 8], 1)       # a0 (g, t), a1 (g+8, t),
A_COL = np.stack([T, T, T + 4, T + 4], 1)       # a2 (g, t+4), a3 (g+8, t+4)
B_ROW = np.stack([T, T + 4], 1)                 # b0 (k t, n g), b1 (k t+4)
B_COL = np.stack([G, G], 1)
C_ROW = np.stack([G, G, G + 8, G + 8], 1)       # c0 (g, 2t), c1 (g, 2t+1),
C_COL = np.stack([2 * T, 2 * T + 1, 2 * T, 2 * T + 1], 1)   # c2, c3


def mma_fragments(a, b, c):
    """d = c + A @ B on fragments: each lane's registers scattered to the
    matrices they stand for, multiplied, gathered back."""
    A = np.zeros((16, 8))
    A[A_ROW, A_COL] = a
    B = np.zeros((8, 8))
    B[B_ROW, B_COL] = b
    C = np.zeros((16, 8))
    C[C_ROW, C_COL] = c
    D = C + A @ B
    return D[C_ROW, C_COL]


def test_relabeled_keys_take_s_fragment_into_pv():
    """S's C fragment (lane t: keys 2t, 2t+1) becomes P·V's A fragment
    with no shuffle when key 2t is the mma's k = t and key 2t+1 its
    k = t + 4, V's rows read the same way; reading V unrelabeled (rows
    t, t+4) gives another product."""
    rs = np.random.RandomState(0)
    P = rs.rand(16, 8)                 # 16 query rows x one 8-key block
    V = rs.randn(8, 8)                 # 8 keys x 8 output columns
    c = P[C_ROW, C_COL]                # P as the S mma left it
    a = c[:, [0, 2, 1, 3]]             # a0 = c0, a1 = c2, a2 = c1, a3 = c3
    b = np.stack([V[2 * T, G], V[2 * T + 1, G]], 1)
    out = np.zeros((16, 8))
    out[C_ROW, C_COL] = mma_fragments(a, b, np.zeros((32, 4)))
    np.testing.assert_allclose(out, P @ V, rtol=1e-12, atol=1e-12)
    b_plain = np.stack([V[T, G], V[T + 4, G]], 1)
    wrong = np.zeros((16, 8))
    wrong[C_ROW, C_COL] = mma_fragments(a, b_plain, np.zeros((32, 4)))
    assert np.abs(wrong - P @ V).max() > 0.1


def test_fragment_mma_is_the_ptx_layout():
    """The fragment emulation itself: Q·Kᵀ from A and B fragments read
    as the kernel reads them (Q rows g, g+8, columns t, t+4; K row g,
    columns t, t+4) lands in C as rows g, g+8 and columns 2t, 2t+1."""
    rs = np.random.RandomState(1)
    Q, K = rs.randn(16, 8), rs.randn(8, 8)     # 16 rows, 8 keys, k = 8
    a = Q[A_ROW, A_COL]
    b = np.stack([K[G, T], K[G, T + 4]], 1)    # B (k, n) = K[n, k]
    d = mma_fragments(a, b, np.zeros((32, 4)))
    np.testing.assert_allclose(d, (Q @ K.T)[C_ROW, C_COL], rtol=1e-12,
                               atol=1e-12)


def test_emulation_crosses_a_ragged_tile():
    """The emulated body and the plain version agree on a length that
    crosses a tile (70 keys: a 64-key tile and a ragged 6-key one)."""
    q, k, v = (torch.from_numpy(a) for a in case(1, 2, 70, 70, 16, 5))
    for causal in (True, False):
        got = emulate(q, k, v, causal)
        want = flash_attention.blockwise_attention(q, k, v, causal)
        assert (got - want).abs().max().item() <= TOL
