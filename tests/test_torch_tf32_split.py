"""A CPU rehearsal of the 3xTF32 arithmetic of the flash-attention kernels.

The forward kernel (B1/B2), the dQ kernel (B3) and the dK/dV kernel (B4)
run their float32 products on the tensor cores as three TF32 products: each operand x is
split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, and a product
``a b`` is taken as ``lo_a hi_b + hi_a lo_b + hi_a hi_b`` (``lo lo`` is
dropped), summed in float32. TF32 keeps 10 mantissa bits and rounds to
nearest with ties away from zero (``cvt.rna.tf32.f32``). Here that
rounding is emulated by bit arithmetic on int32 views, and the kernels'
loops (64-key tiles with an online softmax; 64-key tiles accumulating dQ;
64-query tiles accumulating dK and dV) are written out in plain PyTorch
around the emulated products. Each tile's product is a fresh sum, added
to the accumulator in float32, as the kernels add it.

What is shown, with the float32 tolerance of kernel against plain version
that ``chip_smoke.py`` holds on the card, ``|err| <= 1e-5 * max|plain| +
1e-5 * |plain|`` per output, the -1e30 lse of a fully masked row exact:
the split keeps (out, lse), dq and (dk, dv) within it of the plain
versions, and a single TF32 pass does not (so the test can see the
difference).
"""
import numpy as np
import pytest
import torch

from helpers.torch_threads import one_torch_thread  # noqa: F401
from paddle_tpu_torch.ops.kernels import flash_attention as fa

NEG = -1e30
FLOOR, RTOL = 1e-5, 1e-5  # chip_smoke.py's TOL[torch.float32]
TILE = 64  # keys per forward and dQ tile, queries per dK/dV tile


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half of the dropped 13 bits to the magnitude, clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_split(a, b):
    """a @ b as three TF32 products, small terms first."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_single(a, b):
    """a @ b as one TF32 product (what the kernels must not do)."""
    return tf32(a) @ tf32(b)


def fwd_emulated(mm, q, k, v, scale, q_offset=0, kv_offset=0):
    """The forward kernel's loop: causal, online softmax over key tiles."""
    S, D = q.shape
    rows = q_offset + torch.arange(S)
    m = torch.full((S,), NEG)
    l = torch.zeros(S)
    o = torch.zeros(S, D)
    for k0 in range(0, k.shape[0], TILE):
        kt, vt = k[k0:k0 + TILE], v[k0:k0 + TILE]
        keys = kv_offset + k0 + torch.arange(kt.shape[0])
        s = (mm(q, kt.T) * scale).masked_fill(keys[None] > rows[:, None],
                                              NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alive = m_new > NEG / 2
        p = torch.where(alive[:, None], torch.exp(s - m_new[:, None]),
                        torch.zeros(()))
        corr = torch.where(alive, torch.exp(m - m_new), torch.ones(()))
        l = l * corr + p.sum(-1)
        o = o * corr[:, None] + mm(p, vt)
        m = m_new
    safe = torch.where(l == 0, torch.ones(()), l)
    return o / safe[:, None], torch.where(l == 0, torch.full((), NEG),
                                          m + torch.log(safe))


def dq_emulated(mm, q, k, v, do, lse, delta, scale, q_offset=0,
                kv_offset=0):
    """The dQ kernel's loop: causal, query rows, key tiles."""
    rows = q_offset + torch.arange(q.shape[0])
    dq = torch.zeros_like(q)
    for k0 in range(0, k.shape[0], TILE):
        kt, vt = k[k0:k0 + TILE], v[k0:k0 + TILE]
        keys = kv_offset + k0 + torch.arange(kt.shape[0])
        s = (mm(q, kt.T) * scale).masked_fill(keys[None] > rows[:, None],
                                              NEG)
        p = torch.where(s <= NEG / 2, torch.zeros(()),
                        torch.exp(s - lse[:, None]))
        ds = p * (mm(do, vt.T) - delta[:, None]) * scale
        dq = dq + mm(ds, kt)
    return dq


def dkv_emulated(mm, q, k, v, do, lse, delta, scale, q_offset=0,
                 kv_offset=0):
    """The dK/dV kernel's loop: causal, keys as rows, query tiles."""
    keys = kv_offset + torch.arange(k.shape[0])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, q.shape[0], TILE):
        qt, dot = q[q0:q0 + TILE], do[q0:q0 + TILE]
        rows = q_offset + q0 + torch.arange(qt.shape[0])
        st = (mm(k, qt.T) * scale).masked_fill(keys[:, None] > rows[None],
                                               NEG)
        pt = torch.where(st <= NEG / 2, torch.zeros(()),
                         torch.exp(st - lse[None, q0:q0 + TILE]))
        dst = pt * (mm(v, dot.T) - delta[None, q0:q0 + TILE]) * scale
        dv = dv + mm(pt, dot)
        dk = dk + mm(dst, qt)
    return dk, dv


def within(got, want):
    """chip_smoke.py's float32 check: every element within tolerance,
    the -1e30 sentinel exact."""
    err = (got - want).abs()
    sentinel = want <= -1e29
    bound = FLOOR * want.abs().masked_fill(sentinel, 0).max() \
        + RTOL * want.abs()
    return bool(torch.where(sentinel, err == 0, err <= bound).all())


def inputs(S, D, seed):
    rng = np.random.RandomState(seed)
    return [torch.as_tensor(rng.standard_normal((S, D)), dtype=torch.float32)
            for _ in range(4)]


# (S, D, kv_offset): the training head at S = 1024, and a case whose first
# 64 rows see no key (out = 0, lse = -1e30, no gradient)
CASES = [(1024, 64, 0), (256, 64, 64)]


def reference(S, D, ko, seed=0):
    q, k, v, do = inputs(S, D, seed)
    scale = D ** -0.5
    kw = dict(causal=True, scale=scale, kv_offset=ko)
    out, lse = fa.flash_attention_fwd_plain(q[None, None], k[None, None],
                                            v[None, None], **kw)
    out, lse = out[0, 0], lse[0, 0]
    delta = (do * out).sum(-1)
    dq, dk, dv = fa.flash_attention_bwd_plain(
        q[None, None], k[None, None], v[None, None], do[None, None],
        lse[None, None], delta[None, None], **kw)
    return (q, k, v, do, scale), (out, lse, delta), (dq[0, 0], dk[0, 0],
                                                     dv[0, 0])


@pytest.mark.parametrize("S,D,ko", CASES)
def test_split_forward_within_tolerance(S, D, ko):
    (q, k, v, _, scale), (out, lse, _), _ = reference(S, D, ko)
    got_o, got_l = fwd_emulated(mm_split, q, k, v, scale, kv_offset=ko)
    assert within(got_o, out)
    assert within(got_l, lse)
    if ko:
        assert (got_o[:ko] == 0).all() and (got_l[:ko] == NEG).all()


@pytest.mark.parametrize("S,D,ko", CASES)
def test_split_dq_within_tolerance(S, D, ko):
    (q, k, v, do, scale), (_, lse, delta), (dq, _, _) = reference(S, D, ko)
    got = dq_emulated(mm_split, q, k, v, do, lse, delta, scale, kv_offset=ko)
    assert within(got, dq)
    if ko:  # rows that see no key get no gradient
        assert (got[:ko] == 0).all()


@pytest.mark.parametrize("S,D,ko", CASES)
def test_split_dkv_within_tolerance(S, D, ko):
    (q, k, v, do, scale), (_, lse, delta), (_, dk, dv) = reference(S, D, ko)
    got_dk, got_dv = dkv_emulated(mm_split, q, k, v, do, lse, delta, scale,
                                  kv_offset=ko)
    assert within(got_dk, dk)
    assert within(got_dv, dv)


def test_single_tf32_pass_misses_the_tolerance():
    (q, k, v, do, scale), (out, lse, delta), (dq, dk, dv) = \
        reference(1024, 64, 0)
    got_o, got_l = fwd_emulated(mm_single, q, k, v, scale)
    assert not within(got_o, out)
    assert not within(got_l, lse)
    assert not within(dq_emulated(mm_single, q, k, v, do, lse, delta, scale),
                      dq)
    got_dk, got_dv = dkv_emulated(mm_single, q, k, v, do, lse, delta, scale)
    assert not within(got_dk, dk)
    assert not within(got_dv, dv)


def test_tf32_rounding_is_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                      1 + 3 * one_ulp / 4, 3.0])
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp, 3.0])
    assert torch.equal(tf32(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - hi).abs() <= hi.abs() * 2.0 ** -11).all()
