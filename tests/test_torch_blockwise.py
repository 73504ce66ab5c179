"""The port's blockwise attention (``nn/layers/ring_attention.py``) and
``MultiHeadAttention(attn_impl="blockwise")`` against paddle_tpu's.

``_blockwise_raw`` in both packages on the same seeded numpy q, k, v
``[B, H, S, D]``: the unrolled program (up to 16 key blocks) and the
recomputing scan beyond it (paddle_tpu's custom-VJP ``_blockwise_scan``,
the port's ``_BlockwiseScan``), causal and not, with S and Sk divisible
by the block and ragged; outputs within rtol 1e-5 / atol 1e-6, and the
VJP (paddle_tpu's ``jax.vjp``, the port's autograd) of a seeded cotangent
within 1e-5 of each gradient's largest value. Both run float32 on the
CPU, where paddle_tpu's routing also takes the blockwise program.

Then the route: on the CPU the port takes the torch program; a CUDA
tensor of divisible shape takes ``FlashAttentionFunction`` (forced here on
the CPU, where that Function runs its kernels' plain versions), with AMP
casting q, k and v as ``flash_attention``. ``MultiHeadAttention`` and
``TransformerEncoderLayer`` on the blockwise route against paddle_tpu's
on carried weights, the reference's refusals, and a 2-layer, d 128 slice
of the BERT-on-blockwise program ``chip_smoke.py`` trains at full width:
one batch's loss and gradients (1e-4 of each largest) and three
``Lamb`` steps through ``TrainStep`` (losses within 1e-5, parameters
within 1e-5 of each largest).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.distributed import comm
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.nn.layers import ring_attention as jra

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn.layers import ring_attention as tra
from test_torch_bert_training import _random_state
from test_torch_nn_activation import carry, compare
from test_torch_ops_math import arr, cpu_device  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-5

# (B, H, S, Sk, D, block, causal)
RAW = [
    (2, 2, 16, 16, 8, 4, False),
    (2, 2, 16, 16, 8, 4, True),
    (1, 3, 13, 19, 8, 5, False),     # ragged: the last block short
    (1, 3, 19, 19, 8, 5, True),
    (1, 2, 40, 40, 8, 2, True),      # 20 blocks: the recomputing scan
    (1, 2, 24, 37, 8, 2, False),     # 19 blocks, padded
    (1, 2, 37, 37, 16, 2, True),
]


def _qkv(B, H, S, Sk, D, seed=0):
    return (arr((B, H, S, D), seed=seed), arr((B, H, Sk, D), seed=seed + 1),
            arr((B, H, Sk, D), seed=seed + 2))


def _near(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * scale, f"{what}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("B,H,S,Sk,D,block,causal", RAW, ids=[
    f"S{c[2]}-Sk{c[3]}-block{c[5]}-{'causal' if c[6] else 'full'}"
    for c in RAW])
def test_blockwise_raw_and_vjp(B, H, S, Sk, D, block, causal):
    q, k, v = _qkv(B, H, S, Sk, D)
    g = arr((B, H, S, D), seed=9)

    def jf(a, b, c):
        return jra._blockwise_raw(a, b, c, causal=causal, block_size=block)

    want, vjp = jax.vjp(jf, *(jax.numpy.asarray(t) for t in (q, k, v)))
    jgrads = vjp(jax.numpy.asarray(g))
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    got = tra._blockwise_raw(tq, tk, tv, causal=causal, block_size=block)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    got.backward(torch.tensor(g))
    for name, t, jg in zip("qkv", (tq, tk, tv), jgrads):
        _near(t.grad.numpy(), np.asarray(jg), f"d{name}")


def test_scan_is_taken_beyond_sixteen_blocks(monkeypatch):
    """Over 16 blocks the port's program is ``_BlockwiseScan`` (q, k, v,
    out, lse saved), as paddle_tpu's is its custom VJP."""
    calls = []
    real = tra._BlockwiseScan.apply
    monkeypatch.setattr(tra._BlockwiseScan, "apply",
                        lambda *a: calls.append(a[3:]) or real(*a))
    q, k, v = (torch.tensor(t) for t in _qkv(1, 1, 34, 34, 4))
    tra._blockwise_raw(q, k, v, block_size=2)
    tra._blockwise_raw(q, k, v, block_size=4)
    assert calls == [(False, 2, 0.5)]


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_matches(causal):
    """The public function in both packages (CPU: the blockwise program),
    its default block and an explicit scale."""
    q, k, v = _qkv(2, 2, 24, 24, 8, seed=3)
    for kw in (dict(), dict(block_size=8, scale=0.3)):
        compare(lambda a, b, c: jra.blockwise_attention(a, b, c, causal,
                                                        **kw),
                lambda a, b, c: tra.blockwise_attention(a, b, c, causal,
                                                        **kw), (q, k, v))


def test_kernel_route(monkeypatch):
    """Which route: the kernels only for a CUDA tensor whose S and Sk
    divide by their blocks; forced on the CPU, the route calls
    ``FlashAttentionFunction`` with those blocks and ``causal``, casts
    under AMP as ``flash_attention`` (bf16 in, bf16 out), and computes
    the program's function."""
    q, k, v = (torch.tensor(t) for t in _qkv(2, 2, 16, 32, 8, seed=5))
    assert not tra.kernel_route(q, k, 8)
    seen = []
    real = tra.FlashAttentionFunction.apply

    def spy(*a):
        seen.append((a[0].dtype, a[3:7]))
        return real(*a)

    monkeypatch.setattr(tra.FlashAttentionFunction, "apply", spy)
    monkeypatch.setattr(tra, "kernel_route", lambda *a: True)
    for causal in (False, True):
        want = tra._blockwise_raw(q, k, v, causal=causal, block_size=8)
        got = tra.blockwise_attention(q, k, v, causal, block_size=8)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    with pt.amp.auto_cast(True, level="O1", dtype="bfloat16"):
        out = tra.blockwise_attention(q, k, v, True, block_size=512)
    assert out.dtype == torch.bfloat16
    assert seen == [(torch.float32, (False, 8, 8, None)),
                    (torch.float32, (True, 8, 8, None)),
                    (torch.bfloat16, (True, 16, 32, None))]
    # the torch program is neither white- nor black-listed: no cast
    monkeypatch.setattr(tra, "kernel_route", lambda *a: False)
    with pt.amp.auto_cast(True, level="O1", dtype="bfloat16"):
        assert tra.blockwise_attention(q, k, v).dtype == torch.float32


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_blockwise(causal):
    """``MultiHeadAttention(attn_impl="blockwise")`` (block 4 over 12
    tokens: three blocks) against paddle_tpu's, and against the port's
    dense route on the same weights."""
    E, Hn, T, Bn = 16, 4, 12, 2
    jl = jnn.MultiHeadAttention(E, Hn, attn_impl="blockwise", causal=causal,
                                block_size=4)
    tl = tnn.MultiHeadAttention(E, Hn, attn_impl="blockwise", causal=causal,
                                block_size=4)
    params = carry(jl, tl)
    x = arr((Bn, T, E), seed=6)
    compare(jl, tl, (x,), params=params)
    dense = tnn.MultiHeadAttention(E, Hn, causal=causal)
    dense.set_state_dict(tl.state_dict())
    xt = pt.to_tensor(x)
    np.testing.assert_allclose(tl(xt).numpy(), dense(xt).numpy(), **TOL)


def _zero_mask(pkg):
    return pkg.to_tensor(np.zeros((1, 1, 4, 4), np.float32))


def _zero_pos(pkg):
    return pkg.to_tensor(np.zeros(1, np.int64))


#: (layer arguments, the refused call on a layer of package pkg)
REFUSED = {
    "attn_mask": (dict(), lambda pkg, m, x: m(x, attn_mask=_zero_mask(pkg))),
    "need_weights": (dict(need_weights=True), lambda pkg, m, x: m(x)),
    "dropout": (dict(dropout=0.1), lambda pkg, m, x: (m.train(), m(x))),
    "cache": (dict(), lambda pkg, m, x: m(x, cache=m.gen_cache(x))),
    "static_capacity": (dict(), lambda pkg, m, x: m(
        x, cache=m.gen_cache(x, max_length=8), pos=_zero_pos(pkg))),
}


def test_blockwise_refusals_and_other_impls():
    """What the blockwise route refuses, as paddle_tpu does, and the
    sequence-parallel routes (``ring``, ``ring_pallas``, ``ulysses``):
    the same refusals; without a mesh both packages raise RuntimeError;
    on a one-rank mesh (sp 1) each route equals paddle_tpu's on carried
    weights (the multi-rank worlds: tests/test_torch_sequence_parallel.py)."""
    from paddle_tpu_torch.distributed import comm as tcomm

    E = 8
    x = arr((1, 4, E))
    for impl in ("blockwise", "ring", "ring_pallas", "ulysses"):
        for what, (make, call) in REFUSED.items():
            for pkg in (paddle_tpu, pt):
                m = pkg.nn.MultiHeadAttention(E, 2, attn_impl=impl, **make)
                with pytest.raises(NotImplementedError):
                    call(pkg, m, pkg.to_tensor(x))
    with pytest.raises(ValueError):
        tnn.MultiHeadAttention(E, 2, attn_impl="sparse")
    prev = comm._state.hybrid_mesh, tcomm._mesh
    try:
        comm._state.hybrid_mesh = tcomm._mesh = None
        for impl in ("ring", "ring_pallas", "ulysses"):
            for pkg in (paddle_tpu, pt):
                m = pkg.nn.MultiHeadAttention(E, 2, attn_impl=impl)
                with pytest.raises(RuntimeError, match="mesh"):
                    m(pkg.to_tensor(x))
        comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
        tcomm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
        xs = arr((2, 8, E), seed=4)
        for impl in ("ring", "ring_pallas", "ulysses"):
            jl = jnn.MultiHeadAttention(E, 2, attn_impl=impl, causal=True,
                                        block_size=4)
            tl = tnn.MultiHeadAttention(E, 2, attn_impl=impl, causal=True,
                                        block_size=4)
            compare(jl, tl, (xs,), params=carry(jl, tl))
    finally:
        comm._state.hybrid_mesh, tcomm._mesh = prev


# -- BERT on blockwise attention with LAMB: the 2-layer slice -------------------

VOCAB, D, HEADS, LAYERS, S, B = 64, 128, 4, 2, 16, 2
BLOCK = 8


def _bert(pkg):
    class Bert(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = pkg.nn.Embedding(VOCAB, D)
            self.pos = pkg.nn.Embedding(S, D)
            self.encoder = pkg.nn.LayerList([
                pkg.nn.TransformerEncoderLayer(D, HEADS, 4 * D, dropout=0.0,
                                               attn_impl="blockwise")
                for _ in range(LAYERS)])
            for lyr in self.encoder:
                lyr.self_attn.block_size = BLOCK
            self.head = pkg.nn.Linear(D, 2)

        def forward(self, ids):
            h = self.embed(ids) + self.pos(pkg.arange(ids.shape[1],
                                                      dtype="int64"))
            for lyr in self.encoder:
                h = lyr(h)
            return self.head(h.mean(axis=1))

    return Bert()


@pytest.fixture(scope="module")
def bert_env():
    prev = comm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_GUARD_MODE", "skip")
        for knob in ("PADDLE_GUARD_SPIKE_FACTOR", "PADDLE_GUARD_CHECK_PARAMS",
                     "PADDLE_FAULT_SPEC", "PADDLE_FLASH_DEFAULT",
                     "PADDLE_FUSED_LN"):
            mp.delenv(knob, raising=False)
        comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
        yield
    comm._state.hybrid_mesh = prev


def test_bert_blockwise_lamb_slice(bert_env):
    jm, tm = _bert(paddle_tpu), _bert(pt)
    state = _random_state({k: np.shape(v._data)
                           for k, v in jm.state_dict().items()})
    jm.set_state_dict(state)
    assert tm.set_state_dict(state) == ([], [])
    ids = np.random.RandomState(1).randint(0, VOCAB, (B, S))
    y = np.arange(B) % 2
    jopt = jax_optimizer.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01,
                              parameters=jm.parameters())
    topt = pt.optimizer.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01)
    jstep = JaxTrainStep(jm, lambda o, t: jnn.functional.cross_entropy(o, t),
                         jopt)
    tstep = pt.jit.TrainStep(
        tm, lambda o, t: tnn.functional.cross_entropy(o, t), topt)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jstep._loss_of(p, (), None, (jax.numpy.asarray(ids),),
                                 (jax.numpy.asarray(y),))[0]))(
        tuple(p._data for p in jstep._p_objs))
    name_of = {id(p): n for n, p in jm.named_parameters()}
    want = {name_of[id(p)]: np.asarray(g)
            for p, g in zip(jstep._p_objs, jgrads)}
    tloss = tnn.functional.cross_entropy(tm(torch.as_tensor(ids)),
                                         torch.as_tensor(y))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5)
    for n, p in tm.named_parameters():
        g = p.grad.numpy()
        assert np.abs(g - want[n]).max() <= 1e-4 * np.abs(want[n]).max(), n
        p.grad = None
    for _ in range(3):
        jl = float(jstep(paddle_tpu.to_tensor(ids), paddle_tpu.to_tensor(y)))
        tl = float(tstep(torch.as_tensor(ids), torch.as_tensor(y)))
        np.testing.assert_allclose(tl, jl, atol=1e-5)
    jp = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        v = v.detach().numpy()
        assert np.abs(v - jp[k]).max() <= 1e-5 * np.abs(jp[k]).max(), k
