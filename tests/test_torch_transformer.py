"""``nn.Transformer`` in the port against paddle_tpu's, as a Paddle 2.0
translation script writes it (the shape of Paddle's machine-translation
example, the chip run's ``translation`` phase at a small size).

The script is ``chip_smoke.py``'s (``translation_model``,
``padding_mask``, ``smoothed_loss``, ``greedy``), written once against
the Paddle surface and run here through each package. The model: a
shared word ``Embedding`` (padding id 0) scaled by sqrt(d_model),
sinusoidal positions computed with the package's ops, ``nn.Transformer`` (post-LN, ReLU), and the output
projection tied to the embedding (``matmul(h, emb.weight,
transpose_y=True)``). Here at 2 + 2 layers, d_model 128, 4 heads, ffn 256,
vocab 512, B 2, source 16 (row 1's last 4 positions padding), target 12,
with the reference's weights carried by ``set_state_dict``. Both packages
run with ``PADDLE_FUSED_LN=interpret``: the LayerNorms of 32 and 24 rows
take the kernel route, paddle_tpu's through the Pallas interpreter and
the port's through B5/B7's plain versions.

Checked, float32: the forward at dropout 0 with the padding mask and the
causal ``tgt_mask`` (max |err| <= 1e-5); three Adam steps (beta2 0.98,
epsilon 1e-9, NoamDecay at a warmup of 4) of
``CrossEntropyLoss(soft_label=True)`` over ``label_smooth(one_hot(.))``
(losses within 1e-5 relative, step 1's gradients within 1e-5 and
parameters within 1e-4 of their largest value, every parameter having
moved by more than ten times that); greedy decoding through the
encoder, ``decoder.gen_cache(memory)`` and the incremental cache (tokens
equal, logits within 1e-5, and the port's cached logits against its full
teacher-forced forward); ``TransformerLM(dropout=0.1,
use_flash_attention=False)`` building and training in both packages; and,
in the port alone, that the LayerNorms reach the B5/B7 wrappers as often
as the path needs (12 + 18 a Transformer-base forward: here 4 + 6).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import comm as jcomm
from paddle_tpu.serving import TransformerLM as JaxLM

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from chip_smoke import greedy, padding_mask, smoothed_loss, translation_model
from paddle_tpu_torch.ops.kernels import layer_norm as ln_kernels
from test_torch_ops_math import cpu_device  # noqa: F401

V, D, HEADS, LAYERS, FFN = 512, 128, 4, 2, 256
B, S, T = 2, 16, 12
TOL = 1e-5


class _JaxEmbedding(jnn.Embedding):
    """The reference's ``Embedding`` with ``padding_idx``: its constructor
    zeroes the padding row through a numpy view of the weight, read-only
    under JAX 0.9 (ROADMAP queue C's caveats), so this one does it in two
    steps."""

    def __init__(self, num, dim, padding_idx=None, **kw):
        super().__init__(num, dim, **kw)
        if padding_idx is not None:
            self._padding_idx = padding_idx % num
            w = self.weight.numpy().copy()
            w[self._padding_idx] = 0
            self.weight.set_value(w)


@pytest.fixture(scope="module")
def env():
    prev = jcomm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_FUSED_LN", "interpret")
        for knob in ("PADDLE_FLASH_DEFAULT", "PADDLE_GUARD_MODE",
                     "PADDLE_FAULT_SPEC"):
            mp.delenv(knob, raising=False)
        mp.setattr(jnn, "Embedding", _JaxEmbedding)
        jcomm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
        yield
    jcomm._state.hybrid_mesh = prev


def _random_state(model, seed=3):
    r = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("norm1.weight") or "norm" in k and k.endswith(
                "weight"):
            a = 1 + 0.2 * r.randn(*shape)
        elif k.endswith("bias"):
            a = 0.2 * r.randn(*shape)
        elif k == "emb.weight":
            a = r.randn(*shape) / math.sqrt(D)
            a[0] = 0
        else:
            a = r.randn(*shape) / math.sqrt(shape[0])
        out[k] = a.astype(np.float32)
    return out


def _models(dropout=0.0):
    jm = translation_model(paddle_tpu, V, D, HEADS, LAYERS, FFN, dropout)
    state = _random_state(jm)
    assert jm.set_state_dict(state) == ([], []) or True
    tm = translation_model(pt, V, D, HEADS, LAYERS, FFN, dropout)
    assert tm.set_state_dict(state) == ([], [])
    return jm, tm


def _batch(seed=0):
    r = np.random.RandomState(seed)
    src = r.randint(2, V, (B, S))
    src[1, -4:] = 0
    tgt = r.randint(2, V, (B, T + 1))
    return src, tgt[:, :-1], tgt[:, 1:]


def _inputs(paddle, src, tgt):
    s, t = paddle.to_tensor(src), paddle.to_tensor(tgt)
    return s, t, padding_mask(paddle, s), \
        paddle.nn.Transformer.generate_square_subsequent_mask(T)


def _max_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_square_subsequent_mask(env):
    for n in (1, 5):
        j = paddle_tpu.nn.Transformer.generate_square_subsequent_mask(n)
        t = pt.nn.Transformer.generate_square_subsequent_mask(n)
        assert "float32" in str(t.dtype)
        np.testing.assert_array_equal(t.numpy(), j.numpy())
    assert t.numpy()[0, 1] == -1e9


def test_forward_matches(env):
    """The whole model at dropout 0, padding and causal masks."""
    jm, tm = _models()
    src, tgt, _ = _batch()
    jo = jm(*_inputs(paddle_tpu, src, tgt))
    to = tm(*_inputs(pt, src, tgt))
    assert tuple(to.shape) == (B, T, V)
    assert _max_err(to.numpy(), jo.numpy()) <= TOL


def _grad(p):
    g = p.grad
    return np.array(g.detach().numpy() if isinstance(g, torch.Tensor)
                    else g.numpy())


def _train(paddle, model, steps=3):
    """Three Adam steps under NoamDecay at a warmup of 4 (rates 1.1e-3,
    1.1e-3, 2.2e-3: the chip's warmup of 4000 moves a parameter by about
    3e-6, below any check of its value) -> (losses, step 1's gradients)."""
    sched = paddle.optimizer.lr.NoamDecay(d_model=D, warmup_steps=4,
                                          learning_rate=0.1)
    opt = paddle.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                                epsilon=1e-9,
                                parameters=model.parameters())
    src, tgt, label = _batch(1)
    s, t, sm, tmk = _inputs(paddle, src, tgt)
    lab = paddle.to_tensor(label)
    losses, grads = [], None
    for _ in range(steps):
        loss = smoothed_loss(paddle, model(s, t, sm, tmk), lab, V)
        loss.backward()
        if grads is None:
            grads = {k: _grad(p) for k, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))
    return losses, grads


def test_three_adam_steps_match(env):
    """Losses within 1e-5 relative; step 1's gradients within 1e-5 of
    each parameter's largest; parameters within 1e-4 of their largest
    value, where every parameter moved by more than ten times that (so an
    update that is wrong or missing shows). Adam's first step is about
    lr * sign(g), so an element whose gradient is within rounding of 0
    (the key bias's is 0 exactly: softmax ignores it) moves by +-lr in
    either package at random. The parameter check leaves out the elements
    whose step 1 gradient is below 1e-4 of their parameter's largest (ten
    times the gradient check's tolerance) and not 0 in both packages (a
    ReLU unit off for the whole batch), and holds them to under 2% of all
    (0.96% here)."""
    jm, tm = _models()
    start = {k: np.asarray(p._data).copy() for k, p in jm.named_parameters()}
    (jl, jg), (tl, tg) = _train(paddle_tpu, jm), _train(pt, tm)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert all(np.isfinite(jl)) and abs(jl[2] - jl[0]) > 1e3 * TOL * jl[0]
    tparams = dict(tm.named_parameters())
    left_out = total = 0
    for name, p in jm.named_parameters():
        g = np.abs(jg[name]).max()
        assert _max_err(tg[name], jg[name]) <= TOL * g, name
        want = np.asarray(p._data)
        got = tparams[name].detach().numpy()
        scale = float(np.abs(want).max())
        assert _max_err(want, start[name]) > 10 * 1e-4 * scale, name
        kept = (np.abs(jg[name]) >= 1e-4 * g) | (
            (jg[name] == 0) & (tg[name] == 0))
        left_out += int((~kept).sum())
        total += kept.size
        assert _max_err(got[kept], want[kept]) <= 1e-4 * scale, name
    assert left_out < 0.02 * total, (left_out, total)


def test_cached_greedy_decode_matches(env):
    """Tokens equal and cached logits within 1e-5 between the packages,
    and the port's cached logits against its own full teacher-forced
    forward over the same tokens."""
    jm, tm = _models()
    jm.eval()
    tm.eval()
    src = _batch(2)[0]
    jtok, jlog = greedy(paddle_tpu, jm, paddle_tpu.to_tensor(src),
                        padding_mask(paddle_tpu, paddle_tpu.to_tensor(src)),
                        T)
    s = pt.to_tensor(src)
    sm = padding_mask(pt, s)
    ttok, tlog = greedy(pt, tm, s, sm, T)
    np.testing.assert_array_equal(ttok.numpy(), jtok.numpy())
    assert _max_err(tlog.numpy(), jlog.numpy()) <= TOL
    tgt = pt.concat([pt.full([B, 1], 1, dtype="int64"), ttok[:, :-1]],
                    axis=1)
    full = tm(s, tgt, sm,
              pt.nn.Transformer.generate_square_subsequent_mask(T))
    assert _max_err(full.numpy(), tlog.numpy()) <= TOL


def test_decoder_layer_and_cross_attention_caches(env):
    """One decoder layer with a ``StaticCache`` of the memory (Sq 1 against
    Sk 16) and the incremental ``Cache``, against the reference, and the
    cache it returns; the decoder stack's clones."""
    r = np.random.RandomState(4)
    jl = jnn.TransformerDecoderLayer(D, HEADS, FFN, dropout=0.0)
    tl = pt.nn.TransformerDecoderLayer(D, HEADS, FFN, dropout=0.0)
    state = {k: (r.randn(*tuple(v.shape)) * 0.1).astype(np.float32)
             for k, v in jl.state_dict().items()}
    jl.set_state_dict(state)
    assert tl.set_state_dict(state) == ([], [])
    mem = r.randn(B, S, D).astype(np.float32)
    x = r.randn(B, 1, D).astype(np.float32)
    mmask = np.where(r.rand(B, 1, 1, S) < 0.2, -1e9, 0.0).astype(np.float32)
    jc = jl.gen_cache(paddle_tpu.to_tensor(mem))
    tc = tl.gen_cache(pt.to_tensor(mem))
    for step in range(3):
        jo, jc = jl(paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(mem), None,
                    paddle_tpu.to_tensor(mmask), jc)
        to, tc = tl(pt.to_tensor(x), pt.to_tensor(mem), None,
                    pt.to_tensor(mmask), tc)
        assert _max_err(to.numpy(), jo.numpy()) <= TOL
        assert tuple(tc[0].k.shape) == (B, HEADS, step + 1, D // HEADS)
        assert _max_err(tc[1].v.numpy(), jc[1].v.numpy()) <= TOL
        x = r.randn(B, 1, D).astype(np.float32)
    # the stacks clone their first layer (the same weights, as the
    # reference's deepcopy gives) and share its dropout generator
    gen = torch.Generator().manual_seed(0)
    dec = pt.nn.TransformerDecoder(pt.nn.TransformerDecoderLayer(
        D, HEADS, FFN, generator=gen), 3)
    a, b = dec.layers[0], dec.layers[2]
    assert a is not b and b.dropout1._generator is gen
    assert torch.equal(a.linear1.weight, b.linear1.weight)


def test_layer_norms_reach_the_kernel_wrappers(env, monkeypatch):
    """Port only: a training step's LayerNorms go through the B5 and B7
    wrappers, 2 + 3 a layer (4 + 6 here, as 12 + 18 at Transformer-base
    depth), and greedy decoding of 8 sources runs B5 for the encoder's 4
    and the decoder's 6 a token (its 8 rows are eligible)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ln_kernels.layer_norm_fwd, ln_kernels.layer_norm_bwd

    def spy(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)

        return call

    monkeypatch.setattr(ln_kernels, "layer_norm_fwd", spy("fwd", fwd))
    monkeypatch.setattr(ln_kernels, "layer_norm_bwd", spy("bwd", bwd))
    tm = translation_model(pt, V, D, HEADS, LAYERS, FFN, 0.1)
    src, tgt, label = _batch(3)
    s, t, sm, tmk = _inputs(pt, src, tgt)
    smoothed_loss(pt, tm(s, t, sm, tmk), pt.to_tensor(label), V).backward()
    assert calls == {"fwd": 2 * LAYERS + 3 * LAYERS,
                     "bwd": 2 * LAYERS + 3 * LAYERS}
    calls.update(fwd=0, bwd=0)
    tm.eval()
    src8 = np.random.RandomState(5).randint(2, V, (8, S))
    s8 = pt.to_tensor(src8)
    with pt.no_grad():
        greedy(pt, tm, s8, padding_mask(pt, s8), 3)
    assert calls == {"fwd": 2 * LAYERS + 3 * LAYERS * 3, "bwd": 0}


def test_transformer_lm_dropout_and_flash_arguments(env):
    """``TransformerLM(dropout=0.1, use_flash_attention=False)`` builds in
    both packages and hands both to every block; on the same weights the
    eval forward agrees, and a training step (dropout on) gives a finite
    loss in each."""
    kw = dict(dropout=0.1, use_flash_attention=False)
    jm = JaxLM(64, 32, 4, 2, max_position=16, **kw)
    tm = pt.TransformerLM(64, 32, 4, 2, max_position=16, device="cpu", **kw)
    for blk in tm.blocks:
        assert blk.dropout == 0.1 and blk.attn.use_flash_attention is False
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert tm.set_state_dict(state) == ([], [])
    ids = np.random.RandomState(6).randint(0, 64, (2, 16))
    jm.eval()
    tm.eval()
    jo = jm(paddle_tpu.to_tensor(ids))
    to = tm(torch.as_tensor(ids))
    assert _max_err(to.detach().numpy(), jo.numpy()) <= TOL
    jm.train()
    tm.train()
    for pkg, m, x in ((paddle_tpu, jm, paddle_tpu.to_tensor(ids)),
                      (pt, tm, pt.to_tensor(ids))):
        opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=m.parameters())
        logits = m(x)
        loss = pkg.nn.functional.cross_entropy(
            logits.reshape([-1, 64]), x.reshape([-1]))
        loss.backward()
        opt.step()
        assert np.isfinite(float(loss))


def test_flash_routing_names(env, monkeypatch):
    """``flash_default_enabled`` and ``flash_routable`` give the
    reference's answers on the CPU: off the kernel unless
    ``PADDLE_FLASH_DEFAULT=interpret``, and never with a mask, active
    dropout, returned weights or a cache."""
    from paddle_tpu.nn import functional as JF

    TF = pt.nn.functional
    for knob in (None, "interpret", "0"):
        if knob is None:
            monkeypatch.delenv("PADDLE_FLASH_DEFAULT", raising=False)
        else:
            monkeypatch.setenv("PADDLE_FLASH_DEFAULT", knob)
        assert TF.flash_default_enabled() == JF.flash_default_enabled()
        for kw in ({}, {"has_mask": True}, {"dropout_active": True},
                   {"need_weights": True}, {"has_cache": True}):
            for sq, sk, causal in ((128, 128, True), (64, 128, True),
                                   (128, 128, False)):
                assert TF.flash_routable(sq, sk, causal=causal, **kw) == \
                    JF.flash_routable(sq, sk, causal=causal, **kw), \
                    (knob, kw, sq, sk, causal)
    assert TF.flash_routable(128, 128, causal=True) is False


def test_encoder_stack_matches(env):
    """``TransformerEncoder`` with a final norm (pre-LN layers) on the
    reference's weights, under a padding mask, and its ``gen_cache``."""
    jenc = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        D, HEADS, FFN, dropout=0.0, normalize_before=True), 2,
        jnn.LayerNorm(D))
    tenc = pt.nn.TransformerEncoder(pt.nn.TransformerEncoderLayer(
        D, HEADS, FFN, dropout=0.0, normalize_before=True), 2,
        pt.nn.LayerNorm(D))
    r = np.random.RandomState(7)
    state = {k: (r.randn(*tuple(v.shape)) * 0.1).astype(np.float32)
             for k, v in jenc.state_dict().items()}
    jenc.set_state_dict(state)
    assert tenc.set_state_dict(state) == ([], [])
    x = r.randn(B, S, D).astype(np.float32)
    src = _batch(8)[0]
    jo = jenc(paddle_tpu.to_tensor(x),
              padding_mask(paddle_tpu, paddle_tpu.to_tensor(src)))
    to = tenc(pt.to_tensor(x), padding_mask(pt, pt.to_tensor(src)))
    assert _max_err(to.numpy(), jo.numpy()) <= TOL
    caches = tenc.gen_cache(pt.to_tensor(x))
    assert len(caches) == 2 and tuple(caches[0].k.shape) == (
        B, HEADS, 0, D // HEADS)


def test_decoder_stack_matches(env):
    """``TransformerDecoder`` with a final norm (pre-LN layers) on the
    reference's weights, under the causal ``tgt_mask`` and a padding
    ``memory_mask``, and its ``gen_cache`` (an incremental ``Cache`` and a
    ``StaticCache`` of the memory per layer)."""
    jdec = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
        D, HEADS, FFN, dropout=0.0, normalize_before=True), 2,
        jnn.LayerNorm(D))
    tdec = pt.nn.TransformerDecoder(pt.nn.TransformerDecoderLayer(
        D, HEADS, FFN, dropout=0.0, normalize_before=True), 2,
        pt.nn.LayerNorm(D))
    r = np.random.RandomState(9)
    state = {k: (r.randn(*tuple(v.shape)) * 0.1).astype(np.float32)
             for k, v in jdec.state_dict().items()}
    jdec.set_state_dict(state)
    assert tdec.set_state_dict(state) == ([], [])
    x = r.randn(B, T, D).astype(np.float32)
    mem = r.randn(B, S, D).astype(np.float32)
    src = _batch(10)[0]
    outs = []
    for paddle, dec in ((paddle_tpu, jdec), (pt, tdec)):
        outs.append(dec(
            paddle.to_tensor(x), paddle.to_tensor(mem),
            paddle.nn.Transformer.generate_square_subsequent_mask(T),
            padding_mask(paddle, paddle.to_tensor(src))).numpy())
    assert _max_err(outs[1], outs[0]) <= TOL
    caches = tdec.gen_cache(pt.to_tensor(mem))
    assert len(caches) == 2
    assert tuple(caches[0][0].k.shape) == (B, HEADS, 0, D // HEADS)
    assert tuple(caches[0][1].k.shape) == (B, HEADS, S, D // HEADS)
