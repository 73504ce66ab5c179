"""The port's backward kernels and autograd Functions against paddle_tpu.

The plain versions of the B3/B4 flash backward and the B7 LayerNorm
backward are written from the Pallas kernels' formulas; here they are
held against those Pallas kernels run in the Pallas interpreter, on the
same numpy inputs (the CUDA kernels are held against the plain versions
on the card: tests/test_torch_cuda.py, chip_smoke.py). The autograd
Functions are held against the JAX custom_vjps, checked with
``torch.autograd.gradcheck`` in float64 on their plain route, and shown to
keep every ``TransformerLM`` parameter on the graph.

Tolerances: float32 atol 2e-5 + rtol 1e-5 (both sides compute in f32;
only the summation order differs); bfloat16 atol 1e-2 + rtol 1e-2 (both
compute in f32 from the same bf16 inputs and round each output once, so
they differ by at most a bf16 ulp, 2^-8 relative); gradcheck's float64
defaults (atol 1e-5, rtol 1e-3 against central differences).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import fused_add_layer_norm, fused_layer_norm

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import layer_norm as tln

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
jax_ln = importlib.import_module("paddle_tpu.ops.pallas.layer_norm")

F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))  # a writable copy


def _close(got, want, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.detach().float().numpy(), _f32(want),
                               **tol)


FLASH_CASES = {
    # name: (B, H, S, Sk, D, causal, q_offset, kv_offset, block_q, block_k)
    "causal_square": (2, 2, 32, 32, 16, True, 0, 0, 16, 16),
    "end_aligned": (1, 3, 16, 48, 32, True, 32, 0, 8, 16),
    "fully_masked_rows": (2, 2, 16, 16, 16, True, 0, 8, 8, 8),
    "sq_ne_sk": (2, 2, 16, 32, 16, False, 0, 0, 8, 8),
    # head dims of the CUDA kernels' 256-column tiles
    "head_dim_256": (1, 2, 32, 32, 256, True, 0, 0, 16, 16),
    "head_dim_192": (1, 2, 16, 32, 192, False, 0, 0, 8, 16),
}


def _flash_inputs(case, seed):
    B, H, S, Sk, D = FLASH_CASES[case][:5]
    r = np.random.RandomState(seed)
    q, do = (r.randn(B, H, S, D).astype(np.float32) for _ in range(2))
    k, v = (r.randn(B, H, Sk, D).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_plain_matches_pallas(case, dtype):
    """dq (B3) and dk/dv (B4) of ``flash_attention_bwd_plain`` against
    ``_backward_with_delta`` in the Pallas interpreter, on one lse and
    delta."""
    _, _, _, _, _, causal, qo, ko, bq, bk = FLASH_CASES[case]
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _flash_inputs(case, seed=len(case))
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    kw = dict(causal=causal, block_q=bq, block_k=bk, scale=None,
              interpret=True, q_offset=qo, kv_offset=ko)
    out, lse = jax_fa._forward(jq, jk, jv, return_lse=True, **kw)
    delta = jnp.sum(jdo.astype(jnp.float32) * out.astype(jnp.float32), -1)
    want = jax_fa._backward_with_delta(jq, jk, jv, jdo, lse, delta, **kw)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tlse, tdelta = torch.from_numpy(_f32(lse)), torch.from_numpy(_f32(delta))
    got = tfa.flash_attention_bwd_plain(
        tq, tk, tv, tdo, tlse, tdelta, causal=causal, q_offset=qo,
        kv_offset=ko)
    routed = tfa.flash_attention_bwd(
        tq, tk, tv, tdo, tlse, tdelta, causal=causal, block_q=bq,
        block_k=bk, q_offset=qo, kv_offset=ko)
    for g, r, w in zip(got, routed, want):
        assert g.dtype == tdt
        assert torch.equal(g, r)  # the CPU route is the plain version
        _close(g, w, dtype)
    if ko:  # fully masked rows get no gradient
        assert (got[0][:, :, :ko] == 0).all()


def test_flash_backward_block_contract_raises():
    q = torch.zeros(1, 1, 12, 8)
    lse = torch.zeros(1, 1, 12)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention_bwd(q, q, q, q, lse, lse, block_q=8, block_k=8)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["end_aligned", "head_dim_256"])
def test_flash_function_matches_custom_vjp(case, dtype):
    """``FlashAttentionFunction``'s forward and backward against the
    ``flash_attention`` custom_vjp (interpreter), same cotangent."""
    _, _, _, _, _, causal, qo, ko, bq, bk = FLASH_CASES[case]
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _flash_inputs(case, seed=7)
    jout, vjp = jax.vjp(
        lambda a, b, c: jax_fa.flash_attention(a, b, c, causal, bq, bk, None,
                                               True, qo, ko),
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    out = tfa.FlashAttentionFunction.apply(tq, tk, tv, causal, bq, bk, None,
                                           qo, ko)
    _close(out, jout, dtype)
    got = torch.autograd.grad(out, (tq, tk, tv),
                              torch.from_numpy(do).to(tdt))
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("case", ["causal_square", "head_dim_256"])
def test_flash_float16_matches_custom_vjp(case):
    """float16 q, k, v (AMP with ``use_bf16=False``): the forward and the
    backward of ``FlashAttentionFunction`` against the ``flash_attention``
    custom_vjp in the interpreter. Both compute in f32 and round each
    output to float16 once: atol 2e-3 + rtol 2e-3 (a float16 ulp is 2^-10
    relative)."""
    _, _, _, _, _, causal, qo, ko, bq, bk = FLASH_CASES[case]
    q, k, v, do = _flash_inputs(case, seed=11)
    jout, vjp = jax.vjp(
        lambda a, b, c: jax_fa.flash_attention(a, b, c, causal, bq, bk, None,
                                               True, qo, ko),
        *(jnp.asarray(a, jnp.float16) for a in (q, k, v)))
    want = (jout,) + vjp(jnp.asarray(do, jnp.float16))
    tq, tk, tv = (torch.from_numpy(a).half().requires_grad_()
                  for a in (q, k, v))
    out = tfa.FlashAttentionFunction.apply(tq, tk, tv, causal, bq, bk, None,
                                           qo, ko)
    got = (out,) + torch.autograd.grad(out, (tq, tk, tv),
                                       torch.from_numpy(do).half())
    for g, w in zip(got, want):
        assert g.dtype == torch.float16
        np.testing.assert_allclose(g.detach().float().numpy(), _f32(w),
                                   atol=2e-3, rtol=2e-3)


def _ln_inputs(shape, seed):
    r = np.random.RandomState(seed)
    x, y, g, gs = (r.randn(*shape).astype(np.float32) * 2 for _ in range(4))
    D = shape[-1]
    w = (1 + 0.3 * r.randn(D)).astype(np.float32)
    b = (0.3 * r.randn(D)).astype(np.float32)
    return x, y, g, gs, w, b


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("R,D", [(16, 128), (48, 256)])
def test_layer_norm_backward_plain_matches_pallas(R, D, dtype):
    """dx and the summed dweight/dbias partials of
    ``layer_norm_bwd_plain`` against ``_ln_backward`` (interpreter)."""
    jdt, tdt = DTYPES[dtype]
    x, _, g, _, w, b = _ln_inputs((R, D), seed=R + D)
    jx, jw, jb, jg = (jnp.asarray(a, jdt) for a in (x, w, b, g))
    _, mu, rs = jax_ln._ln_forward(jx, jw[None], jb[None], 1e-5, True)
    want = jax_ln._ln_backward(jx, jw[None], mu, rs, jg, True)
    tx, tw, tg = (torch.from_numpy(a).to(tdt) for a in (x, w, g))
    tmu, trs = torch.from_numpy(_f32(mu)), torch.from_numpy(_f32(rs))
    got = tln.layer_norm_bwd_plain(tx, tw, tmu, trs, tg)
    routed = tln.layer_norm_bwd(tx, tw, tmu, trs, tg)
    for a, r, ww in zip(got, routed, want):
        assert a.dtype == tdt
        assert torch.equal(a, r)
        _close(a, ww, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(16, 128), (2, 8, 256)], ids=str)
def test_layer_norm_functions_match_custom_vjps(shape, dtype):
    """``LayerNormFunction`` / ``AddLayerNormFunction`` against the
    ``fused_layer_norm`` / ``fused_add_layer_norm`` VJPs (interpreter):
    both addends of add-LN get dLN/ds + g_s."""
    jdt, tdt = DTYPES[dtype]
    x, y, g, gs, w, b = _ln_inputs(shape, seed=3)
    jargs = [jnp.asarray(a, jdt) for a in (x, y, w, b)]
    targs = [torch.from_numpy(a).to(tdt).requires_grad_()
             for a in (x, y, w, b)]
    jg, jgs = jnp.asarray(g, jdt), jnp.asarray(gs, jdt)
    tg, tgs = torch.from_numpy(g).to(tdt), torch.from_numpy(gs).to(tdt)

    jout, vjp = jax.vjp(lambda a, c, d: fused_layer_norm(a, c, d, 1e-5, True),
                        jargs[0], jargs[2], jargs[3])
    out = tln.LayerNormFunction.apply(targs[0], targs[2], targs[3], 1e-5)
    _close(out, jout, dtype)
    got = torch.autograd.grad(out, (targs[0], targs[2], targs[3]), tg)
    for a, ww in zip(got, vjp(jg)):
        _close(a, ww, dtype)

    (js, jo), vjp2 = jax.vjp(
        lambda a, c, d, e: fused_add_layer_norm(a, c, d, e, 1e-5, True),
        *jargs)
    s, o = tln.AddLayerNormFunction.apply(*targs, 1e-5)
    np.testing.assert_array_equal(s.detach().float().numpy(), _f32(js))
    _close(o, jo, dtype)
    got = torch.autograd.grad((s, o), targs, (tgs, tg))
    for a, ww in zip(got, vjp2((jgs, jg))):
        _close(a, ww, dtype)


def _f64(*shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64,
                       requires_grad=True)


@pytest.mark.parametrize("S,Sk,causal,qo,ko", [
    (8, 8, True, 0, 0), (4, 8, True, 4, 0), (8, 8, True, 0, 4),
    (4, 8, False, 0, 0)])
def test_gradcheck_flash_function(S, Sk, causal, qo, ko):
    q = _f64(1, 2, S, 4, seed=1)
    k, v = _f64(1, 2, Sk, 4, seed=2), _f64(1, 2, Sk, 4, seed=3)
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.FlashAttentionFunction.apply(
            a, b, c, causal, 4, 4, None, qo, ko), (q, k, v))


def test_gradcheck_layer_norm_functions():
    x, y = _f64(2, 4, 16, seed=4), _f64(2, 4, 16, seed=5)
    w, b = _f64(16, seed=6), _f64(16, seed=7)
    assert torch.autograd.gradcheck(
        lambda a, c, d: tln.LayerNormFunction.apply(a, c, d, 1e-5),
        (x, w, b))
    assert torch.autograd.gradcheck(
        lambda a, e, c, d: tln.AddLayerNormFunction.apply(a, e, c, d, 1e-5),
        (x, y, w, b))


def test_wrappers_refuse_inputs_that_require_grad():
    """Called directly with an input that requires grad, while grad mode
    is on, every wrapper raises instead of returning a result cut from the
    graph (the same rule holds on the card); under no_grad it runs."""
    q = torch.randn(1, 2, 8, 8, requires_grad=True)
    lse = torch.zeros(1, 2, 8)
    x = torch.randn(8, 128, requires_grad=True)
    w, b = torch.ones(128), torch.zeros(128)
    mu, rs = torch.zeros(8), torch.ones(8)
    calls = [
        lambda: tfa.flash_attention_fwd(q, q, q, causal=True),
        lambda: tfa.flash_attention_bwd(q, q, q, q, lse, lse, causal=True),
        lambda: tln.layer_norm_fwd(x, w, b),
        lambda: tln.add_layer_norm_fwd(x, x, w, b),
        lambda: tln.layer_norm_bwd(x, w, mu, rs, x),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()


def test_every_model_parameter_gets_a_gradient(monkeypatch):
    """The routed path keeps the whole ``TransformerLM`` on the autograd
    graph: every parameter gets a non-None, non-zero gradient, and the
    backward went through the Functions' backward routes."""
    monkeypatch.setenv("PADDLE_FLASH_DEFAULT", "interpret")
    monkeypatch.setenv("PADDLE_FUSED_LN", "interpret")
    calls = {"flash_bwd": 0, "ln_bwd": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                        counting("flash_bwd", tfa.flash_attention_bwd_plain))
    monkeypatch.setattr(tln, "layer_norm_bwd_plain",
                        counting("ln_bwd", tln.layer_norm_bwd_plain))
    model = pt.TransformerLM(48, d_model=128, num_heads=4, num_layers=2,
                             max_position=16, device="cpu", seed=3)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 48, (2, 17)))
    logits = model(ids[:, :-1])
    loss = pt.nn.functional.cross_entropy(logits.reshape(-1, 48),
                                          ids[:, 1:].reshape(-1))
    loss.backward()
    # one plain backward per layer (dq, dk and dv together on the CPU);
    # LN: 2 ln1 + ln_f, 2 add-LN
    assert calls == {"flash_bwd": 2, "ln_bwd": 5}
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert p.grad.abs().max() > 0, name


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches(reduction):
    r = np.random.RandomState(9)
    logits = r.randn(12, 7).astype(np.float32) * 3
    label = r.randint(0, 7, size=12)
    label[[2, 5]] = -100  # ignored rows
    want = JF.cross_entropy(paddle_tpu.to_tensor(logits),
                            paddle_tpu.to_tensor(label), reduction=reduction)
    got = pt.nn.functional.cross_entropy(torch.from_numpy(logits),
                                         torch.from_numpy(label),
                                         reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               **F32_TOL)
    col = pt.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label)[:, None],
        reduction=reduction)
    assert torch.equal(col, got)  # (N, 1) labels
    none = pt.nn.functional.cross_entropy(
        torch.zeros(3, 4), torch.full((3,), -100))
    assert none.item() == 0.0  # mean over max(n_valid, 1)


def test_cross_entropy_refuses_what_is_not_ported():
    """Class weights, soft labels and ``use_softmax=False`` are ported
    (held against paddle_tpu in ``test_torch_nn_loss.py``): on uniform
    logits each gives its formula's value. What ``cross_entropy`` still
    refuses is a reduction it does not know."""
    x, y = torch.zeros(3, 4), torch.zeros(3, dtype=torch.int64)
    soft = torch.full((3, 4), 0.25)
    F = pt.nn.functional
    log4 = torch.log(torch.tensor(4.0))
    torch.testing.assert_close(F.cross_entropy(x, y, weight=torch.ones(4)),
                               log4)
    torch.testing.assert_close(F.cross_entropy(x, soft, soft_label=True),
                               log4)
    torch.testing.assert_close(F.cross_entropy(x, y, use_softmax=False),
                               -torch.log(torch.tensor(1e-30)))
    with pytest.raises(ValueError):
        F.cross_entropy(x, y, reduction="avg")



@pytest.mark.parametrize("shape", [(16, 128), (2, 8, 256)], ids=str)
def test_mixed_dtype_add_layer_norm_matches_custom_vjp(shape):
    """AMP O1's residual seam: x float32 (the residual stream) and y
    bfloat16 (the attention branch). The plain B6 against the Pallas
    kernel (interpreter): s and LN(s) in float32, s bit-equal (the sum of
    an f32 and a bf16 value rounded once to f32); then dx, dy, dgamma and
    dbeta. The JAX custom_vjp returns the same f32 ``dsum`` for both
    addends; ``AddLayerNormFunction`` returns y's in y's type, so dy is
    compared after rounding the JAX one to bfloat16 (float32 tolerance on
    the rest)."""
    x, y, g, gs, w, b = _ln_inputs(shape, seed=5)
    jx, jy = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.bfloat16)
    jw, jb = jnp.asarray(w), jnp.asarray(b)
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).to(torch.bfloat16).requires_grad_()
    tw, tb = (torch.from_numpy(a).requires_grad_() for a in (w, b))

    (js, jo), vjp = jax.vjp(
        lambda a, c, d, e: fused_add_layer_norm(a, c, d, e, 1e-5, True),
        jx, jy, jw, jb)
    s, o = tln.AddLayerNormFunction.apply(tx, ty, tw, tb, 1e-5)
    assert (s.dtype, o.dtype) == (torch.float32, torch.float32)
    assert (js.dtype, jo.dtype) == (jnp.float32, jnp.float32)
    np.testing.assert_array_equal(s.detach().numpy(), _f32(js))
    _close(o, jo, "float32")
    tg, tgs = torch.from_numpy(g), torch.from_numpy(gs)
    dx, dy, dw, db = torch.autograd.grad((s, o), (tx, ty, tw, tb),
                                         (tgs, tg))
    jdx, jdy, jdw, jdb = vjp((jnp.asarray(gs), jnp.asarray(g)))
    assert (dx.dtype, dy.dtype) == (torch.float32, torch.bfloat16)
    for got, want in ((dx, jdx), (dw, jdw), (db, jdb)):
        _close(got, want, "float32")
    np.testing.assert_array_equal(
        dy.float().numpy(), _f32(jnp.asarray(jdy).astype(jnp.bfloat16)))
    # the plain wrapper takes the pair as the kernel does
    ps, po, _, _ = tln.add_layer_norm_fwd_plain(
        tx.detach().reshape(-1, shape[-1]), ty.detach().reshape(
            -1, shape[-1]), tw.detach(), tb.detach())
    np.testing.assert_array_equal(ps.numpy(), s.detach().reshape(
        -1, shape[-1]).numpy())
