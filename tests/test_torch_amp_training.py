"""The port's bf16 AMP training path against paddle_tpu's, on carried weights.

bench.py's GPT-medium training program (``_bench_gpt``: token + position
embeddings, ``ParallelGPTBlock``s, no final LayerNorm, a head used only
inside ``fused_linear_cross_entropy``; ``strategy.amp`` through
``fleet``; AdamW lr 1e-4, weight decay 0.01) is built in both packages at
2 layers, d_model 128, 2 heads, S = 128, B = 2, vocab 1000, CE chunk 256
(so the vocab has a tail chunk), with the same random numpy weights
(``set_state_dict``). Both packages run with
``PADDLE_FLASH_DEFAULT=interpret`` and ``PADDLE_FUSED_LN=interpret``:
paddle_tpu through the Pallas interpreter, the port through its kernels'
plain versions.

Checked: the AMP lists; the types at each seam of a block under
``auto_cast``; one batch's loss and every parameter's gradient under the
strategy's AMP, bf16 and float16 (paddle_tpu's gradients from
``jax.value_and_grad`` of the function its ``TrainStep`` differentiates:
its eager tape cannot take the bf16 cotangent of a float32 residual sum);
three ``TrainStep`` calls
through ``fleet.distributed_optimizer``; the float16 loss scaler's skip of
a NaN batch; and ``amp.decorate`` at O2.

Tolerances (bf16 products in both packages; one bf16 rounding is 2^-8 ~
4e-3 relative, and the two packages round sums taken in different orders,
so a rounding can fall on either side and carry through the next layer):
loss atol 2e-3; each parameter's gradient within 2e-2 of its largest
gradient, and the O2 forward's hidden state within 2e-2 of its largest
value; parameters after three AdamW steps atol 6e-4 = 3 x 2 lr (an
Adam step moves a parameter by about lr = 1e-4 in the direction of its
gradient's sign, and a gradient near zero, an embedding row of a rare
token, may take opposite signs in the two packages in every step).
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu
from paddle_tpu import amp as jax_amp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.distributed import ParallelGPTBlock as JaxBlock
from paddle_tpu.distributed import comm
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed.fleet.base import \
    _DistributedOptimizer as _JaxDistributedOptimizer
from paddle_tpu.jit import TrainStep as JaxTrainStep

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import ParallelGPTBlock
from paddle_tpu_torch.distributed import fleet

VOCAB, D, HEADS, LAYERS, S, B, CHUNK = 1000, 128, 2, 2, 128, 2, 256
LR, WD = 1e-4, 0.01
LOSS_ATOL = 2e-3
GRAD_RTOL = 2e-2
HIDDEN_RTOL = 2e-2
PARAM_ATOL = 6e-4


class JaxGPT(jnn.Layer):
    """bench.py's ``_gpt_medium`` at the test's size."""

    def __init__(self):
        super().__init__()
        self.embed = jnn.Embedding(VOCAB, D)
        self.pos = jnn.Embedding(S, D)
        self.blocks = jnn.LayerList(
            [JaxBlock(D, HEADS, dropout=0.0) for _ in range(LAYERS)])
        self.head = jnn.Linear(D, VOCAB)

    def forward(self, ids):
        h = self.embed(ids) + self.pos(paddle_tpu.arange(ids.shape[1],
                                                         dtype="int64"))
        for blk in self.blocks:
            h = blk(h)
        return h


class TorchGPT(torch.nn.Module):
    """The same model from the port's layers."""

    def __init__(self):
        super().__init__()
        kw = dict(device="cpu", generator=torch.Generator().manual_seed(0))
        self.embed = pt.nn.Embedding(VOCAB, D, **kw)
        self.pos = pt.nn.Embedding(S, D, **kw)
        self.blocks = pt.nn.LayerList(
            [ParallelGPTBlock(D, HEADS, dropout=0.0, **kw)
             for _ in range(LAYERS)])
        self.head = pt.nn.Linear(D, VOCAB, **kw)

    def forward(self, ids):
        h = self.embed(ids) + self.pos(torch.arange(ids.shape[1],
                                                    device=ids.device))
        for blk in self.blocks:
            h = blk(h)
        return h


def _numpy_state(state):
    """The port's state (or gradients by name) as numpy copies."""
    return {n: t.detach().cpu().numpy().copy() for n, t in state.items()}


def _jax_loss(model):
    def loss(h, labels, scale=None):
        out = jnn.functional.fused_linear_cross_entropy(
            h.reshape([-1, D]), model.head.weight, model.head.bias,
            labels.reshape([-1]))
        return out if scale is None else out * scale.mean()
    return loss


def _torch_loss(model):
    def loss(h, labels, scale=None):
        out = pt.nn.functional.fused_linear_cross_entropy(
            h.reshape(-1, D), model.head.weight, model.head.bias,
            labels.reshape(-1))
        return out if scale is None else out * scale.mean()
    return loss


@pytest.fixture(scope="module")
def env():
    prev = comm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_FLASH_DEFAULT", "interpret")
        mp.setenv("PADDLE_FUSED_LN", "interpret")
        mp.setenv("PADDLE_CE_CHUNK", str(CHUNK))
        mp.setenv("PADDLE_GUARD_MODE", "skip")
        for knob in ("PADDLE_GUARD_SPIKE_FACTOR", "PADDLE_GUARD_CHECK_PARAMS",
                     "PADDLE_FAULT_SPEC"):
            mp.delenv(knob, raising=False)
        comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
        yield
    comm._state.hybrid_mesh = prev


def _random_state(shapes, seed=5):
    r = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith(("ln1.weight", "ln2.weight")):
            a = 1 + 0.2 * r.randn(*shape)
        elif name.endswith("bias"):
            a = 0.2 * r.randn(*shape)
        elif name in ("embed.weight", "pos.weight"):
            a = r.randn(*shape)
        else:  # [in, out] linear weights
            a = r.randn(*shape) / np.sqrt(shape[0])
        out[name] = a.astype(np.float32)
    return out


def _models():
    jm = JaxGPT()
    state = _random_state({k: tuple(v.shape)
                           for k, v in jm.state_dict().items()})
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected
    tm = TorchGPT()
    tm.load_state_dict({n: torch.from_numpy(np.asarray(a))
                        for n, a in state.items()}, strict=True)
    return jm, tm


def _batch(seed):
    r = np.random.RandomState(seed)
    ids = r.randint(0, VOCAB, size=(B, S + 1))
    return ids[:, :-1], ids[:, 1:]


def _jax_strategy(**amp_configs):
    s = jax_fleet.DistributedStrategy()
    s.amp = True
    if amp_configs:
        s.amp_configs = amp_configs
    return s


def _torch_strategy(**amp_configs):
    s = fleet.DistributedStrategy()
    s.amp = True
    if amp_configs:
        s.amp_configs = amp_configs
    return s


def _jax_step(jm, loss, **amp_configs):
    """paddle_tpu's step of bench's program. Its ``fleet.init`` would lay a
    dp mesh over the test host's eight virtual devices; the optimizer is
    wrapped with the strategy as ``fleet.distributed_optimizer`` does, on
    the one-device mesh the model was built on."""
    opt = _JaxDistributedOptimizer(jax_optimizer.AdamW(
        learning_rate=LR, weight_decay=WD, parameters=jm.parameters()),
        _jax_strategy(**amp_configs))
    return JaxTrainStep(jm, loss, opt), opt


def _torch_step(tm, loss, **amp_configs):
    s = _torch_strategy(**amp_configs)
    fleet.init(is_collective=True, strategy=s)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=LR, weight_decay=WD))
    return pt.jit.TrainStep(tm, loss, opt), opt


def test_amp_lists_match_the_reference():
    assert pt.amp.WHITE_LIST == jax_amp.WHITE_LIST
    assert pt.amp.BLACK_LIST == jax_amp.BLACK_LIST


def test_seam_dtypes_match_the_reference(env):
    """Under bf16 O1 both packages keep the residual stream float32, run
    the attention branch and the MLP's products in bfloat16, and take the
    mixed (float32, bfloat16) residual pair to the fused add-LN, whose s
    and LN(s) come back float32."""
    jm, tm = _models()
    ids, _ = _batch(0)

    def seams(m, F, x):
        blk = m.blocks[0]
        n1 = blk.ln1(x)
        a = blk.attn(n1)
        s, n2 = F.fused_residual_layer_norm(x, a, [D], blk.ln2.weight,
                                            blk.ln2.bias, 1e-5)
        f1 = blk.fc1(n2)
        return [n1, a, s, n2, f1, F.gelu(f1), blk(x)]

    with jax_amp.auto_cast(True, level="O1", dtype="bfloat16"):
        jx = jm.embed(paddle_tpu.to_tensor(ids)) + jm.pos(
            paddle_tpu.arange(S, dtype="int64"))
        want = [str(t._data.dtype) for t in seams(jm, jnn.functional, jx)]
    with pt.amp.auto_cast(True, level="O1", dtype="bfloat16"):
        tx = tm.embed(torch.as_tensor(ids)) + tm.pos(
            torch.arange(S))
        got = [str(t.dtype)[6:] for t in seams(tm, pt.nn.functional, tx)]
    assert want == ["float32", "bfloat16", "float32", "float32", "bfloat16",
                    "bfloat16", "float32"]
    assert got == want


def test_loss_and_gradients_under_amp_match(env):
    jm, tm = _models()
    ids, lab = _batch(1)
    jstep, _ = _jax_step(jm, _jax_loss(jm))
    p_raws = tuple(p._data for p in jstep._p_objs)
    loss_and_grads = jax.jit(jax.value_and_grad(
        lambda p: jstep._loss_of(p, (), None, (jax.numpy.asarray(ids),),
                                 (jax.numpy.asarray(lab),))[0]))
    jloss, jgrads = loss_and_grads(p_raws)
    name_of = {id(p): n for n, p in jm.named_parameters()}
    want = {name_of[id(p)]: np.asarray(g)
            for p, g in zip(jstep._p_objs, jgrads)}

    tstep, _ = _torch_step(tm, _torch_loss(tm))
    with torch.enable_grad(), tstep._amp_guard():
        tloss = tstep.loss_fn(tm(torch.as_tensor(ids)),
                              torch.as_tensor(lab))
    tloss.backward()
    got = _numpy_state(
        {n: p.grad for n, p in tm.named_parameters()})
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=LOSS_ATOL,
                               rtol=0)
    assert set(got) == set(want)
    for name, g in got.items():
        assert g.dtype == np.float32, name
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        assert np.abs(g - want[name]).max() <= GRAD_RTOL * scale, name


def test_fp16_loss_and_gradients_match(env):
    """float16 O1 (``use_bf16=False``): the flash kernels' routes take
    float16 q, k and v, and the add-LN the float32 residual with the
    float16 branch; one batch's loss and every gradient as under bf16 (the
    loss scaler does not enter: both sides differentiate the unscaled
    loss)."""
    jm, tm = _models()
    ids, lab = _batch(2)
    jstep, _ = _jax_step(jm, _jax_loss(jm), use_bf16=False)
    p_raws = tuple(p._data for p in jstep._p_objs)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jstep._loss_of(p, (), None, (jax.numpy.asarray(ids),),
                                 (jax.numpy.asarray(lab),))[0]))(p_raws)
    name_of = {id(p): n for n, p in jm.named_parameters()}
    want = {name_of[id(p)]: np.asarray(g)
            for p, g in zip(jstep._p_objs, jgrads)}
    tstep, _ = _torch_step(tm, _torch_loss(tm), use_bf16=False)
    assert tstep._amp_ctx["dtype"] == "float16"
    with torch.enable_grad(), tstep._amp_guard():
        blk = tm.blocks[0]
        x = tm.embed(torch.as_tensor(ids))
        a = blk.attn(blk.ln1(x))
        s, _ = pt.nn.functional.fused_residual_layer_norm(
            x, a, [D], blk.ln2.weight, blk.ln2.bias)
        assert (a.dtype, s.dtype) == (torch.float16, torch.float32)
        tloss = tstep.loss_fn(tm(torch.as_tensor(ids)),
                              torch.as_tensor(lab))
    tloss.backward()
    got = _numpy_state(
        {n: p.grad for n, p in tm.named_parameters()})
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=LOSS_ATOL,
                               rtol=0)
    assert set(got) == set(want)
    for name, g in got.items():
        assert g.dtype == np.float32, name
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        assert np.abs(g - want[name]).max() <= GRAD_RTOL * scale, name


def test_three_train_steps_through_fleet_match(env):
    jm, tm = _models()
    jstep, _ = _jax_step(jm, _jax_loss(jm))
    tstep, topt = _torch_step(tm, _torch_loss(tm))
    assert tstep._amp_ctx["dtype"] == "bfloat16"
    assert topt.user_defined_strategy.amp
    jl, tl = [], []
    for i in range(3):
        ids, lab = _batch(10 + i)
        jl.append(float(jstep(ids, lab).numpy()))
        tl.append(tstep(ids, lab).item())
    np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
    assert tl[2] < tl[0]
    want = {k: np.array(v._data) for k, v in jm.state_dict().items()}
    got = _numpy_state(tm.state_dict())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def _moments(opt, params):
    return [opt._accumulators[n][id(p)].clone() for p in params
            for n in ("moment1", "moment2")]


def test_fp16_scaler_skips_a_nan_batch_and_backs_off(env):
    """float16 O1 with dynamic loss scaling (``use_bf16=False``,
    ``decr_every_n_nan_or_inf=1``): a NaN batch leaves parameters and both
    moments bitwise unchanged and halves the scale; the scaler's state
    after each step equals paddle_tpu's."""
    cfg = dict(use_bf16=False, decr_every_n_nan_or_inf=1)
    jm, tm = _models()
    jstep, _ = _jax_step(jm, _jax_loss(jm), **cfg)
    tstep, topt = _torch_step(tm, _torch_loss(tm), **cfg)
    assert tstep._amp_ctx["dtype"] == "float16"
    for i, bad in enumerate((False, True, False)):
        ids, lab = _batch(20 + i)
        scale = np.array([np.nan if bad else 1.0], np.float32)
        before = ({k: v.clone() for k, v in tm.state_dict().items()},
                  _moments(topt, tm.parameters()) if i else None)
        jl = float(jstep(ids, [lab, scale]).numpy())
        tl = tstep(ids, [lab, scale]).item()
        assert tstep.state_dict()["scaler"] == \
            jstep.state_dict()["scaler"], i
        if not bad:
            np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
            continue
        assert np.isnan(tl) and np.isnan(jl)
        for k, v in tm.state_dict().items():
            assert torch.equal(v, before[0][k]), k
        for a, b in zip(_moments(topt, tm.parameters()), before[1]):
            assert torch.equal(a, b)
        sc = tstep.state_dict()["scaler"]
        assert sc["scale"] == 32768.0 / 2 and sc["applied_steps"] == 1
    restored, _ = _torch_step(TorchGPT(), _torch_loss(tm), **cfg)
    restored.set_state_dict(tstep.state_dict())
    assert restored.state_dict() == tstep.state_dict()


def test_decorate_o2_casts_the_model(env):
    jm, tm = _models()
    jax_amp.decorate(jm, level="O2", dtype="bfloat16")
    assert pt.amp.decorate(tm, level="O2", dtype="bfloat16") is tm
    assert {str(p._data.dtype) for p in jm.parameters()} == {"bfloat16"}
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    ids, _ = _batch(3)
    with jax_amp.auto_cast(True, level="O2", dtype="bfloat16"):
        want = np.asarray(jm(paddle_tpu.to_tensor(ids))._data, np.float32)
    with pt.amp.auto_cast(True, level="O2", dtype="bfloat16"):
        got = tm(torch.as_tensor(ids))
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    assert np.abs(got.detach().float().numpy() - want).max() \
        <= HIDDEN_RTOL * scale


def test_eager_grad_scaler_matches_the_reference():
    """``GradScaler`` on the eager path: ``scale`` multiplies the loss,
    ``step`` divides the gradients, skips the update on a non-finite one
    and backs the scale off after ``decr_every_n_nan_or_inf`` bad steps,
    grows it after ``incr_every_n_steps`` good ones; its state after each
    step equals paddle_tpu's, and so do the parameters (float32, atol
    1e-6)."""
    from paddle_tpu.core.tensor import Parameter

    r = np.random.RandomState(8)
    init = r.randn(5, 3).astype(np.float32)
    jp = Parameter(init.copy())
    tp = torch.nn.Parameter(torch.as_tensor(init.copy()))
    jopt = jax_optimizer.Adam(learning_rate=0.01, parameters=[jp])
    topt = pt.optimizer.Adam(learning_rate=0.01, parameters=[tp])
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    jsc, tsc = jax_amp.GradScaler(**kw), pt.amp.GradScaler(**kw)
    assert tsc.scale(torch.tensor(2.0)).item() == 2048.0
    for bad in (False, True, False, False):
        g = r.randn(5, 3).astype(np.float32) * 1024.0
        if bad:
            g[1, 2] = np.inf
        jp.grad = paddle_tpu.to_tensor(g)
        tp.grad = torch.as_tensor(g.copy())
        jsc.step(jopt)
        tsc.step(topt)
        assert tsc.state_dict() == jsc.state_dict()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   atol=1e-6, rtol=0)
    assert tsc.get_loss_scaling() == 1024.0  # halved once, doubled once
    disabled = pt.amp.GradScaler(enable=False)
    assert disabled.scale(torch.tensor(3.0)).item() == 3.0
