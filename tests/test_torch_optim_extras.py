"""The port's training extras against paddle_tpu's: LR schedulers, gradient
clips, regularizers, ``fused_linear_cross_entropy`` and dropout.

Checked: the first 30 rates of each of the 14 schedulers (one case each,
float equality up to 1e-12 relative: both packages run the same host
arithmetic); each clip on the same random gradients (float32, rtol 1e-6);
L1 and L2 decay through ``Adam``'s eager step (float32, atol 1e-6); three
``TrainStep`` calls of a small ``TransformerLM`` with ``ClipGradByGlobalNorm``
+ ``LinearWarmup(CosineAnnealingDecay)`` + ``L2Decay`` (losses atol 2e-5,
parameters atol 1e-4, the tolerances of ``test_torch_training.py`` for
the same model); ``fused_linear_cross_entropy``'s loss and its gradients
for the hidden state, weight and bias with a tail chunk, ``ignore_index``
rows and (N, 1) labels, and its dense escape (float32, atol 1e-5: sums of
up to 300 products in another order); dropout's mask statistics,
determinism under one generator, its inference forms and ``p = 0``.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu import regularizer as jax_regularizer
from paddle_tpu.core.tensor import Parameter
from paddle_tpu.distributed import comm
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.serving import TransformerLM as JaxLM

import paddle_tpu_torch as pt
from paddle_tpu_torch.optimizer import lr as pt_lr

SCHEDULERS = {
    "NoamDecay": dict(d_model=64, warmup_steps=10, learning_rate=0.5),
    "PiecewiseDecay": dict(boundaries=[5, 12], values=[0.1, 0.05, 0.01]),
    "NaturalExpDecay": dict(learning_rate=0.1, gamma=0.2),
    "InverseTimeDecay": dict(learning_rate=0.1, gamma=0.3),
    "PolynomialDecay": dict(learning_rate=0.1, decay_steps=7, end_lr=0.001,
                            power=2.0, cycle=True),
    "LinearWarmup": dict(learning_rate="cosine", warmup_steps=5,
                         start_lr=0.0, end_lr=0.1),
    "ExponentialDecay": dict(learning_rate=0.1, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.1, milestones=[3, 9, 20],
                           gamma=0.5),
    "StepDecay": dict(learning_rate=0.1, step_size=4, gamma=0.7),
    "LambdaDecay": dict(learning_rate=0.1, lr_lambda="lambda"),
    "ReduceOnPlateau": dict(learning_rate=0.1, factor=0.5, patience=2,
                            cooldown=1),
    "CosineAnnealingDecay": dict(learning_rate=0.1, T_max=12, eta_min=0.001),
    "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.1,
                     step_size_up=4, step_size_down=6, mode="triangular2"),
    "OneCycleLR": dict(max_learning_rate=0.1, total_steps=25),
}


def _numpy_state(state):
    """The port's state (or gradients by name) as numpy copies."""
    return {n: t.detach().cpu().numpy().copy() for n, t in state.items()}


def _make(mod, name):
    kw = dict(SCHEDULERS[name])
    if kw.get("learning_rate") == "cosine":
        kw["learning_rate"] = mod.CosineAnnealingDecay(0.1, T_max=10)
    if kw.get("lr_lambda") == "lambda":
        kw["lr_lambda"] = lambda e: 0.95 ** e
    return getattr(mod, name)(**kw)


def _rates(sched, name):
    out = []
    for i in range(30):
        out.append(sched())
        if name == "ReduceOnPlateau":  # a loss that stalls, then falls
            sched.step(metrics=1.0 if i < 12 else 1.0 - 0.01 * i)
        else:
            sched.step()
    return out


def test_all_fourteen_schedulers_are_ported():
    assert len(SCHEDULERS) == 14
    assert set(SCHEDULERS) == set(jax_lr.__all__) - {"LRScheduler"}
    assert set(pt_lr.__all__) == set(jax_lr.__all__)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_rates_match(name):
    want = _rates(_make(jax_lr, name), name)
    got = _rates(_make(pt_lr, name), name)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert len(set(got)) > 1 or name == "ReduceOnPlateau"


def test_optimizer_reads_a_scheduler():
    sched = pt_lr.StepDecay(0.1, step_size=2, gamma=0.5)
    opt = pt.optimizer.Adam(learning_rate=sched)
    rates = []
    for _ in range(5):
        rates.append(opt.get_lr())
        sched.step()
    assert rates == [0.1, 0.1, 0.05, 0.05, 0.025]
    with pytest.raises(RuntimeError):
        opt.set_lr(0.3)
    plain = pt.optimizer.Adam(learning_rate=0.1)
    plain.set_lr(0.3)
    assert plain.get_lr() == 0.3


def _grads(seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(*s) * 3).astype(np.float32)
            for s in ((4, 5), (7,), (3, 3))]


@pytest.mark.parametrize("clip", [("ClipGradByValue", (0.8,)),
                                  ("ClipGradByNorm", (2.0,)),
                                  ("ClipGradByGlobalNorm", (5.0,))],
                         ids=lambda c: c[0])
def test_clip_matches(clip):
    name, args = clip
    gs = _grads()
    jp = [Parameter(np.zeros(g.shape, np.float32)) for g in gs]
    want = getattr(jnn, name)(*args)(
        [(p, paddle_tpu.to_tensor(g)) for p, g in zip(jp, gs)])
    tp = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    got = getattr(pt.nn, name)(*args)(
        [(p, torch.as_tensor(g)) for p, g in zip(tp, gs)])
    for (_, w), (_, g), raw in zip(want, got, gs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data), rtol=1e-6,
                                   atol=1e-7)
        assert not np.array_equal(g.numpy(), raw)  # every case clips
    # a parameter that asks not to be clipped keeps its gradient
    tp[0].need_clip = False
    kept = getattr(pt.nn, name)(*args)([(tp[0], torch.as_tensor(gs[0]))])
    np.testing.assert_array_equal(kept[0][1].numpy(), gs[0])


@pytest.mark.parametrize("reg", ["L1Decay", "L2Decay"])
def test_regularizer_through_adam_matches(reg):
    """Two eager Adam steps with ``weight_decay=<regularizer>``; the second
    parameter carries its own regularizer, which takes precedence."""
    r = np.random.RandomState(3)
    init = [r.randn(6, 4).astype(np.float32), r.randn(5).astype(np.float32)]
    grads = [[r.randn(*a.shape).astype(np.float32) for a in init]
             for _ in range(2)]
    jp = [Parameter(a.copy()) for a in init]
    jp[1].regularizer = jax_regularizer.L2Decay(0.5)
    jopt = jax_optimizer.Adam(learning_rate=0.01, parameters=jp,
                              weight_decay=getattr(jax_regularizer, reg)(0.1))
    tp = [torch.nn.Parameter(torch.as_tensor(a.copy())) for a in init]
    tp[1].regularizer = pt.regularizer.L2Decay(0.5)
    topt = pt.optimizer.Adam(learning_rate=0.01, parameters=tp,
                             weight_decay=getattr(pt.regularizer, reg)(0.1))
    for gs in grads:
        for p, g in zip(jp, gs):
            p.grad = paddle_tpu.to_tensor(g)
        jopt.step()
        for p, g in zip(tp, gs):
            p.grad = torch.as_tensor(g)
        topt.step()
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j._data),
                                   atol=1e-6, rtol=0)
    # a float weight_decay is L2Decay of it
    assert isinstance(pt.optimizer.Adam(weight_decay=0.1)._regularization,
                      pt.regularizer.L2Decay)


VOCAB, D, HEADS, LAYERS, S, B = 48, 128, 4, 2, 16, 2


@pytest.fixture(scope="module")
def lm_env():
    prev = comm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_FLASH_DEFAULT", "interpret")
        mp.setenv("PADDLE_FUSED_LN", "interpret")
        mp.setenv("PADDLE_GUARD_MODE", "skip")
        for knob in ("PADDLE_GUARD_SPIKE_FACTOR", "PADDLE_GUARD_CHECK_PARAMS",
                     "PADDLE_FAULT_SPEC"):
            mp.delenv(knob, raising=False)
        yield
    comm._state.hybrid_mesh = prev


def test_train_step_with_clip_schedule_and_decay_matches(lm_env):
    jm = JaxLM(VOCAB, d_model=D, num_heads=HEADS, num_layers=LAYERS,
               max_position=S)
    r = np.random.RandomState(7)
    state = {k: (r.randn(*v.shape) * (0.2 if k.endswith("bias") else 1.0)
                 / (np.sqrt(v.shape[0]) if v.ndim == 2 and "embed" not in k
                    else 1.0)).astype(np.float32)
             for k, v in jm.state_dict().items()}
    for k in state:
        if k.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
            state[k] = (1 + 0.2 * r.randn(*state[k].shape)).astype(np.float32)
    jm.set_state_dict(state)
    tm = pt.TransformerLM(VOCAB, d_model=D, num_heads=HEADS,
                          num_layers=LAYERS, max_position=S, device="cpu")
    assert tm.set_state_dict(state) == ([], [])

    def jsched():
        return jax_lr.LinearWarmup(jax_lr.CosineAnnealingDecay(1e-2, T_max=4),
                                   warmup_steps=1, start_lr=1e-3, end_lr=1e-2)

    def tsched():
        return pt_lr.LinearWarmup(pt_lr.CosineAnnealingDecay(1e-2, T_max=4),
                                  warmup_steps=1, start_lr=1e-3, end_lr=1e-2)

    js, ts = jsched(), tsched()
    jopt = jax_optimizer.Adam(
        learning_rate=js, epsilon=1e-6, parameters=jm.parameters(),
        grad_clip=jnn.ClipGradByGlobalNorm(0.5),
        weight_decay=jax_regularizer.L2Decay(0.01))
    topt = pt.optimizer.Adam(
        learning_rate=ts, epsilon=1e-6,
        grad_clip=pt.nn.ClipGradByGlobalNorm(0.5),
        weight_decay=pt.regularizer.L2Decay(0.01))

    def jloss(out, lab):
        return jnn.functional.cross_entropy(out.reshape([-1, VOCAB]),
                                            lab.reshape([-1]))

    def tloss(out, lab):
        return pt.nn.functional.cross_entropy(out.reshape(-1, VOCAB),
                                              lab.reshape(-1))

    jstep = JaxTrainStep(jm, jloss, jopt)
    tstep = pt.jit.TrainStep(tm, tloss, topt)
    jl, tl = [], []
    for i in range(3):
        ids = np.random.RandomState(30 + i).randint(0, VOCAB, (B, S + 1))
        jl.append(float(jstep(ids[:, :-1], ids[:, 1:]).numpy()))
        tl.append(tstep(ids[:, :-1], ids[:, 1:]).item())
        js.step()
        ts.step()
    np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=0)
    want = {k: np.array(v._data) for k, v in jm.state_dict().items()}
    got = _numpy_state(tm.state_dict())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-4, rtol=0,
                                   err_msg=name)
        assert not np.array_equal(got[name], state[name]), name


def _flce_case(seed=0, N=24, d=16, V=300):
    r = np.random.RandomState(seed)
    h = r.randn(N, d).astype(np.float32)
    w = (r.randn(d, V) / np.sqrt(d)).astype(np.float32)  # paddle [d, V]
    b = (0.3 * r.randn(V)).astype(np.float32)
    lab = r.randint(0, V, size=N)
    lab[[2, 9, 17]] = -100  # ignored rows
    lab[5] = V - 1  # a label in the tail chunk
    return h, w, b, lab


@pytest.mark.parametrize("chunk,labels_2d,reduction", [
    (128, False, "mean"), (128, True, "sum"), (64, False, "none"),
    (0, False, "mean")], ids=["tail-chunk", "n1-labels", "rows", "dense"])
def test_fused_linear_cross_entropy_matches(chunk, labels_2d, reduction):
    h, w, b, lab = _flce_case()
    lab_in = lab[:, None] if labels_2d else lab
    jh, jw, jb = (paddle_tpu.to_tensor(a, stop_gradient=False)
                  for a in (h, w, b))
    jout = jnn.functional.fused_linear_cross_entropy(
        jh, jw, jb, paddle_tpu.to_tensor(lab_in), chunk=chunk,
        reduction=reduction)
    jout.sum().backward()
    th, tw, tb = (torch.tensor(a, requires_grad=True)
                  for a in (h, w, b))
    tout = pt.nn.functional.fused_linear_cross_entropy(
        th, tw, tb, torch.as_tensor(lab_in), chunk=chunk,
        reduction=reduction)
    tout.sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout._data), atol=1e-5, rtol=0)
    for got, want in ((th.grad, jh.grad), (tw.grad, jw.grad),
                      (tb.grad, jb.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   atol=1e-5, rtol=0)
    if reduction == "none":
        assert (tout.detach().numpy()[[2, 9, 17]] == 0).all()


def test_fused_linear_cross_entropy_chunk_knob(monkeypatch):
    """``PADDLE_CE_CHUNK`` sets the default chunk; 0 is the dense route."""
    h, w, b, lab = _flce_case(1)
    args = (torch.as_tensor(h), torch.as_tensor(w),
            torch.as_tensor(b), torch.as_tensor(lab))
    want = pt.nn.functional.fused_linear_cross_entropy(*args, chunk=100)
    for knob in ("100", "0"):
        monkeypatch.setenv("PADDLE_CE_CHUNK", knob)
        got = pt.nn.functional.fused_linear_cross_entropy(*args)
        assert abs(got.item() - want.item()) <= 1e-6


def test_dropout_mask_statistics_and_determinism():
    F = pt.nn.functional
    x = torch.ones(200, 500)
    p = 0.3
    y = F.dropout(x, p, generator=torch.Generator().manual_seed(1))
    kept = (y != 0).float().mean().item()
    n = x.numel()
    assert abs(kept - (1 - p)) < 4 * math.sqrt(p * (1 - p) / n)
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / (1 - p), rtol=1e-6)
    again = F.dropout(x, p, generator=torch.Generator().manual_seed(1))
    assert torch.equal(y, again)
    other = F.dropout(x, p, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(y, other)
    # one decision per row with axis=0, shared along the row
    rows = F.dropout(x, p, axis=0, generator=torch.Generator().manual_seed(3))
    assert all(len(set(r.tolist())) == 1 for r in rows)
    # downscale_in_infer: unscaled in training, times (1 - p) at inference
    d = F.dropout(x, p, mode="downscale_in_infer",
                  generator=torch.Generator().manual_seed(1))
    assert set(d.unique().tolist()) <= {0.0, 1.0}
    np.testing.assert_allclose(
        F.dropout(x, p, training=False, mode="downscale_in_infer").numpy(),
        1 - p)
    # without a generator: the package's generator of the input's device,
    # which paddle.seed reseeds
    pt.seed(5)
    first = F.dropout(x, p)
    pt.seed(5)
    assert torch.equal(F.dropout(x, p), first)


def test_dropout_inference_and_p0_match_the_reference():
    x = np.random.RandomState(4).randn(8, 16).astype(np.float32)
    for kw in (dict(p=0.0), dict(p=0.4, training=False)):
        want = np.asarray(jnn.functional.dropout(paddle_tpu.to_tensor(x),
                                                 **kw)._data)
        got = pt.nn.functional.dropout(torch.as_tensor(x), **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_gpt_block_dropout_uses_its_generator():
    """A block with dropout draws its masks from the generator it was
    built with (same seed, same output); in eval() it is the block without
    dropout; in training it takes the dense attention route."""
    def block(p, seed=0):
        return pt.distributed.ParallelGPTBlock(
            32, 4, dropout=p, device="cpu",
            generator=torch.Generator().manual_seed(seed))

    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(9))
    a, b, ref = block(0.2), block(0.2), block(0.0)
    ya, yb = a(x), b(x)
    assert torch.equal(ya, yb)
    assert not torch.allclose(ya, ref(x))
    assert not torch.equal(a(x), ya)  # the generator moved on
    for m in (a, ref):
        m.eval()
    torch.testing.assert_close(a(x), ref(x), rtol=0, atol=0)
