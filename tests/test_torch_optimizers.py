"""The port's optimizers, their state and wrappers, and the rest of
``amp``, against paddle_tpu's.

A small model (``Linear(4, 3)`` with named parameters, its bias starting
at zero, then ``Linear(3, 2)``) starts from the same numpy weights in both
packages and trains on the same seeded batches. Each optimizer
(``Adamax``, ``Adagrad``, ``Adadelta``, ``RMSProp`` plain, centered and
with momentum, ``Lamb`` with and without its exclusion, ``Lars`` with an
exclusion list, ``LarsMomentum``, and ``SGD``/``Adam`` at a per-parameter
rate) takes three eager steps (``loss.backward(); opt.step()``) and three
``TrainStep`` calls in each package; the parameters are compared after
every step and the accumulators by ``state_dict()`` at the end, within
rtol 1e-5 / atol 1e-6 (float32, the same rules in another order). A step
whose gradients are not finite leaves the port's parameters and every
accumulator bitwise unchanged under ``TrainStep``. ``state_dict()``
carries across the packages both ways in the middle of training. The
named departures (``lr_ratio``, ``multi_precision``, ``lazy_mode``) are
pinned, ``ExponentialMovingAverage``, ``LookaheadOptimizer`` and
``ModelAverage`` are held against paddle_tpu's, and the ``amp`` names
(``amp_guard``, ``AmpScaler``, ``convert_dtype``, the ``GradScaler``
methods) are checked. ``test_optimizer.py`` and
``test_optimizer_extras.py`` run on the port as oracles.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.distributed import comm
from paddle_tpu.jit import TrainStep as JaxTrainStep

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from test_torch_ops_math import arr, cpu_device  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def env():
    prev = comm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_GUARD_MODE", "skip")
        for knob in ("PADDLE_GUARD_SPIKE_FACTOR", "PADDLE_GUARD_CHECK_PARAMS",
                     "PADDLE_FAULT_SPEC"):
            mp.delenv(knob, raising=False)
        comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
        yield
    comm._state.hybrid_mesh = prev


def _model(pkg, w_lr=1.0):
    nn = pkg.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 3, weight_attr=nn.ParamAttr(
                name="fc1_w", learning_rate=w_lr), bias_attr=nn.ParamAttr(
                name="fc1_b"))
            self.fc2 = nn.Linear(3, 2)

        def forward(self, x):
            return self.fc2(pkg.nn.functional.relu(self.fc1(x)))

    m = Net()
    r = np.random.RandomState(0)
    m.set_state_dict({
        "fc1.weight": r.randn(4, 3).astype(np.float32),
        "fc1.bias": np.zeros(3, np.float32),
        "fc2.weight": r.randn(3, 2).astype(np.float32),
        "fc2.bias": r.randn(2).astype(np.float32)})
    return m


def _batch(i):
    return arr((5, 4), seed=10 + i), arr((5, 2), seed=20 + i)


def _loss(pkg, out, t):
    return pkg.mean((out - t) * (out - t))


def _params(pkg, m):
    return {n: (p.numpy() if pkg is pt else np.asarray(p._data)).copy()
            for n, p in m.named_parameters()}


def _state(pkg, opt):
    return {k: (np.asarray(v.numpy()) if hasattr(v, "numpy") else v)
            for k, v in opt.state_dict().items() if k != "LR_Scheduler"}


def _exclude_bias(p):
    return bool(p.name) and p.name.endswith("_b")


# (id, class name, keyword arguments, per-parameter rate of fc1.weight)
OPTIMIZERS = [
    ("adamax", "Adamax", dict(learning_rate=0.05), 1.0),
    ("adagrad", "Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1), 1.0),
    ("adadelta", "Adadelta", dict(learning_rate=1.0, rho=0.9), 1.0),
    ("rmsprop", "RMSProp", dict(learning_rate=0.01), 1.0),
    ("rmsprop_centered_momentum", "RMSProp",
     dict(learning_rate=0.01, centered=True, momentum=0.9), 1.0),
    ("lamb", "Lamb", dict(learning_rate=0.05, lamb_weight_decay=0.01), 1.0),
    ("lamb_exclude", "Lamb", dict(learning_rate=0.05, lamb_weight_decay=0.1,
                                  exclude_from_weight_decay_fn=_exclude_bias),
     1.0),
    ("lars", "Lars", dict(learning_rate=0.5, lars_weight_decay=0.01,
                          exclude_from_weight_decay=["fc1_b"]), 1.0),
    ("lars_momentum", "LarsMomentum", dict(learning_rate=0.5,
                                           lars_coeff=0.01), 1.0),
    ("sgd_param_lr", "SGD", dict(learning_rate=0.1), 0.5),
    ("adam_param_lr", "Adam", dict(learning_rate=0.05), 3.0),
]


def _eager(pkg, cls, kw, w_lr):
    m = _model(pkg, w_lr)
    opt = getattr(pkg.optimizer, cls)(parameters=m.parameters(), **kw)
    params = []
    for i in range(STEPS):
        x, t = _batch(i)
        _loss(pkg, m(pkg.to_tensor(x)), pkg.to_tensor(t)).backward()
        opt.step()
        opt.clear_grad()
        params.append(_params(pkg, m))
    return params, _state(pkg, opt)


def _fused(pkg, cls, kw, w_lr):
    m = _model(pkg, w_lr)
    opt = getattr(pkg.optimizer, cls)(parameters=m.parameters(), **kw)
    Step = JaxTrainStep if pkg is paddle_tpu else pt.jit.TrainStep
    step = Step(m, lambda o, t: _loss(pkg, o, t), opt)
    params = []
    for i in range(STEPS):
        x, t = _batch(i)
        step(pkg.to_tensor(x) if pkg is paddle_tpu else torch.tensor(x),
             pkg.to_tensor(t) if pkg is paddle_tpu else torch.tensor(t))
        params.append(_params(pkg, m))
    return params, _state(pkg, opt)


def _same(got, want):
    assert set(got) == set(want) or set(want) <= set(got), (got, want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("cls,kw,w_lr", [c[1:] for c in OPTIMIZERS],
                         ids=[c[0] for c in OPTIMIZERS])
@pytest.mark.parametrize("path", ["eager", "train_step"])
def test_three_steps_match(path, cls, kw, w_lr):
    run = _eager if path == "eager" else _fused
    (jp, js), (tp, ts) = run(paddle_tpu, cls, kw, w_lr), run(pt, cls, kw,
                                                            w_lr)
    for a, b in zip(tp, jp):
        _same(a, b)
    # the accumulators, under the JAX package's keys (its TrainStep also
    # keeps RMSProp's mean_grad when not centered: zeros, not compared)
    assert js.pop("@step") == ts.pop("@step") == STEPS
    for k, v in ts.items():
        np.testing.assert_allclose(v, js[k], err_msg=k, **TOL)
    assert all(k in ts for k in js if not k.endswith("mean_grad")
               or kw.get("centered"))


@pytest.mark.parametrize("cls,kw", [("Lamb", dict(learning_rate=0.05)),
                                    ("RMSProp", dict(learning_rate=0.01,
                                                     centered=True,
                                                     momentum=0.9)),
                                    ("Adadelta", {})])
def test_skipped_step_leaves_every_accumulator(cls, kw):
    """Under ``TrainStep`` a batch with a NaN leaves the parameters and
    every accumulator bitwise unchanged; the next finite batch applies."""
    m = _model(pt)
    opt = getattr(pt.optimizer, cls)(**kw)
    step = pt.jit.TrainStep(m, lambda o, t: _loss(pt, o, t), opt)
    x, t = _batch(0)
    step(torch.tensor(x), torch.tensor(t))
    before = (_params(pt, m), _state(pt, opt))
    bad = x.copy()
    bad[0, 0] = np.nan
    step(torch.tensor(bad), torch.tensor(t))
    after = (_params(pt, m), _state(pt, opt))
    for a, b in zip(after, before):
        for k in b:
            if k != "@step":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    step(torch.tensor(x), torch.tensor(t))
    assert not np.array_equal(_params(pt, m)["fc2.weight"],
                              before[0]["fc2.weight"])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_carries_mid_training(direction):
    """Two Adam steps in one package (an ``LRScheduler`` rate), its
    ``state_dict()`` as numpy into the other's ``set_state_dict``, then a
    third step in both: the same parameters."""
    src, dst = (paddle_tpu, pt) if direction == "jax_to_port" \
        else (pt, paddle_tpu)
    nets, opts = {}, {}
    for pkg in (src, dst):
        nets[pkg] = _model(pkg)
        sched = pkg.optimizer.lr.StepDecay(0.05, step_size=1, gamma=0.5)
        opts[pkg] = pkg.optimizer.Adam(learning_rate=sched,
                                       parameters=nets[pkg].parameters())
    for i in range(2):
        x, t = _batch(i)
        _loss(src, nets[src](src.to_tensor(x)), src.to_tensor(t)).backward()
        opts[src].step()
        opts[src].clear_grad()
        opts[src]._lr.step()
    state = {k: (v if k in ("@step", "LR_Scheduler") else np.asarray(
        v.numpy())) for k, v in opts[src].state_dict().items()}
    assert "fc1_w.moment1" in state and "param_2.moment2" in state
    nets[dst].set_state_dict({k: np.asarray(v.numpy()) if src is pt else
                              np.asarray(v._data) for k, v in
                              nets[src].state_dict().items()})
    opts[dst].set_state_dict(state)
    assert opts[dst]._step_count == 2
    assert opts[dst].get_lr() == pytest.approx(opts[src].get_lr())
    x, t = _batch(2)
    for pkg in (src, dst):
        _loss(pkg, nets[pkg](pkg.to_tensor(x)), pkg.to_tensor(t)).backward()
        opts[pkg].step()
    _same(_params(dst, nets[dst]), _params(src, nets[src]))


def test_named_departures():
    """``lr_ratio`` scales each parameter's rate (the JAX package drops
    it): ``lr_ratio = 0.5`` equals half the rate there. ``lazy_mode`` is
    the full update for dense gradients. ``multi_precision`` on a float32
    model changes nothing; on bf16 parameters it keeps float32 master
    weights equal to a float32 run on the same gradients."""
    runs = {}
    for name, pkg, kw in (
            ("ratio", pt, dict(learning_rate=0.05, lr_ratio=lambda p: 0.5)),
            ("half", paddle_tpu, dict(learning_rate=0.025)),
            ("lazy", pt, dict(learning_rate=0.05, lazy_mode=True)),
            ("plain", pt, dict(learning_rate=0.05)),
            ("mp32", pt, dict(learning_rate=0.05, multi_precision=True))):
        runs[name] = _eager(pkg, "AdamW", kw, 1.0)[0][-1]
    _same(runs["ratio"], runs["half"])
    for k in runs["plain"]:
        np.testing.assert_array_equal(runs["lazy"][k], runs["plain"][k])
        np.testing.assert_array_equal(runs["mp32"][k], runs["plain"][k])
    g = torch.tensor(arr((6,), seed=40))
    p16 = pt.Parameter(torch.tensor(arr((6,), seed=41)).bfloat16())
    p32 = pt.Parameter(p16.detach().float())
    opt16 = pt.optimizer.Adam(0.01, parameters=[p16], multi_precision=True)
    opt32 = pt.optimizer.Adam(0.01, parameters=[p32])
    for _ in range(STEPS):
        p16.grad, p32.grad = g.bfloat16(), g.bfloat16().float()
        opt16.step()
        opt32.step()
    master = opt16.state_dict()["param_0.master_weight"].numpy()
    np.testing.assert_array_equal(master, p32.detach().numpy())
    assert torch.equal(p16.detach(), p32.detach().bfloat16())
    assert opt16._accumulators["moment1"][id(p16)].dtype == torch.float32


def test_optimizer_oracles():
    """``test_optimizer.py::test_optimizer_state_dict_roundtrip`` and
    ``test_nn.py::test_optimizer_int_weight_decay`` on the port."""
    p = pt.Parameter(torch.tensor([1.0, -2.0]))
    p.name = "w0"
    opt = pt.optimizer.Adam(learning_rate=0.01, parameters=[p])
    pt.sum(pt.Tensor._wrap(p) * pt.Tensor._wrap(p)).backward()
    opt.step()
    sd = opt.state_dict()
    assert any("moment1" in k for k in sd)
    p2 = pt.Parameter(torch.tensor([1.0, -2.0]))
    p2.name = "w0"
    opt2 = pt.optimizer.Adam(learning_rate=0.01, parameters=[p2])
    opt2.set_state_dict(sd)
    assert opt2._step_count == 1
    np.testing.assert_allclose(opt2._accumulators["moment1"][id(p2)],
                               opt._accumulators["moment1"][id(p)])
    q = pt.Parameter(torch.ones(2))
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=[q], weight_decay=1)
    pt.sum(pt.Tensor._wrap(q) * 0.0).backward()
    opt.step()
    np.testing.assert_allclose(q.detach().numpy(), [0.9, 0.9], rtol=1e-5)


# -- EMA, Lookahead, ModelAverage ----------------------------------------------


def _train(pkg, m, opt, steps, after=None):
    for i in range(steps):
        x, t = _batch(i)
        _loss(pkg, m(pkg.to_tensor(x)), pkg.to_tensor(t)).backward()
        opt.step()
        opt.clear_grad()
        if after is not None:
            after(i)


@pytest.mark.parametrize("thres", [None, 100])
def test_exponential_moving_average(thres):
    out = {}
    for pkg in (paddle_tpu, pt):
        m = _model(pkg)
        opt = pkg.optimizer.SGD(0.1, parameters=m.parameters())
        ema = pkg.optimizer.ExponentialMovingAverage(0.9, thres_steps=thres)
        _train(pkg, m, opt, 4, lambda i: ema.update(m.parameters()))
        trained = _params(pkg, m)
        with ema.apply():
            applied = _params(pkg, m)
        out[pkg] = (trained, applied, _params(pkg, m))
    for a, b in zip(out[pt], out[paddle_tpu]):
        _same(a, b)
    _same(out[pt][2], out[pt][0])  # restored
    with pytest.raises(RuntimeError):
        pt.optimizer.ExponentialMovingAverage().apply()


def test_lookahead_and_model_average():
    """Lookahead (k = 2, alpha 0.5) over SGD for five steps, and
    ModelAverage (window closing at 3) over four: the same weights, the
    averages applied and restored."""
    la, avg = {}, {}
    for pkg in (paddle_tpu, pt):
        m = _model(pkg)
        inner = pkg.optimizer.SGD(0.1, parameters=m.parameters())
        _train(pkg, m, pkg.optimizer.LookaheadOptimizer(inner, 0.5, 2), 5)
        la[pkg] = _params(pkg, m)
        m = _model(pkg)
        opt = pkg.optimizer.SGD(0.1, parameters=m.parameters())
        ma = pkg.optimizer.ModelAverage(0.5, parameters=m.parameters(),
                                        min_average_window=2,
                                        max_average_window=3)
        _train(pkg, m, opt, 4, lambda i: ma.accumulate())
        trained = _params(pkg, m)
        ma.apply(need_restore=False)
        avg[pkg] = _params(pkg, m)
        ma.restore()
        _same(_params(pkg, m), trained)
    _same(la[pt], la[paddle_tpu])
    _same(avg[pt], avg[paddle_tpu])
    for bad in (dict(alpha=1.5), dict(k=0)):
        with pytest.raises(ValueError):
            pt.optimizer.LookaheadOptimizer(
                pt.optimizer.SGD(0.1, parameters=[]), **bad)


# -- amp -------------------------------------------------------------------------


def test_amp_names():
    """``amp_guard`` is ``auto_cast``, ``AmpScaler`` is ``GradScaler``,
    ``convert_dtype`` is the dtype helper; the scaler's accessors and its
    ``state_dict`` round trip as in paddle_tpu."""
    amp, jamp = pt.amp, paddle_tpu.amp
    assert amp.amp_guard is amp.auto_cast and amp.AmpScaler is amp.GradScaler
    assert amp.convert_dtype("bfloat16") == torch.bfloat16
    with amp.amp_guard(True, level="O1", dtype="bfloat16"):
        assert amp.is_enabled() and amp.amp_dtype() == torch.bfloat16
    for kw in (dict(), dict(enable=False),
               dict(use_dynamic_loss_scaling=False, init_loss_scaling=8.0)):
        a, b = jamp.AmpScaler(**kw), amp.AmpScaler(**kw)
        assert (a.is_enable(), a.is_use_dynamic_loss_scaling(),
                a.get_loss_scaling()) == (b.is_enable(),
                                          b.is_use_dynamic_loss_scaling(),
                                          b.get_loss_scaling())
        a.set_init_loss_scaling(64.0)
        b.set_init_loss_scaling(64.0)
        assert a.state_dict() == b.state_dict()
    s = amp.GradScaler(init_loss_scaling=4.0)
    s._good_steps = 3
    s2 = amp.GradScaler()
    s2.load_state_dict(s.state_dict())
    assert (s2.get_loss_scaling(), s2._good_steps) == (4.0, 3)
