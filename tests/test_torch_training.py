"""The port's training slice against paddle_tpu's, on carried weights.

A tiny ``TransformerLM`` (d_model 128 so the fused-LN route fires, 4
heads, 2 layers, vocab 48, S = 16, B = 2) is built in paddle_tpu with
random weights made by numpy; the same weights go into
paddle_tpu_torch's model through ``set_state_dict``. Both
packages run with ``PADDLE_FLASH_DEFAULT=interpret`` and
``PADDLE_FUSED_LN=interpret``: paddle_tpu through the Pallas interpreter
(forward and backward kernels), the port through its kernels' plain
versions inside the autograd Functions.

Checked: the loss and every parameter's gradient of one batch (eager
``loss.backward()`` in both); then five ``jit.TrainStep`` calls with
AdamW (lr 1e-3, epsilon 1e-6, so that no update is decided by rounding a
gradient near zero; weight decay 0.01): the losses of steps 1-3 and the
parameters after step 3, compared as numpy arrays;
a NaN batch at step 4, which the skip guard turns into a no-op that
leaves parameters and both moments bitwise unchanged in each package;
and step 5, which must again agree across the packages.

Tolerances (float32 in both packages; sums run in different orders):
loss atol 2e-5; gradients atol 2e-5 + rtol 1e-4; parameters after the
AdamW steps atol 1e-4 (an update is at most lr = 1e-3 per step, and one
whose gradient is close to epsilon moves with the gradient's last bits).
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.distributed import comm
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.nn import functional as JF
from paddle_tpu.serving import TransformerLM as JaxLM

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt

VOCAB, D, HEADS, LAYERS, S, B = 48, 128, 4, 2, 16, 2
LOSS_ATOL = 2e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
PARAM_ATOL = 1e-4
LR, EPS, WD = 1e-3, 1e-6, 0.01


def _numpy_state(state):
    """The port's state (or gradients by name) as numpy copies."""
    return {n: t.detach().cpu().numpy().copy() for n, t in state.items()}


@pytest.fixture(scope="module")
def env():
    """Both packages take the kernel routes (interpret on the CPU) with the
    skip guard on; the JAX model's constructor installs a trivial hybrid
    mesh, restored after the module."""
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


def _random_state(shapes, seed=11):
    r = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
            a = 1 + 0.2 * r.randn(*shape)
        elif name.endswith("bias"):
            a = 0.2 * r.randn(*shape)
        elif "embed" in name:
            a = r.randn(*shape)
        else:  # [in, out] linear weights
            a = r.randn(*shape) / np.sqrt(shape[0])
        out[name] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models(env):
    jm = JaxLM(VOCAB, d_model=D, num_heads=HEADS, num_layers=LAYERS,
               max_position=S)
    state = _random_state({k: tuple(v.shape)
                           for k, v in jm.state_dict().items()})
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected
    tm = pt.TransformerLM(VOCAB, d_model=D, num_heads=HEADS,
                          num_layers=LAYERS, max_position=S, device="cpu")
    assert tm.set_state_dict(state) == ([], [])
    return jm, tm


def _batch(seed):
    r = np.random.RandomState(seed)
    ids = r.randint(0, VOCAB, size=(B, S + 1))
    return ids[:, :-1], ids[:, 1:]


def _jax_loss(out, label, scale=None):
    loss = JF.cross_entropy(out.reshape([-1, VOCAB]), label.reshape([-1]))
    return loss if scale is None else loss * scale.mean()


def _torch_loss(out, label, scale=None):
    loss = pt.nn.functional.cross_entropy(out.reshape(-1, VOCAB),
                                          label.reshape(-1))
    return loss if scale is None else loss * scale.mean()


def _jax_state(jm):
    return {k: np.array(v._data) for k, v in jm.state_dict().items()}


def test_one_batch_loss_and_gradients_match(models):
    jm, tm = models
    ids, lab = _batch(0)
    jloss = _jax_loss(jm(paddle_tpu.to_tensor(ids)),
                      paddle_tpu.to_tensor(lab))
    jloss.backward()
    want = {n: np.array(p.grad._data) for n, p in jm.named_parameters()}
    for p in jm.parameters():
        p.clear_grad()
    tloss = _torch_loss(tm(torch.as_tensor(ids)), torch.as_tensor(lab))
    tloss.backward()
    got = _numpy_state(
        {n: p.grad for n, p in tm.named_parameters()})
    tm.zero_grad(set_to_none=True)
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()),
                               atol=LOSS_ATOL, rtol=0)
    assert set(got) == set(want)
    for name, g in got.items():
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(g, want[name], err_msg=name, **GRAD_TOL)


@pytest.fixture(scope="module")
def trained(models):
    """Five TrainStep calls in each package on one sequence of batches;
    step 4's batch carries a NaN. Records losses and snapshots."""
    jm, tm = models
    jopt = jax_optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                               weight_decay=WD, parameters=jm.parameters())
    topt = pt.optimizer.AdamW(learning_rate=LR, epsilon=EPS, weight_decay=WD)
    jstep = JaxTrainStep(jm, _jax_loss, jopt)
    tstep = pt.jit.TrainStep(tm, _torch_loss, topt)
    rec = {"jax": [], "torch": [], "snap": {}}
    for i in range(5):
        ids, lab = _batch(i + 1)
        scale = np.array([np.nan if i == 3 else 1.0], np.float32)
        rec["jax"].append(float(jstep(ids, [lab, scale]).numpy()))
        rec["torch"].append(tstep(ids, [lab, scale]).item())
        if i in (2, 3):
            rec["snap"][i + 1] = {
                "jax": (_jax_state(jm), [
                    np.array(jopt._accumulators[n][id(p)])
                    for p in jm.parameters()
                    for n in ("moment1", "moment2")]),
                "torch": (_numpy_state(tm.state_dict()), [
                    topt._accumulators[n][id(p)].clone()
                    for p in tm.parameters()
                    for n in ("moment1", "moment2")]),
            }
    rec["final"] = (_jax_state(jm),
                    _numpy_state(tm.state_dict()))
    return rec


def test_train_step_losses_match(trained):
    good = [0, 1, 2, 4]
    np.testing.assert_allclose([trained["torch"][i] for i in good],
                               [trained["jax"][i] for i in good],
                               atol=LOSS_ATOL, rtol=0)


def test_params_after_three_steps_match(trained):
    want, _ = trained["snap"][3]["jax"]
    got, _ = trained["snap"][3]["torch"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_nan_batch_is_skipped_bitwise(trained):
    """Step 4 returns a NaN loss and changes nothing: parameters and both
    AdamW moments equal step 3's bit for bit, in each package."""
    assert np.isnan(trained["jax"][3]) and np.isnan(trained["torch"][3])
    for pkg in ("jax", "torch"):
        (p3, m3), (p4, m4) = trained["snap"][3][pkg], trained["snap"][4][pkg]
        for name in p3:
            np.testing.assert_array_equal(p4[name], p3[name], err_msg=name)
        for a, b in zip(m3, m4):
            if pkg == "torch":
                assert torch.equal(a, b)
            else:
                np.testing.assert_array_equal(a, b)


def test_step_after_the_skip_matches(trained):
    """Step 5 applies again, with the same bias-correction count in both
    packages (the skipped call counts, as in paddle_tpu)."""
    want, got = trained["final"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)
        assert not np.array_equal(got[name],
                                  trained["snap"][4]["torch"][0][name])


def test_train_step_refuses_what_is_not_ported(models, monkeypatch):
    _, tm = models
    opt = pt.optimizer.AdamW(learning_rate=LR)
    opt.user_defined_strategy = object()
    with pytest.raises(NotImplementedError, match="strategy"):
        pt.jit.TrainStep(tm, _torch_loss, opt)
    # the guard's host half is ported: abort and spike detection are
    # accepted (their behaviour: tests/test_torch_train_guard.py)
    for knob, value in (("PADDLE_GUARD_MODE", "abort"),
                        ("PADDLE_GUARD_SPIKE_FACTOR", "4")):
        monkeypatch.setenv(knob, value)
        step = pt.jit.TrainStep(tm, _torch_loss,
                                pt.optimizer.AdamW(learning_rate=LR))
        assert step._guard.mode == ("abort" if value == "abort" else "skip")
        monkeypatch.delenv(knob)
    with pytest.raises(ValueError):
        monkeypatch.setenv("PADDLE_GUARD_MODE", "bogus")
        pt.jit.TrainStep(tm, _torch_loss, pt.optimizer.AdamW(learning_rate=LR))
    monkeypatch.delenv("PADDLE_GUARD_MODE")
    # every strategy option is ported, elastic_reshard last: TrainStep
    # keeps it as data, and the ElasticStep that reads it refuses a policy
    # it does not know (tests/test_torch_resharding.py)
    strategy = pt.distributed.fleet.DistributedStrategy()
    strategy.elastic_reshard = "auto"
    opt = pt.optimizer.AdamW(learning_rate=LR)
    opt.user_defined_strategy = strategy
    step = pt.jit.TrainStep(tm, _torch_loss, opt)
    with pytest.raises(ValueError, match="elastic_reshard"):
        pt.distributed.resharding.ElasticStep(step)
    # lr_ratio, multi_precision and lazy_mode are ported (their updates:
    # tests/test_torch_optimizers.py)
    for kw in ({"lr_ratio": lambda p: 1.0}, {"multi_precision": True},
               {"lazy_mode": True}):
        pt.optimizer.AdamW(**kw)
    # grad_clip and LRScheduler learning rates are ported; a rate that is
    # neither a number nor a scheduler is refused
    with pytest.raises(TypeError):
        pt.optimizer.AdamW(learning_rate=object())


def test_guard_health_word():
    """grad_health's bits: loss, gradients and, when asked, the new
    parameters; mask_step keeps the old values bit for bit on a bad
    verdict."""
    from paddle_tpu_torch.utils import train_guard as tg

    one, nan = torch.tensor(1.0), torch.tensor(float("nan"))
    g = [torch.ones(3), None]
    ok, bits, gnorm = tg.grad_health(one, g)
    assert bool(ok) and bits.item() == 0
    assert gnorm.item() == pytest.approx(3 ** 0.5)
    assert tg.grad_health(nan, g)[1].item() == tg.HEALTH_LOSS
    assert tg.grad_health(one, [g[0] * nan])[1].item() == tg.HEALTH_GRAD
    bad_p = [torch.tensor([1.0, float("inf")])]
    assert tg.grad_health(one, g, bad_p, check_params=False)[1].item() == 0
    ok, bits, _ = tg.grad_health(one, g, bad_p, check_params=True)
    assert not bool(ok) and bits.item() == tg.HEALTH_PARAM
    old, new = [torch.zeros(2)], [torch.ones(2)]
    assert torch.equal(tg.mask_step(ok, new, old)[0], old[0])
    assert torch.equal(tg.mask_step(~ok, new, old)[0], new[0])


def test_train_step_return_outputs():
    model = torch.nn.Linear(4, 3)
    step = pt.jit.TrainStep(
        model, lambda out, y: ((out - y) ** 2).mean(),
        pt.optimizer.AdamW(learning_rate=0.1), return_outputs=True)
    x, y = np.ones((2, 4), np.float32), np.zeros((2, 3), np.float32)
    loss, out = step(x, y)
    assert loss.requires_grad is False and out.requires_grad is False
    assert tuple(out.shape) == (2, 3)
    assert all(p.grad is None for p in model.parameters())


def test_apply_decay_param_fun_sees_parameter_names():
    """AdamW decays only the parameters whose ``named_parameters()`` name
    the function accepts; a zero gradient then moves only those."""
    lin = torch.nn.Linear(4, 4)
    seen = []

    def decay(name):
        seen.append(name)
        return name == "weight"

    opt = pt.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                             parameters=lin.named_parameters(),
                             apply_decay_param_fun=decay)
    w0, b0 = lin.weight.detach().clone(), lin.bias.detach().clone()
    for p in lin.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    assert sorted(seen) == ["bias", "weight"]
    assert torch.allclose(lin.weight, w0 * (1 - 0.1 * 0.5))
    assert torch.equal(lin.bias, b0)
    assert set(opt._accumulators) == {"moment1", "moment2"}
    assert opt.get_lr() == 0.1
    opt.clear_grad()
    assert lin.weight.grad is None


def test_apply_decay_param_fun_refuses_unnamed_parameters():
    """Without ``(name, parameter)`` pairs there is no name to decide on:
    the update raises instead of guessing one."""
    lin = torch.nn.Linear(4, 4)
    opt = pt.optimizer.AdamW(learning_rate=0.1, parameters=lin.parameters(),
                             apply_decay_param_fun=lambda name: True)
    for p in lin.parameters():
        p.grad = torch.zeros_like(p)
    with pytest.raises(ValueError, match="named_parameters"):
        opt.step()


def test_adam_is_adamw_without_decay():
    """``Adam`` (``_adam_rule``) and ``AdamW`` with weight_decay 0 make the
    same update."""
    a, b = torch.nn.Linear(4, 4), torch.nn.Linear(4, 4)
    b.load_state_dict(a.state_dict())
    opts = (pt.optimizer.Adam(learning_rate=0.1, parameters=a.parameters()),
            pt.optimizer.AdamW(learning_rate=0.1, weight_decay=0.0,
                               parameters=b.parameters()))
    g = torch.randn(4, 4, generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        for lin, opt in zip((a, b), opts):
            lin.weight.grad, lin.bias.grad = g.clone(), g[0].clone()
            opt.step()
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert not torch.equal(a.weight.grad, torch.zeros(4, 4))
