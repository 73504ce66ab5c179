"""The strategy's optimizer options, the port against the JAX package.

One process, on the same numpy weights and inputs in both packages:

- ``fleet.distributed_optimizer(...)``'s eager ``step()`` on a
  ``Linear(4, 4)`` (weights ``arange(16) / 10``, one step at lr 0.1 on
  ``[[1, 2, 3, 4]]``): ``gradient_merge`` k 2 leaves the weights, the
  ``lamb`` and ``lars`` swaps update as the JAX package's do, within 1e-6;
  ``a_sync``, ``sharding`` with ``hybrid_dp`` and a wrong inner optimizer
  for ``lamb`` or ``lars`` raise; ``elastic_reshard`` is kept, and an
  unknown policy raises in the ``ElasticStep`` that reads it.
- Gradient merge, fused (``TrainStep``) and eager, on
  ``test_sharding_gm``'s ``_Net`` and ``TestGradientMerge`` programs;
  a step the guard skips adds nothing to the merge buffer or counter.
- ``recompute`` on ``test_strategy_flags``' program: the JAX package's
  loss and weights within 1e-6, the forward run twice a step, and under
  bf16 AMP the loss of the step without it.
- The ``lamb`` and ``lars`` swaps through ``TrainStep``: two steps, the
  JAX package's weights within 1e-5 of each largest.
- ``TerminateOnPreempt`` dumps the flight recorder with reason
  ``preempt`` and prints its path, as the JAX package's does.

The worlds of ranks (ZeRO, the rings, C8's pipeline, the strategy GPT,
``__graft_entry__.py``'s compositions, LocalSGD) are in
``tests/test_torch_fleet_worlds.py``, which imports this module's
helpers.
"""
import io
import os
import signal
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.ops.pallas as jax_pallas
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from helpers import torch_world as tw

REL = 1e-5


def _fresh_process_state():
    jax_comm._state.hybrid_mesh = pt_comm._mesh = None
    jax_pallas.flash_attention = jax_fa


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    yield
    pt_device._current = saved
    _fresh_process_state()


def _sd(layer):
    return {k: np.asarray(v.numpy()).copy()
            for k, v in layer.state_dict().items()}


def _near(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _strategy(pkg, **flags):
    s = pkg.distributed.fleet.DistributedStrategy()
    for k, v in flags.items():
        setattr(s, k, v)
    return s


def _dist_opt(pkg, opt, **flags):
    fleet = pkg.distributed.fleet
    s = _strategy(pkg, **flags)
    fleet.init(is_collective=True, strategy=s)
    return fleet.distributed_optimizer(opt, strategy=s)


# -- C6: the eager step honours every option or raises ------------------------

def _c6(pkg, opt_name, **flags):
    m = pkg.nn.Linear(4, 4)
    m.set_state_dict({
        "weight": np.arange(16, dtype=np.float32).reshape(4, 4) / 10,
        "bias": np.zeros(4, np.float32)})
    opt = _dist_opt(pkg, getattr(pkg.optimizer, opt_name)(
        learning_rate=0.1, parameters=m.parameters()), **flags)
    loss = (m(pkg.to_tensor(np.array([[1, 2, 3, 4]], np.float32))) ** 2
            ).mean()
    loss.backward()
    opt.step()
    out = np.asarray(m.weight.numpy()).copy()
    _fresh_process_state()
    return out, opt


@pytest.mark.parametrize("opt_name,flags,inner", [
    ("Adam", dict(gradient_merge=True,
                  gradient_merge_configs={"k_steps": 2}), "Adam"),
    ("Adam", dict(lamb=True), "Lamb"),
    ("Momentum", dict(lars=True), "Lars"),
], ids=["gradient_merge", "lamb", "lars"])
def test_c6_eager_option_matches_reference(opt_name, flags, inner):
    want, _ = _c6(jpaddle, opt_name, **flags)
    got, opt = _c6(pt, opt_name, **flags)
    assert type(opt._inner).__name__ == inner
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if "gradient_merge" in flags:  # off the boundary: unchanged
        np.testing.assert_array_equal(
            got, np.arange(16, dtype=np.float32).reshape(4, 4) / 10)


@pytest.mark.parametrize("opt_name,flags,error,match", [
    ("SGD", dict(a_sync=True), NotImplementedError, "a_sync"),
    ("SGD", dict(elastic_reshard="auto"), ValueError, "shrink_expand"),
    ("SGD", dict(sharding=True, sharding_configs={"hybrid_dp": True}),
     NotImplementedError, "hybrid_dp"),
    ("SGD", dict(lamb=True), ValueError, "lamb"),
    ("Adam", dict(lars=True), ValueError, "lars"),
], ids=["a_sync", "elastic_reshard", "hybrid_dp", "lamb_inner",
        "lars_inner"])
def test_c6_refusals(opt_name, flags, error, match):
    for pkg in (jpaddle, pt):
        if "elastic_reshard" in flags:
            # the optimizer keeps the policy as data in both packages; the
            # ElasticStep that reads it refuses an unknown one
            _, opt = _c6(pkg, opt_name, **flags)
            with pytest.raises(error, match=match):
                pkg.distributed.resharding.ElasticStep(
                    types.SimpleNamespace(opt=opt))
            continue
        with pytest.raises(error, match=match):
            _c6(pkg, opt_name, **flags)
        _fresh_process_state()


# -- gradient merge --------------------------------------------------------------

def _net(pkg):
    return tw.zero_net() if pkg is pt else _JNet()


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 24)
        self.fc2 = jnn.Linear(24, 8)

    def forward(self, x):
        return self.fc2(jpaddle.nn.functional.relu(self.fc1(x)))


def _data(n, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, 16).astype(np.float32),
             rng.randint(0, 8, (batch,)).astype(np.int64)) for _ in range(n)]


def _ce(pkg):
    return lambda out, y: pkg.nn.functional.cross_entropy(out, y)


@pytest.fixture(scope="module")
def net_init():
    jpaddle.seed(1)
    return _sd(_JNet())


def _gm_run(pkg, init, opt_name, k, lr, data, fused=True, avg=True):
    """Parameters after each call of a ``gradient_merge`` program."""
    m = _net(pkg)
    m.set_state_dict(init)
    opt = _dist_opt(pkg, getattr(pkg.optimizer, opt_name)(
        learning_rate=lr, parameters=m.parameters()),
        gradient_merge=True, gradient_merge_configs={"k_steps": k,
                                                     "avg": avg})
    step = (JTrainStep if pkg is jpaddle else pt.jit.TrainStep)(
        m, _ce(pkg), opt) if fused else None
    out = []
    for x, y in data:
        if fused:
            step(x, y)
        else:
            _ce(pkg)(m(pkg.to_tensor(x)), pkg.to_tensor(y)).backward()
            opt.step()
            opt.clear_grad()
        out.append(_sd(m))
    _fresh_process_state()
    return out, opt


@pytest.mark.parametrize("opt_name,k,lr,fused,avg", [
    ("Momentum", 2, 0.1, True, True),
    ("SGD", 4, 0.5, True, True),
    ("Adam", 2, 0.05, True, True),
    ("Adam", 2, 0.05, False, True),
    ("SGD", 2, 0.5, False, False),
], ids=["fused_momentum_k2", "fused_sgd_k4", "fused_adam_k2",
        "eager_adam_k2", "eager_sgd_k2_sum"])
def test_gradient_merge_matches(net_init, opt_name, k, lr, fused, avg):
    """Every call's parameters: unchanged off the boundary, the JAX
    package's (within 2e-6 of each largest) at it."""
    data = _data(2 * k, seed=3)
    want, _ = _gm_run(jpaddle, net_init, opt_name, k, lr, data, fused, avg)
    got, opt = _gm_run(pt, net_init, opt_name, k, lr, data, fused, avg)
    for i, (g, w) in enumerate(zip(got, want)):
        for name in w:
            _near(g[name], w[name], 2e-6, f"call {i + 1} {name}")
            if (i + 1) % k:
                np.testing.assert_array_equal(
                    g[name], (got[i - 1] if i else {
                        n: v for n, v in net_init.items()})[name])
    assert opt.state_dict()["@step"] == 2


def test_gradient_merge_eager_keeps_grads_mid_merge(net_init):
    """The reference's ``test_eager_gm_step_skips_until_boundary``."""
    m = tw.zero_net()
    m.set_state_dict(net_init)
    opt = _dist_opt(pt, pt.optimizer.SGD(learning_rate=0.5,
                                         parameters=m.parameters()),
                    gradient_merge=True,
                    gradient_merge_configs={"k_steps": 2})
    before = m.fc1.weight.detach().clone()
    for i, (x, y) in enumerate(_data(2, seed=7)):
        _ce(pt)(m(pt.to_tensor(x)), pt.to_tensor(y)).backward()
        opt.step()
        opt.clear_grad()
        if i == 0:
            assert torch.equal(m.fc1.weight, before)
            assert m.fc1.weight.grad is not None
    assert not torch.equal(m.fc1.weight, before)
    assert m.fc1.weight.grad is None
    _fresh_process_state()


def test_gradient_merge_skipped_step_adds_nothing(net_init, monkeypatch):
    """A step the guard skips (a NaN batch) leaves the parameters, the
    merge buffer and the counter as they were."""
    monkeypatch.setenv("PADDLE_GUARD_MODE", "skip")
    m = tw.zero_net()
    m.set_state_dict(net_init)
    opt = _dist_opt(pt, pt.optimizer.Adam(learning_rate=0.05,
                                          parameters=m.parameters()),
                    gradient_merge=True,
                    gradient_merge_configs={"k_steps": 2})
    step = pt.jit.TrainStep(m, _ce(pt), opt)
    (x, y), = _data(1, seed=4)
    step(x, y)
    buf = {k: v.clone() for k, v in opt._inner._accumulators[
        "@gm_buf"].items()}
    cnt = int(opt._gm_cnt)
    bad = x.copy()
    bad[0, 0] = np.nan
    step(bad, y)
    assert int(opt._gm_cnt) == cnt == 1
    for k, v in opt._inner._accumulators["@gm_buf"].items():
        assert torch.equal(v, buf[k])
    _fresh_process_state()


# -- recompute -------------------------------------------------------------------

def _recompute_run(pkg, init, x, y, flagged, amp=False):
    model = pkg.nn.Sequential(pkg.nn.Linear(6, 16), pkg.nn.ReLU(),
                              pkg.nn.Linear(16, 1))
    model.set_state_dict(init)
    calls = [0]
    if pkg is pt:
        model[0].register_forward_pre_hook(
            lambda *a: calls.__setitem__(0, calls[0] + 1))
    opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    flags = dict(recompute=flagged, amp=amp)
    opt = _dist_opt(pkg, opt, **flags)
    step = (JTrainStep if pkg is jpaddle else pt.jit.TrainStep)(
        model, lambda o, t: ((o - t) * (o - t)).mean(), opt)
    loss = float(np.asarray(step(x, y).numpy() if pkg is jpaddle
                            else step(x, y)))
    _fresh_process_state()
    return loss, _sd(model), calls[0]


def test_recompute_matches_reference():
    """``test_strategy_flags``' recompute program: the JAX package's loss
    and weights; the forward runs again in backward."""
    rng = np.random.RandomState(0)
    x = rng.rand(8, 6).astype(np.float32)
    y = rng.rand(8, 1).astype(np.float32)
    jpaddle.seed(7)
    init = _sd(jnn.Sequential(jnn.Linear(6, 16), jnn.ReLU(),
                              jnn.Linear(16, 1)))
    want_loss, want, _ = _recompute_run(jpaddle, init, x, y, True)
    loss, got, calls = _recompute_run(pt, init, x, y, True)
    _, _, plain_calls = _recompute_run(pt, init, x, y, False)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
    assert (calls, plain_calls) == (2, 1)


def test_recompute_under_bf16_amp():
    """Recompute re-enters the step's AMP scope for the recomputation:
    the bf16 O1 step's loss and weights equal the step's without it."""
    rng = np.random.RandomState(1)
    x = rng.rand(8, 6).astype(np.float32)
    y = rng.rand(8, 1).astype(np.float32)
    pt.seed(3)
    init = _sd(pt.nn.Sequential(pt.nn.Linear(6, 16), pt.nn.ReLU(),
                                pt.nn.Linear(16, 1)))
    got = _recompute_run(pt, init, x, y, True, amp=True)
    want = _recompute_run(pt, init, x, y, False, amp=True)
    assert got[0] == want[0]
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])


# -- the Lamb / Lars swaps through TrainStep --------------------------------------

@pytest.mark.parametrize("opt_name,flag", [("Adam", "lamb"),
                                           ("Momentum", "lars")])
def test_optimizer_swap_trains_as_reference(net_init, opt_name, flag):
    data = _data(2, seed=11)
    out = {}
    for pkg in (jpaddle, pt):
        m = _net(pkg)
        m.set_state_dict(net_init)
        opt = _dist_opt(pkg, getattr(pkg.optimizer, opt_name)(
            learning_rate=0.05, parameters=m.parameters()), **{flag: True})
        step = (JTrainStep if pkg is jpaddle else pt.jit.TrainStep)(
            m, _ce(pkg), opt)
        for x, y in data:
            step(x, y)
        out[pkg.__name__] = (type(opt._inner).__name__, _sd(m))
        _fresh_process_state()
    (jname, want), (tname, got) = out["paddle_tpu"], out["paddle_tpu_torch"]
    assert jname == tname == flag.capitalize()
    for k in want:
        _near(got[k], want[k], REL, k)


# -- C7: the preemption notice dumps the flight recorder --------------------------

def test_c7_terminate_on_preempt_dumps_flight_recorder(tmp_path,
                                                        monkeypatch):
    """A SIGTERM mid-epoch with recorded collectives and
    ``PADDLE_COLL_DEBUG_DIR`` set: ``comm_dump.rank0.json`` with reason
    ``preempt`` and one printed line naming it, in both packages."""
    import json

    seen = {}
    for pkg in (jpaddle, pt):
        name = pkg.__name__
        dump_dir = tmp_path / name
        monkeypatch.setenv("PADDLE_COLL_DEBUG_DIR", str(dump_dir))
        mon_mod = pkg.distributed.comm_monitor
        mon_mod.reset()
        with mon_mod.monitor().watch("all_reduce", 0, "dp", 1,
                                     shape=(4,), dtype="float32"):
            pass
        xs = np.random.RandomState(0).rand(8, 4).astype(np.float32)

        class DS(pkg.io.Dataset):
            def __len__(self):
                return 8

            def __getitem__(self, i):
                return xs[i], xs[i]

        class Notice(pkg.hapi.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                if step == 0:
                    os.kill(os.getpid(), signal.SIGTERM)

        net = pkg.nn.Linear(4, 4)
        model = pkg.Model(net)
        model.prepare(pkg.optimizer.SGD(learning_rate=0.1,
                                        parameters=net.parameters()),
                      pkg.nn.MSELoss())
        cb = pkg.hapi.callbacks.TerminateOnPreempt(verbose=1)
        buf = io.StringIO()
        with redirect_stdout(buf):
            model.fit(DS(), batch_size=4, epochs=2, shuffle=False,
                      verbose=0, callbacks=[Notice(), cb])
        path = dump_dir / "comm_dump.rank0.json"
        with open(path) as f:
            reason = json.load(f)["reason"]
        lines = [ln for ln in buf.getvalue().splitlines()
                 if "flight recorder" in ln]
        seen[name] = (reason, [ln.replace(str(dump_dir), "D")
                               for ln in lines])
        mon_mod.reset()
    assert seen["paddle_tpu_torch"][0] == "preempt"
    assert len(seen["paddle_tpu_torch"][1]) >= 1
    assert seen["paddle_tpu_torch"] == seen["paddle_tpu"]


# -- ZeRO's plan and its refusals ---------------------------------------------

def test_zero_plan_rule():
    """The JAX package's ``_zero_constrain`` / ``_leaf_pad_plan`` rule:
    the first dp-divisible axis; else the largest axis, padded, for a leaf
    of 1024 elements or more; else replicated."""
    from paddle_tpu_torch.distributed.fleet.base import _zero_plan

    assert _zero_plan((16, 24), 8) == 0
    assert _zero_plan((24,), 8) == 0
    assert _zero_plan((30522, 16), 8) == 1
    assert _zero_plan((30522, 12), 8) == 0
    assert _zero_plan((12, 30522), 8) == 1
    assert _zero_plan((5, 3), 8) is None
    assert _zero_plan((), 8) is None


def test_zero_refusals(net_init):
    """Narrow moments are not sharded; LocalSGD refuses what it does not
    compose with."""
    m = tw.zero_net()
    with pytest.raises(NotImplementedError, match="quantized_moments"):
        _dist_opt(pt, pt.optimizer.Adam(parameters=m.parameters()),
                  sharding=True, quantized_moments="int8")
    _fresh_process_state()
    for flags in (dict(amp=True), dict(recompute=True),
                  dict(sharding=True), dict(gradient_merge=True)):
        opt = _dist_opt(pt, pt.optimizer.SGD(parameters=m.parameters()),
                        localsgd=True, **flags)
        with pytest.raises(NotImplementedError, match="localsgd"):
            pt.jit.TrainStep(m, _ce(pt), opt)
        _fresh_process_state()


def test_localsgd_state_dict_hook_leaves_with_the_step(net_init):
    """While a ``LocalSGDStep`` lives, ``model.state_dict()`` syncs it
    first (the JAX package's checkpoint rule); once the step is gone, the
    model's own ``state_dict`` is back and no step state stays on it."""
    import gc

    m = tw.zero_net()
    opt = _dist_opt(pt, pt.optimizer.SGD(parameters=m.parameters()),
                    localsgd=True)
    step = pt.jit.TrainStep(m, _ce(pt), opt)
    synced = []
    step.sync_to_model = lambda: synced.append(1)
    assert set(m.state_dict()) == {"fc1.weight", "fc1.bias", "fc2.weight",
                                   "fc2.bias"}
    assert synced == [1]
    del step
    gc.collect()
    assert set(m.state_dict()) == {"fc1.weight", "fc1.bias", "fc2.weight",
                                   "fc2.bias"}
    assert synced == [1]
    assert "state_dict" not in m.__dict__
    _fresh_process_state()
