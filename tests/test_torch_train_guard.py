"""The numerical guard's host half against paddle_tpu's.

- ``update_guard_state``: the same sequences of (ok, bits, gnorm, loss)
  through both packages' policy updates, spike detection off and on, as
  whole state vectors (float32 in both; equal within 1e-6 relative) and
  the same ``ok_apply`` verdicts;
- ``TrainStep`` on a 2-layer d128 ``TransformerLM`` with carried weights
  (AdamW; the dense routes, ``PADDLE_FLASH_DEFAULT=0`` /
  ``PADDLE_FUSED_LN=0``, so the JAX step compiles once per spec), under
  ``PADDLE_FAULT_SPEC=grad:nan:3:2`` and under ``grad:spike:3`` with
  spike detection: losses (atol 2e-5), the guard's counters (exact) and
  the parameters after five steps (atol 1e-4: AdamW updates of lr 1e-3,
  sums in different orders, as ``tests/test_torch_training.py`` states);
  the skipped steps leave the port's parameters bitwise unchanged;
- a rollback after ``PADDLE_GUARD_MAX_SKIPS`` bad steps restores the
  ``auto_checkpoint`` generation written before the poison, bit for bit,
  with the same events as paddle_tpu's;
- ``PADDLE_GUARD_MODE=abort`` exits 96 after a ``guard_abort`` event (a
  subprocess of the port alone);
- ``GuardCallback`` on ``Model.fit``, in both packages: the same events
  and the same stop;
- the replay bundle of a bad step loads and, replayed eagerly under
  ``FLAGS_check_nan_inf``, raises at the first non-finite op (``exp``),
  the op paddle_tpu's ``tools/replay_step.py`` names for its bundle.
"""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import pallas as jax_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from paddle_tpu.serving import TransformerLM as JaxLM
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu.utils import train_guard as jtg

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.utils import fault_injection as pfi
from paddle_tpu_torch.utils import train_guard as ptg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, D, HEADS, LAYERS, S, B = 48, 128, 4, 2, 16, 2
LR, EPS, WD = 1e-3, 1e-6, 0.01
LOSS_ATOL, PARAM_ATOL = 2e-5, 1e-4
GUARD_KNOBS = ("PADDLE_FAULT_SPEC", "PADDLE_GUARD_MODE",
               "PADDLE_GUARD_MAX_SKIPS", "PADDLE_GUARD_SYNC_EVERY",
               "PADDLE_GUARD_SPIKE_FACTOR", "PADDLE_GUARD_EWMA",
               "PADDLE_GUARD_SPIKE_WARMUP", "PADDLE_GUARD_EVENT_FILE",
               "PADDLE_GUARD_DUMP_DIR", "PADDLE_GUARD_CHECK_PARAMS",
               "PADDLE_OBS_DIR", "PADDLE_OBS_BUS_FILE")


def _fresh_process_state():
    jax_comm._state.hybrid_mesh = pt_comm._mesh = None
    jax_pallas.flash_attention = jax_fa


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_FLASH_DEFAULT", "0")
        mp.setenv("PADDLE_FUSED_LN", "0")
        yield
    pt_device._current = saved
    _fresh_process_state()


@pytest.fixture
def guard_env(monkeypatch, tmp_path):
    """Clean guard knobs, sync every step, events in tmp."""
    for k in GUARD_KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PADDLE_GUARD_SYNC_EVERY", "1")
    monkeypatch.setenv("PADDLE_GUARD_EVENT_FILE", str(tmp_path / "ev"))
    jfi.reset()
    pfi.reset()
    yield monkeypatch
    os.environ.pop("PADDLE_FAULT_SPEC", None)
    jfi.reset()
    pfi.reset()


def _events(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


# -- the in-step policy ------------------------------------------------------

def _sequence(seed=3, n=40):
    """(ok, bits, gnorm, loss) rows: mostly healthy, a few nonfinite steps,
    loss and grad-norm spikes."""
    r = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        loss = np.float32(2.0 + 0.1 * r.randn())
        gnorm = np.float32(1.0 + 0.05 * r.randn())
        bits = 0.0
        if i in (7, 8, 21):
            bits = float(ptg.HEALTH_GRAD)
            gnorm = np.float32(0.0)
        if i == 30:
            bits = float(ptg.HEALTH_LOSS | ptg.HEALTH_GRAD)
            loss = np.float32(np.nan)
            gnorm = np.float32(0.0)
        if i in (12, 25):
            loss = np.float32(40.0)        # a loss spike
        if i in (15, 33):
            gnorm = np.float32(60.0)       # a grad-norm spike
        rows.append((bits == 0.0, np.float32(bits), gnorm, loss))
    return rows


@pytest.mark.parametrize("spike", ["0", "4"])
def test_update_guard_state_matches(guard_env, spike):
    import jax.numpy as jnp

    guard_env.setenv("PADDLE_GUARD_SPIKE_FACTOR", spike)
    guard_env.setenv("PADDLE_GUARD_SPIKE_WARMUP", "5")
    js = jtg.init_guard_state()
    ts = ptg.init_guard_state()
    verdicts = []
    for ok, bits, gnorm, loss in _sequence():
        js, jok = jtg.update_guard_state(
            js, jnp.asarray(ok), jnp.asarray(bits), jnp.asarray(gnorm),
            jnp.asarray(loss))
        ts, tok = ptg.update_guard_state(
            ts, torch.tensor(ok), torch.tensor(bits), torch.tensor(gnorm),
            torch.tensor(loss))
        assert bool(tok) == bool(jok)
        verdicts.append(bool(tok))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=0)
    # spike detection masks the grad-norm spikes once warmed up
    assert verdicts.count(False) == (4 if spike == "0" else 6)


# -- TrainStep in both packages ----------------------------------------------

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
        else:
            a = r.randn(*shape) / np.sqrt(shape[0])
        out[name] = a.astype(np.float32)
    return out


def _models():
    jm = JaxLM(VOCAB, d_model=D, num_heads=HEADS, num_layers=LAYERS,
               max_position=S)
    state = _random_state({k: tuple(v.shape)
                           for k, v in jm.state_dict().items()})
    jm.set_state_dict(state)
    tm = pt.TransformerLM(VOCAB, d_model=D, num_heads=HEADS,
                          num_layers=LAYERS, max_position=S, device="cpu")
    tm.set_state_dict(state)
    return jm, tm


def _batch(seed):
    r = np.random.RandomState(seed)
    ids = r.randint(0, VOCAB, size=(B, S + 1))
    return ids[:, :-1], ids[:, 1:]


def _jax_loss(out, label):
    return JF.cross_entropy(out.reshape([-1, VOCAB]), label.reshape([-1]))


def _torch_loss(out, label):
    return pt.nn.functional.cross_entropy(out.reshape(-1, VOCAB),
                                          label.reshape(-1))


def _run_both(spec, steps=5):
    """Five TrainStep calls of each package under ``spec``: losses, the
    flushed guard state, the port's parameters after each step."""
    os.environ["PADDLE_FAULT_SPEC"] = spec
    jfi.reset()
    pfi.reset()
    jm, tm = _models()
    jstep = paddle_tpu.jit.TrainStep(jm, _jax_loss, paddle_tpu.optimizer.AdamW(
        learning_rate=LR, epsilon=EPS, weight_decay=WD,
        parameters=jm.parameters()))
    tstep = pt.jit.TrainStep(tm, _torch_loss, pt.optimizer.AdamW(
        learning_rate=LR, epsilon=EPS, weight_decay=WD,
        parameters=tm.parameters()))
    jl, tl, tparams = [], [], []
    for i in range(steps):
        x, y = _batch(i)
        jl.append(float(jstep(x, y).numpy()))
        tl.append(float(tstep(x, y)))
        tparams.append({k: v.detach().clone()
                        for k, v in tm.state_dict().items()})
    jstep._guard.flush()
    tstep._guard.flush()
    jstate = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    return jl, tl, jstep._guard._last, tstep._guard._last, jstate, tparams


@pytest.fixture(scope="module")
def nan_runs():
    with pytest.MonkeyPatch.context() as mp:
        for k in GUARD_KNOBS:
            mp.delenv(k, raising=False)
        mp.setenv("PADDLE_GUARD_SYNC_EVERY", "2")
        out = _run_both("grad:nan:3:2")
    os.environ.pop("PADDLE_FAULT_SPEC", None)
    return out


def test_grad_nan_losses_and_skips_match(nan_runs):
    jl, tl, jlast, tlast, _, _ = nan_runs
    np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
    assert tlast[1] == jlast[1] == 2.0          # total_skips
    assert tlast[5] == jlast[5] == float(ptg.HEALTH_GRAD)


def test_grad_nan_params_match_and_skips_are_bitwise(nan_runs):
    _, _, _, _, jstate, tparams = nan_runs
    for k, want in jstate.items():
        np.testing.assert_allclose(tparams[-1][k].numpy(), want,
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
        # steps 3 and 4 were no-ops: bitwise the parameters after step 2
        assert torch.equal(tparams[1][k], tparams[3][k]), k
        assert not torch.equal(tparams[3][k], tparams[4][k]) or \
            "embed" in k, k


def test_grad_spike_masked_by_gnorm_detection():
    with pytest.MonkeyPatch.context() as mp:
        for k in GUARD_KNOBS:
            mp.delenv(k, raising=False)
        mp.setenv("PADDLE_GUARD_SYNC_EVERY", "1")
        mp.setenv("PADDLE_GUARD_SPIKE_FACTOR", "5")
        mp.setenv("PADDLE_GUARD_SPIKE_WARMUP", "2")
        jl, tl, jlast, tlast, jstate, tparams = _run_both("grad:spike:3", 4)
    os.environ.pop("PADDLE_FAULT_SPEC", None)
    np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
    assert tlast[1] == jlast[1] == 1.0          # the spike was masked
    assert int(tlast[5]) & ptg.HEALTH_GNORM and int(jlast[5]) & \
        jtg.HEALTH_GNORM
    np.testing.assert_allclose(tlast, jlast, rtol=1e-4, atol=1e-5)
    for k, want in jstate.items():
        np.testing.assert_allclose(tparams[-1][k].numpy(), want,
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
        assert torch.equal(tparams[1][k], tparams[2][k]), k


# -- rollback, abort ----------------------------------------------------------

_X = np.arange(32, dtype=np.float32).reshape(8, 4) / 32.0
_Y = np.ones((8, 4), np.float32)


def _linear_step(pkg, w, b):
    m = pkg.nn.Linear(4, 4)
    m.set_state_dict({"weight": w, "bias": b})
    opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    return m, opt, pkg.jit.TrainStep(m, lambda o, y: ((o - y) ** 2).mean(),
                                     opt)


def test_rollback_restores_the_pre_poison_generation(guard_env, tmp_path):
    """MAX_SKIPS 3, steps 7.. poisoned: epochs 0 and 1 (steps 1-6) commit
    clean generations, epoch 2 spends the budget and the guard restores
    the newest clean generation, bit for bit, as paddle_tpu's does."""
    from paddle_tpu.incubate.checkpoint.auto_checkpoint import (
        TrainEpochRange as JRange)
    from paddle_tpu_torch.incubate.checkpoint.auto_checkpoint import (
        TrainEpochRange as TRange)

    guard_env.setenv("PADDLE_GUARD_MAX_SKIPS", "3")
    guard_env.setenv("PADDLE_FAULT_SPEC", "grad:nan:7:6")
    r = np.random.RandomState(0)
    w, b = r.randn(4, 4).astype(np.float32), r.randn(4).astype(np.float32)
    out = {}
    for name, pkg, rng in (("jax", paddle_tpu, JRange), ("port", pt, TRange)):
        ev = tmp_path / f"ev_{name}"
        guard_env.setenv("PADDLE_GUARD_EVENT_FILE", str(ev))
        m, opt, step = _linear_step(pkg, w, b)
        ck = str(tmp_path / f"ck_{name}")
        rg = rng(4, name="g_rb", checkpoint_path=ck)
        rg.register(model=m, optimizer=opt, scaler=step)
        snap_w = {}
        after_rollback = None
        for epoch in rg.get():
            for _ in range(3):
                step(_X, _Y)
                if step._guard.rollbacks and after_rollback is None:
                    after_rollback = np.array(m.weight.numpy())
            snap_w[epoch] = np.array(m.weight.numpy())
        evs = _events(ev)
        rb = [e for e in evs if e["event"] == "guard_rollback"]
        out[name] = ([e["event"] for e in evs], rb[0]["restored_epoch"],
                     snap_w, after_rollback)
    assert out["port"][0] == out["jax"][0]
    restored = out["port"][1]
    assert restored == out["jax"][1] and restored <= 1
    snap_w, after = out["port"][2], out["port"][3]
    np.testing.assert_array_equal(after, snap_w[restored])
    np.testing.assert_allclose(snap_w[restored], out["jax"][2][restored],
                               atol=1e-6, rtol=0)


def test_abort_exits_96_after_its_event(tmp_path):
    ev = tmp_path / "ev"
    code = (
        "import numpy as np, paddle_tpu_torch as pt\n"
        "pt.set_device('cpu')\n"
        "m = pt.nn.Linear(4, 4)\n"
        "opt = pt.optimizer.SGD(learning_rate=0.1, "
        "parameters=m.parameters())\n"
        "step = pt.jit.TrainStep(m, lambda o, y: ((o - y) ** 2).mean(), "
        "opt)\n"
        "x = np.ones((8, 4), np.float32)\n"
        "for i in range(8):\n"
        "    step(x, x)\n"
        "print('not aborted')\n")
    env = {k: v for k, v in os.environ.items() if k not in GUARD_KNOBS}
    env.update(PYTHONPATH=REPO, PADDLE_GUARD_MODE="abort",
               PADDLE_GUARD_MAX_SKIPS="2", PADDLE_GUARD_SYNC_EVERY="1",
               PADDLE_FAULT_SPEC="grad:nan:2:99",
               PADDLE_GUARD_EVENT_FILE=str(ev))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == ptg.GUARD_ABORT_RC == jtg.GUARD_ABORT_RC, \
        proc.stderr[-2000:]
    assert "not aborted" not in proc.stdout
    kinds = [e["event"] for e in _events(ev)]
    assert kinds[-1] == "guard_abort" and "guard_skip" in kinds
    assert "2 consecutive bad steps" in _events(ev)[-1]["detail"]


# -- hapi ---------------------------------------------------------------------

def _fit_with_guard(pkg, tmp, w, b):
    """Model.fit of a Linear net over 6 batches of 4, the last two with
    NaN inputs, under GuardCallback(max_skips=2) without an anchor yet."""
    xs = np.arange(96, dtype=np.float32).reshape(24, 4) / 96.0
    xs[16:] = np.nan
    ys = np.ones((24, 4), np.float32)

    class DS(pkg.io.Dataset):
        def __len__(self):
            return 24

        def __getitem__(self, i):
            return xs[i], ys[i]

    net = pkg.nn.Linear(4, 4)
    net.set_state_dict({"weight": w, "bias": b})
    model = pkg.Model(net)
    model.prepare(pkg.optimizer.SGD(learning_rate=0.1,
                                    parameters=net.parameters()),
                  pkg.nn.MSELoss())
    cb = pkg.hapi.callbacks.GuardCallback(max_skips=2, verbose=0)
    model.fit(DS(), batch_size=4, epochs=3, shuffle=False, verbose=0,
              callbacks=[cb])
    return cb, model


def test_guard_callback_on_model_fit(guard_env, tmp_path):
    r = np.random.RandomState(1)
    w, b = r.randn(4, 4).astype(np.float32), r.randn(4).astype(np.float32)
    out = {}
    for name, pkg in (("jax", paddle_tpu), ("port", pt)):
        ev = tmp_path / f"ev_{name}"
        guard_env.setenv("PADDLE_GUARD_EVENT_FILE", str(ev))
        cb, model = _fit_with_guard(pkg, tmp_path, w, b)
        out[name] = ([(e["event"], e["step"], e.get("consec"))
                      for e in _events(ev)], cb.total_bad, cb.consec,
                     model.stop_training,
                     np.array(model.network.weight.numpy()))
    assert out["port"][:4] == out["jax"][:4]
    assert out["port"][0][-1][0] == "guard_stop" and out["port"][3]
    np.testing.assert_allclose(out["port"][4], out["jax"][4], atol=1e-6)


def test_terminate_on_preempt_on_model_fit(tmp_path):
    """A SIGTERM during epoch 0 of ``Model.fit``: the epoch finishes, a
    ``save_dir/preempt`` checkpoint is written and training stops, in both
    packages; the handler is restored after."""
    import signal

    r = np.random.RandomState(4)
    w, b = r.randn(4, 4).astype(np.float32), r.randn(4).astype(np.float32)
    xs = np.arange(64, dtype=np.float32).reshape(16, 4) / 64.0
    out = {}
    before = signal.getsignal(signal.SIGTERM)
    for name, pkg in (("jax", paddle_tpu), ("port", pt)):
        class DS(pkg.io.Dataset):
            def __len__(self):
                return 16

            def __getitem__(self, i):
                return xs[i], xs[i]

        class Notice(pkg.hapi.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                if step == 1:
                    os.kill(os.getpid(), signal.SIGTERM)

        net = pkg.nn.Linear(4, 4)
        net.set_state_dict({"weight": w, "bias": b})
        model = pkg.Model(net)
        model.prepare(pkg.optimizer.SGD(learning_rate=0.1,
                                        parameters=net.parameters()),
                      pkg.nn.MSELoss())
        save = str(tmp_path / name)
        cb = pkg.hapi.callbacks.TerminateOnPreempt(save_dir=save,
                                                   verbose=0)
        seen = []

        class Epochs(pkg.hapi.callbacks.Callback):
            def on_epoch_end(self, epoch, logs=None):
                seen.append(epoch)

        model.fit(DS(), batch_size=4, epochs=3, shuffle=False, verbose=0,
                  callbacks=[Notice(), Epochs(), cb])
        out[name] = (seen, cb.preempted, model.stop_training,
                     sorted(os.listdir(save)))
        assert signal.getsignal(signal.SIGTERM) == before
    assert out["port"] == out["jax"]
    assert out["port"][0] == [0] and out["port"][1] is True
    assert any(f.startswith("preempt") for f in out["port"][3])


# -- the replay bundle --------------------------------------------------------

def _exploder(pkg):
    class Exploder(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = pkg.nn.Linear(4, 4)

        def forward(self, x):
            return pkg.exp(self.lin(x))

    return Exploder()


def test_replay_bundle_names_the_faulting_op(guard_env, tmp_path):
    """A batch that overflows exp: the guard dumps the step's bundle; the
    bundle loads, and its step replayed eagerly under FLAGS_check_nan_inf
    raises at exp's forward, the op paddle_tpu's replay names."""
    from paddle_tpu_torch.core.autograd import NanInfError

    sys.path.insert(0, REPO)
    from tools.replay_step import replay

    guard_env.setenv("PADDLE_GUARD_DUMP_DIR", str(tmp_path / "dump"))
    r = np.random.RandomState(2)
    w = (0.5 + 0.01 * r.randn(4, 4)).astype(np.float32)
    b = np.zeros(4, np.float32)
    bad = np.full((8, 4), 200.0, np.float32)   # exp(~400) overflows
    reports = {}
    for name, pkg in (("jax", paddle_tpu), ("port", pt)):
        guard_env.setenv("PADDLE_GUARD_DUMP_DIR", str(tmp_path / name))
        m = _exploder(pkg)
        m.lin.set_state_dict({"weight": w, "bias": b})
        step = pkg.jit.TrainStep(m, lambda o, y: ((o - y) ** 2).mean(),
                                 pkg.optimizer.SGD(learning_rate=0.01,
                                                   parameters=m.parameters()))
        for x in (_X, _X, bad, _X):
            step(x, _Y)
        step._guard.flush()
        bundles = glob.glob(str(tmp_path / name / "*.pdbundle"))
        assert len(bundles) == 1
        reports[name] = bundles[0]
    assert os.path.basename(reports["port"]) == \
        os.path.basename(reports["jax"]) == "guard_step00000003.rank0.pdbundle"
    jrep = replay(reports["jax"], _exploder(paddle_tpu),
                  lambda o, y: ((o - y) ** 2).mean())
    assert jrep["faulting_op"] == "exp" and jrep["phase"] == "forward"
    bundle = pt.load(reports["port"], return_numpy=True)
    assert bundle["step"] == 3 and bundle["fingerprint"] == jrep[
        "fingerprint"]
    np.testing.assert_array_equal(bundle["inputs"][0], bad)
    m2 = _exploder(pt)
    m2.set_state_dict(bundle["state"])
    pt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(NanInfError) as e:
            out = m2(pt.to_tensor(bundle["inputs"][0]))
            ((out - pt.to_tensor(bundle["labels"][0])) ** 2).mean().backward()
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": False})
    assert e.value.op_name == "exp" and e.value.phase == "forward"
