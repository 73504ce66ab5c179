"""``incubate.checkpoint.auto_checkpoint`` against paddle_tpu's.

Both packages' ``TrainEpochRange`` run the same 2-layer d128
``TransformerLM`` (weights carried from numpy; AdamW lr 1e-3 through
``jit.TrainStep``, registered as the range's extra; the dense routes) for
three epochs of two steps, each into its own checkpoint root:

- the per-epoch losses agree (atol 2e-5, float32 sums in different
  orders);
- each generation's ``meta.json`` has the reference's fields and values
  (epoch, name, max_epoch_num, the file names, the extras' class names;
  the CRCs are each file's own);
- ``PADDLE_CHECKPOINT_KEEP`` (2) keeps the two newest generations;
- a flipped byte in the newest generation fails its CRC and both
  packages fall back to the one before; an injected ``OSError`` on the
  first read (``io.load:fail:1``) is retried and the newest serves;
- ``acp.save:fail`` raises out of the range with no generation committed
  for that epoch; ``epoch:fail`` fires on entering that epoch;
- the extras carry the float16 loss scaler's state and the guard's
  counters into a fresh step (the port; the guard's keys are the
  reference's);
- a SIGTERM mid-epoch (one subprocess of the port) snapshots the epoch in
  flight and exits 143; resuming in this process ends bit for bit where
  an uninterrupted run ends (the oracle of
  ``tests/test_inference_acp.py:76``);
- a SIGTERM during a divergence streak withholds the snapshot, in both
  packages.
"""
import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.incubate.checkpoint import auto_checkpoint as jacp
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import pallas as jax_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from paddle_tpu.serving import TransformerLM as JaxLM
from paddle_tpu.utils import fault_injection as jfi

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as tacp
from paddle_tpu_torch.utils import fault_injection as pfi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, D, HEADS, LAYERS, S, B = 48, 128, 4, 2, 16, 2
LR, EPS, WD = 1e-3, 1e-6, 0.01
EPOCHS, STEPS = 3, 2
LOSS_ATOL = 2e-5
KNOBS = ("PADDLE_FAULT_SPEC", "PADDLE_GUARD_MODE", "PADDLE_GUARD_MAX_SKIPS",
         "PADDLE_GUARD_SYNC_EVERY", "PADDLE_GUARD_SPIKE_FACTOR",
         "PADDLE_GUARD_EVENT_FILE", "PADDLE_GUARD_DUMP_DIR",
         "PADDLE_CHECKPOINT_KEEP", "PADDLE_CHECKPOINT_DIR", "PADDLE_JOB_ID",
         "PADDLE_OBS_DIR", "PADDLE_OBS_BUS_FILE")
PKGS = {"jax": (paddle_tpu, jacp), "port": (pt, tacp)}


def _fresh_process_state():
    jax_comm._state.hybrid_mesh = pt_comm._mesh = None
    jax_pallas.flash_attention = jax_fa


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    with pytest.MonkeyPatch.context() as mp:
        for k in KNOBS:
            mp.delenv(k, raising=False)
        mp.setenv("PADDLE_FLASH_DEFAULT", "0")
        mp.setenv("PADDLE_FUSED_LN", "0")
        jfi.reset()
        pfi.reset()
        yield
    pt_device._current = saved
    _fresh_process_state()


@pytest.fixture
def clean_faults():
    jfi.reset()
    pfi.reset()
    yield
    os.environ.pop("PADDLE_FAULT_SPEC", None)
    jfi.reset()
    pfi.reset()


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


def _gpt(pkg, state):
    if pkg is paddle_tpu:
        m = JaxLM(VOCAB, d_model=D, num_heads=HEADS, num_layers=LAYERS,
                  max_position=S)
    else:
        m = pt.TransformerLM(VOCAB, d_model=D, num_heads=HEADS,
                             num_layers=LAYERS, max_position=S,
                             device="cpu")
    m.set_state_dict(state)
    return m


def _loss(pkg):
    F = JF if pkg is paddle_tpu else pt.nn.functional

    def loss(out, label):
        return F.cross_entropy(out.reshape([-1, VOCAB]),
                               label.reshape([-1]))

    return loss


def _batch(i):
    r = np.random.RandomState(100 + i)
    ids = r.randint(0, VOCAB, size=(B, S + 1))
    return ids[:, :-1], ids[:, 1:]


def _trainer(pkg, state):
    m = _gpt(pkg, state)
    opt = pkg.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                              weight_decay=WD, parameters=m.parameters())
    return m, opt, pkg.jit.TrainStep(m, _loss(pkg), opt)


def _state_np(m):
    return {k: np.array(v.numpy()) for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def ranges(tmp_path_factory):
    """Each package's range over three epochs: losses per epoch, the port's
    parameters at each epoch's end, and the checkpoint directories."""
    jm = JaxLM(VOCAB, d_model=D, num_heads=HEADS, num_layers=LAYERS,
               max_position=S)
    state = _random_state({k: tuple(v.shape)
                           for k, v in jm.state_dict().items()})
    root = tmp_path_factory.mktemp("acp")
    out = {"state": state}
    for name, (pkg, acp) in PKGS.items():
        m, opt, step = _trainer(pkg, state)
        r = acp.TrainEpochRange(EPOCHS, name="gpt",
                                checkpoint_path=str(root / name))
        r.register(model=m, optimizer=opt, scaler=step)
        losses, params = [], []
        for epoch in r.get():
            losses.append([float(step(*_batch(epoch * STEPS + i)))
                           if pkg is pt else
                           float(step(*_batch(epoch * STEPS + i)).numpy())
                           for i in range(STEPS)])
            params.append(_state_np(m))
        out[name] = dict(losses=losses, params=params, dir=r._dir,
                         snaps=[e for e, _ in r._snapshots()])
    return out


def test_per_epoch_losses_match(ranges):
    np.testing.assert_allclose(ranges["port"]["losses"],
                               ranges["jax"]["losses"], atol=LOSS_ATOL,
                               rtol=0)


def test_meta_json_fields_match(ranges):
    metas = {}
    for name in PKGS:
        d = ranges[name]["dir"]
        with open(os.path.join(d, "snap_00000002", "meta.json")) as f:
            metas[name] = json.load(f)
    jm, tm = metas["jax"], metas["port"]
    assert set(tm) == set(jm)
    for k in ("epoch", "name", "max_epoch_num", "extras"):
        assert tm[k] == jm[k], k
    assert tm["extras"] == ["TrainStep"]
    assert sorted(tm["files"]) == sorted(jm["files"]) == [
        "extra_0.pdextra", "model_0.pdparams", "opt_0.pdopt"]
    d = ranges["port"]["dir"]
    for fname, crc in tm["files"].items():
        assert pt.framework.io.crc32_file(
            os.path.join(d, "snap_00000002", fname)) == crc


def test_keep_prunes_to_the_two_newest(ranges):
    assert ranges["port"]["snaps"] == ranges["jax"]["snaps"] == [2, 1]


def _copy(ranges, name, tmp_path):
    dst = str(tmp_path / name)
    shutil.copytree(ranges[name]["dir"], dst)
    return dst


def _restore(pkg, acp, state, path):
    m, opt, step = _trainer(pkg, state)
    r = acp.TrainEpochRange(EPOCHS, name=os.path.basename(path))
    r._dir = path
    r.register(model=m, optimizer=opt, scaler=step)
    return r.restore(), m


def test_crc_fallback_on_a_flipped_byte(ranges, tmp_path, capfd):
    nxt = {}
    for name, (pkg, acp) in PKGS.items():
        d = _copy(ranges, name, tmp_path)
        f = os.path.join(d, "snap_00000002", "model_0.pdparams")
        with open(f, "r+b") as fh:
            fh.seek(os.path.getsize(f) // 2)
            byte = fh.read(1)
            fh.seek(-1, 1)
            fh.write(bytes([byte[0] ^ 0xFF]))
        nxt[name], m = _restore(pkg, acp, ranges["state"], d)
        if pkg is pt:
            for k, v in _state_np(m).items():
                np.testing.assert_array_equal(
                    v, ranges["port"]["params"][1][k], err_msg=k)
    assert nxt["port"] == nxt["jax"] == 2
    assert "CRC mismatch" in capfd.readouterr().err


def test_restore_retries_a_transient_oserror(ranges, tmp_path,
                                             clean_faults, monkeypatch):
    monkeypatch.setenv("PADDLE_FAULT_SPEC", "io.load:fail:1")
    for name, (pkg, acp) in PKGS.items():
        d = _copy(ranges, name, tmp_path)
        (jfi if pkg is paddle_tpu else pfi).reset()
        nxt, m = _restore(pkg, acp, ranges["state"], d)
        assert nxt == 3, name
        if pkg is pt:
            for k, v in _state_np(m).items():
                np.testing.assert_array_equal(
                    v, ranges["port"]["params"][2][k], err_msg=k)


def _linear_range(pkg, acp, path, epochs=3):
    m = pkg.nn.Linear(2, 2)
    r = acp.TrainEpochRange(epochs, name="lin", checkpoint_path=path)
    r.register(model=m)
    return r


@pytest.mark.parametrize("spec,ran_want,snaps_want", [
    ("acp.save:fail:2", [0, 1], [0]),
    ("epoch:fail:2", [0], [0]),
])
def test_fault_sites_fire_as_in_the_reference(tmp_path, clean_faults,
                                              monkeypatch, spec, ran_want,
                                              snaps_want):
    monkeypatch.setenv("PADDLE_FAULT_SPEC", spec)
    for name, (pkg, acp) in PKGS.items():
        r = _linear_range(pkg, acp, str(tmp_path / name))
        ran = []
        with pytest.raises(IOError, match="injected failure"):
            for epoch in r.get():
                ran.append(epoch)
        assert ran == ran_want, name
        assert [e for e, _ in r._snapshots()] == snaps_want, name


def test_extras_carry_scaler_and_guard_counters(tmp_path, clean_faults,
                                                monkeypatch):
    """The float16 loss scaler's state and the guard's counters ride the
    TrainStep extra into a fresh step; the guard's keys are paddle_tpu's."""
    from paddle_tpu_torch.distributed import fleet

    monkeypatch.setenv("PADDLE_FAULT_SPEC", "grad:nan:2")
    monkeypatch.setenv("PADDLE_GUARD_SYNC_EVERY", "1")
    x = np.linspace(-1, 1, 16, dtype=np.float32).reshape(4, 4)

    def step_of(seed):
        s = fleet.DistributedStrategy()
        s.amp = True
        s.amp_configs = {"use_bf16": False}
        fleet.init(is_collective=True, strategy=s)
        opt = fleet.distributed_optimizer(pt.optimizer.SGD(
            learning_rate=0.1))
        pt.seed(seed)
        m = pt.nn.Linear(4, 4)
        return m, opt, pt.jit.TrainStep(
            m, lambda o, y: ((o - y) ** 2).mean(), opt)

    m, opt, step = step_of(0)
    r = tacp.TrainEpochRange(1, name="sc", checkpoint_path=str(tmp_path))
    r.register(model=m, optimizer=opt, scaler=step)
    for _ in r.get():
        for _ in range(3):
            step(x, x)
    saved = step.state_dict()
    assert saved["guard"]["total_skips"] == 1.0
    assert saved["scaler"]["bad_steps"] == 0 and \
        saved["scaler"]["applied_steps"] == 2
    m2, opt2, step2 = step_of(1)
    r2 = tacp.TrainEpochRange(2, name="sc", checkpoint_path=str(tmp_path))
    r2.register(model=m2, optimizer=opt2, scaler=step2)
    assert r2.restore() == 1
    assert step2.state_dict() == saved
    assert float(step2._guard_state[1]) == 1.0
    np.testing.assert_array_equal(m2.weight.numpy(), m.weight.numpy())
    # the guard's persisted keys are paddle_tpu's
    jm = paddle_tpu.nn.Linear(4, 4)
    jstep = paddle_tpu.jit.TrainStep(
        jm, lambda o, y: ((o - y) ** 2).mean(),
        paddle_tpu.optimizer.SGD(learning_rate=0.1,
                                 parameters=jm.parameters()))
    assert set(jstep.state_dict()["guard"]) == set(saved["guard"])


_CHILD = r"""
import os, signal, sys
import numpy as np
sys.path.insert(0, {tests!r})
import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate.checkpoint.auto_checkpoint import (
    TrainEpochRange)
pt.set_device("cpu")
state = dict(np.load({state!r}))
import test_torch_auto_checkpoint as T
m, opt, step = T._trainer(pt, state)
r = TrainEpochRange(T.EPOCHS, name="pre", checkpoint_path={root!r})
r.register(model=m, optimizer=opt, scaler=step)
for epoch in r.get():
    for i in range(T.STEPS):
        step(*T._batch(epoch * T.STEPS + i))
        if epoch == 1 and i == 0:
            os.kill(os.getpid(), signal.SIGTERM)   # the notice, mid-epoch
print("completed")
"""


def test_resume_after_preemption_matches_uninterrupted(ranges, tmp_path):
    state_file = str(tmp_path / "state.npz")
    np.savez(state_file, **ranges["state"])
    root = str(tmp_path / "ck")
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(
            tests=os.path.join(REPO, "tests"), state=state_file,
            root=root)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 143, proc.stderr[-2000:]
    assert "completed" not in proc.stdout
    m, opt, step = _trainer(pt, ranges["state"])
    r = tacp.TrainEpochRange(EPOCHS, name="pre", checkpoint_path=root)
    r.register(model=m, optimizer=opt, scaler=step)
    # epoch 0 saved as usual, epoch 1 by the notice
    assert [e for e, _ in r._snapshots()] == [1, 0]
    ran = []
    for epoch in r.get():
        ran.append(epoch)
        for i in range(STEPS):
            step(*_batch(epoch * STEPS + i))
    assert ran == [2]
    for k, v in _state_np(m).items():
        np.testing.assert_array_equal(v, ranges["port"]["params"][-1][k],
                                      err_msg=k)


def test_preemption_mid_streak_withholds_snapshot(tmp_path, clean_faults,
                                                  monkeypatch):
    monkeypatch.setenv("PADDLE_GUARD_MAX_SKIPS", "50")
    monkeypatch.setenv("PADDLE_GUARD_SYNC_EVERY", "1")
    monkeypatch.setenv("PADDLE_FAULT_SPEC", "grad:nan:4:99")
    x = np.linspace(-1, 1, 16, dtype=np.float32).reshape(4, 4)
    for name, (pkg, acp) in PKGS.items():
        (jfi if pkg is paddle_tpu else pfi).reset()
        m = pkg.nn.Linear(4, 4)
        step = pkg.jit.TrainStep(m, lambda o, y: ((o - y) ** 2).mean(),
                                 pkg.optimizer.SGD(
                                     learning_rate=0.1,
                                     parameters=m.parameters()))
        r = acp.TrainEpochRange(6, name="pre", checkpoint_path=str(
            tmp_path / name))
        r.register(model=m, scaler=step)
        with pytest.raises(SystemExit) as ei:
            for epoch in r.get():
                for _ in range(3):
                    step(x, x)
                if epoch == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
        assert ei.value.code == 143
        assert [e for e, _ in r._snapshots()] == [0], name


def test_train_epoch_range_facade(tmp_path):
    for name, (pkg, acp) in PKGS.items():
        with acp.train_epoch_range(3, checkpoint_path=str(
                tmp_path / name)) as r:
            r.register(model=pkg.nn.Linear(2, 2))
            assert list(r.get()) == [0, 1, 2]
        with acp.train_epoch_range(3, checkpoint_path=str(
                tmp_path / name)) as r:
            r.register(model=pkg.nn.Linear(2, 2))
            assert list(r.get()) == []


def test_elastic_trainer_half(tmp_path, monkeypatch):
    """heartbeat, the preemption notice and the exit codes are the
    reference's; the launcher's names raise, naming ROADMAP item 7."""
    from paddle_tpu.distributed import elastic as jel
    from paddle_tpu_torch.distributed import elastic as tel

    assert (tel.PREEMPT_RC, tel.HUNG_RC) == (jel.PREEMPT_RC, jel.HUNG_RC)
    hb = tmp_path / "hb"
    tel.heartbeat()                       # no file set: nothing happens
    monkeypatch.setenv("PADDLE_HEARTBEAT_FILE", str(hb))
    tel.heartbeat()
    assert hb.exists()
    os.utime(hb, (0, 0))
    tel.heartbeat()
    assert os.path.getmtime(hb) > 0
    got = []
    before = signal.getsignal(signal.SIGTERM)
    old = tel.install_preempt_notice(lambda: got.append("notice"))
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        tel.restore_preempt_notice(old)
    assert got == ["notice"] and signal.getsignal(signal.SIGTERM) == before
    for name in ("ElasticManager", "RankProc"):
        with pytest.raises(NotImplementedError, match="item 7"):
            getattr(tel, name)
