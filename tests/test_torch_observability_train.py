"""The training half of the port's observability against paddle_tpu's:
``step_metrics`` rows, MFU, the recompile ledger and the profiler.

- ``StepMetricsSampler``: both packages' ``TrainStep`` under the guard
  (``PADDLE_GUARD_SYNC_EVERY=1``) write ``step_metrics`` rows with the
  same keys and the same counters;
- ``mfu_pct`` is the reference's arithmetic, and both report none on the
  CPU without ``PADDLE_OBS_PEAK_FLOPS``;
- ``TrainStep.flops_per_step`` of a 2-layer d128 ``TransformerLM`` step
  (B 2, S 16; the flash and LayerNorm kernels' routes, their plain
  versions here) is the analytic count of its matrix products, forward
  and backward, the attention at the full S x S;
- the ledger's ``recompile`` fingerprints, ``changed`` lines and
  ``recompile_storm`` detail equal the reference's for the same argument
  sequences (the port's function under ``to_static``, the reference's
  under ``jax.jit``); each kernel build becomes a ``backend_compile`` row;
- the profiler's ``event_summary`` has the reference's keys, and the
  trace window steps through the same states; a window over a guarded
  ``TrainStep`` holds the ``TrainStep::guard`` and
  ``TrainStep::opt_update`` spans.
"""
import json
import os

import jax
import numpy as np
import pytest

import paddle_tpu
from paddle_tpu import profiler as jprof
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.observability import bus as jbus
from paddle_tpu.observability import ledger as jledger
from paddle_tpu.observability import mfu as jmfu
from paddle_tpu.ops import pallas as jax_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from paddle_tpu.utils import fault_injection as jfi

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.observability import bus as tbus
from paddle_tpu_torch.observability import ledger as tledger
from paddle_tpu_torch.observability import mfu as tmfu
from paddle_tpu_torch.utils import fault_injection as pfi

VOCAB, D, HEADS, LAYERS, S, B = 48, 128, 4, 2, 16, 2
KNOBS = ("PADDLE_FAULT_SPEC", "PADDLE_GUARD_MODE", "PADDLE_GUARD_SYNC_EVERY",
         "PADDLE_GUARD_SPIKE_FACTOR", "PADDLE_GUARD_EVENT_FILE",
         "PADDLE_OBS_DIR", "PADDLE_OBS_BUS_FILE", "PADDLE_OBS_PEAK_FLOPS",
         "PADDLE_OBS_STORM_N", "PADDLE_OBS_STEP_METRICS",
         "PADDLE_OBS_TRACE_AT_STEP", "PADDLE_OBS_TRACE_STEPS",
         "PADDLE_OBS_TRACE_DIR", "PADDLE_OBS_TRACE_MAX")


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
        yield
    pt_device._current = saved
    _fresh_process_state()


@pytest.fixture
def obs(monkeypatch, tmp_path):
    """A bus file per package, clean knobs, fresh step counters, trace
    windows and fault injectors."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for mod in (jbus, tbus):
        mod.reset()
    for p in (jprof, tprof):
        p._reset_trace_state()
    jfi.reset()
    pfi.reset()
    yield monkeypatch
    for p in (jprof, tprof):
        p._reset_trace_state()
    for mod in (jbus, tbus):
        mod.reset()


def _rows(path, kind):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["kind"] == kind]


_X = np.arange(32, dtype=np.float32).reshape(8, 4) / 32.0
_Y = np.ones((8, 4), np.float32)


def _linear_step(pkg):
    m = pkg.nn.Linear(4, 4)
    m.set_state_dict({"weight": np.eye(4, dtype=np.float32) * 0.5,
                      "bias": np.zeros(4, np.float32)})
    return pkg.jit.TrainStep(m, lambda o, y: ((o - y) ** 2).mean(),
                             pkg.optimizer.SGD(learning_rate=0.1,
                                               parameters=m.parameters()))


def test_step_metrics_rows_match(obs, tmp_path):
    obs.setenv("PADDLE_GUARD_SYNC_EVERY", "1")
    obs.setenv("PADDLE_FAULT_SPEC", "grad:nan:3")
    rows = {}
    for name, pkg in (("jax", paddle_tpu), ("port", pt)):
        path = str(tmp_path / f"bus_{name}.jsonl")
        obs.setenv("PADDLE_OBS_BUS_FILE", path)
        (jfi if pkg is paddle_tpu else pfi).reset()
        step = _linear_step(pkg)
        for _ in range(6):
            step(_X, _Y)
        rows[name] = _rows(path, "step_metrics")
    assert len(rows["port"]) == len(rows["jax"]) == 4
    for tr, jr in zip(rows["port"], rows["jax"]):
        assert set(tr["payload"]) == set(jr["payload"])
        assert tr["step"] == jr["step"]
        for k in ("steps", "consec_bad", "total_skips", "total_spikes"):
            assert tr["payload"][k] == jr["payload"][k], k
        assert tr["payload"]["grad_comm"] == jr["payload"]["grad_comm"]
        np.testing.assert_allclose(tr["payload"]["loss"],
                                   jr["payload"]["loss"], rtol=1e-5)


def test_step_metrics_off_and_guard_off_write_no_rows(obs, tmp_path):
    path = str(tmp_path / "bus.jsonl")
    obs.setenv("PADDLE_OBS_BUS_FILE", path)
    obs.setenv("PADDLE_GUARD_SYNC_EVERY", "1")
    for knob, value in (("PADDLE_OBS_STEP_METRICS", "0"),
                        ("PADDLE_GUARD_MODE", "off")):
        obs.setenv(knob, value)
        step = _linear_step(pt)
        for _ in range(4):
            step(_X, _Y)
        obs.delenv(knob)
    assert _rows(path, "step_metrics") == []


def test_mfu_pct_matches_the_reference(obs):
    assert tmfu.peak_flops() is None and jmfu.peak_flops() is None
    assert tmfu.mfu_pct(1e12, 0.5) is None
    obs.setenv("PADDLE_OBS_PEAK_FLOPS", "989e12")
    for flops, secs in ((1e12, 0.5), (3.3e15, 0.2841), (7.0, 1e-9)):
        assert tmfu.mfu_pct(flops, secs) == jmfu.mfu_pct(flops, secs)
    assert tmfu.mfu_pct(None, 0.5) is None and tmfu.mfu_pct(1e12, 0) is None
    names = [n for n, _ in tmfu.PEAK_FLOPS]
    assert names.index("h100 pcie") < names.index("h100")
    assert dict(tmfu.PEAK_FLOPS)["h100"] == 989e12


def test_flops_per_step_is_the_analytic_count(obs):
    """Forward: 2 T (in x out) per linear and QK^T + PV at the full S x S;
    backward twice each linear (dX, dW) and the five products of torch's
    SDPA backward formula. paddle_tpu's ``cost_analysis()`` of the same
    step on the CPU reads 88,395,616, 1.1259x this count (XLA prices
    the elementwise work, the softmax and the optimizer too): reported,
    not compared."""
    obs.setenv("PADDLE_FLASH_DEFAULT", "interpret")
    obs.setenv("PADDLE_FUSED_LN", "interpret")
    tm = pt.TransformerLM(VOCAB, d_model=D, num_heads=HEADS,
                          num_layers=LAYERS, max_position=S, device="cpu")
    step = pt.jit.TrainStep(
        tm, lambda o, y: pt.nn.functional.cross_entropy(
            o.reshape(-1, VOCAB), y.reshape(-1)),
        pt.optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters()))
    assert step.flops_per_step() is None          # before the first call
    ids = np.random.RandomState(0).randint(0, VOCAB, (B, S + 1))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    step(ids[:, :-1], ids[:, 1:])
    T, dh = B * S, D // HEADS
    linear = LAYERS * (D * 3 * D + D * D + D * 4 * D + 4 * D * D) \
        + D * VOCAB
    attn = LAYERS * (2 + 5) * 2 * B * HEADS * S * S * dh
    want = 3 * 2 * T * linear + attn
    assert want == 78512128
    after = {k: v.clone() for k, v in tm.state_dict().items()}
    assert step.flops_per_step() == want
    # counting ran on fake tensors: no parameter moved, no gradient left
    assert all((after[k] == tm.state_dict()[k]).all() for k in after)
    assert all(p.grad is None for p in tm.parameters())
    assert any(not (before[k] == after[k]).all() for k in after)
    assert step.mfu_pct(0.1) is None              # no peak on the CPU
    obs.setenv("PADDLE_OBS_PEAK_FLOPS", "1e9")
    assert step.mfu_pct(0.1) == round(want / 0.1 / 1e9 * 100, 2)


def _drive_ledger(name, tmp_path, obs):
    path = str(tmp_path / f"ledger_{name}.jsonl")
    obs.setenv("PADDLE_OBS_BUS_FILE", path)
    obs.setenv("PADDLE_OBS_STORM_N", "3")
    if name == "jax":
        fn = jledger.instrument(jax.jit(lambda x, s: x * 2.0 + s),
                                label="f")
        wrap = jax.numpy.asarray
    else:
        fn = tledger.instrument(pt.jit.to_static(lambda x, s: x * 2.0 + s),
                                label="f")
        wrap = pt.to_tensor
    for rows in (4, 5, 4, 6, 7):
        fn(wrap(np.ones((rows, 8), np.float32)), 1.0)
    return fn.compiles, _rows(path, "recompile"), _rows(
        path, "recompile_storm")


def test_ledger_rows_match_the_reference(obs, tmp_path):
    jledger.reset()
    tledger.reset()
    out = {name: _drive_ledger(name, tmp_path, obs)
           for name in ("jax", "port")}
    (jn, jrec, jstorm), (tn, trec, tstorm) = out["jax"], out["port"]
    assert tn == jn == 4 and tledger.compile_count() == 4
    assert [r["payload"]["fingerprint"] for r in trec] == \
        [r["payload"]["fingerprint"] for r in jrec]
    assert trec[1]["payload"]["fingerprint"][0] == ["args[0]", "float32[5,8]"]
    assert [r["payload"]["changed"] for r in trec] == \
        [r["payload"]["changed"] for r in jrec]
    assert [r["payload"]["detail"] for r in tstorm] == \
        [r["payload"]["detail"] for r in jstorm]
    assert tstorm[-1]["payload"]["detail"] == (
        "f compiled 4x — the argument signature keeps changing: "
        "args[0]: float32[6,8] -> float32[7,8]")


def test_kernel_builds_become_backend_compile_rows(obs, tmp_path):
    from paddle_tpu_torch.ops.kernels import _build

    path = str(tmp_path / "bus.jsonl")
    obs.setenv("PADDLE_OBS_BUS_FILE", path)
    tledger.install_backend_listener()
    tledger.install_backend_listener()            # once a process
    assert _build.BUILD_LISTENERS.count(tledger._on_build) == 1
    for listener in _build.BUILD_LISTENERS:
        listener("flash_attention", 21.4567)
    rows = _rows(path, "backend_compile")
    assert [r["payload"] for r in rows] == [
        {"key": "nvcc:flash_attention", "seconds": 21.457}]


def test_event_summary_keys_match(obs, tmp_path):
    out = {}
    for name, prof in (("jax", jprof), ("port", tprof)):
        prof.start_profiler("CPU")
        for _ in range(3):
            with prof.RecordEvent("outer"):
                with prof.RecordEvent("inner"):
                    pass
        assert prof.is_profiling()
        out[name] = prof.stop_profiler("calls")
        assert not prof.is_profiling()
        with prof.RecordEvent("off"):
            pass
        assert "off" not in prof.event_summary()
    assert set(out["port"]) == set(out["jax"]) == {"outer", "inner"}
    for k in ("outer", "inner"):
        assert set(out["port"][k]) == set(out["jax"][k])
        assert out["port"][k]["calls"] == out["jax"][k]["calls"] == 3
    trace = str(tmp_path / "trace.json")
    with tprof.profiler("CPU", profile_path=trace):
        with tprof.RecordEvent("named"):
            pass
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "named" in names


def _window_states(prof, tmp, obs):
    obs.setenv("PADDLE_OBS_TRACE_MAX", "1")
    prof._reset_trace_state()
    states = [prof.arm_trace(steps=2, reason="test",
                             trace_dir=str(tmp))]
    states.append(prof.arm_trace(steps=2, trace_dir=str(tmp)))  # busy
    for step in range(1, 5):
        prof.step_boundary(step)
        w = prof.trace_window_state()
        states.append(None if w is None else {
            k: w[k] for k in ("remaining", "reason", "active",
                              "start_step", "last_step") if k in w})
    states.append(prof.arm_trace(steps=1, trace_dir=str(tmp)))  # spent
    return states


def test_trace_window_state_machine_matches(obs, tmp_path):
    js = _window_states(jprof, tmp_path / "jax", obs)
    ts = _window_states(tprof, tmp_path / "port", obs)
    assert ts == js
    assert ts[0] is True and ts[1] is False and ts[-1] is False
    assert os.path.exists(tmp_path / "port" / "step1.rank0.test" /
                          "trace.json")


def test_trace_window_over_a_guarded_step(obs, tmp_path):
    """``PADDLE_OBS_TRACE_AT_STEP=2`` opens a window of two steps at the
    second TrainStep call; its trace names the guard and the update, and
    the bus announces it."""
    bus = str(tmp_path / "bus.jsonl")
    obs.setenv("PADDLE_OBS_BUS_FILE", bus)
    obs.setenv("PADDLE_OBS_TRACE_AT_STEP", "2")
    obs.setenv("PADDLE_OBS_TRACE_STEPS", "2")
    obs.setenv("PADDLE_OBS_TRACE_DIR", str(tmp_path / "traces"))
    step = _linear_step(pt)
    for _ in range(4):
        step(_X, _Y)
    captured = _rows(bus, "trace_captured")
    assert [(r["payload"]["first_step"], r["payload"]["last_step"])
            for r in captured] == [(2, 3)]
    with open(os.path.join(captured[0]["payload"]["dir"],
                           "trace.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("TrainStep::guard") == 2
    assert names.count("TrainStep::opt_update") == 2
    assert _rows(bus, "trace_armed")[0]["payload"]["reason"] == "at_step_2"
