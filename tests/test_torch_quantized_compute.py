"""Quantized compute: the fake-quant training matmul (``qat_matmul``,
``PADDLE_Q_MATMUL``, ``strategy.quantized_matmul``) and the narrow Adam
moments (``quantize_moments``, ``strategy.quantized_moments``), the port
against the JAX package on the CPU with the same numpy inputs and
weights.

The primitives give the JAX package's bytes (the weight and moment block
layouts, the sqrt-domain second moment, the 0-d sentinel) and its
straight-through gradients. The linear seam routes a wide weight through
``qat_matmul`` under a scope or the env knob, after the AMP cast, and
falls through to the dense product, bit for bit, with none. The
reference's ``TestQuantizedMoments`` program (20 eager Adam steps) and
bench.py's ``_bench_gpt_q8m`` at 2 layers, d 128, float32 (3 AdamW steps
through ``fleet`` and ``TrainStep``) and its ``quantized_matmul`` twin
run in both packages. Tolerances, stated at each test: float32 products
summed in other orders move a value by a few ulps, and an int8 code whose
value sits on a rounding boundary can land one step apart in the two
packages, which one Adam step turns into at most a learning-rate-sized
difference in that parameter.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu.ops.pallas as jax_pallas
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import ParallelGPTBlock as JaxBlock
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.distributed import quantized_compute as jqcp
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import ParallelGPTBlock
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.distributed import quantized_comm as qc
from paddle_tpu_torch.distributed import quantized_compute as qcp

WIDTHS = ("int8", "fp8")
VOCAB, D, HEADS, LAYERS, S, B = 512, 128, 2, 2, 64, 2


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


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("PADDLE_Q_MATMUL", raising=False)
    yield
    _fresh_process_state()


def _sd(layer):
    return {k: np.asarray(v.numpy()).copy()
            for k, v in layer.state_dict().items()}


def _close(got, want, k=1e-6, what=""):
    """Within ``k`` of ``want``'s largest magnitude: float32 sums of
    products taken in another order (XLA may contract them into fused
    multiply-adds) differ by a few ulps of their terms."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=k * np.abs(want).max(), err_msg=what)


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_qat_matmul_forward_is_the_reference(width):
    """The forward against the block-quantized weight: the JAX package's
    weight bytes, and its product within 1e-6 of the output's scale (one
    float32 product summed in another order)."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 3, 256).astype(np.float32)
    w = (rng.randn(256, 48) * 0.1).astype(np.float32)
    wq, ws = qcp.quantize_weight(torch.tensor(w), width, 128)
    jwq, jws = jqcp.quantize_weight(jnp.asarray(w), width, 128)
    np.testing.assert_array_equal(qc.bits(wq).numpy(),
                                  np.asarray(jwq).view(np.uint8)
                                  if width == "fp8" else np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    got = qcp.qat_matmul(torch.tensor(x), torch.tensor(w), width).numpy()
    want = np.asarray(jqcp.qat_matmul(jnp.asarray(x), jnp.asarray(w),
                                      width, 128))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    dense = x @ w
    rel = np.abs(got - dense).max() / np.abs(dense).max()
    assert 0 < rel < (0.01 if width == "int8" else 0.07)


def test_qat_backward_is_straight_through():
    """``dx`` through the dequantized weight the forward saw, ``dw`` the
    full-width float32 ``x^T g``: the JAX package's custom VJP, and the
    dense ``dw`` of the same cotangent, within 1e-6 of the largest
    gradient."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 256).astype(np.float32)
    w = (rng.randn(256, 16) * 0.1).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    (qcp.qat_matmul(xt, wt) ** 2).sum().backward()
    gx, gw = jax.grad(lambda a, b: jnp.sum(jqcp.qat_matmul(a, b) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _close(xt.grad.numpy(), np.asarray(gx))
    _close(wt.grad.numpy(), np.asarray(gw))
    out = qcp.qat_matmul(torch.tensor(x), torch.tensor(w))
    _close(wt.grad.numpy(), x.T @ (2 * out.numpy()))
    assert wt.grad.dtype == torch.float32


@pytest.mark.parametrize("width", WIDTHS)
def test_moment_layouts_are_the_reference_bytes(width):
    """``moment_narrow``/``moment2_narrow`` give the JAX package's
    payloads and scales (the last-axis blocks, ``sqrt(v)`` for the second
    moment), their wide forms its values (the half-step floor included),
    and a 0-d moment keeps the zero-scale sentinel."""
    rng = np.random.RandomState(3)
    m = rng.randn(6, 256).astype(np.float32) * 1e-3
    v = (rng.rand(6, 256).astype(np.float32) * 1e-6) ** 2
    v[0, 5:40] = 0.0
    for narrow, wide, arr in ((qcp.moment_narrow, qcp.moment_wide, m),
                              (qcp.moment2_narrow, qcp.moment2_wide, v)):
        p, s = narrow(torch.tensor(arr), width, 128)
        jnarrow = getattr(jqcp, narrow.__name__)
        jwide = getattr(jqcp, wide.__name__)
        jp, js = jnarrow(jnp.asarray(arr), width, 128)
        np.testing.assert_array_equal(
            qc.bits(p).numpy(), np.asarray(jp).view(np.uint8)
            if width == "fp8" else np.asarray(jp))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_allclose(wide(p, s).numpy(),
                                   np.asarray(jwide(jp, js)), rtol=1e-6,
                                   atol=0)
    p0, s0 = qcp.moment_narrow(torch.tensor(0.25), width)
    assert p0.dtype == torch.float32 and s0.dim() == 0 and float(s0) == 0
    assert float(qcp.moment_wide(p0, s0)) == 0.25
    assert float(qcp.moment2_wide(*qcp.moment2_narrow(
        torch.tensor(0.25), width))) == 0.25


def test_moment2_sqrt_domain_no_eps_blowup():
    """The reference's test: an element 100x below its block's largest
    survives the narrow second moment, and a true zero comes back as the
    half-step floor ``(scale / 2) ** 2``, not 0."""
    v = torch.full((128,), 1e-4)
    v[0] = 1.0
    p, s = qcp.moment2_narrow(v, "int8", 128)
    back = qcp.moment2_wide(p, s).numpy()
    assert back[1] > 0
    assert abs(np.sqrt(back[1]) - 1e-2) <= float(s[0]) / 2 + 1e-9
    vz = torch.zeros(128)
    vz[0] = 1.0
    pz, sz = qcp.moment2_narrow(vz, "int8", 128)
    assert qcp.moment2_wide(pz, sz)[1].item() == pytest.approx(
        (float(sz[0]) / 2) ** 2)


def test_policy_resolution_env_and_scope(monkeypatch):
    """``resolve_matmul``, ``matmul_scope`` (innermost wins, None forces
    off) and ``PADDLE_Q_MATMUL`` (loud on a typo), as the JAX
    package's."""
    for mod in (qcp, jqcp):
        assert mod.matmul_policy() is None
        assert mod.resolve_matmul("INT8") == ("int8", 128)
        assert mod.resolve_matmul(None) is None
        with pytest.raises(ValueError, match="quantized_matmul"):
            mod.resolve_matmul("int4")
        with mod.matmul_scope(("fp8", 64)):
            assert mod.matmul_policy() == ("fp8", 64)
            with mod.matmul_scope(None):
                monkeypatch.setenv("PADDLE_Q_MATMUL", "int8")
                assert mod.matmul_policy() is None
            assert mod.matmul_policy() == ("fp8", 64)
        assert mod.matmul_policy() == ("int8", 128)
        monkeypatch.setenv("PADDLE_Q_MATMUL", "off")
        assert mod.matmul_policy() is None
        monkeypatch.setenv("PADDLE_Q_MATMUL", "int3")
        with pytest.raises(ValueError, match="PADDLE_Q_MATMUL"):
            mod.matmul_policy()
        monkeypatch.delenv("PADDLE_Q_MATMUL")


def test_byte_records_are_the_reference_records():
    for pol in (None, ("int8", 128), ("fp8", 64)):
        assert qcp.moment_bytes_info(123_456, pol) == \
            jqcp.moment_bytes_info(123_456, pol)
        assert qcp.q_matmul_info(123_456, pol) == \
            jqcp.q_matmul_info(123_456, pol)
    assert qcp.moment_bytes_info(1 << 20, ("int8", 128))["reduction_x"] \
        == 3.88


# ---------------------------------------------------------------------------
# the linear seam
# ---------------------------------------------------------------------------


def _linear_pair(seed=12, din=256, dout=8):
    jpaddle.seed(seed)
    jl = jnn.Linear(din, dout)
    tl = pt.nn.Linear(din, dout)
    tl.set_state_dict(_sd(jl))
    return jl, tl


@pytest.mark.parametrize("route", ["scope", "env"])
def test_linear_routes_wide_weight_through_qat(route, monkeypatch):
    """Under a scope or ``PADDLE_Q_MATMUL`` the linear seam is
    ``qat_matmul(x, w) + b``: the JAX package's output and gradients
    within 1e-6 of their largest value (the weight's gradient full width,
    float32), and not the dense layer's."""
    jl, tl = _linear_pair()
    x = np.random.RandomState(4).rand(4, 256).astype(np.float32)
    cot = np.random.RandomState(5).randn(4, 8).astype(np.float32)
    if route == "env":
        monkeypatch.setenv("PADDLE_Q_MATMUL", "int8")
        ctx = [_nullscope, _nullscope]
    else:
        ctx = [lambda: qcp.matmul_scope(("int8", 128)),
               lambda: jqcp.matmul_scope(("int8", 128))]
    xt = torch.tensor(x, requires_grad=True)
    with ctx[0]():
        out = tl(xt)
    (out * torch.tensor(cot)).sum().backward()
    jx = jpaddle.to_tensor(x, stop_gradient=False)
    with ctx[1]():
        jout = jl(jx)
    (jout * jpaddle.to_tensor(cot)).sum().backward()
    _close(out.detach().numpy(), jout.numpy())
    _close(xt.grad.numpy(), jx.grad.numpy())
    _close(tl.weight.grad.numpy(), jl.weight.grad.numpy())
    assert tl.weight.grad.dtype == torch.float32
    monkeypatch.delenv("PADDLE_Q_MATMUL", raising=False)
    dense = tl(torch.tensor(x)).detach().numpy()
    assert not np.array_equal(out.detach().numpy(), dense)


class _nullscope:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_off_switch_is_bitwise_dense_and_amp_casts_first():
    """No scope and no env: the seam's output is the dense product, bit
    for bit. Under bf16 AMP the cast comes first: the policy quantizes the
    bf16 weight, and the output is the bf16 ``qat_matmul`` of the cast
    operands."""
    _, tl = _linear_pair(13, 64, 16)
    x = torch.tensor(np.random.RandomState(5).rand(8, 64).astype(np.float32))
    ref = torch.nn.functional.linear(x, tl.weight.t(), tl.bias)
    assert torch.equal(tl(x), ref)
    with pt.amp.auto_cast(dtype="bfloat16"), \
            qcp.matmul_scope(("int8", 128)):
        out = tl(x)
    want = qcp.qat_matmul(x.to(torch.bfloat16),
                          tl.weight.detach().to(torch.bfloat16)) \
        + tl.bias.detach().to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# int8 Adam moments
# ---------------------------------------------------------------------------


def _adam_traj(pkg, quant, init, steps=20):
    """The reference's TestQuantizedMoments program: Linear(64, 16), Adam
    1e-2, ``mean(net(x) ** 2)``, eager ``step()``."""
    rng = np.random.RandomState(6)
    net = pkg.nn.Linear(64, 16)
    net.set_state_dict(init)
    opt = pkg.optimizer.Adam(learning_rate=1e-2,
                             parameters=net.parameters())
    if quant:
        opt.quantize_moments(quant)
    x = pkg.to_tensor(rng.rand(8, 64).astype(np.float32))
    for _ in range(steps):
        (net(x) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
    return np.asarray(net.weight.numpy()).copy(), opt


@pytest.mark.parametrize("width", WIDTHS)
def test_narrow_adam_moments_match_the_reference(width):
    """20 Adam steps with int8 (fp8) moments: the port's weights within
    2e-3 of their largest value of the JAX package's at the same width (a
    moment code on a rounding boundary lands one step apart and moves its
    weight by at most ~lr = 1e-2 for the rest of the run; 2e-3 of 0.3),
    and within the reference's own 5% of the wide-moment run; the state
    resident narrow, payloads and float32 scales."""
    jpaddle.seed(14)
    init = _sd(jnn.Linear(64, 16))
    wq, optq = _adam_traj(pt, width, init)
    jq, _ = _adam_traj(jpaddle, width, init)
    wf, _ = _adam_traj(pt, None, init)
    scale = np.abs(jq).max()
    np.testing.assert_allclose(wq, jq, rtol=0, atol=2e-3 * scale)
    assert np.abs(wq - wf).max() / np.abs(wf).max() < 0.05
    assert not np.array_equal(wq, wf)
    narrow = torch.int8 if width == "int8" else qc.fp8_dtype()
    for nm in ("moment1", "moment2"):
        assert {t.dtype for t in optq._accumulators[nm].values()} == \
            {narrow}
        assert {t.dtype for t in optq._accumulators[nm + "_scale"]
                .values()} == {torch.float32}


def test_narrow_state_round_trips_and_late_arm_raises():
    """``state_dict``/``set_state_dict`` carry the narrow state: the port's
    into a new optimizer (the next step then equals the uninterrupted
    run's, bit for bit) and the JAX package's into the port (the same
    bytes); arming after state exists raises, as the reference's."""
    jpaddle.seed(15)
    init = _sd(jnn.Linear(64, 16))
    _, opt = _adam_traj(pt, "int8", init, steps=3)
    _, jopt = _adam_traj(jpaddle, "int8", init, steps=3)
    sd = {k: (v.numpy() if hasattr(v, "numpy") else v)
          for k, v in opt.state_dict().items()}
    jsd = {k: (np.asarray(v.numpy()) if hasattr(v, "numpy") else v)
           for k, v in jopt.state_dict().items()}
    assert set(sd) == set(jsd) and sd["@step"] == 3
    for k in sd:
        if k != "@step":
            assert sd[k].dtype == jsd[k].dtype, k
    for state in (sd, jsd):
        net = pt.nn.Linear(64, 16)
        o2 = pt.optimizer.Adam(learning_rate=1e-2,
                               parameters=net.parameters())
        o2.quantize_moments("int8")
        o2.set_state_dict(state)
        for k, v in state.items():
            if k == "@step":
                continue
            name, acc = k.rsplit(".", 1)
            p = o2._parameter_list[int(name.split("_")[1])] \
                if name.startswith("param_") else None
            got = o2._accumulators[acc][id(p)] if p is not None else None
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), v, err_msg=k)
    net = pt.nn.Linear(8, 4)
    o3 = pt.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters())
    (net(torch.ones(2, 8)) ** 2).mean().backward()
    o3.step()
    with pytest.raises(RuntimeError, match="before the first step"):
        o3.quantize_moments("int8")


# ---------------------------------------------------------------------------
# bench.py's q8m program at a small size
# ---------------------------------------------------------------------------


class JaxGPT(jnn.Layer):
    """bench.py's ``_gpt_medium`` at the test's size."""

    def __init__(self, layers=LAYERS):
        super().__init__()
        self.embed = jnn.Embedding(VOCAB, D)
        self.pos = jnn.Embedding(S, D)
        self.blocks = jnn.LayerList(
            [JaxBlock(D, HEADS, dropout=0.0) for _ in range(layers)])
        self.head = jnn.Linear(D, VOCAB)

    def forward(self, ids):
        h = self.embed(ids) + self.pos(jpaddle.arange(ids.shape[1],
                                                      dtype="int64"))
        for blk in self.blocks:
            h = blk(h)
        return h


class TorchGPT(pt.nn.Layer):
    def __init__(self, layers=LAYERS):
        super().__init__()
        self.embed = pt.nn.Embedding(VOCAB, D)
        self.pos = pt.nn.Embedding(S, D)
        self.blocks = pt.nn.LayerList(
            [ParallelGPTBlock(D, HEADS, dropout=0.0) for _ in range(layers)])
        self.head = pt.nn.Linear(D, VOCAB)

    def forward(self, ids):
        h = self.embed(ids) + self.pos(torch.arange(ids.shape[1]))
        for blk in self.blocks:
            h = blk(h)
        return h


def _lm_loss(pkg, model):
    def loss(h, labels):
        return pkg.nn.functional.fused_linear_cross_entropy(
            h.reshape([-1, D]), model.head.weight, model.head.bias,
            labels.reshape([-1]))

    return loss


def _gpt_run(pkg, init, batch, bus, steps=3, **flags):
    """bench's program: fleet with ``flags``, AdamW 1e-4 / 0.01 through
    ``distributed_optimizer``, ``TrainStep``; float32, its bus rows to the
    file ``bus`` (the guard read every step)."""
    import json

    fleet = pkg.distributed.fleet
    s = fleet.DistributedStrategy()
    for k, v in flags.items():
        setattr(s, k, v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_GUARD_SYNC_EVERY", "1")
        mp.setenv("PADDLE_OBS_BUS_FILE", str(bus))
        fleet.init(is_collective=True, strategy=s)
        model = JaxGPT() if pkg is jpaddle else TorchGPT()
        model.set_state_dict(init)
        opt = fleet.distributed_optimizer(pkg.optimizer.AdamW(
            learning_rate=1e-4, weight_decay=0.01,
            parameters=model.parameters()), strategy=s)
        step = pkg.jit.TrainStep(model, _lm_loss(pkg, model), opt)
        losses = [float(np.asarray(step(*batch).numpy()))
                  for _ in range(steps)]
    _fresh_process_state()
    inner = getattr(opt, "_inner", opt)
    return {"losses": losses, "params": _sd(model),
            "q_matmul": step._q_matmul, "q_matmul_info": step._q_matmul_info,
            "moment_bytes_info": step._moment_bytes_info,
            "resident": sum(t.numel() * t.element_size()
                            for nm in ("moment1", "moment2",
                                       "moment1_scale", "moment2_scale")
                            for t in inner._accumulators.get(nm, {})
                            .values()) if pkg is pt else None,
            "bus": [json.loads(line)
                    for line in bus.read_text().splitlines()]}


@pytest.fixture(scope="module")
def gpt_runs(tmp_path_factory):
    """bench's program through both packages, once a configuration:
    int8 moments, the int8 QAT matmul, and (the port) every policy off."""
    tmp = tmp_path_factory.mktemp("bus")
    jpaddle.distributed.fleet.init(
        is_collective=True,
        strategy=jpaddle.distributed.fleet.DistributedStrategy())
    jpaddle.seed(16)
    init = _sd(JaxGPT())
    _fresh_process_state()
    n = B * S
    ids = (np.arange(n) % (VOCAB - 3)).reshape(B, S).astype(np.int64)
    labels = ((np.arange(n) * 7 + 1) % VOCAB).reshape(B, S).astype(np.int64)
    batch = (ids, labels)
    runs = {}
    for name, pkg, flags in (
            ("q8m", pt, dict(quantized_moments="int8")),
            ("q8m_jax", jpaddle, dict(quantized_moments="int8")),
            ("qat", pt, dict(quantized_matmul="int8")),
            ("qat_jax", jpaddle, dict(quantized_matmul="int8")),
            ("dense", pt, {})):
        runs[name] = _gpt_run(pkg, init, batch, tmp / f"{name}.jsonl",
                              **flags)
    return runs


def test_bench_q8m_program_matches_the_reference(gpt_runs):
    """bench.py's ``_bench_gpt_q8m`` (``quantized_moments="int8"``) at 2
    layers, d 128, float32: losses within 1e-5 of the JAX package's (the
    forward before any update sees equal weights; an update moves weights
    by ~lr = 1e-4), parameters within 6e-4 = 3 steps x 2 lr (a moment code
    on a rounding boundary, or a gradient near 0 whose sign differs,
    moves a weight by up to 2 lr a step); the moments resident narrow, and
    their bytes, payload plus scales, the step's ``moment_bytes``."""
    got, want = gpt_runs["q8m"], gpt_runs["q8m_jax"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=6e-4,
                                   err_msg=k)
    info = got["moment_bytes_info"]
    assert info == want["moment_bytes_info"]
    assert got["resident"] == info["bytes_resident"]
    assert info["reduction_x"] == 3.88


def test_quantized_matmul_step_matches_the_reference(gpt_runs):
    """The same program under ``strategy.quantized_matmul="int8"``: every
    wide linear weight trains through ``qat_matmul`` (the head inside
    ``fused_linear_cross_entropy`` stays wide, as in the JAX package):
    losses within 1e-5 of the JAX package's and 2e-2 of the dense run's,
    parameters within 6e-4 (as above); the step's ``q_matmul`` record the
    reference's."""
    got, want = gpt_runs["qat"], gpt_runs["qat_jax"]
    dense = gpt_runs["dense"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], dense["losses"], rtol=2e-2)
    assert got["losses"] != dense["losses"]
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=6e-4,
                                   err_msg=k)
    assert got["q_matmul"] == ("int8", 128)
    assert got["q_matmul_info"] == want["q_matmul_info"]
    # outside the step the policy is off again
    assert qcp.matmul_policy() is None


def test_step_metrics_rows_carry_quant_bytes_only_when_armed(gpt_runs):
    """The ``step_metrics`` rows carry ``moment_bytes`` under int8
    moments and ``q_matmul`` under the QAT matmul (the JAX package's keys
    and values), and neither with its policy off; the bus gets each
    record once a step."""
    def rows(name):
        return [r["payload"] for r in gpt_runs[name]["bus"]
                if r["kind"] == "step_metrics"]

    for name in ("q8m", "q8m_jax", "qat", "qat_jax", "dense"):
        kinds = [r["kind"] for r in gpt_runs[name]["bus"]]
        assert kinds.count("q_matmul") == kinds.count("moment_bytes") == 1
        assert rows(name)
    for name, armed in (("q8m", "moment_bytes"), ("qat", "q_matmul")):
        other = {"moment_bytes": "q_matmul",
                 "q_matmul": "moment_bytes"}[armed]
        for got, want in zip(rows(name), rows(f"{name}_jax")):
            assert got[armed] == want[armed]
            assert other not in got and other not in want
    for row in rows("dense"):
        assert "q_matmul" not in row and "moment_bytes" not in row
