"""The gradient-width plane: the quantizer's round trip, the quantized
allreduce, the boundary width policies and the hierarchical dcn hop, the
port against the JAX package.

One process: ``quantize_dequantize`` gives the JAX package's bytes (int8
and fp8); ``grad_comm_info`` its record (and the port's per-hop prices);
``fp16_allreduce`` and ``quantized_allreduce`` (int8, fp8) through
``fleet`` on a flat mesh, eager and through ``TrainStep``, give the JAX
package's losses and parameters within 1e-6 relative (float32 on the CPU
in both; the two round a sum in other orders, and a code that lands on a
rounding boundary can move by one step: the tolerance is set from what
int8 of these gradients allows, stated at each assertion).

A world of 4 gloo processes (``helpers/torch_world.py``, once for the
module) at dp4 = dcn2 x ici2, against the JAX package's
``quantized_allreduce`` / ``quantized_pmean`` in a ``shard_map`` over 4
of its 8 CPU devices and against its eager gradients of the global batch
and of each dcn group's half. The reference's own ``TestHierarchical
Quantized`` cannot run on this host (its partial-manual ``shard_map``
needs ``auto``, absent from this JAX: ROADMAP queue C), so the world is
held to what those tests assert and to a constructed oracle: each dcn
group's mean gradient passed through the JAX package's
``quantize_dequantize``, then averaged. The mp2 ``ParallelGPTBlock``
composition needs dcn2 x ici2 x mp2, a second world of 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu as jpaddle
import paddle_tpu.ops.pallas as jax_pallas
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.distributed import quantized_comm as jqc
from paddle_tpu.distributed.parallel import shard_batch
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.distributed import quantized_comm as qc
from helpers import torch_world as tw

import torch

WIDTHS = ("int8", "fp8")


def _block_absmax(a, block=128):
    """Each element's quantizer block's largest magnitude (``a``
    flattened, zero-padded to whole blocks of ``block``), at ``a``'s
    shape."""
    flat = np.asarray(a, np.float32).reshape(-1)
    n = flat.size
    nb = -(-n // block)
    m = np.abs(np.pad(flat, (0, nb * block - n))).reshape(nb, block).max(1)
    return np.repeat(m, block)[:n].reshape(np.shape(a))


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


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_quantize_dequantize_is_the_reference_bytes(width):
    """The boundary round trip, the blocks and scales the JAX package
    makes: bit for bit, at a size that pads the last block and with a
    zero block (scale 0, exact zeros)."""
    x = np.random.RandomState(0).randn(1000).astype(np.float32) * 5
    x[128:256] = 0
    got = qc.quantize_dequantize(torch.tensor(x), width, 128).numpy()
    want = np.asarray(jqc.quantize_dequantize(jnp.asarray(x), width, 128))
    np.testing.assert_array_equal(got, want)
    assert not got[128:256].any()
    assert qc.quantize_dequantize(torch.tensor(x).to(torch.bfloat16),
                                  width).dtype == torch.bfloat16
    # the error bound: half a step of each block (amax / qmax)
    if width == "int8":
        amax = np.abs(x.reshape(-1)[:896].reshape(7, 128)).max(1)
        err = np.abs(got[:896] - x[:896]).reshape(7, 128).max(1)
        assert (err <= amax / 127 / 2 + 1e-6).all()


def test_grad_comm_info_is_the_reference_record():
    """``grad_comm_info`` as the JAX package's, and priced per hop on a
    hierarchical mesh: ici at full width, dcn at the policy's."""
    for pol, fp16 in ((None, False), (None, True), (("int8", 128), False),
                      (("fp8", 64), False)):
        assert qc.grad_comm_info(10_000, pol, fp16_allreduce=fp16) == \
            jqc.grad_comm_info(10_000, pol, fp16_allreduce=fp16)
    rec = qc.grad_comm_info(1 << 20, ("int8", 128), hierarchical=True)
    assert rec["hops"] == {
        "ici": {"dtype": "float32", "bytes_on_wire": 4 << 20},
        "dcn": {"dtype": "int8",
                "bytes_on_wire": (1 << 20) + 4 * (1 << 13)}}
    assert rec["reduction_x"] == 3.88


# ---------------------------------------------------------------------------
# the boundary width policies on one process
# ---------------------------------------------------------------------------


def _jax_dense():
    class DenseNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(10, 16)
            self.fc2 = jnn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(jpaddle.nn.functional.relu(self.fc1(x)))

    return DenseNet()


def _strategy(pkg, policy):
    s = pkg.distributed.fleet.DistributedStrategy()
    if policy == "fp16":
        s.fp16_allreduce = True
    elif policy is not None:
        s.quantized_allreduce = policy
    return s


def _boundary_run(pkg, policy, init, eager, steps=5):
    """The JAX package's TestBoundaryPolicy program: SGD 0.1 on
    ``mean(net(x) ** 2)`` through fleet, eager ``step()`` or
    ``TrainStep``."""
    fleet = pkg.distributed.fleet
    s = _strategy(pkg, policy)
    fleet.init(is_collective=True, strategy=s)
    net = _jax_dense() if pkg is jpaddle else tw.dense_net()
    net.set_state_dict(init)
    opt = fleet.distributed_optimizer(pkg.optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()), strategy=s)
    x = np.random.RandomState(0).rand(8, 10).astype(np.float32)
    y = np.zeros((8, 4), np.float32)
    losses = []
    if eager:
        xt = pkg.to_tensor(x)
        for _ in range(steps):
            loss = (net(xt) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
    else:
        step = pkg.jit.TrainStep(net, lambda o, yy: (o ** 2).mean(), opt)
        losses = [float(np.asarray(step(x, y).numpy()))
                  for _ in range(steps)]
    _fresh_process_state()
    return losses, _sd(net)


@pytest.fixture(scope="module")
def dense_init():
    jpaddle.seed(7)
    return _sd(_jax_dense())


@pytest.mark.parametrize("policy", ["fp16", "int8", "fp8"])
@pytest.mark.parametrize("eager", [True, False], ids=["eager", "step"])
def test_boundary_policy_matches_the_reference(dense_init, policy, eager):
    """``fp16_allreduce`` (the bfloat16 round trip) and
    ``quantized_allreduce`` (one pass through the block quantizer) at the
    optimizer's boundary, eager and through ``TrainStep``: the JAX
    package's losses within 1e-6 and parameters within 1e-6 of their
    largest value, and not the float32 run's."""
    got = _boundary_run(pt, policy, dense_init, eager)
    want = _boundary_run(jpaddle, policy, dense_init, eager)
    wide = _boundary_run(pt, None, dense_init, eager)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k], v, rtol=0,
                                   atol=1e-6 * np.abs(v).max(), err_msg=k)
    assert any(not np.array_equal(got[1][k], wide[1][k]) for k in got[1])
    # the reference's own bound against float32: rtol 2e-2 / atol 1e-3
    np.testing.assert_allclose(got[0], wide[0], rtol=2e-2, atol=1e-3)


def test_quant_cast_is_block_width():
    """The reference's ``test_quant_cast_is_block_width``: the amax comes
    back exactly, another value lands on a code within half a step,
    non-float32 gradients pass, and no policy means no cast."""
    s = _strategy(pt, "int8")
    pt.distributed.fleet.init(is_collective=True, strategy=s)
    opt = pt.distributed.fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=1.0, parameters=tw.dense_net().parameters()))
    g = torch.ones(128)
    g[0], g[1] = 2.0, 1.0 + 2.0 ** -12
    out = opt._quant_cast(g)
    assert out.dtype == torch.float32 and float(out[0]) == 2.0
    assert float(out[1]) != 1.0 + 2.0 ** -12
    assert abs(float(out[1]) - (1.0 + 2.0 ** -12)) <= 2.0 / 127 / 2
    h = torch.tensor(3, dtype=torch.int32)
    assert opt._quant_cast(h) is h
    s2 = _strategy(pt, None)
    pt.distributed.fleet.init(is_collective=True, strategy=s2)
    opt2 = pt.distributed.fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=1.0, parameters=tw.dense_net().parameters()))
    assert opt2._comm_width_cast() is None
    _fresh_process_state()


# ---------------------------------------------------------------------------
# the strategy's checks (fleet.distributed_optimizer and TrainStep)
# ---------------------------------------------------------------------------


def _distributed_opt(pkg, opt_cls="Adam", **flags):
    fleet = pkg.distributed.fleet
    s = fleet.DistributedStrategy()
    for k, v in flags.items():
        setattr(s, k, v)
    fleet.init(is_collective=True, strategy=s)
    net = pkg.nn.Linear(8, 4)
    opt = getattr(pkg.optimizer, opt_cls)(learning_rate=1e-3,
                                          parameters=net.parameters())
    try:
        return fleet.distributed_optimizer(opt, strategy=s), s
    finally:
        _fresh_process_state()


@pytest.mark.parametrize("flags,error,match", [
    (dict(dgc=True, fp16_allreduce=True), ValueError, "dgc"),
    (dict(quantized_allreduce="int8", fp16_allreduce=True), ValueError,
     "one, not both"),
    (dict(quantized_allreduce="int4"), ValueError, "supported"),
    (dict(quantized_matmul="int9"), ValueError, "quantized_matmul"),
    (dict(quantized_moments="int9"), ValueError, "quantized_moments"),
    (dict(quantized_moments="int8", fp16_allreduce=True), ValueError,
     "fp16_allreduce"),
    (dict(quantized_moments="int8", opt_cls="SGD"), ValueError,
     "Adam-family"),
    (dict(quantized_moments="int8", lamb=True), ValueError,
     "Adam-family"),
], ids=["dgc_fp16", "two_widths", "width_typo", "matmul_typo",
        "moments_typo", "moments_fp16", "moments_sgd", "moments_lamb"])
def test_strategy_checks_raise_as_the_reference(flags, error, match):
    """Every check of ``distributed_optimizer``, by the meaning of its
    message, in both packages."""
    for pkg in (jpaddle, pt):
        with pytest.raises(error, match=match):
            _distributed_opt(pkg, **flags)


def test_dgc_routes_to_the_quantized_policy():
    for pkg in (jpaddle, pt):
        with pytest.warns(DeprecationWarning, match="dgc"):
            opt, s = _distributed_opt(pkg, dgc=True)
        assert s.quantized_allreduce == "int8"
        assert opt._comm_width_cast() is not None


def test_strategy_options_leave_not_ported():
    """Every strategy option is ported, ``elastic_reshard`` last (read by
    ``resharding.ElasticStep``): ``distributed_optimizer`` keeps it."""
    from paddle_tpu_torch.distributed.fleet import strategy as st

    assert st.NOT_PORTED == ()
    opt, s = _distributed_opt(pt, elastic_reshard="shrink")
    assert opt.user_defined_strategy.elastic_reshard == "shrink"
    _fresh_process_state()


def test_failed_step_leaves_the_boundary_policy_armed():
    """The reference's ``test_failed_ctor_leaves_boundary_policy_armed``:
    a TrainStep that elects the explicit dcn hop on a flat mesh raises
    before it disarms the optimizer's boundary round trip."""
    s = _strategy(pt, "int8")
    pt.distributed.fleet.init(is_collective=True, strategy=s)
    s.hierarchical_allreduce = True   # after init: no dcn axis
    net = tw.dense_net()
    opt = pt.distributed.fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()))
    with pytest.raises(ValueError, match="dcn axis"):
        pt.jit.TrainStep(net, lambda o, y: (o ** 2).mean(), opt)
    assert not opt._quant_explicit
    assert opt._comm_width_cast() is not None
    _fresh_process_state()


def test_tp_overlap_knob_raises(monkeypatch):
    """``PADDLE_TP_OVERLAP`` off changes nothing; on, it takes the ring:
    ``tp_overlap_enabled`` is True and the layers no longer raise; at mp 1
    they keep the plain form (``row_overlap_plan`` declines), and on an
    mp2 mesh the plan takes the ring for rows that split into two chunks
    and declines otherwise, and with sp above 1 (the rings at mp2 in a
    world: tests/test_torch_fleet_strategy.py)."""
    from types import SimpleNamespace

    from paddle_tpu_torch.distributed import (ColumnParallelLinear,
                                              RowParallelLinear, overlap)

    row, col = RowParallelLinear(8, 4), ColumnParallelLinear(8, 4)
    x = torch.ones(2, 8)
    monkeypatch.setenv("PADDLE_TP_OVERLAP", "0")
    assert overlap.tp_overlap_enabled() is False
    plain = (row(x), col(x))
    assert plain[0].shape == plain[1].shape == (2, 4)
    monkeypatch.setenv("PADDLE_TP_OVERLAP", "1")
    assert overlap.tp_overlap_enabled() is True
    for layer, want in zip((row, col), plain):
        torch.testing.assert_close(layer(x), want, rtol=0, atol=0)
    mesh = SimpleNamespace(shape={"dp": 2, "pp": 1, "sp": 1, "mp": 2})
    assert overlap.row_overlap_plan(None, 4) is None
    assert overlap.row_overlap_plan(mesh, 4) == (2, None)
    assert overlap.row_overlap_plan(mesh, 3) is None
    mesh.shape["sp"] = 2
    assert overlap.row_overlap_plan(mesh, 4) is None
    assert overlap.in_manual_dcn() is False


# ---------------------------------------------------------------------------
# the dcn2 x ici2 world
# ---------------------------------------------------------------------------


def _jax_grads(init, x, y):
    """The JAX package's gradients of the dense net's mean cross entropy
    over the rows ``x``, eager."""
    net = _jax_dense()
    net.set_state_dict(init)
    loss = jpaddle.nn.functional.cross_entropy(net(jpaddle.to_tensor(x)),
                                               jpaddle.to_tensor(y))
    loss.backward()
    return {n: p.grad.numpy() for n, p in net.named_parameters()}


def _world_refs():
    rng = np.random.RandomState(4)
    jpaddle.seed(21)
    x = {"dense_init": _sd(_jax_dense()),
         "dense_data": [(rng.rand(16, 10).astype(np.float32),
                         (np.arange(16) % 4).astype(np.int64))
                        for _ in range(3)],
         "qar": np.random.RandomState(6).randn(4, 300).astype(np.float32)}
    ref = {}
    devs = np.array(jax.devices()[:4])
    flat = Mesh(devs, ("w",))
    pair = Mesh(devs.reshape(2, 2), ("dcn", "ici"))

    def sm(fn, mesh, spec):
        return np.asarray(jax.jit(jax_comm.shard_map(
            fn, mesh, in_specs=spec, out_specs=spec))(jnp.asarray(x["qar"])))

    for dt in WIDTHS:
        ref[f"qar_world_{dt}"] = sm(
            lambda v, dt=dt: jqc.quantized_allreduce(v, "w", dtype=dt),
            flat, P("w"))
        ref[f"qar_dcn_{dt}"] = sm(
            lambda v, dt=dt: jqc.quantized_allreduce(v, "dcn", dtype=dt),
            pair, P(("dcn", "ici")))
    ref["qar_sum"] = sm(lambda v: jqc.quantized_allreduce(v, "w",
                                                          mean=False),
                        flat, P("w"))
    ref["pmean_dcn"] = sm(lambda v: jqc.quantized_pmean(v, "dcn"), pair,
                          P(("dcn", "ici")))
    # the first step's gradients: of the global batch, and of each dcn
    # group's half (ranks 0-1: rows 0-7; ranks 2-3: rows 8-15)
    bx, by = x["dense_data"][0]
    ref["grads"] = _jax_grads(x["dense_init"], bx, by)
    halves = [_jax_grads(x["dense_init"], bx[h], by[h])
              for h in (slice(0, 8), slice(8, 16))]
    ref["half_absmax"] = {
        k: np.maximum(*(_block_absmax(h[k]) for h in halves))
        for k in halves[0]}
    for dt in WIDTHS:
        ref[f"oracle_{dt}"] = {
            k: np.mean([np.asarray(jqc.quantize_dequantize(
                jnp.asarray(h[k]), dt, 128)) for h in halves], axis=0)
            for k in halves[0]}
    # one process on the global batch: Momentum 0.1 / 0.9, 3 steps
    net = _jax_dense()
    net.set_state_dict(x["dense_init"])
    step = JTrainStep(net, lambda o, yy: jpaddle.nn.functional
                      .cross_entropy(o, yy), joptim.Momentum(
                          learning_rate=0.1, momentum=0.9,
                          parameters=net.parameters()))
    ref["losses"] = [float(step(a, b).numpy()) for a, b in x["dense_data"]]
    ref["params"] = _sd(net)
    # the ParallelGPTBlock composition's reference: dp4 x mp2 flat
    jax_comm.init_hybrid_mesh(dp=4, mp=2)
    jpaddle.seed(33)
    blk = jpaddle.distributed.ParallelGPTBlock(16, 4, dropout=0.0)
    x["gpt_block"] = _sd(blk)
    data = np.random.RandomState(9)
    x["gpt_block_data"] = [(data.rand(8, 32, 16).astype(np.float32),
                            (np.arange(8) % 4).astype(np.int64))
                           for _ in range(2)]
    mesh = jax_comm.hybrid_mesh()
    for p in blk.parameters():
        if getattr(p, "_tp_spec", None) is None:
            p._data = jax.device_put(p._data, NamedSharding(mesh, P()))
    step = JTrainStep(blk, lambda o, yy: jpaddle.nn.functional
                      .cross_entropy(o.mean(axis=1), yy), joptim.Momentum(
                          learning_rate=0.05, momentum=0.9,
                          parameters=blk.parameters()))
    ref["gpt_block_losses"] = [
        float(step(shard_batch(a, mesh), shard_batch(b, mesh)).numpy())
        for a, b in x["gpt_block_data"]]
    _fresh_process_state()
    return x, ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    try:
        x, ref = _world_refs()
    finally:
        _fresh_process_state()
    out = tw.run_world(["hierarchical"],
                       str(tmp_path_factory.mktemp("world")), x)
    out.update(tw.run_world(["hier_gpt_block"],
                            str(tmp_path_factory.mktemp("world8")), x,
                            nprocs=8))
    yield x, ref, out


def test_hierarchical_mesh_groups(world):
    """dp4 = dcn2 x ici2, ici innermost: ici groups {0, 1} and {2, 3}, dcn
    groups {0, 2} and {1, 3}; ``dp_axes`` is the pair, ``dp_size`` 4."""
    for r, o in enumerate(world[2]["hierarchical"]):
        m = o["mesh"]
        assert m["axis_names"] == ("dcn", "ici", "pp", "sp", "mp")
        assert m["dp_axes"] == ("dcn", "ici") and m["dp_size"] == 4
        assert m["coords"] == {"dp": r, "dcn": r // 2, "ici": r % 2}
        assert m["groups"] == {"dp": [0, 1, 2, 3], "data": [0, 1, 2, 3],
                               "dcn": [r % 2, r % 2 + 2],
                               "ici": [r - r % 2, r - r % 2 + 1]}


def test_quantized_allreduce_matches_shard_map(world):
    """``quantized_allreduce`` (int8 and fp8 means over the world and over
    dcn, an int8 sum over the world) and ``quantized_pmean`` over dcn, on
    gloo, against the JAX package's in a ``shard_map``: within 1e-6 of the
    largest value (a sum of 2 or 4 float32 products, which XLA may
    contract into fused multiply-adds), and the same bytes on every rank
    of a group; a bfloat16 input comes back bfloat16."""
    _, ref, out = world
    for key in ("qar_world_int8", "qar_world_fp8", "qar_dcn_int8",
                "qar_dcn_fp8", "qar_sum", "pmean_dcn"):
        res = [o[key] for o in out["hierarchical"]]
        for r, got in enumerate(res):
            np.testing.assert_allclose(got, ref[key][r], rtol=0,
                                       atol=1e-6 * np.abs(ref[key]).max(),
                                       err_msg=f"{key} rank {r}")
        same = [(0, 1, 2, 3)] if "dcn" not in key else [(0, 2), (1, 3)]
        for grp in same:
            for r in grp[1:]:
                np.testing.assert_array_equal(res[r], res[grp[0]])
    assert all(o["bf16"] == "torch.bfloat16" for o in out["hierarchical"])


def test_explicit_dcn_path_engages(world):
    """The reference's ``test_explicit_dcn_path_engages``: quantized +
    hierarchical takes the per-gradient hop with and without
    ``async_dcn_allreduce``, and the boundary round trip stands down for
    the step's update only (the oracle tests hold that value to one
    rounding). The step leaves no state on the model or the optimizer: a
    ``DataParallel`` wrapper reused by a plain ``TrainStep`` and by an
    eager backward pass averages their gradients over the data group (the
    JAX package's global-batch gradients within 1e-5 of the largest),
    only its own hook stays on each parameter, and the optimizer's
    boundary cast is armed again."""
    _, ref, out = world
    for o in out["hierarchical"]:
        assert o["int8_tail"]["flags"] == (True, True, ("int8", 128),
                                           False, False)
        assert o["int8"]["flags"] == (True, True, ("int8", 128), False,
                                      False)
        assert o["off"]["flags"] == (True, True, None, False, True)
        assert o["flat_off"]["flags"] == (False, False, None, False, True)
        reuse = o["reuse"]
        assert reuse["flags"] == (False, False)
        assert reuse["hooks"] == [1] * len(reuse["hooks"])
        for run in ("plain", "eager"):
            for k, v in ref["grads"].items():
                np.testing.assert_allclose(reuse[run][k], v, rtol=0,
                                           atol=1e-5 * np.abs(v).max(),
                                           err_msg=f"{run} {k}")


@pytest.mark.parametrize("name", ["off", "flat_off"])
def test_full_width_hop_matches_one_process(world, name):
    """The dcn hop at full width (per gradient, and in the two-level
    buckets): first-step gradients within 1e-5 of the JAX package's on the
    global batch (a mean of means in another order), losses within 1e-5,
    the same on every rank."""
    _, ref, out = world
    for o in out["hierarchical"]:
        for k, v in ref["grads"].items():
            np.testing.assert_allclose(o[name]["grads"][k], v, rtol=0,
                                       atol=1e-5 * np.abs(v).max(),
                                       err_msg=k)
        np.testing.assert_allclose(o[name]["losses"], ref["losses"],
                                   rtol=1e-5)
        for k, v in ref["params"].items():
            np.testing.assert_allclose(o[name]["params"][k], v, rtol=0,
                                       atol=1e-5 * np.abs(v).max(),
                                       err_msg=k)


@pytest.mark.parametrize("name,width", [("int8", "int8"), ("fp8", "fp8"),
                                        ("int8_tail", "int8")])
def test_quantized_hop_matches_the_oracle(world, name, width):
    """The first-step gradients of the quantized dcn hop against the
    constructed oracle (each dcn group's mean gradient through the JAX
    package's ``quantize_dequantize``, averaged): each element within one
    step of its own block, the larger of the two groups' block scales (a
    code on a rounding boundary of the two packages' group means may land
    one step apart in either group; the average of the two is off by at
    most one step), plus 1e-6 relative, and not the full-width
    gradients."""
    _, ref, out = world
    qmax = 127.0 if width == "int8" else 448.0
    for o in out["hierarchical"]:
        for k, v in ref[f"oracle_{width}"].items():
            tol = ref["half_absmax"][k] / qmax + 1e-6 * np.abs(v).max()
            err = np.abs(o[name]["grads"][k] - v)
            assert (err <= tol).all(), \
                f"{k}: off by {(err / tol).max():.3f} of its bound"
        assert any(not np.allclose(o[name]["grads"][k], ref["grads"][k],
                                   rtol=0, atol=1e-7)
                   for k in ref["grads"])


@pytest.mark.parametrize("name,rtol,atol", [("int8", 2e-2, 1e-3),
                                            ("int8_tail", 2e-2, 1e-3),
                                            ("fp8", 5e-2, 5e-3)])
def test_loss_continuity_vs_full_width(world, name, rtol, atol):
    """The reference's loss-continuity gates (int8: rtol 2e-2 / atol
    1e-3, parameters too; fp8: 5e-2 / 5e-3): the quantized run tracks the
    full-width one and the JAX package's one-process run, and is not
    bitwise equal to the full-width one. (The reference also asserts that
    the loss falls in 3 steps; on this data the JAX package's own
    full-width run does not: 1.4082, 1.4402, 1.4240.)"""
    _, ref, out = world
    for o in out["hierarchical"]:
        q, f = o[name], o["off"]
        np.testing.assert_allclose(q["losses"], f["losses"], rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(q["losses"], ref["losses"], rtol=rtol,
                                   atol=atol)
        assert any(not np.array_equal(q["params"][k], f["params"][k])
                   for k in f["params"])
        if name != "fp8":
            for k in f["params"]:
                np.testing.assert_allclose(q["params"][k], f["params"][k],
                                           rtol=rtol, atol=atol, err_msg=k)


def test_policy_off_is_reproducible_bit_for_bit(world):
    for o in world[2]["hierarchical"]:
        a, b = o["flat_off"], o["flat_off2"]
        assert a["losses"] == b["losses"]
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])


def test_hop_bytes_by_group(world):
    """The comm monitor's bytes by group: the int8 dcn hop moves each
    gradient's payload and scales (``n + 4 ceil(n / 128)`` bytes; 3.7x
    below float32 for these gradients, 3.88x at GPT sizes), the ici hop
    the same float32 bytes either way."""
    sizes = (160, 16, 64, 4)
    wire = sum(n + 4 * -(-n // 128) for n in sizes)
    for o in world[2]["hierarchical"]:
        def hop(run, op, group):
            rows = [c for c in o[run]["counts"]
                    if c["op"] == op and c["group"] == group]
            assert all(c["backend"] == "gloo" and c["transport"] ==
                       "gloo-cpu" for c in rows)
            return sum(c["bytes"] for c in rows), sum(c["calls"]
                                                      for c in rows)

        assert hop("int8", "quantized_allreduce", "dcn") == (3 * wire, 12)
        assert hop("off", "all_reduce", "dcn") == (3 * 4 * sum(sizes), 12)
        assert hop("off", "all_reduce", "ici") == \
            hop("int8", "all_reduce", "ici") == (3 * 4 * sum(sizes), 12)
        assert 4 * sum(sizes) / wire >= 3.5
        assert o["int8"]["grad_comm"]["hops"]["dcn"]["dtype"] == "int8"


def test_refusals_of_the_explicit_hop(world):
    """``async_dcn_allreduce`` without ``hierarchical_allreduce`` and the
    explicit hop under float16 dynamic loss scaling raise, as in the JAX
    package."""
    for o in world[2]["hierarchical"]:
        e = o["errors"]
        assert e["async_flat"].startswith("ValueError") \
            and "requires hierarchical_allreduce" in e["async_flat"]
        assert e["fp16_scaling"].startswith("NotImplementedError") \
            and "fp16 dynamic loss" in e["fp16_scaling"]


def test_composes_with_parallel_gpt_block(world):
    """The reference's dcn2 x ici2 x mp2 ``ParallelGPTBlock`` composition
    (a world of 8): the int8 hop's losses within rtol 2e-2 / atol 1e-3 of
    the full-width hop's, which are the JAX package's flat dp4 x mp2
    run's within 1e-5, the same on every rank."""
    _, ref, out = world
    for o in out["hier_gpt_block"]:
        np.testing.assert_allclose(o["int8"], o["off"], rtol=2e-2,
                                   atol=1e-3)
        np.testing.assert_allclose(o["off"], ref["gpt_block_losses"],
                                   rtol=1e-5)
        assert o == out["hier_gpt_block"][0]
