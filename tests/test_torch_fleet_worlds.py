"""The strategy's optimizer options across ranks: one world of 8 gloo
processes of the port (``helpers/torch_world.py``, started once for the
module) against the JAX package on its 8 CPU devices, on the same numpy
weights and global batches.

- ZeRO stages 1, 2 and 3 at dp8 (and stage 2 under the ``lamb`` swap, and
  with ``ClipGradByNorm``) on ``test_sharding_gm``'s ``_Net`` with an L2
  weight decay (Adam's) and a global-norm clip (or the per-tensor one),
  against the JAX package's unsharded ``TrainStep``:
  losses within 1e-5 relative, the parameters within rtol 1e-5 / atol 1e-6
  (``test_sharding_gm``'s bounds); Adam's moment bytes on a rank an eighth
  of the unsharded ones (the parameters too at stage 3).
- Stage 3 on ``Embedding(30522, 10)``, whose axes 8 does not divide: the
  rows padded to 30528, an eighth held a rank; ``state_dict()`` at its
  logical shape, a shard refused by ``set_state_dict``, the checkpoint
  restored, and a third step, all the JAX package's.
- ``lars`` swapping Momentum at dp4 x mp2 (column- and row-parallel
  layers), unsharded and with ZeRO stage 2: the JAX package's run, whose
  trust ratios take the full tensors' norms.
- The overlap rings at dp4 x mp2: ``ColumnParallelLinear`` into
  ``RowParallelLinear`` with ``PADDLE_TP_OVERLAP`` on takes both rings and
  gives the plain layers' output and gradients within 1e-5 relative, and
  those of the JAX package's ``column_gather_overlap`` /
  ``row_parallel_overlap``.
- C8: ``train_batch`` at pp2 x dp4 through a fleet optimizer with
  ``fp16_allreduce``: the JAX package's pipeline under the same strategy.
- A GPT at dp4 x mp2 under ``lamb`` (swapping AdamW) with ZeRO-3, the
  rings and ``recompute`` on, and with all three off: each against the
  JAX package's run at dp4 x mp2 under ``lamb``, and against each other,
  within 1e-5 (the key bias, whose gradient is rounding, within Lamb's
  step); the
  parameters held between steps a quarter of the mp shard's bytes; each
  block's forward twice a step.
- ``__graft_entry__.py``'s GPT at dp2 x pp2 x mp2 (D 16, H 4, 2 blocks and
  a head) with ZeRO-1 and ``gradient_merge`` k 2 over Adam, 1F1B over 2
  microbatches, four ``train_batch`` calls (two merge boundaries): the
  losses and each stage's parameters, gathered over mp, within rtol 1e-5 /
  atol 1e-6; Adam's moment bytes on a rank half the stage's.
- Its dcn4 x ici2 mesh with ZeRO-1 over Adam through ``TrainStep`` (and
  stages 2 and 3, whose gradients are reduce-scattered over the dcn hop,
  then the ici hop): three steps, losses and parameters within the same
  bounds.
- LocalSGD over SGD on ``Linear(3, 1)`` at dp8 (``test_strategy_flags``'
  program): k 1 gives ``DataParallel`` SGD's losses and weights within
  1e-6; k 2 gives the JAX package's ``LocalSGDStep`` losses and averaged
  weights, the ranks' weights differ after an odd step and are equal bit
  for bit after an even one, and ``state_dict()`` averages first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.distributed import ParallelGPTBlock as JBlock
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import overlap as jov
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed.fleet import base as jfleet_base
from paddle_tpu.jit import TrainStep as JTrainStep

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from helpers import torch_world as tw
from test_torch_fleet_strategy import (REL, _JNet, _ce, _data,
                                       _fresh_process_state, _near, _sd,
                                       _strategy)
from test_torch_tensor_parallel import _jax_gpt, _jax_lm_loss

WORLD = 8
D, H = 16, 4
#: name, stage, the lamb swap, the clip (global norm or per tensor)
ZERO_CASES = (("s1", 1, False, "global"), ("s2", 2, False, "global"),
              ("s3", 3, False, "global"), ("s2_lamb", 2, True, "global"),
              ("s2_clipnorm", 2, False, "norm"))
ZERO_LR, ZERO_CLIP, ZERO_WD = 0.01, 0.1, 0.01
EMB_SHAPE = (30522, 10)
PP_CFG, PP_BATCH, PP_T, PP_MICRO, PP_LR = (16, 2, 10), 8, 6, 2, 0.05
GPT_CFG = (64, 16, 4, 2, 8)    # vocab, d, heads, layers, seq
GPT_LR, GPT_STEPS = 1e-2, 2
#: lars: a coefficient that makes each step a few percent of the weights'
#: norm, so that a trust ratio taken over a shard shows
LARS_CFG, LARS_LR = {"lars_coeff": 0.5}, 0.1


def _jax_fleet(**flags):
    s = jfleet.DistributedStrategy()
    for k, v in flags.items():
        setattr(s, k, v)
    jfleet.init(is_collective=True, strategy=s)
    return s


def _jax_unsharded(init, data, make_opt):
    m = _JNet()
    m.set_state_dict(init)
    step = JTrainStep(m, _ce(jpaddle), make_opt(m))
    losses = [float(step(x, y).numpy()) for x, y in data]
    return {"losses": losses, "params": _sd(m)}


def _zero_ref(lamb, clip):
    """The reference of a ZeRO case: its key in ``ref``."""
    return ("lamb" if lamb else "adam") + ("_clipnorm" if clip == "norm"
                                           else "")


def _zero_refs(x, ref):
    """ZeRO's programs, unsharded, on the global batches."""
    jpaddle.seed(2)
    x["zero_init"] = init = _sd(_JNet())
    x.update(zero_cases=ZERO_CASES, zero_lr=ZERO_LR, zero_clip=ZERO_CLIP,
             zero_wd=ZERO_WD, zero_data=_data(3, seed=9))
    clip = lambda: jpaddle.nn.ClipGradByGlobalNorm(ZERO_CLIP)  # noqa: E731
    ref["adam"] = _jax_unsharded(init, x["zero_data"], lambda m: joptim.Adam(
        learning_rate=ZERO_LR, parameters=m.parameters(),
        weight_decay=ZERO_WD, grad_clip=clip()))
    ref["lamb"] = _jax_unsharded(init, x["zero_data"], lambda m: joptim.Lamb(
        learning_rate=ZERO_LR, lamb_weight_decay=0.01,
        parameters=m.parameters(), grad_clip=clip()))
    ref["adam_clipnorm"] = _jax_unsharded(
        init, x["zero_data"], lambda m: joptim.Adam(
            learning_rate=ZERO_LR, parameters=m.parameters(),
            weight_decay=ZERO_WD,
            grad_clip=jpaddle.nn.ClipGradByNorm(ZERO_CLIP)))
    # stage 3 on an embedding with no axis that 8 divides
    jpaddle.seed(3)
    emb = jnn.Embedding(*EMB_SHAPE)
    x.update(emb_shape=EMB_SHAPE, emb_init=_sd(emb),
             emb_ids=(np.arange(16) % EMB_SHAPE[0]).astype(np.int64))
    opt = joptim.Adam(learning_rate=0.1, parameters=emb.parameters())
    step = JTrainStep(emb, lambda o, y: (o ** 2).mean(), opt)
    losses = [float(step(x["emb_ids"], x["emb_ids"]).numpy())
              for _ in range(2)]
    m1 = [np.asarray(v.numpy()) for k, v in opt.state_dict().items()
          if k.endswith(".moment1")][0]
    losses.append(float(step(x["emb_ids"], x["emb_ids"]).numpy()))
    ref["emb"] = {"losses": losses, "moment1": m1,
                  "weight": _sd(emb)["weight"]}


def _ring_refs(x, ref, rng):
    """The rings at dp4 x mp2: the JAX package's functions, jitted."""
    f = np.float32
    R, IN, HID = 8, 16, 24
    x.update(ring_col=(IN, HID), ring_row=(HID, IN),
             ring_x=(rng.rand(R, IN) - 0.5).astype(f))
    ring_w = {"0.weight": (rng.rand(IN, HID) - 0.5).astype(f),
              "0.bias": rng.rand(HID).astype(f),
              "1.weight": (rng.rand(HID, IN) - 0.5).astype(f),
              "1.bias": rng.rand(IN).astype(f)}
    x["ring_init"] = ring_w
    mesh = jax_comm.init_hybrid_mesh(dp=WORLD // 2, mp=2)
    mp, row_ax = jov.row_overlap_plan(mesh, R)

    def ring(xx, wc, bc, wr, br):
        h = jov.column_gather_overlap(xx, wc, bc, mesh, mp, row_ax)
        return jov.row_parallel_overlap(h, wr, br, mesh, mp, row_ax)

    args = [jnp.asarray(a) for a in (x["ring_x"], ring_w["0.weight"],
                                     ring_w["0.bias"], ring_w["1.weight"],
                                     ring_w["1.bias"])]
    out = jax.jit(ring)(*args)
    grads = jax.jit(jax.grad(lambda *a: (ring(*a) ** 2).sum(),
                             tuple(range(5))))(*args)
    ref["rings"] = {"out": np.asarray(out),
                    **{n: np.asarray(g) for n, g in zip(
                        ("gx", "col_w", "col_b", "row_w", "row_b"), grads)}}
    _fresh_process_state()


def _lars_refs(x, ref):
    """``lars`` swapping Momentum at dp4 x mp2 in the JAX package."""
    _jax_fleet(lars=True, lars_configs=LARS_CFG,
               hybrid_configs={"dp_degree": WORLD // 2, "mp_degree": 2})
    jpaddle.seed(6)

    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.col = jdist.ColumnParallelLinear(16, 24,
                                                  gather_output=False)
            self.row = jdist.RowParallelLinear(24, 8, input_is_parallel=True)

        def forward(self, v):
            return self.row(jpaddle.nn.functional.relu(self.col(v)))

    net = MLP()
    x.update(lars_init=_sd(net), lars_configs=LARS_CFG, lars_lr=LARS_LR)
    model = jfleet.distributed_model(net)
    opt = jfleet.distributed_optimizer(joptim.Momentum(
        learning_rate=LARS_LR, momentum=0.9, parameters=net.parameters()))
    step = JTrainStep(model, _ce(jpaddle), opt)
    ref["lars_mp"] = {
        "inner": type(opt._inner).__name__,
        "losses": [float(step(model.shard_input(a),
                              model.shard_input(b)).numpy())
                   for a, b in x["zero_data"]],
        "params": _sd(net)}
    _fresh_process_state()


def _strategy_gpt_refs(x, ref, rng):
    """The strategy GPT's program in the JAX package: dp4 x mp2, ``lamb``
    swapping AdamW (ZeRO, the rings and recompute leave its numbers as
    they are, so the port's runs with them on and off both answer to
    it)."""
    pt.seed(4)
    x.update(gpt_cfg=GPT_CFG, gpt_init=_sd(tw.gpt(*GPT_CFG)),
             gpt_lr=GPT_LR)
    ids = rng.randint(0, GPT_CFG[0], (4, GPT_CFG[4])).astype(np.int64)
    x["gpt_batch"] = (ids, np.roll(ids, -1, axis=1))
    _jax_fleet(lamb=True,
               hybrid_configs={"dp_degree": WORLD // 2, "mp_degree": 2})
    gpt = _jax_gpt(*GPT_CFG)
    gpt.set_state_dict(x["gpt_init"])
    model = jfleet.distributed_model(gpt)
    opt = jfleet.distributed_optimizer(joptim.AdamW(
        learning_rate=GPT_LR, weight_decay=0.01,
        parameters=gpt.parameters()))
    step = JTrainStep(model, _jax_lm_loss(gpt), opt)
    a, b = (model.shard_input(v) for v in x["gpt_batch"])
    ref["strategy_gpt"] = {
        "inner": type(opt._inner).__name__,
        "losses": [float(step(a, b).numpy()) for _ in range(GPT_STEPS)],
        "params": _sd(gpt)}
    _fresh_process_state()


def _c8_refs(x, ref, rng):
    """C8: the JAX package's pipeline through its fleet wrapper."""
    f = np.float32
    xs = [rng.randn(PP_BATCH, PP_T, PP_CFG[0]).astype(f) for _ in range(2)]
    ys = [rng.randint(0, PP_CFG[2], (PP_BATCH,)).astype(np.int64)
          for _ in range(2)]
    x.update(pp_cfg=PP_CFG, pp_micro=PP_MICRO, pp_lr=PP_LR, pp_x=xs,
             pp_y=ys)
    mesh = jax_comm.init_hybrid_mesh(dp=WORLD // 2, pp=2)
    layer = jpipe.PipelineLayer(
        [JBlock(PP_CFG[0], PP_CFG[1], dropout=0.0),
         JBlock(PP_CFG[0], PP_CFG[1], dropout=0.0),
         jnn.Linear(PP_CFG[0], PP_CFG[2])],
        loss_fn=lambda o, t: jpaddle.nn.functional.cross_entropy(
            o.mean(axis=1), t))
    x["pp_init"] = _sd(layer)
    model = jpipe.PipelineParallel(layer, mesh=mesh,
                                   accumulate_steps=PP_MICRO)
    jopt = jfleet_base._DistributedOptimizer(
        joptim.Momentum(learning_rate=PP_LR, momentum=0.9,
                        parameters=model.parameters()),
        _strategy(jpaddle, fp16_allreduce=True))
    ref["c8"] = {"losses": [float(model.train_batch([a, b], jopt).numpy())
                            for a, b in zip(xs, ys)],
                 "params": _sd(layer)}
    _fresh_process_state()


def _graft_refs(x, ref, rng):
    """``__graft_entry__.py:145-200``'s two ZeRO compositions."""
    f = np.float32
    _jax_fleet(pipeline=True, pipeline_configs={"accumulate_steps": 2},
               sharding=True, sharding_configs={"stage": 1},
               gradient_merge=True,
               gradient_merge_configs={"k_steps": 2, "avg": True},
               hybrid_configs={"dp_degree": 2, "pp_degree": 2,
                               "mp_degree": 2})
    jpaddle.seed(0)
    layer = jpipe.PipelineLayer(
        [JBlock(D, H, dropout=0.0) for _ in range(2)] + [jnn.Linear(D, 10)],
        loss_fn=lambda out, y: jpaddle.nn.functional.cross_entropy(
            out.mean(axis=1), y))
    x.update(graft_dh=(D, H), graft_init=_sd(layer),
             graft_x=rng.rand(8, 4, D).astype(f),
             graft_y=(np.arange(8) % 10).astype(np.int64))
    gpt = jfleet.distributed_model(layer)
    gopt = jfleet.distributed_optimizer(joptim.Adam(
        learning_rate=1e-3, parameters=gpt.parameters()))
    ref["graft_gpt"] = {
        "losses": [float(gpt.train_batch([x["graft_x"], x["graft_y"]],
                                         gopt).numpy()) for _ in range(4)],
        "params": _sd(layer)}
    _fresh_process_state()
    _jax_fleet(hierarchical_allreduce=True,
               hierarchical_allreduce_inter_nranks=2, sharding=True,
               sharding_configs={"stage": 1})
    jpaddle.seed(1)
    net = jnn.Sequential(jnn.Linear(32, 64), jnn.ReLU(), jnn.Linear(64, 10))
    x.update(hier_init=_sd(net), hier_x=rng.rand(16, 32).astype(f),
             hier_y=(np.arange(16) % 10).astype(np.int64))
    model = jfleet.distributed_model(net)
    step = JTrainStep(model, _ce(jpaddle), jfleet.distributed_optimizer(
        joptim.Adam(learning_rate=1e-3, parameters=net.parameters())))
    xs, ys = model.shard_input(x["hier_x"]), model.shard_input(x["hier_y"])
    ref["graft_hier"] = {
        "losses": [float(step(xs, ys).numpy()) for _ in range(3)],
        "params": _sd(net)}
    _fresh_process_state()


def _localsgd_refs(x, ref, rng):
    """LocalSGD k 2 (``test_strategy_flags``' program)."""
    f = np.float32
    xs = [rng.rand(16, 3).astype(f) for _ in range(4)]
    ys = [rng.rand(16, 1).astype(f) for _ in range(4)]
    jpaddle.seed(5)
    lin = jnn.Linear(3, 1)
    x.update(ls_x=xs, ls_y=ys, ls_init=_sd(lin))
    _jax_fleet(localsgd=True, localsgd_configs={"k_steps": 2})
    step = JTrainStep(lin, lambda o, y: ((o - y) * (o - y)).mean(),
                      jfleet.distributed_optimizer(joptim.SGD(
                          learning_rate=0.1, parameters=lin.parameters())))
    losses = [float(step(a, b).numpy()) for a, b in zip(xs, ys)]
    step._delegate.sync_to_model()
    ref["localsgd"] = {"losses": losses, "w": _sd(lin)["weight"]}
    _fresh_process_state()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    rng = np.random.RandomState(0)
    x, ref = {}, {}
    try:
        _zero_refs(x, ref)
        _ring_refs(x, ref, rng)
        _c8_refs(x, ref, rng)
        _graft_refs(x, ref, rng)
        _localsgd_refs(x, ref, rng)
        _lars_refs(x, ref)
        _strategy_gpt_refs(x, ref, rng)
    finally:
        _fresh_process_state()
    tmp = str(tmp_path_factory.mktemp("world"))
    out = tw.run_world(["zero", "zero_embedding", "rings", "c8_pipeline",
                        "lars_mp", "strategy_gpt", "graft_gpt",
                        "graft_hier", "localsgd"], tmp, x, nprocs=WORLD)
    yield x, ref, out
    pt_device._current = saved
    _fresh_process_state()


# -- ZeRO ---------------------------------------------------------------------

@pytest.mark.parametrize("name", [c[0] for c in ZERO_CASES])
def test_zero_stages_match_unsharded(world, name):
    x, ref, out = world
    _, _, lamb, clip = [c for c in ZERO_CASES if c[0] == name][0]
    want = ref[_zero_ref(lamb, clip)]
    for r, o in enumerate(out["zero"]):
        got = o[name]
        assert got["inner"] == ("Lamb" if lamb else "Adam")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL,
                                   err_msg=f"rank {r}")
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} rank {r}")


def test_zero_bytes_per_rank(world):
    """Adam's moments: an eighth of the unsharded bytes on each rank at
    every stage (every leaf of ``_Net`` has an axis 8 divides); the
    parameters: all of them at stages 1 and 2, an eighth at stage 3."""
    x, _, out = world
    full = sum(v.size * 4 for v in x["zero_init"].values())
    for r, o in enumerate(out["zero"]):
        for name, stage, _, _ in ZERO_CASES:
            got = o[name]
            assert got["moment_bytes"] == 2 * full // WORLD, (name, r)
            assert got["param_bytes"] == (full // WORLD if stage == 3
                                          else full), (name, r)
        assert o["s3"]["shapes"]["fc1.weight"] == (16 // WORLD, 24)


def test_zero3_padded_embedding_checkpoints_at_logical_shape(world):
    _, ref, out = world
    want = ref["emb"]
    rows = -(-EMB_SHAPE[0] // WORLD)
    for r, o in enumerate(out["zero_embedding"]):
        assert o["stored"] == o["restored"] == (rows, EMB_SHAPE[1])
        assert o["shard_refused"]
        assert o["param_bytes"] == rows * EMB_SHAPE[1] * 4
        assert tuple(o["ckpt_shape"]) == EMB_SHAPE
        assert all(tuple(s) == EMB_SHAPE for s in o["moment_shapes"].values())
        # the losses are means of squares that the updates shrink (the
        # third is 6e-4): a weight within its atol 1e-6 moves one by up
        # to 2 * max|w| (~0.05) * 1e-6
        np.testing.assert_allclose(o["losses"], want["losses"], rtol=REL,
                                   atol=1e-7)
        np.testing.assert_allclose(o["moment1"], want["moment1"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(o["weight"], want["weight"], rtol=1e-5,
                                   atol=1e-6)


# -- the rings, C8, the strategy GPT ---------------------------------------------

def test_rings_match_plain_layers(world):
    for r, o in enumerate(world[2]["rings"]):
        assert sorted(set(o["calls"])) == [
            ("1", "column_gather_overlap"), ("1", "row_parallel_overlap")]
        on, off = o["1"], o["0"]
        _near(on["out"], off["out"], REL, f"out rank {r}")
        _near(on["gx"], off["gx"], REL, f"gx rank {r}")
        for k in off["grads"]:
            _near(on["grads"][k], off["grads"][k], REL, f"{k} rank {r}")


def test_rings_match_reference(world):
    _, ref, out = world
    want = ref["rings"]
    for r, o in enumerate(out["rings"]):
        a, b = o["rows"]
        got = o["1"]
        _near(got["out"], want["out"][a:b], REL, f"out rank {r}")
        _near(got["gx"], want["gx"][a:b], REL, f"gx rank {r}")
        for k, v in got["grads"].items():
            _near(v, want[k], REL, f"{k} rank {r}")


def test_c8_pipeline_takes_the_wrapper_rule(world):
    _, ref, out = world
    want = ref["c8"]
    for r, o in enumerate(out["c8_pipeline"]):
        np.testing.assert_allclose(o["losses"], want["losses"], rtol=REL,
                                   err_msg=f"rank {r}")
        assert o["params"]
        for k, v in o["params"].items():
            _near(v, want["params"][k], REL, f"{k} rank {r}")


def _gpt_params_near(got, want, init, what):
    """The GPT's parameters within 1e-5 of each one's largest, but for the
    key bias (the middle third of each ``qkv.bias``), whose gradient is 0
    but for rounding (softmax is unchanged by a constant added to a row's
    scores), so that Lamb steps it by rounding: it is held to Lamb's step
    in both runs (from a zero bias the trust ratio is 1 and each element
    moves by at most lr; later steps move the bias by lr times its
    norm)."""
    d = GPT_CFG[1]
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k]
        if k.endswith("attn.qkv.bias"):
            kb = slice(d, 2 * d)
            bound = GPT_STEPS * GPT_LR * max(
                1.0, np.linalg.norm(init[k])) * 1.01
            for run in (g, v):
                assert np.abs(run[kb] - init[k][kb]).max() <= bound, k
            g, v = np.delete(g, np.r_[kb]), np.delete(v, np.r_[kb])
        _near(g, v, REL, f"{k} {what}")


def test_strategy_gpt_matches_all_off(world):
    """ZeRO-3, the rings and recompute change no number the step gives:
    losses and parameters within 1e-5 of the run with all three off."""
    x = world[0]
    for r, o in enumerate(world[2]["strategy_gpt"]):
        on, off = o["on"], o["off"]
        assert on["inner"] == off["inner"] == "Lamb"
        np.testing.assert_allclose(on["losses"], off["losses"], rtol=REL)
        _gpt_params_near(on["params"], off["params"], x["gpt_init"],
                         f"rank {r}")


@pytest.mark.parametrize("run", ["on", "off"])
def test_strategy_gpt_matches_reference(world, run):
    """The port's GPT at dp4 x mp2 under ``lamb``, with the options on and
    off, against the JAX package's run: Lamb's trust ratios take the norms
    of the full tensors there, so an mp shard's norm taken alone, or a
    ZeRO shard's, shows here."""
    x, ref, out = world
    want = ref["strategy_gpt"]
    assert want["inner"] == "Lamb"
    for r, o in enumerate(out["strategy_gpt"]):
        got = o[run]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL,
                                   err_msg=f"rank {r}")
        _gpt_params_near(got["params"], want["params"], x["gpt_init"],
                         f"{run} rank {r}")


@pytest.mark.parametrize("stage", [0, 2])
def test_lars_mp_matches_reference(world, stage):
    """``lars`` at dp4 x mp2, unsharded and under ZeRO-2 (every parameter
    sharded over dp too), against the JAX package's run: losses and the
    full parameters within rtol 1e-5 / atol 1e-6."""
    _, ref, out = world
    want = ref["lars_mp"]
    assert want["inner"] == "Lars"
    for r, res in enumerate(out["lars_mp"]):
        o = res[stage]
        assert o["inner"] == "Lars"
        assert o["sharded"] == (4 if stage else 0), r
        np.testing.assert_allclose(o["losses"], want["losses"], rtol=REL,
                                   err_msg=f"rank {r}")
        for k, v in want["params"].items():
            np.testing.assert_allclose(o["params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} rank {r}")


def test_strategy_gpt_memory_and_recompute(world):
    """Between steps a rank holds a quarter (dp4) of its mp shard's
    parameter bytes; each block's forward runs twice a step
    (recompute)."""
    layers = GPT_CFG[3]
    for r, o in enumerate(world[2]["strategy_gpt"]):
        assert WORLD // 2 * o["on"]["param_bytes"] == \
            o["off"]["param_bytes"], r
        assert o["on"]["forwards"] == 2 * 2 * layers
        assert o["off"]["forwards"] == 2 * layers


# -- __graft_entry__.py's compositions --------------------------------------------

def test_graft_gpt_zero1_gradient_merge(world):
    """Losses and parameters, but for the key bias (the middle third of
    each ``qkv.bias``): softmax is unchanged when one constant is added to
    every score of a row, so that bias's gradient is 0 but for rounding,
    and Adam turns rounding of either sign into a step of up to the rate.
    It is held to that: within 2 applied updates of lr 1e-3 of its start
    in both packages."""
    x, ref, out = world
    want = ref["graft_gpt"]
    stages = set()
    lr, applied = 1e-3, 2
    for r, o in enumerate(out["graft_gpt"]):
        stages.add(o["stage"])
        np.testing.assert_allclose(o["losses"], want["losses"], rtol=1e-5,
                                   err_msg=f"rank {r}")
        assert o["params"]
        for k, v in o["params"].items():
            w = want["params"][k]
            if k.endswith("attn.qkv.bias"):
                kb = slice(D, 2 * D)
                for got in (v, w):
                    drift = np.abs(got[kb] - x["graft_init"][k][kb]).max()
                    assert drift <= lr * applied * (1 + 1e-3), (k, drift)
                v, w = np.delete(v, np.r_[kb]), np.delete(w, np.r_[kb])
            np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} rank {r}")
    assert stages == {0, 1}


def test_graft_gpt_moment_bytes(world):
    """ZeRO-1 over each stage's dp2 group: a rank's moments are half its
    stage's unsharded ones (every leaf has an axis 2 divides)."""
    for r, o in enumerate(world[2]["graft_gpt"]):
        assert o["moment_bytes"] == 2 * o["stage_bytes"] // 2, r


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_graft_hierarchical_zero(world, stage):
    """The dryrun's stage 1, and stages 2 and 3 (the gradients
    reduce-scattered over both hops), against the JAX package's run."""
    _, ref, out = world
    want = ref["graft_hier"]
    for r, res in enumerate(out["graft_hier"]):
        o = res[stage]
        assert tuple(o["axes"])[:2] == ("dcn", "ici")
        np.testing.assert_allclose(o["losses"], want["losses"], rtol=1e-5,
                                   err_msg=f"rank {r}")
        for k, v in want["params"].items():
            np.testing.assert_allclose(o["params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} rank {r}")
        full = sum(v.size * 4 for v in want["params"].values())
        # the 10-wide bias (no axis 8 divides, < 1024) stays replicated
        assert o["moment_bytes"] == 2 * ((full - 40) // 8 + 40), r


# -- LocalSGD --------------------------------------------------------------------

def test_localsgd_k1_equals_data_parallel(world):
    for r, o in enumerate(world[2]["localsgd"]):
        np.testing.assert_allclose(o[1]["losses"], o["dp_losses"],
                                   rtol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(o[1]["w"][-1], o["dp_w"], rtol=1e-6,
                                   atol=1e-7, err_msg=f"rank {r}")


def test_localsgd_k2_matches_reference(world):
    _, ref, out = world
    want = ref["localsgd"]
    res = out["localsgd"]
    for r, o in enumerate(res):
        np.testing.assert_allclose(o[2]["losses"], want["losses"],
                                   rtol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(o[2]["state_w"], want["w"], rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")
    for i in range(len(want["losses"])):
        ws = [o[2]["w"][i] for o in res]
        same = all(np.array_equal(w, ws[0]) for w in ws)
        assert same == (i % 2 == 1), f"step {i + 1}"
