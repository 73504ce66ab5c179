"""The pipeline and the mixture-of-experts layer: the port (4 gloo
processes, ``helpers/torch_world.py``, started once for the module) against
the JAX package (its meshes on 4 of its 8 CPU devices).

- The schedules: ``_1f1b_order`` and ``_f_then_b_order`` equal the JAX
  package's for S <= 4 stages and M <= 8 microbatches, and ``segment``
  cuts as it does (uniform and by parameter count).
- ``PipelineParallel.train_batch`` through fleet, a rank a stage: two
  ``ParallelGPTBlock``s (d 16, 2 heads) and a head, 2 Momentum steps of 2
  microbatches, at pp2 (x dp2) in 1F1B and F-then-B and at pp2 x mp2,
  against the JAX package's ``PipelineParallel`` on the same mesh: losses
  within 1e-5 relative (the same on every rank), each stage's parameters
  (gathered over mp) within 1e-5 of each largest; the inference forward
  within 1e-5 of the largest output.
- ``_top2_dispatch`` against the JAX package's on gates with a tie and an
  overflowing expert: the dispatch, combine and first-choice masks
  exactly, the combine's gradient within 1e-6; ``moe_dispatch_combine``.
- ``ExpertParallelMoE`` at ep1 (this process) and ep4 (mp4 in the world,
  2 of 8 experts a rank) against the JAX layer on the same weights: out,
  aux and the gradients of x, gate, wi and wo (gathered) within 1e-5 of
  each largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.ops.pallas as jax_pallas
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.incubate import moe as jmoe
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.distributed import pipeline as tpipe
from paddle_tpu_torch.incubate import moe as tmoe
from helpers import torch_world as tw

#: the pipeline's blocks: d, heads, classes; batch, positions; microbatches
PP_CFG = (16, 2, 10)
PP_BATCH, PP_T, PP_MICRO, PP_STEPS = 8, 6, 2, 2
PP_LR = 0.05
#: MoE: d_model, d_hidden, experts; x [B, S, d]
MOE_CFG = (16, 32, 8)
MOE_X = (2, 8, 16)
MOE_AUX_W = 0.5
REL = 1e-5


def _fresh_process_state():
    jax_comm._state.hybrid_mesh = pt_comm._mesh = None
    jax_pallas.flash_attention = jax_fa


def _sd(layer):
    return {k: np.asarray(v.numpy()).copy()
            for k, v in layer.state_dict().items()}


def _near(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _jax_blocks(d, heads, classes):
    from paddle_tpu import nn
    from paddle_tpu.distributed import ParallelGPTBlock

    return [ParallelGPTBlock(d, heads, dropout=0.0),
            ParallelGPTBlock(d, heads, dropout=0.0), nn.Linear(d, classes)]


def _jax_loss(out, y):
    return jpaddle.nn.functional.cross_entropy(out.mean(axis=1), y)


def _jax_pipeline(init, xs, ys, mode, **degrees):
    """The JAX package's ``PipelineParallel`` on a mesh of 4 of its 8
    devices (its fleet.init wants all 8): the inference forward, the
    losses and the parameters after the steps."""
    from paddle_tpu import optimizer

    mesh = jax_comm.init_hybrid_mesh(**degrees)
    layer = jpipe.PipelineLayer(_jax_blocks(*PP_CFG), loss_fn=_jax_loss)
    if init is None:
        init = _sd(layer)
    layer.set_state_dict(init)
    model = jpipe.PipelineParallel(layer, mesh=mesh,
                                   accumulate_steps=PP_MICRO,
                                   schedule_mode=mode)
    opt = optimizer.Momentum(learning_rate=PP_LR, momentum=0.9,
                             parameters=model.parameters())
    fwd = np.asarray(model(jpaddle.to_tensor(xs[0])).numpy())
    losses = [float(model.train_batch([x, y], opt).numpy())
              for x, y in zip(xs, ys)]
    jax_comm._state.hybrid_mesh = None
    return init, {"forward": fwd, "losses": losses, "params": _sd(layer),
                  "segments": layer.segment(2)}


def _jax_refs(rng):
    f = np.float32
    x, ref = {}, {}
    xs = [rng.randn(PP_BATCH, PP_T, PP_CFG[0]).astype(f)
          for _ in range(PP_STEPS)]
    ys = [rng.randint(0, PP_CFG[2], (PP_BATCH,)).astype(np.int64)
          for _ in range(PP_STEPS)]
    x.update(pp_cfg=PP_CFG, pp_micro=PP_MICRO, pp_lr=PP_LR, pp_x=xs,
             pp_y=ys)
    init = None
    for name, degrees, mode in (("pp2", dict(dp=2, pp=2), "1F1B"),
                                ("pp2_fthenb", dict(dp=2, pp=2), "F-then-B"),
                                ("pp2_mp2", dict(pp=2, mp=2), "1F1B")):
        init, ref[name] = _jax_pipeline(init, xs, ys, mode, **degrees)
    x["pp_init"] = init
    jpaddle.seed(5)
    layer = jmoe.ExpertParallelMoE(*MOE_CFG, mesh=None)
    x.update(moe_cfg=MOE_CFG, moe_init=_sd(layer),
             moe_x=rng.randn(*MOE_X).astype(f),
             moe_cot=rng.randn(*MOE_X).astype(f), moe_aux_w=MOE_AUX_W)
    xt = jpaddle.to_tensor(x["moe_x"], stop_gradient=False)
    o, aux = layer(xt)
    ((o * jpaddle.to_tensor(x["moe_cot"])).sum() + MOE_AUX_W * aux
     ).backward()
    ref["moe"] = {"out": o.numpy(), "aux": float(aux.numpy()),
                  "gx": xt.grad.numpy(),
                  "grads": {n: p.grad.numpy() for n, p in
                            layer.named_parameters()}}
    return x, ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    try:
        x, ref = _jax_refs(np.random.RandomState(0))
    finally:
        _fresh_process_state()
    tmp = str(tmp_path_factory.mktemp("world"))
    out = tw.run_world(["pipeline", "moe"], tmp, x)
    yield x, ref, out
    pt_device._current = saved
    _fresh_process_state()


# -- in this process -----------------------------------------------------------

@pytest.mark.parametrize("order", ["_1f1b_order", "_f_then_b_order"])
def test_schedule_orders_match(order):
    for S in range(1, 5):
        for M in range(1, 9):
            assert getattr(tpipe, order)(S, M) == \
                getattr(jpipe, order)(S, M), (S, M)


def test_segments_match():
    from paddle_tpu import nn as jnn

    sizes = [(64, 64)] + [(4, 4)] * 5 + [(8, 8)] * 3
    for method in ("uniform", "param"):
        jl = jpipe.PipelineLayer([jnn.Linear(*s) for s in sizes],
                                 seg_method=method)
        tl = tpipe.PipelineLayer([pt.nn.Linear(*s, device="cpu")
                                  for s in sizes], seg_method=method)
        for n in range(1, 5):
            assert tl.segment(n) == jl.segment(n), (method, n)
    with pytest.raises(ValueError, match="cannot cut"):
        tl.segment(10)


def _gates_with_tie_and_overflow():
    """[N=8, E=4]: token 2 ties experts 1 and 3 (the first wins), and five
    tokens pick expert 0 first (capacity 3 drops two)."""
    g = np.array([[0.7, 0.1, 0.1, 0.1], [0.6, 0.2, 0.1, 0.1],
                  [0.1, 0.4, 0.1, 0.4], [0.5, 0.3, 0.1, 0.1],
                  [0.8, 0.05, 0.1, 0.05], [0.1, 0.1, 0.7, 0.1],
                  [0.55, 0.15, 0.2, 0.1], [0.2, 0.2, 0.2, 0.4]],
                 np.float32)
    return g, 3


def test_top2_dispatch_matches():
    g, C = _gates_with_tie_and_overflow()
    r = np.random.RandomState(3).randn(8, 4, C).astype(np.float32)
    jd, jc, jm = jmoe._top2_dispatch(jnp.asarray(g), C)
    jgrad = jax.grad(lambda a: jnp.sum(jmoe._top2_dispatch(a, C)[1] * r))(
        jnp.asarray(g))
    gt = torch.tensor(g, requires_grad=True)
    td, tc, tm = tmoe._top2_dispatch(gt, C)
    (tc * torch.tensor(r)).sum().backward()
    np.testing.assert_array_equal(td.detach().numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-6)
    # the tie went to expert 1; expert 0 kept 3 of its 5 first choices
    assert td.detach().numpy()[2, 1].sum() == 1
    assert td.detach().numpy()[:, 0].sum() == C
    x = np.random.RandomState(4).randn(8, 5).astype(np.float32)
    got = tmoe.moe_dispatch_combine(torch.tensor(x), torch.tensor(g), C)
    want = jmoe.moe_dispatch_combine(jnp.asarray(x), jnp.asarray(g), C)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_moe_layer_matches_at_ep1(world):
    x, ref, _ = world
    pt_comm._mesh = None
    layer = tmoe.ExpertParallelMoE(*MOE_CFG, device="cpu")
    layer.set_state_dict(x["moe_init"])
    xt = torch.tensor(x["moe_x"], requires_grad=True)
    o, aux = layer(xt)
    ((o * torch.tensor(x["moe_cot"])).sum() + MOE_AUX_W * aux).backward()
    want = ref["moe"]
    _near(o.detach().numpy(), want["out"], REL, "out")
    np.testing.assert_allclose(float(aux), want["aux"], rtol=REL)
    _near(xt.grad.numpy(), want["gx"], REL, "dx")
    for n, p in layer.named_parameters():
        _near(p.grad.numpy(), want["grads"][n], REL, n)


# -- the world -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["pp2", "pp2_fthenb", "pp2_mp2"])
def test_pipeline_train_batch_matches(world, name):
    """Each rank's losses (the mean over microbatches, from the last
    stage) and its stage's parameters after the steps."""
    _, ref, out = world
    want = ref[name]
    stages = []
    for r, o in enumerate(out["pipeline"]):
        got = o[name]
        stages.append(got["stage"])
        assert got["segments"] == want["segments"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5, err_msg=f"rank {r}")
        assert got["params"], r
        for k, v in got["params"].items():
            _near(v, want["params"][k], REL, f"{name} {k} rank {r}")
    # rank ((dp * PP + pp) * SP + sp) * MP + mp
    assert stages == ([0, 1, 0, 1] if name != "pp2_mp2" else [0, 0, 1, 1])


def test_pipeline_forward_matches(world):
    _, ref, out = world
    for r, o in enumerate(out["pipeline"]):
        _near(o["pp2"]["forward"], ref["pp2"]["forward"], REL, f"rank {r}")


def test_moe_layer_matches_at_ep4(world):
    """mp4: 2 of the 8 experts a rank (wi [2, 16, 32], wo [2, 32, 16]),
    the full weights taken by ``set_state_dict`` and gathered back."""
    x, ref, out = world
    want = ref["moe"]
    for r, o in enumerate(out["moe"]):
        assert o["local"] == {"gate": (16, 8), "wi": (2, 16, 32),
                              "wo": (2, 32, 16)}
        for k, v in x["moe_init"].items():
            np.testing.assert_array_equal(o["full"][k], v)
        _near(o["out"], want["out"], REL, f"out rank {r}")
        np.testing.assert_allclose(o["aux"], want["aux"], rtol=REL)
        _near(o["gx"], want["gx"], REL, f"dx rank {r}")
        for n, g in want["grads"].items():
            _near(o["grads"][n], g, REL, f"{n} rank {r}")
