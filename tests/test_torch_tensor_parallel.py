"""Tensor parallelism, ``DataParallel`` and ``fleet`` at dp2 x mp2: the port
(4 gloo processes, ``helpers/torch_world.py``, started once for the module)
against the JAX package (a dp2 x mp2 mesh of 4 of its 8 CPU devices).

Every layer takes the JAX package's full ``state_dict`` (numpy, the JAX
layout) through ``set_state_dict``, which keeps each rank's shard; outputs
and gradients (gathered back to full) are held to the JAX run's within
rtol 1e-5 / atol 1e-6 in float32 (atol scaled by the array's largest
magnitude where it passes 1). The GPT (2 ``ParallelGPTBlock`` layers,
d 128, 4 heads: bench.py's program at a small size) trains 3 steps through
``fleet`` and ``TrainStep`` against the JAX package's same program, its
gradients clipped by their global norm (the norm of the full gradients,
mp shards included): losses within 1e-5 relative, gathered parameters
within 1e-5 of each one's largest. The optimizer there is Momentum:
Adam divides a gradient by its own root mean square, which turns the
rounding noise of a gradient that is zero in exact arithmetic (the key
projection's bias: softmax does not see a constant added to every key)
into an lr-sized step of either sign, in either package. A NaN injected
into one rank's gradients makes every rank skip that step. Dropout's
streams follow the mesh (one mask per dp index, or per rank for sharded
activations, eager and captured), and ``recompute`` replays them: the
GPT with dropout under ``recompute`` gives the plain run's gradients.
"""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
import paddle_tpu.ops.pallas as jax_pallas
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.distributed.fleet.base import HybridCommunicateGroup
from paddle_tpu.distributed.parallel import shard_batch
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from helpers import torch_world as tw

#: the GPT: vocab, d, heads, layers, seq
GPT_CFG = (256, 128, 4, 2, 32)
LR = 0.05
#: the GPT's global-norm clip: below its gradients' norm, so every step
#: clips by the norm over the full gradients (mp shards included)
CLIP = 1.0
TOL = dict(rtol=1e-5, atol=1e-6)


def _fresh_process_state():
    jax_comm._state.hybrid_mesh = pt_comm._mesh = None
    jax_pallas.flash_attention = jax_fa


def _sd(layer):
    return {k: np.asarray(v.numpy()).copy()
            for k, v in layer.state_dict().items()}


def _jax_fwd_bwd(layer, x, cot):
    xt = jpaddle.to_tensor(x, stop_gradient=x.dtype.kind != "f")
    out = layer(xt)
    (out * jpaddle.to_tensor(cot)).sum().backward()
    return {"out": out.numpy(),
            "gx": None if xt.grad is None else xt.grad.numpy(),
            "grads": {n: p.grad.numpy() for n, p in
                      layer.named_parameters()}}


def _jax_gpt(vocab, d, heads, layers, seq):
    from paddle_tpu import nn

    class GPT(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, d)
            self.pos = nn.Embedding(seq, d)
            self.blocks = nn.LayerList([
                jdist.ParallelGPTBlock(d, heads, dropout=0.0)
                for _ in range(layers)])
            self.head = nn.Linear(d, vocab)

        def forward(self, ids):
            T = ids.shape[1]
            h = self.embed(ids) + self.pos(jpaddle.arange(T, dtype="int64"))
            for blk in self.blocks:
                h = blk(h)
            return h

    return GPT()


def _jax_lm_loss(model):
    def loss(h, labels):
        d = h.shape[-1]
        return jpaddle.nn.functional.fused_linear_cross_entropy(
            h.reshape([-1, d]), model.head.weight, model.head.bias,
            labels.reshape([-1]))

    return loss


def _replicate_rest(model, mesh):
    """``fleet.distributed_model``'s layout: TP parameters keep their mp
    sharding, the rest replicate over the mesh."""
    for p in model.parameters():
        if getattr(p, "_tp_spec", None) is None:
            p._data = jax.device_put(p._data, NamedSharding(mesh, P()))


def _jax_refs(rng):
    """Inputs for the world and the JAX package's results."""
    f = np.float32
    x = {}
    ref = {}
    # DataParallel's reference: one device, the global batch
    from paddle_tpu import nn, optimizer

    class SmallNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(12, 16)
            self.fc2 = nn.Linear(16, 4)

        def forward(self, v):
            return self.fc2(jpaddle.nn.functional.relu(self.fc1(v)))

    small = SmallNet()
    x["dp_init"] = _sd(small)
    x["dp_data"] = [(rng.rand(16, 12).astype(f),
                     rng.randint(0, 4, (16,)).astype(np.int64))
                    for _ in range(4)]
    step = JTrainStep(small, lambda o, y: jpaddle.nn.functional
                      .cross_entropy(o, y), optimizer.Momentum(
                          learning_rate=0.1, parameters=small.parameters()))
    ref["dp_losses"] = [float(step(a, b).numpy()) for a, b in x["dp_data"]]
    ref["dp_params"] = _sd(small)

    # SyncBatchNorm's reference: one device, the global batch
    bn = nn.SyncBatchNorm(4)
    bn.train()
    x["bn"] = _sd(bn)
    x["xbn"] = rng.randn(8, 4, 3, 3).astype(f)
    x["cotbn"] = rng.rand(8, 4, 3, 3).astype(f)
    ref["bn"] = _jax_fwd_bwd(bn, x["xbn"], x["cotbn"])
    ref["bn_running"] = _sd(bn)

    mesh = jax_comm.init_hybrid_mesh(dp=2, mp=2)
    hcg = HybridCommunicateGroup(mesh)
    ref["topology"] = (hcg.get_data_parallel_world_size(),
                       hcg.get_model_parallel_world_size(),
                       hcg.get_pipe_parallel_world_size())
    x["x12"] = rng.rand(6, 12).astype(f)
    x["x8"] = rng.rand(4, 8).astype(f)
    x["ids"] = rng.randint(0, 16, (3, 5)).astype(np.int64)
    x["xb"] = rng.rand(2, 32, 64).astype(f)
    for k, shape in (("cot16", (6, 16)), ("cot5", (6, 5)), ("cot8", (4, 8)),
                     ("cot_emb", (3, 5, 6)), ("cotb", (2, 32, 64))):
        x[k] = rng.rand(*shape).astype(f)
    col = jdist.ColumnParallelLinear(12, 16, gather_output=True)
    x["col"] = _sd(col)
    ref["col"] = _jax_fwd_bwd(col, x["x12"], x["cot16"])
    row = jdist.RowParallelLinear(12, 5)
    x["row"] = _sd(row)
    ref["row"] = _jax_fwd_bwd(row, x["x12"], x["cot5"])

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.col = jdist.ColumnParallelLinear(8, 16, gather_output=False)
            self.row = jdist.RowParallelLinear(16, 8, input_is_parallel=True)

        def forward(self, v):
            return self.row(jpaddle.nn.functional.gelu(self.col(v)))

    mlp = MLP()
    x["mlp_col"], x["mlp_row"] = _sd(mlp.col), _sd(mlp.row)
    ref["mlp"] = _jax_fwd_bwd(mlp, x["x8"], x["cot8"])
    emb = jdist.VocabParallelEmbedding(16, 6)
    x["emb"] = _sd(emb)
    ref["emb"] = _jax_fwd_bwd(emb, x["ids"], x["cot_emb"])
    blk = jdist.ParallelGPTBlock(64, 4, dropout=0.0)
    x["block"] = _sd(blk)
    ref["block"] = _jax_fwd_bwd(blk, x["xb"], x["cotb"])

    x["gpt_cfg"] = GPT_CFG
    model = _jax_gpt(*GPT_CFG)
    x["gpt_init"] = _sd(model)
    _replicate_rest(model, mesh)
    step = JTrainStep(model, _jax_lm_loss(model), optimizer.Momentum(
        learning_rate=LR, momentum=0.9, parameters=model.parameters(),
        grad_clip=nn.ClipGradByGlobalNorm(CLIP)))
    V, S = GPT_CFG[0], GPT_CFG[4]
    ids = rng.randint(0, V, (4, S)).astype(np.int64)
    labels = rng.randint(0, V, (4, S)).astype(np.int64)
    x["gpt_batch"] = (ids, labels)
    ref["gpt_losses"] = [float(step(shard_batch(ids, mesh),
                                    shard_batch(labels, mesh)).numpy())
                         for _ in range(3)]
    ref["gpt_params"] = _sd(model)
    x["gpt_lr"], x["gpt_clip"] = LR, CLIP
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
    out = tw.run_world(["fleet", "tp_layers", "gpt_block", "data_parallel",
                        "sync_batch_norm", "gpt_train", "guard",
                        "random_streams"], tmp, x)
    yield x, ref, out
    pt_device._current = saved
    _fresh_process_state()


def _allclose(got, want, what):
    """rtol 1e-5, atol 1e-6 of the array's scale (its largest magnitude,
    at least 1): the block's input gradients reach 13, where float32 sums
    in another order differ by a few ulps (1e-6 each)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * scale, err_msg=what)


def _close(got, want, what):
    _allclose(got["out"], want["out"], what)
    if want["gx"] is not None:
        _allclose(got["gx"], want["gx"], what)
    assert set(got["grads"]) == set(want["grads"])
    for k in want["grads"]:
        _allclose(got["grads"][k], want["grads"][k], f"{what} {k}")


def test_fleet_topology(world):
    _, ref, out = world
    for r, o in enumerate(out["fleet"]):
        assert (o["dp"], o["mp"], o["pp"]) == ref["topology"] == (2, 2, 1)
        # mp innermost: rank = dp_index * mp + mp_index
        assert (o["dp_rank"], o["mp_rank"]) == divmod(r, 2)
        assert o["mp_group"] == [r - r % 2, r - r % 2 + 1]
        assert o["dp_group"] == [r % 2, r % 2 + 2]
        assert (o["worker_index"], o["worker_num"], o["first"]) == \
            (r, 4, r == 0)
        assert o["backend"] == "gloo"


@pytest.mark.parametrize("layer", ["col", "row", "mlp", "emb"])
def test_tensor_parallel_layer_matches(world, layer):
    _, ref, out = world
    for r, o in enumerate(out["tp_layers"]):
        _close(o[layer], ref[layer],
               f"{layer} rank {r}")


def test_state_dict_is_the_shards(world):
    """``state_dict()`` on a rank gives its shards; ``set_state_dict``
    took the full arrays; ``full_state_dict`` gathers them back."""
    x, _, out = world
    for o in out["tp_layers"]:
        assert o["col_local"] == {"weight": (12, 8), "bias": (8,)}
        assert o["row_local"] == {"weight": (6, 5), "bias": (5,)}
        assert o["emb_local"] == (8, 6)
        for k, v in x["col"].items():
            np.testing.assert_array_equal(o["col_full"][k], v)


def test_split_and_divisibility(world):
    for o in world[2]["tp_layers"]:
        assert o["split_linear"] == (2, 12)
        assert o["split_embedding"] == (1, 2, 4)
        assert "not divisible by mp=2" in o["not_divisible"]


def test_mp_without_a_mesh_raises():
    pt_comm._mesh = None
    with pytest.raises(ValueError, match="mp degree is 1"):
        pt.distributed.ParallelGPTBlock(16, 4, mp=2, device="cpu")


@pytest.mark.parametrize("route", ["dense", "kernels"])
def test_gpt_block_matches(world, route):
    """``ParallelGPTBlock`` at mp2 against the JAX package's: the dense
    route, and the kernels' route (their plain versions on the CPU) with
    two heads a rank."""
    _, ref, out = world
    for r, o in enumerate(out["gpt_block"]):
        _close(o[route], ref["block"], f"{route} rank {r}")


def test_data_parallel_matches_one_process(world):
    _, ref, out = world
    for o in out["data_parallel"]:
        np.testing.assert_allclose(o["losses"], ref["dp_losses"], rtol=1e-5)
        for k, v in ref["dp_params"].items():
            np.testing.assert_allclose(o["params"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert [o["group"] for o in out["data_parallel"]] == \
        [[0, 2], [1, 3], [0, 2], [1, 3]]


def test_sync_batch_norm_takes_the_dp_batch(world):
    """``SyncBatchNorm`` in training on a dp2 world: each rank's rows of
    the output and of the input gradient, and the running statistics, as
    the JAX package's on the global batch (one program)."""
    _, ref, out = world
    for r, o in enumerate(out["sync_batch_norm"]):
        lo, hi = o["rows"]
        _allclose(o["out"], ref["bn"]["out"][lo:hi], f"out rank {r}")
        _allclose(o["gx"], ref["bn"]["gx"][lo:hi], f"dx rank {r}")
        for k, v in ref["bn_running"].items():
            _allclose(o["running"][k], v, f"{k} rank {r}")


def test_gpt_training_matches(world):
    """bench.py's GPT program at a small size through ``fleet`` (dp2 x
    mp2) and ``TrainStep``: the dp-mean loss, the same on every rank, and
    the parameters gathered to full."""
    _, ref, out = world
    for o in out["gpt_train"]:
        np.testing.assert_allclose(o["losses"], ref["gpt_losses"],
                                   rtol=1e-5)
        for k, v in ref["gpt_params"].items():
            scale = max(float(np.abs(v).max()), 1e-30)
            err = float(np.abs(o["params"][k] - v).max()) / scale
            assert err <= 1e-5, (k, err)


def test_guard_skip_agrees_across_ranks(world):
    """``grad:nan:2`` on rank 1 alone: every rank leaves its parameters as
    they were after step 1, and applies step 3."""
    for r, o in enumerate(world[2]["guard"]):
        s1, s2, s3 = o["snaps"]
        assert all(np.array_equal(s1[k], s2[k]) for k in s1), r
        assert any(not np.array_equal(s2[k], s3[k]) for k in s1), r


def test_dropout_streams_follow_the_mesh(world):
    """``dropout`` draws one mask per dp index (mp peers hold the same
    activations), ``dropout_mp`` one per rank; a ``to_static`` capture
    draws from the same stream, fresh masks each call."""
    o = world[2]["random_streams"]
    for name in ("dropout", "captured"):
        first = [np.asarray(r[name]).reshape(-1) for r in o]
        np.testing.assert_array_equal(first[0], first[1], err_msg=name)
        np.testing.assert_array_equal(first[2], first[3], err_msg=name)
        assert not np.array_equal(first[0], first[2]), name
    np.testing.assert_array_equal(o[0]["captured"][0], o[0]["dropout"])
    assert not np.array_equal(*o[0]["captured"])
    assert all(r["captured_draws"] == 1 for r in o)
    masks = [r["dropout_mp"] for r in o]
    assert all(not np.array_equal(masks[i], masks[j])
               for i in range(4) for j in range(i + 1, 4))


def test_recompute_with_dropout_matches_plain(world):
    """The GPT with dropout 0.1 at dp2 x mp2: every block under
    ``recompute`` gives the loss and the gradients of the plain run,
    exactly, on every rank (the recomputation replays the rank's streams),
    and dropout did change the loss."""
    for r, o in enumerate(world[2]["random_streams"]):
        (lp, gp), (lr, gr) = o["plain"], o["recomputed"]
        assert lp == lr, r
        assert lp != o["eval_loss"], r
        for k in gp:
            np.testing.assert_array_equal(gr[k], gp[k], err_msg=f"{r} {k}")
