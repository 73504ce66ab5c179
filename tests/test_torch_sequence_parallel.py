"""Sequence parallelism at sp4: the port (4 gloo processes,
``helpers/torch_world.py``, started once for the module) against the JAX
package (a 4-way ``sp`` mesh of 4 of its 8 CPU devices).

- ``flash_attention_partial``: the port's custom op (its plain version on
  the CPU) against the JAX package's in interpret mode at ``[1, 2, 32, 8]``:
  out, lse, and the gradients of a loss that reads both (the lse
  cotangent folds into delta), causal, not, and with fully masked rows.
- ``ring_attention`` (plain and ``use_pallas``) and ``ulysses_attention``,
  causal and not, on global ``[1, 4, 32, 8]`` inputs: every rank's output
  within 1e-5 of the largest value of the JAX package's, and the gradients
  of ``sum(out * g)`` within 2e-5. The JAX side runs its per-device bodies
  under ``shard_map``, jitted with their gradients (one compile each).
- ``MultiHeadAttention``'s three routes: each rank feeds its rows of x and
  gets its rows of the JAX layer's output; the parameter gradients summed
  over the ranks are the JAX layer's.
- A one-layer causal decoder on ``attn_impl="ring"`` trained 3 Momentum
  steps through fleet (``sp_degree`` 4) and ``TrainStep``, each rank on
  its quarter of the positions (its position embeddings offset), against
  the JAX package's ``TrainStep`` on the global batch over its sp mesh:
  losses within 1e-5 relative, parameters within 1e-5 of each largest.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import paddle_tpu as jpaddle
import paddle_tpu.ops.pallas as jax_pallas
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit.functional_call import functional_call
from paddle_tpu.nn.layers import ring_attention as jra
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_fa, flash_attention_partial as jax_fap)

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
import torch
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from helpers import torch_world as tw

QKV_SHAPE = (1, 4, 32, 8)
BLOCK = 8
#: MultiHeadAttention: embed dim, heads; x [B, T, E]
MHA_CFG = (16, 4)
MHA_X = (2, 32, 16)
#: the decoder: vocab, d, heads, seq (global), attention
DEC_CFG = (32, 16, 2, 32, "ring")
DEC_LR = 0.1
OUT_REL, GRAD_REL = 1e-5, 2e-5
SPEC = P(None, None, "sp", None)


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


def _attention_refs(mesh, q, k, v, g):
    """{(impl, causal): [out, dq, dk, dv]} of the JAX package's bodies
    under shard_map, jitted with their gradients."""
    out = {}
    for impl in ("ring", "ring_pallas", "ulysses"):
        for causal in (True, False):
            if impl == "ulysses":
                body = partial(jra._ulysses_raw, axis_name="sp",
                               causal=causal, scale=None, block_size=BLOCK)
            else:
                body = partial(jra.ring_attention_raw, axis_name="sp",
                               sp_size=4, causal=causal,
                               use_pallas=impl == "ring_pallas",
                               interpret=True)
            fn = jax_comm.shard_map(body, mesh, in_specs=(SPEC,) * 3,
                                    out_specs=SPEC)

            def loss(a, b, c, fn=fn):
                o = fn(a, b, c)
                return jnp.sum(o * g), o

            (_, o), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
            out[impl, causal] = [np.asarray(t) for t in (o, *grads)]
    return out


def _mha_refs(x, cot):
    """Each route's JAX layer (weights of the first): out, dx, param
    grads; the weights."""
    from paddle_tpu import nn

    refs, init = {}, None
    for impl in ("ring", "ring_pallas", "ulysses"):
        layer = nn.MultiHeadAttention(*MHA_CFG, attn_impl=impl, causal=True,
                                      block_size=BLOCK)
        if init is None:
            init = _sd(layer)
        layer.set_state_dict(init)
        params = {n: p._data for n, p in layer.named_parameters()}

        def loss(ps, xx, layer=layer):
            o = functional_call(layer, ps, args=(xx,))[0]
            return jnp.sum(o * cot), o

        (_, o), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
        refs[impl] = {"out": np.asarray(o), "gx": np.asarray(gx),
                      "grads": {n: np.asarray(a) for n, a in gp.items()}}
    return refs, init


def _jax_decoder(vocab, d, heads, seq, impl):
    from paddle_tpu import nn

    class Decoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, d)
            self.pos = nn.Embedding(seq, d)
            self.layer = nn.TransformerEncoderLayer(
                d, heads, 2 * d, dropout=0.0, attn_impl=impl, causal=True)
            self.head = nn.Linear(d, vocab)

        def forward(self, ids):
            T = ids.shape[1]
            pos = jpaddle.arange(T, dtype="int64")
            return self.head(self.layer(self.embed(ids) + self.pos(pos)))

    return Decoder()


def _jax_refs(rng):
    f = np.float32
    x, ref = {}, {}
    mesh = jax_comm.init_hybrid_mesh(sp=4)
    qkvg = [rng.randn(*QKV_SHAPE).astype(f) for _ in range(4)]
    x["qkvg"], x["block"] = qkvg, BLOCK
    ref["attn"] = _attention_refs(mesh, *(jnp.asarray(a) for a in qkvg))
    x["mha_cfg"] = MHA_CFG
    x["mha_x"] = rng.randn(*MHA_X).astype(f)
    x["mha_cot"] = rng.randn(*MHA_X).astype(f)
    ref["mha"], x["mha"] = _mha_refs(x["mha_x"], x["mha_cot"])
    vocab, seq = DEC_CFG[0], DEC_CFG[3]
    model = _jax_decoder(*DEC_CFG)
    x["dec_init"] = _sd(model)
    x["dec_cfg"] = DEC_CFG
    ids = rng.randint(0, vocab, (2, seq)).astype(np.int64)
    labels = rng.randint(0, vocab, (2, seq)).astype(np.int64)
    x["dec_batch"], x["dec_lr"] = (ids, labels), DEC_LR

    def loss_fn(logits, lbl):
        return jpaddle.nn.functional.cross_entropy(
            logits.reshape([-1, vocab]), lbl.reshape([-1]))

    from paddle_tpu import optimizer

    step = JTrainStep(model, loss_fn, optimizer.Momentum(
        learning_rate=DEC_LR, momentum=0.9, parameters=model.parameters()))
    ref["dec_losses"] = [float(step(ids, labels).numpy()) for _ in range(3)]
    ref["dec_params"] = _sd(model)
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
    out = tw.run_world(["sequence_parallel"], tmp, x)["sequence_parallel"]
    yield x, ref, out
    pt_device._current = saved
    _fresh_process_state()


# -- the partial op, in this process -----------------------------------------

@pytest.mark.parametrize("causal,kv_offset", [(True, 0), (False, 0),
                                              (True, 16)],
                         ids=["causal", "full", "masked-rows"])
def test_flash_attention_partial_matches(causal, kv_offset):
    """Out, lse and the gradients of ``sum(out * go) + sum(lse' * gl)``
    (lse' the live rows' lse) against the JAX package's
    ``flash_attention_partial`` in interpret mode."""
    rng = np.random.RandomState(1)
    q, k, v, go = (rng.randn(1, 2, 32, 8).astype(np.float32)
                   for _ in range(4))
    gl = rng.randn(1, 2, 32).astype(np.float32)

    def jloss(a, b, c):
        o, lse = jax_fap(a, b, c, causal, 8, 8, None, True, 0, kv_offset)
        live = jnp.where(lse > -1e29, lse, 0.0)
        return jnp.sum(o * go) + jnp.sum(live * gl), (o, lse)

    (_, (jo, jl)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o, lse = fa.flash_attention_partial(*ts, causal, 8, 8, None, 0,
                                        kv_offset)
    live = torch.where(lse > -1e29, lse, torch.zeros_like(lse))
    ((o * torch.tensor(go)).sum() + (live * torch.tensor(gl)).sum()
     ).backward()
    _near(o.detach().numpy(), jo, OUT_REL, "out")
    np.testing.assert_array_equal(lse.detach().numpy() <= -1e29,
                                  np.asarray(jl) <= -1e29)
    np.testing.assert_allclose(lse.detach().numpy(), jl, rtol=1e-5,
                               atol=1e-5)
    for t, want, name in zip(ts, jg, "qkv"):
        _near(t.grad.numpy(), want, GRAD_REL, f"d{name}")
    if kv_offset:
        assert float(lse.detach().min()) == float(np.float32(-1e30))
        assert float(o.detach()[:, :, :kv_offset].abs().max()) == 0.0


# -- the world ----------------------------------------------------------------

def test_sp_mesh_layout(world):
    """sp4: rank r is sp index r; one sp group; the data group (dp x sp)
    is the same four ranks."""
    _, _, out = world
    for r, o in enumerate(out):
        assert o["sp_rank"] == r
        assert o["sp_group"] == o["data_group"] == [0, 1, 2, 3]


@pytest.mark.parametrize("impl", ["ring", "ring_pallas", "ulysses"])
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "full"])
def test_attention_matches(world, impl, causal):
    _, ref, out = world
    want = ref["attn"][impl, causal]
    for r, o in enumerate(out):
        got = o[impl, causal]
        _near(got[0], want[0], OUT_REL, f"{impl} out rank {r}")
        for name, a, b in zip("qkv", got[1:], want[1:]):
            _near(a, b, GRAD_REL, f"{impl} d{name} rank {r}")


@pytest.mark.parametrize("impl", ["ring", "ring_pallas", "ulysses"])
def test_multi_head_attention_routes_match(world, impl):
    """Each rank's rows of the output and of dx; the parameter gradients
    summed over the ranks (each rank's loss covers its rows)."""
    _, ref, out = world
    want = ref["mha"][impl]
    T = MHA_X[1] // 4
    for r, o in enumerate(out):
        got = o["mha", impl]
        rows = slice(r * T, (r + 1) * T)
        _near(got["out"], want["out"][:, rows], OUT_REL, f"out rank {r}")
        _near(got["gx"], want["gx"][:, rows], GRAD_REL, f"dx rank {r}")
    for n, g in want["grads"].items():
        _near(sum(o["mha", impl]["grads"][n] for o in out), g, GRAD_REL, n)


def test_sequence_parallel_training_matches(world):
    """The decoder at sp4 through fleet and ``TrainStep``: each rank's
    shard is a quarter of the positions; the losses (the mean over the
    ranks' tokens, the same on every rank) and parameters after 3 steps
    are the JAX package's on the global batch."""
    _, ref, out = world
    for r, o in enumerate(out):
        assert o["dec_shard"] == (2, DEC_CFG[3] // 4)
        np.testing.assert_allclose(o["dec_losses"], ref["dec_losses"],
                                   rtol=1e-5)
        for k, v in ref["dec_params"].items():
            _near(o["dec_params"][k], v, 1e-5, f"{k} rank {r}")
