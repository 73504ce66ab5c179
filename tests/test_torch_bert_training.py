"""bench.py's BERT-base training program in the port against paddle_tpu, on
carried weights.

``_bert_base`` (token and position embeddings, post-LN
``TransformerEncoderLayer``s with ReLU and dropout 0, the mean over the
sequence, a 2-way head) is built in both packages at 2 layers, d_model
128, 4 heads, ffn 512, seq 16, batch 2, vocab 64, with the same random
numpy weights (``set_state_dict``), and trained as
``_bench_bert`` trains it: ``cross_entropy``, ``AdamW(1e-4, 0.01)``, in
float32 and under ``strategy.amp`` (bf16 O1). Both packages run with
``PADDLE_FUSED_LN=interpret``: the LayerNorms (D 128, 32 rows) take the
kernel route, paddle_tpu's through the Pallas interpreter and the port's
through its kernels' plain versions. BERT's attention is not causal, so
it takes the dense route in both.

Checked: the LayerNorms' route; one batch's loss and every parameter's
gradient (paddle_tpu's from ``jax.value_and_grad`` of its TrainStep's
``_loss_of``); three TrainSteps (losses, then parameters); and
``MultiHeadAttention``'s other forms (``need_weights``, a bool mask,
``kdim``/``vdim`` projections, the causal mask, a concatenated cache, a
static cache, and decoding into a static-capacity cache at per-slot
positions).

Tolerances as in ``test_torch_amp_training.py``: float32 gradients
within 1e-4 of each parameter's largest gradient, loss atol 1e-5; bf16
AMP gradients within 2e-2, loss atol 2e-3; parameters after three AdamW
steps atol 6e-4 = 3 x 2 lr (an Adam step moves a parameter by about lr,
and a gradient near zero may take opposite signs in the two packages);
attention outputs atol 1e-5 (float32, sums in different orders). Under
bf16 AMP the gradients named in ``AMP_READINGS`` and the three steps'
losses are held within 1.25 times the port's measured distance from
paddle_tpu instead: this two-class loss over the mean of the sequence
sums gradients that cancel, so bf16 roundings taken in different orders
move them far (``encoder.0.linear1.weight``: 31% of its largest value
between the packages, and 31% between paddle_tpu's bf16 and float32
gradients; measured on the CPU with JAX 0.9 and PyTorch 2.13). At this
size the bands cannot tell bf16 from float32: a port whose ``linear``
ran in float32 under AMP lies no further from paddle_tpu (12.7% there).
What holds the casts is the check of every layer's output type against
paddle_tpu's, which that port fails
(``test_amp_type_check_catches_float32_linear``).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.distributed import comm
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed.fleet.base import \
    _DistributedOptimizer as _JaxDistributedOptimizer
from paddle_tpu.jit import TrainStep as JaxTrainStep

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import fleet

VOCAB, D, HEADS, LAYERS, S, B = 64, 128, 4, 2, 16, 2
LR, WD = 1e-4, 0.01
#: (loss atol, gradient share) in float32 and under AMP
TOL = {False: (1e-5, 1e-4), True: (2e-3, 2e-2)}
PARAM_ATOL = 6e-4
#: under AMP, the port's measured distance from paddle_tpu's bf16
#: gradient, as a share of its largest value, for each gradient further
#: than TOL[True]; each is held within AMP_MARGIN times its reading
AMP_READINGS = {
    "embed.weight": 4.884e-2, "pos.weight": 7.818e-2,
    "encoder.0.self_attn.qkv_proj.weight": 5.310e-2,
    "encoder.0.self_attn.qkv_proj.bias": 4.241e-2,
    "encoder.0.self_attn.out_proj.weight": 2.667e-2,
    "encoder.0.self_attn.out_proj.bias": 5.738e-2,
    "encoder.0.linear1.weight": 3.092e-1,
    "encoder.0.linear1.bias": 2.103e-1,
    "encoder.0.linear2.weight": 2.617e-2,
    "encoder.0.linear2.bias": 3.509e-2,
    "encoder.0.norm1.weight": 3.053e-2, "encoder.0.norm1.bias": 4.215e-2,
    "encoder.0.norm2.bias": 2.249e-2,
    "encoder.1.self_attn.qkv_proj.bias": 2.789e-2,
    "encoder.1.self_attn.out_proj.bias": 2.685e-2,
    "encoder.1.linear1.weight": 1.423e-1,
    "encoder.1.linear1.bias": 1.446e-1,
    "encoder.1.norm1.bias": 2.866e-2,
}
#: the largest loss distance over three AdamW steps under AMP
AMP_STEP_LOSS_READING = 2.726e-3
AMP_MARGIN = 1.25


class JaxBert(jnn.Layer):
    """bench.py's ``_bert_base`` at the test's size."""

    def __init__(self):
        super().__init__()
        self.embed = jnn.Embedding(VOCAB, D)
        self.pos = jnn.Embedding(S, D)
        self.encoder = jnn.LayerList([
            jnn.TransformerEncoderLayer(D, HEADS, 4 * D, dropout=0.0)
            for _ in range(LAYERS)])
        self.head = jnn.Linear(D, 2)

    def forward(self, ids):
        h = self.embed(ids) + self.pos(paddle_tpu.arange(ids.shape[1],
                                                         dtype="int64"))
        for lyr in self.encoder:
            h = lyr(h)
        return self.head(h.mean(axis=1))


class TorchBert(torch.nn.Module):
    """The same model from the port's layers."""

    def __init__(self):
        super().__init__()
        kw = dict(device="cpu", generator=torch.Generator().manual_seed(0))
        self.embed = pt.nn.Embedding(VOCAB, D, **kw)
        self.pos = pt.nn.Embedding(S, D, **kw)
        self.encoder = pt.nn.LayerList([
            pt.nn.TransformerEncoderLayer(D, HEADS, 4 * D, dropout=0.0, **kw)
            for _ in range(LAYERS)])
        self.head = pt.nn.Linear(D, 2, **kw)

    def forward(self, ids):
        h = self.embed(ids) + self.pos(torch.arange(ids.shape[1],
                                                    device=ids.device))
        for lyr in self.encoder:
            h = lyr(h)
        return self.head(h.mean(dim=1))


def _numpy_state(state):
    """The port's state (or gradients by name) as numpy copies."""
    return {n: t.detach().cpu().numpy().copy() for n, t in state.items()}


@pytest.fixture(scope="module")
def env():
    prev = comm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_FUSED_LN", "interpret")
        mp.setenv("PADDLE_GUARD_MODE", "skip")
        for knob in ("PADDLE_GUARD_SPIKE_FACTOR", "PADDLE_GUARD_CHECK_PARAMS",
                     "PADDLE_FAULT_SPEC", "PADDLE_FLASH_DEFAULT"):
            mp.delenv(knob, raising=False)
        comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
        yield
    comm._state.hybrid_mesh = prev


def _random_state(shapes, seed=9):
    r = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith(("norm1.weight", "norm2.weight")):
            a = 1 + 0.2 * r.randn(*shape)
        elif name.endswith("bias"):
            a = 0.2 * r.randn(*shape)
        elif name in ("embed.weight", "pos.weight"):
            a = r.randn(*shape)
        else:  # [in, out] linear weights
            a = r.randn(*shape) / np.sqrt(shape[0])
        out[name] = a.astype(np.float32)
    return out


def _models():
    jm = JaxBert()
    state = _random_state({k: tuple(v.shape)
                           for k, v in jm.state_dict().items()})
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected
    tm = TorchBert()
    tm.load_state_dict({n: torch.from_numpy(np.asarray(a))
                        for n, a in state.items()}, strict=True)
    return jm, tm


def _batch(seed):
    r = np.random.RandomState(seed)
    return r.randint(0, VOCAB, size=(B, S)), (np.arange(B) % 2)


def _jax_loss(out, y):
    return jnn.functional.cross_entropy(out, y)


def _torch_loss(out, y):
    return pt.nn.functional.cross_entropy(out, y)


def _steps(jm, tm, amp):
    """bench's optimizer and strategy in each package (paddle_tpu's
    optimizer wrapped as ``fleet.distributed_optimizer`` wraps it)."""
    jopt = jax_optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                               parameters=jm.parameters())
    topt = pt.optimizer.AdamW(learning_rate=LR, weight_decay=WD)
    if amp:
        js = jax_fleet.DistributedStrategy()
        js.amp = True
        jopt = _JaxDistributedOptimizer(jopt, js)
        ts = fleet.DistributedStrategy()
        ts.amp = True
        fleet.init(is_collective=True, strategy=ts)
        topt = fleet.distributed_optimizer(topt)
    return JaxTrainStep(jm, _jax_loss, jopt), pt.jit.TrainStep(
        tm, _torch_loss, topt)


def test_layer_norms_take_the_kernel_route(env, monkeypatch):
    """Every encoder LayerNorm (two a layer) goes through the fused
    route's autograd Function, as the reference's does."""
    from paddle_tpu_torch.nn.functional import norm

    _, tm = _models()
    calls = []
    fused = norm._ln.fused_layer_norm
    monkeypatch.setattr(norm._ln, "fused_layer_norm",
                        lambda *a: calls.append(1) or fused(*a))
    tm(torch.as_tensor(_batch(0)[0]))
    assert len(calls) == 2 * LAYERS


def _jax_grads(jm, jstep, ids, y):
    loss_and_grads = jax.jit(jax.value_and_grad(
        lambda p: jstep._loss_of(p, (), None, (jax.numpy.asarray(ids),),
                                 (jax.numpy.asarray(y),))[0]))
    jloss, jgrads = loss_and_grads(tuple(p._data for p in jstep._p_objs))
    name_of = {id(p): n for n, p in jm.named_parameters()}
    return float(jloss), {name_of[id(p)]: np.asarray(g)
                          for p, g in zip(jstep._p_objs, jgrads)}


def _torch_grads(tm, tstep, ids, y):
    with torch.enable_grad(), tstep._amp_guard():
        tloss = tstep.loss_fn(tm(torch.as_tensor(ids)), torch.as_tensor(y))
    tloss.backward()
    return tloss.item(), _numpy_state(
        {n: p.grad for n, p in tm.named_parameters()})


def _amp_layer_types(jm, tm, ids):
    """{layer name: output type} of every layer holding parameters of its
    own, under bf16 O1, from one forward through paddle_tpu's ``jm`` and
    one through the port's ``tm``."""
    types = ({}, {})

    def hook(side, name):
        def record(layer, inputs, out):
            types[side][name] = str(out._data.dtype) if side == 0 \
                else str(out.dtype).replace("torch.", "")
        return record

    handles = [l.register_forward_post_hook(hook(0, n))
               for n, l in jm.named_sublayers()
               if l.parameters(include_sublayers=False)]
    handles += [m.register_forward_hook(hook(1, n))
                for n, m in tm.named_modules()
                if list(m.parameters(recurse=False))]
    try:
        with paddle_tpu.amp.auto_cast(True, level="O1", dtype="bfloat16"):
            jm(paddle_tpu.to_tensor(ids))
        with pt.amp.auto_cast(True, level="O1", dtype="bfloat16"):
            tm(torch.as_tensor(ids))
    finally:
        for h in handles:
            h.remove()
    return types


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "bf16_amp"])
def test_loss_and_gradients_match(env, amp):
    """One batch's loss and gradients; under AMP, the gradients named in
    AMP_READINGS within their readings, and every layer's output type
    paddle_tpu's."""
    jm, tm = _models()
    ids, y = _batch(1)
    jstep, tstep = _steps(jm, tm, amp)
    jloss, want = _jax_grads(jm, jstep, ids, y)
    loss_atol, share = TOL[amp]
    readings = AMP_READINGS if amp else {}
    tloss, got = _torch_grads(tm, tstep, ids, y)
    np.testing.assert_allclose(tloss, jloss, atol=loss_atol, rtol=0)
    assert set(got) == set(want)
    for name, g in got.items():
        assert g.dtype == np.float32, name
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        bound = max(share, AMP_MARGIN * readings.get(name, 0.0))
        assert np.abs(g - want[name]).max() <= bound * scale, name
    if amp:
        jtypes, ttypes = _amp_layer_types(jm, tm, ids)
        assert jtypes == ttypes and "bfloat16" in jtypes.values()


def test_amp_type_check_catches_float32_linear(env, monkeypatch):
    """The control of the AMP checks: a port whose ``linear`` took
    float32 inputs under AMP returns float32 from every Linear where
    paddle_tpu returns bf16, and the type check fails."""
    cast = pt.amp.cast_if_amp

    def cast_linear_up(op_name, tensors):
        if op_name != "linear":
            return cast(op_name, tensors)
        return tuple(t.float() if isinstance(t, torch.Tensor) else t
                     for t in tensors)

    monkeypatch.setattr(pt.amp, "cast_if_amp", cast_linear_up)
    jm, tm = _models()
    jtypes, ttypes = _amp_layer_types(jm, tm, _batch(1)[0])
    assert jtypes["head"] == "bfloat16" and ttypes["head"] == "float32"
    assert jtypes != ttypes


def _jax_losses(jm, jstep):
    return np.array([float(jstep(*_batch(10 + i)).numpy())
                     for i in range(3)])


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "bf16_amp"])
def test_three_adamw_train_steps_match(env, amp):
    jm, tm = _models()
    jstep, tstep = _steps(jm, tm, amp)
    jl = _jax_losses(jm, jstep)
    tl = np.array([tstep(*_batch(10 + i)).item() for i in range(3)])
    bound = TOL[amp][0]
    if amp:  # the measured distance (module docstring)
        bound = max(bound, AMP_MARGIN * AMP_STEP_LOSS_READING)
    assert (np.abs(tl - jl) <= bound).all(), (tl, jl, bound)
    want = {k: np.array(v._data) for k, v in jm.state_dict().items()}
    got = _numpy_state(tm.state_dict())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("form", ["need_weights", "bool_mask", "kdim_vdim",
                                  "causal", "concat_cache", "static_cache",
                                  "decode_at_positions"])
def test_multi_head_attention_forms_match(env, form):
    """The forms of ``MultiHeadAttention`` BERT does not use, in float32
    (eval, so dropout is off): outputs, the returned weights and the
    updated cache."""
    kdim = 96 if form == "kdim_vdim" else None
    jl = jnn.MultiHeadAttention(D, HEADS, dropout=0.1, kdim=kdim, vdim=kdim,
                                need_weights=form == "need_weights",
                                causal=form == "causal")
    tl = pt.nn.MultiHeadAttention(
        D, HEADS, dropout=0.1, kdim=kdim, vdim=kdim,
        need_weights=form == "need_weights", causal=form == "causal",
        device="cpu", generator=torch.Generator().manual_seed(0))
    state = _random_state({k: tuple(v.shape)
                           for k, v in jl.state_dict().items()}, seed=12)
    jl.set_state_dict(state)
    assert tl.set_state_dict(state) == ([], [])
    jl.eval()
    tl.eval()
    r = np.random.RandomState(13)
    q = r.randn(B, S, D).astype(np.float32)
    kv = r.randn(B, S, kdim or D).astype(np.float32)
    args = {"kdim_vdim": (q, kv, kv),
            "bool_mask": (q, None, None, r.rand(B, 1, S, S) > 0.3)
            }.get(form, (q,))
    jargs = [None if a is None else paddle_tpu.to_tensor(a) for a in args]
    targs = [None if a is None else torch.as_tensor(a) for a in args]
    if form == "concat_cache":
        past = r.randn(B, HEADS, 4, D // HEADS).astype(np.float32)
        jout = jl(*jargs, cache=jl.Cache(paddle_tpu.to_tensor(past),
                                         paddle_tpu.to_tensor(past)))
        tout = tl(*targs, cache=tl.Cache(torch.as_tensor(past),
                                         torch.as_tensor(past)))
        jout = (jout[0], jout[1].k, jout[1].v)
        tout = (tout[0], tout[1].k, tout[1].v)
    elif form == "static_cache":
        jc = jl.gen_cache(paddle_tpu.to_tensor(kv), type=jl.StaticCache)
        tc = tl.gen_cache(torch.as_tensor(kv), type=tl.StaticCache)
        jout, tout = jl(jargs[0], cache=jc), tl(targs[0], cache=tc)
    elif form == "decode_at_positions":
        # one new row a slot, written at per-slot positions of an 8-row
        # cache whose earlier rows hold keys and values already
        pos = np.array([3, 5], np.int32)
        zeros = (jl.gen_cache(batch_size=B, max_length=8),
                 tl.gen_cache(batch_size=B, max_length=8))
        assert tuple(zeros[1].k.shape) == tuple(zeros[0].k.shape)
        assert not zeros[1].k.any() and not zeros[1].v.any()
        fill = r.randn(B, HEADS, 8, D // HEADS).astype(np.float32)
        jc = jl.Cache(paddle_tpu.to_tensor(fill), paddle_tpu.to_tensor(fill))
        tc = tl.Cache(torch.tensor(fill), torch.tensor(fill))
        jout = jl(jargs[0][:, :1], cache=jc, pos=paddle_tpu.to_tensor(pos))
        tout = tl(targs[0][:, :1], cache=tc, pos=torch.as_tensor(pos))
        jout = (jout[0], jout[1].k, jout[1].v)
        tout = (tout[0], tout[1].k, tout[1].v)
    else:
        jout, tout = jl(*jargs), tl(*targs)
    jout = jout if isinstance(jout, tuple) else (jout,)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(jout) == len(tout)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.array(b._data),
                                   atol=1e-5, rtol=0)
