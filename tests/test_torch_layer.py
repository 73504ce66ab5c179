"""The port's ``nn.Layer``, ``ParamAttr`` and initializers against
paddle_tpu's, and the layers' signatures (the JAX package's positional
order, ``weight_attr``/``bias_attr``).

- Each layer built with the same positional arguments in both packages
  has the same parameter and buffer names and shapes (paddle's layout: a
  Linear weight is ``[in, out]``), and a ``paddle_tpu`` model's
  ``state_dict()`` as numpy arrays loads into the port's by
  ``set_state_dict`` with no transposes, after which both compute the same
  outputs (float32, rtol = atol = 1e-5).
- Initializers are drawn from other streams in the two packages, so they
  are held to their law: the mean and standard deviation of 40,000 draws
  within 3% of the law's scale (about five standard errors), bounds for
  the uniform and truncated draws, exact values for Constant and Assign.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import comm
from paddle_tpu.distributed import meta_parallel as jmp

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import meta_parallel as tmp
from test_torch_ops_math import cpu_device  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def mesh():
    """The JAX package's parallel layers read a one-device hybrid mesh."""
    prev = comm._state.hybrid_mesh
    comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
    yield
    comm._state.hybrid_mesh = prev


def _shapes(layer):
    return {k: tuple(np.shape(v.numpy() if hasattr(v, "numpy") else v))
            for k, v in layer.state_dict().items()}


def _carry(jlayer, tlayer):
    state = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    missing, unexpected = tlayer.set_state_dict(state)
    assert missing == [] and unexpected == []


def _same_outputs(jlayer, tlayer, *xs):
    jout = jlayer(*(paddle_tpu.to_tensor(x) for x in xs))
    tout = tlayer(*(pt.to_tensor(x) for x in xs))
    assert isinstance(tout, pt.Tensor)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout.numpy()), **TOL)


LAYERS = [
    ("Linear", (6, 4), {}, (3, 6)),
    ("Linear", (6, 4, None, False), {}, (3, 6)),
    ("Embedding", (10, 4), {}, None),
    ("LayerNorm", (8, 1e-6), {}, (3, 8)),
    ("Conv2D", (3, 4, 3, 1, 1), {}, (2, 3, 6, 6)),
    ("Conv2D", (3, 4, 3, 2, 1, 1, 1, "zeros", None, False), {},
     (2, 3, 6, 6)),
    ("BatchNorm2D", (4,), {}, (2, 4, 3, 3)),
    ("MaxPool2D", (3, 2, 1, True), {}, (2, 3, 7, 7)),
    ("AdaptiveAvgPool2D", ((2, 3),), {}, (2, 3, 6, 6)),
    ("MultiHeadAttention", (8, 2), {}, (2, 5, 8)),
    ("TransformerEncoderLayer", (8, 2, 16, 0.0), {}, (2, 5, 8)),
]


@pytest.mark.parametrize("name,args,kw,x", LAYERS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(LAYERS)])
def test_layer_state_loads_as_it_is(name, args, kw, x):
    jl, tl = getattr(jnn, name)(*args, **kw), getattr(nn, name)(*args, **kw)
    assert _shapes(tl) == _shapes(jl)
    _carry(jl, tl)
    if name == "BatchNorm2D":
        jl.eval()
        tl.eval()
    if x is None:
        ids = np.array([[1, 2, 3], [9, 2, 0]])
        _same_outputs(jl, tl, ids)
    else:
        _same_outputs(jl, tl, np.random.RandomState(0).randn(*x).astype(
            np.float32))


PARALLEL = [
    ("ColumnParallelLinear", (8, 12), {}), ("RowParallelLinear", (12, 8), {}),
    ("ColumnParallelLinear", (8, 12, None, False), {}),
    ("ParallelMultiHeadAttention", (16, 4), {}),
    ("ParallelMultiHeadAttention", (16, 4, 0.0, False), {}),
    ("ParallelGPTBlock", (16, 4, 32), {}),
    ("ParallelGPTBlock", (16, 4, None, 0.0, True, False), {}),
]


@pytest.mark.parametrize("name,args,kw", PARALLEL,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(PARALLEL)])
def test_parallel_layer_state_loads_as_it_is(mesh, name, args, kw):
    jl, tl = getattr(jmp, name)(*args, **kw), getattr(tmp, name)(*args, **kw)
    assert _shapes(tl) == _shapes(jl)
    _carry(jl, tl)
    x = np.random.RandomState(1).randn(2, 16, args[0]).astype(np.float32)
    _same_outputs(jl, tl, x)


def test_parallel_gpt_block_arguments_in_the_jax_order(mesh):
    """The fourth positional argument is dropout in both packages (it was
    ``mp`` in the port); ``causal`` and ``use_flash_attention`` follow."""
    for pkg in (jmp, tmp):
        blk = pkg.ParallelGPTBlock(16, 4, None, 0.1)
        assert blk.dropout == 0.1 and blk.attn.dropout == 0.1
        blk = pkg.ParallelGPTBlock(16, 4, None, 0.0, False, False)
        assert blk.attn.causal is False
        assert blk.attn.use_flash_attention is False
        with pytest.raises(ValueError):
            pkg.ParallelMultiHeadAttention(16, 4, 0.1,
                                           use_flash_attention=True)
    # mp = 2 needs a hybrid mesh of mp 2 (tests/test_torch_tensor_parallel.py)
    with pytest.raises(ValueError, match="mp degree is 1"):
        tmp.ParallelGPTBlock(16, 4, mp=2)


def test_use_flash_attention_routes(monkeypatch):
    """``use_flash_attention=False`` is the dense route even where the
    policy would route the kernel; ``None`` follows PADDLE_FLASH_DEFAULT
    (on the CPU, ``interpret``); ``True`` forces the kernel's route."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    x = torch.randn(2, 16, 16)
    monkeypatch.setenv("PADDLE_FLASH_DEFAULT", "interpret")
    calls = []
    real = fa.flash_attention_fwd_plain
    monkeypatch.setattr(fa, "flash_attention_fwd_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for flag, routed in ((None, True), (False, False), (True, True)):
        calls.clear()
        tmp.ParallelMultiHeadAttention(16, 4, use_flash_attention=flag)(x)
        assert bool(calls) is routed, flag
    monkeypatch.setenv("PADDLE_FLASH_DEFAULT", "0")
    calls.clear()
    tmp.ParallelMultiHeadAttention(16, 4)(x)
    assert not calls


class Net(nn.Layer):
    """A user's layer: its forward gets ``Tensor``s as passed."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(4, 8)
        self.fc2 = nn.Linear(8, 2, weight_attr=nn.ParamAttr(
            name="fc2_w", initializer=nn.initializer.Constant(0.5)))
        self.scale = self.create_parameter([2], default_initializer=nn.
                                           initializer.Constant(2.0))
        self.register_buffer("steps", pt.zeros([1]))
        self.register_buffer("scratch", pt.ones([1]), persistable=False)
        self.seen = []

    def forward(self, x):
        self.seen.append(type(x).__name__)
        return self.fc2(pt.tanh(self.fc1(x))) * self.scale


def test_layer_surface():
    net = Net()
    # a layer's own parameters first, then its sublayers', as in both
    names = [n for n, _ in net.named_parameters()]
    assert names == ["scale", "fc1.weight", "fc1.bias", "fc2.weight",
                     "fc2.bias"]
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 5
    assert all(isinstance(p, pt.Parameter) for p in net.parameters())
    assert list(net.state_dict()) == ["scale", "steps"] + names[1:]
    assert net.fc2.weight.name == "fc2_w"
    np.testing.assert_array_equal(net.fc2.weight.numpy(), 0.5)
    assert net.sublayers() == [net.fc1, net.fc2]
    assert [n for n, _ in net.named_sublayers()] == ["fc1", "fc2"]
    assert net.full_name() != Net().full_name()
    out = net(pt.to_tensor(np.ones((3, 4), np.float32)))
    assert net.seen == ["Tensor"] and isinstance(out, pt.Tensor)
    out.sum().backward()
    assert all(p.grad is not None for p in net.parameters())
    assert net.scale.gradient().shape == (2,)
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())
    net.eval()
    assert not net.training and not net.fc1.training
    net.train()
    assert net.fc2.training
    sub = net.add_sublayer("extra", nn.Linear(2, 2))
    assert net.extra is sub
    p = net.add_parameter("bias2", net.create_parameter([2], is_bias=True))
    assert net.bias2 is p and float(p.numpy().sum()) == 0.0


def test_forward_hooks_and_torch_inputs():
    net = Net()
    log = []
    h1 = net.register_forward_pre_hook(lambda m, inp: log.append("pre"))
    h2 = net.register_forward_post_hook(
        lambda m, inp, out: out * 0.0)
    out = net(torch.ones(3, 4))
    assert log == ["pre"] and float(out.sum()) == 0.0
    h1.remove()
    h2.remove()
    # a built-in layer on torch tensors returns torch tensors, as before
    lin = nn.Linear(4, 2)
    assert type(lin(torch.ones(1, 4))) is torch.Tensor
    assert isinstance(lin(pt.ones([1, 4])), pt.Tensor)


def _user_layers(pkg):
    """A user's layer that calls Paddle's own meanings (``split`` into
    sections, ``astype``, ``transpose(perm)``), and two user subclasses of
    ``nn.Linear``: one keeps its ``forward``, one wraps it."""
    class Halves(pkg.nn.Layer):
        def forward(self, x):
            a, b = x.split(2, axis=-1)
            y = pkg.concat([b, a.transpose([1, 0]).transpose([1, 0])], -1)
            return y.astype("float32") * 2.0

    class KeepLinear(pkg.nn.Linear):
        pass

    class WrapLinear(pkg.nn.Linear):
        def forward(self, x):
            return super().forward(x.astype("float32")).split(2, axis=-1)[1]

    return Halves, KeepLinear, WrapLinear


@pytest.mark.parametrize("case", ["sequential", "keep_forward",
                                  "wrap_forward"])
def test_user_layers_keep_paddle_meanings(case):
    """Each layer converts its own arguments: a user's layer inside
    ``Sequential`` gets ``Tensor``s and Paddle's meanings, and a user
    subclass of a built-in layer converts as the built-in one does; the
    outputs and input gradients equal paddle_tpu's (rtol = atol = 1e-5)."""
    def build(pkg):
        halves, keep, wrap = _user_layers(pkg)
        return {"sequential": lambda: pkg.nn.Sequential(
                    halves(), pkg.nn.Linear(6, 3)),
                "keep_forward": lambda: keep(6, 3),
                "wrap_forward": lambda: wrap(6, 4)}[case]()

    x = np.random.RandomState(2).randn(4, 6).astype(np.float32)
    jl, tl = build(paddle_tpu), build(pt)
    _carry(jl, tl)
    outs = []
    for pkg, layer in ((paddle_tpu, jl), (pt, tl)):
        xt = pkg.to_tensor(x, stop_gradient=False)
        out = layer(xt)
        assert isinstance(out, pkg.Tensor)
        (out * out).sum().backward()
        outs.append((np.asarray(out.numpy()), np.asarray(xt.grad.numpy())))
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, j, **TOL)


def test_embedding_padding_idx():
    """Ids equal to ``padding_idx`` look up zeros and send no gradient
    (the JAX package's rule; its own layer cannot be built with one here:
    it writes into a read-only numpy view of its weight)."""
    emb = nn.Embedding(6, 3, padding_idx=-1)
    np.testing.assert_array_equal(emb.weight.numpy()[5], 0.0)
    with torch.no_grad():
        emb.weight[5] = 1.0
    ids = pt.to_tensor(np.array([[5, 1], [2, 5]]))
    out = emb(ids)
    np.testing.assert_array_equal(out.numpy()[0, 0], 0.0)
    out.sum().backward()
    np.testing.assert_array_equal(emb.weight.gradient()[5], 0.0)
    np.testing.assert_array_equal(emb.weight.gradient()[1], 1.0)


def test_param_attr():
    reg = pt.regularizer.L2Decay(0.1)
    lin = nn.Linear(3, 2, weight_attr=nn.ParamAttr(
        trainable=False, regularizer=reg, need_clip=False), bias_attr=False)
    assert lin.bias is None
    assert not lin.weight.trainable and lin.weight.stop_gradient
    assert lin.weight.regularizer is reg and lin.weight.need_clip is False
    lin2 = nn.Linear(3, 2, weight_attr="w2",
                     bias_attr=nn.initializer.Constant(1.0))
    assert lin2.weight.name == "w2"
    np.testing.assert_array_equal(lin2.bias.numpy(), 1.0)
    for pkg in (jnn, nn):
        lr_lin = pkg.Linear(3, 2, weight_attr=pkg.ParamAttr(
            learning_rate=0.5))
        assert lr_lin.weight.optimize_attr["learning_rate"] == 0.5
        assert lr_lin.bias.optimize_attr["learning_rate"] == 1.0
        attr = pkg.ParamAttr._to_attr(None)
        assert (attr.learning_rate, attr.trainable, attr.need_clip) == (
            1.0, True, True)


def test_parameter_surface():
    lin = nn.Linear(3, 2)
    w = lin.weight
    w.set_value(np.full((3, 2), 0.25, np.float32))
    np.testing.assert_array_equal(w.numpy(), 0.25)
    assert w.gradient() is None and w.persistable
    w.stop_gradient = True
    assert not w.requires_grad
    w.trainable = True
    assert not w.stop_gradient
    with pytest.raises(ValueError):
        w.set_value(np.zeros((2, 3), np.float32))
    assert w.optimize_attr == {"learning_rate": 1.0}


def _draw(init, shape=(200, 200), seed=0):
    pt.seed(seed)
    return init(list(shape), "float32").numpy().astype(np.float64)


def _law(v, mean, std):
    assert abs(v.mean() - mean) < 0.03 * max(std, 1e-3)
    assert abs(v.std() - std) < 0.03 * std


def test_initializers_follow_their_laws():
    I = nn.initializer
    np.testing.assert_array_equal(_draw(I.Constant(0.3)), np.float32(0.3))
    u = _draw(I.Uniform(-2.0, 3.0))
    assert u.min() >= -2 and u.max() < 3
    _law(u, 0.5, 5 / math.sqrt(12))
    _law(_draw(I.Normal(1.0, 2.0)), 1.0, 2.0)
    t = _draw(I.TruncatedNormal(0.5, 2.0))
    assert t.min() >= 0.5 - 4 and t.max() <= 0.5 + 4
    _law(t, 0.5, 2.0 * 0.8796)  # the sd of N(0, 1) cut at +-2
    fi, fo = 200, 200
    xu = _draw(I.XavierUniform())
    assert np.abs(xu).max() <= math.sqrt(6 / (fi + fo))
    _law(xu, 0.0, math.sqrt(2 / (fi + fo)))
    _law(_draw(I.XavierNormal()), 0.0, math.sqrt(2 / (fi + fo)))
    _law(_draw(I.KaimingNormal()), 0.0, math.sqrt(2 / fi))
    ku = _draw(I.KaimingUniform())
    assert np.abs(ku).max() <= math.sqrt(6 / fi)
    _law(ku, 0.0, math.sqrt(2 / fi))
    conv = _draw(I.KaimingNormal(), (64, 16, 5, 5))  # fan-in 16 * 25
    _law(conv, 0.0, math.sqrt(2 / 400))
    val = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(_draw(I.Assign(val), (2, 3)), val)
    with pytest.raises(ValueError):
        I.Assign(val)([3, 2], "float32")


def test_seed_reproduces_layers_and_defaults():
    pt.seed(7)
    a = nn.Linear(5, 3)
    pt.seed(7)
    b = nn.Linear(5, 3)
    np.testing.assert_array_equal(a.weight.numpy(), b.weight.numpy())
    assert tuple(a.weight.shape) == (5, 3) and a.weight.dtype == torch.float32
    np.testing.assert_array_equal(a.bias.numpy(), 0.0)
    c = nn.Linear(5, 3)
    assert not np.array_equal(a.weight.numpy(), c.weight.numpy())
    g = torch.Generator().manual_seed(1)
    d = nn.Linear(5, 3, generator=g)
    e = nn.Linear(5, 3, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(d.weight.numpy(), e.weight.numpy())
    # a layer's dropout draws from the package's generator when given none
    drop = nn.Dropout(0.5)
    x = pt.ones([1000])
    pt.seed(3)
    m1 = drop(x).numpy()
    pt.seed(3)
    np.testing.assert_array_equal(drop(x).numpy(), m1)


def test_layer_to_and_containers():
    seq = nn.Sequential(nn.Linear(2, 3), nn.ReLU(), nn.Linear(3, 1))
    assert [n for n, _ in seq.named_parameters()] == [
        "0.weight", "0.bias", "2.weight", "2.bias"]
    assert isinstance(seq[0:2], nn.Sequential)
    ll = nn.LayerList([nn.Linear(2, 2)])
    ll.append(nn.Linear(2, 2))
    assert len(ll) == 2 and isinstance(ll, nn.Layer)
    seq.to(dtype="float64")
    assert seq[0].weight.dtype == torch.float64
    seq.astype("float32")
    assert seq[0].weight.dtype == torch.float32
    seq.to("cpu")
    out = seq(pt.ones([4, 2]))
    assert out.shape == [4, 1]
