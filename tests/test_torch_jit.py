"""``to_static``, ``jit.save``/``load``, ``functional_call`` and
``recompute`` of the port against the JAX package's, on the CPU.

Each case of ``tests/test_jit.py`` runs in both packages on the same numpy
inputs, the port's Layers carrying the JAX Layers' weights (their
``state_dict()`` as numpy): the outputs, gradients, losses and buffers
agree within float32 rounding (rtol 1e-5, atol 1e-6 unless a case says
otherwise; 30 Adam steps within 1e-4), and the program caches hold the
same number of entries. Random draws differ between the packages, so the
dropout case holds the port to the same properties instead (fresh masks
per call from the package's generator, one cache entry, PyTorch's global
generator untouched). Beyond the reference: bench.py's GPT program at 2
layers, d 128 under ``to_static`` (its kernels' plain versions,
``PADDLE_FLASH_DEFAULT`` / ``PADDLE_FUSED_LN=interpret``) trains three
AdamW steps as the JAX package's ``to_static`` does (losses within 2e-5,
parameters within 1e-4), and its capture records the kernels' custom ops.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.distributed import comm as jcomm

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import comm as tcomm
from test_torch_dygraph_gpt import (SMALL, _batch, _bench_lm_loss,
                                    _bench_texts, _gpt_class, _gpt_medium)
from test_torch_ops_math import cpu_device  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _simple_net(pkg):
    nn, F = pkg.nn, pkg.nn.functional

    class SimpleNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 8)
            self.fc2 = nn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(F.relu(self.fc1(x)))

    return SimpleNet()


def _carry(jlayer, tlayer):
    """The JAX layer's weights into the port's."""
    missing, unexpected = tlayer.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()})
    assert missing == [] and unexpected == []
    return tlayer


def _pair(make=_simple_net):
    paddle_tpu.seed(0)
    j = make(paddle_tpu)
    return j, _carry(j, make(pt))


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return np.asarray(t.numpy())


def test_to_static_matches_eager_and_paddle_tpu():
    j, t = _pair()
    x = _x((3, 4))
    eager = t(pt.to_tensor(x)).numpy()
    want = _np(paddle_tpu.jit.to_static(j)(paddle_tpu.to_tensor(x)))
    got = pt.jit.to_static(t)(pt.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, eager, rtol=0, atol=0)
    np.testing.assert_allclose(got, want, **TOL)


def test_to_static_gradients_match_paddle_tpu():
    j, t = _pair()
    x = _x((3, 4))
    sj, st = paddle_tpu.jit.to_static(j), pt.jit.to_static(t)
    lj = paddle_tpu.mean(sj(paddle_tpu.to_tensor(x)))
    lj.backward()
    lt = pt.mean(st(pt.to_tensor(x)))
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    jp = dict(j.named_parameters())
    for name, p in t.named_parameters():
        np.testing.assert_allclose(p.gradient(), jp[name].gradient(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_to_static_training_converges_like_paddle_tpu():
    """30 Adam steps through a captured program: the optimizer's updates
    of the live parameters are seen by every next call."""
    j, t = _pair()
    x, y = _x((16, 4), 1), np.random.RandomState(2).randint(0, 2, 16)
    runs = []
    for pkg, net in ((paddle_tpu, j), (pt, t)):
        snet = pkg.jit.to_static(net)
        opt = pkg.optimizer.Adam(learning_rate=0.05,
                                 parameters=snet.parameters())
        xs, ys = pkg.to_tensor(x), pkg.to_tensor(y)
        losses = []
        for _ in range(30):
            loss = pkg.nn.functional.cross_entropy(snet(xs), ys)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        runs.append(losses)
        assert len(snet.forward.program_cache) == 1
    np.testing.assert_allclose(runs[1], runs[0], rtol=0, atol=1e-4)
    assert runs[1][-1] < runs[1][0]


def test_program_cache_per_shape():
    sizes = []
    for pkg in (paddle_tpu, pt):
        sf = pkg.jit.to_static(_simple_net(pkg))
        got = []
        for rows in (2, 2, 5):
            sf(pkg.to_tensor(_x((rows, 4))))
            got.append(len(sf.forward.program_cache))
        sizes.append(got)
    assert sizes[0] == sizes[1] == [1, 1, 2]


def test_cache_invalidated_by_train_eval():
    for pkg in (paddle_tpu, pt):
        net = pkg.nn.Sequential(pkg.nn.Linear(4, 4), pkg.nn.Dropout(0.5))
        sf = pkg.jit.StaticFunction(net.forward, layer=net)
        net.train()
        sf(pkg.to_tensor(_x((2, 4))))
        net.eval()
        sf(pkg.to_tensor(_x((2, 4))))
        assert len(sf.program_cache) == 2
        x = pkg.to_tensor(_x((2, 4), 3))
        np.testing.assert_allclose(_np(sf(x)), _np(sf(x)))


def test_static_function_decorator_on_method():
    outs = []
    for pkg in (paddle_tpu, pt):
        class Net(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = pkg.nn.Linear(4, 4)

            @pkg.jit.to_static
            def forward(self, x):
                return self.fc(x) * 2.0

        pkg.seed(0)
        net = Net()
        if pkg is pt:
            _carry(jnet, net)
        else:
            jnet = net
        x = pkg.to_tensor(_x((2, 4)))
        out = net(x)
        np.testing.assert_allclose(_np(out), _np(net.fc(x) * 2.0),
                                   rtol=1e-5)
        pkg.mean(out).backward()
        assert net.fc.weight.grad is not None
        outs.append((_np(out), net.fc.weight.gradient()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, **TOL)


def test_batchnorm_buffers_written_back_to_the_live_layer():
    j = paddle_tpu.nn.BatchNorm1D(4)
    t = _carry(j, pt.nn.BatchNorm1D(4))
    x = _x((8, 4, 5)) + 3.0
    got = []
    for pkg, bn in ((paddle_tpu, j), (pt, t)):
        bn.train()
        sf = pkg.jit.StaticFunction(bn.forward, layer=bn)
        before = _np(bn._mean).copy()
        out = sf(pkg.to_tensor(x))
        assert not np.allclose(before, _np(bn._mean))
        got.append((_np(out), _np(bn._mean), _np(bn._variance)))
    for a, b in zip(*got):
        np.testing.assert_allclose(b, a, **TOL)


def test_dropout_rng_varies_under_jit_from_the_package_generator():
    net = pt.nn.Dropout(0.5)
    net.train()
    sf = pt.jit.StaticFunction(net.forward, layer=net)
    x = pt.ones([32, 32])
    torch_state = torch.get_rng_state()
    prev = pt.core.random.get_seed()
    pt.seed(5)
    a, b = sf(x).numpy(), sf(x).numpy()
    pt.seed(5)
    again = sf(x).numpy()
    pt.seed(prev)
    assert not np.allclose(a, b)  # fresh masks per call, one program
    assert len(sf.program_cache) == 1
    np.testing.assert_array_equal(again, a)  # from the package's generator
    assert set(np.unique(a)) <= {0.0, 2.0}
    assert torch.equal(torch.get_rng_state(), torch_state)
    graph = next(iter(sf.program_cache.values())).exported.graph
    assert any("paddle_tpu_torch.draw" in str(n.target) for n in graph.nodes)
    # the reference's own property, for comparison
    jnet = paddle_tpu.nn.Dropout(0.5)
    jnet.train()
    jsf = paddle_tpu.jit.StaticFunction(jnet.forward, layer=jnet)
    jx = paddle_tpu.ones([32, 32])
    assert not np.allclose(_np(jsf(jx)), _np(jsf(jx)))


def _cond_fn(pkg):
    def f(x):
        return pkg.jit.cond(pkg.sum(x) > 0, lambda a: a * 2.0,
                            lambda a: a - 1.0, x)

    return f


def _loop_fn(pkg):
    def loop(n):
        i = pkg.to_tensor(0)
        s = pkg.to_tensor(0)
        i, s = pkg.jit.while_loop(lambda i, s: i < n,
                                  lambda i, s: (i + 1, s + i), [i, s])
        return s

    return loop


def test_jit_cond_and_while():
    got = []
    for pkg in (paddle_tpu, pt):
        f = _cond_fn(pkg)
        sf = pkg.jit.to_static(f)
        loop = pkg.jit.to_static(_loop_fn(pkg))
        got.append([_np(f(pkg.to_tensor([1.0, 2.0]))),
                    _np(sf(pkg.to_tensor([1.0, 2.0]))),
                    _np(sf(pkg.to_tensor([-5.0, 1.0]))),
                    _np(loop(pkg.to_tensor(5))),
                    _np(loop(pkg.to_tensor(7)))])
    for a, b in zip(*got):
        np.testing.assert_allclose(b, a)
    np.testing.assert_allclose(got[1][:3], [[2, 4], [2, 4], [-6, 0]])
    assert got[1][3] == 10 and got[1][4] == 21


def test_captured_control_flow_is_the_higher_order_ops():
    """The capture records torch's cond and while_loop (one program per
    shape picks its branch, or loops, at run time)."""
    sf = pt.jit.to_static(_cond_fn(pt))
    sf(pt.to_tensor([1.0, 2.0]))
    loop = pt.jit.to_static(_loop_fn(pt))
    loop(pt.to_tensor(5))
    for fn, op in ((sf, "cond"), (loop, "while_loop")):
        (prog,) = fn.program_cache.values()
        assert any(str(n.target) == op
                   or getattr(n.target, "__name__", "") == op
                   for n in prog.exported.graph.nodes), op


def test_capture_refuses_a_python_branch_on_a_tensor(monkeypatch):
    """Without the AST conversion, a Python ``if`` on a tensor cannot be
    captured: ``to_static`` raises, naming the function, instead of
    running it unconverted."""
    monkeypatch.setenv("PADDLE_TPU_NO_AST", "1")

    def branchy(x):
        if pt.sum(x) > 0:
            return x * 2.0
        return x - 1.0

    sf = pt.jit.to_static(branchy)
    with pytest.raises(RuntimeError, match="could not capture branchy"):
        sf(pt.to_tensor([1.0, 2.0]))


def test_jit_save_load_roundtrip(tmp_path):
    j, t = _pair()
    j.eval()
    t.eval()
    x = _x((2, 4))
    got = []
    for pkg, net in ((paddle_tpu, j), (pt, t)):
        path = os.path.join(tmp_path, pkg.__name__, "model")
        pkg.jit.save(net, path, input_spec=[pkg.jit.InputSpec([2, 4],
                                                              "float32")])
        loaded = pkg.jit.load(path)
        got.append((_np(net(pkg.to_tensor(x))), _np(loaded(pkg.to_tensor(
            x)))))
    np.testing.assert_allclose(got[1][1], got[1][0], rtol=0, atol=0)
    np.testing.assert_allclose(got[1][1], got[0][1], **TOL)
    assert isinstance(pt.jit.load(os.path.join(tmp_path, "paddle_tpu_torch",
                                               "model")),
                      pt.jit.TranslatedLayer)


def test_recompute_grads_match_paddle_tpu():
    j, t = _pair()
    x = _x((4, 4))
    got = []
    for pkg, net in ((paddle_tpu, j), (pt, t)):
        pkg.mean(pkg.jit.recompute(net, pkg.to_tensor(x))).backward()
        got.append({n: p.gradient() for n, p in net.named_parameters()})
    for name, g in got[1].items():
        np.testing.assert_allclose(g, got[0][name], **TOL, err_msg=name)


def test_recompute_runs_the_segment_again_with_its_draws():
    """The recomputation is real (the segment runs twice) and draws the
    forward's dropout masks again, so its gradients equal the plain
    call's from the same generator state."""
    pt.seed(4)
    net = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.Dropout(0.5),
                           pt.nn.Linear(8, 2))
    twin = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.Dropout(0.5),
                            pt.nn.Linear(8, 2))
    twin.set_state_dict(net.state_dict())
    calls = []
    net[0].register_forward_post_hook(lambda *a: calls.append(1))
    x = pt.to_tensor(_x((16, 4)))
    prev = pt.core.random.get_seed()
    pt.seed(9)
    # the segment's generator made on first use (inside the forward) too
    pt.core.random._generators.pop(x._data.device, None)
    pt.mean(pt.jit.recompute(net, x) ** 2).backward()
    pt.seed(9)
    pt.mean(twin(x) ** 2).backward()
    pt.seed(prev)
    assert len(calls) == 2
    for a, b in zip(net.parameters(), twin.parameters()):
        np.testing.assert_allclose(a.gradient(), b.gradient(), rtol=0,
                                   atol=0)


def test_functional_call_matches_paddle_tpu_and_is_pure():
    j = paddle_tpu.nn.BatchNorm1D(5)
    t = _carry(j, pt.nn.BatchNorm1D(5))
    x = _x((8, 5)) * 3 + 1
    got = []
    for pkg, m in ((paddle_tpu, j), (pt, t)):
        m.train()
        params, buffers = pkg.jit.raw_state(m)
        before = _np(dict(m.named_buffers())["_mean"]).copy()
        out, new_b = pkg.jit.functional_call(m, params, buffers,
                                             (pkg.to_tensor(x),))
        np.testing.assert_array_equal(
            _np(dict(m.named_buffers())["_mean"]), before)
        assert not np.allclose(np.asarray(new_b["_mean"]), before)
        got.append((np.asarray(out), np.asarray(new_b["_mean"])))
    for a, b in zip(*got):
        np.testing.assert_allclose(b, a, **TOL)
    params, _ = pt.jit.raw_state(t)
    zeroed = {k: torch.zeros_like(v) for k, v in params.items()}
    out, _ = pt.jit.functional_call(t, zeroed, None, (pt.to_tensor(x),))
    np.testing.assert_allclose(out.numpy(), 0.0, atol=1e-6)
    with pytest.raises(KeyError, match="missing parameter"):
        pt.jit.functional_call(t, {}, None, (pt.to_tensor(x),))


def test_functional_call_gradients_and_key():
    """Gradients flow to the parameters passed; ``key`` makes the call's
    dropout a function of it."""
    net = pt.nn.Sequential(pt.nn.Linear(6, 8), pt.nn.Dropout(0.5),
                           pt.nn.Linear(8, 3))
    params, buffers = pt.jit.raw_state(net)
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x = pt.to_tensor(_x((4, 6)))
    out, _ = pt.jit.functional_call(net, params, buffers, (x,), key=3)
    (out ** 2).sum().backward()
    assert all(p.grad is not None for p in params.values())
    again, _ = pt.jit.functional_call(net, params, buffers, (x,), key=3)
    other, _ = pt.jit.functional_call(net, params, buffers, (x,), key=4)
    np.testing.assert_array_equal(again.detach().numpy(),
                                  out.detach().numpy())
    assert not np.allclose(other.detach().numpy(), out.detach().numpy())
    named = pt.jit.named_state(net)
    assert list(named[0]) == list(params)


def test_input_spec_and_concrete_program():
    spec = pt.jit.InputSpec([None, 4], "float32", name="x")
    assert spec.shape == (None, 4) and spec.name == "x"
    assert repr(spec) == repr(paddle_tpu.jit.InputSpec([None, 4]))
    assert pt.jit.InputSpec.from_tensor(pt.ones([2, 3])).shape == (2, 3)
    sf = pt.jit.to_static(_cond_fn(pt))
    with pytest.raises(NotImplementedError):
        sf.concrete_program()
    assert pt.jit.declarative is pt.jit.to_static


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_FLASH_DEFAULT", "interpret")
    monkeypatch.setenv("PADDLE_FUSED_LN", "interpret")
    jcomm._state.hybrid_mesh = tcomm._mesh = None
    yield
    jcomm._state.hybrid_mesh = tcomm._mesh = None


def _gpt_steps(pkg, model, loss_of, ids, labels, steps=3):
    opt = pkg.optimizer.AdamW(learning_rate=1e-4, epsilon=1e-6,
                              weight_decay=0.01,
                              parameters=model.parameters())
    x, y = pkg.to_tensor(ids), pkg.to_tensor(labels)
    losses = []
    for _ in range(steps):
        loss = loss_of(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(np.asarray(loss.numpy())))
    return losses


def test_gpt_program_under_to_static_trains_like_paddle_tpu(interpret):
    gpt, _ = _bench_texts()
    paddle_tpu.seed(0)
    jm = _gpt_class(gpt)(**SMALL)
    tm = _carry(jm, _gpt_class(_gpt_medium)(**SMALL))
    jnn = paddle_tpu.nn

    def jax_loss(h, labels):
        d = h.shape[-1]
        return jnn.functional.fused_linear_cross_entropy(
            h.reshape([-1, d]), jm.head.weight, jm.head.bias,
            labels.reshape([-1]))

    ids, labels = _batch()
    jm = paddle_tpu.jit.to_static(jm)
    want = _gpt_steps(paddle_tpu, jm, jax_loss, ids, labels)
    tm = pt.jit.to_static(tm)
    got = _gpt_steps(pt, tm, _bench_lm_loss(tm), ids, labels)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert got[-1] < got[0]
    (prog,) = tm.forward.program_cache.values()
    ops = {str(n.target) for n in prog.exported.graph.nodes}
    assert {"paddle_tpu_torch.flash_attention_fwd.default",
            "paddle_tpu_torch.layer_norm_fwd.default",
            "paddle_tpu_torch.add_layer_norm_fwd.default"} <= ops
    jsd = jm.state_dict()
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), _np(jsd[k]), rtol=0,
                                   atol=1e-4, err_msg=k)
