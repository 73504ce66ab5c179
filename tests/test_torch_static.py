"""The port's static graphs against paddle_tpu's: ``Program``,
``Executor``, ``static.nn`` and the control flow.

Each program is built in both packages from the same script; the port's
parameters are carried from the JAX package's program
(``static.program.set_program_parameters``, by ``all_parameters()``
order, names and shapes checked) or its layers (``set_state_dict``), and
both executors run on the same numpy feeds. JAX runs on the CPU, the port
on CPU tensors.

Tolerances: losses and outputs within ``rtol = atol = 1e-5`` (float32
products and sums in different orders and libraries). Parameters after
Adam steps: LeNet's within ``atol = 1e-5``; BERT's (AdamW 1e-4, three
steps) each element within 3 lr of the reference's (Adam moves an element
by about lr a step whatever its gradient's size, so an element whose
gradient is zero but for rounding, as the attention's key bias's is, may
move either way) and all updates together within 1e-2 of the reference's
in L2 norm.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.static.nn as jsn

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
import paddle_tpu_torch.static.nn as tsn
from paddle_tpu_torch.static.program import set_program_parameters
from chip_smoke import static_bert, static_bert_program
from test_torch_ops_math import cpu_device  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = (paddle_tpu, pt)


@pytest.fixture(autouse=True)
def static_modes():
    """Each test starts and ends in dygraph mode in both packages."""
    yield
    for pkg in PKGS:
        pkg.disable_static()


def _programs(pkg):
    pkg.enable_static()
    return pkg.static.Program(), pkg.static.Program()


def _carry(jmain, tmain):
    set_program_parameters(tmain, [(p.name, np.asarray(p._data))
                                   for p in jmain.all_parameters()])


def _build_both(build):
    """``build(pkg, static_nn)`` in a fresh program of each package ->
    ((jax main, its result), (port main, its result)), the port's
    parameters carried from the JAX package's."""
    out = []
    for pkg, sn in ((paddle_tpu, jsn), (pt, tsn)):
        main, startup = _programs(pkg)
        with pkg.static.program_guard(main, startup):
            res = build(pkg, sn)
        out.append((main, res))
    _carry(out[0][0], out[1][0])
    return out


def _run_both(built, feed, fetch=None):
    res = []
    for pkg, (main, r) in zip(PKGS, built):
        fl = fetch(r) if fetch else [r]
        res.append(pkg.static.Executor().run(main, feed=feed, fetch_list=fl))
    return res


# -- whole programs ------------------------------------------------------


def _lenet(pkg):
    """tests/test_static.py's LeNet-style script."""
    nn, F = pkg.nn, pkg.nn.functional
    img = pkg.static.data(name="img", shape=[-1, 1, 28, 28], dtype="float32")
    label = pkg.static.data(name="label", shape=[-1], dtype="int64")
    conv = nn.Conv2D(1, 6, 5, padding=2)
    pool = nn.MaxPool2D(2, 2)
    fc1 = nn.Linear(6 * 14 * 14, 64)
    fc2 = nn.Linear(64, 10)
    h = pool(F.relu(conv(img)))
    h = pkg.reshape(h, [-1, 6 * 14 * 14])
    logits = fc2(F.relu(fc1(h)))
    loss = F.cross_entropy(logits, label)
    pkg.optimizer.Adam(learning_rate=3e-3).minimize(loss)
    return loss, logits


def _digits(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1, 28, 28).astype(np.float32) * 0.1
    y = rng.randint(0, 10, (n,)).astype(np.int64)
    for i, c in enumerate(y):
        x[i, 0, c, c] = 1.0
    return x, y


def test_lenet_program_runs_as_the_reference():
    built = _build_both(lambda pkg, sn: _lenet(pkg))
    losses = [[], []]
    for step in range(5):
        x, y = _digits(32, step)
        outs = _run_both(built, {"img": x, "label": y},
                         lambda r: [r[0], r[1]])
        for i, (lv, logits) in enumerate(outs):
            losses[i].append(float(lv))
        np.testing.assert_allclose(outs[1][1], outs[0][1], **TOL)
    np.testing.assert_allclose(losses[1], losses[0], **TOL)
    assert losses[1][-1] < losses[1][0]
    jp, tp = built[0][0].all_parameters(), built[1][0].all_parameters()
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a._data),
                                   atol=1e-5)


BERT_SMALL = dict(vocab=512, d=128, heads=4, layers=2, max_pos=64)
BERT_B, BERT_S = 2, 64


@pytest.fixture(scope="module")
def bert_reference():
    """paddle_tpu's static BERT (2 layers, d 128) on a fixed [2, 64] feed:
    its initial weights, three runs' losses and the weights after."""
    paddle_tpu.seed(11)
    model = static_bert(paddle_tpu, **BERT_SMALL)
    init = {k: np.asarray(v._data).copy()
            for k, v in model.state_dict().items()}
    feed = _bert_feed()
    paddle_tpu.enable_static()
    try:
        main, startup, loss = static_bert_program(paddle_tpu, model, BERT_B,
                                                  BERT_S)
        exe = paddle_tpu.static.Executor()
        exe.run(startup)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                  for _ in range(3)]
    finally:
        paddle_tpu.disable_static()
    after = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    return init, losses, after


def _bert_feed():
    ids = (np.arange(BERT_B * BERT_S).reshape(BERT_B, BERT_S) * 7 % 500
           ).astype(np.int64)
    pos = np.tile(np.arange(BERT_S, dtype=np.int64), (BERT_B, 1))
    return {"ids": ids, "pos": pos,
            "label": (np.arange(BERT_B) % 2).astype(np.int64)}


def _port_bert(init):
    model = static_bert(pt, **BERT_SMALL)
    assert model.set_state_dict(init) == ([], [])
    return model


def test_bert_program_runs_as_the_reference(bert_reference):
    init, j_losses, j_after = bert_reference
    model = _port_bert(init)
    pt.enable_static()
    main, startup, loss = static_bert_program(pt, model, BERT_B, BERT_S)
    exe = pt.static.Executor()
    exe.run(startup)
    losses = [float(exe.run(main, feed=_bert_feed(), fetch_list=[loss])[0])
              for _ in range(3)]
    np.testing.assert_allclose(losses, j_losses, **TOL)
    assert losses[-1] < losses[0]
    off = moved = 0.0
    for k, v in model.state_dict().items():
        got, want = v.detach().numpy(), j_after[k]
        np.testing.assert_allclose(got, want, atol=3e-4, err_msg=k)
        off += np.sum((got - want) ** 2)
        moved += np.sum((want - init[k]) ** 2)
    assert off <= 1e-4 * moved


@pytest.mark.parametrize("fused_ln", ["0", "interpret"])
def test_bert_program_equals_its_eager_step(bert_reference, fused_ln,
                                            monkeypatch):
    """The first run's loss and parameters are the eager ``minimize``
    step's bit for bit: the executor replays the same torch functions and
    applies the same update. On the kernel route (``interpret``: the
    wrappers' plain versions, as on the card the kernels) the shape probe
    reads no LayerNorm parameter, and the program still trains them."""
    monkeypatch.setenv("PADDLE_FUSED_LN", fused_ln)
    init = bert_reference[0]
    model, twin = _port_bert(init), _port_bert(init)
    pt.enable_static()
    main, startup, loss = static_bert_program(pt, model, BERT_B, BERT_S)
    feed = _bert_feed()
    assert len(main.all_parameters()) == len(list(model.parameters()))
    (lv,) = pt.static.Executor().run(main, feed=feed, fetch_list=[loss])
    pt.disable_static()
    opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                             parameters=twin.parameters())
    e_loss = pt.nn.functional.cross_entropy(
        twin(pt.to_tensor(feed["ids"]), pt.to_tensor(feed["pos"])),
        pt.to_tensor(feed["label"]))
    opt.minimize(e_loss)
    assert float(lv) == float(e_loss)
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), n


def test_program_parameters_in_first_use_order():
    """A layer recorded as one op lists the parameters its call takes, in
    the order it takes them (the JAX package's op-input order)."""
    built = _build_both(lambda pkg, sn: _lenet(pkg))
    shapes = [[tuple(np.shape(np.asarray(p._data)))
               for p in built[0][0].all_parameters()],
              [tuple(p.shape) for p in built[1][0].all_parameters()]]
    assert shapes[0] == shapes[1]
    assert len(shapes[1]) == 6


def test_set_program_parameters_checks_shapes():
    built = _build_both(lambda pkg, sn: _lenet(pkg))
    vals = [(p.name, np.asarray(p._data))
            for p in built[0][0].all_parameters()]
    with pytest.raises(ValueError, match="parameter 0"):
        set_program_parameters(built[1][0], vals[::-1])
    with pytest.raises(ValueError, match="values"):
        set_program_parameters(built[1][0], vals[:-1])


# -- static.nn builders ---------------------------------------------------


X4 = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
IDS = np.random.RandomState(1).randint(0, 10, (2, 5)).astype(np.int64)


def _x(pkg, shape=(-1, 3, 8, 8)):
    return pkg.static.data("x", list(shape), "float32")


def _deform(pkg, sn):
    x = _x(pkg)
    off = pkg.static.data("off", [-1, 18, 6, 6], "float32")
    mask = pkg.static.data("mask", [-1, 9, 6, 6], "float32")
    return sn.deform_conv2d(x, off, mask, 4, 3)


def _param(pkg, sn):
    w = sn.create_parameter([8], "float32")
    return _x(pkg) * w


BUILDERS = {
    "fc": (lambda pkg, sn: sn.fc(_x(pkg), 5, activation="relu"), {}),
    "conv2d": (lambda pkg, sn: sn.conv2d(_x(pkg), 4, 3, act="relu"), {}),
    "conv2d_transpose": (lambda pkg, sn: sn.conv2d_transpose(
        _x(pkg), 4, filter_size=3, stride=2), {}),
    "conv3d": (lambda pkg, sn: sn.conv3d(
        _x(pkg, (-1, 3, 4, 8, 8)), 2, 3),
        {"x": np.random.RandomState(2).rand(2, 3, 4, 8, 8).astype(
            np.float32)}),
    "batch_norm": (lambda pkg, sn: sn.batch_norm(_x(pkg), act="relu"), {}),
    "embedding": (lambda pkg, sn: sn.embedding(
        pkg.static.data("ids", [-1, 5], "int64"), [10, 6]), {"ids": IDS}),
    "layer_norm": (lambda pkg, sn: sn.layer_norm(_x(pkg)), {}),
    "group_norm": (lambda pkg, sn: sn.group_norm(_x(pkg), 3), {}),
    "instance_norm": (lambda pkg, sn: sn.instance_norm(_x(pkg)), {}),
    "prelu": (lambda pkg, sn: sn.prelu(_x(pkg), mode="channel"), {}),
    "deform_conv2d": (_deform, {
        "off": np.random.RandomState(3).uniform(
            -1.5, 1.5, (2, 18, 6, 6)).astype(np.float32),
        "mask": np.random.RandomState(4).rand(2, 9, 6, 6).astype(
            np.float32)}),
    "create_parameter": (_param, {}),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_static_nn_builder(name):
    build, feed = BUILDERS[name]
    feed = {"x": X4, **feed}
    built = _build_both(build)
    ref, got = _run_both(built, {k: v for k, v in feed.items()})
    np.testing.assert_allclose(got[0], ref[0], **TOL)


# -- control flow -------------------------------------------------------


def _cond_prog(pkg):
    x = pkg.static.data("x", [3], "float32")
    s = pkg.sum(x)
    return pkg.static.nn.cond(s > 0, lambda: x * 2.0, lambda: x - 1.0)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_picks_its_branch_at_run_time(sign):
    main, startup = _programs(pt)
    with pt.static.program_guard(main, startup):
        out = _cond_prog(pt)
    assert len(main.ops) == 3  # sum, >, cond
    xv = np.array([1.0, 2.0, 3.0], np.float32) * sign
    (got,) = pt.static.Executor().run(main, feed={"x": xv}, fetch_list=[out])
    want = xv * 2.0 if sign > 0 else xv - 1.0
    np.testing.assert_allclose(got, want)
    # eager: plain Python, as the reference
    pt.disable_static()
    paddle_tpu.disable_static()
    for pkg in PKGS:
        r = pkg.static.nn.cond(pkg.to_tensor(xv).sum() > 0,
                               lambda: pkg.to_tensor(xv) * 2.0,
                               lambda: pkg.to_tensor(xv) - 1.0)
        np.testing.assert_allclose(np.asarray(r.numpy()), want)


def test_while_loop_loops_at_run_time_and_trains():
    main, startup = _programs(pt)
    with pt.static.program_guard(main, startup):
        x = pt.static.data("x", [4], "float32")
        w = tsn.create_parameter([4], "float32")
        i = pt.zeros([1], "int64")
        _, h = pt.static.nn.while_loop(
            lambda i, h: i < 3, lambda i, h: [i + 1, h * w + 1.0], [i, x])
        loss = pt.mean(h)
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    w0 = w.detach().clone().numpy()
    xv = np.arange(4, dtype=np.float32)
    (lv,) = pt.static.Executor().run(main, feed={"x": xv}, fetch_list=[loss])
    h_ = xv
    for _ in range(3):
        h_ = h_ * w0 + 1.0
    np.testing.assert_allclose(float(lv), h_.mean(), rtol=1e-6)
    assert not np.allclose(w.detach().numpy(), w0)  # gradients reached w
    pt.disable_static()
    paddle_tpu.disable_static()
    for pkg in PKGS:  # eager
        _, r = pkg.static.nn.while_loop(
            lambda i, h: i < 3, lambda i, h: [i + 1, h * 2.0],
            [pkg.to_tensor(np.array([0], np.int64)), pkg.to_tensor(xv)])
        np.testing.assert_allclose(np.asarray(r.numpy()), xv * 8.0)


@pytest.mark.parametrize("idx", [0, 2, 7])
def test_switch_case_and_case(idx):
    fns = {0: lambda: 1.0, 2: lambda: 3.0}
    want = {0: 1.0, 2: 3.0}.get(idx, -1.0)
    main, startup = _programs(pt)
    with pt.static.program_guard(main, startup):
        i = pt.static.data("i", [1], "int64")
        x = pt.static.data("x", [2], "float32")
        out = pt.static.nn.switch_case(
            i, {k: (lambda v=v: x * v()) for k, v in fns.items()},
            default=lambda: x * -1.0)
        c = pt.static.nn.case([(pt.sum(i) == 0, lambda: x + 10.0),
                               (pt.sum(i) == 2, lambda: x + 20.0)],
                              default=lambda: x)
    xv = np.ones(2, np.float32)
    got, got_c = pt.static.Executor().run(
        main, feed={"i": np.array([idx], np.int64), "x": xv},
        fetch_list=[out, c])
    np.testing.assert_allclose(got, xv * want)
    np.testing.assert_allclose(got_c, xv + {0: 10.0, 2: 20.0}.get(idx, 0.0))
    pt.disable_static()
    paddle_tpu.disable_static()
    for pkg in PKGS:  # eager
        r = pkg.static.nn.switch_case(
            pkg.to_tensor(np.array(idx)),
            {k: (lambda v=v: pkg.to_tensor(xv) * v()) for k, v in fns.items()},
            default=lambda: pkg.to_tensor(xv) * -1.0)
        np.testing.assert_allclose(np.asarray(r.numpy()), xv * want)


def test_scan_eager_against_reference_and_static():
    xs = np.arange(12, dtype=np.float32).reshape(4, 3)
    init = np.zeros(3, np.float32)

    def body(pkg):
        return lambda c, x: (c + x, c * 2.0)

    outs = []
    for pkg in PKGS:
        c, ys = pkg.jit.scan(body(pkg), pkg.to_tensor(init),
                             pkg.to_tensor(xs))
        outs.append((np.asarray(c.numpy()), np.asarray(ys.numpy())))
    np.testing.assert_allclose(outs[1][0], outs[0][0])
    np.testing.assert_allclose(outs[1][1], outs[0][1])
    main, startup = _programs(pt)
    with pt.static.program_guard(main, startup):
        x = pt.static.data("xs", [4, 3], "float32")
        c, ys = pt.jit.scan(body(pt), pt.to_tensor(init), x)
    got = pt.static.Executor().run(main, feed={"xs": xs}, fetch_list=[c, ys])
    np.testing.assert_allclose(got[0], outs[0][0])
    np.testing.assert_allclose(got[1], outs[0][1])


# -- Program / Executor behaviour -----------------------------------------


def test_feed_signature_cache_and_shapes():
    main, _ = _programs(pt)
    with pt.static.program_guard(main):
        x = pt.static.data(name="x", shape=[-1, 4], dtype="float32")
        y = (x * 2.0).sum()
    assert x.shape == [-1, 4]
    exe = pt.static.Executor()
    (a,) = exe.run(main, feed={"x": np.ones((3, 4), np.float32)},
                   fetch_list=[y])
    (b,) = exe.run(main, feed={"x": np.ones((7, 4))}, fetch_list=[y])
    exe.run(main, feed={"x": np.ones((7, 4))}, fetch_list=[y])
    assert float(a) == 24.0 and float(b) == 56.0
    assert len(exe._cache) == 2


def test_static_data_outside_static_mode_raises():
    for pkg in PKGS:
        with pytest.raises(RuntimeError, match="enable_static"):
            pkg.static.data(name="x", shape=[4], dtype="float32")


def test_in_dynamic_mode_reports_static_mode():
    assert pt.in_dynamic_mode()
    pt.enable_static()
    assert not pt.in_dynamic_mode()
    pt.disable_static()
    assert pt.in_dynamic_mode()


def test_program_guard_isolation():
    main, _ = _programs(pt)
    other = pt.static.Program()
    with pt.static.program_guard(main):
        x = pt.static.data(name="x", shape=[-1, 2], dtype="float32")
        _ = x + 1.0
        with pt.static.program_guard(other):
            z = pt.static.data(name="z", shape=[-1, 2], dtype="float32")
            _ = z * 3.0
        _ = x - 1.0
    assert len(other.ops) == 1 and len(main.ops) == 2


def test_dropout_draws_anew_each_run():
    outs = []
    for pkg in PKGS:
        main, _ = _programs(pkg)
        with pkg.static.program_guard(main):
            x = pkg.static.data("x", [-1, 256], "float32")
            y = pkg.nn.functional.dropout(x, p=0.5)
        exe = pkg.static.Executor()
        feed = {"x": np.ones((4, 256), np.float32)}
        a, b = (exe.run(main, feed=feed, fetch_list=[y])[0]
                for _ in range(2))
        outs.append((a, b))
        assert not np.array_equal(a, b)
        assert set(np.unique(a)) <= {0.0, 2.0}
        assert 0.35 < (a == 0).mean() < 0.65


def test_rng_feed_gets_a_fresh_seed_each_run():
    from paddle_tpu_torch.static.program import rng_feed

    main, _ = _programs(pt)
    with pt.static.program_guard(main):
        seed = rng_feed()
        out = seed + 0
    exe = pt.static.Executor()
    a, b = (int(exe.run(main, fetch_list=[out])[0]) for _ in range(2))
    assert a != b


def test_batch_norm_statistics_written_back():
    stats = []
    for pkg in PKGS:
        main, _ = _programs(pkg)
        with pkg.static.program_guard(main):
            x = pkg.static.data("x", [-1, 3, 8, 8], "float32")
            bn = pkg.nn.BatchNorm2D(3)
            y = bn(x)
        exe = pkg.static.Executor()
        for step in range(2):
            exe.run(main, feed={"x": X4 * (step + 1)}, fetch_list=[y])
        stats.append([np.asarray(bn._mean.numpy()),
                      np.asarray(bn._variance.numpy())])
    assert not np.allclose(stats[1][0], 0.0)
    for a, b in zip(*stats):
        np.testing.assert_allclose(b, a, **TOL)


def test_record_state_write():
    main, _ = _programs(pt)
    live = pt.to_tensor(np.zeros(3, np.float32))
    with pt.static.program_guard(main):
        x = pt.static.data("x", [3], "float32")
        main.record_state_write(live, x * 2.0)
    pt.static.Executor().run(main, feed={"x": np.ones(3, np.float32)})
    np.testing.assert_array_equal(live.numpy(), [2.0, 2.0, 2.0])
    with pytest.raises(ValueError):
        main.record_state_write(live, live)


def test_clone_for_test_does_not_train():
    main, startup = _programs(pt)
    with pt.static.program_guard(main, startup):
        x = pt.static.data("x", [-1, 4], "float32")
        fc = pt.nn.Linear(4, 2)
        loss = pt.mean(fc(x))
        pt.optimizer.SGD(learning_rate=0.5).minimize(loss)
    test_prog = main.clone(for_test=True)
    assert test_prog.optimize_directives == []
    w0 = fc.weight.detach().clone()
    exe = pt.static.Executor()
    feed = {"x": np.ones((2, 4), np.float32)}
    exe.run(test_prog, feed=feed, fetch_list=[loss])
    assert torch.equal(fc.weight, w0)
    # a parameter the layer's op reads through its closure is fetchable:
    # its value before the run's update
    _, w_run = exe.run(main, feed=feed, fetch_list=[loss, fc.weight])
    np.testing.assert_array_equal(w_run, w0.numpy())
    assert not torch.equal(fc.weight, w0)


def test_second_minimize_raises_at_run():
    for pkg in PKGS:
        main, _ = _programs(pkg)
        with pkg.static.program_guard(main):
            x = pkg.static.data("x", [-1, 4], "float32")
            loss = pkg.mean(pkg.nn.Linear(4, 2)(x))
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        with pytest.raises(NotImplementedError, match="multiple minimize"):
            pkg.static.Executor().run(
                main, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[loss])


def test_compiled_program_runs_on_one_device():
    main, _ = _programs(pt)
    with pt.static.program_guard(main):
        x = pt.static.data("x", [-1, 2], "float32")
        y = x * 3.0
    prog = pt.static.CompiledProgram(main).with_data_parallel()
    (got,) = pt.static.Executor(pt.CPUPlace()).run(
        prog, feed={"x": np.ones((2, 2), np.float32)}, fetch_list=[y])
    np.testing.assert_array_equal(got, np.full((2, 2), 3.0))
    with pytest.raises(NotImplementedError, match="one device"):
        pt.static.CompiledProgram(main).with_data_parallel(
            places=[pt.CPUPlace(), pt.CPUPlace()])


def test_unbatched_attention_departure():
    """A -1 batch through MultiHeadAttention: the JAX package's probe
    bakes extent 1 into the recorded closure and its run raises; the port
    records the layer's call whole and computes it (CHANGES.md names the
    departure)."""
    xv = np.random.RandomState(5).rand(4, 16, 32).astype(np.float32)
    layers = []
    for pkg in PKGS:
        layers.append(pkg.nn.MultiHeadAttention(32, 4))
    state = {k: np.asarray(v._data) for k, v in layers[0].state_dict().items()}
    layers[1].set_state_dict(state)
    outs = []
    for pkg, mha in zip(PKGS, layers):
        main, _ = _programs(pkg)
        with pkg.static.program_guard(main):
            x = pkg.static.data("x", [-1, 16, 32], "float32")
            y = mha(x, x, x)
        outs.append((main, y))
    with pytest.raises(Exception):
        paddle_tpu.static.Executor().run(outs[0][0], feed={"x": xv},
                                         fetch_list=[outs[0][1]])
    (got,) = pt.static.Executor().run(outs[1][0], feed={"x": xv},
                                      fetch_list=[outs[1][1]])
    pt.disable_static()
    paddle_tpu.disable_static()
    want = layers[0](paddle_tpu.to_tensor(xv), paddle_tpu.to_tensor(xv),
                     paddle_tpu.to_tensor(xv))
    np.testing.assert_allclose(got, np.asarray(want._data), **TOL)
