"""bench.py's LeNet and ResNet training programs in the port against
paddle_tpu, on carried weights.

LeNet as bench.py builds it ([4, 1, 28, 28], 10 classes) and ResNet-18 at
[2, 3, 64, 64] with 10 classes are built in both packages with the same
random numpy weights and batch-norm statistics
(``set_state_dict``); batches are ``np.random.rand``
images with ``arange % classes`` labels, as bench.py makes them. ResNet's
input is 64 x 64, not 32 x 32: at 32 x 32 its last stage is 1 x 1, so
batch norm there normalizes two values per channel, and where the two
nearly agree the output multiplies a float32 rounding difference of its
input by up to 1 / sqrt(epsilon) ~ 316 (a 3e-5 difference after the third
stage became 0.17 after the fourth); at 64 x 64 it normalizes eight.

Checked: in float32, one batch's loss, every parameter's gradient and
the batch-norm running statistics the forward leaves (paddle_tpu's from
``jax.value_and_grad`` of the function its ``TrainStep`` differentiates,
which returns the updated buffers); under ``strategy.amp`` (bf16 O1) the
same of LeNet, and ResNet-18 stage by stage; in both, three
``TrainStep`` calls with ``Momentum(1e-3, 0.9)`` (losses, then
parameters and running statistics after the third); a NaN batch that
the skip guard turns into a no-op, leaving parameters, the velocity and
the running statistics bitwise unchanged in each package; and one
``BottleneckBlock`` with stride 2 and a downsample, forward and
backward. The three float32 steps of ResNet-50 are marked slow
(paddle_tpu's take about a minute on the CPU) and do not hold at this
size: with the batch statistics taken in float32, as both packages take
them, roundings move ResNet-50's gradients at these weights by a large
share of their largest value (paddle_tpu's float32 run against its x64
run: 35%; the port's float64 run with float32 statistics against one
with float64 statistics: 14%), where ResNet-18's move by 4.5e-6.

Tolerances. float32: loss atol 1e-5; each gradient within 1e-4 of its
parameter's largest gradient; running statistics and parameters after
the steps within 1e-5 of their largest value; all without slack. The
one-batch check also holds the port to paddle_tpu's run under
``jax_enable_x64`` (float64, but for the batch statistics, which its
``batch_norm`` takes in float32), and ResNet-18's leaves under
``F32_EXEMPT`` are held to that run alone: paddle_tpu's own float32
gradients there lie up to 8.0e-2 of their largest value
(``layer3.1.conv1.weight``) from its x64 run, while the port's float32
gradients lie within 5.2e-5 of it in every leaf.

Under bf16 AMP: loss atol 2e-3 and every gradient within 2e-2 of its
largest value, but for the values named in ``AMP_READINGS``, each held
within 1.25 times the distance measured for it. Both packages convolve
and apply batch norm in bf16, rounding sums taken in different orders,
and batch norm over a few values magnifies the roundings: LeNet's
convolution gradients lie 13-24% of their largest value from float32 in
each package and 8-13% from each other. A port that convolved in float32
under AMP lies 16-18% from paddle_tpu there, so it fails the bands
(``test_amp_checks_catch_float32_convolution``), and every check also
compares the output type of each layer with paddle_tpu's. Over three
steps the bf16 noise outgrows that difference, so the three-step checks
do not separate the two: their named bounds are the measured distances
with the same margin. Readings on the CPU with JAX 0.9 and PyTorch 2.13.
"""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.distributed import comm
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed.fleet.base import \
    _DistributedOptimizer as _JaxDistributedOptimizer
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.vision import models as jax_models
from paddle_tpu.vision.models.resnet import BottleneckBlock as JaxBottleneck

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.vision import models as pt_models

LR, MOMENTUM = 1e-3, 0.9
#: (loss atol, gradient share, state share) in float32 and under AMP
TOL = {False: (1e-5, 1e-4, 1e-5), True: (2e-3, 2e-2, 2e-2)}
#: ResNet-18's modules whose float32 gradients are held to paddle_tpu's
#: x64 run only (module docstring): paddle_tpu's float32 gradient lies
#: further than 1e-4 from its x64 run in 42 of their 45 leaves
F32_EXEMPT = ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.")
#: under AMP, the port's measured distance from paddle_tpu's bf16 result,
#: as a share of its largest value, for each value further than TOL[True];
#: each is held within AMP_MARGIN times its reading
AMP_READINGS = {
    # one batch of LeNet: gradients
    "lenet": {"features.0.weight": 7.963e-2, "features.0.bias": 8.182e-2,
              "features.3.weight": 1.170e-1, "features.3.bias": 1.265e-1},
    # ResNet-18 stage by stage: gradients under a random cotangent
    "resnet18_stages": {
        "bn1.weight": 1.125e-1, "bn1.bias": 7.456e-2,
        "layer1.0.conv1.weight": 2.861e-2, "layer1.0.bn1.weight": 7.481e-2,
        "layer1.0.bn1.bias": 2.817e-2, "layer1.0.bn2.weight": 2.954e-2,
        "layer1.0.bn2.bias": 4.818e-2, "layer1.1.conv2.weight": 2.107e-2,
        "layer1.1.bn1.weight": 5.110e-2, "layer1.1.bn1.bias": 3.163e-2,
        "layer1.1.bn2.weight": 6.319e-2, "layer1.1.bn2.bias": 3.933e-2,
        "layer2.0.bn1.weight": 2.649e-2,
        "layer2.0.downsample.1.weight": 2.780e-2,
        "layer2.1.bn1.weight": 2.119e-2, "layer2.1.bn2.weight": 4.185e-2},
    # ResNet-18 after three steps: running statistics
    "resnet18_steps": {
        "layer4.0.bn1._variance": 2.356e-2,
        "layer4.0.downsample.1._variance": 2.646e-2,
        "layer4.1.bn1._mean": 2.467e-2, "layer4.1.bn2._mean": 2.385e-2},
}
#: the largest loss distance over three steps under AMP, by model
AMP_STEP_LOSS_READINGS = {"lenet": 2.975e-3, "resnet18": 5.459e-2}
AMP_MARGIN = 1.25
#: model name -> (paddle_tpu constructor, port constructor, input shape,
#: classes)
MODELS = {
    "lenet": (lambda: jax_models.LeNet(),
              lambda: pt_models.LeNet(device="cpu"), (4, 1, 28, 28), 10),
    "resnet18": (lambda: jax_models.resnet18(num_classes=10),
                 lambda: pt_models.resnet18(num_classes=10, device="cpu"),
                 (2, 3, 64, 64), 10),
    "resnet50": (lambda: jax_models.resnet50(num_classes=10),
                 lambda: pt_models.resnet50(num_classes=10, device="cpu"),
                 (2, 3, 64, 64), 10),
}


def _numpy_state(state):
    """The port's state (or gradients by name) as numpy copies."""
    return {n: t.detach().cpu().numpy().copy() for n, t in state.items()}


@pytest.fixture(scope="module")
def env():
    """The skip guard on, and a trivial hybrid mesh (restored after)."""
    prev = comm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_GUARD_MODE", "skip")
        for knob in ("PADDLE_GUARD_SPIKE_FACTOR", "PADDLE_GUARD_CHECK_PARAMS",
                     "PADDLE_FAULT_SPEC"):
            mp.delenv(knob, raising=False)
        comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
        yield
    comm._state.hybrid_mesh = prev


def _random_state(shapes, seed=3):
    """Random weights of paddle's layouts: convolutions ``[out, in, kh,
    kw]`` at paddle's initial scale, Linear ``[in, out]``, batch-norm
    scales near 1 and statistics of a trained-looking spread."""
    r = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("_mean"):
            a = 0.1 * r.randn(*shape)
        elif name.endswith("_variance"):
            a = 1 + 0.2 * np.abs(r.randn(*shape))
        elif len(shape) == 4:
            a = r.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif name.endswith("bias"):
            a = 0.1 * r.randn(*shape)
        elif len(shape) == 1:
            a = 1 + 0.2 * r.randn(*shape)
        else:
            a = r.randn(*shape) / np.sqrt(shape[0])
        out[name] = a.astype(np.float32)
    return out


def _pair(jm, tm, seed=3):
    state = _random_state({k: tuple(v.shape)
                           for k, v in jm.state_dict().items()}, seed)
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected
    assert tm.set_state_dict(state) == ([], [])
    return jm, tm


def _models(name):
    jax_fn, torch_fn, shape, classes = MODELS[name]
    return _pair(jax_fn(), torch_fn())


def _batch(name, seed):
    _, _, shape, classes = MODELS[name]
    r = np.random.RandomState(seed)
    x = r.rand(*shape).astype(np.float32)
    return x, (np.arange(shape[0]) % classes).astype(np.int64)


def _jax_loss(out, y):
    return jnn.functional.cross_entropy(out, y)


def _torch_loss(out, y):
    return pt.nn.functional.cross_entropy(out, y)


def _steps(jm, tm, amp):
    """A TrainStep with Momentum in each package, under the strategy's
    AMP when ``amp`` (paddle_tpu's optimizer wrapped as
    ``fleet.distributed_optimizer`` wraps it, on the one-device mesh)."""
    jopt = jax_optimizer.Momentum(learning_rate=LR, momentum=MOMENTUM,
                                  parameters=jm.parameters())
    topt = pt.optimizer.Momentum(learning_rate=LR, momentum=MOMENTUM)
    if amp:
        js = jax_fleet.DistributedStrategy()
        js.amp = True
        jopt = _JaxDistributedOptimizer(jopt, js)
        ts = fleet.DistributedStrategy()
        ts.amp = True
        fleet.init(is_collective=True, strategy=ts)
        topt = fleet.distributed_optimizer(topt)
    return (JaxTrainStep(jm, _jax_loss, jopt),
            pt.jit.TrainStep(tm, _torch_loss, topt), topt)


def _jax_state(jm):
    return {k: np.array(v._data) for k, v in jm.state_dict().items()}


def _assert_share(got, want, share, what, readings=None):
    """Every entry of ``got`` within ``share`` of the largest |value| of
    ``want``'s entry of the same name, or, for a name in ``readings``,
    within AMP_MARGIN times its reading where that is larger."""
    assert set(got) == set(want), what
    for name, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, (what, name)
        err = np.abs(got[name].astype(np.float64) - w).max()
        bound = max(share, AMP_MARGIN * (readings or {}).get(name, 0.0))
        assert err <= bound * scale, (what, name, err / scale, bound)


def _layer_types(jm, tm, jfwd, tfwd):
    """{layer name: output type} of every layer holding parameters of its
    own, from ``jfwd()`` through paddle_tpu's ``jm`` and ``tfwd()``
    through the port's ``tm``."""
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
        jfwd()
        tfwd()
    finally:
        for h in handles:
            h.remove()
    return types


def _jax_grads(jm, jstep, x, y, x64=False):
    """paddle_tpu's (loss, {name: gradient}, {buffer: value after the
    forward}) of one batch through the function its TrainStep
    differentiates; with ``x64``, under ``jax_enable_x64`` on float64
    parameters, buffers and batch."""
    with jax.enable_x64(x64):
        def arr(a):
            return jax.numpy.asarray(np.asarray(a),
                                     jax.numpy.float64 if x64 else None)

        b_raws = tuple(arr(b._data) for b in jstep._b_objs)
        loss_and_grads = jax.jit(jax.value_and_grad(
            lambda p: jstep._loss_of(p, b_raws, None, (arr(x),),
                                     (jax.numpy.asarray(y),)),
            has_aux=True))
        (loss, (new_b, _)), grads = loss_and_grads(
            tuple(arr(p._data) for p in jstep._p_objs))
        name_of = {id(p): n for n, p in jm.named_parameters()}
        return (float(loss),
                {name_of[id(p)]: np.asarray(g)
                 for p, g in zip(jstep._p_objs, grads)},
                {n: np.asarray(b) for n, b in zip(jstep._b_names, new_b)})


def _torch_grads(tm, tstep, x, y):
    """The port's (loss, {name: gradient}, {buffer: value after the
    forward}) of one batch under its TrainStep's AMP."""
    with torch.enable_grad(), tstep._amp_guard():
        loss = tstep.loss_fn(tm(torch.as_tensor(x)), torch.as_tensor(y))
    loss.backward()
    grads = _numpy_state(
        {n: p.grad for n, p in tm.named_parameters()})
    tm.zero_grad(set_to_none=True)
    return loss.item(), grads, {n: b.numpy().copy()
                                for n, b in tm.named_buffers()}


@pytest.mark.parametrize("name", ["lenet", "resnet18"])
def test_loss_gradients_and_bn_stats_match(env, name):
    """float32: loss, gradients and the running statistics the forward
    leaves, against paddle_tpu's float32 run and its run under
    ``jax_enable_x64``, each at the float32 tolerances. ResNet-18's
    leaves under F32_EXEMPT are held to the x64 run alone (module
    docstring)."""
    jm, tm = _models(name)
    x, y = _batch(name, 0)
    jstep, tstep, _ = _steps(jm, tm, False)
    jloss, want, want_b = _jax_grads(jm, jstep, x, y)
    xloss, want64, want64_b = _jax_grads(jm, jstep, x, y, x64=True)
    tloss, got, got_b = _torch_grads(tm, tstep, x, y)
    loss_atol, grad_share, state_share = TOL[False]
    assert abs(tloss - jloss) <= loss_atol
    assert abs(tloss - xloss) <= loss_atol
    assert all(g.dtype == np.float32 for g in got.values())
    _assert_share(got, want64, grad_share, "gradients against x64")
    exempt = F32_EXEMPT if name == "resnet18" else ()
    kept = [n for n in want if not n.startswith(exempt)]
    _assert_share({n: got[n] for n in kept}, {n: want[n] for n in kept},
                  grad_share, "gradients")
    if name != "lenet":
        _assert_share(got_b, want64_b, state_share,
                      "running statistics against x64")
        _assert_share(got_b, want_b, state_share, "running statistics")


def _lenet_amp(jm, tm, x, y):
    """LeNet's one-batch (paddle_tpu's, the port's) loss and gradients
    under bf16 O1."""
    jstep, tstep, _ = _steps(jm, tm, True)
    jloss, want, _ = _jax_grads(jm, jstep, x, y)
    tloss, got, _ = _torch_grads(tm, tstep, x, y)
    return jloss, want, tloss, got


def _amp_types(jm, tm, x):
    """paddle_tpu's and the port's layer output types under bf16 O1."""
    import paddle_tpu
    from paddle_tpu import amp as jax_amp

    def jfwd():
        with jax_amp.auto_cast(True, level="O1", dtype="bfloat16"):
            jm(paddle_tpu.to_tensor(x))

    def tfwd():
        with pt.amp.auto_cast(True, level="O1", dtype="bfloat16"):
            tm(torch.as_tensor(x))

    return _layer_types(jm, tm, jfwd, tfwd)


def test_lenet_loss_and_gradients_under_amp_match(env):
    """bf16 O1: LeNet's loss, its gradients (the convolutions' within
    their readings, module docstring), and each layer's output type."""
    jm, tm = _models("lenet")
    x, y = _batch("lenet", 0)
    jloss, want, tloss, got = _lenet_amp(jm, tm, x, y)
    loss_atol, grad_share, _ = TOL[True]
    assert abs(tloss - jloss) <= loss_atol
    assert all(g.dtype == np.float32 for g in got.values())
    _assert_share(got, want, grad_share, "gradients", AMP_READINGS["lenet"])
    jtypes, ttypes = _amp_types(jm, tm, x)
    assert jtypes == ttypes and set(jtypes.values()) == {"bfloat16"}


#: the stages of ResNet's forward, in order
STAGES = ("conv1", "bn1", "relu", "maxpool", "layer1", "layer2", "layer3",
          "layer4", "avgpool", "fc")


def _resnet18_stage_checks(check_types=True):
    """bf16 O1 through ResNet-18, stage by stage, each stage on
    paddle_tpu's bf16 input to it: its output within 2e-2 of its largest
    value, its parameters' gradients under a random cotangent within 2e-2
    or their readings, and (``check_types``) its output type
    paddle_tpu's."""
    import paddle_tpu
    from paddle_tpu import amp as jax_amp

    jm, tm = _models("resnet18")
    x, _ = _batch("resnet18", 0)
    r = np.random.RandomState(7)
    with jax_amp.auto_cast(True, level="O1", dtype="bfloat16"):
        a, ins = paddle_tpu.to_tensor(x), {}
        for n in STAGES:
            if n == "fc":
                a = a.reshape([a.shape[0], -1])
            ins[n] = np.array(a._data).astype(np.float32)
            a = getattr(jm, n)(a)
    for n in STAGES:
        jl, tl = getattr(jm, n), getattr(tm, n)
        jin = paddle_tpu.to_tensor(ins[n])
        tin = torch.as_tensor(ins[n])
        if n != "conv1":  # a bf16 activation, as the stage gets it
            jin, tin = jin.astype("bfloat16"), tin.to(torch.bfloat16)
        with jax_amp.auto_cast(True, level="O1", dtype="bfloat16"):
            jout = jl(jin)
        with pt.amp.auto_cast(True, level="O1", dtype="bfloat16"):
            tout = tl(tin)
        if check_types:
            assert str(tout.dtype)[6:] == str(jout._data.dtype), n
        want = np.array(jout._data).astype(np.float32)
        _assert_share({n: tout.detach().float().numpy()}, {n: want}, 2e-2,
                      "stage output")
        if not list(tl.parameters()):
            continue
        g = r.randn(*want.shape).astype(np.float32)
        (jout.astype("float32") * paddle_tpu.to_tensor(g)).sum().backward()
        (tout.float() * torch.as_tensor(g)).sum().backward()
        got = _numpy_state(
            {k: p.grad for k, p in tl.named_parameters()})
        _assert_share(
            {f"{n}.{k}": v for k, v in got.items()},
            {f"{n}.{k}": np.array(p.grad._data)
             for k, p in jl.named_parameters()},
            TOL[True][1], f"{n} gradients", AMP_READINGS["resnet18_stages"])


def test_resnet18_stages_under_amp_match(env):
    """bf16 O1 through ResNet-18, stage by stage. Run end to end, the two
    packages' bf16 roundings (sums in different orders) grow through the
    batch norms to ~7% of the last stage's largest output, as far as
    each package's own bf16 output lies from its float32 output. So each
    stage takes paddle_tpu's bf16 input to it (``_resnet18_stage_checks``;
    paddle_tpu sums a batch-norm weight's gradient over the batch in
    bf16, ~11% of its largest value apart from the port's)."""
    _resnet18_stage_checks()


def _float32_convolution(monkeypatch):
    """Make the port's ``conv2d`` take float32 inputs under AMP."""
    cast = pt.amp.cast_if_amp

    def cast_conv_up(op_name, tensors):
        if op_name != "conv2d":
            return cast(op_name, tensors)
        return tuple(t.float() if isinstance(t, torch.Tensor) else t
                     for t in tensors)

    monkeypatch.setattr(pt.amp, "cast_if_amp", cast_conv_up)


def test_amp_checks_catch_float32_convolution(env, monkeypatch):
    """The control of the AMP bands: a port whose ``conv2d`` skipped
    AMP's cast to bf16 fails LeNet's gradient bands and the ResNet-18
    stages' gradient bands (each checked apart from the output types,
    which it fails as well)."""
    jm, tm = _models("lenet")
    x, y = _batch("lenet", 0)
    _float32_convolution(monkeypatch)
    _, want, _, got = _lenet_amp(jm, tm, x, y)
    with pytest.raises(AssertionError, match="gradients"):
        _assert_share(got, want, TOL[True][1], "gradients",
                      AMP_READINGS["lenet"])
    jtypes, ttypes = _amp_types(jm, tm, x)
    assert ttypes["features.0"] == "float32" != jtypes["features.0"]
    with pytest.raises(AssertionError, match="gradients"):
        _resnet18_stage_checks(check_types=False)


def _three_steps(name, amp):
    jm, tm = _models(name)
    jstep, tstep, _ = _steps(jm, tm, amp)
    jl, tl = [], []
    for i in range(3):
        x, y = _batch(name, 10 + i)
        jl.append(float(jstep(x, y).numpy()))
        tl.append(tstep(x, y).item())
    return jm, tm, np.array(jl), np.array(tl)


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "bf16_amp"])
@pytest.mark.parametrize("name", ["lenet", "resnet18"])
def test_three_momentum_train_steps_match(env, name, amp):
    """Three TrainSteps with Momentum: the losses (which fall), then every
    parameter and running statistic; under AMP the losses and the values
    named in AMP_READINGS within their readings (module docstring)."""
    jm, tm, jl, tl = _three_steps(name, amp)
    loss_atol, _, state_share = TOL[amp]
    assert np.isfinite(tl).all() and tl[2] < tl[0]
    want, got = _jax_state(jm), _numpy_state(tm.state_dict())
    if amp:
        loss_atol = max(loss_atol,
                        AMP_MARGIN * AMP_STEP_LOSS_READINGS[name])
    assert (np.abs(tl - jl) <= loss_atol).all(), (tl, jl, loss_atol)
    _assert_share(got, want, state_share, "parameters and statistics",
                  AMP_READINGS.get(name + "_steps") if amp else None)


@pytest.mark.slow
def test_resnet50_train_steps_match(env):
    jm, tm, jl, tl = _three_steps("resnet50", False)
    np.testing.assert_allclose(tl, jl, atol=TOL[False][0], rtol=0)
    _assert_share(_numpy_state(tm.state_dict()), _jax_state(jm),
                  TOL[False][2], "parameters and statistics")


def test_skipped_step_leaves_bn_stats_unchanged(env):
    """A NaN batch at step 2: the loss is NaN and parameters, velocity and
    the running statistics stay bitwise as step 1 left them, in each
    package; step 3 applies again, and its loss agrees across them."""
    jm, tm = _models("resnet18")
    jstep, tstep, topt = _steps(jm, tm, False)
    snaps = {}
    for i in range(3):
        x, y = _batch("resnet18", 20 + i)
        if i == 1:
            x[0, 0, 0, 0] = np.nan
        jl = float(jstep(x, y).numpy())
        tl = tstep(x, y).item()
        snaps[i] = (_jax_state(jm),
                    {k: v.clone() for k, v in tm.state_dict().items()},
                    [v.clone() for v in
                     topt._accumulators["velocity"].values()])
        assert np.isnan(jl) == np.isnan(tl) == (i == 1)
    # paddle_tpu's float32 gradients are up to ~1% off (see
    # test_loss_gradients_and_bn_stats_match): two lr-1e-3 updates of them
    # move the loss by ~1e-4
    assert abs(tl - jl) <= 1e-3
    (j1, t1, v1), (j2, t2, v2) = snaps[0], snaps[1]
    assert any(k.endswith("_mean") for k in t1)
    for k in j1:
        np.testing.assert_array_equal(j2[k], j1[k], err_msg=k)
    for k in t1:
        assert torch.equal(t2[k], t1[k]), k
    for a, b in zip(v1, v2):
        assert torch.equal(a, b)


def test_bottleneck_block_forward_and_backward_match(env):
    """A stride-2 BottleneckBlock with a 1 x 1 downsample (conv + batch
    norm), 16 -> 32 channels, on [2, 16, 8, 8]: the output, the input's
    gradient and every parameter's gradient (eager backward in both)."""
    import paddle_tpu

    jm = JaxBottleneck(16, 8, stride=2, downsample=jnn.Sequential(
        jnn.Conv2D(16, 32, 1, stride=2, bias_attr=False),
        jnn.BatchNorm2D(32)))
    gen = torch.Generator().manual_seed(0)
    down = pt.nn.Sequential(
        pt.nn.Conv2D(16, 32, 1, stride=2, bias_attr=False, device="cpu",
                     generator=gen),
        pt.nn.BatchNorm2D(32, device="cpu"))
    tm = pt_models.BottleneckBlock(16, 8, stride=2, downsample=down,
                                   device="cpu", generator=gen)
    jm, tm = _pair(jm, tm, seed=4)
    r = np.random.RandomState(5)
    x = r.randn(2, 16, 8, 8).astype(np.float32)
    g = r.randn(2, 32, 4, 4).astype(np.float32)

    jx = paddle_tpu.to_tensor(x, stop_gradient=False)
    jout = jm(jx)
    (jout * paddle_tpu.to_tensor(g)).sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    tout = tm(tx)
    (tout * torch.as_tensor(g)).sum().backward()

    want = np.array(jout._data)
    np.testing.assert_allclose(tout.detach().numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)
    _assert_share({"x": tx.grad.numpy()}, {"x": np.array(jx.grad._data)},
                  TOL[False][1], "input gradient")
    _assert_share(
        _numpy_state({n: p.grad for n, p in tm.named_parameters()}),
        {n: np.array(p.grad._data) for n, p in jm.named_parameters()},
        TOL[False][1], "parameter gradients")
