"""The fluid tree of the port's ``paddle`` route
(``paddle_tpu_torch/compat/paddle/fluid``) against the JAX alias's
``paddle.fluid``, on the same numpy inputs and weights.

- Each fluid-only spelling of ``fluid.layers`` and ``fluid.nets`` is built
  into a fresh static program by both packages; the port's parameters are
  carried from the JAX package's (``set_program_parameters``), and both
  ``fluid.Executor`` s run the same feeds.
- ``fluid.dygraph.nn``'s layers, with ``act``, eagerly on a state dict
  carried across, and ``layers.dropout``'s two modes in training.
- ``fluid.initializer``'s aliases: the same initializer class, and a
  drawn [256, 512] parameter of the same spread.
- ``DataFeeder.feed`` on the same samples.
- ``fluid_fit_a_line.py`` and ``fluid_recognize_digits.py`` verbatim, run
  by the JAX package as tests/test_reference_scripts.py runs them and by
  the port's launcher on the CPU, from the JAX run's starting weights
  with the same shuffle seed (tests/helpers/pinned_run.py), on the data
  of tests/helpers/stage_ref_data.py at that harness's caps: every number
  each prints.

Tolerances: outputs within ``rtol = atol = 1e-5`` (float32 products and
sums in different orders and libraries). A drawn parameter's quantiles
within 3% of the distribution's spread of the JAX package's (131,072
draws; sampling error under 1%). The scripts' printed numbers within
``rtol = 1e-5`` too, after 100 SGD steps (fit_a_line) or 8 Adam steps
(recognize_digits): the two runs differ by under 4e-7 of each value on
the CPU.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import paddle.fluid as jfluid
import paddle_tpu

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
import paddle_tpu_torch.compat.paddle.fluid as tfluid
from paddle_tpu_torch.static.program import set_program_parameters
from chip_smoke import REF_SCRIPTS
from test_torch_ops_math import cpu_device  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
#: (package, its fluid) for the JAX package and the port
FLUIDS = ((paddle_tpu, jfluid), (pt, tfluid))


@pytest.fixture(autouse=True)
def dygraph_after():
    """Each test ends in dygraph mode in both packages (fluid's graph
    entry points turn static mode on)."""
    yield
    for pkg, _ in FLUIDS:
        pkg.disable_static()


def _u(shape, lo=-1.0, hi=1.0, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _run_static(build, feed):
    """``build(fluid)`` -> the variables to fetch, in a fresh program of
    each package; the port's parameters carried from the JAX package's;
    both executors run ``feed``. Returns [JAX outputs, port outputs]."""
    built = []
    for _, fluid in FLUIDS:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            fetch = build(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        built.append((exe, main, fetch))
    set_program_parameters(built[1][1], [
        (p.name, np.asarray(p._data)) for p in built[0][1].all_parameters()])
    return [exe.run(main, feed=feed, fetch_list=list(fetch))
            for exe, main, fetch in built]


# -- fluid.layers and fluid.nets in static programs ------------------------


def _probs(n, c, seed):
    p = np.exp(_u((n, c), -2.0, 2.0, seed))
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


LABEL = np.array([[1], [0], [4], [2]], np.int64)
PROBS = _probs(4, 5, 1)
PROBS[2, 4] = 0.0  # -log of the clipped 1e-10
X4 = _u((2, 3, 4, 5), seed=2)


def _cross_entropy(fluid):
    L = fluid.layers
    p = fluid.data("p", [-1, 5], "float32")
    lbl = fluid.data("lbl", [-1, 1], "int64")
    soft = fluid.data("soft", [-1, 5], "float32")
    return [L.cross_entropy(p, lbl), L.cross_entropy(p, soft,
                                                     soft_label=True),
            L.mean(L.cross_entropy(input=p, label=lbl))]


def _elementwise(fluid):
    L = fluid.layers
    x = fluid.data("x", [2, 3, 4, 5], "float32")
    pos = fluid.data("pos", [2, 3, 4, 5], "float32")
    c = fluid.data("c", [3], "float32")
    hw = fluid.data("hw", [3, 4], "float32")
    t = fluid.data("t", [5], "float32")
    n = fluid.data("n", [2], "float32")
    return [L.elementwise_add(x, c, axis=1, act="relu"),
            L.elementwise_sub(x, hw, axis=1),
            L.elementwise_mul(x, t),
            L.elementwise_div(x, n, axis=0),
            L.elementwise_max(x, c, axis=1),
            L.elementwise_min(x, t, axis=-1, act="sigmoid"),
            L.elementwise_pow(pos, c, axis=1),
            L.elementwise_add(x, pos, act="tanh")]


def _accuracy(fluid):
    L = fluid.layers
    p = fluid.data("p8", [-1, 5], "float32")
    lbl = fluid.data("lbl8", [-1, 1], "int64")
    flat = fluid.data("flat8", [-1], "int64")
    return [L.accuracy(p, lbl), L.accuracy(input=p, label=lbl, k=2),
            L.accuracy(p, flat)]


def _mul(fluid):
    L = fluid.layers
    x3 = fluid.data("x3", [2, 3, 4], "float32")
    y2 = fluid.data("y2", [4, 5], "float32")
    x4 = fluid.data("x4", [2, 3, 2, 2], "float32")
    y12 = fluid.data("y12", [12, 3], "float32")
    y3 = fluid.data("y3", [2, 6, 3], "float32")
    return [L.mul(x3, y2, x_num_col_dims=2), L.mul(x4, y12),
            L.mul(x4, y3, y_num_col_dims=2)]


def _pool2d(fluid):
    L = fluid.layers
    x = fluid.data("img", [-1, 3, 8, 8], "float32")
    return [L.pool2d(x, 2, "max", 2),
            L.pool2d(x, pool_size=3, pool_type="avg", pool_stride=2,
                     pool_padding=1),
            L.pool2d(x, pool_size=3, pool_type="avg", pool_stride=2,
                     pool_padding=1, exclusive=False),
            L.pool2d(x, pool_size=3, pool_type="max", pool_stride=2,
                     ceil_mode=True),
            L.pool2d(x, pool_type="avg", global_pooling=True),
            L.pool2d(x, pool_type="max", global_pooling=True)]


def _dropout_at_test(fluid):
    L = fluid.layers
    x = fluid.data("x", [2, 3, 4, 5], "float32")
    return [L.dropout(x, 0.3, is_test=True),
            L.dropout(x, dropout_prob=0.3, is_test=True,
                      dropout_implementation="upscale_in_train")]


def _reduce(fluid):
    L = fluid.layers
    x = fluid.data("x3", [2, 3, 4], "float32")
    return [L.reduce_mean(x, dim=1), L.reduce_sum(x, dim=[0, 2],
                                                  keep_dim=True),
            L.reduce_max(x, dim=-1), L.reduce_min(x),
            L.reduce_prod(x, dim=2, keep_dim=True)]


def _fc(fluid):
    L = fluid.layers
    x = fluid.data("x3", [-1, 3, 4], "float32")
    x2 = fluid.layers.data("x2", [6])  # [-1, 6]
    return [L.fc(input=x, size=5, num_flatten_dims=2, act="tanh"),
            L.fc(x2, 3, bias_attr=False),
            L.fc(input=x2, size=4, act="softmax",
                 param_attr=fluid.ParamAttr(
                     initializer=fluid.initializer.Constant(0.1)))]


def _losses(fluid):
    L = fluid.layers
    logits = fluid.data("logits", [-1, 5], "float32")
    lbl = fluid.data("lbl", [-1, 1], "int64")
    z = fluid.data("z", [4, 3], "float32")
    zl = fluid.data("zl", [4, 3], "int64")
    loss, sm = L.softmax_with_cross_entropy(logits, lbl,
                                            return_softmax=True)
    return [loss, sm,
            L.sigmoid_cross_entropy_with_logits(z, zl, ignore_index=-1),
            L.sigmoid_cross_entropy_with_logits(z, zl, ignore_index=-1,
                                                normalize=True)]


def _shapes(fluid):
    L = fluid.layers
    lbl = fluid.data("lbl", [-1, 1], "int64")
    x = fluid.data("x213", [2, 1, 3], "float32")
    return [L.one_hot(lbl, 5), fluid.one_hot(lbl, 6),
            L.embedding(lbl, size=[10, 4]), fluid.embedding(lbl, [10, 4]),
            L.squeeze(x, axes=[1]), L.unsqueeze(x, axes=[0, 2]),
            # concrete tensors, fetched through the ops that take them
            L.fill_constant([2, 1, 3], "float32", 1.5) + x,
            L.cast(L.shape(x), "float32") * L.reduce_sum(x),
            L.assign(x)]


def _nets_conv(fluid):
    img = fluid.layers.data("img", [3, 8, 8])
    small = fluid.data("small", [-1, 1, 12, 12], "float32")
    return [fluid.nets.simple_img_conv_pool(
                input=small, num_filters=3, filter_size=3, pool_size=2,
                pool_stride=2, act="relu"),
            fluid.nets.img_conv_group(
                input=img, conv_num_filter=[4, 4], pool_size=2,
                pool_stride=2, conv_act="relu", conv_with_batchnorm=True,
                conv_batchnorm_drop_rate=0.0)]


def _nets_sequence(fluid):
    seq = fluid.data("seq", [2, 6, 4], "float32")
    lengths = fluid.data("lengths", [2], "int64")
    q = fluid.data("q", [2, 5, 8], "float32")
    kv = fluid.data("kv", [2, 7, 8], "float32")
    return [fluid.nets.sequence_conv_pool(seq, lengths, num_filters=3,
                                          filter_size=3),
            fluid.nets.sequence_conv_pool(seq, lengths, 2, 2, act="tanh",
                                          pool_type="average"),
            fluid.nets.glu(fluid.layers.reshape(q, [2, 40]), dim=-1),
            fluid.nets.scaled_dot_product_attention(q, kv, kv * 0.5,
                                                    num_heads=2)]


STATIC = {
    "cross_entropy": (_cross_entropy, {
        "p": PROBS, "lbl": LABEL, "soft": _probs(4, 5, 3)}),
    "elementwise": (_elementwise, {
        "x": X4, "pos": _u((2, 3, 4, 5), 0.5, 2.0, 3), "c": _u((3,), seed=4),
        "hw": _u((3, 4), 0.5, 2.0, 5), "t": _u((5,), seed=6),
        "n": np.array([2.0, -0.5], np.float32)}),
    "accuracy": (_accuracy, {
        "p8": _u((8, 5), seed=7),
        "lbl8": np.array([[0], [1], [2], [3], [4], [0], [1], [2]], np.int64),
        "flat8": np.array([4, 3, 2, 1, 0, 4, 3, 2], np.int64)}),
    "mul": (_mul, {"x3": _u((2, 3, 4), seed=8), "y2": _u((4, 5), seed=9),
                   "x4": _u((2, 3, 2, 2), seed=10),
                   "y12": _u((12, 3), seed=11), "y3": _u((2, 6, 3), seed=12)}),
    "pool2d": (_pool2d, {"img": _u((2, 3, 8, 8), seed=13)}),
    "dropout_at_test": (_dropout_at_test, {"x": X4}),
    "reduce": (_reduce, {"x3": _u((2, 3, 4), seed=14)}),
    "fc": (_fc, {"x3": _u((2, 3, 4), seed=15), "x2": _u((2, 6), seed=16)}),
    "losses": (_losses, {
        "logits": _u((4, 5), -3.0, 3.0, 17), "lbl": LABEL,
        "z": _u((4, 3), -3.0, 3.0, 18),
        "zl": np.array([[0, 1, -1], [1, 1, 0], [-1, -1, -1], [0, 0, 1]],
                       np.int64)}),
    "shapes": (_shapes, {"lbl": LABEL, "x213": _u((2, 1, 3), seed=19)}),
    "nets_conv": (_nets_conv, {"img": _u((2, 3, 8, 8), seed=20),
                               "small": _u((2, 1, 12, 12), seed=21)}),
    "nets_sequence": (_nets_sequence, {
        "seq": _u((2, 6, 4), seed=22), "lengths": np.array([6, 3], np.int64),
        "q": _u((2, 5, 8), seed=23), "kv": _u((2, 7, 8), seed=24)}),
}


@pytest.mark.parametrize("name", sorted(STATIC))
def test_fluid_layers_in_a_static_program(name):
    build, feed = STATIC[name]
    ref, got = _run_static(build, feed)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        a, b = np.asarray(a), np.asarray(b)
        assert b.shape == a.shape, (i, b.shape, a.shape)
        np.testing.assert_allclose(b, a, err_msg=f"output {i}", **TOL)


def test_cross_entropy_over_probabilities_is_minus_log():
    """The 1.x cross entropy over probabilities, from numpy: -log p[label]
    per row, [N, 1], with p clipped to 1e-10."""
    _, got = _run_static(_cross_entropy, STATIC["cross_entropy"][1])
    want = -np.log(np.clip(PROBS[np.arange(4), LABEL[:, 0]], 1e-10, 1.0))
    np.testing.assert_allclose(got[0][:, 0], want, rtol=1e-6)
    assert got[0].shape == (4, 1) and got[0][2, 0] > 23.0


# -- fluid.dygraph.nn, eagerly -------------------------------------------


DYGRAPH = {
    "Linear_relu": (lambda d: d.Linear(6, 4, act="relu"), (3, 6)),
    "Linear_no_bias": (lambda d: d.Linear(6, 4, bias_attr=False), (3, 6)),
    "Conv2D_sigmoid": (lambda d: d.Conv2D(3, 4, 3, padding=1,
                                          act="sigmoid"), (2, 3, 6, 6)),
    "Pool2D_avg": (lambda d: d.Pool2D(3, "avg", 2, 1), (2, 3, 7, 7)),
    "Pool2D_global_max": (lambda d: d.Pool2D(pool_type="max",
                                             global_pooling=True),
                          (2, 3, 5, 5)),
    "BatchNorm_relu": (lambda d: d.BatchNorm(3, act="relu"), (4, 3, 5, 5)),
    "BatchNorm_is_test": (lambda d: d.BatchNorm(3, act="tanh",
                                                is_test=True),
                          (4, 3, 5, 5)),
    "Embedding": (lambda d: d.Embedding(size=[10, 4]), None),
}


@pytest.mark.parametrize("name", sorted(DYGRAPH))
def test_fluid_dygraph_layer(name):
    make, shape = DYGRAPH[name]
    x = np.array([[1, 9, 0], [3, 3, 7]], np.int64) if shape is None \
        else _u(shape, seed=25)
    layers = [make(fluid.dygraph.nn) for _, fluid in FLUIDS]
    state = {k: np.asarray(v._data) for k, v in layers[0].state_dict().items()}
    assert layers[1].set_state_dict(state) == ([], [])
    outs = [np.asarray(lyr(pkg.to_tensor(x)).numpy())
            for (pkg, _), lyr in zip(FLUIDS, layers)]
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    after = [{k: np.asarray(v.numpy()) for k, v in lyr.state_dict().items()}
             for lyr in layers]
    for k in after[0]:  # batch norm's running statistics
        np.testing.assert_allclose(after[1][k], after[0][k], err_msg=k, **TOL)


@pytest.mark.parametrize("impl,kept", [("downgrade_in_infer", 1.0),
                                       ("upscale_in_train", 2.0)])
def test_fluid_dropout_modes_in_training(impl, kept):
    """``layers.dropout``'s implementation names in training: the kept
    values are x (downgrade_in_infer) or x / (1 - p) (upscale_in_train)
    in both packages."""
    x = np.ones((64, 64), np.float32)
    for pkg, fluid in FLUIDS:
        out = np.asarray(fluid.layers.dropout(
            pkg.to_tensor(x), dropout_prob=0.5,
            dropout_implementation=impl).numpy())
        assert set(np.unique(out)) == {0.0, kept}, pkg.__name__
        assert 0.4 < (out == 0).mean() < 0.6


# -- fluid.initializer ---------------------------------------------------


ARR = _u((256, 512), seed=26)
INITS = {
    "Xavier": lambda i: i.Xavier(),
    "Xavier_normal_fans": lambda i: i.Xavier(uniform=False, fan_in=100,
                                             fan_out=300),
    "XavierInitializer_fan_in": lambda i: i.XavierInitializer(fan_in=64),
    "MSRA": lambda i: i.MSRA(),
    "MSRAInitializer_normal": lambda i: i.MSRAInitializer(uniform=False),
    "ConstantInitializer": lambda i: i.ConstantInitializer(0.25),
    "UniformInitializer": lambda i: i.UniformInitializer(-0.1, 0.3),
    "NormalInitializer": lambda i: i.NormalInitializer(0.2, 0.05),
    "TruncatedNormalInitializer": lambda i: i.TruncatedNormalInitializer(
        0.0, 0.1),
    "NumpyArrayInitializer": lambda i: i.NumpyArrayInitializer(ARR),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_fluid_initializer_alias(name):
    inits = [INITS[name](fluid.initializer) for _, fluid in FLUIDS]
    assert type(inits[1]).__name__ == type(inits[0]).__name__
    draws = [np.asarray(fluid.layers.create_parameter(
        [256, 512], "float32",
        attr=fluid.ParamAttr(initializer=init)).numpy())
        for (_, fluid), init in zip(FLUIDS, inits)]
    q = [0.001, 0.01, 0.1, 0.5, 0.9, 0.99, 0.999]
    ref, got = (np.quantile(d, q) for d in draws)
    spread = max(ref[-1] - ref[0], 1e-6)
    np.testing.assert_allclose(got, ref, atol=0.03 * spread, rtol=0)
    np.testing.assert_allclose(draws[1].std(), draws[0].std(), rtol=0.03,
                               atol=1e-7)


# -- DataFeeder -----------------------------------------------------------


def test_data_feeder_feeds_as_the_reference():
    rng = np.random.RandomState(27)
    samples = [(rng.rand(13), [float(i)], rng.rand(784).astype(np.float32),
                i % 10) for i in range(5)]
    feeds = []
    for pkg, fluid in FLUIDS:
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            vs = [fluid.data("x", [None, 13], "float32"),
                  fluid.data("y", [None, 1], "float32"),
                  fluid.layers.data("img", [1, 28, 28], "float32"),
                  fluid.layers.data("label", [1], "int64")]
        feeds.append(fluid.DataFeeder(feed_list=vs,
                                      place=fluid.CPUPlace()).feed(samples))
    assert list(feeds[1]) == list(feeds[0]) == ["x", "y", "img", "label"]
    for k in feeds[0]:
        a, b = feeds[0][k], feeds[1][k]
        # int64 in the port, int32 in the JAX package (no x64): by value
        want = np.int64 if a.dtype == np.int32 else a.dtype
        assert (b.dtype, b.shape) == (want, a.shape), k
        np.testing.assert_array_equal(b, a)
    assert feeds[1]["img"].shape == (5, 1, 28, 28)


# -- the fluid scripts verbatim, step by step against the JAX harness ----


_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+)(?:[eE][-+]?\d+)?|nan|inf")


@pytest.fixture(scope="module")
def dataset_home(tmp_path_factory):
    from helpers.stage_ref_data import stage_all

    return stage_all(str(tmp_path_factory.mktemp("paddle_dataset_home")))


def _pinned_runs(name, home, tmp):
    """The JAX package's run of ``name`` (which writes the starting
    weights), then the port's from them: (JAX stdout, port stdout)."""
    helper = os.path.join(REPO, "tests", "helpers", "pinned_run.py")
    script = os.path.join(REPO, "tests", "reference_scripts", name)
    weights = str(tmp / "weights.npz")
    env = dict(os.environ, PADDLE_DATASET_HOME=home, **REF_SCRIPTS[name])
    jax_env = dict(env, JAX_PLATFORMS=env.get("JAX_PLATFORMS", "cpu"),
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    outs = []
    for cmd, e in (([sys.executable, helper], jax_env),
                   ([sys.executable, "-m", "paddle_tpu_torch.run",
                     "--device", "cpu", helper], env)):
        proc = subprocess.run(cmd + [weights, script], cwd=REPO, env=e,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, (cmd, proc.stdout[-2000:],
                                      proc.stderr[-4000:])
        outs.append(proc.stdout)
    return outs


@pytest.mark.parametrize("name", ["fluid_fit_a_line.py",
                                  "fluid_recognize_digits.py"])
def test_fluid_script_numbers_against_the_jax_harness(name, dataset_home,
                                                      tmp_path):
    ref, got = _pinned_runs(name, dataset_home, tmp_path)
    nums = [[float(v) for v in _NUMBER.findall(out)] for out in (ref, got)]
    assert len(nums[0]) >= 3 and len(nums[1]) == len(nums[0]), (ref, got)
    np.testing.assert_allclose(nums[1], nums[0], rtol=1e-5, atol=1e-6,
                               err_msg=f"\n{ref}\n{got}")
    assert nums[1][-1] < nums[1][0]
