"""The port's ``hapi`` (``Model``, callbacks, ``summary``, ``flops``) and
``paddle.save``/``load`` against paddle_tpu's.

One module fixture trains LeNet through ``Model.fit`` in both packages:
tests/reference_scripts/hapi_mnist_fit.py's program on MNIST files from
``tests/helpers/stage_ref_data.py`` (128 train, 64 test images), the
``paddle_tpu`` weights carried into the port, Adam under a ``StepDecay``
schedule, ``Accuracy``, two epochs of batch 32 with an eval pass each,
``save_dir`` checkpoints and ``VisualDL``; then ``evaluate`` and
``predict``. Shuffling draws from the global numpy stream in both, seeded
alike. Per-step losses, logged metrics, ``evaluate`` and ``predict`` agree
within 1e-5 (float32, summation order across libraries); the printed
progress text agrees line for line, its numbers within 2e-4 (printed to
4 decimals). ``summary`` prints the same table and counts and ``flops``
the same total. A ``paddle_tpu`` ``Model.save`` checkpoint resumes in the
port with the next step's loss within 1e-5; the port's own checkpoint
resumes bit for bit. The three ``io.*`` fault sites act as the JAX
package's under ``PADDLE_FAULT_SPEC``.
"""
import contextlib
import io as _io
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.ops import pallas as jax_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from paddle_tpu.utils import fault_injection as jfi

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.framework import io as pio
from paddle_tpu_torch.utils import fault_injection as pfi

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers.stage_ref_data import stage_mnist  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = {"jax": paddle_tpu, "port": pt}


def _fresh_process_state():
    jax_comm._state.hybrid_mesh = pt_comm._mesh = None
    jax_pallas.flash_attention = jax_fa


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    """The port's default device is the CPU here (restored after); the
    module starts and ends in a fresh process's state."""
    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    yield
    pt_device._current = saved
    _fresh_process_state()


@pytest.fixture(scope="module")
def mnist_home(tmp_path_factory):
    home = tmp_path_factory.mktemp("datasets")
    stage_mnist(str(home), n_train=128, n_test=64)
    saved = os.environ.get("PADDLE_DATASET_HOME")
    os.environ["PADDLE_DATASET_HOME"] = str(home)
    yield home
    if saved is None:
        del os.environ["PADDLE_DATASET_HOME"]
    else:
        os.environ["PADDLE_DATASET_HOME"] = saved


@pytest.fixture(scope="module")
def lenet_weights():
    paddle_tpu.seed(7)
    net = paddle_tpu.vision.models.LeNet()
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _lenet(pkg, weights):
    net = pkg.vision.models.LeNet()
    net.set_state_dict(weights)
    return net


def _model(pkg, weights, metrics=None, sched=True):
    net = _lenet(pkg, weights)
    lr = pkg.optimizer.lr.StepDecay(learning_rate=1e-3, step_size=1,
                                    gamma=0.5) if sched else 1e-3
    opt = pkg.optimizer.Adam(learning_rate=lr, parameters=net.parameters())
    model = pkg.Model(net)
    model.prepare(opt, pkg.nn.CrossEntropyLoss(),
                  metrics if metrics is not None else pkg.metric.Accuracy())
    return model, opt


@pytest.fixture(scope="module")
def fits(mnist_home, lenet_weights, tmp_path_factory):
    """hapi_mnist_fit.py's program in both packages (see the module
    notes); per package: step logs, lr per epoch, printed text, VisualDL
    scalars, checkpoint files, evaluate and predict."""
    out = {}
    for name, pkg in PKGS.items():
        model, opt = _model(pkg, lenet_weights)
        logs, lrs = [], []

        class Record(pkg.hapi.callbacks.Callback):
            def on_epoch_begin(self, epoch, logs=None):
                lrs.append(opt.get_lr())

            def on_train_batch_end(self, step, logs_=None):
                logs.append(dict(logs_))

        vdl = pkg.hapi.callbacks.VisualDL()
        train = pkg.vision.datasets.MNIST(mode="train")
        val = pkg.vision.datasets.MNIST(mode="test")
        save_dir = tmp_path_factory.mktemp(f"ckpt_{name}")
        text = _io.StringIO()
        np.random.seed(21)
        with contextlib.redirect_stdout(text):
            model.fit(train, val, batch_size=32, epochs=2, verbose=2,
                      log_freq=2, save_dir=str(save_dir),
                      callbacks=[Record(), vdl])
            result = model.evaluate(val, batch_size=32, verbose=2)
        preds = model.predict(val, batch_size=32, stack_outputs=True,
                              verbose=0)
        out[name] = dict(logs=logs, lrs=lrs, text=text.getvalue(),
                         scalars=vdl.scalars, save_dir=save_dir,
                         files=sorted(os.listdir(save_dir)),
                         result=result, preds=preds, model=model)
    return out


def test_fit_step_losses_and_metrics_match(fits):
    a, b = fits["jax"]["logs"], fits["port"]["logs"]
    assert len(a) == len(b) == 8
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y) == ["acc", "loss"]
        np.testing.assert_allclose(y["loss"], x["loss"], **TOL)
        np.testing.assert_allclose(y["acc"], x["acc"], **TOL)
    assert b[-1]["loss"] < b[0]["loss"]


def test_evaluate_and_predict_match(fits):
    a, b = fits["jax"]["result"], fits["port"]["result"]
    assert sorted(a) == sorted(b) == ["acc", "loss"]
    for k in a:
        np.testing.assert_allclose(b[k], a[k], **TOL)
    pa, pb = fits["jax"]["preds"], fits["port"]["preds"]
    assert len(pa) == len(pb) == 1 and pb[0].shape == (64, 10)
    np.testing.assert_allclose(pb[0], np.asarray(pa[0]), **TOL)


_NUM = re.compile(r"-?\d+\.\d+")


def test_progbar_text_matches(fits):
    a = fits["jax"]["text"].splitlines()
    b = fits["port"]["text"].splitlines()
    assert len(a) == len(b) and any(ln.startswith("step ") for ln in b)
    for x, y in zip(a, b):
        assert _NUM.sub("#", x) == _NUM.sub("#", y)
        np.testing.assert_allclose([float(v) for v in _NUM.findall(y)],
                                   [float(v) for v in _NUM.findall(x)],
                                   rtol=0, atol=2e-4)


def test_lr_scheduler_callback_steps_per_epoch(fits):
    assert fits["jax"]["lrs"] == fits["port"]["lrs"] == [1e-3, 5e-4]


def test_model_checkpoint_files_and_visualdl_scalars(fits):
    assert fits["port"]["files"] == fits["jax"]["files"] == [
        f"{e}.{x}" for e in ("0", "1", "final") for x in ("pdopt",
                                                         "pdparams")]
    sa, sb = fits["jax"]["scalars"], fits["port"]["scalars"]
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert [s for s, _ in sa[k]] == [s for s, _ in sb[k]]
        np.testing.assert_allclose([v for _, v in sb[k]],
                                   [v for _, v in sa[k]], **TOL)
    final = pio.load(str(fits["port"]["save_dir"] / "final.pdparams"),
                     return_numpy=True)
    net = fits["port"]["model"].network
    for k, v in net.state_dict().items():
        assert np.array_equal(final[k], v.numpy())


@pytest.mark.parametrize("case", ["baseline", "min_delta"])
def test_early_stopping_matches(case, mnist_home, lenet_weights, tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        model, _ = _model(pkg, lenet_weights, sched=False)
        if case == "baseline":
            es = pkg.hapi.callbacks.EarlyStopping(
                "acc", mode="max", patience=0, baseline=1.01, verbose=0)
        else:
            es = pkg.hapi.callbacks.EarlyStopping(
                "loss", patience=1, min_delta=10.0, verbose=0)
        epochs = []

        class Count(pkg.hapi.callbacks.Callback):
            def on_epoch_end(self, epoch, logs=None):
                epochs.append(epoch)

        val = pkg.vision.datasets.MNIST(mode="test")
        np.random.seed(3)
        save_dir = tmp_path / name
        model.fit(val, val, batch_size=32, epochs=4, verbose=0,
                  save_dir=str(save_dir), callbacks=[es, Count()])
        out[name] = (epochs, model.stop_training, es.wait,
                     sorted(os.listdir(save_dir)))
    assert out["port"] == out["jax"]
    assert out["port"][0] == ([0] if case == "baseline" else [0, 1])


def _tiny_net(pkg):
    nn = pkg.nn
    return nn.Sequential(
        nn.Conv2D(3, 8, 3, padding=1), nn.BatchNorm2D(8), nn.ReLU(),
        nn.MaxPool2D(2, 2), nn.Conv2D(8, 8, 3, groups=2), nn.Sigmoid(),
        nn.AdaptiveAvgPool2D(2), nn.Flatten(), nn.Linear(32, 10),
        nn.Dropout(0.1))


@pytest.mark.parametrize("net", ["lenet", "tiny"])
def test_summary_and_flops_match(net, lenet_weights):
    out = {}
    for name, pkg in PKGS.items():
        if net == "lenet":
            layer, size = _lenet(pkg, lenet_weights), (1, 1, 28, 28)
        else:
            layer, size = _tiny_net(pkg), (2, 3, 16, 16)
        text = _io.StringIO()
        with contextlib.redirect_stdout(text):
            counts = pkg.summary(layer, size)
            fl = pkg.flops(layer, size, print_detail=True)
            via_model = pkg.Model(layer).summary(size)
        out[name] = (text.getvalue(), counts, fl, via_model)
    assert out["port"] == out["jax"]
    assert out["port"][1]["total_params"] > 0 and out["port"][2] > 0


def test_paddle_tpu_checkpoint_resumes_in_the_port(fits, lenet_weights,
                                                   tmp_path):
    """``paddle_tpu``'s ``Model.save`` after its fit, loaded by the port's
    ``Model.load`` into a fresh model and optimizer: the next step on one
    batch gives the reference's next loss and parameters within 1e-5."""
    ref = fits["jax"]["model"]
    ref.save(str(tmp_path / "ref"))
    model, opt = _model(pt, lenet_weights)
    model.load(str(tmp_path / "ref"))
    assert opt._step_count == ref._optimizer._step_count == 8
    x = np.random.RandomState(0).rand(16, 1, 28, 28).astype(np.float32)
    y = np.arange(16, dtype=np.int64) % 10
    want = ref.train_batch([x], [y])[0]  # the loss; the metric's state
    got = model.train_batch([x], [y])[0]  # is the model's, not saved
    np.testing.assert_allclose(got, want, **TOL)
    state = model.network.state_dict()
    for k, v in ref.network.state_dict().items():
        np.testing.assert_allclose(state[k].numpy(), np.asarray(v.numpy()),
                                   **TOL)


def test_port_checkpoint_resumes_bit_for_bit(fits, lenet_weights, tmp_path):
    model = fits["port"]["model"]
    model.save(str(tmp_path / "port"))
    crc = pio.crc32_file(str(tmp_path / "port.pdparams"))
    fresh, _ = _model(pt, lenet_weights)
    fresh.load(str(tmp_path / "port"))
    assert pio.crc32_file(str(tmp_path / "port.pdparams")) == crc
    x = np.random.RandomState(1).rand(16, 1, 28, 28).astype(np.float32)
    y = np.arange(16, dtype=np.int64) % 10
    # the loss; the metric's running state is the model's, not saved
    assert fresh.train_batch([x], [y])[0] == model.train_batch([x], [y])[0]
    a, b = model.network.state_dict(), fresh.network.state_dict()
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)


def test_save_and_load_across_packages(tmp_path):
    """A ``paddle_tpu.save`` file loads in the port (Tensor leaves, nested
    containers, numpy with ``return_numpy``); the port's file carries the
    same magic and crc scheme. Departure, pinned: ``paddle_tpu.load`` of a
    port file returns the port's leaf objects, not Tensors."""
    rng = np.random.RandomState(0)
    w, b = rng.rand(3, 4).astype(np.float32), np.arange(5)
    tree = {"w": paddle_tpu.to_tensor(w), "nested": [paddle_tpu.to_tensor(b),
                                                     (1, "s")],
            "raw": w.copy(), "n": 3}
    paddle_tpu.save(tree, str(tmp_path / "ref.pd"))
    got = pt.load(str(tmp_path / "ref.pd"))
    assert isinstance(got["w"], pt.Tensor) and got["w"].place.kind == "cpu"
    assert np.array_equal(got["w"].numpy(), w)
    assert np.array_equal(got["nested"][0].numpy(), b)
    assert got["nested"][1] == (1, "s") and got["n"] == 3
    assert np.array_equal(got["raw"], w)
    as_np = pt.load(str(tmp_path / "ref.pd"), return_numpy=True)
    assert isinstance(as_np["w"], np.ndarray)

    import torch

    ours = {"w": pt.to_tensor(w), "p": pt.nn.Linear(2, 3).weight,
            "bf16": torch.ones(2, dtype=torch.bfloat16), "nested": [1.5]}
    pt.save(ours, str(tmp_path / "port.pd"))
    with open(tmp_path / "port.pd", "rb") as f:
        assert f.read(7) == b"PDTPU1\n"
    back = pt.load(str(tmp_path / "port.pd"), return_numpy=True)
    assert np.array_equal(back["w"], w) and back["p"].shape == (2, 3)
    assert back["bf16"].dtype == np.float32 and back["nested"] == [1.5]
    assert pio.crc32_file(str(tmp_path / "port.pd")) == \
        paddle_tpu.framework.io.crc32_file(str(tmp_path / "port.pd"))
    ref_view = paddle_tpu.load(str(tmp_path / "port.pd"))
    assert type(ref_view["w"]) is pio._TensorLeaf
    assert np.array_equal(ref_view["w"].array, w)


@pytest.mark.parametrize("spec", ["io.save:fail:1", "io.save:fail:2",
                                  "io.load:fail:1", "io.save:corrupt:1",
                                  "io.save.post:corrupt:2"])
def test_io_fault_sites_act_as_the_reference(spec, tmp_path, monkeypatch):
    """Two saves and a load of each file under the same spec: the same
    faults raise at the same calls, and a corrupted (half-length) file
    fails to load in both packages."""
    monkeypatch.setenv("PADDLE_FAULT_SPEC", spec)
    out = {}
    for name, (pkg, fi) in {"jax": (paddle_tpu, jfi),
                            "port": (pt, pfi)}.items():
        fi.reset()
        events, sizes = [], []
        for i in range(2):
            path = str(tmp_path / f"{name}{i}.pd")
            try:
                pkg.save({"x": np.arange(64, dtype=np.float32)}, path)
                events.append("saved")
                sizes.append(os.path.getsize(path))
            except IOError as e:
                events.append(type(e).__name__)
        for i in range(2):
            try:
                pkg.load(str(tmp_path / f"{name}{i}.pd"))
                events.append("loaded")
            except Exception as e:
                events.append(type(e).__name__)
        out[name] = (events, sizes)
        fi.reset()
    assert out["port"] == out["jax"]
    assert any(e != "saved" and e != "loaded" for e in out["port"][0])


def test_refusals_match(lenet_weights, monkeypatch):
    for pkg in PKGS.values():
        net = _lenet(pkg, lenet_weights)
        model = pkg.Model(net)
        with pytest.raises(RuntimeError):
            model.train_batch([np.zeros((1, 1, 28, 28), np.float32)])
        with pytest.raises(NotImplementedError):
            model.prepare(pkg.optimizer.SGD(parameters=net.parameters()),
                          pkg.nn.CrossEntropyLoss(),
                          amp_configs={"level": "O1"})
        model.prepare(pkg.optimizer.SGD(parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss())
        with pytest.raises(NotImplementedError):
            model.train_batch([np.zeros((1, 1, 28, 28), np.float32)],
                              [np.zeros((1,), np.int64)], update=False)
        with pytest.raises(TypeError):
            model.prepare(metrics=[object()])
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(NotImplementedError, match="item 7"):
        pt.Model(_lenet(pt, lenet_weights)).prepare()
    # ported: both callbacks construct as in paddle_tpu
    for pkg in PKGS.values():
        assert pkg.hapi.callbacks.TerminateOnPreempt().preempted is False
        assert pkg.hapi.callbacks.GuardCallback(max_skips=3).max_skips == 3


def test_metrics_with_several_names_departure(mnist_home, lenet_weights):
    """``Accuracy(topk=(1, 2))``: the port logs ``acc_top1`` and
    ``acc_top2`` (upstream Paddle's names); the JAX package's ``fit``
    raises TypeError on the list of names (the named departure)."""
    val = paddle_tpu.vision.datasets.MNIST(mode="test")
    ref, _ = _model(paddle_tpu, lenet_weights,
                    paddle_tpu.metric.Accuracy(topk=(1, 2)))
    with pytest.raises(TypeError):
        ref.fit(val, batch_size=32, epochs=1, verbose=0, num_iters=1)
    model, _ = _model(pt, lenet_weights, pt.metric.Accuracy(topk=(1, 2)))
    logs = []

    class Record(pt.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs_=None):
            logs.append(dict(logs_))

    model.fit(pt.vision.datasets.MNIST(mode="test"), batch_size=32,
              epochs=1, verbose=0, num_iters=1, callbacks=[Record()])
    assert sorted(logs[0]) == ["acc_top1", "acc_top2", "loss"]
    assert logs[0]["acc_top1"] <= logs[0]["acc_top2"]
    res = model.evaluate(pt.vision.datasets.MNIST(mode="test"),
                         batch_size=32, verbose=0)
    assert sorted(res) == ["acc_top1", "acc_top2", "loss"]


def test_fit_from_a_worker_dataloader_with_num_iters(mnist_home,
                                                     lenet_weights):
    """``fit`` takes a ``DataLoader`` as it is (thread workers here) and
    stops after ``num_iters`` steps, skipping the eval pass, as the
    reference does."""
    out = {}
    for name, pkg in PKGS.items():
        model, _ = _model(pkg, lenet_weights, sched=False)
        ds = pkg.vision.datasets.MNIST(mode="test")
        loader = pkg.io.DataLoader(ds, batch_size=16, num_workers=2,
                                   use_shared_memory=False)
        losses = []

        class Record(pkg.hapi.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                losses.append(logs["loss"])

        model.fit(loader, ds, epochs=3, verbose=0, num_iters=3,
                  callbacks=[Record()])
        out[name] = losses
    assert len(out["port"]) == 3
    np.testing.assert_allclose(out["port"], out["jax"], **TOL)
