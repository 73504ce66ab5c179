"""``jit.save`` -> ``jit.load`` -> ``paddle.inference`` of the port against
the JAX package's, on the CPU, and ``paddle.onnx``.

- A Layer with the JAX Layer's weights is saved by each package at the
  same ``InputSpec``; each package's ``create_predictor`` serves its own
  artifact through ``copy_from_cpu`` / ``run`` / ``copy_to_cpu`` on the
  same numpy input: the port's outputs equal its eager forward's, and
  the JAX package's within float32 rounding (rtol 1e-5, atol 1e-6); the
  input and output names are the reference's.
- A missing feed raises; ``onnx.export`` raises, naming the port's
  artifact.
- In a fresh interpreter that imports ``paddle_tpu_torch`` and nothing
  that defines the model, the artifact's output equals the eager one bit
  for bit, and neither ``jax`` nor ``paddle_tpu`` is loaded.
- Devices: the artifact records the device it was captured on; ``load``
  moves the program to the one asked for (here ``meta``, the only other
  device this host has), and ``Config.disable_gpu`` / ``enable_use_gpu``
  choose the predictor's device.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from test_torch_ops_math import cpu_device  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)


def _net(pkg):
    nn, F = pkg.nn, pkg.nn.functional

    class Net(nn.Layer):
        """Two outputs (a tuple), a LayerNorm and a GELU on the way."""

        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(6, 16)
            self.norm = nn.LayerNorm(16)
            self.fc2 = nn.Linear(16, 3)

        def forward(self, x):
            h = F.gelu(self.norm(self.fc1(x)))
            return self.fc2(h), h.mean(axis=-1)

    return Net()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Both packages' artifacts of one set of weights, and the input."""
    root = tmp_path_factory.mktemp("artifacts")
    paddle_tpu.seed(0)
    j = _net(paddle_tpu)
    t = _net(pt)
    t.set_state_dict({k: np.asarray(v.numpy())
                      for k, v in j.state_dict().items()})
    j.eval()
    t.eval()
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    paths = {}
    for pkg, net in ((paddle_tpu, j), (pt, t)):
        paths[pkg] = os.path.join(root, pkg.__name__, "net")
        pkg.jit.save(net, paths[pkg],
                     input_spec=[pkg.jit.InputSpec([4, 6], "float32")])
    with torch.no_grad():
        eager = [o.numpy() for o in t(pt.to_tensor(x))]
    return paths, x, eager


def _serve(pkg, path, x, device=None):
    config = pkg.inference.Config(path + ".pdmodel")
    if device == "cpu":
        config.disable_gpu()
    pred = pkg.inference.create_predictor(config)
    assert pred.get_input_names() == ["input_0"]
    names = pred.get_output_names()
    pred.get_input_handle("input_0").copy_from_cpu(x)
    assert pred.run()
    return names, [pred.get_output_handle(f"output_{i}").copy_to_cpu()
                   for i in range(2)]


def test_predictor_matches_eager_and_paddle_tpu(artifacts):
    paths, x, eager = artifacts
    jnames, want = _serve(paddle_tpu, paths[paddle_tpu], x)
    names, got = _serve(pt, paths[pt], x, device="cpu")
    # the port names every output before the first run; the JAX package
    # names one whatever the count (its output tree has no leaf count)
    assert names == ["output_0", "output_1"] and jnames == ["output_0"]
    for g, e, w in zip(got, eager, want):
        np.testing.assert_array_equal(g, e)
        np.testing.assert_allclose(g, w, **TOL)


def test_load_matches_paddle_tpu_load(artifacts):
    paths, x, eager = artifacts
    want = paddle_tpu.jit.load(paths[paddle_tpu])(paddle_tpu.to_tensor(x))
    loaded = pt.jit.load(paths[pt])
    assert isinstance(loaded, pt.jit.TranslatedLayer)
    got = loaded(pt.to_tensor(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()), **TOL)
    # the loaded program is differentiable in its own parameters
    got[0].sum().backward()
    assert all(p.grad is not None for p in loaded.parameters())


def test_missing_feed_raises(artifacts):
    paths, _, _ = artifacts
    config = pt.inference.Config(paths[pt])
    config.disable_gpu()
    pred = pt.inference.create_predictor(config)
    with pytest.raises(RuntimeError, match="was not fed"):
        pred.run()
    with pytest.raises(RuntimeError, match="holds no data"):
        pred.get_output_handle("output_0").copy_to_cpu()
    with pytest.raises(ValueError, match="artifact path"):
        pt.inference.create_predictor(pt.inference.Config())


def test_onnx_export_raises():
    for pkg in (paddle_tpu, pt):
        with pytest.raises(NotImplementedError, match="jit.save"):
            pkg.onnx.export(_net(pkg), "unused")


def test_save_requires_input_spec():
    with pytest.raises(ValueError, match="input_spec"):
        pt.jit.save(_net(pt), "unused")
    with pytest.raises(TypeError):
        pt.jit.save(object(), "unused", input_spec=[])


def test_fresh_process_loads_without_the_model_source(artifacts, tmp_path):
    paths, x, eager = artifacts
    np.save(tmp_path / "x.npy", x)
    script = f"""
import json, sys
import numpy as np
import paddle_tpu_torch as paddle
paddle.set_device("cpu")
layer = paddle.jit.load({paths[pt]!r})
outs = layer(paddle.to_tensor(np.load({str(tmp_path / 'x.npy')!r})))
for i, o in enumerate(outs):
    np.save({str(tmp_path)!r} + f"/out{{i}}.npy", o.numpy())
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "paddle_tpu", "test_torch_inference", "paddle"))))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
    for i, e in enumerate(eager):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{i}.npy"), e)


def test_artifact_moves_to_the_device_asked_for(artifacts):
    """An artifact captured on one device loads on another: the program's
    devices are rewritten (here to ``meta``, which computes shapes only),
    and the weights follow."""
    paths, x, eager = artifacts
    with open(paths[pt] + ".pdmeta") as f:
        meta = json.load(f)
    assert meta["device"] == "cpu" and meta["n_outputs"] == 2
    assert meta["input_specs"] == [[[4, 6], "float32"]]
    loaded = pt.jit.load(paths[pt], device="meta")
    assert all(p.device.type == "meta" for p in loaded.parameters())
    outs = loaded(torch.empty(4, 6, device="meta"))  # torch in, torch out
    assert [tuple(o.shape) for o in outs] == [(4, 3), (4,)]
    assert all(o.device.type == "meta" for o in outs)
    config = pt.inference.Config(paths[pt])
    assert config.device() is None  # the set_device default: the card
    config.enable_use_gpu(100, 1)
    assert config.device() == "cuda:1" and config.use_gpu()
    config.disable_gpu()
    assert config.device() == "cpu" and not config.use_gpu()


def test_none_dim_is_captured_at_one(tmp_path):
    t = _net(pt)
    t.eval()
    path = str(tmp_path / "net")
    meta = pt.jit.save(t, path, input_spec=[pt.jit.InputSpec([None, 6])])
    assert meta["input_specs"] == [[[None, 6], "float32"]]
    x = np.ones((1, 6), np.float32)
    got = pt.jit.load(path)(pt.to_tensor(x))
    with torch.no_grad():
        want = t(pt.to_tensor(x))
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
