"""The port's own ``import paddle`` route (``paddle_tpu_torch/compat``)
and its launcher (``python -m paddle_tpu_torch.run``).

- The four scripts of tests/reference_scripts/ run verbatim through the
  launcher on the CPU (``--device cpu``), each in a subprocess of its own
  (the four at once, ``chip_smoke.run_reference_scripts``), on the data of
  tests/helpers/stage_ref_data.py at tests/test_reference_scripts.py's
  caps: each exits 0, its loss falls (that harness's pattern), and its
  process loads neither ``jax`` nor ``paddle_tpu`` (the launcher's exit
  line).
- In a subprocess, ``paddle`` is the route: ``paddle.nn is
  paddle_tpu_torch.nn``, module identity in ``sys.modules``.
- The route's names in ``paddle``, ``paddle.fluid``, ``fluid.layers``,
  ``fluid.dygraph`` and ``paddle.jit`` against the JAX alias's (imported
  here under the name ``paddle``; the route imports as
  ``paddle_tpu_torch.compat.paddle``): what is missing is listed in
  ``GAPS``, which may only shrink.
"""
import json
import os
import subprocess
import sys

import pytest

import paddle
import paddle.fluid as jfluid
import paddle_tpu

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch
import paddle_tpu_torch.compat.paddle as route
from paddle_tpu_torch.ops import kernels
from chip_smoke import REF_SCRIPTS, run_reference_scripts
from test_torch_ops_math import cpu_device  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GAPS = {
    "paddle": {
        # TPU places: the port has CUDA and CPU places
        "TPUPlace", "is_compiled_with_tpu",
        # ROADMAP queue A item 9: the tail (incubate and profiler: ported)
        "device", "sysconfig"},
    "fluid": {"TPUPlace", "is_compiled_with_tpu"},
    # modules the JAX package's star imports of nn.functional and ops carry
    # into fluid.layers under names its source uses otherwise (the port's
    # namespaces list their names in __all__): no API
    "fluid.layers": {"activation", "loss", "sequence"},
    "fluid.dygraph": set(),
    # ROADMAP queue A item 6 (to_static, jit.save/load): ported
    "jit": set(),
}


def _names(mod, src_mod=None):
    """Public names, without modules that the source of ``src_mod`` (the
    namespace itself by default; the package the namespace re-exports)
    does not name: a submodule another test imported, or one a star import
    carried along."""
    import re
    import types

    src = open((src_mod or mod).__file__).read()
    return {n for n in dir(mod) if not n.startswith("_") and not (
        isinstance(getattr(mod, n), types.ModuleType)
        and not re.search(rf"\b{n}\b", src))}


@pytest.mark.parametrize("namespace", sorted(GAPS))
def test_route_names_against_the_jax_alias(namespace):
    ref = {"paddle": paddle, "fluid": jfluid, "fluid.layers": jfluid.layers,
           "fluid.dygraph": jfluid.dygraph, "jit": paddle.jit}[namespace]
    got = {"paddle": route, "fluid": route.fluid,
           "fluid.layers": route.fluid.layers,
           "fluid.dygraph": route.fluid.dygraph,
           "jit": route.jit}[namespace]
    src = {"paddle": (paddle_tpu, paddle_tpu_torch)}.get(namespace,
                                                          (None, None))
    missing = _names(ref, src[0]) - _names(got, src[1])
    assert missing - GAPS[namespace] == set(), "names missing from the route"
    assert GAPS[namespace] - missing == set(), \
        "ported names still listed as gaps: take them off"


def test_route_is_not_installed_by_importing_the_port():
    assert sys.modules["paddle"] is paddle
    assert paddle.__file__ == os.path.join(REPO, "paddle", "__init__.py")
    assert route.nn is sys.modules["paddle_tpu_torch.nn"]
    assert route.fluid.__name__ == "paddle_tpu_torch.compat.paddle.fluid"


def test_refused_names_keep_the_reference_message():
    for io_mod in (jfluid.io, route.fluid.io):
        with pytest.raises(NotImplementedError, match="out of scope"):
            io_mod.save_inference_model("d", [], [], None)
        with pytest.raises(NotImplementedError, match="out of scope"):
            io_mod.load_inference_model("d", None)
    with pytest.raises(NotImplementedError, match="TracedLayer"):
        route.fluid.dygraph.TracedLayer()
    assert not route.fluid.core.is_compiled_with_cuda()  # no card here


def _launch(code, tmp_path, *args):
    script = tmp_path / "probe.py"
    script.write_text(code)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.run", *args, str(script)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_launcher_installs_the_route(tmp_path):
    proc = _launch(
        "import json, sys\n"
        "import paddle\n"
        "import paddle.fluid as fluid\n"
        "import paddle_tpu_torch\n"
        "print(json.dumps({\n"
        "  'nn': paddle.nn is paddle_tpu_torch.nn,\n"
        "  'identity': sys.modules['paddle.nn'] is "
        "sys.modules['paddle_tpu_torch.nn'],\n"
        "  'fluid': fluid.__file__,\n"
        "  'argv': sys.argv[1:],\n"
        "  'loaded': sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'paddle_tpu'))}))\n", tmp_path, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["nn"] and got["identity"] and got["loaded"] == []
    assert got["fluid"].startswith(os.path.join(
        REPO, "paddle_tpu_torch", "compat", "paddle", "fluid"))
    assert "device=cpu max_memory_allocated=0 jax_loaded=False " \
        "paddle_tpu_loaded=False kernel_launches={" in proc.stderr


def test_launcher_runs_on_the_card_unless_asked(tmp_path):
    proc = _launch("print('ran')\n", tmp_path)
    assert proc.returncode != 0 and "ran" not in proc.stdout
    assert "no CUDA device" in proc.stderr


@pytest.fixture(scope="module")
def script_runs(tmp_path_factory):
    from helpers.stage_ref_data import stage_all

    home = stage_all(str(tmp_path_factory.mktemp("paddle_dataset_home")))
    return run_reference_scripts(home, device="cpu", timeout=300)


@pytest.mark.parametrize("name", sorted(REF_SCRIPTS))
def test_reference_script_verbatim_on_the_port(script_runs, name):
    src = open(os.path.join(REPO, "tests", "reference_scripts", name)).read()
    assert "paddle_tpu" not in src
    rc, out, err, _, losses, line = script_runs[name]
    assert rc == 0, f"{name} exited {rc}\n{out[-3000:]}\n{err[-3000:]}"
    assert len(losses) >= 2 and losses[-1] < losses[0], (losses, out)
    assert line[:4] == ("cpu", 0, False, False), err[-2000:]
    assert set(line[4]) == set(kernels.WRAPPERS) and not any(
        line[4].values())


def test_data_parallel_at_one_trainer(monkeypatch):
    """``fluid.dygraph.DataParallel`` (``distributed/parallel.py``) at a
    world size of one: the wrapped layer itself, inputs passed as given
    (a user's ``forward`` gets ``Tensor``), its state dict; launched as
    one of several trainers without their endpoints, it raises."""
    pt = paddle_tpu_torch
    seen = []

    class Net(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(3, 2)

        def forward(self, x):
            seen.append(type(x))
            return self.fc(x)

    net = Net()
    env = route.fluid.dygraph.prepare_context() or pt.distributed.ParallelEnv()
    assert (env.rank, env.world_size, env.nranks) == (0, 1, 1)
    dp = route.fluid.dygraph.DataParallel(net)
    x = pt.to_tensor([[1.0, 2.0, 3.0]])
    out = dp(x)
    assert seen == [pt.Tensor] and isinstance(out, pt.Tensor)
    assert (out.numpy() == net(x).numpy()).all()
    assert dp.scale_loss(out) is out
    assert list(dp.state_dict()) == list(net.state_dict())
    # a fresh process launched as one of two trainers needs their
    # endpoints to meet (a world of several: tests/test_torch_collective.py)
    comm = pt.distributed.comm
    saved = comm._state
    comm._state = comm._CommState()
    try:
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        with pytest.raises(ValueError, match="PADDLE_TRAINER_ENDPOINTS"):
            pt.distributed.init_parallel_env()
        with pytest.raises(ValueError, match="PADDLE_TRAINER_ENDPOINTS"):
            pt.DataParallel(net)
    finally:
        comm._state = saved
