"""bench.py's GPT-medium program, as bench.py writes it, in a Paddle eager
loop through both packages; the surface the port has against the JAX
package's; and the two repairs of the port that the surface exposed.

- The copies of bench.py's ``_gpt_medium`` and of ``_bench_gpt``'s loss
  (in ``chip_smoke.py`` and in this file) equal bench.py's text except for
  their import lines, so they cannot drift.
- The program at 2 layers, d 128, 4 heads, vocab 512, seq 64, B 2 (the
  model class is the copy's, built at that size) runs ``paddle.seed``,
  ``to_tensor``, ``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``
  for three steps in each package from the same weights (the JAX model's
  ``state_dict()`` loaded as it is). AdamW as bench.py's (lr 1e-4, weight
  decay 0.01) with epsilon 1e-6, so that no update is decided by rounding
  a gradient near zero. Losses within 2e-5, parameters within 1e-4. The
  Pallas kernels run in interpret mode, the port's kernels their plain
  versions (``PADDLE_FLASH_DEFAULT`` / ``PADDLE_FUSED_LN=interpret``).
- Linear weights are paddle's ``[in, out]`` in both packages: the same
  numpy weight through ``F.linear`` and ``fused_linear_cross_entropy``
  gives the same result (float32, rtol = atol = 1e-5).
- Every top-level and op name of ``paddle_tpu`` the port lacks is in
  ``KNOWN_GAPS``, and every name there is still missing (the list only
  shrinks); likewise each name of ``nn``, ``nn.functional``,
  ``optimizer``, ``amp``, ``jit`` and ``distributed`` in
  ``KNOWN_NAMESPACE_GAPS``.
"""
import ast
import inspect
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.distributed import comm as jcomm
from paddle_tpu.ops import (creation, linalg, logic, manipulation, math,
                            search, sequence)

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as tcomm
from test_torch_ops_math import cpu_device  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(vocab=512, d=128, heads=4, layers=2, seq=64)
B, S = 2, 64


# -- bench.py's program, as bench.py writes it (imports pointed at the port)


def _gpt_medium(dense=False):
    """GPT-medium-shaped causal decoder (the single-chip proxy for
    BASELINE config 5's GPT-3 1.3B, which needs the dp x pp x mp hybrid
    dryrun_multichip proves): 24 ParallelGPTBlock layers (trivial 1-chip
    mesh — same code path the hybrid shards), d_model 1024, 16 heads,
    seq 1024, tied-free 32k vocab head.

    Round 6: the decoder hot path is the DEFAULT path — flash attention
    routes automatically inside every block (PADDLE_FLASH_DEFAULT policy)
    and the model returns the pre-head hidden state so the loss can run
    the blockwise fused vocab CE. `dense=True` is the escape-hatch
    configuration (forced dense attention + materialized-logits CE) used
    to record the routed/unrouted pair."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import ParallelGPTBlock, comm

    if comm.hybrid_mesh() is None:
        comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)

    class GPT(nn.Layer):
        def __init__(self, vocab=32000, d=1024, heads=16, layers=24,
                     seq=1024):
            super().__init__()
            self.embed = nn.Embedding(vocab, d)
            self.pos = nn.Embedding(seq, d)
            self.blocks = nn.LayerList([
                ParallelGPTBlock(
                    d, heads, dropout=0.0,
                    use_flash_attention=False if dense else None,
                )
                for _ in range(layers)
            ])
            self.head = nn.Linear(d, vocab)

        def forward(self, ids):
            T = ids.shape[1]
            pos_ids = paddle.arange(T, dtype="int64")
            h = self.embed(ids) + self.pos(pos_ids)
            for blk in self.blocks:
                h = blk(h)
            # the head projection lives in the LOSS (blockwise fused CE
            # streams it over vocab chunks); the dense escape hatch
            # materializes the logits here as before
            return self.head(h) if dense else h

    return GPT()


def _bench_lm_loss(model):
    """bench.py's ``_bench_gpt`` loss over ``model``'s head (its
    ``fused_linear_cross_entropy`` branch)."""
    from paddle_tpu_torch import nn

    def lm_loss(h, labels):
        d = h.shape[-1]
        # blockwise fused head-projection + CE: the [B*S, 32k] f32
        # logits/grads never materialize at once (PADDLE_CE_CHUNK)
        return nn.functional.fused_linear_cross_entropy(
            h.reshape([-1, d]), model.head.weight, model.head.bias,
            labels.reshape([-1]),
        )

    return lm_loss


# -- the text check ----------------------------------------------------------


def _functions(path):
    src = path.read_text()
    tree = ast.parse(src)
    return src, {n.name: n for n in ast.walk(tree)
                 if isinstance(n, ast.FunctionDef)}


def _bench_texts():
    """bench.py's ``_gpt_medium`` and its fused-CE ``lm_loss``."""
    src, fns = _functions(REPO / "bench.py")
    lm = next(n for n in ast.walk(fns["_bench_gpt"])
              if isinstance(n, ast.FunctionDef) and n.name == "lm_loss"
              and "fused_linear" in ast.get_source_segment(src, n))
    return (ast.get_source_segment(src, fns["_gpt_medium"]),
            textwrap.dedent(ast.get_source_segment(src, lm, padded=True)))


def _unported(text):
    """The import lines pointed back at the JAX package."""
    return "\n".join(
        line.replace("paddle_tpu_torch", "paddle_tpu")
        if line.strip().startswith(("import ", "from ")) else line
        for line in text.splitlines())


@pytest.mark.parametrize("where", ["chip_smoke.py", "test"])
def test_bench_copies_match_bench_py(where):
    gpt, lm = _bench_texts()
    if where == "test":
        src, fns = _functions(Path(__file__))
    else:
        src, fns = _functions(REPO / where)
    got_gpt = ast.get_source_segment(src, fns["_gpt_medium"])
    copy_lm = next(n for n in ast.walk(fns["_bench_lm_loss"])
                   if isinstance(n, ast.FunctionDef) and n.name == "lm_loss")
    got_lm = textwrap.dedent(ast.get_source_segment(src, copy_lm,
                                                    padded=True))
    assert "paddle_tpu_torch" in got_gpt
    assert _unported(got_gpt) == gpt
    assert got_lm == lm


# -- the program through both packages -------------------------------------


@pytest.fixture()
def interpret(monkeypatch):
    """The kernels' interpret routes, and no hybrid mesh before or after
    (bench's ``_gpt_medium`` declares its one-device mesh only when there
    is none)."""
    monkeypatch.setenv("PADDLE_FLASH_DEFAULT", "interpret")
    monkeypatch.setenv("PADDLE_FUSED_LN", "interpret")
    jcomm._state.hybrid_mesh = tcomm._mesh = None
    yield
    jcomm._state.hybrid_mesh = tcomm._mesh = None


def _gpt_class(fn):
    """The GPT class of a ``_gpt_medium`` text (its last line returns the
    class instead of an instance, so it can be built small)."""
    src = textwrap.dedent(inspect.getsource(fn)) if callable(fn) else fn
    ns = {}
    assert src.count("return GPT()") == 1
    exec(src.replace("return GPT()", "return GPT"), ns)
    return ns["_gpt_medium"]()


def _batch():
    n = B * S
    ids = (np.arange(n) % (SMALL["vocab"] - 12)).reshape(B, S)
    return ids, ((np.arange(n) + 1) % (SMALL["vocab"] - 12)).reshape(B, S)


def _eager_steps(paddle, model, lm_loss, ids, labels, steps=3):
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, epsilon=1e-6,
                                 weight_decay=0.01,
                                 parameters=model.parameters())
    x, y = paddle.to_tensor(ids), paddle.to_tensor(labels)
    losses = []
    for _ in range(steps):
        loss = lm_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(np.asarray(loss.numpy())))
    return losses


def test_gpt_program_matches_paddle_tpu(interpret):
    gpt, _ = _bench_texts()
    paddle_tpu.seed(0)
    jm = _gpt_class(gpt)(**SMALL)
    pt.seed(0)
    tm = _gpt_class(_gpt_medium)(**SMALL)
    assert list(tm.head.weight.shape) == jm.head.weight.shape == [128, 512]
    assert tm.set_state_dict({k: np.asarray(v.numpy())
                              for k, v in jm.state_dict().items()}) == ([], [])
    jnn = paddle_tpu.nn

    def jax_loss(h, labels):  # bench.py's lm_loss, in the JAX package
        d = h.shape[-1]
        return jnn.functional.fused_linear_cross_entropy(
            h.reshape([-1, d]), jm.head.weight, jm.head.bias,
            labels.reshape([-1]))

    ids, labels = _batch()
    want = _eager_steps(paddle_tpu, jm, jax_loss, ids, labels)
    got = _eager_steps(pt, tm, _bench_lm_loss(tm), ids, labels)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert got[-1] < got[0]
    jsd = jm.state_dict()
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jsd[k].numpy()),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_gpt_program_through_train_step_and_minimize(interpret):
    """The same class through the port's ``jit.TrainStep`` (a loss that
    returns a ``Tensor``) and an eager loop that calls ``minimize``: the
    same losses as the ``backward()``/``step()`` loop."""
    cls = _gpt_class(_gpt_medium)
    pt.seed(1)
    a = cls(**SMALL)
    state = a.state_dict()
    b, c = cls(**SMALL), cls(**SMALL)
    b.set_state_dict(state)
    c.set_state_dict(state)
    ids, labels = _batch()
    want = _eager_steps(pt, a, _bench_lm_loss(a), ids, labels)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, epsilon=1e-6,
                             weight_decay=0.01, parameters=b.parameters())
    step = pt.jit.TrainStep(b, _bench_lm_loss(b), opt)
    got = [float(step(pt.to_tensor(ids), pt.to_tensor(labels)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, epsilon=1e-6,
                             weight_decay=0.01, parameters=c.parameters())
    lm_loss, x, y = _bench_lm_loss(c), pt.to_tensor(ids), pt.to_tensor(labels)
    mins = []
    for _ in range(3):
        loss = lm_loss(c(x), y)
        opt.minimize(loss)
        opt.clear_grad()
        mins.append(float(loss))
    np.testing.assert_allclose(mins, want, rtol=1e-6, atol=0)


# -- the two repairs -------------------------------------------------------


def test_linear_weights_are_in_out_in_both_packages():
    """Repair 1: the same numpy ``[in, out]`` weight through both packages'
    ``F.linear``, ``fused_linear_cross_entropy`` and ``nn.Linear`` (the
    port computed ``x @ w^T`` and held ``[out, in]``; a square weight
    gave a wrong result in silence)."""
    r = np.random.RandomState(0)
    x, w, b = (r.randn(5, 6).astype(np.float32),
               r.randn(6, 6).astype(np.float32),
               r.randn(6).astype(np.float32))
    JF, TF = paddle_tpu.nn.functional, pt.nn.functional
    want = np.asarray(JF.linear(*(paddle_tpu.to_tensor(a) for a in (x, w, b))
                                ).numpy())
    np.testing.assert_allclose(
        TF.linear(*(pt.to_tensor(a) for a in (x, w, b))).numpy(), want,
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want, x @ w + b, rtol=1e-5, atol=1e-5)
    h, hw, hb = (r.randn(8, 6).astype(np.float32),
                 r.randn(6, 40).astype(np.float32),
                 r.randn(40).astype(np.float32))
    lab = r.randint(0, 40, 8)
    for chunk in (16, 0):
        jl = JF.fused_linear_cross_entropy(
            *(paddle_tpu.to_tensor(a) for a in (h, hw, hb, lab)),
            chunk=chunk)
        tl = TF.fused_linear_cross_entropy(
            *(pt.to_tensor(a) for a in (h, hw, hb, lab)), chunk=chunk)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-5)
    assert list(pt.nn.Linear(3, 4).weight.shape) == \
        paddle_tpu.nn.Linear(3, 4).weight.shape == [3, 4]


def test_parallel_gpt_block_positional_dropout():
    """Repair 2: ``ParallelGPTBlock(d, h, None, 0.1)`` means dropout 0.1
    in both packages (the port read the fourth argument as ``mp``)."""
    prev = jcomm._state.hybrid_mesh
    jcomm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
    try:
        for pkg in (paddle_tpu, pt):
            blk = pkg.distributed.ParallelGPTBlock(16, 4, None, 0.1)
            assert blk.dropout == 0.1 and blk.attn.dropout == 0.1
    finally:
        jcomm._state.hybrid_mesh = prev


# -- the surface -----------------------------------------------------------

#: names of paddle_tpu's namespace the port does not have yet, by the
#: ROADMAP queue A item that brings them; the list only shrinks
KNOWN_GAPS = {
    # item 9: the tail
    "device", "sysconfig",
    # TPU places: the port has CUDA and CPU places
    "TPUPlace", "is_compiled_with_tpu",
}


def _reference_names():
    """The public names ``paddle_tpu/__init__.py`` binds (read from its
    source, so a submodule another test imported does not count), with
    its ``from .ops import *``: the op modules and their ``__all__``."""
    tree = ast.parse((REPO / "paddle_tpu" / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.FunctionDef):
            names.add(node.name)
    ops = (creation, linalg, logic, manipulation, math, search, sequence)
    names |= {m.__name__.rsplit(".", 1)[1] for m in ops}
    for mod in ops:
        names |= set(mod.__all__)
    return {n for n in names if not n.startswith("_") and n != "*"}


#: names of paddle_tpu's sub-namespaces the port does not have yet, by the
#: ROADMAP queue A item that brings them; each list only shrinks
KNOWN_NAMESPACE_GAPS = {
    # items 2 and 3 (the rest of nn, the optimizers and AMP): ported
    "nn": set(),
    "nn.functional": set(),
    "optimizer": set(),
    "amp": set(),
    # item 4 (io, metric, the vision data) and item 5's hapi: ported
    "io": set(),
    "metric": set(),
    "hapi": set(),
    "vision.models": set(),
    "vision.datasets": set(),
    "vision.transforms": set(),
    "vision": set(),
    # item 5 (vision/ops.py) is ported; "AG" is that module's alias of
    # core.autograd, no API
    "vision.ops": {"AG"},
    # item 7's MoE and auto_checkpoint: ported
    "incubate": set(),
    "incubate.checkpoint.auto_checkpoint": set(),
    # item 8's training half: ported; the fleet monitor and the rank and
    # controller fault sites wait for item 7
    "profiler": set(),
    "hapi.callbacks": set(),
    "utils.train_guard": set(),
    "observability": {"FleetMonitor"},
    "observability.metrics": set(),
    "utils.fault_injection": {"consume_rank_events", "consume_ctl_events"},
    # item 6 (to_static, jit.save/load): ported
    "jit": set(),
    "distributed": {
        # item 7's later parts: resharding (the pipeline is ported)
        "resharding"},
}


def _namespace_names(mod):
    """A sub-namespace's public names: ``dir()`` without private names,
    without modules its ``__init__.py`` does not name (``np``, ``jnp``, or
    a submodule that another test imported), and without re-exports of a
    top-level name (counted at the top level)."""
    import re
    import types

    init = Path(mod.__file__).read_text()
    names = set()
    for n in dir(mod):
        v = getattr(mod, n)
        if n.startswith("_") or (isinstance(v, types.ModuleType) and (
                not v.__name__.startswith("paddle_tpu")
                or not re.search(rf"\b{n}\b", init))):
            continue
        if getattr(paddle_tpu, n, None) is v and hasattr(pt, n):
            continue
        names.add(n)
    return names


@pytest.mark.parametrize("namespace", sorted(KNOWN_NAMESPACE_GAPS))
def test_namespace_gaps_are_known(namespace):
    import importlib

    ref = importlib.import_module(f"paddle_tpu.{namespace}")
    port = importlib.import_module(f"paddle_tpu_torch.{namespace}")
    missing = {n for n in _namespace_names(ref) if not hasattr(port, n)}
    known = KNOWN_NAMESPACE_GAPS[namespace]
    assert missing - known == set(), f"names missing from {namespace}"
    assert known - missing == set(), \
        f"ported names still listed as gaps of {namespace}: take them off"


def test_surface_gaps_are_known():
    missing = {n for n in _reference_names() if not hasattr(pt, n)}
    assert missing - KNOWN_GAPS == set(), "names missing from the port"
    assert KNOWN_GAPS - missing == set(), \
        "ported names still listed as gaps: take them off KNOWN_GAPS"
    for name in ("Tensor", "Parameter", "to_tensor", "seed", "set_device",
                 "get_device", "no_grad", "grad", "get_flags", "set_flags",
                 "ParamAttr", "in_dynamic_mode", "matmul", "concat", "nn",
                 "optimizer", "tensor"):
        assert hasattr(pt, name), name
    assert pt.in_dynamic_mode() is True
    assert pt.tensor.matmul is pt.matmul
    assert pt.tensor.creation is pt.creation


# -- device, seed, mesh ----------------------------------------------------


def test_set_device_and_no_fallback():
    """``set_device("cpu")`` is the default of every later call; without
    a card, asking for it raises (the default before ``set_device``
    included): nothing falls back to the CPU in silence."""
    saved = pt_device._current
    try:
        pt.set_device("cpu")
        assert pt.get_device() == "cpu"
        assert pt.to_tensor([1.0])._data.device.type == "cpu"
        assert pt.CPUPlace() == pt.Place("cpu", 0)
        assert pt.is_compiled_with_cuda()
        with pytest.raises(ValueError):
            pt.set_device("tpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pt.set_device("gpu:0")
            pt_device._current = None
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pt.zeros([1])
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pt.nn.Linear(2, 2)
    finally:
        pt_device._current = saved


def test_one_device_mesh():
    """The one-process mesh; a degree the world cannot hold raises
    (ValueError: the world has fewer ranks), pp and sp as dp, and the
    hierarchical factoring as dp (and a dp that ``dp_inner`` does not
    divide)."""
    prev = tcomm._mesh
    try:
        mesh = tcomm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
        assert tcomm.hybrid_mesh() is mesh and mesh.shape["mp"] == 1
        with pytest.raises(ValueError, match="the world has 1"):
            tcomm.init_hybrid_mesh(dp=2)
        with pytest.raises(ValueError, match="the world has 1"):
            tcomm.init_hybrid_mesh(pp=2)
        with pytest.raises(ValueError, match="the world has 1"):
            tcomm.init_hybrid_mesh(sp=2)
        with pytest.raises(ValueError, match="the world has 1"):
            tcomm.init_hybrid_mesh(dp=2, dp_inner=2)
        with pytest.raises(ValueError, match="not divisible"):
            tcomm.init_hybrid_mesh(dp_inner=2)
    finally:
        tcomm._mesh = prev
