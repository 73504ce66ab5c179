"""The six kernels of ``ops/kernels`` as ``torch.library`` custom ops, on
the CPU (their plain versions), torch only.

- ``torch.library.opcheck`` passes on each op at small shapes (schema,
  autograd registration, fake implementation, AOT dispatch with dynamic
  shapes); the forward ops with inputs that require grad, so their
  registered autograd formulas are checked too; and on the draw op the
  ``to_static`` capture routes random draws to.
- ``torch.export`` of a module that calls each op records the op itself:
  the graph holds ``torch.ops.paddle_tpu_torch.<name>`` and no
  ``empty`` / ``empty_like`` in its place, and the exported module gives
  the eager call's outputs (a fake tensor's empty outputs would not).
- The forward ops' autograd formulas agree with ``gradcheck`` in float64.
- ``flash_attention_partial`` (over B1 and B3/B4) passes ``opcheck``,
  exports as itself and its lse-cotangent formula agrees with
  ``gradcheck``.
The card's shapes: ``tests/test_torch_cuda.py`` (``-m cuda``).
"""
import pytest
import torch

from helpers.torch_threads import one_torch_thread  # noqa: F401
from paddle_tpu_torch.core import random as rnd
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import layer_norm as ln

OPS = torch.ops.paddle_tpu_torch
B, H, S, D, R, W = 1, 2, 16, 8, 16, 128


def _gen():
    return torch.Generator().manual_seed(0)


def _qkv(grad=False, dtype=torch.float32):
    g = _gen()
    return [torch.randn(B, H, S, D, generator=g, dtype=dtype
                        ).requires_grad_(grad) for _ in range(3)]


def _ln_inputs(grad=False, dtype=torch.float32):
    g = _gen()
    x = torch.randn(R, W, generator=g, dtype=dtype).requires_grad_(grad)
    y = torch.randn(R, W, generator=g, dtype=dtype).requires_grad_(grad)
    w = (1 + 0.1 * torch.randn(W, generator=g, dtype=dtype)
         ).requires_grad_(grad)
    b = (0.1 * torch.randn(W, generator=g, dtype=dtype)).requires_grad_(grad)
    return x, y, w, b


def _bwd_flash_args():
    q, k, v = _qkv()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, block_q=8,
                                      block_k=8)
    dout = torch.randn(B, H, S, D, generator=_gen())
    delta = (dout * out).sum(-1)
    return (q, k, v, dout, lse, delta, True, None, 0, 0)


def _bwd_ln_args():
    x, _, w, b = _ln_inputs()
    _, mu, rs = ln.layer_norm_fwd(x, w, b)
    return (x, w, mu, rs, torch.randn(R, W, generator=_gen()))


def _args(name):
    q, k, v = _qkv(grad=True)
    x, y, w, b = _ln_inputs(grad=True)
    return {
        "flash_attention_fwd": lambda: (q, k, v, True, 8, 8, None, 0, 0),
        "flash_attention_bwd_dq": _bwd_flash_args,
        "flash_attention_bwd_dkv": _bwd_flash_args,
        "layer_norm_fwd": lambda: (x, w, b, 1e-5),
        "add_layer_norm_fwd": lambda: (x, y, w, b, 1e-5),
        "layer_norm_bwd": _bwd_ln_args,
    }[name]()


def test_the_six_wrappers_are_the_registered_ops():
    assert set(kernels.WRAPPERS) == {
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "layer_norm_fwd", "add_layer_norm_fwd",
        "layer_norm_bwd"}
    for name in kernels.WRAPPERS:
        assert isinstance(getattr(OPS, name).default, torch._ops.OpOverload)
    assert _build.NAMESPACE == "paddle_tpu_torch"
    assert not hasattr(_build, "probe_shapes")


@pytest.mark.parametrize("name", sorted(kernels.WRAPPERS))
def test_opcheck(name):
    result = torch.library.opcheck(getattr(OPS, name), _args(name))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("kind", ["uniform", "normal"])
def test_opcheck_draw(kind):
    result = torch.library.opcheck(
        OPS.draw, (kind, [3, 4], torch.float32, torch.device("cpu"), 7),
        test_utils=("test_schema", "test_faketensor"))
    assert set(result.values()) == {"SUCCESS"}, result


class _Calls(torch.nn.Module):
    """A module whose forward calls one op through its caller."""

    def __init__(self, name):
        super().__init__()
        self.name = name

    def forward(self, *args):
        if self.name == "flash_attention_fwd":
            return fa.FlashAttentionFunction.apply(*args, True, 8, 8)
        if self.name == "layer_norm_fwd":
            return ln.LayerNormFunction.apply(*args)
        if self.name == "add_layer_norm_fwd":
            return ln.AddLayerNormFunction.apply(*args)
        return getattr(OPS, self.name)(*args)


def _export_args(name):
    if name == "flash_attention_fwd":
        return tuple(_qkv())
    if name == "layer_norm_fwd":
        x, _, w, b = _ln_inputs()
        return (x, w, b)
    if name == "add_layer_norm_fwd":
        return _ln_inputs()
    return _args(name)


@pytest.mark.parametrize("name", sorted(kernels.WRAPPERS))
def test_export_records_the_op_itself(name):
    args = _export_args(name)
    mod = _Calls(name)
    ep = torch.export.export(mod, args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert f"paddle_tpu_torch.{name}.default" in targets, targets
    assert not any(t.startswith(("aten.empty", "aten.new_empty"))
                   for t in targets), targets
    want = mod(*args)
    got = ep.module()(*args)
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    for a, b in zip(got, want):
        if isinstance(b, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_forward_ops_gradcheck_float64():
    q, k, v = _qkv(grad=True, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.FlashAttentionFunction.apply(a, b, c, True, 8,
                                                        8), (q, k, v))
    x, y, w, b = _ln_inputs(grad=True, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, c, d: ln.LayerNormFunction.apply(a, c, d), (x, w, b))
    assert torch.autograd.gradcheck(
        lambda a, e, c, d: ln.AddLayerNormFunction.apply(a, e, c, d),
        (x, y, w, b))


def test_partial_op_opcheck_export_and_gradcheck():
    """``flash_attention_partial`` (ring attention's building block, over
    B1 and B3/B4): ``opcheck`` with inputs that require grad, a
    ``torch.export`` that records the op itself, and ``gradcheck`` in
    float64 of a loss that reads both out and lse (the lse cotangent
    folded into delta), causal with fully masked rows."""
    q, k, v = _qkv(grad=True)
    result = torch.library.opcheck(OPS.flash_attention_partial,
                                   (q, k, v, True, 8, 8, None, 0, 0))
    assert set(result.values()) == {"SUCCESS"}, result

    class Partial(torch.nn.Module):
        def forward(self, a, b, c):
            return fa.flash_attention_partial(a, b, c, True, 8, 8)

    args = tuple(_qkv())
    ep = torch.export.export(Partial(), args, strict=False)
    assert "paddle_tpu_torch.flash_attention_partial.default" in [
        str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    for a, b in zip(ep.module()(*args), Partial()(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    gq, gk, gv = _qkv(grad=True, dtype=torch.float64)
    wl = torch.randn(B, H, S, generator=_gen(), dtype=torch.float64)

    def loss(a, b, c):
        out, lse = fa.flash_attention_partial(a, b, c, True, 8, 8, None, 0,
                                              4)
        live = torch.where(lse > -1e29, lse, torch.zeros_like(lse))
        return out.sum(-1) + live * wl

    assert torch.autograd.gradcheck(loss, (gq, gk, gv))


def test_fake_outputs_keep_the_stat_types():
    """lse, mean and rstd stay float32 under a bfloat16 input (float64 on
    the float64 plain route), in the fake implementations as in the
    bodies."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    for dtype, stat in ((torch.bfloat16, torch.float32),
                        (torch.float64, torch.float64)):
        q = torch.randn(B, H, S, D).to(dtype)
        x, _, w, b = (t.to(dtype) for t in _ln_inputs())
        real = (OPS.flash_attention_fwd(q, q, q, True, 8, 8)[1],
                OPS.layer_norm_fwd(x, w, b)[1])
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = (OPS.flash_attention_fwd(q, q, q, True, 8, 8)[1],
                    OPS.layer_norm_fwd(x, w, b)[1])
        for r, f in zip(real, fake):
            assert r.dtype == f.dtype == stat
            assert r.shape == f.shape


def test_draw_op_reads_the_package_generator():
    """The draw op draws from the package's generator of the device (or
    a seed), never from PyTorch's global one."""
    cpu = torch.device("cpu")
    torch_state = torch.get_rng_state()
    prev = rnd.get_seed()
    rnd.seed(3)
    a = OPS.draw("uniform", [4], torch.float32, cpu, 0)
    rnd.seed(3)
    b = OPS.draw("uniform", [4], torch.float32, cpu, 0)
    c = OPS.draw("uniform", [4], torch.float32, cpu, 0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(b, c)
    torch.testing.assert_close(
        OPS.draw("normal", [4], torch.float32, cpu, 9),
        torch.randn(4, generator=torch.Generator().manual_seed(9)))
    assert torch.equal(torch.get_rng_state(), torch_state)
    rnd.seed(prev)
