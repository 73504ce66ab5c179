"""The port's recurrent layers, fluid-era functionals, optimizers,
blockwise attention and eager float16 AMP on the card, against the
port's own CPU runs and plain routes.

These tests need an NVIDIA card (the blockwise route also the CUDA
toolkit: the flash kernels build from paddle_tpu_torch/csrc on first
use); elsewhere they skip. This file imports no JAX:

    python -m pytest tests/test_torch_cuda_nn.py -m cuda --noconftest

Tolerances (float32, TF32 off): outputs within rtol 1e-5 / atol 1e-6 of
the CPU run's, gradients and updated parameters within 1e-5 of their
largest value (the same ops; sums in other orders). The blockwise route's
kernels against the torch blockwise program on the same card tensors:
float32 within (1e-5, 1e-5) (floor of the largest value, share of each
value; as ``test_torch_cuda.py``); bf16 within 2^-7 of the largest value,
two bf16 ulps of it (both round float32 sums to bf16, at other points:
the kernels' backward takes ``delta`` from the bf16 output, as
FlashAttention's does; on the card each lies 1.5-2.6e-3 of the largest
from the float32 program and up to 5.0e-3 from the other), outputs and
gradients. The eager float16 AMP loop with ``GradScaler`` against
``TrainStep``'s float16 O1 with dynamic loss scaling on the same small
GPT: the first loss equal, the parameters after the first step within
1e-5 of their largest value, and the losses of three steps within 1e-4
relative. The two differ in the bias correction only: ``TrainStep``
counts applied updates in a float32 device tensor, whose ``1 - 0.999^t``
lies 1.3e-5 off the eager loop's float64 one (6.9e-6 of each bias after
the first step, on the card); from the second step on, Adam takes the
sign of rounding where a gradient is rounding noise (the key bias,
which softmax ignores), so the parameters are compared after one step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.nn.layers import ring_attention as ra
from paddle_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda

TF = pt.nn.functional


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    saved = pt_device._current
    yield torch.device("cuda")
    pt_device._current = saved


def _arr(shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _near(got, want, rel=1e-5, what=""):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _both(fn, *arrays):
    """``fn`` on CPU tensors and on card tensors (gradients on), then the
    outputs and the gradients of the first output's sum(out * w)."""
    runs = []
    for dev in ("cpu", "cuda"):
        xs = [torch.tensor(a, device=dev, requires_grad=a.dtype.kind == "f")
              for a in arrays]
        out = fn(*xs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        outs = [o for o in outs if isinstance(o, torch.Tensor)]
        w = torch.tensor(_arr(tuple(outs[0].shape), 99, 0.5, 1.5), device=dev)
        (outs[0].float() * w).sum().backward()
        runs.append((outs, [x.grad for x in xs if x.requires_grad]))
    (co, cg), (go, gg) = runs
    for a, b in zip(go, co):
        if a.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(a.cpu(), b)
    for a, b in zip(gg, cg):
        if b is None:  # an input reached only through integer arithmetic
            assert a is None
        else:
            _near(a, b, what="gradient")


# -- optimizers -------------------------------------------------------------------

OPTIMIZERS = [
    ("Adamax", dict(learning_rate=0.05)),
    ("Adagrad", dict(learning_rate=0.1, initial_accumulator_value=0.1)),
    ("Adadelta", dict(rho=0.9)),
    ("RMSProp", dict(learning_rate=0.01, centered=True, momentum=0.9)),
    ("Lamb", dict(learning_rate=0.05, lamb_weight_decay=0.01)),
    ("Lars", dict(learning_rate=0.5, lars_weight_decay=0.01,
                  exclude_from_weight_decay=["bias"])),
    ("Adam", dict(learning_rate=0.05, lazy_mode=True)),
    ("AdamW", dict(learning_rate=0.05, lr_ratio=lambda p: 0.5)),
]


@pytest.mark.parametrize("cls,kw", OPTIMIZERS, ids=[c for c, _ in OPTIMIZERS])
def test_optimizer_on_the_card(card, cls, kw):
    """Three eager steps and three ``TrainStep`` calls on the card equal
    the CPU's, with a per-parameter rate on one weight; the state dict's
    accumulators too."""
    finals = {}
    for dev in ("cpu", "cuda"):
        for fused in (False, True):
            torch.manual_seed(0)
            pt.set_device(dev if dev == "cpu" else "gpu")
            m = pt.nn.Sequential(
                pt.nn.Linear(4, 3, weight_attr=pt.ParamAttr(
                    learning_rate=0.5)), pt.nn.ReLU(), pt.nn.Linear(3, 2))
            m.set_state_dict({k: _arr(tuple(v.shape), i) for i, (k, v) in
                              enumerate(m.state_dict().items())})
            opt = getattr(pt.optimizer, cls)(
                parameters=m.named_parameters(), **kw)
            step = pt.jit.TrainStep(
                m, lambda o, t: ((o - t) ** 2).mean(), opt) if fused \
                else None
            for i in range(3):
                x, t = (torch.tensor(_arr(s, 10 * i + j), device=dev)
                        for j, s in enumerate(((5, 4), (5, 2))))
                if fused:
                    step(x, t)
                else:
                    ((m(x) - t) ** 2).mean().backward()
                    opt.step()
                    opt.clear_grad()
            state = {k: v for k, v in opt.state_dict().items()
                     if k != "@step"}
            finals[dev, fused] = (dict(m.state_dict()), state)
    for fused in (False, True):
        (pc, sc), (pg, sg) = finals["cpu", fused], finals["cuda", fused]
        for k in pc:
            _near(pg[k], pc[k], what=k)
        assert set(sg) == set(sc)
        for k in sc:
            _near(sg[k]._data, sc[k]._data, what=k)


# -- recurrent layers -----------------------------------------------------------------


@pytest.mark.parametrize("cls,kw", [
    ("LSTM", dict(num_layers=2, direction="bidirect")),
    ("GRU", dict(num_layers=2, time_major=True)),
    ("SimpleRNN", dict(activation="relu"))], ids=["lstm", "gru", "rnn"])
def test_recurrent_layer_on_the_card(card, cls, kw):
    """Outputs, final states, and the input's and every parameter's
    gradient on the card equal the CPU's, from the same weights."""
    x = _arr((7, 3, 16) if kw.get("time_major") else (3, 7, 16), 1)
    layers, runs = {}, {}
    for dev in ("cpu", "cuda"):
        layers[dev] = getattr(pt.nn, cls)(16, 32, device=dev, **kw)
        if dev == "cuda":
            layers[dev].set_state_dict(layers["cpu"].state_dict())
        xs = torch.tensor(x, device=dev, requires_grad=True)
        out, state = layers[dev](xs)
        states = tuple(state) if cls == "LSTM" else (state,)
        w = torch.tensor(_arr(tuple(out.shape), 99, 0.5, 1.5), device=dev)
        ((out * w).sum() + sum(s.sum() for s in states)).backward()
        runs[dev] = [out, *states, xs.grad] + [
            p.grad for _, p in layers[dev].named_parameters()]
    for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        _near(a, b, what=f"output or gradient {i}")


# -- extras ----------------------------------------------------------------------------

IMG, GRID = _arr((2, 3, 6, 8), 2), _arr((2, 3, 5, 2), 3, -1.2, 1.2)
BOXES = np.array([[0.0, 0.0, 7.0, 5.0], [1.2, 2.0, 5.6, 4.1]], np.float32)
EXTRAS = [
    ("grid_sample", lambda x, g: TF.grid_sample(x, g), (IMG, GRID)),
    ("grid_sample_reflection", lambda x, g: TF.grid_sample(
        x, g, padding_mode="reflection", align_corners=False), (IMG, GRID)),
    ("affine_grid", lambda t: TF.affine_grid(t, (2, 3, 5, 4)),
     (_arr((2, 2, 3), 4),)),
    ("roi_pool", lambda x, b, n: TF.roi_pool(x, b, n, 2),
     (IMG, BOXES, np.array([1, 1], np.int64))),
    ("temporal_shift", lambda x: TF.temporal_shift(x, 2),
     (_arr((4, 8, 2, 2), 5),)),
    ("space_to_depth", lambda x: TF.space_to_depth(x, 2), (IMG,)),
    ("spectral_norm", lambda w: TF.spectral_norm(w, power_iters=3),
     (_arr((6, 4), 6),)),
    ("pool2d", lambda x: TF.pool2d(x, 3, "avg", 2, 1), (IMG,)),
    ("image_resize", lambda x: TF.image_resize(x, [9, 5]), (IMG,)),
    ("bpr_loss", TF.bpr_loss, (_arr((4, 6), 7),
                               np.array([0, 5, 2, 3], np.int64))),
    ("dice_loss", TF.dice_loss, (_arr((4, 5), 8, 0, 1),
                                 np.array([[1], [0], [4], [2]], np.int64))),
    ("smooth_l1", lambda a, b: TF.smooth_l1(a, b, sigma=2.0),
     (_arr((3, 5), 9), _arr((3, 5), 10))),
    ("add_position_encoding", lambda x: TF.add_position_encoding(
        x, 0.5, 2.0), (_arr((2, 5, 8), 11),)),
    ("warpctc", lambda lp, lb, il, ll: TF.warpctc(
        torch.log_softmax(lp, -1), lb, input_length=il, label_length=ll),
     (_arr((6, 2, 5), 12), np.array([[1, 2, 2], [3, 1, 0]], np.int64),
      np.array([6, 5], np.int64), np.array([3, 2], np.int64))),
]


@pytest.mark.parametrize("fn,arrays", [e[1:] for e in EXTRAS],
                         ids=[e[0] for e in EXTRAS])
def test_extras_on_the_card(card, fn, arrays):
    _both(fn, *arrays)


def test_extras_draws_and_boxes_on_the_card(card):
    """``random_crop`` and ``nce`` draw from a card generator;
    ``density_prior_box`` lands on the input's device with the CPU's
    boxes."""
    x = torch.arange(4 * 64, dtype=torch.float32,
                     device="cuda").reshape(4, 1, 8, 8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    crops = TF.random_crop(x, [4, 4], generator=gen)
    assert crops.shape == (4, 1, 4, 4) and crops.device.type == "cuda"
    out = TF.nce(torch.randn(4, 6, device="cuda"),
                 torch.tensor([1, 0, 7, 9], device="cuda"), 10, 3,
                 weight=torch.randn(10, 6, device="cuda"), generator=gen)
    assert out.shape == (4, 1) and bool(torch.isfinite(out).all())
    args = ([2, 1], [4.0, 6.0], [1.0, 2.0])
    gb, gv = TF.density_prior_box(torch.zeros(1, 3, 2, 3, device="cuda"),
                                  torch.zeros(1, 3, 16, 20, device="cuda"),
                                  *args)
    cb, cv = TF.density_prior_box(torch.zeros(1, 3, 2, 3),
                                  torch.zeros(1, 3, 16, 20), *args)
    assert gb.device.type == "cuda"
    assert torch.equal(gb.cpu(), cb) and torch.equal(gv.cpu(), cv)


# -- blockwise attention -------------------------------------------------------------------

def _assert_tol(got, want, dtype):
    if dtype == torch.bfloat16:
        _near(got, want, 2 ** -7, "bf16 output or gradient")
        return
    got, want = got.float(), want.float()
    bound = 1e-5 * want.abs().max() + 1e-5 * want.abs()
    bad = (got - want).abs() > bound
    assert not bad.any(), f"{int(bad.sum())} elements off"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_blockwise_route_on_the_card(card, dtype, causal):
    """A divisible CUDA shape goes through B1/B3/B4 (one launch each) and
    equals the torch blockwise program on the same card tensors; a ragged
    one takes the program and launches nothing."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(2, 4, 128, 64, device="cuda", generator=gen
                              ).to(dtype) for _ in range(4))
    outs = []
    for route in ("kernels", "program"):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        kernels.reset_launches()
        if route == "kernels":
            o = ra.blockwise_attention(qs, ks, vs, causal, block_size=64)
        else:
            o = ra._blockwise_raw(qs, ks, vs, causal=causal, block_size=64)
        o.backward(g)
        outs.append((o, qs.grad, ks.grad, vs.grad, kernels.launches()))
    got, want = outs
    assert got[4]["flash_attention_fwd"] == 1
    assert got[4]["flash_attention_bwd_dq"] == 1
    assert got[4]["flash_attention_bwd_dkv"] == 1
    assert not any(want[4].values())
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == dtype
        _assert_tol(a, b, dtype)
    kernels.reset_launches()
    ra.blockwise_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100],
                           causal, block_size=64)
    assert not any(kernels.launches().values())


# -- the eager float16 AMP loop ------------------------------------------------------------


def test_eager_fp16_amp_loop_matches_train_step(card):
    """A small GPT trained three steps by the eager loop (``auto_cast``
    float16 O1, ``GradScaler.scale``, ``backward``, ``step``) and by
    ``TrainStep`` under fleet's float16 O1 with dynamic loss scaling, from
    the same weights: the same losses and parameters, and the flash
    kernels launched in float16 the same number of times."""
    fleet = pt.distributed.fleet
    ids = torch.randint(0, 64, (2, 65), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            1))
    x, y = ids[:, :-1], ids[:, 1:]

    def loss_fn(logits, lab):
        return TF.cross_entropy(logits.reshape([-1, 64]), lab.reshape([-1]))

    runs = {}
    for how in ("eager", "train_step"):
        model = pt.TransformerLM(64, d_model=128, num_heads=2, num_layers=2,
                                 max_position=64, seed=1)
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
        kernels.reset_launches()
        if how == "eager":
            scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 15)

            def step(a, b):
                with pt.amp.auto_cast(True, level="O1", dtype="float16"):
                    loss = loss_fn(model(a), b)
                scaler.scale(loss).backward()
                scaler.step(opt)
                opt.clear_grad()
                return loss
        else:
            strategy = fleet.DistributedStrategy()
            strategy.amp = True
            strategy.amp_configs = {"use_bf16": False}
            fleet.init(is_collective=True, strategy=strategy)
            step = pt.jit.TrainStep(model, loss_fn,
                                    fleet.distributed_optimizer(opt))
        losses = [step(x, y).item()]
        first = {k: v.clone() for k, v in model.state_dict().items()}
        losses += [step(x, y).item() for _ in range(2)]
        runs[how] = (losses, first, kernels.launches_by_dtype())
    (le, pe, ce), (lt, pt_, ct) = runs["eager"], runs["train_step"]
    assert le[0] == lt[0]
    np.testing.assert_allclose(le, lt, rtol=1e-4)
    for k in pt_:
        _near(pe[k], pt_[k], 1e-5, k)
    assert ce["flash_attention_fwd"] == ct["flash_attention_fwd"] == {
        "float16": 6}
