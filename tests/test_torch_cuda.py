"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper card and the CUDA toolkit (the kernels
build from paddle_tpu_torch/csrc on first use); elsewhere they skip.
This file imports no JAX, so it runs where only PyTorch is installed
(without the shared conftest, which imports paddle_tpu):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances of kernel against plain version as in chip_smoke.py, scaled
to each output: |kernel - plain| <= floor * max|plain| + rtol * |plain|,
float32 (1e-5, 1e-5) (summation order; the 3xTF32 split of the
tensor-core kernels, ~2^-22 of each product), bfloat16 (2^-12, 2^-7) (one
rounding of the stored output: at most one bf16 ulp), float16 (2^-14,
2^-10) (one f16 rounding of the stored output); the -1e30 lse of a fully
masked row must match exactly. The small model's gradients through the kernels
against the dense route: float32, TF32 off, max |err| <= 1e-4 + 1e-3 of
each parameter's largest gradient (summation order through two layers);
under bf16 AMP O1, 2e-2 of it (the two routes round to bf16 at different
places).
"""

import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import layer_norm as ln

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -12, 2 ** -7),
       torch.float16: (2 ** -14, 2 ** -10)}
DTYPES = [torch.float32, torch.bfloat16]
#: the flash kernels' types
FLASH_DTYPES = DTYPES + [torch.float16]


def assert_near(got, want, dtype):
    """``got`` within TOL[dtype] of ``want``, elementwise."""
    floor, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    sentinel = want <= -1e29
    bound = floor * want.abs().masked_fill(sentinel, 0).max() \
        + rtol * want.abs()
    bad = torch.where(sentinel, err != 0, err > bound)
    assert not bad.any(), (f"{int(bad.sum())} elements off; max |err| "
                           f"{err.max().item():.3e}")


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


# (S, Sk, D, causal, q_offset, kv_offset): causal square, end-aligned
# q_offset = Sk - Sq, kv_offset with fully masked rows, ragged lengths
# around the kernels' 64-row tiles (136; Sq 72 with Sk 200; Sq 200 with
# Sk 72), head dims 32, 40, 64, 96 and 128, and 36 (bf16 rows of 72
# bytes: the kernels' plain copy in place of 16-byte cp.async), a long
# S = 4096 (the float32 sums of the tensor-core kernels over 64 tiles), and
# head dims 192 and 256 (the kernels' 256-column tiles), causal and not,
# with ragged lengths
FWD_CASES = [(128, 128, 64, True, 0, 0), (64, 128, 64, True, 64, 0),
             (128, 128, 64, True, 0, 64), (40, 72, 128, False, 0, 0),
             (24, 40, 96, True, 16, 0), (136, 136, 32, True, 0, 0),
             (136, 136, 64, True, 0, 0), (72, 200, 40, True, 128, 0),
             (72, 200, 96, False, 0, 0), (200, 72, 128, False, 0, 0),
             (200, 200, 64, True, 0, 72), (136, 136, 128, True, 0, 0),
             (72, 72, 36, True, 0, 0), (4096, 4096, 64, True, 0, 0),
             (136, 136, 256, True, 0, 0), (72, 200, 192, False, 0, 0),
             (200, 200, 256, True, 0, 72), (1024, 1024, 256, True, 0, 0)]


@pytest.mark.parametrize("dtype", FLASH_DTYPES, ids=str)
@pytest.mark.parametrize("S,Sk,D,causal,qo,ko", FWD_CASES)
def test_flash_forward_kernel(gen, dtype, S, Sk, D, causal, qo, ko):
    q, k, v = (torch.randn(2, 3, n, D, device="cuda", generator=gen
                           ).to(dtype) for n in (S, Sk, Sk))
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, block_q=8,
                                    block_k=8, q_offset=qo, kv_offset=ko)
    po, plse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                            q_offset=qo, kv_offset=ko)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert_near(o, po, dtype)
    assert_near(lse, plse, torch.float32)
    if ko:  # rows that see no key: out = 0, lse = -1e30
        assert (o[:, :, :ko] == 0).all() and (lse[:, :, :ko] == -1e30).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("R,D", [(1024, 1024), (8, 1024), (48, 384)])
def test_layer_norm_kernels(gen, dtype, R, D):
    x, y = (torch.randn(R, D, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    w, b = (torch.randn(D, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    got, ref = ln.layer_norm_fwd(x, w, b), ln.layer_norm_fwd_plain(x, w, b)
    got2 = ln.add_layer_norm_fwd(x, y, w, b)
    ref2 = ln.add_layer_norm_fwd_plain(x, y, w, b)
    torch.cuda.synchronize()
    assert_near(got[0], ref[0], dtype)
    torch.testing.assert_close(got2[0], ref2[0], atol=0, rtol=0)
    assert_near(got2[1], ref2[1], dtype)
    for a, r in zip(got[1:] + got2[2:], ref[1:] + ref2[2:]):
        assert_near(a, r, torch.float32)


@pytest.mark.parametrize("ytype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("R,D", [(4096, 1024), (1024, 1024), (8, 1024),
                                 (40, 384), (37, 200)])
def test_mixed_dtype_add_layer_norm_kernel(gen, R, D, ytype):
    """AMP O1's residual seam on the B6 kernel: x float32, y bfloat16 or
    float16; s bit-equal to the plain version's (one f32 sum, rounded
    once), LN(s) and the statistics in float32; counted under the pair's
    types. Rows off the training shape (few rows, D not a multiple of 128)
    too."""
    x = torch.randn(R, D, device="cuda", generator=gen)
    y = torch.randn(R, D, device="cuda", generator=gen).to(ytype)
    w, b = (torch.randn(D, device="cuda", generator=gen) for _ in range(2))
    key = f"float32+{str(ytype)[6:]}"
    before = ln.add_layer_norm_fwd.by_dtype.get(key, 0)
    got = ln.add_layer_norm_fwd(x, y, w, b)
    ref = ln.add_layer_norm_fwd_plain(x, y, w, b)
    torch.cuda.synchronize()
    assert ln.add_layer_norm_fwd.by_dtype[key] == before + 1
    assert got[0].dtype == got[1].dtype == torch.float32
    torch.testing.assert_close(got[0], ref[0], atol=0, rtol=0)
    for a, r in zip(got[1:], ref[1:]):
        assert_near(a, r, torch.float32)


def test_add_layer_norm_refuses_pairs_the_router_never_makes(gen):
    """Only (f32, f32), (bf16, bf16), (f32, bf16) and (f32, f16) have a
    kernel; any other pair raises on the card (no plain fallback)."""
    x = torch.randn(16, 128, device="cuda", generator=gen)
    w, b = torch.ones(128, device="cuda"), torch.zeros(128, device="cuda")
    for xt, yt in ((torch.bfloat16, torch.float32),
                   (torch.bfloat16, torch.float16),
                   (torch.float16, torch.float16)):
        with pytest.raises((ValueError, TypeError)):
            ln.add_layer_norm_fwd(x.to(xt), x.to(yt), w, b)


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = torch.randn(1, 2, 16, 64, device="cuda", generator=gen)
    qt = q.transpose(2, 3)  # [1, 2, 64, 16], not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(qt, qt, qt)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, q.half(), q.half())
    wide = torch.randn(1, 2, 16, 320, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(wide, wide, wide)
    with pytest.raises(ValueError, match="CUDA device"):
        ln.layer_norm_fwd(q.reshape(-1, 64), torch.ones(64),
                          torch.zeros(64))


# (S, Sk, D, causal, q_offset, kv_offset): causal square, end-aligned
# q_offset = Sk - Sq, kv_offset with fully masked rows, Sq != Sk with
# ragged tiles, wide heads; then the ragged lengths and head dims of
# FWD_CASES
BWD_CASES = [(128, 128, 64, True, 0, 0), (64, 128, 64, True, 64, 0),
             (128, 128, 64, True, 0, 64), (40, 72, 64, False, 0, 0),
             (72, 40, 32, True, 0, 0), (96, 160, 128, True, 64, 0),
             (48, 48, 96, False, 0, 0), (136, 136, 64, True, 0, 0),
             (72, 200, 40, True, 128, 0), (72, 200, 128, True, 128, 0),
             (200, 72, 96, False, 0, 0), (200, 200, 32, True, 0, 72),
             (72, 72, 36, True, 0, 0), (4096, 4096, 64, True, 0, 0),
             (136, 136, 256, True, 0, 0), (72, 200, 192, True, 128, 0),
             (200, 72, 256, False, 0, 0), (200, 200, 192, True, 0, 72),
             (1024, 1024, 256, True, 0, 0)]


@pytest.mark.parametrize("dtype", FLASH_DTYPES, ids=str)
@pytest.mark.parametrize("S,Sk,D,causal,qo,ko", BWD_CASES)
def test_flash_backward_kernels(gen, dtype, S, Sk, D, causal, qo, ko):
    q, k, v = (torch.randn(2, 3, n, D, device="cuda", generator=gen
                           ).to(dtype) for n in (S, Sk, Sk))
    dout = torch.randn(2, 3, S, D, device="cuda", generator=gen).to(dtype)
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
    out, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    ref = fa.flash_attention_bwd_plain(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == dtype
        assert_near(got, want, dtype)
    if ko:  # fully masked rows get no gradient
        assert (dq[:, :, :ko] == 0).all()


@pytest.mark.parametrize("dtype", FLASH_DTYPES, ids=str)
@pytest.mark.parametrize("kernel", [fa.flash_attention_bwd_dq,
                                    fa.flash_attention_bwd_dkv],
                         ids=["dq", "dkv"])
def test_flash_backward_kernel_is_deterministic(gen, dtype, kernel):
    """One block owns each dQ (dK/dV) tile and sums in a fixed order: two
    calls on the same inputs are bit-equal."""
    q, k, v, dout = (torch.randn(2, 4, 256, 64, device="cuda", generator=gen
                                 ).to(dtype) for _ in range(4))
    out, lse = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    delta = (dout.float() * out.float()).sum(-1)
    first, second = (kernel(q, k, v, dout, lse, delta, causal=True)
                     for _ in range(2))
    torch.cuda.synchronize()
    if kernel is fa.flash_attention_bwd_dq:
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (R, D): the training rows, rows of the register path (D a multiple of
# 128 up to 1024), R not a multiple of a block's 8 warps, and D off the
# register path (not a multiple of 128; wider than 1024)
LN_BWD_CASES = [(4096, 1024), (8, 1024), (40, 384), (37, 1024), (37, 200),
                (300, 2048)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("R,D", LN_BWD_CASES)
def test_layer_norm_backward_kernel(gen, dtype, R, D):
    x, g = (torch.randn(R, D, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    w, b = (torch.randn(D, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    _, mu, rs = ln.layer_norm_fwd_plain(x, w, b)
    before = ln.layer_norm_bwd.launches
    got = ln.layer_norm_bwd(x, w, mu, rs, g)
    ref = ln.layer_norm_bwd_plain(x, w, mu, rs, g)
    torch.cuda.synchronize()
    assert ln.layer_norm_bwd.launches == before + 1
    for a, r in zip(got, ref):
        assert a.dtype == dtype
        assert_near(a, r, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("R,D", [(4096, 1024), (37, 200)])
def test_layer_norm_backward_kernel_is_deterministic(gen, dtype, R, D):
    """The dweight/dbias partials are summed in a fixed order, without
    atomics: two calls on the same inputs are bit-equal."""
    x, g = (torch.randn(R, D, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    w, b = (torch.randn(D, device="cuda", generator=gen) for _ in range(2))
    _, mu, rs = ln.layer_norm_fwd_plain(x, w, b)
    first = ln.layer_norm_bwd(x, w, mu, rs, g)
    second = ln.layer_norm_bwd(x, w, mu, rs, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wrappers_refuse_inputs_that_require_grad(gen):
    q = torch.randn(1, 2, 16, 64, device="cuda", generator=gen,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention_fwd(q, q, q, causal=True)
    x = torch.randn(16, 128, device="cuda", generator=gen,
                    requires_grad=True)
    w, b = torch.ones(128, device="cuda"), torch.zeros(128, device="cuda")
    with pytest.raises(RuntimeError, match="requires grad"):
        ln.layer_norm_fwd(x, w, b)
    with torch.no_grad():
        ln.layer_norm_fwd(x, w, b)


def test_model_gradients_through_the_kernels(gen, monkeypatch):
    """Every parameter's gradient through the kernel routes equals the
    dense route's (torch autograd), and each kernel ran."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = pt.TransformerLM(64, d_model=128, num_heads=2, num_layers=2,
                             max_position=64, seed=1)
    ids = torch.randint(0, 64, (2, 65), device="cuda", generator=gen)

    def grads(route):
        monkeypatch.setenv("PADDLE_FLASH_DEFAULT", route)
        monkeypatch.setenv("PADDLE_FUSED_LN", route)
        model.zero_grad(set_to_none=True)
        logits = model(ids[:, :-1])
        loss = pt.nn.functional.cross_entropy(
            logits.reshape(-1, 64), ids[:, 1:].reshape(-1))
        loss.backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    kernels.reset_launches()
    got = grads("1")
    counts = kernels.launches()
    assert counts == {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
                      "flash_attention_bwd_dkv": 2, "layer_norm_fwd": 3,
                      "add_layer_norm_fwd": 2, "layer_norm_bwd": 5}
    want = grads("0")
    assert set(got) == set(want)
    for n, g in got.items():
        scale = want[n].abs().max().item()
        assert scale > 0, n
        torch.testing.assert_close(g, want[n], atol=1e-4 + 1e-3 * scale,
                                   rtol=0, msg=n)


def test_amp_model_gradients_through_the_kernels(gen, monkeypatch):
    """Under bf16 AMP O1 every parameter's gradient through the kernel
    routes is within 2e-2 of its largest gradient of the dense route's
    under the same AMP (the routes round to bf16 at different places: the
    dense one rounds the scores and probabilities, the flash kernels keep
    them f32); the flash kernels ran in bf16 and the add-LN on the float32
    residual with the bf16 branch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = pt.TransformerLM(64, d_model=128, num_heads=2, num_layers=2,
                             max_position=64, seed=1)
    ids = torch.randint(0, 64, (2, 65), device="cuda", generator=gen)

    def grads(route):
        monkeypatch.setenv("PADDLE_FLASH_DEFAULT", route)
        monkeypatch.setenv("PADDLE_FUSED_LN", route)
        model.zero_grad(set_to_none=True)
        with pt.amp.auto_cast(True, level="O1", dtype="bfloat16"):
            logits = model(ids[:, :-1])
            loss = pt.nn.functional.cross_entropy(
                logits.reshape(-1, 64), ids[:, 1:].reshape(-1))
        loss.backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    kernels.reset_launches()
    got = grads("1")
    assert kernels.launches_by_dtype() == {
        "flash_attention_fwd": {"bfloat16": 2},
        "flash_attention_bwd_dq": {"bfloat16": 2},
        "flash_attention_bwd_dkv": {"bfloat16": 2},
        "layer_norm_fwd": {"float32": 3},
        "add_layer_norm_fwd": {"float32+bfloat16": 2},
        "layer_norm_bwd": {"float32": 5}}
    want = grads("0")
    for n, g in got.items():
        assert g.dtype == torch.float32, n
        scale = want[n].abs().max().item()
        assert scale > 0, n
        torch.testing.assert_close(g, want[n], atol=2e-2 * scale, rtol=0,
                                   msg=n)
