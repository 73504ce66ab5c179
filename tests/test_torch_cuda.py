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
places). The serving tier on the card (paged KV, chunked prefill, the
prefix cache, adapter fleets) against its plain forms: greedy tokens
equal, paged decode logits within 1e-5 (float32, TF32 off). Quantized
serving: the quantizer's bytes and scales on the card equal the CPU's
exactly (int8 and fp8); an fp8 cache's written bytes too, its attention
within 1e-5 of the largest output (summation order); a narrow linear
equals ``F.linear`` on its widened weight exactly (the same product on
the same values); speculative tokens equal the plain loop's, one round
under sync debug mode "error". KV migration: a bundle's gathered bytes
equal the pool's blocks exactly (float32, int8, fp8), cross the wire
bit-exact and resume to the unmoved run's tokens; ``MigrateInsert``
resets the slot's state and reads nothing back; ``retire_slots``
relocates a live request without changing its tokens. The ring's
``flash_attention_partial`` at [1, 16, 2048, 64] (diagonal, full and
fully masked shards; float32 and bf16): out, lse and its lse-cotangent
backward against the plain versions at these tolerances, with opcheck.
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


# (R, D): the training rows, the decode step's, rows of the register path
# at D 384, BERT-base's 768 and Transformer-base's 512 (its training rows
# and its decode step's), and its widest, 2048 (kN = 16)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("R,D", [(1024, 1024), (8, 1024), (48, 384),
                                 (4096, 768), (4096, 512), (8, 512),
                                 (256, 2048)])
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


def _ln_rows(gen, dtype, R, D, offset):
    """[R, D] rows of ``dtype``, ``offset`` elements into their buffer (a
    contiguous view), with float32 weight and bias."""
    buf = torch.randn(R * D + offset, device="cuda", generator=gen).to(dtype)
    w, b = (torch.randn(D, device="cuda", generator=gen) for _ in range(2))
    return buf[offset:].view(R, D), w, b


# (R, D, offset, kN): the register path for D = 128 kN (kN 1..8, 16) on
# aligned rows; the looped path (kN = 0) for D not a multiple of 128, for
# D = 128 kN outside the register path's kN, and for rows one element
# into their buffer (not aligned for the wide loads)
LN_FWD_PATHS = [(4096, 768, 0, 6), (4096, 1024, 0, 8), (8, 1024, 0, 8),
                (4096, 512, 0, 4), (8, 512, 0, 4),
                (32, 1024, 0, 8), (40, 1024, 0, 8), (48, 128, 0, 1),
                (256, 2048, 0, 16), (37, 200, 0, 0), (16, 1152, 0, 0),
                (64, 4096, 0, 0), (4096, 1024, 1, 0), (40, 768, 1, 0)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("R,D,offset,kn", LN_FWD_PATHS)
def test_layer_norm_forward_paths(gen, dtype, R, D, offset, kn):
    """Which path B5 takes (its C query), and that path against the plain
    version: y in x's type, mu and rstd in float32."""
    x, w, b = _ln_rows(gen, dtype, R, D, offset)
    assert ln.layer_norm_fwd_path(x, w, b) == kn
    before = ln.layer_norm_fwd.launches
    got, ref = ln.layer_norm_fwd(x, w, b), ln.layer_norm_fwd_plain(x, w, b)
    torch.cuda.synchronize()
    assert ln.layer_norm_fwd.launches == before + 1
    assert got[0].dtype == dtype
    assert_near(got[0], ref[0], dtype)
    for a, r in zip(got[1:], ref[1:]):
        assert_near(a, r, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("R,D", [(40, 1024), (4096, 768), (37, 384),
                                 (8, 128), (16, 2048)])
def test_layer_norm_forward_paths_agree_bit_for_bit(gen, dtype, R, D):
    """Both paths add in one order (a 256-thread block's): the looped path
    on rows one element into their buffer gives the register path's bits
    on an aligned copy of the same rows."""
    x, w, b = _ln_rows(gen, dtype, R, D, 1)
    aligned = x.clone()
    assert ln.layer_norm_fwd_path(x, w, b) == 0
    assert ln.layer_norm_fwd_path(aligned, w, b) == D // 128
    looped = ln.layer_norm_fwd(x, w, b)
    register = ln.layer_norm_fwd(aligned, w, b)
    torch.cuda.synchronize()
    for a, c in zip(looped, register):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("R,D,offset", [(4096, 768, 0), (37, 200, 0),
                                        (40, 1024, 1)])
def test_layer_norm_forward_kernel_is_deterministic(gen, dtype, R, D,
                                                    offset):
    """Each row's sums run in a fixed order in either path: two calls on
    the same inputs are bit-equal."""
    x, w, b = _ln_rows(gen, dtype, R, D, offset)
    first = ln.layer_norm_fwd(x, w, b)
    second = ln.layer_norm_fwd(x, w, b)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


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


# (R, D): the training rows (GPT's and Transformer-base's), rows of the
# register path (D a multiple of 128 up to 1024), R not a multiple of a
# block's 8 warps, and D off the register path (not a multiple of 128;
# wider than 1024)
LN_BWD_CASES = [(4096, 1024), (4096, 512), (8, 1024), (40, 384), (37, 1024),
                (37, 200), (300, 2048)]


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


# ---------------------------------------------------------------------------
# the serving tier on the card: paged KV, chunked prefill, the prefix cache
# and adapter fleets, each against its plain form (greedy tokens equal)
# ---------------------------------------------------------------------------


@pytest.fixture()
def tier_model(gen, monkeypatch):
    """A small model on the card (d_model 128: the LayerNorms take their
    kernels), TF32 off, no serving-tier knob set."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for k in ("PADDLE_SERVE_BLOCK_SIZE", "PADDLE_SERVE_PREFILL_CHUNK",
              "PADDLE_SERVE_PREFIX_CACHE", "PADDLE_SERVE_KV_QUANT"):
        monkeypatch.delenv(k, raising=False)
    return pt.TransformerLM(64, d_model=128, num_heads=4, num_layers=2,
                            max_position=64, seed=3)


def _serve_tokens(model, reqs, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_length", 64)
    kw.setdefault("sync_every", 4)
    eng = pt.InferenceEngine(model, **kw)
    for r in reqs:
        eng.submit(r)
    return eng, {k: v.tokens for k, v in eng.run().items()}


def test_paged_generate_equals_contiguous(tier_model, monkeypatch):
    prompts = [[5, 17, 3, 40, 22, 9, 31, 2], [11, 4, 46, 8, 27]]
    kernels.reset_launches()
    want, want_l = pt.generate(tier_model, prompts, 8, max_length=48,
                               return_logits=True)
    monkeypatch.setenv("PADDLE_SERVE_BLOCK_SIZE", "8")
    got, got_l = pt.generate(tier_model, prompts, 8, max_length=48,
                             return_logits=True)
    assert (got == want).all()
    torch.testing.assert_close(torch.tensor(got_l), torch.tensor(want_l),
                               atol=1e-5, rtol=0)
    assert kernels.launches()["add_layer_norm_fwd"] > 0


def test_chunked_paged_engine_equals_unchunked(tier_model):
    r = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, 64, (int(n),), generator=r).tolist()
               for n in (9, 17, 30, 12)]

    def reqs():
        return [pt.serving.Request(p, max_new_tokens=6, rid=i)
                for i, p in enumerate(prompts)]

    _, want = _serve_tokens(tier_model, reqs())
    eng, got = _serve_tokens(tier_model, reqs(), prefill_chunk=8,
                             block_size=8, pool_blocks=7)
    assert got == want
    assert eng._admit_deferred > 0 and eng.free_blocks() == 6


def test_warm_prefix_equals_cold(tier_model):
    preamble = list(range(3, 19))  # two blocks of 8
    eng = pt.InferenceEngine(tier_model, slots=2, max_length=64,
                             sync_every=4, block_size=8, prefix_cache=True)
    out = {}
    for rid, prompt in (("cold", preamble), ("warm", preamble),
                        ("tail", preamble + [40])):
        eng.submit(pt.serving.Request(prompt, max_new_tokens=8, rid=rid))
        out[rid] = eng.run()[rid].tokens
    assert out["warm"] == out["cold"]
    assert eng._prefix_hits == 2 and eng._cow_copies == 1
    _, alone = _serve_tokens(tier_model, [pt.serving.Request(
        preamble + [40], max_new_tokens=8, rid="tail")], block_size=8)
    assert out["tail"] == alone["tail"]


def test_mixed_adapter_batch_equals_sequential(tier_model):
    from paddle_tpu_torch.serving.adapters import AdapterSet

    ad = AdapterSet(tier_model, n_adapters=4, rank=2)
    ad.load(1)
    ad.load(2)

    def reqs(aids):
        return [pt.serving.Request([5, 6, 7, 8], max_new_tokens=8,
                                   rid=a, adapter=a) for a in aids]

    _, mixed = _serve_tokens(tier_model, reqs((0, 1, 2)), slots=3,
                             block_size=8)
    assert len({tuple(t) for t in mixed.values()}) == 3
    for a in (0, 1, 2):
        _, alone = _serve_tokens(tier_model, reqs((a,)), slots=3,
                                 block_size=8)
        assert alone[a] == mixed[a], a


# ---------------------------------------------------------------------------
# quantized serving and speculative decoding on the card: the quantizer's
# bytes equal the CPU's, the fp8 cache moves through its uint8 bytes, a
# narrow linear equals the dense product of its widened weight, and a
# speculative round reads nothing back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", ["int8", "fp8"])
def test_quantizer_on_the_card_equals_the_cpu(gen, width):
    from paddle_tpu_torch.distributed import quantized_comm as qc

    x = torch.randn(8, 16, 40, 64, device="cuda", generator=gen) * 3
    x[0, 0] = 0  # all-zero rows: scale 0
    rows = x.reshape(-1, 256)  # two blocks of 128 per row
    for quant, widen in (
            (lambda t: qc.quantize_lastaxis(t, width), qc.dequantize_lastaxis),
            (lambda t: qc.quantize_lastaxis(t.reshape(-1, 256), width),
             qc.dequantize_lastaxis),
            (lambda t: qc.quantize_blockwise(t, width),
             lambda p, s: qc.dequantize_blockwise(p, s, rows.shape))):
        got, want = quant(x), quant(x.cpu())
        assert torch.equal(qc.bits(got[0]).cpu(), qc.bits(want[0]))
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(widen(*got).cpu(), widen(*want))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_fp8_cache_writes_and_gathers(gen, layout):
    """cache_update and cached_attention over an fp8 cache on the card:
    the written bytes and scales equal the CPU's, the attention within
    1e-5 of its largest (summation order)."""
    from paddle_tpu_torch.distributed import quantized_comm as qc
    from paddle_tpu_torch.nn.functional import attention as attn
    from paddle_tpu_torch.serving import paged_kv as pk

    new = torch.randn(8, 16, 5, 64, device="cuda", generator=gen)
    q = torch.randn(8, 16, 5, 64, device="cuda", generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        cache = (qc.kv_zero((8, 16, 64, 64), "fp8", device=dev)
                 if layout == "contiguous" else
                 pk.paged_zero(8, 16, 64, 64, block=16, quant="fp8",
                               device=dev))
        pos = torch.arange(8, device=dev, dtype=torch.int32) * 7
        cache = attn.cache_update(cache, new.to(dev), pos)
        buf = cache.kv if layout == "paged" else cache
        out[dev] = (qc.bits(buf.q).cpu(), buf.scale.cpu(),
                    attn.cached_attention(q.to(dev), cache, cache,
                                          pos).cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    want = out["cpu"][2]
    torch.testing.assert_close(out["cuda"][2], want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_quantized_linear_equals_dense_on_the_widened_weight(gen,
                                                             monkeypatch):
    from paddle_tpu_torch.distributed import quantized_compute as qcp

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    lin = pt.nn.Linear(1024, 256, device="cuda", generator=gen)
    x = torch.randn(8, 1024, device="cuda", generator=gen)
    info = qcp.quantize_layer(lin, "int8")
    assert info["quantized"] == ["weight"] and lin.weight.dtype == torch.int8
    wide = qcp.dequantize_weight(lin.weight, lin.weight_q_scale)
    with torch.no_grad():
        assert torch.equal(lin(x), torch.nn.functional.linear(
            x, wide.t(), lin.bias))


def test_speculative_round_reads_nothing_back(tier_model):
    """One round (draft forwards, the target's k + 1 rows, the accept
    fold) under sync debug mode "error", and greedy speculative tokens
    equal the plain loop's."""
    from paddle_tpu_torch.jit import (PrefillStep, SpecDecodeState,
                                      SpeculativeDecodeStep)
    from paddle_tpu_torch.serving import sampling

    prompts = [[5, 17, 3, 40, 22, 9, 31, 2], [11, 4, 46, 8, 27]]
    want = pt.generate(tier_model, prompts, 12)
    assert (pt.generate(tier_model, prompts, 12, draft_model=tier_model,
                        spec_k=3) == want).all()
    ids = torch.zeros(2, 16, dtype=torch.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = torch.tensor(p)
    lens = [len(p) for p in prompts]
    last, caches, pos = PrefillStep(tier_model)(
        tier_model.gen_cache(2, 32), ids, lens)
    _, dcaches, _ = PrefillStep(tier_model)(tier_model.gen_cache(2, 32),
                                            ids, lens)
    state = SpecDecodeState.make(caches, dcaches, sampling.greedy(last), pos,
                                 budget=10)
    step = SpeculativeDecodeStep(tier_model, tier_model, k=3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        emit, state = step(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert emit.shape == (2, 4) and (emit[:, 0] >= 0).all()


@pytest.mark.parametrize("pool", ["paged", "contiguous"])
def test_fp8_engine_equals_fp8_generate(tier_model, monkeypatch, pool):
    """The engine's splices (block splice, prefix fetch, copy-on-write
    tail splice; or the contiguous slot copy) move fp8 payloads and their
    scales on the card: each request equals fp8 generate of its prompt."""
    monkeypatch.setenv("PADDLE_SERVE_KV_QUANT", "fp8")
    preamble = list(range(3, 19))  # two blocks of 8
    prompts = {"a": preamble, "b": [9, 30, 2, 41, 7], "c": preamble,
               "d": preamble + [27, 4]}
    kw = (dict(block_size=8, prefill_chunk=8, prefix_cache=True)
          if pool == "paged" else dict(block_size=0, prefill_chunk=8))
    eng, got = _serve_tokens(tier_model, [
        pt.serving.Request(p, max_new_tokens=6, rid=r)
        for r, p in prompts.items()], **kw)
    for r, p in prompts.items():
        assert got[r] == list(pt.generate(tier_model, [p], 6,
                                          max_length=64)[0]), r
    if pool == "paged":
        assert eng._prefix_hits >= 1


# ---------------------------------------------------------------------------
# KV migration on the card: the gather moves the pool's bytes, the splice
# and its slot reset land, a bundle resumes token-exact, and retire_slots
# relocates a live request
# ---------------------------------------------------------------------------


def _mid_decode(eng, rid="m", prompt=(5, 6, 7, 9, 11, 2, 3), budget=14):
    eng.submit(pt.serving.Request(list(prompt), max_new_tokens=budget,
                                  rid=rid))
    results = {}
    while not eng.progress().get(rid):
        eng.turn(results)


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_bundle_round_trip_on_the_card(tier_model, monkeypatch, quant):
    """Gather, wire and ``MigrateInsert`` of a float32, int8 or fp8 pool:
    the gathered bytes equal the pool's blocks, the wire form is
    bit-exact, and the bundle resumes in a second engine to the
    uninterrupted tokens with no prefill."""
    from paddle_tpu_torch.distributed import quantized_comm as qc
    from paddle_tpu_torch.serving import kv_migration as kvm
    from paddle_tpu_torch.serving import paged_kv as pk

    if quant is not None:
        monkeypatch.setenv("PADDLE_SERVE_KV_QUANT", quant)
    prompt = [5, 6, 7, 9, 11, 2, 3]
    want = list(pt.generate(tier_model, [prompt], 14, max_length=64)[0])
    src = pt.InferenceEngine(tier_model, slots=2, max_length=64,
                             sync_every=2, block_size=8)
    _mid_decode(src)
    b = src.extract_kv("m")
    blocks = src._slot_blocks[next(iter(src._active))][: b.n_blocks]
    for leaf, pool in zip(b.leaves, pk.paged_leaves(src._state.caches)):
        for t, p in zip(leaf, qc.tensors_of(pool.kv)):
            assert t.device.type == "cpu" and t.dtype == p.dtype
            assert torch.equal(qc.bits(t), qc.bits(p)[blocks].cpu())
    back = kvm.KVBundle.from_wire(b.to_wire())
    assert back.verify() == []
    for la, lb in zip(b.leaves, back.leaves):
        for x, y in zip(la, lb):
            assert torch.equal(qc.bits(x), qc.bits(y))
    man = back.manifest
    dst = pt.InferenceEngine(tier_model, slots=2, max_length=64,
                             sync_every=2, block_size=8)
    req = pt.serving.Request(prompt, max_new_tokens=man["budget_left"],
                             rid="m", resume_tokens=man["emitted"])
    assert dst.insert_migrated(req, back) is True
    got = man["emitted"] + dst.run()["m"].tokens
    assert dst._prefill._n_steps == 0
    if quant is None:
        assert got == want
    else:  # against the same quantized cache served without a move
        ref = pt.InferenceEngine(tier_model, slots=2, max_length=64,
                                 sync_every=2, block_size=8)
        ref.submit(pt.serving.Request(prompt, max_new_tokens=14, rid="m"))
        assert got == ref.run()["m"].tokens


def test_migrate_insert_resets_slot_state_on_the_card(tier_model):
    from paddle_tpu_torch.distributed import quantized_comm as qc
    from paddle_tpu_torch.jit import DecodeState, MigrateInsert
    from paddle_tpu_torch.serving import paged_kv as pk

    caches = tier_model.gen_cache(3, 64, block_size=8, pool_blocks=13)
    st = DecodeState.make(caches, first_tokens=[0, 0, 0], pos=[0, 0, 0])
    rows = [tuple(torch.full((8,) + tuple(t.shape[1:]), float(i + 1))
                  for t in qc.tensors_of(leaf.kv))
            for i, leaf in enumerate(pk.paged_leaves(caches))]
    # the splice copies the rows in and reads nothing back: count the
    # calls that bring a CUDA tensor's values to the host
    reads = []
    names = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
             "__float__", "__index__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def wrap(name, real):
        def counting(self, *a, **kw):
            if self.is_cuda:
                reads.append(name)
            return real(self, *a, **kw)
        return counting

    for n, real in saved.items():
        setattr(torch.Tensor, n, wrap(n, real))
    try:
        MigrateInsert()(st, rows, 2, [4, 7, 9, 0, 0, 0, 0, 0], ctx=19,
                        last_tok=33, temperature=0.5, top_k=3, top_p=0.9,
                        eos_id=7, budget=5, adapter=1)
    finally:
        for n, real in saved.items():
            setattr(torch.Tensor, n, real)
    assert reads == []
    assert st.pos.tolist() == [0, 0, 19] and st.tok.tolist() == [0, 0, 33]
    assert st.done.tolist() == [False, False, False]
    assert (st.top_k[2].item(), st.eos[2].item(), st.budget[2].item(),
            st.adapter[2].item()) == (3, 7, 5, 1)
    leaf = next(pk.paged_leaves(caches))
    assert leaf.table[2].tolist() == [4, 7, 9, 0, 0, 0, 0, 0]
    assert float(leaf.kv[9].mean()) == 1.0


def test_retire_slots_relocates_on_the_card(tier_model):
    eng = pt.InferenceEngine(tier_model, slots=4, max_length=64,
                             sync_every=2, block_size=8)
    want = list(pt.generate(tier_model, [[2, 3, 4]], 12, max_length=64)[0])
    for i in range(4):
        eng.submit(pt.serving.Request([2, 3, 4], max_new_tokens=12,
                                      rid=f"r{i}"))
    results = {}
    while not all(eng.progress().get(f"r{i}") for i in range(4)):
        eng.turn(results)
    top = max(eng._active)
    keep = eng._active[top].req.rid
    for i in range(4):
        if f"r{i}" != keep:
            eng.cancel(f"r{i}")
    steps = eng._prefill._n_steps
    assert eng.retire_slots(2) == [] and eng.slots == 2
    assert next(s for s, st in eng._active.items()
                if st.req.rid == keep) < top
    assert eng._state.pos.shape == (2,)
    assert eng.run()[keep].tokens == want
    assert eng._prefill._n_steps == steps


# -- the Paddle surface on the card ------------------------------------------


@pytest.fixture()
def default_device():
    """The package's default device, restored after the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.core import device as dev

    saved = dev._current
    yield
    dev._current = saved


def test_to_tensor_lands_on_the_card_by_default(default_device):
    from paddle_tpu_torch.core import device as dev

    dev._current = None  # as a fresh process starts
    x = pt.to_tensor([1.0, 2.0])
    assert x._data.is_cuda and pt.get_device() == "gpu:0"
    assert pt.arange(4)._data.is_cuda
    assert pt.nn.Linear(4, 3).weight.is_cuda


def test_set_device_cpu_is_honoured(default_device):
    pt.set_device("cpu")
    assert not pt.to_tensor([1.0])._data.is_cuda
    assert not pt.nn.LayerNorm(8).weight.is_cuda
    assert pt.get_device() == "cpu"
    pt.set_device("gpu")
    assert pt.to_tensor([1.0])._data.is_cuda


def test_tensor_through_layer_norm_and_flash_launches_kernels(
        default_device, gen):
    """A CUDA ``Tensor`` through the functionals reaches the kernels (B5
    forward, B1 forward, and their backward kernels), with gradients
    equal to the plain torch tensors' through the same functionals."""
    pt.set_device("gpu")
    F = pt.nn.functional
    x0 = torch.randn(64, 256, device="cuda", generator=gen)
    w = torch.randn(256, device="cuda", generator=gen)
    b = torch.randn(256, device="cuda", generator=gen)
    q0 = torch.randn(2, 4, 128, 64, device="cuda", generator=gen)
    kernels.reset_launches()
    x = pt.to_tensor(x0, stop_gradient=False)
    y = F.layer_norm(x, [256], w, b, 1e-5)
    q = pt.to_tensor(q0, stop_gradient=False)
    o = F.flash_core(q, q, q, causal=True)
    assert isinstance(y, pt.Tensor) and isinstance(o, pt.Tensor)
    (y.sum() + o.sum()).backward()
    counts = kernels.launches()
    for name in ("layer_norm_fwd", "layer_norm_bwd", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert counts[name] == 1, (name, counts)
    xr, qr = x0.clone().requires_grad_(), q0.clone().requires_grad_()
    (F.layer_norm(xr, [256], w, b, 1e-5).sum()
     + F.flash_core(qr, qr, qr, causal=True).sum()).backward()
    torch.testing.assert_close(x.grad._data, xr.grad, rtol=0, atol=0)
    torch.testing.assert_close(q.grad._data, qr.grad, rtol=0, atol=0)


def test_no_cpu_fallback_without_a_card(monkeypatch, default_device):
    """With no card visible, the default device raises: nothing falls
    back to the CPU in silence."""
    from paddle_tpu_torch.core import device as dev

    dev._current = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.set_device("gpu")


def test_underdetermined_lstsq_on_the_card(default_device):
    """A [3, 4] by [3, 2] system on the card: the minimum-norm solution
    (numpy's and the JAX package's), residuals |b - a x|^2 of shape (2,),
    rank 3, the singular values; equal to the CPU's within float32
    rounding of a 4 x 4 problem (1e-5)."""
    import numpy as np

    a = np.random.RandomState(0).uniform(-1, 1, (3, 4)).astype(np.float32)
    b = np.array([[1, 2], [0, 1], [3, 1]], dtype=np.float32)
    sol, resid, rank, sv = pt.lstsq(pt.to_tensor(a), pt.to_tensor(b))
    assert sol._data.is_cuda and tuple(resid.shape) == (2,)
    np.testing.assert_allclose(sol.numpy(), np.linalg.lstsq(
        a, b, rcond=None)[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(resid.numpy(), np.sum(
        (b - a @ sol.numpy()) ** 2, axis=0), rtol=1e-5, atol=1e-5)
    assert int(rank.numpy()) == 3
    np.testing.assert_allclose(sv.numpy(), np.linalg.svd(a)[1], rtol=1e-5,
                               atol=1e-5)


def test_translation_path_launches(default_device, monkeypatch):
    """``chip_smoke.py``'s translation script at Transformer-base width and
    depth (B 8, 64 tokens): a training step launches B5 and B7 30 times
    each, on float32 rows, and nothing else; greedy decoding of 8 sources
    for 4 tokens launches B5 12 + 18 x 4 times and nothing else."""
    import numpy as np

    from chip_smoke import greedy, padding_mask, smoothed_loss, \
        translation_model

    monkeypatch.delenv("PADDLE_FUSED_LN", raising=False)
    paddle = pt
    paddle.set_device("gpu")
    model = translation_model(paddle, 1000)
    rng = np.random.RandomState(0)
    src = rng.randint(2, 1000, (8, 64))
    src[::2, -8:] = 0
    tgt = rng.randint(2, 1000, (8, 65))
    s = paddle.to_tensor(src)
    kernels.reset_launches()
    logits = model(s, paddle.to_tensor(tgt[:, :-1]), padding_mask(paddle, s),
                   paddle.nn.Transformer.generate_square_subsequent_mask(64))
    smoothed_loss(paddle, logits, paddle.to_tensor(tgt[:, 1:]),
                  1000).backward()
    want = {name: {} for name in kernels.WRAPPERS}
    want.update(layer_norm_fwd={"float32": 30}, layer_norm_bwd={"float32": 30})
    assert kernels.launches_by_dtype() == want
    model.eval()
    kernels.reset_launches()
    with paddle.no_grad():
        greedy(paddle, model, s, padding_mask(paddle, s), 4)
    want.update(layer_norm_fwd={"float32": 12 + 18 * 4}, layer_norm_bwd={})
    assert kernels.launches_by_dtype() == want


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_reuses_pinned_buffers_only_after_their_copy(
        default_device, num_workers):
    """Two DataLoader epochs back to back, each batch's copy queued behind
    a spin kernel so it is still in flight when the next batch is staged:
    every device batch must equal its numpy batch (a pinned buffer taken
    again before its copy ran would carry the next batch's bytes). Thread
    workers (2) and the consumer's own loop (0)."""
    import numpy as np

    from paddle_tpu_torch.io import DataLoader, TensorDataset

    pt.set_device("gpu")
    data = np.random.RandomState(0).rand(96, 3, 128, 128).astype(np.float32)
    labels = np.arange(96, dtype=np.int64)
    loader = DataLoader(TensorDataset([data, labels]), batch_size=8,
                        num_workers=num_workers, use_shared_memory=False)
    got = []
    for _ in range(2):
        for x, y in loader:
            assert x.place.kind == "gpu" and y.place.kind == "gpu"
            got.append((x, y))
            torch.cuda._sleep(20_000_000)  # hold the stream ~10 ms
    torch.cuda.synchronize()
    assert len(got) == 24
    for i, (x, y) in enumerate(got):
        lo = (i % 12) * 8
        assert np.array_equal(x.numpy(), data[lo:lo + 8]), i
        assert np.array_equal(y.numpy(), labels[lo:lo + 8]), i
    assert len(loader._stager._free) <= loader._stager._MAX_FREE


def test_static_program_launches_as_its_eager_step(default_device):
    """``chip_smoke.py``'s static BERT at 2 layers, d 256, B 4 x 128 on the
    card, float32, TF32 off: the first ``Executor.run`` launches B5 and B7
    as many times as the eager step (twice a layer each), nothing else,
    and leaves every parameter equal to the eager step's."""
    import numpy as np

    from chip_smoke import static_bert, static_bert_program

    torch.backends.cuda.matmul.allow_tf32 = False
    pt.set_device("gpu")
    kw = dict(vocab=512, d=256, heads=4, layers=2, max_pos=128)
    model = static_bert(pt, **kw)
    twin = static_bert(pt, **kw)
    twin.set_state_dict(model.state_dict())
    feed = {"ids": np.arange(512).reshape(4, 128) % 500,
            "pos": np.tile(np.arange(128), (4, 1)),
            "label": np.arange(4) % 2}
    pt.enable_static()
    try:
        main, startup, loss = static_bert_program(pt, model, 4, 128)
        exe = pt.static.Executor()
        exe.run(startup)
        kernels.reset_launches()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
        static_counts = kernels.launches()
    finally:
        pt.disable_static()
    opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                             parameters=twin.parameters())
    kernels.reset_launches()
    e_loss = pt.nn.functional.cross_entropy(
        twin(pt.to_tensor(feed["ids"]), pt.to_tensor(feed["pos"])),
        pt.to_tensor(feed["label"]))
    opt.minimize(e_loss)
    eager_counts = kernels.launches()
    want = {name: 0 for name in kernels.WRAPPERS}
    want.update(layer_norm_fwd=4, layer_norm_bwd=4)
    assert static_counts == eager_counts == want
    np.testing.assert_allclose(float(lv), float(e_loss), rtol=1e-6)
    for p, q in zip(model.parameters(), twin.parameters()):
        assert (p - q).abs().max() <= 1e-6 * q.abs().max()


def test_launcher_runs_a_verbatim_script_on_the_card(tmp_path):
    """tests/reference_scripts/fluid_fit_a_line.py verbatim through
    ``python -m paddle_tpu_torch.run`` on the card: exit 0, the loss
    falls, the exit line names the card with peak memory above 0, no
    jax or paddle_tpu module and no kernel launch (a linear model)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from chip_smoke import run_reference_scripts, write_housing

    write_housing(os.path.join(tmp_path, "uci_housing"))
    runs = run_reference_scripts(str(tmp_path), only="fluid_fit_a_line.py")
    rc, out, err, _, losses, line = runs["fluid_fit_a_line.py"]
    assert rc == 0, err[-3000:]
    assert len(losses) >= 2 and losses[-1] < losses[0]
    assert line[0].startswith("cuda") and line[1] > 0
    assert line[2:4] == (False, False)
    assert line[4] == {name: 0 for name in kernels.WRAPPERS}


# -- the kernels as custom ops, to_static and jit.save on the card ----------


def _opcheck_cases(gen):
    ops = torch.ops.paddle_tpu_torch
    q, k, v = (torch.randn(4, 16, 1024, 64, device="cuda", generator=gen)
               for _ in range(3))
    out, lse = ops.flash_attention_fwd(q, k, v, True, 256, 256, None, 0, 0)
    dout = torch.randn_like(out)
    delta = (dout * out).sum(-1)
    x, y = (torch.randn(4096, 1024, device="cuda", generator=gen)
            for _ in range(2))
    w = 1 + 0.1 * torch.randn(1024, device="cuda", generator=gen)
    b = 0.1 * torch.randn(1024, device="cuda", generator=gen)
    _, mu, rs = ops.layer_norm_fwd(x, w, b, 1e-5)
    grad = [t.clone().requires_grad_(True) for t in (q, k, v, x, y, w, b)]
    gq, gk, gv, gx, gy, gw, gb = grad
    bwd = (q, k, v, dout, lse, delta, True, None, 0, 0)
    return {
        "flash_attention_fwd": (gq, gk, gv, True, 256, 256, None, 0, 0),
        "flash_attention_bwd_dq": bwd, "flash_attention_bwd_dkv": bwd,
        "layer_norm_fwd": (gx, gw, gb, 1e-5),
        "add_layer_norm_fwd": (gx, gy, gw, gb, 1e-5),
        "layer_norm_bwd": (x, w, mu, rs, torch.randn_like(x))}


def test_custom_ops_opcheck_at_the_cards_shapes(gen):
    """``torch.library.opcheck`` of the six ops at the GPT training
    shapes (float32): schema, fake implementation, autograd registration
    on the forwards, AOT dispatch."""
    for name, args in _opcheck_cases(gen).items():
        result = torch.library.opcheck(
            getattr(torch.ops.paddle_tpu_torch, name), args)
        assert set(result.values()) == {"SUCCESS"}, (name, result)


# the ring's per-rank shard at GPT-medium width (S 8192 over sp4): the
# diagonal shard, an earlier rank's (not causal), a later rank's (fully
# masked: every key in the future)
PARTIAL_CASES = [(True, 0), (False, 0), (True, 2048)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,ko", PARTIAL_CASES,
                         ids=["diagonal", "full", "masked"])
def test_flash_attention_partial_on_the_card(gen, dtype, causal, ko):
    """``flash_attention_partial`` at [1, 16, 2048, 64]: out and lse
    against the plain forward; its autograd formula (a loss reading out
    and lse) against ``flash_attention_bwd_plain`` with ``delta =
    rowsum(g_out * out) - g_lse``; the B1, B3 and B4 kernels launched
    once each, no plain path; a fully masked shard gives out 0, lse
    -1e30 and zero gradients; ``opcheck`` passes at that shape."""
    shape = (1, 16, 2048, 64)
    q, k, v, go = (torch.randn(shape, device="cuda", generator=gen
                               ).to(dtype) for _ in range(4))
    gl = torch.randn(shape[:3], device="cuda", generator=gen)
    kw = dict(causal=causal, q_offset=0, kv_offset=ko)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    kernels.reset_launches()
    out, lse = fa.flash_attention_partial(*ts, causal, 256, 256, None, 0, ko)
    ((out.float() * go.float()).sum() + (lse * gl).sum()).backward()
    po, pl = fa.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (go.float() * po.float()).sum(-1) - gl
    ref = fa.flash_attention_bwd_plain(q, k, v, go, pl, delta, **kw)
    assert_near(out.detach(), po, dtype)
    assert_near(lse.detach(), pl, torch.float32)
    for t, want in zip(ts, ref):
        assert_near(t.grad, want, dtype)
    assert {n: kernels.launches()[n] for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")} == dict.fromkeys(
        ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv"), 1)
    assert fa.flash_attention_partial.launches == 1
    if ko:
        assert bool((out == 0).all()) and bool((lse <= -1e29).all())
        assert all(bool((t.grad == 0).all()) for t in ts)
    result = torch.library.opcheck(
        torch.ops.paddle_tpu_torch.flash_attention_partial,
        ([t.detach().requires_grad_() for t in (q, k, v)]
         + [causal, 256, 256, None, 0, ko]))
    assert set(result.values()) == {"SUCCESS"}, result


def test_to_static_step_launches_as_the_eager_step(gen):
    """A ``to_static`` training step on the card: the same loss and
    gradients as the eager step of a twin (float32, TF32 off), and each
    kernel launched as often."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = pt.TransformerLM(64, d_model=128, num_heads=2, num_layers=2,
                             max_position=64, seed=1)
    twin = pt.TransformerLM(64, d_model=128, num_heads=2, num_layers=2,
                            max_position=64, seed=1)
    twin.load_state_dict(model.state_dict())
    ids = torch.randint(0, 64, (2, 65), device="cuda", generator=gen)
    static = pt.jit.to_static(model)

    def step(m):
        kernels.reset_launches()
        logits = m(ids[:, :-1])
        logits = logits._data if hasattr(logits, "_data") else logits
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 64),
                                                 ids[:, 1:].reshape(-1))
        loss.backward()
        return loss.item(), kernels.launches()

    (ls, cs), (le, ce) = step(static), step(twin)
    assert cs == ce == {"flash_attention_fwd": 2,
                        "flash_attention_bwd_dq": 2,
                        "flash_attention_bwd_dkv": 2, "layer_norm_fwd": 3,
                        "add_layer_norm_fwd": 2, "layer_norm_bwd": 5}
    assert abs(ls - le) <= 1e-6 * abs(le)
    for (n, a), b in zip(model.named_parameters(), twin.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=0,
                                   atol=1e-5 * b.grad.abs().max().item(),
                                   msg=n)


def test_jit_save_load_round_trip_on_the_card(gen, tmp_path):
    """Saved on the card, the artifact loads on the card (the kernels
    launched as in the eager forward, the logits bit-equal) and on the
    CPU (the plain versions, within float32 rounding)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = pt.TransformerLM(64, d_model=128, num_heads=2, num_layers=2,
                             max_position=64, seed=1)
    model.eval()
    ids = torch.randint(0, 64, (2, 64), device="cuda", generator=gen)
    with torch.no_grad():
        kernels.reset_launches()
        want = model(ids)
        eager = kernels.launches()
    path = str(tmp_path / "lm")
    pt.jit.save(model, path, input_spec=[pt.jit.InputSpec([2, 64],
                                                          "int64")])
    with torch.no_grad():
        kernels.reset_launches()
        got = pt.jit.load(path)(ids)
        assert kernels.launches() == eager
        on_cpu = pt.jit.load(path, device="cpu")(ids.cpu())
    # torch tensors in, torch tensors out
    assert torch.equal(got, want)
    torch.testing.assert_close(on_cpu, want.cpu(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def test_captured_cond_and_while_loop_on_the_card(gen):
    """The card's torch captures a tensor ``cond`` and ``while_loop`` under
    ``to_static`` as torch's higher-order ops, and the captured programs
    pick the branch, or loop, at run time."""
    pt.set_device("gpu")

    def branch(x):
        return pt.jit.cond(pt.sum(x) > 0, lambda a: a * 2.0,
                           lambda a: a - 1.0, x)

    def loop(n):
        i, s = pt.to_tensor(0), pt.to_tensor(0)
        i, s = pt.jit.while_loop(lambda i, s: i < n,
                                 lambda i, s: (i + 1, s + i), [i, s])
        return s

    sb, sl = pt.jit.to_static(branch), pt.jit.to_static(loop)
    assert sb(pt.to_tensor([1.0, 2.0])).numpy().tolist() == [2.0, 4.0]
    assert sb(pt.to_tensor([-5.0, 1.0])).numpy().tolist() == [-6.0, 0.0]
    assert sl(pt.to_tensor(5)).item() == 10
    assert sl(pt.to_tensor(7)).item() == 21
    for fn, op in ((sb, "cond"), (sl, "while_loop")):
        (prog,) = fn.program_cache.values()
        assert any(getattr(n.target, "__name__", "") == op
                   for n in prog.exported.graph.nodes), op


# -- the detection ops, the guarded step (card against CPU) -----------------

def _detection_cases():
    """(op, args as numpy, kwargs, indices of differentiable args) at small
    sizes; the same inputs go to the card and to the CPU."""
    import numpy as np

    r = np.random.RandomState(0)

    def corners(n, seed, scale):
        q = np.random.RandomState(seed)
        lo = q.rand(n, 2) * 0.6 * scale
        return np.concatenate([lo, lo + (q.rand(n, 2) * 0.3 + 0.05)
                               * scale], 1).astype(np.float32)

    head = r.randn(2, 3 * 9, 8, 8).astype(np.float32)
    gt = (r.rand(2, 6, 4) * 0.5 + 0.1).astype(np.float32)
    feat = r.randn(2, 4, 16, 20).astype(np.float32)
    rois = np.concatenate([corners(5, 1, 15.0), corners(3, 2, 15.0)])
    nb = np.array([5, 3], np.int32)
    boxes = np.stack([corners(40, 3, 50.0), corners(40, 4, 50.0)])
    scores = r.rand(2, 5, 40).astype(np.float32)
    pri = corners(6, 5, 1.0)
    var = np.full((6, 4), 0.1, np.float32)
    dist = r.rand(2, 4, 9).astype(np.float32)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    return {
        "yolo_box": ([head, np.array([[256, 256], [200, 240]], np.int32),
                      anchors[:6], 4, 0.1, 32], {}, (0,)),
        "yolo_loss": ([head, gt, r.randint(0, 4, (2, 6)).astype(np.int32),
                       anchors, [0, 1, 2], 4, 0.7, 32], {}, (0,)),
        "prior_box": ([feat, np.zeros((2, 3, 64, 80), np.float32), [8.0],
                       [16.0], [2.0]], dict(flip=True), ()),
        "anchor_generator": ([feat, [32, 64], [0.5, 1.0, 2.0]], {}, ()),
        "box_coder": ([pri, var, corners(3, 6, 1.0)], {}, (0, 2)),
        "iou_similarity": ([pri, corners(4, 7, 1.0)], {}, (0, 1)),
        "box_clip": ([boxes * 2, np.array([[60, 70, 1.0], [80, 90, 2.0]],
                                          np.float32)], {}, ()),
        "roi_align": ([feat, rois, nb, 3], dict(spatial_scale=0.5),
                      (0, 1)),
        "roi_pool": ([feat, rois, nb, 3], {}, (0,)),
        "multiclass_nms": ([boxes, scores, 0.05, 20, 30, 0.45, False, 0.8,
                            -1], {}, ()),
        "bipartite_match": ([dist, "per_prediction", 0.4], {}, ()),
        "target_assign": ([r.randn(2, 4, 3).astype(np.float32),
                           r.randint(-1, 4, (2, 9)).astype(np.int32)],
                          {}, ()),
        "nms": ([boxes[0], 0.3, scores[0, 0]], {}, ()),
    }


@pytest.mark.parametrize("op", sorted(_detection_cases()))
def test_detection_op_on_the_card_equals_the_cpu(default_device, op):
    """Each detection op on CUDA tensors against the same call on CPU
    tensors: outputs within 1e-4 (integers exact), and the gradients of
    the differentiable ones."""
    import numpy as np

    from paddle_tpu_torch.vision import ops

    args, kwargs, diff = _detection_cases()[op]
    outs, grads = {}, {}
    for dev in ("cpu", "gpu"):
        pt.set_device(dev)
        ts = [pt.to_tensor(a, stop_gradient=i not in diff)
              if isinstance(a, np.ndarray) else a
              for i, a in enumerate(args)]
        got = getattr(ops, op)(*ts, **kwargs)
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        assert all(g._data.is_cuda == (dev == "gpu") for g in got)
        outs[dev] = [g.numpy() for g in got]
        if diff:
            sum(pt.sum(g * g) for g in got
                if g._data.dtype == torch.float32).backward()
            grads[dev] = [ts[i].gradient() for i in diff]
    for c, g in zip(outs["cpu"], outs["gpu"]):
        if c.dtype.kind == "f":
            np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, c)
    for c, g in zip(grads.get("cpu", []), grads.get("gpu", [])):
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4)


def _gpt_step(guard, monkeypatch, spec=None):
    monkeypatch.setenv("PADDLE_GUARD_MODE", "skip" if guard else "off")
    monkeypatch.setenv("PADDLE_GUARD_SYNC_EVERY", "2")
    if spec:
        monkeypatch.setenv("PADDLE_FAULT_SPEC", spec)
    else:
        monkeypatch.delenv("PADDLE_FAULT_SPEC", raising=False)
    from paddle_tpu_torch.utils import fault_injection

    fault_injection.reset()
    pt.seed(3)
    model = pt.TransformerLM(64, d_model=128, num_heads=2, num_layers=2,
                             max_position=128, seed=3)
    step = pt.jit.TrainStep(
        model, lambda o, y: pt.nn.functional.cross_entropy(
            o.reshape(-1, 64), y.reshape(-1)),
        pt.optimizer.AdamW(learning_rate=1e-3,
                           parameters=model.parameters()))
    return model, step


def test_guarded_step_equals_the_unguarded_on_the_card(default_device,
                                                       monkeypatch):
    """Guard on (no fault) against guard off: the same losses and
    parameters bit for bit; the guarded steps make no synchronizing call
    (sync debug mode "error"); its state is read one interval late."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, 64, (2, 129), device="cuda", generator=g)
    runs = {}
    for guard in (False, True):
        model, step = _gpt_step(guard, monkeypatch)
        step(ids[:, :-1], ids[:, 1:])      # warm-up: builds, allocates
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = [step(ids[:, :-1], ids[:, 1:]) for _ in range(4)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        runs[guard] = ([float(x) for x in losses],
                       {k: v.clone() for k, v in model.state_dict().items()})
        if guard:
            # steps 1-5, reads at steps 2 and 4: step 4 read step 2's state
            assert step._guard._last_step == 2 and step._guard._last[1] == 0
            assert step._guard_state.is_cuda
    assert runs[True][0] == runs[False][0]
    for k, v in runs[False][1].items():
        assert torch.equal(runs[True][1][k], v), k


def test_grad_nan_skips_bitwise_on_the_card(default_device, monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, 64, (2, 129), device="cuda", generator=g)
    model, step = _gpt_step(True, monkeypatch, spec="grad:nan:2:2")
    after = []
    for _ in range(4):
        step(ids[:, :-1], ids[:, 1:])
        after.append({k: v.clone() for k, v in model.state_dict().items()})
    step._guard.flush()
    assert step._guard._last[1] == 2.0
    for k in after[0]:
        assert torch.equal(after[0][k], after[2][k]), k
    # the FLOP count on fake CUDA tensors is the CPU count of one step
    assert step.flops_per_step() > 0


# -- worlds of ranks on the card --------------------------------------------
#
# Two ranks share the one card (the backend rule gives gloo: NCCL refuses
# two ranks on one device), started by the port's spawn; the ranks run
# tests/helpers/torch_world.py's cases and return their results.


def test_collectives_on_cuda_tensors(default_device, tmp_path):
    """Every collective on CUDA tensors of a 2-rank world on the card:
    float32 results equal numpy's (rtol 1e-6; 1e-5 for PROD and AVG),
    bf16 within one bf16 rounding; each counted on gloo, transport
    gloo-cuda (gloo takes the CUDA tensors itself)."""
    import numpy as np
    from helpers import torch_world as tw

    rng = np.random.RandomState(0)
    x = (rng.rand(2, 3, 4) + 0.5).astype(np.float32)
    rs = rng.rand(2, 4, 3).astype(np.float32)
    out = tw.run_world(["cuda_collectives"], str(tmp_path),
                       {"x": x, "rs": rs}, nprocs=2, device="gpu")
    res = out["cuda_collectives"]
    want = {"sum": x.sum(0), "max": x.max(0), "min": x.min(0),
            "prod": x.prod(0), "avg": x.mean(0)}
    for r, o in enumerate(res):
        assert o["backend"] == "gloo" and o["device"] == "cuda:0"
        for key, rtol in (("float32", 1e-5), ("bfloat16", 2 ** -7)):
            for name, w in want.items():
                np.testing.assert_allclose(o[key, name], w, rtol=rtol,
                                           err_msg=f"{key} {name}")
            np.testing.assert_allclose(
                o[key, "reduce"], x.sum(0) if r == 1 else x[r], rtol=rtol)
            for i in range(2):
                np.testing.assert_allclose(o[key, "all_gather"][i], x[i],
                                           rtol=rtol)
                np.testing.assert_allclose(o[key, "alltoall"][i], x[r],
                                           rtol=rtol)
            np.testing.assert_allclose(o[key, "broadcast"], x[1],
                                       rtol=rtol)
            np.testing.assert_allclose(o[key, "reduce_scatter"],
                                       rs.sum(0)[2 * r:2 * r + 2],
                                       rtol=rtol)
            np.testing.assert_allclose(o[key, "scatter"], x[r], rtol=rtol)
        ops = {c["op"] for c in o["counts"]}
        assert ops == {"all_reduce", "reduce", "all_gather", "broadcast",
                       "reduce_scatter", "scatter", "alltoall", "barrier"}
        for c in o["counts"]:
            assert (c["backend"], c["transport"]) == ("gloo", "gloo-cuda"), c


def test_parallel_gpt_block_at_mp2_on_the_card(default_device, tmp_path):
    """``ParallelGPTBlock`` at mp2 (2 ranks on the card, 2 heads each)
    against the block in one process, float32 with TF32 off, through the
    kernels: output, input gradient and every parameter gradient (gathered
    to full) within 1e-5 of each one's largest value (the row-parallel
    all-reduce sums two partial products)."""
    import numpy as np
    from helpers import torch_world as tw

    torch.backends.cuda.matmul.allow_tf32 = False
    pt.seed(5)
    d, heads = 256, 4
    blk = pt.distributed.ParallelGPTBlock(d, heads, dropout=0.0,
                                          device="gpu")
    rng = np.random.RandomState(1)
    x = rng.randn(2, 256, d).astype(np.float32)
    cot = rng.randn(2, 256, d).astype(np.float32)
    want = tw._fwd_bwd(blk, x, cot, "cuda")
    inputs = {"d": d, "heads": heads, "x": x, "cot": cot,
              "block": {k: v.detach().cpu() for k, v in
                        blk.state_dict().items()}}
    out = tw.run_world(["cuda_gpt_block"], str(tmp_path), inputs, nprocs=2,
                       device="gpu")

    def near(got, w, what):
        err = np.abs(got - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-5, (what, err)

    for r, o in enumerate(out["cuda_gpt_block"]):
        near(o["out"], want["out"], "out")
        near(o["gx"], want["gx"], "dx")
        for k, w in want["grads"].items():
            near(o["grads"][k], w, k)
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv", "layer_norm_fwd",
                     "add_layer_norm_fwd", "layer_norm_bwd"):
            assert o["launches"][name] >= 1, (r, name)
        assert o["shapes"]["flash_attention_fwd"] == [(2, 2, 256, 64)]
