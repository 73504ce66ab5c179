"""The port's kernel modules against paddle_tpu's Pallas kernels.

paddle_tpu_torch's kernel wrappers run their plain PyTorch versions on a
CPU tensor; here they are held against paddle_tpu's Pallas kernels run in
the Pallas interpreter, on the same numpy inputs. The CUDA kernels
themselves are held against those plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: float32 atol 2e-5 (both sides compute in f32; only the
summation order differs); bfloat16 atol 1e-2 + rtol 1e-2 (both compute in
f32 and round the stored output once, so they differ by at most a bf16
ulp, 2^-8 relative).
"""
import importlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.distributed import comm
from paddle_tpu.nn.functional import attention as jax_attn
from paddle_tpu.nn.functional import norm as jax_norm
from paddle_tpu.ops.pallas import fused_add_layer_norm, fused_layer_norm

from helpers.torch_threads import one_torch_thread  # noqa: F401
from paddle_tpu_torch.nn.functional import attention as t_attn
from paddle_tpu_torch.nn.functional import norm as t_norm
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import layer_norm as tln

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

F32_ATOL = 2e-5
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.fixture()
def no_mesh():
    """Route decisions of paddle_tpu read the hybrid mesh: run them with
    none declared, and restore whatever was there."""
    prev = comm._state.hybrid_mesh
    comm._state.hybrid_mesh = None
    yield
    comm._state.hybrid_mesh = prev


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(B, H, S, Sk, D, seed):
    r = np.random.RandomState(seed)
    return [r.randn(B, H, n, D).astype(np.float32) for n in (S, Sk, Sk)]


FLASH_CASES = {
    # name: (B, H, S, Sk, D, causal, q_offset, kv_offset, block_q, block_k)
    "causal": (2, 2, 32, 32, 16, True, 0, 0, 8, 16),
    "non_causal": (2, 2, 16, 32, 16, False, 0, 0, 8, 8),
    "q_offset_end_aligned": (1, 3, 16, 48, 32, True, 32, 0, 8, 16),
    "fully_masked_rows": (2, 2, 16, 16, 16, True, 0, 8, 8, 8),
}


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["resident", "streaming"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_forward_matches_pallas(case, dtype, streaming, monkeypatch):
    B, H, S, Sk, D, causal, qo, ko, bq, bk = FLASH_CASES[case]
    if streaming:  # force the Pallas streaming kernel (B2)
        monkeypatch.setattr(jax_fa, "_RESIDENT_KV_BYTES", 0)
    q, k, v = _qkv(B, H, S, Sk, D, seed=len(case))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jo, jl = jax_fa.flash_attention_partial(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal, bq, bk, None,
        True, qo, ko)
    to, tl = tfa.flash_attention_fwd(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        block_q=bq, block_k=bk, q_offset=qo, kv_offset=ko)
    assert to.dtype == tdt and tl.dtype == torch.float32
    assert tuple(tl.shape) == (B, H, S)
    tol = dict(atol=F32_ATOL, rtol=0) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(to.float().numpy(), _f32(jo), **tol)
    np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=F32_ATOL, rtol=0)
    if ko:  # rows with every key in the future: out = 0, lse = -1e30
        assert (to[:, :, :ko].float() == 0).all()
        assert (tl[:, :, :ko] == -1e30).all()
        np.testing.assert_array_equal(_f32(jl)[:, :, :ko],
                                      np.float32(-1e30))


def test_flash_indivisible_block_raises():
    q, k, v = (torch.zeros(1, 1, 12, 8) for _ in range(3))
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention_fwd(q, k, v, block_q=8, block_k=8)
    with pytest.raises(ValueError, match="divisible"):
        jax_fa.flash_attention(*(jnp.zeros((1, 1, 12, 8)),) * 3, False, 8,
                               8, None, True)


LN_SHAPES = [(16, 128), (4, 8, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LN_SHAPES, ids=str)
def test_layer_norm_matches_pallas(shape, dtype):
    r = np.random.RandomState(1)
    x = r.randn(*shape).astype(np.float32) * 3 + 1
    D = shape[-1]
    w = (1 + 0.3 * r.randn(D)).astype(np.float32)
    b = (0.3 * r.randn(D)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jy = fused_layer_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                          jnp.asarray(b, jdt), 1e-5, True)
    ty = tln.fused_layer_norm(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(w).to(tdt),
                              torch.from_numpy(b).to(tdt), 1e-5)
    assert ty.dtype == tdt and tuple(ty.shape) == shape
    tol = dict(atol=F32_ATOL, rtol=0) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(ty.float().numpy(), _f32(jy), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LN_SHAPES, ids=str)
def test_add_layer_norm_matches_pallas(shape, dtype):
    r = np.random.RandomState(2)
    x, y = (r.randn(*shape).astype(np.float32) * 2 for _ in range(2))
    D = shape[-1]
    w = (1 + 0.3 * r.randn(D)).astype(np.float32)
    b = (0.3 * r.randn(D)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    js, jo = fused_add_layer_norm(
        jnp.asarray(x, jdt), jnp.asarray(y, jdt), jnp.asarray(w, jdt),
        jnp.asarray(b, jdt), 1e-5, True)
    ts, to = tln.fused_add_layer_norm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt),
        torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt), 1e-5)
    # s is the sum rounded once to the input type: equal bit for bit
    np.testing.assert_array_equal(ts.float().numpy(), _f32(js))
    tol = dict(atol=F32_ATOL, rtol=0) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(to.float().numpy(), _f32(jo), **tol)


def test_add_layer_norm_normalizes_the_stored_sum():
    """bf16: LN(s) must be LN of the ROUNDED sum, not of the f32 sum."""
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.randn(16, 128).astype(np.float32)).bfloat16()
    y = torch.from_numpy(r.randn(16, 128).astype(np.float32)).bfloat16()
    w, b = torch.ones(128), torch.zeros(128)
    s, out, mu, rs = tln.add_layer_norm_fwd(x, y, w, b)
    s_rounded = (x.float() + y.float()).bfloat16()
    assert torch.equal(s, s_rounded)
    np.testing.assert_allclose(mu.numpy(), s_rounded.float().mean(-1).numpy(),
                               atol=1e-6)
    ref, _, _ = tln.layer_norm_fwd_plain(s_rounded, w, b)
    assert torch.equal(out, ref)


def _route_cases():
    cases = []
    for shape in [(8, 128), (16, 128), (4, 128), (2, 8, 256), (8, 100),
                  (3, 5, 128), (128,)]:
        for dtype in ("float32", "bfloat16"):
            for affine in (True, False):
                cases.append((shape, dtype, affine, 1))
    cases.append(((8, 2, 128), "float32", True, 2))  # two normalized axes
    return cases


@pytest.mark.parametrize("mode", ["interpret", "0", None])
def test_ln_route_matches_jax_eligibility(mode, monkeypatch, no_mesh):
    if mode is None:
        monkeypatch.delenv("PADDLE_FUSED_LN", raising=False)
    else:
        monkeypatch.setenv("PADDLE_FUSED_LN", mode)
    for shape, dtype, affine, n_axes in _route_cases():
        ns = tuple(shape[-n_axes:])
        jx = jnp.zeros(shape, jnp.float32 if dtype == "float32"
                       else jnp.bfloat16)
        tx = torch.zeros(shape, dtype=getattr(torch, dtype))
        wb = (object(), object()) if affine else (None, None)
        want = jax_norm._fused_ln_route(jx, ns, *wb) is not None
        got = t_norm._fused_ln_route(tx, ns, *wb)
        assert got == want, (shape, dtype, affine, n_axes, mode)


@pytest.mark.parametrize("mode", ["interpret", "0", None])
def test_flash_plan_matches_jax(mode, monkeypatch, no_mesh):
    if mode is None:
        monkeypatch.delenv("PADDLE_FLASH_DEFAULT", raising=False)
    else:
        monkeypatch.setenv("PADDLE_FLASH_DEFAULT", mode)
    for append in ("1", "0"):
        monkeypatch.setenv("PADDLE_FLASH_APPEND", append)
        for sq, sk in [(16, 16), (136, 136), (12, 12), (4, 4), (8, 32),
                       (32, 8), (1, 9), (24, 40)]:
            for kw in ({}, {"has_mask": True}, {"dropout_active": True},
                       {"has_cache": True}, {"need_weights": True}):
                for causal in (True, False):
                    want = jax_attn.flash_plan(sq, sk, causal=causal,
                                               **kw) is not None
                    got = t_attn.flash_plan(sq, sk, causal=causal,
                                            device="cpu", **kw)
                    assert got == want, (sq, sk, causal, kw, mode, append)


@pytest.mark.parametrize("route", ["interpret", "0"])
@pytest.mark.parametrize("Sq,Sk,causal,masked", [
    (16, 16, True, False), (8, 24, True, False), (16, 16, False, True),
    (16, 16, True, True)])
def test_sdpa_matches_jax(route, Sq, Sk, causal, masked, monkeypatch,
                          no_mesh):
    """Routed scaled_dot_product_attention: the flash route (causal, no
    mask) and the dense form with its end-aligned causal mask."""
    import paddle_tpu
    from paddle_tpu.nn.functional import scaled_dot_product_attention

    monkeypatch.setenv("PADDLE_FLASH_DEFAULT", route)
    q, k, v = _qkv(2, 2, Sq, Sk, 8, seed=Sq + Sk)
    mask = (np.random.RandomState(5).randn(Sq, Sk).astype(np.float32)
            if masked else None)
    want = scaled_dot_product_attention(
        *(paddle_tpu.to_tensor(a) for a in (q, k, v)),
        attn_mask=None if mask is None else paddle_tpu.to_tensor(mask),
        is_causal=causal)
    got = t_attn.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               atol=F32_ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor takes the plain version and counts no launch."""
    before = (tfa.flash_attention_fwd.launches,
              tln.layer_norm_fwd.launches, tln.add_layer_norm_fwd.launches)
    q = torch.randn(1, 2, 8, 8)
    out, lse = tfa.flash_attention_fwd(q, q, q, causal=True)
    po, pl = tfa.flash_attention_fwd_plain(q, q, q, causal=True)
    assert torch.equal(out, po) and torch.equal(lse, pl)
    x = torch.randn(8, 128)
    tln.layer_norm_fwd(x, torch.ones(128), torch.zeros(128))
    tln.add_layer_norm_fwd(x, x, torch.ones(128), torch.zeros(128))
    assert (tfa.flash_attention_fwd.launches, tln.layer_norm_fwd.launches,
            tln.add_layer_norm_fwd.launches) == before


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """No CUDA toolkit: building a kernel raises; nothing falls back."""
    monkeypatch.setenv("PATH", "")
    for env in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(env, raising=False)
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
