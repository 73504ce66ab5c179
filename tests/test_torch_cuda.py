"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper card and the CUDA toolkit (the kernels
build from paddle_tpu_torch/csrc on first use); elsewhere they skip.
This file imports no JAX, so it runs where only PyTorch is installed
(without the shared conftest, which imports paddle_tpu):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances as in chip_smoke.py: float32 atol 1e-4 (summation order);
bfloat16 atol 2e-2 + rtol 1.6e-2 (one or two roundings of the stored
output).
"""
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import layer_norm as ln

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("S,Sk,D,causal,qo,ko", [
    (128, 128, 64, True, 0, 0), (64, 128, 64, True, 64, 0),
    (128, 128, 64, True, 0, 64), (40, 72, 128, False, 0, 0),
    (24, 40, 96, True, 16, 0), (136, 136, 32, True, 0, 0)])
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
    torch.testing.assert_close(o, po, **TOL[dtype])
    torch.testing.assert_close(lse, plse, **TOL[torch.float32])


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
    torch.testing.assert_close(got[0], ref[0], **TOL[dtype])
    torch.testing.assert_close(got2[0], ref2[0], atol=0, rtol=0)
    torch.testing.assert_close(got2[1], ref2[1], **TOL[dtype])
    for a, r in zip(got[1:] + got2[2:], ref[1:] + ref2[2:]):
        torch.testing.assert_close(a, r, **TOL[torch.float32])


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = torch.randn(1, 2, 16, 64, device="cuda", generator=gen)
    qt = q.transpose(2, 3)  # [1, 2, 64, 16], not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(qt, qt, qt)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="CUDA device"):
        ln.layer_norm_fwd(q.reshape(-1, 64), torch.ones(64),
                          torch.zeros(64))
