"""Model-FLOPs utilization (counterpart of
``paddle_tpu/observability/mfu.py``).

- **FLOPs of a step.** The JAX package reads XLA's ``cost_analysis()`` of
  the lowered step; torch has none, so :func:`count_flops` runs the
  step's forward and backward once on fake tensors
  (``torch._subclasses.FakeTensorMode``: shapes only, no device work, no
  gradient written; the model's parameters and buffers swapped for fakes
  of them) under ``torch.utils.flop_counter.FlopCounterMode``.
  The counter prices the matrix products (``mm``, ``addmm``, ``bmm``,
  convolutions, SDPA); elementwise work, reductions and the optimizer
  update count 0, as they are not model FLOPs.
- **The flash kernels.** The counter does not know the port's custom ops
  ``paddle_tpu_torch::flash_attention_fwd``, ``_bwd_dq`` and ``_bwd_dkv``;
  this module registers a formula for each, in torch's own SDPA
  convention: the full S x S score matrix, causal or not. The forward
  counts ``QK^T`` and ``PV``; the backward pair counts the five products
  of torch's SDPA backward formula between them: the dQ op the score
  recompute, ``dO V^T`` and ``dS K``, the dK/dV op ``P^T dO`` and
  ``dS^T Q`` (the dK/dV kernel recomputes the scores and ``dO V^T`` too;
  that recomputation is not counted, as torch's formula does not count
  it).
- **Peak FLOPs** come from a table matched against
  ``torch.cuda.get_device_name()``: the dense bf16 tensor-core peak of
  one card, as the JAX package prices a TPU chip at its bf16 matmul peak.
  ``PADDLE_OBS_PEAK_FLOPS`` overrides it (a float32-bound model on the
  float32 rate, say). On the CPU there is none and MFU is not reported.

``mfu_pct(flops_per_step, step_seconds)`` is then the percent of that
peak a measured step reaches.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import torch

__all__ = ["peak_flops", "mfu_pct", "count_flops", "PEAK_FLOPS"]

_PEAK_ENV = "PADDLE_OBS_PEAK_FLOPS"

#: per-card dense bf16 tensor-core peak (NVIDIA's H100 data sheet),
#: matched by substring against the lowercased device name, first match
#: wins: the PCIe and NVL parts name themselves "H100" too
PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),        # H100 SXM ("NVIDIA H100 80GB HBM3")
)


def peak_flops() -> Optional[float]:
    """The card's peak FLOP/s, or None when unknown (the CPU without the
    ``PADDLE_OBS_PEAK_FLOPS`` override: MFU is then not reported rather
    than reported against a made-up number)."""
    raw = os.environ.get(_PEAK_ENV, "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    try:
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name().lower()
    except Exception:  # noqa: BLE001
        return None
    for sub, peak in PEAK_FLOPS:
        if sub in name:
            return peak
    return None


def mfu_pct(flops_per_step: Optional[float],
            step_seconds: float) -> Optional[float]:
    """Model-FLOPs utilization, percent of the card's peak."""
    peak = peak_flops()
    if not peak or not flops_per_step or step_seconds <= 0:
        return None
    return round(flops_per_step / step_seconds / peak * 100.0, 2)


_registered = False


def _bmm(b, m, k, n) -> int:
    return 2 * b * m * k * n


def _register_flash_formulas() -> None:
    """The flop formulas of the three flash custom ops (see the module
    docstring), registered once."""
    global _registered
    if _registered:
        return
    from torch.utils.flop_counter import register_flop_formula

    from ..ops.kernels import flash_attention  # noqa: F401 -- the ops

    ops = torch.ops.paddle_tpu_torch

    def dims(q_shape, k_shape):
        b, h, s, d = q_shape
        return b * h, s, k_shape[2], d

    @register_flop_formula(ops.flash_attention_fwd)
    def _fwd(q, k, v, *args, out_shape=None, **kwargs) -> int:
        bh, s, sk, d = dims(q, k)
        return _bmm(bh, s, d, sk) + _bmm(bh, s, sk, v[3])

    @register_flop_formula(ops.flash_attention_bwd_dq)
    def _dq(q, k, v, *args, out_shape=None, **kwargs) -> int:
        bh, s, sk, d = dims(q, k)
        return (_bmm(bh, s, d, sk) + _bmm(bh, s, v[3], sk)
                + _bmm(bh, s, sk, d))

    @register_flop_formula(ops.flash_attention_bwd_dkv)
    def _dkv(q, k, v, *args, out_shape=None, **kwargs) -> int:
        bh, s, sk, d = dims(q, k)
        return _bmm(bh, sk, s, v[3]) + _bmm(bh, sk, s, d)

    _registered = True


def count_flops(fn: Callable[[], object], module=None) -> Optional[int]:
    """The FLOPs of ``fn()`` and, with ``module``, of the gradient of its
    result with respect to the module's parameters that require one:
    counted on fake tensors (``FakeTensorMode``: nothing launches, nothing
    is written) under ``FlopCounterMode``. The module's parameters and
    buffers are swapped for fakes of them while ``fn`` runs (a real
    ``Parameter`` never reaches the fake dispatch, which refuses it; an
    in-place buffer update lands on the fake). None when the function
    cannot run on fake tensors."""
    import contextlib
    import itertools

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.nn.utils.stateless import _reparametrize_module
    from torch.utils.flop_counter import FlopCounterMode

    _register_flash_formulas()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    counter = FlopCounterMode(display=False)
    state, leaves = {}, []
    if module is not None:
        for name, t in itertools.chain(module.named_parameters(),
                                       module.named_buffers()):
            f = state[name] = mode.from_tensor(t.detach())
            if t.requires_grad:
                leaves.append(f.requires_grad_(True))
    swap = _reparametrize_module(module, state, tie_weights=True) \
        if module is not None else contextlib.nullcontext()
    try:
        with swap, mode, counter:
            out = fn()
            if leaves:
                torch.autograd.grad(out, leaves, allow_unused=True)
    except Exception:  # noqa: BLE001 -- accounting stays best-effort
        return None
    return int(counter.get_total_flops())
