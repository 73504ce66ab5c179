"""The in-step half of the numerical guard of
``paddle_tpu/utils/train_guard.py``.

``jit.TrainStep`` computes a health word each step, ``isfinite(loss)``
and one square-sum over all gradients (a NaN or Inf anywhere propagates
into it), optionally ``isfinite`` of the updated parameters
(``PADDLE_GUARD_CHECK_PARAMS=1``), and under ``PADDLE_GUARD_MODE=skip``
(the default) masks the update with it: a bad step leaves parameters and
optimizer state bitwise unchanged. The verdict stays on the device; the
host never reads it.

Not ported yet (they raise): ``PADDLE_GUARD_MODE=abort``, spike detection
(``PADDLE_GUARD_SPIKE_FACTOR`` > 0), and the host-side ``TrainGuard``
monitor with its consecutive-skip budget, rollback and replay bundles.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

__all__ = ["guard_mode", "grad_health", "mask_step", "HEALTH_LOSS",
           "HEALTH_GRAD", "HEALTH_PARAM"]

_MODE_ENV = "PADDLE_GUARD_MODE"
_CHECK_PARAMS_ENV = "PADDLE_GUARD_CHECK_PARAMS"
_SPIKE_ENV = "PADDLE_GUARD_SPIKE_FACTOR"

#: health-word bits, as in the JAX package
HEALTH_LOSS = 1      # loss nonfinite
HEALTH_GRAD = 2      # some gradient nonfinite (via the fused norm)
HEALTH_PARAM = 4     # some updated parameter nonfinite


def guard_mode() -> str:
    """``off`` or ``skip``; raises for ``abort`` and for spike detection,
    which need the host monitor."""
    mode = os.environ.get(_MODE_ENV, "skip").strip().lower() or "skip"
    if mode not in ("off", "skip", "abort"):
        raise ValueError(f"{_MODE_ENV}={mode!r}: want one of off|skip|abort")
    if mode == "abort":
        raise NotImplementedError(
            f"{_MODE_ENV}=abort needs the guard's host monitor, which is not "
            "ported yet")
    spike = os.environ.get(_SPIKE_ENV, "").strip()
    if mode != "off" and spike and float(spike) > 0.0:
        raise NotImplementedError(
            f"{_SPIKE_ENV} > 0 (spike detection) is not ported yet")
    return mode


def grad_health(loss: torch.Tensor, grads: Sequence[Optional[torch.Tensor]],
                new_params: Optional[Sequence[torch.Tensor]] = None,
                check_params: Optional[bool] = None):
    """The sentinel: (ok, health_bits, gnorm), all 0-dim tensors on the
    device. ``gnorm`` is the global gradient norm in f32 (0 when it is not
    finite); a finite gradient large enough to overflow f32 when squared
    reads as nonfinite, as in the JAX package."""
    if check_params is None:
        check_params = os.environ.get(_CHECK_PARAMS_ENV, "").strip() \
            not in ("", "0")
    loss_ok = torch.isfinite(loss.detach().float()).all()
    gs: List[torch.Tensor] = [g for g in grads if g is not None]
    if gs:
        sq = torch.stack([g.float().square().sum() for g in gs]).sum()
        grad_ok = torch.isfinite(sq)
        gnorm = torch.sqrt(torch.where(grad_ok, sq, torch.zeros_like(sq)))
    else:
        grad_ok = torch.ones((), dtype=torch.bool, device=loss.device)
        gnorm = torch.zeros((), device=loss.device)
    bits = (~loss_ok).int() * HEALTH_LOSS + (~grad_ok).int() * HEALTH_GRAD
    if check_params and new_params:
        p_ok = torch.stack([torch.isfinite(p).all() for p in new_params
                            if p.is_floating_point()]).all()
        bits = bits + (~p_ok).int() * HEALTH_PARAM
    return bits == 0, bits.float(), gnorm


def mask_step(ok: torch.Tensor, new: Sequence[torch.Tensor],
              old: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``where(ok, new, old)`` element by element: the skip no-op, bitwise
    the old values when ``ok`` is False and the new ones when it is
    True."""
    return [torch.where(ok, n, o) for n, o in zip(new, old)]
