"""The numerical guard of the training step (counterpart of
``paddle_tpu/utils/train_guard.py``).

Two halves:

- **in the step** (:func:`grad_health`, :func:`update_guard_state`,
  used by ``jit.TrainStep``): each step computes a health word,
  ``isfinite(loss)`` and one fused norm over all gradients (a NaN or Inf
  anywhere propagates into it), optionally ``isfinite`` of the updated
  parameters (``PADDLE_GUARD_CHECK_PARAMS=1``), then folds it into a
  float32 state vector of :data:`GUARD_LEN` policy counters (consecutive
  bad steps, totals, the loss and grad-norm EWMAs, sticky health bits)
  with spike detection (``PADDLE_GUARD_SPIKE_FACTOR``). Its verdict
  ``ok_apply`` masks the update: a bad step leaves parameters, moments
  and buffers bitwise unchanged. All of it is torch ops on the device;
  nothing reads a value to the host.
- **on the host** (:class:`TrainGuard`): every ``PADDLE_GUARD_SYNC_EVERY``
  steps the step hands over its state vector; the guard starts a
  ``non_blocking`` copy of it into pinned host memory, records a CUDA
  event, and reads the copy started one interval earlier (waiting on its
  event, long done by then). The host never blocks on a step's own
  work. Skipped steps are no-ops, so the lag loses nothing. Past
  ``PADDLE_GUARD_MAX_SKIPS`` consecutive bad steps the guard rolls back
  to the last ``auto_checkpoint`` generation (the range registers itself
  with :func:`set_rescue_target`), raises :class:`GuardDivergenceError`
  without one, or, under ``PADDLE_GUARD_MODE=abort``, emits a
  ``guard_abort`` event and exits with :data:`GUARD_ABORT_RC`. On the
  first observed bad step it dumps a replay bundle (parameters, batch,
  generator state) to ``PADDLE_GUARD_DUMP_DIR``.

Knobs (the JAX package's)::

    PADDLE_GUARD_MODE          off | skip (default) | abort
    PADDLE_GUARD_MAX_SKIPS     consecutive bad steps before rescue (8)
    PADDLE_GUARD_SYNC_EVERY    host observation interval, steps (4)
    PADDLE_GUARD_CHECK_PARAMS  1 = also isfinite-check updated params
    PADDLE_GUARD_SPIKE_FACTOR  loss > factor * EWMA counts as divergence
                               (0 = spike detection off)
    PADDLE_GUARD_EWMA          loss EWMA decay (0.9)
    PADDLE_GUARD_SPIKE_WARMUP  healthy steps before spikes count (20)
    PADDLE_GUARD_EVENT_FILE    JSONL event stream (flat legacy rows)
    PADDLE_GUARD_DUMP_DIR      where replay bundles land (off when unset)
"""
from __future__ import annotations

import os
import sys
import time
import weakref
import zlib
from collections import deque
from typing import Dict, List, Optional, Sequence

import torch

__all__ = [
    "TrainGuard", "GuardDivergenceError", "GUARD_ABORT_RC", "GUARD_LEN",
    "guard_mode", "init_guard_state", "grad_health", "update_guard_state",
    "mask_step", "emit_event", "set_rescue_target", "divergence_active",
    "HEALTH_LOSS", "HEALTH_GRAD", "HEALTH_PARAM", "HEALTH_SPIKE",
    "HEALTH_GNORM",
]

_MODE_ENV = "PADDLE_GUARD_MODE"
_MAX_SKIPS_ENV = "PADDLE_GUARD_MAX_SKIPS"
_SYNC_ENV = "PADDLE_GUARD_SYNC_EVERY"
_CHECK_PARAMS_ENV = "PADDLE_GUARD_CHECK_PARAMS"
_SPIKE_ENV = "PADDLE_GUARD_SPIKE_FACTOR"
_EWMA_ENV = "PADDLE_GUARD_EWMA"
_WARMUP_ENV = "PADDLE_GUARD_SPIKE_WARMUP"
_EVENT_ENV = "PADDLE_GUARD_EVENT_FILE"
_DUMP_ENV = "PADDLE_GUARD_DUMP_DIR"

#: exit code of a guard abort (97 = collective timeout, 98 = launcher
#: watchdog verdict; 96 = the trainer's own numerical verdict)
GUARD_ABORT_RC = 96

#: guard-state vector layout (float32[GUARD_LEN], carried by the step):
#: 0 consec_bad  1 total_skips  2 total_spikes  3 loss_ewma
#: 4 last_gnorm  5 last_health_bits  6 healthy_steps  7 last_loss
#: 8 gnorm_ewma  9 reserved
GUARD_LEN = 10

#: health-word bits, as in the JAX package
HEALTH_LOSS = 1      # loss nonfinite
HEALTH_GRAD = 2      # some gradient nonfinite (via the fused norm)
HEALTH_PARAM = 4     # some updated parameter nonfinite
HEALTH_SPIKE = 8     # finite, but loss spiked past factor * EWMA
HEALTH_GNORM = 16    # finite, but grad norm spiked past factor * EWMA


class GuardDivergenceError(RuntimeError):
    """Raised in ``skip`` mode when the consecutive-bad-step budget is
    spent and no auto_checkpoint range is registered to roll back to."""


def guard_mode() -> str:
    mode = os.environ.get(_MODE_ENV, "skip").strip().lower() or "skip"
    if mode not in ("off", "skip", "abort"):
        raise ValueError(f"{_MODE_ENV}={mode!r}: want one of off|skip|abort")
    return mode


def _envi(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.strip() else default


def _envf(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    return float(raw) if raw.strip() else default


# ---------------------------------------------------------------------------
# the in-step half
# ---------------------------------------------------------------------------


def init_guard_state(device=None) -> torch.Tensor:
    """A fresh guard-state vector (all zeros) on ``device``."""
    return torch.zeros((GUARD_LEN,), dtype=torch.float32, device=device)


def grad_health(loss: torch.Tensor, grads: Sequence[Optional[torch.Tensor]],
                new_params: Optional[Sequence[torch.Tensor]] = None,
                check_params: Optional[bool] = None,
                square_sum: Optional[torch.Tensor] = None):
    """The sentinel: (ok, health_bits, gnorm), all 0-dim tensors on the
    device. ``gnorm`` is the global gradient norm in f32 (0 when it is not
    finite), from ``torch._foreach_norm`` (the JAX package sums the
    squares: the two agree to rounding); a gradient large enough to
    overflow f32 when its norm is squared reads as nonfinite, as in the
    JAX package. ``square_sum``, when given, is that squared norm as the
    caller already has it (a ``TrainStep`` under tensor parallelism: the
    full gradients', ``distributed.meta_parallel.global_square_sum``)."""
    if check_params is None:
        check_params = _envi(_CHECK_PARAMS_ENV, 0) != 0
    loss_ok = torch.isfinite(loss.detach().float()).all()
    gs: List[torch.Tensor] = [g for g in grads if g is not None]
    if square_sum is not None or gs:
        sq = square_sum
        if sq is None:
            # one fused pass over all gradients: the per-tensor norms in
            # f32 (a NaN or Inf anywhere propagates), squared and summed
            norms = torch._foreach_norm(gs, 2, dtype=torch.float32)
            sq = torch.stack(norms).square().sum()
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


def update_guard_state(state: torch.Tensor, ok: torch.Tensor,
                       bits: torch.Tensor, gnorm: torch.Tensor, loss):
    """The policy counters' update, on the device (torch ops only, no
    host read). Returns ``(new_state, ok_apply)``; the caller masks the
    update with ``ok_apply``.

    With ``PADDLE_GUARD_SPIKE_FACTOR`` > 0, after
    ``PADDLE_GUARD_SPIKE_WARMUP`` healthy steps seeded the EWMAs:

    - a finite grad norm above ``factor * gnorm_EWMA`` is masked like a
      nonfinite step (the grad norm reveals an exploding update before
      it applies);
    - a finite loss above ``factor * loss_EWMA`` still applies (it trails
      the update that caused it) but counts against the same
      consecutive-bad budget.
    """
    factor = _envf(_SPIKE_ENV, 0.0)
    decay = _envf(_EWMA_ENV, 0.9)
    warmup = _envi(_WARMUP_ENV, 20)
    (consec, t_skip, t_spike, ewma, _, prev_bits, healthy, _,
     g_ewma, spare) = state.unbind()
    loss32 = torch.as_tensor(loss).detach().to(
        device=state.device, dtype=torch.float32).reshape(())
    false = torch.zeros((), dtype=torch.bool, device=state.device)
    if factor > 0.0:
        warmed = healthy >= warmup
        # the > 0 checks keep an unseeded EWMA (a fresh start, or a state
        # restored without one) from flagging every step
        spike = ok & warmed & (ewma.abs() > 0.0) \
            & (loss32 > factor * ewma.abs())
        g_spike = ok & warmed & (g_ewma > 0.0) & (gnorm > factor * g_ewma)
    else:
        spike = g_spike = false
    ok_apply = ok & ~g_spike
    bad = (~ok_apply) | spike
    zero = torch.zeros_like(consec)
    one = torch.ones_like(consec)
    consec = torch.where(bad, consec + 1, zero)
    t_skip = t_skip + torch.where(ok_apply, zero, one)
    t_spike = t_spike + torch.where(spike, one, zero)
    good = ok_apply & ~spike
    seeded = healthy > 0
    ewma = torch.where(good, torch.where(
        seeded, decay * ewma + (1.0 - decay) * loss32, loss32), ewma)
    g_ewma = torch.where(good, torch.where(
        seeded, decay * g_ewma + (1.0 - decay) * gnorm, gnorm), g_ewma)
    healthy = healthy + torch.where(good, one, zero)
    bits = (bits + torch.where(spike, one * HEALTH_SPIKE, zero)
            + torch.where(g_spike, one * HEALTH_GNORM, zero))
    # sticky-bad: the slot names the most recent unhealthy step's word, so
    # a lazy observer still sees what tripped
    bits = torch.where(bad, bits, prev_bits)
    last_loss = torch.where(torch.isfinite(loss32), loss32, -one)
    new_state = torch.stack([consec, t_skip, t_spike, ewma,
                             gnorm.float().reshape(()), bits, healthy,
                             last_loss, g_ewma, spare])
    return new_state, ok_apply


def mask_step(ok: torch.Tensor, new: Sequence[torch.Tensor],
              old: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``where(ok, new, old)`` element by element: the skip no-op, bitwise
    the old values when ``ok`` is False and the new ones when it is
    True."""
    return [torch.where(ok, n, o) for n, o in zip(new, old)]


# ---------------------------------------------------------------------------
# events, the rescue target
# ---------------------------------------------------------------------------


def emit_event(kind: str, **fields) -> None:
    """One guard event on the telemetry bus, and its flat legacy row on
    ``PADDLE_GUARD_EVENT_FILE`` when that is set."""
    from ..observability import bus as _bus

    _bus.emit(kind, fields, step=fields.get("step"), legacy_env=_EVENT_ENV)


_rescue_ref = None
_active_guards: "weakref.WeakSet" = weakref.WeakSet()


def set_rescue_target(target) -> None:
    """Register the ``TrainEpochRange`` whose last good generation a
    rollback restores (held weakly; None clears it)."""
    global _rescue_ref
    _rescue_ref = None if target is None else weakref.ref(target)


def _rescue_target():
    return _rescue_ref() if _rescue_ref is not None else None


def divergence_active() -> bool:
    """Is a live guard inside a bad-step streak? ``auto_checkpoint`` asks
    before each snapshot, so a diverging epoch is never committed as the
    generation a rollback restores. Only guards that stepped since the
    last call are asked; each reads its pending state (one wait on its
    copy's event) without running its policy. Called at epoch
    boundaries, not per step."""
    streak = False
    for g in list(_active_guards):
        if g.closed or not g._stepped_since_check:
            continue
        g._stepped_since_check = False
        g._sync_pending()
        if g._last[0] > 0:
            streak = True
    return streak


# ---------------------------------------------------------------------------
# the host monitor
# ---------------------------------------------------------------------------


def _prefetch(state: torch.Tensor):
    """Start the copy of a state vector to the host: ``(host, event)``.
    On the card a ``non_blocking`` copy into pinned memory and an event
    recorded after it; on the CPU the tensor itself (the step makes a new
    one each call)."""
    if not state.is_cuda:
        return state, None
    host = torch.empty(state.shape, dtype=state.dtype, pin_memory=True)
    host.copy_(state, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(state.device))
    return host, event


def _read(pending) -> List[float]:
    host, event = pending
    if event is not None:
        event.synchronize()   # the copy was queued an interval ago
    return [float(v) for v in host.tolist()]


class _StepRecord:
    __slots__ = ("step", "rng_state", "inputs", "labels")

    def __init__(self, step, rng_state, inputs, labels):
        self.step = step
        self.rng_state = rng_state
        self.inputs = inputs
        self.labels = labels


class TrainGuard:
    """The host monitor of one step object.

    The step calls :meth:`capture` before its work (ring-buffers the
    generator state and the batch, for a replay bundle) and
    :meth:`observe` after, with its new state vector. ``observe`` reads a
    state only every ``sync_every`` steps, one interval late, and returns
    ``"rollback"`` after it restored a checkpoint (the owner's
    ``_on_rollback`` hook has then refreshed its device state).
    """

    def __init__(self, mode: Optional[str] = None,
                 max_skips: Optional[int] = None,
                 sync_every: Optional[int] = None, model=None):
        self.mode = mode or guard_mode()
        self.max_skips = (max_skips if max_skips is not None
                          else _envi(_MAX_SKIPS_ENV, 8))
        self.sync_every = max(
            sync_every if sync_every is not None else _envi(_SYNC_ENV, 4),
            1)
        self._model_ref = weakref.ref(model) if model is not None else None
        # the step-metrics rows ride this guard's reads (no read of their
        # own)
        from ..observability.metrics import StepMetricsSampler

        self._sampler = StepMetricsSampler()
        self._step = 0
        self._ring: deque = deque(maxlen=2 * self.sync_every + 4)
        self._pending = None     # (step, (host, event)) of the last copy
        self._last = [0.0] * GUARD_LEN   # the newest state read
        self._last_step = -1
        self._reported_bad = 0.0  # total_skips + spikes already evented
        self._just_restored = False
        self._stepped_since_check = False
        self.closed = False       # set when this guard gave its verdict
        self.rollbacks = 0
        self.dumped: List[str] = []
        #: called right after a rollback restored the checkpoint: the step
        #: refreshes its device state vector there
        self._on_rollback = None
        _active_guards.add(self)

    # -- persistence (an auto_checkpoint extra, through TrainStep) --------
    def state_dict(self) -> Dict:
        return {
            "total_skips": float(self._last[1]),
            "total_spikes": float(self._last[2]),
            "loss_ewma": float(self._last[3]),
            "healthy_steps": float(self._last[6]),
            "gnorm_ewma": float(self._last[8]),
            "rollbacks": int(self.rollbacks),
        }

    def set_state_dict(self, state: Dict) -> None:
        self._last = [0.0] * GUARD_LEN
        self._last[1] = float(state.get("total_skips", 0.0))
        self._last[2] = float(state.get("total_spikes", 0.0))
        self._last[3] = float(state.get("loss_ewma", 0.0))
        self._last[6] = float(state.get("healthy_steps", 0.0))
        self._last[8] = float(state.get("gnorm_ewma", 0.0))
        self.rollbacks = int(state.get("rollbacks", 0))
        self._reported_bad = self._last[1] + self._last[2]
        self._pending = None
        self._just_restored = True

    def restored_device_state(self, device=None) -> torch.Tensor:
        """The state vector seeded from the restored counters: the streak
        resets (a rescue forgives it); totals and the EWMA baselines carry
        over."""
        return torch.tensor(
            [0.0, self._last[1], self._last[2], self._last[3], 0.0, 0.0,
             self._last[6], 0.0, self._last[8], 0.0],
            dtype=torch.float32, device=device)

    # -- per-step hooks ----------------------------------------------------
    def capture(self, inputs, labels, rng_state=None) -> None:
        """Count the step; with ``PADDLE_GUARD_DUMP_DIR`` set, ring-buffer
        its generator state and batch (references, nothing copied until a
        bundle is dumped)."""
        self._step += 1
        self._sampler.tick(inputs)   # host ints off the shapes
        if os.environ.get(_DUMP_ENV):
            self._ring.append(_StepRecord(
                self._step, rng_state() if callable(rng_state)
                else rng_state, tuple(inputs), tuple(labels)))

    def observe(self, guard_state: torch.Tensor) -> Optional[str]:
        """Hand over the step's new state vector. Returns None, or
        ``"rollback"`` (a checkpoint was restored); raises or exits by
        mode once the budget is spent."""
        self._stepped_since_check = True
        if self._step % self.sync_every != 0:
            return None
        prev = self._pending
        self._pending = (self._step, _prefetch(guard_state))
        if prev is None:
            return None
        step, copy = prev
        self._last = _read(copy)
        self._last_step = step
        # the read just landed: the metrics row reuses its floats
        self._sampler.sample(step, self._last)
        return self._policy(step)

    def _sync_pending(self) -> None:
        """Read the pending state (no policy)."""
        if self._pending is None:
            return
        step, copy = self._pending
        self._pending = None
        self._last = _read(copy)
        self._last_step = step

    def flush(self) -> Optional[str]:
        """Read and judge the newest handed-over state now (tests, the
        end of a run; :meth:`observe` is the path that never waits)."""
        if self._pending is None:
            return None
        self._sync_pending()
        return self._policy(self._last_step)

    # -- policy ------------------------------------------------------------
    def _policy(self, step: int) -> Optional[str]:
        consec = self._last[0]
        total_bad = self._last[1] + self._last[2]
        if total_bad - self._reported_bad > 0:
            self._reported_bad = total_bad
            bundle = self._dump_bundle(step)
            emit_event(
                "guard_skip", step=step, consec=int(consec),
                total_skips=int(self._last[1]),
                total_spikes=int(self._last[2]),
                health_bits=int(self._last[5]), gnorm=self._last[4],
                loss=self._last[7], loss_ewma=self._last[3],
                bundle=bundle, detail=self._describe(step))
            print(f"paddle_tpu_torch.train_guard: {self._describe(step)}",
                  file=sys.stderr, flush=True)
            # the first observed bad step arms a bounded trace window over
            # the next steps (a no-op without a trace destination)
            if os.environ.get("PADDLE_OBS_TRACE_ON_TRIP", "1").strip() \
                    .lower() not in ("0", "false", "off"):
                from .. import profiler as _prof

                _prof.arm_trace(reason="guard_trip")
        if consec < self.max_skips:
            return None
        detail = (f"divergence: {int(consec)} consecutive bad steps "
                  f"(budget {self.max_skips}) at step ~{step}; "
                  + self._describe(step))
        if self.mode == "abort":
            emit_event("guard_abort", step=step, consec=int(consec),
                       health_bits=int(self._last[5]), gnorm=self._last[4],
                       loss=self._last[7], detail=detail)
            print(f"paddle_tpu_torch.train_guard: {detail}; aborting "
                  f"rc={GUARD_ABORT_RC}", file=sys.stderr, flush=True)
            os._exit(GUARD_ABORT_RC)
        target = _rescue_target()
        if target is None:
            self.closed = True   # verdict given: out of divergence_active
            raise GuardDivergenceError(
                detail + " — no auto_checkpoint range registered to roll "
                "back to (iterate TrainEpochRange, or set "
                "PADDLE_GUARD_MODE=abort to hand the rank to the elastic "
                "launcher)")
        self._just_restored = False
        restored = target.restore()
        self.rollbacks += 1
        if not self._just_restored:
            # the snapshot did not carry this guard: its totals stay the
            # reporting baseline
            self._reported_bad = self._last[1] + self._last[2]
        # states handed over before the restore must not trip it again
        self._pending = None
        self._last[0] = 0.0
        if self._on_rollback is not None:
            self._on_rollback()
        emit_event("guard_rollback", step=step, consec=int(consec),
                   restored_epoch=getattr(target, "_restored_epoch", None),
                   detail=detail)
        print(f"paddle_tpu_torch.train_guard: {detail}; restored last-good "
              f"snapshot (next epoch {restored})", file=sys.stderr,
              flush=True)
        return "rollback"

    def _describe(self, step: int) -> str:
        bits = int(self._last[5])
        what = [w for b, w in ((HEALTH_LOSS, "loss nonfinite"),
                               (HEALTH_GRAD, "grads nonfinite"),
                               (HEALTH_PARAM, "params nonfinite"),
                               (HEALTH_SPIKE, "loss spike"),
                               (HEALTH_GNORM, "grad-norm spike"))
                if bits & b] or ["healthy"]
        return (f"step ~{step}: {', '.join(what)} "
                f"(consec {int(self._last[0])}, gnorm {self._last[4]:.3g}, "
                f"loss {self._last[7]:.6g}, ewma {self._last[3]:.6g})")

    # -- replay bundle -----------------------------------------------------
    def _dump_bundle(self, step: int) -> Optional[str]:
        """Write the first bad step's replay bundle (best effort: the ring
        holds the last ~2 intervals; the oldest record at or after the
        first bad step serves, since skipped steps leave the parameters
        the replay needs untouched). The file is ``framework.io``'s format:
        ``step``, ``health_bits``, ``gnorm``, ``loss``, ``fingerprint``
        (CRC32 of the batch), ``key_data`` (the generator state as bytes),
        ``inputs``, ``labels`` and the model's ``state``, all numpy."""
        dump_dir = os.environ.get(_DUMP_ENV)
        if not dump_dir or not self._ring:
            return None
        consec = int(self._last[0])
        first_bad = max(self._last_step - consec + 1, 1) if consec \
            else self._last_step
        rec = next((r for r in self._ring if r.step >= first_bad),
                   self._ring[-1])
        model = self._model_ref() if self._model_ref is not None else None
        try:
            import numpy as np

            from ..core.tensor import _host, to_torch
            from ..framework import io as fio

            ins = [_host(to_torch(x)) for x in rec.inputs]
            labs = [_host(to_torch(y)) for y in rec.labels]
            fp = 0
            for a in ins + labs:
                fp = zlib.crc32(np.ascontiguousarray(a).tobytes(), fp)
            bundle = {
                "step": rec.step, "time": time.time(),
                "health_bits": int(self._last[5]),
                "gnorm": self._last[4], "loss": self._last[7],
                "fingerprint": fp & 0xFFFFFFFF,
                "key_data": None if rec.rng_state is None
                else _host(rec.rng_state),
                "inputs": ins, "labels": labs,
            }
            if model is not None:
                bundle["state"] = {k: _host(to_torch(v)) for k, v in
                                   model.state_dict().items()}
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(
                dump_dir,
                f"guard_step{rec.step:08d}.rank"
                f"{os.environ.get('PADDLE_TRAINER_ID', '0')}.pdbundle")
            fio.save(bundle, path)
            self.dumped.append(path)
            return path
        except Exception as e:  # noqa: BLE001 -- diagnostics stay best-effort
            print(f"paddle_tpu_torch.train_guard: bundle dump failed: {e}",
                  file=sys.stderr, flush=True)
            return None
