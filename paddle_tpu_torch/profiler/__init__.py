"""Profiling and tracing (counterpart of ``paddle_tpu/profiler``;
reference: paddle/fluid/platform/profiler.h ``RecordEvent`` (:127),
``EnableProfiler``/``DisableProfiler`` (:210, :213), fluid/profiler.py).

- :class:`RecordEvent` pairs a host timing registry (``event_summary``:
  calls, total, mean, max and min ms per name) with
  ``torch.profiler.record_function``, so an event shows in the summary
  and on the trace's timeline. Off, it costs one flag check.
- :func:`start_profiler` / :func:`stop_profiler` (and the
  :func:`profiler` context manager) run ``torch.profiler.profile`` over
  the CPU and, when the state asks for it and there is one, the card.
  ``stop_profiler`` writes the Chrome trace (``chrome://tracing``,
  Perfetto) to ``profile_path`` and to ``<trace_dir>/trace.json``, and
  returns the event summary. (The JAX package writes the summary as JSON
  to ``profile_path`` and an XPlane trace to ``trace_dir``; upstream
  Paddle writes its timeline to ``profile_path``, which the Chrome trace
  stands for here.)
- :func:`device_annotation` names a region of the step on the trace
  (``TrainStep::opt_update``, ``TrainStep::guard``): a
  ``record_function`` while a profiler records, nothing otherwise.
- The capture-on-anomaly window: a guard trip (:func:`arm_trace`) or
  ``PADDLE_OBS_TRACE_AT_STEP=N`` arms a trace of the next
  ``PADDLE_OBS_TRACE_STEPS`` steps (default 3) into
  ``PADDLE_OBS_TRACE_DIR`` (default ``$PADDLE_OBS_DIR/traces``), at most
  ``PADDLE_OBS_TRACE_MAX`` windows a process (default 1). The step objects
  call :func:`step_boundary` before each step; disarmed, that is one
  ``is None`` check. A captured window is
  ``<dir>/step<N>.rank<R>.<reason>/trace.json``, announced by a
  ``trace_captured`` bus row.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "RecordEvent", "record_event", "start_profiler", "stop_profiler",
    "profiler", "is_profiling", "event_summary", "reset_profiler",
    "device_annotation", "arm_trace", "disarm_trace", "step_boundary",
    "trace_window_state",
]

_enabled = False          # host event recording on?
_profile = None           # the torch profiler of start_profiler
_trace_dir: Optional[str] = None


class _Registry(threading.local):
    def __init__(self):
        self.events: Dict[str, List[float]] = {}


_reg = _Registry()


def is_profiling() -> bool:
    return _enabled


def _recording() -> bool:
    """Is a torch profiler recording (ours or the caller's)?"""
    import torch

    return torch.autograd._profiler_enabled()


class RecordEvent:
    """RAII event annotation (profiler.h:127): a context manager or a
    decorator; nests; one flag check when profiling is off."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        self._ann = None

    def __enter__(self):
        if _enabled:
            import torch

            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            _reg.events.setdefault(self.name, []).append(dt)
            self._ann.__exit__(*exc)
            self._t0 = None
        return False

    def __call__(self, fn):
        def wrapped(*a, **kw):
            with RecordEvent(self.name):
                return fn(*a, **kw)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


record_event = RecordEvent


def _activities(state: str):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if state.upper() != "CPU" and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_profiler(state: str = "All", tracer_option: str = "Default",
                   trace_dir: Optional[str] = None):
    """EnableProfiler (profiler.h:210): host events on, and a
    ``torch.profiler`` run over the CPU and (``state`` "GPU" or
    "All") the card."""
    global _enabled, _profile, _trace_dir
    import torch

    _enabled = True
    _reg.events = {}
    _profile = torch.profiler.profile(activities=_activities(state))
    _profile.__enter__()
    _trace_dir = trace_dir


def stop_profiler(sorted_key: str = "total",
                  profile_path: Optional[str] = None):
    """DisableProfiler: stops recording, writes the Chrome trace to
    ``profile_path`` and to ``<trace_dir>/trace.json`` when they are
    given, and returns the event summary."""
    global _enabled, _profile, _trace_dir
    _enabled = False
    prof, _profile = _profile, None
    trace_dir, _trace_dir = _trace_dir, None
    if prof is not None:
        prof.__exit__(None, None, None)
        paths = [profile_path] if profile_path else []
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            paths.append(os.path.join(trace_dir, "trace.json"))
        for p in paths:
            prof.export_chrome_trace(p)
    return event_summary(sorted_key)


def event_summary(sorted_key: str = "total") -> Dict[str, Dict[str, float]]:
    """The aggregated event table: name -> {calls, total_ms, avg_ms,
    max_ms, min_ms}, sorted by ``sorted_key`` (total, calls, max, min,
    ave), largest first."""
    out = {}
    for name, times in _reg.events.items():
        total = sum(times)
        out[name] = {
            "calls": len(times),
            "total_ms": total * 1e3,
            "avg_ms": total / len(times) * 1e3,
            "max_ms": max(times) * 1e3,
            "min_ms": min(times) * 1e3,
        }
    key = {"total": "total_ms", "calls": "calls", "max": "max_ms",
           "min": "min_ms", "ave": "avg_ms"}.get(sorted_key, "total_ms")
    return dict(sorted(out.items(), key=lambda kv: -kv[1][key]))


def reset_profiler():
    _reg.events = {}


@contextlib.contextmanager
def profiler(state: str = "All", tracer_option: str = "Default",
             trace_dir: Optional[str] = None,
             profile_path: Optional[str] = None):
    """fluid/profiler.py's context manager."""
    start_profiler(state, tracer_option, trace_dir)
    try:
        yield
    finally:
        stop_profiler(profile_path=profile_path)


def device_annotation(name: str):
    """Name a region of the step on the trace: ``record_function(name)``
    while a torch profiler records, a null context otherwise (so the step
    pays nothing for its names outside a trace)."""
    try:
        if _recording():
            import torch

            return torch.profiler.record_function(name)
    except Exception:  # noqa: BLE001 -- an annotation never breaks math
        pass
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# the capture-on-anomaly trace window
# ---------------------------------------------------------------------------

_TRACE_AT_ENV = "PADDLE_OBS_TRACE_AT_STEP"
_TRACE_STEPS_ENV = "PADDLE_OBS_TRACE_STEPS"
_TRACE_DIR_ENV = "PADDLE_OBS_TRACE_DIR"
_TRACE_MAX_ENV = "PADDLE_OBS_TRACE_MAX"

_window_lock = threading.Lock()
_window = None          # {"remaining", "dir", "reason", "active", ...}
_windows_taken = 0
_env_arm_at = "unparsed"   # PADDLE_OBS_TRACE_AT_STEP, parsed once


def _reset_trace_state() -> None:
    """Tests: disarm and forget the per-process window budget."""
    global _windows_taken, _env_arm_at
    disarm_trace()
    _windows_taken = 0
    _env_arm_at = "unparsed"


def _trace_dest() -> Optional[str]:
    d = os.environ.get(_TRACE_DIR_ENV)
    if d:
        return d
    obs = os.environ.get("PADDLE_OBS_DIR")
    return os.path.join(obs, "traces") if obs else None


def trace_window_state() -> Optional[dict]:
    """The armed or active window (None when disarmed), without its
    profiler object."""
    if not _window:
        return None
    return {k: v for k, v in _window.items() if k != "profile"}


def arm_trace(steps: Optional[int] = None, reason: str = "manual",
              trace_dir: Optional[str] = None) -> bool:
    """Arm a trace window over the next ``steps`` steps. Returns False
    (and stays disarmed) without a destination, while a window is armed
    or active, or once ``PADDLE_OBS_TRACE_MAX`` windows were taken."""
    global _window, _windows_taken
    dest = trace_dir or _trace_dest()
    if not dest:
        return False
    n = steps if steps is not None else int(
        os.environ.get(_TRACE_STEPS_ENV, "3") or 3)
    if n <= 0:
        return False
    budget = int(os.environ.get(_TRACE_MAX_ENV, "1") or 1)
    with _window_lock:
        if _window is not None or _windows_taken >= budget:
            return False
        _windows_taken += 1
        _window = {"remaining": int(n), "dir": dest, "reason": reason,
                   "active": False}
    from ..observability import bus as _bus

    _bus.emit("trace_armed", {"reason": reason, "steps": int(n),
                              "dir": dest})
    return True


def _stop(w) -> None:
    """Stop a window's profiler and write its ``trace.json``."""
    prof = w.pop("profile")
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(w["dest"], "trace.json"))


def disarm_trace() -> None:
    """Cancel an armed window, or stop an active one (its trace is
    written)."""
    global _window
    with _window_lock:
        w, _window = _window, None
    if w and w["active"]:
        try:
            _stop(w)
        except Exception:  # noqa: BLE001
            pass


def step_boundary(step: int) -> None:
    """Per-step hook of the step objects, called before the step's work:
    open the armed window, count it down, close it. The window covers
    exactly ``steps`` steps: the first call after arming starts the
    profiler, and the first call past the window stops it, before that
    step's work joins it. One ``is None`` check when disarmed."""
    global _window, _windows_taken
    if _window is None:
        _maybe_env_arm(step)
        if _window is None:
            return
    with _window_lock:
        w = _window
        if w is None:
            return
        if w["active"] and w["remaining"] <= 0:
            _window = None          # spent: close before this step
            done = True
        else:
            done = False
            if not w["active"]:
                rank = os.environ.get("PADDLE_TRAINER_ID", "0")
                dest = os.path.join(
                    w["dir"], f"step{step}.rank{rank}.{w['reason']}")
                try:
                    import torch

                    os.makedirs(dest, exist_ok=True)
                    prof = torch.profiler.profile(
                        activities=_activities("All"))
                    prof.__enter__()
                except Exception:  # noqa: BLE001 -- tracing best-effort
                    # a failed start does not spend the budget
                    _window = None
                    _windows_taken = max(_windows_taken - 1, 0)
                    return
                w["active"] = True
                w["dest"] = dest
                w["profile"] = prof
                w["start_step"] = step
            w["remaining"] -= 1
            w["last_step"] = step
    if done:
        try:
            _stop(w)
        except Exception:  # noqa: BLE001
            return
        from ..observability import bus as _bus

        _bus.emit("trace_captured", {
            "reason": w["reason"], "dir": w["dest"],
            "first_step": w["start_step"], "last_step": w["last_step"],
        }, step=step)


def _maybe_env_arm(step: int) -> None:
    """``PADDLE_OBS_TRACE_AT_STEP=N`` arms the window as step N begins
    (so the capture covers step N on). Parsed once a process."""
    global _env_arm_at
    if _env_arm_at == "unparsed":
        raw = os.environ.get(_TRACE_AT_ENV, "").strip()
        try:
            _env_arm_at = int(raw) if raw else None
        except ValueError:
            _env_arm_at = None
    if _env_arm_at is None:
        return
    if step >= _env_arm_at:
        _env_arm_at = None
        arm_trace(reason=f"at_step_{step}")
