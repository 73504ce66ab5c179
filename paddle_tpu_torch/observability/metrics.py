"""Step and serving telemetry on the cadences the program already reads
the device at (counterpart of ``paddle_tpu/observability/metrics.py``).

Training: ``StepMetricsSampler`` rides the numerical guard
(``utils/train_guard.py``), which copies its state vector to the host
every ``PADDLE_GUARD_SYNC_EVERY`` steps, one interval late. When that
copy is read, the sampler builds one ``step_metrics`` row from

- the guard's floats, already on the host (last loss, the loss and
  grad-norm EWMAs, skip and spike totals);
- the host clock between reads (steps in the window, ms per step);
- examples and tokens per step from the inputs' shapes (host ints);
- the caching allocator's counters (:func:`device_memory`, a host query
  of ``torch.cuda.memory_stats``; None on the CPU);
- the step's static grad-comm record (``grad_comm``), and, only when a
  quantized-compute policy is armed, the static ``q_matmul`` and
  ``moment_bytes`` records (:meth:`StepMetricsSampler.set_quant_bytes`).

It adds no device read of its own. ``PADDLE_OBS_STEP_METRICS=0`` turns
the rows off; with the guard off (``PADDLE_GUARD_MODE=off``) there is no
read to ride and no row.

Serving: the continuous-batching engine reads one stacked token block
and the done mask back to the host every ``PADDLE_SERVE_SYNC_EVERY``
decode steps; ``DecodeMetricsSampler`` builds its rows from exactly
those host values and the host's wall clock, so turning them on changes
the engine's device-to-host reads by zero.

Rows:
  ``step_metrics``    one per guard read (:class:`StepMetricsSampler`);
  ``decode_metrics``  one per readback window: decode steps, emitted
    tokens, tokens/s over the window's wall clock, inflight slots, queue
    depth; the TTFT of the requests that reached their first token in the
    window; the paged pool's gauges (blocks in use and total, freed,
    deferred admissions); the prefix cache's and the adapter fleet's
    counters, each only when its feature is on;
  ``decode_request``  one per finished request: tokens, latency, prefill
    share, TTFT, ms per token;
  ``span``            a traced request's engine phases (:meth:`span`) and
    one ``decode_window`` row per window naming every traced inflight
    request (:meth:`window_span`).

``PADDLE_OBS_DECODE_METRICS=0`` turns the serving rows off.
"""
from __future__ import annotations

import os
import time
from typing import Optional

from . import bus

__all__ = ["StepMetricsSampler", "step_metrics_enabled", "device_memory",
           "DecodeMetricsSampler", "decode_metrics_enabled"]

_ENABLE_ENV = "PADDLE_OBS_STEP_METRICS"
_DECODE_ENABLE_ENV = "PADDLE_OBS_DECODE_METRICS"


def step_metrics_enabled() -> bool:
    v = os.environ.get(_ENABLE_ENV, "1").strip().lower()
    return v not in ("0", "false", "off")


def device_memory() -> Optional[dict]:
    """The caching allocator's counters of the current card
    (``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit``, the JAX
    package's keys), or None without an initialized card. A host query of
    the allocator's bookkeeping: no launch, no device sync."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        stats = torch.cuda.memory_stats()
        limit = torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
    except Exception:  # noqa: BLE001 -- metrics stay best-effort
        return None
    if not stats:
        return None
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(limit)}


class StepMetricsSampler:
    """Owned by a ``TrainGuard``: :meth:`tick` per step (integer adds on
    the inputs' shapes), :meth:`sample` once per guard read, with the
    guard's state already on the host."""

    def __init__(self):
        self.enabled = step_metrics_enabled()
        self._t_last: Optional[float] = None
        self._step_last = 0
        self._examples = 0
        self._tokens = 0
        self._grad_comm: Optional[dict] = None
        self._q_matmul: Optional[dict] = None
        self._moment_bytes: Optional[dict] = None

    def set_grad_comm(self, info: Optional[dict]) -> None:
        """The step's static grad-comm record (dtype and bytes of one
        gradient reduction, from the parameters' shapes), carried by every
        row."""
        self._grad_comm = dict(info) if info else None

    def set_quant_bytes(self, q_matmul: Optional[dict],
                        moment_bytes: Optional[dict]) -> None:
        """The static quantized-compute records (resident matmul-weight
        bytes under the QAT policy, Adam-moment bytes under
        ``quantized_moments``), carried by every row only when armed
        (``reduction_x`` other than 1): a row with every policy off keeps
        its keys."""
        def armed(info):
            return dict(info) if info and info.get(
                "reduction_x", 1.0) != 1.0 else None

        self._q_matmul = armed(q_matmul)
        self._moment_bytes = armed(moment_bytes)

    def tick(self, inputs) -> None:
        """Per-step accounting from the inputs' shapes (host ints)."""
        if not self.enabled:
            return
        x = inputs[0] if inputs else None
        shape = getattr(x, "shape", None)
        if not shape:
            return
        n = int(shape[0])
        self._examples += n
        if len(shape) >= 2:
            self._tokens += n * int(shape[1])

    def sample(self, step: int, guard_last) -> None:
        """One ``step_metrics`` row for the window ending at ``step``
        (``guard_last``: the guard's newest state vector as floats)."""
        if not self.enabled or not bus.enabled():
            return
        now = time.perf_counter()
        t0, s0 = self._t_last, self._step_last
        self._t_last, self._step_last = now, step
        examples, tokens = self._examples, self._tokens
        self._examples = self._tokens = 0
        if t0 is None or step <= s0:
            return  # the first window has no baseline
        dt = now - t0
        nsteps = step - s0
        payload = {
            "steps": nsteps,
            "step_ms": round(dt / nsteps * 1e3, 3),
            "loss": float(guard_last[7]),
            "loss_ewma": float(guard_last[3]),
            "gnorm": float(guard_last[4]),
            "gnorm_ewma": float(guard_last[8]),
            "consec_bad": int(guard_last[0]),
            "total_skips": int(guard_last[1]),
            "total_spikes": int(guard_last[2]),
        }
        if dt > 0:
            if examples:
                payload["examples_per_sec"] = round(examples / dt, 2)
            if tokens:
                payload["tokens_per_sec"] = round(tokens / dt, 1)
        if self._grad_comm:
            payload["grad_comm"] = self._grad_comm
        if self._q_matmul:
            payload["q_matmul"] = self._q_matmul
        if self._moment_bytes:
            payload["moment_bytes"] = self._moment_bytes
        mem = device_memory()
        if mem:
            payload["device_memory"] = mem
        bus.emit("step_metrics", payload, step=step)


def decode_metrics_enabled() -> bool:
    v = os.environ.get(_DECODE_ENABLE_ENV, "1").strip().lower()
    return v not in ("0", "false", "off")


class DecodeMetricsSampler:
    """The engine's rows, on its readback cadence (see the module
    docstring). Each method returns at once when the rows are off or the
    bus has no destination."""

    def __init__(self):
        self.enabled = decode_metrics_enabled()
        self._windows = 0

    def window(self, *, steps: int, tokens: int, wall_s: float,
               inflight: int, queue_depth: int, ttft_ms=None,
               blocks_in_use=None, blocks_total=None, blocks_freed=None,
               admit_deferred=None, prefix_hits=None,
               prefix_blocks_shared=None, cow_copies=None,
               adapters_resident=None) -> None:
        if not self.enabled or not bus.enabled():
            return
        self._windows += 1
        payload = {
            "steps": int(steps),
            "tokens": int(tokens),
            "inflight_slots": int(inflight),
            "queue_depth": int(queue_depth),
        }
        if wall_s > 0:
            payload["tokens_per_sec"] = round(tokens / wall_s, 1)
            payload["step_ms"] = round(wall_s / max(steps, 1) * 1e3, 3)
        if ttft_ms:  # requests that reached their first token this window
            payload["ttft_ms"] = round(max(ttft_ms), 3)
            payload["ttft_ms_mean"] = round(
                sum(ttft_ms) / len(ttft_ms), 3)
        if blocks_total:  # the paged pool's gauges
            payload["blocks_in_use"] = int(blocks_in_use or 0)
            payload["blocks_total"] = int(blocks_total)
            payload["block_occupancy"] = round(
                (blocks_in_use or 0) / blocks_total, 4)
            payload["blocks_freed"] = int(blocks_freed or 0)
        if admit_deferred:
            payload["admit_deferred"] = int(admit_deferred)
        # cumulative counters; None = the feature is off and the key is
        # left out
        if prefix_hits is not None:
            payload["prefix_hits"] = int(prefix_hits)
            payload["prefix_blocks_shared"] = int(
                prefix_blocks_shared or 0)
            payload["cow_copies"] = int(cow_copies or 0)
        if adapters_resident is not None:
            payload["adapters_resident"] = int(adapters_resident)
        bus.emit("decode_metrics", payload, step=self._windows)

    def request_done(self, *, rid, tokens: int, latency_ms: float,
                     prefill_ms: float, ttft_ms=None,
                     trace_id=None) -> None:
        if not self.enabled or not bus.enabled():
            return
        payload = {
            "rid": rid,
            "tokens": int(tokens),
            "latency_ms": round(latency_ms, 3),
            "prefill_ms": round(prefill_ms, 3),
            "ms_per_token": round(latency_ms / max(tokens, 1), 3),
        }
        if ttft_ms is not None:
            payload["ttft_ms"] = round(ttft_ms, 3)
        if trace_id is not None:
            payload["trace_id"] = trace_id
        bus.emit("decode_request", payload, step=self._windows)

    def span(self, name: str, *, trace_id, rid=None, **extra) -> None:
        """One engine-phase span row of a traced request (admission,
        prefill, prefill_chunk, retire, cancel, kv_extract, kv_insert,
        kv_relocate, prefix_hit), from values the engine holds on the
        host. No row for an untraced request (``trace_id`` None)."""
        if not self.enabled or not bus.enabled() or trace_id is None:
            return
        payload = dict(extra)
        if rid is not None:
            payload["rid"] = rid
        bus.emit_span(name, trace_id, payload, step=self._windows)

    def window_span(self, trace_ids, *, steps: int) -> None:
        """One ``decode_window`` row per readback window naming every
        traced inflight request: rows follow windows, not tokens."""
        if not self.enabled or not bus.enabled():
            return
        ids = [t for t in trace_ids if t is not None]
        if not ids:
            return
        bus.emit("span", {"name": "decode_window", "trace_ids": ids,
                          "steps": int(steps)}, step=self._windows)
