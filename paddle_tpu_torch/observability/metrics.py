"""Serving telemetry on the engine's readback cadence (counterpart of
``paddle_tpu/observability/metrics.py``'s ``DecodeMetricsSampler``).

The continuous-batching engine reads one stacked token block and the done
mask back to the host every ``PADDLE_SERVE_SYNC_EVERY`` decode steps. The
sampler builds its rows from exactly those host values and the host's
wall clock: nothing here reads a tensor, so turning the rows on changes
the engine's device-to-host reads by zero.

Rows:
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

``PADDLE_OBS_DECODE_METRICS=0`` turns the rows off. The training half of
this module (``StepMetricsSampler``) is ROADMAP queue A item 8.
"""
from __future__ import annotations

import os

from . import bus

__all__ = ["DecodeMetricsSampler", "decode_metrics_enabled"]

_DECODE_ENABLE_ENV = "PADDLE_OBS_DECODE_METRICS"


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
