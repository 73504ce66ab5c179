"""Observability of the port: the telemetry bus (``bus``), the
``step_metrics`` rows on the guard's read cadence and the serving
engine's ``decode_metrics`` rows (``metrics``), the recompile ledger
(``ledger``), model-FLOPs utilization (``mfu``) and the stream cursor the
router's mailbox hosts read (``monitor.StreamCursor``). The bus and the
monitor import the standard library only. The trace window lives in
``paddle_tpu_torch.profiler``."""
from __future__ import annotations

from . import bus, ledger, metrics, mfu, monitor
from .bus import current_step, emit, emit_span, read_stream, set_step
from .metrics import (DecodeMetricsSampler, StepMetricsSampler,
                      decode_metrics_enabled, step_metrics_enabled)
from .monitor import StreamCursor

__all__ = [
    "bus", "metrics", "ledger", "mfu", "monitor",
    "emit", "emit_span", "set_step", "current_step", "read_stream",
    "DecodeMetricsSampler", "decode_metrics_enabled", "StepMetricsSampler",
    "step_metrics_enabled", "StreamCursor",
]
