"""Observability of the port: the telemetry bus (``bus``), the serving
engine's ``decode_metrics`` rows (``metrics``) and the stream cursor the
router's mailbox hosts read (``monitor.StreamCursor``). The bus and the
monitor import the standard library only."""
from __future__ import annotations

from . import bus, metrics, monitor
from .bus import current_step, emit, emit_span, read_stream, set_step
from .metrics import DecodeMetricsSampler, decode_metrics_enabled
from .monitor import StreamCursor

__all__ = [
    "bus", "metrics", "monitor",
    "emit", "emit_span", "set_step", "current_step", "read_stream",
    "DecodeMetricsSampler", "decode_metrics_enabled", "StreamCursor",
]
