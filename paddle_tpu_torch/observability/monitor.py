"""The fleet monitor's stream cursor (counterpart of
``paddle_tpu/observability/monitor.py``'s ``StreamCursor``), which
``serving.router.FileHost`` reads a worker's telemetry through. The rest
of the monitor (straggler ranking, percentile digests, the incident
correlator) is ROADMAP queue A item 8.

Standard library only: the mailbox worker loads this file by path.
"""
from __future__ import annotations

import json
import os
from typing import List

__all__ = ["StreamCursor"]


class StreamCursor:
    """Tail one JSONL stream incrementally: only freshly appended complete
    lines are parsed (a torn trailing line waits for its newline), and a
    file that shrank below the cursor (truncated or rotated in place)
    restarts at byte 0."""

    __slots__ = ("path", "offset")

    def __init__(self, path: str):
        self.path = path
        self.offset = 0

    def poll(self) -> List[dict]:
        """Every complete row appended since the last poll."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self.offset:
            self.offset = 0  # truncated or rotated underneath us
        try:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                chunk = f.read()
        except OSError:
            return []
        end = chunk.rfind(b"\n")
        if end < 0:
            return []
        self.offset += end + 1
        rows: List[dict] = []
        for line in chunk[: end + 1].splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a torn or corrupt line mid-stream
            if isinstance(rec, dict) and "kind" in rec:
                rows.append(rec)
        return rows
