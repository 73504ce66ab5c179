"""The telemetry bus: one per-rank JSONL event schema (counterpart of
``paddle_tpu/observability/bus.py``, with the same rows in the same
files, so a stream written by either package reads in the other's
tools)::

    {"v": 1, "kind": "...", "step": N|null, "time": <wall>, "rank": R,
     "payload": {...}}

- ``v``     schema version.
- ``kind``  event name: the guard's ``guard_*``, ``step_metrics``, the
  ledger's ``recompile`` / ``recompile_storm`` / ``backend_compile``, the
  profiler's ``trace_armed`` / ``trace_captured``, the engine's
  ``decode_metrics`` /
  ``decode_request`` / ``span`` / ``engine_expand`` / ``engine_shrink``,
  the router's ``router_*`` and ``kv_migrate_fail``, the mailbox
  worker's ``worker_ack`` / ``worker_progress`` / ``kv_extract``.
- ``step``  the monotonic per-process step index (:func:`set_step`), or
  the emitter's own counter; ``null`` outside a loop.
- ``rank``  ``PADDLE_TRAINER_ID`` (-1 for a launcher process).

Destination: ``PADDLE_OBS_BUS_FILE`` (one explicit file) or
``PADDLE_OBS_DIR/telemetry.rank{R}.jsonl``. Neither set: the bus is off
and :func:`emit` returns after building its dict.

Standard library only, and no package-relative import at module level:
the mailbox worker (``serving/router.py``) loads this file by path in a
process that imports neither torch nor jax.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "SCHEMA_VERSION", "enabled", "bus_path", "emit", "emit_span",
    "set_step", "current_step", "read_stream", "rank_streams", "reset",
]

SCHEMA_VERSION = 1

_DIR_ENV = "PADDLE_OBS_DIR"
_FILE_ENV = "PADDLE_OBS_BUS_FILE"

_lock = threading.Lock()
_step: Optional[int] = None   # monotonic step index, set by the step objects


def _rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    except ValueError:
        return 0


def bus_path(rank: Optional[int] = None) -> Optional[str]:
    """This process's bus file, or None when the bus is off."""
    explicit = os.environ.get(_FILE_ENV)
    if explicit:
        return explicit
    d = os.environ.get(_DIR_ENV)
    if not d:
        return None
    r = _rank() if rank is None else rank
    name = "telemetry.launcher.jsonl" if r < 0 \
        else f"telemetry.rank{r}.jsonl"
    return os.path.join(d, name)


def enabled() -> bool:
    return bus_path() is not None


def set_step(step: int) -> None:
    """Advance the process-wide monotonic step index (emitters that do not
    know their step inherit it)."""
    global _step
    _step = int(step)


def current_step() -> Optional[int]:
    return _step


def reset() -> None:
    """Forget the step counter (tests, between cases)."""
    global _step
    _step = None


def _mon_fault_action() -> Optional[str]:
    """The ``mon`` fault site: a ``mon:drop:nth`` / ``mon:dup:nth`` rule
    drops or duplicates the nth row this process writes. Resolved only
    when a spec is armed; outside the package (the worker loads this file
    by path) the injector is looked up in ``sys.modules``."""
    if not os.environ.get("PADDLE_FAULT_SPEC"):
        return None
    fi = None
    try:
        from ..utils import fault_injection as fi  # package context
    except (ImportError, ValueError):
        import sys as _sys

        for name in ("fault_injection", "_pdtpu_torch_fault"):
            fi = _sys.modules.get(name)
            if fi is not None:
                break
    if fi is None or not hasattr(fi, "consume_mon_action"):
        return None
    try:
        return fi.consume_mon_action()
    except Exception:  # noqa: BLE001 -- diagnostics stay best-effort
        return None


def emit(kind: str, payload: Optional[Dict] = None, *,
         step: Optional[int] = None, rank: Optional[int] = None,
         legacy_env: Optional[str] = None) -> None:
    """Append one bus row and, with ``legacy_env``, the old flat row
    ``{"event": kind, "time", "rank", **payload}`` to the file that env
    names (``PADDLE_GUARD_EVENT_FILE``, which the elastic launcher reads
    for kill attribution). An I/O failure is swallowed: telemetry never
    takes the program down."""
    payload = dict(payload or {})
    r = _rank() if rank is None else int(rank)
    now = time.time()
    if legacy_env:
        legacy_path = os.environ.get(legacy_env)
        if legacy_path:
            legacy_row = {"event": kind, "time": now, "rank": r}
            legacy_row.update(payload)
            try:
                with _lock, open(legacy_path, "a") as f:
                    f.write(json.dumps(legacy_row, default=str) + "\n")
            except (OSError, TypeError, ValueError):
                pass
    path = bus_path(rank=r)
    if not path:
        return
    action = _mon_fault_action()
    if action == "drop":
        return  # the injected lost line
    row = {
        "v": SCHEMA_VERSION,
        "kind": kind,
        "step": _step if step is None else int(step),
        "time": now,
        "rank": r,
        "payload": payload,
    }
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        line = json.dumps(row, default=str) + "\n"
        if action == "dup":
            line += line  # the injected duplicated line
        with _lock, open(path, "a") as f:
            f.write(line)
    except (OSError, TypeError, ValueError):
        pass


def emit_span(name: str, trace_id, payload: Optional[Dict] = None, *,
              step: Optional[int] = None,
              rank: Optional[int] = None) -> None:
    """One request-scoped ``span`` row: a named phase of a request's life
    (``router_submit``, ``admit``, ``prefill``, ``decode_window``,
    ``retire``, ``kv_extract`` ...) keyed by the ``trace_id`` the router
    stamps. Host values only. No row without a trace id."""
    if trace_id is None:
        return
    p = {"name": name, "trace_id": trace_id}
    p.update(payload or {})
    emit("span", p, step=step, rank=rank)


def read_stream(path: str) -> List[dict]:
    """Parse one bus JSONL file, skipping a torn last line."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict) and "kind" in row:
                    out.append(row)
    except OSError:
        pass
    return out


def rank_streams(obs_dir: str) -> Dict[int, List[dict]]:
    """Every per-rank stream of an observability dir, by rank (the
    launcher's file as -1), rows sorted by time within each."""
    out: Dict[int, List[dict]] = {}
    try:
        names = sorted(os.listdir(obs_dir))
    except OSError:
        return out
    for name in names:
        if name == "telemetry.launcher.jsonl":
            r = -1
        elif name.startswith("telemetry.rank") and name.endswith(".jsonl"):
            try:
                r = int(name[len("telemetry.rank"):-len(".jsonl")])
            except ValueError:
                continue
        else:
            continue
        rows = read_stream(os.path.join(obs_dir, name))
        rows.sort(key=lambda e: e.get("time", 0.0))
        if rows:
            out[r] = rows
    return out
