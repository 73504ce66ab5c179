"""Communication monitor: flight recorder, collective timeouts, desync
detection, the monitored barrier and the collective counts (counterpart of
``paddle_tpu/distributed/comm_monitor.py``, same knobs and meanings).

A hung or mismatched collective is the usual multi-rank failure: one rank
enters ``all_reduce`` while a peer sits in ``barrier``, and every rank
blocks with no diagnostic. Every collective of ``collective.py`` records a
per-rank, per-group **sequence number and op fingerprint** into a bounded
ring buffer (the flight recorder), dumped on timeout, desync or SIGTERM.

- **flight recorder**: ``PADDLE_COLL_RECORDER_SIZE`` (default 256) most
  recent records; ``dump_flight_recorder(reason)`` writes
  ``comm_dump.rank{N}.json`` into ``PADDLE_COLL_DEBUG_DIR``.
- **timeout watchdog**: ``PADDLE_COLL_TIMEOUT`` seconds per collective (0 =
  off). A timer thread fires while the caller is stuck: it dumps the
  recorder, appends an event line to ``PADDLE_COLL_EVENT_FILE`` and then
  applies ``PADDLE_COLL_TIMEOUT_ACTION``: ``abort`` (default: exit with
  ``COLL_TIMEOUT_RC`` 97) or ``dump`` (diagnose only).
- **desync detection**: ranks exchange ``(seq, op-fingerprint)`` through
  ``PADDLE_COLL_SYNC_DIR`` at every ``monitored_barrier`` and, with
  ``PADDLE_COLL_DESYNC_INTERVAL`` = K > 0, every K-th collective. A
  mismatch raises :class:`CollectiveDesyncError` naming both call sites.
- **monitored barrier**: ``barrier_rendezvous(timeout)`` names the ranks
  that never arrived.
- **counts**: each collective adds its calls, bytes and host seconds under
  ``(op, backend, transport)`` (:meth:`CommMonitor.comm_counts`), so a run
  shows which backend and transport every collective took; with
  ``by_group=True`` the rows are split by the group's axis name as well
  (``ici`` and ``dcn`` are the two hops of a hierarchical dp). An
  asynchronous collective is counted when issued, and its wait adds its
  host time to the same row.

The ``coll`` fault site sits in :meth:`CommMonitor.watch`: ``coll:hang``,
``coll:fail``, ``coll:kill`` and ``coll:desync`` (``arg`` = the rank that
desyncs). Standard library only: the launcher side loads it without torch.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "CommMonitor", "CollectiveTimeoutError", "CollectiveDesyncError",
    "monitor", "reset", "dump_flight_recorder", "read_events",
    "COLL_TIMEOUT_RC",
]

_TIMEOUT_ENV = "PADDLE_COLL_TIMEOUT"
_ACTION_ENV = "PADDLE_COLL_TIMEOUT_ACTION"
_RECORDER_ENV = "PADDLE_COLL_RECORDER_SIZE"
_DEBUG_DIR_ENV = "PADDLE_COLL_DEBUG_DIR"
_EVENT_ENV = "PADDLE_COLL_EVENT_FILE"
_SYNC_DIR_ENV = "PADDLE_COLL_SYNC_DIR"
_DESYNC_ENV = "PADDLE_COLL_DESYNC_INTERVAL"

#: exit code a rank reports when its own collective watchdog put it down
#: (distinct from elastic.HUNG_RC=98, which is the launcher-side verdict)
COLL_TIMEOUT_RC = 97


class CollectiveTimeoutError(RuntimeError):
    """A collective (or barrier arrival) exceeded its deadline."""


class CollectiveDesyncError(RuntimeError):
    """Two ranks issued different collectives at the same sequence point."""


class _Record:
    __slots__ = ("seq", "op", "gid", "axis", "nranks", "shape", "dtype",
                 "rank", "site", "t_start", "t_done", "status")

    def __init__(self, seq, op, gid, axis, nranks, shape, dtype, rank, site):
        self.seq = seq
        self.op = op
        self.gid = gid
        self.axis = axis
        self.nranks = nranks
        self.shape = shape
        self.dtype = dtype
        self.rank = rank
        self.site = site
        self.t_start = time.time()
        self.t_done = None
        self.status = "started"

    def fingerprint(self) -> str:
        return (f"{self.op}|g{self.gid}|n{self.nranks}|"
                f"{self.dtype}|{self.shape}")

    def describe(self) -> str:
        return (f"{self.op}(seq {self.seq}, group {self.gid}, "
                f"{self.dtype}{list(self.shape)}, {self.nranks} ranks, "
                f"site {self.site})")

    def to_json(self) -> dict:
        return {
            "seq": self.seq, "op": self.op, "group": self.gid,
            "axis": self.axis, "nranks": self.nranks,
            "shape": list(self.shape), "dtype": self.dtype,
            "rank": self.rank, "site": self.site, "status": self.status,
            "t_start": self.t_start, "t_done": self.t_done,
        }


def _caller_site() -> str:
    """First stack frame outside this package's distributed/ internals
    (and the contextmanager plumbing) — the user call site a desync
    diagnostic should name."""
    here = os.path.dirname(os.path.abspath(__file__))
    for frame in reversed(traceback.extract_stack(limit=24)[:-2]):
        fname = os.path.abspath(frame.filename)
        if os.path.dirname(fname) == here:
            continue
        if os.path.basename(fname) == "contextlib.py":
            continue
        return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


def _fault_point(site: str) -> None:
    """Route through utils.fault_injection when importable; the monitor
    itself stays stdlib-pure so torch-free children can load it."""
    fi = sys.modules.get("paddle_tpu_torch.utils.fault_injection") \
        or sys.modules.get("fault_injection")
    if fi is None:
        try:
            from ..utils import fault_injection as fi
        except ImportError:
            return
    fi.fault_point(site)


def _consume_desync_flag() -> bool:
    fi = sys.modules.get("paddle_tpu_torch.utils.fault_injection") \
        or sys.modules.get("fault_injection")
    if fi is None or not hasattr(fi, "consume_flag"):
        return False
    return fi.consume_flag("desync")


def _bus():
    """The telemetry bus (observability/bus.py) when importable; None
    when this module was loaded standalone outside the package (torch-free
    launcher children) — events then fall back to the legacy-only
    inline write, preserving the stdlib-pure contract."""
    mod = sys.modules.get("paddle_tpu_torch.observability.bus")
    if mod is not None:
        return mod
    try:
        from ..observability import bus as mod  # type: ignore

        return mod
    except ImportError:
        return None


class CommMonitor:
    """Per-process collective monitor (one per rank process).

    Constructor args exist for tests; production reads everything from the
    environment the elastic launcher populated.
    """

    def __init__(self, rank: Optional[int] = None,
                 world: Optional[int] = None,
                 sync_dir: Optional[str] = None,
                 timeout: Optional[float] = None,
                 recorder_size: Optional[int] = None,
                 action: Optional[str] = None):
        def _envf(name, default):
            raw = os.environ.get(name, "")
            return float(raw) if raw.strip() else default

        self.rank = rank if rank is not None else int(
            os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.world = world if world is not None else int(
            os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.sync_dir = (sync_dir if sync_dir is not None
                         else os.environ.get(_SYNC_DIR_ENV))
        self.timeout = (timeout if timeout is not None
                        else _envf(_TIMEOUT_ENV, 0.0))
        self.action = action or os.environ.get(_ACTION_ENV, "abort")
        self.desync_interval = int(_envf(_DESYNC_ENV, 0.0))
        size = recorder_size if recorder_size is not None else int(
            _envf(_RECORDER_ENV, 256.0))
        self._ring: deque = deque(maxlen=max(size, 8))
        self._seq: Dict[int, int] = {}       # per-group sequence numbers
        self._n_records = 0
        self._barrier_round = 0
        self._desync_round = 0
        self._lock = threading.Lock()
        self._sigterm_installed = False
        # (op, group axis name, backend, transport) -> [calls, bytes,
        # host seconds]
        self._counts: Dict[tuple, list] = {}

    # -- recording --------------------------------------------------------
    def record(self, op: str, gid: int, axis: str, nranks: int,
               shape=(), dtype: str = "", status: str = "started",
               ) -> _Record:
        with self._lock:
            seq = self._seq[gid] = self._seq.get(gid, 0) + 1
            rec = _Record(seq, op, gid, axis, nranks, tuple(shape),
                          str(dtype), self.rank, _caller_site())
            rec.status = status
            self._ring.append(rec)
            self._n_records += 1
            n = self._n_records
        if (self.desync_interval > 0 and n % self.desync_interval == 0
                and status == "started"):
            self.check_desync()
        return rec

    # -- counts -----------------------------------------------------------
    def count(self, op: str, backend: str, transport: str, nbytes: int,
              seconds: float, *, calls: int = 1,
              group: Optional[str] = None) -> None:
        """Add ``calls`` collectives (1: one finished call; 0: the wait
        of one already counted) to their (op, group, backend, transport)
        row; ``group`` is the group's axis name."""
        with self._lock:
            row = self._counts.setdefault(
                (op, group or "", backend, transport), [0, 0, 0.0])
            row[0] += int(calls)
            row[1] += int(nbytes)
            row[2] += float(seconds)

    def comm_counts(self, by_group: bool = False) -> List[dict]:
        """The rows of :meth:`count`: op, backend, transport, calls, bytes
        and host milliseconds, in the order first seen; with
        ``by_group`` split by the group's axis name (key ``group``)."""
        with self._lock:
            rows: Dict[tuple, list] = {}
            for (op, group, backend, transport), v in self._counts.items():
                key = (op, group, backend, transport) if by_group \
                    else (op, backend, transport)
                row = rows.setdefault(key, [0, 0, 0.0])
                for i in range(3):
                    row[i] += v[i]
        names = ("op", "group", "backend", "transport") if by_group \
            else ("op", "backend", "transport")
        return [{**dict(zip(names, k)), "calls": v[0], "bytes": v[1],
                 "ms": v[2] * 1e3} for k, v in rows.items()]

    def reset_counts(self) -> None:
        with self._lock:
            self._counts.clear()

    @contextlib.contextmanager
    def watch(self, op: str, gid: int, axis: str, nranks: int,
              shape=(), dtype: str = "", timeout: Optional[float] = None,
              backend: Optional[str] = None, transport: Optional[str] = None,
              nbytes: int = 0):
        """Record one collective, arm its timeout deadline and, with a
        ``backend``, count it on success.

        The timer thread fires while the caller is stuck inside the
        collective — the only vantage point that can still produce a
        diagnostic when the main thread is wedged in the runtime."""
        t0 = time.perf_counter()
        self._maybe_install_sigterm_dump()
        rec = self.record(op, gid, axis, nranks, shape, dtype)
        deadline = self.timeout if timeout is None else timeout
        timer = None
        if deadline and deadline > 0:
            timer = threading.Timer(deadline, self._on_timeout,
                                    (rec, deadline))
            timer.daemon = True
            timer.start()
        try:
            _fault_point("coll")      # coll:hang / coll:fail / coll:kill
            if _consume_desync_flag():
                # injected desync: this rank's fingerprint mutates as if
                # it had issued a different op — peers see the mismatch
                rec.op = f"{op}[desync-injected]"
            yield rec
        except BaseException:
            rec.status = "failed"
            rec.t_done = time.time()
            raise
        finally:
            if timer is not None:
                timer.cancel()
            if rec.status == "started":
                rec.status = "done"
                rec.t_done = time.time()
                if backend is not None:
                    self.count(op, backend, transport or "", nbytes,
                               time.perf_counter() - t0, group=axis)

    # -- timeout path -----------------------------------------------------
    def _on_timeout(self, rec: _Record, deadline: float) -> None:
        if rec.status != "started":
            return  # raced with completion
        rec.status = "timeout"
        msg = (f"collective timeout: rank {self.rank} stalled "
               f">{deadline:g}s in {rec.describe()}")
        path = self.dump_flight_recorder("timeout")
        self._write_event("coll_timeout", rec, extra={
            "timeout_s": deadline, "dump": path})
        print(f"paddle_tpu_torch.comm_monitor: {msg}"
              + (f"; flight recorder dumped to {path}" if path else ""),
              file=sys.stderr, flush=True)
        if self.action == "abort":
            # the rank is wedged in the runtime; exiting is the only way
            # to hand control back to the launcher, which attributes the
            # kill from the event line written above
            os._exit(COLL_TIMEOUT_RC)

    # -- flight recorder dump ---------------------------------------------
    def snapshot(self) -> List[dict]:
        with self._lock:
            return [r.to_json() for r in self._ring]

    def dump_flight_recorder(self, reason: str) -> Optional[str]:
        """Write the ring buffer to PADDLE_COLL_DEBUG_DIR (the launcher
        points it at the workerlog dir). Returns the path, or None when
        no destination is configured or nothing was recorded."""
        records = self.snapshot()
        if not records:
            return None
        dump_dir = os.environ.get(_DEBUG_DIR_ENV)
        if not dump_dir:
            return None
        try:
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(dump_dir, f"comm_dump.rank{self.rank}.json")
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({
                    "rank": self.rank, "world": self.world,
                    "reason": reason, "time": time.time(),
                    "pid": os.getpid(), "records": records,
                }, f, indent=1)
            os.replace(tmp, path)
            return path
        except OSError:
            return None  # diagnostics must never take the trainer down

    def _write_event(self, kind: str, rec: Optional[_Record],
                     extra: Optional[dict] = None) -> None:
        payload: dict = {}
        if rec is not None:
            payload.update(rec.to_json())
            payload["describe"] = rec.describe()
        if extra:
            payload.update(extra)
        bus = _bus()
        if bus is not None:
            # unified-schema row on the per-rank bus stream + the legacy
            # flat row on PADDLE_COLL_EVENT_FILE (kill-attribution reader)
            bus.emit(kind, payload, rank=self.rank, legacy_env=_EVENT_ENV)
            return
        path = os.environ.get(_EVENT_ENV)
        if not path:
            return
        row = {"event": kind, "rank": self.rank, "time": time.time()}
        row.update(payload)
        try:
            with open(path, "a") as f:
                f.write(json.dumps(row) + "\n")
        except OSError:
            pass

    # -- SIGTERM dump -----------------------------------------------------
    def _maybe_install_sigterm_dump(self) -> None:
        """Dump on preemption notice when nothing else owns SIGTERM.
        Trainers using install_preempt_notice get the dump through that
        hook instead (elastic.py chains it); this covers bare scripts."""
        if self._sigterm_installed:
            return
        if threading.current_thread() is not threading.main_thread():
            return  # keep trying: a later main-thread collective installs
        self._sigterm_installed = True
        try:
            current = signal.getsignal(signal.SIGTERM)
        except (ValueError, OSError):
            return
        if current not in (signal.SIG_DFL, None):
            return  # somebody owns SIGTERM; they chain the dump themselves

        def _handler(signum, frame):
            self.dump_flight_recorder("sigterm")
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        try:
            signal.signal(signal.SIGTERM, _handler)
        except (ValueError, OSError):
            pass

    # -- desync detection -------------------------------------------------
    def _exchange(self, subdir: str, rnd: int, payload: dict,
                  timeout: float) -> Dict[int, dict]:
        """Publish this rank's payload for round `rnd` and collect every
        peer's. Raises CollectiveTimeoutError naming the missing ranks."""
        assert self.sync_dir
        d = os.path.join(self.sync_dir, subdir)
        os.makedirs(d, exist_ok=True)
        mine = os.path.join(d, f"r{rnd}.rank{self.rank}")
        tmp = mine + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, mine)
        deadline = time.monotonic() + timeout
        out: Dict[int, dict] = {}
        while True:
            missing = []
            for peer in range(self.world):
                if peer in out:
                    continue
                p = os.path.join(d, f"r{rnd}.rank{peer}")
                try:
                    with open(p) as f:
                        out[peer] = json.load(f)
                except (OSError, ValueError):
                    missing.append(peer)
            if not missing:
                # a rank only publishes round K after completing K-1, so
                # everyone seeing round `rnd` implies round rnd-2 readers
                # are done — prune it to bound the dir (long jobs would
                # otherwise accumulate world files per round forever)
                if rnd >= 2:
                    for peer in range(self.world):
                        try:
                            os.unlink(
                                os.path.join(d, f"r{rnd - 2}.rank{peer}"))
                        except OSError:
                            pass
                return out
            if time.monotonic() > deadline:
                raise CollectiveTimeoutError(
                    f"{subdir} round {rnd}: rank {self.rank} waited "
                    f"{timeout:g}s; missing ranks {missing} "
                    f"(arrived: {sorted(out)})")
            time.sleep(0.02)

    #: how many trailing flight-recorder entries each rank publishes for
    #: the desync diff — enough to localize the first divergent call
    DESYNC_TAIL = 32

    def check_desync(self, timeout: Optional[float] = None) -> None:
        """Exchange the (seq, op-fingerprint) tail of the flight recorder
        with every peer and raise a diagnostic naming the two mismatched
        call sites on divergence. Entries are matched per (group, seq):
        the same sequence slot filled by DIFFERENT collectives on two
        ranks is exactly the mismatched-collective deadlock this detector
        exists for. No-op when there is nothing to exchange through
        (single rank or no launcher-shared sync dir)."""
        if self.world <= 1 or not self.sync_dir:
            return
        with self._lock:
            rnd = self._desync_round
            self._desync_round += 1
            tail = [
                {"gid": r.gid, "seq": r.seq, "op": r.op,
                 "fingerprint": r.fingerprint(), "site": r.site}
                for r in list(self._ring)[-self.DESYNC_TAIL:]
            ]
        payload = {"rank": self.rank, "tail": tail}
        t = timeout if timeout is not None else max(self.timeout, 30.0)
        try:
            peers = self._exchange("desync", rnd, payload, t)
        except CollectiveTimeoutError:
            self.dump_flight_recorder("desync-timeout")
            raise
        base_rank = min(peers)
        base = {(e["gid"], e["seq"]): e for e in peers[base_rank]["tail"]}
        for r in sorted(peers):
            if r == base_rank:
                continue
            for e in peers[r]["tail"]:
                b = base.get((e["gid"], e["seq"]))
                if b is None or b["fingerprint"] == e["fingerprint"]:
                    continue
                err = CollectiveDesyncError(
                    "collective desync detected at group "
                    f"{e['gid']} seq {e['seq']}: rank {base_rank} issued "
                    f"{b['op']} ({b['fingerprint']}) from {b['site']}, "
                    f"but rank {r} issued {e['op']} "
                    f"({e['fingerprint']}) from {e['site']}")
                rec = _Record(e["seq"], "desync_check", e["gid"], "",
                              self.world, (), "", self.rank,
                              _caller_site())
                rec.status = "desync"
                self._write_event("coll_desync", rec, extra={
                    "detail": str(err),
                    "site_a": b["site"], "site_b": e["site"],
                    "op_a": b["op"], "op_b": e["op"],
                    "rank_a": base_rank, "rank_b": r,
                })
                self.dump_flight_recorder("desync")
                raise err

    # -- monitored barrier ------------------------------------------------
    def barrier_rendezvous(self, timeout: float) -> None:
        """Cross-process half of monitored_barrier: every rank checks in
        through the sync dir; a deadline names the ranks that never
        arrived (instead of blocking forever), then fingerprints are
        cross-checked for desync."""
        if self.world <= 1 or not self.sync_dir:
            return
        with self._lock:
            rnd = self._barrier_round
            self._barrier_round += 1
        try:
            self._exchange("barrier", rnd, {"rank": self.rank}, timeout)
        except CollectiveTimeoutError as e:
            rec = _Record(rnd, "monitored_barrier", -1, "", self.world,
                          (), "", self.rank, _caller_site())
            rec.status = "timeout"
            self._write_event("barrier_timeout", rec,
                              extra={"detail": str(e)})
            self.dump_flight_recorder("barrier-timeout")
            raise
        self.check_desync(timeout=timeout)


# ---------------------------------------------------------------------------
# process-global instance
# ---------------------------------------------------------------------------

_active: Optional[CommMonitor] = None
_lock = threading.Lock()


def monitor() -> CommMonitor:
    global _active
    if _active is None:
        with _lock:
            if _active is None:
                _active = CommMonitor()
    return _active


def reset() -> None:
    """Drop the process-global monitor (tests re-arm between cases)."""
    global _active
    _active = None


def dump_flight_recorder(reason: str = "manual") -> Optional[str]:
    """Module-level convenience for signal/teardown hooks: dump the
    active monitor's ring buffer (no-op when nothing was recorded)."""
    if _active is None:
        return None
    return _active.dump_flight_recorder(reason)


def read_events(path: str) -> List[dict]:
    """Parse a PADDLE_COLL_EVENT_FILE (one JSON object per line). The
    launcher-side reader — tolerant of torn last lines."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out
