"""The elastic runtime: heartbeat watchdog, restart budget, log capture
and the reshard notice (counterpart of ``paddle_tpu/distributed/
elastic.py``).

Reference: launch_utils.py:996-1118 (``TrainerProc`` bookkeeping, the
``watch_local_trainers`` poll loop, ``workerlog.N`` per-rank log files,
``terminate_local_procs``' SIGTERM -> grace -> SIGKILL teardown) and
``distributed/fleet/elastic/manager.py``'s ElasticManager.

The trainer's half:

- :func:`heartbeat` touches ``PADDLE_HEARTBEAT_FILE`` (no-op without
  one); the launcher's watchdog compares its mtime.
- :func:`install_preempt_notice` / :func:`restore_preempt_notice`: the
  SIGTERM handler that dumps the collective flight recorder (reason
  ``"sigterm"``, ``comm_monitor``) and then turns the cloud's eviction
  notice into a callback (``TrainEpochRange`` and hapi's
  ``TerminateOnPreempt`` use it).
- :data:`PREEMPT_RC` (143, 128 + SIGTERM) and :data:`HUNG_RC` (98), the
  exit codes the launcher attributes.

The launcher's half, :class:`ElasticManager` (one :class:`RankProc` a
rank; a rank is a process here as in the JAX package's launcher):

- **heartbeats**: each rank gets ``PADDLE_HEARTBEAT_FILE``; a rank whose
  file goes stale for ``PADDLE_WATCHDOG_TIMEOUT`` seconds is hung.
- **escalation**: hung or failed ranks get SIGTERM, a
  ``PADDLE_WATCHDOG_GRACE``-second window, then SIGKILL.
- **restart budget**: at most ``max_restarts`` relaunches per
  ``PADDLE_ELASTIC_WINDOW``-second rolling window, with exponential
  backoff (base ``PADDLE_ELASTIC_BACKOFF``, cap 30 s, +-50% jitter).
- **preemption**: SIGTERM/SIGINT to the manager is forwarded to every
  child, no relaunch follows, and the manager exits 143.
- **kill attribution**: the last event a rank's comm monitor or guard
  wrote (``PADDLE_COLL_EVENT_FILE``, ``PADDLE_GUARD_EVENT_FILE``) names
  what a dead or hung rank was doing.
- **reshard notice**: with ``reshard="shrink"`` (or ``"shrink_expand"``,
  treated as shrink here as in the JAX package: a fresh process cannot
  join a running job's step; CLI ``--reshard``, env
  ``PADDLE_RESHARD_MODE``), a rank that dies (or that the watchdog puts
  down) while at least ``PADDLE_RESHARD_QUORUM`` of the attempt's ranks
  survive is retired, not fatal: the manager appends a JSON notice row to
  every survivor's ``PADDLE_RESHARD_NOTICE_FILE`` and sends SIGUSR1, but
  only to a rank that has armed its handler (the ``.armed`` marker that
  ``resharding.install_reshard_notice`` writes); survivors reshard at
  their next step boundary (``resharding.ElasticStep``).
- ``deadline``: a job still running after that many seconds is killed and
  returns ``HUNG_RC``.

Each child gets ``PADDLE_COLL_SYNC_DIR`` (a fresh directory an attempt,
for ``monitored_barrier``, the desync exchange and the rendezvous of a
rebuilt world; under the manager's own ``PADDLE_COLL_SYNC_DIR`` where set,
a directory the hosts of a job share, as the port's launcher has taken it
since it was ported, where the JAX package's always makes its own),
``PADDLE_COLL_DEBUG_DIR`` (the log dir, where flight
recorder dumps land), ``PADDLE_COLL_TIMEOUT`` from ``coll_timeout`` and
``PADDLE_DISTRI_BACKEND`` from ``backend`` (a torch backend; one that
disagrees with ``comm``'s rule makes the ranks raise).

Departures from the JAX package: the embedded fleet monitor and the
co-tenancy controller (its live lend plane) are ROADMAP queue A item 8.
Asked for explicitly (``monitor=True``, ``PADDLE_MON`` set on,
``controller=`` or ``PADDLE_CTL`` other than ``off``) they raise
``NotImplementedError`` naming it. Where the JAX package starts the
monitor by default (an observability dir, ``PADDLE_MON`` unset), this
manager says once on stderr that it runs without one.
"""
from __future__ import annotations

import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from . import comm_monitor

__all__ = ["ElasticManager", "RankProc", "heartbeat",
           "install_preempt_notice", "restore_preempt_notice", "HUNG_RC",
           "PREEMPT_RC"]

_HEARTBEAT_ENV = "PADDLE_HEARTBEAT_FILE"
_WATCHDOG_ENV = "PADDLE_WATCHDOG_TIMEOUT"
_GRACE_ENV = "PADDLE_WATCHDOG_GRACE"
_BACKOFF_ENV = "PADDLE_ELASTIC_BACKOFF"
_WINDOW_ENV = "PADDLE_ELASTIC_WINDOW"
_LOGDIR_ENV = "PADDLE_LOG_DIR"
_RESHARD_MODE_ENV = "PADDLE_RESHARD_MODE"
_RESHARD_QUORUM_ENV = "PADDLE_RESHARD_QUORUM"
_RESHARD_NOTICE_ENV = "PADDLE_RESHARD_NOTICE_FILE"
_MON_ENV = "PADDLE_MON"
_CTL_ENV = "PADDLE_CTL"

#: exit code the manager reports when the watchdog had to put a rank down
HUNG_RC = 98
#: exit code after a propagated preemption notice (128 + SIGTERM)
PREEMPT_RC = 143

_ITEM_8 = "ROADMAP queue A item 8 (the fleet monitor and controller)"


def _emit(kind: str, **payload) -> None:
    """A launcher-side bus row (rank -1); lands only when the manager's
    own environment names a bus destination."""
    from ..observability import bus

    bus.emit(kind, payload, rank=-1)


def heartbeat() -> None:
    """Touch this rank's heartbeat file (no-op outside the launcher).
    Cheap enough to call per batch; a lost heartbeat never raises."""
    path = os.environ.get(_HEARTBEAT_ENV)
    if not path:
        return
    try:
        with open(path, "a"):
            pass
        os.utime(path, None)
    except OSError:
        pass


def install_preempt_notice(on_notice: Callable[[], None]):
    """Install a SIGTERM handler that dumps the collective flight recorder
    (``comm_monitor.dump_flight_recorder("sigterm")``; a failure to dump
    never blocks the notice) and then calls ``on_notice()``. Returns the
    previous handler for :func:`restore_preempt_notice`, or None when it
    cannot be installed (not the main thread)."""
    if threading.current_thread() is not threading.main_thread():
        return None

    def _handler(signum, frame):
        try:
            comm_monitor.dump_flight_recorder("sigterm")
        except Exception:  # noqa: BLE001 - the notice must go through
            pass
        on_notice()

    try:
        return signal.signal(signal.SIGTERM, _handler)
    except (ValueError, OSError):
        return None


def restore_preempt_notice(old) -> None:
    if old is not None:
        signal.signal(signal.SIGTERM, old)


class RankProc:
    """One spawned rank (launch_utils.py ``TrainerProc``)."""

    __slots__ = ("proc", "rank", "hb_path", "log_path", "log_file",
                 "ev_path", "guard_ev_path", "notice_path")

    def __init__(self, proc, rank, hb_path, log_path=None, log_file=None,
                 ev_path=None, guard_ev_path=None, notice_path=None):
        self.proc = proc
        self.rank = rank
        self.hb_path = hb_path
        self.log_path = log_path
        self.log_file = log_file
        self.ev_path = ev_path
        self.guard_ev_path = guard_ev_path
        self.notice_path = notice_path


class ElasticManager:
    """Spawn this host's ranks and keep the job alive across failures.

    ``envs`` is one environment dict a local rank (``launch.
    build_cluster_env``); the manager adds ``PADDLE_LAUNCH_ATTEMPT``,
    ``PADDLE_HEARTBEAT_FILE`` and the comm monitor's files on top.
    ``monitor`` and ``controller`` are the JAX package's options of
    ROADMAP item 8 (the module's notes)."""

    def __init__(self, script: str, script_args: List[str],
                 envs: List[Dict[str, str]], backend: Optional[str] = None,
                 max_restarts: int = 0,
                 watchdog_timeout: Optional[float] = None,
                 grace: Optional[float] = None,
                 backoff_base: Optional[float] = None,
                 backoff_cap: float = 30.0,
                 restart_window: Optional[float] = None,
                 log_dir: Optional[str] = None,
                 poll_interval: float = 0.1,
                 coll_timeout: Optional[float] = None,
                 reshard: Optional[str] = None,
                 reshard_quorum: Optional[float] = None,
                 monitor: Optional[bool] = None,
                 controller: Optional[str] = None,
                 deadline: Optional[float] = None):
        def _envf(name, default):
            raw = os.environ.get(name, "")
            return float(raw) if raw.strip() else default

        self.script = script
        self.script_args = list(script_args)
        self.envs = envs
        self.backend = backend
        self.max_restarts = int(max_restarts)
        self.watchdog_timeout = (
            watchdog_timeout if watchdog_timeout is not None
            else _envf(_WATCHDOG_ENV, 0.0))
        self.grace = grace if grace is not None else _envf(_GRACE_ENV, 10.0)
        self.backoff_base = (backoff_base if backoff_base is not None
                             else _envf(_BACKOFF_ENV, 0.5))
        self.backoff_cap = backoff_cap
        self.restart_window = (restart_window if restart_window is not None
                               else _envf(_WINDOW_ENV, 3600.0))
        self.log_dir = log_dir or os.environ.get(_LOGDIR_ENV) or None
        self.poll_interval = poll_interval
        self.coll_timeout = coll_timeout
        self.deadline = deadline
        self.reshard = (reshard if reshard is not None
                        else os.environ.get(_RESHARD_MODE_ENV, "off")) \
            .strip().lower() or "off"
        if self.reshard not in ("off", "shrink", "shrink_expand"):
            raise ValueError(
                f"reshard={self.reshard!r}: want off|shrink|shrink_expand")
        self.reshard_quorum = (reshard_quorum if reshard_quorum is not None
                               else _envf(_RESHARD_QUORUM_ENV, 0.5))
        mon_env = os.environ.get(_MON_ENV)
        if monitor is None and mon_env is not None:
            monitor = mon_env.strip().lower() not in ("0", "false", "off")
        if monitor:
            raise NotImplementedError(
                f"ElasticManager(monitor=True): the embedded fleet monitor "
                f"is not ported yet, {_ITEM_8}")
        #: None: the JAX package would start its monitor by default
        self._monitor_default = monitor is None
        if controller is None:
            controller = os.environ.get(_CTL_ENV, "off")
        ctl = (controller or "off").strip().lower() or "off"
        if ctl not in ("off", "dryrun", "live"):
            raise ValueError(f"controller={ctl!r}: want off|dryrun|live")
        if ctl != "off":
            raise NotImplementedError(
                f"ElasticManager(controller={ctl!r}): the co-tenancy "
                f"controller is not ported yet, {_ITEM_8}")
        self._said_no_monitor = False
        self._run_dir = None          # heartbeat files' home, made lazily
        self._procs: List[RankProc] = []
        self._retired: List[RankProc] = []  # resharded-away ranks
        self._spawn_total = 0         # this attempt's quorum denominator
        self._restarts = deque()      # monotonic stamps of past relaunches
        self._preempted = False

    # -- spawning ---------------------------------------------------------
    def _spawn(self, attempt: int) -> None:
        if self._run_dir is None:
            self._run_dir = tempfile.mkdtemp(prefix="paddle_elastic_")
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
        # a sync dir an attempt: a stale round file (or a rebuilt world's
        # store) of an earlier attempt must not satisfy a fresh rendezvous;
        # under one the caller set (a directory the hosts share)
        sync_dir = os.path.join(
            os.environ.get("PADDLE_COLL_SYNC_DIR") or self._run_dir,
            f"collsync.{attempt}")
        os.makedirs(sync_dir, exist_ok=True)
        debug_dir = self.log_dir or self._run_dir
        obs_dir = os.environ.get("PADDLE_OBS_DIR") or self.log_dir
        if obs_dir and self._monitor_default and not self._said_no_monitor:
            self._said_no_monitor = True
            print(f"paddle_tpu_torch.elastic: no embedded fleet monitor "
                  f"(the JAX package starts one for {obs_dir}); it is "
                  f"{_ITEM_8}", file=sys.stderr, flush=True)
        self._procs = []
        self._retired = []
        for env in self.envs:
            env = dict(env)
            if self.backend:
                env["PADDLE_DISTRI_BACKEND"] = self.backend
            env["PADDLE_LAUNCH_ATTEMPT"] = str(attempt)
            rank = int(env.get("PADDLE_TRAINER_ID", "0"))
            hb = os.path.join(self._run_dir, f"hb.{rank}")
            env[_HEARTBEAT_ENV] = hb
            with open(hb, "a"):   # the stale clock starts at spawn
                pass
            os.utime(hb, None)
            ev = os.path.join(self._run_dir, f"collev.{rank}")
            with open(ev, "w"):
                pass  # fresh an attempt: attribution reflects this run
            env["PADDLE_COLL_EVENT_FILE"] = ev
            gev = os.path.join(self._run_dir, f"guardev.{rank}")
            with open(gev, "w"):
                pass
            env["PADDLE_GUARD_EVENT_FILE"] = gev
            notice = None
            if self.reshard != "off":
                notice = os.path.join(
                    self._run_dir, f"reshard.notice.{attempt}.{rank}")
                with open(notice, "w"):
                    pass
                env[_RESHARD_NOTICE_ENV] = notice
            env["PADDLE_COLL_SYNC_DIR"] = sync_dir
            if self.log_dir:
                env["PADDLE_COLL_DEBUG_DIR"] = self.log_dir
            else:
                env.setdefault("PADDLE_COLL_DEBUG_DIR", debug_dir)
            if obs_dir:
                env.setdefault("PADDLE_OBS_DIR", obs_dir)
            if self.coll_timeout is not None:
                env["PADDLE_COLL_TIMEOUT"] = str(self.coll_timeout)
            log_path = log_file = None
            if self.log_dir:
                log_path = os.path.join(self.log_dir, f"workerlog.{rank}")
                log_file = open(log_path, "ab", buffering=0)
                log_file.write(
                    f"==== attempt {attempt} rank {rank} ====\n".encode())
            p = subprocess.Popen(
                [sys.executable, "-u", self.script] + self.script_args,
                env=env, stdout=log_file,
                stderr=subprocess.STDOUT if log_file else None)
            self._procs.append(RankProc(p, rank, hb, log_path, log_file,
                                        ev_path=ev, guard_ev_path=gev,
                                        notice_path=notice))
        self._spawn_total = len(self._procs)
        _emit("elastic_spawn", attempt=attempt,
              ranks=[rp.rank for rp in self._procs],
              pids=[rp.proc.pid for rp in self._procs], obs_dir=obs_dir)

    # -- teardown ---------------------------------------------------------
    def _kill_rank(self, rp: RankProc, why: str) -> None:
        """SIGTERM -> grace -> SIGKILL one rank."""
        if rp.proc.poll() is not None:
            return
        print(f"paddle_tpu_torch.elastic: {why}; terminating rank "
              f"{rp.rank} (pid {rp.proc.pid}, grace {self.grace}s)",
              file=sys.stderr, flush=True)
        rp.proc.send_signal(signal.SIGTERM)
        try:
            rp.proc.wait(timeout=self.grace)
        except subprocess.TimeoutExpired:
            rp.proc.kill()
            rp.proc.wait()

    def _teardown(self, why: str, grace: Optional[float] = None) -> None:
        # signal everyone first, then share one grace deadline: serial
        # waits would stretch teardown to N * grace
        grace = self.grace if grace is None else grace
        live = [rp for rp in self._procs + self._retired
                if rp.proc.poll() is None]
        if live:
            print(f"paddle_tpu_torch.elastic: {why}; terminating "
                  f"{len(live)} rank(s) (grace {grace}s)",
                  file=sys.stderr, flush=True)
            for rp in live:
                try:
                    rp.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
            deadline = time.monotonic() + grace
            for rp in live:
                try:
                    rp.proc.wait(max(deadline - time.monotonic(), 0))
                except subprocess.TimeoutExpired:
                    rp.proc.kill()
                    rp.proc.wait()
        for rp in self._procs + self._retired:
            if rp.log_file is not None:
                try:
                    rp.log_file.close()
                except OSError:
                    pass

    # -- kill attribution (comm_monitor event reader) ---------------------
    def _attribute(self, rp: RankProc, why: str) -> None:
        """Name the collective, or the guard's verdict, behind a rank's
        death when its monitor wrote an event line before the end."""
        events = []
        for path in (rp.ev_path, rp.guard_ev_path):
            if path:
                events.extend(comm_monitor.read_events(path))
        if not events:
            return
        ev = max(events, key=lambda e: e.get("time", 0.0))
        cause = ev.get("event", "?")
        what = ev.get("detail") or ev.get("describe") or cause
        _emit("elastic_attribution", rank=rp.rank, why=why, cause=cause,
              detail=what, incident=None)
        print(f"paddle_tpu_torch.elastic: rank {rp.rank} {why} attributed "
              f"to {cause}: {what}", file=sys.stderr, flush=True)

    # -- reshard notice channel (quorum-holding rank loss) ----------------
    def _quorum_holds(self, n_alive: int) -> bool:
        if self.reshard == "off" or n_alive < 1:
            return False
        return (n_alive / max(self._spawn_total, 1)) >= self.reshard_quorum

    def _retire(self, rp: RankProc) -> None:
        """Drop a departed rank from the watch set without taking the job
        down (its workerlog closes at teardown like everyone's)."""
        self._procs.remove(rp)
        self._retired.append(rp)

    def _rank_proc(self, rank: int) -> Optional[RankProc]:
        for rp in self._procs:
            if rp.rank == rank:
                return rp
        return None

    def _notify_reshard(self, event: str, ranks: List[int],
                        survivors: List[RankProc],
                        extra: Optional[dict] = None) -> None:
        """Append one notice row to every survivor's notice file and send
        SIGUSR1 to each whose handler is armed (its ``.armed`` marker: to
        a child still importing, SIGUSR1's default action is to end it;
        an un-signalled survivor still reads the row at its next step
        boundary)."""
        row = {"event": event, "ranks": ranks, "time": time.time(),
               "survivors": [s.rank for s in survivors]}
        if extra:
            row.update(extra)
        for rp in survivors:
            if rp.notice_path:
                try:
                    with open(rp.notice_path, "a") as f:
                        f.write(json.dumps(row) + "\n")
                except OSError:
                    pass
            if rp.notice_path and os.path.exists(
                    rp.notice_path + ".armed"):
                try:
                    rp.proc.send_signal(signal.SIGUSR1)
                except (OSError, AttributeError):
                    pass
        _emit("elastic_reshard_notice", event=event, ranks=ranks,
              survivors=[s.rank for s in survivors],
              quorum=self.reshard_quorum)
        print(f"paddle_tpu_torch.elastic: rank(s) {ranks} {event}ed; "
              f"quorum holds ({len(survivors)}/{self._spawn_total}): "
              f"reshard notice sent, job continues",
              file=sys.stderr, flush=True)

    # -- the watch loop (launch_utils.py:996-1118) ------------------------
    def _watch(self, t_end: Optional[float]) -> int:
        rc = 0
        while True:
            alive, failed = [], []
            for rp in self._procs:
                code = rp.proc.poll()
                if code is None:
                    alive.append(rp)
                elif code != 0:
                    failed.append((rp, code))
            for rp, code in failed:
                # a rank lost: an in-job event when the quorum holds and
                # resharding is on, a job failure otherwise
                if self._quorum_holds(len(alive)):
                    self._attribute(rp, f"departure (rc={code})")
                    self._retire(rp)
                    self._notify_reshard("depart", [rp.rank], alive)
                elif rc == 0:
                    rc = code  # the first failure wins; tear the job down
                    print(f"paddle_tpu_torch.elastic: rank {rp.rank} "
                          f"exited with code {code}; stopping the job",
                          file=sys.stderr, flush=True)
                    self._attribute(rp, f"failure (rc={code})")
            if rc != 0 or not alive:
                break
            if self._preempted:
                # the notice went out from the signal handler; the
                # children get their grace window to snapshot and exit
                self._teardown("preemption notice")
                return PREEMPT_RC
            if t_end is not None and time.monotonic() > t_end:
                print(f"paddle_tpu_torch.elastic: deadline "
                      f"{self.deadline:g} s passed; killing the job",
                      file=sys.stderr, flush=True)
                self._teardown("deadline", grace=2.0)
                return HUNG_RC
            if self.watchdog_timeout > 0:
                now = time.time()
                for rp in alive:
                    try:
                        age = now - os.path.getmtime(rp.hb_path)
                    except OSError:
                        continue  # the file raced away; skip a beat
                    if age > self.watchdog_timeout:
                        _emit("elastic_watchdog_kill", rank=rp.rank,
                              stale_s=round(age, 1),
                              timeout_s=self.watchdog_timeout)
                        self._kill_rank(
                            rp, f"rank {rp.rank} heartbeat stale "
                                f"{age:.1f}s > {self.watchdog_timeout}s")
                        self._attribute(rp, "watchdog kill")
                        survivors = [s for s in alive if s is not rp]
                        if self._quorum_holds(len(survivors)):
                            # a hung rank put down is a departure
                            self._retire(rp)
                            self._notify_reshard("depart", [rp.rank],
                                                 survivors)
                        else:
                            rc = HUNG_RC
                        break
                if rc != 0:
                    break
            time.sleep(self.poll_interval)
        self._teardown("peer failure" if rc else "job done")
        return rc  # 0: every rank exited clean (even after a notice)

    # -- restart policy ---------------------------------------------------
    def _backoff_delay(self, n_recent: int) -> float:
        """Exponential in the number of recent restarts, capped, with
        +-50% jitter so restarting hosts do not stampede."""
        base = min(self.backoff_cap,
                   self.backoff_base * (2.0 ** max(n_recent - 1, 0)))
        return base * (0.5 + random.random())

    def _budget_left(self) -> bool:
        now = time.monotonic()
        while self._restarts and now - self._restarts[0] > \
                self.restart_window:
            self._restarts.popleft()
        return len(self._restarts) < self.max_restarts

    # -- signals ----------------------------------------------------------
    def _on_notice(self, signum, frame):
        self._preempted = True
        for rp in self._procs:
            if rp.proc.poll() is None:
                try:
                    rp.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass

    def _install_handlers(self):
        old = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                old[sig] = signal.signal(sig, self._on_notice)
        except ValueError:
            pass  # not the main thread: the caller owns signal routing
        return old

    # -- the job ----------------------------------------------------------
    def run(self) -> int:
        old_handlers = self._install_handlers()
        attempt = 0
        t_end = None if self.deadline is None \
            else time.monotonic() + self.deadline
        try:
            while True:
                self._spawn(attempt)
                rc = self._watch(t_end)
                if self._preempted:
                    _emit("elastic_preempt", attempt=attempt, rc=rc)
                    # the notice wins even over a clean exit: the host is
                    # going away
                    return rc or PREEMPT_RC
                if rc == 0:
                    return 0
                if rc == HUNG_RC and t_end is not None \
                        and time.monotonic() > t_end:
                    return rc
                if not self._budget_left():
                    print(f"paddle_tpu_torch.elastic: restart budget "
                          f"exhausted ({self.max_restarts} per "
                          f"{self.restart_window:.0f}s); giving up "
                          f"rc={rc}", file=sys.stderr, flush=True)
                    return rc
                self._restarts.append(time.monotonic())
                delay = self._backoff_delay(len(self._restarts))
                _emit("elastic_relaunch", attempt=attempt, rc=rc,
                      delay_s=round(delay, 2),
                      restarts_left=self.max_restarts - len(self._restarts))
                print(f"paddle_tpu_torch.elastic: attempt {attempt} failed "
                      f"rc={rc}; relaunching in {delay:.2f}s "
                      f"({self.max_restarts - len(self._restarts)} restarts "
                      f"left in window)", file=sys.stderr, flush=True)
                time.sleep(delay)
                if self._preempted:
                    return PREEMPT_RC
                attempt += 1
        finally:
            self._teardown("manager exit", grace=2.0)
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            if self._run_dir is not None:
                shutil.rmtree(self._run_dir, ignore_errors=True)
