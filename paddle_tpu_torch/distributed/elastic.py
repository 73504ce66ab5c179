"""The trainer's half of the elastic runtime (counterpart of the part of
``paddle_tpu/distributed/elastic.py`` that trainers call).

- :func:`heartbeat` touches ``PADDLE_HEARTBEAT_FILE`` (no-op without
  one); the launcher's watchdog compares its mtime.
- :func:`install_preempt_notice` / :func:`restore_preempt_notice`: the
  SIGTERM handler that turns the cloud's eviction notice into a callback
  (``TrainEpochRange`` and hapi's ``TerminateOnPreempt`` use it).
- :data:`PREEMPT_RC` (143, 128 + SIGTERM) and :data:`HUNG_RC` (98), the
  exit codes the launcher attributes.

The launcher itself (``ElasticManager``, ``RankProc``, the restart
budget, the reshard notice and the live lend plane) is ROADMAP queue A
item 7: any of its names raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import os
import signal
import threading
from typing import Callable

__all__ = ["heartbeat", "install_preempt_notice", "restore_preempt_notice",
           "HUNG_RC", "PREEMPT_RC"]

_HEARTBEAT_ENV = "PADDLE_HEARTBEAT_FILE"

#: exit code the manager reports when the watchdog had to put a rank down
HUNG_RC = 98
#: exit code after a propagated preemption notice (128 + SIGTERM)
PREEMPT_RC = 143

#: the JAX package's launcher names, which wait for ROADMAP queue A item 7
_LAUNCHER_NAMES = ("ElasticManager", "RankProc")


def __getattr__(name):
    if name in _LAUNCHER_NAMES:
        raise NotImplementedError(
            f"distributed.elastic.{name}: the elastic launcher is not ported "
            "yet: ROADMAP queue A item 7 (distributed)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    """Install a SIGTERM handler that calls ``on_notice()``. Returns the
    previous handler for :func:`restore_preempt_notice`, or None when it
    cannot be installed (not the main thread).

    The JAX package's handler first dumps the collective flight recorder
    (``comm_monitor``); the port has no comm monitor yet (ROADMAP queue A
    item 7), so this handler only calls ``on_notice``."""
    if threading.current_thread() is not threading.main_thread():
        return None

    def _handler(signum, frame):
        on_notice()

    try:
        return signal.signal(signal.SIGTERM, _handler)
    except (ValueError, OSError):
        return None


def restore_preempt_notice(old) -> None:
    if old is not None:
        signal.signal(signal.SIGTERM, old)
