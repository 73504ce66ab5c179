"""Deterministic env-spec fault injection (counterpart of
``paddle_tpu/utils/fault_injection.py``, same grammar).

``PADDLE_FAULT_SPEC`` is a comma-separated list of rules::

    site:action:nth[:arg]

- ``site``   a fault point. The port instruments eight: ``serve`` (each
  router tick, each mailbox-worker poll, each router submit and each
  prefix-cache lookup that a ``prefix_stale`` / ``adapter_missing`` rule
  names), ``mon`` (each telemetry-bus row write), ``io.save`` (before
  a ``framework.io.save`` write), ``io.save.post`` (after its atomic
  replace, where ``corrupt`` bites), ``io.load``, ``acp.save`` (before an
  auto-checkpoint snapshot), ``epoch`` (on entering each
  ``TrainEpochRange`` epoch) and ``grad`` (once per ``jit.TrainStep``
  call). A rule for a site the JAX package instruments and the port does
  not yet (``coll``, ``rank``, ``ctl``) raises ``NotImplementedError``
  naming the ROADMAP item that brings it; so does any other site.
- ``action`` ``fail`` (raise :class:`InjectedFault`, an IOError), ``kill``
  (``os._exit(arg)``, default 17), ``hang`` (at ``serve``: an event, the
  targeted worker -- ``arg`` = its rank -- stops draining its mailbox but
  keeps its telemetry heartbeat; elsewhere: sleep ``arg`` seconds, default
  3600), ``nan`` / ``inf`` / ``spike`` (``grad`` only: that step's gradients
  are multiplied by NaN, Inf or 1e4 in place; ``arg`` = how many consecutive
  step calls the rule stays armed, default 1, so ``grad:nan:3:2`` poisons
  steps 3 and 4), the ``serve`` events ``burst`` (``arg`` requests at that
  router tick, default 8), ``slow_host`` (the rank's simulated work slows
  20x), ``straggler`` (a fixed delay per window), ``host_crash`` (SIGKILL at
  the rank's next mid-decode window), ``kv_corrupt`` (one bit of block
  ``arg`` of the next migration bundle flips, so its CRC fails), ``kv_lost``
  (the next bundle never arrives), ``prefix_stale`` (the ``arg``-th oldest
  prefix-cache entry's key is poisoned) and ``adapter_missing`` (the next
  submit names an unloaded adapter, ``arg`` or an id past any fleet), or the
  ``mon`` actions ``drop`` / ``dup`` (that bus row is lost or written
  twice), or ``corrupt`` (truncate the file ``io.save.post`` passed to half
  its bytes: a torn write; a ``corrupt`` rule written against ``io.save``
  means ``io.save.post``, so it corrupts a complete file). The other actions
  of the grammar (``desync``, ``depart``/``return``,
  ``flap``/``die``/``lend_crash`` and the serve event ``lent_worker_crash``)
  parse as in the JAX package and then raise ``NotImplementedError``: their
  sites are not instrumented here.
- ``nth``    the 1-based per-process hit count of that site at which the
  rule fires.
- ``arg``    the action's parameter.

A rule that names an action at a site that cannot take it raises
``ValueError`` as in the JAX package. Standard library only: the mailbox
worker loads this file by path.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

__all__ = ["InjectedFault", "FaultInjector", "fault_point", "consume_flag",
           "has_site", "consume_grad_action", "GRAD_POISONS",
           "consume_serve_events", "consume_serve_matching",
           "consume_mon_action", "LEND_PHASES", "RECLAIM_PHASES",
           "PORTED_SITES", "reset"]

_SPEC_ENV = "PADDLE_FAULT_SPEC"
_ACTIONS = ("fail", "hang", "kill", "corrupt", "desync", "nan", "inf",
            "spike", "depart", "return", "burst", "slow_host",
            "straggler", "host_crash", "kv_corrupt", "kv_lost",
            "prefix_stale", "adapter_missing", "lent_worker_crash",
            "drop", "dup", "flap", "die", "lend_crash")
_DESYNC_SITES = ("coll",)
_GRAD_ACTIONS = ("nan", "inf", "spike")
_GRAD_SITES = ("grad",)
_RANK_ACTIONS = ("depart", "return")
_RANK_SITES = ("rank",)
_SERVE_ACTIONS = ("burst", "slow_host", "straggler", "host_crash",
                  "kv_corrupt", "kv_lost", "prefix_stale",
                  "adapter_missing", "lent_worker_crash")
_SERVE_SITES = ("serve",)
_MON_ACTIONS = ("drop", "dup")
_MON_SITES = ("mon",)
_CTL_ACTIONS = ("flap", "die", "lend_crash")
_CTL_SITES = ("ctl",)
#: the live-lend phase ladder a ``lend_crash`` arg must name
LEND_PHASES = ("depart", "deliver", "join")
RECLAIM_PHASES = ("drain", "leave", "rejoin")
_CORRUPT_SITES = ("io.save.post",)

_IO_SITES = ("io.save", "io.save.post", "io.load")
_ACP_SITES = ("acp.save", "epoch")

#: the sites the port has fault points for
PORTED_SITES = _SERVE_SITES + _MON_SITES + _IO_SITES + _ACP_SITES \
    + _GRAD_SITES
#: the JAX package's other sites -> the ROADMAP queue A item that ports
#: the code they sit in
_SITE_ITEMS = {
    "coll": "7 (distributed, the comm monitor)",
    "rank": "7 (distributed, resharding)",
    "ctl": "8 (the fleet controller)",
}
#: serve-site events of planes the port does not have yet
_SERVE_NOT_PORTED = {"lent_worker_crash": "8 (the live lend plane)"}


class InjectedFault(IOError):
    """Raised by a ``fail`` rule (an IOError so I/O retry paths see it)."""


class _Rule:
    __slots__ = ("site", "action", "nth", "arg")

    def __init__(self, site: str, action: str, nth: int,
                 arg: Optional[str]):
        self.site = site
        self.action = action
        self.nth = nth
        self.arg = arg


def _not_ported(item: str, rule: str, what: str):
    raise NotImplementedError(
        f"{_SPEC_ENV} rule {rule!r}: {what} has no fault point in the port "
        f"yet: ROADMAP queue A item {item}")


class FaultInjector:
    """Parsed spec and per-site hit counters (one injector per process)."""

    def __init__(self, spec: str = ""):
        self.spec = spec
        self._rules: List[_Rule] = []
        self._counts: Dict[str, int] = {}
        self.flags: set = set()  # armed markers ("grad:nan" ...)
        self.serve_events: List = []  # armed (action, arg|None), ordered
        self.mon_events: List = []  # armed drop/dup bus-line actions
        for item in filter(None, (s.strip() for s in spec.split(","))):
            parts = item.split(":")
            if len(parts) < 3:
                raise ValueError(
                    f"bad {_SPEC_ENV} rule {item!r}: want site:action:nth")
            site, action, nth = parts[0], parts[1], int(parts[2])
            if action not in _ACTIONS:
                raise ValueError(
                    f"bad {_SPEC_ENV} action {action!r} (one of {_ACTIONS})")
            if action == "corrupt":
                if not site.endswith(".post"):
                    site += ".post"
                if site not in _CORRUPT_SITES:
                    raise ValueError(
                        f"corrupt rule targets un-instrumented site "
                        f"{site!r} (path-carrying sites: {_CORRUPT_SITES})")
            for acts, sites, kind in (
                    (("desync",), _DESYNC_SITES, "fingerprint-recording"),
                    (_GRAD_ACTIONS, _GRAD_SITES, "grad-poisoning"),
                    (_RANK_ACTIONS, _RANK_SITES, "rank-event"),
                    (_SERVE_ACTIONS, _SERVE_SITES, "serving-event"),
                    (_MON_ACTIONS, _MON_SITES, "bus-line"),
                    (_CTL_ACTIONS, _CTL_SITES, "controller")):
                if action in acts and site not in sites:
                    raise ValueError(
                        f"{action} rule targets un-instrumented site "
                        f"{site!r} ({kind} sites: {sites})")
            arg = parts[3] if len(parts) > 3 else None
            if action == "lend_crash" and arg is not None \
                    and arg not in LEND_PHASES + RECLAIM_PHASES:
                raise ValueError(
                    f"bad {_SPEC_ENV} lend_crash phase {arg!r} (one of "
                    f"{LEND_PHASES + RECLAIM_PHASES})")
            # the JAX package's grammar holds; now what the port lacks
            if site not in PORTED_SITES:
                _not_ported(_SITE_ITEMS.get(site, "8 (fault points)"),
                            item, f"site {site!r}")
            if action in _SERVE_NOT_PORTED:
                _not_ported(_SERVE_NOT_PORTED[action], item,
                            f"the serve event {action!r}")
            self._rules.append(_Rule(site, action, nth, arg))

    def fire(self, site: str, path: Optional[str] = None) -> None:
        count = self._counts[site] = self._counts.get(site, 0) + 1
        for r in self._rules:
            if r.site != site:
                continue
            if r.action in _GRAD_ACTIONS:
                # a grad poison stays armed for `arg` consecutive calls
                repeat = int(r.arg) if r.arg else 1
                if r.nth <= count < r.nth + repeat:
                    print(f"fault_injection: arming grad:{r.action} at "
                          f"{site} (hit {count})", file=sys.stderr,
                          flush=True)
                    self.flags.add(f"grad:{r.action}")
                continue
            if r.nth == count:
                self._act(r, site, count, path)

    def _act(self, r: _Rule, site, count, path=None):
        tag = f"{site} (hit {count})"
        if r.action == "fail":
            raise InjectedFault(f"injected failure at {tag}")
        if r.action == "kill":
            code = int(r.arg) if r.arg else 17
            print(f"fault_injection: killing process at {tag} "
                  f"exit={code}", file=sys.stderr, flush=True)
            os._exit(code)
        if r.action == "hang" and site in _SERVE_SITES:
            # an event: the targeted worker stops draining its mailbox
            # while its process and telemetry heartbeat stay alive;
            # sleeping here would stall the router's own tick instead
            arg = int(r.arg) if r.arg else None
            print(f"fault_injection: arming serve:hang"
                  f"{'' if arg is None else f':{arg}'} at {tag}",
                  file=sys.stderr, flush=True)
            self.serve_events.append(("hang", arg))
            return
        if r.action == "hang":
            secs = float(r.arg) if r.arg else 3600.0
            print(f"fault_injection: hanging {secs}s at {tag}",
                  file=sys.stderr, flush=True)
            deadline = time.monotonic() + secs
            while time.monotonic() < deadline:
                time.sleep(min(1.0, deadline - time.monotonic() + 0.01))
            return
        if r.action in _SERVE_ACTIONS:
            arg = int(r.arg) if r.arg else None
            print(f"fault_injection: arming serve:{r.action}"
                  f"{'' if arg is None else f':{arg}'} at {tag}",
                  file=sys.stderr, flush=True)
            self.serve_events.append((r.action, arg))
            return
        if r.action in _MON_ACTIONS:
            # consumed by the bus write that fired this hit
            print(f"fault_injection: arming mon:{r.action} at {tag}",
                  file=sys.stderr, flush=True)
            self.mon_events.append(r.action)
            return
        if r.action == "corrupt":
            if path is None:
                return  # the site carries no file: nothing to corrupt
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(size // 2)
            print(f"fault_injection: truncated {path} "
                  f"{size}->{size // 2}B at {tag}",
                  file=sys.stderr, flush=True)


_active: Optional[FaultInjector] = None


def _injector() -> FaultInjector:
    global _active
    spec = os.environ.get(_SPEC_ENV, "")
    if _active is None or _active.spec != spec:
        _active = FaultInjector(spec)
    return _active


def fault_point(site: str, path: Optional[str] = None) -> None:
    """Instrumentation hook: no-op unless a spec rule matches this hit
    (``path``: the file a ``corrupt`` rule truncates)."""
    _injector().fire(site, path)


def consume_flag(flag: str) -> bool:
    """One-shot read of a marker an action armed: True once after the
    rule fires, then cleared."""
    inj = _active
    if inj is not None and flag in inj.flags:
        inj.flags.discard(flag)
        return True
    return False


def has_site(site: str) -> bool:
    """Does the active spec carry any rule for ``site``? ``TrainStep``
    asks once at construction whether to poison gradients at all."""
    return any(r.site == site for r in _injector()._rules)


#: the poison codes ``TrainStep`` consumes: the gradients' factor is
#: [1, NaN, Inf, 1e4][code]
GRAD_POISONS = {"nan": 1, "inf": 2, "spike": 3}


def consume_grad_action() -> int:
    """Fire the ``grad`` site for this step call and consume an armed
    poison: its ``GRAD_POISONS`` code, 0 for a clean step."""
    fault_point("grad")
    for name, code in GRAD_POISONS.items():
        if consume_flag(f"grad:{name}"):
            return code
    return 0


def consume_serve_events() -> List:
    """Fire the ``serve`` site for this router tick / worker poll and
    drain the armed serving events: ordered ``(action, arg)`` pairs
    (``arg`` None when the rule named none)."""
    fault_point("serve")
    inj = _active
    if inj is None or not inj.serve_events:
        return []
    out, inj.serve_events = inj.serve_events, []
    return out


def consume_serve_matching(actions, *, fire: bool = False) -> List:
    """Drain only the armed serve events whose action is in ``actions``,
    leaving the rest for the router and worker. With ``fire`` the serve
    site is hit first, but only when the spec has a rule for one of
    ``actions``: these hooks sit on every submit and every prefix lookup,
    and a spec that never names them keeps its hit arithmetic
    (``serve:burst:2`` still means the second router tick)."""
    if fire:
        inj = _injector()
        if any(r.site == "serve" and r.action in actions
               for r in inj._rules):
            fault_point("serve")
    inj = _active
    if inj is None or not inj.serve_events:
        return []
    out = [e for e in inj.serve_events if e[0] in actions]
    if out:
        inj.serve_events = [e for e in inj.serve_events
                            if e[0] not in actions]
    return out


def consume_mon_action() -> Optional[str]:
    """Fire the ``mon`` site for this bus-row write and consume an armed
    ``drop`` / ``dup``: the action for the current row, or None."""
    fault_point("mon")
    inj = _active
    if inj is None or not inj.mon_events:
        return None
    return inj.mon_events.pop(0)


def reset() -> None:
    """Drop counters and rules (tests re-arm between cases)."""
    global _active
    _active = None
