"""Multi-host SLO-aware request router (counterpart of
``paddle_tpu/serving/router.py``).

The layer above :class:`serving.InferenceEngine`: it spreads requests over
many hosts, refuses work it cannot serve inside the SLO (admission
control), and notices a degraded host from its own telemetry: the
``decode_metrics`` rows every engine writes at its readback cadence
(tokens/s, inflight slots, queue depth, TTFT, pool occupancy) are the
router's scheduling signal.

- **failure detection**: per-host health (``healthy`` -> ``suspect`` ->
  ``dead``, and ``draining`` -> ``retired``) from heartbeat staleness on
  the ``decode_metrics`` cadence and a service deadline
  (``PADDLE_SERVE_HOST_TIMEOUT_MS``: a host with outstanding requests must
  show an ack, progress or completion inside the window), with
  exponential-backoff probation (``PADDLE_SERVE_RETRY_BACKOFF_MS`` base,
  ``PADDLE_SERVE_RETRY_MAX`` probes) before the ``dead`` verdict;
- **token-exact recovery**: the router tracks every admitted request's
  prompt, sampling parameters and the tokens its host has emitted. On a
  dead verdict each in-flight request is resubmitted to a healthy host
  as a resume request (``resume_tokens`` = the emitted prefix, the budget
  decremented, the same rid: a late copy from a recovering host is
  deduplicated, never counted twice);
- **KV migration first**: failover and drain first try to move the
  request's live KV blocks to the survivor (``serving/kv_migration.py``:
  extract through the block table, per-block CRC, splice through
  ``jit.MigrateInsert``), so decode goes on mid-sentence with no prefill.
  In-process hosts hand the bundle across; mailbox hosts answer an
  ``extract`` verb with an ``outbox/kv_<rid>.json`` blob. A broken rung
  (source gone, blob timeout, a block failing its CRC, no survivor
  capacity) writes ``kv_migrate_fail`` naming the cause and falls back to
  the re-prefill resume. ``PADDLE_SERVE_MIGRATE=0`` turns migration off;
- **live drain**: :meth:`Router.drain_host` stops admissions, lets short
  requests finish in place, moves long ones (priced by
  ``kv_migration.migrate_cost_tokens``), then sends the ``drain`` verb;
- **disaggregated prefill**: a :class:`PrefillHost` /
  :class:`FilePrefillHost` runs only the prefill (and the first token) and
  ships the context as a ``KVBundle`` over the same ladder; the router
  places prefills by predicted compute wait and decodes by free slots,
  and any broken rung falls back to colocated admission
  (``disagg_fallbacks``). ``PADDLE_SERVE_DISAGG=0``, or no prefill host,
  serves colocated;
- **graceful degradation**: admission re-checks ``PADDLE_SERVE_ADMIT_*``
  against the surviving fleet, ``router_admit`` rows carry the reason
  (``no_live_host`` / ``queue_full`` / ``ttft_slo`` / ``adapter``), and a
  failed-over request that finds no live host is orphaned and retried
  every tick: shrunk capacity sheds new work, never admitted work.

Pieces: :class:`LocalHost` (an in-process engine, pumped one turn at a
time), :class:`FileHost` (a mailbox to a worker process: ``inbox/*.json``
requests and verbs in, ``outbox/*.json`` results back, stats and health
from the worker's telemetry stream), :class:`Router`, and
:func:`worker_main`, the simulated host worker: standard library only
(it loads the port's bus, fault injector and stream cursor by path, and
imports neither torch nor jax), it "decodes" with the deterministic
:func:`sim_next_token` chain window by window, writes the same telemetry
rows an engine does, honours the ``drain`` / ``cancel`` / ``extract``
verbs and the ``serve`` fault events (``slow_host``, ``straggler``,
``host_crash``, ``hang``).

Run as a script, the worker::

    python paddle_tpu_torch/serving/router.py <repo_root> <mailbox_base> \
        [rate_tokens_per_sec] [poll_s]

with ``PADDLE_TRAINER_ID`` (its rank: it serves ``<mailbox_base>/host{rank}``)
and ``PADDLE_OBS_DIR`` (where its telemetry goes) in its environment.
"""
from __future__ import annotations

import base64
import importlib.util
import itertools
import json
import os
import signal as _signal
import struct
import sys
import time
import zlib
from typing import Dict, List, Optional

__all__ = ["HostStats", "LocalHost", "FileHost", "PrefillHost",
           "FilePrefillHost", "Router", "admit_queue_default",
           "admit_ttft_ms_default", "host_timeout_ms_default",
           "retry_max_default", "retry_backoff_ms_default",
           "disagg_enabled", "sim_next_token", "worker_main"]

#: process-wide trace-id counter: ids are pid-qualified, so the counter
#: must be shared by every Router in the process or two routers over
#: one obs dir would mint colliding ids
_trace_counter = itertools.count(1)

_ADMIT_QUEUE_ENV = "PADDLE_SERVE_ADMIT_QUEUE"
_ADMIT_TTFT_ENV = "PADDLE_SERVE_ADMIT_TTFT_MS"
_HOST_TIMEOUT_ENV = "PADDLE_SERVE_HOST_TIMEOUT_MS"
_RETRY_MAX_ENV = "PADDLE_SERVE_RETRY_MAX"
_RETRY_BACKOFF_ENV = "PADDLE_SERVE_RETRY_BACKOFF_MS"
_DISAGG_ENV = "PADDLE_SERVE_DISAGG"
_ROLE_ENV = "PADDLE_SERVE_ROLE"


def admit_queue_default() -> int:
    """``PADDLE_SERVE_ADMIT_QUEUE`` — max queued requests per host
    before the router refuses new work (default 64)."""
    try:
        return max(int(os.environ.get(_ADMIT_QUEUE_ENV, "64")), 1)
    except ValueError:
        return 64


def admit_ttft_ms_default() -> float:
    """``PADDLE_SERVE_ADMIT_TTFT_MS`` — reject when every host's
    predicted time-to-first-token exceeds this bound (0 = queue-depth
    admission only, the default)."""
    try:
        return max(float(os.environ.get(_ADMIT_TTFT_ENV, "0")), 0.0)
    except ValueError:
        return 0.0


def host_timeout_ms_default() -> float:
    """``PADDLE_SERVE_HOST_TIMEOUT_MS`` — a host with outstanding
    requests that shows no ack/progress/completion for this long is
    SUSPECT (default 2000). The dead verdict additionally needs the
    probation probes below, so total detection latency is roughly
    ``timeout + backoff * (2^1 + .. + 2^retries)``."""
    try:
        return max(float(os.environ.get(_HOST_TIMEOUT_ENV, "2000")), 1.0)
    except ValueError:
        return 2000.0


def retry_max_default() -> int:
    """``PADDLE_SERVE_RETRY_MAX`` — probation probes without a sign of
    service before a suspect host is declared dead (default 3)."""
    try:
        return max(int(os.environ.get(_RETRY_MAX_ENV, "3")), 1)
    except ValueError:
        return 3


def retry_backoff_ms_default() -> float:
    """``PADDLE_SERVE_RETRY_BACKOFF_MS`` — base of the exponential
    probation backoff between probes (default 250)."""
    try:
        return max(float(os.environ.get(_RETRY_BACKOFF_ENV, "250")), 1.0)
    except ValueError:
        return 250.0


def disagg_enabled() -> bool:
    """``PADDLE_SERVE_DISAGG`` — 0 disables disaggregated
    prefill/decode placement even when prefill hosts are configured
    (default 1: configuring a prefill tier opts in)."""
    v = os.environ.get(_DISAGG_ENV, "1").strip().lower()
    return v not in ("0", "false", "off")


# ---------------------------------------------------------------------------
# standalone-safe module loading (the worker runs without the package:
# neither torch nor jax is imported on the serving control plane)
# ---------------------------------------------------------------------------


def _load_rel(modname: str, *parts: str):
    """Load ``paddle_tpu_torch/<parts>`` by path under ``modname``."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(os.path.dirname(here), *parts)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    # registered so the standalone modules can find each other (the
    # bus's mon-fault hook looks the injector up in sys.modules)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def _bus():
    try:
        from ..observability import bus

        return bus
    except ImportError:
        return _load_rel("_pdtpu_torch_obs_bus", "observability", "bus.py")


def _fault():
    try:
        from ..utils import fault_injection

        return fault_injection
    except ImportError:
        return _load_rel("_pdtpu_torch_fault", "utils",
                         "fault_injection.py")


def _monitor():
    try:
        from ..observability import monitor

        return monitor
    except ImportError:
        return _load_rel("_pdtpu_torch_mon", "observability",
                         "monitor.py")


def _kvm():
    # router side only (it imports torch); the worker builds its blobs
    # with the standard library
    from . import kv_migration

    return kv_migration


# ---------------------------------------------------------------------------
# deterministic "greedy" simulation (the mailbox worker's model)
# ---------------------------------------------------------------------------

_SIM_VOCAB = 64


def sim_next_token(ids: List[int]) -> int:
    """The simulated worker's deterministic next-token rule: a mix over the
    WHOLE prefix (prompt + everything emitted), so it behaves like
    greedy decoding — the continuation is a pure function of the
    prefix, and a resumed request (prefix re-fed as prompt+resume)
    continues token-exactly where the dead host stopped. Stdlib-pure on
    purpose; tests and bench recompute the chain as the uninterrupted
    oracle."""
    h = 2166136261
    for j, v in enumerate(ids):
        # position folds in so a run of equal tokens still walks the
        # state — without it a chain that reaches 0 sticks at 0 forever
        h = ((h ^ ((int(v) + 31 * (j + 1)) & 0xFFFF))
             * 16777619) & 0xFFFFFFFF
    return h % _SIM_VOCAB


# ---------------------------------------------------------------------------
# host endpoints
# ---------------------------------------------------------------------------


class HostStats:
    """One host's freshest serving signal, as the router sees it."""

    __slots__ = ("queue_depth", "inflight", "tokens_per_sec", "ttft_ms",
                 "age_s", "submitted")

    def __init__(self, queue_depth=0, inflight=0, tokens_per_sec=None,
                 ttft_ms=None, age_s=None, submitted=0):
        self.queue_depth = queue_depth
        self.inflight = inflight
        self.tokens_per_sec = tokens_per_sec
        self.ttft_ms = ttft_ms
        self.age_s = age_s
        self.submitted = submitted

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


def _req_fields(req) -> dict:
    """Engine Request / plain dict -> the wire fields a host needs.
    ``trace_id`` rides the mailbox row so a worker's span and
    decode_request rows stitch to the router's — the trace follows the
    request across the process boundary. ``resume_tokens`` is the
    failed-over prefix a resumed request re-prefills."""
    if isinstance(req, dict):
        d = dict(req)
        d.setdefault("max_new_tokens", 16)
        return d
    resume = getattr(req, "resume_tokens", None)
    if resume is None:
        resume = []
    return {
        "rid": req.rid,
        "prompt_ids": [int(t) for t in req.prompt_ids],
        "max_new_tokens": req.max_new_tokens,
        "temperature": req.temperature,
        "top_k": req.top_k,
        "top_p": req.top_p,
        "eos_id": req.eos_id,
        "trace_id": getattr(req, "trace_id", None),
        "resume_tokens": [int(t) for t in resume],
        "adapter": int(getattr(req, "adapter", 0) or 0),
    }


class LocalHost:
    """In-process endpoint over one :class:`InferenceEngine`.

    ``can_fail = False``: an in-process engine cannot die independently
    of the router, so the health machinery never puts it on probation
    (an idle tick-loop would otherwise look like a stall). Drain still
    applies — the router just stops admitting and pumps it dry."""

    can_fail = False

    def __init__(self, engine):
        self.engine = engine
        self._submitted = 0
        self._run_results: Dict = {}
        self._done: List[dict] = []
        self._reqs: Dict[object, object] = {}

    def submit(self, req) -> None:
        from .engine import Request

        if isinstance(req, dict):
            d = _req_fields(req)
            req = Request(
                d.get("prompt_ids", [0]),
                max_new_tokens=d["max_new_tokens"],
                temperature=d.get("temperature", 0.0),
                top_k=d.get("top_k", 0), top_p=d.get("top_p", 1.0),
                eos_id=(None if d.get("eos_id", -1) in (-1, None)
                        else d["eos_id"]),
                rid=d.get("rid"), trace_id=d.get("trace_id"),
                resume_tokens=d.get("resume_tokens"),
                adapter=d.get("adapter", 0))
        self._reqs[req.rid] = req
        self.engine.submit(req)
        self._submitted += 1

    def stats(self) -> HostStats:
        # live engine counters — fresher than any bus row could be
        return HostStats(
            queue_depth=self.engine.queue_depth(),
            inflight=self.engine.inflight(),
            age_s=0.0, submitted=self._submitted)

    def pump(self) -> bool:
        """One engine scheduling turn; finished requests move to the
        :meth:`results` queue. Returns True while work remains."""
        more = self.engine.turn(self._run_results)
        self._harvest()
        return more

    def _harvest(self) -> None:
        for rid, res in list(self._run_results.items()):
            del self._run_results[rid]
            req = self._reqs.pop(rid, None)
            resume = ([int(t) for t in req.resume_tokens]
                      if req is not None else [])
            self._done.append({
                "rid": rid,
                # FULL continuation (resume prefix + new tokens): the
                # host-results contract the dedup/reassembly rides on
                "token_ids": resume + [int(t) for t in res.tokens],
                "resumed": len(resume),
                "ttft_ms": res.ttft_ms,
                "latency_ms": res.total_ms,
                "trace_id": getattr(req, "trace_id", None),
            })

    def drain(self) -> Dict:
        out = self.engine.run()
        # back-compat: callers get the GeneratedResult dict, the router
        # still sees the completions through results()
        self._run_results.update(out)
        self._harvest()
        return out

    def results(self) -> List[dict]:
        out, self._done = self._done, []
        return out

    def progress(self) -> Dict[object, List[int]]:
        return self.engine.progress()

    def cancel(self, rid) -> bool:
        self._reqs.pop(rid, None)
        return self.engine.cancel(rid)

    def send_verb(self, verb: str, rid=None) -> None:
        if verb == "cancel":
            self.cancel(rid)
        # "drain" is router-side for an in-process engine: admissions
        # stop and the remaining work is pumped dry

    # -- multi-tenancy -----------------------------------------------------
    def adapter_ok(self, aid) -> bool:
        """Can this host serve adapter ``aid``? (0 — the base model —
        always; otherwise the engine's AdapterSet must hold it.) The
        router's per-host admission check, so a fleet mixing
        adapter-capable and base-only hosts routes around the gap
        instead of crashing a submit."""
        aid = int(aid or 0)
        if aid == 0:
            return True
        ad = getattr(self.engine, "adapters", None)
        return ad is not None and ad.is_loaded(aid)

    def poison_prefix(self, k=None) -> bool:
        """Forward a ``serve:prefix_stale`` bite into the engine's
        prefix cache (False when the host runs without one)."""
        fn = getattr(self.engine, "poison_prefix", None)
        return bool(fn(k)) if fn is not None else False

    # -- KV block migration ------------------------------------------------
    def extract_kv(self, rid, timeout_ms=None):
        """Pull ``rid``'s live KV bundle straight off the engine (the
        in-process transport never waits — ``timeout_ms`` is the wire
        contract shared with :meth:`FileHost.extract_kv`). None when
        the engine has no migratable state for the request — the
        caller's ladder falls back to re-prefill."""
        fn = getattr(self.engine, "extract_kv", None)
        if fn is None:
            return None
        try:
            return fn(rid)
        except Exception:
            # extraction is an optimization rung: a broken source must
            # degrade to re-prefill, never take the router down
            return None

    def insert_kv(self, bundle) -> bool:
        """Splice a migrated bundle into this host's engine; the
        MANIFEST is the resume truth (prefix = resume + emitted,
        budget = what the source had left). False = this pool cannot
        cover it (the router tries the next survivor)."""
        fn = getattr(self.engine, "insert_migrated", None)
        if fn is None:
            return False
        from .engine import Request

        m = bundle.manifest
        prefix = [int(t) for t in (m.get("resume") or [])] + \
            [int(t) for t in (m.get("emitted") or [])]
        req = Request(
            [int(t) for t in m.get("prompt_ids") or []],
            max_new_tokens=int(m.get("budget_left", 0)),
            temperature=float(m.get("temperature", 0.0)),
            top_k=int(m.get("top_k", 0)),
            top_p=float(m.get("top_p", 1.0)),
            eos_id=(None if m.get("eos_id", -1) in (-1, None)
                    else int(m["eos_id"])),
            rid=m.get("rid"), trace_id=m.get("trace_id"),
            resume_tokens=prefix, adapter=int(m.get("adapter", 0)))
        try:
            ok = bool(fn(req, bundle))
        except Exception:
            ok = False
        if not ok:
            return False
        self._reqs[req.rid] = req
        self._submitted += 1
        return True

    def signals(self) -> dict:
        now = time.time()
        return {"live_t": now, "service_t": now,
                "progress": self.progress(), "results": self.results()}


class FileHost:
    """Mailbox endpoint to a worker process: requests (and the
    ``drain``/``cancel``/``extract`` verbs) as one JSON file each under
    ``<dir>/inbox``, results back under ``<dir>/outbox``, stats AND
    health signals from the worker's ``telemetry.rank{N}.jsonl`` stream
    (the SAME rows the engine emits — the router schedules and judges
    liveness on telemetry, not on a private side channel)."""

    can_fail = True

    def __init__(self, host_dir: str, rank: int,
                 obs_dir: Optional[str] = None):
        self.host_dir = host_dir
        self.rank = int(rank)
        self.obs_dir = obs_dir or host_dir
        self.inbox = os.path.join(host_dir, "inbox")
        self.outbox = os.path.join(host_dir, "outbox")
        os.makedirs(self.inbox, exist_ok=True)
        os.makedirs(self.outbox, exist_ok=True)
        self._submitted = 0
        self._verb_n = 0
        # incremental stream tail: the router polls stats per submit
        # AND per tick, and the stream grows one row per worker poll —
        # re-parsing from byte 0 every time would be quadratic over a
        # long-running router, so only freshly appended COMPLETE lines
        # are read and the last decode_metrics row is cached. The
        # cursor machinery is the fleet monitor's: same
        # torn-line and truncation semantics, one implementation.
        self._cursor = _monitor().StreamCursor(self._stream_path())
        self._last_metrics: Optional[dict] = None
        self._last_row_t: Optional[float] = None
        self._service_t: Optional[float] = None
        self._progress: Dict[object, List[int]] = {}

    def submit(self, req) -> None:
        d = _req_fields(req)
        self._submitted += 1
        path = os.path.join(
            self.inbox, f"req_{self._submitted:06d}_{d.get('rid')}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, path)  # atomic: the worker never sees a torn file

    def send_verb(self, verb: str, rid=None) -> None:
        """Drop one control file in the inbox (``drain`` — finish the
        queue, then exit rc 0; ``cancel`` — stop serving ``rid``)."""
        self._verb_n += 1
        d = {"verb": verb}
        if rid is not None:
            d["rid"] = rid
        path = os.path.join(
            self.inbox, f"req_{self._submitted:06d}v{self._verb_n:03d}"
                        f"_{verb}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, path)

    def cancel(self, rid) -> None:
        self.send_verb("cancel", rid)
        # a cancelled request never writes a result row, so results()
        # would never prune its progress entry — drop it now or every
        # signals() snapshot copies it for the host's lifetime
        self._progress.pop(rid, None)

    # -- KV block migration ------------------------------------------------
    def extract_kv(self, rid, timeout_ms=None, _send=True):
        """Ask the worker for ``rid``'s KV bundle: drop an ``extract``
        verb, poll ``outbox/kv_<rid>.json`` until it lands or
        ``timeout_ms`` (default ``PADDLE_SERVE_MIGRATE_TIMEOUT_MS``)
        expires. None on timeout or a torn blob — the caller's ladder
        falls back to re-prefill. ``_send=False`` is the hand of the
        ``serve:kv_lost`` fault: the verb is swallowed so the bundle
        genuinely never arrives and the deadline does the judging."""
        kvm = _kvm()
        if _send:
            self.send_verb("extract", rid)
        if timeout_ms is None:
            timeout_ms = kvm.migrate_timeout_ms_default()
        path = os.path.join(self.outbox, f"kv_{rid}.json")
        deadline = time.time() + float(timeout_ms) / 1e3
        while True:
            if os.path.exists(path):
                try:
                    bundle = kvm.KVBundle.read_blob(path)
                except (OSError, ValueError):
                    return None
                try:
                    os.remove(path)
                except OSError:
                    pass
                self._progress.pop(rid, None)
                return bundle
            if time.time() >= deadline:
                return None
            time.sleep(0.005)

    def insert_kv(self, bundle) -> bool:
        """Hand a migrated request to this worker. The simulated worker
        holds no real device KV — its \"cache\" IS the token chain —
        so the splice degenerates to a resume submit built from the
        bundle's MANIFEST (still the control-plane contract: same rid,
        manifest-fresh prefix, decremented budget, ``migrated`` flag
        on the mailbox row); a real RPC host would ship the leaves."""
        m = bundle.manifest
        prefix = [int(t) for t in (m.get("resume") or [])] + \
            [int(t) for t in (m.get("emitted") or [])]
        if int(m.get("budget_left", 0)) < 1:
            return False
        self.submit({
            "rid": m.get("rid"),
            "prompt_ids": [int(t) for t in m.get("prompt_ids") or []],
            "max_new_tokens": int(m.get("budget_left", 0)),
            "temperature": float(m.get("temperature", 0.0)),
            "top_k": int(m.get("top_k", 0)),
            "top_p": float(m.get("top_p", 1.0)),
            "eos_id": (-1 if m.get("eos_id") is None
                       else int(m.get("eos_id", -1))),
            "trace_id": m.get("trace_id"),
            "resume_tokens": prefix,
            "adapter": int(m.get("adapter", 0)),
            "migrated": True,
        })
        return True

    def adapter_ok(self, aid) -> bool:
        """Mailbox-tier residency check: the simulated worker holds no
        real weights, so the fleet-size knob IS the residency contract
        — ids ``1..PADDLE_SERVE_ADAPTERS-1`` are servable, everything
        else is not (0, the base model, always is)."""
        aid = int(aid or 0)
        if aid == 0:
            return True
        try:
            n = int(os.environ.get("PADDLE_SERVE_ADAPTERS", "0") or 0)
        except ValueError:
            n = 0
        return 1 <= aid < n

    def _stream_path(self) -> str:
        return os.path.join(self.obs_dir,
                            f"telemetry.rank{self.rank}.jsonl")

    def _drain_stream(self) -> None:
        """Fold freshly appended telemetry into the health caches: the
        decode_metrics row is the heartbeat, `worker_ack` /
        `worker_progress` / `decode_request` rows are SERVICE signals —
        a hung worker keeps the first and stops the rest, which is
        exactly the distinction the failure detector needs."""
        now = time.time()
        for rec in self._cursor.poll():
            self._last_row_t = now
            kind = rec.get("kind")
            p = rec.get("payload") or {}
            if kind == "decode_metrics":
                self._last_metrics = rec
            elif kind == "worker_ack":
                self._service_t = now
            elif kind == "worker_progress":
                self._progress[p.get("rid")] = list(p.get("tokens") or [])
                self._service_t = now
            elif kind == "decode_request":
                self._service_t = now

    def stats(self) -> HostStats:
        self._drain_stream()
        last = self._last_metrics
        if last is None:
            return HostStats(age_s=None, submitted=self._submitted)
        p = last.get("payload") or {}
        t = last.get("time")
        return HostStats(
            queue_depth=int(p.get("queue_depth", 0)),
            inflight=int(p.get("inflight_slots", 0)),
            tokens_per_sec=p.get("tokens_per_sec"),
            ttft_ms=p.get("ttft_ms"),
            age_s=(time.time() - t) if isinstance(t, (int, float))
            else None,
            submitted=self._submitted)

    def results(self) -> List[dict]:
        out = []
        for name in sorted(os.listdir(self.outbox)):
            if not name.endswith(".json"):
                continue
            if name.startswith("kv_"):
                continue  # a migration bundle blob, not a result
            path = os.path.join(self.outbox, name)
            try:
                with open(path) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue
            os.remove(path)
        for res in out:
            self._progress.pop(res.get("rid"), None)
        return out

    def progress(self) -> Dict[object, List[int]]:
        self._drain_stream()
        return dict(self._progress)

    def signals(self) -> dict:
        self._drain_stream()
        return {"live_t": self._last_row_t,
                "service_t": self._service_t,
                "progress": dict(self._progress),
                "results": self.results()}


# ---------------------------------------------------------------------------
# prefill-tier endpoints (disaggregated prefill)
# ---------------------------------------------------------------------------


class PrefillHost(LocalHost):
    """In-process PREFILL-ONLY endpoint: runs the
    compute-bound prefill phase on its own engine, then ships the
    finished context out as a `kv_migration.KVBundle` — the SAME
    sealed wire form the migration plane moves, so the decode
    tier's ``insert_kv`` splice, CRC gate, and capacity refusal all
    apply unchanged. The bundle's manifest carries the first token
    (the extract contract includes it in ``emitted``) and the
    decremented budget; the request is CANCELLED here the moment the
    bundle is sealed — the decode host owns it from then on, exactly
    the double-spend rule the extract verb enforces."""

    can_fail = False
    role = "prefill"

    def prefill(self, fields, timeout_ms=None):
        """Run one request's prefill to completion and return
        ``("bundle", KVBundle)`` — or ``("done", result_dict)`` when
        the request finished AT activation (first token hit EOS or a
        budget of one: there is nothing left to decode, so shipping KV
        would be waste). None = this host could not produce either
        (the router's ladder falls back to colocated admission)."""
        from .engine import Request

        d = _req_fields(fields)
        req = Request(
            d.get("prompt_ids", [0]),
            max_new_tokens=d["max_new_tokens"],
            temperature=d.get("temperature", 0.0),
            top_k=d.get("top_k", 0), top_p=d.get("top_p", 1.0),
            eos_id=(None if d.get("eos_id", -1) in (-1, None)
                    else d["eos_id"]),
            rid=d.get("rid"), trace_id=d.get("trace_id"),
            resume_tokens=d.get("resume_tokens"),
            adapter=d.get("adapter", 0))
        try:
            self.engine.submit(req)
        except ValueError:
            return None  # adapter not resident here: fall back
        self._submitted += 1
        results: Dict = {}
        # pump ONLY the prefill half of the engine's turn — advance
        # chunked prefills and fill free slots (activation computes the
        # first token) — never a decode window: every token after the
        # first belongs to the decode tier. A full engine.turn() would
        # decode a whole readback window here first.
        for _ in range(1024):
            self.engine._advance_prefills(results)
            self.engine._fill_free_slots(results)
            if req.rid in results:
                res = results.pop(req.rid)
                return ("done", {
                    "rid": req.rid,
                    "token_ids": [int(t) for t in res.tokens],
                    "resumed": 0,
                    "ttft_ms": res.ttft_ms,
                    "latency_ms": res.total_ms,
                    "trace_id": d.get("trace_id"),
                })
            if self.engine.progress().get(req.rid):
                break
        else:
            self.engine.cancel(req.rid)
            return None
        bundle = self.extract_kv(req.rid, timeout_ms)
        self.cancel(req.rid)
        if bundle is None:
            return None
        return ("bundle", bundle)


class FilePrefillHost(FileHost):
    """Mailbox PREFILL-ONLY endpoint: submits the request to a worker
    running with ``PADDLE_SERVE_ROLE=prefill``, which answers every
    request with a PROACTIVE ``outbox/kv_<rid>.json`` bundle blob
    (one simulated prefill token, no done file) — so no ``extract``
    verb round-trip sits on the handoff's critical path. The arrival
    deadline and CRC gate are the migration ladder's."""

    role = "prefill"

    def prefill(self, fields, timeout_ms=None):
        d = _req_fields(fields)
        self.submit(d)
        bundle = self.extract_kv(d.get("rid"), timeout_ms, _send=False)
        if bundle is None:
            return None
        return ("bundle", bundle)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

#: host health states: healthy -> suspect -> dead on
#: failure; healthy -> draining -> retired on planned maintenance.
HOST_STATES = ("healthy", "suspect", "dead", "draining", "retired")


class _HostHealth:
    __slots__ = ("state", "prior", "live_t", "service_t", "suspect_t",
                 "probes", "next_probe_t", "drain_t", "reason")

    def __init__(self):
        self.state = "healthy"
        self.prior = "healthy"   # state to restore when probation clears
        self.live_t: Optional[float] = None
        self.service_t: Optional[float] = None
        self.suspect_t = 0.0
        self.probes = 0
        self.next_probe_t = 0.0
        self.drain_t = 0.0
        self.reason = ""


class _Tracked:
    """One admitted request as the router remembers it: enough to
    re-submit it token-exactly to another host."""

    __slots__ = ("fields", "rid", "trace_id", "host", "t_submit",
                 "progress", "attempts")

    def __init__(self, fields: dict, trace_id, host: int, now: float):
        self.fields = fields
        self.rid = fields.get("rid")
        self.trace_id = trace_id
        self.host = host
        self.t_submit = now
        self.progress: List[int] = []  # tokens past THIS submission's resume
        self.attempts = 1


class Router:
    """Admission-controlled, SLO-aware, failure-surviving request
    spreading over hosts.

    Scheduling: pick the LIVE (``healthy``) host minimizing PREDICTED
    WAIT — pending work (queued + inflight requests, times the router's
    average new-token estimate) over the host's published tokens/sec;
    hosts that have never published fall back to queue-depth ordering.
    A host whose queue is at ``admit_queue``, and (when
    ``admit_ttft_ms`` > 0) a host whose predicted wait exceeds the TTFT
    SLO, is NOT eligible; when no host is eligible the request is
    REJECTED (returned None, counted, `router_admit` row carries the
    reason) — under a burst or a shrunken fleet the router sheds load
    instead of building an unbounded queue whose every entry misses the
    SLO. In-router bookkeeping (`_pending_guess`) bridges the telemetry
    lag between submits inside one tick.

    Fault tolerance: every admitted request is TRACKED
    (prompt, params, emitted tokens); :meth:`tick` folds host telemetry
    into per-host health state and, on a ``dead`` verdict, re-submits
    the host's in-flight requests to survivors as token-exact resume
    requests under their ORIGINAL ids (late duplicates from a
    recovering host are deduplicated in :attr:`completed`).
    :meth:`drain_host` is the same path as planned maintenance.

    ``serve`` fault-injection events are drained on every
    :meth:`tick`: a ``burst`` submits ``n`` synthetic probe requests
    through the normal admission path (the admission matrix's prey);
    ``slow_host`` / ``straggler`` / ``host_crash`` / ``hang`` are
    consumed by the WORKER side (degradation and death show up here
    through the telemetry they cause — or stop causing — not through a
    flag).
    """

    def __init__(self, hosts, *, admit_queue=None, admit_ttft_ms=None,
                 avg_new_tokens=16, burst_prompt_len=4,
                 burst_new_tokens=None, host_timeout_ms=None,
                 retry_max=None, retry_backoff_ms=None,
                 drain_inplace_tokens=None, migrate_timeout_ms=None,
                 prefill_hosts=None):
        self.hosts = list(hosts)
        if not self.hosts:
            raise ValueError("Router needs at least one host")
        #: the prefill tier: endpoints exposing ``prefill(fields)``
        #: (PrefillHost / FilePrefillHost). Empty = colocated serving;
        #: the ``PADDLE_SERVE_DISAGG`` knob
        #: additionally gates the placement per submit.
        self.prefill_hosts = list(prefill_hosts or [])
        self.admit_queue = (admit_queue_default()
                            if admit_queue is None else int(admit_queue))
        self.admit_ttft_ms = (admit_ttft_ms_default()
                              if admit_ttft_ms is None
                              else float(admit_ttft_ms))
        self.avg_new_tokens = max(int(avg_new_tokens), 1)
        self.burst_prompt_len = int(burst_prompt_len)
        self.burst_new_tokens = (burst_new_tokens
                                 if burst_new_tokens is not None
                                 else self.avg_new_tokens)
        self.host_timeout_ms = (host_timeout_ms_default()
                                if host_timeout_ms is None
                                else float(host_timeout_ms))
        self.retry_max = (retry_max_default() if retry_max is None
                          else max(int(retry_max), 1))
        self.retry_backoff_ms = (retry_backoff_ms_default()
                                 if retry_backoff_ms is None
                                 else float(retry_backoff_ms))
        #: drain policy: requests with at most this many tokens left
        #: finish on the draining host; longer ones migrate
        self.drain_inplace_tokens = (self.avg_new_tokens
                                     if drain_inplace_tokens is None
                                     else int(drain_inplace_tokens))
        #: cross-process bundle arrival deadline; None =
        #: resolve ``PADDLE_SERVE_MIGRATE_TIMEOUT_MS`` per attempt
        self.migrate_timeout_ms = migrate_timeout_ms
        self.admitted = 0
        self.rejected = 0
        self.failovers = 0
        self.duplicates = 0
        self.migrations = 0       # recovery moves that spliced KV
        self.migrate_failed = 0   # ladder falls to re-prefill
        self.migrate_blocks = 0   # blocks moved (bench: report-only)
        self.migrate_bytes = 0    # bytes moved (bench: report-only)
        self.disagg_prefills = 0  # handoffs that spliced a prefill bundle
        self.disagg_fallbacks = 0  # broken rungs -> colocated admission
        self._ticks = 0
        self._burst_rid = 0
        #: armed serve:kv_corrupt / serve:kv_lost faults, consumed one
        #: per migration attempt (the router's side of the serve site)
        self._kv_faults: List = []
        #: armed serve:adapter_missing faults, consumed one per submit
        #: (each rewrites that submit's adapter id to an unloaded one)
        self._adapter_faults: List = []
        # submits this router made that the host telemetry cannot have
        # absorbed yet; decays when a fresher stats row shows up
        self._pending_guess = [0] * len(self.hosts)
        self._last_submit_t = [0.0] * len(self.hosts)
        self._health = [_HostHealth() for _ in self.hosts]
        self._tracked: Dict[object, _Tracked] = {}
        self._orphans: List[_Tracked] = []
        #: rid -> result dict (token_ids reassembled across hosts);
        #: the dedup point for idempotent re-submits. Bounded: past
        #: ``completed_max`` the oldest results are evicted to a
        #: rid-only tombstone set, so a long-running router's memory
        #: tracks the working set, not total request history, while
        #: dedup of arbitrarily late duplicates keeps working
        self.completed: Dict[object, dict] = {}
        self.completed_max = 4096
        self._completed_rids: set = set()

    # -- introspection ------------------------------------------------------
    def host_state(self, idx: int) -> str:
        return self._health[idx].state

    def inflight(self) -> int:
        return len(self._tracked) + len(self._orphans)

    def outstanding(self, idx: Optional[int] = None) -> List[object]:
        """rids tracked on one host (or orphaned, for ``idx=None``)."""
        if idx is None:
            return [e.rid for e in self._orphans]
        return [rid for rid, e in self._tracked.items()
                if e.host == idx]

    # -- request-scoped tracing --------------------------------------------
    def _stamp_trace(self, req):
        """Give the request a trace id (unless the caller brought one):
        the key every downstream span — FileHost mailbox row, engine
        admission/prefill/decode-window/retire events, decode_request —
        carries, so the monitor and tools/timeline.py can render one
        request's life across processes. pid-qualified so ids from
        several routers over one obs dir never collide."""
        if isinstance(req, dict):
            tid = req.get("trace_id")
            if not tid:
                tid = req["trace_id"] = self._new_trace_id()
            return tid, req.get("rid")
        tid = getattr(req, "trace_id", None)
        if not tid:
            tid = req.trace_id = self._new_trace_id()
        return tid, getattr(req, "rid", None)

    def _new_trace_id(self) -> str:
        return f"t{os.getpid():x}-{next(_trace_counter):05d}"

    # -- scheduling --------------------------------------------------------
    def _predicted_wait_ms(self, st: HostStats, extra: int) -> float:
        pending = st.queue_depth + st.inflight + extra
        if st.tokens_per_sec and st.tokens_per_sec > 0:
            return (pending * self.avg_new_tokens /
                    st.tokens_per_sec) * 1e3
        # no throughput signal yet: rank by pending work alone (1ms per
        # pending request keeps the units comparable)
        return float(pending)

    def _live(self, idx: int) -> bool:
        return self._health[idx].state == "healthy"

    def _ineligible_why(self, idx: int, st: HostStats,
                        aid: int = 0) -> Optional[str]:
        if not self._live(idx):
            return "not_live"
        if aid:
            ok_fn = getattr(self.hosts[idx], "adapter_ok", None)
            if ok_fn is not None and not ok_fn(aid):
                # the host cannot serve this fine-tune: a CLEAN
                # admission reason, never a submit crash
                return "adapter"
        depth = st.queue_depth + self._pending_guess[idx]
        if depth >= self.admit_queue:
            return "queue_full"
        if self.admit_ttft_ms > 0 and self._predicted_wait_ms(
                st, self._pending_guess[idx]) > self.admit_ttft_ms:
            return "ttft_slo"
        return None

    def _refresh_guess(self, idx: int, st: HostStats) -> None:
        # a stats row OBSERVED after our last submit already counts
        # that submit in its queue depth — stop double counting
        if st.age_s is not None and (
                time.time() - st.age_s) >= self._last_submit_t[idx]:
            self._pending_guess[idx] = 0

    def submit(self, req) -> Optional[int]:
        """Route one request; returns the host index, or None when
        admission control rejected it (no live host under its limits).
        Stamps a ``trace_id`` (the root of its span chain) and TRACKS
        the admitted request for failover."""
        tid, rid = self._stamp_trace(req)
        fields = _req_fields(req)
        if fields.get("rid") is None:
            # tracking (and idempotent failover) needs a stable id even
            # for anonymous dict requests
            fields["rid"] = rid = f"r{os.getpid():x}-{next(_trace_counter)}"
        # an armed serve:adapter_missing fault rewrites THIS
        # submit to an unloaded adapter id — admission must reject it
        # cleanly (reason "adapter"), never crash a compiled step
        for _, arg in _fault().consume_serve_matching(
                ("adapter_missing",), fire=True):
            self._adapter_faults.append(arg)
        if self._adapter_faults:
            arg = self._adapter_faults.pop(0)
            fields["adapter"] = int(arg) if arg else 1_000_000
        now = time.time()
        entry = _Tracked(fields, tid, -1, now)
        placed = None
        if self._disagg_eligible(fields):
            placed = self._submit_disagg(entry, now)
        if placed is None:
            placed = self._route(entry, now)
        if placed is None:
            self.rejected += 1
            return None
        # counted HERE, not in _route: failover/orphan re-submissions
        # re-place work that was already admitted once — admitted vs
        # completed must reconcile per request, not per placement
        self.admitted += 1
        return placed

    def _route(self, entry: _Tracked, now: float,
               emit_reject: bool = True) -> Optional[int]:
        """The shared scheduling core for fresh submits AND failover
        re-submits: choose among live, in-bounds hosts; on success the
        entry is tracked on its host. Rejections emit the `router_admit`
        row with the reason the surviving fleet gave."""
        stats = []
        reasons = []
        aid = int(entry.fields.get("adapter", 0) or 0)
        for i, h in enumerate(self.hosts):
            st = h.stats()
            self._refresh_guess(i, st)
            stats.append(st)
            reasons.append(self._ineligible_why(i, st, aid))
        candidates = [i for i, why in enumerate(reasons) if why is None]
        if not candidates:
            if emit_reject:
                live = [w for w in reasons if w != "not_live"]
                reason = ("no_live_host" if not live
                          else "+".join(sorted(set(live))))
                self._emit_admit(None, stats, entry.trace_id, entry.rid,
                                 reason)
            return None
        best = min(candidates, key=lambda i: self._predicted_wait_ms(
            stats[i], self._pending_guess[i]))
        # the prediction that actually drove the choice — captured
        # BEFORE this submit bumps the pending guess
        predicted = self._predicted_wait_ms(stats[best],
                                            self._pending_guess[best])
        self.hosts[best].submit(dict(entry.fields))
        entry.host = best
        entry.t_submit = now
        entry.progress = []
        self._tracked[entry.rid] = entry
        self._pending_guess[best] += 1
        self._last_submit_t[best] = time.time()
        self._emit_span(entry.trace_id, entry.rid, best, predicted)
        return best

    # -- disaggregated prefill/decode --------------------------------------
    def _disagg_eligible(self, fields: dict) -> bool:
        """Disaggregate only FRESH compute-bound work: a configured
        prefill tier, the knob on, a real decode budget (a one-token
        request has nothing to hand off), and no resume prefix (a
        failover/migration re-submit already carries its context — the
        recovery ladders own those)."""
        return (bool(self.prefill_hosts) and disagg_enabled()
                and int(fields.get("max_new_tokens", 16)) > 1
                and not fields.get("resume_tokens"))

    def _submit_disagg(self, entry: _Tracked, now: float) -> Optional[int]:
        """Place one request disaggregated: prefill on the tier host
        with the lowest predicted COMPUTE wait, decode on the eligible
        decode host with the most free SLOTS (fewest queued+inflight),
        handing the context across as a CRC-gated KVBundle — the
        migration ladder. ANY broken rung (no bundle inside
        the deadline, a block failing CRC, every decode pool refusing
        the splice) returns None and the caller falls back to ordinary
        colocated admission: disaggregation changes WHERE the prefill
        burns compute, never whether a request survives."""
        t0 = time.perf_counter()
        order = sorted(
            range(len(self.prefill_hosts)),
            key=lambda i: self._predicted_wait_ms(
                self.prefill_hosts[i].stats(), 0))
        outcome = None
        pi = None
        for i in order:
            try:
                outcome = self.prefill_hosts[i].prefill(
                    dict(entry.fields), self.migrate_timeout_ms)
            except OSError:
                outcome = None
            if outcome is not None:
                pi = i
                break
        if outcome is None:
            self.disagg_fallbacks += 1
            return None
        kind, payload = outcome
        if kind == "done":
            # the prefill's first token ended the request (EOS at
            # activation): the prefill host's result IS the answer
            self._complete(len(self.hosts) + pi, payload)
            self._emit_span(entry.trace_id, entry.rid,
                            len(self.hosts) + pi, 0.0)
            return len(self.hosts) + pi
        bundle = payload
        if bundle.verify():
            self.disagg_fallbacks += 1
            return None  # a torn handoff re-prefills colocated
        m = bundle.manifest
        prefix = [int(t) for t in (m.get("resume") or [])] + \
            [int(t) for t in (m.get("emitted") or [])]
        aid = int(entry.fields.get("adapter", 0) or 0)
        stats, reasons = [], []
        for i, h in enumerate(self.hosts):
            st = h.stats()
            self._refresh_guess(i, st)
            stats.append(st)
            reasons.append(self._ineligible_why(i, st, aid))
        # decode placement ranks by SLOT availability (occupancy), not
        # compute wait: the prefill is already paid, what the decode
        # tier contributes is a free slot's steady token cadence
        decode_order = sorted(
            (i for i, why in enumerate(reasons)
             if why is None and hasattr(self.hosts[i], "insert_kv")),
            key=lambda i: (stats[i].queue_depth + stats[i].inflight
                           + self._pending_guess[i]))
        placed = None
        for i in decode_order:
            try:
                if self.hosts[i].insert_kv(bundle):
                    placed = i
                    break
            except OSError:
                continue
        if placed is None:
            self.disagg_fallbacks += 1
            return None  # every pool refused: colocated can QUEUE
        fields = dict(entry.fields)
        fields["resume_tokens"] = prefix
        fields["max_new_tokens"] = int(m.get("budget_left", 0))
        entry.fields = fields
        entry.host = placed
        entry.t_submit = now
        entry.progress = []
        self._tracked[entry.rid] = entry
        self._pending_guess[placed] += 1
        self._last_submit_t[placed] = time.time()
        self.disagg_prefills += 1
        bus = _bus()
        if bus.enabled():
            bus.emit_span("disagg_prefill", entry.trace_id, {
                "rid": entry.rid,
                "prefill_host": pi,
                "to_host": placed,
                "blocks": bundle.n_blocks,
                "bytes": bundle.nbytes,
                "ctx": int(m.get("ctx", 0)),
                "dur_ms": round((time.perf_counter() - t0) * 1e3, 3),
            }, step=self._ticks)
        self._emit_span(entry.trace_id, entry.rid, placed,
                        self._predicted_wait_ms(
                            stats[placed], self._pending_guess[placed]))
        return placed

    # -- control loop ------------------------------------------------------
    def tick(self) -> List[Optional[int]]:
        """One scheduling tick: drain armed ``serve`` fault events
        (each ``burst`` submits its synthetic requests through normal
        admission), fold host telemetry into health state, fail over
        the in-flight requests of hosts that crossed the dead line,
        finish drains, retry orphans, and publish `router_metrics`.
        Returns the burst routing outcomes (host index or None per
        synthetic request)."""
        self._ticks += 1
        outcomes: List[Optional[int]] = []
        for action, arg in self._consume_serve():
            n = int(arg) if arg else 8
            for _ in range(n):
                self._burst_rid += 1
                outcomes.append(self.submit({
                    "rid": f"burst{self._burst_rid}",
                    "prompt_ids": list(range(self.burst_prompt_len)),
                    "max_new_tokens": self.burst_new_tokens,
                }))
        now = time.time()
        self._poll_hosts(now)
        self._evaluate_health(now)
        self._finish_drains(now)
        self._resubmit_orphans(now)
        self._emit_metrics()
        return outcomes

    def _consume_serve(self) -> List:
        """Drain armed ``serve`` events on the ROUTER's side of the
        site: ``burst`` pairs are returned for :meth:`tick` to submit;
        ``kv_corrupt`` / ``kv_lost`` are stashed for the next migration
        attempt; ``prefix_stale`` is forwarded into every
        host exposing a prefix cache and ``adapter_missing`` is stashed
        for the next submit; the worker-side actions
        (slow_host, straggler, host_crash, hang) are dropped — each
        worker process drains its own injector."""
        out: List = []
        for action, arg in _fault().consume_serve_events():
            if action in ("kv_corrupt", "kv_lost"):
                self._kv_faults.append((action, arg))
            elif action == "prefix_stale":
                for h in list(self.hosts) + list(self.prefill_hosts):
                    fn = getattr(h, "poison_prefix", None)
                    if fn is not None:
                        fn(arg)
            elif action == "adapter_missing":
                self._adapter_faults.append(arg)
            elif action == "burst":
                out.append((action, arg))
        return out

    # -- health: signal folding --------------------------------------------
    def _poll_hosts(self, now: float) -> None:
        for i, h in enumerate(self.hosts):
            sig_fn = getattr(h, "signals", None)
            if sig_fn is None:
                continue
            sig = sig_fn() or {}
            hh = self._health[i]
            lt = sig.get("live_t")
            if isinstance(lt, (int, float)):
                hh.live_t = lt if hh.live_t is None else max(hh.live_t, lt)
            st = sig.get("service_t")
            if isinstance(st, (int, float)):
                hh.service_t = (st if hh.service_t is None
                                else max(hh.service_t, st))
            for rid, toks in (sig.get("progress") or {}).items():
                e = self._tracked.get(rid)
                if e is None or e.host != i:
                    continue  # a late copy on an abandoned host: ignore
                if len(toks) > len(e.progress):
                    e.progress = [int(t) for t in toks]
                    hh.service_t = now
            for res in sig.get("results") or ():
                self._complete(i, res)
                hh.service_t = now

    def _complete(self, host_idx: int, res: dict) -> None:
        """Fold one host result in. ``token_ids`` is the FULL
        continuation (resume prefix + new tokens), so results from the
        original and the failed-over submission are directly
        comparable — first one wins, the rest count as duplicates (the
        idempotent-rid contract)."""
        rid = res.get("rid")
        if rid in self.completed or rid in self._completed_rids:
            self.duplicates += 1
            e = self._tracked.pop(rid, None)
            if e is not None and e.host != host_idx:
                # a third copy is still running somewhere: withdraw it
                self._cancel_on_host(e.host, rid)
            return
        e = self._tracked.pop(rid, None)
        out = {
            "rid": rid,
            "tokens": [int(t) for t in res.get("token_ids") or []],
            "host": host_idx,
            "resumed": int(res.get("resumed", 0)),
            "trace_id": (e.trace_id if e is not None
                         else res.get("trace_id")),
        }
        for k in ("ttft_ms", "latency_ms", "rank"):
            if k in res:
                out[k] = res[k]
        self.completed[rid] = out
        while len(self.completed) > self.completed_max:
            old = next(iter(self.completed))  # oldest: insertion order
            del self.completed[old]
            self._completed_rids.add(old)
        if e is not None and e.host != host_idx:
            # the ORIGINAL host recovered and finished first: withdraw
            # the failed-over copy so the survivor stops wasting work
            self._cancel_on_host(e.host, rid)

    def _cancel_on_host(self, idx: int, rid) -> None:
        if idx is None or not (0 <= idx < len(self.hosts)):
            return
        h = self.hosts[idx]
        try:
            if hasattr(h, "cancel"):
                h.cancel(rid)
            elif hasattr(h, "send_verb"):
                h.send_verb("cancel", rid)
        except OSError:
            pass  # best-effort: dedup already guarantees correctness

    # -- health: evaluation ------------------------------------------------
    def _evaluate_health(self, now: float) -> None:
        for i, h in enumerate(self.hosts):
            if not getattr(h, "can_fail", True):
                continue
            hh = self._health[i]
            if hh.state in ("dead", "retired"):
                continue
            outstanding = [e for e in self._tracked.values()
                           if e.host == i]
            if hh.state in ("healthy", "draining"):
                if not outstanding:
                    continue
                # the host owes a sign of service within the timeout of
                # either its last service signal or the moment the
                # oldest outstanding request reached it
                ref = max([hh.service_t or 0.0] +
                          [min(e.t_submit for e in outstanding)])
                stall_ms = (now - ref) * 1e3
                if stall_ms <= self.host_timeout_ms:
                    continue
                hh.prior = hh.state
                hh.state = "suspect"
                hh.suspect_t = now
                hh.probes = 0
                hh.next_probe_t = now + self.retry_backoff_ms / 1e3
                live_stale = (hh.live_t is None or
                              (now - hh.live_t) * 1e3 >
                              self.host_timeout_ms)
                hh.reason = ("silent" if live_stale else "unresponsive")
                self._emit_host_event("router_host_suspect", i, hh,
                                      stall_ms=round(stall_ms, 1),
                                      inflight=len(outstanding))
            elif hh.state == "suspect":
                if hh.service_t is not None and \
                        hh.service_t > hh.suspect_t:
                    # a sign of service during probation: stand down
                    hh.state = hh.prior
                    hh.probes = 0
                    self._emit_host_event("router_host_recovered", i, hh)
                    continue
                if now < hh.next_probe_t:
                    continue
                hh.probes += 1
                if hh.probes >= self.retry_max:
                    self._declare_dead(i, now)
                else:
                    hh.next_probe_t = now + (
                        self.retry_backoff_ms / 1e3) * (2 ** hh.probes)

    def _declare_dead(self, idx: int, now: float) -> None:
        h = self.hosts[idx]
        hh = self._health[idx]
        hh.state = "dead"
        # re-judge liveness at VERDICT time: at suspicion the heartbeat
        # of a just-crashed host is only borderline-stale, but by now a
        # crash has been silent for the whole probation — only a hang
        # (alive, not serving) still shows a fresh heartbeat
        live_stale = (hh.live_t is None or
                      (now - hh.live_t) * 1e3 > self.host_timeout_ms)
        hh.reason = "silent" if live_stale else "unresponsive"
        victims = [e for e in self._tracked.values() if e.host == idx]
        bus = _bus()
        if bus.enabled():
            bus.emit("router_host_dead", {
                "host": idx,
                "host_rank": getattr(h, "rank", None),
                "reason": hh.reason,
                "silent_ms": round((now - hh.suspect_t) * 1e3
                                   + self.host_timeout_ms, 1),
                "probes": hh.probes,
                "inflight": len(victims),
            }, step=self._ticks)
        for e in victims:
            self._failover(e, idx, now, kind="failover")
        if victims and bus.enabled():
            bus.emit("router_failover", {
                "host": idx, "requests": len(victims),
                "orphaned": len(self._orphans),
            }, step=self._ticks)

    # -- failover / resume --------------------------------------------------
    def _failover(self, e: _Tracked, from_host: int, now: float, *,
                  kind: str) -> Optional[int]:
        """Move one in-flight request off ``from_host``: first try the
        KV block migration (recompute-free — the survivor
        splices the source's cache and decodes on), else the re-prefill
        resume path: prefix = old resume + everything the host emitted,
        budget decremented, SAME rid (idempotent — a recovering host's
        late copy deduplicates instead of double-serving)."""
        self._tracked.pop(e.rid, None)
        prefix = list(e.fields.get("resume_tokens") or []) + \
            [int(t) for t in e.progress]
        budget_left = int(e.fields.get("max_new_tokens", 0)) - \
            len(e.progress)
        span_payload = {
            "rid": e.rid,
            "from_host": from_host,
            "resumed": len(prefix),
            # the slice: how long the request lived on the abandoned
            # host (timeline renders it on the request's trace lane)
            "dur_ms": round((now - e.t_submit) * 1e3, 3),
        }
        eos = e.fields.get("eos_id")
        hit_eos = (eos is not None and eos != -1 and eos in e.progress)
        if budget_left <= 0 or hit_eos:
            # the host died (or drained) with the request effectively
            # finished: the recovered prefix IS the answer
            self.completed.setdefault(e.rid, {
                "rid": e.rid, "tokens": prefix, "host": from_host,
                "resumed": len(prefix) - len(e.progress),
                "trace_id": e.trace_id,
            })
            if kind == "drain":
                self._cancel_on_host(from_host, e.rid)
            span_payload["to_host"] = None
            span_payload["completed_from_progress"] = True
            self._emit_fail_span(kind, e.trace_id, span_payload)
            return None
        if _kvm().migrate_enabled():
            placed = self._try_migrate(e, from_host, now, kind=kind,
                                       span_payload=span_payload)
            if placed is not None:
                return placed
        # re-prefill resume — the asserted fallback rung
        if kind == "drain":
            self._cancel_on_host(from_host, e.rid)
        fields = dict(e.fields)
        fields["resume_tokens"] = prefix
        fields["max_new_tokens"] = budget_left
        e.fields = fields
        e.progress = []
        e.host = -1
        e.attempts += 1
        self.failovers += 1
        placed = self._route(e, now)
        span_payload["to_host"] = placed
        self._emit_fail_span(kind, e.trace_id, span_payload)
        if placed is None:
            # no live host right now: ORPHANED, retried every tick —
            # shrunk capacity sheds NEW work, never admitted work
            self._orphans.append(e)
        return placed

    # -- KV block migration -------------------------------------------------
    def _try_migrate(self, e: _Tracked, from_host: int, now: float, *,
                     kind: str, span_payload: dict) -> Optional[int]:
        """The recompute-free rung of the recovery ladder: pull the
        request's KV bundle off the source, CRC-gate it, splice it into
        the best eligible survivor, and re-track the request there with
        the bundle MANIFEST as the resume truth (the extract-side
        snapshot is at least as fresh as the router's progress rows).
        Every failure emits `kv_migrate_fail` naming the cause
        (``source_dead`` / ``timeout`` / ``lost`` / ``crc`` + block /
        ``no_capacity``) and returns None — the caller re-prefills.
        Armed ``serve:kv_corrupt`` / ``serve:kv_lost`` faults bite
        here, one per migration attempt."""
        src = (self.hosts[from_host]
               if 0 <= from_host < len(self.hosts) else None)
        if src is None or not hasattr(src, "extract_kv"):
            return None  # no migration plane on this endpoint
        if not e.progress and not e.fields.get("resume_tokens"):
            # nothing decoded yet (still queued / mid-prefill): there
            # is no KV worth moving and re-prefill costs nothing extra
            return None
        hh = self._health[from_host]
        if hh.state == "dead" and hh.reason == "silent":
            # heartbeat gone = process (and its device state) gone:
            # there is nothing to extract — the asserted degradation
            # case, not worth burning the blob deadline on
            self._emit_migrate_fail(e, from_host, "source_dead", None)
            return None
        t0 = time.perf_counter()
        fault = self._kv_faults.pop(0) if self._kv_faults else None
        bundle = None
        reason = "timeout"
        block = None
        if fault is not None and fault[0] == "kv_lost":
            # the bundle never arrives: a mailbox source burns the real
            # arrival deadline (suppressed verb -> poll -> timeout); an
            # in-process source has no wire to lose it on, so the loss
            # reports synchronously
            if getattr(src, "inbox", None) is not None:
                bundle = src.extract_kv(e.rid, self.migrate_timeout_ms,
                                        _send=False)
            else:
                reason = "lost"
        else:
            try:
                bundle = src.extract_kv(e.rid, self.migrate_timeout_ms)
            except OSError:
                reason = "error"
        if bundle is not None:
            if fault is not None and fault[0] == "kv_corrupt":
                block = bundle.flip_bit(fault[1])
            bad = bundle.verify()
            if bad:
                reason, block = "crc", bad[0]
                bundle = None
        if bundle is None:
            self._emit_migrate_fail(e, from_host, reason, block)
            return None
        m = bundle.manifest
        prefix = [int(t) for t in (m.get("resume") or [])] + \
            [int(t) for t in (m.get("emitted") or [])]
        budget_left = int(m.get("budget_left", 0))
        # survivor choice mirrors _route (live, in admission bounds,
        # lowest predicted wait) but probes the SPLICE host by host: a
        # pool that cannot cover the blocks refuses and the next
        # candidate is tried — only when every survivor refuses does
        # the ladder fall to re-prefill, which can QUEUE where a
        # splice cannot
        stats, reasons = [], []
        for i, h in enumerate(self.hosts):
            st = h.stats()
            self._refresh_guess(i, st)
            stats.append(st)
            reasons.append(self._ineligible_why(i, st))
        order = sorted(
            (i for i, why in enumerate(reasons)
             if why is None and i != from_host
             and hasattr(self.hosts[i], "insert_kv")),
            key=lambda i: self._predicted_wait_ms(
                stats[i], self._pending_guess[i]))
        placed = None
        for i in order:
            try:
                if self.hosts[i].insert_kv(bundle):
                    placed = i
                    break
            except OSError:
                continue
        if placed is None:
            self._emit_migrate_fail(e, from_host, "no_capacity", None)
            return None
        fields = dict(e.fields)
        fields["resume_tokens"] = prefix
        fields["max_new_tokens"] = budget_left
        e.fields = fields
        e.progress = []
        e.host = placed
        e.t_submit = now
        e.attempts += 1
        self._tracked[e.rid] = e
        self._pending_guess[placed] += 1
        self._last_submit_t[placed] = time.time()
        self.failovers += 1
        self.migrations += 1
        self.migrate_blocks += bundle.n_blocks
        self.migrate_bytes += bundle.nbytes
        # the source stops wasting work (and frees the blocks) the
        # moment the survivor owns the request
        self._cancel_on_host(from_host, e.rid)
        bus = _bus()
        if bus.enabled():
            # begin->commit duration slice on the request's trace lane
            bus.emit_span("kv_migrate", e.trace_id, {
                "rid": e.rid, "from_host": from_host, "to_host": placed,
                "kind": kind, "blocks": bundle.n_blocks,
                "bytes": bundle.nbytes, "resumed": len(prefix),
                "budget_left": budget_left,
                "dur_ms": round((time.perf_counter() - t0) * 1e3, 3),
            }, step=self._ticks)
        span_payload["to_host"] = placed
        span_payload["migrated"] = True
        span_payload["resumed"] = len(prefix)
        self._emit_fail_span(kind, e.trace_id, span_payload)
        return placed

    def _emit_migrate_fail(self, e: _Tracked, from_host: int,
                           reason: str, block) -> None:
        """One `kv_migrate_fail` row per broken ladder rung — the
        incident correlator folds it into the chain NAMING the failed
        block (reason ``crc``) or the missing bundle (``timeout`` /
        ``lost`` / ``source_dead`` / ``no_capacity``)."""
        self.migrate_failed += 1
        bus = _bus()
        if not bus.enabled():
            return
        payload = {"rid": e.rid, "from_host": from_host,
                   "reason": reason, "trace_id": e.trace_id}
        if block is not None:
            payload["block"] = int(block)
        bus.emit("kv_migrate_fail", payload, step=self._ticks)

    def _resubmit_orphans(self, now: float) -> None:
        if not self._orphans:
            return
        pending, self._orphans = self._orphans, []
        for e in pending:
            if e.rid in self.completed or e.rid in self._completed_rids:
                continue  # a recovering host delivered meanwhile
            # emit_reject=False: the shed-load row fired when the
            # request was orphaned; re-emitting a NOTABLE rejected row
            # per orphan per tick would flood the bus and the incident
            # correlator during an outage
            if self._route(e, now, emit_reject=False) is None:
                self._orphans.append(e)

    # -- drain --------------------------------------------------------------
    def drain_host(self, idx: int) -> dict:
        """Live drain: stop admissions to host ``idx``, let
        short requests finish in place, move long ones (KV
        block migration first, resume re-prefill as the fallback,
        cancelling them on the drainer either way), and send the
        ``drain`` verb so the worker retires rc 0 once its queue is
        empty. The in-place/move boundary is COST-BASED: a request
        moves only when its remaining tokens exceed both
        ``drain_inplace_tokens`` and the priced transfer
        (`kv_migration.migrate_cost_tokens` over its context) — a
        request a few tokens from done finishes in place even when its
        long context would make the move dearer than the remainder.
        Returns a summary dict; the host reaches ``retired`` state on
        the tick that sees its last outstanding request finish."""
        if not (0 <= idx < len(self.hosts)):
            raise ValueError(f"no host {idx}")
        hh = self._health[idx]
        if hh.state in ("dead", "retired"):
            raise ValueError(
                f"host {idx} is {hh.state}; nothing to drain")
        kvm = _kvm()
        now = time.time()
        # fold the freshest progress in first: migration resumes from
        # what the host actually emitted, not a stale view
        self._poll_hosts(now)
        hh.state = "draining"
        hh.prior = "draining"
        hh.drain_t = now
        migrated, in_place = 0, 0
        for e in [t for t in self._tracked.values() if t.host == idx]:
            left = int(e.fields.get("max_new_tokens", 0)) - \
                len(e.progress)
            threshold = float(self.drain_inplace_tokens)
            if kvm.migrate_enabled():
                ctx = (len(e.fields.get("prompt_ids") or []) +
                       len(e.fields.get("resume_tokens") or []) +
                       len(e.progress))
                threshold = max(threshold, kvm.migrate_cost_tokens(ctx))
            if left > threshold:
                self._failover(e, idx, now, kind="drain")
                migrated += 1
            else:
                in_place += 1
        h = self.hosts[idx]
        if hasattr(h, "send_verb"):
            h.send_verb("drain")
        bus = _bus()
        if bus.enabled():
            bus.emit("router_drain", {
                "host": idx,
                "host_rank": getattr(h, "rank", None),
                "migrated": migrated,
                "in_place": in_place,
            }, step=self._ticks)
        return {"host": idx, "migrated": migrated, "in_place": in_place}

    def _finish_drains(self, now: float) -> None:
        for i, hh in enumerate(self._health):
            if hh.state != "draining":
                continue
            if any(e.host == i for e in self._tracked.values()):
                continue
            hh.state = "retired"
            bus = _bus()
            if bus.enabled():
                bus.emit("router_host_retired", {
                    "host": i,
                    "host_rank": getattr(self.hosts[i], "rank", None),
                    "drain_ms": round((now - hh.drain_t) * 1e3, 1),
                }, step=self._ticks)

    # -- telemetry ---------------------------------------------------------
    def _emit_metrics(self) -> None:
        bus = _bus()
        if not bus.enabled():
            return
        payload = {
            "hosts": len(self.hosts),
            "admitted": self.admitted,
            "rejected": self.rejected,
            "failovers": self.failovers,
            "duplicates": self.duplicates,
            "migrations": self.migrations,
            "migrate_failed": self.migrate_failed,
            "orphans": len(self._orphans),
        }
        if self.prefill_hosts:
            payload["prefill_hosts"] = len(self.prefill_hosts)
            payload["disagg_prefills"] = self.disagg_prefills
            payload["disagg_fallbacks"] = self.disagg_fallbacks
        total = 0
        for i, h in enumerate(self.hosts):
            st = h.stats()
            # the guess bridges telemetry lag WITHIN a tick; once the
            # host's stats postdate our last submit they already count
            # it — published depth must not double-count indefinitely
            # (it feeds the fleet controller's queue pressure)
            self._refresh_guess(i, st)
            depth = st.queue_depth + self._pending_guess[i]
            payload[f"host{i}_queue_depth"] = depth
            payload[f"host{i}_state"] = self._health[i].state
            total += depth
        payload["queue_depth_total"] = total
        bus.emit("router_metrics", payload, step=self._ticks)

    def _emit_host_event(self, kind: str, idx: int, hh: _HostHealth,
                         **extra) -> None:
        bus = _bus()
        if not bus.enabled():
            return
        payload = {"host": idx,
                   "host_rank": getattr(self.hosts[idx], "rank", None),
                   "state": hh.state, "reason": hh.reason}
        payload.update(extra)
        bus.emit(kind, payload, step=self._ticks)

    def _emit_admit(self, host: Optional[int], stats, trace_id=None,
                    rid=None, reason: Optional[str] = None) -> None:
        if host is not None:
            return  # admitted rows ride the router_submit span instead
        bus = _bus()
        if not bus.enabled():
            return
        payload = {
            "host": host,
            "outcome": "rejected" if host is None else "admitted",
            "depths": [s.queue_depth for s in stats],
            "admit_queue": self.admit_queue,
            "admit_ttft_ms": self.admit_ttft_ms,
            "trace_id": trace_id,
            "rid": rid,
        }
        if reason is not None:
            # why the SURVIVING fleet shed this request
            payload["reason"] = reason
            payload["live_hosts"] = sum(
                1 for hh in self._health if hh.state == "healthy")
        bus.emit("router_admit", payload, step=self._ticks)

    def _emit_span(self, trace_id, rid, host: int,
                   predicted_wait_ms: float) -> None:
        """The root span of an admitted request's life: which host the
        SLO scheduler picked and what it predicted."""
        bus = _bus()
        if not bus.enabled():
            return
        bus.emit_span("router_submit", trace_id, {
            "rid": rid,
            "host": host,
            "predicted_wait_ms": round(predicted_wait_ms, 3),
        }, step=self._ticks)

    def _emit_fail_span(self, kind: str, trace_id, payload: dict) -> None:
        """The failover/drain slice on the request's trace lane
        (``dur_ms`` = its life on the abandoned host; timeline renders
        a duration slice ending at this row's time)."""
        bus = _bus()
        if not bus.enabled():
            return
        bus.emit_span(kind, trace_id, payload, step=self._ticks)


# ---------------------------------------------------------------------------
# the simulated host worker (standard library only: the serving control
# plane pays no torch or jax start-up per host)
# ---------------------------------------------------------------------------

#: simulated tokens per decode window — the worker's SYNC_EVERY analog:
#: progress/metrics rows ride window boundaries, so a crash loses at
#: most one window of host-visible progress (exactly like the engine)
_WORKER_WINDOW = 4

#: the sim worker's "KV block": its deterministic cache is the token
#: chain itself, packed this many int32 per block for the bundle blob
_SIM_KV_BLOCK = 4


def _sim_kv_blob(current: dict, rank: int) -> dict:
    """The simulated worker's answer to the ``extract`` verb:
    the SAME wire form ``serving/kv_migration.KVBundle`` reads — ``v``
    / ``manifest`` / ``leaves`` with base64 little-endian arrays and a
    chained per-block CRC32 — built with nothing but the stdlib (the
    worker imports neither torch, jax nor numpy). The sim's "KV" is its token
    chain packed :data:`_SIM_KV_BLOCK` ints per block, padded with -1:
    real bytes for the CRC gate and the ``kv_corrupt`` fault to bite
    on, while the manifest carries the resume truth the survivor
    decodes from."""
    req = current["req"]
    chain = [int(t) for t in current["chain"]]
    bs = _SIM_KV_BLOCK
    n = max((len(chain) + bs - 1) // bs, 1)
    rows = chain + [-1] * (n * bs - len(chain))
    crcs = [zlib.crc32(
        struct.pack(f"<{bs}i", *rows[b * bs:(b + 1) * bs]), 0)
        & 0xFFFFFFFF for b in range(n)]
    emitted = [int(t) for t in current["emitted"]]
    manifest = {
        "rid": req.get("rid"),
        "trace_id": req.get("trace_id"),
        "prompt_ids": [int(t) for t in req.get("prompt_ids") or []],
        "resume": [int(t) for t in current["resume"]],
        "emitted": emitted,
        "ctx": len(chain),
        "last_tok": chain[-1],
        "temperature": req.get("temperature", 0.0),
        "top_k": req.get("top_k", 0),
        "top_p": req.get("top_p", 1.0),
        "eos_id": req.get("eos_id", -1),
        "budget_left": int(req.get("max_new_tokens", 16)) - len(emitted),
        "adapter": int(req.get("adapter", 0) or 0),
        "block_size": bs,
        "n_blocks": n,
        "quant": None,
        "sim": True,
        "rank": rank,
        "crcs": crcs,
    }
    data = base64.b64encode(
        struct.pack(f"<{n * bs}i", *rows)).decode("ascii")
    return {"v": 1, "manifest": manifest,
            "leaves": [[{"dtype": "int32", "shape": [n, bs],
                         "data": data}]]}


def worker_main(argv: Optional[List[str]] = None) -> int:
    """Simulated host worker for the multi-process mailbox tier:
    polls ``<base>/host{rank}/inbox``, queues requests, decodes
    them WINDOW BY WINDOW at ``rate`` tokens/sec of simulated work with
    the deterministic :func:`sim_next_token` chain (a pure function of
    the prefix — greedy in spirit, so resumed requests continue
    token-exactly), and emits the SAME telemetry rows a real engine
    does: ``decode_metrics`` per poll (tokens/sec, queue depth,
    inflight, step_ms — the heartbeat), ``worker_ack`` per ingested
    request, ``worker_progress`` per decode window (rid + cumulative
    new tokens — what the router's failover resumes from), and
    ``decode_request`` per completion, into its per-rank bus stream
    (``PADDLE_OBS_DIR``). Results land as ``outbox/done_<rid>.json``
    with ``token_ids`` = the FULL continuation (resume prefix + new).

    Verbs: a ``{"verb": "drain"}`` inbox file finishes the
    queue then exits rc 0 (planned retirement); ``{"verb": "cancel",
    "rid": r}`` withdraws one request (dropped from the queue, or
    abandoned mid-decode without a result); ``{"verb":
    "extract", "rid": r}``: the worker writes ``outbox/kv_<rid>.json``
    — a :func:`_sim_kv_blob` bundle in the `kv_migration.KVBundle`
    wire form — and hands the request off to the survivor.

    Faults (``serve`` site, rank-targeted): ``slow_host`` multiplies
    simulated work 20x; ``straggler`` adds a fixed per-window delay;
    ``host_crash`` SIGKILLs the process at the next MID-DECODE window
    boundary (progress emitted, result not — the failover path's
    prey); ``hang`` stops draining the mailbox and serving but keeps
    the process and its ``decode_metrics`` heartbeat ALIVE — the
    detector's harder prey (liveness looks fine; only the service
    deadline sees it). Exits when ``<base>/stop`` appears and the
    inbox is drained (a hung worker exits on ``stop`` alone).

    ``PADDLE_SERVE_ROLE=prefill`` (or ``prefill:R1[,R2...]``
    to target only the named ranks of a mixed launch) turns the worker
    into a PREFILL-ONLY host — each picked-up request "prefills" (one sim
    token: the extract contract's first-token rule), PROACTIVELY
    writes its ``outbox/kv_<rid>.json`` bundle blob, and never writes
    a done file: the decode tier owns the request from the blob on."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("usage: router.py <repo_root> <mailbox_base> "
              "[rate] [poll_s]", file=sys.stderr)
        return 2
    base = argv[1]
    rate = float(argv[2]) if len(argv) > 2 else 2000.0
    poll_s = float(argv[3]) if len(argv) > 3 else 0.02
    bus = _bus()
    fi = _fault()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    # PADDLE_SERVE_ROLE: "prefill" makes every rank of this launch a
    # prefill-tier worker; "prefill:R1[,R2...]" only the named ranks —
    # so ONE spawn of the fleet can mix roles (decode rank 0,
    # dedicated prefill rank 1) over one mailbox base
    role = os.environ.get(_ROLE_ENV, "").strip().lower()
    prefill_role = False
    if role.startswith("prefill"):
        _, _, only = role.partition(":")
        prefill_role = (not only) or str(rank) in [
            s.strip() for s in only.split(",")]
    host_dir = os.path.join(base, f"host{rank}")
    inbox = os.path.join(host_dir, "inbox")
    outbox = os.path.join(host_dir, "outbox")
    os.makedirs(inbox, exist_ok=True)
    os.makedirs(outbox, exist_ok=True)
    stop_path = os.path.join(base, "stop")
    queue: List[dict] = []
    seen = set()
    cancelled = set()
    slow = 1.0
    straggle_s = 0.0
    hung = False
    crash_armed = False
    draining = False
    current: Optional[dict] = None
    windows = 0

    def _mine(arg) -> bool:
        return (arg or 0) == rank

    while True:
        for action, arg in fi.consume_serve_events():
            if action == "slow_host" and _mine(arg):
                slow = 20.0
            elif action == "straggler" and _mine(arg):
                # a fixed per-window decode delay on ONE rank: a skew
                # detector must name it from the step_ms telemetry alone
                straggle_s = 0.25
            elif action == "host_crash" and _mine(arg):
                crash_armed = True
            elif action == "hang" and _mine(arg):
                hung = True
        w0 = time.perf_counter()
        if straggle_s:
            time.sleep(straggle_s)
        if not hung:
            acked = []
            for name in sorted(os.listdir(inbox)):
                if not name.endswith(".json") or name in seen:
                    continue
                seen.add(name)
                try:
                    with open(os.path.join(inbox, name)) as f:
                        row = json.load(f)
                except (OSError, ValueError):
                    continue
                verb = row.get("verb")
                if verb == "drain":
                    draining = True
                    continue
                if verb == "cancel":
                    cancelled.add(row.get("rid"))
                    if current is not None and \
                            current["req"].get("rid") == row.get("rid"):
                        current = None  # abandon mid-decode, no result
                    continue
                if verb == "extract":
                    # answer with the in-flight request's KV
                    # bundle blob, then hand the request off — the
                    # survivor owns it the moment the blob lands, so
                    # keeping it serving would double-spend the budget
                    # the manifest just promised away. An unknown or
                    # not-yet-started rid writes nothing: the router's
                    # blob deadline judges, re-prefill recovers.
                    rid = row.get("rid")
                    if current is not None and \
                            current["req"].get("rid") == rid and \
                            current["emitted"]:
                        blob = _sim_kv_blob(current, rank)
                        path = os.path.join(outbox, f"kv_{rid}.json")
                        with open(path + ".tmp", "w") as f:
                            json.dump(blob, f)
                        os.replace(path + ".tmp", path)
                        bus.emit("kv_extract", {
                            "rid": rid,
                            "trace_id": current["req"].get("trace_id"),
                            "blocks": blob["manifest"]["n_blocks"],
                        }, step=windows)
                        current = None
                    continue
                row["t_arrive"] = time.time()
                queue.append(row)
                acked.append(row.get("rid"))
            if acked:
                # the ack row: receipt, distinct from service — a
                # request deep in the queue is WAITING, not lost
                bus.emit("worker_ack", {"rids": acked}, step=windows)
        served_tokens = 0
        t0 = time.perf_counter()
        if not hung:
            while current is None and queue:
                req = queue.pop(0)
                if req.get("rid") in cancelled:
                    continue
                resume = [int(t) for t in req.get("resume_tokens") or []]
                current = {
                    "req": req,
                    # the greedy chain: prompt + resumed prefix, new
                    # tokens appended as they are "decoded"
                    "chain": [int(t) for t in req.get("prompt_ids")
                              or []] + resume,
                    "resume": resume,
                    "emitted": [],
                    "t_first": None,
                }
                bus.emit_span("admit", req.get("trace_id"), {
                    "rid": req.get("rid"),
                    "queue_wait_ms": round(
                        (time.time() - req["t_arrive"]) * 1e3, 3)},
                    step=windows)
            if current is not None and prefill_role:
                # the prefill tier's whole decode is ONE
                # token (the bundle's first-token contract); the blob
                # lands proactively and the request is handed off
                req = current["req"]
                tok = sim_next_token(current["chain"])
                current["chain"].append(tok)
                current["emitted"].append(tok)
                served_tokens = 1
                time.sleep(len(current["chain"]) / rate * slow)
                blob = _sim_kv_blob(current, rank)
                rid = req.get("rid")
                path = os.path.join(outbox, f"kv_{rid}.json")
                with open(path + ".tmp", "w") as f:
                    json.dump(blob, f)
                os.replace(path + ".tmp", path)
                bus.emit("worker_progress", {
                    "rid": rid,
                    "trace_id": req.get("trace_id"),
                    "tokens": list(current["emitted"]),
                }, step=windows)
                bus.emit("kv_extract", {
                    "rid": rid,
                    "trace_id": req.get("trace_id"),
                    "blocks": blob["manifest"]["n_blocks"],
                    "prefill": True,
                }, step=windows)
                current = None
            elif current is not None:
                req = current["req"]
                budget = int(req.get("max_new_tokens", 16))
                take = min(_WORKER_WINDOW, budget - len(current["emitted"]))
                # simulated decode: `take` tokens at rate tokens/sec
                # (slowed when degraded) — wall clock the telemetry
                # prices
                time.sleep(take / rate * slow)
                for _ in range(take):
                    tok = sim_next_token(current["chain"])
                    current["chain"].append(tok)
                    current["emitted"].append(tok)
                if current["t_first"] is None:
                    current["t_first"] = time.time()
                served_tokens = take
                bus.emit("worker_progress", {
                    "rid": req.get("rid"),
                    "trace_id": req.get("trace_id"),
                    "tokens": list(current["emitted"]),
                }, step=windows)
                if crash_armed:
                    # mid-decode by construction: >= 1 window of this
                    # request's progress is on the bus, its result is
                    # not — the router must recover it token-exactly
                    print(f"fault_injection: serve:host_crash — SIGKILL "
                          f"rank {rank} mid-decode", file=sys.stderr,
                          flush=True)
                    os.kill(os.getpid(), _signal.SIGKILL)
                if len(current["emitted"]) >= budget:
                    ttft_ms = (current["t_first"] - req["t_arrive"]) * 1e3
                    latency_ms = (time.time() - req["t_arrive"]) * 1e3
                    n = len(current["emitted"])
                    bus.emit("decode_request", {
                        "rid": req.get("rid"), "tokens": n,
                        "latency_ms": round(latency_ms, 3),
                        "prefill_ms": 0.0,
                        "ttft_ms": round(ttft_ms, 3),
                        "ms_per_token": round(latency_ms / max(n, 1), 3),
                        "trace_id": req.get("trace_id"),
                    }, step=windows)
                    out = {"rid": req.get("rid"),
                           "token_ids": current["resume"]
                           + current["emitted"],
                           "resumed": len(current["resume"]),
                           "tokens": n, "rank": rank,
                           "trace_id": req.get("trace_id"),
                           "ttft_ms": round(ttft_ms, 3),
                           "latency_ms": round(latency_ms, 3)}
                    path = os.path.join(outbox,
                                        f"done_{req.get('rid')}.json")
                    with open(path + ".tmp", "w") as f:
                        json.dump(out, f)
                    os.replace(path + ".tmp", path)
                    current = None
        windows += 1
        dt = time.perf_counter() - t0
        payload = {
            "steps": 1,
            "tokens": served_tokens,
            "inflight_slots": 1 if current is not None else 0,
            "queue_depth": len(queue),
            # per-window wall time: the fleet monitor's skew signal
            "step_ms": round((time.perf_counter() - w0) * 1e3, 3),
        }
        if served_tokens and dt > 0:
            payload["tokens_per_sec"] = round(served_tokens / dt, 1)
        bus.emit("decode_metrics", payload, step=windows)
        if hung:
            # the mailbox rots, the heartbeat doesn't; the operator's
            # stop file still ends the process cleanly
            if os.path.exists(stop_path):
                return 0
            time.sleep(poll_s)
            continue
        idle = current is None and not queue
        if idle:
            leftover = [n for n in os.listdir(inbox)
                        if n.endswith(".json") and n not in seen]
            if not leftover and (draining or os.path.exists(stop_path)):
                # drain verb or the global stop: retire rc 0
                return 0
        if not served_tokens:
            time.sleep(poll_s)


if __name__ == "__main__":
    sys.exit(worker_main())
