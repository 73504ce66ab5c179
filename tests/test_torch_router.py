"""The port's router over in-process hosts against paddle_tpu's: the
router's decisions on scripted hosts, admission, disaggregated prefill,
failover and drain with KV migration, the fault ladder, and the engine's
``decode_metrics`` / ``decode_request`` / span telemetry.

The model is ``test_torch_serving_tier.py``'s (imported from it): a
``TransformerLM`` with vocab 48, d_model 128, 4 heads, 2 layers, capacity
64, numpy weights loaded into the port by
``set_state_dict``, ``PADDLE_FLASH_DEFAULT=interpret`` and
``PADDLE_FUSED_LN=interpret``; the engines page at block 16. The JAX
oracles are ``tests/test_serving_tier.py::TestRouterInProcess``,
``tests/test_serving_multitenant.py::TestDisaggregation``,
``tests/test_serving_migration.py`` (parity and injected faults) and
``tests/test_serving.py::TestDecodeTelemetry``; paddle_tpu's
uninterrupted tokens are computed once per module.

The health checks are wall-clock tests, as in the JAX package: the
decision test drives both routers with one scripted clock, and the
failover test uses a hangable ``LocalHost`` with explicit timeouts and a
deadline. Tolerances: none; tokens, decisions and rows are equal.
"""
import json
import re
import time

import pytest
import torch

from paddle_tpu.distributed import comm
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import router as jrouter
from paddle_tpu.utils import fault_injection as jfi

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.observability import bus
from paddle_tpu_torch.serving import Request
from paddle_tpu_torch.serving import router
from paddle_tpu_torch.serving.router import (LocalHost, PrefillHost, Router,
                                             sim_next_token)
from paddle_tpu_torch.utils import fault_injection as fi

from test_torch_serving_tier import CAP, _pair, env  # noqa: F401

BS = 16
#: (prompt, budget) of the requests the JAX oracle decodes uninterrupted
ORACLE_REQS = {"d": ([4, 5, 6, 7], 10), "r": ([4, 5, 6, 7], 12),
               "long": ([9, 8, 7], 16), "v": ([3, 1, 4], 12),
               "one": ([4, 5, 6], 1)}


@pytest.fixture(scope="module")
def models(env):  # noqa: F811
    prev = comm._state.hybrid_mesh
    comm._state.hybrid_mesh = None
    comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
    yield _pair()
    comm._state.hybrid_mesh = prev


@pytest.fixture(scope="module")
def oracle(models):
    jm, _ = models
    eng = JaxEngine(jm, slots=2, max_length=CAP, sync_every=4)
    for rid, (p, n) in ORACLE_REQS.items():
        eng.submit(JaxRequest(list(p), max_new_tokens=n, rid=rid))
    return {rid: r.tokens for rid, r in eng.run().items()}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PADDLE_FAULT_SPEC", "PADDLE_SERVE_MIGRATE",
              "PADDLE_SERVE_DISAGG", "PADDLE_OBS_DIR",
              "PADDLE_OBS_BUS_FILE", "PADDLE_SERVE_KV_QUANT"):
        monkeypatch.delenv(k, raising=False)
    fi.reset()
    jfi.reset()
    yield
    fi.reset()
    jfi.reset()


def _engine(m, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_length", CAP)
    kw.setdefault("sync_every", 4)
    kw.setdefault("block_size", BS)
    return pt.InferenceEngine(m, **kw)


def _fast_router(hosts, **kw):
    kw.setdefault("host_timeout_ms", 120)
    kw.setdefault("retry_backoff_ms", 25)
    kw.setdefault("retry_max", 2)
    kw.setdefault("avg_new_tokens", 8)
    return Router(hosts, **kw)


def _drive(r, hosts, rid, deadline_s=30):
    deadline = time.time() + deadline_s
    while rid not in r.completed and time.time() < deadline:
        r.tick()
        for h in hosts:
            h.pump()
        time.sleep(0.01)
    return r.completed[rid]


def _req(rid):
    p, n = ORACLE_REQS[rid]
    return {"rid": rid, "prompt_ids": list(p), "max_new_tokens": n}


def _mid_decode(r, host, rid):
    assert r.submit(_req(rid)) == 0
    host.pump()  # prefill and one readback window
    r.tick()
    pre = list(r._tracked[rid].progress)
    assert 0 < len(pre) < ORACLE_REQS[rid][1], "need a mid-decode victim"
    return pre


class _HangableLocal(LocalHost):
    """A LocalHost whose death keeps the engine reachable: the host hangs
    (heartbeat fresh, service frozen, no decoding) but ``extract_kv``
    still works, the failover case where migration beats re-prefill."""

    can_fail = True

    def __init__(self, engine):
        super().__init__(engine)
        self.dead = False
        self._t_dead = None

    def die(self):
        self.dead = True
        self._t_dead = time.time()

    def pump(self):
        return False if self.dead else super().pump()

    def submit(self, req):
        if not self.dead:
            super().submit(req)

    def signals(self):
        if not self.dead:
            return super().signals()
        return {"live_t": time.time(), "service_t": self._t_dead,
                "progress": {}, "results": []}


def _rows(path, kinds=None):
    rows = bus.read_stream(str(path))
    return [r for r in rows if kinds is None or r["kind"] in kinds]


# ---------------------------------------------------------------------------
# the router's decisions against paddle_tpu's, on scripted hosts
# ---------------------------------------------------------------------------


class _Clock:
    """One scripted clock for a router module: ``time``, ``perf_counter``
    and ``sleep`` read and move it."""

    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += s


class _Stats:
    __slots__ = ("queue_depth", "inflight", "tokens_per_sec", "ttft_ms",
                 "age_s", "submitted")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class _Stub:
    """A scripted host: each tick it decodes two tokens of the
    ``sim_next_token`` chain for every request it holds, publishes its
    queue through ``stats`` and its service through ``signals``. ``hung``
    keeps its heartbeat and stops service; ``silent`` stops both."""

    can_fail = True

    def __init__(self, rank, clock, adapters=(0,), tps=None,
                 extract=False):
        self.rank = rank
        self.clock = clock
        self.adapters = set(adapters)
        self.tps = tps
        self.log = []
        self.reqs = {}
        self.hung = self.silent = False
        self.live_t = self.service_t = None
        self._results = []
        if extract:  # a source whose bundles never arrive
            self.extract_kv = lambda rid, timeout_ms=None, _send=True: None

    def submit(self, req):
        req = dict(req)
        self.log.append(("submit", req))
        self.reqs[req["rid"]] = (req, [])

    def stats(self):
        return _Stats(queue_depth=len(self.reqs), inflight=0,
                      tokens_per_sec=self.tps, age_s=0.0,
                      submitted=len(self.log))

    def step(self):
        if self.silent:
            return
        self.live_t = self.clock.time()
        if self.hung or not self.reqs:
            return
        for rid, (req, toks) in list(self.reqs.items()):
            chain = list(req["prompt_ids"]) + list(
                req.get("resume_tokens") or []) + toks
            for _ in range(min(2, req["max_new_tokens"] - len(toks))):
                toks.append(sim_next_token(chain))
                chain.append(toks[-1])
            if len(toks) >= req["max_new_tokens"]:
                del self.reqs[rid]
                resume = list(req.get("resume_tokens") or [])
                self._results.append({"rid": rid, "resumed": len(resume),
                                      "token_ids": resume + toks})
        self.service_t = self.clock.time()

    def signals(self):
        res, self._results = self._results, []
        return {"live_t": self.live_t, "service_t": self.service_t,
                "progress": {rid: list(t) for rid, (_, t)
                             in self.reqs.items()}, "results": res}

    def adapter_ok(self, aid):
        return int(aid or 0) in self.adapters

    def cancel(self, rid):
        self.log.append(("cancel", rid))
        self.reqs.pop(rid, None)

    def send_verb(self, verb, rid=None):
        self.log.append(("verb", verb, rid))


def _scripted_run(mod, monkeypatch, tmp_path, tag):
    """Drive one router module over three scripted hosts: admission with
    queue, TTFT and adapter limits, a burst and an adapter fault, a hung
    host (found unresponsive, its work failed over), a silent host, a
    drain. Returns the decisions, the hosts' logs and the bus rows."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    monkeypatch.setenv("PADDLE_OBS_BUS_FILE", str(tmp_path / f"{tag}.jsonl"))
    monkeypatch.setenv("PADDLE_FAULT_SPEC",
                       "serve:burst:3:2,serve:adapter_missing:5")
    hosts = [_Stub(0, clock, adapters=(0, 1), tps=400.0),
             _Stub(1, clock, adapters=(0, 1, 2), extract=True),
             _Stub(2, clock, tps=60.0, extract=True),
             _Stub(3, clock, adapters=(0, 1, 2), tps=200.0)]
    r = mod.Router(hosts, admit_queue=3, admit_ttft_ms=250.0,
                   avg_new_tokens=8, host_timeout_ms=100.0,
                   retry_backoff_ms=20.0, retry_max=2,
                   drain_inplace_tokens=3, burst_new_tokens=4)
    trace = []
    for tick in range(30):
        placed = []
        if tick < 12:
            for j in range(2):
                n = 2 * tick + j
                placed.append(r.submit({
                    "rid": f"q{n}", "prompt_ids": [n % 7, 3, n % 5],
                    "max_new_tokens": 8 + n % 7, "adapter": n % 3}))
        if tick == 5:
            hosts[1].hung = True
        if tick == 9:
            hosts[2].silent = True
        if tick == 10:
            placed.append(r.drain_host(0))
        for h in hosts:
            h.step()
        placed.append(r.tick())
        clock.t += 0.05
        trace.append((placed, [r.host_state(i) for i in range(4)],
                      r.admitted, r.rejected, r.failovers, r.duplicates,
                      r.migrations, r.migrate_failed, len(r.completed),
                      r.inflight()))
    done = {rid: v["tokens"] for rid, v in r.completed.items()}
    return trace, [h.log for h in hosts], done, _rows(
        tmp_path / f"{tag}.jsonl")


def _mask(obj, ids):
    """Trace ids and pid-qualified request ids renamed by order of first
    appearance; the rows' wall-clock ``time`` dropped."""
    s = json.dumps(obj, sort_keys=True)
    for pat in (r't[0-9a-f]+-\d{5}',):
        for m in re.findall(pat, s):
            ids.setdefault(m, f"T{len(ids)}")
    for k, v in ids.items():
        s = s.replace(k, v)
    out = json.loads(s)
    if isinstance(out, list):
        for row in out:
            if isinstance(row, dict):
                row.pop("time", None)
    return out


def test_router_decisions_equal_paddle_tpu(monkeypatch, tmp_path):
    got = _scripted_run(router, monkeypatch, tmp_path, "port")
    fi.reset()
    want = _scripted_run(jrouter, monkeypatch, tmp_path, "jax")
    trace, logs, done, rows = got
    # the script reaches every decision it is there for
    kinds = {r["kind"] for r in rows}
    assert {"router_admit", "router_metrics", "router_host_suspect",
            "router_host_dead", "router_failover", "router_drain",
            "kv_migrate_fail", "span"} <= kinds
    reasons = {r["payload"].get("reason") for r in rows
               if r["kind"] == "router_admit"}
    assert {"queue_full", "ttft_slo"} <= {x for r in reasons if r
                                          for x in r.split("+")}
    dead = [r["payload"]["reason"] for r in rows
            if r["kind"] == "router_host_dead"]
    assert dead == ["unresponsive", "silent"]
    fails = {r["payload"]["reason"] for r in rows
             if r["kind"] == "kv_migrate_fail"}
    assert fails == {"timeout", "source_dead"}
    assert trace[-1][1] == ["retired", "dead", "dead", "healthy"]
    assert trace[-1][-1] == 0  # nothing admitted was dropped
    ids_a, ids_b = {}, {}
    assert _mask(trace, ids_a) == _mask(want[0], ids_b)
    assert _mask(logs, ids_a) == _mask(want[1], ids_b)
    assert done == want[2]
    assert _mask(rows, ids_a) == _mask(want[3], ids_b)
    # every request completed on the sim chain, failed over or not
    for rid, toks in done.items():
        if rid.startswith("q"):
            n = int(rid[1:])
            chain, want_toks = [n % 7, 3, n % 5], []
            for _ in range(8 + n % 7):
                want_toks.append(sim_next_token(chain))
                chain.append(want_toks[-1])
            assert toks == want_toks, rid


# ---------------------------------------------------------------------------
# in-process routing and admission (oracle: TestRouterInProcess)
# ---------------------------------------------------------------------------


class TestRouterInProcess:
    def test_routes_to_emptier_local_host(self, models):
        _, tm = models
        hosts = [LocalHost(_engine(tm, block_size=0)) for _ in range(2)]
        r = Router(hosts, admit_queue=10)
        for _ in range(3):  # preload host 0: its live queue dominates
            hosts[0].submit({"prompt_ids": [1, 2], "max_new_tokens": 4})
        assert r.submit({"prompt_ids": [3, 4], "max_new_tokens": 4}) == 1

    def test_admission_rejects_when_all_full(self, models):
        _, tm = models
        host = LocalHost(_engine(tm, block_size=0))
        r = Router([host], admit_queue=2)
        outcomes = [r.submit({"prompt_ids": [1], "max_new_tokens": 2})
                    for _ in range(5)]
        assert outcomes == [0, 0, None, None, None] and r.rejected == 3
        assert len(host.drain()) == 2  # what was admitted is served

    def test_burst_fault_admission_limited(self, models, monkeypatch,
                                           tmp_path):
        _, tm = models
        monkeypatch.setenv("PADDLE_OBS_DIR", str(tmp_path))
        monkeypatch.setenv("PADDLE_FAULT_SPEC", "serve:burst:1:6")
        host = LocalHost(_engine(tm, block_size=0))
        r = Router([host], admit_queue=3)
        outcomes = r.tick()
        assert len(outcomes) == 6 and outcomes.count(None) == 3
        rows = _rows(tmp_path / "telemetry.rank0.jsonl")
        kinds = [x["kind"] for x in rows]
        assert "router_metrics" in kinds and "router_admit" in kinds
        rm = [x["payload"] for x in rows
              if x["kind"] == "router_metrics"][-1]
        assert rm["rejected"] == 3 and "host0_queue_depth" in rm

    def test_ttft_slo_admission(self):
        def stub(qd, tps):
            class S:
                def submit(self, req):
                    pass

                def stats(self):
                    return router.HostStats(queue_depth=qd, inflight=0,
                                            tokens_per_sec=tps, age_s=0.0)
            return S()

        # 8 queued * 16 tokens / 100 tok/s = 1280 ms predicted wait
        r = Router([stub(8, 100.0)], admit_ttft_ms=500.0,
                   avg_new_tokens=16, admit_queue=100)
        assert r.submit({"prompt_ids": [1]}) is None
        r2 = Router([stub(1, 1000.0)], admit_ttft_ms=500.0,
                    avg_new_tokens=16, admit_queue=100)
        assert r2.submit({"prompt_ids": [1]}) == 0

    def test_fault_site_the_port_lacks_raises(self, models, monkeypatch):
        _, tm = models
        r = Router([LocalHost(_engine(tm))])
        for spec, item in (("ctl:flap:1", "item 8"),
                           ("serve:lent_worker_crash:1", "item 8")):
            monkeypatch.setenv("PADDLE_FAULT_SPEC", spec)
            with pytest.raises(NotImplementedError, match=item):
                r.tick()
        # the training sites are instrumented now: their rules parse
        for spec in ("grad:nan:1", "acp.save:fail:1", "epoch:hang:2",
                     "coll:desync:1", "rank:depart:2"):
            fi.FaultInjector(spec)
        # the grammar's own errors stay ValueErrors, as in paddle_tpu
        for spec in ("grad:burst:1", "serve:bogus:1", "serve:burst"):
            with pytest.raises(ValueError):
                fi.FaultInjector(spec)
            with pytest.raises(ValueError):
                jfi.FaultInjector(spec)


# ---------------------------------------------------------------------------
# disaggregated prefill (oracle: TestDisaggregation)
# ---------------------------------------------------------------------------


class TestDisaggregation:
    def _fleet(self, tm):
        return ([LocalHost(_engine(tm)) for _ in range(2)],
                PrefillHost(_engine(tm)))

    def test_handoff_token_exact_zero_decode_prefill(self, models, oracle):
        _, tm = models
        hosts, ph = self._fleet(tm)
        r = _fast_router(hosts, prefill_hosts=[ph])
        placed = r.submit(_req("d"))
        assert placed in (0, 1)  # a decode host, not the prefill tier
        assert _drive(r, hosts, "d")["tokens"] == oracle["d"]
        assert (r.disagg_prefills, r.disagg_fallbacks) == (1, 0)
        # the decode tier resumed from spliced blocks, never prefilled
        assert hosts[placed].engine._prefill._n_steps == 0
        # the prefill tier ran no decode window and released the slot
        assert ph.engine._prefill._n_steps == 1
        assert ph.engine.progress() == {} and ph.engine.inflight() == 0

    def test_off_switch_restores_colocated(self, models, oracle,
                                           monkeypatch):
        monkeypatch.setenv("PADDLE_SERVE_DISAGG", "0")
        _, tm = models
        hosts, ph = self._fleet(tm)
        r = _fast_router(hosts, prefill_hosts=[ph])
        r.submit(_req("d"))
        assert _drive(r, hosts, "d")["tokens"] == oracle["d"]
        assert r.disagg_prefills == 0 and ph.engine._prefill._n_steps == 0

    def test_single_token_requests_stay_colocated(self, models, oracle):
        _, tm = models
        hosts, ph = self._fleet(tm)
        r = _fast_router(hosts, prefill_hosts=[ph])
        r.submit(_req("one"))
        assert _drive(r, hosts, "one")["tokens"] == oracle["one"]
        assert r.disagg_prefills == 0 and ph.engine._prefill._n_steps == 0


# ---------------------------------------------------------------------------
# failover and drain with migration (oracle: test_serving_migration.py)
# ---------------------------------------------------------------------------


class TestMigration:
    def _failover(self, tm):
        hosts = [_HangableLocal(_engine(tm)) for _ in range(2)]
        r = _fast_router(hosts)
        pre = _mid_decode(r, hosts[0], "r")
        hosts[0].die()
        got = _drive(r, hosts[1:], "r")
        return r, hosts, pre, got

    def test_failover_migrate_token_exact_zero_prefill(self, models,
                                                       oracle):
        r, hosts, pre, got = self._failover(models[1])
        assert got["host"] == 1 and got["tokens"] == oracle["r"]
        assert got["resumed"] >= len(pre)
        assert (r.migrations, r.migrate_failed, r.failovers) == (1, 0, 1)
        assert hosts[1].engine._prefill._n_steps == 0
        assert r.migrate_blocks >= 1 and r.migrate_bytes > 0

    def test_failover_reprefills_when_disabled(self, models, oracle,
                                               monkeypatch):
        monkeypatch.setenv("PADDLE_SERVE_MIGRATE", "0")
        r, hosts, _, got = self._failover(models[1])
        assert got["tokens"] == oracle["r"] and r.migrations == 0
        assert hosts[1].engine._prefill._n_steps >= 1

    def test_drain_migrate_token_exact_zero_prefill(self, models, oracle):
        _, tm = models
        hosts = [LocalHost(_engine(tm)) for _ in range(2)]
        r = _fast_router(hosts, drain_inplace_tokens=2)
        pre = _mid_decode(r, hosts[0], "long")
        assert r.drain_host(0) == {"host": 0, "migrated": 1, "in_place": 0}
        assert r.migrations == 1
        assert "long" not in hosts[0].engine.progress()  # cancelled there
        got = _drive(r, hosts, "long")
        assert got["tokens"] == oracle["long"]
        assert got["resumed"] >= len(pre)
        assert hosts[1].engine._prefill._n_steps == 0
        assert r.host_state(0) == "retired" and r.duplicates == 0

    @pytest.mark.parametrize("spec,reason", [("serve:kv_corrupt:1:0", "crc"),
                                             ("serve:kv_lost:1", "lost")])
    def test_injected_kv_fault_falls_back(self, models, oracle, monkeypatch,
                                          tmp_path, spec, reason):
        _, tm = models
        monkeypatch.setenv("PADDLE_FAULT_SPEC", spec)
        monkeypatch.setenv("PADDLE_OBS_DIR", str(tmp_path))
        hosts = [LocalHost(_engine(tm)) for _ in range(2)]
        r = _fast_router(hosts, drain_inplace_tokens=2)
        _mid_decode(r, hosts[0], "v")
        assert r.drain_host(0)["migrated"] == 1  # moved, by the slow rung
        assert _drive(r, hosts, "v")["tokens"] == oracle["v"]
        assert (r.migrations, r.migrate_failed) == (0, 1)
        assert hosts[1].engine._prefill._n_steps >= 1  # re-prefilled
        fails = [x["payload"] for x in _rows(
            tmp_path / "telemetry.rank0.jsonl", {"kv_migrate_fail"})]
        assert [f["reason"] for f in fails] == [reason]
        assert fails[0]["rid"] == "v"
        if reason == "crc":
            assert fails[0]["block"] == 0


# ---------------------------------------------------------------------------
# the engine's telemetry against paddle_tpu's (oracle: TestDecodeTelemetry)
# ---------------------------------------------------------------------------

#: payload keys that hold host wall-clock values
_WALL = ("tokens_per_sec", "step_ms", "ttft_ms", "ttft_ms_mean",
         "latency_ms", "prefill_ms", "ms_per_token", "queue_wait_ms",
         "chunk_ms", "dur_ms")
_TELEMETRY = ("decode_metrics", "decode_request", "span")
_TELE_REQS = [([3, 4, 5], 5, "a"), ([7, 1], 4, "b"), ([2] * 20, 6, "c"),
              ([9, 9, 1], 1, "d")]


def _telemetry_rows(Engine, Req, m, path, monkeypatch, **kw):
    monkeypatch.setenv("PADDLE_OBS_BUS_FILE", str(path))
    eng = Engine(m, slots=2, max_length=CAP, sync_every=3, **kw)
    for p, n, rid in _TELE_REQS:
        eng.submit(Req(p, max_new_tokens=n, rid=rid, trace_id=f"tr-{rid}"))
    out = eng.run()
    rows = []
    for r in _rows(path, _TELEMETRY):
        p = {k: (None if k in _WALL else v)
             for k, v in r["payload"].items()}
        rows.append((r["kind"], r["step"], p))
    return rows, {rid: res.tokens for rid, res in out.items()}


@pytest.mark.parametrize("kw", [dict(block_size=BS, prefill_chunk=16),
                                dict(block_size=0)])
def test_telemetry_rows_equal_paddle_tpu(models, monkeypatch, tmp_path, kw):
    jm, tm = models
    got = _telemetry_rows(pt.InferenceEngine, Request, tm,
                          tmp_path / "port.jsonl", monkeypatch, **kw)
    want = _telemetry_rows(JaxEngine, JaxRequest, jm,
                           tmp_path / "jax.jsonl", monkeypatch, **kw)
    assert got == want
    kinds = [k for k, _, _ in got[0]]
    assert kinds.count("decode_request") == len(_TELE_REQS)
    names = {p.get("name") for k, _, p in got[0] if k == "span"}
    assert {"admit", "prefill", "decode_window", "retire"} <= names
    if kw["block_size"]:
        assert "prefill_chunk" in names


class TestHostReads:
    """Telemetry adds no device-to-host read, and ``extract_kv`` reads the
    pool's blocks only, never a state vector."""

    READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
             "__float__", "__index__")

    def _count(self, monkeypatch, fn):
        """Run ``fn`` recording each read: (method name, data pointer)."""
        seen = []
        with monkeypatch.context() as mp:
            for name in self.READS:
                real = getattr(torch.Tensor, name)

                def counting(self, *a, _real=real, _name=name, **kw):
                    seen.append((_name, self.data_ptr()))
                    return _real(self, *a, **kw)

                mp.setattr(torch.Tensor, name, counting)
            out = fn()
        return seen, out

    def test_telemetry_adds_no_host_read(self, models, monkeypatch,
                                         tmp_path):
        _, tm = models

        def run(on):
            if on:
                monkeypatch.setenv("PADDLE_OBS_BUS_FILE",
                                   str(tmp_path / "on.jsonl"))
            else:
                monkeypatch.delenv("PADDLE_OBS_BUS_FILE", raising=False)
            eng = _engine(tm, sync_every=3, prefill_chunk=16)
            for p, n, rid in _TELE_REQS:
                eng.submit(Request(p, max_new_tokens=n, rid=rid,
                                   trace_id=f"tr-{rid}"))
            seen, res = self._count(monkeypatch, eng.run)
            return len(seen), {k: v.tokens for k, v in res.items()}

        (off, toks_off), (on, toks_on) = run(False), run(True)
        assert on == off > 0 and toks_on == toks_off
        rows = _rows(tmp_path / "on.jsonl")
        assert [r for r in rows if r["kind"] == "decode_metrics"]
        assert len([r for r in rows if r["kind"] == "decode_request"]) \
            == len(_TELE_REQS)

    def test_extract_reads_the_pool_blocks_only(self, models, monkeypatch):
        _, tm = models
        eng = _engine(tm)
        eng.submit(Request([1, 2, 3], max_new_tokens=12, rid="x"))
        results = {}
        while not eng.progress().get("x"):
            eng.turn(results)
        st = eng._state
        state_ptrs = {getattr(st, f).data_ptr() for f in
                      ("pos", "tok", "done", "temperature", "top_k",
                       "top_p", "eos", "budget", "adapter")}
        seen, b = self._count(monkeypatch, lambda: eng.extract_kv("x"))
        assert b is not None
        # one gather and one copy out per pool tensor (2 layers x K, V);
        # the rest reads those host copies (the CRCs), no state vector
        assert [n for n, _ in seen].count("cpu") == 4
        assert not state_ptrs & {ptr for _, ptr in seen}
