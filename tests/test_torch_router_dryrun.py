"""The port's router over its mailbox tier: ``FileHost`` and
``FilePrefillHost`` in front of simulated host workers spawned from
``paddle_tpu_torch/serving/router.py``, one process per rank.

The worker imports the standard library only (it loads the port's bus,
fault injector and stream cursor by path) and "decodes" with the
deterministic ``sim_next_token`` chain, so a resumed or migrated greedy
request is token-exact against the chain itself. The JAX oracles are
``tests/test_serving_tier.py::TestRouterDryrun``,
``tests/test_serving_fault.py::TestLauncherDryruns`` (the host-crash
failover), ``tests/test_serving_migration.py::TestMigrationDryrun`` and
``tests/test_serving_multitenant.py::TestMultitenantDryrun``; where they
spawn the workers through paddle_tpu's launcher, these spawn them
directly (rank in ``PADDLE_TRAINER_ID``, telemetry in ``PADDLE_OBS_DIR``)
and the router writes its own rows as rank -1. Every wait has its own
deadline, and every worker is killed at the end of its test, so a hung
worker fails its test and not the suite.
"""
import json
import os
import subprocess
import sys
import time

import pytest

from helpers.torch_threads import one_torch_thread  # noqa: F401
from paddle_tpu_torch.observability import bus
from paddle_tpu_torch.serving.router import (FileHost, FilePrefillHost,
                                             Router, sim_next_token)
from paddle_tpu_torch.utils import fault_injection as fi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "paddle_tpu_torch", "serving", "router.py")


def _sim_chain(prompt, n):
    chain, out = list(prompt), []
    for _ in range(n):
        out.append(sim_next_token(chain))
        chain.append(out[-1])
    return out


class _Fleet:
    """Worker processes, one per rank, over ``<tmp>/mail/host{rank}``,
    spawned at once or, with ``start=False``, by :meth:`start` (requests
    submitted before then wait in the inboxes)."""

    def __init__(self, tmp_path, ranks=(0, 1), rate="800", poll="0.02",
                 start=True, **env):
        self.base = str(tmp_path / "mail")
        self.logs = str(tmp_path / "logs")
        os.makedirs(self.logs, exist_ok=True)
        base_env = {k: v for k, v in os.environ.items()
                    if k != "PADDLE_OBS_BUS_FILE"}
        base_env.update(env)
        self._spawn = (ranks, rate, poll, base_env)
        self.procs = {}
        if start:
            self.start()

    def start(self):
        ranks, rate, poll, base_env = self._spawn
        for r in ranks:
            e = dict(base_env, PADDLE_TRAINER_ID=str(r),
                     PADDLE_OBS_DIR=self.logs)
            self.procs[r] = subprocess.Popen(
                [sys.executable, WORKER, REPO, self.base, rate, poll],
                env=e, stdout=subprocess.DEVNULL,
                stderr=open(os.path.join(self.logs, f"worker{r}.err"),
                            "w"))

    def hosts(self, ranks=(0, 1)):
        return [FileHost(os.path.join(self.base, f"host{r}"), r,
                         obs_dir=self.logs) for r in ranks]

    def stop(self, timeout=20.0):
        """The stop file, then each worker's exit code (None = still
        running at the deadline)."""
        open(os.path.join(self.base, "stop"), "w").close()
        deadline = time.time() + timeout
        rcs = {}
        for r, p in self.procs.items():
            try:
                rcs[r] = p.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                rcs[r] = None
        return rcs

    def kill(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)

    def rows(self, rank):
        return bus.read_stream(os.path.join(self.logs,
                                            f"telemetry.rank{rank}.jsonl"))

    def blobs(self, rank):
        outbox = os.path.join(self.base, f"host{rank}", "outbox")
        return [n for n in os.listdir(outbox) if n.startswith("kv_")] \
            if os.path.isdir(outbox) else []


@pytest.fixture()
def fleet(tmp_path, monkeypatch):
    """Spawn workers with ``fleet(**kw)``; the router in this process
    writes its rows as rank -1 into the same directory."""
    made = []
    for k in ("PADDLE_FAULT_SPEC", "PADDLE_SERVE_ROLE",
              "PADDLE_OBS_BUS_FILE"):
        monkeypatch.delenv(k, raising=False)

    def spawn(**kw):
        f = _Fleet(tmp_path, **kw)
        made.append(f)
        monkeypatch.setenv("PADDLE_OBS_DIR", f.logs)
        monkeypatch.setenv("PADDLE_TRAINER_ID", "-1")
        return f

    fi.reset()
    bus.reset()
    yield spawn
    for f in made:
        f.kill()
    fi.reset()
    bus.reset()


def _until(cond, deadline_s, router=None):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if router is not None:
            router.tick()
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_burst_and_slow_host(fleet, monkeypatch):
    """A ``serve:slow_host`` fault degrades rank 0, visible only through
    its telemetry, so it gets less traffic; a ``serve:burst`` is
    admission-limited; nothing admitted is dropped; queue depth and TTFT
    rows land on each worker's stream.

    The order is fixed, not left to the wall clock: the first three
    requests and the burst (router tick 3) are routed before the workers
    start, on the router's own pending counts, so the burst meets queues
    that no worker drains meanwhile; the rest are routed once rank 0's
    telemetry shows its throughput and rank 1's shows its queue drained,
    while rank 0's backlog lasts."""
    spec = "serve:slow_host:1:0,serve:burst:3:12"
    monkeypatch.setenv("PADDLE_FAULT_SPEC", spec)
    f = fleet(rate="600", poll="0.01", start=False, PADDLE_FAULT_SPEC=spec)
    hosts = f.hosts()
    router = Router(hosts, admit_queue=6, avg_new_tokens=8)
    placed = {0: 0, 1: 0, None: 0}

    def submit(i):
        placed[router.submit({"rid": f"r{i}", "prompt_ids": [1, 2],
                              "max_new_tokens": 8})] += 1
        for b in router.tick():
            placed[b] += 1

    for i in range(3):
        submit(i)
    f.start()

    def ready():
        slow, fast = hosts[0].stats(), hosts[1].stats()
        return slow.tokens_per_sec is not None and fast.age_s is not None \
            and fast.queue_depth == fast.inflight == 0

    assert _until(ready, 30)
    for i in range(3, 12):
        submit(i)
    assert _until(lambda: router.inflight() == 0, 30, router)
    rcs = f.stop()
    router.tick()
    assert rcs == {0: 0, 1: 0}
    assert placed[1] > placed[0]
    assert router.rejected > 0 and placed[None] == router.rejected
    assert len(router.completed) == router.admitted
    for res in router.completed.values():
        assert res["tokens"] == _sim_chain([1, 2] if res["rid"][0] == "r"
                                           else [0, 1, 2, 3], 8)
    for rank in (0, 1):
        rows = f.rows(rank)
        dm = [r["payload"] for r in rows if r["kind"] == "decode_metrics"]
        assert dm and all("queue_depth" in p for p in dm)
        dr = [r["payload"] for r in rows if r["kind"] == "decode_request"]
        assert dr and all("ttft_ms" in p for p in dr)


def test_host_crash_failover_token_exact(fleet, monkeypatch):
    """``serve:host_crash`` SIGKILLs rank 0 mid-decode: every in-flight
    greedy request completes on the survivor, token-exact against the
    uninterrupted chain, none dropped, and the router calls the host
    dead."""
    spec = "serve:host_crash:2:0"
    monkeypatch.setenv("PADDLE_FAULT_SPEC", spec)
    f = fleet(PADDLE_FAULT_SPEC=spec)
    router = Router(f.hosts(), admit_queue=32, avg_new_tokens=24,
                    host_timeout_ms=400, retry_backoff_ms=60, retry_max=2,
                    migrate_timeout_ms=200)
    prompts = {f"c{i}": [i + 1, i + 2] for i in range(6)}
    for rid, p in prompts.items():
        router.submit({"rid": rid, "prompt_ids": p, "max_new_tokens": 24})
    assert _until(lambda: len(router.completed) == 6, 45, router)
    rcs = f.stop()
    assert rcs[0] == -9 and rcs[1] == 0  # the crash was a SIGKILL
    for rid, p in prompts.items():
        assert router.completed[rid]["tokens"] == _sim_chain(p, 24), rid
    assert router.failovers >= 1 and router.host_state(0) == "dead"
    assert [r for r in router.completed.values() if r.get("resumed")], \
        "no request resumed mid-stream"
    dead = [r["payload"] for r in bus.read_stream(os.path.join(
        f.logs, "telemetry.launcher.jsonl")) if r["kind"] ==
        "router_host_dead"]
    assert dead and dead[0]["host"] == 0 and dead[0]["reason"] == "silent"


def test_drain_migrates_over_blob_transport(fleet, monkeypatch):
    """``drain_host`` moves a mid-decode request over the mailbox: the
    ``extract`` verb, the ``kv_<rid>.json`` blob, its CRC check, the
    splice on the survivor; the drained worker retires with rc 0. The
    workers decode at 40 tokens/s and the blob may take 10 s, so a
    loaded host still drains mid-decode and gets its blob in time (the
    late-blob fallback is ``test_torch_router.py``'s ``kv_lost`` case)."""
    f = fleet(rate="40")
    monkeypatch.setenv("PADDLE_SERVE_MIGRATE_TIMEOUT_MS", "10000")
    router = Router(f.hosts(), admit_queue=32, avg_new_tokens=24,
                    drain_inplace_tokens=4)
    prompts = {f"g{i}": [i + 3, i + 4] for i in range(4)}
    for rid, p in prompts.items():
        router.submit({"rid": rid, "prompt_ids": p, "max_new_tokens": 24})
    assert _until(lambda: any(e.progress for e in router._tracked.values()
                              if e.host == 0), 30, router)
    summary = router.drain_host(0)
    assert router.migrations >= 1, (summary, router.migrate_failed)
    assert _until(lambda: len(router.completed) == 4, 30, router)
    assert _until(lambda: router.host_state(0) == "retired", 10, router)
    # the drained worker exits on its own, before the stop file
    assert f.procs[0].wait(timeout=20) == 0
    assert f.stop() == {0: 0, 1: 0}
    for rid, p in prompts.items():
        assert router.completed[rid]["tokens"] == _sim_chain(p, 24), rid
    assert router.duplicates == 0
    assert any(r["kind"] == "kv_extract" for r in f.rows(0))
    assert f.blobs(0) == []


def test_dedicated_prefill_worker_hands_off(fleet):
    """``PADDLE_SERVE_ROLE=prefill:1``: rank 1 prefills only and answers
    each request with a bundle blob; the decode worker on rank 0 takes
    every handoff, token-exact."""
    f = fleet(PADDLE_SERVE_ROLE="prefill:1")
    decode, pre = f.hosts((0,))[0], FilePrefillHost(
        os.path.join(f.base, "host1"), 1, obs_dir=f.logs)
    router = Router([decode], prefill_hosts=[pre], admit_queue=32,
                    avg_new_tokens=24)
    prompts = {f"d{i}": [i + 3, i + 4] for i in range(2)}
    for rid, p in prompts.items():
        router.submit({"rid": rid, "prompt_ids": p, "max_new_tokens": 24})
    assert _until(lambda: len(router.completed) == 2, 45, router)
    assert f.stop() == {0: 0, 1: 0}
    assert (router.disagg_prefills, router.disagg_fallbacks) == (2, 0)
    for rid, p in prompts.items():
        assert router.completed[rid]["tokens"] == _sim_chain(p, 24), rid
    assert router.duplicates == 0
    extracts = [r for r in f.rows(1) if r["kind"] == "kv_extract"]
    assert len(extracts) == 2
    assert all(r["payload"].get("prefill") for r in extracts)
    assert f.blobs(0) == [] and f.blobs(1) == []


def test_worker_imports_neither_torch_nor_jax(tmp_path):
    """The worker, run as the script it is, with a stop file already in
    place: it polls once, exits 0, and its ``sys.modules`` holds neither
    torch nor jax (nor numpy), only the port's own files loaded by
    path."""
    base = tmp_path / "mail"
    base.mkdir()
    (base / "stop").touch()
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = [{WORKER!r}, {REPO!r}, {str(base)!r}]\n"
        "try:\n"
        f"    runpy.run_path({WORKER!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "mods = {m: getattr(sys.modules[m], '__file__', None)\n"
        "        for m in sys.modules if m.startswith('_pdtpu')}\n"
        "print(json.dumps({'rc': rc, 'mods': mods, 'heavy': sorted(\n"
        "    m for m in sys.modules if m.split('.')[0] in\n"
        "    ('torch', 'jax', 'jaxlib', 'numpy', 'paddle_tpu',\n"
        "     'paddle_tpu_torch'))}))\n")
    env = dict(os.environ, PADDLE_TRAINER_ID="0",
               PADDLE_OBS_DIR=str(tmp_path / "logs"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=60)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and got["heavy"] == []
    root = os.path.join(REPO, "paddle_tpu_torch")
    assert set(got["mods"]) == {"_pdtpu_torch_obs_bus",
                                "_pdtpu_torch_fault"}
    for path in got["mods"].values():
        assert os.path.realpath(path).startswith(root + os.sep)
