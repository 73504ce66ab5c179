"""The port's elastic launcher (``distributed/elastic.py``'s
``ElasticManager`` and ``RankProc``, ``distributed/launch.py``), the
preemption notice, a job that loses a rank mid-run, and hapi's ``Model``
across trainers, against the JAX package's.

- C9: the port's SIGTERM notice dumps the collective flight recorder with
  reason ``"sigterm"`` before the trainer's callback, as the JAX package's
  does (``tests/test_fault_tolerance.py``'s
  ``test_sigterm_notice_dumps_flight_recorder``).
- Each launcher case runs the JAX package's manager and the port's on the
  same stdlib-only children (``helpers/tiny_rank.py``): a quorum-holding
  loss notifies the survivors and ends rc 0; below the quorum, or with
  resharding off, rc 7; a bad mode is a ``ValueError``; a hung rank is put
  down and relaunched; the restart budget runs out; zero retries never
  relaunch; ``workerlog.N`` holds each attempt. The backoff from a seeded
  ``random`` is the JAX manager's, number for number. SIGTERM to the
  port's launcher CLI is forwarded to the ranks and ends 143.
  ``monitor``/``ctl`` raise ``NotImplementedError`` naming ROADMAP item 8.
- Three torch ranks under ``launch(reshard="shrink")``
  (``helpers/torch_elastic_rank.py``): rank 2 exits 7 after step 2; the
  survivors reshard to dp2 (inside the step whose collective failed, or at
  the boundary) and their losses are the uninterrupted run's (the JAX
  package's ``TrainStep`` on the global batches) within 1e-5; rc 0.
- A rank that dies inside a step's collective: the survivors retry the
  step's batch at dp2 (the row says ``retried_step``) and end with the
  losses, parameters and BatchNorm statistics of a run that reshards at
  that step's boundary, dropout draws included.
- hapi ``Model.fit`` and ``evaluate`` at 2 ranks (``helpers/torch_world.py``'s
  ``hapi_fit``) against the JAX ``Model`` on a dp2 world: the logged losses
  and accuracies, ``evaluate``'s numbers and the parameters within 1e-5.
"""
import json
import os
import pickle
import random
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.distributed import elastic as jel
from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu.jit import TrainStep as JTrainStep

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import comm_monitor as pcm
from paddle_tpu_torch.distributed import elastic as pel
from paddle_tpu_torch.distributed import launch as plaunch
from paddle_tpu_torch.utils import fault_injection as pfi
from helpers import torch_world as tw
from test_torch_fleet_strategy import _fresh_process_state, _sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPERS = os.path.join(REPO, "tests", "helpers")
TINY = os.path.join(HELPERS, "tiny_rank.py")
PKGS = {"jax": (jel, jlaunch), "port": (pel, plaunch)}
REL = 1e-5

_KNOBS = ("PADDLE_FAULT_SPEC", "PADDLE_WATCHDOG_TIMEOUT",
          "PADDLE_WATCHDOG_GRACE", "PADDLE_ELASTIC_BACKOFF",
          "PADDLE_ELASTIC_WINDOW", "PADDLE_LOG_DIR", "PADDLE_HEARTBEAT_FILE",
          "PADDLE_TRAINER_ID", "PADDLE_COLL_TIMEOUT",
          "PADDLE_COLL_DEBUG_DIR", "PADDLE_COLL_EVENT_FILE",
          "PADDLE_COLL_SYNC_DIR", "PADDLE_RESHARD_MODE",
          "PADDLE_RESHARD_QUORUM", "PADDLE_RESHARD_NOTICE_FILE",
          "PADDLE_MON", "PADDLE_CTL", "PADDLE_OBS_DIR")


@pytest.fixture
def scoped_env(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    pfi.reset()
    pcm.reset()
    yield monkeypatch
    pfi.reset()
    pcm.reset()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


# -- C9 ----------------------------------------------------------------------

def test_sigterm_notice_dumps_flight_recorder(tmp_path, scoped_env):
    """The JAX package's test, against the port: SIGTERM writes
    ``comm_dump.rank0.json`` (reason ``sigterm``, the last record the
    all_reduce) before the notice callback runs."""
    scoped_env.setenv("PADDLE_COLL_DEBUG_DIR", str(tmp_path))
    pcm.reset()
    pcm.monitor().record("all_reduce", 0, "dp", 8, (2, 2), "float32")
    seen = []
    old = pel.install_preempt_notice(
        lambda: seen.append((tmp_path / "comm_dump.rank0.json").exists()))
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        pel.restore_preempt_notice(old)
    assert seen == [True]
    dump = json.load(open(tmp_path / "comm_dump.rank0.json"))
    assert dump["reason"] == "sigterm"
    assert dump["records"][-1]["op"] == "all_reduce"


def test_sigterm_notice_survives_a_failed_dump(scoped_env, monkeypatch):
    """A dump that raises never blocks the notice."""
    def boom(reason):
        raise OSError("disk full")

    monkeypatch.setattr(pcm, "dump_flight_recorder", boom)
    seen = []
    old = pel.install_preempt_notice(lambda: seen.append(1))
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        pel.restore_preempt_notice(old)
    assert seen == [1]


# -- the launcher --------------------------------------------------------------

def _quorum_run(pkg, tmp_path, exit_ranks, reshard="shrink", quorum=0.5):
    el, la = PKGS[pkg]
    ack = str(tmp_path / f"ack_{pkg}")
    base = _clean_env()
    base.update({"TINY_MODE": "reshard",
                 "TINY_EXIT_RANKS": ",".join(str(r) for r in exit_ranks),
                 "TINY_EXIT_CODE": "7", "TINY_NOTICE_FILE": ack,
                 "TINY_WAIT": "15"})
    envs = la.build_cluster_env(3, start_port=_free_port(), base_env=base)
    mgr = el.ElasticManager(TINY, [], envs, reshard=reshard,
                            reshard_quorum=quorum, monitor=False)
    return mgr.run(), ack


@pytest.mark.parametrize("pkg", list(PKGS))
def test_quorum_holding_loss_notifies_survivors(pkg, tmp_path, scoped_env):
    rc, ack = _quorum_run(pkg, tmp_path, [1])
    assert rc == 0
    for rank in (0, 2):
        row = json.loads(open(f"{ack}.{rank}").read().splitlines()[0])
        assert row["event"] == "depart" and row["ranks"] == [1]
        assert sorted(row["survivors"]) == [0, 2]


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("exit_ranks,reshard,quorum", [
    ([0, 1], "shrink", 0.8), ([1], "off", 0.5)],
    ids=["below_quorum", "reshard_off"])
def test_loss_without_quorum_keeps_rc(pkg, exit_ranks, reshard, quorum,
                                      tmp_path, scoped_env):
    rc, ack = _quorum_run(pkg, tmp_path, exit_ranks, reshard, quorum)
    assert rc == 7
    assert not os.path.exists(f"{ack}.2") and not os.path.exists(f"{ack}.0")


@pytest.mark.parametrize("pkg", list(PKGS))
def test_manager_rejects_bad_mode(pkg):
    with pytest.raises(ValueError, match="shrink"):
        PKGS[pkg][0].ElasticManager("x.py", [], [], reshard="grow")


@pytest.mark.parametrize("pkg", list(PKGS))
def test_hung_rank_is_put_down_and_relaunched(pkg, scoped_env):
    scoped_env.setenv("TINY_MODE", "hang")
    scoped_env.setenv("PADDLE_WATCHDOG_GRACE", "1")
    scoped_env.setenv("PADDLE_ELASTIC_BACKOFF", "0.05")
    t0 = time.monotonic()
    rc = PKGS[pkg][1].launch(TINY, [], nproc_per_node=1,
                             start_port=_free_port(), watchdog_timeout=1.0,
                             elastic_retries=1, monitor=False)
    assert rc == 0  # attempt 1 exits clean after the watchdog's kill
    assert time.monotonic() - t0 < 20


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("retries,code,spawns", [(2, 7, 3), (0, 5, 1)],
                         ids=["budget_exhausted", "zero_retries"])
def test_restart_budget(pkg, retries, code, spawns, tmp_path, scoped_env):
    count = tmp_path / "spawns"
    scoped_env.setenv("TINY_MODE", "exit")
    scoped_env.setenv("TINY_EXIT_CODE", str(code))
    scoped_env.setenv("TINY_COUNT_FILE", str(count))
    scoped_env.setenv("PADDLE_ELASTIC_BACKOFF", "0.05")
    rc = PKGS[pkg][1].launch(TINY, [], nproc_per_node=1,
                             start_port=_free_port(),
                             elastic_retries=retries, monitor=False)
    assert rc == code
    assert len(count.read_text().splitlines()) == spawns


@pytest.mark.parametrize("pkg", list(PKGS))
def test_workerlog_capture(pkg, tmp_path, scoped_env):
    scoped_env.setenv("TINY_MODE", "ok")
    rc = PKGS[pkg][1].launch(TINY, [], nproc_per_node=2,
                             start_port=_free_port(), monitor=False,
                             log_dir=str(tmp_path / "logs"))
    assert rc == 0
    for rank in (0, 1):
        log = tmp_path / "logs" / f"workerlog.{rank}"
        assert f"attempt 0 rank {rank}" in log.read_text()


def test_backoff_matches_reference():
    """Growth, the cap and the jitter: the same numbers as the JAX
    manager's from the same seeded ``random``."""
    got = {}
    for name, (el, _) in PKGS.items():
        mgr = el.ElasticManager("x.py", [], [], backoff_base=1.0,
                                backoff_cap=8.0, monitor=False)
        random.seed(11)
        got[name] = [mgr._backoff_delay(n) for n in (1, 2, 3, 4, 10)
                     for _ in range(5)]
    assert got["port"] == got["jax"]
    for d, nominal in zip(got["port"], np.repeat([1, 2, 4, 8, 8], 5)):
        assert 0.5 * nominal <= d <= 1.5 * nominal


def test_sigterm_to_the_launcher_is_forwarded(tmp_path):
    """SIGTERM to the port's launcher CLI reaches the rank (its notice
    file), no relaunch follows, and the launcher exits 143."""
    notice, ready = tmp_path / "notice", tmp_path / "ready"
    env = _clean_env()
    env.update(TINY_MODE="notice", TINY_NOTICE_FILE=str(notice),
               TINY_READY_FILE=str(ready))
    p = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=1", f"--start_port={_free_port()}",
         "--elastic_retries=3", "--watchdog_timeout=60", "--reshard=off",
         "--reshard_quorum=0.5", TINY], env=env)
    try:
        deadline = time.monotonic() + 60
        while not ready.exists():
            assert p.poll() is None, "launcher died before the rank was up"
            assert time.monotonic() < deadline
            time.sleep(0.1)
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
    assert notice.read_text().strip() == "preempted"
    assert rc == pel.PREEMPT_RC == 143


def test_sync_dir_under_the_callers(tmp_path, scoped_env):
    """The launcher's own ``PADDLE_COLL_SYNC_DIR`` (a directory a job's
    hosts share) holds each attempt's sync dir; the ranks of an attempt
    get the same one."""
    shared = tmp_path / "shared"
    shared.mkdir()
    scoped_env.setenv("PADDLE_COLL_SYNC_DIR", str(shared))
    script = tmp_path / "rank_env.py"
    script.write_text("import os\n"
                      "print('RESULT', os.environ['PADDLE_COLL_SYNC_DIR'])\n")
    logs = tmp_path / "logs"
    assert plaunch.launch(str(script), [], nproc_per_node=2, monitor=False,
                          log_dir=str(logs), deadline=60) == 0
    seen = {ln.split()[1] for r in range(2) for ln in (
        logs / f"workerlog.{r}").read_text().splitlines()
        if ln.startswith("RESULT")}
    assert seen == {str(shared / "collsync.0")}


def test_monitor_and_ctl_name_item_8(scoped_env):
    for kw in ({"monitor": True}, {"ctl": "dryrun"}, {"ctl": "live"}):
        with pytest.raises(NotImplementedError, match="item 8"):
            plaunch.launch(TINY, [], **kw)
    for argv in (["--monitor=on", TINY], ["--ctl=dryrun", TINY]):
        with pytest.raises(NotImplementedError, match="item 8"):
            plaunch.main(argv)
    scoped_env.setenv("PADDLE_CTL", "live")
    with pytest.raises(NotImplementedError, match="item 8"):
        pel.ElasticManager("x.py", [], [])
    scoped_env.setenv("PADDLE_CTL", "off")
    scoped_env.setenv("PADDLE_MON", "1")
    with pytest.raises(NotImplementedError, match="item 8"):
        pel.ElasticManager("x.py", [], [])
    # RankProc keeps a spawned rank's bookkeeping, as the JAX package's
    rp = pel.RankProc(None, 3, "hb")
    assert (rp.rank, rp.hb_path, rp.notice_path) == (3, "hb", None)


# -- torch ranks that lose one mid-run ------------------------------------------

def _batches(n, batch, seed=7):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, 16).astype(np.float32),
             (np.arange(batch) % 10).astype(np.int64)) for _ in range(n)]


def _jax_net(init):
    net = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 10))
    net.set_state_dict(init)
    return net


@pytest.fixture(scope="module")
def inputs():
    from paddle_tpu_torch.core import device as pt_device

    saved = pt_device._current
    pt.set_device("cpu")
    pt.seed(0)
    yield {"rs_init": {k: v.numpy() for k, v in
                       tw.reshard_net().state_dict().items()},
           "rs_data": _batches(5, 12),
           "hapi_data": _batches(4, 16, seed=13)}
    pt_device._current = saved


def test_rank_exit_reshards_in_job(inputs, tmp_path, scoped_env):
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    scoped_env.setenv("TORCH_ELASTIC_DIR", str(tmp_path))
    scoped_env.setenv("TORCH_ELASTIC_EXIT", "2")
    scoped_env.setenv("TORCH_ELASTIC_AFTER", "2")
    scoped_env.setenv("PADDLE_COLL_TIMEOUT", "60")
    rc = plaunch.launch(os.path.join(HELPERS, "torch_elastic_rank.py"), [],
                        nproc_per_node=3, reshard="shrink", deadline=120,
                        monitor=False, log_dir=str(tmp_path / "logs"))
    assert rc == 0
    assert not (tmp_path / "rank2.json").exists()
    net = _jax_net(inputs["rs_init"])
    step = JTrainStep(net, lambda o, y: jpaddle.nn.functional.cross_entropy(
        o, y), joptim.Adam(learning_rate=1e-3, parameters=net.parameters()))
    want = [float(step(x, y).numpy()) for x, y in inputs["rs_data"]]
    for r in (0, 1):
        got = json.load(open(tmp_path / f"rank{r}.json"))
        np.testing.assert_allclose(got["losses"], want, rtol=REL)
        assert got["dp"] == 2
        (row,) = got["rows"]
        assert (row["trigger"], row["old"], row["new"], row["lost"]) == \
            ("launcher", "dp3", "dp2", [2])
        assert row["covered"] and not row["fallback"]


def _launch_bn(inputs, tmp_path, scoped_env, mode):
    out = tmp_path / mode
    out.mkdir()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    for k, v in (("DIR", str(out)), ("EXIT", "2"), ("AFTER", "2"),
                 ("MODE", mode), ("NET", "bn")):
        scoped_env.setenv(f"TORCH_ELASTIC_{k}", v)
    scoped_env.setenv("PADDLE_COLL_TIMEOUT", "60")
    rc = plaunch.launch(os.path.join(HELPERS, "torch_elastic_rank.py"), [],
                        nproc_per_node=3, reshard="shrink", deadline=120,
                        monitor=False, log_dir=str(out / "logs"))
    assert rc == 0
    assert not (out / "rank2.json").exists()
    return [json.load(open(out / f"rank{r}.json")) for r in (0, 1)]


def test_rank_dying_mid_step_retries_the_batch(inputs, tmp_path, scoped_env):
    """Rank 2 exits inside step 3, after both survivors entered it: their
    gradient reduction fails, they reshard to dp2 inside the step and run
    its batch again from the state it started with (BatchNorm's running
    statistics and the dropout stream put back). Losses, parameters and
    buffers equal the run whose ranks reshard at step 3's boundary."""
    mid = _launch_bn(inputs, tmp_path, scoped_env, "mid")
    ref = _launch_bn(inputs, tmp_path, scoped_env, "boundary")
    for got, want in zip(mid, ref):
        (row,) = got["rows"]
        assert row["retried_step"] is True
        assert (row["trigger"], row["old"], row["new"], row["lost"]) == \
            ("launcher", "dp3", "dp2", [2])
        (wrow,) = want["rows"]
        assert "retried_step" not in wrow
        assert (wrow["trigger"], wrow["new"]) == ("api", "dp2")
        assert len(got["losses"]) == len(inputs["rs_data"])
        np.testing.assert_array_equal(got["losses"], want["losses"])
        assert sorted(got["state"]) == sorted(want["state"])
        for k, v in want["state"].items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)


# -- hapi across trainers ----------------------------------------------------------

def test_hapi_fit_at_dp2_matches_reference(inputs, tmp_path):
    x = {"hapi_init": inputs["rs_init"], "hapi_data": inputs["hapi_data"]}
    logs = []
    try:
        jax_comm.rebuild_world(jax.devices()[:2])
        net = _jax_net(x["hapi_init"])
        model = jpaddle.Model(net)
        model.prepare(joptim.Adam(learning_rate=1e-2,
                                  parameters=net.parameters()),
                      jnn.CrossEntropyLoss(), jpaddle.metric.Accuracy())
        assert model._dp_model is not None

        class Record(jpaddle.hapi.callbacks.Callback):
            def on_train_batch_end(self, step, lg=None):
                logs.append({k: float(np.ravel(v)[0]) for k, v in lg.items()
                             if k in ("loss", "acc")})

        model.fit(x["hapi_data"], epochs=1, verbose=0, shuffle=False,
                  callbacks=[Record()])
        res = model.evaluate(x["hapi_data"], verbose=0)
        want = {"logs": logs, "params": _sd(net),
                "eval": {k: float(np.ravel(v)[0]) for k, v in res.items()}}
    finally:
        _fresh_process_state()
        jax_comm._state.default_group = None
        jax_comm._state.groups = {}
        jax_comm.init_parallel_env()
    out = tw.run_world(["hapi_fit"], str(tmp_path), x, nprocs=2)
    for r, o in enumerate(out["hapi_fit"]):
        assert o["wrapped"]
        assert [sorted(d) for d in o["logs"]] == \
            [sorted(d) for d in want["logs"]]
        for g, w in zip(o["logs"], want["logs"]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=REL,
                                           err_msg=f"{k} rank {r}")
        for k in want["eval"]:
            np.testing.assert_allclose(o["eval"][k], want["eval"][k],
                                       rtol=REL, err_msg=f"{k} rank {r}")
        for k, v in want["params"].items():
            np.testing.assert_allclose(o["params"][k], v, rtol=REL,
                                       atol=1e-6, err_msg=f"{k} rank {r}")
