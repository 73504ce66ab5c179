"""The port's collectives, comm monitor, launcher and ``spawn`` against the
JAX package's.

A rank is a process in the port and a mesh device in the JAX package:
rank ``r`` of a 4-process gloo world (``helpers/torch_world.py``, started
once for the module, on the CPU, meeting through a ``file://`` store) takes
row ``r`` of the JAX call's rank-stacked input, over a JAX group of 4 of
its 8 CPU devices, and must hold row ``r`` of the JAX result (rtol 1e-6;
1e-5 for PROD and AVG, as ``tests/test_distributed.py``). The comm
monitor's cases (an injected hang caught by the watchdog, an injected
desync named at a monitored barrier, a monitored barrier that names the
rank that never came) run in the same world. The launcher runs a short
script on 2 ranks; ``spawn`` re-raises its first failing rank.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
import paddle_tpu.ops.pallas as jax_pallas
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from helpers import torch_world as tw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4


def _fresh_process_state():
    jax_comm._state.hybrid_mesh = pt_comm._mesh = None
    jax_pallas.flash_attention = jax_fa


def _inputs():
    rng = np.random.RandomState(0)
    f = np.float32
    return dict(sum=rng.rand(N, 3, 4).astype(f),
                ops=(rng.rand(N, 2, 3) + 0.5).astype(f),
                gather=rng.rand(N, 2, 2).astype(f),
                rs=rng.rand(N, N * 2, 3).astype(f),
                scatter=[rng.rand(2, 3).astype(f) for _ in range(N)],
                a2a=[rng.rand(N, 2).astype(f) for _ in range(N)])


def _jax_refs(x):
    """The JAX package's results over a group of 4 of its devices, and over
    the subset [0, 2]."""
    jdist.init_parallel_env()
    g = jdist.new_group(list(range(N)))
    R = jdist.ReduceOp
    T = jpaddle.to_tensor
    ref = {"sum": jdist.all_reduce(T(x["sum"]), group=g).numpy()}
    for name, op in (("max", R.MAX), ("min", R.MIN), ("prod", R.PROD),
                     ("avg", R.AVG)):
        ref[name] = jdist.all_reduce(T(x["ops"]), op=op, group=g).numpy()
    ref["reduce"] = jdist.reduce(T(x["sum"]), dst=1, group=g).numpy()
    ref["all_gather"] = [p.numpy() for p in
                         jdist.all_gather(None, T(x["gather"]), group=g)]
    ref["broadcast"] = jdist.broadcast(T(x["sum"]), src=2,
                                       group=g).numpy()
    for name, op in (("rs_sum", R.SUM), ("rs_max", R.MAX),
                     ("rs_avg", R.AVG)):
        ref[name] = jdist.reduce_scatter(T(x["rs"]), op=op,
                                         group=g).numpy()
    ref["scatter"] = jdist.scatter(
        T(np.zeros((N, 2, 3), np.float32)),
        [T(a) for a in x["scatter"]], src=1, group=g).numpy()
    ref["alltoall"] = [p.numpy() for p in
                       jdist.alltoall([T(a) for a in x["a2a"]], group=g)]
    sub = jdist.new_group([0, 2])
    ref["subset"] = jdist.all_reduce(T(x["sum"][[0, 2]]), group=sub).numpy()
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    x = _inputs()
    ref = _jax_refs(x)
    tmp = str(tmp_path_factory.mktemp("world"))
    out = tw.run_world(["collectives", "monitor"], tmp, x)
    yield x, ref, out, tmp
    pt_device._current = saved
    _fresh_process_state()


def _rows(world, key):
    _, ref, out, _ = world
    return ref[key], [o[key] for o in out["collectives"]]


def test_all_reduce_sum(world):
    want, got = _rows(world, "sum")
    for r in range(N):
        np.testing.assert_allclose(got[r], want[r], rtol=1e-6)


@pytest.mark.parametrize("op", ["max", "min", "prod", "avg"])
def test_all_reduce_ops(world, op):
    want, got = _rows(world, op)
    for r in range(N):
        np.testing.assert_allclose(got[r], want[r], rtol=1e-5)


def test_reduce_reaches_dst_only(world):
    x, _, _, _ = world
    want, got = _rows(world, "reduce")
    for r in range(N):
        np.testing.assert_allclose(got[r], want[r], rtol=1e-6)
    np.testing.assert_array_equal(got[0], x["sum"][0])


def test_all_gather(world):
    want, got = _rows(world, "all_gather")
    for r in range(N):
        assert len(got[r]) == N
        for i in range(N):
            np.testing.assert_allclose(got[r][i], want[i], rtol=1e-6)


def test_broadcast(world):
    want, got = _rows(world, "broadcast")
    for r in range(N):
        np.testing.assert_allclose(got[r], want[r], rtol=1e-6)


@pytest.mark.parametrize("op", ["rs_sum", "rs_max", "rs_avg"])
def test_reduce_scatter(world, op):
    want, got = _rows(world, op)
    for r in range(N):
        np.testing.assert_allclose(got[r], want[r], rtol=1e-5)


def test_scatter(world):
    want, got = _rows(world, "scatter")
    for r in range(N):
        np.testing.assert_allclose(got[r], want[r], rtol=1e-6)


def test_alltoall(world):
    want, got = _rows(world, "alltoall")
    for r in range(N):
        for s in range(N):
            np.testing.assert_allclose(got[r][s], want[s][r], rtol=1e-6)


def test_new_group_on_a_subset(world):
    x, ref, out, _ = world
    res = out["collectives"]
    assert [o["subset_rank"] for o in res] == [0, -1, 1, -1]
    np.testing.assert_allclose(res[0]["subset"], ref["subset"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(res[2]["subset"], ref["subset"][1],
                               rtol=1e-6)
    # a rank outside the group keeps its tensor
    np.testing.assert_array_equal(res[1]["subset"], x["sum"][1])


def test_shard_rank_axis_and_replicate(world):
    """Row ``r`` of the JAX package's rank-stacked array is rank ``r``'s
    value; ``replicate`` gives every rank the array."""
    x, _, out, _ = world
    for r, o in enumerate(out["collectives"]):
        np.testing.assert_array_equal(o["shard_rank_axis"], x["sum"][r])
        np.testing.assert_array_equal(o["replicate"], x["sum"][0])


def test_torch_tensor_is_written_in_place(world):
    x, _, out, _ = world
    for o in out["collectives"]:
        np.testing.assert_allclose(o["inplace"], x["sum"].sum(0), rtol=1e-6)


def test_counts_name_backend_and_transport(world):
    """Every collective is counted by (op, backend, transport): on the CPU
    the rule gives gloo, and gloo moves CPU tensors itself."""
    for rank, o in enumerate(world[2]["collectives"]):
        rows = {r["op"]: r for r in o["counts"]}
        assert {"all_reduce", "reduce", "all_gather", "broadcast",
                "reduce_scatter", "scatter", "alltoall", "barrier"} \
            <= set(rows)
        for r in o["counts"]:
            assert (r["backend"], r["transport"]) == ("gloo", "gloo-cpu")
            assert r["calls"] >= 1 and r["bytes"] > 0
        # the subset's all-reduce ran on rank 0's and 2's groups only
        assert rows["all_reduce"]["calls"] == 6 + (rank in (0, 2))


def test_flight_recorder_numbers_each_group(world):
    """The flight recorder numbers each group's collectives from 1 and
    names the op, its shape and its call site."""
    recs = world[2]["collectives"][0]["records"]
    seqs = [r["seq"] for r in recs if r["group"] == 0]
    assert seqs == list(range(1, len(seqs) + 1))
    first = recs[0]
    assert (first["op"], first["shape"], first["dtype"]) == \
        ("all_reduce", [3, 4], "float32")
    assert "torch_world.py" in first["site"]
    assert all(r["status"] == "done" for r in recs)


def test_hang_is_caught_by_the_watchdog(world):
    """``coll:hang:2:2`` on rank 0: its watchdog fires at
    ``PADDLE_COLL_TIMEOUT`` (0.5 s) while it is stuck, writes the event and
    dumps the flight recorder naming the op, the group and the rank; the
    collective still completes right."""
    x, _, out, tmp = world
    mon = out["monitor"][0]
    np.testing.assert_allclose(mon["hang_result"],
                               np.full((2, 3), 6.0, np.float32))
    ev = mon["events"][-1]
    assert ev["event"] == "coll_timeout" and ev["op"] == "all_reduce"
    assert ev["time"] - mon["hang_t0"] < 1.8
    dump = json.loads(mon["hang_dump"])
    assert dump["reason"] == "timeout"
    last = dump["records"][-1]
    assert (last["op"], last["group"], last["rank"], last["status"],
            last["shape"]) == ("all_reduce", 0, 0, "timeout", [2, 3])


def test_desync_names_both_call_sites(world):
    """``coll:desync:1:1`` mutates rank 1's fingerprint: the monitored
    barrier raises on every rank, naming both ops and both call sites."""
    for mon in world[2]["monitor"]:
        msg = mon["desync"]
        assert msg is not None and "rank 1 issued" in msg
        assert "all_reduce[desync-injected]" in msg
        assert msg.count("torch_world.py") == 2


def test_monitored_barrier_names_the_missing_rank(world):
    for mon in world[2]["monitor"][:3]:
        assert "missing ranks [3]" in mon["missing"]


def test_launch_runs_a_script_on_two_ranks(tmp_path):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2``:
    each rank gets the env of ``build_cluster_env`` and its own log, meets
    the other at rank 0's endpoint (tcp) and all-reduces."""
    from paddle_tpu_torch.distributed.launch import (build_cluster_env,
                                                     free_port)

    script = tmp_path / "train.py"
    script.write_text(
        "import json, os\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch import distributed as dist\n"
        "pt.set_device('cpu')\n"
        "dist.init_parallel_env()\n"
        "t = pt.to_tensor([float(dist.get_rank() + 1)])\n"
        "dist.all_reduce(t)\n"
        "keys = ('PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM',\n"
        "        'PADDLE_CURRENT_ENDPOINT', 'PADDLE_TRAINER_ENDPOINTS')\n"
        "print('RESULT', json.dumps({k: os.environ[k] for k in keys}),\n"
        "      float(t.numpy()[0]), dist.comm.backend())\n")
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = tmp_path / "logs"
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--start_port", str(port), "--log_dir",
         str(logs), "--deadline", "120", str(script)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=150)
    assert p.returncode == 0, p.stderr + "".join(
        f.read_text() for f in logs.glob("workerlog.*"))
    want = build_cluster_env(2, start_port=port, base_env={})
    for r in range(2):
        line = [ln for ln in (logs / f"workerlog.{r}").read_text()
                .splitlines() if ln.startswith("RESULT")][0]
        env_json, total, backend = line[len("RESULT "):].rsplit(" ", 2)
        assert json.loads(env_json) == want[r]
        assert float(total) == 3.0 and backend == "gloo"


def test_launch_takes_a_free_port_and_removes_its_sync_dir(tmp_path,
                                                          monkeypatch):
    """Without ``start_port`` a one-host job takes a port free on this
    host (two jobs do not meet at one fixed port), and the sync directory
    the launcher made is gone when the job ends."""
    from paddle_tpu_torch.distributed import launch

    monkeypatch.delenv("PADDLE_PORT", raising=False)
    monkeypatch.delenv("PADDLE_COLL_SYNC_DIR", raising=False)
    script = tmp_path / "rank_env.py"
    script.write_text(
        "import os\n"
        "print('RESULT', os.environ['PADDLE_CURRENT_ENDPOINT'],\n"
        "      os.environ['PADDLE_COLL_SYNC_DIR'],\n"
        "      os.path.isdir(os.environ['PADDLE_COLL_SYNC_DIR']))\n")
    logs = tmp_path / "logs"
    assert launch.launch(str(script), [], nproc_per_node=2,
                         log_dir=str(logs), deadline=60) == 0
    seen = [[ln.split()[1:] for ln in (logs / f"workerlog.{r}")
             .read_text().splitlines() if ln.startswith("RESULT")][0]
            for r in range(2)]
    ports = [int(ep.rsplit(":", 1)[1]) for ep, _, _ in seen]
    assert ports[1] == ports[0] + 1 and ports[0] != launch.DEFAULT_PORT
    sync = {d for _, d, _ in seen}
    assert len(sync) == 1 and all(ok == "True" for _, _, ok in seen)
    assert not os.path.exists(sync.pop())


def test_spawn_reraises_the_first_failure():
    from paddle_tpu_torch.distributed import spawn

    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        spawn(tw.fail_on_rank, (1, 3), nprocs=2, timeout=60)


def test_backend_rule(monkeypatch):
    """nccl only when each rank of the host has a card of its own; a
    backend the rule does not give raises."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pt_comm.backend_rule(cpu, 1) == "gloo"
    assert pt_comm.backend_rule(cuda, 1) == "nccl"
    assert pt_comm.backend_rule(cuda, 4) == "gloo"
    saved = pt_comm._state
    pt_comm._state = pt_comm._CommState()
    try:
        with pytest.raises(ValueError, match="rule gives 'gloo'"):
            pt_comm.init_parallel_env(backend="nccl", device="cpu")
        assert not pt_comm.is_initialized()
    finally:
        pt_comm._state = saved


def test_spmd_region_contract():
    assert not pt_comm.in_spmd_region()
    with pt_comm.spmd_region("dp", "mp"):
        assert pt_comm.in_spmd_region() and pt_comm.in_spmd_region("mp")
        assert not pt_comm.in_spmd_region("pp")
    assert not pt_comm.in_spmd_region("dp")
