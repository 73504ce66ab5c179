"""The port's elastic resharding (``distributed/resharding.py``) against the
JAX package's, on the same inputs.

- The planner: ``plan_refactoring`` over dp4, dp8, dp2 x mp2, dcn2 x ici4
  and dcn2 x ici2 x mp2 (the JAX planner gets a jax ``Mesh`` over its CPU
  devices, the port's a ``MeshLayout`` of the same axes), for every lost
  set of one and two ranks and seeded larger ones: the new degrees, the
  survivors, the idled ranks and the error type agree.
- ``factoring_str``; the coverage verdicts (a replicated leaf survives any
  loss, a dp-sharded one dies with its holder: the JAX package reads its
  arrays' shardings, the port the mesh's geometry); the ``rank`` fault
  grammar against the JAX ``FaultInjector``; the launcher's notice rows
  parsed from the same bytes, torn lines included, to the same rows and
  offsets.
- One world of 4 gloo processes (``helpers/torch_world.py``'s
  ``reshard_*`` cases):
  - dp4 -> dp3 -> dp4 through the API, Adam: the losses within 1e-5 of
    the JAX package's ``ElasticStep`` on its dp4 mesh, no ``io.load``, the
    returning rank's state equal to the survivors', two ``reshard`` rows
    (the shrink sends 0 bytes, the return the state) that
    ``tools/timeline.py`` renders;
  - dp2 x mp2 under ``PADDLE_FAULT_SPEC=rank:depart:2:3``
    (``strategy.elastic_reshard="shrink"`` through fleet): dp1 x mp2, rank 2
    retired alongside rank 3, the losses and parameters within 1e-5 of the
    JAX package's run of the same spec (on dense layers of the same
    weights: its tensor-parallel layers do not follow a reshard);
  - ZeRO-1: ``CoverageError`` without a fallback; with one, one checkpoint
    read and the losses of a run restored from the same checkpoint;
  - ``batch="shrink"`` and ``batch="rescale"``;
  - LocalSGD, and the explicit dcn hop losing its dcn axis, refused
    before the world changes, as the JAX package refuses them; no
    recompile where the JAX package's reshard costs one.
"""
import os
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.distributed import resharding as jrs
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.utils import fault_injection as jfi

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import resharding as prs
from paddle_tpu_torch.utils import fault_injection as pfi
from helpers import torch_world as tw
from test_torch_fleet_strategy import _fresh_process_state, _sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
REL = 1e-5

#: name -> (axes, degrees): the meshes the planners are held on
MESHES = {
    "dp4": (("dp", "pp", "sp", "mp"), (4, 1, 1, 1)),
    "dp8": (("dp", "pp", "sp", "mp"), (8, 1, 1, 1)),
    "dp2xmp2": (("dp", "pp", "sp", "mp"), (2, 1, 1, 2)),
    "dcn2xici4": (("dcn", "ici", "pp", "sp", "mp"), (2, 4, 1, 1, 1)),
    "dcn2xici2xmp2": (("dcn", "ici", "pp", "sp", "mp"), (2, 2, 1, 1, 2)),
}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("PADDLE_FAULT_SPEC", "PADDLE_RESHARD_NOTICE_FILE"):
        monkeypatch.delenv(k, raising=False)
    jfi.reset()
    pfi.reset()
    yield
    jfi.reset()
    pfi.reset()


def _lost_sets(n, seed=0):
    sets = [[r] for r in range(n)]
    sets += [[a, b] for a in range(n) for b in range(a + 1, n)]
    rng = np.random.RandomState(seed)
    for k in range(3, n + 1):
        for _ in range(3):
            sets.append(sorted(rng.choice(n, k, replace=False).tolist()))
    return sets


def _plan(mod, mesh, lost):
    try:
        p = mod.plan_refactoring(mesh, lost)
    except Exception as e:  # noqa: BLE001 - the type is compared
        return type(e).__name__
    return (dict(p.new_dims), list(p.survivor_ranks),
            list(p.dropped_ranks), list(p.lost_ranks), p.describe())


@pytest.mark.parametrize("name", list(MESHES))
def test_planner_matches_reference(name):
    axes, degrees = MESHES[name]
    n = int(np.prod(degrees))
    jmesh = Mesh(np.array(jax.devices()[:n]).reshape(degrees), axes)
    pmesh = prs.MeshLayout(axes, dict(zip(axes, degrees)))
    for lost in [[]] + _lost_sets(n):
        want = _plan(jrs, jmesh, lost)
        got = _plan(prs, pmesh, lost)
        assert got == want, (name, lost)
    # a lost rank past the mesh is the same error in both
    assert _plan(prs, pmesh, [n]) == _plan(jrs, jmesh, [n]) \
        == "ReshardError"


def test_planner_new_mesh_keeps_the_survivors_order():
    """The new mesh's ranks (in the first numbering) are the JAX plan's
    devices, in its order: the survivors renumber in that order."""
    axes, degrees = MESHES["dcn2xici4"]
    devs = jax.devices()[:8]
    jmesh = Mesh(np.array(devs).reshape(degrees), axes)
    pmesh = prs.MeshLayout(axes, dict(zip(axes, degrees)))
    for lost in ([5], [0, 6], [1, 2, 7]):
        jp = jrs.plan_refactoring(jmesh, lost)
        pp = prs.plan_refactoring(pmesh, lost)
        want = [devs.index(d) for d in np.asarray(jp.new_mesh.devices)
                .reshape(-1)]
        assert pp.new_mesh.ranks == want
        assert pp.new_mesh.devices.shape == np.asarray(
            jp.new_mesh.devices).shape
        again = prs.plan_refactoring(pp.new_mesh, [])
        assert again.new_mesh.ranks == want


def test_factoring_str_matches_reference():
    for dims in ({"dp": 4}, {"dp": 1}, {"dp": 2, "pp": 1, "sp": 1, "mp": 2},
                 {"dcn": 2, "ici": 3, "pp": 1, "sp": 1, "mp": 1},
                 {"dcn": 1, "ici": 1, "mp": 4}, {"pp": 1, "mp": 1}, {}):
        assert prs.factoring_str(dims) == jrs.factoring_str(dims)


def test_coverage_verdicts_match_reference():
    """Replicated over dp (an mp shard on the JAX side, ``P(None, "mp")``):
    covered while each mp index keeps a row; dp-sharded (a ZeRO shard of an
    mp shard, ``P("dp", "mp")``): uncovered once a holder is lost; both
    packages, every lost set of dp8 and of dp4 x mp2."""
    for degrees in ((8, 1, 1, 1), (4, 1, 1, 2)):
        axes = ("dp", "pp", "sp", "mp")
        devs = np.array(jax.devices()[:8]).reshape(degrees)
        jmesh = Mesh(devs, axes)
        flat = devs.reshape(-1)
        rep = jax.device_put(np.ones((8, 4), np.float32),
                             NamedSharding(jmesh, P(None, "mp")))
        shard = jax.device_put(np.ones((8, 4), np.float32),
                               NamedSharding(jmesh, P("dp", "mp")))
        layout = prs.MeshLayout(axes, dict(zip(axes, degrees)))
        leaves = {"rep": prs.Leaf.replicated(np.ones((8, 4)), layout),
                  "shard": prs.Leaf.dp_sharded(np.ones((2, 4)), layout)}
        for lost in [[]] + _lost_sets(8):
            want = jrs.coverage_report({"rep": rep, "shard": shard},
                                       {flat[r] for r in lost})
            assert prs.coverage_report(leaves, set(lost)) == want, lost
        # a host value is covered in both
        assert prs.leaf_coverage(np.ones(3), {0}) \
            == jrs.leaf_coverage(np.ones(3), {flat[0]}) is True


@pytest.mark.parametrize("spec,hits", [
    ("rank:depart:2:1,rank:return:4:1", 4),
    ("rank:depart:1", 1),
    ("rank:depart:1:3,rank:depart:1:0,rank:return:3", 3),
])
def test_rank_grammar_matches_reference(spec, hits):
    """The armed events, in order, after each hit of the ``rank`` site."""
    ji, pi = jfi.FaultInjector(spec), pfi.FaultInjector(spec)
    for _ in range(hits):
        ji.fire("rank")
        pi.fire("rank")
        assert pi.rank_events == ji.rank_events


def test_rank_rules_rejected_and_drained_as_reference(monkeypatch):
    for mod in (jfi, pfi):
        with pytest.raises(ValueError, match="un-instrumented"):
            mod.FaultInjector("grad:depart:1")
        monkeypatch.setenv("PADDLE_FAULT_SPEC", "rank:depart:1:2")
        mod.reset()
        assert mod.consume_rank_events() == [("depart", 2)]
        assert mod.consume_rank_events() == []


def test_notice_rows_and_offsets_match_reference(tmp_path, monkeypatch):
    """The same bytes, appended in pieces (a torn last line, a blank line,
    a line that is no JSON, an event the channel ignores): each poll gives
    the same rows and the same offset in both packages."""
    path = tmp_path / "notice"
    monkeypatch.setenv("PADDLE_RESHARD_NOTICE_FILE", str(path))
    pieces = [b'{"event": "depart", "ranks": [2], "time": 1.0}\n{"event"',
              b': "return", "ranks": [2]}\n\nnot json\n',
              b'{"event": "noop"}\n{"event": "lend", "ranks": [1]}',
              b'\n']
    assert prs.read_launcher_notices(0) == jrs.read_launcher_notices(0) \
        == ([], 0)
    off_j = off_p = 0
    with open(path, "wb") as f:
        for piece in pieces:
            f.write(piece)
            f.flush()
            rows_j, off_j = jrs.read_launcher_notices(off_j)
            rows_p, off_p = prs.read_launcher_notices(off_p)
            assert (rows_p, off_p) == (rows_j, off_j)


def test_policy_is_read_off_the_strategy():
    """``strategy.elastic_reshard`` through ``fleet.distributed_optimizer``
    and ``TrainStep`` (the JAX package's reading); bad values raise as in
    the JAX package; off and a lost quorum turn a departure into
    ``RankLostError``."""
    from paddle_tpu_torch.distributed import comm, fleet

    pt.set_device("cpu")
    s = fleet.DistributedStrategy()
    s.elastic_reshard = "shrink"
    s.elastic_reshard_configs = {"quorum": 0.75, "batch": "shrink"}
    fleet.init(is_collective=True, strategy=s)
    net = tw.reshard_net()
    opt = fleet.distributed_optimizer(pt.optimizer.Adam(
        parameters=net.parameters()))
    est = prs.ElasticStep(pt.jit.TrainStep(net, tw._ce_loss, opt))
    assert (est.policy, est.quorum, est.batch) == ("shrink", 0.75, "shrink")
    assert est.dp_size() == 1 and est.live_ranks == [0]
    assert est.pending_role() is None
    with pytest.raises(ValueError, match="shrink_expand"):
        prs.ElasticStep(est.step, policy="auto")
    with pytest.raises(ValueError, match="rescale"):
        prs.ElasticStep(est.step, batch="grow")
    for policy, match in (("off", "relaunch"), ("shrink", "quorum")):
        e = prs.ElasticStep(est.step, policy=policy)
        e.notify_departure(0)
        with pytest.raises(prs.RankLostError, match=match):
            e._poll_notices()
    comm._reset()


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _batches(n, batch, classes=10, seed=7):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, 16).astype(np.float32),
             (np.arange(batch) % classes).astype(np.int64))
            for _ in range(n)]


def _jax_loss(o, y):
    return jpaddle.nn.functional.cross_entropy(o, y)


def _jax_net(init):
    net = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 10))
    net.set_state_dict(init)
    return net


def _jax_run(estep, data, events):
    losses = []
    for i, (x, y) in enumerate(data):
        ev = events.get(i)
        if ev is not None:
            getattr(estep, f"notify_{ev[0]}")(ev[1])
        losses.append(float(estep(estep.shard_input(x),
                                  estep.shard_input(y)).numpy()))
    return losses


def _jax_world_reset():
    _fresh_process_state()
    jax_comm._state.default_group = None
    jax_comm._state.groups = {}
    jax_comm.init_parallel_env()


def _references(x, tmp):
    """The JAX package's ElasticStep on the world's programs."""
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.observability import bus as jbus

    ref = {}
    try:
        bus_file = os.path.join(tmp, "jax_telemetry.jsonl")
        os.environ["PADDLE_OBS_BUS_FILE"] = bus_file
        jax_comm.init_hybrid_mesh(dp=4)
        net = _jax_net(x["rs_init"])
        est = jrs.ElasticStep(JTrainStep(net, _jax_loss, joptim.Adam(
            learning_rate=1e-3, parameters=net.parameters())),
            policy="shrink_expand")
        ref["api"] = {"losses": _jax_run(est, x["rs_data"], {
            3: ("departure", 2), 6: ("return", 2)}), "params": _sd(net),
            "compiles": sum(
                r["kind"] == "recompile"
                and r["payload"].get("label") == "TrainStep"
                for r in jbus.read_stream(bus_file))}
        os.environ.pop("PADDLE_OBS_BUS_FILE")
        _jax_world_reset()
        s = jfleet.DistributedStrategy()
        s.localsgd, s.localsgd_configs = True, {"k_steps": 2}
        jfleet.init(is_collective=True, strategy=s)
        net = _jax_net(x["rs_init"])
        step = JTrainStep(net, _jax_loss, jfleet.distributed_optimizer(
            joptim.SGD(learning_rate=0.1, parameters=net.parameters())))
        # its ElasticStep does not reach the refusal (its inventory reads
        # step fields a LocalSGD TrainStep lacks): the executor refuses
        try:
            step.rebind_mesh(jax_comm.hybrid_mesh())
            ref["localsgd"] = None
        except NotImplementedError as e:
            ref["localsgd"] = str(e)
        _jax_world_reset()
        os.environ["PADDLE_FAULT_SPEC"] = "rank:depart:2:3"
        jfi.reset()
        jax_comm.init_hybrid_mesh(dp=2, mp=2)
        mlp = _jax_mlp(x["rs_tp_init"])
        est = jrs.ElasticStep(JTrainStep(mlp, _jax_loss, joptim.Adam(
            learning_rate=1e-2, parameters=mlp.parameters())),
            policy="shrink")
        ref["fault"] = {"losses": _jax_run(est, x["rs_tp_data"], {}),
                        "params": _sd(mlp),
                        "mesh": dict(est.mesh.shape)}
    finally:
        os.environ.pop("PADDLE_FAULT_SPEC", None)
        os.environ.pop("PADDLE_OBS_BUS_FILE", None)
        jfi.reset()
        _jax_world_reset()
    return ref


def _jax_mlp(init):
    """``lars_mlp``'s function, dense: the JAX package's tensor-parallel
    layers keep the mesh they were built on (``meta_parallel.py:31``'s
    constraint), so its reshard of them fails on the new mesh; the dense
    layers of the same weights give the same numbers."""
    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.col = jnn.Linear(16, 24)
            self.row = jnn.Linear(24, 8)

        def forward(self, v):
            return self.row(jpaddle.nn.functional.relu(self.col(v)))

    mlp = MLP()
    mlp.set_state_dict(init)
    return mlp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from paddle_tpu_torch.core import device as pt_device

    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    f = np.float32
    rng = np.random.RandomState(5)
    pt.seed(0)
    x = {"rs_init": {k: v.numpy() for k, v in
                     tw.reshard_net().state_dict().items()},
         "rs_data": _batches(9, 12), "rs_zero_data": _batches(5, 24, seed=9),
         "rs_tp_data": _batches(4, 8, classes=8, seed=3),
         "rs_tp_init": {"col.weight": (rng.rand(16, 24) - .5).astype(f),
                        "col.bias": rng.rand(24).astype(f),
                        "row.weight": (rng.rand(24, 8) - .5).astype(f),
                        "row.bias": rng.rand(8).astype(f)}}
    tmp = str(tmp_path_factory.mktemp("reshard"))
    ref = _references(x, tmp)
    try:
        out = tw.run_world(["reshard_api", "reshard_fault", "reshard_zero",
                            "reshard_batch", "reshard_refusals"], tmp, x,
                           nprocs=WORLD)
    finally:
        pt_device._current = saved
        _fresh_process_state()
    yield x, ref, out, tmp


def test_dp4_dp3_dp4_matches_reference(world):
    x, ref, out, _ = world
    want = ref["api"]
    for r, o in enumerate(out["reshard_api"]):
        assert o["dps"] == [4, 4, 4, 3, 3, 3, 4, 4, 4]
        assert o["reshards"] == 2 and o["io_loads"] == 0, r
        got = [v for v in o["losses"] if v is not None]
        expect = [v for i, v in enumerate(want["losses"])
                  if r != 2 or i not in (3, 4, 5)]
        np.testing.assert_allclose(got, expect, rtol=REL, err_msg=f"{r}")
        # rank 2 is out for steps 4-6: no loss, no work
        assert (o["losses"][3:6] == [None] * 3) == (r == 2)
        for k, v in want["params"].items():
            np.testing.assert_allclose(o["params"][k], v, rtol=REL,
                                       atol=1e-6, err_msg=f"{k} {r}")


def test_returning_rank_state_equals_survivors(world):
    """After the return and two more steps, every rank's parameters and
    Adam moments are bit-equal (the returning rank took them from a
    survivor)."""
    _, _, out, _ = world
    o0 = out["reshard_api"][0]
    for o in out["reshard_api"][1:]:
        for k, v in o0["params"].items():
            np.testing.assert_array_equal(o["params"][k], v)
        for a, b in zip(sorted(o["moments"], key=np.shape),
                        sorted(o0["moments"], key=np.shape)):
            np.testing.assert_array_equal(a, b)


def test_reshard_rows_and_timeline(world):
    """Each rank's two ``reshard`` rows carry the JAX package's keys; the
    shrink sends no bytes (each survivor holds the replicated state), the
    return sends the state; ``tools/timeline.py`` renders them."""
    _, _, out, tmp = world
    keys = {"trigger", "lost", "survivors", "dropped", "old", "new",
            "covered", "fallback", "uncovered", "bytes_moved", "wall_s"}
    for o in out["reshard_api"]:
        shrink, grow = o["rows"]
        assert set(shrink) == set(grow) == keys
        assert (shrink["old"], shrink["new"], grow["new"]) == \
            ("dp4", "dp3", "dp4")
        assert shrink["lost"] == [2] and grow["lost"] == []
        assert shrink["survivors"] == [0, 1, 3]
        assert shrink["covered"] and not shrink["fallback"]
        assert shrink["trigger"] == grow["trigger"] == "api"
        assert shrink["bytes_moved"] == 0 < grow["bytes_moved"]
    from paddle_tpu_torch.observability import bus

    stream = bus.read_stream(os.path.join(tmp, "telemetry.rank0.jsonl"))
    rows = [r for r in stream if r["kind"] == "reshard"]
    assert [r["payload"]["new"] for r in rows] == ["dp3", "dp4"]
    sys.path.insert(0, REPO)
    try:
        from tools import timeline
    finally:
        sys.path.pop(0)
    trace = timeline.chrome_trace({0: stream}, {})
    slices = [e for e in trace["traceEvents"] if e.get("tid") == "reshard"]
    assert len(slices) == 2 and slices[0]["ph"] == "X"
    assert "dp4->dp3" in slices[0]["name"]
    assert any("reshard rank 0: dp4 -> dp3" in ln
               for ln in timeline.summarize({0: stream}, {}))


def test_fault_spec_departure_matches_reference(world):
    """``rank:depart:2:3`` at dp2 x mp2: rank 3's dp row (ranks 2 and 3)
    retires at the second boundary, dp1 x mp2 runs on, as in the JAX
    package."""
    _, ref, out, _ = world
    want = ref["fault"]
    assert want["mesh"]["dp"] == 1 and want["mesh"]["mp"] == 2
    for r, o in enumerate(out["reshard_fault"]):
        assert o["policy"] == "shrink"
        assert o["dps"] == [2, 1, 1, 1]
        (row,) = o["rows"]
        assert (row["trigger"], row["lost"], row["survivors"]) == \
            ("fault", [3], [0, 1])
        assert (row["old"], row["new"]) == ("dp2xmp2", "dp1xmp2")
        assert o["out"] == (r >= 2)
        if r >= 2:
            assert o["losses"][1:] == [None] * 3
            continue
        np.testing.assert_allclose(o["losses"], want["losses"], rtol=REL)
        for k, v in want["params"].items():
            np.testing.assert_allclose(o["params"][k], v, rtol=REL,
                                       atol=1e-6, err_msg=f"{k} {r}")


def test_zero_departure_is_uncovered(world):
    _, _, out, _ = world
    for o in out["reshard_zero"]:
        assert "cover" in o["error"] and "moment1" in o["error"]


def test_zero_fallback_equals_a_restored_run(world):
    """With a fallback, the departure reads the checkpoint once and steps
    4 and 5 at dp3 give the losses of a run restored from it (one process,
    unsharded)."""
    from paddle_tpu_torch.framework import io as fio

    x, _, out, tmp = world
    st = fio.load(os.path.join(tmp, "zero_ck.pdparams"))
    net = tw.reshard_net()
    net.set_state_dict(st["m"])
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters())
    opt.set_state_dict(st["o"])
    step = pt.jit.TrainStep(net, tw._ce_loss, opt)
    want = [float(step(a, b)) for a, b in x["rs_zero_data"][3:]]
    for r, o in enumerate(out["reshard_zero"]):
        (row,) = o["rows"]
        assert not row["covered"] and row["fallback"]
        assert any("moment" in u for u in row["uncovered"])
        if r == 3:
            assert o["losses"][3:] == [None, None] and o["io_loads"] == 0
            continue
        assert o["dps"] == [3, 3] and o["io_loads"] == 1
        np.testing.assert_allclose(o["losses"][3:], want, rtol=REL)


def test_batch_policies(world):
    _, _, out, _ = world
    for r, o in enumerate(out["reshard_batch"]):
        assert o["shrink"] == ((None if r == 0 else 3), 3)
        assert o["rescale"] == ((None if r < 2 else 6), 2)
        assert "rescale" in o["indivisible"]


def test_no_recompile_where_the_reference_has_one(world):
    """The JAX package's reshard re-jits its step (one compile a new mesh
    on its recompile ledger); the port's eager step compiles nothing, so
    its bus has no ``recompile`` row."""
    from paddle_tpu_torch.observability import bus

    _, ref, _, tmp = world
    assert ref["api"]["compiles"] >= 2
    stream = bus.read_stream(os.path.join(tmp, "telemetry.rank0.jsonl"))
    assert not [r for r in stream if r["kind"] == "recompile"]


def test_refusals_before_the_world_changes(world):
    """LocalSGD is refused as the JAX package refuses it; the explicit dcn
    hop losing its dcn axis is the JAX package's ``ValueError``; either
    way on every rank, the world unchanged."""
    _, ref, out, _ = world
    assert "localsgd" in ref["localsgd"]
    for o in out["reshard_refusals"]:
        assert o["localsgd"].startswith("NotImplementedError")
        assert "localsgd" in o["localsgd"]
        assert o["dcn"].startswith("ValueError") and "dcn axis" in o["dcn"]
        assert o["localsgd_world"] == o["dcn_world"] == (WORLD, 0)
