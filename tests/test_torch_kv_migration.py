"""The port's KV migration plane against paddle_tpu's: ``KVBundle`` gather,
CRCs and wire form, resume across the two packages, the elastic slots
(``BlockPool.grow``/``shrink``, ``expand_slots``/``retire_slots``), and
``insert_migrated``'s refusals.

The model is ``test_torch_serving_tier.py``'s (imported from it): a
``TransformerLM`` with vocab 48, d_model 128, 4 heads, 2 layers, capacity
64, numpy weights loaded into the port by
``set_state_dict``, ``PADDLE_FLASH_DEFAULT=interpret`` and
``PADDLE_FUSED_LN=interpret``; the pools here are paged at block 16. The
JAX oracles are ``tests/test_serving_migration.py``'s
``TestQuantBundles`` and ``TestRetireRelocation`` and the bundle units of
``tests/test_serving_fault.py``; each ``paddle_tpu`` engine run compiles
its steps, so runs are shared through module fixtures.

Tolerances: none. Bundles (bytes, CRCs, wire JSON) and greedy tokens are
exactly equal; a resumed request's tokens equal the uninterrupted run's.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.distributed import comm
from paddle_tpu.distributed import quantized_comm as jqc
from paddle_tpu.nn.layers.transformer import MultiHeadAttention as JaxMHA
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import kv_migration as jkvm
from paddle_tpu.serving import paged_kv as jpk

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import quantized_comm as qc
from paddle_tpu_torch.jit import DecodeState, MigrateInsert
from paddle_tpu_torch.nn.layers.transformer import MultiHeadAttention
from paddle_tpu_torch.serving import Request
from paddle_tpu_torch.serving import kv_migration as kvm
from paddle_tpu_torch.serving import paged_kv as pk

from test_torch_serving_tier import CAP, _pair, env  # noqa: F401

BS = 16
PROMPT, BUDGET = [5, 6, 7, 9, 11, 2, 3], 12
QUANTS = (None, "int8", "fp8")


@pytest.fixture(scope="module")
def models(env):  # noqa: F811
    prev = comm._state.hybrid_mesh
    comm._state.hybrid_mesh = None
    comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)
    yield _pair()
    comm._state.hybrid_mesh = prev


def _quant_env(mp, quant):
    if quant is None:
        mp.delenv("PADDLE_SERVE_KV_QUANT", raising=False)
    else:
        mp.setenv("PADDLE_SERVE_KV_QUANT", quant)


def _mid_decode(eng, Req, rid="q", prompt=PROMPT, budget=BUDGET):
    """Submit one request and turn the engine until it has emitted
    tokens: the extraction point."""
    eng.submit(Req(list(prompt), max_new_tokens=budget, rid=rid))
    results = {}
    for _ in range(20):
        eng.turn(results)
        if eng.progress().get(rid):
            return
    raise AssertionError("the request never reached mid-decode")


def _engine(Engine, m, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_length", CAP)
    kw.setdefault("sync_every", 2)
    kw.setdefault("block_size", BS)
    return Engine(m, **kw)


def _resume_req(Req, man, rid="q"):
    return Req(list(man["prompt_ids"]), max_new_tokens=man["budget_left"],
               rid=rid, resume_tokens=list(man["resume"])
               + list(man["emitted"]))


@pytest.fixture(scope="module")
def jax_runs(models, tmp_path_factory):
    """Per quant policy: paddle_tpu's uninterrupted tokens, and a bundle
    it extracted mid-decode (the object and its blob)."""
    jm, _ = models
    out = {}
    d = tmp_path_factory.mktemp("blobs")
    with pytest.MonkeyPatch.context() as mp:
        for quant in QUANTS:
            _quant_env(mp, quant)
            eng = _engine(JaxEngine, jm)
            eng.submit(JaxRequest(list(PROMPT), max_new_tokens=BUDGET,
                                  rid="u"))
            oracle = eng.run()["u"].tokens
            src = _engine(JaxEngine, jm)
            _mid_decode(src, JaxRequest)
            b = src.extract_kv("q")
            path = str(d / f"jax_{quant}.json")
            b.write_blob(path)
            out[quant] = {"oracle": oracle, "blob": path, "bundle": b}
    return out


# ---------------------------------------------------------------------------
# the bundle: gather, CRCs and wire form equal paddle_tpu's
# ---------------------------------------------------------------------------


def _pools(quant, P=7, H=4, D=32, layers=2, seed=0):
    """The same paged caches in both packages: per layer a K and a V pool
    of random contents (float32, or an int8/fp8 payload with float32
    scales) and one table."""
    r = np.random.RandomState(seed)
    table = np.asarray([[3, 5, 1, 0], [2, 6, 4, 0]], np.int32)
    jc, tc = [], []
    for _ in range(layers):
        jbufs, tbufs = [], []
        for _ in range(2):
            if quant is None:
                a = r.randn(P, H, BS, D).astype(np.float32)
                jkv, tkv = jnp.asarray(a), torch.from_numpy(a.copy())
            else:
                raw = r.randint(0, 0x7E, size=(P, H, BS, D)) | \
                    (r.randint(0, 2, size=(P, H, BS, D)) << 7)
                raw = raw.astype(np.uint8)
                sc = r.rand(P, H, BS, D // 32).astype(np.float32)
                if quant == "int8":
                    q = raw.view(np.int8)
                    jq, tq = jnp.asarray(q), torch.from_numpy(q.copy())
                else:
                    jq = jnp.asarray(raw).view(jnp.float8_e4m3fn)
                    tq = torch.from_numpy(raw.copy()).view(
                        torch.float8_e4m3fn)
                jkv = jqc.QuantKV(jq, jnp.asarray(sc))
                tkv = qc.QuantKV(tq, torch.from_numpy(sc.copy()))
            jbufs.append(jpk.PagedKV(jkv, jnp.asarray(table)))
            tbufs.append(pk.PagedKV(tkv, torch.from_numpy(table.copy())))
        jc.append(JaxMHA.Cache(*jbufs))
        tc.append(MultiHeadAttention.Cache(*tbufs))
    return jc, tc


@pytest.mark.parametrize("quant", QUANTS)
def test_gathered_bundle_equals_paddle_tpu(quant):
    """Each package gathers the same blocks out of the same pools: equal
    leaves, CRCs and wire JSON, and each reads the other's blob."""
    jc, tc = _pools(quant)
    blocks = [5, 1, 6]
    man = {"rid": "r", "ctx": 40, "n_blocks": 3, "block_size": BS,
           "quant": quant}
    jb = jkvm.KVBundle(man, jkvm.gather_leaves(jc, blocks)).seal()
    tb = kvm.KVBundle(man, kvm.gather_leaves(tc, blocks)).seal()
    assert len(tb.leaves) == 4 and len(tb.leaves[0]) == (1 if quant is None
                                                         else 2)
    assert tb.manifest["crcs"] == jb.manifest["crcs"]
    assert tb.nbytes == jb.nbytes
    assert json.dumps(tb.to_wire()) == json.dumps(jb.to_wire())
    back = kvm.KVBundle.from_wire(jb.to_wire())
    assert back.verify() == [] and back.leaves[0][0].dtype == \
        tb.leaves[0][0].dtype
    assert json.dumps(back.to_wire()) == json.dumps(jb.to_wire())


def test_flip_bit_is_caught_by_verify_in_both_packages():
    jc, tc = _pools("int8")
    man = {"rid": "r", "n_blocks": 3}
    tb = kvm.KVBundle(man, kvm.gather_leaves(tc, [1, 2, 3])).seal()
    jb = jkvm.KVBundle.from_wire(tb.to_wire())
    assert tb.flip_bit(2) == jb.flip_bit(2) == 2
    assert tb.verify() == jb.verify() == [2]
    # the flipped bundle crosses the wire and is still caught there
    assert jkvm.KVBundle.from_wire(tb.to_wire()).verify() == [2]
    assert kvm.KVBundle.from_wire(jb.to_wire()).verify() == [2]
    assert json.dumps(tb.to_wire()) == json.dumps(jb.to_wire())


def test_cost_and_knobs_equal_paddle_tpu(monkeypatch):
    for env_v in ({}, {"PADDLE_SERVE_MIGRATE_COST_TOKENS": "7",
                       "PADDLE_SERVE_MIGRATE_COST_PER_KCTX": "2.5",
                       "PADDLE_SERVE_MIGRATE_TIMEOUT_MS": "40",
                       "PADDLE_SERVE_MIGRATE": "0"}):
        for k in ("PADDLE_SERVE_MIGRATE_COST_TOKENS",
                  "PADDLE_SERVE_MIGRATE_COST_PER_KCTX",
                  "PADDLE_SERVE_MIGRATE_TIMEOUT_MS", "PADDLE_SERVE_MIGRATE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env_v.items():
            monkeypatch.setenv(k, v)
        for ctx in (0, 100, 4096):
            assert kvm.migrate_cost_tokens(ctx) == \
                jkvm.migrate_cost_tokens(ctx)
        assert kvm.migrate_enabled() == jkvm.migrate_enabled()
        assert kvm.migrate_timeout_ms_default() == \
            jkvm.migrate_timeout_ms_default()


# ---------------------------------------------------------------------------
# resume across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", QUANTS)
def test_paddle_tpu_bundle_resumes_in_the_port(models, jax_runs, quant,
                                               monkeypatch):
    """A bundle paddle_tpu extracted mid-decode, read from its blob, splices
    into the port's engine and decodes on to paddle_tpu's uninterrupted
    tokens with no prefill."""
    _, tm = models
    _quant_env(monkeypatch, quant)
    run = jax_runs[quant]
    b = kvm.KVBundle.read_blob(run["blob"])
    assert b.verify() == [] and b.manifest["quant"] == quant
    # the narrow form crosses bit-exact: bytes as paddle_tpu gathered them
    for la, lb in zip(run["bundle"].leaves, b.leaves):
        for a, t in zip(la, lb):
            assert a.tobytes() == t.reshape(-1).view(torch.uint8) \
                .numpy().tobytes()
    man = b.manifest
    dst = _engine(pt.InferenceEngine, tm)
    assert dst.insert_migrated(_resume_req(Request, man), b) is True
    out = dst.run()
    assert list(man["emitted"]) + out["q"].tokens == run["oracle"]
    assert dst._prefill._n_steps == 0


@pytest.mark.parametrize("quant", QUANTS)
def test_port_bundle_resumes_in_paddle_tpu(models, jax_runs, quant,
                                           monkeypatch, tmp_path):
    """The reverse: the port extracts mid-decode and writes the blob;
    paddle_tpu reads it, splices it and decodes on to its own
    uninterrupted tokens with no prefill."""
    jm, tm = models
    _quant_env(monkeypatch, quant)
    src = _engine(pt.InferenceEngine, tm)
    _mid_decode(src, Request)
    b = src.extract_kv("q")
    assert b is not None and b.verify() == []
    assert b.manifest["quant"] == quant and b.n_blocks == 1
    path = str(tmp_path / "port.json")
    b.write_blob(path)
    jb = jkvm.KVBundle.read_blob(path)
    assert jb.verify() == []
    assert json.dumps(jb.to_wire()) == json.dumps(b.to_wire())
    man = jb.manifest
    dst = _engine(JaxEngine, jm)
    assert dst.insert_migrated(_resume_req(JaxRequest, man), jb) is True
    out = dst.run()
    assert list(man["emitted"]) + out["q"].tokens == \
        jax_runs[quant]["oracle"]
    assert dst._prefill._n_steps == 0


def test_extraction_manifest_equals_paddle_tpu(models, jax_runs):
    """The same request at the same point: the port's manifest equals
    paddle_tpu's, CRCs aside (float32 sums differ in the last bits)."""
    _, tm = models
    src = _engine(pt.InferenceEngine, tm)
    _mid_decode(src, Request)
    man = dict(src.extract_kv("q").manifest)
    want = dict(jax_runs[None]["bundle"].manifest)
    man.pop("crcs"), want.pop("crcs")
    assert man == want


# ---------------------------------------------------------------------------
# insert_migrated refuses where paddle_tpu's engine refuses
# ---------------------------------------------------------------------------


def test_insert_refusals_equal_paddle_tpu(models, jax_runs, monkeypatch):
    jm, tm = models
    monkeypatch.delenv("PADDLE_SERVE_KV_QUANT", raising=False)
    base = jax_runs[None]["bundle"].to_wire()

    def bundles(**change):
        w = json.loads(json.dumps(base))
        w["manifest"].update(change)
        return jkvm.KVBundle.from_wire(w), kvm.KVBundle.from_wire(w)

    def both(kw, change=None, leaves=None, quant=None):
        _quant_env(monkeypatch, quant)
        jb, tb = bundles(**(change or {}))
        if leaves is not None:
            jb.leaves, tb.leaves = jb.leaves[:leaves], tb.leaves[:leaves]
        man = tb.manifest
        got = []
        for Engine, Req, m, b in ((JaxEngine, JaxRequest, jm, jb),
                                  (pt.InferenceEngine, Request, tm, tb)):
            eng = _engine(Engine, m, **kw)
            got.append(eng.insert_migrated(_resume_req(Req, man), b))
        _quant_env(monkeypatch, None)
        return got

    cases = [
        ({}, {"block_size": 8}, None, None),          # block size
        ({}, {}, None, "int8"),                       # quant policy
        ({}, {"budget_left": 0}, None, None),         # nothing to decode
        ({}, {"budget_left": 60}, None, None),        # past capacity
        ({}, {"adapter": 2}, None, None),             # adapter not loaded
        ({}, {}, 3, None),                            # leaf count
        ({"pool_blocks": 2}, {}, None, None),         # pool cannot cover
        ({"block_size": 0}, {}, None, None),          # contiguous pool
    ]
    for kw, change, leaves, quant in cases:
        got = both(kw, change, leaves, quant)
        assert got == [False, False], (kw, change, leaves, quant)


def test_no_free_slot_refuses_like_paddle_tpu(models, jax_runs):
    """One slot: the first insert lands, the second finds no slot; both
    engines then decode the landed request to the same tokens."""
    jm, tm = models
    w = jax_runs[None]["bundle"].to_wire()
    out = []
    for Engine, Req, m, K in ((JaxEngine, JaxRequest, jm, jkvm),
                              (pt.InferenceEngine, Request, tm, kvm)):
        eng = _engine(Engine, m, slots=1)
        b = K.KVBundle.from_wire(w)
        first = eng.insert_migrated(_resume_req(Req, b.manifest), b)
        second = eng.insert_migrated(_resume_req(Req, b.manifest, "z"), b)
        out.append((first, second, eng.run()["q"].tokens))
    assert out[0] == out[1] and out[1][:2] == (True, False)


# ---------------------------------------------------------------------------
# elastic slots
# ---------------------------------------------------------------------------


def test_block_pool_grow_shrink_equal_paddle_tpu():
    def trace(pool):
        out = [pool.grow(3), pool.total, pool.free]
        a = pool.alloc(4)
        out += [a, pool.shrink(5), pool.total, pool.free]
        pool.release(a[:2])
        out += [pool.shrink(5), pool.total, pool.free, pool.grow(0),
                pool.alloc(pool.free + 1), pool.in_use]
        pool.release(a[2:])
        out += [pool.shrink(2), pool.total, sorted(pool._free)]
        return out

    assert trace(pk.BlockPool(5)) == trace(jpk.BlockPool(5))


def _elastic_run(Engine, Req, m, block_size):
    """Expand 2 -> 4 slots, serve 4 requests, retire 2 (relocating what
    is live on the top slots): slots, pool totals and tokens."""
    eng = _engine(Engine, m, block_size=block_size)
    facts = [eng.expand_slots(2), None if eng._pool is None
             else eng._pool.total, eng.free_blocks()]
    for i in range(4):
        eng.submit(Req([2, 3, 4, i], max_new_tokens=10, rid=f"r{i}"))
    results = {}
    for _ in range(30):
        eng.turn(results)
        if all(eng.progress().get(f"r{i}") for i in range(4)):
            break
    pre = dict(eng.progress())
    facts += [eng.retire_slots(2), eng.slots, eng.free_blocks(),
              sorted((s, st.req.rid) for s, st in eng._active.items())]
    results.update(eng.run())
    facts += [eng.slots, None if eng._pool is None else eng._pool.total]
    toks = {rid: r.tokens for rid, r in results.items()}
    for rid, p in pre.items():
        assert toks[rid][: len(p)] == p
    return facts, toks, eng._prefill._n_steps


@pytest.mark.parametrize("block_size", [BS, 0])
def test_expand_and_retire_slots_equal_paddle_tpu(models, block_size):
    jm, tm = models
    got = _elastic_run(pt.InferenceEngine, Request, tm, block_size)
    want = _elastic_run(JaxEngine, JaxRequest, jm, block_size)
    assert got == want
    assert got[0][0] == 4 and got[0][-2] == 2  # grew, then shrank to 2


def test_retire_relocates_active_top_slot(models):
    """tests/test_serving_migration.py::TestRetireRelocation on both
    packages: the live request on the top slot moves low with no prefill,
    the pool shrinks at once, and its tokens are the uninterrupted run's."""
    out = []
    for Engine, Req, m in ((JaxEngine, JaxRequest, models[0]),
                           (pt.InferenceEngine, Request, models[1])):
        ref = _engine(Engine, m)
        ref.submit(Req([2, 3, 4], max_new_tokens=12, rid="u"))
        oracle = ref.run()["u"].tokens
        eng = _engine(Engine, m, slots=4)
        for i in range(4):
            eng.submit(Req([2, 3, 4], max_new_tokens=12, rid=f"r{i}"))
        results = {}
        for _ in range(30):
            eng.turn(results)
            if all(eng.progress().get(f"r{i}") for i in range(4)):
                break
        top = max(eng._active)
        keep = eng._active[top].req.rid
        for i in range(4):
            if f"r{i}" != keep:
                assert eng.cancel(f"r{i}") is True
        steps = eng._prefill._n_steps
        pre = list(eng.progress()[keep])
        assert eng.retire_slots(2) == [] and eng.slots == 2
        new = next(s for s, st in eng._active.items()
                   if st.req.rid == keep)
        assert new < top
        res = eng.run()[keep].tokens
        assert res == oracle and res[: len(pre)] == pre
        assert eng._prefill._n_steps == steps
        out.append((top, new, res, eng._pool.total))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# MigrateInsert: the slot's state takes the source's mid-decode values
# ---------------------------------------------------------------------------


def test_migrate_insert_resets_slot_state(models):
    _, tm = models
    caches = tm.gen_cache(3, CAP, block_size=BS, pool_blocks=9)
    st = DecodeState.make(caches, first_tokens=np.zeros(3, np.int32),
                          pos=np.zeros(3, np.int32))
    nmax = CAP // BS
    rows = [tuple(torch.full((nmax,) + tuple(t.shape[1:]), float(i + 1))
                  for t in qc.tensors_of(leaf.kv))
            for i, leaf in enumerate(pk.paged_leaves(caches))]
    MigrateInsert()(st, rows, 1, [4, 7, 0, 0], ctx=19, last_tok=33,
                    temperature=0.5, top_k=3, top_p=0.9, eos_id=7,
                    budget=5, adapter=2)
    assert st.pos.tolist() == [0, 19, 0] and st.tok.tolist() == [0, 33, 0]
    assert st.done.tolist() == [False, False, False]
    assert st.temperature[1].item() == 0.5 and st.top_k[1].item() == 3
    assert abs(st.top_p[1].item() - 0.9) < 1e-7
    assert (st.eos[1].item(), st.budget[1].item(), st.adapter[1].item()) \
        == (7, 5, 2)
    leaf = next(pk.paged_leaves(caches))
    assert leaf.table[1].tolist() == [4, 7, 0, 0]
    assert float(leaf.kv[4].mean()) == float(leaf.kv[7].mean()) == 1.0
