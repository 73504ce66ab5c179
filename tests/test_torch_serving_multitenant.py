"""The port's multi-tenant serving tier against paddle_tpu's, on carried
weights: the refcounted copy-on-write prefix cache and adapter fleets.

The model, weights, knobs and helpers are ``test_torch_serving_tier.py``'s
(imported from it): a ``TransformerLM`` with vocab 48, d_model 128, 4
heads, 2 layers, capacity 64, numpy weights carried through
``set_state_dict``, ``PADDLE_FLASH_DEFAULT=interpret`` and
``PADDLE_FUSED_LN=interpret``. The JAX oracles are ``tests/test_serving.py``
(``TestPrefixCacheUnit``, ``TestAdapterSetUnit``) and
``tests/test_serving_multitenant.py`` (``TestPrefixSharingE2E``,
``TestAdapterFleetE2E``), without their router, migration, fault and
dryrun cases. Tolerances as there: greedy tokens equal, the adapter delta
within 1e-5 (float32).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import paged_kv as jpk
from paddle_tpu.serving import prefix_cache as jpx
from paddle_tpu.serving.adapters import AdapterSet as JaxAdapterSet

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.serving import Request
from paddle_tpu_torch.serving import paged_kv as pk
from paddle_tpu_torch.serving import prefix_cache as px
from paddle_tpu_torch.serving.adapters import AdapterSet

# the shared model, knobs and serving helper; ``env`` and ``models`` are
# module-scoped fixtures, instantiated anew for this module
from test_torch_serving_tier import (  # noqa: F401
    CAP, D, _pair, _serve, env, models,
)

PREAMBLE = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]  # 2 blocks of 8


def _numpy_state(state):
    """The port's state (or gradients by name) as numpy copies."""
    return {n: t.detach().cpu().numpy().copy() for n, t in state.items()}


@pytest.fixture(scope="module")
def jax_prefix_oracles(models):
    """paddle_tpu's tokens (paged engine, no prefix cache) for the
    preamble prompts of the prefix-sharing tests."""
    jm, _ = models
    reqs = [(PREAMBLE + [27], 8, "tail", {}), (PREAMBLE, 6, "p6", {}),
            (PREAMBLE, 12, "p12", {}), (PREAMBLE + [40], 7, "b", {})]
    _, toks = _serve(JaxEngine, JaxRequest, jm, reqs, block_size=8)
    return toks


# ---------------------------------------------------------------------------
# the prefix cache: index units on the same sequences
# ---------------------------------------------------------------------------


class TestPrefixCacheUnit:
    def _both(self, blocks=16, bs=4, capacity=None):
        return ((px.PrefixCache(bs, capacity=capacity), pk.BlockPool(blocks)),
                (jpx.PrefixCache(bs, capacity=capacity),
                 jpk.BlockPool(blocks)))

    @staticmethod
    def _publish(cache, pool, prompt):
        table = pool.alloc(len(prompt) // cache.block + 1)  # + decode tail
        cache.publish(pool, prompt, table)
        return table

    @staticmethod
    def _plan(share):
        return None if share is None else (
            share.src_blocks, share.ref_blocks, share.cow_src,
            share.tail_start)

    def test_chain_hash_equals_paddle_tpu(self):
        prev = 0
        for block in ([1, 2, 3, 4], [5, 6, 7, 8], PREAMBLE, [0] * 8,
                      [47, 46, 45, 44]):
            assert px.chain_hash(prev, block) == jpx.chain_hash(prev, block)
            prev = px.chain_hash(prev, block)
        a = px.chain_hash(0, [1, 2, 3, 4])
        # block j commits to every token before it
        assert px.chain_hash(px.chain_hash(0, [9, 2, 3, 4]),
                             [5, 6, 7, 8]) != px.chain_hash(a, [5, 6, 7, 8])

    def test_lookup_plans_equal_paddle_tpu(self):
        prompt = list(range(10, 22))  # 3 full blocks of 4
        probes = ([1, 2, 3, 4, 5], prompt[:8] + [40, 41, 42, 43, 44],
                  list(prompt), [99] + prompt[1:], prompt + [7])
        plans = []
        for cache, pool in self._both():
            table = self._publish(cache, pool, prompt)
            plans.append((table, [self._plan(cache.lookup(p))
                                  for p in probes]))
        assert plans[0] == plans[1]
        table, got = plans[0]
        assert got[0] is None and got[3] is None
        assert got[1] == (table[:2], table[:2], None, 8)
        # full match: the last shared block is copied on write
        assert got[2] == (table[:3], table[:2], table[2], len(prompt) - 1)

    def test_publish_refcounts_eviction_and_poison(self):
        def trace(cache, pool):
            out = []
            a = self._publish(cache, pool, list(range(8)))
            out += [pool.refcount(a[0]), len(cache)]
            cache.publish(pool, list(range(8)), a)  # only an LRU touch
            out.append(pool.refcount(a[0]))
            b = self._publish(cache, pool, list(range(100, 108)))
            pool.release(b)  # b's slot retires: its entries go idle
            cache.evict_for(pool, pool.free + 1)
            out += [self._plan(cache.lookup(list(range(8)))),
                    self._plan(cache.lookup(list(range(100, 108)))),
                    cache.evicted]
            out += [cache.poison(0), cache.poisoned,
                    self._plan(cache.lookup(list(range(8))))]
            pool.release(a)
            free0 = pool.free
            cache.clear(pool)
            out += [pool.free - free0, len(cache)]
            return out

        got, want = (trace(*pair) for pair in self._both(blocks=32))
        assert got == want
        assert got[0] == 2 and got[2] == 2  # slot + index
        assert got[3] is not None and got[4] is None  # busy entries stay

    def test_capacity_bound_evicts_oldest_subtree(self):
        def trace(cache, pool):
            a = self._publish(cache, pool, list(range(0, 8)))
            pool.release(a)
            self._publish(cache, pool, list(range(100, 108)))
            return [len(cache), self._plan(cache.lookup(list(range(8)))),
                    self._plan(cache.lookup(list(range(100, 108))))]

        got, want = (trace(*pair)
                     for pair in self._both(blocks=32, capacity=2))
        assert got == want and got[0] == 2 and got[1] is None

    def test_env_knobs(self, monkeypatch):
        assert not px.prefix_cache_enabled()
        monkeypatch.setenv("PADDLE_SERVE_PREFIX_CACHE", "1")
        monkeypatch.setenv("PADDLE_SERVE_PREFIX_BLOCKS", "5")
        assert px.prefix_cache_enabled() and px.prefix_blocks_default() == 5
        assert px.PrefixCache(8).capacity == 5


# ---------------------------------------------------------------------------
# prefix sharing on the engine
# ---------------------------------------------------------------------------


def _px_engine(tm, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_length", CAP)
    kw.setdefault("sync_every", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefix_cache", True)
    return pt.InferenceEngine(tm, **kw)


class TestPrefixSharing:
    def test_shared_preamble_prefills_tail_only(self, models,
                                                jax_prefix_oracles):
        _, tm = models
        prompt = PREAMBLE + [27]  # 2 shared blocks + a 1-token tail
        eng = _px_engine(tm, prefill_chunk=8)
        eng.submit(Request(prompt, max_new_tokens=8, rid="cold"))
        assert eng.run()["cold"].tokens == jax_prefix_oracles["tail"]
        steps_cold = eng._prefill._n_steps
        assert steps_cold == 3  # ceil(17 / 8) chunks
        eng.submit(Request(prompt, max_new_tokens=8, rid="warm"))
        assert eng.run()["warm"].tokens == jax_prefix_oracles["tail"]
        # one prefill call, for the one-token unshared tail
        assert eng._prefill._n_steps - steps_cold == 1
        assert eng._prefix_hits == 1 and eng._prefix_blocks_shared == 2

    def test_cow_isolation_divergent_continuations(self, models,
                                                   jax_prefix_oracles):
        _, tm = models
        o6, o12 = jax_prefix_oracles["p6"], jax_prefix_oracles["p12"]
        eng = _px_engine(tm, slots=3)
        eng.submit(Request(PREAMBLE, max_new_tokens=6, rid="a"))
        assert eng.run()["a"].tokens == o6
        # two concurrent full-prefix borrowers copy the last shared block
        # and decode different lengths side by side
        eng.submit(Request(PREAMBLE, max_new_tokens=6, rid="b"))
        eng.submit(Request(PREAMBLE, max_new_tokens=12, rid="c"))
        out = eng.run()
        assert out["b"].tokens == o6 and out["c"].tokens == o12
        assert eng._prefix_hits == 2 and eng._cow_copies == 2
        # no writer touched the cached blocks: a later borrower hits and
        # matches
        eng.submit(Request(PREAMBLE, max_new_tokens=6, rid="d"))
        assert eng.run()["d"].tokens == o6
        assert eng._prefix_hits == 3
        share = eng._prefix.lookup(PREAMBLE)
        assert all(eng._pool.refcount(b) == 1 for b in share.src_blocks)

    def test_admission_charges_unshared_blocks_only(self, models,
                                                    jax_prefix_oracles):
        _, tm = models
        eng = _px_engine(tm, pool_blocks=6)  # 5 usable blocks
        eng.submit(Request(PREAMBLE, max_new_tokens=8, rid="a"))
        eng.run()
        assert len(eng._prefix) == 2  # the preamble's 2 blocks
        # hold 2 blocks: 1 free < the cold charge of 3, so only the
        # shared-demand discount admits the borrower
        held = eng._pool.alloc(2)
        assert held is not None and eng._pool.free == 1
        eng.submit(Request(PREAMBLE + [40], max_new_tokens=7, rid="b"))
        assert eng.run()["b"].tokens == jax_prefix_oracles["b"]
        assert eng._admit_deferred == 0 and eng._prefix_hits == 1
        assert len(eng._prefix) == 2  # nothing was evicted
        eng._pool.release(held)

    def test_prefix_cache_needs_the_paged_pool(self, models, monkeypatch):
        _, tm = models
        assert _px_engine(tm, block_size=0)._prefix is None
        monkeypatch.setenv("PADDLE_SERVE_PREFIX_CACHE", "1")
        assert pt.InferenceEngine(tm, slots=1, max_length=CAP,
                                  block_size=8)._prefix is not None


# ---------------------------------------------------------------------------
# adapter fleets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleets(env):
    """A paddle_tpu model and the port's on the same weights, each with a
    4-row rank-2 fleet holding adapters 1 (seed 21) and 2 (seed 22), and
    paddle_tpu's mixed-batch tokens."""
    jm, tm = _pair()
    jad = JaxAdapterSet(jm, n_adapters=4, rank=2, scale=1.0)
    tad = AdapterSet(tm, n_adapters=4, rank=2, scale=1.0)
    for ad in (jad, tad):
        ad.load(1, seed=21)
        ad.load(2, seed=22)
    reqs = [([5, 6, 7, 8], 8, f"a{a}", {"adapter": a}) for a in (0, 1, 2)]
    _, mixed = _serve(JaxEngine, JaxRequest, jm, reqs, slots=3,
                      block_size=8)
    return jm, tm, jad, tad, mixed


class TestAdapters:
    def test_seeded_rows_equal_paddle_tpu(self, fleets):
        jm, tm, jad, tad, _ = fleets
        for jb, tb in zip(jm.blocks, tm.blocks):
            np.testing.assert_array_equal(tb.adapter_A.numpy(),
                                          np.asarray(jb.adapter_A._data))
            np.testing.assert_array_equal(tb.adapter_B.numpy(),
                                          np.asarray(jb.adapter_B._data))
        assert not tm.blocks[0].adapter_A[0].any()  # row 0: the base
        assert tad.resident == jad.resident == [0, 1, 2]

    def test_lifecycle_and_id_checks(self, env):
        _, tm = _pair()
        ad = AdapterSet(tm, n_adapters=4, rank=3)
        assert ad.resident == [0] and ad.is_loaded(0)
        ad.load(1, seed=11)
        ad.load(3, seed=12)
        assert ad.resident == [0, 1, 3]
        with pytest.raises(ValueError, match="out of range"):
            ad.load(0)  # row 0 is the reserved base row
        with pytest.raises(ValueError, match="out of range"):
            ad.load(4)
        ad.unload(1)
        assert not ad.is_loaded(1) and not tm.blocks[1].adapter_B[1].any()
        with pytest.raises(ValueError, match="n_adapters"):
            AdapterSet(tm, n_adapters=1)

    def test_env_knobs(self, env, monkeypatch):
        monkeypatch.setenv("PADDLE_SERVE_ADAPTERS", "3")
        monkeypatch.setenv("PADDLE_SERVE_ADAPTER_RANK", "5")
        monkeypatch.setenv("PADDLE_SERVE_ADAPTER_SCALE", "0.5")
        _, tm = _pair()
        ad = AdapterSet(tm)
        assert (ad.n_adapters, ad.rank, ad.scale) == (3, 5, 0.5)
        assert tuple(tm.blocks[0].adapter_B.shape) == (3, 4 * D, 5)

    def test_delta_matches_dense_reference_and_paddle_tpu(self, fleets):
        import paddle_tpu

        jm, tm, jad, _, _ = fleets
        x = np.random.RandomState(0).normal(size=(3, 4, D)).astype(
            np.float32)
        ids = np.asarray([0, 2, 1], np.int32)
        got = tm.blocks[0]._adapter_delta(torch.tensor(x),
                                          torch.tensor(ids)).numpy()
        want = np.asarray(jm.blocks[0]._adapter_delta(
            paddle_tpu.to_tensor(x), paddle_tpu.to_tensor(ids))._data)
        assert not got[0].any()  # id 0 adds exact zeros
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        a, b = jad.weights[2][0]
        dense = np.einsum("btr,fr->btf", np.einsum("btd,rd->btr", x, a), b)
        np.testing.assert_allclose(got[1], dense[1], atol=1e-5, rtol=0)

    def test_mixed_batch_matches_paddle_tpu_and_sequential(self, fleets,
                                                           models):
        _, tm, _, _, jax_mixed = fleets
        reqs = [([5, 6, 7, 8], 8, f"a{a}", {"adapter": a}) for a in (0, 1, 2)]
        _, mixed = _serve(pt.InferenceEngine, Request, tm, reqs, slots=3,
                          block_size=8)
        assert mixed == jax_mixed
        assert len({tuple(t) for t in mixed.values()}) == 3
        for r in reqs:
            _, alone = _serve(pt.InferenceEngine, Request, tm, [r],
                              block_size=8)
            assert alone == {r[2]: mixed[r[2]]}
        # adapter 0 is the base model: the same weights with no fleet
        _, base = _serve(pt.InferenceEngine, Request, models[1],
                         [([5, 6, 7, 8], 8, "a0", {})], block_size=8)
        assert base["a0"] == mixed["a0"]

    def test_generate_and_chunked_prefill_serve_the_fleet(self, fleets):
        """The fleet rides the whole-batch generate (adapter 0 there) and
        chunked prefill (the adapter's delta on every chunk)."""
        _, tm, _, _, jax_mixed = fleets
        reqs = [([5, 6, 7, 8], 8, "a2", {"adapter": 2})]
        _, chunked = _serve(pt.InferenceEngine, Request, tm, reqs,
                            prefill_chunk=2, block_size=8)
        assert chunked["a2"] == jax_mixed["a2"]
        toks = pt.generate(tm, [[5, 6, 7, 8]], 8)
        assert list(toks[0]) == jax_mixed["a0"]

    def test_unloaded_adapter_rejected_at_submit(self, fleets, models):
        _, tm, _, _, _ = fleets
        eng = pt.InferenceEngine(tm, slots=2, max_length=CAP, block_size=8)
        with pytest.raises(ValueError, match="adapter 3"):
            eng.submit(Request([5, 6], max_new_tokens=4, rid="x", adapter=3))
        bare = pt.InferenceEngine(models[1], slots=1, max_length=CAP)
        with pytest.raises(ValueError, match="no AdapterSet"):
            bare.submit(Request([5, 6], max_new_tokens=4, adapter=1))
        # the rejection left the engine serviceable
        eng.submit(Request([5, 6], max_new_tokens=4, rid="ok", adapter=1))
        assert len(eng.run()["ok"].tokens) == 4

    def test_weights_carry_the_fleet(self, fleets, env):
        """A paddle_tpu fleet's stacks ride ``set_state_dict`` into
        a port model with a fleet of the same shape, and back."""
        jm, _, jad, _, _ = fleets
        state = {k: np.array(v._data) for k, v in jm.state_dict().items()}
        assert "blocks.1.adapter_B" in state
        _, tm = _pair()
        AdapterSet(tm, n_adapters=4, rank=2)
        assert tm.set_state_dict(state) == ([], [])
        back = _numpy_state(tm.state_dict())
        for name in ("blocks.0.adapter_A", "blocks.1.adapter_B"):
            np.testing.assert_array_equal(back[name], state[name])
