"""The port's serving tier against paddle_tpu's, on carried weights: the
paged KV cache and chunked prefill (the prefix cache and adapter fleets
are in ``test_torch_serving_multitenant.py``, which imports this module's
model and helpers).

The model is ``test_torch_serving.py``'s: a ``TransformerLM`` with vocab
48, d_model 128, 4 heads, 2 layers (capacity 64 here, the engine tests'
``max_length``), its weights made by numpy and carried into the port
through ``set_state_dict``; both packages run with
``PADDLE_FLASH_DEFAULT=interpret`` and ``PADDLE_FUSED_LN=interpret``. The
JAX oracles are ``tests/test_serving_tier.py``'s ``TestPagedPrimitives``,
``TestPagedGenerateParity``, ``TestPagedEngine`` and
``TestChunkedPrefill``, without their quantized, dp2 x mp2, speculative,
router and telemetry cases. Each ``paddle_tpu`` engine run compiles its
steps, so each is made once per module and shared.

Tolerances: float32 logits atol 1e-4 (two packages, sums in different
orders through two layers); greedy tokens and the paged primitives' data
movement exactly equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.distributed import comm
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import TransformerLM as JaxLM
from paddle_tpu.serving import generate as jax_generate
from paddle_tpu.serving import paged_kv as jpk

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.jit import PrefillStep
from paddle_tpu_torch.serving import Request
from paddle_tpu_torch.serving import paged_kv as pk

VOCAB, D, HEADS, LAYERS, CAP = 48, 128, 4, 2, 64
LOGIT_ATOL = 1e-4
rng = np.random.RandomState(13)
#: the engine's request set: prompts of 9..18 tokens, 6 new each (2 or 3
#: blocks of 8)
ENGINE_PROMPTS = [rng.randint(0, VOCAB, size=int(n)) for n in
                  rng.randint(9, 19, size=4)]
NEAR_CAP = rng.randint(0, VOCAB, size=59)  # 59 + 5 new = the capacity


@pytest.fixture(scope="module")
def env():
    prev = comm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_FLASH_DEFAULT", "interpret")
        mp.setenv("PADDLE_FUSED_LN", "interpret")
        for k in ("PADDLE_SERVE_BLOCK_SIZE", "PADDLE_SERVE_BUCKETS",
                  "PADDLE_SERVE_PREFILL_CHUNK", "PADDLE_SERVE_PREFIX_CACHE",
                  "PADDLE_SERVE_PREFIX_BLOCKS", "PADDLE_SERVE_KV_QUANT",
                  "PADDLE_SERVE_ADAPTERS", "PADDLE_SERVE_ADAPTER_RANK",
                  "PADDLE_SERVE_ADAPTER_SCALE"):
            mp.delenv(k, raising=False)
        yield
    comm._state.hybrid_mesh = prev


def _random_state(shapes, seed=7):
    r = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
            a = 1 + 0.2 * r.randn(*shape)
        elif name.endswith("bias"):
            a = 0.2 * r.randn(*shape)
        elif "embed" in name:
            a = r.randn(*shape)
        else:  # [in, out] linear weights
            a = r.randn(*shape) / np.sqrt(shape[0])
        out[name] = a.astype(np.float32)
    return out


def _pair():
    """A paddle_tpu model and the port's, on the same numpy weights."""
    jm = JaxLM(VOCAB, d_model=D, num_heads=HEADS, num_layers=LAYERS,
               max_position=CAP)
    jm.eval()
    state = _random_state({k: tuple(v.shape)
                           for k, v in jm.state_dict().items()})
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected
    tm = pt.TransformerLM(VOCAB, d_model=D, num_heads=HEADS,
                          num_layers=LAYERS, max_position=CAP, device="cpu")
    assert tm.set_state_dict(state) == ([], [])
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def models(env):
    return _pair()


def _serve(Engine, Req, model, reqs, **kw):
    """Serve ``reqs`` ([(prompt, max_new, rid, extra kwargs)]) -> (engine,
    rid -> tokens)."""
    kw.setdefault("slots", 2)
    kw.setdefault("max_length", CAP)
    kw.setdefault("sync_every", 4)
    eng = Engine(model, **kw)
    for p, n, rid, extra in reqs:
        eng.submit(Req(list(p), max_new_tokens=n, rid=rid, **extra))
    return eng, {k: list(v.tokens) for k, v in eng.run().items()}


def _engine_reqs(prompts, n=6):
    return [(p, n, i, {}) for i, p in enumerate(prompts)]


# ---------------------------------------------------------------------------
# the paddle_tpu runs, once per module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_paged_engine(models):
    """paddle_tpu's paged engine over a pool of 4 usable blocks (each
    request needs 2 or 3): tokens by rid."""
    jm, _ = models
    _, toks = _serve(JaxEngine, JaxRequest, jm, _engine_reqs(ENGINE_PROMPTS),
                     block_size=8, pool_blocks=5)
    return toks


@pytest.fixture(scope="module")
def jax_chunked_engine(models):
    """paddle_tpu's chunked engine (chunk 4) on the same requests, and the
    near-capacity prompt at chunk 8."""
    jm, _ = models
    _, toks = _serve(JaxEngine, JaxRequest, jm, _engine_reqs(ENGINE_PROMPTS),
                     prefill_chunk=4)
    _, near = _serve(JaxEngine, JaxRequest, jm,
                     [(NEAR_CAP, 5, "near", {})], prefill_chunk=8)
    return toks, near["near"]


# ---------------------------------------------------------------------------
# paged_kv primitives, on the same numpy inputs
# ---------------------------------------------------------------------------


class TestPagedPrimitives:
    def test_block_math(self):
        for cap, bs in ((64, 8), (65, 8), (1, 8), (17, 8), (45, 8)):
            assert pk.num_blocks(cap, bs) == jpk.num_blocks(cap, bs)
            assert pk.blocks_for(cap, bs) == jpk.blocks_for(cap, bs)
        assert pk.blocks_for(0, 8) == jpk.blocks_for(0, 8) == 1

    def test_block_pool_alloc_ref_release(self):
        pools = (pk.BlockPool(6), jpk.BlockPool(6))  # 5 usable + trash

        def trace(pool):
            out = [pool.total, pool.free]
            a = pool.alloc(3)
            out += [a, pool.alloc(3), pool.free, pool.in_use]
            pool.ref(a[:2])
            out += [pool.refcount(b) for b in a]
            pool.release(a)
            out += [pool.free, pool.freed_total, pool.refcount(a[0])]
            pool.release(a[:2])
            out += [pool.free, pool.freed_total, pool.refcount(a[0]),
                    pool.alloc(5)]
            return out

        got, want = (trace(p) for p in pools)
        assert got == want
        assert 0 not in got[2] and got[3] is None

    def test_identity_and_explicit_tables(self):
        ident = pk.paged_zero(2, 4, 16, 8, block=8, device="cpu")
        want = jpk.paged_zero(2, 4, 16, 8, block=8)
        assert tuple(ident.kv.shape) == tuple(want.kv.shape) == (5, 4, 8, 8)
        np.testing.assert_array_equal(ident.table.numpy(),
                                      np.asarray(want.table))
        assert ident.table.tolist() == [[1, 2], [3, 4]]  # block 0 reserved
        pooled = pk.paged_zero(2, 4, 16, 8, block=8, pool_blocks=4,
                               device="cpu")
        assert pooled.kv.shape[0] == 4 and int(pooled.table.sum()) == 0
        with pytest.raises(ValueError, match="trash"):
            pk.paged_zero(2, 4, 16, 8, block=8, pool_blocks=1,
                          device="cpu")

    @pytest.mark.parametrize("pool_blocks", [None, 7])
    def test_write_then_gather_matches_paddle_tpu(self, pool_blocks):
        """Identity tables, and an explicit table with a shared and a trash
        entry: the pool after the write and the gathered view equal
        paddle_tpu's exactly."""
        r = np.random.RandomState(1)
        kv0 = r.randn(7 if pool_blocks else 9, 2, 4, 3).astype(np.float32)
        table = (np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
                 if pool_blocks is None else
                 np.asarray([[3, 1, 0, 0], [2, 6, 5, 0]], np.int32))
        new = r.randn(2, 2, 3, 3).astype(np.float32)
        pos = np.asarray([1, 6], np.int32)
        want_kv = np.asarray(jpk.paged_write(
            jnp.asarray(kv0), jnp.asarray(table), jnp.asarray(new),
            jnp.asarray(pos)))
        want_view = np.asarray(jpk.paged_gather(jnp.asarray(want_kv),
                                                jnp.asarray(table)))
        kv = torch.tensor(kv0)
        got_kv = pk.paged_write(kv, torch.tensor(table), torch.tensor(new),
                                torch.tensor(pos))
        assert got_kv is kv  # in place
        np.testing.assert_array_equal(got_kv.numpy(), want_kv)
        view = pk.paged_gather(got_kv, torch.tensor(table)).numpy()
        np.testing.assert_array_equal(view, want_view)
        for b in range(2):
            np.testing.assert_array_equal(view[b, :, pos[b]:pos[b] + 3],
                                          new[b])

    def test_splices_fetch_adopt_and_retire_match_paddle_tpu(self):
        r = np.random.RandomState(2)
        kv0 = r.randn(8, 2, 4, 3).astype(np.float32)
        table0 = np.asarray([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
        slot_kv = r.randn(1, 2, 16, 3).astype(np.float32)
        row = np.asarray([6, 7, 2, 0], np.int32)

        def both(jfn, tfn, *args):
            jres = jfn(jpk.PagedKV(jnp.asarray(kv0), jnp.asarray(table0)),
                       *args)
            tres = tfn(pk.PagedKV(torch.tensor(kv0), torch.tensor(table0)),
                       *args)
            return jres, tres

        for args in ((jnp.asarray(slot_kv), 1, jnp.asarray(row)),):
            j, t = both(jpk.paged_splice, lambda p, s, sl, rw: pk.paged_splice(
                p, torch.tensor(np.array(s)), sl, np.array(rw)), *args)
            np.testing.assert_array_equal(t.kv.numpy(), np.asarray(j.kv))
            np.testing.assert_array_equal(t.table.numpy(),
                                          np.asarray(j.table))
        # fetch: the inverse, into a contiguous scratch
        want = np.asarray(jpk.paged_fetch(
            jpk.PagedKV(jnp.asarray(kv0), jnp.asarray(table0)),
            jnp.zeros((1, 2, 16, 3)), jnp.asarray(row)))
        scratch = torch.zeros(1, 2, 16, 3)
        got = pk.paged_fetch(pk.PagedKV(torch.tensor(kv0),
                                        torch.tensor(table0)), scratch, row)
        assert got is scratch
        np.testing.assert_array_equal(got.numpy(), want)
        # the shared-prefix splice: CoW block 2 -> 6, then rows 9..12 only
        for cow in ((2, 6), (0, 0)):
            j = jpk.paged_splice_tail(
                jpk.PagedKV(jnp.asarray(kv0), jnp.asarray(table0)),
                jnp.asarray(slot_kv), 0, jnp.asarray(row), 9, 13, *cow)
            t = pk.paged_splice_tail(
                pk.PagedKV(torch.tensor(kv0), torch.tensor(table0)),
                torch.tensor(slot_kv), 0, row, 9, 13, *cow)
            np.testing.assert_array_equal(t.kv.numpy()[1:],
                                          np.asarray(j.kv)[1:])
            np.testing.assert_array_equal(t.table.numpy(),
                                          np.asarray(j.table))
        # adopt: migrated block rows, zero-padded to the table width
        rows = r.randn(4, 2, 4, 3).astype(np.float32)
        j = jpk.paged_adopt(jpk.PagedKV(jnp.asarray(kv0),
                                        jnp.asarray(table0)),
                            jnp.asarray(rows), 1, jnp.asarray(row))
        t = pk.paged_adopt(pk.PagedKV(torch.tensor(kv0),
                                      torch.tensor(table0)), rows, 1, row)
        np.testing.assert_array_equal(t.kv.numpy()[1:], np.asarray(j.kv)[1:])
        np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
        # retire: every table of the tree points the slot at trash
        tree = [(pk.PagedKV(torch.tensor(kv0), torch.tensor(table0)),
                 pk.PagedKV(torch.tensor(kv0), torch.tensor(table0)))]
        jtree = jpk.retire_tables(
            [(jpk.PagedKV(jnp.asarray(kv0), jnp.asarray(table0)),)], 1)
        pk.retire_tables(tree, 1)
        for leaf in tree[0]:
            np.testing.assert_array_equal(leaf.table.numpy(),
                                          np.asarray(jtree[0][0].table))

    def test_pool_bytes_smaller_than_worst_case(self, models):
        jm, tm = models
        paged = tm.gen_cache(4, 64, block_size=8, pool_blocks=9)
        contig = tm.gen_cache(4, 64)
        assert pk.pool_bytes(paged) < pk.pool_bytes(contig)
        worst = pk.worst_case_bytes(4, HEADS, 64, D // HEADS, itemsize=4,
                                    layers=LAYERS)
        assert pk.pool_bytes(contig) == worst == jpk.worst_case_bytes(
            4, HEADS, 64, D // HEADS, itemsize=4, layers=LAYERS)
        assert pk.pool_bytes(paged) == jpk.pool_bytes(
            jm.gen_cache(4, 64, block_size=8, pool_blocks=9))
        assert isinstance(paged[0].k, pk.PagedKV)
        assert tuple(paged[0].k.kv.shape) == (9, HEADS, 8, D // HEADS)

    def test_quantized_cache_raises(self, models, monkeypatch):
        """The int8/fp8 pool is served (``test_torch_quant_serving.py``);
        what still raises is what raises in paddle_tpu: an env value that
        names no width, and a quantized cache without a capacity."""
        jm, tm = models
        kv = tm.gen_cache(2, 64, dtype="int8", block_size=8)[0].k.kv
        assert tuple(kv.q.shape) == tuple(
            jm.gen_cache(2, 64, dtype="int8", block_size=8)[0].k.kv.q.shape)
        monkeypatch.setenv("PADDLE_SERVE_KV_QUANT", "int4")
        for bs in (8, 0):
            with pytest.raises(ValueError, match="PADDLE_SERVE_KV_QUANT"):
                tm.gen_cache(2, 64, block_size=bs)
        with pytest.raises(ValueError, match="PADDLE_SERVE_KV_QUANT"):
            pt.generate(tm, [[1, 2, 3]], 2, max_length=16)
        monkeypatch.delenv("PADDLE_SERVE_KV_QUANT")
        with pytest.raises(ValueError, match="static-capacity"):
            pt.nn.MultiHeadAttention(
                D, HEADS, device="cpu", generator=torch.Generator()
            ).gen_cache(batch_size=2, dtype="int8")


# ---------------------------------------------------------------------------
# generate through a paged cache
# ---------------------------------------------------------------------------


class TestPagedGenerate:
    PROMPTS = [[5, 17, 3, 40, 22, 9, 31, 2], [11, 4, 46, 8, 27], [7, 7, 1]]

    def test_logits_match_paddle_tpu_and_contiguous(self, models,
                                                    monkeypatch):
        jm, tm = models
        ref_t, ref_l = pt.generate(tm, self.PROMPTS, 8, max_length=48,
                                   return_logits=True)
        monkeypatch.setenv("PADDLE_SERVE_BLOCK_SIZE", "8")
        jt, jl = jax_generate(jm, self.PROMPTS, 8, max_length=48,
                              return_logits=True)
        tt, tl = pt.generate(tm, self.PROMPTS, 8, max_length=48,
                             return_logits=True)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_array_equal(tt, ref_t)
        np.testing.assert_allclose(tl, ref_l, atol=1e-5, rtol=0)

    def test_odd_capacity_rounds_up(self, models, monkeypatch):
        # cap 45 with block 8 -> 6 blocks, 48 rows: the tail padding is
        # position-masked like every unwritten row
        _, tm = models
        ref = pt.generate(tm, self.PROMPTS, 5, max_length=45)
        monkeypatch.setenv("PADDLE_SERVE_BLOCK_SIZE", "8")
        cache = tm.gen_cache(3, 45)
        assert tuple(cache[0].k.table.shape) == (3, 6)
        np.testing.assert_array_equal(
            pt.generate(tm, self.PROMPTS, 5, max_length=45), ref)

    def test_explicit_block_size_wins_over_env(self, models, monkeypatch):
        _, tm = models
        monkeypatch.setenv("PADDLE_SERVE_BLOCK_SIZE", "8")
        assert isinstance(tm.gen_cache(1, 16)[0].k, pk.PagedKV)
        assert isinstance(tm.gen_cache(1, 16, block_size=0)[0].k,
                          torch.Tensor)
        assert tm.gen_cache(1, 16, block_size=4)[0].k.kv.shape[2] == 4

    def test_speculative_decode_raises(self, models):
        """Speculative decoding runs (``test_torch_speculative.py``); what
        still raises is what raises in paddle_tpu: sampling, returned
        logits, and a ``spec_k`` against a prebuilt step's k."""
        _, tm = models
        with pytest.raises(ValueError, match="greedy-only"):
            pt.generate(tm, self.PROMPTS, 4, draft_model=tm,
                        temperature=0.7)
        with pytest.raises(ValueError, match="return_logits"):
            pt.generate(tm, self.PROMPTS, 4, draft_model=tm,
                        return_logits=True)
        step = pt.jit.SpeculativeDecodeStep(tm, tm, k=2)
        with pytest.raises(ValueError, match="conflicts"):
            pt.generate(tm, self.PROMPTS, 4, draft_model=tm, decode=step,
                        spec_k=3)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------


class TestPagedEngine:
    def test_small_pool_matches_paddle_tpu_and_contiguous(
            self, models, jax_paged_engine):
        _, tm = models
        reqs = _engine_reqs(ENGINE_PROMPTS)
        _, contig = _serve(pt.InferenceEngine, Request, tm, reqs)
        eng, paged = _serve(pt.InferenceEngine, Request, tm, reqs,
                            block_size=8, pool_blocks=5)
        assert paged == jax_paged_engine
        assert contig == jax_paged_engine
        assert eng.free_blocks() == 4  # every block came back
        assert eng._pool.freed_total > 0

    def test_admission_defers_until_blocks_free(self, models,
                                                jax_paged_engine):
        _, tm = models
        # 3 usable blocks: one request (2-3 blocks) at a time, though two
        # slots are free: admission is bound by blocks
        eng, toks = _serve(pt.InferenceEngine, Request, tm,
                           _engine_reqs(ENGINE_PROMPTS), block_size=8,
                           pool_blocks=4)
        assert toks == jax_paged_engine
        assert eng._admit_deferred > 0
        assert eng.needed_blocks(Request(ENGINE_PROMPTS[0], 6)) == \
            pk.blocks_for(ENGINE_PROMPTS[0].size + 6, 8)

    def test_hbm_scales_with_length_not_capacity(self, models):
        _, tm = models
        small = pt.InferenceEngine(tm, slots=2, max_length=64, block_size=8,
                                   pool_blocks=5)
        full = pt.InferenceEngine(tm, slots=2, max_length=64)
        assert pk.pool_bytes(small._state.caches) < \
            pk.pool_bytes(full._state.caches) / 2

    def test_unadmittable_request_raises(self, models):
        _, tm = models
        eng = pt.InferenceEngine(tm, slots=2, max_length=64, block_size=8,
                                 pool_blocks=3)
        with pytest.raises(ValueError, match="never be admitted"):
            eng.submit(Request(np.arange(30) % VOCAB, max_new_tokens=20))

    def test_misaligned_max_length_raises(self, models):
        _, tm = models
        with pytest.raises(ValueError, match="multiple"):
            pt.InferenceEngine(tm, slots=2, max_length=60, block_size=8)

    def test_trash_redirect_protects_reallocated_blocks(self, models):
        """A retired slot keeps writing at its frozen position while its
        freed block serves a new request: the new request's tokens equal
        a run alone on a fresh pool."""
        _, tm = models
        long_p = rng.randint(0, VOCAB, size=7)
        # 7 + 10 new = 3 blocks of 8: with the short request holding one
        # of the pool's 3, the long one waits for the retire and reuses
        # the freed block
        _, alone = _serve(pt.InferenceEngine, Request, tm,
                          [(long_p, 10, "long", {})], sync_every=2,
                          block_size=8, pool_blocks=4)
        eng, both = _serve(pt.InferenceEngine, Request, tm,
                           [([4, 5, 6], 2, "short", {}),
                            (long_p, 10, "long", {})], sync_every=2,
                           block_size=8, pool_blocks=4)
        assert both["long"] == alone["long"]
        assert eng._admit_deferred > 0

    def test_progress_and_cancel(self, models):
        _, tm = models
        eng = pt.InferenceEngine(tm, slots=1, max_length=64, sync_every=2,
                                 block_size=8, pool_blocks=5)
        for rid in ("a", "b", "c"):
            eng.submit(Request([4, 5, 6], max_new_tokens=6, rid=rid))
        results = {}
        eng.turn(results)
        assert eng.queue_depth() == 2 and eng.inflight() == 1
        assert eng.progress() == {"a": eng.progress()["a"], "b": [],
                                  "c": []}
        assert len(eng.progress()["a"]) == 3  # first token + one window
        assert eng.cancel("b") and eng.cancel("a")
        assert not eng.cancel("zz") and eng.free_blocks() == 4
        out = eng.run()
        assert set(out) == {"c"} and len(out["c"].tokens) == 6

    def test_left_out_engine_features_raise(self, models, monkeypatch):
        """What the engine leaves out answers as the JAX package's does: a
        contiguous pool has no migration plane (``extract_kv`` None,
        ``insert_migrated`` False), a no-op resize changes nothing, and a
        fault rule for a site the port has no fault point for raises."""
        from paddle_tpu_torch.utils import fault_injection as fi

        _, tm = models
        eng = pt.InferenceEngine(tm, slots=2, max_length=64, block_size=0)
        eng.submit(Request([1, 2, 3], max_new_tokens=6, rid=0))
        eng.turn({})
        assert eng.extract_kv(0) is None
        assert eng.insert_migrated(Request([1], rid=1), None) is False
        assert eng.expand_slots(0) == 2 and eng.retire_slots(0) == []
        monkeypatch.setenv("PADDLE_FAULT_SPEC", "ctl:flap:1")
        fi.reset()
        with pytest.raises(NotImplementedError, match="item 8"):
            fi.fault_point("serve")
        fi.reset()


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------


class TestChunkedPrefill:
    def test_prefill_step_start_seam(self, models):
        """Two half prompts through the start seam equal one whole-prompt
        prefill, in the port and against paddle_tpu's logits."""
        jm, tm = models
        p = rng.randint(0, VOCAB, size=(1, 8)).astype(np.int32)
        pre = PrefillStep(tm)
        whole, _, pos1 = pre(tm.gen_cache(1, 32), p, [8])
        _, caches, _ = pre(tm.gen_cache(1, 32), p[:, :4], [4])
        half, _, pos2 = pre(caches, p[:, 4:], [4], start=[4])
        assert int(pos2[0]) == int(pos1[0]) == 8
        np.testing.assert_allclose(half.numpy(), whole.numpy(), atol=1e-5,
                                   rtol=0)
        from paddle_tpu.jit.decode_step import PrefillStep as JaxPrefill

        want, _, _ = JaxPrefill(jm)(jm.gen_cache(1, 32), p,
                                    np.asarray([8], np.int32))
        np.testing.assert_allclose(half.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)

    def test_tokens_match_unchunked_and_paddle_tpu(self, models,
                                                   jax_chunked_engine,
                                                   jax_paged_engine):
        _, tm = models
        reqs = _engine_reqs(ENGINE_PROMPTS)
        _, chunked = _serve(pt.InferenceEngine, Request, tm, reqs,
                            prefill_chunk=4)
        assert chunked == jax_chunked_engine[0] == jax_paged_engine
        _, both = _serve(pt.InferenceEngine, Request, tm, reqs,
                         prefill_chunk=8, block_size=8, pool_blocks=9)
        assert both == jax_paged_engine

    def test_near_capacity_prompt_chunked(self, models, jax_chunked_engine):
        """A prompt at capacity minus its budget, chunked: the last chunk
        ends exactly at the capacity and no earlier row is overwritten."""
        _, tm = models
        reqs = [(NEAR_CAP, 5, "near", {})]
        _, whole = _serve(pt.InferenceEngine, Request, tm, reqs)
        _, chunked = _serve(pt.InferenceEngine, Request, tm, reqs,
                            prefill_chunk=8)
        _, paged = _serve(pt.InferenceEngine, Request, tm, reqs,
                          prefill_chunk=8, block_size=8)
        assert chunked["near"] == whole["near"] == paged["near"] \
            == jax_chunked_engine[1]

    def test_misaligned_prefill_chunk_raises(self, models):
        _, tm = models
        with pytest.raises(ValueError, match="prefill_chunk"):
            pt.InferenceEngine(tm, slots=2, max_length=60, prefill_chunk=8)

    def test_ttft_bound_under_long_prompt(self, models):
        """A short request admitted first finishes its decode while a long
        prompt is still prefilling in chunks."""
        _, tm = models
        eng = pt.InferenceEngine(tm, slots=2, max_length=64, sync_every=2,
                                 prefill_chunk=4)
        eng.submit(Request([4, 5, 6], max_new_tokens=4, rid="short"))
        eng.submit(Request(rng.randint(0, VOCAB, size=48), max_new_tokens=4,
                           rid="long"))
        res = eng.run()
        assert list(res) == ["short", "long"]
        assert res["short"].ttft_ms < res["long"].ttft_ms
        assert eng._prefill._n_steps == 1 + 48 // 4
