"""The port's greedy speculative decoding against paddle_tpu's, on carried
weights: ``generate(draft_model=, spec_k=)`` and ``SpeculativeDecodeStep``
round by round.

Both packages run in one process. The target is a ``TransformerLM`` at
vocab 48, d_model 32, 4 heads, 2 layers, capacity 64; the draft is
``tests/test_serving_tier.py``'s ``_draft_lm`` shape (1 layer, d_model 16,
2 heads); weights made by numpy and carried into the port through
``set_state_dict``, with ``PADDLE_FLASH_DEFAULT=interpret``
and ``PADDLE_FUSED_LN=interpret``. The JAX oracle is
``tests/test_serving_tier.py``'s ``TestSpeculativeDecode``.

Tolerances: none. Greedy tokens, each round's ``[B, k+1]`` emits (the -1
sentinels included) and the loop state (positions, done flags, budgets)
must be exactly equal: the accept rule compares argmaxes, and both
packages' argmaxes agree on these models (their logits lie within 1e-4,
``test_torch_serving_tier.py``). The rounds pin the reference's own
draft-cache gap: the draft never feeds its k-th token, so after a round
that accepts every draft, the draft's row ``pos + k`` stays stale and
acceptance drops (with the target as its own draft, the first round
accepts every draft and the next one rejects one). The port computes the
same rounds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.distributed import comm
from paddle_tpu.jit import PrefillStep as JaxPrefill
from paddle_tpu.jit import SpecDecodeState as JaxSpecState
from paddle_tpu.jit import SpeculativeDecodeStep as JaxSpecStep
from paddle_tpu.serving import TransformerLM as JaxLM
from paddle_tpu.serving import generate as jax_generate
from paddle_tpu.serving import sampling as jax_sampling

import paddle_tpu_torch as pt
from paddle_tpu_torch.jit import (PrefillStep, SpecDecodeState,
                                  SpeculativeDecodeStep, spec_k_default)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving import sampling

from test_torch_serving_tier import _random_state

VOCAB, CAP = 48, 64
PROMPTS = [[5, 17, 3, 40, 22, 9, 31, 2], [11, 4, 46, 8, 27], [7, 7, 1]]


@pytest.fixture(scope="module")
def env():
    prev = comm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_FLASH_DEFAULT", "interpret")
        mp.setenv("PADDLE_FUSED_LN", "interpret")
        for k in ("PADDLE_SERVE_BLOCK_SIZE", "PADDLE_SERVE_BUCKETS",
                  "PADDLE_SERVE_KV_QUANT", "PADDLE_SERVE_SPEC_K",
                  "PADDLE_SERVE_SYNC_EVERY", "PADDLE_Q_MATMUL"):
            mp.delenv(k, raising=False)
        yield
    comm._state.hybrid_mesh = prev


def _pair(d, heads, layers, seed):
    """A paddle_tpu model and the port's on the same numpy weights."""
    jm = JaxLM(VOCAB, d_model=d, num_heads=heads, num_layers=layers,
               max_position=CAP)
    jm.eval()
    state = _random_state({k: tuple(v.shape)
                           for k, v in jm.state_dict().items()}, seed)
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected
    tm = pt.TransformerLM(VOCAB, d_model=d, num_heads=heads,
                          num_layers=layers, max_position=CAP, device="cpu")
    assert tm.set_state_dict(state) == ([], [])
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def models(env):
    """(target pair, draft pair): the target 2 x 32 wide, the draft 1 x 16
    wide (its own weights)."""
    return _pair(32, 4, 2, seed=7), _pair(16, 2, 1, seed=99)


class TestTokenExact:
    @pytest.mark.parametrize("k", [1, 3, 5])
    def test_greedy_token_exact(self, models, k):
        (jm, tm), (jd, td) = models
        ref = pt.generate(tm, PROMPTS, 12)
        np.testing.assert_array_equal(ref, jax_generate(jm, PROMPTS, 12))
        out = pt.generate(tm, PROMPTS, 12, draft_model=td, spec_k=k)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(
            out, jax_generate(jm, PROMPTS, 12, draft_model=jd, spec_k=k))

    def test_eos_token_exact(self, models):
        (jm, tm), (jd, td) = models
        probe = pt.generate(tm, PROMPTS, 12)
        eos = int(probe[0, 3])  # a stop id that occurs
        ref = pt.generate(tm, PROMPTS, 12, eos_id=eos)
        out = pt.generate(tm, PROMPTS, 12, eos_id=eos, draft_model=td,
                          spec_k=3)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, jax_generate(
            jm, PROMPTS, 12, eos_id=eos, draft_model=jd, spec_k=3))
        assert (out == -1).any()

    @pytest.mark.parametrize("knobs", [
        {"PADDLE_SERVE_BLOCK_SIZE": "8"},
        {"PADDLE_SERVE_KV_QUANT": "int8"},
        {"PADDLE_SERVE_BLOCK_SIZE": "8", "PADDLE_SERVE_KV_QUANT": "fp8"}],
        ids=["paged", "int8", "paged-fp8"])
    def test_paged_and_quantized_kv(self, models, monkeypatch, knobs):
        """A round writes k + 1 rows through the block table and the
        quantizer: the plain loop's tokens under the same knobs, and
        paddle_tpu's."""
        (jm, tm), (jd, td) = models
        for name, value in knobs.items():
            monkeypatch.setenv(name, value)
        ref = pt.generate(tm, PROMPTS, 10)
        out = pt.generate(tm, PROMPTS, 10, draft_model=td, spec_k=3)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, jax_generate(
            jm, PROMPTS, 10, draft_model=jd, spec_k=3))


def _rounds(step, pre, dpre, gen_cache, dgen_cache, greedy, make, where,
            asnp, ids, lens, n_new, eos):
    """Prefill both models, then drive ``step`` round by round until every
    slot is done: [(emit, pos, done, budget)] as numpy."""
    B = len(lens)
    last, caches, pos = pre(gen_cache(B), ids, lens)
    _, dcaches, _ = dpre(dgen_cache(B), ids, lens)
    first = greedy(last)
    state = make(caches, dcaches, first, pos, eos_id=eos, budget=n_new - 1)
    state.done = first == state.eos
    state.tok = where(state.done, 0, first)
    out = []
    for _ in range(n_new - 1):
        emit, state = step(state)
        out.append(tuple(asnp(t) for t in (emit, state.pos, state.done,
                                           state.budget)))
        if asnp(state.done).all():
            break
    return asnp(first), out


class TestRounds:
    @pytest.mark.parametrize("draft", ["small", "self"])
    def test_rounds_match_paddle_tpu(self, models, draft):
        """Each round's emits (-1 sentinels included), positions, done
        flags and budgets equal paddle_tpu's, round for round; with the
        target as its own draft the first round accepts all k and the
        stale draft row then costs acceptance, in both packages."""
        (jm, tm), (jd, td) = models
        if draft == "self":
            jd, td = jm, tm
        ids, lens = engine_mod._pad_prompts(PROMPTS, 16)
        cap = 8 + 14 + 3
        # the small draft's run stops one slot at a stop id; the self
        # draft's runs on its budget
        eos = int(pt.generate(tm, PROMPTS, 14)[1, 6]) \
            if draft == "small" else None
        jf, want = _rounds(
            JaxSpecStep(jm, jd, k=3), JaxPrefill(jm), JaxPrefill(jd),
            lambda B: jm.gen_cache(B, cap), lambda B: jd.gen_cache(B, cap),
            jax_sampling.greedy, JaxSpecState.make,
            lambda c, a, b: jnp.where(c, jnp.int32(a), b), np.asarray,
            ids, lens, 14, eos)
        tf, got = _rounds(
            SpeculativeDecodeStep(tm, td, k=3), PrefillStep(tm),
            PrefillStep(td), lambda B: tm.gen_cache(B, cap),
            lambda B: td.gen_cache(B, cap), sampling.greedy,
            SpecDecodeState.make, torch.where, lambda t: t.numpy(),
            ids, lens, 14, eos)
        np.testing.assert_array_equal(tf, jf)
        assert len(got) == len(want)
        for r, (g, w) in enumerate(zip(got, want)):
            for name, a, b in zip(("emit", "pos", "done", "budget"), g, w):
                np.testing.assert_array_equal(a, b, err_msg=f"round {r} "
                                              f"{name}")
        emitted = np.stack([g[0] for g in got])  # [rounds, B, k+1]
        assert (emitted == -1).any()
        if draft == "self":
            # round 0 accepts all three drafts in every slot; the stale row
            # pos + k makes the next round reject
            assert (emitted[0] >= 0).all()
            assert (emitted[1] == -1).any()


class TestContract:
    def test_errors_and_k(self, models, monkeypatch):
        (_, tm), (_, td) = models
        with pytest.raises(ValueError, match="greedy-only"):
            pt.generate(tm, PROMPTS, 6, draft_model=td, temperature=0.8)
        with pytest.raises(ValueError, match="return_logits"):
            pt.generate(tm, PROMPTS, 6, draft_model=td, return_logits=True)
        with pytest.raises(ValueError, match="k >= 1"):
            SpeculativeDecodeStep(tm, td, k=0)
        with pytest.raises(ValueError, match="headroom"):
            pt.generate(tm, PROMPTS, 6, draft_model=td, spec_k=4,
                        max_length=8 + 6 + 3)

    def test_spec_k_env_default(self, models, monkeypatch):
        (_, tm), (_, td) = models
        assert spec_k_default() == 4
        assert SpeculativeDecodeStep(tm, td).k == 4
        monkeypatch.setenv("PADDLE_SERVE_SPEC_K", "7")
        assert spec_k_default() == 7
        assert SpeculativeDecodeStep(tm, td).k == 7
        monkeypatch.setenv("PADDLE_SERVE_SPEC_K", "0")
        assert spec_k_default() == 1  # clamped, as in paddle_tpu
        monkeypatch.setenv("PADDLE_SERVE_SPEC_K", "x")
        assert spec_k_default() == 4

    def test_prebuilt_step_k_drives_headroom(self, models):
        """A prebuilt step's k (8, above the default) sizes the cache's
        headroom; a conflicting spec_k raises."""
        (_, tm), (_, td) = models
        ref = pt.generate(tm, PROMPTS, 12)
        step = SpeculativeDecodeStep(tm, td, k=8)
        np.testing.assert_array_equal(
            pt.generate(tm, PROMPTS, 12, draft_model=td, decode=step), ref)
        with pytest.raises(ValueError, match="conflicts"):
            pt.generate(tm, PROMPTS, 12, draft_model=td, decode=step,
                        spec_k=3)

    def test_draft_prefill_reused_across_calls(self, models):
        (_, tm), (_, td) = models
        step = SpeculativeDecodeStep(tm, td, k=3)
        pt.generate(tm, PROMPTS, 8, draft_model=td, decode=step)
        dpre = step._draft_prefill
        assert dpre.model is td and dpre._n_steps == 1
        pt.generate(tm, PROMPTS, 8, draft_model=td, decode=step)
        assert step._draft_prefill is dpre and dpre._n_steps == 2


class TestHostReads:
    """tests/test_serving_tier.py:382-440: drafting more tokens per round
    adds no host read, and an explicit ``sync_every=0`` reads the device
    only after the loop."""

    READS = ("item", "tolist", "cpu", "numpy", "__bool__")

    def _count(self, monkeypatch, fn):
        n = {"reads": 0}
        for name in self.READS:
            real = getattr(torch.Tensor, name)

            def counting(self, *a, _real=real, **kw):
                n["reads"] += 1
                return _real(self, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counting)
        try:
            fn()
        finally:
            monkeypatch.undo()
        return n["reads"]

    def test_reads_independent_of_k(self, models, monkeypatch):
        (_, tm), (_, td) = models
        steps = {k: SpeculativeDecodeStep(tm, td, k=k) for k in (2, 5)}
        counts = {k: self._count(monkeypatch, lambda k=k: pt.generate(
            tm, PROMPTS, 9, draft_model=td, decode=steps[k],
            sync_every=100)) for k in steps}
        assert counts[2] == counts[5] <= 2

    def test_sync_every_zero_reads_after_the_loop(self, models,
                                                  monkeypatch):
        (_, tm), (_, td) = models
        step = SpeculativeDecodeStep(tm, td, k=2)
        counts = [self._count(monkeypatch, lambda n=n: pt.generate(
            tm, PROMPTS, n, draft_model=td, decode=step, sync_every=0))
            for n in (6, 12)]
        assert counts[0] == counts[1] <= 2
        # the default cadence checks the done mask every few rounds
        assert self._count(monkeypatch, lambda: pt.generate(
            tm, PROMPTS, 12, draft_model=td, decode=step,
            sync_every=1)) > counts[1]
