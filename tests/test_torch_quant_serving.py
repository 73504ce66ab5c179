"""The port's quantized serving against paddle_tpu's, on carried weights:
the block quantizer, the int8/fp8 KV cache (contiguous and paged, through
``generate`` and the engine) and the int8/fp8 weight checkpoint in both
directions.

Both packages run in one process on the same numpy inputs; models are
``TransformerLM`` at vocab 48, d_model 64 or 128, 4 heads, 2 layers,
capacity <= 64, weights made by numpy and carried into the port through
``set_state_dict``, with ``PADDLE_FLASH_DEFAULT=interpret``
and ``PADDLE_FUSED_LN=interpret``. The JAX oracles are
``tests/test_quantized_comm.py`` (``TestQuantizedKV``),
``tests/test_quantized_compute.py`` (``TestQuantizedCheckpoint``) and
``tests/test_serving_tier.py``'s quantized paged case.

Tolerances, each with its reason:
- quantizer payloads (fp8 compared as uint8 bytes), scales and
  dequantized values exactly equal: both packages compute ``x / scale``
  in float32, round half to even (int8) or cast (fp8), in one order;
- ``quantized_matmul`` within 1e-6 of its largest output (the widened
  weights are equal; 256 products summed in different orders);
- ``cached_attention`` over one quantized cache within 1e-5 of the
  largest output (the dequantized K/V are equal; softmax and the two
  products sum in different orders);
- ``generate`` tokens exactly equal, logits within 1e-4 (float32 through
  two layers in two packages, the tier tests' bound); paged int8 equal to
  contiguous int8 token for token and within 1e-5 (the gathered view
  holds the same values);
- a checkpoint written by either package loads into the other with the
  payload bytes equal after the transposition and the tokens of the
  writer's own narrow model, logits within 1e-4.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.distributed import comm
from paddle_tpu.distributed import quantized_comm as jqc
from paddle_tpu.distributed import quantized_compute as jqcp
from paddle_tpu.jit import load_quantized as jax_load_quantized
from paddle_tpu.jit import save_quantized as jax_save_quantized
from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import TransformerLM as JaxLM
from paddle_tpu.serving import generate as jax_generate
from paddle_tpu.serving import paged_kv as jpk
from paddle_tpu.serving.adapters import AdapterSet as JaxAdapterSet

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import quantized_comm as qc
from paddle_tpu_torch.distributed import quantized_compute as qcp
from paddle_tpu_torch.jit import load_quantized, save_quantized
from paddle_tpu_torch.nn.functional import attention as attn
from paddle_tpu_torch.serving import Request
from paddle_tpu_torch.serving import paged_kv as pk
from paddle_tpu_torch.serving.adapters import AdapterSet

from test_torch_serving_tier import _random_state, _serve

VOCAB, HEADS, LAYERS = 48, 4, 2
LOGIT_ATOL = 1e-4
WIDTHS = ["int8", "fp8"]
PROMPTS = [[5, 17, 3, 40, 22, 9, 31, 2], [11, 4, 46, 8, 27], [7, 7, 1]]
#: two blocks of 8: a full-prefix match copies its last block on write
PREAMBLE = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
_KNOBS = ("PADDLE_SERVE_BLOCK_SIZE", "PADDLE_SERVE_BUCKETS",
          "PADDLE_SERVE_PREFILL_CHUNK", "PADDLE_SERVE_PREFIX_CACHE",
          "PADDLE_SERVE_PREFIX_BLOCKS", "PADDLE_SERVE_KV_QUANT",
          "PADDLE_SERVE_ADAPTERS", "PADDLE_SERVE_ADAPTER_RANK",
          "PADDLE_SERVE_ADAPTER_SCALE", "PADDLE_SERVE_SPEC_K",
          "PADDLE_Q_MATMUL")


@pytest.fixture(scope="module")
def env():
    prev = comm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_FLASH_DEFAULT", "interpret")
        mp.setenv("PADDLE_FUSED_LN", "interpret")
        for k in _KNOBS:
            mp.delenv(k, raising=False)
        yield
    comm._state.hybrid_mesh = prev


def _pair(d=64, cap=64, seed=7):
    """A paddle_tpu model and the port's on the same numpy weights."""
    jm = JaxLM(VOCAB, d_model=d, num_heads=HEADS, num_layers=LAYERS,
               max_position=cap)
    jm.eval()
    state = _random_state({k: tuple(v.shape)
                           for k, v in jm.state_dict().items()}, seed)
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected
    tm = pt.TransformerLM(VOCAB, d_model=d, num_heads=HEADS,
                          num_layers=LAYERS, max_position=cap, device="cpu")
    assert tm.set_state_dict(state) == ([], [])
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def models(env):
    return _pair()


def _u8(a):
    """A payload as comparable numpy: fp8 as its bytes."""
    if isinstance(a, torch.Tensor):
        return qc.bits(a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and \
        a.dtype != np.int8 else a


def _blocks(kind, width, shape):
    """Test rows: ``random``; ``zero`` (random with every other row
    zero: scale 0, exact zeros back); ``ties`` (every value of x / scale
    halfway between two codes: int8 rounds half to even, fp8's cast
    too)."""
    r = np.random.RandomState(3)
    x = r.randn(*shape).astype(np.float32)
    if kind == "zero":
        x.reshape(-1, shape[-1])[::2] = 0.0
    elif kind == "ties":
        # int8: amax 127 -> scale 1, values k + 0.5; fp8: amax 448 ->
        # scale 1, values between codes 2 apart (16..32) or 1 apart (8..16)
        half = (np.arange(shape[-1]) % 9 - 4 + 0.5 if width == "int8"
                else np.where(np.arange(shape[-1]) % 2, 17.0, 9.5))
        x = np.broadcast_to(half, shape).astype(np.float32).copy()
        x[..., 0] = 127.0 if width == "int8" else 448.0
        x[..., 1::3] *= -1
    return x


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------


class TestQuantizer:
    @pytest.mark.parametrize("kind", ["random", "zero", "ties"])
    @pytest.mark.parametrize("width", WIDTHS)
    def test_lastaxis_equals_paddle_tpu(self, width, kind):
        # head dim 64 under block 128: one scale per row; 256: two blocks
        for shape in ((2, 3, 5, 64), (4, 256)):
            x = _blocks(kind, width, shape)
            jp, js = jqc.quantize_lastaxis(jnp.asarray(x), width, 128)
            tp, ts = qc.quantize_lastaxis(torch.tensor(x), width, 128)
            np.testing.assert_array_equal(_u8(tp), _u8(jp))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(
                qc.dequantize_lastaxis(tp, ts).numpy(),
                np.asarray(jqc.dequantize_lastaxis(jp, js)))
            assert ts.shape[-1] == shape[-1] // (64 if shape[-1] == 64
                                                 else 128)
        if kind == "zero":
            assert not qc.dequantize_lastaxis(tp, ts).numpy()[::2].any()

    @pytest.mark.parametrize("width", WIDTHS)
    def test_blockwise_equals_paddle_tpu(self, width):
        # 1000 values: seven blocks of 128 and a zero-padded eighth
        x = np.concatenate([_blocks(k, width, (8, 125)).reshape(-1)
                            for k in ("random", "zero", "ties")])[:1000]
        jp, js = jqc.quantize_blockwise(jnp.asarray(x), width, 128)
        tp, ts = qc.quantize_blockwise(torch.tensor(x), width, 128)
        assert tuple(tp.shape) == (8, 128)
        np.testing.assert_array_equal(_u8(tp), _u8(jp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            qc.dequantize_blockwise(tp, ts, (1000,)).numpy(),
            np.asarray(jqc.dequantize_blockwise(jp, js, (1000,))))
        assert qc.wire_bytes(1000, width) == jqc.wire_bytes(1000, width)

    @pytest.mark.parametrize("width", WIDTHS)
    def test_weight_quantizer_equals_paddle_tpu(self, width):
        """paddle's ``[in, out]`` weight in both packages: the same bytes
        and scales (in = 256 tiles block 128; in = 96 falls back to one
        scale per output)."""
        for i, o in ((256, 40), (96, 24)):
            w = _blocks("random", width, (i, o))
            jp, js = jqcp.quantize_weight(jnp.asarray(w), width, 128)
            tp, ts = qcp.quantize_weight(torch.tensor(w), width, 128)
            np.testing.assert_array_equal(_u8(tp), _u8(jp))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(
                qcp.dequantize_weight(tp, ts).numpy(),
                np.asarray(jqcp.dequantize_weight(jp, js)))
            x = np.random.RandomState(0).randn(3, i).astype(np.float32)
            want = np.asarray(jqcp.quantized_matmul(jnp.asarray(x), jp, js))
            np.testing.assert_allclose(
                qcp.quantized_matmul(torch.tensor(x), tp, ts).numpy(),
                want, atol=1e-6 * np.abs(want).max(), rtol=0)

    def test_policies_and_knobs(self, env, monkeypatch):
        assert qc.kv_quant_policy("INT8") == "int8"
        assert qc.kv_quant_policy(torch.float32) is None
        monkeypatch.setenv("PADDLE_SERVE_KV_QUANT", "fp8")
        assert qc.kv_quant_policy(None) == jqc.kv_quant_policy(None) == "fp8"
        monkeypatch.setenv("PADDLE_SERVE_KV_QUANT", "int4")
        for fn in (qc.kv_quant_policy, jqc.kv_quant_policy):
            with pytest.raises(ValueError, match="supported"):
                fn(None)
        with pytest.raises(ValueError, match="supported"):
            qc.resolve_policy("int4")
        assert qc.resolve_policy("fp8", 64) == ("fp8", 64)
        # PADDLE_Q_MATMUL arms the fake-quant matmul, which is not
        # ported: the port must raise, not compute at full width
        monkeypatch.setenv("PADDLE_Q_MATMUL", "int8")
        lin = pt.nn.Linear(8, 4, device="cpu", generator=torch.Generator())
        with pytest.raises(NotImplementedError, match="item 7"):
            lin(torch.ones(2, 8))
        monkeypatch.setenv("PADDLE_Q_MATMUL", "int3")
        with pytest.raises(ValueError, match="PADDLE_Q_MATMUL"):
            lin(torch.ones(2, 8))


# ---------------------------------------------------------------------------
# the cache seams over a QuantKV cache
# ---------------------------------------------------------------------------


def _jax_wrap(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_jax_wrap(t) for t in tree))
    return JaxTensor._wrap(jnp.asarray(tree))


def _torch_of(tree):
    if isinstance(tree, jpk.PagedKV):
        return pk.PagedKV(*(_torch_of(t) for t in tree))
    if isinstance(tree, jqc.QuantKV):
        return qc.QuantKV(*(_torch_of(t) for t in tree))
    a = np.asarray(tree)
    if a.dtype.itemsize == 1 and a.dtype != np.int8:  # fp8 bytes
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            qc.fp8_dtype())
    return torch.from_numpy(a.copy())


class TestCachedAttention:
    @pytest.mark.parametrize("width", WIDTHS)
    @pytest.mark.parametrize("sq", [1, 5])
    @pytest.mark.parametrize("layout", ["contiguous", "paged"])
    def test_update_then_attend_matches_paddle_tpu(self, env, layout, sq,
                                                   width):
        """Write ``sq`` new rows into a half-written quantized cache
        through ``cache_update``, then attend over it: the buffers equal
        paddle_tpu's bit for bit, the outputs within 1e-5 of the
        largest."""
        r = np.random.RandomState(5)
        B, H, cap, D, bs = 3, 2, 24, 16, 8
        pos = np.asarray([3, 11, 16], np.int32)
        hist = r.randn(B, H, cap, D).astype(np.float32)
        new = [r.randn(B, H, sq, D).astype(np.float32) for _ in range(2)]
        q = r.randn(B, H, sq, D).astype(np.float32)
        caches = []
        for _ in range(2):
            p, s = jqc.quantize_lastaxis(jnp.asarray(hist), width)
            c = jqc.QuantKV(np.asarray(p), np.asarray(s))
            if layout == "paged":
                # a shuffled table over a pool with the trash block
                nmax = cap // bs
                table = (1 + np.random.RandomState(6).permutation(
                    B * nmax)).reshape(B, nmax).astype(np.int32)

                def pool(a):
                    out = np.zeros((B * nmax + 1,) + a.shape[1:2]
                                   + (bs,) + a.shape[3:], a.dtype)
                    blocks = a.reshape(B, H, nmax, bs, -1).transpose(
                        0, 2, 1, 3, 4)
                    out[table.reshape(-1)] = blocks.reshape(
                        (B * nmax, H, bs, -1))
                    return out

                c = jpk.PagedKV(jqc.QuantKV(pool(c.q), pool(c.scale)),
                                table)
            caches.append(c)
        jk, jv = (_jax_wrap(c) for c in caches)
        tk, tv = (_torch_of(c) for c in caches)
        jpos = JaxTensor._wrap(jnp.asarray(pos))
        jk = jattn.cache_update(jk, JaxTensor._wrap(jnp.asarray(new[0])),
                                jpos)
        jv = jattn.cache_update(jv, JaxTensor._wrap(jnp.asarray(new[1])),
                                jpos)
        tk2 = attn.cache_update(tk, torch.tensor(new[0]), torch.tensor(pos))
        tv2 = attn.cache_update(tv, torch.tensor(new[1]), torch.tensor(pos))
        for t, j in ((tk2, jk), (tv2, jv)):
            tq = t.kv if layout == "paged" else t
            jq = j.kv if layout == "paged" else j
            np.testing.assert_array_equal(_u8(tq.q), _u8(jq.q._data))
            np.testing.assert_array_equal(tq.scale.numpy(),
                                          np.asarray(jq.scale._data))
        want = np.asarray(jattn.cached_attention(
            JaxTensor._wrap(jnp.asarray(q)), jk, jv, jpos)._data)
        got = attn.cached_attention(torch.tensor(q), tk2, tv2,
                                    torch.tensor(pos)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                                   rtol=0)


# ---------------------------------------------------------------------------
# gen_cache layouts (tests/test_quantized_comm.py::test_gen_cache_layouts)
# ---------------------------------------------------------------------------


class TestGenCache:
    def test_gen_cache_layouts(self, env, monkeypatch):
        model = pt.TransformerLM(64, d_model=32, num_heads=4, num_layers=2,
                                 max_position=32, device="cpu")
        c0 = model.gen_cache(2, 16, dtype="int8")[0]
        assert isinstance(c0.k, qc.QuantKV)
        assert c0.k.q.dtype == torch.int8
        assert tuple(c0.k.q.shape) == (2, 4, 16, 8)
        assert tuple(c0.k.scale.shape) == (2, 4, 16, 1)
        # the env knob is the no-code-change path
        monkeypatch.setenv("PADDLE_SERVE_KV_QUANT", "int8")
        assert isinstance(model.gen_cache(2, 16)[0].k, qc.QuantKV)
        monkeypatch.delenv("PADDLE_SERVE_KV_QUANT")
        assert not isinstance(model.gen_cache(2, 16)[0].k, qc.QuantKV)
        # the single-device MultiHeadAttention carries the same form
        mha = pt.nn.MultiHeadAttention(32, 4, device="cpu",
                                       generator=torch.Generator())
        c = mha.gen_cache(batch_size=2, max_length=16, dtype="int8")
        assert isinstance(c.k, qc.QuantKV)
        with pytest.raises(ValueError, match="static-capacity"):
            mha.gen_cache(batch_size=2, dtype="int8")
        # the env default must not reach a concatenating caller that never
        # asked for it
        monkeypatch.setenv("PADDLE_SERVE_KV_QUANT", "int8")
        legacy = mha.gen_cache(batch_size=2)
        assert not isinstance(legacy.k, qc.QuantKV)
        assert tuple(legacy.k.shape)[2] == 0

    def test_paged_and_fp8_layouts_and_bytes(self, models, monkeypatch):
        jm, tm = models
        f8 = tm.gen_cache(2, 16, dtype="fp8")[0].k
        assert f8.q.dtype == qc.fp8_dtype() and not qc.bits(f8.q).any()
        paged = tm.gen_cache(4, 64, dtype="int8", block_size=8,
                             pool_blocks=9)
        assert isinstance(paged[0].k, pk.PagedKV)
        assert isinstance(paged[0].k.kv, qc.QuantKV)
        assert tuple(paged[0].k.kv.q.shape) == (9, HEADS, 8, 16)
        assert tuple(paged[0].k.kv.scale.shape) == (9, HEADS, 8, 1)
        assert pk.pool_bytes(paged) == jpk.pool_bytes(
            jm.gen_cache(4, 64, dtype="int8", block_size=8, pool_blocks=9))
        # 16 int8 values and one float32 scale per token and head: 20 bytes
        # against 64 in float32, exactly
        q8 = pk.pool_bytes(tm.gen_cache(4, 64, dtype="int8"))
        f32 = pk.pool_bytes(tm.gen_cache(4, 64))
        assert q8 * 64 == f32 * 20
        monkeypatch.setenv("PADDLE_SERVE_KV_QUANT", "fp8")
        monkeypatch.setenv("PADDLE_SERVE_BLOCK_SIZE", "8")
        kv = tm.gen_cache(1, 16)[0].v.kv
        assert isinstance(kv, qc.QuantKV) and kv.q.dtype == qc.fp8_dtype()


# ---------------------------------------------------------------------------
# generate with a quantized KV cache
# ---------------------------------------------------------------------------


class TestQuantizedGenerate:
    @pytest.mark.parametrize("block", [0, 8])
    @pytest.mark.parametrize("width", WIDTHS)
    def test_tokens_and_logits_match_paddle_tpu(self, models, monkeypatch,
                                                width, block):
        jm, tm = models
        monkeypatch.setenv("PADDLE_SERVE_KV_QUANT", width)
        if block:
            monkeypatch.setenv("PADDLE_SERVE_BLOCK_SIZE", str(block))
        jt, jl = jax_generate(jm, PROMPTS, 8, max_length=48,
                              return_logits=True)
        tt, tl = pt.generate(tm, PROMPTS, 8, max_length=48,
                             return_logits=True)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        cache = tm.gen_cache(1, 16)[0].k
        assert isinstance(cache.kv if block else cache, qc.QuantKV)
        if block:
            monkeypatch.delenv("PADDLE_SERVE_BLOCK_SIZE")
            ct, cl = pt.generate(tm, PROMPTS, 8, max_length=48,
                                 return_logits=True)
            np.testing.assert_array_equal(tt, ct)
            np.testing.assert_allclose(tl, cl, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the engine over an int8 pool
# ---------------------------------------------------------------------------

ENGINE_REQS = [(PREAMBLE, 6, "a", {"adapter": 1}),
               ([9, 30, 2, 41, 7], 6, "d", {"adapter": 1}),
               (PREAMBLE, 8, "b", {"adapter": 2}),
               (PREAMBLE + [27, 4], 5, "c", {})]
ENGINE_CASES = {
    # chunked prefill, the prefix cache (b and c, admitted after a's
    # prefill, share its blocks; b's full match copies a block on write)
    # and two adapters, over a paged pool
    "paged": dict(slots=2, block_size=8, prefill_chunk=8,
                  prefix_cache=True),
    # the contiguous pool's slot copy, chunked
    "contiguous": dict(slots=2, block_size=0, prefill_chunk=8),
}


@pytest.fixture(scope="module")
def engine_models(env):
    """A model pair with a two-adapter fleet, and paddle_tpu's int8-pool
    engine tokens for each case."""
    jm, tm = _pair(d=64, cap=48, seed=11)
    for ad in (JaxAdapterSet(jm, n_adapters=3, rank=2, scale=1.0),
               AdapterSet(tm, n_adapters=3, rank=2, scale=1.0)):
        ad.load(1, seed=21)
        ad.load(2, seed=22)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_SERVE_KV_QUANT", "int8")
        for case, kw in ENGINE_CASES.items():
            eng, want[case] = _serve(JaxEngine, JaxRequest, jm, ENGINE_REQS,
                                     max_length=48, **kw)
            if case == "paged":
                assert eng._prefix_hits == 2 and eng._cow_copies == 1
    return tm, want


class TestQuantizedEngine:
    @pytest.mark.parametrize("case", sorted(ENGINE_CASES))
    def test_requests_match_paddle_tpu(self, engine_models, monkeypatch,
                                       case):
        tm, want = engine_models
        monkeypatch.setenv("PADDLE_SERVE_KV_QUANT", "int8")
        eng, got = _serve(pt.InferenceEngine, Request, tm, ENGINE_REQS,
                          max_length=48, **ENGINE_CASES[case])
        assert got == want[case]
        leaf = eng._state.caches[0].k
        assert isinstance(leaf.kv if case == "paged" else leaf, qc.QuantKV)
        if case == "paged":
            assert eng._prefix_hits == 2 and eng._cow_copies == 1
        # the int8 pool against generate's int8 cache, one request alone
        p, n, rid, extra = ENGINE_REQS[3]
        alone = pt.generate(tm, [p], n, max_length=48)
        assert got[rid] == list(alone[0])


# ---------------------------------------------------------------------------
# the int8/fp8 weight checkpoint, in both directions
# ---------------------------------------------------------------------------


def _narrow(model):
    """name -> (payload bytes, scales) of every narrow linear weight,
    in paddle's [in, out] layout."""
    out = {}
    if isinstance(model, pt.TransformerLM):
        for name, _, w in qcp.iter_quantizable(model):
            out[name] = (_u8(w.detach()), qcp.scale_of(w).numpy())
    else:
        for name, _, w in jqcp.iter_quantizable(model):
            out[name] = (_u8(w._data), np.asarray(w._q_scale._data))
    return out


class TestQuantizedCheckpoint:
    @pytest.mark.parametrize("writer", ["paddle_tpu", "port"])
    @pytest.mark.parametrize("width", WIDTHS)
    def test_interchange(self, env, tmp_path, width, writer):
        """A checkpoint written by one package loads narrow into the
        other: the payloads are the writer's bytes, and the reader decodes
        the tokens the writer's own narrow model decodes."""
        jm, tm = _pair(d=64, cap=48, seed=13)
        path = str(tmp_path / "m")
        save = jax_save_quantized if writer == "paddle_tpu" else \
            save_quantized
        info = save(jm if writer == "paddle_tpu" else tm, path, width)
        with np.load(path + ".pdqparams") as z:
            stored = {n: z[n] for n in z.files}
        assert all(stored[f"{n}::q"].dtype == (
            np.int8 if width == "int8" else np.uint8)
            for n in info["quantized"])
        with open(path + ".pdqmeta") as f:
            assert json.load(f)["format"] == "pdq1"
        jq, tq = _pair(d=64, cap=48, seed=99)  # other weights, replaced
        jmeta = jax_load_quantized(jq, path)
        tmeta = tq.load_quantized(path)
        assert tmeta["load_ms"] >= 0 and tmeta["quantized"] == \
            jmeta["quantized"] == info["quantized"]
        jn, tn = _narrow(jq), _narrow(tq)
        assert len(tn) == 4 * LAYERS + 1 == len(jn)
        for name, (p, s) in jn.items():
            np.testing.assert_array_equal(tn[name][0], p)
            np.testing.assert_array_equal(tn[name][1], s)
            np.testing.assert_array_equal(tn[name][0],
                                          stored[f"{name}::q"])
        assert tq.blocks[0].fc1.weight.dtype == (
            torch.int8 if width == "int8" else qc.fp8_dtype())
        assert "blocks.0.fc1.weight_q_scale" not in tq.state_dict()
        jt, jl = jax_generate(jq, PROMPTS, 6, max_length=32,
                              return_logits=True)
        tt, tl = pt.generate(tq, PROMPTS, 6, max_length=32,
                             return_logits=True)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        # the port's own records and re-save of a narrow model
        again = save_quantized(tq, str(tmp_path / "again"), width)
        for k in ("bytes_payload", "bytes_scales", "bytes_wide"):
            assert again[k] == info[k]

    def test_quantize_layer_equals_paddle_tpu(self, env):
        jm, tm = _pair(d=64, cap=48, seed=13)
        jinfo = jqcp.quantize_layer(jm, "int8")
        tinfo = qcp.quantize_layer(tm, "int8")
        assert tinfo == jinfo
        assert qcp.quantize_layer(tm, "int8")["quantized"] == []
        jn, tn = _narrow(jm), _narrow(tm)
        for name, (p, s) in jn.items():
            np.testing.assert_array_equal(tn[name][0], p)
            np.testing.assert_array_equal(tn[name][1], s)
        assert qcp.q_matmul_info(1000, ("int8", 128)) == \
            jqcp.q_matmul_info(1000, ("int8", 128))

    def test_mismatch_and_deadline_raise(self, env, tmp_path):
        _, tm = _pair(d=64, cap=48, seed=13)
        path = str(tmp_path / "m")
        save_quantized(tm, path, "int8")
        other = pt.TransformerLM(VOCAB, d_model=64, num_heads=HEADS,
                                 num_layers=LAYERS + 1, max_position=48,
                                 device="cpu")
        with pytest.raises(ValueError, match="does not match"):
            other.load_quantized(path)  # a layer the file does not hold
        fewer = pt.TransformerLM(VOCAB, d_model=64, num_heads=HEADS,
                                 num_layers=1, max_position=48, device="cpu")
        with pytest.raises(ValueError, match="architecture mismatch"):
            fewer.load_quantized(path)
        with pytest.raises(ValueError, match="int8"):
            save_quantized(tm, path, None)
        fresh = _pair(d=64, cap=48, seed=14)[1]
        with pytest.raises(TimeoutError, match="deadline"):
            load_quantized(fresh, path, deadline_ms=-1.0)
        assert load_quantized(_pair(d=64, cap=48, seed=14)[1], path,
                              deadline_ms=6e5)["load_ms"] <= 6e5
