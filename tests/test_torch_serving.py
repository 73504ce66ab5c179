"""The port's serving slice against paddle_tpu's, on carried weights.

A tiny ``TransformerLM`` (d_model 128 so the fused-LN route fires, 4
heads, 2 layers, vocab 48, capacity 32) is built in paddle_tpu with
random weights made by numpy; the same weights go into
paddle_tpu_torch's model through ``set_state_dict``. Both
packages run with ``PADDLE_FLASH_DEFAULT=interpret`` and
``PADDLE_FUSED_LN=interpret``: paddle_tpu through the Pallas interpreter,
the port through its kernels' plain versions (the CPU route of the same
decision).

Tolerances: float32 logits atol 1e-4 (both packages compute in float32;
sums run in different orders through two layers); tokens (greedy) equal.
"""
import ast
import pathlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.distributed import comm
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import TransformerLM as JaxLM
from paddle_tpu.serving import generate as jax_generate

import paddle_tpu_torch as pt

VOCAB, D, HEADS, LAYERS, CAP = 48, 128, 4, 2, 32
LOGIT_ATOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def env():
    """Both packages take the kernel routes (interpret on the CPU); the
    JAX model's constructor installs a trivial hybrid mesh, restored
    after the module."""
    prev = comm._state.hybrid_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_FLASH_DEFAULT", "interpret")
        mp.setenv("PADDLE_FUSED_LN", "interpret")
        mp.delenv("PADDLE_SERVE_BLOCK_SIZE", raising=False)
        mp.delenv("PADDLE_SERVE_BUCKETS", raising=False)
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


@pytest.fixture(scope="module")
def models(env):
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


PROMPTS = [[5, 17, 3, 40, 22, 9, 31, 2], [11, 4, 46, 8, 27]]


def test_full_forward_logits_match(models):
    jm, tm = models
    ids = np.random.RandomState(0).randint(0, VOCAB, size=(2, 16))
    want = np.asarray(jm(paddle_tpu.to_tensor(ids))._data)
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    assert got.shape == (2, 16, VOCAB)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_full_forward_takes_the_kernel_routes(models, monkeypatch):
    """T = 16 routes attention to the flash wrapper and every LayerNorm
    (32 rows of 128) to the LN wrappers; on the CPU they run the plain
    versions, so count the calls there."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.ops.kernels import layer_norm as tln

    calls = {"flash": 0, "ln": 0, "add_ln": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "flash_attention_fwd_plain",
                        counting("flash", tfa.flash_attention_fwd_plain))
    monkeypatch.setattr(tln, "layer_norm_fwd_plain",
                        counting("ln", tln.layer_norm_fwd_plain))
    monkeypatch.setattr(tln, "add_layer_norm_fwd_plain",
                        counting("add_ln", tln.add_layer_norm_fwd_plain))
    _, tm = models
    with torch.no_grad():
        tm(torch.zeros(2, 16, dtype=torch.int64))
    # add-LN's plain version calls the LN plain version once more
    assert calls == {"flash": LAYERS, "ln": 2 * LAYERS + 1,
                     "add_ln": LAYERS}


def test_generate_greedy_matches(models):
    jm, tm = models
    jt, jl = jax_generate(jm, PROMPTS, 6, return_logits=True)
    tt, tl = pt.generate(tm, PROMPTS, 6, return_logits=True)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)


def test_generate_matches_full_forward(models):
    """The cached decode's step logits equal the cache-off full forward
    (the flash route) at each generated position."""
    _, tm = models
    toks, logits = pt.generate(tm, PROMPTS[:1], 6, return_logits=True)
    seq = np.concatenate([PROMPTS[0], toks[0, :5]])[None]
    with torch.no_grad():
        full = tm(torch.as_tensor(seq)).numpy()
    np.testing.assert_allclose(full[:, len(PROMPTS[0]) - 1:], logits,
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(full[0, len(PROMPTS[0]) - 1:].argmax(-1),
                                  toks[0])


def test_generate_eos_sentinel_matches(models):
    jm, tm = models
    plain = pt.generate(tm, PROMPTS, 6)
    eos = int(plain[0, 2])
    jt = jax_generate(jm, PROMPTS, 6, eos_id=eos)
    tt = pt.generate(tm, PROMPTS, 6, eos_id=eos)
    np.testing.assert_array_equal(tt, jt)
    first = int(np.argmax(tt[0] == eos))
    assert first <= 2 and (tt[0, first + 1:] == -1).all()


def test_engine_tokens_match(models):
    jm, tm = models
    r = np.random.RandomState(4)
    specs = [(int(r.randint(3, 17)), int(r.randint(2, 9)))
             for _ in range(5)]
    prompts = [r.randint(0, VOCAB, size=L) for L, _ in specs]
    results = []
    for Engine, Req, model in ((JaxEngine, JaxRequest, jm),
                               (pt.InferenceEngine, pt.serving.Request,
                                tm)):
        eng = Engine(model, slots=2, max_length=CAP, sync_every=3)
        for i, (p, (_, n)) in enumerate(zip(prompts, specs)):
            eng.submit(Req(p, max_new_tokens=n, rid=i))
        res = eng.run()
        results.append({k: list(v.tokens) for k, v in res.items()})
    assert results[1] == results[0]
    assert all(len(results[1][i]) == n for i, (_, n) in enumerate(specs))


def test_sampling_properties():
    """JAX's sampling RNG cannot be reproduced: check sampled paths by
    property."""
    from paddle_tpu_torch.serving import sampling

    g = torch.Generator().manual_seed(0)
    lg = torch.randn(4, 23, generator=g) * 2
    assert torch.equal(sampling.sample(lg, g, 1.0, 1, 1.0),
                       sampling.greedy(lg))  # top-k 1 is greedy
    top3 = torch.topk(lg, 3, dim=-1).indices
    for _ in range(8):
        got = sampling.sample(lg, g, 1.5, 3, 1.0)
        assert all(int(got[b]) in top3[b].tolist() for b in range(4))
    temp = torch.tensor([0.0, 0.0, 1.0, 1.0])
    got = sampling.sample(lg, g, temp, 0, 1.0)
    assert torch.equal(got[:2], sampling.greedy(lg)[:2])
    kept = sampling.top_p_mask(lg, torch.tensor([0.0, 0.5, 0.9, 1.0]))
    assert (torch.isfinite(kept).sum(-1)[0] == 1).item()  # top token only
    assert torch.equal(kept[3], lg[3])


def test_no_jax_imports_in_the_port():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py",
              REPO / "tools" / "profile_torch_serving.py",
              REPO / "tools" / "profile_torch_train.py"]
    assert len(files) > 10
    assert {"paged_kv.py", "prefix_cache.py", "adapters.py",
            "quantized_comm.py", "quantized_compute.py", "save_load.py"} <= {
        p.name for p in files}
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "paddle_tpu", "paddle"), \
                    f"{path.relative_to(REPO)} imports {n}"
    # the files the mailbox worker runs import the standard library only
    # at module level (no torch, no package-relative import) ...
    port = REPO / "paddle_tpu_torch"
    for rel in ("serving/router.py", "observability/bus.py",
                "observability/monitor.py", "utils/fault_injection.py"):
        tree = ast.parse((port / rel).read_text())
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"{rel}: relative import at top"
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in sys.stdlib_module_names \
                    or n == "__future__", f"{rel} imports {n}"
    # ... and every file the router's _load_rel loads lies in the port
    calls = [node for node in ast.walk(ast.parse(
        (port / "serving" / "router.py").read_text()))
        if isinstance(node, ast.Call)
        and getattr(node.func, "id", None) == "_load_rel"]
    assert len(calls) == 3
    for call in calls:
        parts = [a.value for a in call.args[1:]]
        target = (port / Path(*parts)).resolve()
        assert target.is_file() and port.resolve() in target.parents, parts


def test_default_device_is_cuda():
    """No device given means the card; without one the entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.TransformerLM(VOCAB, d_model=D, num_heads=HEADS,
                         num_layers=LAYERS, max_position=CAP)
