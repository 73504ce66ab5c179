"""Drive the PyTorch/H100 port on one card and check it end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit and builds the CUDA kernels of
   ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. holds each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at the serving shapes, and times the kernel, the
   plain version and one PyTorch library call computing the same function;
3. serves the GPT-medium-shaped ``TransformerLM`` (vocab 32000, d_model
   1024, 16 heads, 24 layers, ffn 4096, float32, random weights from a
   seeded generator) through ``generate`` and ``InferenceEngine``, checks
   the cached decode against a full forward that goes through the flash
   kernel, and checks that every kernel was launched on that path;
4. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
   "device": ...}`` line.

Exits non-zero, printing no result, without a CUDA device, outside a
checkout of the repository, or when any check fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# peak rates of one H100 SXM (data sheet, dense): HBM bytes/s, FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# the serving configuration: bench.py's GPT-medium decode proxy
VOCAB, D_MODEL, HEADS, LAYERS, FFN = 32000, 1024, 16, 24, 4096
BATCH, PROMPT, NEW = 8, 128, 64
CAP = PROMPT + NEW

# tolerances of kernel vs plain version on the card (same inputs):
# f32 differs by summation order only; bf16 by one or two roundings of
# the stored output (one bf16 ulp is 2^-8 relative)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1.6e-2)}
# cached decode (dense cached_attention) vs the full forward (flash
# kernel), float32 with TF32 off: the two paths sum in different orders
# through 24 layers
LOGIT_ATOL = 2e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def close(a, b, dtype):
    """max |a - b| and whether it is within (atol + rtol * |b|)."""
    atol, rtol = TOL[dtype]
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return err.max().item(), bool((err <= atol + rtol * b.abs()).all())


def time_ms(fn, calls=20, reps=5):
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events (no host launch
    cost in the number; inputs L2-warm)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * calls)


def bound_ms(nbytes, flops, dtype):
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def flash_phase(fa, gen, rows):
    """Flash forward vs its plain version; returns the JSON entry."""
    import torch.nn.functional as tF

    cases = [  # (B, H, Sq, Sk, q_offset, kv_offset, what)
        (BATCH, HEADS, 128, 128, 0, 0, "causal"),
        (BATCH, HEADS, 64, 128, 64, 0, "end-aligned q_offset=Sk-Sq"),
        (BATCH, HEADS, 128, 128, 0, 64, "64 fully masked rows"),
        (BATCH, HEADS, PROMPT + 8, PROMPT + 8, 0, 0, "main path S=136"),
    ]
    D = D_MODEL // HEADS
    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, S, Sk, qo, ko, what in cases:
            q, k, v = (torch.randn(B, H, n, D, device="cuda", generator=gen
                                   ).to(dtype) for n in (S, Sk, Sk))
            kw = dict(causal=True, q_offset=qo, kv_offset=ko)
            o, l = fa.flash_attention_fwd(q, k, v, block_q=S, block_k=Sk,
                                          **kw)
            po, pl = fa.flash_attention_fwd_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            eo, ok_o = close(o, po, dtype)
            el, ok_l = close(l, pl, torch.float32)
            masked = int((pl <= -1e29).sum())
            if ko and masked != B * H * ko:
                fail(f"flash {what}: {masked} fully masked rows expected "
                     f"{B * H * ko}")
            if ko and not bool((o[:, :, :ko].float() == 0).all()):
                fail(f"flash {what}: fully masked rows must give out = 0")
            print(f"flash_attention_fwd {str(dtype)[6:]} [{B},{H},{S},{Sk},"
                  f"{D}] {what}: max|out err| {eo:.3e} max|lse err| "
                  f"{el:.3e}")
            if not (ok_o and ok_l):
                fail(f"flash_attention_fwd {dtype} {what} disagrees with "
                     "its plain version")
            if what.startswith("main path") and dtype == torch.float32:
                ms = time_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, block_q=8, block_k=8, **kw))
                plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
                    q, k, v, **kw))
                lib_ms = time_ms(lambda: tF.scaled_dot_product_attention(
                    q, k, v, is_causal=True))
                pairs = S * (S + 1) // 2  # visible (q, k) pairs per head
                nbytes = (3 * B * H * S * D + B * H * S * D) \
                    * q.element_size() + B * H * S * 4
                flops = 4 * D * pairs * B * H
                bms, by = bound_ms(nbytes, flops, dtype)
                entry = dict(
                    name="flash_attention_fwd", route="cuda",
                    source=fa.SOURCE,
                    replaces="paddle_tpu/ops/pallas/flash_attention.py:49 "
                             "(_fwd_kernel_resident) and :110 (_fwd_kernel)",
                    shape=f"[{B},{H},{S},{D}] causal", dtype="float32",
                    max_abs_err=max(eo, el), ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)
                rows.append(f"flash_attention_fwd f32 [{B},{H},{S},{D}]: "
                            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                            f"sdpa {lib_ms:.4f} ms, bound {bms:.6f} ms "
                            f"({by})")
    return entry


def ln_phase(ln, gen, rows):
    """LN and add-LN vs their plain versions; returns two JSON entries."""
    import torch.nn.functional as tF

    entries = {}
    D = D_MODEL
    for dtype in (torch.float32, torch.bfloat16):
        for R in (BATCH * PROMPT, BATCH):
            x, y = (torch.randn(R, D, device="cuda", generator=gen
                                ).to(dtype) for _ in range(2))
            w, b = (torch.randn(D, device="cuda", generator=gen
                                ).to(dtype) for _ in range(2))
            got = ln.layer_norm_fwd(x, w, b)
            ref = ln.layer_norm_fwd_plain(x, w, b)
            got2 = ln.add_layer_norm_fwd(x, y, w, b)
            ref2 = ln.add_layer_norm_fwd_plain(x, y, w, b)
            torch.cuda.synchronize()
            e1 = [close(a, r, dtype if i == 0 else torch.float32)
                  for i, (a, r) in enumerate(zip(got, ref))]
            e2 = [close(a, r, dtype if i < 2 else torch.float32)
                  for i, (a, r) in enumerate(zip(got2, ref2))]
            print(f"layer_norm_fwd {str(dtype)[6:]} [{R},{D}]: max err "
                  f"y/mu/rstd {[f'{e:.3e}' for e, _ in e1]}")
            print(f"add_layer_norm_fwd {str(dtype)[6:]} [{R},{D}]: max err "
                  f"s/y/mu/rstd {[f'{e:.3e}' for e, _ in e2]}")
            if not all(ok for _, ok in e1 + e2):
                fail(f"layer norm kernels {dtype} R={R} disagree with "
                     "their plain versions")
            if dtype != torch.float32:
                continue
            it = x.element_size()
            for name, fn, plain, lib, nbytes, err in (
                    ("layer_norm_fwd",
                     lambda: ln.layer_norm_fwd(x, w, b),
                     lambda: ln.layer_norm_fwd_plain(x, w, b),
                     lambda: tF.layer_norm(x, (D,), w, b, 1e-5),
                     2 * R * D * it + 2 * D * it + 2 * R * 4,
                     max(e for e, _ in e1)),
                    ("add_layer_norm_fwd",
                     lambda: ln.add_layer_norm_fwd(x, y, w, b),
                     lambda: ln.add_layer_norm_fwd_plain(x, y, w, b),
                     None,
                     4 * R * D * it + 2 * D * it + 2 * R * 4,
                     max(e for e, _ in e2))):
                ms = time_ms(fn)
                plain_ms = time_ms(plain)
                lib_ms = time_ms(lib) if lib is not None else None
                bms, by = bound_ms(nbytes, 8 * R * D, dtype)
                rows.append(
                    f"{name} f32 [{R},{D}]: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, library "
                    f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                    f"bound {bms:.6f} ms ({by})")
                if R == BATCH * PROMPT:
                    entries[name] = dict(
                        name=name, route="cuda", source=ln.SOURCE,
                        replaces=("paddle_tpu/ops/pallas/layer_norm.py:54 "
                                  "(_ln_fwd_kernel)"
                                  if name == "layer_norm_fwd" else
                                  "paddle_tpu/ops/pallas/layer_norm.py:68 "
                                  "(_add_ln_fwd_kernel)"),
                        shape=f"[{R},{D}]", dtype="float32",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms)
    return entries["layer_norm_fwd"], entries["add_layer_norm_fwd"]


def serving_phase(pt, kernels):
    """Serve the GPT-medium model through generate and InferenceEngine;
    returns the per-kernel launch counts of this phase."""
    from paddle_tpu_torch.jit import PrefillStep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    class TimedPrefill(PrefillStep):
        def __call__(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().__call__(*a, **kw)
            torch.cuda.synchronize()
            self.ms = (time.perf_counter() - t0) * 1e3
            return out

    t0 = time.perf_counter()
    model = pt.TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, max_position=CAP,
                             dim_feedforward=FFN, seed=0)
    torch.cuda.synchronize()
    print(f"model: {sum(p.numel() for p in model.parameters())} float32 "
          f"parameters on {model.device}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, VOCAB, size=(BATCH, PROMPT))
    # warm-up (cuBLAS handles, the allocator), so the timed prefill below
    # is the steady state; its launches are not counted
    pt.generate(model, prompts, 2)

    kernels.reset_launches()  # the main path starts here
    pre = TimedPrefill(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, step_logits = pt.generate(model, prompts, NEW, prefill=pre,
                                    return_logits=True)
    gen_s = time.perf_counter() - t0
    print(f"generate B={BATCH} prompt={PROMPT} new={NEW}: "
          f"{BATCH * NEW / gen_s:.1f} tokens/s ({gen_s * 1e3:.1f} ms, "
          f"prefill {pre.ms:.2f} ms)")
    if toks.shape != (BATCH, NEW) or (toks < 0).any() \
            or (toks >= VOCAB).any():
        fail(f"generate returned bad tokens, shape {toks.shape}")

    # the oracle: one cache-off full forward over prompt + 8 generated
    # tokens (136 positions, so attention takes the flash kernel)
    seq = np.concatenate([prompts, toks[:, :8]], axis=1)
    with torch.no_grad():
        full = model(torch.as_tensor(seq, device=model.device))
    ref = full[:, PROMPT - 1:PROMPT + 8].float().cpu().numpy()
    got = step_logits[:, :9]
    err = float(np.abs(ref - got).max())
    agree = ref.argmax(-1) == toks[:, :9]
    print(f"cached decode vs full forward (flash), 9 positions x {BATCH} "
          f"rows: max|logit err| {err:.3e} (tolerance {LOGIT_ATOL}), "
          f"argmax agrees {int(agree.sum())}/{agree.size}")
    if not np.isfinite(got).all() or err > LOGIT_ATOL or not agree.all():
        fail("cached decode disagrees with the full forward")

    reqs = []
    for i in range(12):
        L = int(rng.randint(9, PROMPT + 1))
        reqs.append(pt.serving.Request(
            rng.randint(0, VOCAB, size=L), max_new_tokens=int(
                rng.randint(16, 49)), rid=i))
    # request 12 repeats generate's row 0: its tokens must follow row 0's
    n12 = min(48, NEW)
    reqs.append(pt.serving.Request(prompts[0], max_new_tokens=n12, rid=12))
    eng = pt.InferenceEngine(model, slots=BATCH, max_length=CAP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    res = eng.run()
    eng_s = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in res.values())
    print(f"InferenceEngine slots={BATCH} cap={CAP}: {len(res)} requests "
          f"(prompts {min(r.prompt_ids.size for r in reqs)}.."
          f"{max(r.prompt_ids.size for r in reqs)}), {n_tok} tokens, "
          f"{n_tok / eng_s:.1f} tokens/s, prefill mean "
          f"{np.mean([r.prefill_ms for r in res.values()]):.2f} ms, ttft "
          f"mean {np.mean([r.ttft_ms for r in res.values()]):.2f} ms")
    for r in reqs:
        out = res.get(r.rid)
        if out is None or len(out.tokens) != r.max_new_tokens \
                or min(out.tokens) < 0 or max(out.tokens) >= VOCAB:
            fail(f"engine request {r.rid} came back wrong")
    same = res[12].tokens == list(toks[0, :n12])
    if not same:
        i = next(j for j, (a, b) in enumerate(zip(res[12].tokens, toks[0]))
                 if a != b)
        top2 = np.sort(step_logits[0, i])[-2:]
        print(f"engine request 12 leaves generate's row 0 at token {i}; "
              f"top-2 logit gap there {top2[1] - top2[0]:.3e}")
        if top2[1] - top2[0] > LOGIT_ATOL:
            fail("engine decode disagrees with generate")
    print(f"engine request 12 equals generate's row 0: {same}")
    counts = kernels.launches()  # the main path ends here
    print(f"launches on the serving path: {counts}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import paddle_tpu_torch as pt  # a checkout of the repository
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build(kernels.SOURCES)
    print(f"built {', '.join(kernels.SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for src in kernels.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line:
                print(f"  {src}: {line.split(':', 1)[1].strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    flash = flash_phase(fa, gen, rows)
    ln_entry, add_entry = ln_phase(ln, gen, rows)
    for r in rows:
        print(r)
    counts = serving_phase(pt, kernels)
    entries = [flash, ln_entry, add_entry]
    for e in entries:
        e["launches"] = counts[e["name"]]
    print(f"{card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
