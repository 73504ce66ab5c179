"""Drive the PyTorch/H100 port on one card and check it end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the CUDA kernels of
   ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel), prints
   each kernel's registers and spills, and counts the tensor-core (HMMA)
   instructions of the flash forward, dQ and dK/dV kernels
   (``cuobjdump``);
2. holds each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16 (the attention kernels in float16 too, and the
   add-LN on the float32 + bfloat16 and float32 + float16 pairs), at the
   training shapes (B = 4, S = 1024; LN rows 4096), BERT-base's LN rows
   ([4096, 768]) and the serving shapes (the LayerNorms also at the decode
   step's 8 rows, a speculative round's 40 and a prefill chunk's 32), at
   the masked and offset cases,
   and the attention kernels at head dims 192 and 256 (causal and not,
   ragged lengths); times the kernel, the plain version and one PyTorch
   library call computing the same function, all from CUDA-graph replays
   (the attention kernels in each type beside SDPA in that type, also at
   the head-dim-256 block's shape);
3. serves the GPT-medium-shaped ``TransformerLM`` (vocab 32000, d_model
   1024, 16 heads, 24 layers, ffn 4096, float32, random weights from a
   seeded generator) through ``generate`` and ``InferenceEngine``, checks
   the cached decode against a full forward that goes through the flash
   kernel, and checks that every forward kernel was launched on that path
   and no backward kernel;
4. serves the same model through the serving tier, at bench.py's sizes:
   ``generate`` through a paged KV cache (block 16) against the contiguous
   cache's tokens; the chunked paged engine (4 slots, chunk 32, a pool
   sized by the requests' demand, then one that covers three of them, so
   admission defers) against the unchunked contiguous engine; a prefix
   cache whose warm request must hit and equal the cold one; a fleet of
   LoRA-style adapters mixed in one engine against each request served
   alone; with tokens/s, TTFTs, the pool's bytes against the contiguous
   worst case, and the LayerNorm forwards' launches (float32 only, no
   backward kernel);
5. quantized serving at the same size (bench.py's ``_bench_decode_q8w``):
   an int8 weight checkpoint saved and loaded narrow (load ms, payload MB,
   reduction), ``generate`` at B = 1 and 8 beside the float model, tokens
   and logits against a float model holding the widened weights; then the
   int8 KV cache: contiguous = paged ``generate``, the chunked paged engine
   = ``generate`` of its prompt, the pool's bytes against the float
   pool's, the agreement with the float cache (reported); and the fp8
   cache's bytes on the card against the CPU quantizer's;
6. greedy speculative decoding (k = 4) with a 2-layer draft at the
   target's width and with the target as its own draft, contiguous and
   paged, each equal to plain greedy ``generate`` (tokens/s, rounds,
   tokens per round), and one round under sync debug mode "error";
7. the router's plane at GPT-medium width (cap 160, block 16, float32):
   bench.py's disaggregated decode tier (``_bench_serve_multitenant``'s
   second half: a ``PrefillHost`` of 2 slots hands 8 mixed-adapter
   requests of prompt 128 to a decode ``LocalHost`` of 8 as CRC-sealed
   KV bundles) against a colocated engine (tokens/s, tokens equal, every
   handoff spliced, bundle bytes and the gather, seal, verify and insert
   ms); ``drain_host`` moving live requests between two 4-slot engines,
   in float32 and int8 KV (no fallback, no prefill for a moved request,
   spliced bytes = the source's, tokens = greedy ``generate``);
   ``retire_slots(2)`` relocating live top slots; and the disaggregated
   run again with the telemetry bus on (one ``decode_metrics`` row per
   readback window, one ``decode_request`` per request, the host reads of
   the run with the bus off);
8. trains the same model (bench.py's GPT-medium training proxy: B = 4,
   S = 1024, AdamW lr 1e-4, weight decay 0.01, float32) through
   ``jit.TrainStep``: first one gradient oracle (every parameter's
   gradient through the kernels against the dense route's, torch
   autograd), then six steps on one fixed batch (the loss must fall), and
   checks that each of the six kernels was launched as often as a step
   needs;
9. trains bench.py's GPT-medium program as published (``_bench_gpt``: no
   final LayerNorm, ``strategy.amp`` through ``fleet``, bf16 AMP O1,
   ``fused_linear_cross_entropy`` with chunk 8192, AdamW lr 1e-4, weight
   decay 0.01, B = 4, S = 1024): a bf16 gradient oracle against the dense
   route under the same AMP, then six steps on bench's fixed batch (the
   loss must fall), and checks each kernel's launches by input types (the
   flash kernels in bf16, the add-LN on the float32 residual and the bf16
   branch);
10. the same program under float16 O1 (``amp_configs = {"use_bf16":
   False}``, dynamic loss scaling): its gradient oracle (at the scaler's
   initial scale), six steps with the scaler's skipped steps, and the
   flash kernels' launches in float16 and the add-LN's on (float32,
   float16);
11. one ParallelGPTBlock at d_model 2048 with 8 heads (head dim 256), B =
   2, S = 1024, forward and backward through the kernels against the
   dense route, in float32 and under bf16 AMP;
12. bench.py's other training programs at its sizes: LeNet (batch 256,
   Adam 1e-3), ResNet-50 (batch 256 at 224 x 224, 1000 classes, Momentum
   0.1/0.9) in float32 with TF32 off and under bf16 AMP through
   ``fleet``, and BERT-base (12 layers, 768 wide, batch 32 x 128, AdamW
   1e-4/0.01, bf16 AMP): six steps each on one batch, with the rate,
   ms/step, peak memory, losses (which must fall) and launches (BERT's
   LayerNorms on B5/B7; the others none);
13. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
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

# peak rates of one H100 SXM (data sheet, dense): HBM bytes/s, FLOP/s.
# PEAK_FLOPS: elementwise work (the LayerNorms), float32 outside the tensor
# cores. PEAK_MMA_FLOPS: the attention kernels' products, whose least time is
# on the tensor cores: bf16 at 989e12, and float32 at the 3xTF32 rate, 495e12
# / 3 -- three TF32 products per float32-accurate product, the card's fastest
# route that keeps float32 (one TF32 pass keeps ~3 digits, which the float32
# contract refuses).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
PEAK_MMA_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12,
                  torch.float16: 989e12}

# the serving configuration: bench.py's GPT-medium decode proxy
VOCAB, D_MODEL, HEADS, LAYERS, FFN = 32000, 1024, 16, 24, 4096
BATCH, PROMPT, NEW = 8, 128, 64
CAP = PROMPT + NEW

# tolerances of kernel vs plain version on the card (same inputs), as
# (floor, rtol): |kernel - plain| <= floor * max|plain| + rtol * |plain|,
# so the test scales with each output (|dq| at S = 1024 is ~0.03). f32
# results differ by summation order and, in the tensor-core attention
# kernels, by the 3xTF32 split (~2^-22 of each product). bf16 outputs are
# rounded once from such f32 results, so they differ by at most one bf16
# ulp (<= 2^-7 relative); the floor covers the f32 differences of values
# near zero. float16 outputs likewise differ by one f16 rounding (2^-10
# relative, floor 2^-14).
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -12, 2 ** -7),
       torch.float16: (2 ** -14, 2 ** -10)}
#: the flash kernels' types; the short names of the JSON line
FLASH_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
SHORT = {torch.float32: "float32", torch.bfloat16: "bf16",
         torch.float16: "float16"}
# cached decode (dense cached_attention) vs the full forward (flash
# kernel), float32 with TF32 off: the two paths sum in different orders
# through 24 layers
LOGIT_ATOL = 2e-3

# the serving tier: bench.py's _bench_decode_paged (block 16, chunk 32,
# engine requests of 16 new tokens) and _bench_serve_multitenant (prompt
# 128 + 32 new: cap 160)
TIER_BLOCK, TIER_CHUNK, TIER_ENGINE_NEW = 16, 32, 16
MT_NEW, MT_CAP = 32, 160

# quantized serving (bench.py's _bench_decode_q8w: an int8 checkpoint served
# at B = 1 and 8) and speculative decoding (k = 4, a 2-layer draft at the
# target's width, or the target itself)
Q_BATCHES = (1, BATCH)
SPEC_K, DRAFT_LAYERS = 4, 2
# int8 weights against a float model holding the widened weights: the same
# GEMMs on the same values (float32, TF32 off), so only the widening's
# placement differs; max |logit err| <= Q_LOGIT_RTOL * max |logit|
Q_LOGIT_RTOL = 1e-5

# the training configuration: bench.py's GPT-medium training proxy
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 6
# gradient oracle, float32 with TF32 off: per parameter, max |kernel route
# - dense route| <= GRAD_RTOL * max |dense route| (sums in different
# orders through 24 layers; one bf16 rounding would be 2^-8 ~ 4e-3)
GRAD_RTOL = 1e-3
#: launches of each kernel per training step at TRAIN_* (24 layers)
TRAIN_LAUNCHES = {
    "flash_attention_fwd": LAYERS, "flash_attention_bwd_dq": LAYERS,
    "flash_attention_bwd_dkv": LAYERS, "layer_norm_fwd": LAYERS + 1,
    "add_layer_norm_fwd": LAYERS, "layer_norm_bwd": 2 * LAYERS + 1,
}
#: the kernels of the serving path (it runs no backward)
SERVING_KERNELS = ("flash_attention_fwd", "layer_norm_fwd",
                   "add_layer_norm_fwd")

# bench.py's training program as published (_bench_gpt): bf16 AMP O1
# through fleet, no final LayerNorm, fused vocab-chunked CE (chunk 8192)
AMP_CHUNK = 8192
# gradient oracle under bf16 AMP: per parameter, max |kernel route - dense
# route| <= AMP_GRAD_RTOL * max |dense route|. Both routes run the
# projections in bf16 but round at different places: the dense route
# rounds the scores and the probabilities to bf16 before its products
# (matmul is white-listed) and its head's logits to bf16 (linear), while
# the flash kernels keep the scores and P in f32 and the fused CE keeps
# the head in f32; each such rounding is up to 2^-9 relative, and the
# differences pass through 24 layers: 2e-2 is ~5 bf16 ulps. Printed
# beside each route's distance from the float32 dense route, which shows
# whether the kernel route is the one that strays.
AMP_GRAD_RTOL = 2e-2
#: launches of each kernel per AMP training step (24 layers, no ln_f), by
#: input types: the flash kernels in bf16 (white list), ln1 and the add-LN
#: backward in f32, the add-LN on the f32 residual and the bf16 branch
AMP_LAUNCHES = {
    "flash_attention_fwd": {"bfloat16": LAYERS},
    "flash_attention_bwd_dq": {"bfloat16": LAYERS},
    "flash_attention_bwd_dkv": {"bfloat16": LAYERS},
    "layer_norm_fwd": {"float32": LAYERS},
    "add_layer_norm_fwd": {"float32+bfloat16": LAYERS},
    "layer_norm_bwd": {"float32": 2 * LAYERS},
}


# head dim 256 (queue C's fault): one full-width ParallelGPTBlock
WIDE_D_MODEL, WIDE_HEADS, WIDE_B, WIDE_S = 2048, 8, 2, 1024
WIDE_H, WIDE_D = WIDE_HEADS, WIDE_D_MODEL // WIDE_HEADS

# bench.py's other training programs (main(), bench.py:1393-1440), at its
# sizes: LeNet (Adam 1e-3), ResNet-50 in float32 and bf16 AMP (Momentum
# 0.1, 0.9), BERT-base under bf16 AMP (AdamW 1e-4, 0.01)
BENCH_STEPS = 6
LENET_BATCH, RESNET_BATCH = 256, 256
BERT_B, BERT_S, BERT_D, BERT_HEADS, BERT_LAYERS = 32, 128, 768, 12, 12
BERT_VOCAB, BERT_POS = 30522, 512


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def close(a, b, dtype):
    """max |a - b| and whether every element is within TOL[dtype]. The
    lse of a fully masked row (the -1e30 sentinel) must match exactly and
    does not count in max |b|."""
    floor, rtol = TOL[dtype]
    a, b = a.float(), b.float()
    err = (a - b).abs()
    sentinel = b <= -1e29
    scale = b.abs().masked_fill(sentinel, 0).max()
    ok = torch.where(sentinel, err == 0, err <= floor * scale
                     + rtol * b.abs())
    return err.max().item(), bool(ok.all())


def peaks(ts):
    """max |t| of each tensor, formatted (the scale a tolerance meets)."""
    return [f"{t.float().abs().max().item():.3e}" for t in ts]


def time_ms(fn, calls=20, reps=5, stream=None):
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph on ``stream`` (a new side stream by default; pass the stream an
    autograd graph was recorded on to capture its backward), replayed
    ``reps`` times between CUDA events (no host launch cost in the number;
    inputs L2-warm)."""
    s = stream or torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
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


def bound_ms(nbytes, flops, dtype, peak=PEAK_FLOPS):
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = flops / peak[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


#: the kernels that must run their products on the tensor cores, by library
MMA_KERNELS = {"flash_attention_fwd": ("flash_attention_fwd",
                                       "flash_fwd_kernel"),
               "flash_attention_bwd_dq": ("flash_attention_bwd",
                                          "flash_dq_kernel"),
               "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                           "flash_dkv_kernel")}


def tensor_core_counts(build, libs):
    """HMMA (tensor-core) instructions in the SASS of each MMA_KERNELS
    kernel, summed over its instantiations, from ``cuobjdump -sass`` when
    the toolkit has it (else None). Fails when a kernel has none."""
    from pathlib import Path

    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("cuobjdump not in the toolkit: HMMA counts not read")
        return None
    counts = {}
    for name, (lib, kernel) in MMA_KERNELS.items():
        sass = subprocess.run([str(tool), "-sass", str(libs[lib])],
                              capture_output=True, text=True,
                              check=True).stdout
        per_fn, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                fn = fn if kernel in fn else None
                if fn:
                    per_fn[fn] = 0
            elif fn and "HMMA" in line:
                per_fn[fn] += 1
        counts[name] = sum(per_fn.values())
        print(f"HMMA instructions in {kernel}: {counts[name]} "
              f"({len(per_fn)} instantiations: {sorted(per_fn.values())})")
        if not per_fn or min(per_fn.values()) == 0:
            fail(f"{kernel} runs no product on the tensor cores")
    return counts


def flash_phase(fa, gen, rows):
    """Flash forward vs its plain version, at the model's head dim and at
    head dims 192/256 (the kernel's 256-column tiles) in every type;
    returns the JSON entry, timed at the training shape with the serving
    shape's and the D = 256 block shape's times beside it."""
    import torch.nn.functional as tF

    D0 = D_MODEL // HEADS
    serve, train, wide = "serving S=136", "training S=1024", \
        f"D={WIDE_D} block S={WIDE_S}"
    cases = [  # (B, H, Sq, Sk, D, causal, q_offset, kv_offset, what)
        (BATCH, HEADS, 128, 128, D0, True, 0, 0, "causal"),
        (BATCH, HEADS, 64, 128, D0, True, 64, 0,
         "end-aligned q_offset=Sk-Sq"),
        (BATCH, HEADS, 128, 128, D0, True, 0, 64, "64 fully masked rows"),
        (BATCH, HEADS, PROMPT + 8, PROMPT + 8, D0, True, 0, 0, serve),
        (TRAIN_B, HEADS, TRAIN_S, TRAIN_S, D0, True, 0, 0, train),
        (1, HEADS, 4 * TRAIN_S, 4 * TRAIN_S, D0, True, 0, 0, "long S=4096"),
        (WIDE_B, WIDE_H, WIDE_S, WIDE_S, WIDE_D, True, 0, 0, wide),
        (2, 4, 200, 200, 256, False, 0, 0, "ragged, not causal"),
        (2, 4, 136, 136, 192, True, 0, 0, "ragged causal"),
        (2, 4, 72, 200, 192, True, 128, 0, "end-aligned q_offset=Sk-Sq"),
    ]
    timed = {}
    for dtype in FLASH_DTYPES:
        for B, H, S, Sk, D, causal, qo, ko, what in cases:
            q, k, v = (torch.randn(B, H, n, D, device="cuda", generator=gen
                                   ).to(dtype) for n in (S, Sk, Sk))
            kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
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
                  f"{el:.3e} (max|out| {peaks([po])[0]})")
            if not (ok_o and ok_l):
                fail(f"flash_attention_fwd {dtype} D={D} {what} disagrees "
                     "with its plain version")
            # timed: every type at the training and D = 256 block shapes,
            # float32 at the serving shape too
            if what not in (train, wide) and not (
                    what == serve and dtype == torch.float32):
                continue
            calls = 20 if S <= 256 else 5
            ms = time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, block_q=8, block_k=8, **kw), calls=calls)
            lib_ms = time_ms(lambda: tF.scaled_dot_product_attention(
                q, k, v, is_causal=True), calls=calls)
            pairs = S * (S + 1) // 2  # visible (q, k) pairs per head
            nbytes = (3 * B * H * S * D + B * H * S * D) \
                * q.element_size() + B * H * S * 4
            bms, by = bound_ms(nbytes, 4 * D * pairs * B * H, dtype,
                               PEAK_MMA_FLOPS)
            plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, **kw), calls=calls)
            timed[what, SHORT[dtype]] = dict(
                shape=f"[{B},{H},{S},{D}] causal", max_abs_err=max(eo, el),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)
            rows.append(f"flash_attention_fwd {str(dtype)[6:]} [{B},{H},{S},"
                        f"{D}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"sdpa {lib_ms:.4f} ms, bound {bms:.6f} ms ({by})")
    return dict(name="flash_attention_fwd", route="cuda", source=fa.SOURCE,
                replaces="paddle_tpu/ops/pallas/flash_attention.py:49 "
                         "(_fwd_kernel_resident) and :110 (_fwd_kernel)",
                dtype="float32", **timed[train, "float32"],
                at_serving_shape=timed[serve, "float32"],
                bf16=timed[train, "bf16"], float16=timed[train, "float16"],
                head_dim_256={t: timed[wide, t] for t in SHORT.values()})


def ln_phase(ln, gen, rows):
    """LN and add-LN vs their plain versions; returns two JSON entries,
    timed at the training rows with the serving prefill's beside them."""
    import torch.nn.functional as tF

    timed = {}
    D = D_MODEL
    train_r, serve_r = TRAIN_B * TRAIN_S, BATCH * PROMPT
    # the serving rows: decode [8], a speculative round's target [8 x (k+1)]
    # and a prefill chunk [32]
    serve_rows = (BATCH, BATCH * (SPEC_K + 1), TIER_CHUNK)
    for dtype in (torch.float32, torch.bfloat16):
        for R in (train_r, serve_r) + serve_rows:
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
            for ytype in (torch.bfloat16, torch.float16):
                mixed = mixed_add_ln(ln, gen, R, D, rows, R == train_r,
                                     ytype)
                if mixed is not None:
                    timed[f"float32+{str(ytype)[6:]}"] = mixed
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
                timed.setdefault(name, {})[R] = dict(
                    shape=f"[{R},{D}]", max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms)
    for ytype in (torch.bfloat16, torch.float16):  # off the fast path
        mixed_add_ln(ln, gen, 37, 200, rows, False, ytype)
    entries = tuple(
        dict(name=name, route="cuda", source=ln.SOURCE,
             replaces=f"paddle_tpu/ops/pallas/layer_norm.py:{line}",
             dtype="float32", **timed[name][train_r],
             at_serving_shape=timed[name][serve_r],
             at_serving_rows={timed[name][R]["shape"]: timed[name][R]
                              for R in serve_rows})
        for name, line in (("layer_norm_fwd", "54 (_ln_fwd_kernel)"),
                           ("add_layer_norm_fwd", "68 (_add_ln_fwd_kernel)")))
    for pair in ("float32+bfloat16", "float32+float16"):
        entries[1][pair] = timed[pair]
    entries[0]["bert_base"] = bert_width_ln(ln, gen, rows)
    return entries


def bert_width_ln(ln, gen, rows):
    """B5 at BERT-base's rows (32 x 128 tokens, D 768, float32) against its
    plain version, timed beside ``F.layer_norm``; returns the dict."""
    import torch.nn.functional as tF

    R, D = BERT_B * BERT_S, BERT_D
    x = torch.randn(R, D, device="cuda", generator=gen)
    w, b = (torch.randn(D, device="cuda", generator=gen) for _ in range(2))
    got = ln.layer_norm_fwd(x, w, b)
    ref = ln.layer_norm_fwd_plain(x, w, b)
    torch.cuda.synchronize()
    errs = [close(a, r, torch.float32) for a, r in zip(got, ref)]
    print(f"layer_norm_fwd float32 [{R},{D}] (BERT-base): max err y/mu/rstd "
          f"{[f'{e:.3e}' for e, _ in errs]}")
    if not all(ok for _, ok in errs):
        fail(f"layer_norm_fwd float32 [{R},{D}] disagrees with its plain "
             "version")
    ms = time_ms(lambda: ln.layer_norm_fwd(x, w, b))
    plain_ms = time_ms(lambda: ln.layer_norm_fwd_plain(x, w, b))
    lib_ms = time_ms(lambda: tF.layer_norm(x, (D,), w, b, 1e-5))
    bms, by = bound_ms(2 * R * D * 4 + 2 * D * 4 + 2 * R * 4, 8 * R * D,
                       torch.float32)
    rows.append(f"layer_norm_fwd f32 [{R},{D}]: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                f"{bms:.6f} ms ({by})")
    return dict(shape=f"[{R},{D}]", max_abs_err=max(e for e, _ in errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def mixed_add_ln(ln, gen, R, D, rows, timed, ytype):
    """The add-LN kernel on AMP O1's pair (x float32, y bfloat16 or
    float16) against its plain version: s bit-equal, LN(s) and the
    statistics within the float32 tolerance. Timed (and its dict returned)
    when ``timed``."""
    pair = f"float32+{str(ytype)[6:]}"
    x = torch.randn(R, D, device="cuda", generator=gen)
    y = torch.randn(R, D, device="cuda", generator=gen).to(ytype)
    w, b = (torch.randn(D, device="cuda", generator=gen) for _ in range(2))
    got = ln.add_layer_norm_fwd(x, y, w, b)
    ref = ln.add_layer_norm_fwd_plain(x, y, w, b)
    torch.cuda.synchronize()
    errs = [close(a, r, torch.float32) for a, r in zip(got, ref)]
    same_s = bool(torch.equal(got[0], ref[0]))
    print(f"add_layer_norm_fwd {pair} [{R},{D}]: max err "
          f"s/y/mu/rstd {[f'{e:.3e}' for e, _ in errs]}; s bit-equal "
          f"{same_s}")
    if not (same_s and all(ok for _, ok in errs)) \
            or got[0].dtype != torch.float32:
        fail(f"add_layer_norm_fwd {pair} R={R} D={D} disagrees with its "
             "plain version")
    if not timed:
        return None
    ms = time_ms(lambda: ln.add_layer_norm_fwd(x, y, w, b))
    plain_ms = time_ms(lambda: ln.add_layer_norm_fwd_plain(x, y, w, b))
    # reads x (f32), y (16-bit), w, b; writes s, LN(s) (f32), mu, rstd
    bms, by = bound_ms(R * D * (4 + 2) + 2 * R * D * 4 + 2 * D * 4
                       + 2 * R * 4, 8 * R * D, torch.float32)
    rows.append(f"add_layer_norm_fwd {pair} [{R},{D}]: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library n/a, bound "
                f"{bms:.6f} ms ({by})")
    return dict(shape=f"[{R},{D}]", max_abs_err=max(e for e, _ in errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


def flash_bwd_phase(fa, gen, rows):
    """B3 (dq) and B4 (dk/dv) vs the plain backward, at the model's head
    dim and at head dims 192/256 in every type; returns two JSON entries,
    timed at the training shape with the D = 256 block shape's times
    beside it."""
    import torch.nn.functional as tF

    S, D0 = TRAIN_S, D_MODEL // HEADS
    train, wide = "training S=1024", f"D={WIDE_D} block S={WIDE_S}"
    cases = [  # (B, H, Sq, Sk, D, causal, q_offset, kv_offset, what)
        (TRAIN_B, HEADS, S, S, D0, True, 0, 0, train),
        (2, HEADS, 128, 256, D0, True, 128, 0, "end-aligned q_offset=Sk-Sq"),
        (2, HEADS, 256, 256, D0, True, 0, 64, "64 fully masked rows"),
        (1, HEADS, 4 * S, 4 * S, D0, True, 0, 0, "long S=4096"),
        (WIDE_B, WIDE_H, WIDE_S, WIDE_S, WIDE_D, True, 0, 0, wide),
        (2, 4, 200, 200, 256, False, 0, 0, "ragged, not causal"),
        (2, 4, 136, 136, 192, True, 0, 0, "ragged causal"),
        (2, 4, 72, 200, 192, True, 128, 0, "end-aligned q_offset=Sk-Sq"),
    ]
    timed = {}
    for dtype in FLASH_DTYPES:
        for b, h, sq, sk, D, causal, qo, ko, what in cases:
            q, do = (torch.randn(b, h, sq, D, device="cuda", generator=gen
                                 ).to(dtype) for _ in range(2))
            k, v = (torch.randn(b, h, sk, D, device="cuda", generator=gen
                                ).to(dtype) for _ in range(2))
            kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
            # out and lse from the plain forward: the backward's check does
            # not lean on B1
            out, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
            delta = (do.float() * out.float()).sum(-1)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                **kw)
            ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                               **kw)
            torch.cuda.synchronize()
            errs = [close(a, r, dtype) for a, r in zip((dq, dk, dv), ref)]
            print(f"flash_attention_bwd {str(dtype)[6:]} [{b},{h},{sq},"
                  f"{sk},{D}] {what}: max|dq err| {errs[0][0]:.3e} "
                  f"max|dk err| {errs[1][0]:.3e} max|dv err| "
                  f"{errs[2][0]:.3e} (max|dq|, |dk|, |dv| {peaks(ref)})")
            if not all(ok for _, ok in errs):
                fail(f"flash backward {dtype} D={D} {what} disagrees with "
                     "its plain version")
            if ko and not bool((dq[:, :, :ko] == 0).all()):
                fail(f"flash backward {what}: fully masked rows must get "
                     "dq = 0")
            if what not in (train, wide):
                continue
            ms_dq = time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, **kw), calls=5)
            ms_dkv = time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, **kw), calls=5)
            # SDPA's backward alone: its forward is recorded on the stream
            # that the backward is then captured on
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                lib_out = tF.scaled_dot_product_attention(ql, kl, vl,
                                                          is_causal=True)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), do, retain_graph=True), calls=5,
                stream=side)
            pairs = b * h * sq * (sq + 1) // 2  # visible (q, k) pairs
            el, it = b * h * sq * D, q.element_size()
            # dq: reads q, k, v, dO, lse, delta, writes dq; 3 products
            # of length D per visible pair. dk/dv: the same reads, writes
            # dk, dv; 4 products.
            b_dq = bound_ms(5 * el * it + 2 * b * h * sq * 4,
                            6 * D * pairs, dtype, PEAK_MMA_FLOPS)
            b_dkv = bound_ms(6 * el * it + 2 * b * h * sq * 4,
                             8 * D * pairs, dtype, PEAK_MMA_FLOPS)
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, do, lse, delta, **kw), calls=5)
            for name, ms, (bms, by), err in (
                    ("flash_attention_bwd_dq", ms_dq, b_dq, errs[0][0]),
                    ("flash_attention_bwd_dkv", ms_dkv, b_dkv,
                     max(errs[1][0], errs[2][0]))):
                timed[name, what, SHORT[dtype]] = dict(
                    shape=f"[{b},{h},{sq},{D}] causal", max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms)
                rows.append(f"{name} {str(dtype)[6:]} [{b},{h},{sq},{D}]: "
                            f"kernel {ms:.4f} ms, plain (dq, dk, dv) "
                            f"{plain_ms:.4f} ms, sdpa backward (dq, dk, dv) "
                            f"{lib_ms:.4f} ms, bound {bms:.6f} ms ({by})")
    return tuple(
        dict(name=name, route="cuda", source=fa.BWD_SOURCE,
             replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
             dtype="float32", **timed[name, train, "float32"],
             bf16=timed[name, train, "bf16"],
             float16=timed[name, train, "float16"],
             head_dim_256={t: timed[name, wide, t] for t in SHORT.values()})
        for name, line in (("flash_attention_bwd_dq", "171 (_dq_kernel)"),
                           ("flash_attention_bwd_dkv", "224 (_dkv_kernel)")))


def ln_bwd_phase(ln, gen, rows):
    """B7 vs the plain LayerNorm backward; returns the JSON entry."""
    entry = bert_entry = None
    # the training rows, BERT-base's rows, a few rows, and rows off the
    # register path (D not a multiple of 128; R not a multiple of the
    # block's 8 warps)
    bert = BERT_B * BERT_S, BERT_D
    for dtype in (torch.float32, torch.bfloat16):
        for R, D in ((TRAIN_B * TRAIN_S, D_MODEL), bert, (40, D_MODEL),
                     (37, 200)):
            x, g = (torch.randn(R, D, device="cuda", generator=gen
                                ).to(dtype) for _ in range(2))
            w, b = (torch.randn(D, device="cuda", generator=gen
                                ).to(dtype) for _ in range(2))
            _, mu, rs = ln.layer_norm_fwd_plain(x, w, b)  # not through B5
            got = ln.layer_norm_bwd(x, w, mu, rs, g)
            ref = ln.layer_norm_bwd_plain(x, w, mu, rs, g)
            torch.cuda.synchronize()
            errs = [close(a, r, dtype) for a, r in zip(got, ref)]
            print(f"layer_norm_bwd {str(dtype)[6:]} [{R},{D}]: max err "
                  f"dx/dw/db {[f'{e:.3e}' for e, _ in errs]} (max|dx|, "
                  f"|dw|, |db| {peaks(ref)})")
            if not all(ok for _, ok in errs):
                fail(f"layer_norm_bwd {dtype} R={R} disagrees with its "
                     "plain version")
            if dtype != torch.float32 or R not in (TRAIN_B * TRAIN_S,
                                                   bert[0]):
                continue
            ms = time_ms(lambda: ln.layer_norm_bwd(x, w, mu, rs, g))
            plain_ms = time_ms(lambda: ln.layer_norm_bwd_plain(
                x, w, mu, rs, g))
            _, amu, ars = torch.ops.aten.native_layer_norm(x, [D], w, b,
                                                           1e-5)
            lib_ms = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                g, x, [D], amu, ars, w, b, [True, True, True]))
            it = x.element_size()
            # reads x, g, w, mu, rstd; writes dx, dweight, dbias
            bms, by = bound_ms(3 * R * D * it + 3 * D * it + 2 * R * 4,
                               10 * R * D, dtype)
            rows.append(f"layer_norm_bwd f32 [{R},{D}]: kernel {ms:.4f} "
                        f"ms, plain {plain_ms:.4f} ms, native_layer_norm_"
                        f"backward {lib_ms:.4f} ms, bound {bms:.6f} ms "
                        f"({by})")
            if D == BERT_D:
                bert_entry = dict(
                    shape=f"[{R},{D}]", max_abs_err=max(e for e, _ in errs),
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms)
                continue
            entry = dict(
                name="layer_norm_bwd", route="cuda", source=ln.SOURCE,
                replaces="paddle_tpu/ops/pallas/layer_norm.py:87 "
                         "(_ln_bwd_kernel)",
                shape=f"[{R},{D}]", dtype="float32",
                max_abs_err=max(e for e, _ in errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)
    entry["bert_base"] = bert_entry
    return entry


def training_phase(pt, kernels):
    """Train the GPT-medium model through TrainStep + AdamW; returns the
    per-kernel launch counts of the steps."""
    import os

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    V = VOCAB
    t0 = time.perf_counter()
    model = pt.TransformerLM(V, D_MODEL, HEADS, LAYERS,
                             max_position=TRAIN_S, dim_feedforward=FFN,
                             seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(1)
    ids = torch.as_tensor(rng.randint(0, V, size=(TRAIN_B, TRAIN_S + 1)),
                          device=model.device)
    inputs, labels = ids[:, :-1], ids[:, 1:]

    def loss_fn(logits, lab):
        return pt.nn.functional.cross_entropy(logits.reshape(-1, V),
                                              lab.reshape(-1))

    def grads(route):
        os.environ["PADDLE_FLASH_DEFAULT"] = route
        os.environ["PADDLE_FUSED_LN"] = route
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model(inputs), labels)
        loss.backward()
        out = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), out

    # the oracle: every parameter's gradient through the kernels against
    # the dense route (torch autograd through materialized attention and
    # plain LayerNorms)
    kernels.reset_launches()
    loss_k, g_k = grads("1")
    oracle_counts = kernels.launches()
    loss_d, g_d = grads("0")
    os.environ.pop("PADDLE_FLASH_DEFAULT")
    os.environ.pop("PADDLE_FUSED_LN")
    worst, worst_name = 0.0, ""
    for n, gd in g_d.items():
        gk = g_k.get(n)
        if gk is None or not bool(torch.isfinite(gk).all()):
            fail(f"kernel route gives no finite gradient for {n}")
        scale = gd.abs().max().item()
        rel = (gk - gd).abs().max().item() / max(scale, 1e-30)
        if scale == 0 or rel > worst:
            worst, worst_name = (rel, n) if scale else (float("inf"), n)
    print(f"gradient oracle, {n_params} float32 parameters, B={TRAIN_B} "
          f"S={TRAIN_S}: loss kernels {loss_k:.6f} dense {loss_d:.6f}; "
          f"worst max|g_kernel - g_dense| / max|g_dense| {worst:.3e} "
          f"({worst_name}; tolerance {GRAD_RTOL}); launches {oracle_counts}")
    if abs(loss_k - loss_d) > 1e-4 or worst > GRAD_RTOL:
        fail("kernel-route gradients disagree with the dense route")
    del g_k, g_d

    opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01)
    step = pt.jit.TrainStep(model, loss_fn, opt)
    torch.cuda.synchronize()
    print(f"training model built and checked in "
          f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()  # the training path starts here
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step(inputs, labels).item())  # .item() syncs
        ms.append((time.perf_counter() - t1) * 1e3)
    counts = kernels.launches()  # the training path ends here
    steady = float(np.mean(ms[1:]))
    print(f"TrainStep B={TRAIN_B} S={TRAIN_S} AdamW: losses "
          f"{[f'{x:.5f}' for x in losses]}; step ms {[f'{x:.1f}' for x in ms]}"
          f"; steady {steady:.2f} ms/step, "
          f"{TRAIN_B * TRAIN_S / steady * 1e3:.1f} tokens/s (after one "
          f"warm-up step); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches on the training path ({TRAIN_STEPS} steps): {counts}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("training loss is not finite or did not fall")
    for name, per_step in TRAIN_LAUNCHES.items():
        if counts[name] != per_step * TRAIN_STEPS:
            fail(f"kernel {name}: {counts[name]} launches on the training "
                 f"path, expected {per_step} per step")
    return counts


def bench_gpt(pt, layers, seq, seed):
    """bench.py's ``_gpt_medium`` from the port's layers: token and
    position embeddings, ``layers`` ParallelGPTBlocks (dropout 0), no
    final LayerNorm, and a head that the loss uses
    (``fused_linear_cross_entropy``); forward returns the hidden state."""
    from paddle_tpu_torch.distributed import ParallelGPTBlock

    class GPT(torch.nn.Module):
        def __init__(self):
            super().__init__()
            kw = dict(device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(seed))
            self.embed = pt.nn.Embedding(VOCAB, D_MODEL, **kw)
            self.pos = pt.nn.Embedding(seq, D_MODEL, **kw)
            self.blocks = pt.nn.LayerList([
                ParallelGPTBlock(D_MODEL, HEADS, FFN, dropout=0.0, **kw)
                for _ in range(layers)])
            self.head = pt.nn.Linear(D_MODEL, VOCAB, **kw)

        def forward(self, ids):
            pos_ids = pt.arange(ids.shape[1], dtype="int64",
                                device=ids.device)
            h = self.embed(ids) + self.pos(pos_ids)
            for blk in self.blocks:
                h = blk(h)
            return h

    return GPT()


def amp_training_phase(pt, kernels, amp_dtype="bfloat16"):
    """Train bench.py's GPT-medium as bench.py does: ``strategy.amp``
    through ``fleet.init``, ``fleet.distributed_optimizer(AdamW(1e-4,
    0.01))``, ``fused_linear_cross_entropy`` (chunk 8192) and
    ``TrainStep``; one gradient oracle first, then six steps on bench's
    fixed batch. ``amp_dtype="float16"`` sets ``amp_configs["use_bf16"] =
    False``: float16 O1 with dynamic loss scaling, whose initial scale the
    oracle applies too (an unscaled float16 backward would flush small
    gradients to zero). Returns the launch counts of the steps."""
    import os

    from paddle_tpu_torch.distributed import fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp16 = amp_dtype == "float16"
    t0 = time.perf_counter()
    model = bench_gpt(pt, LAYERS, TRAIN_S, seed=3 if fp16 else 2)
    n_params = sum(p.numel() for p in model.parameters())
    n = TRAIN_B * TRAIN_S
    ids = torch.as_tensor((np.arange(n) % 31000).reshape(TRAIN_B, TRAIN_S),
                          device="cuda")
    labels = torch.as_tensor(((np.arange(n) + 1) % 31000).reshape(
        TRAIN_B, TRAIN_S), device="cuda")

    def lm_loss(h, lab):
        return pt.nn.functional.fused_linear_cross_entropy(
            h.reshape(-1, D_MODEL), model.head.weight, model.head.bias,
            lab.reshape(-1))

    strategy = fleet.DistributedStrategy()
    strategy.amp = True
    if fp16:
        strategy.amp_configs = {"use_bf16": False}
    fleet.init(is_collective=True, strategy=strategy)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01))
    step = pt.jit.TrainStep(model, lm_loss, opt)
    scale = strategy.amp_configs["init_loss_scaling"] if fp16 else 1.0

    def grads(route, amp_on=True):
        """(loss, {name: grad}) of one batch: route "1" through the
        kernels and the fused CE, "0" dense attention, dense LayerNorms
        and materialized-logit cross_entropy (torch autograd)."""
        os.environ["PADDLE_FLASH_DEFAULT"] = route
        os.environ["PADDLE_FUSED_LN"] = route
        os.environ["PADDLE_CE_CHUNK"] = str(AMP_CHUNK) if route == "1" \
            else "0"
        model.zero_grad(set_to_none=True)
        with pt.amp.auto_cast(amp_on, level="O1", dtype=amp_dtype):
            loss = lm_loss(model(ids), labels)
        (loss * scale).backward()
        out = {k: p.grad / scale for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        for knob in ("PADDLE_FLASH_DEFAULT", "PADDLE_FUSED_LN",
                     "PADDLE_CE_CHUNK"):
            os.environ.pop(knob)
        return loss.item(), out

    def worst(got, want):
        w, name = 0.0, ""
        for k, gd in want.items():
            scale = gd.abs().max().item()
            rel = (got[k].float() - gd.float()).abs().max().item() \
                / max(scale, 1e-30)
            if scale == 0 or rel > w:
                w, name = (rel, k) if scale else (float("inf"), k)
        return w, name

    kernels.reset_launches()
    loss_k, g_k = grads("1")
    oracle_counts = kernels.launches_by_dtype()
    loss_d, g_d = grads("0")
    for k, g in g_k.items():
        if g is None or g.dtype != torch.float32 \
                or not bool(torch.isfinite(g).all()):
            fail(f"kernel route gives no finite float32 gradient for {k}")
    w_kd, n_kd = worst(g_k, g_d)
    loss_f, g_f = grads("0", amp_on=False)  # float32, for scale only
    w_kf, _ = worst(g_k, g_f)
    w_df, _ = worst(g_d, g_f)
    del g_f
    print(f"AMP gradient oracle, {n_params} float32 parameters under "
          f"{amp_dtype} O1 (loss scale {scale}), B={TRAIN_B} S={TRAIN_S}: "
          f"loss kernels {loss_k:.6f} dense "
          f"{loss_d:.6f} (float32 dense {loss_f:.6f}); worst max|g_kernel - "
          f"g_dense| / max|g_dense| {w_kd:.3e} ({n_kd}; tolerance "
          f"{AMP_GRAD_RTOL}); against the float32 dense route: kernels "
          f"{w_kf:.3e}, dense bf16 {w_df:.3e}; launches {oracle_counts}")
    if abs(loss_k - loss_d) > AMP_GRAD_RTOL * abs(loss_d) \
            or w_kd > AMP_GRAD_RTOL:
        fail("AMP kernel-route gradients disagree with the dense route")
    del g_k, g_d
    torch.cuda.synchronize()
    # hand back the dense routes' activations, so that the steps below
    # start from the allocator state a training job starts from
    torch.cuda.empty_cache()
    print(f"AMP training model built and checked in "
          f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()  # the AMP training path starts here
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step(ids, labels).item())  # .item() syncs
        ms.append((time.perf_counter() - t1) * 1e3)
    counts = kernels.launches_by_dtype()  # the AMP training path ends here
    steady = float(np.mean(ms[1:]))
    applied = TRAIN_STEPS
    if fp16:
        applied = step.state_dict()["scaler"]["applied_steps"]
        print(f"float16 loss scaler after {TRAIN_STEPS} steps: "
              f"{step.state_dict()['scaler']}; skipped steps "
              f"{TRAIN_STEPS - applied}")
    print(f"TrainStep {amp_dtype} AMP O1 (fleet) B={TRAIN_B} S={TRAIN_S} "
          f"AdamW, "
          f"fused CE chunk {AMP_CHUNK}: losses "
          f"{[f'{x:.5f}' for x in losses]}; step ms "
          f"{[f'{x:.1f}' for x in ms]}; steady {steady:.2f} ms/step, "
          f"{TRAIN_B * TRAIN_S / steady * 1e3:.1f} tokens/s (after one "
          f"warm-up step); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches on the AMP training path ({TRAIN_STEPS} steps), by "
          f"input types: {counts}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] \
            or applied == 0:
        fail("AMP training loss is not finite or did not fall")
    for name, per_step in AMP_LAUNCHES.items():
        want = {k.replace("bfloat16", amp_dtype): v * TRAIN_STEPS
                for k, v in per_step.items()}
        if counts[name] != want:
            fail(f"kernel {name}: launches {counts[name]} on the AMP "
                 f"training path, expected {want}")
    return {k: sum(v.values()) for k, v in counts.items()}


def wide_block_phase(pt, kernels):
    """One ParallelGPTBlock at d_model 2048 with 8 heads (head dim 256), B
    = 2, S = 1024: the forward's output and the input's and every
    parameter's gradient under a random cotangent through the kernels
    against the dense route, in float32 (TF32 off) and under bf16 AMP O1.
    Returns the kernels' launches by input types, per run."""
    import os

    from paddle_tpu_torch.distributed import ParallelGPTBlock

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    blk = ParallelGPTBlock(WIDE_D_MODEL, WIDE_HEADS, device="cuda",
                           generator=gen)
    x = torch.randn(WIDE_B, WIDE_S, WIDE_D_MODEL, device="cuda",
                    generator=gen)
    cot = torch.randn(WIDE_B, WIDE_S, WIDE_D_MODEL, device="cuda",
                      generator=gen)

    def run(route, amp_dtype):
        os.environ["PADDLE_FLASH_DEFAULT"] = route
        os.environ["PADDLE_FUSED_LN"] = route
        blk.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        with pt.amp.auto_cast(amp_dtype != "float32", level="O1",
                              dtype="bfloat16"):
            out = blk(xi)
        (out.float() * cot).sum().backward()
        res = {n: p.grad for n, p in blk.named_parameters()}
        res["x"], res["out"] = xi.grad, out.detach().float()
        for knob in ("PADDLE_FLASH_DEFAULT", "PADDLE_FUSED_LN"):
            os.environ.pop(knob)
        return res

    counts = {}
    for amp_dtype, tol in (("float32", GRAD_RTOL),
                           ("bfloat16", AMP_GRAD_RTOL)):
        kernels.reset_launches()  # this run starts here
        got = run("1", amp_dtype)
        counts[amp_dtype] = kernels.launches_by_dtype()  # and ends here
        want = run("0", amp_dtype)
        worst, worst_name = 0.0, ""
        for n, w in want.items():
            rel = (got[n].float() - w.float()).abs().max().item() \
                / max(w.abs().max().item(), 1e-30)
            if not np.isfinite(rel) or rel > worst:
                worst, worst_name = rel, n
        flash_type = "float32" if amp_dtype == "float32" else "bfloat16"
        print(f"ParallelGPTBlock d_model {WIDE_D_MODEL}, {WIDE_HEADS} heads "
              f"(head dim {WIDE_D}), B={WIDE_B} S={WIDE_S}, {amp_dtype}: "
              f"worst max|kernels - dense| / max|dense| over the output and "
              f"the gradients {worst:.3e} ({worst_name}; tolerance {tol}); "
              f"launches {counts[amp_dtype]}")
        if not worst <= tol:
            fail(f"head dim {WIDE_D} block ({amp_dtype}) disagrees with the "
                 "dense route")
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            if counts[amp_dtype][name] != {flash_type: 1}:
                fail(f"kernel {name}: launches {counts[amp_dtype][name]} in "
                     f"the head dim {WIDE_D} block, expected one in "
                     f"{flash_type}")
    del blk, got, want
    torch.cuda.empty_cache()
    return counts


def bench_bert(pt):
    """bench.py's ``_bert_base`` from the port's layers: token and
    position embeddings, 12 post-LN TransformerEncoderLayers (768 wide, 12
    heads, ffn 3072, dropout 0), the mean over the sequence, a 2-way
    head."""

    class Bert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            kw = dict(device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(5))
            self.embed = pt.nn.Embedding(BERT_VOCAB, BERT_D, **kw)
            self.pos = pt.nn.Embedding(BERT_POS, BERT_D, **kw)
            self.encoder = pt.nn.LayerList([
                pt.nn.TransformerEncoderLayer(BERT_D, BERT_HEADS, 4 * BERT_D,
                                              dropout=0.0, **kw)
                for _ in range(BERT_LAYERS)])
            self.head = pt.nn.Linear(BERT_D, 2, **kw)

        def forward(self, ids):
            pos_ids = pt.arange(ids.shape[1], dtype="int64",
                                device=ids.device)
            h = self.embed(ids) + self.pos(pos_ids)
            for lyr in self.encoder:
                h = lyr(h)
            return self.head(h.mean(dim=1))

    return Bert()


def bench_program_phase(pt, kernels, name, model, opt, x, y, amp, unit,
                        launches):
    """Train one of bench.py's programs as ``_bench_train`` /
    ``_bench_bert`` do (``TrainStep`` with ``cross_entropy``; bf16 AMP
    through ``fleet`` when ``amp``) for BENCH_STEPS steps on one batch
    made on the card: prints the rate (``unit`` per second, from the mean
    host time of steps 2-6 around a synchronize), the step times, peak
    memory, the losses (which must be finite and fall) and the kernels'
    launches by input types (which must equal ``launches`` per step).
    Returns the launches."""
    from paddle_tpu_torch.distributed import fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if amp:
        strategy = fleet.DistributedStrategy()
        strategy.amp = True
        fleet.init(is_collective=True, strategy=strategy)
        opt = fleet.distributed_optimizer(opt)
    step = pt.jit.TrainStep(
        model, lambda out, lab: pt.nn.functional.cross_entropy(out, lab),
        opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()  # this program's path starts here
    losses, ms = [], []
    for _ in range(BENCH_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step(x, y).item())  # .item() syncs
        ms.append((time.perf_counter() - t1) * 1e3)
    counts = kernels.launches_by_dtype()  # and ends here
    steady = float(np.mean(ms[1:]))
    print(f"{name}: batch {x.shape[0]}, {x.shape[0] / steady * 1e3:.1f} "
          f"{unit}/s, {steady:.2f} ms/step (mean of steps 2-"
          f"{BENCH_STEPS}); step ms {[f'{t:.1f}' for t in ms]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
          f"{[f'{v:.5f}' for v in losses]}; launches {counts}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{name}: loss is not finite or did not fall")
    want = {k: {t: n * BENCH_STEPS for t, n in launches.get(k, {}).items()}
            for k in counts}
    if counts != want:
        fail(f"{name}: launches {counts}, expected {want}")
    del step, opt, model
    torch.cuda.empty_cache()
    return counts


def bench_programs_phase(pt, kernels):
    """bench.py's LeNet, ResNet-50 (float32 and bf16 AMP) and BERT-base
    programs at its sizes; returns each path's launches by input types."""
    from paddle_tpu_torch.vision.models import LeNet, resnet50

    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    x = torch.rand(LENET_BATCH, 1, 28, 28, device="cuda", generator=gen)
    y = torch.arange(LENET_BATCH, device="cuda") % 10
    out["lenet"] = bench_program_phase(
        pt, kernels, "LeNet (Adam 1e-3, float32)", LeNet(generator=gen),
        pt.optimizer.Adam(learning_rate=1e-3), x, y, False, "imgs", {})
    x = torch.rand(RESNET_BATCH, 3, 224, 224, device="cuda", generator=gen)
    y = torch.arange(RESNET_BATCH, device="cuda") % 1000
    for amp in (False, True):
        label = "resnet50_bf16" if amp else "resnet50_f32"
        out[label] = bench_program_phase(
            pt, kernels, f"ResNet-50 (Momentum 0.1/0.9, "
            f"{'bf16 AMP' if amp else 'float32, TF32 off'})",
            resnet50(num_classes=1000, generator=gen),
            pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9), x, y,
            amp, "imgs", {})
    del x
    ids = torch.arange(BERT_B * BERT_S, device="cuda").reshape(
        BERT_B, BERT_S) % 30000
    y = torch.arange(BERT_B, device="cuda") % 2
    # the post-LN encoder's two LayerNorms a layer on the float32 residual
    # sums ([4096, 768]): B5 forward, B7 backward
    ln_per_step = {"float32": 2 * BERT_LAYERS}
    out["bert"] = bench_program_phase(
        pt, kernels, "BERT-base (AdamW 1e-4/0.01, bf16 AMP)", bench_bert(pt),
        pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01), ids, y,
        True, "samples", {"layer_norm_fwd": ln_per_step,
                          "layer_norm_bwd": ln_per_step})
    return out


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
        if (n <= 0) == (name in SERVING_KERNELS):
            fail(f"kernel {name}: {n} launches on the serving path")
    return counts


def serving_tier_phase(pt, kernels, card):
    """The serving tier at GPT-medium width: bench.py's
    ``_bench_decode_paged`` (paged ``generate``, the chunked paged engine)
    and the colocated half of ``_bench_serve_multitenant`` (the prefix
    cache's cold and warm requests, a mixed-adapter fleet), each held to
    its plain form: paged equals contiguous, chunked equals unchunked, warm
    equals cold, mixed equals each request served alone. Returns the
    per-kernel launch counts of the phase."""
    import os

    from paddle_tpu_torch.jit import DecodeStep, PrefillStep
    from paddle_tpu_torch.serving import Request, paged_kv
    from paddle_tpu_torch.serving.adapters import AdapterSet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cap = PROMPT + NEW
    cap += (-cap) % TIER_BLOCK  # engine pools splice block-aligned
    model = pt.TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS, max_position=cap,
                             dim_feedforward=FFN, seed=2)
    # bench's prompts: rows of arange % 31000
    prompts = (np.arange(BATCH * PROMPT) % 31000).reshape(BATCH, PROMPT)
    one = (np.arange(PROMPT) % 31000).astype(np.int32)
    pre, dec = PrefillStep(model), DecodeStep(model)
    os.environ["PADDLE_SERVE_BLOCK_SIZE"] = str(TIER_BLOCK)
    try:
        if not isinstance(model.gen_cache(1, cap)[0].k, paged_kv.PagedKV):
            fail("PADDLE_SERVE_BLOCK_SIZE did not page the cache")
        # warm the step objects the timed call uses (bench's pattern)
        pt.generate(model, prompts, 2, max_length=cap, prefill=pre,
                    decode=dec)
        kernels.reset_launches()  # the phase's main path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paged = pt.generate(model, prompts, NEW, max_length=cap,
                            prefill=pre, decode=dec)
        gen_s = time.perf_counter() - t0
    finally:
        del os.environ["PADDLE_SERVE_BLOCK_SIZE"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    contig = pt.generate(model, prompts, NEW, max_length=cap, prefill=pre,
                         decode=dec)
    contig_s = time.perf_counter() - t0
    same = bool(np.array_equal(paged, contig))
    print(f"paged generate (block {TIER_BLOCK}) B={BATCH} prompt={PROMPT} "
          f"new={NEW} cap={cap}: {BATCH * NEW / gen_s:.1f} tokens/s "
          f"({gen_s * 1e3:.1f} ms), the contiguous cache's right after "
          f"{BATCH * NEW / contig_s:.1f} tokens/s; tokens equal: {same}")
    if not same or (paged < 0).any() or (paged >= VOCAB).any():
        fail("paged generate disagrees with the contiguous cache")

    def serve(reqs, **kw):
        eng = pt.InferenceEngine(model, max_length=kw.pop("cap", cap), **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        res = eng.run()
        return eng, res, time.perf_counter() - t0

    def requests(n, prompt, new, adapter=lambda i: 0):
        return [Request(prompt, max_new_tokens=new, rid=i,
                        adapter=adapter(i)) for i in range(n)]

    # bench's chunked engine: pool sized by the requests' demand (prompt +
    # 16 new per slot), not by capacity
    need = paged_kv.blocks_for(PROMPT + TIER_ENGINE_NEW, TIER_BLOCK)
    demand = 4 * need + 1
    reqs = requests(8, one, TIER_ENGINE_NEW)
    eng, res, eng_s = serve(reqs, slots=4, block_size=TIER_BLOCK,
                            prefill_chunk=TIER_CHUNK, pool_blocks=demand)
    _, plain, _ = serve(requests(8, one, TIER_ENGINE_NEW), slots=4)
    ttfts = sorted(r.ttft_ms for r in res.values())
    held = paged_kv.pool_bytes(eng._state.caches)
    worst = paged_kv.worst_case_bytes(4, HEADS, cap, D_MODEL // HEADS,
                                      itemsize=4, layers=LAYERS)
    print(f"chunked paged engine (slots 4, chunk {TIER_CHUNK}, "
          f"{demand} blocks): 8 x {TIER_ENGINE_NEW} tokens in "
          f"{eng_s * 1e3:.1f} ms, median TTFT {ttfts[len(ttfts) // 2]:.2f} "
          f"ms (min {ttfts[0]:.2f}, max {ttfts[-1]:.2f}); admission deferred "
          f"{eng._admit_deferred} times (4 slots x {need} blocks fill the "
          f"pool exactly); KV pool {held} bytes against the contiguous "
          f"worst case {worst}")
    # the same requests over a pool that covers three of them: admission
    # must defer while the fourth slot is free
    tight, tres, _ = serve(requests(8, one, TIER_ENGINE_NEW), slots=4,
                           block_size=TIER_BLOCK, prefill_chunk=TIER_CHUNK,
                           pool_blocks=3 * need + 1)
    print(f"chunked paged engine over {3 * need + 1} blocks: admission "
          f"deferred {tight._admit_deferred} times")
    for got in (res, tres):
        if any(got[i].tokens != plain[i].tokens for i in range(8)):
            fail("the chunked paged engine disagrees with the unchunked "
                 "contiguous engine")
    if tight._admit_deferred < 1 or held >= worst \
            or len(plain[0].tokens) != TIER_ENGINE_NEW:
        fail("paged admission did not defer, or the pool is not smaller "
             "than the worst case")

    # bench's multitenant half: adapters attach before any engine
    adapters = AdapterSet(model, n_adapters=4, rank=8)
    adapters.load(1)
    adapters.load(2)
    px = pt.InferenceEngine(model, slots=2, max_length=MT_CAP,
                            block_size=TIER_BLOCK, prefix_cache=True)
    cold_warm = {}
    for rid in ("cold", "warm"):
        px.submit(Request(one, max_new_tokens=8, rid=rid))
        cold_warm[rid] = px.run()[rid]
    hit_rate = px._prefix_hits / 2.0
    warm_same = cold_warm["warm"].tokens == cold_warm["cold"].tokens
    print(f"prefix cache (cap {MT_CAP}, block {TIER_BLOCK}): cold TTFT "
          f"{cold_warm['cold'].ttft_ms:.2f} ms, warm TTFT "
          f"{cold_warm['warm'].ttft_ms:.2f} ms, hit rate {hit_rate}, "
          f"{px._prefix_blocks_shared} blocks shared, {px._cow_copies} "
          f"copied on write; warm tokens equal cold: {warm_same}")
    if px._prefix_hits != 1 or not warm_same:
        fail("the warm request missed the prefix cache or disagrees")
    fleet, mixed, mixed_s = serve(
        requests(8, one, MT_NEW, adapter=lambda i: i % 3), slots=8,
        cap=MT_CAP, block_size=TIER_BLOCK)
    alone = {}
    for a in range(3):
        _, r, _ = serve(requests(1, one, MT_NEW, adapter=lambda i: a),
                        slots=8, cap=MT_CAP, block_size=TIER_BLOCK)
        alone[a] = r[0].tokens
    same = all(mixed[i].tokens == alone[i % 3] for i in range(8))
    distinct = len({tuple(t) for t in alone.values()})
    print(f"adapter fleet: {len(adapters.resident) - 1} adapters, 8 "
          f"requests (adapter i % 3) x {MT_NEW} tokens in one engine of 8 "
          f"slots: {8 * MT_NEW / mixed_s:.1f} tokens/s; each equals the "
          f"request served alone: {same}; {distinct} distinct streams")
    if not same or distinct != 3:
        fail("the mixed-adapter batch disagrees with the requests served "
             "alone")
    counts = _serving_launches(kernels, "serving-tier")  # main path ends
    print(f"serving tier on {card}: paged generate "
          f"{BATCH * NEW / gen_s:.1f} tokens/s, chunked engine median TTFT "
          f"{ttfts[len(ttfts) // 2]:.2f} ms, KV pool {held} / {worst} "
          f"bytes, prefix TTFT cold {cold_warm['cold'].ttft_ms:.2f} / warm "
          f"{cold_warm['warm'].ttft_ms:.2f} ms, fleet "
          f"{8 * MT_NEW / mixed_s:.1f} tokens/s")
    return counts


def _serving_launches(kernels, phase):
    """The launch counts of a serving phase's main path, by input types:
    the LayerNorm forwards in float32 only, and no backward kernel. Returns
    the per-kernel totals."""
    counts = kernels.launches_by_dtype()
    print(f"launches on the {phase} path, by input types: {counts}")
    for name in ("layer_norm_fwd", "add_layer_norm_fwd"):
        if set(counts[name]) != {"float32"}:
            fail(f"kernel {name}: launches {counts[name]} on the {phase} "
                 "path, expected float32 only")
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "layer_norm_bwd"):
        if counts[name]:
            fail(f"backward kernel {name} ran on the {phase} path")
    return {k: sum(v.values()) for k, v in counts.items()}


def quant_serving_phase(pt, kernels, card):
    """Quantized serving at GPT-medium width, as bench.py's
    ``_bench_decode_q8w``: ``save_quantized(model, path, "int8")``, a fresh
    model's ``load_quantized``, ``generate`` at B = 1 and 8 beside the
    float model of the same call; the int8-weight model against a float
    model that holds the widened weights. Then the int8 KV cache
    (``PADDLE_SERVE_KV_QUANT=int8``) on the int8-weight model: contiguous
    against paged ``generate``, the chunked paged engine against
    ``generate`` of its prompt, the pool's bytes against the float pool's;
    and the fp8 cache's bytes on the card against the CPU quantizer's.
    Returns the per-kernel launch counts of the phase."""
    import os
    import shutil
    from pathlib import Path

    from paddle_tpu_torch.distributed import quantized_comm as qc
    from paddle_tpu_torch.distributed import quantized_compute as qcp
    from paddle_tpu_torch.jit import DecodeStep, PrefillStep, save_quantized
    from paddle_tpu_torch.nn.functional import attention as attn
    from paddle_tpu_torch.serving import Request, paged_kv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cap = PROMPT + NEW  # a multiple of the block and the chunk

    def lm(seed):
        return pt.TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS,
                                max_position=cap, dim_feedforward=FFN,
                                seed=seed)

    model = lm(4)
    # the checkpoint goes under the checkout's git-ignored build directory
    ckpt = Path(__file__).resolve().parent / "paddle_tpu_torch" / \
        "_build" / "q_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        info = save_quantized(model, str(ckpt / "gpt_medium"), "int8")
        save_s = time.perf_counter() - t0
        qmodel = lm(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = qmodel.load_quantized(str(ckpt / "gpt_medium"))
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    payload = info["bytes_payload"] + info["bytes_scales"]
    print(f"int8 checkpoint of {len(info['quantized'])} linear weights: "
          f"saved in {save_s:.2f} s; q_ckpt_load_ms {load_ms:.1f} "
          f"(load_quantized's own load_ms {meta['load_ms']}); "
          f"q_ckpt_payload_mb {payload / 1e6:.1f}; q_ckpt_reduction_x "
          f"{4.0 * info['bytes_payload'] / payload:.2f}; wide rest "
          f"{info['bytes_wide'] / 1e6:.1f} MB")
    narrow = {n: w for n, _, w in qcp.iter_quantizable(qmodel)}
    if len(narrow) != 4 * LAYERS + 1 or any(
            w.dtype != torch.int8 for w in narrow.values()):
        fail("load_quantized left linear weights wide")
    # the float model becomes the same function in two spellings: its
    # linear weights are the widened payloads (the wide rest is already
    # equal: the checkpoint carried it)
    with torch.no_grad():
        for name, _, w in qcp.iter_quantizable(model):
            w.copy_(qcp.dequantize_weight(narrow[name],
                                          qcp.scale_of(narrow[name])))
    del narrow
    steps = {"q8w": (qmodel, PrefillStep(qmodel), DecodeStep(qmodel)),
             "float": (model, PrefillStep(model), DecodeStep(model))}
    prompts = {B: (np.arange(B * PROMPT) % 31000).reshape(
        B, PROMPT).astype(np.int32) for B in Q_BATCHES}
    for B in Q_BATCHES:  # warm the step objects (bench's pattern)
        for m, pre, dec in steps.values():
            pt.generate(m, prompts[B], 2, max_length=cap, prefill=pre,
                        decode=dec)

    kernels.reset_launches()  # the phase's main path starts here
    rates = {}
    for B in Q_BATCHES:
        for name, (m, pre, dec) in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = pt.generate(m, prompts[B], NEW, max_length=cap,
                               prefill=pre, decode=dec)
            rates[name, B] = B * NEW / (time.perf_counter() - t0)
            if toks.shape != (B, NEW) or (toks < 0).any() \
                    or (toks >= VOCAB).any():
                fail(f"{name} generate B={B} returned bad tokens")
        print(f"generate B={B} prompt={PROMPT} new={NEW}: int8 weights "
              f"{rates['q8w', B]:.1f} tokens/s "
              f"(serve_gpt_medium_tokens_per_sec_b{B}_q8w), the float "
              f"model's right after {rates['float', B]:.1f} tokens/s")
    got = {name: pt.generate(m, prompts[BATCH], NEW, max_length=cap,
                             prefill=pre, decode=dec, return_logits=True)
           for name, (m, pre, dec) in steps.items()}
    (qt, ql), (ft, fl) = got["q8w"], got["float"]
    err = float(np.abs(ql - fl).max())
    peak = float(np.abs(fl).max())
    same = bool(np.array_equal(qt, ft))
    print(f"int8 weights against the float model holding the widened "
          f"weights, B={BATCH} x {NEW}: tokens equal {same}, max|logit "
          f"err| {err:.3e} of max|logit| {peak:.3e} (tolerance "
          f"{Q_LOGIT_RTOL} of it)")
    if not same or not np.isfinite(ql).all() or err > Q_LOGIT_RTOL * peak:
        fail("the int8-weight model disagrees with its widened weights")

    qm, pre, dec = steps["q8w"]
    one = (np.arange(PROMPT) % 31000).astype(np.int32)
    need = paged_kv.blocks_for(PROMPT + TIER_ENGINE_NEW, TIER_BLOCK)
    demand = 4 * need + 1
    os.environ["PADDLE_SERVE_KV_QUANT"] = "int8"
    try:
        if not isinstance(qm.gen_cache(1, cap)[0].k, qc.QuantKV):
            fail("PADDLE_SERVE_KV_QUANT=int8 did not quantize the cache")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv8, kv8_logits = pt.generate(qm, prompts[BATCH], NEW,
                                      max_length=cap, prefill=pre,
                                      decode=dec, return_logits=True)
        kv8_s = time.perf_counter() - t0
        os.environ["PADDLE_SERVE_BLOCK_SIZE"] = str(TIER_BLOCK)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kv8_paged = pt.generate(qm, prompts[BATCH], NEW, max_length=cap,
                                    prefill=pre, decode=dec)
            kv8_paged_s = time.perf_counter() - t0
        finally:
            del os.environ["PADDLE_SERVE_BLOCK_SIZE"]
        same = bool(np.array_equal(kv8, kv8_paged))
        print(f"int8 KV generate B={BATCH}: contiguous "
              f"{BATCH * NEW / kv8_s:.1f} tokens/s, paged (block "
              f"{TIER_BLOCK}) {BATCH * NEW / kv8_paged_s:.1f} tokens/s; "
              f"tokens equal: {same}")
        if not same:
            fail("paged int8 KV generate disagrees with the contiguous one")
        eng = pt.InferenceEngine(qm, slots=4, max_length=cap,
                                 block_size=TIER_BLOCK,
                                 prefill_chunk=TIER_CHUNK,
                                 pool_blocks=demand)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(8):
            eng.submit(Request(one, max_new_tokens=TIER_ENGINE_NEW, rid=i))
        res = eng.run()
        eng_s = time.perf_counter() - t0
        alone = list(pt.generate(qm, [one], TIER_ENGINE_NEW,
                                 max_length=cap)[0])
        ttfts = sorted(r.ttft_ms for r in res.values())
        same = all(res[i].tokens == alone for i in range(8))
        caches = eng._state.caches
        tables = sum(leaf.table.numel() * leaf.table.element_size()
                     for c in caches for leaf in (c.k, c.v))
        held = paged_kv.pool_bytes(caches)
        wide = paged_kv.pool_bytes(qm.gen_cache(
            4, cap, dtype=torch.float32, block_size=TIER_BLOCK,
            pool_blocks=demand))
    finally:
        del os.environ["PADDLE_SERVE_KV_QUANT"]
    dh = D_MODEL // HEADS
    print(f"int8 KV chunked paged engine (slots 4, chunk {TIER_CHUNK}, "
          f"{demand} blocks): 8 x {TIER_ENGINE_NEW} tokens in "
          f"{eng_s * 1e3:.1f} ms, median TTFT {ttfts[4]:.2f} ms; each "
          f"request equals int8 KV generate of its prompt: {same}; KV pool "
          f"{held - tables} bytes against the float pool's {wide - tables} "
          f"({(held - tables) / (wide - tables):.4f}; {dh} int8 values and "
          f"one float32 scale per token and head: {dh + 4} / {4 * dh})")
    if not same:
        fail("the int8 KV engine disagrees with int8 KV generate")
    if (held - tables) * 4 * dh != (wide - tables) * (dh + 4):
        fail("the int8 pool's bytes are not (Dh + 4) / 4 Dh of the float "
             "pool's")
    counts = _serving_launches(kernels, "quantized serving")
    agree = float((kv8 == qt).mean())
    gap = float(np.abs(kv8_logits - ql).max())
    print(f"int8 KV against float KV (int8 weights, B={BATCH} x {NEW}): "
          f"{agree:.4f} of tokens agree, largest logit gap {gap:.3e} "
          "(reported, no limit)")

    # fp8 on the card: the quantizer's and the cache's bytes against the
    # CPU's, on K rows of this model's shape
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = torch.randn(BATCH, HEADS, SPEC_K + 1, dh, device="cuda",
                       generator=gen)
    fp8 = {}
    for dev in ("cuda", "cpu"):
        pool = paged_kv.paged_zero(BATCH, HEADS, cap, dh, block=TIER_BLOCK,
                                   quant="fp8", device=dev)
        pos = torch.arange(BATCH, dtype=torch.int32, device=dev) * 17
        pool = attn.cache_update(pool, rows.to(dev), pos)
        fp8[dev] = (qc.bits(pool.kv.q).cpu(), pool.kv.scale.cpu(),
                    paged_kv.paged_gather(pool.kv, pool.table).cpu())
    same = all(torch.equal(a, b) for a, b in zip(fp8["cuda"], fp8["cpu"]))
    print(f"fp8 KV on the card: pool bytes, scales and gathered view equal "
          f"the CPU quantizer's: {same}")
    if not same:
        fail("the fp8 cache on the card disagrees with the CPU quantizer")
    print(f"quantized serving on {card}: q8w generate "
          f"{rates['q8w', 1]:.1f} / {rates['q8w', BATCH]:.1f} tokens/s (B "
          f"1 / {BATCH}) against float {rates['float', 1]:.1f} / "
          f"{rates['float', BATCH]:.1f}; q_ckpt_load_ms {load_ms:.1f}")
    return counts


def speculative_phase(pt, kernels, card):
    """Greedy speculative decoding at GPT-medium width: the target with k
    = 4 and two drafts (a 2-layer ``TransformerLM`` at the target's width,
    its own seed; the target itself), B = 8, prompt 128, 64 new, the
    contiguous and the paged (block 16) cache, each against the plain
    greedy ``generate`` of the same call; then one round under
    ``torch.cuda.set_sync_debug_mode("error")``. Returns the per-kernel
    launch counts of the phase."""
    import os

    from paddle_tpu_torch.jit import (DecodeStep, PrefillStep,
                                      SpecDecodeState, SpeculativeDecodeStep)
    from paddle_tpu_torch.serving import sampling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cap = PROMPT + NEW + SPEC_K  # the round's headroom
    target = pt.TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS,
                              max_position=cap, dim_feedforward=FFN, seed=6)
    small = pt.TransformerLM(VOCAB, D_MODEL, HEADS, DRAFT_LAYERS,
                             max_position=cap, dim_feedforward=FFN, seed=7)
    prompts = (np.arange(BATCH * PROMPT) % 31000).reshape(BATCH, PROMPT)
    pre, dec = PrefillStep(target), DecodeStep(target)
    drafts = {f"{DRAFT_LAYERS}-layer draft": SpeculativeDecodeStep(
        target, small, k=SPEC_K),
        "self draft": SpeculativeDecodeStep(target, target, k=SPEC_K)}
    pt.generate(target, prompts, 2, max_length=cap, prefill=pre, decode=dec)
    for st in drafts.values():
        pt.generate(target, prompts, 3, max_length=cap, prefill=pre,
                    decode=st, draft_model=st.draft_model)

    kernels.reset_launches()  # the phase's main path starts here
    summary = []
    for layout in ("contiguous", "paged"):
        if layout == "paged":
            os.environ["PADDLE_SERVE_BLOCK_SIZE"] = str(TIER_BLOCK)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = pt.generate(target, prompts, NEW, max_length=cap,
                                prefill=pre, decode=dec)
            plain_rate = BATCH * NEW / (time.perf_counter() - t0)
            for name, st in drafts.items():
                n0 = st._n_steps
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                # sync_every=1: the loop stops at the round that finishes
                # the last slot, so the rounds counted are the rounds needed
                out = pt.generate(target, prompts, NEW, max_length=cap,
                                  prefill=pre, decode=st,
                                  draft_model=st.draft_model, sync_every=1)
                rate = BATCH * NEW / (time.perf_counter() - t0)
                rounds = st._n_steps - n0
                same = bool(np.array_equal(out, plain))
                print(f"speculative generate ({layout}, {name}, k={SPEC_K}) "
                      f"B={BATCH} prompt={PROMPT} new={NEW}: {rate:.1f} "
                      f"tokens/s, {rounds} rounds, "
                      f"{(NEW - 1) / rounds:.2f} tokens per slot and round; "
                      f"plain generate {plain_rate:.1f} tokens/s; tokens "
                      f"equal: {same}")
                if not same:
                    fail(f"speculative generate ({layout}, {name}) disagrees "
                         "with plain greedy generate")
                summary.append(f"{layout} {name} {rate:.1f}")
        finally:
            os.environ.pop("PADDLE_SERVE_BLOCK_SIZE", None)
    counts = _serving_launches(kernels, "speculative")

    # one round with every device-to-host read an error
    st = drafts[f"{DRAFT_LAYERS}-layer draft"]
    ids = torch.as_tensor(prompts, dtype=torch.int32)
    lens = [PROMPT] * BATCH
    last, caches, pos = pre(target.gen_cache(BATCH, cap), ids, lens)
    _, dcaches, _ = PrefillStep(small)(small.gen_cache(BATCH, cap), ids,
                                       lens)
    state = SpecDecodeState.make(caches, dcaches, sampling.greedy(last),
                                 pos, budget=NEW - 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        emit, state = st(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"one speculative round under sync debug mode 'error': emitted "
          f"{emit.shape[1]} columns, {int((emit >= 0).sum())} tokens, no "
          "host read")
    print(f"speculative decoding on {card}: " + "; ".join(summary)
          + " tokens/s")
    return counts


def _count_host_reads(fn):
    """Run ``fn``; returns (its result, the device-to-host reads it made:
    calls that bring a CUDA tensor's values to the host)."""
    names = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
             "__float__", "__index__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    count = [0]

    def wrap(real):
        def counting(self, *a, **kw):
            if self.is_cuda:
                count[0] += 1
            return real(self, *a, **kw)
        return counting

    for n, real in saved.items():
        setattr(torch.Tensor, n, wrap(real))
    try:
        out = fn()
    finally:
        for n, real in saved.items():
            setattr(torch.Tensor, n, real)
    return out, count[0]


def router_phase(pt, kernels, card):
    """The router's plane at GPT-medium width (cap 160, block 16):
    (a) the disaggregated decode tier of bench.py's
    ``_bench_serve_multitenant`` (8 mixed-adapter requests of prompt 128
    and 32 new through a ``PrefillHost`` of 2 slots and a decode
    ``LocalHost`` of 8), against a colocated engine of 8 slots on the same
    model and adapters; (b) ``drain_host`` with KV migration between two
    4-slot ``LocalHost`` engines, in float32 and under an int8 KV cache,
    against greedy ``generate``; (c) ``retire_slots(2)`` relocating the
    live top slots of a 4-slot engine; (d) (a) again with the telemetry bus
    on, against its readback windows and its host reads with the bus off.
    Returns the per-kernel launch counts of each of the phase's paths, each
    counted in a window of its own that no reference run falls in: the
    disaggregated tier (``router``), each drain, the retire and the
    telemetry run."""
    import os
    import tempfile

    from paddle_tpu_torch.distributed import quantized_comm as qc
    from paddle_tpu_torch.observability import bus
    from paddle_tpu_torch.serving import Request, kv_migration as kvm
    from paddle_tpu_torch.serving.adapters import AdapterSet
    from paddle_tpu_torch.serving.router import (LocalHost, PrefillHost,
                                                 Router)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in ("PADDLE_SERVE_KV_QUANT", "PADDLE_OBS_DIR",
              "PADDLE_OBS_BUS_FILE", "PADDLE_SERVE_MIGRATE",
              "PADDLE_SERVE_DISAGG", "PADDLE_FAULT_SPEC"):
        os.environ.pop(k, None)
    t_phase = time.perf_counter()
    model = pt.TransformerLM(VOCAB, D_MODEL, HEADS, LAYERS,
                             max_position=MT_CAP, dim_feedforward=FFN,
                             seed=8)
    adapters = AdapterSet(model, n_adapters=4, rank=8)
    adapters.load(1)
    adapters.load(2)
    prompt = (np.arange(PROMPT) % 31000).astype(np.int32)
    B = BATCH

    def engine(slots, **kw):
        return pt.InferenceEngine(model, slots=slots, max_length=MT_CAP,
                                  block_size=TIER_BLOCK, **kw)

    def drive(router, hosts, n, deadline_s=120):
        deadline = time.perf_counter() + deadline_s
        while len(router.completed) < n:
            if time.perf_counter() > deadline:
                fail(f"router: {len(router.completed)} of {n} requests "
                     f"done in {deadline_s} s")
            router.tick()
            for h in hosts:
                h.pump()

    def disagg():
        """(a): returns the router, its decode engine, the seconds, and
        the decode steps the decode engine ran."""
        dec = engine(B)
        steps = [0]
        real = dec._decode

        def counted(state):
            steps[0] += 1
            return real(state)

        dec._decode = counted
        decode, prefill = LocalHost(dec), PrefillHost(engine(2))
        router = Router([decode], prefill_hosts=[prefill],
                        admit_queue=2 * B, avg_new_tokens=MT_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(B):
            router.submit({"rid": f"d{i}", "prompt_ids": prompt.tolist(),
                           "max_new_tokens": MT_NEW, "adapter": i % 3})
        drive(router, [decode], B)
        torch.cuda.synchronize()
        return router, dec, time.perf_counter() - t0, steps[0]

    def same_as(router, ref):
        return all(router.completed[f"d{i}"]["tokens"] == ref[f"d{i}"].tokens
                   for i in range(B))

    # warm the allocator, the step objects' first calls and an adapter's
    w = engine(2)
    w.submit(Request(prompt, max_new_tokens=2, rid="w"))
    w.submit(Request(prompt, max_new_tokens=2, rid="wa", adapter=1))
    w.run()

    def colocated():
        col = engine(B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(B):
            col.submit(Request(prompt, max_new_tokens=MT_NEW, rid=f"d{i}",
                               adapter=i % 3))
        out = col.run()
        return out, time.perf_counter() - t0

    # (a) colocated, disaggregated, disaggregated, colocated: no
    # instrumentation in the timed runs, and each side runs once first
    # and once last; the launch counts are the first disaggregated run's
    paths = {}
    ref, col_s1 = colocated()
    kernels.reset_launches()  # the disaggregated path starts here
    router, dec, dis_s1, _ = disagg()
    paths["router"] = _serving_launches(kernels, "router")  # and ends here
    router2, dec2, dis_s2, _ = disagg()
    ref2, col_s2 = colocated()
    same = same_as(router, ref) and same_as(router2, ref) and all(
        ref2[f"d{i}"].tokens == ref[f"d{i}"].tokens for i in range(B))
    fallbacks = [r.disagg_fallbacks for r in (router, router2)]
    handoffs = [r.disagg_prefills for r in (router, router2)]
    dec_prefills = [d._prefill._n_steps for d in (dec, dec2)]
    dis_s, col_s = (dis_s1 + dis_s2) / 2, (col_s1 + col_s2) / 2
    print(f"disaggregated tier (PrefillHost 2 slots -> decode LocalHost "
          f"{B} slots, cap {MT_CAP}, block {TIER_BLOCK}, adapters i % 3), "
          f"tokens/s in the order run: colocated {B * MT_NEW / col_s1:.1f}, "
          f"disaggregated {B * MT_NEW / dis_s1:.1f}, disaggregated "
          f"{B * MT_NEW / dis_s2:.1f}, colocated {B * MT_NEW / col_s2:.1f}; "
          f"serve_gpt_medium_tokens_per_sec_b8_disagg {B * MT_NEW / dis_s:.1f}"
          f" against colocated {B * MT_NEW / col_s:.1f} (means of the "
          f"times, {col_s / dis_s:.3f}x); handoffs {handoffs}, fallbacks "
          f"{fallbacks}, decode-side prefills {dec_prefills}; tokens equal "
          f"colocated: {same}")
    if handoffs != [B, B] or any(fallbacks) or any(dec_prefills) \
            or not same:
        fail("the disaggregated tier fell back, prefilled on the decode "
             "side, or disagrees with the colocated engine")
    # host reads of the disaggregated run with the bus off, untimed: (d)
    # holds the bus-on run against it
    (r_off, _, _, _), reads_off = _count_host_reads(disagg)
    if not same_as(r_off, ref):
        fail("the disaggregated tier disagrees with itself across runs")

    # one handoff's parts, timed apart through the hosts' own calls (the
    # tier above runs them inline): extract = the engine's gather and
    # seal; seal again on its leaves, alone; the router's verify; insert
    parts = {"extract": [], "seal": [], "verify": [], "insert": []}
    nbytes = 0
    for rep in range(3):
        src, dst = LocalHost(engine(2)), LocalHost(engine(2))
        src.engine.submit(Request(prompt, max_new_tokens=MT_NEW, rid="h",
                                  adapter=1))
        src.engine._fill_free_slots({})  # the prefill and the first token
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = src.extract_kv("h")
        t1 = time.perf_counter()
        crcs = list(b.manifest["crcs"])
        b.seal()
        t2 = time.perf_counter()
        bad = b.verify()
        t3 = time.perf_counter()
        ok = dst.insert_kv(b)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if bad or not ok or b.manifest["crcs"] != crcs \
                or b.n_blocks != PROMPT // TIER_BLOCK:
            fail("a timed handoff did not verify or splice")
        for k, a, z in (("extract", t0, t1), ("seal", t1, t2),
                        ("verify", t2, t3), ("insert", t3, t4)):
            parts[k].append((z - a) * 1e3)
        nbytes = b.nbytes
    want = (PROMPT // TIER_BLOCK) * TIER_BLOCK * 2 * LAYERS * D_MODEL * 4
    print(f"per bundle: {nbytes} bytes (reckoned {want}: "
          f"{PROMPT // TIER_BLOCK} blocks x {TIER_BLOCK} rows x {LAYERS} "
          f"layers x K, V x {D_MODEL} x 4 B); ms over 3 handoffs: "
          + ", ".join(f"{k} " + " / ".join(f"{v:.2f}" for v in vs)
                      for k, vs in parts.items())
          + " (extract = gather + seal)")
    if nbytes != want:
        fail(f"a bundle holds {nbytes} bytes, not {want}")

    # (b) drain with migration, float32 and int8 KV
    drain_prompt = 112  # + 48 new = the cap; ctx 128 at the drain: 8 blocks
    prompts = [((np.arange(drain_prompt) + 7 * i) % 31000).astype(np.int32)
               for i in range(6)]
    drains = {}
    for quant in (None, "int8"):
        kv = quant or "float32"
        if quant:
            os.environ["PADDLE_SERVE_KV_QUANT"] = quant
        try:
            # the references, outside the counted window: greedy generate
            # of the six prompts at B = 6 and of each prompt alone (B = 1,
            # the batch of the engine's prefill)
            greedy, glog = pt.generate(model, prompts, 48,
                                       max_length=MT_CAP, return_logits=True)
            alone = [list(pt.generate(model, [p], 48,
                                      max_length=MT_CAP)[0])
                     for p in prompts]
            moved = []

            class Survivor(LocalHost):
                def insert_kv(self, bundle):
                    ok = super().insert_kv(bundle)
                    if ok:
                        moved.append(bundle)
                    return ok

            kernels.reset_launches()  # the drain's path starts here
            hosts = [LocalHost(engine(4)), Survivor(engine(4))]
            r = Router(hosts, admit_queue=16, avg_new_tokens=48,
                       drain_inplace_tokens=8)
            for i, p in enumerate(prompts):
                r.submit({"rid": f"m{i}", "prompt_ids": p.tolist(),
                          "max_new_tokens": 48})
            hosts[0].pump()  # prefill and one window on the source only
            r.tick()
            own = hosts[1].engine.queue_depth()
            t0 = time.perf_counter()
            summary = r.drain_host(0)
            drain_ms = (time.perf_counter() - t0) * 1e3
            eng1 = hosts[1].engine
            same_bytes = True
            for bnd in moved:
                slot = next(s for s, x in eng1._active.items()
                            if x.req.rid == bnd.manifest["rid"])
                got = kvm.gather_leaves(
                    eng1._state.caches,
                    eng1._slot_blocks[slot][: bnd.n_blocks])
                same_bytes &= all(
                    torch.equal(qc.bits(x), qc.bits(y))
                    for la, lb in zip(got, bnd.leaves)
                    for x, y in zip(la, lb))
            drive(r, hosts, 6)
            paths[f"router_drain_{kv}"] = _serving_launches(
                kernels, f"router drain ({kv} KV)")  # the drain's path ends
            toks = {f"m{i}": r.completed[f"m{i}"]["tokens"]
                    for i in range(6)}
            moved_rids = sorted(bnd.manifest["rid"] for bnd in moved)
            alone_eq = [toks[f"m{i}"] == alone[i] for i in range(6)]
            gen_eq = [toks[f"m{i}"] == list(greedy[i]) for i in range(6)]
            # where the drained tokens leave B = 6 generate: generate's
            # logit lead of its own token over the engine's, and its top-2
            # gap there (a near-tie says a last-bit difference flipped it)
            diverge = []
            for i in range(6):
                j = next((j for j, (a, g) in enumerate(zip(
                    toks[f"m{i}"], greedy[i])) if a != g), None)
                if j is not None:
                    lg = glog[i, j]
                    top2 = np.sort(lg)[-2:]
                    diverge.append(
                        f"m{i} at token {j}: lead "
                        f"{lg[greedy[i][j]] - lg[toks[f'm{i}'][j]]:.3e}, "
                        f"top-2 gap {top2[1] - top2[0]:.3e}, max|logit| "
                        f"{np.abs(lg).max():.3e}")
            sizes = sorted({bnd.nbytes for bnd in moved})
            drains[kv] = sizes
            print(f"drain ({kv} KV): {summary}, moved {moved_rids}, "
                  f"{r.migrations} migrations, {r.migrate_failed} failed, "
                  f"{r.migrate_bytes} bytes moved (per bundle {sizes}) in "
                  f"{drain_ms:.1f} ms; survivor prefills "
                  f"{eng1._prefill._n_steps} for its own {own} requests; "
                  f"spliced bytes equal the source's: {same_bytes}; tokens "
                  f"equal greedy generate of each prompt alone (B = 1): "
                  f"{sum(alone_eq)} of 6, at B = 6: {sum(gen_eq)} of "
                  f"6 ({'; '.join(diverge) or 'no divergence'})")
            # the gate in both KV types: greedy generate of each prompt;
            # float32 also at B = 6 (an int8 cache can turn a last-bit
            # difference between batch shapes into a quantization step,
            # so there the B = 6 comparison is reported with its margins)
            if r.migrations < 1 or r.migrate_failed \
                    or not same_bytes or eng1._prefill._n_steps != own \
                    or not all(alone_eq) \
                    or (quant is None and not all(gen_eq)):
                fail(f"drain with migration ({kv} KV) failed, re-prefilled "
                     "a moved request or disagrees with greedy generate")
        finally:
            os.environ.pop("PADDLE_SERVE_KV_QUANT", None)
    ratio = drains["int8"][0] / drains["float32"][0]
    print(f"int8 bundle / float32 bundle: {ratio} (reckoned 0.265625)")
    if ratio != 0.265625 or drains["float32"] != [want]:
        fail("the bundles' sizes are off")

    # (c) retire_slots relocates the live top slots
    with tempfile.TemporaryDirectory() as d:
        os.environ["PADDLE_OBS_BUS_FILE"] = os.path.join(d, "bus.jsonl")
        try:
            rp = [((np.arange(64) + 11 * i) % 31000).astype(np.int32)
                  for i in range(4)]
            want_t = pt.generate(model, rp, 32, max_length=MT_CAP)
            kernels.reset_launches()  # the retire path starts here
            eng = engine(4, sync_every=8)
            for i, p in enumerate(rp):
                eng.submit(Request(p, max_new_tokens=32, rid=i,
                                   trace_id=f"retire-{i}"))
            res = {}
            eng.turn(res)
            eng.cancel(0)
            eng.cancel(1)
            before = {s: x.req.rid for s, x in eng._active.items()}
            still = eng.retire_slots(2)
            after = {x.req.rid: s for s, x in eng._active.items()}
            res.update(eng.run())
            paths["router_retire"] = _serving_launches(
                kernels, "router retire")  # the retire path ends here
            spans = [x["payload"] for x in bus.read_stream(
                os.environ["PADDLE_OBS_BUS_FILE"])
                if x["kind"] == "span"
                and x["payload"]["name"] == "kv_relocate"]
        finally:
            os.environ.pop("PADDLE_OBS_BUS_FILE")
    # the pool gives up the free top of its id space at once, the rest as
    # traffic frees it
    tables = {int(c.k.table.shape[0]) for c in eng._state.caches}
    ok = (before == {2: 2, 3: 3} and still == [] and eng.slots == 2
          and tuple(eng._state.pos.shape) == (2,) and tables == {2}
          and eng._pool.total < 4 * (MT_CAP // TIER_BLOCK)
          and sorted(after) == [2, 3] and max(after.values()) < 2
          and len(spans) == 2
          and all(res[i].tokens == list(want_t[i]) for i in (2, 3)))
    print(f"retire_slots(2) on 4 slots: relocated {before} -> "
          f"{ {r: s for r, s in after.items()} }, {len(spans)} kv_relocate "
          f"spans, {eng.slots} slots and {eng._pool.total} of "
          f"{4 * (MT_CAP // TIER_BLOCK)} blocks left; "
          f"tokens equal greedy generate: {ok}")
    if not ok:
        fail("retire_slots did not relocate and shrink, or changed tokens")

    # (d) (a) with the telemetry bus on
    with tempfile.TemporaryDirectory() as d:
        os.environ["PADDLE_OBS_DIR"] = d
        try:
            kernels.reset_launches()  # the telemetry run starts here
            (r2, dec2, _, steps2), reads_on = _count_host_reads(disagg)
            paths["router_telemetry"] = _serving_launches(
                kernels, "router telemetry")  # and ends here
            rows = bus.read_stream(os.path.join(d, "telemetry.rank0.jsonl"))
        finally:
            os.environ.pop("PADDLE_OBS_DIR")
    dm = [x["payload"] for x in rows if x["kind"] == "decode_metrics"]
    dr = [x for x in rows if x["kind"] == "decode_request"]
    windows = steps2 // dec2.sync_every
    same2 = same_as(r2, ref)
    print(f"telemetry on (a): {len(dm)} decode_metrics rows for {windows} "
          f"readback windows ({steps2} decode steps), {len(dr)} "
          f"decode_request rows for {B} requests, {len(rows)} rows in all; "
          f"host reads {reads_on} with the bus on, {reads_off} off; tokens "
          f"equal: {same2}")
    if len(dm) != windows or len(dr) != B or reads_on != reads_off \
            or not same2 or sum(p["steps"] for p in dm) != steps2:
        fail("decode telemetry does not follow the readback windows or "
             "adds host reads")
    print(f"router plane on {card}: disagg "
          f"{B * MT_NEW / dis_s:.1f} / colocated {B * MT_NEW / col_s:.1f} "
          f"tokens/s, bundle {nbytes} bytes (extract "
          f"{min(parts['extract']):.2f}, seal {min(parts['seal']):.2f}, "
          f"verify {min(parts['verify']):.2f}, insert "
          f"{min(parts['insert']):.2f} ms), drain migrations in float32 and "
          f"int8 KV, retire relocation, telemetry rows; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths


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
    t_start = t0 = time.perf_counter()
    libs = _build.build(kernels.SOURCES)
    print(f"built {', '.join(kernels.SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for src in kernels.SOURCES:
        fn = spill = ""
        for line in _build.build_log(src).splitlines():
            if "Function properties for" in line:
                fn = line.rsplit(" ", 1)[1]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                print(f"  {src}: {fn}: {line.split(':', 1)[1].strip()}; "
                      f"{spill}")
    hmma = tensor_core_counts(_build, libs)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    flash = flash_phase(fa, gen, rows)
    ln_entry, add_entry = ln_phase(ln, gen, rows)
    dq_entry, dkv_entry = flash_bwd_phase(fa, gen, rows)
    ln_bwd_entry = ln_bwd_phase(ln, gen, rows)
    for r in rows:
        print(r)
    print(f"kernel checks done at {time.perf_counter() - t_start:.1f} s")
    serving = serving_phase(pt, kernels)
    print(f"serving phase done at {time.perf_counter() - t_start:.1f} s")
    tier = serving_tier_phase(pt, kernels, card)
    print(f"serving tier phase done at {time.perf_counter() - t_start:.1f} "
          "s")
    quant = quant_serving_phase(pt, kernels, card)
    print(f"quantized serving phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    spec = speculative_phase(pt, kernels, card)
    print(f"speculative decoding phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    routed = router_phase(pt, kernels, card)
    print(f"router phase done at {time.perf_counter() - t_start:.1f} s")
    training = training_phase(pt, kernels)
    print(f"training phase done at {time.perf_counter() - t_start:.1f} s")
    amp_training = amp_training_phase(pt, kernels)
    print(f"AMP training phase done at {time.perf_counter() - t_start:.1f} "
          "s")
    fp16_training = amp_training_phase(pt, kernels, "float16")
    print(f"float16 AMP training phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    wide_block = wide_block_phase(pt, kernels)
    print(f"head dim {WIDE_D} block phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    programs = bench_programs_phase(pt, kernels)
    print(f"bench programs phase done at {time.perf_counter() - t_start:.1f} "
          "s")
    entries = [flash, ln_entry, add_entry, dq_entry, dkv_entry, ln_bwd_entry]
    for e in entries:
        if hmma is not None and e["name"] in hmma:
            e["hmma"] = hmma[e["name"]]
        e["launches"] = amp_training[e["name"]]
        e["launches_by_path"] = {
            "serving": serving[e["name"]],
            "serving_tier": tier[e["name"]],
            "quant_serving": quant[e["name"]],
            "speculative": spec[e["name"]],
            **{k: v[e["name"]] for k, v in routed.items()},
            "training": training[e["name"]],
            "amp_training": amp_training[e["name"]],
            "fp16_amp_training": fp16_training[e["name"]],
            **{f"head_dim_{WIDE_D}_{k}": sum(v[e["name"]].values())
               for k, v in wide_block.items()},
            **{k: sum(v[e["name"]].values()) for k, v in programs.items()}}
    print(f"{card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
