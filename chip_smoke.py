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
   the head-dim-256 block's shape); the row LayerNorm forward (B5) also
   with its inputs out of L2, beside its time before its redesign,
   asserting which path each shape takes (its register path at every
   shape above, its looped path at D = 200 and on rows one element into
   their buffer) and that no instantiation of its register path spills;
3. serves the GPT-medium-shaped ``TransformerLM`` (vocab 32000, d_model
   1024, 16 heads, ffn 4096, float32, random weights from a seeded
   generator; 2 of its 24 layers in steps 3-7, a depth cut,
   ``SERVE_LAYERS``) through ``generate`` and ``InferenceEngine``, checks
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
9. trains bench.py's GPT-medium program as published (its
   ``_gpt_medium`` and ``_bench_gpt``'s loss, copied below as bench.py
   writes them with their import lines pointed at the port: no final
   LayerNorm, ``strategy.amp`` through ``fleet``, bf16 AMP O1,
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
13. runs that program as written in a Paddle eager loop (``set_device``,
   ``seed``, ``to_tensor``, ``loss.backward()``, ``opt.step()``,
   ``opt.clear_grad()``; float32, three steps) against three
   ``jit.TrainStep`` calls of the same model class from the same weights:
   the losses, the first step's gradients and each kernel's float32
   launches per step must agree (eager and TrainStep ms/step, peak
   memory);
14. its ``translation_phase``: Transformer-base (``nn.Transformer`` at
   its defaults: d_model 512, 8 heads, 6 + 6 layers, ffn 2048, dropout
   0.1, post-LN; a shared 37000-token embedding, padding id 0, scaled by
   sqrt(512), sinusoidal positions, the output projection tied to it) as
   a Paddle translation script writes it, float32: a gradient oracle
   against the dense LayerNorm at dropout 0, five Adam steps (NoamDecay)
   of ``CrossEntropyLoss(soft_label=True)`` over ``label_smooth(
   one_hot(.))`` on 32 x 128 source and target tokens (losses finite and
   falling, B5 and B7 30 launches a step, nothing else), then greedy
   decoding of 8 sources for 32 tokens through the decoder's incremental
   cache (B5 12 + 18 a token) against a full teacher-forced forward
   (ms/step, target tokens/s, peak memory, decode tokens/s); B5 and B7
   are also held at its [4096, 512] rows in step 2;
15. its ``rnn_lm_phase``: the PTB "medium" LSTM language model (Zaremba
   et al. 2014; vocabulary 10000, 650 wide, 2 layers, dropout 0.5,
   uniform init 0.05, batch 20 x 35 steps, SGD 1.0 under global-norm clip
   5) as Paddle's language_model script writes it, float32: its first step
   (dropout off) against the port's CPU step in float64 (loss and every
   gradient within 1e-4 of the largest), then six eager steps with the
   state carried and detached (losses falling, no kernel of the port
   launched; ms/step, tokens/s, peak memory);
16. its ``blockwise_bert_phase``: bench.py's BERT-base with its encoder on
   ``attn_impl="blockwise"`` (block 128), trained with ``Lamb(1e-3,
   0.01)`` through fleet bf16 O1 and ``TrainStep``: gradient oracles,
   each route against a float64 copy (the blockwise route within the
   dense twin's distance + 1e-3 in float32, + 2e-2 under bf16 O1), six
   steps (losses falling;
   B1, B3, B4 twelve launches a step in bf16, not causal, and B5, B7 24
   each; the torch blockwise program never runs), and the twin's six
   steps beside them (ms/step, samples/s, peak memory). Step 2 holds B1,
   B3 and B4 at that shape, [32, 12, 128, 64] bf16 not causal, too;
17. its ``mnist_fit_phase``: tests/reference_scripts/hapi_mnist_fit.py's
   program (``paddle.Model(LeNet())``, Adam 1e-3, ``Accuracy``) on MNIST
   IDX files it writes under a temporary PADDLE_DATASET_HOME, through
   ``vision.datasets.MNIST``, ``fit`` (2 epochs, batch 64, 8 steps) and
   ``evaluate``: the loss must fall and ``evaluate`` report an accuracy;
18. its ``model_fit_phase``: ResNet-50 trained by ``Model.fit`` from a
   DataLoader of 8 spawned workers (ImageNet-shaped uint8 images made per
   index, RandomResizedCrop(224) and a flip, the native fused uint8 ->
   float32 collation, /dev/shm, one pinned copy to the card a batch),
   Momentum with L2Decay, ``Accuracy(topk=(1, 5))``, float32, one epoch
   of 8 batches of 256 with ``ModelCheckpoint``: the first step equal to
   ``TrainStep``'s bit for bit, ``evaluate`` equal to ``predict``'s
   outputs, a checkpoint that resumes bit for bit and keeps its crc32,
   the staging library used for every batch; imgs/s through the loader
   beside a batch already on the card, the wait on the loader and the
   host-to-device copy per batch, ``Model.save``'s time, peak memory;
19. its ``reference_scripts_phase``: the four scripts of
   tests/reference_scripts/ verbatim, each through ``python -m
   paddle_tpu_torch.run`` in a subprocess of its own on the card (the four
   at once), on MNIST IDX files and a UCI housing file it writes under a
   temporary PADDLE_DATASET_HOME, at tests/test_reference_scripts.py's
   caps: each must exit 0 with a falling loss (that harness's pattern),
   and the launcher's exit line must name a CUDA device with peak memory
   above 0, no ``jax`` or ``paddle_tpu`` module loaded and no kernel
   launched (LeNet and the linear model reach no kernel of the port);
20. its ``static_bert_phase``: bench.py's BERT-base (vocab 30522, d 768,
   12 heads, 12 layers, ffn 3072, batch 32 x 128, AdamW 1e-4 / 0.01),
   float32 with TF32 off, as a static program (``enable_static``, fixed
   [32, 128] int64 ``static.data``, ``opt.minimize``, ``Executor.run`` of
   the startup program, then six runs of the main one) beside an eager
   twin on the same weights and batch: the first run's loss within 1e-6
   of the eager step's, whatever the parameters read, and every parameter
   after it equal to the eager step's (bit for bit, or within 1e-6 of
   each parameter's largest value, the reading printed), the
   losses falling, B5 and B7 as many launches a run as in the eager step
   and no other kernel; ms per run (mean of runs 2-6) beside the eager
   ms per step (a static run and an eager step in turns), peak memory;
21. its ``to_static_phase``: bench.py's GPT-medium program as the dygraph
   phase builds it (float32, TF32 off, AdamW 1e-4 / 0.01, B = 4, S =
   1024) under ``paddle.jit.to_static`` (a ``torch.export`` capture run on
   the live weights) for three steps beside an eager twin on the same
   weights and ids, in turns: each loss within 1e-5, every first-step
   gradient within 1e-5 of its largest value, the dygraph step's launches
   of all six kernels a step, one cached program; then one step of the
   twin with each of its 24 blocks under ``paddle.jit.recompute`` against
   its plain step (gradients within 1e-5, the forward kernels twice a
   block, a lower peak); ms/step of each, capture seconds, peak memory;
22. its ``jit_save_phase``: the same program with its head applied (ids ->
   logits) in ``eval()``, 2 of its 24 blocks (a depth cut,
   ``SAVE_LAYERS``), saved by ``paddle.jit.save`` at ``InputSpec([8,
   128], "int64")`` and served from a process of its own that imports
   the port and neither this script nor any module defining the model,
   through ``paddle.jit.load`` and ``paddle.inference`` (``Config``,
   ``copy_from_cpu`` / ``run`` / ``copy_to_cpu``): the logits bit-equal
   to the eager forward's, or within 1e-5 of the largest, the eager
   forward's launches, no ``jax``, ``paddle_tpu`` or model source loaded;
   save, load and forward ms, the artifact's bytes;
23. its ``guarded_training_phase``: bench.py's GPT-medium program at its
   full width and 2 of its 24 blocks (a depth cut, ``GUARD_LAYERS``;
   float32, TF32 off, AdamW 1e-4 / 0.01, B = 4, S = 1024) through
   ``TrainStep``
   under the numerical guard and ``train_epoch_range``: guard on against
   guard off from the same weights (losses and parameters bit-equal, the
   same launches), a trace window of the guarded steps (no pageable
   device-to-host copy, one pinned guard copy every
   ``PADDLE_GUARD_SYNC_EVERY`` steps, the six kernels and the
   ``TrainStep::guard`` span), ``step_metrics`` rows with the step's MFU;
   ``grad:nan:3:2`` skipped bit for bit; a child process of this script
   (``--acp-child``) preempted by SIGTERM mid-epoch (exit 143) and a
   second that resumes, ending bit for bit where an uninterrupted run
   ends; a poisoned streak past ``PADDLE_GUARD_MAX_SKIPS`` rolled back to
   the newest generation; a flipped byte in it falling back to the one
   before; generation bytes, save and restore seconds (the checkpoints
   in a temporary directory, removed after);
24. its ``detection_phase``: YOLOv3's head at PaddleDetection's COCO sizes
   (the port's ResNet-50 C3-C5 through 1 x 1 convolutions, 608 x 608,
   batch 8, 80 classes) trains five Momentum steps of ``yolo_loss`` (the
   loss must fall); its untrained heads' 22,743 boxes go through
   ``yolo_box`` and ``multiclass_nms``; the other detection ops run at SSD300 (8,732
   priors) or Faster R-CNN (512 RoIs on a 1024-channel stride-16 map of
   800 x 1333) sizes; each result on the card equals the port's CPU
   result on the same tensors within 1e-4 (NMS's kept rows equal but at
   score ties, reported); step and NMS ms;
25. its ``multichip_gpt_phase``: bench.py's ``_bench_gpt_multichip``
   program (GPT-medium at full width and 2 of its 24 blocks, a depth cut,
   ``MC_LAYERS``; fleet dp2 x mp2, global batch 8) as a world of 4 ranks
   of this script (``--rank-child``)
   started by ``paddle_tpu_torch.distributed.launch``, all on this card
   over gloo (the backend rule for ranks that share a card): float32
   against the same program in one process (each loss within 1e-5, every
   first-step gradient gathered to full within 1e-5 of its largest, the
   attention kernels at [4, 8, 1024, 64], ``MC_LAYERS`` a step), one step under
   ``PADDLE_FLASH_SHARD=0`` (no kernel, the same loss), and the bf16 AMP
   program as bench writes it (ms/step, global tokens/s, collective ms by
   op and transport, peak memory by rank: 4 ranks sharing one H100);
26. its ``sp_pp_ep_phase``: sequence, pipeline and expert parallelism as
   one world of 4 ranks of this script (``--sp-child``) on this card over
   gloo: GPT-medium-shaped at sp4 on ``ring_pallas`` (S 8192, 2048 a
   rank) against one process on ``blockwise`` (losses within 1e-5, first-
   step gradients within 1e-4, rank r launching B1/B3/B4 ``SP_LAYERS`` (r +
   1) times a step), a bf16 Ulysses step against a bf16 ring step; bench's
   GPT-medium as a ``PipelineLayer`` at pp2 x mp2 (1F1B over 4
   microbatches; F-then-B's loss = 1F1B's) against one process's
   ``TrainStep``; ``ExpertParallelMoE`` at ep4 against one process's;
   both models at full width and ``SP_LAYERS`` (2) of 24 blocks, a depth
   cut; before the world, step 2 also holds ``flash_attention_partial``
   (B1; B3/B4 with the lse cotangent) against its plain version at the
   ring's [1, 16, 2048, 64], and B1/B3/B4 at the ring's and Ulysses'
   shapes;
27. its ``q8m_phase``: bench.py's ``_bench_gpt_q8m`` (GPT-medium, B = 4,
   S = 1024, ``strategy.quantized_moments = "int8"``): three float32
   AdamW steps against the same steps with wide moments (losses within
   ``Q8M_LOSS_RTOL``; the resident moment bytes counted from the
   optimizer's accumulators equal ``moment_bytes_info``'s, ~3.9x below
   float32), then the program as bench writes it (bf16 AMP, int8 then
   wide moments: ms/step, tokens/s, peak memory, launches), then one
   float32 step under ``strategy.quantized_matmul = "int8"`` at 4 blocks
   (loss within ``QAT_LOSS_RTOL`` of the dense loss, float32 weight
   gradients);
28. its ``dp_q8_phase``: bench.py's ``_bench_gpt_dp_q8`` (GPT-medium at full
   width and ``DPQ8_LAYERS`` of 24 blocks, a depth cut; dp4 = dcn2 x ici2,
   ``async_dcn_allreduce``, global batch 16) as a world of 4 ranks of this
   script (``--dpq8-child``) over gloo: float32 with the policy off
   (first-step gradients within 1e-5 of one process's), float32 int8
   (first-step gradients against the oracle of each dcn group's mean
   gradient through ``quantize_dequantize``, averaged; losses within rtol
   2e-2 / atol 1e-3 of the policy-off run's), bench's bf16 program int8
   and off (ms/step, global tokens/s, collective host ms and bytes by op,
   group and transport: the dcn hop's bytes >= 3.5x fewer under int8, the
   ici hop's the same);
29. its ``strategy_phase``: the strategy's optimizer options at
   GPT-medium's full width and ``STRAT_LAYERS`` (2) of 24 blocks, a depth
   cut, as one world of 8 ranks of this script (``--strat-child``) over
   gloo: ``__graft_entry__.py``'s dp2 x pp2 x mp2 with ZeRO-1 and gradient
   merge k 2 against one process's merged Adam step (losses and
   parameters within 1e-6, Adam's first moment within 1e-5 of the merged
   gradient's; moment bytes half the stage's); dp4 x mp2 with Lamb,
   ZeRO-3, the overlap rings and recompute against the same world with
   those three off (losses, parameters and Lamb's first moment within
   1e-5; a quarter of the mp shard's parameter bytes a rank between
   steps; B1, B5 and B6 twice a block a step); LocalSGD at dp8 (k 1 =
   ``DataParallel`` SGD within 1e-6; with k 2 the ranks differ after step
   1 and are equal bit for bit after step 2);
30. prints one ``{"kernels": [...]}`` line (the seven kernels' entries and
   the partial op's) and, last, the ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, without a CUDA device, outside a
checkout of the repository, or when any check fails.
"""
from __future__ import annotations

import json
import math
import os
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

# the serving paths (serving, the tier, quantized, speculative, the router
# plane) run GPT-medium at its full width and SERVE_LAYERS of its 24 layers:
# a depth cut that makes room for the world phases (named in PERF.md;
# CHIP_SMOKE_SERVE_LAYERS sets another depth)
SERVE_LAYERS = int(os.environ.get("CHIP_SMOKE_SERVE_LAYERS", "2"))

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


# bench.py's GPT-medium program as written (_gpt_medium, _bench_gpt's loss),
# float32, in a Paddle eager loop against TrainStep from the same weights:
# the same kernels in the same order, so the losses and gradients agree to
# float32 rounding (DYGRAPH_*_RTOL; the gradient relative to each leaf's
# largest value)
DYGRAPH_STEPS = 3
DYGRAPH_LOSS_RTOL = 1e-5
DYGRAPH_GRAD_RTOL = 1e-5
#: launches of each kernel per eager step, float32 (24 layers, no ln_f)
DYGRAPH_LAUNCHES = {
    name: {"float32": n} for name, n in (
        ("flash_attention_fwd", LAYERS), ("flash_attention_bwd_dq", LAYERS),
        ("flash_attention_bwd_dkv", LAYERS), ("layer_norm_fwd", LAYERS),
        ("add_layer_norm_fwd", LAYERS), ("layer_norm_bwd", 2 * LAYERS))}


# bench.py's _bench_gpt_multichip program (GPT-medium, fleet dp x mp2,
# global batch 4 * dp) as a world of 4 ranks of this script
# (--rank-child) on the one card, over gloo: every rank's tensors and
# kernels are on cuda:0, and the speeds are those of 4 ranks sharing one
# H100 over gloo, which say nothing of NCCL across cards
MC_DP, MC_MP = 2, 2
# the world's GPT keeps bench's width and MC_LAYERS (2) of its 24 blocks: a
# depth cut that makes room for the later world phases (named in PERF.md;
# CHIP_SMOKE_MC_LAYERS sets another depth, which the --rank-child
# processes inherit)
MC_LAYERS = int(os.environ.get("CHIP_SMOKE_MC_LAYERS", "2"))
MC_WORLD = MC_DP * MC_MP
MC_BATCH = 4 * MC_DP
MC_STEPS = 3
# float32, TF32 off: each step's dp-mean loss within MC_LOSS_RTOL of the
# one-process step on the global batch, every first-step gradient
# (gathered to full) within MC_GRAD_RTOL of its largest value (the row-
# parallel all-reduce adds two partial products where one process sums
# one contraction, and the dp mean averages two local means: float32
# rounding, about 1e-7 relative)
MC_LOSS_RTOL = 1e-5
MC_GRAD_RTOL = 1e-5
#: a world still running after this many seconds is killed and fails
MC_DEADLINE_S = 480
#: the attention kernels' shape on each rank: [B/dp, H/mp, S, D]
MC_RANK_SHAPE = (MC_BATCH // MC_DP, HEADS // MC_MP, TRAIN_S,
                 D_MODEL // HEADS)
MC_RANK_ROW = "per rank dp2 x mp2 S=1024"

# sequence, pipeline and expert parallelism: one world of 4 ranks of this
# script (--sp-child) on the one card over gloo, in three parts:
# (a) sp4: a GPT-medium-shaped causal decoder (24 TransformerEncoderLayer
#     1024 / 16 / 4096 on attn_impl="ring_pallas", a 32k head), batch 1 x
#     seq 8192 (2048 a rank), float32, against one process on "blockwise"
#     (B1-B4 at S 8192); one bf16 step on "ulysses" against one on
#     "ring_pallas";
# (b) pp2 x mp2: bench.py's _gpt_medium as a PipelineLayer (embedding, 24
#     ParallelGPTBlock, head), accumulate_steps 4, 1F1B, batch 8 x 1024,
#     float32, against one process's TrainStep;
# (c) ep4: ExpertParallelMoE(1024, 4096, 8 experts) over mp4, x [4, 1024,
#     1024] float32, against one process's layer.
SP_WORLD = 4
SP_SEQ = 8192
SP_STEPS = 3
# the sp decoder and the pipeline's GPT keep bench's width and SP_LAYERS
# (2) of its 24 blocks: a depth cut that makes room for the later phases
# (named in PERF.md; CHIP_SMOKE_SP_LAYERS sets another even depth, which
# the --sp-child processes inherit)
SP_LAYERS = int(os.environ.get("CHIP_SMOKE_SP_LAYERS", "2"))
# float32, TF32 off: the ring merges 1-4 partials where the one-process
# run's flash kernel sums one row; each loss within SP_LOSS_RTOL, each
# first-step gradient within SP_GRAD_RTOL of its largest value
SP_LOSS_RTOL = 1e-5
SP_GRAD_RTOL = 1e-4
# one bf16 AMP O1 step, Ulysses against the ring: both round q, k, v and
# the products to bf16 in other places (2e-2 is ~5 bf16 ulps)
SP_ULYSSES_RTOL = 2e-2
#: the attention kernels' shapes on a rank: the ring's shard and Ulysses'
#: head shard over the whole sequence
SP_RING_SHAPE = (1, HEADS, SP_SEQ // SP_WORLD, D_MODEL // HEADS)
SP_ULYSSES_SHAPE = (1, HEADS // SP_WORLD, SP_SEQ, D_MODEL // HEADS)
SP_RING_ROW, SP_ULYSSES_ROW = "ring shard S=2048", "Ulysses S=8192"
#: the flash kernels' checks and timings at those shapes: the ring's
#: diagonal shard (causal) and an earlier rank's (not causal), Ulysses'
SP_ROWS = (f"{SP_RING_ROW} diagonal", f"{SP_RING_ROW} full", SP_ULYSSES_ROW)
SP_CASES = [(*SP_RING_SHAPE[:3], SP_RING_SHAPE[2], SP_RING_SHAPE[3], True,
             0, 0, SP_ROWS[0]),
            (*SP_RING_SHAPE[:3], SP_RING_SHAPE[2], SP_RING_SHAPE[3], False,
             0, 0, SP_ROWS[1]),
            (*SP_ULYSSES_SHAPE[:3], SP_ULYSSES_SHAPE[2],
             SP_ULYSSES_SHAPE[3], True, 0, 0, SP_ROWS[2])]
PP_MICRO, PP_BATCH, PP_STEPS = 4, 8, 3
# the one-F-then-B step's loss against 1F1B's: the same products in
# another order of microbatches
PP_SCHEDULE_RTOL = 1e-6
EP_EXPERTS, EP_HIDDEN, EP_X = 8, 4096, (4, 1024, 1024)
EP_AUX_W = 0.01
EP_RTOL = 1e-5
#: a world still running after this many seconds is killed and fails
SP_DEADLINE_S = 600


# bench.py's _bench_gpt_q8m (GPT-medium, B = 4, S = 1024, int8 Adam moments)
Q8M_STEPS = 3
# (a) float32, int8 moments against wide ones from the same weights: steps
# 1 and 2 see the same weights in both runs (step 1's update reads moments
# that are still wide: they are narrowed after it), so their losses agree
# to float32 rounding (1e-6). Step 3's weights took one update from narrow
# moments: each moment element within half a step (1/254 of its row
# block's largest) of the wide one, which moves each weight's Adam update
# (about lr = 1e-4 a weight) by a fraction of itself; the loss then moves
# by a fraction of what a whole step moves it (~0.1 at loss ~10.4):
# Q8M_LOSS_RTOL = 1e-3 relative
Q8M_EXACT_RTOL = 1e-6
Q8M_LOSS_RTOL = 1e-3
# one float32 step under strategy.quantized_matmul = "int8" at QAT_LAYERS
# blocks: the forward multiplies by weights within half an int8 step
# (1/254 of each 128-row block's largest) of the dense ones, so the loss
# stays within QAT_LOSS_RTOL = 1e-2 of the dense loss, and each weight
# gradient within the reference's own QAT_GRAD_RTOL = 5e-2 of its largest
# dense value (tests/test_quantized_compute.py's bound), full width
QAT_LAYERS = 4
QAT_LOSS_RTOL = 1e-2
QAT_GRAD_RTOL = 5e-2

# bench.py's _bench_gpt_dp_q8 (hierarchical dp, async dcn hop, int8) as a
# world of 4 ranks of this script (--dpq8-child) on the one card over
# gloo: dp4 = dcn2 x ici2, 4 rows a rank (global B = 16, S = 1024); the
# GPT keeps bench's width and DPQ8_LAYERS (2) of its 24 blocks, a depth
# cut that makes room for the strategy phase (named in PERF.md;
# CHIP_SMOKE_DPQ8_LAYERS sets another depth, which the --dpq8-child
# processes inherit); each gradient's size is that of the full model's,
# so the hop's per-gradient traffic is real
DPQ8_LAYERS = int(os.environ.get("CHIP_SMOKE_DPQ8_LAYERS", "2"))
DPQ8_WORLD, DPQ8_ICI = 4, 2
DPQ8_BATCH = 4 * DPQ8_WORLD
DPQ8_STEPS = 3
# (b) the int8 hop's first-step gradients against the oracle (each dcn
# group's mean gradient through quantize_dequantize, averaged): a code on a
# rounding boundary of the world's ici mean and the one process's group
# mean (float32 sums in another order) may land one int8 step apart in
# either group, so the average may be off by up to one step of the
# element's block: per element, |got - oracle| <= (the larger of the two
# groups' scales of its 128-block, max|block| / 127) + DPQ8_ORACLE_RTOL *
# max|oracle|; and the gradients must not be the full-width ones (some
# parameter off them by more than MC_GRAD_RTOL of its largest value)
DPQ8_ORACLE_RTOL = 1e-5
# (c) the int8 run's losses against the policy-off run's: the bounds of the
# reference's TestHierarchicalQuantized
DPQ8_LOSS_RTOL, DPQ8_LOSS_ATOL = 2e-2, 1e-3
#: the int8 dcn hop's bytes must be at least this many times fewer
DPQ8_BYTES_X = 3.5
#: a world still running after this many seconds is killed and fails
DPQ8_DEADLINE_S = 480
#: the attention kernels' shape on each rank: [B/dp, H, S, D]
DPQ8_RANK_SHAPE = (DPQ8_BATCH // DPQ8_WORLD, HEADS, TRAIN_S,
                   D_MODEL // HEADS)


# the strategy's optimizer options as one world of 8 ranks of this script
# (--strat-child) on the one card over gloo: bench's GPT-medium at its full
# width and STRAT_LAYERS of its 24 blocks, a depth cut (named in PERF.md;
# CHIP_SMOKE_STRAT_LAYERS sets another even depth, which the --strat-child
# processes inherit); global batch 8 x 1024
STRAT_LAYERS = int(os.environ.get("CHIP_SMOKE_STRAT_LAYERS", "2"))
STRAT_WORLD, STRAT_BATCH, STRAT_STEPS = 8, 8, 2
STRAT_LR, STRAT_SGD_LR = 1e-4, 1e-2
#: (a) losses and parameters against one process's merged update; (b) the
#: options on against off; (c) LocalSGD k 1 against DataParallel SGD: the
#: largest |got - want| over each parameter's largest |want| (phase notes)
STRAT_A_RTOL, STRAT_B_RTOL, STRAT_C_RTOL = 1e-6, 1e-5, 1e-6
#: a world still running after this many seconds is killed and fails
STRAT_DEADLINE_S = 480
#: (d) the elastic reshard: a global batch of 24 x 1024 (8 and 6 divide
#: it) over 4 Adam steps, ranks 6 and 7 out for steps 2 and 3; losses
#: within STRAT_D_RTOL of one process's uninterrupted run
STRAT_D_BATCH, STRAT_D_STEPS, STRAT_D_OUT = 24, 4, (6, 7)
STRAT_D_RTOL = 1e-6


# B5 (layer_norm_fwd) before its redesign, float32 ms by shape: this
# script's reading, on an H100 80GB HBM3 at 700 W, of the one-block-per-row
# kernel that the one-warp-per-row kernel replaced (PERF.md, "earlier ms").
# Printed beside this run's times, never in the kernels line: not measured
# in this run.
B5_EARLIER_MS = {"[4096,1024]": 0.0133, "[1024,1024]": 0.0045,
                 "[8,1024]": 0.0027, "[40,1024]": 0.0027,
                 "[32,1024]": 0.0027, "[4096,768]": 0.0138}


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

# BERT-base on blockwise attention: bench.py's _bert_base with its encoder
# layers built with attn_impl="blockwise" and block 128 (one key block a row
# at S = 128, so B1/B3/B4 run not causal at [32, 12, 128, 64]), trained with
# LAMB (You et al. 2019, arXiv:1904.00962, BERT's pretraining optimizer) at
# 1e-3 and weight decay 0.01 through fleet bf16 O1 and TrainStep; its twin on
# the dense route (the same weights) and a float64 copy are the gradient
# oracles, and the twin's rate is printed beside its own
BERT_BLOCK = 128
BERT_BLOCKWISE_ROW = "BERT not causal S=128"
#: launches per step on the dense BERT route: its two LayerNorms a layer on
#: the float32 residual sums ([4096, 768]), B5 forward and B7 backward
BERT_LN_LAUNCHES = {"layer_norm_fwd": {"float32": 2 * BERT_LAYERS},
                    "layer_norm_bwd": {"float32": 2 * BERT_LAYERS}}
#: on the blockwise route the attention adds B1, B3 and B4 once a layer,
#: in bf16 (q, k and v come from bf16 products under O1)
BLOCKWISE_BERT_LAUNCHES = {
    **{k: {"bfloat16": BERT_LAYERS} for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}, **BERT_LN_LAUNCHES}

# the PTB "medium" LSTM language model (Zaremba, Sutskever & Vinyals 2014,
# "Recurrent Neural Network Regularization", section 4.1; PaddlePaddle's
# models/language_model "medium"): vocabulary 10000, 650 wide, 2 layers,
# dropout 0.5 on the non-recurrent connections, uniform init +-0.05, batch
# 20 x 35 unrolled steps with the state carried and detached, SGD at 1.0
# under ClipGradByGlobalNorm(5.0), float32, six eager steps. Token ids are
# drawn from a Zipf distribution over the vocabulary (PTB's unigram counts
# fall about so), from a seed: no dataset is read. No kernel of the port
# runs on it: its check is the port's CPU run of the same first step in
# float64, dropout off, loss and every gradient within PTB_RTOL of the
# largest
PTB_VOCAB, PTB_D, PTB_LAYERS = 10000, 650, 2
PTB_B, PTB_T, PTB_STEPS = 20, 35, 6
PTB_DROPOUT, PTB_INIT, PTB_LR, PTB_CLIP = 0.5, 0.05, 1.0, 5.0
PTB_RTOL = 1e-4

# Transformer-base translation (Vaswani et al. 2017, Table 3 "base", the
# defaults of nn.Transformer) in the shape of Paddle's machine-translation
# example: the shared 37000-token BPE vocabulary of WMT14 en-de (the paper's
# section 5.1), B = 32 sentences of 128 source and 128 target tokens, five
# eager Adam steps (beta2 0.98, epsilon 1e-9) under NoamDecay(512, 4000) at
# the example's scale 2.0, then greedy decoding of 8 sources for 32 tokens
TB_VOCAB, TB_D, TB_B, TB_S, TB_STEPS = 37000, 512, 32, 128, 5
TB_DECODE_B, TB_DECODE_NEW = 8, 32
TB_LAYERS = 6
#: launches per training step (2 LayerNorms an encoder layer, 3 a decoder
#: layer) and per greedy decode (the encoder once, the decoder per token)
TB_STEP_LAUNCHES = {"layer_norm_fwd": {"float32": 5 * TB_LAYERS},
                    "layer_norm_bwd": {"float32": 5 * TB_LAYERS}}
TB_DECODE_LAUNCHES = {"layer_norm_fwd": {
    "float32": 2 * TB_LAYERS + 3 * TB_LAYERS * TB_DECODE_NEW}}

# ResNet-50 trained through hapi's Model.fit from a multi-process DataLoader
# (the Paddle 2.0 vision entry point, paddle.Model(net).prepare(...).fit):
# ImageNet-shaped uint8 CHW 3 x 256 x 256 images made per index from a seed
# (labels idx % 1000), RandomResizedCrop(224) and RandomHorizontalFlip in 8
# spawned workers, the native fused uint8 -> float32 /255 collation
# (vision_collate_fn), batches through /dev/shm and one pinned copy to the
# card each; Momentum 0.1 / 0.9 with L2Decay(1e-4) (bench.py's ResNet
# optimizer, the usual ImageNet weight decay), CrossEntropyLoss and
# Accuracy(topk=(1, 5)); float32 with TF32 off, one epoch of 8 batches,
# then evaluate on 2 batches (center crops) and predict on the same 2
FIT_BATCH, FIT_IMG, FIT_CROP, FIT_WORKERS = 256, 256, 224, 8
FIT_STEPS, FIT_EVAL_BATCHES = 8, 2
FIT_BATCH_BYTES = FIT_BATCH * 3 * FIT_CROP * FIT_CROP * 4  # 154,140,672
# tests/reference_scripts/hapi_mnist_fit.py's program (LeNet, Adam 1e-3,
# Accuracy) at tests/test_reference_scripts.py's caps: batch 64, 8 steps,
# on striped MNIST IDX files written here (512 train, 256 test images)
MNIST_BATCH, MNIST_STEPS, MNIST_EPOCHS = 64, 8, 2
# the verbatim scripts and tests/test_reference_scripts.py's caps for each
REF_SCRIPTS = {
    "dygraph_lenet_mnist.py": {"BATCH_SIZE": "64", "MAX_STEPS": "8",
                               "EPOCHS": "1"},
    "fluid_fit_a_line.py": {"BATCH_SIZE": "20", "NUM_EPOCHS": "5"},
    "fluid_recognize_digits.py": {"BATCH_SIZE": "64", "NUM_EPOCHS": "1",
                                  "MAX_STEPS": "8"},
    "hapi_mnist_fit.py": {"BATCH_SIZE": "64", "EPOCHS": "1",
                          "MAX_STEPS": "8"},
}
#: that harness's loss pattern, and the launcher's exit line
REF_LOSS_PATTERN = (r"(?:Loss at epoch \d+ step \d+|Pass \d+, Cost|Pass \d+, "
                    r"Batch \d+, Cost|loss):?\s*([0-9]*\.?[0-9]+(?:[eE][-+]?"
                    r"[0-9]+)?)")
RUN_EXIT_PATTERN = (r"paddle_tpu_torch\.run: device=(\S+) "
                    r"max_memory_allocated=(\d+) jax_loaded=(\w+) "
                    r"paddle_tpu_loaded=(\w+) kernel_launches=(\S+)")
# bench.py's BERT-base (_bench_bert, the BERT_* sizes above) as a static
# program: AdamW 1e-4 / 0.01, float32 with TF32 off, six runs; the first
# run's loss against the eager step's within STATIC_BERT_ATOL of it, and its
# parameters within STATIC_BERT_ATOL of each parameter's largest value (when
# not bit-equal)
STATIC_BERT_RUNS = 6
STATIC_BERT_ATOL = 1e-6
# to_static: bench.py's GPT-medium program (the dygraph phase's)
# under paddle.jit.to_static beside an eager twin, with the dygraph phase's
# tolerances and launches a step; then one step with each block under
# paddle.jit.recompute against the plain step (DYGRAPH_GRAD_RTOL), whose
# forward kernels run twice a block
TO_STATIC_STEPS = 3
RECOMPUTE_LAUNCHES = {
    name: {"float32": n} for name, n in (
        ("flash_attention_fwd", 2 * LAYERS),
        ("flash_attention_bwd_dq", LAYERS),
        ("flash_attention_bwd_dkv", LAYERS),
        ("layer_norm_fwd", 2 * LAYERS),
        ("add_layer_norm_fwd", 2 * LAYERS),
        ("layer_norm_bwd", 2 * LAYERS))}
# jit.save: the same program with its head, in eval(), saved at the
# serving cells' batch and prompt and served from a process that holds no
# model source, through jit.load and paddle.inference: its logits bit-equal
# to the eager forward's, or within SAVE_LOGIT_RTOL of the largest |logit|
SAVE_B, SAVE_S = BATCH, PROMPT
SAVE_LOGIT_RTOL = 1e-5
# the saved program keeps bench's width and SAVE_LAYERS (2) of its 24
# blocks (a depth cut, as MC_LAYERS; CHIP_SMOKE_SAVE_LAYERS sets another
# depth)
SAVE_LAYERS = int(os.environ.get("CHIP_SMOKE_SAVE_LAYERS", "2"))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class ImageNetLike:
    """``n`` uint8 CHW 3 x FIT_IMG x FIT_IMG images, each drawn from its own
    seed (``seed + idx``), labels ``idx % 1000``; ``transform`` runs on the
    uint8 image. Module-level, so that the DataLoader's spawned workers,
    which import this file again, find it."""

    def __init__(self, n, transform=None, seed=0):
        self.n, self.transform, self.seed = n, transform, seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        img = np.random.RandomState(self.seed + idx).randint(
            0, 256, (3, FIT_IMG, FIT_IMG), dtype=np.uint8)
        if self.transform is not None:
            img = np.ascontiguousarray(self.transform(img))
        return img, np.int64(idx % 1000)


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


def time_ms_l2_cold(fn, calls=20, reps=5):
    """Device time of one ``fn()`` with its inputs out of L2: each call
    follows a read of 64 MiB (more than the H100's 50 MB L2), and the
    reads' own time, timed alone the same way, is taken off. What ``fn``
    writes is written back to HBM within the measurement."""
    flush = torch.ones(16 << 20, device="cuda")
    sink = torch.empty((), device="cuda")

    def read():
        torch.sum(flush, dim=0, out=sink)

    def both():
        read()
        fn()

    return time_ms(both, calls, reps) - time_ms(read, calls, reps)


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


def ln_fwd_registers(build):
    """Registers and spills of each instantiation of B5's ln_fwd_kernel
    (``-Xptxas -v``), as {"<type> kN=<n>": "<registers>; <spills>"}
    (kN = 0: the looped path). Fails when the register path spills, or
    when the log does not report every instantiation (float32 and bf16,
    kN 0..8 and 16)."""
    import re

    out, key = {}, None
    for line in build.build_log("layer_norm").splitlines():
        if "Function properties for" in line:
            m = re.search(r"\d+ln_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                          line)
            key = m and (f"{'float32' if m[1] == 'f' else 'bf16'} "
                         f"kN={m[2]}")
        elif key and "spill" in line:
            out[key] = line.strip()
        elif key and "registers" in line:
            out[key] = f"{line.split(':', 1)[1].strip()}; {out[key]}"
            print(f"  ln_fwd_kernel {key}: {out[key]}")
            if not key.endswith("kN=0") and " 0 bytes spill stores" \
                    not in out[key]:
                fail(f"ln_fwd_kernel {key} spills")
            key = None
    want = {f"{t} kN={n}" for t in ("float32", "bf16")
            for n in (*range(9), 16)}
    if set(out) != want:
        fail(f"ln_fwd_kernel: the build log reports {sorted(out)}, not "
             f"the {len(want)} instantiations {sorted(want)}")
    return out


def flash_phase(fa, gen, rows):
    """Flash forward vs its plain version, at the model's head dim and at
    head dims 192/256 (the kernel's 256-column tiles) in every type;
    returns the JSON entry, timed at the training shape with the serving
    shape's and the D = 256 block shape's times beside it."""
    import torch.nn.functional as tF

    D0 = D_MODEL // HEADS
    serve, train, wide = "serving S=136", "training S=1024", \
        f"D={WIDE_D} block S={WIDE_S}"
    bert = BERT_BLOCKWISE_ROW
    cases = [  # (B, H, Sq, Sk, D, causal, q_offset, kv_offset, what)
        (BATCH, HEADS, 128, 128, D0, True, 0, 0, "causal"),
        (BERT_B, BERT_HEADS, BERT_S, BERT_S, BERT_D // BERT_HEADS, False, 0,
         0, bert),
        (BATCH, HEADS, 64, 128, D0, True, 64, 0,
         "end-aligned q_offset=Sk-Sq"),
        (BATCH, HEADS, 128, 128, D0, True, 0, 64, "64 fully masked rows"),
        (BATCH, HEADS, PROMPT + 8, PROMPT + 8, D0, True, 0, 0, serve),
        (TRAIN_B, HEADS, TRAIN_S, TRAIN_S, D0, True, 0, 0, train),
        (TRAIN_B, HEADS // MC_MP, TRAIN_S, TRAIN_S, D0, True, 0, 0,
         MC_RANK_ROW),
        (1, HEADS, 4 * TRAIN_S, 4 * TRAIN_S, D0, True, 0, 0, "long S=4096"),
        (WIDE_B, WIDE_H, WIDE_S, WIDE_S, WIDE_D, True, 0, 0, wide),
        (2, 4, 200, 200, 256, False, 0, 0, "ragged, not causal"),
        (2, 4, 136, 136, 192, True, 0, 0, "ragged causal"),
        (2, 4, 72, 200, 192, True, 128, 0, "end-aligned q_offset=Sk-Sq"),
    ] + SP_CASES
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
            # float32 at the serving shape too, bf16 at BERT's non-causal
            if what not in (train, wide) and not (
                    what == serve and dtype == torch.float32) and not (
                    what == bert and dtype == torch.bfloat16) and not (
                    what in (MC_RANK_ROW, *SP_ROWS)
                    and dtype != torch.float16):
                continue
            calls = 20 if S <= 256 else 5
            ms = time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, block_q=8, block_k=8, **kw), calls=calls)
            lib_ms = time_ms(lambda: tF.scaled_dot_product_attention(
                q, k, v, is_causal=causal), calls=calls)
            # visible (q, k) pairs per head
            pairs = S * (S + 1) // 2 if causal else S * Sk
            nbytes = (3 * B * H * S * D + B * H * S * D) \
                * q.element_size() + B * H * S * 4
            bms, by = bound_ms(nbytes, 4 * D * pairs * B * H, dtype,
                               PEAK_MMA_FLOPS)
            plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, **kw), calls=calls)
            timed[what, SHORT[dtype]] = dict(
                shape=f"[{B},{H},{S},{D}] "
                      f"{'causal' if causal else 'not causal'}",
                max_abs_err=max(eo, el),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)
            rows.append(f"flash_attention_fwd {str(dtype)[6:]} "
                        f"{timed[what, SHORT[dtype]]['shape']}: kernel "
                        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"sdpa {lib_ms:.4f} ms, bound {bms:.6f} ms ({by})")
    return dict(name="flash_attention_fwd", route="cuda", source=fa.SOURCE,
                replaces="paddle_tpu/ops/pallas/flash_attention.py:49 "
                         "(_fwd_kernel_resident) and :110 (_fwd_kernel)",
                dtype="float32", **timed[train, "float32"],
                at_serving_shape=timed[serve, "float32"],
                bf16=timed[train, "bf16"], float16=timed[train, "float16"],
                head_dim_256={t: timed[wide, t] for t in SHORT.values()},
                bert_not_causal_bf16=timed[bert, "bf16"],
                per_rank_dp2_mp2={t: timed[MC_RANK_ROW, t]
                                  for t in ("float32", "bf16")},
                **_sp_timed(timed))


def _sp_timed(timed, name=None):
    """The sp rows of a kernel's timings, for its JSON entry."""
    key = (lambda row, t: (row, t)) if name is None else \
        (lambda row, t: (name, row, t))
    return {row.replace(" ", "_").replace("=", ""): {
        t: timed[key(row, t)] for t in ("float32", "bf16")}
        for row in SP_ROWS}


def ln_phase(ln, gen, rows):
    """LN and add-LN vs their plain versions; returns two JSON entries,
    timed at the training rows with the serving prefill's beside them."""
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
            expect_path(ln, x, w, b, D // 128)
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
            if dtype == torch.bfloat16 and R == train_r:
                timed["layer_norm_fwd_bf16"] = dict(time_ln_fwd(
                    ln, x, w, b, max(e for e, _ in e1), rows),
                    dtype="bfloat16")
            if dtype != torch.float32:
                continue
            for ytype in (torch.bfloat16, torch.float16):
                mixed = mixed_add_ln(ln, gen, R, D, rows, R == train_r,
                                     ytype)
                if mixed is not None:
                    timed[f"float32+{str(ytype)[6:]}"] = mixed
            timed.setdefault("layer_norm_fwd", {})[R] = time_ln_fwd(
                ln, x, w, b, max(e for e, _ in e1), rows,
                B5_EARLIER_MS[f"[{R},{D}]"])
            it = x.element_size()
            ms = time_ms(lambda: ln.add_layer_norm_fwd(x, y, w, b))
            plain_ms = time_ms(lambda: ln.add_layer_norm_fwd_plain(
                x, y, w, b))
            bms, by = bound_ms(4 * R * D * it + 2 * D * it + 2 * R * 4,
                               8 * R * D, dtype)
            rows.append(
                f"add_layer_norm_fwd f32 [{R},{D}]: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, library n/a, bound {bms:.6f} ms "
                f"({by})")
            timed.setdefault("add_layer_norm_fwd", {})[R] = dict(
                shape=f"[{R},{D}]", max_abs_err=max(e for e, _ in e2),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)
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
    entries[0]["bfloat16"] = timed["layer_norm_fwd_bf16"]
    entries[0]["bert_base"] = width_ln(
        ln, gen, rows, BERT_B * BERT_S, BERT_D, "BERT-base",
        B5_EARLIER_MS[f"[{BERT_B * BERT_S},{BERT_D}]"])
    entries[0]["transformer_base"] = width_ln(
        ln, gen, rows, TB_B * TB_S, TB_D, "Transformer-base")
    entries[0]["transformer_base_decode"] = {
        f"[{R},{TB_D}]": width_ln(ln, gen, rows, R, TB_D, what)
        for R, what in ((TB_DECODE_B * TB_S, "Transformer-base encoder "
                         "in the decode"),
                        (TB_DECODE_B, "Transformer-base decoder, a token"))}
    entries[0]["looped_path"] = ln_fwd_looped(ln, gen, rows)
    return entries


def expect_path(ln, x, w, b, kn):
    """Fail unless B5 takes the register path with ``kn`` (D = 128 kn) on
    these tensors, or the looped path for ``kn`` 0."""
    got = ln.layer_norm_fwd_path(x, w, b)
    if got != kn:
        fail(f"layer_norm_fwd {x.dtype} {list(x.shape)} at offset "
             f"{x.storage_offset()} takes path kN = {got}, not {kn}")


def time_ln_fwd(ln, x, w, b, err, rows, earlier_ms=None):
    """B5 on ``x`` timed beside its plain version and ``F.layer_norm`` in
    x's type (``w`` and ``b`` in x's type for it, float32 for the kernel,
    whose wrapper would otherwise time their casts); the dict of the JSON
    line. ``earlier_ms``, the earlier kernel's recorded time, goes on the
    printed row only."""
    import torch.nn.functional as tF

    R, D = x.shape
    w32, b32 = w.float(), b.float()
    ms = time_ms(lambda: ln.layer_norm_fwd(x, w32, b32))
    plain_ms = time_ms(lambda: ln.layer_norm_fwd_plain(x, w32, b32))
    lib_ms = time_ms(lambda: tF.layer_norm(x, (D,), w, b, 1e-5))
    cold_ms = time_ms_l2_cold(lambda: ln.layer_norm_fwd(x, w32, b32))
    lib_cold_ms = time_ms_l2_cold(lambda: tF.layer_norm(x, (D,), w, b,
                                                        1e-5))
    # reads x, w, b (float32); writes y, mu, rstd (f32 arithmetic)
    it = x.element_size()
    bms, by = bound_ms(2 * R * D * it + 2 * D * 4 + 2 * R * 4, 8 * R * D,
                       torch.float32)
    rows.append(f"layer_norm_fwd {SHORT[x.dtype]} [{R},{D}]: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{lib_ms:.4f} ms, bound {bms:.6f} ms ({by}); L2-cold: "
                f"kernel {cold_ms:.4f} ms, library {lib_cold_ms:.4f} ms"
                + ("" if earlier_ms is None else
                   f"; the earlier kernel read {earlier_ms:.4f} ms "
                   "(recorded, PERF.md)"))
    return dict(shape=f"[{R},{D}]",
                path="register" if ln.layer_norm_fwd_path(x, w, b)
                else "looped", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                l2_cold_ms=cold_ms, library_l2_cold_ms=lib_cold_ms)


def ln_fwd_looped(ln, gen, rows):
    """B5's looped path against its plain version: rows of D = 200 (not a
    multiple of 128) and training rows given as a contiguous view one
    element into its buffer (not aligned for the wide loads), in float32
    and bfloat16; on those rows bit-equal to the register path on an
    aligned copy; the misaligned float32 rows timed. Returns the dict."""
    out = {}
    R, D = TRAIN_B * TRAIN_S, D_MODEL
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.randn(R * D + 1, device="cuda", generator=gen).to(dtype)
        for what, x in (("D=200", buf[:37 * 200].view(37, 200)),
                        ("offset", buf[1:].view(R, D))):
            d = x.shape[1]
            w, b = (torch.randn(d, device="cuda", generator=gen)
                    for _ in range(2))
            expect_path(ln, x, w, b, 0)
            got = ln.layer_norm_fwd(x, w, b)
            ref = ln.layer_norm_fwd_plain(x, w, b)
            torch.cuda.synchronize()
            errs = [close(a, r, dtype if i == 0 else torch.float32)
                    for i, (a, r) in enumerate(zip(got, ref))]
            print(f"layer_norm_fwd looped path {SHORT[dtype]} "
                  f"{list(x.shape)} ({what}): max err y/mu/rstd "
                  f"{[f'{e:.3e}' for e, _ in errs]}")
            if not all(ok for _, ok in errs):
                fail(f"layer_norm_fwd looped path {dtype} {what} disagrees "
                     "with its plain version")
            if what == "offset":
                aligned = x.clone()
                expect_path(ln, aligned, w, b, D // 128)
                if not all(torch.equal(a, c) for a, c in zip(
                        got, ln.layer_norm_fwd(aligned, w, b))):
                    fail(f"layer_norm_fwd {dtype}: the looped and register "
                         "paths differ on the same rows")
            if dtype == torch.float32 and what == "offset":
                out = time_ln_fwd(ln, x, w, b, max(e for e, _ in errs),
                                  rows)
                out["path"] = "looped (x one element into its buffer)"
    return out


def width_ln(ln, gen, rows, R, D, what, earlier_ms=None):
    """B5 at a model's rows (``what``: BERT-base's [4096, 768],
    Transformer-base's [4096, 512] in training and its decode's [1024, 512]
    and [8, 512]; float32) against its plain version on its register path,
    timed beside ``F.layer_norm``; returns the dict."""
    x = torch.randn(R, D, device="cuda", generator=gen)
    w, b = (torch.randn(D, device="cuda", generator=gen) for _ in range(2))
    expect_path(ln, x, w, b, D // 128)
    got = ln.layer_norm_fwd(x, w, b)
    ref = ln.layer_norm_fwd_plain(x, w, b)
    torch.cuda.synchronize()
    errs = [close(a, r, torch.float32) for a, r in zip(got, ref)]
    print(f"layer_norm_fwd float32 [{R},{D}] ({what}): max err y/mu/rstd "
          f"{[f'{e:.3e}' for e, _ in errs]}")
    if not all(ok for _, ok in errs):
        fail(f"layer_norm_fwd float32 [{R},{D}] disagrees with its plain "
             "version")
    return time_ln_fwd(ln, x, w, b, max(e for e, _ in errs), rows,
                       earlier_ms)


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
    bert = BERT_BLOCKWISE_ROW
    cases = [  # (B, H, Sq, Sk, D, causal, q_offset, kv_offset, what)
        (TRAIN_B, HEADS, S, S, D0, True, 0, 0, train),
        (TRAIN_B, HEADS // MC_MP, S, S, D0, True, 0, 0, MC_RANK_ROW),
        (BERT_B, BERT_HEADS, BERT_S, BERT_S, BERT_D // BERT_HEADS, False, 0,
         0, bert),
        (2, HEADS, 128, 256, D0, True, 128, 0, "end-aligned q_offset=Sk-Sq"),
        (2, HEADS, 256, 256, D0, True, 0, 64, "64 fully masked rows"),
        (1, HEADS, 4 * S, 4 * S, D0, True, 0, 0, "long S=4096"),
        (WIDE_B, WIDE_H, WIDE_S, WIDE_S, WIDE_D, True, 0, 0, wide),
        (2, 4, 200, 200, 256, False, 0, 0, "ragged, not causal"),
        (2, 4, 136, 136, 192, True, 0, 0, "ragged causal"),
        (2, 4, 72, 200, 192, True, 128, 0, "end-aligned q_offset=Sk-Sq"),
    ] + SP_CASES
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
            if what not in (train, wide) and not (
                    what == bert and dtype == torch.bfloat16) and not (
                    what in (MC_RANK_ROW, *SP_ROWS)
                    and dtype != torch.float16):
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
                                                          is_causal=causal)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), do, retain_graph=True), calls=5,
                stream=side)
            # visible (q, k) pairs
            pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * sk)
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
                    shape=f"[{b},{h},{sq},{D}] "
                          f"{'causal' if causal else 'not causal'}",
                    max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms)
                rows.append(f"{name} {str(dtype)[6:]} "
                            f"{timed[name, what, SHORT[dtype]]['shape']}: "
                            f"kernel {ms:.4f} ms, plain (dq, dk, dv) "
                            f"{plain_ms:.4f} ms, sdpa backward (dq, dk, dv) "
                            f"{lib_ms:.4f} ms, bound {bms:.6f} ms ({by})")
    return tuple(
        dict(name=name, route="cuda", source=fa.BWD_SOURCE,
             replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
             dtype="float32", **timed[name, train, "float32"],
             bf16=timed[name, train, "bf16"],
             float16=timed[name, train, "float16"],
             head_dim_256={t: timed[name, wide, t] for t in SHORT.values()},
             bert_not_causal_bf16=timed[name, bert, "bf16"],
             per_rank_dp2_mp2={t: timed[name, MC_RANK_ROW, t]
                               for t in ("float32", "bf16")},
             **_sp_timed(timed, name))
        for name, line in (("flash_attention_bwd_dq", "171 (_dq_kernel)"),
                           ("flash_attention_bwd_dkv", "224 (_dkv_kernel)")))


def partial_phase(fa, gen, rows):
    """``flash_attention_partial`` (the ring's building block: B1 forward,
    B3/B4 backward with the lse cotangent folded into delta) against its
    plain version on the card at the ring's per-rank shape [1, 16, 2048,
    64], float32 and bf16: the diagonal shard (causal), a full shard (not
    causal) and a fully masked one (causal, every key in the future:
    out = 0, lse = -1e30, gradients 0). The backward's plain version is
    ``flash_attention_bwd_plain`` with ``delta = rowsum(g_out * out) -
    g_lse``. Timed (forward) at the diagonal in float32 beside the plain
    forward and ``aten._scaled_dot_product_efficient_attention`` with its
    log-sum-exp (one PyTorch call computing (out, lse)); the backward's
    time beside it, with its bound (B3's and B4's added) and SDPA's
    backward (``torch.autograd.grad`` of ``scaled_dot_product_attention``,
    the library's nearest call: it takes no lse cotangent). Returns the
    JSON entry."""
    import torch.nn.functional as tF

    B, H, S, D = SP_RING_SHAPE
    cases = ((True, 0, "diagonal shard"), (False, 0, "full shard"),
             (True, S, "fully masked shard"))
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal, ko, what in cases:
            q, k, v, go = (torch.randn(B, H, S, D, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(4))
            gl = torch.randn(B, H, S, device="cuda", generator=gen)
            kw = dict(causal=causal, q_offset=0, kv_offset=ko)
            out, lse = fa.flash_attention_partial(q, k, v, causal, S, S,
                                                  None, 0, ko)
            dq, dk, dv = fa.partial_backward(q, k, v, out, lse, go, gl, **kw)
            po, pl = fa.flash_attention_fwd_plain(q, k, v, **kw)
            delta = (go.float() * po.float()).sum(-1) - gl
            ref = fa.flash_attention_bwd_plain(q, k, v, go, pl, delta, **kw)
            torch.cuda.synchronize()
            errs = [close(a, b, dtype) for a, b in
                    ((out, po), (dq, ref[0]), (dk, ref[1]), (dv, ref[2]))]
            el, ok_l = close(lse, pl, torch.float32)
            print(f"flash_attention_partial {str(dtype)[6:]} {list(q.shape)}"
                  f" {what}: max|out err| {errs[0][0]:.3e} max|lse err| "
                  f"{el:.3e} max|dq, dk, dv err| "
                  f"{[f'{e:.3e}' for e, _ in errs[1:]]}")
            if not (ok_l and all(ok for _, ok in errs)):
                fail(f"flash_attention_partial {dtype} {what} disagrees "
                     "with its plain version")
            if ko and not (bool((out == 0).all()) and bool(
                    (lse <= -1e29).all()) and all(
                    bool((t == 0).all()) for t in (dq, dk, dv))):
                fail(f"flash_attention_partial {what}: a fully masked "
                     "shard must give out 0, lse -1e30 and no gradient")
            if what != "diagonal shard":
                continue
            ms = time_ms(lambda: fa.flash_attention_partial(
                q, k, v, causal, S, S, None, 0, 0), calls=5)
            bwd_ms = time_ms(lambda: fa.partial_backward(
                q, k, v, out, lse, go, gl, **kw), calls=5)
            plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, **kw), calls=5)
            lib_ms = time_ms(
                lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                    q, k, v, None, True, 0.0, causal), calls=5)
            # SDPA's backward alone, as flash_bwd_phase times it (its
            # forward recorded on the stream the backward is captured on)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                lib_out = tF.scaled_dot_product_attention(ql, kl, vl,
                                                          is_causal=causal)
            lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), go, retain_graph=True), calls=5,
                stream=side)
            del ql, kl, vl, lib_out
            pairs = S * (S + 1) // 2
            nbytes = 4 * B * H * S * D * q.element_size() + B * H * S * 4
            bms, by = bound_ms(nbytes, 4 * D * pairs * B * H, dtype,
                               PEAK_MMA_FLOPS)
            # the backward's bound, from the work it needs: S = QK^T once,
            # then dP, dV, dQ and dK (10 D flops a causal pair); q, k, v,
            # o, dO, lse and its cotangent read, dq, dk, dv written
            el_, it = B * H * S * D, q.element_size()
            bwd_bms = bound_ms(8 * el_ * it + 2 * B * H * S * 4,
                               10 * D * pairs * B * H, dtype,
                               PEAK_MMA_FLOPS)[0]
            # B3's and B4's bounds (flash_bwd_phase's counts) added: what
            # the split kernels' design moves and recomputes (S and dP in
            # each)
            split_bms = bound_ms(5 * el_ * it + 2 * B * H * S * 4,
                                 6 * D * pairs * B * H, dtype,
                                 PEAK_MMA_FLOPS)[0] + bound_ms(
                6 * el_ * it + 2 * B * H * S * 4, 8 * D * pairs * B * H,
                dtype, PEAK_MMA_FLOPS)[0]
            timed[SHORT[dtype]] = dict(
                shape=f"[{B},{H},{S},{D}] causal", max_abs_err=max(
                    [el] + [e for e, _ in errs]),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, backward_ms=bwd_ms,
                backward_bound_ms=bwd_bms,
                backward_split_bound_ms=split_bms,
                backward_library_ms=lib_bwd_ms)
            rows.append(f"flash_attention_partial {str(dtype)[6:]} "
                        f"{timed[SHORT[dtype]]['shape']}: forward {ms:.4f} "
                        f"ms, backward (delta, B3, B4) {bwd_ms:.4f} ms "
                        f"(bound {bwd_bms:.4f} ms, B3 + B4's bounds "
                        f"{split_bms:.4f} ms, SDPA's backward "
                        f"{lib_bwd_ms:.4f} ms), "
                        f"plain forward {plain_ms:.4f} ms, efficient "
                        f"attention with lse {lib_ms:.4f} ms, bound "
                        f"{bms:.6f} ms ({by})")
    return dict(name="flash_attention_partial", route="cuda",
                source=f"{fa.SOURCE}, {fa.BWD_SOURCE} (the B1 forward; B3 "
                       "and B4 with the lse cotangent folded into delta)",
                replaces="paddle_tpu/ops/pallas/flash_attention.py:421 "
                         "(flash_attention_partial, _fap_fwd, _fap_bwd)",
                dtype="float32", **timed["float32"], bf16=timed["bf16"])


def ln_bwd_phase(ln, gen, rows):
    """B7 vs the plain LayerNorm backward; returns the JSON entry."""
    entry = bf16_entry = None
    widths = {}  # float32 rows of BERT-base and Transformer-base
    # the training rows, BERT-base's and Transformer-base's rows, a few
    # rows, and rows off the register path (D not a multiple of 128; R not
    # a multiple of the block's 8 warps)
    bert = BERT_B * BERT_S, BERT_D
    tbase = TB_B * TB_S, TB_D
    for dtype in (torch.float32, torch.bfloat16):
        for R, D in ((TRAIN_B * TRAIN_S, D_MODEL), bert, tbase,
                     (40, D_MODEL), (37, 200)):
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
            if (R, D) not in ((TRAIN_B * TRAIN_S, D_MODEL), bert, tbase) or (
                    dtype != torch.float32 and (R, D) != (
                        TRAIN_B * TRAIN_S, D_MODEL)):
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
            rows.append(f"layer_norm_bwd {SHORT[dtype]} [{R},{D}]: kernel "
                        f"{ms:.4f} "
                        f"ms, plain {plain_ms:.4f} ms, native_layer_norm_"
                        f"backward {lib_ms:.4f} ms, bound {bms:.6f} ms "
                        f"({by})")
            if D != D_MODEL or dtype != torch.float32:
                row = dict(
                    shape=f"[{R},{D}]", max_abs_err=max(e for e, _ in errs),
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms)
                if D != D_MODEL:
                    widths[D] = row
                else:
                    bf16_entry = row
                continue
            entry = dict(
                name="layer_norm_bwd", route="cuda", source=ln.SOURCE,
                replaces="paddle_tpu/ops/pallas/layer_norm.py:87 "
                         "(_ln_bwd_kernel)",
                shape=f"[{R},{D}]", dtype="float32",
                max_abs_err=max(e for e, _ in errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)
    entry["bert_base"] = widths[BERT_D]
    entry["transformer_base"] = widths[TB_D]
    entry["bfloat16"] = bf16_entry
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


# -- bench.py's GPT-medium program, as bench.py writes it -------------------
# The two functions below are bench.py's ``_gpt_medium`` and the loss of its
# ``_bench_gpt`` (the fused-CE branch), with only their import lines
# pointed at paddle_tpu_torch; tests/test_torch_dygraph_gpt.py checks the
# text against bench.py.


def _gpt_medium(dense=False):
    """GPT-medium-shaped causal decoder (the single-chip proxy for
    BASELINE config 5's GPT-3 1.3B, which needs the dp x pp x mp hybrid
    dryrun_multichip proves): 24 ParallelGPTBlock layers (trivial 1-chip
    mesh — same code path the hybrid shards), d_model 1024, 16 heads,
    seq 1024, tied-free 32k vocab head.

    Round 6: the decoder hot path is the DEFAULT path — flash attention
    routes automatically inside every block (PADDLE_FLASH_DEFAULT policy)
    and the model returns the pre-head hidden state so the loss can run
    the blockwise fused vocab CE. `dense=True` is the escape-hatch
    configuration (forced dense attention + materialized-logits CE) used
    to record the routed/unrouted pair."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import ParallelGPTBlock, comm

    if comm.hybrid_mesh() is None:
        comm.init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)

    class GPT(nn.Layer):
        def __init__(self, vocab=32000, d=1024, heads=16, layers=24,
                     seq=1024):
            super().__init__()
            self.embed = nn.Embedding(vocab, d)
            self.pos = nn.Embedding(seq, d)
            self.blocks = nn.LayerList([
                ParallelGPTBlock(
                    d, heads, dropout=0.0,
                    use_flash_attention=False if dense else None,
                )
                for _ in range(layers)
            ])
            self.head = nn.Linear(d, vocab)

        def forward(self, ids):
            T = ids.shape[1]
            pos_ids = paddle.arange(T, dtype="int64")
            h = self.embed(ids) + self.pos(pos_ids)
            for blk in self.blocks:
                h = blk(h)
            # the head projection lives in the LOSS (blockwise fused CE
            # streams it over vocab chunks); the dense escape hatch
            # materializes the logits here as before
            return self.head(h) if dense else h

    return GPT()


def _bench_lm_loss(model):
    """bench.py's ``_bench_gpt`` loss over ``model``'s head (its
    ``fused_linear_cross_entropy`` branch)."""
    from paddle_tpu_torch import nn

    def lm_loss(h, labels):
        d = h.shape[-1]
        # blockwise fused head-projection + CE: the [B*S, 32k] f32
        # logits/grads never materialize at once (PADDLE_CE_CHUNK)
        return nn.functional.fused_linear_cross_entropy(
            h.reshape([-1, d]), model.head.weight, model.head.bias,
            labels.reshape([-1]),
        )

    return lm_loss


def worst_grad(got, want):
    """The largest ``max|got - want| / max|want|`` over the parameters of
    ``want`` (inf where ``want`` is all zeros), and its name."""
    w, name = 0.0, ""
    for k, gd in want.items():
        scale = gd.abs().max().item()
        rel = (got[k].float() - gd.float()).abs().max().item() \
            / max(scale, 1e-30)
        if scale == 0 or rel > w:
            w, name = (rel, k) if scale else (float("inf"), k)
    return w, name


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
    pt.seed(3 if fp16 else 2)
    model = _gpt_medium()
    n_params = sum(p.numel() for p in model.parameters())
    n = TRAIN_B * TRAIN_S
    ids = torch.as_tensor((np.arange(n) % 31000).reshape(TRAIN_B, TRAIN_S),
                          device="cuda")
    labels = torch.as_tensor(((np.arange(n) + 1) % 31000).reshape(
        TRAIN_B, TRAIN_S), device="cuda")
    lm_loss = _bench_lm_loss(model)

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

    kernels.reset_launches()
    loss_k, g_k = grads("1")
    oracle_counts = kernels.launches_by_dtype()
    loss_d, g_d = grads("0")
    for k, g in g_k.items():
        if g is None or g.dtype != torch.float32 \
                or not bool(torch.isfinite(g).all()):
            fail(f"kernel route gives no finite float32 gradient for {k}")
    w_kd, n_kd = worst_grad(g_k, g_d)
    loss_f, g_f = grads("0", amp_on=False)  # float32, for scale only
    w_kf, _ = worst_grad(g_k, g_f)
    w_df, _ = worst_grad(g_d, g_f)
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


def dygraph_phase(pt, kernels, card):
    """bench.py's GPT-medium program as written (``_gpt_medium`` and
    ``_bench_gpt``'s loss, above) in a Paddle eager loop at bench's sizes,
    float32 with TF32 off: ``set_device("gpu")``, ``seed(0)``, AdamW(1e-4,
    weight decay 0.01), three steps of ``lm_loss(model(ids),
    labels).backward(); opt.step(); opt.clear_grad()`` on bench's ids as
    ``to_tensor``; then three ``jit.TrainStep`` calls of the same model
    class from the same initial weights (``state_dict`` copied). Fails
    unless each step's loss agrees within DYGRAPH_LOSS_RTOL, every
    parameter's first-step gradient within DYGRAPH_GRAD_RTOL of its
    largest value, and each kernel ran in float32 as often per step as in
    the TrainStep run (DYGRAPH_LAUNCHES). Returns the eager run's launch
    counts."""
    paddle = pt  # the names of a dygraph script: import ... as paddle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    paddle.seed(0)
    t0 = time.perf_counter()
    model = _gpt_medium()
    twin = _gpt_medium()
    twin.set_state_dict(model.state_dict())
    n = TRAIN_B * TRAIN_S
    ids = paddle.to_tensor((np.arange(n) % 31000).reshape(TRAIN_B, TRAIN_S))
    labels = paddle.to_tensor(((np.arange(n) + 1) % 31000).reshape(
        TRAIN_B, TRAIN_S))
    torch.cuda.synchronize()
    print(f"dygraph: two bench GPT-medium models built in "
          f"{time.perf_counter() - t0:.2f} s")

    def run(steps_fn):
        losses, ms, counts = [], [], []
        for i in range(DYGRAPH_STEPS):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(steps_fn(i)))  # a host read: syncs
            ms.append((time.perf_counter() - t1) * 1e3)
            counts.append(kernels.launches_by_dtype())
        kernels.reset_launches()
        return losses, ms, counts

    # the eager loop, as a Paddle dygraph script writes it
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=model.parameters())
    lm_loss = _bench_lm_loss(model)
    g_eager = {}

    def eager_step(i):
        loss = lm_loss(model(ids), labels)
        loss.backward()
        if i == 0:
            g_eager.update({k: p.grad.clone()
                            for k, p in model.named_parameters()})
        opt.step()
        opt.clear_grad()
        return loss

    torch.cuda.reset_peak_memory_stats()
    e_loss, e_ms, e_counts = run(eager_step)
    e_peak = torch.cuda.max_memory_allocated() / 2**30

    # the same program through TrainStep; its first step's gradients are
    # caught as they are accumulated (TrainStep clears them after the
    # update)
    topt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  parameters=twin.parameters())
    step = paddle.jit.TrainStep(twin, _bench_lm_loss(twin), topt)
    g_step = {}

    def catch(name):
        def hook(p):
            if name not in g_step:
                g_step[name] = p.grad.clone()

        return hook

    hooks = [p.register_post_accumulate_grad_hook(catch(k))
             for k, p in twin.named_parameters()]
    torch.cuda.reset_peak_memory_stats()
    s_loss, s_ms, s_counts = run(lambda i: step(ids, labels))
    s_peak = torch.cuda.max_memory_allocated() / 2**30
    for h in hooks:
        h.remove()

    rels = {}
    for k, gs in g_step.items():
        ge = g_eager.get(k)
        if ge is None or not bool(torch.isfinite(ge).all()):
            fail(f"dygraph: no finite eager gradient for {k}")
        scale = gs.abs().max().item()
        rels[k] = (ge - gs).abs().max().item() / max(scale, 1e-30)
    worst_name = max(rels, key=rels.get)
    worst = rels[worst_name]
    if set(g_step) != set(g_eager):
        fail("dygraph: the eager and TrainStep runs differ in which "
             "parameters got gradients")
    pdiff = max((p - q).abs().max().item() for p, q in zip(
        model.parameters(), twin.parameters()))
    bitwise = pdiff == 0.0
    del g_eager, g_step
    print(f"dygraph eager loop (bench GPT-medium, float32, B={TRAIN_B} "
          f"S={TRAIN_S}, AdamW 1e-4/0.01): losses "
          f"{[f'{x:.7f}' for x in e_loss]}; TrainStep "
          f"{[f'{x:.7f}' for x in s_loss]}; first-step gradients: worst "
          f"max|g_eager - g_step| / max|g_step| {worst:.3e} ({worst_name}; "
          f"tolerance {DYGRAPH_GRAD_RTOL}); largest parameter difference "
          f"after {DYGRAPH_STEPS} steps {pdiff:.3e} (a reading; bitwise "
          f"equal: {bitwise})")
    print(f"dygraph ms/step (host clock, median of steps 2-"
          f"{DYGRAPH_STEPS}): eager {float(np.median(e_ms[1:])):.2f}, "
          f"TrainStep {float(np.median(s_ms[1:])):.2f}; step ms eager "
          f"{[f'{x:.1f}' for x in e_ms]}, TrainStep "
          f"{[f'{x:.1f}' for x in s_ms]}; peak memory eager {e_peak:.2f} "
          f"GiB, TrainStep {s_peak:.2f} GiB; {card}")
    print(f"dygraph launches per step, eager {e_counts[0]}; TrainStep "
          f"{s_counts[0]}")
    for i, (le, ls) in enumerate(zip(e_loss, s_loss)):
        if not np.isfinite(le) or abs(le - ls) > DYGRAPH_LOSS_RTOL * abs(ls):
            fail(f"dygraph step {i + 1}: eager loss {le} against TrainStep "
                 f"{ls}")
    if worst > DYGRAPH_GRAD_RTOL:
        fail("dygraph: eager first-step gradients disagree with TrainStep's")
    for i, (ce, cs) in enumerate(zip(e_counts, s_counts)):
        if ce != cs:
            fail(f"dygraph step {i + 1}: launches {ce}, TrainStep {cs}")
        for name, want in DYGRAPH_LAUNCHES.items():
            if ce[name] != want:
                fail(f"dygraph step {i + 1}: kernel {name} launched "
                     f"{ce[name]}, expected {want}")
    del model, twin, opt, topt, step
    torch.cuda.empty_cache()
    return {name: sum(sum(c[name].values()) for c in e_counts)
            for name in DYGRAPH_LAUNCHES}


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


def bench_bert(pt, attn_impl="dense"):
    """bench.py's ``_bert_base`` from the port's layers: token and
    position embeddings, 12 post-LN TransformerEncoderLayers (768 wide, 12
    heads, ffn 3072, dropout 0), the mean over the sequence, a 2-way
    head; ``attn_impl="blockwise"`` builds the encoder layers on blockwise
    attention with blocks of BERT_BLOCK."""

    class Bert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            kw = dict(device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(5))
            self.embed = pt.nn.Embedding(BERT_VOCAB, BERT_D, **kw)
            self.pos = pt.nn.Embedding(BERT_POS, BERT_D, **kw)
            self.encoder = pt.nn.LayerList([
                pt.nn.TransformerEncoderLayer(BERT_D, BERT_HEADS, 4 * BERT_D,
                                              dropout=0.0,
                                              attn_impl=attn_impl, **kw)
                for _ in range(BERT_LAYERS)])
            for lyr in self.encoder:
                lyr.self_attn.block_size = BERT_BLOCK
            self.head = pt.nn.Linear(BERT_D, 2, **kw)

        def forward(self, ids):
            pos_ids = torch.arange(ids.shape[1], device=ids.device)
            h = self.embed(ids) + self.pos(pos_ids)
            for lyr in self.encoder:
                h = lyr(h)
            return self.head(h.mean(dim=1))

    return Bert()


def bench_program_phase(pt, kernels, name, model, opt, x, y, amp, unit,
                        launches, stats=None):
    """Train one of bench.py's programs as ``_bench_train`` /
    ``_bench_bert`` do (``TrainStep`` with ``cross_entropy``; bf16 AMP
    through ``fleet`` when ``amp``) for BENCH_STEPS steps on one batch
    made on the card: prints the rate (``unit`` per second, from the mean
    host time of steps 2-6 around a synchronize), the step times, peak
    memory, the losses (which must be finite and fall) and the kernels'
    launches by input types (which must equal ``launches`` per step).
    Returns the launches; fills ``stats`` (a dict) with ms/step, the rate
    and peak GiB."""
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
    if stats is not None:
        stats.update(ms_per_step=steady, rate=x.shape[0] / steady * 1e3,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     losses=losses)
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
    out["bert"] = bench_program_phase(
        pt, kernels, "BERT-base (AdamW 1e-4/0.01, bf16 AMP)", bench_bert(pt),
        pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01), ids, y,
        True, "samples", BERT_LN_LAUNCHES)
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
    model = pt.TransformerLM(VOCAB, D_MODEL, HEADS, SERVE_LAYERS,
                             max_position=CAP, dim_feedforward=FFN, seed=0)
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
    model = pt.TransformerLM(VOCAB, D_MODEL, HEADS, SERVE_LAYERS,
                             max_position=cap, dim_feedforward=FFN, seed=2)
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
                                      itemsize=4, layers=SERVE_LAYERS)
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
        return pt.TransformerLM(VOCAB, D_MODEL, HEADS, SERVE_LAYERS,
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
    if len(narrow) != 4 * SERVE_LAYERS + 1 or any(
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
    target = pt.TransformerLM(VOCAB, D_MODEL, HEADS, SERVE_LAYERS,
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
    model = pt.TransformerLM(VOCAB, D_MODEL, HEADS, SERVE_LAYERS,
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
    want = (PROMPT // TIER_BLOCK) * TIER_BLOCK * 2 * SERVE_LAYERS \
        * D_MODEL * 4
    print(f"per bundle: {nbytes} bytes (reckoned {want}: "
          f"{PROMPT // TIER_BLOCK} blocks x {TIER_BLOCK} rows x "
          f"{SERVE_LAYERS} "
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


# -- Transformer-base translation, as a Paddle 2.0 script writes it --------
# translation_model, padding_mask, smoothed_loss and greedy are the script;
# tests/test_torch_transformer.py imports them and runs them through both
# packages at a small size.


def translation_model(paddle, vocab, d_model=512, nhead=8, layers=6,
                      ffn=2048, dropout=0.1):
    """Transformer-base for translation (Vaswani et al. 2017, Table 3
    "base"), written against the Paddle surface ``paddle``."""
    nn = paddle.nn

    class Translator(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(vocab, d_model, padding_idx=0)
            self.transformer = nn.Transformer(d_model, nhead, layers, layers,
                                              ffn, dropout)

        def embed(self, ids, start=0):
            n = ids.shape[1]
            pos = paddle.arange(start, start + n, dtype="float32")
            inv = paddle.exp(paddle.arange(0, d_model, 2, dtype="float32")
                             * (-math.log(10000.0) / d_model))
            angle = pos.unsqueeze(1) * inv.unsqueeze(0)
            table = paddle.concat([paddle.sin(angle), paddle.cos(angle)],
                                  axis=1)
            return self.emb(ids) * d_model ** 0.5 + table

        def logits(self, h):
            return paddle.matmul(h, self.emb.weight, transpose_y=True)

        def forward(self, src, tgt, src_mask, tgt_mask):
            h = self.transformer(self.embed(src), self.embed(tgt), src_mask,
                                 tgt_mask, src_mask)
            return self.logits(h)

    return Translator()


def padding_mask(paddle, src):
    """[B, 1, 1, S] additive: -1e9 at padding ids (0)."""
    return paddle.cast(src == 0, "float32").unsqueeze([1, 2]) * -1e9


def smoothed_loss(paddle, logits, label, vocab):
    soft = paddle.nn.functional.label_smooth(
        paddle.nn.functional.one_hot(label, vocab), epsilon=0.1)
    return paddle.nn.CrossEntropyLoss(soft_label=True)(logits, soft)


def greedy(paddle, model, src, src_mask, steps, bos=1):
    """Greedy decoding through the encoder and the decoder's incremental
    cache -> (tokens [B, steps], logits [B, steps, V])."""
    t = model.transformer
    memory = t.encoder(model.embed(src), src_mask)
    cache = t.decoder.gen_cache(memory)
    tok = paddle.full([src.shape[0], 1], bos, dtype="int64")
    toks, logits = [], []
    for i in range(steps):
        h, cache = t.decoder(model.embed(tok, start=i), memory, None,
                             src_mask, cache)
        lg = model.logits(h)
        tok = paddle.argmax(lg, axis=-1).astype("int64")
        toks.append(tok)
        logits.append(lg)
    return paddle.concat(toks, axis=1), paddle.concat(logits, axis=1)


def _launches_off_path(counts, want):
    """Kernels launched where ``want`` (name -> {types: n}) expects other
    counts, as (name, got, expected)."""
    return [(name, got, want.get(name, {}))
            for name, got in counts.items() if got != want.get(name, {})]


def translation_phase(pt, kernels, card):
    """Transformer-base translation at full width on the card, float32 with
    TF32 off (the script above, in a Paddle eager loop): a gradient oracle
    (a dropout-0 twin on the same weights, the kernel route against
    ``PADDLE_FUSED_LN=0`` on the kernel route's ReLU branches, per
    parameter within GRAD_RTOL of its largest value), TB_STEPS Adam steps on one fixed batch (finite, falling
    losses; B5 and B7 launched 30 times a step, on [4096, 512] float32,
    and no other kernel), then greedy decoding of TB_DECODE_B sources for
    TB_DECODE_NEW tokens through the incremental cache (B5 12 + 18 a token
    and no other kernel), its logits against one full teacher-forced
    forward over the same tokens within LOGIT_ATOL. Returns each path's
    launches by kernel."""
    import os

    paddle = pt  # the names of a dygraph script: import ... as paddle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    paddle.seed(0)
    t0 = time.perf_counter()
    model = translation_model(paddle, TB_VOCAB)
    twin = translation_model(paddle, TB_VOCAB, dropout=0.0)
    twin.set_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(0)
    src = rng.randint(2, TB_VOCAB, (TB_B, TB_S))
    src[::2, -16:] = 0  # half the rows end in 16 padding tokens
    tgt = rng.randint(2, TB_VOCAB, (TB_B, TB_S + 1))
    s, t = paddle.to_tensor(src), paddle.to_tensor(tgt[:, :-1])
    label = paddle.to_tensor(tgt[:, 1:])
    src_mask = padding_mask(paddle, s)
    tgt_mask = paddle.nn.Transformer.generate_square_subsequent_mask(TB_S)

    # ReLU's derivative jumps at 0: an input within float32 rounding of 0
    # (~3e-6 here) may take the other branch in the other route, and one
    # such element moves its linear1 gradients by ~5e-3 of their largest
    # value (measured, PERF.md). So the dense route replays the kernel
    # route's ReLU branches, and the comparison sees the LayerNorms alone;
    # the inputs that changed sides are counted and printed.
    branches, flips = [], []

    def record(x):
        keep = x > 0
        branches.append(keep)
        return x * keep

    def replay(x):
        keep = branches.pop(0)
        flips.append(int(((x > 0) != keep).sum()))
        return x * keep

    def grads(route, relu):
        os.environ["PADDLE_FUSED_LN"] = route
        for layer in list(twin.transformer.encoder.layers) \
                + list(twin.transformer.decoder.layers):
            layer.activation = relu
        loss = smoothed_loss(paddle, twin(s, t, src_mask, tgt_mask), label,
                             TB_VOCAB)
        loss.backward()
        out = {n: p.grad.clone() for n, p in twin.named_parameters()}
        twin.clear_gradients()
        return float(loss), out

    def worst(ga, gb):
        rels = {n: (ga[n] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-30) for n, g in gb.items()}
        name = max(rels, key=rels.get)
        return rels[name], name

    loss_k, g_k = grads("1", record)
    loss_d, g_d = grads("0", replay)
    # a reading: the dense route on its own branches
    free, free_name = worst(g_k, grads("0", paddle.nn.functional.relu)[1])
    os.environ.pop("PADDLE_FUSED_LN")
    rel, rel_name = worst(g_k, g_d)
    print(f"translation: Transformer-base ({n_params} float32 parameters, "
          f"vocab {TB_VOCAB}) built in {time.perf_counter() - t0:.2f} s; "
          f"gradient oracle at dropout 0, B={TB_B} S={TB_S}: loss kernels "
          f"{loss_k:.6f} dense LN {loss_d:.6f}; worst max|g_kernel - "
          f"g_dense| / max|g_dense| {rel:.3e} ({rel_name}; tolerance "
          f"{GRAD_RTOL}) on the same ReLU branches; {sum(flips)} ReLU "
          f"inputs on the other side of 0 in the dense route, which on its "
          f"own branches reads {free:.3e} ({free_name}; not gated)")
    if not all(torch.isfinite(g).all() for g in g_k.values()) \
            or rel > GRAD_RTOL or abs(loss_k - loss_d) > 1e-4:
        fail("translation: kernel-route gradients disagree with the dense "
             "LayerNorm's")
    del twin, g_k, g_d

    sched = paddle.optimizer.lr.NoamDecay(d_model=TB_D, warmup_steps=4000,
                                          learning_rate=2.0)
    opt = paddle.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                                epsilon=1e-9, parameters=model.parameters())
    losses, ms, counts = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TB_STEPS):
        kernels.reset_launches()  # the training path, one step
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = smoothed_loss(paddle, model(s, t, src_mask, tgt_mask), label,
                             TB_VOCAB)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))  # a host read: syncs
        ms.append((time.perf_counter() - t1) * 1e3)
        counts.append(kernels.launches_by_dtype())
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.mean(ms[1:]))

    model.eval()
    dsrc = s[:TB_DECODE_B]
    dmask = padding_mask(paddle, dsrc)
    with paddle.no_grad():
        kernels.reset_launches()  # the decode path
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, cached = greedy(paddle, model, dsrc, dmask, TB_DECODE_NEW)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
        decode_counts = kernels.launches_by_dtype()
        kernels.reset_launches()
        bos = paddle.full([TB_DECODE_B, 1], 1, dtype="int64")
        full = model(dsrc, paddle.concat([bos, toks[:, :-1]], axis=1), dmask,
                     paddle.nn.Transformer.generate_square_subsequent_mask(
                         TB_DECODE_NEW))
    err = float((full - cached).abs().max())
    print(f"translation training (Adam 0.9/0.98/1e-9, NoamDecay(512, 4000, "
          f"2.0), dropout 0.1, label smoothing 0.1): losses "
          f"{[f'{x:.6f}' for x in losses]}; step ms "
          f"{[f'{x:.1f}' for x in ms]}; {step_ms:.2f} ms/step (mean of steps "
          f"2-{TB_STEPS}), {TB_B * TB_S / step_ms * 1e3:.1f} target "
          f"tokens/s; peak memory {peak:.2f} GiB; {card}")
    print(f"translation greedy decode of {TB_DECODE_B} sources x "
          f"{TB_DECODE_NEW} tokens: {decode_s * 1e3:.1f} ms, "
          f"{TB_DECODE_B * TB_DECODE_NEW / decode_s:.1f} tokens/s; cached "
          f"against full logits max |err| {err:.3e} (tolerance "
          f"{LOGIT_ATOL}); {card}")
    print(f"translation launches per training step {counts[0]}; decode "
          f"{decode_counts}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("translation: the loss is not finite or did not fall")
    for i, c in enumerate(counts):
        off = _launches_off_path(c, TB_STEP_LAUNCHES)
        if off:
            fail(f"translation step {i + 1}: launches off the path {off}")
    off = _launches_off_path(decode_counts, TB_DECODE_LAUNCHES)
    if off:
        fail(f"translation decode: launches off the path {off}")
    if not err <= LOGIT_ATOL:
        fail("translation: cached decode logits disagree with the full "
             "forward")
    del model, opt
    torch.cuda.empty_cache()
    return {"translation_training": {
        name: sum(sum(c[name].values()) for c in counts)
        for name in kernels.WRAPPERS},
        "translation_decode": {name: sum(decode_counts[name].values())
                               for name in kernels.WRAPPERS}}


# -- the PTB language model, as Paddle's language_model script writes it ----
# ptb_lm and ptb_loss are the script; tests/test_torch_rnn.py imports them
# and runs them through both packages at a small size.


def ptb_lm(paddle, vocab=PTB_VOCAB, d=PTB_D, layers=PTB_LAYERS,
           dropout=PTB_DROPOUT, init=PTB_INIT):
    """Embedding, dropout, a ``layers``-deep LSTM (dropout between its
    layers), dropout, the vocabulary projection; every weight uniform in
    [-init, init]. ``forward(x, h, c) -> (logits, h, c)``."""
    nn = paddle.nn

    def attr():
        return paddle.ParamAttr(
            initializer=nn.initializer.Uniform(-init, init))

    class PtbLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(vocab, d, weight_attr=attr())
            self.lstm = nn.LSTM(d, d, num_layers=layers, dropout=dropout,
                                weight_ih_attr=attr(), weight_hh_attr=attr(),
                                bias_ih_attr=attr(), bias_hh_attr=attr())
            self.dropout = nn.Dropout(dropout)
            self.fc = nn.Linear(d, vocab, weight_attr=attr(),
                                bias_attr=attr())

        def forward(self, x, h, c):
            y, (h, c) = self.lstm(self.dropout(self.embedding(x)), (h, c))
            return self.fc(self.dropout(y)), h, c

    return PtbLM()


def ptb_loss(paddle, logits, y, vocab=PTB_VOCAB):
    return paddle.nn.functional.cross_entropy(
        logits.reshape([-1, vocab]), y.reshape([-1]))


def rnn_lm_phase(pt, kernels, card):
    """The PTB "medium" LSTM language model at full width (the constants'
    notes): a first-step oracle (dropout off) of the card's float32 step
    against the port's CPU step in float64 on the same weights and
    tokens, then six eager training steps as the script runs them (the
    state carried and detached), which must lower the loss and launch no
    kernel of the port. Returns the launches (all 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    pt.set_device("gpu")
    pt.seed(7)
    model = ptb_lm(pt)
    n_params = sum(p.numel() for p in model.parameters())
    zipf = 1.0 / np.arange(1, PTB_VOCAB + 1)
    stream = np.random.RandomState(7).choice(
        PTB_VOCAB, size=(PTB_B, PTB_T * PTB_STEPS + 1), p=zipf / zipf.sum())

    def batch(i):
        return (stream[:, i * PTB_T:(i + 1) * PTB_T],
                stream[:, i * PTB_T + 1:(i + 1) * PTB_T + 1])

    def first_step(m, device, dtype):
        m.eval()
        x, y = (torch.as_tensor(a, device=device) for a in batch(0))
        h0 = torch.zeros(PTB_LAYERS, PTB_B, PTB_D, device=device,
                         dtype=dtype)
        loss = ptb_loss(pt, m(x, h0, h0)[0], y)
        loss.backward()
        out = {n: p.grad.double().cpu() for n, p in m.named_parameters()}
        m.clear_gradients()
        m.train()
        return loss.item(), out

    loss_g, g_g = first_step(model, "cuda", torch.float32)
    pt.set_device("cpu")
    twin = ptb_lm(pt).to(dtype="float64")
    twin.set_state_dict({k: v.detach().cpu().numpy()
                         for k, v in model.state_dict().items()})
    loss_c, g_c = first_step(twin, "cpu", torch.float64)
    pt.set_device("gpu")
    del twin
    w, name = worst_grad(g_g, g_c)
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    print(f"PTB LSTM LM oracle, {n_params} float32 parameters, B={PTB_B} "
          f"T={PTB_T}, dropout off: loss card {loss_g:.7f} CPU float64 "
          f"{loss_c:.7f} (relative {loss_err:.3e}); worst max|g_card - "
          f"g_cpu64| / max|g_cpu64| {w:.3e} ({name}; tolerance {PTB_RTOL}); "
          f"{time.perf_counter() - t0:.2f} s")
    if loss_err > PTB_RTOL or w > PTB_RTOL:
        fail("PTB LSTM LM: the card's first step disagrees with the CPU's "
             "float64 step")
    del g_g, g_c

    opt = pt.optimizer.SGD(learning_rate=PTB_LR,
                           parameters=model.parameters(),
                           grad_clip=pt.nn.ClipGradByGlobalNorm(PTB_CLIP))
    h = c = pt.zeros([PTB_LAYERS, PTB_B, PTB_D])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()  # the recurrent path starts here
    losses, ms = [], []
    for i in range(PTB_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x, y = (pt.to_tensor(a) for a in batch(i))
        logits, h, c = model(x, h, c)
        loss = ptb_loss(pt, logits, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        h, c = h.detach(), c.detach()
        losses.append(loss.item())  # .item() syncs
        ms.append((time.perf_counter() - t1) * 1e3)
    counts = kernels.launches()  # and ends here
    steady = float(np.mean(ms[1:]))
    print(f"PTB LSTM LM (SGD {PTB_LR}, clip {PTB_CLIP}, dropout "
          f"{PTB_DROPOUT}, float32, eager): {steady:.2f} ms/step (mean of "
          f"steps 2-{PTB_STEPS}), {PTB_B * PTB_T / steady * 1e3:.1f} "
          f"tokens/s; step ms {[f'{t:.1f}' for t in ms]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
          f"{[f'{v:.5f}' for v in losses]}; launches {counts}; {card}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("PTB LSTM LM: loss is not finite or did not fall")
    if any(counts.values()):
        fail(f"PTB LSTM LM: a kernel of the port launched on a path that "
             f"has none: {counts}")
    del model, opt
    torch.cuda.empty_cache()
    return counts


def blockwise_bert_phase(pt, kernels, card):
    """bench.py's BERT-base with its encoder on blockwise attention,
    trained with LAMB through fleet bf16 O1 and TrainStep: first the
    gradient oracles, then six steps (losses falling, B1, B3 and B4
    twelve times a step in bf16 and the torch blockwise program never,
    B5 and B7 as on the dense route), then its dense twin's six steps
    under the same optimizer for the rate beside it. Returns both paths'
    launches.

    The oracles hold one batch's gradients on the blockwise route against
    the dense twin's with the same weights, each against the dense route
    in float64: the blockwise route's worst distance from float64 (of
    each parameter's largest gradient) may exceed the dense route's by
    GRAD_RTOL in float32 and AMP_GRAD_RTOL under bf16 O1, and their
    losses agree within the same shares. The two routes' distance from
    each other is printed too: this model's backward (post-LN, the mean
    over the sequence into a 2-way head, embeddings at XavierNormal's
    scale) moves its embedding gradients far for small differences in the
    layers above, so two float32 routes that each lie near float64 lie
    further from each other, and bf16 O1 moves both routes ~6% of the
    largest gradient from float32."""
    from paddle_tpu_torch.nn.layers import ring_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = bench_bert(pt, "blockwise")
    twin = bench_bert(pt)
    twin.load_state_dict(model.state_dict())
    ids = torch.arange(BERT_B * BERT_S, device="cuda").reshape(
        BERT_B, BERT_S) % 30000
    y = torch.arange(BERT_B, device="cuda") % 2

    def grads(m, amp_on=False):
        m.zero_grad(set_to_none=True)
        with pt.amp.auto_cast(amp_on, level="O1", dtype="bfloat16"):
            loss = pt.nn.functional.cross_entropy(m(ids), y)
        loss.backward()
        out = {k: p.grad for k, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.item(), out

    wide = bench_bert(pt).to(torch.float64)
    wide.load_state_dict(model.state_dict())
    loss_64, g_64 = grads(wide)
    del wide
    for amp_on, tol in ((False, GRAD_RTOL), (True, AMP_GRAD_RTOL)):
        kernels.reset_launches()
        loss_b, g_b = grads(model, amp_on)
        launches = kernels.launches_by_dtype()
        loss_d, g_d = grads(twin, amp_on)
        w_b, n_b = worst_grad(g_b, g_64)
        w_d, n_d = worst_grad(g_d, g_64)
        w_bd, n_bd = worst_grad(g_b, g_d)
        del g_b, g_d
        what = "bf16 O1" if amp_on else "float32"
        print(f"BERT-base blockwise gradient oracle, {what} (B={BERT_B} "
              f"S={BERT_S}, block {BERT_BLOCK}, TF32 off): loss blockwise "
              f"{loss_b:.7f} dense {loss_d:.7f} float64 {loss_64:.7f}; worst "
              f"max|g - g_float64| / max|g_float64|: blockwise {w_b:.3e} "
              f"({n_b}), dense {w_d:.3e} ({n_d}) (tolerance: dense + {tol}); "
              f"blockwise against dense {w_bd:.3e} ({n_bd}); launches "
              f"{launches}")
        if w_b > w_d + tol or abs(loss_b - loss_d) > tol * abs(loss_d):
            fail(f"BERT blockwise {what} gradients stray further from "
                 "float64 than the dense route's")
        if amp_on and launches != {k: BLOCKWISE_BERT_LAUNCHES.get(k, {})
                                   for k in launches}:
            fail(f"BERT blockwise oracle launches {launches}, expected "
                 f"{BLOCKWISE_BERT_LAUNCHES}")
    del g_64
    print(f"BERT-base oracles done in {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    scan_calls = []
    real = ra._blockwise_raw
    ra._blockwise_raw = lambda *a, **kw: scan_calls.append(1) or real(
        *a, **kw)
    blk, dns = {}, {}
    try:
        counts = bench_program_phase(
            pt, kernels, f"BERT-base on blockwise attention (block "
            f"{BERT_BLOCK}; Lamb 1e-3/0.01, bf16 AMP)", model,
            pt.optimizer.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01),
            ids, y, True, "samples", BLOCKWISE_BERT_LAUNCHES, blk)
    finally:
        ra._blockwise_raw = real
    if scan_calls:
        fail(f"BERT blockwise: the torch blockwise program ran "
             f"{len(scan_calls)} times on the card's path")
    dense_counts = bench_program_phase(
        pt, kernels, "BERT-base, its dense twin (Lamb 1e-3/0.01, bf16 AMP)",
        twin, pt.optimizer.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01),
        ids, y, True, "samples", BERT_LN_LAUNCHES, dns)
    print(f"BERT-base Lamb bf16 O1, blockwise against dense: "
          f"{blk['ms_per_step']:.2f} / {dns['ms_per_step']:.2f} ms/step, "
          f"{blk['rate']:.1f} / {dns['rate']:.1f} samples/s, peak "
          f"{blk['peak_gib']:.2f} / {dns['peak_gib']:.2f} GiB; {card}")
    return {"blockwise_bert": counts, "blockwise_bert_dense_twin":
            dense_counts}


# -- hapi's Model.fit from a multi-process DataLoader ------------------------


def _write_mnist(root, n, prefix, seed):
    """Striped MNIST images (noise and a class band) and labels as the gzip
    IDX files ``vision.datasets.MNIST`` reads."""
    import gzip
    import os
    import struct

    rng = np.random.RandomState(seed)
    labels = (np.arange(n) % 10).astype(np.uint8)
    rng.shuffle(labels)
    imgs = (rng.rand(n, 28, 28) * 50).astype(np.uint8)
    for i, lbl in enumerate(labels):
        col = (int(lbl) * 28) // 10
        imgs[i, :, col:col + 2] = 250
    with gzip.open(os.path.join(root, f"{prefix}-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(os.path.join(root, f"{prefix}-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def mnist_fit_phase(pt, kernels, card):
    """tests/reference_scripts/hapi_mnist_fit.py's program on the card:
    ``vision.datasets.MNIST`` from IDX files under a temporary
    PADDLE_DATASET_HOME, ``Model(LeNet())`` with Adam 1e-3,
    CrossEntropyLoss and Accuracy, ``fit`` for MNIST_EPOCHS epochs capped
    at MNIST_STEPS steps of MNIST_BATCH, then ``evaluate``. The last loss
    must be below the first and ``evaluate`` must report a finite
    accuracy; no kernel of the port runs. Returns the launches."""
    import os
    import tempfile

    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    t0 = time.perf_counter()
    losses = []

    class Losses(pt.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    saved = os.environ.get("PADDLE_DATASET_HOME")
    with tempfile.TemporaryDirectory() as home:
        os.makedirs(os.path.join(home, "mnist"))
        _write_mnist(os.path.join(home, "mnist"), 512, "train", 0)
        _write_mnist(os.path.join(home, "mnist"), 256, "t10k", 1)
        os.environ["PADDLE_DATASET_HOME"] = home
        try:
            train, val = MNIST(mode="train"), MNIST(mode="test")
        finally:
            if saved is None:
                del os.environ["PADDLE_DATASET_HOME"]
            else:
                os.environ["PADDLE_DATASET_HOME"] = saved
    pt.set_device("gpu")
    pt.seed(3)
    np.random.seed(3)
    model = pt.Model(LeNet())
    optim = pt.optimizer.Adam(learning_rate=0.001,
                              parameters=model.parameters())
    model.prepare(optim, pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    kernels.reset_launches()  # the LeNet fit path starts here
    model.fit(train, epochs=MNIST_EPOCHS, batch_size=MNIST_BATCH,
              num_iters=MNIST_STEPS, verbose=2, callbacks=[Losses()])
    result = model.evaluate(val, batch_size=MNIST_BATCH, verbose=0)
    counts = kernels.launches()  # and ends here
    print(f"LeNet MNIST Model.fit (hapi_mnist_fit.py's program): losses "
          f"{[f'{v:.5f}' for v in losses]}; evaluate {result}; launches "
          f"{counts}; {time.perf_counter() - t0:.2f} s; {card}")
    if not (len(losses) == MNIST_STEPS and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        fail("LeNet MNIST fit: the loss is not finite or did not fall")
    if not np.isfinite(result.get("acc", np.nan)):
        fail("LeNet MNIST fit: evaluate reported no accuracy")
    if any(counts.values()):
        fail(f"LeNet MNIST fit: a kernel of the port launched: {counts}")
    return counts


def _fit_model(pt, net):
    """``Model(net)`` prepared as the phase trains it."""
    opt = pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=net.parameters(),
        weight_decay=pt.regularizer.L2Decay(1e-4))
    model = pt.Model(net)
    model.prepare(opt, pt.nn.CrossEntropyLoss(),
                  pt.metric.Accuracy(topk=(1, 5)))
    return model


def _params(net):
    return {n: t.detach().clone() for n, t in net.state_dict().items()}


def model_fit_phase(pt, kernels, card):
    """ResNet-50 through hapi's ``Model.fit`` from a multi-process
    DataLoader at full width (the constants' notes), float32 with TF32 off.
    Gates: the staging library is available and every batch's fused
    collation ran in it; the first ``train_batch`` loss equals, bit for
    bit, a ``TrainStep`` driven directly from the same weights on the same
    batch; losses are finite; ``evaluate``'s top-1 and top-5 equal those
    recomputed from ``predict``'s outputs on the same batches; a
    checkpoint that ``ModelCheckpoint`` wrote passes ``crc32_file`` before
    and after ``Model.load`` and resumes a fresh model and optimizer whose
    next ``train_batch`` gives the uninterrupted model's loss and
    parameters bit for bit (cuDNN deterministic for those two steps); no
    kernel of the port runs. Prints imgs/s of ``fit`` (loader included,
    batches 2-8) beside the same model's ``train_batch`` on a batch
    already on the card, the consumer's wait on the loader per batch,
    the host-to-device copy per batch, the time of one ``Model.save`` and
    peak memory. Returns the launches."""
    import shutil
    import tempfile

    from paddle_tpu_torch import native
    from paddle_tpu_torch.framework.io import crc32_file
    from paddle_tpu_torch.hapi.callbacks import Callback, ModelCheckpoint
    from paddle_tpu_torch.io import DataLoader, vision_collate_fn
    from paddle_tpu_torch.io.dataloader import LoaderTiming
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import resnet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if not native.available():
        fail(f"the native staging library is not available on the card's "
             f"host: {native.build_error()}")
    shm = shutil.disk_usage("/dev/shm")
    fits = shm.free // FIT_BATCH_BYTES
    print(f"/dev/shm: total {shm.total}, free {shm.free} bytes; one float32 "
          f"batch {FIT_BATCH_BYTES} bytes; {fits} fit")
    if fits < FIT_WORKERS:
        fail(f"/dev/shm holds {fits} batches of {FIT_BATCH_BYTES} bytes: "
             f"{FIT_WORKERS} workers keep at least {FIT_WORKERS} in flight")
    prefetch = min(2, fits // FIT_WORKERS)

    pt.set_device("gpu")
    gen = torch.Generator(device="cuda").manual_seed(12)
    net = resnet50(num_classes=1000, generator=gen)
    init = _params(net)
    model = _fit_model(pt, net)
    train = ImageNetLike(FIT_STEPS * FIT_BATCH, T.Compose([
        T.RandomResizedCrop(FIT_CROP), T.RandomHorizontalFlip()]))
    loader = DataLoader(train, batch_size=FIT_BATCH, shuffle=True,
                        drop_last=True, num_workers=FIT_WORKERS,
                        use_shared_memory=True, prefetch_factor=prefetch,
                        collate_fn=vision_collate_fn)
    loader.timing = LoaderTiming()

    class FirstBatch:
        """The loader's batches, keeping the first."""

        def __init__(self):
            self.first = None

        def __len__(self):
            return len(loader)

        def __iter__(self):
            for b in loader:
                if self.first is None:
                    self.first = b
                yield b

    stamps, losses, accs = [], [], []

    class Clock(Callback):
        def on_train_batch_end(self, step, logs=None):
            stamps.append(time.perf_counter())  # logs hold host floats
            losses.append(logs["loss"])
            accs.append((logs["acc_top1"], logs["acc_top5"]))

    batches = FirstBatch()
    tmp = tempfile.TemporaryDirectory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()  # the Model.fit path starts here
    native.reset_calls()
    t_fit = time.perf_counter()
    model.fit(batches, epochs=1, verbose=2, log_freq=1,
              callbacks=[ModelCheckpoint(save_dir=tmp.name), Clock()])
    fit_s = time.perf_counter() - t_fit
    staged = native.calls()
    x, y = batches.first
    if not (x.shape == [FIT_BATCH, 3, FIT_CROP, FIT_CROP]
            and x.dtype == torch.float32 and x.place.kind == "gpu"
            and y.dtype == torch.int64 and y.place.kind == "gpu"):
        fail(f"Model.fit: a loader batch is {x.shape} {x.dtype} on "
             f"{x.place}, labels {y.dtype} on {y.place}")
    fit_rate = (len(stamps) - 1) * FIT_BATCH / (stamps[-1] - stamps[0])
    # one batch's copy from pinned memory with nothing else running
    pinned = torch.empty(FIT_BATCH_BYTES, dtype=torch.uint8,
                         pin_memory=True)
    dev = torch.empty(FIT_BATCH_BYTES, dtype=torch.uint8, device="cuda")
    alone = time_ms(lambda: dev.copy_(pinned, non_blocking=True), calls=1,
                    reps=5)
    del pinned, dev
    waits = np.asarray(loader.timing.wait_s) * 1e3
    stage = np.asarray(loader.timing.stage_s) * 1e3
    decode = np.asarray(loader.timing.decode_s) * 1e3
    h2d = np.asarray(loader.timing.h2d_ms())
    step_ms = np.diff(stamps) * 1e3
    print(f"ResNet-50 Model.fit (Momentum 0.1/0.9, L2Decay 1e-4, float32, "
          f"TF32 off; {FIT_WORKERS} process workers, prefetch_factor "
          f"{prefetch}, vision_collate_fn; consumer waits on the pinning "
          f"thread's queue): {fit_rate:.1f} imgs/s over "
          f"batches 2-{len(stamps)} (loader included); fit() {fit_s:.2f} s "
          f"with worker start-up and 2 checkpoints; losses "
          f"{[f'{v:.5f}' for v in losses]}; top-1/top-5 {accs[-1]}; wait "
          f"on the loader per batch: first {waits[0]:.2f} ms, then mean "
          f"{waits[1:].mean():.2f} / max {waits[1:].max():.2f} ms; "
          f"/dev/shm decode into pinned memory (pinning thread) mean "
          f"{decode.mean():.2f} / max {decode.max():.2f} ms; copies' launch "
          f"(consumer; the first batches allocate their pinned buffers) ms "
          f"{[f'{t:.2f}' for t in stage]}; between events around them "
          f"(device) ms {[f'{t:.3f}' for t in h2d]}; one batch's copy "
          f"alone {alone:.3f} ms; step ms "
          f"{[f'{t:.1f}' for t in step_ms]}; native staging calls {staged}")
    if len(losses) != FIT_STEPS or not all(np.isfinite(losses)):
        fail(f"Model.fit: losses {losses}")
    if not (staged["stack_u8_to_f32"]["native"] >= FIT_STEPS
            and staged["stack_u8_to_f32"]["numpy"] == 0):
        fail(f"Model.fit: the loader did not collate through the native "
             f"staging library: {staged}")

    # the first train_batch against TrainStep from the same weights
    twin = resnet50(num_classes=1000, generator=gen)
    twin.set_state_dict(init)
    del init
    opt = pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=twin.parameters(),
        weight_decay=pt.regularizer.L2Decay(1e-4))
    ce = pt.nn.CrossEntropyLoss()
    twin.train()
    step_loss = pt.jit.TrainStep(twin, lambda out, lab: ce(out, lab), opt)(
        x, y).item()
    print(f"first train_batch loss {losses[0]!r}, TrainStep on the same "
          f"weights and batch {step_loss!r}")
    if step_loss != losses[0]:
        fail("Model.fit's first step differs from TrainStep's")
    del twin, opt

    # resume: the final checkpoint into a fresh model and optimizer
    ckpt = f"{tmp.name}/final"
    crc = crc32_file(ckpt + ".pdparams")
    fresh = _fit_model(pt, resnet50(num_classes=1000, generator=gen))
    fresh.load(ckpt)
    crc_after = crc32_file(ckpt + ".pdparams")
    torch.backends.cudnn.deterministic = True
    try:
        cont = model.train_batch([x], [y])
        resumed = fresh.train_batch([x], [y])
        a, b = _params(model.network), _params(fresh.network)
    finally:
        torch.backends.cudnn.deterministic = False
    same = all(torch.equal(a[k], b[k]) for k in a)
    print(f"resume from {ckpt}: crc32 {crc:#010x} before load, "
          f"{crc_after:#010x} after; next step uninterrupted {cont[0]!r}, "
          f"resumed {resumed[0]!r}; parameters and buffers bitwise equal: "
          f"{same}")
    if crc != crc_after:
        fail("Model.load changed the checkpoint's crc32")
    if cont[0] != resumed[0] or not same:
        fail("a resumed Model does not continue bit for bit")
    del fresh, a, b

    t1 = time.perf_counter()
    model.save(f"{tmp.name}/timed")
    save_s = time.perf_counter() - t1
    nbytes = sum(os.path.getsize(f"{tmp.name}/timed{e}")
                 for e in (".pdparams", ".pdopt"))

    # evaluate and predict on the same batches
    evals = DataLoader(ImageNetLike(FIT_EVAL_BATCHES * FIT_BATCH,
                                    T.CenterCrop(FIT_CROP), seed=10 ** 6),
                       batch_size=FIT_BATCH, num_workers=2,
                       use_shared_memory=False, collate_fn=vision_collate_fn)
    result = model.evaluate(evals, verbose=0)
    logits = model.predict(evals, stack_outputs=True, verbose=0)[0]
    labels = np.arange(FIT_EVAL_BATCHES * FIT_BATCH) % 1000
    order = np.argsort(-logits, axis=-1, kind="stable")
    want = [float((order[:, :k] == labels[:, None]).any(-1).sum()
                  / len(labels)) for k in (1, 5)]
    got = [result["acc_top1"], result["acc_top5"]]
    print(f"evaluate on {FIT_EVAL_BATCHES} batches: {result}; from "
          f"predict's outputs top-1/top-5 {want}")
    if got != want:
        fail("evaluate's accuracy differs from predict's outputs")

    # the same model on a batch already on the card
    ms = []
    for _ in range(BENCH_STEPS):
        t1 = time.perf_counter()
        model.train_batch([x], [y])  # reads the loss: synchronizes
        ms.append((time.perf_counter() - t1) * 1e3)
    steady = float(np.mean(ms[1:]))
    counts = kernels.launches()  # the path ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"ResNet-50 Model: {FIT_BATCH / steady * 1e3:.1f} imgs/s on a "
          f"batch staged on the card ({steady:.2f} ms/step, mean of steps "
          f"2-{BENCH_STEPS}) against {fit_rate:.1f} through the loader "
          f"({fit_rate / (FIT_BATCH / steady * 1e3):.3f}x); Model.save "
          f"{save_s * 1e3:.1f} ms for {nbytes} bytes (fsync included); peak "
          f"memory {peak:.2f} GiB; launches {counts}; "
          f"{time.perf_counter() - t0:.2f} s; {card}")
    if any(counts.values()):
        fail(f"Model.fit: a kernel of the port launched: {counts}")
    tmp.cleanup()
    del model, net, loader, batches, x, y
    torch.cuda.empty_cache()
    return counts


# -- the verbatim reference scripts through the port's paddle route --------


def write_housing(root, n=400, seed=2):
    """A UCI housing file (``housing.data``: 14 whitespace-separated
    columns, 13 features and a target from a planted linear map plus
    noise) as ``text.datasets.UCIHousing`` reads it."""
    import os

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 13) * 10.0
    y = x @ rng.randn(13) + 1.0 + rng.randn(n) * 0.1
    with open(os.path.join(root, "housing.data"), "w") as f:
        for row in np.concatenate([x, y[:, None]], axis=1):
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")


def run_reference_scripts(home, device=None, timeout=600, only=None):
    """Each script of tests/reference_scripts/ (or the one named ``only``)
    verbatim through ``python -m paddle_tpu_torch.run [--device cpu]`` in a
    subprocess of its own, the four at once, with
    PADDLE_DATASET_HOME=``home`` and REF_SCRIPTS' caps. Returns {script: (exit code, stdout, stderr, seconds, losses,
    the launcher's exit line as (device, peak bytes, jax loaded,
    paddle_tpu loaded, {kernel: launches}) or None)}."""
    import os
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for name, caps in REF_SCRIPTS.items():
        if only is not None and name != only:
            continue
        env = dict(os.environ, PADDLE_DATASET_HOME=home, **caps)
        cmd = [sys.executable, "-m", "paddle_tpu_torch.run"]
        cmd += ["--device", device] if device else []
        cmd.append(os.path.join(root, "tests", "reference_scripts", name))
        procs[name] = (time.perf_counter(), subprocess.Popen(
            cmd, cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (t0, proc) in procs.items():
        try:
            so, se = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            so, se = proc.communicate()
        m = re.search(RUN_EXIT_PATTERN, se)
        exit_line = None if m is None else (
            m.group(1), int(m.group(2)), m.group(3) == "True",
            m.group(4) == "True", json.loads(m.group(5)))
        losses = [float(v) for v in re.findall(REF_LOSS_PATTERN, so)]
        out[name] = (proc.returncode, so, se, time.perf_counter() - t0,
                     losses, exit_line)
    return out


def reference_scripts_phase(card):
    """The four verbatim scripts on the card through the launcher: each
    must exit 0, its loss fall, and its exit line name a CUDA device with
    peak memory above 0, no jax or paddle_tpu module loaded and no kernel
    launched."""
    import os
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as home:
        os.makedirs(os.path.join(home, "mnist"))
        _write_mnist(os.path.join(home, "mnist"), 512, "train", 0)
        _write_mnist(os.path.join(home, "mnist"), 256, "t10k", 1)
        write_housing(os.path.join(home, "uci_housing"))
        runs = run_reference_scripts(home)
    for name, (rc, so, se, sec, losses, line) in runs.items():
        print(f"verbatim {name} through paddle_tpu_torch.run: exit {rc}, "
              f"{sec:.2f} s, losses {losses}, exit line {line}")
        if rc != 0:
            fail(f"verbatim {name} exited {rc}:\n{so[-2000:]}\n{se[-3000:]}")
        if len(losses) < 2 or not losses[-1] < losses[0]:
            fail(f"verbatim {name}: the loss did not fall: {losses}")
        if line is None or not line[0].startswith("cuda") or line[1] <= 0:
            fail(f"verbatim {name}: the run was not on the card: {line}")
        if line[2] or line[3]:
            fail(f"verbatim {name}: jax or paddle_tpu was loaded: {line}")
        if any(line[4].values()):
            fail(f"verbatim {name}: kernels launched: {line[4]}")
    print(f"verbatim reference scripts done in "
          f"{time.perf_counter() - t0:.2f} s (the four at once); {card}")


# -- bench.py's BERT-base as a static program --------------------------------


def static_bert(paddle, vocab=BERT_VOCAB, d=BERT_D, heads=BERT_HEADS,
                layers=BERT_LAYERS, max_pos=BERT_POS, **kw):
    """bench.py's ``_bert_base`` as a Paddle script writes it with
    ``paddle`` (either package): token and position embeddings, post-LN
    ``TransformerEncoderLayer`` s (ffn 4 d, dropout 0), the mean over the
    sequence, a 2-way head. The position ids are an input beside the token
    ids (``position_ids``), so that a static program reads both from its
    feeds. ``kw`` goes to each layer (the port's ``device`` and
    ``generator``)."""

    class Bert(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = paddle.nn.Embedding(vocab, d, **kw)
            self.pos = paddle.nn.Embedding(max_pos, d, **kw)
            self.encoder = paddle.nn.LayerList([
                paddle.nn.TransformerEncoderLayer(d, heads, 4 * d,
                                                  dropout=0.0, **kw)
                for _ in range(layers)])
            self.head = paddle.nn.Linear(d, 2, **kw)

        def forward(self, ids, pos):
            h = self.embed(ids) + self.pos(pos)
            for lyr in self.encoder:
                h = lyr(h)
            return self.head(paddle.mean(h, axis=1))

    return Bert()


def static_bert_program(paddle, model, batch, seq, lr=1e-4, wd=0.01):
    """``model`` (``static_bert``) as a static program: the main and
    startup programs, fixed [batch, seq] int64 ``ids`` and ``pos`` and
    [batch] int64 ``label`` placeholders, the cross entropy and
    ``AdamW(lr, wd).minimize``. Returns (main, startup, loss)."""
    main, startup = paddle.static.Program(), paddle.static.Program()
    with paddle.static.program_guard(main, startup):
        ids = paddle.static.data("ids", [batch, seq], "int64")
        pos = paddle.static.data("pos", [batch, seq], "int64")
        label = paddle.static.data("label", [batch], "int64")
        loss = paddle.nn.functional.cross_entropy(model(ids, pos), label)
        paddle.optimizer.AdamW(learning_rate=lr,
                               weight_decay=wd).minimize(loss)
    return main, startup, loss


def static_bert_phase(pt, kernels, card):
    """bench.py's BERT-base as a static program on the card beside an
    eager twin on the same weights and batch (the gate of step 20 of this
    script's docstring), a static run and an eager step in turns. Returns
    the static path's launches a run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    pt.set_device("gpu")
    gen = dict(device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(15))
    model = static_bert(pt, **gen)
    twin = static_bert(pt, **gen)
    twin.set_state_dict(model.state_dict())
    ids = (np.arange(BERT_B * BERT_S).reshape(BERT_B, BERT_S) % 30000
           ).astype(np.int64)
    pos = np.tile(np.arange(BERT_S, dtype=np.int64), (BERT_B, 1))
    y = (np.arange(BERT_B) % 2).astype(np.int64)
    feed = {"ids": ids, "pos": pos, "label": y}
    t_models = time.perf_counter() - t0
    pt.enable_static()
    try:
        t0 = time.perf_counter()
        main, startup, loss = static_bert_program(pt, model, BERT_B, BERT_S)
        t_build = time.perf_counter() - t0
        exe = pt.static.Executor(pt.CUDAPlace(0))
        exe.run(startup)
    finally:
        pt.disable_static()
    F = pt.nn.functional
    opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                             parameters=twin.parameters())
    ids_t, pos_t, y_t = pt.to_tensor(ids), pt.to_tensor(pos), pt.to_tensor(y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = {"static": ([], [], []), "eager": ([], [], [])}  # loss, ms, runs
    # the allocator's new segments (cudaMalloc calls) in each run: the
    # first runs of either path take new ones, which their times show
    segments = {"static": [], "eager": []}
    for i in range(STATIC_BERT_RUNS):
        for path in ("static", "eager"):
            seg0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
            kernels.reset_launches()  # one run of this path
            t1 = time.perf_counter()
            if path == "static":
                pt.enable_static()
                try:
                    (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
                finally:
                    pt.disable_static()
            else:
                lv = F.cross_entropy(twin(ids_t, pos_t), y_t)
                lv.backward()
                opt.step()
                opt.clear_grad()
            lv = float(lv)  # a host value: synchronized
            losses, ms, counts = runs[path]
            ms.append((time.perf_counter() - t1) * 1e3)
            counts.append(kernels.launches())  # and ends here
            losses.append(lv)
            segments[path].append(torch.cuda.memory_stats().get(
                "segment.all.allocated", 0) - seg0)
        if i == 0:
            bits, worst, worst_name = True, 0.0, ""
            for (n, a), b in zip(model.named_parameters(),
                                 twin.parameters()):
                bits = bits and torch.equal(a, b)
                w = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)
                     ).item()
                if w > worst:
                    worst, worst_name = w, n
    peak = torch.cuda.max_memory_allocated()
    (losses, ms, counts), (e_losses, e_ms, e_counts) = runs.values()
    steady, e_steady = float(np.mean(ms[1:])), float(np.mean(e_ms[1:]))
    print(f"BERT-base static program (B={BERT_B} S={BERT_S}, AdamW "
          f"1e-4/0.01, float32, TF32 off): two models built in "
          f"{t_models:.2f} s, {len(main.ops)} ops recorded in {t_build:.2f} "
          f"s; first run against the eager step: loss {losses[0]!r} / "
          f"{e_losses[0]!r}, parameters bit-equal {bits}, worst max|static "
          f"- eager| / max|eager| {worst:.3e} ({worst_name}; tolerance "
          f"{STATIC_BERT_ATOL}); losses {[f'{v:.6f}' for v in losses]}, "
          f"eager {[f'{v:.6f}' for v in e_losses]}; {steady:.2f} ms/run "
          f"(mean of runs 2-{STATIC_BERT_RUNS}) against eager {e_steady:.2f} "
          f"ms/step, in turns; run ms {[f'{t:.1f}' for t in ms]}, eager "
          f"{[f'{t:.1f}' for t in e_ms]}; new allocator segments "
          f"{segments['static']}, eager {segments['eager']}; peak memory "
          f"(both models) "
          f"{peak / 2**30:.2f} GiB; launches a run {counts[0]}, eager step "
          f"{e_counts[0]}; {card}")
    if abs(losses[0] - e_losses[0]) > STATIC_BERT_ATOL * abs(e_losses[0]):
        fail("static BERT: the first run's loss is not the eager step's")
    if not bits and worst > STATIC_BERT_ATOL:
        fail("static BERT: the parameters after the first run differ from "
             "the eager step's")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("static BERT: the losses are not finite or did not fall")
    for c, e in zip(counts, e_counts):
        if c != e or any(v for k, v in c.items() if k not in (
                "layer_norm_fwd", "layer_norm_bwd")):
            fail(f"static BERT: launches a run {c}, the eager step's {e} "
                 "(B5 and B7 only)")
    if not (e_counts[0]["layer_norm_fwd"] == e_counts[0]["layer_norm_bwd"]
            == 2 * BERT_LAYERS):
        fail(f"static BERT: the eager step launched {e_counts[0]}")
    del model, twin, opt, exe, main, startup, loss
    torch.cuda.empty_cache()
    return counts[0]


def to_static_phase(pt, kernels, card):
    """bench.py's GPT-medium program (``_gpt_medium`` and ``_bench_gpt``'s
    loss) as the dygraph phase builds it, float32 with TF32 off, AdamW(1e-4,
    weight decay 0.01), B = TRAIN_B, S = TRAIN_S: ``model =
    paddle.jit.to_static(model)`` takes TO_STATIC_STEPS steps of the eager
    loop beside an eager twin on the same weights and ids, in turns. Fails
    unless each step's loss agrees within DYGRAPH_LOSS_RTOL, every
    parameter's first-step gradient within DYGRAPH_GRAD_RTOL of its
    largest value, each kernel launched in float32 as often a step as in
    the eager step (DYGRAPH_LAUNCHES), and the program cache holds one
    entry. Then one step of the twin with each block under
    ``paddle.jit.recompute`` against its plain step on the same weights:
    gradients within DYGRAPH_GRAD_RTOL, the forward kernels twice a block
    (RECOMPUTE_LAUNCHES), a lower peak. Returns the launches of the
    to_static steps and of the recompute step."""
    paddle = pt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    paddle.seed(0)
    model = _gpt_medium()
    twin = _gpt_medium()
    twin.set_state_dict(model.state_dict())
    n = TRAIN_B * TRAIN_S
    ids = paddle.to_tensor((np.arange(n) % 31000).reshape(TRAIN_B, TRAIN_S))
    labels = paddle.to_tensor(((np.arange(n) + 1) % 31000).reshape(
        TRAIN_B, TRAIN_S))
    model = paddle.jit.to_static(model)
    runs = {}
    for name, m in (("to_static", model), ("eager", twin)):
        opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                     parameters=m.parameters())
        runs[name] = dict(model=m, opt=opt, loss_of=_bench_lm_loss(m),
                          losses=[], ms=[], counts=[], grads={}, peak=0)
    torch.cuda.synchronize()
    for i in range(TO_STATIC_STEPS):
        for name, r in runs.items():  # a static step and an eager one
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            loss = r["loss_of"](r["model"](ids), labels)
            loss.backward()
            if i == 0:
                r["grads"] = {k: p.grad.clone()
                              for k, p in r["model"].named_parameters()}
            r["opt"].step()
            r["opt"].clear_grad()
            r["losses"].append(float(loss))  # a host read: syncs
            r["ms"].append((time.perf_counter() - t1) * 1e3)
            r["counts"].append(kernels.launches_by_dtype())  # ends here
            r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
    kernels.reset_launches()
    s, e = runs["to_static"], runs["eager"]
    cache = model.forward.program_cache
    capture_s = sum(p.capture_s for p in cache.values())
    worst, worst_name = 0.0, ""
    for k, ge in e["grads"].items():
        gs = s["grads"].get(k)
        if gs is None or not bool(torch.isfinite(gs).all()):
            fail(f"to_static: no finite gradient for {k}")
        rel = (gs - ge).abs().max().item() / max(ge.abs().max().item(),
                                                 1e-30)
        if rel > worst:
            worst, worst_name = rel, k
    if set(s["grads"]) != set(e["grads"]):
        fail("to_static: the runs differ in which parameters got gradients")
    s["grads"] = e["grads"] = None
    print(f"to_static (bench GPT-medium, float32, B={TRAIN_B} S={TRAIN_S}, "
          f"AdamW 1e-4/0.01): losses {[f'{x:.7f}' for x in s['losses']]}, "
          f"eager {[f'{x:.7f}' for x in e['losses']]}; first-step "
          f"gradients: worst max|g_static - g_eager| / max|g_eager| "
          f"{worst:.3e} ({worst_name}; tolerance {DYGRAPH_GRAD_RTOL}); "
          f"captured in {capture_s:.2f} s, {len(cache)} program(s) cached")
    print(f"to_static ms/step (host clock, median of steps 2-"
          f"{TO_STATIC_STEPS}, in turns): to_static "
          f"{float(np.median(s['ms'][1:])):.2f}, eager "
          f"{float(np.median(e['ms'][1:])):.2f}; step ms to_static "
          f"{[f'{x:.1f}' for x in s['ms']]}, eager "
          f"{[f'{x:.1f}' for x in e['ms']]}; peak memory to_static "
          f"{s['peak'] / 2**30:.2f} GiB, eager {e['peak'] / 2**30:.2f} GiB "
          f"(both models held); {card}")
    print(f"to_static launches per step {s['counts'][0]}; eager "
          f"{e['counts'][0]}")
    for i, (ls, le) in enumerate(zip(s["losses"], e["losses"])):
        if not np.isfinite(ls) or abs(ls - le) > DYGRAPH_LOSS_RTOL * abs(le):
            fail(f"to_static step {i + 1}: loss {ls} against eager {le}")
    if worst > DYGRAPH_GRAD_RTOL:
        fail("to_static: first-step gradients disagree with the eager "
             "step's")
    for i, (cs, ce) in enumerate(zip(s["counts"], e["counts"])):
        if cs != ce or any(cs[k] != w for k, w in DYGRAPH_LAUNCHES.items()):
            fail(f"to_static step {i + 1}: launches {cs}, eager {ce}, "
                 f"expected {DYGRAPH_LAUNCHES}")
    if len(cache) != 1:
        fail(f"to_static: {len(cache)} programs cached after "
             f"{TO_STATIC_STEPS} steps")
    static_counts = {k: sum(sum(c[k].values()) for c in s["counts"])
                     for k in DYGRAPH_LAUNCHES}
    del runs, s, e, model
    torch.cuda.empty_cache()

    # recompute: each block of the twin under paddle.jit.recompute
    lm_loss = _bench_lm_loss(twin)

    def forward(recompute):
        T = ids.shape[1]
        h = twin.embed(ids) + twin.pos(paddle.arange(T, dtype="int64"))
        for blk in twin.blocks:
            h = paddle.jit.recompute(blk, h) if recompute else blk(h)
        return h

    out = {}
    for name in ("plain", "recompute"):
        twin.clear_gradients()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t1 = time.perf_counter()
        loss = lm_loss(forward(name == "recompute"), labels)
        loss.backward()
        lv = float(loss)
        ms = (time.perf_counter() - t1) * 1e3
        out[name] = dict(loss=lv, ms=ms,
                         counts=kernels.launches_by_dtype(),  # ends here
                         peak=torch.cuda.max_memory_allocated(),
                         grads={k: p.grad.clone()
                                for k, p in twin.named_parameters()})
    kernels.reset_launches()
    worst, worst_name = 0.0, ""
    for k, g in out["plain"]["grads"].items():
        rel = (out["recompute"]["grads"][k] - g).abs().max().item() \
            / max(g.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, k
    p, r = out["plain"], out["recompute"]
    print(f"recompute (each of the {LAYERS} blocks): loss {r['loss']!r} / "
          f"plain {p['loss']!r}; gradients: worst max|g_recompute - "
          f"g_plain| / max|g_plain| {worst:.3e} ({worst_name}); step ms "
          f"{r['ms']:.1f}, plain {p['ms']:.1f} (forward + backward, no "
          f"update); peak memory {r['peak'] / 2**30:.2f} GiB, plain "
          f"{p['peak'] / 2**30:.2f} GiB; launches {r['counts']}; {card}")
    if worst > DYGRAPH_GRAD_RTOL or not np.isfinite(r["loss"]):
        fail("recompute: gradients disagree with the plain step's")
    if r["counts"] != RECOMPUTE_LAUNCHES:
        fail(f"recompute: launches {r['counts']}, expected "
             f"{RECOMPUTE_LAUNCHES}")
    if not r["peak"] < p["peak"]:
        fail("recompute: peak memory not below the plain step's")
    del out, twin, lm_loss
    torch.cuda.empty_cache()
    return {"to_static": static_counts,
            "to_static_recompute": {k: sum(v.values()) for k, v in
                                    r["counts"].items()}}


#: the serving side of jit_save_phase, run in a process of its own that
#: imports the port and neither this script nor any module that defines
#: the model; argv: artifact path, ids (.npy), output directory
SERVE_ARTIFACT = r"""
import json, sys, time
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import paddle_tpu_torch as paddle
from paddle_tpu_torch.ops import kernels
path, ids_file, out = sys.argv[1:4]
ids = np.load(ids_file)
report = {}
t = time.perf_counter()
layer = paddle.jit.load(path)
torch.cuda.synchronize()
report["load_ms"] = (time.perf_counter() - t) * 1e3
x = paddle.to_tensor(ids)
with paddle.no_grad():
    kernels.reset_launches()
    logits = layer(x)
    report["jit_load_launches"] = kernels.launches_by_dtype()
    np.save(out + "/jit_load.npy", logits.numpy())
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        layer(x)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    report["forward_ms"] = ms
config = paddle.inference.Config(path + ".pdmodel")
config.enable_use_gpu(100, 0)
predictor = paddle.inference.create_predictor(config)
predictor.get_input_handle(predictor.get_input_names()[0]).copy_from_cpu(ids)
kernels.reset_launches()
predictor.run()
report["inference_launches"] = kernels.launches_by_dtype()
name = predictor.get_output_names()[0]
np.save(out + "/inference.npy",
        predictor.get_output_handle(name).copy_to_cpu())
report["device"] = torch.cuda.get_device_name(0)
report["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "paddle_tpu", "chip_smoke", "bench", "paddle"))
print(json.dumps(report))
"""


def jit_save_phase(pt, kernels, card):
    """The same GPT-medium program with its head (ids -> logits), float32,
    TF32 off, in ``eval()``: ``paddle.jit.save`` at ``InputSpec([SAVE_B,
    SAVE_S], "int64")``, then, in a process that imports the port and
    neither this script nor any module defining the model, ``paddle.jit.
    load(path)(ids)`` and ``inference.create_predictor(Config(path))``
    through ``copy_from_cpu`` / ``run`` / ``copy_to_cpu``. Fails unless
    both give the eager forward's logits (bit-equal, or within
    SAVE_LOGIT_RTOL of the largest |logit|), each launches every kernel as
    often as the eager forward, and the process loaded no ``jax``,
    ``paddle_tpu`` or model-defining module. Returns the launches of the
    two loaded forwards."""
    import tempfile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_device("gpu")
    pt.seed(16)

    class WithHead(pt.nn.Layer):
        """bench.py's GPT program with its head applied: ids -> logits."""

        def __init__(self, gpt):
            super().__init__()
            self.gpt = gpt

        def forward(self, ids):
            return self.gpt.head(self.gpt(ids))

    lm = WithHead(_gpt_cut(SAVE_LAYERS))
    lm.eval()
    ids = (np.arange(SAVE_B * SAVE_S) % 31000).reshape(SAVE_B, SAVE_S)
    with pt.no_grad():
        kernels.reset_launches()
        want = lm(pt.to_tensor(ids))
        eager_counts = kernels.launches_by_dtype()  # the eager forward
        kernels.reset_launches()
    want = want._data.float()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gpt_medium")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pt.jit.save(lm, path, input_spec=[pt.jit.InputSpec(
            [SAVE_B, SAVE_S], "int64")])
        save_ms = (time.perf_counter() - t1) * 1e3
        nbytes = {s: os.path.getsize(path + s)
                  for s in (".pdmodel", ".pdiparams", ".pdmeta")}
        del lm
        torch.cuda.empty_cache()
        np.save(os.path.join(tmp, "ids.npy"), ids)
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, "-c", SERVE_ARTIFACT, path,
             os.path.join(tmp, "ids.npy"), tmp], capture_output=True,
            text=True, env=env, cwd=tmp, timeout=600)
        if proc.returncode != 0:
            fail(f"jit.save: serving the artifact failed:\n"
                 f"{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        got = {k: torch.from_numpy(np.load(os.path.join(tmp, k + ".npy")))
               for k in ("jit_load", "inference")}
    want = want.cpu()
    scale = want.abs().max().item()
    errs = {k: (v - want).abs().max().item() / scale for k, v in got.items()}
    bits = {k: torch.equal(v, want) for k, v in got.items()}
    print(f"jit.save (bench GPT-medium with its head, float32, eval, "
          f"[{SAVE_B}, {SAVE_S}] int64): save {save_ms:.1f} ms, artifact "
          f"{sum(nbytes.values())} bytes ({nbytes}); served in a process "
          f"of its own on {report['device']}: jit.load {report['load_ms']:.1f}"
          f" ms, forward ms {[f'{x:.2f}' for x in report['forward_ms']]}; "
          f"logits against the eager forward's: bit-equal {bits}, max|err| "
          f"/ max|logit| {errs} (tolerance {SAVE_LOGIT_RTOL}); modules of "
          f"jax, paddle_tpu or the model's source loaded: "
          f"{report['modules']}; launches jit.load "
          f"{report['jit_load_launches']}, inference "
          f"{report['inference_launches']}, eager {eager_counts}; {card}")
    for k in got:
        if not bits[k] and not errs[k] <= SAVE_LOGIT_RTOL:
            fail(f"jit.save: {k} logits disagree with the eager forward's")
        if report[f"{k}_launches"] != eager_counts:
            fail(f"jit.save: {k} launches {report[f'{k}_launches']}, the "
                 f"eager forward's {eager_counts}")
    if report["modules"]:
        fail(f"jit.save: the serving process loaded {report['modules']}")
    for name in SERVING_KERNELS:
        if eager_counts[name] != {"float32": SAVE_LAYERS}:
            fail(f"jit.save: the eager forward launched {eager_counts}")
    torch.cuda.empty_cache()
    return {k: {n: sum(v.values()) for n, v in report[f"{k}_launches"].items()}
            for k in ("jit_load", "inference")}


# -- phase (a): bench's GPT-medium guarded, checkpointed and observed -------
# The guard reads its state every GUARD_SYNC_EVERY steps; gate 1 runs
# GUARD_STEPS steps with the guard off, then on (bit-equal), then a traced
# window of GUARD_STEPS more. The preemption gate runs ACP_EPOCHS epochs of
# ACP_STEPS steps, a generation every ACP_INTER epochs and at the last;
# the rollback gate poisons every step after a restore with
# PADDLE_GUARD_MAX_SKIPS = GUARD_MAX_SKIPS.
GUARD_SYNC_EVERY, GUARD_STEPS = 2, 4
ACP_EPOCHS, ACP_STEPS, ACP_INTER = 3, 2, 2
# the depth cut that keeps the script's phases near half its time limit
# once the multichip phase joined them: the guarded phase's GPT keeps
# bench's width and its first GUARD_LAYERS (2) of 24 blocks (named in
# PERF.md;
# CHIP_SMOKE_GUARD_LAYERS sets another depth, which the --acp-child
# processes inherit: tools/time_depth_cuts.py times the phase at two)
GUARD_LAYERS = int(os.environ.get("CHIP_SMOKE_GUARD_LAYERS", "2"))
GUARD_MAX_SKIPS = 2
#: the six kernels' functions, as the trace names them
TRACE_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                 "ln_fwd_kernel", "add_ln_fwd_kernel", "ln_bwd_kernel")
GUARD_KNOBS = ("PADDLE_GUARD_MODE", "PADDLE_GUARD_SYNC_EVERY",
               "PADDLE_GUARD_MAX_SKIPS", "PADDLE_FAULT_SPEC",
               "PADDLE_GUARD_EVENT_FILE", "PADDLE_OBS_BUS_FILE")


def _bench_batch(paddle):
    """bench.py's fixed GPT batch (the dygraph phase's)."""
    n = TRAIN_B * TRAIN_S
    ids = paddle.to_tensor((np.arange(n) % 31000).reshape(TRAIN_B, TRAIN_S))
    labels = paddle.to_tensor(((np.arange(n) + 1) % 31000).reshape(
        TRAIN_B, TRAIN_S))
    return ids, labels


def _gpt_cut(layers):
    """bench's GPT-medium at its full width with only its first ``layers``
    blocks (the guarded, jit.save and multichip phases' depth cuts)."""
    from paddle_tpu_torch import nn

    model = _gpt_medium()
    model.blocks = nn.LayerList(list(model.blocks)[:layers])
    return model


def _acp_trainer(paddle, model=None):
    """bench's GPT-medium program at GUARD_LAYERS (built from seed 0 unless
    given), AdamW 1e-4 / weight decay 0.01, and its TrainStep under the
    current guard knobs."""
    if model is None:
        paddle.seed(0)
        model = _gpt_cut(GUARD_LAYERS)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=model.parameters())
    return model, opt, paddle.jit.TrainStep(model, _bench_lm_loss(model),
                                            opt)


def _guard_knobs(**knobs):
    """Set the guard's knobs (unset the others) and re-arm the injector."""
    from paddle_tpu_torch.utils import fault_injection

    for k in GUARD_KNOBS:
        os.environ.pop(k, None)
    os.environ.update({k: str(v) for k, v in knobs.items()})
    fault_injection.reset()


def _params_equal(model, want) -> bool:
    return all(torch.equal(v, want[k])
               for k, v in model.state_dict().items())


def acp_child(argv) -> int:
    """``python3 chip_smoke.py --acp-child DIR MODE``: one trainer process of
    phase (a)'s preemption gate. It trains bench's GPT-medium (seed 0)
    inside ``TrainEpochRange(ACP_EPOCHS, checkpoint_path=DIR)`` under the
    guard (skip). MODE ``preempt``: at epoch 1's first step it writes
    ``DIR/notice.ready`` and waits for the SIGTERM the parent then sends;
    the range snapshots that epoch and exits 143. MODE ``resume``: it
    restores the newest generation and finishes. Prints its save and
    restore seconds."""
    root, mode = argv
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.checkpoint.auto_checkpoint import (
        TrainEpochRange)

    torch.backends.cuda.matmul.allow_tf32 = False
    paddle.set_device("gpu")
    model, opt, step = _acp_trainer(paddle)
    ids, labels = _bench_batch(paddle)
    r = TrainEpochRange(ACP_EPOCHS, name="gpt", checkpoint_path=root,
                        save_checkpoint_inter=ACP_INTER)
    r.register(model=model, optimizer=opt, scaler=step)
    epochs = r.get()
    t0 = time.perf_counter()
    epoch = next(epochs, None)
    print(f"acp child {mode}: restore {time.perf_counter() - t0:.2f} s, "
          f"first epoch {epoch}", flush=True)
    while epoch is not None:
        for i in range(ACP_STEPS):
            step(ids, labels)
            if mode == "preempt" and epoch == 1 and i == 0:
                torch.cuda.synchronize()
                open(os.path.join(root, "notice.ready"), "w").close()
                deadline = time.monotonic() + 120
                while not r._preempted and time.monotonic() < deadline:
                    time.sleep(0.01)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            epoch = next(epochs, None)
        finally:
            print(f"acp child {mode}: end of epoch, snapshot and next "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
    return 0


def _trace_rows(trace_dir):
    """The Chrome trace of the window under ``trace_dir``: its events."""
    import glob

    paths = glob.glob(os.path.join(trace_dir, "*", "trace.json"))
    if len(paths) != 1:
        fail(f"guarded training: {len(paths)} trace windows in {trace_dir}")
    with open(paths[0]) as f:
        return json.load(f)["traceEvents"]


def guarded_training_phase(pt, kernels, card):
    """Phase (a): bench.py's GPT-medium at its full width (d 1024, 16
    heads, vocab 32000, float32, B 4, S 1024, AdamW through ``TrainStep``)
    and GUARD_LAYERS of its 24 blocks (a depth cut) under the guard (skip)
    and inside ``train_epoch_range``. Gates:

    1. guard on, no fault: losses and parameters bit-equal to the guard-off
       steps, each kernel launched as often (DYGRAPH_LAUNCHES a step, at
       GUARD_LAYERS of LAYERS); a
       trace window of GUARD_STEPS steps holds no blocking (pageable)
       device-to-host copy, exactly one pinned one every GUARD_SYNC_EVERY
       steps, the six kernels and the ``TrainStep::guard`` span (the
       synchronizing calls that sync debug mode sees, and the trace's
       synchronizes, are printed);
    2. ``grad:nan:3:2``: the parameters after step 4 equal those after step
       2 bit for bit, ``total_skips`` 2, the events in
       ``PADDLE_GUARD_EVENT_FILE``;
    3. (after 4) a poisoned streak past PADDLE_GUARD_MAX_SKIPS rolls back
       to the newest generation, bit for bit;
    4. a child process (this script, ``--acp-child``) gets SIGTERM mid-epoch
       and exits 143; a second resumes and finishes; its final parameters
       equal an uninterrupted run's bit for bit;
    5. a flipped byte in the newest generation: the restore falls back to
       the one before (bit for bit the uninterrupted run's at that epoch);
    6. ``step_metrics`` rows with their MFU print, with the step's FLOPs.

    The checkpoints live in a temporary directory, removed at the end.
    Returns the guarded run's launches."""
    import shutil
    import signal
    import tempfile

    paddle = pt
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.incubate.checkpoint.auto_checkpoint import (
        TrainEpochRange)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_acp_")
    print(f"guarded training: checkpoints under {tmp}, "
          f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB free")
    try:
        return _guarded_training(paddle, kernels, card, tmp, profiler,
                                 TrainEpochRange, signal)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for k in GUARD_KNOBS:
            os.environ.pop(k, None)
        torch.cuda.empty_cache()


def _guarded_training(paddle, kernels, card, tmp, profiler, TrainEpochRange,
                      signal):
    t_phase = time.perf_counter()
    paddle.seed(0)
    model = _gpt_cut(GUARD_LAYERS)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ids, labels = _bench_batch(paddle)

    def steps(step, n, window=None):
        """n steps, no host read between them (in a trace window of
        ``window`` when given, closed before any read): losses, host ms
        per call, wall ms per step (the first step included), launches;
        the synchronizing calls the steps made (sync debug mode "warn")
        are printed."""
        import warnings

        kernels.reset_launches()
        torch.cuda.synchronize()
        if window:
            profiler.arm_trace(steps=n, reason="gate1", trace_dir=window)
        losses, host_ms = [], []
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(n):
                    t1 = time.perf_counter()
                    losses.append(step(ids, labels))
                    host_ms.append((time.perf_counter() - t1) * 1e3)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        if window:
            profiler.disarm_trace()     # writes the window's trace
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
        syncs = sorted({str(w.message)[:160] for w in caught
                        if "called a synchronizing" in str(w.message)})
        if syncs:
            print(f"guarded training: synchronizing calls in the steps: "
                  f"{syncs}")
        return ([float(x) for x in losses], host_ms, wall,
                kernels.launches_by_dtype())

    # gate 1: guard off, then on, from the same weights
    runs = {}
    bus = os.path.join(tmp, "bus.jsonl")
    for mode in ("off", "skip"):
        _guard_knobs(PADDLE_GUARD_MODE=mode,
                     PADDLE_GUARD_SYNC_EVERY=GUARD_SYNC_EVERY,
                     PADDLE_OBS_BUS_FILE=bus)
        model.set_state_dict(init)
        _, _, step = _acp_trainer(paddle, model)
        runs[mode] = steps(step, GUARD_STEPS) + (
            {k: v.detach().clone() for k, v in model.state_dict().items()},)
    (off_l, off_host, off_wall, off_n, off_p) = runs["off"]
    (on_l, on_host, on_wall, on_n, on_p) = runs["skip"]
    bit_equal = on_l == off_l and all(torch.equal(on_p[k], v)
                                      for k, v in off_p.items())
    del runs, off_p, on_p
    want = {k: {t: c * GUARD_STEPS * GUARD_LAYERS // LAYERS
                for t, c in v.items()}
            for k, v in DYGRAPH_LAUNCHES.items()}
    print(f"guarded training gate 1 ({GUARD_STEPS} steps from the same "
          f"weights): losses off {off_l}, on {on_l}; "
          f"bit-equal {bit_equal}; host ms/step (call) off "
          f"{[f'{x:.1f}' for x in off_host]}, on "
          f"{[f'{x:.1f}' for x in on_host]} (median of steps 2-"
          f"{GUARD_STEPS}: off {float(np.median(off_host[1:])):.2f}, on "
          f"{float(np.median(on_host[1:])):.2f}); wall ms/step off "
          f"{off_wall:.2f}, on {on_wall:.2f} (step 1 included); launches "
          f"off {off_n}, on {on_n}; {card}")
    if not bit_equal:
        fail("guarded training: the guarded steps differ from the unguarded")
    if on_n != off_n or on_n != want:
        fail(f"guarded training: launches {on_n}, unguarded {off_n}, "
             f"expected {want}")

    # the same guarded step, GUARD_STEPS more, in a trace window
    trace_dir = os.path.join(tmp, "traces")
    steps(step, GUARD_STEPS, window=trace_dir)
    events = _trace_rows(trace_dir)
    memcpy = [e["name"] for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", "")]
    pinned = sum("Pinned" in n for n in memcpy)
    kern = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in n for n in kern) for k in TRACE_KERNELS}
    spans = sum(e.get("name") == "TrainStep::guard"
                and e.get("cat") == "user_annotation" for e in events)
    syncs = sum(e.get("name") in ("cudaStreamSynchronize",
                                  "cudaDeviceSynchronize") for e in events)
    print(f"guarded training trace window ({GUARD_STEPS} steps): "
          f"device-to-host copies {memcpy}; kernels found {found}; "
          f"TrainStep::guard spans {spans}; stream/device synchronizes "
          f"{syncs}; {len(kern)} kernel events")
    if len(memcpy) != pinned or pinned != GUARD_STEPS // GUARD_SYNC_EVERY:
        fail(f"guarded training: device-to-host copies {memcpy}, expected "
             f"{GUARD_STEPS // GUARD_SYNC_EVERY} pinned ones")
    if not all(found.values()) or spans != GUARD_STEPS:
        fail("guarded training: the trace window lacks a kernel or the "
             "guard span")

    # gate 6: step_metrics rows and the step's model FLOPs; the guarded
    # step's time (each step synchronized) for its MFU
    timed = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t1) * 1e3)
    step_ms = float(np.median(timed))
    flops = step.flops_per_step()
    from paddle_tpu_torch.observability import bus as _bus

    rows = [r for r in _bus.read_stream(bus) if r["kind"] == "step_metrics"]
    for r in rows:
        r["payload"]["mfu_pct"] = step.mfu_pct(r["payload"]["step_ms"] / 1e3)
    print(f"guarded training step_metrics rows: "
          f"{json.dumps([dict(r['payload'], step=r['step']) for r in rows])}")
    print(f"guarded training FLOPs a step (matrix products, forward and "
          f"backward, attention at the full S^2): {flops}; guarded step "
          f"{[f'{x:.2f}' for x in timed]} ms (synchronized), MFU at the "
          f"median {step_ms:.2f} ms: {step.mfu_pct(step_ms / 1e3)} % of "
          f"{paddle.observability.mfu.peak_flops():.4g} FLOP/s; {card}")
    if not rows or not flops or not all(
            r["payload"]["mfu_pct"] for r in rows):
        fail("guarded training: no step_metrics row with an MFU")
    del step

    # gate 2: grad:nan:3:2
    ev = os.path.join(tmp, "events.jsonl")
    _guard_knobs(PADDLE_GUARD_MODE="skip",
                 PADDLE_GUARD_SYNC_EVERY=GUARD_SYNC_EVERY,
                 PADDLE_FAULT_SPEC="grad:nan:3:2", PADDLE_GUARD_EVENT_FILE=ev)
    model.set_state_dict(init)
    _, _, step = _acp_trainer(paddle, model)
    after = []
    for i in range(4):
        step(ids, labels)
        if i in (1, 3):
            after.append({k: v.detach().clone()
                          for k, v in model.state_dict().items()})
    step._guard.flush()
    skips = step._guard._last[1]
    events = [json.loads(line) for line in open(ev)] \
        if os.path.exists(ev) else []
    skipped_bitwise = all(torch.equal(after[0][k], v)
                          for k, v in after[1].items())
    print(f"guarded training gate 2 (grad:nan:3:2): parameters after step 4 "
          f"equal after step 2: {skipped_bitwise}; total_skips {skips}; "
          f"events {[(e['event'], e.get('total_skips')) for e in events]}")
    if not skipped_bitwise or skips != 2.0 or not any(
            e["event"] == "guard_skip" and e["total_skips"] == 2
            for e in events):
        fail("guarded training: the poisoned steps were not skipped")
    del after, step

    # gate 4: an uninterrupted run, then a preempted child and its resume
    _guard_knobs(PADDLE_GUARD_MODE="skip",
                 PADDLE_GUARD_SYNC_EVERY=GUARD_SYNC_EVERY)
    model.set_state_dict(init)
    _, _, step = _acp_trainer(paddle, model)
    for i in range(ACP_EPOCHS * ACP_STEPS):
        step(ids, labels)
        if i + 1 == (ACP_EPOCHS - 1) * ACP_STEPS:
            p_mid = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
    p_end = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ck = os.path.join(tmp, "ck")
    os.makedirs(ck)
    child = [sys.executable, os.path.abspath(__file__), "--acp-child", ck]
    env = dict(os.environ)
    t0 = time.perf_counter()
    proc = subprocess.Popen(child + ["preempt"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    ready = os.path.join(ck, "notice.ready")
    deadline = time.monotonic() + 300
    while not os.path.exists(ready) and proc.poll() is None \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    if proc.poll() is None and os.path.exists(ready):
        proc.send_signal(signal.SIGTERM)
    try:
        out_a, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail("guarded training: the preempted child did not end")
    t_a = time.perf_counter() - t0
    gens = sorted(os.listdir(os.path.join(ck, "default_job", "gpt")))
    print(f"guarded training gate 4: preempted child rc {proc.returncode} "
          f"in {t_a:.1f} s, generations {gens}; its lines: "
          f"{[x for x in out_a.splitlines() if 'acp child' in x]}")
    if proc.returncode != 143:
        print(out_a[-4000:])
        fail("guarded training: the preempted child did not exit 143")
    t0 = time.perf_counter()
    res = subprocess.run(child + ["resume"], env=env, capture_output=True,
                         text=True, timeout=600)
    t_b = time.perf_counter() - t0
    snap_dir = os.path.join(ck, "default_job", "gpt")
    gens = sorted(os.listdir(snap_dir))
    newest = os.path.join(snap_dir, gens[-1])
    gen_bytes = sum(os.path.getsize(os.path.join(newest, f))
                    for f in os.listdir(newest))
    print(f"guarded training gate 4: resumed child rc {res.returncode} in "
          f"{t_b:.1f} s, generations {gens}, {gen_bytes} bytes a "
          f"generation; its lines: "
          f"{[x for x in res.stdout.splitlines() if 'acp child' in x]}")
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:])
        fail("guarded training: the resumed child failed")

    # gates 4 and 3: restore the resumed run's last generation, then a
    # poisoned streak past the budget rolls back to it
    _guard_knobs(PADDLE_GUARD_MODE="skip", PADDLE_GUARD_SYNC_EVERY=1,
                 PADDLE_GUARD_MAX_SKIPS=GUARD_MAX_SKIPS,
                 PADDLE_FAULT_SPEC="grad:nan:1:99")
    _, opt, step = _acp_trainer(paddle, model)
    r = TrainEpochRange(ACP_EPOCHS + 2, name="gpt", checkpoint_path=ck,
                        save_checkpoint_inter=ACP_INTER)
    r.register(model=model, optimizer=opt, scaler=step)
    epochs = r.get()
    t0 = time.perf_counter()
    epoch = next(epochs)
    restore_s = time.perf_counter() - t0
    resumed_equal = _params_equal(model, p_end)
    rolled = None
    for i in range(GUARD_MAX_SKIPS + 2):
        step(ids, labels)
        if step._guard.rollbacks:
            rolled = i + 1
            break
    rollback_equal = _params_equal(model, p_end)
    epochs.close()
    print(f"guarded training gates 4 and 3: restore of {gen_bytes} bytes in "
          f"{restore_s:.2f} s (next epoch {epoch}); resumed run = "
          f"uninterrupted run bit for bit: {resumed_equal}; rollback at "
          f"poisoned step {rolled} (budget {GUARD_MAX_SKIPS}), parameters = "
          f"the newest generation's: {rollback_equal}")
    if epoch != ACP_EPOCHS or not resumed_equal:
        fail("guarded training: the resumed run differs from the "
             "uninterrupted one")
    if rolled is None or not rollback_equal:
        fail("guarded training: no rollback to the last generation")

    # gate 5: a flipped byte in the newest generation
    target = os.path.join(newest, "model_0.pdparams")
    with open(target, "r+b") as f:
        f.seek(os.path.getsize(target) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    _guard_knobs(PADDLE_GUARD_MODE="skip")
    _, opt, step = _acp_trainer(paddle, model)
    r = TrainEpochRange(ACP_EPOCHS, name="gpt", checkpoint_path=ck)
    r.register(model=model, optimizer=opt, scaler=step)
    t0 = time.perf_counter()
    nxt = r.restore()
    fallback_s = time.perf_counter() - t0
    fell_back = _params_equal(model, p_mid)
    print(f"guarded training gate 5: flipped byte in {gens[-1]}: restore "
          f"fell back to next epoch {nxt} in {fallback_s:.2f} s; parameters "
          f"= the uninterrupted run's after epoch {ACP_EPOCHS - 2}: "
          f"{fell_back}")
    if nxt != ACP_EPOCHS - 1 or not fell_back:
        fail("guarded training: no fallback to the previous generation")
    print(f"guarded training phase: {time.perf_counter() - t_phase:.1f} s")
    return on_n


# -- phase (b): the detection ops at PaddleDetection's sizes -----------------
# YOLOv3 on COCO (PaddleDetection's yolov3 config): 608 x 608, batch 8, 80
# classes, the nine COCO anchors, masks [[6,7,8],[3,4,5],[0,1,2]] on strides
# 32/16/8, ignore_thresh 0.7, up to 50 ground-truth boxes an image; decoding
# with conf_thresh 0.005 and multiclass NMS (score 0.01, nms_top_k 1000,
# keep_top_k 100, IoU 0.45). SSD300's 8,732 priors for the box ops, and a
# Faster R-CNN stride-16 map of 800 x 1333 (1024 channels, 512 RoIs, 7 x 7)
# for the RoI ops.
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_MASKS = ([6, 7, 8], [3, 4, 5], [0, 1, 2])
YOLO_STRIDES = (32, 16, 8)
YOLO_SIZE, YOLO_BATCH, YOLO_CLASSES, YOLO_MAX_GT = 608, 8, 80, 50
YOLO_STEPS, YOLO_LR = 5, 1e-5
SSD_MAPS = ((38, 30.0, 60.0, (2.0,), 8), (19, 60.0, 111.0, (2.0, 3.0), 16),
            (10, 111.0, 162.0, (2.0, 3.0), 32),
            (5, 162.0, 213.0, (2.0, 3.0), 64), (3, 213.0, 264.0, (2.0,), 100),
            (1, 264.0, 315.0, (2.0,), 300))
FRCNN_H, FRCNN_W, FRCNN_C, FRCNN_ROIS = 800, 1333, 1024, 512
DET_RTOL = DET_ATOL = 1e-4


def yolo_head(paddle):
    """The port's ResNet-50, its C3-C5 features (strides 8, 16, 32) each
    through a 1 x 1 convolution to 3 x (5 + 80) = 255 channels: the three
    heads of YOLOv3, largest stride first."""
    from paddle_tpu_torch import nn

    class YOLOv3Head(nn.Layer):
        def __init__(self):
            super().__init__()
            self.backbone = paddle.vision.models.resnet50(num_classes=0,
                                                          with_pool=False)
            self.heads = nn.LayerList([
                nn.Conv2D(c, 3 * (5 + YOLO_CLASSES), 1)
                for c in (2048, 1024, 512)])

        def forward(self, x):
            b = self.backbone
            x = b.maxpool(b.relu(b.bn1(b.conv1(x))))
            c3 = b.layer2(b.layer1(x))
            c4 = b.layer3(c3)
            c5 = b.layer4(c4)
            return [h(c) for h, c in zip(self.heads, (c5, c4, c3))]

    return YOLOv3Head()


def yolo_loss_fn(paddle):
    """yolo_loss of each head (mean over the batch), summed."""
    ops = paddle.vision.ops

    def loss(outs, gt_box, gt_label):
        total = 0.0
        for out, mask, stride in zip(outs, YOLO_MASKS, YOLO_STRIDES):
            total = total + ops.yolo_loss(
                out, gt_box, gt_label, YOLO_ANCHORS, mask, YOLO_CLASSES,
                0.7, stride, use_label_smooth=False).mean()
        return total

    return loss


def yolo_batch(seed=0):
    """Images and ground truth from a seed: 5-50 boxes an image, centre
    format relative to the image, the rest zero rows."""
    r = np.random.RandomState(seed)
    img = r.randn(YOLO_BATCH, 3, YOLO_SIZE, YOLO_SIZE).astype(np.float32)
    gt = np.zeros((YOLO_BATCH, YOLO_MAX_GT, 4), np.float32)
    lab = np.zeros((YOLO_BATCH, YOLO_MAX_GT), np.int32)
    for i in range(YOLO_BATCH):
        n = r.randint(5, YOLO_MAX_GT + 1)
        wh = r.uniform(0.02, 0.5, (n, 2))
        c = r.uniform(wh / 2, 1 - wh / 2)
        gt[i, :n] = np.concatenate([c, wh], 1)
        lab[i, :n] = r.randint(0, YOLO_CLASSES, n)
    return img, gt, lab


def _on(dev, fn, *args, **kwargs):
    """``fn`` on Tensors of the numpy ``args`` on ``dev`` ("gpu" / "cpu");
    numpy results (the ms on the card)."""
    import paddle_tpu_torch as paddle

    paddle.set_device(dev)
    ts = [paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
          for a in args]
    if dev == "gpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*ts, **kwargs)
    if dev == "gpu":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = list(out) if isinstance(out, (tuple, list)) else [out]
    return [o.numpy() for o in out], ms


def _compare(name, fn, *args, ties=None, **kwargs):
    """``fn`` on the card and on the CPU on the same inputs: floats within
    DET_RTOL/DET_ATOL, integers equal. With ``ties`` (a list), NMS rows
    [label, score, box] may differ only at slots whose CPU score ties with
    another kept slot's; those are appended to ``ties``. Returns the card's
    outputs and ms."""
    gpu, ms = _on("gpu", fn, *args, **kwargs)
    cpu, _ = _on("cpu", fn, *args, **kwargs)
    errs = []
    for g, c in zip(gpu, cpu):
        if g.shape != c.shape:
            fail(f"detection ops: {name} shapes {g.shape} vs {c.shape}")
        close = np.allclose(g, c, rtol=DET_RTOL, atol=DET_ATOL) \
            if c.dtype.kind == "f" else np.array_equal(g, c)
        if c.dtype.kind == "f" and c.size:
            errs.append(float(np.abs(g.astype(np.float64) - c).max()))
        if close:
            continue
        if ties is None or g.ndim != 3:
            fail(f"detection ops: {name} on the card differs from the CPU"
                 + (f" by {errs[-1]:.3e}" if errs else ""))
        for n in range(g.shape[0]):
            s = c[n, :, 1]
            for j in np.nonzero(~np.isclose(g[n], c[n], rtol=DET_RTOL,
                                            atol=DET_ATOL).all(-1))[0]:
                if np.sum(s == s[j]) < 2:
                    fail(f"detection ops: {name} keeps another box on the "
                         f"card (image {n}, slot {j}) with no score tie")
                ties.append((name, n, int(j)))
    print(f"  {name}: shapes {[tuple(g.shape) for g in gpu]}, card {ms:.2f} "
          f"ms, max |card - cpu| {max(errs) if errs else 0.0:.3e}")
    return gpu, ms


def detection_phase(pt, kernels, card):
    """Phase (b): YOLOv3's head at PaddleDetection's COCO sizes (see the
    constants above) takes YOLO_STEPS Momentum steps of ``yolo_loss``
    through ``TrainStep`` (the loss must fall); its heads before training
    are decoded with ``yolo_box`` and go through ``multiclass_nms``; the other detection ops run once each at
    SSD300 or Faster R-CNN sizes. Every result on the card equals the
    port's CPU result on the same tensors within 1e-4 (rtol and atol);
    ``multiclass_nms``'s kept rows are equal, or differ only at slots
    whose scores tie (reported); ``nms``'s kept indices are equal.
    Prints the step and NMS ms. Returns the launches of the run (none: the
    detection ops and ResNet-50 use no hand-written kernel)."""
    paddle = pt
    ops = paddle.vision.ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    paddle.seed(7)
    t_phase = time.perf_counter()
    model = yolo_head(paddle)
    img, gt, lab = yolo_batch()
    opt = paddle.optimizer.Momentum(learning_rate=YOLO_LR, momentum=0.9,
                                    parameters=model.parameters())
    step = paddle.jit.TrainStep(model, yolo_loss_fn(paddle), opt)
    x = paddle.to_tensor(img)
    gtb, gtl = paddle.to_tensor(gt), paddle.to_tensor(lab)
    # the heads decoded below are the network's before training: a few
    # steps push every objectness logit below conf_thresh (the negative
    # cells dominate the loss), which would leave NMS nothing to keep
    with paddle.no_grad():
        heads = [h.numpy() for h in model(x)]
    kernels.reset_launches()
    losses, ms = [], []
    for _ in range(YOLO_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(x, [gtb, gtl])))
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launches()
    print(f"detection: YOLOv3 (ResNet-50 C3-C5, {YOLO_SIZE}x{YOLO_SIZE}, "
          f"batch {YOLO_BATCH}, {YOLO_CLASSES} classes, "
          f"{int((gt[..., 2] > 0).sum())} ground-truth boxes) Momentum "
          f"{YOLO_LR}: losses {[f'{v:.4f}' for v in losses]}; step ms "
          f"{[f'{v:.1f}' for v in ms]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("detection: the YOLOv3 loss is not finite or did not fall")
    with paddle.no_grad():
        trained = model(x)
        above = [int((paddle.nn.functional.sigmoid(
            h.reshape([YOLO_BATCH, 3, 5 + YOLO_CLASSES, -1])[:, :, 4])
            >= 0.005).sum()) for h in trained]
    print(f"detection: after {YOLO_STEPS} steps, boxes above conf_thresh "
          f"0.005 by head: {above} (before: the heads decoded below)")
    del step, opt, model, x, trained
    torch.cuda.empty_cache()

    print("detection ops, card against CPU on the same tensors:")
    total = 0.0
    for i, (h, mask, stride) in enumerate(zip(heads, YOLO_MASKS,
                                              YOLO_STRIDES)):
        (loss,), _ = _compare(
            f"yolo_loss head {i}", ops.yolo_loss, h, gt, lab, YOLO_ANCHORS,
            mask, YOLO_CLASSES, 0.7, stride, use_label_smooth=False)
        total += float(loss.mean())
    sizes = np.full((YOLO_BATCH, 2), YOLO_SIZE, np.int32)
    boxes, scores = [], []
    for i, (h, mask, stride) in enumerate(zip(heads, YOLO_MASKS,
                                              YOLO_STRIDES)):
        (b, s), _ = _compare(
            f"yolo_box head {i}", ops.yolo_box, h, sizes,
            [YOLO_ANCHORS[2 * a + j] for a in mask for j in (0, 1)],
            YOLO_CLASSES, 0.005, stride)
        boxes.append(b)
        scores.append(s)
    boxes = np.concatenate(boxes, 1)
    scores = np.ascontiguousarray(np.concatenate(scores, 1).transpose(
        0, 2, 1))
    ties = []
    nms_args = (boxes, scores, 0.01, 1000, 100, 0.45, False, 1.0, -1)
    _on("gpu", ops.multiclass_nms, *nms_args)          # warm-up
    (out, counts_nms), nms_ms = _compare("multiclass_nms",
                                         ops.multiclass_nms, *nms_args,
                                         ties=ties)
    print(f"detection: {boxes.shape[1]} boxes an image, "
          f"multiclass_nms kept {counts_nms.tolist()} in {nms_ms:.2f} ms "
          f"(IoU tensor [{YOLO_BATCH}, {YOLO_CLASSES}, 1000, 1000] float32); "
          f"kept rows differing only at score ties: {ties or 'none'}; "
          f"yolo_loss on the card's heads {total:.4f}; {card}")

    # SSD300's priors, and the box ops over them
    priors, pvars = [], []
    for size, lo, hi, ars, stride in SSD_MAPS:
        (p, v), _ = _compare(
            f"prior_box {size}x{size}", ops.prior_box,
            np.zeros((1, 1, size, size), np.float32),
            np.zeros((1, 1, 300, 300), np.float32), [lo], [hi], list(ars),
            flip=True, clip=True, steps=(float(stride), float(stride)))
        priors.append(p.reshape(-1, 4))
        pvars.append(v.reshape(-1, 4))
    priors, pvars = np.concatenate(priors), np.concatenate(pvars)
    if priors.shape[0] != 8732:
        fail(f"detection ops: SSD300 gives {priors.shape[0]} priors")
    r = np.random.RandomState(3)
    lo = r.uniform(0, 0.7, (YOLO_MAX_GT, 2))
    gtc = np.concatenate([lo, lo + r.uniform(0.05, 0.3, (YOLO_MAX_GT, 2))],
                         1).astype(np.float32)
    deltas = (r.randn(YOLO_BATCH, priors.shape[0], 4) * 0.1).astype(
        np.float32)
    _compare("box_coder encode", ops.box_coder, priors, pvars, gtc)
    (dec,), _ = _compare("box_coder decode", ops.box_coder, priors, pvars,
                         deltas, "decode_center_size")
    _compare("iou_similarity", ops.iou_similarity, gtc, priors)
    dist = r.rand(YOLO_BATCH, YOLO_MAX_GT, priors.shape[0]).astype(
        np.float32)
    (match, _), _ = _compare("bipartite_match", ops.bipartite_match, dist,
                             "per_prediction", 0.5)
    _compare("target_assign", ops.target_assign,
             np.repeat(gtc[None], YOLO_BATCH, 0), match, mismatch_value=0.0)
    info = np.tile(np.array([[300, 300, 1.0]], np.float32), (YOLO_BATCH, 1))
    _compare("box_clip", ops.box_clip, dec * 300, info)
    _compare("nms", ops.nms, dec[0] * 300, 0.45, r.rand(
        priors.shape[0]).astype(np.float32), top_k=200)

    # Faster R-CNN's stride-16 map
    fh, fw = FRCNN_H // 16, -(-FRCNN_W // 16)
    feat = r.randn(2, FRCNN_C, fh, fw).astype(np.float32)
    x1 = r.uniform(0, FRCNN_W - 64, (FRCNN_ROIS, 1))
    y1 = r.uniform(0, FRCNN_H - 64, (FRCNN_ROIS, 1))
    rois = np.concatenate([x1, y1, x1 + r.uniform(16, 400, (FRCNN_ROIS, 1)),
                           y1 + r.uniform(16, 300, (FRCNN_ROIS, 1))],
                          1).astype(np.float32)
    per = np.array([FRCNN_ROIS // 2] * 2, np.int32)
    _compare("anchor_generator", ops.anchor_generator, feat[:1],
             [32, 64, 128, 256, 512], [0.5, 1.0, 2.0], stride=(16.0, 16.0))
    _compare("roi_align", ops.roi_align, feat, rois, per, 7,
             spatial_scale=1 / 16, sampling_ratio=2)
    _compare("roi_pool", ops.roi_pool, feat, rois, per, 7,
             spatial_scale=1 / 16)
    paddle.set_device("gpu")
    torch.cuda.empty_cache()
    print(f"detection phase: {time.perf_counter() - t_phase:.1f} s; "
          f"YOLOv3 step {float(np.median(ms[1:])):.1f} ms (median of steps "
          f"2-{YOLO_STEPS}), multiclass_nms {nms_ms:.2f} ms; {card}")
    return counts


def _mc_batch():
    """bench.py's _bench_gpt_multichip batch: the global [4 * dp, S] ids and
    next-token labels, as numpy."""
    n = MC_BATCH * TRAIN_S
    ids = (np.arange(n) % 31000).reshape(MC_BATCH, TRAIN_S).astype(np.int64)
    labels = ((np.arange(n) + 1) % 31000).reshape(MC_BATCH, TRAIN_S) \
        .astype(np.int64)
    return ids, labels


def multichip_gpt_phase(pt, kernels, card):
    """bench.py's ``_bench_gpt_multichip`` program at GPT-medium's full
    width and ``MC_LAYERS`` of its 24 blocks (a depth cut), as a world of
    4 ranks (dp2 x mp2) of this script
    (``--rank-child``), all on this card, over gloo (the backend rule for
    ranks that share a card), started by the port's launcher
    (``distributed.launch``) with a deadline.

    The parent first runs the program in one process on the same global
    batch (B = 8) and weights (seed 0): the first-step gradients, then
    ``MC_STEPS`` float32 steps (TF32 off), and writes the weights and the
    gradients to a temporary directory (``/dev/shm`` where there is one);
    then it frees the card before the world starts. Each rank loads the
    full weights through ``set_state_dict``, which keeps its shard, and:

    (a) float32: its first-step gradients, averaged over dp and gathered
        to full, within ``MC_GRAD_RTOL`` of the one-process gradient's
        largest value; ``MC_STEPS`` steps of ``TrainStep`` (AdamW 1e-4 /
        0.01, ``fused_linear_cross_entropy``), each dp-mean loss within
        ``MC_LOSS_RTOL`` of the one-process loss and the same on all 4
        ranks; B1, B3 and B4 launched ``MC_LAYERS`` times a step at ``[4, 8,
        1024, 64]`` float32, B5/B6/B7 at the one-process step's counts
        (scaled to ``MC_LAYERS``), no other
        kernel type. Parameters after the steps are not gated: Adam turns
        sub-ulp gradient differences into lr-sized ones.
    (c) one float32 step from the same weights under
        ``PADDLE_FLASH_SHARD=0``: no kernel launch (the dense attention and
        LayerNorm), its loss within ``MC_LOSS_RTOL`` of (a)'s first.
    (b) bench's program as written (bf16 AMP O1 through the strategy):
        one warm-up step, then ``MC_STEPS`` timed: step ms and global
        tokens/s, host ms in collectives by (op, transport), per-rank peak
        memory, B1/B3/B4 launches in bf16; finite losses, the same on all
        ranks.

    Fails when a rank exits non-zero or outlives ``MC_DEADLINE_S``, when a
    collective ran on another backend than the rule's, or when a gate or
    a kernel of the path fails. Returns rank 0's launch counts of (a) and
    (b)."""
    import gc
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed import launch as dlaunch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="mc_gpt_", dir=shm)
    try:
        pt.seed(0)
        model = _gpt_cut(MC_LAYERS)
        lm_loss = _bench_lm_loss(model)
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()},
                   os.path.join(root, "state.pt"))
        ids, labels = (torch.as_tensor(a, device="cuda")
                       for a in _mc_batch())
        torch.cuda.reset_peak_memory_stats()
        loss = lm_loss(model(ids), labels)
        loss.backward()
        torch.save({k: p.grad.detach().cpu()
                    for k, p in model.named_parameters()},
                   os.path.join(root, "grads.pt"))
        model.clear_gradients()
        step = pt.jit.TrainStep(model, lm_loss, pt.optimizer.AdamW(
            learning_rate=1e-4, weight_decay=0.01,
            parameters=model.parameters()))
        ref = [step(ids, labels).item() for _ in range(MC_STEPS)]
        ref_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del model, step, loss, lm_loss, ids, labels
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"multichip GPT: one-process reference, B={MC_BATCH} "
              f"S={TRAIN_S} float32: first-step loss {ref[0]:.6f}, losses "
              f"{[f'{x:.6f}' for x in ref]}, peak {ref_peak:.2f} GiB, "
              f"{time.perf_counter() - t0:.1f} s with the weights and "
              "gradients written")
        logs = os.path.join(root, "logs")
        t1 = time.perf_counter()
        rc = dlaunch.launch(os.path.abspath(__file__),
                            ["--rank-child", root],
                            nproc_per_node=MC_WORLD, log_dir=logs,
                            deadline=MC_DEADLINE_S)
        world_s = time.perf_counter() - t1
        for r in range(MC_WORLD):
            with open(os.path.join(logs, f"workerlog.{r}")) as f:
                text = f.read()
            if rc != 0 or r == 0:
                print(f"--- rank {r} log ---\n{text.rstrip()}")
        if rc != 0:
            fail(f"multichip GPT: the world of {MC_WORLD} ranks exited "
                 f"with code {rc}")
        res = []
        for r in range(MC_WORLD):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"multichip GPT: world of {MC_WORLD} ranks (dp{MC_DP} x mp{MC_MP})"
          f" ran in {world_s:.1f} s on {card}, 4 ranks sharing one H100 over "
          "gloo")
    for r, o in enumerate(res):
        bad = [c for c in o["a_counts"] + o["b_counts"]
               if c["backend"] != "gloo" or c["transport"] != "gloo-cuda"]
        if o["backend"] != "gloo" or bad:
            fail(f"multichip GPT rank {r}: a collective left the rule's "
                 f"backend (gloo, gloo-cuda): {o['backend']}, {bad}")
        for i, (got, want) in enumerate(zip(o["a_losses"], ref)):
            if abs(got - want) > MC_LOSS_RTOL * abs(want):
                fail(f"multichip GPT rank {r} step {i + 1}: loss {got!r} "
                     f"against one process's {want!r}")
        if o["grad_worst"] > MC_GRAD_RTOL:
            fail(f"multichip GPT rank {r}: gradient {o['grad_worst_name']} "
                 f"off by {o['grad_worst']:.3e} of its largest value")
        want = _scaled(DYGRAPH_LAUNCHES, MC_LAYERS, MC_STEPS)
        if o["a_launches"] != want:
            fail(f"multichip GPT rank {r}: float32 launches "
                 f"{o['a_launches']}, expected {want}")
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            if o["a_shapes"][name] != [list(MC_RANK_SHAPE)]:
                fail(f"multichip GPT rank {r}: {name} at "
                     f"{o['a_shapes'][name]}, expected {MC_RANK_SHAPE}")
            if o["b_launches"][name] != {"bfloat16": MC_STEPS * MC_LAYERS}:
                fail(f"multichip GPT rank {r}: {name} bf16 launches "
                     f"{o['b_launches'][name]}")
        if any(o["c_launches"].values()) or o["c_declines"]["flash"] == 0:
            fail(f"multichip GPT rank {r}: PADDLE_FLASH_SHARD=0 launched "
                 f"{o['c_launches']} (declines {o['c_declines']})")
        if abs(o["c_loss"] - ref[0]) > MC_LOSS_RTOL * abs(ref[0]):
            fail(f"multichip GPT rank {r}: PADDLE_FLASH_SHARD=0 loss "
                 f"{o['c_loss']!r} against {ref[0]!r}")
        if not all(np.isfinite(o["b_losses"])):
            fail(f"multichip GPT rank {r}: bf16 losses {o['b_losses']}")
    for key in ("a_losses", "b_losses", "c_loss"):
        if any(o[key] != res[0][key] for o in res):
            fail(f"multichip GPT: {key} differ across ranks: "
                 f"{[o[key] for o in res]}")
    r0 = res[0]
    ms = float(np.mean(r0["b_ms"]))
    print(f"multichip GPT (a) float32: losses {r0['a_losses']} (one "
          f"process {ref}); worst first-step gradient "
          f"{max(o['grad_worst'] for o in res):.3e} of its largest "
          f"({r0['grad_worst_name']}); launches a rank "
          f"{r0['a_launches']} at {r0['a_shapes']['flash_attention_fwd']}")
    print(f"multichip GPT (c) PADDLE_FLASH_SHARD=0: loss {r0['c_loss']!r}, "
          f"launches {r0['c_launches']}, declines {r0['c_declines']}")
    print(f"multichip GPT (b) bf16 AMP, {MC_STEPS} steps after one warm-up "
          f"(4 ranks sharing one H100 over gloo): losses {r0['b_losses']}; "
          f"step ms {[round(x, 1) for x in r0['b_ms']]}, mean {ms:.1f} ms, "
          f"{MC_BATCH * TRAIN_S / ms * 1e3:.1f} global tokens/s; peak "
          f"memory by rank {[round(o['b_peak_gib'], 2) for o in res]} GiB; "
          f"load {[round(o['load_s'], 2) for o in res]} s; bf16 launches "
          f"{ {k: v for k, v in r0['b_launches'].items()} }")
    for c in r0["b_counts"]:
        print(f"multichip GPT (b) rank 0 collectives, {MC_STEPS} steps: "
              f"{c['op']} {c['backend']}/{c['transport']}: {c['calls']} "
              f"calls, {c['bytes'] / 2 ** 20:.1f} MiB, {c['ms']:.1f} host ms")
    return {"multichip_gpt_f32": {k: sum(v.values()) for k, v in
                                  r0["a_launches"].items()},
            "multichip_gpt_bf16": {k: sum(v.values()) for k, v in
                                   r0["b_launches"].items()}}


def rank_child(argv) -> int:
    """``python3 chip_smoke.py --rank-child DIR``: one rank of the multichip
    GPT phase's world, started by the port's launcher with its rank's env.
    Writes its results to ``DIR/rank<r>.json``."""
    root, = argv
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import comm, fleet
    from paddle_tpu_torch.nn.functional import attention as attn
    from paddle_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    rank = dist.get_rank()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": MC_DP, "mp_degree": MC_MP}
    fleet.init(is_collective=True, strategy=strategy)
    pt.seed(0)
    model = _gpt_cut(MC_LAYERS)
    lm_loss = _bench_lm_loss(model)
    state = os.path.join(root, "state.pt")

    t = time.perf_counter()
    model.set_state_dict(torch.load(state, mmap=True))
    torch.cuda.synchronize()
    out = {"rank": rank, "backend": comm.backend(),
           "load_s": time.perf_counter() - t}
    # the loaded shards, kept on the card to start (c) and (b) from
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    fl = fleet.distributed_model(model)
    ids, labels = (fl.shard_input(a) for a in _mc_batch())
    mon = dist.comm_monitor.monitor()
    dev = torch.device("cuda", torch.cuda.current_device())

    # (a) the first-step gradients, averaged over dp, gathered to full
    loss = lm_loss(fl(ids), labels)
    loss.backward()
    want = torch.load(os.path.join(root, "grads.pt"), mmap=True)
    worst, worst_name = 0.0, ""
    for name, p in model.named_parameters():
        shard = getattr(p, "_tp_shard", None)
        full = shard.gather(p.grad) if shard is not None else p.grad
        w = want[name].to(dev)
        rel = ((full - w).abs().max() / w.abs().max()).item()
        if rel > worst:
            worst, worst_name = rel, name
    out.update(grad_worst=worst, grad_worst_name=worst_name)
    model.clear_gradients()
    del loss, want

    def trainer(strat=None):
        opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=model.parameters())
        return pt.jit.TrainStep(fl, lm_loss, fleet.distributed_optimizer(
            opt, strategy=strat))

    # (a) float32 steps
    step = trainer()
    mon.reset_counts()
    kernels.reset_launches()  # the float32 multichip path starts here
    out["a_losses"] = [step(ids, labels).item() for _ in range(MC_STEPS)]
    out["a_launches"] = kernels.launches_by_dtype()  # ... and ends here
    out["a_shapes"] = kernels.launch_shapes()
    out["a_counts"] = mon.comm_counts()
    del step

    # (c) one float32 step from the same weights under PADDLE_FLASH_SHARD=0
    model.set_state_dict(init)
    os.environ["PADDLE_FLASH_SHARD"] = "0"
    step = trainer()
    for k in attn.SHARD_DECLINES:
        attn.SHARD_DECLINES[k] = 0
    kernels.reset_launches()
    out["c_loss"] = step(ids, labels).item()
    out["c_launches"] = kernels.launches()
    out["c_declines"] = dict(attn.SHARD_DECLINES)
    os.environ.pop("PADDLE_FLASH_SHARD")
    del step

    # (b) bench's program as written: bf16 AMP through the strategy
    model.set_state_dict(init)
    del init
    amp = fleet.DistributedStrategy()
    amp.amp = True
    amp.hybrid_configs = {"dp_degree": MC_DP, "mp_degree": MC_MP}
    step = trainer(amp)
    step_ms = []
    step(ids, labels).item()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    mon.reset_counts()
    kernels.reset_launches()  # the bf16 multichip path starts here
    losses = []
    for _ in range(MC_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(ids, labels).item())  # .item() syncs
        step_ms.append((time.perf_counter() - t) * 1e3)
    out["b_launches"] = kernels.launches_by_dtype()  # ... and ends here
    out.update(b_losses=losses, b_ms=step_ms, b_counts=mon.comm_counts(),
               b_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"rank {rank}: {json.dumps(out)}", flush=True)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    comm.destroy_parallel_env()
    return 0


def sp_decoder(paddle, attn_impl, layers=SP_LAYERS):
    """The sp part's GPT-medium-shaped causal decoder: token and position
    embeddings, ``layers`` (``SP_LAYERS`` of GPT-medium's 24: a depth
    cut) post-LN ``TransformerEncoderLayer(1024, 16,
    4096, dropout=0)`` on ``attn_impl`` (causal) with GPT's GELU (a
    ReLU's kink turns a pre-activation within rounding of 0 into a
    gradient that differs by a whole token's term, 7.3e-3 of
    ``linear1.weight``'s largest value at sp4 against one process, where
    the 1e-4 oracle means to see the ring's rounding) and a 32k head
    (applied in the loss, ``_bench_lm_loss``). On an sp mesh its positions
    are those of the rank's shard (from ``sp_rank * T``)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import comm

    class Decoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(VOCAB, D_MODEL)
            self.pos = nn.Embedding(SP_SEQ, D_MODEL)
            self.layers = nn.LayerList([
                nn.TransformerEncoderLayer(D_MODEL, HEADS, FFN, dropout=0.0,
                                           activation="gelu",
                                           attn_impl=attn_impl, causal=True)
                for _ in range(layers)])
            self.head = nn.Linear(D_MODEL, VOCAB)

        def forward(self, ids):
            T = ids.shape[1]
            mesh = comm.hybrid_mesh()
            start = mesh.axis_rank("sp") * T if mesh is not None else 0
            h = self.embed(ids) + self.pos(paddle.arange(start, start + T,
                                                         dtype="int64"))
            for lyr in self.layers:
                h = lyr(h)
            return h

    return Decoder()


def _set_attn(model, impl):
    for lyr in model.layers:
        lyr.self_attn.attn_impl = impl


def _sp_batch():
    """The sp part's batch: [1, SP_SEQ] ids and next-token labels."""
    ids = (np.arange(SP_SEQ) % 31000).reshape(1, SP_SEQ).astype(np.int64)
    return ids, (ids + 1) % 31000


def pp_gpt_layers(paddle, layers=None):
    """bench.py's ``_gpt_medium`` as a layer sequence for ``PipelineLayer``:
    the embeddings (token + position), ``layers`` (``SP_LAYERS`` by
    default) ``ParallelGPTBlock``s (of its 24: a depth cut) and the 32k
    head."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import ParallelGPTBlock

    class Embedding(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(VOCAB, D_MODEL)
            self.pos = nn.Embedding(TRAIN_S, D_MODEL)

        def forward(self, ids):
            T = ids.shape[1]
            return self.embed(ids) + self.pos(paddle.arange(T,
                                                            dtype="int64"))

    return ([Embedding()]
            + [ParallelGPTBlock(D_MODEL, HEADS, dropout=0.0)
               for _ in range(SP_LAYERS if layers is None else layers)]
            + [nn.Linear(D_MODEL, VOCAB)])


def pp_loss(logits, labels):
    """Cross-entropy of the head's logits, the mean over the tokens."""
    import paddle_tpu_torch as paddle

    return paddle.nn.functional.cross_entropy(
        logits.reshape([-1, VOCAB]), labels.reshape([-1]))


def sp_pp_ep_phase(pt, kernels, card):
    """Sequence, pipeline and expert parallelism at full width, as one
    world of 4 ranks of this script (``--sp-child``) started by the port's
    launcher, all on this card over gloo, three parts in turn, each with
    the launch counts reset:

    (a) sp4: ``sp_decoder`` on ``ring_pallas`` (each rank 2048 of the 8192
        positions, fleet ``sp_degree`` 4, ``TrainStep`` with AdamW 1e-4 /
        0.01, ``_bench_lm_loss``): the first-step gradients (averaged over
        sp) within ``SP_GRAD_RTOL`` of each largest value of one process's
        on ``blockwise`` (B1-B4 at S 8192), ``SP_STEPS`` losses within
        ``SP_LOSS_RTOL``; rank r launches B1, B3 and B4 exactly
        ``SP_LAYERS`` (r + 1) times a step (the diagonal and r earlier
        shards a layer; the masked shards launch nothing) at [1, 16, 2048,
        64]. Then one bf16 AMP O1 step on ``ulysses`` (B1, B3, B4
        ``SP_LAYERS`` a step at [1, 4, 8192, 64] bf16)
        against one on ``ring_pallas`` (losses within ``SP_ULYSSES_RTOL``),
        and one direct ``ulysses_attention(use_pallas=True)`` against the
        flash kernel on the global tensors. ms/step, global tokens/s, host
        ms in the ring's shifts and in ``all_reduce`` by transport, peak by
        rank.
    (b) pp2 x mp2: bench's GPT-medium as ``PipelineLayer`` (embeddings,
        ``SP_LAYERS`` ``ParallelGPTBlock``, head; half a stage) through fleet,
        ``accumulate_steps`` 4, 1F1B, batch 8 x 1024: the first-step
        gradients (before the update) within ``SP_GRAD_RTOL`` of one
        process's, one F-then-B pass's loss within ``PP_SCHEDULE_RTOL`` of
        1F1B's, ``PP_STEPS`` ``train_batch`` losses within ``SP_LOSS_RTOL``
        of one process's ``TrainStep``; every kernel of the block on every
        rank (SP_LAYERS / 2 blocks x 4 microbatches a step); ms/step,
        tokens/s, peak
        by stage.
    (c) ep4: ``ExpertParallelMoE(1024, 4096, 8)`` over mp4 (2 experts a
        rank) on x [4, 1024, 1024]: out, aux and the gradients of x, gate,
        wi and wo within ``EP_RTOL`` of each largest value of one
        process's layer.

    The one-process references run first, in this process, and their
    weights, batches and results reach the ranks through ``/dev/shm``;
    the card is freed before the world starts. Returns rank 0's launch
    counts by path."""
    import gc
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed import launch as dlaunch
    from paddle_tpu_torch.incubate import ExpertParallelMoE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="sp_pp_ep_", dir=shm)

    def save(obj, name):
        torch.save(obj, os.path.join(root, name))

    def cpu_state(layer):
        return {k: v.detach().cpu() for k, v in layer.state_dict().items()}

    def grads(layer):
        return {k: p.grad.detach().cpu()
                for k, p in layer.named_parameters()}

    def adamw(model):
        return pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  parameters=model.parameters())

    try:
        ref = {}
        # (a) one process on blockwise attention: B1-B4 at S 8192
        pt.seed(0)
        model = sp_decoder(pt, "blockwise")
        lm_loss = _bench_lm_loss(model)
        save(cpu_state(model), "sp_state.pt")
        ids, labels = (torch.as_tensor(a, device="cuda")
                       for a in _sp_batch())
        lm_loss(model(ids), labels).backward()
        save(grads(model), "sp_grads.pt")
        model.clear_gradients()
        step = pt.jit.TrainStep(model, lm_loss, adamw(model))
        ref["sp"] = [step(ids, labels).item() for _ in range(SP_STEPS)]
        del model, step, lm_loss, ids, labels
        # (b) one process's TrainStep over the pipeline's layers
        pt.seed(1)
        layer = pt.distributed.PipelineLayer(pp_gpt_layers(pt),
                                             loss_fn=pp_loss)
        save(cpu_state(layer), "pp_state.pt")
        ids, labels = (torch.as_tensor(a, device="cuda")
                       for a in _mc_batch())
        pp_loss(layer(ids), labels).backward()
        save(grads(layer), "pp_grads.pt")
        layer.clear_gradients()
        step = pt.jit.TrainStep(layer, pp_loss, adamw(layer))
        ref["pp"] = [step(ids, labels).item() for _ in range(PP_STEPS)]
        del layer, step, ids, labels
        # (c) one process's MoE layer
        pt.seed(2)
        moe = ExpertParallelMoE(D_MODEL, EP_HIDDEN, EP_EXPERTS)
        save(cpu_state(moe), "ep_state.pt")
        gen = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn(EP_X, device="cuda", generator=gen)
        cot = torch.randn(EP_X, device="cuda", generator=gen)
        save({"x": x.cpu(), "cot": cot.cpu()}, "ep_inputs.pt")
        x.requires_grad_()
        out, aux = moe(x)
        ((out * cot).sum() + EP_AUX_W * aux).backward()
        save({"out": out.detach().cpu(), "aux": aux.detach().cpu(),
              "x": x.grad.cpu(), **{k: v for k, v in grads(moe).items()}},
             "ep_ref.pt")
        ref["ep_aux"] = aux.item()
        del moe, x, cot, out, aux
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with open(os.path.join(root, "ref.json"), "w") as f:
            json.dump(ref, f)
        print(f"sp/pp/ep: one-process references in "
              f"{time.perf_counter() - t0:.1f} s: sp (blockwise, S="
              f"{SP_SEQ}) losses {ref['sp']}, pp losses {ref['pp']}, "
              f"MoE aux {ref['ep_aux']!r}")
        logs = os.path.join(root, "logs")
        t1 = time.perf_counter()
        rc = dlaunch.launch(os.path.abspath(__file__), ["--sp-child", root],
                            nproc_per_node=SP_WORLD, log_dir=logs,
                            deadline=SP_DEADLINE_S)
        world_s = time.perf_counter() - t1
        for r in range(SP_WORLD):
            with open(os.path.join(logs, f"workerlog.{r}")) as f:
                text = f.read()
            if rc != 0 or r == 0:
                print(f"--- rank {r} log ---\n{text.rstrip()}")
        if rc != 0:
            fail(f"sp/pp/ep: the world of {SP_WORLD} ranks exited with "
                 f"code {rc}")
        res = []
        for r in range(SP_WORLD):
            with open(os.path.join(root, f"sp_rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"sp/pp/ep: world of {SP_WORLD} ranks ran in {world_s:.1f} s on "
          f"{card}, 4 ranks sharing one H100 over gloo")
    for r, o in enumerate(res):
        bad = [c for part in ("a", "b", "c") for c in o[f"{part}_counts"]
               if c["backend"] != "gloo" or c["transport"] != "gloo-cuda"]
        if bad:
            fail(f"sp/pp/ep rank {r}: a collective left the rule's backend "
                 f"(gloo, gloo-cuda): {bad}")
        # (a)
        for i, (got, want) in enumerate(zip(o["a_losses"], ref["sp"])):
            if abs(got - want) > SP_LOSS_RTOL * abs(want):
                fail(f"sp4 rank {r} step {i + 1}: loss {got!r} against one "
                     f"process's {want!r}")
        if o["a_grad_worst"] > SP_GRAD_RTOL:
            fail(f"sp4 rank {r}: gradient {o['a_grad_worst_name']} off by "
                 f"{o['a_grad_worst']:.3e} of its largest value")
        want = SP_STEPS * SP_LAYERS * (r + 1)
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            if o["a_launches"][name] != {"float32": want}:
                fail(f"sp4 rank {r}: {name} launches "
                     f"{o['a_launches'][name]}, expected {want} float32")
            if o["a_shapes"][name] != [list(SP_RING_SHAPE)]:
                fail(f"sp4 rank {r}: {name} at {o['a_shapes'][name]}")
            if o["u_launches"][name] != {"bfloat16": SP_LAYERS} or \
                    o["u_shapes"][name] != [list(SP_ULYSSES_SHAPE)]:
                fail(f"sp4 Ulysses rank {r}: {name} launches "
                     f"{o['u_launches'][name]} at {o['u_shapes'][name]}")
            if o["rb_launches"][name] != {"bfloat16": SP_LAYERS * (r + 1)}:
                fail(f"sp4 bf16 ring rank {r}: {name} launches "
                     f"{o['rb_launches'][name]}")
        if o["a_partials"] != want:
            fail(f"sp4 rank {r}: {o['a_partials']} partial-op calls, "
                 f"expected {want}")
        if abs(o["u_loss"] - o["rb_loss"]) > SP_ULYSSES_RTOL * abs(
                o["rb_loss"]):
            fail(f"sp4 rank {r}: bf16 Ulysses loss {o['u_loss']!r} against "
                 f"the bf16 ring's {o['rb_loss']!r}")
        if o["u_direct_err"] > 2 ** -7 * o["u_direct_max"]:
            fail(f"sp4 rank {r}: ulysses_attention(use_pallas) off the "
                 f"flash kernel by {o['u_direct_err']:.3e}")
        # (b)
        for i, (got, want) in enumerate(zip(o["b_losses"], ref["pp"])):
            if abs(got - want) > SP_LOSS_RTOL * abs(want):
                fail(f"pp2 x mp2 rank {r} step {i + 1}: loss {got!r} "
                     f"against one process's {want!r}")
        if o["b_grad_worst"] > SP_GRAD_RTOL:
            fail(f"pp2 x mp2 rank {r}: gradient {o['b_grad_worst_name']} "
                 f"off by {o['b_grad_worst']:.3e} of its largest value")
        if abs(o["b_fthenb_loss"] - o["b_1f1b_loss"]) > \
                PP_SCHEDULE_RTOL * abs(o["b_1f1b_loss"]):
            fail(f"pp2 x mp2 rank {r}: F-then-B loss {o['b_fthenb_loss']!r}"
                 f" against 1F1B's {o['b_1f1b_loss']!r}")
        per = PP_STEPS * PP_MICRO * (SP_LAYERS // 2)
        want = {k: {"float32": n * per} for k, n in (
            ("flash_attention_fwd", 1), ("flash_attention_bwd_dq", 1),
            ("flash_attention_bwd_dkv", 1), ("layer_norm_fwd", 1),
            ("add_layer_norm_fwd", 1), ("layer_norm_bwd", 2))}
        if o["b_launches"] != want:
            fail(f"pp2 x mp2 rank {r}: launches {o['b_launches']}, "
                 f"expected {want}")
        # (c)
        if o["c_worst"] > EP_RTOL:
            fail(f"ep4 rank {r}: {o['c_worst_name']} off by "
                 f"{o['c_worst']:.3e} of its largest value")
    for key in ("a_losses", "b_losses", "u_loss", "rb_loss"):
        if any(o[key] != res[0][key] for o in res):
            fail(f"sp/pp/ep: {key} differ across ranks: "
                 f"{[o[key] for o in res]}")
    r0 = res[0]
    a_ms, b_ms = float(np.mean(r0["a_ms"])), float(np.mean(r0["b_ms"]))
    print(f"sp4 (a) float32 ring_pallas: losses {r0['a_losses']} (one "
          f"process, blockwise: {ref['sp']}); worst first-step gradient "
          f"{max(o['a_grad_worst'] for o in res):.3e} of its largest "
          f"({r0['a_grad_worst_name']}); B1/B3/B4 launches by rank "
          f"{[o['a_launches']['flash_attention_fwd'] for o in res]} over "
          f"{SP_STEPS} steps at {list(SP_RING_SHAPE)}")
    print(f"sp4 (a) {SP_STEPS} steps: step ms {[round(x, 1) for x in r0['a_ms']]}"
          f", mean {a_ms:.1f} ms, {SP_SEQ / a_ms * 1e3:.1f} global "
          f"tokens/s; peak memory by rank "
          f"{[round(o['a_peak_gib'], 2) for o in res]} GiB")
    for c in r0["a_counts"]:
        print(f"sp4 (a) rank 0 collectives, {SP_STEPS} steps: {c['op']} "
              f"{c['backend']}/{c['transport']}: {c['calls']} calls, "
              f"{c['bytes'] / 2 ** 20:.1f} MiB, {c['ms']:.1f} host ms")
    print(f"sp4 bf16 AMP step: Ulysses loss {r0['u_loss']!r}, ring_pallas "
          f"loss {r0['rb_loss']!r}; Ulysses launches "
          f"{r0['u_launches']['flash_attention_fwd']} at "
          f"{list(SP_ULYSSES_SHAPE)}; direct ulysses_attention(use_pallas) "
          f"max|err| {r0['u_direct_err']:.3e} (max|out| "
          f"{r0['u_direct_max']:.3e})")
    print(f"pp2 x mp2 (b) 1F1B: losses {r0['b_losses']} (one process "
          f"{ref['pp']}); F-then-B pass {r0['b_fthenb_loss']!r} against "
          f"1F1B {r0['b_1f1b_loss']!r}; worst first-step gradient "
          f"{max(o['b_grad_worst'] for o in res):.3e} "
          f"({r0['b_grad_worst_name']}); step ms "
          f"{[round(x, 1) for x in r0['b_ms']]}, mean {b_ms:.1f} ms, "
          f"{PP_BATCH * TRAIN_S / b_ms * 1e3:.1f} tokens/s; peak memory "
          f"by rank (stage) {[(round(o['b_peak_gib'], 2), o['b_stage']) for o in res]} GiB")
    for c in res[0]["b_counts"] + res[2]["b_counts"]:
        print(f"pp2 x mp2 (b) collectives, {PP_STEPS} steps: {c['op']} "
              f"{c['backend']}/{c['transport']}: {c['calls']} calls, "
              f"{c['bytes'] / 2 ** 20:.1f} MiB, {c['ms']:.1f} host ms")
    print(f"ep4 (c) MoE: worst {max(o['c_worst'] for o in res):.3e} of the "
          f"largest ({r0['c_worst_name']}); aux {r0['c_aux']!r} (one "
          f"process {ref['ep_aux']!r}); local experts "
          f"{r0['c_local']}")
    return {"sp4_ring_pallas": {k: sum(v.values()) for k, v in
                                r0["a_launches"].items()},
            "sp4_ulysses_bf16": {k: sum(v.values()) for k, v in
                                 r0["u_launches"].items()},
            "pp2_mp2_1f1b": {k: sum(v.values()) for k, v in
                             r0["b_launches"].items()},
            "ep4_moe": {k: sum(v.values()) for k, v in
                        r0["c_launches"].items()},
            "partial_op": r0["a_partials"]}


def sp_child(argv) -> int:
    """``python3 chip_smoke.py --sp-child DIR``: one rank of
    ``sp_pp_ep_phase``'s world, started by the port's launcher. Writes its
    results to ``DIR/sp_rank<r>.json``."""
    import gc

    root, = argv
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.core.tensor import to_torch
    from paddle_tpu_torch.distributed import comm, fleet
    from paddle_tpu_torch.incubate import ExpertParallelMoE
    from paddle_tpu_torch.nn.layers import ring_attention as ra
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    mon = dist.comm_monitor.monitor()
    out = {"rank": rank}
    t_start = time.perf_counter()

    def done(what):
        print(f"rank {rank}: {what} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def init(**degrees):
        comm._mesh = None
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
        return s

    def load(name):
        return torch.load(os.path.join(root, name), mmap=True)

    def worst(model, want_name):
        want = load(want_name)
        w, wn = 0.0, ""
        for name, p in model.named_parameters():
            if p.grad is None:
                continue
            shard = getattr(p, "_tp_shard", None)
            full = shard.gather(p.grad) if shard is not None else p.grad
            ref = want[name].to(dev)
            rel = ((full - ref).abs().max() / ref.abs().max()).item()
            if rel > w:
                w, wn = rel, name
        return w, wn

    def adamw(model):
        return pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  parameters=model.parameters())

    def timed(fn, n):
        ms, vals = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            vals.append(fn())
            ms.append((time.perf_counter() - t) * 1e3)
        return vals, ms

    # (a) sp4 on ring_pallas
    fleet.init(is_collective=True, strategy=init(sp=SP_WORLD))
    pt.seed(0)
    model = sp_decoder(pt, "ring_pallas")
    model.set_state_dict(load("sp_state.pt"))
    lm_loss = _bench_lm_loss(model)
    fl = fleet.distributed_model(model)
    ids, labels = (fl.shard_input(a) for a in _sp_batch())
    loss = lm_loss(fl(ids), labels)
    loss.backward()
    out["a_grad_worst"], out["a_grad_worst_name"] = worst(model,
                                                          "sp_grads.pt")
    model.clear_gradients()
    del loss
    step = pt.jit.TrainStep(fl, lm_loss, fleet.distributed_optimizer(
        adamw(model)))
    torch.cuda.reset_peak_memory_stats()
    mon.reset_counts()
    kernels.reset_launches()  # the sp4 path starts here
    losses, ms = timed(lambda: step(ids, labels).item(), SP_STEPS)
    out.update(a_launches=kernels.launches_by_dtype(),  # ... and ends here
               a_shapes=kernels.launch_shapes(),
               a_partials=fa.flash_attention_partial.launches,
               a_losses=losses, a_ms=ms, a_counts=mon.comm_counts(),
               a_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del step
    gc.collect()

    # one bf16 AMP O1 step on ring_pallas, then on ulysses, same weights
    def bf16_step(impl):
        model.set_state_dict(load("sp_state.pt"))
        _set_attn(model, impl)
        kernels.reset_launches()
        with pt.amp.auto_cast(True, level="O1", dtype="bfloat16"):
            loss = to_torch(lm_loss(fl(ids), labels))
        with fl.no_sync():  # the gradients are not read
            loss.backward()
        model.clear_gradients()
        val = loss.detach().reshape(1).float()
        dist.collective.all_reduce_(val, dist.ReduceOp.AVG,
                                    comm.data_group())
        return val.item(), kernels.launches_by_dtype(), \
            kernels.launch_shapes()

    done("(a) sp4 float32")
    out["rb_loss"], out["rb_launches"], _ = bf16_step("ring_pallas")
    out["u_loss"], out["u_launches"], out["u_shapes"] = bf16_step("ulysses")
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((1, HEADS, SP_SEQ, D_MODEL // HEADS),
                           device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    with torch.no_grad():
        got = ra.ulysses_attention(q, k, v, causal=True, use_pallas=True)
        want = fa.FlashAttentionFunction.apply(q, k, v, True, 512, 512)
    out["u_direct_err"] = (got.float() - want.float()).abs().max().item()
    out["u_direct_max"] = want.float().abs().max().item()
    del model, fl, ids, labels, lm_loss, q, k, v, got, want
    gc.collect()
    torch.cuda.empty_cache()
    done("(a) sp4 bf16 Ulysses and ring")

    # (b) pp2 x mp2, 1F1B over 4 microbatches
    s = init(pp=2, mp=2)
    s.pipeline = True
    s.pipeline_configs = {"accumulate_steps": PP_MICRO,
                          "schedule_mode": "1F1B"}
    fleet.init(is_collective=True, strategy=s)
    pt.seed(1)
    layer = pt.distributed.PipelineLayer(pp_gpt_layers(pt), loss_fn=pp_loss)
    layer.set_state_dict(load("pp_state.pt"))
    model = fleet.distributed_model(layer)
    data = list(_mc_batch())
    out["b_1f1b_loss"] = model.forward_backward_pipeline(data).item()
    out["b_grad_worst"], out["b_grad_worst_name"] = worst(layer,
                                                          "pp_grads.pt")
    layer.clear_gradients()
    model.schedule_mode = "F-then-B"
    out["b_fthenb_loss"] = model.forward_backward_pipeline(data).item()
    model.schedule_mode = "1F1B"
    layer.clear_gradients()
    opt = fleet.distributed_optimizer(adamw(model))
    torch.cuda.reset_peak_memory_stats()
    mon.reset_counts()
    kernels.reset_launches()  # the pp2 x mp2 path starts here
    losses, ms = timed(lambda: model.train_batch(data, opt).item(),
                       PP_STEPS)
    out.update(b_launches=kernels.launches_by_dtype(),  # ... and ends here
               b_losses=losses, b_ms=ms, b_counts=mon.comm_counts(),
               b_stage=model.stage_id,
               b_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, layer, opt
    gc.collect()
    torch.cuda.empty_cache()
    done("(b) pp2 x mp2")

    # (c) ep4: 2 of the 8 experts a rank
    fleet.init(is_collective=True, strategy=init(mp=SP_WORLD))
    pt.seed(2)
    moe = ExpertParallelMoE(D_MODEL, EP_HIDDEN, EP_EXPERTS)
    moe.set_state_dict(load("ep_state.pt"))
    inputs = load("ep_inputs.pt")
    x = inputs["x"].to(dev).requires_grad_()
    mon.reset_counts()
    kernels.reset_launches()  # the ep4 path starts here
    o, aux = moe(x)
    ((o * inputs["cot"].to(dev)).sum() + EP_AUX_W * aux).backward()
    out.update(c_launches=kernels.launches_by_dtype(),  # ... ends here
               c_counts=mon.comm_counts(), c_aux=aux.item(),
               c_local={n: list(p.shape) for n, p in
                        moe.named_parameters()})
    want = load("ep_ref.pt")
    got = {"out": o.detach(), "aux": aux.detach(), "x": x.grad}
    for n, p in moe.named_parameters():
        shard = getattr(p, "_tp_shard", None)
        got[n] = shard.gather(p.grad) if shard is not None else p.grad
    w, wn = 0.0, ""
    for n, g in got.items():
        ref = want[n].to(dev)
        rel = ((g - ref).abs().max() / ref.abs().max().clamp(min=1e-30)
               ).item()
        if rel > w:
            w, wn = rel, n
    out.update(c_worst=w, c_worst_name=wn)
    print(f"rank {rank}: {json.dumps(out)}", flush=True)
    with open(os.path.join(root, f"sp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    comm.destroy_parallel_env()
    return 0


def _scaled(launches, layers, steps):
    """``launches`` (per step of the 24-block model, by input types) for
    ``steps`` steps of a ``layers``-block cut."""
    return {k: {t: n * steps * layers // LAYERS for t, n in v.items()}
            for k, v in launches.items()}


def _moment_bytes(opt):
    """The resident bytes of an Adam optimizer's two moments, payload and
    scales, counted from its accumulators."""
    accs = opt._accumulators
    return sum(t.numel() * t.element_size()
               for nm in ("moment1", "moment2", "moment1_scale",
                          "moment2_scale") if nm in accs
               for t in accs[nm].values())


def q8m_phase(pt, kernels, card):
    """bench.py's ``_bench_gpt_q8m`` program: GPT-medium (full width, 24
    blocks), B = 4, S = 1024, AdamW 1e-4 / 0.01 through
    ``fleet.distributed_optimizer`` with ``strategy.quantized_moments =
    "int8"``, ``TrainStep``, bench's loss and batch.

    (a) float32, TF32 off: ``Q8M_STEPS`` steps with int8 moments against
        the same steps with wide moments, from the same weights; losses 1
        and 2 within ``Q8M_EXACT_RTOL``, the last within
        ``Q8M_LOSS_RTOL`` (the constants' note); the resident moment bytes
        counted from the optimizer's accumulators (int8 payloads, float32
        scales) equal ``moment_bytes_info``'s ``bytes_resident``, 3.88x
        below float32; B1-B7 at their float32 counts.
    (b) the program as bench writes it: bf16 AMP, int8 moments and then
        wide ones, one warm-up step and ``Q8M_STEPS`` timed: ms/step,
        tokens/s, peak memory, B1-B7 at ``AMP_LAUNCHES``.
    (c) one float32 step under ``strategy.quantized_matmul = "int8"`` at
        ``QAT_LAYERS`` blocks: its loss within ``QAT_LOSS_RTOL`` of the
        dense loss, each weight gradient float32 and within
        ``QAT_GRAD_RTOL`` of its largest dense value (and not equal to
        it), B1/B3/B4 ``QAT_LAYERS`` times.

    Returns the launch counts of (a)'s int8 run, (b)'s int8 run and
    (c)."""
    import gc

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import quantized_compute as qcp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    pt.seed(4)
    model = _gpt_medium()
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    lm_loss = _bench_lm_loss(model)
    n = TRAIN_B * TRAIN_S
    ids = torch.as_tensor((np.arange(n) % 31000).reshape(TRAIN_B, TRAIN_S),
                          device="cuda")
    labels = torch.as_tensor(((np.arange(n) + 1) % 31000).reshape(
        TRAIN_B, TRAIN_S), device="cuda")

    def trainer(quant, amp):
        s = fleet.DistributedStrategy()
        s.amp = amp
        if quant:
            s.quantized_moments = "int8"
        fleet.init(is_collective=True, strategy=s)
        model.set_state_dict(init)
        opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=1e-4, weight_decay=0.01,
            parameters=model.parameters()), strategy=s)
        return pt.jit.TrainStep(model, lm_loss, opt), opt

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # (a) float32: int8 moments against wide ones
    a = {}
    for name in ("wide", "int8"):
        step, opt = trainer(name == "int8", False)
        kernels.reset_launches()  # the float32 q8m path starts here
        a[name] = [step(ids, labels).item() for _ in range(Q8M_STEPS)]
        a[f"{name}_launches"] = kernels.launches_by_dtype()  # ... ends here
        a[f"{name}_bytes"] = _moment_bytes(opt._inner)
        if name == "int8":
            info = step._moment_bytes_info
            accs = opt._inner._accumulators
            types = {nm: sorted({str(t.dtype) for t in accs[nm].values()})
                     for nm in ("moment1", "moment2", "moment1_scale",
                                "moment2_scale")}
        del step, opt
        free()
    print(f"q8m (a) float32 on {card}, B={TRAIN_B} S={TRAIN_S}, "
          f"{Q8M_STEPS} AdamW steps: losses int8 moments {a['int8']}, wide "
          f"{a['wide']}; |diff| "
          f"{[abs(x - y) for x, y in zip(a['int8'], a['wide'])]}; moment "
          f"bytes counted {a['int8_bytes']} (moment_bytes_info "
          f"{info['bytes_resident']}, x{info['reduction_x']} below float32 "
          f"{info['bytes_f32']}; wide run's counted {a['wide_bytes']}); "
          f"types {types}")
    for i, (q, w) in enumerate(zip(a["int8"], a["wide"])):
        tol = Q8M_EXACT_RTOL if i < 2 else Q8M_LOSS_RTOL
        if not math.isfinite(q) or abs(q - w) > tol * abs(w):
            fail(f"q8m (a): step {i + 1} loss {q!r} with int8 moments "
                 f"against {w!r} with wide ones (rtol {tol})")
    if a["int8_bytes"] != info["bytes_resident"] \
            or a["wide_bytes"] != info["bytes_f32"] \
            or info["reduction_x"] < 3.8:
        fail(f"q8m (a): moment bytes {a['int8_bytes']} (wide "
             f"{a['wide_bytes']}) against {info}")
    if types != {"moment1": ["torch.int8"], "moment2": ["torch.int8"],
                 "moment1_scale": ["torch.float32"],
                 "moment2_scale": ["torch.float32"]}:
        fail(f"q8m (a): moment types {types}")
    for name in ("wide", "int8"):
        if a[f"{name}_launches"] != _scaled(DYGRAPH_LAUNCHES, LAYERS,
                                            Q8M_STEPS):
            fail(f"q8m (a) {name}: launches {a[f'{name}_launches']}")

    # (b) bench's program: bf16 AMP, int8 moments then wide ones
    b = {}
    for name in ("int8", "wide"):
        step, opt = trainer(name == "int8", True)
        step(ids, labels).item()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()  # the bf16 q8m path starts here
        losses, ms = [], []
        for _ in range(Q8M_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(step(ids, labels).item())  # .item() syncs
            ms.append((time.perf_counter() - t1) * 1e3)
        b[name] = dict(losses=losses, ms=ms,
                       launches=kernels.launches_by_dtype(),  # ... ends here
                       peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        del step, opt
        free()
        mean = float(np.mean(ms))
        print(f"q8m (b) bf16 AMP, {name} moments, {Q8M_STEPS} steps after "
              f"one warm-up on {card}: losses {losses}; step ms "
              f"{[round(x, 2) for x in ms]}, mean {mean:.2f} ms, "
              f"{TRAIN_B * TRAIN_S / mean * 1e3:.1f} tokens/s; peak memory "
              f"{b[name]['peak']:.2f} GiB; launches {b[name]['launches']}")
        if not all(np.isfinite(losses)):
            fail(f"q8m (b) {name}: losses {losses}")
        if b[name]["launches"] != _scaled(AMP_LAUNCHES, LAYERS, Q8M_STEPS):
            fail(f"q8m (b) {name}: launches {b[name]['launches']}")
    del model, init, lm_loss
    free()

    # (c) one float32 step through the QAT matmul at QAT_LAYERS blocks
    pt.seed(5)
    model = _gpt_cut(QAT_LAYERS)
    lm_loss = _bench_lm_loss(model)
    qinit = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def eager(scope):
        model.zero_grad(set_to_none=True)
        with qcp.matmul_scope(scope):
            loss = lm_loss(model(ids), labels)
        loss.backward()
        out = {k: p.grad.detach().clone()
               for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), out

    loss_d, g_d = eager(None)
    loss_q, g_q = eager(("int8", 128))
    worst, worst_name, moved = 0.0, "", False
    for k, g in g_q.items():
        if g.dtype != torch.float32 or not bool(torch.isfinite(g).all()):
            fail(f"q8m (c): the QAT gradient of {k} is not finite float32")
        rel = ((g - g_d[k]).abs().max() / g_d[k].abs().max()).item()
        moved |= rel > 0
        if rel > worst:
            worst, worst_name = rel, k
    s = fleet.DistributedStrategy()
    s.quantized_matmul = "int8"
    fleet.init(is_collective=True, strategy=s)
    model.set_state_dict(qinit)
    step = pt.jit.TrainStep(model, lm_loss, fleet.distributed_optimizer(
        pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                           parameters=model.parameters()), strategy=s))
    kernels.reset_launches()  # the QAT step starts here
    loss_s = step(ids, labels).item()
    c_launches = kernels.launches_by_dtype()  # ... and ends here
    print(f"q8m (c) quantized_matmul int8, {QAT_LAYERS} blocks, float32: "
          f"TrainStep loss {loss_s!r}, eager QAT loss {loss_q!r}, dense "
          f"{loss_d!r} (rel {abs(loss_q - loss_d) / abs(loss_d):.3e}, "
          f"tolerance {QAT_LOSS_RTOL}); worst weight gradient against the "
          f"dense one {worst:.3e} of its largest ({worst_name}; tolerance "
          f"{QAT_GRAD_RTOL}); q_matmul {step._q_matmul_info}; launches "
          f"{c_launches}; phase {time.perf_counter() - t0:.1f} s")
    if not math.isfinite(loss_s) or abs(loss_s - loss_q) > \
            Q8M_EXACT_RTOL * abs(loss_q) or abs(loss_q - loss_d) > \
            QAT_LOSS_RTOL * abs(loss_d):
        fail("q8m (c): the QAT loss strays from the dense loss")
    if worst > QAT_GRAD_RTOL or not moved:
        fail(f"q8m (c): QAT gradients {worst:.3e} off the dense ones")
    if c_launches != _scaled(DYGRAPH_LAUNCHES, QAT_LAYERS, 1):
        fail(f"q8m (c): launches {c_launches}")
    del model, step, lm_loss, qinit, g_q, g_d
    free()
    return {"q8m_f32_int8": {k: sum(v.values()) for k, v in
                             a["int8_launches"].items()},
            "q8m_bf16_int8": {k: sum(v.values()) for k, v in
                              b["int8"]["launches"].items()},
            "q8m_qat_f32": {k: sum(v.values()) for k, v in
                            c_launches.items()}}


def _dpq8_batch():
    """bench.py's _bench_gpt_dp_q8 batch: the global [16, S] ids and
    next-token labels, as numpy."""
    n = DPQ8_BATCH * TRAIN_S
    ids = (np.arange(n) % 31000).reshape(DPQ8_BATCH, TRAIN_S) \
        .astype(np.int64)
    labels = ((np.arange(n) + 1) % 31000).reshape(DPQ8_BATCH, TRAIN_S) \
        .astype(np.int64)
    return ids, labels


def _dpq8_strategy(fleet, quant, amp):
    """bench's _bench_gpt_dp_q8 strategy: hierarchical dcn x ici2 dp, the
    async dcn hop, ``quant`` ("int8" or None), ``amp``."""
    s = fleet.DistributedStrategy()
    s.amp = amp
    s.hierarchical_allreduce = True
    s.hierarchical_allreduce_inter_nranks = DPQ8_ICI
    s.async_dcn_allreduce = True
    if quant:
        s.quantized_allreduce = quant
    return s


def _hop_bytes(counts, op, group):
    return sum(c["bytes"] for c in counts
               if c["op"] == op and c["group"] == group)


def dp_q8_phase(pt, kernels, card):
    """bench.py's ``_bench_gpt_dp_q8`` program at GPT-medium's full width
    and ``DPQ8_LAYERS`` of its 24 blocks (a depth cut) as a world of 4
    ranks of this script (``--dpq8-child``), dp4 = dcn2 x ici2, all on this
    card over gloo, started by the port's launcher with a deadline; 4 rows
    a rank, global B = 16, S = 1024, AdamW 1e-4 / 0.01 through fleet with
    ``hierarchical_allreduce`` (inter_nranks 2) and
    ``async_dcn_allreduce``.

    The parent first runs, on the global batch, from the same weights
    (seed 0): the first-step gradients; each dcn group's (rows 0-7 and
    8-15) and from them the oracle (each through the plain quantizer,
    ``quantize_dequantize``, then averaged); ``DPQ8_STEPS`` float32
    ``TrainStep`` losses. Then each rank:

    (a) float32, TF32 off, the policy off: first-step gradients (what the
        update receives) within ``MC_GRAD_RTOL`` of one process's largest
        value, losses within ``MC_LOSS_RTOL``;
    (b) float32, ``quantized_allreduce = "int8"``: first-step gradients
        against the oracle within the note's per-block bound
        (``DPQ8_ORACLE_RTOL``), and not the full-width gradients;
    (c) (b)'s losses within ``DPQ8_LOSS_RTOL`` / ``DPQ8_LOSS_ATOL`` of
        (a)'s;
    (d) bench's program as written (bf16 AMP O1), int8 and off: one
        warm-up step and ``DPQ8_STEPS`` timed: ms/step, global tokens/s,
        host ms and bytes of each collective by (op, group, transport),
        peak memory by rank; the dcn hop's bytes at least
        ``DPQ8_BYTES_X`` times fewer under int8 (and equal to 3 steps of
        ``grad_comm_info``'s dcn hop), the ici hop's unchanged.

    Fails when a rank exits non-zero or outlives ``DPQ8_DEADLINE_S``, when a
    collective ran on another backend than the rule's, when a gate fails,
    or when a kernel of the path was not launched at its count or ran in
    other types. Returns rank 0's launch counts of (a), (b) and (d)."""
    import gc
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed import launch as dlaunch
    from paddle_tpu_torch.distributed import quantized_comm as qc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="dp_q8_", dir=shm)
    try:
        pt.seed(0)
        model = _gpt_cut(DPQ8_LAYERS)
        lm_loss = _bench_lm_loss(model)
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()},
                   os.path.join(root, "state.pt"))
        ids, labels = (torch.as_tensor(a, device="cuda")
                       for a in _dpq8_batch())

        def grads(rows):
            model.clear_gradients()
            lm_loss(model(ids[rows]), labels[rows]).backward()
            out = {k: p.grad.detach().clone()
                   for k, p in model.named_parameters()}
            model.clear_gradients()
            return out

        half = DPQ8_BATCH // 2
        torch.save({k: v.cpu() for k, v in grads(slice(None)).items()},
                   os.path.join(root, "grads.pt"))
        g0, g1 = grads(slice(0, half)), grads(slice(half, None))
        torch.save({k: ((qc.quantize_dequantize(g0[k], "int8", 128)
                         + qc.quantize_dequantize(g1[k], "int8", 128))
                        / 2).cpu() for k in g0},
                   os.path.join(root, "oracle.pt"))
        # each 128-block's step: the larger of the two groups' scales
        torch.save({k: torch.maximum(
            qc.quantize_blockwise(g0[k], "int8", 128)[1],
            qc.quantize_blockwise(g1[k], "int8", 128)[1]).cpu()
            for k in g0}, os.path.join(root, "block_step.pt"))
        del g0, g1
        step = pt.jit.TrainStep(model, lm_loss, pt.optimizer.AdamW(
            learning_rate=1e-4, weight_decay=0.01,
            parameters=model.parameters()))
        ref = [step(ids, labels).item() for _ in range(DPQ8_STEPS)]
        del model, step, lm_loss, ids, labels
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"dp_q8: one-process reference, B={DPQ8_BATCH} S={TRAIN_S} "
              f"float32, {DPQ8_LAYERS} blocks: losses {ref}; gradients, "
              f"the dcn groups' oracle written in "
              f"{time.perf_counter() - t0:.1f} s")
        logs = os.path.join(root, "logs")
        t1 = time.perf_counter()
        rc = dlaunch.launch(os.path.abspath(__file__),
                            ["--dpq8-child", root],
                            nproc_per_node=DPQ8_WORLD, log_dir=logs,
                            deadline=DPQ8_DEADLINE_S)
        world_s = time.perf_counter() - t1
        for r in range(DPQ8_WORLD):
            with open(os.path.join(logs, f"workerlog.{r}")) as f:
                text = f.read()
            if rc != 0 or r == 0:
                print(f"--- rank {r} log ---\n{text.rstrip()}")
        if rc != 0:
            fail(f"dp_q8: the world of {DPQ8_WORLD} ranks exited with code "
                 f"{rc}")
        res = []
        for r in range(DPQ8_WORLD):
            with open(os.path.join(root, f"dpq8_rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"dp_q8: world of {DPQ8_WORLD} ranks (dcn{DPQ8_WORLD // DPQ8_ICI} "
          f"x ici{DPQ8_ICI}) ran in {world_s:.1f} s on {card}, 4 ranks "
          "sharing one H100 over gloo")
    f32_want = _scaled(DYGRAPH_LAUNCHES, DPQ8_LAYERS, DPQ8_STEPS)
    bf16_want = _scaled(AMP_LAUNCHES, DPQ8_LAYERS, DPQ8_STEPS)
    for r, o in enumerate(res):
        runs = ("a", "b", "d_int8", "d_off")
        bad = [c for run in runs for c in o[f"{run}_counts"]
               if c["backend"] != "gloo" or c["transport"] != "gloo-cuda"]
        if o["backend"] != "gloo" or bad:
            fail(f"dp_q8 rank {r}: a collective left the rule's backend "
                 f"(gloo, gloo-cuda): {o['backend']}, {bad}")
        for i, (got, want) in enumerate(zip(o["a_losses"], ref)):
            if abs(got - want) > MC_LOSS_RTOL * abs(want):
                fail(f"dp_q8 (a) rank {r} step {i + 1}: loss {got!r} "
                     f"against one process's {want!r}")
        if o["a_grad_worst"] > MC_GRAD_RTOL:
            fail(f"dp_q8 (a) rank {r}: gradient {o['a_grad_worst_name']} "
                 f"off by {o['a_grad_worst']:.3e} of its largest value")
        for run, want in (("a", [True, True, None, False]),
                          ("b", [True, True, ["int8", 128], False])):
            if o[f"{run}_flags"] != want:
                fail(f"dp_q8 ({run}) rank {r}: the step's dcn hop "
                     f"(explicit, per gradient, policy, boundary flag left "
                     f"set) {o[f'{run}_flags']}, expected {want}")
        if o["b_oracle_worst"] > 1.0:
            fail(f"dp_q8 (b) rank {r}: gradient {o['b_oracle_worst_name']} "
                 f"off the oracle by {o['b_oracle_worst']:.3f} of its bound")
        if o["b_full_width"] <= MC_GRAD_RTOL:
            fail(f"dp_q8 (b) rank {r}: the int8 hop's gradients are the "
                 f"full-width ones (at most {o['b_full_width']:.3e} of "
                 "their largest value off them)")
        for i, (q, f) in enumerate(zip(o["b_losses"], o["a_losses"])):
            if abs(q - f) > DPQ8_LOSS_RTOL * abs(f) + DPQ8_LOSS_ATOL:
                fail(f"dp_q8 (c) rank {r} step {i + 1}: int8 loss {q!r} "
                     f"against the policy-off {f!r}")
        for run, want in (("a", f32_want), ("b", f32_want),
                          ("d_int8", bf16_want), ("d_off", bf16_want)):
            if o[f"{run}_launches"] != want:
                fail(f"dp_q8 {run} rank {r}: launches "
                     f"{o[f'{run}_launches']}, expected {want}")
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            if o["a_shapes"][name] != [list(DPQ8_RANK_SHAPE)]:
                fail(f"dp_q8 rank {r}: {name} at {o['a_shapes'][name]}")
        q8 = _hop_bytes(o["d_int8_counts"], "quantized_allreduce", "dcn")
        full = _hop_bytes(o["d_off_counts"], "all_reduce", "dcn")
        ici = [_hop_bytes(o[f"d_{k}_counts"], "all_reduce", "ici")
               for k in ("int8", "off")]
        priced = DPQ8_STEPS * o["grad_comm"]["hops"]["dcn"]["bytes_on_wire"]
        if not q8 or full / q8 < DPQ8_BYTES_X or q8 != priced \
                or ici[0] != ici[1] or not ici[0]:
            fail(f"dp_q8 rank {r}: hop bytes dcn int8 {q8} (priced "
                 f"{priced}), off {full}; ici {ici}")
        if not all(np.isfinite(o["d_int8_losses"] + o["d_off_losses"])):
            fail(f"dp_q8 (d) rank {r}: losses {o['d_int8_losses']} "
                 f"{o['d_off_losses']}")
    for key in ("a_losses", "b_losses", "d_int8_losses", "d_off_losses"):
        if any(o[key] != res[0][key] for o in res):
            fail(f"dp_q8: {key} differ across ranks: "
                 f"{[o[key] for o in res]}")
    r0 = res[0]
    print(f"dp_q8 (a) float32 policy off: losses {r0['a_losses']} (one "
          f"process {ref}); worst first-step gradient "
          f"{max(o['a_grad_worst'] for o in res):.3e} of its largest "
          f"({r0['a_grad_worst_name']}); launches a rank {r0['a_launches']}"
          f" at {r0['a_shapes']['flash_attention_fwd']}")
    print(f"dp_q8 (b) float32 int8: losses {r0['b_losses']}; worst first-"
          f"step gradient against the oracle "
          f"{max(o['b_oracle_worst'] for o in res):.3f} of its per-block "
          f"bound ({r0['b_oracle_worst_name']}); off the full-width "
          f"gradients by up to {r0['b_full_width']:.3e} of the largest; "
          f"(c) |int8 - off| "
          f"{[abs(q - f) for q, f in zip(r0['b_losses'], r0['a_losses'])]}")
    for k in ("int8", "off"):
        ms = float(np.mean(r0[f"d_{k}_ms"]))
        print(f"dp_q8 (d) bf16 AMP, dcn hop {k}, {DPQ8_STEPS} steps after "
              f"one warm-up (4 ranks sharing one H100 over gloo): losses "
              f"{r0[f'd_{k}_losses']}; step ms "
              f"{[round(x, 1) for x in r0[f'd_{k}_ms']]}, mean {ms:.1f} ms, "
              f"{DPQ8_BATCH * TRAIN_S / ms * 1e3:.1f} global tokens/s; peak "
              f"memory by rank "
              f"{[round(o[f'd_{k}_peak_gib'], 2) for o in res]} GiB")
        for c in r0[f"d_{k}_counts"]:
            print(f"dp_q8 (d) {k} rank 0 collectives, {DPQ8_STEPS} steps: "
                  f"{c['op']} group {c['group']} {c['backend']}/"
                  f"{c['transport']}: {c['calls']} calls, {c['bytes']} "
                  f"bytes, {c['ms']:.1f} host ms")
    q8 = _hop_bytes(r0["d_int8_counts"], "quantized_allreduce", "dcn")
    full = _hop_bytes(r0["d_off_counts"], "all_reduce", "dcn")
    print(f"dp_q8: dcn hop bytes a rank, {DPQ8_STEPS} steps: off {full}, "
          f"int8 {q8} (x{full / q8:.3f} fewer); ici hop "
          f"{_hop_bytes(r0['d_int8_counts'], 'all_reduce', 'ici')} both; "
          f"grad_comm {r0['grad_comm']}")
    return {"dp_q8_f32_off": {k: sum(v.values()) for k, v in
                              r0["a_launches"].items()},
            "dp_q8_f32_int8": {k: sum(v.values()) for k, v in
                               r0["b_launches"].items()},
            "dp_q8_bf16_int8": {k: sum(v.values()) for k, v in
                                r0["d_int8_launches"].items()}}


def dpq8_child(argv) -> int:
    """``python3 chip_smoke.py --dpq8-child DIR``: one rank of
    ``dp_q8_phase``'s world, started by the port's launcher. Writes its
    results to ``DIR/dpq8_rank<r>.json``."""
    root, = argv
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import comm, fleet
    from paddle_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    rank = dist.get_rank()
    fleet.init(is_collective=True,
               strategy=_dpq8_strategy(fleet, None, False))
    pt.seed(0)
    model = _gpt_cut(DPQ8_LAYERS)
    lm_loss = _bench_lm_loss(model)
    model.set_state_dict(torch.load(os.path.join(root, "state.pt"),
                                    mmap=True))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    fl = fleet.distributed_model(model)
    ids, labels = (fl.shard_input(a) for a in _dpq8_batch())
    mon = dist.comm_monitor.monitor()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank, "backend": comm.backend()}

    class FirstGrads(pt.optimizer.AdamW):
        """AdamW that keeps the first gradients it is given (after the
        reduction and the clip): what the update receives."""
        first = None

        def _functional_update(self, params, grads, lr, t):
            if self.first is None:
                self.first = {self._names[id(p)]: g.detach().clone()
                              for p, g in zip(params, grads)
                              if g is not None}
            return super()._functional_update(params, grads, lr, t)

    def run(quant, amp, warm):
        model.set_state_dict(init)
        s = _dpq8_strategy(fleet, quant, amp)
        opt = FirstGrads(learning_rate=1e-4, weight_decay=0.01,
                         parameters=list(model.named_parameters()))
        step = pt.jit.TrainStep(fl, lm_loss,
                                fleet.distributed_optimizer(opt, strategy=s))
        if warm:
            step(ids, labels).item()
        torch.cuda.reset_peak_memory_stats()
        mon.reset_counts()
        kernels.reset_launches()  # the dp_q8 path starts here
        losses, ms = [], []
        for _ in range(DPQ8_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(step(ids, labels).item())  # .item() syncs
            ms.append((time.perf_counter() - t) * 1e3)
        res = {"losses": losses, "ms": ms,
               "launches": kernels.launches_by_dtype(),  # ... ends here
               "shapes": kernels.launch_shapes(),
               "counts": mon.comm_counts(by_group=True),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "flags": [step._async_dcn, step._hop is not None,
                         step._dcn_quant, step.opt._quant_explicit],
               "grad_comm": step._grad_comm_info}
        return res, opt.first

    def worst(first, ref, bound=None):
        """The largest |got - want| over the parameters, in units of the
        parameter's largest |want|, or of ``bound(k, want)`` per
        element."""
        w, wn = 0.0, ""
        for k, g in first.items():
            want = ref[k].to(dev)
            err = (g - want).abs()
            if bound is None:
                lim = want.abs().max()
                rel = (err.max() / lim).item() if lim > 0 \
                    else float("inf")
            else:
                lim = bound(k, want).clamp_min(torch.finfo(
                    torch.float32).tiny)
                rel = (err / lim).max().item()
            if rel > w:
                w, wn = rel, k
        return w, wn

    # (a) float32, the policy off
    res, first = run(None, False, warm=False)
    ref = torch.load(os.path.join(root, "grads.pt"), mmap=True)
    w, wn = worst(first, ref)
    out.update({f"a_{k}": v for k, v in res.items()},
               a_grad_worst=w, a_grad_worst_name=wn)
    del first, ref
    # (b) float32, the int8 dcn hop, against the oracle
    res, first = run("int8", False, warm=False)
    oracle = torch.load(os.path.join(root, "oracle.pt"), mmap=True)
    block_step = torch.load(os.path.join(root, "block_step.pt"))

    def bound(k, want):
        n = want.numel()
        step = block_step[k].to(dev).repeat_interleave(128)[:n]
        return step.view_as(want) + DPQ8_ORACLE_RTOL * want.abs().max()

    w, wn = worst(first, oracle, bound)
    del oracle
    ref = torch.load(os.path.join(root, "grads.pt"), mmap=True)
    full, _ = worst(first, ref)
    out.update({f"b_{k}": v for k, v in res.items()},
               b_oracle_worst=w, b_oracle_worst_name=wn, b_full_width=full)
    del first, ref
    # (d) bench's program as written: bf16 AMP, int8 and off
    for name, quant in (("int8", "int8"), ("off", None)):
        res, first = run(quant, True, warm=True)
        out.update({f"d_{name}_{k}": v for k, v in res.items()})
        del first
    out["grad_comm"] = out["d_int8_grad_comm"]
    print(f"rank {rank}: {json.dumps(out)}", flush=True)
    with open(os.path.join(root, f"dpq8_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    comm.destroy_parallel_env()
    return 0


def _strat_batches():
    """The strategy phase's two global batches: [8, 1024] ids and
    next-token labels, the second shifted by 7 tokens."""
    n = STRAT_BATCH * TRAIN_S
    out = []
    for shift in (0, 7):
        ids = ((np.arange(n) + shift) % 31000).reshape(STRAT_BATCH, TRAIN_S)
        out.append((ids.astype(np.int64), ((ids + 1) % 31000).astype(
            np.int64)))
    return out


def _elastic_batches():
    """(d)'s global batches: [24, 1024] ids and next-token labels, each
    shifted by 5 tokens from the one before."""
    n = STRAT_D_BATCH * TRAIN_S
    out = []
    for i in range(STRAT_D_STEPS):
        ids = ((np.arange(n) + 5 * i) % 31000).reshape(STRAT_D_BATCH,
                                                        TRAIN_S)
        out.append((ids.astype(np.int64), ((ids + 1) % 31000).astype(
            np.int64)))
    return out


def strategy_phase(pt, kernels, card):
    """The strategy's optimizer options at GPT-medium's full width and
    ``STRAT_LAYERS`` of its 24 blocks (a depth cut), as one world of 8
    ranks of this script (``--strat-child``), all on this card over gloo,
    started by the port's launcher with a deadline; global batch 8 x
    1024, float32 with TF32 off unless a case says bf16. Three cases in
    turn, each with the launch counts reset:

    (a) ``__graft_entry__.py``'s composition: dp2 x pp2 x mp2, ZeRO-1 and
        ``gradient_merge`` k 2 (avg) over Adam (lr 1e-4) through fleet,
        bench's GPT as a ``PipelineLayer`` (embeddings, the blocks, the
        32k head), 1F1B over 2 microbatches, two ``train_batch`` calls on
        two batches (the first off the merge boundary). Held against one
        process that computes both batches' gradients and applies one Adam
        step to their mean: both losses within ``STRAT_A_RTOL`` (1e-6; the
        pipeline at pp2 x mp2 agrees with one process within 8.8e-8), and
        every element of the rank's stage's parameters (its mp shard)
        within ``STRAT_A_RTOL`` of its parameter's largest value plus how
        far the step can move it apart: Adam's first step moves an element
        by ``lr g / (|g| + eps)``, whose change with ``g`` is ``lr eps /
        (|g| + eps)^2`` for gradients that agree within ``MC_GRAD_RTOL``
        (1e-5) of their largest (every world phase's gradient bound), and
        by at most 2 lr (the key third of each ``qkv.bias`` has a gradient
        of 0 but for rounding: softmax is unchanged by a constant added to
        a row's scores). The worst element's share of its bound is
        printed. Adam's and Lamb's steps do not change when every
        gradient is scaled by one factor, so the parameters cannot show
        a wrong gradient scale (a merge without its mean, a dp sum in
        place of the mean): the reduced gradient is held directly,
        Adam's first moment on each rank (its ZeRO shard) within
        ``MC_GRAD_RTOL`` of the largest of (1 - beta1) times one
        process's merged gradient. Adam's moment bytes on a rank are half
        the stage's unsharded bytes (every leaf has an axis 2 divides: no
        padding). Every kernel of the block on every rank: (blocks a
        stage) x 2 microbatches x 2 calls.
    (b) dp4 x mp2, ``lamb`` swapping AdamW (lr 1e-4, decay 0.01) with ZeRO
        stage 3, ``PADDLE_TP_OVERLAP=1`` and ``recompute`` on, two
        ``TrainStep`` steps, against the same world with the three off
        (Lamb, unsharded): losses within ``STRAT_B_RTOL`` (1e-5), each
        parameter element within ``STRAT_B_RTOL`` of its largest value plus
        (a)'s step bound for the off run's first-step gradient (its first
        moment over 1 - beta1), over two steps and scaled by Lamb's trust
        ratio (at most the larger of 1 and the parameter's root mean
        square); Lamb's first moment, gathered from the ZeRO shards,
        within ``STRAT_B_RTOL`` of the off run's (the gradients' scale,
        which the parameters cannot show); the parameter bytes a rank
        holds between
        steps a quarter of its mp shard's (every leaf divides by 4); the
        rings shift (``ppermute`` calls with the knob on, none off); B1,
        B5 and B6 launch twice a block a step (recompute), B3, B4 and B7
        as without it.
    (c) LocalSGD over SGD (lr 1e-2) at dp8, one row a rank: k 1 gives
        ``DataParallel`` SGD's losses and parameters within
        ``STRAT_C_RTOL`` (1e-6, of each parameter's largest) over 2 steps; with k 2 the ranks'
        parameters differ after step 1 and are equal bit for bit after
        step 2.
    (d) ``__graft_entry__.py:275-327``'s elastic composition: flat dp8,
        Adam (lr 1e-4) through ``resharding.ElasticStep(policy=
        "shrink_expand")`` over ``TrainStep``, a global batch of 24 x 1024
        a step (``shard_input``). Step 1 at dp8; ``notify_departure([6,
        7])`` on every rank and the boundary (the world is rebuilt at
        dp6: ranks 6 and 7 leave it); steps 2 and 3 at dp6;
        ``notify_return([6, 7])`` and the boundary (dp8 again: the
        returning ranks take the state from a survivor); step 4 at dp8.
        Every rank's plan reads dp8 -> dp6 -> dp8; ranks 6 and 7 launch
        no kernel and start no collective while out; the four losses
        within ``STRAT_D_RTOL`` (1e-6) of one process's uninterrupted Adam
        run on the same batches; after the return, before step 4, every
        rank's parameters and Adam moments bit-equal to rank 0's; after
        step 4 every rank's parameters equal and within ``STRAT_A_RTOL``
        of the one-process run's plus four steps' slack (after Adam's
        first step an update is a ratio of gradient sums, which gradients
        that agree within ``MC_GRAD_RTOL`` of their largest, d, move by up
        to 2 d / |g|, at the element's smallest |g| over the run), and
        Adam's first moment (linear in the gradients: their scale, which
        the step ignores) within ``MC_GRAD_RTOL`` of the run's largest,
        and its second moment within what such gradients move a sum of
        squares by, element by element (the update's denominator, and the
        state the returning ranks took); rank 0's bus two
        ``reshard`` rows, covered and without the fallback, and no
        ``io.load``; B1, B3, B4, B5 and B6 ``STRAT_LAYERS`` launches and B7
        twice that for each step a rank takes. Prints each transition's
        wall seconds and bytes sent, the step ms at dp8 and dp6, and the
        share of each leaf's elements at the parameter slack's clamp.

    The one-process references run first, in this process; weights,
    batches and results reach the ranks through ``/dev/shm``. Fails when a
    rank exits non-zero or outlives ``STRAT_DEADLINE_S``, when a collective
    ran on another backend than the rule's, or when a gate or a kernel of
    the path fails. Returns rank 0's launch counts by case."""
    import gc
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed import launch as dlaunch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="strategy_", dir=shm)

    def save(obj, name):
        torch.save(obj, os.path.join(root, name))

    try:
        # (a) one process: both batches' gradients, one Adam step on
        # their mean
        pt.seed(1)
        layer = pt.distributed.PipelineLayer(
            pp_gpt_layers(pt, STRAT_LAYERS), loss_fn=pp_loss)
        save({k: v.detach().cpu() for k, v in layer.state_dict().items()},
             "a_state.pt")
        losses = []
        dev = layer.parameters()[0].device
        for ids, labels in _strat_batches():
            ids, labels = (torch.as_tensor(a, device=dev)
                           for a in (ids, labels))
            loss = pp_loss(layer(ids), labels)
            loss.backward()
            losses.append(loss.item())
            del loss
        opt = pt.optimizer.Adam(learning_rate=STRAT_LR,
                                parameters=layer.parameters())
        with torch.no_grad():
            for p in layer.parameters():
                p.grad.div_(2)
        save({k: p.grad.detach().cpu() for k, p in
              layer.named_parameters()}, "a_grad.pt")
        opt.step()
        save({k: v.detach().cpu() for k, v in layer.state_dict().items()},
             "a_ref.pt")
        ref = {"a": losses}
        del layer, opt
        # (b), (c), (d): the GPT's weights; (d) one process: four Adam
        # steps on its global batches
        pt.seed(0)
        model = _gpt_cut(STRAT_LAYERS)
        save({k: v.detach().cpu() for k, v in model.state_dict().items()},
             "gpt_state.pt")
        adam = pt.optimizer.Adam(learning_rate=STRAT_LR,
                                 parameters=model.parameters())
        step = pt.jit.TrainStep(model, _bench_lm_loss(model), adam)
        ref["d"] = []
        # for the bound: each element's smallest |gradient| over the steps
        # (g_t = (m_t - beta1 m_t-1) / (1 - beta1)) and each parameter's
        # largest first-step |gradient|
        named = list(model.named_parameters())
        b1 = adam._beta1
        gmin, gmax, m_prev = {}, {}, {n: 0.0 for n, _ in named}
        for ids, labels in _elastic_batches():
            ref["d"].append(float(step(ids, labels)))
            m1 = adam._accumulators["moment1"]
            for n, p in named:
                g = ((m1[id(p)] - b1 * m_prev[n]) / (1 - b1)).abs()
                m_prev[n] = m1[id(p)].clone()
                gmin[n] = g if n not in gmin else torch.minimum(gmin[n], g)
                gmax[n] = torch.maximum(gmax[n], g.max()) if n in gmax \
                    else g.max()
            del m1
        m2 = adam._accumulators["moment2"]
        save({"gmin": {n: v.cpu() for n, v in gmin.items()},
              "gmax": {n: v.cpu() for n, v in gmax.items()},
              "m1": {n: m_prev[n].cpu() for n, _ in named},
              "m2": {n: m2[id(p)].cpu() for n, p in named}}, "d_grad.pt")
        del m2
        save({k: v.detach().cpu() for k, v in model.state_dict().items()},
             "d_ref.pt")
        del named, gmin, gmax, m_prev
        del model, adam, step
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with open(os.path.join(root, "ref.json"), "w") as f:
            json.dump(ref, f)
        print(f"strategy: one-process references (a), (d) in "
              f"{time.perf_counter() - t0:.1f} s: losses {ref['a']}, "
              f"{ref['d']}")
        logs = os.path.join(root, "logs")
        t1 = time.perf_counter()
        rc = dlaunch.launch(os.path.abspath(__file__),
                            ["--strat-child", root],
                            nproc_per_node=STRAT_WORLD, log_dir=logs,
                            deadline=STRAT_DEADLINE_S)
        world_s = time.perf_counter() - t1
        for r in range(STRAT_WORLD):
            with open(os.path.join(logs, f"workerlog.{r}")) as f:
                text = f.read()
            if rc != 0 or r == 0:
                print(f"--- rank {r} log ---\n{text.rstrip()}")
        if rc != 0:
            fail(f"strategy: the world of {STRAT_WORLD} ranks exited with "
                 f"code {rc}")
        res = []
        for r in range(STRAT_WORLD):
            with open(os.path.join(root, f"strat_rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"strategy: world of {STRAT_WORLD} ranks ran in {world_s:.1f} s "
          f"on {card}, 8 ranks sharing one H100 over gloo")
    L = STRAT_LAYERS
    per_stage = STRAT_STEPS * 2 * (L // 2)
    want_a = {k: {"float32": n * per_stage} for k, n in (
        ("flash_attention_fwd", 1), ("flash_attention_bwd_dq", 1),
        ("flash_attention_bwd_dkv", 1), ("layer_norm_fwd", 1),
        ("add_layer_norm_fwd", 1), ("layer_norm_bwd", 2))}
    want_off = {k: {"float32": n * L * STRAT_STEPS} for k, n in (
        ("flash_attention_fwd", 1), ("flash_attention_bwd_dq", 1),
        ("flash_attention_bwd_dkv", 1), ("layer_norm_fwd", 1),
        ("add_layer_norm_fwd", 1), ("layer_norm_bwd", 2))}
    want_on = {k: {"float32": n * L * STRAT_STEPS} for k, n in (
        ("flash_attention_fwd", 2), ("flash_attention_bwd_dq", 1),
        ("flash_attention_bwd_dkv", 1), ("layer_norm_fwd", 2),
        ("add_layer_norm_fwd", 2), ("layer_norm_bwd", 2))}
    for r, o in enumerate(res):
        bad = [c for run in ("a", "b_on", "b_off", "c_k2")
               for c in o[f"{run}_counts"]
               if c["backend"] != "gloo" or c["transport"] != "gloo-cuda"]
        if o["backend"] != "gloo" or bad:
            fail(f"strategy rank {r}: a collective left the rule's backend "
                 f"(gloo, gloo-cuda): {o['backend']}, {bad}")
        # (a)
        for i, (got, want) in enumerate(zip(o["a_losses"], ref["a"])):
            if abs(got - want) > STRAT_A_RTOL * abs(want):
                fail(f"strategy (a) rank {r} call {i + 1}: loss {got!r} "
                     f"against one process's {want!r}")
        if o["a_worst"] > 1:
            fail(f"strategy (a) rank {r}: parameter {o['a_worst_name']} at "
                 f"{o['a_worst']:.3f} of its bound")
        if o["a_m1_worst"] > 1:
            fail(f"strategy (a) rank {r}: Adam's first moment of "
                 f"{o['a_m1_worst_name']} at {o['a_m1_worst']:.3f} of its "
                 "bound against one process's merged gradient")
        if 2 * o["a_moment_bytes"] != o["a_unsharded_moment_bytes"]:
            fail(f"strategy (a) rank {r}: moment bytes "
                 f"{o['a_moment_bytes']}, unsharded "
                 f"{o['a_unsharded_moment_bytes']}")
        if o["a_launches"] != want_a:
            fail(f"strategy (a) rank {r}: launches {o['a_launches']}, "
                 f"expected {want_a}")
        # (b)
        for i, (got, want) in enumerate(zip(o["b_on_losses"],
                                            o["b_off_losses"])):
            if abs(got - want) > STRAT_B_RTOL * abs(want):
                fail(f"strategy (b) rank {r} step {i + 1}: loss {got!r} "
                     f"with the options on, {want!r} off")
        if o["b_worst"] > 1:
            fail(f"strategy (b) rank {r}: parameter {o['b_worst_name']} at "
                 f"{o['b_worst']:.3f} of its bound")
        if o["b_m1_worst"] > 1:
            fail(f"strategy (b) rank {r}: Lamb's first moment of "
                 f"{o['b_m1_worst_name']} at {o['b_m1_worst']:.3f} of its "
                 "bound against the run with the options off")
        if 4 * o["b_on_param_bytes"] != o["b_off_param_bytes"]:
            fail(f"strategy (b) rank {r}: parameter bytes held between "
                 f"steps {o['b_on_param_bytes']} with ZeRO-3, "
                 f"{o['b_off_param_bytes']} without")
        if not o["b_on_shifts"] or o["b_off_shifts"]:
            fail(f"strategy (b) rank {r}: ring shifts on {o['b_on_shifts']}"
                 f", off {o['b_off_shifts']}")
        for run, want in (("b_on", want_on), ("b_off", want_off)):
            if o[f"{run}_launches"] != want:
                fail(f"strategy ({run}) rank {r}: launches "
                     f"{o[f'{run}_launches']}, expected {want}")
        # (c)
        for i, (got, want) in enumerate(zip(o["c_k1_losses"],
                                            o["c_dp_losses"])):
            if abs(got - want) > STRAT_C_RTOL * abs(want):
                fail(f"strategy (c) rank {r} step {i + 1}: LocalSGD k 1 "
                     f"loss {got!r}, DataParallel {want!r}")
        if o["c_k1_worst"] > 1:
            fail(f"strategy (c) rank {r}: LocalSGD k 1 parameter "
                 f"{o['c_k1_worst_name']} at {o['c_k1_worst']:.3f} of its "
                 "bound")
        if o["c_k2_launches"] != want_off:
            fail(f"strategy (c) rank {r}: launches {o['c_k2_launches']}, "
                 f"expected {want_off}")
        # (d)
        taken = 2 if r in STRAT_D_OUT else STRAT_D_STEPS
        for i, (got, want) in enumerate(zip(o["d_losses"], ref["d"])):
            if got is None and r in STRAT_D_OUT and i in (1, 2):
                continue
            if got is None or abs(got - want) > STRAT_D_RTOL * abs(want):
                fail(f"strategy (d) rank {r} step {i + 1}: loss {got!r} "
                     f"against one process's {want!r}")
        if o["d_dp"] != [8, 6, 6, 8] or [
                (w["old"], w["new"], w["lost"]) for w in o["d_rows"]] != [
                ("dp8", "dp6", list(STRAT_D_OUT)), ("dp6", "dp8", [])]:
            fail(f"strategy (d) rank {r}: dp by step {o['d_dp']}, plans "
                 f"{[(w['old'], w['new'], w['lost']) for w in o['d_rows']]}"
                 ", expected dp8 -> dp6 -> dp8")
        if (r in STRAT_D_OUT) != (o["d_out_launches"] == {}
                                  and o["d_out_records"] == 0):
            fail(f"strategy (d) rank {r}: while ranks {STRAT_D_OUT} were "
                 f"out it launched {o['d_out_launches']} and started "
                 f"{o['d_out_records']} collectives")
        want_d = {k: {"float32": n * L * taken} for k, n in (
            ("flash_attention_fwd", 1), ("flash_attention_bwd_dq", 1),
            ("flash_attention_bwd_dkv", 1), ("layer_norm_fwd", 1),
            ("add_layer_norm_fwd", 1), ("layer_norm_bwd", 2))}
        if o["d_launches"] != want_d:
            fail(f"strategy (d) rank {r}: launches {o['d_launches']}, "
                 f"expected {want_d} ({taken} steps)")
        if o["d_worst"] > 1:
            fail(f"strategy (d) rank {r}: parameter {o['d_worst_name']} at "
                 f"{o['d_worst']:.3f} of its bound against one process")
        if o["d_m1_worst"] > 1:
            fail(f"strategy (d) rank {r}: Adam's first moment of "
                 f"{o['d_m1_worst_name']} at {o['d_m1_worst']:.3f} of its "
                 "bound against one process")
        if o["d_m2_worst"] > 1:
            fail(f"strategy (d) rank {r}: Adam's second moment of "
                 f"{o['d_m2_worst_name']} at {o['d_m2_worst']:.3f} of its "
                 "bound against one process")
        if o["d_io_loads"]:
            fail(f"strategy (d) rank {r}: {o['d_io_loads']} checkpoint "
                 "reads on the covered path")
    for key in ("d_return_hash", "d_final_hash"):
        if any(o[key] != res[0][key] for o in res):
            fail(f"strategy (d): {key} differs across ranks (the returning "
                 f"ranks' state is not rank 0's): "
                 f"{[o[key] for o in res]}")
    bus_rows = res[0]["d_bus_rows"]
    if len(bus_rows) != 2 or not all(
            w["covered"] and not w["fallback"] for w in bus_rows):
        fail(f"strategy (d): rank 0's bus has reshard rows {bus_rows}, "
             "expected two, covered, without the fallback")
    for key in ("a_losses", "b_on_losses", "b_off_losses", "c_k1_losses",
                "c_dp_losses", "c_k2_losses"):
        if any(o[key] != res[0][key] for o in res):
            fail(f"strategy: {key} differ across ranks: "
                 f"{[o[key] for o in res]}")
    for i in range(STRAT_STEPS):
        hashes = {o["c_k2_hashes"][i] for o in res}
        if (len(hashes) == 1) != (i % 2 == 1):
            fail(f"strategy (c) LocalSGD k 2: after step {i + 1} the ranks' "
                 f"parameters take {len(hashes)} distinct values")
    r0 = res[0]
    print(f"strategy (a) dp2 x pp2 x mp2 ZeRO-1 + gm k2: losses "
          f"{r0['a_losses']} (one process {ref['a']}); worst parameter at "
          f"{max(o['a_worst'] for o in res):.3f} of its bound "
          f"({r0['a_worst_name']}); first moment at "
          f"{max(o['a_m1_worst'] for o in res):.3f} of its bound "
          f"({r0['a_m1_worst_name']}); "
          f"moment bytes by rank {[o['a_moment_bytes'] for o in res]} of "
          f"{[o['a_unsharded_moment_bytes'] for o in res]} unsharded; call "
          f"ms {[round(x, 1) for x in r0['a_ms']]}; peak by rank (stage) "
          f"{[(round(o['a_peak_gib'], 2), o['a_stage']) for o in res]} GiB")
    print(f"strategy (b) dp4 x mp2 Lamb, ZeRO-3 + rings + recompute: losses "
          f"{r0['b_on_losses']} (off {r0['b_off_losses']}); worst parameter "
          f"at {max(o['b_worst'] for o in res):.3f} of its bound "
          f"({r0['b_worst_name']}); first moment at "
          f"{max(o['b_m1_worst'] for o in res):.3f} of its bound "
          f"({r0['b_m1_worst_name']}); "
          f"parameter bytes a rank {r0['b_on_param_bytes']} (off "
          f"{r0['b_off_param_bytes']}); step ms on "
          f"{[round(x, 1) for x in r0['b_on_ms']]}, off "
          f"{[round(x, 1) for x in r0['b_off_ms']]}; peak by rank on "
          f"{[round(o['b_on_peak_gib'], 2) for o in res]}, off "
          f"{[round(o['b_off_peak_gib'], 2) for o in res]} GiB; launches "
          f"on {r0['b_on_launches']}")
    print(f"strategy (c) LocalSGD dp8: k 1 losses {r0['c_k1_losses']} "
          f"(DataParallel {r0['c_dp_losses']}), worst parameter at "
          f"{max(o['c_k1_worst'] for o in res):.3f} of its bound; k 2 "
          f"losses "
          f"{r0['c_k2_losses']}, distinct parameters across ranks by step "
          f"{[len({o['c_k2_hashes'][i] for o in res}) for i in range(STRAT_STEPS)]}; "
          f"step ms k 2 {[round(x, 1) for x in r0['c_k2_ms']]}, "
          f"DataParallel {[round(x, 1) for x in r0['c_dp_ms']]}")
    dms = r0["d_ms"]
    print(f"strategy (d) dp8 -> dp6 -> dp8 Adam, ElasticStep: losses "
          f"{r0['d_losses']} (one process {ref['d']}), ranks "
          f"{list(STRAT_D_OUT)}' {[res[i]['d_losses'] for i in STRAT_D_OUT]}"
          f"; worst parameter at {max(o['d_worst'] for o in res):.3f} of its "
          f"bound ({r0['d_worst_name']}), first moment at "
          f"{max(o['d_m1_worst'] for o in res):.3f} "
          f"({r0['d_m1_worst_name']}), second moment at "
          f"{max(o['d_m2_worst'] for o in res):.3f} "
          f"({r0['d_m2_worst_name']}); share of elements at the parameter "
          f"slack's clamp by leaf (rank 0) "
          f"{ {n: round(v, 4) for n, v in r0['d_clamp_share'].items()} }"
          f"; transitions (rank 0) "
          + "; ".join(f"{w['old']} -> {w['new']} {w['wall_s']:.3f} s, "
                      f"{w['bytes_moved']} bytes sent" for w in r0["d_rows"])
          + f"; slowest rank's transitions "
          f"{[max(o['d_rows'][i]['wall_s'] for o in res) for i in (0, 1)]} s"
          f"; step ms at dp8 {[round(dms[i], 1) for i in (0, 3)]}, at dp6 "
          f"{[round(dms[i], 1) for i in (1, 2)]}; peak by rank "
          f"{[round(o['d_peak_gib'], 2) for o in res]} GiB")
    for run in ("a", "b_on", "b_off", "c_k2", "c_dp", "d"):
        for c in r0[f"{run}_counts"]:
            print(f"strategy ({run}) rank 0 collectives: {c['op']} group "
                  f"{c['group']} {c['backend']}/{c['transport']}: "
                  f"{c['calls']} calls, {c['bytes']} bytes, "
                  f"{c['ms']:.1f} host ms")
    return {"strategy_a_pp_zero1_gm2": {k: sum(v.values()) for k, v in
                                        r0["a_launches"].items()},
            "strategy_b_zero3_rings_recompute": {
                k: sum(v.values()) for k, v in r0["b_on_launches"].items()},
            "strategy_c_localsgd": {k: sum(v.values()) for k, v in
                                    r0["c_k2_launches"].items()},
            "strategy_d_elastic_reshard": {
                k: sum(v.values()) for k, v in r0["d_launches"].items()}}


def strat_child(argv) -> int:
    """``python3 chip_smoke.py --strat-child DIR``: one rank of
    ``strategy_phase``'s world, started by the port's launcher. Writes its
    results to ``DIR/strat_rank<r>.json``."""
    import gc
    import hashlib

    root, = argv
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import comm, fleet
    from paddle_tpu_torch.distributed.parallel import DataParallel, \
        shard_batch
    from paddle_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    rank = dist.get_rank()
    dev = comm.rank_device()
    mon = dist.comm_monitor.monitor()
    out = {"rank": rank, "backend": comm.backend()}
    t_start = time.perf_counter()

    def done(what):
        print(f"rank {rank}: {what} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def world(degrees=None, **options):
        comm._mesh = None
        s = fleet.DistributedStrategy()
        if degrees:
            s.hybrid_configs = {f"{k}_degree": v
                                for k, v in degrees.items()}
        for k, v in options.items():
            setattr(s, k, v)
        fleet.init(is_collective=True, strategy=s)
        return s

    def load(name):
        return torch.load(os.path.join(root, name), mmap=True)

    def start():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mon.reset_counts()
        kernels.reset_launches()

    def timed(fn, n):
        ms, vals = [], []
        for i in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            vals.append(fn(i))
            ms.append((time.perf_counter() - t) * 1e3)
        return vals, ms

    def finish(tag, losses, ms):
        out.update({f"{tag}_losses": losses, f"{tag}_ms": ms,
                    f"{tag}_launches": kernels.launches_by_dtype(),
                    f"{tag}_shapes": kernels.launch_shapes(),
                    f"{tag}_counts": mon.comm_counts(by_group=True),
                    f"{tag}_peak_gib":
                        torch.cuda.max_memory_allocated() / 2 ** 30})

    def nbytes(ts):
        return int(sum(t.numel() * t.element_size() for t in ts))

    def worst(pairs, rtol):
        """The largest |got - want| / (rtol max|want| + slack) over
        ``(name, got, want, slack)`` (slack: a tensor of the elements'
        shape, or 0), and its name: at most 1 where every element is
        within its bound."""
        w, wn = 0.0, ""
        for name, got, want, slack in pairs:
            want = want.float()
            err = (got.float() - want).abs()
            lim = (rtol * want.abs().max() + slack).clamp_min(
                torch.finfo(torch.float32).tiny)
            ratio = (err / lim).max().item()
            if ratio > w:
                w, wn = ratio, name
        return w, wn

    def step_slack(g, eps, scale):
        """How far ``scale`` steps of an Adam-family rule at the rate can
        move an element apart in two runs whose gradients ``g`` agree
        within ``MC_GRAD_RTOL`` of their largest: the first step moves it
        by lr g / (|g| + eps), whose change with g is eps / (|g| + eps)^2,
        and by at most 2 lr (the sign)."""
        a = g.abs().float()
        d = MC_GRAD_RTOL * a.max()
        return scale * torch.clamp(eps * d / (a + eps) ** 2, max=2.0)

    batches = _strat_batches()

    # (a) dp2 x pp2 x mp2, ZeRO-1, gradient merge k 2
    world(dict(dp=2, pp=2, mp=2), pipeline=True,
          pipeline_configs={"accumulate_steps": 2, "schedule_mode": "1F1B"},
          sharding=True, sharding_configs={"stage": 1},
          gradient_merge=True,
          gradient_merge_configs={"k_steps": 2, "avg": True})
    pt.seed(1)
    layer = pt.distributed.PipelineLayer(pp_gpt_layers(pt, STRAT_LAYERS),
                                         loss_fn=pp_loss)
    start_state = load("a_state.pt")
    layer.set_state_dict(start_state)
    model = fleet.distributed_model(layer)
    opt = fleet.distributed_optimizer(pt.optimizer.Adam(
        learning_rate=STRAT_LR, parameters=model.parameters()))
    start()
    losses, ms = timed(lambda i: model.train_batch(list(batches[i]),
                                                   opt).item(), STRAT_STEPS)
    finish("a", losses, ms)
    own = {id(p) for p in model.stage.params}
    want, grad = load("a_ref.pt"), load("a_grad.pt")
    pairs = []
    for name, p in layer.named_parameters():
        if id(p) not in own:
            continue
        shard = getattr(p, "_tp_shard", None)
        pick = (lambda t: shard.take(t.to(dev))) if shard is not None \
            else (lambda t: t.to(dev))
        pairs.append((name, p.detach(), pick(want[name]),
                      step_slack(pick(grad[name]), opt._inner._epsilon,
                                 STRAT_LR)))
    out["a_worst"], out["a_worst_name"] = worst(pairs, STRAT_A_RTOL)
    inner = opt._inner
    # the reduced, merged gradient itself: Adam's first moment after the
    # boundary, this rank's ZeRO shard of its mp shard
    b1, m1, mpairs = inner._beta1, inner._accumulators["moment1"], []
    for name, p in layer.named_parameters():
        if id(p) not in own:
            continue
        shard = getattr(p, "_tp_shard", None)
        g = grad[name].to(dev)
        g = shard.take(g) if shard is not None else g
        zs = getattr(p, "_zero_shard", None)
        g = zs.take(g) if zs is not None else g
        mpairs.append((name, m1[id(p)], (1 - b1) * g, 0.0))
    out["a_m1_worst"], out["a_m1_worst_name"] = worst(mpairs, MC_GRAD_RTOL)
    out["a_moment_bytes"] = nbytes(
        v for acc in ("moment1", "moment2")
        for pid, v in inner._accumulators[acc].items() if pid in own)
    out["a_unsharded_moment_bytes"] = 2 * nbytes(model.stage.params)
    out["a_stage"] = model.stage_id
    del model, layer, opt, inner, pairs, mpairs, m1, want, grad, start_state
    done("(a) dp2 x pp2 x mp2 ZeRO-1 + gm k2")

    # (b) dp4 x mp2: Lamb with ZeRO-3, the rings and recompute, and off
    gpt_state = load("gpt_state.pt")
    kept, kept_m1, grad = {}, {}, {}
    for tag, on in (("b_off", False), ("b_on", True)):
        world(dict(dp=4, mp=2), lamb=True, recompute=on, sharding=on,
              sharding_configs={"stage": 3})
        os.environ["PADDLE_TP_OVERLAP"] = "1" if on else "0"
        pt.seed(0)
        model = _gpt_cut(STRAT_LAYERS)
        model.set_state_dict(gpt_state)
        lm_loss = _bench_lm_loss(model)
        fl = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=STRAT_LR, weight_decay=0.01,
            parameters=model.parameters()))
        step = pt.jit.TrainStep(fl, lm_loss, opt)
        ids, labels = (fl.shard_input(a) for a in batches[0])
        inner = opt._inner

        def one(i):
            loss = step(ids, labels).item()
            if not on and i == 0:  # the first step's gradients, for the
                m1 = inner._accumulators["moment1"]  # bound: m1 / (1 - b1)
                grad.update({n: m1[id(p)] / (1 - inner._beta1)
                             for n, p in model.named_parameters()})
            return loss

        start()
        losses, ms = timed(one, STRAT_STEPS)
        finish(tag, losses, ms)
        out[f"{tag}_shifts"] = sum(c["calls"] for c in out[f"{tag}_counts"]
                                   if c["op"] == "ppermute")
        out[f"{tag}_param_bytes"] = nbytes(model.parameters())
        out[f"{tag}_inner"] = type(opt._inner).__name__
        m1 = inner._accumulators["moment1"]
        if not on:
            kept = {n: p.detach().clone()
                    for n, p in model.named_parameters()}
            kept_m1 = {n: m1[id(p)].clone()
                       for n, p in model.named_parameters()}
        else:
            pairs, mpairs = [], []
            eps = inner._epsilon
            for name, p in model.named_parameters():
                zs = getattr(p, "_zero_shard", None)
                full = (lambda t: zs.gather(t)) if zs is not None and \
                    tuple(p.shape) == zs.shard_shape else \
                    (lambda t: t.detach())
                shard = getattr(p, "_tp_shard", None)
                s0 = gpt_state[name].to(dev)
                s0 = shard.take(s0) if shard is not None else s0
                trust = max(1.0, s0.float().pow(2).mean().sqrt().item())
                pairs.append((name, full(p), kept[name], step_slack(
                    grad[name], eps, STRAT_STEPS * STRAT_LR * trust)))
                mpairs.append((name, full(m1[id(p)]), kept_m1[name], 0.0))
            out["b_worst"], out["b_worst_name"] = worst(pairs,
                                                        STRAT_B_RTOL)
            out["b_m1_worst"], out["b_m1_worst_name"] = worst(
                mpairs, STRAT_B_RTOL)
            del pairs, mpairs
        del model, fl, opt, step, lm_loss, inner, m1
    os.environ.pop("PADDLE_TP_OVERLAP")
    kept, kept_m1, grad = None, None, None
    done("(b) dp4 x mp2 Lamb + ZeRO-3 + rings + recompute")

    # (c) LocalSGD at dp8 against DataParallel
    def bits_hash(tensors):
        """A fingerprint of float32 tensors' bits, taken on the device:
        per tensor the sum of its int32 words and of each word times its
        index (int64, wrapping)."""
        h = hashlib.sha1()
        for t in tensors:
            b = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
            i = torch.arange(b.numel(), device=b.device)
            h.update(f"{int(b.sum())}:{int((b * i).sum())}|".encode())
        return h.hexdigest()

    def params_hash(model):
        return bits_hash(model.parameters())

    kept = None
    for tag in ("c_dp", "c_k1", "c_k2"):
        if tag == "c_dp":
            world()
        else:
            world(localsgd=True, localsgd_configs={"k_steps": int(tag[-1])})
        pt.seed(0)
        model = _gpt_cut(STRAT_LAYERS)
        model.set_state_dict(gpt_state)
        lm_loss = _bench_lm_loss(model)
        sgd = pt.optimizer.SGD(learning_rate=STRAT_SGD_LR,
                               parameters=model.parameters())
        if tag == "c_dp":
            step = pt.jit.TrainStep(DataParallel(model), lm_loss, sgd)
        else:
            step = pt.jit.TrainStep(model, lm_loss,
                                    fleet.distributed_optimizer(sgd))
        ids, labels = (shard_batch(a) for a in batches[0])
        hashes = []

        def one(i):
            loss = step(ids, labels).item()
            hashes.append(params_hash(model))
            return loss

        start()
        losses, ms = timed(one, STRAT_STEPS)
        finish(tag, losses, ms)
        out[f"{tag}_hashes"] = hashes
        if tag == "c_dp":
            kept = {n: p.detach().clone() for n, p in
                    model.named_parameters()}
        elif tag == "c_k1":
            w, wn = worst([(n, p.detach(), kept[n], 0.0)
                           for n, p in model.named_parameters()],
                          STRAT_C_RTOL)
            out.update(c_k1_worst=w, c_k1_worst_name=wn)
            kept = None
        del model, step, lm_loss, sgd
    done("(c) LocalSGD dp8")

    # (d) the elastic reshard: flat dp8 -> dp6 -> dp8 through ElasticStep
    from paddle_tpu_torch.distributed import resharding
    from paddle_tpu_torch.observability import bus
    from paddle_tpu_torch.utils import fault_injection

    world()
    pt.seed(0)
    model = _gpt_cut(STRAT_LAYERS)
    model.set_state_dict(gpt_state)
    adam = pt.optimizer.Adam(learning_rate=STRAT_LR,
                             parameters=model.parameters())
    estep = resharding.ElasticStep(
        pt.jit.TrainStep(model, _bench_lm_loss(model), adam),
        policy="shrink_expand")
    d_batches = _elastic_batches()
    loads0 = fault_injection._injector()._counts.get("io.load", 0)
    d_losses, d_ms, d_dp = [], [], []

    def d_step(i):
        ids, labels = d_batches[i]
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = estep(estep.shard_input(ids), estep.shard_input(labels))
        d_losses.append(None if loss is None else float(loss))
        torch.cuda.synchronize()
        d_ms.append((time.perf_counter() - t) * 1e3)
        d_dp.append(estep.dp_size())

    def state_hash():
        accs = adam._accumulators
        return bits_hash(t for p in model.parameters() for t in (
            [p] + [accs[a][id(p)] for a in ("moment1", "moment2")]))

    start()
    d_step(0)
    estep.notify_departure(list(STRAT_D_OUT))
    estep._poll_notices()   # the boundary: the world shrinks to dp6
    seen = (kernels.launches_by_dtype(), mon._n_records)
    d_step(1)
    d_step(2)
    launched = kernels.launches_by_dtype()
    out["d_out_launches"] = {
        k: {t: n - seen[0].get(k, {}).get(t, 0) for t, n in v.items()
            if n != seen[0].get(k, {}).get(t, 0)}
        for k, v in launched.items()
        if v != seen[0].get(k, {})}
    out["d_out_records"] = mon._n_records - seen[1]
    estep.notify_return(list(STRAT_D_OUT))
    estep._poll_notices()   # the boundary: dp8 again, the state sent
    out["d_return_hash"] = state_hash()
    d_step(3)
    finish("d", d_losses, d_ms)
    out["d_dp"], out["d_rows"] = d_dp, estep.rows
    out["d_final_hash"] = params_hash(model)
    want, grad = load("d_ref.pt"), load("d_grad.pt")

    def d_sense(n):
        """2 d / (|g| + eps): how far gradients that agree within
        ``MC_GRAD_RTOL`` of their largest (d) can move Adam's update after
        its first step (sign-like: (a)'s eps / (|g| + eps)^2), a ratio of
        gradient sums, m / sqrt(v); |g| the element's smallest over the
        one-process run's steps."""
        a, eps = grad["gmin"][n].to(dev).float(), adam._epsilon
        d = MC_GRAD_RTOL * grad["gmax"][n].to(dev).float()
        return 2 * d / (a + eps)

    def d_slack(n):
        """How far four Adam steps can move an element apart in two such
        runs: each step by d_sense in units of lr, and by at most 2 lr
        (the clamp: such elements are held by the moments' gates)."""
        return STRAT_D_STEPS * STRAT_LR * torch.clamp(d_sense(n), max=2.0)

    out["d_worst"], out["d_worst_name"] = worst(
        [(n, p.detach(), want[n].to(dev), d_slack(n))
         for n, p in model.named_parameters()], STRAT_A_RTOL)
    # the share of each leaf's elements whose slack is at the clamp
    out["d_clamp_share"] = {
        n: float((d_sense(n) >= 2.0).float().mean())
        for n, _ in model.named_parameters()}
    # the gradients' scale, which Adam's step ignores: the first moment,
    # linear in the gradients, against the one-process run's
    m1 = adam._accumulators["moment1"]
    out["d_m1_worst"], out["d_m1_worst_name"] = worst(
        [(n, m1[id(p)], grad["m1"][n].to(dev), 0.0)
         for n, p in model.named_parameters()], MC_GRAD_RTOL)
    # Adam's second moment, a sum of squares, element by element: where
    # the gradients agree within d, (1 - b2) sum_t (2 |g_t| d + d^2), and
    # sum_t |g_t| <= sqrt(T v / ((1 - b2) b2^(T - 1))) (v: one process's)
    m2, b2, T = adam._accumulators["moment2"], adam._beta2, STRAT_D_STEPS

    def v_slack(n):
        d = MC_GRAD_RTOL * grad["gmax"][n].to(dev).float()
        v = grad["m2"][n].to(dev).float()
        s = torch.sqrt(T * v / ((1 - b2) * b2 ** (T - 1)))
        return (1 - b2) * (2 * d * s + T * d * d)

    out["d_m2_worst"], out["d_m2_worst_name"] = worst(
        [(n, m2[id(p)], grad["m2"][n].to(dev), v_slack(n))
         for n, p in model.named_parameters()], 0.0)
    del m1, m2
    out["d_io_loads"] = fault_injection._injector()._counts.get(
        "io.load", 0) - loads0
    path = bus.bus_path()
    out["d_bus_rows"] = [r["payload"] for r in bus.read_stream(path)
                         if r["kind"] == "reshard"] if path else []
    del model, adam, estep, want, grad
    done("(d) elastic reshard dp8 -> dp6 -> dp8")
    print(f"rank {rank}: {json.dumps(out)}", flush=True)
    with open(os.path.join(root, f"strat_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    comm.destroy_parallel_env()
    return 0


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
    b5_registers = ln_fwd_registers(_build)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    flash = flash_phase(fa, gen, rows)
    ln_entry, add_entry = ln_phase(ln, gen, rows)
    ln_entry["registers"] = b5_registers
    dq_entry, dkv_entry = flash_bwd_phase(fa, gen, rows)
    ln_bwd_entry = ln_bwd_phase(ln, gen, rows)
    partial_entry = partial_phase(fa, gen, rows)
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
    dygraph = dygraph_phase(pt, kernels, card)
    print(f"dygraph phase done at {time.perf_counter() - t_start:.1f} s")
    translation = translation_phase(pt, kernels, card)
    print(f"translation phase done at {time.perf_counter() - t_start:.1f} s")
    rnn_lm = rnn_lm_phase(pt, kernels, card)
    print(f"PTB LSTM LM phase done at {time.perf_counter() - t_start:.1f} s")
    blockwise = blockwise_bert_phase(pt, kernels, card)
    print(f"BERT blockwise phase done at {time.perf_counter() - t_start:.1f} "
          "s")
    mnist_fit = mnist_fit_phase(pt, kernels, card)
    print(f"LeNet MNIST Model.fit phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    model_fit = model_fit_phase(pt, kernels, card)
    print(f"ResNet-50 Model.fit phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    reference_scripts_phase(card)
    print(f"reference scripts phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    static_bert_counts = static_bert_phase(pt, kernels, card)
    print(f"static BERT phase done at {time.perf_counter() - t_start:.1f} s")
    to_static = to_static_phase(pt, kernels, card)
    print(f"to_static phase done at {time.perf_counter() - t_start:.1f} s")
    saved = jit_save_phase(pt, kernels, card)
    print(f"jit.save phase done at {time.perf_counter() - t_start:.1f} s")
    guarded = guarded_training_phase(pt, kernels, card)
    print(f"guarded training phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    detection = detection_phase(pt, kernels, card)
    print(f"detection phase done at {time.perf_counter() - t_start:.1f} s")
    multichip = multichip_gpt_phase(pt, kernels, card)
    print(f"multichip GPT phase done at {time.perf_counter() - t_start:.1f} "
          "s")
    sp_pp_ep = sp_pp_ep_phase(pt, kernels, card)
    print(f"sp/pp/ep phase done at {time.perf_counter() - t_start:.1f} s")
    q8m = q8m_phase(pt, kernels, card)
    print(f"q8m phase done at {time.perf_counter() - t_start:.1f} s")
    dp_q8 = dp_q8_phase(pt, kernels, card)
    print(f"dp_q8 phase done at {time.perf_counter() - t_start:.1f} s")
    strategy = strategy_phase(pt, kernels, card)
    print(f"strategy phase done at {time.perf_counter() - t_start:.1f} s")
    partial_entry["launches"] = sp_pp_ep.pop("partial_op")
    partial_entry["launches_by_path"] = {"sp4_ring_pallas":
                                         partial_entry["launches"]}
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
            **{k: sum(v[e["name"]].values()) for k, v in programs.items()},
            "dygraph": dygraph[e["name"]],
            **{k: v[e["name"]] for k, v in translation.items()},
            "ptb_lstm_lm": rnn_lm[e["name"]],
            **{k: sum(v[e["name"]].values())
               for k, v in blockwise.items()},
            "lenet_mnist_model_fit": mnist_fit[e["name"]],
            "resnet50_model_fit": model_fit[e["name"]],
            "static_bert_per_run": static_bert_counts[e["name"]],
            **{k: v[e["name"]] for k, v in to_static.items()},
            **{f"jit_save_{k}": v[e["name"]] for k, v in saved.items()},
            "guarded_training": sum(guarded[e["name"]].values()),
            "detection": detection[e["name"]],
            **{k: v[e["name"]] for k, v in multichip.items()},
            **{k: v[e["name"]] for k, v in sp_pp_ep.items()},
            **{k: v[e["name"]] for k, v in q8m.items()},
            **{k: v[e["name"]] for k, v in dp_q8.items()},
            **{k: v[e["name"]] for k, v in strategy.items()}}
    entries.append(partial_entry)
    print(f"{card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--acp-child"]:
        sys.exit(acp_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--rank-child"]:
        sys.exit(rank_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--sp-child"]:
        sys.exit(sp_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--dpq8-child"]:
        sys.exit(dpq8_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--strat-child"]:
        sys.exit(strat_child(sys.argv[2:]))
    sys.exit(main())
