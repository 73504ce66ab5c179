"""Where the time of the port's training step goes, on one card.

    python3 tools/profile_torch_train.py [--layers 24] [--steps 3] [--amp]

Builds chip_smoke.py's GPT-medium ``TransformerLM`` (vocab 32000, d_model
1024, 16 heads, ffn 4096, float32, random weights) and trains it in
float32 with ``cross_entropy``; with ``--amp``, bench.py's program as
published instead (its ``_gpt_medium`` and loss as chip_smoke.py copies
them: no final LayerNorm, bf16 AMP O1 through ``fleet``,
``fused_linear_cross_entropy`` with chunk 8192).
Takes two warm-up ``jit.TrainStep`` calls (AdamW lr 1e-4, weight decay
0.01, B = 4, S = 1024, one fixed batch, TF32 off), then ``--steps`` more
with the profiler off and ``--steps`` under ``torch.profiler``. Prints the
host wall time per step (ending in a synchronize), the device time summed
over the CUDA kernels the profiler saw, the device's idle share, and the
kernels that took the most device time, with the port's own kernels
named. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from profile_torch_serving import _device_us, _report  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--amp", action="store_true",
                    help="bench.py's program: bf16 AMP O1, fused CE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 1
    import paddle_tpu_torch as pt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    V, B, S = 32000, 4, 1024
    ids = torch.as_tensor(np.random.RandomState(1).randint(
        0, V, size=(B, S + 1)), device="cuda")
    opt = pt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01)
    if args.amp:
        from chip_smoke import _bench_lm_loss, _gpt_medium
        from paddle_tpu_torch.distributed import fleet

        pt.seed(2)
        model = _gpt_medium()
        if args.layers != 24:
            model = type(model)(layers=args.layers)
        strategy = fleet.DistributedStrategy()
        strategy.amp = True
        fleet.init(is_collective=True, strategy=strategy)
        opt = fleet.distributed_optimizer(opt)
        loss_fn = _bench_lm_loss(model)
    else:
        model = pt.TransformerLM(V, 1024, 16, args.layers, max_position=S,
                                 dim_feedforward=4096, seed=1)

        def loss_fn(logits, lab):
            return pt.nn.functional.cross_entropy(logits.reshape(-1, V),
                                                  lab.reshape(-1))

    step = pt.jit.TrainStep(model, loss_fn, opt)
    what = "bf16 AMP O1, fused CE" if args.amp else "float32"
    for _ in range(2):  # warm up: kernel builds, allocator, cuBLAS
        step(ids[:, :-1], ids[:, 1:])
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(ids[:, :-1], ids[:, 1:])
    torch.cuda.synchronize()
    off = (time.perf_counter() - t0) * 1e3 / args.steps
    print(f"TrainStep {what} B={B} S={S} layers={args.layers}, profiler "
          f"off: host {off:.3f} ms per step, {B * S / off * 1e3:.1f} "
          "tokens/s")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(ids[:, :-1], ids[:, 1:])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _report(f"TrainStep {what} B={B} S={S} layers={args.layers}", wall,
            "step", prof, args.steps)
    dev = _device_us(prof)
    # B7 is the row kernel and the reduction of its partials
    ours = {"B1/B2": ("flash_fwd_kernel",), "B3": ("flash_dq_kernel",),
            "B4": ("flash_dkv_kernel",), "B5": ("ln_fwd_kernel",),
            "B6": ("add_ln_fwd_kernel",),
            "B7": ("ln_bwd_kernel", "ln_bwd_reduce_kernel")}
    for tag, keys in ours.items():
        us = sum(v for k, v in dev.items() if any(key in k for key in keys)
                 and not (keys == ("ln_fwd_kernel",) and "add_ln" in k))
        print(f"  {tag} {' + '.join(keys)}: {us / 1e3 / args.steps:.4f} ms "
              "per step")
    # every kernel the profiler saw, in classes that sum to device busy
    classes = {"port kernels (B1-B7)": 0.0, "float32 GEMMs": 0.0,
               "other GEMMs (bf16)": 0.0, "copies": 0.0,
               "elementwise and reductions": 0.0}
    for k, us in dev.items():
        if any(key in k for keys in ours.values() for key in keys):
            c = "port kernels (B1-B7)"
        elif "f32f32" in k or "sgemm" in k:
            c = "float32 GEMMs"
        elif "gemm" in k or "nvjet" in k:
            c = "other GEMMs (bf16)"
        elif k.startswith("Memcpy") or k.startswith("Memset"):
            c = "copies"
        else:
            c = "elementwise and reductions"
        classes[c] += us
    for c, us in classes.items():
        print(f"  {c}: {us / 1e3 / args.steps:.4f} ms per step")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
