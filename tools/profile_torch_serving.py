"""Where the time of the port's serving path goes, on one card.

    python3 tools/profile_torch_serving.py [--layers 24] [--steps 8]
                                           [--block-size 16]
                                           [--weights int8|fp8]
                                           [--kv int8|fp8]

Builds chip_smoke.py's GPT-medium-shaped ``TransformerLM`` (float32,
random weights; with ``--weights`` its linear weights narrowed in place
by ``quantize_layer``, as an int8/fp8 checkpoint loads them), prefills 8
prompts of 128 tokens through ``PrefillStep``, then runs ``--steps``
``DecodeStep`` calls under ``torch.profiler``, over a contiguous KV cache
or, with ``--block-size``, a paged one (identity tables, as ``generate``
builds it), full width or, with ``--kv``, int8/fp8. Prints, for the
prefill and for one decode step: the host wall time (ending in a
synchronize), the device time summed over the CUDA kernels the profiler
saw, the device's idle share, and the kernels that took the most device
time. Needs a CUDA device.
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


def _device_us(prof):
    """Device time (us) of every kernel and copy the profiler saw on the
    card, by name (operator rows, which repeat their kernels' time, are
    left out)."""
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out[e.name] = out.get(e.name, 0.0) + float(e.device_time_total)
    return out


def _report(what, wall_ms, per, prof, n):
    dev = _device_us(prof)
    total = sum(dev.values()) / 1e3 / n
    if total <= 0:
        print(f"{what}: host {wall_ms / n:.3f} ms; device time not measured "
              "(the profiler saw no CUDA kernels)")
        return
    print(f"{what}: host {wall_ms / n:.3f} ms, device busy {total:.3f} ms, "
          f"idle share {1 - total / (wall_ms / n):.3f} (per {per})")
    for name, us in sorted(dev.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3 / n:9.4f} ms  {name[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=0,
                    help="KV block size; 0 keeps the contiguous cache")
    ap.add_argument("--weights", choices=("int8", "fp8"), default=None,
                    help="narrow the linear weights (default: float32)")
    ap.add_argument("--kv", choices=("int8", "fp8"), default=None,
                    help="a quantized KV cache (default: float32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA device", file=sys.stderr)
        return 1
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import quantized_compute
    from paddle_tpu_torch.jit import DecodeState, DecodeStep, PrefillStep

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    B, P, cap = 8, 128, 192
    model = pt.TransformerLM(32000, 1024, 16, args.layers, max_position=cap,
                             dim_feedforward=4096, seed=0)
    if args.weights:
        info = quantized_compute.quantize_layer(model, args.weights)
        print(f"{len(info['quantized'])} linear weights {args.weights}: "
              f"{info['bytes_payload']} payload and {info['bytes_scales']} "
              f"scale bytes against {info['bytes_wide_f32']} in float32")
    ids = np.random.RandomState(0).randint(0, 32000, size=(B, P))
    lens = np.full(B, P, np.int32)
    pre, step = PrefillStep(model), DecodeStep(model)
    for _ in range(2):  # warm up: kernel builds, allocator, cuBLAS
        last, caches, pos = pre(
            model.gen_cache(B, cap, args.kv, block_size=args.block_size),
            ids, lens)
        state = DecodeState.make(caches, last.argmax(-1), pos)
        for _ in range(2):
            _, _, state = step(state)
    torch.cuda.synchronize()

    caches = model.gen_cache(B, cap, args.kv, block_size=args.block_size)
    kv = f"block {args.block_size}" if args.block_size else "contiguous"
    kv += f", {args.kv or 'float32'} KV, {args.weights or 'float32'} weights"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        last, caches, pos = pre(caches, ids, lens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _report(f"prefill B={B} L={P} layers={args.layers} {kv}", wall,
            "prefill", prof, 1)

    state = DecodeState.make(caches, last.argmax(-1), pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        _, _, state = step(state)
    torch.cuda.synchronize()
    print(f"decode B={B} layers={args.layers} {kv}, profiler off: host "
          f"{(time.perf_counter() - t0) * 1e3 / args.steps:.3f} ms per step")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _, _, state = step(state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _report(f"decode B={B} layers={args.layers} {kv}", wall, "step", prof,
            args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
