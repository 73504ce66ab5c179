"""Where the host time of a ``to_static`` training step goes, beside the
eager step, on one card.

    python3 tools/profile_torch_to_static.py [--layers 24] [--steps 3]

Builds chip_smoke.py's copy of bench.py's GPT-medium program twice from
one set of weights (float32, TF32 off, AdamW lr 1e-4 / weight decay 0.01,
B = 4, S = 1024, its fused-CE loss), one of them under
``paddle.jit.to_static``, and takes two warm-up steps of each. Then, each
path in turns: ``--steps`` steps with the profiler off (host ms per step,
ending in a synchronize); the ops that reach the dispatcher in one step
(a ``TorchDispatchMode`` count, forward and backward); ``--steps`` steps
under ``torch.profiler`` (device busy and idle share); one step under
``cProfile`` (the Python functions with the most host time of their own).
Also times one call of the captured forward through
``ExportedProgram.module()`` beside its lifted ``graph_module``. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from profile_torch_serving import _report  # noqa: E402


class _Ops(TorchDispatchMode):
    """Counts the ops that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.count = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_to_static: needs a CUDA device", file=sys.stderr)
        return 1
    import paddle_tpu_torch as paddle
    from chip_smoke import _bench_lm_loss, _gpt_medium

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    paddle.set_device("gpu")
    paddle.seed(0)
    B, S = 4, 1024
    model = _gpt_medium()
    if args.layers != 24:
        model = type(model)(layers=args.layers)
    twin = type(model)(layers=args.layers)
    twin.set_state_dict(model.state_dict())
    ids = paddle.to_tensor((np.arange(B * S) % 31000).reshape(B, S))
    labels = paddle.to_tensor(((np.arange(B * S) + 1) % 31000).reshape(B, S))
    paths = {}
    for name, m in (("to_static", paddle.jit.to_static(model)),
                    ("eager", twin)):
        opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                     parameters=m.parameters())
        loss_of = _bench_lm_loss(m)

        def step(m=m, opt=opt, loss_of=loss_of):
            loss = loss_of(m(ids), labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        paths[name] = step
    for _ in range(2):
        for step in paths.values():
            float(step())
    what = f"GPT-medium float32 B={B} S={S} layers={args.layers}"
    for name, step in paths.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / args.steps
        print(f"{name} {what}, profiler off: host {ms:.3f} ms per step")
    for name, step in paths.items():
        with _Ops() as ops:
            step()
        print(f"{name}: {sum(ops.count.values())} dispatcher ops a step; "
              f"most: {ops.count.most_common(8)}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        _report(f"{name} {what}", wall, "step", prof, args.steps)
        pr = cProfile.Profile()
        pr.enable()
        step()
        torch.cuda.synchronize()
        pr.disable()
        out = io.StringIO()
        pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(15)
        print(f"{name}: one step's Python functions by own host time\n"
              + "\n".join(out.getvalue().splitlines()[4:26]))
    (prog,) = model.forward.program_cache.values()
    flat = prog.state.live() + [ids._data]
    for label, fn in (("ExportedProgram.module()", prog.module),
                      ("graph_module", prog.exported.graph_module)):
        with torch.no_grad():
            fn(*flat)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*flat)
            torch.cuda.synchronize()
        print(f"captured forward through {label}: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms (no grad)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
