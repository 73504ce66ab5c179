"""Time chip_smoke.py's guarded training phase at several depths of its
GPT, one after another on one card.

    python3 tools/time_guarded_depth.py [--depths 4,24,4,24]

Builds the port's kernels, then runs ``chip_smoke.guarded_training_phase``
(every gate of it) once for each depth in the order given, each run in a
process of its own (the phase arms the profiler's one trace window a
process), with ``CHIP_SMOKE_GUARD_LAYERS`` set so that its
``--acp-child`` processes build the same depth. A run's seconds are the
phase's own, from its call to its return (the process's start and the
cached build's load are outside them). Prints them and writes them, with
the card's name and power limit, to
``chiprun_out/time_guarded_depth.json``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def child(n: int) -> None:
    """One run of the phase at ``n`` blocks; prints ``RESULT {json}``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build

    _build.build(kernels.SOURCES)  # built by the parent: loads
    pt.set_device("gpu")
    t0 = time.perf_counter()
    cs.guarded_training_phase(pt, kernels, card())
    print("RESULT " + json.dumps({"layers": n,
                                  "s": time.perf_counter() - t0}),
          flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="4,24,4,24",
                    help="the GPT's blocks for each run, in order")
    ap.add_argument("--child", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_guarded_depth: no CUDA device", file=sys.stderr)
        return 1
    if args.child is not None:
        child(args.child)
        return 0
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build

    name = card()
    print(name, flush=True)
    _build.build(kernels.SOURCES)
    runs = []
    for n in (int(d) for d in args.depths.split(",")):
        env = dict(os.environ, CHIP_SMOKE_GUARD_LAYERS=str(n))
        p = subprocess.run([sys.executable, __file__, "--child", str(n)],
                           env=env, capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            print(f"time_guarded_depth: the run at {n} blocks failed "
                  f"(rc {p.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1][len("RESULT "):]))
        print(f"guarded training phase at {n} of 24 blocks: "
              f"{runs[-1]['s']:.1f} s", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    result = {"card": name, "runs": runs}
    (out / "time_guarded_depth.json").write_text(json.dumps(result,
                                                            indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
