"""Time chip_smoke.py's phases whose GPT-medium keeps bench's width and
only some of its 24 blocks (the depth cuts), at several depths, one after
another on one card.

    python3 tools/time_depth_cuts.py PHASE [--depths 4,24,4,24]

PHASE is ``serving`` (the serving, serving tier, quantized serving,
speculative and router phases, ``CHIP_SMOKE_SERVE_LAYERS``),
``multichip`` (``CHIP_SMOKE_MC_LAYERS``), ``jit_save``
(``CHIP_SMOKE_SAVE_LAYERS``) or ``guarded`` (``CHIP_SMOKE_GUARD_LAYERS``).
Builds the port's kernels, then runs the phase (every gate of it) once for
each depth in the order given, each run in a process of its own (the
guarded phase arms the profiler's one trace window a process) with the
depth's variable set, so that the processes a phase starts build the same
depth. A run's seconds are the phase's own, from its call to its return
(the process's start and the cached build's load are outside them).
Prints them and writes them, with the card's name and power limit, to
``chiprun_out/time_depth_cuts_<PHASE>.json``. Needs a CUDA device.
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
#: phase -> (its depth's variable, chip_smoke's functions, in order)
PHASES = {
    "serving": ("CHIP_SMOKE_SERVE_LAYERS", (
        "serving_phase", "serving_tier_phase", "quant_serving_phase",
        "speculative_phase", "router_phase")),
    "multichip": ("CHIP_SMOKE_MC_LAYERS", ("multichip_gpt_phase",)),
    "jit_save": ("CHIP_SMOKE_SAVE_LAYERS", ("jit_save_phase",)),
    "guarded": ("CHIP_SMOKE_GUARD_LAYERS", ("guarded_training_phase",)),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def child(phase: str, n: int) -> None:
    """One run of ``phase`` at ``n`` blocks; prints ``RESULT {json}``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build

    _build.build(kernels.SOURCES)  # built by the parent: loads
    pt.set_device("gpu")
    name = card()
    secs = {}
    t0 = time.perf_counter()
    for fn in PHASES[phase][1]:
        t = time.perf_counter()
        f = getattr(cs, fn)
        f(pt, kernels) if fn == "serving_phase" else f(pt, kernels, name)
        secs[fn] = time.perf_counter() - t
    print("RESULT " + json.dumps({"layers": n, "s": time.perf_counter() - t0,
                                  "by_phase": secs}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=sorted(PHASES))
    ap.add_argument("--depths", default="4,24,4,24",
                    help="the GPT's blocks for each run, in order")
    ap.add_argument("--child", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_depth_cuts: no CUDA device", file=sys.stderr)
        return 1
    if args.child is not None:
        child(args.phase, args.child)
        return 0
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build

    name = card()
    print(name, flush=True)
    _build.build(kernels.SOURCES)
    var = PHASES[args.phase][0]
    runs = []
    for n in (int(d) for d in args.depths.split(",")):
        env = dict(os.environ, **{var: str(n)})
        p = subprocess.run([sys.executable, __file__, args.phase, "--child",
                            str(n)], env=env, capture_output=True,
                           text=True)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            print(f"time_depth_cuts: {args.phase} at {n} blocks failed "
                  f"(rc {p.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1][len("RESULT "):]))
        print(f"{args.phase} at {n} of 24 blocks: {runs[-1]['s']:.1f} s "
              f"{ {k: round(v, 1) for k, v in runs[-1]['by_phase'].items()} }",
              flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    result = {"card": name, "phase": args.phase, "variable": var,
              "runs": runs}
    (out / f"time_depth_cuts_{args.phase}.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
