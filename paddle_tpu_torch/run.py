"""Run a Paddle script verbatim on the port.

    python -m paddle_tpu_torch.run [--device cpu] script.py [args...]

The launcher puts ``compat/`` at the head of ``sys.path``, ahead of the
script's directory and of the directory the launcher runs from, so the
script's ``import paddle`` and ``import paddle.fluid as fluid`` load the
port's route (``compat/paddle``), whatever other ``paddle`` the path
holds. It sets ``sys.argv`` to the script and its arguments and runs the
script as ``__main__``. The run is on the card unless ``--device cpu``
asks for the CPU (``set_device("cpu")``); without a card it fails. At exit
it prints one line to stderr::

    paddle_tpu_torch.run: device=cuda:0 max_memory_allocated=<bytes> \
jax_loaded=False paddle_tpu_loaded=False kernel_launches={"...":0,...}

(``max_memory_allocated`` is ``torch.cuda.max_memory_allocated()``, 0 on
the CPU; the next two say whether ``jax`` or ``paddle_tpu`` were loaded
into the process; the last is ``ops.kernels.launches()``, each kernel
wrapper's launches in the run, as JSON.)
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys

_COMPAT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "compat")


def _exit_line(device) -> str:
    import json

    import torch

    from .ops import kernels

    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    mods = set(sys.modules)
    return (f"paddle_tpu_torch.run: device={device} "
            f"max_memory_allocated={peak} "
            f"jax_loaded={any(m == 'jax' or m.startswith('jax.') for m in mods)} "
            f"paddle_tpu_loaded="
            f"{any(m == 'paddle_tpu' or m.startswith('paddle_tpu.') for m in mods)} "
            f"kernel_launches="
            f"{json.dumps(kernels.launches(), separators=(',', ':'))}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.run",
        description="run a Paddle script verbatim on the port")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)

    script = os.path.abspath(ns.script)
    sys.path[:] = [_COMPAT, os.path.dirname(script)] + [
        p for p in sys.path if p not in (_COMPAT, os.path.dirname(script))]
    import paddle_tpu_torch as pt

    pt.set_device(ns.device or "gpu")
    device = pt.core.resolve_device(None)
    sys.argv = [script] + list(ns.args)
    try:
        runpy.run_path(script, run_name="__main__")
    finally:
        print(_exit_line(device), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
