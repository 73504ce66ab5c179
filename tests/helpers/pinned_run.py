"""Run a verbatim reference script with its starting weights pinned, so
that two packages' runs of it can be held against each other step by step.

    PYTHONPATH=<repo> python pinned_run.py WEIGHTS.npz SCRIPT.py
    python -m paddle_tpu_torch.run --device cpu pinned_run.py WEIGHTS.npz \
        SCRIPT.py

Seeds Python's ``random`` (``paddle.reader.shuffle`` draws from it) and
runs SCRIPT as ``__main__`` with ``sys.argv = [SCRIPT]``. Before the first
``Executor.run`` of the default main program, that program's parameters
(``all_parameters()`` order) are saved to WEIGHTS.npz when it does not
exist (the JAX package's run, first), and set from it when it does (the
port's run, through ``set_program_parameters``). Both runs then start
from the same weights and read the same batches.
"""
import os
import random
import runpy
import sys

import numpy as np

import paddle  # noqa: F401  (the package the run is of, imported first)
import paddle.fluid as fluid


def _pin(program, path):
    params = program.all_parameters()
    if not os.path.exists(path):
        np.savez(path, *[np.asarray(p._data) for p in params],
                 names=np.array([str(p.name) for p in params]))
        return
    from paddle_tpu_torch.static.program import set_program_parameters

    with np.load(path) as f:
        names = [None if n == "None" else n for n in f["names"]]
        vals = [f[f"arr_{i}"] for i in range(len(names))]
    set_program_parameters(program, list(zip(names, vals)))


def main():
    weights, script = sys.argv[1], os.path.abspath(sys.argv[2])
    run = fluid.Executor.run
    pinned = []

    def pinned_run(self, program=None, *args, **kwargs):
        main_program = fluid.default_main_program()
        if not pinned and (program is None or program is main_program):
            _pin(main_program, weights)
            pinned.append(True)
        return run(self, program, *args, **kwargs)

    fluid.Executor.run = pinned_run
    sys.argv = [script]
    random.seed(0)
    runpy.run_path(script, run_name="__main__")
    if not pinned:
        raise SystemExit(f"{script} never ran its main program")


if __name__ == "__main__":
    main()
