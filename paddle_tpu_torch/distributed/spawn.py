"""paddle.distributed.spawn: start ``nprocs`` ranks of ``func(*args)`` from
Python (counterpart of ``paddle_tpu/distributed/spawn.py``; reference:
python/paddle/distributed/spawn.py:276).

Each rank is a process made with the ``spawn`` start method (a forked
child of a process that touched CUDA, or that runs threads, is unsafe),
with the env of ``launch.build_cluster_env`` set before ``func`` runs.
The first rank to fail ends the job: the others are terminated and a
``RuntimeError`` names the rank and its exit code. A job still running
after ``timeout`` seconds (the caller's deadline) is killed, and the error
says so.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import Optional, Tuple

from .launch import build_cluster_env

__all__ = ["spawn"]


def _worker(func, args, env):
    os.environ.update(env)
    func(*args)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(func, args: Tuple = (), nprocs: int = 1, join: bool = True,
          daemon: bool = False, backend: Optional[str] = None,
          start_port: Optional[int] = None,
          timeout: Optional[float] = None,
          **options):
    """spawn.py:276 parity. Returns the process list (not yet joined when
    ``join=False``). ``backend`` is passed to the ranks as
    ``PADDLE_DISTRI_BACKEND`` (checked there against the rule of
    ``comm.py``). ``start_port`` None takes a free port of this host
    (``launch.build_cluster_env``)."""
    ctx = mp.get_context("spawn")
    envs = build_cluster_env(nprocs, start_port=start_port)
    procs = []
    for env in envs:
        if backend:
            env["PADDLE_DISTRI_BACKEND"] = backend
        p = ctx.Process(target=_worker, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if not join:
        return procs
    t_end = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            for rank, p in enumerate(procs):
                if not p.is_alive() and p.exitcode != 0:
                    raise RuntimeError(
                        f"spawned rank {rank} exited with code {p.exitcode}")
            if not any(p.is_alive() for p in procs):
                return procs
            if t_end is not None and time.monotonic() > t_end:
                alive = [r for r, p in enumerate(procs) if p.is_alive()]
                raise RuntimeError(f"spawned ranks {alive} still running "
                                   f"after {timeout:g} s: killed")
            time.sleep(0.05)
    finally:
        _stop(procs)
