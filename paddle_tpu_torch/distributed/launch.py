"""The launcher: one process per rank of this host (counterpart of
``paddle_tpu/distributed/launch.py``).

Reference: python/paddle/distributed/fleet/launch.py (launch_collective
:208: one subprocess per device with ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINER_ENDPOINTS``, then a watch loop that tears the job down
when a process dies, launch_utils.py:996-1118).

Each rank is a process (``comm.py``): ``--nproc_per_node N`` starts N
copies of the script with the env of :func:`build_cluster_env`, rank 0's
endpoint doubling as the rendezvous address of ``init_parallel_env``. Each
child writes to ``<log_dir>/workerlog.<rank>`` (its parent's stdio without
a log dir). The first child to fail ends the job: the others get SIGTERM,
then SIGKILL 10 s later, and its exit code is returned. A job still running
at ``deadline`` seconds is killed and returns ``HUNG_RC`` (98). The
children also get ``PADDLE_COLL_SYNC_DIR`` (a fresh directory, for
``monitored_barrier`` and the desync exchange, removed when the job
ends), ``PADDLE_COLL_DEBUG_DIR``
(the log dir, where flight-recorder dumps land), ``PADDLE_COLL_TIMEOUT``
from ``coll_timeout`` and ``PADDLE_DISTRI_BACKEND`` from ``backend`` (a
backend that disagrees with the rule of ``comm.py`` makes the ranks raise).
Without ``start_port`` (or ``PADDLE_PORT``) a job of one host takes a port
that is free on it, so two jobs on one host do not collide; a job of
several hosts takes 6170, which every host must agree on.

Usage::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \\
        [--ips=h1,h2] [--start_port=P] [--deadline=600] train.py [args]

The elastic options of the JAX package's launcher (``elastic_retries``,
``watchdog_timeout``, ``reshard``, ``monitor``, ``ctl``) belong to its
``ElasticManager``, ROADMAP queue A item 7's last part: set, they raise.
"""
from __future__ import annotations

import argparse
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from .elastic import HUNG_RC

__all__ = ["launch", "build_cluster_env", "main"]

#: the first port of a job of several hosts when none is given
DEFAULT_PORT = 6170


def free_port() -> int:
    """A TCP port that is free on this host now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_port(start_port: Optional[int], n_hosts: int) -> int:
    if start_port is not None:
        return int(start_port)
    env = os.environ.get("PADDLE_PORT")
    if env:
        return int(env)
    return free_port() if n_hosts == 1 else DEFAULT_PORT


def build_cluster_env(nproc: int, ips: str = "127.0.0.1",
                      start_port: Optional[int] = None,
                      base_env: Dict[str, str] = None) -> List[Dict[str, str]]:
    """Per-rank environment blocks (launch_utils.py get_cluster analog):
    endpoints are host:port pairs, rank-major across hosts; rank 0's is the
    rendezvous address. ``start_port`` None: ``PADDLE_PORT``, else a free
    port of this host for one host, else ``DEFAULT_PORT``."""
    if nproc < 1:
        raise ValueError(f"nproc must be >= 1, got {nproc}")
    hosts = [h.strip() for h in ips.split(",") if h.strip()]
    if not hosts:
        raise ValueError(f"no hosts parsed from ips={ips!r}")
    start_port = _start_port(start_port, len(hosts))
    endpoints = [f"{host}:{start_port + p}" for host in hosts
                 for p in range(nproc)]
    envs = []
    for rank, ep in enumerate(endpoints):
        env = dict(base_env if base_env is not None else os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(len(endpoints)),
            "PADDLE_CURRENT_ENDPOINT": ep,
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        })
        envs.append(env)
    return envs


def _stop(procs, grace: float = 10.0) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    t_end = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(timeout=max(t_end - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(script: str, script_args: List[str], nproc_per_node: int = 1,
           ips: str = "127.0.0.1", start_port: Optional[int] = None,
           backend: Optional[str] = None, node_rank: Optional[int] = None,
           elastic_retries: int = 0, watchdog_timeout: float = None,
           log_dir: Optional[str] = None, coll_timeout: float = None,
           reshard: str = None, reshard_quorum: float = None,
           monitor: bool = None, ctl: str = None,
           deadline: Optional[float] = None) -> int:
    """Start this host's ranks (``node_rank`` of ``ips``, default
    ``PADDLE_NODE_RANK`` or 0) and watch them. Returns 0 when all exit 0,
    else the first failure's exit code (``HUNG_RC`` at the deadline)."""
    for name, value in (("elastic_retries", elastic_retries or None),
                        ("watchdog_timeout", watchdog_timeout),
                        ("reshard", None if reshard in (None, "off")
                         else reshard),
                        ("reshard_quorum", reshard_quorum),
                        ("monitor", monitor), ("ctl", None if ctl in
                                               (None, "off") else ctl)):
        if value is not None:
            raise NotImplementedError(
                f"launch({name}={value!r}): the elastic launcher is not "
                "ported yet, ROADMAP queue A item 7")
    if node_rank is None:
        node_rank = int(os.environ.get("PADDLE_NODE_RANK", "0"))
    hosts = [h.strip() for h in ips.split(",") if h.strip()]
    if not 0 <= node_rank < len(hosts):
        raise ValueError(
            f"node_rank {node_rank} out of range for {len(hosts)} hosts")
    envs = build_cluster_env(nproc_per_node, ips=ips, start_port=start_port)
    lo = node_rank * nproc_per_node
    envs = envs[lo:lo + nproc_per_node]
    log_dir = log_dir or os.environ.get("PADDLE_LOG_DIR")
    own_sync = not os.environ.get("PADDLE_COLL_SYNC_DIR")
    sync_dir = tempfile.mkdtemp(prefix="paddle_coll_sync_") if own_sync \
        else os.environ["PADDLE_COLL_SYNC_DIR"]
    procs, logs = [], []
    try:
        for env in envs:
            env["PADDLE_COLL_SYNC_DIR"] = sync_dir
            if backend:
                env["PADDLE_DISTRI_BACKEND"] = backend
            if coll_timeout is not None:
                env["PADDLE_COLL_TIMEOUT"] = str(coll_timeout)
            out = None
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                env["PADDLE_COLL_DEBUG_DIR"] = log_dir
                out = open(os.path.join(
                    log_dir, f"workerlog.{env['PADDLE_TRAINER_ID']}"), "w")
                logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-u", script] + list(script_args), env=env,
                stdout=out, stderr=subprocess.STDOUT if out else None))
        t_end = None if deadline is None else time.monotonic() + deadline
        while True:
            codes = [p.poll() for p in procs]
            bad = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                rank, rc = bad[0]
                print(f"paddle_tpu_torch.launch: rank {lo + rank} exited "
                      f"with code {rc}; stopping the job", file=sys.stderr,
                      flush=True)
                _stop(procs)
                return rc
            if all(c == 0 for c in codes):
                return 0
            if t_end is not None and time.monotonic() > t_end:
                print(f"paddle_tpu_torch.launch: deadline {deadline:g} s "
                      "passed; killing the job", file=sys.stderr, flush=True)
                _stop(procs, grace=2.0)
                return HUNG_RC
            time.sleep(0.1)
    finally:
        _stop(procs, grace=2.0)
        for f in logs:
            f.close()
        if own_sync:
            shutil.rmtree(sync_dir, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="start one training process per rank of this host")
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--node_rank", type=int, default=None,
                        help="index of this host in --ips "
                             "(default: $PADDLE_NODE_RANK or 0)")
    parser.add_argument("--ips", type=str, default="127.0.0.1")
    parser.add_argument("--start_port", type=int, default=None,
                        help="rank 0's port (default: $PADDLE_PORT, else "
                             f"a free port for one host, else {DEFAULT_PORT})")
    parser.add_argument("--backend", type=str, default=None,
                        help="the torch.distributed backend the ranks must "
                             "get by the rule (nccl or gloo)")
    parser.add_argument("--log_dir", type=str, default=None,
                        help="each rank's output to <log_dir>/workerlog.N "
                             "(default: $PADDLE_LOG_DIR, unset = inherit)")
    parser.add_argument("--coll_timeout", type=float, default=None,
                        help="per-collective deadline in seconds for the "
                             "ranks' comm monitor")
    parser.add_argument("--deadline", type=float, default=None,
                        help="kill the job after this many seconds")
    parser.add_argument("script", type=str)
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    sys.exit(launch(
        args.script, args.script_args, nproc_per_node=args.nproc_per_node,
        ips=args.ips, start_port=args.start_port, backend=args.backend,
        node_rank=args.node_rank, log_dir=args.log_dir,
        coll_timeout=args.coll_timeout, deadline=args.deadline))


if __name__ == "__main__":
    main()
