"""The launcher: one process per rank of this host (counterpart of
``paddle_tpu/distributed/launch.py``).

Reference: python/paddle/distributed/fleet/launch.py (launch_collective
:208: one subprocess per device with ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINER_ENDPOINTS``, then a watch loop that tears the job down
when a process dies, launch_utils.py:996-1118).

Each rank is a process (``comm.py``): ``--nproc_per_node N`` starts N
copies of the script with the env of :func:`build_cluster_env`, rank 0's
endpoint doubling as the rendezvous address of ``init_parallel_env``.
Without ``start_port`` (or ``PADDLE_PORT``) a job of one host takes a port
that is free on it, so two jobs on one host do not collide; a job of
several hosts takes 6170, which every host must agree on.

The ranks are watched by ``elastic.ElasticManager`` (its notes): each
child writes to ``<log_dir>/workerlog.<rank>`` (its parent's stdio without
a log dir); the first child to fail ends the job (the others get SIGTERM,
then SIGKILL after the grace) and its exit code is returned, unless
``elastic_retries`` relaunches the job or ``reshard`` retires the rank
while the quorum holds; ``watchdog_timeout`` puts down a rank whose
heartbeat goes stale; a job still running at ``deadline`` seconds is
killed and returns ``HUNG_RC`` (98). The children also get
``PADDLE_COLL_SYNC_DIR`` (a fresh directory an attempt, under the
launcher's own ``PADDLE_COLL_SYNC_DIR`` where set: the hosts of a job share
it), ``PADDLE_COLL_DEBUG_DIR`` (the log dir, where flight-recorder
dumps land), ``PADDLE_COLL_TIMEOUT`` from ``coll_timeout`` and
``PADDLE_DISTRI_BACKEND`` from ``backend`` (a backend that disagrees with
the rule of ``comm.py`` makes the ranks raise).

Usage::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \\
        [--ips=h1,h2] [--start_port=P] [--deadline=600] \\
        [--elastic_retries=N] [--watchdog_timeout=S] \\
        [--reshard=shrink --reshard_quorum=0.5] train.py [args]

``monitor`` and ``ctl`` (the embedded fleet monitor and the co-tenancy
controller) are ROADMAP queue A item 8: set, they raise.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
from typing import Dict, List, Optional

from .elastic import ElasticManager

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


def launch(script: str, script_args: List[str], nproc_per_node: int = 1,
           ips: str = "127.0.0.1", start_port: Optional[int] = None,
           backend: Optional[str] = None, node_rank: Optional[int] = None,
           elastic_retries: int = 0, watchdog_timeout: float = None,
           log_dir: Optional[str] = None, coll_timeout: float = None,
           reshard: str = None, reshard_quorum: float = None,
           monitor: bool = None, ctl: str = None,
           deadline: Optional[float] = None) -> int:
    """Start this host's ranks (``node_rank`` of ``ips``, default
    ``PADDLE_NODE_RANK`` or 0) and watch them through
    ``elastic.ElasticManager``. Returns 0 when all exit 0 (ranks a
    quorum-holding reshard retired included), else the first failure's
    exit code (``HUNG_RC`` at the deadline or after a watchdog kill)."""
    if node_rank is None:
        node_rank = int(os.environ.get("PADDLE_NODE_RANK", "0"))
    hosts = [h.strip() for h in ips.split(",") if h.strip()]
    if not 0 <= node_rank < len(hosts):
        raise ValueError(
            f"node_rank {node_rank} out of range for {len(hosts)} hosts")
    envs = build_cluster_env(nproc_per_node, ips=ips, start_port=start_port)
    lo = node_rank * nproc_per_node
    mgr = ElasticManager(
        script, list(script_args), envs[lo:lo + nproc_per_node],
        backend=backend, max_restarts=int(elastic_retries),
        watchdog_timeout=watchdog_timeout, log_dir=log_dir,
        coll_timeout=coll_timeout, reshard=reshard,
        reshard_quorum=reshard_quorum, monitor=monitor, controller=ctl,
        deadline=deadline)
    return mgr.run()


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
    parser.add_argument("--elastic_retries", type=int, default=0,
                        help="relaunch the whole job up to N times per "
                             "rolling PADDLE_ELASTIC_WINDOW after a failure")
    parser.add_argument("--watchdog_timeout", type=float, default=None,
                        help="seconds without a rank heartbeat before the "
                             "watchdog puts it down (default: "
                             "$PADDLE_WATCHDOG_TIMEOUT, 0 = off)")
    parser.add_argument("--reshard", type=str, default=None,
                        choices=("off", "shrink", "shrink_expand"),
                        help="turn a quorum-holding rank loss into an "
                             "in-job reshard notice (default: "
                             "$PADDLE_RESHARD_MODE or off)")
    parser.add_argument("--reshard_quorum", type=float, default=None,
                        help="least surviving share for an in-job reshard "
                             "(default: $PADDLE_RESHARD_QUORUM or 0.5)")
    parser.add_argument("--monitor", type=str, default=None,
                        choices=("on", "off"),
                        help="the embedded fleet monitor: 'on' raises "
                             "(ROADMAP queue A item 8)")
    parser.add_argument("--ctl", type=str, default=None,
                        choices=("off", "dryrun", "live"),
                        help="the co-tenancy controller: anything but "
                             "'off' raises (ROADMAP queue A item 8)")
    parser.add_argument("script", type=str)
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    sys.exit(launch(
        args.script, args.script_args, nproc_per_node=args.nproc_per_node,
        ips=args.ips, start_port=args.start_port, backend=args.backend,
        node_rank=args.node_rank, log_dir=args.log_dir,
        coll_timeout=args.coll_timeout, deadline=args.deadline,
        elastic_retries=args.elastic_retries,
        watchdog_timeout=args.watchdog_timeout, reshard=args.reshard,
        reshard_quorum=args.reshard_quorum,
        monitor=None if args.monitor is None else args.monitor == "on",
        ctl=args.ctl))


if __name__ == "__main__":
    main()
