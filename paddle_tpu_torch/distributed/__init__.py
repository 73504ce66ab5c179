"""Distributed layers of the port (single-device form so far), ``fleet``,
``parallel`` (``DataParallel``, ``ParallelEnv``, ``init_parallel_env`` at a
world size of one),
the one-device mesh of ``comm``, the quantization plane's serving
half (``quantized_comm``: the quantizer and the KV layout;
``quantized_compute``: narrow weights), and the trainer's half of
``elastic`` (heartbeat, the preemption notice)."""
from . import (comm, elastic, fleet, parallel, quantized_comm,
               quantized_compute)
from .meta_parallel import (
    ColumnParallelLinear, ParallelGPTBlock, ParallelMultiHeadAttention,
    RowParallelLinear,
)
from .parallel import DataParallel, ParallelEnv, init_parallel_env

__all__ = ["comm", "elastic", "fleet", "parallel", "quantized_comm",
           "quantized_compute",
           "DataParallel", "ParallelEnv", "init_parallel_env",
           "ColumnParallelLinear", "RowParallelLinear",
           "ParallelMultiHeadAttention", "ParallelGPTBlock"]
