"""``paddle_tpu_torch.distributed`` (counterpart of
``paddle_tpu/distributed/__init__.py``; reference surface:
python/paddle/distributed/__init__.py).

**A rank is a process** of a ``torch.distributed`` process group, each
with its own tensors: the JAX package's single-controller model, where a
per-rank value is a global array with a leading rank axis, becomes
upstream Paddle's (and PyTorch's) model, where row ``r`` of that axis is
what rank ``r`` holds (``comm.py``). The backend follows a rule: ``nccl``
when each rank of a host has a card of its own, ``gloo`` when ranks share
a card or run on the CPU.

Ported: the world and its groups (``comm``), the collectives
(``collective``), the comm monitor (``comm_monitor``), ``spawn`` and the
``python -m paddle_tpu_torch.distributed.launch`` launcher,
``DataParallel`` across trainers (``parallel``), the tensor-parallel
layers at any mp (``meta_parallel``), the pipeline (``pipeline``: one
stage a rank, 1F1B and F-then-B), ``fleet`` at any dp x pp x sp x mp
(dp factored into dcn x ici under ``hierarchical_allreduce``), the
quantization plane (``quantized_comm``: the quantizer, the quantized
allreduce and KV layout; ``quantized_compute``: narrow serving weights,
``qat_matmul``, the narrow Adam moments), the per-gradient dcn hop and
the tensor-parallel overlap rings (``overlap``), the strategy's optimizer
options (``fleet``: ZeRO stages 1-3, gradient merge, the Lamb and Lars
swaps; ``fleet.localsgd``), ``elastic`` (the trainer's half and the
launcher's ``ElasticManager``) and in-job resharding (``resharding``:
the planner, coverage and ``ElasticStep`` over a rebuilt world); ring and
Ulysses attention live in ``nn/layers/ring_attention.py`` and MoE in
``incubate/moe.py``. The launcher's embedded fleet monitor and co-tenancy
controller are ROADMAP queue A item 8.
"""
from . import (comm, comm_monitor, collective, elastic, fleet, overlap,
               parallel, pipeline, quantized_comm, quantized_compute,
               resharding)
from .collective import (ReduceOp, all_gather, all_reduce, alltoall,
                         barrier, broadcast, monitored_barrier, reduce,
                         reduce_scatter, scatter, wait)
from .comm import (Group, ParallelEnv, get_group, get_rank, get_world_size,
                   in_spmd_region, init_parallel_env, is_initialized,
                   new_group, replicate, shard_rank_axis, spmd_region)
from .meta_parallel import (
    ColumnParallelLinear, ParallelGPTBlock, ParallelMultiHeadAttention,
    RowParallelLinear, VocabParallelEmbedding, split,
)
from .parallel import DataParallel
from .pipeline import PipelineLayer, PipelineParallel
from .spawn import spawn


def __getattr__(name):
    # .launch is the `python -m paddle_tpu_torch.distributed.launch` entry
    # point: imported on first use, since importing it with the package
    # would trip runpy's re-execution warning
    if name == "launch":
        import importlib

        return importlib.import_module(".launch", __name__)
    raise AttributeError(name)


__all__ = ["comm", "comm_monitor", "collective", "elastic", "fleet",
           "overlap", "parallel", "pipeline", "quantized_comm",
           "quantized_compute", "resharding",
           "PipelineLayer", "PipelineParallel",
           "ReduceOp", "all_gather", "all_reduce", "alltoall", "barrier",
           "broadcast", "monitored_barrier", "reduce", "reduce_scatter",
           "scatter", "wait", "Group", "ParallelEnv", "get_group",
           "get_rank", "get_world_size", "in_spmd_region",
           "init_parallel_env", "is_initialized", "new_group", "replicate",
           "shard_rank_axis", "spmd_region", "DataParallel", "spawn",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelMultiHeadAttention",
           "ParallelGPTBlock", "split"]
