"""``DistributedStrategy`` (counterpart of
``paddle_tpu/distributed/fleet/strategy.py``): the one distributed-config
object, a feature flag and a ``*_configs`` dict per feature, with the
JAX package's field names and defaults (``amp_configs`` defaults to bf16,
``use_bf16`` True, dynamic scaling from 32768 when float16 is asked for).

``fleet.init`` lays the world out as ``hybrid_configs`` (dp x pp x sp x
mp; or ``tensor_parallel`` with its ``tensor_parallel_degree``), with dp
factored into dcn x ici under ``hierarchical_allreduce``.
``fleet.distributed_optimizer`` applies the optimizer options: the
``lamb`` and ``lars`` swaps, ``sharding`` (ZeRO stages 1-3 over the dp
group), ``gradient_merge``, the gradient-width options
(``fp16_allreduce``, ``quantized_allreduce``, ``dgc``, which becomes the
latter) and ``quantized_moments``; ``a_sync`` raises there.
``jit.TrainStep`` applies ``amp``, ``recompute``, ``quantized_matmul``
and ``async_dcn_allreduce``, and hands a ``localsgd`` strategy to
``fleet.localsgd.LocalSGDStep``; ``fleet.distributed_model`` reads
``pipeline_configs`` (``accumulate_steps``, ``schedule_mode``) for a
``PipelineLayer``. The one option of ``NOT_PORTED``, ``elastic_reshard``,
is kept as data, and ``distributed_optimizer`` and ``TrainStep`` raise
``NotImplementedError`` naming it.
"""
from __future__ import annotations

import copy


_DEFAULTS = {
    # feature flags and their configs, with the JAX package's names and
    # defaults; `amp` and `pipeline_configs` change what the port runs
    "amp": False,
    "amp_configs": {
        "init_loss_scaling": 32768.0,
        "incr_every_n_steps": 1000,
        "decr_every_n_nan_or_inf": 2,
        "incr_ratio": 2.0,
        "decr_ratio": 0.5,
        "use_dynamic_loss_scaling": True,
        "custom_white_list": [],
        "custom_black_list": [],
        "use_pure_fp16": False,
        "use_bf16": True,
    },
    "recompute": False,
    "recompute_configs": {"checkpoints": []},
    "sharding": False,
    "sharding_configs": {
        "sharding_degree": 8, "stage": 1, "fuse_broadcast_MB": 32.0,
        "hybrid_dp": False,
    },
    "pipeline": False,
    "pipeline_configs": {
        "micro_batch_size": 1, "accumulate_steps": 1, "schedule_mode": "1F1B",
    },
    "tensor_parallel": False,
    "tensor_parallel_configs": {"tensor_parallel_degree": 1},
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "fp16_allreduce": False,
    "localsgd": False,
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "lamb": False,
    "lamb_configs": {"lamb_weight_decay": 0.01, "exclude_from_weight_decay": []},
    "lars": False,
    "lars_configs": {
        "lars_coeff": 0.001, "lars_weight_decay": 0.0005,
        "epsilon": 0.0, "exclude_from_weight_decay": [],
    },
    "hybrid_configs": {
        "dp_degree": 1, "mp_degree": 1, "pp_degree": 1, "sp_degree": 1,
    },
    "hierarchical_allreduce": False,
    "hierarchical_allreduce_inter_nranks": 0,
    "async_dcn_allreduce": False,
    "quantized_allreduce": None,
    "quantized_allreduce_block": 128,
    "quantized_matmul": None,
    "quantized_moments": None,
    "dgc": False,
    "elastic_reshard": None,
    "elastic_reshard_configs": {"quorum": 0.5, "batch": "rescale"},
    "a_sync": False,
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "nccl_comm_num": 1,
    "find_unused_parameters": False,
    "without_graph_optimization": False,
    "last_comm_group_size_MB": 1,
}

#: the options the port keeps as data only: distributed_optimizer and
#: TrainStep refuse a strategy that sets one
NOT_PORTED = ("elastic_reshard",)


class DistributedStrategy:
    """Feature flags and configs, read and set as attributes; an unknown
    field or ``*_configs`` key raises."""

    def __init__(self):
        self.__dict__["_conf"] = copy.deepcopy(_DEFAULTS)

    def __getattr__(self, name):
        conf = self.__dict__["_conf"]
        if name in conf:
            return conf[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        conf = self.__dict__["_conf"]
        if name not in conf:
            raise AttributeError(
                f"DistributedStrategy has no field '{name}' "
                f"(known: {sorted(conf)})"
            )
        if name.endswith("_configs"):
            if not isinstance(value, dict):
                raise TypeError(f"{name} expects a dict")
            known = set(_DEFAULTS[name])
            unknown = set(value) - known
            if unknown:
                # a typo must not silently disable a mode
                raise ValueError(
                    f"unknown key(s) {sorted(unknown)} for {name}; "
                    f"known: {sorted(known)}"
                )
            merged = dict(conf[name])
            merged.update(value)
            conf[name] = merged
        else:
            conf[name] = value

    def not_ported(self):
        """The options of ``NOT_PORTED`` that this strategy sets."""
        return [k for k in NOT_PORTED
                if self._conf[k] not in (False, None, "off")]
