"""``paddle_tpu_torch.distributed.fleet``: the module acts as the fleet
singleton (``fleet.init``, ``fleet.distributed_model``,
``fleet.distributed_optimizer``, the worker API), as paddle's does."""
from .base import Fleet, HybridCommunicateGroup, fleet as _fleet
from .strategy import DistributedStrategy

init = _fleet.init
worker_index = _fleet.worker_index
worker_num = _fleet.worker_num
is_first_worker = _fleet.is_first_worker
is_worker = _fleet.is_worker
is_server = _fleet.is_server
worker_endpoints = _fleet.worker_endpoints
barrier_worker = _fleet.barrier_worker
stop_worker = _fleet.stop_worker
distributed_model = _fleet.distributed_model
distributed_optimizer = _fleet.distributed_optimizer
get_hybrid_communicate_group = _fleet.get_hybrid_communicate_group

__all__ = [
    "DistributedStrategy", "Fleet", "HybridCommunicateGroup", "init",
    "worker_index", "worker_num", "is_first_worker", "is_worker",
    "is_server", "worker_endpoints", "barrier_worker", "stop_worker",
    "distributed_model", "distributed_optimizer",
    "get_hybrid_communicate_group",
]
