"""``paddle_tpu_torch.distributed.fleet``: the module acts as the fleet
singleton (``fleet.init``, ``fleet.distributed_optimizer``), as paddle's
does."""
from .base import Fleet, fleet as _fleet
from .strategy import DistributedStrategy

init = _fleet.init
distributed_optimizer = _fleet.distributed_optimizer

__all__ = ["DistributedStrategy", "Fleet", "init", "distributed_optimizer"]
