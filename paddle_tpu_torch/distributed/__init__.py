"""Distributed layers of the port (single-device form so far) and
``fleet``."""
from . import fleet
from .meta_parallel import (
    ColumnParallelLinear, ParallelGPTBlock, ParallelMultiHeadAttention,
    RowParallelLinear,
)

__all__ = ["fleet", "ColumnParallelLinear", "RowParallelLinear",
           "ParallelMultiHeadAttention", "ParallelGPTBlock"]
