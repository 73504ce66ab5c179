"""Distributed layers of the port (single-device form so far), ``fleet``,
the one-device mesh of ``comm``, and the quantization plane's serving
half (``quantized_comm``: the quantizer and the KV layout;
``quantized_compute``: narrow weights)."""
from . import comm, fleet, quantized_comm, quantized_compute
from .meta_parallel import (
    ColumnParallelLinear, ParallelGPTBlock, ParallelMultiHeadAttention,
    RowParallelLinear,
)

__all__ = ["comm", "fleet", "quantized_comm", "quantized_compute",
           "ColumnParallelLinear", "RowParallelLinear",
           "ParallelMultiHeadAttention", "ParallelGPTBlock"]
