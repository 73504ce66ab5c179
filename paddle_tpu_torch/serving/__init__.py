"""Serving of the port: the causal LM, sampling, ``generate`` and the
continuous-batching ``InferenceEngine`` (contiguous KV pool)."""
from . import sampling
from .model import TransformerLM
from .engine import (
    GeneratedResult, GenerationConfig, InferenceEngine, Request, bucket_for,
    generate, prefill_buckets,
)

__all__ = ["sampling", "TransformerLM", "GenerationConfig", "generate",
           "Request", "GeneratedResult", "InferenceEngine",
           "prefill_buckets", "bucket_for"]
