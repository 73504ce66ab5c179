"""Serving of the port: the causal LM, sampling, ``generate`` and the
continuous-batching ``InferenceEngine``, with the serving tier: the paged
KV cache (``paged_kv``), chunked prefill, the prefix cache
(``prefix_cache``) and adapter fleets (``adapters``)."""
from . import paged_kv, prefix_cache, sampling
from .model import TransformerLM
from .adapters import AdapterSet
from .engine import (
    GeneratedResult, GenerationConfig, InferenceEngine, Request, bucket_for,
    generate, prefill_buckets, prefill_chunk_default,
)
from .prefix_cache import PrefixCache

__all__ = ["sampling", "paged_kv", "prefix_cache", "TransformerLM",
           "AdapterSet", "PrefixCache", "GenerationConfig", "generate",
           "Request", "GeneratedResult", "InferenceEngine",
           "prefill_buckets", "bucket_for", "prefill_chunk_default"]
