"""Serving of the port: the causal LM, sampling, ``generate`` and the
continuous-batching ``InferenceEngine``, with the serving tier: the paged
KV cache (``paged_kv``), chunked prefill, the prefix cache
(``prefix_cache``), adapter fleets (``adapters``), the int8/fp8 KV cache
and weights, and greedy speculative decoding (``generate(draft_model=)``,
whose step and loop state the serving namespace re-exports)."""
from . import paged_kv, prefix_cache, sampling
from .model import TransformerLM
from .adapters import AdapterSet
from .engine import (
    GeneratedResult, GenerationConfig, InferenceEngine, Request, bucket_for,
    generate, prefill_buckets, prefill_chunk_default,
)
from .prefix_cache import PrefixCache
from ..jit.decode_step import (SpecDecodeState, SpeculativeDecodeStep,
                               spec_k_default)
from ..jit.save_load import load_quantized, save_quantized

__all__ = ["sampling", "paged_kv", "prefix_cache", "TransformerLM",
           "AdapterSet", "PrefixCache", "GenerationConfig", "generate",
           "Request", "GeneratedResult", "InferenceEngine",
           "prefill_buckets", "bucket_for", "prefill_chunk_default",
           "SpeculativeDecodeStep", "SpecDecodeState", "spec_k_default",
           "save_quantized", "load_quantized"]
