"""Serving of the port: the causal LM, sampling, ``generate`` and the
continuous-batching ``InferenceEngine``, with the serving tier: the paged
KV cache (``paged_kv``), chunked prefill, the prefix cache
(``prefix_cache``), adapter fleets (``adapters``), the int8/fp8 KV cache
and weights, greedy speculative decoding (``generate(draft_model=)``,
whose step and loop state the serving namespace re-exports); and the
router's plane: KV migration (``kv_migration``), elastic slots, the
``decode_metrics`` telemetry, and the ``router`` with its in-process and
mailbox hosts and disaggregated prefill."""
from . import kv_migration, paged_kv, prefix_cache, router, sampling
from .model import TransformerLM
from .adapters import AdapterSet
from .engine import (
    GeneratedResult, GenerationConfig, InferenceEngine, Request, bucket_for,
    generate, prefill_buckets, prefill_chunk_default,
)
from .kv_migration import KVBundle
from .prefix_cache import PrefixCache
from .router import FileHost, FilePrefillHost, LocalHost, PrefillHost, Router
from ..jit.decode_step import (SpecDecodeState, SpeculativeDecodeStep,
                               spec_k_default)
from ..jit.save_load import load_quantized, save_quantized

__all__ = ["sampling", "paged_kv", "prefix_cache", "kv_migration", "router",
           "TransformerLM", "AdapterSet", "PrefixCache", "KVBundle",
           "GenerationConfig", "generate", "Request", "GeneratedResult",
           "InferenceEngine", "prefill_buckets", "bucket_for",
           "prefill_chunk_default", "Router", "LocalHost", "FileHost",
           "PrefillHost", "FilePrefillHost",
           "SpeculativeDecodeStep", "SpecDecodeState", "spec_k_default",
           "save_quantized", "load_quantized"]
