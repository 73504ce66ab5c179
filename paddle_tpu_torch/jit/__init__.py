"""paddle.jit of the port (counterpart of ``paddle_tpu/jit``): program
capture (``to_static``, ``declarative``, ``InputSpec``, the AST
conversion), ``functional_call``, ``recompute``, ``save`` / ``load`` and
the quantized checkpoints; the steps of serving (decode, prefill, the
migrated-KV insert, the speculative round) and training; and the control
flow (``cond``, ``case``, ``switch_case``, ``while_loop``, ``scan``)."""
from . import control_flow
from .control_flow import case, cond, scan, switch_case, while_loop
from .decode_step import (
    NO_BUDGET, DecodeState, DecodeStep, MigrateInsert, PrefillStep,
    SpecDecodeState, SpeculativeDecodeStep, spec_k_default,
)
from .functional_call import functional_call, named_state, raw_state
from .program import InputSpec, StaticFunction, declarative, to_static
from .recompute import recompute
from .save_load import (TranslatedLayer, load, load_quantized, save,
                        save_quantized)
from .train_step import TrainStep

__all__ = ["NO_BUDGET", "DecodeState", "DecodeStep", "PrefillStep",
           "MigrateInsert",
           "SpecDecodeState", "SpeculativeDecodeStep", "spec_k_default",
           "save_quantized", "load_quantized", "TrainStep", "control_flow",
           "case", "cond", "scan", "switch_case", "while_loop",
           "functional_call", "named_state", "raw_state", "InputSpec",
           "StaticFunction", "declarative", "to_static", "recompute",
           "TranslatedLayer", "load", "save", "not_to_static"]


def not_to_static(fn):
    """Leave ``fn`` out of the dygraph-to-static AST conversion
    (reference: dygraph_to_static convert_call's not-to-static registry):
    the marked function runs as plain Python inside ``to_static``
    programs; tensor control flow in it is NOT rewritten."""
    raw = getattr(fn, "__func__", fn)
    try:
        raw.__ptu_not_to_static__ = True
    except (AttributeError, TypeError):
        pass  # builtins can't carry the mark; they are never converted
    return fn
