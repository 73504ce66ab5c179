"""Hand-written CUDA kernels for Hopper, one module per Pallas kernel
source of ``paddle_tpu/ops/pallas``: each kernel is a ``torch.library``
custom op (``torch.ops.paddle_tpu_torch.<name>``, the names of
:data:`WRAPPERS`) that launches its kernel on a CUDA tensor, takes its
plain PyTorch version on a CPU tensor, and counts its launches in
``<wrapper>.launches`` (and by input types in ``<wrapper>.by_dtype``);
importing the package registers them."""
from . import flash_attention, layer_norm

#: every kernel wrapper of the port, by the name the chip run reports
WRAPPERS = {
    "flash_attention_fwd": flash_attention.flash_attention_fwd,
    "flash_attention_bwd_dq": flash_attention.flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention.flash_attention_bwd_dkv,
    "layer_norm_fwd": layer_norm.layer_norm_fwd,
    "add_layer_norm_fwd": layer_norm.add_layer_norm_fwd,
    "layer_norm_bwd": layer_norm.layer_norm_bwd,
}

#: the CUDA sources, by library name (csrc/<name>.cu)
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "layer_norm")


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0
        w.by_dtype = {}


def launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def launches_by_dtype() -> dict:
    """Each wrapper's launches by the types of its inputs."""
    return {name: dict(w.by_dtype) for name, w in WRAPPERS.items()}
