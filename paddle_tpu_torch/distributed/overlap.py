"""The per-gradient dcn hop of a hierarchical data-parallel step
(counterpart of ``paddle_tpu/distributed/overlap.py``: its async dcn-hop
gradient reduction, ``dcn_value_and_grad`` at lines 254-352).

The JAX package runs the step's ``value_and_grad`` inside a ``shard_map``
manual over ``dcn``, so that each gradient's inter-node mean sits at the
gradient's own place in the backward dataflow and can start behind the
backward of the layers still to go. The port's ranks are processes, and
the same schedule is a hook: :class:`DcnGradHop` registers, for the
extent of the step's backward pass, a post-accumulate hook on each
parameter, and the hook, the moment a gradient is complete, averages it
over the ``ici`` group at full width and issues its ``dcn`` reduction
without waiting (an async work handle): a full-width mean, or, under
the quantized policy, ``quantized_comm.quantized_allreduce``, which
quantizes the ici mean, the value each dcn group contributes. After the
backward pass :meth:`DcnGradHop.wait` completes every handle, before the
clip. The gradient then equals the global mean (full width), or the mean
over dcn of each group's block-quantized mean (the quantized policy), as
the JAX package's is.

As there, the step's loss is the dcn mean of the groups' losses, which is
the global mean when the loss is a fixed-divisor batch mean; models with
buffers (batch statistics) raise. Each rank draws its own dropout masks
(``core.random``'s ``dropout`` stream per dp x sp index), so each dcn
group draws its own, as the JAX package's ``fold_in(key, dcn_index)``
gives. :func:`in_manual_dcn` is True while a step's backward runs under
the hop: ``parallel.DataParallel`` then leaves the gradients to it.

Not ported yet (ROADMAP queue A item 7, part 5): the tensor-parallel
overlap rings (``row_parallel_overlap``, ``column_gather_overlap``) that
``PADDLE_TP_OVERLAP`` turns on. ``meta_parallel``'s row- and
column-parallel layers ask :func:`tp_overlap_enabled` at each forward, as
the JAX package's do, and it raises when the variable is set on.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Sequence

import torch

from . import collective

__all__ = ["tp_overlap_enabled", "in_manual_dcn", "manual_dcn",
           "DcnGradHop"]


def tp_overlap_enabled() -> bool:
    """``PADDLE_TP_OVERLAP``: off is False; on raises, naming the item
    that ports the overlap rings."""
    v = os.environ.get("PADDLE_TP_OVERLAP", "0").strip().lower()
    if v in ("", "0", "false", "off"):
        return False
    raise NotImplementedError(
        f"PADDLE_TP_OVERLAP={v!r}: the tensor-parallel overlap rings "
        "(row_parallel_overlap, column_gather_overlap) are not ported yet: "
        "ROADMAP queue A item 7, part 5; unset it")


_MANUAL_DCN = [False]


def in_manual_dcn() -> bool:
    """True while a step's backward runs under the per-gradient dcn
    hop."""
    return _MANUAL_DCN[0]


@contextlib.contextmanager
def manual_dcn():
    """Mark the extent of a backward pass that reduces under the dcn
    hop."""
    prev, _MANUAL_DCN[0] = _MANUAL_DCN[0], True
    try:
        yield
    finally:
        _MANUAL_DCN[0] = prev


class DcnGradHop:
    """The per-gradient hierarchical reduction of ``params``' gradients
    over a mesh with ``dcn`` and ``ici`` axes (the module's notes).
    ``quant`` is a resolved ``(dtype, block)`` pair for the quantized
    dcn hop, or None for a full-width mean. The hooks are on the
    parameters only inside :meth:`backward` (a backward pass outside it
    reduces nothing), which also marks :func:`manual_dcn`, so that a
    ``DataParallel`` wrapper leaves that pass's gradients to the hop."""

    def __init__(self, params: Sequence[torch.Tensor], mesh, quant=None):
        if "dcn" not in mesh.shape or int(mesh.shape["dcn"]) <= 1:
            raise ValueError(
                "the explicit dcn grad reduction (async_dcn_allreduce / "
                "hierarchical quantized_allreduce) needs a hybrid mesh with "
                "a dcn axis (> 1) — fleet.init with hierarchical_allreduce "
                "and a dp_degree that factors must run first")
        self.quant = quant
        self._params = [p for p in params if p.requires_grad]
        self._inner = [mesh.group("ici")]
        if mesh.shape["sp"] > 1:
            self._inner.append(mesh.group("sp"))
        self._dcn = mesh.group("dcn")
        self._pending: List = []

    @contextlib.contextmanager
    def backward(self):
        """The extent of one backward pass whose gradients the hop
        reduces: each completed gradient's ici mean and issued dcn
        reduction; :meth:`wait` completes them."""
        self._pending.clear()
        handles = [p.register_post_accumulate_grad_hook(self._on_grad)
                   for p in self._params]
        try:
            with manual_dcn():
                yield
        finally:
            for h in handles:
                h.remove()

    @torch.no_grad()
    def _on_grad(self, p) -> None:
        g = p.grad
        for h in self._inner:
            collective.all_reduce_(g, collective.ReduceOp.AVG, h)
        if self.quant is None:
            work = collective.all_reduce_async_(g, collective.ReduceOp.AVG,
                                                self._dcn)
        else:
            from . import quantized_comm as qc

            work = qc.quantized_allreduce(g, self._dcn, dtype=self.quant[0],
                                          block=self.quant[1], async_op=True)
        self._pending.append((p, work))

    @torch.no_grad()
    def wait(self) -> int:
        """Complete every issued dcn reduction and write the results into
        the gradients; returns how many there were."""
        n = len(self._pending)
        for p, work in self._pending:
            out = work.wait()
            if out is not p.grad:
                p.grad.copy_(out)
        self._pending.clear()
        return n
