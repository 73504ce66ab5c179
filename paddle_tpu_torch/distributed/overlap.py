"""Comm/compute overlap on the multi-rank hot path (counterpart of
``paddle_tpu/distributed/overlap.py``): the tensor-parallel overlap rings
(its lines 103-250) and the per-gradient dcn hop of a hierarchical
data-parallel step (``dcn_value_and_grad``, its lines 254-352).

**The rings** (``PADDLE_TP_OVERLAP`` on: :func:`tp_overlap_enabled`).
``meta_parallel``'s ``RowParallelLinear`` and gathering
``ColumnParallelLinear`` ask :func:`row_overlap_plan` at each forward and
take the ring where it allows it (mp above 1, sp 1, this rank's rows split
into mp chunks, no quantized-matmul route), the plain layer otherwise, as
the JAX package's do. :func:`row_parallel_overlap` decomposes the
row-parallel product's all-reduce into a reduce-scatter ring over row
chunks (at step s rank d computes its partial of chunk ``(d - s) mod
mp``, adds the accumulator its ring neighbour sent and passes it on;
after mp - 1 shifts rank d holds chunk ``(d + 1) mod mp`` in full) and
one gather of the chunks. :func:`column_gather_overlap` computes the
column-parallel product a row chunk at a time, each chunk's all-gather
behind its matmul. Each shift is one ``all_to_all_single``
(``collective.shift_``, as every shift of the port); each ring
is built from autograd Functions (:class:`_RingShift`, whose backward
shifts the other way, and :class:`_GatherRows`, whose backward keeps this
rank's row, Megatron's rule for a replicated output), so its gradients
are those of the plain layers. The matmul chunks are ``torch.matmul``
(under AMP, on the white list's type), as the JAX package computes them
outside any Pallas kernel. The collectives are issued in the ring's order
and complete before the next chunk's matmul: the order is the JAX
package's, and the overlap itself is the compiler's there (on one card
over gloo the port measures none).

**The dcn hop.** The JAX package runs the step's ``value_and_grad``
inside a ``shard_map`` manual over ``dcn``, so that each gradient's
inter-node mean sits at the gradient's own place in the backward
dataflow and can start behind the backward of the layers still to go.
The port's ranks are processes, and the same schedule is a hook:
:class:`DcnGradHop` registers, for the extent of the step's backward
pass, a post-accumulate hook on each parameter, and the hook, the moment
a gradient is complete, averages it over the ``ici`` group at full width
and issues its ``dcn`` reduction without waiting (an async work handle):
a full-width mean, or, under the quantized policy,
``quantized_comm.quantized_allreduce``, which quantizes the ici mean, the
value each dcn group contributes. After the backward pass
:meth:`DcnGradHop.wait` completes every handle, before the clip. The
gradient then equals the global mean (full width), or the mean over dcn
of each group's block-quantized mean (the quantized policy), as the JAX
package's is.

As there, the step's loss is the dcn mean of the groups' losses, which is
the global mean when the loss is a fixed-divisor batch mean; models with
buffers (batch statistics) raise. Each rank draws its own dropout masks
(``core.random``'s ``dropout`` stream per dp x sp index), so each dcn
group draws its own, as the JAX package's ``fold_in(key, dcn_index)``
gives. :func:`in_manual_dcn` is True while a step's backward runs under
the hop: ``parallel.DataParallel`` then leaves the gradients to it, and
:func:`row_overlap_plan` declines.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Sequence

import torch

from . import collective

__all__ = ["tp_overlap_enabled", "in_manual_dcn", "manual_dcn",
           "row_overlap_plan", "row_parallel_overlap",
           "column_gather_overlap", "DcnGradHop"]


def tp_overlap_enabled() -> bool:
    """``PADDLE_TP_OVERLAP``: anything but unset, "", "0", "false" or
    "off" routes the tensor-parallel layers through the rings."""
    v = os.environ.get("PADDLE_TP_OVERLAP", "0").strip().lower()
    return v not in ("", "0", "false", "off")


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


# ---------------------------------------------------------------------------
# the tensor-parallel overlap rings
# ---------------------------------------------------------------------------


def row_overlap_plan(mesh, rows: int):
    """``(mp, None)`` when the overlapped tensor-parallel matmuls apply to
    ``rows`` of this rank's rows (the JAX package's plan: mp above 1,
    the rows split into mp ring chunks; its row axis is this rank's dp
    share, which the port's rank holds already), else None. Declines on a
    mesh with sp above 1 (sequence-local activations) and under the
    explicit dcn hop."""
    if in_manual_dcn() or mesh is None:
        return None
    mp = int(mesh.shape["mp"])
    if mp <= 1 or int(mesh.shape["sp"]) > 1 or rows % mp:
        return None
    return mp, None


class _RingShift(torch.autograd.Function):
    """``collective.shift_`` over ``group`` (rank i's tensor to rank i +
    1); the backward shifts the gradient back (rank i + 1's to rank i)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective.shift_(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        n = ctx.group.nranks
        return collective.ppermute_(
            g.contiguous(), [(i, (i - 1) % n) for i in range(n)],
            ctx.group), None


class _GatherRows(torch.autograd.Function):
    """Every rank's ``x`` stacked, ``[n, *x.shape]``; the output is
    replicated over the group, so the backward keeps this rank's row."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = group.rank
        return collective.all_gather_(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank].contiguous(), None


def row_parallel_overlap(x, w, b, group):
    """``RowParallelLinear``'s forward through the reduce-scatter ring
    (the module's notes): ``x`` ``[..., in/mp]`` this rank's features,
    ``w`` ``[in/mp, out]`` its rows, ``b`` ``[out]`` or None, added once
    after the reduction. Returns ``[..., out]``, the same on every rank
    of ``group``."""
    from .. import amp

    x, w, b = amp.cast_if_amp("linear", (x, w, b))
    n, d = group.nranks, group.rank
    shape = tuple(x.shape[:-1]) + (int(w.shape[-1]),)
    xr = x.reshape(n, -1, x.shape[-1])
    acc = None
    for s in range(n):
        part = torch.matmul(xr[(d - s) % n], w)
        acc = part if acc is None else acc + part
        if s < n - 1:
            acc = _RingShift.apply(acc, group)
    # rank j holds chunk (j + 1) mod n: one roll puts chunk c at slot c
    out = torch.roll(_GatherRows.apply(acc, group), 1, dims=0)
    out = out.reshape(shape)
    return out if b is None else out + b.to(out.dtype)


def column_gather_overlap(x, w, b, group):
    """A gathering ``ColumnParallelLinear``'s forward, a row chunk at a
    time (the module's notes): ``x`` ``[..., in]`` (replicated over
    ``group``; its gradient is all-reduced over it), ``w`` ``[in,
    out/mp]`` this rank's columns, ``b`` ``[out/mp]`` or None. Returns
    ``[..., out]``, the columns in rank order."""
    from .. import amp
    from .meta_parallel import _CopyToMP

    x = _CopyToMP.apply(x, group)
    x, w, b = amp.cast_if_amp("linear", (x, w, b))
    n = group.nranks
    xr = x.reshape(n, -1, x.shape[-1])
    outs = []
    for c in range(n):
        part = torch.matmul(xr[c], w)
        if b is not None:
            part = part + b
        g = _GatherRows.apply(part, group)       # [n, chunk, out/mp]
        outs.append(g.transpose(0, 1).reshape(g.shape[1], -1))
    return torch.cat(outs).reshape(tuple(x.shape[:-1]) + (-1,))


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
