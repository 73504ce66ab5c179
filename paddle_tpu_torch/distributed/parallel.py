"""Data-parallel training across trainers (counterpart of
``paddle_tpu/distributed/parallel.py`` and of ``ParallelEnv`` /
``init_parallel_env`` in ``paddle_tpu/distributed/comm.py``).

Reference: python/paddle/fluid/dygraph/parallel.py:322 (``DataParallel``)
and the C++ Reducer (paddle/fluid/imperative/reducer.cc:374-718):
bucketed gradient all-reduce hooks.

Each rank is a process holding a full copy of the replicated parameters
and its own slice of the global batch (:func:`shard_batch`,
``DataParallel.shard_input``). ``DataParallel`` broadcasts the wrapped
layer's parameters and buffers from the group's first rank, then averages
the gradients over the group at the end of every backward pass
(:func:`reduce_gradients`): in buckets of ``comm_buffer_size_MB``, each
flattened into one buffer and all-reduced through the group's process
group, so every reduction is one counted collective of
``collective.py``. The average of the ranks' gradients of their local mean
losses is the gradient of the global mean loss, so ``scale_loss`` is the
identity, as in the JAX package. Inside ``no_sync()`` gradients accumulate
locally. A parameter with no gradient on a rank enters its bucket as zeros
and keeps no gradient there; ranks are expected to leave the same
parameters unused (``find_unused_parameters`` is taken and changes
nothing). At a dp degree of one, nothing is communicated.

On a hierarchical mesh (``init_hybrid_mesh(dp_inner=k)``, the
``hierarchical_allreduce`` strategy) the reduction over the data group
takes two hops at full width: an all-reduce AVG over the fast inner
``ici`` group (and ``sp``, when the sequence is split), then one over the
slow ``dcn`` group. The mean of the ici means over dcn is the mean over
the whole group. Where ``TrainStep`` makes the dcn hop explicit
(``async_dcn_allreduce``, or a quantized policy on a hierarchical mesh),
its ``overlap.DcnGradHop`` reduces each gradient in the backward pass,
under ``overlap.manual_dcn``, and ``DataParallel`` leaves that pass's
gradients to it.

Under ZeRO stage 2 or 3 (``fleet``'s ``sharding``) the parameters that
ZeRO shards carry ``_zero_shard``: their gradients are reduce-scattered,
in the hook and in :func:`reduce_gradients` alike, and each rank keeps
its shard of the mean gradient only (``_zero_shard.grad``).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.tensor import Tensor, to_tensor
from ..nn.layer import Layer
from . import collective, comm, overlap
from .comm import ParallelEnv, init_parallel_env

__all__ = ["DataParallel", "ParallelEnv", "init_parallel_env",
           "shard_batch", "shard_tokens", "reduce_gradients",
           "all_reduce_sum"]


def shard_batch(x, mesh=None, axis_name: str = "dp", group=None) -> Tensor:
    """This rank's slice of the global batch ``x`` along dim 0 (the dp
    group's share: rows ``[r * B / n, (r + 1) * B / n)``), a ``Tensor`` on
    the rank's device. ``B`` must divide by the group's size."""
    g = group or comm.dp_group() or comm._default_group()
    raw = x._data if isinstance(x, Tensor) else x
    n, r = g.nranks, max(g.rank, 0)
    B = int(raw.shape[0])
    if B % n:
        raise ValueError(f"shard_batch: batch {B} does not split over {n} "
                         "data-parallel ranks")
    part = raw[r * B // n:(r + 1) * B // n]
    if isinstance(part, torch.Tensor):
        return Tensor._wrap(part.to(comm._state.device or part.device))
    return to_tensor(np.ascontiguousarray(part), place=comm._state.device)


def shard_tokens(x, mesh=None) -> Tensor:
    """This rank's part of a global ``[B, S, ...]`` batch on a mesh with
    sequence parallelism: rows ``[d * B / dp, (d + 1) * B / dp)`` of its dp
    index ``d`` and positions ``[s * S / sp, (s + 1) * S / sp)`` of its sp
    index ``s``, a ``Tensor`` on the rank's device."""
    mesh = mesh or comm.hybrid_mesh()
    raw = x._data if isinstance(x, Tensor) else x
    B, S = int(raw.shape[0]), int(raw.shape[1])
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if B % dp or S % sp:
        raise ValueError(f"shard_tokens: [{B}, {S}] does not split over "
                         f"dp={dp} x sp={sp}")
    d, s = mesh.axis_rank("dp"), mesh.axis_rank("sp")
    part = raw[d * B // dp:(d + 1) * B // dp, s * S // sp:(s + 1) * S // sp]
    if isinstance(part, torch.Tensor):
        return Tensor._wrap(part.to(comm._state.device or part.device))
    return to_tensor(np.ascontiguousarray(part), place=comm._state.device)


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group's ranks; its gradient is the sum of the ranks'
    gradients (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective.all_reduce_(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return collective.all_reduce_(g.contiguous().clone(),
                                      group=ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce (SUM) of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


def _buckets(params: Sequence[torch.Tensor], nbytes: int
             ) -> List[List[torch.Tensor]]:
    """Consecutive parameters, in reverse order (the order backward makes
    their gradients), grouped by dtype and device up to ``nbytes``."""
    out, cur, size = [], [], 0
    for p in reversed(list(params)):
        b = p.numel() * p.element_size()
        if cur and (size + b > nbytes or p.dtype != cur[0].dtype
                    or p.device != cur[0].device):
            out.append(cur)
            cur, size = [], 0
        cur.append(p)
        size += b
    if cur:
        out.append(cur)
    return out


def _hops(group) -> list:
    """The groups a gradient reduction over ``group`` averages over, in
    order: on a hierarchical mesh's data group, the ici group (and the sp
    group when sp is above 1), then the dcn group; else ``[group]``."""
    mesh = comm.hybrid_mesh()
    if mesh is None or "dcn" not in mesh.shape \
            or group is not mesh.group("data"):
        return [group]
    return [mesh.group("ici")] + \
        ([mesh.group("sp")] if mesh.shape["sp"] > 1 else []) + \
        [mesh.group("dcn")]


def _scatter_hops(group, zs) -> tuple:
    """How a gradient reduction over ``group`` reduce-scatters onto the
    ZeRO shards of ``zs`` (``fleet``'s shard of a parameter): ``(groups
    all-reduced first, groups reduce-scattered in order)``, or None when
    ``group`` is not the data group ZeRO shards over. On a hierarchical
    mesh the scatter takes the dcn hop, then the ici hop (rank ``c *
    ici + i`` of dp ends with row ``c * ici + i``); the sp group, when sp
    is above 1, is averaged over first (ZeRO shards over dp only)."""
    mesh = comm.hybrid_mesh()
    if mesh is None:
        return ((), (group,)) if group is zs.group else None
    if group is not mesh.group("data") and group is not mesh.group("dp"):
        return None
    pre = (mesh.group("sp"),) if group is mesh.group("data") \
        and mesh.shape["sp"] > 1 else ()
    if "dcn" in mesh.shape:
        return pre, (mesh.group("dcn"), mesh.group("ici"))
    return pre, (mesh.group("dp"),)


def _scatters(p, group) -> bool:
    zs = getattr(p, "_zero_shard", None)
    return zs is not None and zs.scatter and \
        _scatter_hops(group, zs) is not None


@torch.no_grad()
def _reduce_scatter_bucket(bucket, group) -> None:
    """One bucket of ZeRO parameters (stage 2 and 3): each gradient padded
    and laid out as ``[dp, shard]`` rows, the rows of the bucket joined,
    one reduce-scatter (AVG) a hop; each parameter's shard of the mean
    gradient lands in ``p._zero_shard.grad`` and ``p.grad`` is freed."""
    pre, hops = _scatter_hops(group, bucket[0]._zero_shard)
    rows = torch.cat([p._zero_shard.rows(
        p.grad if p.grad is not None else torch.zeros_like(p))
        for p in bucket], dim=1)
    for h in pre:
        collective.all_reduce_(rows, collective.ReduceOp.AVG, h)
    for h in hops:
        rows = collective.reduce_scatter_(
            rows.view(h.nranks, -1), collective.ReduceOp.AVG, h)
    off = 0
    for p in bucket:
        zs = p._zero_shard
        k = zs.numel
        if p.grad is not None:
            zs.grad = rows[off:off + k].view(zs.shard_shape)
            p.grad = None
        off += k


@torch.no_grad()
def reduce_gradients(params: Sequence[torch.Tensor], group=None,
                     bucket_mb: float = 25) -> None:
    """Average ``params``' gradients over ``group`` (the dp group by
    default) in place, one all-reduce per bucket of ``bucket_mb`` and
    hop (:func:`_hops`). A parameter that ZeRO stage 2 or 3 shards
    (``p._zero_shard``, ``fleet``) is reduce-scattered instead, in buckets
    of its own: this rank keeps only its shard of the mean gradient
    (:func:`_reduce_scatter_bucket`)."""
    g = group or comm.dp_group()
    if g is None or g.nranks <= 1:
        return
    params = [p for p in params if p.requires_grad]
    scattered = [p for p in params if _scatters(p, g)]
    if scattered:
        ids = {id(p) for p in scattered}
        params = [p for p in params if id(p) not in ids]
        for bucket in _buckets(scattered, int(bucket_mb * 2 ** 20)):
            _reduce_scatter_bucket(bucket, g)
    hops = _hops(g)
    for bucket in _buckets(params, int(bucket_mb * 2 ** 20)):
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in bucket])
        for h in hops:
            collective.all_reduce_(flat, collective.ReduceOp.AVG, h)
        off = 0
        for p in bucket:
            n = p.numel()
            if p.grad is not None:
                p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n


class DataParallel(Layer):
    """Wrap a Layer for data-parallel training (parallel.py:322 parity)::

        dist.init_parallel_env()
        model = paddle.DataParallel(model)
        out = model(model.shard_input(global_batch))

    ``group`` defaults to the hybrid mesh's dp group, else the world."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size_MB=25,
                 last_comm_buffer_size_MB=1, find_unused_parameters=False,
                 group: Optional[comm.Group] = None):
        super().__init__()
        self._layers = layers
        comm._ensure_init()
        self.group = group or comm.dp_group()
        self._bucket_mb = float(comm_buffer_size_MB)
        self._sync = True
        self._queued = False
        if self.group.nranks > 1:
            self.sync_params_buffers()
            for p in layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._on_grad)

    @torch.no_grad()
    def sync_params_buffers(self) -> None:
        """Every rank takes the group's first rank's parameters and buffers
        (reference: parallel.py sync_params_buffers)."""
        for t in list(self._layers.parameters()) + \
                list(self._layers.buffers()):
            collective.broadcast(t.data, 0, self.group)

    def _on_grad(self, _p) -> None:
        # the first gradient of a backward pass queues the reduction at
        # its end, when every gradient of the pass is accumulated; a pass
        # under the explicit dcn hop is the hop's to reduce
        if self._sync and not self._queued and not overlap.in_manual_dcn():
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._reduce)

    def _reduce(self) -> None:
        self._queued = False
        reduce_gradients(list(self._layers.parameters()), self.group,
                         self._bucket_mb)

    def shard_input(self, x) -> Tensor:
        """This rank's slice of the global batch ``x`` (dim 0); over a
        mesh's dp x sp group, its rows and its sequence positions (dim 1,
        :func:`shard_tokens`)."""
        mesh = comm.hybrid_mesh()
        if mesh is not None and mesh.shape["sp"] > 1 \
                and self.group is mesh.group("data"):
            return shard_tokens(x, mesh)
        return shard_batch(x, group=self.group)

    def scale_loss(self, loss):
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients of backward passes inside accumulate locally."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    # state passthrough: checkpoints are of the wrapped model
    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, use_structured_name=True):
        return self._layers.set_state_dict(state_dict, use_structured_name)

    set_dict = set_state_dict
    load_dict = set_state_dict


def _forward(self, *inputs, **kwargs):
    return self._layers(*inputs, **kwargs)


# bound after the class body, so the wrapped layer gets its inputs as the
# caller passed them (a forward defined in the class would convert them at
# the package's tensor boundary)
DataParallel.forward = _forward
