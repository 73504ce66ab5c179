"""The collectives (counterpart of ``paddle_tpu/distributed/collective.py``).

Reference: python/paddle/distributed/collective.py:101-457 (all_reduce,
all_gather, reduce, broadcast, scatter, barrier over NCCL rings).

**A rank is a process** (see ``comm.py``): each rank passes its own
tensor, and what rank ``r`` holds before and after a call is row ``r`` of the
JAX package's rank-stacked operand and result. ``all_reduce``, ``reduce``,
``broadcast`` and ``scatter`` write their result into the caller's tensor
(a ``Tensor`` is rebound to it, as the JAX package's ``_write_back`` does; a
``torch.Tensor`` is written in place); ``reduce_scatter`` writes into its
first argument; ``all_gather`` and ``alltoall`` return lists and extend the
one passed. ``src`` and ``dst`` are ranks within the group. ``sync_op``
is taken and the call always completes before it returns.

Each call runs on the group's ``torch.distributed`` process group, whose
backend the rule of ``comm.py`` named (``nccl``, or ``gloo`` for ranks that
share a card or run on the CPU), and goes through the comm monitor
(``comm_monitor.py``: flight recorder, the ``PADDLE_COLL_TIMEOUT`` watchdog,
the ``coll`` fault site), which counts it by (op, backend, transport,
bytes). The transports: ``nccl``; ``gloo-cuda``, where gloo takes the CUDA
tensors itself and moves them through host memory inside its own
algorithms (PyTorch 2.11's gloo takes CUDA tensors for every op used here:
``alltoall`` goes as ``all_to_all_single``, since gloo has no list form);
``gloo-cpu`` for CPU tensors; ``local`` for a group of one rank. Operands
and results stay on the rank's device: a transport moves bytes and never
computes on the host in the device's place.

Sequence and pipeline parallelism add the torch-level ``ppermute_`` (and
its ring ``shift_``), ``send_recv_`` between two ranks of a group, and
``all_to_all_tiled_`` (``jax.lax.all_to_all(..., tiled=True)``): each is
one ``all_to_all_single`` whose splits route the bytes, which every rank
of the group enters.

``ReduceOp.AVG`` is a SUM and a division by the group's size on the
device (gloo has no AVG of integers); ``reduce_scatter`` splits dim 0 of
its input into ``nranks`` equal parts.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..core.tensor import Tensor
from . import comm
from . import comm_monitor as _cm
from .comm import Group

__all__ = ["ReduceOp", "all_reduce", "reduce", "all_gather", "broadcast",
           "reduce_scatter", "scatter", "alltoall", "barrier", "wait",
           "monitored_barrier", "transport", "all_reduce_", "all_gather_",
           "ppermute_", "shift_", "send_recv_", "all_to_all_tiled_",
           "all_reduce_async_", "all_gather_async_", "reduce_scatter_"]


class ReduceOp:
    """reference: collective.py ReduceOp (SUM/MAX/MIN/PROD + AVG)."""

    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}


def _group(group) -> Group:
    if group is None:
        return comm._default_group()
    if isinstance(group, int):
        g = comm.get_group(group)
        if g is None:
            raise ValueError(f"no group with id {group}")
        return g
    return group


def transport(g: Group, t: torch.Tensor) -> str:
    """How a collective of ``g`` moves ``t``: ``local``, ``nccl``,
    ``gloo-cuda`` or ``gloo-cpu``."""
    if g.pg is None:
        return "local"
    if g.backend == "nccl":
        if not t.is_cuda:
            raise ValueError("nccl takes CUDA tensors only")
        return "nccl"
    return "gloo-cuda" if t.is_cuda else "gloo-cpu"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _watch(op: str, g: Group, t: torch.Tensor, nbytes: int, **kw):
    return _cm.monitor().watch(
        op, g.id, g.axis_name, g.nranks, shape=tuple(t.shape),
        dtype=str(t.dtype).replace("torch.", ""), backend=g.backend,
        transport=transport(g, t), nbytes=nbytes, **kw)


def _avg(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.is_floating_point() or t.is_complex():
        return t.div_(n)
    return t.copy_(torch.div(t, n, rounding_mode="trunc"))


def _global(g: Group, r: int) -> int:
    return g.ranks[int(r)]


# ---------------------------------------------------------------------------
# in-place torch-level forms: the ones the port's own layers call
# ---------------------------------------------------------------------------


def all_reduce_(t: torch.Tensor, op: int = ReduceOp.SUM,
                group: Optional[Group] = None) -> torch.Tensor:
    """All-reduce the contiguous ``t`` in place over ``group``."""
    g = _group(group)
    with _watch("all_reduce", g, t, _nbytes(t)):
        if g.pg is not None:
            dist.all_reduce(t, op=_TORCH_OP[op], group=g.pg)
        if op == ReduceOp.AVG:
            _avg(t, g.nranks)
    return t


def all_gather_(t: torch.Tensor, group: Optional[Group] = None
                ) -> torch.Tensor:
    """Every rank's ``t`` stacked along a new leading axis, ``[nranks,
    *t.shape]``."""
    g = _group(group)
    t = t.contiguous()
    # gloo gathers into one flat buffer, rank-major
    out = torch.empty(g.nranks * t.numel(), dtype=t.dtype, device=t.device)
    with _watch("all_gather", g, t, _nbytes(out)):
        if g.pg is None:
            out.copy_(t.reshape(-1))
        else:
            dist.all_gather_into_tensor(out, t.reshape(-1), group=g.pg)
    return out.view((g.nranks,) + tuple(t.shape))


def reduce_scatter_(t: torch.Tensor, op: int = ReduceOp.SUM,
                    group: Optional[Group] = None) -> torch.Tensor:
    """Rank ``r`` of ``group`` gets row ``r`` of the reduction of the
    contiguous ``t`` (``[nranks, ...]``, one row a rank): a new tensor of
    ``t.shape[1:]``. SUM or AVG."""
    g = _group(group)
    t = t.contiguous()
    out = torch.empty(tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    with _watch("reduce_scatter", g, t, _nbytes(t)):
        if g.pg is None:
            out.copy_(t[0])
        else:
            dist.reduce_scatter_tensor(out.view(-1), t.view(-1),
                                       op=_TORCH_OP[op], group=g.pg)
        if op == ReduceOp.AVG:
            _avg(out, g.nranks)
    return out


class _Pending:
    """An issued asynchronous collective: :meth:`wait` completes it (the
    process group's work, then ``finish`` on the result) and adds the
    wait's host time to the comm monitor's row of the call, which was
    counted, with its bytes, when it was issued."""

    def __init__(self, work, result, finish, row):
        self._work, self._result, self._finish = work, result, finish
        self._row = row

    def wait(self) -> torch.Tensor:
        import time

        t0 = time.perf_counter()
        if self._work is not None:
            self._work.wait()
        out = self._finish(self._result) if self._finish else self._result
        op, backend, tr, axis = self._row
        _cm.monitor().count(op, backend, tr, 0, time.perf_counter() - t0,
                            calls=0, group=axis)
        return out


def all_reduce_async_(t: torch.Tensor, op: int = ReduceOp.SUM,
                      group: Optional[Group] = None) -> _Pending:
    """:func:`all_reduce_` issued without waiting: returns a handle whose
    ``wait()`` completes it and returns ``t`` (reduced in place)."""
    g = _group(group)
    with _watch("all_reduce", g, t, _nbytes(t)):
        work = None if g.pg is None else dist.all_reduce(
            t, op=_TORCH_OP[op], group=g.pg, async_op=True)
    finish = (lambda r: _avg(r, g.nranks)) if op == ReduceOp.AVG else None
    return _Pending(work, t, finish, _row("all_reduce", g, t))


def all_gather_async_(t: torch.Tensor, group: Optional[Group] = None, *,
                      op: str = "all_gather"):
    """Every rank's flat ``t`` gathered rank-major into one buffer,
    issued without waiting: returns ``(buffer, work)``, the buffer valid
    after ``work.wait()`` (``work`` None for a group of one). Counted
    under ``op`` with the bytes of ``t``: what this rank hands the
    transport."""
    g = _group(group)
    t = t.contiguous().reshape(-1)
    out = torch.empty(g.nranks * t.numel(), dtype=t.dtype, device=t.device)
    with _watch(op, g, t, _nbytes(t)):
        if g.pg is None:
            out.copy_(t)
            return out, None
        work = dist.all_gather_into_tensor(out, t, group=g.pg,
                                           async_op=True)
    return out, _Pending(work, out, None, _row(op, g, t))


def _row(op: str, g: Group, t: torch.Tensor):
    return (op, g.backend, transport(g, t), g.axis_name)


def _exchange(send: torch.Tensor, recv: torch.Tensor, dst: int, src: int,
              g: Group) -> None:
    """Rank ``dst`` of ``g`` gets ``send`` and this rank fills ``recv``
    from rank ``src`` (-1: nothing to send or to receive): one
    ``all_to_all_single`` whose splits are 0 but for those two ranks. Every
    rank of the group calls it; ``send`` and ``recv`` are flat and
    contiguous, of the pair's one type. gloo takes it on CUDA tensors too
    (its send and recv do not stage a CUDA tensor through host memory),
    NCCL and gloo on the CPU alike, so the shift has one route."""
    n = g.nranks
    ins = [0] * n
    outs = [0] * n
    if dst >= 0:
        ins[dst] = send.numel()
    if src >= 0:
        outs[src] = recv.numel()
    dist.all_to_all_single(recv, send, outs, ins, group=g.pg)


def ppermute_(t: torch.Tensor, perm, group: Optional[Group] = None
              ) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` lists ``(src, dst)`` pairs of group
    ranks, each rank the source of one pair at most and the destination of
    one at most; every rank of the group calls it with its own ``t`` (all
    of one shape and type) and gets what its source sent, or zeros when it
    is nobody's destination. Counted as op ``ppermute``."""
    g = _group(group)
    me = g.rank
    dst = next((int(d) for s, d in perm if int(s) == me), -1)
    src = next((int(s) for s, d in perm if int(d) == me), -1)
    t = t.contiguous()
    out = torch.zeros_like(t)
    with _watch("ppermute", g, t, _nbytes(t) if dst >= 0 else 0):
        if g.pg is None:
            if src == me:
                out.copy_(t)
        else:
            empty = t.new_empty(0)
            _exchange(t.reshape(-1) if dst >= 0 else empty,
                      out.view(-1) if src >= 0 else empty, dst, src, g)
    return out


def shift_(t: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """The ring shift: rank ``i``'s ``t`` goes to rank ``(i + 1) % n`` of
    the group; returns what rank ``(i - 1) % n`` sent (``ppermute`` over
    ``[(i, (i + 1) % n)]``)."""
    g = _group(group)
    n = g.nranks
    return ppermute_(t, [(i, (i + 1) % n) for i in range(n)], g)


def send_recv_(send: Optional[torch.Tensor], dst: int, recv_like,
               src: int, group: Optional[Group] = None
               ) -> Optional[torch.Tensor]:
    """One point-to-point transfer inside ``group``, which every rank of
    it enters: this rank sends ``send`` to group rank ``dst`` (None, -1:
    it sends nothing) and receives from group rank ``src`` a tensor shaped
    like ``recv_like`` (a tensor or ``(shape, dtype, device)``; None, -1:
    it receives nothing). The sender's and receiver's types agree. Counted
    as op ``send_recv``. Returns the received tensor (None)."""
    g = _group(group)
    recv = None
    if src >= 0:
        shape, dtype, dev = (tuple(recv_like.shape), recv_like.dtype,
                             recv_like.device) \
            if isinstance(recv_like, torch.Tensor) else recv_like
        recv = torch.empty(shape, dtype=dtype, device=dev)
    probe = send if send is not None else recv
    if probe is None:  # a rank of the group outside this transfer
        probe = torch.empty(0, device=comm._state.device or "cpu")
    if send is not None:
        send = send.contiguous()
    with _watch("send_recv", g, probe,
                _nbytes(send) if send is not None else 0):
        if g.pg is None:
            if src >= 0:
                recv.copy_(send)
        else:
            empty = probe.new_empty(0)
            _exchange(send.reshape(-1) if send is not None else empty,
                      recv.view(-1) if recv is not None else empty,
                      dst, src, g)
    return recv


def all_to_all_tiled_(x: torch.Tensor, split_axis: int, concat_axis: int,
                      group: Optional[Group] = None) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)``: ``x`` is cut into ``n`` equal parts along
    ``split_axis``, part ``j`` goes to group rank ``j``, and the parts
    received are joined along ``concat_axis`` in rank order. Counted as
    op ``all_to_all``."""
    g = _group(group)
    n = g.nranks
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of "
                         f"{tuple(x.shape)} does not split into {n} parts")
    inp = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(inp)
    with _watch("all_to_all", g, inp, _nbytes(inp)):
        if g.pg is None:
            out.copy_(inp)
        else:
            dist.all_to_all_single(out, inp, group=g.pg)
    return torch.cat(out.unbind(0), dim=concat_axis)


# ---------------------------------------------------------------------------
# the public API (paddle.distributed.*)
# ---------------------------------------------------------------------------


def _raw(x) -> torch.Tensor:
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=comm._state.device)


def _work(x) -> torch.Tensor:
    """A detached contiguous tensor to run the collective on: a copy for a
    ``Tensor`` (rebound afterwards), the caller's own storage for a
    contiguous ``torch.Tensor`` (written in place)."""
    if isinstance(x, Tensor):
        return x._data.detach().clone(memory_format=torch.contiguous_format)
    raw = _raw(x)
    return raw if raw.is_contiguous() else raw.contiguous()


def _write_back(orig, out: torch.Tensor):
    if isinstance(orig, Tensor):
        orig._data = out
        return orig
    if isinstance(orig, torch.Tensor):
        if out is not orig:
            orig.copy_(out)
        return orig
    return Tensor._wrap(out)


def all_reduce(tensor, op: int = ReduceOp.SUM, group=None,
               sync_op: bool = True, use_calc_stream: bool = True):
    """collective.py:101 all_reduce: every rank gets the reduction of all
    ranks' tensors, in place."""
    g = _group(group)
    if not g.is_member:
        return tensor
    return _write_back(tensor, all_reduce_(_work(tensor), op, g))


def reduce(tensor, dst: int = 0, op: int = ReduceOp.SUM, group=None,
           sync_op: bool = True, use_calc_stream: bool = True):
    """collective.py reduce: rank ``dst`` gets the reduction; the others
    keep their tensor."""
    g = _group(group)
    if not g.is_member:
        return tensor
    t = _work(tensor)
    buf = t.clone() if g.rank != int(dst) else t
    with _watch("reduce", g, t, _nbytes(t)):
        if g.pg is not None:
            dist.reduce(buf, _global(g, dst), op=_TORCH_OP[op], group=g.pg)
        if op == ReduceOp.AVG and g.rank == int(dst):
            _avg(buf, g.nranks)
    return _write_back(tensor, t)


def all_gather(tensor_list: Optional[List], tensor=None, group=None,
               sync_op: bool = True, use_calc_stream: bool = True):
    """collective.py all_gather: the list of every rank's tensor, in rank
    order (appended to ``tensor_list``); ``all_gather(x)`` is the
    shorthand."""
    g = _group(group)
    if tensor is None:
        tensor, tensor_list = tensor_list, None
    if not g.is_member:
        return []
    out = all_gather_(_raw(tensor).detach(), g)
    wrap = isinstance(tensor, Tensor) or not isinstance(tensor, torch.Tensor)
    parts = [Tensor._wrap(out[i]) if wrap else out[i]
             for i in range(g.nranks)]
    if tensor_list is not None:
        tensor_list.extend(parts)
    return parts


def broadcast(tensor, src: int = 0, group=None, sync_op: bool = True,
              use_calc_stream: bool = True):
    """collective.py broadcast: every rank gets rank ``src``'s tensor."""
    g = _group(group)
    if not g.is_member:
        return tensor
    t = _work(tensor)
    with _watch("broadcast", g, t, _nbytes(t)):
        if g.pg is not None:
            dist.broadcast(t, _global(g, src), group=g.pg)
    return _write_back(tensor, t)


def reduce_scatter(tensor, tensor_or_tensor_list=None,
                   op: int = ReduceOp.SUM, group=None, sync_op: bool = True):
    """Rank ``r`` gets part ``r`` of the reduction: the input (the second
    argument, or the first when there is none; a list is concatenated) is
    split along dim 0 into ``nranks`` parts. The result goes into
    ``tensor``."""
    g = _group(group)
    if not g.is_member:
        return tensor
    src = tensor if tensor_or_tensor_list is None else tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        inp = torch.cat([_raw(x).detach() for x in src])
    else:
        inp = _raw(src).detach().contiguous()
    if inp.shape[0] % g.nranks:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(inp.shape)} does "
                         f"not split into {g.nranks} parts")
    chunk = inp.shape[0] // g.nranks
    out = torch.empty((chunk,) + tuple(inp.shape[1:]), dtype=inp.dtype,
                      device=inp.device)
    with _watch("reduce_scatter", g, inp, _nbytes(inp)):
        if g.pg is None:
            out.copy_(inp)
        elif op == ReduceOp.PROD:
            # gloo's reduce_scatter has no PRODUCT: the all-reduce, then
            # this rank's part
            full = inp.clone()
            dist.all_reduce(full, op=dist.ReduceOp.PRODUCT, group=g.pg)
            out.copy_(full[g.rank * chunk:(g.rank + 1) * chunk])
        else:
            dist.reduce_scatter_tensor(out, inp, op=_TORCH_OP[op],
                                       group=g.pg)
        if op == ReduceOp.AVG:
            _avg(out, g.nranks)
    if isinstance(tensor, Tensor):
        tensor._data = out
        return tensor
    if isinstance(tensor, torch.Tensor) and tensor.shape == out.shape \
            and tensor is not src:
        return tensor.copy_(out)
    return Tensor._wrap(out)


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op: bool = True, use_calc_stream: bool = True):
    """collective.py scatter: rank ``r`` gets ``tensor_list[r]`` of rank
    ``src`` in ``tensor``, its receive buffer (upstream Paddle's form:
    the other ranks' lists are not read and may be None; the JAX package's
    one rank-stacked array becomes the list on ``src``)."""
    g = _group(group)
    if not g.is_member:
        return tensor
    out = _work(tensor)
    is_src = g.rank == int(src)
    if is_src and tensor_list is None:
        raise ValueError("scatter: the source rank needs tensor_list")
    parts = [_raw(x).detach().contiguous() for x in tensor_list] \
        if is_src else None
    with _watch("scatter", g, out, _nbytes(out) * g.nranks):
        if g.pg is None:
            out.copy_(parts[0])
        else:
            dist.scatter(out, parts, src=_global(g, src), group=g.pg)
    return _write_back(tensor, out)


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op: bool = True):
    """Rank ``r`` sends ``in_tensor_list[s]`` to rank ``s`` and returns the
    list whose item ``s`` came from rank ``s`` (appended to
    ``out_tensor_list``)."""
    g = _group(group)
    if not g.is_member:
        return []
    if isinstance(in_tensor_list, (list, tuple)):
        inp = torch.stack([_raw(x).detach() for x in in_tensor_list])
        wrap = any(isinstance(x, Tensor) for x in in_tensor_list)
    else:
        inp = _raw(in_tensor_list).detach().contiguous()
        wrap = isinstance(in_tensor_list, Tensor)
    if inp.shape[0] != g.nranks:
        raise ValueError(f"alltoall: {g.nranks} items expected, got "
                         f"{inp.shape[0]}")
    out = torch.empty_like(inp)
    with _watch("alltoall", g, inp, _nbytes(inp)):
        if g.pg is None:
            out.copy_(inp)
        else:
            dist.all_to_all_single(out, inp, group=g.pg)
    parts = [Tensor._wrap(out[s]) if wrap else out[s]
             for s in range(g.nranks)]
    if out_tensor_list is not None:
        out_tensor_list.extend(parts)
    return parts


def _token() -> torch.Tensor:
    dev = comm._state.device or torch.device("cpu")
    return torch.zeros(1, dtype=torch.int32, device=dev)


def barrier(group=None):
    """collective ops barrier: returns once every rank of the group has
    entered it (an all-reduce of one int32 on the rank's device)."""
    g = _group(group)
    if not g.is_member:
        return
    t = _token()
    with _watch("barrier", g, t, _nbytes(t)):
        if g.pg is not None:
            dist.all_reduce(t, group=g.pg)
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()


def wait(tensor, group=None, use_calc_stream=True):
    """collective.py wait: block until the work that writes ``tensor`` is
    done (every collective here completes before it returns; a CUDA
    tensor's stream is synchronized)."""
    raw = _raw(tensor)
    if raw.is_cuda:
        torch.cuda.current_stream(raw.device).synchronize()
    return tensor


def monitored_barrier(group=None, timeout: Optional[float] = None):
    """A barrier that names the missing ranks instead of deadlocking. The
    job-wide group first checks in through ``PADDLE_COLL_SYNC_DIR`` (ranks
    absent at the deadline are named in a ``CollectiveTimeoutError``, and a
    diverged op stream raises ``CollectiveDesyncError``), then runs the
    barrier under the ``PADDLE_COLL_TIMEOUT`` watchdog. ``timeout``
    defaults to ``PADDLE_COLL_TIMEOUT``, else 300 s."""
    mon = _cm.monitor()
    t = timeout
    if t is None:
        t = mon.timeout if mon.timeout > 0 else 300.0
    g = _group(group)
    if not g.is_member:
        return
    if g.id == 0:
        mon.barrier_rendezvous(t)
    tok = _token()
    with _watch("monitored_barrier", g, tok, _nbytes(tok), timeout=t):
        if g.pg is not None:
            dist.all_reduce(tok, group=g.pg)
        if tok.is_cuda:
            torch.cuda.current_stream(tok.device).synchronize()
