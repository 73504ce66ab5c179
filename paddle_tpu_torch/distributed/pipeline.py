"""Pipeline parallelism: a layer sequence cut into stages and the 1F1B
schedule (counterpart of ``paddle_tpu/distributed/pipeline.py``).

Reference: ``device_guard`` stage annotations and ``PipelineOptimizer``'s
program split (python/paddle/fluid/optimizer.py:3718,3801,4493), the
send_v2/recv_v2 ops between stages, and ``SectionWorker::TrainFiles``'s
micro-batch loop (paddle/fluid/framework/section_worker.cc:34,51).

**A rank owns one stage** (a rank is a process, ``comm.py``). The JAX
package drives every stage from one process, each on its submesh; here the
rank at pipeline index ``s`` of the hybrid mesh's ``pp`` axis runs stage
``s``'s layers and, of the schedule's global issue order (``_1f1b_order``
or ``_f_then_b_order``, copied as they are), the subsequence of its own
stage. An activation goes to the next stage's rank after each forward,
and its cotangent back after each backward, as ``collective.send_recv_``
over the rank's pp group (a header of the type and shape, then the
tensor). Every rank of the pp group enters every transfer of the order at
its place in the global order, so the transfers come in one order on
every rank and no pair can block another (stage s sending F(m) while
stage s + 1 sends B(m') cannot both wait). The stage's other mesh axes
keep their meaning: its ``ParallelGPTBlock``s shard over mp as anywhere,
and each microbatch is cut over dp, the gradients averaged over dp.

Memory: the port keeps the autograd graph of each microbatch in flight
(1F1B bounds them to ``num_stages - stage`` a stage), where the JAX
package keeps only the stage's input and recomputes the forward in its
backward; so the stage's forward runs once, and dropout draws its masks
once (from ``core.random``'s streams, as every layer of a world does).

``train_batch`` applies one update from the microbatch-mean gradients,
with no clip and no regularizer term, as the JAX package's
``_functional_update`` path does; the mean loss comes back on every rank
(from the last stage). ``PipelineLayer`` holds every layer on every rank,
so a ``paddle_tpu`` ``state_dict()`` loads into it as it is; each rank
then trains its segment's parameters only.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.tensor import Tensor, to_torch
from ..nn.layer import Layer
from . import collective, comm

__all__ = ["PipelineLayer", "PipelineParallel"]

#: header of a transfer between stages: dtype code, ndim, up to 8 dims
_HEADER = 10
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool)


class PipelineLayer(Layer):
    """A sequential model cut into pipeline stages.

    ``layers`` is the whole sequence; ``num_stages`` defaults to the hybrid
    mesh's pp degree at distribution time. ``loss_fn(logits, *labels)``
    runs on the last stage. ``seg_method``: ``"uniform"`` (equal layer
    counts) or ``"param"`` (balanced by parameter count)."""

    def __init__(self, layers: Sequence[Layer],
                 num_stages: Optional[int] = None,
                 loss_fn: Optional[Callable] = None,
                 seg_method: str = "uniform"):
        super().__init__()
        from ..nn.layers.container import LayerList

        self.funcs = LayerList(list(layers))
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        self.seg_method = seg_method

    def forward(self, x, *labels):
        """The whole sequence in one process (the parity reference)."""
        out = x
        for lyr in self.funcs:
            out = lyr(out)
        if labels and self.loss_fn is not None:
            return self.loss_fn(out, *labels)
        return out

    def segment(self, num_stages: int) -> List[List[int]]:
        """Layer indices per stage."""
        n = len(self.funcs)
        if num_stages > n:
            raise ValueError(
                f"cannot cut {n} layers into {num_stages} pipeline stages")
        if self.seg_method == "param":
            weights = [max(sum(int(p.numel()) for p in lyr.parameters()), 1)
                       for lyr in self.funcs]
        elif self.seg_method == "uniform":
            weights = [1] * n
        else:
            raise ValueError(f"unknown seg_method '{self.seg_method}'")
        total = sum(weights)
        bounds = [0]
        acc, j = 0, 0
        for k in range(1, num_stages):
            target = total * k / num_stages
            # advance to the weight midpoint, leaving >= 1 layer per
            # remaining stage and >= 1 layer in this one
            while acc < target and j < n - (num_stages - k):
                acc += weights[j]
                j += 1
            if j <= bounds[-1]:
                j = bounds[-1] + 1
                acc = sum(weights[:j])
            bounds.append(j)
        bounds.append(n)
        return [list(range(bounds[s], bounds[s + 1]))
                for s in range(num_stages)]


def _f_then_b_order(num_stages: int, num_micro: int):
    """The F-then-B issue order (schedule_mode="F-then-B",
    distributed_strategy.proto pipeline_configs): every microbatch's
    forward completes before any backward — simpler, all M activations in
    flight (higher memory than 1F1B, the reference's default for small M)."""
    S, M = num_stages, num_micro
    fwd = [("F", s, m) for m in range(M) for s in range(S)]
    bwd = [("B", s, m) for m in range(M) for s in reversed(range(S))]
    return fwd + bwd


def _1f1b_order(num_stages: int, num_micro: int):
    """The 1F1B issue order: list of ("F"|"B", stage, microbatch).

    Per-stage policy of SectionWorker's schedule (section_worker.cc:51):
    stage s keeps at most `num_stages - s` microbatches in flight — it runs
    `num_stages - 1 - s` warmup forwards, then alternates backward/forward,
    then drains. Generated by discrete-clock simulation (one op per stage
    per tick, deeper stages first so cotangents flow without idle ticks).
    """
    S, M = num_stages, num_micro
    f_done = [0] * S
    b_done = [0] * S
    ops = []
    while any(b < M for b in b_done):
        progressed = False
        for s in reversed(range(S)):
            m = b_done[s]
            b_ready = (
                m < M
                and f_done[s] > m
                and (s == S - 1 or b_done[s + 1] > m)
            )
            fm = f_done[s]
            f_ready = (
                fm < M
                and (s == 0 or f_done[s - 1] > fm)
                and fm - b_done[s] < S - s  # in-flight bound
            )
            if b_ready:
                ops.append(("B", s, m))
                b_done[s] += 1
                progressed = True
            elif f_ready:
                ops.append(("F", s, fm))
                f_done[s] += 1
                progressed = True
        if not progressed:
            raise AssertionError("1F1B schedule deadlock (bug)")
    return ops


class _Stage:
    """This rank's stage: its layers, their trainable parameters, and the
    loss on the last stage."""

    def __init__(self, layers: Sequence[Layer], is_last: bool,
                 loss_fn: Optional[Callable]):
        self.layers = list(layers)
        self.is_last = is_last
        self.loss_fn = loss_fn
        seen, self.params = set(), []
        for lyr in self.layers:
            for p in lyr.parameters():
                if p.requires_grad and id(p) not in seen:
                    seen.add(id(p))
                    self.params.append(p)

    def forward(self, x, labels=()):
        out = x
        for lyr in self.layers:
            out = to_torch(lyr(out))
        if self.is_last and self.loss_fn is not None and labels:
            out = to_torch(self.loss_fn(out, *labels))
        return out


def _transfer(t: Optional[torch.Tensor], src: int, dst: int, me: int,
              group, device) -> Optional[torch.Tensor]:
    """Stage ``src`` hands ``t`` to stage ``dst``; every rank of the pp
    group calls this at the same place of the order. Returns the tensor on
    ``dst``, None elsewhere."""
    sending, receiving = me == src, me == dst
    head = None
    if sending:
        if t.dim() > _HEADER - 2:
            raise ValueError(f"pipeline: a {t.dim()}-dim tensor between "
                             "stages (8 at most)")
        head = torch.tensor([_DTYPES.index(t.dtype), t.dim(), *t.shape]
                            + [0] * (_HEADER - 2 - t.dim()),
                            dtype=torch.int64, device=device)
    got = collective.send_recv_(
        head, dst if sending else -1,
        ((_HEADER,), torch.int64, device) if receiving else None,
        src if receiving else -1, group)
    like = None
    if receiving:
        h = got.tolist()
        like = (tuple(h[2:2 + h[1]]), _DTYPES[h[0]], device)
    return collective.send_recv_(t.detach() if sending else None,
                                 dst if sending else -1, like,
                                 src if receiving else -1, group)


class PipelineParallel(Layer):
    """Drive a PipelineLayer over the hybrid mesh's pp axis, one stage a
    rank.

    Built by ``fleet.distributed_model`` when ``pp_degree > 1``; usage
    follows the fleet pipeline API::

        model = fleet.distributed_model(PipelineLayer(layers, loss_fn=...))
        opt = fleet.distributed_optimizer(opt)
        loss = model.train_batch([x, y], opt)

    ``accumulate_steps`` (strategy pipeline_configs) is the microbatch
    count (distributed_strategy.proto:120 micro_batch)."""

    def __init__(self, layer: PipelineLayer, mesh=None,
                 num_stages: Optional[int] = None,
                 accumulate_steps: int = 1, schedule_mode: str = "1F1B"):
        super().__init__()
        if schedule_mode not in ("1F1B", "F-then-B"):
            raise NotImplementedError(
                f"schedule_mode '{schedule_mode}': only '1F1B' and "
                "'F-then-B' are built (interleaved/virtual stages are not)")
        self.schedule_mode = schedule_mode
        self.pipeline = layer
        mesh = mesh if mesh is not None else comm.hybrid_mesh()
        if mesh is None:
            raise RuntimeError(
                "PipelineParallel needs a hybrid mesh: call fleet.init with "
                "hybrid_configs pp_degree, or comm.init_hybrid_mesh(pp=N)")
        self.mesh = mesh
        S = num_stages or layer.num_stages or mesh.shape["pp"]
        if mesh.shape["pp"] != S:
            raise ValueError(
                f"PipelineLayer wants {S} stages but the mesh pp axis is "
                f"{mesh.shape['pp']}")
        self.num_stages = S
        self.accumulate_steps = int(accumulate_steps)
        self.stage_id = mesh.axis_rank("pp")
        self.group = mesh.group("pp")
        seg = layer.segment(S)
        self.segments = seg
        self.stage = _Stage([layer.funcs[i] for i in seg[self.stage_id]],
                            is_last=self.stage_id == S - 1,
                            loss_fn=layer.loss_fn)
        self._device = comm._state.device or torch.device("cpu")
        self._order_cache = {}

    def parameters(self, include_sublayers=True):
        return self.pipeline.parameters(include_sublayers)

    def _raw(self, x):
        raw = to_torch(x)
        if not isinstance(raw, torch.Tensor):
            raw = torch.as_tensor(np.asarray(raw))
        return raw.to(self._device)

    def _bcast_from_last(self, t: Optional[torch.Tensor]) -> torch.Tensor:
        """The last stage's ``t`` on every rank of the pipeline."""
        S, me = self.num_stages, self.stage_id
        if S == 1:
            return t
        out = None
        for dst in range(S - 1):
            got = _transfer(t, S - 1, dst, me, self.group, self._device)
            if me == dst:
                out = got
        return t if me == S - 1 else out

    def forward(self, x, *labels):
        """Inference: the batch straight through the stages, no
        microbatches; the output on every rank."""
        out = self._raw(x) if self.stage_id == 0 else None
        for s in range(self.num_stages):
            if s == self.stage_id:
                out = self.stage.forward(out)
            if s < self.num_stages - 1:
                got = _transfer(out if s == self.stage_id else None, s,
                                s + 1, self.stage_id, self.group,
                                self._device)
                if self.stage_id == s + 1:
                    out = got
        return Tensor._wrap(self._bcast_from_last(out).detach())

    def _order(self):
        key = (self.num_stages, self.accumulate_steps, self.schedule_mode)
        if key not in self._order_cache:
            gen = _1f1b_order if self.schedule_mode == "1F1B" \
                else _f_then_b_order
            self._order_cache[key] = gen(self.num_stages,
                                         self.accumulate_steps)
        return self._order_cache[key]

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One global batch: split into microbatches, run the schedule,
        apply the optimizer once with microbatch-averaged gradients (and
        averaged over dp). Returns the mean loss, the same on every rank."""
        if scaler is not None:
            raise NotImplementedError(
                "GradScaler with pipeline: use bf16 (strategy.amp) instead")
        loss = self.forward_backward_pipeline(data)
        params = [p for p in self.stage.params if p.grad is not None]
        inner = getattr(optimizer, "_inner", optimizer)
        inner._step_count += 1
        inner._write(inner._functional_update(
            params, [p.grad for p in params], inner.get_lr(),
            inner._step_count))
        for p in self.stage.params:
            p.grad = None
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def forward_backward_pipeline(self, data):
        """The schedule over one global batch ``[inputs, *labels]``
        without the update: this stage's parameters are left holding the
        microbatch-mean gradients, averaged over dp. Returns the mean
        loss, the same on every rank."""
        if self.pipeline.loss_fn is None:
            raise ValueError(
                "train_batch needs PipelineLayer(..., loss_fn=...) — the "
                "last stage computes the loss")
        if len(data) < 2:
            raise ValueError(
                "train_batch expects [inputs, *labels]; got no labels")
        x = self._raw(data[0])
        labels = tuple(self._raw(lbl) for lbl in data[1:])
        M, S, me = self.accumulate_steps, self.num_stages, self.stage_id
        if x.shape[0] % M != 0:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by accumulate_steps {M}")
        mb = x.shape[0] // M
        dp = comm.dp_size(self.mesh)
        if mb % dp != 0:
            raise ValueError(
                f"microbatch size {mb} (batch {x.shape[0]} / "
                f"accumulate_steps {M}) must be divisible by dp_degree {dp}")
        rows = mb // dp
        d0 = self.mesh.axis_rank("dp") * rows

        def micro(t, m):
            return t[m * mb + d0:m * mb + d0 + rows]

        st = self.stage
        for p in st.params:
            p.grad = None
        stage_in, outs, gout, losses = {}, {}, {}, []
        with torch.enable_grad():
            for op, s, m in self._order():
                if op == "F":
                    if s == me:
                        xin = micro(x, m) if s == 0 else \
                            stage_in[m].requires_grad_()
                        stage_in[m] = xin
                        lab = tuple(micro(t, m) for t in labels) \
                            if st.is_last else ()
                        outs[m] = st.forward(xin, lab)
                        if st.is_last:
                            losses.append(outs[m].detach())
                    if s < S - 1:
                        got = _transfer(outs.get(m) if s == me else None,
                                        s, s + 1, me, self.group,
                                        self._device)
                        if me == s + 1:
                            stage_in[m] = got
                    continue
                gx = None
                if s == me:
                    out = outs.pop(m)
                    if st.is_last:
                        out.backward()
                    else:
                        out.backward(gout.pop(m))
                    gx = stage_in.pop(m).grad if s > 0 else None
                if s > 0:
                    got = _transfer(gx, s, s - 1, me, self.group,
                                    self._device)
                    if me == s - 1:
                        gout[m] = got
        from .parallel import reduce_gradients

        params = [p for p in st.params if p.grad is not None]
        with torch.no_grad():
            for p in params:
                p.grad.mul_(1.0 / M)
        reduce_gradients(params, comm.data_group())
        loss = torch.stack(losses).mean().reshape(1) if st.is_last else None
        loss = self._bcast_from_last(loss)
        g = comm.data_group()
        if g is not None and g.nranks > 1:
            collective.all_reduce_(loss, collective.ReduceOp.AVG, g)
        return Tensor._wrap(loss.reshape(()).detach())
