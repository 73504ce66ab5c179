"""Worlds of ``paddle_tpu_torch`` ranks on the CPU, for the multi-rank
parity tests (tests/test_torch_collective.py,
tests/test_torch_tensor_parallel.py, tests/test_torch_sequence_parallel.py
and tests/test_torch_pipeline_moe.py).

A world is ``nprocs`` processes started by the port's ``spawn`` (the
``spawn`` start method), each on the CPU with one thread, meeting through a
``file://`` store in the test's temporary directory over gloo. Every rank
runs the named cases of this module in order; each case reads the inputs
the test wrote (``inputs.pkl``) and returns a dict that lands in
``<case>.rank<r>.pkl``. Imports torch, numpy and the port only: no JAX,
no ``paddle_tpu``.
"""
from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np

#: a world still running after this many seconds is killed and fails
DEADLINE_S = 120.0


def run_world(cases, tmpdir: str, inputs: dict, nprocs: int = 4,
              env: dict = None, device: str = "cpu") -> dict:
    """Run ``cases`` (names of this module's ``case_*`` functions, without
    the prefix) on a world of ``nprocs`` ranks on ``device`` ("cpu", or
    "gpu": every rank on the card, over the backend the rule gives);
    returns ``{case: [rank 0's result, rank 1's, ...]}``. A rank's
    exception fails the world, with its traceback in
    ``<tmpdir>/error.rank<r>``."""
    from paddle_tpu_torch.distributed import spawn

    with open(os.path.join(tmpdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    try:
        spawn(_child, (list(cases), tmpdir, dict(env or {}), device),
              nprocs=nprocs, timeout=DEADLINE_S)
    except RuntimeError as e:
        errs = [open(os.path.join(tmpdir, n)).read()
                for n in sorted(os.listdir(tmpdir)) if n.startswith("error")]
        raise RuntimeError(f"{e}\n" + "\n".join(errs)) from None
    out = {}
    for c in cases:
        out[c] = []
        for r in range(nprocs):
            with open(os.path.join(tmpdir, f"{c}.rank{r}.pkl"), "rb") as f:
                out[c].append(pickle.load(f))
    return out


def _child(cases, tmpdir, env, device):
    os.environ.update(env)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    try:
        import torch

        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        from paddle_tpu_torch import distributed as dist

        dist.init_parallel_env(init_method=f"file://{tmpdir}/store",
                               device="cpu" if device == "cpu" else None)
        with open(os.path.join(tmpdir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        mod = sys.modules[__name__]
        for c in cases:
            res = getattr(mod, f"case_{c}")(rank, inputs, tmpdir)
            with open(os.path.join(tmpdir, f"{c}.rank{rank}.pkl"),
                      "wb") as f:
                pickle.dump(res, f)
        dist.barrier()
        dist.comm.destroy_parallel_env()
    except BaseException:
        with open(os.path.join(tmpdir, f"error.rank{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise


def fail_on_rank(rank_to_fail: int, code: int) -> None:
    """A ``spawn`` target: the rank ``rank_to_fail`` exits with ``code``,
    the others wait to be terminated."""
    import time

    if int(os.environ["PADDLE_TRAINER_ID"]) == rank_to_fail:
        os._exit(code)
    time.sleep(60)


def _np(t):
    import torch

    raw = getattr(t, "_data", t)
    if isinstance(raw, torch.Tensor):
        return raw.detach().float().cpu().numpy() \
            if raw.dtype == torch.bfloat16 else raw.detach().cpu().numpy()
    return np.asarray(raw)


# ---------------------------------------------------------------------------
# the collectives (tests/test_torch_collective.py)
# ---------------------------------------------------------------------------


def case_collectives(rank, inputs, tmpdir):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist

    R = dist.ReduceOp
    out = {}
    x = inputs["sum"][rank]
    out["sum"] = _np(dist.all_reduce(pt.to_tensor(x)))
    for name, op in (("max", R.MAX), ("min", R.MIN), ("prod", R.PROD),
                     ("avg", R.AVG)):
        out[name] = _np(dist.all_reduce(pt.to_tensor(inputs["ops"][rank]),
                                        op=op))
    out["reduce"] = _np(dist.reduce(pt.to_tensor(inputs["sum"][rank]),
                                    dst=1))
    out["all_gather"] = [_np(p) for p in dist.all_gather(
        None, pt.to_tensor(inputs["gather"][rank]))]
    out["broadcast"] = _np(dist.broadcast(
        pt.to_tensor(inputs["sum"][rank]), src=2))
    for name, op in (("rs_sum", R.SUM), ("rs_max", R.MAX),
                     ("rs_avg", R.AVG)):
        t = pt.to_tensor(inputs["rs"][rank])
        out[name] = _np(dist.reduce_scatter(t, op=op))
    t = pt.to_tensor(np.zeros_like(inputs["scatter"][0]))
    lst = [pt.to_tensor(a) for a in inputs["scatter"]] if rank == 1 \
        else None
    out["scatter"] = _np(dist.scatter(t, lst, src=1))
    out["alltoall"] = [_np(p) for p in dist.alltoall(
        [pt.to_tensor(a[rank]) for a in inputs["a2a"]])]
    out["shard_rank_axis"] = _np(dist.shard_rank_axis(inputs["sum"]))
    out["replicate"] = _np(dist.replicate(inputs["sum"][0]))
    sub = dist.new_group([0, 2])
    out["subset"] = _np(dist.all_reduce(pt.to_tensor(inputs["sum"][rank]),
                                        group=sub))
    out["subset_rank"] = sub.rank
    dist.barrier()
    dist.wait(pt.to_tensor(x))
    # a torch tensor is written in place
    import torch

    raw = torch.tensor(x)
    dist.all_reduce(raw)
    out["inplace"] = raw.numpy()
    mon = dist.comm_monitor.monitor()
    out["counts"] = mon.comm_counts()
    out["records"] = mon.snapshot()
    return out


def case_monitor(rank, inputs, tmpdir):
    """The comm monitor in a world: an injected hang caught by the
    watchdog and dumped, an injected desync named at a monitored barrier,
    and a monitored barrier that names the rank that never came."""
    import time

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import comm_monitor as cm
    from paddle_tpu_torch.utils import fault_injection as fi

    dbg = os.path.join(tmpdir, "dbg")
    os.environ.update({"PADDLE_COLL_SYNC_DIR": os.path.join(tmpdir, "s1"),
                       "PADDLE_COLL_DEBUG_DIR": dbg,
                       "PADDLE_COLL_EVENT_FILE":
                           os.path.join(tmpdir, f"events.{rank}"),
                       "PADDLE_COLL_TIMEOUT": "0.5",
                       "PADDLE_COLL_TIMEOUT_ACTION": "dump"})
    out = {}
    # rank 0 hangs 2 s inside its second collective; the watchdog fires
    # while it is stuck, dumps the recorder and writes the event
    os.environ["PADDLE_FAULT_SPEC"] = "coll:hang:2:2" if rank == 0 else ""
    fi.reset()
    cm.reset()
    x = np.full((2, 3), float(rank), np.float32)
    dist.all_reduce(pt.to_tensor(x))
    t0 = time.time()
    out["hang_result"] = _np(dist.all_reduce(pt.to_tensor(x)))
    out["hang_t0"] = t0
    out["events"] = cm.read_events(os.path.join(tmpdir, f"events.{rank}"))
    with open(os.path.join(dbg, f"comm_dump.rank{rank}.json")) as f:
        out["hang_dump"] = f.read()
    # a desync injected on rank 1: its next collective's fingerprint
    # mutates, and the monitored barrier names both call sites
    os.environ["PADDLE_COLL_TIMEOUT"] = "0"
    os.environ["PADDLE_FAULT_SPEC"] = "coll:desync:1:1"
    fi.reset()
    cm.reset()
    dist.all_reduce(pt.to_tensor(x))
    try:
        dist.monitored_barrier(timeout=30)
        out["desync"] = None
    except cm.CollectiveDesyncError as e:
        out["desync"] = str(e)
    # rank 3 skips a monitored barrier: the others name it at the deadline
    os.environ["PADDLE_FAULT_SPEC"] = ""
    os.environ["PADDLE_COLL_SYNC_DIR"] = os.path.join(tmpdir, "s2")
    fi.reset()
    cm.reset()
    if rank != 3:
        try:
            dist.monitored_barrier(timeout=1.0)
            out["missing"] = None
        except cm.CollectiveTimeoutError as e:
            out["missing"] = str(e)
    return out


# ---------------------------------------------------------------------------
# tensor parallelism, DataParallel and fleet at dp2 x mp2
# (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------


def _fleet(dp=2, mp=2):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    fleet.init(is_collective=True, strategy=s)
    return s


def _full_grads(layer):
    """Each parameter's gradient, gathered to its full shape."""
    out = {}
    for n, p in layer.named_parameters():
        shard = getattr(p, "_tp_shard", None)
        g = p.grad
        out[n] = _np(shard.gather(g) if shard is not None else g)
    return out


def _fwd_bwd(layer, x, cot, dev="cpu"):
    """``layer(x)``, then the backward of ``sum(out * cot)``: the output,
    the input's gradient and the full parameter gradients."""
    import torch

    xt = torch.tensor(x, device=dev, requires_grad=x.dtype.kind == "f")
    out = layer(xt)
    (out * torch.tensor(cot, device=dev)).sum().backward()
    return {"out": _np(out), "gx": None if xt.grad is None else _np(xt.grad),
            "grads": _full_grads(layer)}


def case_fleet(rank, inputs, tmpdir):
    from paddle_tpu_torch.distributed import comm, fleet

    _fleet()
    hcg = fleet.get_hybrid_communicate_group()
    return {"dp": hcg.get_data_parallel_world_size(),
            "mp": hcg.get_model_parallel_world_size(),
            "pp": hcg.get_pipe_parallel_world_size(),
            "dp_rank": hcg.get_data_parallel_rank(),
            "mp_rank": hcg.get_model_parallel_rank(),
            "mp_group": hcg.get_model_parallel_group().ranks,
            "dp_group": hcg.get_data_parallel_group().ranks,
            "worker_index": fleet.worker_index(),
            "worker_num": fleet.worker_num(),
            "first": fleet.is_first_worker(),
            "backend": comm.backend()}


def case_tp_layers(rank, inputs, tmpdir):
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import meta_parallel as M

    out = {}
    col = dist.ColumnParallelLinear(12, 16, gather_output=True)
    col.set_state_dict(inputs["col"])
    out["col_local"] = {k: tuple(v.shape) for k, v in
                        col.state_dict().items()}
    out["col_full"] = M.full_state_dict(col)
    out["col"] = _fwd_bwd(col, inputs["x12"], inputs["cot16"])
    row = dist.RowParallelLinear(12, 5)
    row.set_state_dict(inputs["row"])
    out["row_local"] = {k: tuple(v.shape) for k, v in
                        row.state_dict().items()}
    out["row"] = _fwd_bwd(row, inputs["x12"], inputs["cot5"])

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.col = dist.ColumnParallelLinear(8, 16, gather_output=False)
            self.row = dist.RowParallelLinear(16, 8, input_is_parallel=True)

        def forward(self, x):
            return self.row(torch.nn.functional.gelu(self.col(x)))

    mlp = MLP()
    mlp.col.set_state_dict(inputs["mlp_col"])
    mlp.row.set_state_dict(inputs["mlp_row"])
    out["mlp"] = _fwd_bwd(mlp, inputs["x8"], inputs["cot8"])
    emb = dist.VocabParallelEmbedding(16, 6)
    emb.set_state_dict(inputs["emb"])
    out["emb_local"] = tuple(emb.weight.shape)
    out["emb"] = _fwd_bwd(emb, inputs["ids"], inputs["cot_emb"])
    out["split_linear"] = tuple(dist.split(
        torch.tensor(inputs["x8"][:2]), size=(8, 12), operation="linear",
        axis=1).shape)
    out["split_embedding"] = tuple(dist.split(
        torch.tensor([[1, 2]]), size=(8, 4), operation="embedding").shape)
    try:
        dist.ColumnParallelLinear(8, 7)
        out["not_divisible"] = None
    except ValueError as e:
        out["not_divisible"] = str(e)
    return out


def case_gpt_block(rank, inputs, tmpdir):
    """``ParallelGPTBlock`` at mp2 on the dense route, and on the kernels'
    route (their plain versions here: ``interpret``)."""
    from paddle_tpu_torch import distributed as dist

    out = {}
    for route in ("dense", "kernels"):
        if route == "kernels":
            os.environ["PADDLE_FLASH_DEFAULT"] = "interpret"
            os.environ["PADDLE_FUSED_LN"] = "interpret"
        blk = dist.ParallelGPTBlock(64, 4, dropout=0.0)
        blk.set_state_dict(inputs["block"])
        out[route] = _fwd_bwd(blk, inputs["xb"], inputs["cotb"])
    os.environ.pop("PADDLE_FLASH_DEFAULT")
    os.environ.pop("PADDLE_FUSED_LN")
    return out


def small_net():
    import paddle_tpu_torch as pt

    class SmallNet(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pt.nn.Linear(12, 16)
            self.fc2 = pt.nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(pt.nn.functional.relu(self.fc1(x)))

    return SmallNet()


def case_data_parallel(rank, inputs, tmpdir):
    import paddle_tpu_torch as pt

    net = small_net()
    net.set_state_dict(inputs["dp_init"])
    dp = pt.DataParallel(net)
    opt = pt.optimizer.Momentum(learning_rate=0.1,
                                parameters=dp.parameters())
    step = pt.jit.TrainStep(
        dp, lambda o, y: pt.nn.functional.cross_entropy(o, y), opt)
    losses = [float(step(dp.shard_input(x), dp.shard_input(y)))
              for x, y in inputs["dp_data"]]
    return {"losses": losses, "params": {k: _np(v) for k, v in
                                         dp.state_dict().items()},
            "group": dp.group.ranks}


def case_sync_batch_norm(rank, inputs, tmpdir):
    """``SyncBatchNorm`` in training on this rank's part of the global
    batch (its dp group's rows): statistics over the dp group's batch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import comm

    _fleet()
    bn = pt.nn.SyncBatchNorm(4)
    bn.set_state_dict(inputs["bn"])
    mesh = comm.hybrid_mesh()
    dp_i, n = mesh.axis_rank("dp"), mesh.shape["dp"]
    rows = slice(dp_i * 8 // n, (dp_i + 1) * 8 // n)
    res = _fwd_bwd(bn, inputs["xbn"][rows], inputs["cotbn"][rows])
    res["rows"] = (rows.start, rows.stop)
    res["running"] = {k: _np(v) for k, v in bn.state_dict().items()}
    return res



def gpt(vocab, d, heads, layers, seq, dropout=0.0):
    """bench.py's ``_gpt_medium`` program at a given size (the port), with
    ``dropout`` in its blocks and on the embeddings."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import ParallelGPTBlock

    class GPT(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, d)
            self.pos = nn.Embedding(seq, d)
            self.blocks = nn.LayerList([
                ParallelGPTBlock(d, heads, dropout=dropout)
                for _ in range(layers)])
            self.drop = nn.Dropout(dropout)
            self.head = nn.Linear(d, vocab)

        def embed_ids(self, ids):
            T = ids.shape[1]
            return self.drop(self.embed(ids)
                             + self.pos(paddle.arange(T, dtype="int64")))

        def forward(self, ids):
            h = self.embed_ids(ids)
            for blk in self.blocks:
                h = blk(h)
            return h

    return GPT()


def lm_loss(model):
    from paddle_tpu_torch import nn

    def loss(h, labels):
        d = h.shape[-1]
        return nn.functional.fused_linear_cross_entropy(
            h.reshape([-1, d]), model.head.weight, model.head.bias,
            labels.reshape([-1]))

    return loss


def case_gpt_train(rank, inputs, tmpdir):
    """The GPT through fleet at dp2 x mp2 and ``TrainStep``, 3 steps of
    Momentum with the gradients clipped by their global norm."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import meta_parallel as M

    _fleet()
    model = gpt(*inputs["gpt_cfg"])
    model.set_state_dict(inputs["gpt_init"])
    fl = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.Momentum(
        learning_rate=inputs["gpt_lr"], momentum=0.9,
        parameters=model.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(inputs["gpt_clip"])))
    step = pt.jit.TrainStep(fl, lm_loss(model), opt)
    ids, labels = inputs["gpt_batch"]
    losses = [float(step(fl.shard_input(ids), fl.shard_input(labels)))
              for _ in range(3)]
    return {"losses": losses, "params": M.full_state_dict(model)}


def case_guard(rank, inputs, tmpdir):
    """A NaN injected into rank 1's gradients at step 2: every rank skips
    that step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import meta_parallel as M
    from paddle_tpu_torch.utils import fault_injection as fi

    _fleet()
    os.environ["PADDLE_FAULT_SPEC"] = "grad:nan:2" if rank == 1 else ""
    fi.reset()
    model = gpt(*inputs["gpt_cfg"])
    model.set_state_dict(inputs["gpt_init"])
    fl = pt.distributed.fleet.distributed_model(model)
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    step = pt.jit.TrainStep(fl, lm_loss(model), opt)
    ids, labels = inputs["gpt_batch"]
    snaps = []
    for _ in range(3):
        step(fl.shard_input(ids), fl.shard_input(labels))
        snaps.append(M.full_state_dict(model))
    os.environ["PADDLE_FAULT_SPEC"] = ""
    fi.reset()
    return {"snaps": snaps}


def case_random_streams(rank, inputs, tmpdir):
    """Dropout's streams at dp2 x mp2: the masks of the ``dropout`` and
    ``dropout_mp`` streams, eager and inside a ``to_static`` capture; and
    the GPT with dropout 0.1 under ``recompute`` against the same GPT
    without it (the recomputation must draw the forward's masks again)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet

    _fleet()
    F = pt.nn.functional
    out = {}
    ones = pt.ones([64])
    pt.seed(3)
    out["dropout"] = _np(F.dropout(ones, 0.5))
    out["dropout_mp"] = _np(F.dropout(ones, 0.5, stream="dropout_mp"))
    drop = pt.nn.Dropout(0.5)
    drop.train()
    sf = pt.jit.StaticFunction(drop.forward, layer=drop)
    pt.seed(3)
    out["captured"] = [_np(sf(ones)), _np(sf(ones))]
    graph = next(iter(sf.program_cache.values())).exported.graph
    out["captured_draws"] = sum("paddle_tpu_torch.draw" in str(n.target)
                                for n in graph.nodes)

    model = gpt(*inputs["gpt_cfg"], dropout=0.1)
    model.set_state_dict(inputs["gpt_init"])
    fl = fleet.distributed_model(model)
    ids, labels = (fl.shard_input(a) for a in inputs["gpt_batch"])
    loss_fn = lm_loss(model)

    def run(recompute, training=True):
        model.train() if training else model.eval()
        model.clear_gradients()
        pt.seed(11)
        h = model.embed_ids(ids)
        for blk in model.blocks:
            h = pt.jit.recompute(blk, h) if recompute else blk(h)
        loss = loss_fn(h, labels)
        loss.backward()
        return float(loss), {n: _np(p.grad)
                             for n, p in model.named_parameters()}

    out["plain"], out["recomputed"] = run(False), run(True)
    out["eval_loss"] = run(False, training=False)[0]
    return out


# ---------------------------------------------------------------------------
# sequence parallelism at sp4 (tests/test_torch_sequence_parallel.py)
# ---------------------------------------------------------------------------


def _fleet_hybrid(**degrees):
    from paddle_tpu_torch.distributed import comm, fleet

    comm._mesh = None
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=s)
    return s


def _seq_rows(a, axis, rank, n):
    """Rank ``rank``'s ``1/n`` of ``a`` along ``axis``."""
    size = a.shape[axis] // n
    return np.take(a, range(rank * size, (rank + 1) * size), axis=axis)


def sp_decoder(vocab, d, heads, seq, impl):
    """A one-layer causal decoder whose attention is ``impl``: token and
    position embeddings (the positions of this rank's sequence shard on an
    sp mesh), a ``TransformerEncoderLayer`` and a head."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import comm

    class Decoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, d)
            self.pos = nn.Embedding(seq, d)
            self.layer = nn.TransformerEncoderLayer(
                d, heads, 2 * d, dropout=0.0, attn_impl=impl, causal=True)
            self.head = nn.Linear(d, vocab)

        def forward(self, ids):
            T = ids.shape[1]
            mesh = comm.hybrid_mesh()
            start = mesh.axis_rank("sp") * T if mesh is not None else 0
            pos = paddle.arange(start, start + T, dtype="int64")
            return self.head(self.layer(self.embed(ids) + self.pos(pos)))

    return Decoder()


def case_sequence_parallel(rank, inputs, tmpdir):
    """At sp4: ring, ring_pallas and Ulysses attention (global forms, causal
    and not) with the gradients of ``sum(out * g)``; each
    ``MultiHeadAttention`` route on this rank's rows of x; the one-layer
    decoder trained 3 steps through fleet (sp_degree 4) and
    ``TrainStep``."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import comm, fleet
    from paddle_tpu_torch.distributed import meta_parallel as M
    from paddle_tpu_torch.nn.layers import ring_attention as ra

    _fleet_hybrid(sp=4)
    mesh = comm.hybrid_mesh()
    out = {"sp_rank": mesh.axis_rank("sp"),
           "sp_group": mesh.group("sp").ranks,
           "data_group": mesh.group("data").ranks}
    q, k, v, g = (torch.tensor(a) for a in inputs["qkvg"])
    for impl in ("ring", "ring_pallas", "ulysses"):
        for causal in (True, False):
            ts = [t.clone().requires_grad_() for t in (q, k, v)]
            if impl == "ulysses":
                o = ra.ulysses_attention(*ts, causal=causal,
                                         block_size=inputs["block"])
            else:
                o = ra.ring_attention(*ts, causal=causal,
                                      use_pallas=impl == "ring_pallas")
            (o * g).sum().backward()
            out[impl, causal] = [_np(o)] + [_np(t.grad) for t in ts]
    x, cot = inputs["mha_x"], inputs["mha_cot"]
    for impl in ("ring", "ring_pallas", "ulysses"):
        mha = pt.nn.MultiHeadAttention(*inputs["mha_cfg"], attn_impl=impl,
                                       causal=True,
                                       block_size=inputs["block"])
        mha.set_state_dict(inputs["mha"])
        xt = torch.tensor(_seq_rows(x, 1, rank, 4), requires_grad=True)
        o = mha(xt)
        (o * torch.tensor(_seq_rows(cot, 1, rank, 4))).sum().backward()
        out["mha", impl] = {"out": _np(o), "gx": _np(xt.grad),
                            "grads": {n: _np(p.grad) for n, p in
                                      mha.named_parameters()}}
    model = sp_decoder(*inputs["dec_cfg"])
    model.set_state_dict(inputs["dec_init"])
    fl = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.Momentum(
        learning_rate=inputs["dec_lr"], momentum=0.9,
        parameters=model.parameters()))

    def loss_fn(logits, labels):
        return pt.nn.functional.cross_entropy(
            logits.reshape([-1, logits.shape[-1]]), labels.reshape([-1]))

    step = pt.jit.TrainStep(fl, loss_fn, opt)
    ids, labels = inputs["dec_batch"]
    out["dec_shard"] = tuple(fl.shard_input(ids).shape)
    out["dec_losses"] = [float(step(fl.shard_input(ids),
                                    fl.shard_input(labels)))
                         for _ in range(3)]
    out["dec_params"] = M.full_state_dict(model)
    return out


# ---------------------------------------------------------------------------
# the pipeline and MoE (tests/test_torch_pipeline_moe.py)
# ---------------------------------------------------------------------------


def pipeline_blocks(d, heads, classes):
    """Two ``ParallelGPTBlock``s and a head (dropout 0)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import ParallelGPTBlock

    return [ParallelGPTBlock(d, heads, dropout=0.0),
            ParallelGPTBlock(d, heads, dropout=0.0), nn.Linear(d, classes)]


def pipeline_loss(out, y):
    """Mean over the positions, then cross-entropy."""
    import paddle_tpu_torch as pt

    return pt.nn.functional.cross_entropy(out.mean(axis=1), y)


def case_pipeline(rank, inputs, tmpdir):
    """``PipelineParallel.train_batch`` through fleet at pp2 (x dp2) in
    1F1B and F-then-B, and at pp2 x mp2 in 1F1B: losses and the gathered
    parameters after the steps; the inference forward."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import PipelineParallel, fleet
    from paddle_tpu_torch.distributed import meta_parallel as M

    out = {}
    for name, degrees, mode in (("pp2", dict(dp=2, pp=2), "1F1B"),
                                ("pp2_fthenb", dict(dp=2, pp=2), "F-then-B"),
                                ("pp2_mp2", dict(pp=2, mp=2), "1F1B")):
        s = _fleet_hybrid(**degrees)
        s.pipeline = True
        s.pipeline_configs = {"accumulate_steps": inputs["pp_micro"],
                              "schedule_mode": mode}
        layer = pt.distributed.PipelineLayer(
            pipeline_blocks(*inputs["pp_cfg"]), loss_fn=pipeline_loss)
        layer.set_state_dict(inputs["pp_init"])
        model = fleet.distributed_model(layer)
        assert isinstance(model, PipelineParallel)
        opt = fleet.distributed_optimizer(pt.optimizer.Momentum(
            learning_rate=inputs["pp_lr"], momentum=0.9,
            parameters=model.parameters()))
        res = {"stage": model.stage_id, "segments": model.segments}
        if name == "pp2":
            res["forward"] = _np(model(inputs["pp_x"][0]))
        res["losses"] = [float(model.train_batch([x, y], opt))
                         for x, y in zip(inputs["pp_x"], inputs["pp_y"])]
        own = {id(p) for p in model.stage.params}
        res["params"] = {k: v for k, v in M.full_state_dict(layer).items()
                         if id(dict(layer.named_parameters()).get(k)) in own}
        out[name] = res
    return out


def case_moe(rank, inputs, tmpdir):
    """``ExpertParallelMoE`` at ep4 (mp4, 2 experts a rank): out, aux and
    the gradients of x and the (gathered) weights."""
    import torch

    from paddle_tpu_torch.distributed import meta_parallel as M
    from paddle_tpu_torch.incubate import ExpertParallelMoE

    _fleet_hybrid(mp=4)
    moe = ExpertParallelMoE(*inputs["moe_cfg"])
    moe.set_state_dict(inputs["moe_init"])
    x = torch.tensor(inputs["moe_x"], requires_grad=True)
    o, aux = moe(x)
    ((o * torch.tensor(inputs["moe_cot"])).sum()
     + inputs["moe_aux_w"] * aux).backward()
    return {"local": {n: tuple(p.shape) for n, p in moe.named_parameters()},
            "out": _np(o), "aux": float(aux), "gx": _np(x.grad),
            "grads": _full_grads(moe), "full": M.full_state_dict(moe)}


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------


def case_cuda_collectives(rank, inputs, tmpdir):
    """Each collective on CUDA tensors of this rank's card, float32 and
    bf16, with the counts' backend and transport."""
    import torch

    from paddle_tpu_torch import distributed as dist

    R = dist.ReduceOp
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt)[6:]

        def t(a):
            return torch.tensor(a, device=dev).to(dt)

        for name, op in (("sum", R.SUM), ("max", R.MAX), ("min", R.MIN),
                         ("prod", R.PROD), ("avg", R.AVG)):
            out[key, name] = _np(dist.all_reduce(t(inputs["x"][rank]),
                                                 op=op))
        out[key, "reduce"] = _np(dist.reduce(t(inputs["x"][rank]), dst=1))
        out[key, "all_gather"] = [_np(p) for p in
                                  dist.all_gather(t(inputs["x"][rank]))]
        out[key, "broadcast"] = _np(dist.broadcast(t(inputs["x"][rank]),
                                                   src=1))
        out[key, "reduce_scatter"] = _np(dist.reduce_scatter(
            t(inputs["rs"][rank])))
        out[key, "scatter"] = _np(dist.scatter(
            t(inputs["x"][0]), [t(a) for a in inputs["x"]] if rank == 0
            else None, src=0))
        out[key, "alltoall"] = [_np(p) for p in dist.alltoall(
            [t(a) for a in inputs["x"]])]
        dist.barrier()
    out["counts"] = dist.comm_monitor.monitor().comm_counts()
    out["backend"] = dist.comm.backend()
    out["device"] = str(dev)
    return out


def case_cuda_quantized(rank, inputs, tmpdir):
    """``quantized_allreduce`` of this rank's CUDA tensor (int8 and fp8,
    waited at once and issued without waiting), with the counts."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import quantized_comm as qc

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.tensor(inputs["x"][rank], device=dev)
    out = {}
    for dt in ("int8", "fp8"):
        out[dt] = _np(qc.quantized_allreduce(x, dtype=dt))
        out[dt, "async"] = _np(qc.quantized_allreduce(
            x, dtype=dt, async_op=True).wait())
    out["counts"] = dist.comm_monitor.monitor().comm_counts(by_group=True)
    return out


def case_cuda_gpt_block(rank, inputs, tmpdir):
    """``ParallelGPTBlock`` at mp2 on the card, through the kernels."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.ops import kernels

    _fleet(dp=1, mp=2)
    blk = dist.ParallelGPTBlock(inputs["d"], inputs["heads"], dropout=0.0)
    blk.set_state_dict(inputs["block"])
    kernels.reset_launches()
    res = _fwd_bwd(blk, inputs["x"], inputs["cot"], blk.ln1.weight.device)
    res["launches"] = kernels.launches()
    res["shapes"] = kernels.launch_shapes()
    return res



# ---------------------------------------------------------------------------
# gradient width: the dcn2 x ici2 world (tests/test_torch_quantized_comm.py)
# ---------------------------------------------------------------------------


def dense_net():
    """The JAX package's ``_DenseNet`` of its quantized-comm tests."""
    import paddle_tpu_torch as pt

    class DenseNet(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pt.nn.Linear(10, 16)
            self.fc2 = pt.nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(pt.nn.functional.relu(self.fc1(x)))

    return DenseNet()


def _recording(cls):
    """``cls`` whose ``_functional_update`` keeps the gradients it was
    given (after the reduction, the clip and the width cast), by name."""

    class Recording(cls):
        def _functional_update(self, params, grads, lr, t):
            self.seen.append({self._names[id(p)]: _np(g)
                              for p, g in zip(params, grads)
                              if g is not None})
            return super()._functional_update(params, grads, lr, t)

    return Recording


def _hier_strategy(quant, async_dcn, **kw):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hierarchical_allreduce = True
    s.hierarchical_allreduce_inter_nranks = 2
    s.async_dcn_allreduce = async_dcn
    if quant:
        s.quantized_allreduce = quant
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _hier_train(inputs, quant, async_dcn, steps=3):
    """The JAX package's TestHierarchicalQuantized program: the dense net,
    Momentum 0.1 / 0.9, cross entropy, ``steps`` batches of 16 (4 a rank)
    through fleet at dp4 = dcn2 x ici2 and ``TrainStep``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import comm_monitor, fleet

    s = _hier_strategy(quant, async_dcn)
    fleet.init(is_collective=True, strategy=s)
    net = dense_net()
    net.set_state_dict(inputs["dense_init"])
    model = fleet.distributed_model(net)
    opt = _recording(pt.optimizer.Momentum)(
        learning_rate=0.1, momentum=0.9,
        parameters=list(net.named_parameters()))
    opt.seen = []
    opt = fleet.distributed_optimizer(opt)
    step = pt.jit.TrainStep(
        model, lambda o, y: pt.nn.functional.cross_entropy(o, y), opt)
    mon = comm_monitor.monitor()
    mon.reset_counts()
    losses = [float(step(model.shard_input(x), model.shard_input(y)))
              for x, y in inputs["dense_data"][:steps]]
    return {"losses": losses,
            "params": {k: _np(v) for k, v in net.state_dict().items()},
            "grads": opt.seen[0],
            "flags": (step._async_dcn, step._hop is not None,
                      step._dcn_quant, opt._quant_explicit,
                      opt._comm_width_cast() is None),
            "counts": mon.comm_counts(by_group=True),
            "grad_comm": step._grad_comm_info}


def _hier_reuse(inputs):
    """One ``DataParallel`` model and one distributed optimizer through a
    step of the int8 async dcn hop, then a plain ``TrainStep`` and an
    eager backward pass on the same wrapper, each on the first batch at
    learning rate 0 (the parameters stay the initial ones): the gradients
    of the later two, the post-accumulate hooks on the parameters, and
    the optimizer's flags after the hop's step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True, strategy=_hier_strategy("int8", True))
    net = dense_net()
    net.set_state_dict(inputs["dense_init"])
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=0.0, parameters=net.parameters()))

    def loss_fn(o, y):
        return pt.nn.functional.cross_entropy(o, y)

    x, y = (model.shard_input(a) for a in inputs["dense_data"][0])
    pt.jit.TrainStep(model, loss_fn, opt)(x, y)
    out = {"flags": (opt._quant_explicit, opt._comm_width_cast() is None),
           "hooks": [len(p._post_accumulate_grad_hooks or {})
                     for p in net.parameters()]}
    plain = _recording(pt.optimizer.SGD)(
        learning_rate=0.0, parameters=list(net.named_parameters()))
    plain.seen = []
    pt.jit.TrainStep(model, loss_fn, plain)(x, y)
    out["plain"] = plain.seen[0]
    net.clear_gradients()
    loss_fn(model(x), y).backward()
    out["eager"] = {k: _np(p.grad) for k, p in net.named_parameters()}
    return out


def case_hierarchical(rank, inputs, tmpdir):
    """The hierarchical mesh, the quantized allreduce over the world and
    over dcn, and the dense net at dp4 = dcn2 x ici2: the dcn hop off,
    int8 and fp8 (per gradient, in backward), int8 without
    ``async_dcn_allreduce``, the policy off twice, and a ``DataParallel``
    wrapper reused after the hop's step."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import comm, fleet
    from paddle_tpu_torch.distributed import quantized_comm as qc

    out = {}
    fleet.init(is_collective=True, strategy=_hier_strategy(None, False))
    mesh = comm.hybrid_mesh()
    out["mesh"] = {"axis_names": mesh.axis_names, "dp_axes": comm.dp_axes(),
                   "dp_size": comm.dp_size(),
                   "coords": {a: mesh.axis_rank(a)
                              for a in ("dp", "dcn", "ici")},
                   "groups": {a: mesh.group(a).ranks
                              for a in ("dp", "data", "dcn", "ici")}}
    x = torch.tensor(inputs["qar"][rank])
    for dt in ("int8", "fp8"):
        out[f"qar_world_{dt}"] = _np(qc.quantized_allreduce(x, dtype=dt))
        out[f"qar_dcn_{dt}"] = _np(qc.quantized_allreduce(
            x, "dcn", dtype=dt))
    out["qar_sum"] = _np(qc.quantized_allreduce(x, mean=False))
    out["pmean_dcn"] = _np(qc.quantized_pmean(x, "dcn"))
    out["bf16"] = str(qc.quantized_allreduce(
        x.to(torch.bfloat16), "dcn").dtype)
    for name, quant, async_dcn in (("off", None, True),
                                   ("int8", "int8", True),
                                   ("fp8", "fp8", True),
                                   ("int8_tail", "int8", False),
                                   ("flat_off", None, False),
                                   ("flat_off2", None, False)):
        out[name] = _hier_train(inputs, quant, async_dcn)
    out["reuse"] = _hier_reuse(inputs)
    # what the strategy refuses at TrainStep, by message
    errs = {}
    for key, kw in (("async_flat", dict(hierarchical_allreduce=False)),
                    ("fp16_scaling", dict(amp=True, amp_configs={
                        "use_bf16": False}))):
        s = _hier_strategy("int8", True, **kw)
        net = dense_net()
        opt = pt.distributed.fleet.distributed_optimizer(
            pt.optimizer.SGD(learning_rate=0.1,
                             parameters=net.parameters()), strategy=s)
        try:
            pt.jit.TrainStep(net, lambda o, y: (o ** 2).mean(), opt)
        except (ValueError, NotImplementedError) as e:
            errs[key] = f"{type(e).__name__}: {e}"
    out["errors"] = errs
    return out


def case_hier_gpt_block(rank, inputs, tmpdir):
    """``ParallelGPTBlock`` at dcn2 x ici2 x mp2 (a world of 8): 2 Momentum
    steps with the dcn hop int8 and at full width, per gradient."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import ParallelGPTBlock, fleet

    out = {}
    for name, quant in (("int8", "int8"), ("off", None)):
        s = _hier_strategy(quant, True,
                           hybrid_configs={"dp_degree": 4, "mp_degree": 2})
        fleet.init(is_collective=True, strategy=s)
        net = ParallelGPTBlock(16, 4, dropout=0.0)
        net.set_state_dict(inputs["gpt_block"])
        model = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(pt.optimizer.Momentum(
            learning_rate=0.05, momentum=0.9, parameters=net.parameters()))
        step = pt.jit.TrainStep(
            model, lambda o, y: pt.nn.functional.cross_entropy(
                o.mean(axis=1), y), opt)
        out[name] = [float(step(model.shard_input(x), model.shard_input(y)))
                     for x, y in inputs["gpt_block_data"]]
    return out


# ---------------------------------------------------------------------------
# the strategy's optimizer options: ZeRO, gradient merge, recompute, the
# Lamb/Lars swaps, the overlap rings and LocalSGD
# (tests/test_torch_fleet_strategy.py, tests/test_torch_fleet_worlds.py)
# ---------------------------------------------------------------------------


def _strategy_world(degrees=None, **options):
    """``fleet.init`` of a fresh mesh of ``degrees`` (dp filling the rest
    of the world) under a strategy with ``options``."""
    from paddle_tpu_torch.distributed import comm, fleet

    comm._mesh = None
    s = fleet.DistributedStrategy()
    if degrees:
        s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    for k, v in options.items():
        setattr(s, k, v)
    fleet.init(is_collective=True, strategy=s)
    return s


def zero_net():
    """``test_sharding_gm``'s ``_Net``: fc1 [16, 24], relu, fc2 [24, 8]."""
    import paddle_tpu_torch as pt

    class Net(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pt.nn.Linear(16, 24)
            self.fc2 = pt.nn.Linear(24, 8)

        def forward(self, x):
            return self.fc2(pt.nn.functional.relu(self.fc1(x)))

    return Net()


def _nbytes(tensors):
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _moment_bytes(opt, params):
    inner = getattr(opt, "_inner", opt)
    ids = {id(p) for p in params}
    return _nbytes([v for name in ("moment1", "moment2")
                    for pid, v in inner._accumulators.get(name, {}).items()
                    if pid in ids])


def case_zero(rank, inputs, tmpdir):
    """ZeRO stages 1-3 over the world's dp (and stage 2 under the ``lamb``
    swap, and with a per-tensor clip) on ``zero_net`` through fleet and
    ``TrainStep`` with an L2 weight decay (Adam's; the swap drops it, as
    the JAX package's does) and a global-norm clip (``ClipGradByNorm``
    where the case says "norm"): losses, the full parameters after the
    steps, the bytes of Adam's moments and of the parameters this rank
    holds between steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import meta_parallel as M

    out = {}
    for name, stage, lamb, clip in inputs["zero_cases"]:
        _strategy_world(sharding=True, sharding_configs={"stage": stage},
                        lamb=lamb)
        net = zero_net()
        net.set_state_dict(inputs["zero_init"])
        fl = fleet.distributed_model(net)
        clip_cls = pt.nn.ClipGradByNorm if clip == "norm" \
            else pt.nn.ClipGradByGlobalNorm
        opt = fleet.distributed_optimizer(pt.optimizer.Adam(
            learning_rate=inputs["zero_lr"], parameters=net.parameters(),
            weight_decay=inputs["zero_wd"],
            grad_clip=clip_cls(inputs["zero_clip"])))
        step = pt.jit.TrainStep(fl, lambda o, y: pt.nn.functional
                                .cross_entropy(o, y), opt)
        losses = [float(step(fl.shard_input(x), fl.shard_input(y)))
                  for x, y in inputs["zero_data"]]
        params = list(net.parameters())
        out[name] = {
            "losses": losses,
            "inner": type(opt._inner).__name__,
            "moment_bytes": _moment_bytes(opt, params),
            "param_bytes": _nbytes(params),
            "shapes": {n: tuple(p.shape) for n, p in net.named_parameters()},
            "params": M.full_state_dict(net)}
    return out


def case_zero_embedding(rank, inputs, tmpdir):
    """ZeRO stage 3 over the world's dp on ``Embedding(30522, 10)``, whose
    axes 4 and 8 do not divide (the rows padded): two Adam steps, the
    checkpoint at logical shapes (the layer's and the optimizer's
    ``state_dict``), a shard refused by ``set_state_dict``, the checkpoint
    restored through ``set_state_dict`` and one more step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import meta_parallel as M
    from paddle_tpu_torch.distributed.parallel import shard_batch

    _strategy_world(sharding=True, sharding_configs={"stage": 3})
    emb = pt.nn.Embedding(*inputs["emb_shape"])
    emb.set_state_dict(inputs["emb_init"])
    opt = fleet.distributed_optimizer(pt.optimizer.Adam(
        learning_rate=0.1, parameters=emb.parameters()))
    step = pt.jit.TrainStep(emb, lambda o, y: (o ** 2).mean(), opt)
    ids = shard_batch(inputs["emb_ids"])
    out = {"losses": [float(step(ids, ids)) for _ in range(2)],
           "stored": tuple(emb.weight.shape),
           "param_bytes": _nbytes([emb.weight])}
    full = {k: _np(v) for k, v in emb.state_dict().items()}
    osd = {k: _np(v) for k, v in opt.state_dict().items()
           if k.endswith((".moment1", ".moment2"))}
    try:
        emb.set_state_dict({"weight": _np(emb.weight)})
        out["shard_refused"] = False
    except ValueError:
        out["shard_refused"] = True
    out.update(ckpt_shape=full["weight"].shape,
               moment_shapes={k: v.shape for k, v in osd.items()},
               moment1=[v for k, v in osd.items()
                        if k.endswith(".moment1")][0])
    if inputs.get("emb_restore", True):
        emb.set_state_dict(full)
        opt.set_state_dict(opt.state_dict())
    out["restored"] = tuple(emb.weight.shape)
    out["losses"].append(float(step(ids, ids)))
    out["weight"] = M.full_state_dict(emb)["weight"]
    return out


def case_rings(rank, inputs, tmpdir):
    """``ColumnParallelLinear(gather_output=True)`` into
    ``RowParallelLinear`` at mp2 (dp the rest of the world),
    ``PADDLE_TP_OVERLAP`` on and off:
    this rank's rows of the output and of the input's gradient, and the
    full weight gradients summed over dp, of ``sum(out ** 2)``."""
    import os

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import (ColumnParallelLinear,
                                              RowParallelLinear, collective,
                                              comm, overlap)

    _strategy_world(dict(mp=2))
    mesh = comm.hybrid_mesh()
    col = ColumnParallelLinear(*inputs["ring_col"], gather_output=True)
    row = RowParallelLinear(*inputs["ring_row"], input_is_parallel=False)
    pt.nn.Sequential(col, row).set_state_dict(inputs["ring_init"])
    d = mesh.axis_rank("dp")
    x_all = inputs["ring_x"]
    n = x_all.shape[0] // mesh.shape["dp"]
    out = {"rows": (d * n, (d + 1) * n)}
    calls = []
    rings = {name: getattr(overlap, name) for name in (
        "row_parallel_overlap", "column_gather_overlap")}
    for knob in ("1", "0"):
        os.environ["PADDLE_TP_OVERLAP"] = knob
        for name, fn in rings.items():
            def rec(*a, _fn=fn, _name=name, _knob=knob):
                calls.append((_knob, _name))
                return _fn(*a)

            setattr(overlap, name, rec)
        try:
            x = torch.tensor(x_all[d * n:(d + 1) * n],
                             device=col.weight.device, requires_grad=True)
            y = row(col(x))
            (y ** 2).sum().backward()
        finally:
            for name, fn in rings.items():
                setattr(overlap, name, fn)
        grads = {}
        for pname, p in (("col_w", col.weight), ("col_b", col.bias),
                         ("row_w", row.weight), ("row_b", row.bias)):
            g = collective.all_reduce_(p.grad.clone(),
                                       group=mesh.group("dp"))
            shard = getattr(p, "_tp_shard", None)
            grads[pname] = _np(shard.gather(g) if shard is not None else g)
            p.grad = None
        out[knob] = {"out": _np(y), "gx": _np(x.grad), "grads": grads}
    os.environ.pop("PADDLE_TP_OVERLAP")
    out["calls"] = calls
    return out


def case_c8_pipeline(rank, inputs, tmpdir):
    """``PipelineParallel.train_batch`` at pp2 (dp the rest of the world)
    through a fleet optimizer with ``fp16_allreduce``: the update takes the wrapper's
    width cast."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import meta_parallel as M

    _strategy_world(dict(pp=2), pipeline=True, fp16_allreduce=True,
                    pipeline_configs={"accumulate_steps": inputs["pp_micro"]})
    layer = pt.distributed.PipelineLayer(
        pipeline_blocks(*inputs["pp_cfg"]), loss_fn=pipeline_loss)
    layer.set_state_dict(inputs["pp_init"])
    model = fleet.distributed_model(layer)
    opt = fleet.distributed_optimizer(pt.optimizer.Momentum(
        learning_rate=inputs["pp_lr"], momentum=0.9,
        parameters=model.parameters()))
    losses = [float(model.train_batch([x, y], opt))
              for x, y in zip(inputs["pp_x"], inputs["pp_y"])]
    own = {id(p) for p in model.stage.params}
    named = dict(layer.named_parameters())
    return {"losses": losses, "stage": model.stage_id,
            "params": {k: v for k, v in M.full_state_dict(layer).items()
                       if id(named.get(k)) in own}}


def lars_mlp():
    """``ColumnParallelLinear(16, 24)``, relu, ``RowParallelLinear(24,
    8)``: every weight and the column bias mp shards."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import (ColumnParallelLinear,
                                              RowParallelLinear)

    class MLP(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.col = ColumnParallelLinear(16, 24, gather_output=False)
            self.row = RowParallelLinear(24, 8, input_is_parallel=True)

        def forward(self, x):
            return self.row(pt.nn.functional.relu(self.col(x)))

    return MLP()


def case_lars_mp(rank, inputs, tmpdir):
    """``lars`` swapping Momentum at mp2 (dp the rest of the world) on
    ``lars_mlp`` through fleet and ``TrainStep``, unsharded and with ZeRO
    stage 2 (the trust ratio's norms summed over the mp group, and over
    dp for the ZeRO shards): losses and the full parameters."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import meta_parallel as M

    out = {}
    for stage in (0, 2):
        _strategy_world(dict(mp=2), lars=True,
                        lars_configs=inputs["lars_configs"],
                        sharding=stage > 0, sharding_configs={"stage": 2})
        net = lars_mlp()
        net.set_state_dict(inputs["lars_init"])
        fl = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(pt.optimizer.Momentum(
            learning_rate=inputs["lars_lr"], momentum=0.9,
            parameters=net.parameters()))
        step = pt.jit.TrainStep(fl, lambda o, y: pt.nn.functional
                                .cross_entropy(o, y), opt)
        losses = [float(step(fl.shard_input(x), fl.shard_input(y)))
                  for x, y in inputs["zero_data"]]
        out[stage] = {"losses": losses, "inner": type(opt._inner).__name__,
                      "sharded": sum(getattr(p, "_zero_shard", None)
                                     is not None for p in net.parameters()),
                      "params": M.full_state_dict(net)}
    return out


def case_strategy_gpt(rank, inputs, tmpdir):
    """The GPT at mp2 (dp the rest of the world) through ``TrainStep``, two
    steps of ``lamb`` (swapping AdamW) with ZeRO stage 3,
    ``PADDLE_TP_OVERLAP`` and ``recompute`` on, and the same with all
    three off: losses, the full parameters, the parameter bytes held
    between steps and the blocks' forward calls a step."""
    import os

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import meta_parallel as M

    out = {}
    for name, on in (("on", True), ("off", False)):
        _strategy_world(dict(mp=2), lamb=True, recompute=on,
                        sharding=on, sharding_configs={"stage": 3})
        os.environ["PADDLE_TP_OVERLAP"] = "1" if on else "0"
        model = gpt(*inputs["gpt_cfg"])
        model.set_state_dict(inputs["gpt_init"])
        fwd = [0]
        for blk in model.blocks:
            blk.register_forward_pre_hook(
                lambda *a: fwd.__setitem__(0, fwd[0] + 1))
        fl = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=inputs["gpt_lr"], weight_decay=0.01,
            parameters=model.parameters()))
        step = pt.jit.TrainStep(fl, lm_loss(model), opt)
        ids, labels = inputs["gpt_batch"]
        losses = [float(step(fl.shard_input(ids), fl.shard_input(labels)))
                  for _ in range(2)]
        out[name] = {"losses": losses, "inner": type(opt._inner).__name__,
                     "forwards": fwd[0],
                     "param_bytes": _nbytes(model.parameters()),
                     "params": M.full_state_dict(model)}
    os.environ.pop("PADDLE_TP_OVERLAP")
    return out


def case_graft_gpt(rank, inputs, tmpdir):
    """``__graft_entry__.py``'s GPT: dp2 x pp2 x mp2, ZeRO-1 and
    ``gradient_merge`` k 2 over Adam, 1F1B over 2 microbatches, four
    ``train_batch`` calls (two merge boundaries): losses, this stage's
    parameters gathered over mp, and Adam's moment bytes here."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import meta_parallel as M
    from paddle_tpu_torch.distributed import ParallelGPTBlock

    _strategy_world(dict(dp=2, pp=2, mp=2), pipeline=True,
                    pipeline_configs={"accumulate_steps": 2},
                    sharding=True, sharding_configs={"stage": 1},
                    gradient_merge=True,
                    gradient_merge_configs={"k_steps": 2, "avg": True})
    D, H = inputs["graft_dh"]
    layer = pt.distributed.PipelineLayer(
        [ParallelGPTBlock(D, H, dropout=0.0) for _ in range(2)]
        + [pt.nn.Linear(D, 10)], loss_fn=pipeline_loss)
    layer.set_state_dict(inputs["graft_init"])
    model = fleet.distributed_model(layer)
    opt = fleet.distributed_optimizer(pt.optimizer.Adam(
        learning_rate=1e-3, parameters=model.parameters()))
    x, y = inputs["graft_x"], inputs["graft_y"]
    losses = [float(model.train_batch([x, y], opt)) for _ in range(4)]
    own = {id(p) for p in model.stage.params}
    named = dict(layer.named_parameters())
    return {"losses": losses, "stage": model.stage_id,
            "moment_bytes": _moment_bytes(opt, model.stage.params),
            "stage_bytes": _nbytes(model.stage.params),
            "params": {k: v for k, v in M.full_state_dict(layer).items()
                       if id(named.get(k)) in own}}


def case_graft_hier(rank, inputs, tmpdir):
    """``__graft_entry__.py``'s hierarchical composition: dp8 = dcn4 x ici2
    with ZeRO over Adam through ``TrainStep`` (three steps), at stage 1 (the
    dryrun's) and at stages 2 and 3 (the gradients reduce-scattered over
    the dcn hop, then the ici hop): losses and the parameters."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet

    from paddle_tpu_torch.distributed import meta_parallel as M

    out = {}
    for stage in (1, 2, 3):
        _strategy_world(hierarchical_allreduce=True,
                        hierarchical_allreduce_inter_nranks=2, sharding=True,
                        sharding_configs={"stage": stage})
        net = pt.nn.Sequential(pt.nn.Linear(32, 64), pt.nn.ReLU(),
                               pt.nn.Linear(64, 10))
        net.set_state_dict(inputs["hier_init"])
        fl = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(pt.optimizer.Adam(
            learning_rate=1e-3, parameters=net.parameters()))
        step = pt.jit.TrainStep(fl, lambda o, y: pt.nn.functional
                                .cross_entropy(o, y), opt)
        x = fl.shard_input(inputs["hier_x"])
        y = fl.shard_input(inputs["hier_y"])
        losses = [float(step(x, y)) for _ in range(3)]
        out[stage] = {
            "losses": losses, "axes": comm_axes(),
            "moment_bytes": _moment_bytes(opt, list(net.parameters())),
            "params": M.full_state_dict(net)}
    return out


def comm_axes():
    from paddle_tpu_torch.distributed import comm

    return comm.hybrid_mesh().axis_names


def case_localsgd(rank, inputs, tmpdir):
    """LocalSGD over SGD on ``Linear(3, 1)`` (the world's dp): k 1 against
    ``DataParallel`` SGD over the same steps; k 2: this rank's parameters
    after each step, and the ``state_dict`` after the last."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.localsgd import LocalSGDStep
    from paddle_tpu_torch.distributed.parallel import (DataParallel,
                                                       shard_batch)

    def mse(o, y):
        return ((o - y) * (o - y)).mean()

    xs, ys = inputs["ls_x"], inputs["ls_y"]
    out = {}
    _strategy_world()
    dp = DataParallel(pt.nn.Linear(3, 1))
    dp.set_state_dict(inputs["ls_init"])
    step = pt.jit.TrainStep(dp, mse, pt.optimizer.SGD(
        learning_rate=0.1, parameters=dp.parameters()))
    out["dp_losses"] = [float(step(dp.shard_input(x), dp.shard_input(y)))
                        for x, y in zip(xs, ys)]
    out["dp_w"] = _np(dp._layers.weight)
    for k in (1, 2):
        _strategy_world(localsgd=True, localsgd_configs={"k_steps": k})
        net = pt.nn.Linear(3, 1)
        net.set_state_dict(inputs["ls_init"])
        opt = fleet.distributed_optimizer(pt.optimizer.SGD(
            learning_rate=0.1, parameters=net.parameters()))
        step = pt.jit.TrainStep(net, mse, opt)
        assert isinstance(step, LocalSGDStep)
        losses, ws = [], []
        for x, y in zip(xs, ys):
            losses.append(float(step(shard_batch(x), shard_batch(y))))
            ws.append(_np(net.weight).copy())
        out[k] = {"losses": losses, "w": ws,
                  "state_w": _np(net.state_dict()["weight"])}
    return out
