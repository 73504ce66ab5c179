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

