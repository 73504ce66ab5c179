"""One rank of ``paddle_tpu_torch.distributed.launch(reshard="shrink")``
(tests/test_torch_elastic.py): a net under Adam through
``resharding.ElasticStep`` on the CPU over gloo, on the global batches of
``$TORCH_ELASTIC_DIR/inputs.pkl``. Rank ``$TORCH_ELASTIC_EXIT`` leaves
after step ``$TORCH_ELASTIC_AFTER``, as ``$TORCH_ELASTIC_MODE`` says:

- ``exit`` (default): it exits 7 after the step; the launcher retires it
  and sends the survivors its notice, and they reshard at the next
  boundary (or inside the step whose collective failed).
- ``mid``: it exits 7 inside the next step's loss, once every survivor
  has entered that step's loss, so the survivors' gradient reduction
  fails: they reshard inside the step and run its batch again.
- ``boundary``: every rank calls ``notify_departure`` before the next
  step (the same transition at a boundary, with no failure); the rank
  that is out exits 0.

``$TORCH_ELASTIC_NET`` is ``plain`` (``torch_world.reshard_net``, the
state of ``rs_init``) or ``bn`` (the same widths with BatchNorm1D and
Dropout, initialised from ``pt.seed(0)``: a forward that mutates buffers
and draws from the random stream). Each survivor writes its losses, its
``reshard`` rows and its final state to ``$TORCH_ELASTIC_DIR/rank<r>.json``.
"""
import json
import os
import pickle
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import resharding
    from helpers import torch_world as tw

    out_dir = os.environ["TORCH_ELASTIC_DIR"]
    exit_rank = int(os.environ["TORCH_ELASTIC_EXIT"])
    after = int(os.environ["TORCH_ELASTIC_AFTER"])
    mode = os.environ.get("TORCH_ELASTIC_MODE", "exit")
    pt.set_device("cpu")
    dist.init_parallel_env(device="cpu")
    rank = dist.get_rank()
    world = dist.get_world_size()
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    if os.environ.get("TORCH_ELASTIC_NET", "plain") == "bn":
        pt.seed(0)
        net = pt.nn.Sequential(
            pt.nn.Linear(16, 32), pt.nn.BatchNorm1D(32), pt.nn.ReLU(),
            pt.nn.Dropout(0.5), pt.nn.Linear(32, 10))
    else:
        net = tw.reshard_net()
        net.set_state_dict(inputs["rs_init"])
    step_no = [0]

    def marker(r):
        return os.path.join(out_dir, f"entered.r{r}")

    def loss_fn(o, y):
        if mode == "mid" and step_no[0] == after:
            if rank == exit_rank:
                others = [r for r in range(world) if r != exit_rank]
                while not all(os.path.exists(marker(r)) for r in others):
                    time.sleep(0.01)
                os._exit(7)
            open(marker(rank), "w").close()
        return tw._ce_loss(o, y)

    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters())
    estep = resharding.ElasticStep(
        pt.jit.TrainStep(net, loss_fn, opt), policy="shrink")
    losses = []
    for i, (x, y) in enumerate(inputs["rs_data"]):
        step_no[0] = i
        if mode == "boundary" and i == after:
            estep.notify_departure([exit_rank])
        loss = estep(estep.shard_input(x), estep.shard_input(y))
        if loss is None:
            break
        losses.append(float(loss))
        if mode == "exit" and rank == exit_rank and i + 1 == after:
            os._exit(7)
    if estep.out:
        dist.comm.destroy_parallel_env()
        return
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "rows": estep.rows,
                   "dp": estep.dp_size(),
                   "state": {k: v.numpy().tolist()
                             for k, v in net.state_dict().items()}}, f)
    dist.comm.destroy_parallel_env()


if __name__ == "__main__":
    main()
