"""The strategy's rings and ZeRO on the card: worlds of 4 ranks sharing
the one card over gloo (``helpers/torch_world.py``, every tensor a CUDA
tensor), against the same programs on the CPU in this process. Run on the
card with ``python -m pytest tests/test_torch_cuda_strategy.py -m cuda
--noconftest``; elsewhere they skip.

- ``ColumnParallelLinear`` into ``RowParallelLinear`` at dp2 x mp2 with
  ``PADDLE_TP_OVERLAP`` on takes both rings and gives the plain layers'
  output and gradients within 1e-5 of each largest value.
- ZeRO stages 1, 2 and 3 at dp4 (and stage 2 under the ``lamb`` swap) on
  ``zero_net`` through ``TrainStep``: losses within 1e-5 and parameters
  (stage 3's gathered from their shards) within rtol 1e-5 / atol 1e-6 of
  the unsharded step on the CPU over the global batches; Adam's moments a
  quarter of the unsharded bytes a rank, and at stage 3 the parameters.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from helpers import torch_world as tw

pytestmark = pytest.mark.cuda

#: name, stage, the lamb swap, the clip (``helpers.torch_world.case_zero``)
ZERO_CASES = (("s1", 1, False, "global"), ("s2", 2, False, "global"),
              ("s3", 3, False, "global"), ("s2_lamb", 2, True, "global"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _near(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def test_rings_on_the_card(card, tmp_path):
    rng = np.random.RandomState(0)
    f = np.float32
    inputs = {"ring_col": (16, 24), "ring_row": (24, 16),
              "ring_x": (rng.rand(8, 16) - 0.5).astype(f),
              "ring_init": {"0.weight": (rng.rand(16, 24) - 0.5).astype(f),
                            "0.bias": rng.rand(24).astype(f),
                            "1.weight": (rng.rand(24, 16) - 0.5).astype(f),
                            "1.bias": rng.rand(16).astype(f)}}
    out = tw.run_world(["rings"], str(tmp_path), inputs, nprocs=4,
                       device="gpu")
    for r, o in enumerate(out["rings"]):
        assert sorted(set(o["calls"])) == [
            ("1", "column_gather_overlap"), ("1", "row_parallel_overlap")]
        on, off = o["1"], o["0"]
        _near(on["out"], off["out"], 1e-5, f"out rank {r}")
        _near(on["gx"], off["gx"], 1e-5, f"gx rank {r}")
        for k in off["grads"]:
            _near(on["grads"][k], off["grads"][k], 1e-5, f"{k} rank {r}")


def _unsharded_cpu(init, data, lamb):
    """The unsharded step on the CPU over the global batches."""
    saved = pt_device._current
    pt.set_device("cpu")
    try:
        net = tw.zero_net()
        net.set_state_dict(init)
        clip = pt.nn.ClipGradByGlobalNorm(0.1)
        opt = pt.optimizer.Lamb(learning_rate=0.01, lamb_weight_decay=0.01,
                                parameters=net.parameters(),
                                grad_clip=clip) if lamb else \
            pt.optimizer.Adam(learning_rate=0.01, weight_decay=0.01,
                              parameters=net.parameters(), grad_clip=clip)
        step = pt.jit.TrainStep(net, lambda o, y: pt.nn.functional
                                .cross_entropy(o, y), opt)
        losses = [float(step(x, y)) for x, y in data]
        return losses, {k: v.detach().numpy().copy()
                        for k, v in net.state_dict().items()}
    finally:
        pt_device._current = saved


def test_zero_stages_on_the_card(card, tmp_path):
    saved = pt_device._current
    pt.set_device("cpu")
    try:
        pt.seed(2)
        init = {k: v.detach().numpy().copy()
                for k, v in tw.zero_net().state_dict().items()}
    finally:
        pt_device._current = saved
    rng = np.random.RandomState(9)
    data = [(rng.rand(8, 16).astype(np.float32),
             rng.randint(0, 8, (8,)).astype(np.int64)) for _ in range(3)]
    out = tw.run_world(["zero"], str(tmp_path), {
        "zero_cases": ZERO_CASES, "zero_init": init, "zero_lr": 0.01,
        "zero_clip": 0.1, "zero_wd": 0.01, "zero_data": data}, nprocs=4,
        device="gpu")
    full = sum(v.size * 4 for v in init.values())
    for lamb in (False, True):
        losses, params = _unsharded_cpu(init, data, lamb)
        for name, stage, is_lamb, _ in ZERO_CASES:
            if is_lamb != lamb:
                continue
            for r, o in enumerate(out["zero"]):
                got = o[name]
                np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                           err_msg=f"{name} rank {r}")
                for k, v in params.items():
                    np.testing.assert_allclose(
                        got["params"][k], v, rtol=1e-5, atol=1e-6,
                        err_msg=f"{name} {k} rank {r}")
                assert got["moment_bytes"] == 2 * full // 4
                assert got["param_bytes"] == (full // 4 if stage == 3
                                              else full)
