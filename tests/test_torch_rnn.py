"""The port's recurrent layers (``nn/layers/rnn.py``) and ``F.rnn`` /
``F.birnn`` against paddle_tpu's.

Each case builds the layer in both packages, carries the reference's
weights into the port's by ``set_state_dict`` of its numpy state dict
(``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_*``, the ``_reverse``
ones), feeds the same seeded numpy inputs and initial states, and
compares every output and state within rtol 1e-5 / atol 1e-6, then the
gradients of ``sum(out * w)`` for the inputs, the initial states and each
parameter within 1e-5 of their largest value (``compare`` of
``test_torch_nn_activation.py``). JAX runs the time loop as
``lax.scan``, the port as a torch loop: the same sums, in float32.

Also: ``test_nn.py::test_lstm_gru_shapes`` and
``test_lstm_interlayer_dropout_active`` as oracles, the inter-layer
dropout's draws (between layers from the layer's generator, none inside
the time loop), and a 2-layer, d 128 slice of the PTB language model
that ``chip_smoke.py`` trains at full width.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from chip_smoke import ptb_lm, ptb_loss
from test_torch_nn_activation import carry, compare
from test_torch_ops_math import arr, cpu_device  # noqa: F401

B, T, I, H = 3, 5, 4, 6


def flat(out):
    """``(out, states)`` with nested state tuples -> a flat tuple."""
    if isinstance(out, (tuple, list)):
        return tuple(v for o in out for v in flat(o))
    return (out,)


def pair(cls, *args, **kw):
    """The class of both packages, the reference's weights carried; the
    port's parameter names must be the reference's."""
    jl, tl = getattr(jnn, cls)(*args, **kw), getattr(tnn, cls)(*args, **kw)
    assert [n for n, _ in jl.named_parameters()] == \
        [n for n, _ in tl.named_parameters()]
    return jl, tl, carry(jl, tl)


# -- cells ----------------------------------------------------------------------

CELLS = [("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
         ("LSTMCell", {}), ("GRUCell", {})]


@pytest.mark.parametrize("cls,kw", CELLS,
                         ids=["rnn_tanh", "rnn_relu", "lstm", "gru"])
@pytest.mark.parametrize("with_states", [False, True],
                         ids=["zero_states", "given_states"])
def test_cell(cls, kw, with_states):
    jl, tl, params = pair(cls, I, H, **kw)
    x = arr((B, I), seed=1)
    h = arr((B, H), seed=2)
    c = arr((B, H), seed=3)
    lstm = cls == "LSTMCell"
    if not with_states:
        compare(lambda a: flat(jl(a)), lambda a: flat(tl(a)), (x,),
                params=params)
    elif lstm:
        compare(lambda a, s, t: flat(jl(a, (s, t))),
                lambda a, s, t: flat(tl(a, (s, t))), (x, h, c),
                params=params)
    else:
        compare(lambda a, s: flat(jl(a, s)), lambda a, s: flat(tl(a, s)),
                (x, h), params=params)


def test_cell_initial_states():
    for cls in ("LSTMCell", "GRUCell"):
        jl, tl, _ = pair(cls, I, H)
        x = arr((B, I))
        js = jl.get_initial_states(paddle_tpu.to_tensor(x), init_value=0.5)
        ts = tl.get_initial_states(pt.to_tensor(x), init_value=0.5)
        for a, b in zip(flat(js), flat(ts)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a._data))


# -- the stacked layers -----------------------------------------------------------

LAYERS = [
    ("SimpleRNN", dict(num_layers=2)),
    ("SimpleRNN", dict(activation="relu", direction="bidirect")),
    ("LSTM", dict(num_layers=2)),
    ("LSTM", dict(num_layers=2, direction="bidirect")),
    ("LSTM", dict(time_major=True, direction="bidirectional")),
    ("GRU", dict(num_layers=2)),
    ("GRU", dict(num_layers=2, direction="bidirect", time_major=True)),
]


@pytest.mark.parametrize("cls,kw", LAYERS, ids=[
    f"{c}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for c, kw in LAYERS])
@pytest.mark.parametrize("with_states", [False, True],
                         ids=["zero_states", "given_states"])
def test_layer(cls, kw, with_states):
    jl, tl, params = pair(cls, I, H, **kw)
    L = kw.get("num_layers", 1) * (1 if kw.get("direction", "forward")
                                   == "forward" else 2)
    x = arr((T, B, I) if kw.get("time_major") else (B, T, I), seed=4)
    h, c = arr((L, B, H), seed=5), arr((L, B, H), seed=6)
    if not with_states:
        compare(lambda a: flat(jl(a)), lambda a: flat(tl(a)), (x,),
                params=params)
    elif cls == "LSTM":
        compare(lambda a, s, t: flat(jl(a, (s, t))),
                lambda a, s, t: flat(tl(a, (s, t))), (x, h, c),
                params=params)
    else:
        compare(lambda a, s: flat(jl(a, s)), lambda a, s: flat(tl(a, s)),
                (x, h), params=params)


def test_sequence_length_is_taken_as_in_the_reference():
    """``sequence_length`` is accepted and, as in the JAX package, not
    applied: the outputs equal the call without it."""
    jl, tl, params = pair("GRU", I, H)
    lens = np.array([5, 3, 1], np.int64)
    compare(lambda a: flat(jl(a, sequence_length=paddle_tpu.to_tensor(
        lens))), lambda a: flat(tl(a, sequence_length=pt.to_tensor(lens))),
        (arr((B, T, I)),), params=params)
    x = pt.to_tensor(arr((B, T, I)))
    np.testing.assert_array_equal(
        tl(x, sequence_length=pt.to_tensor(lens))[0].numpy(),
        tl(x)[0].numpy())


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
@pytest.mark.parametrize("wrap", ["RNN", "RNN_reverse", "BiRNN"])
def test_cell_wrappers(cell, wrap):
    """``RNN(cell)`` (forward, reversed, time-major) and ``BiRNN`` over
    carried cells."""
    jc, tc, params = pair(cell, I, H)
    x = arr((T, B, I), seed=7)
    if wrap == "BiRNN":
        jc2, tc2, params2 = pair(cell, I, H)
        jw, tw = jnn.BiRNN(jc, jc2, True), tnn.BiRNN(tc, tc2, True)
        params = params + params2
    else:
        rev = wrap == "RNN_reverse"
        jw, tw = jnn.RNN(jc, rev, True), tnn.RNN(tc, rev, True)
    compare(lambda a: flat(jw(a)), lambda a: flat(tw(a)), (x,),
            params=params)


def test_functional_rnn_and_birnn():
    jc, tc, params = pair("LSTMCell", I, H)
    jc2, tc2, params2 = pair("GRUCell", I, H)
    x = arr((B, T, I), seed=8)
    compare(lambda a: flat(JF.rnn(jc, a, is_reverse=True)),
            lambda a: flat(TF.rnn(tc, a, is_reverse=True)), (x,),
            params=params)
    compare(lambda a: flat(JF.birnn(jc, jc2, a)),
            lambda a: flat(TF.birnn(tc, tc2, a)), (x,),
            params=params + params2)


# -- the oracles of test_nn.py ------------------------------------------------------


def test_lstm_gru_shapes():
    """``test_nn.py::test_lstm_gru_shapes`` on the port."""
    pt.seed(0)
    lstm = tnn.LSTM(8, 16, num_layers=2)
    x = pt.randn([4, 5, 8])
    out, (h, c) = lstm(x)
    assert out.shape == [4, 5, 16]
    assert h.shape == [2, 4, 16] and c.shape == [2, 4, 16]
    gru = tnn.GRU(8, 16, direction="bidirect")
    out, h = gru(x)
    assert out.shape == [4, 5, 32] and h.shape == [2, 4, 16]
    out.sum().backward()
    assert gru.weight_ih_l0.grad is not None
    with pytest.raises(ValueError):
        tnn.LSTM(I, H, direction="sideways")


def test_lstm_interlayer_dropout_active():
    """``test_nn.py::test_lstm_interlayer_dropout_active`` on the port,
    and where the masks come from: one draw of the layer's generator per
    inner layer boundary (none inside the time loop, none after the last
    layer); in eval, none at all."""
    pt.seed(5)
    gen = torch.Generator().manual_seed(3)
    lstm = tnn.LSTM(4, 8, num_layers=3, dropout=0.5, generator=gen)
    lstm.train()
    x = pt.randn([2, 6, 4])
    calls = []
    real = torch.rand

    def counted(*a, **kw):
        calls.append(kw.get("generator"))
        return real(*a, **kw)

    torch.rand = counted
    try:
        a = lstm(x)[0].numpy()
        n_train = len(calls)
        b = lstm(x)[0].numpy()
        lstm.eval()
        c = lstm(x)[0].numpy()
        d = lstm(x)[0].numpy()
    finally:
        torch.rand = real
    assert not np.allclose(a, b)  # stochastic between calls
    np.testing.assert_allclose(c, d)
    assert n_train == 2 and len(calls) == 4
    assert all(g is gen for g in calls)
    # dropout 0 (or eval) is the reference's function exactly
    jl, tl, params = pair("LSTM", I, H, num_layers=2, dropout=0.5)
    jl.eval()
    tl.eval()
    compare(lambda v: flat(jl(v)), lambda v: flat(tl(v)), (arr((B, T, I)),),
            params=params)


# -- the PTB language model's slice ------------------------------------------------


def test_ptb_lm_slice_matches():
    """``chip_smoke.py``'s PTB language model script (``ptb_lm``,
    ``ptb_loss``) at vocab 50, 2 layers, d 128, 7 steps, batch 4, float32,
    dropout off, on the same weights in both packages: the loss and every
    gradient of one step within 1e-5 of the largest, then one ``SGD(1.0)``
    step under ``ClipGradByGlobalNorm(5.0)``: the updated weights within
    rtol 1e-5 / atol 1e-6."""
    V, D, S, Bn = 50, 128, 7, 4
    ids = np.random.RandomState(0).randint(0, V, (Bn, S + 1))
    jm, tm = (ptb_lm(pkg, V, D, 2, 0.0) for pkg in (paddle_tpu, pt))
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    assert tm.set_state_dict(state) == ([], [])
    h0 = np.zeros((2, Bn, D), np.float32)
    losses, grads = [], []
    for pkg, m in ((paddle_tpu, jm), (pt, tm)):
        opt = pkg.optimizer.SGD(
            learning_rate=1.0, parameters=m.parameters(),
            grad_clip=pkg.nn.ClipGradByGlobalNorm(5.0))
        logits, h, c = m(pkg.to_tensor(ids[:, :-1]), pkg.to_tensor(h0),
                         pkg.to_tensor(h0))
        loss = ptb_loss(pkg, logits, pkg.to_tensor(ids[:, 1:]), V)
        loss.backward()
        losses.append(float(loss.numpy()))
        grads.append({n: np.asarray(p.gradient())
                      for n, p in m.named_parameters()})
        opt.step()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for n, g in grads[0].items():
        err = np.abs(grads[1][n] - g).max()
        assert err <= 1e-5 * np.abs(g).max(), (n, err)
    jp = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), jp[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
