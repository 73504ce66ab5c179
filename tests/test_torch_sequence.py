"""The port's LoD sequence ops (``ops/sequence.py``) against paddle_tpu's:
the module's 21 functions on the padded-plus-lengths form, each on the
same numpy inputs, outputs and the gradients of the float inputs (``check`` of
``test_torch_ops_math.py``: float32 ``rtol = atol = 1e-5``; integer
outputs exactly, the port's int64 against the JAX package's int32 by
value). Then the exports (top level and ``nn.functional``) and one op
recorded into a static program."""
import numpy as np
import pytest

import paddle_tpu

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from test_torch_ops_math import arr, check, cpu_device  # noqa: F401

LENS = np.array([3, 1, 4], np.int64)
PADDED = arr((3, 4, 2), seed=1)
ROWS = arr((8, 2), seed=2)
IDS = np.array([[5, 2, 7, 2], [1, 2, 3, 0], [2, 2, 9, 4]], np.int64)

CASES = {
    "mask": ("sequence_mask", (LENS,), dict(maxlen=6), False),
    "mask_no_maxlen": ("sequence_mask", (LENS,), dict(dtype="float32"),
                       False),
    "pad": ("sequence_pad", (ROWS, 0.5, 4, LENS), {}, True),
    "unpad": ("sequence_unpad", (PADDED, LENS), {}, True),
    "segment_sum": ("segment_sum", (arr((5, 3)), np.array([0, 0, 1, 3, 3])),
                    {}, True),
    "segment_mean": ("segment_mean",
                     (arr((5, 3)), np.array([0, 0, 1, 3, 3])), {}, True),
    "segment_max": ("segment_max",
                    (arr((5, 3)), np.array([0, 0, 1, 3, 3])), {}, True),
    "segment_min": ("segment_min",
                    (arr((5, 3)), np.array([0, 2, 2, 2, 3])), {}, True),
    "first_step": ("sequence_first_step", (PADDED, LENS), {}, True),
    "last_step": ("sequence_last_step", (PADDED, LENS), {}, True),
    "softmax": ("sequence_softmax", (arr((3, 4)), LENS), {}, True),
    "reverse": ("sequence_reverse", (PADDED, LENS), {}, True),
    "conv": ("sequence_conv", (arr((3, 4, 2)), arr((6, 5), seed=3), LENS,
                               3), {}, True),
    "conv_even_bias": ("sequence_conv", (arr((3, 4, 2)), arr((8, 5), seed=3),
                                         LENS, 4, None, arr((5,), seed=4)),
                       {}, True),
    "expand": ("sequence_expand", (arr((3, 2)), LENS), {}, True),
    "expand_as": ("sequence_expand_as", (arr((3, 2)), LENS), {}, True),
    "slice": ("sequence_slice", (PADDED, np.array([0, 0, 1]),
                                 np.array([2, 1, 3])), {}, True),
    "enumerate": ("sequence_enumerate", (IDS, 3), dict(
        pad_value=-1, lengths=pt.to_tensor(LENS, place="cpu")), False),
    "erase": ("sequence_erase", (IDS, (2, 9)), {}, False),
    "reshape": ("sequence_reshape", (arr((3, 4, 2)), np.array([2, 4, 2]),
                                     4), {}, True),
    "scatter": ("sequence_scatter", (arr((3, 6)), np.array(
        [[0, 2, 5], [1, 1, 0], [4, 3, 2]]), arr((3, 3), seed=5),
        np.array([3, 2, 1])), {}, True),
}
POOLS = ("sum", "average", "sqrt", "max", "min", "first", "last")


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_op(case):
    name, args, kw, grad = CASES[case]
    if "lengths" in kw:  # the reference's own tensor for its call
        kw_j = dict(kw, lengths=paddle_tpu.to_tensor(LENS))
        out_j = getattr(paddle_tpu, name)(paddle_tpu.to_tensor(args[0]),
                                          *args[1:], **kw_j)
        out_t = getattr(pt, name)(pt.to_tensor(args[0]), *args[1:], **kw)
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j._data))
        return
    check(name, *args, grad=grad, **kw)


@pytest.mark.parametrize("pool", POOLS)
def test_sequence_pool(pool):
    check("sequence_pool", PADDED, pool, LENS)


def test_sequence_erase_with_lengths():
    check("sequence_erase", IDS, (2,), np.array([4, 2, 3]), grad=False)


def test_sequence_concat():
    parts = [(arr((3, 2, 2), seed=6), np.array([1, 2, 0])),
             (arr((3, 3, 2), seed=7), np.array([3, 1, 2]))]
    outs = []
    for pkg in (paddle_tpu, pt):
        vals = [pkg.to_tensor(v, stop_gradient=False) for v, _ in parts]
        pairs = [(v, pkg.to_tensor(n)) for v, (_, n) in zip(vals, parts)]
        out, lens = pkg.sequence_concat(pairs)
        pkg.sum(out * pkg.to_tensor(arr((3, 5, 2), 0.5, 1.5, seed=8))
                ).backward()
        outs.append((out.numpy(), lens.numpy(),
                     [v.gradient() for v in vals]))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    for a, b in zip(outs[0][2], outs[1][2]):
        np.testing.assert_allclose(b, a, rtol=1e-6)


def test_sequence_names_exported_as_the_reference():
    from paddle_tpu.ops import sequence as jseq

    assert set(pt.sequence.__all__) == set(jseq.__all__)
    assert len(pt.sequence.__all__) == 21
    for n in jseq.__all__:
        assert getattr(pt, n) is getattr(pt.sequence, n), n
    for n in paddle_tpu.nn.functional._SEQUENCE_ALIASES:
        assert getattr(pt.nn.functional, n) is getattr(pt.sequence, n), n


def test_sequence_op_records_in_a_static_program():
    pt.enable_static()
    try:
        main = pt.static.Program()
        with pt.static.program_guard(main):
            x = pt.static.data("x", [-1, 4, 2], "float32")
            n = pt.static.data("n", [-1], "int64")
            y = pt.sequence_pool(x, "max", n)
        (got,) = pt.static.Executor().run(
            main, feed={"x": PADDED, "n": LENS}, fetch_list=[y])
    finally:
        pt.disable_static()
    assert len(main.ops) == 1
    want = pt.sequence_pool(pt.to_tensor(PADDED), "max", pt.to_tensor(LENS))
    np.testing.assert_array_equal(got, want.numpy())
