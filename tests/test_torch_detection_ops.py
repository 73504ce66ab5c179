"""``vision.ops``' detection ops against paddle_tpu's, on the same numpy
inputs: outputs, and input gradients of ``sum(out * w)`` (w seeded) where
the reference differentiates (``yolo_loss``, ``roi_align``, ``roi_pool``,
``box_coder``, ``iou_similarity``; ``yolo_box`` too). Tolerance 1e-5
(relative and absolute; ``yolo_box``'s image-scale boxes 1e-5 relative).
``multiclass_nms`` runs at ``nms_eta`` 1 and 0.7 with ``background_label``
-1 and 0; ``nms`` with scores, categories and ``top_k``; the matching ops
in both match types.
"""
import numpy as np
import pytest

import paddle_tpu
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.ops import pallas as jax_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from paddle_tpu.vision import ops as jops

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.vision import ops as tops

TOL = dict(rtol=1e-5, atol=1e-5)


def _fresh_process_state():
    jax_comm._state.hybrid_mesh = pt_comm._mesh = None
    jax_pallas.flash_attention = jax_fa


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    yield
    pt_device._current = saved
    _fresh_process_state()


def _to(pkg, v, grad):
    if isinstance(v, np.ndarray):
        return pkg.to_tensor(v, stop_gradient=not (grad and v.dtype.kind
                                                   == "f"))
    return v


def check(name, args, kwargs=None, diff=(), tol=TOL):
    """``vision.ops.<name>`` of both packages on numpy ``args``; the
    floating arguments at the indices ``diff`` get gradients compared."""
    kwargs = kwargs or {}
    jargs = [_to(paddle_tpu, a, i in diff) for i, a in enumerate(args)]
    targs = [_to(pt, a, i in diff) for i, a in enumerate(args)]
    jout = getattr(jops, name)(*jargs, **{
        k: _to(paddle_tpu, v, False) for k, v in kwargs.items()})
    tout = getattr(tops, name)(*targs, **{
        k: _to(pt, v, False) for k, v in kwargs.items()})
    jout = list(jout) if isinstance(jout, (tuple, list)) else [jout]
    tout = list(tout) if isinstance(tout, (tuple, list)) else [tout]
    assert len(jout) == len(tout), name
    for j, t in zip(jout, tout):
        jv, tv = np.asarray(j._data), t.numpy()
        assert jv.shape == tv.shape, (name, jv.shape, tv.shape)
        if jv.dtype.kind == "f":
            np.testing.assert_allclose(tv, jv, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(tv.astype(jv.dtype), jv,
                                          err_msg=name)
    if not diff:
        for t in tout:
            assert t.stop_gradient, name
        return tout
    r = np.random.RandomState(1)
    jl = tl = None
    for j, t in zip(jout, tout):
        jv = np.asarray(j._data)
        if jv.dtype.kind != "f":
            continue
        w = r.uniform(0.5, 1.5, jv.shape).astype(jv.dtype)
        ja = paddle_tpu.sum(j * paddle_tpu.to_tensor(w))
        ta = pt.sum(t * pt.to_tensor(w))
        jl, tl = (ja, ta) if jl is None else (jl + ja, tl + ta)
    jl.backward()
    tl.backward()
    for i in diff:
        jg, tg = jargs[i].gradient(), targs[i].gradient()
        shape = np.shape(args[i])
        jg = np.zeros(shape) if jg is None else jg
        tg = np.zeros(shape) if tg is None else tg
        np.testing.assert_allclose(tg, jg, err_msg=f"{name} grad {i}",
                                   **tol)
    return tout


R = np.random.RandomState(0)
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
X_HEAD = R.randn(2, 3 * (5 + 4), 5, 6).astype(np.float32)
IMG = np.array([[160, 192], [128, 150]], np.int32)
GT = (R.rand(2, 5, 4) * 0.5 + 0.1).astype(np.float32)
GT[1, 3:] = 0.0                                   # padded gt rows
LABEL = R.randint(0, 4, (2, 5)).astype(np.int32)
SCORE = R.uniform(0.5, 1.0, (2, 5)).astype(np.float32)


@pytest.mark.parametrize("clip", [True, False])
def test_yolo_box(clip):
    check("yolo_box", [X_HEAD, IMG, ANCHORS[:6], 4, 0.3, 32],
          dict(clip_bbox=clip, scale_x_y=1.05), diff=(0,),
          tol=dict(rtol=1e-5, atol=3e-5))


@pytest.mark.parametrize("smooth,score", [(True, None), (False, SCORE)])
def test_yolo_loss(smooth, score):
    check("yolo_loss", [X_HEAD, GT, LABEL, ANCHORS, [3, 4, 5], 4, 0.5, 32],
          dict(use_label_smooth=smooth, scale_x_y=1.1, gt_score=score),
          diff=(0,))


def test_prior_box():
    feat = np.zeros((1, 3, 6, 7), np.float32)
    img = np.zeros((1, 3, 60, 70), np.float32)
    for order in (False, True):
        check("prior_box", [feat, img, [20.0, 40.0], [40.0, 60.0],
                            [1.0, 2.0, 0.5]],
              dict(flip=True, clip=True, min_max_aspect_ratios_order=order))


def test_anchor_generator():
    feat = np.zeros((1, 3, 6, 7), np.float32)
    check("anchor_generator", [feat, [32, 64, 128], [0.5, 1.0, 2.0]],
          dict(stride=(16.0, 8.0)))


def _corner_boxes(n, seed, scale=1.0):
    r = np.random.RandomState(seed)
    lo = r.rand(n, 2) * 0.6 * scale
    wh = (r.rand(n, 2) * 0.3 + 0.05) * scale
    return np.concatenate([lo, lo + wh], 1).astype(np.float32)


PRIORS = _corner_boxes(6, 1)
PVAR = np.full((6, 4), 0.1, np.float32)
PVAR[:, 2:] = 0.2


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode(normalized):
    check("box_coder", [PRIORS * 10, PVAR, _corner_boxes(3, 2) * 10,
                        "encode_center_size", normalized],
          diff=(0, 2))


@pytest.mark.parametrize("axis", [0, 1])
def test_box_coder_decode(axis):
    deltas = (np.random.RandomState(3).randn(6, 6, 4) * 0.2).astype(
        np.float32)
    check("box_coder", [PRIORS, PVAR, deltas, "decode_center_size"],
          dict(axis=axis), diff=(0, 2))


def test_iou_similarity():
    for normalized in (True, False):
        check("iou_similarity", [_corner_boxes(5, 4) * 20,
                                 _corner_boxes(4, 5) * 20],
              dict(box_normalized=normalized), diff=(0, 1))


def test_box_clip():
    boxes = (np.random.RandomState(6).rand(2, 5, 4) * 120 - 10).astype(
        np.float32)
    info = np.array([[50, 60, 1.0], [80, 40, 2.0]], np.float32)
    check("box_clip", [boxes, info])
    check("box_clip", [boxes[0], info[:1]])


FEAT = np.random.RandomState(7).randn(2, 3, 10, 12).astype(np.float32)
ROIS = np.array([[1, 1, 6, 7], [0, 2, 11, 9], [-3, -2, 4, 5],
                 [2.5, 3.2, 8.1, 9.9], [5, 5, 5.5, 5.5],
                 [9, 7, 20, 16]], np.float32)
ROIS_NUM = np.array([4, 2], np.int32)


@pytest.mark.parametrize("aligned,ratio", [(True, -1), (False, 3)])
def test_roi_align(aligned, ratio):
    check("roi_align", [FEAT, ROIS * 2, ROIS_NUM, (3, 2)],
          dict(spatial_scale=0.5, sampling_ratio=ratio, aligned=aligned),
          diff=(0, 1))


def test_roi_align_samples_outside_are_zero():
    """The named departure: a roi wholly outside [-1, H] x [-1, W] pools
    exactly zero (not a border replica), in both packages."""
    far = np.array([[40, 40, 50, 50]], np.float32)
    out = check("roi_align", [FEAT[:1], far, np.array([1], np.int32), 2])
    assert not out[0].numpy().any()


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_pool(scale):
    check("roi_pool", [FEAT, ROIS / scale, ROIS_NUM, 3],
          dict(spatial_scale=scale), diff=(0,))


def test_roi_pool_chunks_agree(monkeypatch):
    """Rois taken a few at a time (the bound on memory) give the same
    pooling and gradient as all at once."""
    def pooled():
        x = pt.to_tensor(FEAT, stop_gradient=False)
        out = tops.roi_pool(x, pt.to_tensor(ROIS), pt.to_tensor(ROIS_NUM), 3)
        (out * out).sum().backward()
        return out.numpy(), x.gradient()

    full = pooled()
    monkeypatch.setattr(tops, "_ROI_CHUNK_ELEMS", 3 * 10 * 12 * 2)
    chunked = pooled()
    for a, b in zip(chunked, full):
        np.testing.assert_array_equal(a, b)


NMS_BOXES = _corner_boxes(30, 8, scale=50.0)
NMS_BOXES = np.stack([NMS_BOXES, _corner_boxes(30, 9, scale=50.0)])
NMS_SCORES = np.random.RandomState(10).rand(2, 4, 30).astype(np.float32)


@pytest.mark.parametrize("eta", [1.0, 0.7])
@pytest.mark.parametrize("background", [-1, 0])
def test_multiclass_nms(eta, background):
    out, counts = check(
        "multiclass_nms", [NMS_BOXES, NMS_SCORES, 0.05, 10, 12, 0.3, False,
                           eta, background])
    assert counts.numpy().dtype == np.int32
    labels = out.numpy()[..., 0]
    if background == 0:
        assert not (labels == 0).any()


def test_multiclass_nms_eta_changes_the_kept_set():
    a = tops.multiclass_nms(pt.to_tensor(NMS_BOXES),
                            pt.to_tensor(NMS_SCORES), 0.05, 20, 80, 0.9,
                            False, 1.0, -1)[1].numpy()
    b = tops.multiclass_nms(pt.to_tensor(NMS_BOXES),
                            pt.to_tensor(NMS_SCORES), 0.05, 20, 80, 0.9,
                            False, 0.5, -1)[1].numpy()
    assert (b <= a).all() and (b < a).any()


@pytest.mark.parametrize("match_type,thresh", [("bipartite", None),
                                               ("per_prediction", 0.3)])
def test_bipartite_match(match_type, thresh):
    dist = np.random.RandomState(11).rand(2, 4, 7).astype(np.float32)
    dist[0, 2] = 0.0                       # a gt that matches nothing
    check("bipartite_match", [dist, match_type, thresh])
    check("bipartite_match", [dist[1], match_type, thresh])


def test_target_assign():
    dist = np.random.RandomState(12).rand(2, 4, 7).astype(np.float32)
    idx = np.asarray(jops.bipartite_match(paddle_tpu.to_tensor(dist))[0]
                     ._data)
    targets = np.random.RandomState(13).randn(2, 4, 3).astype(np.float32)
    check("target_assign", [targets, idx], dict(mismatch_value=-1.0))


@pytest.mark.parametrize("case", ["scores", "order", "categories"])
def test_nms(case):
    boxes = NMS_BOXES[0]
    kw = {}
    args = [boxes, 0.3]
    if case in ("scores", "categories"):
        args.append(NMS_SCORES[0, 0])
    if case == "categories":
        cats = np.random.RandomState(14).randint(0, 3, 30)
        args += [cats, [0, 1, 2]]
        kw["top_k"] = 6
    out = check("nms", args, kw)[0].numpy()
    assert out.dtype == np.int64 and len(set(out.tolist())) == len(out)


def test_detection_ops_are_the_reference_names():
    want = {n for n in jops.__all__}
    assert want <= set(tops.__all__)
