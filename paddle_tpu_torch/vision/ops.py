"""paddle.vision.ops — the detection ops (counterpart of
``paddle_tpu/vision/ops.py``; reference: python/paddle/vision/ops.py over
operators/detection/*.h, deformable_conv_op.h, roi_align_op,
roi_pool_op).

The JAX package writes them as plain ``jnp`` programs (no Pallas kernel),
so torch ops are their port: the YOLOv3 head (``yolo_box``, ``yolo_loss``),
the SSD and RPN priors (``prior_box``, ``anchor_generator``), box coding
and clipping (``box_coder``, ``box_clip``, ``iou_similarity``), matching
(``bipartite_match``, ``target_assign``), RoI pooling (``roi_align``,
``roi_pool``), NMS (``multiclass_nms`` with fixed-size output, ``nms``
with the kept indices) and the deformable convolution (``deform_conv2d``,
``DeformConv2D``). Shapes stay static wherever the JAX package keeps them
static; the loops that the JAX package writes as ``lax.scan`` /
``fori_loop`` (greedy NMS, bipartite matching) stay sequential in their
step and run vectorised over images and classes. ``yolo_loss``,
``roi_align``, ``roi_pool``, ``box_coder``, ``iou_similarity``,
``yolo_box`` and ``deform_conv2d`` are differentiable; the matching, NMS
and prior ops give results without gradient, as the JAX package's
``apply_nondiff`` does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.tensor import Tensor, tensor_boundary
from ..nn.initializer import XavierNormal
from ..nn.layer import Layer

__all__ = ["yolo_loss", "yolo_box", "deform_conv2d", "DeformConv2D",
           "prior_box", "box_coder", "roi_align", "multiclass_nms",
           "iou_similarity", "box_clip", "anchor_generator",
           "bipartite_match", "target_assign", "nms", "roi_pool"]


def _op(fn):
    """``tensor_boundary`` that also takes numpy arrays (as ``Tensor`` on
    the current device), as the JAX package's ops take raw arrays."""
    inner = tensor_boundary(fn)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        args = [Tensor(a) if isinstance(a, np.ndarray) else a for a in args]
        kwargs = {k: Tensor(v) if isinstance(v, np.ndarray) else v
                  for k, v in kwargs.items()}
        return inner(*args, **kwargs)

    return call



def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@tensor_boundary
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (mask=None) / v2 (modulated)
    (deformable_conv_op.h parity: per-tap offsets, channel layout
    [dg * kh * kw * 2] with the h-offset before the w-offset, bilinear
    sampling that reads 0 outside [-1, H] x [-1, W]).

    x [N, Cin, H, W]; offset [N, 2*dg*kh*kw, Ho, Wo]; mask
    [N, dg*kh*kw, Ho, Wo]; weight [Cout, Cin/groups, kh, kw]."""
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    N, Cin, H, W = x.shape
    Cout, Cin_g, kh, kw = weight.shape
    Ho = (H + 2 * p[0] - (d[0] * (kh - 1) + 1)) // s[0] + 1
    Wo = (W + 2 * p[1] - (d[1] * (kw - 1) + 1)) // s[1] + 1
    dg = deformable_groups
    dev = x.device
    off = offset.reshape(N, dg, kh * kw, 2, Ho, Wo)
    base_h = (torch.arange(Ho, device=dev) * s[0] - p[0])[
        None, None, None, :, None]
    base_w = (torch.arange(Wo, device=dev) * s[1] - p[1])[
        None, None, None, None, :]
    ks_h = torch.repeat_interleave(torch.arange(kh, device=dev) * d[0], kw)
    ks_w = (torch.arange(kw, device=dev) * d[1]).repeat(kh)
    hh = base_h + ks_h[None, None, :, None, None] + off[:, :, :, 0]
    ww = base_w + ks_w[None, None, :, None, None] + off[:, :, :, 1]
    h0, w0 = torch.floor(hh), torch.floor(ww)
    dh, dw = hh - h0, ww - w0
    imgd = x.reshape(N, dg, Cin // dg, H, W)
    ni = torch.arange(N, device=dev)[:, None, None, None, None]
    di = torch.arange(dg, device=dev)[None, :, None, None, None]
    samples = 0.0
    for ih, wgt_h in ((h0, 1 - dh), (h0 + 1, dh)):
        for iw, wgt_w in ((w0, 1 - dw), (w0 + 1, dw)):
            inb = ((ih > -1) & (ih < H) & (iw > -1) & (iw < W)
                   & (hh > -1) & (hh < H) & (ww > -1) & (ww < W))
            ci = ih.clamp(0, H - 1).long()
            cj = iw.clamp(0, W - 1).long()
            # [N, dg, T, Ho, Wo, C/dg], as jnp's advanced indexing gives
            val = imgd.permute(0, 1, 3, 4, 2)[ni, di, ci, cj]
            wgt = wgt_h * wgt_w * inb.to(x.dtype)
            samples = samples + val * wgt[..., None]
    if mask is not None:
        samples = samples * mask.reshape(N, dg, kh * kw, Ho, Wo)[..., None]
    samples = samples.movedim(-1, 2).reshape(N, Cin, kh * kw, Ho, Wo)
    wr = weight.reshape(groups, Cout // groups, Cin_g, kh * kw)
    sg = samples.reshape(N, groups, Cin // groups, kh * kw, Ho, Wo)
    out = torch.einsum("ngctxy,goct->ngoxy", sg, wr).reshape(N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class DeformConv2D(Layer):
    """paddle.vision.ops.DeformConv2D: the layer over
    :func:`deform_conv2d`, weights made like Conv2D's (XavierNormal);
    offsets and mask are forward inputs."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        k = _pair(kernel_size)
        self._cfg = dict(stride=stride, padding=padding, dilation=dilation,
                         deformable_groups=deformable_groups, groups=groups)
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups, k[0], k[1]],
            attr=weight_attr, default_initializer=XavierNormal())
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, mask=mask,
                              **self._cfg)


# ---------------------------------------------------------------------------
# YOLOv3 (yolo_box_op.h, yolov3_loss_op.h)
# ---------------------------------------------------------------------------


def _sce(x, label):
    """SigmoidCrossEntropy(x, label) (yolov3_loss_op.h)."""
    return x.clamp(min=0.0) - x * label + torch.log1p(torch.exp(-x.abs()))


def _iou_xywh(b1, b2):
    """IoU of center-format boxes; b1 [..., 4], b2 [..., 4] broadcast."""
    lo = torch.maximum(b1[..., :2] - b1[..., 2:] / 2,
                       b2[..., :2] - b2[..., 2:] / 2)
    hi = torch.minimum(b1[..., :2] + b1[..., 2:] / 2,
                       b2[..., :2] + b2[..., 2:] / 2)
    wh = (hi - lo).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = b1[..., 2] * b1[..., 3] + b2[..., 2] * b2[..., 3] - inter
    return inter / union.clamp(min=1e-10)


@_op
def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0):
    """Decode a YOLOv3 head into boxes and scores (yolo_box_op.h
    GetYoloBox / CalcDetectionBox / CalcLabelScore).

    x [N, an_num * (5 + class_num), H, W]; img_size [N, 2] (h, w). Returns
    (boxes [N, an_num*H*W, 4] x1y1x2y2 in image scale, scores [N,
    an_num*H*W, class_num]); a box below ``conf_thresh`` is all zeros."""
    anc = np.asarray(anchors, np.float32).reshape(-1, 2)
    an_num = anc.shape[0]
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    N, _, H, W = x.shape
    dev, dt = x.device, x.dtype
    in_h, in_w = downsample_ratio * H, downsample_ratio * W
    xr = x.reshape(N, an_num, 5 + class_num, H, W)
    img_h = img_size[:, 0].to(dt)[:, None, None, None]
    img_w = img_size[:, 1].to(dt)[:, None, None, None]
    gx = torch.arange(W, dtype=dt, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=dt, device=dev)[None, None, :, None]
    cx = (gx + torch.sigmoid(xr[:, :, 0]) * scale + bias) * img_w / W
    cy = (gy + torch.sigmoid(xr[:, :, 1]) * scale + bias) * img_h / H
    anc_t = torch.as_tensor(anc, dtype=dt, device=dev)
    bw = torch.exp(xr[:, :, 2]) * anc_t[:, 0][None, :, None, None] \
        * img_w / in_w
    bh = torch.exp(xr[:, :, 3]) * anc_t[:, 1][None, :, None, None] \
        * img_h / in_h
    x1, y1 = cx - bw / 2, cy - bh / 2
    x2, y2 = cx + bw / 2, cy + bh / 2
    if clip_bbox:
        x1 = x1.clamp(min=0.0)
        y1 = y1.clamp(min=0.0)
        x2 = torch.minimum(x2, img_w - 1)
        y2 = torch.minimum(y2, img_h - 1)
    conf = torch.sigmoid(xr[:, :, 4])
    keep = (conf >= conf_thresh).to(dt)[..., None]
    boxes = torch.stack([x1, y1, x2, y2], dim=-1) * keep
    scores = conf[..., None] * torch.sigmoid(xr[:, :, 5:].movedim(2, -1))
    scores = scores * keep
    return (boxes.reshape(N, an_num * H * W, 4),
            scores.reshape(N, an_num * H * W, class_num))


@_op
def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 loss (yolov3_loss_op.h Yolov3LossKernel): per image, the sum
    of the location loss (SCE x/y and L1 w/h, scaled by (2 - gw*gh) *
    score), the classification loss (per-class SCE, label smoothing
    optional) and the objectness loss (positive cells target 1 weighted by
    score, negatives 0, predictions whose best gt IoU exceeds
    ``ignore_thresh`` left out).

    x [N, mask_num * (5 + class_num), H, W]; gt_box [N, B, 4] center
    format in relative coordinates; gt_label [N, B]; returns loss [N]."""
    anchors_full = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask = list(anchor_mask)
    mask_num = len(mask)
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    if use_label_smooth:
        delta = 1.0 / max(class_num, 1)
        pos_l, neg_l = 1.0 - delta, delta
    else:
        pos_l, neg_l = 1.0, 0.0
    N, _, H, W = x.shape
    B = gt_box.shape[1]
    dev, dt = x.device, x.dtype
    in_size = downsample_ratio * H
    gtb = gt_box.to(dt)
    score = gt_score.to(dt) if gt_score is not None \
        else torch.ones((N, B), dtype=dt, device=dev)
    xr = x.reshape(N, mask_num, 5 + class_num, H, W)
    valid = (gtb[..., 2] > 0) & (gtb[..., 3] > 0)              # [N, B]
    anc_full = torch.as_tensor(anchors_full, dtype=dt, device=dev)
    anc_m = anc_full[torch.as_tensor(mask, device=dev)]

    # predicted boxes (relative coordinates) for the ignore mask
    gx = torch.arange(W, dtype=dt, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=dt, device=dev)[None, None, :, None]
    px = (gx + torch.sigmoid(xr[:, :, 0]) * scale + bias) / W
    py = (gy + torch.sigmoid(xr[:, :, 1]) * scale + bias) / H
    pw = torch.exp(xr[:, :, 2]) * anc_m[:, 0][None, :, None, None] / in_size
    ph = torch.exp(xr[:, :, 3]) * anc_m[:, 1][None, :, None, None] / in_size
    pred = torch.stack([px, py, pw, ph], dim=-1)               # [N,m,H,W,4]
    ious = _iou_xywh(pred[:, :, :, :, None, :],
                     gtb[:, None, None, None, :, :])           # [N,m,H,W,B]
    ious = torch.where(valid[:, None, None, None, :], ious,
                       torch.zeros_like(ious))
    ignore = ious.amax(dim=-1) > ignore_thresh                 # [N,m,H,W]

    # gt -> anchor: the best anchor of the full set by centred IoU
    gwh = gtb[..., 2:]
    aw = anc_full[:, 0] / in_size
    ah = anc_full[:, 1] / in_size
    inter = torch.minimum(gwh[..., 0][..., None], aw) * torch.minimum(
        gwh[..., 1][..., None], ah)
    union = (gwh[..., 0] * gwh[..., 1])[..., None] + aw * ah - inter
    an_iou = inter / union.clamp(min=1e-10)                    # [N,B,A]
    best_n = an_iou.argmax(dim=-1)                             # [N,B]
    mask_arr = torch.as_tensor(mask, device=dev)
    in_mask = best_n[..., None] == mask_arr[None, None, :]
    mask_idx = in_mask.int().argmax(dim=-1)                    # first match
    is_pos = in_mask.any(dim=-1) & valid

    gi = (gtb[..., 0] * W).to(torch.int64).clamp(0, W - 1)
    gj = (gtb[..., 1] * H).to(torch.int64).clamp(0, H - 1)
    bidx = torch.arange(N, device=dev)[:, None].expand(N, B)
    sel = xr[bidx, mask_idx, :, gj, gi]                        # [N,B,5+cls]
    tx = gtb[..., 0] * W - gi
    ty = gtb[..., 1] * H - gj
    tw = torch.log((gtb[..., 2] * in_size
                    / anc_m[:, 0][mask_idx]).clamp(min=1e-9))
    th = torch.log((gtb[..., 3] * in_size
                    / anc_m[:, 1][mask_idx]).clamp(min=1e-9))
    loc_scale = (2.0 - gtb[..., 2] * gtb[..., 3]) * score
    loc = (_sce(sel[..., 0], tx) + _sce(sel[..., 1], ty)
           + (sel[..., 2] - tw).abs() + (sel[..., 3] - th).abs()) * loc_scale
    cls_targets = torch.where(
        torch.arange(class_num, device=dev)[None, None, :]
        == gt_label.to(torch.int64)[..., None],
        torch.full((), pos_l, dtype=dt, device=dev),
        torch.full((), neg_l, dtype=dt, device=dev))
    cls = _sce(sel[..., 5:], cls_targets).sum(-1) * score
    per_gt = torch.where(is_pos, loc + cls, torch.zeros_like(loc))
    loss = per_gt.sum(dim=1)                                   # [N]

    # objectness targets: positive scores scattered (only positive rows
    # write; duplicates average), ignored cells -1
    obj = torch.where(ignore, -1.0, 0.0).to(dt)
    at = (bidx, mask_idx, gj, gi)
    pos_sum = torch.zeros_like(obj).index_put(
        at, torch.where(is_pos, score, torch.zeros_like(score)),
        accumulate=True)
    pos_cnt = torch.zeros_like(obj).index_put(
        at, is_pos.to(dt), accumulate=True)
    obj = torch.where(pos_cnt > 0, pos_sum / pos_cnt.clamp(min=1.0), obj)
    obj_pred = xr[:, :, 4]
    obj_loss = torch.where(
        obj > 1e-5, _sce(obj_pred, 1.0) * obj,
        torch.where(obj > -0.5, _sce(obj_pred, 0.0),
                    torch.zeros_like(obj_pred)))
    return loss + obj_loss.sum(dim=(1, 2, 3))


# ---------------------------------------------------------------------------
# priors, box coding (prior_box_op.h, anchor_generator_op.h, box_coder_op.h,
# box_clip_op.h, iou_similarity_op.h)
# ---------------------------------------------------------------------------


def _device_of(t):
    return t._data.device if isinstance(t, Tensor) else \
        torch.as_tensor(t).device


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes (prior_box_op.h). input [N, C, H, W] feature map,
    image [N, C, IH, IW]. Returns (boxes [H, W, P, 4] normalized
    xmin/ymin/xmax/ymax, variances [H, W, P, 4]), without gradient."""
    H, W = int(input.shape[2]), int(input.shape[3])
    IH, IW = int(image.shape[2]), int(image.shape[3])
    dev = _device_of(input)
    step_w = steps[0] or IW / W
    step_h = steps[1] or IH / H
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    # (w, h) of each prior in the reference's order
    whs = []
    for i, ms in enumerate(min_sizes):
        ms = float(ms)
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                bs = float(np.sqrt(ms * float(max_sizes[i])))
                whs.append((bs, bs))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
            if max_sizes:
                bs = float(np.sqrt(ms * float(max_sizes[i])))
                whs.append((bs, bs))
    wh = torch.as_tensor(np.asarray(whs, np.float32), device=dev)  # [P, 2]
    P = wh.shape[0]
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    cxg, cyg = cxg[..., None], cyg[..., None]
    half_w = wh[None, None, :, 0] / 2.0
    half_h = wh[None, None, :, 1] / 2.0
    boxes = torch.stack([(cxg - half_w) / IW, (cyg - half_h) / IH,
                         (cxg + half_w) / IW, (cyg + half_h) / IH], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = torch.as_tensor(np.asarray(variance, np.float32),
                          device=dev).expand(H, W, P, 4).contiguous()
    return Tensor._wrap(boxes), Tensor._wrap(var)


@_op
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """box_coder_op.h: encode corner boxes against priors into centre-size
    offsets, or decode offsets back to corners.

    encode: prior [M, 4], target [N, 4] -> [N, M, 4]
    decode: prior [M, 4], target [N, M, 4] (or [N, 4], broadcast along
            ``axis``) -> [N, M, 4]."""
    norm_off = 0.0 if box_normalized else 1.0
    p, t, v = prior_box, target_box, prior_box_var

    def prior_cs(q):
        pw = q[..., 2] - q[..., 0] + norm_off
        ph = q[..., 3] - q[..., 1] + norm_off
        return pw, ph, q[..., 0] + pw / 2.0, q[..., 1] + ph / 2.0

    if code_type == "encode_center_size":
        pw, ph, pcx, pcy = prior_cs(p[None, :, :])             # [1, M]
        tw = t[:, None, 2] - t[:, None, 0] + norm_off
        th = t[:, None, 3] - t[:, None, 1] + norm_off
        tcx = t[:, None, 0] + tw / 2.0
        tcy = t[:, None, 1] + th / 2.0
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], dim=-1)
        if v is not None:
            out = out / v[None, :, :]
        return out
    if code_type == "decode_center_size":
        pw, ph, pcx, pcy = prior_cs(p[None, :, :] if axis == 0
                                    else p[:, None, :])
        tt = t if t.dim() == 3 else t[:, None, :]
        if v is not None:
            tt = tt * (v[None, :, :] if axis == 0 else v[:, None, :])
        cx = tt[..., 0] * pw + pcx
        cy = tt[..., 1] * ph + pcy
        w = torch.exp(tt[..., 2]) * pw
        h = torch.exp(tt[..., 3]) * ph
        return torch.stack([cx - w / 2.0, cy - h / 2.0,
                            cx + w / 2.0 - norm_off,
                            cy + h / 2.0 - norm_off], dim=-1)
    raise ValueError(f"unknown code_type {code_type!r}")


@_op
def iou_similarity(x, y, box_normalized=True, name=None):
    """iou_similarity_op.h: pairwise IoU of corner boxes, x [N, 4] against
    y [M, 4] -> [N, M]."""
    off = 0.0 if box_normalized else 1.0
    ax1, ay1, ax2, ay2 = (x[:, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (y[None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + off).clamp(
        min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + off).clamp(
        min=0)
    inter = iw * ih
    area_a = (ax2 - ax1 + off) * (ay2 - ay1 + off)
    area_b = (bx2 - bx1 + off) * (by2 - by1 + off)
    return inter / (area_a + area_b - inter).clamp(min=1e-10)


@_op
def box_clip(input, im_info, name=None):
    """box_clip_op.h: clip corner boxes to the image. input [N, M, 4] (or
    [M, 4]); im_info [N, 3] rows (height, width, scale): boxes clip to
    [0, round(dim / scale) - 1] (bbox_util.h ClipTiledBoxes)."""
    boxes = input[None] if input.dim() == 2 else input
    h = torch.round(im_info[:, 0] / im_info[:, 2]) - 1.0
    w = torch.round(im_info[:, 1] / im_info[:, 2]) - 1.0
    zero = torch.zeros_like(w)[:, None]
    out = torch.stack([
        boxes[..., 0].clamp(min=zero, max=w[:, None]),
        boxes[..., 1].clamp(min=zero, max=h[:, None]),
        boxes[..., 2].clamp(min=zero, max=w[:, None]),
        boxes[..., 3].clamp(min=zero, max=h[:, None])], dim=-1)
    return out[0] if input.dim() == 2 else out


def anchor_generator(input, anchor_sizes, aspect_ratios,
                     variances=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    """anchor_generator_op.h (RPN anchors): one anchor per (size, ratio)
    at every cell, unnormalized xmin/ymin/xmax/ymax. Returns (anchors
    [H, W, A, 4], variances [H, W, A, 4]), without gradient."""
    H, W = int(input.shape[2]), int(input.shape[3])
    dev = _device_of(input)
    sw, sh = float(stride[0]), float(stride[1])
    # base extents from the stride's area, rounded, scaled by size/stride;
    # the ratio loop outer, the size loop inner
    whs = []
    for r in aspect_ratios:
        base_w = float(np.round(np.sqrt(sw * sh / float(r))))
        base_h = float(np.round(base_w * float(r)))
        for s in anchor_sizes:
            whs.append((float(s) / sw * base_w, float(s) / sh * base_h))
    wh = torch.as_tensor(np.asarray(whs, np.float32), device=dev)
    A = wh.shape[0]
    cx = torch.arange(W, dtype=torch.float32, device=dev) * sw \
        + offset * (sw - 1.0)
    cy = torch.arange(H, dtype=torch.float32, device=dev) * sh \
        + offset * (sh - 1.0)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    cxg, cyg = cxg[..., None], cyg[..., None]
    hw = 0.5 * (wh[None, None, :, 0] - 1.0)
    hh = 0.5 * (wh[None, None, :, 1] - 1.0)
    anchors = torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
    var = torch.as_tensor(np.asarray(variances, np.float32),
                          device=dev).expand(H, W, A, 4).contiguous()
    return Tensor._wrap(anchors), Tensor._wrap(var)


# ---------------------------------------------------------------------------
# RoI pooling (roi_align_op, roi_pool_op)
# ---------------------------------------------------------------------------


def _div(a, n):
    """``a / n`` correctly rounded on either device: CUDA divides by a
    Python scalar through its reciprocal, which can move a floor or ceil
    at a bin edge by one cell."""
    return a / torch.full((), float(n), dtype=a.dtype, device=a.device)


def _size2(output_size):
    if isinstance(output_size, int):
        return int(output_size), int(output_size)
    return int(output_size[0]), int(output_size[1])


def _roi_images(boxes_num, N, R, device):
    """The image index of each of the R rois (``boxes_num`` rows of
    ``boxes`` per image), without a host read."""
    bn = torch.as_tensor(boxes_num, device=device).to(torch.int64)
    return torch.repeat_interleave(torch.arange(N, device=device), bn,
                                   output_size=R)


@_op
def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """roi_align_op: bilinear-sampled RoI pooling, differentiable in the
    feature map and the boxes. x [N, C, H, W]; boxes [R, 4] (x1, y1, x2,
    y2); boxes_num [N] rows of ``boxes`` per image. Out [R, C, out_h,
    out_w]: the mean of ``sampling_ratio`` x ``sampling_ratio`` samples a
    bin (2 x 2 when ``sampling_ratio`` <= 0).

    Departure from upstream Paddle, as the JAX package has it
    (``paddle_tpu/vision/ops.py:531-541``): a sample outside [-1, H] x
    [-1, W] is exactly zero (the CUDA kernel's early return), not a
    border-clamped replica; inside that window the coordinates clamp to
    the border; and the grid is a fixed ``sampling_ratio`` (2 when not
    given) per bin rather than upstream's adaptive ceil(roi / bin)."""
    out_h, out_w = _size2(output_size)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    dev = x.device
    img = _roi_images(boxes_num, N, R, dev)
    off = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - off
    y1 = boxes[:, 1] * spatial_scale - off
    x2 = boxes[:, 2] * spatial_scale - off
    y2 = boxes[:, 3] * spatial_scale - off
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    gy = _div(torch.arange(out_h * sr, device=dev, dtype=x.dtype) + 0.5, sr)
    gx = _div(torch.arange(out_w * sr, device=dev, dtype=x.dtype) + 0.5, sr)
    yy = y1[:, None] + _div(rh[:, None], out_h) * gy[None, :]  # [R, oh*sr]
    xx = x1[:, None] + _div(rw[:, None], out_w) * gx[None, :]  # [R, ow*sr]
    vy = (yy >= -1.0) & (yy <= H)
    vx = (xx >= -1.0) & (xx <= W)
    y0 = torch.floor(yy).clamp(0, H - 1)
    x0 = torch.floor(xx).clamp(0, W - 1)
    y1i = (y0 + 1).clamp(0, H - 1).long()
    x1i = (x0 + 1).clamp(0, W - 1).long()
    wy1 = (yy.clamp(0, H - 1) - y0)[:, None, :, None]
    wx1 = (xx.clamp(0, W - 1) - x0)[:, None, None, :]
    y0i, x0i = y0.long(), x0.long()
    r = img[:, None, None]

    def at(yi, xi):
        # [R, oh*sr, ow*sr, C] -> [R, C, oh*sr, ow*sr]; no [R, C, H, W]
        # copy of the feature map
        return x[r, :, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2)

    out = (at(y0i, x0i) * (1 - wy1) * (1 - wx1)
           + at(y0i, x1i) * (1 - wy1) * wx1
           + at(y1i, x0i) * wy1 * (1 - wx1)
           + at(y1i, x1i) * wy1 * wx1)
    out = out * (vy[:, None, :, None] & vx[:, None, None, :])
    return out.reshape(R, C, out_h, sr, out_w, sr).mean(dim=(3, 5))


def _window_max(src, lo, hi, size, dim_len):
    """Max of ``src`` [R, C, L, M] along dim 2 over each roi's windows
    [lo, hi) (lo, hi: [R, K] ints, clipped to [0, dim_len]). Returns
    [R, C, K, M], -inf for an empty window. The windows are gathered
    ``size`` wide (the widest window) and masked."""
    R, C, _, M = src.shape
    K = lo.shape[1]
    idx = lo[:, :, None] + torch.arange(size, device=src.device)
    inside = idx < hi[:, :, None]                              # [R, K, size]
    idx = idx.clamp(max=dim_len - 1).reshape(R, 1, K * size, 1)
    got = torch.gather(src, 2, idx.expand(R, C, K * size, M)).reshape(
        R, C, K, size, M)
    neg = torch.full((), float("-inf"), dtype=src.dtype, device=src.device)
    return torch.where(inside[:, None, :, :, None], got, neg).amax(dim=3)


#: elements of one chunk of rois' feature maps in ``roi_pool``
_ROI_CHUNK_ELEMS = 1 << 27


@_op
def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """roi_pool_op: quantized max pooling over each RoI (integer bin
    boundaries, max, not a bilinear mean). x [N, C, H, W]; boxes [R, 4];
    boxes_num [N]. Out [R, C, oh, ow]; an empty bin is 0. Differentiable
    through the max.

    Bin [i, j] covers rows floor(y1 + i h / oh) .. ceil(y1 + (i + 1) h /
    oh) and the columns likewise (clipped to the map), as the JAX
    package's mask does. The max is taken in two passes, over each bin's
    columns and then its rows, a chunk of rois at a time (at most
    ``_ROI_CHUNK_ELEMS`` elements of their maps), so memory stays
    bounded at any roi count."""
    out_h, out_w = _size2(output_size)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    dev = x.device
    img = _roi_images(boxes_num, N, R, dev)
    with torch.no_grad():
        rx1 = torch.round(boxes[:, 0] * spatial_scale)
        ry1 = torch.round(boxes[:, 1] * spatial_scale)
        rx2 = torch.round(boxes[:, 2] * spatial_scale)
        ry2 = torch.round(boxes[:, 3] * spatial_scale)
        rw = (rx2 - rx1 + 1).clamp(min=1.0)
        rh = (ry2 - ry1 + 1).clamp(min=1.0)
        i = torch.arange(out_h, dtype=rx1.dtype, device=dev)
        j = torch.arange(out_w, dtype=rx1.dtype, device=dev)
        y_lo = torch.floor(ry1[:, None] + _div(i * rh[:, None], out_h))
        y_hi = torch.ceil(ry1[:, None] + _div((i + 1) * rh[:, None], out_h))
        x_lo = torch.floor(rx1[:, None] + _div(j * rw[:, None], out_w))
        x_hi = torch.ceil(rx1[:, None] + _div((j + 1) * rw[:, None], out_w))
        y_lo, y_hi = y_lo.clamp(0, H).long(), y_hi.clamp(0, H).long()
        x_lo, x_hi = x_lo.clamp(0, W).long(), x_hi.clamp(0, W).long()
        # the widest window sets the gather width (one host read)
        bw = max(int((x_hi - x_lo).max()), 1) if R else 1
        bh = max(int((y_hi - y_lo).max()), 1) if R else 1
    chunk = max(_ROI_CHUNK_ELEMS // max(C * H * W, 1), 1)
    parts = []
    for c0 in range(0, R, chunk):
        c1 = min(c0 + chunk, R)
        maps = x[img[c0:c1]].transpose(2, 3)              # [r, C, W, H]
        cols = _window_max(maps, x_lo[c0:c1], x_hi[c0:c1], bw, W)
        parts.append(_window_max(cols.transpose(2, 3), y_lo[c0:c1],
                                 y_hi[c0:c1], bh, H))     # [r, C, oh, ow]
    pooled = torch.cat(parts) if parts else x.new_zeros(
        (0, C, out_h, out_w))
    empty = (y_hi <= y_lo)[:, :, None] | (x_hi <= x_lo)[:, None, :]
    return torch.where(empty[:, None], torch.zeros_like(pooled), pooled)


# ---------------------------------------------------------------------------
# NMS and matching (multiclass_nms_op.cc, bipartite_match_op.cc,
# target_assign_op, python/paddle/vision/ops.py nms)
# ---------------------------------------------------------------------------


def _top_k(s, k):
    """``lax.top_k``: the k largest along the last dim, in descending
    order, ties to the lower index (a stable sort, the same on either
    device)."""
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pair_iou(b, off):
    """IoU of every pair of corner boxes b [..., K, 4] -> [..., K, K]."""
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    area = (x2 - x1 + off) * (y2 - y1 + off)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :]) + off).clamp(
        min=0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :]) + off).clamp(
        min=0)
    inter = iw * ih
    return inter / (area[..., :, None] + area[..., None, :] - inter).clamp(
        min=1e-10)


@_op
def multiclass_nms(bboxes, scores, score_threshold, nms_top_k,
                   keep_top_k, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    """multiclass_nms_op.cc with fixed-size output: per class, the score
    filter, the top ``nms_top_k``, greedy IoU suppression; then the
    classes merge and the top ``keep_top_k`` stay. Returns (out [N,
    keep_top_k, 6] rows [label, score, x1, y1, x2, y2], label -1 for an
    empty slot; valid counts [N] int32), without gradient.

    bboxes [N, M, 4]; scores [N, C, M]. The greedy pass is sequential in
    the K candidates (the JAX package's ``lax.scan``) and vectorised over
    images and classes: one step tests candidate i of every (image,
    class) against the kept ones before it.

    Departure from upstream Paddle, as the JAX package has it
    (``paddle_tpu/vision/ops.py:611-640``): with ``nms_eta`` < 1 the
    threshold adapts per class as each box is KEPT (``thresh *= eta``
    while it is above 0.5), in the one greedy pass over the sorted list
    (upstream NMSFast decays it in its own loop)."""
    off = 0.0 if normalized else 1.0
    eta = float(nms_eta)
    N, C, M = scores.shape
    dev = scores.device
    with torch.no_grad():
        K = min(int(nms_top_k), M)
        s = torch.where(scores > score_threshold, scores,
                        torch.full((), -1.0, dtype=scores.dtype,
                                   device=dev))
        top_s, idx = _top_k(s, K)                              # [N, C, K]
        cand = torch.gather(bboxes[:, None].expand(N, C, M, 4), 2,
                            idx[..., None].expand(N, C, K, 4))
        iou = _pair_iou(cand, off)                             # [N,C,K,K]
        kept = torch.zeros((N, C, K), dtype=torch.bool, device=dev)
        thresh = torch.full((N, C), float(nms_threshold),
                            dtype=torch.float32, device=dev)
        for i in range(K):
            # suppressed by a kept, higher-scoring box overlapping > thresh
            over = (iou[:, :, i, :i] > thresh[..., None]) & kept[:, :, :i]
            keep_i = ~over.any(dim=-1) & (top_s[:, :, i] > 0)
            kept[:, :, i] = keep_i
            if eta < 1.0:
                thresh = torch.where(keep_i & (thresh > 0.5),
                                     thresh * eta, thresh)
        cls_s = torch.where(kept, top_s, torch.full(
            (), -1.0, dtype=top_s.dtype, device=dev))
        labels = torch.arange(C, device=dev)[None, :, None].expand(N, C, K)
        flat_s = cls_s.reshape(N, C * K)
        if background_label >= 0:
            flat_s = torch.where(labels.reshape(N, -1) == background_label,
                                 torch.full((), -1.0, dtype=flat_s.dtype,
                                            device=dev), flat_s)
        kk = min(int(keep_top_k), C * K)
        sel_s, sel = _top_k(flat_s, kk)                         # [N, kk]
        sel_l = torch.gather(labels.reshape(N, -1), 1, sel)
        sel_i = torch.gather(idx.reshape(N, -1), 1, sel)
        sel_b = torch.gather(bboxes, 1, sel_i[..., None].expand(N, kk, 4))
        valid = sel_s > 0
        out = torch.cat([
            torch.where(valid, sel_l, -1).to(torch.float32)[..., None],
            torch.where(valid, sel_s, torch.zeros_like(sel_s))[..., None],
            torch.where(valid[..., None], sel_b, torch.zeros_like(sel_b))],
            dim=-1)
        return out, valid.sum(dim=-1).to(torch.int32)


@_op
def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=None, name=None):
    """bipartite_match_op.cc: greedy global matching on a [N, num_gt,
    num_prior] (or [num_gt, num_prior]) distance matrix. Repeatedly the
    largest entry (> 1e-6) among unmatched rows and columns assigns its
    column to its row and retires the row; with ``per_prediction``,
    a leftover column whose best row exceeds ``dist_threshold`` (default
    0.5) takes that row. Returns (match_indices int32 [N, P], -1 where
    unmatched; match_dist [N, P]), without gradient. The loop runs
    num_gt steps (the JAX package's ``fori_loop``), each over all images
    at once."""
    if match_type not in ("bipartite", "per_prediction"):
        raise ValueError(f"unknown match_type {match_type!r}")
    thresh = 0.5 if dist_threshold is None else float(dist_threshold)
    eps = 1e-6
    squeeze = dist_matrix.dim() == 2
    dist = dist_matrix[None] if squeeze else dist_matrix
    N, R, C = dist.shape
    dev = dist.device
    with torch.no_grad():
        match = torch.full((N, C), -1, dtype=torch.int32, device=dev)
        mdist = torch.zeros((N, C), dtype=dist.dtype, device=dev)
        row_used = torch.zeros((N, R), dtype=torch.bool, device=dev)
        n = torch.arange(N, device=dev)
        neg = torch.full((), -1.0, dtype=dist.dtype, device=dev)
        for _ in range(R):
            avail = (match[:, None, :] == -1) & ~row_used[:, :, None] \
                & (dist > eps)
            masked = torch.where(avail, dist, neg).reshape(N, R * C)
            flat = masked.argmax(dim=1)                        # first max
            r, c = flat // C, flat % C
            best = masked[n, flat]
            ok = best > eps
            match[n, c] = torch.where(ok, r.to(torch.int32), match[n, c])
            mdist[n, c] = torch.where(ok, best, mdist[n, c])
            row_used[n, r] = row_used[n, r] | ok
        if match_type == "per_prediction":
            best_d, best_r = dist.max(dim=1)
            take = (match == -1) & (best_d > thresh)
            match = torch.where(take, best_r.to(torch.int32), match)
            mdist = torch.where(take, best_d, mdist)
    if squeeze:
        return match[0], mdist[0]
    return match, mdist


@_op
def target_assign(input, matched_indices, mismatch_value=0.0, name=None):
    """target_assign_op in dense form: input [N, B, K] per-gt targets,
    matched_indices [N, P] from ``bipartite_match`` -> (out [N, P, K], the
    gathered targets and ``mismatch_value`` where unmatched; out_weight
    [N, P, 1], 1 or 0), without gradient."""
    with torch.no_grad():
        matched = matched_indices >= 0
        safe = matched_indices.clamp(min=0).to(torch.int64)
        gathered = torch.gather(
            input, 1, safe[..., None].expand(*safe.shape, input.shape[2]))
        out = torch.where(matched[..., None], gathered, torch.full(
            (), mismatch_value, dtype=input.dtype, device=input.device))
        return out, matched[..., None].to(input.dtype)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """python/paddle/vision/ops.py nms: greedy suppression returning the
    kept indices (int64) in descending score order (ties to the lower
    index). The pairwise IoUs and the same-category mask are computed on
    the boxes' device; the greedy walk over them, whose result size
    depends on the data, runs on the host over one copy of the
    suppression matrix. The JAX package's loop compares pairs on the host
    in the same order, with the same test (IoU > threshold, union > 0,
    same category), so the kept indices are the same.

    boxes [M, 4] (x1, y1, x2, y2); optional scores [M] (default: the
    given order); optional category_idxs [M] for per-category
    suppression."""
    from ..core.tensor import to_torch

    b = to_torch(boxes)
    b = torch.as_tensor(b, dtype=torch.float32)
    dev = b.device
    M = b.shape[0]
    with torch.no_grad():
        sc = torch.as_tensor(to_torch(scores), dtype=torch.float32,
                             device=dev) if scores is not None else \
            torch.arange(M, 0, -1, dtype=torch.float32, device=dev)
        x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
        iw = (torch.minimum(x2[:, None], x2[None, :])
              - torch.maximum(x1[:, None], x1[None, :])).clamp(min=0)
        ih = (torch.minimum(y2[:, None], y2[None, :])
              - torch.maximum(y1[:, None], y1[None, :])).clamp(min=0)
        inter = iw * ih
        union = area[:, None] + area[None, :] - inter
        pos = union > 0
        sup = pos & (inter / torch.where(pos, union, torch.ones_like(union))
                     > iou_threshold)
        if category_idxs is not None:
            cat = torch.as_tensor(to_torch(category_idxs), device=dev)
            sup &= cat[:, None] == cat[None, :]
        order = torch.sort(-sc, stable=True).indices
        sup = sup[order][:, order].cpu().numpy()   # one read of the mask
        order = order.cpu().numpy()
    removed = np.zeros(M, dtype=bool)
    kept = []
    limit = M if top_k is None else int(top_k)
    for pos in range(M):
        if len(kept) >= limit:
            break
        if removed[pos]:
            continue
        kept.append(int(order[pos]))
        removed |= sup[pos]
    return Tensor._wrap(torch.as_tensor(kept, dtype=torch.int64, device=dev))
