"""paddle.vision.ops — the detection ops (counterpart of
``paddle_tpu/vision/ops.py``; reference: python/paddle/vision/ops.py over
operators/deformable_conv_op.h).

Ported so far: the deformable convolution, ``deform_conv2d`` and its layer
``DeformConv2D``, whose bilinear sampling is a gather and an einsum in
torch. The YOLO, box, RoI and NMS ops are still to come.
"""
from __future__ import annotations

import torch

from ..core.tensor import tensor_boundary
from ..nn.initializer import XavierNormal
from ..nn.layer import Layer

__all__ = ["deform_conv2d", "DeformConv2D"]


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
