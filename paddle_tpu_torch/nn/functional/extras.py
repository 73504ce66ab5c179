"""The fluid-era functional tail (counterpart of
``paddle_tpu/nn/functional/extras.py``), on ``torch.Tensor``.

Real ops: ``grid_sample`` and ``affine_grid``, ``space_to_depth``,
``shuffle_channel``, ``temporal_shift``, ``affine_channel``,
``pad_constant_like``, ``fsp_matrix``, ``roi_pool``, ``random_crop``,
``density_prior_box``, ``spectral_norm``, the losses ``dice_loss``,
``bpr_loss``, ``smooth_l1``, ``soft_relu``, and ``add_position_encoding``.
Adapters over the modern functions: ``image_resize``, ``resize_*`` and
``image_resize_short`` over ``interpolate``; ``pool2d``/``pool3d`` over
the typed pools; ``pad2d`` over ``pad``; ``warpctc`` over ``ctc_loss``;
``hsigmoid_loss`` and ``nce`` over the loss layers' math on explicit
weights; ``fc`` and ``bilinear_tensor_product``, which build fresh
parameters at each call; ``rnn``/``birnn`` over the ``RNN``/``BiRNN``
layers. The tensor arrays are Python lists, as in the JAX package.

Each function computes the JAX package's function. Draws come from an
explicit ``generator`` (``random_crop``, ``nce``), the package's
generator of the input's device when None, where the JAX package takes
its next key. ``density_prior_box`` is a departure of the JAX package
from upstream Paddle (ROADMAP, ADVICE.md): the port computes the JAX
package's boxes, spaced by ``step_average`` as upstream's kernel spaces
them, with the corners clipped to [0, 1] only when ``clip`` is set (the
docstring of the function says more).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.random import default_generator
from ...core.tensor import to_torch
from . import activation as _activation
from .common import interpolate

__all__ = [
    "grid_sample", "affine_grid", "space_to_depth", "shuffle_channel",
    "temporal_shift", "dice_loss", "bpr_loss", "soft_relu", "pad2d",
    "add_position_encoding", "create_array", "array_write", "array_read",
    "array_length", "fc", "smooth_l1", "image_resize", "resize_bilinear",
    "resize_nearest", "resize_trilinear", "pool2d", "pool3d",
    "affine_channel", "pad_constant_like", "fsp_matrix", "random_crop",
    "image_resize_short", "roi_pool", "density_prior_box",
    "bilinear_tensor_product", "spectral_norm", "warpctc",
    "hsigmoid_loss", "nce", "rnn", "birnn", "tensor_array_to_tensor",
]

#: the tensor-array names, which take and give Python lists as they are
ARRAY_FUNCTIONS = ("create_array", "array_write", "array_read",
                   "array_length")


def _act(out, act):
    if act is None:
        return out
    fn = getattr(_activation, act, None) or getattr(torch, act, None)
    if fn is None:
        raise ValueError(f"unknown activation {act!r}")
    return fn(out)


# -- the spatial transformer pair --------------------------------------------


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta ``[N, 2, 3]`` and ``out_shape`` (N, C, H, W) -> grid ``[N, H,
    W, 2]`` of normalized (x, y) sample locations."""
    N, C, H, W = (int(s) for s in out_shape)
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, W, device=dev)
        ys = torch.linspace(-1.0, 1.0, H, device=dev)
    else:
        xs = (torch.arange(W, device=dev) * 2 + 1) / W - 1.0
        ys = (torch.arange(H, device=dev) * 2 + 1) / H - 1.0
    xg, yg = torch.meshgrid(xs, ys, indexing="xy")
    base = torch.stack([xg, yg, torch.ones_like(xg)], dim=-1)
    return torch.einsum("hwk,njk->nhwj", base, theta.float())


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` ``[N, C, H, W]`` at ``grid`` ``[N, Hg, Wg, 2]``
    normalized locations, bilinear or nearest, with zeros, border or
    reflection padding; differentiable in ``x`` and ``grid``."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample padding_mode {padding_mode!r}")
    N, C, H, W = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) / 2.0 * (W - 1)
        fy = (gy + 1.0) / 2.0 * (H - 1)
    else:
        fx = ((gx + 1.0) * W - 1.0) / 2.0
        fy = ((gy + 1.0) * H - 1.0) / 2.0

    def reflect(v, lo, hi):
        rng = hi - lo
        v = ((v - lo) % (2 * rng + 1e-9)).abs()
        return torch.where(v > rng, 2 * rng - v, v) + lo

    if padding_mode == "reflection":
        if align_corners:
            fx, fy = reflect(fx, 0.0, W - 1.0), reflect(fy, 0.0, H - 1.0)
        else:  # folded at the half-pixel border
            fx = reflect(fx, -0.5, W - 0.5).clamp(0, W - 1)
            fy = reflect(fy, -0.5, H - 0.5).clamp(0, H - 1)
    flat = x.reshape(N, C, H * W)

    def fetch(ix, iy):
        idx = (iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long())
        v = flat.gather(2, idx.reshape(N, 1, -1).expand(N, C, -1)).reshape(
            N, C, *idx.shape[1:])
        if padding_mode == "zeros":
            ok = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
            v = torch.where(ok[:, None], v, torch.zeros((), dtype=v.dtype,
                                                        device=v.device))
        return v

    if mode == "nearest":
        return fetch(torch.round(fx), torch.round(fy))
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x1, y1 = x0 + 1, y0 + 1
    wa = ((x1 - fx) * (y1 - fy))[:, None]
    wb = ((x1 - fx) * (fy - y0))[:, None]
    wc = ((fx - x0) * (y1 - fy))[:, None]
    wd = ((fx - x0) * (fy - y0))[:, None]
    return (fetch(x0, y0) * wa + fetch(x0, y1) * wb
            + fetch(x1, y0) * wc + fetch(x1, y1) * wd)


# -- small vision ops ----------------------------------------------------------


def space_to_depth(x, blocksize, name=None):
    """``[N, C, H, W]`` -> ``[N, C bs^2, H / bs, W / bs]``."""
    bs = int(blocksize)
    N, C, H, W = x.shape
    a = x.reshape(N, C, H // bs, bs, W // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return a.reshape(N, C * bs * bs, H // bs, W // bs)


def shuffle_channel(x, group, name=None):
    """ShuffleNet's channel shuffle in ``group`` groups."""
    g = int(group)
    N, C, H, W = x.shape
    return x.reshape(N, g, C // g, H, W).transpose(1, 2).reshape(N, C, H, W)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    """TSM: within each of the ``[N * seg_num, C, H, W]`` clips, the first
    ``C * shift_ratio`` channels move one segment back, the next as many
    one segment forward, zeros entering."""
    T = int(seg_num)
    NT, C, H, W = x.shape
    c1, c2 = int(C * shift_ratio), int(C * 2 * shift_ratio)
    a = x.reshape(NT // T, T, C, H, W)
    fwd = torch.cat([a[:, 1:, :c1], torch.zeros_like(a[:, :1, :c1])], 1)
    back = torch.cat([torch.zeros_like(a[:, :1, c1:c2]), a[:, :-1, c1:c2]],
                     1)
    return torch.cat([fwd, back, a[:, :, c2:]], 2).reshape(NT, C, H, W)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    """Per-channel ``x * scale + bias``."""
    ch = 1 if data_layout == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    out = x
    if scale is not None:
        out = out * scale.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """``y`` padded at the end of each axis up to ``x``'s shape."""
    pads = []
    for i in reversed(range(y.dim())):
        pads += [0, x.shape[i] - y.shape[i]]
    return torch.nn.functional.pad(y, pads, value=pad_value)


def fsp_matrix(x, y, name=None):
    """``[N, C1, H, W]`` x ``[N, C2, H, W]`` -> ``[N, C1, C2]``, the mean
    over H W of ``x_c1 y_c2``."""
    return torch.einsum("nchw,ndhw->ncd", x, y) / (x.shape[2] * x.shape[3])


def random_crop(x, shape, seed=None, name=None, *, generator=None):
    """A random window of the trailing ``len(shape)`` axes, one per sample
    when ``x`` has more axes than ``shape``. The starts come from a
    generator seeded with ``seed``, else ``generator``, else the package's
    generator of ``x``'s device."""
    gen = generator if seed is None else torch.Generator(
        device=x.device).manual_seed(int(seed))
    gen = gen or default_generator(x.device)
    tgt = [int(s) for s in shape]
    k = len(tgt)

    def crop(sample):
        lead = sample.dim() - k
        out = sample
        for i in range(k):
            hi = sample.shape[lead + i] - tgt[i]
            start = int(torch.randint(0, hi + 1, (), generator=gen,
                                      device=x.device)) if hi > 0 else 0
            out = out.narrow(lead + i, start, tgt[i])
        return out

    if x.dim() > k:
        return torch.stack([crop(s) for s in x.unbind(0)], 0)
    return crop(x)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """Max pooling of each RoI over ``output_size`` bins of whole pixels
    (the corners rounded after ``spatial_scale``); an empty bin gives 0.
    ``boxes`` ``[R, 4]`` (x1, y1, x2, y2); ``boxes_num`` RoIs per image."""
    oh, ow = (int(output_size), int(output_size)) \
        if isinstance(output_size, int) else map(int, output_size)
    N, C, H, W = x.shape
    img = torch.repeat_interleave(torch.arange(N, device=x.device),
                                  boxes_num.long().reshape(-1))
    x1, y1, x2, y2 = (torch.round(boxes[:, i] * spatial_scale)
                      for i in range(4))
    rw = (x2 - x1 + 1).clamp(min=1.0)
    rh = (y2 - y1 + 1).clamp(min=1.0)
    ys = torch.arange(H, dtype=torch.float32, device=x.device)
    xs = torch.arange(W, dtype=torch.float32, device=x.device)
    neg = torch.tensor(-math.inf, dtype=x.dtype, device=x.device)
    outs = []
    for r in range(boxes.shape[0]):
        by = torch.floor((ys - y1[r]) / rh[r] * oh).clamp(0, oh - 1).long()
        bx = torch.floor((xs - x1[r]) / rw[r] * ow).clamp(0, ow - 1).long()
        inside = ((ys >= y1[r]) & (ys <= y2[r]))[:, None] \
            & ((xs >= x1[r]) & (xs <= x2[r]))[None, :]
        vals = torch.where(inside[None], x[img[r]], neg).reshape(C, -1)
        bins = (by[:, None] * ow + bx[None, :]).reshape(1, -1).expand(C, -1)
        out = torch.full((C, oh * ow), -math.inf, dtype=x.dtype,
                         device=x.device).scatter_reduce(
            1, bins, vals, reduce="amax", include_self=True)
        outs.append(torch.where(torch.isfinite(out), out,
                                torch.zeros_like(out)).reshape(C, oh, ow))
    return torch.stack(outs, 0)


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False,
                      name=None):
    """Per feature-map cell, for each (density, fixed_size) pair and each
    fixed ratio, a density x density grid of boxes, spaced and centred by
    ``step_average = int((step_w + step_h) / 2)``, the cell's extent.
    Returns (boxes ``[H, W, P, 4]``, variances of the same shape), or ``[H
    W P, 4]`` each with ``flatten_to_2d``, on ``input``'s device.

    Departure (named): this is the JAX package's function, which ROADMAP
    lists among its departures from upstream Paddle (``extras.py:607``;
    ADVICE.md found it spacing the grid by ``fixed_size``, which its code
    no longer does). Upstream's kernel also clamps each corner to [0, 1];
    the JAX package, and so the port, clamp only with ``clip=True``."""
    H, W = int(input.shape[2]), int(input.shape[3])
    IH, IW = int(image.shape[2]), int(image.shape[3])
    step_w = steps[0] or IW / W
    step_h = steps[1] or IH / H
    step_average = int((step_w + step_h) * 0.5)
    boxes = []
    for h in range(H):
        for w in range(W):
            cx, cy = (w + offset) * step_w, (h + offset) * step_h
            for density, fs in zip(densities, fixed_sizes):
                for ar in fixed_ratios:
                    bw, bh = fs * np.sqrt(ar), fs / np.sqrt(ar)
                    shift = step_average // density
                    for di in range(density):
                        for dj in range(density):
                            ccx = (cx - step_average / 2.0 + shift / 2.0
                                   + dj * shift)
                            ccy = (cy - step_average / 2.0 + shift / 2.0
                                   + di * shift)
                            boxes.append([(ccx - bw / 2.0) / IW,
                                          (ccy - bh / 2.0) / IH,
                                          (ccx + bw / 2.0) / IW,
                                          (ccy + bh / 2.0) / IH])
    arr = np.asarray(boxes, np.float32)
    if clip:
        arr = np.clip(arr, 0.0, 1.0)
    arr = arr.reshape(H, W, arr.shape[0] // (H * W), 4)
    var = np.broadcast_to(np.asarray(variance, np.float32), arr.shape)
    if flatten_to_2d:
        arr, var = arr.reshape(-1, 4), var.reshape(-1, 4)
    return (torch.tensor(arr, device=input.device),
            torch.tensor(np.array(var), device=input.device))


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``W / sigma_max(W)`` by power iteration from a uniform ``u`` (fresh
    at each call; the layer keeps its vectors as buffers), differentiable
    through the iteration."""
    d = int(dim)
    Wm = weight.movedim(d, 0).reshape(weight.shape[d], -1)
    u = torch.ones(Wm.shape[0], dtype=weight.dtype, device=weight.device) \
        / np.sqrt(Wm.shape[0])
    v = None
    for _ in range(max(int(power_iters), 1)):
        v = Wm.t() @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = Wm @ v
        u = u / (torch.linalg.norm(u) + eps)
    return weight / (u @ (Wm @ v) + eps)


# -- small losses and activations ----------------------------------------------


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - (2 |X n Y| + eps) / (|X| + |Y| + eps)``, averaged; a label
    of one trailing index is one-hot over ``input``'s classes."""
    if label.shape[-1] == 1 and input.shape[-1] > 1:
        y = torch.nn.functional.one_hot(label[..., 0].long(),
                                        input.shape[-1]).to(input.dtype)
    else:
        y = label.to(input.dtype)
    axes = tuple(range(1, input.dim()))
    inter = (input * y).sum(axes)
    union = input.sum(axes) + y.sum(axes)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def bpr_loss(input, label, name=None):
    """Bayesian personalized ranking: ``-mean_j log(sigmoid(x_label -
    x_j))`` over ``j != label``, ``[B, 1]``."""
    B, C = input.shape
    y = label.reshape(B).long()
    diff = input.gather(1, y[:, None]) - input
    lg = torch.log(torch.sigmoid(diff) + 1e-12)
    mask = 1.0 - torch.nn.functional.one_hot(y, C).to(input.dtype)
    return (-(lg * mask).sum(1) / max(C - 1, 1))[:, None]


def soft_relu(x, threshold=40.0, name=None):
    """``log(1 + exp(clip(x, -threshold, threshold)))``."""
    return torch.log1p(torch.exp(x.clamp(-threshold, threshold)))


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None,
              name=None):
    """Huber form of ``d = (x - y) * inside_weight`` with the crossover at
    ``|d| = 1 / sigma^2``, times ``outside_weight``, summed over the last
    axis (``[..., 1]``)."""
    sigma2 = 1.0 if sigma is None else float(sigma) ** 2
    d = x - y
    if inside_weight is not None:
        d = d * inside_weight
    ad = d.abs()
    loss = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * d * d,
                       ad - 0.5 / sigma2)
    if outside_weight is not None:
        loss = loss * outside_weight
    return loss.sum(dim=-1, keepdim=True)


def add_position_encoding(input, alpha, beta, name=None):
    """``alpha x + beta PE`` over ``[B, T, C]``, PE the sinusoidal
    encoding (sines in the first half of the channels, cosines in the
    second)."""
    B, T, C = input.shape
    half = C // 2
    pos = torch.arange(T, dtype=torch.float32, device=input.device)[:, None]
    den = torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                          device=input.device) / half)[None]
    pe = torch.cat([torch.sin(pos / den), torch.cos(pos / den)], dim=-1)
    return alpha * input + beta * pe[None].to(input.dtype)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """``HSigmoidLoss``'s function over explicit ``weight``/``bias``: the
    default tree of ``num_classes``, or ``path_table``/``path_code``."""
    from ..layers.loss import _hsigmoid_apply, _hsigmoid_tables

    tables = None if path_table is not None \
        else _hsigmoid_tables(int(num_classes))
    return _hsigmoid_apply(input, label, weight, bias, tables, path_table,
                           path_code)


def nce(input, label, num_total_classes, num_neg_samples=10,
        sampler="uniform", weight=None, bias=None, name=None, *,
        generator=None, **kwargs):
    """``NCELoss``'s function over explicit ``weight``/``bias``, the noise
    drawn uniformly from ``generator``."""
    from ..layers.loss import _nce_apply

    if sampler != "uniform":
        raise NotImplementedError("nce sampler: only 'uniform'")
    return _nce_apply(input, label, weight, bias, int(num_total_classes),
                      int(num_neg_samples), generator)


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    """``ctc_loss`` per sample (``reduction="none"``) on the padded-dense
    form; the LoD form (no lengths) raises, as in the JAX package."""
    if input_length is None or label_length is None:
        raise NotImplementedError(
            "warpctc without explicit lengths is the fluid LoD form; "
            "pass input_length/label_length (padded-dense) or call "
            "nn.functional.ctc_loss directly")
    from .loss import ctc_loss

    return ctc_loss(input, label, input_length, label_length, blank=blank,
                    reduction="none")


# -- adapters over the modern functions ----------------------------------------


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    """``pad`` with fluid's ``[top, bottom, left, right]`` order."""
    from ...ops.manipulation import pad

    t, b, l, r = (int(v) for v in paddings)
    return to_torch(pad(input, [l, r, t, b], mode=mode, value=pad_value,
                        data_format=data_format))


def image_resize(input, out_shape=None, scale=None, resample="BILINEAR",
                 align_corners=True, align_mode=1, data_format="NCHW",
                 name=None):
    return interpolate(input, size=out_shape, scale_factor=scale,
                       mode=resample.lower(), align_corners=align_corners,
                       data_format=data_format)


def resize_bilinear(input, out_shape=None, scale=None, align_corners=True,
                    align_mode=1, data_format="NCHW", name=None):
    return image_resize(input, out_shape, scale, "BILINEAR", align_corners,
                        align_mode, data_format)


def resize_nearest(input, out_shape=None, scale=None, align_corners=True,
                   data_format="NCHW", name=None):
    return image_resize(input, out_shape, scale, "NEAREST", align_corners,
                        1, data_format)


def resize_trilinear(input, out_shape=None, scale=None, align_corners=True,
                     align_mode=1, data_format="NCDHW", name=None):
    return interpolate(input, size=out_shape, scale_factor=scale,
                       mode="trilinear", align_corners=align_corners,
                       data_format=data_format)


def image_resize_short(input, out_short_len, resample="BILINEAR",
                       name=None):
    """Resize so the shorter spatial side is ``out_short_len`` (aspect
    kept, rounded)."""
    H, W = int(input.shape[2]), int(input.shape[3])
    ratio = float(out_short_len) / min(H, W)
    return image_resize(input, out_shape=[int(round(H * ratio)),
                                          int(round(W * ratio))],
                        resample=resample)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCHW", name=None):
    """fluid's pool2d over the typed pools (NHWC transposed around
    them)."""
    from .pooling import avg_pool2d, max_pool2d

    x = input.permute(0, 3, 1, 2) if data_format == "NHWC" else input
    if global_pooling:
        out = x.amax((2, 3), keepdim=True) if pool_type == "max" \
            else x.mean((2, 3), keepdim=True)
    elif pool_type == "max":
        out = max_pool2d(x, pool_size, stride=pool_stride,
                         padding=pool_padding, ceil_mode=ceil_mode)
    else:
        out = avg_pool2d(x, pool_size, stride=pool_stride,
                         padding=pool_padding, ceil_mode=ceil_mode,
                         exclusive=exclusive)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCDHW", name=None):
    """fluid's pool3d: the global form reduces the spatial axes of
    ``data_format``; the windowed one pools NCDHW, as in the JAX
    package."""
    from .pooling import avg_pool3d, max_pool3d

    if global_pooling:
        axes = (2, 3, 4) if data_format == "NCDHW" else (1, 2, 3)
        return input.amax(axes, keepdim=True) if pool_type == "max" \
            else input.mean(axes, keepdim=True)
    if pool_type == "max":
        return max_pool3d(input, pool_size, stride=pool_stride,
                          padding=pool_padding, ceil_mode=ceil_mode)
    return avg_pool3d(input, pool_size, stride=pool_stride,
                      padding=pool_padding, ceil_mode=ceil_mode,
                      exclusive=exclusive)


def fc(x, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """fluid's fc: a ``Linear`` with fresh parameters (on ``x``'s device)
    over the axes from ``num_flatten_dims`` on, flattened; a list of
    inputs sums one such product each; then ``act``."""
    from ..layers.common import Linear

    outs = []
    for xi in x if isinstance(x, (list, tuple)) else [x]:
        lead = list(xi.shape[:num_flatten_dims])
        n_in = int(np.prod(xi.shape[num_flatten_dims:]))
        lin = Linear(n_in, size, weight_attr=param_attr,
                     bias_attr=bias_attr, device=xi.device)
        flat = xi.reshape((lead if num_flatten_dims > 1 else [-1])
                          + [n_in])
        outs.append(lin(flat))
    out = outs[0]
    for o in outs[1:]:
        out = out + o
    return _act(out, act)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """``Bilinear`` with fresh parameters (on ``x``'s device), then
    ``act``."""
    from ..layers.common import Bilinear

    layer = Bilinear(int(x.shape[-1]), int(y.shape[-1]), int(size),
                     weight_attr=param_attr, bias_attr=bias_attr,
                     device=x.device)
    return _act(layer(x, y), act)


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """``cell`` run over the sequence by the ``RNN`` layer."""
    from ..layers.rnn import RNN

    return RNN(cell, is_reverse=is_reverse, time_major=time_major)(
        inputs, initial_states=initial_states,
        sequence_length=sequence_length)


def birnn(cell_fw, cell_bw, inputs, initial_states=None,
          sequence_length=None, time_major=False, **kwargs):
    """Two cells over the sequence by the ``BiRNN`` layer."""
    from ..layers.rnn import BiRNN

    return BiRNN(cell_fw, cell_bw, time_major=time_major)(
        inputs, initial_states=initial_states,
        sequence_length=sequence_length)


# -- fluid tensor arrays: Python lists -----------------------------------------


def create_array(dtype="float32"):
    return []


def array_write(x, i, array=None):
    """``array[i] = x``, the list grown with None up to ``i``."""
    i = int(to_torch(i))
    if array is None:
        array = []
    while len(array) <= i:
        array.append(None)
    array[i] = x
    return array


def array_read(array, i):
    return array[int(to_torch(i))]


def array_length(array):
    """The list's length as an int64 ``Tensor``."""
    from ...ops.creation import to_tensor

    return to_tensor(len(array), dtype="int64")


def tensor_array_to_tensor(input, axis=1, use_stack=False, name=None):
    """The array's tensors concatenated (stacked with ``use_stack``) along
    ``axis``, and each one's length along it (1 when stacked), int64."""
    vals = [to_torch(v) for v in input if v is not None]
    out = torch.stack(vals, axis) if use_stack else torch.cat(vals, axis)
    lengths = [1 if use_stack else int(v.shape[axis]) for v in vals]
    return out, torch.tensor(lengths, dtype=torch.int64, device=out.device)
