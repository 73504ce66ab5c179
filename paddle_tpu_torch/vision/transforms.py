"""Vision transforms on numpy CHW arrays (counterpart of
``paddle_tpu/vision/transforms.py``; reference:
python/paddle/vision/transforms/transforms.py). They run on the host (in
DataLoader workers), so the device sees collated batches only.

Every random draw comes from the global numpy stream, as in the JAX
package, so ``np.random.seed(s)`` gives both the same crops and flips.
``Resize`` and ``RandomResizedCrop`` resize by nearest neighbour
(``_chw_resize``) whatever ``interpolation`` names, as the JAX package
does.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "Compose", "ToTensor", "Normalize", "Resize", "CenterCrop", "RandomCrop",
    "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose", "Pad",
    "RandomResizedCrop", "BrightnessTransform", "Grayscale",
]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor:
    """HWC uint8 -> CHW float32/255 (transforms.ToTensor)."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and self.data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
            arr = arr.transpose(2, 0, 1)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        return arr.astype(np.float32)


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            shape = (-1,) + (1,) * (img.ndim - 1)
        else:
            shape = (1,) * (img.ndim - 1) + (-1,)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


def _chw_resize(img, size):
    """Nearest-neighbor resize without external deps (PIL-free)."""
    if isinstance(size, int):
        size = (size, size)
    c, h, w = img.shape
    oh, ow = size
    ys = (np.arange(oh) * (h / oh)).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(ow) * (w / ow)).astype(np.int64).clip(0, w - 1)
    return img[:, ys[:, None], xs[None, :]]


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = size

    def __call__(self, img):
        return _chw_resize(np.asarray(img), self.size)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        c, h, w = img.shape
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[:, i : i + th, j : j + tw]


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        if self.padding:
            p = self.padding
            img = np.pad(img, ((0, 0), (p, p), (p, p)))
        c, h, w = img.shape
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[:, i : i + th, j : j + tw]


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img):
        c, h, w = img.shape
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target * ar)))
            th = int(round(np.sqrt(target / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = np.random.randint(0, h - th + 1)
                j = np.random.randint(0, w - tw + 1)
                crop = img[:, i : i + th, j : j + tw]
                return _chw_resize(crop, self.size)
        return _chw_resize(img, self.size)


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return img[..., ::-1].copy()
        return img


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return img[..., ::-1, :].copy()
        return img


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = padding

    def __call__(self, img):
        p = self.padding
        if isinstance(p, int):
            p = (p, p)
        return np.pad(img, ((0, 0), (p[0], p[0]), (p[1], p[1])))


class BrightnessTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        factor = 1 + np.random.uniform(-self.value, self.value)
        return np.clip(img * factor, 0, 1).astype(np.float32)


class Grayscale:
    def __init__(self, num_output_channels=1):
        self.n = num_output_channels

    def __call__(self, img):
        gray = img.mean(axis=0, keepdims=True)
        return np.repeat(gray, self.n, axis=0)


__all__ += ["ContrastTransform", "SaturationTransform", "HueTransform",
            "ColorJitter", "RandomRotation"]


def _blend(a, b, factor):
    return np.clip(a * factor + b * (1 - factor), 0, 1).astype(np.float32)


_LUMA = np.array([0.299, 0.587, 0.114], np.float32)  # ITU-R 601


def _gray(img):
    """Luma-weighted grayscale [1, H, W] (the reference's rgb_to_
    grayscale); non-RGB inputs fall back to the channel mean."""
    if img.shape[0] == 3:
        return np.einsum("c,chw->hw", _LUMA, img)[None]
    return img.mean(axis=0, keepdims=True)


class ContrastTransform:
    """transforms.py ContrastTransform: blend toward the scalar mean
    LUMINANCE (luma-weighted gray mean, not the raw channel mean) with a
    factor drawn from [1-value, 1+value]."""

    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        factor = 1 + np.random.uniform(-self.value, self.value)
        mean = _gray(img).mean()
        return _blend(img, np.full_like(img, mean), factor)


class SaturationTransform:
    """Blend toward the per-pixel luma grayscale."""

    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        factor = 1 + np.random.uniform(-self.value, self.value)
        return _blend(img, np.broadcast_to(_gray(img), img.shape), factor)


class HueTransform:
    """Hue rotation in YIQ space (the classic NTSC rotation matrix —
    avoids a per-pixel RGB<->HSV conversion on the loader hot path).
    Grayscale inputs pass through unchanged."""

    _RGB2YIQ = np.array([[0.299, 0.587, 0.114],
                         [0.596, -0.274, -0.322],
                         [0.211, -0.523, 0.312]], np.float32)
    _YIQ2RGB = np.array([[1.0, 0.956, 0.621],
                         [1.0, -0.272, -0.647],
                         [1.0, -1.106, 1.703]], np.float32)

    def __init__(self, value):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value should be in [0, 0.5]")
        self.value = value

    def __call__(self, img):
        if img.shape[0] != 3:
            return img
        theta = np.random.uniform(-self.value, self.value) * 2 * np.pi
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        m = self._YIQ2RGB @ rot @ self._RGB2YIQ
        out = np.einsum("ij,jhw->ihw", m, img.astype(np.float32))
        return np.clip(out, 0, 1).astype(np.float32)


class ColorJitter:
    """transforms.py ColorJitter: brightness/contrast/saturation/hue in
    a freshly shuffled order per call (reference _apply_image)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.ts = []
        if brightness:
            self.ts.append(BrightnessTransform(brightness))
        if contrast:
            self.ts.append(ContrastTransform(contrast))
        if saturation:
            self.ts.append(SaturationTransform(saturation))
        if hue:
            self.ts.append(HueTransform(hue))

    def __call__(self, img):
        for i in np.random.permutation(len(self.ts)):
            img = self.ts[int(i)](img)
        return img


class RandomRotation:
    """transforms.py RandomRotation: rotate CHW by a uniform angle from
    [-degrees, degrees] about `center` (default: image center), inverse
    mapping on the host. `interpolation` supports 'nearest' and
    'bilinear'; `expand=True` enlarges the canvas to hold the whole
    rotated image (the reference's output-bound computation); `fill`
    pads outside the source."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        if np.isscalar(degrees):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            self.degrees = (-float(degrees), float(degrees))
        else:
            self.degrees = (float(degrees[0]), float(degrees[1]))
        if interpolation not in ("nearest", "bilinear"):
            raise ValueError(
                f"interpolation must be 'nearest' or 'bilinear', got "
                f"{interpolation!r}"
            )
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def __call__(self, img):
        angle = np.deg2rad(np.random.uniform(*self.degrees))
        c, s = np.cos(angle), np.sin(angle)
        C, H, W = img.shape
        if self.center is not None:
            cx, cy = float(self.center[0]), float(self.center[1])
        else:
            cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
        if self.expand:
            # output canvas bounds the rotated source rectangle
            # the 1e-9 absorbs float noise (cos(90 deg) ~ 6e-17 would
            # otherwise ceil a 10.000000000000001 up to 11)
            out_h = int(np.ceil(abs(H * c) + abs(W * s) - 1e-9))
            out_w = int(np.ceil(abs(W * c) + abs(H * s) - 1e-9))
        else:
            out_h, out_w = H, W
        ocy = cy + (out_h - H) / 2.0
        ocx = cx + (out_w - W) / 2.0
        yy, xx = np.meshgrid(np.arange(out_h), np.arange(out_w),
                             indexing="ij")
        # inverse map: output pixel -> source pixel
        sy = c * (yy - ocy) + s * (xx - ocx) + cy
        sx = -s * (yy - ocy) + c * (xx - ocx) + cx
        out = np.full((C, out_h, out_w), self.fill, np.float32)
        if self.interpolation == "nearest":
            syi = np.round(sy).astype(np.int64)
            sxi = np.round(sx).astype(np.int64)
            valid = (syi >= 0) & (syi < H) & (sxi >= 0) & (sxi < W)
            out[:, valid] = img[:, syi[valid], sxi[valid]]
            return out
        # bilinear: gather the 4 neighbors, weight, zero-fill outside
        y0 = np.floor(sy).astype(np.int64)
        x0 = np.floor(sx).astype(np.int64)
        wy = (sy - y0).astype(np.float32)
        wx = (sx - x0).astype(np.float32)
        valid = (sy >= 0) & (sy <= H - 1) & (sx >= 0) & (sx <= W - 1)
        y0c = np.clip(y0, 0, H - 1)
        x0c = np.clip(x0, 0, W - 1)
        y1c = np.clip(y0 + 1, 0, H - 1)
        x1c = np.clip(x0 + 1, 0, W - 1)
        val = (img[:, y0c, x0c] * (1 - wy) * (1 - wx)
               + img[:, y0c, x1c] * (1 - wy) * wx
               + img[:, y1c, x0c] * wy * (1 - wx)
               + img[:, y1c, x1c] * wy * wx)
        out[:, valid] = val[:, valid].astype(np.float32)
        return out
