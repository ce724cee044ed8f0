"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``).

Host-side numpy, run where the ``DataLoader`` runs its workers, on HWC
uint8 images before the batch goes to the card: ``Compose``, ``Cast``,
``ToTensor`` (HWC [0, 255] -> CHW float32 [0, 1]), ``Normalize``,
``Resize`` (nearest neighbour), ``CenterCrop``, ``RandomResizedCrop``,
``RandomCrop``, ``CropResize``, ``RandomFlipLeftRight``,
``RandomFlipTopBottom``, ``RandomBrightness``, ``RandomContrast``,
``RandomSaturation``, ``RandomHue``, ``RandomColorJitter`` and
``RandomLighting``. The random ones draw from the calling thread's
``random.host_rng()``. ``CropResize`` with a ``size`` resizes with
``image.imresize``'s interpolation, which waits for ROADMAP A9
(``image.py``), and refuses.
"""
from __future__ import annotations

import numpy as _np

from .... import random as _rng
from ....base import MXNetError
from ....ndarray import NDArray
from ...block import Block
from ...nn import Sequential


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        if isinstance(x, NDArray):
            return x.astype(self._dtype)
        return _np.asarray(x, dtype=self._dtype)


class ToTensor(Block):
    """HWC uint8 [0,255] -> CHW float32 [0,1]."""

    def forward(self, x):
        a = x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)
        a = a.astype(_np.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return a


class Normalize(Block):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, dtype=_np.float32)
        self._std = _np.asarray(std, dtype=_np.float32)

    def forward(self, x):
        a = x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x, dtype=_np.float32)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return (a - mean) / std


def _resize_np(a, size):
    """Nearest-neighbor host resize (OpenCV-free)."""
    h, w = a.shape[:2]
    oh, ow = (size, size) if isinstance(size, int) else (size[1], size[0])
    ri = (_np.arange(oh) * h / oh).astype(int).clip(0, h - 1)
    ci = (_np.arange(ow) * w / ow).astype(int).clip(0, w - 1)
    return a[ri][:, ci]


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size

    def forward(self, x):
        a = x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)
        return _resize_np(a, self._size)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        a = x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)
        ow, oh = self._size
        h, w = a.shape[:2]
        if h < oh or w < ow:
            a = _resize_np(a, (max(ow, w), max(oh, h)))
            h, w = a.shape[:2]
        y0 = (h - oh) // 2
        x0 = (w - ow) // 2
        return a[y0:y0 + oh, x0:x0 + ow]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        a = x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = _rng.host_rng().uniform(*self._scale) * area
            ar = _np.exp(_rng.host_rng().uniform(_np.log(self._ratio[0]), _np.log(self._ratio[1])))
            nw = int(round(_np.sqrt(target_area * ar)))
            nh = int(round(_np.sqrt(target_area / ar)))
            if nw <= w and nh <= h:
                x0 = _rng.host_rng().randint(0, w - nw + 1)
                y0 = _rng.host_rng().randint(0, h - nh + 1)
                crop = a[y0:y0 + nh, x0:x0 + nw]
                return _resize_np(crop, self._size)
        return _resize_np(a, self._size)


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad

    def forward(self, x):
        a = x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)
        if self._pad:
            p = self._pad
            a = _np.pad(a, ((p, p), (p, p), (0, 0)), mode="constant")
        h, w = a.shape[:2]
        ow, oh = self._size
        y0 = _rng.host_rng().randint(0, max(h - oh, 0) + 1)
        x0 = _rng.host_rng().randint(0, max(w - ow, 0) + 1)
        return a[y0:y0 + oh, x0:x0 + ow]


class RandomFlipLeftRight(Block):
    def forward(self, x):
        a = x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)
        if _rng.host_rng().rand() < 0.5:
            a = a[:, ::-1].copy()
        return a


class RandomFlipTopBottom(Block):
    def forward(self, x):
        a = x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)
        if _rng.host_rng().rand() < 0.5:
            a = a[::-1].copy()
        return a


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        a = _np.asarray(x, dtype=_np.float32)
        f = 1.0 + _rng.host_rng().uniform(-self._b, self._b)
        return _np.clip(a * f, 0, 255)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        a = _np.asarray(x, dtype=_np.float32)
        f = 1.0 + _rng.host_rng().uniform(-self._c, self._c)
        mean = a.mean()
        return _np.clip((a - mean) * f + mean, 0, 255)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        a = _np.asarray(x, dtype=_np.float32)
        f = 1.0 + _rng.host_rng().uniform(-self._s, self._s)
        gray = a.mean(axis=-1, keepdims=True)
        return _np.clip(gray + (a - gray) * f, 0, 255)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        for t in self._ts:
            x = t(x)
        return x


class RandomHue(Block):
    """Random hue jitter (reference transforms.py RandomHue): rotate RGB
    around the luminance axis by the YIQ hue-rotation matrix."""

    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        a = _np.asarray(x, dtype=_np.float32)
        f = _rng.host_rng().uniform(-self._h, self._h)
        theta = f * _np.pi
        u, w = _np.cos(theta), _np.sin(theta)
        t_yiq = _np.array([[0.299, 0.587, 0.114],
                           [0.596, -0.274, -0.321],
                           [0.211, -0.523, 0.311]], _np.float32)
        t_rgb = _np.array([[1.0, 0.956, 0.621],
                           [1.0, -0.272, -0.647],
                           [1.0, -1.107, 1.705]], _np.float32)
        rot = _np.diag(_np.array([1.0, u, u], _np.float32))
        rot[1, 2] = -w
        rot[2, 1] = w
        m = t_rgb @ rot @ t_yiq
        return _np.clip(a @ m.T, 0, 255)


class RandomLighting(Block):
    """AlexNet-style PCA lighting noise (reference transforms.py
    RandomLighting)."""

    _EIGVAL = _np.array([55.46, 4.794, 1.148], _np.float32)
    _EIGVEC = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], _np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = _np.asarray(x, dtype=_np.float32)
        alpha = _rng.host_rng().normal(0, self._alpha, 3).astype(_np.float32)
        shift = self._EIGVEC @ (alpha * self._EIGVAL)
        return _np.clip(a + shift, 0, 255)


class CropResize(Block):
    """Fixed crop (``x``, ``y``, ``width``, ``height``); a ``size`` to resize
    to waits for ROADMAP A9's ``image.imresize``."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        if size:
            raise MXNetError("CropResize(size=...) resizes with image.imresize, which the "
                             "port does not have yet: ROADMAP A9 (image.py)")
        self._box = (x, y, width, height)

    def forward(self, img):
        x0, y0, w, h = self._box
        a = img.asnumpy() if isinstance(img, NDArray) else _np.asarray(img)
        return a[y0:y0 + h, x0:x0 + w]
