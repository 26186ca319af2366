"""Host-side data augmentation, the port's copy of
``nmrf_tpu/data/transforms.py`` (reference ``nmrf/data/transforms.py``):
``FlowAugmentor`` and ``SparseFlowAugmentor`` with the same draws from the
global ``numpy`` and stdlib ``random`` generators, so the same seeds give
the same outputs as the JAX package.

The photometric chain (torchvision ColorJitter semantics: brightness,
contrast, saturation through PIL ImageEnhance in a random order, hue by an
HSV rotation, then AdjustGamma) runs in the host C++ kernel of
``nmrf_tpu_torch/native`` (``fused_photometric``).  Its PIL version is the
plain one, for the tests: it runs only when the caller passes
``plain=True``.  PIL and OpenCV are imported where they are used, so the
synthetic path runs without them; OpenCV resizes where it is installed, as
in the JAX package, else PIL.

The reference's defects fixed in the JAX package stay fixed here:
``SparseFlowAugmentor.spatial_transform`` has its intended four arguments,
and ``FlowAugmentor.spatial_aug_prob`` is a constructor argument.
"""

import ctypes
import random

import numpy as np

from .. import native
from .frame_io import _cv2, _pil_image


def _adjust_hue(img, hue_factor: float):
    """torchvision functional.adjust_hue equivalent (hue_factor in [-0.5, 0.5])."""
    if abs(hue_factor) < 1e-8:
        return img
    Image = _pil_image()
    h, s, v = img.convert("HSV").split()
    h_np = np.array(h, dtype=np.uint8)
    h_np = (h_np.astype(np.int16) + int(round(hue_factor * 255))) % 256
    return Image.merge("HSV", (Image.fromarray(h_np.astype(np.uint8), "L"), s, v)).convert("RGB")


def _adjust_gamma(img, gamma: float, gain: float = 1.0):
    arr = np.asarray(img).astype(np.float32) / 255.0
    arr = 255.0 * gain * np.power(arr, gamma)
    return _pil_image().fromarray(np.clip(arr, 0, 255).astype(np.uint8))


class ColorJitter:
    """torchvision-equivalent ColorJitter: random factors, random op order."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=(1.0, 1.0), hue=0.0):
        self.brightness = (max(0.0, 1 - brightness), 1 + brightness)
        self.contrast = (max(0.0, 1 - contrast), 1 + contrast)
        self.saturation = tuple(saturation)
        self.hue = (-hue, hue)

    def sample_params(self):
        """Draw (order, b, c, s, h) consuming the stdlib-random stream
        exactly as ``__call__`` historically did (op codes: 0 brightness,
        1 contrast, 2 saturation, 3 hue) — so the native and PIL paths stay
        interchangeable under the loader's per-sample deterministic seeds."""
        b = random.uniform(*self.brightness)
        c = random.uniform(*self.contrast)
        s = random.uniform(*self.saturation)
        h = random.uniform(*self.hue)
        order = [0, 1, 2, 3]
        random.shuffle(order)
        return order, b, c, s, h

    def apply(self, img, order, b, c, s, h):
        """The PIL chain on a PIL image (the plain version)."""
        from PIL import ImageEnhance

        ops = {0: lambda im: ImageEnhance.Brightness(im).enhance(b),
               1: lambda im: ImageEnhance.Contrast(im).enhance(c),
               2: lambda im: ImageEnhance.Color(im).enhance(s),
               3: lambda im: _adjust_hue(im, h)}
        for code in order:
            img = ops[code](img)
        return img

    def __call__(self, img):
        order, b, c, s, h = self.sample_params()
        return self.apply(img, order, b, c, s, h)


class AdjustGamma:
    """Reference AdjustGamma (transforms.py:17-28)."""

    def __init__(self, gamma_min, gamma_max, gain_min=1.0, gain_max=1.0):
        self.gamma_min, self.gamma_max = gamma_min, gamma_max
        self.gain_min, self.gain_max = gain_min, gain_max

    def sample_params(self):
        gain = random.uniform(self.gain_min, self.gain_max)
        gamma = random.uniform(self.gamma_min, self.gamma_max)
        return gain, gamma

    def __call__(self, img):
        gain, gamma = self.sample_params()
        return _adjust_gamma(img, gamma, gain)


def _gamma_lut(gamma: float, gain: float) -> np.ndarray:
    """256-entry uint8 LUT computed with the exact numpy expression of
    ``_adjust_gamma`` (float32 divide/pow, clip, truncating astype) so the
    native path is bit-identical to the PIL path for the gamma stage."""
    arr = np.arange(256, dtype=np.float32) / 255.0
    arr = 255.0 * gain * np.power(arr, gamma)
    return np.clip(arr, 0, 255).astype(np.uint8)


def fused_photometric(arr: np.ndarray, photo_aug: "ColorJitter",
                      gamma_aug: "AdjustGamma", plain=False) -> np.ndarray:
    """ColorJitter + AdjustGamma over a uint8 RGB array in one pass chain,
    in the host C++ kernel (``nmrf_tpu_torch/native/photometric.cpp``; it
    raises if it cannot be built), or with ``plain`` in the PIL chain.  Both
    consume the stdlib-random stream identically (``sample_params``).
    Kernel vs PIL: brightness, contrast, saturation and gamma bit-exact, hue
    within PIL's own float-ordering jitter (see the .cpp header)."""
    order, b, c, s, h = photo_aug.sample_params()
    gain, gamma = gamma_aug.sample_params()
    if plain:
        img = photo_aug.apply(_pil_image().fromarray(arr), order, b, c, s, h)
        return np.array(_adjust_gamma(img, gamma, gain), dtype=np.uint8)
    lib = native.load()
    out = np.ascontiguousarray(arr, dtype=np.uint8).copy()
    # PIL's _adjust_hue is an exact no-op below 1e-8 (no HSV round trip);
    # above it the round trip applies even when the integer shift is 0.
    codes = np.asarray([o for o in order if o != 3 or abs(h) >= 1e-8],
                       dtype=np.int32)
    lut = _gamma_lut(gamma, gain)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.nmrf_photometric(
        out.ctypes.data_as(u8p), out.size // 3,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(codes),
        b, c, s, int(round(h * 255)),
        lut.ctypes.data_as(u8p), 1)
    return out


def _resize(img, fx, fy):
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
    Image = _pil_image()
    h, w = img.shape[:2]
    out = Image.fromarray(img).resize(
        (int(round(w * fx)), int(round(h * fy))), Image.BILINEAR)
    return np.asarray(out)


class FlowAugmentor:
    """Dense-GT augmentor (reference transforms.py:31-155)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=True,
                 yjitter=False, saturation_range=(0.6, 1.4), gamma=(1, 1, 1, 1),
                 spatial_aug_prob=0.0):
        crop_size = [crop_size[0] // 8 * 8, crop_size[1] // 8 * 8]
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        # reference hardcodes 0.0 (defect §2.9.6); configurable here
        self.spatial_aug_prob = spatial_aug_prob
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.yjitter = yjitter
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = ColorJitter(brightness=0.4, contrast=0.4,
                                     saturation=saturation_range, hue=0.5 / 3.14)
        self.gamma_aug = AdjustGamma(*gamma)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5

    def _photo(self, arr):
        return fused_photometric(arr, self.photo_aug, self.gamma_aug)

    def color_transform(self, img1, img2):
        if np.random.rand() < self.asymmetric_color_aug_prob:
            return self._photo(img1), self._photo(img2)
        stack = np.concatenate([img1, img2], axis=0)
        stack = self._photo(stack)
        i1, i2 = np.split(stack, 2, axis=0)
        return i1, i2

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if np.random.rand() < self.eraser_aug_prob:
            mean_color = np.mean(img2.reshape(-1, 3), axis=0)
            for _ in range(np.random.randint(1, 3)):
                x0 = np.random.randint(0, wd)
                y0 = np.random.randint(0, ht)
                dx = np.random.randint(bounds[0], bounds[1])
                dy = np.random.randint(bounds[0], bounds[1])
                img2 = img2.copy()
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    def spatial_transform(self, img1, img2, flow):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum((self.crop_size[0] + 8) / float(ht),
                               (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** np.random.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if np.random.rand() < self.stretch_prob:
            scale_x *= 2 ** np.random.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** np.random.uniform(-self.max_stretch, self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        if np.random.rand() < self.spatial_aug_prob:
            img1 = _resize(img1, scale_x, scale_y)
            img2 = _resize(img2, scale_x, scale_y)
            flow = _resize(flow, scale_x, scale_y)
            flow = flow * [scale_x, scale_y]

        if self.do_flip:
            if np.random.rand() < self.h_flip_prob and self.do_flip == "hf":
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if np.random.rand() < self.h_flip_prob and self.do_flip == "h":
                tmp = img1[:, ::-1]
                img1 = img2[:, ::-1]
                img2 = tmp
            if np.random.rand() < self.v_flip_prob and self.do_flip == "v":
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]

        if self.yjitter:
            y0 = np.random.randint(2, img1.shape[0] - self.crop_size[0] - 2)
            x0 = np.random.randint(2, img1.shape[1] - self.crop_size[1] - 2)
            y1 = y0 + np.random.randint(-2, 2 + 1)
            img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
            img2 = img2[y1:y1 + self.crop_size[0], x0:x0 + self.crop_size[1]]
            flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        else:
            y0 = np.random.randint(0, img1.shape[0] - self.crop_size[0])
            x0 = np.random.randint(0, img1.shape[1] - self.crop_size[1])
            img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
            img2 = img2[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
            flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1, img2, flow

    def __call__(self, img1, img2, flow):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow = self.spatial_transform(img1, img2, flow)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


class SparseFlowAugmentor:
    """Sparse-GT augmentor (reference transforms.py:158-294, arity bug fixed)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 yjitter=False, saturation_range=(0.7, 1.3), gamma=(1, 1, 1, 1)):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = ColorJitter(brightness=0.3, contrast=0.3,
                                     saturation=saturation_range, hue=0.3 / 3.14)
        self.gamma_aug = AdjustGamma(*gamma)
        self.eraser_aug_prob = 0.5

    def _photo(self, arr):
        return fused_photometric(arr, self.photo_aug, self.gamma_aug)

    def color_transform(self, img1, img2):
        stack = np.concatenate([img1, img2], axis=0)
        stack = self._photo(stack)
        i1, i2 = np.split(stack, 2, axis=0)
        return i1, i2

    def eraser_transform(self, img1, img2):
        ht, wd = img1.shape[:2]
        if np.random.rand() < self.eraser_aug_prob:
            mean_color = np.mean(img2.reshape(-1, 3), axis=0)
            for _ in range(np.random.randint(1, 3)):
                x0 = np.random.randint(0, wd)
                y0 = np.random.randint(0, ht)
                dx = np.random.randint(50, 100)
                dy = np.random.randint(50, 100)
                img2 = img2.copy()
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        """Scatter-valid resize (reference transforms.py:197-229)."""
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1)
        coords = coords.reshape(-1, 2).astype(np.float32)
        flow = flow.reshape(-1, 2).astype(np.float32)
        valid = valid.reshape(-1).astype(np.float32)
        coords0 = coords[valid >= 1]
        flow0 = flow[valid >= 1]
        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        flow_img = np.zeros([ht1, wd1, 2], dtype=np.float32)
        valid_img = np.zeros([ht1, wd1], dtype=np.int32)
        flow_img[yy[v], xx[v]] = flow1[v]
        valid_img[yy[v], xx[v]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum((self.crop_size[0] + 1) / float(ht),
                               (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** np.random.uniform(self.min_scale, self.max_scale)
        scale_x = np.clip(scale, min_scale, None)
        scale_y = np.clip(scale, min_scale, None)

        if np.random.rand() < self.spatial_aug_prob:
            img1 = _resize(img1, scale_x, scale_y)
            img2 = _resize(img2, scale_x, scale_y)
            flow, valid = self.resize_sparse_flow_map(flow, valid, scale_x, scale_y)

        if self.do_flip:
            if np.random.rand() < self.h_flip_prob and self.do_flip == "hf":
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
                valid = valid[:, ::-1]
            if np.random.rand() < self.h_flip_prob and self.do_flip == "h":
                tmp = img1[:, ::-1]
                img1 = img2[:, ::-1]
                img2 = tmp
            if np.random.rand() < self.v_flip_prob and self.do_flip == "v":
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]
                valid = valid[::-1, :]

        margin_y, margin_x = 20, 50
        y0 = np.random.randint(0, img1.shape[0] - self.crop_size[0] + margin_y)
        x0 = np.random.randint(-margin_x, img1.shape[1] - self.crop_size[1] + margin_x)
        y0 = np.clip(y0, 0, img1.shape[0] - self.crop_size[0])
        x0 = np.clip(x0, 0, img1.shape[1] - self.crop_size[1])
        img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        img2 = img2[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        valid = valid[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1, img2, flow, valid > 0

    def __call__(self, img1, img2, flow, valid):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow, valid)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))
