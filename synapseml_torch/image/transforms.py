"""ImageTransformer and its image stages.

The port's copy of ``synapseml_tpu/image/transforms.py`` (numpy only, the
same stages, Params and results, bit for bit): each stage is a small
dataclass with an ``apply(img) -> img`` on HWC float32 numpy arrays;
``ImageTransformer`` chains them per image, then optionally normalizes
(means/stds/scale) and emits either HWC images or a stacked [N, C, H, W]
tensor column for a model's input. Everything runs on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Transformer

__all__ = ["ImageTransformer", "Resize", "Crop", "CenterCrop", "ColorFormat",
           "Flip", "GaussianBlur", "Threshold", "as_image"]


def as_image(x) -> np.ndarray:
    """Coerce to HWC float32 (grayscale promoted to 1 channel)."""
    img = np.asarray(x, dtype=np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3:
        raise ValueError(f"expected HW or HWC image, got shape {img.shape}")
    return img


def bilinear_resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Vectorized bilinear resample (align_corners=False convention, matching
    OpenCV INTER_LINEAR)."""
    H, W, C = img.shape
    if (H, W) == (height, width):
        return img
    ys = (np.arange(height) + 0.5) * H / height - 0.5
    xs = (np.arange(width) + 0.5) * W / width - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(int(round(3.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(sigma, 1e-8)) ** 2)
    return (k / k.sum()).astype(np.float32)


def _sep_conv(img: np.ndarray, kx: np.ndarray, ky: np.ndarray) -> np.ndarray:
    """Separable 2D convolution with edge replication (OpenCV BORDER_REPLICATE)."""
    ry, rx = len(ky) // 2, len(kx) // 2
    pad = np.pad(img, ((ry, ry), (rx, rx), (0, 0)), mode="edge")
    # convolve rows then columns via strided sums
    out = np.zeros((img.shape[0] + 2 * ry, img.shape[1], img.shape[2]), np.float32)
    for i, w in enumerate(kx):
        out += w * pad[:, i : i + img.shape[1], :]
    final = np.zeros_like(img)
    for j, w in enumerate(ky):
        final += w * out[j : j + img.shape[0], :, :]
    return final


@dataclasses.dataclass
class Resize:
    """(ref ``ImageTransformer.scala`` ResizeImage) — keep_aspect_ratio resizes
    the short side to ``size`` (then callers usually CenterCrop)."""

    height: int = -1
    width: int = -1
    size: int = -1  # short-side mode when >0
    keep_aspect_ratio: bool = False

    def apply(self, img: np.ndarray) -> np.ndarray:
        H, W, _ = img.shape
        if self.size > 0 or self.keep_aspect_ratio:
            s = self.size if self.size > 0 else max(self.height, self.width)
            scale = s / min(H, W)
            return bilinear_resize(img, max(int(round(H * scale)), 1),
                                   max(int(round(W * scale)), 1))
        return bilinear_resize(img, self.height, self.width)


@dataclasses.dataclass
class Crop:
    x: int = 0
    y: int = 0
    height: int = 0
    width: int = 0

    def apply(self, img: np.ndarray) -> np.ndarray:
        return img[self.y : self.y + self.height, self.x : self.x + self.width]


@dataclasses.dataclass
class CenterCrop:
    height: int = 0
    width: int = 0

    def apply(self, img: np.ndarray) -> np.ndarray:
        H, W, _ = img.shape
        y = max((H - self.height) // 2, 0)
        x = max((W - self.width) // 2, 0)
        return img[y : y + self.height, x : x + self.width]


@dataclasses.dataclass
class ColorFormat:
    """'rgb' <-> 'bgr' swap or 'gray' (ITU-R BT.601 luma, what OpenCV uses)."""

    format: str = "rgb"

    def apply(self, img: np.ndarray) -> np.ndarray:
        f = self.format.lower()
        if f in ("bgr", "rgb"):  # symmetric channel swap
            return img[:, :, ::-1] if img.shape[2] == 3 else img
        if f in ("gray", "grayscale"):
            if img.shape[2] == 1:
                return img
            w = np.array([0.299, 0.587, 0.114], np.float32)
            return (img[:, :, :3] @ w)[:, :, None]
        raise ValueError(f"unknown color format {self.format!r}")


@dataclasses.dataclass
class Flip:
    """flip_code: 0 = vertical (around x-axis), 1 = horizontal, -1 = both
    (OpenCV convention, ``ImageTransformer.scala`` Flip stage)."""

    flip_code: int = 1

    def apply(self, img: np.ndarray) -> np.ndarray:
        if self.flip_code == 0:
            return img[::-1]
        if self.flip_code > 0:
            return img[:, ::-1]
        return img[::-1, ::-1]


@dataclasses.dataclass
class GaussianBlur:
    """Covers both Blur (box ~ sigma from aperture) and GaussianKernel stages."""

    aperture_size: int = 0
    sigma: float = 1.0

    def apply(self, img: np.ndarray) -> np.ndarray:
        radius = self.aperture_size // 2 if self.aperture_size > 0 else None
        k = gaussian_kernel1d(self.sigma, radius)
        return _sep_conv(img, k, k)


@dataclasses.dataclass
class Threshold:
    """Binary threshold (ref Threshold stage): pixel > threshold ? max_val : 0."""

    threshold: float = 127.0
    max_val: float = 255.0

    def apply(self, img: np.ndarray) -> np.ndarray:
        return np.where(img > self.threshold, np.float32(self.max_val), np.float32(0.0))


class ImageTransformer(Transformer):
    """Chain of image stages + normalization + optional tensor output
    (ref ``opencv/.../ImageTransformer.scala:429``).

    ``set_to_tensor(True)`` emits a [C, H, W] float32 array per row (stacked
    into a rectangular column when sizes agree) — the DNN input format
    (`ImageTransformer.scala:413`); otherwise HWC images come back.
    """

    feature_name = "image"

    input_col = Param("input_col", "image column", default="image")
    output_col = Param("output_col", "output column", default="out_image")
    stages = ComplexParam("stages", "ordered list of image stage objects", default=None)
    color_scale_factor = Param("color_scale_factor", "multiply pixels (e.g. 1/255)",
                               default=None)
    norm_means = ComplexParam("norm_means", "per-channel means subtracted after scaling",
                              default=None)
    norm_stds = ComplexParam("norm_stds", "per-channel stds divided after scaling",
                             default=None)
    to_tensor = Param("to_tensor", "emit CHW float tensor", default=False,
                      converter=TypeConverters.to_bool)

    # -------- fluent stage builders (mirroring the reference's API) --------
    def _add(self, stage) -> "ImageTransformer":
        cur = list(self.get("stages") or [])
        cur.append(stage)
        return self.set(stages=cur)

    def resize(self, height: int = -1, width: int = -1, size: int = -1,
               keep_aspect_ratio: bool = False) -> "ImageTransformer":
        return self._add(Resize(height, width, size, keep_aspect_ratio))

    def crop(self, x: int, y: int, height: int, width: int) -> "ImageTransformer":
        return self._add(Crop(x, y, height, width))

    def center_crop(self, height: int, width: int) -> "ImageTransformer":
        return self._add(CenterCrop(height, width))

    def color_format(self, format: str) -> "ImageTransformer":
        return self._add(ColorFormat(format))

    def flip(self, flip_code: int = 1) -> "ImageTransformer":
        return self._add(Flip(flip_code))

    def gaussian_blur(self, aperture_size: int = 0, sigma: float = 1.0) -> "ImageTransformer":
        return self._add(GaussianBlur(aperture_size, sigma))

    def threshold(self, threshold: float = 127.0, max_val: float = 255.0) -> "ImageTransformer":
        return self._add(Threshold(threshold, max_val))

    def normalize(self, means, stds, color_scale_factor: float = 1.0 / 255.0) -> "ImageTransformer":
        self.set(norm_means=list(means), norm_stds=list(stds),
                 color_scale_factor=color_scale_factor)
        return self.set(to_tensor=True)

    # -------- transform --------
    def _process_one(self, x) -> np.ndarray:
        img = as_image(x)
        for stage in self.get("stages") or []:
            img = stage.apply(img)
        scale = self.get("color_scale_factor")
        means, stds = self.get("norm_means"), self.get("norm_stds")
        if scale is not None or means is not None or stds is not None:
            img = img * np.float32(scale if scale is not None else 1.0)
            if means is not None:
                img = img - np.asarray(means, np.float32)
            if stds is not None:
                img = img / np.asarray(stds, np.float32)
        if self.get("to_tensor"):
            img = np.transpose(img, (2, 0, 1))  # CHW
        return img.astype(np.float32)

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("input_col"))

        def per_part(p):
            imgs = [self._process_one(x) for x in p[self.get("input_col")]]
            shapes = {im.shape for im in imgs}
            if len(shapes) == 1 and imgs:  # rectangular -> stacked tensor column
                return np.stack(imgs)
            out = np.empty(len(imgs), dtype=object)
            out[:] = imgs
            return out

        return df.with_column(self.get("output_col"), per_part)
