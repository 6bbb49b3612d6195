"""Image preprocessing on the host: the port's copy of ``synapseml_tpu/image``.

Images are numpy HWC arrays in DataFrame columns (ragged sizes allowed via
object columns); the stages are numpy on the host, and the output of a
pipeline is a rectangular [N, C, H, W] float tensor column sized for a
model on the card. The same exports as ``synapseml_tpu/image/__init__.py``.
"""

from .transforms import (
    CenterCrop,
    ColorFormat,
    Crop,
    Flip,
    GaussianBlur,
    ImageTransformer,
    Resize,
    Threshold,
)
from .augment import ImageSetAugmenter
from .unroll import UnrollBinaryImage, UnrollImage
from .superpixel import SuperpixelTransformer, slic_segments

__all__ = [
    "ImageTransformer", "Resize", "Crop", "CenterCrop", "ColorFormat", "Flip",
    "GaussianBlur", "Threshold", "ImageSetAugmenter", "UnrollImage", "UnrollBinaryImage",
    "SuperpixelTransformer", "slic_segments",
]
