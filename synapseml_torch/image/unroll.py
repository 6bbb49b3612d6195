"""UnrollImage and UnrollBinaryImage: the port's copy of
``synapseml_tpu/image/unroll.py``.

Image column -> flat float vector column (the classical-ML feature bridge,
e.g. for TrainClassifier / KNN over raw pixels). ``UnrollBinaryImage``
decodes encoded bytes with :func:`decode_image_bytes`, this package's copy
of ``synapseml_tpu/io/files.py:79-89``, which imports PIL when it is
called.
"""

from __future__ import annotations

import io

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import Param
from ..core.pipeline import Transformer
from .transforms import as_image

__all__ = ["UnrollImage", "UnrollBinaryImage", "decode_image_bytes"]


def decode_image_bytes(data: bytes) -> np.ndarray:
    """bytes -> [H, W, C] uint8 (RGB; grayscale promoted to 3 channels)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr.astype(np.uint8)


class UnrollImage(Transformer):
    feature_name = "image"

    input_col = Param("input_col", "image column", default="image")
    output_col = Param("output_col", "flattened vector column", default="unrolled")

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("input_col"))

        def per_part(p):
            flats = [as_image(x).ravel() for x in p[self.get("input_col")]]
            lens = {len(f) for f in flats}
            if len(lens) == 1 and flats:
                return np.stack(flats)
            out = np.empty(len(flats), dtype=object)
            out[:] = flats
            return out

        return df.with_column(self.get("output_col"), per_part)


class UnrollBinaryImage(Transformer):
    """Decode ENCODED image bytes (png/jpeg) straight to the flat vector —
    the reference's binary variant (``image/UnrollImage.scala:204``,
    ``UnrollBinaryImage``) used downstream of the binary-file source without
    an intermediate decoded-image column."""

    feature_name = "image"

    input_col = Param("input_col", "binary image-bytes column", default="content")
    output_col = Param("output_col", "flattened vector column", default="unrolled")

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("input_col"))

        def per_part(p):
            flats = []
            for raw in p[self.get("input_col")]:
                try:
                    flats.append(decode_image_bytes(bytes(raw)).ravel())
                except Exception:  # undecodable bytes -> empty vector
                    flats.append(np.zeros(0, np.uint8))
            lens = {len(f) for f in flats}
            if len(lens) == 1 and flats:
                return np.stack(flats)
            out = np.empty(len(flats), dtype=object)
            out[:] = flats
            return out

        return df.with_column(self.get("output_col"), per_part)
