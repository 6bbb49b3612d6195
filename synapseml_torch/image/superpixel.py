"""SLIC superpixel segmentation: the port's copy of
``synapseml_tpu/image/superpixel.py`` (numpy only).

Local k-means in (color, xy) space, vectorized per iteration: a per-image
integer label map, which the image explainers perturb by blanking
superpixels.
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import Param, TypeConverters
from ..core.pipeline import Transformer
from .transforms import as_image

__all__ = ["slic_segments", "SuperpixelTransformer"]


def slic_segments(img: np.ndarray, cell_size: float = 16.0, modifier: float = 130.0,
                  n_iter: int = 5) -> np.ndarray:
    """SLIC label map [H, W] int32. ``cell_size`` is the seed-grid pitch;
    ``modifier`` weights color distance vs spatial distance (the reference's
    (cellSize, modifier) parameterization, ``SuperpixelTransformer.scala``)."""
    img = as_image(img)
    H, W, C = img.shape
    S = max(int(round(cell_size)), 2)
    ys = np.arange(S // 2, H, S)
    xs = np.arange(S // 2, W, S)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    centers_xy = np.stack([cy.ravel(), cx.ravel()], axis=1).astype(np.float64)
    K = len(centers_xy)
    centers_col = img[centers_xy[:, 0].astype(int), centers_xy[:, 1].astype(int)].astype(np.float64)

    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix_xy = np.stack([yy, xx], axis=-1).astype(np.float64)          # [H,W,2]
    color_weight = (modifier / 255.0) ** 2
    spatial_weight = 1.0 / (S * S)

    labels = np.zeros((H, W), np.int64)
    dist = np.full((H, W), np.inf)
    for _ in range(n_iter):
        dist[:] = np.inf
        for k in range(K):
            y0, x0 = centers_xy[k]
            ylo, yhi = max(int(y0) - S, 0), min(int(y0) + S + 1, H)
            xlo, xhi = max(int(x0) - S, 0), min(int(x0) + S + 1, W)
            patch = img[ylo:yhi, xlo:xhi].astype(np.float64)
            d_col = np.sum((patch - centers_col[k]) ** 2, axis=-1) * color_weight
            d_sp = np.sum((pix_xy[ylo:yhi, xlo:xhi] - centers_xy[k]) ** 2, axis=-1) * spatial_weight
            d = d_col + d_sp
            win = dist[ylo:yhi, xlo:xhi]
            better = d < win
            win[better] = d[better]
            labels[ylo:yhi, xlo:xhi][better] = k
        # recompute centers
        flat = labels.ravel()
        counts = np.bincount(flat, minlength=K).astype(np.float64)
        counts = np.maximum(counts, 1.0)
        for d_idx in range(2):
            centers_xy[:, d_idx] = np.bincount(flat, weights=pix_xy[..., d_idx].ravel(),
                                               minlength=K) / counts
        for c_idx in range(C):
            centers_col[:, c_idx] = np.bincount(flat, weights=img[..., c_idx].ravel().astype(np.float64),
                                                minlength=K) / counts
    # compact label ids (empty clusters removed)
    uniq, remap = np.unique(labels, return_inverse=True)
    return remap.reshape(H, W).astype(np.int32)


class SuperpixelTransformer(Transformer):
    """(ref ``SuperpixelTransformer.scala``) emits, per image, the superpixel
    clustering as a list of pixel-index arrays (what the image explainers
    toggle on/off)."""

    feature_name = "image"

    input_col = Param("input_col", "image column", default="image")
    output_col = Param("output_col", "superpixel column", default="superpixels")
    cell_size = Param("cell_size", "seed grid pitch in pixels", default=16.0,
                      converter=TypeConverters.to_float)
    modifier = Param("modifier", "color-vs-spatial distance weight", default=130.0,
                     converter=TypeConverters.to_float)

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("input_col"))

        def per_part(p):
            out = np.empty(len(p[self.get("input_col")]), dtype=object)
            for i, x in enumerate(p[self.get("input_col")]):
                out[i] = slic_segments(x, self.get("cell_size"), self.get("modifier"))
            return out

        return df.with_column(self.get("output_col"), per_part)
