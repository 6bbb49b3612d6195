"""ImageSetAugmenter: the port's copy of ``synapseml_tpu/image/augment.py``.

Train-time dataset expansion by horizontal/vertical flips: emits the
original rows plus one extra copy per enabled flip."""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import Param, TypeConverters
from ..core.pipeline import Transformer
from .transforms import Flip, as_image

__all__ = ["ImageSetAugmenter"]


class ImageSetAugmenter(Transformer):
    feature_name = "image"

    input_col = Param("input_col", "image column", default="image")
    output_col = Param("output_col", "augmented image column", default="image")
    flip_left_right = Param("flip_left_right", "add horizontal flips", default=True,
                            converter=TypeConverters.to_bool)
    flip_up_down = Param("flip_up_down", "add vertical flips", default=False,
                         converter=TypeConverters.to_bool)

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("input_col"))
        ic, oc = self.get("input_col"), self.get("output_col")

        def flipped(code: int):
            f = Flip(code)

            def per_part(p):
                q = dict(p)
                imgs = [f.apply(as_image(x)) for x in p[ic]]
                if len({im.shape for im in imgs}) == 1 and imgs:
                    q[oc] = np.stack(imgs)
                else:
                    col = np.empty(len(imgs), dtype=object)
                    col[:] = imgs
                    q[oc] = col
                return q

            return df.map_partitions(per_part)

        base = df if oc == ic else df.with_column(
            oc, lambda p: p[ic])
        out = base
        if self.get("flip_left_right"):
            out = out.union(flipped(1))
        if self.get("flip_up_down"):
            out = out.union(flipped(0))
        return out
