"""ImageFeaturizer: ImageTransformer preprocessing -> headless ONNX model ->
feature vector column.

Counterpart of ``synapseml_tpu/onnx/featurizer.py``, with the same Params
and defaults plus ``device`` (default ``"cuda"``; a host without a CUDA
device must ask for ``"cpu"``), on this package's
:class:`~synapseml_torch.image.ImageTransformer` (host numpy) and
:class:`.model.ONNXModel` (the graph as torch ops on ``device``).
``set_model(name)`` pulls from the local :class:`.hub.ONNXHub`;
``head_less=True`` slices the graph at ``feature_tensor_name`` and flattens
the activations into the output vector.
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.device import device_type
from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Transformer
from ..image import ImageTransformer
from .hub import ONNXHub
from .model import ONNXModel, slice_model_at_outputs

__all__ = ["ImageFeaturizer"]

IMAGENET_MEANS = [0.485, 0.456, 0.406]
IMAGENET_STDS = [0.229, 0.224, 0.225]


class ImageFeaturizer(Transformer):
    feature_name = "onnx"

    input_col = Param("input_col", "image column", default="image")
    output_col = Param("output_col", "feature vector column", default="features")
    model_payload = ComplexParam("model_payload", "ONNX model bytes")
    head_less = Param("head_less", "cut at the feature tensor (transfer learning)",
                      default=True, converter=TypeConverters.to_bool)
    feature_tensor_name = Param("feature_tensor_name",
                                "intermediate output to cut at when head_less",
                                default=None)
    image_height = Param("image_height", "model input height", default=224,
                         converter=TypeConverters.to_int)
    image_width = Param("image_width", "model input width", default=224,
                        converter=TypeConverters.to_int)
    mini_batch_size = Param("mini_batch_size", "device batch size", default=32,
                            converter=TypeConverters.to_int)
    center_crop = Param("center_crop", "aspect-preserving resize + center crop",
                        default=True, converter=TypeConverters.to_bool)
    device = Param("device", "torch device: 'cuda' (default), 'cuda:N' or 'cpu'",
                   default="cuda", converter=TypeConverters.to_string,
                   validator=lambda v: device_type(v) in ("cuda", "cpu"))

    def set_model(self, name: str, hub: ONNXHub | None = None) -> "ImageFeaturizer":
        return self.set(model_payload=(hub or ONNXHub()).load(name))

    def set_model_location(self, path: str) -> "ImageFeaturizer":
        with open(path, "rb") as f:
            return self.set(model_payload=f.read())

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("input_col"))
        h, w = self.get("image_height"), self.get("image_width")
        it = ImageTransformer(input_col=self.get("input_col"), output_col="_img_tensor")
        if self.get("center_crop"):
            it = it.resize(size=max(h, w) * 256 // 224, keep_aspect_ratio=True)
            it = it.center_crop(h, w)
        else:
            it = it.resize(height=h, width=w)
        it = it.normalize(means=IMAGENET_MEANS, stds=IMAGENET_STDS,
                          color_scale_factor=1 / 255.0)

        payload = self.get("model_payload")
        if payload is None:
            raise ValueError("ImageFeaturizer: model_payload not set "
                             "(set_model / set_model_location)")
        if self.get("head_less"):
            cut = self.get("feature_tensor_name")
            if not cut:
                raise ValueError(
                    "ImageFeaturizer: head_less=True requires "
                    "feature_tensor_name (the intermediate output to cut at); "
                    "set head_less=False to use the full model's outputs")
            payload = slice_model_at_outputs(payload, [cut])
        om = ONNXModel(model_bytes=payload, mini_batch_size=self.get("mini_batch_size"),
                       device=self.get("device"))
        in_name = om.model_input_names[0]
        out_name = om.model_output_names[0]
        om.set(feed_dict={in_name: "_img_tensor"},
               fetch_dict={"_raw_feats": out_name})

        out = om.transform(it.transform(df))

        def flatten(p):
            feats = np.asarray(p["_raw_feats"])
            return feats.reshape(len(feats), -1)

        return (out.with_column(self.get("output_col"), flatten)
                   .drop("_img_tensor", "_raw_feats"))
