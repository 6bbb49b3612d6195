"""Gradient-boosted decision trees on the card (the LightGBM-equivalent engine).

Counterpart of ``synapseml_tpu/gbdt/``: quantile binning on the host, then
level-wise histogram tree growth on the device, where each level's
histogram is one launch of the hand-written CUDA kernel
``csrc/gbdt_hist.cu`` (``histogram_impl='pallas'``) or plain torch
(``'segment'``, ``'onehot'``). Ported: ``BinMapper``, the objectives but
lambdarank, tree growth, ``Booster`` (scoring, TreeSHAP, leaf indices,
importances, save/load in the JAX package's format) and the classifier and
regressor estimators.
"""

from .binning import BinMapper
from .booster import Booster, train_booster, train_booster_from_source
from .estimators import (
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRegressionModel,
    LightGBMRegressor,
)
from .hist import fixed_point_histogram, level_histogram, segment_histogram

__all__ = [
    "BinMapper",
    "Booster",
    "train_booster",
    "train_booster_from_source",
    "LightGBMClassifier",
    "LightGBMClassificationModel",
    "LightGBMRegressor",
    "LightGBMRegressionModel",
    "LightGBMRanker",
    "fixed_point_histogram",
    "level_histogram",
    "segment_histogram",
]
