"""Gradient-boosted decision trees on the card (the LightGBM-equivalent engine).

Counterpart of ``synapseml_tpu/gbdt/``: quantile bin boundaries on the host
(the codes on the card for a fit there), then level-wise histogram tree
growth on the device, where each level's
histogram is one launch of the hand-written CUDA kernel
``csrc/gbdt_hist.cu`` (``histogram_impl='pallas'``) or plain torch
(``'segment'``, ``'onehot'``). Ported: ``BinMapper`` (categorical
features included), every objective (lambdarank too), tree growth with
categorical splits, ``Booster`` (scoring, TreeSHAP, leaf indices,
importances, save/load in the JAX package's format; ``TpuBooster`` is its
JAX name), every boosting mode and sampling option, continued training,
LightGBM ``model.txt`` both ways (:mod:`.interop`), out-of-core training
from a ``ShardedSource`` (:mod:`.streaming`) and the classifier, regressor
and ranker estimators, data-parallel over a mesh's ``data`` axis (``mesh``,
``mesh_config``). The fused sweep (``train_boosters_fused``) waits for
ROADMAP.md queue A item 11.
"""

from .binning import BinMapper
from .booster import Booster, TpuBooster, train_booster, train_booster_from_source
from .estimators import (
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRankerModel,
    LightGBMRegressionModel,
    LightGBMRegressor,
)
from .interop import ImportedBooster, parse_lightgbm_string, to_lightgbm_string
from .hist import fixed_point_histogram, level_histogram, segment_histogram

__all__ = [
    "BinMapper",
    "Booster",
    "TpuBooster",
    "ImportedBooster",
    "parse_lightgbm_string",
    "to_lightgbm_string",
    "train_booster",
    "train_booster_from_source",
    "LightGBMClassifier",
    "LightGBMClassificationModel",
    "LightGBMRegressor",
    "LightGBMRegressionModel",
    "LightGBMRanker",
    "LightGBMRankerModel",
    "fixed_point_histogram",
    "level_histogram",
    "segment_histogram",
]
