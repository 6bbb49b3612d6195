"""LightGBMClassifier / LightGBMRegressor estimators.

Counterpart of ``synapseml_tpu/gbdt/estimators.py`` (reference
``LightGBMClassifier.scala``, ``LightGBMRegressor.scala`` and the shared
param surface of ``params/LightGBMParams.scala``): the same Param names and
defaults, mapped 1:1 onto :func:`.booster.train_booster` keywords, plus a
``device`` Param (default ``"cuda"``; a host without a card must ask for
``"cpu"``) on which the estimator trains and the fitted model scores.
Partitions are concatenated host-side into one binned matrix that moves to
the device once.

Not ported yet, each refused with ``NotImplementedError``: the ranker,
``model_string`` continuation, ``mesh_config``, the fused sweep
(``_fit_fused``) and ``save_native_model`` (LightGBM model.txt interop),
plus the booster's own refusals (see :mod:`.booster`).
"""

from __future__ import annotations

import numpy as np

from ..core import DataFrame, Estimator, Model
from ..core.params import ComplexParam, Param, TypeConverters
from .booster import device_type, train_booster
from .hist import HIST_IMPLS

__all__ = [
    "LightGBMClassifier", "LightGBMClassificationModel",
    "LightGBMRegressor", "LightGBMRegressionModel", "LightGBMRanker",
]


class _LightGBMParams:
    """Shared train params (reference ``params/LightGBMParams.scala``)."""

    features_col = Param("features_col", "features column: one (N,F) array column, "
                         "or set feature_cols for separate numeric columns",
                         default="features")
    feature_cols = Param("feature_cols", "explicit list of numeric feature columns "
                         "(alternative to an assembled features_col)", default=None)
    label_col = Param("label_col", "label column", default="label")
    weight_col = Param("weight_col", "sample weight column", default=None)
    prediction_col = Param("prediction_col", "prediction output column", default="prediction")
    validation_indicator_col = Param(
        "validation_indicator_col", "boolean column marking validation rows "
        "(reference validationIndicatorCol)", default=None)

    num_iterations = Param("num_iterations", "boosting rounds", default=100,
                           converter=TypeConverters.to_int)
    learning_rate = Param("learning_rate", "shrinkage", default=0.1,
                          converter=TypeConverters.to_float)
    num_leaves = Param("num_leaves", "max leaves per tree", default=31,
                       converter=TypeConverters.to_int)
    max_depth = Param("max_depth", "max depth (-1 = derive from num_leaves)",
                      default=-1, converter=TypeConverters.to_int)
    max_bin = Param("max_bin", "histogram bins per feature", default=255,
                    converter=TypeConverters.to_int)
    lambda_l1 = Param("lambda_l1", "L1 regularization", default=0.0,
                      converter=TypeConverters.to_float)
    lambda_l2 = Param("lambda_l2", "L2 regularization", default=0.0,
                      converter=TypeConverters.to_float)
    min_data_in_leaf = Param("min_data_in_leaf", "min rows per leaf", default=20,
                             converter=TypeConverters.to_int)
    min_sum_hessian_in_leaf = Param("min_sum_hessian_in_leaf", "min hessian per leaf",
                                    default=1e-3, converter=TypeConverters.to_float)
    min_gain_to_split = Param("min_gain_to_split", "min split gain", default=0.0,
                              converter=TypeConverters.to_float)
    feature_fraction = Param("feature_fraction", "per-tree feature subsample "
                             "(< 1 not ported yet)", default=1.0,
                             converter=TypeConverters.to_float)
    bagging_fraction = Param("bagging_fraction", "row subsample fraction "
                             "(< 1 not ported yet)", default=1.0,
                             converter=TypeConverters.to_float)
    bagging_freq = Param("bagging_freq", "bagging every k iterations (0=off)",
                         default=0, converter=TypeConverters.to_int)
    boosting_type = Param("boosting_type", "gbdt | goss | dart | rf "
                          "(reference boostingType; only gbdt is ported yet)",
                          default="gbdt")
    top_rate = Param("top_rate", "goss: keep fraction by |grad|", default=0.2,
                     converter=TypeConverters.to_float)
    other_rate = Param("other_rate", "goss: sample fraction of the rest",
                       default=0.1, converter=TypeConverters.to_float)
    drop_rate = Param("drop_rate", "dart: per-tree dropout probability",
                      default=0.1, converter=TypeConverters.to_float)
    max_drop = Param("max_drop", "dart: max trees dropped per iteration",
                     default=50, converter=TypeConverters.to_int)
    skip_drop = Param("skip_drop", "dart: probability of skipping dropout",
                      default=0.5, converter=TypeConverters.to_float)
    monotone_constraints = ComplexParam(
        "monotone_constraints", "per-feature +1/-1/0 monotonicity "
        "(reference monotoneConstraints; 'basic' method)", default=None)
    categorical_slot_indexes = ComplexParam(
        "categorical_slot_indexes", "feature indices treated as categorical "
        "codes (reference categoricalSlotIndexes; not ported yet)", default=None)
    early_stopping_round = Param("early_stopping_round", "stop after k rounds without "
                                 "validation improvement (0=off)", default=0,
                                 converter=TypeConverters.to_int)
    seed = Param("seed", "random seed", default=0, converter=TypeConverters.to_int)
    histogram_impl = Param("histogram_impl", "histogram backend: segment "
                           "(index_add_) | onehot (one-hot matmuls) | pallas "
                           "(on this package, the hand-written deterministic CUDA "
                           "histogram kernel, csrc/gbdt_hist.cu); equivalent "
                           "results", default="segment",
                           validator=lambda v: v in HIST_IMPLS)
    verbosity = Param("verbosity", "print eval metrics when > 0", default=-1,
                      converter=TypeConverters.to_int)
    model_string = ComplexParam(
        "model_string", "previous booster to continue training from "
        "(reference modelString; not ported yet)", default=None)
    mesh_config = ComplexParam("mesh_config", "mesh to shard rows over "
                               "(not ported yet)", default=None)
    device = Param("device", "torch device to train and score on: 'cuda' (default), "
                   "'cuda:N' or 'cpu'", default="cuda",
                   converter=TypeConverters.to_string,
                   validator=lambda v: device_type(v) in ("cuda", "cpu"))

    # ---- shared helpers ----
    def _features(self, df: DataFrame) -> np.ndarray:
        # float32 sources keep float32; everything else widens to float64
        cols = self.get("feature_cols")
        if cols:
            self.require_columns(df, *cols)
            arrs = [np.asarray(df.collect_column(c)) for c in cols]
            dt = (np.float32 if all(a.dtype == np.float32 for a in arrs)
                  else np.float64)
            return np.stack([np.asarray(a, dt) for a in arrs], axis=1)
        fc = self.get("features_col")
        self.require_columns(df, fc)
        col = df.collect_column(fc)
        if col.dtype == object:
            col = np.stack([np.asarray(v) for v in col])
        if col.dtype == np.float32:
            return col
        return np.asarray(col, np.float64)

    def _split_validation(self, df: DataFrame):
        vic = self.get("validation_indicator_col")
        if not vic:
            return df, None
        self.require_columns(df, vic)
        mask = np.asarray(df.collect_column(vic), bool)
        whole = df.collect()
        train = DataFrame([{k: v[~mask] for k, v in whole.items()}])
        valid = DataFrame([{k: v[mask] for k, v in whole.items()}])
        return train, valid

    def _train_kwargs(self) -> dict:
        if self.get("model_string") is not None:
            raise NotImplementedError("model_string (continued training) is not ported yet")
        if self.get("mesh_config") is not None:
            raise NotImplementedError("mesh_config (multi-device training) is not ported yet")
        return dict(
            num_iterations=self.get("num_iterations"),
            learning_rate=self.get("learning_rate"),
            num_leaves=self.get("num_leaves"),
            max_depth=self.get("max_depth"),
            max_bin=self.get("max_bin"),
            lambda_l1=self.get("lambda_l1"),
            lambda_l2=self.get("lambda_l2"),
            min_data_in_leaf=self.get("min_data_in_leaf"),
            min_sum_hessian=self.get("min_sum_hessian_in_leaf"),
            min_gain_to_split=self.get("min_gain_to_split"),
            feature_fraction=self.get("feature_fraction"),
            bagging_fraction=self.get("bagging_fraction"),
            bagging_freq=self.get("bagging_freq"),
            early_stopping_round=self.get("early_stopping_round"),
            boosting_type=self.get("boosting_type"),
            monotone_constraints=self.get("monotone_constraints"),
            categorical_features=self.get("categorical_slot_indexes"),
            seed=self.get("seed"),
            histogram_impl=self.get("histogram_impl"),
            verbose=self.get("verbosity") > 0,
            device=self.get("device"),
        )

    def _fit_fused(self, df: DataFrame, configs: list[dict]):
        raise NotImplementedError("the fused hyperparameter sweep (_fit_fused) is not "
                                  "ported yet")

    def _fitted(self, model):
        model.set(**{k: v for k, v in self._param_values.items() if model.has_param(k)})
        return model


class _LightGBMModelBase(Model, _LightGBMParams):
    booster = ComplexParam("booster", "trained Booster")
    features_shap_col = Param("features_shap_col", "when set, adds per-row "
                              "TreeSHAP contributions (F features + bias; "
                              "reference featuresShap)", default=None)

    def get_booster(self):
        return self.get("booster")

    def get_train_measures(self) -> dict:
        """Per-phase training instrumentation (reference
        ``TaskInstrumentationMeasures``, ``LightGBMPerformance.scala``)."""
        return getattr(self.get_booster(), "train_measures", {})

    def predict_contrib(self, features) -> np.ndarray:
        """Exact TreeSHAP contributions (N, K, F+1), computed on the host."""
        return self.get_booster().predict_contrib(features)

    def _maybe_shap(self, out: dict, x) -> None:
        col = self.get("features_shap_col")
        if col:
            contrib = self.predict_contrib(x)
            # single-output models emit (N, F+1); multiclass (N, K, F+1)
            out[col] = contrib[:, 0, :] if contrib.shape[1] == 1 else contrib

    def get_feature_importances(self, importance_type: str = "split") -> np.ndarray:
        return self.get_booster().feature_importance(importance_type)

    def save_native_model(self, path: str) -> None:
        raise NotImplementedError("save_native_model (LightGBM model.txt interop) is not "
                                  "ported yet; Booster.save writes the package's own format")


# ---------------- classification ----------------

class LightGBMClassifier(Estimator, _LightGBMParams):
    feature_name = "lightgbm"

    objective = Param("objective", "binary | multiclass (auto-detected from labels "
                      "when left at default)", default="auto")
    scale_pos_weight = Param("scale_pos_weight", "positive-class weight "
                             "multiplier (binary)", default=1.0,
                             converter=TypeConverters.to_float)
    is_unbalance = Param("is_unbalance", "auto-weight positives by "
                         "n_neg/n_pos (binary)", default=False,
                         converter=TypeConverters.to_bool)
    probability_col = Param("probability_col", "class probabilities output column",
                            default="probability")
    raw_prediction_col = Param("raw_prediction_col", "raw margin output column",
                               default="rawPrediction")

    def _fit(self, df: DataFrame) -> "LightGBMClassificationModel":
        train, valid = self._split_validation(df)
        x = self._features(train)
        self.require_columns(train, self.get("label_col"))
        y_raw = np.asarray(train.collect_column(self.get("label_col")))
        classes, y = np.unique(y_raw, return_inverse=True)
        num_class = len(classes)
        objective = self.get("objective")
        if objective == "auto":
            objective = "binary" if num_class <= 2 else "multiclass"
        w = (np.asarray(train.collect_column(self.get("weight_col")), np.float32)
             if self.get("weight_col") else None)
        vx = vy = None
        if valid is not None and valid.count() > 0:
            vx = self._features(valid)
            vy = np.searchsorted(classes, np.asarray(valid.collect_column(self.get("label_col"))))
        booster = train_booster(
            x, y.astype(np.float32), objective=objective, num_class=num_class,
            weights=w, valid_features=vx, valid_labels=vy,
            scale_pos_weight=self.get("scale_pos_weight"),
            is_unbalance=self.get("is_unbalance"), **self._train_kwargs())
        return self._fitted(LightGBMClassificationModel(booster=booster, classes=classes))


class LightGBMClassificationModel(_LightGBMModelBase):
    feature_name = "lightgbm"

    classes = ComplexParam("classes", "original class labels (argmax index -> label)")
    probability_col = Param("probability_col", "class probabilities output column",
                            default="probability")
    raw_prediction_col = Param("raw_prediction_col", "raw margin output column",
                               default="rawPrediction")

    def _transform(self, df: DataFrame) -> DataFrame:
        b = self.get_booster()
        classes = np.asarray(self.get("classes"))

        def per_part(part):
            x = self._features(DataFrame([part]))
            # one forest walk for both the margins and the probabilities
            raw, prob = b.raw_score_and_predict(x, device=self.get("device"))
            if b.objective == "binary":
                prob2 = np.stack([1 - prob, prob], axis=1)
                pred_idx = (prob >= 0.5).astype(int)
            else:
                prob2 = prob
                pred_idx = np.argmax(prob, axis=1)
            out = dict(part)
            out[self.get("raw_prediction_col")] = raw
            out[self.get("probability_col")] = prob2
            out[self.get("prediction_col")] = classes[pred_idx]
            self._maybe_shap(out, x)
            return out

        return df.map_partitions(per_part)


# ---------------- regression ----------------

class LightGBMRegressor(Estimator, _LightGBMParams):
    feature_name = "lightgbm"

    objective = Param("objective", "regression | regression_l1 | huber | "
                      "poisson | quantile | tweedie | gamma | mape",
                      default="regression")
    alpha = Param("alpha", "huber delta / quantile level", default=0.9,
                  converter=TypeConverters.to_float)
    tweedie_variance_power = Param(
        "tweedie_variance_power", "tweedie rho in [1, 2): 1 -> poisson limit, "
        "2 -> gamma-like", default=1.5, converter=TypeConverters.to_float)

    def _fit(self, df: DataFrame) -> "LightGBMRegressionModel":
        train, valid = self._split_validation(df)
        x = self._features(train)
        self.require_columns(train, self.get("label_col"))
        y = np.asarray(train.collect_column(self.get("label_col")), np.float32)
        w = (np.asarray(train.collect_column(self.get("weight_col")), np.float32)
             if self.get("weight_col") else None)
        vx = vy = None
        if valid is not None and valid.count() > 0:
            vx = self._features(valid)
            vy = np.asarray(valid.collect_column(self.get("label_col")), np.float32)
        booster = train_booster(
            x, y, objective=self.get("objective"), weights=w,
            objective_alpha=self.get("alpha"),
            tweedie_variance_power=self.get("tweedie_variance_power"),
            valid_features=vx, valid_labels=vy, **self._train_kwargs())
        return self._fitted(LightGBMRegressionModel(booster=booster))


class LightGBMRegressionModel(_LightGBMModelBase):
    feature_name = "lightgbm"

    def _transform(self, df: DataFrame) -> DataFrame:
        b = self.get_booster()

        def per_part(part):
            x = self._features(DataFrame([part]))
            out = dict(part)
            out[self.get("prediction_col")] = b.predict(x, device=self.get("device"))
            self._maybe_shap(out, x)
            return out

        return df.map_partitions(per_part)


# ---------------- ranking ----------------

class LightGBMRanker(Estimator, _LightGBMParams):
    """Not ported yet: lambdarank's padded-group lambdas come in a later slice."""

    feature_name = "lightgbm"

    def _fit(self, df: DataFrame):
        raise NotImplementedError("LightGBMRanker (objective 'lambdarank') is not "
                                  "ported yet")
