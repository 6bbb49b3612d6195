"""Estimator / Transformer / Pipeline — the SparkML-compatible stage API.

Counterpart of ``synapseml_tpu/core/pipeline.py``: the same stage classes,
``Pipeline``/``PipelineModel`` chaining with one tracer span per pipeline
slot, and persistence through :mod:`.serialization`. Stages hold device
state (built modules, weights on the card) only in memory and rebuild it
lazily after load; saved artifacts carry host-side numpy weights only.
``Transformer.transform_source`` comes with the port of the scoring plane.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Sequence

from . import observability as _obs
from . import serialization
from .dataframe import DataFrame
from .logging import StageTelemetry
from .params import ComplexParam, Params

__all__ = ["PipelineStage", "Transformer", "Estimator", "Model", "Pipeline", "PipelineModel", "load_stage"]


class PipelineStage(Params, StageTelemetry):
    """Base of every stage; persists via metadata.json + out-of-band complex params."""

    def save(self, path: str, overwrite: bool = True) -> None:
        serialization.save_stage(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str) -> "PipelineStage":
        stage = serialization.load_stage(path)
        if cls is not PipelineStage and not isinstance(stage, cls):
            raise TypeError(f"loaded {type(stage).__name__}, expected {cls.__name__}")
        return stage

    def transform_schema(self, schema: dict) -> dict:
        """Best-effort schema propagation (SparkML transformSchema analog)."""
        return schema

    def require_columns(self, df: DataFrame, *cols: str) -> None:
        """Fail fast with a readable message when input columns are missing."""
        missing = [c for c in cols if c not in df.columns]
        if missing:
            raise ValueError(f"{type(self).__name__} ({self.uid}): input column(s) "
                             f"{missing} not found; DataFrame has {df.columns}")


class Transformer(PipelineStage):
    def _transform(self, df: DataFrame) -> DataFrame:  # pragma: no cover - abstract
        raise NotImplementedError

    def transform(self, df: DataFrame) -> DataFrame:
        return self.log_verb("transform", self._transform, df)

    def __call__(self, df: DataFrame) -> DataFrame:
        return self.transform(df)


class Estimator(PipelineStage):
    def _fit(self, df: DataFrame) -> "Model":  # pragma: no cover - abstract
        raise NotImplementedError

    def fit(self, df: DataFrame) -> "Model":
        return self.log_verb("fit", self._fit, df)


class Model(Transformer):
    """A fitted Transformer (SparkML Model[M])."""


def load_stage(path: str) -> PipelineStage:
    return serialization.load_stage(path)


def _stage_span(i: int, stage):
    return _obs.get_tracer().span(f"pipeline.stage[{i}]",
                                  {"stage": type(stage).__name__,
                                   "uid": getattr(stage, "uid", "?")})


class Pipeline(Estimator):
    stages = ComplexParam("stages", "ordered list of pipeline stages")

    def __init__(self, stages: Sequence[PipelineStage] | None = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))

    def _fit(self, df: DataFrame) -> "PipelineModel":
        fitted: list[Transformer] = []
        cur = df
        stages = self.get("stages") or []
        for i, stage in enumerate(stages):
            # one span per pipeline slot; the stage's own fit/transform span
            # nests inside it
            with _stage_span(i, stage):
                if isinstance(stage, Estimator):
                    model = stage.fit(cur)
                    fitted.append(model)
                    if i < len(stages) - 1:
                        cur = model.transform(cur)
                elif isinstance(stage, Transformer):
                    fitted.append(stage)
                    if i < len(stages) - 1:
                        cur = stage.transform(cur)
                else:
                    raise TypeError(f"pipeline stage {stage!r} is neither Estimator nor Transformer")
        return PipelineModel(stages=fitted)

    # persistence: stages are saved as numbered sub-directories
    def save(self, path: str, overwrite: bool = True) -> None:
        _save_pipeline_like(self, path, overwrite)

    @classmethod
    def load(cls, path: str) -> "Pipeline":
        return _load_pipeline_like(path)


class PipelineModel(Model):
    stages = ComplexParam("stages", "ordered list of fitted transformers")

    def __init__(self, stages: Sequence[Transformer] | None = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))

    def _transform(self, df: DataFrame) -> DataFrame:
        cur = df
        for i, stage in enumerate(self.get("stages") or []):
            with _stage_span(i, stage):
                cur = stage.transform(cur)
        return cur

    def save(self, path: str, overwrite: bool = True) -> None:
        _save_pipeline_like(self, path, overwrite)

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        return _load_pipeline_like(path)


def _save_pipeline_like(obj, path: str, overwrite: bool) -> None:
    serialization.prepare_dir(path, overwrite)
    stages = obj.get("stages") or []
    meta = {
        "class": f"{type(obj).__module__}.{type(obj).__qualname__}",
        "uid": obj.uid,
        "numStages": len(stages),
    }
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    for i, stage in enumerate(stages):
        stage.save(os.path.join(path, f"stage_{i:03d}"), overwrite=overwrite)


def _load_pipeline_like(path: str):
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    mod_name, _, cls_name = meta["class"].rpartition(".")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    stages = [serialization.load_stage(os.path.join(path, f"stage_{i:03d}"))
              for i in range(meta["numStages"])]
    obj = cls(stages=stages)
    obj.uid = meta["uid"]
    return obj
