from .batching import ShapeBucketer, default_bucketer, pad_rows, unpad_rows
from .dataframe import DataFrame, Partition, concat_partitions, schema_of
from .observability import Tracer, get_tracer
from .params import ComplexParam, GlobalParams, Param, Params, TypeConverters
from .pipeline import Estimator, Model, Pipeline, PipelineModel, PipelineStage, Transformer, load_stage

__all__ = [
    "DataFrame", "Partition", "concat_partitions", "schema_of",
    "Param", "ComplexParam", "Params", "GlobalParams", "TypeConverters",
    "PipelineStage", "Transformer", "Estimator", "Model", "Pipeline", "PipelineModel", "load_stage",
    "ShapeBucketer", "default_bucketer", "pad_rows", "unpad_rows",
    "Tracer", "get_tracer",
]
