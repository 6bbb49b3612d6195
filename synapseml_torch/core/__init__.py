from .batching import (
    CompiledCache,
    ShapeBucketer,
    default_bucketer,
    get_compiled_cache,
    instance_token,
    invalidate_token,
    pad_rows,
    reset_compiled_cache,
    set_default_bucketer,
    unpad_rows,
)
from .dataframe import DataFrame, Partition, concat_partitions, schema_of
from .faults import FaultPlan, FaultSpec, active_fault_plan, inject_faults
from .observability import (
    MetricsRegistry,
    Span,
    SpanContext,
    Tracer,
    chrome_trace_events,
    export_chrome_trace,
    get_registry,
    get_tracer,
    register_instrumentation,
    reset_registry,
    reset_tracer,
)
from .params import ComplexParam, GlobalParams, Param, Params, TypeConverters
from .pipeline import Estimator, Model, Pipeline, PipelineModel, PipelineStage, Transformer, load_stage
from .resilience import (
    CircuitBreaker,
    Deadline,
    DeadlineExpired,
    RetryBudget,
    RetryPolicy,
    all_resilience_measures,
    reset_resilience_measures,
    resilience_measures,
)

__all__ = [
    "DataFrame", "Partition", "concat_partitions", "schema_of",
    "Param", "ComplexParam", "Params", "GlobalParams", "TypeConverters",
    "PipelineStage", "Transformer", "Estimator", "Model", "Pipeline", "PipelineModel", "load_stage",
    "RetryPolicy", "RetryBudget", "CircuitBreaker", "Deadline", "DeadlineExpired",
    "resilience_measures", "reset_resilience_measures", "all_resilience_measures",
    "ShapeBucketer", "CompiledCache", "get_compiled_cache",
    "reset_compiled_cache", "default_bucketer", "set_default_bucketer",
    "instance_token", "invalidate_token", "pad_rows", "unpad_rows",
    "MetricsRegistry", "get_registry", "reset_registry",
    "register_instrumentation",
    "Tracer", "Span", "SpanContext", "get_tracer", "reset_tracer",
    "chrome_trace_events", "export_chrome_trace",
    "FaultSpec", "FaultPlan", "inject_faults", "active_fault_plan",
]
