"""The port's public surface against the JAX package's.

* Every stage class of ``synapseml_torch`` that has a same-named class in
  the mirrored ``synapseml_tpu`` module has the same Params, the port's
  ``device`` the only addition (a Param the port lacks is allowed only
  where a queue A item of ROADMAP.md names it).
* Every name in the ``__all__`` of a JAX subpackage the port mirrors is
  exported by the port's subpackage, or waits for the queue A item named
  beside it here.
* ``core.batching``: ``set_default_bucketer`` swaps the process ladder and
  ``reset_compiled_cache`` the process cache, as the JAX ones do;
  ``release_executables`` evicts the entries the JAX function evicts.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest

import synapseml_torch
from synapseml_torch.core import DataFrame
from synapseml_torch.core import batching as cb
from synapseml_torch.core.params import Params as TParams
from synapseml_torch.hf.embedder import HuggingFaceSentenceEmbedder
from synapseml_torch.models.text import DeepTextModel
from synapseml_torch.models.tokenizer import HashingTokenizer


def _stage_pairs() -> list[tuple[str, type, type]]:
    pairs = []
    for info in pkgutil.walk_packages(synapseml_torch.__path__, "synapseml_torch."):
        mod = importlib.import_module(info.name)
        for name, cls in vars(mod).items():
            if not (inspect.isclass(cls) and issubclass(cls, TParams)
                    and cls.__module__ == info.name and cls is not TParams):
                continue
            jmod = importlib.import_module(info.name.replace("synapseml_torch", "synapseml_tpu"))
            pairs.append((f"{info.name.split('.', 1)[1]}.{name}", cls, getattr(jmod, name)))
    return pairs


_PAIRS = _stage_pairs()

# Params of a JAX stage the port does not have yet, by class
_WAITING_PARAMS: dict = {}


def test_every_ported_stage_class_is_compared():
    names = {p[0].rsplit(".", 1)[1] for p in _PAIRS}
    assert len(_PAIRS) >= 24
    assert {"DeepTextModel", "DeepTextClassifier", "DeepVisionModel", "HuggingFaceCausalLM",
            "HuggingFaceSentenceEmbedder", "ONNXModel", "ImageFeaturizer",
            "LightGBMClassifier", "ImageTransformer"} <= names


@pytest.mark.parametrize("qualname,port,ref", _PAIRS, ids=[p[0] for p in _PAIRS])
def test_stage_params_match_the_jax_stage(qualname, port, ref):
    extra = set(port.params()) - set(ref.params())
    missing = set(ref.params()) - set(port.params())
    assert extra <= {"device"}, extra
    assert missing == _WAITING_PARAMS.get(port.__name__, set()), missing


def test_deep_text_model_mesh_config_is_refused_with_its_item():
    """The Param (the JAX stage takes it), refused until the multi-GPU plane
    was ported, now builds the stage's mesh beside its module: a world of
    one process here (sharded scoring over gloo ranks is the same code,
    held in test_torch_mesh.py's collectives)."""
    from synapseml_torch.models import text as ttext
    from synapseml_torch.models.nets.bert import bert_tiny
    from synapseml_torch.models.tokenizer import HashingTokenizer
    from synapseml_torch.parallel import MeshConfig, MeshContext

    tok = HashingTokenizer(vocab_size=64)
    cfg = bert_tiny(vocab_size=64)
    model = DeepTextModel(mesh_config=MeshConfig(data=1), device="cpu", arch_config=cfg,
                          model_params=ttext._init_params(cfg, 2, 0),
                          tokenizer_config=tok.to_config())
    assert model.get("mesh_config") == MeshConfig(data=1)
    model._get_module()
    assert isinstance(model._mesh, MeshContext) and model._mesh.data_parallel_size() == 1


# Names of a JAX subpackage's __all__ that wait, by the ROADMAP.md queue A
# item that ports them
_WAITING_EXPORTS = {
    "core": {"ServiceParam": "12", "StopWatch": "12", "retry_with_timeout": "12", "using": "12",
             "ClusterInfo": "12", "cluster_info": "12"},
    "gbdt": {"train_boosters_fused": "11"},
    # the HTTP clients, eager readers and writers and Power BI (item 12)
    "io": {"HTTPRequest": "12", "HTTPResponse": "12", "HTTPTransformer": "12",
           "SimpleHTTPTransformer": "12", "JSONInputParser": "12", "JSONOutputParser": "12",
           "CustomInputParser": "12", "StringOutputParser": "12", "AsyncHTTPClient": "12",
           "send_with_retries": "12", "read_binary_files": "12", "read_image_files": "12",
           "read_csv": "12", "write_csv": "12", "read_jsonl": "12", "write_jsonl": "12",
           "PowerBIWriter": "12"},
    "models": {"ModelDownloader": "12", "ModelSchema": "12", "CNTKModel": "12",
               "FusedTrainer": "9", "fused_fit_source": "9", "fused_fit_arrays": "9",
               "PipelineTrainer": "9"},
    # the publish-time executable recorder waits for an AOT mechanism, which
    # the port has none of by design (ROADMAP.md section C)
    "registry": {"AOTCapture": "C"},
    # the GPipe pipeline: item 9's pipe axis
    "parallel": {"pipeline_apply": "9", "pipeline_sharded": "9", "stack_stage_params": "9"},
}
_SUBPACKAGES = ("continual", "core", "data", "fleet", "gbdt", "hf", "image", "io", "models",
                "nn", "onnx", "ops", "parallel", "registry", "retrieval", "scoring")


@pytest.mark.parametrize("sub", _SUBPACKAGES)
def test_exports_cover_the_jax_all(sub):
    port = importlib.import_module(f"synapseml_torch.{sub}")
    ref = importlib.import_module(f"synapseml_tpu.{sub}")
    waiting = _WAITING_EXPORTS.get(sub, {})
    port_all = set(getattr(port, "__all__", ()))
    for name in ref.__all__:
        if name in port_all:
            assert hasattr(port, name), name
        else:
            assert name in waiting, f"synapseml_torch.{sub} lacks {name}"
            assert not hasattr(port, name), f"{name} is ported: export it"
    assert not set(waiting) & port_all and set(waiting) <= set(ref.__all__)  # no stale entry


def test_models_and_core_export_the_ported_names():
    from synapseml_torch import core, models
    from synapseml_torch.models import trainer

    assert models.Trainer is trainer.Trainer and models.TrainState is trainer.TrainState
    assert models.TrainerConfig is trainer.TrainerConfig
    assert models.cross_entropy_loss is trainer.cross_entropy_loss
    for name in ("CompiledCache", "get_compiled_cache", "instance_token", "invalidate_token",
                 "MetricsRegistry", "get_registry", "reset_registry", "Span", "RetryPolicy",
                 "RetryBudget", "resilience_measures", "reset_resilience_measures",
                 "reset_compiled_cache", "set_default_bucketer", "CircuitBreaker", "Deadline",
                 "SpanContext", "reset_tracer", "chrome_trace_events",
                 "all_resilience_measures"):
        assert name in core.__all__ and hasattr(core, name), name


def _embedder():
    return HuggingFaceSentenceEmbedder(model_name="bert-tiny", batch_size=16, max_token_len=16,
                                       tokenizer=HashingTokenizer(vocab_size=512).to_config(),
                                       device="cpu")


def _embed(stage, n):
    texts = [f"row {i} of the swapped ladder" for i in range(n)]
    out = stage.transform(DataFrame.from_dict({"text": np.asarray(texts, dtype=object)}))
    return np.stack(list(out.collect_column("embeddings")))


def test_set_default_bucketer_swaps_the_process_ladder():
    """As tests/test_batching.py's exact_bucketer: a ladder with every rung
    makes a stage run its rows unpadded (bucket == rows, read from the keys
    of a fresh process cache); the swap returns the previous ladder, which
    restores the padded run."""
    cache = cb.reset_compiled_cache()
    try:
        assert cb.get_compiled_cache() is cache and cache.stats()["misses"] == 0
        stage = _embedder()
        padded = _embed(stage, 5)
        prev = cb.set_default_bucketer(cb.ShapeBucketer(ladder=list(range(1, 17))))
        try:
            assert cb.default_bucketer().bucket_for(5) == 5
            exact = _embed(stage, 5)
        finally:
            assert cb.set_default_bucketer(prev).ladder == tuple(range(1, 17))
        assert cb.default_bucketer() is prev
        buckets = sorted(k[2][0] for k in cache._entries if k[0] == "hf_embedder")
        assert buckets == [5, 8] and cache.stats()["misses"] == 2
        np.testing.assert_allclose(exact, padded, atol=2e-2)  # bf16 compute
        assert exact.shape == (5, 64)
    finally:
        fresh = cb.reset_compiled_cache()
    assert fresh is not cache and cb.get_compiled_cache() is fresh


def test_release_executables_evicts_what_the_jax_function_evicts():
    """A pipeline of two stages (one in a nested ``stages`` list), each with
    a cached entry, and a third stage outside it: the port's
    ``release_executables`` evicts the entries the JAX function evicts (the
    pipeline's two), keeps the outsider's, and gives each released stage a
    fresh token."""
    from synapseml_torch.core.pipeline import PipelineModel as TPipelineModel
    from synapseml_tpu.core import batching as jcb
    from synapseml_tpu.core.pipeline import PipelineModel as JPipelineModel

    def run(batching, pipeline_cls):
        cache = batching.reset_compiled_cache()
        try:
            inner, other, outsider = _embedder(), _embedder(), _embedder()
            pipe = pipeline_cls(stages=[inner, pipeline_cls(stages=[other])])
            for i, st in enumerate((inner, other, outsider)):
                cache.get(f"fn{i}", (8,), lambda: (lambda: None),
                          instance=batching.instance_token(st))
            tokens = [batching.instance_token(st) for st in (inner, other, outsider)]
            batching.release_executables(pipe)
            kept = sorted(k[0] for k in cache._entries)
            fresh = [batching.instance_token(st) != t
                     for st, t in zip((inner, other, outsider), tokens)]
            return kept, fresh, cache.stats()["evictions"]
        finally:
            batching.reset_compiled_cache()

    port = run(cb, TPipelineModel)
    assert port == run(jcb, JPipelineModel)
    assert port == (["fn2"], [True, True, False], 2)
