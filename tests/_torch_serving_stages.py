"""Servable text-scoring pipelines for the serving tests, one per package.

A request body is ``{"texts": [...]}`` (one to a few texts) or a string.
``TextsIn`` explodes each request row into one row per text,
``DeepTextModel`` scores the rows, ``ScoresOut`` folds them back into one
JSON reply per request: ``{"scores": [[...], ...], "prediction": [...]}``,
or ``{"error": ...}`` for a body with no text. The classes are module-level
so that ``save_stage``/``load_stage`` (a hot swap by path, a registry
publish) find them; ``J*`` are the JAX package's twins. The row functions
live in ``_torch_worker_stages``, whose own ``TextsIn``/``ScoresOut`` a
distributed worker imports without the JAX package.
"""

import numpy as np

from _torch_worker_stages import _explode, _fold
from synapseml_torch.core.pipeline import PipelineModel, Transformer
from synapseml_tpu.core.pipeline import PipelineModel as JPipelineModel
from synapseml_tpu.core.pipeline import Transformer as JTransformer

VOCAB = 256
MAX_TOKENS = 16
WORDS = ("good great bad awful film plot acting score long short the a of "
         "and was is not very really quite").split()


class TextsIn(Transformer):
    def _transform(self, df):
        return df.map_partitions(_explode)


class ScoresOut(Transformer):
    def _transform(self, df):
        return df.map_partitions(_fold)


class JTextsIn(JTransformer):
    def _transform(self, df):
        return df.map_partitions(_explode)


class JScoresOut(JTransformer):
    def _transform(self, df):
        return df.map_partitions(_fold)


class JTextPipeline(JPipelineModel):
    """The JAX pipeline under a class of this module: the JAX
    ``serve_pipeline_distributed`` puts the directory of the pipeline's
    class module on its workers' path, and ``synapseml_tpu/core`` there
    would shadow the standard library's ``platform``."""


def serving_pipelines(seed=0, port_device="cpu"):
    """(JAX pipeline, port pipeline) of bert-tiny f32 with the same weights."""
    import flax.linen as nn
    import jax
    import torch

    from synapseml_torch.models import convert_jax
    from synapseml_torch.models.nets import bert as tbert
    from synapseml_torch.models.text import DeepTextModel
    from synapseml_torch.models.tokenizer import HashingTokenizer
    from synapseml_tpu.models.flax_nets import bert as jbert
    from synapseml_tpu.models.text import DeepTextModel as JDeepTextModel

    jcfg = jbert.bert_tiny(vocab_size=VOCAB, dtype=jax.numpy.float32)
    init = jax.jit(jbert.BertClassifier(jcfg, 2).init)
    params = nn.unbox(init(jax.random.PRNGKey(seed), np.ones((1, 8), np.int32))["params"])
    rs = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: (np.asarray(a) + rs.normal(scale=0.05, size=a.shape)
                                     ).astype(np.float32), params)
    common = dict(tokenizer_config=HashingTokenizer(vocab_size=VOCAB).to_config(),
                  checkpoint="bert-tiny", num_classes=2, max_token_len=MAX_TOKENS,
                  batch_size=8)
    jmodel = JDeepTextModel(model_params=params, arch_config=jcfg, **common)
    tmodel = DeepTextModel(model_params=convert_jax.bert_state_dict_from_flax(params),
                           arch_config=tbert.bert_tiny(vocab_size=VOCAB, dtype=torch.float32),
                           device=port_device, **common)
    return (JPipelineModel(stages=[JTextsIn(), jmodel, JScoresOut()]),
            PipelineModel(stages=[TextsIn(), tmodel, ScoresOut()]))


def request_bodies(n, seed=0, bad_every=0):
    """``n`` bodies of 1-4 texts of 1-24 words (a string now and then),
    every ``bad_every``-th one without text."""
    rs = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if bad_every and i % bad_every == bad_every - 1:
            out.append({"texts": []} if i % 2 else {"oops": 1})
            continue
        texts = [" ".join(rs.choice(WORDS, size=int(rs.integers(1, 25))))
                 for _ in range(int(rs.integers(1, 5)))]
        out.append(texts[0] if i % 7 == 3 else {"texts": texts})
    return out


def request(base, method, path, body=None, headers=None, timeout=30.0):
    """One HTTP exchange on its own connection, with a socket timeout:
    ``(status, headers, body bytes)``. ``body`` is sent as JSON unless it
    is bytes."""
    import http.client
    import json
    from urllib.parse import urlsplit

    parts = urlsplit(base)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=timeout)
    try:
        data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
        conn.request(method, path, body=data, headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()
