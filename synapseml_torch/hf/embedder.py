"""HuggingFaceSentenceEmbedder: text -> pooled encoder embedding on the card.

Counterpart of ``synapseml_tpu/hf/embedder.py`` (reference
``hf/HuggingFaceSentenceEmbedder.py:26-228``), with the same Params and
defaults plus ``device``: a BERT-style encoder in f32, masked mean pooling
(the sentence-transformers default) or CLS pooling, L2 normalisation on
request. ``model_name`` is a preset (``bert-base``, ``bert-tiny``) or a
local HuggingFace checkpoint directory
(:func:`..models.convert_hf.pretrained_encoder`, its tokenizer unless
``tokenizer`` is given). ``model_params`` is the encoder's ``state_dict``
(``embeddings.*``, ``encoder.*``); None means the directory's weights, or
for a preset the JAX initialisers drawn with numpy from seed 0
(:func:`..models.convert_jax.init_flax_bert_params`: the distribution,
not the bits, of ``PRNGKey(0)``).

Rows go through ``ShapeBucketer.slices`` and ``pad_rows``; padded rows
keep mask 1 so that their pooled denominators stay nonzero, and are sliced
off. Each (bucket, seq_len) takes one callable from the process-wide
``CompiledCache`` under ``"hf_embedder"``, run eagerly under
``torch.inference_mode()`` on a module built once a stage. With
``mesh_config`` each process embeds its rows of a batch over a mesh of the
process group and the embeddings are gathered on every process.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..core import batching as cb
from ..core.dataframe import DataFrame
from ..core.device import device_type, resolve_device
from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Transformer
from ..models.convert_hf import (host_tensor, legacy_prenorm_fixup, pretrained_encoder,
                                 resolve_model_source)
from ..models.convert_jax import bert_state_dict_from_flax, init_flax_bert_params
from ..models.nets.bert import BertEmbeddings, bert_base, bert_tiny
from ..models.nets.transformer import Encoder

__all__ = ["HuggingFaceSentenceEmbedder"]

_ARCHS = {"bert-base": bert_base, "bert-tiny": bert_tiny}


class BertEncoder(nn.Module):
    """Embeddings + encoder stack (no pooler, no head): ``[B, T]`` ids and
    mask -> ``[B, T, hidden]`` in ``cfg.dtype``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, input_ids, attention_mask):
        x = self.embeddings(input_ids)
        return self.encoder(x, attention_mask[:, None, None, :].bool())


def _init_encoder(cfg) -> dict[str, np.ndarray]:
    """A preset's encoder weights: the embeddings and encoder of
    ``init_flax_bert_params(cfg, seed=0)``, drawn before its head."""
    sd = bert_state_dict_from_flax(init_flax_bert_params(cfg, seed=0))
    return {k: v for k, v in sd.items() if not k.startswith(("pooler.", "classifier."))}


class HuggingFaceSentenceEmbedder(Transformer):
    feature_name = "hf"

    model_name = Param("model_name", "encoder preset or local HF checkpoint dir",
                       default="bert-tiny")
    model_params = ComplexParam("model_params", "the encoder's state_dict (None = "
                                "the checkpoint's, or random for a preset)", default=None)
    tokenizer = ComplexParam("tokenizer", "tokenizer spec/object", default=None)
    input_col = Param("input_col", "text column", default="text")
    output_col = Param("output_col", "embedding column", default="embeddings")
    pooling = Param("pooling", "mean | cls", default="mean",
                    validator=lambda v: v in ("mean", "cls"))
    normalize = Param("normalize", "L2-normalize embeddings (opt in for "
                      "cosine indexes; raw pooled vectors by default)", default=False,
                      converter=TypeConverters.to_bool)
    max_token_len = Param("max_token_len", "truncation length", default=128,
                          converter=TypeConverters.to_int)
    batch_size = Param("batch_size", "rows per padded batch", default=32,
                       converter=TypeConverters.to_int)
    mesh_config = ComplexParam("mesh_config", "MeshConfig for sharded embedding (a "
                               "batch's rows split over the data-parallel processes, "
                               "gathered on every process)", default=None)
    device = Param("device", "torch device: 'cuda' (default), 'cuda:N' or 'cpu'",
                   default="cuda", converter=TypeConverters.to_string,
                   validator=lambda v: device_type(v) in ("cuda", "cpu"))

    _TRANSIENT = ("_mesh",)  # the built model and engines are "_cache_*" entries
    _CACHE_KEYS = frozenset({"model_name", "model_params", "tokenizer",
                             "mesh_config", "pooling", "normalize", "device"})

    def set(self, **kw):
        out = super().set(**kw)
        if self._CACHE_KEYS & kw.keys():
            self.__dict__.pop("_cache_model", None)
            cb.invalidate_token(self)  # cached callables captured old state
        return out

    def _setup(self):
        """``(embed_fn, tokenizer)``: the module on its device, built once."""
        if self.__dict__.get("_cache_model") is None:
            device = resolve_device("HuggingFaceSentenceEmbedder", self.get("device"))
            mesh = None
            if self.get("mesh_config") is not None:
                from ..parallel.mesh import create_mesh

                mesh = create_mesh(self.get("mesh_config"))
            cfg, loaded, tok = resolve_model_source(
                self.get("model_name"), _ARCHS, self.get("tokenizer"),
                functools.partial(pretrained_encoder, dtype=torch.float32),
                preset_kwargs={"dtype": torch.float32})
            params = self.get("model_params")
            if params is None:
                params = loaded
            elif loaded is None:
                cfg = legacy_prenorm_fixup(cfg, params)
            if params is None:
                params = _init_encoder(cfg)
            with torch.device("meta"):
                module = BertEncoder(cfg)
            module.load_state_dict({k: host_tensor(v).to(device).to(
                cfg.param_dtype) for k, v in params.items()}, assign=True)
            module.eval()
            cls_pool, normalize = self.get("pooling") == "cls", self.get("normalize")

            def embed_fn(ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
                if mesh is not None:  # this process's rows; gathered below
                    ids, mask = mesh.shard_batch(ids), mesh.shard_batch(mask)
                with torch.inference_mode():
                    m = torch.from_numpy(mask).to(device)
                    h = module(torch.from_numpy(ids).to(device), m)  # [B, T, H]
                    if cls_pool:
                        pooled = h[:, 0]
                    else:
                        w = m[:, :, None].to(h.dtype)
                        pooled = (h * w).sum(dim=1) / w.sum(dim=1).clamp_min(1e-9)
                    if normalize:
                        pooled = pooled / torch.linalg.vector_norm(
                            pooled, dim=-1, keepdim=True).clamp_min(1e-9)
                    if mesh is not None:
                        from ..parallel.collectives import all_gather_dim

                        pooled = all_gather_dim(mesh, pooled, ("data", "fsdp"))
                    return pooled.float().cpu().numpy()

            self.__dict__["_mesh"] = mesh
            self.__dict__["_cache_model"] = (embed_fn, tok)
        return self.__dict__["_cache_model"]

    def _embed_for(self, bucket: int, seq_len: int):
        """The (batch bucket, seq len) callable through the CompiledCache: a
        mixed request stream builds at most ladder-many per sequence shape."""
        embed_fn, _tok = self._setup()
        return cb.get_compiled_cache().get(
            "hf_embedder", (bucket, seq_len), lambda: embed_fn,
            instance=cb.instance_token(self), dtype="int32")

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("input_col"))
        _embed_fn, tok = self._setup()
        B = self.get("batch_size")
        bucketer = cb.default_bucketer()
        mesh = self.__dict__.get("_mesh")
        dp = mesh.data_parallel_size() if mesh is not None else 1

        def per_part(p):
            texts = [str(t) for t in p[self.get("input_col")]]
            n = len(texts)
            if n == 0:
                q = dict(p)
                q[self.get("output_col")] = np.empty((0, 0), np.float32)
                return q
            enc = tok(texts, max_len=self.get("max_token_len"))
            ids = np.asarray(enc["input_ids"], np.int32)
            mask = np.asarray(enc["attention_mask"], np.int32)
            chunks = []
            for s, e, bucket in bucketer.slices(n, B):
                bucket = cb.round_up_to_multiple(bucket, dp)  # rows split evenly
                ib = cb.pad_rows(ids[s:e], bucket)
                # padded rows keep mask=1 so pooled denominators stay
                # nonzero; their embeddings are sliced off below
                mb = cb.pad_rows(mask[s:e], bucket, mode="constant", constant=1)
                embed = self._embed_for(bucket, ids.shape[1])
                chunks.append(cb.unpad_rows(embed(ib, mb), e - s))
            q = dict(p)
            q[self.get("output_col")] = np.concatenate(chunks, axis=0)
            return q

        return df.map_partitions(per_part)
