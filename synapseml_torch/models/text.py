"""DeepTextModel — BERT text scoring on the card.

Counterpart of ``DeepTextModel`` in ``synapseml_tpu/models/text.py``: the
same Param names and validators, the same per-partition loop (tokenize,
``ShapeBucketer.slices``, ``pad_rows``, forward, softmax, ``unpad_rows``),
and a module that is built once per stage — weights moved to the device
once — and dropped when a param it depends on changes. Scoring runs under
``torch.inference_mode()`` on ``device`` (default ``"cuda"``; a host
without a CUDA device must ask for ``"cpu"``).

``model_params`` is this package's ``state_dict`` as numpy arrays;
:func:`..convert_jax.bert_state_dict_from_flax` maps a JAX model's Flax
tree to it. ``DeepTextClassifier`` (fine-tuning) comes with the training
slice, sharded inference (``mesh_config``) with the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import DataFrame, Model
from ..core import batching as cb
from ..core.params import ComplexParam, Param, TypeConverters
from .nets.bert import BertClassifier, bert_base, bert_tiny
from .tokenizer import resolve_tokenizer

__all__ = ["DeepTextModel", "legacy_prenorm_fixup"]

_ARCHS = {"bert-base": bert_base, "bert-tiny": bert_tiny}


def _resolve_arch(name: str):
    """Known preset or fail fast — a typo must not silently score with a
    mis-shaped architecture."""
    try:
        return _ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown checkpoint {name!r}; available presets: "
                         f"{sorted(_ARCHS)}") from None


def _device_type(spec: str) -> str | None:
    try:
        return torch.device(spec).type
    except RuntimeError:
        return None


def legacy_prenorm_fixup(cfg, state_dict):
    """Saved artifacts from before the BERT post-norm change carry pre-norm
    param layouts (an encoder-level final norm) with no arch_config; rebuild
    the architecture they were trained as instead of silently mis-evaluating."""
    if cfg.norm_position == "post" and "encoder.norm.weight" in state_dict:
        return dataclasses.replace(cfg, norm_position="pre", norm_eps=1e-6,
                                   act="gelu_tanh")
    return cfg


class _TextParams:
    text_col = Param("text_col", "input text column", default="text")
    label_col = Param("label_col", "label column", default="label")
    prediction_col = Param("prediction_col", "argmax output column", default="prediction")
    scores_col = Param("scores_col", "softmax scores output column", default="scores")
    checkpoint = Param("checkpoint", "architecture preset", default="bert-tiny")
    num_classes = Param("num_classes", "number of classes", default=2,
                        converter=TypeConverters.to_int)
    max_token_len = Param("max_token_len", "max sequence length (reference default 128)",
                          default=128, converter=TypeConverters.to_int)
    batch_size = Param("batch_size", "global batch size", default=32,
                       converter=TypeConverters.to_int)


class DeepTextModel(Model, _TextParams):
    feature_name = "deep_learning"

    model_params = ComplexParam("model_params", "trained parameters: this "
                                "package's BertClassifier state_dict as numpy "
                                "arrays (convert_jax maps a Flax tree)")
    arch_config = ComplexParam("arch_config", "TransformerConfig (None = "
                               "resolve checkpoint preset)", default=None)
    tokenizer_config = ComplexParam("tokenizer_config", "tokenizer config dict")
    train_metrics = ComplexParam("train_metrics", "loss/throughput trace", default=None)
    attn_impl = Param("attn_impl", "serve-time attention backend override: "
                      "einsum | flash (None = the trained arch's choice); "
                      "pure kernel selection — the parameters are unchanged",
                      default=None,
                      validator=lambda v: v in (None, "einsum", "flash"))
    device = Param("device", "torch device to score on: 'cuda' (default), "
                   "'cuda:N' or 'cpu'", default="cuda",
                   converter=TypeConverters.to_string,
                   validator=lambda v: _device_type(v) in ("cuda", "cpu"))

    _APPLY_KEYS = frozenset({"model_params", "arch_config", "tokenizer_config",
                             "checkpoint", "num_classes", "attn_impl", "device"})

    def __init__(self, **kw):
        super().__init__(**kw)
        self._module = None

    def _post_load(self):
        self._module = None

    def set(self, **kw):
        out = super().set(**kw)
        if self._APPLY_KEYS & kw.keys():
            self._module = None  # the built module captured the old values
        return out

    def _resolve_device(self) -> torch.device:
        device = torch.device(self.get("device"))
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DeepTextModel: device={self.get('device')!r} but this host has "
                "no CUDA device; pass device='cpu' to score on the CPU")
        return device

    def _get_module(self) -> BertClassifier:
        """The module on its device, built once per stage."""
        if self._module is None:
            tok = resolve_tokenizer(self.get("tokenizer_config"))
            params = self.get("model_params")
            cfg = self.get("arch_config")
            if cfg is None:
                cfg = _resolve_arch(self.get("checkpoint"))(vocab_size=tok.vocab_size)
                cfg = legacy_prenorm_fixup(cfg, params)
            if self.get("attn_impl"):
                # serve-time kernel override: same math, same parameters
                cfg = dataclasses.replace(cfg, attn_impl=self.get("attn_impl"))
            if tok.vocab_size > cfg.vocab_size:
                raise ValueError(f"tokenizer vocab {tok.vocab_size} exceeds the "
                                 f"model's embedding table ({cfg.vocab_size})")
            device = self._resolve_device()
            with torch.device("meta"):
                module = BertClassifier(cfg, num_classes=self.get("num_classes"))
            state = {k: torch.as_tensor(np.asarray(v)).to(device=device,
                                                          dtype=cfg.param_dtype)
                     for k, v in params.items()}
            module.load_state_dict(state, assign=True)
            self._tok, self._device = tok, device
            self._module = module.eval()
        return self._module

    def _score(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Softmax scores of one padded batch, as a host array."""
        module = self._get_module()
        with torch.inference_mode():
            logits = module(torch.from_numpy(ids).to(self._device),
                            torch.from_numpy(mask).to(self._device))
            return torch.softmax(logits, dim=-1).cpu().numpy()

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("text_col"))
        self._get_module()
        bs = self.get("batch_size")
        bucketer = cb.default_bucketer()

        def per_part(part):
            texts = list(part[self.get("text_col")])
            if not texts:
                # keep the output schema rectangular across partitions
                out = dict(part)
                out[self.get("scores_col")] = np.zeros((0, self.get("num_classes")), np.float32)
                out[self.get("prediction_col")] = np.zeros(0, np.int32)
                return out
            enc = self._tok(texts, max_len=self.get("max_token_len"))
            ids = np.asarray(enc["input_ids"])
            mask = np.asarray(enc["attention_mask"])
            probs_chunks = []
            for s, e, bucket in bucketer.slices(len(texts), bs):
                p = self._score(cb.pad_rows(ids[s:e], bucket), cb.pad_rows(mask[s:e], bucket))
                probs_chunks.append(cb.unpad_rows(p, e - s))
            probs = np.concatenate(probs_chunks, axis=0)
            out = dict(part)
            out[self.get("scores_col")] = probs
            out[self.get("prediction_col")] = np.argmax(probs, axis=-1).astype(np.int32)
            return out

        return df.map_partitions(per_part)
