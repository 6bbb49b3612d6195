"""DeepTextClassifier / DeepTextModel — BERT fine-tuning and scoring on the card.

Counterpart of ``synapseml_tpu/models/text.py``, with the same Param names,
defaults and validators.

``DeepTextClassifier`` (``:60-178`` there) tokenizes the text column, fits a
BERT classifier with :func:`..trainer.fit_arrays` (linear warm-up over a
tenth of the steps, then linear decay; AdamW; ``unfreeze_layers`` freezes
all but the last N encoder layers and the head) at its default
``scan_chunk`` of 8, as the reference does: on the card, chunks of 8 steps
run as captured CUDA graphs (``Trainer.train_steps_scan``), and returns a
``DeepTextModel`` holding the fitted ``state_dict``, the architecture it
was trained as and the trainer's ``train_metrics``. ``checkpoint`` is a
preset or a local HuggingFace checkpoint directory (``:117-137`` there):
a directory gives the architecture and the pretrained initial weights
(:func:`..convert_hf.pretrained_text_classifier`, a missing or mis-sized
head seeded as the JAX mapping seeds it) and its own tokenizer unless
``tokenizer`` is given. A preset's initial weights come from
``_init_params``: the JAX package's initialisers drawn with numpy from
``seed`` (:func:`..convert_jax.init_flax_bert_params`), the same
distribution, not the same bits, as ``jax.random.PRNGKey(seed)``. Training
runs either attention: ``attn_impl='flash'`` goes through the flash
forward and backward kernels.

``DeepTextModel`` keeps the JAX stage's per-partition loop (tokenize,
``ShapeBucketer.slices``, ``pad_rows``, forward, softmax, ``unpad_rows``),
and builds its module once per stage — weights moved to the device once —
dropping it when a param it depends on changes. Each padded batch shape
``(bucket, seq_len)`` gets its scoring callable from ``CompiledCache``
under the JAX stage's fn id ``"deep_text_model"`` and the stage's instance
token, so a scoring stream takes at most ladder-many misses and a warmed
stage (a serving hot swap's warmup) takes none at the shapes its warmup
drove; a change of a param the module depends on invalidates the token.
The callables run eagerly under ``torch.inference_mode()``.
``_AUTOTUNE_PARAMS`` declares ``attn_impl`` (einsum or flash) to the
registry's publish-time search, as the JAX stage does; ``_AUTOTUNE_PLAIN``
names einsum as the flash kernel's plain version, which the search on the
card times but never pins.

Both stages run on ``device`` (default ``"cuda"``; a host without a CUDA
device must ask for ``"cpu"``). ``model_params`` is this package's
``state_dict`` as numpy arrays; :func:`..convert_jax.bert_state_dict_from_flax`
maps a JAX model's Flax tree to it.

``checkpoint_dir`` writes the fit's training checkpoints there
(``checkpoint_every``, ``checkpoint_keep``; an
:class:`~synapseml_torch.parallel.AsyncCheckpointer`); ``mesh_config``
trains over a mesh of the process group (:func:`..parallel.create_mesh`:
every process fits the same DataFrame and takes its rows of each batch),
where ``attn_impl='ring'``/``'ulysses'`` shard the tokens over the mesh's
``seq`` axis (the local flash kernel, with a warning, when it has size 1).
``DeepTextModel(mesh_config=)`` scores each batch's rows over the
data-parallel processes and gathers the scores on every process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import DataFrame, Estimator, Model
from ..core import batching as cb
from ..core.device import device_type, resolve_device
from ..core.params import ComplexParam, Param, TypeConverters
from ..parallel.mesh import create_mesh
from .convert_hf import (host_tensor, is_checkpoint_dir, legacy_prenorm_fixup,
                         pretrained_text_classifier, tokenizer_for_checkpoint)
from .convert_jax import bert_state_dict_from_flax, init_flax_bert_params
from .nets.bert import BertClassifier, bert_base, bert_tiny
from .tokenizer import resolve_tokenizer
from .trainer import (Trainer, TrainerConfig, _fit_with_optional_checkpointing, fit_arrays,
                      plan_fit)

__all__ = ["DeepTextClassifier", "DeepTextModel"]

_ARCHS = {"bert-base": bert_base, "bert-tiny": bert_tiny}


def _resolve_arch(name: str):
    """Known preset or fail fast — a typo must not silently score with a
    mis-shaped architecture."""
    try:
        return _ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown checkpoint {name!r}; available presets: "
                         f"{sorted(_ARCHS)} (or pass a local HF checkpoint "
                         f"directory for pretrained weights)") from None


def _init_params(cfg, num_classes: int, seed: int) -> dict:
    """The classifier's initial ``state_dict``: the JAX package's
    initialisers, drawn with numpy from ``seed``."""
    return bert_state_dict_from_flax(init_flax_bert_params(cfg, num_classes, seed))


class _TextParams:
    text_col = Param("text_col", "input text column", default="text")
    label_col = Param("label_col", "label column", default="label")
    prediction_col = Param("prediction_col", "argmax output column", default="prediction")
    scores_col = Param("scores_col", "softmax scores output column", default="scores")
    checkpoint = Param("checkpoint", "architecture preset or HF checkpoint name",
                       default="bert-tiny")
    num_classes = Param("num_classes", "number of classes", default=2,
                        converter=TypeConverters.to_int)
    max_token_len = Param("max_token_len", "max sequence length (reference default 128)",
                          default=128, converter=TypeConverters.to_int)
    batch_size = Param("batch_size", "global batch size", default=32,
                       converter=TypeConverters.to_int)
    device = Param("device", "torch device: 'cuda' (default), 'cuda:N' or 'cpu'",
                   default="cuda", converter=TypeConverters.to_string,
                   validator=lambda v: device_type(v) in ("cuda", "cpu"))


class DeepTextClassifier(Estimator, _TextParams):
    feature_name = "deep_learning"

    learning_rate = Param("learning_rate", "peak learning rate", default=5e-5,
                          converter=TypeConverters.to_float)
    num_train_epochs = Param("num_train_epochs", "training epochs", default=3,
                             converter=TypeConverters.to_int)
    max_steps = Param("max_steps", "hard cap on optimizer steps (-1 = epochs decide)",
                      default=-1, converter=TypeConverters.to_int)
    unfreeze_layers = Param("unfreeze_layers",
                            "train only the last N encoder layers (+head); -1 = all "
                            "(reference LitDeepTextModel._fine_tune_layers)",
                            default=-1, converter=TypeConverters.to_int)
    grad_accum = Param("grad_accum", "gradient accumulation steps "
                       "(horovod backward_passes_per_step analog)", default=1,
                       converter=TypeConverters.to_int)
    seed = Param("seed", "init seed", default=0, converter=TypeConverters.to_int)
    checkpoint_dir = Param("checkpoint_dir", "when set, write async training "
                           "checkpoints here; resume through "
                           "trainer.fit_source(resume_from=)", default=None)
    checkpoint_every = Param("checkpoint_every", "checkpoint every N optimizer "
                             "steps — the scanned chunk shrinks to N when smaller "
                             "(0 = only the final state)", default=0,
                             converter=TypeConverters.to_int)
    checkpoint_keep = Param("checkpoint_keep", "retain the most recent K "
                            "checkpoints", default=3,
                            converter=TypeConverters.to_int)
    attn_impl = Param("attn_impl", "attention backend: einsum | flash | ring "
                      "| ulysses (None = architecture default; ring/ulysses "
                      "need a mesh with a seq axis > 1; ulysses also needs "
                      "n_heads divisible by the seq-axis size)", default=None,
                      validator=lambda v: v in (None, "einsum", "flash",
                                                "ring", "ulysses"))
    tokenizer = ComplexParam("tokenizer", "tokenizer object/config/name", default=None)
    mesh_config = ComplexParam("mesh_config", "MeshConfig override", default=None)
    weight_decay = Param("weight_decay", "adamw weight decay", default=0.01,
                         converter=TypeConverters.to_float)

    def _make_config(self, vocab_size: int):
        return _resolve_arch(self.get("checkpoint"))(vocab_size=vocab_size)

    def _freeze_predicate(self, n_layers_total: int):
        """Frozen unless in the head or in the last ``unfreeze_layers``
        encoder layers, on this package's parameter names
        (``encoder.layers.<i>`` is the Flax ``layer_<i>``)."""
        n = self.get("unfreeze_layers")
        if n is None or n < 0:
            return None
        trainable = {str(i) for i in range(max(n_layers_total - n, 0), n_layers_total)}

        def frozen(path: tuple[str, ...]) -> bool:
            if path and path[0] in ("classifier", "pooler"):
                return False
            return not (path[:2] == ("encoder", "layers") and len(path) > 2
                        and path[2] in trainable)

        return frozen

    def _fit_plan(self, df: DataFrame):
        """What the fit runs: ``(trainer, data, fit_arrays keywords, cfg,
        tokenizer)`` for ``df``, the trainer on the stage's device with its
        module and ``TrainerConfig``, the keywords those of the reference
        stage's ``fit_arrays`` call (its default ``scan_chunk``)."""
        device = resolve_device("DeepTextClassifier", self.get("device"))
        ck, num_classes = self.get("checkpoint"), self.get("num_classes")
        if is_checkpoint_dir(ck):
            # a local HF checkpoint directory: pretrained weights and its
            # tokenizer (the reference's AutoModelForSequenceClassification
            # transfer-learning path, dl/DeepTextClassifier.py:27-288)
            cfg, init = pretrained_text_classifier(ck, num_classes=num_classes,
                                                   seed=self.get("seed"))
            tok = tokenizer_for_checkpoint(self.get("tokenizer"), ck, cfg.vocab_size)
        else:
            tok = resolve_tokenizer(self.get("tokenizer"))
            cfg = self._make_config(tok.vocab_size)
            init = _init_params(cfg, num_classes, self.get("seed"))
        if self.get("attn_impl"):
            cfg = dataclasses.replace(cfg, attn_impl=self.get("attn_impl"))
        with torch.device("meta"):
            module = BertClassifier(cfg, num_classes=num_classes)
        module = module.to_empty(device="cpu")

        texts = df.collect_column(self.get("text_col"))
        labels = df.collect_column(self.get("label_col")).astype(np.int32)
        encoded = tok(list(texts), max_len=self.get("max_token_len"))
        data = {**encoded, "labels": labels}

        bs, total = plan_fit(len(labels), self.get("batch_size"),
                             self.get("num_train_epochs"), self.get("max_steps"))
        tcfg = TrainerConfig(
            learning_rate=self.get("learning_rate"),
            weight_decay=self.get("weight_decay"),
            total_steps=total, grad_accum=self.get("grad_accum"),
            warmup_steps=max(total // 10, 1), lr_schedule="linear",
            freeze_predicate=self._freeze_predicate(cfg.n_layers),
        )
        mesh = (create_mesh(self.get("mesh_config"))
                if self.get("mesh_config") is not None else None)
        trainer = Trainer(module, tcfg, device=device, mesh=mesh)
        kw = dict(batch_size=bs, total_steps=total, seed=self.get("seed"), init_params=init)
        return trainer, data, kw, cfg, tok

    def _fit(self, df: DataFrame) -> "DeepTextModel":
        trainer, data, kw, cfg, tok = self._fit_plan(df)
        num_classes = self.get("num_classes")
        state = _fit_with_optional_checkpointing(
            self, lambda ck, every: fit_arrays(trainer, data, checkpointer=ck,
                                               checkpoint_every=every, **kw))
        trainer.release_graphs()  # the captured steps' memory pools
        model_params = {k: v.detach().cpu().numpy() for k, v in state.params.items()}
        # the arch is always saved, so the model keeps evaluating with the
        # architecture it was trained as
        return DeepTextModel(
            model_params=model_params,
            arch_config=cfg,
            tokenizer_config=tok.to_config(),
            checkpoint=self.get("checkpoint"),
            num_classes=num_classes,
            text_col=self.get("text_col"),
            prediction_col=self.get("prediction_col"),
            scores_col=self.get("scores_col"),
            max_token_len=self.get("max_token_len"),
            batch_size=self.get("batch_size"),
            device=self.get("device"),
            train_metrics=trainer.metrics,
        )


class DeepTextModel(Model, _TextParams):
    feature_name = "deep_learning"

    model_params = ComplexParam("model_params", "trained parameters: this "
                                "package's BertClassifier state_dict as numpy "
                                "arrays (convert_jax maps a Flax tree)")
    mesh_config = ComplexParam("mesh_config", "MeshConfig for sharded inference "
                               "(each batch's rows split over the data-parallel "
                               "processes, the scores gathered on every process)",
                               default=None)
    arch_config = ComplexParam("arch_config", "TransformerConfig (None = "
                               "resolve checkpoint preset)", default=None)
    tokenizer_config = ComplexParam("tokenizer_config", "tokenizer config dict")
    train_metrics = ComplexParam("train_metrics", "loss/throughput trace", default=None)
    attn_impl = Param("attn_impl", "serve-time attention backend override: "
                      "einsum | flash (None = the trained arch's choice); "
                      "pure kernel selection — the parameters are unchanged",
                      default=None,
                      validator=lambda v: v in (None, "einsum", "flash"))
    _APPLY_KEYS = frozenset({"model_params", "arch_config", "tokenizer_config",
                             "checkpoint", "num_classes", "mesh_config", "attn_impl",
                             "device"})
    # the registry's publish-time backend search (registry/autotune.py)
    _AUTOTUNE_PARAMS = {"attn_impl": ("einsum", "flash")}
    # einsum is the flash kernel's plain version: on the card it is the
    # search's baseline, never its winner
    _AUTOTUNE_PLAIN = {"attn_impl": "einsum"}
    _TRANSIENT = ("_module", "_tok", "_device", "_mesh")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._module = None

    def _post_load(self):
        self._module = None
        cb.invalidate_token(self)

    def set(self, **kw):
        out = super().set(**kw)
        if self._APPLY_KEYS & kw.keys():
            self._module = None  # the built module captured the old values
            cb.invalidate_token(self)
        return out

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
            device = resolve_device("DeepTextModel", self.get("device"))
            with torch.device("meta"):
                module = BertClassifier(cfg, num_classes=self.get("num_classes"))
            state = {k: host_tensor(v).to(device=device, dtype=cfg.param_dtype)
                     for k, v in params.items()}
            module.load_state_dict(state, assign=True)
            self._tok, self._device = tok, device
            self._mesh = (create_mesh(self.get("mesh_config"))
                          if self.get("mesh_config") is not None else None)
            self._module = module.eval()
        return self._module

    def _score(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Softmax scores of one padded batch, as a host array. Under a mesh
        this process scores its rows and the scores of every process's rows
        are gathered."""
        module = self._get_module()
        mesh = self._mesh
        if mesh is None:
            with torch.inference_mode():
                logits = module(torch.from_numpy(ids).to(self._device),
                                torch.from_numpy(mask).to(self._device))
                return torch.softmax(logits, dim=-1).cpu().numpy()
        from ..parallel.collectives import all_gather_dim

        ids, mask = mesh.shard_batch(ids), mesh.shard_batch(mask)
        with torch.inference_mode(), mesh:
            logits = module(torch.from_numpy(ids).to(self._device),
                            torch.from_numpy(mask).to(self._device))
            probs = all_gather_dim(mesh, torch.softmax(logits, dim=-1), ("data", "fsdp"))
            return probs.cpu().numpy()

    def _score_fn(self, bucket: int, seq_len: int):
        """The scoring callable of one padded batch shape, from the process
        cache (the JAX stage's ``run_for``)."""
        return cb.get_compiled_cache().get(
            "deep_text_model", (bucket, seq_len), lambda: self._score,
            instance=cb.instance_token(self), dtype="int32")

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("text_col"))
        self._get_module()
        bs = self.get("batch_size")
        bucketer = cb.default_bucketer()
        dp = self._mesh.data_parallel_size() if self._mesh is not None else 1

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
                bucket = cb.round_up_to_multiple(bucket, dp)  # rows split evenly
                p = self._score_fn(bucket, ids.shape[1])(cb.pad_rows(ids[s:e], bucket),
                                                         cb.pad_rows(mask[s:e], bucket))
                probs_chunks.append(cb.unpad_rows(p, e - s))
            probs = np.concatenate(probs_chunks, axis=0)
            out = dict(part)
            out[self.get("scores_col")] = probs
            out[self.get("prediction_col")] = np.argmax(probs, axis=-1).astype(np.int32)
            return out

        return df.map_partitions(per_part)
