"""DeepVisionClassifier / DeepVisionModel — vision fine-tuning and scoring on the card.

Counterpart of ``synapseml_tpu/models/vision.py`` (``:28-238``), with the
same Param names, defaults and validators, plus ``device`` (default
``"cuda"``; a host without a CUDA device must ask for ``"cpu"``).

``DeepVisionClassifier`` fits a ViT (``vit_b16``, ``vit_tiny``) or a ResNet
(``resnet50``, ``resnet18``, ``resnet_tiny``, the default) on an image
column of ``[H, W, C]`` float arrays with :func:`..trainer.fit_arrays`
(AdamW, linear warm-up over a tenth of the steps, then cosine decay) at its
default ``scan_chunk`` of 8: on the card, chunks of 8 steps run as captured
CUDA graphs. A ResNet trains with BatchNorm state (``has_batch_stats``):
its running statistics update in the step and go to the model beside the
weights. The initial weights come from ``_init_variables``: the JAX
modules' initialisers drawn with numpy from ``seed``
(:mod:`..convert_jax`), the same distribution, not the same bits, as
``jax.random.PRNGKey(seed)``.

``DeepVisionModel`` keeps the JAX stage's per-partition loop (stack,
``ShapeBucketer.slices``, ``pad_rows``, forward with the running
statistics, softmax, ``unpad_rows``). Each (bucket, image shape) takes its
callable from the process-wide ``CompiledCache`` under ``"deep_vision_model"``,
keyed by the stage's ``instance_token``; the callables run eagerly under
``torch.inference_mode()`` on a module built once per stage. ``model_params``
is this package's ``state_dict`` of parameters as numpy arrays, and
``batch_stats`` the BatchNorm buffers (``None`` for a ViT).

Not ported yet, each refused with ``NotImplementedError`` naming its
``ROADMAP.md`` item: a local checkpoint directory as ``backbone`` (and the
``arch_spec`` it yields), ``checkpoint_dir`` and ``mesh_config``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import DataFrame, Estimator, Model
from ..core import batching as cb
from ..core.device import device_type, resolve_device
from ..core.params import ComplexParam, Param, TypeConverters
from .convert_jax import (init_flax_resnet_params, init_flax_vit_params,
                          resnet_state_dict_from_flax, vit_state_dict_from_flax)
from .nets.resnet import ResNet, resnet18, resnet50, resnet_tiny
from .nets.vit import ViTClassifier, vit_b16, vit_tiny
from .trainer import Trainer, TrainerConfig, fit_arrays, plan_fit

__all__ = ["DeepVisionClassifier", "DeepVisionModel"]

# backbone -> builder(num_classes) of (module, has_batch_stats)
_BACKBONES = {
    "vit_b16": lambda n: (ViTClassifier(vit_b16(), num_classes=n, patch=16), False),
    "vit_tiny": lambda n: (ViTClassifier(vit_tiny(), num_classes=n, patch=8), False),
    "resnet50": lambda n: (resnet50(num_classes=n), True),
    "resnet18": lambda n: (resnet18(num_classes=n), True),
    "resnet_tiny": lambda n: (resnet_tiny(num_classes=n), True),
}


def _unported(stage: str, what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{stage}: {what} is not ported to synapseml_torch yet: "
                               f"ROADMAP.md queue A item {item}")


def _build_module(backbone: str, num_classes: int, arch_spec=None):
    """(module on the CPU with uninitialised tensors, has_batch_stats) for a
    preset ``backbone``."""
    if arch_spec is not None or (isinstance(backbone, (str, os.PathLike))
                                 and os.path.isdir(str(backbone))):
        raise _unported("DeepVision", "a local checkpoint directory as backbone",
                        "4 (convert_hf.pretrained_vision)")
    try:
        build = _BACKBONES[backbone]
    except KeyError:
        raise ValueError(f"unknown backbone {backbone!r}; have "
                         "vit_b16|vit_tiny|resnet50|resnet18|resnet_tiny "
                         "or a local HF checkpoint directory") from None
    with torch.device("meta"):
        module, has_bn = build(num_classes)
    return module.to_empty(device="cpu"), has_bn


def _init_variables(module: torch.nn.Module, seed: int) -> tuple[dict, dict | None]:
    """(``state_dict`` of parameters, BatchNorm buffers or None): the JAX
    module's initialisers for ``module``'s architecture, drawn with numpy
    from ``seed``."""
    if isinstance(module, ViTClassifier):
        tree = init_flax_vit_params(module.cfg, module.head.out_features, module.patch,
                                    module.patch_embed.in_channels, seed)
        return vit_state_dict_from_flax(tree), None
    if isinstance(module, ResNet):
        variables = init_flax_resnet_params(
            tuple(module.stage_sizes), module.block, module.head.out_features, module.width,
            module.stem.in_channels, seed)
        return (resnet_state_dict_from_flax(variables["params"]),
                resnet_state_dict_from_flax(batch_stats=variables["batch_stats"]))
    raise TypeError(f"no initialiser for {type(module).__name__}")


class _VisionParams:
    image_col = Param("image_col", "input image column ([H,W,C] float arrays)",
                      default="image")
    label_col = Param("label_col", "label column", default="label")
    prediction_col = Param("prediction_col", "argmax output column", default="prediction")
    scores_col = Param("scores_col", "softmax scores column", default="scores")
    backbone = Param("backbone", "vit_b16|vit_tiny|resnet50|resnet18|resnet_tiny",
                     default="resnet_tiny")
    num_classes = Param("num_classes", "number of classes", default=2,
                        converter=TypeConverters.to_int)
    batch_size = Param("batch_size", "global batch size", default=32,
                       converter=TypeConverters.to_int)
    device = Param("device", "torch device: 'cuda' (default), 'cuda:N' or 'cpu'",
                   default="cuda", converter=TypeConverters.to_string,
                   validator=lambda v: device_type(v) in ("cuda", "cpu"))


class DeepVisionClassifier(Estimator, _VisionParams):
    feature_name = "deep_learning"

    learning_rate = Param("learning_rate", "peak lr", default=1e-3,
                          converter=TypeConverters.to_float)
    num_train_epochs = Param("num_train_epochs", "epochs", default=2,
                             converter=TypeConverters.to_int)
    max_steps = Param("max_steps", "hard step cap (-1 = epochs)", default=-1,
                      converter=TypeConverters.to_int)
    seed = Param("seed", "init seed", default=0, converter=TypeConverters.to_int)
    checkpoint_dir = Param("checkpoint_dir", "directory for training checkpoints "
                           "(not ported yet: must stay None)", default=None)
    checkpoint_every = Param("checkpoint_every", "checkpoint every N optimizer "
                             "steps (0 = only the final state)", default=0,
                             converter=TypeConverters.to_int)
    checkpoint_keep = Param("checkpoint_keep", "retain the most recent K "
                            "checkpoints", default=3,
                            converter=TypeConverters.to_int)
    mesh_config = ComplexParam("mesh_config", "MeshConfig override (not ported yet: "
                               "must stay None)", default=None)

    def _refuse_unported(self) -> None:
        if self.get("checkpoint_dir"):
            raise _unported("DeepVisionClassifier", "checkpoint_dir",
                            "1.3 (parallel/checkpoint.py)")
        if self.get("mesh_config") is not None:
            raise _unported("DeepVisionClassifier", "mesh_config", "9 (multi-GPU)")

    def _fit_plan(self, df: DataFrame):
        """What the fit runs: ``(trainer, data, fit_arrays keywords)`` for
        ``df``, the trainer on the stage's device with its module and
        ``TrainerConfig``, the keywords those of the reference stage's
        ``fit_arrays`` call (its default ``scan_chunk``)."""
        self._refuse_unported()
        device = resolve_device("DeepVisionClassifier", self.get("device"))
        module, has_bn = _build_module(self.get("backbone"), self.get("num_classes"))
        labels = df.collect_column(self.get("label_col")).astype(np.int32)
        bs, total = plan_fit(len(labels), self.get("batch_size"),
                             self.get("num_train_epochs"), self.get("max_steps"))
        images = np.stack(list(df.collect_column(self.get("image_col")))).astype(np.float32)
        trainer = Trainer(module, TrainerConfig(learning_rate=self.get("learning_rate"),
                                                total_steps=total, lr_schedule="cosine",
                                                warmup_steps=max(total // 10, 1)),
                          device=device, has_batch_stats=has_bn)
        params, stats = _init_variables(module, self.get("seed"))
        kw = dict(batch_size=bs, total_steps=total, seed=self.get("seed"),
                  init_params=params, init_batch_stats=stats)
        return trainer, {"x": images, "labels": labels}, kw

    def _fit(self, df: DataFrame) -> "DeepVisionModel":
        trainer, data, kw = self._fit_plan(df)
        state = fit_arrays(trainer, data, **kw)
        trainer.release_graphs()  # the captured steps' memory pools
        host = lambda tensors: {k: v.detach().cpu().numpy()  # noqa: E731
                                for k, v in tensors.items()}
        return DeepVisionModel(
            model_params=host(state.params),
            batch_stats=host(state.batch_stats) if state.batch_stats is not None else None,
            backbone=self.get("backbone"), num_classes=self.get("num_classes"),
            image_col=self.get("image_col"), prediction_col=self.get("prediction_col"),
            scores_col=self.get("scores_col"), batch_size=self.get("batch_size"),
            device=self.get("device"), train_metrics=trainer.metrics,
        )


class DeepVisionModel(Model, _VisionParams):
    feature_name = "deep_learning"

    model_params = ComplexParam("model_params", "trained parameters: this package's "
                                "state_dict as numpy arrays")
    batch_stats = ComplexParam("batch_stats", "BN running stats: the module's "
                               "BatchNorm buffers as numpy arrays", default=None)
    arch_spec = ComplexParam("arch_spec", "(kind, info) for pretrained-dir fits "
                             "(not ported yet: must stay None)", default=None)
    mesh_config = ComplexParam("mesh_config", "MeshConfig for sharded inference "
                               "(not ported yet: must stay None)", default=None)
    train_metrics = ComplexParam("train_metrics", "loss/throughput trace", default=None)

    _APPLY_KEYS = frozenset({"model_params", "batch_stats", "arch_spec", "backbone",
                             "num_classes", "mesh_config", "device"})

    def __init__(self, **kw):
        super().__init__(**kw)
        self._module = None

    def _post_load(self):
        self._module = None
        cb.invalidate_token(self)

    def set(self, **kw):
        out = super().set(**kw)
        if self._APPLY_KEYS & kw.keys():
            self._module = None  # the built module and the cached callables
            cb.invalidate_token(self)  # captured the old values
        return out

    def _get_module(self) -> torch.nn.Module:
        """The module on its device with the fitted weights and running
        statistics, built once per stage."""
        if self.__dict__.get("_module") is None:
            if self.get("mesh_config") is not None:
                raise _unported("DeepVisionModel", "mesh_config", "9 (multi-GPU)")
            device = resolve_device("DeepVisionModel", self.get("device"))
            module, _ = _build_module(self.get("backbone"), self.get("num_classes"),
                                      self.get("arch_spec"))
            state = dict(self.get("model_params"))
            if self.get("batch_stats") is not None:
                state.update(self.get("batch_stats"))
            module.load_state_dict({k: torch.as_tensor(np.asarray(v)).to(device)
                                    for k, v in state.items()}, assign=True)
            self._device = device
            self._module = module.to(device).eval()
        return self._module

    def _run_for(self, bucket: int, img_shape: tuple):
        """The callable of one (bucket, image shape): host images -> softmax
        scores as a host array."""
        def build():
            module, device = self._get_module(), self._device

            def run(x: np.ndarray) -> np.ndarray:
                with torch.inference_mode():
                    logits = module(x=torch.from_numpy(x).to(device))
                    return torch.softmax(logits, dim=-1).cpu().numpy()

            return run

        return cb.get_compiled_cache().get(
            "deep_vision_model", (bucket,) + tuple(img_shape), build,
            instance=cb.instance_token(self), dtype="float32")

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("image_col"))
        self._get_module()
        bs = self.get("batch_size")
        bucketer = cb.default_bucketer()

        def per_part(part):
            imgs = part[self.get("image_col")]
            if len(imgs) == 0:
                # keep the output schema rectangular across partitions
                out = dict(part)
                out[self.get("scores_col")] = np.zeros((0, self.get("num_classes")), np.float32)
                out[self.get("prediction_col")] = np.zeros(0, np.int32)
                return out
            x = np.stack(list(imgs)).astype(np.float32)
            chunks = []
            for s, e, bucket in bucketer.slices(len(x), bs):
                p = self._run_for(bucket, x.shape[1:])(cb.pad_rows(x[s:e], bucket))
                chunks.append(cb.unpad_rows(p, e - s))
            probs = np.concatenate(chunks, axis=0)
            out = dict(part)
            out[self.get("scores_col")] = probs
            out[self.get("prediction_col")] = np.argmax(probs, axis=-1).astype(np.int32)
            return out

        return df.map_partitions(per_part)
