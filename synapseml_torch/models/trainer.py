"""Single-device trainer: the counterpart of ``synapseml_tpu/models/trainer.py``.

The JAX package jits one train step over a named mesh and scans chunks of
steps on the device. Here one ``nn.Module`` on one device takes a step at a
time: the forward and ``loss.backward()`` with the module in ``eval()``
mode (dropout stays off, as the JAX step applies the module without a
dropout rng), then the optimizer of ``_make_optimizer`` (``:214-230``
there), written as plain functions on tensors so that it computes what
optax computes:

* the learning-rate schedule is evaluated at the optimizer's count BEFORE
  its increment, in float32 (so the first linear warm-up step has lr 0);
* ``clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon;
* AdamW decays every trained leaf (biases and norms included), with eps
  outside the square root and bias correction by the count;
* with ``freeze_predicate`` the clip and AdamW see the trained leaves only
  (``multi_transform``); frozen leaves get no update and no decay;
* ``grad_accum = k`` (``MultiSteps``) keeps a running mean of k
  micro-gradients and applies nothing on the k-1 steps in between; the
  schedule counts optimizer steps.

``TrainState.params`` holds the module's own parameters, updated in place.
``fit`` runs the per-step loop of the JAX package (``:596-680``); a
``scan_chunk`` is accepted and the loop stays per step (the JAX package's
scanned and per-step loops give equal results). Not ported yet, each
refused with ``NotImplementedError`` naming its ``ROADMAP.md`` item:
checkpointing (``checkpointer``, ``checkpoint_every``, ``resume_from``),
gang training (``gang``, ``fit_gang_source``), ``train_steps_scan``, a mesh
and ``partition_rules``/``zero_shard``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch import nn

from ..core import observability as obs
from ..core.instrumentation import chip_peak_tflops

__all__ = ["TrainerConfig", "Trainer", "TrainState", "NonFiniteLossError",
           "cross_entropy_loss", "plan_fit", "fit_source", "fit_arrays",
           "fit_gang_source"]

_MULTI_GPU = "ROADMAP.md queue A item 9 (multi-GPU)"
_CHECKPOINTS = "ROADMAP.md queue A item 9 (parallel/checkpoint.py)"


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to synapseml_torch yet: {item}")


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 0
    total_steps: int = 1000
    grad_clip: float = 1.0
    grad_accum: int = 1
    freeze_predicate: Callable[[tuple[str, ...]], bool] | None = None  # True -> frozen
    lr_schedule: str = "constant"  # constant | cosine | linear
    b1: float = 0.9
    b2: float = 0.999
    # non-finite loss guard: "count" counts non-finite steps into
    # synapseml_train_nonfinite_total; "raise" aborts the fit with
    # NonFiniteLossError naming the poisoned step
    nonfinite_action: str = "count"  # count | raise
    partition_rules: Any | None = None
    zero_shard: bool = False

    def __post_init__(self):
        if self.partition_rules is not None or self.zero_shard:
            raise _unported("partition_rules / zero_shard", _MULTI_GPU)


class NonFiniteLossError(RuntimeError):
    """The fit loop saw a non-finite loss at ``step`` (the optimizer step
    the poisoned batch trained). ``last_finite_step`` is the newest step
    whose loss was still finite."""

    def __init__(self, step: int, last_finite_step: int):
        super().__init__(
            f"non-finite loss at step {step} (last finite step: "
            f"{last_finite_step}) — rewind to a checkpoint at or before "
            f"{last_finite_step} and skip the offending batch window")
        self.step = int(step)
        self.last_finite_step = int(last_finite_step)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood in float32; with ``mask`` (the loader's
    ``_valid``) a masked mean over ``max(sum(mask), 1)`` rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int, count: int) -> np.float32:
    """optax.linear_schedule at ``count``, in float32."""
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1) - c / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


def _make_schedule(cfg: TrainerConfig) -> Callable[[int], np.float32]:
    """The learning rate at optimizer count ``count`` (before its
    increment), as optax's schedules compute it."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        # warmup_cosine_decay_schedule(0, lr, max(warmup, 1), max(total, 2))
        warm = max(cfg.warmup_steps, 1)
        decay = max(cfg.total_steps, 2) - warm
        if decay <= 0:
            raise ValueError("cosine schedule needs total_steps > warmup_steps")

        def cosine(count: int) -> np.float32:
            if count < warm:
                return _linear(0.0, lr, warm, count)
            c = np.float32(min(count - warm, decay))
            cos = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(math.pi) * c
                                                            / np.float32(decay)))
            return np.float32(lr) * cos

        return cosine
    if cfg.lr_schedule == "linear":
        warm, decay = max(cfg.warmup_steps, 1), max(cfg.total_steps - cfg.warmup_steps, 1)

        def linear(count: int) -> np.float32:
            if count < cfg.warmup_steps:
                return _linear(0.0, lr, warm, count)
            return _linear(lr, 0.0, decay, count - cfg.warmup_steps)

        return linear
    return lambda count: np.float32(lr)


def _global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@dataclasses.dataclass
class OptState:
    """AdamW moments of the trained leaves, the optimizer count (which the
    schedule reads before it increments), and the ``MultiSteps``
    accumulators and micro-step (``grad_accum > 1`` only)."""

    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int = 0
    acc: list[torch.Tensor] | None = None
    mini_step: int = 0


class _Optimizer:
    """Global-norm clip then AdamW over the trained leaves, with frozen
    leaves left as they are and ``MultiSteps`` accumulation: the optax chain
    that the JAX package's ``_make_optimizer`` builds."""

    def __init__(self, cfg: TrainerConfig, names: list[str]):
        self.cfg = cfg
        self.names = list(names)
        pred = cfg.freeze_predicate
        self.train_idx = [i for i, n in enumerate(self.names)
                          if pred is None or not pred(tuple(n.split(".")))]
        self.schedule = _make_schedule(cfg)

    def init(self, params: list[torch.Tensor]) -> OptState:
        train = [params[i] for i in self.train_idx]
        zeros = lambda: [torch.zeros_like(p) for p in train]  # noqa: E731
        return OptState(mu=zeros(), nu=zeros(),
                        acc=zeros() if self.cfg.grad_accum > 1 else None)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: OptState,
               params: list[torch.Tensor]) -> None:
        """One optimizer (micro-)step: ``params`` change in place. The
        trained leaves' ``grads`` are overwritten (clipped)."""
        cfg = self.cfg
        g = [grads[i] for i in self.train_idx]
        p = [params[i] for i in self.train_idx]
        if not p:
            return
        k = cfg.grad_accum
        if k > 1:
            # running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(g, state.acc)
            torch._foreach_div_(delta, float(state.mini_step + 1))
            torch._foreach_add_(state.acc, delta)
            state.mini_step += 1
            if state.mini_step < k:
                return
            state.mini_step = 0
            g = state.acc  # the mean; reset to 0 * acc after the update
        # clip_by_global_norm: t if norm < max_norm else (t / norm) * max_norm
        norm = _global_norm(g)
        clip = ~(norm < cfg.grad_clip)
        torch._foreach_div_(g, torch.where(clip, norm, torch.ones_like(norm)))
        torch._foreach_mul_(g, torch.where(clip, torch.full_like(norm, cfg.grad_clip),
                                           torch.ones_like(norm)))
        # scale_by_adam: moments, then bias correction by the new count
        b1, b2 = cfg.b1, cfg.b2
        lr = self.schedule(state.count)
        state.count += 1
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(g, 1 - b1))
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, sq)
        bc1 = float(np.float32(1) - np.float32(b1) ** state.count)
        bc2 = float(np.float32(1) - np.float32(b2) ** state.count)
        upd = torch._foreach_div(state.mu, bc1)
        den = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, 1e-8)
        torch._foreach_div_(upd, den)
        # add_decayed_weights, then scale by -lr, then apply
        torch._foreach_add_(upd, torch._foreach_mul(p, cfg.weight_decay))
        torch._foreach_mul_(upd, -float(lr))
        torch._foreach_add_(p, upd)
        if k > 1:
            torch._foreach_mul_(state.acc, 0.0)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # the module's parameters, by state_dict name
    opt_state: OptState
    step: int = 0


_GUARD_METRICS = obs.HandleCache(lambda reg: {
    "nonfinite": reg.counter("synapseml_train_nonfinite_total",
                             "optimizer steps whose loss was NaN/Inf", ("engine",)),
    "last_finite": reg.gauge("synapseml_train_last_finite_step",
                             "newest optimizer step with a finite loss"),
})


def _resolve_device(owner: str, spec) -> torch.device:
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{owner}: device={str(spec)!r} but this host has no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return device


class Trainer:
    """Owns the module on its device, the optimizer and the step loop.

    ``loss_fn(module, batch) -> loss`` replaces the default masked cross
    entropy of the module's logits against ``labels``. ``device`` defaults
    to the card and raises on a host without one."""

    def __init__(self, module: nn.Module, cfg: TrainerConfig,
                 loss_fn: Callable[[nn.Module, dict], torch.Tensor] | None = None,
                 *, device: str | torch.device = "cuda", mesh=None):
        if mesh is not None:
            raise _unported("a mesh", _MULTI_GPU)
        self.device = _resolve_device("Trainer", device)
        self.module = module.eval()  # dropout stays off, as in the JAX step
        self.cfg = cfg
        self._loss_fn = loss_fn
        self._tx = _Optimizer(cfg, [n for n, _ in module.named_parameters()])
        self._metrics: list[dict] = []
        # newest optimizer step whose loss was finite (post-step numbering);
        # -1 until the first loss is seen
        self.last_finite_step: int = -1

    def init_state(self, seed: int = 0, init_params: dict | None = None) -> TrainState:
        """Fresh state. ``init_params`` (a ``state_dict`` of host arrays)
        replaces the module's values, every parameter by name and shape;
        without it the module's own initialisers run under ``seed``."""
        module = self.module.to("cpu")
        named = dict(module.named_parameters())
        with torch.no_grad():
            if init_params is not None:
                missing = sorted(set(named) - set(init_params))
                extra = sorted(set(init_params) - set(named))
                if missing or extra:
                    raise ValueError(f"init_params do not match the module: missing "
                                     f"{missing[:8]}, unused {extra[:8]}")
                for name, p in named.items():
                    v = torch.tensor(np.asarray(init_params[name]))
                    if tuple(v.shape) != tuple(p.shape):
                        raise ValueError(f"shape mismatch for {name!r}: given "
                                         f"{tuple(v.shape)}, module {tuple(p.shape)}")
                    p.copy_(v.to(p.dtype))
            else:
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(seed)
                    for m in module.modules():
                        if hasattr(m, "reset_parameters"):
                            m.reset_parameters()
        self.module = module.to(self.device)
        params = dict(self.module.named_parameters())
        return TrainState(params=params, opt_state=self._tx.init(list(params.values())))

    def _model_inputs(self, batch: dict) -> dict:
        drop = {"labels", "label", "mask", "_valid"}
        return {k: v for k, v in batch.items() if k not in drop}

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def default_loss(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(masked cross entropy, logits) of one device batch."""
        logits = self.module(**self._model_inputs(batch))
        labels = batch.get("labels", batch.get("label"))
        return cross_entropy_loss(logits, labels, batch.get("_valid")), logits

    def train_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """One step on a host batch: forward, backward, optimizer. ``state``
        is updated in place and returned; ``metrics`` holds the loss and
        the global norm of the raw gradients as 0-d device tensors."""
        batch = self._to_device(batch)
        params = list(state.params.values())
        for p in params:
            p.grad = None
        if self._loss_fn is not None:
            loss = self._loss_fn(self.module, batch)
        else:
            loss, _ = self.default_loss(batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        with torch.no_grad():
            grad_norm = _global_norm(grads)
        self._tx.update(grads, state.opt_state, params)
        state.step += 1
        return state, {"loss": loss.detach().float(), "grad_norm": grad_norm.float()}

    def train_steps_scan(self, state, stacked_batches):
        raise _unported("train_steps_scan (K steps in one dispatch)",
                        "ROADMAP.md queue A item 1d (the scanned / CUDA-graph step)")

    # ---- non-finite loss guard ----
    def _observe_losses(self, losses, last_step: int) -> None:
        """Check per-step losses ending at post-step number ``last_step``:
        advance ``last_finite_step``, count non-finite steps into
        ``synapseml_train_nonfinite_total``, and under
        ``nonfinite_action='raise'`` raise :class:`NonFiniteLossError` naming
        the first poisoned step."""
        arr = np.asarray(losses, dtype=np.float64).reshape(-1)
        if arr.size == 0:
            return
        finite = np.isfinite(arr)
        m = _GUARD_METRICS.get()
        if bool(finite.all()):
            self.last_finite_step = max(self.last_finite_step, int(last_step))
        else:
            first_bad = int(np.argmax(~finite))
            bad_step = last_step - arr.size + 1 + first_bad
            if first_bad > 0:
                self.last_finite_step = max(self.last_finite_step, int(bad_step - 1))
            m["nonfinite"].inc(int((~finite).sum()), engine="trainer")
            if self.cfg.nonfinite_action == "raise":
                m["last_finite"].set(self.last_finite_step)
                raise NonFiniteLossError(bad_step, self.last_finite_step)
        m["last_finite"].set(self.last_finite_step)

    @staticmethod
    def _count_skipped() -> None:
        obs.get_registry().counter(
            "synapseml_train_skipped_steps_total",
            "batches consumed but not trained (NaN-rewind skip windows)",
            ("engine",)).inc(engine="trainer")

    # ---- loop ----
    def fit(self, state: TrainState, batch_iter: Iterator[dict], max_steps: int,
            log_every: int = 50, callback: Callable[[int, dict], None] | None = None,
            scan_chunk: int = 8, checkpointer=None, checkpoint_every: int = 0,
            skip_fn: Callable[[int], bool] | None = None, gang=None) -> TrainState:
        """Up to ``max_steps`` steps over any iterator of host batches.

        ``callback(i, metrics)`` runs after each trained step.
        ``skip_fn(batch_index)`` (the pre-step counter) marks batches to
        consume but not train: ``state.step`` advances, the params stay.
        Each step's loss stays on the device until a log window (every
        ``log_every`` steps and the last step), where the window's losses
        are read at once, checked by the non-finite guard and the window
        appended to :attr:`metrics`; ``nonfinite_action='raise'`` reads
        every loss at its step."""
        if checkpointer is not None or checkpoint_every:
            raise _unported("checkpointer / checkpoint_every", _CHECKPOINTS)
        if gang is not None:
            raise _unported("gang training", _MULTI_GPU)
        it = iter(batch_iter)
        meter = _ThroughputMeter(self, state.params)
        base = state.step
        eager_guard = self.cfg.nonfinite_action == "raise"
        pending: list[torch.Tensor] = []  # losses not yet read, ending at state.step
        logged_at = steps_done = 0

        def flush() -> float | None:
            if not pending:
                return None
            losses = torch.stack(pending).cpu().numpy()
            pending.clear()
            self._observe_losses(losses, last_step=state.step)
            return float(losses[-1])

        for i in range(max_steps):
            try:
                batch = next(it)  # never pull past max_steps batches
            except StopIteration:
                break
            steps_done = i + 1
            if skip_fn is not None and skip_fn(base + i):
                flush()
                state.step += 1
                self._count_skipped()
                continue
            state, metrics = self.train_step(state, batch)
            meter.observe(batch)
            pending.append(metrics["loss"])
            if eager_guard:
                flush()
            if callback is not None:
                callback(i, metrics)
            if steps_done - logged_at >= log_every or steps_done >= max_steps:
                flush()
                self._metrics.append(meter.entry(float(metrics["loss"])))
                logged_at = steps_done
        flush()
        return state

    @property
    def metrics(self) -> list[dict]:
        return self._metrics


class _ThroughputMeter:
    """samples/s, 6ND model TFLOP/s and MFU against the card's dense bf16
    peak (``core.instrumentation.chip_peak_tflops``), on the host clock.
    Tokens come from ``input_ids`` only."""

    def __init__(self, trainer: Trainer, params: dict):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.n_samples = 0
        self.n_tokens = 0
        self.flops_per_token = 6 * sum(p.numel() for p in params.values())
        dev = trainer.device
        self.peak = (chip_peak_tflops(torch.cuda.get_device_name(dev))
                     if dev.type == "cuda" else None)
        self._last_t = self.t0
        self._last_steps = 0

    def observe(self, batch: dict) -> None:
        self.steps += 1
        self.n_samples += int(np.shape(next(iter(batch.values())))[0])
        ids = batch.get("input_ids")
        if ids is not None:
            self.n_tokens += int(np.prod(np.shape(ids)))

    def entry(self, loss: float) -> dict:
        dt = time.perf_counter() - self.t0
        out = {"step": self.steps, "loss": loss, "samples_per_sec": self.n_samples / dt}
        if self.n_tokens:
            out["model_tflops_per_sec"] = self.flops_per_token * self.n_tokens / dt / 1e12
            if self.peak:
                out["mfu"] = round(out["model_tflops_per_sec"] / self.peak, 4)
        self._export(out)
        return out

    def _export(self, out: dict) -> None:
        """Each window onto the metrics registry: the window's mean step time
        into the step histogram, throughput and MFU as gauges."""
        now = time.perf_counter()
        dsteps = self.steps - self._last_steps
        reg = obs.get_registry()
        if dsteps > 0:
            reg.histogram("synapseml_train_step_duration_ms",
                          "training step (boosting iteration / optimizer step) wall time",
                          ("engine",)).observe((now - self._last_t) * 1e3 / dsteps,
                                               engine="trainer")
        self._last_t, self._last_steps = now, self.steps
        reg.gauge("synapseml_train_samples_per_sec", "fit-loop throughput",
                  ("engine",)).set(out["samples_per_sec"], engine="trainer")
        if "mfu" in out:
            reg.gauge("synapseml_train_mfu", "model FLOPs utilization vs chip_peak_tflops",
                      ("engine",)).set(out["mfu"], engine="trainer")


def plan_fit(n: int, batch_size: int, epochs: int, max_steps: int) -> tuple[int, int]:
    """(effective batch size, total optimizer steps) for an n-row fit.
    Raises on empty input."""
    if n == 0:
        raise ValueError("cannot fit on an empty DataFrame (0 rows)")
    bs = min(batch_size, n)
    steps_per_epoch = max(n // bs, 1)
    total = max_steps if max_steps > 0 else steps_per_epoch * epochs
    return bs, total


def fit_source(trainer: Trainer, source, *, batch_size: int, total_steps: int,
               seed: int, init_params=None, scan_chunk: int = 8,
               checkpointer=None, checkpoint_every: int = 0,
               state: TrainState | None = None, data_state: dict | str | None = None,
               epochs: int | None = None, drop_remainder: bool = True,
               shuffle_rows: str = "full", shuffle_window: int = 4096,
               prefetch: int = 2, columns: list | None = None,
               host_index: int = 0, host_count: int = 1,
               resume_from: str | None = None,
               skip_fn: Callable[[int], bool] | None = None,
               callback: Callable[[int, dict], None] | None = None) -> TrainState:
    """Streaming fit over a :class:`synapseml_torch.data.ShardedSource`.

    The data plane supplies seeded shard and row shuffles, bucket-ladder
    batch shapes and a bounded background prefetcher; this function
    initialises the state (``trainer.init_state(seed, init_params)``) unless
    ``state`` is given, and runs ``trainer.fit``.

    ``total_steps`` is the total optimizer-step target: from a ``state`` at
    step N, ``total_steps - N`` more steps run, and ``data_state`` (an
    ``IteratorState.to_tree()``, or ``'fresh'`` to restart the stream on
    purpose) says where the stream stands, so the batch stream continues
    as an uninterrupted run's would."""
    from ..data import DataLoader, IteratorState

    if checkpointer is not None or checkpoint_every or resume_from is not None:
        raise _unported("checkpointer / checkpoint_every / resume_from", _CHECKPOINTS)
    done = state.step if state is not None else 0
    remaining = total_steps - done
    if state is not None and remaining <= 0:
        return state
    if state is not None and done > 0 and data_state is None:
        raise ValueError(
            f"resuming from step {done} without data_state= — the loader "
            "would silently restart the stream from epoch 0. Pass the "
            "loader's IteratorState tree for a bit-identical continuation, "
            "or data_state='fresh' to deliberately restart the stream")
    if isinstance(data_state, str):
        if data_state != "fresh":
            raise ValueError(f"data_state must be an IteratorState tree or 'fresh', "
                             f"got {data_state!r}")
        # a fresh stream whose batch counter stays aligned with state.step
        data_state = IteratorState(seed=int(seed), batches_emitted=done).to_tree()
    loader = DataLoader(
        source, batch_size, seed=seed, epochs=epochs,
        drop_remainder=drop_remainder, shuffle_rows=shuffle_rows,
        shuffle_window=shuffle_window, prefetch=prefetch, columns=columns,
        host_index=host_index, host_count=host_count,
        state=IteratorState.from_tree(data_state) if data_state is not None else None)
    try:
        if state is None:
            state = trainer.init_state(seed=seed, init_params=init_params)
        return trainer.fit(state, iter(loader), max_steps=remaining,
                           scan_chunk=scan_chunk, skip_fn=skip_fn, callback=callback)
    finally:
        loader.close()


def fit_gang_source(*args, **kwargs):
    raise _unported("fit_gang_source (elastic gang training)", _MULTI_GPU)


def fit_arrays(trainer: Trainer, data: dict, *, batch_size: int, total_steps: int,
               seed: int, init_params=None, scan_chunk: int = 8, checkpointer=None,
               checkpoint_every: int = 0, shard_rows: int | None = None) -> TrainState:
    """Fit over host arrays: they go behind a
    :class:`synapseml_torch.data.MemorySource` into :func:`fit_source`.
    ``shard_rows`` sets the shard layout (None = one shard)."""
    from ..data.source import MemorySource

    n = next(iter(data.values())).shape[0]
    return fit_source(trainer, MemorySource(data, shard_rows=shard_rows),
                      batch_size=batch_size, total_steps=total_steps, seed=seed,
                      init_params=init_params, scan_chunk=scan_chunk,
                      checkpointer=checkpointer, checkpoint_every=checkpoint_every,
                      drop_remainder=n >= batch_size)
