"""Single-device trainer: the counterpart of ``synapseml_tpu/models/trainer.py``.

The JAX package jits one train step over a named mesh and scans chunks of
steps on the device. Here one ``nn.Module`` on one device takes each step
as the forward and ``loss.backward()`` with the module in ``eval()`` mode
(dropout stays off, as the JAX step applies the module without a dropout
rng), then the optimizer of ``_make_optimizer`` (``:214-230`` there),
written as plain functions on tensors so that it computes what optax
computes:

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

The per-step scalars (learning rate, bias corrections, the running mean's
divisor) are computed on the host from the counters and reach the
optimizer as device tensors, so that :meth:`Trainer.train_steps_scan`
(the JAX ``lax.scan`` of K steps, ``:487-502`` there) runs K whole steps as
one captured CUDA graph per (batch shape, K, accumulation phase), replayed
with no host dispatch; on the CPU it runs them eagerly through the same
step body. ``fit`` dispatches as the JAX package's does (``:551-675``):
chunks of ``scan_chunk`` same-shape batches, stacked by a producer thread,
go through ``train_steps_scan``; a callback, a ``skip_fn`` or
``scan_chunk <= 1`` run the per-step loop.

``TrainState.params`` holds the module's own parameters, updated in place.
With ``has_batch_stats`` (the JAX package's, for BatchNorm nets) the step
calls the module with ``train=True``, whose BatchNorm layers normalise with
the batch's statistics and update their running statistics in place, and
``TrainState.batch_stats`` holds those buffers by ``state_dict`` name: a
captured chunk updates them on every replay, and nothing is read back to
the host. Not ported yet, each refused with ``NotImplementedError`` naming its
``ROADMAP.md`` item: checkpointing (``checkpointer``, ``checkpoint_every``,
``resume_from``), gang training (``gang``, ``fit_gang_source``), a mesh
and ``partition_rules``/``zero_shard``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch import nn

from ..core import batching as cb
from ..core import observability as obs
from ..core.device import resolve_device
from ..core.instrumentation import chip_peak_tflops
from ..ops import attention as att

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
    that the JAX package's ``_make_optimizer`` builds.

    The per-step scalars (``-lr``, the bias corrections and the running
    mean's divisor) are computed on the host from the counters
    (:meth:`plan`) and reach :meth:`apply` as 0-d tensors on the params'
    device, read by the tensor-scalar overloads of ``torch._foreach_*``: a
    captured CUDA graph then reads each replay's values from its table
    instead of freezing the captured step's."""

    # columns of the per-step scalar table
    NEG_LR, BC1, BC2, DIV = range(4)

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

    def plan(self, state: OptState, n: int) -> tuple[np.ndarray, list[int]]:
        """The next ``n`` micro-steps from ``state``'s counters, which it
        advances: a float32 ``[n, 4]`` table of (``-lr``, ``1 - b1^count``,
        ``1 - b2^count``, the running mean's divisor) and each step's index
        within its accumulation window (``grad_accum - 1`` applies the
        update; always 0 without accumulation). The schedule reads the
        count before its increment, the bias corrections after it."""
        cfg, k = self.cfg, self.cfg.grad_accum
        table = np.zeros((n, 4), np.float32)
        micro = []
        for i in range(n):
            table[i, self.DIV] = state.mini_step + 1
            micro.append(state.mini_step)
            if k > 1 and state.mini_step + 1 < k:
                state.mini_step += 1
                continue
            state.mini_step = 0
            table[i, self.NEG_LR] = -self.schedule(state.count)
            state.count += 1
            table[i, self.BC1] = np.float32(1) - np.float32(cfg.b1) ** state.count
            table[i, self.BC2] = np.float32(1) - np.float32(cfg.b2) ** state.count
        return table, micro

    @torch.no_grad()
    def apply(self, grads: list[torch.Tensor], state: OptState, params: list[torch.Tensor],
              scalars: torch.Tensor, micro: int) -> None:
        """One optimizer (micro-)step with ``scalars``, a row of
        :meth:`plan`'s table on the params' device, at accumulation index
        ``micro``: ``params`` change in place; the trained leaves' ``grads``
        are overwritten (clipped). Reads nothing back to the host."""
        cfg = self.cfg
        g = [grads[i] for i in self.train_idx]
        p = [params[i] for i in self.train_idx]
        if not p:
            return
        k = cfg.grad_accum
        if k > 1:
            # running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(g, state.acc)
            torch._foreach_div_(delta, scalars[self.DIV])
            torch._foreach_add_(state.acc, delta)
            if micro < k - 1:
                return
            g = state.acc  # the mean; reset to 0 * acc after the update
        # clip_by_global_norm: t if norm < max_norm else (t / norm) * max_norm
        norm = _global_norm(g)
        clip = ~(norm < cfg.grad_clip)
        torch._foreach_div_(g, torch.where(clip, norm, torch.ones_like(norm)))
        torch._foreach_mul_(g, torch.where(clip, torch.full_like(norm, cfg.grad_clip),
                                           torch.ones_like(norm)))
        # scale_by_adam: moments, then bias correction by the new count
        b1, b2 = cfg.b1, cfg.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(g, 1 - b1))
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, sq)
        upd = torch._foreach_div(state.mu, scalars[self.BC1])
        den = torch._foreach_div(state.nu, scalars[self.BC2])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, 1e-8)
        torch._foreach_div_(upd, den)
        # add_decayed_weights, then scale by -lr, then apply
        torch._foreach_add_(upd, torch._foreach_mul(p, cfg.weight_decay))
        torch._foreach_mul_(upd, scalars[self.NEG_LR])
        torch._foreach_add_(p, upd)
        if k > 1:
            torch._foreach_mul_(state.acc, 0.0)

    def update(self, grads: list[torch.Tensor], state: OptState,
               params: list[torch.Tensor]) -> None:
        """One optimizer (micro-)step from the counters: :meth:`plan` one
        step, then :meth:`apply` it."""
        table, micro = self.plan(state, 1)
        device = params[0].device if params else torch.device("cpu")
        self.apply(grads, state, params, _scalars_on(table, device)[0], micro[0])


def _init_buffers(module: nn.Module, values: dict | None) -> None:
    """A BatchNorm net's running statistics at their initial values, or at
    ``values`` (host arrays by buffer name, every buffer given)."""
    for m in module.modules():
        if hasattr(m, "reset_running_stats"):
            m.reset_running_stats()
    if values is None:
        return
    named = dict(module.named_buffers())
    if set(values) != set(named):
        raise ValueError(f"init_batch_stats do not match the module's buffers: missing "
                         f"{sorted(set(named) - set(values))[:8]}, unused "
                         f"{sorted(set(values) - set(named))[:8]}")
    for name, buf in named.items():
        v = torch.tensor(np.asarray(values[name]))
        if tuple(v.shape) != tuple(buf.shape):
            raise ValueError(f"shape mismatch for {name!r}: given {tuple(v.shape)}, module "
                             f"{tuple(buf.shape)}")
        buf.copy_(v.to(buf.dtype))


def _scalars_on(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host scalar table on ``device``: on a CUDA device through pinned
    memory with a copy that does not wait for the host."""
    t = torch.from_numpy(table)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # the module's parameters, by state_dict name
    opt_state: OptState
    step: int = 0
    # with has_batch_stats: the module's BatchNorm buffers, by state_dict name
    batch_stats: dict[str, torch.Tensor] | None = None


_GUARD_METRICS = obs.HandleCache(lambda reg: {
    "nonfinite": reg.counter("synapseml_train_nonfinite_total",
                             "optimizer steps whose loss was NaN/Inf", ("engine",)),
    "last_finite": reg.gauge("synapseml_train_last_finite_step",
                             "newest optimizer step with a finite loss"),
})


def _shape_key(batch: dict) -> tuple:
    """A batch's (key, shape, dtype) triples, sorted: the JAX package's
    ``shape_key`` of ``_fit_chunked``."""
    return tuple(sorted((k, np.shape(v), str(getattr(v, "dtype", None) or np.asarray(v).dtype))
                        for k, v in batch.items()))


_SIDE_STREAMS: dict = {}  # device -> the stream of warm-ups and captures
_SIDE_LOCK = threading.Lock()


def _release_graphs(token: str) -> int:
    """Evict the graphs keyed to a trainer's ``token``, after the card has
    finished any replay of them still in flight."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return cb.get_compiled_cache().evict_instance(token)


def _binding(trainer: "Trainer", state: "TrainState") -> tuple[int, ...]:
    """The addresses a captured chunk reads and writes outside its pool: the
    module's parameters and buffers, the state's parameters, and its
    optimizer moments and accumulators."""
    opt = state.opt_state
    tensors = itertools.chain(trainer.module.parameters(), trainer.module.buffers(),
                              state.params.values(), opt.mu, opt.nu, opt.acc or ())
    return tuple(t.data_ptr() for t in tensors)


def _flash_counts() -> list[tuple[Callable, str, int]]:
    """(wrapper, dtype key, count) for each flash launch counter."""
    return [(fn, k, n) for fn in (att.flash_attention_fwd, att.flash_attention_bwd)
            for k, n in fn.launches.items()]


class _ChunkGraph:
    """K whole optimizer steps (forward, loss, ``backward``, global norm,
    clip and AdamW, accumulation resolved by the phase of the key) captured
    in one ``torch.cuda.CUDAGraph`` and replayed for every chunk of its key.

    It holds the static device inputs ``[K, ...]`` and the scalar table,
    filled before each replay from pinned host buffers by copies that do
    not wait for the host, and the static ``loss`` and ``grad_norm``
    outputs; all of them are allocated outside the graph's memory pool, so
    nothing read after a replay lives in it. The module's parameters and
    the optimizer moments stay where they are and are updated in place.
    The graph has a pool of its own. It keeps no reference to the trainer,
    but it holds those tensors' addresses: a replay for a state whose tensors
    lie elsewhere (one from another ``init_state``, or a module moved since
    the capture) raises instead of writing to them.

    A replay runs the flash kernels without their wrappers, so the capture
    notes how much each launch counter grew, takes that back (nothing ran),
    and every replay adds it: the counters count launches that ran."""

    def __init__(self, stacked: dict, device: torch.device):
        self.host = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype,
                                    pin_memory=True) for k, v in stacked.items()}
        self.inputs = {k: torch.empty_like(v, device=device) for k, v in self.host.items()}
        K = next(iter(stacked.values())).shape[0]
        self.host_scalars = torch.empty((K, 4), dtype=torch.float32, pin_memory=True)
        self.scalars = torch.empty((K, 4), dtype=torch.float32, device=device)
        self.loss = torch.zeros(K, dtype=torch.float32, device=device)
        self.grad_norm = torch.zeros(K, dtype=torch.float32, device=device)
        self.copied = torch.cuda.Event()  # the last copy out of the pinned buffers
        self.graph: torch.cuda.CUDAGraph | None = None
        self.binding: tuple[int, ...] = ()  # _binding at the capture
        self.launches: list[tuple[Callable, str, int]] = []

    def _load(self, stacked: dict, table: np.ndarray) -> None:
        self.copied.synchronize()  # the pinned buffers are free again
        for k, v in stacked.items():
            self.host[k].numpy()[...] = v
        self.host_scalars.numpy()[...] = table
        for k, v in self.inputs.items():
            v.copy_(self.host[k], non_blocking=True)
        self.scalars.copy_(self.host_scalars, non_blocking=True)
        self.copied.record()

    def _capture(self, trainer: "Trainer", state: "TrainState", micro: list[int]) -> None:
        graph = torch.cuda.CUDAGraph()
        self.binding = _binding(trainer, state)
        before = _flash_counts()
        with torch.cuda.graph(graph, stream=trainer._side_stream()):
            for i, m in enumerate(micro):
                loss, grad_norm = trainer._step(
                    state, {k: v[i] for k, v in self.inputs.items()}, self.scalars[i], m)
                self.loss[i].copy_(loss)
                self.grad_norm[i].copy_(grad_norm)
        for fn, k, n in before:
            self.launches.append((fn, k, fn.launches[k] - n))
            fn.launches[k] = n
        for p in state.params.values():
            p.grad = None  # the last step's gradients live in the graph's pool
        self.graph = graph

    def __call__(self, trainer: "Trainer", state: "TrainState", stacked: dict,
                 table: np.ndarray, micro: list[int]) -> dict:
        if self.graph is not None and _binding(trainer, state) != self.binding:
            raise RuntimeError(
                "train_steps_scan: this chunk's CUDA graph was captured with other parameter "
                "or optimizer-moment tensors than this state holds (a state from another "
                "init_state, or a module moved since the capture); call "
                "trainer.release_graphs() before training it")
        self._load(stacked, table)
        if self.graph is None:
            self._capture(trainer, state, micro)
        self.graph.replay()
        for fn, k, n in self.launches:
            fn.launches[k] += n
        return {"loss": self.loss.clone(), "grad_norm": self.grad_norm.clone()}


class Trainer:
    """Owns the module on its device, the optimizer and the step loop.

    ``loss_fn(module, batch) -> loss`` replaces the default masked cross
    entropy of the module's logits against ``labels``. ``device`` defaults
    to the card and raises on a host without one. ``has_batch_stats``: the
    module takes a ``train`` keyword (True in the step) and keeps running
    statistics in its buffers."""

    def __init__(self, module: nn.Module, cfg: TrainerConfig,
                 loss_fn: Callable[[nn.Module, dict], torch.Tensor] | None = None,
                 *, device: str | torch.device = "cuda", mesh=None,
                 has_batch_stats: bool = False):
        if mesh is not None:
            raise _unported("a mesh", _MULTI_GPU)
        self.device = resolve_device("Trainer", device)
        self.module = module.eval()  # dropout stays off, as in the JAX step
        self.cfg = cfg
        self.has_batch_stats = has_batch_stats
        self._loss_fn = loss_fn
        self._tx = _Optimizer(cfg, [n for n, _ in module.named_parameters()])
        self._metrics: list[dict] = []
        # newest optimizer step whose loss was finite (post-step numbering);
        # -1 until the first loss is seen
        self.last_finite_step: int = -1
        # train_steps_scan on the card: the keys whose warm-up chunk ran; the
        # captured graphs go when the trainer does
        self._warm: set = set()
        weakref.finalize(self, _release_graphs, cb.instance_token(self))

    def init_state(self, seed: int = 0, init_params: dict | None = None,
                   init_batch_stats: dict | None = None) -> TrainState:
        """Fresh state. ``init_params`` (a ``state_dict`` of host arrays)
        replaces the module's values, every parameter by name and shape;
        without it the module's own initialisers run under ``seed``. With
        ``has_batch_stats`` the running statistics start from their initial
        values (each module's ``reset_running_stats``), or from
        ``init_batch_stats`` (host arrays by buffer name, each buffer given).
        The module's tensors move, so the trainer's captured graphs are
        dropped (:meth:`release_graphs`)."""
        self.release_graphs()
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
            if self.has_batch_stats:
                _init_buffers(module, init_batch_stats)
        self.module = module.to(self.device)
        params = dict(self.module.named_parameters())
        stats = dict(self.module.named_buffers()) if self.has_batch_stats else None
        return TrainState(params=params, opt_state=self._tx.init(list(params.values())),
                          batch_stats=stats)

    def _model_inputs(self, batch: dict) -> dict:
        drop = {"labels", "label", "mask", "_valid"}
        return {k: v for k, v in batch.items() if k not in drop}

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def default_loss(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(masked cross entropy, logits) of one device batch; with
        ``has_batch_stats`` the module runs with ``train=True`` (batch
        statistics, running statistics updated)."""
        inputs = self._model_inputs(batch)
        if self.has_batch_stats:
            inputs["train"] = True
        logits = self.module(**inputs)
        labels = batch.get("labels", batch.get("label"))
        return cross_entropy_loss(logits, labels, batch.get("_valid")), logits

    def _step(self, state: TrainState, batch: dict, scalars: torch.Tensor,
              micro: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The body of one step on a device batch, shared by the eager step
        and the captured chunk: forward, ``backward``, the global norm of
        the raw gradients, and the optimizer with ``scalars`` (a row of
        ``_Optimizer.plan``'s table) at accumulation index ``micro``.
        Returns the loss and the norm as f32 device tensors; reads nothing
        back to the host."""
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
        self._tx.apply(grads, state.opt_state, params, scalars, micro)
        return loss.detach().float(), grad_norm.float()

    def train_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """One step on a host batch: forward, backward, optimizer. ``state``
        is updated in place and returned; ``metrics`` holds the loss and
        the global norm of the raw gradients as 0-d device tensors."""
        batch = self._to_device(batch)
        table, micro = self._tx.plan(state.opt_state, 1)
        loss, grad_norm = self._step(state, batch, _scalars_on(table, self.device)[0], micro[0])
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    def train_steps_scan(self, state: TrainState, stacked_batches: dict
                         ) -> tuple[TrainState, dict]:
        """K optimizer steps over ``stacked_batches`` (host arrays with a
        leading dim K): the state after them, and ``{"loss": [K],
        "grad_norm": [K]}`` as f32 device tensors, as the JAX package's
        ``lax.scan`` returns its stacked metrics.

        On a CUDA device the K steps run as one captured CUDA graph
        (:class:`_ChunkGraph`), got through the process-wide
        :class:`~synapseml_torch.core.batching.CompiledCache` under the key
        (the shape key of one batch, K, the accumulation phase at the
        chunk's start): the first chunk of a new key runs its K steps
        eagerly on a side stream (the warm-up torch advises before a
        capture; they are real steps), the next captures and replays, the
        later ones replay. A failed capture or replay raises. On the CPU
        the K steps run eagerly through the same step body."""
        stacked = {k: np.asarray(v) for k, v in stacked_batches.items()}
        K = int(next(iter(stacked.values())).shape[0])
        phase = state.opt_state.mini_step
        table, micro = self._tx.plan(state.opt_state, K)
        if self.device.type != "cuda":
            metrics = self._eager_chunk(state, stacked, table, micro)
        else:
            key = (_shape_key({k: v[0] for k, v in stacked.items()}), K, phase)
            if key not in self._warm:
                metrics = self._warm_up(state, stacked, table, micro)
                self._warm.add(key)
            else:
                runner = cb.get_compiled_cache().get(
                    "train_steps_scan", key, lambda: _ChunkGraph(stacked, self.device),
                    instance=cb.instance_token(self))
                metrics = runner(self, state, stacked, table, micro)
        state.step += K
        return state, metrics

    def _eager_chunk(self, state: TrainState, stacked: dict, table: np.ndarray,
                     micro: list[int]) -> dict:
        """K eager steps over a stacked chunk, on the current stream."""
        batches = self._to_device(stacked)
        scalars = _scalars_on(table, self.device)
        out = [self._step(state, {k: v[i] for k, v in batches.items()}, scalars[i], m)
               for i, m in enumerate(micro)]
        return {"loss": torch.stack([o[0] for o in out]),
                "grad_norm": torch.stack([o[1] for o in out])}

    def _side_stream(self) -> "torch.cuda.Stream":
        """The stream of the warm-up chunks and captures on this trainer's
        card: one a device for the process, since cuBLAS keeps a workspace
        for every stream it has run on until the process ends."""
        with _SIDE_LOCK:
            if self.device not in _SIDE_STREAMS:
                _SIDE_STREAMS[self.device] = torch.cuda.Stream(self.device)
            return _SIDE_STREAMS[self.device]

    def _warm_up(self, state: TrainState, stacked: dict, table: np.ndarray,
                 micro: list[int]) -> dict:
        """A new key's first chunk: its K steps, eagerly on the side stream,
        which meet every first-use cost of the step (kernel builds, cuBLAS
        workspaces, the flash kernels' shared-memory set-up) before a
        capture."""
        side = self._side_stream()
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            metrics = self._eager_chunk(state, stacked, table, micro)
        torch.cuda.current_stream(self.device).wait_stream(side)
        return metrics

    def release_graphs(self) -> int:
        """Drop this trainer's captured graphs (and their memory pools) from
        the process-wide cache; returns how many."""
        self._warm.clear()
        return _release_graphs(cb.instance_token(self))

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

        Default path (:meth:`_fit_chunked`): a producer thread stacks
        ``scan_chunk`` same-shape batches into chunks for
        :meth:`train_steps_scan` (CUDA graphs on the card), the next chunk
        built while this one trains; a shape change flushes the pending
        batches and a short or odd tail runs per step. A ``callback``, a
        ``skip_fn``, ``scan_chunk <= 1`` or ``max_steps <= 1`` run the
        per-step loop instead:

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
        if not (callback is not None or skip_fn is not None or scan_chunk <= 1
                or max_steps <= 1):
            return self._fit_chunked(state, it, max_steps, scan_chunk, log_every)
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

    def _fit_chunked(self, state: TrainState, it: Iterator[dict], max_steps: int,
                     scan_chunk: int, log_every: int = 50) -> TrainState:
        """The JAX package's ``_fit_chunked``: a producer thread stacks
        ``scan_chunk`` same-shape batches into a chunk (double-buffered, at
        most two waiting), a shape change flushes the pending batches, and
        a short or odd tail goes per step. Each chunk's losses are read
        once, checked by the non-finite guard, and a log window closes when
        ``log_every`` steps have passed or the last step is done. A producer
        error is raised here; an error here stops the producer."""
        end = object()
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                pending: list[dict] = []
                pkey = None
                taken = 0

                def flush() -> bool:
                    nonlocal pending, pkey
                    if not pending:
                        return True
                    if len(pending) == scan_chunk:
                        item = ("chunk", {k: np.stack([b[k] for b in pending])
                                          for k in pending[0]})
                    else:  # a short or odd tail: per step
                        item = ("steps", pending)
                    pending, pkey = [], None
                    return put(item)

                while taken < max_steps:
                    try:
                        b = next(it)
                    except StopIteration:
                        break
                    key = _shape_key(b)
                    if pending and key != pkey:
                        if not flush():
                            return
                    pending.append(b)
                    pkey = key
                    taken += 1
                    if len(pending) == scan_chunk and not flush():
                        return
                if flush():
                    put(end)
            except BaseException as e:  # noqa: BLE001 - surfaced in the consumer
                put(e)

        threading.Thread(target=producer, daemon=True, name="fit-chunk-producer").start()
        meter = _ThroughputMeter(self, state.params)
        steps_done = logged_at = 0
        base = state.step
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                kind, payload = item
                if kind == "chunk":
                    state, metrics = self.train_steps_scan(state, payload)
                    meter.observe(payload, steps=scan_chunk)
                    steps_done += scan_chunk
                    losses = metrics["loss"].cpu().numpy()
                else:
                    step_losses = []
                    for b in payload:
                        state, metrics = self.train_step(state, b)
                        meter.observe(b, steps=1)
                        step_losses.append(metrics["loss"])
                    steps_done += len(payload)
                    losses = torch.stack(step_losses).cpu().numpy()
                self._observe_losses(losses, last_step=base + steps_done)
                if steps_done - logged_at >= log_every or steps_done >= max_steps:
                    self._metrics.append(meter.entry(float(losses[-1])))
                    logged_at = steps_done
        finally:
            stop.set()
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

    def observe(self, batch: dict, steps: int = 1) -> None:
        """``batch`` leaves are (B, ...) when ``steps`` is 1, (K, B, ...)
        stacked when it is K."""
        self.steps += steps
        first = np.shape(next(iter(batch.values())))
        self.n_samples += int(np.prod(first[: (2 if steps > 1 else 1)]))
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
               seed: int, init_params=None, init_batch_stats=None, scan_chunk: int = 8,
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
    initialises the state (``trainer.init_state(seed, init_params,
    init_batch_stats)``) unless
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
            state = trainer.init_state(seed=seed, init_params=init_params,
                                       init_batch_stats=init_batch_stats)
        return trainer.fit(state, iter(loader), max_steps=remaining,
                           scan_chunk=scan_chunk, skip_fn=skip_fn, callback=callback)
    finally:
        loader.close()


def fit_gang_source(*args, **kwargs):
    raise _unported("fit_gang_source (elastic gang training)", _MULTI_GPU)


def fit_arrays(trainer: Trainer, data: dict, *, batch_size: int, total_steps: int,
               seed: int, init_params=None, init_batch_stats=None, scan_chunk: int = 8,
               checkpointer=None, checkpoint_every: int = 0,
               shard_rows: int | None = None) -> TrainState:
    """Fit over host arrays: they go behind a
    :class:`synapseml_torch.data.MemorySource` into :func:`fit_source`.
    ``shard_rows`` sets the shard layout (None = one shard)."""
    from ..data.source import MemorySource

    n = next(iter(data.values())).shape[0]
    return fit_source(trainer, MemorySource(data, shard_rows=shard_rows),
                      batch_size=batch_size, total_steps=total_steps, seed=seed,
                      init_params=init_params, init_batch_stats=init_batch_stats,
                      scan_chunk=scan_chunk, checkpointer=checkpointer,
                      checkpoint_every=checkpoint_every, drop_remainder=n >= batch_size)
