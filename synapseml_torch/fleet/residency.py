"""Multi-model residency: one worker hosts N registry versions behind
per-model ``PipelineHolder`` slots with a byte-budgeted LRU.

Counterpart of ``synapseml_tpu/fleet/residency.py``. The long tail of small
models does not deserve a worker each — a real model-serving fleet packs
them onto shared capacity and evicts cold ones. :class:`ResidencyManager`
owns the slots: ``acquire(model)`` returns the resident pipeline (touching
LRU order) or loads it from the registry on a miss, evicting
least-recently-used residents until the artifact fits the byte budget (the
budget's unit is the artifact's bytes on disk, as in the reference).

Eviction gives the card's memory back: the evicted stage's callables leave
the shared ``CompiledCache`` via ``release_executables`` (with any CUDA
graph and its memory pool a cache entry owns), a causal LM's paged engines
release their page pools, and every stage drops its runtime state (its
``_cache_*`` entries and ``_TRANSIENT`` attributes: a ``DeepTextModel``'s
built module on the card, an index's resident shards), so a caller still
holding the evicted stage keeps its host-side Params and nothing on the
card.

The port records no AOT executables (``registry/aot.py``): ``use_aot=True``
takes ``/admin/load``'s route, one structured ``aot_fallback`` warning and
a JIT warmup of the manifest's recorded rows up to ``warmup_cap``.

:func:`serve_multi_model` runs a :class:`~synapseml_torch.io.serving.
ServingServer` whose serve loop routes each request row by the model path
segment (``POST /m/<model>/...``) to its resident slot — the worker-side
half of the ``RoutingFront``'s model-segment routing. Its serve thread
runs with grad off, as ``serve_pipeline``'s does.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..core import batching as cb
from ..core import observability as obs
from ..core.dataframe import DataFrame

__all__ = ["ResidencyManager", "serve_multi_model", "model_path",
           "model_from_path", "artifact_nbytes"]

_RESIDENCY_METRICS = obs.HandleCache(lambda reg: {
    "resident_models": reg.gauge(
        "synapseml_fleet_resident_models",
        "models currently resident on this worker").labels(),
    "resident_bytes": reg.gauge(
        "synapseml_fleet_resident_bytes",
        "artifact bytes currently resident on this worker").labels(),
    "evictions": reg.counter(
        "synapseml_fleet_evictions_total",
        "residency LRU evictions", ("model",)),
    "loads": reg.counter(
        "synapseml_fleet_model_loads_total",
        "residency slot lookups", ("model", "outcome")),
})

# default warmup cap for a residency load (the small-rung discipline: a
# miss-triggered load sits on a live request's critical path)
_RESIDENT_WARMUP_CAP = 16


def model_path(model: str) -> str:
    """The canonical request path for a model on a multi-model fleet."""
    return f"/m/{model}"


def model_from_path(path: str) -> str | None:
    """Extract the model segment from ``/m/<model>[/...][?query]``; None
    when the path does not address a model (health/admin/default
    traffic). Query/fragment suffixes are stripped — ``/m/x?k=v`` must
    route (and key admission/metrics) as ``x``, never as ``x?k=v``."""
    bare = str(path).split("?", 1)[0].split("#", 1)[0]
    parts = bare.split("/")
    if len(parts) >= 3 and parts[1] == "m" and parts[2]:
        return parts[2]
    return None


def artifact_nbytes(path: str) -> int:
    """Total bytes of a materialized artifact directory (the residency
    accounting unit: what evicting the model actually frees)."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                continue
    return total


def _teardown_stage(stage) -> None:
    """Release everything an evicted resident holds on its device: the
    paged-KV engines a causal-LM stage accumulated (``_cache_engines``:
    their live sequences aborted, their page pools released), every other
    ``_cache_*`` entry (a built model, a converted graph), the
    ``_TRANSIENT`` runtime attributes (a built module, its tokenizer and
    device), an index's resident shards, and the stage tree's cached
    callables in the shared ``CompiledCache`` (which close over the module,
    and own any captured CUDA graph and its memory pool). A stage that runs
    again rebuilds all of it."""
    for obj in cb.stage_tree(stage):
        state = getattr(obj, "__dict__", None)
        if state is None:
            continue
        engines = state.pop("_cache_engines", None)
        if isinstance(engines, dict):
            for eng in list(engines.values()):
                try:
                    eng.abort_all()
                    eng.release()
                except Exception:  # noqa: BLE001 — teardown is best-effort
                    pass
        for key in [k for k in state if k.startswith("_cache_")]:
            state.pop(key, None)
        for name in getattr(type(obj), "_TRANSIENT", ()):
            state[name] = None
        drop = getattr(obj, "_drop_resident", None)
        if callable(drop):
            drop()
    cb.release_executables(stage)


class _Resident:
    __slots__ = ("holder", "version", "nbytes", "path")

    def __init__(self, holder, version, nbytes, path):
        self.holder = holder
        self.version = version
        self.nbytes = nbytes
        self.path = path


class ResidencyManager:
    """Byte-budgeted LRU of registry models resident in this process.

    ``registry`` is a :class:`~synapseml_torch.registry.ModelRegistry` (or
    a root path/URL for one); ``refs`` maps model name -> the version/alias
    to resolve (default ``"latest"``). ``byte_budget`` bounds the summed
    artifact bytes; one artifact larger than the whole budget is refused
    outright. ``use_aot=True`` asks for recorded executables, which this
    runtime has none of: each load logs one ``aot_fallback`` warning and
    warms up by JIT, as ``/admin/load`` does."""

    def __init__(self, registry, byte_budget: int,
                 refs: dict[str, str] | None = None,
                 default_ref: str = "latest",
                 use_aot: bool = False,
                 loop_cfg: dict | None = None,
                 warmup_cap: int = _RESIDENT_WARMUP_CAP,
                 nbytes_fn=None):
        if isinstance(registry, (str, os.PathLike)):
            from ..registry.registry import ModelRegistry

            registry = ModelRegistry(str(registry))
        self.registry = registry
        self.byte_budget = int(byte_budget)
        if self.byte_budget <= 0:
            raise ValueError(f"byte_budget must be > 0: {byte_budget}")
        self.refs = dict(refs or {})
        self.default_ref = default_ref
        self.use_aot = bool(use_aot)
        self.loop_cfg = dict(loop_cfg or
                             {"parse_json": True, "input_col": "body"})
        self.warmup_cap = int(warmup_cap)
        self._nbytes_fn = nbytes_fn or artifact_nbytes
        self._slots: "OrderedDict[str, _Resident]" = OrderedDict()
        self._lock = threading.RLock()
        # introspection reads a SNAPSHOT behind its own tiny lock: a miss
        # load holds the main lock for seconds (resolve + evict + warmup),
        # and /admin/stats — the autoscaler's queue-depth poll — must not
        # block on it (a stalled poll would blind the autoscaler exactly
        # while a cold-model load is building the backlog it should see)
        self._snap_lock = threading.Lock()
        self._snapshot: dict = {}
        self._snapshot_bytes = 0

    # -- introspection -----------------------------------------------------
    def resident(self) -> dict:
        """model -> {version, nbytes} (lock-free snapshot, refreshed on
        membership changes — order reflects loads/evictions, not
        per-request hit recency)."""
        with self._snap_lock:
            return dict(self._snapshot)

    def resident_bytes(self) -> int:
        with self._snap_lock:
            return self._snapshot_bytes

    def _refresh_snapshot(self) -> None:
        """(main lock held) Rebuild the introspection snapshot and export
        the occupancy gauges."""
        snap = {m: {"version": r.version, "nbytes": r.nbytes}
                for m, r in self._slots.items()}
        total = sum(r.nbytes for r in self._slots.values())
        with self._snap_lock:
            self._snapshot = snap
            self._snapshot_bytes = total
        m = _RESIDENCY_METRICS.get()
        m["resident_models"].set(len(snap))
        m["resident_bytes"].set(total)

    # -- the slot API ------------------------------------------------------
    def acquire(self, model: str):
        """(stage, version) for ``model``, loading on a miss and touching
        LRU order on a hit. Raises ``KeyError`` for a model the registry
        does not have and ``ValueError`` for one that cannot fit."""
        with self._lock:
            resident = self._slots.get(model)
            if resident is not None:
                # hit path (per request group): LRU touch only — the
                # snapshot refresh (O(slots) rebuild + gauge exports) runs
                # on MEMBERSHIP changes, not on every hit
                self._slots.move_to_end(model)
                _RESIDENCY_METRICS.get()["loads"].inc(model=model,
                                                      outcome="hit")
                return resident.holder.get()
            resident = self._load(model)
            # evict LRU-oldest only AFTER the newcomer loaded and warmed
            # successfully: a broken artifact must fail its own request,
            # never repeatedly tear down healthy neighbors (the cost is a
            # brief accounting overshoot while both exist)
            while sum(r.nbytes for r in self._slots.values()) \
                    + resident.nbytes > self.byte_budget:
                victim, old = next(iter(self._slots.items()))
                del self._slots[victim]
                self._teardown(victim, old)
            self._slots[model] = resident
            self._refresh_snapshot()
            _RESIDENCY_METRICS.get()["loads"].inc(model=model,
                                                  outcome="miss")
            return resident.holder.get()

    def evict(self, model: str) -> bool:
        """Release one resident (no-op False when absent)."""
        with self._lock:
            resident = self._slots.pop(model, None)
            if resident is None:
                return False
            self._teardown(model, resident)
            self._refresh_snapshot()
            return True

    def release_all(self) -> None:
        with self._lock:
            for model in list(self._slots):
                self.evict(model)

    # -- internals (lock held) ---------------------------------------------
    def _teardown(self, model: str, resident: _Resident) -> None:
        _teardown_stage(resident.holder.pipeline)
        _RESIDENCY_METRICS.get()["evictions"].inc(model=model)

    def _load(self, model: str) -> _Resident:
        from ..io.serving import PipelineHolder, run_warmup
        from ..registry import aot as raot

        try:
            resolved = self.registry.resolve(
                model, self.refs.get(model, self.default_ref))
        except FileNotFoundError as e:
            raise KeyError(f"model {model!r} not in registry: {e}") from e
        nbytes = int(self._nbytes_fn(os.path.dirname(resolved.path)))
        if nbytes > self.byte_budget:
            raise ValueError(
                f"model {model!r} ({nbytes} bytes) exceeds the whole "
                f"residency budget ({self.byte_budget} bytes)")
        stage = resolved.stage
        aot_cfg = (resolved.manifest or {}).get("aot") or {}
        warmup_rows = (aot_cfg.get("warmup") or {}).get("rows") or []
        warmup_buckets = [b for b in cb.default_bucketer().ladder
                          if b <= self.warmup_cap]
        if self.use_aot:
            # no executable serialization in this runtime: /admin/load's
            # route, one structured warning, then the JIT warmup below
            raot.log_fallback(raot.load_blocker(aot_cfg), model=model,
                              version=resolved.version)
        try:
            if warmup_rows:
                run_warmup(stage, warmup_rows, warmup_buckets, self.loop_cfg)
        except Exception:
            _teardown_stage(stage)
            raise
        return _Resident(PipelineHolder(stage, resolved.version),
                         resolved.version, nbytes, resolved.path)


def serve_multi_model(residency: ResidencyManager, port: int = 0,
                      batch_interval_ms: int = 5,
                      latency_budget_ms: float | None = None,
                      max_batch_rows: int = 256,
                      reply_col: str = "reply",
                      version: str | None = None):
    """Serve every model the ``residency`` manager can resolve from ONE
    worker: requests address models by path segment (``POST /m/<name>``),
    the serve loop groups each drained micro-batch by model, acquires each
    group's resident pipeline (loading/evicting under the byte budget), and
    transforms the groups independently — one failing model's batch is that
    group's 500, never its neighbors'. Unknown models get terminal 404s.
    Returns the started :class:`~synapseml_torch.io.serving.ServingServer`
    (``server.residency`` exposes the manager; ``/admin/stats`` reports the
    resident set)."""
    from ..io.serving import (PipelineHolder, ServingServer, _prepare_batch)

    server = ServingServer(port=port)
    # the holder slot holds the residency manager's identity for /admin
    # introspection; per-model holders live inside the manager
    server.pipeline_holder = PipelineHolder(residency, version)
    server.residency = residency
    server._loop_cfg = dict(residency.loop_cfg)
    server.start()
    budget_s = (batch_interval_ms if latency_budget_ms is None
                else latency_budget_ms) / 1000.0

    @torch.no_grad()
    def loop():
        while server._running:
            batch = server.read_batch_adaptive(
                max_rows=max_batch_rows, latency_budget_s=budget_s,
                poll_timeout_s=max(batch_interval_ms, 10) / 1000.0)
            if batch.is_empty():
                continue
            # collect each column ONCE per drained batch; groups index into
            # the shared arrays (G resident models must not cost G full
            # re-materializations of the batch on the serving hot path)
            cols = {c: batch.collect_column(c)
                    for c in ("id", "method", "path", "body")}
            groups: dict[str | None, list[int]] = {}
            for i, p in enumerate(cols["path"]):
                groups.setdefault(model_from_path(p), []).append(i)
            for model, idxs in groups.items():
                _serve_group(cols, model, idxs)

    def _reply_rows(ids, idxs, payload, status) -> None:
        for i in idxs:
            ex = server.exchange_for(str(ids[i]))
            if ex is not None:
                ex.respond(payload, status=status)

    def _serve_group(cols, model, idxs) -> None:
        ids = cols["id"]
        if model is None:
            _reply_rows(ids, idxs, {"error": "multi-model worker: address "
                                             "a model as /m/<name>"}, 404)
            return
        try:
            stage, _v = residency.acquire(model)
        except (KeyError, ValueError) as e:
            _reply_rows(ids, idxs, {"error": str(e)}, 404)
            return
        except Exception as e:  # noqa: BLE001 — a failed LOAD (corrupt
            # artifact, warmup raise, blob I/O) is this model's 500; it
            # must never kill the serve thread and brick every neighbor
            _reply_rows(ids, idxs, {"error": f"model load failed: "
                                             f"{type(e).__name__}: {e}"},
                        500)
            return
        sub = DataFrame([{
            col: np.asarray([vals[i] for i in idxs], dtype=object)
            for col, vals in cols.items()
        }])
        try:
            prepared = _prepare_batch(sub, **residency.loop_cfg)
            server.reply_batch(stage.transform(prepared),
                               reply_col=reply_col)
        except Exception as e:  # noqa: BLE001 — one model's failure is
            _reply_rows(ids, idxs, {"error": str(e)}, 500)  # its own 500

    threading.Thread(target=loop, daemon=True).start()
    return server
