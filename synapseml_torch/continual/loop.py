"""The declarative flywheel: watch -> retrain -> gate -> publish -> canary.

Counterpart of ``synapseml_tpu/continual/loop.py``. :class:`ContinualLoop`
drives one model's serve->log->retrain->canary cycle from a single
:class:`ContinualSpec`. An iteration (:meth:`ContinualLoop.run_once`) walks
seven seams, each consulting the active ``FaultPlan``
(``plan.on_continual("<model>:<seam>")``):

====================  ====================================================
seam                  degradation on failure
====================  ====================================================
``watch``             iteration skipped, nothing changed
``snapshot``          iteration aborted, logged parts stay unconsumed
``train``             supervisor restarts (bounded) from the latest
                      verified checkpoint; NaN rewinds skip the poisoned
                      window; an exhausted budget aborts the iteration
``eval``              gate unanswerable: iteration aborted, no publish
``publish``           nothing published, aliases untouched
``canary``            auto-rollback (``CanaryController``) snaps traffic
                      and the ``prod`` alias back to the stable version
``promote``           rollback to the stable version, alias untouched
====================  ====================================================

In every failure row ``prod``, the alias and the fleet serving it, is as
it was before the iteration; the outcome lands on
``synapseml_continual_iterations_total{outcome}`` and the loop stays
runnable.

Training data is the request logger's DONE-committed parts: rows map
through ``row_fn`` with per-row quarantine, a seeded hash holds out a
fraction of the parts, and the candidate must beat the current prod model
on that held-out slice by ``gate_min_margin`` before anything is
published. Canary and promote go through the port's
``registry.deploy.Deployment``; probe traffic replays logged bodies through
the front of ``io/distributed_serving.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import urllib.request
from typing import Callable

import numpy as np

from ..core import observability as obs
from ..core.faults import active_fault_plan
from ..registry.store import atomic_write_bytes
from .logger import _DONE_SUFFIX, _PART_PREFIX  # shared layout constants
from .supervisor import TrainSupervisor

__all__ = ["ContinualSpec", "ContinualLoop", "LoopAborted",
           "annotate_drift_gauge", "drift_annotation"]

# gauge name -> opaque evidence ref (e.g. the rai plane's audit artifact
# "name:version"). A drift-triggered iteration appends it to the trigger
# reason, so the retrain record carries WHY the gauge fired, not just that
# it did. Process-local like the gauge itself; last writer wins.
_DRIFT_ANNOTATIONS: dict[str, str] = {}


def annotate_drift_gauge(gauge: str, evidence: str | None) -> None:
    """Attach (or clear, with ``None``) the evidence ref behind a drift
    gauge — the rai ``AuditJob`` calls this with the audit artifact it
    published alongside setting the per-segment gauge values."""
    if evidence is None:
        _DRIFT_ANNOTATIONS.pop(gauge, None)
    else:
        _DRIFT_ANNOTATIONS[gauge] = str(evidence)


def drift_annotation(gauge: str) -> str | None:
    """The current evidence ref behind ``gauge``, if any."""
    return _DRIFT_ANNOTATIONS.get(gauge)

_LOOP_METRICS = obs.HandleCache(lambda reg: {
    "iterations": reg.counter(
        "synapseml_continual_iterations_total",
        "flywheel iterations by outcome (promoted / gate_failed / "
        "canary_rolled_back / skipped:* / error:*)", ("model", "outcome")),
    "gate_margin": reg.gauge(
        "synapseml_continual_gate_margin",
        "last eval-gate margin (prod metric - candidate metric, sign "
        "normalized so positive = candidate better)", ("model",)),
    "quarantined": reg.counter(
        "synapseml_continual_quarantined_rows_total",
        "logged rows dropped while building the training set (malformed "
        "record / row_fn failure / schema mismatch)", ("model",)),
    "train_rows": reg.gauge(
        "synapseml_continual_train_rows",
        "rows in the last iteration's training split", ("model",)),
})


class LoopAborted(RuntimeError):
    """An iteration died at ``seam`` — contained by :meth:`ContinualLoop.
    run_once` into an ``error:<seam>`` outcome with ``prod`` untouched."""

    def __init__(self, seam: str, cause: BaseException):
        super().__init__(f"continual iteration aborted at seam "
                         f"{seam!r}: {type(cause).__name__}: {cause}")
        self.seam = seam
        self.cause = cause


@dataclasses.dataclass
class ContinualSpec:
    """One model's flywheel, declaratively. JSON round-trips so a fleet
    config file can carry it (``to_json``/``from_json``)."""

    model: str
    # -- watch triggers ----------------------------------------------------
    min_new_rows: int = 1            # freshness: new logged rows required
    drift_gauge: str | None = None   # a metrics-registry gauge; fires when ...
    drift_threshold: float | None = None  # ... its value exceeds this
    cadence_s: float = 0.0           # run_forever poll interval
    # -- training ----------------------------------------------------------
    seed: int = 0
    holdout_fraction: float = 0.25   # fraction of PARTS held out for eval
    max_restarts: int = 3
    max_rewinds: int = 2
    # preemption/resize resumes (elastic gang exits) get their OWN budget:
    # a preempted retraining iteration RESUMES from its coordinated
    # checkpoint instead of aborting, without eating the crash budget
    max_preempts: int = 16
    hang_timeout_s: float = 60.0
    # -- eval gate ---------------------------------------------------------
    gate_metric: str = "loss"        # label on the published metrics
    gate_min_margin: float = 0.0     # candidate must beat prod by this
    higher_is_better: bool = False
    # -- publish / rollout -------------------------------------------------
    publish: dict | None = None      # extra registry.publish kwargs (aot=...)
    alias: str = "prod"
    canary_weight: float = 0.1
    canary_workers: int = 1
    canary_min_requests: int = 10
    canary_timeout_s: float = 30.0
    canary: dict | None = None       # CanaryController kwargs ({} = defaults)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ContinualSpec":
        return cls(**json.loads(text))


def _tolerant_rows(path: str) -> list:
    """One committed part's records; a torn/garbage line inside a
    COMMITTED part should be impossible (atomic commit), but a poisoned
    upstream must cost one quarantined row, not the whole iteration —
    malformed lines yield ``None`` placeholders the caller counts."""
    rows = []
    with open(path, "rb") as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                rows.append(None)
    return rows


def default_row_fn(record: dict) -> dict:
    """Default logged-record → training-row mapping: the request body IS
    the row (the serving payload carries the features, and — for logged
    supervised traffic — the label). Override with ``row_fn=`` for any
    other schema."""
    body = record.get("body")
    if not isinstance(body, dict):
        raise ValueError("logged record body is not a JSON object")
    return body


class ContinualLoop:
    """Drive one :class:`ContinualSpec` against a registry + (optionally)
    a serving fleet.

    * ``log_dir`` — the :class:`~synapseml_torch.continual.RequestLogger`'s
      directory (or any directory of DONE-committed jsonl parts);
    * ``train_fn(ctx, attempt)`` — build/resume the candidate model; MUST
      checkpoint into ``ctx.checkpoint_dir`` and honor ``attempt.resume``
      / ``attempt.skip_fn`` (run under :class:`TrainSupervisor`); returns
      the candidate STAGE to publish;
    * ``eval_fn(stage, holdout_cols) -> float`` — the gate metric on the
      held-out slice (lower is better unless ``spec.higher_is_better``);
    * ``deployment`` — a :class:`~synapseml_torch.registry.Deployment` for
      canary + promote; ``None`` pins the alias directly after the gate
      (no-fleet mode);
    * ``traffic_fn(n)`` — drive ``n`` requests through the fleet during
      the canary window; defaults to replaying logged request bodies
      through the front.

    ``ctx`` (a :class:`TrainContext`) carries the training source, the
    holdout columns, the iteration's checkpoint dir, the resolved prod
    model (warm-start donor) and the previous champion's checkpoint dir.
    """

    def __init__(self, spec: ContinualSpec, registry, log_dir: str,
                 train_fn: Callable, eval_fn: Callable,
                 row_fn: Callable | None = None, deployment=None,
                 state_dir: str | None = None,
                 traffic_fn: Callable | None = None):
        self.spec = spec
        self.registry = registry
        self.log_dir = str(log_dir)
        self.train_fn = train_fn
        self.eval_fn = eval_fn
        self.row_fn = row_fn or default_row_fn
        self.deployment = deployment
        self.traffic_fn = traffic_fn
        self.state_dir = str(state_dir or
                             os.path.join(self.log_dir, "_continual"))
        os.makedirs(self.state_dir, exist_ok=True)
        self.state = self._load_state()
        self.history: list[dict] = self.state.setdefault("history", [])

    # -- persistent loop state ---------------------------------------------
    def _state_path(self) -> str:
        return os.path.join(self.state_dir, "loop_state.json")

    def _load_state(self) -> dict:
        try:
            with open(self._state_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {"iteration": 0, "consumed": [], "champion_ckpt": None,
                    "history": []}

    def _save_state(self) -> None:
        atomic_write_bytes(self._state_path(),
                           json.dumps(self.state, indent=2).encode())

    # -- seams --------------------------------------------------------------
    def _seam(self, name: str) -> None:
        plan = active_fault_plan()
        if plan is not None:
            plan.on_continual(f"{self.spec.model}:{name}")

    # -- watch --------------------------------------------------------------
    def _committed_parts(self) -> list[str]:
        try:
            names = sorted(os.listdir(self.log_dir))
        except OSError:
            return []
        return [n for n in names
                if n.startswith(_PART_PREFIX) and n.endswith(".jsonl")
                and os.path.exists(os.path.join(self.log_dir,
                                                n + _DONE_SUFFIX))]

    def _new_parts(self) -> list[str]:
        consumed = set(self.state.get("consumed", []))
        return [n for n in self._committed_parts() if n not in consumed]

    def _part_rows(self, name: str) -> int:
        try:
            with open(os.path.join(self.log_dir, name + _DONE_SUFFIX)) as f:
                return int(json.load(f).get("rows", 0))
        except (OSError, json.JSONDecodeError, ValueError):
            return 0

    def should_run(self) -> tuple[bool, str]:
        """(run?, reason). Freshness: enough new committed rows. Drift: a
        named registry gauge above its threshold forces a run regardless."""
        fresh_rows = sum(self._part_rows(n) for n in self._new_parts())
        if fresh_rows >= max(self.spec.min_new_rows, 1):
            return True, f"fresh_rows={fresh_rows}"
        if self.spec.drift_gauge and self.spec.drift_threshold is not None:
            value = self._gauge_value(self.spec.drift_gauge)
            if value is not None and value > self.spec.drift_threshold:
                reason = (f"drift {self.spec.drift_gauge}="
                          f"{value:g}>{self.spec.drift_threshold:g}")
                evidence = drift_annotation(self.spec.drift_gauge)
                if evidence:
                    # e.g. the rai plane's published audit artifact: the
                    # retrain record names its triggering evidence
                    reason += f" audit={evidence}"
                return True, reason
        return False, f"fresh_rows={fresh_rows}<{self.spec.min_new_rows}"

    @staticmethod
    def _gauge_value(name: str) -> float | None:
        """Max value across the named series in the metrics registry snapshot
        (snapshot keys are ``name{label=...}``; unlabeled = bare name)."""
        snap = obs.get_registry().snapshot()
        values = [v for k, v in snap.items()
                  if (k == name or k.startswith(name + "{"))
                  and isinstance(v, (int, float))]
        return max(values) if values else None

    # -- dataset ------------------------------------------------------------
    def _holdout_part(self, name: str) -> bool:
        import hashlib

        h = int(hashlib.sha256(
            f"{self.spec.seed}:{name}".encode()).hexdigest()[:8], 16)
        return (h % 1000) < int(self.spec.holdout_fraction * 1000)

    def _build_dataset(self, parts: list[str]) -> tuple[dict, dict, int]:
        """(train_cols, holdout_cols, quarantined). Parts split into
        train/holdout deterministically by seeded hash; rows map through
        ``row_fn`` with per-row quarantine; the row schema is fixed by the
        first good row (rows missing keys quarantine)."""
        train_rows: list[dict] = []
        holdout_rows: list[dict] = []
        quarantined = 0
        schema: tuple | None = None
        for name in parts:
            self._seam(f"read:{name}")
            bucket = (holdout_rows if self._holdout_part(name)
                      else train_rows)
            for record in _tolerant_rows(os.path.join(self.log_dir, name)):
                if record is None:
                    quarantined += 1
                    continue
                try:
                    row = self.row_fn(record)
                    if not isinstance(row, dict) or not row:
                        raise ValueError("row_fn must return a non-empty "
                                         "dict")
                    key = tuple(sorted(row))
                    if schema is None:
                        schema = key
                    elif key != schema:
                        raise ValueError(f"row schema {key} != {schema}")
                    # fail NOW on a non-numeric value, inside quarantine
                    row = {k: np.asarray(v) for k, v in row.items()}
                    if any(v.dtype == object for v in row.values()):
                        raise ValueError("non-numeric row value")
                    bucket.append(row)
                except Exception:  # noqa: BLE001 — one bad row, one tick
                    quarantined += 1
        if quarantined:
            _LOOP_METRICS.get()["quarantined"].inc(quarantined,
                                                   model=self.spec.model)
        # both splits must be non-empty for the gate to mean anything; with
        # few parts the hash split can starve one side — rebalance by
        # MOVING tail rows across (deterministic), never by sharing them:
        # an overlap would let an overfit candidate grade its own homework.
        # Too few rows to keep the splits disjoint ⇒ one side stays empty
        # and the iteration skips (skipped:no_usable_rows).
        if train_rows and not holdout_rows:
            cut = max(len(train_rows) // 5, 1)
            if len(train_rows) > cut:
                holdout_rows, train_rows = (train_rows[-cut:],
                                            train_rows[:-cut])
        elif holdout_rows and not train_rows:
            cut = max(len(holdout_rows) // 5, 1)
            if len(holdout_rows) > cut:
                train_rows, holdout_rows = (holdout_rows[:-cut],
                                            holdout_rows[-cut:])

        def columnar(rows: list[dict]) -> dict:
            if not rows:
                return {}
            return {k: np.stack([np.asarray(r[k]) for r in rows])
                    for k in rows[0]}

        return columnar(train_rows), columnar(holdout_rows), quarantined

    # -- canary traffic -----------------------------------------------------
    def _replay_traffic(self, n: int) -> int:
        """Default canary probe: replay the newest logged request bodies
        through the deployment's front (they are known-serveable traffic).
        Returns requests actually sent."""
        if self.deployment is None:
            return 0
        address = self.deployment.serving.front.address
        bodies: list[tuple[str, bytes]] = []
        for name in reversed(self._committed_parts()):
            for record in reversed(_tolerant_rows(
                    os.path.join(self.log_dir, name))):
                if record is None or record.get("method") != "POST":
                    continue
                body = record.get("body")
                path = record.get("path", "/")
                bodies.append((path, json.dumps(body).encode()))
                if len(bodies) >= n:
                    break
            if len(bodies) >= n:
                break
        sent = 0
        for i in range(n):
            path, body = bodies[i % len(bodies)] if bodies else ("/", b"{}")
            req = urllib.request.Request(
                address + path, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    r.read()
                sent += 1
            except Exception:  # noqa: BLE001 — probe failures are the
                sent += 1      # canary controller's signal, not ours
        return sent

    def _drive_canary(self, controller, version: str) -> bool:
        """Send probe traffic until the canary has judged
        ``canary_min_requests`` or the controller rolls back. True when
        the canary is healthy and promotable."""
        spec = self.spec
        deadline = time.monotonic() + spec.canary_timeout_s
        front = self.deployment.serving.front
        send = self.traffic_fn or self._replay_traffic
        while time.monotonic() < deadline:
            if controller is not None and controller.rolled_back:
                return False
            stats = front.version_stats().get(version, {})
            seen = stats.get("ok", 0) + stats.get("err", 0)
            if seen >= spec.canary_min_requests:
                # let the controller ingest the final counters
                if controller is not None:
                    reason = controller.check_once()
                    if reason is not None or controller.rolled_back:
                        return False
                return True
            send(max(spec.canary_min_requests - seen, 1))
            time.sleep(0.05)
        return controller is None or not controller.rolled_back

    # -- the iteration ------------------------------------------------------
    def run_once(self, raise_errors: bool = False) -> dict:
        """One flywheel iteration. NEVER raises for operational failures
        (containment contract): the outcome lands in the returned record
        (and the metric series), ``prod`` stays untouched on every
        non-promoted path, and the next ``run_once`` proceeds from clean
        state. ``raise_errors=True`` ADDITIONALLY re-raises the contained
        failure as :class:`LoopAborted` after recording it — for operators
        driving one iteration by hand."""
        spec = self.spec
        t0 = time.perf_counter()
        record: dict = {"iteration": self.state.get("iteration", 0),
                        "model": spec.model, "outcome": None}
        seam = "watch"
        canary_started = False
        stable = None
        try:
            self._seam("watch")
            ok, reason = self.should_run()
            record["trigger"] = reason
            if not ok:
                record["outcome"] = "skipped:not_due"
                return self._finish(record, t0)

            seam = "snapshot"
            self._seam("snapshot")
            parts = self._new_parts()
            train_cols, holdout_cols, quarantined = \
                self._build_dataset(parts)
            record["parts"] = len(parts)
            record["quarantined"] = quarantined
            n_train = (len(next(iter(train_cols.values())))
                       if train_cols else 0)
            record["train_rows"] = n_train
            _LOOP_METRICS.get()["train_rows"].set(n_train, model=spec.model)
            if not train_cols or not holdout_cols:
                record["outcome"] = "skipped:no_usable_rows"
                return self._finish(record, t0)

            seam = "train"
            self._seam("train")
            prod = self._resolve_prod()
            ckpt_dir = os.path.join(self.state_dir,
                                    f"it{record['iteration']:04d}", "ckpt")
            ctx = TrainContext(
                spec=spec, train_cols=train_cols,
                holdout_cols=holdout_cols, checkpoint_dir=ckpt_dir,
                prod=prod,
                champion_ckpt=self.state.get("champion_ckpt"))
            supervisor = TrainSupervisor(
                ckpt_dir, max_restarts=spec.max_restarts,
                max_rewinds=spec.max_rewinds,
                max_preempts=spec.max_preempts,
                hang_timeout_s=spec.hang_timeout_s)
            record["supervisor"] = {"restarts": 0, "rewinds": 0,
                                    "preempts": 0}
            stage = supervisor.run(
                lambda attempt: self.train_fn(ctx, attempt))
            record["supervisor"] = {"restarts": supervisor.restarts,
                                    "rewinds": supervisor.rewinds,
                                    "preempts": supervisor.preempts}
            # the data is consumed whatever the gate says — retraining on
            # the same poisoned shards next tick would loop forever
            self.state.setdefault("consumed", []).extend(parts)

            seam = "eval"
            self._seam("eval")
            cand_metric = float(self.eval_fn(stage, holdout_cols))
            prod_metric = (float(self.eval_fn(prod.stage, holdout_cols))
                           if prod is not None else None)
            sign = 1.0 if spec.higher_is_better else -1.0
            margin = (sign * (cand_metric - prod_metric)
                      if prod_metric is not None else float("inf"))
            record["gate"] = {spec.gate_metric: cand_metric,
                              "prod": prod_metric,
                              "margin": None if margin == float("inf")
                              else margin}
            _LOOP_METRICS.get()["gate_margin"].set(
                0.0 if margin == float("inf") else margin,
                model=spec.model)
            # NaN-safe comparison: a NaN candidate metric (diverged model)
            # makes `margin >= threshold` False and FAILS the gate — the
            # `<` form would let a NaN model sail through to prod
            if not (margin >= spec.gate_min_margin):
                record["outcome"] = "gate_failed"
                return self._finish(record, t0)

            seam = "publish"
            self._seam("publish")
            pub = self.registry.publish(
                spec.model, stage,
                metrics={spec.gate_metric: cand_metric,
                         "gate_margin": (None if margin == float("inf")
                                         else margin)},
                **(spec.publish or {}))
            record["version"] = pub.version

            if self.deployment is not None:
                seam = "canary"
                self._seam("canary")
                stable = self.deployment.stable_version()
                controller = self.deployment.canary(
                    pub.version, weight=spec.canary_weight,
                    num_workers=spec.canary_workers,
                    autorollback=spec.canary if spec.canary is not None
                    else {})
                canary_started = True
                healthy = self._drive_canary(controller, pub.version)
                if not healthy:
                    self.deployment.stop_controller()
                    if controller is not None and not controller.rolled_back:
                        self.deployment.rollback(stable=stable)
                    record["outcome"] = "canary_rolled_back"
                    record["rollback_reason"] = (
                        controller.reason if controller is not None
                        else "unhealthy")
                    return self._finish(record, t0)
                seam = "promote"
                self._seam("promote")
                self.deployment.promote(pub.version)
            else:
                seam = "promote"
                self._seam("promote")
                self.registry.pin(spec.model, spec.alias, pub.version)
            self.state["champion_ckpt"] = ckpt_dir
            record["outcome"] = "promoted"
            return self._finish(record, t0)
        except Exception as e:  # noqa: BLE001 — containment contract
            # (KeyboardInterrupt/SystemExit pass through: the operator —
            # or the chaos watchdog — outranks the containment contract)
            if canary_started:
                # never leave a half-rolled-out canary behind: traffic and
                # alias snap back to the stable version
                try:
                    self.deployment.stop_controller()
                    self.deployment.rollback(stable=stable)
                except Exception:  # noqa: BLE001
                    pass
            record["outcome"] = f"error:{seam}"
            record["error"] = f"{type(e).__name__}: {e}"
            record = self._finish(record, t0)
            if raise_errors:
                raise LoopAborted(seam, e) from e
            return record

    def _finish(self, record: dict, t0: float) -> dict:
        record["duration_s"] = round(time.perf_counter() - t0, 3)
        self.state["iteration"] = int(self.state.get("iteration", 0)) + 1
        self.history.append(record)
        self.state["history"] = self.history[-50:]
        self._save_state()
        _LOOP_METRICS.get()["iterations"].inc(model=self.spec.model,
                                              outcome=record["outcome"])
        return record

    def _resolve_prod(self):
        """The current prod model (None before the first promote)."""
        try:
            if self.registry.alias_target(self.spec.model,
                                          self.spec.alias) is None:
                return None
            return self.registry.resolve(self.spec.model, self.spec.alias)
        except FileNotFoundError:
            return None

    # -- background driver ---------------------------------------------------
    def run_forever(self, stop_event=None, max_iterations: int | None = None
                    ) -> list[dict]:
        """Poll ``should_run`` every ``spec.cadence_s`` seconds and run due
        iterations until ``stop_event`` is set (or ``max_iterations`` ran).
        Synchronous — callers wanting a daemon wrap it in a thread."""
        import threading

        stop_event = stop_event or threading.Event()
        out = []
        while not stop_event.is_set():
            out.append(self.run_once())
            if max_iterations is not None and len(out) >= max_iterations:
                break
            stop_event.wait(max(self.spec.cadence_s, 0.05))
        return out


@dataclasses.dataclass
class TrainContext:
    """Everything a ``train_fn`` needs for one iteration. The training
    split is materialized columnar (wrap in a
    :class:`~synapseml_torch.data.MemorySource` — or shard it to disk —
    before ``fit_source``); ``prod`` is the warm-start donor;
    ``checkpoint_dir`` is where the supervisor expects progress."""

    spec: ContinualSpec
    train_cols: dict
    holdout_cols: dict
    checkpoint_dir: str
    prod: object | None
    champion_ckpt: str | None
