"""Crash-safe long training runs: restarts, hang watchdog, NaN rewind.

Counterpart of ``synapseml_tpu/continual/supervisor.py``.
:class:`TrainSupervisor` wraps a ``fit_source``-shaped training attempt so
that the ways a long fit dies become bounded, observable degradations:

* **crash**: the attempt raises (an injected
  ``FaultSpec(..., planes=("training",))``, an OOM, a killed subprocess);
  it restarts under a bounded ``RetryPolicy`` (each restart counted on
  ``resilience_measures("training")`` and
  ``synapseml_continual_supervisor_restarts_total``) and resumes from the
  latest *verified* checkpoint;
* **hang**: subprocess mode (:meth:`TrainSupervisor.run_subprocess`)
  watches the checkpoint directory; no new completed step within
  ``hang_timeout_s`` of the launch or of the last new step means SIGKILL
  and a restart (the clock starts at launch: give it room for the child's
  start-up);
* **NaN**: the trainer (``nonfinite_action="raise"``) raises
  ``NonFiniteLossError``; the supervisor rewinds to the latest verified
  checkpoint and ``skip_fn`` skips the batches from there through the
  poisoned step (``synapseml_continual_rewinds_total``);
* **preemption / gang resize**: ``EXIT_PREEMPTED`` / ``EXIT_RESIZE``
  exits, or ``Preempted`` / ``GangAborted`` raised in process, are
  expected elastic events and resume on a separate ``max_preempts``
  budget.

In-process mode cannot preempt a hung Python thread: hang detection is
subprocess mode only.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from typing import Callable

from ..core import observability as obs
from ..core.faults import active_fault_plan
from ..core.resilience import RetryPolicy, resilience_measures
from ..models.trainer import NonFiniteLossError
from ..parallel.checkpoint import latest_step, latest_verified_step
from ..parallel.gang import (EXIT_PREEMPTED, EXIT_RESIZE, GangAborted,
                             Preempted)

__all__ = ["TrainSupervisor", "TrainAttempt"]

_SUP_METRICS = obs.HandleCache(lambda reg: {
    "restarts": reg.counter(
        "synapseml_continual_supervisor_restarts_total",
        "supervised training attempts restarted after a crash/hang",
        ("mode",)),
    "rewinds": reg.counter(
        "synapseml_continual_rewinds_total",
        "NaN rewinds: resume from the last verified checkpoint, skip the "
        "poisoned batch window", ()),
})


class TrainAttempt:
    """One supervised attempt's context, handed to the attempt callable.

    * ``index`` — 0 for the first attempt, +1 per restart/rewind;
    * ``resume`` — True when a previous attempt made checkpoint progress
      (the attempt should ``fit_source(resume_from=checkpoint_dir)``);
    * ``skip_fn`` — the accumulated NaN-rewind skip predicate (None when
      no rewind happened); pass it straight to ``fit_source(skip_fn=)``;
    * ``heartbeat(step)`` — call once per optimizer step: feeds the fault
      plane's ``training`` hook (``step:<n>`` targets, so a seeded plan
      can kill the trainer at an exact step) and records progress.
    """

    def __init__(self, supervisor: "TrainSupervisor", index: int,
                 skip_windows: list):
        self.supervisor = supervisor
        self.index = index
        self.skip_windows = list(skip_windows)
        self.resume = index > 0 or supervisor.checkpoint_progress() is not None
        self.last_step: int | None = None

    @property
    def skip_fn(self) -> Callable[[int], bool] | None:
        if not self.skip_windows:
            return None
        windows = tuple(self.skip_windows)

        def skip(batch_index: int) -> bool:
            return any(lo <= batch_index < hi for lo, hi in windows)

        return skip

    def heartbeat(self, step: int) -> None:
        self.last_step = int(step)
        plan = active_fault_plan()
        if plan is not None:
            plan.on_training(f"step:{step}")


class TrainSupervisor:
    """Supervise training attempts against one checkpoint directory.

    ``max_restarts`` bounds crash/hang restarts; ``max_rewinds`` bounds
    NaN rewinds (each rewind widens the skip set — an input stream that is
    ALL poison must eventually surface, not spin). ``retry_policy``
    optionally rate-limits restarts with a shared
    :class:`~synapseml_torch.core.resilience.RetryBudget` and supplies the
    jittered backoff between attempts."""

    def __init__(self, checkpoint_dir: str, max_restarts: int = 3,
                 max_rewinds: int = 2, hang_timeout_s: float = 60.0,
                 poll_s: float = 0.25,
                 retry_policy: RetryPolicy | None = None,
                 max_preempts: int = 16):
        self.checkpoint_dir = str(checkpoint_dir)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.max_restarts = int(max_restarts)
        self.max_rewinds = int(max_rewinds)
        self.max_preempts = int(max_preempts)
        self.hang_timeout_s = float(hang_timeout_s)
        self.poll_s = float(poll_s)
        self.retry_policy = retry_policy or RetryPolicy(
            backoffs_ms=(50, 200, 500))
        self.restarts = 0
        self.rewinds = 0
        self.preempts = 0
        self.skip_windows: list[tuple[int, int]] = []
        self.current_pid: int | None = None  # subprocess mode

    def checkpoint_progress(self) -> int | None:
        """Newest VERIFIED checkpoint step (the resume point)."""
        return latest_verified_step(self.checkpoint_dir)

    def _backoff(self) -> None:
        time.sleep(self.retry_policy.backoff_ms(
            max(self.restarts - 1, 0)) / 1000.0)

    def _on_restart(self, mode: str) -> bool:
        """Account one restart; False when the budget is exhausted."""
        if self.restarts >= self.max_restarts \
                or not self.retry_policy.acquire_retry():
            return False
        self.restarts += 1
        resilience_measures("training").count("retry")
        _SUP_METRICS.get()["restarts"].inc(mode=mode)
        return True

    def _on_preempt(self, mode: str) -> bool:
        """Account one elastic resume (preemption / gang resize) on its own
        budget: an emergency-checkpointed exit is bounded lost work, not a
        crash — it must neither abort the run nor eat the crash budget."""
        if self.preempts >= self.max_preempts:
            return False
        self.preempts += 1
        resilience_measures("training").count("preempt_resume")
        _SUP_METRICS.get()["restarts"].inc(mode=mode)
        return True

    def _on_rewind(self, err: NonFiniteLossError) -> bool:
        """Account one NaN rewind and extend the skip set: the next attempt
        resumes from the latest verified checkpoint and skips every batch
        from there THROUGH the poisoned step."""
        if self.rewinds >= self.max_rewinds:
            return False
        self.rewinds += 1
        _SUP_METRICS.get()["rewinds"].inc()
        lo = self.checkpoint_progress() or 0
        self.skip_windows.append((lo, err.step))
        return True

    # -- in-process mode ----------------------------------------------------
    def run(self, attempt_fn: Callable[[TrainAttempt], object]):
        """Drive ``attempt_fn(attempt)`` to completion. The attempt MUST
        checkpoint into ``checkpoint_dir`` and honor ``attempt.resume`` /
        ``attempt.skip_fn`` (i.e. call ``fit_source(resume_from=
        checkpoint_dir, skip_fn=attempt.skip_fn)``) — that is what makes a
        restart bit-identical to an uninterrupted run. Returns the
        attempt's result; raises the final error when budgets run out."""
        index = 0
        while True:
            attempt = TrainAttempt(self, index, self.skip_windows)
            try:
                plan = active_fault_plan()
                if plan is not None:
                    plan.on_training(f"attempt:{index}")
                return attempt_fn(attempt)
            except NonFiniteLossError as e:
                if not self._on_rewind(e):
                    raise
            except Preempted:
                # an emergency checkpoint COMMITTED — resume the iteration
                # from it instead of aborting the flywheel
                if not self._on_preempt("preempt"):
                    raise
            except GangAborted:
                if not self._on_preempt("resize"):
                    raise
            except Exception:
                if not self._on_restart("inprocess"):
                    raise
                self._backoff()
            index += 1

    # -- subprocess mode ----------------------------------------------------
    def run_subprocess(self, argv: list[str], env: dict | None = None,
                       timeout_s: float = 600.0) -> int:
        """Run ``argv`` as the training process; restart it (bounded) when
        it dies, SIGKILL + restart when it hangs (no new completed
        checkpoint step within ``hang_timeout_s``). The child is expected
        to resume from ``checkpoint_dir`` on its own (``fit_source(
        resume_from=...)``) and exit 0 when the run is complete. Returns
        the number of attempts it took."""
        deadline = time.monotonic() + timeout_s
        attempts = 0
        while True:
            attempts += 1
            proc = subprocess.Popen(argv, env=env)
            self.current_pid = proc.pid
            last_progress = time.monotonic()
            # progress polling uses the DONE-marker scan (latest_step),
            # not the verified scan — re-hashing a multi-GB payload 4x/s
            # for the whole run would be the watchdog DoS'ing the trainer;
            # verification happens once, at restore time
            last_step = latest_step(self.checkpoint_dir)
            hung = False
            while True:
                rc = proc.poll()
                if rc is not None:
                    break
                now = time.monotonic()
                step = latest_step(self.checkpoint_dir)
                if step != last_step:
                    last_step, last_progress = step, now
                if now - last_progress > self.hang_timeout_s:
                    hung = True
                    proc.send_signal(signal.SIGKILL)
                    proc.wait(timeout=30)
                    rc = proc.returncode
                    break
                if now > deadline:
                    proc.send_signal(signal.SIGKILL)
                    proc.wait(timeout=30)
                    raise TimeoutError(
                        f"supervised subprocess run exceeded {timeout_s}s")
                time.sleep(self.poll_s)
            self.current_pid = None
            if rc == 0 and not hung:
                return attempts
            if not hung and rc in (EXIT_PREEMPTED, EXIT_RESIZE):
                # elastic gang exits: the child either committed an
                # emergency checkpoint (preempt) or lost a member (resize)
                # — resume it on the preemption budget, no crash counted
                mode = "preempt" if rc == EXIT_PREEMPTED else "resize"
                if not self._on_preempt(mode):
                    raise RuntimeError(
                        f"supervised trainer preempted {self.preempts} "
                        f"time(s) — preemption budget exhausted")
                continue
            if not self._on_restart("hang" if hung else "subprocess"):
                raise RuntimeError(
                    f"supervised trainer failed after {attempts} attempt(s) "
                    f"(last exit code {rc}"
                    f"{', hang-killed' if hung else ''}) — restart budget "
                    "exhausted")
            self._backoff()
