"""Publish-time backend autotuning: pin each artifact's fastest kernels.

Counterpart of ``synapseml_tpu/registry/autotune.py``: any stage class
declaring ``_AUTOTUNE_PARAMS = {"param": (candidates...)}`` gets each
candidate timed through the serve-loop warmup drive
(``io.serving.run_warmup``) at every bucket rung (one untimed warm pass,
then min of ``trials``), and the winner per platform lands in the
manifest's ``autotune`` section; ``/admin/load`` pins it again with
:func:`apply_autotune` before its warmup. ``DeepTextModel`` declares its
einsum/flash pair, so on the card the search times the flash kernel
against the einsum attention. ``winners`` overrides (a decision bench's
verdict) are recorded as given. Winners apply only on the platform they
were measured on (``"cuda"`` or ``"cpu"``, ``aot.runtime_fingerprint``):
a manifest tuned elsewhere keeps the stage's saved defaults.

On the card the hand-written kernels are the served path: a stage names
the candidate that is a kernel's plain PyTorch version in
``_AUTOTUNE_PLAIN``, and there that candidate is timed as the baseline
(the section's ``baseline``) but never pinned, and a candidate that fails
to build or launch fails the search instead of losing it.
"""

from __future__ import annotations

import logging
import time

from ..core.params import Param
from .aot import _platform_name, walk_stages

__all__ = ["autotune_stage", "apply_autotune", "tunable_params"]

logger = logging.getLogger("synapseml_torch.registry.autotune")


def tunable_params(stage) -> list[tuple]:
    """``(stage_obj, param_name, candidates)`` for every tunable the
    pipeline tree declares via ``_AUTOTUNE_PARAMS``."""
    out = []
    for st in walk_stages(stage):
        declared = getattr(type(st), "_AUTOTUNE_PARAMS", None)
        if not declared:
            continue
        for param, candidates in declared.items():
            if isinstance(getattr(type(st), param, None), Param):
                out.append((st, param, tuple(candidates)))
    return out


def _time_rung(stage, rows, rung, loop_cfg, trials: int) -> float:
    """min-of-``trials`` wall for one warmup drive at one rung, after one
    untimed warm pass (the first call builds the module and its
    callables; kernel choice is about steady-state serving).
    Rows are cycled to EXACTLY the rung size so the drive transforms one
    rung-sized batch and nothing else — ``run_warmup`` would otherwise
    union a second ``len(rows)``-sized batch into every timing."""
    from ..io.serving import run_warmup

    bodies = [rows[i % len(rows)] for i in range(int(rung))]
    run_warmup(stage, bodies, [rung], loop_cfg)
    best = float("inf")
    for _ in range(max(trials, 1)):
        t0 = time.perf_counter()
        run_warmup(stage, bodies, [rung], loop_cfg)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def autotune_stage(stage, rows, buckets, loop_cfg: dict,
                   trials: int = 2, winners: dict | None = None,
                   platform: str | None = None) -> dict | None:
    """Search every declared tunable over ``buckets`` and mutate ``stage``
    to the winners. Returns the manifest ``autotune`` section, or None when
    there is nothing to record. Off the card, candidates that fail to run
    are skipped with their error recorded — a broken backend can never
    win; on the card the failure is raised and a plain candidate never
    wins (module docstring)."""
    from ..core import batching as cb

    if platform is None:
        platform = _platform_name()
    tunables = tunable_params(stage) if rows else []
    if not tunables and not winners:
        return None
    section = {"platform": platform, "winners": dict(winners or {}),
               "per_rung": {}, "timings_ms": {}, "errors": {}}
    rungs = sorted({int(b) for b in buckets}) or [1]
    on_card = platform == "cuda"
    for st, param, candidates in tunables:
        original = st.get(param)
        plain = (getattr(type(st), "_AUTOTUNE_PLAIN", {}).get(param)
                 if on_card else None)
        timings: dict[str, dict] = {}
        errors: dict[str, str] = {}
        for cand in candidates:
            st.set(**{param: cand})
            cb.invalidate_token(st)
            per_rung = {}
            try:
                for rung in rungs:
                    per_rung[str(rung)] = round(
                        _time_rung(stage, rows, rung, loop_cfg, trials), 3)
            except Exception as e:  # noqa: BLE001 - a broken backend loses
                if on_card:
                    st.set(**{param: original})
                    cb.invalidate_token(st)
                    raise
                errors[str(cand)] = f"{type(e).__name__}: {e}"
                continue
            timings[str(cand)] = per_rung
        if not timings:
            # every candidate failed: restore the stage's original value —
            # the AOT capture that follows must not compile (and the
            # manifest must not omit) a backend the search left behind
            st.set(**{param: original})
            cb.invalidate_token(st)
            section["errors"][param] = errors
            continue
        # winner per rung, overall = lowest summed wall across the ladder;
        # on the card the plain version is only the baseline
        eligible = [c for c in timings if c != plain] or list(timings)
        per_rung_winners = {
            str(r): min(eligible, key=lambda c: timings[c][str(r)])
            for r in rungs}
        winner = min(eligible, key=lambda c: sum(timings[c].values()))
        st.set(**{param: winner})
        cb.invalidate_token(st)
        section["winners"][param] = winner
        section["per_rung"][param] = per_rung_winners
        section["timings_ms"][param] = timings
        if plain in timings:
            section.setdefault("baseline", {})[param] = plain
        if errors:
            section["errors"][param] = errors
    if not section["winners"]:
        return None
    if not section["errors"]:
        del section["errors"]
    return section


def apply_autotune(stage, section: dict,
                   platform: str | None = None) -> list[dict]:
    """Pin a manifest's autotuned winners onto a freshly loaded stage tree
    (called by ``/admin/load`` before warmup/AOT binding). Only applies on
    the platform the search ran on; returns the list of applied changes."""
    if platform is None:
        platform = _platform_name()
    if not section or section.get("platform") != platform:
        return []
    from ..core import batching as cb

    applied = []
    winners = section.get("winners") or {}
    for st in walk_stages(stage):
        for param, winner in winners.items():
            if not isinstance(getattr(type(st), param, None), Param):
                continue
            before = st.get(param)
            if before == winner:
                continue
            st.set(**{param: winner})
            cb.invalidate_token(st)
            applied.append({"stage": type(st).__name__, "param": param,
                            "from": before, "to": winner})
    return applied
