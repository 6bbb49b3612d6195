"""Uniform stage telemetry — the SynapseMLLogging equivalent.

Counterpart of ``synapseml_tpu/core/logging.py``: every fit/transform runs
inside one tracer span, lands in the ``synapseml_stage_duration_ms``
histogram and the ``synapseml_stage_events_total`` counter
(``observability.observe_stage``) and emits one structured JSON log line
(uid, class, feature, method, duration, and a failing verb's error text).
The error text carries the exception's message, which may hold user data,
so every payload goes through :func:`scrub_json` as the JAX package's does:
named secrets, bearer and JWT tokens, emails and runs of 12+ digits are
masked, and each mask counts into ``synapseml_scrub_fields_total{kind}``.
The patterns are the JAX package's. The telemetry sinks
(``add_telemetry_sink``) come with ROADMAP.md queue A item 12.
"""

from __future__ import annotations

import json
import logging
import re
import time

from . import observability as obs

logger = logging.getLogger("synapseml_torch")

_SECRET_WORDS = r"(?:sig|key|token|secret|password|authorization|api[-_]?key)"
_SECRET_PAT = re.compile(rf"(?i){_SECRET_WORDS}=[^&\s\"]+")
# a quoted key containing a secret word, then a quoted string or bare scalar
_JSON_SECRET_PAT = re.compile(
    rf"(?i)(\"[^\"]*{_SECRET_WORDS}[^\"]*\"\s*:\s*)(\"(?:[^\"\\]|\\.)*\"|[^,}}\]\s]+)")
_BEARER_PAT = re.compile(r"(?i)bearer\s+[a-z0-9\-_\.=]+")
# free-text PII: emails, bearer-less JWTs, 12+ digit runs (card, account and
# phone numbers; epoch milliseconds scrub too, visibly in the counter)
_EMAIL_PAT = re.compile(r"[\w.+%-]+@[\w-]+\.[\w.-]{2,}")
_JWT_PAT = re.compile(r"eyJ[A-Za-z0-9_-]{6,}\.[A-Za-z0-9_-]{4,}"
                      r"\.[A-Za-z0-9_-]*")
_DIGITS_PAT = re.compile(r"\d(?:[ \-]?\d){11,}")
_SECRET_KEY_PAT = re.compile(rf"(?i){_SECRET_WORDS}")


def _count_scrubs(counts: dict[str, int]) -> None:
    """Publish per-kind substitution counts as
    ``synapseml_scrub_fields_total{kind}``."""
    if not counts:
        return
    try:
        counter = obs.get_registry().counter(
            "synapseml_scrub_fields_total",
            "fields masked by the log scrubber, by pattern kind", ("kind",))
        for kind, n in counts.items():
            counter.inc(n, kind=kind)
    except Exception:  # noqa: BLE001 - scrubbing must never fail a log call
        logger.debug("scrub counter emission failed", exc_info=True)


def scrub(text: str, counts: dict[str, int] | None = None) -> str:
    """Mask secrets and free-text PII in ``text``: query-string pairs
    (``sig=...``), JSON pairs (``"apiKey": "..."``), bearer tokens, JWTs,
    emails and long digit runs. Every substitution counts into
    ``synapseml_scrub_fields_total{kind}``; ``counts`` (mutated in place)
    also receives the per-kind tally."""
    tally: dict[str, int] = {}

    def _sub(kind: str, pat: re.Pattern, repl, s: str) -> str:
        out, n = pat.subn(repl, s)
        if n:
            tally[kind] = tally.get(kind, 0) + n
        return out

    text = _sub("keyvalue", _SECRET_PAT,
                lambda m: m.group(0).split("=", 1)[0] + "=####", text)
    text = _sub("json", _JSON_SECRET_PAT,
                lambda m: m.group(1) + '"####"', text)
    text = _sub("bearer", _BEARER_PAT, "Bearer ####", text)
    text = _sub("jwt", _JWT_PAT, "####", text)
    text = _sub("email", _EMAIL_PAT, "####@####", text)
    text = _sub("digits", _DIGITS_PAT, "####", text)
    _count_scrubs(tally)
    if counts is not None:
        for kind, n in tally.items():
            counts[kind] = counts.get(kind, 0) + n
    return text


def _tally_one(kind: str, counts: dict[str, int] | None) -> None:
    if counts is not None:
        counts[kind] = counts.get(kind, 0) + 1
    _count_scrubs({kind: 1})


def scrub_json(value, counts: dict[str, int] | None = None):
    """Scrub a decoded JSON value in structure: a secret-worded dict key
    masks its scalar value, strings go through :func:`scrub`, and integers
    of 12+ digits become ``"####"``. The result is JSON-serializable."""
    if isinstance(value, str):
        return scrub(value, counts)
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, int) and len(str(abs(value))) >= 12:
        _tally_one("digits", counts)
        return "####"
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if isinstance(k, str) and _SECRET_KEY_PAT.search(k) \
                    and isinstance(v, (str, int, float)) and not isinstance(v, bool):
                _tally_one("json", counts)
                out[k] = "####"
            else:
                out[k] = scrub_json(v, counts)
        return out
    if isinstance(value, (list, tuple)):
        return [scrub_json(v, counts) for v in value]
    return value


def log_stage_event(payload: dict) -> None:
    """Log one stage event: objects stringified, then scrubbed in structure,
    so the masked line is valid JSON."""
    normalized = json.loads(json.dumps(payload, default=str))
    logger.info(json.dumps(scrub_json(normalized)))


class StageTelemetry:
    """Mixin providing the ``log_verb`` wrapper of fit/transform."""

    feature_name: str = "core"

    def _emit(self, method: str, duration_ms: float,
              error: BaseException | None = None) -> None:
        payload = {
            "uid": getattr(self, "uid", "?"),
            "className": type(self).__name__,
            "featureName": self.feature_name,
            "method": method,
            "durationMs": round(duration_ms, 3),
        }
        if error is not None:
            payload["error"] = f"{type(error).__name__}: {error}"
        log_stage_event(payload)

    def log_verb(self, method: str, fn, *args, **kwargs):
        cls = type(self).__name__
        t0 = time.perf_counter()
        with obs.get_tracer().span(f"{cls}.{method}",
                                   {"uid": getattr(self, "uid", "?"),
                                    "featureName": self.feature_name}):
            try:
                out = fn(*args, **kwargs)
            except BaseException as e:
                dt = (time.perf_counter() - t0) * 1e3
                obs.observe_stage(cls, method, dt, error=True)
                self._emit(method, dt, error=e)
                raise
        dt = (time.perf_counter() - t0) * 1e3
        obs.observe_stage(cls, method, dt)
        self._emit(method, dt)
        return out
