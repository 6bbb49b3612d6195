"""Uniform stage telemetry — the SynapseMLLogging equivalent.

Counterpart of ``StageTelemetry`` in ``synapseml_tpu/core/logging.py``:
every fit/transform runs inside one tracer span, lands in the
``synapseml_stage_duration_ms`` histogram and the
``synapseml_stage_events_total`` counter (``observability.observe_stage``)
and emits one structured JSON log line (uid, class, feature, method,
duration). The payload carries
no user data, so it needs none of the JAX package's scrubbers; those and
the telemetry sinks come with the port of the services plane.
"""

from __future__ import annotations

import json
import logging
import time

from . import observability as obs

logger = logging.getLogger("synapseml_torch")


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
        logger.info(json.dumps(payload, default=str))

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
