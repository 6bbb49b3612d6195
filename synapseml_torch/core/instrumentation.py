"""Per-phase instrumentation measures.

Counterpart of ``InstrumentationMeasures`` in
``synapseml_tpu/core/instrumentation.py`` (reference
``lightgbm/.../LightGBMPerformance.scala``: ``TaskInstrumentationMeasures``
mark dataset-prep/training windows and travel back with results). One
collector serves every engine: estimators thread it through fit and attach
``.to_dict()`` to the trained model. The JAX package's ``profile_trace``
wraps ``jax.profiler``; here ``torch.profiler`` is used directly.

``chip_peak_tflops`` is the counterpart of the JAX package's table of the
same name (``:29``): the card's dense bf16 peak, named by
``torch.cuda.get_device_name``, for MFU reporting.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator

__all__ = ["InstrumentationMeasures", "chip_peak_tflops"]

# Dense bf16 tensor-core peak in TFLOP/s by card name (lower-cased
# substring), from NVIDIA's H100 data sheet: the SXM part at its 700 W
# limit. A card not listed has no MFU.
_CHIP_PEAK_TFLOPS = [("h100 80gb hbm3", 989.0), ("h100 sxm", 989.0)]


def chip_peak_tflops(device_name: str) -> float | None:
    name = (device_name or "").lower()
    for key, peak in _CHIP_PEAK_TFLOPS:
        if key in name:
            return peak
    return None


class InstrumentationMeasures:
    """Named wall-clock phase windows + point marks + counters.

    ``measure(name)`` windows accumulate across repeated entries (loop
    phases); ``count(name)`` tallies events; everything exports as one flat
    dict of ``*_ms`` / ``*_count`` / mark timestamps.
    """

    def __init__(self):
        self._t0 = time.perf_counter()
        self._phases: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._marks: dict[str, float] = {}
        # one lock guards phases, marks and counts: collectors are shared
        # between threads
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed_ms = (time.perf_counter() - start) * 1e3
            with self._lock:
                self._phases[name] = self._phases.get(name, 0.0) + elapsed_ms

    def mark(self, name: str) -> None:
        at_ms = (time.perf_counter() - self._t0) * 1e3
        with self._lock:
            self._marks[name] = at_ms

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def phase_ms(self, name: str) -> float:
        with self._lock:
            return self._phases.get(name, 0.0)

    def to_dict(self) -> dict:
        with self._lock:  # snapshot under the lock: an export never tears
            phases = dict(self._phases)
            counts = dict(self._counts)
            marks = dict(self._marks)
        out = {f"{k}_ms": round(v, 3) for k, v in phases.items()}
        out.update({f"{k}_count": v for k, v in counts.items()})
        out.update({f"{k}_at_ms": round(v, 3) for k, v in marks.items()})
        out["total_ms"] = round((time.perf_counter() - self._t0) * 1e3, 3)
        return out
