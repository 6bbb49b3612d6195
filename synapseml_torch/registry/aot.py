"""The deploy plane's AOT contract: manifest section, keys and the fallback.

Counterpart of ``synapseml_tpu/registry/aot.py``. The JAX package publishes
serialized XLA executables beside an artifact's weights and maps them in at
``/admin/load``; its :func:`aot_mechanism` returns ``None`` where the
runtime cannot serialize one, and then a publish records no executables
and every load warms up by JIT (``:106-138`` there). The port always takes
that route: :func:`aot_mechanism` returns ``None``.

Why warmup and not ``torch.export``/AOTInductor: the port's hot path
traces nothing (its stages run eagerly, their callables come through
``CompiledCache``); its kernels are ``nvcc`` builds already cached under
``build/torch_kernels/``; a CUDA graph holds device addresses and cannot
be serialized; and AOTInductor would serve generated kernels in place of
the hand-written ones. So:

* a publish (:func:`capture_stage_ladder`) records no entries, only the
  runtime fingerprint and the warmup drive (rows and buckets);
* a manifest that carries ``aot.entries`` (one the JAX package published)
  is refused by :func:`load_blocker`, logged once by :func:`log_fallback`
  and warmed up by JIT with its recorded rows when the load's body brings
  none, as the JAX package's fallback does: the swap never fails on it;
* :class:`AOTExecutableSet` keeps the JAX class's ordinal binding and
  counters as a ``CompiledCache`` provider tier; every entry it matches is
  an executable it cannot serve (:class:`AOTError`), so it counts an error,
  warns once and the entry is built.

Keys (:func:`aot_key_digest`) and the ``synapseml_deploy_*`` series
(:func:`emit_load_metrics`) are the JAX package's.
"""

from __future__ import annotations

import hashlib
import json
import logging
import platform as _platform
import threading

import torch

from ..core import batching as cb
from ..core import observability as obs
from .store import _canonical_json

__all__ = [
    "AOTError", "AOTExecutableSet",
    "aot_mechanism", "runtime_fingerprint", "fingerprint_mismatch",
    "aot_key_digest", "capture_stage_ladder", "walk_stages",
    "emit_load_metrics", "load_blocker", "log_fallback",
]

logger = logging.getLogger("synapseml_torch.registry.aot")

_NO_MECHANISM = ("no executable-serialization mechanism in this runtime: the "
                 "port serves by warmup (registry/aot.py)")

# deploy-plane warmup observability: the fields of the /admin/load reply's
# breakdown, as synapseml_deploy_* series
_AOT_METRICS = obs.HandleCache(lambda reg: {
    "io_ms": reg.histogram(
        "synapseml_deploy_warmup_io_ms",
        "per-swap wall time spent materializing + deserializing AOT "
        "executable blobs (plus registry resolve I/O)").labels(),
    "compile_ms": reg.histogram(
        "synapseml_deploy_warmup_compile_ms",
        "per-swap wall time spent tracing/compiling during warmup (zero "
        "when the full ladder rode the AOT path)").labels(),
    "aot_hits": reg.counter(
        "synapseml_deploy_aot_hits_total",
        "warmup cache misses served from AOT executable blobs").labels(),
    "aot_misses": reg.counter(
        "synapseml_deploy_aot_misses_total",
        "warmup cache misses with no matching AOT blob (traced "
        "instead)").labels(),
    "loaded": reg.counter(
        "synapseml_deploy_executables_loaded_total",
        "distinct precompiled executables deserialized at load").labels(),
    "traced": reg.counter(
        "synapseml_deploy_executables_traced_total",
        "executables traced+compiled during /admin/load warmup").labels(),
    "fallbacks": reg.counter(
        "synapseml_deploy_aot_fallbacks_total",
        "swaps that fell back to JIT warmup despite the artifact shipping "
        "AOT blobs", ("reason",)),
})


class AOTError(RuntimeError):
    """An AOT executable blob cannot serve the requested call."""


def aot_mechanism() -> str | None:
    """The executable-serialization mechanism of this runtime: always
    ``None`` in the port (no AOT; plain warmup), the JAX package's value
    for a runtime without one."""
    return None


def _platform_name() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def runtime_fingerprint() -> dict:
    """What an executable would be compiled for: platform, torch and CUDA
    versions, the card's name and the Python version."""
    return {
        "platform": _platform_name(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                   else "cpu"),
        "python": _platform.python_version(),
    }


def fingerprint_mismatch(recorded: dict, current: dict | None = None) -> str | None:
    """None when ``recorded`` matches the current runtime, else a readable
    reason (the structured warning's payload)."""
    current = current or runtime_fingerprint()
    for field in current:
        want, got = recorded.get(field), current.get(field)
        if want != got:
            return (f"aot {field} mismatch: artifact compiled for "
                    f"{want!r}, runtime is {got!r}")
    return None


def _jsonable(obj):
    """Canonical JSON-safe form of a cache-key component: tuples and lists
    collapse to lists, scalars stay, anything else stringifies."""
    if isinstance(obj, (tuple, list)):
        return [_jsonable(x) for x in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def aot_key_digest(fn_id: str, shape, dtype) -> str:
    """Stable cross-process digest of the (fn_id, bucket shape, dtype) part
    of a CompiledCache key (the instance token is process-local: entries
    bind by first-seen ordinal instead)."""
    return hashlib.sha256(_canonical_json(
        [fn_id, _jsonable(shape), _jsonable(dtype)])).hexdigest()


def walk_stages(stage):
    """Deterministic pipeline-tree walk (root first, then nested ``stages``
    in order), shared by the autotuner and ``release_executables``."""
    return cb.stage_tree(stage)


def capture_stage_ladder(stage, rows, buckets, loop_cfg: dict, put_blob) -> dict:
    """The manifest's ``aot`` section for a publish. With no mechanism (the
    port, always) no executable is captured: the section records the
    runtime and the warmup drive (``rows`` and ``buckets``) and no
    entries."""
    del stage, loop_cfg, put_blob
    mechanism = aot_mechanism()
    return {
        "mechanism": mechanism,
        "runtime": runtime_fingerprint(),
        "entries": [],
        "skipped": [{"reason": _NO_MECHANISM}],
        "warmup": {"rows": list(rows), "buckets": sorted(int(b) for b in buckets)},
        "total_bytes": 0,
    }


class AOTExecutableSet:
    """A CompiledCache provider tier for one loaded artifact.

    ``lookup`` runs on cache misses: entries match by (fn_id, shape, dtype)
    digest and the instance's first-seen ordinal (bound on the warmup
    thread, frozen after). Every matching entry is an executable this
    runtime cannot serve (no mechanism): it counts an error and demotes to
    a build with one structured warning; the swap proceeds."""

    def __init__(self, aot_section: dict, blob_dir: str):
        self.mechanism = aot_section.get("mechanism")
        self.blob_dir = blob_dir
        self._by_key: dict[tuple, dict] = {}
        for e in aot_section.get("entries", ()):
            self._by_key[(e["key"], int(e["ordinal"]))] = e
        self._ordinals: dict = {}
        self._warned: set = set()
        self._bind_thread: int | None = None
        self._lock = threading.Lock()
        # the /admin/load breakdown's counters
        self.hits = 0          # lookups served from a blob
        self.misses = 0        # lookups with no matching entry
        self.errors = 0        # blobs rejected
        self.loaded = 0        # distinct executables deserialized
        self.io_ms = 0.0       # wall spent reading blobs

    def __len__(self) -> int:
        return len(self._by_key)

    def begin_binding(self) -> None:
        """Open the ordinal-binding window to the current thread (the
        warmup drive); other threads see no entries until :meth:`freeze`."""
        with self._lock:
            self._bind_thread = threading.get_ident()

    def freeze(self) -> None:
        """Close the binding window: known instances keep resolving."""
        with self._lock:
            self._bind_thread = None

    def lookup(self, fn_id: str, instance, shape, dtype):
        with self._lock:
            if self._bind_thread is not None:
                if threading.get_ident() != self._bind_thread:
                    return None
                ordinal = self._ordinals.setdefault(instance, len(self._ordinals))
            else:
                ordinal = self._ordinals.get(instance)
                if ordinal is None:
                    return None
        key = (aot_key_digest(fn_id, shape, dtype), ordinal)
        entry = self._by_key.get(key)
        with self._lock:
            if entry is None:
                self.misses += 1
                return None
            # no mechanism: the blob demotes to a build
            self.errors += 1
            first = key not in self._warned
            self._warned.add(key)
        if first:
            logger.warning(json.dumps({
                "event": "aot_blob_rejected", "fn_id": fn_id,
                "sha256": entry.get("sha256"),
                "error": f"AOTError: cannot serve a "
                         f"{entry.get('mechanism', self.mechanism)!r} executable: "
                         f"{_NO_MECHANISM}",
                "action": "falling back to JIT trace for this entry"}))
        return None

    def report(self) -> dict:
        with self._lock:
            return {"aot_hits": self.hits, "aot_misses": self.misses,
                    "aot_errors": self.errors, "executables_loaded": self.loaded,
                    "io_ms": round(self.io_ms, 2), "entries": len(self._by_key)}


def load_blocker(aot_section: dict) -> str | None:
    """Why this runtime cannot ride the artifact's AOT blobs (None = it
    can): no entries, a mechanism this runtime lacks, or a fingerprint
    mismatch."""
    if not aot_section.get("entries"):
        return "artifact has no aot entries"
    mechanism = aot_section.get("mechanism")
    available = aot_mechanism()
    if mechanism == "xla" and available != "xla":
        return (f"artifact uses the {mechanism!r} mechanism but this "
                f"runtime supports {available!r}")
    if available is None:
        return "this runtime has no executable-serialization support"
    return fingerprint_mismatch(aot_section.get("runtime", {}))


def log_fallback(reason: str, model: str | None = None, version: str | None = None) -> None:
    """One structured warning per fallback decision: a mismatch or a
    missing mechanism demotes to JIT warmup loudly and never fails the
    swap."""
    coarse = ("mismatch" if "mismatch" in reason
              else "disabled" if "disabled" in reason
              else "unsupported")
    _AOT_METRICS.get()["fallbacks"].inc(reason=coarse)
    logger.warning(json.dumps({
        "event": "aot_fallback", "model": model, "version": version,
        "reason": reason, "action": "JIT warmup (swap proceeds)"}))


def emit_load_metrics(breakdown: dict) -> None:
    """Mirror an /admin/load warmup breakdown into the synapseml_deploy_*
    series."""
    m = _AOT_METRICS.get()
    m["io_ms"].observe(float(breakdown.get("io_ms", 0.0)))
    m["compile_ms"].observe(float(breakdown.get("compile_ms", 0.0)))
    for field, handle in (("aot_hits", "aot_hits"),
                          ("aot_misses", "aot_misses"),
                          ("executables_loaded", "loaded"),
                          ("executables_traced", "traced")):
        n = int(breakdown.get(field, 0))
        if n:
            m[handle].inc(n)
