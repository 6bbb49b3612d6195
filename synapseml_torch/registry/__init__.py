"""Model registry: the artifact store, versioned publish/resolve, and the
deploy plane's warmup-only AOT contract and autotuning.

Counterpart of ``synapseml_tpu/registry/``: ``store`` (content-addressed
blobs, signed manifests, alias pointers), ``registry`` (publish, resolve,
pin), ``aot`` (the manifest's ``aot`` section and its fallback: the port
records no executables and warms up at load, so it has no ``AOTCapture``)
and ``autotune`` (the publish-time backend search). Canary rollout
(``deploy``: ``Deployment``, ``CanaryController``, ``admin_load``) waits
for ROADMAP.md queue A item 10's second half.
"""

from .store import (ArtifactStore, IntegrityError, atomic_write_bytes,
                    sha256_file, write_stream_verified)
from .registry import (ModelRegistry, PublishedVersion, RegistryReadOnlyError,
                       ResolvedModel, param_schema_hash)
from .aot import AOTExecutableSet, aot_mechanism, runtime_fingerprint
from .autotune import apply_autotune, autotune_stage

__all__ = [
    "ArtifactStore",
    "IntegrityError",
    "ModelRegistry",
    "PublishedVersion",
    "ResolvedModel",
    "RegistryReadOnlyError",
    "param_schema_hash",
    "sha256_file",
    "atomic_write_bytes",
    "write_stream_verified",
    "AOTExecutableSet",
    "aot_mechanism",
    "runtime_fingerprint",
    "autotune_stage",
    "apply_autotune",
]
