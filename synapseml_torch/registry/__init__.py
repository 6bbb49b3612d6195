"""Model registry: the artifact store, versioned publish/resolve, and the
deploy plane's warmup-only AOT contract, autotuning and canary rollout.

Counterpart of ``synapseml_tpu/registry/``: ``store`` (content-addressed
blobs, signed manifests, alias pointers), ``registry`` (publish, resolve,
pin), ``aot`` (the manifest's ``aot`` section and its fallback: the port
records no executables and warms up at load, so it has no ``AOTCapture``),
``autotune`` (the publish-time backend search) and ``deploy`` (canary
rollout over the routing front: ``Deployment``, ``CanaryController``,
``admin_load``).
"""

from .store import (ArtifactStore, IntegrityError, atomic_write_bytes,
                    sha256_file, write_stream_verified)
from .registry import (ModelRegistry, PublishedVersion, RegistryReadOnlyError,
                       ResolvedModel, param_schema_hash)
from .aot import AOTExecutableSet, aot_mechanism, runtime_fingerprint
from .autotune import apply_autotune, autotune_stage
from .deploy import CanaryController, Deployment, admin_load

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
    "Deployment",
    "CanaryController",
    "admin_load",
]
