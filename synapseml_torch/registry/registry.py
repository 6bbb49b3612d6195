"""Model registry: versioned publish / resolve / pin over the artifact store.

Counterpart of ``synapseml_tpu/registry/registry.py``. ``publish()`` saves
any fitted stage with ``core.serialization.save_stage``, stores every file
as a content-addressed blob and writes a signed manifest: the stage list,
a param-schema hash computed from the saved artifact, the framework
versions (Python, numpy, torch, CUDA and the card where the JAX package
records jax), a metrics snapshot, and the optional ``autotune``, ``aot``
and ``sharding`` sections. ``resolve()`` materializes, verifies and
``load_stage``s a version or an alias (``latest``, ``prod``, ``canary``:
atomically swapped pointer files). A remote registry (``http(s)://``, any
static file server rooted at the store) is read-only.

``aot`` takes the warmup route (``registry/aot.py``): the publish reloads
the saved artifact, runs the autotune search when asked, and records the
warmup drive in the manifest but no executables. ``sharding`` goes through
``parallel/partition.py`` (``sharding_manifest_section`` at publish,
``apply_manifest_sharding`` at ``/admin/load``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import tempfile
import time
import urllib.error
import urllib.request

from ..core import serialization
from .store import (ArtifactStore, IntegrityError, _canonical_json,
                    _safe_component, _version_sort_key, write_stream_verified)

__all__ = ["ModelRegistry", "ResolvedModel", "PublishedVersion",
           "RegistryReadOnlyError", "param_schema_hash"]


class RegistryReadOnlyError(RuntimeError):
    """A write operation (publish/pin) was attempted on a remote registry."""


@dataclasses.dataclass(frozen=True)
class PublishedVersion:
    name: str
    version: str
    manifest: dict
    manifest_path: str


@dataclasses.dataclass(frozen=True)
class ResolvedModel:
    stage: object
    name: str
    version: str
    manifest: dict
    path: str  # materialized stage directory


def param_schema_hash(stage_dir: str) -> str:
    """sha256 over the artifact's param schema: every ``metadata.json`` in
    the saved tree contributes (class, sorted simple-param names, sorted
    complex-param names + kinds). Two artifacts with the same hash are
    loadable by the same code; a serialization-format change flips it —
    the drift guard ``tests/test_serialization_roundtrip.py`` asserts the
    hash is stable across a save -> load -> save round trip."""
    entries = []
    for dirpath, _dirs, files in os.walk(stage_dir):
        if "metadata.json" not in files:
            continue
        with open(os.path.join(dirpath, "metadata.json")) as f:
            meta = json.load(f)
        rel = os.path.relpath(dirpath, stage_dir).replace(os.sep, "/")
        entries.append({
            "at": "" if rel == "." else rel,
            "class": meta.get("class", ""),
            "params": sorted(meta.get("params", {})),
            "complex": sorted((name, entry.get("kind", ""))
                              for name, entry in
                              meta.get("complexParams", {}).items()),
        })
    entries.sort(key=lambda e: e["at"])
    return hashlib.sha256(_canonical_json(entries)).hexdigest()


def _framework_versions() -> dict:
    import numpy
    import torch

    return {"python": platform.python_version(), "numpy": numpy.__version__,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device": (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                       else "cpu")}


class ModelRegistry:
    """Publish/resolve/pin pipeline versions against a local store directory
    or a read-only remote (``http(s)://``) registry.

    ``cache_dir`` is where resolved versions materialize (default:
    ``<root>/.cache`` locally, a per-user dir for remotes). A version is
    materialized once — the ``.complete`` marker makes re-resolution a pure
    ``load_stage``.
    """

    def __init__(self, root: str, cache_dir: str | None = None,
                 timeout_s: float = 10.0):
        self.root = root.rstrip("/") if root.startswith(("http://", "https://")) \
            else os.path.abspath(root)
        self.is_remote = self.root.startswith(("http://", "https://"))
        self.timeout_s = timeout_s
        self._store = None if self.is_remote else ArtifactStore(self.root)
        if cache_dir is None:
            if self.is_remote:
                digest = hashlib.sha256(self.root.encode()).hexdigest()[:16]
                cache_dir = os.path.join(
                    tempfile.gettempdir(),
                    f"synapseml_registry_cache_{digest}")
            else:
                cache_dir = os.path.join(self.root, ".cache")
        self.cache_dir = cache_dir

    # -- remote plumbing (plain files over HTTP) --
    def _open_remote(self, rel: str):
        url = f"{self.root}/{rel}"
        try:
            return urllib.request.urlopen(url, timeout=self.timeout_s)
        except urllib.error.HTTPError as e:
            raise RuntimeError(f"registry server returned {e.code} for "
                               f"{url!r}: {e.reason}") from e
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise RuntimeError(
                f"registry unreachable at {url!r}: {e}. On zero-egress "
                "hosts point ModelRegistry at a local store directory "
                "instead.") from e

    def _read_remote(self, rel: str) -> bytes:
        with self._open_remote(rel) as r:
            return r.read()

    def _require_local(self, op: str) -> ArtifactStore:
        if self._store is None:
            raise RegistryReadOnlyError(
                f"{op}() needs a local registry; {self.root!r} is remote "
                "(read-only)")
        return self._store

    # -- listing / refs ----------------------------------------------------
    def list_versions(self, name: str) -> list[str]:
        if self._store is not None:
            return self._store.list_versions(name)
        try:
            index = json.loads(self._read_remote(
                f"manifests/{_safe_component(name)}/index.json"))
        except RuntimeError:
            return []
        return sorted((str(v) for v in index), key=_version_sort_key)

    def aliases(self, name: str) -> dict[str, str]:
        if self._store is not None:
            return self._store.list_aliases(name)
        # the remote protocol has no directory listing for aliases; probe
        # the conventional set (the deployment plane only moves these)
        out = {}
        for alias in ("latest", "prod", "canary"):
            target = self.alias_target(name, alias)
            if target:
                out[alias] = target
        return out

    def alias_target(self, name: str, alias: str) -> str | None:
        if self._store is not None:
            return self._store.read_alias(name, alias)
        try:
            return self._read_remote(
                f"aliases/{_safe_component(name)}/"
                f"{_safe_component(alias)}").decode().strip() or None
        except RuntimeError:
            return None

    def resolve_ref(self, name: str, ref: str) -> str:
        """A concrete version for ``ref`` (version string or alias)."""
        versions = self.list_versions(name)
        if ref in versions:
            return ref
        target = self.alias_target(name, ref)
        if target is not None:
            if target not in versions:
                raise KeyError(
                    f"alias {name}:{ref} points at missing version "
                    f"{target!r}")
            return target
        raise KeyError(f"{name}:{ref} is neither a version nor an alias "
                       f"(versions: {versions or 'none'})")

    def next_version(self, name: str) -> str:
        nums = [int(v[1:]) for v in self.list_versions(name)
                if v.startswith("v") and v[1:].isdigit()]
        return f"v{max(nums, default=0) + 1}"

    def manifest(self, name: str, ref: str = "latest") -> dict:
        return self._manifest_for_version(name, self.resolve_ref(name, ref))

    def _manifest_for_version(self, name: str, version: str) -> dict:
        """Manifest for an already-concrete version (no re-resolution — a
        remote resolve must not pay a second index.json round trip)."""
        if self._store is not None:
            return self._store.read_manifest(name, version)
        return json.loads(self._read_remote(
            f"manifests/{_safe_component(name)}/"
            f"{_safe_component(version)}.json"))

    # -- publish -----------------------------------------------------------
    def publish(self, name: str, stage, version: str | None = None,
                metrics: dict | None = None, extra: dict | None = None,
                set_latest: bool = True, aot: dict | None = None,
                autotune: dict | None = None,
                sharding=None, extra_tree: str | None = None) -> PublishedVersion:
        """Save ``stage``, blobify its tree, and write the signed manifest.
        ``version`` defaults to the next ``v<N>``; ``metrics`` is the
        caller's evaluation snapshot at publish time (what the deployment
        plane compares a canary against). ``extra_tree`` names a directory
        whose contents are merged into the artifact tree before blobify —
        sidecar data (e.g. retrieval index shards) that must version, GC
        and materialize with the stage.

        ``aot`` turns on publish-time AOT compilation of the serve ladder
        (``registry/aot.py``): ``{"rows": [<sample request bodies>],
        "buckets": [...], "input_col": ..., "parse_json": ...}``. The
        port has no executable-serialization mechanism, so the section
        records the runtime fingerprint and the warmup drive (rows and
        buckets, which ``/admin/load`` by registry replays) and no
        entries. ``buckets`` defaults to the process-wide ladder. ``autotune`` (same ``rows``-driven harness,
        plus optional ``{"winners": {...}}`` overrides from the decision
        benches) searches any stage-declared ``_AUTOTUNE_PARAMS`` backend
        candidates and pins the fastest per platform into the manifest.

        ``sharding`` records the declarative sharding plane in the
        manifest: a ``parallel.partition.PartitionRules`` (its ``mesh``
        field names the target topology), a prebuilt section dict, or
        ``"auto"`` to lift the stage's own ``partition_rules``/
        ``mesh_config`` params. ``/admin/load`` re-applies the section
        BEFORE warmup — a loading host whose devices cannot build the
        recorded mesh demotes to a replicated load with one structured
        warning instead of a failed swap."""
        store = self._require_local("publish")
        _safe_component(name)
        version = _safe_component(version or self.next_version(name))
        if version in self.list_versions(name):
            raise FileExistsError(
                f"{name}:{version} already published (versions are "
                "immutable; pick a new version or alias)")
        aot_section = tune_section = None
        with tempfile.TemporaryDirectory(prefix="synapseml_publish_") as tmp:
            stage_dir = os.path.join(tmp, "stage")
            serialization.save_stage(stage, stage_dir)
            if extra_tree is not None:
                # sidecar data riding the artifact (retrieval index shards):
                # merged into the stage tree BEFORE ingest, so the files are
                # content-addressed blobs on the manifest ``files`` list —
                # deduped across versions, GC-protected, materialized under
                # ``resolve().path`` like any other artifact byte
                import shutil

                shutil.copytree(extra_tree, stage_dir, dirs_exist_ok=True)
            files = store.ingest_tree(stage_dir)
            stages = _stage_classes(stage_dir)
            schema_hash = param_schema_hash(stage_dir)
            if aot is not None or autotune is not None:
                aot_section, tune_section = self._publish_compile(
                    stage_dir, store, aot, autotune)
        manifest = {
            "name": name,
            "version": version,
            "created_at_unix": time.time(),
            "stages": stages,
            "param_schema_sha256": schema_hash,
            "framework": _framework_versions(),
            "metrics": dict(metrics or {}),
            "files": files,
            "total_bytes": sum(e["bytes"] for e in files),
        }
        if aot_section is not None:
            manifest["aot"] = aot_section
        if tune_section is not None:
            manifest["autotune"] = tune_section
        shard_section = self._sharding_section(stage, sharding)
        if shard_section is not None:
            manifest["sharding"] = shard_section
        if extra:
            manifest["extra"] = dict(extra)
        path = store.write_manifest(name, version, manifest)
        if set_latest:
            store.write_alias(name, "latest", version)
        return PublishedVersion(name, version, manifest, path)

    def _sharding_section(self, stage, sharding) -> dict | None:
        """Build the manifest's ``sharding`` section. Accepts a
        ``PartitionRules``, a prebuilt section dict (``{"rules": ...}``),
        or ``"auto"`` (lift the stage's own ``partition_rules`` +
        ``mesh_config`` params — the publish path for a stage already
        configured for sharded serving). Per-leaf spec digests are added
        when the stage exposes a ``model_params`` pytree."""
        if sharding is None:
            return None
        from ..parallel import partition as pp
        from ..parallel.mesh import MeshConfig

        if isinstance(sharding, dict) and "rules" in sharding:
            return dict(sharding)
        target = pp.sharding_target(stage)
        if sharding == "auto":
            if target is None:
                raise ValueError(
                    f"publish(sharding='auto'): stage "
                    f"{type(stage).__name__} has no partition_rules/"
                    "mesh_config params to lift (nested stages searched)")
            mesh_cfg = target.get("mesh_config")
            rules = target.get("partition_rules") \
                or pp.default_llama_rules(mesh=mesh_cfg)
            if mesh_cfg is None:
                raise ValueError(
                    "publish(sharding='auto'): stage has no mesh_config "
                    "set — there is no topology to record")
            if rules.mesh is None:
                import dataclasses as dc

                rules = dc.replace(rules, mesh=mesh_cfg)
            sharding = rules
        if not isinstance(sharding, pp.PartitionRules):
            raise TypeError(
                f"sharding must be a PartitionRules, a section dict or "
                f"'auto', got {type(sharding).__name__}")
        if sharding.mesh is None:
            raise ValueError(
                "publish(sharding=...): the rule table must carry its "
                "target mesh (PartitionRules(mesh=MeshConfig(...))) so "
                "/admin/load can rebuild the topology")
        assert isinstance(sharding.mesh, MeshConfig)
        params = None
        if target is not None and callable(getattr(target, "has_param",
                                                   None)) \
                and target.has_param("model_params"):
            params = target.get("model_params")
        return pp.sharding_manifest_section(sharding, params)

    def _publish_compile(self, stage_dir: str, store: ArtifactStore,
                         aot: dict | None, autotune: dict | None):
        """The offline pass: reload the just-saved artifact (fresh
        instances, what a worker will load), autotune backends first, then
        record the ladder's ``aot`` section."""
        from ..core import batching as cb
        from . import aot as raot

        spec = dict(aot or {})
        rows = spec.get("rows") or (autotune or {}).get("rows")
        if not rows and aot is not None:
            raise ValueError(
                "publish(aot=...) needs sample request rows to drive the "
                "ladder: aot={'rows': [<request bodies>], ...}")
        loop_cfg = {"parse_json": spec.get("parse_json", True),
                    "input_col": spec.get("input_col", "body")}
        buckets = spec.get("buckets")
        if buckets is None:
            buckets = cb.default_bucketer().buckets_upto(
                int(spec.get("max_rows", cb.default_bucketer().max_bucket)))
        loaded = serialization.load_stage(stage_dir)
        tune_section = None
        if autotune is not None:
            from .autotune import autotune_stage

            tune_section = autotune_stage(
                loaded, rows or [], buckets, loop_cfg,
                trials=int(autotune.get("trials", 2)),
                winners=autotune.get("winners"))
            # the search drove the loaded copy through the process cache:
            # release its callables, which would pin its weights otherwise
            cb.release_executables(loaded)
        aot_section = None
        if aot is not None:
            aot_section = raot.capture_stage_ladder(
                loaded, rows, buckets, loop_cfg, store.put_blob_bytes)
        return aot_section, tune_section

    # -- resolve -----------------------------------------------------------
    def resolve(self, name: str, ref: str = "latest") -> ResolvedModel:
        """Materialize + integrity-verify + ``load_stage`` one version."""
        version = self.resolve_ref(name, ref)
        manifest = self._manifest_for_version(name, version)
        dest = os.path.join(self.cache_dir, _safe_component(name),
                            _safe_component(version))
        marker = os.path.join(dest, ".complete")
        if not os.path.isfile(marker):
            # serialize materialization per version: two workers resolving
            # the same version concurrently (a fleet-wide hot swap) must not
            # race the build-then-rename
            import fcntl

            os.makedirs(dest, exist_ok=True)
            with open(os.path.join(dest, ".lock"), "w") as lockf:
                fcntl.flock(lockf, fcntl.LOCK_EX)
                if not os.path.isfile(marker):
                    self._materialize(name, version, manifest, dest)
                    with open(marker, "w") as f:
                        f.write(version)
        else:
            # marker present: the stage tree is complete, but AOT blobs
            # that failed a transient fetch self-heal here (cheap isfile
            # scan when everything is already on disk)
            self._ensure_aot_blobs(manifest, dest)
        stage = serialization.load_stage(os.path.join(dest, "stage"))
        return ResolvedModel(stage=stage, name=name, version=version,
                             manifest=manifest,
                             path=os.path.join(dest, "stage"))

    def _materialize(self, name: str, version: str, manifest: dict,
                     dest: str) -> None:
        cache_store = ArtifactStore(self.cache_dir) if self.is_remote \
            else self._store

        def fetch(digest: str, path: str) -> None:
            # remote blobs mirror into the cache's blob dir first, so a
            # version re-resolve and shared blobs across versions hit the
            # network once
            if not cache_store.has_blob(digest):
                blob = cache_store.blob_path(digest)
                os.makedirs(os.path.dirname(blob), exist_ok=True)
                with self._open_remote(f"blobs/{digest}") as r:
                    write_stream_verified(r, blob, digest)
            cache_store.materialize_blob(digest, path)

        stage_root = os.path.join(dest, "stage")
        cache_store.materialize_tree(
            manifest["files"], stage_root,
            fetch=fetch if self.is_remote else None)
        self._ensure_aot_blobs(manifest, dest)
        got = param_schema_hash(stage_root)
        want = manifest.get("param_schema_sha256")
        if want and got != want:
            raise IntegrityError(
                f"{name}:{version} param schema hash mismatch: manifest "
                f"{want}, materialized {got} — artifact and manifest "
                "disagree")

    def _ensure_aot_blobs(self, manifest: dict, dest: str) -> None:
        """Materialize the manifest's AOT executable blobs into
        ``dest/aot/<sha256>``. Idempotent and SELF-HEALING: called on every
        resolve (cheap ``isfile`` checks once present), so a transient
        fetch failure is retried next resolve instead of becoming a
        permanent per-worker JIT fallback behind the ``.complete`` marker.
        A still-missing blob is skipped, never fatal — the load path
        demotes that entry to tracing."""
        entries = (manifest.get("aot") or {}).get("entries", ())
        if not entries:
            return
        cache_store = ArtifactStore(self.cache_dir) if self.is_remote \
            else self._store
        for entry in entries:
            digest = entry.get("sha256")
            if not digest:
                continue
            blob_dest = os.path.join(dest, "aot", digest)
            if os.path.isfile(blob_dest):
                continue
            try:
                if self.is_remote:
                    blob = cache_store.blob_path(digest)
                    if not cache_store.has_blob(digest):
                        os.makedirs(os.path.dirname(blob), exist_ok=True)
                        with self._open_remote(f"blobs/{digest}") as r:
                            write_stream_verified(r, blob, digest)
                    cache_store.materialize_blob(digest, blob_dest)
                else:
                    cache_store.materialize_blob(digest, blob_dest)
            except (OSError, RuntimeError, IntegrityError):
                continue

    # -- pin (atomic alias swap) -------------------------------------------
    def pin(self, name: str, alias: str, ref: str) -> str:
        """Point ``alias`` at a version (atomic pointer-file swap); returns
        the concrete version pinned. ``ref`` may itself be an alias."""
        store = self._require_local("pin")
        version = self.resolve_ref(name, ref)
        store.write_alias(name, alias, version)
        return version


def _stage_classes(stage_dir: str) -> list[str]:
    """The artifact's stage class list: the root metadata class plus any
    nested stage/stage_list complex params, in tree order."""
    out = []

    def walk(d: str) -> None:
        meta_path = os.path.join(d, "metadata.json")
        if not os.path.isfile(meta_path):
            return
        with open(meta_path) as f:
            meta = json.load(f)
        out.append(meta.get("class", ""))
        for name, entry in sorted(meta.get("complexParams", {}).items()):
            target = os.path.join(d, f"complex_{name}")
            if entry.get("kind") == "stage":
                walk(target)
            elif entry.get("kind") == "stage_list":
                for i in range(int(entry.get("n", 0))):
                    walk(f"{target}_{i:03d}")

    walk(stage_dir)
    return out
