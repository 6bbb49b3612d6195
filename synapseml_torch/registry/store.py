"""Content-addressed artifact store: sha256 blobs + signed JSON manifests.

Counterpart of ``synapseml_tpu/registry/store.py``, copied whole, so the
two packages' stores share one layout and either reads the other's:

* **Content addressing**: every file of a published pipeline is stored once
  under ``blobs/<sha256>``; identical weights across versions dedupe, and a
  blob read re-hashes the bytes so corruption surfaces as
  :class:`IntegrityError`, never as a wrong prediction.
* **Atomicity**: every write (blob, manifest, alias pointer) goes through a
  same-directory temp file (``io/files._tmp_path``) and ``os.replace``, so
  a crashed publish never leaves a half-written artifact that ``resolve()``
  would load (:func:`write_stream_verified` streams and verifies in one
  pass).
* **Tamper evidence**: manifests are HMAC-SHA256 signed with a per-store
  key (``store.key``, created on first publish, 0600), verified wherever
  the key is readable; a read-only remote consumer falls back to content
  addressing.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets
import shutil
from typing import Any, Callable

__all__ = [
    "IntegrityError",
    "ArtifactStore",
    "sha256_file",
    "atomic_write_bytes",
    "write_stream_verified",
]

_CHUNK = 1 << 20


class IntegrityError(RuntimeError):
    """Stored bytes do not match their recorded sha256 (or a manifest
    signature failed) — the artifact is corrupt or tampered with."""


# ---------------------------------------------------------------------------
# low-level atomic/verified file helpers
# ---------------------------------------------------------------------------

def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _tmp_name(path: str) -> str:
    """Per-writer temp name: pid + thread id, so two threads of one process
    writing the same destination cannot interleave into one temp file and
    rename corrupt bytes under a verified name (``io/files._tmp_path``)."""
    from ..io.files import _tmp_path

    return _tmp_path(path)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write-then-rename in the destination directory (same filesystem, so
    ``os.replace`` is atomic); readers see the old file or the new file,
    never a torn one."""
    tmp = _tmp_name(path)
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def write_stream_verified(reader, path: str,
                          expected_sha256: str | None = None) -> str:
    """Stream ``reader`` (any object with ``.read(n)``) to ``path``
    atomically, hashing incrementally — one pass, constant memory. With
    ``expected_sha256`` the rename only happens on a digest match; a
    mismatch removes the temp file and raises :class:`IntegrityError`
    ("sha256 mismatch"), so a failed transfer never leaves a destination
    file at all. Returns the hex digest."""
    h = hashlib.sha256()
    tmp = _tmp_name(path)
    try:
        with open(tmp, "wb") as f:
            for chunk in iter(lambda: reader.read(_CHUNK), b""):
                h.update(chunk)
                f.write(chunk)
        got = h.hexdigest()
        if expected_sha256 and got != expected_sha256:
            raise IntegrityError(
                f"sha256 mismatch for {path!r}: expected {expected_sha256}, "
                f"got {got}")
        os.replace(tmp, path)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return got


def _canonical_json(obj: Any) -> bytes:
    """Stable byte form for hashing/signing (sorted keys, no whitespace
    drift)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str).encode()


def _safe_component(name: str) -> str:
    """Reject path-escaping names/versions/aliases (manifest and alias file
    names are caller data)."""
    if (not name or name != os.path.basename(name) or name.startswith(".")
            or "/" in name or "\\" in name or os.path.isabs(name)):
        raise ValueError(f"unsafe registry path component: {name!r}")
    return name


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class ArtifactStore:
    """One directory owning blobs, manifests, and alias pointers.

    Layout under ``root``::

        blobs/<sha256>                  content-addressed files (dedup'd)
        manifests/<name>/<version>.json signed per-version manifests
        manifests/<name>/index.json     version list (remote listing)
        aliases/<name>/<alias>          pointer file: one version string
        store.key                       HMAC signing key (created lazily)

    Every path component is validated; every write is atomic; every blob
    read is digest-verified.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    # -- paths -------------------------------------------------------------
    def blob_path(self, digest: str) -> str:
        if len(digest) != 64 or not all(c in "0123456789abcdef"
                                        for c in digest):
            raise ValueError(f"not a sha256 hex digest: {digest!r}")
        return os.path.join(self.root, "blobs", digest)

    def _manifest_dir(self, name: str) -> str:
        return os.path.join(self.root, "manifests", _safe_component(name))

    def manifest_path(self, name: str, version: str) -> str:
        return os.path.join(self._manifest_dir(name),
                            _safe_component(version) + ".json")

    def alias_path(self, name: str, alias: str) -> str:
        return os.path.join(self.root, "aliases", _safe_component(name),
                            _safe_component(alias))

    # -- blobs -------------------------------------------------------------
    def has_blob(self, digest: str) -> bool:
        return os.path.isfile(self.blob_path(digest))

    def put_blob_file(self, path: str) -> str:
        """Ingest a file; returns its digest. One streaming pass: hash
        while copying into a temp blob, then rename to the digest-named
        path (a multi-GB publish reads each file once, not twice).
        Already-present blobs are dropped, not rewritten (content
        addressing = free dedup across versions)."""
        blobs_dir = os.path.join(self.root, "blobs")
        os.makedirs(blobs_dir, exist_ok=True)
        tmp = _tmp_name(os.path.join(blobs_dir, ".ingest"))
        h = hashlib.sha256()
        try:
            with open(path, "rb") as src, open(tmp, "wb") as f:
                for chunk in iter(lambda: src.read(_CHUNK), b""):
                    h.update(chunk)
                    f.write(chunk)
            digest = h.hexdigest()
            dest = self.blob_path(digest)
            if os.path.isfile(dest):
                os.unlink(tmp)
            else:
                os.replace(tmp, dest)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return digest

    def put_blob_bytes(self, data: bytes) -> str:
        digest = hashlib.sha256(data).hexdigest()
        dest = self.blob_path(digest)
        if not os.path.isfile(dest):
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            atomic_write_bytes(dest, data)
        return digest

    def get_blob(self, digest: str) -> bytes:
        """Read + verify; raises :class:`IntegrityError` on corruption."""
        with open(self.blob_path(digest), "rb") as f:
            data = f.read()
        got = hashlib.sha256(data).hexdigest()
        if got != digest:
            raise IntegrityError(
                f"blob {digest} corrupt on read: bytes hash to {got}")
        return data

    def materialize_blob(self, digest: str, dest: str) -> None:
        """Copy a blob to ``dest`` (creating parents), verifying the digest
        in the same streaming pass that writes the file."""
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        with open(self.blob_path(digest), "rb") as f:
            write_stream_verified(f, dest, digest)

    def ingest_tree(self, src_dir: str) -> list[dict]:
        """Blobify every file under ``src_dir``; returns the manifest
        ``files`` list: ``[{"path": rel, "sha256": d, "bytes": n}, ...]``
        sorted by path (deterministic manifests)."""
        files = []
        for dirpath, _dirnames, filenames in os.walk(src_dir):
            for fname in filenames:
                full = os.path.join(dirpath, fname)
                rel = os.path.relpath(full, src_dir)
                digest = self.put_blob_file(full)
                files.append({"path": rel.replace(os.sep, "/"),
                              "sha256": digest,
                              "bytes": os.path.getsize(full)})
        files.sort(key=lambda e: e["path"])
        return files

    def materialize_tree(self, files: list[dict], dest_dir: str,
                         fetch: Callable[[str, str], None] | None = None
                         ) -> str:
        """Rebuild a published directory tree from its manifest ``files``
        list. ``fetch(digest, dest_path)`` overrides the blob source (the
        remote registry passes an HTTP fetcher); default reads local blobs.
        Builds into a temp dir and renames, so a partially-materialized tree
        is never visible."""
        tmp = f"{dest_dir}.building.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            root = os.path.realpath(tmp)
            for entry in files:
                dest = os.path.realpath(os.path.join(tmp, entry["path"]))
                if not dest.startswith(root + os.sep):
                    raise ValueError(
                        f"manifest path escapes the tree: {entry['path']!r}")
                if fetch is not None:
                    os.makedirs(os.path.dirname(dest), exist_ok=True)
                    fetch(entry["sha256"], dest)
                else:
                    self.materialize_blob(entry["sha256"], dest)
            shutil.rmtree(dest_dir, ignore_errors=True)
            os.replace(tmp, dest_dir)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return dest_dir

    # -- signing -----------------------------------------------------------
    def _key(self, create: bool = False) -> bytes | None:
        path = os.path.join(self.root, "store.key")
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            if not create:
                return None
        key = secrets.token_bytes(32)
        tmp = f"{path}.tmp.{os.getpid()}"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.write(fd, key)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        return key

    def sign(self, manifest: dict) -> str:
        body = {k: v for k, v in manifest.items() if k != "signature"}
        return hmac.new(self._key(create=True), _canonical_json(body),
                        hashlib.sha256).hexdigest()

    def verify_signature(self, manifest: dict) -> bool:
        """True when the signature checks out; :class:`IntegrityError` when
        it does not; False when no key is readable (remote consumer —
        content addressing still verifies every blob)."""
        key = self._key(create=False)
        if key is None:
            return False
        body = {k: v for k, v in manifest.items() if k != "signature"}
        want = hmac.new(key, _canonical_json(body), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, manifest.get("signature", "")):
            raise IntegrityError(
                f"manifest signature mismatch for "
                f"{manifest.get('name')}/{manifest.get('version')}")
        return True

    # -- manifests ---------------------------------------------------------
    def write_manifest(self, name: str, version: str, manifest: dict) -> str:
        path = self.manifest_path(name, version)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        signed = dict(manifest)
        signed["signature"] = self.sign(manifest)
        atomic_write_bytes(path, json.dumps(signed, indent=2,
                                            default=str).encode())
        # keep the remote-listable version index in sync (atomic rewrite)
        index = sorted(set(self.list_versions(name)) | {version},
                       key=_version_sort_key)
        atomic_write_bytes(os.path.join(self._manifest_dir(name),
                                        "index.json"),
                           json.dumps(index).encode())
        return path

    def read_manifest(self, name: str, version: str,
                      verify: bool = True) -> dict:
        with open(self.manifest_path(name, version)) as f:
            manifest = json.load(f)
        if verify:
            self.verify_signature(manifest)
        return manifest

    def list_versions(self, name: str) -> list[str]:
        try:
            entries = os.listdir(self._manifest_dir(name))
        except OSError:
            return []
        return sorted((e[:-len(".json")] for e in entries
                       if e.endswith(".json") and e != "index.json"),
                      key=_version_sort_key)

    def list_models(self) -> list[str]:
        try:
            return sorted(os.listdir(os.path.join(self.root, "manifests")))
        except OSError:
            return []

    # -- garbage collection ------------------------------------------------
    def referenced_blobs(self) -> set[str]:
        """Every blob digest any manifest references: the stage-tree
        ``files`` plus AOT executable ``entries``. Aliases point at
        versions, so their references are already covered by the version
        manifests."""
        refs: set[str] = set()
        for name in self.list_models():
            for version in self.list_versions(name):
                try:
                    manifest = self.read_manifest(name, version,
                                                  verify=False)
                except (OSError, json.JSONDecodeError):
                    continue  # unreadable manifest: prune nothing it names
                for entry in manifest.get("files", ()):
                    refs.add(entry.get("sha256"))
                for entry in (manifest.get("aot") or {}).get("entries", ()):
                    refs.add(entry.get("sha256"))
        refs.discard(None)
        return refs

    def gc(self, dry_run: bool = False, min_age_s: float = 3600.0) -> dict:
        """Prune blobs unreferenced by any manifest (orphans from failed
        publishes accumulate forever; AOT executable ladders multiply
        store size, so dead versions now leave real garbage).

        ``dry_run=True`` reports without deleting. ``min_age_s`` protects
        blobs younger than the window — a concurrent publish writes blobs
        BEFORE its manifest, and gc must never eat an in-flight publish's
        blobs. Returns ``{"scanned", "referenced", "pruned",
        "bytes_freed", "kept_young", "dry_run"}``."""
        import time

        blobs_dir = os.path.join(self.root, "blobs")
        try:
            names = sorted(os.listdir(blobs_dir))
        except OSError:
            names = []
        refs = self.referenced_blobs()
        now = time.time()
        pruned: list[str] = []
        bytes_freed = 0
        kept_young = 0
        scanned = 0
        for fname in names:
            if len(fname) != 64 or not all(c in "0123456789abcdef"
                                           for c in fname):
                continue  # temp files belong to the writers' cleanup
            scanned += 1
            if fname in refs:
                continue
            path = os.path.join(blobs_dir, fname)
            try:
                st = os.stat(path)
            except OSError:
                continue
            if now - st.st_mtime < min_age_s:
                kept_young += 1
                continue
            pruned.append(fname)
            bytes_freed += st.st_size
            if not dry_run:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        return {"scanned": scanned, "referenced": len(refs),
                "pruned": pruned, "bytes_freed": bytes_freed,
                "kept_young": kept_young, "dry_run": dry_run}

    # -- aliases (atomically-swapped pointer files) ------------------------
    def write_alias(self, name: str, alias: str, version: str) -> None:
        path = self.alias_path(name, alias)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_write_bytes(path, _safe_component(version).encode())

    def read_alias(self, name: str, alias: str) -> str | None:
        try:
            with open(self.alias_path(name, alias)) as f:
                return f.read().strip() or None
        except OSError:
            return None

    def list_aliases(self, name: str) -> dict[str, str]:
        d = os.path.join(self.root, "aliases", _safe_component(name))
        try:
            entries = os.listdir(d)
        except OSError:
            return {}
        out = {}
        for alias in sorted(entries):
            target = self.read_alias(name, alias)
            if target:
                out[alias] = target
        return out


def _version_sort_key(version: str):
    """``v2`` sorts before ``v10`` (numeric when the conventional form
    matches, lexicographic otherwise)."""
    if version.startswith("v") and version[1:].isdigit():
        return (0, int(version[1:]), version)
    return (1, 0, version)
