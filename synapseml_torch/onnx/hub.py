"""ONNXHub — a model-zoo client: a manifest, sha256 checks and a local cache.

Counterpart of ``synapseml_tpu/onnx/hub.py``, host only. Cache-first
(models + ``manifest.json`` under ``hub_dir``, default
``$SYNAPSEML_TORCH_HUB`` or ``~/.cache/synapseml_torch/onnx``); when a
``base_url`` is configured (constructor argument or
``$SYNAPSEML_TORCH_HUB_URL``) a cache miss fetches ``{base_url}/
manifest.json`` and the model file, verifies the manifest's sha256, and
caches it. Without a base_url a miss raises with the expected cache path.
"""

from __future__ import annotations

import hashlib
import json
import os

__all__ = ["ONNXHub"]


class ONNXHub:
    def __init__(self, hub_dir: str | None = None, base_url: str | None = None,
                 timeout_s: float = 120.0):
        self.hub_dir = hub_dir or os.environ.get(
            "SYNAPSEML_TORCH_HUB",
            os.path.join(os.path.expanduser("~"), ".cache", "synapseml_torch", "onnx"))
        self.base_url = (base_url or os.environ.get("SYNAPSEML_TORCH_HUB_URL")
                         or "").rstrip("/")
        self.timeout_s = timeout_s

    # -------- remote fetch (manifest-driven, SHA-checked) --------
    def _fetch(self, rel: str) -> bytes:
        import urllib.request

        url = f"{self.base_url}/{rel.lstrip('/')}"
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return r.read()

    def refresh_manifest(self) -> list[dict]:
        """Download the zoo manifest."""
        if not self.base_url:
            raise RuntimeError("no hub base_url configured (constructor arg or "
                               "$SYNAPSEML_TORCH_HUB_URL)")
        manifest = json.loads(self._fetch("manifest.json"))
        os.makedirs(self.hub_dir, exist_ok=True)
        with open(self._manifest_path(), "w") as f:
            json.dump(manifest, f, indent=2)
        return manifest

    def _safe_cache_path(self, rel: str) -> str:
        """Join a manifest-supplied relative path into hub_dir, rejecting
        absolute paths and traversal — the manifest is REMOTE UNTRUSTED data."""
        if os.path.isabs(rel):
            raise ValueError(f"manifest model_path must be relative: {rel!r}")
        path = os.path.realpath(os.path.join(self.hub_dir, rel))
        root = os.path.realpath(self.hub_dir)
        if not (path == root or path.startswith(root + os.sep)):
            raise ValueError(f"manifest model_path escapes the cache dir: {rel!r}")
        return path

    def download(self, name: str) -> tuple[str, bytes]:
        """Fetch one model by manifest entry, verify sha256, cache atomically,
        return (path, bytes)."""
        if self.base_url:
            try:
                self.get_model_info(name)
            except KeyError:
                # stale/empty local manifest: refresh before giving up
                self.refresh_manifest()
        info = self.get_model_info(name)
        rel = info.get("model_path") or f"{name}.onnx"
        data = self._fetch(rel)
        expect = info.get("model_sha256")
        if expect:
            got = hashlib.sha256(data).hexdigest()
            if got != expect:
                raise ValueError(f"downloaded {name!r} sha256 mismatch: "
                                 f"{got} != {expect}")
        path = self._safe_cache_path(rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".part"
        with open(tmp, "wb") as f:  # atomic: no truncated cache entries
            f.write(data)
        os.replace(tmp, path)
        return path, data

    # -------- manifest --------
    def _manifest_path(self) -> str:
        return os.path.join(self.hub_dir, "manifest.json")

    def list_models(self) -> list[dict]:
        path = self._manifest_path()
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return json.load(f)

    def get_model_info(self, name: str) -> dict:
        matches = [m for m in self.list_models()
                   if m.get("model", "").lower() == name.lower()
                   or m.get("model_path", "") == name]
        if not matches:
            raise KeyError(f"model {name!r} not in hub manifest "
                           f"({self._manifest_path()}); available: "
                           f"{[m.get('model') for m in self.list_models()]}")
        # newest opset wins (reference picks max opset version)
        return max(matches, key=lambda m: m.get("opset_version", 0))

    # -------- models --------
    def model_path(self, name: str) -> str:
        try:
            info = self.get_model_info(name)
            rel = info.get("model_path") or f"{name}.onnx"
        except KeyError:
            rel = f"{name}.onnx"
        return os.path.join(self.hub_dir, rel)

    def load(self, name: str, verify_sha: bool = True) -> bytes:
        path = self.model_path(name)
        if not os.path.exists(path) and self.base_url:
            _, data = self.download(name)  # just verified in memory
            return data
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"ONNX model {name!r} not cached at {path}. This environment "
                f"has no network egress: place the .onnx file there (and "
                f"optionally a manifest.json entry) to use the hub, or set a "
                f"base_url.")
        with open(path, "rb") as f:
            data = f.read()
        if verify_sha:
            try:
                expect = self.get_model_info(name).get("model_sha256")
            except KeyError:
                expect = None
            if expect and hashlib.sha256(data).hexdigest() != expect:
                if self.base_url:
                    # corrupt/interrupted cache entry: re-download once
                    _, data = self.download(name)
                    return data
                raise ValueError(f"sha256 mismatch for {name}: "
                                 f"{hashlib.sha256(data).hexdigest()} != {expect}")
        return data

    def save(self, name: str, data: bytes, extra_info: dict | None = None) -> str:
        """Register a model into the local hub (test/setup convenience)."""
        os.makedirs(self.hub_dir, exist_ok=True)
        rel = f"{name}.onnx"
        with open(os.path.join(self.hub_dir, rel), "wb") as f:
            f.write(data)
        manifest = self.list_models()
        manifest = [m for m in manifest if m.get("model") != name]
        entry = {"model": name, "model_path": rel,
                 "model_sha256": hashlib.sha256(data).hexdigest(),
                 "opset_version": 17}
        entry.update(extra_info or {})
        manifest.append(entry)
        with open(self._manifest_path(), "w") as f:
            json.dump(manifest, f, indent=2)
        return os.path.join(self.hub_dir, rel)
