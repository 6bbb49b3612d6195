"""IndexShard: the immutable on-disk unit of a vector index.

Counterpart of ``synapseml_tpu/retrieval/shards.py``, the same layout and
bytes, host code only.

One shard is one directory::

    <name>/
      vectors.npy     float32 [N, D]
      ids.npy         int64 [N] global document ids
      payload.jsonl   N JSON lines (optional; the match's returned payload)
      MANIFEST.json   {name, rows, dim, kind, format_version, files:{...}}

``MANIFEST.json`` carries a sha256 per data file, so a shard is verifiable
end-to-end after riding the registry's content-addressed blob store.
Commit is ATOMIC: a shard is staged under ``.tmp-<name>`` and renamed into
place, so readers (``list_shards``, ``open_shard``) can never observe a
torn shard — the same part/DONE discipline as the scoring sinks, one level
up. Shards never mutate; continual ingest adds NEW ``kind="delta"`` shards
and compaction republishes merged ``kind="base"`` shards under the next
index version.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np

__all__ = ["IndexShard", "SHARD_MANIFEST", "write_shard", "open_shard",
           "list_shards"]

SHARD_MANIFEST = "MANIFEST.json"
FORMAT_VERSION = 1
_TMP_PREFIX = ".tmp-"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@dataclasses.dataclass
class IndexShard:
    """Handle on one committed shard directory (data loads lazily)."""

    name: str
    path: str
    rows: int
    dim: int
    kind: str  # "base" | "delta"
    manifest: dict

    def vectors(self) -> np.ndarray:
        return np.load(os.path.join(self.path, "vectors.npy"))

    def ids(self) -> np.ndarray:
        return np.load(os.path.join(self.path, "ids.npy"))

    def payloads(self) -> list | None:
        p = os.path.join(self.path, "payload.jsonl")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return [json.loads(ln) for ln in f if ln.strip()]

    @property
    def nbytes(self) -> int:
        return sum(e["bytes"] for e in self.manifest["files"].values())

    def verify(self) -> None:
        """Recompute every data file's sha256 against the manifest."""
        for fname, entry in self.manifest["files"].items():
            got = _sha256(os.path.join(self.path, fname))
            if got != entry["sha256"]:
                raise ValueError(
                    f"shard {self.name!r}: {fname} sha mismatch "
                    f"(manifest {entry['sha256'][:12]}, file {got[:12]})")


def write_shard(shards_dir: str, name: str, vectors: np.ndarray,
                ids: np.ndarray | None = None, payloads: list | None = None,
                kind: str = "base", overwrite: bool = False) -> IndexShard:
    """Atomically commit one shard under ``shards_dir/name``. An existing
    committed shard is returned as-is unless ``overwrite`` (idempotent
    resume: a re-run of an interrupted build skips what already landed)."""
    if kind not in ("base", "delta"):
        raise ValueError(f"shard kind must be 'base' or 'delta', got {kind!r}")
    final = os.path.join(shards_dir, name)
    if os.path.exists(os.path.join(final, SHARD_MANIFEST)):
        if not overwrite:
            return open_shard(final)
        shutil.rmtree(final)
    vectors = np.ascontiguousarray(vectors, np.float32)
    if vectors.ndim != 2:
        raise ValueError(f"shard vectors must be [N, D], got {vectors.shape}")
    n, d = vectors.shape
    if ids is None:
        ids = np.arange(n, dtype=np.int64)
    ids = np.ascontiguousarray(ids, np.int64)
    if len(ids) != n:
        raise ValueError(f"{len(ids)} ids for {n} vectors")
    if payloads is not None and len(payloads) != n:
        raise ValueError(f"{len(payloads)} payloads for {n} vectors")
    tmp = os.path.join(shards_dir, _TMP_PREFIX + name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.save(os.path.join(tmp, "vectors.npy"), vectors)
    np.save(os.path.join(tmp, "ids.npy"), ids)
    if payloads is not None:
        with open(os.path.join(tmp, "payload.jsonl"), "w") as f:
            for p in payloads:
                f.write(json.dumps(p) + "\n")
    files = {}
    for fname in sorted(os.listdir(tmp)):
        fp = os.path.join(tmp, fname)
        files[fname] = {"sha256": _sha256(fp), "bytes": os.path.getsize(fp)}
    manifest = {"name": name, "rows": n, "dim": d, "kind": kind,
                "format_version": FORMAT_VERSION, "files": files}
    with open(os.path.join(tmp, SHARD_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.rename(tmp, final)  # the atomic commit point
    return IndexShard(name=name, path=final, rows=n, dim=d, kind=kind,
                      manifest=manifest)


def open_shard(path: str, verify: bool = False) -> IndexShard:
    """Open one committed shard directory; ``verify`` recomputes shas."""
    with open(os.path.join(path, SHARD_MANIFEST)) as f:
        manifest = json.load(f)
    shard = IndexShard(name=manifest["name"], path=path,
                       rows=int(manifest["rows"]), dim=int(manifest["dim"]),
                       kind=manifest.get("kind", "base"), manifest=manifest)
    if verify:
        shard.verify()
    return shard


def list_shards(shards_dir: str) -> list[IndexShard]:
    """Every COMMITTED shard under ``shards_dir``, name-sorted. Staged
    ``.tmp-*`` directories (a torn write) are invisible by construction."""
    out = []
    try:
        names = sorted(os.listdir(shards_dir))
    except OSError:
        return []
    for name in names:
        if name.startswith(_TMP_PREFIX):
            continue
        p = os.path.join(shards_dir, name)
        if os.path.isdir(p) and os.path.exists(os.path.join(p, SHARD_MANIFEST)):
            out.append(open_shard(p))
    return out
