"""Continual ingest: request logs -> delta shards -> the next index version.

Counterpart of ``synapseml_tpu/retrieval/ingest.py``. Freshly logged
documents (the request log's committed parts: ``part-NNNNN.jsonl`` beside
its ``part-NNNNN.jsonl.DONE``, as ``continual.RequestLogger`` writes them)
embed and commit as new ``kind="delta"`` shards, with no rebuild. The path
is deterministic and exactly-once, so an ingest killed and resumed in a
fresh process commits byte-identical shards:

* only DONE-committed log parts are read (torn parts are invisible);
* the extracted docs file is a function of (base manifest, committed parts)
  and is rewritten atomically on resume;
* the embed is a ``scoring.transform_source`` job (resume skips done parts);
* delta shards commit by ``shards.py``'s stage-and-rename, and an
  unpublished one is invisible to ``registry.resolve()``.

The manifest's ``extra.retrieval.ingested_parts`` records the log parts
each version absorbed (re-runs are no-ops), and the freshness lag (earliest
logged ``ts`` to publish) is a measured metric. ``compact_index`` folds the
deltas past a threshold into one base shard under the next version. The
republished stage keeps the base stage's search params and device.
"""

from __future__ import annotations

import json
import os
import shutil
import time

from .build import embed_corpus, shards_from_parts
from .metrics import retrieval_metrics
from .model import VectorIndexModel
from .shards import list_shards

__all__ = ["ingest_deltas", "compact_index", "extract_documents"]


def _default_doc_fn(record: dict):
    """Pull an ingestible document out of one request-log record: a body
    carrying ``doc`` or ``text``. Return None to skip (non-document
    traffic logs alongside document traffic on a shared front)."""
    body = record.get("body")
    if not isinstance(body, dict):
        return None
    text = body.get("doc") or body.get("text")
    if not text or not isinstance(text, str):
        return None
    return {"text": text, "payload": {"text": text}, "ts": record.get("ts")}


def _committed_log_parts(log_dir: str) -> list[str]:
    out = []
    for name in sorted(os.listdir(log_dir)):
        if (name.startswith("part-") and name.endswith(".jsonl")
                and os.path.exists(os.path.join(log_dir, name + ".DONE"))):
            out.append(name)
    return out


def extract_documents(log_dir: str, parts: list[str], out_path: str, *,
                      doc_fn=None, base_rows: int = 0) -> dict:
    """Deterministically extract documents from the named committed log
    parts into ``out_path`` (JSONL ``{id, text, payload, ts}``; atomic
    write). Doc ids continue the index's global id space at ``base_rows``.
    Returns ``{"docs": n, "min_ts": float|None}``."""
    doc_fn = doc_fn or _default_doc_fn
    docs, min_ts = [], None
    for part in parts:
        with open(os.path.join(log_dir, part)) as f:
            for ln in f:
                if not ln.strip():
                    continue
                doc = doc_fn(json.loads(ln))
                if doc is None:
                    continue
                ts = doc.get("ts")
                if ts is not None:
                    min_ts = ts if min_ts is None else min(min_ts, ts)
                docs.append({"id": base_rows + len(docs),
                             "text": doc["text"],
                             "payload": doc.get("payload")})
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        for d in docs:
            f.write(json.dumps(d, sort_keys=True) + "\n")
    os.replace(tmp, out_path)
    return {"docs": len(docs), "min_ts": min_ts}


def _assemble_index(resolved_path: str, index_dir: str) -> None:
    """Copy the base version's committed shards into the new index tree
    (content-addressed blobs dedupe them at publish, so this costs local
    disk only). Already-copied shards are kept (resume)."""
    src = os.path.join(resolved_path, "shards")
    dst = os.path.join(index_dir, "shards")
    os.makedirs(dst, exist_ok=True)
    for sh in list_shards(src):
        target = os.path.join(dst, sh.name)
        if not os.path.exists(os.path.join(target, "MANIFEST.json")):
            tmp = os.path.join(dst, ".tmp-" + sh.name)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            shutil.copytree(sh.path, tmp)
            os.rename(tmp, target)


def _republish(registry, name: str, resolved, index_dir: str,
               extra_retrieval: dict, set_latest: bool = True):
    """Publish the assembled tree under the next version, carrying the
    base stage's search params forward."""
    committed = list_shards(os.path.join(index_dir, "shards"))
    base = resolved.stage
    model = VectorIndexModel(
        index_name=name, shard_names=[s.name for s in committed],
        dim=int(committed[0].dim), metric=base.get("metric"),
        k=base.get("k"), query_batch=base.get("query_batch"),
        device=base.get("device"))
    extra = {"retrieval": dict(extra_retrieval)}
    extra["retrieval"].update({
        "shards": [{"name": s.name, "rows": s.rows, "kind": s.kind}
                   for s in committed],
        "rows": int(sum(s.rows for s in committed)),
        "dim": int(committed[0].dim),
        "metric": base.get("metric"),
    })
    return registry.publish(name, model, extra=extra,
                            set_latest=set_latest, extra_tree=index_dir)


def ingest_deltas(registry, name: str, log_dir: str, embedder,
                  work_dir: str, *, ref: str = "latest", doc_fn=None,
                  vector_col: str = "embedding", batch_rows: int = 256,
                  set_latest: bool = True) -> dict | None:
    """Embed the not-yet-ingested committed log parts under ``log_dir`` as
    delta shards and publish the next index version. Returns the ingest
    report, or None when there is nothing new (also the crash-after-publish
    resume path: the republished manifest already lists the parts).

    ``work_dir`` is the job's scratch/resume root: re-running with the
    same ``work_dir`` after a SIGKILL resumes the embed exactly-once and
    recommits the identical shards."""
    resolved = registry.resolve(name, ref)
    extra = dict((resolved.manifest.get("extra") or {}).get("retrieval") or {})
    already = set(extra.get("ingested_parts") or [])
    parts = [p for p in _committed_log_parts(log_dir) if p not in already]
    if not parts:
        return None
    base_rows = int(extra.get("rows") or 0)
    os.makedirs(work_dir, exist_ok=True)
    docs_path = os.path.join(work_dir, "docs.jsonl")
    info = extract_documents(log_dir, parts, docs_path, doc_fn=doc_fn,
                             base_rows=base_rows)
    if not info["docs"]:
        return None
    from ..data.source import ShardedSource

    source = ShardedSource.jsonl([docs_path])
    sink, report = embed_corpus(embedder, source,
                                os.path.join(work_dir, "emb"),
                                vector_col=vector_col, id_col="id",
                                batch_rows=batch_rows)
    index_dir = os.path.join(work_dir, "index")
    payloads = {}
    with open(docs_path) as f:
        for ln in f:
            d = json.loads(ln)
            payloads[int(d["id"])] = d.get("payload")
    deltas = shards_from_parts(
        sink, index_dir, vector_col=vector_col, id_col="id",
        payload_fn=payloads.get, prefix=f"delta-{resolved.version}",
        kind="delta")
    _assemble_index(resolved.path, index_dir)
    extra["ingested_parts"] = sorted(already | set(parts))
    published = _republish(registry, name, resolved, index_dir, extra,
                           set_latest=set_latest)
    lag = (time.time() - info["min_ts"]) if info["min_ts"] else 0.0
    retrieval_metrics()["freshness"].set(lag, index=name)
    return {
        "name": name, "base_version": resolved.version,
        "version": published.version, "docs": info["docs"],
        "delta_shards": [s.name for s in deltas],
        "freshness_lag_s": lag,
        "quarantined": int(report.rows_quarantined),
    }


def compact_index(registry, name: str, work_dir: str, *,
                  ref: str = "latest", threshold: int = 4,
                  set_latest: bool = True) -> dict | None:
    """Merge the base version's delta shards into ONE new base shard once
    there are >= ``threshold`` of them, republishing under the next
    version. Returns the compaction report, or None below threshold.
    Shards are immutable: compaction writes a new roster, never edits."""
    import numpy as np

    resolved = registry.resolve(name, ref)
    src_shards = list_shards(os.path.join(resolved.path, "shards"))
    deltas = [s for s in src_shards if s.kind == "delta"]
    if len(deltas) < threshold:
        return None
    index_dir = os.path.join(work_dir, "index")
    shards_dir = os.path.join(index_dir, "shards")
    os.makedirs(shards_dir, exist_ok=True)
    # keep bases as-is; fold every delta into one new base shard
    from .shards import write_shard

    vectors = np.concatenate([s.vectors() for s in deltas], axis=0)
    ids = np.concatenate([s.ids() for s in deltas], axis=0)
    payload_lists = [s.payloads() for s in deltas]
    payloads = (None if any(p is None for p in payload_lists)
                else [p for lst in payload_lists for p in lst])
    merged_name = f"base-{resolved.version}-compacted"
    write_shard(shards_dir, merged_name, vectors, ids=ids,
                payloads=payloads, kind="base")
    for s in src_shards:
        if s.kind != "delta":
            target = os.path.join(shards_dir, s.name)
            if not os.path.exists(os.path.join(target, "MANIFEST.json")):
                tmp = os.path.join(shards_dir, ".tmp-" + s.name)
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                shutil.copytree(s.path, tmp)
                os.rename(tmp, target)
    extra = dict((resolved.manifest.get("extra") or {}).get("retrieval") or {})
    published = _republish(registry, name, resolved, index_dir, extra,
                           set_latest=set_latest)
    return {"name": name, "base_version": resolved.version,
            "version": published.version,
            "merged": [s.name for s in deltas], "into": merged_name}
