"""Input-path resolution and the JSONL line parser.

Counterpart of ``synapseml_tpu/io/files.py:29-56,233-251``, copied as it is
(``_IMAGE_EXTS``, ``_resolve_paths``, ``resolve_input_paths``,
``loads_jsonl_line``), so the port's on-disk sources list and parse files
exactly as the JAX package's do. Images decode through
``synapseml_torch.image.unroll.decode_image_bytes``.
"""

from __future__ import annotations

import glob as _glob
import json as _json
import os

__all__ = ["resolve_input_paths", "loads_jsonl_line"]

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif", ".tiff", ".webp")


def _resolve_paths(path: str, recursive: bool, exts: tuple[str, ...] | None) -> list[str]:
    if os.path.isdir(path):
        pattern = os.path.join(path, "**" if recursive else "", "*")
        paths = _glob.glob(pattern, recursive=recursive)
    else:
        paths = _glob.glob(path, recursive=recursive)
    out = [p for p in paths if os.path.isfile(p)]
    if exts is not None:
        out = [p for p in out if p.lower().endswith(exts)]
    return sorted(out)


def resolve_input_paths(path: str, what: str,
                        exts: tuple[str, ...] | None = None) -> list[str]:
    """A glob pattern or directory lists through ``_resolve_paths``; a
    literal filename passes through untouched."""
    is_glob = any(ch in path for ch in "*?[")
    paths = (_resolve_paths(path, recursive=True, exts=exts)
             if is_glob or os.path.isdir(path) else [path])
    if not paths:
        raise FileNotFoundError(f"no {what} files match {path!r}")
    return paths


def loads_jsonl_line(line: str | bytes, path: str, lineno: int) -> dict:
    """``json.loads`` for one JSONL record that, on a malformed line, names
    the file and line instead of raising a bare ``JSONDecodeError``."""
    try:
        return _json.loads(line)
    except _json.JSONDecodeError as e:
        snippet = line if isinstance(line, str) else \
            line.decode("utf-8", "replace")
        snippet = snippet.strip()
        if len(snippet) > 120:
            snippet = snippet[:120] + "..."
        raise ValueError(
            f"{path}:{lineno}: malformed JSONL record ({e.msg} at column "
            f"{e.colno}): {snippet!r}") from e
