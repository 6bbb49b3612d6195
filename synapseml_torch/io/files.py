"""Input-path resolution, the JSONL line parser and the streamed writers.

Counterpart of ``synapseml_tpu/io/files.py:29-56,233-420``, copied as it is
(``_IMAGE_EXTS``, ``_resolve_paths``, ``resolve_input_paths``,
``loads_jsonl_line``, ``_tmp_path``, ``json_default`` and the streamed
atomic JSONL and ``.npy`` writers the scoring sinks write through), so the
port's on-disk sources list and parse files exactly as the JAX package's
do, and its sinks and the registry's atomic writes produce the JAX
package's bytes. ``json_default`` also takes torch tensors. Images decode
through ``synapseml_torch.image.unroll.decode_image_bytes``; the eager
readers and writers come with ROADMAP.md queue A item 12.
"""

from __future__ import annotations

import glob as _glob
import json as _json
import os
import struct as _struct
import threading as _threading

import numpy as np

__all__ = ["resolve_input_paths", "loads_jsonl_line", "json_default", "jsonl_writer",
           "npy_writer", "write_npy", "StreamedJsonlWriter", "StreamedNpyWriter"]

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


def json_default(o):
    """The numpy/torch/bytes -> plain-JSON coercion of every JSONL writer."""
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, bytes):
        return o.decode("utf-8", "replace")
    if type(o).__module__ == "torch" and hasattr(o, "tolist"):  # a tensor, on any device
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o)}")


def _tmp_path(path: str) -> str:
    """Same-directory per-writer temp name (pid + thread id): two threads
    writing the same destination cannot interleave into one temp file."""
    return f"{path}.tmp.{os.getpid()}.{_threading.get_ident()}"


class _StreamedWriterBase:
    """Write-to-temp / rename-on-commit lifecycle of the streamed writers:
    :meth:`commit` flushes, fsyncs and ``os.replace``s the temp onto the
    destination, so a crashed writer never leaves a torn file under the
    final name; :meth:`abort` removes the temp. As a context manager it
    commits on a clean exit and aborts on an exception."""

    def __init__(self, path: str):
        self.path = path
        self._tmp = _tmp_path(path)
        self._f = None
        self.rows = 0

    def _finish_payload(self) -> None:
        """Subclass hook: last bytes before the fsync."""

    def commit(self) -> str:
        if self._f is None:
            raise RuntimeError(f"writer for {self.path!r} already closed")
        self._finish_payload()
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._f = None
        os.replace(self._tmp, self.path)
        return self.path

    def abort(self) -> None:
        """Drop the temp file; the destination is untouched. Idempotent."""
        if self._f is not None:
            try:
                self._f.close()
            finally:
                self._f = None
        try:
            os.unlink(self._tmp)
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.commit()
        else:
            self.abort()
        return False


class StreamedJsonlWriter(_StreamedWriterBase):
    """Streamed JSONL writer: rows or columnar chunks in bounded memory; the
    destination appears atomically on :meth:`commit`."""

    def __init__(self, path: str):
        super().__init__(path)
        self._f = open(self._tmp, "w")

    def write_row(self, row: dict) -> None:
        self._f.write(_json.dumps(row, default=json_default) + "\n")
        self.rows += 1

    def write_columns(self, cols: dict, n: int | None = None) -> None:
        """Append a columnar chunk as ``n`` rows (default: the first
        column's length)."""
        names = list(cols.keys())
        if n is None:
            n = len(next(iter(cols.values()))) if names else 0
        for i in range(int(n)):
            self.write_row({c: cols[c][i] for c in names})


def jsonl_writer(path: str) -> StreamedJsonlWriter:
    """Streamed atomic JSONL writer (see :class:`StreamedJsonlWriter`)."""
    return StreamedJsonlWriter(path)


_NPY_MAGIC = b"\x93NUMPY\x01\x00"
_NPY_HEADER_LEN = 118  # dict bytes; total header = 10 + 118 = 128 (64-aligned)


def _npy_header(dtype: np.dtype, shape: tuple) -> bytes:
    """A fixed-length (128-byte) npy 1.0 header, so that the shape can be
    rewritten in place once the row count is known."""
    from numpy.lib import format as _npfmt

    body = ("{'descr': %r, 'fortran_order': False, 'shape': %r, }"
            % (_npfmt.dtype_to_descr(dtype), tuple(int(d) for d in shape))
            ).encode("latin1")
    if len(body) > _NPY_HEADER_LEN - 1:
        raise ValueError(f"npy header too large for the fixed slot: {body!r}")
    body = body + b" " * (_NPY_HEADER_LEN - 1 - len(body)) + b"\n"
    return _NPY_MAGIC + _struct.pack("<H", _NPY_HEADER_LEN) + body


class StreamedNpyWriter(_StreamedWriterBase):
    """Streamed ``.npy`` writer: row chunks of one array without knowing the
    row count up front. The first :meth:`append` pins dtype and trailing
    shape and writes a placeholder header, which :meth:`commit` rewrites in
    place before the rename; ``np.load`` reads the result."""

    def __init__(self, path: str):
        super().__init__(path)
        self._f = open(self._tmp, "wb")
        self._dtype: np.dtype | None = None
        self._trailing: tuple | None = None

    def append(self, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        if arr.dtype == object:
            raise TypeError("cannot stream an object-dtype column to .npy; "
                            "featurize it into a rectangular array first")
        if arr.ndim == 0:
            raise ValueError("append needs rows along a leading dimension; "
                             "got a 0-d scalar (np.atleast_1d it first)")
        if self._dtype is None:
            self._dtype = arr.dtype
            self._trailing = tuple(arr.shape[1:])
            self._f.write(_npy_header(self._dtype, (0,) + self._trailing))
        elif arr.dtype != self._dtype or tuple(arr.shape[1:]) != self._trailing:
            raise ValueError(
                f"chunk dtype/shape {arr.dtype}{tuple(arr.shape[1:])} does "
                f"not match the stream's {self._dtype}{self._trailing}")
        self._f.write(arr.tobytes())
        self.rows += int(arr.shape[0])

    def _finish_payload(self) -> None:
        if self._dtype is None:  # zero appends: a legal empty float64 array
            self._dtype, self._trailing = np.dtype(np.float64), ()
            self._f.write(_npy_header(self._dtype, (0,)))
        self._f.seek(0)
        self._f.write(_npy_header(self._dtype, (self.rows,) + self._trailing))
        self._f.seek(0, os.SEEK_END)


def npy_writer(path: str) -> StreamedNpyWriter:
    """Streamed atomic ``.npy`` writer (see :class:`StreamedNpyWriter`)."""
    return StreamedNpyWriter(path)


def write_npy(path: str, array: np.ndarray) -> str:
    """One array -> one ``.npy`` file, atomically; a scalar saves as shape
    ``(1,)``."""
    with npy_writer(path) as w:
        w.append(np.atleast_1d(np.asarray(array)))
    return path
