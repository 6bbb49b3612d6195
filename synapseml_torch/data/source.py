"""Out-of-core sharded data sources.

Counterpart of ``synapseml_tpu/data/source.py``: a :class:`ShardedSource`
describes a dataset as a list of :class:`Shard` descriptors — byte ranges
of jsonl/csv files, row ranges of ``.npy`` arrays, slices of an image
directory listing — and ``read_shard`` materializes ONE shard as a
columnar dict, so memory is bounded by the shard, not the dataset. Every
host computes the same seeded epoch order (``state.shard_order``) and takes
the strided slice ``order[host_index::host_count]``.

Reads honor the resilience and fault-injection planes: each physical read
consults ``core.faults.active_fault_plan().on_read(target)`` and retries
transient ``OSError``/``TimeoutError`` failures under a
:class:`~synapseml_torch.core.resilience.RetryPolicy`, counting retries on
``resilience_measures("data")``.

The CSV reader parses with the standard library's ``csv`` module where the
JAX package calls ``pandas.read_csv``, and infers each column's dtype as
pandas does for plain files (:func:`_infer_column`): int64, float64 (a
missing value in a numeric column), bool, else object with NaN for missing
values. :class:`MemorySource` wraps an in-memory ``DataFrame`` or column
dict, so ``fit_arrays`` rides the same plane.
"""

from __future__ import annotations

import csv as _csv
import dataclasses
import io as _io
import os
import re
import time
from typing import Any, Callable, Sequence

import numpy as np

from ..core.resilience import RetryPolicy, resilience_measures

__all__ = ["Shard", "ShardedSource", "MemorySource", "default_read_retry",
           "resolve_host"]


def resolve_host(host_index: int | None,
                 host_count: int | None) -> tuple[int, int]:
    """Per-host striding defaults and validation. Without a process group
    the defaults are one host: index 0 of 1."""
    host_index = 0 if host_index is None else int(host_index)
    host_count = 1 if host_count is None else int(host_count)
    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} outside [0, {host_count})")
    return host_index, host_count


DEFAULT_SHARD_BYTES = 64 << 20
DEFAULT_SHARD_ROWS = 65536


def default_read_retry() -> RetryPolicy:
    """Transient read failures retry on a short jittered schedule."""
    return RetryPolicy(backoffs_ms=(50, 200, 500))


@dataclasses.dataclass(frozen=True)
class Shard:
    """One independently readable slice of a dataset.

    ``kind`` selects the reader; ``start``/``stop`` are byte offsets for
    tabular files, row offsets for ``npy``/``memory`` shards, and listing
    offsets for image shards."""

    index: int
    kind: str            # jsonl | csv | npy | image | memory
    path: str            # file path ('' for memory shards)
    start: int
    stop: int

    @property
    def target(self) -> str:
        """The fault-plan / span match target."""
        return f"{self.path}[{self.start}:{self.stop}]"


def _line_aligned_ranges(size: int, shard_bytes: int, origin: int = 0
                         ) -> list[tuple[int, int]]:
    """Byte ranges covering [origin, size); a LINE belongs to the range that
    contains its first byte, so ranges need no alignment up front — the
    reader seeks and skips the partial first line itself."""
    shard_bytes = max(int(shard_bytes), 1)
    out = []
    pos = origin
    while pos < size:
        out.append((pos, min(pos + shard_bytes, size)))
        pos += shard_bytes
    return out  # empty when the file holds no body bytes (e.g. header-only)


def _read_lines_in_range(path: str, start: int, stop: int,
                         at_line_start: bool = False) -> list[bytes]:
    """The byte-range line reader shared by the jsonl and csv shards: every
    line whose first byte lands in [start, stop) belongs to this shard.
    ``at_line_start`` marks ``start`` as a known line boundary (byte 0, or
    the csv body origin right after the header) — no partial-line skip."""
    out = []
    with open(path, "rb") as f:
        f.seek(start)
        if start > 0 and not at_line_start:
            # Position to the first line STARTING in-range: back up one byte
            # and consume to the next newline — when byte start-1 is itself
            # a newline this is a no-op skip (the line beginning exactly at
            # ``start`` belongs to THIS shard and must not be dropped).
            f.seek(start - 1)
            f.readline()
        while True:
            line_start = f.tell()
            if line_start >= stop:
                break
            line = f.readline()
            if not line:
                break
            if line.strip():
                out.append(line)
    return out


def _columnar(rows: list[dict]) -> dict[str, np.ndarray]:
    """rows -> columnar dict over the union of keys (missing fields None)."""
    keys: list = []
    for r in rows:
        keys += [k for k in r if k not in keys]
    from ..core.dataframe import _as_column

    n = len(rows)
    return {k: _as_column([r.get(k) for r in rows], n) for k in keys}


# pandas.read_csv's default missing-value strings and boolean words
_NA_VALUES = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
                        "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
                        "None", "n/a", "nan", "null"])
_TRUE, _FALSE = frozenset(["True", "TRUE", "true"]), frozenset(["False", "FALSE", "false"])
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
                    r"|(?i:inf|infinity))")
_POW10 = [float(f"1e{k}") for k in range(309)]


def _pandas_float(s: str) -> float:
    """A decimal string as pandas' default ("high") converter reads it,
    which is not always correctly rounded: the first 17 digits (leading
    zeros included) are accumulated as ``x * 10 + d`` in double, later
    integer digits only raise the exponent and later decimals are dropped,
    then the value is scaled by one power of ten from a table (twice below
    1e-308)."""
    m = re.fullmatch(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?", s)
    if m is None:  # inf / infinity
        return float(s)
    sign, whole, frac, exp = m.group(1), m.group(2), m.group(3) or "", m.group(4)
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in frac[:max(17 - digits, 0)]:
        number = number * 10.0 + (ord(ch) - 48)
        exponent -= 1
    exponent += int(exp) if exp else 0
    if exponent < -616:
        return 0.0
    if exponent > 308:
        number = float("inf") if number else 0.0
    elif exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:
        number = number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    return -number if sign == "-" else number


_INT_CHARS = frozenset("0123456789+-")
_FLOAT_CHARS = frozenset("0123456789+-.eE")
_NA_LIST = sorted(_NA_VALUES)


def _chars(arr: np.ndarray) -> set | None:
    """The characters of a unicode array's strings, or None past ASCII."""
    codes = arr.view(np.uint32).ravel()
    if codes.size and int(codes.max()) >= 128:
        return None
    return {chr(c) for c in np.flatnonzero(np.bincount(codes, minlength=128)) if c}


def _floats(present: np.ndarray) -> np.ndarray:
    """A unicode array of numbers as pandas reads them. A string of at most
    15 characters with no exponent holds at most 15 digits and at most 14
    decimals, so pandas' converter divides an exact integer by an exact
    power of ten once: the correctly rounded value, which numpy's parse
    gives. Only the other strings take :func:`_pandas_float`."""
    out = present.astype(np.float64)
    slow = np.char.str_len(present) > 15
    for letter in "eEnN":  # exponents, inf and infinity
        slow |= np.char.find(present, letter) >= 0
    for i in np.flatnonzero(slow):
        out[i] = _pandas_float(str(present[i]))
    return out


def _infer_column(values) -> np.ndarray:
    """One CSV column's values as ``pandas.read_csv`` types them: int64 when
    every value is an integer, float64 when every value is a number or
    missing (NaN), bool when every value is a boolean word, else object
    (the strings, NaN where missing)."""
    arr = np.array(values, dtype=str)
    na = np.isin(arr, _NA_LIST)
    any_na = bool(na.any())
    present = arr[~na] if any_na else arr
    chars = _chars(present)
    if present.size and not any_na and chars is not None and chars <= _INT_CHARS:
        try:
            return present.astype(np.int64)
        except (ValueError, OverflowError):  # a stray sign, or past int64
            pass
    vals = None
    if chars is not None and chars <= _FLOAT_CHARS:
        try:  # within these characters numpy's grammar is pandas'
            vals = _floats(present)
        except ValueError:
            pass
    elif all(map(_FLOAT.fullmatch, present.tolist())):  # inf / infinity
        vals = _floats(present)
    if vals is not None:
        out = np.full(arr.shape[0], np.nan)
        out[~na] = vals
        return out
    strings = arr.tolist()
    words = all(v in _TRUE or v in _FALSE for v in present.tolist())
    if words and not any_na:
        return np.asarray([v in _TRUE for v in strings], dtype=bool)
    out = np.empty(len(strings), dtype=object)
    for i, (v, m) in enumerate(zip(strings, na.tolist())):
        out[i] = np.nan if m else (v in _TRUE if words else v)
    return out


_NUMERIC_BYTES = np.zeros(256, dtype=bool)
_NUMERIC_BYTES[np.frombuffer(b"0123456789+-.,\n", np.uint8)] = True


def _parse_numeric_csv(header: list[str], body: bytes) -> dict[str, np.ndarray] | None:
    """The fast path of :func:`_parse_csv`: a body of plain decimal fields
    of 1 to 15 characters (no quotes, exponents or missing values), which
    numpy's parser reads to pandas' bits (see :func:`_floats`); a column
    with no ``.`` is int64. None when the body is not such a body."""
    b = np.frombuffer(body, dtype=np.uint8)
    width = len(header)
    if not b.size or b[-1] != ord("\n") or not _NUMERIC_BYTES[b].all():
        return None
    newline, comma = b == ord("\n"), b == ord(",")
    sep = newline | comma
    ends = np.flatnonzero(sep)
    lengths = np.diff(ends, prepend=-1) - 1
    n_rows = int(newline.sum())
    if lengths.min() < 1 or lengths.max() > 15 or ends.size != n_rows * width:
        return None
    column = np.arange(ends.size) % width
    if not np.array_equal(np.flatnonzero(newline[ends]), np.flatnonzero(column == width - 1)):
        return None  # a row of another width
    try:
        table = np.loadtxt(_io.BytesIO(body), delimiter=",", dtype=np.float64, ndmin=2,
                           comments=None, encoding=None)
    except ValueError:  # a stray sign or a second point
        return None
    table = np.ascontiguousarray(table.T)  # a column a row, as pandas' columns
    field_of_byte = np.cumsum(sep) - sep  # the field each byte belongs to
    has_dot = np.bincount(column[field_of_byte[b == ord(".")]], minlength=width) > 0
    out = {}
    for j, name in enumerate(header):
        col = table[j]
        if has_dot[j]:
            out[name] = col
        elif np.all(np.abs(col) < 2 ** 53):
            out[name] = col.astype(np.int64)
        else:
            return None
    return out


def _parse_csv(data: bytes, where: str) -> dict[str, np.ndarray]:
    """A header line plus body rows -> columnar dict, each column typed by
    :func:`_infer_column`. A row with fewer fields than the header is
    padded with missing values; one with more raises."""
    head, _, rest = data.partition(b"\n")
    header = next(_csv.reader([head.decode("utf-8").rstrip("\r")]))
    fast = _parse_numeric_csv(header, rest) if len(set(header)) == len(header) else None
    if fast is not None:
        return fast
    rows = [r for r in _csv.reader(_io.StringIO(data.decode("utf-8"), newline="")) if r]
    header, body = rows[0], rows[1:]  # blank lines dropped, as pandas' skip_blank_lines
    width = len(header)
    for k, r in enumerate(body):
        if len(r) != width:
            if len(r) > width:
                raise ValueError(f"CSV {where}: row {k + 1} has {len(r)} fields, the "
                                 f"header {width}")
            body[k] = r + [""] * (width - len(r))
    cols = list(zip(*body)) if body else [()] * width
    return {name: _infer_column(vals) for name, vals in zip(header, cols)}


class ShardedSource:
    """A dataset as independently readable shards (see module docstring).

    Build with the classmethod constructors — :meth:`jsonl`, :meth:`csv`,
    :meth:`npy`, :meth:`image_dir` — or wrap in-memory data with
    :class:`MemorySource`.
    """

    kind = "sharded"

    def __init__(self, shards: Sequence[Shard],
                 reader: Callable[[Shard], dict],
                 retry_policy: RetryPolicy | None = None,
                 name: str = "source"):
        if not shards:
            raise ValueError("a ShardedSource needs at least one shard")
        self._shards = list(shards)
        self._reader = reader
        self.retry_policy = retry_policy or default_read_retry()
        self.name = name

    # -- interface ----------------------------------------------------------
    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def shards(self) -> list[Shard]:
        return list(self._shards)

    def read_shard(self, shard: Shard | int) -> dict[str, np.ndarray]:
        """Materialize one shard as a columnar dict. Fault-injectable
        (``FaultSpec(..., planes=("data",))``) and retried under the
        source's ``RetryPolicy``."""
        if isinstance(shard, int):
            shard = self._shards[shard]
        return self._guarded(lambda: self._reader(shard), shard.target)

    def iter_shards(self):
        """Sequential (unshuffled) pass over every shard — the fixed-memory
        scan the streamed GBDT passes use."""
        for s in self._shards:
            yield s, self.read_shard(s)

    def estimate_rows(self, sample_bytes: int = 1 << 20,
                      read_fallback: bool = True) -> int:
        """Cheap row-count estimate. Row-range shard kinds (npy/memory/image)
        answer from shard metadata; byte-range kinds (jsonl/csv) sample up
        to ``sample_bytes`` from the first shard's file for a bytes/row
        ratio and scale it over the total sharded byte count. Unknown
        custom readers fall back to reading ONE shard and scaling by shard
        count — ``read_fallback=False`` raises instead. Memoized; an exact
        ``total_rows`` computed earlier is preferred."""
        if hasattr(self, "_total_rows"):
            return self._total_rows
        if hasattr(self, "_estimated_rows"):
            return self._estimated_rows
        if all(s.kind in ("npy", "memory") for s in self._shards):
            return self.total_rows()
        if all(s.kind in ("npy", "memory", "image") for s in self._shards):
            # image start/stop are file-LISTING offsets: one row per file
            # counted without decoding (undecodable files overcount)
            est = sum(s.stop - s.start for s in self._shards)
            self._estimated_rows = est
            return est
        if all(s.kind in ("jsonl", "csv") for s in self._shards):
            first = self._shards[0]
            with open(first.path, "rb") as f:
                f.seek(first.start)
                buf = f.read(max(int(sample_bytes), 1))
            cut = buf.rfind(b"\n")
            sample = buf if cut < 0 else buf[:cut + 1]
            n_lines = max(sum(1 for ln in sample.splitlines() if ln.strip()), 1)
            bytes_per_row = max(len(sample), 1) / n_lines
            total_bytes = sum(s.stop - s.start for s in self._shards)
            est = max(int(round(total_bytes / bytes_per_row)), 1)
        else:
            if not read_fallback:
                raise ValueError(
                    "estimate_rows for custom shard kinds needs a full "
                    "shard read; call with read_fallback=True to allow it")
            est = _n_rows(self.read_shard(self._shards[0])) * self.num_shards
        self._estimated_rows = est
        return est

    def total_rows(self) -> int:
        """Exact row count: from the shard metadata for row-range kinds
        (npy/memory), else one full read pass (image dirs too: their reader
        drops undecodable files). Memoized."""
        if not hasattr(self, "_total_rows"):
            if all(s.kind in ("npy", "memory") for s in self._shards):
                self._total_rows = sum(s.stop - s.start for s in self._shards)
            else:
                self._total_rows = sum(_n_rows(cols) for _, cols in self.iter_shards())
        return self._total_rows

    # -- read guard ---------------------------------------------------------
    def _guarded(self, fn: Callable[[], dict], target: str) -> dict:
        from ..core.faults import active_fault_plan

        policy = self.retry_policy
        measures = resilience_measures("data")
        for attempt in range(policy.max_attempts):
            try:
                plan = active_fault_plan()
                if plan is not None:
                    plan.on_read(target)
                out = fn()
                policy.on_success(first_attempt=attempt == 0)
                return out
            except (OSError, TimeoutError):
                if attempt + 1 >= policy.max_attempts or not policy.acquire_retry():
                    raise
                measures.count("retry")
                time.sleep(policy.backoff_ms(attempt) / 1000.0)
        raise AssertionError("unreachable")

    # -- constructors -------------------------------------------------------
    @classmethod
    def jsonl(cls, path, shard_bytes: int = DEFAULT_SHARD_BYTES,
              retry_policy: RetryPolicy | None = None) -> "ShardedSource":
        """JSON-lines file(s)/glob/dir — or an explicit LIST of file paths —
        -> byte-range shards. Heterogeneous records union over all keys seen
        in the shard."""
        paths = _tabular_paths(path, "JSONL")
        shards, idx = [], 0
        for p in paths:
            for start, stop in _line_aligned_ranges(os.path.getsize(p), shard_bytes):
                shards.append(Shard(idx, "jsonl", p, start, stop))
                idx += 1
        if not shards:
            raise ValueError(f"no data rows under {path!r} (the matched "
                             "JSONL files are all empty)")

        def read(shard: Shard) -> dict:
            from ..io.files import loads_jsonl_line

            # line numbers are unknowable inside a byte range without a scan
            # from byte 0: the error names the shard's byte window and the
            # line's ordinal within it
            rows = [loads_jsonl_line(ln, f"{shard.path}[{shard.start}:"
                                     f"{shard.stop}] line", k + 1)
                    for k, ln in enumerate(_read_lines_in_range(
                        shard.path, shard.start, shard.stop))]
            return _columnar(rows)

        return cls(shards, read, retry_policy, name="jsonl")

    @classmethod
    def csv(cls, path: str, shard_bytes: int = DEFAULT_SHARD_BYTES,
            retry_policy: RetryPolicy | None = None) -> "ShardedSource":
        """CSV file(s)/glob/dir -> byte-range shards; every shard re-reads
        the file's header line so any byte range parses standalone. The
        JAX package passes extra keywords to ``pandas.read_csv``; this
        package parses without pandas and takes none."""
        paths = _tabular_paths(path, "CSV")
        shards, idx, headers = [], 0, {}
        for p in paths:
            with open(p, "rb") as f:
                headers[p] = f.readline()
            body = len(headers[p])
            for start, stop in _line_aligned_ranges(os.path.getsize(p), shard_bytes,
                                                    origin=body):
                shards.append(Shard(idx, "csv", p, start, stop))
                idx += 1
        if not shards:
            raise ValueError(f"no data rows under {path!r} (the matched "
                             "CSV files hold headers only)")

        def read(shard: Shard) -> dict:
            lines = _read_lines_in_range(
                shard.path, shard.start, shard.stop,
                at_line_start=shard.start == len(headers[shard.path]))
            body = b"".join(lines)
            whole_file = (shard.start == len(headers[shard.path])
                          and shard.stop >= os.path.getsize(shard.path))
            # per-LINE parity, not whole-shard: a slice torn inside quoted
            # fields at BOTH ends has even total quotes but its first and
            # last fragment lines are each odd
            if not whole_file and any(ln.count(b'"') % 2 for ln in lines):
                # byte-range splitting assumes one record per physical line;
                # an odd quote count in a strict slice of the file means a
                # quoted field with an embedded newline (or a bare literal
                # quote) straddles a shard boundary — fail LOUD instead of
                # feeding a torn record fragment into training. A shard
                # covering the whole file can hold no torn record, so it
                # skips this check (lone literal quotes stay parseable).
                raise ValueError(
                    f"CSV shard {shard.target} cuts through a quoted "
                    "multi-line field (or the file holds bare literal "
                    "quotes); byte-range sharding needs one record per "
                    "line — raise shard_bytes past the file size (one "
                    "shard per file) or flatten embedded newlines")
            return _parse_csv(headers[shard.path] + body, shard.target)

        return cls(shards, read, retry_policy, name="csv")

    @classmethod
    def npy(cls, path: str, column: str = "features",
            shard_rows: int = DEFAULT_SHARD_ROWS,
            retry_policy: RetryPolicy | None = None) -> "ShardedSource":
        """``.npy`` file(s)/glob/dir -> row-range shards (mmap metadata only
        at build time; each shard materializes its own row slice)."""
        from ..io.files import resolve_input_paths

        paths = resolve_input_paths(path, ".npy", exts=(".npy",))
        shards, idx = [], 0
        for p in paths:
            n = np.load(p, mmap_mode="r").shape[0]
            for start in range(0, n, max(int(shard_rows), 1)):
                shards.append(Shard(idx, "npy", p, start, min(start + shard_rows, n)))
                idx += 1

        def read(shard: Shard) -> dict:
            mm = np.load(shard.path, mmap_mode="r")
            return {column: np.asarray(mm[shard.start:shard.stop])}

        return cls(shards, read, retry_policy, name="npy")

    @classmethod
    def image_dir(cls, path: str, recursive: bool = True,
                  shard_files: int = 256, drop_invalid: bool = True,
                  retry_policy: RetryPolicy | None = None) -> "ShardedSource":
        """Image directory -> shards of ``shard_files`` files each, decoded
        to the path/image/height/width/channels schema (PIL is imported
        when an image decodes)."""
        from ..image.unroll import decode_image_bytes
        from ..io.files import _IMAGE_EXTS, _resolve_paths

        files = _resolve_paths(path, recursive, _IMAGE_EXTS)
        if not files:
            raise FileNotFoundError(f"no image files under {path!r}")
        shard_files = max(int(shard_files), 1)
        shards = [Shard(i, "image", path, s, min(s + shard_files, len(files)))
                  for i, s in enumerate(range(0, len(files), shard_files))]

        def read(shard: Shard) -> dict:
            rows = []
            for p in files[shard.start:shard.stop]:
                with open(p, "rb") as f:
                    data = f.read()
                try:
                    arr = decode_image_bytes(data)
                except Exception:
                    if drop_invalid:
                        continue
                    rows.append({"path": os.path.abspath(p), "image": None,
                                 "height": 0, "width": 0, "channels": 0})
                    continue
                rows.append({"path": os.path.abspath(p), "image": arr,
                             "height": arr.shape[0], "width": arr.shape[1],
                             "channels": arr.shape[2]})
            return _columnar(rows)

        return cls(shards, read, retry_policy, name="image")


def _tabular_paths(path, what: str) -> list[str]:
    """``io.files.resolve_input_paths`` plus a streaming-only refinement:
    zero-byte files carry no shards, so they drop here. An explicit LIST of
    file paths bypasses globbing."""
    from ..io.files import resolve_input_paths

    if isinstance(path, (list, tuple)):
        missing = [p for p in path if not os.path.isfile(p)]
        if missing:
            raise FileNotFoundError(f"no such {what} file(s): {missing}")
        paths = [str(p) for p in path]
    else:
        paths = resolve_input_paths(path, what)
    return [p for p in paths if os.path.getsize(p) > 0]


def _n_rows(cols: dict) -> int:
    return len(next(iter(cols.values()))) if cols else 0


class MemorySource(ShardedSource):
    """In-memory data behind the sharded interface.

    Wraps a column dict or a ``core.DataFrame``. ``shard_rows=None`` keeps
    one shard per DataFrame partition (a dict is one shard); ``shard_rows``
    re-shards into fixed row windows, and a layout that matches another
    source's row for row gives the same batch stream under the same seed."""

    def __init__(self, data: Any, shard_rows: int | None = None,
                 retry_policy: RetryPolicy | None = None):
        from ..core.dataframe import DataFrame

        if isinstance(data, DataFrame):
            parts = [dict(p) for p in data.partitions]
        else:
            parts = [dict(data)]
        if shard_rows is not None:
            whole = {k: np.concatenate([np.asarray(p[k]) for p in parts])
                     for k in parts[0]} if parts else {}
            n = _n_rows(whole)
            parts = [{k: v[s:s + shard_rows] for k, v in whole.items()}
                     for s in range(0, max(n, 1), max(int(shard_rows), 1))]
        self._parts = [p for p in parts if _n_rows(p) > 0] or parts[:1]
        shards = [Shard(i, "memory", "", 0, _n_rows(p))
                  for i, p in enumerate(self._parts)]

        def read(shard: Shard) -> dict:
            return dict(self._parts[shard.index])

        super().__init__(shards, read, retry_policy, name="memory")
