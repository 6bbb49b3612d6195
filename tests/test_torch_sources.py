"""synapseml_torch's on-disk sources and fault injection against the JAX package's.

The same files (jsonl, csv, npy, images) written from a seed go through
the JAX ``ShardedSource`` constructors and the port's: shards, columns and
dtypes bitwise (the port parses CSV without pandas, typing columns as
pandas does), ``estimate_rows`` and ``total_rows`` equal, the retry counts
under ``inject_faults`` equal, and the ``DataLoader`` batch stream over
the files bitwise the JAX loader's. The error cases of ``tests/test_data.py``
(a torn multi-line quote, header-only files, schema drift, empty byte-range
shards) raise or skip on both sides alike.
"""

import json

import numpy as np
import pytest

from synapseml_torch.core import FaultPlan, FaultSpec, active_fault_plan, inject_faults
from synapseml_torch.core.resilience import RetryPolicy, reset_resilience_measures, \
    resilience_measures
from synapseml_torch.data import DataLoader, ShardedSource
from synapseml_torch.data.source import _parse_csv, _parse_numeric_csv
from synapseml_tpu.core import faults as jfaults
from synapseml_tpu.core.resilience import reset_resilience_measures as jreset
from synapseml_tpu.core.resilience import resilience_measures as jmeasures
from synapseml_tpu.data import DataLoader as JDataLoader
from synapseml_tpu.data import ShardedSource as JShardedSource


def _write_jsonl(d, n_files=3, rows_per=40, seed=0):
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n_files * rows_per, 4)).astype(np.float32)
    for i in range(n_files):
        with open(d / f"part-{i:03d}.jsonl", "w") as f:
            for j in range(rows_per):
                rid = i * rows_per + j
                row = {"x": X[rid].tolist(), "labels": int(rid % 3), "rid": rid}
                if rid % 7 == 0:
                    row["extra"] = float(rid) / 3  # heterogeneous records
                f.write(json.dumps(row) + "\n")


def _write_csv(path, n=90, seed=1):
    rs = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("i,x,y,name,flag,maybe\n")
        for i in range(n):
            x, y = rs.normal(), rs.normal() * 1e-3
            name = f'"q, {i}"' if i % 5 == 0 else f"n{i}"
            maybe = "" if i % 4 == 0 else f"{rs.normal():.6f}"
            f.write(f"{i},{x!r},{y:.17g},{name},{'True' if i % 2 else 'False'},{maybe}\n")


def _assert_same_shards(src, jsrc):
    assert src.num_shards == jsrc.num_shards
    assert [(s.kind, s.path, s.start, s.stop) for s in src.shards()] == \
        [(s.kind, s.path, s.start, s.stop) for s in jsrc.shards()]
    for (_, got), (_, want) in zip(src.iter_shards(), jsrc.iter_shards()):
        assert list(got) == list(want)
        for k in want:
            a, b = got[k], np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
            if a.dtype == object:
                assert all(type(u) is type(v) and (u == v or (u != u and v != v))
                           for u, v in zip(a, b)), k
            else:
                assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


@pytest.mark.parametrize("shard_bytes", [64, 700, 1 << 30])
def test_jsonl_shards_match_jax(tmp_path, shard_bytes):
    _write_jsonl(tmp_path)
    pattern = str(tmp_path / "*.jsonl")
    src = ShardedSource.jsonl(pattern, shard_bytes=shard_bytes)
    jsrc = JShardedSource.jsonl(pattern, shard_bytes=shard_bytes)
    _assert_same_shards(src, jsrc)
    assert src.estimate_rows() == jsrc.estimate_rows()
    assert src.total_rows() == jsrc.total_rows() == 120


@pytest.mark.parametrize("shard_bytes", [97, 500, 1 << 30])
def test_csv_shards_match_pandas_typing(tmp_path, shard_bytes):
    p = tmp_path / "t.csv"
    _write_csv(p)
    (tmp_path / "empty.csv").write_text("")  # a zero-byte file carries no shards
    src = ShardedSource.csv(str(tmp_path / "*.csv"), shard_bytes=shard_bytes)
    jsrc = JShardedSource.csv(str(tmp_path / "*.csv"), shard_bytes=shard_bytes)
    _assert_same_shards(src, jsrc)
    assert src.estimate_rows() == jsrc.estimate_rows()
    assert src.total_rows() == jsrc.total_rows() == 90


def test_csv_float_text_reads_as_pandas_reads_it():
    """pandas' default float converter is not correctly rounded for long
    digit strings; the port's reader gives its bits, not float()'s."""
    pd = pytest.importorskip("pandas")
    import io

    rs = np.random.default_rng(2)
    vals = rs.normal(size=3000) * 10.0 ** rs.integers(-12, 12, 3000)
    fmts = [repr, lambda v: f"{v:.17g}", lambda v: f"{v:.20f}", lambda v: f"{v:.25e}",
            lambda v: str(np.float32(v))]
    strs = [fmts[i % len(fmts)](float(v)) for i, v in enumerate(vals)]
    strs += ["1e400", "-1e-700", "-0.0", "1e-400", "-1e-310", ".5", "+3.25", "1E5", "inf",
             "-Infinity"]
    text = "a\n" + "\n".join(strs) + "\n"
    want = pd.read_csv(io.StringIO(text))["a"].to_numpy()
    got = _parse_csv(text.encode(), "t")["a"]
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert sum(float(s) != w for s, w in zip(strs, want)) > 100  # not float()'s bits


def test_numeric_csv_fast_path_matches_jax(tmp_path):
    """A body of plain decimal fields takes numpy's parser, to the same bits
    and dtypes (int64 for columns without a point) as pandas."""
    rs = np.random.default_rng(6)
    p = tmp_path / "n.csv"
    with open(p, "w") as f:
        f.write("a,b,c,d\n")
        for i in range(400):
            f.write(f"{rs.normal():.7f},{rs.integers(-50, 50)},+{rs.random():.9f},"
                    f"{'-0' if i % 9 == 0 else rs.integers(0, 9)}.{rs.integers(0, 99)}\n")
    head, _, body = p.read_bytes().partition(b"\n")
    assert _parse_numeric_csv(head.decode().split(","), body) is not None
    for shard_bytes in (1500, 1 << 30):
        _assert_same_shards(ShardedSource.csv(str(p), shard_bytes=shard_bytes),
                            JShardedSource.csv(str(p), shard_bytes=shard_bytes))


def test_csv_torn_quote_bare_quotes_and_header_only(tmp_path):
    p = tmp_path / "q.csv"
    with open(p, "w") as f:
        f.write("a,b\n")
        for i in range(6):
            f.write(f'{i},"line one\nline two number {i}"\n')
    for cls in (ShardedSource, JShardedSource):
        with pytest.raises(ValueError, match="quoted multi-line"):
            for _ in cls.csv(str(p), shard_bytes=20).iter_shards():
                pass
    _assert_same_shards(ShardedSource.csv(str(p), shard_bytes=1 << 20),
                        JShardedSource.csv(str(p), shard_bytes=1 << 20))
    q = tmp_path / "bare.csv"
    q.write_text('h,w\n5\'10",170\n6\'1",190\n')
    _assert_same_shards(ShardedSource.csv(str(q), shard_bytes=1 << 20),
                        JShardedSource.csv(str(q), shard_bytes=1 << 20))
    h = tmp_path / "h.csv"
    h.write_text("a,b\n")
    for cls in (ShardedSource, JShardedSource):
        with pytest.raises(ValueError, match="headers only"):
            cls.csv(str(h))
    with pytest.raises(TypeError, match="sep"):  # no pandas options: no pandas
        ShardedSource.csv(str(q), sep=";")


def test_npy_and_image_sources_match_jax(tmp_path):
    np.save(tmp_path / "x.npy", np.arange(60, dtype=np.float32).reshape(20, 3))
    np.save(tmp_path / "y.npy", np.arange(14, dtype=np.int64).reshape(7, 2))
    src = ShardedSource.npy(str(tmp_path / "*.npy"), column="x", shard_rows=6)
    jsrc = JShardedSource.npy(str(tmp_path / "*.npy"), column="x", shard_rows=6)
    _assert_same_shards(src, jsrc)
    assert src.total_rows() == jsrc.total_rows() == 27
    assert src.estimate_rows() == jsrc.estimate_rows() == 27

    PIL = pytest.importorskip("PIL.Image")
    img = tmp_path / "img"
    img.mkdir()
    for i in range(5):
        PIL.new("RGB" if i % 2 else "L", (4 + i, 3), color=(i, 0, 0) if i % 2 else i).save(
            img / f"{i}.png")
    (img / "broken.png").write_bytes(b"not a png")
    for drop in (True, False):
        src = ShardedSource.image_dir(str(img), shard_files=2, drop_invalid=drop)
        jsrc = JShardedSource.image_dir(str(img), shard_files=2, drop_invalid=drop)
        assert src.estimate_rows() == jsrc.estimate_rows() == 6
        assert src.total_rows() == jsrc.total_rows() == (5 if drop else 6)
        for (_, got), (_, want) in zip(src.iter_shards(), jsrc.iter_shards()):
            assert list(got) == list(want)
            for k in ("path", "height", "width", "channels"):
                assert list(got[k]) == list(want[k]), k
            for a, b in zip(got["image"], want["image"]):
                assert (a is None and b is None) or np.array_equal(a, b)


def test_empty_byte_range_shards_and_schema_drift(tmp_path):
    with open(tmp_path / "part-big.jsonl", "w") as f:
        f.write(json.dumps({"x": [0.0] * 500, "labels": 0, "rid": 40}) + "\n")
        f.write(json.dumps({"x": [1.0] * 500, "labels": 1, "rid": 41}) + "\n")
    src = ShardedSource.jsonl(str(tmp_path / "*.jsonl"), shard_bytes=256)
    jsrc = JShardedSource.jsonl(str(tmp_path / "*.jsonl"), shard_bytes=256)
    _assert_same_shards(src, jsrc)
    assert any(not cols for _, cols in src.iter_shards())
    with open(tmp_path / "b.jsonl", "w") as f:
        for i in range(10):
            f.write(json.dumps({"y": float(i), "labels": 0}) + "\n")
    src = ShardedSource.jsonl(str(tmp_path / "*.jsonl"))
    with pytest.raises(ValueError, match="missing column"):
        list(DataLoader(src, 4, seed=0, epochs=1, shuffle_shards=False,
                        drop_remainder=False, host_index=0, host_count=1))
    with pytest.raises(ValueError, match="JSONL files are all empty"):
        (tmp_path / "e").mkdir()
        (tmp_path / "e" / "z.jsonl").write_text("")
        ShardedSource.jsonl(str(tmp_path / "e" / "*.jsonl"))


_LOADER_CASES = {
    "two epochs": dict(epochs=2),
    "tail padded": dict(epochs=1, drop_remainder=False),
    "host 1 of 2": dict(epochs=2, host_index=1, host_count=2, drop_remainder=False),
}


def _file_sources(d, kind):
    if kind == "jsonl":
        _write_jsonl(d)
        return (ShardedSource.jsonl(str(d / "*.jsonl"), shard_bytes=900),
                JShardedSource.jsonl(str(d / "*.jsonl"), shard_bytes=900), ["x", "labels", "rid"])
    np.save(d / "arr.npy", np.random.default_rng(3).normal(size=(50, 2)))
    return (ShardedSource.npy(str(d / "arr.npy"), column="x", shard_rows=9),
            JShardedSource.npy(str(d / "arr.npy"), column="x", shard_rows=9), ["x"])


@pytest.mark.parametrize("kind", ["jsonl", "npy"])
@pytest.mark.parametrize("case", sorted(_LOADER_CASES))
def test_loader_stream_over_files_matches_jax(tmp_path, case, kind):
    src, jsrc, columns = _file_sources(tmp_path, kind)
    kw = dict(seed=7, columns=columns, **_LOADER_CASES[case])
    got, want = list(DataLoader(src, 16, **kw)), list(JDataLoader(jsrc, 16, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == np.asarray(b[k]).dtype
            assert np.array_equal(a[k], np.asarray(b[k])), k


def test_fault_plan_matches_jax_and_reads_retry(tmp_path):
    """The port's copy of core/faults.py draws the JAX plan's sequence; the
    source retries injected read errors under its policy and counts them as
    the JAX source does."""
    specs = dict(kind="connection_error", probability=0.5, times=3, planes=("data",))
    plan, jplan = FaultPlan([FaultSpec(**specs)], seed=4), \
        jfaults.FaultPlan([jfaults.FaultSpec(**specs)], seed=4)
    outcomes = []
    for p in (plan, jplan):
        seq = []
        for i in range(12):
            try:
                p.on_read(f"t{i}")
                seq.append(0)
            except ConnectionRefusedError:
                seq.append(1)
        outcomes.append((seq, p.injected, p.fired(0)))
    assert outcomes[0] == outcomes[1] and sum(outcomes[0][0]) == 3

    _write_jsonl(tmp_path)
    counts = []
    for cls, inject, spec, reset, measures in (
            (ShardedSource, inject_faults, FaultSpec, reset_resilience_measures,
             resilience_measures),
            (JShardedSource, jfaults.inject_faults, jfaults.FaultSpec, jreset, jmeasures)):
        reset("data")
        src = cls.jsonl(str(tmp_path / "*.jsonl"), shard_bytes=900,
                        retry_policy=RetryPolicy(backoffs_ms=(1, 1, 1), jitter=False)
                        if cls is ShardedSource else None)
        if cls is JShardedSource:
            from synapseml_tpu.core.resilience import RetryPolicy as JRetry

            src.retry_policy = JRetry(backoffs_ms=(1, 1, 1), jitter=False)
        with inject([spec("connection_error", times=2, planes=("data",))]) as plan:
            rows = sum(len(c["rid"]) for _, c in src.iter_shards())
        m = measures("data").to_dict()
        counts.append((rows, len(plan.injected), m["retry_count"], m["faults_injected_count"]))
    assert counts[0] == counts[1] == (120, 2, 2, 2)
    assert active_fault_plan() is None
    src = ShardedSource.jsonl(str(tmp_path / "*.jsonl"),
                              retry_policy=RetryPolicy(backoffs_ms=(1,), jitter=False))
    with inject_faults([FaultSpec("connection_error", planes=("data",))]):
        with pytest.raises(ConnectionRefusedError):
            src.read_shard(0)
        with pytest.raises(RuntimeError, match="already active"):
            with inject_faults([]):
                pass
