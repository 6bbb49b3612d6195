"""synapseml_torch's data plane against the JAX package's.

The port's DataLoader over a MemorySource emits the JAX loader's batch
stream for the same seed, compared with ``array_equal`` as
``tests/test_data.py``'s determinism cases compare: every batch's arrays
and ``_valid``, the epoch reshuffle, a ``drop_remainder=False`` tail padded
to its ladder rung, ``shard_rows`` re-sharding over a 3-partition
DataFrame, host slices, and a mid-epoch resume from
``IteratorState.to_tree()``/``from_tree()``. The order functions, the
metrics registry and the read retry are held to the JAX package's too.
"""

import random
import threading

import numpy as np
import pytest

import synapseml_torch as pt
from synapseml_torch.core import observability as tobs
from synapseml_torch.core import resilience as tres
from synapseml_torch.data import DataLoader, IteratorState, MemorySource, Shard, ShardedSource
from synapseml_torch.data import state as tstate
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.core import observability as jobs
from synapseml_tpu.data import DataLoader as JDataLoader
from synapseml_tpu.data import IteratorState as JIteratorState
from synapseml_tpu.data import MemorySource as JMemorySource
from synapseml_tpu.data import state as jstate

N = 150


def _columns(n=N, seed=0):
    rs = np.random.default_rng(seed)
    return {"rid": np.arange(n, dtype=np.int64),
            "x": rs.normal(size=(n, 3)).astype(np.float32),
            "ids": rs.integers(0, 50, (n, 6)).astype(np.int32),
            "labels": rs.integers(0, 2, n).astype(np.int32)}


def _sources(num_partitions=3, shard_rows=None):
    cols = _columns()
    return (MemorySource(pt.DataFrame.from_dict(cols, num_partitions=num_partitions),
                         shard_rows=shard_rows),
            JMemorySource(JDataFrame.from_dict(cols, num_partitions=num_partitions),
                          shard_rows=shard_rows))


def _assert_same_stream(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert list(a) == list(b), i
        for k in a:
            assert a[k].dtype == np.asarray(b[k]).dtype, (i, k)
            assert np.array_equal(a[k], np.asarray(b[k])), (i, k)


_STREAM_CASES = {
    "two epochs, tail dropped": dict(epochs=2),
    "two epochs, tail padded to its rung": dict(epochs=2, drop_remainder=False),
    "window shuffle": dict(epochs=1, shuffle_rows="window", shuffle_window=7),
    "no shuffle": dict(epochs=1, shuffle_rows="none", shuffle_shards=False,
                       drop_remainder=False),
    "host 1 of 2": dict(epochs=2, host_index=1, host_count=2, drop_remainder=False),
    "multiple_of 8": dict(epochs=1, multiple_of=8, drop_remainder=False),
    "columns": dict(epochs=1, columns=["rid", "labels"]),
}


@pytest.mark.parametrize("case", sorted(_STREAM_CASES))
@pytest.mark.parametrize("layout", ["partitions", "shard_rows=40"])
def test_stream_matches_jax(case, layout):
    kw = dict(seed=7, **_STREAM_CASES[case])
    src, jsrc = _sources(shard_rows=40 if layout == "shard_rows=40" else None)
    assert src.num_shards == jsrc.num_shards == (3 if layout == "partitions" else 4)
    _assert_same_stream(DataLoader(src, 16, **kw), JDataLoader(jsrc, 16, **kw))


def test_tail_pads_to_its_rung_and_epochs_reshuffle():
    src, _ = _sources()
    batches = list(DataLoader(src, 32, seed=1, epochs=2, drop_remainder=False))
    # 150 rows: 4 full batches and a 22-row tail on the 32 rung, per epoch
    assert [len(b["rid"]) for b in batches] == [32] * 4 + [32] + [32] * 4 + [32]
    assert [int(b["_valid"].sum()) for b in batches] == [32] * 4 + [22] + [32] * 4 + [22]
    first = np.concatenate([b["rid"][b["_valid"] > 0] for b in batches[:5]])
    second = np.concatenate([b["rid"][b["_valid"] > 0] for b in batches[5:]])
    assert sorted(first) == sorted(second) == list(range(N))
    assert not np.array_equal(first, second)


@pytest.mark.parametrize("at", [1, 4, 6])
def test_resume_mid_epoch_matches_jax(at):
    src, jsrc = _sources(shard_rows=40)
    whole = list(DataLoader(src, 16, seed=3, epochs=2))
    loader = DataLoader(src, 16, seed=3, epochs=2)
    it = iter(loader)
    for _ in range(at):
        next(it)
    tree = loader.state_for_batch(at).to_tree()
    loader.close()
    jtree = jstate.IteratorState.from_tree(tree).to_tree()  # the JAX package reads it
    assert {k: np.asarray(v).tolist() for k, v in tree.items()} == \
        {k: np.asarray(v).tolist() for k, v in jtree.items()}
    resumed = DataLoader(src, 16, seed=3, epochs=2, state=IteratorState.from_tree(tree))
    jresumed = JDataLoader(jsrc, 16, seed=3, epochs=2, state=JIteratorState.from_tree(jtree))
    got = list(resumed)
    _assert_same_stream(got, jresumed)
    _assert_same_stream(got, whole[at:])


def test_resume_state_is_validated():
    src, _ = _sources()
    with pytest.raises(ValueError, match="seed"):
        DataLoader(src, 16, seed=1, state=IteratorState(seed=2))
    with pytest.raises(ValueError, match="shard layout"):
        DataLoader(src, 16, seed=1, state=IteratorState(seed=1, shard_counts=np.zeros(5, np.int64)))


def test_order_functions_match_jax():
    for seed, epoch in [(0, 0), (7, 3)]:
        for n in (1, 5, 40):
            assert np.array_equal(tstate.shard_order(seed, epoch, n),
                                  jstate.shard_order(seed, epoch, n))
            for mode in ("full", "window", "none"):
                assert np.array_equal(tstate.row_order(seed, epoch, 2, n, mode, 6),
                                      jstate.row_order(seed, epoch, 2, n, mode, 6))
    with pytest.raises(ValueError, match="shuffle_rows"):
        tstate.row_order(0, 0, 0, 5, "bogus")


def test_memory_source_layouts_match_jax():
    for kw in (dict(num_partitions=3), dict(num_partitions=3, shard_rows=64),
               dict(num_partitions=1, shard_rows=1000)):
        src, jsrc = _sources(**kw)
        assert [(s.index, s.kind, s.start, s.stop) for s in src.shards()] == \
            [(s.index, s.kind, s.start, s.stop) for s in jsrc.shards()]
        assert src.total_rows() == jsrc.total_rows() == N
        for (s, cols), (_, jcols) in zip(src.iter_shards(), jsrc.iter_shards()):
            assert all(np.array_equal(cols[k], jcols[k]) for k in cols)


def test_loader_errors_name_the_cause():
    cols = _columns(20)
    with pytest.raises(ValueError, match="drop_remainder"):
        list(DataLoader(MemorySource(cols), 32, epochs=1))
    bad = dict(cols, text=np.array(["a"] * 20, dtype=object))
    with pytest.raises(TypeError, match="object-dtype"):
        list(DataLoader(MemorySource(bad), 8, epochs=1))
    shards = [Shard(0, "custom", "", 0, 20), Shard(1, "custom", "", 0, 20)]
    drift = ShardedSource(shards, lambda s: cols if s.index == 0 else {"rid": cols["rid"]})
    with pytest.raises(ValueError, match="missing column"):
        list(DataLoader(drift, 8, epochs=1, shuffle_shards=False))


def test_loader_emits_metrics_and_spans():
    reg = tobs.reset_registry()
    tobs.get_tracer().clear()
    src, _ = _sources()
    loader = DataLoader(src, 16, seed=0, epochs=1)
    n = sum(int(b["_valid"].sum()) for b in loader)
    snap = reg.snapshot()
    assert snap['synapseml_data_rows_total{source="memory"}'] == n == 144
    # one wait per batch, and one for the end of the stream
    assert snap['synapseml_data_batch_wait_ms{source="memory"}']["count"] == 10
    assert snap['synapseml_data_shard_read_ms{source="memory"}']["count"] == 3
    assert loader.stats()["batches"] == 9
    assert sum(s.name == "data.prefetch" for s in tobs.get_tracer().finished_spans()) == 3


def test_close_wakes_a_blocked_consumer():
    gate = threading.Event()
    shards = [Shard(0, "custom", "", 0, 8)]
    slow = ShardedSource(shards, lambda s: (gate.wait(5), _columns(8))[1])
    loader = DataLoader(slow, 4, epochs=1, prefetch=1)
    out = []
    t = threading.Thread(target=lambda: out.append(list(loader)))
    t.start()
    loader.close()
    gate.set()
    t.join(10)
    assert not t.is_alive() and out == [[]]


def test_reads_retry_transient_errors_and_count_them():
    tres.reset_resilience_measures("data")
    calls = []

    def flaky(shard):
        calls.append(shard.index)
        if len(calls) < 3:
            raise OSError("transient")
        return _columns(8)

    policy = tres.RetryPolicy(backoffs_ms=(1, 1, 1), rng=random.Random(0))
    src = ShardedSource([Shard(0, "custom", "", 0, 8)], flaky, retry_policy=policy)
    assert len(src.read_shard(0)["rid"]) == 8
    assert tres.resilience_measures("data").to_dict()["retry_count"] == 2
    src = ShardedSource([Shard(0, "custom", "", 0, 8)],
                        lambda s: (_ for _ in ()).throw(OSError("down")),
                        retry_policy=tres.RetryPolicy(backoffs_ms=(1,)))
    with pytest.raises(OSError, match="down"):
        src.read_shard(0)


def test_retry_budget_bounds_retries():
    budget = tres.RetryBudget(max_tokens=2, deposit_per_success=0.5, initial_tokens=1)
    policy = tres.RetryPolicy(backoffs_ms=(10, 20), jitter=False, budget=budget)
    assert policy.max_attempts == 3 and policy.backoff_ms(0) == 10 and policy.backoff_ms(5) == 20
    assert policy.acquire_retry() and not policy.acquire_retry()
    policy.on_success(first_attempt=False)
    assert budget.tokens == 0
    policy.on_success()
    policy.on_success()
    assert budget.tokens == 1.0


def test_registry_snapshot_matches_jax():
    got, want = tobs.MetricsRegistry(), jobs.MetricsRegistry()
    for reg in (got, want):
        reg.counter("c_total", "c", ("k",)).inc(3, k="a")
        reg.gauge("g", "g").set(2.5)
        h = reg.histogram("h_ms", "h", ("k",))
        for v in (0.3, 4, 4, 70, 900, 1e6):
            h.observe(v, k="b")
    assert got.snapshot() == want.snapshot()
    with pytest.raises(ValueError, match="already registered"):
        got.gauge("c_total", "c", ("k",))
    with pytest.raises(ValueError, match="buckets"):
        got.histogram("h_ms", "h", ("k",), buckets=(1, 2))
    with pytest.raises(ValueError, match="only increase"):
        got.counter("c_total", "c", ("k",)).inc(-1, k="a")
    got.register_collector(lambda: iter([tobs.Sample("s", {"p": 1}, 4)]))
    assert got.snapshot()['s{p="1"}'] == 4.0


def test_handle_cache_follows_the_registry():
    cache = tobs.HandleCache(lambda reg: reg.counter("n_total"))
    first = cache.get()
    assert cache.get() is first
    tobs.reset_registry()
    assert cache.get() is not first and cache.get() is tobs.get_registry().counter("n_total")
