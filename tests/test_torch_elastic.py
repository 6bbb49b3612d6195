"""synapseml_torch.data's ElasticPlan and ElasticStreamSet against
synapseml_tpu.data's.

The elastic cases of ``tests/test_gang.py:306-444`` run through each
package on the same ``MemorySource`` rows and seeds, and the batches'
row ids must be equal, batch by batch, member by member:

* 4 virtual streams consumed 3 batches each, then resumed on M = 1..4
  members: each member's batches equal the JAX package's, and the rows
  of the whole run are the dataset's two epochs, each row twice (none
  replayed, none skipped);
* a member serving 2 streams checkpointed after an odd batch count goes
  on with the interleaving of the uninterrupted run;
* streams of uneven length drain completely;
* a missing stream and one beyond ``orig_world`` raise the reference's
  errors, and the assignment of members beyond the streams is empty.
"""

import numpy as np
import pytest

from synapseml_torch import data as tdata
from synapseml_tpu import data as jdata

PKGS = {"jax": jdata, "torch": tdata}


def _ids(b):
    return tuple(np.asarray(b["idx"])[np.asarray(b["_valid"]) > 0].astype(int).tolist())


def _drain(set_, n=None):
    out = []
    try:
        while n is None or len(out) < n:
            out.append(_ids(next(set_)))
    except StopIteration:
        pass
    set_.close()
    return out


def _resume_on(pkg, new_world):
    """Per-member batches before the cut (4 members, 3 batches each) and
    after it (``new_world`` members)."""
    src = pkg.MemorySource({"idx": np.arange(240, dtype=np.int64)}, shard_rows=20)
    kw = dict(shuffle_rows="none", epochs=2, drop_remainder=False)
    plan = pkg.ElasticPlan.fresh(4, seed=5)
    before, host_states = [], {}
    for r in range(4):
        s = pkg.ElasticStreamSet(src, 8, plan, r, 4, **kw)
        before.append([_ids(next(s)) for _ in range(3)])
        host_states[r] = {"data_iter": s.state_for_batch(3)}
        s.close()
    resumed = pkg.ElasticPlan.from_host_states(4, host_states)
    after = [_drain(pkg.ElasticStreamSet(src, 8, resumed, j, new_world, **kw))
             for j in range(new_world)]
    return before, after, resumed


@pytest.mark.parametrize("new_world", [1, 2, 3, 4])
def test_n_to_m_resume_equals_the_jax_streams(new_world):
    jb, ja, jplan = _resume_on(jdata, new_world)
    tb, ta, tplan = _resume_on(tdata, new_world)
    assert tb == jb and ta == ja
    assert tplan.assignment(new_world) == jplan.assignment(new_world)
    rows = [r for member in tb + ta for batch in member for r in batch]
    assert sorted(rows) == sorted(list(range(240)) * 2)


def test_mid_cycle_resume_keeps_the_interleaving():
    got = {}
    for tag, pkg in PKGS.items():
        src = pkg.MemorySource({"idx": np.arange(160, dtype=np.int64)}, shard_rows=16)
        kw = dict(shuffle_rows="none", epochs=1, drop_remainder=False)
        ref = _drain(pkg.ElasticStreamSet(src, 8, pkg.ElasticPlan.fresh(2, seed=9), 0, 1, **kw))
        s1 = pkg.ElasticStreamSet(src, 8, pkg.ElasticPlan.fresh(2, seed=9), 0, 1, **kw)
        head = [_ids(next(s1)) for _ in range(5)]
        snap = {0: {"data_iter": s1.state_for_batch(5)}}
        s1.close()
        tail = _drain(pkg.ElasticStreamSet(src, 8, pkg.ElasticPlan.from_host_states(2, snap),
                                           0, 1, **kw))
        assert head + tail == ref
        got[tag] = ref
    assert got["torch"] == got["jax"]


def test_uneven_streams_drain_completely():
    for world in (1, 2):
        got = {}
        for tag, pkg in PKGS.items():
            # 7 shards over 2 streams: 4 against 3
            src = pkg.MemorySource({"idx": np.arange(140, dtype=np.int64)}, shard_rows=20)
            got[tag] = [_drain(pkg.ElasticStreamSet(src, 8, pkg.ElasticPlan.fresh(2, seed=3),
                                                    r, world, shuffle_rows="none", epochs=1,
                                                    drop_remainder=False))
                        for r in range(world)]
        assert got["torch"] == got["jax"]
        assert sorted(r for m in got["torch"] for b in m for r in b) == list(range(140))


def _raised(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


def test_missing_and_extra_streams_raise_as_the_reference():
    for pkg in PKGS.values():
        assert pkg.ElasticPlan.fresh(2, seed=0).assignment(3) == [[0], [1], []]
    cases = [
        lambda pkg: pkg.ElasticPlan.from_host_states(3, {
            0: {"data_iter": {"0": pkg.IteratorState(seed=1).to_tree()}},
            1: {"data_iter": {"1": pkg.IteratorState(seed=1).to_tree()}}}),
        lambda pkg: pkg.ElasticPlan.from_host_states(1, {
            0: {"data_iter": {"0": pkg.IteratorState(seed=1).to_tree(),
                              "1": pkg.IteratorState(seed=1).to_tree()}}}),
        lambda pkg: pkg.ElasticPlan(orig_world=2, states=[{}]),
        lambda pkg: pkg.ElasticPlan.fresh(2, seed=0).assignment(0),
        lambda pkg: pkg.ElasticStreamSet(pkg.MemorySource({"idx": np.arange(8)}), 4,
                                         pkg.ElasticPlan.fresh(1, seed=0), 1, 2),
    ]
    for case in cases:
        msgs = [_raised(lambda: case(pkg)) for pkg in PKGS.values()]
        assert msgs[0] == msgs[1]
    assert "missing cursors" in _raised(lambda: cases[0](tdata))
    assert "undercounts" in _raised(lambda: cases[1](tdata))
