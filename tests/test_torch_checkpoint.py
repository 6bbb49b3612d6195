"""The port's checkpoints against the JAX package's, on the same trees.

Mirrors of the JAX package's single-host checkpoint tests, run on
``synapseml_torch.parallel.checkpoint`` (``test_parallel.py:92,178,212,251``,
``test_gang.py:103,230,263,272,285``, ``test_continual.py:303``,
``test_data.py:521,594,694,819``), each also holding the layout to the JAX
package: a step the port writes restores through the JAX
``restore_checkpoint`` and the other way round, leaf for leaf, bitwise.
The trainer's kill/resume (checkpoint at step 8 of 12, a fresh trainer
resumed, 4 more steps) equals the uninterrupted fit bitwise, per step and
chunked; over a gloo world of 2 with ``zero_shard`` too. A step written by
a world of 4 (each rank its shards of a rule-placed ``bert_tiny`` tree)
restores on a world of 2 with another mesh: each rank's local shards are
its slices of the saved values, bitwise. DeepTextClassifier with
``mesh_config`` and ``checkpoint_dir`` over a world of 2 fits the
one-process params (1e-5) and leaves its last step for every rank.
"""

import os
import time

import numpy as np
import pytest
import torch

from _torch_rank_cases import Mlp, _bert_state
from _torch_ranks import spawn
from synapseml_torch import parallel as tp
from synapseml_torch.data import MemorySource
from synapseml_torch.models import trainer as tt
from synapseml_torch.parallel import checkpoint as cp
from synapseml_tpu.parallel import checkpoint as jcp


def _same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---- test_parallel.py -----------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "opt": {"mu": np.zeros(3)}}
    cp.save_checkpoint(str(tmp_path), tree, step=3)
    cp.save_checkpoint(str(tmp_path), {"w": tree["w"] + 1, "opt": {"mu": tree["opt"]["mu"] + 1}},
                       step=7)
    restored = cp.restore_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(restored["w"], tree["w"] + 1)
    np.testing.assert_array_equal(cp.restore_checkpoint(str(tmp_path), step=3)["opt"]["mu"],
                                  np.zeros(3))
    # the JAX package reads the port's steps, the port the JAX package's
    _same_tree(jcp.restore_checkpoint(str(tmp_path)), restored)
    jcp.save_checkpoint(str(tmp_path / "j"), tree, step=2)
    _same_tree(cp.restore_checkpoint(str(tmp_path / "j")), tree)
    # torch leaves save as their numpy values
    cp.save_checkpoint(str(tmp_path / "t"), {"w": torch.arange(4.0)}, step=1)
    np.testing.assert_array_equal(jcp.restore_checkpoint(str(tmp_path / "t"))["w"],
                                  np.arange(4.0, dtype=np.float32))


def test_async_checkpointer_overlap_retention_and_errors(tmp_path):
    path = str(tmp_path / "ckpts")
    tree = {"w": np.arange(8, dtype=np.float32), "b": np.float32(0.0)}
    with cp.AsyncCheckpointer(path, keep=2) as ck:
        for step in range(5):
            tree["w"] = tree["w"] + 1.0
            snap = {"w": tree["w"].copy(), "b": np.float32(step),
                    "t": torch.full((3,), float(step))}
            ck.save(snap, step)
            snap["w"][:] = -1  # mutated after save: the snapshot wins
            snap["t"].fill_(-1.0)
        ck.wait()
        assert cp.latest_step(path) == 4
        kept = sorted(d for d in os.listdir(path) if d.startswith("step_"))
        assert len(kept) == 2 and kept[-1].endswith("0000000004")
        restored = cp.restore_checkpoint(path)
        assert float(restored["b"]) == 4.0
        np.testing.assert_array_equal(restored["w"], np.arange(8, dtype=np.float32) + 5)
        np.testing.assert_array_equal(restored["t"], np.full(3, 4.0, np.float32))
    bad = cp.AsyncCheckpointer("/proc/definitely/not/writable", keep=1)
    bad.save({"x": np.zeros(2)}, 0)
    with pytest.raises(Exception):
        bad.wait()


def test_async_checkpointer_nonblocking_save_and_backpressure(tmp_path, monkeypatch):
    real_save = cp.save_checkpoint
    delay = 0.4

    def slow_save(path, tree, step=0, use_orbax=None, sharding=None):
        time.sleep(delay)
        return real_save(path, tree, step, use_orbax=use_orbax, sharding=sharding)

    monkeypatch.setattr(cp, "save_checkpoint", slow_save)
    tree = {"w": torch.zeros((64, 64)), "b": np.float32(1.0)}
    with cp.AsyncCheckpointer(str(tmp_path / "bp"), keep=10) as ck:
        t0 = time.perf_counter()
        fut0 = ck.save(tree, 0)
        assert time.perf_counter() - t0 < delay / 2
        t0 = time.perf_counter()
        ck.save(tree, 1)
        assert time.perf_counter() - t0 >= delay * 0.6  # waited out write 0
        assert fut0.done()
    assert cp.latest_step(str(tmp_path / "bp")) == 1
    np.testing.assert_array_equal(cp.restore_checkpoint(str(tmp_path / "bp"))["w"],
                                  np.zeros((64, 64)))


def test_async_checkpointer_error_surfaces_at_next_save():
    ck = cp.AsyncCheckpointer("/proc/definitely/not/writable", keep=1)
    ck.save({"x": np.zeros(2)}, 0)
    with pytest.raises(Exception):
        ck.save({"x": np.zeros(2)}, 1)


def test_use_orbax_maps_to_torch_distributed_checkpoint(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "opt": ({"mu": np.zeros(3)}, np.int64(4))}
    cp.save_checkpoint(str(tmp_path), tree, step=5, use_orbax=True)
    assert os.path.isdir(tmp_path / "step_0000000005" / "dcp")
    _same_tree(cp.restore_checkpoint(str(tmp_path)), tree)


# ---- test_gang.py: coordinated shards and retention --------------------------


def _row_chunk_fn(rank):
    def chunk_fn(name, leaf):
        if name == "params/w":
            arr = np.asarray(leaf)
            return [([rank, 0], [rank + 1, arr.shape[1]], arr[rank:rank + 1])]
        return None
    return chunk_fn


def _write_shards(mod, path, step, world=3):
    tree = {"params": {"w": np.arange(world * 4, dtype=np.float32).reshape(world, 4)},
            "step": np.int32(step),
            "opt": (np.ones(3, np.float32), {"mu": np.zeros(2, np.float32)})}
    for r in range(world):
        mod.save_checkpoint_shard(
            path, tree, step, process_index=r, process_count=world,
            host_tree={"data_iter": {str(r): {"epoch": np.int64(r)}}},
            meta={"orig_world": world} if r == 0 else None, chunk_fn=_row_chunk_fn(r))
    return tree


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_two_phase_commit_and_torn_shard(tmp_path, writer):
    d = str(tmp_path)
    tree = _write_shards(cp if writer == "port" else jcp, d, 7)
    assert cp.latest_step(d) is None
    with pytest.raises(cp.CheckpointCorrupt, match="torn multi-host"):
        cp.restore_checkpoint(d, step=7)
    assert cp.commit_checkpoint(d, 7, 3) is not None
    assert cp.checkpoint_world(d, 7) == 3 and cp.checkpoint_meta(d) == {"orig_world": 3}
    got = cp.restore_checkpoint(d)
    np.testing.assert_array_equal(got["params"]["w"], tree["params"]["w"])
    _same_tree(jcp.restore_checkpoint(d), got)
    hosts = cp.restore_host_states(d)
    assert sorted(hosts) == [0, 1, 2] and int(hosts[1]["data_iter"]["1"]["epoch"]) == 1
    payload = os.path.join(d, "step_0000000007", "state.shard00001-of-00003.npz")
    with open(payload, "rb") as f:
        raw = f.read()
    with open(payload, "wb") as f:
        f.write(raw[:-9])  # torn tail
    assert cp.latest_verified_step(d) is None
    with pytest.raises(cp.CheckpointCorrupt):
        cp.restore_checkpoint(d, step=7)


def test_commit_refuses_incomplete_and_fenced_ack_sets(tmp_path):
    d = str(tmp_path)
    tree = {"w": np.zeros(4, np.float32)}
    for r in (0, 2):
        cp.save_checkpoint_shard(d, tree, 5, process_index=r, process_count=3)
    assert cp.commit_checkpoint(d, 5, 3) is None
    cp.save_checkpoint_shard(d, tree, 5, process_index=1, process_count=3)
    assert cp.commit_checkpoint(d, 5, 3) is not None
    cp.save_checkpoint_shard(d, tree, 9, process_index=0, process_count=2, run_id="old")
    cp.save_checkpoint_shard(d, tree, 9, process_index=1, process_count=2, run_id="new")
    assert cp.commit_checkpoint(d, 9, 2, run_id="new") is None


def test_single_host_checkpoint_unchanged(tmp_path):
    d = str(tmp_path)
    cp.save_checkpoint(d, {"w": np.arange(3, dtype=np.float32)}, step=2)
    assert cp.checkpoint_world(d, 2) is None
    assert cp.restore_host_states(d) == {}
    assert cp.latest_verified_step(d) == 2


def _corrupt(path, step, name="state.npz"):
    with open(os.path.join(path, f"step_{step:010d}", name), "ab") as f:
        f.write(b"xx")


def test_gc_keeps_last_k_verified_never_newest(tmp_path):
    d, jd = str(tmp_path / "p"), str(tmp_path / "j")
    for path, mod in ((d, cp), (jd, jcp)):
        for step in range(1, 7):
            mod.save_checkpoint(path, {"w": np.full(2, step, np.float32)}, step=step)
        for s in (3, 6):
            _corrupt(path, s)
    assert cp.gc_checkpoints(d, keep=2) == jcp.gc_checkpoints(jd, keep=2) == [1, 2, 3]
    left = sorted(int(x.split("_")[1]) for x in os.listdir(d) if x.startswith("step_"))
    assert left == [4, 5, 6] and cp.latest_verified_step(d) == 5


def test_save_checkpoint_keep_param(tmp_path):
    d = str(tmp_path)
    for step in range(4):
        cp.save_checkpoint(d, {"w": np.zeros(2, np.float32)}, step=step, keep=2)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == [
        "step_0000000002", "step_0000000003"]


def test_checkpoint_sharding_defaults_to_verified(tmp_path):
    d = str(tmp_path)
    cp.save_checkpoint(d, {"w": np.zeros(2, np.float32)}, step=1, sharding={"digest": "old"})
    cp.save_checkpoint(d, {"w": np.zeros(2, np.float32)}, step=2, sharding={"digest": "new"})
    _corrupt(d, 2)
    assert cp.checkpoint_sharding(d)["digest"] == "old"
    assert jcp.checkpoint_sharding(d)["digest"] == "old"


def test_torn_newest_demotes_the_resume_point(tmp_path):
    d = str(tmp_path)
    cp.save_checkpoint(d, {"w": np.zeros(2, np.float32)}, step=4)
    cp.save_checkpoint(d, {"w": np.ones(2, np.float32)}, step=8)
    _corrupt(d, 8)
    assert cp.latest_verified_step(d) == jcp.latest_verified_step(d) == 4
    np.testing.assert_array_equal(cp.restore_checkpoint(d)["w"], np.zeros(2, np.float32))


# ---- the trainer: sidecars, kill/resume, loader state ----------------------


def _rows(n=96, seed=2):
    rs = np.random.default_rng(seed)
    return {"x": rs.normal(size=(n, 4)).astype(np.float32),
            "labels": (np.arange(n) % 3).astype(np.int32)}


def _trainer(total=12):
    torch.manual_seed(0)
    net = Mlp()
    return tt.Trainer(net, tt.TrainerConfig(total_steps=total, learning_rate=1e-2),
                      device="cpu")


def _fit(tmp_path, total=12, every=4, scan_chunk=1, keep=5, **kw):
    with cp.AsyncCheckpointer(str(tmp_path), keep=keep) as ck:
        return tt.fit_source(_trainer(12), MemorySource(_rows(), shard_rows=32),
                             batch_size=16, total_steps=total, seed=5, scan_chunk=scan_chunk,
                             checkpointer=ck, checkpoint_every=every, **kw)


def test_checkpoint_sidecar_verification_demotes(tmp_path):
    _fit(tmp_path, total=8)
    d = str(tmp_path)
    newest = cp.latest_step(d)
    assert newest == 8 and cp.verify_checkpoint(d, newest)
    with open(os.path.join(d, f"step_{newest:010d}", "state.npz"), "r+b") as f:
        f.seek(80)
        f.write(b"\xff\xff\xff\xff")
    assert not cp.verify_checkpoint(d, newest)
    demoted = cp.latest_verified_step(d)
    assert demoted == 4
    assert int(np.asarray(cp.restore_checkpoint(d)["step"])) == demoted
    with pytest.raises(cp.CheckpointCorrupt):
        cp.restore_checkpoint(d, step=newest)
    with open(os.path.join(d, f"step_{demoted:010d}", "state.tree.json"), "a") as f:
        f.write("garbage")
    assert cp.latest_verified_step(d) is None


@pytest.mark.parametrize("scan_chunk", [1, 8])
def test_fit_source_kill_resume_equals_uninterrupted(tmp_path, scan_chunk):
    full = tt.fit_source(_trainer(), MemorySource(_rows(), shard_rows=32), batch_size=16,
                         total_steps=12, seed=5, scan_chunk=scan_chunk)
    _fit(tmp_path, total=8, scan_chunk=scan_chunk)  # "killed" after step 8
    tree = cp.restore_checkpoint(str(tmp_path), step=8)
    assert "data_iter" in tree
    t = _trainer()
    state = t.resume_state(tree["params"], tree["opt_state"], step=int(tree["step"]))
    res = tt.fit_source(t, MemorySource(_rows(), shard_rows=32), batch_size=16,
                        total_steps=12, seed=5, scan_chunk=scan_chunk, state=state,
                        data_state=tree["data_iter"])
    again = tt.fit_source(_trainer(), MemorySource(_rows(), shard_rows=32), batch_size=16,
                          total_steps=12, seed=5, scan_chunk=scan_chunk,
                          resume_from=str(tmp_path))
    assert res.step == again.step == full.step == 12
    for s in (res, again):
        for name in full.params:
            assert torch.equal(full.params[name], s.params[name]), name
        for a, b in zip(full.opt_state.mu + full.opt_state.nu, s.opt_state.mu + s.opt_state.nu):
            assert torch.equal(a, b)


def test_large_scan_chunk_checkpoints_keep_data_iter(tmp_path):
    _fit(tmp_path, total=40, every=8, scan_chunk=16)
    for step in (32, 40):
        assert "data_iter" in cp.restore_checkpoint(str(tmp_path), step=step)


def test_fit_source_resume_requires_explicit_data_state(tmp_path):
    _fit(tmp_path, total=8)
    tree = cp.restore_checkpoint(str(tmp_path), step=8)
    t = _trainer()
    state = t.resume_state(tree["params"], tree["opt_state"], step=int(tree["step"]))
    with pytest.raises(ValueError, match="data_state"):
        tt.fit_source(t, MemorySource(_rows(), shard_rows=32), batch_size=16, total_steps=12,
                      seed=5, state=state)
    res = tt.fit_source(t, MemorySource(_rows(), shard_rows=32), batch_size=16,
                        total_steps=12, seed=5, state=state, data_state="fresh")
    assert res.step == 12


def test_resume_from_an_empty_directory_starts_fresh(tmp_path):
    s = tt.fit_source(_trainer(), MemorySource(_rows(), shard_rows=32), batch_size=16,
                      total_steps=4, seed=5, resume_from=str(tmp_path / "none"))
    assert s.step == 4


def test_async_checkpointer_gc_prunes_stale_partials(tmp_path):
    root = tmp_path / "ck"
    partial = root / "step_0000000001"
    os.makedirs(partial)
    np.savez(partial / "state.npz", w=np.zeros(2))
    with cp.AsyncCheckpointer(str(root), keep=2) as ck:
        for step in (2, 3, 4):
            ck.save({"w": np.full(2, step)}, step=step)
            ck.wait()
    assert cp.latest_step(str(root)) == 4
    assert sorted(os.listdir(root)) == ["step_0000000003", "step_0000000004"]


# ---- across worlds ------------------------------------------------------------


def test_world4_save_restores_on_world2(tmp_path):
    path = str(tmp_path / "ck")
    spawn("_torch_rank_cases:ckpt_write_suite", 4, tmp_path / "w4", path=path)
    assert cp.latest_step(path) is None  # phase 1 only
    assert cp.commit_checkpoint(path, 7, 4, run_id="r1") is not None
    assert cp.checkpoint_meta(path) == {"orig_world": 4}
    _, state = _bert_state(seed=3)
    whole = cp.restore_checkpoint(path)
    for name, arr in state.items():
        assert np.array_equal(whole["params"][name], arr), name
    ranks = spawn("_torch_rank_cases:ckpt_read_suite", 2, tmp_path / "r2", path=path)
    rules = tp.default_transformer_rules(tp.MeshConfig(data=1, fsdp=2))
    for r, got in enumerate(ranks):
        assert int(got["step"]) == 7
        np.testing.assert_array_equal(got["cursors"], [[q, 10 + q] for q in range(4)])
        for name, arr in state.items():
            assert np.array_equal(got[f"full/{name}"], arr), name
            spec = rules.spec_for(name, arr.shape)
            want = arr
            if spec and spec[-1] == "fsdp" or (len(spec) > 1 and spec[1] == "fsdp"):
                d = [i for i, e in enumerate(spec) if e == "fsdp"][0]
                n = arr.shape[d] // 2
                want = np.take(arr, range(r * n, (r + 1) * n), axis=d)
            assert np.array_equal(got[f"local/{name}"], want), (r, name)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawn of two ranks for the mesh fits below."""
    d = tmp_path_factory.mktemp("resume2")
    return spawn("_torch_rank_cases:resume_suite", 2, d / "w2", path=str(d / "ck"))


def test_mesh_kill_resume_with_zero_equals_uninterrupted(world2):
    ranks = world2
    for got in ranks:
        assert tuple(got["steps"]) == (12, 12)
        names = [k[len("full/"):] for k in got if k.startswith("full/")]
        for name in names:
            assert np.array_equal(got[f"full/{name}"], got[f"resumed/{name}"]), name
        for k in [k for k in got if k.startswith("mu_full/")]:
            assert np.array_equal(got[k], got[k.replace("mu_full", "mu_resumed")])
    for name in [k for k in ranks[0] if k.startswith("full/")]:
        assert np.array_equal(ranks[0][name], ranks[1][name])


def test_stage_fit_on_a_mesh_with_checkpoints(world2):
    """DeepTextClassifier with ``mesh_config`` (data=2, gloo) and
    ``checkpoint_dir``: rank 0 writes, every rank sees the final step after
    the fit, and the params equal the one-process fit's within 1e-5 (f32;
    the gradient summed in another order) but the attention key bias, whose
    exact gradient is 0: both train it on rounding noise, at most lr a step
    each (learning rate 1e-3, 4 steps)."""
    for got in world2:
        assert int(got["stage/steps"][0]) == 4
        names = [k[len("stage/plain/"):] for k in got if k.startswith("stage/plain/")]
        assert names
        for name in names:
            atol = 2 * 1e-3 * 4 if name.endswith("attn.k.bias") else 1e-5
            np.testing.assert_allclose(got[f"stage/mesh/{name}"], got[f"stage/plain/{name}"],
                                       atol=atol, rtol=0, err_msg=name)
