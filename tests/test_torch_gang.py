"""synapseml_torch.parallel.gang against synapseml_tpu.parallel.gang.

The protocol runs over real TCP (``DriverRendezvous`` with keep-alive, the
members' ``worker_rendezvous`` in threads), the coordinator from one
package and the workers from the other or the same: torch/torch,
torch workers under a JAX coordinator and JAX workers under a torch one.
Each scenario is run by the JAX package alone too, and the driver's events,
verdicts, commits and member status must be the same:

* beats move the per-rank step and the ``synapseml_train_gang_*`` series;
  a member whose connection drops (no ``bye``) is dead at once and the
  survivor reads ``resize`` (``tests/test_gang.py:487``);
* a member that stops beating on a live socket is dead after the missed-beat
  deadline (``:530``);
* the preemption dance commits at the gang's sync step, the larger of two
  members' steps, each member writing its shard with its own package and
  the driver committing with its own (``:551``);
* the fault plan's gang hooks through ``GangWorker.heartbeat``: dropped
  beats, a delayed beat, a kill at a step (``:447``).

Then the trainer's seam (``:598``): ``Trainer.fit(gang=)`` raises
``GangAborted`` on ``resize``, and on a sync verdict trains to the sync
step, writes the shard, acks and raises ``Preempted(5)``. ``fit_gang_source``
at a world of one, in process and under a live coordinator, against the
JAX one on the same rows with the Flax init bridged: per-step losses within
1e-5, the same commits and stream cursors, final params within 1e-5; then a
JAX-written coordinated checkpoint (that fit's, and a 2-rank one)
``elastic_restore``s in the port to the same step, plan and tree, and each
package's resume of its own gang checkpoint gives the same losses.
"""

import os
import shutil
import socket
import threading
import time

import numpy as np
import pytest
import torch

from _torch_gang_cases import TorchMLP, bridge, flax_init, flax_mlp, gang_rows, unbridge
from synapseml_torch.core import faults as tfaults
from synapseml_torch.core import observability as tobs
from synapseml_torch.core import resilience as tres
from synapseml_torch.data import MemorySource as TSource
from synapseml_torch.models import trainer as tt
from synapseml_torch.parallel import backend as tbackend
from synapseml_torch.parallel import checkpoint as tcp
from synapseml_torch.parallel import gang as tgang
from synapseml_tpu.core import faults as jfaults
from synapseml_tpu.core import observability as jobs
from synapseml_tpu.core import resilience as jres
from synapseml_tpu.parallel import backend as jbackend
from synapseml_tpu.parallel import checkpoint as jcp
from synapseml_tpu.parallel import gang as jgang

PKGS = {"jax": dict(backend=jbackend, gang=jgang, cp=jcp, faults=jfaults, obs=jobs, res=jres),
        "torch": dict(backend=tbackend, gang=tgang, cp=tcp, faults=tfaults, obs=tobs, res=tres)}
# (coordinator's package, workers' package)
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]


class _Gang:
    """A gang of ``world`` members over real TCP: the coordinator of
    ``coord`` over a ``DriverRendezvous`` of that package, the workers of
    ``worker`` registered with their package's ``worker_rendezvous``."""

    def __init__(self, coord: str, worker: str, world: int, ckdir=None, **coord_kw):
        self.c, self.w = PKGS[coord], PKGS[worker]
        driver = self.c["backend"].DriverRendezvous(world_size=world, keep_alive=True).start()
        addr = f"127.0.0.1:{driver.port}"
        replies = {}

        def register(p):
            replies[p] = self.w["backend"].worker_rendezvous(addr, f"exec-{p}", p,
                                                             timeout_s=30, keep_alive=True)

        threads = [threading.Thread(target=register, args=(p,)) for p in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        driver.join(30)
        kw = dict(beat_timeout_s=30.0, grace_s=10.0, poll_s=0.02)
        kw.update(coord_kw)
        self.coord = self.c["gang"].GangCoordinator(driver.conns, checkpoint_dir=ckdir,
                                                    run_id=driver.run_id, **kw).start()
        self.workers = sorted(
            (self.w["gang"].GangWorker(sock, info["rank"], info["world"], grace_s=10.0,
                                       run_id=info["run_id"]).start()
             for info, sock in replies.values()), key=lambda g: g.rank)
        assert [g.run_id for g in self.workers] == [driver.run_id] * world

    def close(self):
        self.coord.close()
        for g in self.workers:
            try:
                g.sock.close()
            except OSError:
                pass


def _until(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _both(scenario, pair, *args):
    """The scenario under the JAX package alone and under ``pair``: equal."""
    want = scenario("jax", "jax", *args)
    got = scenario(*pair, *args)
    assert got == want
    return got


# ---------------------------------------------------------------- protocol


def _beats_then_eof(coord, worker, _):
    h = _Gang(coord, worker, 2)
    try:
        for step in range(1, 4):
            for g in h.workers:
                g.heartbeat(step)
        assert _until(lambda: all(s["last_step"] == 3 for s in h.coord.status().values()))
        snap = h.c["obs"].get_registry().snapshot()
        gauges = sorted({k.split("{")[0] for k in snap if k.startswith("synapseml_train_gang_")})
        aborts = h.c["res"].resilience_measures("parallel").to_dict().get("gang_abort_count", 0)
        # rank 1's process dies: its socket goes without a bye
        h.workers[1].sock.shutdown(socket.SHUT_RDWR)
        h.workers[1].sock.close()
        failure = h.coord.wait_failure(5.0)
        assert _until(lambda: h.workers[0].check(4) == "resize")
        moved = h.c["res"].resilience_measures("parallel").to_dict()["gang_abort_count"] - aborts
        return {"failure": failure, "events": h.coord.events(), "gauges": gauges,
                "aborts": moved, "alive": h.coord.alive_ranks()}
    finally:
        h.close()


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_beats_gauges_and_eof_failure(pair):
    got = _both(_beats_then_eof, pair, None)
    assert got["failure"] == (1, "connection lost") and got["aborts"] == 1
    assert "synapseml_train_gang_step_latency_ms" in got["gauges"]
    assert "synapseml_train_gang_beats_total" in got["gauges"]


def _missed_beats(coord, worker, _):
    h = _Gang(coord, worker, 2, beat_timeout_s=1.0)
    try:
        missed = h.c["res"].resilience_measures("parallel").to_dict().get(
            "beats_missed_count", 0)
        # only rank 0 beats; rank 1's socket stays open
        deadline = time.monotonic() + 5
        while h.coord.failure is None and time.monotonic() < deadline:
            h.workers[0].heartbeat(1)
            time.sleep(0.05)
        assert _until(lambda: h.workers[0].check(1) == "resize")
        moved = h.c["res"].resilience_measures("parallel").to_dict()["beats_missed_count"] - missed
        return {"failure": h.coord.failure, "events": h.coord.events(), "missed": moved}
    finally:
        h.close()


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_missed_beats_trigger_resize(pair):
    got = _both(_missed_beats, pair, None)
    assert got["failure"][0] == 1 and got["missed"] == 1


def _dance(coord, worker, tmp_path):
    d = str(tmp_path / f"{coord}-{worker}")
    os.makedirs(d)
    h = _Gang(coord, worker, 2, ckdir=d)
    steps = {0: 5, 1: 7}  # rank 1 is ahead: the sync step is 7
    results = {}

    def member(rank):
        g, step = h.workers[rank], steps[rank]
        if rank == 0:
            g.preempt()  # what the SIGTERM hook does
        while True:
            g.heartbeat(step)
            v = g.check(step)
            if v == "resize":
                results[rank] = ("resize", step)
                return
            if isinstance(v, tuple):
                step = max(step, v[1])  # train on to the sync step
                h.w["cp"].save_checkpoint_shard(
                    d, {"w": np.full(2, rank, np.float32)}, step, process_index=rank,
                    process_count=2, host_tree={"data_iter": {str(rank): {"s": np.int64(1)}}},
                    run_id=g.run_id)
                results[rank] = ("preempted" if g.ack_and_wait_commit(step) else "resize", step)
                return
            time.sleep(0.02)

    threads = [threading.Thread(target=member, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    try:
        # the commit scanner may commit the step before the dance does:
        # which of the two wrote DONE is a race, the commit is not
        events = [e for e in h.coord.events() if e["event"] != "committed"]
        return {"results": results, "commit": h.coord.preempt_commit_step,
                "committed": sorted(set(h.coord.committed_steps)), "events": events,
                "verified": tcp.latest_verified_step(d), "jax_verified": jcp.latest_verified_step(d),
                "hosts": sorted(tcp.restore_host_states(d)),
                "tree": tcp.restore_checkpoint(d)["w"].tolist()}
    finally:
        h.close()


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_preempt_dance_commits_at_the_sync_step(pair, tmp_path):
    got = _both(_dance, pair, tmp_path)
    assert got["results"] == {0: ("preempted", 7), 1: ("preempted", 7)}
    assert got["commit"] == got["verified"] == got["jax_verified"] == 7
    assert got["hosts"] == [0, 1] and got["tree"] == [0.0, 0.0]  # rank 0's whole leaf
    assert [e["event"] for e in got["events"]] == ["preempt_notice", "verdict", "sync"]


def _fault_hooks(coord, worker, _):
    h = _Gang(coord, worker, 2)
    faults = h.w["faults"]
    specs = [faults.FaultSpec("drop", planes=("gang",), match="rank=1", times=2),
             faults.FaultSpec("latency", planes=("gang",), match="rank=0:step=2",
                              latency_ms=50, times=1),
             faults.FaultSpec("crash", planes=("gang",), match="step=9", times=1)]
    try:
        with faults.inject_faults(specs, seed=11) as plan:
            seen = []
            for step in (1, 2, 3):
                t0 = time.perf_counter()
                h.workers[0].heartbeat(step)
                delayed = time.perf_counter() - t0 >= 0.05
                h.workers[1].heartbeat(step)
                # rank 1's first two beats are dropped: from step 3 on it lands too
                assert _until(lambda: h.coord.status()[0]["last_step"] == step and (
                    step < 3 or h.coord.status()[1]["last_step"] == step))
                seen.append((delayed, h.coord.status()[1]["last_step"]))
            with pytest.raises(ConnectionResetError):
                h.workers[0].heartbeat(9)  # the kill at step 9
        assert _until(lambda: h.coord.status()[1]["last_step"] == 3)
        return {"seen": seen, "injected": [(p, k) for p, k, _ in plan.injected],
                "status": h.coord.status()}
    finally:
        h.close()


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_fault_plan_gang_drop_delay_and_kill_at_step(pair):
    got = _both(_fault_hooks, pair, None)
    # rank 1's first two beats dropped; rank 0's step-2 beat delayed
    assert [s for _, s in got["seen"]] == [-1, -1, 3] and got["seen"][1][0]
    assert got["injected"] == [("gang", "drop"), ("gang", "latency"), ("gang", "drop"),
                               ("gang", "crash")]


# ---------------------------------------------------------------- trainer seam


class FakeGang:
    def __init__(self, verdict_at, verdict):
        self.verdict_at, self.verdict = verdict_at, verdict
        self.beats, self.acked = [], None

    def heartbeat(self, step):
        self.beats.append(int(step))

    def check(self, step):
        if step >= self.verdict_at:
            return "resize" if self.verdict == "resize" else ("sync", step + 2)
        return None

    def ack_and_wait_commit(self, step):
        self.acked = int(step)
        return True


def _batches():
    rs = np.random.default_rng(0)
    batch = {"x": rs.normal(size=(8, 4)).astype(np.float32),
             "labels": rs.integers(0, 2, 8).astype(np.int32)}
    while True:
        yield dict(batch)


def _tiny_trainer(total=50):
    return tt.Trainer(TorchMLP(), tt.TrainerConfig(total_steps=total), device="cpu")


def test_trainer_fit_gang_abort_and_preempt(tmp_path):
    tr = _tiny_trainer()
    g = FakeGang(3, "resize")
    with pytest.raises(tgang.GangAborted):
        tr.fit(tr.init_state(), _batches(), max_steps=50, gang=g)
    assert g.beats == [0, 1, 2, 3]  # the beat before the first step, then one a step

    tr2 = _tiny_trainer()
    ck = tcp.AsyncCheckpointer(str(tmp_path), process_index=0, process_count=1,
                               coordinated=True)
    g2 = FakeGang(3, "sync")
    with pytest.raises(tgang.Preempted) as ei:
        tr2.fit(tr2.init_state(), _batches(), max_steps=50, gang=g2, checkpointer=ck,
                checkpoint_every=100)
    ck.close()
    assert ei.value.step == 5 and g2.acked == 5 and g2.beats[-1] == 5
    # the shard landed; the driver commits it
    assert tcp.commit_checkpoint(str(tmp_path), 5, 1) is not None
    assert tcp.latest_verified_step(str(tmp_path)) == 5 == jcp.latest_verified_step(str(tmp_path))
    assert int(tcp.restore_checkpoint(str(tmp_path))["step"]) == 5


# ---------------------------------------------------------------- fit_gang_source

TOTAL, EVERY, BATCH, SEED = 12, 4, 16, 3


def _jax_trainer(total):
    import jax

    from synapseml_tpu.models.trainer import Trainer, TrainerConfig
    from synapseml_tpu.parallel.mesh import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:1])
    return Trainer(flax_mlp(), mesh, TrainerConfig(total_steps=total, learning_rate=1e-2))


def _torch_trainer(total):
    return tt.Trainer(TorchMLP(), tt.TrainerConfig(total_steps=total, learning_rate=1e-2),
                      device="cpu")


def _gang_fit(tag: str, ckdir: str, total: int, init):
    """One member's fit_gang_source under a live coordinator of the same
    package; returns the per-step losses, the commits and the final state."""
    from synapseml_tpu.data import MemorySource as JSource
    from synapseml_tpu.models.trainer import fit_gang_source as jfit

    pkg = PKGS[tag]
    h = _Gang(tag, tag, 1, ckdir=ckdir)
    losses = []
    try:
        fit = jfit if tag == "jax" else tt.fit_gang_source
        trainer = _jax_trainer(total) if tag == "jax" else _torch_trainer(total)
        src = (JSource if tag == "jax" else TSource)(gang_rows(512), shard_rows=64)
        state = fit(trainer, src, batch_size=BATCH, total_steps=total, seed=SEED,
                    gang=h.workers[0], checkpoint_dir=ckdir, rank=0, world=1,
                    checkpoint_every=EVERY, init_params=init,
                    callback=lambda i, m: losses.append(float(m["loss"])))
        assert h.coord.wait_commit(step=total, timeout_s=15) == total
        return {"losses": losses, "commits": sorted(set(h.coord.committed_steps)),
                "state": state,
                "cursors": pkg["cp"].restore_host_states(ckdir, total)[0]["data_iter"]}
    finally:
        h.workers[0].close("done")
        h.close()


@pytest.fixture(scope="module")
def gang_fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("gang_fit")
    init = flax_init(SEED)
    out = {}
    for tag in ("jax", "torch"):
        d = str(root / tag)
        os.makedirs(d)
        out[tag] = dict(_gang_fit(tag, d, TOTAL, init if tag == "jax" else bridge(init)),
                        dir=d)
    out["root"] = root
    return out


def _same_cursors(a, b):
    assert set(a) == set(b)
    for sid in a:
        assert set(a[sid]) == set(b[sid])
        for k in a[sid]:
            np.testing.assert_array_equal(np.asarray(a[sid][k]), np.asarray(b[sid][k]))


def test_fit_gang_source_world_one_equals_the_jax_fit(gang_fits):
    j, t = gang_fits["jax"], gang_fits["torch"]
    assert len(t["losses"]) == len(j["losses"]) == TOTAL
    np.testing.assert_allclose(t["losses"], j["losses"], atol=1e-5)
    assert t["commits"] == j["commits"] == [4, 8, 12]
    _same_cursors(t["cursors"], j["cursors"])
    got = unbridge(t["state"].params)
    for layer in ("fc1", "fc2"):
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][k], np.asarray(j["state"].params[layer][k]),
                                       atol=1e-5)


def test_elastic_restore_of_jax_written_checkpoints(gang_fits, tmp_path):
    d = gang_fits["jax"]["dir"]
    want, got = jgang.elastic_restore(d), tgang.elastic_restore(d)
    assert got.step == want.step == TOTAL and got.meta == want.meta
    assert got.plan.orig_world == want.plan.orig_world == 1
    _same_cursors(dict(enumerate(got.plan.states)), dict(enumerate(want.plan.states)))
    for layer in ("fc1", "fc2"):
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(got.tree["params"][layer][k],
                                          np.asarray(want.tree["params"][layer][k]))
    # a coordinated step of two JAX ranks, each with its row of one leaf
    d2 = str(tmp_path / "two")
    w = np.arange(8, dtype=np.float32).reshape(2, 4)
    for r in range(2):
        jcp.save_checkpoint_shard(
            d2, {"params": {"w": w}, "step": np.int64(6)}, 6, process_index=r, process_count=2,
            host_tree={"data_iter": {str(r): {"epoch": np.int64(0), "rows_emitted": np.int64(r),
                                              "batches_emitted": np.int64(6),
                                              "seed": np.int64(1),
                                              "shard_counts": np.full(0, -1, np.int64)}}},
            meta={"orig_world": 2} if r == 0 else None,
            chunk_fn=lambda name, leaf, r=r: ([([r, 0], [r + 1, 4], np.asarray(leaf)[r:r + 1])]
                                              if name == "params/w" else None))
    assert jcp.commit_checkpoint(d2, 6, 2) is not None
    want, got = jgang.elastic_restore(d2), tgang.elastic_restore(d2)
    assert got.step == want.step == 6 and got.plan.assignment(1) == [[0, 1]]
    np.testing.assert_array_equal(got.tree["params"]["w"], w)
    _same_cursors(dict(enumerate(got.plan.states)), dict(enumerate(want.plan.states)))


def test_gang_resume_equals_the_jax_resume(gang_fits):
    """A copy of each package's gang checkpoint, resumed by that package to
    16 steps: the same 4 losses within 1e-5, and the same cursors."""
    root = gang_fits["root"]
    out = {}
    for tag in ("jax", "torch"):
        d = str(root / f"resume_{tag}")
        shutil.copytree(gang_fits[tag]["dir"], d)
        out[tag] = _gang_fit(tag, d, TOTAL + 4, None)
    assert len(out["torch"]["losses"]) == 4
    np.testing.assert_allclose(out["torch"]["losses"], out["jax"]["losses"], atol=1e-5)
    _same_cursors(out["torch"]["cursors"], out["jax"]["cursors"])
    assert out["torch"]["state"].step == TOTAL + 4


def test_fit_gang_source_refuses_a_world_beyond_the_streams_and_a_single_host_dir(tmp_path):
    one = str(tmp_path / "one")
    tcp.save_checkpoint(one, {"params": {}, "step": np.int64(1)}, step=1)
    with pytest.raises(ValueError, match="single-host checkpoint"):
        tt.fit_gang_source(_torch_trainer(4), TSource(gang_rows(64)), batch_size=8,
                           total_steps=4, seed=0, gang=FakeGang(99, "resize"),
                           checkpoint_dir=one, rank=0, world=1)
    two = str(tmp_path / "two")
    trainer = _torch_trainer(2)
    tt.fit_gang_source(trainer, TSource(gang_rows(64)), batch_size=8, total_steps=2, seed=0,
                       gang=FakeGang(99, "resize"), checkpoint_dir=two, rank=0, world=1,
                       checkpoint_every=2)
    assert tcp.commit_checkpoint(two, 2, 1) is not None
    with pytest.raises(ValueError, match="exceeds the run's frozen stream count"):
        tt.fit_gang_source(_torch_trainer(4), TSource(gang_rows(64)), batch_size=8,
                           total_steps=4, seed=0, gang=FakeGang(99, "resize"),
                           checkpoint_dir=two, rank=0, world=2)


def test_stream_exhausted_early_warns(tmp_path, caplog):
    import logging

    with caplog.at_level(logging.WARNING, logger="synapseml_torch.models.trainer"):
        out = tt.fit_gang_source(_torch_trainer(20), TSource(gang_rows(64), shard_rows=32),
                                 batch_size=16, total_steps=20, seed=0,
                                 gang=FakeGang(99, "resize"), checkpoint_dir=str(tmp_path),
                                 rank=0, world=1, epochs=1)
    assert out.step == 4
    assert any("gang_stream_exhausted_early" in r.message for r in caplog.records)
