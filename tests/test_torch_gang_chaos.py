"""Gangs of real processes on the CPU through synapseml_torch.parallel.gang.

Each member is a fresh interpreter running ``run_gang_member`` over the
port's trainer (``tests/test_gang.py:686-938`` for the JAX package):

* SIGKILL one of four members after a committed step: the coordinator
  names it, the other three exit ``EXIT_RESIZE``; three members resume from
  the last verified commit, and their per-step losses and final tree
  (params and optimizer state) are bitwise those of an uninterrupted
  three-member run from a copy of the same checkpoint. The stream cursors
  sum to ``4·resume + 3·(total − resume)``, none below the resume step.
* SIGTERM to one of two members: both run the emergency-checkpoint dance
  and exit ``EXIT_PREEMPTED``; the committed step is the gang's sync step,
  newer than the last periodic one, and a relaunch finishes from it.
* A member printing far more than a pipe holds does not stall: the
  launcher drains every pipe from launch, and the gang completes.

Every wait is on the coordinator's events or the processes' exits.
"""

import json
import os
import shutil
import signal
import textwrap

import numpy as np
import pytest

from synapseml_torch.parallel import checkpoint as cp
from synapseml_torch.parallel.gang import (EXIT_PREEMPTED, EXIT_RESIZE, finish_gang_processes,
                                           launch_gang_processes)

TESTS = os.path.dirname(os.path.abspath(__file__))

GANG_WORKER = textwrap.dedent("""
    import json, sys, time

    import torch

    torch.set_num_threads(1)

    from _torch_gang_cases import TorchMLP, gang_rows
    from synapseml_torch.data import MemorySource
    from synapseml_torch.models.trainer import Trainer, TrainerConfig
    from synapseml_torch.parallel.gang import run_gang_member

    addr, part = sys.argv[1], int(sys.argv[2])
    ckdir, logp = sys.argv[3], sys.argv[4]
    total_steps, step_ms = int(sys.argv[5]), float(sys.argv[6])

    log = open(logp, "a")
    rank_box = []

    def trainer_fn(info):
        rank_box.append(info["rank"])
        return Trainer(TorchMLP(), TrainerConfig(total_steps=total_steps, learning_rate=1e-2),
                       device="cpu")

    def cb(i, metrics):
        log.write(json.dumps({"rank": rank_box[0], "loss": float(metrics["loss"])}) + "\\n")
        log.flush()
        if step_ms:
            time.sleep(step_ms / 1000.0)

    def on_exit(kind, payload):
        rec = {"rank": rank_box[0], "kind": kind}
        if kind == "preempted":
            rec["step"] = payload.step
        log.write(json.dumps(rec) + "\\n")

    code = run_gang_member(addr, part, trainer_fn=trainer_fn,
                           source=MemorySource(gang_rows(), shard_rows=64),
                           checkpoint_dir=ckdir, total_steps=total_steps, batch_size=16, seed=3,
                           checkpoint_every=4, grace_s=60.0, on_exit=on_exit, epochs=None,
                           shuffle_rows="none", callback=cb)
    log.close()
    sys.exit(code)
""")


def _env():
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/"),
            "PYTHONPATH": os.pathsep.join([TESTS, os.path.dirname(TESTS)]),
            "OMP_NUM_THREADS": "1"}


def _launch(tmp_path, tag, world, ckdir, total, step_ms, script_text=GANG_WORKER):
    script = tmp_path / f"worker_{tag}.py"
    script.write_text(script_text)
    logs = [str(tmp_path / f"log_{tag}_{p}.jsonl") for p in range(world)]
    procs, coord, _ = launch_gang_processes(
        str(script), world, checkpoint_dir=ckdir,
        worker_args_fn=lambda p, addr: [addr, str(p), ckdir, logs[p], str(total), str(step_ms)],
        env=_env(), coordinator_kw=dict(beat_timeout_s=60.0, grace_s=30.0, poll_s=0.05))
    return procs, coord, logs


def _losses(path):
    with open(path) as f:
        return [rec["loss"] for rec in map(json.loads, f) if "loss" in rec]


def _same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.chaos(timeout_s=180)
def test_sigkill_one_of_four_resumes_on_three(tmp_path):
    ckdir = str(tmp_path / "ck")
    os.makedirs(ckdir)
    # phase A: four members on a run far longer than it will get
    procs, coord, _ = _launch(tmp_path, "a", 4, ckdir, 400, step_ms=50)
    assert coord.wait_commit(step=8, timeout_s=90) == 8, coord.events()
    procs[2].send_signal(signal.SIGKILL)
    failure = coord.wait_failure(60.0)
    assert failure is not None and failure[0] == 2
    outs, codes = finish_gang_processes(procs, coord, timeout_s=90)
    assert codes[2] == -signal.SIGKILL
    assert [c for i, c in enumerate(codes) if i != 2] == [EXIT_RESIZE] * 3, (codes, outs)
    resume = cp.latest_verified_step(ckdir)
    assert resume is not None and resume >= 8 and cp.checkpoint_world(ckdir, resume) == 4
    total = resume + 12
    refdir = str(tmp_path / "ref")
    shutil.copytree(ckdir, refdir)

    # phase B: three survivors resume; phase C: three from the copy, uninterrupted
    runs = {}
    for tag, d in (("b", ckdir), ("c", refdir)):
        procs, coord, logs = _launch(tmp_path, tag, 3, d, total, step_ms=0)
        outs, codes = finish_gang_processes(procs, coord, timeout_s=90, wait_commit_step=total)
        assert codes == [0, 0, 0], (codes, outs)
        assert cp.latest_verified_step(d) == total
        runs[tag] = [_losses(p) for p in logs]
    assert runs["b"] == runs["c"] and all(len(x) == total - resume for x in runs["b"])
    _same_tree(cp.restore_checkpoint(ckdir, total), cp.restore_checkpoint(refdir, total))
    cursors = {}
    for tree in cp.restore_host_states(ckdir, total).values():
        cursors.update(tree["data_iter"])
    emitted = [int(np.asarray(c["batches_emitted"])) for c in cursors.values()]
    assert sorted(int(k) for k in cursors) == [0, 1, 2, 3]
    assert min(emitted) >= resume and sum(emitted) == 4 * resume + 3 * (total - resume)


@pytest.mark.chaos(timeout_s=180)
def test_sigterm_grace_window_emergency_checkpoint(tmp_path):
    ckdir = str(tmp_path / "ck")
    os.makedirs(ckdir)
    procs, coord, logs = _launch(tmp_path, "t", 2, ckdir, 400, step_ms=50)
    assert coord.wait_commit(step=4, timeout_s=90) == 4, coord.events()
    procs[1].send_signal(signal.SIGTERM)
    outs, codes = finish_gang_processes(procs, coord, timeout_s=120)
    assert codes == [EXIT_PREEMPTED, EXIT_PREEMPTED], (codes, outs)
    emergency = coord.preempt_commit_step
    sync = [e["step"] for e in coord.events() if e["event"] == "sync"]
    assert emergency is not None and emergency > 4 and sync == [emergency]
    assert cp.latest_verified_step(ckdir) == emergency and cp.checkpoint_world(ckdir, emergency) == 2
    for p in logs:
        with open(p) as f:
            assert [r for r in map(json.loads, f) if "kind" in r][-1]["step"] == emergency

    finish = emergency + 6
    procs, coord, _ = _launch(tmp_path, "r", 2, ckdir, finish, step_ms=0)
    outs, codes = finish_gang_processes(procs, coord, timeout_s=90, wait_commit_step=finish)
    assert codes == [0, 0], (codes, outs)
    assert cp.latest_verified_step(ckdir) == finish


@pytest.mark.chaos(timeout_s=120)
def test_chatty_worker_stdout_does_not_stall_gang(tmp_path):
    ckdir = str(tmp_path / "ck")
    os.makedirs(ckdir)
    total = 6
    chatty = GANG_WORKER.replace("def cb(i, metrics):",
                                 "def cb(i, metrics):\n    print('#' * 65536, flush=True)")
    assert chatty != GANG_WORKER
    procs, coord, _ = _launch(tmp_path, "chatty", 2, ckdir, total, 0, script_text=chatty)
    outs, codes = finish_gang_processes(procs, coord, timeout_s=90, wait_commit_step=total)
    assert codes == [0, 0], (codes, [o[-500:] for o in outs])
    # each member printed total x 64 KiB, far beyond a pipe's capacity
    assert all(len(o) >= total * 65536 for o in outs)
    assert cp.latest_verified_step(ckdir) == total
