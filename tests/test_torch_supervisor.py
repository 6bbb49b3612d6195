"""synapseml_torch.continual's TrainSupervisor against synapseml_tpu.continual's.

The supervisor cases of ``tests/test_continual.py:400-555`` and
``tests/test_gang.py:662``, each package supervising its own trainer on
the same rows, with the Flax init bridged into the port:

* an injected crash at step 5 restarts the fit once from the latest
  verified checkpoint; the final params are bitwise the uninterrupted
  run's, and within 1e-5 of the JAX package's supervised run;
* a NaN batch raises, the supervisor rewinds, and the skip window equals
  the JAX supervisor's on the same seeded poison; the params come out
  finite and within 1e-5 of the JAX run's;
* preemptions and resizes resume on their own budget, as the JAX
  supervisor counts them;
* a subprocess trainer SIGKILLed mid-fit resumes to the uninterrupted
  run's params bitwise; a wedged one is hang-killed and restarted. The
  watchdog's clock starts at launch (the reference's semantics), so its
  timeout is set well above a loaded interpreter's start-up.
"""

import os
import sys

import numpy as np
import pytest

from _torch_gang_cases import TorchMLP, bridge, flax_init, flax_mlp, unbridge
from synapseml_torch import continual as tcont
from synapseml_torch.core import faults as tfaults
from synapseml_torch.core import resilience as tres
from synapseml_torch.data import MemorySource as TSource
from synapseml_torch.models import trainer as tt
from synapseml_torch.parallel import checkpoint as tcp
from synapseml_torch.parallel import gang as tgang
from synapseml_tpu import continual as jcont
from synapseml_tpu.core import faults as jfaults
from synapseml_tpu.core import resilience as jres
from synapseml_tpu.data import MemorySource as JSource
from synapseml_tpu.models import trainer as jt
from synapseml_tpu.parallel import checkpoint as jcp
from synapseml_tpu.parallel import gang as jgang

TESTS = os.path.dirname(os.path.abspath(__file__))
N_CLASSES = 3
PKGS = {"jax": dict(cont=jcont, faults=jfaults, res=jres, src=JSource, tr=jt, cp=jcp, gang=jgang),
        "torch": dict(cont=tcont, faults=tfaults, res=tres, src=TSource, tr=tt, cp=tcp,
                      gang=tgang)}
_W_TRUE = np.random.default_rng(3).normal(size=(4,))


def make_rows(n, seed):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 4)).astype(np.float32)
    y = np.digitize(X @ _W_TRUE, np.quantile(X @ _W_TRUE, [1 / 3, 2 / 3])).astype(np.int32)
    return X, y


def _trainer(tag, steps, lr=0.05):
    if tag == "torch":
        return tt.Trainer(TorchMLP(N_CLASSES), tt.TrainerConfig(
            total_steps=steps, learning_rate=lr, nonfinite_action="raise"), device="cpu")
    import jax

    from synapseml_tpu.parallel.mesh import MeshConfig, create_mesh

    return jt.Trainer(flax_mlp(N_CLASSES), create_mesh(MeshConfig(), devices=jax.devices()[:1]),
                      jt.TrainerConfig(total_steps=steps, learning_rate=lr,
                                       nonfinite_action="raise"))


def _fit(tag, ckdir, att, X, y, steps, every, seed, shard_rows=32, **kw):
    pkg = PKGS[tag]
    init = flax_init(11, N_CLASSES)
    with pkg["cp"].AsyncCheckpointer(str(ckdir), keep=10) as ck:
        return pkg["tr"].fit_source(
            _trainer(tag, steps), pkg["src"]({"x": X, "labels": y}, shard_rows=shard_rows),
            batch_size=16, total_steps=steps, seed=seed, scan_chunk=1,
            init_params=init if tag == "jax" else bridge(init), checkpointer=ck,
            checkpoint_every=every, resume_from=str(ckdir), skip_fn=att.skip_fn,
            callback=lambda i, m: att.heartbeat(i), **kw)


def _params(tag, state) -> dict:
    if tag == "torch":
        return unbridge(state.params)
    return {layer: {k: np.asarray(v) for k, v in leaves.items()}
            for layer, leaves in state.params.items()}


def _close(a, b, atol):
    for layer in ("fc1", "fc2"):
        for k in ("kernel", "bias"):
            if atol == 0:
                np.testing.assert_array_equal(a[layer][k], b[layer][k])
            else:
                np.testing.assert_allclose(a[layer][k], b[layer][k], atol=atol)


class _NoopAttempt:
    skip_fn = None
    resume = False

    def heartbeat(self, step):
        pass


@pytest.mark.chaos
def test_crash_restart_bitwise_the_clean_run(tmp_path):
    X, y = make_rows(96, 9)
    got = {}
    for tag, pkg in PKGS.items():
        ref = _fit(tag, tmp_path / f"{tag}_ref", _NoopAttempt(), X, y, 12, 3, 9)
        sup = pkg["cont"].TrainSupervisor(str(tmp_path / f"{tag}_sup"), max_restarts=2)
        r0 = pkg["res"].resilience_measures("training").to_dict().get("retry_count", 0)
        with pkg["faults"].inject_faults([pkg["faults"].FaultSpec(
                "crash", match="step:5", times=1, planes=("training",))]) as plan:
            state = sup.run(lambda att: _fit(tag, tmp_path / f"{tag}_sup", att, X, y, 12, 3, 9))
        assert sup.restarts == 1 and len(plan.injected) == 1 and int(state.step) == 12
        assert pkg["res"].resilience_measures("training").to_dict()["retry_count"] == r0 + 1
        _close(_params(tag, ref), _params(tag, state), atol=0)
        got[tag] = _params(tag, state)
    _close(got["torch"], got["jax"], atol=1e-5)


@pytest.mark.chaos
def test_nan_rewind_skip_window_equals_the_jax_supervisor(tmp_path):
    X, y = make_rows(128, 10)
    X[96:112] = np.nan  # shard 6 of 8 poisons exactly one batch
    got = {}
    for tag, pkg in PKGS.items():
        sup = pkg["cont"].TrainSupervisor(str(tmp_path / tag), max_restarts=1, max_rewinds=2)
        state = sup.run(lambda att: _fit(tag, tmp_path / tag, att, X, y, 8, 2, 0,
                                         shard_rows=16, shuffle_rows="none"))
        assert sup.rewinds == 1 and sup.restarts == 0 and int(state.step) == 8
        params = _params(tag, state)
        assert all(np.isfinite(v).all() for leaves in params.values() for v in leaves.values())
        got[tag] = (list(sup.skip_windows), params)
    assert got["torch"][0] == got["jax"][0]
    lo, hi = got["torch"][0][0]
    assert 0 <= lo < hi <= 8
    _close(got["torch"][1], got["jax"][1], atol=1e-5)


def test_preempt_budget_equals_the_jax_supervisor(tmp_path):
    got = {}
    for tag, pkg in PKGS.items():
        calls = []

        def attempt_fn(attempt, gang=pkg["gang"]):
            calls.append(attempt.index)
            if len(calls) == 1:
                raise gang.Preempted(12)
            if len(calls) == 2:
                raise gang.GangAborted("resize")
            return "ok"

        sup = pkg["cont"].TrainSupervisor(str(tmp_path / tag), max_restarts=0, max_preempts=4)
        out = sup.run(attempt_fn)
        sup2 = pkg["cont"].TrainSupervisor(str(tmp_path / tag), max_restarts=0, max_preempts=1)
        calls.clear()
        with pytest.raises(pkg["gang"].GangAborted):
            sup2.run(attempt_fn)  # the second preemption exhausts a budget of 1
        got[tag] = (out, sup.preempts, sup.restarts, list(calls), sup2.preempts)
    assert got["torch"] == got["jax"] == ("ok", 2, 0, [0, 1], 1)


_CHILD = r"""
import os, signal, sys, time
import numpy as np
import torch

torch.set_num_threads(1)

from _torch_gang_cases import TorchMLP
from synapseml_torch.data import MemorySource
from synapseml_torch.models.trainer import Trainer, TrainerConfig, fit_source
from synapseml_torch.parallel.checkpoint import AsyncCheckpointer, latest_verified_step

ckdir, mode, marker = sys.argv[1], sys.argv[2], sys.argv[3]
r = np.random.default_rng(9)
X = r.normal(size=(96, 4)).astype(np.float32)
y = (np.arange(96) % 3).astype(np.int32)
t = Trainer(TorchMLP(3), TrainerConfig(total_steps=16, learning_rate=0.05), device="cpu")
base = latest_verified_step(ckdir) or 0

def cb(i, m):
    if mode != "clean" and not os.path.exists(marker) and base + i == 6:
        with open(marker, "w") as f:
            f.write("hit")
        if mode == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(3600)  # mode == "hang": wedge without dying

with AsyncCheckpointer(ckdir, keep=10) as ck:
    fit_source(t, MemorySource({"x": X, "labels": y}, shard_rows=32), batch_size=16,
               total_steps=16, seed=9, scan_chunk=1, checkpointer=ck, checkpoint_every=3,
               resume_from=ckdir, callback=cb)
"""

# the watchdog's clock starts at launch: far above a loaded start-up
HANG_TIMEOUT_S = 25.0


@pytest.mark.chaos(timeout_s=150)
def test_subprocess_sigkill_and_hang_watchdog(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([TESTS, os.path.dirname(TESTS)]))

    def run(mode):
        ckdir = tmp_path / mode
        sup = tcont.TrainSupervisor(str(ckdir), max_restarts=2, hang_timeout_s=HANG_TIMEOUT_S,
                                    poll_s=0.2)
        attempts = sup.run_subprocess([sys.executable, str(script), str(ckdir), mode,
                                       str(tmp_path / f"{mode}.marker")], env=env, timeout_s=120)
        return sup, attempts, tcp.restore_checkpoint(str(ckdir), step=16)

    _, attempts, clean = run("clean")
    assert attempts == 1
    for mode in ("kill", "hang"):
        sup, attempts, got = run(mode)
        assert attempts == 2 and sup.restarts == 1, mode
        assert os.path.exists(tmp_path / f"{mode}.marker")
        for k in clean["params"]:
            np.testing.assert_array_equal(got["params"][k], clean["params"][k])
