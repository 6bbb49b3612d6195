"""synapseml_torch.continual's ContinualLoop against synapseml_tpu.continual's.

The loop cases of ``tests/test_continual.py:557-806``. Each package runs
its own loop over the same hand-written log parts, with a ``train_fn``
that warm-starts its trainer's fit of the small MLP from prod's params
(the Flax layout, bridged into the port) under the loop's supervisor, and
the same numpy ``eval_fn``. The records must be equal: ``outcome``,
``trigger``, ``parts``, ``quarantined``, ``train_rows``, the supervisor's
counts and the published version, the gate's metrics within 1e-5:

* clean parts promote; poisoned train parts fail the gate with prod and
  the published versions untouched;
* not due, then due on a drift gauge;
* a fault at each seam ends that iteration as ``error:<seam>`` with prod's
  alias and params byte-identical; ``raise_errors`` re-raises; a clean
  iteration then promotes.

End to end on the port, as ``tests/test_continual.py:689``: a live fleet
of two worker processes serves v1 behind the front, a ``RequestLogger``
logs 240 labelled requests; iteration 1 survives a crash mid-fit (one
restart), its candidate bitwise an uninterrupted reference iteration's, is
canaried, promoted, and served by both workers; iteration 2, fed poison,
fails the gate with prod and a probe's reply bytes unchanged; iteration 3
passes the gate, regresses the canary's p95 and is rolled back.
"""

import dataclasses
import json
import os
import urllib.request

import numpy as np
import pytest

from _torch_gang_cases import MLPScorer, TorchMLP, bridge, flax_init, flax_mlp, numpy_forward
from _torch_gang_cases import unbridge
from synapseml_torch import continual as tcont
from synapseml_torch.core import faults as tfaults
from synapseml_torch.core import observability as tobs
from synapseml_torch.data import MemorySource as TSource
from synapseml_torch.models import trainer as tt
from synapseml_torch.parallel import checkpoint as tcp
from synapseml_torch.registry import Deployment, ModelRegistry
from synapseml_tpu import continual as jcont
from synapseml_tpu.core import faults as jfaults
from synapseml_tpu.core import observability as jobs
from synapseml_tpu.core.params import ComplexParam as JComplexParam
from synapseml_tpu.core.pipeline import Transformer as JTransformer
from synapseml_tpu.data import MemorySource as JSource
from synapseml_tpu.models import trainer as jt
from synapseml_tpu.parallel import checkpoint as jcp
from synapseml_tpu.registry import ModelRegistry as JModelRegistry

pytestmark = pytest.mark.continual

TESTS = os.path.dirname(os.path.abspath(__file__))
D_IN, N_CLASSES = 4, 3
_W_TRUE = np.random.default_rng(3).normal(size=(D_IN,))


class JMLPScorer(JTransformer):
    """The JAX twin of ``_torch_gang_cases.MLPScorer``."""

    params = JComplexParam("params", "weights in the Flax layout", default=None)

    def _transform(self, df):
        W = self.get("params")

        def per_part(p):
            out = dict(p)
            out["reply"] = np.asarray([{"pred": int(np.argmax(numpy_forward(
                W, np.asarray(b["x"], dtype=np.float32)[None, :])))} for b in p["body"]],
                dtype=object)
            return out

        return df.map_partitions(per_part)


PKGS = {"jax": dict(cont=jcont, faults=jfaults, obs=jobs, reg=JModelRegistry, scorer=JMLPScorer,
                    tr=jt, src=JSource, cp=jcp),
        "torch": dict(cont=tcont, faults=tfaults, obs=tobs, reg=ModelRegistry, scorer=MLPScorer,
                      tr=tt, src=TSource, cp=tcp)}


def make_rows(n, seed, poison=False):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, D_IN)).astype(np.float32)
    y = np.digitize(X @ _W_TRUE, np.quantile(X @ _W_TRUE, [1 / 3, 2 / 3])).astype(np.int32)
    if poison:
        y = r.integers(0, N_CLASSES, size=n).astype(np.int32)
    return X, y


def write_part(logdir, idx, Xp, yp, garbage=0, drop_y=0):
    """One committed log part in the layout RequestLogger writes."""
    name = f"part-{idx:05d}.jsonl"
    with open(os.path.join(logdir, name), "w") as f:
        for i in range(len(Xp)):
            body = {"x": [float(v) for v in Xp[i]]}
            if i >= drop_y:
                body["y"] = int(yp[i])
            f.write(json.dumps({"ts": 0, "method": "POST", "path": "/", "status": 200,
                                "latency_ms": 1.0, "body": body, "reply": {}}) + "\n")
        for _ in range(garbage):
            f.write("{torn json!!\n")
    with open(os.path.join(logdir, name + ".DONE"), "w") as f:
        json.dump({"rows": len(Xp)}, f)
    return name


def row_fn(record):
    b = record["body"]
    return {"x": np.asarray(b["x"], dtype=np.float32), "labels": np.int32(b["y"])}


def eval_fn(stage, holdout):
    """Mean NLL of the scorer on the held-out slice (lower is better)."""
    logits = numpy_forward(stage.get("params"), holdout["x"].astype(np.float32))
    z = logits - logits.max(-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    return float(-logp[np.arange(len(logits)), holdout["labels"].astype(int)].mean())


def _trainer(tag, steps):
    if tag == "torch":
        return tt.Trainer(TorchMLP(N_CLASSES), tt.TrainerConfig(
            total_steps=steps, learning_rate=0.05, nonfinite_action="raise"), device="cpu")
    import jax

    from synapseml_tpu.parallel.mesh import MeshConfig, create_mesh

    return jt.Trainer(flax_mlp(N_CLASSES), create_mesh(MeshConfig(), devices=jax.devices()[:1]),
                      jt.TrainerConfig(total_steps=steps, learning_rate=0.05,
                                       nonfinite_action="raise"))


def _flax_params(tag, state) -> dict:
    if tag == "torch":
        return unbridge(state.params)
    return {layer: {k: np.asarray(v) for k, v in leaves.items()}
            for layer, leaves in state.params.items()}


def make_train_fn(tag, total_steps=30, batch_size=16):
    pkg = PKGS[tag]

    def train_fn(ctx, attempt):
        init = ctx.prod.stage.get("params") if ctx.prod is not None else None
        if tag == "torch" and init is not None:
            init = bridge(init)
        with pkg["cp"].AsyncCheckpointer(ctx.checkpoint_dir, keep=10) as ck:
            state = pkg["tr"].fit_source(
                _trainer(tag, total_steps), pkg["src"](ctx.train_cols, shard_rows=32),
                batch_size=batch_size, total_steps=total_steps, seed=ctx.spec.seed,
                init_params=init, scan_chunk=1, checkpointer=ck, checkpoint_every=5,
                resume_from=ctx.checkpoint_dir, skip_fn=attempt.skip_fn,
                callback=lambda i, m: attempt.heartbeat(i))
        return pkg["scorer"]().set(params=_flax_params(tag, state))

    return train_fn


def _v1(tag):
    return PKGS[tag]["scorer"]().set(params=flax_init(1, N_CLASSES))


def _params_bytes(reg):
    params = reg.resolve("m", "prod").stage.get("params")
    return b"".join(np.ascontiguousarray(params[layer][k]).tobytes()
                    for layer in ("fc1", "fc2") for k in ("kernel", "bias"))


def _loop(tag, root, logdir, **spec_kw):
    pkg = PKGS[tag]
    reg = pkg["reg"](str(root / tag / "reg"))
    reg.publish("m", _v1(tag), version="v1")
    reg.pin("m", "prod", "v1")
    kw = {"min_new_rows": 50, "gate_min_margin": 0.05, "seed": 5}
    kw.update(spec_kw)
    loop = pkg["cont"].ContinualLoop(pkg["cont"].ContinualSpec(model="m", **kw), reg,
                                     str(logdir), make_train_fn(tag), eval_fn, row_fn=row_fn,
                                     state_dir=str(root / tag / "state"))
    return reg, loop


def _write_clean_parts(logdir, start=0, n_parts=8, rows=30, seed=7):
    X, y = make_rows(n_parts * rows, seed)
    for k in range(n_parts):
        write_part(str(logdir), start + k, X[k * rows:(k + 1) * rows], y[k * rows:(k + 1) * rows])


_KEYS = ("outcome", "trigger", "parts", "quarantined", "train_rows", "supervisor", "version",
         "iteration", "model")


def _same_records(a: dict, b: dict):
    assert {k: a.get(k) for k in _KEYS} == {k: b.get(k) for k in _KEYS}
    assert set(a.get("gate", {})) == set(b.get("gate", {}))
    for k, v in a.get("gate", {}).items():
        if v is None:
            assert b["gate"][k] is None
        else:
            np.testing.assert_allclose(v, b["gate"][k], atol=1e-5)


def _poison_iteration(loop, logdir, first, train_rows=30, holdout_rows=16, drop_y=2):
    """Parts ``first..first+11``: poisoned ones where the seeded split puts
    them in training, clean ones where it holds them out."""
    names = [f"part-{i:05d}.jsonl" for i in range(first, first + 12)]
    holdout = [n for n in names if loop._holdout_part(n)]
    train = [n for n in names if not loop._holdout_part(n)]
    assert holdout and train
    Xp, yp = make_rows(12 * train_rows, 11, poison=True)
    Xc, yc = make_rows(12 * holdout_rows, 12)
    for j, n in enumerate(train):
        write_part(str(logdir), int(n[5:10]), Xp[j * train_rows:(j + 1) * train_rows],
                   yp[j * train_rows:(j + 1) * train_rows], garbage=2, drop_y=drop_y)
    for j, n in enumerate(holdout):
        write_part(str(logdir), int(n[5:10]), Xc[j * holdout_rows:(j + 1) * holdout_rows],
                   yc[j * holdout_rows:(j + 1) * holdout_rows])
    return train


def test_loop_promotes_then_fails_gate_on_poison(tmp_path):
    logdir = tmp_path / "log"
    os.makedirs(logdir)
    _write_clean_parts(logdir)
    loops = {tag: _loop(tag, tmp_path, logdir) for tag in PKGS}
    recs = {tag: loop.run_once() for tag, (_, loop) in loops.items()}
    _same_records(recs["torch"], recs["jax"])
    reg, loop = loops["torch"]
    assert recs["torch"]["outcome"] == "promoted" and recs["torch"]["gate"]["margin"] > 0.05
    v2 = recs["torch"]["version"]
    assert reg.alias_target("m", "prod") == v2 and loop.state["champion_ckpt"]

    train = _poison_iteration(loop, logdir, 90)
    recs2 = {tag: loop.run_once() for tag, (_, loop) in loops.items()}
    _same_records(recs2["torch"], recs2["jax"])
    assert recs2["torch"]["outcome"] == "gate_failed"
    assert recs2["torch"]["quarantined"] >= 2 * len(train)  # torn lines and label-less rows
    assert reg.alias_target("m", "prod") == v2 and reg.list_versions("m") == ["v1", v2]


def test_loop_skips_when_not_due_and_drift_triggers(tmp_path):
    logdir = tmp_path / "log"
    os.makedirs(logdir)
    _write_clean_parts(logdir, n_parts=2)
    got = {}
    for tag, pkg in PKGS.items():
        _, loop = _loop(tag, tmp_path, logdir, min_new_rows=10_000,
                        drift_gauge="synapseml_test_drift", drift_threshold=0.5)
        # the process-wide gauge may hold another test's value
        pkg["obs"].get_registry().gauge("synapseml_test_drift", "t").set(0.0)
        before = loop.should_run()
        rec = loop.run_once()
        assert loop._new_parts()  # nothing consumed
        pkg["obs"].get_registry().gauge("synapseml_test_drift", "t").set(0.9)
        pkg["cont"].annotate_drift_gauge("synapseml_test_drift", "audit:v7")
        after = loop.should_run()
        assert pkg["cont"].drift_annotation("synapseml_test_drift") == "audit:v7"
        pkg["cont"].annotate_drift_gauge("synapseml_test_drift", None)
        pkg["obs"].get_registry().gauge("synapseml_test_drift", "t").set(0.0)
        got[tag] = (before, {k: rec.get(k) for k in _KEYS}, after)
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] is False and got["torch"][1]["outcome"] == "skipped:not_due"
    assert got["torch"][2] == (True, "drift synapseml_test_drift=0.9>0.5 audit=audit:v7")


def test_spec_json_round_trip():
    spec = tcont.ContinualSpec(model="m", drift_gauge="g", drift_threshold=0.2,
                               publish={"aot": False}, canary={"window": 4})
    assert tcont.ContinualSpec.from_json(spec.to_json()) == spec
    assert spec.to_json() == jcont.ContinualSpec(**json.loads(spec.to_json())).to_json()


@pytest.mark.chaos
def test_loop_seam_faults_contained(tmp_path):
    logdir = tmp_path / "log"
    os.makedirs(logdir)
    _write_clean_parts(logdir)
    loops = {tag: _loop(tag, tmp_path, logdir) for tag in PKGS}
    prod_bytes = {tag: _params_bytes(reg) for tag, (reg, _) in loops.items()}
    for k, seam in enumerate(("watch", "snapshot", "train", "eval", "publish", "promote")):
        recs = {}
        for tag, (reg, loop) in loops.items():
            faults = PKGS[tag]["faults"]
            with faults.inject_faults([faults.FaultSpec("crash", match=f"m:{seam}", times=1,
                                                        planes=("continual",))]) as plan:
                recs[tag] = loop.run_once()
            assert len(plan.injected) == 1
            assert reg.alias_target("m", "prod") == "v1" and _params_bytes(reg) == prod_bytes[tag]
            if seam != "promote":
                assert reg.list_versions("m") == ["v1"], seam
        _same_records(recs["torch"], recs["jax"])
        assert recs["torch"]["outcome"] == f"error:{seam}"
        if seam in ("eval", "publish", "promote"):
            # these iterations consumed the parts before failing: refeed
            _write_clean_parts(logdir, start=200 + 10 * k)
    reg, loop = loops["torch"]
    with tfaults.inject_faults([tfaults.FaultSpec("crash", match="m:watch", times=1,
                                                  planes=("continual",))]):
        with pytest.raises(tcont.LoopAborted) as ei:
            loop.run_once(raise_errors=True)
    assert ei.value.seam == "watch" and loop.history[-1]["outcome"] == "error:watch"
    assert reg.alias_target("m", "prod") == "v1"
    rec = loop.run_once()  # no plan: the loop has recovered
    assert rec["outcome"] == "promoted" and reg.alias_target("m", "prod") == rec["version"]


# ---------------------------------------------------------------- the fleet


def _post(address, body: dict, path="/"):
    req = urllib.request.Request(address + path, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=15) as r:
        return r.read()


def _send_labelled_traffic(address, n, seed):
    X, y = make_rows(n, seed)
    for i in range(n):
        _post(address, {"x": [float(v) for v in X[i]], "y": int(y[i])})


def _version(w):
    with urllib.request.urlopen(f"http://{w['host']}:{w['port']}/admin/version",
                                timeout=10) as r:
        return json.loads(r.read())["version"]


@pytest.mark.chaos(timeout_s=240)
def test_e2e_flywheel_over_a_live_two_worker_fleet(tmp_path, monkeypatch):
    from synapseml_torch.io.distributed_serving import serve_pipeline_distributed

    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([TESTS, os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    v1 = _v1("torch")
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish("m", v1, version="v1")
    reg.pin("m", "prod", "v1")
    logdir = str(tmp_path / "log")
    handle = serve_pipeline_distributed(v1, num_workers=2, batch_interval_ms=0, version="v1")
    lg = None
    try:
        lg = tcont.RequestLogger(logdir, shard_rows=30, seed=0)
        handle.front.set_request_logger(lg)
        _send_labelled_traffic(handle.address, 240, seed=7)
        lg.flush()
        assert lg.stats()["logged"] == 240

        dep = Deployment(handle, reg, "m", warmup=[{"x": [0.0] * D_IN}])
        spec = tcont.ContinualSpec(model="m", min_new_rows=50, gate_min_margin=0.05, seed=5,
                                   canary_weight=0.5, canary_min_requests=8,
                                   canary_timeout_s=90.0, canary={})
        loop = tcont.ContinualLoop(spec, reg, logdir, make_train_fn("torch"), eval_fn,
                                   row_fn=row_fn, deployment=dep,
                                   state_dir=str(tmp_path / "state"))
        # the uninterrupted reference iteration: same spec and logs, no fleet
        ref_reg = ModelRegistry(str(tmp_path / "ref_reg"))
        ref_reg.publish("m", v1, version="v1")
        ref_reg.pin("m", "prod", "v1")
        ref_rec = tcont.ContinualLoop(dataclasses.replace(spec), ref_reg, logdir,
                                      make_train_fn("torch"), eval_fn, row_fn=row_fn,
                                      state_dir=str(tmp_path / "ref_state")).run_once()
        assert ref_rec["outcome"] == "promoted", ref_rec
        ref_bytes = _params_bytes(ref_reg)

        # iteration 1: a crash mid-fit, one restart, canary, promote
        with tfaults.inject_faults([tfaults.FaultSpec("crash", match="step:11", times=1,
                                                      planes=("training",))]):
            rec1 = loop.run_once()
        assert rec1["outcome"] == "promoted", rec1
        assert rec1["supervisor"]["restarts"] == 1
        v2 = rec1["version"]
        assert reg.alias_target("m", "prod") == v2 and _params_bytes(reg) == ref_bytes
        assert sorted(_version(w) for w in handle.registry.workers()) == [v2, v2]
        probe = {"x": [0.1, -0.2, 0.3, 0.4]}
        r0 = _post(handle.address, probe)

        # iteration 2: poisoned training parts fail the gate
        _poison_iteration(loop, logdir, 900, drop_y=1)
        rec2 = loop.run_once()
        assert rec2["outcome"] == "gate_failed" and rec2["quarantined"] > 0, rec2
        assert reg.alias_target("m", "prod") == v2 and _params_bytes(reg) == ref_bytes
        assert _post(handle.address, probe) == r0

        # iteration 3: the gate passes, the canary's p95 regresses: rolled back
        _send_labelled_traffic(handle.address, 120, seed=21)
        lg.flush()
        spec3 = dataclasses.replace(spec, gate_min_margin=-1e9, canary_min_requests=3,
                                    canary={"p95_regression_factor": 1e-6,
                                            "min_latency_samples": 1,
                                            "error_rate_threshold": 1.0, "window": 1000,
                                            "min_samples": 1000})
        rec3 = tcont.ContinualLoop(spec3, reg, logdir, make_train_fn("torch"), eval_fn,
                                   row_fn=row_fn, deployment=dep,
                                   state_dir=str(tmp_path / "state")).run_once()
        assert rec3["outcome"] == "canary_rolled_back", rec3
        assert reg.alias_target("m", "prod") == v2
        assert _post(handle.address, probe) == r0
        snap = tobs.get_registry().snapshot()
        assert any(k.startswith("synapseml_continual_iterations_total") for k in snap)
    finally:
        if lg is not None:
            lg.close()
        handle.stop()
