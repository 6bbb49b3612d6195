"""synapseml_torch.fleet's admission policy against the JAX package's.

Every case drives both packages' ``TokenBucket``/``AdmissionController``
with the same calls on an injected clock and asserts the same decisions
(admitted, status, reason, retry-after), the same ``stats()`` counters and
p99s, exactly: the code is host arithmetic, so nothing needs a tolerance.
``FleetSpec`` round-trips to the same JSON and refuses the same configs;
``model_path``/``model_from_path`` and ``priority_of`` agree on every
input.
"""

import pytest

from synapseml_torch import fleet as tfleet
from synapseml_torch.core import observability as tobs
from synapseml_tpu import fleet as jfleet

PKGS = (jfleet, tfleet)


def _decision(d):
    return (d.admitted, d.status, d.retry_after_s, d.reason)


def _both(run):
    """``run(fleet)`` on each package; the two records must be equal."""
    got = [run(pkg) for pkg in PKGS]
    assert got[0] == got[1]
    return got[1]


def test_token_bucket_rate_refill_and_reserve_floor():
    def run(f):
        t = [0.0]
        bucket = f.TokenBucket(10.0, 5.0, clock=lambda: t[0])
        out = [bucket.try_take() for _ in range(6)]
        out.append(bucket.wait_time_s())
        t[0] += 0.35
        out += [bucket.try_take() for _ in range(4)]
        t[0] += 0.2
        out += [bucket.try_take(floor=4.0), bucket.try_take(floor=1.0), bucket.tokens]
        with pytest.raises(ValueError):
            f.TokenBucket(0.0, 5.0)
        return out

    out = _both(run)
    assert out[:6] == [True] * 5 + [False]
    assert out[6] == pytest.approx(0.1)
    assert out[7:11] == [True, True, True, False]
    assert out[11:13] == [False, True]


def test_admission_bulk_sheds_before_interactive():
    def run(f):
        t = [0.0]
        ctrl = f.AdmissionController(
            {"m": f.AdmissionPolicy(rate_rps=10.0, burst=10.0, interactive_reserve=0.3)},
            clock=lambda: t[0])
        out = [_decision(ctrl.admit("m", "bulk")) for _ in range(9)]
        out += [_decision(ctrl.admit("m", "interactive")) for _ in range(4)]
        t[0] += 0.25  # 2.5 tokens back
        out += [_decision(ctrl.admit("m", p)) for p in ("bulk", "interactive", "bulk")]
        return out, ctrl.stats()

    out, stats = _both(run)
    assert [d[0] for d in out[:9]] == [True] * 7 + [False] * 2
    assert [d[0] for d in out[9:13]] == [True] * 3 + [False]
    assert out[7][1:] == (429, pytest.approx(0.1), "rate")
    assert stats["m"]["admitted"] == {"interactive": 4, "bulk": 7}
    assert stats["m"]["shed"] == {"interactive": 1, "bulk": 4}


def test_admission_p99_budget_sheds_newest_first_by_class():
    def run(f):
        ctrl = f.AdmissionController({"m": f.AdmissionPolicy(
            p99_budget_ms=100.0, hard_shed_factor=3.0, retry_after_s=2.0)})
        out = [_decision(ctrl.admit("m", "bulk"))]
        for _ in range(50):
            ctrl.observe("m", 150.0)
        out += [_decision(ctrl.admit("m", "bulk")), _decision(ctrl.admit("m", "interactive"))]
        for _ in range(50):
            ctrl.observe("m", 400.0)
        out += [_decision(ctrl.admit("m", "interactive")), _decision(ctrl.admit("other", "bulk"))]
        return out, ctrl.p99_ms("m"), ctrl.stats()

    out, p99, stats = _both(run)
    assert out == [(True, 200, 0.0, ""), (False, 429, 2.0, "p99_budget"), (True, 200, 0.0, ""),
                   (False, 429, 2.0, "p99_budget"), (True, 200, 0.0, "")]
    assert p99 == 400.0 and "other" not in stats


def test_admission_p99_shed_cannot_lock_out_forever():
    def run(f):
        t = [0.0]
        ctrl = f.AdmissionController({"m": f.AdmissionPolicy(
            p99_budget_ms=100.0, hard_shed_factor=1.5, retry_after_s=1.0)}, clock=lambda: t[0])
        for _ in range(50):
            ctrl.observe("m", 500.0)
        out = [ctrl.admit("m", "interactive").admitted]
        t[0] = 1.5
        out += [ctrl.admit("m", "interactive").admitted, ctrl.admit("m", "interactive").admitted]
        ctrl.observe("m", 500.0)
        out.append(ctrl.admit("m", "bulk").admitted)
        t[0] = 3.0
        out.append(ctrl.admit("m", "bulk").admitted)
        return out

    assert _both(run) == [False, True, False, False, True]


def test_admission_failed_replies_do_not_dilute_the_p99_window():
    def run(f):
        ctrl = f.AdmissionController({"m": f.AdmissionPolicy(
            p99_budget_ms=100.0, hard_shed_factor=1.5, retry_after_s=10.0)}, clock=lambda: 0.0)
        for _ in range(50):
            ctrl.observe("m", 500.0)
        first = ctrl.admit("m", "interactive").admitted
        for _ in range(300):
            ctrl.observe("m", 2.0, ok=False)
        return first, ctrl.p99_ms("m"), ctrl.admit("m", "interactive").admitted

    assert _both(run) == (False, 500.0, False)


def test_admission_p99_window_is_the_policy_window():
    """The window keeps the last ``latency_window`` observations: p99 moves
    once the old slow ones have left it."""
    def run(f):
        ctrl = f.AdmissionController({"m": f.AdmissionPolicy(p99_budget_ms=50.0,
                                                             latency_window=16)})
        out = []
        for ms in [300.0] * 16 + [10.0] * 15 + [20.0]:
            ctrl.observe("m", ms)
            out.append(ctrl.p99_ms("m"))
        return out

    out = _both(run)
    assert out[15] == 300.0 and out[-2] == 300.0 and out[-1] == 20.0


def test_admission_default_policy_state_is_bounded():
    def run(f):
        ctrl = f.AdmissionController(default=f.AdmissionPolicy(rate_rps=100000.0,
                                                               burst=100000.0))
        cap = f.AdmissionController._MAX_DEFAULT_MODELS
        admitted = all(ctrl.admit(f"scan-{i}").admitted for i in range(cap + 50))
        stats = ctrl.stats()
        return admitted, cap, len(stats), "_overflow" in stats, \
            stats["_overflow"]["admitted"]

    admitted, cap, n, overflow, counts = _both(run)
    assert admitted and n == cap + 1 and overflow and counts["interactive"] == 50
    family = tobs.get_registry().counter(
        "synapseml_fleet_admitted_total", "requests admitted by the fleet admission controller",
        ("model", "priority"))
    labels = {dict(k)["model"] for k, _ in family._child_items()}
    assert "_overflow" in labels and f"scan-{cap + 10}" not in labels


def test_admission_observe_reaches_the_overflow_state():
    def run(f):
        ctrl = f.AdmissionController(default=f.AdmissionPolicy(
            rate_rps=100000.0, burst=100000.0, p99_budget_ms=100.0))
        cap = f.AdmissionController._MAX_DEFAULT_MODELS
        for i in range(cap + 5):
            ctrl.admit(f"scan-{i}")
        for _ in range(50):
            ctrl.observe(f"scan-{cap + 1}", 500.0)
        return ctrl.stats()["_overflow"]["p99_ms"], ctrl.admit(f"scan-{cap + 1}", "bulk").admitted

    assert _both(run) == (500.0, False)


def test_admission_from_spec_and_shed_metrics():
    def run(f):
        spec = f.FleetSpec(models=[f.ModelSLO(model="a", admission=f.AdmissionPolicy(
            rate_rps=2.0, burst=2.0, interactive_reserve=0.0)), f.ModelSLO(model="b")])
        ctrl = f.AdmissionController.from_spec(spec, clock=lambda: 0.0)
        return [_decision(ctrl.admit(m)) for m in ("a", "a", "a", "b")], sorted(ctrl.stats())

    decisions, models = _both(run)
    assert [d[0] for d in decisions] == [True, True, False, True] and models == ["a"]
    snap = tobs.get_registry().snapshot()
    assert snap['synapseml_fleet_shed_total{model="a",priority="interactive",reason="rate"}'] >= 1


def test_fleet_spec_json_round_trip_and_validation():
    def run(f):
        spec = f.FleetSpec(
            models=[f.ModelSLO(model="a", ref="prod", min_workers=1, max_workers=8,
                               p95_slo_ms=50.0, admission=f.AdmissionPolicy(rate_rps=100.0),
                               serve={"batch_interval_ms": 10}),
                    {"model": "b", "admission": {"p99_budget_ms": 80.0}}],
            reconcile_interval_s=0.5, byte_budget=1 << 20)
        text = spec.to_json()
        again = f.FleetSpec.from_json(text)
        errors = []
        for bad in (lambda: f.ModelSLO(model="x", min_workers=3, max_workers=2),
                    lambda: f.FleetSpec(models=[f.ModelSLO(model="a"), f.ModelSLO(model="a")]),
                    lambda: f.AdmissionPolicy(interactive_reserve=1.5),
                    lambda: f.AdmissionPolicy(hard_shed_factor=0.5),
                    lambda: f.AdmissionPolicy(rate_rps=0.5)):
            with pytest.raises(ValueError) as e:
                bad()
            errors.append(str(e.value))
        return (text, again.to_json(), again.models[0].admission.burst,
                again.slo_for("a").max_workers, again.slo_for("missing"),
                sorted(again.admission_policies()), errors)

    text, again, burst, max_workers, missing, policies, errors = _both(run)
    assert text == again and burst == 200.0 and max_workers == 8 and missing is None
    assert policies == ["a", "b"]
    assert "min_workers" in errors[0] and "duplicate" in errors[1] \
        and "interactive_reserve" in errors[2] and "never be admitted" in errors[4]


def test_model_path_and_priority_round_trip():
    paths = ["/m/mlp", "/m/mlp/predict", "/m/x?k=v", "/m/x#frag", "/m/", "/m", "/", "/score",
             "/admin/load", "m/x", "/m/a/b?c=/m/d"]
    headers = [{}, {"X-Priority": "bulk"}, {"x-priority": " BULK "},
               {"X-Priority": "interactive"}, {"X-Priority": "other"}, None]

    def run(f):
        return ([f.model_from_path(p) for p in paths],
                [f.model_from_path(f.model_path(m)) for m in ("mlp", "bert-base", "a.b")],
                [f.priority_of(h) for h in headers])

    models, round_trip, prios = _both(run)
    assert models[:4] == ["mlp", "mlp", "x", "x"] and models[4:] == [None] * 6 + ["a"]
    assert round_trip == ["mlp", "bert-base", "a.b"]
    assert prios == ["interactive", "bulk", "bulk", "interactive", "interactive", "interactive"]
    assert tfleet.model_path("mlp") == "/m/mlp"
