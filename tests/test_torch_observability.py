"""synapseml_torch's observability and resilience planes against the JAX
package's.

The same samples, spans, headers and clock-driven sequences go through
both packages' functions: Prometheus exposition byte for byte (label
escaping, float formatting, histograms, collectors), W3C traceparent
parsing and extraction, Chrome trace events, the instrumentation and
resilience collectors, ``observe_stage`` through a stage's transform, and
``Deadline`` / ``CircuitBreaker`` transitions under an injected clock.
"""

import json

import numpy as np
import pytest

from synapseml_torch.core import instrumentation as tins
from synapseml_torch.core import observability as tobs
from synapseml_torch.core import resilience as tres
from synapseml_torch.core.dataframe import DataFrame
from synapseml_torch.core.pipeline import Transformer
from synapseml_tpu.core import instrumentation as jins
from synapseml_tpu.core import observability as jobs
from synapseml_tpu.core import resilience as jres


@pytest.fixture()
def fresh():
    """Both packages' process registries, tracers and resilience planes
    fresh for the test, fresh again after it."""
    for mod, res in ((tobs, tres), (jobs, jres)):
        res.reset_resilience_measures()
        mod.reset_registry()
        mod.reset_tracer()
    yield
    for mod, res in ((tobs, tres), (jobs, jres)):
        res.reset_resilience_measures()
        mod.reset_registry()
        mod.reset_tracer()


def _fill(obs, res):
    """One set of families, series, observations and collectors."""
    reg = obs.get_registry()
    c = reg.counter("demo_requests_total", "requests", ("method", "status"))
    c.inc(method="GET", status="2xx")
    c.inc(3, method="POST", status="5xx")
    c.inc(0.25, method='we"ird\\path\nx', status="2xx")
    g = reg.gauge("demo_occupancy", "")
    g.set(0.1)
    reg.gauge("demo_big", "a big gauge").set(1e20)
    reg.gauge("demo_neg", "negative", ("k",)).set(-2.0, k="a")
    h = reg.histogram("demo_latency_ms", "latency", ("method",))
    for v in (0.3, 0.5, 7, 12.5, 99, 1e6):
        h.observe(v, method="GET")
    reg.histogram("demo_rows", "rows", buckets=(1, 2, 4, 8)).labels().observe(3)
    res.resilience_measures("http").count("retry", 2)
    res.resilience_measures("data").count("breaker_open")
    m = _Measures()
    obs.register_instrumentation("demo_loader", m, labels={"part": "0"})
    return m  # the collector holds it by weakref


class _Measures:
    """An ``InstrumentationMeasures`` with fixed windows (a real one's
    ``total_ms`` is the wall time since it was made)."""

    def to_dict(self):
        return {"rows_count": 7, "load_ms": 1.5, "fetch_ms": 0.125, "started_at_ms": 3.0}


def test_prometheus_exposition_is_bytewise_the_jax_one(fresh):
    keep = (_fill(tobs, tres), _fill(jobs, jres))
    got, got_type = tobs.prometheus_exposition()
    want, want_type = jobs.prometheus_exposition()
    assert got_type == want_type
    assert got == want
    text = got.decode()
    assert 'demo_requests_total{method="we\\"ird\\\\path\\nx",status="2xx"} 0.25' in text
    assert "demo_big 1e+20" in text and "demo_occupancy 0.1" in text
    assert 'synapseml_resilience_retry_total{plane="http"} 2' in text
    assert 'demo_loader_rows_total{part="0"} 7' in text
    assert tobs.get_registry().snapshot() == jobs.get_registry().snapshot()
    del keep


def test_register_instrumentation_reads_the_port_measures(fresh):
    """A real ``InstrumentationMeasures`` of each package: the same series
    names and counts (the windows are wall times), and a dropped collector
    stops exporting."""
    snaps = []
    for obs, ins in ((tobs, tins), (jobs, jins)):
        m = ins.InstrumentationMeasures()
        m.count("rows", 7)
        with m.measure("load"):
            pass
        obs.register_instrumentation("demo_loader", m)
        snap = obs.get_registry().snapshot()
        del m
        snaps.append((snap, obs.get_registry().snapshot()))
    (got, gone), (want, jgone) = snaps
    assert set(got) == set(want) and got["demo_loader_rows_total"] == 7
    assert "demo_loader_load_ms" in got and not [k for k in gone if "demo_loader" in k]
    assert set(gone) == set(jgone)


def test_fmt_float_and_escape_label_match_jax():
    for v in (0, 1, -3, 0.1, 2.5e-7, 1e15, 1e16, 123456789.125, -0.0):
        assert tobs._fmt_float(v) == jobs._fmt_float(v), v
    for v in ("plain", 'q"uote', "back\\slash", "new\nline", 3, None):
        assert tobs._escape_label(v) == jobs._escape_label(v)


_HEADERS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00 ",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "00-xyz92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "garbage", "", None,
]


def _ctx(c):
    return None if c is None else (c.trace_id, c.span_id)


@pytest.mark.parametrize("value", _HEADERS)
def test_traceparent_parse_and_format_match_jax(value):
    got, want = tobs.parse_traceparent(value), jobs.parse_traceparent(value)
    assert _ctx(got) == _ctx(want)
    if got is not None:
        assert tobs.format_traceparent(got) == jobs.format_traceparent(want)
    for headers in ({"traceparent": value}, {"TraceParent": value}, {"X-Other": "1"}, None):
        assert _ctx(tobs.extract_context(headers)) == _ctx(jobs.extract_context(headers))


def test_spans_nest_join_remote_traces_and_export_as_jax(fresh, tmp_path):
    tracer = tobs.get_tracer()
    remote = tobs.parse_traceparent(_HEADERS[0])
    with tracer.span("outer", {"a": 1}):
        with tracer.span("inner") as inner:
            inner.set_attribute("rows", 3)
            headers = tracer.inject({})
    with pytest.raises(ValueError):
        with tracer.span("served", parent=remote):
            raise ValueError("boom")
    spans = {s["name"]: s for s in tracer.spans_as_dicts()}
    assert spans["inner"]["parent"] == "outer" and spans["outer"]["parent"] is None
    assert spans["inner"]["parent_id"] == spans["outer"]["span_id"]
    assert spans["inner"]["trace_id"] == spans["outer"]["trace_id"]
    assert headers["traceparent"] == f"00-{spans['inner']['trace_id']}-" \
                                     f"{spans['inner']['span_id']}-01"
    served = spans["served"]
    assert (served["trace_id"], served["parent_id"]) == (remote.trace_id, remote.span_id)
    assert served["status"] == "error" and served["attributes"]["error"] == "ValueError: boom"
    # Chrome trace events: the port's function is the JAX one on the same dicts
    dicts = tracer.spans_as_dicts()
    assert tobs.chrome_trace_events(dicts) == jobs.chrome_trace_events(dicts)
    assert tobs.chrome_trace_events() == jobs.chrome_trace_events(dicts)
    path = tobs.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        assert json.load(f) == jobs.chrome_trace_events(dicts)
    tobs.reset_tracer(max_spans=2)
    for i in range(5):
        with tobs.get_tracer().span(f"s{i}"):
            pass
    assert [s.name for s in tobs.get_tracer().finished_spans()] == ["s3", "s4"]


class _Double(Transformer):
    def _transform(self, df):
        return df.with_column("y", lambda p: np.asarray(p["x"]) * 2)


class _Fails(Transformer):
    def _transform(self, df):
        raise RuntimeError("no")


def test_observe_stage_records_every_transform(fresh):
    df = DataFrame.from_dict({"x": np.arange(4)})
    _Double().transform(df)
    _Double().transform(df)
    with pytest.raises(RuntimeError):
        _Fails().transform(df)
    snap = tobs.get_registry().snapshot()
    assert snap['synapseml_stage_duration_ms{method="transform",stage="_Double"}']["count"] == 2
    assert snap['synapseml_stage_events_total{method="transform",stage="_Double",status="ok"}'] == 2
    assert snap['synapseml_stage_events_total{method="transform",stage="_Fails",status="error"}'] == 1
    # the same calls on the JAX function give the same series
    jobs.observe_stage("_Double", "transform", 1.0)
    jobs.observe_stage("_Double", "transform", 1.0)
    jobs.observe_stage("_Fails", "transform", 1.0, error=True)
    jsnap = jobs.get_registry().snapshot()
    assert {k for k in snap if "stage" in k} == {k for k in jsnap if "stage" in k}


def test_resilience_collector_and_measures_match_jax(fresh):
    for res in (tres, jres):
        res.resilience_measures("serving").count("deadline_expired", 2)
        res.resilience_measures("data").count("retry")
    got, want = tres.all_resilience_measures(), jres.all_resilience_measures()
    strip = lambda d: {p: {k: v for k, v in m.items() if k.endswith("_count")}  # noqa: E731
                       for p, m in d.items()}
    assert strip(got) == strip(want)
    assert got["serving"]["deadline_expired_count"] == 2
    assert got["data"]["breaker_open_count"] == 0


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _deadline_trace(res):
    clock = _Clock()
    d = res.Deadline(2.0, clock=clock)
    out = [d.remaining(), d.expired(), d.cap(5.0), d.cap(0.5), d.sleep_allowed(1.5)]
    clock.t += 1.5
    out += [d.remaining(), d.cap(5.0), d.sleep_allowed(1.0), d.expired()]
    clock.t += 0.5
    out.append(d.expired())
    with pytest.raises(res.DeadlineExpired, match="expired"):
        d.cap(1.0)
    assert isinstance(res.DeadlineExpired("x"), TimeoutError)
    return out


def test_deadline_matches_jax():
    assert _deadline_trace(tres) == _deadline_trace(jres)


_BREAKER_OPS = ("f", "s", "f", "f", "a", "t1", "a", "a", "f", "t2.5", "v", "a", "s", "f",
                "f", "f", "t0.5", "a", "t3", "a", "a", "t2.1", "a", "f", "t2", "a", "s")


def _breaker_trace(res, **kw):
    clock = _Clock()
    measures = res.resilience_measures("test_breaker")
    b = res.CircuitBreaker(clock=clock, measures=measures, name="w", **kw)
    out = []
    for op in _BREAKER_OPS:
        if op == "f":
            b.record_failure()
        elif op == "s":
            b.record_success()
        elif op == "a":
            out.append(("allow", b.allow()))
        elif op == "v":
            out.append(("available", b.available()))
        else:
            clock.t += float(op[1:])
        out.append(b.state)
    out.append(measures.to_dict()["breaker_open_count"])
    out.append(repr(b))
    return out


@pytest.mark.parametrize("kw", [
    {},
    dict(failure_rate_threshold=0.6, window=5, min_samples=3, probe_interval_s=2.0,
         half_open_probes=2),
    dict(failure_rate_threshold=0.0, window=1),
])
def test_circuit_breaker_matches_jax(fresh, kw):
    assert _breaker_trace(tres, **kw) == _breaker_trace(jres, **kw)
