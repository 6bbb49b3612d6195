"""synapseml_torch.continual's RequestLogger against synapseml_tpu.continual's.

The logger cases of ``tests/test_continual.py:172-290`` run through each
package on the same traffic: atomic parts with DONE markers read back by
``logged_request_source``, the seeded sampler, shedding on a full queue,
and a commit fault that sheds one shard. The kept set of one seed is the
JAX logger's, the committed parts equal the JAX logger's field for field
apart from ``ts`` and ``latency_ms`` (a wall clock), the DONE markers apart
from ``bytes`` (which counts those), and the scrub counts are equal. Then
the two hooks: ``ServingServer.request_logger`` and
``RoutingFront.set_request_logger`` log every batched (forwarded) exchange
with its version, each package's server or front serving the same echo
stage.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from _torch_worker_stages import EchoPid
from synapseml_torch import continual as tcont
from synapseml_torch.core import faults as tfaults
from synapseml_torch.core import observability as tobs
from synapseml_torch.io import distributed_serving as tds
from synapseml_torch.io import serving as tserving
from synapseml_tpu import continual as jcont
from synapseml_tpu.core import faults as jfaults
from synapseml_tpu.core import observability as jobs
from synapseml_tpu.core.pipeline import Transformer as JTransformer
from synapseml_tpu.io import distributed_serving as jds
from synapseml_tpu.io import serving as jserving

PKGS = {"jax": dict(cont=jcont, faults=jfaults, obs=jobs, ds=jds, serving=jserving),
        "torch": dict(cont=tcont, faults=tfaults, obs=tobs, ds=tds, serving=tserving)}


class JEchoPid(JTransformer):
    """The JAX twin of ``_torch_worker_stages.EchoPid``."""

    def _transform(self, df):
        def per_part(p):
            out = dict(p)
            reply = np.empty(len(p["body"]), dtype=object)
            reply[:] = [{"echo": b, "pid": os.getpid()} for b in p["body"]]
            out["reply"] = reply
            return out

        return df.map_partitions(per_part)


def _echo(pkg):
    return JEchoPid() if pkg["cont"] is jcont else EchoPid()


def _parts(path):
    """Every committed part's records without ``ts`` and ``latency_ms``, and
    its DONE marker without ``bytes``, by part name."""
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".jsonl") and os.path.exists(os.path.join(path, name + ".DONE")):
            with open(os.path.join(path, name)) as f:
                recs = [json.loads(line) for line in f]
            for r in recs:
                assert isinstance(r.pop("ts"), float) and r.pop("latency_ms") >= 0
            with open(os.path.join(path, name + ".DONE")) as f:
                done = json.load(f)
            assert done.pop("bytes") == os.path.getsize(os.path.join(path, name))
            out[name] = (recs, done)
    return out


def _scrub_counts(obs):
    snap = obs.get_registry().snapshot()
    return {k: v for k, v in snap.items()
            if k.startswith("synapseml_continual_scrubbed_fields_total")}


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _both(run, tmp_path):
    got = []
    for tag, pkg in PKGS.items():
        d = tmp_path / tag
        d.mkdir()
        got.append(run(pkg, str(d)))
    assert got[0] == got[1]
    return got[1]


SECRETS = ["api_key=abc123", "card 4111 1111 1111 1111", "bob@example.com", "plain text"]


def test_atomic_parts_and_source_equal_the_jax_logger(tmp_path):
    def run(pkg, d):
        cont, obs = pkg["cont"], pkg["obs"]
        scrub0 = _scrub_counts(obs)
        with cont.RequestLogger(d, shard_rows=4, seed=1) as lg:
            for i in range(10):
                lg.log(method="POST", path="/", status=200, latency_ms=1.0,
                       body=json.dumps({"x": [i], "email": "u@x.io",
                                        "note": SECRETS[i % 4]}).encode(),
                       reply={"pred": i % 3, "n": 1234567890123 + i})
            lg.flush()
            parts = lg.committed_parts()
            assert not [n for n in os.listdir(d) if n.endswith(".jsonl")
                        and not os.path.exists(os.path.join(d, n + ".DONE"))]
            src = cont.logged_request_source(d)
            rows = sum(len(next(iter(c.values()))) for _, c in src.iter_shards())
            first = src.read_shard(0)["body"][0]
            stats = lg.stats()
        return {"parts": _parts(d), "names": [os.path.basename(p) for p in parts],
                "rows": rows, "first": first, "stats": stats,
                "scrubs": _delta(_scrub_counts(obs), scrub0)}

    rec = _both(run, tmp_path)
    assert len(rec["names"]) == 3 and rec["rows"] == 10 and rec["stats"]["logged"] == 10
    assert rec["first"]["email"] == "####@####"
    done = rec["parts"]["part-00000.jsonl"][1]
    assert done["rows"] == 4 and done["scrubbed"]["email"] > 0 and rec["scrubs"]


def test_the_kept_set_of_a_seed_is_the_jax_loggers(tmp_path):
    def run(pkg, d):
        with pkg["cont"].RequestLogger(d, sample_rate=0.5, seed=42, shard_rows=1000) as lg:
            for i in range(200):
                lg.log(method="POST", path="/", body=json.dumps({"i": i}).encode(), reply={},
                       status=200, latency_ms=0.1)
            lg.flush()
            kept = [r["body"]["i"] for recs, _ in _parts(d).values() for r in recs]
            return kept, lg.stats()["logged"]

    kept, logged = _both(run, tmp_path)
    assert logged == len(kept) and 50 < logged < 150


def test_a_full_queue_sheds_and_never_blocks(tmp_path):
    for tag, pkg in PKGS.items():
        lg = pkg["cont"].RequestLogger(str(tmp_path / tag), shard_rows=1000, max_queue=2)
        gate = threading.Event()
        orig = lg._write_record

        def slow(item, orig=orig, gate=gate):
            gate.wait(10)
            orig(item)

        lg._write_record = slow
        for _ in range(20):
            lg.log(method="POST", path="/", body=b"{}", reply={}, status=200, latency_ms=0.1)
        assert lg.dropped > 0, tag
        gate.set()
        lg.close()
        assert lg.stats()["logged"] + lg.dropped == 20, tag


def test_a_commit_fault_sheds_its_shard_as_the_jax_logger(tmp_path):
    def run(pkg, d):
        cont, faults = pkg["cont"], pkg["faults"]
        with cont.RequestLogger(d, shard_rows=4) as lg:
            with faults.inject_faults([faults.FaultSpec("crash", match="log_commit", times=1,
                                                        planes=("continual",))]):
                for i in range(8):
                    lg.log(method="POST", path="/", body=json.dumps({"i": i}).encode(),
                           reply={}, status=200, latency_ms=0.1)
                lg.flush()
            return lg.dropped, lg.logged, _parts(d)

    dropped, logged, parts = _both(run, tmp_path)
    assert (dropped, logged) == (4, 4) and list(parts) == ["part-00001.jsonl"]


def test_serving_server_request_logger_logs_every_batched_exchange(tmp_path):
    bodies = [{"q": i, "note": SECRETS[i % 4]} for i in range(12)]

    def run(pkg, d):
        serving = pkg["serving"]
        srv = serving.serve_pipeline(_echo(pkg), batch_interval_ms=5, version="v7")
        lg = pkg["cont"].RequestLogger(d, shard_rows=5)
        assert srv.request_logger is None
        srv.request_logger = lg
        try:
            for b in bodies:
                req = urllib.request.Request(srv.address + "/score", method="POST",
                                             data=json.dumps(b).encode())
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert r.status == 200
            lg.flush()
            return _parts(d)
        finally:
            srv.request_logger = None
            lg.close()
            srv.stop()

    parts = _both(run, tmp_path)
    recs = [r for recs, _ in parts.values() for r in recs]
    assert len(recs) == len(bodies) and {r["version"] for r in recs} == {"v7"}
    assert [r["reply"]["echo"]["q"] for r in recs] == list(range(12))
    assert all(r["path"] == "/score" and r["status"] == 200 for r in recs)
    assert "abc123" not in json.dumps(recs) and "4111" not in json.dumps(recs)


def test_routing_front_request_logger_logs_every_forwarded_exchange(tmp_path):
    bodies = [{"q": i} for i in range(9)]

    def run(pkg, d):
        ds, serving = pkg["ds"], pkg["serving"]
        srv = serving.serve_pipeline(_echo(pkg), batch_interval_ms=5, version="v2")
        wreg = ds.WorkerRegistry()
        urllib.request.urlopen(urllib.request.Request(
            wreg.address + "/register", method="POST", data=json.dumps(
                {"host": srv.host, "port": srv.port, "pid": -1, "version": "v2"}).encode()),
            timeout=10).read()
        front = ds.RoutingFront(registry=wreg)
        lg = pkg["cont"].RequestLogger(d, sample_rate=1.0, shard_rows=4)
        front.set_request_logger(lg)
        try:
            assert front.request_logger() is lg
            for b in bodies:
                req = urllib.request.Request(front.address + "/m/echo", method="POST",
                                             data=json.dumps(b).encode())
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert r.status == 200
            lg.flush()
            # the front logs on each exchange's handler thread after its
            # reply is written, so the next exchange may log first: the
            # records compare as a set, the markers by their rows
            parts = _parts(d)
            recs = sorted((r for recs, _ in parts.values() for r in recs),
                          key=lambda r: r["body"]["q"])
            return recs, sum(done["rows"] for _, done in parts.values())
        finally:
            front.set_request_logger(None)
            lg.close()
            front.close()
            wreg.close()
            srv.stop()

    recs, rows = _both(run, tmp_path)
    assert len(recs) == rows == len(bodies) and {r["version"] for r in recs} == {"v2"}
    assert [r["body"]["q"] for r in recs] == list(range(9))
    assert [r["reply"]["echo"]["q"] for r in recs] == list(range(9))


def test_logger_refuses_a_sample_rate_out_of_range(tmp_path):
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="sample_rate"):
            pkg["cont"].RequestLogger(str(tmp_path), sample_rate=1.5)
