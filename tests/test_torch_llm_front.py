"""synapseml_torch's journaled LLM streams through the RoutingFront against
the JAX package's.

Every worker serves llama-tiny in f32 over the paged engine (the presets
patched to f32 on both sides, the Flax weights bridged with
``convert_jax``, as ``test_torch_serve_llm.py`` does), so greedy tokens are
held equal to the JAX package's, exactly. The journal's admission (new,
replay, conflict, LRU eviction of finished entries) and the stream
writer's seq dedup and first-writer-wins arbitration equal the JAX
package's on the same calls; a journaled stream and a retried idempotency
key through each package's front give the same chunks, the same replayed
terminal and the same counters. On the port: a stuck prefill is hedged to
the second worker, which wins; a live drain hands every active sequence to
the peer through ``/admin/migrate``; and one of two ``llm_worker_main``
processes is SIGKILLed once every one of 16 streams has received a chunk:
every stream completes with contiguous seqs (no duplicate, none lost) and
the JAX package's tokens, and the survivor ends holding no KV page. Decode
steps are paced 10-20 ms longer where the test must act on live streams.
"""

import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch.core import faults as tfaults
from synapseml_torch.core import observability as tobs
from synapseml_torch.hf import HuggingFaceCausalLM
from synapseml_torch.hf import causal_lm as tcl
from synapseml_torch.io import distributed_serving as tds
from synapseml_torch.io import serving as tsrv
from synapseml_torch.models import convert_jax
from synapseml_torch.models.nets import llama as tl
from synapseml_torch.models.tokenizer import HashingTokenizer
from synapseml_tpu.core import observability as jobs
from synapseml_tpu.hf import causal_lm as jcl
from synapseml_tpu.io import distributed_serving as jds
from synapseml_tpu.io import serving as jsrv
from synapseml_tpu.models.flax_nets import llama as jl

VOCAB = 512
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    j_old, t_old = dict(jcl._ARCHS), dict(tcl._ARCHS)
    jcl._ARCHS["llama-tiny"] = lambda **kw: jl.llama_tiny(dtype=jnp.float32, **kw)
    tcl._ARCHS["llama-tiny"] = lambda **kw: tl.llama_tiny(dtype=torch.float32, **kw)
    jcfg = jl.llama_tiny(dtype=jnp.float32, vocab_size=VOCAB)
    init = jax.jit(jl.LlamaLM(jcfg).init)
    params = nn.unbox(init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    params = jax.tree.map(np.asarray, params)
    yield params, convert_jax.llama_state_dict_from_flax(params)
    for archs, old in ((jcl._ARCHS, j_old), (tcl._ARCHS, t_old)):
        archs.clear()
        archs.update(old)


def _kw():
    return dict(model_name="llama-tiny", engine="paged", max_new_tokens=64,
                tokenizer=HashingTokenizer(vocab_size=VOCAB).to_config(), decode_slots=16)


def _worker(weights, pkg="torch"):
    params, sd = weights
    if pkg == "jax":
        return jsrv.serve_llm(jcl.HuggingFaceCausalLM(**_kw(), model_params=params),
                              warmup=False)
    return tsrv.serve_llm(HuggingFaceCausalLM(**_kw(), model_params=sd, device="cpu"),
                          warmup=False)


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """Greedy ``output_ids`` of the JAX package's worker, by (prompt ids,
    max_new_tokens)."""
    srv = _worker(weights, "jax")
    memo = {}

    def tokens(ids, max_new):
        key = (tuple(ids), max_new)
        if key not in memo:
            st, body, _ = _request(srv.address, {"input_ids": list(ids),
                                                 "max_new_tokens": max_new})
            assert st == 200, body
            memo[key] = body["output_ids"]
        return memo[key]

    yield tokens
    srv.stop()


def _request(address, payload, headers=None, timeout=120, path="/"):
    """(status, reply dict | list of stream chunks, headers)."""
    host, port = address.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    conn.request("POST", path, body=json.dumps(payload).encode(), headers=headers or {})
    r = conn.getresponse()
    try:
        if payload.get("stream") and r.status == 200:
            out = [json.loads(line) for line in iter(r.readline, b"") if line.strip()]
        else:
            out = json.loads(r.read() or b"null")
    finally:
        conn.close()
    return r.status, out, dict(r.getheaders())


def _contiguous(chunks):
    """The token ids of a stream whose chunks carry seq 0..n-1, no gap and
    no repeat, and whose terminal carries seq n without an error."""
    toks = [c for c in chunks if "token" in c and not c.get("done")]
    assert [c["seq"] for c in toks] == list(range(len(toks))), [c["seq"] for c in toks]
    term = chunks[-1]
    assert term.get("done") and "error" not in term and term["seq"] == len(toks), term
    return [c["token"] for c in toks]


def _metric(obs, name, labels=""):
    snap = obs.get_registry().snapshot()
    return sum(v for k, v in snap.items() if k.startswith(name) and labels in k)


def _pace(monkeypatch, seconds):
    step = tcl.CausalLMServingEngine.step

    def slow(self):
        time.sleep(seconds)
        return step(self)

    monkeypatch.setattr(tcl.CausalLMServingEngine, "step", slow)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_journal_admission_and_stream_writer_arbitration(pkg):
    ds = {"jax": jds, "torch": tds}[pkg]
    j = ds._StreamJournal(max_entries=2)
    e1, v1 = j.admit("a", "d1", {"prompt": "x"}, True, None)
    e1.inflight = True
    verdicts = [v1, j.admit("a", "d1", {}, True, None)[1]]
    e1.inflight, e1.done = False, True
    verdicts += [j.admit("a", "d1", {}, True, None)[1], j.admit("a", "d2", {}, True, None)[1]]
    for k in ("b", "c"):
        j.admit(k, "d", {}, False, None)[0].done = True
    j.admit("d", "d", {}, False, None)  # past max_entries: finished ones evict oldest-first
    assert verdicts == ["new", "conflict", "replay", "new"]
    # the live "a" (re-admitted, unfinished) is never evicted
    assert j.depth() == 2 and j.get("a") is not None and j.get("d") is not None
    assert j.get("b") is None and j.get("c") is None

    class Handler:
        wfile = io.BytesIO()

        def send_response(self, status):
            self.status = status

        def send_header(self, *a):
            pass

        def end_headers(self):
            pass

    entry = ds._JournalEntry("k", "d", {}, True, None)
    writer = ds._StreamWriter(Handler(), entry)
    out = [writer.deliver({"token": 7, "seq": 0, "uid": 3}, 0),
           writer.deliver({"token": 8, "seq": 1}, 1),  # the other attempt lost
           writer.deliver({"token": 8, "seq": 1}, 0),
           writer.deliver({"token": 8, "seq": 1}, 0),  # a resume overlap: dup
           writer.deliver({"done": True, "seq": 2, "output_ids": [7, 8]}, 0),
           writer.deliver({"done": True, "seq": 2}, 0)]
    writer.finish_stream()
    assert out == ["ok", "lost", "ok", "dup", "ok", "dup"]
    assert entry.emitted_ids == [7, 8] and entry.relayed == 2 and entry.uid == 3
    assert entry.done and entry.result["output_ids"] == [7, 8]
    body = Handler.wfile.getvalue()
    assert body.endswith(b"0\r\n\r\n") and body.count(b'"token"') == 2


def test_journal_stream_seq_and_terminal_dedup_match_jax(weights):
    def run(pkg):
        ds, obs = {"jax": (jds, jobs), "torch": (tds, tobs)}[pkg]
        srv = _worker(weights, pkg)
        front = ds.RoutingFront([{"host": srv.host, "port": srv.port, "pid": 1}],
                                timeout_s=60, journal=True)
        try:
            prompt = {"input_ids": [5, 9, 17, 4], "max_new_tokens": 6}
            st, chunks, _ = _request(front.address, dict(prompt, stream=True),
                                     headers={"X-Request-Key": "k-stream"})
            replays0 = _metric(obs, "synapseml_llm_journal_replays_total")
            once = [_request(front.address, prompt, headers={"X-Request-Key": "k-once"})
                    for _ in range(2)]
            return (st, [{k: v for k, v in c.items() if k != "uid"} for c in chunks],
                    [(s, b["output_ids"], h.get("X-Journal-Replay")) for s, b, h in once],
                    _metric(obs, "synapseml_llm_journal_replays_total") - replays0,
                    _metric(obs, "synapseml_llm_journal_depth") >= 2)
        finally:
            front.close()
            srv.stop()

    want, got = run("jax"), run("torch")
    assert got == want
    ids = _contiguous(got[1])
    assert len(ids) == 6 and got[2] == [(200, ids, None), (200, ids, "1")]
    assert got[3] == 1 and got[4]


def test_hedged_stuck_prefill_first_writer_wins(weights, jax_tokens):
    srv_a, srv_b = _worker(weights), _worker(weights)
    front = tds.RoutingFront([{"host": s.host, "port": s.port, "pid": i}
                              for i, s in enumerate((srv_a, srv_b))],
                             timeout_s=60, journal=True, hedge_after_s=0.5)
    payload = {"input_ids": [3, 11, 7], "max_new_tokens": 5, "stream": True}
    try:
        for srv in (srv_a, srv_b):  # both warm
            assert _request(srv.address, payload)[0] == 200
        won0 = _metric(tobs, "synapseml_llm_hedges_total", 'outcome="won"')
        # whichever worker the rotation makes the primary stalls on connect
        plan = tfaults.FaultPlan([tfaults.FaultSpec(kind="latency", latency_ms=4000, times=1,
                                                    planes=("distributed_serving",))], seed=7)
        with tfaults.inject_faults(plan):
            t0 = time.perf_counter()
            st, chunks, _ = _request(front.address, payload, headers={"X-Request-Key": "k-h"})
            took = time.perf_counter() - t0
        assert st == 200 and _contiguous(chunks) == jax_tokens([3, 11, 7], 5)
        assert len(plan.injected) == 1 and took < 3.5
        assert _metric(tobs, "synapseml_llm_hedges_total", 'outcome="won"') == won0 + 1
    finally:
        front.close()
        srv_a.stop()
        srv_b.stop()


@pytest.mark.chaos(timeout_s=90)
def test_live_drain_migrates_every_active_sequence(weights, jax_tokens, monkeypatch):
    srv_a, srv_b = _worker(weights), _worker(weights)
    registry = tds.WorkerRegistry()
    front = tds.RoutingFront(registry=registry, timeout_s=60, journal=True)
    n, max_new = 3, 24
    rng = np.random.default_rng(33)
    prompts = [rng.integers(2, 200, (6,)).tolist() for _ in range(n)]
    try:
        refs = [_request(srv_b.address, {"input_ids": p, "max_new_tokens": max_new,
                                         "stream": True})[1] for p in prompts]
        for p, ref in zip(prompts, refs):
            assert _contiguous(ref) == jax_tokens(p, max_new)

        def register(srv, pid):
            urllib.request.urlopen(urllib.request.Request(
                registry.address + "/register", method="POST", data=json.dumps(
                    {"host": srv.host, "port": srv.port, "pid": pid}).encode()), timeout=10).read()

        register(srv_a, 1)  # only A: every stream lands there
        _pace(monkeypatch, 0.01)
        results, progress, started = [None] * n, [0] * n, threading.Barrier(n + 1)

        def run(i):
            host, port = front.address.split("//")[1].split(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=120)
            conn.request("POST", "/", body=json.dumps(
                {"input_ids": prompts[i], "max_new_tokens": max_new, "stream": True}).encode(),
                headers={"X-Request-Key": f"k-drain-{i}"})
            r = conn.getresponse()
            chunks = []
            for line in iter(r.readline, b""):
                if line.strip():
                    chunks.append(json.loads(line))
                    progress[i] = len(chunks)
                    if len(chunks) == 2:
                        started.wait(60)
            conn.close()
            results[i] = (r.status, chunks)

        m = "synapseml_llm_migrations_total"
        ok0, err0 = _metric(tobs, m, 'outcome="ok"'), _metric(tobs, m, 'outcome="error"')
        imp0 = _metric(tobs, "synapseml_llm_resubmits_total", 'mode="import"')
        res0 = _metric(tobs, "synapseml_llm_resubmits_total", 'mode="resume"')
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        started.wait(60)  # every stream has two chunks and is mid-decode on A
        register(srv_b, 2)
        st, body, _ = _request(srv_a.address, {"migrate_to": front.address},
                               path="/admin/drain")
        assert st < 300, body
        for t in threads:
            t.join(120)
        for (st, chunks), ref in zip(results, refs):
            assert st == 200 and _contiguous(chunks) == _contiguous(ref)
            assert "".join(c.get("text") or "" for c in chunks) == \
                "".join(c.get("text") or "" for c in ref)
        assert _metric(tobs, m, 'outcome="ok"') == ok0 + n
        assert _metric(tobs, m, 'outcome="error"') == err0
        assert _metric(tobs, "synapseml_llm_resubmits_total", 'mode="import"') == imp0 + n
        assert _metric(tobs, "synapseml_llm_resubmits_total", 'mode="resume"') == res0
    finally:
        front.close()
        registry.close()
        srv_a.stop()
        srv_b.stop()


def _worker_metric(address, name):
    with urllib.request.urlopen(address + "/metrics", timeout=10) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(name):
                return float(line.rsplit(" ", 1)[1])
    return None


@pytest.mark.chaos(timeout_s=150)
def test_sigkill_one_of_two_llm_workers_mid_decode_16_streams(weights, jax_tokens, tmp_path):
    """Two ``llm_worker_main`` processes (llama-tiny f32, the bridged
    weights, decode steps paced 20 ms longer); one is SIGKILLed once every
    stream has received a chunk."""
    _, sd = weights
    npz = str(tmp_path / "llama_tiny.npz")
    np.savez(npz, **{k: np.asarray(v) for k, v in sd.items()})
    registry = tds.WorkerRegistry()
    tok = HashingTokenizer(vocab_size=VOCAB).to_config()
    code = "\n".join([
        "import time, numpy as np, torch",
        "torch.set_num_threads(1)",
        "from synapseml_torch.hf import causal_lm as c",
        "from synapseml_torch.models.nets import llama as l",
        "c._ARCHS['llama-tiny'] = lambda **kw: l.llama_tiny(dtype=torch.float32, **kw)",
        "step = c.CausalLMServingEngine.step",
        "c.CausalLMServingEngine.step = lambda self: (time.sleep(0.02), step(self))[1]",
        "from synapseml_torch.io.distributed_serving import llm_worker_main",
        f"llm_worker_main('llama-tiny', {registry.address + '/register'!r}, max_new_tokens=64,",
        f"                device='cpu', warmup=False, stage_params={{'tokenizer': {tok!r},",
        f"                'decode_slots': 16, 'model_params': dict(np.load({npz!r}))}})"])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env) for _ in range(2)]
    front = None
    n, max_new = 16, 24
    rng = np.random.default_rng(35)
    prompts = [rng.integers(2, 200, (6,)).tolist() for _ in range(n)]
    try:
        want = [jax_tokens(p, max_new) for p in prompts]
        workers = registry.wait_for(2, timeout_s=90)
        victim = procs[0]
        assert victim.pid in {w["pid"] for w in workers}
        survivor = next(w for w in workers if w["pid"] != victim.pid)
        survivor_addr = f"http://{survivor['host']}:{survivor['port']}"
        for w in workers:  # both engines built and their first prefill done
            st, body, _ = _request(f"http://{w['host']}:{w['port']}",
                                   {"input_ids": prompts[0], "max_new_tokens": 2})
            assert st == 200, body
        front = tds.RoutingFront(registry=registry, timeout_s=60, journal=True)
        results, progress = [None] * n, [0] * n
        every_stream_going = threading.Event()

        def run(i):
            host, port = front.address.split("//")[1].split(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=120)
            conn.request("POST", "/", body=json.dumps(
                {"input_ids": prompts[i], "max_new_tokens": max_new, "stream": True}).encode(),
                headers={"X-Request-Key": f"k-kill-{i}"})
            r = conn.getresponse()
            chunks = []
            for line in iter(r.readline, b""):
                if line.strip():
                    chunks.append(json.loads(line))
                    progress[i] = len(chunks)
                    if all(progress):
                        every_stream_going.set()
            conn.close()
            results[i] = (r.status, chunks)

        resubmits0 = _metric(tobs, "synapseml_llm_resubmits_total")
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        assert every_stream_going.wait(60), "streams never got going"
        os.kill(victim.pid, signal.SIGKILL)  # mid-decode, no goodbye
        victim.wait(30)
        for t in threads:
            t.join(90)
        assert all(r is not None for r in results), "a client hung"
        for (st, chunks), w in zip(results, want):
            assert st == 200 and _contiguous(chunks) == w
        assert _metric(tobs, "synapseml_llm_resubmits_total") > resubmits0
        occ = None
        for _ in range(100):
            occ = _worker_metric(survivor_addr, "synapseml_llm_kv_block_occupancy")
            if occ == 0.0:
                break
            time.sleep(0.1)
        assert occ == 0.0, f"the survivor holds KV pages (occupancy {occ})"
    finally:
        if front is not None:
            front.close()
        registry.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(30)


def test_a_crash_resume_computes_no_model_digest(weights, jax_tokens, monkeypatch):
    """``__resume__`` re-prefills over prompt + relayed tokens whatever the
    engine's weights are, so it never hashes them (seconds on the serve
    loop at 7B width); its tokens are the uninterrupted run's."""
    srv = _worker(weights)
    try:
        prompt = [7, 3, 9, 12, 5]
        want = jax_tokens(prompt, 10)
        from synapseml_torch.models.paged_engine import PagedDecodeEngine

        def no_digest(self):
            raise AssertionError("a resume computed the model digest")

        monkeypatch.setattr(PagedDecodeEngine, "model_digest", no_digest)
        st, chunks, _ = _request(srv.address, {"__resume__": {
            "body": {"input_ids": prompt, "max_new_tokens": 10}, "emitted_ids": want[:4],
            "uid": 1}, "stream": True}, headers={"X-Request-Key": "k-resume"})
        assert st == 200, chunks
        toks = [c for c in chunks if "token" in c and not c.get("done")]
        assert [c["seq"] for c in toks] == list(range(4, 10))
        assert [c["token"] for c in toks] == want[4:] and chunks[-1]["output_ids"] == want
    finally:
        srv.stop()
