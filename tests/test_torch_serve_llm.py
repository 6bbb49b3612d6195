"""synapseml_torch's serve_llm against the JAX package's.

One process runs both token schedulers over llama-tiny in f32 (the presets
patched to f32 on both sides, the Flax weights bridged with
``convert_jax``) and sends both the same bodies: greedy ``output_ids``,
chunk framing (``token``/``seq``/``uid`` per chunk, the terminal record),
``finish_reason``s, ``X-Deadline-Ms`` 504s and 4xx replies are equal. On
the port alone: a dropped stream is reaped (``client_gone``) and a drain
whose ``migrate_to`` is dead re-imports every live stream locally, each
ending with the tokens of an undrained run, and its pages freed.
"""

import json
import threading
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving_stages import request
from synapseml_torch.core import observability as tobs
from synapseml_torch.hf import HuggingFaceCausalLM
from synapseml_torch.hf import causal_lm as tcl
from synapseml_torch.io import serving as tsrv
from synapseml_torch.models import convert_jax
from synapseml_torch.models.nets import llama as tl
from synapseml_torch.models.tokenizer import HashingTokenizer
from synapseml_tpu.hf import causal_lm as jcl
from synapseml_tpu.io import serving as jsrv
from synapseml_tpu.models.flax_nets import llama as jl

VOCAB = 512
WORDS = "the a of and to in is was model token paged cache decode stream".split()


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
    return dict(model_name="llama-tiny", engine="paged", max_new_tokens=8,
                tokenizer=HashingTokenizer(vocab_size=VOCAB).to_config(), decode_slots=4)


@pytest.fixture()
def servers(weights):
    params, sd = weights
    srvs = []
    try:
        srvs.append(jsrv.serve_llm(jcl.HuggingFaceCausalLM(**_kw(), model_params=params),
                                   warmup=False))
        srvs.append(tsrv.serve_llm(HuggingFaceCausalLM(**_kw(), model_params=sd, device="cpu"),
                                   warmup=False))
        yield srvs
    finally:
        for s in srvs:
            s.stop()


def _bodies(n, seed):
    rs = np.random.default_rng(seed)
    out = []
    for i in range(n):
        body = {"prompt": " ".join(rs.choice(WORDS, size=int(rs.integers(1, 30)))),
                "max_new_tokens": int(rs.integers(1, 20))}
        if i % 3 == 1:
            body["stream"] = True
        if i % 5 == 4:
            body = {"input_ids": rs.integers(3, VOCAB, int(rs.integers(2, 12))).tolist(),
                    "stream": bool(i % 2)}
        out.append(body)
    return out


def _exchange(base, body, headers=None):
    """(status, records): a buffered reply as one record, a stream as its
    NDJSON chunks."""
    status, hdrs, data = request(base, "POST", "/", body, headers=headers, timeout=60)
    if hdrs.get("Content-Type") == "application/x-ndjson":
        return status, [json.loads(line) for line in data.decode().splitlines()]
    return status, [json.loads(data)]


def _strip_uid(records):
    return [{k: v for k, v in r.items() if k != "uid"} for r in records]


def test_replies_and_chunk_framing_match_jax(servers):
    bodies = _bodies(12, seed=0)
    # one at a time: the engines assign the same uids in the same order
    seq = [[_exchange(s.address, b) for b in bodies] for s in servers]
    assert seq[0] == seq[1]
    streams = [r for st, r in seq[1] if len(r) > 1]
    assert streams and all(r[-1]["done"] and [c["seq"] for c in r[:-1]] == list(range(len(r) - 1))
                           and [c["token"] for c in r[:-1]] == r[-1]["output_ids"] for r in streams)
    assert {r[-1]["finish_reason"] for _, r in seq[1]} <= {"length", "eos"}
    # eight clients at once: the same tokens (uids follow arrival order)
    got = []
    for s in servers:
        out = [None] * len(bodies)

        def client(k, base=s.address, out=out):
            for i in range(k, len(bodies), 4):
                out[i] = _exchange(base, bodies[i])

        ts = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        got.append([(st, _strip_uid(r)) for st, r in out])
    assert got[0] == got[1] == [(st, _strip_uid(r)) for st, r in seq[1]]


@pytest.mark.parametrize("body", [
    {"prompt": ""}, {"max_new_tokens": 3}, [1, 2, 3], b"{not json", b"",
    {"input_ids": []}, {"input_ids": list(range(3, 200))},
], ids=["empty-prompt", "no-prompt", "list", "not-json", "no-body", "empty-ids", "too-long"])
def test_bad_requests_match_jax(servers, body):
    replies = [request(s.address, "POST", "/", body) for s in servers]
    (js, _, jd), (ts, _, td) = replies
    assert ts == js and ts in (400, 200)
    assert json.loads(td) == json.loads(jd)


def test_deadline_gets_504_and_frees_pages(servers):
    body = {"prompt": "the model decodes a long stream", "max_new_tokens": 50}
    replies = [_exchange(s.address, body, headers={"X-Deadline-Ms": "0.001"}) for s in servers]
    assert replies[0] == replies[1]
    status, (rec,) = replies[1]
    assert status == 504 and rec["finish_reason"] == "deadline" and rec["done"]
    for s in servers:
        llm = json.loads(request(s.address, "GET", "/admin/stats")[2])["llm"]
        assert llm["active"] == llm["waiting"] == llm["blocks_used"] == 0


def _slow_steps(monkeypatch):
    """Each decode step 10 ms longer, so that streams are live when the
    test acts on them."""
    step = tcl.CausalLMServingEngine.step

    def slow(self):
        time.sleep(0.01)
        return step(self)

    monkeypatch.setattr(tcl.CausalLMServingEngine, "step", slow)


def _open_stream(base, body, key):
    import http.client
    from urllib.parse import urlsplit

    parts = urlsplit(base)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=60)
    conn.request("POST", "/", body=json.dumps(body).encode(),
                 headers={"X-Request-Key": key})
    resp = conn.getresponse()
    assert resp.status == 200
    return conn, resp


def test_client_gone_is_reaped(servers, monkeypatch):
    _slow_steps(monkeypatch)
    tserver = servers[1]
    conn, resp = _open_stream(tserver.address, {"prompt": "a b c", "max_new_tokens": 100,
                                                "stream": True}, "gone")
    json.loads(resp.readline())
    conn.sock.close()
    conn.close()
    for _ in range(300):
        llm = json.loads(request(tserver.address, "GET", "/admin/stats")[2])["llm"]
        if llm["active"] == 0 and llm["blocks_used"] == 0:
            break
        time.sleep(0.02)
    assert llm["active"] == 0 and llm["blocks_used"] == 0
    snap = tobs.get_registry().snapshot()
    assert snap.get('synapseml_llm_sequences_finished_total{reason="client_gone"}', 0) >= 1


def test_drain_with_a_dead_migrate_to_reimports_locally(servers, monkeypatch):
    tserver = servers[1]
    bodies = [{"prompt": " ".join(WORDS[:n]), "max_new_tokens": 100, "stream": True}
              for n in (3, 7, 11)]
    want = [_exchange(tserver.address, b)[1][-1]["output_ids"] for b in bodies]
    _slow_steps(monkeypatch)
    m = "synapseml_llm_migrations_total"
    before = tobs.get_registry().snapshot().get(f'{m}{{outcome="error",reason="drain"}}', 0)
    streams = [_open_stream(tserver.address, b, f"key{i}") for i, b in enumerate(bodies)]
    firsts = [json.loads(resp.readline()) for _, resp in streams]
    status, _, data = request(tserver.address, "POST", "/admin/drain",
                              {"migrate_to": "http://127.0.0.1:9", "timeout_s": 30})
    assert status == 200 and json.loads(data)["draining"]
    for (conn, resp), first, out in zip(streams, firsts, want):
        recs = [first] + [json.loads(line) for line in resp.read().decode().splitlines()]
        conn.close()
        assert recs[-1]["done"] and recs[-1]["output_ids"] == out
        assert [r["token"] for r in recs[:-1]] == out
        assert [r["seq"] for r in recs[:-1]] == list(range(len(out)))
    after = tobs.get_registry().snapshot()[f'{m}{{outcome="error",reason="drain"}}']
    assert after - before == len(bodies)
    llm = json.loads(request(tserver.address, "GET", "/admin/stats")[2])["llm"]
    assert llm["active"] == 0 and llm["blocks_used"] == 0
    assert request(tserver.address, "POST", "/", bodies[0])[0] == 503
