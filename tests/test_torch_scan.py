"""synapseml_torch's scanned training step and chunked fit against the JAX package's.

* ``Trainer.train_steps_scan`` over K stacked batches against K
  ``train_step`` calls on ``bert_tiny`` in f32: losses, gradient norms,
  parameters, moments and counters bitwise equal, for the constant, linear
  and cosine schedules, with ``freeze_predicate``, and with
  ``grad_accum = 2`` from both accumulation phases. On the CPU the K steps
  run eagerly through the step body that the card captures in a CUDA graph,
  so equality here is exact.
* The port's ``train_steps_scan`` against the JAX ``Trainer.train_steps_scan``
  (one ``lax.scan``) on the same bridged weights and stacked batches: per
  step loss within 1e-5, gradient norm within rtol 1e-4, parameters within
  atol 2e-5 with the Adam-noise allowance of
  ``test_torch_trainer.py::test_bert_tiny_steps_match_jax`` (at most 0.1 %
  of a leaf's entries further off, none by more than lr x steps).
* ``fit(scan_chunk=3)`` against ``fit(scan_chunk=1)``, bitwise, over a
  stream whose batch shape changes mid-stream and that ends in an odd
  tail (``tests/test_trainer_extra.py::test_streaming_fit_chunked_matches_per_step``);
  the log windows' steps equal to the JAX chunked fit's on the same
  stream; a producer error raised in the fit, and a consumer error
  stopping the producer.
* A second fit on one trainer bitwise a fresh trainer's; ``init_state``
  dropping the trainer's captured graphs, and a graph refusing a state
  whose tensors are not the ones it was captured with.
* The port's ``CompiledCache`` against the JAX one on the same key
  sequence: hits, misses, evictions and LRU order, exactly.
"""

import threading
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch.core import batching as tcb
from synapseml_torch.core import observability as tobs
from synapseml_torch.models import convert_jax
from synapseml_torch.models import trainer as tt
from synapseml_torch.models.nets import bert as tbert
from synapseml_tpu.core import batching as jcb
from synapseml_tpu.models import trainer as jt
from synapseml_tpu.models.flax_nets import bert as jbert
from synapseml_tpu.parallel.mesh import MeshConfig, create_mesh

VOCAB, T, B, K = 128, 12, 8, 3


def _configs():
    jcfg = jbert.bert_tiny(vocab_size=VOCAB, dtype=jnp.float32, max_len=32)
    tcfg = tbert.bert_tiny(vocab_size=VOCAB, dtype=torch.float32, max_len=32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def flax_init():
    jcfg, _ = _configs()
    init = jax.jit(jbert.BertClassifier(jcfg, 2).init)
    tree = nn.unbox(init(jax.random.PRNGKey(0), np.ones((1, T), np.int32))["params"])
    return jax.tree.map(np.asarray, tree)


def _batch(rs, i, b=B, t=T):
    mask = np.ones((b, t), np.int32)
    for r in range(b):
        mask[r, rs.integers(3, t + 1):] = 0
    valid = np.ones(b, np.float32)
    valid[b - 1 - i % 3:] = 0.0  # padded tail rows, as the loader's tail batch has
    return {"input_ids": (rs.integers(1, VOCAB, (b, t)) * mask).astype(np.int32),
            "attention_mask": mask,
            "labels": rs.integers(0, 2, b).astype(np.int32),
            "_valid": valid}


def _batches(n, seed=0):
    rs = np.random.default_rng(seed)
    return [_batch(rs, i) for i in range(n)]


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _freeze_enc0_port(path):  # encoder layer 0 and the embeddings frozen
    return not (path[0] in ("classifier", "pooler") or path[:3] == ("encoder", "layers", "1"))


def _freeze_enc0_flax(path):
    return not (path[0] in ("classifier", "pooler") or "layer_1" in path)


# name -> (TrainerConfig keywords, steps run per step before the chunks)
_SCAN_CASES = {
    "constant": (dict(lr_schedule="constant"), 0),
    "linear": (dict(lr_schedule="linear", warmup_steps=2), 0),
    "cosine": (dict(lr_schedule="cosine", warmup_steps=2), 0),
    "cosine, freeze_predicate": (dict(lr_schedule="cosine", warmup_steps=2,
                                      freeze_predicate=_freeze_enc0_port), 0),
    "linear, grad_accum=2 from phase 0": (dict(lr_schedule="linear", warmup_steps=1,
                                               grad_accum=2), 0),
    "linear, grad_accum=2 from phase 1": (dict(lr_schedule="linear", warmup_steps=1,
                                               grad_accum=2), 1),
}


def _port_trainer(init_sd, **kw):
    _, tcfg = _configs()
    trainer = tt.Trainer(tbert.BertClassifier(tcfg, 2),
                         tt.TrainerConfig(learning_rate=2e-3, total_steps=8, grad_clip=1.0, **kw),
                         device="cpu")
    return trainer, trainer.init_state(init_params=init_sd)


@pytest.mark.parametrize("case", sorted(_SCAN_CASES))
def test_scan_matches_per_step_bitwise(case, flax_init):
    """Two chunks of K steps through ``train_steps_scan`` against the same
    2K batches through ``train_step``, after ``lead`` per-step steps (which
    put a ``grad_accum = 2`` chunk at phase 1): everything bitwise equal."""
    kw, lead = _SCAN_CASES[case]
    init_sd = convert_jax.bert_state_dict_from_flax(flax_init)
    batches = _batches(lead + 2 * K)
    runs = []
    for scanned in (False, True):
        trainer, state = _port_trainer(init_sd, **kw)
        for b in batches[:lead]:
            trainer.train_step(state, b)
        rest = batches[lead:]
        if scanned:
            assert state.opt_state.mini_step == lead % kw.get("grad_accum", 1)
            metrics = [trainer.train_steps_scan(state, _stack(rest[i:i + K]))[1]
                       for i in (0, K)]
            loss = torch.cat([m["loss"] for m in metrics])
            norm = torch.cat([m["grad_norm"] for m in metrics])
            assert loss.shape == norm.shape == (2 * K,)
        else:
            metrics = [trainer.train_step(state, b)[1] for b in rest]
            loss = torch.stack([m["loss"] for m in metrics])
            norm = torch.stack([m["grad_norm"] for m in metrics])
        runs.append((loss, norm, state))
    (l1, n1, s1), (l2, n2, s2) = runs
    assert torch.equal(l1, l2) and torch.equal(n1, n2)
    assert (s1.step, s1.opt_state.count, s1.opt_state.mini_step) == \
        (s2.step, s2.opt_state.count, s2.opt_state.mini_step)
    for name in s1.params:
        assert torch.equal(s1.params[name], s2.params[name]), name
    for a, b in zip(s1.opt_state.mu + s1.opt_state.nu + (s1.opt_state.acc or []),
                    s2.opt_state.mu + s2.opt_state.nu + (s2.opt_state.acc or [])):
        assert torch.equal(a, b)
    if "freeze_predicate" in kw:
        frozen = [n for n in s2.params if _freeze_enc0_port(tuple(n.split(".")))]
        assert frozen and all(torch.equal(s2.params[n], torch.tensor(init_sd[n])) for n in frozen)


_JAX_CASES = {
    "linear": (dict(lr_schedule="linear", warmup_steps=1), None),
    "cosine, freeze_predicate": (dict(lr_schedule="cosine", warmup_steps=2),
                                 (_freeze_enc0_flax, _freeze_enc0_port)),
    "linear, grad_accum=2": (dict(lr_schedule="linear", warmup_steps=1, grad_accum=2), None),
}


@pytest.mark.parametrize("case", sorted(_JAX_CASES))
def test_scan_matches_jax_scan(case, flax_init):
    kw, freeze = _JAX_CASES[case]
    jfreeze, tfreeze = freeze or (None, None)
    common = dict(learning_rate=2e-3, total_steps=8, grad_clip=1.0, **kw)
    jcfg, _ = _configs()
    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrainer = jt.Trainer(jbert.BertClassifier(jcfg, 2), mesh,
                          jt.TrainerConfig(freeze_predicate=jfreeze, **common))
    jstate = jtrainer.resume_state(flax_init)
    init_sd = convert_jax.bert_state_dict_from_flax(flax_init)
    ttrainer, tstate = _port_trainer(init_sd, freeze_predicate=tfreeze, **kw)
    batches = _batches(2 * K, seed=1)
    for i in (0, K):
        chunk = _stack(batches[i:i + K])
        jstate, jm = jtrainer.train_steps_scan(jstate, chunk)
        tstate, tm = ttrainer.train_steps_scan(tstate, chunk)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), atol=1e-5,
                                   err_msg=f"losses of the chunk at {i}")
        np.testing.assert_allclose(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"]),
                                   rtol=1e-4, err_msg=f"grad norms of the chunk at {i}")
    assert tstate.step == int(jstate.step) == 2 * K
    want = convert_jax.bert_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    lr_steps = common["learning_rate"] * 2 * K
    for name, p in tstate.params.items():
        got = p.detach().numpy()
        if name.endswith("attn.k.bias"):
            # its exact gradient is 0: both sides train it on rounding noise
            for x in (got, want[name]):
                assert np.abs(x - init_sd[name]).max() <= lr_steps, name
            continue
        off = np.abs(got - want[name]) > 2e-5
        assert off.mean() <= 1e-3, (name, int(off.sum()))
        assert np.abs(got - want[name]).max() <= lr_steps, name


# ------------------------------------------------------------ chunked fit


def _stream():
    """7 batches of [8, 12], then 2 of [16, 8]: a shape change mid-stream,
    and with scan_chunk=3 an odd tail of 1 before it."""
    rs = np.random.default_rng(5)
    return ([_batch(rs, i) for i in range(7)]
            + [_batch(rs, i, b=16, t=8) for i in range(2)])


def test_chunked_fit_matches_per_step_fit_bitwise(flax_init):
    init_sd = convert_jax.bert_state_dict_from_flax(flax_init)
    states = []
    for chunk in (1, 3):
        trainer, state = _port_trainer(init_sd, lr_schedule="cosine", warmup_steps=2)
        calls = {"scan": 0}
        scan = trainer.train_steps_scan

        def counted(state, stacked, scan=scan, calls=calls):
            calls["scan"] += 1
            return scan(state, stacked)

        trainer.train_steps_scan = counted
        state = trainer.fit(state, iter(_stream()), max_steps=20, scan_chunk=chunk)
        assert state.step == 9  # the finite stream is shorter than max_steps
        # chunks of 3: batches 0-2 and 3-5; 6 alone (the shape changes), 7-8 short
        assert calls["scan"] == (0 if chunk == 1 else 2)
        states.append(state)
    for name in states[0].params:
        assert torch.equal(states[0].params[name], states[1].params[name]), name
    assert states[0].opt_state.count == states[1].opt_state.count == 9


def test_log_windows_match_the_jax_chunked_fit(flax_init):
    jcfg, _ = _configs()
    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:1])
    jtrainer = jt.Trainer(jbert.BertClassifier(jcfg, 2), mesh, jt.TrainerConfig(total_steps=20))
    jtrainer.fit(jtrainer.resume_state(flax_init), iter(_stream()), max_steps=9, log_every=4,
                 scan_chunk=3)
    ttrainer, tstate = _port_trainer(convert_jax.bert_state_dict_from_flax(flax_init))
    ttrainer.fit(tstate, iter(_stream()), max_steps=9, log_every=4, scan_chunk=3)
    steps = [m["step"] for m in ttrainer.metrics]
    assert steps == [m["step"] for m in jtrainer.metrics] == [6, 9]
    assert all(m["samples_per_sec"] > 0 for m in ttrainer.metrics)
    assert ttrainer.last_finite_step == 9


def _mlp_trainer(loss_fn=None):
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 3))
    trainer = tt.Trainer(net, tt.TrainerConfig(total_steps=50, learning_rate=1e-2),
                         device="cpu", loss_fn=loss_fn or (
                             lambda m, b: tt.cross_entropy_loss(m(b["x"]), b["labels"])))
    return trainer, trainer.init_state(seed=0)


def _mlp_batches(n, seed=0):
    rs = np.random.default_rng(seed)
    for _ in range(n):
        yield {"x": rs.normal(size=(6, 4)).astype(np.float32),
               "labels": rs.integers(0, 3, 6).astype(np.int32)}


def _producers() -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.name == "fit-chunk-producer"]


def test_a_producer_error_is_raised_in_the_fit():
    def failing():
        yield from _mlp_batches(5)
        raise OSError("shard 3 is unreadable")

    trainer, state = _mlp_trainer()
    with pytest.raises(OSError, match="shard 3 is unreadable"):
        trainer.fit(state, failing(), max_steps=20, scan_chunk=2)
    assert state.step == 4  # the two whole chunks before the error trained


def test_a_consumer_error_stops_the_producer():
    def loss_fn(module, batch):
        if float(batch["x"][0, 0]) > 1e8:
            raise RuntimeError("a bad step")
        return tt.cross_entropy_loss(module(batch["x"]), batch["labels"])

    def endless():
        n = 0
        while True:
            for b in _mlp_batches(1, seed=n):
                if n == 4:
                    b["x"][0, 0] = 1e9
                yield b
            n += 1

    trainer, state = _mlp_trainer(loss_fn)
    with pytest.raises(RuntimeError, match="a bad step"):
        trainer.fit(state, endless(), max_steps=10_000, scan_chunk=2)
    deadline = time.monotonic() + 10
    while _producers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _producers()


def test_a_second_fit_on_one_trainer_matches_a_fresh_trainers():
    # bitwise: the same ops from the same init on the same stream
    def fitted(trainer, state):
        state = trainer.fit(state, _mlp_batches(9), max_steps=9, scan_chunk=2)
        return {k: v.detach().clone() for k, v in state.params.items()}

    trainer, state = _mlp_trainer()
    fitted(trainer, state)
    again = fitted(trainer, trainer.init_state(seed=0))
    fresh = fitted(*_mlp_trainer())
    assert all(torch.equal(again[k], fresh[k]) for k in fresh)


def test_init_state_drops_the_trainers_graphs():
    trainer, _ = _mlp_trainer()
    cache, token = tcb.get_compiled_cache(), tcb.instance_token(trainer)
    cache.get("train_steps_scan", ("key",), lambda: (lambda: None), instance=token)
    trainer._warm.add(("key",))
    trainer.init_state(seed=1)
    assert not [k for k in cache._entries if k[1] == token] and not trainer._warm


def test_a_graph_refuses_a_state_it_was_not_captured_with():
    trainer, first = _mlp_trainer()
    second = trainer.init_state(seed=0)  # the same module, new optimizer moments
    assert tt._binding(trainer, first) == tt._binding(trainer, first)
    assert tt._binding(trainer, first) != tt._binding(trainer, second)
    graph = tt._ChunkGraph.__new__(tt._ChunkGraph)  # as a capture with `first` leaves it
    graph.graph, graph.binding = object(), tt._binding(trainer, first)
    with pytest.raises(RuntimeError, match="release_graphs"):
        graph(trainer, second, {}, np.zeros((0, 4), np.float32), [])


def test_meter_counts_stacked_chunks():
    trainer, state = _mlp_trainer()
    meter = tt._ThroughputMeter(trainer, state.params)
    meter.observe({"input_ids": np.zeros((4, 6, 8), np.int32)}, steps=4)
    meter.observe({"input_ids": np.zeros((6, 8), np.int32)})
    assert (meter.steps, meter.n_samples, meter.n_tokens) == (5, 30, 240)


# ---------------------------------------------------------- CompiledCache


def _drive(cache, keys):
    """Get each (fn, shape, instance) key, each build returning a distinct
    callable; the trace of which keys were built."""
    built = []

    def build(fn, shape):
        built.append((fn, shape))
        return lambda: (fn, shape)

    for fn, shape, inst in keys:
        cache.get(fn, shape, lambda fn=fn, shape=shape: build(fn, shape), instance=inst)
    return built


def test_compiled_cache_matches_jax():
    rs = np.random.default_rng(0)
    keys = [(f"fn{rs.integers(0, 2)}", (int(rs.integers(1, 4)), 8), f"i{rs.integers(0, 2)}")
            for _ in range(60)]
    tobs.reset_registry()
    port, ref = tcb.CompiledCache(capacity=3), jcb.CompiledCache(capacity=3)
    built = _drive(port, keys)
    assert built == _drive(ref, keys)
    got, want = port.stats(), ref.stats()
    assert {k: got[k] for k in ("hits", "misses", "evictions", "size")} == \
        {k: want[k] for k in ("hits", "misses", "evictions", "size")}
    assert got["misses"] > 3 and got["evictions"] > 0 and got["hits"] > 0
    assert list(port._entries) == list(ref._entries)  # the same LRU order
    assert port.miss_count("fn0") == sum(fn == "fn0" for fn, _ in built)
    # the first call of a miss runs under a compile span, timed; later ones not
    fn = port.get("fn9", (1,), lambda: (lambda: 7))
    assert fn() == 7 and fn() == 7
    snap = tobs.get_registry().snapshot()
    assert snap['synapseml_compile_trace_ms{fn="fn9"}']["count"] == 1
    assert [s.attributes for s in tobs.get_tracer().finished_spans()
            if s.name == "compile" and s.attributes["fn"] == "fn9"] == [
                {"fn": "fn9", "shape": "(1,)"}]
    held = [k for k in port._entries if k[1] == "i0"]
    evictions = port.evictions
    assert port.evict_instance("i0") == len(held) and port.evictions == evictions + len(held)
    assert not [k for k in port._entries if k[1] == "i0"]


def test_compiled_cache_refuses_the_aot_tier():
    cache = tcb.CompiledCache()
    with pytest.raises(NotImplementedError, match="item 10"):
        cache.install_aot_provider(object())
    with pytest.raises(NotImplementedError, match="item 10"):
        cache.set_capture(object())
    with pytest.raises(ValueError, match="capacity"):
        tcb.CompiledCache(capacity=0)
