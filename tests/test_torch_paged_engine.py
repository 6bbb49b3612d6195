"""synapseml_torch's PagedDecodeEngine against the JAX engine and the port's
dense decode, plus the engine's scheduling, allocator, prefix-cache,
speculation, migration and sampling properties (the cases of
tests/test_paged_llm.py that need no io/serving).

The model is llama_tiny in f32 with the Flax init bridged by
``convert_jax``: greedy tokens are identical to the JAX engine's and to the
port's ``greedy_generate``, with the prefix cache and speculation (self-draft
and a drafter model) as without them; the JAX engines of a module share
their compiled programs through one CompiledCache instance. Sampling cannot
reproduce ``jax.random``'s bits; it is held by determinism per (seed, uid),
its support, and a chi-square bound on its frequencies.
"""

import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch.core import batching as cb
from synapseml_torch.core import observability as obs
from synapseml_torch.core.batching import ShapeBucketer
from synapseml_torch.hf.causal_lm import load_llama
from synapseml_torch.models import convert_jax
from synapseml_torch.models.nets import llama as tl
from synapseml_torch.models.paged_engine import BlockAllocator, PagedDecodeEngine

VOCAB = 256
LADDER = dict(ladder=[1, 2, 4, 8], seq_ladder=[8, 16, 32, 64])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast here, and idle OpenMP
    threads spinning after each small op would take cores from the other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tiny():
    from synapseml_tpu.models.flax_nets import llama as jl

    jcfg = jl.llama_tiny(dtype=jnp.float32)
    init = jax.jit(jl.LlamaLM(jcfg).init)
    params = nn.unbox(init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return jcfg, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def model(jax_tiny):
    _, params = jax_tiny
    return load_llama(tl.llama_tiny(dtype=torch.float32),
                      convert_jax.llama_state_dict_from_flax(params), "cpu")


@pytest.fixture(scope="module")
def jax_drafter():
    """A one-layer llama_tiny drafter: (JAX cfg, Flax params, port model)."""
    from synapseml_tpu.models.flax_nets import llama as jl

    jcfg = jl.llama_tiny(dtype=jnp.float32, n_layers=1)
    init = jax.jit(jl.LlamaLM(jcfg).init)
    params = nn.unbox(init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    params = jax.tree.map(np.asarray, params)
    return jcfg, params, load_llama(tl.llama_tiny(dtype=torch.float32, n_layers=1),
                                    convert_jax.llama_state_dict_from_flax(params), "cpu")


@pytest.fixture(scope="module")
def jax_engine(jax_tiny, jax_drafter):
    """A factory of JAX engines over the same weights as ``model``: ``ladder``
    (a ShapeBucketer's kwargs) and ``drafter=True`` stand for the JAX
    ShapeBucketer and the JAX drafter pair. Every engine of the module keys
    its programs under one instance, so a pool shape compiles once."""
    from synapseml_tpu.core.batching import ShapeBucketer as JShapeBucketer
    from synapseml_tpu.models.paged_engine import PagedDecodeEngine as JEngine

    jcfg, params = jax_tiny
    made = []

    def make(ladder=None, drafter=False, **kw):
        if ladder is not None:
            kw["bucketer"] = JShapeBucketer(**ladder)
        if drafter:
            kw["drafter"] = jax_drafter[:2]
        made.append(JEngine(jcfg, params, instance="torch-engine-parity", **kw))
        return made[-1]

    yield make
    if made:
        made[-1].release()  # evicts the shared instance's programs


def _dense_greedy(model, prompt, max_new, eos_id=None):
    P = max(((len(prompt) + 7) // 8) * 8, 8)
    ids = np.zeros((1, P), np.int64)
    mask = np.zeros((1, P), np.int64)
    ids[0, :len(prompt)] = prompt
    mask[0, :len(prompt)] = 1
    return tl.greedy_generate(model, ids, max_new, eos_id=eos_id,
                              prompt_mask=mask).numpy()[0, P:].tolist()


def _trim_eos(tokens, eos_id):
    out = []
    for t in tokens:
        if t == eos_id:
            break
        out.append(t)
    return out


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, VOCAB, (int(n),)).tolist() for n in lens]


def _run_to_done(eng, seq):
    deadline = time.perf_counter() + 120
    while not seq.done and time.perf_counter() < deadline:
        eng.admit()
        eng.step()
    assert seq.done, "sequence never finished"
    return list(seq.generated)


def _metric(name, **labels):
    fam = obs.get_registry().snapshot()
    key = name + ("{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}"
                  if labels else "")
    return fam.get(key, 0.0)


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

def test_paged_greedy_matches_jax_engine_and_dense(jax_tiny, model):
    """Four prompt rungs decoded together: the port's engine gives the JAX
    engine's tokens and the port's dense greedy_generate's."""
    from synapseml_tpu.core.batching import ShapeBucketer as JShapeBucketer
    from synapseml_tpu.models.paged_engine import PagedDecodeEngine as JEngine

    jcfg, params = jax_tiny
    prompts = _prompts(3, [5, 12, 27, 50])
    jeng = JEngine(jcfg, params, block_len=16, max_slots=4, bucketer=JShapeBucketer(**LADDER))
    want = jeng.generate(prompts, 12)
    jeng.release()
    eng = PagedDecodeEngine(model, block_len=16, max_slots=4, bucketer=ShapeBucketer(**LADDER))
    assert eng.generate(prompts, 12) == want
    assert [_dense_greedy(model, p, 12) for p in prompts] == want
    eng.release()


def test_paged_greedy_parity_with_early_eos(model):
    prompts = _prompts(5, [5, 12, 27, 50])
    max_new = 16
    free_run = [_dense_greedy(model, p, max_new) for p in prompts]
    eos_id = next(int(t) for row in free_run for t in row[1:max_new // 2]
                  if sum(t in r for r in free_run) < len(free_run))
    dense = [_trim_eos(_dense_greedy(model, p, max_new, eos_id=eos_id), eos_id)
             for p in prompts]
    assert any(len(d) < max_new for d in dense), "eos never fired"
    eng = PagedDecodeEngine(model, block_len=16, max_slots=4, eos_id=eos_id,
                            bucketer=ShapeBucketer(**LADDER))
    assert [_trim_eos(r, eos_id) for r in eng.generate(prompts, max_new)] == dense
    assert eng.allocator.used_count == 0
    eng.release()


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------

def test_block_allocator_invariants_property():
    rng = np.random.default_rng(0)
    alloc = BlockAllocator(33)
    live: dict[int, list[int]] = {}
    next_id = 0
    for _ in range(500):
        if live and rng.random() < 0.45:
            alloc.free(live.pop(int(rng.choice(list(live)))))
        else:
            got = alloc.alloc(int(rng.integers(1, 5)))
            if got is None:
                continue
            assert 0 not in got, "trash page handed out"
            flat = [b for blocks in live.values() for b in blocks]
            assert not (set(got) & set(flat)), "live page re-allocated"
            assert len(set(got)) == len(got)
            live[next_id] = got
            next_id += 1
        held = sum(len(b) for b in live.values())
        assert alloc.used_count == held
        assert alloc.free_count == alloc.capacity - held
    with pytest.raises(RuntimeError):
        alloc.free([0])


def test_block_allocator_refcount_invariants_property():
    rng = np.random.default_rng(1)
    alloc = BlockAllocator(25)
    holders: dict[int, int] = {}
    for _ in range(800):
        r = rng.random()
        if holders and r < 0.35:
            b = int(rng.choice(list(holders)))
            alloc.free([b])
            holders[b] -= 1
            if holders[b] == 0:
                del holders[b]
        elif holders and r < 0.55:
            b = int(rng.choice(list(holders)))
            alloc.ref(b)
            holders[b] += 1
        else:
            got = alloc.alloc(int(rng.integers(1, 4)))
            if got is None:
                continue
            assert 0 not in got and not (set(got) & set(holders))
            for b in got:
                holders[b] = 1
        for b, n in holders.items():
            assert alloc.refcount(b) == n, (b, n)
        assert alloc.used_count == len(holders)
        assert alloc.free_count == alloc.capacity - len(holders)
    for b, n in list(holders.items()):
        for _ in range(n):
            alloc.free([b])
    assert alloc.used_count == 0
    with pytest.raises(RuntimeError):
        alloc.free([1])
    with pytest.raises(RuntimeError):
        alloc.ref(1)
    with pytest.raises(RuntimeError):
        alloc.ref(0)


# ---------------------------------------------------------------------------
# scheduling
# ---------------------------------------------------------------------------

def test_engine_live_pages_never_alias(model):
    rng = np.random.default_rng(9)
    prompts = _prompts(9, rng.integers(3, 40, 12))
    budgets = [int(n) for n in rng.integers(1, 14, 12)]
    eng = PagedDecodeEngine(model, block_len=8, max_slots=4, n_blocks=40)
    seqs = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    while any(not s.done for s in seqs):
        eng.admit()
        eng.step()
        seen: set[int] = set()
        for s in eng._active:
            assert 0 not in s.blocks
            assert not (seen & set(s.blocks)), "live pages aliased"
            seen |= set(s.blocks)
        assert len(seen) == eng.allocator.used_count
    assert eng.allocator.used_count == 0
    eng.release()


def test_preemption_recomputes_identically(model):
    prompts = _prompts(13, [20] * 4)
    roomy = PagedDecodeEngine(model, block_len=8, max_slots=4)
    want = roomy.generate(prompts, 20)
    tight = PagedDecodeEngine(model, block_len=8, max_slots=4, n_blocks=14)
    seqs = [tight.submit(p, 20) for p in prompts]
    while any(not s.done for s in seqs):
        tight.admit()
        tight.step()
    assert [list(s.generated) for s in seqs] == want
    assert sum(s.preemptions for s in seqs) >= 1
    roomy.release()
    tight.release()


def test_oversized_sequence_finishes_kv_capacity_not_wedge(model):
    eng = PagedDecodeEngine(model, block_len=8, max_slots=2, n_blocks=4)
    big, ok = (eng.submit(p, 4) for p in _prompts(7, [30, 8]))
    for _ in range(50):
        if big.done and ok.done:
            break
        eng.admit()
        eng.step()
    assert big.finish_reason == "kv_capacity" and not big.generated
    assert ok.finish_reason == "length" and len(ok.generated) == 4
    assert eng.allocator.used_count == 0
    eng.release()


def test_slots_refill_before_long_sequence_finishes(model):
    eng = PagedDecodeEngine(model, block_len=8, max_slots=2)
    long_p, a_p, b_p = _prompts(2, [6, 6, 6])
    long_seq = eng.submit(long_p, 40)
    short_a = eng.submit(a_p, 3)
    short_b = eng.submit(b_p, 3)  # waits: only 2 slots
    refills = _metric("synapseml_llm_slots_refilled_total")
    while not short_b.done:
        eng.admit()
        eng.step()
        assert not long_seq.done, "refill never happened"
    assert short_a.done and not long_seq.done
    assert _metric("synapseml_llm_slots_refilled_total") > refills
    assert _run_to_done(eng, long_seq) and len(long_seq.generated) == 40
    eng.release()


def test_compile_counts_bounded_by_ladders(model):
    cache = cb.get_compiled_cache()
    p0 = cache.miss_count("llama_paged_prefill")
    d0 = cache.miss_count("llama_paged_decode")
    eng = PagedDecodeEngine(model, block_len=16, max_slots=8,
                            bucketer=ShapeBucketer(ladder=[2, 4, 8], seq_ladder=[16, 32, 64]))
    rng = np.random.default_rng(21)
    prompts = _prompts(21, rng.integers(3, 60, 24))
    eng.generate(prompts, [int(n) for n in rng.integers(1, 10, 24)])
    n_prefill = cache.miss_count("llama_paged_prefill") - p0
    n_decode = cache.miss_count("llama_paged_decode") - d0
    assert 0 < n_prefill <= len(eng.bucketer.seq_ladder)
    assert 0 < n_decode <= len(eng.slot_rungs)
    eng.release()


def test_warmup_precompiles_all_rungs(model):
    cache = cb.get_compiled_cache()
    eng = PagedDecodeEngine(model, block_len=16, max_slots=4,
                            bucketer=ShapeBucketer(ladder=[2, 4], seq_ladder=[16, 32, 64]))
    # prompt rungs 16/32/64 + the max_len cap bucket (128) + two slot rungs
    assert eng.warmup() == 4 + 2
    p0 = cache.miss_count("llama_paged_prefill")
    d0 = cache.miss_count("llama_paged_decode")
    rng = np.random.default_rng(8)
    eng.generate(_prompts(8, rng.integers(3, 60, 10)), 6)
    assert cache.miss_count("llama_paged_prefill") == p0
    assert cache.miss_count("llama_paged_decode") == d0
    eng.release()


def test_warmup_does_not_corrupt_live_sequences(model):
    prompts = _prompts(17, [10, 10])
    eng = PagedDecodeEngine(model, block_len=8, max_slots=2)
    want = eng.generate(prompts, 10)
    seqs = [eng.submit(p, 10) for p in prompts]
    eng.admit()
    for _ in range(4):
        eng.step()
    eng.warmup()  # every write lands on the trash page
    while any(not s.done for s in seqs):
        eng.step()
    assert [list(s.generated) for s in seqs] == want
    eng.release()


def test_generate_progress_is_engine_wide(model):
    eng = PagedDecodeEngine(model, block_len=8, max_slots=2)
    t0 = eng._progress_ticks
    eng.generate([[3, 4, 5]], 3)
    assert eng._progress_ticks > t0
    eng.release()


def test_deadline_abort_and_release(model):
    eng = PagedDecodeEngine(model, block_len=8, max_slots=2)
    a, b, c = (eng.submit(p, 8) for p in _prompts(4, [6, 7, 9]))
    eng.admit()
    a.deadline = time.perf_counter() - 1  # already past
    events = eng.step()
    assert a.finish_reason == "deadline" and not a.blocks
    assert any(e["seq"] is a and e["finish_reason"] == "deadline" for e in events)
    eng.abort(b, reason="client_gone")
    assert b.finish_reason == "client_gone"
    assert eng.abort_all() == [c] and c.finish_reason == "aborted"
    assert eng.allocator.used_count == 0 and not eng.has_work()
    eng.release()
    with pytest.raises(RuntimeError, match="released"):
        eng.step()


# ---------------------------------------------------------------------------
# prefix cache and speculation
# ---------------------------------------------------------------------------

def _shared_head_prompts(seed):
    rng = np.random.default_rng(seed)
    head = rng.integers(2, VOCAB, (24,)).tolist()  # 3 blocks of 8
    return [head[:5], head[:14], head + rng.integers(2, VOCAB, (4,)).tolist(),
            head + rng.integers(2, VOCAB, (30,)).tolist(), list(head)]


def _spec_stats(eng):
    st = eng.stats()
    return ({k: st["prefix_cache"][k] for k in ("hits", "tokens_reused")},
            {k: st["speculation"][k] for k in ("proposed", "accepted", "steps", "fallbacks")})


@pytest.mark.parametrize("drafter", ["self", "model"])
def test_prefix_and_spec_parity_across_rungs(model, jax_engine, jax_drafter, drafter):
    """Prefix cache + speculation (self-draft, or a dense drafter model)
    across prompt rungs, with cache hits, a fully-cached COW prompt and
    multi-token steps, twice: the JAX engine's tokens, cache hits and
    acceptance counts, and the plain engine's tokens."""
    prompts = _shared_head_prompts(41)
    kw = dict(block_len=8, max_slots=4)
    plain = PagedDecodeEngine(model, bucketer=ShapeBucketer(**LADDER), **kw)
    want = plain.generate(prompts, 10)
    plain.release()
    jeng = jax_engine(ladder=LADDER, prefix_cache=True, draft_tokens=3,
                      drafter=drafter == "model", **kw)
    extra = {"drafter": jax_drafter[2]} if drafter == "model" else {}
    boosted = PagedDecodeEngine(model, prefix_cache=True, draft_tokens=3,
                                bucketer=ShapeBucketer(**LADDER), **extra, **kw)
    for round_ in range(2):
        jax_out = jeng.generate(prompts, 10)
        assert boosted.generate(prompts, 10) == jax_out, f"diverged on round {round_}"
        assert jax_out == want
        assert _spec_stats(boosted) == _spec_stats(jeng)
    pc, spec = _spec_stats(boosted)
    assert pc["hits"] > 0 and pc["tokens_reused"] > 0
    assert spec["steps"] > 0
    boosted.release()


def test_prefix_and_spec_parity_with_early_eos(model, jax_engine):
    rng = np.random.default_rng(43)
    head = rng.integers(2, VOCAB, (16,)).tolist()
    prompts = [head + rng.integers(2, VOCAB, (int(n),)).tolist() for n in (2, 9, 21, 40)]
    kw = dict(block_len=8, max_slots=4)
    free_eng = PagedDecodeEngine(model, bucketer=ShapeBucketer(**LADDER), **kw)
    free_run = free_eng.generate(prompts, 16)
    free_eng.release()
    eos_id = next(int(t) for row in free_run for t in row[1:8]
                  if sum(t in r for r in free_run) < len(free_run))
    plain = PagedDecodeEngine(model, eos_id=eos_id, bucketer=ShapeBucketer(**LADDER), **kw)
    want = [_trim_eos(r, eos_id) for r in plain.generate(prompts, 16)]
    plain.release()
    assert any(len(r) < 16 for r in want), "eos never fired"
    jeng = jax_engine(ladder=LADDER, eos_id=eos_id, prefix_cache=True, draft_tokens=3, **kw)
    jax_out = [_trim_eos(r, eos_id) for r in jeng.generate(prompts, 16)]
    boosted = PagedDecodeEngine(model, eos_id=eos_id, prefix_cache=True, draft_tokens=3,
                                bucketer=ShapeBucketer(**LADDER), **kw)
    assert [_trim_eos(r, eos_id) for r in boosted.generate(prompts, 16)] == jax_out == want
    assert _spec_stats(boosted) == _spec_stats(jeng)
    assert boosted.allocator.used_count == len(boosted.prefix_cache.block_ids())
    assert boosted.allocator.used_count == jeng.allocator.used_count
    boosted.release()


def _drive(eng, seqs):
    deadline = time.perf_counter() + 120
    while any(not s.done for s in seqs) and time.perf_counter() < deadline:
        eng.admit()
        eng.step()
    return [list(s.generated) for s in seqs]


# the pool of the preemption and fuzz tests: one shape, one set of JAX programs
TIGHT = dict(block_len=8, max_slots=4, n_blocks=28, prefix_cache=True, draft_tokens=3)


def test_prefix_and_spec_parity_under_preemption(model, jax_engine):
    """Four sequences of 7 pages each on 27 free pages: preemption and
    recompute, with the prefix cache and speculation on, give the JAX
    engine's tokens and preemptions and the roomy engine's tokens."""
    prompts = _prompts(45, [36] * 4)
    roomy = PagedDecodeEngine(model, block_len=8, max_slots=4, bucketer=ShapeBucketer(**LADDER))
    want = roomy.generate(prompts, 20)
    roomy.release()
    jtight = jax_engine(ladder=LADDER, **TIGHT)
    jseqs = [jtight.submit(p, 20) for p in prompts]
    jax_out = _drive(jtight, jseqs)
    tight = PagedDecodeEngine(model, bucketer=ShapeBucketer(**LADDER), **TIGHT)
    seqs = [tight.submit(p, 20) for p in prompts]
    assert _drive(tight, seqs) == jax_out == want
    assert sum(s.preemptions for s in seqs) >= 1
    assert [s.preemptions for s in seqs] == [s.preemptions for s in jseqs]
    tight.release()


def test_speculation_is_greedy_only(model):
    with pytest.raises(ValueError, match="greedy"):
        PagedDecodeEngine(model, block_len=8, max_slots=2, draft_tokens=3, temperature=0.9)


def test_compile_counts_bounded_with_prefix_and_spec(model):
    cache = cb.get_compiled_cache()
    ids = ("llama_paged_prefill", "llama_paged_extend", "llama_paged_decode",
           "llama_paged_spec")
    before = {i: cache.miss_count(i) for i in ids}
    eng = PagedDecodeEngine(model, block_len=16, max_slots=8, prefill_batch=2,
                            prefix_cache=True, draft_tokens=3,
                            bucketer=ShapeBucketer(ladder=[2, 4, 8], seq_ladder=[16, 32, 64]))
    rng = np.random.default_rng(47)
    heads = [rng.integers(2, VOCAB, (20,)).tolist() for _ in range(3)]
    prompts = [heads[k % 3] + rng.integers(2, VOCAB, (int(rng.integers(1, 30)),)).tolist()
               for k in range(24)]
    for _ in range(2):
        eng.generate(prompts, 8)
    assert eng.stats()["prefix_cache"]["hits"] > 0
    assert eng.stats()["speculation"]["steps"] > 0
    n_seq = len(eng.bucketer.seq_buckets_upto(eng.max_len))
    d = {i: cache.miss_count(i) - before[i] for i in ids}
    assert 0 < d["llama_paged_prefill"] <= n_seq and 0 < d["llama_paged_extend"] <= n_seq, d
    assert d["llama_paged_decode"] <= len(eng.slot_rungs), d
    assert 0 < d["llama_paged_spec"] <= len(eng.slot_rungs), d
    eng.release()


def test_warmup_covers_extend_and_spec_rungs(model):
    cache = cb.get_compiled_cache()
    eng = PagedDecodeEngine(model, block_len=16, max_slots=4, prefill_batch=2,
                            prefix_cache=True, draft_tokens=3,
                            bucketer=ShapeBucketer(ladder=[2, 4], seq_ladder=[16, 32, 64]))
    eng.warmup()
    ids = ("llama_paged_prefill", "llama_paged_extend", "llama_paged_decode",
           "llama_paged_spec")
    before = {i: cache.miss_count(i) for i in ids}
    rng = np.random.default_rng(49)
    head = rng.integers(2, VOCAB, (32,)).tolist()
    prompts = [head + rng.integers(2, VOCAB, (int(n),)).tolist()
               for n in rng.integers(1, 30, (8,))]
    for _ in range(2):
        eng.generate(prompts, 6)
    assert eng.stats()["prefix_cache"]["hits"] > 0
    for i in ids:
        assert cache.miss_count(i) == before[i], f"{i} built after warmup"
    eng.release()


def _assert_refcount_conservation(eng):
    holders: dict[int, int] = {}
    cache_blocks = eng.prefix_cache.block_ids()
    for s in eng._active:
        assert 0 not in s.blocks
        for b in s.blocks:
            holders[b] = holders.get(b, 0) + 1
        wi = s.tokens_in_pages // eng.block_len
        if wi < len(s.blocks):
            wb = s.blocks[wi]
            assert eng.allocator.refcount(wb) == 1, f"seq {s.uid} would write shared block"
            assert wb not in cache_blocks
    for b in cache_blocks:
        holders[b] = holders.get(b, 0) + 1
    for b, n in holders.items():
        assert eng.allocator.refcount(b) == n, (b, n)
    assert eng.allocator.used_count == len(holders)


def test_prefix_cache_fuzz_refcounts_cow_and_parity(model, jax_engine):
    """A random stream of submissions, the JAX engine driven in lockstep:
    after every step the same sequences have the same tokens and the same
    pages are held; refcounts are conserved; every finished sequence equals
    the plain engine's run of its prompt."""
    rng = np.random.default_rng(51)
    heads = [rng.integers(2, VOCAB, (16,)).tolist() for _ in range(2)]
    eng = PagedDecodeEngine(model, bucketer=ShapeBucketer(**LADDER), **TIGHT)
    jeng = jax_engine(ladder=LADDER, **TIGHT)
    plain = PagedDecodeEngine(model, block_len=8, max_slots=4, bucketer=ShapeBucketer(**LADDER))
    live, done = [], []

    def step_both():
        for e in (eng, jeng):
            e.admit()
            e.step()
        _assert_refcount_conservation(eng)
        for s, js in live:
            assert list(s.generated) == list(js.generated) and s.done == js.done
        assert eng.allocator.used_count == jeng.allocator.used_count

    for _ in range(24):
        if rng.random() < 0.7:
            r = rng.random()
            h = heads[int(rng.integers(0, 2))]
            if r < 0.3:
                p = list(h)  # block-multiple prompt: the COW path
            elif r < 0.8:
                p = h + rng.integers(2, VOCAB, (int(rng.integers(1, 12)),)).tolist()
            else:
                p = rng.integers(2, VOCAB, (int(rng.integers(3, 20)),)).tolist()
            n = int(rng.integers(2, 8))
            live.append((eng.submit(p, n), jeng.submit(p, n)))
        step_both()
        done += [s for s, _ in live if s.done]
        live = [(s, js) for s, js in live if not s.done]
    while live:
        step_both()
        done += [s for s, _ in live if s.done]
        live = [(s, js) for s, js in live if not s.done]
    assert eng.stats()["prefix_cache"]["hits"] > 0
    assert _spec_stats(eng) == _spec_stats(jeng)
    for s in done:
        assert list(s.generated) == plain.generate([list(s.prompt_ids)], s.max_new_tokens)[0]
    plain.release()
    eng.release()


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def test_export_import_greedy_token_identity(model):
    prompt = _prompts(21, [11])[0]
    reference = _dense_greedy(model, prompt, 12)
    src = PagedDecodeEngine(model, block_len=8, max_slots=2)
    dst = PagedDecodeEngine(model, block_len=8, max_slots=2)
    seq = src.submit(prompt, 12, request_id="mig", stream=True)
    while len(seq.generated) < 4:
        src.admit()
        src.step()
    snap = src.export_sequence(seq.uid)
    assert src.allocator.used_count == 0, "export leaked source pages"
    assert snap["manifest"]["model_digest"] == dst.model_digest()
    moved = dst.import_sequence(snap)
    assert moved.tokens_in_pages == len(moved.context_ids) - 1  # the fast path
    assert list(moved.generated) == list(seq.generated)
    assert _run_to_done(dst, moved) == reference
    assert dst.allocator.used_count == 0
    assert src.export_sequence(12345) is None
    src.release()
    dst.release()


def test_import_digest_mismatch_falls_back_to_reprefill(model):
    prompt = _prompts(22, [9])[0]
    reference = _dense_greedy(model, prompt, 10)
    src = PagedDecodeEngine(model, block_len=8, max_slots=2)
    dst = PagedDecodeEngine(model, block_len=8, max_slots=2)
    seq = src.submit(prompt, 10)
    while len(seq.generated) < 3:
        src.admit()
        src.step()
    snap = src.export_sequence(seq.uid)
    snap["manifest"]["model_digest"] = "not-the-same-model"
    preempt0 = _metric("synapseml_llm_slots_preempted_total")
    moved = dst.import_sequence(snap)
    assert moved.tokens_in_pages == 0, "mismatched digest spliced KV"
    assert _run_to_done(dst, moved) == reference
    assert _metric("synapseml_llm_slots_preempted_total") > preempt0
    src.release()
    dst.release()


def test_export_import_sampled_identity(model):
    prompt = _prompts(23, [9])[0]
    kw = dict(block_len=8, max_slots=2, temperature=0.9, top_p=0.95, seed=5)
    ref_eng, src, dst = (PagedDecodeEngine(model, **kw) for _ in range(3))
    reference = ref_eng.generate([prompt], 10, uids=[77])[0]
    seq = src.submit(prompt, 10, uid=77)
    while len(seq.generated) < 4:
        src.admit()
        src.step()
    moved = dst.import_sequence(src.export_sequence(seq.uid))
    assert moved.uid == 77
    assert _run_to_done(dst, moved) == reference
    for e in (ref_eng, src, dst):
        e.release()


def test_export_import_bf16_pages_and_shared_prefix():
    """bf16 pages ride the payload as raw bytes and come back bitwise; a
    sequence holding shared prefix pages exports with the source's cache
    intact."""
    cfg = tl.llama_tiny()  # bf16 compute
    bmodel = load_llama(cfg, convert_jax.init_llama_params(cfg, seed=2, device="cpu"), "cpu")
    rng = np.random.default_rng(24)
    head = rng.integers(2, VOCAB, (16,)).tolist()
    kw = dict(block_len=8, max_slots=2, prefix_cache=True)
    src, dst = PagedDecodeEngine(bmodel, **kw), PagedDecodeEngine(bmodel, **kw)
    src.generate([head + [5, 6]], 3)  # fills the cache with the head's blocks
    seq = src.submit(head + [7, 8, 9], 10)
    while len(seq.generated) < 3:
        src.admit()
        src.step()
    rows = torch.as_tensor(seq.blocks)
    T = seq.tokens_in_pages
    k_before = src._k_pages[1][rows].reshape(-1, cfg.kv_heads, cfg.head_dim)[:T].clone()
    snap = src.export_sequence(seq.uid)
    assert snap["manifest"]["chunks"]["kv/k/001"]["dtype"] == "bfloat16"
    assert src.allocator.used_count == len(src.prefix_cache.block_ids())
    moved = dst.import_sequence(snap)
    got = dst._k_pages[1][torch.as_tensor(moved.blocks)].reshape(
        -1, cfg.kv_heads, cfg.head_dim)[:T]
    assert torch.equal(got, k_before)
    rest = _run_to_done(dst, moved)
    assert len(rest) == 10
    src.release()
    dst.release()


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_paged_sampling_deterministic_per_uid(model):
    prompts = _prompts(11, [9, 9, 9])
    kw = dict(block_len=16, max_slots=4, temperature=0.9, top_p=0.95)
    a, b, c = (PagedDecodeEngine(model, seed=s, **kw).generate(prompts, 8, uids=[10, 11, 12])
               for s in (1, 1, 2))
    assert a == b and a != c
    # a stream is a function of (seed, uid), not of its neighbours
    solo = PagedDecodeEngine(model, seed=1, **kw).generate(prompts[1:2], 8, uids=[11])
    assert solo[0] == a[1]


def test_sampled_tokens_stay_in_the_support(model):
    """Every sampled token lies in its step's top-k, and with top_p in the
    nucleus of that top-k (the logits recomputed by one forward)."""
    prompts = _prompts(12, [7, 13, 20])
    for top_k, top_p in ((5, None), (12, 0.6)):
        eng = PagedDecodeEngine(model, block_len=8, max_slots=4, temperature=1.0,
                                top_k=top_k, top_p=top_p, seed=3)
        out = eng.generate(prompts, 10)
        eng.release()
        for p, g in zip(prompts, out):
            with torch.no_grad():
                logits = model(torch.as_tensor([p + g]))[0, len(p) - 1:len(p) - 1 + len(g)]
            vals, idx = torch.topk(logits, top_k, dim=-1)
            for t, (v, i) in enumerate(zip(vals, idx)):
                allowed = i
                if top_p is not None:
                    probs = torch.softmax(v, -1)
                    allowed = i[(torch.cumsum(probs, -1) - probs) < top_p]
                assert g[t] in allowed.tolist(), (top_k, top_p, t)


# the 0.999 quantiles of chi-square by degrees of freedom
CHI2_999 = {3: 16.27, 4: 18.47, 7: 24.32}


@pytest.mark.parametrize("top_k,top_p", [(None, None), (5, None), (None, 0.7)])
def test_sampling_frequencies_follow_the_softmax(top_k, top_p):
    """20000 draws at fixed logits over 8 tokens: the counts against the
    renormalised softmax of the kept set by chi-square, under its 0.999
    quantile for the kept set's degrees of freedom (the bound is stated; the draws are seeded)."""
    logits = torch.log(torch.tensor([[0.25, 0.2, 0.15, 0.12, 0.1, 0.08, 0.06, 0.04]]))
    p = torch.softmax(logits[0], -1).double()
    keep = torch.ones(8, dtype=torch.bool)
    if top_k is not None:
        keep[top_k:] = False
    if top_p is not None:
        keep = (torch.cumsum(p, 0) - p) < top_p
    want = torch.where(keep, p, 0.0)
    want = want / want.sum()
    select = tl._make_selector(1.0, top_k, top_p)
    n = 20000
    draws = select(logits.expand(n, 8), tl.fold_in(0, 1))
    counts = torch.bincount(draws, minlength=8).double()
    assert counts[~keep].sum() == 0
    expected = n * want[keep]
    chi2 = float(((counts[keep] - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_999[int(keep.sum()) - 1], chi2
    # the same key draws the same tokens
    assert torch.equal(select(logits.expand(n, 8), tl.fold_in(0, 1)), draws)
