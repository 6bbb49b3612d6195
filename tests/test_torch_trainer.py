"""synapseml_torch's trainer against the JAX package's.

* The optimizer against optax itself (the JAX package's ``_make_optimizer``)
  on the same random parameter and gradient trees, 10 steps, each schedule,
  the clip active and not, ``freeze_predicate`` and ``grad_accum=2``:
  params within rtol 1e-6 (atol 1e-6 for entries near 0). The learning
  rate is 0.1, so a missed trap (lr != 0 on the first warm-up step, the
  clip's threshold, decay on frozen leaves) moves a parameter by ~0.1.
* Both ``Trainer``s on ``bert_tiny`` in f32 with the Flax init bridged
  (einsum attention, and once ``attn_impl='flash'``: the flash backward),
  6 steps on the same batches (padded rows with ``_valid = 0``): per-step
  loss within 1e-5, ``grad_norm`` within rtol 1e-4, final params within
  atol 2e-5 (summation order differs between XLA and torch; Adam turns a
  relative gradient difference into the same relative update difference)
  on at least 99.9 % of each leaf's entries, and every entry within
  lr x steps: an entry whose gradient cancels to ~0 moves on rounding
  noise, which Adam scales up to lr a step. The attention key bias, whose
  exact gradient is 0, is held on both sides to within lr x steps of its
  init.
* ``fit_source`` over a multi-shard ``MemorySource`` against ``fit_arrays``
  over the same rows, bitwise; a resume from a state and the loader's
  ``IteratorState`` equal to the uninterrupted run, bitwise.
* The non-finite guard and the refused options.
"""


import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import synapseml_torch as pt
from synapseml_torch.core import observability as tobs
from synapseml_torch.data import DataLoader, MemorySource
from synapseml_torch.models import convert_jax
from synapseml_torch.models import trainer as tt
from synapseml_torch.models.nets import bert as tbert
from synapseml_tpu.models import trainer as jt
from synapseml_tpu.models.flax_nets import bert as jbert
from synapseml_tpu.parallel.mesh import MeshConfig, create_mesh

VOCAB, T, B = 128, 12, 8


def _ONE_DEVICE():
    return create_mesh(MeshConfig(), devices=jax.devices()[:1])

# ---------------------------------------------------------------- optimizer


def _tree(rs):
    return {"enc": {"w": rs.normal(size=(6, 5)).astype(np.float32),
                    "b": rs.normal(size=5).astype(np.float32)},
            "head": {"w": rs.normal(size=(5, 3)).astype(np.float32),
                     "b": rs.normal(size=3).astype(np.float32)}}


_NAMES = ["enc.w", "enc.b", "head.w", "head.b"]


def _leaves(tree):
    return [np.asarray(tree[a][b]) for a, b in (n.split(".") for n in _NAMES)]


_OPT_CASES = {
    "constant": dict(lr_schedule="constant"),
    "cosine": dict(lr_schedule="cosine"),
    "linear, clip active": dict(lr_schedule="linear", grad_clip=1.0),
    "linear, clip inactive": dict(lr_schedule="linear", grad_clip=100.0),
    "freeze_predicate": dict(lr_schedule="linear", freeze_predicate=lambda p: p[0] == "enc"),
    "grad_accum=2": dict(lr_schedule="cosine", grad_accum=2),
}


@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = _OPT_CASES[case]
    rs = np.random.default_rng(0)
    params = _tree(rs)
    grads = [jax.tree.map(lambda x: (rs.normal(size=x.shape) * 0.5).astype(np.float32), params)
             for _ in range(10)]
    cfg = dict(learning_rate=0.1, weight_decay=0.05, total_steps=10, warmup_steps=3, **kw)
    tx = jt._make_optimizer(jt.TrainerConfig(**cfg), params)
    update = jax.jit(tx.update)
    jstate, jparams = tx.init(params), params
    opt = tt._Optimizer(tt.TrainerConfig(**cfg), _NAMES)
    tparams = [torch.tensor(x) for x in _leaves(params)]
    tstate = opt.init(tparams)
    for i, g in enumerate(grads):
        upd, jstate = update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update([torch.tensor(x) for x in _leaves(g)], tstate, tparams)
        for name, want, got in zip(_NAMES, _leaves(jparams), tparams):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} after step {i + 1}")
    moved = [not np.array_equal(a, b) for a, b in zip(_leaves(params), tparams)]
    if "freeze_predicate" in kw:
        assert moved == [False, False, True, True]
    else:
        assert all(moved)


def test_first_linear_warmup_step_leaves_the_params_unchanged():
    params = [torch.ones(3)]
    cfg = tt.TrainerConfig(learning_rate=0.1, lr_schedule="linear", warmup_steps=2,
                           total_steps=10)
    opt = tt._Optimizer(cfg, ["w"])
    state = opt.init(params)
    opt.update([torch.ones(3)], state, params)
    assert torch.equal(params[0], torch.ones(3)) and state.count == 1
    opt.update([torch.ones(3)], state, params)
    assert not torch.equal(params[0], torch.ones(3))


def test_schedules_match_optax():
    for sched in ("constant", "cosine", "linear"):
        for warm in (0, 1, 4):
            cfg = dict(learning_rate=3e-4, warmup_steps=warm, total_steps=20, lr_schedule=sched)
            want = jt._make_schedule(jt.TrainerConfig(**cfg))
            got = tt._make_schedule(tt.TrainerConfig(**cfg))
            for count in range(22):
                w = float(want(jnp.int32(count))) if callable(want) else float(want)
                assert got(count).dtype == np.float32
                np.testing.assert_allclose(float(got(count)), w, rtol=1e-6,
                                           err_msg=f"{sched} warmup {warm} at {count}")


def test_cross_entropy_divides_by_the_valid_rows():
    rs = np.random.default_rng(3)
    logits = rs.normal(size=(6, 3)).astype(np.float32)
    labels = rs.integers(0, 3, 6).astype(np.int32)
    for mask in (np.array([1, 1, 1, 1, 0, 0], np.float32), np.zeros(6, np.float32), None):
        want = jt.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     None if mask is None else jnp.asarray(mask))
        got = tt.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                    None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ------------------------------------------------------------ bert_tiny steps


def _configs(vocab=VOCAB, attn_impl="einsum"):
    jcfg = jbert.bert_tiny(vocab_size=vocab, dtype=jnp.float32, max_len=32, attn_impl=attn_impl)
    tcfg = tbert.bert_tiny(vocab_size=vocab, dtype=torch.float32, max_len=32,
                           attn_impl=attn_impl)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def flax_init():
    jcfg, _ = _configs()
    init = jax.jit(jbert.BertClassifier(jcfg, 2).init)
    tree = nn.unbox(init(jax.random.PRNGKey(0), np.ones((1, T), np.int32))["params"])
    return jax.tree.map(np.asarray, tree)


def _batches(n=6, seed=0):
    rs = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mask = np.ones((B, T), np.int32)
        for r in range(B):
            mask[r, rs.integers(3, T + 1):] = 0
        valid = np.ones(B, np.float32)
        valid[B - 1 - i % 3:] = 0.0  # padded tail rows, as the loader's tail batch has
        out.append({"input_ids": (rs.integers(1, VOCAB, (B, T)) * mask).astype(np.int32),
                    "attention_mask": mask,
                    "labels": rs.integers(0, 2, B).astype(np.int32),
                    "_valid": valid})
    return out


def _freeze_enc0_flax(path):  # encoder layer 0 and the embeddings frozen
    return not (path[0] in ("classifier", "pooler") or "layer_1" in path)


def _freeze_enc0_port(path):
    return not (path[0] in ("classifier", "pooler") or path[:3] == ("encoder", "layers", "1"))


_TRAIN_CASES = {  # the three schedules; freezing, accumulation and flash ride on them
    "constant": (dict(lr_schedule="constant"), {}),
    # the flash kernel's forward and backward (their plain versions on the
    # CPU) against the JAX flash_attention (Pallas in interpret mode) and
    # its custom_vjp backward
    "constant, attn_impl=flash": (dict(lr_schedule="constant"), dict(attn_impl="flash")),
    "cosine, freeze_predicate": (dict(lr_schedule="cosine", warmup_steps=2),
                                 dict(freeze=(_freeze_enc0_flax, _freeze_enc0_port))),
    "linear, grad_accum=2": (dict(lr_schedule="linear", warmup_steps=1, grad_accum=2), {}),
}


@pytest.mark.parametrize("case", sorted(_TRAIN_CASES))
def test_bert_tiny_steps_match_jax(case, flax_init):
    kw, extra = _TRAIN_CASES[case]
    common = dict(learning_rate=2e-3, total_steps=6, grad_clip=1.0, **kw)
    jfreeze, tfreeze = extra.get("freeze", (None, None))
    jcfg, tcfg = _configs(attn_impl=extra.get("attn_impl", "einsum"))
    batches = _batches()

    jtrainer = jt.Trainer(jbert.BertClassifier(jcfg, 2), _ONE_DEVICE(),
                          jt.TrainerConfig(freeze_predicate=jfreeze, **common))
    jstate = jtrainer.resume_state(flax_init)  # init_state(init_params=...) without the module init
    ttrainer = tt.Trainer(tbert.BertClassifier(tcfg, 2),
                          tt.TrainerConfig(freeze_predicate=tfreeze, **common), device="cpu")
    init_sd = convert_jax.bert_state_dict_from_flax(flax_init)
    tstate = ttrainer.init_state(init_params=init_sd)
    for i, batch in enumerate(batches):
        jstate, jm = jtrainer.train_step(jstate, batch)
        tstate, tm = ttrainer.train_step(tstate, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), atol=1e-5,
                                   err_msg=f"loss at step {i}")
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-4, err_msg=f"grad_norm at step {i}")
    want = convert_jax.bert_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    assert tstate.step == 6
    for name, p in tstate.params.items():
        if name.endswith("attn.k.bias"):
            # its gradient is 0 in exact arithmetic (softmax ignores a shift
            # shared by a row's scores): both sides train it on rounding
            # noise, which Adam scales up to at most lr a step
            bound = common["learning_rate"] * 6
            for got in (p.detach().numpy(), want[name]):
                assert np.abs(got - init_sd[name]).max() <= bound, name
            continue
        got = p.detach().numpy()
        # an entry whose gradient cancels to ~0 (here and there a word
        # embedding under accumulation) is moved by rounding noise, up to lr a
        # step; all others agree to 2e-5
        off = np.abs(got - want[name]) > 2e-5
        assert off.mean() <= 1e-3, (name, int(off.sum()))
        assert np.abs(got - want[name]).max() <= common["learning_rate"] * 6, name
        if tfreeze is not None and tfreeze(tuple(name.split("."))):
            assert np.array_equal(p.detach().numpy(), init_sd[name]), name
        else:
            assert not np.array_equal(p.detach().numpy(), init_sd[name]), name


def _mlp():
    return torch.nn.Sequential(torch.nn.Linear(4, 16), torch.nn.ReLU(), torch.nn.Linear(16, 3))


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.mlp = _mlp()

    def forward(self, x):
        return self.mlp(x)


def _rows(n=96, seed=2):
    rs = np.random.default_rng(seed)
    return {"x": rs.normal(size=(n, 4)).astype(np.float32),
            "labels": (np.arange(n) % 3).astype(np.int32)}


def _trainer(total=14, **kw):
    return tt.Trainer(_Net(), tt.TrainerConfig(total_steps=total, learning_rate=1e-2, **kw),
                      device="cpu")


def test_fit_source_over_partitions_matches_fit_arrays():
    data = _rows()
    df = pt.DataFrame.from_dict(data, num_partitions=3)  # partitions of 32 rows
    assert [len(p["x"]) for p in df.partitions] == [32, 32, 32]
    s1 = tt.fit_source(_trainer(), MemorySource(df), batch_size=16, total_steps=14, seed=3)
    s2 = tt.fit_arrays(_trainer(), data, batch_size=16, total_steps=14, seed=3, shard_rows=32)
    s3 = tt.fit_source(_trainer(), MemorySource(df, shard_rows=32), batch_size=16,
                       total_steps=14, seed=3)
    assert s1.step == s2.step == s3.step == 14
    for name in s1.params:
        assert torch.equal(s1.params[name], s2.params[name]), name
        assert torch.equal(s1.params[name], s3.params[name]), name


def test_fit_source_resumes_the_stream_from_a_state():
    data = _rows()
    full = tt.fit_arrays(_trainer(12), data, batch_size=16, total_steps=12, seed=5,
                         shard_rows=32)
    trainer = _trainer(12)
    half = tt.fit_source(trainer, MemorySource(data, shard_rows=32), batch_size=16,
                         total_steps=8, seed=5)
    assert half.step == 8
    with pytest.raises(ValueError, match="data_state"):
        tt.fit_source(trainer, MemorySource(data, shard_rows=32), batch_size=16,
                      total_steps=12, seed=5, state=half)
    # the loader's cursor after batch 8: what a checkpoint would carry
    loader = DataLoader(MemorySource(data, shard_rows=32), 16, seed=5)
    it = iter(loader)
    for _ in range(8):
        next(it)
    tree = loader.state_for_batch(8).to_tree()
    loader.close()
    resumed = tt.fit_source(trainer, MemorySource(data, shard_rows=32), batch_size=16,
                            total_steps=12, seed=5, state=half, data_state=tree)
    assert resumed.step == 12
    for name in full.params:
        assert torch.equal(full.params[name], resumed.params[name]), name


def test_fit_logs_windows_and_the_last_step_with_callback_and_skip():
    data = _rows()
    trainer = _trainer(10)
    seen = []
    state = trainer.init_state(seed=0)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    batches = list(DataLoader(MemorySource(data), 16, seed=1, epochs=2))
    state = trainer.fit(state, iter(batches[:1]), max_steps=1, skip_fn=lambda i: i == 0)
    assert state.step == 1 and all(torch.equal(before[k], v) for k, v in state.params.items())
    state = trainer.fit(state, iter(batches[1:]), max_steps=9, log_every=4,
                        callback=lambda i, m: seen.append((i, float(m["loss"]))))
    assert state.step == 10 and [i for i, _ in seen] == list(range(9))
    assert [m["step"] for m in trainer.metrics] == [4, 8, 9]
    assert trainer.metrics[-1]["loss"] == seen[-1][1]
    assert trainer.last_finite_step == 10
    snap = tobs.get_registry().snapshot()
    assert snap['synapseml_train_skipped_steps_total{engine="trainer"}'] >= 1
    assert snap['synapseml_train_step_duration_ms{engine="trainer"}']["count"] >= 3


def test_seeded_init_without_init_params_is_reproducible():
    a = _trainer().init_state(seed=4).params
    b = _trainer().init_state(seed=4).params
    c = _trainer().init_state(seed=5).params
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def _poisoned(n_bad_at):
    data = _rows(64)
    batches = list(DataLoader(MemorySource(data), 16, seed=0, epochs=1))
    batches[n_bad_at]["x"] = np.full_like(batches[n_bad_at]["x"], np.nan)
    return batches


def test_nonfinite_raise_names_the_poisoned_step():
    trainer = _trainer(4, nonfinite_action="raise")
    state = trainer.init_state(seed=0)
    with pytest.raises(tt.NonFiniteLossError, match="at step 3") as err:
        trainer.fit(state, iter(_poisoned(2)), max_steps=4, scan_chunk=1)  # per step
    assert err.value.step == 3 and err.value.last_finite_step == 2


def test_nonfinite_raise_names_the_poisoned_step_inside_a_chunk():
    """The chunked fit reads a chunk's losses at once and still names the
    first poisoned step: batch 2 of the chunk of batches 0-3 trains step 3."""
    trainer = _trainer(4, nonfinite_action="raise")
    state = trainer.init_state(seed=0)
    with pytest.raises(tt.NonFiniteLossError, match="at step 3") as err:
        trainer.fit(state, iter(_poisoned(2)), max_steps=4, scan_chunk=4)
    assert err.value.step == 3 and err.value.last_finite_step == 2
    assert state.step == 4  # the whole chunk ran


def test_nonfinite_count_increments_the_registry_counter():
    reg = tobs.reset_registry()
    trainer = _trainer(4)
    trainer.fit(trainer.init_state(seed=0), iter(_poisoned(2)), max_steps=4)
    snap = reg.snapshot()
    assert snap['synapseml_train_nonfinite_total{engine="trainer"}'] == 2  # NaN params after
    assert snap["synapseml_train_last_finite_step"] == 2


class _BeatGang:
    """A gang worker that records beats and never returns a verdict."""

    run_id = None

    def __init__(self):
        self.beats = []

    def heartbeat(self, step):
        self.beats.append(int(step))

    def check(self, step):
        return None


def test_unported_trainer_options_are_refused(tmp_path):
    """The options that were refused until their slice was ported now run:
    the gang seam (a beat at the start step, one a step; fit_gang_source
    writes a coordinated shard at every checkpoint step, which the driver's
    commit makes restorable), a rule table with ZeRO, a mesh, a
    checkpointer, resume_from (held to the JAX package in
    test_torch_gang.py, test_torch_trainer_mesh.py and
    test_torch_checkpoint.py)."""
    from synapseml_torch import parallel as tp

    data = _rows()
    cfg = tt.TrainerConfig(partition_rules=tp.PartitionRules(), zero_shard=True)
    trainer = tt.Trainer(_Net(), cfg, device="cpu", mesh=tp.create_mesh())
    state = trainer.init_state()
    gang = _BeatGang()
    assert trainer.fit(state, iter([]), max_steps=1, gang=gang).step == 0
    assert gang.beats == [0]
    gang, gang_dir = _BeatGang(), str(tmp_path / "gang")
    got = tt.fit_gang_source(trainer, MemorySource(data), batch_size=16, total_steps=4, seed=0,
                             gang=gang, checkpoint_dir=gang_dir, rank=0, world=1,
                             checkpoint_every=2)
    assert got.step == 4 and gang.beats == [0, 1, 2, 3, 4]
    assert tp.latest_verified_step(gang_dir) is None  # no driver has committed yet
    assert tp.commit_checkpoint(gang_dir, 4, 1) is not None
    assert tp.elastic_restore(gang_dir).step == 4
    with tp.AsyncCheckpointer(str(tmp_path / "ck"), keep=2) as ck:
        got = tt.fit_arrays(trainer, data, batch_size=16, total_steps=4, seed=0,
                            checkpointer=ck, checkpoint_every=2)
    assert got.step == 4 and tp.latest_verified_step(str(tmp_path / "ck")) == 4
    assert tp.checkpoint_sharding(str(tmp_path / "ck"))["rules"]["zero_axes"] == ["data", "fsdp"]
    fresh = tt.fit_source(_trainer(), MemorySource(data), batch_size=16, total_steps=2, seed=0,
                          resume_from=str(tmp_path / "none"))
    assert fresh.step == 2


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.Trainer(_Net(), tt.TrainerConfig())


def test_plan_fit_matches_jax():
    for args in [(100, 32, 3, -1), (10, 32, 2, -1), (100, 32, 3, 7)]:
        assert tt.plan_fit(*args) == jt.plan_fit(*args)
    with pytest.raises(ValueError, match="empty"):
        tt.plan_fit(0, 8, 1, -1)


def test_meter_reports_mfu_against_the_named_peak(monkeypatch):
    from synapseml_torch.core.instrumentation import chip_peak_tflops

    assert chip_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert chip_peak_tflops("cpu") is None
    trainer = _trainer()
    state = trainer.init_state()
    meter = tt._ThroughputMeter(trainer, state.params)
    assert meter.peak is None and meter.flops_per_token == 6 * sum(
        p.numel() for p in state.params.values())
    meter.peak = 100.0
    meter.observe({"input_ids": np.zeros((4, 8), np.int32)})
    entry = meter.entry(0.5)
    assert entry["step"] == 1 and entry["samples_per_sec"] > 0
    assert entry["mfu"] == round(entry["model_tflops_per_sec"] / 100.0, 4)


def test_dropout_stays_off_in_training():
    trainer = tt.Trainer(torch.nn.Sequential(torch.nn.Dropout(0.5), torch.nn.Linear(4, 3)),
                         tt.TrainerConfig(learning_rate=0.0), device="cpu",
                         loss_fn=lambda m, b: tt.cross_entropy_loss(m(b["x"]), b["labels"]))
    state = trainer.init_state(seed=0)
    batch = {"x": np.ones((8, 4), np.float32), "labels": np.zeros(8, np.int32)}
    losses = {trainer.train_step(state, batch)[1]["loss"].item() for _ in range(3)}
    assert len(losses) == 1 and not trainer.module.training
