"""The port's partition plane against the JAX package's, in one process.

* ``MeshConfig.resolve`` against the JAX ``MeshConfig.resolve`` over a
  table of configs and world sizes, errors included.
* The default rule tables on the port's ``state_dict`` names place the
  same tensor elements on the same mesh coordinates as the JAX tables on
  the Flax leaves: every Flax leaf is filled with its element ids, mapped
  to the port's layout by ``convert_jax`` (transposes, head merges), and
  for every coordinate of each mesh the ids a device holds under the JAX
  spec equal those the port's spec gives it. BERT (``bert_tiny``) and
  Llama (``llama_tiny``, GQA) on a tensor mesh and on a tensor-less fsdp
  mesh (the tables' two modes).
* ``zero_shard_spec``, the ``PartitionRules`` JSON round trip and digest,
  ``opt_state_specs``, ``checkpoint_sharding_fn``, ``split_stage_params``,
  ``spec_digests`` and ``apply_manifest_sharding``'s demotion, each held to
  the JAX function on the same inputs.
"""

import itertools
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch import parallel as tp
from synapseml_torch.models import convert_jax
from synapseml_torch.parallel import partition as tpart
from synapseml_tpu.models.flax_nets import bert as jbert
from synapseml_tpu.models.flax_nets import llama as jl
from synapseml_tpu.parallel import partition as jpart
from synapseml_tpu.parallel.mesh import MeshConfig as JMeshConfig


def test_mesh_config_resolves_as_jax():
    cases = [dict(), dict(data=2), dict(data=-1, fsdp=2), dict(data=2, tensor=2),
             dict(data=1, seq=4), dict(data=-1, tensor=4), dict(data=3),
             dict(data=-1, fsdp=-1), dict(data=2, fsdp=2, tensor=2)]
    for kw, n in itertools.product(cases, (1, 2, 4, 8)):
        try:
            want = JMeshConfig(**kw).resolve(n)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tp.MeshConfig(**kw).resolve(n)
            assert str(got.value) == str(e)
            continue
        assert tp.MeshConfig(**kw).resolve(n) == want, (kw, n)


def test_one_process_mesh_degrades_like_allow_fewer():
    m = tp.create_mesh(tp.MeshConfig(data=2, tensor=2))
    assert m.axis_sizes == dict(data=1, fsdp=1, tensor=1, seq=1, expert=1, pipe=1)
    assert m.device_mesh is None and m.coordinate()["data"] == 0
    with pytest.raises(ValueError):
        tp.create_mesh(tp.MeshConfig(data=2, tensor=2), allow_fewer=False)
    batch = {"x": np.arange(6)}
    assert np.array_equal(m.shard_batch(batch)["x"], batch["x"])
    t = torch.ones(3)
    assert tpart.place_leaf(t, m.sharding("data")) is t


# ---- the rule tables: the same elements on the same coordinates ----------


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _id_tree(tree):
    """The Flax tree with each leaf filled with element ids unique across
    the tree (float64: exact up to 2^53)."""
    off = [0]

    def fill(x):
        a = np.arange(off[0], off[0] + x.size, dtype=np.float64).reshape(x.shape)
        off[0] += x.size
        return a

    return jax.tree.map(fill, tree)


def _held(arr, spec, sizes, coord):
    """The ids a device at ``coord`` holds of ``arr`` under ``spec``."""
    index = []
    for d in range(arr.ndim):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            index.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = math.prod(sizes[a] for a in axes)
        i = 0
        for a in axes:
            i = i * sizes[a] + coord[a]
        size = arr.shape[d] // n
        index.append(slice(i * size, (i + 1) * size))
    return set(arr[tuple(index)].ravel().tolist())


def _divides(shape, spec, sizes):
    for d, entry in enumerate(spec):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            if shape[d] % math.prod(sizes[a] for a in axes):
                return False
    return True


def _coords(sizes):
    axes = list(sizes)
    for combo in itertools.product(*(range(sizes[a]) for a in axes)):
        yield dict(zip(axes, combo))


def _check_same_placement(flax_tree, to_port, jrules, trules, cfg):
    sizes = cfg.resolve(math.prod(v for v in (cfg.data, cfg.fsdp, cfg.tensor, cfg.seq,
                                                cfg.expert, cfg.pipe)))
    ids = _id_tree(flax_tree)
    port = to_port(ids)
    # the Flax leaf each port leaf came from, by its first id
    owner = {}
    for path, leaf in _flat(ids):
        owner[int(leaf.ravel()[0])] = ("/".join(path), leaf)
    checked = 0
    for name, arr in port.items():
        fname, fleaf = owner[int(np.min(arr))]
        jspec = jrules.spec_for(fname, fleaf.shape)
        tspec = trules.spec_for(name, arr.shape)
        if not _divides(fleaf.shape, jspec, sizes):
            continue  # the JAX table cannot place it here (its validation refuses)
        for coord in _coords(sizes):
            assert _held(fleaf, jspec, sizes, coord) == _held(arr, tspec, sizes, coord), \
                (name, fname, jspec, tspec, coord)
        checked += bool(len(tspec))
    return checked


_MESHES = [dict(data=2, tensor=2), dict(data=1, fsdp=4), dict(data=2, fsdp=2)]


@pytest.mark.parametrize("shape", _MESHES, ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_transformer_rules_place_bert_as_jax(shape):
    cfg = jbert.bert_tiny(vocab_size=128, dtype=jnp.float32, max_len=32)
    tree = nn.unbox(jax.jit(jbert.BertClassifier(cfg, 2).init)(
        jax.random.PRNGKey(0), np.ones((1, 8), np.int32))["params"])
    tree = jax.tree.map(np.asarray, tree)
    n = _check_same_placement(tree, convert_jax.bert_state_dict_from_flax,
                              jpart.default_transformer_rules(JMeshConfig(**shape)),
                              tpart.default_transformer_rules(tp.MeshConfig(**shape)),
                              tp.MeshConfig(**shape))
    assert n >= 10  # most leaves are sharded


@pytest.mark.parametrize("shape", _MESHES[:2],
                         ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_llama_rules_place_llama_as_jax(shape):
    cfg = jl.llama_tiny(dtype=jnp.float32)
    tree = nn.unbox(jax.jit(jl.LlamaLM(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tree = jax.tree.map(np.asarray, tree)
    n = _check_same_placement(tree, convert_jax.llama_state_dict_from_flax,
                              jpart.default_llama_rules(JMeshConfig(**shape)),
                              tpart.default_llama_rules(tp.MeshConfig(**shape)),
                              tp.MeshConfig(**shape))
    assert n >= 10


# ---- the table's helpers against the JAX ones ----------------------------


def _jspec(spec):
    from jax.sharding import PartitionSpec

    return PartitionSpec(*spec)


def test_zero_shard_spec_matches_jax():
    sizes = dict(data=2, fsdp=2, tensor=2, seq=1, expert=1, pipe=1)
    cases = [((), (8, 4)), ((None, "tensor"), (8, 4)), (("fsdp", None), (8, 4)),
             ((), (3, 5)), ((), (1,)), ((None,), (6,)), (("tensor", None), (4, 3))]
    for spec, shape in cases:
        for zero_axes in (("data", "fsdp"), ("data",)):
            want = jpart.zero_shard_spec(_jspec(spec), shape, sizes, zero_axes)
            got = tpart.zero_shard_spec(tp.P(*spec), shape, sizes, zero_axes)
            assert tuple(got) == tuple(want), (spec, shape, zero_axes)


def test_rules_json_round_trip_and_digest_match_jax():
    for mesh in (None, dict(data=2, tensor=2)):
        t = tpart.default_transformer_rules(tp.MeshConfig(**mesh) if mesh else None,
                                            zero_axes=("data",))
        again = tpart.PartitionRules.from_json(t.to_json())
        assert again == t and again.digest() == t.digest()
        # the wire format is the JAX package's: it reads the port's table
        j = jpart.PartitionRules.from_json(t.to_json())
        assert j.to_json() == t.to_json() and j.digest() == t.digest()
    with pytest.raises(ValueError, match="ONE capture group"):
        tpart.PartitionRules(stage_regex=r"layers\.\d+")
    with pytest.raises(ValueError, match="no partition rule"):
        tpart.PartitionRules(unmatched="error").spec_for("w", (4, 4))


def test_opt_state_specs_and_checkpoint_sharding_fn():
    cfg = tp.MeshConfig(data=2, fsdp=2)
    rules = tpart.default_transformer_rules(cfg)
    mesh = _FakeMesh(cfg.resolve(4))
    w = np.zeros((8, 4), np.float32)
    opt = {"mu": {"encoder.layers.0.mlp.up.weight": w}, "count": np.zeros((), np.int64)}
    specs = tpart.opt_state_specs(rules, opt, mesh, zero=True)
    want = jpart.zero_shard_spec(_jspec((None, "fsdp")), (8, 4), mesh.axis_sizes,
                                 ("data", "fsdp"))
    assert tuple(specs["mu"]["encoder.layers.0.mlp.up.weight"]) == tuple(want)
    assert tuple(specs["count"]) == ()
    fn = tpart.checkpoint_sharding_fn(rules, mesh, zero=True)
    assert fn("data_iter/cursor", np.zeros(3)) is None
    assert tuple(fn("params/encoder.layers.0.mlp.up.weight", w).spec) == (None, "fsdp")
    assert tuple(fn("opt_state/mu/encoder.layers.0.mlp.up.weight", w).spec) == tuple(want)
    assert fn("step", np.zeros(())) is None  # scalars stay host numpy
    assert tuple(fn("params/classifier.bias", np.zeros(1)).spec) == ()


class _FakeMesh:
    """Axis sizes for the pure tree helpers (no process group needed)."""

    def __init__(self, sizes):
        self.axis_sizes = dict(sizes)


def test_stage_splits_and_digests_match_jax():
    _, state = _bert()
    shared, stages = tpart.split_stage_params(state, r"layers\.(\d+)")
    assert len(stages) == 2 and "embeddings.word.weight" in shared
    assert "encoder.layers.#.attn.q.weight" in stages[0]
    assert all("#" in k for k in stages[0]) and not any("layers" in k for k in shared)
    _, stacked = tpart.stack_stages(state, r"layers\.(\d+)")
    q = stacked["encoder.layers.#.attn.q.weight"]
    assert q.shape == (2,) + state["encoder.layers.0.attn.q.weight"].shape
    with pytest.raises(ValueError, match="matched no params"):
        tpart.split_stage_params(state, r"blocks\.(\d+)")
    rules = tpart.default_transformer_rules()
    got = tpart.spec_digests(rules, state)
    # the JAX digest of the same (name, spec) pairs
    want = jpart.spec_digests(rules, state)
    assert got == want
    section = tpart.sharding_manifest_section(rules, state)
    assert section["digest"] == rules.digest() and section["spec_digests"] == got


def _bert():
    from synapseml_torch.models.nets import bert

    cfg = bert.bert_tiny(vocab_size=64, dtype=torch.float32, max_len=16)
    return cfg, convert_jax.bert_state_dict_from_flax(convert_jax.init_flax_bert_params(cfg, 2))


def test_manifest_sharding_demotes_without_a_fitting_world():
    from synapseml_torch.models.text import DeepTextModel

    stage = DeepTextModel()
    stage.has_param("mesh_config")
    rules = tpart.default_transformer_rules(tp.MeshConfig(data=4))
    applied, reason = tpart.apply_manifest_sharding(stage, tpart.sharding_manifest_section(rules))
    # DeepTextModel has mesh_config but no partition_rules: a replicated load
    assert not applied and "partition_rules" in reason


def test_per_device_bytes_of_a_one_process_tree():
    _, state = _bert()
    m = tp.create_mesh()
    placed = tpart.shard_tree(state, m, tpart.default_transformer_rules())
    assert tpart.per_device_bytes(placed) == tpart.total_bytes(state)
    snap = tpart.emit_shard_metrics(placed, None, m)
    assert snap["params"]["total_bytes"] == tpart.total_bytes(state)


# ---- parallel/batching.py and the rendezvous ------------------------------


def test_training_batcher_matches_jax():
    from synapseml_torch.parallel import batching as tb
    from synapseml_tpu.parallel import batching as jb

    for n, buckets in ((5, None), (8, None), (9, None), (3, (4, 16)), (16, (4, 16))):
        assert tb.bucket_size(n, buckets) == jb.bucket_size(n, buckets)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        tb.bucket_size(17, (4, 16))
    arrays = {"x": np.arange(10, dtype=np.float32).reshape(5, 2), "y": np.arange(5)}
    for kw in (dict(), dict(bucket=6), dict(multiple_of=4), dict(buckets=(8,))):
        got, want = tb.pad_batch(arrays, **kw), jb.pad_batch(arrays, **kw)
        assert got.n_valid == want.n_valid and np.array_equal(got.mask, want.mask)
        for k in arrays:
            assert np.array_equal(got.data[k], want.data[k])
        assert np.array_equal(tb.unpad(torch.from_numpy(got.data["x"]), got),
                              jb.unpad(want.data["x"], want))
    for drop in (False, True):
        got = list(tb.batches(arrays, 2, drop_remainder=drop))
        want = list(jb.batches(arrays, 2, drop_remainder=drop))
        assert [b.n_valid for b in got] == [b.n_valid for b in want]
        assert all(np.array_equal(a.data["x"], b.data["x"]) for a, b in zip(got, want))
    seqs = [[1, 2, 3], [4], list(range(12))]
    for kw in (dict(), dict(max_len=5), dict(multiple_of=4, pad_value=9)):
        for a, b in zip(tb.pad_sequences(seqs, **kw), jb.pad_sequences(seqs, **kw)):
            assert np.array_equal(a, b)
    placed = []
    feeder = tb.DoubleBufferedFeeder(iter([1, 2, 3]), lambda x: placed.append(x) or x * 10)
    assert next(feeder) == 10 and placed == [1, 2]  # one batch of lookahead
    assert list(feeder) == [20, 30]


def test_rendezvous_orders_workers_and_backend_records_one_process():
    import threading

    from synapseml_torch.parallel import backend as tb

    drv = tb.DriverRendezvous(world_size=3).start()
    results = {}

    def worker(pid):
        results[pid] = tb.worker_rendezvous(f"localhost:{drv.port}", f"exec{pid}", pid)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    drv.join()
    for t in threads:
        t.join()
    assert {pid: r["rank"] for pid, r in results.items()} == {0: 0, 1: 1, 2: 2}
    assert {r["world"] for r in results.values()} == {3}
    assert {r["run_id"] for r in results.values()} == {drv.run_id}
    tb.reset_backend()
    backend = tb.initialize_backend()
    assert (backend.rank, backend.world, backend.is_distributed) == (0, 1, False)
    tb.reset_backend()
    with pytest.raises(TimeoutError):
        tb.worker_rendezvous("localhost:1", "e", 0, timeout_s=0.3, retry_interval_s=0.05)
