"""The port's mesh and collectives in a gloo world of 4 processes.

One spawn of four ranks (``_torch_ranks.py``) runs the rank side
(``_torch_rank_cases.mesh_suite``); this module checks what each returned:

* coordinates on a ``data=2 x tensor=2`` mesh in the JAX package's device
  order (``data`` outermost), the ``allow_fewer`` degradation of a config
  that does not fit the world;
* ``psum_over``/``pmean_over``/``all_gather_over`` over one axis and over
  two, ``ring_permute`` both ways on a ``seq`` ring, ``data_parallel_map``'s
  global mean and ``shard_batch``'s rows (data-major, as the JAX
  ``("data", "fsdp")`` batch spec splits them), exactly;
* ``shard_tree`` of a ``bert_tiny`` state_dict by the port's transformer
  table on a tensor mesh and on an fsdp mesh: each rank's local shard is
  the slice its coordinate holds under the leaf's spec, bitwise, and the
  per-rank bytes divide as the specs say (about 1/fsdp on the fsdp mesh,
  as the JAX ``test_parallel.py:314`` asserts of its compiled step);
* the trainer's ZeRO moments on the fsdp mesh: a quarter of the optimizer
  bytes a rank (``test_parallel.py:368`` asserts the JAX package's moments
  shard); the trainer on a tensor mesh, and the trainer and the causal LM
  with a rule table that cuts a weight, refused naming queue A item 9 (the
  port keeps the parameters whole);
* sharded inference over ``data=4``: DeepTextModel scores, the embedder's
  embeddings (each rank its rows, gathered; within 1e-6 of no mesh in f32:
  a row's products in a batch of 1 against 4) and the causal LM's greedy
  completions (equal), on every rank.
"""

import math

import numpy as np
import pytest

from _torch_rank_cases import _bert_state
from _torch_ranks import spawn
from synapseml_torch import parallel as tp
from synapseml_torch.parallel import partition as tpart

AXES = ("data", "fsdp", "tensor", "seq", "expert", "pipe")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("_torch_rank_cases:mesh_suite", 4, tmp_path_factory.mktemp("mesh"))


def test_coordinates_and_degradation(ranks):
    for r, got in enumerate(ranks):
        coord = dict(zip(AXES, got["coord"]))
        assert (coord["data"], coord["tensor"]) == (r // 2, r % 2)
        assert dict(zip(AXES, got["sizes"])) == dict(data=2, fsdp=1, tensor=2, seq=1,
                                                     expert=1, pipe=1)
        assert got["degraded"][0] == 4  # MeshConfig(data=3) on 4 ranks -> data=4


def test_collectives(ranks):
    rows = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, got in enumerate(ranks):
        t, d = r % 2, r // 2
        x = lambda k: np.array([k + 1.0, 10.0 * (k + 1)], np.float32)  # noqa: E731
        np.testing.assert_array_equal(got["psum_data"], x(t) + x(t + 2))
        np.testing.assert_array_equal(got["psum_all"], sum(x(k) for k in range(4)))
        np.testing.assert_array_equal(got["pmean_tensor"], (x(2 * d) + x(2 * d + 1)) / 2)
        np.testing.assert_array_equal(got["gather_data"], np.stack([x(t), x(t + 2)]))
        np.testing.assert_array_equal(got["ring"], x((r - 1) % 4))
        np.testing.assert_array_equal(got["ring_back"], x((r + 1) % 4))
        np.testing.assert_allclose(got["dp_mean"], (rows * 2).mean(axis=0), rtol=1e-6)
        np.testing.assert_array_equal(got["dp_rows"], rows[2 * r:2 * r + 2])


def _slice(arr, spec, sizes, coord):
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
    return arr[tuple(index)]


@pytest.mark.parametrize("tag,shape", [("tensor", dict(data=2, tensor=2)),
                                       ("fsdp", dict(data=1, fsdp=4))])
def test_shard_tree_places_each_rank_its_slice(ranks, tag, shape):
    cfg = tp.MeshConfig(**shape)
    sizes = cfg.resolve(4)
    rules = tpart.default_transformer_rules(cfg)
    _, state = _bert_state()
    total = tpart.total_bytes(state)
    for r, got in enumerate(ranks):
        coord = dict(zip(AXES, np.unravel_index(r, [sizes[a] for a in AXES])))
        want_bytes = 0
        for name, arr in state.items():
            want = _slice(arr, rules.spec_for(name, arr.shape), sizes, coord)
            assert np.array_equal(got[f"{tag}/{name}"], want), (r, name)
            want_bytes += want.nbytes
        assert tuple(got[f"{tag}_bytes"]) == (total, want_bytes)
    if tag == "fsdp":
        # every weight shards over fsdp: a rank holds a quarter of them,
        # and the replicated biases and norms whole
        replicated = sum(a.nbytes for n, a in state.items()
                         if not tp.mesh.spec_axes(rules.spec_for(n, a.shape)))
        assert want_bytes == (total - replicated) // 4 + replicated
        assert want_bytes <= total / 4 * 1.1


def test_zero_moments_shard_with_their_params(ranks):
    # the parameters stay whole (a table that cuts one is refused below);
    # ZeRO cuts the trained leaves, flattened and padded to 4 equal spans,
    # and each rank holds the f32 mu and nu of its span
    _, state = _bert_state()
    n = sum(a.size for a in state.values())
    span = -(-n // 4)
    for got in ranks:
        total, per_rank = got["zero_bytes"]
        assert per_rank == 2 * span * 4 and total == 4 * per_rank
        assert 0 <= total - 2 * tpart.total_bytes(state) < 2 * 4 * 4


@pytest.mark.parametrize("tag", ["trainer_tensor", "trainer_fsdp_rules", "lm_rules"])
def test_placing_parameters_is_refused_naming_item_9(ranks, tag):
    for got in ranks:
        msg = str(got[f"refused/{tag}"][0])
        assert "queue A item 9" in msg, msg


@pytest.mark.parametrize("stage", ["text", "embed", "lm"])
def test_sharded_inference_equals_no_mesh(ranks, stage):
    for r, got in enumerate(ranks):
        want = got[f"{stage}/plain"]
        if stage == "lm":
            assert np.array_equal(got["lm/sharded"], want), r
        else:
            np.testing.assert_allclose(got[f"{stage}/sharded"], want, atol=1e-6, rtol=0,
                                       err_msg=f"rank {r}")
        assert np.array_equal(want, ranks[0][f"{stage}/plain"])
