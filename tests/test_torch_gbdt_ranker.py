"""synapseml_torch.gbdt's lambdarank and LightGBMRanker against the JAX package.

``lambdarank_grad_hess`` and ``ndcg_at_k`` within rtol 1e-6 of the JAX
functions on the same padded groups — the all-equal scores of iteration 0
(where the rank order is the tie order, slot order in both), groups of
size 1, and the group-chunked evaluation the port uses for large groups;
a ranker fit against the JAX ranker's forest; the NDCG gate of
``tests/test_gbdt.py:222``; and the ranker model's save/load.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synapseml_torch as pt
from synapseml_torch.gbdt import LightGBMRanker, LightGBMRankerModel, objectives
from synapseml_torch.gbdt import train_booster
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.gbdt import LightGBMRanker as JRanker
from synapseml_tpu.gbdt import objectives as jobjectives
from synapseml_tpu.gbdt.booster import train_booster as jtrain_booster


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast here, and idle OpenMP
    threads spinning after each small op would take cores from the other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _groups(seed=0, n_groups=12, lo=1, hi=30):
    rs = np.random.default_rng(seed)
    sizes = rs.integers(lo, hi, n_groups)
    sizes[:2] = 1  # groups of one document
    n = int(sizes.sum())
    labels = rs.integers(0, 5, n).astype(np.float32)
    return rs, sizes, n, labels


def test_pad_groups_matches_jax():
    _, sizes, _, _ = _groups()
    got, got_max = objectives.pad_groups(sizes)
    want, want_max = jobjectives.pad_groups(sizes)
    assert got.dtype == want.dtype and got_max == want_max
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("scores", ["equal", "random", "tied_pairs"])
def test_lambdarank_grad_hess_matches_jax(scores, chunked, monkeypatch):
    rs, sizes, n, labels = _groups()
    s = {"equal": np.zeros(n), "random": rs.normal(size=n),
         "tied_pairs": np.round(rs.normal(size=n), 1)}[scores].astype(np.float32)
    if chunked:  # a few groups a chunk
        monkeypatch.setattr(objectives, "_PAIR_ELEMENTS", 3 * 29 * 29)
    gslot, S = jobjectives.pad_groups(sizes)
    jg, jh = jobjectives.lambdarank_grad_hess(jnp.asarray(s), jnp.asarray(labels),
                                              jnp.asarray(gslot), len(sizes), S)
    tg, th = objectives.lambdarank_grad_hess(torch.from_numpy(s), torch.from_numpy(labels),
                                             torch.from_numpy(gslot), len(sizes), S)
    assert tg.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-7)
    assert np.all(tg.numpy()[:2] == 0)  # a lone document has no pair
    for k in (1, 3, 5, 10, 100):
        want = float(jobjectives.ndcg_at_k(jnp.asarray(s), jnp.asarray(labels),
                                           jnp.asarray(gslot), len(sizes), S, k=k))
        got = float(objectives.ndcg_at_k(torch.from_numpy(s), torch.from_numpy(labels),
                                         torch.from_numpy(gslot), len(sizes), S, k=k))
        assert got == pytest.approx(want, rel=1e-6)


def _rank_data(seed=3, n_groups=40, size=20, f=5):
    rs = np.random.default_rng(seed)
    n = n_groups * size
    X = rs.normal(size=(n, f))
    rel = np.clip(X[:, 0] * 2 + 2 + 0.3 * rs.normal(size=n), 0, 4).round().astype(np.float32)
    return X, rel, np.repeat(np.arange(n_groups), size)


def test_ranker_booster_matches_jax():
    X, rel, groups = _rank_data()
    sizes = np.bincount(groups)
    kw = dict(objective="lambdarank", group_sizes=sizes, num_iterations=6, num_leaves=7,
              learning_rate=0.3)
    b = train_booster(X, rel, device="cpu", **kw)
    jb = jtrain_booster(X, rel, **kw)
    np.testing.assert_array_equal(b.feature, jb.feature)
    np.testing.assert_allclose(b.threshold_value, jb.threshold_value, rtol=1e-6)
    np.testing.assert_allclose(b.leaf_value, jb.leaf_value, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b.raw_score(X, device="cpu"), jb.raw_score(X), atol=1e-5)
    assert b.objective == "lambdarank" and np.all(b.init_score == 0)


def test_ranker_early_stopping_on_validation_groups_matches_jax():
    X, rel, groups = _rank_data(n_groups=50)
    tr, va = groups < 35, groups >= 35
    kw = dict(objective="lambdarank", group_sizes=np.bincount(groups[tr]),
              valid_features=X[va], valid_labels=rel[va],
              valid_group_sizes=np.bincount(groups[va] - 35), num_iterations=40,
              num_leaves=7, learning_rate=0.5, early_stopping_round=3)
    b = train_booster(X[tr], rel[tr], device="cpu", **kw)
    jb = jtrain_booster(X[tr], rel[tr], **kw)
    assert b.best_iteration == jb.best_iteration
    with pytest.raises(ValueError, match="valid_group_sizes"):
        train_booster(X[tr], rel[tr], device="cpu", **dict(kw, valid_group_sizes=None))
    with pytest.raises(ValueError, match="group_sizes"):
        train_booster(X, rel, objective="lambdarank", device="cpu")


def test_ranker_ndcg():  # tests/test_gbdt.py:222-231
    rs = np.random.default_rng(0)
    n = 1000
    x = rs.normal(size=(n, 5))
    groups = np.repeat(np.arange(50), 20)
    rel = np.clip(x[:, 0] * 2 + 2, 0, 4).round()
    df = pt.DataFrame.from_dict({"features": x, "label": rel, "group": groups})
    model = LightGBMRanker(num_iterations=10, num_leaves=7, learning_rate=0.3,
                           device="cpu").fit(df)
    pred = model.transform(df).collect_column("prediction")
    assert np.corrcoef(pred, rel)[0, 1] > 0.6


def test_ranker_estimator_matches_jax_and_round_trips(tmp_path):
    """Groups arrive shuffled over partitions; both stages sort by group."""
    X, rel, groups = _rank_data(seed=4)
    perm = np.random.default_rng(1).permutation(len(rel))
    data = {"features": X[perm], "label": rel[perm], "qid": groups[perm]}
    kw = dict(num_iterations=6, num_leaves=7, learning_rate=0.3, group_col="qid",
              eval_at=[1, 3, 5])
    tdf, jdf = pt.DataFrame.from_dict(data, num_partitions=3), \
        JDataFrame.from_dict(data, num_partitions=3)
    est = LightGBMRanker(device="cpu", **kw)
    assert est.get("eval_at") == [1, 3, 5] and est.get("group_col") == "qid"
    model = est.fit(tdf)
    jmodel = JRanker(**kw).fit(jdf)
    assert isinstance(model, LightGBMRankerModel) and model.get("device") == "cpu"
    np.testing.assert_array_equal(model.get_booster().feature, jmodel.get_booster().feature)
    got = model.transform(tdf).collect_column("prediction")
    np.testing.assert_allclose(got, jmodel.transform(jdf).collect_column("prediction"),
                               atol=1e-5)
    model.save(str(tmp_path / "m"))
    loaded = pt.load_stage(str(tmp_path / "m"))
    np.testing.assert_array_equal(loaded.transform(tdf).collect_column("prediction"), got)
