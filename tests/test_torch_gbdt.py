"""synapseml_torch.gbdt against the JAX package's GBDT engine.

The same numpy inputs go through the JAX package (jitted on the CPU) and
through the port on the CPU (``device="cpu"``; ``histogram_impl='pallas'``
takes the CUDA kernel's plain version there). Forests are held to the JAX
``'segment'`` backend, which ``tests/test_gbdt.py:945-960`` holds equal to
the others, with that test's tolerances: split features equal, thresholds
rtol 1e-6, raw scores rtol 1e-4 / atol 1e-5. The JAX side of each
configuration trains once per module.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import synapseml_torch as pt
from synapseml_torch.data import MemorySource
from synapseml_torch.gbdt import (BinMapper, Booster, LightGBMClassificationModel,
                                  LightGBMClassifier, LightGBMRanker, LightGBMRegressor,
                                  objectives, train_booster, train_booster_from_source)
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.gbdt import LightGBMClassifier as JClassifier
from synapseml_tpu.gbdt import LightGBMRegressor as JRegressor
from synapseml_tpu.gbdt import TpuBooster
from synapseml_tpu.gbdt import objectives as jobjectives
from synapseml_tpu.gbdt.binning import BinMapper as JBinMapper
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


def _mode_dataset(seed=8, n=800):  # tests/test_gbdt.py:350-354
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 2] > 0).astype(np.float32)
    return X, y


def _multiclass_dataset(seed=9, n=600):
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, 5))
    y = np.argmax(X[:, :3] + 0.3 * rs.normal(size=(n, 3)), axis=1).astype(np.float32)
    return X, y


def _regression_dataset(seed=10, n=700):
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, 6))
    y = (X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * rs.normal(size=n)).astype(np.float32)
    return X, y


BIN = dict(objective="binary", num_iterations=8, learning_rate=0.2, num_leaves=15)
CASES = {
    "binary": (_mode_dataset, BIN),
    "binary_f32_input": (lambda: (_mode_dataset()[0].astype(np.float32), _mode_dataset()[1]),
                         BIN),
    "multiclass": (_multiclass_dataset, dict(objective="multiclass", num_class=3,
                                             num_iterations=6, learning_rate=0.3,
                                             num_leaves=7)),
    "regression": (_regression_dataset, dict(objective="regression", num_iterations=8,
                                             learning_rate=0.2, num_leaves=15,
                                             lambda_l1=0.1, lambda_l2=1.0)),
    "monotone": (_regression_dataset, dict(objective="regression", num_iterations=6,
                                           learning_rate=0.3, num_leaves=15,
                                           monotone_constraints=[1, -1, 0, 0, 0, 0])),
    "weights": (_mode_dataset, dict(BIN, weights=np.random.default_rng(1).uniform(
        0.2, 2.0, 800).astype(np.float32))),
    "is_unbalance": (lambda: _mode_dataset(seed=11), dict(BIN, is_unbalance=True,
                                                           max_depth=4, max_bin=63)),
    "early_stopping": (_mode_dataset, dict(
        BIN, num_iterations=40, learning_rate=0.5, early_stopping_round=3,
        valid_features=_mode_dataset(seed=12, n=300)[0],
        valid_labels=_mode_dataset(seed=12, n=300)[1])),
}


@pytest.fixture(scope="module")
def jax_boosters():
    """The JAX ('segment') side of each configuration, trained once."""
    cache = {}

    def get(name):
        if name not in cache:
            data, kw = CASES[name]
            X, y = data()
            cache[name] = (X, y, jtrain_booster(X, y, histogram_impl="segment", **kw))
        return cache[name]

    return get


def _assert_same_forest(got: Booster, want, X):
    np.testing.assert_array_equal(got.feature, want.feature)
    np.testing.assert_allclose(got.threshold_value, want.threshold_value, rtol=1e-6)
    np.testing.assert_allclose(got.raw_score(X[:100], device="cpu"), want.raw_score(X[:100]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.init_score, want.init_score, rtol=1e-6, atol=1e-6)
    assert got.best_iteration == want.best_iteration
    assert (got.max_depth, got.num_model_out, got.objective) == (
        want.max_depth, want.num_model_out, want.objective)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_booster_matches_jax(case, jax_boosters):
    X, y, want = jax_boosters(case)
    got = train_booster(X, y, histogram_impl="segment", device="cpu", **CASES[case][1])
    _assert_same_forest(got, want, X)
    np.testing.assert_allclose(got.leaf_value, want.leaf_value, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.cover, want.cover)
    if case == "early_stopping":
        assert got.best_iteration is not None and got.num_iterations < 40


@pytest.mark.parametrize("impl", ["pallas", "onehot"])
@pytest.mark.parametrize("case", ["binary", "multiclass"])
def test_histogram_backends_grow_the_jax_forest(case, impl, jax_boosters):
    X, y, want = jax_boosters(case)
    got = train_booster(X, y, histogram_impl=impl, device="cpu", **CASES[case][1])
    _assert_same_forest(got, want, X)


def test_pallas_backend_counts_no_launch_on_the_cpu():
    from synapseml_torch.gbdt import hist

    X, y = _mode_dataset(n=200)
    before = hist.fixed_point_histogram.launches
    train_booster(X, y, histogram_impl="pallas", device="cpu", **dict(BIN, num_iterations=2))
    assert hist.fixed_point_histogram.launches == before


def test_grow_tree_with_the_tree_scale_equals_the_per_level_scale(monkeypatch):
    """grow_tree computes the fixed-point scale once a tree and passes it to
    every level; the tree is bitwise the one grown by the per-call scale
    path (each level and the final totals computing their own scale)."""
    from synapseml_torch.gbdt import hist, trees

    X, y = _mode_dataset(n=600)
    mapper = BinMapper(max_bin=63).fit(X)
    bins = torch.from_numpy(mapper.transform(X))
    rs = np.random.default_rng(13)
    grad = torch.from_numpy(rs.normal(size=600).astype(np.float32))
    hess = torch.from_numpy(rs.uniform(0.01, 0.25, 600).astype(np.float32))
    presence = torch.ones(600)
    cfg = trees.GrowthConfig(max_depth=4, num_leaves=15, num_bins=mapper.num_bins,
                             lambda_l1=0.0, lambda_l2=1.0, learning_rate=0.1,
                             min_data_in_leaf=5, min_sum_hessian=1e-3, min_gain_to_split=0.0,
                             hist_impl="pallas")
    fmask = torch.ones(X.shape[1], dtype=torch.bool)
    got = trees.grow_tree(bins, grad, hess, presence, cfg, fmask)

    def per_call_level(bins, grad, hess, presence, node, base, width, num_bins, impl, tree,
                       rows=None):
        return hist.fixed_point_histogram_plain(bins, grad, hess, presence, node, base, width,
                                                num_bins)

    def per_call_totals(grad, hess, presence, node, base, width, impl, tree, rows=None):
        return hist.fixed_point_histogram_plain(None, grad, hess, presence, node, base, width,
                                                1).reshape(width, 3)

    monkeypatch.setattr(trees, "level_histogram", per_call_level)
    monkeypatch.setattr(trees, "node_totals", per_call_totals)
    want = trees.grow_tree(bins, grad, hess, presence, cfg, fmask)
    for name in trees.TreeArrays._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int((got.feature >= 0).sum()) > 3  # the tree really split


def test_predict_contrib_leaf_and_importance_match_jax(jax_boosters):
    X, y, want = jax_boosters("multiclass")
    got = train_booster(X, y, device="cpu", **CASES["multiclass"][1])
    np.testing.assert_allclose(got.predict_contrib(X[:20]), want.predict_contrib(X[:20]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.predict_contrib(X[:20]).sum(-1),
                               got.raw_score(X[:20], device="cpu"), atol=1e-4)
    np.testing.assert_array_equal(got.predict_leaf(X[:50], device="cpu"),
                                  want.predict_leaf(X[:50]))
    for kind in ("split", "gain"):
        np.testing.assert_allclose(got.feature_importance(kind), want.feature_importance(kind),
                                   rtol=1e-4)
    np.testing.assert_allclose(got.predict(X[:50], device="cpu"), want.predict(X[:50]),
                               atol=1e-5)
    assert got.dump_text().splitlines()[0] == want.dump_text().splitlines()[0]
    assert "leaf" in got.dump_text()


def test_booster_directories_load_in_both_packages(tmp_path, jax_boosters):
    """The weight bridge: JAX TpuBooster.save -> port Booster.load, and port
    Booster.save -> JAX TpuBooster.load, with equal raw scores."""
    X, y, jb = jax_boosters("binary")
    jb.save(str(tmp_path / "jax"))
    loaded = Booster.load(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_allclose(loaded.raw_score(X, device="cpu"), jb.raw_score(X),
                               rtol=1e-6, atol=1e-6)
    port = train_booster(X, y, device="cpu", **BIN)
    port.save(str(tmp_path / "port"))
    back = TpuBooster.load(str(tmp_path / "port"))
    np.testing.assert_allclose(back.raw_score(X), port.raw_score(X, device="cpu"),
                               rtol=1e-6, atol=1e-6)
    again = Booster.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(again.raw_score(X), port.raw_score(X, device="cpu"))
    assert again.best_iteration == port.best_iteration and again.params == port.params


def test_booster_pickles_without_device_tensors(tmp_path):
    import pickle

    X, y = _mode_dataset(n=200)
    b = train_booster(X, y, device="cpu", **dict(BIN, num_iterations=3))
    before = b.raw_score(X)
    assert b._device_cache
    clone = pickle.loads(pickle.dumps(b))
    assert clone._device_cache == {}
    np.testing.assert_array_equal(clone.raw_score(X), before)


# ---------------- binning and objectives ----------------

@pytest.mark.parametrize("max_bin", [255, 300, 15])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bin_mapper_matches_jax(dtype, max_bin):
    rs = np.random.default_rng(3)
    X = rs.normal(size=(2000, 5)).astype(dtype)
    X[:, 3] = rs.integers(0, 4, 2000)  # low cardinality: one bin per value
    X[rs.random((2000, 5)) < 0.05] = np.nan
    X[:, 4] = np.nan  # an all-NaN column
    want = JBinMapper(max_bin=max_bin, sample_count=1000, seed=2).fit_transform(X)
    mapper = BinMapper(max_bin=max_bin, sample_count=1000, seed=2)
    got = mapper.fit_transform(X)
    assert got.dtype == (np.uint8 if max_bin < 256 else np.int32)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(mapper.upper_bound_values(),
                                  JBinMapper.from_dict(mapper.to_dict()).upper_bound_values())


@pytest.mark.parametrize("max_bin,categorical", [(255, (4,)), (300, (4,)), (15, ())])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_bin_mapper_torch_comparisons_match_jax(dtype, max_bin, categorical):
    """The comparisons a CUDA device runs (torch.searchsorted in float64 over
    column blocks), here on CPU tensors: the JAX package's codes, with NaN,
    infinite values (NaN boundaries take the host path), ties at the
    boundaries and out-of-range category codes."""
    rs = np.random.default_rng(4)
    X = np.round(rs.normal(size=(3000, 6)) * 20)  # ties at the quantile boundaries
    X[:, 3] = rs.integers(0, 4, 3000)  # low cardinality: one bin per value
    X[:, 4] = rs.integers(-3, 40, 3000)  # categorical where asked, codes out of range
    if dtype is not np.int64:
        X[rs.random((3000, 6)) < 0.05] = np.nan
        X[::11, 2], X[::13, 2] = np.inf, -np.inf
    X = X.astype(dtype)
    want = JBinMapper(max_bin=max_bin, sample_count=1000, seed=2,
                      categorical=categorical).fit_transform(X)
    mapper = BinMapper(max_bin=max_bin, sample_count=1000, seed=2, categorical=categorical)
    mapper.fit(X)
    got = mapper._transform_torch(X, "cpu", block=7000)  # three column blocks of two
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mapper.transform(X), want)


_OBJECTIVES = [("regression", {}), ("regression_l1", {}), ("huber", {"alpha": 0.7}),
               ("poisson", {}), ("quantile", {"alpha": 0.8}), ("gamma", {}), ("mape", {}),
               ("tweedie", {"tweedie_variance_power": 1.3}), ("binary", {}),
               ("multiclass", {})]


@pytest.mark.parametrize("name,kw", _OBJECTIVES, ids=[n for n, _ in _OBJECTIVES])
def test_objective_matches_jax(name, kw):
    rs = np.random.default_rng(5)
    n, k = 301, 3 if name == "multiclass" else 1
    if name == "multiclass":
        y = rs.integers(0, 3, n).astype(np.float32)
    elif name == "binary":
        y = (rs.random(n) < 0.3).astype(np.float32)
    elif name in ("poisson", "gamma", "tweedie"):
        y = rs.gamma(2.0, 1.5, n).astype(np.float32)
    else:
        y = (rs.normal(size=n) * 3).astype(np.float32)
    s = (rs.normal(size=(n, k)) * 0.5).astype(np.float32)
    jo = jobjectives.get_objective(name, num_class=k, **kw)
    to = objectives.get_objective(name, num_class=k, **kw)
    ty, ts = torch.from_numpy(y), torch.from_numpy(s)
    assert (to.name, to.num_model_out, to.metric_name) == (jo.name, jo.num_model_out,
                                                           jo.metric_name)
    got_init = to.init_score(ty)
    assert got_init.dtype == torch.float32
    np.testing.assert_allclose(got_init.numpy(), np.asarray(jo.init_score(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)
    (tg, th), (jg, jh) = to.grad_hess(ts, ty), jo.grad_hess(jnp.asarray(s), jnp.asarray(y))
    assert tg.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to.transform(ts).numpy(), np.asarray(jo.transform(jnp.asarray(s))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(to.metric(ts, ty)),
                               float(jo.metric(jnp.asarray(s), jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)


def test_median_init_averages_the_middle_values():
    """regression_l1 starts at the median of an even count: the mean of the
    two middle labels, as jnp.median, not torch.median's lower one."""
    y = torch.tensor([1.0, 2.0, 4.0, 10.0])
    assert float(objectives.get_objective("regression_l1").init_score(y)) == 3.0


# ---------------- estimators ----------------

def _frames(X, y, **cols):
    data = {"features": X, "label": y, **cols}
    return pt.DataFrame.from_dict(data, num_partitions=3), JDataFrame.from_dict(data,
                                                                                num_partitions=3)


def test_classifier_matches_jax():
    X, y = _multiclass_dataset()
    tdf, jdf = _frames(X, y)
    kw = dict(num_iterations=6, learning_rate=0.3, num_leaves=7)
    want = JClassifier(**kw).fit(jdf).transform(jdf)
    model = LightGBMClassifier(device="cpu", **kw).fit(tdf)
    got = model.transform(tdf)
    np.testing.assert_array_equal(got.collect_column("prediction"),
                                  want.collect_column("prediction"))
    np.testing.assert_allclose(np.stack(list(got.collect_column("probability"))),
                               np.stack(list(want.collect_column("probability"))), atol=1e-4)
    np.testing.assert_allclose(np.stack(list(got.collect_column("rawPrediction"))),
                               np.stack(list(want.collect_column("rawPrediction"))),
                               rtol=1e-4, atol=1e-5)
    assert model.get("device") == "cpu" and model.get_train_measures()["iterations_count"] == 6


def test_binary_classifier_with_kernel_backend_weights_and_validation_matches_jax():
    X, y = _mode_dataset()
    rs = np.random.default_rng(2)
    w = rs.uniform(0.5, 2.0, len(y)).astype(np.float32)
    valid = rs.random(len(y)) < 0.25
    tdf, jdf = _frames(X, y, weight=w, valid=valid)
    kw = dict(num_iterations=30, learning_rate=0.4, num_leaves=15, weight_col="weight",
              validation_indicator_col="valid", early_stopping_round=3)
    jmodel = JClassifier(**kw).fit(jdf)
    tmodel = LightGBMClassifier(device="cpu", histogram_impl="pallas", **kw).fit(tdf)
    assert tmodel.get_booster().best_iteration == jmodel.get_booster().best_iteration
    got, want = tmodel.transform(tdf), jmodel.transform(jdf)
    np.testing.assert_array_equal(got.collect_column("prediction"),
                                  want.collect_column("prediction"))
    np.testing.assert_allclose(np.stack(list(got.collect_column("probability"))),
                               np.stack(list(want.collect_column("probability"))), atol=1e-4)


def test_regressor_matches_jax_and_adds_shap():
    X, y = _regression_dataset()
    tdf, jdf = _frames(X, y)
    kw = dict(num_iterations=8, learning_rate=0.2, num_leaves=15, objective="huber", alpha=0.5)
    jmodel = JRegressor(**kw).fit(jdf)
    tmodel = LightGBMRegressor(device="cpu", **kw).fit(tdf)
    np.testing.assert_allclose(tmodel.transform(tdf).collect_column("prediction"),
                               jmodel.transform(jdf).collect_column("prediction"),
                               rtol=1e-4, atol=1e-4)
    tmodel.set(features_shap_col="shap")
    out = tmodel.transform(tdf)
    shap = np.stack(list(out.collect_column("shap")))
    assert shap.shape == (len(y), X.shape[1] + 1)
    np.testing.assert_allclose(shap.sum(-1), out.collect_column("prediction"), atol=1e-4)


def test_model_save_load_round_trip(tmp_path):
    X, y = _mode_dataset(n=300)
    tdf, _ = _frames(X, y)
    model = LightGBMClassifier(device="cpu", num_iterations=4, histogram_impl="pallas").fit(tdf)
    before = np.stack(list(model.transform(tdf).collect_column("probability")))
    model.save(str(tmp_path / "m"))
    loaded = pt.load_stage(str(tmp_path / "m"))
    assert isinstance(loaded, LightGBMClassificationModel)
    assert loaded.get("device") == "cpu" and loaded.get("histogram_impl") == "pallas"
    after = np.stack(list(loaded.transform(tdf).collect_column("probability")))
    np.testing.assert_array_equal(after, before)


# ---------------- formerly refused modes, and the device default ----------------

# Each mode the port refused until it was ported, as a configuration that
# now trains (named as before); only `mesh` still waits (queue A item 9).
_REFUSED = {
    "goss": dict(boosting_type="goss"),
    "dart": dict(boosting_type="dart"),
    "rf": dict(boosting_type="rf"),
    "bagging": dict(bagging_fraction=0.7, bagging_freq=1),
    "feature_fraction": dict(feature_fraction=0.5),
    "categorical": dict(categorical_features=[0]),
    "lambdarank": dict(objective="lambdarank", group_sizes=np.array([100, 100])),
    "group_sizes": dict(objective="lambdarank", group_sizes=np.array([50, 150])),
    "init_model": dict(init_model="booster"),
    "mesh": dict(mesh="one process"),
}


@pytest.mark.parametrize("name", sorted(_REFUSED))
def test_unported_modes_are_refused(name):
    """The modes refused until they were ported now train on the CPU as
    the JAX booster does; `mesh` (a mesh of one process here; over gloo
    worlds in test_torch_gbdt_mesh.py) grows the forest of no mesh."""
    X, y = _mode_dataset(n=200)
    kw = dict(_REFUSED[name], num_iterations=3)
    if name == "mesh":
        from synapseml_torch.parallel import create_mesh

        kw.update(mesh=create_mesh(), histogram_impl="pallas")
        want = train_booster(X, y, device="cpu", num_iterations=3, histogram_impl="pallas")
        got = train_booster(X, y, device="cpu", **kw)
        assert np.array_equal(got.leaf_value, want.leaf_value)
        assert np.array_equal(got.feature, want.feature)
        return
    if name == "init_model":
        kw["init_model"] = train_booster(X, y, device="cpu", num_iterations=2)
    b = train_booster(X, y, device="cpu", **kw)
    assert b.num_iterations == (5 if name == "init_model" else 3)
    assert np.isfinite(b.raw_score(X, device="cpu")).all()
    if name in ("goss", "dart", "rf"):
        assert b.params["boosting_type"] == name and b.average_output == (name == "rf")
    if name == "categorical":
        assert b.categorical_features == (0,) and b.cat_mask is not None


@pytest.mark.parametrize("param", ["model_string", "mesh_config", "categorical_slot_indexes",
                                   "boosting_type"])
def test_unported_estimator_params_are_refused(param):
    """The Params refused until they were ported all fit now; mesh_config
    (a data axis of one process) grows the stage's forest without it."""
    from synapseml_torch.parallel import MeshConfig

    X, y = _mode_dataset(n=200)
    tdf, _ = _frames(X, y)
    value = {"model_string": train_booster(X, y, device="cpu", num_iterations=2),
             "mesh_config": MeshConfig(data=1), "categorical_slot_indexes": [1],
             "boosting_type": "dart"}[param]
    est = LightGBMClassifier(device="cpu", num_iterations=2, **{param: value})
    if param == "mesh_config":
        want = LightGBMClassifier(device="cpu", num_iterations=2).fit(tdf).get_booster()
        got = est.fit(tdf).get_booster()
        assert np.array_equal(got.feature, want.feature)
        np.testing.assert_allclose(got.leaf_value, want.leaf_value, atol=1e-6)
        return
    booster = est.fit(tdf).get_booster()
    assert booster.num_iterations == (4 if param == "model_string" else 2)


def test_unported_entry_points_are_refused(tmp_path):
    """The ranker, out-of-core training and save_native_model run; the
    fused sweep is refused naming queue A item 11."""
    X, y = _mode_dataset(n=200)
    tdf, _ = _frames(X, y, group=np.repeat(np.arange(10), 20))
    ranker = LightGBMRanker(device="cpu", num_iterations=2).fit(tdf)
    assert ranker.get_booster().objective == "lambdarank"
    src = MemorySource({"feat": X.astype(np.float32), "label": y})
    streamed = train_booster_from_source(src, feature_cols=["feat"], num_iterations=2,
                                         device="cpu")
    assert streamed.params["streamed"] and streamed.num_iterations == 2
    est = LightGBMClassifier(device="cpu", num_iterations=2)
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        est._fit_fused(tdf, [{}])
    est.fit(tdf).save_native_model(str(tmp_path / "native"))
    assert (tmp_path / "native" / "model.txt").read_text().startswith("tree\n")


def test_default_device_is_the_card():
    """The no-device default is 'cuda'; on a host without a CUDA device
    training and scoring raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    X, y = _mode_dataset(n=200)
    tdf, _ = _frames(X, y)
    assert LightGBMClassifier().get("device") == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LightGBMClassifier(num_iterations=2).fit(tdf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_booster(X, y, num_iterations=2)
    model = LightGBMClassifier(device="cpu", num_iterations=2).fit(tdf)
    model.clear("device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.transform(tdf)
    with pytest.raises(ValueError, match="device"):
        LightGBMRegressor(device="tpu:0")
