"""synapseml_torch.gbdt's model.txt interop and continued training against the JAX package.

``to_lightgbm_string`` is byte for byte the JAX package's string, for
boosters trained by the JAX package and loaded through the port's
``Booster.load`` (each objective of ``tests/test_gbdt.py:461``, link-carrying
regressions, rf, NaN routing, categorical splits) and for the port's own;
``parse_lightgbm_string`` → ``ImportedBooster`` scores within 1e-6 of the
JAX ``ImportedBooster`` on the same text (hand-written stock-LightGBM
files, default-left and zero-as-missing nodes included), and slots into the
classification model; continued training (``tests/test_gbdt.py:1021-1072``)
from a booster and from a model string against the JAX booster's.
"""

import numpy as np
import pytest
import torch

import synapseml_torch as pt
from synapseml_torch.gbdt import (Booster, ImportedBooster, LightGBMClassificationModel,
                                  LightGBMClassifier, parse_lightgbm_string,
                                  to_lightgbm_string, train_booster)
from synapseml_tpu.gbdt import parse_lightgbm_string as jparse
from synapseml_tpu.gbdt import to_lightgbm_string as jto_string
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


def _case(name):
    rs = np.random.default_rng(21)
    X = rs.normal(size=(300, 5))
    kw = dict(num_iterations=8, learning_rate=0.3, num_leaves=7)
    if name == "multiclass":
        return X, np.argmax(X[:, :3], axis=1).astype(np.float32), dict(kw, objective=name,
                                                                        num_class=3)
    if name == "binary":
        return X, (X[:, 0] > 0).astype(np.float32), dict(kw, objective=name)
    if name == "poisson":
        return X, rs.poisson(np.exp(0.5 * X[:, 0])).astype(np.float32), dict(kw, objective=name)
    if name == "rf":
        return X, (X[:, 0] > 0).astype(np.float32), dict(
            objective="binary", boosting_type="rf", bagging_fraction=0.7, bagging_freq=1,
            num_iterations=6)
    if name == "nan":
        X[rs.random(300) < 0.2, 0] = np.nan
        return X, (np.nan_to_num(X[:, 0]) + X[:, 1] > 0).astype(np.float32), dict(
            kw, objective="binary")
    if name == "categorical":
        X[:, 1] = rs.integers(0, 20, 300)
        effect = np.random.default_rng(5).normal(size=20)
        return X, (effect[X[:, 1].astype(int)] + 0.3 * X[:, 0] > 0).astype(np.float32), dict(
            kw, objective="binary", categorical_features=[1], min_data_in_leaf=5)
    return X, (X[:, 0] * 2 + X[:, 1]).astype(np.float32), dict(kw, objective=name)


CASES = ["regression", "binary", "multiclass", "poisson", "rf", "nan", "categorical"]


@pytest.mark.parametrize("case", CASES)
def test_model_string_is_the_jax_string(case, tmp_path):
    X, y, kw = _case(case)
    jb = jtrain_booster(X, y, **kw)
    jb.save(str(tmp_path / "jax"))
    loaded = Booster.load(str(tmp_path / "jax"), device="cpu")
    text = to_lightgbm_string(loaded)
    assert text == jto_string(jb)
    assert "Tree=0" in text and "end of trees" in text
    port = train_booster(X, y, device="cpu", **kw)
    assert to_lightgbm_string(port) == jto_string(port)  # the JAX writer on the port's arrays

    imported, jimported = parse_lightgbm_string(text), jparse(text)
    assert isinstance(imported, ImportedBooster)
    assert (imported.objective, imported.num_model_out, imported.average_output) == (
        jimported.objective, jimported.num_model_out, jimported.average_output)
    np.testing.assert_allclose(imported.raw_score(X, device="cpu"), jimported.raw_score(X),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(imported.predict(X, device="cpu"),
                               np.asarray(jimported.predict(X)), rtol=1e-6, atol=1e-6)
    # the import scores the booster it came from
    np.testing.assert_allclose(imported.raw_score(X, device="cpu"),
                               loaded.raw_score(X, device="cpu"), rtol=1e-5, atol=1e-5)
    assert to_lightgbm_string(imported) == jto_string(jimported)
    np.testing.assert_allclose(imported.raw_score(X[:10], num_iterations=50, device="cpu"),
                               imported.raw_score(X[:10], device="cpu"))


_HANDWRITTEN = {  # tests/test_gbdt.py:487-517 and :587-615
    "default_left": ("""tree
version=v3
num_class=1
num_tree_per_iteration=1
max_feature_idx=1
objective=regression

Tree=0
num_leaves=3
num_cat=0
split_feature=0 1
split_gain=10 5
threshold=0.5 -1
decision_type=10 0
left_child=1 -2
right_child=-1 -3
leaf_value=100 200 300
shrinkage=1

end of trees

parameters:
end of parameters
""", np.array([[0.4, -2.0], [0.4, 0.0], [0.6, 9.9], [np.nan, 0.0], [0.4, np.nan]]),
        [200, 300, 100, 300, 300]),
    "zero_as_missing": ("""tree
version=v3
num_class=1
num_tree_per_iteration=1
max_feature_idx=0
objective=regression

Tree=0
num_leaves=2
num_cat=0
split_feature=0
split_gain=1
threshold=-5
decision_type=6
left_child=-1
right_child=-2
leaf_value=111 222
shrinkage=1

end of trees
""", np.array([[0.0], [np.nan], [-7.0], [3.0]]), [111, 111, 111, 222]),
}


@pytest.mark.parametrize("name", sorted(_HANDWRITTEN))
def test_parse_handwritten_lightgbm_files(name):
    text, X, want = _HANDWRITTEN[name]
    got = parse_lightgbm_string(text).raw_score(X, device="cpu")[:, 0]
    np.testing.assert_allclose(got, want)
    np.testing.assert_allclose(got, jparse(text).raw_score(X)[:, 0])


def test_save_native_model_and_imported_booster_in_the_transformer(tmp_path):
    rs = np.random.default_rng(22)  # tests/test_gbdt.py:520-546
    X = rs.normal(size=(200, 4))
    y = (X[:, 0] - X[:, 1] > 0).astype(int)
    df = pt.DataFrame.from_rows([{"features": X[i], "label": int(y[i])} for i in range(200)])
    model = LightGBMClassifier(num_iterations=10, learning_rate=0.3, device="cpu").fit(df)
    model.save_native_model(str(tmp_path / "native"))
    text = (tmp_path / "native" / "model.txt").read_text()
    assert "objective=binary sigmoid:1" in text
    assert text == jto_string(model.get_booster())
    again = Booster.load(str(tmp_path / "native"), device="cpu")
    np.testing.assert_array_equal(again.raw_score(X), model.get_booster().raw_score(X))
    m2 = LightGBMClassificationModel(booster=parse_lightgbm_string(text),
                                     classes=model.get("classes"), device="cpu")
    out1, out2 = model.transform(df), m2.transform(df)
    np.testing.assert_array_equal(out1.collect_column("prediction"),
                                  out2.collect_column("prediction"))
    np.testing.assert_allclose(np.stack(list(out1.collect_column("probability"))),
                               np.stack(list(out2.collect_column("probability"))), atol=1e-5)
    m2.save_native_model(str(tmp_path / "imported"))  # model.txt only
    assert (tmp_path / "imported" / "model.txt").read_text() == to_lightgbm_string(
        m2.get_booster())
    with pytest.raises(NotImplementedError, match="cover"):
        m2.set(features_shap_col="shap").transform(df)


def test_continued_training_matches_jax():  # tests/test_gbdt.py:1001-1020
    X, y = _mode_dataset(seed=51, n=500)
    kw = dict(objective="binary", num_iterations=5, learning_rate=0.2, num_leaves=7)
    a = train_booster(X, y, device="cpu", seed=0, **kw)
    ja = jtrain_booster(X, y, seed=0, **kw)
    b = train_booster(X, y, device="cpu", seed=1, init_model=a, **kw)
    jb = jtrain_booster(X, y, seed=1, init_model=ja, **kw)
    assert b.num_iterations == jb.num_iterations == 10
    np.testing.assert_array_equal(b.feature, jb.feature)
    np.testing.assert_allclose(b.raw_score(X, device="cpu"), jb.raw_score(X), atol=1e-5)
    # the first 5 trees of the continued model ARE the previous model, bitwise
    for name in ("feature", "threshold_value", "leaf_value"):
        assert np.array_equal(getattr(b, name)[:5], getattr(a, name))
    np.testing.assert_array_equal(b.raw_score(X[:50], num_iterations=5, device="cpu"),
                                  a.raw_score(X[:50], device="cpu"))


def test_continued_training_from_model_string_and_estimator():  # :1023-1041
    X, y = _mode_dataset(seed=52, n=300)
    kw = dict(objective="binary", learning_rate=0.3, num_leaves=7)
    a = train_booster(X, y, device="cpu", num_iterations=4, seed=0, **kw)
    s = to_lightgbm_string(a)
    b = train_booster(X, y, device="cpu", num_iterations=3, init_model=s, **kw)
    jb = jtrain_booster(X, y, num_iterations=3, init_model=s, **kw)
    assert isinstance(b, ImportedBooster) and b.num_iterations == 7
    np.testing.assert_allclose(b.raw_score(X, device="cpu"), jb.raw_score(X), atol=1e-5)
    np.testing.assert_allclose(b.raw_score(X[:40], num_iterations=4, device="cpu"),
                               a.raw_score(X[:40], device="cpu"), rtol=1e-4, atol=1e-4)
    df = pt.DataFrame.from_dict({"features": X.astype(np.float32), "label": y})
    for source in (a, s):
        model = LightGBMClassifier(num_iterations=3, num_leaves=7, model_string=source,
                                   device="cpu").fit(df)
        assert model.get_booster().num_iterations == 7
        model.transform(df)


def test_continued_training_validation_and_truncation():  # :1044-1079
    X, y = _mode_dataset(seed=53, n=200)
    a = train_booster(X, y, objective="binary", num_iterations=2, num_leaves=7, device="cpu")
    with pytest.raises(ValueError, match="features"):
        train_booster(X[:, :4], y, objective="binary", num_iterations=2, init_model=a,
                      device="cpu")
    rf = train_booster(X, y, objective="binary", num_iterations=2, boosting_type="rf",
                       bagging_fraction=0.8, bagging_freq=1, num_leaves=7, device="cpu")
    with pytest.raises(ValueError, match="averaged"):
        train_booster(X, y, objective="binary", num_iterations=2, init_model=rf, device="cpu")
    with pytest.raises(ValueError, match="rf"):
        train_booster(X, y, objective="binary", num_iterations=2, boosting_type="rf",
                      bagging_fraction=0.8, bagging_freq=1, init_model=a, device="cpu")

    X, y = _mode_dataset(seed=54, n=600)
    kw = dict(objective="binary", learning_rate=0.5, num_leaves=7)
    a = train_booster(X[:400], y[:400], num_iterations=100, valid_features=X[400:],
                      valid_labels=y[400:], early_stopping_round=2, device="cpu", **kw)
    assert a.best_iteration and a.best_iteration < a.num_iterations
    b = train_booster(X[:400], y[:400], num_iterations=3, init_model=a, device="cpu", **kw)
    assert b.num_iterations == a.best_iteration + 3
    np.testing.assert_allclose(b.raw_score(X[:50], num_iterations=a.best_iteration,
                                           device="cpu"),
                               a.raw_score(X[:50], device="cpu"), rtol=1e-5, atol=1e-6)
