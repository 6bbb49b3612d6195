"""synapseml_torch.gbdt's categorical features against the JAX package.

Bin codes of categorical columns bitwise the JAX ``BinMapper``'s; forests
(split features, left sets, thresholds, leaves within 1e-5) against the JAX
booster on the same data; a categorical booster saved by either package
loads in the other with the same scores and leaf indices; and the six
cases of ``tests/test_gbdt_categorical.py`` on the port. The category order
of a node is a stable sort of ``g / (h + cat_smooth)``, so near ties can
flip with the packages' summation order; the data here holds none, which
the forest comparison itself checks (a flip would change a left set).
"""

import numpy as np
import pytest
import torch

import synapseml_torch as pt
from synapseml_torch.gbdt import (Booster, LightGBMClassifier, parse_lightgbm_string,
                                  to_lightgbm_string, train_booster)
from synapseml_torch.gbdt.binning import BinMapper
from synapseml_tpu.gbdt import TpuBooster
from synapseml_tpu.gbdt import to_lightgbm_string as jto_string
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


def _cat_data(n=3000, n_cats=30, seed=0, noise=0.05):  # tests/test_gbdt_categorical.py:19
    rs = np.random.default_rng(seed)
    cats = rs.integers(0, n_cats, n)
    good = rs.permutation(n_cats)[: n_cats // 2]
    y = np.isin(cats, good).astype(np.float32)
    flip = rs.random(n) < noise
    y[flip] = 1 - y[flip]
    X = np.column_stack([rs.normal(size=n), cats.astype(np.float64),
                         rs.normal(size=n) * 0.1]).astype(np.float32)
    return X, y, good


def _acc(b, X, y):
    return float(((np.asarray(b.predict(X, device="cpu")).ravel() > 0.5) == (y > 0.5)).mean())


KW = dict(objective="binary", num_iterations=5, learning_rate=0.3, num_leaves=7,
          max_depth=3, min_data_in_leaf=5, seed=0, categorical_features=[1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_categorical_bin_codes_match_jax(dtype):
    rs = np.random.default_rng(4)
    X = rs.normal(size=(3000, 4)).astype(dtype)
    X[:, 1] = rs.integers(-3, 300, 3000)  # negative and past max_bin: the NaN bin
    X[:, 3] = np.floor(rs.uniform(0, 40, 3000)) + 0.5  # floored codes
    X[rs.random((3000, 4)) < 0.05] = np.nan
    for max_bin in (63, 255):
        want = JBinMapper(max_bin=max_bin, categorical=(1, 3)).fit_transform(X)
        mapper = BinMapper(max_bin=max_bin, categorical=(1, 3))
        got = mapper.fit_transform(X)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        back = BinMapper.from_dict(mapper.to_dict())
        assert back.categorical == (1, 3)
        np.testing.assert_array_equal(back.transform(X), got)
        jback = JBinMapper.from_dict(mapper.to_dict())
        np.testing.assert_array_equal(jback.transform(X), got)
    with pytest.raises(ValueError, match="out of range"):
        BinMapper(categorical=(7,)).fit_transform(X)


@pytest.mark.parametrize("case", ["binary", "multiclass", "with_numeric_signal"])
def test_categorical_forest_matches_jax(case):
    X, y, _ = _cat_data(n=1500)
    kw = dict(KW)
    if case == "multiclass":
        effect = np.random.default_rng(5).normal(size=30)
        score = effect[X[:, 1].astype(int)] + 0.5 * X[:, 0]
        y = np.digitize(score, np.quantile(score, [0.33, 0.66])).astype(np.float32)
        kw.update(objective="multiclass", num_class=3)
    elif case == "with_numeric_signal":
        y = ((y > 0.5) ^ (X[:, 0] > 0.8)).astype(np.float32)
        kw.update(num_leaves=15, max_depth=4, num_iterations=6)
    b = train_booster(X, y, device="cpu", **kw)
    jb = jtrain_booster(X, y, **kw)
    np.testing.assert_array_equal(b.feature, jb.feature)
    np.testing.assert_array_equal(b.cat_mask, jb.cat_mask)
    np.testing.assert_allclose(b.threshold_value, jb.threshold_value, rtol=1e-6)
    np.testing.assert_allclose(b.leaf_value, jb.leaf_value, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.raw_score(X, device="cpu"), jb.raw_score(X), atol=1e-5)
    assert b.categorical_features == jb.categorical_features == (1,)
    assert to_lightgbm_string(b) == jto_string(b)


def test_categorical_boosters_load_in_both_packages(tmp_path):
    X, y, _ = _cat_data(n=1500)
    jb = jtrain_booster(X, y, **KW)
    jb.save(str(tmp_path / "jax"))
    loaded = Booster.load(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_allclose(loaded.raw_score(X, device="cpu"), jb.raw_score(X), atol=1e-6)
    np.testing.assert_array_equal(loaded.predict_leaf(X[:64], device="cpu"),
                                  jb.predict_leaf(X[:64]))
    port = train_booster(X, y, device="cpu", **KW)
    port.save(str(tmp_path / "port"))
    back = TpuBooster.load(str(tmp_path / "port"))
    assert back.categorical_features == (1,)
    np.testing.assert_allclose(back.raw_score(X), port.raw_score(X, device="cpu"), atol=1e-6)


def test_categorical_split_beats_numerical_treatment():
    X, y, _ = _cat_data()
    kw = dict(objective="binary", num_iterations=2, learning_rate=0.5,
              num_leaves=7, max_depth=3, min_data_in_leaf=5, seed=0)
    b_cat = train_booster(X, y, categorical_features=[1], device="cpu", **kw)
    b_num = train_booster(X, y, device="cpu", **kw)
    acc_cat, acc_num = _acc(b_cat, X, y), _acc(b_num, X, y)
    assert acc_cat > 0.92, acc_cat
    assert acc_cat > acc_num + 0.05, (acc_cat, acc_num)


def test_unseen_and_invalid_categories_route_like_missing():
    X, y, _ = _cat_data()
    b = train_booster(X, y, device="cpu", **dict(KW, num_iterations=6))
    probe = np.tile(X[:1], (4, 1)).astype(np.float32)
    probe[0, 1] = 254.0   # in-range but never seen in training
    probe[1, 1] = 3000.0  # out of the bin range entirely
    probe[2, 1] = -5.0    # negative code
    probe[3, 1] = np.nan  # missing
    p = np.asarray(b.predict(probe, device="cpu")).ravel()
    assert np.allclose(p, p[0]), p


def test_categorical_save_load_leaf_shap_and_dump(tmp_path):
    X, y, _ = _cat_data(n=1500)
    b = train_booster(X, y, device="cpu", **KW)
    b.save(str(tmp_path / "m"))
    b2 = Booster.load(str(tmp_path / "m"), device="cpu")
    assert b2.categorical_features == (1,)
    np.testing.assert_array_equal(b.predict(X, device="cpu"), b2.predict(X, device="cpu"))
    np.testing.assert_array_equal(b.predict_leaf(X[:64], device="cpu"),
                                  b2.predict_leaf(X[:64], device="cpu"))
    contrib = b.predict_contrib(X[:128])
    np.testing.assert_allclose(contrib.sum(-1)[:, 0], b.raw_score(X[:128], device="cpu")[:, 0],
                               rtol=1e-4, atol=1e-5)
    mean_abs = np.abs(contrib[:, 0, :-1]).mean(0)
    assert mean_abs[1] > 5 * max(mean_abs[0], mean_abs[2]), mean_abs
    assert " in [" in b.dump_text()


@pytest.mark.parametrize("boosting_type", ["goss", "dart"])
def test_categorical_with_sampling_modes(boosting_type):
    X, y, _ = _cat_data(n=1500)
    b = train_booster(X, y, device="cpu", boosting_type=boosting_type,
                      **dict(KW, num_iterations=6))
    assert _acc(b, X, y) > 0.85


def test_estimator_categorical_slot_indexes():
    X, y, _ = _cat_data(n=1500)
    df = pt.DataFrame.from_dict({"features": X, "label": y.astype(np.int32)},
                                num_partitions=4)
    model = LightGBMClassifier(num_iterations=8, learning_rate=0.3, num_leaves=7,
                               max_depth=3, min_data_in_leaf=5, categorical_slot_indexes=[1],
                               device="cpu").fit(df)
    out = model.transform(df)
    acc = float(np.mean(out.collect_column("prediction") == out.collect_column("label")))
    assert acc > 0.92, acc


def test_categorical_native_model_txt_round_trip():
    X, y, _ = _cat_data(n=1500)
    b = train_booster(X, y, device="cpu", **KW)
    text = to_lightgbm_string(b)
    assert "num_cat=" in text and "cat_threshold=" in text
    imported = parse_lightgbm_string(text)
    probe = np.vstack([X[:200], X[:1]])
    probe[-1, 1] = np.nan  # missing categorical routes right both sides
    np.testing.assert_allclose(imported.predict(probe, device="cpu").ravel(),
                               b.predict(probe, device="cpu").ravel(), rtol=1e-5, atol=1e-6)
    assert to_lightgbm_string(imported) == to_lightgbm_string(imported)
    again = parse_lightgbm_string(to_lightgbm_string(imported))
    np.testing.assert_allclose(again.predict(probe, device="cpu"),
                               imported.predict(probe, device="cpu"), rtol=1e-6)
