"""The accuracy gates of the JAX package's GBDT, run on synapseml_torch.

The per-mode gates of ``tests/test_benchmark_gates.py`` (classifier and
regressor, gbdt/goss/dart/rf) and the real-data gates of
``tests/test_real_data_gates.py`` (scikit-learn's bundled breast_cancer,
wine, digits and diabetes on the same held-out splits, with the sklearn
``HistGradientBoosting*`` parity checks), each held to the same
``tests/resources/benchmark_gates.csv`` row. The sampling modes reach the
real-data gates too: breast_cancer through goss, dart, rf and bagging with
``feature_fraction`` against its AUC gate.
"""

import numpy as np
import pytest
import torch
from sklearn.datasets import load_breast_cancer, load_diabetes, load_digits, load_wine

from synapseml_torch.gbdt import train_booster
from test_benchmark_gates import _assert_gate, _cls_data, _reg_data
from test_real_data_gates import _auc, _split


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast here, and idle OpenMP
    threads spinning after each small op would take cores from the other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["gbdt", "goss", "dart", "rf"])
def test_classifier_gate(mode):
    X, y = _cls_data()
    kw = dict(objective="multiclass", num_class=3, num_iterations=50,
              learning_rate=0.1, num_leaves=15, seed=0, boosting_type=mode)
    if mode == "rf":
        kw.update(bagging_fraction=0.7, bagging_freq=1)
    b = train_booster(X[:800], y[:800], device="cpu", **kw)
    acc = float(np.mean(np.argmax(b.predict(X[800:], device="cpu"), axis=1) == y[800:]))
    _assert_gate(f"classifier_{mode}_accuracy", acc)


@pytest.mark.parametrize("mode", ["gbdt", "goss", "dart", "rf"])
def test_regressor_gate(mode):
    X, y = _reg_data()
    kw = dict(objective="regression", num_iterations=50, learning_rate=0.1,
              num_leaves=15, seed=0, boosting_type=mode)
    if mode == "rf":
        kw.update(bagging_fraction=0.7, bagging_freq=1)
    b = train_booster(X[:800], y[:800], device="cpu", **kw)
    rmse = float(np.sqrt(np.mean((b.predict(X[800:], device="cpu").ravel() - y[800:]) ** 2)))
    _assert_gate(f"regressor_{mode}_rmse", rmse)


_BC_MODES = {"gbdt": {}, "goss": dict(boosting_type="goss"), "dart": dict(boosting_type="dart"),
             "rf": dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1),
             "bagging": dict(bagging_fraction=0.8, bagging_freq=2, feature_fraction=0.8)}


@pytest.mark.parametrize("mode", sorted(_BC_MODES))
def test_breast_cancer_auc_gate(mode):
    d = load_breast_cancer()
    Xtr, ytr, Xte, yte = _split(d.data.astype(np.float32), d.target.astype(np.float32))
    b = train_booster(Xtr, ytr, objective="binary", num_iterations=60, learning_rate=0.1,
                      num_leaves=15, seed=0, device="cpu", **_BC_MODES[mode])
    ours = _auc(b.predict(Xte, device="cpu").ravel(), yte)
    _assert_gate("real_breast_cancer_gbdt_auc", ours)
    if mode == "gbdt":
        from sklearn.ensemble import HistGradientBoostingClassifier

        h = HistGradientBoostingClassifier(max_iter=60, learning_rate=0.1, max_leaf_nodes=15,
                                           random_state=0).fit(Xtr, ytr)
        assert ours >= _auc(h.predict_proba(Xte)[:, 1], yte) - 0.02


def test_wine_and_digits_multiclass_gates():
    for load, gate, kw in (
            (load_wine, "real_wine_gbdt_accuracy",
             dict(num_class=3, num_iterations=40, learning_rate=0.1, num_leaves=7)),
            (load_digits, "real_digits_gbdt_accuracy",
             dict(num_class=10, num_iterations=30, learning_rate=0.2, num_leaves=15))):
        d = load()
        Xtr, ytr, Xte, yte = _split(d.data.astype(np.float32), d.target.astype(np.float32))
        b = train_booster(Xtr, ytr, objective="multiclass", seed=0, device="cpu", **kw)
        _assert_gate(gate, float(np.mean(np.argmax(b.predict(Xte, device="cpu"), 1) == yte)))


def test_diabetes_regression_gate_and_parity():
    d = load_diabetes()
    Xtr, ytr, Xte, yte = _split(d.data.astype(np.float32), d.target.astype(np.float32))
    b = train_booster(Xtr, ytr, objective="regression", num_iterations=60, learning_rate=0.1,
                      num_leaves=7, seed=0, device="cpu")
    rmse = float(np.sqrt(np.mean((b.predict(Xte, device="cpu").ravel() - yte) ** 2)))
    _assert_gate("real_diabetes_gbdt_rmse", rmse)
    from sklearn.ensemble import HistGradientBoostingRegressor

    h = HistGradientBoostingRegressor(max_iter=60, learning_rate=0.1, max_leaf_nodes=7,
                                      random_state=0).fit(Xtr, ytr)
    assert rmse <= float(np.sqrt(np.mean((h.predict(Xte) - yte) ** 2))) * 1.10
