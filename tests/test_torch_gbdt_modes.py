"""synapseml_torch.gbdt's boosting modes and sampling against the JAX package.

Torch cannot reproduce ``jax.random``'s bits, so row bagging,
``feature_fraction`` and goss are held by distribution: the rows each tree
sees (a tree's root cover, in both packages) are held to their expected
fractions within 4 standard deviations; the port's ``grow_tree`` calls
show the bag constant between resamples and exactly ``k_feat`` features
offered a tree. The accuracy gates and the dart, rf and
early-stopping cases of ``tests/test_gbdt.py:104,357-460`` run on the port.
dart without sampling draws its drops from the same numpy generator as the
JAX booster, so it is held to the JAX forest tree by tree (1e-5).
"""

import numpy as np
import pytest
import torch

from synapseml_torch.gbdt import booster as tbooster
from synapseml_torch.gbdt import train_booster
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


def _binary_data(n=3000, f=10):  # tests/test_gbdt.py:25-30
    rs = np.random.default_rng(0)
    x = rs.normal(size=(n, f))
    logit = 2 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    return x, (logit + rs.normal(scale=0.5, size=n) > 0).astype(np.float32)


def _acc(b, X, y, **kw):
    return float(np.mean((np.asarray(b.predict(X, **kw)).ravel() >= 0.5) == y))


class _port_recorder:
    """Records (presence, feature mask, gradient) of every tree the port
    grows."""

    def __enter__(self):
        self.calls, self._grow = [], tbooster.T.grow_tree

        def grow(bins, grad, hess, presence, cfg, feat_mask, rows=None):
            self.calls.append(tuple(a.numpy() for a in (presence, feat_mask, grad)))
            return self._grow(bins, grad, hess, presence, cfg, feat_mask, rows)

        tbooster.T.grow_tree = grow
        return self

    def __exit__(self, *exc):
        tbooster.T.grow_tree = self._grow


def _within_4_sigma(frac, p, n):
    return abs(frac - p) <= 4 * np.sqrt(p * (1 - p) / n)


def _root_fractions(b, n):
    """Rows each tree saw: a tree's root cover is its presence count."""
    return b.cover[:, 0, 0] / n


def test_bagging_and_feature_fraction_sample_by_distribution():
    X, y = _binary_data()
    n = len(y)
    kw = dict(objective="binary", num_iterations=20, learning_rate=0.2,
              bagging_fraction=0.7, bagging_freq=3, feature_fraction=0.8, seed=5)
    with _port_recorder() as rec:
        b = train_booster(X, y, device="cpu", **kw)
    jb = jtrain_booster(X, y, **kw)
    assert _acc(b, X, y, device="cpu") > 0.9 and _acc(jb, X, y) > 0.9  # test_gbdt.py:104
    for fracs in (_root_fractions(b, n), _root_fractions(jb, n)):
        assert all(_within_4_sigma(f, 0.7, n) for f in fracs), fracs
    k_feat = int(round(10 * 0.8))
    bags = [p for p, _, _ in rec.calls]
    for it, (presence, fmask, _) in enumerate(rec.calls):
        assert set(np.unique(presence)) <= {0.0, 1.0}
        assert fmask.sum() == k_feat
        # the bag is kept between resamples, redrawn at each multiple of 3
        assert np.array_equal(presence, bags[it - it % 3])
        if it % 3 == 0 and it:
            assert not np.array_equal(presence, bags[it - 3])
    assert len({tuple(m) for _, m, _ in rec.calls}) > 5  # a fresh mask a tree
    # features outside a tree's mask never split it
    for t, (_, fmask, _) in enumerate(rec.calls):
        used = b.feature[t, 0][b.feature[t, 0] >= 0]
        assert fmask[used].all()
    again = train_booster(X, y, device="cpu", **kw)
    assert np.array_equal(again.leaf_value, b.leaf_value)  # one seed, one fit


def test_goss_keeps_the_top_rows_and_samples_the_rest():
    X, y = _binary_data()
    n = len(y)
    top, other = 0.2, 0.1
    kw = dict(objective="binary", num_iterations=15, learning_rate=0.2,
              boosting_type="goss", top_rate=top, other_rate=other, seed=1)
    with _port_recorder() as rec:
        b = train_booster(X, y, device="cpu", **kw)
    jb = jtrain_booster(X, y, **kw)
    assert _acc(b, X, y, device="cpu") > 0.9 and _acc(jb, X, y) > 0.9
    want = top + other * (1 - top)
    # iteration 0: every |g| ties at the threshold, so every row is "top"
    for fracs in (_root_fractions(b, n)[1:], _root_fractions(jb, n)[1:]):
        assert all(_within_4_sigma(f, want, n) for f in fracs), fracs
    k_top = int(round(top * n))
    amp = (1 - top) / other
    for presence, fmask, grad in rec.calls[1:]:
        assert fmask.all() and presence.sum() >= k_top
        assert np.array_equal(grad != 0, presence > 0)
        # the kept rows: the k_top largest |g| at weight 1, the sampled rest
        # amplified; divided back, every sampled row is below every top row
        mag = np.abs(grad[presence > 0])
        top_rows = np.sort(mag)[-k_top:]
        rest = np.sort(mag)[:-k_top] / amp
        assert rest.max() <= top_rows.min() * (1 + 1e-6)


@pytest.mark.parametrize("mode", ["goss", "dart", "rf"])
def test_boosting_modes_accuracy(mode):  # tests/test_gbdt.py:357-376
    X, y = _mode_dataset()
    kw = dict(objective="binary", num_iterations=30, num_leaves=15, seed=0)
    if mode == "rf":
        kw.update(bagging_fraction=0.7, bagging_freq=1, num_iterations=40)
    else:
        kw.update(learning_rate=0.2)
    b = train_booster(X, y, boosting_type=mode, device="cpu", **kw)
    jb = jtrain_booster(X, y, boosting_type=mode, **kw)
    acc, jacc = _acc(b, X, y, device="cpu"), _acc(jb, X, y)
    assert acc > 0.9 and jacc > 0.9, (acc, jacc)
    assert abs(acc - jacc) < 0.03
    assert b.params["boosting_type"] == mode
    if mode == "rf":
        assert b.average_output
        p = b.predict(X, device="cpu")
        assert 0.0 < p.mean() < 1.0  # averaged, not summed


@pytest.mark.parametrize("num_class", [1, 3])
def test_dart_without_sampling_grows_the_jax_forest(num_class):
    """dart's drops come from np.random.default_rng(seed + 17) in both
    packages: with no bagging the forests agree tree by tree."""
    X, y = _mode_dataset(seed=9, n=400)
    kw = dict(objective="binary", num_iterations=12, learning_rate=0.3, num_leaves=7,
              drop_rate=0.4, skip_drop=0.2, seed=3, boosting_type="dart")
    if num_class == 3:
        y = np.digitize(X[:, 0] - X[:, 2], [-0.5, 0.5]).astype(np.float32)
        kw.update(objective="multiclass", num_class=3)
    b = train_booster(X, y, device="cpu", **kw)
    jb = jtrain_booster(X, y, **kw)
    np.testing.assert_array_equal(b.feature, jb.feature)
    np.testing.assert_allclose(b.threshold_value, jb.threshold_value, rtol=1e-6)
    np.testing.assert_allclose(b.leaf_value, jb.leaf_value, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.raw_score(X, device="cpu"), jb.raw_score(X), atol=1e-5)


def test_dart_additivity_after_rescaling():  # tests/test_gbdt.py:378-390
    X, y = _mode_dataset(seed=9, n=300)
    b = train_booster(X, y, objective="binary", boosting_type="dart", device="cpu",
                      num_iterations=12, learning_rate=0.3, num_leaves=7,
                      drop_rate=0.4, skip_drop=0.2, seed=3)
    assert b.train_measures["trees_dropped_count"] > 0
    contrib = b.predict_contrib(X[:20])
    np.testing.assert_allclose(contrib[:, 0, :].sum(-1),
                               b.raw_score(X[:20], device="cpu")[:, 0], atol=1e-4)


def test_rf_with_early_stopping():  # tests/test_gbdt.py:393-402
    X, y = _mode_dataset(seed=10)
    b = train_booster(X[:600], y[:600], objective="binary", boosting_type="rf",
                      bagging_fraction=0.7, bagging_freq=1, num_iterations=40,
                      valid_features=X[600:], valid_labels=y[600:],
                      early_stopping_round=5, device="cpu")
    assert _acc(b, X[600:], y[600:], device="cpu") > 0.85


def test_rf_defaults_bagging_and_shap_additivity():  # tests/test_gbdt.py:424-433
    X, y = _mode_dataset(seed=12, n=300)
    with _port_recorder() as rec:
        b = train_booster(X, y, objective="binary", boosting_type="rf", num_iterations=10,
                          device="cpu")
    # rf without bagging gets LightGBM's 0.632 every iteration, on the
    # initial scores' gradients (every tree fits the same gradient)
    for presence, _, grad in rec.calls:
        assert _within_4_sigma(presence.mean(), 0.632, 300)
        assert np.array_equal(grad != 0, presence > 0)
    assert len({p.tobytes() for p, _, _ in rec.calls}) == 10
    contrib = b.predict_contrib(X[:20])
    np.testing.assert_allclose(contrib[:, 0, :].sum(-1),
                               b.raw_score(X[:20], device="cpu")[:, 0], atol=1e-4)


def test_dart_early_stopping_returns_measured_model():  # tests/test_gbdt.py:436-455
    X, y = _mode_dataset(seed=13, n=600)
    kw = dict(objective="binary", boosting_type="dart", num_iterations=25,
              learning_rate=0.3, drop_rate=0.5, skip_drop=0.1, valid_features=X[400:],
              valid_labels=y[400:], early_stopping_round=3, seed=5)
    b = train_booster(X[:400], y[:400], device="cpu", **kw)
    jb = jtrain_booster(X[:400], y[:400], **kw)
    # (31 leaves on 400 rows: equal-gain thresholds over empty bins tie, and
    # the packages' prefix sums break such ties apart, so only the stopping
    # point is compared with the JAX booster here)
    assert b.best_iteration is not None and b.best_iteration == jb.best_iteration
    assert b.feature.shape[0] == b.best_iteration
    contrib = b.predict_contrib(X[:10])
    np.testing.assert_allclose(contrib[:, 0, :].sum(-1),
                               b.raw_score(X[:10], device="cpu")[:, 0], atol=1e-4)


@pytest.mark.parametrize("mode", ["goss", "bagging"])
def test_sampled_fit_on_the_kernel_path_is_its_own_twin(mode):
    """The host draws make a fit a pure function of its seed: the kernel's
    plain version (histogram_impl='pallas' on the CPU) gives bitwise the
    same forest twice, and 'segment' the same split features."""
    X, y = _mode_dataset(seed=14, n=600)
    kw = dict(objective="binary", num_iterations=6, learning_rate=0.3, num_leaves=7,
              seed=2, feature_fraction=0.7)
    kw.update(dict(boosting_type="goss") if mode == "goss"
              else dict(bagging_fraction=0.6, bagging_freq=2))
    a = train_booster(X, y, histogram_impl="pallas", device="cpu", **kw)
    b = train_booster(X, y, histogram_impl="pallas", device="cpu", **kw)
    for name in ("feature", "threshold_value", "leaf_value", "gain", "cover"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    seg = train_booster(X, y, histogram_impl="segment", device="cpu", **kw)
    np.testing.assert_array_equal(seg.feature, a.feature)
