"""Data-parallel LightGBM of the port over gloo worlds of 2 and 4 processes.

Rows split over the mesh's ``data`` axis (1001 rows: padded to a multiple
of the world with presence 0; lambdarank cut at query-group boundaries).
Held to:

* the one-process port forest, BITWISE (features, thresholds, leaf values
  and predictions), with ``histogram_impl='pallas'`` whose CPU route is the
  kernel's plain version in its int64-sum mode: binary, regression,
  multiclass and lambdarank, and goss for binary and lambdarank;
* the 'segment' histograms summed as floats: the same split features as
  one process, predictions within 1e-5;
* the JAX package's sharded forest (``TestSharded`` of ``test_gbdt.py``:
  the same rows, ``mesh_dp8``): predictions within its rtol 1e-4 / atol
  1e-5.

The ranks are spawned once a world (``_torch_ranks.py``).
"""

import numpy as np
import pytest

from _torch_rank_cases import GBDT_KW, gbdt_data, gbdt_fit
from _torch_ranks import spawn


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: spawn("_torch_rank_cases:gbdt_suite", w, tmp_path_factory.mktemp(f"gbdt{w}"))
            for w in (2, 4)}


@pytest.fixture(scope="module")
def single():
    out = {}
    for kind in GBDT_KW:
        for mode, extra in (("gbdt", {}), ("goss", dict(boosting_type="goss")),
                            ("segment", dict(histogram_impl="segment"))):
            if mode != "gbdt" and kind not in ("binary", "lambdarank"):
                continue
            out[f"{kind}/{mode}"] = gbdt_fit(kind, **extra)
    return out


def _pred(b, kind):
    x, _, _ = gbdt_data(kind)
    return np.asarray(b.raw_score(x[:200], device="cpu") if kind == "lambdarank"
                      else b.predict(x[:200], device="cpu"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag", ["binary/gbdt", "regression/gbdt", "multiclass/gbdt",
                                 "lambdarank/gbdt", "binary/goss", "lambdarank/goss"])
def test_forest_over_ranks_is_the_one_process_forest_bitwise(worlds, single, world, tag):
    b = single[tag]
    kind = tag.split("/")[0]
    for r, got in enumerate(worlds[world]):
        assert np.array_equal(got[f"{tag}/feature"], b.feature), (r, tag)
        assert np.array_equal(got[f"{tag}/threshold"], b.threshold_value), (r, tag)
        assert np.array_equal(got[f"{tag}/leaf"], b.leaf_value), (r, tag)
        assert np.array_equal(got[f"{tag}/pred"], _pred(b, kind)), (r, tag)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["binary", "lambdarank"])
def test_segment_histograms_sum_as_floats(worlds, single, world, kind):
    b = single[f"{kind}/segment"]
    got = worlds[world][0]
    assert np.array_equal(got[f"{kind}/segment/feature"], b.feature)
    np.testing.assert_allclose(got[f"{kind}/segment/pred"], _pred(b, kind), atol=1e-5)


def test_uneven_rows_match_jax_sharded(worlds, mesh_dp8):
    """``TestSharded`` (test_gbdt.py:233-249): the JAX package's forest on
    its 8-device data mesh; the port's over 2 and 4 processes."""
    from synapseml_tpu.gbdt.booster import train_booster

    x, y, _ = gbdt_data("binary")
    jb = train_booster(x, y, objective="binary", num_iterations=4, learning_rate=0.3,
                       num_leaves=7, min_data_in_leaf=5, mesh=mesh_dp8.mesh)
    want = np.asarray(jb.predict(x[:200]))
    for world in (2, 4):
        np.testing.assert_allclose(worlds[world][0]["binary/gbdt/pred"], want,
                                   rtol=1e-4, atol=1e-5)
    assert ((worlds[4][0]["binary/gbdt/pred"] > 0.5) == y[:200]).mean() > 0.9


def test_estimator_mesh_config_at_one_process():
    """The estimators' ``mesh_config`` in a world of one: the forest of the
    stage without it, bitwise."""
    import synapseml_torch as pt
    from synapseml_torch.gbdt import LightGBMClassifier
    from synapseml_torch.parallel import MeshConfig

    x, y, _ = gbdt_data("binary")
    df = pt.DataFrame.from_dict({"features": x.astype(np.float32), "label": y})
    kw = dict(num_iterations=3, num_leaves=7, histogram_impl="pallas", device="cpu")
    a = LightGBMClassifier(**kw).fit(df).get_booster()
    b = LightGBMClassifier(mesh_config=MeshConfig(data=1), **kw).fit(df).get_booster()
    assert np.array_equal(a.leaf_value, b.leaf_value)
    assert np.array_equal(a.feature, b.feature)
