"""synapseml_torch's vision nets, BatchNorm trainer state and vision stages
against the JAX package's.

Everything runs in f32 compute on the CPU (the presets patched to f32 on
both sides, in the tests only), the Flax side jitted, the same numpy inputs
through both packages and the Flax weights carried over by
``convert_jax``'s bridges:

* ``ViTClassifier`` (``vit_tiny``) logits within 1e-5, at 16 x 16 and
  32 x 32 and at 20 x 20 and 19 x 21 with patch 8 (Flax's 'SAME' padding,
  symmetric and not);
* ``ResNet`` with basic and bottleneck blocks (the stem's max pool in the
  second) logits and pooled features within 1e-5 at random running
  statistics; in train mode the logits within 1e-5 and the running
  statistics after one call within 1e-6 of Flax's
  ``mutable=["batch_stats"]``; one BatchNorm layer's train-mode output and
  statistics within 1e-6 of ``nn.BatchNorm``'s;
* the numpy initialisers: the Flax init's leaves, shapes and per-leaf
  distribution;
* ``vit_tiny`` (einsum and flash) and ``resnet_tiny`` Trainer steps against
  the JAX ``Trainer``: losses within 1e-5, gradient norms rtol 1e-4, params
  within 2e-5 (on at least 99.9 % of each leaf, every entry within
  lr x steps) and running statistics within 2e-5; ``train_steps_scan`` with
  batch statistics bitwise the per-step steps and within the same limits
  of the JAX ``train_steps_scan``;
* ``DeepVisionClassifier`` -> ``DeepVisionModel`` against the JAX stages
  (the Flax init grafted through ``vision._init_variables``): fitted
  params as above, scores within 1e-4 with equal predictions; the inputs of
  tests/test_models.py's two vision tests reach train accuracy > 0.8; save
  -> load bitwise; the Param surface; the refusals.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synapseml_torch as pt
from synapseml_torch.core import batching as tcb
from synapseml_torch.models import convert_jax
from synapseml_torch.models import trainer as tt
from synapseml_torch.models import vision as tvision
from synapseml_torch.models.nets import resnet as tresnet
from synapseml_torch.models.nets import vit as tvit
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.models import trainer as jt
from synapseml_tpu.models import vision as jvision
from synapseml_tpu.models.flax_nets import resnet as jresnet
from synapseml_tpu.models.flax_nets import vit as jvit
from synapseml_tpu.parallel.mesh import MeshConfig, create_mesh

TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, nn.unbox(tree))


def _x(B, H, W, C=3, seed=0):
    return np.random.default_rng(seed).normal(size=(B, H, W, C)).astype(np.float32)


def _to_torch(sd):
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


# ---------------------------------------------------------------- the nets


def _vit_pair(num_classes=4, patch=8, **kw):
    jm = jvit.ViTClassifier(jvit.vit_tiny(dtype=jnp.float32, **kw), num_classes=num_classes,
                            patch=patch)
    tm = tvit.ViTClassifier(tvit.vit_tiny(dtype=torch.float32, **kw), num_classes=num_classes,
                            patch=patch)
    return jm, tm


@pytest.mark.parametrize("hw", [(16, 16), (32, 32), (20, 20), (19, 21)])
def test_vit_logits_match_flax(hw):
    jm, tm = _vit_pair()
    x = _x(3, *hw, seed=hw[0])
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"])
    tm.load_state_dict(_to_torch(convert_jax.vit_state_dict_from_flax(params)))
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    with torch.no_grad():
        got = tm(x=torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_same_padding_is_xla_s():
    assert tvit.same_padding(20, 8, 8) == (2, 2)
    assert tvit.same_padding(19, 8, 8) == (2, 3)
    assert tvit.same_padding(21, 8, 8) == (1, 2)
    assert tvit.same_padding(224, 16, 16) == (0, 0)


_RESNETS = {  # name -> (ResNet kwargs, image size)
    "basic, stem stride 1 (resnet_tiny)": (dict(stage_sizes=(1, 1), block="basic", width=8,
                                                stem_stride=1, num_classes=5), 16),
    "bottleneck, stem stride 2 and max pool": (dict(stage_sizes=(1, 2), block="bottleneck",
                                                    width=8, num_classes=5), 32),
    "basic, two blocks a stage (resnet18's layout)": (dict(stage_sizes=(2, 2, 2), block="basic",
                                                           width=8, num_classes=3), 32),
}


def _resnet_pair(kw):
    return jresnet.ResNet(**kw, dtype=jnp.float32), tresnet.ResNet(**kw, dtype=torch.float32)


def _resnet_variables(jm, x, seed=0):
    """Flax init with random running statistics (the eval path reads them)."""
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(seed), x))
    rs = np.random.default_rng(seed + 1)
    stats = jax.tree.map(lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         v["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: a - 1.0 if p[-1].key == "mean" else a, stats)
    return {"params": v["params"], "batch_stats": stats}


def _load_resnet(tm, v):
    tm.load_state_dict(_to_torch(convert_jax.resnet_state_dict_from_flax(v["params"],
                                                                         v["batch_stats"])))


@pytest.mark.parametrize("case", sorted(_RESNETS))
def test_resnet_logits_and_features_match_flax(case):
    kw, hw = _RESNETS[case]
    jm, tm = _resnet_pair(kw)
    x = _x(4, hw, hw, seed=1)
    v = _resnet_variables(jm, x)
    _load_resnet(tm, v)
    with torch.no_grad():
        for features_only in (False, True):
            want = np.asarray(jax.jit(functools.partial(jm.apply, features_only=features_only))(
                v, x))
            got = tm(torch.from_numpy(x), features_only=features_only)
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", sorted(_RESNETS))
def test_resnet_train_mode_matches_flax(case):
    kw, hw = _RESNETS[case]
    jm, tm = _resnet_pair(kw)
    x = _x(4, hw, hw, seed=2)
    v = _resnet_variables(jm, x)
    _load_resnet(tm, v)
    want, new = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(v, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    want_stats = convert_jax.resnet_state_dict_from_flax(batch_stats=_np(new["batch_stats"]))
    bufs = dict(tm.named_buffers())
    assert sorted(bufs) == sorted(want_stats)
    for name, buf in bufs.items():
        np.testing.assert_allclose(buf.numpy(), want_stats[name], atol=1e-6, rtol=0,
                                   err_msg=name)


def test_batchnorm_matches_flax_in_train_mode():
    """One layer: the biased E[x^2] - E[x]^2 variance, the 0.9 / 0.1 update of
    both running statistics, eps 1e-5 (the unbiased variance over these 210
    values a channel is 0.5 % larger, which moves the output by ~1e-3)."""
    x = (_x(6, 5, 7, 4, seed=3) + 0.5).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.float32)
    v = _np(bn.init(jax.random.PRNGKey(0), x))
    rs = np.random.default_rng(4)
    v["params"] = {"scale": rs.normal(size=4).astype(np.float32),
                   "bias": rs.normal(size=4).astype(np.float32)}
    v["batch_stats"] = {"mean": rs.normal(size=4).astype(np.float32),
                        "var": rs.uniform(0.5, 2, 4).astype(np.float32)}
    want, new = bn.apply(v, x, mutable=["batch_stats"])
    tbn = tresnet.BatchNorm(4, dtype=torch.float32)
    tbn.load_state_dict(_to_torch({"weight": v["params"]["scale"], "bias": v["params"]["bias"],
                                   **v["batch_stats"]}))
    with torch.no_grad():
        got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, leaf).numpy(),
                                   np.asarray(new["batch_stats"][leaf]), atol=1e-6, rtol=0)
    torch_bn = torch.nn.BatchNorm2d(4, momentum=0.1)  # torch's running var is unbiased
    torch_bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(torch_bn.running_var.numpy(), tbn.var.numpy(), atol=1e-4)


# ---------------------------------------------------------- the initialisers


def _assert_flax_distribution(got: dict, want: dict):
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for name in got:
        g, w = got[name], want[name]
        assert g.dtype == np.float32, name
        if np.all(w == w.flat[0]):  # biases, cls 0; scales, variances 1
            assert np.array_equal(g, w), name
        else:
            assert abs(g.std() / w.std() - 1) < 0.1, name
            assert abs(g.mean()) < 3 * w.std() / np.sqrt(g.size), name
            assert np.abs(g).max() <= 1.5 * np.abs(w).max(), name


def test_vit_init_has_the_flax_distribution():
    cfg = dict(hidden=96, mlp_dim=192, max_len=65)
    jm, tm = _vit_pair(num_classes=200, **cfg)
    want = convert_jax.vit_state_dict_from_flax(
        _np(jm.init(jax.random.PRNGKey(0), _x(1, 64, 64))["params"]))
    got, stats = tvision._init_variables(tm, seed=0)
    assert stats is None
    _assert_flax_distribution(got, want)
    again, _ = tvision._init_variables(tm, seed=0)
    assert all(np.array_equal(got[k], again[k]) for k in got)


def test_resnet_init_has_the_flax_distribution():
    kw = dict(stage_sizes=(1, 1), block="bottleneck", width=16, num_classes=200)
    jm, tm = _resnet_pair(kw)
    v = _np(jm.init(jax.random.PRNGKey(0), _x(1, 32, 32)))
    want = convert_jax.resnet_state_dict_from_flax(v["params"])
    want_stats = convert_jax.resnet_state_dict_from_flax(batch_stats=v["batch_stats"])
    got, stats = tvision._init_variables(tm, seed=0)
    _assert_flax_distribution(got, want)
    assert sorted(stats) == sorted(want_stats)
    assert all(np.array_equal(stats[k], want_stats[k]) for k in stats)
    # lecun_normal is truncated at two standard deviations
    w = got["stem.weight"]
    assert np.abs(w).max() <= 2 * np.sqrt(1 / (7 * 7 * 3)) / 0.87962566103423978 + 1e-7


# ----------------------------------------------------------- trainer steps

B, STEPS, LR = 8, 6, 2e-3


def _one_device():
    return create_mesh(MeshConfig(), devices=jax.devices()[:1])


def _batches(hw, n=STEPS, seed=0):
    rs = np.random.default_rng(seed)
    out = []
    for i in range(n):
        valid = np.ones(B, np.float32)
        valid[B - 1 - i % 3:] = 0.0  # padded tail rows, as the loader's tail batch has
        out.append({"x": rs.normal(size=(B, hw, hw, 3)).astype(np.float32),
                    "labels": rs.integers(0, 3, B).astype(np.int32), "_valid": valid})
    return out


def _trainer_pair(kind, attn_impl="einsum", **cfg):
    common = dict(learning_rate=LR, total_steps=STEPS, grad_clip=1.0, lr_schedule="cosine",
                  warmup_steps=2, **cfg)
    if kind == "vit":
        jm, tm = _vit_pair(num_classes=3, attn_impl=attn_impl)
        hw = 16
        tree = _np(jm.init(jax.random.PRNGKey(0), _x(1, hw, hw))["params"])
        init, stats = convert_jax.vit_state_dict_from_flax(tree), None
        jinit = dict(params=tree)
    else:
        jm, tm = _resnet_pair(dict(stage_sizes=(1, 1), block="basic", width=8, stem_stride=1,
                                   num_classes=3))
        hw = 16
        v = _resnet_variables(jm, _x(1, hw, hw))
        init = convert_jax.resnet_state_dict_from_flax(v["params"])
        stats = convert_jax.resnet_state_dict_from_flax(batch_stats=v["batch_stats"])
        jinit = dict(params=v["params"], batch_stats=v["batch_stats"])
    has_bn = kind == "resnet"
    jtrainer = jt.Trainer(jm, _one_device(), jt.TrainerConfig(**common), has_batch_stats=has_bn)
    ttrainer = tt.Trainer(tm, tt.TrainerConfig(**common), device="cpu", has_batch_stats=has_bn)
    jstate = jtrainer.resume_state(jinit["params"], batch_stats=jinit.get("batch_stats"))
    tstate = ttrainer.init_state(init_params=init, init_batch_stats=stats)
    return (jtrainer, jstate), (ttrainer, tstate), init, hw


def _assert_state_matches(tstate, jstate, kind, init):
    bridge = (convert_jax.vit_state_dict_from_flax if kind == "vit"
              else convert_jax.resnet_state_dict_from_flax)
    want = bridge(_np(jstate.params))
    assert sorted(tstate.params) == sorted(want)
    for name, p in tstate.params.items():
        got = p.detach().numpy()
        diff = np.abs(got - want[name])
        assert diff.max() <= LR * STEPS, name
        if not name.endswith("attn.k.bias"):  # its exact gradient is 0: rounding noise
            assert (diff > 2e-5).mean() <= 1e-3, (name, int((diff > 2e-5).sum()))
        assert not np.array_equal(got, init[name]), name
    if kind == "resnet":
        want_stats = convert_jax.resnet_state_dict_from_flax(
            batch_stats=_np(jstate.batch_stats))
        assert sorted(tstate.batch_stats) == sorted(want_stats)
        for name, buf in tstate.batch_stats.items():
            np.testing.assert_allclose(buf.numpy(), want_stats[name], atol=2e-5, rtol=0,
                                       err_msg=name)
    else:
        assert tstate.batch_stats is None and jstate.batch_stats is None


_STEP_CASES = {"vit_tiny einsum": ("vit", "einsum"), "vit_tiny flash": ("vit", "flash"),
               "resnet_tiny, batch stats": ("resnet", "einsum")}


@pytest.mark.parametrize("case", sorted(_STEP_CASES))
def test_steps_match_jax(case):
    kind, attn_impl = _STEP_CASES[case]
    (jtrainer, jstate), (ttrainer, tstate), init, hw = _trainer_pair(kind, attn_impl)
    stats0 = {k: v.clone() for k, v in (tstate.batch_stats or {}).items()}
    for i, batch in enumerate(_batches(hw)):
        jstate, jm = jtrainer.train_step(jstate, batch)
        tstate, tm = ttrainer.train_step(tstate, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), atol=1e-5,
                                   err_msg=f"loss at step {i}")
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-4, err_msg=f"grad_norm at step {i}")
    assert tstate.step == STEPS
    _assert_state_matches(tstate, jstate, kind, init)
    # the state's buffers are the module's, updated in place by the steps
    for name, buf in (tstate.batch_stats or {}).items():
        assert buf is dict(ttrainer.module.named_buffers())[name]
        assert not torch.equal(buf, stats0[name]), name


def test_train_steps_scan_with_batch_stats():
    """Two chunks of 3 steps: bitwise the per-step steps on the port, and
    within the step limits of the JAX train_steps_scan."""
    (jtrainer, jstate), (ttrainer, tstate), init, hw = _trainer_pair("resnet")
    _, (step_trainer, step_state), _, _ = _trainer_pair("resnet")
    batches = _batches(hw)
    losses, jlosses = [], []
    for c in range(2):
        chunk = {k: np.stack([b[k] for b in batches[3 * c:3 * c + 3]]) for k in batches[0]}
        tstate, m = ttrainer.train_steps_scan(tstate, chunk)
        jstate, jm = jtrainer.train_steps_scan(jstate, chunk)
        losses += m["loss"].tolist()
        jlosses += np.asarray(jm["loss"]).tolist()
    step_losses = []
    for b in batches:
        step_state, m = step_trainer.train_step(step_state, b)
        step_losses.append(m["loss"].item())
    assert losses == step_losses
    for name in tstate.params:
        assert torch.equal(tstate.params[name], step_state.params[name]), name
    for name in tstate.batch_stats:
        assert torch.equal(tstate.batch_stats[name], step_state.batch_stats[name]), name
    np.testing.assert_allclose(losses, jlosses, atol=1e-5)
    _assert_state_matches(tstate, jstate, "resnet", init)


def test_init_batch_stats_must_match_the_buffers():
    trainer = tt.Trainer(tresnet.resnet_tiny(3, dtype=torch.float32), tt.TrainerConfig(),
                         device="cpu", has_batch_stats=True)
    state = trainer.init_state(seed=0)
    assert sorted(state.batch_stats) == sorted(dict(trainer.module.named_buffers()))
    assert all(float(v.sum()) == (0.0 if k.endswith("mean") else v.numel())
               for k, v in state.batch_stats.items())
    with pytest.raises(ValueError, match="init_batch_stats"):
        trainer.init_state(init_batch_stats={"stem_bn.mean": np.zeros(8, np.float32)})


# -------------------------------------------------------------- the stages


def _resnet_rows():
    """tests/test_models.py::test_deep_vision_classifier_runs's inputs."""
    rng = np.random.default_rng(0)
    n = 32
    labels = rng.integers(0, 2, n).astype(np.int32)
    imgs = rng.normal(size=(n, 16, 16, 3)).astype(np.float32) + labels[:, None, None, None]
    return {"image": imgs, "label": labels}, dict(
        backbone="resnet_tiny", num_classes=2, batch_size=16, max_steps=20, learning_rate=5e-3)


def _vit_rows():
    """tests/test_models.py::test_deep_vision_classifier_vit_backbone's inputs."""
    rs = np.random.default_rng(0)
    imgs, labels = [], []
    for i in range(16):
        label = i % 2
        imgs.append(np.full((16, 16, 3), label, np.float32)
                    + rs.normal(0, 0.1, (16, 16, 3)).astype(np.float32))
        labels.append(label)
    return {"image": np.stack(imgs), "label": np.asarray(labels)}, dict(
        backbone="vit_tiny", num_classes=2, batch_size=8, max_steps=8, learning_rate=3e-3)


_INPUTS = {"resnet_tiny": _resnet_rows, "vit_tiny": _vit_rows}


def _patched(mp, backbone, seed=0):
    """Both packages' presets in f32, and the port's init the JAX stage's
    (``module.init(PRNGKey(seed))``, eager as its trainer calls it)."""
    jpreset = {"resnet_tiny": jvision.resnet_tiny, "vit_tiny": jvision.vit_tiny}[backbone]
    mp.setattr(jvision, backbone, functools.partial(jpreset, dtype=jnp.float32))
    tbuild = {"resnet_tiny": lambda n: (tresnet.resnet_tiny(n, dtype=torch.float32), True),
              "vit_tiny": lambda n: (tvit.ViTClassifier(tvit.vit_tiny(dtype=torch.float32),
                                                        num_classes=n, patch=8), False)}
    mp.setitem(tvision._BACKBONES, backbone, tbuild[backbone])
    module, _ = jvision._build_module(backbone, 2)
    v = _np(module.init(jax.random.PRNGKey(seed), np.zeros((1, 16, 16, 3), np.float32)))
    if backbone == "vit_tiny":
        init = (convert_jax.vit_state_dict_from_flax(v["params"]), None)
    else:
        init = (convert_jax.resnet_state_dict_from_flax(v["params"]),
                convert_jax.resnet_state_dict_from_flax(batch_stats=v["batch_stats"]))
    mp.setattr(tvision, "_init_variables", lambda module, seed: init)
    return v


@pytest.fixture(scope="module", params=sorted(_INPUTS))
def fits(request):
    """(backbone, data, JAX model, port model) fitted on the same rows."""
    backbone = request.param
    data, kw = _INPUTS[backbone]()
    with pytest.MonkeyPatch.context() as mp:
        _patched(mp, backbone)
        jmodel = jvision.DeepVisionClassifier(**kw).fit(
            JDataFrame.from_dict(data, num_partitions=2))
        tmodel = tvision.DeepVisionClassifier(device="cpu", **kw).fit(
            pt.DataFrame.from_dict(data, num_partitions=2))
    return backbone, data, kw, jmodel, tmodel


def _scores(model, df):
    out = model.transform(df)
    return (np.stack(list(out.collect_column("scores"))),
            np.asarray(out.collect_column("prediction")))


def test_fit_matches_the_jax_stage(fits):
    backbone, data, kw, jmodel, tmodel = fits
    lr, steps = kw["learning_rate"], kw["max_steps"]
    bridge = (convert_jax.vit_state_dict_from_flax if backbone == "vit_tiny"
              else convert_jax.resnet_state_dict_from_flax)
    want = bridge(_np(jmodel.get("model_params")))
    got = tmodel.get("model_params")
    assert sorted(got) == sorted(want)
    for name in got:
        diff = np.abs(got[name] - want[name])
        assert diff.max() <= lr * steps, name
        if not name.endswith("attn.k.bias"):
            assert (diff > 2e-5).mean() <= 1e-3, (name, int((diff > 2e-5).sum()))
    if backbone == "resnet_tiny":
        want_stats = convert_jax.resnet_state_dict_from_flax(
            batch_stats=_np(jmodel.get("batch_stats")))
        stats = tmodel.get("batch_stats")
        assert sorted(stats) == sorted(want_stats)
        for name in stats:
            np.testing.assert_allclose(stats[name], want_stats[name], atol=2e-5, rtol=0,
                                       err_msg=name)
    else:
        assert tmodel.get("batch_stats") is None and jmodel.get("batch_stats") is None
    rs = np.random.default_rng(5)
    x = data["image"][rs.permutation(len(data["image"]))[:13]] + 0.1
    parts = [{"image": x[:9]}, {"image": x[9:9]}, {"image": x[9:]}]  # an empty partition
    with pytest.MonkeyPatch.context() as mp:  # the models build their modules in f32
        _patched(mp, backbone)
        jscores, jpred = _scores(jmodel, JDataFrame([dict(p) for p in parts]))
        tscores, tpred = _scores(tmodel, pt.DataFrame([dict(p) for p in parts]))
    np.testing.assert_allclose(tscores, jscores, atol=1e-4)
    np.testing.assert_array_equal(tpred, jpred)
    (metrics,) = tmodel.get("train_metrics")
    assert metrics["step"] == steps and np.isfinite(metrics["loss"])


@pytest.mark.parametrize("backbone", sorted(_INPUTS))
def test_stage_reaches_the_jax_tests_accuracy(backbone, tmp_path):
    """The JAX tests' fits with the port's own (numpy) init and the presets'
    bf16 compute: train accuracy > 0.8, finite scores of the right shape,
    and a save -> load round trip bitwise."""
    data, kw = _INPUTS[backbone]()
    df = pt.DataFrame.from_dict(data, num_partitions=2)
    model = tvision.DeepVisionClassifier(device="cpu", **kw).fit(df)
    probs, pred = _scores(model, df)
    assert probs.shape == (len(data["label"]), 2) and np.all(np.isfinite(probs))
    acc = float(np.mean(pred == data["label"]))
    assert acc > 0.8, f"train accuracy {acc} too low"
    assert (model.get("batch_stats") is None) == (backbone == "vit_tiny")
    model.save(str(tmp_path / "m"))
    loaded = pt.load_stage(str(tmp_path / "m"))
    again, _ = _scores(loaded, df)
    assert np.array_equal(probs, again)
    assert loaded.get("device") == "cpu"


def test_one_callable_per_bucket_and_image_shape():
    data, kw = _resnet_rows()
    model = tvision.DeepVisionClassifier(device="cpu", **{**kw, "max_steps": 2}).fit(
        pt.DataFrame.from_dict(data, num_partitions=2))
    cache = tcb.get_compiled_cache()
    before = cache.miss_count("deep_vision_model")
    df = pt.DataFrame([{"image": data["image"][:16]}, {"image": data["image"][16:21]}])
    first = model.transform(df)
    # 16 rows fill a rung of 16 (batch_size), 5 rows pad to 8
    assert cache.miss_count("deep_vision_model") - before == 2
    again = model.transform(df)
    assert cache.miss_count("deep_vision_model") - before == 2
    for p, q in zip(first.partitions, again.partitions):
        assert np.array_equal(p["scores"], q["scores"])
    model.transform(pt.DataFrame([{"image": _x(3, 20, 20)}]))  # a new image shape
    assert cache.miss_count("deep_vision_model") - before == 3
    tok = tcb.instance_token(model)
    model.set(batch_size=4)  # not a key of the built module: the callables stay
    assert tcb.instance_token(model) == tok
    model.set(model_params=dict(model.get("model_params")))  # evicts them
    assert not any(k[1] == tok for k in cache._entries)


def test_params_match_the_jax_stages():
    for name in ("DeepVisionClassifier", "DeepVisionModel"):
        jparams = {n: p.default for n, p in getattr(jvision, name).params().items()}
        tparams = {n: p.default for n, p in getattr(tvision, name).params().items()}
        assert tparams.pop("device") == "cuda", name
        assert tparams == jparams, name


_REFUSED = {
    "checkpoint_dir": (dict(checkpoint_dir="/tmp/ck"), "item 1.3"),
    "mesh_config": (dict(mesh_config=object()), "item 9"),
}


@pytest.mark.parametrize("param", sorted(_REFUSED))
def test_unported_params_are_refused(param):
    kw, item = _REFUSED[param]
    data, _ = _resnet_rows()
    with pytest.raises(NotImplementedError, match=item):
        tvision.DeepVisionClassifier(device="cpu", max_steps=1, **kw).fit(
            pt.DataFrame.from_dict(data))


def test_local_checkpoint_directory_and_arch_spec_are_refused(tmp_path):
    data, _ = _resnet_rows()
    with pytest.raises(NotImplementedError, match="item 4"):
        tvision.DeepVisionClassifier(device="cpu", backbone=str(tmp_path)).fit(
            pt.DataFrame.from_dict(data))
    df = pt.DataFrame.from_dict({"image": data["image"][:2]})
    with pytest.raises(NotImplementedError, match="item 4"):
        tvision.DeepVisionModel(model_params={}, arch_spec=("vit", {}), device="cpu").transform(df)
    with pytest.raises(NotImplementedError, match="item 9"):
        tvision.DeepVisionModel(model_params={}, mesh_config=object(),
                                device="cpu").transform(df)
    with pytest.raises(ValueError, match="unknown backbone"):
        tvision.DeepVisionClassifier(device="cpu", backbone="vgg").fit(
            pt.DataFrame.from_dict(data))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    data, kw = _resnet_rows()
    assert tvision.DeepVisionClassifier().get("device") == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvision.DeepVisionClassifier(**kw).fit(pt.DataFrame.from_dict(data))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.Trainer(tresnet.resnet_tiny(2), tt.TrainerConfig(), has_batch_stats=True)
