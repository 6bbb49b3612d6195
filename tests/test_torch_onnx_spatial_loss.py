"""synapseml_torch's ONNX vision, spatial-sampling, normalization, loss and
signal ops against the JAX package's converter, and against torch.

One-node models written with the port's codec run through both converters
on the CPU on the same numpy inputs (f32 within 1e-5, 1e-4 where a
convolution, an FFT or a sampling grid sums in another order; exact
gathers bitwise); real torch exports (GridSample, cross-entropy) are held
to the JAX converter and to the torch module. ``ConvTranspose`` with
``output_shape`` or ``auto_pad``, which the reference refuses, is held to
``F.conv_transpose2d`` by the ONNX spec's padding rule. The references are
``synapseml_tpu/onnx/convert.py`` :274-316, :409-490, :1503-1712,
:1733-1754, :1755-1998.
"""

import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401  (before the exporters' spec-less onnx stand-in)
import torch.nn.functional as F
from torch import nn

sys.path.insert(0, str(Path(__file__).parent))
from _torch_onnx_graphs import (I64, assert_same, case, f32, jax, model_bytes,  # noqa: E402
                                port, run_case)
from _torch_resnet import _install_onnx_shim  # noqa: E402

RS = np.random.default_rng(0)
IMG = f32(2, 3, 5, 7, seed=1)
GRID = (RS.uniform(size=(2, 4, 6, 2)) * 2.6 - 1.3).astype(np.float32)  # spills past [-1, 1]
ROIS = np.array([[1.0, 1.0, 8.0, 7.0], [0.0, 2.0, 11.0, 9.0], [3.0, 0.5, 6.0, 4.0],
                 [0.0, 0.0, 3.0, 2.0], [2.0, 2.0, 2.4, 2.4]], np.float32)
SIG = f32(2, 16, 1, seed=2)


def _conv_t(cin, cout, k, stride, pad, out_pad, groups, dil, seed=11, rank=2):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(2, cin) + (7,) * rank).astype(np.float32)
    w = rs.normal(size=(cin, cout // groups) + (k,) * rank).astype(np.float32)
    b = rs.normal(size=(cout,)).astype(np.float32)
    attrs = dict(strides=[stride] * rank, pads=[pad] * (2 * rank),
                 output_padding=[out_pad] * rank, group=groups, dilations=[dil] * rank)
    return case("ConvTranspose", [x, w, b], attrs, init=(1, 2), tol=1e-4,
                id=f"conv-transpose-{rank}d-k{k}s{stride}p{pad}op{out_pad}g{groups}d{dil}")


VISION_CASES = [
    _conv_t(4, 6, 3, 2, 1, 1, 1, 1),
    _conv_t(4, 4, 2, 2, 0, 0, 1, 1),
    _conv_t(4, 8, 3, 1, 1, 0, 2, 1),
    _conv_t(3, 3, 3, 2, 2, 1, 1, 2),
    _conv_t(3, 4, 3, 2, 1, 1, 1, 1, rank=1),
    case("ConvTranspose", [f32(1, 2, 5, 6), f32(2, 3, 3, 2, seed=1)],
         dict(strides=[2, 1], pads=[0, 1, 2, 0]), init=(1,), tol=1e-4,
         id="conv-transpose-asymmetric-pads"),
    case("InstanceNormalization", [f32(2, 4, 5, 6), f32(4, seed=1), f32(4, seed=2)],
         dict(epsilon=1e-3), init=(1, 2)),
    case("GroupNormalization", [f32(2, 6, 4, 4), f32(6, seed=1), f32(6, seed=2)],
         dict(num_groups=3), init=(1, 2), id="group-norm-per-channel"),
    case("GroupNormalization", [f32(2, 6, 4, 4), f32(3, seed=1), f32(3, seed=2)],
         dict(num_groups=3, epsilon=1e-3), init=(1, 2), id="group-norm-per-group"),
    case("MeanVarianceNormalization", [f32(2, 3, 4, 5, scale=2.0) + 3.0]),
    case("MeanVarianceNormalization", [f32(2, 3, 4, 5)], dict(axes=[2, 3]),
         id="mvn-axes"),
    *(case("GridSample", [IMG, GRID], dict(mode=m, padding_mode=p, align_corners=a), tol=1e-4,
           id=f"grid-sample-{m}-{p}-align{a}")
      for m in ("bilinear", "nearest") for p in ("zeros", "border", "reflection") for a in (0, 1)),
    case("GridSample", [np.arange(5, dtype=np.float32).reshape(1, 1, 1, 5),
                        np.stack(np.meshgrid(np.linspace(-1.2, 1.2, 4), [0.3]), -1)[None]
                        .astype(np.float32)],
         dict(mode="bilinear", padding_mode="reflection", align_corners=1),
         id="grid-sample-size-one-reflection"),
    *(case("AffineGrid", [f32(2, 2, 3, seed=3), np.array([2, 3, 5, 7], I64)],
           dict(align_corners=a), init=(1,), id=f"affine-grid-2d-align{a}") for a in (0, 1)),
    *(case("AffineGrid", [f32(1, 3, 4, seed=4), np.array([1, 2, 3, 4, 5], I64)],
           dict(align_corners=a), init=(1,), id=f"affine-grid-3d-align{a}") for a in (0, 1)),
    *(case("RoiAlign", [f32(2, 3, 10, 12), ROIS, np.array([0, 1, 0, 1, 0], I64)],
           dict(output_height=4, output_width=3, sampling_ratio=2, spatial_scale=1.0, mode=m,
                coordinate_transformation_mode=c), tol=1e-4, id=f"roi-align-{m}-{c}")
      for m in ("avg", "max") for c in ("half_pixel", "output_half_pixel")),
    case("RoiAlign", [f32(1, 2, 8, 8), ROIS[:2] * 2, np.array([0, 0], I64)],
         dict(output_height=2, output_width=2, spatial_scale=0.5), init=(2,), tol=1e-4,
         id="roi-align-adaptive-ratio-scale"),
    case("CenterCropPad", [f32(3, 8, 5), np.array([4, 9], I64)], dict(axes=[1, 2]), init=(1,),
         tol=0),
    case("CenterCropPad", [f32(3, 8, 5), np.array([3, 3, 3], I64)], init=(1,), tol=0,
         id="center-crop-pad-all-axes"),
]


def _resize_case(x, scales, sizes, attrs, id):
    inputs = [x, np.zeros(0, np.float32), scales, sizes]
    return case("Resize", inputs, attrs, init=(1, 2, 3), tol=1e-5, id=id)


XR = np.arange(2 * 3 * 5 * 7, dtype=np.float32).reshape(2, 3, 5, 7) / 10
RESIZE_CASES = [
    *(_resize_case(XR, np.array([1, 1, 2, 1.5], np.float32), None,
                   dict(mode="nearest", coordinate_transformation_mode=c, nearest_mode=n),
                   f"resize-nearest-{c}-{n}")
      for c in ("asymmetric", "half_pixel", "align_corners")
      for n in ("floor", "ceil", "round_prefer_floor", "round_prefer_ceil")),
    *(_resize_case(XR, None, np.array([2, 3, 9, 13], I64),
                   dict(mode="linear", coordinate_transformation_mode=c), f"resize-linear-{c}")
      for c in ("pytorch_half_pixel", "half_pixel", "align_corners", "asymmetric")),
    _resize_case(XR, np.array([1, 1, 0.5, 0.6], np.float32), None,
                 dict(mode="linear"), "resize-linear-downscale"),
    _resize_case(XR, None, np.array([2, 3, 1, 13], I64),
                 dict(mode="linear", coordinate_transformation_mode="pytorch_half_pixel"),
                 "resize-pytorch-half-pixel-length-1"),
    case("Resize", [XR, np.array([1, 1, 2, 2], np.float32)], dict(mode="nearest"), init=(1,),
         tol=0, id="resize-opset10-form"),
]


@pytest.mark.parametrize("op,inputs,attrs,init,n_out,tol", VISION_CASES + RESIZE_CASES)
def test_vision_op_matches_jax(op, inputs, attrs, init, n_out, tol):
    run_case(op, inputs, attrs, init, n_out, tol)


LABELS = np.array([0, 1, 2, 3, 4, 0, 3, 2], I64)
LOGP = np.log(np.random.default_rng(3).dirichlet(np.ones(5), size=8)).astype(np.float32)
LOSS_CASES = [
    *(case("NegativeLogLikelihoodLoss", [LOGP, LABELS], dict(reduction=r), tol=1e-5,
           id=f"nll-{r}") for r in ("mean", "sum", "none")),
    case("NegativeLogLikelihoodLoss", [LOGP, LABELS, np.abs(f32(5, seed=4)) + 0.5],
         dict(reduction="mean", ignore_index=3), init=(2,), id="nll-weighted-ignore"),
    case("NegativeLogLikelihoodLoss",
         [f32(2, 4, 3, seed=5), np.array([[0, 3, 1], [2, 2, -1]], I64)],
         dict(reduction="mean", ignore_index=-1), id="nll-spatial"),
    *(case("SoftmaxCrossEntropyLoss",
           [f32(8, 5, seed=6), LABELS] + ([np.abs(f32(5)) + 0.5] if w else []),
           dict(reduction=r, ignore_index=3), n_out=2, id=f"softmax-ce-{r}-weighted{w}")
      for r in ("mean", "sum", "none") for w in (0, 1)),
    case("DFT", [SIG], dict(axis=1), tol=1e-4, id="dft"),
    case("DFT", [SIG], dict(axis=-2, onesided=1), tol=1e-4, id="dft-onesided-negative-axis"),
    case("DFT", [f32(2, 16, 2, seed=7)], dict(axis=1, inverse=1), tol=1e-4, id="dft-inverse"),
    case("DFT", [SIG, np.array(32, I64)], dict(axis=1), init=(1,), tol=1e-4, id="dft-pad"),
    case("DFT", [f32(3, 12, 2, seed=8), np.array(8, I64)], dict(axis=1), init=(1,), tol=1e-4,
         id="dft-truncate-complex"),
    case("STFT", [f32(2, 64, seed=9), np.array(4, I64),
                  np.hanning(16).astype(np.float32)], dict(onesided=1), init=(1, 2),
         tol=1e-4, id="stft"),
    case("STFT", [f32(2, 64, 1, seed=9), np.array(4, I64), None, np.array(16, I64)],
         dict(onesided=1), init=(1, 3), tol=1e-4, id="stft-3d-frame-length"),
    case("STFT", [f32(1, 32, 2, seed=10), np.array(4, I64), np.hanning(8).astype(np.float32)],
         dict(onesided=0), init=(1, 2), tol=1e-4, id="stft-complex"),
    case("Col2Im", [f32(2, 27, 20, seed=11), np.array([8, 10], I64), np.array([3, 3], I64)],
         dict(strides=[2, 2], pads=[1, 1, 1, 1]), init=(1, 2), id="col2im"),
    case("Col2Im", [f32(2, 24, 30, seed=12), np.array([8, 10], I64), np.array([2, 4], I64)],
         dict(strides=[1, 2], dilations=[2, 1], pads=[0, 1, 0, 1]), init=(1, 2),
         id="col2im-dilated"),
]


@pytest.mark.parametrize("op,inputs,attrs,init,n_out,tol", LOSS_CASES)
def test_loss_and_signal_op_matches_jax(op, inputs, attrs, init, n_out, tol):
    run_case(op, inputs, attrs, init, n_out, tol)


def test_signal_refusals_match_the_reference():
    cases = [("DFT", [SIG], dict(axis=2), "component"),
             ("DFT", [np.concatenate([SIG, SIG], -1)], dict(axis=1, onesided=1), "onesided"),
             ("DFT", [SIG], dict(axis=1, inverse=1, onesided=1), "exclusive"),
             ("STFT", [f32(1, 32, 2), np.array(4, I64), np.hanning(8).astype(np.float32)],
              dict(onesided=1), "onesided")]
    for op, inputs, attrs, msg in cases:
        data, feeds = model_bytes(op, inputs, attrs, init=(1, 2) if op == "STFT" else ())
        with pytest.raises(NotImplementedError, match=msg):
            port(data, feeds)


@pytest.mark.parametrize("attrs,torch_out", [
    (dict(output_shape=[14, 14]), lambda x, w: F.conv_transpose2d(x, w, stride=2, padding=1,
                                                                  output_padding=1)),
    (dict(output_shape=[1, 4, 13, 13]), lambda x, w: F.conv_transpose2d(x, w, stride=2,
                                                                        padding=1)),
    (dict(auto_pad="SAME_UPPER"), lambda x, w: F.conv_transpose2d(x, w, stride=2)[..., :14, :14]),
    (dict(auto_pad="SAME_LOWER"), lambda x, w: F.conv_transpose2d(x, w, stride=2)[..., 1:, 1:]),
    (dict(auto_pad="VALID"), lambda x, w: F.conv_transpose2d(x, w, stride=2)),
])
def test_conv_transpose_output_shape_and_auto_pad_by_the_spec(attrs, torch_out):
    """The reference refuses ``output_shape`` and ``auto_pad``; the port
    takes the ONNX spec's pads (total = full + output_padding - target,
    the odd element at the end for SAME_UPPER and NOTSET's output_shape
    ... at the start), held to torch's transposed convolution."""
    x, w = f32(1, 3, 7, 7), f32(3, 4, 3, 3, seed=1)
    data, feeds = model_bytes("ConvTranspose", [x, w], dict(strides=[2, 2], **attrs), init=(1,))
    want = torch_out(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    got = port(data, feeds)["out0"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _export(model, args, names, out="y", **kw):
    _install_onnx_shim()
    buf = io.BytesIO()
    torch.onnx.export(model.eval(), args, buf, dynamo=False, input_names=names,
                      output_names=[out], **kw)
    return buf.getvalue()


class _Sampler(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.kw = kw

    def forward(self, x, grid):
        return F.grid_sample(x, grid, **self.kw)


@pytest.mark.parametrize("mode,padding_mode,align_corners", [
    ("bilinear", "zeros", False), ("bilinear", "reflection", True), ("nearest", "border", False)])
def test_grid_sample_export_matches_jax_and_torch(mode, padding_mode, align_corners):
    model = _Sampler(mode=mode, padding_mode=padding_mode, align_corners=align_corners)
    x, grid = torch.from_numpy(IMG), torch.from_numpy(GRID)
    data = _export(model, (x, grid), ["x", "grid"], opset_version=16)
    feeds = {"x": IMG, "grid": GRID}
    ours = port(data, feeds)
    assert_same(ours, jax(data, feeds), 1e-4)
    np.testing.assert_allclose(ours["y"], model(x, grid).numpy(), rtol=1e-4, atol=1e-5)


class _CELoss(nn.Module):
    def __init__(self, weight, reduction):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, scores, labels):
        return F.cross_entropy(scores, labels, weight=self.weight, ignore_index=3,
                               reduction=self.reduction)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_export_matches_jax_and_torch(reduction, weighted):
    torch.manual_seed(1)
    weight = torch.rand(5) + 0.5 if weighted else None
    model = _CELoss(weight, reduction)
    scores, labels = torch.randn(8, 5), torch.from_numpy(LABELS)
    data = _export(model, (scores, labels), ["scores", "labels"], out="loss")
    feeds = {"scores": scores.numpy(), "labels": LABELS}
    ours = port(data, feeds)
    assert_same(ours, jax(data, feeds), 1e-5)
    np.testing.assert_allclose(ours["loss"], model(scores, labels).numpy(), rtol=1e-5,
                               atol=1e-6)
