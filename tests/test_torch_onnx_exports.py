"""Real torch exports of a causal decoder, a stacked recurrent net, a
modern-vision net and a UNet through synapseml_torch's ONNX converter,
against the JAX package's converter and against the torch modules.

Each export (``torch.onnx.export(dynamo=False)`` under the codec-backed
``onnx`` stand-in) goes through both converters on the CPU on the same
inputs: within 1e-5 of the JAX converter (1e-4 where a recurrence or a
transposed convolution sums in another order; TopK indices bitwise), and
within 2e-4 of the torch module (the reference tests' tolerances). The
decoder holds Trilu masks, Not/Where chains, GatherElements and the
exporter's shape guards, at two lengths; the recurrent net a bidirectional
LSTM into a GRU (``linear_before_reset``); the vision net Resize (nearest
and bilinear), InstanceNormalization (GroupNorm), HardSwish and TopK; the
UNet ConvTranspose. The references are ``tests/test_onnx_{gpt,rnn,mixed}.py``.
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
from _torch_gpt import TorchTinyGPT, export_gpt_onnx_bytes  # noqa: E402
from _torch_onnx_graphs import assert_same, jax, port  # noqa: E402
from _torch_resnet import _install_onnx_shim  # noqa: E402

from synapseml_torch.onnx.convert import _all_op_types  # noqa: E402
from synapseml_torch.onnx.proto import parse_model  # noqa: E402


def _export(model, args, input_names, output_names, **kw):
    _install_onnx_shim()
    buf = io.BytesIO()
    torch.onnx.export(model.eval(), args, buf, dynamo=False, input_names=input_names,
                      output_names=output_names, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def gpt():
    torch.manual_seed(0)
    model = TorchTinyGPT(vocab=256, d=32, layers=2, heads=2, max_len=64)
    return model, export_gpt_onnx_bytes(model, torch.randint(0, 256, (2, 12)),
                                        torch.tensor([3, 11]))


@pytest.mark.parametrize("B,T", [(2, 12), (3, 20)])
def test_decoder_export_matches_jax_and_torch(gpt, B, T):
    model, data = gpt
    assert {"Trilu", "GatherElements", "Not", "Where"} <= _all_op_types(parse_model(data).graph)
    gen = torch.Generator().manual_seed(B * 31 + T)
    ids = torch.randint(0, 256, (B, T), generator=gen)
    gi = torch.arange(B) % T
    feeds = {"ids": ids.numpy(), "gather_idx": gi.numpy()}
    ours = port(data, feeds)
    assert_same(ours, jax(data, feeds), 1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(ours["logits"], model(ids, gi).numpy(), rtol=2e-4, atol=2e-5)


def test_causality_holds_through_conversion(gpt):
    """A future token does not change the logits gathered at an earlier
    position: the Trilu/Where mask chain masks."""
    _, data = gpt
    ids = torch.randint(0, 256, (1, 12), generator=torch.Generator().manual_seed(5)).numpy()
    feeds = {"ids": ids, "gather_idx": np.array([4])}
    base = port(data, feeds)["logits"]
    ids2 = ids.copy()
    ids2[0, 9] = (ids2[0, 9] + 7) % 256
    np.testing.assert_array_equal(port(data, {"ids": ids2, "gather_idx": np.array([4])})["logits"],
                                  base)


class _RecNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(8, 16, num_layers=1, bidirectional=True)
        self.gru = nn.GRU(32, 12)
        self.head = nn.Linear(12, 4)

    def forward(self, x):
        h, _ = self.lstm(x)
        g, _ = self.gru(h)
        return self.head(g[-1])


def test_stacked_bilstm_gru_export_matches_jax_and_torch():
    torch.manual_seed(0)
    model = _RecNet()
    data = _export(model, (torch.randn(10, 3, 8),), ["x"], ["y"])
    assert {"LSTM", "GRU"} <= _all_op_types(parse_model(data).graph)
    x = torch.randn(10, 3, 8, generator=torch.Generator().manual_seed(1))
    ours = port(data, {"x": x.numpy()})
    assert_same(ours, jax(data, {"x": x.numpy()}), 1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(ours["y"], model(x).numpy(), rtol=2e-4, atol=2e-5)


class _BareLSTM(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(5, 7)

    def forward(self, x, h0, c0):
        y, (h, c) = self.lstm(x, (h0, c0))
        return y, h, c


def test_lstm_every_output_and_initial_state_match_jax_and_torch():
    torch.manual_seed(2)
    m = _BareLSTM()
    x, h0, c0 = torch.randn(6, 2, 5), torch.randn(1, 2, 7), torch.randn(1, 2, 7)
    data = _export(m, (x, h0, c0), ["x", "h0", "c0"], ["y", "h", "c"])
    feeds = {"x": x.numpy(), "h0": h0.numpy(), "c0": c0.numpy()}
    ours = port(data, feeds)
    assert_same(ours, jax(data, feeds), 1e-5)
    with torch.no_grad():
        wy, (wh, wc) = m.lstm(x, (h0, c0))
    for k, want in (("y", wy), ("h", wh), ("c", wc)):
        np.testing.assert_allclose(ours[k], want.numpy(), rtol=2e-4, atol=2e-5)


class _MixedNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.gn = nn.GroupNorm(2, 8)
        self.act = nn.Hardswish()
        self.head = nn.Linear(8, 16)

    def forward(self, x):
        h = self.act(self.gn(self.conv(x)))
        h = F.interpolate(h, scale_factor=2.0, mode="nearest")
        h = F.interpolate(h, size=(8, 8), mode="bilinear", align_corners=False)
        pooled = h.mean(dim=(2, 3))
        freq = torch.arange(4, device=x.device, dtype=torch.float32)
        enc = torch.cat([torch.sin(pooled[:, :4] * freq), torch.cos(pooled[:, :4] * freq)], -1)
        return torch.topk(self.head(enc), k=3, dim=-1)


def test_mixed_vision_export_matches_jax_and_torch():
    torch.manual_seed(0)
    model = _MixedNet()
    data = _export(model, (torch.randn(2, 3, 4, 4),), ["x"], ["vals", "idx"],
                   dynamic_axes={"x": {0: "N"}})
    ops = _all_op_types(parse_model(data).graph)
    assert {"Resize", "InstanceNormalization", "HardSwish", "TopK"} <= ops
    for B in (2, 5):
        x = torch.randn(B, 3, 4, 4, generator=torch.Generator().manual_seed(B))
        ours = port(data, {"x": x.numpy()})
        assert_same(ours, jax(data, {"x": x.numpy()}), 1e-5)
        with torch.no_grad():
            vals, idx = model(x)
        np.testing.assert_allclose(ours["vals"], vals.numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(ours["idx"], idx.numpy())


class _MiniUNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.down = nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.mid = nn.Conv2d(8, 8, 3, padding=1)
        self.up = nn.ConvTranspose2d(8, 4, 3, stride=2, padding=1, output_padding=1)
        self.out = nn.Conv2d(7, 2, 1)  # 4 up + 3 skip channels

    def forward(self, x):
        m = torch.relu(self.mid(torch.relu(self.down(x))))
        return self.out(torch.cat([torch.relu(self.up(m)), x], dim=1))


def test_unet_export_matches_jax_and_torch():
    torch.manual_seed(0)
    model = _MiniUNet()
    x = np.random.default_rng(12).normal(size=(1, 3, 16, 16)).astype(np.float32)
    data = _export(model, (torch.from_numpy(x),), ["x"], ["y"])
    assert "ConvTranspose" in _all_op_types(parse_model(data).graph)
    ours = port(data, {"x": x})
    assert_same(ours, jax(data, {"x": x}), 1e-4)
    with torch.no_grad():
        np.testing.assert_allclose(ours["y"], model(torch.from_numpy(x)).numpy(), rtol=1e-4,
                                   atol=1e-4)
