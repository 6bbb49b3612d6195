"""ResNet: the convolutional backbone of DeepVisionClassifier.

Counterpart of ``synapseml_tpu/models/flax_nets/resnet.py`` (``:18-101``):
the same blocks, stage layouts and parameter names, [B, H, W, C] images at
the module's face. Inside, the NHWC input is viewed as NCHW in the
channels-last memory format (a permute, no copy), which cuDNN's
convolutions take as they are.

Convolutions and the residual adds run in ``dtype`` (bf16 by default),
parameters in float32. :class:`BatchNorm` is Flax's ``nn.BatchNorm``, not
``nn.BatchNorm2d``:

  * the batch statistics in float32 whatever the compute dtype, the
    variance as ``E[x^2] - E[x]^2`` clipped at 0, **biased**;
  * the running statistics updated as ``0.9 * running + 0.1 * batch``, the
    running variance with the biased batch variance too;
  * ``eps = 1e-5``; the output in the compute dtype.

Training or evaluation is the ``train`` keyword of ``forward``, as the JAX
module's, never ``module.train()``: the trainer keeps every module in
``eval()`` mode.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "Bottleneck", "BasicBlock", "ResNet", "resnet50", "resnet18",
           "resnet_tiny"]


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum, epsilon, dtype)`` over dim 1 of an
    NCHW tensor: ``weight``/``bias`` are Flax's ``scale``/``bias``, the
    buffers ``mean``/``var`` its ``batch_stats``."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
        self.reset_running_stats()

    def reset_running_stats(self) -> None:
        with torch.no_grad():
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            mean2 = (x32 * x32).mean(dim=(0, 2, 3))
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            with torch.no_grad():  # in place: a captured step updates them every replay
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x.float() - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(self.dtype)


class _Conv(nn.Conv2d):
    """Flax's ``nn.Conv(use_bias=False, dtype)`` with ``k // 2`` padding:
    input and kernel cast to ``dtype``."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, dtype: torch.dtype):
        super().__init__(c_in, c_out, k, stride=stride, padding=k // 2, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None, self.stride,
                        self.padding)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = features * 4
        self.conv1, self.bn1 = _Conv(c_in, features, 1, 1, dtype), BatchNorm(features, dtype=dtype)
        self.conv2 = _Conv(features, features, 3, strides, dtype)
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.conv3, self.bn3 = _Conv(features, out, 1, 1, dtype), BatchNorm(out, dtype=dtype)
        if c_in != out or strides != 1:  # the residual's shape differs from the output's
            self.proj, self.bn_proj = _Conv(c_in, out, 1, strides, dtype), BatchNorm(out, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = self.bn_proj(self.proj(x), train) if hasattr(self, "proj") else x
        return F.relu(y + residual)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = _Conv(c_in, features, 3, strides, dtype)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2, self.bn2 = _Conv(features, features, 3, 1, dtype), BatchNorm(features, dtype=dtype)
        if c_in != features or strides != 1:
            self.proj = _Conv(c_in, features, 1, strides, dtype)
            self.bn_proj = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = self.bn_proj(self.proj(x), train) if hasattr(self, "proj") else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """[B, H, W, C] images -> float32 logits [B, num_classes]; with
    ``features_only`` the pooled float32 features (the headless featurizer
    path)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), block: str = "bottleneck",
                 num_classes: int = 1000, width: int = 64, stem_stride: int = 2,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3):
        super().__init__()
        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.stage_sizes, self.block, self.width = tuple(stage_sizes), block, width
        self.stem_stride, self.dtype = stem_stride, dtype
        self.stem = _Conv(in_channels, width, 7, stem_stride, dtype)
        self.stem_bn = BatchNorm(width, dtype=dtype)
        blocks, c = {}, width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if j == 0 and i > 0 else 1
                blocks[f"stage{i}_block{j}"] = block_cls(c, width * 2 ** i, strides, dtype)
                c = width * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleDict(blocks)
        self.head = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                features_only: bool = False) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW, channels-last in memory
        x = F.relu(self.stem_bn(self.stem(x), train))
        if self.stem_stride > 1:  # padded with -inf, as Flax's max_pool
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for block in self.blocks.values():
            x = block(x, train)
        # global average pool: accumulated in float32, returned in the compute dtype
        x = x.float().mean(dim=(2, 3)).to(self.dtype).float()
        if features_only:
            return x
        return F.linear(x, self.head.weight.float(), self.head.bias.float())


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block="bottleneck", num_classes=num_classes, **kw)


def resnet18(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block="basic", num_classes=num_classes, **kw)


def resnet_tiny(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(stage_sizes=(1, 1), block="basic", num_classes=num_classes, width=8,
                  stem_stride=1, **kw)
