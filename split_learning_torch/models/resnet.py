"""ResNet-50 as 21 indexed layers.

Port of the JAX package's ``models/resnet.py`` (BASELINE config 3): 1 =
stem conv (3x3, stride 1, no bias), 2 = stem BatchNorm, 3 = ReLU,
4 .. 19 = the 16 bottleneck blocks (3-4-6-3, stride 2 at the entry of
stages 2-4), 20 = global average pool + flatten, 21 = the linear head.
Each bottleneck is ONE layer, so every index is a cut with one
streaming activation; its BatchNorms (``bn1``-``bn3``, ``proj_bn``)
keep their running statistics under the layer, keyed by their path
(``{"layer4": {"bn1.mean": ...}}``), as flax's ``batch_stats/layer4/
bn1`` is.  Activations are NHWC at every layer boundary; the convs run
on its ``channels_last`` view.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from split_learning_torch.models.split import (
    BatchNorm, Conv, Dense, LayerSpec, batchnorm_fn, conv_fn,
    module_plain_fn, module_train_fn, register_model, relu_fn,
)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride ``strides``, padding 1) -> 1x1 expand to
    ``4 * features``, each followed by a BatchNorm (momentum 0.9, epsilon
    1e-5), with a 1x1 projection shortcut (stride ``strides``, flax's
    ``SAME``: no padding for a 1x1 kernel) when the shape changes."""

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        out_ch = 4 * features
        conv = functools.partial(Conv, use_bias=False, dtype=dtype,
                                 device=device, generator=generator)
        bn = functools.partial(BatchNorm, dtype=dtype, device=device)
        self.conv1 = conv(in_channels, features, 1, padding=0)
        self.bn1 = bn(features)
        self.conv2 = conv(features, features, 3, stride=strides, padding=1)
        self.bn2 = bn(features)
        self.conv3 = conv(features, out_ch, 1, padding=0)
        self.bn3 = bn(out_ch)
        if in_channels != out_ch or strides != 1:
            self.proj = conv(in_channels, out_ch, 1, stride=strides,
                             padding=0)
            self.proj_bn = bn(out_ch)
        else:
            self.proj = self.proj_bn = None

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = torch.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = x
        if self.proj is not None:
            residual = self.proj_bn(self.proj(x), train)
        return torch.relu(y + residual)


def avgpool_flatten_fn(_, x, train):
    """``jnp.mean`` over H and W: summed and divided in at least float32,
    rounded once to the input's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc).mean(dim=(1, 2)).to(x.dtype)


def _resnet50_specs(num_classes: int, dtype=torch.float32) -> tuple:
    specs = [
        LayerSpec("layer1", make=functools.partial(
            Conv, 3, 64, 3, padding=1, use_bias=False, dtype=dtype),
            fn=conv_fn),
        LayerSpec("layer2", make=functools.partial(BatchNorm, 64,
                                                   dtype=dtype),
                  fn=batchnorm_fn),
        LayerSpec("layer3", fn=relu_fn),
    ]
    ch = 64
    for features, n_blocks, first_stride in (
            (64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
        for i in range(n_blocks):
            specs.append(LayerSpec(
                f"layer{len(specs) + 1}", make=functools.partial(
                    Bottleneck, ch, features,
                    first_stride if i == 0 else 1, dtype=dtype),
                fn=module_train_fn))
            ch = 4 * features
    specs.append(LayerSpec(f"layer{len(specs) + 1}", fn=avgpool_flatten_fn))
    specs.append(LayerSpec(f"layer{len(specs) + 1}", make=functools.partial(
        Dense, ch, num_classes, dtype=dtype), fn=module_plain_fn))
    assert len(specs) == 21
    return tuple(specs)


@register_model("ResNet50_CIFAR100")
def resnet50_cifar100(dtype=torch.float32) -> tuple:
    """(B, 32, 32, 3) NHWC -> 100 classes, 21 layers."""
    return _resnet50_specs(100, dtype=dtype)


@register_model("ResNet50_CIFAR10")
def resnet50_cifar10(dtype=torch.float32) -> tuple:
    return _resnet50_specs(10, dtype=dtype)
