"""VGG16 (+BatchNorm) as 52 individually indexed layers.

Port of the JAX package's ``models/vgg.py``: conv, BatchNorm, ReLU,
pool, flatten, dropout and dense layers each occupy one index (52 for
CIFAR, 51 for MNIST), built from the same spec list.  Activations are
NHWC at every layer boundary, as in the JAX package, so the cut-7
activation ``(B, 16, 16, 64)`` and its wire frames match it element for
element and the flatten before the first dense layer needs no
permutation.

Mixed precision as in flax: parameters are float32 and conv and dense
layers compute in ``dtype`` (inputs and weights cast to it, the product
rounded to ``dtype`` before the bias is added in ``dtype``); BatchNorm
computes in float32 and casts to ``dtype``
(:class:`~split_learning_torch.models.split.BatchNorm`).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from split_learning_torch.models.split import (
    BatchNorm, Dense, LayerSpec, batchnorm_fn, conv_fn, dropout_layer,
    flatten_fn, lecun_normal_, maxpool2_fn, module_plain_fn, register_model,
    relu_fn,
)

# (out_channels, convs per block, pool after block?) — CIFAR: 5 pools
# (52 layers, 32px -> 1px); MNIST: 4 pools (51 layers, 28px -> 1px)
_VGG16_CIFAR_CFG = [(64, 2, True), (128, 2, True), (256, 3, True),
                    (512, 3, True), (512, 3, True)]
_VGG16_MNIST_CFG = [(64, 2, True), (128, 2, True), (256, 3, True),
                    (512, 3, True), (512, 3, False)]


class Conv(nn.Module):
    """``nn.Conv(kernel_size=(3, 3), padding=1)`` on NHWC inputs: weight
    (out, in, 3, 3) (flax's HWIO kernel transposed), lecun-normal
    (truncated) init, zero bias."""
    jax_param = "kernel"

    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, 3, 3, device=device))
        lecun_normal_(self.weight, in_channels * 9, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x):
        # the NCHW view of an NHWC tensor is channels_last: no copy
        y = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype),
                     self.weight.to(self.dtype), padding=1)
        return y.permute(0, 2, 3, 1).contiguous() + self.bias.to(self.dtype)


def _vgg_specs(num_classes: int, cfg=None, in_channels: int = 3,
               dtype=torch.float32) -> tuple:
    cfg = cfg or _VGG16_CIFAR_CFG
    specs: list[LayerSpec] = []

    def add(make=None, fn=None):
        specs.append(LayerSpec(f"layer{len(specs) + 1}", make=make, fn=fn))

    ch = in_channels
    for out_ch, n_convs, pool in cfg:
        for _ in range(n_convs):
            add(make=functools.partial(Conv, ch, out_ch, dtype=dtype),
                fn=conv_fn)
            add(make=functools.partial(BatchNorm, out_ch, dtype=dtype),
                fn=batchnorm_fn)
            add(fn=relu_fn)
            ch = out_ch
        if pool:
            add(fn=maxpool2_fn)

    add(fn=flatten_fn)
    add(*dropout_layer(0.5))
    add(make=functools.partial(Dense, ch, 4096, dtype=dtype),
        fn=module_plain_fn)
    add(fn=relu_fn)
    add(*dropout_layer(0.5))
    add(make=functools.partial(Dense, 4096, 4096, dtype=dtype),
        fn=module_plain_fn)
    add(fn=relu_fn)
    add(make=functools.partial(Dense, 4096, num_classes, dtype=dtype),
        fn=module_plain_fn)
    return tuple(specs)


@register_model("VGG16_CIFAR10")
def vgg16_cifar10(dtype=torch.float32) -> tuple:
    """CIFAR-10 VGG16: input (B, 32, 32, 3) NHWC, 10 classes, 52 layers."""
    specs = _vgg_specs(10, dtype=dtype)
    assert len(specs) == 52
    return specs


@register_model("VGG16_MNIST")
def vgg16_mnist(dtype=torch.float32) -> tuple:
    """MNIST VGG16: input (B, 28, 28, 1) NHWC, 10 classes, 51 layers
    (4 pools; 28 -> 14 -> 7 -> 3 -> 1)."""
    specs = _vgg_specs(10, cfg=_VGG16_MNIST_CFG, in_channels=1, dtype=dtype)
    assert len(specs) == 51
    return specs


@register_model("VGG16_CIFAR100")
def vgg16_cifar100(dtype=torch.float32) -> tuple:
    return _vgg_specs(100, dtype=dtype)
