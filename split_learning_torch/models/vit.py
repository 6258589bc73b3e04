"""ViT as indexed layers.

Port of the JAX package's ``models/vit.py``: 1 = patch conv (patch x
patch, stride patch, VALID, with bias), 2 = patch flatten, 3 = CLS-token
concat (a learned parameter layer), 4 = learned position embedding,
5 .. 4 + n_block = pre-LN encoder blocks
(:class:`~split_learning_torch.models.transformer.PreLNBlock`), then a
LayerNorm over the CLS token and the linear head.  Activations are NHWC
into the patch conv and (B, tokens, embed) after it.

``ViT_S16_CIFAR10`` is BASELINE config 4: ViT-S geometry (384 wide, 6
heads, MLP 1536, 12 blocks, patch 4 on 32x32 images, dropout 0.1), 18
layers.  The CLS token and the position embedding start from a standard
normal, as flax's ``normal(1.0)`` draws them.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from split_learning_torch.models.split import (
    Conv, Dense, LayerNorm, LayerSpec, module_plain_fn, module_train_fn,
    register_model,
)
from split_learning_torch.models.transformer import PreLNBlock


class PatchFlatten(nn.Module):
    """(B, H', W', C) -> (B, H'*W', C) token sequence."""

    def __init__(self, device=None, generator=None):
        super().__init__()

    def forward(self, x):
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)


class ClsToken(nn.Module):
    """Prepend a learned CLS token (parameter ``cls``, (1, 1, embed))."""

    def __init__(self, embed_dim: int, device=None, generator=None):
        super().__init__()
        self.cls = nn.Parameter(torch.randn(
            1, 1, embed_dim, generator=generator, device=device))

    def forward(self, x):
        cls = self.cls.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1)


class PosEmbed(nn.Module):
    """Learned position embedding (parameter ``pos``, (1, tokens,
    embed)), added in the input's dtype."""

    def __init__(self, n_tokens: int, embed_dim: int, device=None,
                 generator=None):
        super().__init__()
        self.pos = nn.Parameter(torch.randn(
            1, n_tokens, embed_dim, generator=generator, device=device))

    def forward(self, x):
        return x + self.pos.to(x.dtype)


class ClsNorm(nn.Module):
    """LayerNorm (flax's default dtype: float32 out of a bf16 input) of
    the CLS token only."""

    def __init__(self, embed_dim: int, device=None, generator=None):
        super().__init__()
        self.norm = LayerNorm(embed_dim, device=device, generator=generator)

    def forward(self, x):
        return self.norm(x[:, 0])


def _vit_specs(img_size: int, num_classes: int, in_channels: int = 3,
               patch_size: int = 4, embed_dim: int = 128,
               num_heads: int = 4, mlp_dim: int = 256, n_block: int = 6,
               dropout_rate: float = 0.0, dtype=torch.float32) -> tuple:
    n_tokens = (img_size // patch_size) ** 2 + 1
    specs = [
        LayerSpec("layer1", make=functools.partial(
            Conv, in_channels, embed_dim, kernel_size=patch_size,
            stride=patch_size, padding=0, dtype=dtype), fn=module_plain_fn),
        LayerSpec("layer2", make=PatchFlatten, fn=module_plain_fn),
        LayerSpec("layer3", make=functools.partial(ClsToken, embed_dim),
                  fn=module_plain_fn),
        LayerSpec("layer4", make=functools.partial(PosEmbed, n_tokens,
                                                   embed_dim),
                  fn=module_plain_fn),
    ]
    for i in range(n_block):
        specs.append(LayerSpec(f"layer{5 + i}", make=functools.partial(
            PreLNBlock, embed_dim, num_heads, mlp_dim,
            dropout_rate=dropout_rate, dtype=dtype), fn=module_train_fn))
    specs.append(LayerSpec(f"layer{5 + n_block}",
                           make=functools.partial(ClsNorm, embed_dim),
                           fn=module_plain_fn))
    specs.append(LayerSpec(f"layer{6 + n_block}", make=functools.partial(
        Dense, embed_dim, num_classes, dtype=dtype), fn=module_plain_fn))
    return tuple(specs)


@register_model("ViT_CIFAR10")
def vit_cifar10(dtype=torch.float32, **kw) -> tuple:
    """CIFAR-10 ViT: (B, 32, 32, 3) NHWC -> 10 classes, 12 layers."""
    specs = _vit_specs(32, 10, dtype=dtype, **kw)
    if not kw:
        assert len(specs) == 12
    return specs


@register_model("ViT_MNIST")
def vit_mnist(dtype=torch.float32, **kw) -> tuple:
    """MNIST ViT: (B, 28, 28, 1) -> 10 classes, 12 layers (the MNIST
    provider is not ported yet)."""
    return _vit_specs(28, 10, in_channels=1, dtype=dtype, **kw)


@register_model("ViT_S16_CIFAR10")
def vit_s16_cifar10(dtype=torch.float32, **kw) -> tuple:
    """ViT-S geometry on CIFAR-10 (BASELINE config 4): patch 4, 384
    wide, 6 heads, MLP 1536, 12 blocks, dropout 0.1 -> 18 layers."""
    defaults = dict(patch_size=4, embed_dim=384, num_heads=6,
                    mlp_dim=1536, n_block=12, dropout_rate=0.1)
    defaults.update(kw)
    return _vit_specs(32, 10, dtype=dtype, **defaults)
