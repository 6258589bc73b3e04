"""Keyword Transformer (KWT) over MFCC features as 17 indexed layers.

Port of the JAX package's ``models/kwt.py``: 1 = linear embedding of
each time step (the (B, n_mfcc, T) input made time-major), 2 = CLS
token, 3 = learned position embedding + dropout, 4-15 = pre-LN encoder
blocks (:class:`~split_learning_torch.models.transformer.PreLNBlock`,
no dropout inside), 16 = LayerNorm (epsilon 1e-6) on the CLS position,
17 = the classification head.  KWT-1's published width is the default:
embed 64, 1 head, MLP 256, 12 blocks, 40 x 98 MFCCs, 10 classes.
``cls_token`` and ``pos_embed`` start from flax's
``truncated_normal(0.02)``: a standard normal cut at +-2, times 0.02.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from split_learning_torch.models.split import (
    Dense, Dropout, LayerNorm, LayerSpec, module_plain_fn, module_train_fn,
    register_model,
)
from split_learning_torch.models.transformer import PreLNBlock


def _trunc_normal_002(shape, device, generator) -> nn.Parameter:
    w = torch.empty(*shape, device=device)
    nn.init.trunc_normal_(w, 0.0, 0.02, -0.04, 0.04, generator=generator)
    return nn.Parameter(w)


class TimeMajorEmbed(nn.Module):
    """(B, n_mfcc, T) -> (B, T, embed): the ``embed`` Dense on each time
    step."""

    def __init__(self, n_mfcc: int, embed_dim: int, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.embed = Dense(n_mfcc, embed_dim, dtype=dtype, device=device,
                           generator=generator)

    def forward(self, x):
        return self.embed(x.transpose(1, 2))


class KwtClsToken(nn.Module):
    """Prepend the learned ``cls_token`` (1, 1, embed), cast to the
    input's dtype."""

    def __init__(self, embed_dim: int, device=None, generator=None):
        super().__init__()
        self.cls_token = _trunc_normal_002((1, 1, embed_dim), device,
                                           generator)

    def forward(self, x):
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1)


class KwtPosEmbed(nn.Module):
    """``x + pos_embed`` (1, T + 1, embed) in the input's dtype, then
    dropout."""

    def __init__(self, seq_len: int, embed_dim: int,
                 dropout_rate: float = 0.1, device=None, generator=None):
        super().__init__()
        self.pos_embed = _trunc_normal_002((1, seq_len, embed_dim), device,
                                           generator)
        self.drop = (Dropout(dropout_rate, device=device,
                             generator=generator) if dropout_rate else None)

    def forward(self, x, train: bool = False):
        x = x + self.pos_embed.to(x.dtype)
        return x if self.drop is None else self.drop(x, train)


def _cls_norm_fn(mod, x, train):
    return mod(x[:, 0])


@register_model("KWT_SPEECHCOMMANDS")
def kwt_speechcommands(n_mfcc: int = 40, time_steps: int = 98,
                       embed_dim: int = 64, num_heads: int = 1,
                       mlp_dim: int = 256, num_classes: int = 10,
                       dropout_rate: float = 0.1,
                       dtype=torch.float32) -> tuple:
    specs = [
        LayerSpec("layer1", make=functools.partial(
            TimeMajorEmbed, n_mfcc, embed_dim, dtype=dtype),
            fn=module_plain_fn),
        LayerSpec("layer2", make=functools.partial(KwtClsToken, embed_dim),
                  fn=module_plain_fn),
        LayerSpec("layer3", make=functools.partial(
            KwtPosEmbed, time_steps + 1, embed_dim,
            dropout_rate=dropout_rate), fn=module_train_fn),
    ]
    for i in range(12):
        specs.append(LayerSpec(f"layer{4 + i}", make=functools.partial(
            PreLNBlock, embed_dim, num_heads, mlp_dim, dtype=dtype),
            fn=module_train_fn))
    specs.append(LayerSpec("layer16", make=functools.partial(
        LayerNorm, embed_dim, dtype=dtype), fn=_cls_norm_fn))
    specs.append(LayerSpec("layer17", make=functools.partial(
        Dense, embed_dim, num_classes, dtype=dtype), fn=module_plain_fn))
    assert len(specs) == 17
    return tuple(specs)
