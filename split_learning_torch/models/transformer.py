"""Transformer blocks: the pre-LN encoder block of ViT.

Port of the JAX package's ``models/transformer.py`` ``PreLNBlock``
(the post-LN BERT blocks wait for the BERT slice).  Attention follows
flax's ``nn.MultiHeadDotProductAttention`` step for step, in plain torch
ops and in the compute dtype:

* query, key and value are ``DenseGeneral`` projections to (heads,
  head_dim), each with its own (embed, heads, head_dim) kernel and
  (heads, head_dim) bias — flax's parameter layout, kept as it is;
* the query is divided by ``sqrt(head_dim)`` (in the compute dtype)
  before the product with the keys;
* the softmax runs in the compute dtype (flax's
  ``force_fp32_for_softmax`` is off): ``exp(s - max)`` over its sum;
* the heads are merged by the ``out`` projection, a (heads, head_dim,
  embed) kernel.

No flash kernel and no ``scaled_dot_product_attention``: the JAX
package's ViT runs plain XLA attention, and SDPA's float32 softmax
would not round as flax's bf16 chain does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from split_learning_torch.models.split import (
    Dense, Dropout, LayerNorm, gelu_fn, lecun_normal_,
)


class DenseGeneral(nn.Module):
    """flax's ``DenseGeneral`` with the kernel in flax's layout: the
    ``in_axes`` trailing axes of the input contract with the kernel's
    leading ones, ``in_shape + out_shape``.  Lecun-normal (truncated)
    init over the flattened fan-in, zero bias of ``out_shape``; the
    product and the bias in ``dtype``."""
    jax_param = "kernel"

    def __init__(self, in_shape: tuple, out_shape: tuple,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.in_axes = len(in_shape)
        self.weight = nn.Parameter(torch.empty(
            *in_shape, *out_shape, device=device))
        lecun_normal_(self.weight, math.prod(in_shape), generator)
        self.bias = nn.Parameter(torch.zeros(*out_shape, device=device))

    def forward(self, x):
        y = torch.tensordot(x.to(self.dtype), self.weight.to(self.dtype),
                            dims=self.in_axes)
        return y + self.bias.to(self.dtype)


class SelfAttention(nn.Module):
    """``nn.MultiHeadDotProductAttention(num_heads, qkv_features=embed,
    out_features=embed)`` applied to ``(x, x)``, without a mask."""

    def __init__(self, embed_dim: int, num_heads: int, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed {embed_dim} is not divisible by "
                             f"{num_heads} heads")
        heads = (num_heads, embed_dim // num_heads)
        for name in ("query", "key", "value"):
            setattr(self, name, DenseGeneral(
                (embed_dim,), heads, dtype, device, generator))
        self.out = DenseGeneral(heads, (embed_dim,), dtype, device,
                                generator)

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)   # (B, T, H, D)
        depth = q.shape[-1]
        q = q / torch.tensor(math.sqrt(depth), dtype=q.dtype)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        w = e / e.sum(dim=-1, keepdim=True)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class PreLNBlock(nn.Module):
    """Pre-LN encoder block: ``x + attn(ln1(x))``, then ``x +
    mlp_out(gelu(mlp_in(ln2(x))))`` with dropout on the MLP's output when
    ``dropout_rate`` is set (flax's tanh-approximated gelu; LayerNorm at
    flax's epsilon 1e-6, in ``dtype``)."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 dropout_rate: float = 0.0, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ln1 = LayerNorm(embed_dim, dtype=dtype, **kw)
        self.attention = SelfAttention(embed_dim, num_heads, dtype, **kw)
        self.ln2 = LayerNorm(embed_dim, dtype=dtype, **kw)
        self.mlp_in = Dense(embed_dim, mlp_dim, dtype=dtype, **kw)
        self.mlp_out = Dense(mlp_dim, embed_dim, dtype=dtype, **kw)
        self.drop = (Dropout(dropout_rate, **kw) if dropout_rate else None)

    def forward(self, x, train: bool = False):
        x = x + self.attention(self.ln1(x))
        h = self.mlp_in(self.ln2(x))
        h = self.mlp_out(gelu_fn(None, h, train))
        if self.drop is not None:
            h = self.drop(h, train)
        return x + h
