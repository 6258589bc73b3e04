"""Transformer blocks: the pre-LN encoder block of ViT and KWT, and
BERT's post-LN blocks, embeddings, pooler and classifier.

Port of the JAX package's ``models/transformer.py``.  Attention follows
flax's ``nn.MultiHeadDotProductAttention`` step for step, in plain torch
ops and in the compute dtype:

* query, key and value are ``DenseGeneral`` projections to (heads,
  head_dim), each with its own (embed, heads, head_dim) kernel and
  (heads, head_dim) bias — flax's parameter layout, kept as it is;
* the query is divided by ``sqrt(head_dim)`` (in the compute dtype)
  before the product with the keys;
* a boolean key mask (BERT's padding, broadcast ``(B, 1, 1, S)``)
  replaces a masked logit by ``finfo(dtype).min`` of the compute dtype,
  not ``-inf``: a row whose keys are all masked is uniform, as flax's,
  not NaN;
* the softmax runs in the compute dtype (flax's
  ``force_fp32_for_softmax`` is off): ``exp(s - max)`` over its sum;
* in train mode with a dropout rate, the weights are multiplied by one
  (q, k) keep mask broadcast over batch and heads (flax's
  ``broadcast_dropout``), over the keep probability;
* the heads are merged by the ``out`` projection, a (heads, head_dim,
  embed) kernel.

No flash kernel and no ``scaled_dot_product_attention``: the JAX
package's ViT, KWT and BERT run plain XLA attention, and SDPA's float32
softmax would not round as flax's bf16 chain does.

BERT's blocks are post-LN (``LayerNorm(x + sublayer(x))``, epsilon
1e-12); the fine-grained BERT splits each block into its attention and
FFN halves (:class:`BertAttentionSublayer`, :class:`BertFfnSublayer`),
whose parameters are named as the block's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from split_learning_torch.models.llama import Embed
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


class AttentionDropout(Dropout):
    """flax's dropout of the attention weights: one (q, k) keep mask
    broadcast over batch and heads, ``w * keep / keep_prob`` in the
    weights' dtype."""

    def forward(self, w, train: bool = False):
        if not train or self.rate == 0.0:
            return w
        keep_prob = 1.0 - self.rate
        keep = torch.rand((1, 1) + tuple(w.shape[-2:]),
                          generator=self.generator, device=w.device)
        keep = keep < keep_prob
        return w * (keep.to(w.dtype) / torch.tensor(keep_prob,
                                                     dtype=w.dtype))


class SelfAttention(nn.Module):
    """``nn.MultiHeadDotProductAttention(num_heads, qkv_features=embed,
    out_features=embed, dropout_rate=rate)`` applied to ``(x, x)``, with
    an optional boolean key mask broadcastable to (B, heads, q, k)."""

    def __init__(self, embed_dim: int, num_heads: int, dtype=torch.float32,
                 device=None, generator=None, dropout_rate: float = 0.0):
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
        self.drop = (AttentionDropout(dropout_rate, device=device,
                                      generator=generator)
                     if dropout_rate else None)

    def forward(self, x, mask=None, train: bool = False):
        q, k, v = self.query(x), self.key(x), self.value(x)   # (B, T, H, D)
        depth = q.shape[-1]
        q = q / torch.tensor(math.sqrt(depth), dtype=q.dtype)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            s = torch.where(mask, s, torch.finfo(s.dtype).min)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        w = e / e.sum(dim=-1, keepdim=True)
        if self.drop is not None:
            w = self.drop(w, train)
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


# --------------------------------------------------------------------------
# BERT (post-LN)
# --------------------------------------------------------------------------

def _dropout(rate: float, kw: dict):
    return Dropout(rate, **kw) if rate else None


def _drop(mod, x, train):
    return x if mod is None else mod(x, train)


class BertEmbeddings(nn.Module):
    """Word + position + token-type (ids all zero) embeddings, each looked
    up in ``dtype`` and summed in that order, then LayerNorm (epsilon
    1e-12) and dropout."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 max_position_embeddings: int, type_vocab_size: int = 2,
                 dropout_rate: float = 0.1, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.word_embeddings = Embed(vocab_size, hidden_size, dtype, **kw)
        self.position_embeddings = Embed(max_position_embeddings,
                                         hidden_size, dtype, **kw)
        self.token_type_embeddings = Embed(type_vocab_size, hidden_size,
                                           dtype, **kw)
        self.LayerNorm = LayerNorm(hidden_size, eps=1e-12, dtype=dtype,
                                   **kw)
        self.drop = _dropout(dropout_rate, kw)

    def forward(self, input_ids, train: bool = False):
        seq = input_ids.shape[1]
        word = self.word_embeddings(input_ids)
        pos = self.position_embeddings(
            torch.arange(seq, device=input_ids.device)[None, :])
        tok = self.token_type_embeddings(torch.zeros_like(input_ids))
        return _drop(self.drop, self.LayerNorm(word + pos + tok), train)


class _AttnHalf(nn.Module):
    """Attention half of a post-LN block: attention (with its weight
    dropout) -> dropout -> ``attention_norm(x + attn)``."""

    def _init_attn(self, hidden_size, num_heads, dropout_rate, dtype, kw):
        self.attention = SelfAttention(hidden_size, num_heads, dtype,
                                       dropout_rate=dropout_rate, **kw)
        self.attn_drop = _dropout(dropout_rate, kw)
        self.attention_norm = LayerNorm(hidden_size, eps=1e-12,
                                        dtype=dtype, **kw)

    def _attn(self, x, mask, train):
        a = self.attention(x, mask=mask, train=train)
        return self.attention_norm(x + _drop(self.attn_drop, a, train))


class _FfnHalf(nn.Module):
    """FFN half of a post-LN block: ``intermediate`` -> tanh gelu ->
    ``output`` -> dropout -> ``output_norm(x + h)``."""

    def _init_ffn(self, hidden_size, intermediate_size, dropout_rate,
                  dtype, kw):
        self.intermediate = Dense(hidden_size, intermediate_size,
                                  dtype=dtype, **kw)
        self.output = Dense(intermediate_size, hidden_size, dtype=dtype,
                            **kw)
        self.ffn_drop = _dropout(dropout_rate, kw)
        self.output_norm = LayerNorm(hidden_size, eps=1e-12, dtype=dtype,
                                     **kw)

    def _ffn(self, x, train):
        h = self.output(gelu_fn(None, self.intermediate(x), train))
        return self.output_norm(x + _drop(self.ffn_drop, h, train))


class BertBlock(_AttnHalf, _FfnHalf):
    """Post-LN encoder block: attention half, then FFN half."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, dropout_rate: float = 0.1,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self._init_attn(hidden_size, num_heads, dropout_rate, dtype, kw)
        self._init_ffn(hidden_size, intermediate_size, dropout_rate, dtype,
                       kw)

    def forward(self, x, mask=None, train: bool = False):
        return self._ffn(self._attn(x, mask, train), train)


class BertAttentionSublayer(_AttnHalf):
    """The attention half as a layer of its own (fine-grained cuts)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 dropout_rate: float = 0.1, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        self._init_attn(hidden_size, num_heads, dropout_rate, dtype,
                        dict(device=device, generator=generator))

    def forward(self, x, mask=None, train: bool = False):
        return self._attn(x, mask, train)


class BertFfnSublayer(_FfnHalf):
    """The FFN half as a layer of its own (position-local: the mask is
    accepted and not used)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 dropout_rate: float = 0.1, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        self._init_ffn(hidden_size, intermediate_size, dropout_rate, dtype,
                       dict(device=device, generator=generator))

    def forward(self, x, mask=None, train: bool = False):
        return self._ffn(x, train)


class Pooler(nn.Module):
    """``tanh(dense(x[:, 0]))``: the CLS token's dense + tanh."""

    def __init__(self, hidden_size: int, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size, dtype=dtype,
                           device=device, generator=generator)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class ClassifierHead(nn.Module):
    """Dropout, then the linear ``classifier``."""

    def __init__(self, hidden_size: int, num_labels: int,
                 dropout_rate: float = 0.1, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.drop = _dropout(dropout_rate, kw)
        self.classifier = Dense(hidden_size, num_labels, dtype=dtype, **kw)

    def forward(self, x, train: bool = False):
        return self.classifier(_drop(self.drop, x, train))
