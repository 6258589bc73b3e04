"""TinyLlama-style causal LM as indexed layers (north-star config #5).

Port of the JAX package's ``models/llama.py``: RMSNorm pre-norm blocks,
interleaved rotary position embeddings, grouped-query attention, SwiGLU
MLP, untied LM head.  TinyLlama-1.1B defaults (2048 hidden, 22 blocks,
32 Q / 4 KV heads, 5632 intermediate, 32000 vocab).

Split-layer contract: 1 = token embedding, 2..n_block+1 = decoder blocks,
n_block+2 = final RMSNorm, n_block+3 = LM head (25 layers at full size).
The activation between any two stages is the (B, S, H) hidden state.

Mixed precision as in flax: parameters are float32 and every layer
computes in ``dtype`` (the product inputs are cast to it); RMSNorm
reduces in float32; the logits reach the cross entropy in ``dtype``.
One rounding differs under bf16: torch's cross entropy accumulates its
log-softmax in float32 before rounding to bf16, where optax computes it
in bf16.  The float32 model is held against the JAX package on the CPU
(logits 2e-5, gradients 5e-4); the bf16 model is not compared with it.
``use_flash`` routes attention through the hand-written flash-attention
kernels (``ops/flash_attention.py``).
The MoE variant waits for the expert-parallel slice.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from split_learning_torch.models.split import (
    Dense, LayerSpec, register_model, module_plain_fn as _plain_fn,
)
from split_learning_torch.ops.flash_attention import flash_attention

class Embed(nn.Module):
    """``nn.Embed``: weight (vocab, features) ~ N(0, 1/features),
    looked up in float32 and cast to ``dtype``."""
    jax_param = "embedding"

    def __init__(self, num_embeddings: int, features: int,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, features, device=device))
        nn.init.normal_(self.weight, 0.0, math.sqrt(1.0 / features),
                        generator=generator)

    def forward(self, ids):
        return F.embedding(ids.long(), self.weight).to(self.dtype)


class RMSNorm(nn.Module):
    """``nn.RMSNorm(epsilon=1e-5)``: ``x * (rsqrt(mean(x^2) + eps) *
    scale)`` in float32, cast to ``dtype``."""
    jax_param = "scale"

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        del generator   # ones
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * (torch.rsqrt(var + self.eps) * self.weight)).to(
            self.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          base: float = 10000.0) -> torch.Tensor:
    """Interleaved rotary embedding over the last dim of (B, S, H, D):
    pairs ``(x[..., 0::2], x[..., 1::2])`` rotate and re-stack (not the
    half-split ``rotate_half`` layout)."""
    d = x.shape[-1]
    # float64 then float32, as the reference's numpy table; built on the
    # device (a host table would cost a stream sync per call)
    exps = torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d
    inv_freq = (1.0 / base ** exps).float()
    freqs = positions[:, None].float() * inv_freq[None, :]
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.reshape(x.shape).to(x.dtype)


class LlamaAttention(nn.Module):
    """Causal GQA with RoPE; ``use_flash`` uses the flash kernels."""

    def __init__(self, hidden_size: int, num_heads: int, num_kv_heads: int,
                 dtype=torch.float32, use_flash: bool = False, device=None,
                 generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = hidden_size // num_heads
        self.dtype = dtype
        self.use_flash = use_flash
        hd = self.head_dim
        dense = functools.partial(Dense, use_bias=False, dtype=dtype,
                                  device=device, generator=generator)
        self.q_proj = dense(hidden_size, num_heads * hd)
        self.k_proj = dense(hidden_size, num_kv_heads * hd)
        self.v_proj = dense(hidden_size, num_kv_heads * hd)
        self.o_proj = dense(num_heads * hd, hidden_size)

    def forward(self, x):
        b, s, _ = x.shape
        hd = self.head_dim
        q = self.q_proj(x).reshape(b, s, self.num_heads, hd)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, hd)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, hd)
        pos = torch.arange(s, device=x.device)
        q, k = _rope(q, pos), _rope(k, pos)
        rep = self.num_heads // self.num_kv_heads
        if rep > 1:
            # head h reads KV head h // rep (jnp.repeat along heads)
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if self.use_flash:
            out = flash_attention(q, k, v, causal=True).reshape(b, s, -1)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / \
                math.sqrt(hd)
            mask = torch.ones(s, s, dtype=torch.bool,
                              device=x.device).tril()
            scores = scores.masked_fill(~mask, -1e30)
            probs = torch.softmax(scores, dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs,
                               v).reshape(b, s, -1)
        return self.o_proj(out)


class LlamaBlock(nn.Module):
    """Pre-RMSNorm: x + attn(norm(x)); x + swiglu(norm(x))."""

    def __init__(self, hidden_size: int, num_heads: int, num_kv_heads: int,
                 intermediate_size: int, dtype=torch.float32,
                 use_flash: bool = False, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.input_norm = RMSNorm(hidden_size, **kw)
        self.attention = LlamaAttention(hidden_size, num_heads,
                                        num_kv_heads, use_flash=use_flash,
                                        **kw)
        self.post_norm = RMSNorm(hidden_size, **kw)
        dense = functools.partial(Dense, use_bias=False, **kw)
        self.gate_proj = dense(hidden_size, intermediate_size)
        self.up_proj = dense(hidden_size, intermediate_size)
        self.down_proj = dense(intermediate_size, hidden_size)

    def forward(self, x):
        x = x + self.attention(self.input_norm(x))
        h = self.post_norm(x)
        gate = F.silu(self.gate_proj(h))
        return x + self.down_proj(gate * self.up_proj(h))


def _llama_specs(vocab_size: int = 32000, hidden_size: int = 2048,
                 num_heads: int = 32, num_kv_heads: int = 4,
                 intermediate_size: int = 5632, n_block: int = 22,
                 use_flash: bool = False, dtype=torch.float32) -> tuple:
    specs = [LayerSpec("layer1", make=functools.partial(
        Embed, vocab_size, hidden_size, dtype=dtype), fn=_plain_fn)]
    for i in range(n_block):
        block = functools.partial(
            LlamaBlock, hidden_size, num_heads, num_kv_heads,
            intermediate_size, dtype=dtype, use_flash=use_flash)
        specs.append(LayerSpec(f"layer{2 + i}", make=block, fn=_plain_fn))
    specs.append(LayerSpec(f"layer{2 + n_block}", make=functools.partial(
        RMSNorm, hidden_size, dtype=dtype), fn=_plain_fn))
    specs.append(LayerSpec(f"layer{3 + n_block}", make=functools.partial(
        Dense, hidden_size, vocab_size, use_bias=False, dtype=dtype),
        fn=_plain_fn))
    return tuple(specs)


@register_model("TinyLlama_TINYSTORIES")
def tinyllama_tinystories(dtype=torch.float32, **kw) -> tuple:
    """TinyLlama-1.1B geometry; input (B, S) integer token ids, output
    (B, S, vocab) next-token logits.  25 layers at full size."""
    return _llama_specs(dtype=dtype, **kw)
