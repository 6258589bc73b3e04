"""BERT-base as 15 macro-layers (or 27 fine-grained ones) for AG-News and
the 6-label Emotion set.

Port of the JAX package's ``models/bert.py``: layer 1 = embeddings,
layers 2-13 = post-LN encoder blocks, 14 = CLS pooler, 15 = classifier.
``fine_grained=True`` splits every block into its attention and FFN
halves: 1 embeddings, 2-25 alternating attention/FFN, 26 pooler, 27
classifier, so that a cut can fall inside a block.

The stage boundary between layers 1 and the pooler is the pair
``(hidden, mask)``: layer 1 derives the padding mask from the token ids
(``[PAD]`` is id 0) and every block passes it on, so it crosses every
cut beside the activations; each block attends only to unmasked keys.
"""

from __future__ import annotations

import functools

import torch

from split_learning_torch.models.split import (
    LayerSpec, module_train_fn, register_model,
)
from split_learning_torch.models.transformer import (
    BertAttentionSublayer, BertBlock, BertEmbeddings, BertFfnSublayer,
    ClassifierHead, Pooler,
)

_PAD_ID = 0  # [PAD] is id 0 in BERT vocabs (data/wordpiece.py)


def _embed_fn(mod, input_ids, train):
    """Layer 1: the embeddings, and the padding mask threaded beside
    them across every later layer and cut."""
    mask = input_ids != _PAD_ID
    return mod(input_ids, train=train), mask


def _block_fn(mod, xm, train):
    """An encoder block (or half) on ``(hidden, mask)``: padded key
    positions are not attended (a (B, 1, 1, S) boolean mask)."""
    x, mask = xm
    return mod(x, mask=mask[:, None, None, :], train=train), mask


def _pooler_fn(mod, xm, train):
    x, _ = xm  # CLS pooling: the mask's job is done
    return mod(x)


def _bert_specs(num_labels: int, vocab_size: int = 28996,
                hidden_size: int = 768, num_heads: int = 12,
                intermediate_size: int = 3072,
                max_position_embeddings: int = 512, n_block: int = 12,
                dropout_rate: float = 0.1, dtype=torch.float32,
                fine_grained: bool = False) -> tuple:
    specs = [LayerSpec("layer1", make=functools.partial(
        BertEmbeddings, vocab_size, hidden_size, max_position_embeddings,
        dropout_rate=dropout_rate, dtype=dtype), fn=_embed_fn)]
    attn = functools.partial(BertAttentionSublayer, hidden_size, num_heads,
                             dropout_rate=dropout_rate, dtype=dtype)
    ffn = functools.partial(BertFfnSublayer, hidden_size,
                            intermediate_size, dropout_rate=dropout_rate,
                            dtype=dtype)
    block = functools.partial(BertBlock, hidden_size, num_heads,
                              intermediate_size, dropout_rate=dropout_rate,
                              dtype=dtype)
    for _ in range(n_block):
        for make in ((attn, ffn) if fine_grained else (block,)):
            specs.append(LayerSpec(f"layer{len(specs) + 1}", make=make,
                                   fn=_block_fn))
    specs.append(LayerSpec(f"layer{len(specs) + 1}", make=functools.partial(
        Pooler, hidden_size, dtype=dtype), fn=_pooler_fn))
    specs.append(LayerSpec(f"layer{len(specs) + 1}", make=functools.partial(
        ClassifierHead, hidden_size, num_labels, dropout_rate=dropout_rate,
        dtype=dtype), fn=module_train_fn))
    return tuple(specs)


@register_model("BERT_AGNEWS")
def bert_agnews(dtype=torch.float32, **kw) -> tuple:
    """AG-News: 4 classes, input (B, 128) int token ids."""
    return _bert_specs(4, dtype=dtype, **kw)


@register_model("BERT_EMOTION")
def bert_emotion(dtype=torch.float32, **kw) -> tuple:
    """Emotion: 6 classes; ``fine_grained=True`` gives the 27
    per-sublayer layers."""
    return _bert_specs(6, dtype=dtype, **kw)
