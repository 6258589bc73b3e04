"""Parameter-level LoRA adapters (peft parity).

Port of the JAX package's ``ops/lora.py``.  The reference wraps BERT
shards with peft LoRA (r=8, alpha=16, targets query/key/value/dense),
trains only the adapters (and the classifier on the last stage) and
bakes them into the weights with ``merge_and_unload`` before its UPDATE.

Here LoRA lives at the level of the state tree: every kernel whose path
names a target gets a pair of factors, and the effective weight is
``W + (alpha/r) delta`` with ``delta`` the product of the pair in the
weight's own layout.  Training differentiates the merged forward
(:func:`lora_forward`) with respect to the adapters (and any unfrozen
layers) while the base weights stay constant — peft's semantics, not a
masked update.

The target rule is the JAX package's, restated on the port's names.  A
leaf is a kernel when its module's ``jax_param`` is ``"kernel"`` (a
Dense, a DenseGeneral, a Conv — not an embedding table), of rank 2 or
more, and one of ``targets`` is a whole element of its path
(``["layer3", "attention", "query"]``; so ``output`` matches BERT's FFN
output and not ``output_norm``).  Each kernel is factored over its
(in, out) view in flax's layout: a Dense's (out, in) weight is flax's
(in, out) kernel transposed; attention's 3-D ``DenseGeneral`` kernels
keep flax's layout, query/key/value (embed, heads, head_dim) with the
heads on the OUTPUT side and ``out`` (heads, head_dim, embed) with the
heads on the INPUT side.  The port stores each pair as peft does,
``a: (r, in)`` and ``b: (out, r)`` (the JAX package's ``a: (in, r)``
and ``b: (r, out)`` transposed; ``convert.from_jax_lora`` carries them
across), so ``b @ a`` is ``delta`` over (out, in).  ``a`` is
Gaussian/r and ``b`` zeros, so the merged model starts at the base
weights.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch.func import functional_call

from split_learning_torch.config import (
    LORA_DEFAULT_TARGETS as DEFAULT_TARGETS,
)


def kernel_keys(model) -> dict:
    """``{layer: {key, ...}}``: the parameter keys of ``model`` (a
    :class:`SplitModel`) that hold a flax ``kernel``."""
    out: dict = {}
    for layer, mod in model.layers.items():
        for path, sub in mod.named_modules():
            if getattr(sub, "jax_param", None) == "kernel":
                out.setdefault(layer, set()).add(
                    f"{path}.weight" if path else "weight")
    return out


def _names(layer: str, key: str) -> list:
    """The flax path of a kernel leaf, without its leaf name."""
    return [layer, *key.split(".")[:-1]]


def _jax_shape(shape: Sequence[int]) -> tuple:
    """flax's shape of a port kernel: (out, in) -> (in, out); OIHW ->
    HWIO; a 3-D DenseGeneral kernel as it is."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 2:
        return shape[::-1]
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    return shape


def _as_2d(shape: Sequence[int], names: Sequence[str]) -> tuple[int, int]:
    """(in, out) view of a flax kernel shape: the attention out
    projection has its heads on the input side, every other kernel
    (query/key/value's (embed, heads, head_dim) included) its first axis
    as the input."""
    if len(shape) <= 2:
        return int(shape[0]), int(math.prod(shape[1:]))
    if "out" in names:
        return int(math.prod(shape[:-1])), int(shape[-1])
    return int(shape[0]), int(math.prod(shape[1:]))


def is_target(layer: str, key: str, leaf: torch.Tensor, kernels: dict,
              targets: Sequence[str] = DEFAULT_TARGETS) -> bool:
    if key not in kernels.get(layer, ()) or leaf.ndim < 2:
        return False
    names = _names(layer, key)
    return any(t in names for t in targets)


def lora_init(generator: torch.Generator, params: dict, model,
              targets: Sequence[str] = DEFAULT_TARGETS,
              rank: int = 8) -> dict:
    """Adapter tree over the target kernels of ``params`` (a state tree
    of ``model``'s layers): ``{layer: {key: {"a": (r, in), "b": (out,
    r)}}}``, ``a`` drawn from ``generator`` (on the leaves' device) as a
    standard normal over ``rank``, ``b`` zeros.  Layers without a target
    are absent."""
    kernels = kernel_keys(model)
    out: dict = {}
    for layer, sd in params.items():
        for key, leaf in sd.items():
            if not is_target(layer, key, leaf, kernels, targets):
                continue
            d_in, d_out = _as_2d(_jax_shape(leaf.shape),
                                 _names(layer, key))
            a = torch.randn((rank, d_in), generator=generator,
                            dtype=leaf.dtype, device=leaf.device) / rank
            b = torch.zeros((d_out, rank), dtype=leaf.dtype,
                            device=leaf.device)
            out.setdefault(layer, {})[key] = {"a": a, "b": b}
    return out


def lora_delta(entry: dict, shape: Sequence[int]) -> torch.Tensor:
    """``b @ a`` laid out as the port's weight of ``shape``: flax's
    (in, out) product reshaped to flax's kernel shape, then moved to the
    port's layout (a Dense's transpose, a Conv's OIHW)."""
    d = (entry["b"] @ entry["a"]).T.reshape(_jax_shape(shape))
    if d.ndim == 2:
        return d.T
    if d.ndim == 4:
        return d.permute(3, 2, 0, 1)
    return d


def lora_merge(params: dict, lora: dict, alpha: float = 16.0,
               rank: int = 8) -> dict:
    """Bake adapters into the base weights, ``W + (alpha/r) delta``
    (peft ``merge_and_unload``); leaves without an adapter are passed on
    as they are."""
    scale = alpha / rank
    out = {}
    for layer, sd in params.items():
        entries = lora.get(layer, {})
        out[layer] = {
            k: (t + scale * lora_delta(entries[k], t.shape).to(t.dtype)
                if k in entries else t)
            for k, t in sd.items()}
    return out


def lora_forward(model, lora: dict, alpha: float, rank: int, *args,
                 **kwargs):
    """``model(*args, **kwargs)`` on the merged weights of the layers it
    owns, differentiable in the adapters (the module's own parameters
    are the base)."""
    scale = alpha / rank
    merged = {}
    for layer, entries in lora.items():
        if layer not in model.layers:
            continue
        own = dict(model.layers[layer].named_parameters())
        for key, entry in entries.items():
            w = own[key]
            merged[f"layers.{layer}.{key}"] = (
                w + scale * lora_delta(entry, w.shape).to(w.dtype))
    if not merged:
        return model(*args, **kwargs)
    return functional_call(model, merged, args, kwargs, strict=False)


def lora_tensors(lora: dict) -> list:
    """The adapter factors of ``lora``, in tree order."""
    return [entry[n] for entries in lora.values()
            for entry in entries.values() for n in ("a", "b")]


def lora_trainable(model, lora: dict, unfrozen) -> list:
    """Freeze every layer of ``model`` but ``unfrozen`` (the classifier)
    and make the adapter factors leaves that require grad; returns the
    tensors a LoRA round trains: the factors, then the unfrozen layers'
    parameters."""
    for name, mod in model.layers.items():
        mod.requires_grad_(name in unfrozen)
    for t in lora_tensors(lora):
        t.requires_grad_()
    return lora_tensors(lora) + [p for name in unfrozen
                                 for p in model.layers[name].parameters()]


def lora_param_count(lora: dict) -> int:
    return sum(t.numel() for t in lora_tensors(lora))


def split_frozen(params: dict, unfrozen_names: Sequence[str]):
    """Partition a state tree into (frozen, trainable) by layer name —
    the reference unfreezes the classifier on the last stage."""
    frozen = {k: v for k, v in params.items() if k not in unfrozen_names}
    trainable = {k: v for k, v in params.items() if k in unfrozen_names}
    return frozen, trainable
