"""Generic layer-indexed model splitting.

Port of the JAX package's ``models/split.py``: 1-based layer indices, a
shard owns layers ``start+1..end``, ``end == -1`` means "to the end",
and a model is a tuple of :class:`LayerSpec` entries.

Parameter state is a two-level tree keyed by **absolute** layer name:
``{"layer7": {"attention.q_proj.weight": tensor, ...}, ...}`` — the top
level is the layer name (the same in every shard and in the full
model), the inner dict is that layer module's ``state_dict``.  So shard
state transfer, FedAvg across shards and full-model reassembly are plain
dict slicing, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One indexed layer of a splittable model.

    ``make(device=..., generator=...)`` builds the layer's module
    (parametric layers); param-free ops set only ``fn``.  ``fn``
    signature: ``fn(module_or_none, x, train)``.
    """
    name: str
    make: Callable[..., nn.Module] | None = None
    fn: Callable[..., Any] | None = None

    def __post_init__(self):
        if self.make is None and self.fn is None:
            raise ValueError(
                f"LayerSpec {self.name}: at least one of make/fn required")


class SplitModel(nn.Module):
    """A contiguous slice ``start_layer+1 .. end_layer`` of a layer list.

    ``start_layer=0, end_layer=-1`` (or ``len(specs)``) is the full
    model.  ``layers`` hands in already-built layer modules by name, so
    the shards of one model share its parameters (:meth:`shard`).
    """

    def __init__(self, specs: Sequence[LayerSpec], start_layer: int = 0,
                 end_layer: int = -1, *, layers: dict | None = None,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.specs = tuple(specs)
        self.start_layer = start_layer
        self.end_layer = end_layer
        self.layers = nn.ModuleDict()
        for i, spec in self._owned_specs():
            if spec.make is None:
                continue
            if layers is not None:
                self.layers[spec.name] = layers[spec.name]
            else:
                self.layers[spec.name] = spec.make(device=device,
                                                   generator=generator)

    @property
    def resolved_end(self) -> int:
        return len(self.specs) if self.end_layer == -1 else self.end_layer

    def _owned_specs(self):
        for i, spec in enumerate(self.specs, start=1):
            if self.start_layer < i <= self.resolved_end:
                yield i, spec

    def forward(self, x, train: bool = False):
        for _, spec in self._owned_specs():
            if spec.make:
                mod = self.layers[spec.name]
                x = spec.fn(mod, x, train) if spec.fn else mod(x)
            else:
                x = spec.fn(None, x, train)
        return x

    def shard(self, start_layer: int, end_layer: int) -> "SplitModel":
        """The shard ``start_layer+1..end_layer`` of this model, sharing
        its layer modules (and so its parameters)."""
        return SplitModel(self.specs, start_layer, end_layer,
                          layers=dict(self.layers.items()))

    def state_tree(self) -> dict:
        """``{layer name: layer state_dict}`` of the owned layers (the
        live tensors, detached; clone before mutating the model)."""
        return {name: {k: t.detach() for k, t in mod.state_dict().items()}
                for name, mod in self.layers.items()}

    @torch.no_grad()
    def load_state_tree(self, tree: dict) -> None:
        """Copy a state tree into the owned layers (layers the tree does
        not name keep their values; entries for other layers are
        ignored)."""
        for name, mod in self.layers.items():
            if name in tree:
                mod.load_state_dict(tree[name])


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., tuple]] = {}


def register_model(name: str):
    """Decorator: register a ``(**kw) -> tuple[LayerSpec, ...]`` spec function."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def model_registry() -> dict[str, Callable[..., tuple]]:
    return dict(_REGISTRY)


def build_model(name: str, start_layer: int = 0, end_layer: int = -1, *,
                device=None, generator: torch.Generator | None = None,
                **kwargs) -> SplitModel:
    """Instantiate a shard of a registered model on ``device``.

    Parameters are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 when omitted)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    device = torch.device("cpu" if device is None else device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    specs = _REGISTRY[name](**kwargs)
    return SplitModel(specs, start_layer, end_layer, device=device,
                      generator=generator)


def num_layers(name: str, **kwargs) -> int:
    return len(_REGISTRY[name](**kwargs))


# --------------------------------------------------------------------------
# shard tree slicing
# --------------------------------------------------------------------------

def _layer_index(specs: Sequence[LayerSpec], layer_name: str) -> int:
    for i, s in enumerate(specs, start=1):
        if s.name == layer_name:
            return i
    raise KeyError(layer_name)


def shard_params(full_tree: dict, specs: Sequence[LayerSpec],
                 start_layer: int, end_layer: int) -> dict:
    """Slice a full-model state tree down to one shard's layers
    (``end_layer == -1`` means to-the-end)."""
    end = len(specs) if end_layer == -1 else end_layer
    return {
        k: v for k, v in full_tree.items()
        if start_layer < _layer_index(specs, k) <= end
    }


def merge_shard_params(full_tree: dict, *shard_trees: dict) -> dict:
    """Overlay shard trees onto a full-model tree (reassembly)."""
    out = dict(full_tree)
    for sd in shard_trees:
        out.update(sd)
    return out


def module_plain_fn(mod, x, train):
    """Module whose forward ignores train mode."""
    return mod(x)
