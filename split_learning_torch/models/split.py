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

BatchNorm running statistics are a second tree of the same shape, keyed
as flax keys its ``batch_stats`` collection: ``{"layer2": {"mean": t,
"var": t}, ...}`` for a layer that is a BatchNorm, and by the nested
path for the BatchNorms inside a layer (flax's ``batch_stats/layer4/
bn1/mean`` is ``{"layer4": {"bn1.mean": t, ...}}``), as the parameter
tree keys its inner modules (:meth:`SplitModel.stats_tree`).  A train-mode
forward does not change them: each :class:`BatchNorm` leaves its new
statistics pending, and the caller keeps them with
:meth:`SplitModel.commit_stats` once per consumed batch — so a forward
that is recomputed for its backward still updates them once.

Layers compute in NHWC, as the JAX package's: a conv runs on the NCHW
view ``x.permute(0, 3, 1, 2)`` of an NHWC-contiguous tensor, which is
``channels_last`` memory, and its output is permuted back to an
NHWC-contiguous tensor.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One indexed layer of a splittable model.

    ``make(device=..., generator=...)`` builds the layer's module
    (parametric layers); param-free ops set only ``fn``.  ``fn``
    signature: ``fn(module_or_none, x, train)``; ``x`` and the result may
    be a tuple of tensors (BERT's ``(hidden, mask)`` boundary).
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
        """Run the owned layers; in train mode each BatchNorm leaves its
        new statistics pending (:meth:`commit_stats` keeps them)."""
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
        """``{layer name: layer state_dict}`` of the owned layers that
        hold parameters (the live tensors, detached; clone before
        mutating the model)."""
        tree = {name: {k: t.detach() for k, t in mod.state_dict().items()}
                for name, mod in self.layers.items()}
        return {name: sd for name, sd in tree.items() if sd}

    @torch.no_grad()
    def load_state_tree(self, tree: dict) -> None:
        """Copy a state tree into the owned layers (layers the tree does
        not name keep their values; entries for other layers are
        ignored)."""
        for name, mod in self.layers.items():
            if name in tree:
                mod.load_state_dict(tree[name])

    def _batchnorms(self):
        """``(layer name, path inside the layer, module)`` of every owned
        BatchNorm, those nested inside a layer included (path "" for a
        layer that is a BatchNorm)."""
        return [(name, path, mod) for name, layer in self.layers.items()
                for path, mod in layer.named_modules()
                if isinstance(mod, BatchNorm)]

    def stats_tree(self) -> dict:
        """``{layer name: {"mean", "var"}}`` running statistics of the
        owned BatchNorms (the live tensors, detached); a nested one's
        keys carry its path, ``"bn1.mean"``."""
        tree: dict = {}
        for name, path, mod in self._batchnorms():
            tree.setdefault(name, {}).update(
                {_join(path, k): t for k, t in mod.stats().items()})
        return tree

    @torch.no_grad()
    def load_stats_tree(self, tree: dict) -> None:
        """Copy a statistics tree into the owned BatchNorms; one the tree
        does not name starts from flax's initial statistics (mean 0,
        var 1), as a flax apply without its ``batch_stats`` does."""
        for name, path, mod in self._batchnorms():
            leaves = tree.get(name) or {}
            if _join(path, "mean") in leaves:
                mod.load_stats({k: leaves[_join(path, k)]
                                for k in ("mean", "var")})
            else:
                mod.load_stats(mod.initial_stats())

    def commit_stats(self) -> None:
        """Keep every owned BatchNorm's pending statistics (from its
        latest train-mode forward) as its running statistics."""
        for _, _, mod in self._batchnorms():
            mod.commit()

    def _dropouts(self) -> list:
        """``(key, module)`` of every owned dropout, nested ones
        included; the key is the layer name, dotted with the path inside
        the layer for a nested one."""
        return [(_join(name, path), mod)
                for name, layer in self.layers.items()
                for path, mod in layer.named_modules()
                if isinstance(mod, Dropout)]

    def seed_dropout(self, seed: int) -> None:
        """Reseed every owned dropout generator from ``seed`` and the
        dropout's key."""
        for key, mod in self._dropouts():
            mod.generator.manual_seed(zlib.crc32(f"{seed}:{key}".encode()))

    def rng_state(self) -> list:
        """The owned dropout generators' states (for a recompute that
        must draw the same masks)."""
        return [mod.generator.get_state() for _, mod in self._dropouts()]

    def set_rng_state(self, state: list) -> None:
        for (_, mod), st in zip(self._dropouts(), state):
            mod.generator.set_state(st)


def _join(path: str, key: str) -> str:
    return f"{path}.{key}" if path else key


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


# --------------------------------------------------------------------------
# layers with train-mode behaviour
# --------------------------------------------------------------------------

# flax's truncated_normal(-2, 2) has std 0.8796...; lecun_normal divides
# it out so the drawn values have the requested variance
TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator=None) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class Dense(nn.Module):
    """``nn.Dense``: weight (out, in), lecun-normal (truncated) init,
    zero bias unless ``use_bias`` is false; the product is computed (and
    rounded) in ``dtype`` before the bias is added in ``dtype``."""
    jax_param = "kernel"

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, device=device))
        lecun_normal_(self.weight, in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if use_bias else None)

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Conv(nn.Module):
    """``nn.Conv`` on NHWC inputs: weight (out, in, kh, kw) (flax's HWIO
    kernel transposed), lecun-normal (truncated) init, zero bias unless
    ``use_bias`` is false.  ``padding`` is the explicit padding of each
    spatial side (flax's ``padding=1``; ``0`` is ``VALID``, and flax's
    default ``SAME`` for a 1x1 kernel).  The conv is computed (and
    rounded) in ``dtype`` on the NCHW view of the NHWC tensor — which is
    ``channels_last`` memory, so no copy — and the bias is added in
    ``dtype`` to the NHWC-contiguous result."""
    jax_param = "kernel"

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 use_bias: bool = True, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size,
            device=device))
        lecun_normal_(self.weight, in_channels * kernel_size ** 2,
                      generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if use_bias else None)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype),
                     self.weight.to(self.dtype), stride=self.stride,
                     padding=self.padding)
        y = y.permute(0, 2, 3, 1).contiguous()
        return y if self.bias is None else y + self.bias.to(self.dtype)


class BatchNorm(nn.Module):
    """``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last (channel)
    axis, in flax's numerics.

    Train mode normalises with the batch statistics, computed in float32
    as flax's fast variance: ``var = max(E[x^2] - E[x]^2, 0)``, the
    biased variance, which also enters the running average
    ``0.9 * running + 0.1 * batch``.  That new average is left pending
    (:meth:`commit`), never written by the forward itself — torch's
    ``nn.BatchNorm2d`` would feed the unbiased variance in, on every
    forward.  Eval mode normalises with the running statistics.  The
    normalisation runs in float32 and casts to ``dtype``.  The running
    statistics are non-persistent buffers, so the parameter tree holds
    ``weight`` (flax ``scale``) and ``bias`` only."""
    jax_param = "scale"

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        del generator   # ones and zeros
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device),
                             persistent=False)
        self.register_buffer("var", torch.ones(features, device=device),
                             persistent=False)
        self.pending: dict | None = None

    def forward(self, x, train: bool = False):
        # at least float32, as flax's statistics (float64 stays float64)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            axes = tuple(range(x.ndim - 1))
            mean = x32.mean(dim=axes)
            var = torch.clamp_min((x32 * x32).mean(dim=axes)
                                  - mean * mean, 0.0)
            m = self.momentum
            self.pending = {
                "mean": m * self.mean + (1 - m) * mean.detach(),
                "var": m * self.var + (1 - m) * var.detach()}
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean) * mul + self.bias).to(self.dtype)

    def stats(self) -> dict:
        return {"mean": self.mean.detach(), "var": self.var.detach()}

    def initial_stats(self) -> dict:
        return {"mean": torch.zeros_like(self.mean),
                "var": torch.ones_like(self.var)}

    @torch.no_grad()
    def load_stats(self, tree: dict) -> None:
        self.mean.copy_(tree["mean"])
        self.var.copy_(tree["var"])

    @torch.no_grad()
    def commit(self) -> None:
        if self.pending is not None:
            self.mean.copy_(self.pending["mean"])
            self.var.copy_(self.pending["var"])
            self.pending = None


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` over the last axis, in flax's numerics: the
    statistics in float32 as flax's fast variance (``var = max(E[x^2] -
    E[x]^2, 0)``), ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    float32, cast to ``dtype``.  flax's epsilon is 1e-6 (torch's
    ``nn.LayerNorm`` has 1e-5).  ``dtype=None`` is flax's default: the
    result type of the input and the float32 parameters, so a bf16
    input gives float32."""
    jax_param = "scale"

    def __init__(self, features: int, eps: float = 1e-6, dtype=None,
                 device=None, generator=None):
        super().__init__()
        del generator   # ones and zeros
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(dim=-1, keepdim=True)
                              - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean) * mul + self.bias
        return y.to(self.dtype if self.dtype is not None
                    else torch.promote_types(x.dtype, self.weight.dtype))


class Dropout(nn.Module):
    """``nn.Dropout(rate)``: in train mode keeps each element with
    probability ``1 - rate`` and scales it by ``1 / (1 - rate)``; the
    identity in eval mode.  Masks come from the layer's own generator on
    its device (seeded from the build generator, reseeded by
    :meth:`SplitModel.seed_dropout`)."""

    def __init__(self, rate: float, device=None, generator=None):
        super().__init__()
        self.rate = rate
        device = torch.device("cpu" if device is None else device)
        seed = (0 if generator is None else
                int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                  device=generator.device)))
        # a model on the meta device (a shape pass) draws no mask, and
        # torch has no meta generator: its generator stays on the CPU
        self.generator = torch.Generator(
            device="cpu" if device.type == "meta" else device
        ).manual_seed(seed)

    def forward(self, x, train: bool = False):
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


# --------------------------------------------------------------------------
# layer functions for LayerSpec.fn (NHWC activations)
# --------------------------------------------------------------------------

def relu_fn(_, x, train):
    return F.relu(x)


def gelu_fn(_, x, train):
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def maxpool2_fn(_, x, train):
    """2x2 max pool, stride 2, VALID (an odd edge row/column is dropped)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 1).contiguous()


def flatten_fn(_, x, train):
    """Flatten in NHWC order, as the JAX package does."""
    return x.reshape(x.shape[0], -1)


def dropout_layer(rate: float):
    """``(make, fn)`` of a dropout layer of ``rate``."""
    def make(device=None, generator=None):
        return Dropout(rate, device=device, generator=generator)

    def fn(mod, x, train):
        return mod(x, train)
    return make, fn


def batchnorm_fn(mod, x, train):
    return mod(x, train)


def conv_fn(mod, x, train):
    return mod(x)


def identity_fn(_, x, train):
    return x


def module_train_fn(mod, x, train):
    """Module whose forward takes ``train`` (BatchNorm or dropout
    inside)."""
    return mod(x, train)


def module_plain_fn(mod, x, train):
    """Module whose forward ignores train mode."""
    return mod(x)
