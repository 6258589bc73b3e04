"""The port's hand-written CUDA kernel plane.

Port of the JAX package's ``ops/kernels/``: the fused tiled-absmax
quantize/dequantize codec kernels (:mod:`.quant`, ``csrc/quant.cu``) and
the fused round-boundary stage-update kernels (:mod:`.update`,
``csrc/update.cu``), built by :mod:`.build` from ``csrc/`` at first use.

Gating is the JAX package's: the config's ``kernels:`` block becomes a
:class:`KernelPlan`, passed explicitly (``QuantCodec(..., kernels=...)``,
``CudaFoldBackend(kernels=...)``) or through the process-wide plan that
:func:`configure` installs (``make_codecs`` calls it with the loaded
config, so the self-describing receiver decode follows the same plan).
With every flag off the behaviour is exactly the plain PyTorch chain —
the counterpart of the JAX package's XLA chain, and the config's own
semantics, not a fallback.  With a flag on, a CUDA tensor launches the
kernel or raises; a CPU tensor takes the kernel's plain version.

The JAX package's ``pick_block``/``pick_pair_block`` grid sizing and the
plan's ``block`` target have no counterpart: the quantizer's vec kernel
gives each warp whole tiles (a persistent grid, walked tile by tile),
its generic kernel gives each block a fixed, even run of tiles (so int4
code pairs never cross a block), and the update kernels run a flat
grid-stride loop.
"""

from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["KernelPlan", "DISABLED", "as_plan", "configure", "plan",
           "override"]


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Which kernels are live."""
    quantize: bool = False
    dequantize: bool = False
    stage_update: bool = False


DISABLED = KernelPlan()
_active: KernelPlan = DISABLED


def as_plan(obj) -> KernelPlan:
    """Coerce a config ``kernels:`` section (or a plan, or None) into a
    :class:`KernelPlan`.  None means "no opinion": the process-wide
    plan."""
    if obj is None:
        return _active
    if isinstance(obj, KernelPlan):
        return obj
    return KernelPlan(
        quantize=bool(getattr(obj, "quantize", False)),
        dequantize=bool(getattr(obj, "dequantize", False)),
        stage_update=bool(getattr(obj, "stage_update", False)))


def configure(obj) -> KernelPlan:
    """Install the process-wide kernel plan from a loaded config's
    ``kernels`` section.  ``configure(None)`` is a no-op returning the
    current plan."""
    global _active
    if obj is not None:
        _active = as_plan(obj)
    return _active


def plan() -> KernelPlan:
    """The process-wide kernel plan (default: :data:`DISABLED`)."""
    return _active


@contextlib.contextmanager
def override(**fields):
    """Test helper: temporarily replace fields of the process plan."""
    global _active
    prev = _active
    _active = dataclasses.replace(prev, **fields)
    try:
        yield _active
    finally:
        _active = prev
