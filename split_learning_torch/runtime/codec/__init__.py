"""Wire codec layer between the runtime and the SLT2 frame format.

Port of the JAX package's ``runtime/codec/__init__.py``.  A codec is a
per-queue-family policy configured in ``transport.codec`` (grammar in
:mod:`.specs`):

* ``intermediate`` — :class:`~.quant.QuantCodec`, tiled absmax int8/int4
  codes computed on the sender's device;
* ``gradient`` — the same quantizer, or :class:`~.sparse.TopKCodec`:
  top-k sparsification with a checkpointable error-feedback residual;
* ``rpc`` — :class:`~.delta.DeltaCodec`: UPDATE frames carry ``trained
  - base`` against the server's versioned shadow copy.

The data-plane codecs share the JAX package's two-phase encoder:
``prepare(tree, key)`` runs on the training thread (device ops and any
residual update, so state order is publish order) and
``encode(prepared)`` builds the host wire leaves.  The ``partial``
family (the aggregator tree's sums) builds its kind's codec here as the
JAX package does; the tree encodes its partials through
:mod:`.partial`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from split_learning_torch.runtime.protocol import Float0
from split_learning_torch.runtime.codec.specs import (  # noqa: F401
    CODEC_COUNTERS, CODEC_FAMILIES, CodecSpec, CodecSpecError,
    parse_codec_map, parse_spec,
)

__all__ = [
    "CODEC_COUNTERS", "CODEC_FAMILIES", "CodecSpec", "CodecSpecError",
    "parse_codec_map", "parse_spec", "make_codecs", "wire_raw_nbytes",
]

def make_codecs(cfg, faults=None) -> dict:
    """{family: codec instance} for one participant, from
    ``cfg.transport.codec``.  Families without a spec are absent —
    callers use the plain wire-dtype path."""
    specs = parse_codec_map(getattr(cfg.transport, "codec", None))
    # a full config carries the kernel plan for this process — install
    # it so the self-describing decode path (no config in scope)
    # follows the same plan
    kcfg = getattr(cfg, "kernels", None)
    if kcfg is not None:
        from split_learning_torch.ops import kernels as kplane
        kplane.configure(kcfg)
    out: dict = {}
    for family, spec in specs.items():
        if spec.kind == "topk":
            from split_learning_torch.runtime.codec.sparse import TopKCodec
            out[family] = TopKCodec(spec, faults=faults)
        elif spec.kind == "delta":
            from split_learning_torch.runtime.codec.delta import DeltaCodec
            out[family] = DeltaCodec(spec, faults=faults)
        else:
            from split_learning_torch.runtime.codec.quant import (
                QuantCodec,
            )
            out[family] = QuantCodec(spec, faults=faults, kernels=kcfg)
    return out


def wire_raw_nbytes(tree, wire_dtype: torch.dtype) -> int:
    """Bytes this payload tree (of tensors, or host arrays) WOULD occupy
    on the plain (codec-less) wire: float leaves at ``wire_dtype``, a
    :class:`Float0` gradient at 4 bytes an element (as the JAX package
    counts a float0 leaf), everything else at its own width.  Shape-only
    — no device sync.  The denominator of the compression ratio."""
    if isinstance(tree, Float0):
        return 4 * math.prod(tree.shape)
    itemsize = torch.tensor([], dtype=wire_dtype).element_size()
    if isinstance(tree, dict):
        return sum(wire_raw_nbytes(v, wire_dtype) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(wire_raw_nbytes(v, wire_dtype) for v in tree)
    if isinstance(tree, np.ndarray):   # a host tree (an UPDATE's)
        return tree.size * (itemsize if np.issubdtype(tree.dtype,
                                                       np.floating)
                            else tree.itemsize)
    if not isinstance(tree, torch.Tensor):
        return 0
    n = tree.numel()
    return n * (itemsize if tree.dtype.is_floating_point
                else tree.element_size())
