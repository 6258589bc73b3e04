"""Codec'd partial sums: the aggregator tree's wire codec
(``transport.codec: {partial: "int8:64"}`` or ``"delta:int8:64"``).

Port of the JAX package's ``runtime/codec/partial.py``.  A
:class:`~split_learning_torch.runtime.protocol.PartialAggregate` carries
one group's per-stage weighted float32 SUMS; this codec compresses that
leg on the host (aggregators never touch a device, so the numpy twins of
:mod:`~split_learning_torch.runtime.codec.quant` apply):

* the sender ships the group **mean** (``sums / weight``), whose
  magnitudes are the parameters' own and tile-quantize well, where raw
  sums grow with the fold weight;
* ``delta`` mode first subtracts the generation's START shard (the base
  both ends hold), so the int8 tiles spend their range on the round's
  training step;
* the mean (or delta) is tiled-absmax quantized (``quantize_np``), and
  the receiver rebuilds ``sums = (base + dequant) * weight`` in float32
  before folding.

A non-finite tile ships a NaN scale (counted ``quant_nonfinite``) and
dequantizes to NaN, as a NaN in a raw partial would reach the fold.  The
frame's ``codec``/``codec_base`` fields say how to decode, so raw and
codec'd partials share every consumer.  A delta partial whose base the
receiver does not hold raises :class:`PartialCodecError` (the caller
counts ``partial_codec_errors`` and drops it): never mis-reconstructed.
Batch-statistic sums quantize without the delta.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from split_learning_torch.ops.fedavg import unflatten_items as _unflatten
from split_learning_torch.ops.fedavg import walk_items as _flat_items
from split_learning_torch.runtime.codec.quant import (
    dequantize_leaf_np, quantize_np,
)
from split_learning_torch.runtime.codec.specs import CodecSpec, parse_spec
from split_learning_torch.runtime.protocol import QuantLeaf, unpack_members


class PartialCodecError(ValueError):
    """A codec'd partial could not be reconstructed (unknown spec,
    missing or mismatched delta base)."""


def _resolve_spec(spec: CodecSpec | str) -> CodecSpec:
    return parse_spec(spec) if isinstance(spec, str) else spec


def spec_string(spec: CodecSpec) -> str:
    """The self-describing wire form of a partial codec spec."""
    if spec.kind == "delta":
        return f"delta:{'int8' if spec.delta_dtype == 'int8' else 'bf16'}" \
            + (f":{spec.tile}" if spec.delta_dtype == "int8" else "")
    return f"{spec.kind}:{spec.tile}"


def _quant_bits(spec: CodecSpec) -> int:
    # delta:bf16 has no integer quantizer; encode refuses it
    return 8 if spec.kind == "delta" else spec.bits


def _host(leaf) -> np.ndarray:
    """A base or sum leaf (numpy array or CPU tensor) as float32 numpy."""
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.float32)


def encode_partial_entry(ent: dict, spec: CodecSpec | str,
                         base: Any = None, base_gen: int | None = None,
                         faults=None) -> tuple[dict, str, int | None]:
    """Compress one ``StreamingFold.partial()`` stage entry (a copy; the
    caller's entry is untouched).

    Returns ``(entry, codec_string, codec_base)`` for the
    PartialAggregate fields.  ``base`` is the stage's START shard tree
    (delta mode); paths absent from it quantize plain."""
    spec = _resolve_spec(spec)
    delta = spec.kind == "delta"
    if delta and spec.delta_dtype != "int8":
        raise PartialCodecError(
            "partial delta codec supports int8 payloads only "
            f"(got {spec.delta_dtype!r})")
    out = dict(ent)
    base_flat = dict(_flat_items(base)) if (delta and base is not None) \
        else {}
    used_base = False
    for sums_key, w_key in (("sums", "weight"),
                            ("stat_sums", "stat_weight")):
        sums = ent.get(sums_key)
        w = float(ent.get(w_key) or 0.0)
        if not sums or w == 0.0:
            continue
        flat: dict = {}
        for path, leaf in _flat_items(sums):
            mean = _host(leaf) / np.float32(w)
            b = base_flat.get(path) if sums_key == "sums" else None
            if b is not None and tuple(b.shape) == mean.shape:
                mean = mean - _host(b)
                used_base = True
            q = quantize_np(mean, spec.tile, bits=_quant_bits(spec))
            if not np.isfinite(np.asarray(q.scale)).all() \
                    and faults is not None:
                faults.inc("quant_nonfinite")
            flat[path] = q
        out[sums_key] = _unflatten(flat)
    return (out, spec_string(spec),
            base_gen if (delta and used_base) else None)


def decode_partial_entry(ent: dict, codec: str,
                         codec_base: int | None = None,
                         base: Any = None,
                         base_gen: int | None = None) -> dict:
    """Rebuild float32 sums from a codec'd stage entry; raises
    :class:`PartialCodecError` when the delta base is needed but missing
    or from another generation."""
    _resolve_spec(codec)   # an unknown spec raises here
    if codec_base is not None:
        if base is None or base_gen != codec_base:
            raise PartialCodecError(
                f"delta partial against base gen {codec_base} but the "
                f"receiver holds "
                f"{'none' if base is None else f'gen {base_gen}'}")
    base_flat = dict(_flat_items(base)) if (codec_base is not None
                                            and base is not None) else {}
    out = dict(ent)
    for sums_key, w_key in (("sums", "weight"),
                            ("stat_sums", "stat_weight")):
        sums = ent.get(sums_key)
        w = float(ent.get(w_key) or 0.0)
        if not sums:
            continue
        flat: dict = {}
        for path, leaf in _flat_items(sums):
            if isinstance(leaf, QuantLeaf):
                mean = dequantize_leaf_np(leaf)
                b = base_flat.get(path) if sums_key == "sums" else None
                if b is not None:
                    if tuple(b.shape) != mean.shape:
                        raise PartialCodecError(
                            f"delta base shape {tuple(b.shape)} != "
                            f"partial {mean.shape} at {path!r}")
                    mean = mean + _host(b)
                flat[path] = (mean * np.float32(w)).astype(np.float32)
            else:
                flat[path] = _host(leaf)
        out[sums_key] = _unflatten(flat)
    return out


def msg_entry(msg) -> dict:
    """The stage-entry view of a PartialAggregate's payload fields."""
    return {"sums": msg.sums, "weight": msg.weight,
            "stat_sums": msg.stat_sums, "stat_weight": msg.stat_weight}


def decode_partial_msg(msg, bases: dict | None = None,
                       base_gen: int | None = None) -> None:
    """Decode a PartialAggregate IN PLACE when it carries a codec (a
    no-op on raw float32 frames).  ``bases`` maps stage -> START shard
    tree for the delta mode.  A packed member list (``members_z``) is
    restored to the plain list first."""
    if getattr(msg, "members_z", None):
        msg.members = unpack_members(msg.members_z)
        msg.members_z = None
    if not msg.codec:
        return
    ent = decode_partial_entry(
        msg_entry(msg), msg.codec, codec_base=msg.codec_base,
        base=(bases or {}).get(msg.stage), base_gen=base_gen)
    msg.sums = ent["sums"]
    msg.stat_sums = ent["stat_sums"]
    msg.codec = None
    msg.codec_base = None
