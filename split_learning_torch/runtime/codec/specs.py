"""Codec spec grammar — the import-light half of the codec package.

``transport.codec`` maps a queue FAMILY to a codec spec string::

    transport:
      codec:
        intermediate: int8          # tiled absmax int8 activations
        gradient: topk:0.05         # top-5% gradients + error feedback
        rpc: delta:int8             # int8-quantized Update deltas

This module owns parsing + validation of those strings and the static
metadata the ``codec`` slcheck analyzer consumes (which counters each
codec kind may increment).  It deliberately imports NOTHING heavy:
``config.py`` validates specs at YAML-load time and the analyzer runs
in ``--no-trace`` (jax-free) CI lanes — both must not pull in jax.

Spec grammar (kind[:arg[:arg]]):

* ``int8`` / ``int4``            — tiled absmax quantization; optional
  ``:<tile>`` sets the per-tile scale width (elements; default 256),
  e.g. ``int4:128``.
* ``topk:<frac>``                — magnitude top-k sparsification with a
  client-side error-feedback residual; ``frac`` in (0, 1] is the kept
  fraction, e.g. ``topk:0.05``.
* ``delta`` / ``delta:int8[:t]`` / ``delta:bf16``
  — Update frames carry ``params - last_server_acked`` against a
  version tag; the payload delta ships bf16 (default) or tiled-int8.

Family compatibility: ``intermediate`` takes quantizers, ``gradient``
takes quantizers or topk, ``rpc`` takes delta only — a spec outside its
family is a config error, not a silent no-op.
"""

from __future__ import annotations

import dataclasses

#: queue families a codec policy can target (the protocol's four
#: tensor-framed planes: Activation, Gradient, Update, and the
#: aggregator tree's PartialAggregate sums)
CODEC_FAMILIES = ("intermediate", "gradient", "rpc", "partial")

#: codec kind -> FaultCounters names its runtime half may increment.
#: The ``codec`` slcheck analyzer (CD001) holds every entry to the
#: declared registries in ``runtime/trace.py`` — a codec minting an
#: unregistered counter is a typo no dashboard would ever surface.
CODEC_COUNTERS: dict[str, tuple] = {
    # the partial family reuses the int8/int4/delta kinds
    # (runtime/codec/partial.py): undecodable codec'd partials count
    # partial_codec_errors at the receiving aggregator/root
    "int8": ("quant_nonfinite", "partial_codec_errors"),
    "int4": ("quant_nonfinite", "partial_codec_errors"),
    "topk": ("topk_dense_fallbacks",),
    "delta": ("delta_folds", "delta_full_frames", "delta_resyncs",
              "quant_nonfinite", "partial_codec_errors"),
}

#: specs legal per family.  ``partial`` (the aggregator tree's
#: PartialAggregate sums, ``runtime/codec/partial.py``) takes the
#: tiled quantizers — the group MEAN ships as int8/int4 codes — or
#: ``delta[:int8[:tile]]``: mean minus the generation's START shard
#: (the base both endpoints hold), quantized.
_FAMILY_KINDS = {
    "intermediate": ("int8", "int4"),
    "gradient": ("int8", "int4", "topk"),
    "rpc": ("delta",),
    "partial": ("int8", "int4", "delta"),
}

DEFAULT_TILE = 256


class CodecSpecError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """One parsed codec spec."""
    kind: str                     # int8 | int4 | topk | delta
    bits: int = 8                 # quantizer width (int8/int4/delta:int8)
    tile: int = DEFAULT_TILE      # per-tile scale width (elements)
    frac: float = 0.0             # topk kept fraction
    delta_dtype: str = ""         # delta payload: "bfloat16" | "int8"


def _parse_tile(tok: str, spec: str) -> int:
    try:
        tile = int(tok)
    except ValueError:
        raise CodecSpecError(
            f"codec spec {spec!r}: tile must be an integer, "
            f"got {tok!r}") from None
    if tile < 1:
        raise CodecSpecError(f"codec spec {spec!r}: tile must be >= 1")
    return tile


def parse_spec(spec: str) -> CodecSpec:
    """Parse one codec spec string; :class:`CodecSpecError` on junk."""
    if not isinstance(spec, str) or not spec:
        raise CodecSpecError(f"codec spec must be a string, got {spec!r}")
    toks = spec.split(":")
    kind = toks[0]
    if kind in ("int8", "int4"):
        if len(toks) > 2:
            raise CodecSpecError(f"codec spec {spec!r}: expected "
                                 f"{kind}[:tile]")
        tile = _parse_tile(toks[1], spec) if len(toks) == 2 \
            else DEFAULT_TILE
        return CodecSpec(kind=kind, bits=4 if kind == "int4" else 8,
                         tile=tile)
    if kind == "topk":
        if len(toks) != 2:
            raise CodecSpecError(
                f"codec spec {spec!r}: topk needs a kept fraction, "
                "e.g. topk:0.05")
        try:
            frac = float(toks[1])
        except ValueError:
            raise CodecSpecError(
                f"codec spec {spec!r}: fraction must be a float, "
                f"got {toks[1]!r}") from None
        if not 0.0 < frac <= 1.0:
            raise CodecSpecError(
                f"codec spec {spec!r}: fraction must be in (0, 1]")
        return CodecSpec(kind="topk", frac=frac)
    if kind == "delta":
        if len(toks) == 1:
            return CodecSpec(kind="delta", delta_dtype="bfloat16")
        inner = toks[1]
        if inner in ("bf16", "bfloat16"):
            if len(toks) > 2:
                raise CodecSpecError(f"codec spec {spec!r}: bf16 delta "
                                     "takes no tile")
            return CodecSpec(kind="delta", delta_dtype="bfloat16")
        if inner == "int8":
            tile = _parse_tile(toks[2], spec) if len(toks) == 3 \
                else DEFAULT_TILE
            if len(toks) > 3:
                raise CodecSpecError(f"codec spec {spec!r}: expected "
                                     "delta:int8[:tile]")
            return CodecSpec(kind="delta", delta_dtype="int8", tile=tile)
        raise CodecSpecError(
            f"codec spec {spec!r}: delta payload must be bf16 or "
            f"int8, got {inner!r}")
    raise CodecSpecError(
        f"unknown codec kind {kind!r} in spec {spec!r}; known: "
        "int8, int4, topk, delta")


def parse_codec_map(codec) -> dict[str, CodecSpec]:
    """Validate a ``transport.codec`` mapping; returns
    {family: CodecSpec}.  Raises :class:`CodecSpecError` on an unknown
    family, a malformed spec, or a spec outside its family."""
    if codec is None:
        return {}
    if not isinstance(codec, dict):
        raise CodecSpecError(
            f"transport.codec must be a mapping of queue family to "
            f"codec spec, got {type(codec).__name__}")
    out: dict[str, CodecSpec] = {}
    for family, spec in codec.items():
        if family not in CODEC_FAMILIES:
            raise CodecSpecError(
                f"unknown codec family {family!r}; known: "
                f"{'/'.join(CODEC_FAMILIES)}")
        if spec in (None, "", "none"):
            continue
        parsed = parse_spec(spec)
        if parsed.kind not in _FAMILY_KINDS[family]:
            raise CodecSpecError(
                f"codec {parsed.kind!r} is not valid for the "
                f"{family!r} family (allowed: "
                f"{'/'.join(_FAMILY_KINDS[family])})")
        if family == "partial" and parsed.kind == "delta" \
                and parsed.delta_dtype != "int8":
            # the partial delta path is int8-only (the bf16 delta has
            # no tiled quantizer); rejecting here keeps the runtime
            # failure mode — an aggregator dying at flush AFTER
            # consuming its members — out of reach of a legal config
            raise CodecSpecError(
                f"codec spec {spec!r}: the partial family's delta "
                "form must be delta:int8[:tile]")
        out[family] = parsed
    return out
