"""Tiled absmax int8/int4 quantization — the activation/gradient wire
codec (``transport.codec: {intermediate: int8, ...}``).

Port of the JAX package's ``runtime/codec/quant.py``.  The quantizer
runs on the sender's device before the device-to-host fetch, so the
host hop moves codes and the (small) scale vector, not float32; the
receiver dequantizes on its device.  With ``kernels.quantize`` /
``kernels.dequantize`` on, a CUDA leaf goes through the hand-written
kernels (``ops/kernels/quant.py``, ``csrc/quant.cu``); with the flags
off it takes the plain PyTorch chain, the counterpart of the JAX
package's XLA chain.

Numerics: ``x ≈ q * scale`` per tile with ``scale = max|x| / qmax``
(qmax 127 int8, 7 int4); an all-zero tile uses scale 1; a non-finite
tile ships a NaN scale so the receiver's NaN sentinel still fires.

The numpy twins (:func:`quantize_np`, :func:`dequantize_leaf_np`) are
the host-side form of the same codec for payloads already on the host
(the delta codec's UPDATE path).  :func:`quantize_per_tensor_np` is the
legacy per-tensor int8 wire dtype, on the host as in the JAX package;
its leaves decode through the same two functions.
"""

from __future__ import annotations

import numpy as np
import torch

from split_learning_torch.ops.kernels import as_plan
from split_learning_torch.ops.kernels import quant as kquant
from split_learning_torch.runtime.codec.specs import CodecSpec
from split_learning_torch.runtime.protocol import (
    Float0, QuantLeaf, host_tensor,
)


class DevQuant:
    """Device-staged quantized leaf: codes and scales still on the
    device; :meth:`QuantCodec.encode` turns it into a wire
    :class:`QuantLeaf`."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int,
                 tile: int, shape: tuple):
        self.q = q
        self.scale = scale
        self.bits = bits
        self.tile = tile
        self.shape = tuple(int(s) for s in shape)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _quantize_dev(x: torch.Tensor, tile: int, bits: int,
                  kernel: bool = False):
    """(codes, per-tile scales) of one float leaf on its device: the
    fused kernel when ``kernel``, else the plain chain."""
    if kernel:
        return kquant.quantize_tiles(x.contiguous(), tile=tile, bits=bits)
    return kquant.quantize_reference(x, tile, bits)


def _dequantize_dev(q: torch.Tensor, scale: torch.Tensor, tile: int,
                    bits: int, shape: tuple,
                    kernel: bool = False) -> torch.Tensor:
    n = int(np.prod(shape)) if shape else 1
    expect = scale.numel() * tile // (2 if bits == 4 else 1)
    if q.numel() != expect:
        raise ValueError(f"quantized leaf holds {q.numel()} codes, "
                         f"{expect} expected for {scale.numel()} tiles "
                         f"of {tile}")
    if kernel:
        out = kquant.dequantize_tiles(q, scale, tile=tile, bits=bits)
    else:
        out = kquant.dequantize_reference(q, scale, tile, bits)
    return out[:n].reshape(shape)


class QuantCodec:
    """Per-family activation/gradient quantizer (stateless)."""

    name = "quant"
    COUNTERS = ("quant_nonfinite",)

    def __init__(self, spec: CodecSpec, faults=None, kernels=None):
        self.bits = spec.bits
        self.tile = spec.tile
        # explicit kernel plan wins; None defers to the process-wide
        # plan at prepare time (installed by make_codecs)
        self._kernels = kernels
        if faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            faults = default_fault_counters
        self.faults = faults

    def prepare(self, tree, key: str = ""):
        """Device-side stage (training thread): float tensor leaves
        become :class:`DevQuant` holders; bool and int leaves (and a
        :class:`Float0` gradient) pass through."""
        kernel = as_plan(self._kernels).quantize

        def conv(leaf):
            if not (isinstance(leaf, torch.Tensor)
                    and leaf.dtype.is_floating_point):
                return leaf
            q, scale = _quantize_dev(leaf.detach(), self.tile, self.bits,
                                     kernel)
            return DevQuant(q, scale, self.bits, self.tile, leaf.shape)
        return _map(conv, tree)

    def encode(self, prepared):
        """Host-side stage: fetch the staged device tensors and build
        wire :class:`QuantLeaf` leaves."""
        def conv(leaf):
            if isinstance(leaf, DevQuant):
                scale = leaf.scale.cpu().numpy()
                if not np.isfinite(scale).all():
                    # a diverged payload crossed the wire: visible in
                    # the counters, not just in the eventual NaN loss
                    self.faults.inc("quant_nonfinite")
                return QuantLeaf(q=leaf.q.cpu().numpy(), scale=scale,
                                 bits=leaf.bits, tile=leaf.tile,
                                 shape=leaf.shape)
            if isinstance(leaf, Float0):
                # the JAX package's codec sends a float0 cotangent as
                # float32 zeros, not quantized
                return np.zeros(leaf.shape, np.float32)
            if isinstance(leaf, torch.Tensor):
                t = leaf.detach().cpu()
                return t if t.dtype == torch.bfloat16 else t.numpy()
            return leaf
        return _map(conv, prepared)


def dequantize_leaf(leaf: QuantLeaf, device=None,
                    kernels=None) -> torch.Tensor:
    """Wire QuantLeaf -> float32 tensor on ``device`` (receiver hot
    path).  Decode is self-describing (no sender config in scope), so
    the kernel engages through the RECEIVER's plan — the explicit
    ``kernels`` argument, or the process-wide plan."""
    device = torch.device("cpu" if device is None else device)
    if leaf.tile == 0 and leaf.shape is None:
        # the legacy per-tensor form: its own exact computation
        q = host_tensor(np.ascontiguousarray(leaf.q)).to(device)
        return q.to(torch.float32) * float(np.float32(leaf.scale))
    q = host_tensor(np.ascontiguousarray(leaf.q)).to(device)
    scale = host_tensor(np.ascontiguousarray(leaf.scale,
                                             np.float32)).to(device)
    return _dequantize_dev(q, scale, leaf.tile, leaf.bits,
                           tuple(leaf.shape),
                           as_plan(kernels).dequantize)


# -- numpy twins (host-side inputs) ------------------------------------------

def quantize_np(x: np.ndarray, tile: int, bits: int) -> QuantLeaf:
    qmax = kquant.qmax_for(bits)
    flat = np.asarray(x, np.float32).reshape(-1)
    n = flat.size
    t_count = kquant.padded_tiles(n, tile, bits)
    tiles = np.pad(flat, (0, t_count * tile - n)).reshape(-1, tile)
    amax = np.max(np.abs(tiles), axis=1)
    with np.errstate(invalid="ignore"):
        scale = np.where(np.isfinite(amax),
                         np.where(amax > 0, amax / qmax, 1.0),
                         np.nan).astype(np.float32)
        q = np.clip(np.round(tiles / scale[:, None]), -qmax, qmax)
    q = np.nan_to_num(q, nan=0.0).astype(np.int8).reshape(-1)
    if bits == 4:
        u = q.view(np.uint8) & 0xF
        q = (u[0::2] | (u[1::2] << 4)).astype(np.uint8)
    return QuantLeaf(q=q, scale=scale, bits=bits, tile=tile,
                     shape=tuple(int(s) for s in np.shape(x)))


def quantize_per_tensor_np(a: np.ndarray):
    """The legacy per-tensor int8 quantizer (``transport.wire-dtype:
    int8``, behind ``transport.allow-global-lossy``) of one float leaf:
    ``q = round(a / scale)`` with ``scale = max|a| / 127`` (1 for an
    all-zero leaf).  A non-finite leaf ships raw float32, so the
    receiver's NaN sentinel still fires."""
    a32 = np.asarray(a, np.float32)
    amax = float(np.max(np.abs(a32))) if a32.size else 0.0
    if not np.isfinite(amax):
        return a32
    scale = (amax / 127.0) or 1.0
    return QuantLeaf(q=np.round(a32 / scale).astype(np.int8), scale=scale)


def dequantize_leaf_np(leaf: QuantLeaf) -> np.ndarray:
    if leaf.tile == 0 and leaf.shape is None:
        return np.asarray(leaf.q, np.float32) * np.float32(leaf.scale)
    if leaf.bits == 4:
        u = np.asarray(leaf.q, np.uint8)
        codes = np.stack([u & 0xF, u >> 4], axis=-1).reshape(-1).astype(
            np.int32)
        codes = np.where(codes < 8, codes, codes - 16)
    else:
        codes = np.asarray(leaf.q, np.int32)
    flat = codes.astype(np.float32)
    scale = np.asarray(leaf.scale, np.float32)
    n = int(np.prod(leaf.shape)) if leaf.shape else 1
    out = (flat.reshape(-1, leaf.tile) * scale[:, None]).reshape(-1)[:n]
    return out.reshape(leaf.shape)
