"""Fused tiled-absmax quantize / dequantize: hand-written CUDA kernels
(``csrc/quant.cu``) and their plain PyTorch versions.

Port of the JAX package's ``ops/kernels/quant.py``.  The JAX wrapper
takes the already padded ``(T, tile)`` float32 array; here the padding is
folded into the kernel, which reads the leaf in its own dtype and masks
the ragged tail, so :func:`quantize_tiles` takes the flat leaf.  Codes
and scales come back in the JAX package's shapes: the flat padded code
array (int8, or uint8 nibble pairs half as long for int4) and the
``(T,)`` float32 scales.  :func:`dequantize_tiles` returns the flat
``(T * tile,)`` float32 values; the caller slices off the padding.

Numerics (the oracle's, bit for bit): ``scale = amax / qmax`` (qmax 127
int8 / 7 int4), an all-zero tile gets scale 1, a non-finite tile a NaN
scale and zero codes; codes round half to even and clip; int4 codes are
two's-complement nibbles, low nibble first.

Each wrapper takes the plain version (``*_reference``) only because the
tensor it was given lies on the CPU; for a CUDA tensor it launches the
kernel or raises.  Each launch adds one to its entry in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of each CUDA kernel since the last :func:`reset_launches`
LAUNCHES = {"quantize": 0, "dequantize": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def qmax_for(bits: int) -> float:
    return 127.0 if bits == 8 else 7.0


def padded_tiles(n: int, tile: int, bits: int) -> int:
    """Tile count T of an n-value leaf: zero-padded to whole tiles and,
    for int4, to an even code count (one more tile of zeros when the
    tile width is odd) — ``codec/quant.py``'s padding rule."""
    pad = (-n) % tile
    if bits == 4 and (n + pad) % 2:
        pad += tile
    return max(1, (n + pad) // tile) if n + pad else 0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def quantize_reference(x: torch.Tensor, tile: int, bits: int):
    """Plain PyTorch chain: ``(codes, scales)`` of one float leaf."""
    qmax = qmax_for(bits)
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    t_count = padded_tiles(n, tile, bits)
    tiles = torch.nn.functional.pad(flat, (0, t_count * tile - n)).reshape(
        t_count, tile)
    finite = torch.isfinite(tiles).all(dim=1)
    amax = tiles.abs().amax(dim=1)
    # divide by a device tensor: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which is not the oracle's division
    q_t = torch.tensor(qmax, dtype=torch.float32, device=x.device)
    scale = torch.where(amax > 0, amax / q_t, torch.ones_like(amax))
    scale = torch.where(finite, scale, torch.full_like(scale, float("nan")))
    codes = torch.clamp(torch.round(tiles / scale[:, None]), -qmax, qmax)
    # non-finite tile (NaN scale): codes 0, the scale alone carries the
    # divergence
    q = torch.where(torch.isnan(codes), torch.zeros_like(codes),
                    codes).to(torch.int8).reshape(-1)
    if bits == 4:
        u = q.view(torch.uint8) & 0xF     # two's-complement nibbles
        q = u[0::2] | (u[1::2] << 4)
    return q, scale


def dequantize_reference(q: torch.Tensor, scale: torch.Tensor, tile: int,
                         bits: int) -> torch.Tensor:
    """Plain PyTorch chain: flat ``(T * tile,)`` float32 values."""
    if bits == 4:
        u = q.view(torch.uint8).to(torch.int32)
        codes = torch.stack([u & 0xF, u >> 4], dim=-1).reshape(-1)
        codes = torch.where(codes < 8, codes, codes - 16)
    else:
        codes = q
    return (codes.to(torch.float32).reshape(-1, tile)
            * scale[:, None]).reshape(-1)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _library():
    from split_learning_torch.ops.kernels.build import load
    lib = load("quant")
    if not getattr(lib, "_slt_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.slt_quantize.argtypes = [i, p, ll, i, ll, i, p, p, p]
        lib.slt_dequantize.argtypes = [p, p, ll, i, i, p, p]
        lib.slt_quantize.restype = ctypes.c_int
        lib.slt_dequantize.restype = ctypes.c_int
        lib._slt_typed = True
    return lib


def _on_cpu(*tensors) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"quantizer inputs span devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"the quantizer has no kernel for {dev}")
    return False


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check_args(tile: int, bits: int) -> None:
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")


def quantize_tiles(x: torch.Tensor, *, tile: int, bits: int):
    """One pass: ``(codes, scales)`` of a float leaf (any shape, float32,
    bfloat16 or float16, contiguous)."""
    _check_args(tile, bits)
    if _on_cpu(x):
        return quantize_reference(x, tile, bits)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the quantize kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the quantize kernel needs a contiguous leaf")
    n = x.numel()
    t_count = padded_tiles(n, tile, bits)
    if t_count == 0:
        raise ValueError("the quantize kernel needs a non-empty leaf")
    n_codes = t_count * tile // (2 if bits == 4 else 1)
    codes = torch.empty(n_codes, device=x.device,
                        dtype=torch.int8 if bits == 8 else torch.uint8)
    scales = torch.empty(t_count, device=x.device, dtype=torch.float32)
    err = _library().slt_quantize(
        _DTYPE_CODE[x.dtype], x.data_ptr(), n, tile, t_count, bits,
        codes.data_ptr(), scales.data_ptr(), _stream(x))
    _raise_on(err, "quantize")
    LAUNCHES["quantize"] += 1
    return codes, scales


def dequantize_tiles(q: torch.Tensor, scale: torch.Tensor, *, tile: int,
                     bits: int) -> torch.Tensor:
    """Mirror pass: flat codes + ``(T,)`` scales -> flat ``(T * tile,)``
    float32 (the caller slices off the padding and reshapes)."""
    _check_args(tile, bits)
    if _on_cpu(q, scale):
        return dequantize_reference(q, scale, tile, bits)
    t_count = scale.numel()
    want = t_count * tile // (2 if bits == 4 else 1)
    want_dt = torch.int8 if bits == 8 else torch.uint8
    if q.dtype != want_dt or q.numel() != want or q.dim() != 1:
        raise ValueError(f"expected {want} {want_dt} codes for {t_count} "
                         f"tiles of {tile}, got {tuple(q.shape)} {q.dtype}")
    if scale.dtype != torch.float32 or scale.dim() != 1:
        raise ValueError(f"expected (T,) float32 scales, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("the dequantize kernel needs contiguous inputs")
    out = torch.empty(t_count * tile, device=q.device, dtype=torch.float32)
    err = _library().slt_dequantize(
        q.data_ptr(), scale.data_ptr(), t_count, tile, bits,
        out.data_ptr(), _stream(q))
    _raise_on(err, "dequantize")
    LAUNCHES["dequantize"] += 1
    return out
