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

The quantizer has two CUDA kernels, and :func:`_quant_route` picks one
from the leaf's dtype, the tile width and the leaf's alignment alone:
``"vec"`` (``quantize_kernel``, one warp per tile held in registers,
16-byte loads; counted as ``LAUNCHES["quantize"]``) for a tile of 512,
1024, 2048 or 4096 bytes and at most 1024 values on a 16-byte aligned
leaf — at the wire's tile 256, every bf16, fp16 and float32 leaf — and
``"generic"`` (``quantize_generic_kernel``, any tile up to
:data:`GENERIC_MAX_TILE` and any alignment: a block stages a span of
whole tiles in shared memory with 16-byte copies from the aligned-down
address and reads the leaf once, a tile wider than the span twice;
counted as ``LAUNCHES["quantize_generic"]``) otherwise — the wire-slow
codec's tile 64 on every frame.

The dequantizer has two CUDA kernels too, and :func:`_dequant_route`
picks one from the tile width, the code width and the codes' alignment
alone: ``"vec"`` (``dequantize_kernel``: 16-byte loads of whole code
chunks, restaged in shared memory so that a warp's stores are
contiguous; counted as ``LAUNCHES["dequantize"]``) when a tile holds a
whole number of 16-byte chunks (``tile % 16 == 0`` for int8,
``tile % 32 == 0`` for int4) of 16-byte aligned codes — the wire's tile
256 on the codes a frame decodes into — and ``"generic"``
(``dequantize_generic_kernel``: the same design at any tile, with the
16-byte chunks realigned from the aligned-down address; counted as
``LAUNCHES["dequantize_generic"]``) otherwise.

Each wrapper takes the plain version (``*_reference``) only because the
tensor it was given lies on the CPU; for a CUDA tensor it launches a
kernel or raises.  Each launch adds one to its entry in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of each CUDA kernel since the last :func:`reset_launches`
LAUNCHES = {"quantize": 0, "quantize_generic": 0, "dequantize": 0,
            "dequantize_generic": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
#: quantizer route -> its kernel's entry in :data:`LAUNCHES`
QUANT_ROUTES = {"vec": "quantize", "generic": "quantize_generic"}
#: dequantizer route -> its kernel's entry in :data:`LAUNCHES`
DEQUANT_ROUTES = {"vec": "dequantize", "generic": "dequantize_generic"}
#: codes in one 16-byte chunk, by code width
CHUNK_CODES = {8: 16, 4: 32}
#: the widest tile (values) the vec route holds in registers: at 1024 a
#: float32 tile is 8 chunks a lane, twice over (the next tile's loads go
#: out before the current one's codes), 64 registers of data
VEC_MAX_TILE = 1024
#: the widest tile (values) the generic quantizer takes
GENERIC_MAX_TILE = (2**31 - 1) // 8


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
        for fn in (lib.slt_quantize, lib.slt_quantize_generic):
            fn.argtypes = [i, p, ll, i, ll, i, p, p, p]
            fn.restype = ctypes.c_int
        for fn in (lib.slt_dequantize, lib.slt_dequantize_generic):
            fn.argtypes = [p, p, ll, i, i, p, p]
            fn.restype = ctypes.c_int
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


def _quant_route(dtype: torch.dtype, tile: int, data_ptr: int) -> str:
    """The quantizer kernel for a leaf of ``dtype`` at ``data_ptr``:
    ``"vec"`` when a tile is one, two, four or eight 16-byte chunks a
    lane of a warp (``tile * itemsize`` of 512, 1024, 2048 or 4096
    bytes), at most :data:`VEC_MAX_TILE` values, and the leaf is 16-byte
    aligned; ``"generic"`` otherwise.  The code width takes no part: a
    vec tile is even, so its 16-byte chunks hold whole int4 code pairs
    and int4 adds no tile of padding."""
    chunks, rest = divmod(tile * _ITEMSIZE[dtype], 512)
    if (rest == 0 and chunks in (1, 2, 4, 8) and tile <= VEC_MAX_TILE
            and data_ptr % 16 == 0):
        return "vec"
    return "generic"


def _launch_quantize(route: str, x: torch.Tensor, tile: int, bits: int):
    """Launch the quantizer kernel of ``route`` on a checked CUDA leaf;
    ``(codes, scales)``."""
    n = x.numel()
    t_count = padded_tiles(n, tile, bits)
    if t_count == 0:
        raise ValueError("the quantize kernel needs a non-empty leaf")
    if route == "vec" and _quant_route(x.dtype, tile,
                                       x.data_ptr()) != "vec":
        raise ValueError(f"the vec quantizer does not take {x.dtype} at "
                         f"tile {tile} from {x.data_ptr():#x}")
    if tile > GENERIC_MAX_TILE:
        raise ValueError(f"the quantizer takes tiles of at most "
                         f"{GENERIC_MAX_TILE} values, got {tile}")
    n_codes = t_count * tile // (2 if bits == 4 else 1)
    codes = torch.empty(n_codes, device=x.device,
                        dtype=torch.int8 if bits == 8 else torch.uint8)
    scales = torch.empty(t_count, device=x.device, dtype=torch.float32)
    lib = _library()
    fn = lib.slt_quantize if route == "vec" else lib.slt_quantize_generic
    name = QUANT_ROUTES[route]
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), n, tile, t_count, bits,
             codes.data_ptr(), scales.data_ptr(), _stream(x))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return codes, scales


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
    return _launch_quantize(_quant_route(x.dtype, tile, x.data_ptr()), x,
                            tile, bits)


def _dequant_route(tile: int, bits: int, codes_ptr: int) -> str:
    """The dequantizer kernel for codes of ``bits`` at ``codes_ptr`` in
    tiles of ``tile``: ``"vec"`` when a tile is a whole number of
    16-byte code chunks (16 int8 or 32 int4 codes each, so no chunk
    straddles two tiles) and the codes are 16-byte aligned; ``"generic"``
    otherwise."""
    if tile % CHUNK_CODES[bits] == 0 and codes_ptr % 16 == 0:
        return "vec"
    return "generic"


def _launch_dequantize(route: str, q: torch.Tensor, scale: torch.Tensor,
                       tile: int, bits: int) -> torch.Tensor:
    """Launch the dequantizer kernel of ``route`` on checked CUDA codes
    and scales; the flat ``(T * tile,)`` float32 values."""
    if route == "vec" and _dequant_route(tile, bits, q.data_ptr()) != "vec":
        raise ValueError(f"the vec dequantizer does not take int{bits} "
                         f"codes at tile {tile} from {q.data_ptr():#x}")
    t_count = scale.numel()
    out = torch.empty(t_count * tile, device=q.device, dtype=torch.float32)
    lib = _library()
    fn = lib.slt_dequantize if route == "vec" else lib.slt_dequantize_generic
    name = DEQUANT_ROUTES[route]
    err = fn(q.data_ptr(), scale.data_ptr(), t_count, tile, bits,
             out.data_ptr(), _stream(q))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


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
    if bits == 4 and t_count * tile % 2:
        raise ValueError(f"int4 codes pair up: {t_count} tiles of {tile} "
                         "are an odd code count")
    if scale.dtype != torch.float32 or scale.dim() != 1:
        raise ValueError(f"expected (T,) float32 scales, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("the dequantize kernel needs contiguous inputs")
    return _launch_dequantize(_dequant_route(tile, bits, q.data_ptr()), q,
                              scale, tile, bits)
