"""The dequantizer's two kernel routes (``ops/kernels/quant.py``
``_dequant_route``; ``dequantize_kernel`` and
``dequantize_generic_kernel`` in ``csrc/quant.cu``): which route a tile
width, code width and codes pointer take, the vec kernel's tile
indexing and code widening emulated in numpy and held bit for bit
against the JAX package's ``dequantize_tiles`` (its Pallas kernel run
through the interpreter) and the port's plain version, and the
wrapper's refusals before any launch.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_torch.ops.kernels import quant as kq

jq = importlib.import_module("split_learning_tpu.ops.kernels.quant")

BASE = 0x7F0000000000   # a 16-byte aligned device address


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("tile", [7, 16, 32, 64, 256, 1024])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_route(bits, tile, offset):
    """The vec kernel takes a tile of whole 16-byte code chunks (16 int8
    or 32 int4 codes, so no chunk straddles two tiles) of 16-byte
    aligned codes; everything else the generic kernel.  Every route has
    its own launch count."""
    whole = tile % (16 if bits == 8 else 32) == 0
    want = "vec" if whole and offset == 0 else "generic"
    assert kq._dequant_route(tile, bits, BASE + offset) == want
    assert kq.DEQUANT_ROUTES[want] in kq.LAUNCHES


def test_every_dequant_route_is_counted():
    assert set(kq.DEQUANT_ROUTES) == {"vec", "generic"}
    assert all(name in kq.LAUNCHES for name in kq.DEQUANT_ROUTES.values())


def vec_dequantize_np(codes: np.ndarray, scales: np.ndarray, tile: int,
                      bits: int) -> np.ndarray:
    """The vec kernel's arithmetic: float4 f of the output holds codes 4f
    to 4f + 3, which are word f (int8: bytes low first) or halfword f
    (int4: nibbles low first) of the little-endian code array, in tile
    4f >> shift (a power-of-two tile) or 4f // tile; each code is
    widened by sign-extending shifts and multiplied in float32."""
    raw = codes.tobytes()
    if bits == 8:
        units = np.frombuffer(raw, np.uint32)
        lanes = [(units << np.uint32(24 - 8 * b)).view(np.int32) >> 24
                 for b in range(4)]
    else:
        top = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        lanes = [(top << np.uint32(12 - 4 * j)).view(np.int32) >> 28
                 for j in range(4)]
    code = 4 * np.arange(lanes[0].size)
    shift = tile.bit_length() - 1
    tiles = code >> shift if 1 << shift == tile else code // tile
    out = np.stack([x.astype(np.float32) for x in lanes], axis=-1)
    return (out * scales[tiles][:, None]).reshape(-1)


def _codes(bits: int, t_count: int, tile: int, rng) -> np.ndarray:
    """Random codes with the extremes: -127 and 127 (int8), -8 and 7
    (int4 nibbles), packed as the wire holds them."""
    n = t_count * tile
    if bits == 8:
        c = rng.integers(-127, 128, n).astype(np.int8)
        c[:4] = [-127, 127, 0, -1]
        return c
    c = rng.integers(-8, 8, n).astype(np.int8)
    c[:4] = [-8, 7, 0, -1]
    u = c.view(np.uint8) & 0xF
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit for bit, NaNs compared as NaN (their payloads are the
    producer's own)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return (a.shape == b.shape and np.array_equal(nan, np.isnan(b))
            and np.array_equal(a[~nan].view(np.uint32),
                               b[~nan].view(np.uint32)))


@pytest.mark.parametrize("tile", [32, 256, 96])
@pytest.mark.parametrize("bits", [8, 4])
def test_vec_kernel_emulation_matches_jax_and_plain(bits, tile):
    """float4 to tile to scale indexing (power-of-two tiles, by a shift,
    and a tile of 96, by a division) and the widening, bit for bit
    against the JAX
    Pallas dequantizer and the port's plain version, with a NaN-scale
    tile and a negative scale."""
    rng = np.random.default_rng(tile + bits)
    t_count = 6
    codes = _codes(bits, t_count, tile, rng)
    scales = (rng.random(t_count) * 0.1 + 1e-3).astype(np.float32)
    scales[2] = np.nan
    scales[4] = -scales[4]
    got = vec_dequantize_np(codes, scales, tile, bits)
    want_j = np.asarray(jq.dequantize_tiles(
        jnp.asarray(codes), jnp.asarray(scales), tile=tile, bits=bits,
        interpret=True))
    want_t = kq.dequantize_reference(torch.from_numpy(codes),
                                     torch.from_numpy(scales), tile,
                                     bits).numpy()
    assert _same(got, want_j.reshape(-1))
    assert _same(got, want_t)
    assert np.isnan(got[2 * tile:3 * tile]).all()
    assert not np.isnan(np.delete(got, np.s_[2 * tile:3 * tile])).any()


@pytest.mark.parametrize("bits", [8, 4])
def test_widening_of_the_extreme_codes(bits):
    """One chunk of the extreme codes, scale 1: int8 -127 and 127 (and
    -128, which the quantizer never writes), int4 -8 and 7, each at
    every position of a word."""
    vals = ([-127, 127, -128, 1] if bits == 8 else [-8, 7, -1, 0, 1, -7,
                                                     3, -4])
    per = 16 if bits == 8 else 32
    c = np.resize(np.array(vals, np.int8), per)
    if bits == 4:
        u = c.view(np.uint8) & 0xF
        c = (u[0::2] | (u[1::2] << 4)).astype(np.uint8)
    got = vec_dequantize_np(c, np.ones(1, np.float32), per, bits)
    assert np.array_equal(got, np.resize(np.array(vals, np.float32), per))


def _refuse(monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(kq, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(kq, "_library", no_library)
    kq.reset_launches()


@pytest.mark.parametrize("fault", ["int8 codes for int4", "code count",
                                   "2-D codes", "float64 scales",
                                   "2-D scales", "non-contiguous codes"])
def test_wrapper_raises_before_any_launch(monkeypatch, fault):
    """Codes or scales a kernel does not take raise before the library
    is loaded, on either route, and no launch is counted."""
    _refuse(monkeypatch)
    bits = 4 if fault == "int8 codes for int4" else 8
    q = torch.zeros(4 * 256 // (2 if bits == 4 else 1),
                    dtype=torch.uint8 if bits == 4 else torch.int8)
    s = torch.ones(4)
    if fault == "int8 codes for int4":
        q = q.view(torch.int8)
    elif fault == "code count":
        q = q[:-16]
    elif fault == "2-D codes":
        q = q.view(4, 256)
    elif fault == "float64 scales":
        s = s.double()
    elif fault == "2-D scales":
        s = s.view(2, 2)
    else:
        q = torch.zeros(2 * q.numel(), dtype=q.dtype)[::2]
    with pytest.raises(ValueError):
        kq.dequantize_tiles(q, s, tile=256, bits=bits)
    assert not any(kq.LAUNCHES.values())


def test_vec_launch_refuses_other_shapes(monkeypatch):
    """Forcing the vec kernel on codes it does not take (a tile that
    splits a chunk, codes off 16-byte alignment) raises before the
    library is loaded."""
    _refuse(monkeypatch)
    s = torch.ones(4)
    with pytest.raises(ValueError, match="vec dequantizer does not take"):
        kq._launch_dequantize("vec", torch.zeros(4 * 24, dtype=torch.int8),
                              s, 24, 8)
    shifted = torch.zeros(4 * 256 + 1, dtype=torch.int8)[1:]
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="vec dequantizer does not take"):
        kq._launch_dequantize("vec", shifted, s, 256, 8)
    assert not any(kq.LAUNCHES.values())


class _FailingLibrary:
    """A kernel library whose every entry point reports a CUDA error
    (700) and records that it was called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 700
        return entry


@pytest.mark.parametrize("offset,route", [(0, "vec"), (1, "generic")])
def test_failed_launch_raises_and_never_falls_back(monkeypatch, offset,
                                                   route):
    """A dequantize launch that fails raises at once: the wrapper reaches
    its route's one entry point, tries no other, and counts nothing."""
    lib = _FailingLibrary()
    monkeypatch.setattr(kq, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(kq, "_library", lambda: lib)
    monkeypatch.setattr(kq, "_stream", lambda t: None)
    kq.reset_launches()
    q = torch.zeros(4 * 256 + offset, dtype=torch.int8)[offset:]
    name = kq.DEQUANT_ROUTES[route]
    with pytest.raises(RuntimeError, match=f"{name} kernel launch failed"):
        kq.dequantize_tiles(q, torch.ones(4), tile=256, bits=8)
    assert lib.calls == ["slt_dequantize" if route == "vec"
                         else "slt_dequantize_generic"]
    assert not any(kq.LAUNCHES.values())
