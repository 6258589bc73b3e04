"""The port's tiled int8/int4 wire codec against the JAX package's, on the
CPU.

The same inputs, made from a seed with numpy, go through the JAX
package's device codec (``_quantize_dev``/``_dequantize_dev``, with
``kernel_block`` 0 — the XLA chain — and 128 — the Pallas kernels under
the interpreter) and its numpy twins, and through the port's plain
versions (what its CUDA kernels are held against on the card).  Codes,
scales and dequantized values are compared as raw bytes (NaN scales
included) against the numpy twins, which divide in IEEE float32 as the
port's kernels do.  Against the device chain and its Pallas kernels the
scales are within one ulp, and the codes equal in every tile whose scale
is bit-equal and at most one step apart elsewhere: measured, XLA:CPU
turns ``amax / qmax`` (a division by a constant) into a multiply by the
reciprocal, which rounds differently for some tiles (32 of the 715 tiles
of the 5000-value, tile-7 case), and a quotient at a .5 boundary can
then round the other way.  Dequantizing the same codes and scales is
bitwise in both.
Cases: an all-zero tile, a NaN tile, an inf tile, a ragged length, tile
256, an odd tile 7 (int4 pairs straddle tiles), and a bf16 leaf; then
the CUDA quantizer's route function (which of its two kernels a leaf
takes, from dtype, tile and alignment) and the shapes the chip check
holds each route on: rounding ties, tiles 1024 and 2048, fp16, ragged
leaves at tile 256, and a tile whose scale underflows to zero.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from split_learning_tpu.runtime.codec import quant as jq
from split_learning_tpu.runtime.codec import wire_raw_nbytes as j_raw
from split_learning_tpu.runtime.protocol import QuantLeaf as JQuantLeaf
from split_learning_torch.ops import kernels as kplane
from split_learning_torch.ops.kernels import quant as kq
from split_learning_torch.runtime.codec import make_codecs
from split_learning_torch.runtime.codec import quant as tq
from split_learning_torch.runtime.codec import wire_raw_nbytes as t_raw


def _leaf(n: int, tile: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    x[:tile] = 0.0                       # an all-zero tile
    if n > 4 * tile:
        x[2 * tile + 1] = np.nan         # a NaN tile
        x[3 * tile + 2] = np.inf         # an inf tile
    return x


def _bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.contiguous().numpy().tobytes()
    return np.asarray(a).tobytes()


CASES = [(n, tile) for tile in (256, 7, 64) for n in (5000, 8 * tile, 13)]


def _codes(q, bits: int) -> np.ndarray:
    q = np.asarray(q.numpy() if isinstance(q, torch.Tensor) else q)
    if bits == 8:
        return q.astype(np.int32)
    u = q.view(np.uint8).astype(np.int32)
    c = np.stack([u & 0xF, u >> 4], axis=-1).reshape(-1)
    return np.where(c < 8, c, c - 16)


def _match_device_chain(q, s, jcodes, jscale, tile: int, bits: int) -> None:
    """Scales within one ulp of the device chain's; codes equal in every
    tile whose scale is bit-equal, and at most one step apart in a tile
    whose scale is not (the quotient can round the other way at .5)."""
    a, b = s.numpy(), np.asarray(jscale)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    fin = ~np.isnan(a)
    np.testing.assert_array_max_ulp(a[fin], b[fin], maxulp=1)
    same = (a.view(np.uint32) == b.view(np.uint32))
    diff = np.abs(_codes(q, bits) - _codes(jcodes, bits)).reshape(-1, tile)
    assert not diff[same].any()
    assert diff.max(initial=0) <= 1


@pytest.mark.parametrize("n,tile", CASES)
@pytest.mark.parametrize("kernel_block", [0, 128])
def test_int8_matches_jax_codec(n, tile, kernel_block):
    x = _leaf(n, tile, seed=n + tile)
    q, s = tq._quantize_dev(torch.from_numpy(x), tile, 8)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    # the numpy twin divides like the port: codes and scales bitwise
    ref = jq.quantize_np(x, tile, 8)
    assert _bytes(q) == _bytes(ref.q) and _bytes(s) == _bytes(ref.scale)
    # the device chain and its Pallas kernel: scales may sit one ulp off
    # (XLA:CPU divides amax by the constant qmax as a multiply by its
    # reciprocal), and a code in such a tile one step off
    jcodes, jscale = jq._quantize_dev(jnp.asarray(x), tile, 8,
                                      kernel_block=kernel_block)
    _match_device_chain(q, s, jcodes, jscale, tile, 8)
    # dequantize the same codes and scales: bitwise
    jd = jq._dequantize_dev(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                            tile, 8, n, (n,), kernel_block=kernel_block)
    d = tq._dequantize_dev(q, s, tile, 8, (n,))
    assert _bytes(d) == _bytes(jd)


@pytest.mark.parametrize("n,tile", CASES)
def test_int4_matches_numpy_twin(n, tile):
    x = _leaf(n, tile, seed=3 * n + tile)
    ref = jq.quantize_np(x, tile, 4)
    q, s = tq._quantize_dev(torch.from_numpy(x), tile, 4)
    assert q.dtype == torch.uint8
    assert _bytes(q) == _bytes(ref.q)
    assert _bytes(s) == _bytes(ref.scale)
    # and the JAX package's device chain packs the same nibbles
    jcodes, jscale = jq._quantize_dev(jnp.asarray(x), tile, 4)
    _match_device_chain(q, s, jcodes, jscale, tile, 4)
    d = tq._dequantize_dev(q, s, tile, 4, (n,))
    assert _bytes(d) == _bytes(jq.dequantize_leaf_np(ref))


@pytest.mark.parametrize("bits", [8, 4])
def test_numpy_twins_match(bits):
    x = _leaf(3001, 7, seed=bits).reshape(3001)
    a, b = tq.quantize_np(x, 7, bits), jq.quantize_np(x, 7, bits)
    assert _bytes(a.q) == _bytes(b.q) and _bytes(a.scale) == _bytes(b.scale)
    assert a.shape == b.shape and a.bits == b.bits and a.tile == b.tile
    assert _bytes(tq.dequantize_leaf_np(a)) == _bytes(
        jq.dequantize_leaf_np(b))


@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_leaf_matches(bits):
    """A bf16 activation quantizes from its own bits (the kernel reads
    bf16 directly; the JAX chain casts to float32 first)."""
    rng = np.random.default_rng(9)
    words = (rng.standard_normal((4, 256, 32)) * 2).astype(
        ml_dtypes.bfloat16)
    words.reshape(-1)[700] = np.nan
    jx = jnp.asarray(words)
    tx = torch.from_numpy(words.view(np.int16).copy()).view(torch.bfloat16)
    jcodes, jscale = jq._quantize_dev(jx, 256, bits)
    q, s = tq._quantize_dev(tx, 256, bits)
    ref = jq.quantize_np(np.asarray(words, np.float32), 256, bits)
    assert _bytes(q) == _bytes(ref.q) and _bytes(s) == _bytes(ref.scale)
    _match_device_chain(q, s, jcodes, jscale, 256, bits)
    # the kernel flag takes the same plain version for a CPU tensor
    qk, sk = tq._quantize_dev(tx, 256, bits, kernel=True)
    assert torch.equal(qk, q) and _bytes(sk) == _bytes(s)


def test_codec_round_trip_and_counters(tmp_path):
    """prepare/encode/dequantize_leaf through both packages' codecs; a
    non-finite payload counts ``quant_nonfinite``; int leaves pass."""
    from split_learning_torch.config import from_dict
    from split_learning_torch.runtime.trace import FaultCounters
    cfg = from_dict({"transport": {"codec": {"intermediate": "int4:64",
                                             "gradient": "int8"}},
                     "kernels": {"quantize": True, "dequantize": True},
                     "log-path": str(tmp_path)})
    faults = FaultCounters()
    with kplane.override():   # make_codecs installs the config's plan
        codecs = make_codecs(cfg, faults=faults)
        assert kplane.plan().quantize and kplane.plan().dequantize
    assert set(codecs) == {"intermediate", "gradient"}
    assert (codecs["intermediate"].bits, codecs["intermediate"].tile) == (
        4, 64)
    x = _leaf(1000, 64, seed=5).reshape(10, 100)
    ids = np.arange(6, dtype=np.int32)
    tree = {"h": torch.from_numpy(x), "ids": torch.from_numpy(ids)}
    wire = codecs["intermediate"].encode(
        codecs["intermediate"].prepare(tree))
    assert isinstance(wire["h"], tq.QuantLeaf) and wire["h"].shape == (10,
                                                                       100)
    assert wire["ids"].dtype == np.int32
    assert faults.snapshot() == {"quant_nonfinite": 1}
    back = tq.dequantize_leaf(wire["h"])
    ref = jq.dequantize_leaf(JQuantLeaf(
        q=wire["h"].q, scale=wire["h"].scale, bits=4, tile=64,
        shape=(10, 100)))
    assert _bytes(back) == _bytes(np.asarray(ref))


def test_unported_codecs_raise_and_raw_bytes(tmp_path):
    from split_learning_torch.config import from_dict
    for codec in ({"gradient": "topk:0.05"}, {"rpc": "delta"}):
        cfg = from_dict({"transport": {"codec": codec},
                         "log-path": str(tmp_path)})
        with pytest.raises(NotImplementedError, match="not ported"):
            make_codecs(cfg)
    rng = np.random.default_rng(2)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    i = rng.integers(0, 9, (7,)).astype(np.int64)
    assert t_raw({"a": torch.from_numpy(f), "b": [torch.from_numpy(i)]},
                 torch.bfloat16) == j_raw(
        {"a": jnp.asarray(f), "b": [np.asarray(i)]}, ml_dtypes.bfloat16)


def test_padding_rule_matches():
    """Tile counts of the padded code array: int4 with an odd tile adds
    a tile of zeros to keep the code count even."""
    for n, tile, bits in ((13, 7, 4), (14, 7, 4), (13, 7, 8), (1, 256, 4),
                          (4096, 256, 4)):
        ref = jq.quantize_np(np.ones(n, np.float32), tile, bits)
        assert kq.padded_tiles(n, tile, bits) == ref.scale.size


# -- the quantizer's kernel routes ------------------------------------------

# (dtype, tile, byte offset of the leaf, route): a tile of 512, 1024, 2048
# or 4096 bytes and at most 1024 values, on a 16-byte aligned leaf, takes
# the vec kernel; everything else the generic one
ROUTES = [
    (torch.bfloat16, 256, 0, "vec"), (torch.float16, 256, 0, "vec"),
    (torch.float32, 256, 0, "vec"), (torch.float32, 128, 0, "vec"),
    (torch.bfloat16, 512, 0, "vec"), (torch.bfloat16, 1024, 0, "vec"),
    (torch.float32, 1024, 0, "vec"),
    (torch.bfloat16, 64, 0, "generic"),     # 128 B: part of a warp load
    (torch.bfloat16, 128, 0, "generic"),
    (torch.float32, 64, 0, "generic"),
    (torch.bfloat16, 768, 0, "generic"),    # three chunks a lane
    (torch.bfloat16, 2048, 0, "generic"),   # past the register cap
    (torch.float32, 2048, 0, "generic"),
    (torch.float32, 7, 0, "generic"),
    (torch.bfloat16, 256, 2, "generic"),    # off 16-byte alignment
    (torch.float32, 256, 4, "generic"),
    (torch.float16, 256, 8, "generic"),
    (torch.float32, 256, 32, "vec"),
]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype,tile,offset,route", ROUTES)
def test_quant_route(dtype, tile, offset, route, bits):
    """The route depends on dtype, tile and alignment alone.  The code
    width takes no part because a vec tile holds whole int4 code pairs:
    it is even, so int4 pads a leaf to the same tiles as int8."""
    assert kq._quant_route(dtype, tile, 0x7f0000000000 + offset) == route
    assert kq.QUANT_ROUTES[route] in kq.LAUNCHES
    if route == "vec":
        for n in (1, tile - 1, 3 * tile + 1):
            assert kq.padded_tiles(n, tile, bits) == -(-n // tile)


def test_vec_launch_refuses_other_shapes():
    """Forcing the vec kernel on a shape it does not take raises before
    anything is built or launched; a CPU leaf takes the plain version
    and launches nothing."""
    x = torch.zeros(4096, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="vec quantizer does not take"):
        kq._launch_quantize("vec", x, 64, 8)
    kq.reset_launches()
    q, s = kq.quantize_tiles(x, tile=256, bits=8)
    assert q.shape == (4096,) and s.shape == (16,)
    assert not any(kq.LAUNCHES.values())


def _ties(qmax: float) -> np.ndarray:
    """A tile of amax qmax (scale exactly 1) holding values half-way
    between two codes: round half to even gives 2, -2, 4, -4, 0, 0, 2."""
    t = np.array([2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5] * 32,
                 np.float32)
    t[7] = qmax
    return t


def _edge_leaf(case: str, bits: int):
    """The chip check's phase-3 shapes at a CPU size: (float32 values,
    the dtype the port quantizes them in, tile)."""
    rng = np.random.default_rng(len(case) + bits)
    if case.startswith("ties"):
        x = _ties(127.0 if bits == 8 else 7.0)
        return x, (torch.bfloat16 if "bf16" in case else torch.float32), 256
    tile = {"tile 1024": 1024, "tile 2048": 2048}.get(case[:9], 256)
    n = 2 * tile + 77 if "ragged" in case else 2 * tile
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    x[tile + 5] = np.nan
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16}.get(
        case.split()[-1], torch.float32)
    return x, dtype, tile


EDGE_CASES = ["ties bf16", "ties f32", "tile 1024 bf16", "tile 1024 f32",
              "tile 2048 bf16", "fp16", "ragged bf16", "ragged f32"]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_route_shapes_match_jax_codec(case, bits):
    """The shapes the two kernel routes are held on: the port's plain
    version bitwise against the numpy twin, and against the JAX device
    chain at the file's tolerances (scales within one ulp, codes one
    step off at most where a scale differs)."""
    x, dtype, tile = _edge_leaf(case, bits)
    tx = torch.from_numpy(x).to(dtype)
    xf = tx.float().numpy()          # the values the port quantizes
    q, s = tq._quantize_dev(tx, tile, bits)
    ref = jq.quantize_np(xf, tile, bits)
    assert _bytes(q) == _bytes(ref.q) and _bytes(s) == _bytes(ref.scale)
    jcodes, jscale = jq._quantize_dev(jnp.asarray(xf), tile, bits)
    _match_device_chain(q, s, jcodes, jscale, tile, bits)
    if case.startswith("ties"):
        assert s.tolist() == [1.0]
        assert _codes(q, bits)[:8].tolist() == [2, -2, 4, -4, 0, 0, 2,
                                                int(x[7])]
    d = tq._dequantize_dev(q, s, tile, bits, (x.size,))
    assert _bytes(d) == _bytes(jq.dequantize_leaf_np(ref))


@pytest.mark.parametrize("bits", [8, 4])
def test_zero_scale_tile_matches_numpy_twin(bits):
    """A float32 tile whose amax / qmax underflows to a zero scale: the
    port divides in IEEE float32 as the numpy twin does (nonzero values
    clip to +-qmax, zeros give 0).  The JAX device chain on the CPU
    treats these subnormal inputs as zeros (scale 1, codes 0), so it is
    not the oracle here."""
    x = np.zeros(256, np.float32)
    x[:4] = [3e-45, -3e-45, 1.4e-45, -0.0]
    q, s = tq._quantize_dev(torch.from_numpy(x), 256, bits)
    ref = jq.quantize_np(x, 256, bits)
    assert _bytes(q) == _bytes(ref.q) and _bytes(s) == _bytes(ref.scale)
    qmax = 127 if bits == 8 else 7
    assert s.tolist() == [0.0]
    assert _codes(q, bits)[:4].tolist() == [qmax, -qmax, qmax, 0]
