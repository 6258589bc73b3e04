"""The generic quantizer and dequantizer kernels of the port
(``quantize_generic_kernel`` and ``dequantize_generic_kernel`` in
``split_learning_torch/csrc/quant.cu``), emulated in numpy down to their
index arithmetic, against the JAX package's codec on the CPU.

The emulation follows the CUDA source step by step, with its constants
read from the source itself:

* the quantizer: the host's span plan (tiles a block, window width,
  pairs at an odd int4 tile, windows over a wide tile), each window
  staged by 16-byte copies from the aligned-down address of a memory
  model that fails on any read of a 16-byte chunk holding no byte of the
  leaf (bytes past the leaf arrive as zeros), the chunks realigned by
  the kernel's funnel shifts into units of 8 values, the absmax over
  magnitude bits through the runs a unit flushes and the warp's shuffle
  scan by tile, one division a unit and a compare a value for the tile,
  the codes by the saturating conversion, packed a unit and restaged,
  and the store phase's 16-byte stores at aligned addresses and byte
  stores at the ends;
* the dequantizer: the codes' 16-byte chunks loaded from the
  aligned-down address (the next chunk from the neighbouring lane, lane
  31 loading its own), realigned, staged a warp group at a time, each
  float4's tile from one division and its scales (1, 2 or 4 by the
  tile) selected a code at a time, and the partial last float4.

Both are held bit for bit against the JAX package's numpy twins
(``quantize_np``, ``dequantize_leaf_np``) and the port's plain versions
over every tile of :data:`TILES` (up to one value wider than a block's
span), int8 and int4, float32, bf16 and fp16, element or byte offsets 0,
1 and 3, with all-zero, NaN and inf tiles; against the JAX package's
Pallas kernels under the interpreter at two small shapes (the quantizer
at ``_match_device_chain``'s tolerance: XLA:CPU divides by qmax through
its reciprocal).  The kernels divide by the tile width directly (no
magic multiplier), so there is no multiplier to check.  Last, the
wrappers refuse before any launch what the C entry points refuse.
"""

import importlib
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.runtime.codec import quant as jcodec
from split_learning_torch.ops.kernels import quant as kq

jq = importlib.import_module("split_learning_tpu.ops.kernels.quant")

CU = (pathlib.Path(kq.__file__).resolve().parents[2] / "csrc"
      / "quant.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


SPAN_BYTES = _const("kSpanBytes")
SPAN_MIN_BYTES = _const("kSpanMinBytes")
SPAN_TARGET_BYTES = _const("kSpanTargetBytes")
SPAN_BLOCKS_PER_SM = _const("kSpanBlocksPerSM")
MAX_SPAN_TILES = _const("kMaxSpanTiles")
GEN_THREADS = _const("kGenThreads")
#: a small card, so that the test leaves span several blocks
SMS = 4
ITEM = {np.float32: 4, "bf16": 2, np.float16: 2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
#: the widest tile a block stages (bf16 values), and one past it
SPAN_VALUES = SPAN_BYTES // 2
TILES = [1, 3, 7, 16, 48, 64, 100, 128, 768, 2048, SPAN_VALUES + 1]
BASE = 0x7F0000000000   # a 16-byte aligned device address
MASK = 0xFFFFFFFF


# -- a device memory of one array, with garbage around it -----------------

class Memory:
    """``nbytes`` at ``addr`` inside the 16-byte aligned chunks that hold
    them; the chunks' other bytes are garbage.  A read of a chunk that
    holds no byte of the array fails: the kernels may read the rest of a
    chunk they need (a page holds it), never a chunk beyond."""

    def __init__(self, data: bytes, addr: int, seed: int):
        self.addr, self.n = addr, len(data)
        self.lo = addr & ~15
        hi = (addr + len(data) + 15) & ~15
        rng = np.random.default_rng(seed)
        self.buf = rng.integers(0, 256, hi - self.lo, dtype=np.uint8)
        self.buf[addr - self.lo:addr - self.lo + len(data)] = \
            np.frombuffer(data, np.uint8)

    def chunk(self, a: int, nbytes: int = 16) -> np.ndarray:
        assert a % 16 == 0 and self.lo <= a and a + 16 <= \
            self.lo + self.buf.size, f"read of a chunk outside the array"
        out = np.zeros(16, np.uint8)
        out[:nbytes] = self.buf[a - self.lo:a - self.lo + nbytes]
        return out


def _words(chunks: np.ndarray) -> np.ndarray:
    """(k, 16) bytes -> (k, 4) little-endian 32-bit words."""
    return np.ascontiguousarray(chunks).view("<u4").reshape(-1, 4).astype(
        np.uint64)


def _bytes(words: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(words.astype("<u4")).view(np.uint8).reshape(
        -1, 16)


def realign(a: np.ndarray, b: np.ndarray, s: int) -> np.ndarray:
    """The kernel's ``realign``: words i of bytes [s, s + 16) of a ++ b by
    ``__funnelshift_r(w[q + i], w[q + i + 1], 8 * (s & 3))``."""
    w = np.concatenate([a, b], axis=1)
    q, r = s >> 2, np.uint64(8 * (s & 3))
    return np.stack([((w[:, q + i + 1] << np.uint64(32)) | w[:, q + i])
                     >> r & np.uint64(MASK) for i in range(4)], axis=1)


def _value_bits(w: np.ndarray, p: int, item: int) -> np.ndarray:
    if item == 4:
        return w[:, p]
    return (w[:, p >> 1] >> np.uint64(16 * (p & 1))) & np.uint64(0xFFFF)


def _to_f32(bits: np.ndarray, dt: str) -> np.ndarray:
    b = bits.astype(np.uint32)
    if dt == "f32":
        return b.view(np.float32)
    if dt == "bf16":
        return (b << np.uint32(16)).view(np.float32)
    return b.astype(np.uint16).view(np.float16).astype(np.float32)


def _inf_bits(dt: str) -> int:
    return {"f32": 0x7F800000, "bf16": 0x7F80, "f16": 0x7C00}[dt]


# -- the quantizer ---------------------------------------------------------

def staged_bytes(values: int, item: int) -> int:
    return ((values * item + 15) // 16 + 2) * 16


def code_window_bytes(values: int, bits: int) -> int:
    return ((values * bits // 8 + 15) // 16 + 2) * 16


def span_plan(tile: int, t_count: int, item: int, bits: int,
              sms: int = SMS) -> tuple:
    """``launch_quantize_generic``'s (tiles a block, window values)."""
    pair = 2 if bits == 4 and tile % 2 else 1
    tile_bytes = tile * item
    if pair * tile_bytes > SPAN_BYTES:
        return pair, SPAN_BYTES // item
    target = t_count * tile_bytes // (SPAN_BLOCKS_PER_SM * sms)
    target = min(max(target, SPAN_MIN_BYTES), SPAN_TARGET_BYTES)
    k = target // tile_bytes // pair * pair
    k = min(max(k, pair), MAX_SPAN_TILES)
    return k, k * tile


def _stage(mem: Memory, item: int, e: int, nv: int, win: int, rng):
    """``stage_window``: (the staged chunks as words, head)."""
    g = mem.addr + e * item
    head = g & 15
    a = g - head
    end = mem.addr + mem.n
    chunks = (head + nv * item + 15) // 16
    # the rest of the buffer holds whatever an earlier window left
    sx = rng.integers(0, 256, (staged_bytes(win, item) // 16, 16),
                      dtype=np.uint8)
    assert chunks + 1 <= sx.shape[0]
    # a unit of float32 reads two chunks and the next: never past the
    # buffer
    assert (item // 2) * -(-nv // UNIT) < sx.shape[0]
    for i in range(chunks):
        valid = end - (a + 16 * i)
        sx[i] = mem.chunk(a + 16 * i, min(16, valid)) if valid > 0 else 0
    return _words(sx), head, chunks


def _chunk_tiles(v0: int, j0: np.ndarray, tile: int):
    v = v0 + j0
    key = v // tile          # one division a chunk
    return key, v - key * tile


UNIT = 8   # values a thread takes: 16 bytes of a 16-bit dtype, 32 of f32


def _units(words: np.ndarray, k: np.ndarray, head: int, item: int):
    """``load_unit``: unit k's 8 values as 32-bit words, each 16-byte
    chunk realigned from the two staged chunks that hold it."""
    c = item // 2
    return np.concatenate([realign(words[c * k + i], words[c * k + i + 1],
                                   head) for i in range(c)], axis=1)


def _reduce(words, head, v0, nv, tile, dt, st, lanes_per_block):
    """``reduce_window``: the runs a unit flushes and the warp's shuffle
    scan of each unit's last run, applied to ``st`` as atomicMax."""
    item = 4 if dt == "f32" else 2
    units = (nv + UNIT - 1) // UNIT
    padded = -(-units // lanes_per_block) * lanes_per_block
    k = np.arange(padded)
    live = k < units
    kk = np.minimum(k, units - 1)
    w = _units(words, kk, head, item)
    j0 = kk * UNIT
    key, r = _chunk_tiles(v0, j0, tile)
    key = key.astype(np.int64)
    m = np.zeros(padded, np.uint64)
    for p in range(UNIT):
        valid = live & (j0 + p < nv)
        flush = valid & (r == tile)
        np.maximum.at(st, key[flush], m[flush])
        key = np.where(flush, key + 1, key)
        m = np.where(flush, 0, m)
        r = np.where(flush, 0, r)
        mag = _value_bits(w, p, item) & np.uint64(0x7FFFFFFF if item == 4
                                                  else 0x7FFF)
        m = np.where(valid, np.maximum(m, mag), m)
        r = r + valid
    key = np.where(live, key, MASK)
    m = np.where(live, m, 0)
    km, mm = key.reshape(-1, 32), m.reshape(-1, 32)
    lane = np.arange(32)
    for off in (1, 2, 4, 8, 16):
        om = np.roll(mm, -off, axis=1)
        ok = np.roll(km, -off, axis=1)
        mm = np.where((lane + off < 32) & (ok == km), np.maximum(mm, om), mm)
    prev = np.roll(km, 1, axis=1)
    heads = (km != MASK) & ((lane == 0) | (prev != km))
    np.maximum.at(st, km[heads], mm[heads])


def _scale_of(st: np.ndarray, dt: str, bits: int) -> np.ndarray:
    """``scale_of``: NaN for a non-finite tile, 1 for an all-zero one,
    else absmax / qmax in float32."""
    qmax = np.float32(127.0 if bits == 8 else 7.0)
    with np.errstate(invalid="ignore"):
        return np.where(st >= _inf_bits(dt), np.float32(np.nan),
                        np.where(st != 0, _to_f32(st, dt) / qmax,
                                 np.float32(1.0))).astype(np.float32)


def _f2i_rn(d: np.ndarray) -> np.ndarray:
    """``__float2int_rn``: round half to even, saturated to int32, NaN to
    0 (the PTX conversion's rule)."""
    out = np.zeros(d.shape, np.int64)
    ok = ~np.isnan(d)
    out[ok] = np.clip(np.rint(d[ok]), -2**31, 2**31 - 1)
    return out


def _code(words, head, v0, nv, tile, dt, bits, scale, win):
    """``code_window``: the window's codes restaged as the code array
    holds them, behind the code window's 16-byte pad."""
    item = 4 if dt == "f32" else 2
    qmax = 127 if bits == 8 else 7
    units = (nv + UNIT - 1) // UNIT
    k = np.arange(units)
    w = _units(words, k, head, item)
    j0 = k * UNIT
    t, r = _chunk_tiles(v0, j0, tile)
    out = np.zeros((units, 2), np.uint64)
    for p in range(UNIT):
        valid = j0 + p < nv
        adv = valid & (r == tile)
        t = np.where(adv, t + 1, t)
        r = np.where(adv, 0, r)
        s = scale[np.where(valid, t, 0)]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            d = _to_f32(_value_bits(w, p, item), dt) / s
        c = np.clip(_f2i_rn(d), -qmax, qmax)
        c = np.where(valid, c, 0).astype(np.uint64)
        if bits == 8:
            out[:, p >> 2] |= (c & np.uint64(0xFF)) << np.uint64(8 * (p & 3))
        else:
            out[:, 0] |= (c & np.uint64(0xF)) << np.uint64(4 * p)
        r = r + valid
    k_bytes = 8 if bits == 8 else 4
    sc = np.zeros(code_window_bytes(win, bits), np.uint8)
    raw = np.ascontiguousarray(out.astype("<u4")).view(np.uint8).reshape(
        units, 8)[:, :k_bytes]
    dst = 16 + (j0 if bits == 8 else j0 // 2)
    assert (dst % k_bytes == 0).all() and dst[-1] + k_bytes <= sc.size
    sc[(dst[:, None] + np.arange(k_bytes)).reshape(-1)] = raw.reshape(-1)
    return sc


def _store(sc: np.ndarray, nb: int, dst: int, out: Memory) -> None:
    """``store_window``: 16-byte stores where the window covers an
    aligned chunk whole, bytes at its ends."""
    hb = dst & 15
    a = dst - hb
    chunks = (hb + nb + 15) // 16
    words = _words(sc.reshape(-1, 16))
    idx = np.arange(chunks)
    v = (realign(words[idx], words[idx + 1], 16 - hb) if hb
         else words[idx + 1])
    vb = _bytes(v)
    for i in range(chunks):
        r0 = 16 * i - hb
        at = a + 16 * i - out.lo
        if r0 >= 0 and r0 + 16 <= nb:
            assert (a + 16 * i) % 16 == 0
            out.buf[at:at + 16] = vb[i]
        else:
            for b in range(16):
                if 0 <= r0 + b < nb:
                    out.buf[at + b] = vb[i, b]


def emulate_quantize(bits_arr: np.ndarray, dt: str, tile: int, bits: int,
                     offset: int = 0, codes_offset: int = 0):
    """The generic quantizer's codes and scales for a leaf of raw value
    bits ``bits_arr`` (uint32 for float32, uint16 otherwise) placed
    ``offset`` elements past a 16-byte boundary."""
    item = 4 if dt == "f32" else 2
    n = bits_arr.size
    t_count = kq.padded_tiles(n, tile, bits)
    rng = np.random.default_rng(tile + bits + offset)
    x = Memory(bits_arr.tobytes(), BASE + offset * item, seed=tile)
    n_code = t_count * tile // (2 if bits == 4 else 1)
    codes = Memory(bytes(n_code), BASE + (1 << 32) + codes_offset, seed=1)
    scales = np.full(t_count, np.nan, np.float32)
    span_tiles, win = span_plan(tile, t_count, item, bits)
    assert span_tiles <= MAX_SPAN_TILES
    assert (staged_bytes(win, item) + code_window_bytes(win, bits)
            + 4 * span_tiles) <= (staged_bytes(SPAN_BYTES // item, item)
                                  + code_window_bytes(SPAN_BYTES // item,
                                                      bits)
                                  + 4 * MAX_SPAN_TILES)
    for blk in range(-(-t_count // span_tiles)):
        t0 = blk * span_tiles
        tiles = min(span_tiles, t_count - t0)
        span, e0 = tiles * tile, t0 * tile
        wins = -(-span // win)
        if bits == 4:   # no code byte straddles two blocks or windows
            assert e0 % 2 == 0 and win % 2 == 0
        st = np.zeros(tiles, np.uint64)
        staged = None
        for w in range(wins):
            v0 = w * win
            nv = min(win, span - v0)
            staged = _stage(x, item, e0 + v0, nv, win, rng)
            _reduce(staged[0], staged[1], v0, nv, tile, dt, st, GEN_THREADS)
        scale = _scale_of(st, dt, bits)
        scales[t0:t0 + tiles] = scale
        for w in range(wins):
            v0 = w * win
            nv = min(win, span - v0)
            if wins > 1:
                staged = _stage(x, item, e0 + v0, nv, win, rng)
            sc = _code(staged[0], staged[1], v0, nv, tile, dt, bits, scale,
                       win)
            e = e0 + v0
            _store(sc, nv if bits == 8 else nv // 2,
                   codes.addr + (e if bits == 8 else e // 2), codes)
    q = codes.buf[codes.addr - codes.lo:codes.addr - codes.lo + n_code]
    return (q.view(np.int8) if bits == 8 else q).copy(), scales


# -- the dequantizer -------------------------------------------------------

def emulate_dequantize(q: np.ndarray, scales: np.ndarray, tile: int,
                       bits: int, offset: int = 0,
                       threads: int = 256) -> np.ndarray:
    """The generic dequantizer's float32 output for codes placed
    ``offset`` bytes past a 16-byte boundary."""
    t_count = scales.size
    total = t_count * tile
    mem = Memory(q.tobytes(), BASE + offset, seed=tile + bits)
    hq = mem.addr & 15
    qa = mem.addr - hq
    nbytes = total if bits == 8 else total // 2
    chunks = (nbytes + 15) // 16
    held = (hq + nbytes + 15) // 16
    quads = (total + 3) // 4
    groups = (chunks + 31) // 32
    k_out = 4 if bits == 8 else 8
    zero = np.zeros(16, np.uint8)
    c = np.arange(groups * 32)
    a = np.stack([mem.chunk(qa + 16 * i) if i < held else zero for i in c])
    a = _words(a).reshape(groups, 32, 4)
    if hq:
        nxt = np.roll(a, -1, axis=1)                 # from lane l + 1
        last = c.reshape(groups, 32)[:, 31] + 1      # lane 31 loads its own
        nxt[:, 31] = _words(np.stack([mem.chunk(qa + 16 * i) if i < held
                                      else zero for i in last]))
        staged = realign(a.reshape(-1, 4), nxt.reshape(-1, 4), hq)
    else:
        staged = a.reshape(-1, 4)
    stage = _bytes(staged).reshape(groups, 512)
    ns = 1 if tile % 4 == 0 else 2 if tile >= 4 else 4
    out = np.full(total, np.nan, np.float32)
    f = np.arange(groups * 32 * k_out)
    g, j = f // (32 * k_out), f % (32 * k_out)
    live = f < quads
    f, g, j = f[live], g[live], j[live]
    if bits == 8:
        word = stage.view("<u4")[g, j].astype(np.uint32)
        codes = [((word << np.uint32(24 - 8 * i)).view(np.int32) >> 24)
                 for i in range(4)]
    else:
        half = stage.view("<u2")[g, j].astype(np.uint32) << np.uint32(16)
        codes = [((half << np.uint32(12 - 4 * i)).view(np.int32) >> 28)
                 for i in range(4)]
    code = 4 * f
    t = code // tile                                 # one division a float4
    rr = code - t * tile
    s = [scales[np.minimum(t + i, t_count - 1)] for i in range(ns)]
    idx = np.zeros_like(t)
    for i in range(4):
        if ns > 1:
            adv = rr == tile
            idx = np.where(adv, idx + 1, idx)
            rr = np.where(adv, 0, rr)
        sel = s[0]
        for n in range(1, ns):
            sel = np.where(idx == n, s[n], sel)
        val = codes[i].astype(np.float32) * sel.astype(np.float32)
        pos = 4 * f + i
        keep = pos < total                           # the partial last float4
        out[pos[keep]] = val[keep]
        rr = rr + 1
    return out


# -- the inputs ------------------------------------------------------------

def _leaf(dt: str, tile: int, seed: int) -> torch.Tensor:
    """A leaf of a few tiles and a ragged end (enough values to span
    several blocks), with an all-zero, a NaN and an inf tile."""
    rng = np.random.default_rng(seed)
    n = max(5 * tile + tile // 2 + 1, 2400)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    x[:tile] = 0.0
    x[tile + tile // 2] = np.nan
    x[3 * tile] = np.inf
    return torch.from_numpy(x).to(DTYPES[dt])


def _raw(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.float32:
        return x.numpy().view(np.uint32)
    return x.view(torch.int16).numpy().view(np.uint16)


def _same_f32(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return (a.shape == b.shape and np.array_equal(nan, np.isnan(b))
            and np.array_equal(a[~nan].view(np.uint32),
                               b[~nan].view(np.uint32)))


# -- the tests -------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tile", TILES)
def test_quantizer_emulation_matches_jax_and_plain(tile, bits, dt, offset):
    x = _leaf(dt, tile, seed=tile * 7 + bits + offset)
    q, s = emulate_quantize(_raw(x), dt, tile, bits, offset=offset)
    ref = jcodec.quantize_np(x.float().numpy(), tile, bits)
    assert q.tobytes() == np.asarray(ref.q).tobytes()
    assert s.tobytes() == np.asarray(ref.scale).tobytes()
    qt, st = kq.quantize_reference(x, tile, bits)
    assert q.tobytes() == qt.numpy().tobytes()
    assert s.tobytes() == st.numpy().tobytes()


@pytest.mark.parametrize("codes_offset", [1, 3, 13])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tile", [7, 100])
def test_quantizer_emulation_stores_at_any_code_alignment(tile, bits,
                                                          codes_offset):
    """The store phase's aligned 16-byte stores and byte ends, with the
    code array itself off 16-byte alignment."""
    x = _leaf("bf16", tile, seed=tile + codes_offset)
    q, s = emulate_quantize(_raw(x), "bf16", tile, bits,
                            codes_offset=codes_offset)
    ref = jcodec.quantize_np(x.float().numpy(), tile, bits)
    assert q.tobytes() == np.asarray(ref.q).tobytes()
    assert s.tobytes() == np.asarray(ref.scale).tobytes()


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tile", TILES)
def test_dequantizer_emulation_matches_jax_and_plain(tile, bits, offset):
    x = _leaf("f32", tile, seed=tile * 5 + bits)
    ref = jcodec.quantize_np(x.numpy(), tile, bits)
    q, s = np.asarray(ref.q), np.asarray(ref.scale, np.float32)
    s = s.copy()
    s[-1] = -s[-1] if np.isfinite(s[-1]) else s[-1]   # a negative scale
    got = emulate_dequantize(q, s, tile, bits, offset=offset)
    want_t = kq.dequantize_reference(torch.from_numpy(q), torch.from_numpy(s),
                                     tile, bits).numpy()
    assert _same_f32(got, want_t)
    leaf = jcodec.QuantLeaf(q=q, scale=s, bits=bits, tile=tile,
                            shape=(s.size * tile,))
    assert _same_f32(got, jcodec.dequantize_leaf_np(leaf))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tile,t_count", [(48, 6), (7, 10)])
def test_emulations_match_the_pallas_kernels(tile, t_count, bits):
    """Two small shapes through the JAX package's Pallas kernels under
    the interpreter: the dequantizer bit for bit, the quantizer at the
    device chain's tolerance (scales within one ulp; codes equal where
    the scale is)."""
    rng = np.random.default_rng(tile + bits)
    x = (rng.standard_normal(t_count * tile) * 3).astype(np.float32)
    x[:tile] = 0.0
    x[2 * tile + 1] = np.nan
    q, s = emulate_quantize(x.view(np.uint32), "f32", tile, bits, offset=1)
    jcodes, jscale = jq.quantize_tiles(jnp.asarray(x.reshape(-1, tile)),
                                       bits=bits, interpret=True)
    jscale = np.asarray(jscale)
    assert np.array_equal(np.isnan(s), np.isnan(jscale))
    fin = ~np.isnan(s)
    np.testing.assert_array_max_ulp(s[fin], jscale[fin], maxulp=1)
    same = s.view(np.uint32) == jscale.view(np.uint32)

    def codes_of(a):
        a = np.asarray(a)
        if bits == 8:
            return a.astype(np.int32)
        u = a.view(np.uint8).astype(np.int32)
        c = np.stack([u & 0xF, u >> 4], axis=-1).reshape(-1)
        return np.where(c < 8, c, c - 16)
    diff = np.abs(codes_of(q) - codes_of(jcodes)).reshape(-1, tile)
    assert not diff[same].any() and diff.max(initial=0) <= 1
    got = emulate_dequantize(q, s, tile, bits, offset=3)
    want = np.asarray(jq.dequantize_tiles(jnp.asarray(q), jnp.asarray(s),
                                          tile=tile, bits=bits,
                                          interpret=True)).reshape(-1)
    assert _same_f32(got, want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("item", [2, 4])
@pytest.mark.parametrize("tile", TILES + [SPAN_BYTES // 4 + 1, 4097, 9])
def test_span_plan(tile, item, bits):
    """Spans of whole tiles within the budget (pairs at an odd int4 tile,
    so that no code byte straddles two blocks); a wider tile (pair) one
    block and windows of the budget; the frame over the card's blocks."""
    for t_count in (1, 2, 3, 2049, 10**6):
        if bits == 4 and t_count * tile % 2:
            continue
        span_tiles, win = span_plan(tile, t_count, item, bits, sms=132)
        pair = 2 if bits == 4 and tile % 2 else 1
        assert span_tiles % pair == 0 and 1 <= span_tiles <= MAX_SPAN_TILES
        assert win % 2 == 0 or bits == 8
        if pair * tile * item > SPAN_BYTES:
            assert span_tiles == pair and win * item == SPAN_BYTES
        else:
            assert win == span_tiles * tile and win * item <= SPAN_BYTES


def test_vgg_wire_slow_frames_plan():
    """The wire-slow codec's tile 64 on VGG's cut-7 frames spreads over
    the card: the bf16 frame and the float32 gradient frame each take at
    least two blocks an SM of an H100 (132 SMs), at most twice the
    planned blocks an SM, each span read once."""
    n = 32 * 16 * 16 * 64
    for item in (2, 4):
        span_tiles, win = span_plan(64, n // 64, item, 8, sms=132)
        blocks = -(-(n // 64) // span_tiles)
        assert win == span_tiles * 64
        assert 2 * 132 <= blocks <= 2 * SPAN_BLOCKS_PER_SM * 132


def _no_library(monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(kq, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(kq, "_library", no_library)
    kq.reset_launches()


@pytest.mark.parametrize("fault", ["tile too wide", "int64 leaf",
                                   "non-contiguous leaf", "empty leaf",
                                   "bits 2", "tile 0"])
def test_quantizer_refuses_before_any_launch(monkeypatch, fault):
    """What ``slt_quantize_generic`` refuses, the wrapper refuses first:
    no library loaded, no launch counted."""
    _no_library(monkeypatch)
    x, tile, bits = torch.ones(300), 7, 8
    if fault == "tile too wide":
        tile = kq.GENERIC_MAX_TILE + 1
    elif fault == "int64 leaf":
        x = x.long()
    elif fault == "non-contiguous leaf":
        x = torch.ones(600)[::2]
    elif fault == "empty leaf":
        x = torch.ones(0)
    elif fault == "bits 2":
        bits = 2
    else:
        tile = 0
    with pytest.raises((ValueError, TypeError)):
        kq.quantize_tiles(x, tile=tile, bits=bits)
    assert not any(kq.LAUNCHES.values())


@pytest.mark.parametrize("fault", ["odd int4 code count", "bits 2",
                                   "tile 0", "code count"])
def test_dequantizer_refuses_before_any_launch(monkeypatch, fault):
    _no_library(monkeypatch)
    tile, bits = 7, 4
    q = torch.zeros(3 * 7 // 2, dtype=torch.uint8)
    s = torch.ones(3)
    if fault == "bits 2":
        bits = 2
    elif fault == "tile 0":
        tile = 0
    elif fault == "code count":
        tile, bits = 100, 8
        q = torch.zeros(299, dtype=torch.int8)
    with pytest.raises(ValueError):
        kq.dequantize_tiles(q, s, tile=tile, bits=bits)
    assert not any(kq.LAUNCHES.values())


def test_generic_limits_match_the_entry_points():
    """The wrapper's limits are the C entry points': a tile of at most
    2^28 - 1 values (``8LL * tile > 0x7fffffffLL`` refused), and int4's
    even code count."""
    assert "8LL * tile > 0x7fffffffLL" in CU
    assert kq.GENERIC_MAX_TILE == 0x7FFFFFFF // 8
    assert CU.count("(bits == 4 && (t_count * tile) % 2)") == 2
