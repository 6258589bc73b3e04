"""The port's protocol frames: SLT1 (pickled control), SLT2 (tensor) and
SLTC (chunks), on the CPU.

Round trips of ACTIVATION (a bf16 payload), GRADIENT (int8 and int4
QuantLeaf payloads) and UPDATE (a float32 state tree with an int leaf),
a START big enough to be chunked and reassembled out of order, the
integrity checks, and the restricted unpickler refusing a class outside
the protocol's vocabulary.  The same checks run once more in a process
where ``ml_dtypes``, ``jax`` and the JAX package cannot be imported: the
port ships bf16 as raw 16-bit words, so it needs neither.
"""

import dataclasses
import pathlib
import pickle
import random
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from split_learning_torch.runtime.codec.quant import quantize_np
from split_learning_torch.runtime.protocol import (
    Activation, CorruptFrame, FrameAssembler, Gradient, Pause, Register,
    Start, Update, decode, encode, encode_parts,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _bf16(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.view(torch.int16) if a.dtype
                                == torch.bfloat16 else a,
                                b.view(torch.int16) if b.dtype
                                == torch.bfloat16 else b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    return a == b


def check_data_plane_round_trips():
    act = Activation(data_id="d1", data=_bf16((2, 8, 16), 0),
                     labels=np.arange(16, dtype=np.int32).reshape(2, 8),
                     trace=["client_1_0"], cluster=0, round_idx=3)
    raw = encode(act)
    assert raw[:4] == b"SLT2"
    out = decode(raw)
    assert out.data.dtype == torch.bfloat16 and _same(act, out)
    rng = np.random.default_rng(1)
    g = rng.standard_normal((2, 8, 16)).astype(np.float32)
    g[0, 0, 3] = np.nan
    for bits, tile in ((8, 256), (4, 7)):
        grad = Gradient(data_id="d1", data=quantize_np(g, tile, bits),
                        trace=["client_1_0"], round_idx=3)
        out = decode(encode(grad))
        assert _same(grad, out), (bits, tile)
    upd = Update(client_id="client_2_0", stage=2, cluster=0, params={
        "layer2": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                   "n": np.arange(5, dtype=np.int64)}},
        num_samples=32, batch_stats={}, round_idx=3, version=3)
    assert _same(upd, decode(encode(upd)))


def check_chunked_start():
    rng = np.random.default_rng(2)
    params = {f"layer{i}": {"weight": rng.standard_normal(
        (64, 64)).astype(np.float32)} for i in range(1, 9)}
    start = Start(start_layer=1, end_layer=12, cluster=0, params=params,
                  learning={"learning_rate": 3e-4},
                  label_counts=np.array([3, 4]), round_idx=1,
                  extra={"gen": 2})
    parts = encode_parts(start, max_bytes=16 << 10)
    assert len(parts) > 4 and all(p[:4] == b"SLTC" for p in parts)
    random.Random(0).shuffle(parts)
    asm = FrameAssembler()
    outs = [asm.feed(p) for p in parts]
    assert all(o is None for o in outs[:-1])
    assert _same(start, outs[-1])
    assert asm.last_bytes == sum(len(p) for p in parts)
    # a control frame stays one pickled frame
    assert encode_parts(Pause())[0][:4] == b"SLT1"


def check_integrity_and_unpickler():
    raw = bytearray(encode(Register(client_id="c", stage=1)))
    raw[-3] ^= 0xFF
    with pytest.raises(CorruptFrame):
        decode(bytes(raw))
    t = bytearray(encode(Update(client_id="c", stage=1, cluster=0,
                                params={"w": np.ones(8, np.float32)},
                                num_samples=1)))
    t[-5] ^= 0x01   # inside the blob: its own crc catches it
    with pytest.raises(CorruptFrame):
        decode(bytes(t))
    # a frame whose body names a class outside the protocol vocabulary
    body = pickle.dumps(collections_ordered_dict(), protocol=5)
    frame = b"SLT1" + struct.pack(">I", zlib.crc32(body)) + body
    with pytest.raises(pickle.UnpicklingError, match="disallowed class"):
        decode(frame)


def collections_ordered_dict():
    import collections
    return collections.OrderedDict(a=1)


def test_data_plane_round_trips():
    check_data_plane_round_trips()


def test_chunked_start_reassembles_out_of_order():
    check_chunked_start()


def test_integrity_and_restricted_unpickler():
    check_integrity_and_unpickler()


def test_frames_without_ml_dtypes_or_jax():
    """The same checks in a process where ml_dtypes, jax and the JAX
    package cannot be imported."""
    code = "\n".join([
        "import sys",
        "for name in ('ml_dtypes', 'jax', 'flax', 'optax',"
        " 'split_learning_tpu'):",
        "    sys.modules[name] = None",
        "sys.path.insert(0, 'tests')",
        "import test_torch_frames as t",
        "t.check_data_plane_round_trips()",
        "t.check_chunked_start()",
        "t.check_integrity_and_unpickler()",
        "assert sys.modules['ml_dtypes'] is None",
        "print('frames ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "frames ok" in proc.stdout
