"""Typed control-plane protocol: queue names, messages and frames.

Port of the part of the JAX package's ``runtime/protocol.py`` that a
FedAvg round runs: the queue names, the round's messages (REGISTER,
READY, NOTIFY, UPDATE, START, SYN, PAUSE, STOP, the telemetry plane's
HEARTBEAT, the ACTIVATION/GRADIENT data plane, EPOCHEND, the quantized
:class:`QuantLeaf`, the top-k :class:`SparseLeaf` and the aggregator
tree's :class:`PartialAggregate`), and the three frame families with the
same bytes:

* ``SLT1`` — pickled frame ``MAGIC | crc32(body) | pickle(body)`` for
  control messages, read back by a restricted unpickler that admits the
  protocol's own dataclasses and plain builtins/numpy only;
* ``SLT2`` — tensor frame for the data plane and UPDATE: every array
  leaf is lifted out into a raw blob with a fixed header (dtype code,
  flags, shape, crc32, length) behind a tiny pickled skeleton;
* ``SLTC`` — chunk frame: a frame above the chunk cap is split into
  crc'd parts that a :class:`FrameAssembler` reassembles.

Payload leaves are numpy arrays, except bfloat16, which numpy cannot
hold without ``ml_dtypes``: a bfloat16 leaf is a CPU ``torch.Tensor``,
written and read as raw 16-bit words under the JAX package's dtype
code 4.  Every frame is checksummed end to end; a corrupt frame raises
:class:`CorruptFrame` before any unpickling.

Queue naming (the reference's topology):

* ``rpc_queue``                              any client -> server
* ``reply_{client_id}``                      server -> one client
* ``intermediate_queue_{stage}_{cluster}``   stage k -> k+1 activations
  (``..._p{pair}``: a 2LS pair's or one DCSL device's own queue)
* ``gradient_queue_{stage}_{client_id}``     stage k+1 -> one stage-k client
* ``aggregate_queue_{cluster}_{group}``      a tree group's members -> its
  aggregator (``aggregation.fan-in``)

Left out here (raising where a config asks for them): the remote
aggregator nodes' AGGHELLO/AGGASSIGN/AGGFLUSH, the digest roll-up's
FLEETDIGEST/DIGESTROUTE, stage-host and blackbox messages, and the
trace-context sidecar's span plumbing (the context bytes still ride the
frames unchanged).
"""

from __future__ import annotations

import collections
import dataclasses
import io
import math
import os
import pickle
import struct
import uuid
import warnings
import zlib
from typing import Any

import numpy as np
import torch

RPC_QUEUE = "rpc_queue"


def reply_queue(client_id: str) -> str:
    return f"reply_{client_id}"


def intermediate_queue(stage: int, cluster: int,
                       pair: int | str | None = None) -> str:
    """Forward-activation queue, shared per cluster (natural load
    balance across same-stage clients).  ``pair`` selects a private
    queue, ``intermediate_queue_{stage}_{cluster}_p{pair}``: 2LS's fixed
    edge<->head pairing (an in-cluster index) or DCSL's per-device
    scatter (the consuming client's id)."""
    base = f"intermediate_queue_{stage}_{cluster}"
    return base if pair is None else f"{base}_p{pair}"


def gradient_queue(stage: int, client_id: str) -> str:
    return f"gradient_queue_{stage}_{client_id}"


def aggregate_queue(cluster: int, group: int) -> str:
    """Aggregator-tree upload queue (``aggregation.fan-in``): the clients
    of level-1 group ``group`` publish their round UPDATE here instead of
    ``rpc_queue``, and an interior group's children their
    :class:`PartialAggregate`; the group's
    :class:`~split_learning_torch.runtime.aggregate.L1Aggregator` folds
    them into one partial for its parent."""
    return f"aggregate_queue_{cluster}_{group}"


# --------------------------------------------------------------------------
# control messages
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Register:
    """client -> server: join the round (with the offline profile)."""
    client_id: str
    stage: int                      # 1-based stage index ("layer_id")
    cluster: int | None = None      # manual cluster assignment, or None
    profile: dict | None = None


@dataclasses.dataclass
class Ready:
    """client -> server: shard built, data loaded.  ``round_idx`` carries
    the START's generation so a late READY cannot count toward a newer
    invocation's barrier."""
    client_id: str
    round_idx: int = 0


@dataclasses.dataclass
class Notify:
    """stage-1 client -> server: local data exhausted this round."""
    client_id: str
    cluster: int
    round_idx: int = 0


@dataclasses.dataclass
class Update:
    """client -> server: round's trained shard parameters.

    ``round_idx`` fences aggregation: a straggler's stale round-N
    weights must not count as round N+1's contribution."""
    client_id: str
    stage: int
    cluster: int
    params: Any                     # state tree of arrays / tensors
    num_samples: int                # FedAvg weight (data_count semantics)
    ok: bool = True                 # False -> NaN seen, skip aggregation
    batch_stats: Any | None = None  # shard's running stats (BN models)
    round_idx: int = 0
    # delta-encoded Update: params holds ``trained - base`` against the
    # server's versioned shadow copy; None = full frame
    delta_base: int | None = None
    # async mode: the server generation this client's params were seeded
    # from; sync clients stamp their fence here too
    version: int | None = None
    # piggybacked telemetry snapshot (a plain dict)
    telemetry: dict | None = None


@dataclasses.dataclass
class Start:
    """server -> client: round config + shard weights."""
    start_layer: int
    end_layer: int                  # -1 = to the end
    cluster: int
    params: Any                     # shard tree (numpy arrays)
    batch_stats: Any | None = None
    learning: dict | None = None    # lr/momentum/... overrides
    label_counts: Any | None = None  # stage-1: per-label sample counts
    round_idx: int = 0
    extra: dict | None = None       # strategy-specific knobs


@dataclasses.dataclass
class Syn:
    """server -> client: begin training (``sda_*``: responsive-set
    overrides of the START values)."""
    round_idx: int = 0
    sda_fence_quorum: int | None = None
    sda_feeders: list | None = None


@dataclasses.dataclass
class Pause:
    """server -> client: stop the hot loop, upload weights."""
    send_weights: bool = True


@dataclasses.dataclass
class Stop:
    """server -> client: terminate."""
    reason: str = ""


@dataclasses.dataclass
class Heartbeat:
    """client -> server, on the rpc queue, from a background thread every
    ``observability.heartbeat-interval`` seconds: liveness plus a full
    :class:`~split_learning_torch.runtime.telemetry.TelemetrySnapshot`
    as a plain dict (counters, gauges, histogram digests, current round,
    EWMA samples/s).  The snapshot's monotonic ``seq`` and sender clock
    ``t`` are the server's staleness guard.  Small and pickled (SLT1):
    it shares the rpc queue with the UPDATE uploads."""
    client_id: str
    round_idx: int = 0
    telemetry: dict | None = None


# --------------------------------------------------------------------------
# data-plane messages
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Activation:
    """stage k -> stage k+1.  ``trace`` is the routing stack of client
    ids, appended per forward hop, popped per backward hop; a consumer
    drops messages stamped with another ``round_idx``."""
    data_id: str
    data: Any
    labels: np.ndarray
    trace: list
    cluster: int
    round_idx: int = 0


@dataclasses.dataclass
class Gradient:
    """stage k+1 -> the originating stage-k client."""
    data_id: str
    data: Any   # cotangent, same tree structure as the Activation.data
    trace: list
    round_idx: int = 0


@dataclasses.dataclass
class EpochEnd:
    """stage k -> stage k+1 (strict SDA only): the feeder dispatched its
    last batch of this epoch."""
    client_id: str
    round_idx: int = 0
    epoch: int = 0


@dataclasses.dataclass
class PartialAggregate:
    """Aggregator -> its parent (``rpc_queue`` at the root, the parent
    group's aggregate queue below it): one aggregator-tree group's folded
    contribution (``aggregation.fan-in`` / ``aggregation.levels``).

    ``sums`` are the group's per-path weighted float32 SUMS, not divided:
    every level continues the running fold and the root divides once.
    ``members`` is the per-client metadata the root books (client_id,
    stage, num_samples, ok, telemetry); an interior node concatenates its
    children's lists.  ``round_idx`` carries the invocation generation,
    the same fence as UPDATE's.  ``codec``/``codec_base`` describe a
    compressed payload (``transport.codec: {partial: ...}``,
    ``runtime/codec/partial.py``): ``sums`` then holds tiled int8
    :class:`QuantLeaf` codes of the group mean (delta'd against the
    generation ``codec_base`` START shard both ends hold), and
    ``members_z`` the packed member list (:func:`pack_members`).  None =
    raw float32 sums, the bit-parity leg."""
    aggregator_id: str
    cluster: int
    group: int                      # group index (canonical position)
    stage: int                      # the one stage this group covers
    round_idx: int = 0
    sums: Any = None                # tree of float32 weighted sums
    weight: float = 0.0             # total fold weight behind the sums
    dtypes: Any = None              # tree of the leaves' dtype names
    stat_sums: Any = None           # batch-statistics sums (BN models)
    stat_weight: float = 0.0
    stat_dtypes: Any = None
    n_samples: int = 0              # stage-1 samples folded (0 otherwise)
    members: list | None = None     # per-client {client_id, stage, ...}
    level: int = 1                  # tree level that produced this
    codec: str | None = None        # partial codec spec, None = raw f32
    codec_base: int | None = None   # delta base generation, None = plain
    members_z: bytes | None = None  # packed members (codec path only)


@dataclasses.dataclass
class QuantLeaf:
    """One tiled absmax-quantized float tensor on the data-plane wire:
    ``x ≈ q * scale``.  ``q`` is the FLAT padded code array (int8, or
    uint8 with two 4-bit codes per byte when ``bits == 4``), ``scale``
    a float32 array with one entry per ``tile`` values, ``shape`` the
    original shape.  A non-finite tile ships a NaN scale.  The legacy
    per-tensor form (``transport.wire-dtype: int8``) keeps ``q`` int8 in
    the tensor's own shape, ``scale`` a Python float, ``tile`` 0 and
    ``shape`` None."""
    q: np.ndarray
    scale: Any
    bits: int = 8
    tile: int = 0
    shape: tuple | None = None


@dataclasses.dataclass
class SparseLeaf:
    """One top-k sparsified float tensor on the data-plane wire
    (``transport.codec`` ``topk:<frac>``, ``runtime/codec/sparse.py``):
    flat ``idx`` into the dense tensor (int32, ascending), the kept
    ``val``ues (float32), and the dense ``shape`` to scatter back into
    (zeros elsewhere)."""
    idx: np.ndarray
    val: np.ndarray
    shape: tuple = ()


@dataclasses.dataclass
class _TensorRef:
    """Placeholder left in a TENSOR frame's pickled skeleton where an
    array leaf was lifted out into the raw blob table."""
    idx: int


CONTROL_TYPES = (Register, Ready, Notify, Update, Start, Syn, Pause, Stop,
                 Heartbeat, PartialAggregate)
DATA_TYPES = (Activation, Gradient, EpochEnd)
#: messages whose array payloads ride the TENSOR framing
TENSOR_TYPES = (Activation, Gradient, Update, PartialAggregate)
_TYPE_BY_NAME = {t.__name__: t for t in CONTROL_TYPES + DATA_TYPES}
#: nested wire-format helpers (never valid as a top-level message)
_WIRE_HELPERS = {"QuantLeaf": QuantLeaf, "SparseLeaf": SparseLeaf,
                 "_TensorRef": _TensorRef}


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor sharing a decoded (read-only) numpy array's memory.
    Callers copy it (to the device) or compute new tensors from it;
    none writes it in place."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


class Float0:
    """The gradient of a boundary leaf that is not differentiable (a
    bool or int leaf: BERT's padding mask), as JAX's ``float0``
    cotangent: it crosses the wire as zeros of the leaf's shape —
    float32 through a codec, the wire dtype on the plain wire — and the
    sender of that activation ignores it."""

    def __init__(self, shape):
        self.shape = tuple(int(s) for s in shape)


# --------------------------------------------------------------------------
# serialization
# --------------------------------------------------------------------------

FRAME_MAGIC = b"SLT1"
TENSOR_MAGIC = b"SLT2"
CHUNK_MAGIC = b"SLTC"
_HDR_LEN = len(FRAME_MAGIC) + 4
_MODULE = __name__


class CorruptFrame(pickle.UnpicklingError):
    """Frame failed the integrity check (bad magic / length / checksum)."""


class _SafeUnpickler(pickle.Unpickler):
    _ALLOWED = {
        ("builtins", "dict"), ("builtins", "list"), ("builtins", "tuple"),
        ("builtins", "set"), ("builtins", "frozenset"),
        ("builtins", "complex"), ("builtins", "bytearray"),
        ("numpy", "dtype"), ("numpy", "ndarray"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.numeric", "_frombuffer"),
        ("numpy.core.numeric", "_frombuffer"),
    }

    def find_class(self, module, name):
        if module == _MODULE:
            if name in _TYPE_BY_NAME:
                return _TYPE_BY_NAME[name]
            if name in _WIRE_HELPERS:
                return _WIRE_HELPERS[name]
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"disallowed class in protocol message: {module}.{name}")


def pack_members(members: list | None) -> bytes | None:
    """crc32-prefixed zlib'd pickle of a :class:`PartialAggregate`'s
    member list (the codec'd wire form, ``members_z``): at fleet scale
    the per-client member dicts dominate a root partial's bytes."""
    if not members:
        return None
    body = zlib.compress(
        pickle.dumps(members, protocol=pickle.HIGHEST_PROTOCOL), 6)
    return struct.pack(">I", zlib.crc32(body)) + body


def unpack_members(blob: bytes) -> list:
    """Inverse of :func:`pack_members`: the blob's own crc is checked
    before anything is decompressed or unpickled, and the restricted
    unpickler reads it (member dicts are plain builtins)."""
    if len(blob) < 4:
        raise CorruptFrame("packed member list truncated")
    (want,) = struct.unpack_from(">I", blob, 0)
    body = blob[4:]
    if zlib.crc32(body) != want:
        raise CorruptFrame("packed member list checksum mismatch")
    out = _SafeUnpickler(io.BytesIO(zlib.decompress(body))).load()
    if not isinstance(out, list):
        raise CorruptFrame(
            f"packed member list decoded to {type(out).__name__}")
    return out


def encode_pickled(msg) -> bytes:
    """Pickled frame (``SLT1``): what control messages use."""
    if type(msg).__name__ not in _TYPE_BY_NAME:
        raise TypeError(f"not a protocol message: {type(msg)!r}")
    body = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    return FRAME_MAGIC + struct.pack(">I", zlib.crc32(body)) + body


def _decode_pickled(raw: bytes):
    (want,) = struct.unpack_from(">I", raw, len(FRAME_MAGIC))
    body = memoryview(raw)[_HDR_LEN:]
    if zlib.crc32(body) != want:
        raise CorruptFrame("protocol frame checksum mismatch "
                           f"({len(raw)} bytes)")
    msg = _SafeUnpickler(io.BytesIO(body)).load()
    if not isinstance(msg, CONTROL_TYPES + DATA_TYPES):
        raise pickle.UnpicklingError(
            f"not a protocol message: {type(msg).__name__}")
    return msg


# -- TENSOR frames ----------------------------------------------------------

#: dtype code table, the JAX package's: code 4 is bfloat16 (raw 16-bit
#: words here); anything outside the table stays in the pickled skeleton
_DTYPE_BY_CODE: dict[int, np.dtype] = {
    1: np.dtype(np.float32), 2: np.dtype(np.float64),
    3: np.dtype(np.float16), 5: np.dtype(np.int8),
    6: np.dtype(np.int16), 7: np.dtype(np.int32),
    8: np.dtype(np.int64), 9: np.dtype(np.uint8),
    10: np.dtype(np.uint16), 11: np.dtype(np.uint32),
    12: np.dtype(np.uint64), 13: np.dtype(np.bool_),
}
_CODE_BY_DTYPE = {dt: c for c, dt in _DTYPE_BY_CODE.items()}
_BF16_CODE = 4

#: per-tensor fixed header: dtype code, flags, ndim, crc32(raw bytes),
#: raw byte length — shape dims (u64 each) follow
_THDR = struct.Struct(">BBHIQ")
TENSOR_FLAG_PACKED4 = 0x01   # two 4-bit codes per byte (bits == 4)
TENSOR_FLAG_TILED = 0x02     # per-tile scales (tile > 0)
_MAX_NDIM = 32
_MAX_TENSORS = 1 << 20
#: trace-context sanity cap
_MAX_CTX_BYTES = 255


#: CPU tensor leaves are lifted out like numpy arrays
_TORCH_CODE = {torch.float32: 1, torch.float64: 2, torch.float16: 3,
               torch.bfloat16: _BF16_CODE, torch.int8: 5, torch.int16: 6,
               torch.int32: 7, torch.int64: 8, torch.uint8: 9,
               torch.bool: 13}


def _is_blob(o) -> bool:
    if isinstance(o, np.ndarray):
        return o.dtype in _CODE_BY_DTYPE
    return (isinstance(o, torch.Tensor) and o.device.type == "cpu"
            and o.dtype in _TORCH_CODE)


def _blob(a):
    """(dtype code, shape, contiguous little-endian byte view) of one
    array leaf: a numpy array, or a CPU tensor (bfloat16 as raw words)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous()
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return (_TORCH_CODE[t.dtype], tuple(t.shape),
                memoryview(words.numpy()).cast("B"))
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return _CODE_BY_DTYPE[a.dtype], a.shape, memoryview(a).cast("B")


def _encode_tensor(msg, ctx: bytes = b"") -> bytes:
    if len(ctx) > _MAX_CTX_BYTES:
        raise ValueError(f"trace context of {len(ctx)} bytes exceeds "
                         f"the {_MAX_CTX_BYTES}-byte cap")
    tensors: list = []
    tflags: list[int] = []

    def strip(o, flags: int = 0):
        if _is_blob(o):
            tensors.append(o)
            tflags.append(flags)
            return _TensorRef(len(tensors) - 1)
        if isinstance(o, QuantLeaf):
            qf = ((TENSOR_FLAG_PACKED4 if o.bits == 4 else 0)
                  | (TENSOR_FLAG_TILED if o.tile else 0))
            return QuantLeaf(q=strip(o.q, qf), scale=strip(o.scale),
                             bits=o.bits, tile=o.tile, shape=o.shape)
        if isinstance(o, SparseLeaf):
            return SparseLeaf(idx=strip(o.idx), val=strip(o.val),
                              shape=o.shape)
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items()}
        if isinstance(o, list):
            return [strip(v) for v in o]
        if isinstance(o, tuple):
            return tuple(strip(v) for v in o)
        return o

    skel = type(msg)(**{f.name: strip(getattr(msg, f.name))
                        for f in dataclasses.fields(msg)})
    skel_bytes = pickle.dumps(skel, protocol=pickle.HIGHEST_PROTOCOL)

    headers: list[bytes] = []
    blobs: list = []
    for a, fl in zip(tensors, tflags):
        code, shape, buf = _blob(a)
        headers.append(
            _THDR.pack(code, fl, len(shape), zlib.crc32(buf), buf.nbytes)
            + struct.pack(f">{len(shape)}Q", *shape))
        blobs.append(buf)
    meta = (struct.pack(">H", len(ctx)) + ctx
            + struct.pack(">I", len(tensors)) + b"".join(headers)
            + struct.pack(">I", len(skel_bytes)) + skel_bytes)
    return b"".join([TENSOR_MAGIC, struct.pack(">I", zlib.crc32(meta)),
                     meta, *blobs])


def _decode_tensor(raw: bytes):
    view = memoryview(raw)
    try:
        (want,) = struct.unpack_from(">I", raw, 4)
        off = 8
        (ctx_len,) = struct.unpack_from(">H", raw, off)
        off += 2
        if ctx_len > _MAX_CTX_BYTES or off + ctx_len > len(raw):
            raise CorruptFrame(f"tensor frame claims {ctx_len}-byte "
                               "trace context")
        ctx = raw[off:off + ctx_len]
        off += ctx_len
        (n_tensors,) = struct.unpack_from(">I", raw, off)
        off += 4
        if n_tensors > _MAX_TENSORS:
            raise CorruptFrame(f"tensor frame claims {n_tensors} tensors")
        hdrs = []
        for _ in range(n_tensors):
            code, flags, ndim, bcrc, nbytes = _THDR.unpack_from(raw, off)
            off += _THDR.size
            if ndim > _MAX_NDIM:
                raise CorruptFrame(f"tensor frame claims ndim={ndim}")
            shape = struct.unpack_from(f">{ndim}Q", raw, off)
            off += 8 * ndim
            hdrs.append((code, flags, shape, bcrc, nbytes))
        (skel_len,) = struct.unpack_from(">I", raw, off)
        off += 4
        if off + skel_len > len(raw):
            raise CorruptFrame("tensor frame skeleton truncated")
        skel = raw[off:off + skel_len]
        off += skel_len
    except struct.error as e:
        raise CorruptFrame(f"tensor frame header truncated: {e}") from None
    # integrity BEFORE np.frombuffer / unpickling: meta (headers +
    # skeleton) under the outer crc, each raw blob under its own
    if zlib.crc32(view[8:off]) != want:
        raise CorruptFrame("tensor frame meta checksum mismatch "
                           f"({len(raw)} bytes)")
    if len(raw) - off != sum(h[4] for h in hdrs):
        raise CorruptFrame("tensor frame blob region length mismatch")
    arrays = []
    flags_of: list[int] = []
    for code, flags, shape, bcrc, nbytes in hdrs:
        bf16 = code == _BF16_CODE
        dt = np.dtype(np.int16) if bf16 else _DTYPE_BY_CODE.get(code)
        if dt is None:
            raise CorruptFrame(f"unknown tensor dtype code {code}")
        count, rem = divmod(nbytes, dt.itemsize)
        if rem or math.prod(shape) != count:
            raise CorruptFrame("tensor header shape/length mismatch")
        if zlib.crc32(view[off:off + nbytes]) != bcrc:
            raise CorruptFrame("tensor blob checksum mismatch")
        a = np.frombuffer(raw, dtype=dt, count=count,
                          offset=off).reshape(shape)
        arrays.append(host_tensor(a).view(torch.bfloat16) if bf16 else a)
        flags_of.append(flags)
        off += nbytes
    msg = _SafeUnpickler(io.BytesIO(skel)).load()
    if not isinstance(msg, TENSOR_TYPES):
        raise pickle.UnpicklingError(
            f"not a tensor-frame message: {type(msg).__name__}")

    def fill(o):
        if isinstance(o, _TensorRef):
            if not 0 <= o.idx < len(arrays):
                raise CorruptFrame(f"tensor ref {o.idx} out of range")
            return arrays[o.idx]
        if isinstance(o, QuantLeaf):
            # the skeleton's quantizer parameters must agree with the
            # flags stamped on the code blob's header
            if isinstance(o.q, _TensorRef) \
                    and 0 <= o.q.idx < len(flags_of):
                want = ((TENSOR_FLAG_PACKED4 if o.bits == 4 else 0)
                        | (TENSOR_FLAG_TILED if o.tile else 0))
                if flags_of[o.q.idx] != want:
                    raise CorruptFrame(
                        "quantized blob flags disagree with skeleton "
                        f"(header {flags_of[o.q.idx]:#x}, skeleton "
                        f"bits={o.bits} tile={o.tile})")
            return QuantLeaf(q=fill(o.q), scale=fill(o.scale),
                             bits=o.bits, tile=o.tile, shape=o.shape)
        if isinstance(o, SparseLeaf):
            idx, val = fill(o.idx), fill(o.val)
            # bounds-checked here, where a decode error costs one
            # message, not at densify time on the training thread
            n = int(math.prod(o.shape)) if o.shape else 1
            if isinstance(idx, np.ndarray):
                if np.shape(idx) != np.shape(val):
                    raise CorruptFrame("sparse leaf idx/val length "
                                       "mismatch")
                if idx.size and (int(idx.min()) < 0
                                 or int(idx.max()) >= n):
                    raise CorruptFrame(
                        f"sparse leaf index out of range for shape "
                        f"{o.shape}")
            return SparseLeaf(idx=idx, val=val, shape=o.shape)
        if isinstance(o, dict):
            return {k: fill(v) for k, v in o.items()}
        if isinstance(o, list):
            return [fill(v) for v in o]
        if isinstance(o, tuple):
            return tuple(fill(v) for v in o)
        return o

    out = type(msg)(**{f.name: fill(getattr(msg, f.name))
                       for f in dataclasses.fields(msg)})
    if ctx_len:
        out._ctx = bytes(ctx)
    return out


def encode(msg, ctx: bytes = b"") -> bytes:
    """One complete frame: TENSOR framing for the data-plane payload
    types and UPDATE, the pickled frame for everything else."""
    if type(msg).__name__ not in _TYPE_BY_NAME:
        raise TypeError(f"not a protocol message: {type(msg)!r}")
    if isinstance(msg, TENSOR_TYPES):
        return _encode_tensor(msg, ctx)
    return encode_pickled(msg)


def decode(raw: bytes):
    """Decode one COMPLETE frame (either framing).  Chunk frames only
    make sense inside a :class:`FrameAssembler`."""
    if len(raw) < _HDR_LEN:
        raise CorruptFrame(
            f"protocol frame missing magic/header ({len(raw)} bytes)")
    magic = raw[:4]
    if magic == TENSOR_MAGIC:
        return _decode_tensor(raw)
    if magic == CHUNK_MAGIC:
        raise CorruptFrame("chunk frame outside a FrameAssembler")
    if magic != FRAME_MAGIC:
        raise CorruptFrame(
            f"protocol frame missing magic/header ({len(raw)} bytes)")
    return _decode_pickled(raw)


# -- chunking ---------------------------------------------------------------

#: one frame's size cap before it is split into SLTC chunks
#: (config: ``transport.chunk-mb``)
DEFAULT_CHUNK_BYTES = 512 << 20
_CHUNK_HDR = 16 + 8 + 2        # uuid | u32 idx | u32 total | u16 ctx-len
_MAX_CHUNKS = 1 << 16

#: assembled-frame sanity cap (``SLT_MAX_ASSEMBLED_GB`` on each endpoint
#: process): a corrupt chunk stream must not drive an unbounded
#: reassembly; exceeding it is a counted corrupt frame
try:
    MAX_ASSEMBLED_BYTES = int(
        float(os.environ.get("SLT_MAX_ASSEMBLED_GB", "8")) * (1 << 30))
except ValueError:
    MAX_ASSEMBLED_BYTES = 1 << 33


def encode_parts(msg, max_bytes: int | None = None,
                 ctx: bytes = b"") -> list[bytes]:
    """Encode into one or more publishable frames: a single complete
    frame when it fits ``max_bytes``, else crc'd SLTC chunks carrying a
    shared message id (per-queue FIFO keeps a message's chunks
    together; out-of-order arrival within the id is still handled)."""
    if len(ctx) > _MAX_CTX_BYTES:
        raise ValueError(f"trace context of {len(ctx)} bytes exceeds "
                         f"the {_MAX_CTX_BYTES}-byte cap")
    frame = encode(msg, ctx)
    cap = int(max_bytes) if max_bytes else DEFAULT_CHUNK_BYTES
    if len(frame) <= cap:
        return [frame]
    mid = uuid.uuid4().bytes
    total = -(-len(frame) // cap)
    if total > _MAX_CHUNKS:
        raise ValueError(f"frame of {len(frame)} bytes needs {total} "
                         f"chunks (cap {_MAX_CHUNKS})")
    view = memoryview(frame)
    parts = []
    for idx in range(total):
        body = b"".join([mid, struct.pack(">II", idx, total),
                         struct.pack(">H", len(ctx)), ctx,
                         view[idx * cap:(idx + 1) * cap]])
        parts.append(CHUNK_MAGIC + struct.pack(">I", zlib.crc32(body))
                     + body)
    return parts


class FrameAssembler:
    """Per-consumer reassembly of SLTC chunk streams.

    ``feed`` returns the decoded message once complete (immediately for
    unchunked frames), or None while a chunked message is still partial.
    At most ``max_pending`` partial messages are held (the stalest is
    evicted).  Not thread-safe: one assembler per consumer thread.
    ``last_bytes`` holds the wire byte count of the most recently
    completed message."""

    def __init__(self, max_pending: int = 64, faults=None):
        self._max_pending = max_pending
        self._faults = faults
        self.last_bytes = 0
        self._pending: collections.OrderedDict = collections.OrderedDict()
        # mids whose partial was evicted: their LATE chunks are dropped
        self._evicted: collections.OrderedDict = collections.OrderedDict()

    def _count_oversize(self) -> None:
        if self._faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            self._faults = default_fault_counters
        self._faults.inc("oversize_frames")

    def feed(self, raw: bytes):
        if raw[:4] != CHUNK_MAGIC:
            if len(raw) > MAX_ASSEMBLED_BYTES:
                self._count_oversize()
                raise CorruptFrame(
                    f"frame of {len(raw)} bytes exceeds the "
                    f"{MAX_ASSEMBLED_BYTES}-byte assembled cap")
            self.last_bytes = len(raw)
            return decode(raw)
        if len(raw) < _HDR_LEN + _CHUNK_HDR:
            raise CorruptFrame(f"chunk frame truncated ({len(raw)} bytes)")
        (want,) = struct.unpack_from(">I", raw, 4)
        body = memoryview(raw)[8:]
        if zlib.crc32(body) != want:
            raise CorruptFrame("chunk frame checksum mismatch")
        mid = bytes(body[:16])
        idx, total = struct.unpack_from(">II", body, 16)
        if not 0 < total <= _MAX_CHUNKS or idx >= total:
            raise CorruptFrame(f"chunk index {idx}/{total} out of range")
        (ctx_len,) = struct.unpack_from(">H", body, 24)
        if ctx_len > _MAX_CTX_BYTES or _CHUNK_HDR + ctx_len > len(body):
            raise CorruptFrame(f"chunk frame claims {ctx_len}-byte "
                               "trace context")
        ctx = bytes(body[_CHUNK_HDR:_CHUNK_HDR + ctx_len])
        if mid in self._evicted:
            return None
        ent = self._pending.get(mid)
        if ent is None:
            ent = self._pending[mid] = {"total": total, "parts": {},
                                        "ctx": ctx, "bytes": 0}
            while len(self._pending) > self._max_pending:
                dead, _ = self._pending.popitem(last=False)
                self._evicted[dead] = True
                while len(self._evicted) > 4 * self._max_pending:
                    self._evicted.popitem(last=False)
        if ent["total"] != total:
            raise CorruptFrame("chunk total mismatch within message")
        if idx not in ent["parts"]:
            ent["parts"][idx] = body[_CHUNK_HDR + ctx_len:]
            ent["bytes"] += len(raw)
            if ent["bytes"] > MAX_ASSEMBLED_BYTES:
                del self._pending[mid]
                self._evicted[mid] = True
                self._count_oversize()
                raise CorruptFrame(
                    f"chunked message exceeds the "
                    f"{MAX_ASSEMBLED_BYTES}-byte assembled cap "
                    f"({ent['bytes']} bytes across "
                    f"{len(ent['parts'])}/{total} chunks)")
        if len(ent["parts"]) < total:
            return None
        del self._pending[mid]
        self.last_bytes = ent["bytes"]
        msg = decode(b"".join(ent["parts"][i] for i in range(total)))
        if ent["ctx"] and getattr(msg, "_ctx", None) is None:
            msg._ctx = ent["ctx"]
        return msg
