"""Delta-encoded Update frames — the rpc wire codec
(``transport.codec: {rpc: "delta:int8"}``).

Port of the JAX package's ``runtime/codec/delta.py``.  A round's UPDATE
is the biggest frame a client publishes (the trained shard, float32),
but the server sent this client a shard in START, and after one round
the trained weights sit a small step away from it.  So the client ships
``trained - base`` instead, quantized (bf16, or tiled int8) with a
client-side error-feedback residual, tagged with the base's **version**
(the server's per-invocation generation).

Both ends keep the base: the client the weights exactly as its START
carried them, the server a **versioned shadow copy per client**
(:class:`DeltaShadow`, recorded at the START fan-out), and the server
folds ``base + dequant(delta)`` back into a full tree before
aggregation.  The server advertises the shadow's version in every START
(``extra["delta_base_version"]``) and the client sends a delta only
when its base carries that version; otherwise (a restarted client, a
hold round whose base drifted, a server without a shadow) it sends the
full float32 frame (counted ``delta_full_frames``).  A delta against a
version the shadow lacks is dropped (``delta_resyncs``) and the client
is re-seeded with a full START next round.

This runs once a round on host trees, so the quantizer is the numpy
twin in :mod:`~split_learning_torch.runtime.codec.quant`, on the host,
as in the JAX package.  Leaves are numbered in the JAX package's
flattening order (dict keys sorted), so the residual of leaf ``i`` is
the same tensor's in both packages.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from split_learning_torch.runtime.codec.quant import (
    dequantize_leaf_np, quantize_np,
)
from split_learning_torch.runtime.codec.specs import CodecSpec
from split_learning_torch.runtime.protocol import QuantLeaf


def _map_leaves(fn, *trees):
    """``fn(i, *leaves)`` over trees of one structure, the leaves
    numbered in sorted-key order; a structure mismatch raises
    ``ValueError``."""
    counter = [0]

    def walk(*ts):
        t = ts[0]
        if isinstance(t, dict):
            if any(not isinstance(x, dict) or set(x) != set(t)
                   for x in ts[1:]):
                raise ValueError("delta base/params structure mismatch")
            return {k: walk(*(x[k] for x in ts)) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            if any(len(x) != len(t) for x in ts[1:]):
                raise ValueError("delta base/params structure mismatch")
            return type(t)(walk(*xs) for xs in zip(*ts))
        i = counter[0]
        counter[0] += 1
        return fn(i, *ts)
    return walk(*trees)


def _host32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().float().numpy()
    return np.asarray(leaf, np.float32)


def _is_float(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype.is_floating_point
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


class DeltaCodec:
    """Client half: encode ``trained - base`` (+ error-feedback
    residual)."""

    name = "delta"
    COUNTERS = ("delta_folds", "delta_full_frames", "delta_resyncs",
                "quant_nonfinite")

    def __init__(self, spec: CodecSpec, faults=None):
        self.delta_dtype = spec.delta_dtype
        self.tile = spec.tile
        if faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            faults = default_fault_counters
        self.faults = faults
        # leaf index -> residual (what quantization dropped last round)
        self._res: dict[int, np.ndarray] = {}

    def encode_update(self, params: Any, base: Any) -> Any:
        """Trained tree + base tree (host arrays, one structure) ->
        the quantized delta tree: :class:`QuantLeaf` leaves for int8,
        bfloat16 CPU tensors for bf16; non-float leaves ship whole."""
        def enc(i, p, b):
            if not _is_float(p):
                return p
            p32 = _host32(p)
            res = self._res.get(i)
            if res is not None and res.shape != p32.shape:
                # a re-plan moved this client's layer range: leaf i is
                # another tensor now, its old residual is dropped
                res = None
            d = (p32 - _host32(b)
                 + (res if res is not None else np.float32(0.0)))
            if self.delta_dtype == "int8":
                leaf = quantize_np(d, self.tile, bits=8)
                if not np.isfinite(np.asarray(leaf.scale)).all():
                    self.faults.inc("quant_nonfinite")
                sent = dequantize_leaf_np(leaf)
            else:
                leaf = torch.from_numpy(d).to(torch.bfloat16)
                sent = leaf.float().numpy()
            self._res[i] = d - sent
            return leaf
        return _map_leaves(enc, params, base)

    # -- checkpointable residual state ---------------------------------

    def state_dict(self) -> dict[str, np.ndarray]:
        return {f"delta|{i}": np.asarray(r)
                for i, r in sorted(self._res.items())}

    def load_state_dict(self, state: dict) -> None:
        self._res = {}
        for name, arr in state.items():
            _, _, i = name.rpartition("|")
            self._res[int(i)] = _host32(arr)


def decode_delta_tree(delta: Any) -> Any:
    """Quantized delta tree -> float32 host delta tree (server side).
    Non-float leaves carry the full trained value and stay as they
    are."""
    def dec(_, leaf):
        if isinstance(leaf, QuantLeaf):
            return dequantize_leaf_np(leaf)
        if _is_float(leaf):
            return _host32(leaf)
        return np.asarray(leaf)
    return _map_leaves(dec, delta)


class DeltaShadow:
    """Server half: a versioned shadow copy per client, and the fold.

    ``note_sent`` records the exact tree a START carried (keyed by the
    invocation's generation); ``fold`` reconstructs a delta UPDATE
    against it.  One version per client suffices: a client only ever
    holds its latest base, and a delta against another means the chain
    broke, which ``fold`` refuses."""

    def __init__(self, faults=None):
        if faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            faults = default_fault_counters
        self.faults = faults
        self._shadow: dict[str, tuple[int, Any]] = {}
        self._nbytes_by_client: dict[str, int] = {}
        # note_sent and fold run on the round thread, clear may not
        self._lock = threading.Lock()

    @staticmethod
    def _tree_nbytes(tree: Any) -> int:
        total = [0]

        def count(_, leaf):
            total[0] += int(np.asarray(leaf).nbytes)
            return leaf
        _map_leaves(count, tree)
        return total[0]

    def note_sent(self, client_id: str, version: int, tree: Any) -> None:
        n = self._tree_nbytes(tree)
        with self._lock:
            self._nbytes_by_client[client_id] = n
            self._shadow[client_id] = (version, tree)

    def version_for(self, client_id: str) -> int | None:
        with self._lock:
            ent = self._shadow.get(client_id)
        return ent[0] if ent is not None else None

    def clear(self, client_id: str | None = None) -> None:
        with self._lock:
            if client_id is None:
                self._shadow.clear()
                self._nbytes_by_client.clear()
            else:
                self._shadow.pop(client_id, None)
                self._nbytes_by_client.pop(client_id, None)

    def nbytes(self) -> int:
        """Host bytes pinned across every client's shadow tree."""
        with self._lock:
            return sum(self._nbytes_by_client.values())

    def fold(self, client_id: str, base_version: int,
             delta: Any) -> Any | None:
        """``base + dequant(delta)`` as a full tree (float leaves back
        in the base's dtype), or None when the shadow does not hold
        ``base_version`` for this client (the caller re-seeds it)."""
        with self._lock:
            ent = self._shadow.get(client_id)
        if ent is None or ent[0] != base_version:
            self.faults.inc("delta_resyncs")
            return None
        self.faults.inc("delta_folds")

        def comb(_, b, d):
            b = np.asarray(b)
            if np.issubdtype(b.dtype, np.floating):
                return (b.astype(np.float32)
                        + np.asarray(d, np.float32)).astype(b.dtype)
            return np.asarray(d)   # non-float leaves ship whole
        return _map_leaves(comb, ent[1], decode_delta_tree(delta))
