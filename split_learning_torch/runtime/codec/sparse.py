"""Top-k gradient sparsification with error feedback — the gradient
wire codec (``transport.codec: {gradient: "topk:0.05"}``).

Port of the JAX package's ``runtime/codec/sparse.py``.  Each published
gradient keeps only the k largest-magnitude entries of (gradient +
residual); what is not sent accumulates in a client-side
**error-feedback residual** and rides the next publish to the same
destination, so the training signal is delayed, never lost.

* The residual starts at zeros and advances on the training thread at
  prepare time, in publish order: the published stream is a function of
  the training stream alone, whatever the channel does below.
* Selection runs on the gradient's device (``torch.topk`` on
  ``|acc|``; the JAX package's ``jax.lax.top_k`` under ``jit``, no
  Pallas kernel), and the chosen indices are sorted so the wire bytes
  are order-canonical.  Among entries of equal magnitude the two
  libraries may keep different ones; where those are zeros (a ReLU
  boundary) the densified tensor and the residual are the same.
* The state is keyed by (destination queue, leaf index): the SDA head's
  per-origin gradient returns each keep their own residual.

The residual is checkpointable (``state_dict`` / ``load_state_dict``;
the client writes it as a sidecar beside its checkpoint).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from split_learning_torch.runtime.codec.specs import CodecSpec
from split_learning_torch.runtime.protocol import (
    CorruptFrame, Float0, SparseLeaf, host_tensor,
)

#: leaves smaller than this ship dense (index+value overhead would
#: exceed the dense bytes)
MIN_SPARSE_SIZE = 64


class DevTopK:
    """Device-staged sparse leaf (indices and values still on the
    device); :meth:`TopKCodec.encode` turns it into a wire
    :class:`SparseLeaf`."""

    def __init__(self, idx: torch.Tensor, val: torch.Tensor, shape: tuple):
        self.idx = idx
        self.val = val
        self.shape = tuple(int(s) for s in shape)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def topk_dev(g: torch.Tensor, res: torch.Tensor, k: int):
    """(ascending int32 indices, their values, new residual) of one
    gradient flattened to float32 plus its residual."""
    acc = g.reshape(-1).to(torch.float32) + res
    idx = torch.topk(acc.abs(), k, sorted=False).indices
    idx = torch.sort(idx).values      # canonical wire order
    val = acc[idx]
    new_res = acc.index_fill(0, idx, 0.0)
    return idx.to(torch.int32), val, new_res


class TopKCodec:
    """Stateful per-client top-k + error-feedback gradient codec."""

    name = "topk"
    COUNTERS = ("topk_dense_fallbacks",)

    def __init__(self, spec: CodecSpec, faults=None):
        self.frac = spec.frac
        if faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            faults = default_fault_counters
        self.faults = faults
        # (destination queue, leaf index) -> flat float32 residual
        self._res: dict[tuple[str, int], torch.Tensor] = {}

    def _k(self, n: int) -> int:
        return max(1, math.ceil(self.frac * n))

    def prepare(self, tree, key: str = ""):
        """Device-side stage (training thread: residual order is publish
        order).  ``key`` is the destination queue.  Leaves are numbered
        in the JAX package's flattening order (dict keys sorted)."""
        index = {id(leaf): i for i, leaf in enumerate(_leaves(tree))}

        def conv(leaf):
            if not (isinstance(leaf, torch.Tensor)
                    and leaf.dtype.is_floating_point):
                return leaf
            n = leaf.numel()
            if n < MIN_SPARSE_SIZE or self._k(n) >= n:
                self.faults.inc("topk_dense_fallbacks")
                return leaf
            skey = (key, index[id(leaf)])
            res = self._res.get(skey)
            if res is None or res.shape[0] != n:
                # a fresh stream, or a re-plan moved this leaf's layout:
                # another tensor's unsent mass is reset, not carried
                res = torch.zeros(n, dtype=torch.float32,
                                  device=leaf.device)
            res = res.to(leaf.device)   # a residual loaded on the host
            idx, val, self._res[skey] = topk_dev(leaf.detach(), res,
                                                 self._k(n))
            return DevTopK(idx, val, leaf.shape)
        return _map(conv, tree)

    def encode(self, prepared):
        """Host-side stage: fetch indices and values, build wire
        :class:`SparseLeaf` leaves."""
        def conv(leaf):
            if isinstance(leaf, DevTopK):
                return SparseLeaf(idx=leaf.idx.cpu().numpy(),
                                  val=leaf.val.cpu().numpy(),
                                  shape=leaf.shape)
            if isinstance(leaf, Float0):
                return np.zeros(leaf.shape, np.float32)
            if isinstance(leaf, torch.Tensor):
                t = leaf.detach().cpu()
                return t if t.dtype == torch.bfloat16 else t.numpy()
            return leaf
        return _map(conv, prepared)

    # -- checkpointable residual state ---------------------------------

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Flat ``{"<queue>|<leaf-idx>": residual}`` snapshot (CPU)."""
        return {f"{q}|{i}": r.cpu()
                for (q, i), r in sorted(self._res.items())}

    def load_state_dict(self, state: dict) -> None:
        """Residuals back from :meth:`state_dict` (host tensors or
        arrays; each moves to its gradient's device at its next
        publish)."""
        self._res = {}
        for name, arr in state.items():
            q, _, i = name.rpartition("|")
            t = arr if isinstance(arr, torch.Tensor) else host_tensor(
                np.ascontiguousarray(arr, np.float32))
            self._res[(q, int(i))] = t.to(torch.float32)


def densify_leaf(leaf: SparseLeaf, device=None) -> torch.Tensor:
    """Wire :class:`SparseLeaf` -> dense float32 tensor on ``device``
    (receiver hot path)."""
    n = math.prod(leaf.shape) if leaf.shape else 1
    idx = np.asarray(leaf.idx)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise CorruptFrame(
            f"sparse leaf index out of range for shape {leaf.shape}")
    device = torch.device("cpu" if device is None else device)
    dense = torch.zeros(n, dtype=torch.float32, device=device)
    dense[host_tensor(idx.astype(np.int64)).to(device)] = host_tensor(
        np.ascontiguousarray(leaf.val, np.float32)).to(device)
    return dense.reshape(leaf.shape)
