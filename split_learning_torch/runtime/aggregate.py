"""Streaming aggregation plane.

Port of the flat part of the JAX package's ``runtime/aggregate.py``:

* :class:`StreamingFold` — an incremental per-stage weighted-sum
  accumulator.  Each Update folds into a running sum the moment the
  server decodes it, so the UPDATE barrier holds O(1) parameter trees
  instead of O(clients).  Contributions fold in the canonical
  ``(stage, client_id)`` order whatever order frames arrive — a reorder
  window holds early arrivals until their predecessors land (or are
  dropped) — so the float summation sequence is the barrier oracle's
  (``aggregate_cluster`` over the client-id-sorted list) and the result
  is bit-identical to it.  Async mode's late contributions fold at a
  staleness-scaled weight under their own keys, at finish.
* :class:`HostFoldBackend` — numpy accumulate/divide, the single-host
  default.
* :class:`CudaFoldBackend` — the counterpart of the JAX package's
  ``MeshFoldBackend`` on a one-device ``agg`` axis: accumulators,
  velocity and the fused per-stage round-boundary update live on the
  card.  With ``kernels.stage-update`` on, each eligible leaf goes
  through the finalize or momentum kernel (``ops/kernels/update.py``);
  otherwise through the same plain chain.  Both backends replicate the
  host fold op for op, so they are bit-identical on the CPU.
* server-side optimizer (``aggregation.server-momentum``, FedAvgM):
  ``v = m·v + (base - avg); new = base - v`` inside the finish; with
  ``m = 0`` this is plain FedAvg.

The aggregator tree (``L1Aggregator``, ``plan_tree``, partial
aggregates) and the legacy per-leaf finish (``update-sharded: false``)
wait for later slices.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

from split_learning_torch.device import resolve_device
from split_learning_torch.ops import kernels as kplane
from split_learning_torch.ops.fedavg import is_int_dtype as _torch_is_int
from split_learning_torch.ops.fedavg import unflatten_items as _unflatten
from split_learning_torch.ops.fedavg import walk_items as _flat_items
from split_learning_torch.ops.kernels import update as kupd
from split_learning_torch.runtime.protocol import Update, host_tensor

#: strategies whose per-invocation aggregation consumes the WHOLE update
#: list at once — the only shape a streaming fold can replace
FOLD_STRATEGIES = frozenset({"fedavg", "sda", "cluster_relay"})


class UpdateBatch(list):
    """``train_cluster``'s return value when a streaming fold ran: the
    (weight-stripped) Update list plus the precomputed fold result that
    ``aggregate_cluster`` consumes instead of re-folding."""
    fold: "FoldResult | None" = None


@dataclasses.dataclass
class FoldResult:
    params: Any
    stats: Any
    n_samples: int
    fold_s: float = 0.0            # wall spent folding (overlapped)
    peak_tree_copies: float = 0.0  # window HWM in full-tree equivalents
    window_hwm: int = 0            # most simultaneous held contributions
    folded: int = 0                # contributions folded
    update_s: float = 0.0          # round-boundary update wall
    stage_update_ms: dict = dataclasses.field(default_factory=dict)


def _is_int(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return _torch_is_int(dtype)
    return np.dtype(dtype).kind in "biu"


def _leaf_tensor(leaf) -> torch.Tensor:
    """A wire leaf (numpy array, or CPU tensor) as a tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return host_tensor(np.ascontiguousarray(leaf))


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def _tree_nbytes(tree) -> int:
    return sum(_nbytes(leaf) for _, leaf in _flat_items(tree))


# --------------------------------------------------------------------------
# fold backends
# --------------------------------------------------------------------------
# Both replicate ops/fedavg.py's fold op for op:
#   t   = nan_to_num(leaf.astype(f32)) * w
#   acc = t | acc + t          (canonical order)
#   avg = acc / total_w        (int leaves: round first)
# so a streamed fold is bit-identical to the barrier fold.

def _mom_path_set(st: "_StageFold", base_flat, momentum: float) -> set:
    """Paths the FedAvgM step applies to: float leaves present in the
    base tree (int leaves and paths outside the base keep plain
    FedAvg)."""
    if not momentum or base_flat is None:
        return set()
    return {p for p in st.acc
            if p in base_flat and not _is_int(st.dtype[p])}


def _stage_velocity(st: "_StageFold", base_flat, velocity,
                    mom_paths: set) -> dict:
    """This stage's usable velocity entries (a velocity shaped for
    another tensor restarts from zero)."""
    out = {}
    for p in mom_paths:
        vel = (velocity or {}).get(p)
        if vel is not None and tuple(vel.shape) != tuple(
                base_flat[p].shape):
            vel = None
        out[p] = vel
    return out


class HostFoldBackend:
    """Numpy accumulate/divide — the single-host default."""

    name = "host"

    def dtype_of(self, leaf):
        return np.asarray(leaf).dtype

    def contrib(self, leaf, w) -> np.ndarray:
        return np.nan_to_num(np.asarray(leaf, dtype=np.float32)) * w

    def add(self, acc, t):
        return acc + t

    def finalize(self, acc, total_w: float, dtype) -> np.ndarray:
        avg = acc / np.float32(total_w)
        if _is_int(dtype):
            return np.round(avg).astype(dtype)
        return avg.astype(dtype)

    def momentum_step(self, base, avg32, vel, m: float):
        """FedAvgM: returns (new_param_f32, new_velocity)."""
        b = np.asarray(base, dtype=np.float32)
        v = m * vel + (b - avg32) if vel is not None else (b - avg32)
        return b - v, v

    def stage_update(self, st: "_StageFold", base_flat, velocity,
                     momentum: float):
        """Fused per-stage round-boundary update, host twin: FedAvg
        divide + FedAvgM step + cast back to the leaf's wire dtype for
        every leaf of one stage.  Returns host (params, stats, new
        velocity) trees."""
        mom_paths = _mom_path_set(st, base_flat, momentum)
        vels = _stage_velocity(st, base_flat, velocity, mom_paths)
        params: dict = {}
        new_vel: dict = {}
        for path, acc in st.acc.items():
            dt = st.dtype[path]
            if path in mom_paths:
                avg32 = self.finalize(acc, st.total_w,
                                      np.dtype(np.float32))
                base = base_flat[path]
                if isinstance(base, torch.Tensor):
                    base = base.detach().cpu().numpy()
                vel = vels[path]
                if isinstance(vel, torch.Tensor):
                    vel = vel.cpu().numpy()
                new32, nv = self.momentum_step(base, avg32, vel, momentum)
                new_vel[path] = nv
                params[path] = np.asarray(new32).astype(dt)
            else:
                params[path] = self.finalize(acc, st.total_w, dt)
        stats = {p: self.finalize(a, st.stat_total_w, st.stat_dtype[p])
                 for p, a in st.stat_acc.items()}
        st.acc, st.stat_acc = {}, {}
        return params, stats, new_vel


class CudaFoldBackend:
    """Accumulate, divide and optimizer step on the card
    (``aggregation.sharded``): the one-device counterpart of the JAX
    package's mesh backend.

    Each contribution is copied to the device once and added into the
    stage's running float32 sum IN PLACE — the counterpart of the mesh
    backend's donated accumulator buffer: per-client fold cost is one
    elementwise add with no fresh allocation.  The fused stage update
    runs the finalize/momentum kernels when ``kernels.stage-update`` is
    on; the new velocity stays on the device between rounds.  On a CPU
    device (the tests) every op takes its plain version."""

    name = "cuda"

    def __init__(self, device=None, kernels=None):
        self.device = resolve_device(device)
        # kernel plan captured at construction, so one backend's
        # updates are self-consistent
        self._kplan = kplane.as_plan(kernels)

    def dtype_of(self, leaf):
        return _leaf_tensor(leaf).dtype

    def _put(self, leaf) -> torch.Tensor:
        return _leaf_tensor(leaf).to(self.device, torch.float32)

    def contrib(self, leaf, w) -> torch.Tensor:
        t = _leaf_tensor(leaf).to(self.device)
        return torch.nan_to_num(t.to(torch.float32)) * w

    def add(self, acc, t):
        return acc.add_(t)

    def _finish_leaf(self, acc, tw: float, dt, base=None, vel=None,
                     m: float = 0.0):
        kernel = self._kplan.stage_update and kupd.kernel_ok(acc)
        if base is not None:
            fn = kupd.momentum_leaf if kernel else kupd.momentum_reference
            return fn(acc, base, vel, tw, m, dt)
        if kernel:
            return kupd.finalize_leaf(acc, tw, dt, rnd=_is_int(dt)), None
        return kupd.finalize_reference(acc, tw, dt, _is_int(dt)), None

    def stage_update(self, st: "_StageFold", base_flat, velocity,
                     momentum: float):
        """One stage's fused update on the device.  Returns (params,
        stats, new velocity) trees of device tensors."""
        mom_paths = _mom_path_set(st, base_flat, momentum)
        vels = _stage_velocity(st, base_flat, velocity, mom_paths)
        params: dict = {}
        new_vel: dict = {}
        for path in sorted(st.acc):
            acc, dt = st.acc[path], st.dtype[path]
            if path in mom_paths:
                base = self._put(base_flat[path]).contiguous()
                vel = vels[path]
                vel = (torch.zeros_like(base) if vel is None
                       else self._put(vel).contiguous())
                params[path], new_vel[path] = self._finish_leaf(
                    acc, st.total_w, dt, base, vel, momentum)
            else:
                params[path], _ = self._finish_leaf(acc, st.total_w, dt)
        stats = {p: self._finish_leaf(st.stat_acc[p], st.stat_total_w,
                                      st.stat_dtype[p])[0]
                 for p in sorted(st.stat_acc)}
        st.acc, st.stat_acc = {}, {}   # consumed
        return params, stats, new_vel


def make_fold_backend(cfg, device=None):
    """The CUDA backend for ``aggregation.sharded`` (on ``device``),
    else the numpy host fold."""
    if getattr(cfg.aggregation, "sharded", False):
        return CudaFoldBackend(device=device,
                               kernels=getattr(cfg, "kernels", None))
    return HostFoldBackend()


# --------------------------------------------------------------------------
# the streaming fold
# --------------------------------------------------------------------------

class _StageFold:
    """Per-stage canonical-order fold state."""

    def __init__(self, order: list):
        self.order = list(order)          # canonical fold order (keys)
        self.order_set = set(self.order)
        self.next = 0                     # next canonical position
        self.pending: dict = {}           # key -> held contribution
        self.extras: dict = {}            # keys outside the plan
        self.folded: set = set()
        self.gone: set = set()            # dropped; stop waiting for them
        self.acc: dict = {}               # path -> backend accumulator
        self.dtype: dict = {}             # path -> original dtype
        self.total_w: float = 0.0
        self.stat_acc: dict = {}
        self.stat_dtype: dict = {}
        self.stat_total_w: float = 0.0


class StreamingFold:
    """Incremental per-stage weighted FedAvg with a canonical-order
    reorder window.

    ``expected`` maps stage -> the ordered list of contribution keys
    (client ids).  Duplicate contributions for a key are dropped and
    counted (``agg_dup_drops``).  Thread-safe."""

    def __init__(self, expected: dict, *, backend=None, faults=None):
        self.backend = backend if backend is not None else HostFoldBackend()
        if faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            faults = default_fault_counters
        self.faults = faults
        self._lock = threading.Lock()
        self._stages = {int(s): _StageFold(keys)
                        for s, keys in expected.items()}
        self.n_samples = 0
        self.fold_s = 0.0
        self.folded = 0
        self._held_bytes = 0
        self._held_hwm_bytes = 0
        self.window_hwm = 0
        self._finished = None

    # -- ingest --------------------------------------------------------------

    def add_update(self, u: Update, *, scale: float = 1.0,
                   key: str | None = None) -> None:
        """Fold one client Update (params may be None — a weight-less
        update occupies its canonical slot, counts stage-1 samples, and
        contributes nothing, like the barrier oracle skips it).

        ``scale`` multiplies the FedAvg weight (async mode's staleness
        decay, ``staleness-decay ** lag``); at 1.0 the integer weight is
        kept, so a sync fold stays bit for bit the barrier oracle's.
        ``key`` overrides the fold key: a stale-admitted contribution
        folds under ``client@vN``, which never collides with the same
        client's fresh slot and folds (sorted) at finish."""
        if getattr(u, "delta_base", None) is not None:
            raise ValueError(
                f"delta-encoded Update from {u.client_id} reached the "
                "streaming fold un-reconstructed")
        self._enqueue(int(u.stage), key or u.client_id, (u, scale),
                      0 if u.params is None else _tree_nbytes(u.params))

    def drop(self, stage: int, key: str) -> None:
        """The key will never contribute (client dropped at a barrier):
        stop holding the window for it."""
        with self._lock:
            st = self._stages.get(int(stage))
            if st is None:
                return
            st.gone.add(key)
            self._drain(st)

    def _enqueue(self, stage: int, key, item: tuple, nbytes: int) -> None:
        with self._lock:
            st = self._stages.get(stage)
            if st is None:
                # a stage outside the plan: fold deterministically at
                # finish (sorted), never silently dropped
                st = self._stages[stage] = _StageFold([])
            if key in st.folded or key in st.pending or key in st.extras:
                self.faults.inc("agg_dup_drops")
                return
            if key not in st.order_set or key in st.gone:
                st.extras[key] = item
            else:
                st.pending[key] = item
            self._held_bytes += nbytes
            self._held_hwm_bytes = max(self._held_hwm_bytes,
                                       self._held_bytes)
            self.window_hwm = max(
                self.window_hwm,
                sum(len(s.pending) + len(s.extras)
                    for s in self._stages.values()))
            self._drain(st)

    # -- canonical-order drain ----------------------------------------------

    def _drain(self, st: _StageFold) -> None:
        while st.next < len(st.order):
            k = st.order[st.next]
            item = st.pending.pop(k, None)
            if item is None:
                if k in st.gone or k in st.folded:
                    st.next += 1
                    continue
                return   # window holds until the predecessor lands
            self._fold_item(st, k, item)
            st.next += 1

    def _fold_item(self, st: _StageFold, key, item: tuple) -> None:
        t0 = time.perf_counter()
        u, scale = item
        if u.stage == 1:
            self.n_samples += u.num_samples
        if u.params is not None:
            self._held_bytes -= _tree_nbytes(u.params)
            # the INT weight keeps the float summation bit-identical to
            # the barrier oracle; the staleness decay scales it only
            # when it decays
            w = max(1, u.num_samples)
            if scale != 1.0:
                w = w * float(scale)
            st.total_w += w
            self._fold_tree(st.acc, st.dtype, u.params, w)
            if u.batch_stats:
                st.stat_total_w += w
                self._fold_tree(st.stat_acc, st.stat_dtype, u.batch_stats,
                                w)
        st.folded.add(key)
        self.folded += 1
        self.fold_s += time.perf_counter() - t0

    def _fold_tree(self, acc: dict, dtypes: dict, tree, w) -> None:
        be = self.backend
        for path, leaf in _flat_items(tree):
            c = be.contrib(leaf, w)
            if path in acc:
                acc[path] = be.add(acc[path], c)
            else:
                acc[path] = c
                dtypes[path] = be.dtype_of(leaf)

    def _drain_all(self) -> None:
        for st in self._stages.values():
            st.gone |= set(st.order)      # stop waiting; fold arrivals
            self._drain(st)
            for k in sorted(st.extras, key=str):
                self._fold_item(st, k, st.extras.pop(k))

    # -- results -------------------------------------------------------------

    def finish(self, base=None, momentum: float = 0.0,
               velocity: dict | None = None, *, fused: bool = True,
               on_stage=None) -> FoldResult:
        """The round-boundary update: FedAvg divide (+ optional server
        momentum vs ``base``) + cast back to each leaf's wire dtype, in
        canonical stage order; idempotent (returns the first result).

        Each stage's whole update runs as one backend call (the fused
        ``aggregation.update-sharded`` form).  ``velocity`` (a
        {path: tensor} dict the caller keeps between rounds) is updated
        in place.  ``on_stage(stage, stage_params, stage_stats)`` is
        called per stage, in ascending order, the moment that stage's
        trees exist."""
        if not fused:
            raise NotImplementedError(
                "aggregation.update-sharded: false (the per-leaf legacy "
                "finish) is not ported; the fused per-stage update is")
        with self._lock:
            if self._finished is not None:
                return self._finished
            self._drain_all()
            be = self.backend
            t0 = time.perf_counter()
            params: dict = {}
            stats: dict = {}
            stage_ms: dict = {}
            base_flat = (dict(_flat_items(base))
                         if (momentum and base is not None) else None)
            for s in sorted(self._stages):
                st = self._stages[s]
                if not st.acc and not st.stat_acc:
                    continue
                t_s = time.perf_counter()
                flat_p, flat_s, new_vel = be.stage_update(
                    st, base_flat, velocity, momentum)
                if velocity is not None:
                    velocity.update(new_vel)
                stage_p = _unflatten(flat_p)
                stage_s = _unflatten(flat_s)
                params.update(stage_p)
                stats.update(stage_s)
                stage_ms[s] = round((time.perf_counter() - t_s) * 1e3, 3)
                if on_stage is not None:
                    on_stage(s, stage_p, stage_s)
            update_s = time.perf_counter() - t0
            self.fold_s += update_s
            result_bytes = _tree_nbytes(params)
            peak = (1.0 + self._held_hwm_bytes / result_bytes
                    if result_bytes else float(bool(self.window_hwm)))
            self._finished = FoldResult(
                params=params, stats=stats, n_samples=self.n_samples,
                fold_s=round(self.fold_s, 6),
                peak_tree_copies=round(peak, 3),
                window_hwm=self.window_hwm, folded=self.folded,
                update_s=round(update_s, 6), stage_update_ms=stage_ms)
            return self._finished
