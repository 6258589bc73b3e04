"""Streaming aggregation plane.

Port of the JAX package's ``runtime/aggregate.py`` (its thread-mode
tree; the remote aggregator nodes wait for the telemetry plane):

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
* the aggregator tree (``aggregation.fan-in``, ``aggregation.levels``):
  :func:`plan_tree` groups the round's clients per stage into level-1
  groups of at most ``fan-in`` members, and each higher level groups
  ``fan-in`` child groups of one stage.  Clients publish their UPDATE to
  their group's ``aggregate_queue``; an :class:`L1Aggregator` thread
  folds its members in canonical order into one
  :class:`~split_learning_torch.runtime.protocol.PartialAggregate`
  (weighted float32 SUMS and their total weight, never divided) for its
  parent: an interior group's queue, or the root's rpc queue.  The root
  folds the partials at their groups' canonical positions and divides
  once.  A group whose aggregator dies is drained by the server itself
  (the direct-to-root fallback, counted ``agg_l1_fallbacks``).  The
  tree changes the summation's shape (``(a+b)+(c+d)`` against the flat
  ``((a+b)+c)+d``), so a tree round is deterministic but not bit for
  bit the flat round; it is bit for bit the flat per-client fold in the
  tree's own (stage, group, client) order.

The legacy per-leaf finish (``update-sharded: false``) waits for a
later slice.
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
from split_learning_torch.runtime.protocol import (
    RPC_QUEUE, FrameAssembler, PartialAggregate, Update, aggregate_queue,
    encode_parts, host_tensor,
)

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
    partials: int = 0              # PartialAggregate contributions
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


def _dtype_name(dtype) -> str:
    """A leaf dtype's wire name (``float32``), numpy's or torch's."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


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

    def dtype_from(self, name: str):
        return np.dtype(name)

    def contrib(self, leaf, w) -> np.ndarray:
        return np.nan_to_num(np.asarray(leaf, dtype=np.float32)) * w

    def ingest(self, sums_leaf) -> np.ndarray:
        """Adopt a PartialAggregate's float32 sum leaf as it is.
        ``nan_to_num`` as :meth:`contrib` does: a partial's sums come
        over the wire (an overflow at an aggregator) and are the one
        fold input the contribution path never sanitized; a no-op on
        finite values."""
        return np.nan_to_num(np.asarray(sums_leaf, dtype=np.float32))

    def add(self, acc, t):
        return acc + t

    def to_host(self, x) -> np.ndarray:
        return np.asarray(x)

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

    def dtype_from(self, name: str) -> torch.dtype:
        return getattr(torch, name)

    def _put(self, leaf) -> torch.Tensor:
        return _leaf_tensor(leaf).to(self.device, torch.float32)

    def contrib(self, leaf, w) -> torch.Tensor:
        t = _leaf_tensor(leaf).to(self.device)
        return torch.nan_to_num(t.to(torch.float32)) * w

    def ingest(self, sums_leaf) -> torch.Tensor:
        """A partial's float32 sums on the device as they are (a fresh
        tensor: the running sum adds into it in place)."""
        return torch.nan_to_num(self._put(sums_leaf))

    def add(self, acc, t):
        return acc.add_(t)

    def to_host(self, x) -> np.ndarray:
        return x.cpu().numpy()

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
    (client ids, or group keys at an aggregator-tree root).  Duplicate
    contributions for a key are dropped and counted (``agg_dup_drops``).
    With ``hists`` each fold of an Update or a partial into the running
    sum is observed as ``agg_fold``.  Thread-safe."""

    def __init__(self, expected: dict, *, backend=None, faults=None,
                 hists=None):
        self.backend = backend if backend is not None else HostFoldBackend()
        if faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            faults = default_fault_counters
        self.faults = faults
        self.hists = hists
        self._lock = threading.Lock()
        self._stages = {int(s): _StageFold(keys)
                        for s, keys in expected.items()}
        self.n_samples = 0
        self.fold_s = 0.0
        self.folded = 0
        self.partials = 0
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
        self._enqueue(int(u.stage), key or u.client_id, ("u", u, scale),
                      0 if u.params is None else _tree_nbytes(u.params))

    def add_partial(self, stage: int, key: str, sums, weight: float,
                    dtypes, stat_sums=None, stat_weight: float = 0.0,
                    stat_dtypes=None, n_samples: int = 0) -> None:
        """Fold one aggregator's per-stage partial SUMS at the group's
        canonical position."""
        item = ("p", dict(sums=sums, weight=weight, dtypes=dtypes,
                          stat_sums=stat_sums, stat_weight=stat_weight,
                          stat_dtypes=stat_dtypes, n_samples=n_samples))
        self._enqueue(int(stage), key, item,
                      _tree_nbytes(sums) if sums else 0)

    def has_key(self, stage: int, key) -> bool:
        """True once the key is accounted for at this stage: folded,
        held in the window, an extra, or declared gone."""
        with self._lock:
            st = self._stages.get(int(stage))
            return st is not None and (
                key in st.folded or key in st.pending
                or key in st.extras or key in st.gone)

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
        if item[0] == "u":
            self._fold_update_item(st, item[1], item[2])
        else:
            self._fold_partial_item(st, item[1])
        st.folded.add(key)
        self.folded += 1
        dt = time.perf_counter() - t0
        self.fold_s += dt
        if self.hists is not None:
            self.hists.observe("agg_fold", dt)

    def _fold_update_item(self, st: _StageFold, u: Update,
                          scale: float) -> None:
        if u.stage == 1:
            self.n_samples += u.num_samples
        if u.params is None:
            return
        self._held_bytes -= _tree_nbytes(u.params)
        # the INT weight keeps the float summation bit-identical to the
        # barrier oracle; the staleness decay scales it only when it
        # decays
        w = max(1, u.num_samples)
        if scale != 1.0:
            w = w * float(scale)
        st.total_w += w
        self._fold_tree(st.acc, st.dtype, u.params, w)
        if u.batch_stats:
            st.stat_total_w += w
            self._fold_tree(st.stat_acc, st.stat_dtype, u.batch_stats, w)

    def _fold_partial_item(self, st: _StageFold, p: dict) -> None:
        """A group's sums continue the running sum as they are; its
        total weight adds to the stage's."""
        self.partials += 1
        self.n_samples += int(p.get("n_samples") or 0)
        be = self.backend
        for acc, dty, sums_key, dt_key, w_key in (
                (st.acc, st.dtype, "sums", "dtypes", "weight"),
                (st.stat_acc, st.stat_dtype, "stat_sums", "stat_dtypes",
                 "stat_weight")):
            sums = p.get(sums_key)
            if not sums:
                continue
            if sums_key == "sums":
                self._held_bytes -= _tree_nbytes(sums)
                st.total_w += float(p[w_key])
            else:
                st.stat_total_w += float(p[w_key])
            dtypes = dict(_flat_items(p.get(dt_key) or {}))
            for path, leaf in _flat_items(sums):
                t = be.ingest(leaf)
                if path in acc:
                    acc[path] = be.add(acc[path], t)
                else:
                    acc[path] = t
                    dty[path] = be.dtype_from(dtypes.get(path, "float32"))

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

    def partial(self) -> tuple[dict, int]:
        """An aggregator's flush: per-stage weighted SUMS (host arrays),
        total weights and dtype names, never divided (the root continues
        the fold), and the stage-1 samples folded.  Terminal."""
        with self._lock:
            self._drain_all()
            out: dict = {}
            be = self.backend
            for s in sorted(self._stages):
                st = self._stages[s]
                if not st.acc and not st.stat_acc and not st.total_w:
                    continue
                out[s] = {
                    "sums": _unflatten({p: be.to_host(a)
                                        for p, a in st.acc.items()}),
                    "weight": st.total_w,
                    "dtypes": _unflatten({p: _dtype_name(d)
                                          for p, d in st.dtype.items()}),
                    "stat_sums": _unflatten(
                        {p: be.to_host(a) for p, a in st.stat_acc.items()}),
                    "stat_weight": st.stat_total_w,
                    "stat_dtypes": _unflatten(
                        {p: _dtype_name(d)
                         for p, d in st.stat_dtype.items()}),
                }
            return out, self.n_samples

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
                partials=self.partials, update_s=round(update_s, 6),
                stage_update_ms=stage_ms)
            return self._finished


# --------------------------------------------------------------------------
# the aggregator tree's plan
# --------------------------------------------------------------------------

def plan_fanin_groups(active: list, fan_in: int) -> list:
    """Partition the round's (client_id, stage) send set into level-1
    groups of at most ``fan_in`` clients, per stage (a group never spans
    stages: its partial covers one stage's slice), in canonical sorted
    order.  Returns ``[AggGroup]``."""
    by_stage: dict[int, list] = {}
    for cid, s in active:
        by_stage.setdefault(int(s), []).append(cid)
    groups: list[AggGroup] = []
    gi = 0
    for s in sorted(by_stage):
        cids = sorted(by_stage[s])
        for i in range(0, len(cids), fan_in):
            groups.append(AggGroup(idx=gi, stage=s,
                                   members=cids[i:i + fan_in]))
            gi += 1
    return groups


def plan_tree(active: list, fan_in: int, levels: int = 1) -> list:
    """:func:`plan_fanin_groups` made recursive (``aggregation.levels``):
    each level above the first folds at most ``fan_in`` child groups'
    PARTIALS of one stage (sums of sums with the total weight carried,
    so any depth still divides once, at the root).  Group indices are
    unique across levels, so a group's input queue is
    ``aggregate_queue(cluster, idx)`` whatever its level.  A stage whose
    population at some level is already one group is not wrapped again
    (a one-child node would add a hop for nothing): that group stays
    parentless and publishes to the root.  Returns every group of every
    level, canonical order within each level."""
    groups = plan_fanin_groups(active, fan_in)
    gi = len(groups)
    tier = groups
    for _ in range(2, levels + 1):
        by_stage: dict[int, list] = {}
        for g in tier:
            by_stage.setdefault(g.stage, []).append(g)
        nxt: list[AggGroup] = []
        for s in sorted(by_stage):
            kids = sorted(by_stage[s], key=lambda g: g.idx)
            if len(kids) <= 1:
                continue   # nothing to reduce at this stage
            for i in range(0, len(kids), fan_in):
                chunk = kids[i:i + fan_in]
                parent = AggGroup(idx=gi, stage=s,
                                  members=[c.key for c in chunk],
                                  level=chunk[0].level + 1)
                gi += 1
                for c in chunk:
                    c.parent = parent.idx
                nxt.append(parent)
        if not nxt:
            break
        groups += nxt
        tier = nxt
    return groups


def root_groups(groups: list) -> list:
    """The parentless groups, whose partials land at the root (in index
    order)."""
    return sorted((g for g in groups if g.parent is None),
                  key=lambda g: g.idx)


def group_key(idx: int) -> str:
    """The fold key of group ``idx`` (zero-padded, so lexicographic
    order is numeric order)."""
    return f"g{idx:05d}"


@dataclasses.dataclass
class AggGroup:
    idx: int
    stage: int
    members: list               # client ids (level 1) or child keys
    level: int = 1
    parent: int | None = None   # parent group idx; None = a root child

    @property
    def key(self) -> str:
        return group_key(self.idx)

    def as_dict(self) -> dict:
        """Plain builtins (the remote nodes' assignment form)."""
        return {"idx": self.idx, "stage": self.stage,
                "members": list(self.members), "level": self.level,
                "parent": self.parent}

    @classmethod
    def from_dict(cls, d: dict) -> "AggGroup":
        return cls(idx=int(d["idx"]), stage=int(d["stage"]),
                   members=list(d.get("members") or []),
                   level=int(d.get("level", 1)),
                   parent=d.get("parent"))


# --------------------------------------------------------------------------
# the aggregator
# --------------------------------------------------------------------------

class L1Aggregator(threading.Thread):
    """One aggregator-tree node, at any level: drains its group's
    ``aggregate_queue``, folds its members in canonical member order, and
    publishes one PartialAggregate to ``out_queue`` (the root's rpc queue
    for a parentless group, else the parent group's aggregate queue).  A
    level-1 node folds client Updates; a higher one its children's
    partials (sums of sums, total weight carried).  Frames of another
    generation are dropped (``agg_stale_drops``), a second copy of a
    member's (``agg_dup_drops``).

    ``codec`` (a ``transport.codec: partial`` spec) compresses the
    published sums (``runtime/codec/partial.py``); ``base``/``base_gen``
    are the stage's START shard for the delta mode, which an interior
    node also uses to decode its children's codec'd partials.

    Flushes when every expected member has folded, on
    :meth:`request_flush` (the server gave up on stragglers), or at
    ``deadline``.  ``TEST_KILL`` (a set of aggregator names) makes the
    thread die silently mid-round: the failure the direct-to-root
    fallback recovers from.  The fold runs on the host (numpy), as the
    JAX package's aggregators do."""

    TEST_KILL: set = set()

    def __init__(self, bus, *, cluster: int, group: AggGroup,
                 members: list, gen: int, deadline: float,
                 log=None, faults=None, chunk_bytes: int | None = None,
                 owns_bus: bool = False, out_queue: str = RPC_QUEUE,
                 codec=None, base=None, base_gen: int | None = None):
        self.agg_id = f"aggregator_{cluster}_{group.idx}"
        super().__init__(daemon=True, name=self.agg_id)
        self.bus = bus
        self.cluster = cluster
        self.group = group
        self.members = list(members)
        self.gen = gen
        self.deadline = deadline
        self.log = log
        if faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            faults = default_fault_counters
        self.faults = faults
        self.chunk_bytes = chunk_bytes
        self.owns_bus = owns_bus
        self.out_queue = out_queue
        self.codec = codec
        self.base = base
        self.base_gen = base_gen
        self.flushed = False
        self._flush = threading.Event()
        self.fold = StreamingFold({self.group.stage: self.members},
                                  faults=self.faults)
        self.asm = FrameAssembler(faults=self.faults)
        self.meta: list[dict] = []
        self.seen: set = set()

    def request_flush(self) -> None:
        self._flush.set()

    @property
    def complete(self) -> bool:
        return self.seen >= set(self.members)

    @property
    def queue(self) -> str:
        return aggregate_queue(self.cluster, self.group.idx)

    def run(self) -> None:
        try:
            while True:
                if self.agg_id in L1Aggregator.TEST_KILL:
                    return   # died mid-round: the server's fallback
                    # drains the queue direct-to-root
                raw = self.bus.get(self.queue, timeout=0.2)
                if raw is not None:
                    self.feed_raw(raw)
                if self.complete or self._flush.is_set() \
                        or time.monotonic() >= self.deadline:
                    self.publish()
                    return
        finally:
            if self.owns_bus:
                try:
                    self.bus.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass

    def feed_raw(self, raw: bytes) -> None:
        try:
            msg = self.asm.feed(raw)
        except Exception as e:  # noqa: BLE001 — one corrupt frame costs
            # one message, not the aggregator
            self.faults.inc("corrupt_rejected")
            if self.log is not None:
                self.log.warning(f"{self.agg_id}: dropping undecodable "
                                 f"frame: {e}")
            return
        if msg is None:
            return
        if isinstance(msg, Update) and self.group.level == 1:
            self._feed_update(msg)
        elif isinstance(msg, PartialAggregate) and self.group.level > 1:
            self._feed_partial(msg)

    def _feed_update(self, msg: Update) -> None:
        if msg.round_idx != self.gen:
            self.faults.inc("agg_stale_drops")
            return
        if msg.client_id in self.seen:
            self.faults.inc("agg_dup_drops")
            return
        self.seen.add(msg.client_id)
        self.fold.add_update(msg)
        self.meta.append(
            {"client_id": msg.client_id, "stage": msg.stage,
             "num_samples": msg.num_samples, "ok": msg.ok,
             "telemetry": msg.telemetry})
        if self.log is not None:
            self.log.received(f"UPDATE {msg.client_id} (L1 fold)")

    def _feed_partial(self, msg: PartialAggregate) -> None:
        """One child group's partial, dedup'd on its key as a member
        Update is: at-least-once delivery must not double-weight a whole
        group either."""
        if msg.round_idx != self.gen:
            self.faults.inc("agg_stale_drops")
            return
        key = group_key(msg.group)
        if key in self.seen:
            self.faults.inc("agg_dup_drops")
            return
        if msg.codec or msg.members_z:
            from split_learning_torch.runtime.codec.partial import (
                PartialCodecError, decode_partial_msg,
            )
            try:
                decode_partial_msg(msg, bases={msg.stage: self.base},
                                   base_gen=self.base_gen)
            except PartialCodecError as e:
                self.faults.inc("partial_codec_errors")
                if self.log is not None:
                    self.log.warning(f"{self.agg_id}: dropping "
                                     f"undecodable partial: {e}")
                return
        self.seen.add(key)
        self.fold.add_partial(msg.stage, key, msg.sums, msg.weight,
                              msg.dtypes, stat_sums=msg.stat_sums,
                              stat_weight=msg.stat_weight,
                              stat_dtypes=msg.stat_dtypes,
                              n_samples=msg.n_samples)
        self.meta.extend(msg.members or [])
        if self.log is not None:
            self.log.received(f"PARTIALAGGREGATE {msg.aggregator_id} "
                              f"(L{self.group.level} fold)")

    def publish(self) -> int:
        """Flush: one PartialAggregate (codec'd when configured) to
        ``out_queue``; returns the wire bytes published.  A second call
        publishes nothing (0 bytes)."""
        if self.flushed:
            return 0
        stages, n_samples = self.fold.partial()
        ent = stages.get(self.group.stage, {})
        codec_s = codec_base = members_z = None
        members = self.meta
        if self.codec is not None:
            from split_learning_torch.runtime.codec.partial import (
                encode_partial_entry,
            )
            from split_learning_torch.runtime.protocol import pack_members
            if ent.get("sums"):
                ent, codec_s, codec_base = encode_partial_entry(
                    ent, self.codec, base=self.base,
                    base_gen=self.base_gen, faults=self.faults)
            # the member metadata is the other O(clients) term of a
            # root partial's bytes: packed with the sums
            members_z = pack_members(members)
            if members_z is not None:
                members = None
        msg = PartialAggregate(
            aggregator_id=self.agg_id, cluster=self.cluster,
            group=self.group.idx, stage=self.group.stage,
            round_idx=self.gen, sums=ent.get("sums"),
            weight=float(ent.get("weight") or 0.0),
            dtypes=ent.get("dtypes"), stat_sums=ent.get("stat_sums"),
            stat_weight=float(ent.get("stat_weight") or 0.0),
            stat_dtypes=ent.get("stat_dtypes"), n_samples=n_samples,
            members=members, level=self.group.level, codec=codec_s,
            codec_base=codec_base, members_z=members_z)
        nbytes = 0
        for part in encode_parts(msg, self.chunk_bytes):
            self.bus.publish(self.out_queue, part)
            nbytes += len(part)
        self.flushed = True
        if self.log is not None:
            self.log.sent(f"PARTIALAGGREGATE members={len(self.meta)}/"
                          f"{len(self.members)}")
        return nbytes


def drain_group_queue(bus, cluster: int, group_idx: int, gen: int,
                      assembler: FrameAssembler, faults,
                      log=None) -> list:
    """The direct-to-root fallback's drain: what a dead (or flushed)
    aggregator's queue holds now, as the current generation's messages
    (member Updates for a level-1 group, child PartialAggregates for an
    interior one); other generations are dropped and counted."""
    out: list = []
    q = aggregate_queue(cluster, group_idx)
    while True:
        raw = bus.get(q, timeout=0.0)
        if raw is None:
            return out
        try:
            msg = assembler.feed(raw)
        except Exception as e:  # noqa: BLE001 — count and go on
            faults.inc("corrupt_rejected")
            if log is not None:
                log.warning(f"fallback drain: undecodable frame: {e}")
            continue
        if msg is None or not isinstance(msg, (Update, PartialAggregate)):
            continue
        if msg.round_idx != gen:
            faults.inc("agg_stale_drops")
            continue
        out.append(msg)
