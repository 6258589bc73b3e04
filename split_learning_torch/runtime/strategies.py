"""Round strategies: the reference's six server forks as plug-ins.

Port of the JAX package's ``runtime/strategies.py``.  The reference
implements each scheduling/aggregation algorithm as a full copy of the
server: the main concurrent FedAvg server, Vanilla_SL's sequential
relay, Cluster_FSL's cluster relay, FLEX's periodic aggregation, 2LS's
two-level FedAsync, and DCSL's SDA.  Here each is a
:class:`RoundStrategy` driving the same :class:`TrainContext` — host
Python decides *who trains when* and *how weights merge*; the training
step never changes.

Aggregation math is shared: per-cluster per-stage weighted FedAvg, stage
concatenation (disjoint absolute layer keys), unweighted cross-cluster
average.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from split_learning_torch.config import Config
from split_learning_torch.ops.fedavg import TreeFold, fedavg_trees
from split_learning_torch.runtime.checkpoint import save_checkpoint
from split_learning_torch.runtime.context import TrainContext, client_groups
from split_learning_torch.runtime.plan import ClusterPlan
from split_learning_torch.runtime.protocol import Update


def _span(ctx, name: str, **attrs):
    """Tracing span on the context's tracer (no-op without one)."""
    tracer = getattr(ctx, "tracer", None)
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, **attrs)


@dataclasses.dataclass
class RoundOutcome:
    params: Any
    stats: Any
    ok: bool = True
    num_samples: int = 0
    validate: bool = True           # run full-model validation this round?
    metrics: dict = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# shared aggregation math
# --------------------------------------------------------------------------

def aggregate_cluster(updates: Sequence[Update]) -> tuple[Any, Any, int]:
    """Per-stage weighted FedAvg then stage concat for ONE cluster.

    Returns (params_tree, stats_tree, total_stage1_samples).  When the
    protocol server already folded the round incrementally
    (``aggregation.streaming``, ``runtime/aggregate.py``), ``updates``
    arrives as an :class:`~split_learning_torch.runtime.aggregate.
    UpdateBatch` whose ``fold`` carries the finished result — the
    per-client trees were folded (and freed) as each UPDATE decoded —
    and it is unwrapped instead of re-folded.  Otherwise each stage
    folds through :class:`~split_learning_torch.ops.fedavg.TreeFold` in
    client-id order (float summation order must not depend on arrival
    order).  Updates are deduplicated on (client_id, version or
    round_idx) before any sample accounting; weight-less updates are
    skipped by the fold but their samples still count."""
    fold = getattr(updates, "fold", None)
    if fold is not None:
        # the streamed result IS the barrier fold (bit-identical by the
        # canonical-order contract); its sample count already includes
        # every stage-1 contribution
        return fold.params, fold.stats, fold.n_samples
    by_stage: dict[int, list[Update]] = {}
    n_weightless = 0
    seen: set = set()
    for u in updates:
        if u.delta_base is not None:
            raise ValueError(
                f"delta-encoded Update from {u.client_id} (base "
                f"v{u.delta_base}) reached aggregation un-reconstructed")
        key = (u.client_id,
               u.version if u.version is not None else u.round_idx)
        if key in seen:
            continue
        seen.add(key)
        if u.params is None:
            if u.stage == 1:
                n_weightless += u.num_samples
            continue
        by_stage.setdefault(u.stage, []).append(u)
    params: dict = {}
    stats: dict = {}
    n_samples = n_weightless
    for stage, ups in sorted(by_stage.items()):
        ups = sorted(ups, key=lambda u: u.client_id)
        pfold, sfold = TreeFold(), TreeFold()
        for u in ups:
            w = max(1, u.num_samples)
            pfold.add(u.params, w)
            if u.batch_stats:
                sfold.add(u.batch_stats, w)
        params.update(pfold.finalize())
        if sfold.total_w:
            stats.update(sfold.finalize())
        if stage == 1:
            n_samples += sum(u.num_samples for u in ups)
    return params, stats, n_samples


def merge_clusters(cluster_trees: Sequence[Any]) -> Any:
    """Unweighted cross-cluster average.  Deliberately not
    short-circuited for one cluster: the degenerate average still runs
    every leaf through ``nan_to_num``, which the relay strategies (whose
    trees come raw from the clients) rely on; the FedAvg path, whose one
    tree comes out of the already sanitised fold, skips the call
    instead."""
    return fedavg_trees(list(cluster_trees))


def _lerp(a: Any, b: Any, alpha: float) -> Any:
    """``(1 - alpha) * a + alpha * b`` leaf by leaf in float32, cast back
    to ``a``'s dtype (two-level state trees)."""
    def lerp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        out = ((1.0 - alpha) * x.to(torch.float32)
               + alpha * y.to(x.device, torch.float32))
        return out.to(x.dtype)
    return {layer: {k: lerp(x, b[layer][k]) for k, x in leaves.items()}
            for layer, leaves in a.items()}


def _fill(full: Any, partial: Any) -> Any:
    """Overlay aggregated layers onto the previous full tree (missing
    keys keep their previous values)."""
    out = dict(full)
    out.update(partial)
    return out


# --------------------------------------------------------------------------
# strategies
# --------------------------------------------------------------------------

class RoundStrategy:
    name = "base"

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def run_round(self, ctx: TrainContext, plans: list[ClusterPlan],
                  round_idx: int, params: Any, stats: Any) -> RoundOutcome:
        raise NotImplementedError

    def _lr(self, round_idx: int) -> float | None:
        """DCSL-style lr decay."""
        lrn = self.cfg.learning
        if lrn.lr_decay_every and lrn.lr_decay != 1.0:
            return lrn.learning_rate * (
                lrn.lr_decay ** (round_idx // lrn.lr_decay_every))
        return None


class FedAvgStrategy(RoundStrategy):
    """Main-server behavior: all clusters train, per-cluster FedAvg per
    stage, cross-cluster average, validate every round."""
    name = "fedavg"
    sync_all_later_stages = False   # SDA override

    def _epochs(self) -> int:
        return 1

    def run_round(self, ctx, plans, round_idx, params, stats):
        cluster_params, cluster_stats = [], []
        total, ok = 0, True
        agg_s = 0.0
        for plan in plans:
            ups = ctx.train_cluster(
                plan, params, stats, round_idx=round_idx,
                epochs=self._epochs(), lr=self._lr(round_idx),
                sync_all_later_stages=self.sync_all_later_stages)
            ok &= all(u.ok for u in ups)
            t0 = time.perf_counter()
            p, s, n = aggregate_cluster(ups)
            agg_s += time.perf_counter() - t0
            cluster_params.append(_fill(params, p))
            cluster_stats.append(_fill(stats, s))
            total += n
        if not ok:
            # reference: a failed round skips aggregation entirely
            return RoundOutcome(params, stats, ok=False, validate=False)
        metrics = {"fold_s": agg_s}
        # the round's fold as one "aggregate" span: the final merge, with
        # the per-cluster folds' total as an attribute
        with _span(ctx, "aggregate", round=round_idx,
                   fold_s=round(agg_s, 6)):
            if len(plans) == 1:
                # the fold's output is already nan_to_num-sanitized
                return RoundOutcome(cluster_params[0], cluster_stats[0],
                                    num_samples=total, metrics=metrics)
            return RoundOutcome(merge_clusters(cluster_params),
                                merge_clusters(cluster_stats),
                                num_samples=total, metrics=metrics)


class SDAStrategy(FedAvgStrategy):
    """DCSL: later stages train on every feeder's batches (one sync
    group across the columns) for ``local_rounds`` epochs per round."""
    name = "sda"
    sync_all_later_stages = True

    def _epochs(self) -> int:
        return self.cfg.aggregation.local_rounds


class RelayStrategy(RoundStrategy):
    """Vanilla_SL: stage-1 clients train ONE AT A TIME; each finisher's
    stage-1 weights seed the next client; later stages train
    continuously, and their snapshots are averaged at round end."""
    name = "relay"

    def run_round(self, ctx, plans, round_idx, params, stats):
        total, ok = 0, True
        cluster_params, cluster_stats = [], []
        for plan in plans:
            cur_p, cur_s = params, stats
            last_stage_updates: list[Update] = []
            for cid in plan.stage1_clients:
                ups = ctx.train_cluster(plan, cur_p, cur_s,
                                        round_idx=round_idx,
                                        client_subset=[cid],
                                        lr=self._lr(round_idx))
                ok &= all(u.ok for u in ups)
                for u in ups:
                    cur_p = _fill(cur_p, u.params)
                    if u.batch_stats:
                        cur_s = _fill(cur_s, u.batch_stats)
                    if u.stage == 1:
                        total += u.num_samples
                    else:
                        last_stage_updates.append(u)
            if last_stage_updates:
                p, s, _ = aggregate_cluster(last_stage_updates)
                cur_p = _fill(cur_p, p)
                if s:
                    cur_s = _fill(cur_s, s)
            cluster_params.append(cur_p)
            cluster_stats.append(cur_s)
        if not ok:
            return RoundOutcome(params, stats, ok=False, validate=False)
        return RoundOutcome(merge_clusters(cluster_params),
                            merge_clusters(cluster_stats),
                            num_samples=total)


class ClusterRelayStrategy(RoundStrategy):
    """Cluster_FSL: clusters run sequentially; cluster i's aggregated
    weights initialize cluster i+1."""
    name = "cluster_relay"

    def run_round(self, ctx, plans, round_idx, params, stats):
        cur_p, cur_s = params, stats
        total, ok = 0, True
        for plan in plans:
            ups = ctx.train_cluster(plan, cur_p, cur_s,
                                    round_idx=round_idx,
                                    lr=self._lr(round_idx))
            ok &= all(u.ok for u in ups)
            p, s, n = aggregate_cluster(ups)
            cur_p = _fill(cur_p, p)
            cur_s = _fill(cur_s, s)
            total += n
        if not ok:
            return RoundOutcome(params, stats, ok=False, validate=False)
        return RoundOutcome(cur_p, cur_s, num_samples=total)


class PeriodicStrategy(RoundStrategy):
    """FLEX: per-client weights PERSIST across rounds; client-level
    FedAvg every ``t_client`` rounds, global merge + validation every
    ``t_global`` rounds.

    Over a context whose clients hold their state between rounds
    (``clients_hold_state``: the protocol) the non-aggregation rounds
    send no weights either way (START ``send_params``, PAUSE
    ``send_weights``); in process the persisted trees are pushed every
    round (no wire to economise)."""
    name = "periodic"

    def __init__(self, cfg):
        super().__init__(cfg)
        self._client_params: dict = {}   # client_id -> full tree
        self._reseed_stages: set = {0}   # 0 = every stage (initial seed)

    def run_round(self, ctx, plans, round_idx, params, stats):
        agg = self.cfg.aggregation
        hold = getattr(ctx, "clients_hold_state", False)
        boundary_c = (round_idx + 1) % agg.t_client == 0
        boundary_g = (round_idx + 1) % agg.t_global == 0
        total, ok = 0, True
        cluster_params, cluster_stats = [], []
        for plan in plans:
            if hold:
                send_w = {s: (boundary_c or boundary_g) if s == 1
                          else boundary_g
                          for s in range(1, plan.n_stages + 1)}
                send_p = {s: (0 in self._reseed_stages
                              or s in self._reseed_stages)
                          for s in range(1, plan.n_stages + 1)}
            else:
                send_w = send_p = True
            ups = ctx.train_cluster(
                plan, params, stats, round_idx=round_idx,
                per_client_params=dict(self._client_params),
                lr=self._lr(round_idx),
                send_params=send_p, send_weights=send_w)
            ok &= all(u.ok for u in ups)
            for u in ups:
                if u.stage == 1:
                    total += u.num_samples
            # persist each uploading client's full tree (its shard
            # overlaid on the round's base); weight-less updates persist
            # nothing
            got_w = [u for u in ups if u.params is not None]
            for u in got_w:
                base = self._client_params.get(u.client_id, params)
                self._client_params[u.client_id] = _fill(base, u.params)
            if got_w:
                p, s, _ = aggregate_cluster(got_w)
                cluster_params.append(_fill(params, p))
                cluster_stats.append(_fill(stats, s))
            if boundary_c and not boundary_g and got_w:
                # client-level FedAvg: the cluster's stage-1 clients
                # restart from the cluster average
                for cid in plan.stage1_clients:
                    self._client_params[cid] = cluster_params[-1]
        if not ok:
            self._reseed_stages = {0}   # deterministic recovery re-seed
            return RoundOutcome(params, stats, ok=False, validate=False)
        self._reseed_stages = set()
        if boundary_g:
            merged = merge_clusters(cluster_params)
            merged_stats = merge_clusters(cluster_stats)
            self._client_params.clear()  # re-seed everyone from global
            self._reseed_stages = {0}
            return RoundOutcome(merged, merged_stats, num_samples=total,
                                validate=True)
        if boundary_c:
            self._reseed_stages = {1}
        return RoundOutcome(params, stats, num_samples=total,
                            validate=False)


class FedAsyncStrategy(RoundStrategy):
    """2LS two-level clustering + FedAsync.

    Out-clusters (the ``plans``) run one after another in an order
    shuffled per round.  Within an out-cluster, ``topology.in_clusters``
    in-clusters — contiguous groups of stage-1 clients, each with its
    round-robin share of the later-stage clients — train together; each
    in-cluster's average then merges into the global model in order
    with ``alpha = 1/(1+rank)`` (or the fixed config alpha): ``g = (1-a)
    g + a c``.  Rank resets per out-cluster, so the first in-cluster's
    average replaces the global; continuity across out-clusters flows
    through the training init.  With ``checkpoint.per-merge`` every
    merge is checkpointed, and a round that fails after one restores
    the round-entry state on disk."""
    name = "fedasync"

    def _in_groups(self, plan: ClusterPlan) -> list[tuple[list, set]]:
        """[(stage1_member_ids, later_stage_member_ids)] per in-cluster:
        the later-stage clients partitioned over the in-clusters
        round-robin, so every update belongs to exactly one."""
        n_in = max(1, self.cfg.topology.in_clusters)
        s1 = plan.stage1_clients
        groups = client_groups(len(s1), min(n_in, len(s1)))
        later: list[set] = [set() for _ in groups]
        for s in range(2, plan.n_stages + 1):
            for j, cid in enumerate(plan.clients[s - 1]):
                later[j % len(groups)].add(cid)
        return [([s1[i] for i in idxs], later[g])
                for g, idxs in enumerate(groups)]

    def run_round(self, ctx, plans, round_idx, params, stats):
        rng = np.random.default_rng(self.cfg.seed + round_idx)
        order = rng.permutation(len(plans))
        g_p, g_s = params, stats
        total, ok = 0, True
        saved_any = False   # any per-merge checkpoint written this round
        ck = self.cfg.checkpoint
        for pi in order:
            plan = plans[pi]
            ups = ctx.train_cluster(plan, g_p, g_s, round_idx=round_idx,
                                    lr=self._lr(round_idx))
            ok &= all(u.ok for u in ups)
            rank = 0   # over REPORTING in-clusters only: a dropped
            # in-cluster must not shift the survivors' alphas
            for members, later in self._in_groups(plan):
                in_ups = [u for u in ups
                          if (u.stage == 1 and u.client_id in members)
                          or (u.stage >= 2 and u.client_id in later)]
                if not in_ups:
                    continue
                p, s, n = aggregate_cluster(in_ups)
                alpha = (self.cfg.aggregation.fedasync_alpha
                         if self.cfg.aggregation.fedasync_alpha is not None
                         else 1.0 / (1.0 + rank))
                rank += 1
                g_p = _lerp(g_p, _fill(g_p, p), alpha)
                g_s = _fill(g_s, s)
                total += n
                if ok and ck.per_merge and ck.save:
                    # 2LS persists every alpha-merge, synchronously: a
                    # crash mid-round loses at most one in-cluster's
                    # work.  Gated on `ok`: a round that already saw a
                    # NaN will revert, and its merges must not overwrite
                    # the last good checkpoint
                    save_checkpoint(ck.directory, self.cfg.model_key,
                                    g_p, g_s, round_idx=round_idx)
                    saved_any = True
        if not ok:
            if saved_any:
                # a later plan's NaN reverts the round after earlier
                # clean merges overwrote the checkpoint: put the
                # round-entry state back
                save_checkpoint(ck.directory, self.cfg.model_key, params,
                                stats, round_idx=round_idx)
            return RoundOutcome(params, stats, ok=False, validate=False)
        return RoundOutcome(g_p, g_s, num_samples=total)


_STRATEGIES = {
    cls.name: cls for cls in (
        FedAvgStrategy, SDAStrategy, RelayStrategy, ClusterRelayStrategy,
        PeriodicStrategy, FedAsyncStrategy)
}


def make_strategy(cfg: Config) -> RoundStrategy:
    name = cfg.aggregation.strategy
    if name not in _STRATEGIES:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"known: {sorted(_STRATEGIES)}")
    return _STRATEGIES[name](cfg)
