"""Round strategies.

Port of the JAX package's ``runtime/strategies.py``.  The shared
aggregation math — per-cluster per-stage weighted FedAvg, stage
concatenation over disjoint absolute layer keys, unweighted cross-cluster
average — and the main server's FedAvg strategy are ported.  The other
five strategies (sda, relay, cluster_relay, periodic, fedasync) wait for
their slice and raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

from split_learning_torch.config import Config
from split_learning_torch.ops.fedavg import TreeFold, fedavg_trees
from split_learning_torch.runtime.context import TrainContext
from split_learning_torch.runtime.plan import ClusterPlan
from split_learning_torch.runtime.protocol import Update


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

    Returns (params_tree, stats_tree, total_stage1_samples).  Each stage
    folds through :class:`~split_learning_torch.ops.fedavg.TreeFold` in
    client-id order (float summation order must not depend on arrival
    order).  Updates are deduplicated on (client_id, version or
    round_idx) before any sample accounting; weight-less updates are
    skipped by the fold but their samples still count."""
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
    """Unweighted cross-cluster average (runs every leaf through
    ``nan_to_num`` even for one cluster; the FedAvg path skips the call
    for one cluster instead)."""
    return fedavg_trees(list(cluster_trees))


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

    def run_round(self, ctx, plans, round_idx, params, stats):
        cluster_params, cluster_stats = [], []
        total, ok = 0, True
        agg_s = 0.0
        for plan in plans:
            ups = ctx.train_cluster(plan, params, stats,
                                    round_idx=round_idx, epochs=1,
                                    lr=self._lr(round_idx))
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
        if len(plans) == 1:
            # the fold's output is already nan_to_num-sanitized
            return RoundOutcome(cluster_params[0], cluster_stats[0],
                                num_samples=total, metrics=metrics)
        return RoundOutcome(merge_clusters(cluster_params),
                            merge_clusters(cluster_stats),
                            num_samples=total, metrics=metrics)


#: strategies of the JAX package not ported yet -> the slice that ports them
_LATER = {
    "sda": "the strategies slice (DCSL server-side data aggregation)",
    "relay": "the strategies slice (Vanilla_SL sequential relay)",
    "cluster_relay": "the strategies slice (Cluster_FSL cluster relay)",
    "periodic": "the strategies slice (FLEX periodic aggregation)",
    "fedasync": "the strategies slice (2LS two-level FedAsync)",
}


def make_strategy(cfg: Config) -> RoundStrategy:
    name = cfg.aggregation.strategy
    if name == FedAvgStrategy.name:
        return FedAvgStrategy(cfg)
    if name in _LATER:
        raise NotImplementedError(
            f"aggregation strategy {name!r} is not ported yet; it comes "
            f"with {_LATER[name]}")
    raise ValueError(f"unknown strategy {name!r}; known: "
                     f"{sorted(['fedavg', *_LATER])}")
