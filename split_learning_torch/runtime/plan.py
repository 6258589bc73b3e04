"""Round planning: registrations → clusters, cut points, data assignment.

This is the server-side planning pass the reference runs once all clients
have registered (``src/Server.py:111-135`` registration
barrier → ``:87-101`` label-distribution synthesis → ``:300-382``
``cluster_and_selection``): KMeans clustering of stage-1 clients by label
distribution, GMM straggler rejection, and per-cluster cut-point search —
reimplemented as pure functions in :mod:`split_learning_torch.planner`
(copies of the JAX package's).  The output :class:`ClusterPlan` list is
what both execution backends (the in-process context and the protocol
server) consume.  ``pipeline_slots`` and ``prune_plan_members`` of the
JAX package come with their callers (stage hosts, the elastic server and
the scheduler).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from split_learning_torch.config import Config
from split_learning_torch.models import num_layers
from split_learning_torch.planner import (
    auto_threshold, clustering_algorithm, partition, partition_multiway,
    synthesize_label_counts,
)

#: classes per dataset (reference: implicit in each loader/model pairing)
DATASET_CLASSES = {
    "CIFAR10": 10, "CIFAR100": 100, "MNIST": 10,
    "AGNEWS": 4, "EMOTION": 6, "SPEECHCOMMANDS": 10,
}


@dataclasses.dataclass
class Registration:
    """One client's REGISTER payload (``client.py:57-59``)."""
    client_id: str
    stage: int                       # 1-based
    cluster: int | None = None       # manual assignment
    profile: dict | None = None      # {exe_time, size_data, speed, network}


@dataclasses.dataclass
class ClusterPlan:
    """Everything one cluster needs for a round."""
    cluster_id: int
    cuts: list                       # 1-based cut layers, len = n_stages-1
    clients: list                    # per-stage lists of client_ids
    label_counts: np.ndarray         # (n_stage1_clients, n_classes)
    rejected: list                   # client_ids dropped by selection

    @property
    def n_stages(self) -> int:
        return len(self.clients)

    @property
    def stage1_clients(self) -> list:
        return self.clients[0]

    def stage_of(self, client_id: str) -> int:
        for s, ids in enumerate(self.clients, start=1):
            if client_id in ids:
                return s
        raise KeyError(client_id)

    def all_clients(self) -> list:
        return [c for ids in self.clients for c in ids]


def _num_classes(cfg: Config) -> int:
    return DATASET_CLASSES.get(cfg.dataset, 10)


def plan_clusters(cfg: Config,
                  registrations: list[Registration]) -> list[ClusterPlan]:
    """Full planning pass. Registrations must cover ``cfg.clients`` counts
    (stage s gets cfg.clients[s-1] clients)."""
    n_stages = cfg.num_stages
    by_stage: dict[int, list[Registration]] = {s: [] for s in
                                               range(1, n_stages + 1)}
    for reg in registrations:
        if reg.stage not in by_stage:
            raise ValueError(
                f"client {reg.client_id} registered for stage {reg.stage}, "
                f"config has {n_stages} stages")
        by_stage[reg.stage].append(reg)
    for s in range(1, n_stages + 1):
        if len(by_stage[s]) != cfg.clients[s - 1]:
            raise ValueError(
                f"stage {s}: expected {cfg.clients[s - 1]} clients, "
                f"got {len(by_stage[s])}")

    stage1 = by_stage[1]
    if cfg.topology.mode == "auto" and cfg.topology.require_profiles:
        # fail-fast contract (reference client.py:52-62: clients refuse
        # to start without profiling.json): auto partitioning must not
        # silently degrade to an even split
        missing = [r.client_id for r in stage1
                   if not (r.profile and "exe_time" in r.profile
                           and "size_data" in r.profile)]
        if missing:
            raise ValueError(
                "topology.require_profiles: auto partitioning needs a "
                "profile (exe_time + size_data) from every stage-1 "
                f"client; missing from {missing} — run "
                "`python -m split_learning_torch.profiler` on each client "
                "or disable require-profiles")
    n_classes = _num_classes(cfg)
    dist = cfg.distribution
    label_counts = synthesize_label_counts(
        len(stage1), n_classes, dist.num_samples,
        non_iid=(dist.mode == "dirichlet"), alpha=dist.alpha,
        seed=dist.seed if dist.seed is not None else cfg.seed)
    if dist.mode == "fixed":
        label_counts = np.asarray(dist.matrix, dtype=int)
        if label_counts.shape[0] != len(stage1):
            raise ValueError(
                f"fixed distribution matrix has {label_counts.shape[0]} "
                f"rows, need {len(stage1)}")

    k = cfg.topology.num_clusters
    # -- cluster assignment of stage-1 clients --------------------------
    if cfg.topology.mode == "auto" and k > 1:
        labels, _ = clustering_algorithm(label_counts, k)
    else:
        # manual: honor Register.cluster when provided (and in range),
        # else round-robin
        labels = np.array([
            reg.cluster if reg.cluster is not None
            and 0 <= reg.cluster < k else i % k
            for i, reg in enumerate(stage1)
        ])

    # -- straggler rejection (GMM on speed) -----------------------------
    rejected_ids: set = set()
    if cfg.topology.selection:
        speeds = np.array([
            (reg.profile or {}).get("speed", 1.0) for reg in stage1
        ], dtype=float)
        if len(set(speeds.tolist())) > 1:
            thr = auto_threshold(speeds)
            for reg, sp in zip(stage1, speeds):
                if sp < thr:
                    rejected_ids.add(reg.client_id)

    # -- later-stage clients: manual cluster or round-robin -------------
    later_assign: dict[int, list[list]] = {}
    for s in range(2, n_stages + 1):
        buckets: list[list] = [[] for _ in range(k)]
        unassigned = []
        for reg in by_stage[s]:
            if reg.cluster is not None and 0 <= reg.cluster < k:
                buckets[reg.cluster].append(reg.client_id)
            else:
                unassigned.append(reg.client_id)
        for i, cid in enumerate(unassigned):
            order = sorted(range(k), key=lambda c: len(buckets[c]))
            buckets[order[0]].append(cid)
        later_assign[s] = buckets

    # -- per-cluster cut points -----------------------------------------
    n_layer = num_layers(cfg.model_key, **(cfg.model_kwargs or {}))
    plans: list[ClusterPlan] = []
    for c in range(k):
        members = [i for i in range(len(stage1)) if labels[i] == c]
        kept = [i for i in members
                if stage1[i].client_id not in rejected_ids]
        if not kept:
            kept = members  # never reject a whole cluster
        cuts = _cluster_cuts(cfg, c, [stage1[i] for i in kept],
                             later_assign, n_layer)
        clients = [[stage1[i].client_id for i in kept]]
        for s in range(2, n_stages + 1):
            clients.append(list(later_assign[s][c]))
        plans.append(ClusterPlan(
            cluster_id=c, cuts=cuts, clients=clients,
            label_counts=label_counts[kept],
            rejected=[stage1[i].client_id for i in members
                      if stage1[i].client_id in rejected_ids]))
    return [p for p in plans if p.stage1_clients]


def _cluster_cuts(cfg: Config, cluster_id: int, stage1_regs: list,
                  later_assign: dict, n_layer: int) -> list:
    topo = cfg.topology
    n_cuts = cfg.num_stages - 1
    if n_cuts == 0:
        return []
    if topo.mode == "manual":
        if topo.cluster_cut_layers is not None:
            return list(topo.cluster_cut_layers[cluster_id])
        return list(topo.cut_layers)[:n_cuts]
    # auto: throughput-balance search over profiles (src/Partition.py:2-21)
    profs = [r.profile for r in stage1_regs if r.profile]
    if not profs or "exe_time" not in profs[0] \
            or "size_data" not in profs[0]:
        # no profiles -> even layer split
        return [max(1, (i + 1) * n_layer // (n_cuts + 1))
                for i in range(n_cuts)]
    exe1 = [p["exe_time"] for p in profs]
    # `or`: an unprobed profile carries network=0.0 — treat as unconstrained
    net1 = [float(p.get("network") or 1e9) for p in profs]
    # profiles record fp32 boundary bytes; a compressed data-plane wire
    # (transport.wire-dtype) shrinks what actually crosses per hop, and
    # the throughput-balance search must weigh the cut with the bytes it
    # will really ship (non-float extras like masks are negligible)
    wire_factor = {"float32": 1.0, "float16": 0.5,
                   "bfloat16": 0.5, "int8": 0.25}[
                       cfg.transport.wire_dtype_normalized]
    size_data = [s * wire_factor for s in profs[0]["size_data"]]
    # later-stage devices are unprofiled at the server (the reference also
    # only keeps stage-1 size_data — src/Server.py:115-117); mirror group 1
    if n_cuts == 1:
        return partition(exe1, net1, exe1, net1, size_data)
    return partition_multiway([exe1] * (n_cuts + 1),
                              [net1] * (n_cuts + 1), size_data)
