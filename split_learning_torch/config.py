"""Validated configuration schema.

The reference parses a schemaless ``config.yaml`` with ``yaml.safe_load``
at every entry point (``server.py:12-17``,
``client.py:20-21``) and its five variants drift keys freely
(``manual`` vs ``no-cluster`` vs ``manual-cluster`` blocks).  Here the
union of all of those surfaces lives in one typed, validated schema:

* rounds {global, local}, wall-clock limit, per-stage client counts;
* model / dataset selection;
* cut topology {manual list, per-cluster lists, auto planner};
* data distribution {iid, dirichlet(alpha), fixed matrix};
* aggregation strategy {fedavg, periodic(t_c, t_g), fedasync(alpha),
  sequential relay, cluster relay, sda(size)};
* device selection on/off, cluster algorithm, cluster count;
* learning hyperparams incl. the in-flight cap (``control-count`` →
  microbatch count of the compiled schedule);
* checkpoint save/load/validate flags and paths;
* transport choice for the control plane.

Unknown keys are rejected (the reference silently ignores typos).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any

import yaml


class ConfigError(ValueError):
    pass


#: LoRA kernel-name targets (single source of truth; ops/lora re-exports).
#: Mirrors the reference peft config [query, key, value, dense] where HF
#: "dense" suffix-matches the attention out-projection and both FFN
#: linears (src/RpcClient.py:61-66) — listed here under their flax names.
LORA_DEFAULT_TARGETS = ("query", "key", "value", "out", "dense",
                        "intermediate", "output", "mlp_in", "mlp_out")


def _check(cond: bool, msg: str):
    if not cond:
        raise ConfigError(msg)


@dataclasses.dataclass(frozen=True)
class LearningConfig:
    """Optimizer + loop hyperparameters (reference ``config.yaml:50-55``)."""
    learning_rate: float = 5e-4
    momentum: float = 0.9
    weight_decay: float = 0.0
    batch_size: int = 32
    # sgd | adamw | adamw-bf16 (both Adam moments stored bfloat16,
    # parallel/zero.py) | adamw-zero1 (bf16 moments additionally
    # flattened + sharded across the `stage` mesh axis — ZeRO-1; on
    # backends without a stage axis to shard over, protocol clients
    # already hold only their own stage's params and the optimizer
    # degrades to adamw-bf16)
    optimizer: str = "sgd"
    control_count: int = 4          # in-flight cap -> num_microbatches
    clip_grad_norm: float | None = None  # Vanilla_SL Scheduler.py:204-205
    # TPU-native extension (no reference equivalent): on device-resident
    # FedAvg rounds, CARRY adaptive-optimizer state across the round
    # barrier instead of re-initializing it each round.  The reference
    # (and the default here) rebuilds the optimizer per round, which
    # for Adam means the moments re-estimate from zero every few steps
    # — on small rounds that is the dominant source of the sawtooth
    # loss the flagship trajectory shows.  Params still FedAvg; moments
    # stay per-client (the standard local-Adam federated variant).
    opt_resident: bool = False
    lr_decay: float = 1.0           # DCSL Server.py:38-39
    lr_decay_every: int = 0         # rounds; 0 = off
    # LoRA adapters (reference peft wrap for BERT, RpcClient.py:61-66):
    # rank 0 disables; targets match kernel path names
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = LORA_DEFAULT_TARGETS
    # per-stage activation-recompute policy for the compiled pipeline
    # (parallel/pipeline.py): "wide" (default) checkpoints only stages
    # whose boundary exceeds the width threshold; "all" is the blanket
    # recompute; "none" stores every stage's activations
    remat: str = "wide"
    # Asynchronous decoupled split learning (ROADMAP item 2; *Decoupled
    # Split Learning via Auxiliary Loss*, arxiv 2601.19261 + staleness-
    # tolerant pipelining, arxiv 2412.14374).  "sync" (default) is the
    # reference's lockstep round; "async" decouples the backward wire:
    # every non-final stage trains against a LOCAL auxiliary head (no
    # Gradient frames at all — the gradient queues and their codecs go
    # dormant), the server folds Updates under a bounded-staleness
    # admission window instead of a full barrier, and clients keep
    # ticking on their current version while the next START streams in
    # (double-buffered seed swap at a tick boundary).
    mode: str = "sync"              # sync | async
    # auxiliary-head architecture built from the plan's cut shapes:
    # pooled-linear (mean-pool the boundary -> one Dense to classes) or
    # projection-mlp (pool -> Dense(hidden) -> gelu -> Dense(classes))
    aux_head: str = "pooled-linear"
    aux_hidden: int = 64            # projection-mlp hidden width
    # server admission window: an Update seeded from version v folds
    # iff server_version - v <= max-staleness, with its FedAvg weight
    # scaled by staleness-decay ** lag; older ones are rejected and
    # counted (agg_stale_updates)
    max_staleness: int = 2
    staleness_decay: float = 0.5
    # fresh (lag-0) contributions that cut a new global version; 0 =
    # every started client (the full barrier, maximally deterministic)
    async_quorum: int = 0
    # Round-boundary compute overlap in SYNC mode (the sync twin of the
    # async mode's pipelined rounds): after publishing its Update a
    # stage-1 client keeps working while the server folds, optimizes
    # and re-fans-out — it prefetches the next round's first batches
    # (loader draw + host->device transfer) and, when the previous
    # START held the local shard, runs the next round's first
    # microbatch FORWARDS on the stale seed.  The new params splice in
    # at the first tick boundary after START lands: speculative work
    # that matches the round's actual seed/loader is consumed in
    # place, anything else is discarded with the rng stream restored —
    # so an overlapped round is BIT-IDENTICAL to a non-overlapped one.
    sync_overlap: bool = False

    def validate(self):
        _check(self.remat in ("all", "wide", "none"),
               f"remat must be all|wide|none, got {self.remat!r}")
        _check(self.mode in ("sync", "async"),
               f"learning.mode must be sync|async, got {self.mode!r}")
        _check(self.aux_head in ("pooled-linear", "projection-mlp"),
               "learning.aux-head must be pooled-linear|projection-mlp, "
               f"got {self.aux_head!r}")
        _check(self.aux_hidden >= 1, "learning.aux-hidden must be >= 1")
        _check(self.max_staleness >= 0,
               "learning.max-staleness must be >= 0")
        _check(0.0 <= self.staleness_decay <= 1.0,
               "learning.staleness-decay must be in [0, 1], "
               f"got {self.staleness_decay!r}")
        _check(self.async_quorum >= 0,
               "learning.async-quorum must be >= 0 (0 = all clients)")
        _check(self.lora_rank >= 0, "lora-rank must be >= 0")
        _check(self.learning_rate > 0, "learning-rate must be > 0")
        _check(self.batch_size > 0, "batch-size must be > 0")
        _check(self.optimizer in ("sgd", "adamw", "adamw-bf16",
                                  "adamw-zero1"),
               "optimizer must be sgd|adamw|adamw-bf16|adamw-zero1, "
               f"got {self.optimizer!r}")
        _check(not (self.optimizer == "adamw-zero1"
                    and self.clip_grad_norm),
               "adamw-zero1 does not support clip-grad-norm (the "
               "sharded flat update has no global-norm view)")
        _check(not (self.optimizer == "adamw-zero1"
                    and self.lora_rank > 0),
               "adamw-zero1 does not support lora-rank > 0")
        _check(self.control_count > 0, "control-count must be > 0")


@dataclasses.dataclass(frozen=True)
class DistributionConfig:
    """Per-client label distribution synthesis (``src/Server.py:87-101``)."""
    mode: str = "iid"               # iid | dirichlet | fixed
    alpha: float = 1.0              # dirichlet concentration
    num_samples: int = 2500         # samples per stage-1 client
    matrix: tuple | None = None     # fixed per-client label counts (FLEX)
    seed: int | None = None
    # reference data-distribution.refresh (src/Server.py:48, consumed at
    # src/RpcClient.py:108): True -> every round re-samples each
    # client's label-count subset (loader rebuilt per START); False ->
    # the subset is drawn once and reused all training
    refresh: bool = False

    def validate(self):
        _check(self.mode in ("iid", "dirichlet", "fixed"),
               f"distribution mode must be iid|dirichlet|fixed, "
               f"got {self.mode!r}")
        if self.mode == "dirichlet":
            _check(self.alpha > 0, "dirichlet alpha must be > 0")
        if self.mode == "fixed":
            _check(self.matrix is not None,
                   "fixed distribution requires a matrix")


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Cut points + clustering (``config.yaml:25-34`` union)."""
    mode: str = "manual"            # manual | auto
    cut_layers: tuple = (7,)        # manual: one cut list for all clusters
    cluster_cut_layers: tuple | None = None  # per-cluster cut lists (FLEX)
    num_clusters: int = 1
    in_clusters: int = 1            # 2LS: in-clusters per out-cluster
    # (clients pair 1:1 edge<->head inside each; other/2LS/client.py:15-17)
    cluster_algorithm: str = "kmeans"  # kmeans | affinity
    selection: bool = False         # GMM straggler rejection on/off
    force_pipeline: bool = False    # keep stage ppermute even where the
    # backend would rather collapse to DP (CPU big-model safety fallback)
    # Reference clients refuse to start without profiling.json
    # (client.py:52-62); with require_profiles the server-side planner
    # restores that fail-fast contract: auto partitioning REJECTS
    # registrations without a usable profile instead of silently falling
    # back to an even layer split.
    require_profiles: bool = False
    # Elastic membership BETWEEN rounds (extension; the reference fixes
    # the client set at the registration barrier and a late client can
    # never join, src/Server.py:111-135): clients that REGISTER after
    # training started join the next round's plan, and clients that miss
    # consecutive round barriers are pruned from it (protocol backend).
    elastic_join: bool = False
    # Intra-client acceleration axes (fresh TPU surface, SURVEY.md §2.2):
    # shard each logical client's model over `model` (Megatron-style TP,
    # parallel/tensor.py), its sequence over `seq` (ring attention,
    # parallel/sequence.py), or its MoE experts over `expert`
    # (parallel/expert.py).  They compose with client DP (remaining
    # devices form the client axis); cuts are preserved as virtual
    # stages on each group.
    tensor_parallel: int = 1
    sequence_parallel: int = 1
    expert_parallel: int = 1

    def validate(self):
        _check(self.mode in ("manual", "auto"),
               f"topology mode must be manual|auto, got {self.mode!r}")
        _check(self.num_clusters >= 1, "num-clusters must be >= 1")
        _check(self.in_clusters >= 1, "in-clusters must be >= 1")
        _check(self.tensor_parallel >= 1 and self.sequence_parallel >= 1
               and self.expert_parallel >= 1,
               "tensor/sequence/expert-parallel must be >= 1")
        _check(sum(a > 1 for a in (self.tensor_parallel,
                                   self.sequence_parallel,
                                   self.expert_parallel)) <= 1,
               "at most one of tensor/sequence/expert-parallel may "
               "exceed 1 (each composes with client DP, not each other)")
        _check(self.cluster_algorithm in ("kmeans", "affinity"),
               f"cluster-algorithm must be kmeans|affinity, "
               f"got {self.cluster_algorithm!r}")
        if self.cluster_cut_layers is not None:
            _check(len(self.cluster_cut_layers) == self.num_clusters,
                   "cluster-cut-layers must have one entry per cluster")


@dataclasses.dataclass(frozen=True)
class AggregationConfig:
    """Round strategy knobs — the algorithm surface of the five variants
    (SURVEY.md §2.3) as configuration instead of code forks."""
    strategy: str = "fedavg"
    # fedavg | relay | cluster_relay | periodic | fedasync | sda
    t_client: int = 1               # FLEX t-c: client FedAvg interval
    t_global: int = 1               # FLEX t-g: global concat+validate interval
    fedasync_alpha: float | None = None  # 2LS: None -> 1/(1+rank)
    sda_size: int = 2               # DCSL server-side data-aggregation width
    # strict SDA barrier (VERDICT r3 weak #5): True = the window is a
    # HARD sda_size distinct-origin barrier (DCSL parity,
    # other/DCSL/src/Scheduler.py:152-191) — a slow-but-alive feeder is
    # waited for, and leftovers drain only on a feeder's epoch-end
    # marker or round PAUSE.  False (default) = elastic: an idle spell
    # flushes a partial window and the barrier adapts to live feeders.
    sda_strict: bool = False
    local_rounds: int = 1           # DCSL epochs per round
    # Streaming aggregation plane (runtime/aggregate.py, ROADMAP item
    # 4).  ``streaming`` (default on) folds each UPDATE into a running
    # per-stage weighted sum the moment the server decodes it, so the
    # UPDATE barrier holds O(1) parameter trees instead of O(clients);
    # a canonical (stage, client_id) reorder window keeps the result
    # bit-identical to the barrier fold.  Only strategies whose
    # aggregation consumes the whole update list at once stream
    # (fedavg/sda/cluster_relay); the others keep barrier semantics
    # automatically.
    streaming: bool = True
    # Aggregator tree: >= 2 interposes L1 aggregator participants
    # (clients -> L1 -> root) so per-node fan-in stays constant at
    # 100+ clients; groups of at most fan-in clients per stage fold
    # locally and publish one PartialAggregate.  0 = flat
    # direct-to-root.  An L1 that dies mid-round degrades to a counted
    # direct-to-root fallback drain.
    fan_in: int = 0
    # Tree depth (runtime/aggregate.py plan_tree): 1 = the classic
    # clients -> L1 -> root shape; >= 2 adds interior levels that
    # re-fold their children's PartialAggregates (sums of sums with
    # total weight — any depth divides exactly once at the root) so
    # the ROOT's fan-in stays constant at 10k+ clients too.  Stages
    # whose population already fits one group are not wrapped again.
    levels: int = 1
    # Run the aggregator tree in standalone AGGREGATOR PROCESSES
    # (runtime/aggnode.py, tools/sl_aggregator.py) adopted over the
    # broker instead of server threads: nodes announce with AggHello,
    # receive per-round AggAssign group assignments, heartbeat like
    # clients (FleetMonitor `lost` — or child-process exit — triggers
    # the same counted direct-to-root fallback drain an in-proc L1
    # death does).  False (default): thread-mode L1s, unchanged.
    remote: bool = False
    # With remote: the number of aggregator subprocesses the SERVER
    # spawns at startup (tcp transport only).  0 = adopt externally
    # started nodes (`python -m split_learning_tpu.aggregator`).
    nodes: int = 0
    # Run the running sum + FedAvg divide + server optimizer step as
    # jitted ops on arrays sharded across the server's device mesh
    # (MeshFoldBackend) instead of replicated host numpy trees.
    sharded: bool = False
    # Server-side optimizer on the aggregate (FedAvgM):
    # v' = m*v + (base - avg); new = base - v'.  0 (default) is plain
    # FedAvg — and keeps the bit-identity contract with the barrier
    # oracle.  Velocity state lives in the fold backend's (sharded)
    # representation between rounds.
    server_momentum: float = 0.0
    # Cross-replica-sharded weight update (arxiv 2004.13336): run the
    # entire round-boundary update — FedAvg divide, FedAvgM momentum
    # step, wire-dtype cast for START — as ONE fused program per
    # stage instead of per-leaf ops.  On the mesh backend
    # (aggregation.sharded) the fused program is jitted with donated
    # buffers and every leaf sharded along axis 0 over the `agg` mesh
    # axis, and the stage's result comes back in a single
    # device->host fetch; per-stage results stream to the START
    # fan-out in stage order while later stages are still updating.
    # Bit-identical to the per-leaf path (same elementwise IEEE ops in
    # the same order) — False keeps the legacy per-leaf path as the
    # parity oracle.
    update_sharded: bool = True

    def validate(self):
        _check(self.strategy in ("fedavg", "relay", "cluster_relay",
                                 "periodic", "fedasync", "sda"),
               f"unknown aggregation strategy {self.strategy!r}")
        _check(self.t_client >= 1 and self.t_global >= 1,
               "t-client/t-global must be >= 1")
        _check(self.sda_size >= 1, "sda-size must be >= 1")
        _check(self.local_rounds >= 1, "local-rounds must be >= 1")
        _check(self.fan_in == 0 or self.fan_in >= 2,
               f"aggregation.fan-in must be 0 (flat) or >= 2, "
               f"got {self.fan_in!r}")
        _check(not self.fan_in or self.streaming,
               "aggregation.fan-in requires aggregation.streaming "
               "(the root folds PartialAggregates incrementally)")
        _check(1 <= self.levels <= 4,
               f"aggregation.levels must be in 1..4, got {self.levels!r}")
        _check(self.levels == 1 or self.fan_in,
               "aggregation.levels > 1 requires aggregation.fan-in "
               "(the tree is built from fan-in groups)")
        _check(not self.remote or self.fan_in,
               "aggregation.remote requires aggregation.fan-in "
               "(remote nodes serve fan-in groups)")
        _check(self.nodes >= 0, "aggregation.nodes must be >= 0")
        _check(not self.nodes or self.remote,
               "aggregation.nodes requires aggregation.remote")
        _check(0.0 <= self.server_momentum < 1.0,
               f"aggregation.server-momentum must be in [0, 1), "
               f"got {self.server_momentum!r}")


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Save/load/validate flags (``config.yaml:11-13``).

    ``per_merge`` (2LS parity, ``other/2LS/src/Server.py:184``): under
    ``aggregation.strategy: fedasync`` also checkpoint after EVERY
    FedAsync in-cluster merge, not just at round end — the reference
    persists each alpha-merge so a crash mid-round loses at most one
    in-cluster's work.  Ignored by the other strategies (they have no
    mid-round global-model updates to persist)."""
    save: bool = True
    load: bool = False
    validate: bool = True
    directory: str = "checkpoints"
    per_merge: bool = False


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Control-plane transport. ``inproc`` runs the whole cell in one
    process (TPU-native mode); ``tcp`` is the multi-process protocol mode
    replacing the reference's RabbitMQ creds (``config.yaml:36-43``)."""
    kind: str = "inproc"            # inproc | tcp
    host: str = "127.0.0.1"
    port: int = 5672
    # Activation/input-gradient float payload dtype on the data-plane
    # wire.  bf16 (the default) halves the per-hop bytes vs the
    # reference's fp32 pickles (src/train/VGG16.py:27); int8
    # absmax-quantizes each payload leaf for ~4x (runtime/protocol.py
    # QuantLeaf).  fp32 MASTER copies are untouched: weights in
    # START/UPDATE always travel full precision.  Aliases fp32/bf16/fp16
    # accepted.
    wire_dtype: str = "bfloat16"    # float32 | float16 | bfloat16 | int8
    # Async data plane (runtime/bus.py AsyncTransport, default on):
    # sends are enqueued into a bounded background sender (depth =
    # send-depth) that does the device fetch + TENSOR encode + socket
    # write off the training thread, and data-plane receives are pulled
    # prefetch-depth frames ahead by per-queue prefetchers.
    async_send: bool = True
    send_depth: int = 8
    prefetch_depth: int = 2
    # One frame's wire-size cap before it splits into crc'd chunks
    # (runtime/protocol.py encode_parts / FrameAssembler) — keeps a
    # giant UPDATE under the broker's frame sanity cap.
    chunk_mb: int = 512
    # Per-queue-family wire codec policy (runtime/codec/): a mapping of
    # queue family -> codec spec, e.g.
    #   codec: {intermediate: int8, gradient: "topk:0.05", rpc: delta}
    # intermediate takes tiled quantizers (int8[:tile] | int4[:tile]),
    # gradient additionally takes top-k + error-feedback
    # (topk:<frac>), rpc takes delta-encoded Updates
    # (delta | delta:bf16 | delta:int8[:tile]).  None = no codec; the
    # plain wire-dtype path applies.
    codec: Any = None
    # Global lossy wire dtypes are ambiguous now that per-queue codec
    # policies exist: ``wire-dtype: int8`` quantizes EVERY data-plane
    # payload with the blunt per-tensor legacy quantizer and composes
    # confusingly with a codec block.  It therefore requires this
    # explicit opt-in (and is always rejected alongside ``codec:``);
    # new configs should quantize via the codec block instead.
    allow_global_lossy: bool = False
    # At-least-once in-order delivery (runtime/bus.py ReliableTransport)
    # for queues matching ``reliable-queues``: sequence-numbered + ack'd
    # frames with bounded redelivery, receiver-side dedup + resequencing.
    # Default off — the plain queues are at-most-once, exactly the
    # reference's semantics; turn on for lossy/restarting brokers and
    # chaos runs.
    reliable: bool = False
    reliable_queues: tuple = ("intermediate_queue*", "gradient_queue*",
                              "rpc_queue", "aggregate_queue*")
    redeliver_s: float = 0.3        # first redelivery deadline (backoff x1.5)
    max_redeliver: int = 20         # bounded redelivery, then give up

    #: short spellings accepted for wire-dtype
    WIRE_DTYPE_ALIASES = {"fp32": "float32", "fp16": "float16",
                          "bf16": "bfloat16"}

    @property
    def wire_dtype_normalized(self) -> str:
        return self.WIRE_DTYPE_ALIASES.get(self.wire_dtype,
                                           self.wire_dtype)

    def validate(self):
        _check(self.kind in ("inproc", "tcp"),
               f"transport must be inproc|tcp, got {self.kind!r}")
        _check(self.wire_dtype_normalized in ("float32", "float16",
                                              "bfloat16", "int8"),
               f"wire-dtype must be float32|float16|bfloat16|int8 "
               f"(or fp32|fp16|bf16), got {self.wire_dtype!r}")
        from split_learning_torch.runtime.codec.specs import (
            CodecSpecError, parse_codec_map,
        )
        try:
            parsed = parse_codec_map(self.codec)
        except CodecSpecError as e:
            raise ConfigError(f"transport.codec: {e}") from None
        if self.wire_dtype_normalized == "int8":
            _check(not parsed,
                   "transport.wire-dtype: int8 together with a "
                   "transport.codec block is ambiguous (two quantizers "
                   "would stack); move quantization into the codec "
                   "block, e.g. codec: {intermediate: int8, "
                   "gradient: int8}")
            _check(self.allow_global_lossy,
                   "transport.wire-dtype: int8 lossily quantizes EVERY "
                   "data-plane payload with the legacy per-tensor "
                   "quantizer; prefer the per-queue transport.codec "
                   "block, or set transport.allow-global-lossy: true "
                   "to opt in explicitly")
        _check(self.redeliver_s > 0, "redeliver-s must be > 0")
        _check(self.max_redeliver >= 1, "max-redeliver must be >= 1")
        _check(self.send_depth >= 1, "send-depth must be >= 1")
        _check(self.prefetch_depth >= 1, "prefetch-depth must be >= 1")
        _check(self.chunk_mb >= 1, "chunk-mb must be >= 1")


@dataclasses.dataclass(frozen=True)
class BrokerConfig:
    """Broker-plane shape (``runtime/bus.py``).

    ``shards`` > 1 splits the TCP broker into N independent shard
    processes on consecutive ports (``transport.port`` ..
    ``transport.port + shards - 1``).  Every participant maps each
    queue to its owning shard with the same deterministic
    ``shard_for`` hash (family-aware: a queue family's instances
    round-robin across shards, one queue never spans two), so the
    fleet's aggregate broker bandwidth scales with the shard count
    instead of serializing through one process.  A dead shard stalls
    only its own queues; per-shard reconnect backoff plus the
    reliable layer's redelivery recover it across a restart.  1
    (default) is the classic single broker — exactly the pre-sharding
    deployment.  Ignored by ``transport.kind: inproc`` (no broker
    process exists to shard)."""
    shards: int = 1
    #: seconds between the server's broker-plane stats sweeps (the
    #: /fleet "brokers" block + broker_* gauges); 0 disables polling
    stats_interval: float = 5.0

    def validate(self):
        _check(self.shards >= 1, "broker.shards must be >= 1")
        _check(self.shards <= 256,
               f"broker.shards must be <= 256, got {self.shards!r}")
        _check(self.stats_interval >= 0,
               "broker.stats-interval must be >= 0")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault injection (``runtime/chaos.py``).

    Every fault decision is drawn from a per-queue RNG seeded by
    ``(seed, queue)``, so a run's fault pattern is reproducible from the
    single ``chaos.seed`` — per queue, independent of scheduling — and a
    failure found in a chaos sweep replays exactly.  ``crash`` holds
    scripted crash points, e.g.::

        crash:
          - {client: client_1_1, queue: "intermediate_queue*", after: 2}

    meaning "client_1_1's process dies at its 2nd activation publish".
    Probabilities apply per published message on matching ``queues``."""
    enabled: bool = False
    seed: int = 0
    drop: float = 0.0               # message silently lost
    duplicate: float = 0.0          # message delivered twice
    reorder: float = 0.0            # message swapped behind its successor
    corrupt: float = 0.0            # one payload byte flipped
    delay: float = 0.0              # message held for delay-s
    delay_s: float = 0.02
    # rpc_queue included so EVERY tensor-framed message kind has a
    # default fault-injection point (slcheck PC006): Update rides
    # rpc_queue, and a wire type chaos can never touch is a recovery
    # path no soak ever exercises; aggregate_queue* covers the
    # aggregator-tree upload leg (Update -> L1) the same way
    queues: tuple = ("intermediate_queue*", "gradient_queue*",
                     "rpc_queue", "aggregate_queue*")
    crash: tuple = ()               # scripted crash points (dicts)

    def validate(self):
        for name in ("drop", "duplicate", "reorder", "corrupt", "delay"):
            v = getattr(self, name)
            _check(0.0 <= v <= 1.0,
                   f"chaos.{name} must be in [0, 1], got {v!r}")
        _check(self.delay_s >= 0, "chaos.delay-s must be >= 0")
        for spec in self.crash:
            _check(isinstance(spec, dict) and "client" in spec,
                   f"chaos.crash entries must be mappings with a "
                   f"'client' key, got {spec!r}")
            after = spec.get("after", 1)
            try:
                after = int(after)
            except (TypeError, ValueError):
                after = 0   # fall through to the clean error below
            _check(after >= 1,
                   f"chaos.crash 'after' must be an integer >= 1, "
                   f"got {spec.get('after', 1)!r}")


@dataclasses.dataclass(frozen=True)
class BlackboxConfig:
    """Per-process flight recorder (``runtime/blackbox.py``).

    Every process entry point installs a bounded in-memory event ring
    fed by the existing instrumentation seams (spans, transport
    publish/consume metadata, chaos injections, fault-counter deltas,
    scheduler decisions).  On abnormal exit (SIGTERM/SIGABRT,
    uncaught exception, sticky ChaosCrash) — or on demand via the
    server's ``BlackboxDump`` fan-out when any fleet member dies —
    the ring flushes an atomic ``blackbox-{participant}.json`` dump
    that ``tools/sl_postmortem.py`` assembles into a causal
    root-cause report.  ``ring-events`` bounds the ring (oldest
    events overwritten); ``dump-dir`` overrides where dumps land
    (default: the run-scoped artifacts directory, next to
    ``spans-*.jsonl`` and ``metrics.jsonl``)."""
    enabled: bool = True
    ring_events: int = 2048
    dump_dir: str | None = None

    def validate(self):
        _check(self.ring_events >= 16,
               f"observability.blackbox.ring-events must be >= 16, "
               f"got {self.ring_events!r}")


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """Distributed round tracing (``runtime/spans.py``).

    Every participant journals spans to ``spans-{participant}.jsonl``
    (under ``journal-dir``, default the run's ``log_path``); the wire
    propagates a compact trace context on every TENSOR/chunk frame so
    publish and consume spans link across participants.
    ``tools/sl_trace.py`` merges the journals into a Perfetto
    ``trace.json`` and prints the per-round critical-path report.
    ``sample-rate`` thins the per-frame/per-batch spans (structural
    round/phase spans always record); latency histograms and counters
    are unaffected by sampling.

    Live telemetry plane (``runtime/telemetry.py``):
    ``heartbeat-interval`` is the period (seconds) of each client's
    background HEARTBEAT publish on the rpc queue (0 disables the
    plane entirely — no emitter threads, no FleetMonitor);
    ``liveness-timeout`` is how long the server's FleetMonitor lets a
    client stay silent before marking it ``lost`` — the state the
    round barriers drop instead of stalling until the 600 s RPC
    deadline; ``http-port`` (when set) serves ``/metrics`` (Prometheus
    text) and ``/fleet`` (JSON) from the server process (0 = an
    OS-assigned ephemeral port, logged at startup).

    ``run-scoped`` routes every output file (``app.log``,
    ``metrics.jsonl``, ``spans-*.jsonl``) under
    ``{journal-dir or log_path}/artifacts/runs/{run_id}/`` with compat
    symlinks at the old paths, so successive runs stop appending into
    one shared metrics.jsonl.

    Fleet-scale telemetry (``runtime/sketch.py``):
    ``digest-interval`` > 0 turns on the hierarchical heartbeat
    roll-up — clients' HEARTBEATs route to their aggregator node's
    digest queue and the server ingests one merged ``FleetDigest`` per
    node per interval (O(nodes), not O(clients)); the server keeps
    exact per-client state only for a ``watchlist-size``-bounded set
    (digest top-K / recent transitions / scheduler attention, with
    promotion/demotion hysteresis).  ``max-client-series`` caps the
    per-client ``sl_client_*`` cardinality on ``/metrics`` (watchlist
    first; the rest live in the fleet-level quantile families) and is
    the client count past which ``/fleet`` defaults to its summary
    shape.  ``metrics-max-mb`` > 0 rotates ``metrics.jsonl`` at that
    size (keeping ``metrics-keep`` rotated files) so long fleet runs
    cannot grow it without bound."""
    enabled: bool = True
    sample_rate: float = 1.0
    journal_dir: str | None = None      # None -> the run's log_path
    flush_every: int = 128              # span-journal buffer size
    heartbeat_interval: float = 2.0     # seconds; 0 = heartbeats off
    liveness_timeout: float = 45.0      # silent seconds -> lost
    http_port: int | None = None        # /metrics + /fleet; 0 = ephemeral
    run_scoped: bool = True             # artifacts/runs/<run_id>/ layout
    digest_interval: float = 0.0        # seconds; 0 = roll-up off
    max_client_series: int = 256        # /metrics sl_client_* cap
    watchlist_size: int = 64            # exact-state bound (digest mode)
    metrics_max_mb: float = 0.0         # metrics.jsonl rotation; 0 = off
    metrics_keep: int = 4               # rotated metrics.jsonl.N kept
    blackbox: BlackboxConfig = BlackboxConfig()  # flight recorder

    def validate(self):
        self.blackbox.validate()
        _check(0.0 <= self.sample_rate <= 1.0,
               f"observability.sample-rate must be in [0, 1], "
               f"got {self.sample_rate!r}")
        _check(self.flush_every >= 1,
               "observability.flush-every must be >= 1")
        _check(self.heartbeat_interval >= 0,
               "observability.heartbeat-interval must be >= 0")
        _check(self.liveness_timeout > self.heartbeat_interval,
               "observability.liveness-timeout must exceed the "
               "heartbeat interval")
        _check(self.http_port is None
               or 0 <= int(self.http_port) <= 65535,
               f"observability.http-port must be in [0, 65535], "
               f"got {self.http_port!r}")
        _check(self.digest_interval >= 0,
               "observability.digest-interval must be >= 0")
        _check(self.digest_interval == 0
               or self.heartbeat_interval > 0,
               "observability.digest-interval requires "
               "heartbeat-interval > 0 (digests roll up heartbeats)")
        _check(self.max_client_series >= 1,
               "observability.max-client-series must be >= 1")
        _check(self.watchlist_size >= 0,
               "observability.watchlist-size must be >= 0")
        _check(self.metrics_max_mb >= 0,
               "observability.metrics-max-mb must be >= 0")
        _check(self.metrics_keep >= 1,
               "observability.metrics-keep must be >= 1")


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    """Compute performance-attribution plane (``runtime/perf.py``).

    ``sample-every`` is the step-sampling period of the hot-loop
    device fence: every Nth step is ``block_until_ready``-fenced to
    measure device wall (the other N-1 steps stay sync-free — the
    ``perf`` slcheck analyzer enforces that discipline statically).
    ``profile-dir`` overrides where on-demand ``POST /profile``
    captures land (default: the run-scoped output directory's
    ``profile/``).  ``datasheet`` overrides/extends the built-in
    per-``device_kind`` bf16 peak-TFLOPs table used as the MFU
    denominator — the supported way to pin a measured CPU roofline,
    e.g. ``datasheet: {cpu: 0.1}``."""
    enabled: bool = True
    sample_every: int = 16
    profile_dir: str | None = None
    datasheet: Any = None               # {device_kind: peak bf16 TFLOPs}

    def validate(self):
        _check(self.sample_every >= 1,
               "perf.sample-every must be >= 1")
        if self.datasheet is not None:
            _check(isinstance(self.datasheet, dict)
                   and all(isinstance(k, str) for k in self.datasheet),
                   "perf.datasheet must map device_kind -> TFLOPs")
            for k, v in self.datasheet.items():
                try:
                    ok = float(v) > 0
                except (TypeError, ValueError):
                    ok = False
                _check(ok, f"perf.datasheet[{k!r}] must be a positive "
                           f"number, got {v!r}")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Closed-loop resource-aware scheduler (``runtime/scheduler.py``).

    Runs at round boundaries on the protocol server, consuming the
    fleet-telemetry plane (per-client EWMA rate, compute rate, step
    p95, version lag — PRs 7/8/10) and closing the loop back into the
    plan: online clustering of clients, straggler demotion/eviction
    with per-client knob retunes, and measured-throughput cut
    re-planning.  Every decision is journaled as a ``kind=sched``
    metrics record (slcheck SC001 enforces that no control action is
    silent).  Default off — a static hand-written plan behaves exactly
    as before."""
    enabled: bool = False
    # decide every N rounds (1 = every round boundary)
    interval: int = 1
    # observe-only boundaries before the first action: the policies
    # need at least one round of telemetry to score against
    warmup_rounds: int = 1
    # online-clustering centroid count; 0 = one cluster per plan
    clusters: int = 0
    # mini-batch KMeans partial-fit cap per boundary: bounds the
    # decision cost so clustering stays O(minibatch) per round however
    # large the fleet grows (assignment stays O(n), vectorized)
    minibatch: int = 1024
    # sticky re-assignment margin: a client moves cluster only when the
    # new centroid is at least this fraction CLOSER than its current
    # one — the hysteresis that keeps assignments stable under churn
    hysteresis: float = 0.25
    # straggler eviction (through the elastic-drop path) on/off, and
    # how many consecutive scheduler boundaries a client must score
    # straggler before it is evicted rather than demoted
    evict: bool = True
    evict_after: int = 2
    # per-client knob demotion on/off
    demote: bool = True
    # codec retune shipped to WIRE-slow stragglers (START extra.sched):
    # any intermediate-family spec (runtime/codec/specs.py)
    wire_slow_codec: str = "int8:64"
    # extra bounded-staleness window granted to COMPUTE-slow stragglers
    # (async mode: their late Updates keep folding), and whether they
    # are exempted from quorum denominators
    staleness_bonus: int = 2
    # measured-throughput cut re-planning on/off, the damping threshold
    # (a new cut is adopted only when its predicted round wall improves
    # on the incumbent by at least this fraction — the anti-flap
    # contract), and the cooldown in rounds between adopted re-plans
    replan: bool = True
    replan_damping: float = 0.15
    replan_cooldown: int = 2
    # aggregator fan-in retuning (aggregation.fan-in >= 2 only): at
    # round boundaries the scheduler rescans the fan-in candidates
    # against the MEASURED per-contribution fold wall the kind=agg_node
    # heartbeats report, adopting a new tree width when the predicted
    # critical-path fold wall improves by replan-damping (same cooldown
    # as cut re-planning; journaled kind=sched action "retune")
    retune_fanin: bool = True
    # mid-round barrier policy: a NOTIFY/UPDATE barrier may drop a
    # health-state-straggler client after waiting this many seconds
    # (0 disables mid-round drops; lost clients are always droppable
    # via the fleet-liveness path regardless)
    barrier_grace_s: float = 20.0
    seed: int = 0

    def validate(self):
        _check(self.interval >= 1, "scheduler.interval must be >= 1")
        _check(self.warmup_rounds >= 0,
               "scheduler.warmup-rounds must be >= 0")
        _check(self.clusters >= 0, "scheduler.clusters must be >= 0")
        _check(self.minibatch >= 1, "scheduler.minibatch must be >= 1")
        _check(0.0 <= self.hysteresis < 1.0,
               f"scheduler.hysteresis must be in [0, 1), "
               f"got {self.hysteresis!r}")
        _check(self.evict_after >= 1,
               "scheduler.evict-after must be >= 1")
        _check(self.staleness_bonus >= 0,
               "scheduler.staleness-bonus must be >= 0")
        _check(0.0 <= self.replan_damping < 1.0,
               f"scheduler.replan-damping must be in [0, 1), "
               f"got {self.replan_damping!r}")
        _check(self.replan_cooldown >= 0,
               "scheduler.replan-cooldown must be >= 0")
        _check(self.barrier_grace_s >= 0,
               "scheduler.barrier-grace-s must be >= 0")
        from split_learning_torch.runtime.codec.specs import (
            CodecSpecError, parse_codec_map,
        )
        try:
            parse_codec_map({"intermediate": self.wire_slow_codec})
        except CodecSpecError as e:
            raise ConfigError(
                f"scheduler.wire-slow-codec: {e}") from None


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Cross-host MPMD stage pipeline (``runtime/stagehost.py``).

    ``remote: true`` moves the pipeline's LATER-stage clients (the
    ``intermediate_queue_*`` consumers) out of the deployment's
    process group into standalone stage-host processes adopted over
    the broker via StageHello/StageAssign — stage-0 feeders stay
    wherever the deployment put them (they own the data).  The
    activation/gradient streams already ride broker queues as
    TENSOR/SLTC frames, so transport, codecs, generation fences and
    the async staleness plane compose unchanged; what changes is WHO
    polls those queues."""
    # Adopt stage hosts announced with StageHello and assign them the
    # later-stage client slots.  False (default): in-process later
    # stages, unchanged.
    remote: bool = False
    # With remote: the number of stage-host subprocesses the SERVER
    # spawns at startup (tcp transport only).  0 = adopt externally
    # started hosts (`python -m split_learning_tpu.stagehost`).
    hosts: int = 0
    # Per-round cap on counted slot re-assignments after a stage-host
    # death (FleetMonitor `lost` or child-process exit).  Each retry
    # re-assigns the dead host's slots to a survivor under the SAME
    # client ids and re-runs the round attempt behind a bumped
    # generation fence — the re-run fold is bit-identical to the
    # fault-free twin.  Exhausting retries fails the round loudly.
    retries: int = 2
    # With hosts: pin each spawned stage host to its own CPU core
    # (host i -> core (i+1) mod cpu_count; core 0 stays with the
    # server + feeders).  The NUMA-naive placement proxy the MPMD
    # bench cell uses so host processes don't migrate mid-measurement;
    # ignored when there are fewer cores than processes.
    pin_cpus: bool = False

    def validate(self):
        _check(self.hosts >= 0, "pipeline.hosts must be >= 0")
        _check(not self.hosts or self.remote,
               "pipeline.hosts requires pipeline.remote")
        _check(self.retries >= 0, "pipeline.retries must be >= 0")


@dataclasses.dataclass(frozen=True)
class KernelsConfig:
    """Pallas hot-path kernel plane (``ops/kernels/``).

    Per-kernel enables for the single-pass fused kernels that replace
    the XLA op chains on the two data-plane hot blocks: the tiled
    absmax quantize/dequantize codec path and the fused round-boundary
    ``stage_update``.  Off (default) keeps the pre-kernel XLA chains —
    byte-for-byte the old behavior.  When enabled, the same kernels
    run under the Pallas interpreter off-TPU and lower natively on
    TPU; the slcheck ``pallas`` analyzer (PK001) asserts an enabled
    kernel's ``pallas_call`` is actually present in the traced
    hot-path jaxpr."""
    # fused quantize (absmax reduce + scale + round/clip + NaN
    # sentinel + int4 nibble-pack in one VMEM pass) on the sender
    quantize: bool = False
    # the mirror fused dequantize on the receiver hot path
    dequantize: bool = False
    # fused FedAvg divide + FedAvgM momentum + wire-dtype cast inside
    # the sharded round-boundary update (aggregation.sharded)
    stage_update: bool = False
    # grid block target (tiles per quantize instance / axis-0 rows per
    # update instance); auto-shrunk to the largest exact divisor
    block: int = 128

    def validate(self):
        _check(self.block >= 1, "kernels.block must be >= 1")


@dataclasses.dataclass(frozen=True)
class Config:
    model: str = "VGG16"
    dataset: str = "CIFAR10"
    clients: tuple = (1, 1)         # per-stage client counts
    global_rounds: int = 1
    limited_time: float | None = None   # Vanilla_SL wall-clock budget (s)
    seed: int = 0
    debug: bool = False
    log_path: str = "."
    compute_dtype: str = "bfloat16"     # bfloat16 | float32
    # Persistent XLA compilation cache directory (default off): every
    # entry point applies it via platform.apply_compile_cache, so a
    # restarted process (the protocol deployment's cold round) reuses
    # compiled programs instead of re-paying the compile tax.
    compile_cache_dir: str | None = None
    model_kwargs: Any = None            # overrides for the model spec function
    synthetic_size: int | None = None   # force synthetic datasets (tests)
    val_batch_size: int = 200
    val_max_batches: int | None = None
    learning: LearningConfig = LearningConfig()
    distribution: DistributionConfig = DistributionConfig()
    topology: TopologyConfig = TopologyConfig()
    aggregation: AggregationConfig = AggregationConfig()
    checkpoint: CheckpointConfig = CheckpointConfig()
    transport: TransportConfig = TransportConfig()
    broker: BrokerConfig = BrokerConfig()
    chaos: ChaosConfig = ChaosConfig()
    observability: ObservabilityConfig = ObservabilityConfig()
    perf: PerfConfig = PerfConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    pipeline: PipelineConfig = PipelineConfig()
    kernels: KernelsConfig = KernelsConfig()

    @property
    def model_key(self) -> str:
        """Registry key, reference naming: ``{MODEL}_{DATASET}``."""
        return f"{self.model}_{self.dataset}"

    @property
    def num_stages(self) -> int:
        return len(self.clients)

    def validate(self) -> "Config":
        _check(self.global_rounds >= 1, "global-rounds must be >= 1")
        _check(len(self.clients) >= 1 and all(c >= 1 for c in self.clients),
               "clients must be a non-empty list of positive counts")
        _check(self.compute_dtype in ("bfloat16", "float32"),
               f"compute-dtype must be bfloat16|float32, "
               f"got {self.compute_dtype!r}")
        for sub in (self.learning, self.distribution, self.topology,
                    self.aggregation, self.transport, self.broker,
                    self.chaos, self.observability, self.perf,
                    self.scheduler, self.pipeline, self.kernels):
            sub.validate()
        if self.scheduler.enabled:
            # the scheduler's only senses are the fleet-telemetry
            # plane's; with heartbeats disabled there is no
            # FleetMonitor and every policy would be blind
            _check(self.observability.heartbeat_interval > 0,
                   "scheduler.enabled requires "
                   "observability.heartbeat-interval > 0 (the "
                   "scheduler's inputs are the fleet-telemetry "
                   "plane's per-client series)")
        if self.learning.mode == "async":
            # the bounded-staleness admission window lives in the
            # streaming fold; strategies that consume individual
            # u.params (relay/periodic/fedasync) have no place to fold
            # a staleness-weighted late contribution
            _check(self.aggregation.strategy in ("fedavg", "sda",
                                                 "cluster_relay"),
                   "learning.mode: async requires a streaming-capable "
                   "aggregation strategy (fedavg|sda|cluster_relay), "
                   f"got {self.aggregation.strategy!r}")
            # the admission window LIVES in the streaming fold: with
            # streaming off there is nothing to fold a late Update
            # into (every stale contribution would be rejected), and
            # with an aggregator tree the L1s hard-fence on the
            # generation before the root ever sees the frame — both
            # would silently void the mode's staleness contract
            _check(self.aggregation.streaming,
                   "learning.mode: async requires "
                   "aggregation.streaming: true (the bounded-staleness "
                   "window folds into the streaming plane)")
            _check(self.aggregation.fan_in == 0,
                   "learning.mode: async does not compose with the "
                   "aggregator tree yet (L1 groups generation-fence "
                   "Updates before the admission window) — set "
                   "aggregation.fan-in: 0")
        if self.aggregation.nodes:
            _check(self.transport.kind == "tcp",
                   "aggregation.nodes (server-spawned aggregator "
                   "subprocesses) requires transport.kind: tcp — "
                   "in-process deployments adopt AggregatorNode "
                   "threads instead")
        if self.pipeline.hosts:
            _check(self.transport.kind == "tcp",
                   "pipeline.hosts (server-spawned stage-host "
                   "subprocesses) requires transport.kind: tcp — "
                   "in-process deployments adopt StageHost threads "
                   "instead")
        if self.topology.mode == "manual":
            cuts = self.topology.cluster_cut_layers or (
                self.topology.cut_layers,)
            for cl in cuts:
                _check(len(cl) == len(self.clients) - 1 or
                       len(self.clients) == 1,
                       f"manual cut list {cl!r} must have "
                       f"num_stages-1 = {len(self.clients) - 1} entries")
        return self


_SECTION_TYPES = {
    "learning": LearningConfig,
    "distribution": DistributionConfig,
    "topology": TopologyConfig,
    "aggregation": AggregationConfig,
    "checkpoint": CheckpointConfig,
    "transport": TransportConfig,
    "broker": BrokerConfig,
    "chaos": ChaosConfig,
    "observability": ObservabilityConfig,
    "perf": PerfConfig,
    "scheduler": SchedulerConfig,
    "pipeline": PipelineConfig,
    "kernels": KernelsConfig,
}


def _freeze(v):
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


def _coerce(v, annotation: str):
    """YAML 1.1 parses ``5e-4`` (no dot) as a string; coerce strings into
    the field's declared numeric type so reference-style configs load."""
    if not isinstance(v, str):
        return v
    ann = annotation.replace(" ", "")
    try:
        if ann.startswith("float"):
            return float(v)
        if ann.startswith("int"):
            return int(v)
    except ValueError:
        pass
    return v


#: dataclass-typed fields NESTED inside a section (annotation name ->
#: class), so ``observability.blackbox: {...}`` builds a sub-config
#: instead of freezing to a plain dict
_NESTED_TYPES = {"BlackboxConfig": BlackboxConfig}


def _build(cls, d: dict, path: str):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        key = k.replace("-", "_")
        _check(key in fields, f"unknown config key {path}{k!r}")
        ann = str(fields[key].type).replace(" ", "")
        if ann in _NESTED_TYPES:
            _check(isinstance(v, dict),
                   f"section {path}{k!r} must be a mapping")
            kwargs[key] = _build(_NESTED_TYPES[ann], v, f"{path}{k}.")
        else:
            kwargs[key] = _coerce(_freeze(v), ann)
    return cls(**kwargs)


def from_dict(d: dict[str, Any]) -> Config:
    top: dict[str, Any] = {}
    for k, v in d.items():
        key = k.replace("-", "_")
        if key in _SECTION_TYPES:
            _check(isinstance(v, dict),
                   f"section {k!r} must be a mapping")
            top[key] = _build(_SECTION_TYPES[key], v, f"{k}.")
        else:
            fields = {f.name: f for f in dataclasses.fields(Config)}
            _check(key in fields, f"unknown config key {k!r}")
            top[key] = _coerce(_freeze(v), str(fields[key].type))
    return Config(**top).validate()


def from_yaml(path: str | pathlib.Path) -> Config:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    _check(isinstance(data, dict), "config file must be a mapping")
    return from_dict(data)


def to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)
