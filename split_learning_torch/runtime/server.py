"""Protocol server: the reference's ``server.py`` + ``src/Server.py``
state machine over a transport.

Port of the synchronous part of the JAX package's ``runtime/server.py``.
The server is a :class:`ProtocolContext` — a
:class:`~split_learning_torch.runtime.context.TrainContext` whose
``train_cluster`` drives clients through the control protocol instead
of training locally — so the round strategies work unchanged over it.
It holds the full model for reassembly and validation on its device.

Round choreography: registration barrier -> planning -> per-round START
with shard weights (chunked per stage) -> READY barrier -> SYN -> NOTIFY
collection -> PAUSE fan-out -> UPDATE collection (each UPDATE folds into
the streaming fold the moment it decodes) -> the fold's round-boundary
update (FedAvg divide, FedAvgM momentum, cast) -> validation +
checkpoint through the shared round loop.  Every barrier carries a
deadline; clients that miss it are dropped from the round with a logged
warning instead of wedging the server.

All six round strategies run over it: relay STARTs one stage-1 client at
a time, FLEX's hold rounds send STARTs without weights and PAUSEs that
ask for none back, SDA widens each head's window over distinct feeders
(DCSL's per-device scatter, strict SDA's epoch fences with their quorum
and feeder sets rebroadcast with SYN), and 2LS pairs each in-cluster's
feeders with its own head's queue.

Without a transport from the caller the server builds its configured
stack (``runtime/chaos.py`` ``make_runtime_transport``: the async sender
over the reliable layer over chaos injection, on one broker or a sharded
plane) and closes every layer of it when ``serve`` ends.  The process's
cumulative fault counters (drops, redeliveries, dedup hits, reconnects,
...) go into a ``kind=faults`` record each round, and into a ``round
faults (cumulative): ...`` log line when they changed.

Async decoupled mode (``learning.mode: async``): the generation is the
global model version.  An UPDATE seeded from version ``v`` is admitted
while ``version - v <= learning.max-staleness`` and folds at weight
``staleness-decay ** lag`` under the key ``client@vN``; an older one is
rejected and counted.  With ``learning.async-quorum`` N the NOTIFY and
UPDATE barriers cut the version at N fresh contributions, and a
straggler's work folds late through the window.  A READY arriving after
the SYN fan-out of an async round still gets its SYN (with the
responsive set's fence overrides) and its PAUSE.

With an ``rpc`` delta codec the server keeps a versioned shadow of the
shard each weighted START carried, advertises its version in every
START, and folds ``base + delta`` back into a full tree before the
streaming fold; a full frame is counted (``delta_full_frames``), and a
delta against an unknown base drops its weights and re-seeds the client
with a full START next round.

The aggregator tree (``aggregation.fan-in``, ``aggregation.levels``):
the round's clients are planned into groups (``runtime/aggregate.py``
``plan_tree``), each START names the client's level-1 group, and after
the READY barrier one ``L1Aggregator`` thread a group (any level) folds
its responsive members into one PartialAggregate for its parent.  The
root folds the parentless groups' partials at their canonical
positions, decoding the ``partial`` codec first (``transport.codec:
{partial: ...}``; the delta mode against this generation's START
shards).  An aggregator that dies mid-round is replaced by the server's
own drain of its queue (counted ``agg_l1_fallbacks``): parentless
groups fold straight into the root, others publish a substitute partial
into their parent's queue; members whose frames the dead aggregator had
consumed are abandoned after a grace period (``agg_fallback_abandons``)
rather than stalling the UPDATE barrier.

Round tracing (``observability``): the server's tracer, wire counters
and latency histograms are its transport stack's when it has them, else
its own.  Its trace id rides every START (``extra["trace_id"]``), which
the clients adopt; each invocation journals ``start_fanout``,
``ready_wait``, ``syn_fanout``, ``notify_wait``, ``pause_fanout``,
``update_wait`` and the fold's ``aggregate`` (one ``update_stage``
record a stage) under the round loop's ``train`` span, and a
``consume`` span per UPDATE, parented to the client's ``publish``.  The
``kind=wire`` record carries the wire counters' fields, and a
``kind=latency`` record (this participant's histograms merged with the
process-wide ``queue_wait`` and ``transport_rtt``) follows when they
changed.

The live telemetry plane (``observability``, ``runtime/telemetry.py``):
with ``heartbeat-interval`` > 0 (the default) the server runs a
:class:`~split_learning_torch.runtime.telemetry.FleetMonitor` fed by
every client's HEARTBEAT frames, by the snapshot each UPDATE carries
(also the members' snapshots behind a partial aggregate), and by any
other client frame as proof of life.  Liveness ages count only after a
drained pump (``note_pump``).  The READY, NOTIFY and UPDATE barriers
name the clients they still need: every ``_WAIT_CHECK_S`` they advance
the monitor, and once every missing client is ``lost`` (silent for
``liveness-timeout`` seconds) the barrier is released at once, counted
``fleet_lost_drops``, instead of waiting out the client timeout.  A
``lost`` client's delta shadow is dropped.  Each invocation ends with a
``kind=fleet`` record.  With ``http-port`` set, a
:class:`~split_learning_torch.runtime.telemetry.TelemetryExporter`
serves ``/metrics`` (Prometheus text) and ``/fleet`` (the monitor's
snapshot, with the aggregator tree's topology and, over TCP, the broker
shards' stats) for ``tools/sl_top.py``.  No aggregator node sends digests
yet, so ``digest-interval`` leaves every client beating straight to the
rpc queue, as the JAX package does with no node adopted.

Left out (each raises ``NotImplementedError`` when its config asks for
it): the remote aggregator nodes, stage hosts, the scheduler, elastic
re-planning, the per-leaf legacy fold finish
(``aggregation.update-sharded: false``).  The perf plane's on-demand
profile (``POST /profile`` answers 404) and the blackbox are not run.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from collections import Counter
from typing import Any, Callable

import numpy as np
import torch

from split_learning_torch.config import Config
from split_learning_torch.device import resolve_device
from split_learning_torch.models import shard_params
from split_learning_torch.parallel.mesh import stage_ranges
from split_learning_torch.runtime import aggregate as agg_plane
from split_learning_torch.runtime.bus import (
    InProcTransport, QueueClosed, Transport, queue_family,
)
from split_learning_torch.runtime.codec import make_codecs
from split_learning_torch.runtime.context import TorchContext, client_groups
from split_learning_torch.runtime.log import Logger
from split_learning_torch.runtime.loop import TrainResult, run_training
from split_learning_torch.runtime.plan import (
    ClusterPlan, Registration, plan_clusters,
)
from split_learning_torch.runtime.protocol import (
    RPC_QUEUE, FrameAssembler, Heartbeat, Notify, PartialAggregate, Pause,
    Ready, Register, Start, Stop, Syn, Update, encode, encode_parts,
    host_tensor, reply_queue,
)
from split_learning_torch.runtime.spans import make_tracer, unpack_ctx
from split_learning_torch.runtime.telemetry import FleetMonitor, GaugeSet


class RoundTimeout(RuntimeError):
    pass


def _np_tree(tree: dict) -> dict:
    """A state tree of tensors as host numpy arrays (the START payload)."""
    return {k: (_np_tree(v) if isinstance(v, dict)
                else v.detach().cpu().numpy()) for k, v in tree.items()}


def _torch_tree(tree: dict, device) -> dict:
    """A fold result (numpy or tensors) as tensors on ``device``."""
    return {k: (_torch_tree(v, device) if isinstance(v, dict)
                else (v if isinstance(v, torch.Tensor)
                      else host_tensor(np.ascontiguousarray(v))).to(device))
            for k, v in tree.items()}


def _stage_flag(flag: bool | dict, stage: int) -> bool:
    """A strategy's per-round flag for ``stage``: a bool, or a
    ``{stage: bool}`` map (a stage it does not name: True)."""
    return bool(flag.get(stage, True) if isinstance(flag, dict) else flag)


def _note_members(fleet, members) -> None:
    """The snapshots of the clients behind a partial aggregate (or a
    fallback drain's UPDATEs) reach ``fleet`` one by one: a client
    behind an aggregator stays visible everywhere but the fold."""
    if fleet is None:
        return
    for m in members or []:
        cid = m.get("client_id")
        if cid is not None and m.get("telemetry"):
            fleet.note_heartbeat(cid, m["telemetry"])


def _refuse_unported(cfg: Config) -> None:
    agg, topo = cfg.aggregation, cfg.topology
    later = [
        (agg.remote, "aggregation.remote (aggregator nodes)",
         "the remote aggregator nodes' slice, which heartbeat through "
         "the telemetry plane"),
        (cfg.pipeline.remote, "pipeline.remote (stage hosts)",
         "the fleet planes' slice"),
        (cfg.scheduler.enabled, "scheduler.enabled (the closed-loop "
                                "scheduler)", "the fleet planes' slice"),
        (topo.elastic_join, "topology.elastic-join (elastic re-planning)",
         "the fleet planes' slice"),
    ]
    for on, what, when in later:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet; it comes with {when}; the "
                "protocol round and its thread-mode aggregator tree are "
                "(see ROADMAP.md)")


class ProtocolContext(TorchContext):
    """Server-side TrainContext that trains via protocol clients.

    Validation and init reuse the in-process context: the server holds
    the full model on its device for reassembly and test passes."""

    #: remote clients keep their shard between rounds (the periodic
    #: strategy's wire economy reads this)
    clients_hold_state = True

    def __init__(self, cfg: Config, transport: Transport,
                 logger: Logger | None = None,
                 client_timeout: float = 600.0,
                 ready_timeout: float | None = None, device=None):
        _refuse_unported(cfg)
        super().__init__(cfg, device=device)
        self.bus = transport
        from split_learning_torch.runtime.trace import (
            HistogramSet, default_fault_counters, default_wire_counters,
        )
        self.faults = default_fault_counters
        self._fault_base: dict | None = None
        self.wire = getattr(transport, "wire", None) \
            or default_wire_counters
        self.tracer = getattr(transport, "tracer", None) \
            or make_tracer(cfg, "server")
        self.hists = getattr(transport, "hists", None) or HistogramSet()
        self._hist_base: dict | None = None
        self._assembler = FrameAssembler()   # chunked UPDATE reassembly
        self.log = logger or Logger.for_run(cfg, "server", console=False)
        # the live telemetry plane: the fleet's health state machine fed
        # by heartbeats, consulted by the barriers (None: heartbeats off)
        self.gauges = GaugeSet()
        obs = cfg.observability
        self.fleet = None
        if obs.heartbeat_interval > 0:
            self.fleet = FleetMonitor(
                interval=obs.heartbeat_interval,
                liveness_timeout=obs.liveness_timeout, log=self.log,
                gauges=self.gauges, faults=self.faults,
                watchlist_size=obs.watchlist_size)
        # the clients the barrier being pumped still needs
        # (:meth:`_barrier`), clients the planner left out (never scored)
        # and the aggregator tree of the current invocation (``/fleet``)
        self._waiting: Callable[[], set] | None = None
        self._excluded: set = set()
        self._agg_topology: dict | None = None
        self.client_timeout = client_timeout
        # the READY barrier's deadline; registration keeps the full
        # client_timeout (it covers client process start-up)
        self.ready_timeout = (client_timeout if ready_timeout is None
                              else ready_timeout)
        self._registrations: dict[str, Registration] = {}
        self._ready: set = set()
        self._notified: set = set()
        self._updates: list[Update] = []
        # installs this process's kernel plan (the receiver decode path
        # has no config in scope) and refuses unported codecs up front
        codecs = make_codecs(cfg, faults=self.faults)
        # delta-encoded UPDATEs (an rpc codec): a versioned shadow copy
        # of each client's START shard, to fold a delta back into a
        # full tree
        self._delta_shadow = None
        if "rpc" in codecs:
            from split_learning_torch.runtime.codec.delta import DeltaShadow
            self._delta_shadow = DeltaShadow(faults=self.faults)
            if self.fleet is not None:
                # a lost client's shadow is a full shard copy held here
                self.fleet.on_lost = self._on_client_lost
        # clients whose next START must carry weights whatever the
        # strategy's wire economy says (a broken delta chain)
        self._needs_params: set = set()
        # streaming aggregation plane: fold each UPDATE into a running
        # per-stage weighted sum the moment it decodes
        self._agg = cfg.aggregation
        self._streaming = (self._agg.streaming and self._agg.strategy
                           in agg_plane.FOLD_STRATEGIES)
        self._fold_backend = (agg_plane.make_fold_backend(cfg, self.device)
                              if self._streaming else None)
        self._fold: agg_plane.StreamingFold | None = None
        # the aggregator tree of the current invocation: each level-1
        # client's group, the aggregator threads, the fallback drains of
        # dead ones (group idx -> state), every group by idx, the
        # parentless ones, and each group's responsive members
        self._group_of: dict = {}
        self._l1: list = []
        self._l1_fallback: dict = {}
        self._tree_groups: dict = {}
        self._tree_roots: list = []
        self._tree_narrowed: dict = {}
        # members of a dead aggregator's group whose UPDATE frames it
        # consumed before dying: unrecoverable, so the UPDATE barrier
        # stops waiting for them (counted agg_fallback_abandons)
        self._agg_gone: set = set()
        # rpc-wire bytes of the partials that landed at this root
        self._agg_ingress_bytes = 0
        # the partial-sum codec (transport.codec: partial) and, in its
        # delta mode, this generation's per-stage START shards (both
        # ends of every tree edge hold them)
        from split_learning_torch.runtime.codec import parse_codec_map
        self._partial_codec = parse_codec_map(
            getattr(cfg.transport, "codec", None)).get("partial")
        self._partial_bases: dict = {}
        self._partial_base_gen: int | None = None
        # FedAvgM velocity, keyed cluster_id -> {path: velocity}: each
        # cluster's fold is its own optimizer stream (on the card with
        # the CUDA fold backend, between rounds too)
        self._agg_velocity: dict = {}
        # fence: messages are stamped with a per-train_cluster
        # generation, so a straggler from an abandoned invocation can't
        # satisfy a later invocation's barriers
        self._gen = 0
        self._cur_gen = 0
        # async decoupled mode: the generation IS the global model
        # version; the UPDATE pump admits contributions through a
        # bounded-staleness window and the barriers cut a new version at
        # learning.async-quorum fresh contributions
        self._async = cfg.learning.mode == "async"
        # (client_id, version) pairs already folded — at-least-once
        # redelivery must not double-count; pruned past the window
        self._folded_versions: set = set()
        # late-READY SYN: True between an async round's SYN fan-out and
        # its end, so that a straggler's late READY still gets its SYN
        # (with the responsive set's fence overrides, kept per client)
        self._syn_live = False
        self._syn_round = 0
        self._syn_overrides: dict = {}
        self.last_fold: agg_plane.FoldResult | None = None
        #: per invocation, the wall of each round phase (START fan-out,
        #: READY, training, UPDATE upload + fold, the fold's update)
        self.round_phases: list[dict] = []

    # -- rpc pump ------------------------------------------------------------

    def _pump_one(self, timeout: float) -> bool:
        raw = self.bus.get(RPC_QUEUE, timeout=timeout)
        if raw is None:
            if self.fleet is not None:
                # liveness ages are trusted only at a drained queue: after
                # an unpumped phase (validation) the backlog still holds
                # everyone's beats
                self.fleet.note_pump()
            return False
        t_wall = time.time()
        t0 = time.perf_counter()
        try:
            msg = self._assembler.feed(raw)
        except Exception as e:  # noqa: BLE001 — corrupt frame: a flipped
            # bit on rpc_queue must cost one message, not the server
            self.faults.inc("corrupt_rejected")
            self.log.warning(f"dropping undecodable rpc frame: {e}")
            self.wire.add_decode(time.perf_counter() - t0)
            return True
        dt = time.perf_counter() - t0
        self.wire.add_decode(dt)
        self.hists.observe("decode", dt)
        if msg is None:
            return True   # chunk of a still-partial frame
        ctx = unpack_ctx(getattr(msg, "_ctx", None))
        if ctx is not None:
            # consume span linked to the client's publish span: the
            # UPDATE upload gets a flow edge like any data-plane frame
            _, sender_span, t_send = ctx
            rtt = max(0.0, t_wall - t_send)
            self.hists.observe("frame_rtt", rtt)
            self.tracer.record(
                "consume", t_wall, t_wall + dt, parent=sender_span,
                queue=RPC_QUEUE, kind=type(msg).__name__,
                nbytes=len(raw), rtt_ms=round(rtt * 1e3, 3),
                round=getattr(msg, "round_idx", None))
        if isinstance(msg, Heartbeat):
            # liveness and telemetry only, never logged; the monitor's
            # staleness guard drops a duplicated or reordered beat
            if self.fleet is not None \
                    and msg.client_id not in self._excluded:
                self.fleet.note_heartbeat(msg.client_id, msg.telemetry)
            return True
        cid = getattr(msg, "client_id", None)
        if self.fleet is not None and cid is not None \
                and cid not in self._excluded:
            # any client frame proves a live process; an UPDATE's
            # snapshot counts as a full beat, whatever its generation
            if isinstance(msg, Update) and msg.telemetry:
                self.fleet.note_heartbeat(cid, msg.telemetry)
            else:
                self.fleet.note_frame(cid)
        if isinstance(msg, Register):
            # keyed by client_id: clients re-REGISTER until STARTed
            if msg.client_id not in self._registrations:
                self.log.received(f"REGISTER {msg.client_id} "
                                  f"stage={msg.stage}")
            self._registrations[msg.client_id] = Registration(
                client_id=msg.client_id, stage=msg.stage,
                cluster=msg.cluster, profile=msg.profile)
        elif isinstance(msg, Ready):
            if msg.round_idx != self._cur_gen:
                self.log.warning(f"stale READY {msg.client_id} "
                                 f"gen={msg.round_idx} (dropped)")
            else:
                late = self._syn_live and msg.client_id not in self._ready
                self._ready.add(msg.client_id)
                if late:
                    # async pipelining: the SYN fan-out already went out
                    # (the READY barrier collapsed to the responsive
                    # set); a straggler that finished its late upload
                    # still joins THIS round, with the fan-out's fence
                    # overrides (the START's may name dropped feeders)
                    q, feeders = self._syn_overrides.get(
                        msg.client_id, (None, None))
                    self.bus.publish(reply_queue(msg.client_id), encode(Syn(
                        self._syn_round, sda_fence_quorum=q,
                        sda_feeders=feeders)))
                    self.log.sent(f"SYN -> {msg.client_id} (late READY)")
        elif isinstance(msg, Notify):
            if msg.round_idx != self._cur_gen:
                self.log.warning(f"stale NOTIFY {msg.client_id} "
                                 f"gen={msg.round_idx} (dropped)")
            else:
                self._notified.add(msg.client_id)
                self.log.received(f"NOTIFY {msg.client_id}")
        elif isinstance(msg, Update):
            self._admit_update(msg)
        elif isinstance(msg, PartialAggregate):
            # one aggregator's folded group landing at the root
            if msg.round_idx != self._cur_gen:
                self.faults.inc("agg_stale_drops")
                self.log.warning(
                    f"stale PARTIALAGGREGATE {msg.aggregator_id} "
                    f"gen={msg.round_idx} (dropped)")
            else:
                self._fold_partial(msg, nbytes=self._assembler.last_bytes)
        else:
            self.log.warning(f"unexpected rpc message "
                             f"{type(msg).__name__}")
        return True

    def _admit_update(self, msg: Update) -> None:
        """The one admission door for client Updates.

        * dedup first: a redelivered Update for a ``(client_id,
          version)`` already folded is dropped before any sample
          accounting (``agg_dup_drops``);
        * sync: only the current generation folds (the hard fence);
        * async: an Update seeded from version ``v`` is admitted while
          ``version - v <= learning.max-staleness``, its FedAvg weight
          scaled by ``staleness-decay ** lag`` under the fold key
          ``client@vN`` (``agg_stale_admits``); anything older is
          rejected and counted (``agg_stale_updates``)."""
        lrn = self.cfg.learning
        ver = msg.version if msg.version is not None else msg.round_idx
        key = (msg.client_id, ver)
        if key in self._folded_versions:
            self.faults.inc("agg_dup_drops")
            self.log.warning(f"duplicate UPDATE {msg.client_id} "
                             f"v{ver} (already folded; dropped)")
            return
        lag = self._cur_gen - ver
        fresh = lag == 0 and msg.round_idx == self._cur_gen
        stale = (not fresh and self._async and self._fold is not None
                 and 0 < lag <= lrn.max_staleness)
        if not (fresh or stale):
            self.faults.inc("agg_stale_updates")
            self.log.warning(f"stale UPDATE {msg.client_id} v{ver} "
                             f"lag={lag} (rejected)")
            return
        self._fold_update(msg)
        if self._fold is not None:
            # the weights fold into the running sum NOW; the barrier
            # list holds a weight-stripped record
            if stale:
                scale = lrn.staleness_decay ** lag
                self._fold.add_update(copy.copy(msg), scale=scale,
                                      key=f"{msg.client_id}@v{ver}")
            else:
                self._fold.add_update(copy.copy(msg))
            msg.params = None
            msg.batch_stats = None
        elif msg.params is not None:
            msg.params = _torch_tree(msg.params, "cpu")
            msg.batch_stats = _torch_tree(msg.batch_stats or {}, "cpu")
        self._folded_versions.add(key)
        self._updates.append(msg)
        if self._async and self.fleet is not None:
            # version lag is an async signal: in sync mode the generation
            # counts invocations, and sequential clusters would read as lag
            self.fleet.note_client_version(msg.client_id, ver)
        if stale:
            self.faults.inc("agg_stale_admits")
            self.log.received(
                f"UPDATE {msg.client_id} v{ver} lag={lag} "
                f"(stale-admitted, weight x{scale:g})")
        else:
            self.log.received(f"UPDATE {msg.client_id} "
                              f"samples={msg.num_samples} ok={msg.ok}")

    def _fold_update(self, msg: Update) -> None:
        """Reconstruct a delta-encoded UPDATE in place (``base +
        dequant(delta)`` against the versioned shadow).  When the chain
        is broken (shadow missing or moved) the delta is unusable: the
        update is kept weight-less (the barrier must not stall on it)
        and the client is re-seeded with a full START next round.  Full
        frames pass through and are counted: they are the resync
        path."""
        if msg.delta_base is None:
            if self._delta_shadow is not None and msg.params is not None:
                self.faults.inc("delta_full_frames")
            return
        full = (None if self._delta_shadow is None
                else self._delta_shadow.fold(msg.client_id,
                                             msg.delta_base, msg.params))
        if full is None:
            self.log.warning(
                f"delta UPDATE {msg.client_id} against unknown base "
                f"v{msg.delta_base}: weights dropped; full-frame resync "
                "next round")
            self._needs_params.add(msg.client_id)
            msg.params = None
            msg.batch_stats = None
        else:
            msg.params = full
        msg.delta_base = None   # downstream sees a plain (full) update

    def _on_client_lost(self, cid: str) -> None:
        """The monitor's ``lost`` hook: drop the client's delta shadow (a
        full shard copy held here).  A client that comes back full-frames
        its next UPDATE, so the chain repairs itself."""
        if self._delta_shadow is not None:
            self._delta_shadow.clear(cid)
            self.gauges.set("agg_shadow_bytes", self._delta_shadow.nbytes())

    def exclude(self, client_ids) -> None:
        """Clients the planner left out of every plan: no longer scored
        (their silence would drag the fleet median and mint ``lost``
        states for clients no round waits for)."""
        self._excluded |= set(client_ids)
        if self.fleet is not None:
            for cid in self._excluded:
                self.fleet.forget(cid)

    # -- the aggregator tree ---------------------------------------------------

    def _decode_partial(self, msg: PartialAggregate, where: str) -> bool:
        """Restore a codec'd partial to float32 sums and a plain member
        list in place; False (counted ``partial_codec_errors``) when it
        cannot be, e.g. a delta against a base this root does not hold:
        the fallback machinery, not a silently wrong fold, owns that
        group's fate."""
        if not (msg.codec or msg.members_z):
            return True
        from split_learning_torch.runtime.codec.partial import (
            PartialCodecError, decode_partial_msg,
        )
        try:
            decode_partial_msg(msg, bases=self._partial_bases,
                               base_gen=self._partial_base_gen)
        except PartialCodecError as e:
            self.faults.inc("partial_codec_errors")
            self.log.warning(f"{where}: undecodable partial from "
                             f"{msg.aggregator_id} ({e}); dropped")
            return False
        return True

    def _book_members(self, msg: PartialAggregate) -> None:
        """A weight-less Update record for each client behind a partial:
        they count for the UPDATE barrier one by one.  ``num_samples``
        0: the group's stage-1 samples rode the partial's
        ``n_samples``."""
        for m in msg.members or []:
            cid = m.get("client_id")
            if cid is not None:
                self._updates.append(Update(
                    client_id=cid, stage=int(m.get("stage", msg.stage)),
                    cluster=msg.cluster, params=None, num_samples=0,
                    ok=bool(m.get("ok", True)), round_idx=msg.round_idx))

    def _fold_partial(self, msg: PartialAggregate, nbytes: int = 0) -> None:
        """Fold one PartialAggregate at its group's canonical position in
        the root fold and book its members."""
        if self._fold is None:
            self.log.warning(
                f"PARTIALAGGREGATE {msg.aggregator_id} outside a "
                "streaming invocation (dropped)")
            return
        self._agg_ingress_bytes += int(nbytes)
        if not self._decode_partial(msg, "PARTIALAGGREGATE"):
            return
        # generation-fenced by the pump; tree members are never
        # stale-admitted
        self._fold.add_partial(
            msg.stage, agg_plane.group_key(msg.group), msg.sums,
            msg.weight, msg.dtypes, stat_sums=msg.stat_sums,
            stat_weight=msg.stat_weight, stat_dtypes=msg.stat_dtypes,
            n_samples=msg.n_samples)
        _note_members(self.fleet, msg.members)
        self._book_members(msg)
        self.log.received(
            f"PARTIALAGGREGATE {msg.aggregator_id} "
            f"members={len(msg.members or [])} weight={msg.weight:g}")

    def _spawn_l1_threads(self, plan: ClusterPlan, groups: list,
                          narrowed: dict) -> None:
        """One L1Aggregator thread a group, at every level.  Over TCP each
        gets its own transport stack (a blocked get holds a connection's
        socket); in one process they share the server's bus."""
        deadline = time.monotonic() + self.client_timeout
        for g in groups:
            agg_id = f"aggregator_{plan.cluster_id}_{g.idx}"
            bus, owns = self.bus, False
            if self.cfg.transport.kind == "tcp":
                from split_learning_torch.runtime.chaos import (
                    make_runtime_transport,
                )
                bus = make_runtime_transport(self.cfg, agg_id,
                                             faults=self.faults)
                owns = True
            out_q = (RPC_QUEUE if g.parent is None
                     else agg_plane.aggregate_queue(plan.cluster_id,
                                                    g.parent))
            t = agg_plane.L1Aggregator(
                bus, cluster=plan.cluster_id, group=g,
                members=narrowed[g.idx], gen=self._cur_gen,
                deadline=deadline, log=self.log, faults=self.faults,
                chunk_bytes=self.cfg.transport.chunk_mb << 20,
                owns_bus=owns, out_queue=out_q, codec=self._partial_codec,
                base=self._partial_bases.get(g.stage),
                base_gen=self._partial_base_gen)
            t.start()
            self._l1.append(t)

    #: liveness grace of a fallback drain: a dead aggregator may have
    #: consumed a member's UPDATE frames, which that member never resends.
    #: The clock restarts on every recovered frame, so only a drained and
    #: silent queue abandons its missing members.
    L1_FALLBACK_GRACE_S = 30.0

    def _poll_l1(self) -> None:
        """The tree's health check, run at every UPDATE-barrier pump: an
        aggregator thread that is no longer alive (and never flushed)
        degrades its group to the direct-to-root drain, so the group
        still folds at its canonical position."""
        for t in self._l1:
            if t.flushed:
                continue
            fb = self._l1_fallback.get(t.group.idx)
            if fb is None:
                if t.is_alive():
                    continue
                self.faults.inc("agg_l1_fallbacks")
                self.log.warning(
                    f"aggregator {t.agg_id} died mid-round; draining "
                    f"group {t.group.idx} direct-to-root")
                fb = self._start_fallback(t.group, t.cluster,
                                          set(t.members))
            self._step_fallback(fb)

    def _start_fallback(self, group, cluster: int, members: set) -> dict:
        fb = self._l1_fallback[group.idx] = {
            "group": group, "cluster": cluster, "members": set(members),
            "fold": agg_plane.StreamingFold(
                {group.stage: sorted(members)}, faults=self.faults),
            "asm": FrameAssembler(faults=self.faults),
            "seen": set(), "meta": [],
            # a parentless group books its members and sums straight
            # into the root fold; one under an interior parent publishes
            # a substitute partial into the parent's queue instead (the
            # parent's dedup absorbs the race where the aggregator had
            # flushed before it was declared dead): booking both ways
            # would count the members twice
            "book_direct": group.parent is None,
            "deadline": time.monotonic() + self.L1_FALLBACK_GRACE_S,
            "flushed": False}
        return fb

    def _children_draining(self, group) -> bool:
        """True while a child group of ``group`` has an unflushed
        fallback of its own: its drain will publish a substitute partial
        into this group's queue, so closing this group now would strand
        members the child is recovering."""
        if group.level == 1:
            return False
        return any(f["group"].parent == group.idx and not f["flushed"]
                   for f in self._l1_fallback.values())

    def _step_fallback(self, fb: dict) -> None:
        if not fb["flushed"]:
            self._drain_fallback(fb)
        if not fb["flushed"] and time.monotonic() >= fb["deadline"]:
            if self._children_draining(fb["group"]):
                fb["deadline"] = (time.monotonic()
                                  + self.L1_FALLBACK_GRACE_S)
                return
            gone_keys = fb["members"] - fb["seen"]
            gone = self._member_clients(fb["group"], gone_keys)
            if gone:
                self.faults.inc("agg_fallback_abandons", len(gone))
            if gone_keys:
                self.log.warning(
                    f"fallback group {fb['group'].idx}: abandoning "
                    f"{sorted(gone_keys)} (the dead aggregator consumed "
                    f"their frames; folding {len(fb['seen'])}/"
                    f"{len(fb['members'])} members)")
            self._agg_gone |= gone
            self._flush_fallback(fb)

    def _member_clients(self, group, keys) -> set:
        """The client ids behind a set of member keys: the keys
        themselves at level 1, the responsive clients of the named child
        groups above it."""
        if group.level == 1:
            return set(keys)
        out: set = set()
        by_key = {g.key: g for g in self._tree_groups.values()}
        for key in keys:
            child = by_key.get(key)
            if child is not None:
                out |= self._member_clients(
                    child, self._tree_narrowed.get(child.idx,
                                                   child.members))
        return out

    def _drain_fallback(self, fb: dict) -> None:
        g = fb["group"]
        for m in agg_plane.drain_group_queue(
                self.bus, fb["cluster"], g.idx, self._cur_gen, fb["asm"],
                self.faults, log=self.log):
            if isinstance(m, Update):
                self._drain_fallback_update(fb, g, m)
            else:
                self._drain_fallback_partial(fb, g, m)
        if not fb["flushed"] and fb["seen"] >= fb["members"]:
            self._flush_fallback(fb)

    def _drain_fallback_update(self, fb: dict, g, u: Update) -> None:
        if g.level != 1 or u.client_id in fb["seen"]:
            self.faults.inc("agg_dup_drops")
            return
        fb["seen"].add(u.client_id)
        fb["deadline"] = time.monotonic() + self.L1_FALLBACK_GRACE_S
        self._fold_update(u)   # a delta rebuilt, as the pump does
        # drain_group_queue generation-fenced it already
        fb["fold"].add_update(copy.copy(u))
        fb["meta"].append({"client_id": u.client_id, "stage": u.stage,
                           "num_samples": u.num_samples, "ok": u.ok,
                           "telemetry": u.telemetry})
        u.params = None
        u.batch_stats = None
        # (the drain's methods also run bound alone to a context that has
        # no telemetry plane)
        _note_members(getattr(self, "fleet", None), fb["meta"][-1:])
        if fb["book_direct"]:
            self._updates.append(u)
        self.log.received(f"UPDATE {u.client_id} (fallback drain)")

    def _drain_fallback_partial(self, fb: dict, g,
                                m: PartialAggregate) -> None:
        """A dead interior group's queue holds its children's partials:
        folded into the fallback's own fold, keyed and dedup'd as the
        dead aggregator would have."""
        key = agg_plane.group_key(m.group)
        if g.level == 1 or key in fb["seen"]:
            self.faults.inc("agg_dup_drops")
            return
        if not self._decode_partial(m, "fallback drain"):
            return
        fb["seen"].add(key)
        fb["deadline"] = time.monotonic() + self.L1_FALLBACK_GRACE_S
        fb["fold"].add_partial(
            m.stage, key, m.sums, m.weight, m.dtypes,
            stat_sums=m.stat_sums, stat_weight=m.stat_weight,
            stat_dtypes=m.stat_dtypes, n_samples=m.n_samples)
        fb["meta"].extend(m.members or [])
        _note_members(getattr(self, "fleet", None), m.members)
        if fb["book_direct"]:
            self._book_members(m)
        self.log.received(
            f"PARTIALAGGREGATE {m.aggregator_id} (fallback drain)")

    def _flush_fallback(self, fb: dict) -> None:
        """Close a fallback group: its fold's partial sums land where the
        dead aggregator's would have: in the root fold at the group's
        canonical position when parentless, else as a substitute (raw
        float32) partial in the parent's queue."""
        g = fb["group"]
        stages, n = fb["fold"].partial()
        ent = stages.get(g.stage)
        if fb["book_direct"]:
            if ent:
                self._fold.add_partial(
                    g.stage, g.key, ent["sums"], ent["weight"],
                    ent["dtypes"], stat_sums=ent["stat_sums"],
                    stat_weight=ent["stat_weight"],
                    stat_dtypes=ent["stat_dtypes"], n_samples=n)
            else:
                self._fold.drop(g.stage, g.key)
        else:
            ent = ent or {}
            msg = PartialAggregate(
                aggregator_id=f"aggregator_{fb['cluster']}_{g.idx}",
                cluster=fb["cluster"], group=g.idx, stage=g.stage,
                round_idx=self._cur_gen, sums=ent.get("sums"),
                weight=float(ent.get("weight") or 0.0),
                dtypes=ent.get("dtypes"), stat_sums=ent.get("stat_sums"),
                stat_weight=float(ent.get("stat_weight") or 0.0),
                stat_dtypes=ent.get("stat_dtypes"), n_samples=n,
                members=fb["meta"], level=g.level)
            q = agg_plane.aggregate_queue(fb["cluster"], g.parent)
            for part in encode_parts(msg, self.cfg.transport.chunk_mb << 20):
                self.bus.publish(q, part)
            self.log.sent(f"PARTIALAGGREGATE (fallback substitute for "
                          f"group {g.idx} -> group {g.parent})")
        fb["flushed"] = True

    def _finish_l1(self) -> None:
        """After the UPDATE barrier, level by level upwards: live
        unflushed aggregators are told to flush (the server gave up on
        their stragglers), so an interior group still folds what the
        level below just produced; dead ones fall back to the drain;
        then every root partial is awaited and every fallback closed.
        Bounded: an aggregator that neither flushes nor dies within the
        deadlines is abandoned (its group key drops out at finish)."""
        for lv in sorted({t.group.level for t in self._l1}):
            level_ts = [t for t in self._l1 if t.group.level == lv]
            for t in level_ts:
                if t.is_alive() and not t.flushed:
                    t.request_flush()

            def lv_done(ts=level_ts) -> bool:
                self._poll_l1()
                return all(t.flushed or self._l1_fallback.get(
                    t.group.idx, {}).get("flushed") for t in ts)
            deadline = time.monotonic() + 15.0
            while not lv_done() and time.monotonic() < deadline:
                self._pump_one(timeout=0.05)
        want = [(g.stage, g.key) for g in self._tree_roots]

        def landed() -> bool:
            self._poll_l1()
            return all(self._fold.has_key(s, k) for s, k in want)
        if not landed():
            self._pump_until(landed, "aggregator flushes",
                             deadline=time.monotonic() + 30.0)
        # forced close, level by level upwards: a child's flush publishes
        # its substitute into the parent's queue, so the parent (drained
        # right after) still folds it
        for fb in sorted(self._l1_fallback.values(),
                         key=lambda f: (f["group"].level,
                                        f["group"].idx)):
            if not fb["flushed"]:
                self._flush_fallback(fb)
            parent = self._l1_fallback.get(fb["group"].parent)
            if parent is not None and not parent["flushed"]:
                self._drain_fallback(parent)
        for t in self._l1:
            t.join(timeout=5.0)

    #: wall-clock cadence of the barriers' liveness check (an advance of
    #: the whole fleet: O(clients), so not once a frame)
    _WAIT_CHECK_S = 0.1

    def _pump_until(self, pred: Callable[[], bool],
                    what: str | Callable[[], str],
                    deadline: float | None = None,
                    waiting: Callable[[], set] | None = None,
                    poll: Callable[[], None] | None = None) -> bool:
        """Drain rpc_queue until ``pred()``; False if the deadline
        passes (``what`` may be a callable naming who is missing AT the
        deadline).  ``poll`` runs before each check (the aggregator
        tree's health check and fallback drains).

        ``waiting`` (by default the enclosing :meth:`_barrier`'s) names
        the clients the barrier still needs: once every one of them is
        the fleet monitor's ``lost`` (silent for
        ``observability.liveness-timeout``), the wait gives up at once,
        counting ``fleet_lost_drops`` — a dead client costs the round
        the liveness timeout, not the whole deadline.  A slow but live
        client is never dropped."""
        deadline = (time.monotonic() + self.client_timeout
                    if deadline is None else deadline)
        waiting = waiting if waiting is not None else self._waiting
        t_checked = 0.0
        while True:
            if poll is not None:
                poll()
            if pred():
                return True
            now = time.monotonic()
            remain = deadline - now
            if remain <= 0:
                w = what() if callable(what) else what
                self.faults.inc("timeouts")
                self.log.warning(f"timeout waiting for {w}")
                return False
            if (waiting is not None and self.fleet is not None
                    and now - t_checked >= self._WAIT_CHECK_S):
                t_checked = now
                lost = self.fleet.advance()
                missing = set(waiting())
                if missing and missing <= lost:
                    self.faults.inc("fleet_lost_drops", len(missing))
                    self.log.warning(
                        f"dropping lost client(s) {sorted(missing)}: no "
                        f"heartbeat within {self.fleet.liveness_timeout:g}"
                        "s — barrier released early")
                    return False
            self._pump_one(timeout=min(remain, 0.25))

    @contextlib.contextmanager
    def _barrier(self, name: str, round_idx: int,
                 waiting: Callable[[], set]):
        """One round barrier: its span, and the clients it still needs
        (``waiting``) for the liveness check of every :meth:`_pump_until`
        inside it."""
        prev, self._waiting = self._waiting, waiting
        try:
            with self.tracer.span(name, round=round_idx):
                yield
        finally:
            self._waiting = prev

    # -- registration barrier ------------------------------------------------

    @property
    def registrations(self) -> list[Registration]:
        return list(self._registrations.values())

    def wait_for_registrations(self) -> list[Registration]:
        """Block until every configured client has registered
        (``src/Server.py:111-135``)."""
        total = sum(self.cfg.clients)
        self._pump_until(lambda: len(self._registrations) >= total,
                         f"{total} registrations")
        if len(self._registrations) < total:
            raise RoundTimeout(
                f"registrations incomplete within {self.client_timeout}s:"
                f" {len(self._registrations)} of {total}")
        return self.registrations

    # -- one round -----------------------------------------------------------

    def _data_plane(self, plan: ClusterPlan, stage1: list,
                    sync_all_later_stages: bool) -> tuple:
        """The round's forward routing and SDA window: ``(pair_of,
        pair_groups, sda, sda_route)``.

        * 2LS's fixed 1:1 edge<->head pairing
          (``other/2LS/src/train/VGG16.py:23``): with ``in-clusters`` > 1,
          a two-stage plan and exactly one head per in-cluster, each
          in-cluster's feeders and its head share the queue
          ``..._p{group}`` (``pair_of``: client -> group); otherwise the
          shared queue's natural load balance stays.
        * The SDA window (``sda``): ``aggregation.sda-size`` under SDA,
          never wider than the feeders a head hears (a wider window could
          never gather distinct origins), else 1.
        * DCSL's per-device scatter (``other/DCSL/src/Scheduler.py:21-26,
          :110-133``): with a window wider than one batch and no pairing,
          every later-stage client consumes its own queue ``..._p{id}``
          and the previous stage scatters batches over them
          (``sda_route``).  ``pair_groups`` is the pairing alone, before
          those per-device entries: the strict head's feeder sets follow
          it."""
        pair_of: dict = {}
        n_in = self.cfg.topology.in_clusters
        if n_in > 1 and plan.n_stages == 2:
            groups = client_groups(len(stage1), min(n_in, len(stage1)))
            heads = plan.clients[1]
            if len(heads) == len(groups):
                for g, idxs in enumerate(groups):
                    for i in idxs:
                        pair_of[stage1[i]] = g
                    pair_of[heads[g]] = g
            else:
                self.log.warning(
                    f"in_clusters={n_in} but {len(heads)} heads for "
                    f"{len(groups)} in-groups: keeping shared queues")
        if pair_of:
            n_feeders = min(Counter(pair_of[c] for c in stage1).values())
        else:
            n_feeders = len(stage1) if plan.n_stages >= 2 else 1
        sda = (min(self.cfg.aggregation.sda_size, n_feeders)
               if sync_all_later_stages else 1)
        pair_groups = dict(pair_of)
        sda_route = sda > 1 and not pair_of
        if sda_route:
            for s in range(2, plan.n_stages + 1):
                for cid in plan.clients[s - 1]:
                    pair_of[cid] = cid
        return pair_of, pair_groups, sda, sda_route

    @staticmethod
    def _feeders(stage1: list, pair_groups: dict, cid: str) -> list:
        """The stage-1 clients whose batches reach ``cid`` (its 2LS pair
        group's, or every one)."""
        return [c for c in stage1
                if not pair_groups or pair_groups.get(c)
                == pair_groups.get(cid)]

    def train_cluster(self, plan: ClusterPlan, params, stats, *,
                      round_idx: int = 0, epochs: int = 1,
                      client_subset: list | None = None,
                      per_client_params: dict | None = None,
                      lr: float | None = None,
                      sync_all_later_stages: bool = False,
                      send_params: bool | dict = True,
                      send_weights: bool | dict = True) -> list[Update]:
        """One remote round for one cluster: the plan's stage-1 clients
        (those in ``client_subset`` when it is given: the relay
        strategy's one-at-a-time cycles) and every later-stage client.

        FLEX's wire economy (``other/FLEX/src/Server.py:140-143``):
        ``send_params`` False (a bool, or ``{stage: bool}``) sends a START
        without weights, and the client keeps its shard, optimizer state
        and data loader; ``per_client_params`` gives a client its own
        tree; ``send_weights`` (same shape) rides the PAUSE, so the
        clients of a non-aggregation round reply UPDATE with sample
        counts and no weights.  ``sync_all_later_stages`` (SDA) and
        ``topology.in-clusters`` set the data plane
        (:meth:`_data_plane`); the strict-SDA fence quorum and feeder
        sets go out with START and again, recomputed from the clients
        that answered the READY barrier, with SYN."""
        stage1 = [c for c in plan.stage1_clients
                  if client_subset is None or c in client_subset]
        if not stage1:
            return []
        active = [(cid, 1) for cid in stage1]
        for s in range(2, plan.n_stages + 1):
            active += [(cid, s) for cid in plan.clients[s - 1]]
        stage_of = dict(active)
        ranges = stage_ranges(len(self.specs), plan.cuts)
        learning = dataclasses.asdict(self.cfg.learning)
        if lr is not None:
            learning["learning_rate"] = lr
        pair_of, pair_groups, sda, sda_route = self._data_plane(
            plan, stage1, sync_all_later_stages)
        self._ready.clear()
        self._notified.clear()
        self._updates = []
        self._gen += 1
        self._cur_gen = self._gen
        self._syn_live = False
        # async: the generation is the global model version — the dedup
        # ledger is pruned past the admission window
        self._folded_versions = {
            (c, v) for c, v in self._folded_versions
            if self._cur_gen - v <= self.cfg.learning.max_staleness + 1}
        if self._async and self.fleet is not None:
            # where "now" is for version-lag scoring (async only: in sync
            # mode the generation counts invocations, not versions)
            self.fleet.note_version(self._cur_gen)

        # streaming fold for this invocation, in canonical per-stage key
        # order: sorted client ids, or the root groups' keys when the
        # aggregator tree (aggregation.fan-in) is interposed.  Built
        # BEFORE the START fan-out so the first UPDATE to land has
        # somewhere to fold
        groups = None
        self._group_of = {}
        self._l1 = []
        self._l1_fallback = {}
        self._tree_groups = {}
        self._tree_roots = []
        self._tree_narrowed = {}
        self._agg_gone = set()
        self._agg_ingress_bytes = 0
        if self._streaming:
            fan_in = self._agg.fan_in
            expected: dict[int, list] = {}
            if fan_in and len(active) > fan_in:
                groups = agg_plane.plan_tree(active, fan_in,
                                             self._agg.levels)
                self._tree_groups = {g.idx: g for g in groups}
                self._tree_roots = agg_plane.root_groups(groups)
                self._group_of = {cid: g for g in groups
                                  if g.level == 1 for cid in g.members}
                for g in self._tree_roots:
                    expected.setdefault(g.stage, []).append(g.key)
            else:
                for cid, s in sorted(active):
                    expected.setdefault(s, []).append(cid)
            self._fold = agg_plane.StreamingFold(
                expected, backend=self._fold_backend, faults=self.faults,
                hists=self.hists)
            # the partial codec's delta mode: this generation's per-stage
            # START shards, against which the tree encodes (group mean -
            # base) and every receiver adds the base back
            self._partial_bases = {}
            self._partial_base_gen = None
            if groups is not None and self._partial_codec is not None \
                    and self._partial_codec.kind == "delta":
                for s in range(1, plan.n_stages + 1):
                    a, b = ranges[s - 1]
                    self._partial_bases[s] = _np_tree(
                        shard_params(params, self.specs, a, b))
                self._partial_base_gen = self._cur_gen

        # round-phase spans: sequential on the server thread, under the
        # round loop's "train" span, so the critical-path walk crosses
        # from here into the clients' timelines at the consume spans
        # recorded inside each barrier
        fanout_span = self.tracer.start("start_fanout", round=round_idx,
                                        cluster=plan.cluster_id)
        # stage-ascending START fan-out: stage-1 feeders start streaming
        # while later stages' STARTs are still encoding.  Shard trees of
        # the shared base are cut once per layer range; a big shard
        # frame is published as crc'd SLTC chunks
        fanout_t0 = time.perf_counter()
        shard_cache: dict = {}
        for cid, s in active:
            a, b = ranges[s - 1]
            sp = _stage_flag(send_params, s)
            if cid in self._needs_params:
                # a broken delta chain: a weight-less START would leave
                # the client without a base the shadow knows
                sp = True
                self._needs_params.discard(cid)
            if sp:
                base = (per_client_params or {}).get(cid, params)
                key = (a, b) if base is params else None
                shard = shard_cache.get(key)
                if shard is None:
                    shard = tuple(
                        _np_tree(shard_params(tree, self.specs, a, b))
                        for tree in (base, stats or {}))
                    if key is not None:
                        shard_cache[key] = shard
            else:
                shard = (None, None)
            # delta codec: a versioned shadow of exactly what this START
            # carries, and the version held advertised (a weight-less
            # START advertises the standing shadow).  A tree member gets
            # none: its aggregator holds no shadow to rebuild a delta
            # against, so tree rounds send full frames (and the standing
            # shadow, which could never be used again, is dropped)
            delta_ver = None
            group = self._group_of.get(cid)
            if self._delta_shadow is not None:
                if group is not None:
                    self._delta_shadow.clear(cid)
                elif sp:
                    self._delta_shadow.note_sent(cid, self._cur_gen,
                                                 shard[0])
                    delta_ver = self._cur_gen
                else:
                    delta_ver = self._delta_shadow.version_for(cid)
            label_counts = None
            if s == 1:
                label_counts = np.asarray(
                    plan.label_counts[plan.stage1_clients.index(cid)])
            end_layer = -1 if s == plan.n_stages else b
            for part in encode_parts(Start(
                    start_layer=a, end_layer=end_layer,
                    cluster=plan.cluster_id, params=shard[0],
                    batch_stats=shard[1], learning=learning,
                    label_counts=label_counts, round_idx=round_idx,
                    extra={"epochs": epochs, "sda_size": sda,
                           "sda_strict": self._agg.sda_strict,
                           # copies of each (feeder, epoch) fence to
                           # collect before acting on it: one from each
                           # previous-stage client (stage 2 hears the
                           # feeders directly)
                           "sda_fence_quorum": (
                               1 if s <= 2
                               else max(1, len(plan.clients[s - 2]))),
                           # a consumer's full feeder set: the strict
                           # head drains leftovers only once every one
                           # has fenced its epochs
                           "sda_feeders": (
                               None if s == 1
                               else self._feeders(stage1, pair_groups, cid)),
                           "n_stages": plan.n_stages,
                           "pair": pair_of.get(cid),
                           "sda_peers": (list(plan.clients[s])
                                         if sda_route and s < plan.n_stages
                                         else None),
                           "refresh": self.cfg.distribution.refresh,
                           # clients adopt the server's run-scoped trace
                           # id, so every journal merges onto one trace
                           "trace_id": self.tracer.trace_id,
                           "delta_base_version": delta_ver,
                           # aggregator tree: UPDATE to this group's
                           # aggregate queue instead of rpc_queue
                           "agg_group": (None if group is None
                                         else group.idx),
                           "gen": self._cur_gen}),
                    self.cfg.transport.chunk_mb << 20):
                self.bus.publish(reply_queue(cid), part)
            self.log.sent(f"START -> {cid} layers=[{a}, {end_layer}]"
                          + ("" if shard[0] is not None
                             else " (no weights)"))
        del shard_cache
        fanout_span.end()
        # wall of each phase of the round, read at the barriers
        phases = {"fanout_s": time.perf_counter() - fanout_t0}
        t_phase = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal t_phase
            now = time.perf_counter()
            phases[name] = now - t_phase
            t_phase = now

        ids = {cid for cid, _ in active}
        with self._barrier("ready_wait", round_idx,
                           lambda: ids - self._ready):
            ready_ok = self._pump_until(
                lambda: ids <= self._ready,
                lambda: f"READY from {ids - self._ready}",
                deadline=time.monotonic() + self.ready_timeout)
        if not ready_ok:
            ids &= self._ready   # drop unresponsive clients mid-round
        if self._fold is not None and groups is None:
            # stop the reorder window waiting for clients dropped at the
            # READY barrier
            for cid, s in active:
                if cid not in ids:
                    self._fold.drop(s, cid)
        if groups is not None:
            # the tree's aggregators start now, with level-1 membership
            # narrowed to the responsive clients (one dropped at READY
            # never publishes; its aggregator must not hold the group's
            # flush for it).  Interior groups keep every child key: child
            # aggregators always publish, an empty group at once
            narrowed = {g.idx: ([m for m in g.members if m in ids]
                                if g.level == 1 else list(g.members))
                        for g in groups}
            self._tree_narrowed = narrowed
            self._spawn_l1_threads(plan, groups, narrowed)
            # the tree's shape for /fleet, so that a slow group is named
            self._agg_topology = {
                "fan_in": self._agg.fan_in, "levels": self._agg.levels,
                "remote": False, "gen": self._cur_gen,
                "groups": [{"idx": g.idx, "stage": g.stage,
                            "level": g.level, "parent": g.parent,
                            "members": len(narrowed[g.idx]), "node": None}
                           for g in groups]}
            self.log.info(
                f"aggregator tree: {len(groups)} group(s), fan-in "
                f"{self._agg.fan_in}, levels {self._agg.levels} "
                "(threads)", "cyan")
        lap("ready_s")   # clients decode their START and build shards
        # strict SDA under client loss: a previous-stage client dropped
        # at the READY barrier never sends its fence copies, and a
        # dropped feeder never fences, so the quorum and the feeder sets
        # are recomputed from the clients that answered and ride SYN.
        # Kept for every active client: a late READY's SYN reuses them
        syn_span = self.tracer.start("syn_fanout", round=round_idx)
        live_s1 = [c for c in stage1 if c in ids]
        self._syn_overrides = {}
        for cid, s in active:
            quorum = (1 if s <= 2 else
                      max(1, sum(c in ids for c in plan.clients[s - 2])))
            feeders = (None if s == 1
                       else self._feeders(live_s1, pair_groups, cid))
            self._syn_overrides[cid] = (quorum, feeders)
        for cid in sorted(ids):
            quorum, feeders = self._syn_overrides[cid]
            self.bus.publish(reply_queue(cid), encode(Syn(
                round_idx, sda_fence_quorum=quorum, sda_feeders=feeders)))
        self.log.sent(f"SYN -> {sorted(ids)}")
        syn_span.end()
        # async: the SYN window stays open for a straggler's late READY
        self._syn_live = self._async
        self._syn_round = round_idx

        s1_ids = set(stage1) & ids
        quorum_n = self.cfg.learning.async_quorum if self._async else 0
        with self._barrier("notify_wait", round_idx,
                           lambda: s1_ids - self._notified):
            if quorum_n:
                # async quorum: the round moves on once enough feeders
                # have dispatched their data; a slow one folds late
                s1_need = min(len(s1_ids), quorum_n)
                self._pump_until(
                    lambda: len(self._notified & s1_ids) >= s1_need,
                    f"NOTIFY quorum {s1_need}/{len(s1_ids)}")
            else:
                self._pump_until(lambda: s1_ids <= self._notified,
                                 "NOTIFY from stage-1 clients")
        lap("train_s")   # SYN -> the last stage-1 NOTIFY
        pause_span = self.tracer.start("pause_fanout", round=round_idx)
        # late-READY joiners (async) get their PAUSE too: they are
        # training and upload like everyone else
        pause_ids = ids | (self._ready & set(stage_of))
        for cid in sorted(pause_ids):
            self.bus.publish(reply_queue(cid), encode(Pause(
                send_weights=_stage_flag(send_weights, stage_of[cid]))))
        self.log.sent(f"PAUSE -> {sorted(pause_ids)}")
        pause_span.end()

        def fresh_ids() -> set:
            # the current version's contributions only: an async
            # straggler's stale-admitted Update also rides the list
            return {u.client_id for u in self._updates
                    if (u.version if u.version is not None
                        else u.round_idx) == self._cur_gen}
        # _agg_gone: members whose UPDATE a dead aggregator consumed;
        # they can never arrive, so the barrier stops counting them
        # (the tree's health check runs at each pump, when a tree runs)
        tree = {"poll": self._poll_l1} if self._l1 else {}
        with self._barrier("update_wait", round_idx,
                           lambda: ids - fresh_ids() - self._agg_gone):
            if quorum_n:
                # bounded-staleness version cut at async-quorum fresh
                # contributions
                need = min(quorum_n, len(ids))
                self._pump_until(
                    lambda: len(fresh_ids() & ids) >= need,
                    lambda: (f"UPDATE quorum {need}/{len(ids)} (missing "
                             f"{sorted(ids - fresh_ids())})"))
            else:
                self._pump_until(
                    lambda: (fresh_ids() | self._agg_gone) >= ids,
                    lambda: "UPDATE from " + str(
                        ids - fresh_ids() - self._agg_gone), **tree)
        self._syn_live = False
        if self._l1:
            self._finish_l1()
        lap("upload_s")   # PAUSE -> every UPDATE decoded and folded
        updates = list(self._updates)
        self._updates = []
        if self._fold is not None:
            # the overlapped fold already consumed every tree; what is
            # left is the per-stage divide + optimizer step + cast
            fold, self._fold = self._fold, None
            m = float(self._agg.server_momentum)
            # the span carries the overlapped fold's wall; each stage's
            # completion is marked on it
            with self.tracer.span(
                    "aggregate", round=round_idx, cluster=plan.cluster_id,
                    overlapped_fold_s=round(fold.fold_s, 6)):
                result = fold.finish(
                    base=params if m else None, momentum=m,
                    velocity=(self._agg_velocity.setdefault(
                        plan.cluster_id, {}) if m else None),
                    fused=self._agg.update_sharded,
                    on_stage=lambda s, p, st: self.tracer.record(
                        "update_stage", time.time(), time.time(),
                        round=round_idx, stage=s))
            result.params = _torch_tree(result.params, self.device)
            result.stats = _torch_tree(result.stats, self.device)
            self.last_fold = result
            lap("update_s")
            updates = agg_plane.UpdateBatch(updates)
            updates.fold = result
            self.log.metric(
                kind="agg", gen=self._cur_gen, round_idx=round_idx,
                cluster=plan.cluster_id, backend=self._fold_backend.name,
                fan_in=(self._agg.fan_in if groups is not None else 0),
                levels=(self._agg.levels if groups is not None else 0),
                # rpc-wire bytes of the partials that landed at the root
                root_ingress_bytes=self._agg_ingress_bytes,
                partial_codec=(None if self._partial_codec is None
                               else self._partial_codec.kind),
                fold_s=result.fold_s, folded=result.folded,
                partials=result.partials, window_hwm=result.window_hwm,
                peak_tree_copies=result.peak_tree_copies,
                n_samples=result.n_samples, update_s=result.update_s,
                stage_update_ms=result.stage_update_ms)
            self.log.info(
                f"streamed aggregate: folded={result.folded} "
                f"(partials={result.partials}) fold={result.fold_s:.3f}s "
                f"update={result.update_s:.3f}s", "cyan")
            self._l1 = []
            self._l1_fallback = {}
        # wire audit: CUMULATIVE transport-wide publish bytes by queue
        # family (reply = server down; rpc = clients up; data = the
        # intermediate and gradient plane); on the shared in-process bus
        # this covers every participant
        totals = {"reply": 0, "rpc": 0, "data": 0}
        for q, n in self.bus.bytes_out_snapshot().items():
            family = queue_family(q)
            totals[family if family in ("reply", "rpc") else "data"] += n
        # and, on the async sender, the seconds the server waited for
        # room in its send queue and the sender spent on the socket
        sender = {f"cumulative_{k}": getattr(self.bus, k) for k in (
            "publish_wait_s", "send_s") if hasattr(self.bus, k)}
        # this process's wire counters ride the same record: bytes in
        # and out by plane, encode and decode seconds, the sender's
        # high-water mark
        wsnap = {k: v for k, v in self.wire.snapshot().items() if v}
        self.log.metric(kind="wire", gen=self._cur_gen,
                        round_idx=round_idx, cluster=plan.cluster_id,
                        cumulative_reply_bytes=totals["reply"],
                        cumulative_rpc_bytes=totals["rpc"],
                        cumulative_data_bytes=totals["data"], **sender,
                        **wsnap)
        self.round_phases.append(phases)
        self.log.metric(kind="phases", gen=self._cur_gen,
                        round_idx=round_idx, cluster=plan.cluster_id,
                        **{k: round(v, 6) for k, v in phases.items()})
        # CUMULATIVE fault counters of this process's stack (on the
        # shared in-process bus: every participant's), so a chaos run is
        # audited, not silently repaired
        snap = {k: v for k, v in self.faults.snapshot().items() if v}
        if snap:
            if snap != self._fault_base:
                self._fault_base = snap
                self.log.info("round faults (cumulative): " + " ".join(
                    f"{k}={v}" for k, v in sorted(snap.items())),
                    "yellow")
            self.log.metric(kind="faults", gen=self._cur_gen,
                            round_idx=round_idx, cluster=plan.cluster_id,
                            **snap)
        # latency percentiles: this participant's histograms merged with
        # the process-wide transport clocks (queue wait, reliable
        # envelope RTT), cumulative like the counters above
        from split_learning_torch.runtime.trace import default_histograms
        hsnap = {**default_histograms.snapshot(), **self.hists.snapshot()}
        if hsnap and hsnap != self._hist_base:
            self._hist_base = hsnap
            self.log.metric(kind="latency", gen=self._cur_gen,
                            round_idx=round_idx, cluster=plan.cluster_id,
                            **hsnap)
        if self.fleet is not None:
            # fleet health at the invocation's end, after the beats still
            # queued: one kind=fleet record (states, rates, scores and the
            # counters each client's last beat carried) and a summary line
            while self._pump_one(timeout=0.0):
                pass
            self.fleet.advance()
            fsnap = self.fleet.snapshot()
            self.log.metric(kind="fleet", gen=self._cur_gen,
                            round_idx=round_idx, cluster=plan.cluster_id,
                            fleet=fsnap)
            unhealthy = {c: v["state"] for c, v in fsnap["clients"].items()
                         if v["state"] != "healthy"}
            line = "fleet: " + " ".join(
                f"{k}={n}" for k, n in fsnap["counts"].items() if n)
            if unhealthy:
                line += " (" + " ".join(
                    f"{c}:{v}" for c, v in sorted(unhealthy.items())) + ")"
            self.log.info(line, "yellow" if unhealthy else "cyan")
        # a finished invocation's spans are durable before the next one
        self.tracer.flush()
        return updates

    def stop_all(self, reason: str = "training complete"):
        for reg in self.registrations:
            self.bus.publish(reply_queue(reg.client_id),
                             encode(Stop(reason=reason)))
        self.log.sent(f"STOP -> all ({reason})")
        self._drain_after_stop()
        self.tracer.close()

    #: quiet seconds on rpc_queue that end the drain after STOP
    _STOP_QUIET_S = 0.25

    def _drain_after_stop(self) -> None:
        """Consume the heartbeats still in flight after STOP (a client
        stops beating when its STOP arrives), so that nothing the fleet
        sent is left queued on the broker: the drain ends after
        :data:`_STOP_QUIET_S` without a frame, or two heartbeat intervals
        and a second at most."""
        if self.fleet is None:
            return
        end = time.monotonic() + 2 * self.fleet.interval + 1.0
        try:
            while (time.monotonic() < end
                   and self._pump_one(timeout=self._STOP_QUIET_S)):
                pass
        except (QueueClosed, ConnectionError, OSError):
            pass   # the transport went first: nothing left to drain


class ProtocolServer:
    """Top-level server (reference ``server.py:20-30``) on ``device``
    (CUDA unless the CPU is asked for).  Without a transport from the
    caller it builds its configured stack (``runtime/chaos.py``
    ``make_runtime_transport``)."""

    def __init__(self, cfg: Config, transport: Transport | None = None,
                 logger: Logger | None = None,
                 client_timeout: float = 600.0,
                 ready_timeout: float | None = None, device=None):
        self.cfg = cfg
        # fail on a missing card before connecting to anything
        device = resolve_device(device)
        self.log = logger or Logger.for_run(cfg, "server", console=True)
        # a stack built here is closed (its sender flushed) by serve()
        self._own_bus = transport is None
        if transport is None:
            from split_learning_torch.runtime.chaos import (
                make_runtime_transport,
            )
            transport = make_runtime_transport(cfg, "server")
        transport.purge()   # queue hygiene at startup (src/Utils.py:8-32)
        self.ctx = ProtocolContext(cfg, transport, logger=self.log,
                                   client_timeout=client_timeout,
                                   ready_timeout=ready_timeout,
                                   device=device)
        self.exporter = None
        # over TCP, the broker shards' stats for /fleet and the broker_*
        # gauges: refreshed in a thread at most every broker.stats-interval
        # seconds, so a scrape never waits on a shard's connect
        self._broker_cache: dict = {"t": 0.0, "stats": None, "busy": False}
        if cfg.observability.http_port is not None:
            from split_learning_torch.runtime.telemetry import (
                TelemetryExporter,
            )
            self.exporter = TelemetryExporter(
                self._metrics_page, self._fleet_page,
                port=int(cfg.observability.http_port)).start()
            self.log.info("telemetry: serving /metrics and /fleet on "
                          f"{self.exporter.url}", "cyan")

    def _refresh_broker_stats(self) -> None:
        from split_learning_torch.runtime.bus import collect_broker_stats
        cache, cfg = self._broker_cache, self.cfg
        try:
            stats = collect_broker_stats(cfg.transport.host,
                                         cfg.transport.port,
                                         cfg.broker.shards)
            cache["stats"], cache["t"] = stats, time.monotonic()
            live = [st for st in stats if "error" not in st]
            g = self.ctx.gauges
            g.set("broker_shards_up", len(live))
            for gauge, key in (("broker_conns", "conns"),
                               ("broker_queues", "queues"),
                               ("broker_depth", "depth"),
                               ("broker_depth_hwm", "depth_hwm"),
                               ("broker_parked_gets", "parked_gets"),
                               ("broker_bytes_in", "bytes_in"),
                               ("broker_bytes_out", "bytes_out")):
                g.set(gauge, sum(st.get(key, 0) for st in live))
        finally:
            cache["busy"] = False

    def _broker_stats(self) -> list | None:
        """The cached shard stats (None off TCP); a stale cache starts a
        refresh in the background and serves the previous sweep."""
        cfg = self.cfg
        if cfg.transport.kind != "tcp" or cfg.broker.stats_interval <= 0:
            return None
        cache = self._broker_cache
        if (time.monotonic() - cache["t"] >= cfg.broker.stats_interval
                and not cache["busy"]):
            cache["busy"] = True
            threading.Thread(target=self._refresh_broker_stats,
                             daemon=True, name="broker-stats").start()
        return cache["stats"]

    def _metrics_page(self) -> str:
        """``/metrics``: the monitor advanced first, so that a scrape in
        the middle of a barrier sees current states."""
        from split_learning_torch.runtime.telemetry import render_prometheus
        ctx = self.ctx
        if ctx.fleet is not None:
            ctx.fleet.advance()
        self._broker_stats()   # refreshes the broker_* gauges
        return render_prometheus(
            fleet=ctx.fleet, faults=ctx.faults, wire=ctx.wire,
            hists=ctx.hists, gauges=ctx.gauges,
            max_client_series=self.cfg.observability.max_client_series)

    def _fleet_page(self, query: dict | None = None) -> dict:
        """``/fleet``: the monitor's snapshot (``?full=1``, ``?page=N``,
        ``?client=ID``; the ring-buffer series only while the tracked
        clients are within ``max-client-series`` or ``full`` asks), the
        aggregator tree's shape and, over TCP, the broker shards."""
        query, ctx = query or {}, self.ctx
        if ctx.fleet is None:
            snap = {"clients": {}, "counts": {}, "transitions": []}
        else:
            ctx.fleet.advance()
            full = str(query.get("full", "")) in ("1", "true", "yes")
            try:
                page = (None if query.get("page") is None
                        else int(query["page"]))
            except (TypeError, ValueError):
                page = None
            big = (ctx.fleet.tracked_clients()
                   > self.cfg.observability.max_client_series)
            snap = ctx.fleet.snapshot(series=full or not big, page=page,
                                      client=query.get("client"))
        if ctx._agg_topology is not None:
            snap["agg_tree"] = ctx._agg_topology
        brokers = self._broker_stats()
        if brokers is not None:
            snap["brokers"] = brokers
        return snap

    def serve(self, init_params: Any | None = None,
              init_stats: Any | None = None) -> TrainResult:
        """Registration barrier, planning, the round loop, STOP."""
        try:
            regs = self.ctx.wait_for_registrations()
            with self.ctx.tracer.span("plan"):
                plans = plan_clusters(self.cfg, regs)
            self.ctx.exclude([c for p in plans for c in p.rejected])
            try:
                return run_training(self.cfg, self.ctx, plans, self.log,
                                    init_params=init_params,
                                    init_stats=init_stats)
            finally:
                self.ctx.stop_all()
                self.ctx.shutdown()
                if self._own_bus:
                    self.ctx.bus.close()
        finally:
            if self.exporter is not None:
                self.exporter.close()


@dataclasses.dataclass
class InProcRun:
    server: ProtocolServer
    clients: list
    bus: InProcTransport
    result: TrainResult
    #: each participant's transport stack over ``bus`` (empty when the
    #: participants share ``bus`` itself)
    stacks: dict = dataclasses.field(default_factory=dict)
    #: the clients that a scripted crash ended
    crashed: list = dataclasses.field(default_factory=list)


def run_inproc(cfg: Config, device=None, client_timeout: float = 600.0,
               init_params: Any | None = None,
               logger: Logger | None = None,
               init_stats: Any | None = None,
               profiles: dict | None = None) -> InProcRun:
    """The whole protocol deployment in this process on ``device`` (CUDA
    unless the CPU is asked for): the server in the calling thread, one
    ``ProtocolClient`` thread per configured client (``client_{stage}_{i}``,
    registering ``profiles[client_id]`` when given), one shared
    :class:`InProcTransport`.

    With ``chaos.enabled`` or ``transport.reliable`` each participant
    speaks through its own stack over the shared bus, as
    ``make_runtime_transport`` builds it (the async sender, the reliable
    layer, chaos injection): fault state and dedup state are per
    participant, as they are per process.  A client that a scripted
    :class:`~split_learning_torch.runtime.chaos.ChaosCrash` ends stops
    its own stack and leaves the bus to the others (the round goes on
    without it).  A client that raises anything else closes the bus, so
    the server fails at once instead of waiting out a barrier; its error
    is raised here.  Every stack is stopped before this returns."""
    from split_learning_torch.runtime.chaos import (
        ChaosCrash, make_runtime_transport, stop_stack,
    )
    from split_learning_torch.runtime.client import ProtocolClient

    if cfg.transport.kind != "inproc":
        raise ValueError(
            f"run_inproc runs every participant over one in-process bus; "
            f"transport.kind is {cfg.transport.kind!r}: start the broker, "
            "server and clients as processes for it")
    bus = InProcTransport()
    layered = cfg.chaos.enabled or cfg.transport.reliable
    stacks: dict = {}

    def stack(name: str) -> Transport:
        if not layered:
            return bus
        stacks[name] = make_runtime_transport(cfg, name, bus=bus)
        return stacks[name]

    ids = [(f"client_{s}_{i}", s) for s, n in enumerate(cfg.clients, 1)
           for i in range(n)]
    try:
        server = ProtocolServer(cfg, stack("server"), logger=logger,
                                client_timeout=client_timeout,
                                device=device)
        clients = [ProtocolClient(cfg, cid, s, stack(cid),
                                  profile=(profiles or {}).get(cid),
                                  device=device) for cid, s in ids]
    except BaseException:
        for t in stacks.values():
            stop_stack(t, close_inner=False)
        raise
    errors: list = []
    crashed: list = []

    def run(client):
        try:
            client.run()
        except ChaosCrash:
            # the participant died; the network lives on
            crashed.append(client.client_id)
            stop_stack(client.bus, close_inner=False)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append((client.client_id, e))
            bus.close()

    threads = [threading.Thread(target=run, args=(c,), daemon=True,
                                name=c.client_id) for c in clients]
    for t in threads:
        t.start()
    try:
        try:
            result = server.serve(init_params=init_params,
                                  init_stats=init_stats)
        except QueueClosed as e:
            if errors:
                cid, err = errors[0]
                raise RuntimeError(f"protocol client {cid} failed") from err
            raise RuntimeError("the in-process bus closed") from e
        for t in threads:
            t.join(timeout=120)
            if t.is_alive():
                raise RuntimeError(f"protocol client {t.name} did not stop")
    finally:
        for name, t in stacks.items():
            if name not in crashed:
                stop_stack(t, close_inner=False)
    if errors:
        cid, err = errors[0]
        raise RuntimeError(f"protocol client {cid} failed") from err
    return InProcRun(server, clients, bus, result, stacks, crashed)
