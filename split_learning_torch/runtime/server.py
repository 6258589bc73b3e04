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

Left out (each raises ``NotImplementedError`` when its config asks for
it): the aggregator tree and remote aggregator nodes, stage hosts, the
scheduler, elastic re-planning, async mode and the delta shadow (its
codec raises in ``make_codecs``).  The telemetry exporter, liveness
monitor, blackbox and tracing spans are not run.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
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
from split_learning_torch.runtime.context import TorchContext
from split_learning_torch.runtime.log import Logger
from split_learning_torch.runtime.loop import TrainResult, run_training
from split_learning_torch.runtime.plan import (
    ClusterPlan, Registration, plan_clusters,
)
from split_learning_torch.runtime.protocol import (
    RPC_QUEUE, FrameAssembler, Notify, Pause, Ready, Register, Start, Stop,
    Syn, Update, encode, encode_parts, host_tensor, reply_queue,
)


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


def _refuse_unported(cfg: Config) -> None:
    agg, topo = cfg.aggregation, cfg.topology
    later = [
        (agg.fan_in, "aggregation.fan-in (the aggregator tree)"),
        (agg.remote, "aggregation.remote (aggregator nodes)"),
        (cfg.pipeline.remote, "pipeline.remote (stage hosts)"),
        (cfg.scheduler.enabled, "scheduler.enabled (the closed-loop "
                                "scheduler)"),
        (topo.elastic_join, "topology.elastic-join (elastic re-planning)"),
        (cfg.learning.mode == "async", "learning.mode: async"),
    ]
    for on, what in later:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet; the in-process synchronous "
                "protocol round is (see ROADMAP.md)")


class ProtocolContext(TorchContext):
    """Server-side TrainContext that trains via protocol clients.

    Validation and init reuse the in-process context: the server holds
    the full model on its device for reassembly and test passes."""

    def __init__(self, cfg: Config, transport: Transport,
                 logger: Logger | None = None,
                 client_timeout: float = 600.0,
                 ready_timeout: float | None = None, device=None):
        _refuse_unported(cfg)
        super().__init__(cfg, device=device)
        self.bus = transport
        from split_learning_torch.runtime.trace import default_fault_counters
        self.faults = default_fault_counters
        self._assembler = FrameAssembler()   # chunked UPDATE reassembly
        self.log = logger or Logger.for_run(cfg, "server", console=False)
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
        make_codecs(cfg, faults=self.faults)
        # streaming aggregation plane: fold each UPDATE into a running
        # per-stage weighted sum the moment it decodes
        self._agg = cfg.aggregation
        self._streaming = (self._agg.streaming and self._agg.strategy
                           in agg_plane.FOLD_STRATEGIES)
        self._fold_backend = (agg_plane.make_fold_backend(cfg, self.device)
                              if self._streaming else None)
        self._fold: agg_plane.StreamingFold | None = None
        # FedAvgM velocity, keyed cluster_id -> {path: velocity}: each
        # cluster's fold is its own optimizer stream (on the card with
        # the CUDA fold backend, between rounds too)
        self._agg_velocity: dict = {}
        # fence: messages are stamped with a per-train_cluster
        # generation, so a straggler from an abandoned invocation can't
        # satisfy a later invocation's barriers
        self._gen = 0
        self._cur_gen = 0
        # (client_id, version) pairs already folded — at-least-once
        # redelivery must not double-count
        self._folded_versions: set = set()
        self.last_fold: agg_plane.FoldResult | None = None
        #: per invocation, the wall of each round phase (START fan-out,
        #: READY, training, UPDATE upload + fold, the fold's update)
        self.round_phases: list[dict] = []

    # -- rpc pump ------------------------------------------------------------

    def _pump_one(self, timeout: float) -> bool:
        raw = self.bus.get(RPC_QUEUE, timeout=timeout)
        if raw is None:
            return False
        try:
            msg = self._assembler.feed(raw)
        except Exception as e:  # noqa: BLE001 — corrupt frame: a flipped
            # bit on rpc_queue must cost one message, not the server
            self.faults.inc("corrupt_rejected")
            self.log.warning(f"dropping undecodable rpc frame: {e}")
            return True
        if msg is None:
            return True   # chunk of a still-partial frame
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
                self._ready.add(msg.client_id)
        elif isinstance(msg, Notify):
            if msg.round_idx != self._cur_gen:
                self.log.warning(f"stale NOTIFY {msg.client_id} "
                                 f"gen={msg.round_idx} (dropped)")
            else:
                self._notified.add(msg.client_id)
                self.log.received(f"NOTIFY {msg.client_id}")
        elif isinstance(msg, Update):
            self._admit_update(msg)
        else:
            self.log.warning(f"unexpected rpc message "
                             f"{type(msg).__name__}")
        return True

    def _admit_update(self, msg: Update) -> None:
        """The one admission door for client Updates: dedup on
        ``(client_id, version)`` before any sample accounting, then the
        generation fence (only the current invocation folds)."""
        ver = msg.version if msg.version is not None else msg.round_idx
        key = (msg.client_id, ver)
        if key in self._folded_versions:
            self.faults.inc("agg_dup_drops")
            self.log.warning(f"duplicate UPDATE {msg.client_id} "
                             f"v{ver} (already folded; dropped)")
            return
        if ver != self._cur_gen or msg.round_idx != self._cur_gen:
            self.faults.inc("agg_stale_updates")
            self.log.warning(f"stale UPDATE {msg.client_id} v{ver} "
                             "(rejected)")
            return
        if msg.delta_base is not None:
            raise NotImplementedError(
                "delta-encoded UPDATE frames (transport.codec rpc) are not "
                "ported yet; they come with the codec slice")
        if self._fold is not None:
            # the weights fold into the running sum NOW; the barrier
            # list holds a weight-stripped record
            self._fold.add_update(copy.copy(msg))
            msg.params = None
            msg.batch_stats = None
        elif msg.params is not None:
            msg.params = _torch_tree(msg.params, "cpu")
            msg.batch_stats = _torch_tree(msg.batch_stats or {}, "cpu")
        self._folded_versions.add(key)
        self._updates.append(msg)
        self.log.received(f"UPDATE {msg.client_id} "
                          f"samples={msg.num_samples} ok={msg.ok}")

    def _pump_until(self, pred: Callable[[], bool],
                    what: str | Callable[[], str],
                    deadline: float | None = None) -> bool:
        """Drain rpc_queue until ``pred()``; False if the deadline
        passes (``what`` may be a callable naming who is missing AT the
        deadline)."""
        deadline = (time.monotonic() + self.client_timeout
                    if deadline is None else deadline)
        while not pred():
            remain = deadline - time.monotonic()
            if remain <= 0:
                w = what() if callable(what) else what
                self.faults.inc("timeouts")
                self.log.warning(f"timeout waiting for {w}")
                return False
            self._pump_one(timeout=min(remain, 0.25))
        return True

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

    def train_cluster(self, plan: ClusterPlan, params, stats, *,
                      round_idx: int = 0, epochs: int = 1,
                      lr: float | None = None) -> list[Update]:
        """One remote round for one cluster."""
        stage1 = list(plan.stage1_clients)
        if not stage1:
            return []
        active = [(cid, 1) for cid in stage1]
        for s in range(2, plan.n_stages + 1):
            active += [(cid, s) for cid in plan.clients[s - 1]]
        ranges = stage_ranges(len(self.specs), plan.cuts)
        learning = dataclasses.asdict(self.cfg.learning)
        if lr is not None:
            learning["learning_rate"] = lr
        self._ready.clear()
        self._notified.clear()
        self._updates = []
        self._gen += 1
        self._cur_gen = self._gen
        self._folded_versions = {(c, v) for c, v in self._folded_versions
                                 if self._cur_gen - v <= 1}

        # streaming fold for this invocation, in canonical per-stage
        # sorted client-id order; built BEFORE the START fan-out so the
        # first UPDATE to land has somewhere to fold
        if self._streaming:
            expected: dict[int, list] = {}
            for cid, s in sorted(active):
                expected.setdefault(s, []).append(cid)
            self._fold = agg_plane.StreamingFold(
                expected, backend=self._fold_backend, faults=self.faults)

        # stage-ascending START fan-out: stage-1 feeders start streaming
        # while later stages' STARTs are still encoding.  Shard trees
        # are cut once per layer range; a big shard frame is published
        # as crc'd SLTC chunks
        fanout_t0 = time.perf_counter()
        shard_cache: dict = {}
        for cid, s in active:
            a, b = ranges[s - 1]
            if (a, b) not in shard_cache:
                shard_cache[(a, b)] = tuple(
                    _np_tree(shard_params(tree, self.specs, a, b))
                    for tree in (params, stats or {}))
            label_counts = None
            if s == 1:
                label_counts = np.asarray(
                    plan.label_counts[plan.stage1_clients.index(cid)])
            end_layer = -1 if s == plan.n_stages else b
            for part in encode_parts(Start(
                    start_layer=a, end_layer=end_layer,
                    cluster=plan.cluster_id, params=shard_cache[(a, b)][0],
                    batch_stats=shard_cache[(a, b)][1], learning=learning,
                    label_counts=label_counts, round_idx=round_idx,
                    extra={"epochs": epochs, "sda_size": 1,
                           "n_stages": plan.n_stages,
                           "refresh": self.cfg.distribution.refresh,
                           "gen": self._cur_gen}),
                    self.cfg.transport.chunk_mb << 20):
                self.bus.publish(reply_queue(cid), part)
            self.log.sent(f"START -> {cid} layers=[{a}, {end_layer}]")
        del shard_cache
        # wall of each phase of the round, read at the barriers
        phases = {"fanout_s": time.perf_counter() - fanout_t0}
        t_phase = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal t_phase
            now = time.perf_counter()
            phases[name] = now - t_phase
            t_phase = now

        ids = {cid for cid, _ in active}
        if not self._pump_until(
                lambda: ids <= self._ready,
                lambda: f"READY from {ids - self._ready}",
                deadline=time.monotonic() + self.ready_timeout):
            ids &= self._ready   # drop unresponsive clients mid-round
        if self._fold is not None:
            # stop the reorder window waiting for clients dropped at the
            # READY barrier
            for cid, s in active:
                if cid not in ids:
                    self._fold.drop(s, cid)
        lap("ready_s")   # clients decode their START and build shards
        for cid in sorted(ids):
            self.bus.publish(reply_queue(cid), encode(Syn(round_idx)))
        self.log.sent(f"SYN -> {sorted(ids)}")

        s1_ids = set(stage1) & ids
        self._pump_until(lambda: s1_ids <= self._notified,
                         "NOTIFY from stage-1 clients")
        lap("train_s")   # SYN -> the last stage-1 NOTIFY
        for cid in sorted(ids):
            self.bus.publish(reply_queue(cid), encode(Pause()))
        self.log.sent(f"PAUSE -> {sorted(ids)}")
        self._pump_until(
            lambda: {u.client_id for u in self._updates} >= ids,
            lambda: ("UPDATE from "
                     + str(ids - {u.client_id for u in self._updates})))
        lap("upload_s")   # PAUSE -> every UPDATE decoded and folded
        updates = list(self._updates)
        self._updates = []
        if self._fold is not None:
            # the overlapped fold already consumed every tree; what is
            # left is the per-stage divide + optimizer step + cast
            fold, self._fold = self._fold, None
            m = float(self._agg.server_momentum)
            result = fold.finish(
                base=params if m else None, momentum=m,
                velocity=(self._agg_velocity.setdefault(
                    plan.cluster_id, {}) if m else None),
                fused=self._agg.update_sharded)
            result.params = _torch_tree(result.params, self.device)
            result.stats = _torch_tree(result.stats, self.device)
            self.last_fold = result
            lap("update_s")
            updates = agg_plane.UpdateBatch(updates)
            updates.fold = result
            self.log.metric(
                kind="agg", gen=self._cur_gen, round_idx=round_idx,
                cluster=plan.cluster_id, backend=self._fold_backend.name,
                fold_s=result.fold_s, folded=result.folded,
                window_hwm=result.window_hwm,
                peak_tree_copies=result.peak_tree_copies,
                n_samples=result.n_samples, update_s=result.update_s,
                stage_update_ms=result.stage_update_ms)
            self.log.info(
                f"streamed aggregate: folded={result.folded} "
                f"fold={result.fold_s:.3f}s update={result.update_s:.3f}s",
                "cyan")
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
        self.log.metric(kind="wire", gen=self._cur_gen,
                        round_idx=round_idx, cluster=plan.cluster_id,
                        cumulative_reply_bytes=totals["reply"],
                        cumulative_rpc_bytes=totals["rpc"],
                        cumulative_data_bytes=totals["data"], **sender)
        self.round_phases.append(phases)
        self.log.metric(kind="phases", gen=self._cur_gen,
                        round_idx=round_idx, cluster=plan.cluster_id,
                        **{k: round(v, 6) for k, v in phases.items()})
        snap = {k: v for k, v in self.faults.snapshot().items() if v}
        if snap:
            self.log.metric(kind="faults", gen=self._cur_gen,
                            round_idx=round_idx, cluster=plan.cluster_id,
                            **snap)
        return updates

    def stop_all(self, reason: str = "training complete"):
        for reg in self.registrations:
            self.bus.publish(reply_queue(reg.client_id),
                             encode(Stop(reason=reason)))
        self.log.sent(f"STOP -> all ({reason})")


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

    def serve(self, init_params: Any | None = None,
              init_stats: Any | None = None) -> TrainResult:
        """Registration barrier, planning, the round loop, STOP."""
        regs = self.ctx.wait_for_registrations()
        plans = plan_clusters(self.cfg, regs)
        try:
            return run_training(self.cfg, self.ctx, plans, self.log,
                                init_params=init_params,
                                init_stats=init_stats)
        finally:
            self.ctx.stop_all()
            self.ctx.shutdown()
            if self._own_bus:
                self.ctx.bus.close()


@dataclasses.dataclass
class InProcRun:
    server: ProtocolServer
    clients: list
    bus: InProcTransport
    result: TrainResult


def run_inproc(cfg: Config, device=None, client_timeout: float = 600.0,
               init_params: Any | None = None,
               logger: Logger | None = None,
               init_stats: Any | None = None) -> InProcRun:
    """The whole protocol deployment in this process on ``device`` (CUDA
    unless the CPU is asked for): the server in the calling thread, one
    ``ProtocolClient`` thread per configured client (``client_{stage}_{i}``),
    one shared :class:`InProcTransport`.  A client that raises closes the
    bus, so the server fails at once instead of waiting out a barrier;
    its error is raised here."""
    from split_learning_torch.runtime.client import ProtocolClient

    if cfg.transport.kind != "inproc":
        raise ValueError(
            f"run_inproc runs every participant over one in-process bus; "
            f"transport.kind is {cfg.transport.kind!r}: start the broker, "
            "server and clients as processes for it")
    bus = InProcTransport()
    server = ProtocolServer(cfg, bus, logger=logger,
                            client_timeout=client_timeout, device=device)
    clients = [ProtocolClient(cfg, f"client_{s}_{i}", s, bus,
                              device=device)
               for s, n in enumerate(cfg.clients, start=1)
               for i in range(n)]
    errors: list = []

    def run(client):
        try:
            client.run()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append((client.client_id, e))
            bus.close()

    threads = [threading.Thread(target=run, args=(c,), daemon=True,
                                name=c.client_id) for c in clients]
    for t in threads:
        t.start()
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
    if errors:
        cid, err = errors[0]
        raise RuntimeError(f"protocol client {cid} failed") from err
    return InProcRun(server, clients, bus, result)
