"""Seeded fault injection, and a participant's transport stack built from
its config.

Port of the JAX package's ``runtime/chaos.py``.  :class:`ChaosTransport`
wraps any transport and injects what a real deployment's channel does —
dropped, duplicated, reordered, delayed and bit-corrupted frames — and
scripted process crashes, reproducibly: every decision is drawn from a
per-queue RNG seeded by ``(chaos.seed, queue)``, six draws a publish
whether or not a fault fires, so a run's fault pattern replays from one
integer whatever the thread timing, and equals the JAX package's for the
same seed and frame stream.

:func:`make_runtime_transport` builds the stack the JAX package builds:
``AsyncTransport(ReliableTransport(ChaosTransport(bus)))``.  Chaos sits
below reliability, where the network does, so redelivered frames roll
fresh faults too; the reliable layer's seq/ack, dedup and resequencing
turn the channel back into the exact stream, and the frames' own crc
rejects what corruption reaches above it.

A scripted crash models "client c2 dies right after sending its 2nd
activation": when the owner's Nth publish to a matching queue has gone
out (the frame is sent first), :class:`ChaosCrash` is raised out of
``publish`` and the participant unwinds; every later publish or get on
the wrapper raises again.

Not ported: the flight recorder's feed (``blackbox.record`` of each
fault and the dump at a crash) and the tracer on the outermost layer;
neither plane is in the port yet.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import random
import threading
import zlib
from typing import Iterable

from split_learning_torch.config import ChaosConfig, Config
from split_learning_torch.runtime.bus import (
    AsyncTransport, QueueClosed, ReliableTransport, Transport,
    make_transport,
)


class ChaosCrash(RuntimeError):
    """Scripted process death (``chaos.crash``), raised out of
    ``publish``."""


class ChaosTransport(Transport):
    """Seeded fault-injecting wrapper over any transport.

    ``name`` names the owning participant for crash scripts.  All fault
    state (RNGs, the reorder stash, crash counts) lives on the instance:
    give every participant its own wrapper over a shared bus.  Delayed
    frames go out on ``side`` from timer threads (over TCP a second
    connection: a blocking get holds the main socket)."""

    def __init__(self, inner: Transport, cfg: ChaosConfig, name: str = "",
                 faults=None, side: Transport | None = None):
        super().__init__()
        self.inner = inner
        self._side = side if side is not None else inner
        self.cfg = cfg
        self.name = name
        if faults is None:
            from split_learning_torch.runtime.trace import (
                default_fault_counters,
            )
            faults = default_fault_counters
        self.faults = faults
        self._lock = threading.Lock()
        self._rngs: dict[str, random.Random] = {}
        self._stash: dict[str, bytes] = {}     # reorder slot per queue
        # this participant's crash points (copies: the publish count
        # lives in the spec under "_n")
        self._crash = [dict(s) for s in cfg.crash
                       if s.get("client") in ("*", name)]
        # sticky death: once a crash point fires, every later publish or
        # get on this wrapper raises, so a crash that surfaces on a
        # background thread (the async sender) still ends the participant
        self._crashed = False
        self._timers: list[threading.Timer] = []

    def _check_crashed(self) -> None:
        if self._crashed:
            raise ChaosCrash(f"scripted crash: {self.name or '?'} is dead")

    def _rng(self, queue: str) -> random.Random:
        r = self._rngs.get(queue)
        if r is None:
            r = random.Random(zlib.crc32(
                f"{self.cfg.seed}:{queue}".encode()))
            self._rngs[queue] = r
        return r

    def _match(self, queue: str) -> bool:
        return any(fnmatch.fnmatchcase(queue, p) for p in self.cfg.queues)

    def _crash_due(self, queue: str) -> bool:
        due = False
        for spec in self._crash:
            if fnmatch.fnmatchcase(queue, spec.get("queue", "*")):
                spec["_n"] = spec.get("_n", 0) + 1
                if spec["_n"] == int(spec.get("after", 1)):
                    due = True
        return due

    def _die(self, queue: str) -> None:
        self.faults.inc("crashes")
        self._crashed = True
        raise ChaosCrash(f"scripted crash: {self.name or '?'} dies at "
                         f"publish to {queue}")

    def _late_publish(self, queue: str, payload: bytes) -> None:
        try:
            self._side.publish(queue, payload)
        except (QueueClosed, ConnectionError, OSError):
            # the run ended before the delayed frame went out: counted
            # apart from a drop
            self.faults.inc("late_drops")

    def publish(self, queue: str, payload: bytes) -> None:
        self._check_crashed()
        with self._lock:
            # a crash script counts publishes on any queue it names;
            # probabilistic faults apply to cfg.queues only
            crash = self._crash_due(queue)
        if not self._match(queue):
            self.inner.publish(queue, payload)
            if crash:
                self._die(queue)
            return
        cfg = self.cfg
        with self._lock:
            r = self._rng(queue)
            # six draws a publish whatever fires, so the per-queue stream
            # stays aligned
            drop = r.random() < cfg.drop
            dup = r.random() < cfg.duplicate
            reorder = r.random() < cfg.reorder
            corrupt = r.random() < cfg.corrupt
            delay = r.random() < cfg.delay
            pos_f = r.random()

            out = payload
            if corrupt and payload:
                i = int(pos_f * len(payload)) % len(payload)
                out = (bytes(payload[:i]) + bytes([payload[i] ^ 0xFF])
                       + bytes(payload[i + 1:]))
                self.faults.inc("corruptions")
            sends = []
            if drop:
                self.faults.inc("drops")
            else:
                sends.append(out)
                if dup:
                    sends.append(out)
                    self.faults.inc("duplicates")
            # reorder: stash one frame; it goes out after the next
            # publish to the same queue (a 2-swap)
            prior = self._stash.pop(queue, None)
            emit = []
            for s in sends:
                if reorder and queue not in self._stash:
                    self._stash[queue] = s
                    self.faults.inc("reorders")
                else:
                    emit.append(s)
            if prior is not None:
                emit.append(prior)
            if delay and cfg.delay_s > 0 and emit:
                self.faults.inc("delays")
                self._timers = [t for t in self._timers if t.is_alive()]
                for s in emit:
                    t = threading.Timer(cfg.delay_s, self._late_publish,
                                        (queue, s))
                    t.daemon = True
                    self._timers.append(t)
                    t.start()
                emit = []
        for s in emit:
            self.inner.publish(queue, s)
        if crash:
            self._die(queue)

    def get(self, queue: str, timeout: float | None = None):
        self._check_crashed()
        return self.inner.get(queue, timeout)

    def purge(self, queues: Iterable[str] | None = None) -> None:
        self.inner.purge(queues)
        with self._lock:
            if queues is None:
                self._stash.clear()
            else:
                for q in queues:
                    self._stash.pop(q, None)

    def bytes_out_snapshot(self) -> dict:
        return self.inner.bytes_out_snapshot()

    def stop(self, close_inner: bool = True) -> None:
        """Cancel the delay timers and close the side connection this
        layer owns; ``close_inner=False`` leaves a shared bus below
        open."""
        with self._lock:
            for t in self._timers:
                t.cancel()
            self._timers.clear()
        if self._side is not self.inner:
            self._side.close()
        if close_inner:
            self.inner.close()

    def close(self) -> None:
        self.stop(close_inner=True)


def stop_stack(bus: Transport, close_inner: bool = True) -> None:
    """Stop every layer of a stack, outermost first.  ``close_inner``
    True closes the base transport too (each layer's ``close`` closes
    the one below); False leaves the base open — a participant that dies
    over a bus the others share (each layer then stops with
    ``close_inner=False``)."""
    if close_inner:
        bus.close()
        return
    layer = bus
    while hasattr(layer, "inner") and hasattr(layer, "stop"):
        layer.stop(close_inner=False)
        layer = layer.inner


def make_runtime_transport(cfg: Config, name: str, faults=None,
                           bus: Transport | None = None) -> Transport:
    """Build participant ``name``'s transport stack from ``cfg``, as the
    JAX package's ``make_runtime_transport`` does:
    ``AsyncTransport(ReliableTransport(ChaosTransport(base)))``, each
    layer where its config asks for it.

    The base is ``bus`` when the caller gives one (a bus the participants
    of one process share; the stack never closes it through
    :func:`stop_stack` with ``close_inner=False``), else a fresh
    transport of ``transport.kind`` — over TCP a
    :class:`~split_learning_torch.runtime.bus.ShardedTcpTransport` when
    ``broker.shards`` > 1.

    Over TCP the chaos delay timers and the reliable daemon each get a
    connection of their own (a blocked get holds a connection's socket);
    the daemon's is itself wrapped in chaos, without the crash scripts
    (the main path's wrapper already models the process dying), so
    redelivered frames roll fresh faults.  With the reliable layer the
    async prefetchers share the stack (its dedup and resequencing state
    must live on one instance per queue); without it each gets its own
    connection.  The participant's span tracer rides the async layer
    (``stack.tracer``), where the protocol roles find it; the layers below
    move the trace context inside each frame untouched."""
    tcp = cfg.transport.kind == "tcp"
    shards = cfg.broker.shards if tcp else 1

    def mk() -> Transport:
        return make_transport(cfg.transport.kind, cfg.transport.host,
                              cfg.transport.port, shards=shards,
                              faults=faults)

    stack = bus if bus is not None else mk()
    if cfg.chaos.enabled:
        stack = ChaosTransport(stack, cfg.chaos, name=name, faults=faults,
                               side=mk() if tcp else None)
    if cfg.transport.reliable:
        side = None
        if tcp:
            side = mk()
            if cfg.chaos.enabled:
                side = ChaosTransport(
                    side, dataclasses.replace(cfg.chaos, crash=()),
                    name=f"{name}.redeliver", faults=faults)
        stack = ReliableTransport(
            stack, sender=name, patterns=cfg.transport.reliable_queues,
            side=side, redeliver_s=cfg.transport.redeliver_s,
            max_redeliver=cfg.transport.max_redeliver, faults=faults)
    if cfg.transport.async_send:
        from split_learning_torch.runtime.spans import make_tracer
        recv_factory = (mk if tcp and not cfg.transport.reliable
                        else None)
        stack = AsyncTransport(
            stack, send_depth=cfg.transport.send_depth,
            prefetch_depth=cfg.transport.prefetch_depth,
            recv_factory=recv_factory, slice_gets=tcp, faults=faults,
            tracer=make_tracer(cfg, name))
    return stack
