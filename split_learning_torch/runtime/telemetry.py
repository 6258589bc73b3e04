"""The live telemetry plane: heartbeats, fleet health, exporters.

Port of the JAX package's ``runtime/telemetry.py`` (plain Python, no
tensor library; the port keeps its own copy):

* :class:`GaugeSet` — last-value named gauges, the third registry of
  ``runtime/trace.py`` beside the fault counters and the histograms
  (names from :data:`~split_learning_torch.runtime.trace.GAUGE_NAMES`);
* :class:`TelemetrySnapshot` / :class:`TelemetryEmitter` — one
  participant's telemetry at one instant (counters, gauges, histogram
  digests, current round, EWMA samples/s), published as a ``Heartbeat``
  control frame on the rpc queue by a background thread every
  ``observability.heartbeat-interval`` seconds and piggybacked on every
  UPDATE.  The beat thread reads host counters only: it never waits on
  the card.  Unlike the JAX package's, it beats on a fixed grid, so the
  cost of a beat does not stretch the interval.  Counter snapshots ride
  every heartbeat, so a client that crashes mid-round loses at most one
  interval of counters;
* :class:`FleetMonitor` — the server-side consumer: per-client
  ring-buffer series and a health state machine (``healthy → degraded
  → straggler → lost``) driven by missed heartbeats and step-rate
  scoring against the fleet median.  Duplicated or reordered beats are
  rejected by a (sender clock, seq) staleness guard, so they never flap
  a ``lost`` client back to ``healthy``; recovery climbs back through
  ``degraded``.  The server's barriers consult :meth:`FleetMonitor.
  advance`, so a ``lost`` client is dropped after
  ``observability.liveness-timeout`` seconds instead of stalling the
  round until the client timeout.  The digest methods (``note_digest``,
  ``build_digest``, ``drop_digest``, the watchlist) are the hierarchical
  roll-up's pure logic (``runtime/sketch.py``); no aggregator node of
  the port sends a digest yet;
* :func:`render_prometheus` / :func:`lint_prometheus` — Prometheus
  text exposition (byte for byte the JAX package's page under the same
  state) and a pure-Python format linter;
* :class:`TelemetryExporter` — a stdlib HTTP thread serving
  ``/metrics`` (Prometheus text) and ``/fleet`` (JSON), polled by
  ``tools/sl_top.py``.

No protocol imports: the emitter publishes through a callback the client
provides, so the wire vocabulary stays owned by ``runtime/protocol.py``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import re
import statistics
import threading
import time
from typing import Any, Callable

from split_learning_torch.runtime import sketch
from split_learning_torch.runtime.trace import GAUGE_NAMES


class GaugeSet:
    """Thread-safe named gauges (last value wins), the third leg of the
    ``trace.py`` registry family: :class:`~split_learning_torch.runtime
    .trace.FaultCounters` count, :class:`~split_learning_torch.runtime
    .trace.HistogramSet` distributes, gauges *state*.  Names must come
    from :data:`~split_learning_torch.runtime.trace.GAUGE_NAMES`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict[str, float] = {}

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = float(value)

    def get(self, name: str, default: float | None = None
            ) -> float | None:
        with self._lock:
            return self._values.get(name, default)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._values)


@dataclasses.dataclass
class TelemetrySnapshot:
    """One participant's full telemetry state at one instant.

    Travels the wire as a PLAIN DICT (:meth:`as_dict`): the protocol's
    restricted unpickler admits builtins, not this class — keeping the
    wire vocabulary closed is worth the round-trip through ``dict``.
    ``seq`` increases monotonically per emitter; together with ``t``
    (the sender's clock) it is the receiver's staleness guard against
    duplicated/reordered heartbeats."""

    part: str                       # participant id
    t: float                        # sender clock (epoch seconds)
    seq: int                        # per-emitter monotonic sequence
    kind: str = "client"            # participant role: client | agg_node
    # pipeline stage this participant runs (1-based; None for
    # non-training roles): what lets the digest path and the
    # scheduler's cut re-planner aggregate MEASURED step times per
    # stage instead of mirroring stage-1 profiles
    stage: int | None = None
    round: int | None = None        # current round index (gauge)
    samples: int = 0                # cumulative samples this round
    samples_per_s: float = 0.0      # EWMA training throughput
    gauges: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    wire: dict = dataclasses.field(default_factory=dict)
    latency: dict = dataclasses.field(default_factory=dict)
    v: int = 1                      # schema version

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TelemetrySnapshot | None":
        """Tolerant decode: a foreign/newer snapshot degrades to None,
        never raises into the server's rpc pump."""
        if not isinstance(d, dict):
            return None
        known = {f.name for f in dataclasses.fields(cls)}
        try:
            return cls(**{k: v for k, v in d.items() if k in known})
        except (TypeError, ValueError):
            return None


class TelemetryEmitter:
    """Client-side heartbeat publisher + EWMA rate meter.

    ``send`` is a callable taking the snapshot *dict* — the client
    wraps it in a ``Heartbeat`` frame and publishes on the rpc queue
    (keeping this module protocol-free).  ``samples_fn`` reads the
    owner's cumulative sample counter; per-round resets are handled
    (a negative delta restarts the window).  The background thread is
    a daemon started on the first START and stopped with the client;
    publish failures are counted (``heartbeat_errors``) and a run of
    consecutive failures stops the thread — a dead transport must not
    spin a hot error loop."""

    #: consecutive publish failures before the beat thread gives up
    MAX_ERRORS = 3
    #: EWMA smoothing factor per tick (~3-tick half life)
    ALPHA = 0.3

    def __init__(self, participant: str, send: Callable[[dict], None],
                 interval: float, faults=None, wire=None, hists=None,
                 gauges: GaugeSet | None = None,
                 samples_fn: Callable[[], int] | None = None,
                 kind: str = "client", stage: int | None = None):
        self.participant = participant
        # participant role stamped on every snapshot: the FleetMonitor
        # rate-scores only kind="client" reporters (an idle aggregator
        # node's 0 samples/s is its normal state, not a straggler)
        self.kind = kind
        # pipeline stage (mutable: a re-plan may move this client);
        # stamped on every snapshot for per-stage fleet aggregation
        self.stage = stage
        self.interval = float(interval)
        self._send = send
        self._faults = faults
        self._wire = wire
        self._hists = hists
        self.gauges = gauges if gauges is not None else GaugeSet()
        self._samples_fn = samples_fn
        self._lock = threading.Lock()
        self._seq = 0
        self._samples = 0           # fallback counter (note_samples)
        self._rate: float | None = None
        self._last_t: float | None = None
        self._last_total = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- rate meter ----------------------------------------------------------

    def note_samples(self, n: int) -> None:
        """Count trained samples (only needed when no ``samples_fn``)."""
        with self._lock:
            self._samples += int(n)

    def _total_samples(self) -> int:
        if self._samples_fn is not None:
            try:
                return int(self._samples_fn())
            except Exception:  # noqa: BLE001 — a racing reset must not
                return 0       # kill the beat thread
        with self._lock:
            return self._samples

    def _tick_rate(self, now: float) -> float:
        total = self._total_samples()
        with self._lock:
            if self._last_t is None:
                inst = 0.0
            else:
                delta = total - self._last_total
                if delta < 0:           # per-round counter reset
                    delta = total
                inst = delta / max(now - self._last_t, 1e-9)
            self._last_t, self._last_total = now, total
            self._rate = (inst if self._rate is None
                          else (1 - self.ALPHA) * self._rate
                          + self.ALPHA * inst)
            rate = self._rate
        self.gauges.set("samples_per_s", round(rate, 3))
        return rate

    # -- snapshots -----------------------------------------------------------

    def snapshot(self, now: float | None = None) -> TelemetrySnapshot:
        """Build (and rate-tick) one snapshot; also used to piggyback
        telemetry on Update frames, so sync rounds report for free."""
        now = time.time() if now is None else now
        rate = self._tick_rate(now)
        with self._lock:
            self._seq += 1
            seq = self._seq
        rnd = self.gauges.get("round")
        return TelemetrySnapshot(
            part=self.participant, t=now, seq=seq, kind=self.kind,
            stage=self.stage,
            round=None if rnd is None else int(rnd),
            samples=self._total_samples(),
            samples_per_s=round(rate, 3),
            gauges=self.gauges.snapshot(),
            counters=(self._faults.snapshot() if self._faults else {}),
            wire=({k: v for k, v in self._wire.snapshot().items() if v}
                  if self._wire else {}),
            latency=(self._hists.snapshot() if self._hists else {}))

    def beat_once(self) -> None:
        self._send(self.snapshot().as_dict())

    # -- thread lifecycle ----------------------------------------------------

    def start(self) -> None:
        """Idempotent; no-op when the interval disables heartbeats."""
        if self.interval <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"heartbeat-{self.participant}")
        self._thread.start()

    def _run(self) -> None:
        errors = 0
        # beats on a fixed grid (start + k * interval), where the JAX
        # package's thread waits a whole interval after each beat: the
        # time a beat takes, the wait for the GIL the training threads
        # hold included, does not stretch the interval, and the grid's
        # slots missed in a stall are skipped, not sent in a burst
        due = time.monotonic() + self.interval
        while not self._stop.wait(max(0.0, due - time.monotonic())):
            late = max(0.0, time.monotonic() - due)
            due += (late // self.interval + 1) * self.interval
            try:
                self.beat_once()
                errors = 0
            except Exception as e:  # noqa: BLE001 — transport gone/
                # teardown.  A scripted ChaosCrash is the simulated
                # process dying — stop beating IMMEDIATELY (the sticky
                # crashed transport kills the training thread at its
                # next op); retrying would mis-model a dead process as
                # three more liveness signals.  Matched by name so the
                # telemetry plane keeps zero chaos imports.
                if type(e).__name__ == "ChaosCrash":
                    return
                errors += 1
                if self._faults is not None:
                    self._faults.inc("heartbeat_errors")
                if errors >= self.MAX_ERRORS:
                    return

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, 2 * self.interval))
            self._thread = None


# --------------------------------------------------------------------------
# server-side fleet monitor
# --------------------------------------------------------------------------

#: ring-buffer length of the per-client (t, rate, samples) series
HISTORY = 256

HEALTH_STATES = ("healthy", "degraded", "straggler", "lost")
_STATE_CODE = {s: i for i, s in enumerate(HEALTH_STATES)}


@dataclasses.dataclass
class _ClientHealth:
    state: str = "healthy"
    kind: str = "client"            # client | agg_node (snapshot.kind)
    stage: int | None = None        # pipeline stage (snapshot.stage)
    # digest roll-up: the aggregator node whose FleetDigest sourced
    # this entry (a WATCHLIST member — its liveness/state machine runs
    # on that node, the server keeps the exact view), None for clients
    # heartbeating directly at this monitor
    via: str | None = None
    first_seen: float = 0.0
    last_seen: float = 0.0          # receiver clock, any FRESH frame
    last_t_send: float = 0.0        # sender clock of last fresh beat
    last_seq: int = -1
    rate: float | None = None       # EWMA samples/s (sender-reported)
    score: float | None = None      # rate / fleet median (lower=worse)
    round: int | None = None
    version: int | None = None      # last Update's seed version (async)
    samples: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    wire: dict = dataclasses.field(default_factory=dict)
    latency: dict = dataclasses.field(default_factory=dict)
    gauges: dict = dataclasses.field(default_factory=dict)
    series: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=HISTORY))


class FleetMonitor:
    """Per-client health state machine + time series, fed by the
    server's rpc pump and advanced on a wall clock.

    State machine (``healthy → degraded → straggler → lost``):

    * *missed heartbeats*: silence past ``DEGRADED_MISSES`` intervals
      degrades, past ``STRAGGLER_MISSES`` intervals marks a straggler,
      past ``liveness_timeout`` seconds marks **lost** — the state the
      server's barriers are allowed to drop;
    * *step-rate scoring*: a reporting client whose EWMA samples/s
      falls below ``STRAGGLER_SCORE`` × the fleet median is a
      straggler even while heartbeating on time (the slow-but-alive
      case eviction must see but not kill — that policy belongs to the
      scheduler);
    * *recovery*: fresh contact lifts ``lost`` only to ``degraded``;
      the next :meth:`advance` with recent contact and a score at or
      above ``RECOVER_SCORE`` × median completes the climb to
      ``healthy``.  The two-step path plus the seq/send-time staleness
      guard (duplicated or reordered heartbeats are dropped and
      counted ``stale_heartbeats``) is what keeps chaos dup/reorder
      from flapping ``lost`` → ``healthy``.

    Thread-safe: the rpc pump feeds it, HTTP exporter threads read it.
    """

    DEGRADED_MISSES = 1.5    # intervals of silence -> degraded
    STRAGGLER_MISSES = 2.0   # intervals of silence -> straggler
    STRAGGLER_SCORE = 0.5    # rate below this x median -> straggler
    RECOVER_SCORE = 0.75     # rate at/above this x median -> healthy
    STALE_LAG = 2            # version lag at/above this -> straggler
    MAX_TRANSITIONS = 512    # bounded transition journal
    #: watchlist demotion hysteresis: a digest-sourced client is
    #: dropped back to sketch space only after this many consecutive
    #: digests from its node stopped naming it AND it is healthy — a
    #: client oscillating around the top-K boundary cannot flap in and
    #: out of exact state
    WATCH_DEMOTE_MISSES = 3
    #: per-digest worst-straggler fan-in (K of the top-K heap)
    DIGEST_TOP_K = 8

    def __init__(self, interval: float, liveness_timeout: float,
                 log=None, gauges: GaugeSet | None = None,
                 faults=None, watchlist_size: int = 64):
        self.interval = max(float(interval), 1e-3)
        self.liveness_timeout = float(liveness_timeout)
        self._log = log
        self._faults = faults
        self.gauges = gauges if gauges is not None else GaugeSet()
        self._lock = threading.RLock()
        self._clients: dict[str, _ClientHealth] = {}
        self._last_pump: float | None = None
        # hierarchical digest roll-up (runtime/sketch.py): latest
        # FleetDigest per aggregator node (seq-guarded), the bounded
        # watchlist's miss counters (promotion/demotion hysteresis)
        # and the pinned set (scheduler attention — never demoted
        # while pinned)
        self.watchlist_size = int(watchlist_size)
        self._digests: dict[str, dict] = {}
        self._watch_miss: dict[str, int] = {}
        self._pinned: set = set()
        # monotonic transition sequence: stamps every journal record so
        # build_digest can report exactly the transitions since the
        # previous digest, duplicate-free across digest intervals
        self._tx_seq = 0
        self._digest_mark = 0
        # async staleness as a first-class fleet signal: the server's
        # current global version (note_version at each cut) vs the
        # version each client's last Update was seeded from — the lag
        # the admission window decays by, surfaced per client as
        # sl_client_version_lag and annotated `stale` on straggler
        # transitions it causes
        self._version: int | None = None
        self.transitions: collections.deque = collections.deque(
            maxlen=self.MAX_TRANSITIONS)
        # optional hook fired (under the monitor lock) when a client
        # transitions INTO `lost`: the server prunes per-client server
        # state that would otherwise leak — today the delta codec's
        # shadow trees (runtime/server.py _on_client_lost).  Must be
        # cheap and non-blocking.
        self.on_lost = None

    # -- ingest --------------------------------------------------------------

    def _ensure(self, cid: str, now: float) -> _ClientHealth:
        h = self._clients.get(cid)
        if h is None:
            h = self._clients[cid] = _ClientHealth(
                first_seen=now, last_seen=now)
        return h

    def note_pump(self, now: float | None = None) -> None:
        """Mark the feeding queue as freshly drained.  Age-based
        transitions are only meaningful while someone is actually
        pumping the rpc queue: during a long server-side phase
        (validation, aggregation) heartbeats pile up undelivered and
        every client would LOOK silent — :meth:`advance` freezes
        age-driven downgrades whenever the last pump is stale.  Never
        calling this (standalone/unit use) leaves the gate open."""
        now = time.time() if now is None else now
        with self._lock:
            self._last_pump = now

    def note_frame(self, cid: str, now: float | None = None,
                   via: str | None = None) -> None:
        """Any rpc frame from ``cid`` proves a live process — clients
        whose config disables heartbeats still register liveness.
        ``via`` (the server's digest routing table) marks the entry
        digest-covered: a routed client's occasional control frames
        (READY/NOTIFY) must not start an aging clock here that its
        heartbeats — which go to the node — can never feed."""
        now = time.time() if now is None else now
        with self._lock:
            h = self._ensure(cid, now)
            h.last_seen = max(h.last_seen, now)
            if via is not None:
                h.via = via
                return   # state machine runs on the digest node
            if h.state == "lost":
                self._transition(cid, h, "degraded", "contact resumed",
                                 now)

    def note_heartbeat(self, cid: str, telemetry: dict | None,
                       now: float | None = None,
                       via: str | None = None) -> bool:
        """Fold one heartbeat/piggybacked snapshot; False when it was
        stale (duplicate/reordered) and therefore ignored — a stale
        beat must neither refresh liveness nor flap the state.

        ``via`` names the digest node whose roll-up covers this
        client (the server passes its routing table): the fresh data
        folds, but the entry stays digest-covered — its liveness
        clock keeps running on the node, not here, so a routed client
        whose direct frames are merely occasional (round-end Update
        piggybacks) can never age into a phantom ``lost``."""
        now = time.time() if now is None else now
        snap = TelemetrySnapshot.from_dict(telemetry or {})
        with self._lock:
            h = self._ensure(cid, now)
            if snap is None:
                h.last_seen = max(h.last_seen, now)
                return True
            # freshness is lexicographic on (sender clock, seq): a
            # duplicate ties, a reordered older beat is behind on both
            # — and a crashed-and-restarted client (new emitter, seq
            # back at 1) is STILL fresh because its clock moved on,
            # while the old emitter's late-draining frames (higher
            # seq, older clock) stay stale.  Plain seq comparison
            # would lock a restarted client out until its new seq
            # caught the old one.
            if (snap.t, snap.seq) <= (h.last_t_send, h.last_seq):
                if self._faults is not None:
                    self._faults.inc("stale_heartbeats")
                return False
            h.last_seq = snap.seq
            h.last_t_send = snap.t
            h.last_seen = max(h.last_seen, now)
            h.kind = snap.kind or "client"
            if snap.stage is not None:
                h.stage = int(snap.stage)
            # an unrouted direct heartbeat outranks the digest view:
            # the client is talking to THIS monitor again (digest-node
            # fallback), so its liveness clock runs here from now on.
            # A routed client's occasional direct frame (Update
            # piggyback) keeps its digest coverage instead.
            h.via = via
            h.rate = float(snap.samples_per_s)
            h.round = snap.round
            h.samples = int(snap.samples)
            if snap.counters:
                h.counters = dict(snap.counters)
            if snap.wire:
                h.wire = dict(snap.wire)
            if snap.latency:
                h.latency = dict(snap.latency)
            if snap.gauges:
                # the perf plane's gauges (mfu, compute rate, compile
                # seconds, HBM peak) ride every snapshot — what lets
                # the monitor and sl_top tell compute-slow from
                # wire-slow without another wire frame
                h.gauges = dict(snap.gauges)
            h.series.append((round(now, 3), h.rate, h.samples))
            if h.state == "lost":
                self._transition(cid, h, "degraded", "fresh heartbeat",
                                 now)
            return True

    def note_version(self, version: int) -> None:
        """The server cut a new global version (async mode; in sync
        mode this is simply the invocation generation)."""
        with self._lock:
            self._version = int(version)

    def note_client_version(self, cid: str, version: int,
                            now: float | None = None) -> None:
        """Record the seed version of a client's admitted Update —
        the numerator of its version lag."""
        now = time.time() if now is None else now
        with self._lock:
            h = self._ensure(cid, now)
            if h.version is None or version > h.version:
                h.version = int(version)

    def _lag(self, h: _ClientHealth) -> int | None:
        if self._version is None or h.version is None:
            return None
        return max(0, self._version - h.version)

    def forget(self, cid: str) -> None:
        """Elastic prune: a client removed from the plans stops being
        scored (and stops dragging the fleet median down)."""
        with self._lock:
            self._clients.pop(cid, None)
            self._watch_miss.pop(cid, None)
            self._pinned.discard(cid)

    # -- hierarchical digest roll-up (runtime/sketch.py) ---------------------

    def route_via(self, cid: str, node_id: str | None) -> None:
        """The server routed this client's heartbeats to a digest
        node: any standing exact entry stops aging here (the node's
        state machine covers it from now on).  No-op without an entry
        — the digest alone will carry the client."""
        if node_id is None:
            return
        with self._lock:
            h = self._clients.get(cid)
            if h is not None:
                h.via = node_id

    def watch(self, cid: str, pinned: bool = True) -> None:
        """Pin a client to the watchlist (scheduler attention: a
        demoted/knob-carrying client must keep its exact view even
        when it climbs out of the digests' top-K).  ``pinned=False``
        releases the pin; the normal demotion hysteresis then
        applies."""
        with self._lock:
            if pinned:
                self._pinned.add(cid)
                self._watch_miss.pop(cid, None)
            else:
                self._pinned.discard(cid)

    def note_digest(self, node_id: str, digest: dict | None,
                    now: float | None = None) -> bool:
        """Fold one aggregator node's FleetDigest: False when it was
        stale (duplicate/reordered — same lexicographic (t, seq) guard
        as heartbeats) or undecodable.  Fresh digests replace the
        node's standing summary wholesale (each digest is a full
        restatement, not an increment — redelivery can never
        double-count), append the node's state transitions to the
        shared journal, and run the watchlist promotion/demotion
        hysteresis over the digest's top-K."""
        now = time.time() if now is None else now
        d = sketch.decode_digest(digest)
        with self._lock:
            if d is None:
                if self._faults is not None:
                    self._faults.inc("stale_digests")
                return False
            last = self._digests.get(node_id)
            if last is not None and (d["t"], d["seq"]) \
                    <= (last["t"], last["seq"]):
                if self._faults is not None:
                    self._faults.inc("stale_digests")
                return False
            self._digests[node_id] = d
            for rec in d.get("transitions") or []:
                if isinstance(rec, dict) and rec.get("client"):
                    self.transitions.append(
                        {**rec, "via": node_id})
            # -- watchlist maintenance ---------------------------------------
            mentioned: set = set()
            for w in d.get("worst") or []:
                cid = w.get("client")
                if not cid:
                    continue
                mentioned.add(cid)
                self._promote_from_view(cid, w, node_id, now)
            for rec in d.get("transitions") or []:
                cid = rec.get("client")
                if cid:
                    # a transition names the client but carries no
                    # view; promotion happens on its next top-K
                    # mention — resetting the miss counter here keeps
                    # a transitioning client from demoting mid-event
                    mentioned.add(cid)
            for cid, h in list(self._clients.items()):
                if h.via != node_id:
                    continue
                if cid in mentioned:
                    self._watch_miss.pop(cid, None)
                    continue
                miss = self._watch_miss[cid] = \
                    self._watch_miss.get(cid, 0) + 1
                # demotion hysteresis, WATCH_DEMOTE_MISSES consecutive
                # unmentioned digests.  build_digest ranks EVERY
                # client into its worst heap, so a still-straggler/
                # lost client keeps being mentioned — sustained
                # absence means the client now ranks healthier than
                # the node's top-K, and keeping the STALE severe copy
                # would freeze a recovered client in straggler/lost
                # (the scheduler would act on fiction, and the cap
                # would preferentially retain exactly these).  Pinned
                # entries stay (scheduler attention needs to SEE the
                # recovery) but their state resets to healthy.
                if miss >= self.WATCH_DEMOTE_MISSES:
                    if cid in self._pinned:
                        h.state = "healthy"
                        h.score = None
                        self._watch_miss.pop(cid, None)
                    else:
                        del self._clients[cid]
                        self._watch_miss.pop(cid, None)
            self._enforce_watchlist_cap()
            self._set_digest_gauges()
            return True

    def _promote_from_view(self, cid: str, entry: dict, node_id: str,
                           now: float) -> None:
        """Seed/refresh a watchlist entry from a digest's top-K view
        (the node runs the state machine; this is the server's exact
        copy)."""
        view = entry.get("view") or {}
        h = self._ensure(cid, now)
        h.via = node_id
        h.state = entry.get("state", h.state)
        if entry.get("score") is not None:
            h.score = entry["score"]
        h.kind = view.get("kind", h.kind) or "client"
        if view.get("stage") is not None:
            h.stage = int(view["stage"])
        if view.get("samples_per_s") is not None:
            h.rate = float(view["samples_per_s"])
        if view.get("samples") is not None:
            h.samples = int(view["samples"])
        if view.get("round") is not None:
            h.round = view["round"]
        if view.get("counters"):
            h.counters = dict(view["counters"])
        if view.get("gauges"):
            h.gauges = dict(view["gauges"])
        if view.get("latency"):
            h.latency = dict(view["latency"])
        if view.get("age_s") is not None:
            h.last_seen = max(h.last_seen, now - float(view["age_s"]))
        else:
            h.last_seen = max(h.last_seen, now)
        self._watch_miss.pop(cid, None)

    def _enforce_watchlist_cap(self) -> None:
        """Hard bound: the least-severe unpinned digest-sourced
        entries are dropped first (deterministic: severity, then id).
        Pinned entries never count against others — they ARE the
        scheduler's attention set."""
        watch = [(cid, h) for cid, h in self._clients.items()
                 if h.via is not None and cid not in self._pinned]
        over = len(watch) - max(0, self.watchlist_size)
        if over <= 0:
            return
        watch.sort(key=lambda kv: sketch._worst_key(
            {"client": kv[0], "state": kv[1].state,
             "score": kv[1].score}))
        for cid, _ in watch[len(watch) - over:]:
            del self._clients[cid]
            self._watch_miss.pop(cid, None)

    def _set_digest_gauges(self) -> None:
        self.gauges.set("fleet_digest_nodes", len(self._digests))
        self.gauges.set("fleet_digest_clients",
                        sum(int(d.get("clients", 0))
                            for d in self._digests.values()))
        self.gauges.set("fleet_watchlist",
                        sum(1 for h in self._clients.values()
                            if h.via is not None))

    def drop_digest(self, node_id: str,
                    now: float | None = None) -> None:
        """Digest-node fallback (server side): forget the node's
        standing digest and convert its watchlist views to DIRECT
        entries with a fresh liveness grace — their heartbeats were
        parked on the dead node's queue, not missing, and they are
        about to resume beating here."""
        now = time.time() if now is None else now
        with self._lock:
            self._digests.pop(node_id, None)
            for cid, h in self._clients.items():
                if h.via == node_id:
                    h.via = None
                    h.last_seen = max(h.last_seen, now)
                    self._watch_miss.pop(cid, None)
            self._set_digest_gauges()

    def digest_totals(self) -> dict | None:
        """The merged cross-node digest (None when no node reported
        yet): exact state counts / counter sums / samples over every
        digest-covered client, sketch-merged quantiles, re-ranked
        worst-K."""
        with self._lock:
            if not self._digests:
                return None
            return sketch.merge_digests(
                [self._digests[n] for n in sorted(self._digests)],
                k=self.DIGEST_TOP_K)

    def build_digest(self, node_id: str, seq: int,
                     now: float | None = None,
                     k: int | None = None) -> dict:
        """One digest of THIS monitor's clients — the node side of the
        roll-up (a remote aggregator node's digest worker).  Callers should
        :meth:`advance` first so states are current.  Transitions are
        reported exactly once across successive digests (the ``i``
        cursor); per-client views ride only the top-K entries."""
        now = time.time() if now is None else now
        k = self.DIGEST_TOP_K if k is None else int(k)
        with self._lock:
            d = sketch.empty_digest()
            d.update({"node": node_id, "t": round(now, 3),
                      "seq": int(seq)})
            rate, crate = sketch.ValueSketch(), sketch.ValueSketch()
            worst = sketch.WorstK(k)
            states: dict[str, int] = {}
            counters: dict[str, int] = {}
            stages: dict[str, dict] = {}
            samples = 0
            for cid, h in self._clients.items():
                if h.kind != "client":
                    continue   # nodes never digest other nodes
                d["clients"] += 1
                states[h.state] = states.get(h.state, 0) + 1
                samples += int(h.samples)
                for name, v in h.counters.items():
                    if isinstance(v, (int, float)):
                        counters[name] = counters.get(name, 0) + int(v)
                rate.observe(h.rate)
                cr = h.gauges.get("compute_samples_per_s")
                crate.observe(cr)
                step = (h.latency.get("step_device")
                        or h.latency.get("step") or {})
                if h.stage is not None:
                    ent = stages.setdefault(str(h.stage), {
                        "n": 0, "crate": sketch.ValueSketch(),
                        "step_ms": sketch.ValueSketch()})
                    ent["n"] += 1
                    ent["crate"].observe(cr)
                    ent["step_ms"].observe(step.get("p95_ms"))
                worst.add(cid, h.state, h.score,
                          view=self._digest_view(h, now))
            d["states"] = states
            d["counters"] = counters
            d["samples"] = samples
            d["rate"] = rate.as_dict()
            d["crate"] = crate.as_dict()
            d["stages"] = {
                st: {"n": e["n"], "crate": e["crate"].as_dict(),
                     "step_ms": e["step_ms"].as_dict()}
                for st, e in sorted(stages.items())}
            d["worst"] = worst.top()
            d["transitions"] = [
                t for t in self.transitions
                if t.get("i", 0) > self._digest_mark]
            if d["transitions"]:
                self._digest_mark = max(t.get("i", 0)
                                        for t in d["transitions"])
            return d

    @staticmethod
    def _digest_view(h: _ClientHealth, now: float) -> dict:
        """The compact per-client view riding a digest's top-K entry —
        what the server needs to seed a watchlist state machine."""
        step = (h.latency.get("step_device")
                or h.latency.get("step") or {})
        return {
            "kind": h.kind, "stage": h.stage,
            "samples_per_s": h.rate, "samples": h.samples,
            "round": h.round, "age_s": round(max(0.0, now
                                                 - h.last_seen), 3),
            "counters": dict(h.counters),
            "gauges": dict(h.gauges),
            "latency": ({"step_device": dict(step)} if step else {}),
        }

    # -- state machine -------------------------------------------------------

    def _transition(self, cid: str, h: _ClientHealth, to: str,
                    why: str, now: float) -> None:
        if h.state == to:
            return
        self._tx_seq += 1
        rec = {"t": round(now, 3), "client": cid, "from": h.state,
               "to": to, "why": why, "i": self._tx_seq}
        h.state = to
        self.transitions.append(rec)
        if to == "lost" and self.on_lost is not None:
            try:
                self.on_lost(cid)
            except Exception:  # noqa: BLE001 — pruning is best-effort;
                pass           # a hook bug must not kill the monitor
        if self._log is not None:
            line = (f"fleet: {cid} {rec['from']} -> {to} ({why})")
            if to == "healthy":
                self._log.info(line, "green")
            else:
                self._log.warning(line)

    @staticmethod
    def _rate_why(h: _ClientHealth, cmed: float | None) -> str:
        """Attribute a rate-scored straggler transition: a client whose
        COMPUTE rate (samples over device-busy seconds, perf-plane
        gauge) also trails the fleet is compute-slow; one whose compute
        rate is healthy is losing its round to the wire."""
        crate = h.gauges.get("compute_samples_per_s")
        if not crate or not cmed:
            return ""
        if crate < FleetMonitor.STRAGGLER_SCORE * cmed:
            return (f" (compute-slow: {crate:.1f}/s device rate vs "
                    f"fleet {cmed:.1f}/s)")
        return (f" (wire-slow: device rate healthy at {crate:.1f}/s)")

    def advance(self, now: float | None = None) -> frozenset:
        """Re-evaluate every client's time/rate-driven transitions;
        returns the current ``lost`` set (what barriers may drop)."""
        now = time.time() if now is None else now
        with self._lock:
            # pump-freshness gate (see note_pump): a stale pump means
            # silence is unmeasurable — freeze downgrades, keep the
            # standing lost set, still let resumed contact recover
            pumping = (self._last_pump is None
                       or now - self._last_pump
                       <= max(2 * self.interval, 1.0))
            # rate scoring covers TRAINING clients only: an aggregator
            # node's samples/s is structurally 0 — including it would
            # both drag the fleet median and flag the node straggler
            # for doing its job (liveness transitions still apply)
            rates = [h.rate for h in self._clients.values()
                     if h.rate and h.state != "lost"
                     and h.kind == "client"]
            med = statistics.median(rates) if rates else None
            # compute-rate median (perf-plane gauge riding heartbeats):
            # the second axis that tells a compute-slow straggler from
            # a wire-slow one in the transition journal
            crates = [h.gauges.get("compute_samples_per_s")
                      for h in self._clients.values()
                      if h.gauges.get("compute_samples_per_s")
                      and h.state != "lost"]
            cmed = statistics.median(crates) if crates else None
            if self._digests:
                # digest mode: the exact population here is the
                # watchlist + direct reporters — a biased slice (the
                # worst clients).  The fleet median must come from the
                # WHOLE fleet's sketches, or every watchlist member
                # would score against its own cohort.
                rsk, csk = sketch.ValueSketch(), sketch.ValueSketch()
                for d in self._digests.values():
                    rsk.merge(d.get("rate"))
                    csk.merge(d.get("crate"))
                for h in self._clients.values():
                    if h.via is None and h.kind == "client" \
                            and h.state != "lost":
                        rsk.observe(h.rate)
                        cr = h.gauges.get("compute_samples_per_s")
                        csk.observe(cr)
                med = rsk.quantile(50) or med
                cmed = csk.quantile(50) or cmed
            lost = set()
            for cid, h in self._clients.items():
                if h.via is not None:
                    # watchlist entry: its liveness clock and state
                    # machine run on the digest node — aging it here
                    # against a clock nobody feeds would mint phantom
                    # `lost` states.  Its score still updates (the
                    # fleet median moved), and a node-reported `lost`
                    # joins the droppable set.
                    h.score = (round(h.rate / med, 4)
                               if med and h.rate is not None
                               and h.kind == "client" else h.score)
                    if h.state == "lost":
                        lost.add(cid)
                    continue
                age = now - h.last_seen
                h.score = (round(h.rate / med, 4)
                           if med and h.rate is not None
                           and h.kind == "client" else None)
                if not pumping:
                    pass
                elif age > self.liveness_timeout:
                    self._transition(
                        cid, h, "lost",
                        f"silent {age:.1f}s > liveness-timeout "
                        f"{self.liveness_timeout:g}s", now)
                elif h.state == "lost":
                    # contact resumed since the last advance
                    self._transition(cid, h, "degraded",
                                     "contact resumed", now)
                elif age > self.STRAGGLER_MISSES * self.interval:
                    self._transition(
                        cid, h, "straggler",
                        f"wire-silent: missed heartbeats "
                        f"({age:.1f}s silent)", now)
                elif age > self.DEGRADED_MISSES * self.interval:
                    if h.state == "healthy":
                        self._transition(cid, h, "degraded",
                                         "missed a heartbeat", now)
                elif (self._lag(h) is not None
                        and self._lag(h) >= self.STALE_LAG):
                    # async staleness: the client is alive and may even
                    # be fast, but its contributions fold STALE_LAG+
                    # versions behind the fleet — a distinct straggler
                    # cause from compute-slow / wire-slow
                    self._transition(
                        cid, h, "straggler",
                        f"stale: version lag {self._lag(h)} behind "
                        f"v{self._version}", now)
                elif (h.score is not None
                        and h.score < self.STRAGGLER_SCORE
                        and len(rates) >= 2):
                    self._transition(
                        cid, h, "straggler",
                        f"rate {h.rate:.1f}/s is {h.score:.2f}x the "
                        "fleet median" + self._rate_why(h, cmed), now)
                elif h.state in ("degraded", "straggler"):
                    if (h.score is None
                            or h.score >= self.RECOVER_SCORE):
                        self._transition(cid, h, "healthy",
                                         "heartbeats + rate recovered",
                                         now)
                if h.state == "lost":
                    lost.add(cid)
            counts = self._counts_locked()
            self.gauges.set("fleet_size", sum(counts.values()))
            self.gauges.set("fleet_healthy", counts.get("healthy", 0))
            self.gauges.set("fleet_degraded", counts.get("degraded", 0))
            self.gauges.set("fleet_straggler",
                            counts.get("straggler", 0))
            self.gauges.set("fleet_lost", counts.get("lost", 0))
            return frozenset(lost)

    def _counts_locked(self) -> collections.Counter:
        """Per-state fleet counts, EXACT under the digest roll-up: the
        digests' per-state counts (each node's exact state machine
        over its clients) plus the direct reporters.  Watchlist
        entries are VIEWS of digest-covered clients — counting them
        here would double-count against their node's digest."""
        counts = collections.Counter(
            h.state for h in self._clients.values() if h.via is None)
        for d in self._digests.values():
            for s, n in (d.get("states") or {}).items():
                counts[s] += int(n)
        return counts

    # -- views ---------------------------------------------------------------

    def lost(self) -> frozenset:
        with self._lock:
            return frozenset(c for c, h in self._clients.items()
                             if h.state == "lost")

    def state(self, cid: str) -> str | None:
        with self._lock:
            h = self._clients.get(cid)
            return h.state if h else None

    def states(self) -> dict:
        with self._lock:
            return {c: h.state for c, h in self._clients.items()}

    def tracked_clients(self) -> int:
        """Exact per-client entries held (direct + watchlist) — the
        count the exporter compares against max-client-series to pick
        the /fleet default shape."""
        with self._lock:
            return len(self._clients)

    def _view_of(self, cid: str, h: _ClientHealth, now: float,
                 series: bool) -> dict:
        rtt = (h.latency.get("frame_rtt") or {})
        step = (h.latency.get("step_device")
                or h.latency.get("step") or {})
        out = {
            "state": h.state,
            "kind": h.kind,
            "stage": h.stage,
            # the digest node whose roll-up sourced this entry
            # (watchlist member), None for direct reporters
            "via": h.via,
            "age_s": round(max(0.0, now - h.last_seen), 3),
            "round": h.round,
            "samples": h.samples,
            "samples_per_s": h.rate,
            "straggler_score": h.score,
            # async staleness signal: versions behind the
            # server's current cut (None outside async / before
            # the first Update)
            "version_lag": self._lag(h),
            "rtt_p95_ms": rtt.get("p95_ms"),
            "wire_bytes_out": h.wire.get("bytes_out_total"),
            # perf-plane gauges, ridden in on
            # heartbeats; absent for clients predating the
            # plane — consumers render "-"
            "mfu": h.gauges.get("mfu"),
            "step_p95_ms": step.get("p95_ms"),
            "compute_samples_per_s":
                h.gauges.get("compute_samples_per_s"),
            "hbm_peak_bytes": h.gauges.get("hbm_peak_bytes"),
            # MPMD stage pipeline (pipeline.remote): a later-stage
            # client's ingest backlog and a stage host's slot count;
            # absent for pre-plane participants — consumers render "-"
            "queue_depth": h.gauges.get("queue_depth"),
            "stage_slots": h.gauges.get("stage_slots"),
            # flight-recorder health, ridden in
            # on heartbeats: ring depth and seconds since the last
            # dump (-1 = never dumped); absent when the recorder is
            # off — consumers render "-"
            "blackbox_ring_depth": h.gauges.get("blackbox_ring_depth"),
            "blackbox_last_dump_age_s":
                h.gauges.get("blackbox_last_dump_age_s"),
            "counters": dict(h.counters),
        }
        if series:
            out["series"] = [list(x) for x in h.series][-32:]
        return out

    def _stages_locked(self, totals: dict | None) -> dict:
        """Per-stage measured stats (the kind=perf plane rolled up
        fleet-wide): client count, compute-rate and step-wall p50/p95
        from the direct reporters' latest snapshots merged with the
        digests' per-stage sketches — what the scheduler's cut
        re-planner reads instead of mirroring stage-1 profiles."""
        stages: dict[str, dict] = {}
        for h in self._clients.values():
            if h.kind != "client" or h.stage is None \
                    or h.via is not None:
                continue
            ent = stages.setdefault(str(h.stage), {
                "n": 0, "crate": sketch.ValueSketch(),
                "step_ms": sketch.ValueSketch()})
            ent["n"] += 1
            ent["crate"].observe(h.gauges.get("compute_samples_per_s"))
            step = (h.latency.get("step_device")
                    or h.latency.get("step") or {})
            ent["step_ms"].observe(step.get("p95_ms"))
        for st, sd in ((totals or {}).get("stages") or {}).items():
            ent = stages.setdefault(str(st), {
                "n": 0, "crate": sketch.ValueSketch(),
                "step_ms": sketch.ValueSketch()})
            ent["n"] += int(sd.get("n", 0))
            ent["crate"].merge(sd.get("crate"))
            ent["step_ms"].merge(sd.get("step_ms"))
        out = {}
        for st, ent in sorted(stages.items(), key=lambda kv: kv[0]):
            crate, step_ms = ent["crate"], ent["step_ms"]
            out[st] = {
                "n": ent["n"],
                "compute_samples_per_s_p50": crate.quantile(50),
                "compute_samples_per_s_p95": crate.quantile(95),
                "step_p95_ms_p50": step_ms.quantile(50),
                "step_p95_ms_p95": step_ms.quantile(95),
            }
        return out

    def snapshot(self, now: float | None = None, *,
                 series: bool = True, page: int | None = None,
                 per_page: int = 256,
                 client: str | None = None) -> dict:
        """The ``/fleet`` JSON view (also the ``kind=fleet`` metrics
        record): per-client state/rate/score/age + the latest
        counter/wire snapshots each heartbeat flushed (so a client
        that crashes mid-round loses at most one interval of
        counters), recent transitions, and state counts.

        Under the digest roll-up the per-client block holds only the
        EXACT population (direct reporters + the bounded watchlist);
        everyone else is summarized in the ``digest`` block (exact
        counts/counter sums, quantile sketches, per-node summary).
        ``series=False`` drops the ring-buffer series (the summary
        shape); ``page`` (0-based, ``per_page`` ids per page) pages
        the per-client block; ``client`` restricts it to one id."""
        now = time.time() if now is None else now
        with self._lock:
            ids = sorted(self._clients)
            total_ids = len(ids)
            if client is not None:
                ids = [c for c in ids if c == client]
            elif page is not None:
                per_page = max(1, int(per_page))
                ids = ids[page * per_page:(page + 1) * per_page]
            clients = {cid: self._view_of(cid, self._clients[cid],
                                          now, series)
                       for cid in ids}
            counts = self._counts_locked()
            totals = (sketch.merge_digests(
                [self._digests[n] for n in sorted(self._digests)],
                k=self.DIGEST_TOP_K) if self._digests else None)
            out = {
                "t": round(now, 3),
                "heartbeat_interval_s": self.interval,
                "liveness_timeout_s": self.liveness_timeout,
                "counts": {s: counts.get(s, 0) for s in HEALTH_STATES},
                "clients": clients,
                "transitions": list(self.transitions)[-64:],
            }
            stages = self._stages_locked(totals)
            if stages:
                out["stages"] = stages
            if page is not None or client is not None:
                out["paging"] = {
                    "page": page, "per_page": per_page,
                    "tracked_clients": total_ids,
                    "pages": -(-total_ids // max(1, per_page))}
            if totals is not None:
                # worst entries carry full views on the wire (watchlist
                # seeding); the JSON summary only needs the ranking
                out["digest"] = {
                    "nodes": {
                        nid: {"t": d.get("t"), "seq": d.get("seq"),
                              "clients": d.get("clients"),
                              "states": d.get("states")}
                        for nid, d in sorted(self._digests.items())},
                    "clients": totals.get("clients", 0),
                    "states": totals.get("states"),
                    "counters": totals.get("counters"),
                    "samples": totals.get("samples"),
                    "quantiles": sketch.digest_quantiles(totals),
                    "worst": [{k: w.get(k) for k in
                               ("client", "state", "score")}
                              for w in totals.get("worst") or []],
                }
                out["watchlist"] = sorted(
                    cid for cid, h in self._clients.items()
                    if h.via is not None)
            return out


# --------------------------------------------------------------------------
# Prometheus text-format exposition
# --------------------------------------------------------------------------

def _esc(v: Any) -> str:
    """Escape one label value per the text-format spec."""
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


#: perf-plane gauge -> dedicated /metrics family (the help texts are
#: the JAX package's, byte for byte, so the two pages compare equal):
#: (gauge name, metric name, type, help)
_PERF_FAMILIES = (
    ("mfu", "sl_mfu", "gauge",
     "Model-FLOPs utilization vs the datasheet bf16 peak."),
    ("step_seconds", "sl_step_seconds", "gauge",
     "Wall seconds of the last sampled (device-fenced) step."),
    ("hbm_peak_bytes", "sl_hbm_peak_bytes", "gauge",
     "Peak device memory bytes observed this round."),
    ("compile_seconds_total", "sl_compile_seconds_total", "counter",
     "Cumulative XLA compile wall-clock seconds."),
    # streaming aggregation plane (runtime/aggregate.py): host bytes
    # pinned by the delta codec's per-client shadow trees — what the
    # fleet-monitor `lost` prune and the elastic prune reclaim
    ("agg_shadow_bytes", "sl_agg_shadow_bytes", "gauge",
     "Host bytes pinned by per-client delta-codec shadow trees."),
)


def _sample(name: str, labels: dict, value: Any) -> str:
    if labels:
        body = ",".join(f'{k}="{_esc(v)}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {value}"
    return f"{name} {value}"


def _series_order_key(item: tuple) -> tuple:
    """Cap ordering for per-client /metrics series, worst first:
    watchlist members (digest-sourced exact views) before direct
    reporters, then state severity, then straggler score, then id —
    so a bounded scrape always shows the clients that need looking
    at."""
    cid, c = item
    score = c.get("straggler_score")
    return (0 if c.get("via") else 1,
            -_STATE_CODE.get(c.get("state", "healthy"), 0),
            score if score is not None else math.inf,
            cid)


def render_prometheus(fleet: FleetMonitor | None = None, faults=None,
                      wire=None, hists=None,
                      gauges: GaugeSet | None = None,
                      max_client_series: int | None = None) -> str:
    """One ``/metrics`` page: process counters/gauges/latency digests
    plus the per-client fleet view.  Pure string building — safe to
    call from the exporter's HTTP threads mid-round.

    ``max_client_series`` bounds the per-client ``sl_client_*``
    cardinality (``observability.max-client-series``): when the exact
    population exceeds it, the watchlist/worst clients render first
    (:func:`_series_order_key`) and the rest are summarized by the
    fleet-level families (``sl_fleet_clients``,
    ``sl_fleet_rate_quantile``) — a 100k-client scrape stays the size
    of a 256-client one."""
    out: list[str] = []

    def family(name: str, kind: str, help_: str, samples: list):
        if not samples:
            return
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {kind}")
        out.extend(samples)

    if faults is not None:
        fsnap = faults.snapshot()
        family("sl_faults_total", "counter",
               "Cumulative fault/recovery counters (runtime/trace.py).",
               [_sample("sl_faults_total", {"name": k}, v)
                for k, v in sorted(fsnap.items())])
        family("sl_retraces_total", "counter",
               "Compiles observed after round 0 (runtime/perf.py "
               "CompileWatch — the live JX004 retrace rule).",
               [_sample("sl_retraces_total", {},
                        fsnap.get("retraces", 0))])
    if wire is not None:
        w = wire.snapshot()
        family("sl_wire_bytes_total", "counter",
               "Cumulative wire bytes by direction.",
               [_sample("sl_wire_bytes_total", {"direction": "out"},
                        w.get("bytes_out_total", 0)),
                _sample("sl_wire_bytes_total", {"direction": "in"},
                        w.get("bytes_in_total", 0))])
        family("sl_wire_messages_total", "counter",
               "Cumulative wire messages by direction.",
               [_sample("sl_wire_messages_total", {"direction": "out"},
                        w.get("msgs_out", 0)),
                _sample("sl_wire_messages_total", {"direction": "in"},
                        w.get("msgs_in", 0))])
    if gauges is not None:
        gsnap = gauges.snapshot()
        family("sl_gauge", "gauge",
               "Last-value gauges (runtime/trace.py GAUGE_NAMES).",
               [_sample("sl_gauge", {"name": k}, v)
                for k, v in sorted(gsnap.items())
                if k in GAUGE_NAMES and _finite(v)])
        # perf-plane gauges additionally published under dedicated
        # names (the compute half of the compute/wire ratio the
        # scheduler consumes)
        for gname, mname, kind, help_ in _PERF_FAMILIES:
            v = gsnap.get(gname)
            if v is not None and _finite(v):
                family(mname, kind, help_, [_sample(mname, {}, v)])
    if hists is not None:
        h = hists.snapshot()
        q_samples, n_samples = [], []
        for name, digest in sorted(h.items()):
            for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                           ("0.99", "p99_ms")):
                ms = digest.get(key)
                if ms is not None:
                    q_samples.append(_sample(
                        "sl_latency_seconds",
                        {"name": name, "quantile": q}, ms / 1e3))
            n_samples.append(_sample("sl_latency_observations_total",
                                     {"name": name},
                                     digest.get("count", 0)))
        family("sl_latency_seconds", "summary",
               "Latency digests (log-spaced fixed buckets).", q_samples)
        family("sl_latency_observations_total", "counter",
               "Observations per latency histogram.", n_samples)
    if fleet is not None:
        snap = fleet.snapshot(series=False)
        by_state = [_sample("sl_fleet_clients", {"state": s}, n)
                    for s, n in sorted(snap["counts"].items())]
        family("sl_fleet_clients", "gauge",
               "Clients per health state (exact under the digest "
               "roll-up).", by_state)
        dig = snap.get("digest")
        if dig:
            family("sl_fleet_digest_nodes", "gauge",
                   "Aggregator nodes reporting FleetDigest roll-ups.",
                   [_sample("sl_fleet_digest_nodes", {},
                            len(dig.get("nodes") or {}))])
            family("sl_fleet_digest_clients", "gauge",
                   "Clients covered by digest roll-ups (exact state "
                   "lives on their aggregator node).",
                   [_sample("sl_fleet_digest_clients", {},
                            dig.get("clients", 0))])
            q_samples = []
            for key, v in sorted((dig.get("quantiles")
                                  or {}).items()):
                field, _, q = key.rpartition("_p")
                name = ("sl_fleet_rate_quantile"
                        if field == "rate"
                        else "sl_fleet_compute_rate_quantile")
                if _finite(v):
                    q_samples.append((name,
                                      _sample(name,
                                              {"quantile":
                                               f"0.{q}"}, v)))
            for name, help_ in (
                    ("sl_fleet_rate_quantile",
                     "Fleet-wide samples/s quantiles from the merged "
                     "digest sketch (error <= one 2^0.25 bucket)."),
                    ("sl_fleet_compute_rate_quantile",
                     "Fleet-wide device-rate quantiles from the "
                     "merged digest sketch.")):
                family(name, "gauge", help_,
                       [s for n, s in q_samples if n == name])
        items = sorted(snap["clients"].items())
        if max_client_series is not None \
                and len(items) > max_client_series:
            capped = sorted(items, key=_series_order_key)
            items = sorted(capped[:max_client_series])
        family("sl_fleet_client_series", "gauge",
               "Per-client series rendered below (bounded by "
               "observability.max-client-series; the rest live in "
               "the fleet-level families).",
               [_sample("sl_fleet_client_series", {}, len(items))])
        up, code, rate, score, age = [], [], [], [], []
        mfu, crate, vlag = [], [], []
        for cid, c in items:
            lbl = {"client": cid}
            up.append(_sample("sl_client_up", lbl,
                              0 if c["state"] == "lost" else 1))
            code.append(_sample("sl_client_state_code", lbl,
                                _STATE_CODE[c["state"]]))
            if c["samples_per_s"] is not None:
                rate.append(_sample("sl_client_samples_per_second",
                                    lbl, c["samples_per_s"]))
            if c["straggler_score"] is not None:
                score.append(_sample("sl_client_straggler_score", lbl,
                                     c["straggler_score"]))
            if c.get("version_lag") is not None:
                vlag.append(_sample("sl_client_version_lag", lbl,
                                    c["version_lag"]))
            if c.get("mfu") is not None:
                mfu.append(_sample("sl_client_mfu", lbl, c["mfu"]))
            if c.get("compute_samples_per_s") is not None:
                crate.append(_sample(
                    "sl_client_compute_samples_per_second", lbl,
                    c["compute_samples_per_s"]))
            age.append(_sample("sl_client_heartbeat_age_seconds", lbl,
                               c["age_s"]))
        family("sl_client_up", "gauge",
               "1 unless the client is health-state lost.", up)
        family("sl_client_state_code", "gauge",
               "0=healthy 1=degraded 2=straggler 3=lost.", code)
        family("sl_client_samples_per_second", "gauge",
               "EWMA training throughput per client.", rate)
        family("sl_client_straggler_score", "gauge",
               "Client rate / fleet median (lower is slower).", score)
        family("sl_client_version_lag", "gauge",
               "Versions behind the server's current cut "
               "(async bounded-staleness mode).", vlag)
        family("sl_client_mfu", "gauge",
               "Per-client model-FLOPs utilization (perf plane).", mfu)
        family("sl_client_compute_samples_per_second", "gauge",
               "Per-client samples/s over device-busy time.", crate)
        family("sl_client_heartbeat_age_seconds", "gauge",
               "Seconds since the last fresh frame.", age)
    return "\n".join(out) + ("\n" if out else "")


_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_TYPES = ("counter", "gauge", "summary", "histogram", "untyped")


def _finite(v) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


def _parse_labels(body: str) -> dict | None:
    """Parse ``k="v",...`` with escape handling; None on bad syntax."""
    labels: dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        j = body.find("=", i)
        if j < 0:
            return None
        name = body[i:j]
        if not _LABEL_NAME_RE.match(name):
            return None
        if j + 1 >= n or body[j + 1] != '"':
            return None
        i = j + 2
        val = []
        while i < n and body[i] != '"':
            if body[i] == "\\":
                if i + 1 >= n or body[i + 1] not in ('\\', '"', 'n'):
                    return None
                val.append(body[i:i + 2])
                i += 2
            else:
                val.append(body[i])
                i += 1
        if i >= n:            # unterminated value
            return None
        i += 1                # closing quote
        if name in labels:
            return None       # duplicate label name
        labels[name] = "".join(val)
        if i < n:
            if body[i] != ",":
                return None
            i += 1
    return labels


def lint_prometheus(text: str) -> list[str]:
    """Pure-python Prometheus text-format lint: metric/label name
    grammar, label-value escaping, float-parseable values, TYPE
    declared before a family's first sample, no duplicate series.
    Returns a list of errors (empty = parseable)."""
    errors: list[str] = []
    typed: set[str] = set()
    seen: set[tuple] = set()
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                if not _METRIC_NAME_RE.match(parts[2]):
                    errors.append(f"line {lineno}: bad metric name "
                                  f"{parts[2]!r} in {parts[1]}")
                if parts[1] == "TYPE":
                    if len(parts) < 4 or parts[3] not in _TYPES:
                        errors.append(f"line {lineno}: bad TYPE "
                                      f"{line!r}")
                    typed.add(parts[2])
            continue
        m = re.match(r"^([^\s{]+)(\{(.*)\})?\s+(\S+)(\s+-?\d+)?$", line)
        if m is None:
            errors.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name, _, label_body, value = m.group(1, 2, 3, 4)
        if not _METRIC_NAME_RE.match(name):
            errors.append(f"line {lineno}: bad metric name {name!r}")
            continue
        labels = _parse_labels(label_body) if label_body else {}
        if labels is None:
            errors.append(f"line {lineno}: bad label syntax "
                          f"{label_body!r}")
            continue
        if value not in ("NaN", "+Inf", "-Inf"):
            try:
                float(value)
            except ValueError:
                errors.append(f"line {lineno}: unparseable value "
                              f"{value!r}")
        base = re.sub(r"_(count|sum|bucket)$", "", name)
        if name not in typed and base not in typed:
            errors.append(f"line {lineno}: sample {name!r} has no "
                          "preceding # TYPE")
        key = (name, tuple(sorted(labels.items())))
        if key in seen:
            errors.append(f"line {lineno}: duplicate series {key}")
        seen.add(key)
    return errors


# --------------------------------------------------------------------------
# HTTP exporter
# --------------------------------------------------------------------------

class TelemetryExporter:
    """Stdlib HTTP thread serving ``/metrics`` (Prometheus text,
    ``text/plain; version=0.0.4``) and ``/fleet`` (JSON snapshot),
    plus ``POST /profile?steps=K`` when a ``profile_fn`` is wired (the
    perf plane's on-demand capture; without one the request gets 404).
    Callbacks run on the
    handler threads — keep them lock-cheap (the FleetMonitor/
    registries are all internally locked; ``arm`` only flips state)."""

    def __init__(self, metrics_fn: Callable[[], str],
                 fleet_fn: Callable[[], dict],
                 host: str = "127.0.0.1", port: int = 0,
                 profile_fn: Callable[[int], dict] | None = None):
        import http.server

        exporter = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API
                try:
                    path, _, query = self.path.partition("?")
                    if path == "/metrics":
                        body = exporter._metrics_fn().encode()
                        ctype = "text/plain; version=0.0.4"
                    elif path == "/fleet":
                        if exporter._fleet_wants_query:
                            import urllib.parse
                            q = {k: v[-1] for k, v in
                                 urllib.parse.parse_qs(query).items()}
                            snap = exporter._fleet_fn(q)
                        else:
                            snap = exporter._fleet_fn()
                        body = json.dumps(snap).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # noqa: BLE001 — a render bug
                    # must 500 the scrape, not kill the handler thread
                    self.send_error(500, str(e)[:100])
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 — stdlib API
                path, _, query = self.path.partition("?")
                if path != "/profile" or exporter._profile_fn is None:
                    self.send_error(404)
                    return
                try:
                    import urllib.parse
                    q = urllib.parse.parse_qs(query)
                    steps = int(q.get("steps", ["1"])[0])
                    body = json.dumps(
                        exporter._profile_fn(steps)).encode()
                except (ValueError, TypeError):
                    self.send_error(400, "steps must be an integer")
                    return
                except Exception as e:  # noqa: BLE001 — see do_GET
                    self.send_error(500, str(e)[:100])
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # scrapes must not spam stderr
                pass

        self._metrics_fn = metrics_fn
        self._fleet_fn = fleet_fn
        # a fleet_fn taking a parameter receives the query-string dict
        # (?full=1 / ?page=N / ?client=id — the summary-mode knobs);
        # zero-arg callables (tests, old callers) keep working
        import inspect
        try:
            self._fleet_wants_query = bool(
                inspect.signature(fleet_fn).parameters)
        except (TypeError, ValueError):
            self._fleet_wants_query = False
        self._profile_fn = profile_fn
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> "TelemetryExporter":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"telemetry-http-{self.port}")
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
