"""Runtime counters, latency histograms and the round loop's phase timer.

Port of the JAX package's ``runtime/trace.py`` as far as the round
tracing plane runs it:

* :class:`FaultCounters` — thread-safe failure and recovery counters
  (``drops``, ``redeliveries``, ``dedup_hits``, ``corrupt_rejected``,
  ...) shared by the transport stack, the codecs, the streaming fold and
  the aggregator tree, surfaced by the server and each client as
  ``kind=faults`` records;
* :class:`WireCounters` — bytes in and out per queue, encode and decode
  seconds and the async sender's queue high-water mark, surfaced as the
  server's ``kind=wire`` fields and each client's ``kind=wire_client``
  record;
* :class:`LatencyHistogram` / :class:`HistogramSet` — fixed-bucket
  (log-spaced) latency histograms for frame RTT, broker queue wait,
  reliable-envelope RTT, step time, encode/decode and the fold, surfaced
  as ``kind=latency`` records;
* :class:`StepTimer` — named wall-clock phase accumulators whose fence
  waits for the CUDA work behind the tensors it is given; the round loop
  writes its summary as ``phases`` in ``kind=round``;
* :data:`FAULT_COUNTER_NAMES` / :data:`HISTOGRAM_NAMES` /
  :data:`GAUGE_NAMES` — the declared name registries every
  ``.inc("...")``, ``.observe("...")`` and ``.set("...")`` literal is
  held to (a typo would silently mint a dead key); the gauges' registry
  is ``runtime/telemetry.py``'s ``GaugeSet``.

Not ported: the profiler capture (``trace`` / ``annotate``).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import math
import threading
import time

#: Declared registry of every FaultCounters name the runtime may
#: increment (the JAX package's set, name for name).
FAULT_COUNTER_NAMES = frozenset({
    # chaos injection (runtime/chaos.py)
    "drops", "duplicates", "reorders", "corruptions", "delays",
    "crashes", "late_drops",
    # reliable delivery (runtime/bus.py ReliableTransport)
    "redeliveries", "dedup_hits", "resequenced", "lost", "gave_up",
    "daemon_errors", "ack_send_failures", "corrupt_rejected",
    # transport plumbing
    "reconnects", "timeouts", "async_send_errors", "prefetch_errors",
    # live telemetry plane: heartbeat publishes that failed, stale
    # heartbeats, barrier waits cut short by `lost` clients
    "heartbeat_errors", "stale_heartbeats", "fleet_lost_drops",
    # hierarchical digest roll-up
    "stale_digests", "digest_fallbacks",
    # wire codecs (runtime/codec/)
    "quant_nonfinite", "topk_dense_fallbacks",
    "delta_folds", "delta_full_frames", "delta_resyncs",
    # compiles observed after round 0
    "retraces",
    # streaming aggregation plane (runtime/aggregate.py)
    "agg_dup_drops", "agg_stale_drops", "agg_l1_fallbacks",
    "agg_fallback_abandons",
    # multi-process aggregator tree, frame assembly
    "oversize_frames", "partial_codec_errors", "agg_node_deaths",
    # sync-mode round-boundary overlap
    "overlap_splices", "overlap_discards",
    # async bounded-staleness admission window (runtime/server.py)
    "agg_stale_admits", "agg_stale_updates",
    # closed-loop scheduler
    "sched_evictions", "sched_demotions", "sched_replans",
    "sched_barrier_drops", "sched_cluster_moves",
    "sched_knob_rejects",
    "sched_fanin_retunes",
    # MPMD cross-host stage pipeline
    "stage_host_deaths", "stage_reassigns",
})

#: Declared registry of latency-histogram names (same contract as
#: FAULT_COUNTER_NAMES, held on ``.observe("name", ...)`` sites).
HISTOGRAM_NAMES = frozenset({
    "frame_rtt",       # publish wire-context t_send -> consume decode
    "queue_wait",      # broker enqueue -> dequeue
    "transport_rtt",   # reliable envelope t_send -> receiver pop
    "step",            # one hot-loop training step (bwd+apply / window)
    "encode",          # frame encode (device fetch + TENSOR framing)
    "decode",          # frame decode (assembler feed)
    # per-step dispatch wall and dispatch+device wall of the sampled
    # step timer (the performance-attribution plane)
    "step_dispatch", "step_device",
    # wall of one contribution's fold into the running sum
    "agg_fold",
})

#: Declared registry of gauge names (``runtime/telemetry.py``
#: ``GaugeSet``; the JAX package's set, name for name).  Gauges hold the
#: last value set: a snapshot reports the current one.
GAUGE_NAMES = frozenset({
    # client-side (the hot loops and the heartbeat emitter)
    "round",           # current round index (set at SYN)
    "epoch",           # current local epoch within the round
    "inflight",        # stage-1 1F1B in-flight window depth
    "samples_per_s",   # EWMA training throughput (emitter tick)
    # the performance-attribution plane: model-FLOPs utilization, the
    # last sampled step's wall, peak device bytes, cumulative compile
    # wall, samples/s over device-busy time
    "mfu", "step_seconds", "hbm_peak_bytes", "compile_seconds_total",
    "compute_samples_per_s",
    # server-side (the FleetMonitor, on every advance)
    "fleet_size", "fleet_healthy", "fleet_degraded",
    "fleet_straggler", "fleet_lost",
    # host bytes pinned by the delta codec's per-client shadow trees
    "agg_shadow_bytes",
    # standalone aggregator nodes
    "agg_node_folded", "agg_node_ingress_bytes",
    "agg_node_egress_bytes", "agg_node_fold_s", "agg_node_groups",
    # the closed-loop scheduler
    "sched_decision_ms", "sched_clusters",
    # the hierarchical digest roll-up (runtime/sketch.py
    # DIGEST_GAUGE_NAMES)
    "fleet_digest_nodes", "fleet_digest_clients", "fleet_watchlist",
    # the sharded broker plane, swept from the shards' stats queues:
    # shards answering, and plane-wide sums of connections, live
    # queues, stored depth (and its high-water mark), parked gets and
    # wire bytes
    "broker_shards_up", "broker_conns", "broker_queues",
    "broker_depth", "broker_depth_hwm", "broker_parked_gets",
    "broker_bytes_in", "broker_bytes_out",
    # a later-stage client's ingest backlog, a stage host's slot count
    "queue_depth", "stage_slots",
    # the flight recorder's ring depth and last dump's age
    "blackbox_ring_depth", "blackbox_last_dump_age_s",
})


class FaultCounters:
    """Monotonic named counters; values never reset during a run, so
    consumers diff successive snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: collections.Counter = collections.Counter()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())


#: process-wide default registry: every participant created without an
#: explicit ``faults=`` counts here, so in one process the server sees
#: its clients' counters too
default_fault_counters = FaultCounters()


class WireCounters:
    """Thread-safe wire-traffic counters (monotonic like
    :class:`FaultCounters`): bytes sent and received per queue,
    cumulative encode and decode seconds, and the async sender-queue
    high-water mark.  Fed by ``runtime/bus.py`` ``AsyncTransport`` and
    the protocol roles' encode and decode sites."""

    #: queue-name prefixes classified as data-plane traffic
    _DATA_PREFIXES = ("intermediate_queue", "gradient_queue")

    def __init__(self):
        self._lock = threading.Lock()
        self._bytes_out: collections.Counter = collections.Counter()
        self._bytes_in: collections.Counter = collections.Counter()
        self._raw_bytes_out: collections.Counter = collections.Counter()
        self._msgs_out = 0
        self._msgs_in = 0
        self._encode_s = 0.0
        self._encode_n = 0
        self._decode_s = 0.0
        self._decode_n = 0
        self._send_queue_hwm = 0

    def count_out(self, queue: str, nbytes: int) -> None:
        with self._lock:
            self._bytes_out[queue] += nbytes
            self._msgs_out += 1

    def count_raw(self, queue: str, nbytes: int) -> None:
        """Pre-codec dense-equivalent bytes of a payload published on
        ``queue``: the denominator of the wire compression ratio.  Only
        codec paths count here, so zero means no codec was active."""
        with self._lock:
            self._raw_bytes_out[queue] += nbytes

    def count_in(self, queue: str, nbytes: int) -> None:
        with self._lock:
            self._bytes_in[queue] += nbytes
            self._msgs_in += 1

    def add_encode(self, seconds: float) -> None:
        with self._lock:
            self._encode_s += seconds
            self._encode_n += 1

    def add_decode(self, seconds: float) -> None:
        with self._lock:
            self._decode_s += seconds
            self._decode_n += 1

    def note_send_depth(self, depth: int) -> None:
        with self._lock:
            if depth > self._send_queue_hwm:
                self._send_queue_hwm = depth

    def per_queue(self) -> dict:
        with self._lock:
            return {"bytes_out": dict(self._bytes_out),
                    "bytes_in": dict(self._bytes_in)}

    def _data_bytes(self, counter) -> int:
        return sum(n for q, n in counter.items()
                   if q.startswith(self._DATA_PREFIXES))

    def snapshot(self) -> dict:
        """Flat record for metrics.jsonl (zero-valued fields included;
        callers prune)."""
        with self._lock:
            return {
                "bytes_out_total": sum(self._bytes_out.values()),
                "bytes_in_total": sum(self._bytes_in.values()),
                "raw_bytes_out": sum(self._raw_bytes_out.values()),
                "data_bytes_out": self._data_bytes(self._bytes_out),
                "data_bytes_in": self._data_bytes(self._bytes_in),
                "data_raw_bytes_out": self._data_bytes(
                    self._raw_bytes_out),
                "msgs_out": self._msgs_out,
                "msgs_in": self._msgs_in,
                "encode_s": round(self._encode_s, 6),
                "encode_n": self._encode_n,
                "decode_s": round(self._decode_s, 6),
                "decode_n": self._decode_n,
                "send_queue_hwm": self._send_queue_hwm,
            }


#: process-wide default, mirroring ``default_fault_counters``: a
#: participant whose transport carries no counters of its own (the bus
#: that the participants of one process share) counts here
default_wire_counters = WireCounters()


class LatencyHistogram:
    """Fixed-bucket latency histogram: log-spaced bounds from 1 µs to
    ~64 s (factor 2^0.25 per bucket, so a reported percentile is within
    ~19% of the true value), O(log buckets) per observe, thread-safe.
    Monotonic: never reset, consumers diff successive snapshots."""

    #: geometric bucket upper bounds (seconds); one overflow bucket past
    #: the last bound
    BOUNDS = tuple(1e-6 * (2 ** (i / 4)) for i in range(104))

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.BOUNDS) + 1)
        self._n = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, seconds: float) -> None:
        if not (seconds >= 0.0):     # NaN/negative: clock went backward
            seconds = 0.0
        i = bisect.bisect_left(self.BOUNDS, seconds)
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._sum += seconds
            if seconds > self._max:
                self._max = seconds

    def _bucket_value(self, i: int) -> float:
        """Representative value: geometric mean of the bucket's edges."""
        hi = self.BOUNDS[min(i, len(self.BOUNDS) - 1)]
        lo = self.BOUNDS[i - 1] if i > 0 else hi / (2 ** 0.25)
        return math.sqrt(lo * hi)

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) in seconds."""
        with self._lock:
            n = self._n
            if n == 0:
                return 0.0
            rank = max(1, math.ceil(n * q / 100.0))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    return min(self._bucket_value(i), self._max)
            return self._max

    def snapshot(self) -> dict:
        with self._lock:
            n = self._n
            if n == 0:
                return {}
            mean = self._sum / n
        return {"count": n, "mean_ms": round(mean * 1e3, 4),
                "p50_ms": round(self.percentile(50) * 1e3, 4),
                "p95_ms": round(self.percentile(95) * 1e3, 4),
                "p99_ms": round(self.percentile(99) * 1e3, 4),
                "max_ms": round(self._max * 1e3, 4)}


class HistogramSet:
    """Named latency histograms, created on first observe.  Names come
    from :data:`HISTOGRAM_NAMES`; snapshots go into metrics.jsonl as
    ``kind=latency`` records."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: dict[str, LatencyHistogram] = {}

    def hist(self, name: str) -> LatencyHistogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram()
            return h

    def observe(self, name: str, seconds: float) -> None:
        self.hist(name).observe(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            hists = list(self._hists.items())
        return {name: snap for name, h in hists
                if (snap := h.snapshot())}


#: process-wide default: layers with no per-participant registry in
#: reach (the broker's queue-wait clock, the reliable receiver's
#: envelope RTT) observe here, mirroring ``default_fault_counters``
default_histograms = HistogramSet()


def _fence(tree) -> None:
    """Wait for the CUDA work that produced the tensors in ``tree``: an
    event recorded on each of their devices' current streams (the stream
    this thread launched them on) is waited for.  CPU tensors and
    anything that is not a tensor need nothing."""
    import torch
    devices: set = set()

    def walk(x) -> None:
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class StepTimer:
    """Accumulates wall-clock per named phase; device-fenced."""

    def __init__(self):
        self.totals: dict = collections.defaultdict(float)
        self.counts: dict = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase.  The context yields a ``fence`` callable: pass
        it the tensors (or a tree of them) produced INSIDE the block and
        the clock stops only once the card has finished them, so
        asynchronous launches don't hide device time::

            with timer.phase("step") as fence:
                out = step(...)
                fence(out)
        """
        pending = []
        t0 = time.perf_counter()
        try:
            yield pending.append
        finally:
            for tree in pending:
                _fence(tree)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def record(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {"total_s": round(self.totals[name], 6),
                   "count": self.counts[name],
                   "mean_s": round(self.totals[name]
                                   / max(self.counts[name], 1), 6)}
            for name in sorted(self.totals)
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()
