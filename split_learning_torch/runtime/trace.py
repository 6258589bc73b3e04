"""Fault counters of the port's protocol runtime.

Port of the part of the JAX package's ``runtime/trace.py`` that the
protocol slice calls: :class:`FaultCounters` and the process-wide
:data:`default_fault_counters` (the codec counts ``quant_nonfinite``
there, the streaming fold ``agg_dup_drops``, the aggregator tree
``agg_stale_drops``, ``agg_l1_fallbacks``, ``agg_fallback_abandons`` and
``partial_codec_errors``, frame decoding ``corrupt_rejected`` and
``oversize_frames``).  Wire counters, latency
histograms, the step timer and the profiler hooks wait for the
observability slice.
"""

from __future__ import annotations

import collections
import threading


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


#: process-wide default registry: every participant created without an
#: explicit ``faults=`` counts here, so in one process the server sees
#: its clients' counters too
default_fault_counters = FaultCounters()
