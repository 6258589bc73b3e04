"""Mergeable fleet-health sketches: the digest path's data structures.

Port of the JAX package's ``runtime/sketch.py``, name for name (it is
plain Python and math; the port keeps its own copy).  Summaries that are

* **deterministic** — same inputs, same bytes, whatever the fold order;
* **mergeable** — ``merge(a, b)`` loses nothing a flat pass would keep
  (state counts and counter sums are exact; quantiles are exact up to
  the fixed bucket width);
* **bounded** — a digest's size depends on the bucket count and the
  top-K, never on the client count behind it.

Pieces:

* :class:`ValueSketch` — log-bucket quantile sketch over positive
  values, on the geometric grid of ``trace.py``'s
  :class:`~split_learning_torch.runtime.trace.LatencyHistogram`
  (factor ``2**0.25`` a bucket), so two sketches merge by adding counts
  and a reported quantile is within one bucket width (~19 %) of the
  true value however many merges happened;
* :class:`WorstK` — bounded worst-straggler list ordered by (health
  state severity, straggler score): the clients a merged digest still
  names individually;
* :func:`merge_digests` — fold any number of digest dicts into one,
  exact counts and sums, sketch-merged quantiles, worst-K re-truncated;
* :data:`DIGEST_COUNTER_NAMES` / :data:`DIGEST_GAUGE_NAMES` — the
  counter and gauge names the digest path mints, members of the
  ``runtime/trace.py`` registries.

The :class:`~split_learning_torch.runtime.telemetry.FleetMonitor` uses
the sketches for its per-stage roll-up and its ``snapshot`` even with
no digest in play.  A digest travels the wire as a plain dict, and
nothing here imports the protocol or a tensor library.
"""

from __future__ import annotations

import math
from typing import Any, Iterable

#: geometric bucket factor — 2**(1/_BUCKETS_PER_OCTAVE) per bucket,
#: matching trace.py LatencyHistogram's 2**0.25 spacing so the two
#: families quantize identically
_BUCKETS_PER_OCTAVE = 4

#: quantile sketch schema version (travels inside the digest dict)
SKETCH_V = 1

#: counters the digest path increments (members of
#: ``trace.FAULT_COUNTER_NAMES``):
#: duplicate/reordered FleetDigest frames the server rejected, and
#: clients re-pointed to direct heartbeats because their digest node
#: died
DIGEST_COUNTER_NAMES = frozenset({
    "stale_digests", "digest_fallbacks",
})

#: gauges the digest path sets (members of ``trace.GAUGE_NAMES``): live digest-reporting nodes, clients covered by digests,
#: and the server watchlist's current size
DIGEST_GAUGE_NAMES = frozenset({
    "fleet_digest_nodes", "fleet_digest_clients", "fleet_watchlist",
})


def bucket_index(value: float) -> int:
    """Bucket of a positive value: ``i`` covers
    ``[2**(i/4), 2**((i+1)/4))``.  Deterministic across platforms for
    the float range telemetry produces."""
    return math.floor(_BUCKETS_PER_OCTAVE * math.log2(value))


def bucket_value(i: int) -> float:
    """Representative value: geometric mean of the bucket's edges
    (same convention as ``LatencyHistogram._bucket_value``)."""
    lo = 2.0 ** (i / _BUCKETS_PER_OCTAVE)
    hi = 2.0 ** ((i + 1) / _BUCKETS_PER_OCTAVE)
    return math.sqrt(lo * hi)


class ValueSketch:
    """Log-bucket quantile sketch over positive values.

    Sparse: buckets are a ``{index: count}`` dict, so the footprint is
    the number of OCCUPIED buckets (a fleet whose rates span 6 orders
    of magnitude still costs ~80 entries).  Zero/negative/non-finite
    observations land in a dedicated ``zero`` bin that quantile
    queries rank below every positive bucket — an idle client is the
    worst rate, not a dropped sample.  NOT thread-safe: a sketch is
    built by one thread and merged by value."""

    __slots__ = ("counts", "zero", "n", "total")

    def __init__(self):
        self.counts: dict[int, int] = {}
        self.zero = 0          # observations <= 0 (or non-finite)
        self.n = 0             # total observations
        self.total = 0.0       # exact running sum (mean survives merge)

    def observe(self, value: float | None) -> None:
        if value is None:
            return
        v = float(value)
        self.n += 1
        if not math.isfinite(v) or v <= 0.0:
            self.zero += 1
            return
        self.total += v
        i = bucket_index(v)
        self.counts[i] = self.counts.get(i, 0) + 1

    def merge(self, other: "ValueSketch | dict | None") -> "ValueSketch":
        """Fold another sketch in (lossless: same bucket grid)."""
        if other is None:
            return self
        if isinstance(other, dict):
            o = ValueSketch.from_dict(other)
            if o is None:
                return self
            other = o
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.zero += other.zero
        self.n += other.n
        self.total += other.total
        return self

    def quantile(self, q: float) -> float | None:
        """Approximate q-th percentile (q in [0, 100]); None when
        empty.  Error is bounded by one bucket width (~19%)."""
        if self.n == 0:
            return None
        rank = max(1, math.ceil(self.n * q / 100.0))
        if rank <= self.zero:
            return 0.0
        cum = self.zero
        for i in sorted(self.counts):
            cum += self.counts[i]
            if cum >= rank:
                return bucket_value(i)
        return bucket_value(max(self.counts)) if self.counts else 0.0

    def mean(self) -> float | None:
        return self.total / self.n if self.n else None

    def as_dict(self) -> dict:
        """Wire form (plain builtins; bucket keys as strings so the
        dict survives JSON round-trips in metrics.jsonl)."""
        return {"v": SKETCH_V, "n": self.n, "zero": self.zero,
                "total": round(self.total, 6),
                "b": {str(i): c for i, c in sorted(self.counts.items())}}

    @classmethod
    def from_dict(cls, d: Any) -> "ValueSketch | None":
        """Tolerant decode: a foreign/garbage dict degrades to None,
        never raises into the server's rpc pump."""
        if not isinstance(d, dict):
            return None
        try:
            out = cls()
            out.n = int(d.get("n", 0))
            out.zero = int(d.get("zero", 0))
            out.total = float(d.get("total", 0.0))
            out.counts = {int(k): int(c)
                          for k, c in (d.get("b") or {}).items()}
            return out
        except (TypeError, ValueError):
            return None


# --------------------------------------------------------------------------
# worst-K straggler heap
# --------------------------------------------------------------------------

#: health states in severity order (mirrors telemetry.HEALTH_STATES —
#: re-declared here so this module stays import-light; the telemetry
#: tests assert the two agree)
_SEVERITY = {"healthy": 0, "degraded": 1, "straggler": 2, "lost": 3}


def _worst_key(entry: dict) -> tuple:
    """Sort key, worst first: higher state severity, then lower
    straggler score, then client id (the deterministic tiebreak)."""
    score = entry.get("score")
    return (-_SEVERITY.get(entry.get("state", "healthy"), 0),
            score if score is not None else math.inf,
            entry.get("client") or "")


class WorstK:
    """Bounded list of the K worst clients, each entry carrying enough
    of the client's last snapshot (``view``) for the server to seed an
    exact watchlist state machine from it.  Merging two WorstK's and
    truncating is associative and order-independent (ties broken by
    client id), and a duplicate client id keeps its WORST entry."""

    __slots__ = ("k", "entries")

    def __init__(self, k: int):
        self.k = max(0, int(k))
        self.entries: list[dict] = []

    def add(self, client: str, state: str, score: float | None,
            view: dict | None = None) -> None:
        self.entries.append({"client": client, "state": state,
                             "score": score, "view": view or {}})

    def merge(self, other: "WorstK | Iterable[dict] | None") -> "WorstK":
        if other is None:
            return self
        self.entries.extend(other.entries if isinstance(other, WorstK)
                            else list(other))
        return self

    def top(self) -> list[dict]:
        best: dict[str, dict] = {}
        for e in self.entries:
            cid = e.get("client")
            if not cid:
                continue
            cur = best.get(cid)
            if cur is None or _worst_key(e) < _worst_key(cur):
                best[cid] = e
        ranked = sorted(best.values(), key=_worst_key)
        return ranked[:self.k]


# --------------------------------------------------------------------------
# digest folding
# --------------------------------------------------------------------------

#: the sketch-valued fields of a digest dict
_SKETCH_FIELDS = ("rate", "crate")
#: bounded lengths of the list-valued digest fields after a merge
MAX_TRANSITIONS = 64


def empty_digest() -> dict:
    return {"v": 1, "node": None, "t": 0.0, "seq": 0, "clients": 0,
            "states": {}, "counters": {}, "samples": 0,
            "rate": ValueSketch().as_dict(),
            "crate": ValueSketch().as_dict(),
            "stages": {}, "worst": [], "transitions": []}


def decode_digest(d: Any) -> dict | None:
    """Tolerant validation of a wire digest dict (the FleetDigest
    frame's payload): required fields with the right shapes, or None."""
    if not isinstance(d, dict):
        return None
    try:
        t = float(d.get("t", 0.0))
        seq = int(d.get("seq", 0))
        states = d.get("states") or {}
        counters = d.get("counters") or {}
        if not isinstance(states, dict) or not isinstance(counters,
                                                         dict):
            return None
        out = dict(empty_digest())
        out.update(d)
        out["t"], out["seq"] = t, seq
        out["clients"] = int(d.get("clients", 0))
        out["samples"] = int(d.get("samples", 0))
        out["states"] = {str(s): int(n) for s, n in states.items()}
        out["counters"] = {str(k): int(v)
                           for k, v in counters.items()}
        return out
    except (TypeError, ValueError):
        return None


def merge_digests(digests: Iterable[dict], k: int = 16) -> dict:
    """Fold node digests into one fleet view.  Exact where the inputs
    are exact (state counts, counter sums, samples, client count),
    sketch-merged for the quantiles, worst-K re-ranked across nodes.
    Order/duplicate handling is the CALLER's job (the FleetMonitor
    keeps one latest digest per node, seq-guarded) — given one digest
    per node this fold is order-invariant."""
    out = empty_digest()
    out["node"] = "*"
    rate, crate = ValueSketch(), ValueSketch()
    worst = WorstK(k)
    stages: dict[str, dict] = {}
    transitions: list[dict] = []
    for d in digests:
        if not d:
            continue
        out["t"] = max(out["t"], float(d.get("t", 0.0)))
        out["clients"] += int(d.get("clients", 0))
        out["samples"] += int(d.get("samples", 0))
        for s, n in (d.get("states") or {}).items():
            out["states"][s] = out["states"].get(s, 0) + int(n)
        for name, v in (d.get("counters") or {}).items():
            out["counters"][name] = out["counters"].get(name, 0) \
                + int(v)
        rate.merge(d.get("rate"))
        crate.merge(d.get("crate"))
        worst.merge(d.get("worst") or [])
        for st, sd in (d.get("stages") or {}).items():
            ent = stages.setdefault(str(st), {
                "n": 0, "crate": ValueSketch(),
                "step_ms": ValueSketch()})
            ent["n"] += int(sd.get("n", 0))
            ent["crate"].merge(sd.get("crate"))
            ent["step_ms"].merge(sd.get("step_ms"))
        transitions.extend(d.get("transitions") or [])
    out["rate"] = rate.as_dict()
    out["crate"] = crate.as_dict()
    out["worst"] = worst.top()
    out["stages"] = {
        st: {"n": ent["n"], "crate": ent["crate"].as_dict(),
             "step_ms": ent["step_ms"].as_dict()}
        for st, ent in sorted(stages.items())}
    transitions.sort(key=lambda r: (r.get("t", 0.0),
                                    r.get("client") or ""))
    out["transitions"] = transitions[-MAX_TRANSITIONS:]
    return out


def digest_quantiles(digest: dict, qs=(50, 95)) -> dict:
    """Fleet-level quantile gauges from a (merged) digest —
    what /metrics renders instead of 100k per-client series."""
    out: dict = {}
    for field in _SKETCH_FIELDS:
        sk = ValueSketch.from_dict(digest.get(field))
        if sk is None or sk.n == 0:
            continue
        for q in qs:
            v = sk.quantile(q)
            if v is not None:
                out[f"{field}_p{q}"] = round(v, 4)
    return out
