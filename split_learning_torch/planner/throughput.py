"""Measured-throughput cost model for cut re-planning.

A copy of the JAX package's ``planner/throughput.py`` (numpy only;
copied, not imported, so that the port never loads JAX).  Its caller,
the closed-loop scheduler, is not ported yet.

The static planner (:mod:`split_learning_torch.planner.partition`) picks
cuts from the profiles clients registered with — a one-shot snapshot
of each device, taken before any real round ran.  The closed-loop
scheduler (``runtime/scheduler.py``) needs the same max-min
pipeline-balance search driven by LIVE telemetry instead: measured
per-client device rate (the perf plane's ``compute_samples_per_s``
gauge) and measured end-to-end rate (the telemetry plane's EWMA
``samples_per_s``), folded back onto the profile's per-layer shape and
boundary byte sizes.  This module is that bridge: pure numpy functions
that rescale profiles to measurements, invert the rate gap into an
implied wire bandwidth, predict the round wall for any cut, and search
for a better one under a damping threshold — the same shape as the
measured-profile partitioning in MPMD pipeline planning
(PAPERS.md, arxiv 2412.14374), fed by fleet telemetry rather than a
static profiling pass.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

from split_learning_torch.planner.partition import _group_rate


def scaled_exe_time(profile_exe: Sequence[float],
                    compute_rate: float | None) -> list[float]:
    """Per-layer execution times rescaled so their SUM matches the
    measured per-sample device time ``1 / compute_rate``.

    The profile supplies the per-layer *shape* (which layers are
    expensive relative to each other — stable across load), the
    measurement supplies the absolute speed (which drifts with
    thermal state, co-tenants, batch size).  Without a usable
    measurement the profile passes through unchanged; without a usable
    profile the measured time spreads uniformly."""
    exe = [float(t) for t in profile_exe]
    if not compute_rate or compute_rate <= 0:
        return exe
    target = 1.0 / float(compute_rate)
    total = sum(exe)
    if total <= 0:
        n = max(len(exe), 1)
        return [target / n] * n
    return [t * target / total for t in exe]


def implied_bandwidth(cut_bytes: float, rate: float | None,
                      compute_rate: float | None) -> float:
    """Bytes/s implied by the gap between a client's end-to-end rate
    and its device rate at the current cut.

    Per sample the client spends ``1/compute_rate`` on device and
    ``1/rate`` overall; the residual is wire + queueing, attributed to
    shipping ``cut_bytes`` per sample.  Returns 0.0 (the planner's
    "unconstrained" sentinel) when the gap is unmeasurable or
    non-positive — a client whose end-to-end rate matches its device
    rate is not wire-bound."""
    if not rate or not compute_rate or rate <= 0 or compute_rate <= 0:
        return 0.0
    wire_t = 1.0 / rate - 1.0 / compute_rate
    if wire_t <= 0 or cut_bytes <= 0:
        return 0.0
    return float(cut_bytes) / wire_t


def stage_rates(exe_time_groups: Sequence[Sequence[Sequence[float]]],
                net_groups: Sequence[Sequence[float]],
                cuts: Sequence[int],
                size_data: Sequence[float]) -> list[float]:
    """Aggregate throughput (samples/s) of each stage group under
    ``cuts`` — the reference's harmonic per-device rate model
    (:func:`~split_learning_torch.planner.partition._group_rate`), with
    each group paying its incoming AND outgoing boundary transfer."""
    n_groups = len(exe_time_groups)
    bounds = (-1,) + tuple(int(c) - 1 for c in cuts) \
        + (len(size_data) - 1,)
    rates = []
    for k in range(n_groups):
        lo, hi = bounds[k] + 1, bounds[k + 1] + 1
        edge = 0.0
        if k > 0:
            edge += float(size_data[bounds[k]])
        if k < n_groups - 1:
            edge += float(size_data[bounds[k + 1]])
        rates.append(_group_rate(exe_time_groups[k], net_groups[k],
                                 slice(lo, hi), edge))
    return rates


def predict_round_wall(exe_time_groups, net_groups, cuts, size_data,
                       samples: float = 1.0) -> float:
    """Predicted round wall: the per-round sample budget divided by
    the SLOWEST stage group's aggregate rate (the pipeline's
    steady-state bottleneck).  ``inf`` when any group has no
    throughput at all (empty/unmeasured)."""
    rates = stage_rates(exe_time_groups, net_groups, cuts, size_data)
    slowest = min(rates) if rates else 0.0
    if slowest <= 0:
        return float("inf")
    return float(samples) / slowest


def replan_cuts(exe_time_groups, net_groups, size_data,
                current_cuts: Sequence[int],
                damping: float = 0.15,
                samples: float = 1.0,
                window: int = 16) -> dict:
    """Max-min cut search over the MEASURED inputs, gated by a damping
    threshold so the plan cannot flap on noise.

    Returns ``{cuts, adopted, predicted_wall_s, incumbent_wall_s,
    improvement}`` where ``adopted`` is True only when the best cut's
    predicted wall beats the incumbent's by at least ``damping``
    (fractional).  Candidates are restricted to ``window`` layers
    around each INCUMBENT cut: this runs on the protocol thread at
    every round boundary, and the scheduler's job is tracking drift —
    a deep-model full C(n_layers, k) sweep (~156k combos at 100
    layers x 4 stages) belongs to the static planner's one-shot pass,
    not the per-boundary loop.  The window covers the whole space
    whenever ``n_layers <= 2*window`` (every bench/test geometry)."""
    n_groups = len(exe_time_groups)
    n_layers = len(size_data)
    cur = [int(c) for c in current_cuts]
    incumbent = predict_round_wall(exe_time_groups, net_groups, cur,
                                   size_data, samples)
    best_cuts, best_wall = cur, incumbent
    if n_groups >= 2:
        k = n_groups - 1
        anchors = (cur if len(cur) == k
                   else [max(1, (i + 1) * (n_layers - 1) // n_groups)
                         for i in range(k)])
        cand = [range(max(1, a - window),
                      min(n_layers - 1, a + window) + 1)
                for a in anchors]
        for combo in itertools.product(*cand):
            if any(combo[i] >= combo[i + 1] for i in range(k - 1)):
                continue
            wall = predict_round_wall(exe_time_groups, net_groups,
                                      combo, size_data, samples)
            if wall < best_wall:
                best_wall = wall
                best_cuts = list(combo)
    improvement = (0.0 if not np.isfinite(incumbent) or incumbent <= 0
                   else max(0.0, 1.0 - best_wall / incumbent))
    # an unmeasurable incumbent (inf) adopts any finite plan — there
    # is nothing to damp against
    adopted = (best_cuts != cur
               and ((not np.isfinite(incumbent)
                     and np.isfinite(best_wall))
                    or improvement >= damping))
    return {
        "cuts": best_cuts if adopted else cur,
        "adopted": adopted,
        "predicted_wall_s": (round(best_wall, 6)
                             if np.isfinite(best_wall) else None),
        "incumbent_wall_s": (round(incumbent, 6)
                             if np.isfinite(incumbent) else None),
        "improvement": round(improvement, 4),
    }
