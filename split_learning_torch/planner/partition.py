"""Throughput-optimal cut-point search.

Behavioral parity with the reference's max-min pipeline-balance search
(``src/Partition.py:2-21``): given per-device per-layer
execution times and network bandwidths for the two stage groups, pick the cut
that maximizes the slower group's aggregate rate.  Extended here with a
multi-way generalization (the reference only supports one cut; BASELINE.json
config #3/#5 need 3- and 4-stage splits).
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np


def _group_rate(exe_times: Sequence[Sequence[float]],
                bandwidths: Sequence[float],
                compute_slice: slice,
                transfer_bytes: float) -> float:
    """Aggregate throughput of one device group.

    Each device contributes ``1 / (compute_time + transfer_bytes/bandwidth)``
    — the harmonic form the reference uses, so clients' rates add.
    """
    rate = 0.0
    for exe, bw in zip(exe_times, bandwidths):
        t = float(np.sum(np.asarray(exe, dtype=float)[compute_slice]))
        if bw > 0:       # unmeasured bandwidth (0) -> free transfer
            t += transfer_bytes / bw
        if t > 0:
            rate += 1.0 / t
    return rate


def partition(exe_time_group_1: Sequence[Sequence[float]],
              net_group_1: Sequence[float],
              exe_time_group_2: Sequence[Sequence[float]],
              net_group_2: Sequence[float],
              size_data: Sequence[float]) -> list[int]:
    """Choose the single cut maximizing ``min(rate_group1, rate_group2)``.

    ``size_data[c]`` is the byte size of the activation leaving layer ``c``
    (0-indexed).  Group 1 computes layers ``0..c`` and ships the activation;
    group 2 receives it and computes layers ``c+1..``.  Returns the 1-indexed
    cut layer in a list (matching the reference's return shape, which feeds
    straight into the per-cluster ``layers`` ranges).
    """
    best_rate = 0.0
    best_cut = 1
    n_layers = len(size_data)
    # proper cuts only: cutting after the last layer would leave group 2
    # with no compute (cheap-transfer profiles would otherwise pick it)
    for cut in range(n_layers - 1):
        size = float(size_data[cut])
        r1 = _group_rate(exe_time_group_1, net_group_1, slice(0, cut + 1), size)
        r2 = _group_rate(exe_time_group_2, net_group_2, slice(cut + 1, None), size)
        rate = min(r1, r2)
        if rate > best_rate:
            best_rate = rate
            best_cut = cut + 1
    return [best_cut]


def partition_multiway(exe_time_groups: Sequence[Sequence[Sequence[float]]],
                       net_groups: Sequence[Sequence[float]],
                       size_data: Sequence[float]) -> list[int]:
    """K-way generalization: find cuts ``c_1 < ... < c_{K-1}`` maximizing the
    minimum group rate over K stage groups.

    Group ``k`` computes layers ``c_k+1..c_{k+1}`` (with ``c_0 = -1``,
    ``c_K = n_layers-1``) and pays the transfer of *both* its boundary
    activations — incoming and outgoing (the first group has no incoming
    edge, the last no outgoing).  With K=2 this reduces exactly to the
    reference's 2-way model where each side pays the cut's transfer once.
    Exhaustive search — layer counts here are <100 and K <= 4, so the loop
    is cheap; a DP refinement can replace it if profiles ever get large.
    """
    n_groups = len(exe_time_groups)
    n_layers = len(size_data)
    if n_groups < 2:
        return []
    best_rate = -1.0
    best_cuts: tuple[int, ...] = tuple(range(1, n_groups))
    for cuts in itertools.combinations(range(n_layers - 1), n_groups - 1):
        bounds = (-1,) + cuts + (n_layers - 1,)
        worst = np.inf
        for k in range(n_groups):
            lo, hi = bounds[k] + 1, bounds[k + 1] + 1
            edge_bytes = 0.0
            if k > 0:
                edge_bytes += float(size_data[cuts[k - 1]])  # incoming
            if k < n_groups - 1:
                edge_bytes += float(size_data[cuts[k]])      # outgoing
            rate = _group_rate(exe_time_groups[k], net_groups[k],
                               slice(lo, hi), edge_bytes)
            worst = min(worst, rate)
        if worst > best_rate:
            best_rate = worst
            best_cuts = tuple(c + 1 for c in cuts)
    return list(best_cuts)
