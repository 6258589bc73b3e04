"""Stage geometry.

Of the JAX package's ``parallel/mesh.py`` only :func:`stage_ranges` is
ported: one device holds every stage, so there is no (client, stage)
mesh to build.
"""

from __future__ import annotations

from typing import Sequence


def stage_ranges(n_layers: int, cuts: Sequence[int]) -> list[tuple[int, int]]:
    """Turn 1-based cut layers into per-stage (start, end) layer ranges.

    ``cuts=[7]`` over 52 layers -> ``[(0, 7), (7, 52)]`` — stage k owns
    layers ``start+1..end``, the same contract as the reference's START
    message ``layers`` ranges.
    """
    if any(not (1 <= c < n_layers) for c in cuts):
        raise ValueError(
            f"cuts {cuts!r} out of range [1, {n_layers - 1}]")
    bounds = [0] + sorted(cuts) + [n_layers]
    if len(set(bounds)) != len(bounds):
        raise ValueError(f"degenerate cuts {cuts!r} for {n_layers} layers")
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
