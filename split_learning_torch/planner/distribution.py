"""Per-client label-count synthesis (IID / Dirichlet non-IID).

Parity with the reference server's ``distribution()``
(``src/Server.py:87-101``): stage-1 clients each get a
per-label sample-count vector — IID mode splits ``num_sample`` evenly over
labels for every client; non-IID mode draws each client's label distribution
from ``Dirichlet(alpha * 1)`` and scales to ``num_sample``.
"""

from __future__ import annotations

import numpy as np


def synthesize_label_counts(num_clients: int, num_labels: int,
                            num_samples: int, non_iid: bool = False,
                            alpha: float = 1.0,
                            seed: int | None = None) -> np.ndarray:
    """(num_clients, num_labels) int array of per-label sample counts."""
    if num_clients <= 0:
        return np.zeros((0, num_labels), dtype=int)
    if non_iid:
        rng = np.random.default_rng(seed)
        probs = rng.dirichlet([alpha] * num_labels, size=num_clients)
        counts = _largest_remainder(probs * num_samples)
    else:
        counts = _largest_remainder(
            np.full((num_clients, num_labels),
                    num_samples / num_labels, dtype=float))
    return counts


def _largest_remainder(target: np.ndarray) -> np.ndarray:
    """Round rows to ints preserving each row's total (the reference's
    plain ``int()`` truncation loses up to num_labels-1 samples per client
    and zeroes everything when num_samples < num_labels)."""
    floor = np.floor(target).astype(int)
    remainder = target - floor
    deficit = np.round(target.sum(axis=1)).astype(int) - floor.sum(axis=1)
    for i in range(target.shape[0]):
        if deficit[i] > 0:
            top = np.argsort(-remainder[i])[:deficit[i]]
            floor[i, top] += 1
    return floor


def fixed_matrix_label_counts(matrix) -> np.ndarray:
    """Pass-through for the FLEX variant's hardcoded non-IID matrix
    (``other/FLEX/src/Server.py:80-93``) expressed as a config value."""
    return np.asarray(matrix, dtype=int)
