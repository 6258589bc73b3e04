"""Client clustering by label distribution.

A copy of the JAX package's ``planner/cluster.py`` (numpy only; copied,
not imported, so that the port never loads JAX), equal to it label for
label on the same inputs and seed.

Parity with ``src/Cluster.py:5-21``: L1-normalize each
client's per-label sample-count vector, KMeans with a fixed seed, return the
per-client cluster labels and per-cluster sizes.  KMeans is implemented here
directly (kmeans++ init + Lloyd iterations, numpy) — deterministic given the
seed, no sklearn.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), dtype=float)
    centers[0] = x[rng.integers(n)]
    d2 = ((x - centers[0]) ** 2).sum(axis=1)
    for i in range(1, k):
        total = d2.sum()
        if total <= 0:
            centers[i] = x[rng.integers(n)]
        else:
            centers[i] = x[rng.choice(n, p=d2 / total)]
        d2 = np.minimum(d2, ((x - centers[i]) ** 2).sum(axis=1))
    return centers


def kmeans(x: np.ndarray, k: int, n_init: int = 10, n_iter: int = 300,
           seed: int = 42) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd's KMeans with kmeans++ restarts. Returns (labels, centers)."""
    rng = np.random.default_rng(seed)
    best_inertia = np.inf
    best: tuple[np.ndarray, np.ndarray] | None = None
    for _ in range(n_init):
        centers = _kmeans_pp_init(x, k, rng)
        for _ in range(n_iter):
            d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
            labels = d2.argmin(axis=1)
            new_centers = centers.copy()
            for j in range(k):
                mask = labels == j
                if mask.any():
                    new_centers[j] = x[mask].mean(axis=0)
            if np.allclose(new_centers, centers):
                centers = new_centers
                break
            centers = new_centers
        # final assignment against the *final* centers, so the returned
        # (labels, centers) pair is consistent and restarts rank correctly
        d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
        labels = d2.argmin(axis=1)
        inertia = float(d2[np.arange(x.shape[0]), labels].sum())
        if inertia < best_inertia:
            best_inertia = inertia
            best = (labels.copy(), centers.copy())
    assert best is not None
    return best


def kmeans_cluster(label_counts: Sequence[Sequence[float]], num_cluster: int,
                   seed: int = 42) -> tuple[np.ndarray, list[list[int]]]:
    """Cluster clients by L1-normalized label distribution.

    Returns ``(labels, infor_cluster)`` where ``infor_cluster[c] == [size_c]``
    — the same nested-singleton shape the reference server consumes when
    building per-cluster client counts.
    """
    x = np.asarray(label_counts, dtype=float)
    norms = np.abs(x).sum(axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    x = x / norms
    k = min(num_cluster, x.shape[0])
    labels, _ = kmeans(x, k, seed=seed)
    counts = np.bincount(labels, minlength=k)
    return labels, [[int(c)] for c in counts]


def clustering_algorithm(label_counts: Sequence[Sequence[float]],
                         num_cluster: int, algorithm: str = "KMeans",
                         seed: int = 42) -> tuple[np.ndarray, list[list[int]]]:
    """Dispatch by algorithm name (config key ``algorithm-cluster``)."""
    if algorithm.lower() in ("kmeans", "k_means", "k-means"):
        return kmeans_cluster(label_counts, num_cluster, seed=seed)
    if algorithm.lower() in ("affinitypropagation", "affinity-propagation"):
        labels = affinity_propagation(np.asarray(label_counts, dtype=float))
        k = int(labels.max()) + 1 if labels.size else 0
        counts = np.bincount(labels, minlength=k)
        return labels, [[int(c)] for c in counts]
    raise ValueError(f"unknown clustering algorithm: {algorithm!r}")


def affinity_propagation(x: np.ndarray, damping: float = 0.7,
                         n_iter: int = 200, conv_iter: int = 15) -> np.ndarray:
    """Affinity propagation on negative-squared-euclidean similarity.

    Needed by BASELINE.json config #2 ("AffinityPropagation cluster mode") —
    the reference only names KMeans, so this is a fresh implementation of the
    standard responsibility/availability message passing.
    """
    norms = np.abs(x).sum(axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    x = x / norms
    n = x.shape[0]
    if n == 1:
        return np.zeros(1, dtype=int)
    s = -((x[:, None, :] - x[None, :, :]) ** 2).sum(axis=2)
    pref = np.median(s[~np.eye(n, dtype=bool)])
    np.fill_diagonal(s, pref)
    # deterministic tie-breaking jitter: exact-duplicate points otherwise
    # collapse the message passing into oscillation / one cluster
    scale = max(np.abs(s).max(), 1.0)
    s = s + np.random.default_rng(0).normal(0, 1e-9 * scale, s.shape)
    r = np.zeros((n, n))
    a = np.zeros((n, n))
    stable = 0
    prev_ex = None
    for _ in range(n_iter):
        # responsibilities
        as_ = a + s
        idx = as_.argmax(axis=1)
        first = as_[np.arange(n), idx]
        as_[np.arange(n), idx] = -np.inf
        second = as_.max(axis=1)
        rnew = s - first[:, None]
        rnew[np.arange(n), idx] = s[np.arange(n), idx] - second
        r = damping * r + (1 - damping) * rnew
        # availabilities
        rp = np.maximum(r, 0)
        np.fill_diagonal(rp, r.diagonal())
        anew = rp.sum(axis=0)[None, :] - rp
        dA = anew.diagonal().copy()
        anew = np.minimum(anew, 0)
        np.fill_diagonal(anew, dA)
        a = damping * a + (1 - damping) * anew
        ex = np.flatnonzero((a + r).diagonal() > 0)
        if prev_ex is not None and ex.size and np.array_equal(ex, prev_ex):
            stable += 1
            if stable >= conv_iter:
                break
        else:
            stable = 0
        prev_ex = ex
    exemplars = np.flatnonzero((a + r).diagonal() > 0)
    if exemplars.size == 0:
        exemplars = np.array([int((a + r).diagonal().argmax())])
    labels_raw = s[:, exemplars].argmax(axis=1)
    labels_raw[exemplars] = np.arange(exemplars.size)
    return labels_raw.astype(int)
