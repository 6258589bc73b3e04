"""Straggler rejection via a 2-component Gaussian-mixture speed threshold.

A copy of the JAX package's ``planner/selection.py`` (numpy only; copied,
not imported, so that the port never loads JAX): the same threshold as a
float64 on the same speeds.

Behavioral parity with ``src/Selection.py:4-48``: fit a
2-component GMM to log(speed), then place the threshold at the intersection
of the two Gaussians between their means (the Bayes decision boundary);
devices slower than the threshold are rejected.  The reference leans on
sklearn — here the EM fit is a ~40-line numpy routine (1-D, full covariance)
so the planner has zero dependencies beyond numpy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _gmm_em_1d(x: np.ndarray, n_components: int = 2, n_init: int = 9,
               n_iter: int = 200, tol: float = 1e-7, seed: int = 0):
    """EM for a 1-D Gaussian mixture. Returns (means, variances, weights)."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    best = None
    best_ll = -np.inf
    for _ in range(n_init):
        # init means from random data points, shared variance
        mu = rng.choice(x, size=n_components, replace=n < n_components)
        var = np.full(n_components, max(x.var(), 1e-12))
        w = np.full(n_components, 1.0 / n_components)
        ll_prev = -np.inf
        for _ in range(n_iter):
            # E-step: responsibilities (log-space for stability)
            log_p = (-0.5 * (x[:, None] - mu[None, :]) ** 2 / var[None, :]
                     - 0.5 * np.log(2 * np.pi * var[None, :])
                     + np.log(w[None, :]))
            log_norm = np.logaddexp.reduce(log_p, axis=1)
            resp = np.exp(log_p - log_norm[:, None])
            ll = float(log_norm.sum())
            # M-step
            nk = resp.sum(axis=0) + 1e-12
            mu = (resp * x[:, None]).sum(axis=0) / nk
            var = (resp * (x[:, None] - mu[None, :]) ** 2).sum(axis=0) / nk
            var = np.maximum(var, 1e-12)
            w = nk / n
            if abs(ll - ll_prev) < tol:
                break
            ll_prev = ll
        if ll > best_ll:
            best_ll = ll
            best = (mu.copy(), var.copy(), w.copy())
    return best


def auto_threshold(performance: Sequence[float], n_init: int = 9,
                   seed: int = 0) -> float:
    """Speed threshold separating the slow and fast device populations.

    Solves the quadratic for the intersection of the two fitted Gaussians in
    log-speed space; falls back to the midpoint of the means when the
    intersection is degenerate or lies outside (mu_slow, mu_fast) — the same
    decision ladder as the reference.
    """
    perf = np.asarray(performance, dtype=float)
    if perf.size <= 1:
        return 0.0
    # a dead/timed-out device may report speed <= 0; log() would poison the
    # EM likelihood and fail every restart, so clamp to a tiny positive speed
    # (such a device always lands far below any sane threshold anyway)
    perf = np.maximum(perf, 1e-300)

    x = np.log(perf)
    mu_raw, var_raw, w_raw = _gmm_em_1d(x, 2, n_init=n_init, seed=seed)
    order = np.argsort(mu_raw)
    mu, var, w = mu_raw[order], var_raw[order], w_raw[order]

    # intersection of w0*N(mu0,var0) and w1*N(mu1,var1): quadratic in t
    a = var[0] - var[1]
    b = 2.0 * (var[1] * mu[0] - var[0] * mu[1])
    c = (var[0] * mu[1] ** 2 - var[1] * mu[0] ** 2
         + 2.0 * var[0] * var[1] * np.log((var[1] * w[0]) / (var[0] * w[1])))

    if np.isclose(a, 0.0):
        if np.isclose(b, 0.0):
            t = float(np.mean(mu))
        else:
            root = -c / b
            t = float(root) if mu[0] < root < mu[1] else float(np.mean(mu))
    else:
        roots = np.roots([a, b, c])
        real = roots[np.isreal(roots)].real
        inside = real[(real > mu[0]) & (real < mu[1])]
        if inside.size:
            mid = float(np.mean(mu))
            t = float(inside[np.argmin(np.abs(inside - mid))])
        else:
            t = float(np.mean(mu))
    return float(np.exp(t))


def select_devices(speeds: Sequence[float], enabled: bool = True,
                   n_init: int = 9, seed: int = 0) -> tuple[np.ndarray, float]:
    """Boolean keep-mask over devices plus the threshold used.

    With selection disabled, or a single device (no mixture to fit),
    everything is kept.
    """
    speeds = np.asarray(speeds, dtype=float)
    if not enabled or speeds.size <= 1:
        return np.ones(speeds.shape, dtype=bool), 0.0
    thr = auto_threshold(speeds, n_init=n_init, seed=seed)
    return speeds >= thr, thr
