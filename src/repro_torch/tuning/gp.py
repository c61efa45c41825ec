"""Minimal Gaussian-process regression for Bayesian optimization.

RBF kernel with per-dimension length scales (median heuristic), noise
jitter, exact Cholesky inference — numpy/scipy only, adequate for the
69-point scout search spaces of CherryPick/Arrow.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import cho_factor, cho_solve
from scipy.stats import norm


class GP:
    def __init__(self, noise: float = 1e-3):
        self.noise = noise
        self.X = None
        self.y = None

    def _scales(self, X):
        if len(X) < 2:
            # single observation: every pairwise distance is zero, the
            # median heuristic is undefined -> unit length scales
            return np.ones(X.shape[-1])
        med = np.median(np.abs(X[:, None, :] - X[None, :, :]), axis=(0, 1))
        return np.where(med > 1e-9, med, 1.0)

    def _k(self, A, B):
        d = (A[:, None, :] - B[None, :, :]) / self.scales
        return np.exp(-0.5 * np.sum(d * d, axis=-1))

    def fit(self, X: np.ndarray, y: np.ndarray):
        self.X = np.asarray(X, float)
        self.y_mean = float(np.mean(y))
        # constant-y guard: a (numerically) zero spread would blow up
        # the standardized targets; fall back to unit std
        std = float(np.std(y))
        self.y_std = std if std > 1e-12 * max(1.0, abs(self.y_mean)) \
            else 1.0
        self.y = (np.asarray(y, float) - self.y_mean) / self.y_std
        self.scales = self._scales(self.X)
        K = self._k(self.X, self.X) + self.noise * np.eye(len(self.X))
        self.chol = cho_factor(K)
        self.alpha = cho_solve(self.chol, self.y)
        return self

    def predict(self, Xs: np.ndarray):
        Ks = self._k(np.asarray(Xs, float), self.X)
        mu = Ks @ self.alpha
        v = cho_solve(self.chol, Ks.T)
        var = np.clip(1.0 - np.sum(Ks * v.T, axis=1), 1e-9, None)
        return (mu * self.y_std + self.y_mean,
                np.sqrt(var) * self.y_std)


def expected_improvement(mu, sigma, best, xi: float = 0.01):
    """EI for *minimization*; non-negative by definition, so the result
    is clipped at 0 (degenerate sigma -> the improvement itself)."""
    imp = best - mu - xi
    z = imp / np.maximum(sigma, 1e-9)
    return np.maximum(imp * norm.cdf(z) + sigma * norm.pdf(z), 0.0)
