"""Wasserstein-2 machinery for mid-attribute speaker distributions (port of
masg_tpu/distributions/wasserstein.py).

Reference: model/distributions.py (InterpolateGMM :12-77, BarycenterGMM
:79-192) + check.py (the reference's numerical check of the diagonal
Gaussian W2 formulas). All covariances are diagonal, so every matrix
expression has a closed form:

  W2^2(N_a, N_b) = ||mu_a - mu_b||^2 + sum_d (sigma_a_d - sigma_b_d)^2
  interpolant:     mu_t = (1-t) mu_a + t mu_b,
                   sigma_t = (1-t) sigma_a + t sigma_b
  barycenter:      sigma_bar = sum_j rate_j sigma_j (diagonal fixed point)

and the exact OT plan between the <= 3-component mixtures is a small LP
solved with scipy's `linprog` (HiGHS), in place of POT's `ot.emd`.

The math runs in numpy, as masg_tpu's does. The classes take the port's
`DiagGMM` (torch tensors with a leading batch of 1, or without one) and
return float32 CPU tensors with a leading batch of 1.

Known reference divergence, kept from masg_tpu: the reference's
InterpolateGMM feeds the interpolated *variance* as torch Normal's `scale`
(distributions.py:45-62), i.e. it samples with stddev = variance_t. This
uses stddev sigma_t; `reproduce_reference_scale_bug=True` gives the
reference's behaviour.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.gmm import DiagGMM


def w2sq_diag(mu_a, sigma_a, mu_b, sigma_b) -> float:
    """Squared W2 between diagonal Gaussians (check.py's identity)."""
    mu_a, mu_b = np.asarray(mu_a), np.asarray(mu_b)
    sigma_a, sigma_b = np.asarray(sigma_a), np.asarray(sigma_b)
    return float(np.sum((mu_a - mu_b) ** 2) + np.sum((sigma_a - sigma_b) ** 2))


def exact_emd(a: np.ndarray, b: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """Exact optimal transport plan between histograms a (K_a,) and b (K_b,)
    under cost (K_a, K_b), in place of ot.emd (distributions.py:22)."""
    from scipy.optimize import linprog

    ka, kb = cost.shape
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    a = a / a.sum()
    b = b / b.sum()
    # variables P[i, j] >= 0, sum_j P[i, :] = a_i, sum_i P[:, j] = b_j
    a_eq, b_eq = [], []
    for i in range(ka):
        row = np.zeros(ka * kb)
        row[i * kb:(i + 1) * kb] = 1.0
        a_eq.append(row)
        b_eq.append(a[i])
    for j in range(kb):
        row = np.zeros(ka * kb)
        row[j::kb] = 1.0
        a_eq.append(row)
        b_eq.append(b[j])
    res = linprog(np.asarray(cost, np.float64).reshape(-1), A_eq=np.stack(a_eq),
                  b_eq=np.array(b_eq), bounds=[(0, None)] * (ka * kb), method="highs")
    if not res.success:
        raise RuntimeError(f"exact_emd: linprog failed: {res.message}")
    return res.x.reshape(ka, kb)


def _np_gmm(gmm: DiagGMM) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A DiagGMM (leading batch of 1 allowed; tensors or arrays) -> unbatched
    numpy (pi (K,), mu (K, D), sigma (K, D))."""
    pi, mu, sigma = (np.asarray(torch.as_tensor(x).detach().float().cpu()) for x in gmm)
    if pi.ndim == 2:
        pi, mu, sigma = pi[0], mu[0], sigma[0]
    return pi, mu, sigma


def _batched_gmm(pi, mu, sigma) -> DiagGMM:
    """float32 CPU tensors with a leading batch of 1."""
    return DiagGMM(*(torch.from_numpy(np.asarray(x, dtype=np.float32)[None].copy())
                     for x in (pi, mu, sigma)))


class InterpolateGMM:
    """W2 interpolation between two speaker GMMs (distributions.py:12-77).

    A product mixture of K_a x K_b components weighted by the exact OT plan;
    `interpolate_rate(t)` re-mixes at any t in [0, 1].
    """

    def __init__(self, gmm_a: DiagGMM, gmm_b: DiagGMM,
                 reproduce_reference_scale_bug: bool = False):
        self.pi_a, self.mu_a, self.sigma_a = _np_gmm(gmm_a)
        self.pi_b, self.mu_b, self.sigma_b = _np_gmm(gmm_b)
        self.reproduce_reference_scale_bug = reproduce_reference_scale_bug
        cost = np.array([[w2sq_diag(self.mu_a[i], self.sigma_a[i], self.mu_b[j], self.sigma_b[j])
                          for j in range(len(self.pi_b))] for i in range(len(self.pi_a))])
        self.ot_plan = exact_emd(self.pi_a, self.pi_b, cost)  # (K_a, K_b)
        self.t = 0.5
        self._rebuild()

    def _rebuild(self):
        t = self.t
        ka, kb = self.ot_plan.shape
        # components iterate [for j: for i:] like the reference
        # (distributions.py:24-25), each with its own plan weight P[i, j]
        # (the reference pairs them with the transposed weights; masg_tpu and
        # this port keep them aligned)
        mus, sigmas, weights = [], [], []
        for j in range(kb):
            for i in range(ka):
                mus.append((1 - t) * self.mu_a[i] + t * self.mu_b[j])
                s = (1 - t) * self.sigma_a[i] + t * self.sigma_b[j]
                if self.reproduce_reference_scale_bug:
                    s = s * s  # the reference feeds variance_t as Normal scale
                sigmas.append(s)
                weights.append(self.ot_plan[i, j])
        self.gmm = _batched_gmm(weights, np.stack(mus), np.stack(sigmas))

    def interpolate_rate(self, t: float) -> DiagGMM:
        self.t = t
        self._rebuild()
        return self.gmm


def metadata_corners(metadata: Dict[str, Dict[str, int]]) -> List[np.ndarray]:
    """All one-hot combinations across metadata families, in the reference's
    product order (distributions.py:83-90): gender x language gives 4 corner
    vectors of dim 4."""
    pools = []
    for family in metadata.values():
        eye = np.eye(len(family), dtype=np.float32)
        pools.append([eye[idx] for idx in family.values()])
    return [np.concatenate(combo) for combo in itertools.product(*pools)]


class BarycenterGMM:
    """W2 barycenter over a set of speaker GMMs (distributions.py:79-192).

    Typically built from the prior's GMM at every metadata corner; the
    default rate is uniform ("gender/language-neutral" speakers). One
    barycenter Gaussian per element of the index product across the input
    mixtures; each original component maps to its nearest barycenter (by
    W2^2) with mass rate_j * pi_jk.
    """

    def __init__(self, gmms: Sequence[DiagGMM], rates: Sequence[float] = None):
        self.gmms = [_np_gmm(g) for g in gmms]
        n = len(self.gmms)
        self.rates = list(rates) if rates is not None else [1.0 / n] * n
        _check_rates(self.rates, n)
        self._rebuild()

    def barycenter_rate(self, rates: Sequence[float]) -> DiagGMM:
        _check_rates(rates, len(self.gmms))
        self.rates = list(rates)
        self._rebuild()
        return self.gmm

    def _rebuild(self):
        barycenters = {}
        for pos in itertools.product(*[range(len(pi)) for pi, _, _ in self.gmms]):
            mu = sum(self.rates[i] * self.gmms[i][1][pos[i]] for i in range(len(pos)))
            # the diagonal W2 fixed point is the rate-weighted mean of the
            # stddevs (the reference's 60-iteration loop, :154-163, reaches
            # it after one step)
            sigma = sum(self.rates[i] * self.gmms[i][2][pos[i]] for i in range(len(pos)))
            barycenters[pos] = (mu, sigma)

        probs: Dict[tuple, float] = {}
        for i, (pi, mu, sigma) in enumerate(self.gmms):
            for k in range(len(pi)):
                best, best_d = None, None
                for pos, (bmu, bsigma) in barycenters.items():
                    d = w2sq_diag(mu[k], sigma[k], bmu, bsigma)
                    if best_d is None or d < best_d:
                        best, best_d = pos, d
                probs[best] = probs.get(best, 0.0) + self.rates[i] * float(pi[k])

        used = list(probs)
        self.gmm = _batched_gmm([probs[u] for u in used],
                                np.stack([barycenters[u][0] for u in used]),
                                np.stack([barycenters[u][1] for u in used]))


def _check_rates(rates: Sequence[float], n: int) -> None:
    if len(rates) != n or abs(sum(rates) - 1.0) >= 1e-6:
        raise ValueError(f"barycenter rates must be {n} numbers summing to 1, got {list(rates)}")
