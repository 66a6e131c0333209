"""Constant-velocity Kalman filter over (x, y, aspect, h) box states,
batched over tracks: the port's copy of ``openpvsg_tpu/tracker/kalman.py``
(host numpy, the same arithmetic, except ``initiate`` on a box less than a
pixel high, where the JAX package's covariance is singular).

Rebuild of the reference's 8-state KF (reference:
models/unitrack/core/motion/kalman_filter.py:23-277). The reference's
per-track loop in ``multi_predict`` is one batched einsum over the track
axis; an 8-dim filter over tens of tracks is host work. The tracker's device
work is the appearance encoder and the reconsdot cost
(``openpvsg_torch.tracker.appearance``, ``openpvsg_torch.tracker.matching``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# 0.95-quantile of chi-square distribution (Mahalanobis gating)
CHI2INV95 = {1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877,
             5: 11.070, 6: 12.592, 7: 14.067, 8: 15.507}


class KalmanFilter:
    def __init__(self):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def initiate(self, measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """measurement: (4,) xyah -> (mean (8,), covariance (8, 8))."""
        mean = np.r_[measurement, np.zeros(4)]
        # the noise of a box less than a pixel high (a one-row mask gives a
        # tlwh height of 0) is that of a one-pixel box: with h = 0 the
        # covariance is singular and the next gating's Cholesky raises, as
        # it does in openpvsg_tpu (ROADMAP.md §C); pixel boxes of height >= 1
        # are untouched
        h = max(measurement[3], 1.0)
        std = [2 * self._std_weight_position * h,
               2 * self._std_weight_position * h,
               1e-2,
               2 * self._std_weight_position * h,
               10 * self._std_weight_velocity * h,
               10 * self._std_weight_velocity * h,
               1e-5,
               10 * self._std_weight_velocity * h]
        return mean, np.diag(np.square(std))

    def _motion_cov(self, h: np.ndarray) -> np.ndarray:
        """h: (N,) heights -> (N, 8, 8) process noise."""
        swp, swv = self._std_weight_position, self._std_weight_velocity
        n = h.shape[0]
        std = np.stack([swp * h, swp * h, np.full(n, 1e-2), swp * h,
                        swv * h, swv * h, np.full(n, 1e-5), swv * h], axis=1)
        cov = np.zeros((n, 8, 8))
        idx = np.arange(8)
        cov[:, idx, idx] = np.square(std)
        return cov

    def predict(self, mean: np.ndarray, covariance: np.ndarray):
        m, c = self.multi_predict(mean[None], covariance[None])
        return m[0], c[0]

    def multi_predict(self, mean: np.ndarray, covariance: np.ndarray):
        """mean: (N, 8); covariance: (N, 8, 8) — one batched step."""
        motion_cov = self._motion_cov(mean[:, 3])
        F = self._motion_mat
        mean = mean @ F.T
        covariance = np.einsum("ij,njk,lk->nil", F, covariance, F) + motion_cov
        return mean, covariance

    def project(self, mean: np.ndarray, covariance: np.ndarray):
        """State -> measurement space, (4,) + (4,4)."""
        h = mean[3]
        swp = self._std_weight_position
        std = [swp * h, swp * h, 1e-1, swp * h]
        innovation_cov = np.diag(np.square(std))
        H = self._update_mat
        return H @ mean, H @ covariance @ H.T + innovation_cov

    def update(self, mean: np.ndarray, covariance: np.ndarray,
               measurement: np.ndarray):
        proj_mean, proj_cov = self.project(mean, covariance)
        K = np.linalg.solve(proj_cov.T,
                            (covariance @ self._update_mat.T).T).T
        innovation = measurement - proj_mean
        new_mean = mean + K @ innovation
        new_cov = covariance - K @ proj_cov @ K.T
        return new_mean, new_cov

    def gating_distance(self, mean: np.ndarray, covariance: np.ndarray,
                        measurements: np.ndarray, only_position: bool = False,
                        metric: str = "maha") -> np.ndarray:
        """Squared Mahalanobis distance of measurements (M, 4) to one track's
        projected distribution."""
        proj_mean, proj_cov = self.project(mean, covariance)
        if only_position:
            proj_mean, proj_cov = proj_mean[:2], proj_cov[:2, :2]
            measurements = measurements[:, :2]
        d = measurements - proj_mean
        if metric == "gaussian":
            return np.sum(d * d, axis=1)
        chol = np.linalg.cholesky(proj_cov)
        z = np.linalg.solve(chol, d.T)
        return np.sum(z * z, axis=0)


# xyah/tlwh/tlbr conversions (reference: models/unitrack/utils/box.py)

def tlwh_to_xyah(tlwh: np.ndarray) -> np.ndarray:
    ret = np.asarray(tlwh, dtype=np.float64).copy()
    ret[:2] += ret[2:] / 2
    ret[2] /= ret[3] if ret[3] != 0 else 1.0
    return ret


def tlbr_to_tlwh(tlbr: np.ndarray) -> np.ndarray:
    ret = np.asarray(tlbr, dtype=np.float64).copy()
    ret[2:] -= ret[:2]
    return ret


def tlwh_to_tlbr(tlwh: np.ndarray) -> np.ndarray:
    ret = np.asarray(tlwh, dtype=np.float64).copy()
    ret[2:] += ret[:2]
    return ret
