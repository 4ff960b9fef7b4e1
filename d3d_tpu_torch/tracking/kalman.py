"""Minimal linear Kalman filter and Julier-sigma-point UKF (the port's own
copy of ``d3d_tpu.tracking.kalman``, host numpy).

The reference depends on filterpy (d3d/tracking/filter.py:7); the math is
tiny O(state-dim^3) host work per track, so numpy is the right tool (a
card has nothing to win on 6x6 matrices). Interfaces mirror the filterpy subset the reference uses:
``predict(dt=...)`` / ``update(z, R=...)`` with custom mean/residual hooks
for angular states.
"""

import numpy as np
import scipy.linalg

__all__ = ["KalmanFilter", "UnscentedKalmanFilter", "JulierSigmaPoints"]


class KalmanFilter:
    """Standard linear KF with state x, covariance P, transition F,
    observation H, process noise Q."""

    def __init__(self, dim_x, dim_z):
        self.dim_x = dim_x
        self.dim_z = dim_z
        self.x = np.zeros(dim_x)
        self.P = np.eye(dim_x)
        self.F = np.eye(dim_x)
        self.H = np.zeros((dim_z, dim_x))
        self.Q = np.eye(dim_x)
        self.R = np.eye(dim_z)

    def predict(self):
        self.x = self.F.dot(self.x)
        self.P = self.F.dot(self.P).dot(self.F.T) + self.Q

    def update(self, z, R=None):
        R = self.R if R is None else np.asarray(R)
        y = np.asarray(z) - self.H.dot(self.x)
        S = self.H.dot(self.P).dot(self.H.T) + R
        K = self.P.dot(self.H.T).dot(np.linalg.inv(S))
        self.x = self.x + K.dot(y)
        ikh = np.eye(self.dim_x) - K.dot(self.H)
        # Joseph form for numerical stability
        self.P = ikh.dot(self.P).dot(ikh.T) + K.dot(R).dot(K.T)


class JulierSigmaPoints:
    """Julier's original sigma points: 2n+1 points with spread sqrt(n+kappa)."""

    def __init__(self, n, kappa=0.0):
        self.n = n
        self.kappa = kappa

    def num_sigmas(self):
        return 2 * self.n + 1

    def weights(self):
        n, k = self.n, self.kappa
        w = np.full(2 * n + 1, 0.5 / (n + k))
        w[0] = k / (n + k)
        return w

    def sigma_points(self, x, P):
        n, k = self.n, self.kappa
        x = np.asarray(x, dtype=float)
        P = np.atleast_2d(P)
        # upper-triangular cholesky: rows of U are the perturbation directions
        U = scipy.linalg.cholesky((n + k) * P)
        pts = np.empty((2 * n + 1, n))
        pts[0] = x
        pts[1:n + 1] = x + U
        pts[n + 1:] = x - U
        return pts


class UnscentedKalmanFilter:
    """UKF with pluggable state/measurement mean and residual functions
    (needed for angle-wrapping states)."""

    def __init__(self, dim_x, dim_z, dt, fx, hx, points,
                 x_mean_fn=None, z_mean_fn=None,
                 residual_x=None, residual_z=None):
        self.dim_x = dim_x
        self.dim_z = dim_z
        self.fx = fx
        self.hx = hx
        self.points = points
        self.x = np.zeros(dim_x)
        self.P = np.eye(dim_x)
        self.Q = np.eye(dim_x)
        self.R = np.eye(dim_z)
        self._wm = points.weights()
        self.x_mean_fn = x_mean_fn or (lambda s, w: np.average(s, axis=0, weights=w))
        self.z_mean_fn = z_mean_fn or (lambda s, w: np.average(s, axis=0, weights=w))
        self.residual_x = residual_x or (lambda a, b: a - b)
        self.residual_z = residual_z or (lambda a, b: a - b)
        self._sigmas_f = None

    def _unscented_transform(self, sigmas, mean_fn, residual_fn, noise):
        mean = mean_fn(sigmas, self._wm)
        cov = np.zeros((sigmas.shape[1], sigmas.shape[1]))
        for i in range(sigmas.shape[0]):
            d = residual_fn(sigmas[i], mean)
            cov += self._wm[i] * np.outer(d, d)
        return mean, cov + noise

    def predict(self, dt=None):
        sigmas = self.points.sigma_points(self.x, self.P)
        self._sigmas_f = np.array([self.fx(s, dt) for s in sigmas])
        self.x, self.P = self._unscented_transform(
            self._sigmas_f, self.x_mean_fn, self.residual_x, self.Q)

    def update(self, z, R=None):
        R = self.R if R is None else np.asarray(R)
        if self._sigmas_f is None:  # update without prior predict
            self._sigmas_f = self.points.sigma_points(self.x, self.P)
        sigmas_h = np.array([self.hx(s) for s in self._sigmas_f])
        zp, S = self._unscented_transform(
            sigmas_h, self.z_mean_fn, self.residual_z, R)

        Pxz = np.zeros((self.dim_x, self.dim_z))
        for i in range(sigmas_h.shape[0]):
            dx = self.residual_x(self._sigmas_f[i], self.x)
            dz = self.residual_z(sigmas_h[i], zp)
            Pxz += self._wm[i] * np.outer(dx, dz)

        K = Pxz.dot(np.linalg.inv(S))
        y = self.residual_z(np.asarray(z, dtype=float), zp)
        self.x = self.x + K.dot(y)
        self.P = self.P - K.dot(S).dot(K.T)
        self._sigmas_f = None
        # innovation statistics (consumed by the IMM mode-probability step)
        self.y = y
        self.S = S
        sign, logdet = np.linalg.slogdet(S)
        self.log_likelihood = float(
            -0.5 * (self.dim_z * np.log(2 * np.pi) + logdet
                    + y.dot(np.linalg.solve(S, y))))
