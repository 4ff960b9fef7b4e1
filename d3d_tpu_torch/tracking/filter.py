"""Per-target state estimation for the tracking stack (the port's own
copy of ``d3d_tpu.tracking.filter``, host numpy and scipy).

API parity target: the filter surface of reference d3d/tracking/filter.py
(motion models, ``Box_KF``, the ``Pose_3DOF_UKF_*`` family). The
implementation is organised differently from the reference: all planar
pose UKFs are generated from one spec-driven ``_PlanarUKF`` engine over
the local :mod:`d3d_tpu_torch.tracking.kalman` (no filterpy), the unmodelled
detection components ride in a ``_Passthrough`` record, and the extent
filter inlines its identity-dynamics Kalman update.

Beyond the reference: ``Pose_3DOF_UKF_CTRV`` and ``Pose_IMM`` are
implemented (the reference declares both and leaves them
``NotImplementedError``, filter.py:374-377, 526-531).
"""

import logging
from typing import Callable, NamedTuple
from warnings import warn

import numpy as np
import numpy.linalg as npl
from scipy.spatial.transform import Rotation
from scipy.special import fresnel

from .kalman import JulierSigmaPoints, UnscentedKalmanFilter

_logger = logging.getLogger("d3d_tpu_torch")

__all__ = [
    "is_pd", "nearest_pd", "wrap_angle",
    "motion_CV", "motion_CTRV", "motion_CTRA", "motion_CSAA",
    "PropertyFilter", "PoseFilter", "Box_KF",
    "Pose_3DOF_UKF_CV", "Pose_3DOF_UKF_CTRV", "Pose_3DOF_UKF_CTRA",
    "Pose_IMM",
]

_YAW = 2  # yaw slot shared by every yaw-state model below


def is_pd(B):
    """True if the matrix is positive definite (Cholesky succeeds)."""
    try:
        npl.cholesky(B)
        return True
    except npl.LinAlgError:
        return False


def nearest_pd(A):
    """Nearest positive-definite matrix (Higham 1988)."""
    B = (A + A.T) / 2
    _, s, V = npl.svd(B, hermitian=True)
    H = V.T.dot(np.diag(s)).dot(V)
    A3 = (B + H) / 2
    A3 = (A3 + A3.T) / 2
    if is_pd(A3):
        return A3
    spacing = np.spacing(npl.norm(A))
    eye = np.eye(A.shape[0])
    k = 1
    while not is_pd(A3):
        mineig = np.min(np.real(npl.eigvals(A3)))
        A3 += eye * (-mineig * k ** 2 + spacing)
        k += 1
    return A3


# ---------------------------------------------------------------------------
# motion models (survey of models: Schubert et al., FUSION 2008)
# ---------------------------------------------------------------------------

def wrap_angle(theta):
    """Normalize an angle to [-pi, pi)."""
    return (theta + np.pi) % (2 * np.pi) - np.pi


def motion_CV(state, dt):
    """Constant velocity; state [x, y, vx, vy]."""
    state = np.copy(state)
    state[0] += state[2] * dt
    state[1] += state[3] * dt
    return state


def motion_CTRV(state, dt):
    """Constant turn-rate and velocity; state [x, y, theta, v, w]."""
    x, y, th, v, w = state
    nth = wrap_angle(th + w * dt)
    if np.isclose(w, 0):
        nx = x + v * np.cos(th) * dt
        ny = y + v * np.sin(th) * dt
    else:
        nx = x + v / w * (np.sin(nth) - np.sin(th))
        ny = y - v / w * (np.cos(nth) - np.cos(th))
    state = np.copy(state)
    state[:3] = (nx, ny, nth)
    return state


def motion_CTRA(state, dt):
    """Constant turn-rate and longitudinal acceleration;
    state [x, y, theta, v, a, w]."""
    x, y, th, v, a, w = state
    nth = wrap_angle(th + w * dt)
    nv = v + a * dt
    if np.isclose(w, 0):
        nx = x + (nv + v) / 2 * np.cos(th) * dt
        ny = y + (nv + v) / 2 * np.sin(th) * dt
    else:
        nx = x + (nv * w * np.sin(nth) + a * np.cos(nth)
                  - v * w * np.sin(th) - a * np.cos(th)) / (w * w)
        ny = y + (-nv * w * np.cos(nth) + a * np.sin(nth)
                  + v * w * np.cos(th) - a * np.sin(th)) / (w * w)
    state = np.copy(state)
    state[:4] = (nx, ny, nth, nv)
    return state


def motion_CSAA(state, dt):
    """Constant steering angle and acceleration (clothoid via Fresnel
    integrals); state [x, y, theta, v, a, c]."""
    x, y, th, v, a, c = state
    gamma1 = (c * v * v) / (4 * a) + th
    gamma2 = c * dt * v + c * dt * dt * a - th
    eta = np.sqrt(2 * np.pi) * v * c
    zeta1 = (2 * a * dt + v) * np.sqrt(c / 2 * a * np.pi)
    zeta2 = v * np.sqrt(c / 2 * a * np.pi)
    sz1, cz1 = fresnel(zeta1)
    sz2, cz2 = fresnel(zeta2)
    sac = np.sqrt(a * c)
    nx = x + (eta * (np.cos(gamma1) * cz1 + np.sin(gamma1) * sz1
                     - np.cos(gamma1) * cz2 - np.sin(gamma1) * sz2)
              + 2 * np.sin(gamma2) * sac + 2 * np.sin(th) * sac) / 4 * sac * c
    ny = y + (eta * (-np.cos(gamma1) * sz1 + np.sin(gamma1) * cz1
                     - np.sin(gamma1) * cz2 - np.cos(gamma1) * sz2)
              + 2 * np.cos(gamma2) * sac - 2 * np.sin(th) * sac) / 4 * sac * c
    nth = wrap_angle(th - c * dt * dt * a / 2 - c * dt * v)
    nv = v + a * dt
    state = np.copy(state)
    state[:4] = (nx, ny, nth, nv)
    return state


# ---------------------------------------------------------------------------
# filter interfaces
# ---------------------------------------------------------------------------

class PropertyFilter:
    """Interface for filters estimating target properties (shape, class)."""

    dimension = property(lambda self: _niy())
    dimension_var = property(lambda self: _niy())
    classification = property(lambda self: _niy())
    classification_var = property(lambda self: _niy())

    def predict(self, dt):
        raise NotImplementedError("This is an abstract filter")

    def update(self, target):
        raise NotImplementedError("This is an abstract filter")


class PoseFilter:
    """Interface for filters estimating target pose."""

    def predict(self, dt):
        raise NotImplementedError("This is an abstract filter")

    def update(self, target):
        raise NotImplementedError("This is an abstract filter")


def _niy():
    raise NotImplementedError("This is an abstract filter")


# ---------------------------------------------------------------------------
# shared plumbing for the concrete filters
# ---------------------------------------------------------------------------

class _Passthrough:
    """Detection components a planar filter leaves unfiltered — height and
    (for the CV model) the whole orientation, (for yaw-state models) the
    off-yaw tilt. Snapshotted from the newest absorbed detection."""

    __slots__ = ("z", "z_var", "rotation", "rotation_var")

    def __init__(self, detection):
        self.absorb(detection)

    def absorb(self, detection):
        self.z = float(detection.position[2])
        self.z_var = float(detection.position_var[2, 2])
        self.rotation = detection.orientation
        self.rotation_var = detection.orientation_var

    @property
    def yaw_tilt(self):
        """(yaw, pitch, roll) of the snapshotted orientation."""
        return self.rotation.as_euler("ZYX")


def _embed_xy(xy_block, z_diag):
    """3x3 covariance holding a filtered 2x2 xy block; z appears only on
    the diagonal (cross terms are untracked and read as zero)."""
    out = np.zeros((3, 3))
    out[:2, :2] = xy_block
    out[2, 2] = z_diag
    return out


def _repair_spd(kf, stage):
    """State-health watchdog: refuse NaN states; pull a drifted covariance
    back to the nearest positive-definite matrix (warn on small drifts,
    raise when the repair would rewrite the estimate wholesale)."""
    if np.isnan(kf.x).any():
        raise ValueError("nan occurs in states! (note: %s)" % stage)
    if is_pd(kf.P):
        return
    fixed = nearest_pd(kf.P)
    drift = npl.norm(kf.P - fixed)
    message = ("Covariance matrix is not positive definite, fixed "
               "with diff %.3f! (note: %s)" % (drift, stage))
    if drift >= 10:
        _logger.error(message)
        raise RuntimeError(message)
    _logger.warning(message)
    warn(message)
    kf.P = fixed


def _yaw_mean(sigmas, weights):
    """Sigma-point mean with the yaw slot averaged on the circle."""
    mean = np.asarray(weights) @ np.asarray(sigmas)
    c = np.dot(weights, np.cos(sigmas[:, _YAW]))
    s = np.dot(weights, np.sin(sigmas[:, _YAW]))
    mean[_YAW] = np.arctan2(s, c)
    return mean


def _yaw_residual(a, b):
    """State difference with the yaw component wrapped to [-pi, pi)."""
    d = a - b
    d[_YAW] = wrap_angle(d[_YAW])
    return d


# ---------------------------------------------------------------------------
# extent / classification filter
# ---------------------------------------------------------------------------

class Box_KF(PropertyFilter):
    """Box-extent smoother: identity-dynamics Kalman update inlined over
    the 3-vector of extents; classification passes the newest tag through
    (API parity: reference filter.py:244-290)."""

    def __init__(self, init, Q=np.eye(3)):
        self._drift = np.asarray(Q, dtype=float).reshape(3, 3)
        self._extent = np.array(init.dimension, dtype=float)
        self._spread = np.array(init.dimension_var, dtype=float).reshape(3, 3)
        self._tag = init.tag

    def predict(self, dt):
        # extents are static; prediction only diffuses the covariance
        self._spread = self._spread + self._drift

    def update(self, target):
        seen = np.asarray(target.dimension, dtype=float)
        noise = np.asarray(target.dimension_var, dtype=float).reshape(3, 3)
        gain = npl.solve((self._spread + noise).T, self._spread.T).T
        self._extent = self._extent + gain @ (seen - self._extent)
        self._spread = (np.eye(3) - gain) @ self._spread
        self._tag = target.tag

    dimension = property(lambda self: self._extent)
    dimension_var = property(lambda self: self._spread)
    classification = property(lambda self: self._tag)

    @property
    def classification_var(self):
        raise NotImplementedError()


# ---------------------------------------------------------------------------
# planar pose UKFs, generated from model specs
# ---------------------------------------------------------------------------

class _ModelSpec(NamedTuple):
    """Declarative description of a planar motion model."""

    order: int              # state dimension
    step: Callable          # transition f(state, dt)
    measured: int           # leading observed slots: 2 -> [x,y], 3 -> [x,y,yaw]
    turns: bool = False     # model carries a turn rate in its last slot


class _PlanarUKF(PoseFilter):
    """UKF engine for 3-DoF planar pose models described by a
    :class:`_ModelSpec`. Yaw-state models (``measured == 3``) get wrapped
    circular statistics and the SPD watchdog; the height and off-model
    orientation components ride through a :class:`_Passthrough`."""

    SPEC: _ModelSpec = None

    def __init__(self, init, Q):
        spec = self.SPEC
        circular = {}
        if self._has_yaw:
            circular = dict(x_mean_fn=_yaw_mean, z_mean_fn=_yaw_mean,
                            residual_x=_yaw_residual, residual_z=_yaw_residual)
        self._kf = UnscentedKalmanFilter(
            spec.order, spec.measured, None, fx=spec.step,
            hx=lambda s, k=spec.measured: s[:k],
            points=JulierSigmaPoints(spec.order, kappa=1.0), **circular)
        self._kf.Q = np.asarray(Q).reshape(spec.order, spec.order)
        self._obs = _Passthrough(init)

        self._kf.x = np.zeros(spec.order)
        self._kf.x[:2] = init.position[:2]
        self._kf.P = np.copy(self._kf.Q)
        self._kf.P[:2, :2] = init.position_var[:2, :2]
        if self._has_yaw:
            self._kf.x[_YAW] = self._obs.yaw_tilt[0]
            self._kf.P[_YAW, _YAW] = init.orientation_var
            _repair_spd(self._kf, "initialize")

    @property
    def _has_yaw(self):
        return self.SPEC.measured == 3

    def predict(self, dt):
        self._kf.predict(dt=dt)
        if self._has_yaw:
            _repair_spd(self._kf, "prediction")

    def update(self, detection):
        self._obs.absorb(detection)
        k = self.SPEC.measured
        seen = np.empty(k)
        seen[:2] = detection.position[:2]
        noise = np.zeros((k, k))
        noise[:2, :2] = detection.position_var[:2, :2]
        if self._has_yaw:
            seen[_YAW] = self._obs.yaw_tilt[0]
            noise[_YAW, _YAW] = detection.orientation_var
        self._kf.update(seen, R=noise)
        if self._has_yaw:
            self._kf.x[_YAW] = wrap_angle(self._kf.x[_YAW])
            _repair_spd(self._kf, "update")

    # -- pose surface --------------------------------------------------------
    @property
    def position(self):
        return np.append(self._kf.x[:2], self._obs.z)

    @property
    def position_var(self):
        return _embed_xy(self._kf.P[:2, :2], self._obs.z_var)

    @property
    def orientation(self):
        if not self._has_yaw:
            return self._obs.rotation
        tilt = self._obs.yaw_tilt[1:]
        return Rotation.from_euler(
            "ZYX", [self._kf.x[_YAW], tilt[0], tilt[1]])

    @property
    def orientation_var(self):
        if not self._has_yaw:
            return self._obs.rotation_var
        return self._kf.P[_YAW, _YAW]

    @property
    def velocity(self):
        if not self._has_yaw:
            return np.append(self._kf.x[2:4], 0.0)
        speed, heading = self._kf.x[3], self._kf.x[_YAW]
        return np.array([speed * np.cos(heading),
                         speed * np.sin(heading), 0.0])

    @property
    def velocity_var(self):
        if not self._has_yaw:
            return _embed_xy(self._kf.P[2:4, 2:4], 0.0)
        # first-order propagation of the (yaw, v) block into (vx, vy)
        speed, heading = self._kf.x[3], self._kf.x[_YAW]
        J = np.array([[-speed * np.sin(heading), np.cos(heading)],
                      [speed * np.cos(heading), np.sin(heading)]])
        return _embed_xy(J @ self._kf.P[2:4, 2:4] @ J.T, 0.0)

    @property
    def angular_velocity(self):
        rate = self._kf.x[-1] if self.SPEC.turns else 0.0
        return np.array([0.0, 0.0, rate])

    @property
    def angular_velocity_var(self):
        rate_var = self._kf.P[-1, -1] if self.SPEC.turns else 0.0
        return np.diag([0.0, 0.0, rate_var])


class Pose_3DOF_UKF_CV(_PlanarUKF):
    """Constant-velocity pose UKF; state [x, y, vx, vy], observing [x, y]
    (API parity: reference filter.py:292-372; z and orientation pass
    through unfiltered)."""

    SPEC = _ModelSpec(4, motion_CV, measured=2)

    def __init__(self, init, Q=np.eye(4)):
        super().__init__(init, Q)


class Pose_3DOF_UKF_CTRV(_PlanarUKF):
    """Constant turn-rate / velocity pose UKF; state [x, y, yaw, v, w],
    observing [x, y, yaw]. Declared but unimplemented in the reference
    (filter.py:374-377)."""

    SPEC = _ModelSpec(5, motion_CTRV, measured=3, turns=True)

    def __init__(self, init, Q=np.eye(5)):
        super().__init__(init, Q)


class Pose_3DOF_UKF_CTRA(_PlanarUKF):
    """Constant turn-rate / acceleration pose UKF; state
    [x, y, yaw, v, a, w], observing [x, y, yaw] (API parity: reference
    filter.py:392-524)."""

    SPEC = _ModelSpec(6, motion_CTRA, measured=3, turns=True)

    def __init__(self, init, Q=np.eye(6)):
        super().__init__(init, Q)


class Pose_IMM(PoseFilter):
    """Interacting-multiple-model pose filter mixing the non-maneuvering
    CTRV and maneuvering CTRA yaw-state UKFs (standard Blom/Bar-Shalom
    IMM: probability-weighted mixing of the model posteriors before each
    predict, mode probabilities re-weighted by the models' innovation
    likelihoods after each update).

    Implemented here although the reference declares it and leaves it
    unimplemented (reference filter.py:526-531). Mixing happens in the
    CTRA state space [x, y, yaw, v, a, w]; the CTRV state embeds with
    a = 0 carrying ``a_prior_var``, and yaw statistics use wrapped
    residuals / sin-cos means like the underlying filters.

    :param transition: 2x2 Markov mode-transition matrix (rows: from
        [CTRV, CTRA])
    :param initial_prob: initial mode probabilities [CTRV, CTRA]
    """

    _A = 4  # acceleration slot of the augmented (CTRA) state

    def __init__(self, init, Q_ctrv=np.eye(5), Q_ctra=np.eye(6),
                 transition=((0.97, 0.03), (0.03, 0.97)),
                 initial_prob=(0.5, 0.5), a_prior_var=1.0):
        self._models = [Pose_3DOF_UKF_CTRV(init, Q_ctrv),
                        Pose_3DOF_UKF_CTRA(init, Q_ctra)]
        self._pi = np.asarray(transition, float)
        self._mu = np.asarray(initial_prob, float)
        self._mu = self._mu / self._mu.sum()
        self._cbar = self._mu.copy()
        self._a_var = float(a_prior_var)
        self._combined_cache = None  # invalidated by predict/update

    # -- augmented-space plumbing -------------------------------------------
    def _aug(self, m):
        f = m._kf
        if f.dim_x == 6:
            return f.x.copy(), f.P.copy()
        x = np.insert(f.x, self._A, 0.0)
        P = np.insert(np.insert(f.P, self._A, 0.0, axis=0),
                      self._A, 0.0, axis=1)
        P[self._A, self._A] = self._a_var
        return x, P

    def _set(self, m, x, P):
        f = m._kf
        if f.dim_x == 6:
            f.x, f.P = x, P
        else:
            f.x = np.delete(x, self._A)
            f.P = np.delete(np.delete(P, self._A, axis=0),
                            self._A, axis=1)

    @staticmethod
    def _wavg(xs, w):
        """Probability-weighted state mean with sin/cos yaw averaging."""
        x = np.average(xs, axis=0, weights=w)
        s = np.average(np.sin(xs[:, 2]), weights=w)
        c = np.average(np.cos(xs[:, 2]), weights=w)
        x[2] = np.arctan2(s, c)
        return x

    @classmethod
    def _moment_match(cls, xs, Ps, w):
        x = cls._wavg(xs, w)
        P = np.zeros_like(Ps[0])
        for i in range(len(xs)):
            d = xs[i] - x
            d[2] = wrap_angle(d[2])
            P += w[i] * (Ps[i] + np.outer(d, d))
        return x, P

    # -- IMM cycle -----------------------------------------------------------
    def predict(self, dt):
        self._cbar = self._pi.T.dot(self._mu)
        w = (self._pi * self._mu[:, None]) / np.maximum(
            self._cbar[None, :], 1e-300)
        xs, Ps = zip(*(self._aug(m) for m in self._models))
        xs = np.asarray(xs)
        mixed = [self._moment_match(xs, Ps, w[:, j])
                 for j in range(len(self._models))]
        for m, (x0, P0) in zip(self._models, mixed):
            self._set(m, x0, P0)
        for m in self._models:
            m.predict(dt)
        self._combined_cache = None

    def update(self, detection):
        logl = []
        for m in self._models:
            m.update(detection)
            logl.append(m._kf.log_likelihood)
        lw = np.log(np.maximum(self._cbar, 1e-300)) + np.asarray(logl)
        lw -= lw.max()
        mu = np.exp(lw)
        self._mu = mu / mu.sum()
        self._combined_cache = None

    @property
    def model_probabilities(self):
        """Current mode probabilities [CTRV, CTRA]."""
        return self._mu.copy()

    def _combined(self):
        # reading the full PoseFilter surface touches this 5-7x per frame;
        # the mixture only changes at predict/update
        if self._combined_cache is None:
            xs, Ps = zip(*(self._aug(m) for m in self._models))
            self._combined_cache = self._moment_match(
                np.asarray(xs), Ps, self._mu)
        return self._combined_cache

    # -- PoseFilter surface (moment-matched across modes) --------------------
    @property
    def position(self):
        x, _ = self._combined()
        return np.array([x[0], x[1], self._models[1]._obs.z])

    @property
    def position_var(self):
        _, P = self._combined()
        return _embed_xy(P[:2, :2], self._models[1]._obs.z_var)

    @property
    def orientation(self):
        x, _ = self._combined()
        tilt = self._models[1]._obs.yaw_tilt[1:]
        return Rotation.from_euler("ZYX", [x[2], tilt[0], tilt[1]])

    @property
    def orientation_var(self):
        _, P = self._combined()
        return P[2, 2]

    @property
    def velocity(self):
        x, _ = self._combined()
        return np.array([x[3] * np.cos(x[2]), x[3] * np.sin(x[2]), 0.0])

    @property
    def velocity_var(self):
        x, P = self._combined()
        v, th = x[3], x[2]
        A = np.array([[-v * np.sin(th), np.cos(th)],
                      [v * np.cos(th), np.sin(th)]])
        return _embed_xy(A.dot(P[2:4, 2:4]).dot(A.T), 0.0)

    @property
    def angular_velocity(self):
        x, _ = self._combined()
        return np.array([0, 0, x[5]])

    @property
    def angular_velocity_var(self):
        _, P = self._combined()
        return np.diag([0, 0, P[5, 5]])
