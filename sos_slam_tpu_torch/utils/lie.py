"""SO(3) / SE(3) Lie groups in PyTorch (port of sos_slam_tpu/utils/lie.py).

Conventions follow Sophus, as the reference does:
  * group elements are homogeneous matrices: SO3 -> (3,3), SE3 -> (4,4);
  * tangent vectors put translation first: se3 = [v(3), w(3)];
  * every function is batch-friendly over leading dims and f32-safe via
    Taylor fallbacks near theta = 0 (the same switch points as the JAX
    package, so both give the same branches on the same inputs).

The numpy twins `np_*` are float64 host helpers for pose bookkeeping.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-6  # small-angle switch; sq errors ~theta^4 < f32 ulp below this


def _eye(n, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w (…,3) -> (…,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def so3_vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _sinc_cosc(theta2):
    """A = sin(t)/t and B = (1-cos(t))/t^2 with Taylor fallbacks."""
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < _EPS
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    return A, B


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, -1)
    A, B = _sinc_cosc(theta2)
    W = so3_hat(w)
    I = _eye(3, w).expand(W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(…,3,3) -> (…,3). Safe for theta in [0, pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    theta2 = theta * theta
    sin_t = torch.sin(theta)
    small = theta2 < _EPS
    fac = torch.where(small, 0.5 + theta2 / 12.0,
                      theta / torch.clamp(2.0 * sin_t, min=1e-24))
    w = fac[..., None] * so3_vee(R - R.transpose(-1, -2))
    near_pi = cos_t < -0.99999
    M = (R + _eye(3, R).expand(R.shape)) * 0.5
    diag = torch.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], -1)
    k = torch.argmax(diag, -1)
    col = torch.gather(M, -1, k[..., None, None].expand(*M.shape[:-1], 1))[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True),
                             min=1e-24)
    w_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def _se3_V(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, -1)
    small = theta2 < _EPS
    A, B = _sinc_cosc(theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - A) / torch.clamp(theta2, min=1e-24))
    W = so3_hat(w)
    I = _eye(3, w).expand(W.shape)
    return I + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _se3_Vinv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < _EPS
    half = theta * 0.5
    cot_term = half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-24)
    k = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - cot_term) / torch.clamp(theta2, min=1e-24))
    W = so3_hat(w)
    I = _eye(3, w).expand(W.shape)
    return I - 0.5 * W + k[..., None, None] * (W @ W)


def compose_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """exp: (…,6) [v,w] -> (…,4,4)."""
    v, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    t = (_se3_V(w) @ v[..., None])[..., 0]
    return compose_rt(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """log: (…,4,4) -> (…,6) [v,w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    v = (_se3_Vinv(w) @ t[..., None])[..., 0]
    return torch.cat([v, w], -1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return compose_rt(Rt, -(Rt @ t[..., None])[..., 0])


def se3_adj(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3), (…,6,6) acting on [v,w]: [[R, [t]x R], [0, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    A = torch.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype, device=T.device)
    A[..., :3, :3] = R
    A[..., :3, 3:] = so3_hat(t) @ R
    A[..., 3:, 3:] = R
    return A


# ---------------------------------------------------------------------------
# float64 numpy twins for host-side pose bookkeeping
# ---------------------------------------------------------------------------

def _np_hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def np_so3_exp(w):
    w = np.asarray(w, np.float64)
    th2 = float(w @ w)
    W = _np_hat(w)
    if th2 < 1e-12:
        return np.eye(3) + W + 0.5 * (W @ W)
    th = np.sqrt(th2)
    return np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th2 * (W @ W)


def np_so3_log(R):
    R = np.asarray(R, np.float64)
    cos_t = np.clip((np.trace(R) - 1) * 0.5, -1.0, 1.0)
    th = np.arccos(cos_t)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-7:
        return 0.5 * v
    if cos_t < -0.99999:
        M = (R + np.eye(3)) * 0.5
        k = int(np.argmax(np.diag(M)))
        axis = M[:, k] / max(np.linalg.norm(M[:, k]), 1e-12)
        return axis * th
    return th / (2 * np.sin(th)) * v


def np_se3_exp(xi):
    xi = np.asarray(xi, np.float64)
    v, w = xi[:3], xi[3:]
    R = np_so3_exp(w)
    th2 = float(w @ w)
    W = _np_hat(w)
    if th2 < 1e-12:
        V = np.eye(3) + 0.5 * W + (W @ W) / 6.0
    else:
        th = np.sqrt(th2)
        V = np.eye(3) + (1 - np.cos(th)) / th2 * W \
            + (th - np.sin(th)) / (th2 * th) * (W @ W)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def np_se3_log(T):
    T = np.asarray(T, np.float64)
    w = np_so3_log(T[:3, :3])
    th2 = float(w @ w)
    W = _np_hat(w)
    if th2 < 1e-12:
        Vinv = np.eye(3) - 0.5 * W + (W @ W) / 12.0
    else:
        th = np.sqrt(th2)
        half = th * 0.5
        k = (1 - half * np.cos(half) / np.sin(half)) / th2
        Vinv = np.eye(3) - 0.5 * W + k * (W @ W)
    return np.concatenate([Vinv @ T[:3, 3], w])


def np_quat_to_rot(q):
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
