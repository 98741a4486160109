"""The port's trajectory evaluation (utils/evaluate.py) against the JAX
package's, and the alignment `chip_smoke.py` gates the loop scene on.

Both modules are numpy float64 on the host, so every comparison with the
JAX package is exact. Inputs: seeded numpy draws."""

import numpy as np
import pytest

from sos_slam_tpu.utils import evaluate as JE
from sos_slam_tpu_torch.utils import evaluate as TE


def _pair(seed, n=40, scale=2.5, noise=0.01):
    """(src, dst): a seeded cloud and a noisy similarity transform of it."""
    r = np.random.RandomState(seed)
    src = r.randn(n, 3)
    R, _ = np.linalg.qr(r.randn(3, 3))
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    dst = (scale * (R @ src.T)).T + r.randn(3) + noise * r.randn(n, 3)
    return src, dst


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_and_ate_match(seed, with_scale):
    src, dst = _pair(seed)
    for a, b in zip(JE.umeyama(src, dst, with_scale),
                    TE.umeyama(src, dst, with_scale)):
        np.testing.assert_array_equal(a, b)
    assert JE.ate_rmse(src, dst, with_scale) \
        == TE.ate_rmse(src, dst, with_scale)


def test_umeyama_recovers_a_similarity():
    """tests/test_evaluate.py's exact case on the port."""
    src, dst = _pair(0, n=50, noise=0.0)
    R, t, s = TE.umeyama(src, dst, with_scale=True)
    np.testing.assert_allclose(s, 2.5, rtol=1e-6)
    np.testing.assert_allclose((s * (R @ src.T)).T + t, dst, atol=1e-6)
    assert TE.ate_rmse(src, dst, align_scale=True)["rmse"] < 1e-6
    assert TE.ate_rmse(src, 2.0 * src, align_scale=False)["rmse"] > 0.5


def test_associate_match():
    r = np.random.RandomState(3)
    gt_t = np.sort(r.uniform(0, 10, 200))
    gt_xyz = r.randn(200, 3)
    est_t = np.sort(r.uniform(0, 10, 80))
    est_xyz = r.randn(80, 3)
    for a, b in zip(JE.associate_by_time(est_t, est_xyz, gt_t, gt_xyz),
                    TE.associate_by_time(est_t, est_xyz, gt_t, gt_xyz)):
        np.testing.assert_array_equal(a, b)
    ids = np.arange(200)
    traj = np.concatenate([r.choice(300, (60, 1), replace=False),
                           r.randn(60, 3)], 1)
    for a, b in zip(JE.associate_by_id(traj, ids, gt_xyz),
                    TE.associate_by_id(traj, ids, gt_xyz)):
        np.testing.assert_array_equal(a, b)
    est, gt = TE.associate_by_time(np.array([0.0, 0.1, 0.2, 0.35]),
                                   np.eye(4, 3),
                                   np.array([0.001, 0.099, 0.26, 0.349]),
                                   np.ones((4, 3)), max_dt=0.02)
    assert len(est) == len(gt) == 3   # 0.2 has no partner within 20 ms


def _rigid_ate(est, gt):
    """RMSE of est against gt after the least-squares rigid alignment, as
    chip_smoke.py computed its loop scene's drift gate before it called
    `ate_rmse`."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e) / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    aligned = (R @ (est - mu_e).T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, 1))))


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_rigid_ate_is_ate_rmse_without_scale(seed):
    est, gt = _pair(seed, n=20, scale=1.0, noise=0.3)
    assert abs(_rigid_ate(est, gt)
               - TE.ate_rmse(est, gt, align_scale=False)["rmse"]) <= 1e-12
