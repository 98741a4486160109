"""The scene generator: one period makes a seamless ring, the IMU is
periodic, the distortion inverts, the traffic's noise seed chooses the
sensor noise (CPU)."""

import json

import numpy as np
import torch

from benchmark.harness import manifest as MF
from benchmark.reference.camera import CameraModel
from benchmark.scene import ring as RING

CRUISE = json.loads(MF.traffic_path("cruise").read_text())
CAM0 = CameraModel.load(str(MF.BENCH_DIR / "configs/calib/euroc_cam0.txt"))
SEED = 2 ** 31 + 12345
N = int(CRUISE["period_s"] * CRUISE["fps"])


def test_frame_k_plus_ring_is_frame_k():
    flight = RING.Flight.from_traffic(CRUISE)
    n = N
    assert n == 1200
    k = np.array([0, 1, 7, 113, n - 1])
    a = flight.poses(k / CRUISE["fps"])
    b = flight.poses((k + n) / CRUISE["fps"])
    np.testing.assert_allclose(a, b, atol=1e-9)
    rays = torch.as_tensor(RING.raw_rays(CAM0), dtype=torch.float32)
    tex = RING.Texture(CRUISE)
    ia = RING.render(rays, torch.as_tensor(a[:2], dtype=torch.float32),
                     flight.plane_z, tex)
    ib = RING.render(rays, torch.as_tensor(b[:2], dtype=torch.float32),
                     flight.plane_z, tex)
    assert ia.dtype == torch.uint8 and ia.shape == (2, 480, 752)
    assert torch.equal(ia, ib)


def small_ring(noise_seed=None, imu=True):
    cam = CameraModel(CAM0.pars * np.array([0.25] * 4 + [1] * 4), 188, 120,
                      160, 120)
    config = dict(imu_hz=200, imu_bias_g=[0.005, -0.008, 0.006]) if imu \
        else {}
    traffic = dict(CRUISE)
    if noise_seed is not None:
        traffic["noise_seed"] = noise_seed
    return RING.make_ring(traffic, config, [cam], "cpu")


def test_ring_frames_and_imu_are_seamless_and_periodic():
    ring = small_ring()
    m = ring.imu_per_frame
    assert m == 10
    for k in (0, 1, 113, N - 1):
        assert np.array_equal(ring.frame(k), ring.frame(k + N))
        np.testing.assert_array_equal(ring.gt_pose(k), ring.gt_pose(k + N))
        a, b = ring.imu_for(k), ring.imu_for(k + N)
        assert len(a) == len(b) == m
        for (ta, aa, ga), (tb, ab, gb) in zip(a, b):
            assert abs(tb - ta - CRUISE["period_s"]) < 1e-9
            assert np.array_equal(aa, ab) and np.array_equal(ga, gb)
        # consecutive frames' samples follow each other without a gap
        nxt = ring.imu_for(k + 1)
        assert abs(nxt[0][0] - a[-1][0] - 1 / 200.0) < 1e-9
    # the ring's seam: the last frame and the first are one step apart
    seam = np.linalg.norm(
        ring.poses[0][:3, 3] - ring.poses[-1][:3, 3])
    assert seam < 0.025


def test_imu_matches_the_flight():
    """The specific force and body rates of the ring's IMU agree with the
    flight's analytic acceleration and rotation."""
    ring = small_ring()
    f = ring.flight
    m = ring.imu_per_frame
    t = np.arange(201) / 200.0
    R = f.poses(t)[:, :3, :3]
    acc, gyro = ring.acc[:201].astype(np.float64), ring.gyro[:201]
    a = -f.A * f.wt * f.wt * np.sin(f.wt * t[:, None] + f.pt)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", R, acc),
                               a + RING.GRAVITY, atol=1e-4)
    Ri = R[0]
    for i in range(200):
        w = gyro[i:i + 1].astype(np.float64) - [0.005, -0.008, 0.006]
        Ri = Ri @ RING.so3_exp(w / 200.0)[0]
    assert np.linalg.norm(Ri - R[200]) < 2e-3
    assert m == 10


def test_distortion_inverts():
    xd = np.linspace(-0.8, 0.8, 41)[:, None] * np.ones((1, 41))
    yd = xd.T * 0.6
    x, y = CAM0.undistort_normalized(xd, yd)
    bx, by = CAM0.distort_normalized(x, y)
    assert np.max(np.abs(bx - xd)) < 1e-9 and np.max(np.abs(by - yd)) < 1e-9


def test_cruise_pace():
    """~0.024 m a frame at most at 20 Hz: EuRoC Machine Hall pace."""
    t = np.arange(N + 1) / 20.0
    p = RING.Flight.from_traffic(CRUISE).poses(t)[:, :3, 3]
    step = np.linalg.norm(np.diff(p, axis=0), axis=1)
    assert 0.02 < step.max() < 0.025


def test_the_traffic_noise_seed_chooses_the_sensor_noise_only():
    a, b = small_ring(None, False), small_ring(SEED, False)
    assert a.left.shape == (N, 120, 188) and a.left.dtype == np.uint8
    assert np.array_equal(a.poses, b.poses)
    diff = a.left.astype(np.float64) - b.left.astype(np.float64)
    sigma = CRUISE["noise_sigma"]
    assert 0.8 * sigma < diff.std() / np.sqrt(2) < 1.2 * sigma
    assert abs(diff.mean()) < 0.05
    assert np.array_equal(small_ring(None, False).left, a.left)
    assert np.array_equal(a.gt_pose(3), a.poses[3])
    assert np.array_equal(a.frame(N + 3), a.left[3])
    assert abs(a.frame_time(7) - 7 / 20.0) < 1e-12
    assert 60 < a.left.mean() < 200 and a.left.std() > 10
