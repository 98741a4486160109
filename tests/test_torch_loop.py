"""The port's loop-closure modules against sos_slam_tpu/loop.

Scan Context (host numpy float64 in both packages): exact equality. The
JAX package's ScanAccumulator prefers its g++ voxel filter, which returns
the same voxels in another order; it is switched to its numpy form here so
that the point order, and with it every output, is held exactly.

The pose graph on the four scenarios of tests/test_loop.py, ICP and the
direct alignment on a rendered 256x192 pair, at the repo's ladder: 2e-4
on a block-tridiagonal solve, 5e-3 on a pose-graph optimization (a run
of full GN steps), the tracker's 1e-4 on an aligned pose and 1e-3 on its
residual (tests/test_torch_tracker.py). At 1000 vertices the f32 solve
is dominated by rounding in both packages (each lies ~10 m from a
float64 solve of the same graph after 25 iterations, on poses 126 m from
the origin), so that scenario is held to tests/test_loop.py's own
assertions in both packages, and to its < 10 s warm bound.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_slam_tpu import native
from sos_slam_tpu.loop import pose_estimator as JPE
from sos_slam_tpu.loop import pose_graph as JPG
from sos_slam_tpu.loop import scancontext as JSC
from sos_slam_tpu.ops.image import build_pyramid as j_build_pyramid
from sos_slam_tpu.utils import lie as jlie
from sos_slam_tpu.utils import synthetic as jsyn
from sos_slam_tpu_torch.loop import pose_estimator as TPE
from sos_slam_tpu_torch.loop import pose_graph as TPG
from sos_slam_tpu_torch.loop import scancontext as TSC
from sos_slam_tpu_torch.models.full_system import _np_bilinear
from sos_slam_tpu_torch.utils import lie as tlie
from tests.test_loop import _pack, make_structured_cloud
from tests.test_torch_helpers import GN_TOL, close, exact, t


@pytest.fixture
def numpy_voxels(monkeypatch):
    monkeypatch.setattr(native, "scan_voxel_filter", lambda *a, **k: None)


def _exact_tree(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _exact_tree(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------------
# Scan Context
# ----------------------------------------------------------------------
@pytest.mark.parametrize("enable_imu", [False, True])
def test_scancontext_descriptors_exact(enable_imu):
    rng = np.random.RandomState(5)
    for seed in (0, 99):
        cloud = make_structured_cloud(seed=seed) + rng.randn(600, 3) * 0.05
        T = np.eye(4)
        T[:3, :3] = jlie.np_so3_exp(rng.randn(3) * 0.2)
        T[:3, 3] = rng.randn(3)
        _exact_tree(JSC.pca_align(cloud, T, enable_imu),
                    TSC.pca_align(cloud, T, enable_imu))
        Tsc = JSC.pca_align(cloud, T, enable_imu)
        for r in (15.0, 30.0):
            _exact_tree(JSC.generate(cloud, Tsc, r),
                        TSC.generate(cloud, Tsc, r))
        _exact_tree(JSC.process_scan_downward(T, cloud, 15.0, enable_imu),
                    TSC.process_scan_downward(T, cloud, 15.0, enable_imu))
    _exact_tree(JSC.generate(np.zeros((0, 3)), np.eye(4), 30.0),
                TSC.generate(np.zeros((0, 3)), np.eye(4), 30.0))


def test_scan_accumulator_exact(numpy_voxels):
    """Forward-camera scan assembly over a turning trajectory (orientation
    pruning after 0.5 rad, range filter, voxel keep-highest)."""
    rng = np.random.RandomState(1)
    env = make_structured_cloud(n=1500, seed=3)
    ja = JSC.ScanAccumulator(20.0, enable_imu=False)
    ta = TSC.ScanAccumulator(20.0, enable_imu=False)
    T = np.eye(4)
    step = jlie.np_se3_exp(np.array([1.5, 0.0, 0.5, 0.0, 0.15, 0.0]))
    for fid in range(12):
        T = T @ step
        T_cw = np.linalg.inv(T)
        pc = env @ T_cw[:3, :3].T + T_cw[:3, 3]
        pc = pc[rng.rand(len(pc)) < 0.3]
        _exact_tree(ja.process(fid, T, pc), ta.process(fid, T, pc))
        exact(ja.pts_w, ta.pts_w)
        exact(ja.fids, ta.fids)
        assert sorted(ja.id2pose) == sorted(ta.id2pose)
    _exact_tree(ja.process(99, T, np.zeros((0, 3))),
                ta.process(99, T, np.zeros((0, 3))))


def test_ringkey_index_and_search_exact():
    rng = np.random.RandomState(2)
    ji, ti = JSC.RingkeyIndex(margin=6), TSC.RingkeyIndex(margin=6)
    base = rng.rand(5, JSC.NUM_R)
    sigs = [rng.rand(JSC.NUM_S, JSC.NUM_R) for _ in range(40)]
    for i in range(40):
        rk = base[i % 5] + rng.randn(JSC.NUM_R) * 0.02
        cj, ct = ji.search_and_insert(rk), ti.search_and_insert(rk)
        assert cj == ct
        if cj:
            assert JSC.search_sc(sigs[i], cj, sigs) \
                == TSC.search_sc(sigs[i], ct, sigs)
    assert len(ti.keys) == len(ji.keys) and ti.queue is not ji.queue


# ----------------------------------------------------------------------
# block-tridiagonal solve and the pose graph
# ----------------------------------------------------------------------
def test_block_tridiag_solve_matches():
    rng = np.random.RandomState(4)
    N, K = 20, 3
    O = rng.randn(N, 6, 6).astype(np.float32) * 0.3
    O[-1] = 0.0
    D = np.stack([a @ a.T + 6 * np.eye(6) for a in rng.randn(N, 6, 6)]
                 ).astype(np.float32)
    B = rng.randn(N, 6, K).astype(np.float32)
    xj = np.asarray(JPG.block_tridiag_solve(jnp.asarray(D), jnp.asarray(O),
                                            jnp.asarray(B)))
    xt = TPG.block_tridiag_solve(t(D), t(O), t(B))
    close(xj, xt)
    dense = np.zeros((6 * N, 6 * N))
    for i in range(N):
        dense[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[i]
        if i + 1 < N:
            dense[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = O[i]
            dense[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = O[i].T
    ref = np.linalg.solve(dense, B.reshape(6 * N, K)).reshape(N, 6, K)
    close(xt, ref, tol=1e-3)
    close(JPG._blockdiag(jnp.asarray(D[:3])), TPG._blockdiag(t(D[:3])))
    for pe, se in ((0.5, 2.0), (1e-12, -1.0), (3.0, 0.0)):
        exact(JPG.edge_information(pe, se), TPG.edge_information(pe, se))


def _drift_scene(n, step_xi, drift_xi, rng=None, noise=0.0):
    gt = [np.eye(4)]
    for _ in range(1, n):
        xi = np.asarray(step_xi, np.float64)
        if rng is not None:
            xi = xi + rng.randn(6) * noise
        gt.append(gt[-1] @ np.asarray(jlie.se3_exp(
            jnp.asarray(xi, jnp.float32))))
    gt = np.stack(gt)
    drift = np.asarray(jlie.se3_exp(jnp.asarray(drift_xi, jnp.float32)))
    odo = [np.eye(4)]
    for i in range(1, n):
        odo.append(odo[-1] @ np.linalg.inv(gt[i - 1]) @ gt[i] @ drift)
    chain = [(i, i + 1, np.linalg.inv(gt[i]) @ gt[i + 1] @ drift, np.eye(6))
             for i in range(n - 1)]
    return gt, np.stack(odo), chain


def _inputs(odo, chain, loops, fixed_idx, N=None, Ec=None, El=16):
    n = len(odo)
    N = N or n
    T = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    T[:n] = odo
    v_valid = np.arange(N) < n
    fixed = ~v_valid
    fixed[fixed_idx] = True
    Ec = Ec or (1 << max(4, (max(len(chain), 1) - 1).bit_length()))
    return (T, v_valid, fixed, *(np.asarray(a) for a in _pack(chain, Ec)),
            *(np.asarray(a) for a in _pack(loops, El)))


def _both(args, n_iters):
    tj = np.asarray(JPG.optimize_pose_graph(
        *(jnp.asarray(a) for a in args), n_iters=n_iters))
    tt = TPG.optimize_pose_graph(*(t(a) for a in args), n_iters=n_iters)
    return tj, tt.numpy()


def _loop_err(T, gt, a, b):
    rel = np.linalg.inv(gt[a]) @ gt[b]
    return np.linalg.norm(tlie.np_se3_log(
        np.linalg.inv(rel) @ (np.linalg.inv(T[a]) @ T[b])))


def test_pose_graph_corrects_drift():
    """tests/test_loop.py: a 16-vertex square loop, the loop edge from the
    fixed vertex 0 to the free end (the one-fixed path)."""
    n = 16
    gt, odo, chain = _drift_scene(n, [1.0, 0, 0, 0, np.pi / 8, 0],
                                  [0.02, 0.01, -0.015, 0.002, 0.004, 0.0])
    loops = [(0, n - 1, np.linalg.inv(gt[0]) @ gt[n - 1], np.eye(6) * 100.0)]
    tj, tt = _both(_inputs(odo, chain, loops, fixed_idx=0), 30)
    close(tj, tt, tol=GN_TOL)
    err_before = np.linalg.norm(odo[n - 1][:3, 3] - gt[n - 1][:3, 3])
    err_after = np.linalg.norm(tt[n - 1][:3, 3] - gt[n - 1][:3, 3])
    assert err_after < 0.35 * err_before, (err_before, err_after)


def test_pose_graph_loop_between_free_vertices():
    """tests/test_loop.py: both-free loop edge (the Woodbury path), newest
    vertex fixed, padded to N=32."""
    n = 20
    gt, odo, chain = _drift_scene(n, [1.0, 0, 0, 0, np.pi / 9, 0],
                                  [0.03, 0.01, -0.02, 0.003, 0.005, 0.0])
    loops = [(1, n - 2, np.linalg.inv(gt[1]) @ gt[n - 2], np.eye(6) * 100.0)]
    tj, tt = _both(_inputs(odo, chain, loops, fixed_idx=n - 1, N=32), 30)
    close(tj, tt, tol=GN_TOL)
    assert _loop_err(tt, gt, 1, n - 2) < 0.35 * _loop_err(odo, gt, 1, n - 2)


def test_pose_graph_chain_without_loops_is_stable():
    n = 8
    step = np.asarray(jlie.se3_exp(jnp.asarray(
        [0.5, 0.1, 0.2, 0.02, 0.05, 0.01], jnp.float32)))
    T = [np.eye(4)]
    for _ in range(1, n):
        T.append(T[-1] @ step)
    chain = [(i, i + 1, step, np.eye(6)) for i in range(n - 1)]
    tj, tt = _both(_inputs(np.stack(T), chain, [], fixed_idx=n - 1), 10)
    close(tj, tt, tol=GN_TOL)
    np.testing.assert_allclose(tt[:n], np.stack(T), atol=2e-3)


def test_pose_graph_large_graph_scales():
    """tests/test_loop.py's 1000-keyframe graph (N=1024, Ec=1024, El=16,
    four loop edges): its assertions in both packages, and the port's
    warm call under the same 10 s."""
    n = 1000
    gt, odo, chain = _drift_scene(
        n, [1.0, 0, 0, 0, 2 * np.pi / 360, 0],
        [0.01, 0.004, -0.006, 0.0008, 0.0012, 0.0],
        rng=np.random.RandomState(0), noise=0.01)
    pairs = [(5, 360), (200, 560), (400, 760), (30, 930)]
    loops = [(a, b, np.linalg.inv(gt[a]) @ gt[b], np.eye(6) * 100.0)
             for a, b in pairs]
    args = _inputs(odo, chain, loops, fixed_idx=n - 1, N=1024, Ec=1024,
                   El=16)
    targs = tuple(t(a) for a in args)
    t0 = time.time()
    TPG.optimize_pose_graph(*targs)
    t_first = time.time() - t0
    t0 = time.time()
    tt = TPG.optimize_pose_graph(*targs).numpy()
    t_warm = time.time() - t0
    print(f"port pose graph 1000 KF on the CPU: first {t_first:.2f} s, "
          f"warm {t_warm:.2f} s")
    assert t_warm < 10.0, t_warm
    tj = np.asarray(JPG.optimize_pose_graph(*(jnp.asarray(a) for a in args)))
    for a, b in pairs[:3]:
        e0 = _loop_err(odo, gt, a, b)
        assert _loop_err(tt, gt, a, b) < 0.5 * e0, (a, b)
        assert _loop_err(tj, gt, a, b) < 0.5 * e0, (a, b)
    assert np.isfinite(tt).all() and np.allclose(tt[n:], np.eye(4))


# ----------------------------------------------------------------------
# ICP and the direct alignment
# ----------------------------------------------------------------------
@pytest.mark.parametrize("padded", [False, True])
def test_icp_matches(padded):
    """tests/test_loop.py::TestICP's cloud and motion; padded: the
    handler's 1024-point clouds with masked tails, 5 iterations."""
    cloud = make_structured_cloud(400)[:400]
    T_gt = np.asarray(jlie.se3_exp(jnp.asarray(
        [0.4, -0.2, 0.3, 0.05, 0.08, -0.04], jnp.float32)))
    moved = (T_gt[:3, :3] @ cloud.T).T + T_gt[:3, 3]
    P = cloud.astype(np.float32)
    Q = moved.astype(np.float32)
    vp = vq = np.ones(len(cloud), bool)
    n_iters = 8
    if padded:
        P = np.concatenate([P, np.zeros((624, 3), np.float32)])
        Q = np.concatenate([Q[::-1], np.full((624, 3), 50.0, np.float32)])
        vp = vq = np.arange(1024) < 400
        n_iters = 5
    Tj, okj, ej = JPE.icp(jnp.asarray(P), jnp.asarray(vp), jnp.asarray(Q),
                          jnp.asarray(vq), jnp.eye(4), max_dist=2.0,
                          n_iters=n_iters)
    Tt, okt, et = TPE.icp(t(P), t(vp), t(Q), t(vq), torch.eye(4),
                          max_dist=2.0, n_iters=n_iters)
    close(Tj, Tt, tol=1e-4)
    exact(okj, okt)
    close(ej, et, tol=1e-3)
    assert bool(okt)
    e = tlie.np_se3_log(np.linalg.inv(Tt.numpy()) @ T_gt)
    assert np.linalg.norm(e) < 0.05, e


def _direct_pair(w=256, h=192):
    """A matched keyframe A and a current keyframe B 4 cm / ~0.7 deg
    apart over the textured plane: A's points (<= 2048 on a pixel grid,
    idepth from the render) with per-level intensities sampled from A's
    pyramid, and B's pyramid."""
    calib = jsyn.default_calib(w, h)
    T_a = np.eye(4, dtype=np.float32)
    T_b = np.asarray(jlie.se3_exp(jnp.asarray(
        [0.03, -0.02, 0.015, 0.006, -0.008, 0.004], jnp.float32)))
    img_a, idp_a = jsyn.render_plane(calib, jnp.asarray(T_a), 2.0)
    img_b, _ = jsyn.render_plane(calib, jnp.asarray(T_b), 2.0)
    pyr_a, _ = j_build_pyramid(img_a, calib.levels)
    pyr_b, _ = j_build_pyramid(img_b, calib.levels)
    fx, fy, cx, cy = calib.intrinsics(0)
    vv, uu = np.mgrid[16:h - 16:4, 16:w - 16:4]
    u = uu.reshape(-1).astype(np.float32)[:2048]
    v = vv.reshape(-1).astype(np.float32)[:2048]
    idp = np.asarray(idp_a)[v.astype(int), u.astype(int)]
    pts = np.stack([(u - cx) / fx / idp, (v - cy) / fy / idp, 1.0 / idp],
                   -1).astype(np.float32)
    inten = np.stack([
        _np_bilinear(np.asarray(pyr_a[lvl])[:, :, 0],
                     (u + 0.5) / (1 << lvl) - 0.5,
                     (v + 0.5) / (1 << lvl) - 0.5)
        for lvl in range(calib.levels)], -1).astype(np.float32)
    intr = tuple(calib.intrinsics(lvl) for lvl in range(calib.levels))
    T_cm = np.linalg.inv(T_b) @ T_a
    return pyr_b, pts, inten, intr, calib.levels, T_cm


@pytest.mark.parametrize("perturb", [0.0, 1.0])
def test_estimate_direct_matches(perturb):
    """The JAX package has no test of estimate_direct: the direct
    alignment of a rendered 256x192 pair from the true relative pose and
    from one perturbed by ~2 cm and 1 deg, both packages."""
    pyr_b, pts, inten, intr, n_levels, T_cm = _direct_pair()
    T0 = (T_cm @ jlie.np_se3_exp(
        perturb * np.array([0.02, -0.01, 0.01, 0.01, 0.012, -0.008]))
          ).astype(np.float32)
    valid = np.ones(len(pts), bool)
    Tj, okj, rj = JPE.estimate_direct(
        pyr_b, jnp.asarray(pts), jnp.asarray(inten), jnp.asarray(valid),
        jnp.asarray(T0), intr, n_levels, 12.0)
    Tt, okt, rt = TPE.estimate_direct(
        tuple(t(p) for p in pyr_b), t(pts), t(inten), t(valid), t(T0), intr,
        n_levels, 12.0)
    close(Tj, Tt, tol=1e-4)
    exact(okj, okt)
    close(rj, rt, tol=1e-3)
    assert bool(okt), float(rt)
    e = tlie.np_se3_log(np.linalg.inv(Tt.numpy()) @ T_cm)
    assert np.linalg.norm(e) < 5e-3, e
    # a stricter residual gate than the alignment reaches refuses it
    _, ok_strict, _ = TPE.estimate_direct(
        tuple(t(p) for p in pyr_b), t(pts), t(inten), t(valid), t(T0), intr,
        n_levels, float(rt) * 0.5)
    assert not bool(ok_strict)
