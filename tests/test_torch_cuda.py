"""The port's four CUDA kernels against their plain PyTorch twins, on the
card. Each test skips without a CUDA device (decided inside the test).
They need the port alone (no JAX); on a GPU machine without JAX run them
from the repository root with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from test_torch_helpers import close, exact, gram_close   # tests/ on sys.path

pytestmark = pytest.mark.cuda


def _dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def test_k1_pyramid_level():
    from sos_slam_tpu_torch.ops import image as IMG
    dev = _dev()
    img = torch.rand(120, 160, device=dev) * 255
    for k, p in zip(IMG.pyramid_level(img), IMG.pyramid_level_plain(img)):
        close(k, p)


def _chained_levels(IMG, img, n_levels):
    """n_levels one-level launches chained through `down` (the last level
    may have odd sides, so it is taken without a next one)."""
    levels, absgrads, cur = [], [], img
    for _ in range(n_levels - 1):
        dI, asg, cur = IMG.pyramid_level(cur)
        levels.append(dI)
        absgrads.append(asg)
    (dI,), (asg,) = IMG.pyramid_levels(cur, 1)
    return levels + [dI], absgrads + [asg]


# 640x480 is the main path's frame; 328x248 fills no whole number of tiles
# and its coarse levels' rows start off 16 bytes; 6 levels take two launches
@pytest.mark.parametrize("hw,n_levels", [
    ((480, 640), 4), ((480, 640), 3), ((480, 640), 1), ((248, 328), 4),
    ((248, 328), 3), ((248, 328), 1), ((40, 72), 4), ((512, 640), 6)])
def test_k1_pyramid_levels(hw, n_levels):
    dev = _dev()
    g = torch.Generator(device="cpu").manual_seed(hw[0] + n_levels)
    _k1_against_plain((torch.rand(*hw, generator=g) * 255).to(dev), n_levels)


def _k1_against_plain(img, n_levels):
    """One launch for all levels: against the plain twin, bit for bit
    against one launch per level, and a second launch repeats every bit."""
    from sos_slam_tpu_torch.ops import image as IMG
    before = IMG.pyramid_levels.launches
    lv, ag = IMG.pyramid_levels(img, n_levels)
    assert IMG.pyramid_levels.launches - before == -(-n_levels // 4)
    assert len(lv) == len(ag) == n_levels
    plv, pag = IMG.pyramid_levels_plain(img, n_levels)
    for k, p in zip(lv + ag, plv + pag):
        assert k.shape == p.shape and k.is_contiguous()
        close(k, p)
    clv, cag = _chained_levels(IMG, img, n_levels)
    for k, c in zip(lv + ag, tuple(clv + cag)):
        assert _same_bits(k, c)
    lv2, ag2 = IMG.pyramid_levels(img, n_levels)
    for k, c in zip(lv + ag, lv2 + ag2):
        assert _same_bits(k, c)


def test_k1_rejects_what_the_kernel_does_not_take():
    from sos_slam_tpu_torch.ops import image as IMG
    dev = _dev()
    img = torch.rand(480, 640, device=dev)
    with pytest.raises(ValueError):
        IMG.pyramid_levels(img[:, ::2], 2)
    with pytest.raises(ValueError):
        IMG.pyramid_levels(img[:60, :80].contiguous(), 4)
    with pytest.raises(ValueError):
        IMG.pyramid_levels(img.double(), 2)


def _template_inputs(dims, dev, seed=0, interleaved=True):
    """Sparse idepth/weight maps per level and the colour planes, as
    channel-0 views of interleaved (H,W,3) levels with a NaN among them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    maps, colors = [], []
    for h, w in dims:
        occ = torch.rand(h, w, generator=g) < 0.05
        wm = torch.where(occ, torch.rand(h, w, generator=g) + 0.1,
                         torch.zeros(h, w)).to(dev)
        idm = torch.where(occ, torch.rand(h, w, generator=g) * 2,
                          torch.zeros(h, w)).to(dev)
        level = (torch.rand(h, w, 3, generator=g) * 255)
        level[3:h - 3:5, 3:w - 3:4, 0] = float("nan")
        maps.append((idm, wm))
        colors.append(level.to(dev)[..., 0] if interleaved
                      else level[..., 0].contiguous().to(dev))
    return maps, colors


def test_k2_template_level():
    from sos_slam_tpu_torch.models import window as WIN
    dev = _dev()
    (maps,), (color,) = (x[:1] for x in _template_inputs(
        [(60, 80)], dev, interleaved=False))
    idm, wm = maps
    for diag in (False, True):
        ki, kg = WIN.template_level(idm, wm, color, diag)
        pi, pg = WIN.template_level_plain(idm, wm, color, diag)
        exact(kg, pg)
        close(ki, pi)


# the main path's four levels; a size whose coarse widths are no multiples
# of 4 (41, and 82 whose rows still start on 8 bytes); six levels
@pytest.mark.parametrize("dims", [
    [(480, 640), (240, 320), (120, 160), (60, 80)],
    [(248, 328), (124, 164), (62, 82), (31, 41)],
    [(512, 640), (256, 320), (128, 160), (64, 80), (32, 40), (16, 20)],
    [(9, 7)]])
def test_k2_template_levels(dims):
    """One launch for all levels, the colour read in place at stride 3:
    idn and good exactly the plain twin's, bit for bit one launch per
    level's, and a second launch repeats every bit."""
    from sos_slam_tpu_torch.models import window as WIN
    dev = _dev()
    maps, colors = _template_inputs(dims, dev, seed=len(dims))
    for diags in ([lvl < 2 for lvl in range(len(dims))],
                  [lvl >= 2 for lvl in range(len(dims))]):
        before = WIN.template_levels.launches
        out = WIN.template_levels(maps, colors, diags)
        assert WIN.template_levels.launches - before == 1
        plain = WIN.template_levels_plain(maps, colors, diags)
        again = WIN.template_levels(maps, colors, diags)
        for lvl, ((ki, kg), (pi, pg), (ai, ag)) in enumerate(
                zip(out, plain, again)):
            assert ki.is_contiguous() and kg.is_contiguous()
            assert kg.dtype == torch.bool
            exact(kg, pg)
            exact(ki, pi)
            oi, og = WIN.template_level(*maps[lvl], colors[lvl].contiguous(),
                                        diags[lvl])
            assert _same_bits(ki, oi) and _same_bits(kg, og)
            assert _same_bits(ki, ai) and _same_bits(kg, ag)
        assert int(out[0][1].sum()) > 0 or dims[0][0] < 10


def test_k2_rejects_what_the_kernel_does_not_take():
    from sos_slam_tpu_torch.models import window as WIN
    dev = _dev()
    (maps,), (color,) = _template_inputs([(60, 80)], dev)
    idm, wm = maps
    with pytest.raises(ValueError):
        WIN.template_levels([(idm, wm.double())], [color], [True])
    with pytest.raises(ValueError):
        WIN.template_levels([(idm, wm)], [color.t()], [True])
    with pytest.raises(ValueError):
        WIN.template_levels([(idm, wm)], [color[:, :40]], [True])
    with pytest.raises(ValueError):     # rows further apart than w pixels
        WIN.template_levels([(idm, wm)],
                            [torch.rand(60, 100, device=dev)[:, :80]], [True])


def test_k3_fused_iteration():
    """On the window of a short port run of the fused-KF scene (port only:
    the GPU machine has no JAX)."""
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.ops import ba as B
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    dev = _dev()
    calib = synthetic.default_calib(256, 192)
    s = default_settings(max_points=512, max_immature=1024,
                         max_track_pts=4096, desired_point_density=400.0,
                         desired_immature_density=400.0)
    imgs, _, _ = synthetic.make_sequence(
        calib, 14, (0.05, 0.02, 0.03, 0.003, 0.006, 0.002), device=dev)
    fs = FullSystem(calib, s, device=dev)
    for i in range(14):
        fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
    assert fs.initialized and not fs.is_lost
    ba, dI = fs.ba, fs.dI
    pre = B.make_precalc(ba)
    pm = ba.pt_valid & (torch.arange(ba.P, device=dev) % 3 == 0)
    for kw in (dict(), dict(pmask=pm, use_rz=True, shift_prior_to_zero=False,
                            prior_fac=s.idepth_fix_prior_marg_fac)):
        fk = BP.fused_iteration(ba, pre, dI, s, 256, 192, **kw)
        fp = BP.fused_iteration_plain(ba, pre, dI, s, 256, 192, **kw)
        exact(fk.new_state, fp.new_state)
        exact(fk.sc.has_res, fp.sc.has_res)
        for a, b in ((fk.H_top, fp.H_top), (fk.b_top, fp.b_top),
                     (fk.H_sc, fp.H_sc), (fk.b_sc, fp.b_sc),
                     (fk.sc.vcross, fp.sc.vcross), (fk.energy, fp.energy)):
            close(a, b)
        gram_close(fk.H_top, fp.H_top)
        gram_close(fk.H_sc, fp.H_sc)
        # the kernel's own per-(host, target) cells, before the stitch
        prep = BP.k3_prepare(ba, pre, dI, s, 256, 192, **kw)
        BP.k3_launch(prep)
        cH, cb = BP.fused_cells_plain(ba, pre, dI, s, 256, 192,
                                      pmask=kw.get("pmask"),
                                      use_rz=kw.get("use_rz", False))
        gram_close(prep["out"]["acc"][..., :12, :12], cH)
        close(prep["out"]["acc"][..., :12, 12], cb)


def test_k4_act_pass():
    from sos_slam_tpu_torch.ops import ba_p as BP
    from test_torch_helpers import act_inputs
    dev = _dev()
    ins = [torch.as_tensor(x, device=dev) for x in act_inputs(3)]
    for clamp in (False, True):
        ok_ = BP.act_pass(*ins, clamp=clamp, huber_th=9.0)
        op_ = BP.act_pass_plain(*ins, clamp=clamp, huber_th=9.0)
        exact(ok_[1], op_[1])
        live = (op_[1] < 0.5).cpu().numpy()
        close(ok_[0].cpu().numpy()[live], op_[0].cpu().numpy()[live])
        for a, b in zip(ok_[2:], op_[2:]):
            close(a, b)
        assert np.isfinite(ok_[2].cpu().numpy()).all()


# ---- K3 and K4 at the edges: ragged shapes on numpy-seeded inputs ----

def _window(P, F, dev, seed=3, **override):
    from sos_slam_tpu_torch.ops import ba as B
    from sos_slam_tpu_torch.utils import convert, synthetic
    fields, dI = synthetic.make_window(P, F, seed=seed)
    fields.update(override)
    ba = convert.from_numpy(B.BAState, fields, dev)
    return ba, B.make_precalc(ba), torch.as_tensor(dI, device=dev)


def _k3_against_plain(ba, pre, dI, s=None, **kw):
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.utils.config import default_settings
    s = s or default_settings()
    h, w = dI.shape[1], dI.shape[2]
    fk = BP.fused_iteration(ba, pre, dI, s, w, h, **kw)
    fp = BP.fused_iteration_plain(ba, pre, dI, s, w, h, **kw)
    exact(fk.new_state, fp.new_state)
    exact(fk.active, fp.active)
    exact(fk.sc.has_res, fp.sc.has_res)
    for k in ("H_top", "b_top", "H_sc", "b_sc", "energy", "energy_raw"):
        close(getattr(fk, k), getattr(fp, k))
    for k in ("Hdd", "HdiF", "bd", "vcross"):
        close(getattr(fk.sc, k), getattr(fp.sc, k))
    gram_close(fk.H_top, fp.H_top)
    gram_close(fk.H_sc, fp.H_sc)
    prep = BP.k3_prepare(ba, pre, dI, s, w, h, **kw)
    BP.k3_launch(prep)
    cH, cb = BP.fused_cells_plain(ba, pre, dI, s, w, h,
                                  pmask=kw.get("pmask"),
                                  use_rz=kw.get("use_rz", False))
    gram_close(prep["out"]["acc"][..., :12, :12], cH)
    close(prep["out"]["acc"][..., :12, 12], cb)
    # no atomics: a second launch on the same inputs repeats every bit
    again = BP.fused_iteration(ba, pre, dI, s, w, h, **kw)
    for a, b in zip(fk[:4] + tuple(fk.sc) + fk[5:],
                    again[:4] + tuple(again.sc) + again[5:]):
        assert _same_bits(a, b)
    return fk


_MARG = dict(use_rz=True, shift_prior_to_zero=False, prior_fac=2.5)


def _k3_shapes():
    from sos_slam_tpu_torch.utils import synthetic
    return synthetic.K3_RAGGED_SHAPES


def _k4_shapes():
    from sos_slam_tpu_torch.utils import synthetic
    return synthetic.K4_RAGGED_SHAPES


@pytest.mark.parametrize("marg", [False, True])
@pytest.mark.parametrize("P,F", _k3_shapes())
def test_k3_ragged(P, F, marg):
    dev = _dev()
    ba, pre, dI = _window(P, F, dev)
    kw = {}
    if marg:
        kw = dict(_MARG, pmask=ba.pt_valid
                  & (torch.arange(P, device=dev) % 3 == 0))
    fk = _k3_against_plain(ba, pre, dI, **kw)
    if F > 1:
        assert bool(fk.sc.has_res.any())


def test_k3_empty_pmask():
    dev = _dev()
    ba, pre, dI = _window(512, 5, dev)
    fk = _k3_against_plain(ba, pre, dI, **dict(
        _MARG, pmask=torch.zeros(512, dtype=torch.bool, device=dev)))
    assert not bool(fk.sc.has_res.any())
    assert float(fk.H_sc.abs().max()) == 0.0


def test_k3_all_oob():
    from sos_slam_tpu_torch.ops import ba as B
    dev = _dev()
    ba, pre, dI = _window(100, 3, dev,
                          res_state=np.full((100, 3), B.RES_OOB, np.int8))
    fk = _k3_against_plain(ba, pre, dI)
    assert bool((fk.new_state == B.RES_OOB).all())
    assert not bool(fk.active.any())


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("N,F", _k4_shapes())
def test_k4_ragged(N, F, clamp):
    """NaN taps in dead frames, clamp off and on, and a bitwise repeat."""
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.utils import synthetic
    dev = _dev()
    ins = [torch.as_tensor(x, device=dev)
           for x in synthetic.make_act_inputs(N, F, seed=5)]
    ok_ = BP.act_pass(*ins, clamp=clamp, huber_th=9.0)
    op_ = BP.act_pass_plain(*ins, clamp=clamp, huber_th=9.0)
    exact(ok_[1], op_[1])
    live = (op_[1] < 0.5).cpu().numpy()
    close(ok_[0].cpu().numpy()[live], op_[0].cpu().numpy()[live])
    for a, b in zip(ok_[2:], op_[2:]):
        close(a, b)
        assert np.isfinite(a.cpu().numpy()).all()
    again = BP.act_pass(*ins, clamp=clamp, huber_th=9.0)
    for a, b in zip(ok_, again):
        assert _same_bits(a, b)


# ---- the flagship path (stereo + spline VIO): K3 in the visual-inertial
# BA and its point marginalization, K1 on a right image ----

@pytest.fixture(scope="module")
def flagship_calls():
    """The port on the card over the flagship scene (utils/synthetic's
    sine trajectory, stereo + 200 Hz IMU) at 256x192, until K3 has served
    a VIO GN step and a VIO point marginalization of at least one point:
    those two calls' arguments, the scene's last right image and the
    pyramid depth."""
    import sys
    from sos_slam_tpu_torch.models.full_system import FullSystem, StereoCalib
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    dev = _dev()
    calib = synthetic.default_calib(256, 192)
    s = default_settings(weight_imu_dso=6.0, scale_opt_thres=12.0,
                         min_g_imu=10, max_points=512, max_immature=1024,
                         max_track_pts=4096, desired_point_density=400.0,
                         desired_immature_density=400.0)
    sc = synthetic.stereo_vio_scene(calib, 44, 0.1, synthetic.sine_pose,
                                    synthetic.sine_acc, device=dev)
    calls, orig = {}, BP.fused_iteration

    def recording(*a, **kw):
        who = sys._getframe(2).f_code.co_name
        if who == "gn_step_vio" or (who == "marginalize_points_vio"
                                    and bool(kw["pmask"].any())):
            calls[who] = (a, kw)
        return orig(*a, **kw)

    # the wrapper counts its launches through its module-level name
    recording.launches = orig.launches
    BP.fused_iteration = recording
    try:
        fs = FullSystem(calib, s, stereo=StereoCalib(
            T_lr=sc["T_lr"], calib_right=calib), device=dev)
        for i in range(44):
            fs.add_active_frame(sc["left"][i], timestamp=0.1 * i, frame_id=i,
                                image_right=sc["right"][i],
                                imu_samples=sc["imu"][i])
            if len(calls) == 2:
                break
    finally:
        BP.fused_iteration = orig
    assert fs.imu_initialized and len(calls) == 2, sorted(calls)
    return calls, sc["right"][i], calib.levels


@pytest.mark.parametrize("who", ["gn_step_vio", "marginalize_points_vio"])
def test_k3_on_the_flagship_path(flagship_calls, who):
    a, kw = flagship_calls[0][who]
    ba, pre, dI, s = a[:4]
    fk = _k3_against_plain(ba, pre, dI, s, **kw)
    assert bool(fk.sc.has_res.any())


def test_k1_on_a_right_image(flagship_calls):
    _, right, n_levels = flagship_calls
    _k1_against_plain(right.contiguous(), n_levels)


# ---- loop closure: the pose graph, ICP and the direct alignment on the
# card against the same calls on the CPU, and one SlamNode run ----

def _se3(xi):
    from sos_slam_tpu_torch.utils import lie
    return lie.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy() \
        .astype(np.float64)


def _pose_graph_inputs(n, N, step, drift_xi, loops, fixed_idx):
    """A drifted chain of n vertices (padded to N) with loop edges between
    the true poses, as the 13 numpy inputs of optimize_pose_graph."""
    gt = [np.eye(4)]
    for _ in range(1, n):
        gt.append(gt[-1] @ _se3(step))
    drift = _se3(drift_xi)
    odo = [np.eye(4)]
    for i in range(1, n):
        odo.append(odo[-1] @ np.linalg.inv(gt[i - 1]) @ gt[i] @ drift)
    E = 1 << max(4, (n - 2).bit_length())
    cf, ct = np.zeros(E, np.int32), np.zeros(E, np.int32)
    cm = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    ci = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1))
    cv = np.zeros(E, bool)
    for i in range(n - 1):
        cf[i], ct[i], cv[i] = i, i + 1, True
        cm[i] = np.linalg.inv(gt[i]) @ gt[i + 1] @ drift
    lf, lt = np.zeros(16, np.int32), np.zeros(16, np.int32)
    lm = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    li = np.tile(np.eye(6, dtype=np.float32), (16, 1, 1))
    lv = np.zeros(16, bool)
    for j, (a, b) in enumerate(loops):
        lf[j], lt[j], lv[j] = a, b, True
        lm[j] = np.linalg.inv(gt[a]) @ gt[b]
        li[j] = np.eye(6) * 100.0
    T = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    T[:n] = np.stack(odo)
    v = np.arange(N) < n
    fixed = ~v
    fixed[fixed_idx] = True
    return (T, v, fixed, cf, ct, cm, ci, cv, lf, lt, lm, li, lv)


@pytest.mark.parametrize("case", ["one_fixed", "both_free"])
def test_pose_graph_on_the_card(case):
    """tests/test_loop.py's 16-gon (loop edge from the fixed vertex) and
    20-vertex Woodbury case: the card's optimization against the CPU's at
    the repo's 5e-3 for a run of full GN steps."""
    from sos_slam_tpu_torch.loop import pose_graph as PG
    dev = _dev()
    if case == "one_fixed":
        args = _pose_graph_inputs(16, 16, [1.0, 0, 0, 0, np.pi / 8, 0],
                                  [0.02, 0.01, -0.015, 0.002, 0.004, 0.0],
                                  [(0, 15)], 0)
    else:
        args = _pose_graph_inputs(20, 32, [1.0, 0, 0, 0, np.pi / 9, 0],
                                  [0.03, 0.01, -0.02, 0.003, 0.005, 0.0],
                                  [(1, 18)], 19)
    cpu = PG.optimize_pose_graph(*(torch.as_tensor(a) for a in args),
                                 n_iters=30)
    gpu = PG.optimize_pose_graph(*(torch.as_tensor(a, device=dev)
                                   for a in args), n_iters=30)
    assert gpu.device.type == "cuda"
    close(gpu.cpu(), cpu, tol=5e-3)
    again = PG.optimize_pose_graph(*(torch.as_tensor(a, device=dev)
                                     for a in args), n_iters=30)
    assert _same_bits(gpu, again)


def test_icp_on_the_card():
    from sos_slam_tpu_torch.loop import pose_estimator as PE
    dev = _dev()
    rng = np.random.RandomState(0)
    cloud = np.concatenate([rng.uniform(-20, 20, (300, 3)),
                            rng.randn(100, 3) * 0.5 + [3.0, -4.0, 8.0]])
    T_gt = _se3([0.4, -0.2, 0.3, 0.05, 0.08, -0.04])
    moved = (T_gt[:3, :3] @ cloud.T).T + T_gt[:3, 3]
    P = np.zeros((1024, 3), np.float32)
    Q = np.full((1024, 3), 50.0, np.float32)
    P[:400], Q[:400] = cloud, moved[::-1]
    v = np.arange(1024) < 400
    out = [PE.icp(*(torch.as_tensor(a, device=d) for a in
                    (P, v, Q, v, np.eye(4, dtype=np.float32))))
           for d in ("cpu", dev)]
    close(out[1][0].cpu(), out[0][0], tol=1e-4)
    assert bool(out[1][1]) == bool(out[0][1])
    close(out[1][2].cpu(), out[0][2], tol=1e-3)


def test_estimate_direct_on_the_card():
    """A 256x192 rendered pair 4 cm / 0.7 deg apart, from ~2 cm and 1 deg
    off the true relative pose: the card against the CPU on the same
    pyramid at the tracker's tolerances (tests/test_torch_tracker.py)."""
    from sos_slam_tpu_torch.loop import pose_estimator as PE
    from sos_slam_tpu_torch.models.full_system import _np_bilinear
    from sos_slam_tpu_torch.ops.image import build_pyramid
    from sos_slam_tpu_torch.utils import synthetic
    dev = _dev()
    calib = synthetic.default_calib(256, 192)
    T_b = _se3([0.03, -0.02, 0.015, 0.006, -0.008, 0.004])
    img_a, idp_a = synthetic.render_plane(calib, torch.eye(4), 2.0)
    img_b, _ = synthetic.render_plane(calib, torch.as_tensor(
        T_b, dtype=torch.float32), 2.0)
    pyr_a, _ = build_pyramid(img_a, calib.levels)
    pyr_b, _ = build_pyramid(img_b, calib.levels)
    fx, fy, cx, cy = calib.intrinsics(0)
    vv, uu = np.mgrid[16:176:4, 16:240:4]
    u = uu.reshape(-1).astype(np.float32)[:2048]
    v = vv.reshape(-1).astype(np.float32)[:2048]
    idp = idp_a.numpy()[v.astype(int), u.astype(int)]
    pts = np.stack([(u - cx) / fx / idp, (v - cy) / fy / idp, 1.0 / idp],
                   -1).astype(np.float32)
    inten = np.stack([_np_bilinear(pyr_a[l][:, :, 0].numpy(),
                                   (u + 0.5) / (1 << l) - 0.5,
                                   (v + 0.5) / (1 << l) - 0.5)
                      for l in range(calib.levels)], -1).astype(np.float32)
    T0 = (np.linalg.inv(T_b) @ _se3([0.02, -0.01, 0.01, 0.01, 0.012, -0.008])
          ).astype(np.float32)
    intr = tuple(calib.intrinsics(l) for l in range(calib.levels))
    out = [PE.estimate_direct(tuple(p.to(d) for p in pyr_b),
                              *(torch.as_tensor(a, device=d) for a in
                                (pts, inten, np.ones(len(pts), bool), T0)),
                              intr, calib.levels, 12.0)
           for d in ("cpu", dev)]
    close(out[1][0].cpu(), out[0][0], tol=1e-4)
    assert bool(out[1][1]) and bool(out[0][1])
    close(out[1][2].cpu(), out[0][2], tol=1e-3)


def test_slam_node_with_loop_closure_on_the_card(tmp_path):
    """tests/test_loop_integration.py's stereo scene (256x192, 24 frames,
    loop closure on) through the port's SlamNode on the card: every
    marginalized keyframe reaches the loop handler with a finite
    dso_error and an odometry edge to the one before, a scan is
    assembled, poses.txt is metric, and the asynchronous handler gives
    the synchronous one's poses."""
    from sos_slam_tpu_torch.io.node import SlamNode
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    dev = _dev()
    calib = synthetic.default_calib(256, 192)
    imgs, _, poses = synthetic.make_sequence(
        calib, 24, (0.05, 0.02, 0.03, 0.003, 0.006, 0.002), device=dev)
    T_lr, T_rl = synthetic.stereo_T_lr(0.11)
    right = [synthetic.render_plane(calib, p @ torch.as_tensor(
        T_rl, dtype=torch.float32, device=dev), 2.0)[0] for p in poses]
    cam = str(tmp_path / "camera.txt")
    with open(cam, "w") as f:
        f.write("Pinhole 179.2 179.2 127.5 95.5 0\n256 192\nnone\n256 192\n")
    s = default_settings(scale_opt_thres=12.0, loop_lidar_range=40.0,
                         max_window_frames=8, max_points=512,
                         max_immature=1024, max_track_pts=4096,
                         desired_point_density=400.0,
                         desired_immature_density=400.0)
    trajs = []
    for async_loop in (False, True):
        node = SlamNode(s, cam, calib1=cam, T_stereo=T_lr, device=dev,
                        async_loop=async_loop)
        for i in range(24):
            node.process(imgs[i], i * 0.05, image_right=right[i])
        node.save_poses(str(tmp_path / "poses.txt"))
        trajs.append(np.loadtxt(str(tmp_path / "poses.txt"), ndmin=2))
        fs, loop = node.fs, node.loop
        assert fs.initialized and not fs.is_lost
        n_marg = sum(1 for sh in fs.shells
                     if sh.is_kf and sh.marginalized_at >= 0)
        assert len(loop.frames) == n_marg >= 3
        assert sum(len(f["edges"]) for f in loop.frames) == n_marg - 1
        assert all(np.isfinite(f["dso_error"]) for f in loop.frames)
        assert any(len(f["pts_sc"]) for f in loop.frames)
        assert loop.frames[-1]["pyramid"][0].device.type == "cuda"
    rows = trajs[0]
    assert rows.shape == (n_marg, 4)
    ate, _ = synthetic.metric_ate(rows, poses.cpu().numpy())
    assert ate < 0.15, ate
    np.testing.assert_array_equal(trajs[0], trajs[1])


def test_snapshot_from_the_card(tmp_path):
    """tests/test_torch_snapshot.py's scenario on the card: a snapshot of a
    CUDA system after frame 12 loads into a CUDA system and into a CPU
    system with every array equal (dtypes too) and on the loader's
    device; the CUDA system resumed from it gives the uninterrupted run
    bit for bit."""
    from sos_slam_tpu_torch.models import snapshot as SNAP
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    dev = _dev()
    calib = synthetic.default_calib(256, 192)
    s = default_settings(max_points=512, max_immature=1024,
                         max_track_pts=4096, desired_point_density=400.0,
                         desired_immature_density=400.0)
    imgs, _, _ = synthetic.make_sequence(
        calib, 18, (0.05, 0.02, 0.03, 0.003, 0.006, 0.002), device=dev)
    fs = FullSystem(calib, s, device=dev)
    path = str(tmp_path / "state.npz")
    for i in range(18):
        fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
        if i == 11:
            SNAP.save_snapshot(fs, path)
            saved = [t.to("cpu", copy=True) for t in (
                *fs.ba, *fs.imm, fs.dI, fs.HdiF, *(
                    lv for pyr in fs.frame_pyramids if pyr is not None
                    for lv in pyr), *(x for tp in fs.templates for x in tp))]
    for device in (dev, torch.device("cpu")):
        fl = SNAP.load_snapshot(FullSystem(calib, s, device=device), path)
        got = [*fl.ba, *fl.imm, fl.dI, fl.HdiF] \
            + [lv for pyr in fl.frame_pyramids if pyr is not None
               for lv in pyr] \
            + [x for tp in fl.templates for x in tp]
        assert len(got) == len(saved)
        for a, b in zip(got, saved):
            assert a.device.type == device.type and a.dtype == b.dtype
            exact(a.cpu(), b)
    fl = SNAP.load_snapshot(FullSystem(calib, s, device=dev), path)
    for i in range(12, 18):
        fl.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
    exact(fl.trajectory(), fs.trajectory())
    for a, b in zip(fl.ba, fs.ba):
        exact(a.cpu(), b.cpu())


def test_live_pinv_on_the_card():
    """The VIO fold's pseudo-inverse over the live eigen-directions
    (ops/numerics.py, no host read) on the card against numpy's
    eigendecomposition: a 29x29 float64 block with four eigenvalues at f32
    rounding and one at the cut's order."""
    from sos_slam_tpu_torch.ops.numerics import live_pinv
    dev = _dev()
    r = np.random.RandomState(7)
    Q, _ = np.linalg.qr(r.randn(29, 29))
    w = np.exp(r.uniform(np.log(5e-6), np.log(5.0), 29))
    w[:4] = r.uniform(-4e-7, 4e-7, 4)
    A = (Q * w) @ Q.T
    live = w > 1e-6 * np.abs(w).max()
    ref = (Q[:, live] / w[live]) @ Q[:, live].T
    got = live_pinv(torch.tensor(A, device=dev), 1e-6).cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-8 * np.abs(ref).max()


def test_pipelined_driver_on_the_card():
    """The pipelined fused driver (depth 3, its completions read from
    pinned buffers behind events) bit for bit the synchronous one on the
    card, mono at 256x192."""
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    dev = _dev()
    calib = synthetic.default_calib(256, 192)
    s = default_settings(max_points=512, max_immature=1024,
                         max_track_pts=4096, desired_point_density=400.0,
                         desired_immature_density=400.0)
    imgs, _, _ = synthetic.make_sequence(
        calib, 24, (0.05, 0.02, 0.03, 0.003, 0.006, 0.002), device=dev)
    runs = []
    for depth in (0, 3):
        fs = FullSystem(calib, s, device=dev)
        fs.pipeline, fs.pipeline_depth = depth > 0, depth
        most = 0
        for i in range(24):
            fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
            most = max(most, len(fs._pending_fused))
        fs.finish_pending()
        assert most == depth
        runs.append(fs)
    a, b = runs
    assert a.kf_shell_ids == b.kf_shell_ids
    exact(a.trajectory(), b.trajectory())
    exact(a.ba.state.cpu(), b.ba.state.cpu())
    exact(a.ba.pt_valid.cpu(), b.ba.pt_valid.cpu())


def test_prewarm_on_the_card():
    """FullSystem.prewarm on the card: the kernels launched, every state
    tensor, the key and the rung the same bits after it, the rung set
    recorded. Mono at 256x192, frames in flight when it is called."""
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    dev = _dev()
    calib = synthetic.default_calib(256, 192)
    s = default_settings(max_points=512, max_immature=1024,
                         max_track_pts=4096, desired_point_density=400.0,
                         desired_immature_density=400.0)
    imgs, _, _ = synthetic.make_sequence(
        calib, 12, (0.05, 0.02, 0.03, 0.003, 0.006, 0.002), device=dev)
    fs = FullSystem(calib, s, device=dev)
    for i in range(12):
        fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
    assert len(fs._pending_fused) > 0
    fs.finish_pending()

    def state():
        ts = list(fs.ba) + list(fs.imm) + [fs.dI, fs.HdiF] + [
            t for tp in fs.templates for t in tp]
        return [t.clone() for t in ts], np.array(fs.key), fs._sel_pot

    before = state()
    k1, k3 = IMG.pyramid_levels.launches, BP.fused_iteration.launches
    fs.prewarm()
    assert IMG.pyramid_levels.launches > k1
    assert BP.fused_iteration.launches > k3
    after = state()
    assert all(_same_bits(a, b) for a, b in zip(before[0], after[0]))
    exact(before[1], after[1])
    assert before[2] == after[2]
    assert fs._prewarmed_pots == {1, 2, 3, 4}


def test_device_trace_on_the_card(tmp_path):
    """Telemetry.device_trace on a CUDA run records the card's activity:
    the trace names K1's kernel. 300 launches, since the profiler may drop
    the first device events of a window."""
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.utils.telemetry import Telemetry
    dev = _dev()
    img = torch.rand(480, 640, device=dev) * 255
    IMG.pyramid_levels(img, 4)
    with Telemetry(device=dev).device_trace(str(tmp_path)):
        for _ in range(300):
            IMG.pyramid_levels(img, 4)
    (trace,) = list(tmp_path.iterdir())
    assert "pyramid_kernel" in trace.read_text()


def _same_state(a, b):
    """The fields of two NamedTuple states whose bits differ."""
    return [f for f in a._fields
            if not _same_bits(getattr(a, f).reshape(-1),
                              getattr(b, f).reshape(-1))]


@pytest.fixture(scope="module")
def world_one_steps():
    """NCCL at world size 1 in this process: the sharded BA and VIO steps
    and the sharded trace on the dry run's inputs, with their unsharded
    twins."""
    from sos_slam_tpu_torch.models import energy as E
    from sos_slam_tpu_torch.models import full_system as FSM
    from sos_slam_tpu_torch.parallel import dryrun as DR
    from sos_slam_tpu_torch.parallel import sharded as S
    dev = _dev()
    ba, dI, st, _ = DR.tiny_window(device=dev)
    bav, dIv, stv, imu = DR.tiny_window(n_frames=5, with_imu=True,
                                        device=dev)
    imm = DR.tiny_pool(64, device=dev)
    eye = torch.eye(4, device=dev)
    tr = (ba, imm, dI[0], eye, torch.zeros(2, device=dev),
          torch.tensor(1.0, device=dev), DR.W, DR.H, st)
    mesh = S.make_mesh(1, dev)
    try:
        import torch.distributed as dist
        backend = dist.get_backend()
        out = dict(gn=(S.sharded_gn_step(mesh, ba, dI, st, DR.W, DR.H),
                       E.gn_step(ba, dI, st, DR.W, DR.H)),
                   vio=(S.sharded_vio_gn_step(mesh, bav, imu, dIv, stv,
                                              DR.W, DR.H),
                        E.gn_step_vio(bav, imu, dIv, stv, DR.W, DR.H)),
                   trace=(S.sharded_trace(mesh, *tr), FSM.trace_new(*tr)))
        with pytest.raises(ValueError):
            S.make_mesh(2, dev)
    finally:
        S.close_mesh()
    return backend, out


def test_sharded_steps_at_world_one_on_the_card(world_one_steps):
    """At one NCCL rank the sharded steps and trace are bit for bit the
    unsharded ones; a mesh of more ranks than the group holds raises."""
    backend, out = world_one_steps
    assert backend == "nccl"
    (b1, e1), (b0, _, e0) = out["gn"]
    assert not _same_state(b1, b0) and _same_bits(e1.reshape(-1),
                                                  e0.reshape(-1))
    (bv1, iv1, ev1), (bv0, iv0, _, ev0) = out["vio"]
    assert not _same_state(bv1, bv0) and not _same_state(iv1, iv0)
    assert _same_bits(ev1.reshape(-1), ev0.reshape(-1))
    t1, t0 = out["trace"]
    assert not _same_state(t1, t0)


def test_dryrun_multichip_on_the_card(world_one_steps):
    """Two gloo ranks on the card (every collective staged through host
    memory by gloo): the gathered BA and VIO states within 1e-4 of the
    single-rank steps, res_state exact, every rank the same bits."""
    from sos_slam_tpu_torch.parallel import dryrun as DR
    dev = _dev()
    res = DR.dryrun_multichip(2, dev)
    _, out = world_one_steps
    for job, ref in (("gn", out["gn"][0][0]), ("vio", out["vio"][0][0])):
        got = res[job][0]
        for f in ("state", "c", "idepth"):
            np.testing.assert_allclose(got[f"ba.{f}"],
                                       getattr(ref, f).cpu().numpy(),
                                       atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(got["ba.res_state"],
                                      ref.res_state.cpu().numpy())
        assert all(int(o["k3_launches"]) >= 1 for o in res[job])
    DR.same_on_every_rank(res, ["gn", "vio", "trace", "track"])


def test_nccl_ranks_beyond_the_cards_refused():
    """NCCL places one rank on each card: asking for more raises before a
    process starts, and no mesh moves to the CPU."""
    from sos_slam_tpu_torch.parallel import dryrun as DR
    from sos_slam_tpu_torch.parallel import sharded as S
    dev = _dev()
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="NCCL"):
        DR.spawn_ranks(n, [], dev, backend="nccl")
    with pytest.raises(RuntimeError, match="no process group"):
        S.make_mesh(n, dev)


# ---------------------------------------------------------------------------
# the frame step as CUDA graphs (models/frame_graph.py)
# ---------------------------------------------------------------------------
_MONO_TWIST = (0.05, 0.02, 0.03, 0.003, 0.006, 0.002)


def _mono_run(dev, imgs, cuda_graphs, feed=None):
    """tests/test_torch_pipeline.py's mono scene through a FullSystem on
    the card at the default depth 3; `feed(fs, i)` replaces the plain
    add_active_frame of frame i."""
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    s = default_settings(max_window_frames=8, max_points=512,
                         max_immature=1024, max_track_pts=4096,
                         desired_point_density=400.0,
                         desired_immature_density=400.0)
    fs = FullSystem(synthetic.default_calib(256, 192), s, device=dev,
                    cuda_graphs=cuda_graphs)
    for i in range(len(imgs)):
        if feed is None:
            fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
        else:
            feed(fs, i)
    fs.finish_pending()
    return fs


def _mono_images(dev, n=24, roll_frame=None):
    from sos_slam_tpu_torch.utils import synthetic
    imgs, _, _ = synthetic.make_sequence(synthetic.default_calib(256, 192),
                                         n, _MONO_TWIST, device=dev)
    imgs = [im.clone() for im in imgs]
    if roll_frame is not None:
        # an unmodelled jump: the primary misses, the retry runs and the
        # step refuses the frame
        imgs[roll_frame] = torch.roll(imgs[roll_frame], 40, 1)
    return imgs


def _assert_same_run(a, b):
    assert a.kf_shell_ids == b.kf_shell_ids
    exact(a.trajectory(), b.trajectory())
    for x, y in zip((*a.ba, *a.imm), (*b.ba, *b.imm)):
        assert _same_bits(x, y)


def test_frame_graph_replays_bit_for_bit_on_the_card():
    """The graph form against the eager form (cuda_graphs=False) on the
    card: every keyframe, pose, window tensor and immature-pool tensor
    the same bits, over frames that copy a keyframe's window and
    templates into the graphs' buffers and a frame whose primary misses
    (the retry run, the frame refused)."""
    dev = _dev()
    imgs = _mono_images(dev, roll_frame=14)
    eager = _mono_run(dev, imgs, cuda_graphs=False)
    graph = _mono_run(dev, imgs, cuda_graphs=True)
    assert eager.frame_graph is None
    g = graph.frame_graph
    assert g.graphs is not None and g.retries >= 1
    assert g.copy_ins["templates"] >= 8 and g.copy_ins["ba"] >= 2
    # the private pool's own segments hold the graphs' buffers
    assert 0 < g.pool_bytes <= torch.cuda.memory_reserved(dev)
    _assert_same_run(eager, graph)


def _syncs_per_frame(fs, imgs):
    """The synchronising calls (torch.cuda.set_sync_debug_mode("warn"))
    of each add_active_frame call, by frame id."""
    import warnings
    counts, where = {}, {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i in range(len(imgs)):
            g = fs.frame_graph
            if g is not None and g.graphs is None:
                where[i] = "before the capture"
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
            syncs = [w for w in got if "synchroniz" in str(w.message)]
            counts[i] = len(syncs)
            where.setdefault(i, [f"{w.filename.split('/')[-1]}:{w.lineno}"
                                 for w in syncs])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fs.finish_pending()
    return counts, where


def test_frame_graph_syncs_on_the_card():
    """A steady frame that dispatches no keyframe chain makes at most two
    synchronising calls in the graph form (prim_ok with the tracker's
    overrun, and need_kf); the eager form's count is printed beside it.
    The mono scene at half the test twist, so that most frames are no
    keyframe."""
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    dev = _dev()
    calib = synthetic.default_calib(256, 192)
    imgs, _, _ = synthetic.make_sequence(
        calib, 24, tuple(0.5 * x for x in _MONO_TWIST), device=dev)
    s = default_settings(max_window_frames=8, max_points=512,
                         max_immature=1024, max_track_pts=4096,
                         desired_point_density=400.0,
                         desired_immature_density=400.0)
    counts, where = {}, {}
    for cuda_graphs in (False, True):
        fs = FullSystem(calib, s, device=dev, cuda_graphs=cuda_graphs)
        counts[cuda_graphs], where[cuda_graphs] = _syncs_per_frame(fs, imgs)
        kf = set(fs.kf_shell_ids)
    # steady: the frames after the one that captured the graphs, whose
    # dispatch made no keyframe
    first = max(i for i, w in where[True].items()
                if w == "before the capture") + 1
    steady = [i for i in range(first, 24) if i not in kf]
    assert len(steady) >= 3, kf
    graph = [counts[True][i] for i in steady]
    eager = [counts[False][i] for i in steady]
    print(f"synchronising calls a steady frame without keyframe, frames "
          f"{steady}: graph form {graph}, eager form {eager}; where, frame "
          f"{steady[-1]}: graph form {where[True][steady[-1]]}, eager form "
          f"{where[False][steady[-1]]}")
    assert max(graph) <= 2, graph


def test_frame_graph_capture_error_raises_on_the_card():
    """A host read inside a captured body fails the capture; the error
    reaches the caller and the eager step never runs."""
    from sos_slam_tpu_torch.models import frame_graph as FG
    dev = _dev()
    imgs = _mono_images(dev, n=12)
    real = FG.need_kf

    def reads_host(*a, **kw):
        out = real(*a, **kw)
        bool(out)          # a synchronising read: refused while capturing
        return out

    def eager_step(*a, **kw):
        raise AssertionError("the eager step ran")

    FG.need_kf = reads_host
    try:
        with pytest.raises(RuntimeError):
            def feed(fs, i):
                fs._frame_step = eager_step
                fs.add_active_frame(imgs[i], timestamp=0.05 * i,
                                    frame_id=i)
            _mono_run(dev, imgs, cuda_graphs=True, feed=feed)
    finally:
        FG.need_kf = real
    x = torch.ones(4, device=dev) + 1.0       # the card still works
    torch.cuda.synchronize()
    assert float(x.sum()) == 8.0


def test_frame_graph_capture_beside_the_loop_worker_on_the_card(tmp_path):
    """Graphs captured while the loop handler's worker thread runs on the
    same card: tests/test_loop_integration.py's stereo scene through
    SlamNode with the asynchronous handler, a fresh FrameGraph (a new
    capture) made at frames 10, 14 and 18 while the worker spends a second
    allocating, launching and reading on the card; the poses, the window
    and the loop handler's records the eager form's."""
    from sos_slam_tpu_torch.io.node import SlamNode
    from sos_slam_tpu_torch.models import frame_graph as FG
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    dev = _dev()
    calib = synthetic.default_calib(256, 192)
    imgs, _, poses = synthetic.make_sequence(calib, 24, _MONO_TWIST,
                                             device=dev)
    T_lr, T_rl = synthetic.stereo_T_lr(0.11)
    right = [synthetic.render_plane(calib, p @ torch.as_tensor(
        T_rl, dtype=torch.float32, device=dev), 2.0)[0] for p in poses]
    cam = str(tmp_path / "camera.txt")
    with open(cam, "w") as f:
        f.write("Pinhole 179.2 179.2 127.5 95.5 0\n256 192\nnone\n256 192\n")
    s = default_settings(scale_opt_thres=12.0, loop_lidar_range=40.0,
                         max_window_frames=8, max_points=512,
                         max_immature=1024, max_track_pts=4096,
                         desired_point_density=400.0,
                         desired_immature_density=400.0)
    import threading
    import time
    BUSY = dict(busy=True)
    runs, busy = [], []
    for cuda_graphs in (False, True):
        node = SlamNode(s, cam, calib1=cam, T_stereo=T_lr, device=dev,
                        async_loop=True)
        process = node.loop._process
        started = threading.Event()

        def worker_job(rec, process=process, started=started):
            if rec is not BUSY:
                return process(rec)
            # a second of allocations, launches and reads on the card from
            # the worker thread (no random numbers: a capture owns the
            # generator's offsets)
            started.set()
            a = torch.ones(512, 512, device=dev)
            t_end = time.perf_counter() + 1.0
            while time.perf_counter() < t_end:
                float((a @ a).sum())

        node.loop._process = worker_job
        if not cuda_graphs:
            node.fs.frame_graph = node.fs.chain_graph = None
        for i in range(24):
            if cuda_graphs and i in (10, 14, 18):
                started.clear()
                node.loop.on_keyframe(BUSY)
                started.wait(10.0)
                busy.append(node.loop._queue.unfinished_tasks)
                node.fs.frame_graph = FG.FrameGraph(node.fs)
            node.process(imgs[i], i * 0.05, image_right=right[i])
        node.fs.finish_pending()
        node.loop.join()
        assert node.loop._worker.is_alive()
        runs.append(node)
    print(f"loop records queued or in work at the captures: {busy}")
    assert min(busy) >= 1
    a, b = runs[0].fs, runs[1].fs
    assert b.frame_graph.graphs is not None
    _assert_same_run(a, b)
    assert len(runs[0].loop.frames) == len(runs[1].loop.frames) >= 3


# ---------------------------------------------------------------------------
# the vision keyframe chain as CUDA graphs (models/chain_graph.py)
# ---------------------------------------------------------------------------
def test_chain_graph_replays_bit_for_bit_on_the_card():
    """The keyframe chain's graphs against the eager chain
    (cuda_graphs=False) on the card: every keyframe, pose, window tensor
    and immature-pool tensor the same bits, over chains that marginalize
    frames and a frame the step refuses (its keyframe is classic); the
    bootstrap's budgets and the classic keyframes run eagerly, every
    other chain replays the graphs."""
    dev = _dev()
    imgs = _mono_images(dev, roll_frame=14)
    eager = _mono_run(dev, imgs, cuda_graphs=False)
    graph = _mono_run(dev, imgs, cuda_graphs=True)
    assert eager.chain_graph is None
    g = graph.chain_graph
    assert g.eager["budget"] == 1
    assert set(g.eager) == {"classic", "budget"} and g.eager["classic"] >= 2
    rungs = sum(g.replays.values())
    # the first keyframe is the initializer's, no chain
    assert rungs == len(graph.kf_shell_ids) - 1 - sum(g.eager.values()) >= 5
    assert any(sh.marginalized_at >= 0 for sh in graph.shells)
    assert 0 < g.pool_bytes <= torch.cuda.memory_reserved(dev)
    _assert_same_run(eager, graph)
    assert eager.kf_n_its == graph.kf_n_its
    exact(eager.host_out, graph.host_out)


def test_chain_graph_launch_counters_on_the_card():
    """A replay adds the kernels captured in the chain's graph to their
    launch counters: K1 (the selection's gradient pyramid), K2 (the
    template), K3 (the bounded BA's steps, the final linearization and
    the point marginalization) and K4 (the activation passes); a step
    that captures its rung first counts the warm-up's launches too (they
    run), not the capture's (nothing runs)."""
    from sos_slam_tpu_torch.models import chain_graph as CG
    dev = _dev()
    imgs = _mono_images(dev)
    deltas = []

    def feed(fs, i):
        g = fs.chain_graph
        if "step" not in g.__dict__:
            step = g.step

            def counted(*a, **kw):
                before = [fn.launches for _, fn in CG.COUNTERS]
                runs = 1 if a[-1] in g.graphs else 2
                out = step(*a, **kw)
                deltas.append((a[-1], runs, [fn.launches - b for b, (_, fn)
                                             in zip(before, CG.COUNTERS)]))
                return out
            g.step = counted
        fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)

    fs = _mono_run(dev, imgs, cuda_graphs=True, feed=feed)
    s = fs.settings
    want = dict(K1=1, K2=1, K3=s.max_opt_iterations + 2,
                K4=1 + s.gn_its_on_point_activation)
    g = fs.chain_graph
    assert len(deltas) >= 5
    assert any(runs == 1 for _, runs, _ in deltas)
    for pot, runs, got in deltas:
        assert g.per_replay[pot] == want, g.per_replay
        assert got == [runs * want[c] for c, _ in CG.COUNTERS], got


def test_chain_graph_capture_error_raises_on_the_card():
    """A host read inside the chain's captured body fails the capture;
    the error reaches the caller and no eager chain takes its place."""
    from sos_slam_tpu_torch.models import chain_graph as CG
    dev = _dev()
    imgs = _mono_images(dev, n=16)
    real = CG.flag_frames
    eager_before = []

    def reads_host(*a, **kw):
        out = real(*a, **kw)
        bool(out[1].sum())    # a synchronising read: refused while capturing
        return out

    def feed(fs, i):
        g = fs.chain_graph
        eager_before.append(sum(g.eager.values()))
        fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)

    CG.flag_frames = reads_host
    try:
        with pytest.raises(RuntimeError):
            _mono_run(dev, imgs, cuda_graphs=True, feed=feed)
    finally:
        CG.flag_frames = real
    # the eager chains before it are the bootstrap's two; none after
    assert eager_before[-1] == 2, eager_before
    x = torch.ones(4, device=dev) + 1.0       # the card still works
    torch.cuda.synchronize()
    assert float(x.sum()) == 8.0


def test_chain_graph_syncs_on_the_card():
    """A frame whose dispatch replays the keyframe chain's graphs (no
    retry, no overrun, no dispatch again) makes at most two synchronising
    calls in the graph form: prim_ok with the tracker's overrun, and
    need_kf. The eager form's count of the same frames is printed beside
    it, and each call is named by file and line."""
    dev = _dev()
    imgs = _mono_images(dev)
    counts, where, clean = {}, {}, {}
    for cuda_graphs in (False, True):
        from sos_slam_tpu_torch.models.full_system import FullSystem
        from sos_slam_tpu_torch.utils import synthetic
        from sos_slam_tpu_torch.utils.config import default_settings
        s = default_settings(max_window_frames=8, max_points=512,
                             max_immature=1024, max_track_pts=4096,
                             desired_point_density=400.0,
                             desired_immature_density=400.0)
        fs = FullSystem(synthetic.default_calib(256, 192), s, device=dev,
                        cuda_graphs=cuda_graphs)
        if cuda_graphs:
            g, fg = fs.chain_graph, fs.frame_graph
            marks = []
            real_add = fs.add_active_frame

            def add(*a, **kw):
                before = (sum(g.replays.values()), fg.retries, fg.overruns,
                          len(fs.telemetry.timers["redispatch"]),
                          len(g.capture_ms))
                real_add(*a, **kw)
                after = (sum(g.replays.values()), fg.retries, fg.overruns,
                         len(fs.telemetry.timers["redispatch"]),
                         len(g.capture_ms))
                marks.append(after[0] == before[0] + 1
                             and after[1:] == before[1:])
            fs.add_active_frame = add
        counts[cuda_graphs], where[cuda_graphs] = _syncs_per_frame(fs, imgs)
        if cuda_graphs:
            clean = [i for i, ok in enumerate(marks) if ok]
    assert len(clean) >= 3, clean
    graph = [counts[True][i] for i in clean]
    eager = [counts[False][i] for i in clean]
    print(f"synchronising calls of a frame that replays the keyframe "
          f"chain's graphs, frames {clean}: graph form {graph}, eager form "
          f"{eager}; where, frame {clean[-1]}: graph form "
          f"{where[True][clean[-1]]}, eager form {where[False][clean[-1]]}")
    assert max(graph) <= 2, (graph, [where[True][i] for i in clean])
