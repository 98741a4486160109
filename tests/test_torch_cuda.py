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
