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
    return torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                       b.reshape(-1).contiguous().view(torch.uint8))


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
    pyramid depth. The eager form (`cuda_graphs=False`): the recorder
    reads the card, which a chain graph's capture refuses, and a call's
    arguments stay as they were called."""
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
            T_lr=sc["T_lr"], calib_right=calib), device=dev,
            cuda_graphs=False)
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
# the fused frame as CUDA graphs (models/fused_graph.py: the frame step,
# the keyframe decision and the keyframe chain under one IF node)
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
    """The graph form (the fused frame graph: the retry and the tracker's
    loops as conditional nodes inside it) against the eager form
    (cuda_graphs=False) on the card: every keyframe, pose, window tensor
    and immature-pool tensor the same bits, over keyframe frames and a
    rolled frame whose primary misses (the retry run inside the graph,
    the frame refused: its successors dispatched again, the state copied
    in from the host's); the eager step never runs in the graph form."""
    dev = _dev()
    imgs = _mono_images(dev, roll_frame=14)
    eager = _mono_run(dev, imgs, cuda_graphs=False)
    stepped = []

    def feed(fs, i):
        if "_frame_step" not in fs.__dict__:
            step = fs._frame_step
            fs._frame_step = lambda *a: stepped.append(i) or step(*a)
        fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)

    graph = _mono_run(dev, imgs, cuda_graphs=True, feed=feed)
    assert eager.fused_graph is None and not stepped
    g = graph.fused_graph
    assert g.graphs and g.frame.retries >= 1
    assert g.copy_ins >= 2
    # the private pool's own segments hold the graphs' buffers
    assert 0 < g.pool_bytes <= torch.cuda.memory_reserved(dev)
    _assert_same_run(eager, graph)


def _dispatch_syncs(fs, add, frames):
    """The synchronising calls (torch.cuda.set_sync_debug_mode("warn"))
    of each fused frame's own dispatch (`_dispatch_fused`; `add(i)` feeds
    frame i), by frame id, with the calls by file:line; a frame whose
    call captured a graph or dispatched frames again is marked "capture"
    or "again" in place of its calls."""
    import warnings
    counts, where = {}, {}
    dispatch = fs._dispatch_fused
    g = fs.fused_graph
    box = [[]]

    def syncs():
        return [w for w in box[0] if "synchroniz" in str(w.message)]

    def dispatched(img, shell, *a, **kw):
        n0 = len(syncs())
        rec = dispatch(img, shell, *a, **kw)
        if shell.id == box[1] and box[1] not in counts:
            new = syncs()[n0:]
            counts[box[1]] = len(new)
            where[box[1]] = [f"{w.filename.split('/')[-1]}:{w.lineno}"
                             for w in new]
        return rec

    fs._dispatch_fused = dispatched
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i in frames:
            n_cap = len(g.capture_ms) if g is not None else 0
            n_redo = len(fs.telemetry.timers["redispatch"])
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                box[:] = [got, i]
                add(i)
            if g is not None and len(g.capture_ms) > n_cap:
                where[i] = "capture"
            elif len(fs.telemetry.timers["redispatch"]) > n_redo:
                where[i] = "again"
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del fs._dispatch_fused
    fs.finish_pending()
    return counts, where


def _syncs_per_frame(fs, imgs):
    """`_dispatch_syncs` of the mono scene's frames `imgs`."""
    return _dispatch_syncs(fs, lambda i: fs.add_active_frame(
        imgs[i], timestamp=0.05 * i, frame_id=i), range(len(imgs)))


def test_frame_graph_syncs_on_the_card():
    """The dispatch of a steady frame that makes no keyframe makes no
    synchronising call in the graph form (the decision and the
    conditional nodes' run counts ride the frame's readback, fetched at
    its completion); the eager form's count is printed beside it.
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
    # steady: fused frames that captured no graph, went no second time and
    # made no keyframe
    steady = [i for i in counts[True] if i not in kf
              and isinstance(where[True][i], list)]
    assert len(steady) >= 3, (kf, where[True])
    graph = [counts[True][i] for i in steady]
    eager = [counts[False].get(i) for i in steady]
    print(f"synchronising calls of a steady frame's dispatch without "
          f"keyframe, frames {steady}: graph form {graph}, eager form "
          f"{eager}; where, frame {steady[-1]}: eager form "
          f"{where[False].get(steady[-1])}")
    assert max(graph) == 0, [where[True][i] for i in steady]


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
    SlamNode with the asynchronous handler, a fresh FusedFrameGraph (a new
    capture) made at frames 10, 14 and 18 while the worker spends a second
    allocating, launching and reading on the card; the poses, the window
    and the loop handler's records the eager form's."""
    from sos_slam_tpu_torch.io.node import SlamNode
    from sos_slam_tpu_torch.models import fused_graph as FU
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
            node.fs.fused_graph = None
        for i in range(24):
            if cuda_graphs and i in (10, 14, 18):
                started.clear()
                node.loop.on_keyframe(BUSY)
                started.wait(10.0)
                busy.append(node.loop._queue.unfinished_tasks)
                node.fs.fused_graph = FU.FusedFrameGraph(node.fs)
            node.process(imgs[i], i * 0.05, image_right=right[i])
        node.fs.finish_pending()
        node.loop.join()
        assert node.loop._worker.is_alive()
        runs.append(node)
    print(f"loop records queued or in work at the captures: {busy}")
    assert min(busy) >= 1
    a, b = runs[0].fs, runs[1].fs
    assert b.fused_graph.graphs
    _assert_same_run(a, b)
    assert len(runs[0].loop.frames) == len(runs[1].loop.frames) >= 3


# ---------------------------------------------------------------------------
# the keyframe chain inside the fused frame graph (models/chain_graph.py's
# bodies under models/fused_graph.py's IF node)
# ---------------------------------------------------------------------------
def test_chain_graph_replays_bit_for_bit_on_the_card():
    """The keyframe chain inside the fused frame graph against the eager
    chain (cuda_graphs=False) on the card: every keyframe, pose, window
    tensor and immature-pool tensor the same bits, over chains that
    marginalize frames and a frame the step refuses (its keyframe is
    classic); only the classic keyframes run eagerly, every other chain
    (the bootstrap's 20- and 15-step budgets too) runs in a replay."""
    dev = _dev()
    imgs = _mono_images(dev, roll_frame=14)
    eager = _mono_run(dev, imgs, cuda_graphs=False)
    graph = _mono_run(dev, imgs, cuda_graphs=True)
    assert eager.fused_graph is None
    g = graph.fused_graph
    assert set(g.eager) == {"classic"} and g.eager["classic"] >= 2
    rungs = sum(g.chains.values())
    # the first keyframe is the initializer's, no chain
    assert rungs == len(graph.kf_shell_ids) - 1 - sum(g.eager.values()) >= 5
    assert {20, 15} <= set(graph.kf_n_its) or max(graph.kf_n_its) > 6
    assert any(sh.marginalized_at >= 0 for sh in graph.shells)
    assert 0 < g.pool_bytes <= torch.cuda.memory_reserved(dev)
    _assert_same_run(eager, graph)
    assert eager.kf_n_its == graph.kf_n_its
    exact(eager.host_out, graph.host_out)


def _warm_ups(fs):
    """Count the K1-K4 launches of `fs`'s graphs' capture warm-ups (the
    bodies' plain twins run once; the capture after them launches
    nothing) into the returned list."""
    from sos_slam_tpu_torch.ops import control
    n = [0, 0, 0, 0]
    for g in (fs.fused_graph,):
        capture = g.capture

        def counted(*a, capture=capture, **kw):
            before = [fn.launches for _, fn in control.counters()]
            out = capture(*a, **kw)
            for j, ((_, fn), b) in enumerate(zip(control.counters(),
                                                 before)):
                n[j] += fn.launches - b
            return out
        g.capture = counted
    return n


def _launches(run):
    """K1-K4 launches of `run()`, the counters credited with every
    conditional node's runs."""
    from sos_slam_tpu_torch.ops import control
    control.account()
    before = [fn.launches for _, fn in control.counters()]
    out = run()
    control.account()
    return out, [fn.launches - b for (_, fn), b
                 in zip(control.counters(), before)]


def test_chain_graph_launch_counters_on_the_card():
    """K1-K4 launches of the graph form equal the eager form's plus the
    graphs' capture warm-ups' (a warm-up runs the bodies' plain twins:
    every loop to its bound, the chain too); a replay adds the launches
    captured outside its conditional nodes (the frame's pyramid: the
    chain's all lie in its IF node), and the nodes' runs, counted on the
    device and credited from each frame's readback, credit those in their
    bodies (the chain, the BA's GN steps, the frame step's loops)."""
    dev = _dev()
    imgs = _mono_images(dev, roll_frame=14)
    _, eager = _launches(lambda: _mono_run(dev, imgs, cuda_graphs=False))
    warm = []

    def feed(fs, i):
        if not warm:
            warm.append(_warm_ups(fs))
        fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)

    fs, graph = _launches(lambda: _mono_run(dev, imgs, cuda_graphs=True,
                                            feed=feed))
    assert sum(fs.fused_graph.chains.values()) >= 5
    assert graph == [e + w for e, w in zip(eager, warm[0])], (
        graph, eager, warm[0])
    for pot, per in fs.fused_graph.per_replay.items():
        assert per == dict(K1=1, K2=0, K3=0, K4=0), per


def test_chain_graph_capture_error_raises_on_the_card():
    """A host read inside the chain's captured body fails the fused
    frame's capture; the error reaches the caller and no eager chain
    takes its place."""
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
        g = fs.fused_graph
        eager_before.append(sum(g.eager.values()))
        fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)

    CG.flag_frames = reads_host
    try:
        with pytest.raises(RuntimeError):
            _mono_run(dev, imgs, cuda_graphs=True, feed=feed)
    finally:
        CG.flag_frames = real
    # the eager chain before it is the classic keyframe's; none after
    assert eager_before[-1] == 1, eager_before
    x = torch.ones(4, device=dev) + 1.0       # the card still works
    torch.cuda.synchronize()
    assert float(x.sum()) == 8.0


def test_chain_graph_syncs_on_the_card():
    """The dispatch of a frame that makes a keyframe (its chain run in the
    fused graph's IF node; no capture, no dispatch again) makes no
    synchronising call in the graph form: the host learns the decision
    at the frame's completion. The eager form's count of the same frames
    is printed beside it, each call named by file and line."""
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    dev = _dev()
    imgs = _mono_images(dev)
    s = default_settings(max_window_frames=8, max_points=512,
                         max_immature=1024, max_track_pts=4096,
                         desired_point_density=400.0,
                         desired_immature_density=400.0)
    counts, where = {}, {}
    for cuda_graphs in (False, True):
        fs = FullSystem(synthetic.default_calib(256, 192), s, device=dev,
                        cuda_graphs=cuda_graphs)
        counts[cuda_graphs], where[cuda_graphs] = _syncs_per_frame(fs, imgs)
        kf = set(fs.kf_shell_ids)
    clean = [i for i in counts[True] if i in kf
             and isinstance(where[True][i], list)]
    assert len(clean) >= 3, (kf, where[True])
    graph = [counts[True][i] for i in clean]
    eager = [counts[False].get(i) for i in clean]
    print(f"synchronising calls of the dispatch of a frame that makes a "
          f"keyframe, frames {clean}: graph form {graph}, eager form "
          f"{eager}; where, frame {clean[-1]}: eager form "
          f"{where[False].get(clean[-1])}")
    assert max(graph) == 0, [where[True][i] for i in clean]


@pytest.mark.parametrize("pot", [1, 2, 3, 4])
def test_fused_graph_rung_bit_for_bit_on_the_card(pot):
    """The fused frame graph of each selector rung (the rung set by hand
    at the first fused frame, its chains selecting at it until the
    density adaptation moves it) bit for bit the eager form on the card,
    and no dispatch of a graph-form frame synchronises."""
    dev = _dev()
    imgs = _mono_images(dev)
    runs, syncs = {}, {}
    for cuda_graphs in (False, True):
        def feed(fs, i):
            if fs._fused_active() and "rung" not in fs.__dict__:
                fs.rung = fs._sel_pot = pot
            fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)

        fs = _mono_run(dev, imgs[:2], cuda_graphs=cuda_graphs)
        syncs[cuda_graphs] = _dispatch_syncs(
            fs, lambda i, fs=fs: feed(fs, i), range(2, len(imgs)))
        runs[cuda_graphs] = fs
    a, b = runs[False], runs[True]
    _assert_same_run(a, b)
    assert pot in b.fused_graph.graphs and b.fused_graph.chains[pot] >= 1
    counts, where = syncs[True]
    clean = [i for i in counts if isinstance(where[i], list)]
    assert clean and max(counts[i] for i in clean) == 0, where


# ---------------------------------------------------------------------------
# the VIO keyframe chain inside the fused VIO frame graph
# ---------------------------------------------------------------------------
def _vio_run(dev, cuda_graphs, feed=None, n=44):
    """The flagship scene (stereo + spline VIO, utils/synthetic's sine
    trajectory) at 256x192 through a FullSystem on the card at the
    default depth 3; `feed(fs, i)` replaces the plain add_active_frame of
    frame i."""
    from sos_slam_tpu_torch.models.full_system import FullSystem, StereoCalib
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    calib = synthetic.default_calib(256, 192)
    s = default_settings(weight_imu_dso=6.0, scale_opt_thres=12.0,
                         min_g_imu=10, max_points=512, max_immature=1024,
                         max_track_pts=4096, desired_point_density=400.0,
                         desired_immature_density=400.0)
    sc = synthetic.stereo_vio_scene(calib, n, 0.1, synthetic.sine_pose,
                                    synthetic.sine_acc, device=dev)
    fs = FullSystem(calib, s, stereo=StereoCalib(T_lr=sc["T_lr"],
                                                 calib_right=calib),
                    device=dev, cuda_graphs=cuda_graphs)

    def add(i):
        fs.add_active_frame(sc["left"][i], timestamp=0.1 * i, frame_id=i,
                            image_right=sc["right"][i],
                            imu_samples=sc["imu"][i])
    for i in range(n):
        if feed is None:
            add(i)
        else:
            feed(fs, add, i)
    fs.finish_pending()
    return fs


def test_vio_chain_graph_replays_bit_for_bit_on_the_card():
    """The fused VIO frame's graphs (the staged IMU block masked on the
    device, the VIO chain under the need_kf IF node, the visual-inertial
    BA bounded, the stereo scale solve's branch taken on the device)
    against the eager form (cuda_graphs=False) on the card: every
    keyframe, both
    trajectories, and every tensor of the window, the immature pool and
    the IMU state the same bits; K1-K4 launches the eager form's plus the
    capture warm-ups'."""
    dev = _dev()
    eager, n_eager = _launches(lambda: _vio_run(dev, cuda_graphs=False))
    warm = []

    def feed(fs, add, i):
        if not warm:
            warm.append(_warm_ups(fs))
        add(i)

    graph, n_graph = _launches(lambda: _vio_run(dev, cuda_graphs=True,
                                                feed=feed))
    assert n_graph == [e + w for e, w in zip(n_eager, warm[0])], (
        n_graph, n_eager, warm[0])
    g = graph.fused_graph
    assert eager.fused_graph is None and graph.imu_initialized
    assert sum(g.chains.values()) >= 2, g.chains
    assert set(g.eager) <= {"classic"}, g.eager
    assert 0 < g.pool_bytes <= torch.cuda.memory_reserved(dev)
    _assert_same_run(eager, graph)
    exact(eager.trajectory(scaled=True), graph.trajectory(scaled=True))
    for x, y in zip(eager.imu, graph.imu):
        assert _same_bits(x, y)
    assert eager.current_scale == graph.current_scale
    assert eager.kf_n_its == graph.kf_n_its


def _vio_launch_windows():
    """The flagship frames from the fused VIO frame's capture on, each
    under torch.profiler, in this process: [(frame, keyframe chains run
    in the window's replay, {kernel: seen}, {kernel: counted}, {kernel:
    inside conditional nodes}, {kernel: inside, as the profiler shows
    them}), ...] and the graph's launches a replay outside its nodes by
    rung. Each window opens with 1000 throwaway launches, since the
    profiler may drop the first device events of a window."""
    from torch.profiler import ProfilerActivity, profile
    from sos_slam_tpu_torch.models import chain_graph as CG
    from sos_slam_tpu_torch.ops import control
    dev = _dev()
    names = dict(K1="pyramid_kernel", K2="template_kernel",
                 K3="ba_block_kernel", K4="act_pass_kernel")
    seen = []

    def feed(fs, add, i):
        g = fs.fused_graph
        if i < 32 or not g.graphs:
            add(i)
            return
        # the frames in flight complete before the window: the window's
        # keyframe chain is the frame's own
        fs.finish_pending()
        torch.cuda.synchronize()
        control.account()
        before = {c: fn.launches for c, fn in CG.COUNTERS}
        inside = dict(control.CREDITED)
        shown = dict(control.PROFILED)
        replays = sum(g.chains.values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(1000):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            add(i)
            fs.finish_pending()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        assert any("spin_kernel" in e.key for e in ev)
        seen.append((
            i, sum(g.chains.values()) - replays,
            {c: sum(e.count for e in ev if names[c] in e.key)
             for c in names},
            {c: fn.launches - before[c] for c, fn in CG.COUNTERS},
            {c: control.CREDITED[c] - inside.get(c, 0) for c in names},
            {c: control.PROFILED[c] - shown.get(c, 0) for c in names}))

    fs = _vio_run(dev, cuda_graphs=True, feed=feed)
    return seen, {pot: dict(per)
                  for pot, per in fs.fused_graph.per_replay.items()}


def test_vio_chain_graph_launch_counters_on_the_card():
    """Over the flagship frames after the fused VIO frame's capture, under
    torch.profiler: a replay adds the launches captured outside its
    conditional nodes (K1: the frame's pyramid), exactly, and the nodes'
    runs, credited from each frame's readback, credit those in their
    bodies (the whole VIO chain under the need_kf IF node: the
    selection's pyramid, the template, the activation passes, the final
    linearization and the point marginalization, the BA's GN steps in its
    WHILE node, the right image's pyramid under the scale solve's IF
    node). The profiler sees each
    kernel exactly as often as the counters say, those inside the nodes
    as it reports them (control.PROFILED: an IF body's each run, a WHILE
    body's once each time the node is entered). It runs in a process of
    its own: the profiler loses and adds records of kernels inside
    conditional nodes in a process that has made many of them (the card
    tests before it), which a fresh process does not show."""
    import json
    import pathlib
    import subprocess
    import sys
    _dev()
    here = pathlib.Path(__file__).resolve().parent
    code = ("import json, sys; sys.path[:0] = [%r, %r]; "
            "import test_torch_cuda as T; w, per = T._vio_launch_windows(); "
            "print('WINDOWS ' + json.dumps([w, {str(k): v for k, v in "
            "per.items()}]))" % (str(here), str(here.parent)))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=str(here.parent))
    line = [x for x in run.stdout.splitlines() if x.startswith("WINDOWS ")]
    assert run.returncode == 0 and line, run.stderr[-4000:]
    seen, per_replay = json.loads(line[-1][len("WINDOWS "):])
    want = dict(K1=1, K2=0, K3=0, K4=0)
    for pot, per in per_replay.items():
        assert per == want, (pot, per)
    assert any(n for _, n, _, _, _, _ in seen), seen
    for i, _, got, counted, inside, shown in seen:
        rule = {c: counted[c] - inside[c] + shown[c] for c in counted}
        print(f"frame {i}: the profiler saw {got}, counted {counted}, "
              f"inside conditional nodes {inside}, shown by the rule "
              f"{shown}")
        assert got == rule, (i, got, counted, inside, shown)


def test_vio_chain_graph_capture_error_raises_on_the_card():
    """A host read inside the VIO chain's captured body fails the
    capture; the error reaches the caller and no eager chain takes its
    place."""
    from sos_slam_tpu_torch.models import chain_graph as CG
    dev = _dev()
    real = CG.vio_tail
    eager = []

    def reads_host(*a, **kw):
        out = real(*a, **kw)
        bool(out["n_have"] > 0)    # a synchronising read: refused
        return out

    def feed(fs, add, i):
        eager.append(sum(fs.fused_graph.eager.values()))
        add(i)

    CG.vio_tail = reads_host
    try:
        with pytest.raises(RuntimeError):
            _vio_run(dev, cuda_graphs=True, feed=feed)
    finally:
        CG.vio_tail = real
    assert eager and eager[-1] == 0, eager
    x = torch.ones(4, device=dev) + 1.0       # the card still works
    torch.cuda.synchronize()
    assert float(x.sum()) == 8.0


def test_vio_chain_syncs_on_the_card():
    """The dispatch of a flagship frame that makes a VIO keyframe (no
    capture, no dispatch again) makes no synchronising call in the graph
    form. The eager form's count of the same frames is printed beside it,
    each call named by file and line."""
    dev = _dev()
    counts, where, kf = {}, {}, None
    for cuda_graphs in (False, True):
        box = {}

        def feed(fs, add, i, box=box):
            # frames 30-43 go in one call, their dispatches counted
            if i < 30:
                add(i)
            elif i == 30:
                box["got"] = _dispatch_syncs(fs, add, range(30, 44))
        fs = _vio_run(dev, cuda_graphs=cuda_graphs, feed=feed)
        counts[cuda_graphs], where[cuda_graphs] = box["got"]
        kf = set(fs.kf_shell_ids)
    clean = [i for i in counts[True] if i in kf
             and isinstance(where[True][i], list)]
    assert len(clean) >= 2, (kf, where[True])
    graph = [counts[True][i] for i in clean]
    eager = [counts[False].get(i) for i in clean]
    print(f"synchronising calls of the dispatch of a flagship frame that "
          f"makes a VIO keyframe, frames {clean}: graph form {graph}, eager "
          f"form {eager}; where, frame {clean[-1]}: eager form "
          f"{where[False].get(clean[-1])}")
    assert max(graph) == 0, [where[True][i] for i in clean]


# ---------------------------------------------------------------------------
# the device control flow as conditional graph nodes (ops/control.py)
# ---------------------------------------------------------------------------
def _probe():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" \
        / "torch_graph_probe.py"
    spec = importlib.util.spec_from_file_location("torch_graph_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_control_cases_on_the_card():
    """Every case of scripts/torch_graph_probe.py's conditional nodes (an
    IF taken and skipped, an IF with an else, nested IFs, five bodies
    deep as the fused frame's deepest path, a WHILE of no
    trip, of three and to its cap, the counters' credit and the setter
    launches) replays bit for bit its eager form and its plain twin; a
    skipped IF node and a WHILE trip cost some microseconds of device
    time."""
    dev = _dev()
    probe = _probe()
    cases = probe.control_cases(dev)
    assert len(cases) == 8
    assert all(ok for _, ok, _ in cases), cases
    us = probe.node_costs(dev, n=100, trips=200)
    print(f"device us: {us}")
    assert all(0 < v < 1000 for v in us.values()), us


def _chain_calls(dev, vio):
    """The keyframe chains' arguments of an eager run (cuda_graphs=False)
    of the mono scene, or with `vio` of the flagship scene, and its
    FullSystem."""
    calls = []

    def wrap(fs):
        if "_run_chain" not in fs.__dict__:
            run = fs._run_chain

            def recorded(*a, **kw):
                calls.append(a)
                return run(*a, **kw)
            fs._run_chain = recorded

    if vio:
        def feed(fs, add, i):
            wrap(fs)
            add(i)
        fs = _vio_run(dev, cuda_graphs=False, feed=feed)
    else:
        imgs = _mono_images(dev)

        def feed(fs, i):
            wrap(fs)
            fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
        fs = _mono_run(dev, imgs, cuda_graphs=False, feed=feed)
    del fs._run_chain
    budget = fs.settings.max_opt_iterations
    return fs, [a for a in calls if a[10] == budget]


def _chain_both(fs, a, kf):
    """One chain on the arguments `a` of `_run_chain` with the inputs `kf`:
    replayed as a fresh ChainGraph's graph, and eagerly. Returns both
    outputs."""
    from sos_slam_tpu_torch.models import chain_graph as CG
    from sos_slam_tpu_torch.utils import rng
    st, imm, pyr, T, aff, exp, stats, host_out, n_kf, sid, max_its, pot = \
        a[:12]
    key = rng.fold_in(st["key"], sid)
    g = CG.ChainGraph(fs)
    got = g.step(st, imm, pyr, T, aff, exp, stats, host_out, n_kf, key, pot,
                 kf=kf)
    body = CG.kf_chain_vio_body if fs.settings.enable_imu \
        else CG.kf_chain_body
    keys = torch.as_tensor(CG.selection_keys(key), device=fs.device)
    ref = body(fs, st, imm, pyr, T, aff, exp, stats, host_out, n_kf, keys,
               pot, max_its, False, kf)
    assert sum(g.replays.values()) == 1
    return got, ref


def _assert_same_chain(got, ref, vio=False):
    for k in ("ba", "imm", "dI") + (("imu",) if vio else ()):
        x, y = got["state"][k], ref["state"][k]
        for a_, b_ in (zip(x, y) if isinstance(x, tuple) else ((x, y),)):
            assert _same_bits(a_, b_), k
    for k in ("marg_ks", "host_out", "n_have", "slot", "T_cw_all_t"):
        assert _same_bits(got[k], ref[k]), k
    for a_, b_ in zip(got["scale_out"], ref["scale_out"]):
        assert _same_bits(a_, b_)
    assert int(got["ba_stats"]["n_its"]) == int(ref["ba_stats"]["n_its"])


@pytest.fixture(scope="module")
def mono_chain_calls():
    return _chain_calls(_dev(), vio=False)


@pytest.mark.parametrize("n_flagged", [0, 1, 4])
def test_chain_flagged_slots_on_the_card(mono_chain_calls, n_flagged):
    """The vision chain's graph with 0, 1 and 4 flagged frame slots (the
    flags forced: each slot's fold a conditional node that a padded slot
    skips) bit for bit the eager chain on the same inputs."""
    from sos_slam_tpu_torch.models import chain_graph as CG
    fs, calls = mono_chain_calls
    a = max(calls, key=lambda c: int(c[0]["ba"].frame_valid.sum()))
    n = int(a[0]["ba"].frame_valid.sum())
    assert n >= 5, n
    ks = [n - 2, n - 3, n - 4, 1][:n_flagged]
    F = a[0]["ba"].F
    flags = torch.zeros(F, dtype=torch.bool, device=fs.device)
    flags[ks] = True
    marg_ks = torch.tensor(ks + [-1] * (CG.MAX_MARG_FRAMES - n_flagged),
                           device=fs.device)
    real = CG.flag_frames
    CG.flag_frames = lambda *args, **kw: (flags, marg_ks)
    try:
        got, ref = _chain_both(fs, a, a[12])
    finally:
        CG.flag_frames = real
    _assert_same_chain(got, ref)
    assert int((got["marg_ks"] >= 0).sum()) == n_flagged


def test_vio_chain_untrapped_on_the_card():
    """A flagship VIO chain handed an untrapped scale state: its graph
    solves the scale from the multi-guess start (the other branch of the
    scale solve's conditional node) bit for bit the eager chain, and the
    same chain trapped too."""
    dev = _dev()
    fs, calls = _chain_calls(dev, vio=True)
    a = calls[-1]
    kf = a[12]
    s_, t_, f_ = kf["scale_state"]
    assert bool(t_)
    for trapped in (False, True):
        k = dict(kf, scale_state=(s_, torch.full_like(t_, trapped), f_))
        got, ref = _chain_both(fs, a, k)
        _assert_same_chain(got, ref, vio=True)


@pytest.mark.parametrize("n", [8, 29, 68, 237])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_inside_a_conditional_body_on_the_card(n, dtype):
    """numerics.solve of one system captures inside an IF node's body
    (torch.linalg.solve_ex's cuSOLVER route allocates stream-ordered
    memory there at 29 <= n <= 128, which a body may not hold), replays
    to its uncaptured bits and agrees with torch.linalg.solve; a singular
    system gives NaN."""
    from sos_slam_tpu_torch.ops import control
    from sos_slam_tpu_torch.ops import numerics as NUM
    dev = _dev()
    g_ = torch.Generator(device="cpu").manual_seed(n)
    A = torch.randn(n, n, generator=g_, dtype=dtype)
    A = (A @ A.T + n * torch.eye(n, dtype=dtype)).to(dev)
    b = torch.randn(n, generator=g_, dtype=dtype).to(dev)
    ref = NUM.solve(A, b)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    close(ref, torch.linalg.solve(A, b), tol=tol)
    out = torch.zeros(n, dtype=dtype, device=dev)
    go = torch.ones((), dtype=torch.bool, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        NUM.solve(A, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with control.capture(graph, torch.cuda.graph_pool_handle(), side):
        control.cond(go, lambda: NUM.solve(A, b), None, out=out)
    graph.replay()
    torch.cuda.synchronize()
    assert _same_bits(out, ref)
    assert torch.isnan(NUM.solve(torch.zeros_like(A), b)).all()


def _timer_step(buf):
    """The smallest step between back-to-back device stamps into `buf`
    (launched from one replayed graph, so they follow each other closely),
    and the share of steps that read 0 (a clock coarser than the
    launches)."""
    from sos_slam_tpu_torch.ops import control
    n = buf.numel()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with control.capture(graph, torch.cuda.graph_pool_handle(), side):
        for i in range(n):
            control.stamp(buf, i)
    graph.replay()
    torch.cuda.synchronize()
    d = torch.diff(buf.cpu())
    assert (d >= 0).all()
    return int(d[d > 0].min()), float((d == 0).double().mean())


def test_stamps_inside_a_conditional_body_on_the_card():
    """A stamp is a kernel node: captured in the main graph and at the end
    of an IF body (`cond`'s `then`), the body passes `_check_body` (the
    capture would raise), a replay writes the device clock in stream
    order and leaves the slot of a skipped body as the memset left it.
    Stamps move no K1-K4 launch counter, `control.PROFILED` or the setter
    kernels' count. The smallest step of %globaltimer is printed."""
    from sos_slam_tpu_torch.ops import control
    dev = _dev()
    buf = torch.zeros(4, dtype=torch.int64, device=dev)
    go = torch.ones((), dtype=torch.bool, device=dev)
    out = torch.zeros(8, device=dev)
    x = torch.arange(8.0, device=dev)

    def body():
        control.stamp(buf, 0)
        buf[1:3].zero_()
        control.cond(go, lambda: x * 2.0, None, out=out,
                     then=lambda: control.stamp(buf, 1))
        control.stamp(buf, 2)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with control.capture(graph, torch.cuda.graph_pool_handle(), side):
        body()
    control.account(dev)
    launches = [fn.launches for _, fn in control.counters()]
    profiled = dict(control.PROFILED)
    setters = control.setter_launches(dev)
    graph.replay()
    torch.cuda.synchronize()
    a = buf.cpu().tolist()
    assert 0 < a[0] <= a[1] <= a[2], a
    assert _same_bits(out, x * 2.0)
    go.fill_(False)
    graph.replay()
    torch.cuda.synchronize()
    b = buf.cpu().tolist()
    assert b[1] == 0 and a[2] <= b[0] <= b[2], b
    control.account(dev)
    assert [fn.launches for _, fn in control.counters()] == launches
    assert dict(control.PROFILED) == profiled
    assert control.setter_launches(dev) == setters + 2     # one IF a replay
    step, zeros = _timer_step(torch.zeros(512, dtype=torch.int64,
                                          device=dev))
    print(f"%globaltimer on {torch.cuda.get_device_name(dev)}: smallest "
          f"step {step} ns between back-to-back stamps, {100 * zeros:.1f}% "
          "of the steps 0")


def test_fused_frame_stamps_on_the_card():
    """The mono scene in the graph form with the node's intake stamps: a
    steady frame's dispatch and its intake make no synchronising call;
    each fused frame's device stamps, mapped onto the host's clock, lie
    ordered between its dispatch (the `frame` span's start; the intake's
    for the intake) and its completion (the `complete` span's end), within
    the calibration's uncertainty and the clock's step; the stage series
    are printed."""
    import collections
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
    fs = FullSystem(calib, s, device=dev, cuda_graphs=True)

    def add(i):
        with fs.intake(i):
            img = imgs[i] * 1.0
        fs.add_active_frame(img, timestamp=0.05 * i, frame_id=i)

    counts, where = _dispatch_syncs(fs, add, range(len(imgs)))
    steady = [i for i in counts if i not in set(fs.kf_shell_ids)
              and isinstance(where[i], list)]
    assert len(steady) >= 3 and max(counts[i] for i in steady) == 0, where
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            with fs.intake(99):
                imgs[0] * 1.0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not [w for w in got if "synchroniz" in str(w.message)]
    tel = fs.telemetry
    clock = tel.report()["clock"]
    step, _ = _timer_step(torch.zeros(256, dtype=torch.int64, device=dev))
    slack = clock["uncertainty_ns"] + abs(clock["drift_ns"]) + step
    host, devs, n = {}, collections.defaultdict(dict), collections.Counter()
    for name, f, t0, t1 in tel.records:
        if name.startswith("dev."):
            devs[f][name] = (t0, t1)
            n[f, name] += 1
        elif name in ("frame", "complete", "node.intake"):
            host.setdefault(f, {})[name] = (t0, t1)
    checked = 0
    for f, r in devs.items():
        if "dev.track" not in r or n[f, "dev.frame"] != 1:
            continue
        h = host[f]
        order = [*r["dev.intake"], r["dev.track"][0], r["dev.track"][1],
                 r["dev.trace"][1]] + ([r["dev.chain"][1]]
                                       if "dev.chain" in r else []) \
            + [r["dev.frame"][1]]
        assert order == sorted(order), (f, order)
        assert h["node.intake"][0] - slack <= r["dev.intake"][0], f
        assert h["frame"][0] - slack <= r["dev.frame"][0], f
        assert r["dev.frame"][1] <= h["complete"][1] + slack, f
        checked += 1
    assert checked >= 10
    rep = tel.report()
    print(f"stamps on {torch.cuda.get_device_name(dev)}: {checked} frames "
          f"checked, slack {slack:.0f} ns (clock {clock}); device ms by "
          "series: " + ", ".join(
              f"{k} n={v['n']} mean {v['mean']:.3f}"
              for k, v in sorted(rep["timers_ms"].items())
              if k.startswith("dev."))
          + f"; idle by host span (ms): {rep['idle_by_host']}")
