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


def test_k1_pyramid_level():
    from sos_slam_tpu_torch.ops import image as IMG
    dev = _dev()
    img = torch.rand(120, 160, device=dev) * 255
    for k, p in zip(IMG.pyramid_level(img), IMG.pyramid_level_plain(img)):
        close(k, p)


def test_k2_template_level():
    from sos_slam_tpu_torch.models import window as WIN
    dev = _dev()
    g = torch.Generator(device="cpu").manual_seed(0)
    occ = torch.rand(60, 80, generator=g) < 0.05
    wm = torch.where(occ, torch.rand(60, 80, generator=g) + 0.1,
                     torch.zeros(60, 80)).to(dev)
    idm = torch.where(occ, torch.rand(60, 80, generator=g) * 2,
                      torch.zeros(60, 80)).to(dev)
    color = (torch.rand(60, 80, generator=g) * 255).to(dev)
    for diag in (False, True):
        ki, kg = WIN.template_level(idm, wm, color, diag)
        pi, pg = WIN.template_level_plain(idm, wm, color, diag)
        exact(kg, pg)
        close(ki, pi)


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
