"""K2 and the window bookkeeping of the port against the JAX package.

K2's plain twin against the TPU kernel in interpret mode
(pallas_kernels.template_level) on every in-border pixel (the only pixels
the template extraction can pick), one level and all levels of a keyframe
in one call; build_track_template against the JAX form (identical
extracted templates); the slot bookkeeping exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_slam_tpu.models import window as JW
from sos_slam_tpu.ops import pallas_kernels as PK
from sos_slam_tpu_torch.models import window as TW
from sos_slam_tpu_torch.ops import ba as TB
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_ba import W, H, build_window
from tests.test_torch_helpers import close, exact, port_state, t


def _maps(seed, h, w, frac=0.05):
    r = np.random.RandomState(seed)
    occ = r.rand(h, w) < frac
    wm = np.where(occ, r.rand(h, w) + 0.1, 0.0).astype(np.float32)
    idm = np.where(occ, r.rand(h, w) * 2.0, 0.0).astype(np.float32)
    color = (r.rand(h, w) * 255.0).astype(np.float32)
    color[3, 5] = np.nan
    return idm, wm, color


@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("hw", [(60, 80), (30, 40)])
def test_k2_plain_matches_pallas_interpret(diag, hw):
    h, w = hw
    idm, wm, color = _maps(h + int(diag), h, w)
    idn_j, good_j = PK.template_level(jnp.asarray(idm), jnp.asarray(wm),
                                      jnp.asarray(color), diag=diag,
                                      interpret=True)
    idn_t, good_t = TW.template_level(t(idm), t(wm), t(color), diag)
    exact(good_j, good_t)
    inb = np.zeros((h, w), bool)
    inb[2:h - 2, 2:w - 2] = True
    close(np.asarray(idn_j)[inb], idn_t.numpy()[inb])


def test_template_levels_matches_pallas_interpret():
    """All levels of a keyframe in one call, the colour read in place from
    interleaved [I, dx, dy] levels (a NaN among it), against one TPU-kernel
    call per level (interpret mode)."""
    dims = [(96, 128), (48, 64), (24, 32), (12, 16)]
    diags = [lvl < 2 for lvl in range(4)]
    maps, colors, ref = [], [], []
    for lvl, (h, w) in enumerate(dims):
        idm, wm, color = _maps(20 + lvl, h, w, frac=0.08)
        level = np.random.RandomState(lvl).rand(h, w, 3).astype(np.float32)
        level[..., 0] = color
        maps.append((t(idm), t(wm)))
        colors.append(t(level)[..., 0])
        assert not colors[-1].is_contiguous()
        ref.append(PK.template_level(jnp.asarray(idm), jnp.asarray(wm),
                                     jnp.asarray(color), diag=diags[lvl],
                                     interpret=True))
    out = TW.template_levels(maps, colors, diags)
    assert len(out) == 4
    for (h, w), (idn_j, good_j), (idn_t, good_t) in zip(dims, ref, out):
        assert idn_t.shape == (h, w) and good_t.dtype == torch.bool
        exact(good_j, good_t)
        assert not bool(good_t[3, 5]) and int(good_t.sum()) > 0
        close(np.asarray(idn_j)[2:h - 2, 2:w - 2],
              idn_t.numpy()[2:h - 2, 2:w - 2])
    # one level through the whole-call entry is the one-level entry
    one = TW.template_level(*maps[2], colors[2], diags[2])
    exact(one[0], out[2][0])
    exact(one[1], out[2][1])


def test_template_levels_rejects_mismatched_levels():
    idm, wm, color = (t(x) for x in _maps(1, 12, 16))
    with pytest.raises(ValueError):
        TW.template_levels([(idm, wm)], [color], [True, False])
    with pytest.raises(ValueError):
        TW.template_levels([], [], [])
    with pytest.raises(ValueError):
        TW.template_levels([(idm, wm)] * 7, [color] * 7, [True] * 7)


@pytest.fixture(scope="module")
def win():
    ba, dI, _, _ = build_window(n_frames=3, n_points=100, pose_noise=0.01,
                                seed=1)
    return ba, dI


def test_build_track_template_matches(win):
    ba, dI = win
    from sos_slam_tpu.ops import image as JI
    from sos_slam_tpu_torch.ops import image as TI
    img = np.asarray(dI[2][..., 0])
    pyr_j, _ = JI.build_pyramid(jnp.asarray(img), 3)
    pyr_t, _ = TI.build_pyramid(t(img), 3)
    ba = ba._replace(res_exist=ba.res_exist | ba.pt_valid[:, None]
                     & (jnp.arange(ba.F)[None, :] == 2))
    HdiF = np.random.RandomState(0).rand(ba.P).astype(np.float32) * 0.01
    sizes = (2048, 512, 256)
    tj, pcj = JW.build_track_template(ba, jnp.asarray(HdiF), pyr_j, 3,
                                      sizes, W, H)
    tt, pct = TW.build_track_template(port_state(TB.BAState, ba), t(HdiF),
                                      pyr_t, 3, sizes, W, H)
    for a, b in zip(tj, tt):
        exact(a.valid, b.valid)
        assert int(np.sum(np.asarray(a.valid))) > 10
        v = np.asarray(a.valid)
        exact(np.asarray(a.u)[v], b.u.numpy()[v])
        exact(np.asarray(a.v)[v], b.v.numpy()[v])
        close(np.asarray(a.idepth)[v], b.idepth.numpy()[v])
        close(np.asarray(a.color)[v], b.color.numpy()[v])


def test_insert_frame_and_points(win):
    ba, _ = win
    s = default_settings()
    T_new = np.eye(4, dtype=np.float32)
    T_new[:3, 3] = [0.1, 0.0, 0.02]
    aff = np.array([0.05, 2.0], np.float32)
    prior = np.arange(8, dtype=np.float32)
    bj = JW.insert_frame(ba, jnp.asarray(T_new), jnp.asarray(aff),
                         jnp.float32(1.3), jnp.asarray(prior))
    bt = TW.insert_frame(port_state(TB.BAState, ba), t(T_new), t(aff),
                         t(np.float32(1.3)), t(prior))
    for k in ("frame_valid", "res_exist", "res_state"):
        exact(getattr(bj, k), getattr(bt, k))
    for k in ("T_cw_eval", "state", "state_zero", "exposure", "energy_th",
              "prior"):
        close(getattr(bj, k), getattr(bt, k))

    r = np.random.RandomState(2)
    M = 40
    valid = np.asarray(bj.pt_valid).copy()
    valid[::7] = False
    ok = r.rand(M) < 0.6
    host = r.randint(0, 3, M).astype(np.int32)
    u, v = (r.rand(M) * 100).astype(np.float32), (r.rand(M) * 80).astype(
        np.float32)
    col = r.rand(M, 8).astype(np.float32)
    idp = r.rand(M).astype(np.float32)
    sj, aj = JW.scatter_into_free_slots(jnp.asarray(valid), jnp.asarray(ok))
    st, at = TW.scatter_into_free_slots(t(valid), t(ok))
    exact(aj, at)
    exact(np.asarray(sj)[np.asarray(aj)], st.numpy()[at.numpy()])
    bj2 = JW.insert_points(bj._replace(pt_valid=jnp.asarray(valid)), sj, aj,
                           jnp.asarray(host), jnp.asarray(u), jnp.asarray(v),
                           jnp.asarray(col), jnp.asarray(col),
                           jnp.asarray(idp), jnp.full(M, s.idepth_fix_prior))
    bt2 = TW.insert_points(bt._replace(pt_valid=t(valid)), st, at, t(host),
                           t(u), t(v), t(col), t(col), t(idp),
                           t(np.full(M, s.idepth_fix_prior, np.float32)))
    for k in ("pt_valid", "host", "res_exist", "res_state"):
        exact(getattr(bj2, k), getattr(bt2, k))
    for k in ("u", "v", "color", "weight", "idepth", "idepth_zero",
              "pt_prior"):
        close(getattr(bj2, k), getattr(bt2, k))
