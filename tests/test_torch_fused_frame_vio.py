"""The VIO fused frame as one device program (models/fused_graph.py with
IMU: the staged block's validity and compaction, the gyro-integrated
hypothesis, the step, the decision, the VIO keyframe chain with the stereo
scale solve under `control.cond(need_kf)`, the next frame's inputs) on the
CPU, against the JAX package's `_fused_frame_vio_jit`.

The stereo + VIO scene of tests/test_torch_chain_graph_vio.py (256x192,
20 frames, F = 8, P = 512) runs through the FusedFrameGraph's body,
pipelined at depth 3, recording each dispatch (the scene's eager-path
comparison is tests/test_torch_chain_graph_vio.py's). Tolerances as in
tests/test_torch_fused_frame.py; the comparison leaves out the fields
the port's repaired VIO frame fold writes (the IMU prior HM and bM,
tests/test_torch_chain_graph_vio.py)."""

import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.models import fused_graph as FU
from sos_slam_tpu_torch.models import imu as IM
from sos_slam_tpu_torch.models.full_system import FrameShell, FullSystem
from sos_slam_tpu_torch.utils import synthetic
from tests.test_torch_chain_graph_vio import (FRAME_DT, N_FRAMES, _scene,
                                              _settings, _system)
from tests.test_torch_fused_frame import (_common_args, _held_to_jax, _j,
                                          check_stamps)
from tests.test_torch_helpers import GN_TOL, close, exact

torch.set_num_threads(2)

W, H = 256, 192


@pytest.fixture(scope="module")
def run():
    calib, T_lr, left, right, imu = _scene()
    fs = _system(calib, T_lr)
    fs.pipeline, fs.pipeline_depth = True, 3
    fs.fused_graph = g = FU.FusedFrameGraph(fs)
    calls = []
    dispatch, by_graph = g.dispatch, fs._dispatch_graph

    def recorded(*a):
        calls.append(dict(args=a))
        return dispatch(*a)

    def dispatched(img, shell, *a, **kw):
        rec = by_graph(img, shell, *a, **kw)
        calls[-1].update(shell=shell, rec=rec)
        return rec
    g.dispatch, fs._dispatch_graph = recorded, dispatched
    for i in range(N_FRAMES):
        with fs.intake(i):      # as SlamNode.process: stamps around it
            img, img_r = left[i], right[i]
        fs.add_active_frame(img, timestamp=i * FRAME_DT, frame_id=i,
                            image_right=img_r, imu_samples=imu[i])
        assert not (fs.is_lost or fs.init_failed)
    fs.finish_pending()
    del g.dispatch, fs._dispatch_graph
    return fs, calls


def test_fused_body_matches_jax_vio(run):
    """The last VIO keyframe frame against `_fused_frame_vio_jit` given
    the same staged block (every sample up to the frame) and the last
    keyframe's time, which the JAX program masks the block by."""
    import jax.numpy as jnp
    from sos_slam_tpu.models import full_system as JFS
    from sos_slam_tpu.models import imu as JIM
    from sos_slam_tpu.utils import config as JC
    fs, calls = run
    c = next(c for c in reversed(calls) if c["shell"].is_kf)
    (st, inp, _, _, _, _, _, right, _, block, _, _) = c["args"]
    N = IM.N_IMU
    last_kf = int(inp["last_kf"])
    t_last = fs.shells[last_kf].timestamp if last_kf >= 0 else -1e9
    args = _common_args(fs, c)
    R01, t01, intr1 = fs._lr
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[:3, :3], T_lr[:3, 3] = R01.numpy(), t01.numpy()
    imu_j = JIM.ImuState(**{k: jnp.asarray(v.numpy())
                            for k, v in st["imu"]._asdict().items()})
    jout = JFS._fused_frame_vio_jit(
        **args, imu=imu_j, acc_s=_j(block[:3 * N].reshape(N, 3)),
        gyro_s=_j(block[3 * N:6 * N].reshape(N, 3)),
        ts_s=_j(block[6 * N:7 * N]), valid_s=_j(block[7 * N:8 * N] > 0.5),
        timestamp=_j(block[9 * N + 1]), ts_thresh=_j(block[9 * N]),
        t_last_kf_in=jnp.float32(t_last), img_right=_j(right),
        have_right=jnp.asarray(True), T_lr=jnp.asarray(T_lr),
        settings=_settings(JC),
        stereo=(tuple(fs._intr), tuple(intr1)))
    got = _held_to_jax(fs, c, jout, vio=True)
    imu5 = jout[2][1]
    back = jout[4][4]
    imu_p = c["rec"]["state"]["imu"]
    for k in ("bias_valid", "spline_valid", "imu_valid", "scale_trapped",
              "queue_i"):
        exact(np.asarray(getattr(imu5, k)), getattr(imu_p, k))
    # the samples the chain took in: the block masked and compacted alike
    # (the JAX program leaves the masked samples' values behind the valid
    # ones, the port zeroes them as the host's staging does: the valid
    # entries are compared)
    ok = np.asarray(imu5.imu_valid)
    for k in ("acc", "gyro", "ts"):
        close(np.asarray(getattr(imu5, k))[ok], getattr(imu_p, k).numpy()[ok])
    close(np.asarray(imu5.timestamps), imu_p.timestamps)
    close(np.asarray(imu5.scale), imu_p.scale, GN_TOL)
    close(np.asarray(back[12]), got["bg"], GN_TOL)
    close(np.asarray(back[11][3]), got["scale_err"], GN_TOL)


def test_imu_block_leaves_out_the_keyframe_in_flight():
    """The fused graph's staged block, masked on the device by the chained
    last keyframe's shell index, is `_stage_imu`'s block from the
    float64 test `q[0] > t_kf` bit for bit, also for the sample at the
    keyframe's own time (t_kf = 2.6, t = 2.9: an f32 mask keeps it, the
    flagship scene at 640x480), and with no keyframe in flight the whole
    block up to the frame."""
    fs = FullSystem(synthetic.default_calib(W, H),
                    _settings(stereo=False), device="cpu")
    r = np.random.RandomState(0)
    queue = [(k / 200.0, r.randn(3).astype(np.float32),
              r.randn(3).astype(np.float32)) for k in range(460, 601)]
    fs.shells = [FrameShell(id=i, timestamp=0.1 * i, cam_to_world=np.eye(4),
                            aff=np.zeros(2), shell_idx=i) for i in range(30)]
    fs.imu_queue = queue
    shell = fs.shells[29]
    assert 2.6 in [q[0] for q in queue]
    g = FU.FusedFrameGraph(fs)
    g._make(fs._state() | dict(templates=(), pc_l0=()))
    for last_kf, t_kf in ((26, 2.6), (-1, float("-inf"))):
        g.chained["last_kf"].fill_(last_kf)
        g.per_frame["imu"].copy_(torch.from_numpy(
            fs._stage_imu_block(shell, 2.8)))
        acc, gyro, ts, valid, thresh, t_frame = g._imu_block()
        ref = fs._stage_imu(shell, t_kf, 2.8)
        for k, v in dict(acc=acc, gyro=gyro, ts=ts, valid=valid,
                         thresh=thresh, t_kf=t_frame).items():
            exact(v, ref[k])
        assert int(valid.sum()) == (60 if last_kf >= 0 else 121)


def test_stamps_of_the_fused_vio_frames(run):
    """The VIO frames' device stamps ordered as the mono frames' (the gyro
    hypothesis inside `dev.track`, the VIO chain ending at chain.end),
    one `dev.chain` a fused keyframe, the series one a completed frame."""
    fs, _ = run
    t = fs.telemetry.timers
    check_stamps(fs)
    assert len(t["dev.chain"]) == sum(fs.fused_graph.chains.values()) >= 1
    assert len(t["track.retry"]) == len(t["track.lm_trips"]) \
        == len(t["complete"]) == len(t["dev.track"])
