#!/usr/bin/env python3
"""The VIO frame marginalizations of the flagship scene (stereo + spline
VIO, chip_smoke.py's scene and settings), each folded by the port
(`models/energy.py::fold_vio_block`, or with --f32 the f32 inverse of the
whole block with its exactly-zero rows patched, the fold before the
live-subspace one) and by the float64 fold over the live subspace of the
scaled block from an eigendecomposition (chip_smoke.py's `live_fold64`);
with --plant, after each exactly-zero row was replaced by a near-zero
one.

    python3 scripts/torch_vio_fold.py [--device cpu] [--size 256x192]
        [--frames 44] [--use port|f64] [--f32] [--plant 1e-7]

For each marginalization it prints the patched rows, the smallest and
largest eigenvalue of the scaled 29x29 block, the norm of the folded
prior's scale row under both folds, and, for each keyframe from frame 35
on, the scale and the scale's VIO GN steps; then the keyframes, the
stereo scale and the metric ATE of the scaled trajectory. `--use` names
the fold the run goes on with.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--frames", type=int, default=44)
    ap.add_argument("--use", choices=("port", "f64"), default="port")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--plant", type=float, default=0.0)
    a = ap.parse_args()
    import torch
    torch.set_num_threads(2)
    import chip_smoke as CS
    from sos_slam_tpu_torch import resolve_device
    from sos_slam_tpu_torch.models import energy as E
    from sos_slam_tpu_torch.models import full_system as FSM
    from sos_slam_tpu_torch.models import imu as IM
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings

    dev = resolve_device(a.device)
    w, h = (int(x) for x in a.size.split("x"))
    calib = synthetic.default_calib(w, h)
    settings = default_settings(weight_imu_dso=6.0, scale_opt_thres=12.0,
                                min_g_imu=10)
    scene = synthetic.stereo_vio_scene(
        calib, a.frames, CS.FLAG_DT, synthetic.sine_pose,
        synthetic.sine_acc, device=dev)
    stereo = FSM.StereoCalib(T_lr=scene["T_lr"], calib_right=calib)
    probe = CS.FoldProbe(torch, E, IM, use=a.use, plant=a.plant, f32=a.f32)
    # eager: the probe reads the card inside the chain, which a CUDA
    # graph's capture refuses
    fs = FSM.FullSystem(calib, settings, stereo=stereo, device=dev,
                        cuda_graphs=False)
    fs.pipeline = False
    for i in range(a.frames):
        probe.frame = i
        fs.add_active_frame(scene["left"][i], timestamp=i * CS.FLAG_DT,
                            frame_id=i, image_right=scene["right"][i],
                            imu_samples=scene["imu"][i])
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    probe.restore()
    tag = (f"[vio fold] {w}x{h} {dev} use={a.use}"
           f"{' (port = f32)' if a.f32 else ''} plant={a.plant:g}")
    for line in probe.lines(tag, 35):
        print(line)
    ate, path = synthetic.metric_ate(fs.trajectory(scaled=True),
                                     scene["poses"])
    print(f"{tag}: keyframes {fs.kf_shell_ids}, stereo scale "
          f"{fs.current_scale:.6f}, metric ATE of the scaled trajectory "
          f"{ate:.5f} m over {path:.3f} m, lost {fs.is_lost}, init_failed "
          f"{fs.init_failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
