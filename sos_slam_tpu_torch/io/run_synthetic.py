"""End-to-end synthetic odometry demo (port of
sos_slam_tpu/io/run_synthetic.py):

    python -m sos_slam_tpu_torch.io.run_synthetic [--device cpu] [--classic]

Renders a constant-twist trajectory over an analytic textured scene, runs
the full pipeline (initializer -> tracking -> keyframes -> windowed BA ->
marginalization) on the device (CUDA unless `--device` names another),
writes

  poses.txt       — `id x y z` per keyframe (the reference's output
                    contract, LoopHandler::savePose, LoopHandler.cpp:62-76)
  map_*.png       — headless viewer frames (with --viewer)

and prints the scale-aligned ATE against ground truth.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--out", default="out_synthetic")
    ap.add_argument("--viewer", action="store_true",
                    help="render headless map views per keyframe")
    ap.add_argument("--classic", action="store_true",
                    help="host-decided keyframe path instead of fused")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "PyTorch twins)")
    args = ap.parse_args(argv)

    import numpy as np

    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings

    os.makedirs(args.out, exist_ok=True)
    calib = synthetic.default_calib(args.width, args.height)
    twist = (0.05, 0.02, 0.03, 0.003, 0.006, 0.002)
    imgs, _, poses = synthetic.make_sequence(calib, args.frames, twist,
                                             plane_z=2.0, device=args.device)

    settings = default_settings(
        max_window_frames=8, max_points=512, max_immature=1024,
        max_track_pts=4096, desired_point_density=400.0,
        desired_immature_density=400.0)
    fs = FullSystem(calib, settings, device=imgs.device)
    if args.classic:
        fs.fused_kf = False
    if args.viewer:
        from sos_slam_tpu_torch.io.viewer import MapViewer
        fs.output_wrappers.append(MapViewer(out_dir=args.out, size=480))

    t0 = time.time()
    for i in range(args.frames):
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        if fs.is_lost or fs.init_failed:
            print(f"tracking {'lost' if fs.is_lost else 'init failed'} "
                  f"at frame {i}", file=sys.stderr)
            break
    fs.finish_pending()
    wall = time.time() - t0

    traj = fs.trajectory()
    path = os.path.join(args.out, "poses.txt")
    np.savetxt(path, traj, fmt=["%d", "%.6f", "%.6f", "%.6f"])

    ids = traj[:, 0].astype(int)
    est = traj[:, 1:4]
    gt = poses.cpu().numpy()[ids, :3, 3]
    en, gn = np.linalg.norm(est, axis=1), np.linalg.norm(gt, axis=1)
    nz = gn > 1e-6
    scale = np.median(en[nz] / gn[nz]) if nz.any() else 1.0
    ate = float(np.sqrt(np.mean(
        np.linalg.norm(est / max(scale, 1e-9) - gt, axis=1) ** 2)))
    plen = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))

    print(f"frames={fs.stats['n_frames']} keyframes={fs.stats['n_kf']} "
          f"wall={wall:.1f}s ({fs.stats['n_frames'] / max(wall, 1e-9):.2f} "
          f"fps) on {imgs.device}")
    print(f"ATE={ate * 1000:.1f} mm over a {plen:.2f} m path "
          f"({100 * ate / max(plen, 1e-9):.2f}% of path)")
    print(f"poses.txt -> {path}")
    return 0 if (ate < 0.05 * plen + 0.01 and not fs.is_lost) else 1


if __name__ == "__main__":
    sys.exit(main())
