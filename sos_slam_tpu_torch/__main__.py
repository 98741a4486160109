"""Command-line entry: run SLAM on a dataset using a reference-style launch
bundle (port of sos_slam_tpu/__main__.py).

Usage:
  python -m sos_slam_tpu_torch --launch tests/EuRoC/euroc.launch \
      --dataset /data/euroc/MH_01 --format euroc --output poses.txt
  python -m sos_slam_tpu_torch --launch tests/KITTI/kitti.launch \
      --dataset /data/kitti/sequences/00 --format kitti --device cpu

Mirrors the reference node's offline replay mode (main.cpp:203-232) with the
same configuration surface and the same poses.txt output contract. Runs on
CUDA unless `--device` names another device; without a CUDA device and
without `--device` it refuses to start.
"""

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser("sos_slam_tpu_torch")
    p.add_argument("--launch", required=True,
                   help="reference-style .launch file")
    p.add_argument("--package-root", default=None,
                   help="resolves $(find sos_slam) in the launch file")
    p.add_argument("--dataset", required=True, help="dataset directory")
    p.add_argument("--format",
                   choices=["euroc", "kitti", "malaga", "robotcar"],
                   default="euroc")
    p.add_argument("--output", default="poses.txt")
    p.add_argument("--start-frame", type=int, default=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; 'cpu' runs the plain "
                        "PyTorch twins of the kernels)")
    args = p.parse_args(argv)

    from sos_slam_tpu_torch.io.datasets import (EurocReader, KittiReader,
                                                MalagaReader, RobotCarReader)
    from sos_slam_tpu_torch.io.launch import load_launch
    from sos_slam_tpu_torch.io.node import SlamNode

    cfg = load_launch(args.launch, package_root=args.package_root)
    s = cfg.settings
    start = args.start_frame if args.start_frame is not None \
        else cfg.start_frame

    node = SlamNode(
        s, cfg.calib0,
        calib1=cfg.calib1 if s.enable_scale_opt else None,
        T_stereo=cfg.T_cam1_cam0,
        gamma0=cfg.gamma0, vignette0=cfg.vignette0, device=args.device,
    )

    if args.format == "euroc":
        reader = EurocReader(args.dataset, stereo=s.enable_scale_opt,
                             use_imu=s.enable_imu, start=start)
    elif args.format == "kitti":
        reader = KittiReader(args.dataset, stereo=s.enable_scale_opt,
                             start=start)
    elif args.format == "malaga":
        reader = MalagaReader(args.dataset, stereo=s.enable_scale_opt,
                              start=start)
    else:  # robotcar (reference tests/RobotCar/robotcar.launch, preset 2)
        reader = RobotCarReader(args.dataset, stereo=s.enable_scale_opt,
                                start=start)

    t0 = time.time()
    n = node.run(reader, max_frames=args.max_frames)
    dt = time.time() - t0
    node.save_poses(args.output)
    print(f"processed {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps) "
          f"on {node.device}, {node.fs.stats['n_kf']} keyframes, "
          f"{node.loop.n_loop_edges} loop closures -> {args.output}")
    return 0 if not node.fs.is_lost else 1


if __name__ == "__main__":
    sys.exit(main())
