"""Launch-file / calib.yaml compatibility layer (port of
sos_slam_tpu/io/launch.py; host-only, its own copy).

Parses the reference's public configuration surface — the ROS .launch XML
(<param name=.../> entries) and the calib.yaml (topics, T_cam0_imu,
T_cam1_cam0, IMU noise) — into a `Settings` + file paths, reproducing the
parameter semantics of src/main.cpp:96-195 (derived enable switches, preset
handling, IMU noise -> information weights).

This makes the reference's `tests/<dataset>/*.launch` bundles directly
loadable by the port.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from sos_slam_tpu_torch.utils.config import Settings, default_settings


@dataclass
class LaunchConfig:
    settings: Settings
    calib0: Optional[str] = None
    calib1: Optional[str] = None
    gamma0: Optional[str] = None
    vignette0: Optional[str] = None
    gamma1: Optional[str] = None
    vignette1: Optional[str] = None
    bag: Optional[str] = None
    start_frame: int = 0
    T_cam0_imu: Optional[np.ndarray] = None
    T_cam1_cam0: Optional[np.ndarray] = None
    topics: Dict[str, str] = field(default_factory=dict)


def _parse_yaml_simple(path: str) -> Dict:
    """Minimal YAML subset parser for the reference's calib.yaml (flat keys,
    inline [..] lists, comments)."""
    out: Dict = {}
    text = open(path).read()
    # join multi-line bracketed lists
    text = re.sub(r"\[[^\]]*\]", lambda m: m.group(0).replace("\n", " "), text)
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if not line or ":" not in line:
            continue
        key, val = line.split(":", 1)
        key, val = key.strip(), val.strip()
        if not val:
            continue
        if val.startswith("["):
            out[key] = [float(v) for v in re.split(r"[,\s]+", val[1:-1].strip())
                        if v]
        else:
            try:
                out[key] = float(val) if "." in val or "e" in val.lower() \
                    else int(val)
            except ValueError:
                out[key] = val
    return out


def load_launch(launch_file: str, package_root: Optional[str] = None,
                **overrides) -> LaunchConfig:
    """Parse a reference-style .launch file. `$(find sos_slam)` resolves to
    `package_root` (defaults to the launch file's grandparent dir);
    `$(arg name)` resolves to the declared defaults."""
    tree = ET.parse(launch_file)
    root = tree.getroot()
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(
            os.path.abspath(launch_file)))

    args: Dict[str, str] = {}
    params: Dict[str, str] = {}
    yaml_data: Dict = {}

    def resolve(v: str) -> str:
        v = re.sub(r"\$\(find [^)]*\)", package_root, v)
        v = re.sub(r"\$\(arg ([^)]*)\)", lambda m: args.get(m.group(1), ""), v)
        return v

    for el in root.iter():
        if el.tag == "arg":
            args[el.get("name")] = resolve(el.get("default", ""))
        elif el.tag == "rosparam" and el.get("command") == "load":
            f = resolve(el.get("file", ""))
            if os.path.exists(f):
                yaml_data.update(_parse_yaml_simple(f))
        elif el.tag == "param":
            params[el.get("name")] = resolve(el.get("value", ""))

    def fparam(name, default):
        return float(params.get(name, default))

    kw = dict(
        preset=int(fparam("preset", 0)),
        photometric_calibration=int(fparam("mode", 1)) and 2
        if "mode" not in params else {0: 2, 1: 1, 2: 0}.get(
            int(fparam("mode", 1)), 1),
        weight_imu_dso=fparam("weight_imu_dso", -1.0),
        scale_opt_thres=fparam("scale_opt_thres", -1.0),
        loop_lidar_range=fparam("loop_lidar_range", -1.0),
        scan_context_thres=fparam("scan_context_thres", 0.33),
        loop_direct_thres=fparam("loop_direc_thres", 10.0),
        loop_force_icp=params.get("loop_force_icp", "false") == "true",
        loop_icp_thres=fparam("loop_icp_thres", 1.5),
    )
    # photometric mode mapping (main.cpp:66-90): mode 0 = full calib,
    # 1 = no calib (affine), 2 = none
    mode = int(fparam("mode", 1))
    kw["photometric_calibration"] = {0: 2, 1: 2, 2: 0}.get(mode, 2)

    T_c0_imu = None
    if "T_cam0_imu" in yaml_data:
        T_c0_imu = np.array(yaml_data["T_cam0_imu"]).reshape(4, 4)
        # setting_rot_imu_cam = R(T_cam0_imu)^T (main.cpp:134-137)
        kw["rot_imu_cam"] = tuple(T_c0_imu[:3, :3].T.reshape(-1).tolist())
    for yk, sk in (("rate_hz", "imu_freq"),
                   ("accelerometer_noise_density", "imu_acc_nd"),
                   ("accelerometer_random_walk", "imu_acc_rw"),
                   ("gyroscope_noise_density", "imu_gyro_nd"),
                   ("gyroscope_random_walk", "imu_gyro_rw")):
        if yk in yaml_data:
            kw[sk] = float(yaml_data[yk])

    kw.update(overrides)
    settings = default_settings(**kw)

    T_c1_c0 = None
    if "T_cam1_cam0" in yaml_data:
        T_c1_c0 = np.array(yaml_data["T_cam1_cam0"]).reshape(4, 4)

    topics = {k: yaml_data[k] for k in
              ("imu_topic", "cam0_topic", "cam1_topic") if k in yaml_data}

    return LaunchConfig(
        settings=settings,
        calib0=params.get("calib0"), calib1=params.get("calib1"),
        gamma0=params.get("gamma0"), vignette0=params.get("vignette0"),
        gamma1=params.get("gamma1"), vignette1=params.get("vignette1"),
        bag=params.get("bag"),
        start_frame=int(fparam("start_frame", 0)),
        T_cam0_imu=T_c0_imu, T_cam1_cam0=T_c1_c0, topics=topics,
    )
