"""State snapshot / resume (port of sos_slam_tpu/models/snapshot.py).

The reference has no checkpointing (its only persistent output is
poses.txt at shutdown). `save_snapshot` writes the window, the immature
pool, the IMU state, the image stack, HdiF, each slot's pyramid and the
host bookkeeping to one compressed `.npz`; `load_snapshot` restores them
into a freshly constructed FullSystem of the same settings and
calibration, on its device.

The layout and key names are the JAX package's (`ba.*`, `imm.*`, `imu.*`,
`dI`, `HdiF`, `pyr.{slot}.{level}`, `host_json`), so a snapshot written by
either package loads into the other. That layout leaves out state a
resumed run reads, so a JAX snapshot resumes close to the uninterrupted
run but not on it: the tracker template (built on the keyframe before its
point and frame marginalizations; the loader rebuilds it from the
restored window, K2 on a CUDA system), the next frame's inputs chained on
the device from the last frame (`FullSystem._last_chain`), the selector's
random key, the selector rungs that `FullSystem.prewarm` confined the
density adaptation to, and the host IMU queue, the gyro-bias copy and the
last dso_error. The port writes these too, under `port.*` keys that the JAX
loader, which reads by name, ignores; a port snapshot therefore resumes
bit for bit on the run it was taken from.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from sos_slam_tpu_torch.models import imu as IM
from sos_slam_tpu_torch.models import window as WIN
from sos_slam_tpu_torch.models.full_system import FrameShell, FullSystem
from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import trace as TR
from sos_slam_tpu_torch.ops.tracker import LevelTemplate
from sos_slam_tpu_torch.utils.convert import from_numpy, to_numpy

PORT = "port."   # prefix of the entries only the port writes and reads


def _default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.floating, np.integer, np.bool_)):
        return o.item()
    raise TypeError(type(o))


def _json_entry(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj, default=_default).encode(),
                         dtype=np.uint8)


def _read_json(entry) -> dict:
    return json.loads(bytes(np.asarray(entry).tobytes()).decode())


def _put(out: dict, name: str, v):
    """Store `v` (a tensor, numpy value, tuple of them, or a JSON value)
    under entries named `name`; returns the description `_get` reads."""
    if torch.is_tensor(v):
        out[name] = v.detach().cpu().numpy()
        return "tensor"
    if isinstance(v, (np.ndarray, np.generic)):
        out[name] = np.asarray(v)
        return "array" if isinstance(v, np.ndarray) else "scalar"
    if isinstance(v, tuple):
        return ["tuple"] + [_put(out, f"{name}.{i}", x)
                            for i, x in enumerate(v)]
    return ["value", v]


def _get(data, name: str, desc, device):
    if desc == "tensor":
        return torch.as_tensor(data[name], device=device)
    if desc == "array":
        return np.array(data[name])
    if desc == "scalar":
        return data[name][()]
    if desc[0] == "tuple":
        return tuple(_get(data, f"{name}.{i}", d, device)
                     for i, d in enumerate(desc[1:]))
    return desc[1]


def save_snapshot(fs: FullSystem, path: str) -> None:
    """Complete the frames in flight, then write the state to `path`."""
    # complete the frames in flight (as the JAX package does): the chained
    # next-frame inputs kept below are then the last completed frame's
    fs.finish_pending()
    out: dict = {}
    for prefix, st in (("ba", fs.ba), ("imm", fs.imm), ("imu", fs.imu)):
        if st is not None:
            out.update({f"{prefix}.{k}": v
                        for k, v in to_numpy(st).items()})
    out["dI"] = fs.dI.cpu().numpy()
    out["HdiF"] = fs.HdiF.cpu().numpy()
    for i, pyr in enumerate(fs.frame_pyramids):
        if pyr is not None:
            for lvl, lv in enumerate(pyr):
                out[f"pyr.{i}.{lvl}"] = lv.cpu().numpy()
    out["host_json"] = _json_entry(dict(
        shells=[dataclasses.asdict(s) for s in fs.shells],
        frame_shell_idx=fs.frame_shell_idx,
        kf_shell_ids=fs.kf_shell_ids,
        host_out=fs.host_out.tolist(),
        current_min_act_dist=float(fs.current_min_act_dist),
        sel_pot=int(fs._sel_pot),
        current_scale=fs.current_scale,
        scale_trapped=fs.scale_trapped,
        scale_opt_fails=fs.scale_opt_fails,
        imu_initialized=fs.imu_initialized,
        initialized=fs.initialized,
        is_lost=fs.is_lost,
        init_failed=fs.init_failed,
        ref_slot=fs.ref_slot,
        ref_exposure=fs.ref_exposure,
        first_coarse_rmse=fs.first_coarse_rmse,
        last_coarse_rmse=fs.last_coarse_rmse.tolist(),
        stats=dict(fs.stats),
        marg_pts=[[list(map(float, p)) for p in c]
                  for c in fs._marg_pts_cache]))

    # the port's own resume state
    out[PORT + "key"] = np.asarray(fs.key, np.uint32)
    if fs.templates is not None:
        for lvl, tp in enumerate(fs.templates):
            for k, v in to_numpy(tp).items():
                out[f"{PORT}tmpl.{lvl}.{k}"] = v
    pc_l0 = _put(out, PORT + "pc_l0", fs.pc_l0) \
        if fs.pc_l0 is not None else None
    chain = None
    if fs._last_chain is not None:
        c = fs._last_chain
        chain = dict(need_kf=bool(c["need_kf"]),
                     shell_idx=c["shell"].shell_idx,
                     nxt={k: _put(out, f"{PORT}nxt.{k}", v)
                          for k, v in c["nxt"].items()})
    if fs.imu_queue:
        ts, acc, gyro = zip(*fs.imu_queue)
        out[PORT + "imu_t"] = np.asarray(ts, np.float64)
        out[PORT + "imu_acc"] = np.stack(acc)
        out[PORT + "imu_gyro"] = np.stack(gyro)
    if fs._last_bg is not None:
        out[PORT + "last_bg"] = np.asarray(fs._last_bg)
    if fs._prewarmed_pots is not None:
        out[PORT + "prewarmed_pots"] = np.array(sorted(fs._prewarmed_pots),
                                                np.int64)
    out[PORT + "host_json"] = _json_entry(dict(
        pc_l0=pc_l0, chain=chain, last_dso_error=float(fs._last_dso_error)))
    np.savez_compressed(path, **out)


def _state(cls, prefix, data, device):
    return from_numpy(cls, {k: data[f"{prefix}{k}"] for k in cls._fields},
                      device)


def load_snapshot(fs: FullSystem, path: str) -> FullSystem:
    """Restore state into a freshly constructed FullSystem (same settings
    and calibration), on its device. Returns fs (changed in place)."""
    dev = fs.device
    with np.load(path) as data:
        fs.ba = _state(B.BAState, "ba.", data, dev)
        fs.imm = _state(TR.ImmatureState, "imm.", data, dev)
        if fs.imu is not None and "imu.state" in data:
            fs.imu = _state(IM.ImuState, "imu.", data, dev)
        fs.dI = torch.as_tensor(data["dI"], device=dev)
        fs.HdiF = torch.as_tensor(data["HdiF"], device=dev)
        fs.frame_pyramids = [None] * fs.F
        for i in range(fs.F):
            lvls = []
            while f"pyr.{i}.{len(lvls)}" in data:
                lvls.append(torch.as_tensor(data[f"pyr.{i}.{len(lvls)}"],
                                            device=dev))
            if lvls:
                fs.frame_pyramids[i] = tuple(lvls)
        _load_host(fs, _read_json(data["host_json"]))
        port = _read_json(data[PORT + "host_json"]) \
            if PORT + "host_json" in data else None
        if port is not None:
            _load_port(fs, port, data)

    if fs._last_chain is not None:
        # the record the next frame dispatches from: the restored state
        fs._last_chain["state"] = fs._state()
    n = len(fs.frame_shell_idx)
    if fs.initialized and fs.frame_pyramids[max(n - 1, 0)] is not None:
        if port is None:
            # rebuild the tracker template from the restored window
            fs.templates, fs.pc_l0 = WIN.build_track_template(
                fs.ba, fs.HdiF, fs.frame_pyramids[n - 1], fs.n_levels,
                fs.tmpl_sizes, fs.w, fs.h)
        fs.ref_aff = np.asarray(fs.shells[fs.frame_shell_idx[n - 1]].aff,
                                np.float32)
    return fs


def _load_host(fs: FullSystem, host: dict) -> None:
    """The JAX layout's host bookkeeping."""
    fs.shells = []
    fs._shell_by_id = {}
    for i, d in enumerate(host["shells"]):
        d = dict(d)
        for k in ("cam_to_world", "aff", "cam_to_world_scaled"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k])
        d["shell_idx"] = i      # recomputed (absent in older snapshots)
        sh = FrameShell(**d)
        fs.shells.append(sh)
        fs._shell_by_id[sh.id] = sh
    fs.frame_shell_idx = host["frame_shell_idx"]
    fs.kf_shell_ids = host["kf_shell_ids"]
    fs.host_out = np.asarray(host["host_out"], np.int64)
    fs.current_min_act_dist = torch.full(
        (), float(np.float32(host["current_min_act_dist"])), device=fs.device)
    fs._sel_pot = int(host.get("sel_pot", 3))
    fs.current_scale = host["current_scale"]
    fs.scale_trapped = host["scale_trapped"]
    fs.scale_opt_fails = host["scale_opt_fails"]
    fs.imu_initialized = host["imu_initialized"]
    fs.initialized = host["initialized"]
    fs.is_lost = host["is_lost"]
    fs.init_failed = host["init_failed"]
    fs.ref_slot = host["ref_slot"]
    fs.ref_exposure = host["ref_exposure"]
    fs.first_coarse_rmse = host["first_coarse_rmse"]
    fs.last_coarse_rmse = np.asarray(host["last_coarse_rmse"])
    fs.stats.update(host["stats"])
    fs._marg_pts_cache = [[tuple(p) for p in c] for c in host["marg_pts"]]


def _load_port(fs: FullSystem, port: dict, data) -> None:
    """The `port.*` entries: the state the JAX layout leaves out."""
    dev = fs.device
    fs.key = np.array(data[PORT + "key"], np.uint32)
    lvl, templates = 0, []
    while f"{PORT}tmpl.{lvl}.u" in data:
        templates.append(_state(LevelTemplate, f"{PORT}tmpl.{lvl}.", data,
                                dev))
        lvl += 1
    fs.templates = tuple(templates) if templates else None
    if port["pc_l0"] is not None:
        fs.pc_l0 = _get(data, PORT + "pc_l0", port["pc_l0"], dev)
    chain = port["chain"]
    if chain is not None:
        fs._last_chain = dict(
            need_kf=chain["need_kf"], shell=fs.shells[chain["shell_idx"]],
            nxt={k: _get(data, f"{PORT}nxt.{k}", d, dev)
                 for k, d in chain["nxt"].items()})
    fs._last_dso_error = port["last_dso_error"]
    if PORT + "imu_t" in data:
        fs.imu_queue = list(zip(data[PORT + "imu_t"].tolist(),
                                np.array(data[PORT + "imu_acc"]),
                                np.array(data[PORT + "imu_gyro"])))
    if PORT + "last_bg" in data:
        fs._last_bg = np.array(data[PORT + "last_bg"])
    if PORT + "prewarmed_pots" in data:
        fs._prewarmed_pots = {int(p) for p in data[PORT + "prewarmed_pots"]}
