"""Carry window / point / template state between the JAX package and the
port as numpy dicts.

SLAM has no weights; the state that matters is the point, frame, IMU and
stereo state. `from_numpy` builds one of the port's NamedTuple states
(BAState, ImmatureState, LevelTemplate, Precalc, InitState, ImuState, ...)
from a dict of numpy arrays keyed by field name — e.g. the JAX package's
state turned into `{k: np.asarray(v) for k, v in s._asdict().items()}` —
and `to_numpy` is the inverse. Dtypes are kept: int8 residual states,
int32 hosts and counters, bool masks, float32 everything else.

The stereo calibration is host-side in both packages: `from_numpy`
builds the port's StereoCalib from `dataclasses.asdict` of the JAX one
({"T_lr": (4,4), "calib_right": {widths, heights, fx, fy, cx, cy}}), and
`to_numpy` gives that dict back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

_DTYPES = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"no tensor dtype for numpy {a.dtype}")
    return torch.as_tensor(np.array(a), dtype=_DTYPES[a.dtype],
                           device=device)


def from_numpy(cls, arrays: Dict[str, Any], device):
    """An instance of the NamedTuple state `cls` from numpy arrays keyed by
    field name. InitState's `levels` is a sequence of per-level dicts (or
    of anything with `_asdict`). For StereoCalib, `device` is not used."""
    from sos_slam_tpu_torch.models.full_system import StereoCalib
    from sos_slam_tpu_torch.models.initializer import InitLevel, InitState
    from sos_slam_tpu_torch.utils.camera import CalibPyramid
    if cls is StereoCalib:
        cr = arrays["calib_right"]
        return StereoCalib(
            T_lr=np.array(arrays["T_lr"], np.float32),
            calib_right=CalibPyramid(**{f.name: tuple(cr[f.name]) for f in
                                        dataclasses.fields(CalibPyramid)}))
    kw = {}
    for name in cls._fields:
        val = arrays[name]
        if cls is InitState and name == "levels":
            kw[name] = tuple(
                from_numpy(InitLevel, lv if isinstance(lv, dict)
                           else {k: np.asarray(v)
                                 for k, v in lv._asdict().items()}, device)
                for lv in val)
        else:
            kw[name] = _tensor(val, device)
    return cls(**kw)


def to_numpy(state) -> Dict[str, Any]:
    """The inverse of `from_numpy`: a dict of numpy arrays by field name
    (InitState's levels as a list of dicts; a StereoCalib as its
    `dataclasses.asdict`)."""
    if dataclasses.is_dataclass(state):
        return dataclasses.asdict(state)
    out = {}
    for name, val in state._asdict().items():
        if isinstance(val, tuple):
            out[name] = [to_numpy(v) for v in val]
        else:
            out[name] = val.detach().cpu().numpy()
    return out
