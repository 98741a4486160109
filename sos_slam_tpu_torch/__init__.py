"""sos_slam_tpu_torch — the PyTorch/CUDA port of sos_slam_tpu for NVIDIA Hopper.

The same direct sparse odometry as the JAX package (`sos_slam_tpu/`), which
stays the reference: each ported function keeps the JAX function's name,
argument layout and state field names, and is tested against it on the
same inputs. Plain device code is eager PyTorch; each of the JAX package's
four Pallas kernels is a hand-written CUDA kernel here (`csrc/`), built at
first use and launched through a wrapper that runs the kernel's plain
PyTorch twin when its tensors lie on the CPU.

The port covers the monocular main path (initializer, coarse tracker,
immature-point trace/activation, windowed BA with FEJ marginalization),
the stereo 1-DoF metric-scale solve, the continuous-time spline VIO
with its visual-inertial KKT BA, loop closure (Scan Context, direct +
ICP verification, the SE(3) pose graph), the SlamNode driver with its
command line (`python -m sos_slam_tpu_torch`), state snapshots
(`models/snapshot.py`), trajectory evaluation (`utils/evaluate.py`), the
headless map viewer (`io/viewer.py`), the debug plots
(`io/debug_plot.py`) and data parallelism over the point axis on
torch.distributed ranks (`parallel/`).
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM geometry is precision-critical: lower-precision matmuls give ~1e-2
# pose errors (the JAX package's own finding, which is why it forces f32
# matmuls). TF32 keeps ~3 decimal digits, so it is off everywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> _torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another device. Raises when no CUDA device exists and none was named —
    the port never falls back to the CPU on its own."""
    if device is None:
        if not _torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return _torch.device("cuda")
    return _torch.device(device)


from sos_slam_tpu_torch.utils.config import Settings, default_settings  # noqa: E402,F401
