"""The yardstick's byte and operation counts against chip_smoke.py's, at
the shapes PERF.md's kernel table uses, and the benchmark's K3 window
accepted by the program's BA state (CPU)."""

import importlib.util

import numpy as np
import pytest
import torch

from benchmark.costs import kernels as C
from benchmark.costs import window as WIN
from benchmark.harness import manifest as MF
from benchmark.reference.camera import CameraModel


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_costs", MF.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("w,h,levels", [(640, 480, 4), (640, 480, 1),
                                        (328, 248, 3)])
def test_k1_counts_equal_chip_smoke(smoke, w, h, levels):
    px = sum((w >> lv) * (h >> lv) for lv in range(levels))
    assert C.k1_bytes(w, h, levels) == smoke.k1_bytes(w, h, levels)
    assert C.k1_flops(w, h, levels) == px * 12
    assert C.bound_ms(C.k1_bytes(w, h, levels), C.k1_flops(w, h, levels)) \
        == smoke.bound(smoke.k1_bytes(w, h, levels), px * 12)


@pytest.mark.parametrize("P,F", [(2048, 8), (2048 + 37, 5), (100, 1)])
def test_k3_counts_equal_chip_smoke(smoke, P, F):
    D = 4 + 8 * F
    assert C.k3_bytes(P, F, D) == smoke.k3_bytes(P, F, D)
    assert C.k3_flops(P, F, D) == smoke.k3_flops(P, F, D)
    assert C.H100_BYTES_PER_S == smoke.H100_BYTES_PER_S
    assert C.H100_F32_FLOPS == smoke.H100_F32_FLOPS


def test_k3_window_runs_through_the_program():
    """The benchmark's window is a valid BA state: the plain twin of the
    fused iteration gives finite energies with residuals in every state."""
    from sos_slam_tpu_torch.ops import ba as B
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.utils import convert
    from sos_slam_tpu_torch.utils.config import default_settings
    cam = CameraModel.load(str(MF.BENCH_DIR / "tests/data/small_cam0.txt"))
    traffic = MF.resolve("euroc_mono.cruise").traffic
    fields, dI = WIN.window_fields(256, 4, cam.crop_K(), cam.w, cam.h,
                                   traffic, seed=3)
    assert dI.shape == (4, cam.h, cam.w, 3)
    ba = convert.from_numpy(B.BAState, fields, "cpu")
    out = BP.fused_iteration(ba, B.make_precalc(ba), torch.as_tensor(dI),
                             default_settings(), cam.w, cam.h)
    e = out.energy.numpy()
    assert np.isfinite(e).all() and e.sum() > 0
    assert out.active.any()
