"""k3_roofline: K3 (csrc/ba_fused.cu, the fused BA iteration, GN mode) at
the cell's P point slots and F frame slots (D = 4 + 8F), its bound
(benchmark/costs) over its device ms a call from 200 queued launches under
CUDA events, after the window, on a window the benchmark makes from the
seed of the plane at the cell's frame size (benchmark/costs/window.py)."""

import numpy as np

from benchmark.costs import kernels as C
from benchmark.costs import window as WIN


def read(view):
    torch = view.torch
    if view.device.type != "cuda":
        return None
    from sos_slam_tpu_torch.ops import ba as B
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.utils import convert

    from benchmark.harness.timing import queued_ms
    s = view.settings
    P, F = s.max_points, s.max_window_frames
    cam = view.cams[0]
    fields, dI = WIN.window_fields(P, F, cam.crop_K(), cam.w, cam.h,
                                   view.cell.traffic, seed=0)
    ba = convert.from_numpy(B.BAState, fields, view.device)
    dI = torch.as_tensor(dI, device=view.device)
    prep = BP.k3_prepare(ba, B.make_precalc(ba), dI, s, cam.w, cam.h)
    ms = float(np.median(queued_ms(torch, lambda: BP.k3_launch(prep))))
    D = 4 + 8 * F
    bound, _ = C.bound_ms(C.k3_bytes(P, F, D), C.k3_flops(P, F, D))
    return 100.0 * bound / ms
