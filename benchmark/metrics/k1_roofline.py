"""k1_roofline: K1 (csrc/pyramid.cu) at the cell's frame size and levels,
its bound (benchmark/costs) over its device ms a call from 200 queued
launches under CUDA events, after the window; the input is a ring frame
rectified by the plain reference."""

import numpy as np

from benchmark.costs import kernels as C
from benchmark.harness.timing import queued_ms
from benchmark.reference import camera as CAM


def read(view):
    torch = view.torch
    if view.device.type != "cuda":
        return None
    from sos_slam_tpu_torch.ops import image as IMG
    cam = view.cams[0]
    K = cam.crop_K()
    rx, ry, valid = cam.remap_coords(K)
    img = CAM.remap(view.ring.frame(0), rx, ry, valid).astype(np.float32)
    frame = torch.as_tensor(img, device=view.device).contiguous()
    levels = int(view.cell.config["sizes"]["pyramid_levels"])
    ms = float(np.median(queued_ms(torch, lambda: IMG.pyramid_levels(
        frame, levels))))
    bound, _ = C.bound_ms(C.k1_bytes(cam.w, cam.h, levels),
                          C.k1_flops(cam.w, cam.h, levels))
    return 100.0 * bound / ms

