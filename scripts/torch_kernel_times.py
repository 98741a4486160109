#!/usr/bin/env python3
"""The four kernels of the PyTorch port, timed the same way in one or several
checkouts of the repository on one NVIDIA GPU, so that two designs of a
kernel are compared inside one run on one card.

    python3 scripts/torch_kernel_times.py [CHECKOUT ...]

Each CHECKOUT (default: this repository) is a directory that holds the
`sos_slam_tpu_torch` package, for example an unpacked `git archive` of an
earlier commit; name a checkout twice (parent, change, change, parent) to
see the spread. Every checkout runs in a process of its own: it builds its
kernels, records the kernels' inputs on a short run of the 640x480 main
scene (chip_smoke.py's capture), and prints one JSON line with, per kernel,
the device ms a call by chip_smoke.py's 200-queued-launches measure (three
repeats), the device ops a call of the whole wrapper (K1: build_pyramid,
K2: build_track_template), the host's ms a call of it, and the copies
among its device ops that cross between host and device. A call of K1 is
the pyramid of one frame and a call of K2 the template maps of one
keyframe, all levels: one launch where the checkout has the whole-call
entries (`pyramid_levels`, `template_levels`), else its one launch per
level. The measuring code is always this repository's chip_smoke.py; only
the package comes from CHECKOUT. End-to-end numbers (fps, keyframes, ATE)
are chip_smoke.py's own.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_ms(torch, fn, n=50) -> float:
    """The host's ms a call of `fn` over n calls in a row (the time to
    enqueue them, plus whatever host reads the call makes)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e3


def one(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.utils import cuda_build, synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    dev = torch.device("cuda")
    cuda_build.build_all()
    calib = synthetic.default_calib(cs.W, cs.H)
    settings = default_settings()
    imgs, _, _ = synthetic.make_sequence(calib, cs.N_FRAMES, cs.TWIST,
                                         plane_z=2.0, device=dev)
    one_launch = hasattr(WIN, "template_levels")
    recs, n_pre = cs.capture(
        torch, calib, settings, imgs, dev,
        k2_entry="template_levels" if one_launch else "template_level")
    frame = imgs[n_pre].contiguous()
    if one_launch:
        (maps, colors, diags), _ = recs["k2"].calls[-1]

        def k1():
            return IMG.pyramid_levels(frame, calib.levels)

        def k2():
            return WIN.template_levels(maps, colors, diags)
    else:
        levels = [frame]
        for _ in range(calib.levels - 1):
            levels.append(IMG.downsample2x(levels[-1]).contiguous())
        calls = list(recs["k2"].calls)

        def k1():
            return [IMG.pyramid_level(lv) for lv in levels]

        def k2():
            return [WIN.template_level(*a, **kw) for a, kw in calls]
    ta, tkw = recs["tmpl"].calls[-1]
    a, kw = recs["k3"].last_of["gn"]
    a4, kw4 = recs["k4"].calls[-1]
    prep = BP.k3_prepare(*a, **kw)
    out = {"checkout": root, "card": cs.nvidia_smi()}
    for name, kernel_fn, wrapper_fn in (
            ("K1", k1, lambda: IMG.build_pyramid(frame, calib.levels)),
            ("K2", k2, lambda: WIN.build_track_template(*ta, **tkw)),
            ("K3", lambda: BP.k3_launch(prep),
             lambda: BP.fused_iteration(*a, **kw)),
            ("K4", lambda: BP.act_pass(*a4, **kw4),
             lambda: BP.act_pass(*a4, **kw4))):
        q, before, after = cs.queued_ms(torch, kernel_fn)
        n_ops, crossing = cs.device_ops(torch, wrapper_fn)
        out[name] = {"queued_ms": q, "clocks": [before, after],
                     "wrapper_host_ms": host_ms(torch, wrapper_fn),
                     "wrapper_device_ops": n_ops,
                     "wrapper_host_device_copies": crossing}
    print(json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    for root in sys.argv[1:] or [REPO]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
