#!/usr/bin/env python3
"""What a steady frame without keyframe costs the card in the fused frame
graph (models/fused_graph.py), in a process of its own.

    python3 scripts/torch_fused_costs.py [--frames 34]

Runs the mono scene of chip_smoke.py (640x480, default settings) through
the graph form, then on the last frame that made no keyframe, recorded at
its dispatch: the copy-in of its source record's state and inputs, the
fused graph's replay (the keyframe chain's IF node takes its else body)
and the frame step's own graph (a FrameGraph captured on the same
inputs), each in device ms a call under CUDA events (20 calls) and under
torch.profiler (5 calls; in a fresh process it sees the kernels inside
conditional nodes), with the ops a call; and the record's clones of the
state, the pyramid and the next inputs. Prints one line each and the
card's name and power limit. Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_fused_costs: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=34)
    n = ap.parse_args().frames
    import chip_smoke as C
    from sos_slam_tpu_torch.models import frame_graph as FG
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.ops import control
    from sos_slam_tpu_torch.utils import cuda_build, synthetic
    from sos_slam_tpu_torch.utils.config import default_settings

    cuda_build.build_all()
    dev = torch.device("cuda")
    calib = synthetic.default_calib(C.W, C.H)
    imgs, _, _ = synthetic.make_sequence(calib, n, C.TWIST, plane_z=2.0,
                                         device=dev)
    fs = FullSystem(calib, default_settings(), device=dev)
    disp = C.Dispatches(fs)
    for i in range(n):
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
    fs.finish_pending()
    disp.restore()
    frame = max(i for i in disp.by_id if i not in set(fs.kf_shell_ids))
    g = fs.fused_graph
    (st, inp, prev, _, img, exposure, key, right, shell_idx, block, pot,
     _) = disp.by_id[frame]

    def load():
        g._load(st, inp, prev)
        g._stage(img, exposure, key, right, shell_idx, block)

    def replay():
        load()
        g.graphs[pot].replay()

    def clones():
        control.clone((g.outs[pot]["pyr"], g.state, dict(g.frame.inp),
                       g.chained))

    fg = FG.FrameGraph(fs)
    fg.step(st, img, inp["T_primary"], inp["T_hyps"], inp, exposure)
    g.last = None
    tag = f"[fused costs] ({C.nvidia_smi()}) mono frame {frame}"
    events = {k: C.replay_ms(torch, fn) for k, fn in (
        ("copy-in", load), ("copy-in + fused replay", replay),
        ("frame step's own graph", fg.graph.replay), ("clones", clones))}
    C.log(f"{tag}, device ms a call under CUDA events: " + ", ".join(
        f"{k} {v:.4f}" for k, v in events.items()))
    for name, fn in (("copy-in", load), ("copy-in + fused replay", replay),
                     ("frame step's own graph", fg.graph.replay)):
        _, ev = C.prof_window(torch, lambda fn=fn: [fn() for _ in range(5)])
        ms = sum(e.self_device_time_total for e in ev) / 5 / 1e3
        ops = sum(e.count for e in ev) / 5
        C.log(f"{tag}, under torch.profiler: {name} {ms:.4f} ms of device "
              f"work in {ops:.0f} device ops a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
