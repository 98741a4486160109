"""pose_p95_ms: the 95th percentile, over the window's published frames,
of the time from handing a frame to `SlamNode.process` to the benchmark's
output wrapper receiving its pose (`publish_cam_pose`)."""

import statistics


def read(view):
    if len(view.latency_ms) < 2:
        return None
    return statistics.quantiles(view.latency_ms, n=100)[94]
