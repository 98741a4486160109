"""trace_dev_ms: the fused frame's trace, window stats and keyframe
decision on the card, mean ms a frame over the window: the program's
`dev.trace` series (device stamps `track.end` .. `step.end`)."""


def read(view):
    v = view.timers_ms.get("dev.trace")
    return sum(v) / len(v) if v else None
