"""gn_its: the windowed BA's GN steps, mean a keyframe over the window:
the program's `ba.gn_its` series (one a keyframe)."""


def read(view):
    v = view.timers_ms.get("ba.gn_its")
    return sum(v) / len(v) if v else None
