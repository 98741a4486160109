"""retry_pct: the frames whose primary track missed, so that the 5-wide
retry ran, in % of the window's fused frames: the program's
`track.retry` series (0 or 1 a frame)."""


def read(view):
    v = view.timers_ms.get("track.retry")
    return 100.0 * sum(v) / len(v) if v else None
