"""track_dev_ms: the fused frame's pyramid, primary track and retry on
the card, mean ms a frame over the window: the program's `dev.track`
series (device stamps `frame.begin` .. `track.end`)."""


def read(view):
    v = view.timers_ms.get("dev.track")
    return sum(v) / len(v) if v else None
