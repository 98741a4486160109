"""lm_trips: the primary track's LM trips, summed over the pyramid's
levels, mean a frame over the window: the program's `track.lm_trips`
series (counted on the card, read back with the frame)."""


def read(view):
    v = view.timers_ms.get("track.lm_trips")
    return sum(v) / len(v) if v else None
