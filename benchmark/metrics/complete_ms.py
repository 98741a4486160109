"""complete_ms: the driver's host time completing frames, ms a published
frame: the program's `complete` and `redispatch` timers
(models/full_system.py) summed over the window."""


def read(view):
    total = sum(sum(view.timers_ms.get(name, []))
                for name in ("complete", "redispatch"))
    if not view.published or "complete" not in view.timers_ms:
        return None
    return total / len(view.published)
