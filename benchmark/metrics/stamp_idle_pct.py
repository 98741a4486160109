"""stamp_idle_pct: the card's idle share over the window from the
program's device stamps, in %: the gaps between the stamped spans in
stream order (`dev.idle`) over the intakes, frames, posts (the record's
clones and readback copy) and gaps together."""


def read(view):
    t = view.timers_ms
    idle = sum(t.get("dev.idle", []))
    whole = idle + sum(sum(t.get(n, []))
                       for n in ("dev.intake", "dev.frame", "dev.post"))
    if not t.get("dev.frame") or whole <= 0:
        return None
    return 100.0 * idle / whole
