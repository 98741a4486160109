"""device_idle_pct: 100 minus the card's mean NVML kernel-busy utilization
sampled every ~100 ms through the window (NVML sees inside conditional
graph nodes)."""


def read(view):
    if not view.util:
        return None
    return 100.0 - sum(view.util) / len(view.util)
