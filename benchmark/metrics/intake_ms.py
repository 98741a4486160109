"""intake_ms: the node's own share of a frame, mean ms a frame over the
window: `SlamNode.process` (the 8-bit frame converted, copied to the card
from pageable memory, remapped there) minus the
`FullSystem.add_active_frame` inside it, from the benchmark's spans."""


def read(view):
    n = min(len(view.process_ms), len(view.add_frame_ms))
    if n == 0:
        return None
    return sum(p - a for p, a in zip(view.process_ms[:n],
                                     view.add_frame_ms[:n])) / n
