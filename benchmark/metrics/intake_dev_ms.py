"""intake_dev_ms: the node's intake on the card, mean ms a frame over the
window: the program's `dev.intake` series (the fused graph's device
stamps `intake.begin` .. `intake.end` around `SlamNode.process`'s
upload and remap, on the host's clock)."""


def read(view):
    v = view.timers_ms.get("dev.intake")
    return sum(v) / len(v) if v else None
