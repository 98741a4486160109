"""chain_dev_ms: the keyframe chain inside the fused frame's IF node on
the card, mean ms a keyframe over the window: the program's `dev.chain`
series (device stamps `step.end` .. `chain.end`, one a keyframe)."""


def read(view):
    v = view.timers_ms.get("dev.chain")
    return sum(v) / len(v) if v else None
