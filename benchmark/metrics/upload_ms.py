"""upload_ms: the host's time in the node's `.to(device)` of a frame's
images, mean ms a frame over the window: the program's `node.upload`
spans summed over the frames of its `node.intake` spans."""


def read(view):
    up = view.timers_ms.get("node.upload")
    frames = view.timers_ms.get("node.intake")
    if not up or not frames:
        return None
    return sum(up) / len(frames)
