"""eager_chains: keyframe chains run eagerly instead of inside the fused
frame graph during the window, all reasons (`fused_graph.eager`); nothing
to read without the graphs."""


def read(view):
    if view.eager is None:
        return None
    return sum(view.eager.values())
