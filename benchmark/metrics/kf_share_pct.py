"""kf_share_pct: keyframes made in the window (the program's
`stats["n_kf"]`) per frame published, in %."""


def read(view):
    if not view.published:
        return None
    return 100.0 * view.n_kf / len(view.published)
