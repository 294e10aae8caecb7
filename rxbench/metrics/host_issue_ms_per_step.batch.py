"""Host-clock ms for ``decode_frame`` to return (its enqueue), the mean over
the steps of the untraced window that precedes the traced one."""


def read(view):
    return view.figures.get("issue_ms_mean")
