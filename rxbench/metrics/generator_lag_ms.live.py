"""The most the open loop's generator ran behind its schedule, in ms: how
late a buffer's decode started after its due time while the decoder was
idle, over the untraced window."""


def read(view):
    return view.figures.get("generator_lag_ms_max")
