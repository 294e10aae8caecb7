"""The median host-clock ms of one ``decode_regular`` call in the open loop
(from its start to its bytes on the host), over the untraced window."""


def read(view):
    return view.figures.get("service_ms_p50")
