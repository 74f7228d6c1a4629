"""Share (%) of the span of device activity in the traced window in
which no operation ran: 1 - busy / span, from the capture of device
activity alone (``harness/trace.py::device_window``)."""


def read(r: dict):
    if not r.get("span_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["span_s"])
