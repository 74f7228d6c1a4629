"""Host ms from the serving function's call to its return, before the
read-back (the enqueue), averaged over every frame of the untraced
window."""


def read(r: dict):
    return r.get("host_ms_per_item")
