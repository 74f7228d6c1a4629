"""Host ms from ``train_step``'s call to its return, without a
synchronise (the enqueue), averaged over every step of the untraced
window."""


def read(r: dict):
    return r.get("host_ms_per_item")
