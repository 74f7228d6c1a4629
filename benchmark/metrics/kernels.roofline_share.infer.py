"""Share (%) of the program's hand-written kernels' device time that
their least time takes: the summed least ms of every kernel call in the
traced window (``harness/roofline.py``, from each call's shapes) over the
summed device ms of the kernels named in the program's CUDA sources."""


def read(r: dict):
    ms = r["trace"].kernels_ms(r["kernels"])
    if not ms:
        return None
    return 100.0 * r["least_ms"] / ms
