"""Device ms a frame of the operations launched inside the harness's
ranges around the serving function's depth completion (``fill_missing``)
and preprocessing (``preprocess_shared_image``), over the traced frames."""


def read(r: dict):
    parts = [r["trace"].range_ms(name) for name in ("fill", "preprocess")]
    if None in parts:
        return None
    return sum(parts) / r["traced"]["items"]
