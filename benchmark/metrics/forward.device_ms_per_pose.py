"""Device ms a posed instance of the operations launched inside the
model's forward (the harness's range around ``ISTNet.forward``), over
the traced items."""


def read(r: dict):
    ms = r["trace"].range_ms("forward")
    if ms is None or not r["traced"]["units"]:
        return None
    return ms / r["traced"]["units"]
