"""%: the share of the profiled slice's window (from the first request's
send to the last video on the host) in which no operation ran on the
device: one less the union of the device's intervals over the window."""


def value(record):
    prof = record.get("profile")
    if not prof or not prof.get("window_s") or not prof.get("busy_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
