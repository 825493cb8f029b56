"""frames/s: the frames of every video completed in the window, delivered
to the host, over the window's seconds (from the first request's send to
the last video's arrival, less the time the client took to make the
photographs between requests)."""


def value(record):
    window = record["window"]
    frames = sum(v["frames"] for v in window["videos"] if v["ok"])
    return frames / window["seconds"] if window["seconds"] > 0 else None
